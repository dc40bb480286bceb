#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

Builds the hand-written CUDA wavefront kernel from ``src/repro_torch``, holds
its three builds (int32, float32, float64) against the plain torch version,
then drives the port's main path at the paper's IN2P3 scale: the exact DP
solve of every ``PAPER_PROFILE`` tape whose padded table fits the card,
through ``solve_batch(..., ExecutionContext(backend="cuda",
numeric_policy="f64"))``, to a ``TapeLibrary`` read plan.  Every phase fails
the run on any mismatch.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py

It imports neither ``jax`` nor the JAX package.  Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.  The last line of
its output is ``{"ok": true, "device": {...}}``; the line before it lists the
kernel with its launches, error and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks used for the bound (NVIDIA data sheet, dense, non-tensor
#: for the table types): HBM3 bandwidth and the per-type operation rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12, "int32": 33.5e12}
#: operations per (cell, candidate, s) of the fold: sum of the two table
#: reads, movement multiply and add, U-turn add, multiply and add, compare.
OPS_PER_CANDIDATE = 7
#: wall-clock budget (s) the R_pad = 512 tapes must fit in, estimated from
#: the median bucket's kernel and copy times (half the run's 1200 s limit).
BUDGET_S = 600.0
#: the paper profile's median shape bucket (R_pad, S_pad) and the largest
#: R_pad the main path solves unconditionally.
MEDIAN_BUCKET = (256, 8192)
DENSE_R_MAX = 256


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(R: int, S: int, B: int, type_name: str, span: int | None,
             disjoint: bool) -> tuple[float, str]:
    """Least time for one table build: outputs written once vs candidate ops."""
    item = 4 if type_name != "float64" else 8
    out_bytes = B * R * R * S * (item + 4)  # T and C
    in_bytes = B * (4 * R * item + R * 4)  # left, right, nl, u; x
    cands = 0
    for d in range(1, R):
        for a in range(R - d):
            if disjoint and a > 0:
                continue
            lo = a + 1 if span is None else max(a + 1, a + d - span)
            cands += a + d - lo + 1
    ops = OPS_PER_CANDIDATE * cands * S * B
    t_bytes = (out_bytes + in_bytes) / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[type_name]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import (
        ExecutionContext, evaluate_detours, logdp_span, solve, solve_batch,
    )
    from repro_torch.core.instance import make_instance
    from repro_torch.data import BENCH_PROFILE, PAPER_PROFILE, generate_dataset, u_turn_values
    from repro_torch.kernels.ltsp_dp import build, ltsp_dp
    from repro_torch.kernels.ltsp_dp.ops import (
        _table_bound, bucket_shape, prepare_batch, rescale_instance,
    )
    from repro_torch.kernels.ltsp_dp.ref import ltsp_dp_tables_ref
    from repro_torch.serving.sim import replay_schedule
    from repro_torch.storage.tape import TapeLibrary

    assert "jax" not in sys.modules and "repro" not in sys.modules
    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t_start = time.perf_counter()
    phases: dict[str, float] = {}

    def sync_now() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    def events_ms(fn, reps: int = 1) -> float:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    # ---- build ------------------------------------------------------------
    path, build_s, ptxas = build.build()
    log(f"build: {path.name} in {build_s:.3f} s (0 = already built)")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    build.load()

    # ---- phase 1: kernel vs plain version, bit for bit ---------------------
    t0 = time.perf_counter()
    max_err = 0.0
    n_cases = 0

    def compare(insts, dtype, span, disjoint, cand_tile, B_pad=None, label=""):
        nonlocal max_err, n_cases
        args = prepare_batch(insts, dtype=dtype, B_pad=B_pad, device=dev)
        *arrays, S = args
        kw = dict(S=S, span=span, disjoint=disjoint, cand_tile=cand_tile)
        Tk, Ck = ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw)
        Tp, Cp = ltsp_dp_tables_ref(*arrays, **kw)
        torch.cuda.synchronize()
        same = torch.equal(Tk, Tp) and torch.equal(Ck, Cp)
        err = float((Tk.double() - Tp.double()).abs().max())
        max_err = max(max_err, err)
        n_cases += 1
        if not same:
            bad = int(((Tk != Tp) | (Ck != Cp)).sum())
            raise SystemExit(
                f"phase 1 FAILED: kernel != plain version ({label}, {dtype}, span={span}, "
                f"disjoint={disjoint}, cand_tile={cand_tile}): {bad} cells differ"
            )

    rng = np.random.default_rng(20211217)

    def random_inst(R_lo, R_hi, scale=1):
        R = int(rng.integers(R_lo, R_hi))
        sizes = rng.integers(1, 50, size=R) * scale
        gaps = rng.integers(0, 40, size=R + 1) * scale
        left, pos = [], int(gaps[0])
        for i in range(R):
            left.append(pos)
            pos += int(sizes[i] + gaps[i + 1])
        mult = rng.integers(1, 10, size=R)
        return make_instance(left, sizes, mult, m=pos, u_turn=int(rng.integers(0, 30)) * scale)

    for dtype in (torch.int32, torch.float32, torch.float64):
        for R_lo, R_hi in ((1, 2), (2, 3), (3, 24)):
            for span, disjoint, tile in ((None, False, 128), (3, False, 128),
                                         (None, True, 128), (None, False, 4),
                                         (2, False, 4), (None, True, 4)):
                insts = [random_inst(R_lo, R_hi) for _ in range(3)]
                compare(insts, dtype, span, disjoint, tile, B_pad=4, label="batched")
                compare(insts[:1], dtype, span, disjoint, tile, label="single")
    # int32 cells past the sentinel and past 2**31 (wrapping), both scan forms
    for tile in (128, 3):
        for span, disjoint in ((None, False), (2, False), (None, True)):
            compare([random_inst(3, 10, scale=10**6)], torch.int32, span, disjoint, tile,
                    label="int32 wrap")
    log(f"phase 1a: {n_cases} small cases bit-equal (int32, float32, float64)")

    u_half = u_turn_values(generate_dataset(PAPER_PROFILE))["half_seg"]
    paper = generate_dataset(PAPER_PROFILE, u_turn=u_half)
    by_bucket: dict[tuple[int, int], list[int]] = {}
    for i, inst in enumerate(paper):
        by_bucket.setdefault(bucket_shape(inst), []).append(i)
    wide = [i for i, inst in enumerate(paper) if _table_bound(rescale_instance(inst)[0]) >= 2**31]
    log(f"paper profile: {len(paper)} tapes, U = {u_half}, {len(wide)} fail the int32 guard")
    median = by_bucket[MEDIAN_BUCKET]
    timing: dict = {}
    for j, (idx, span) in enumerate(((median[0], None),
                                     (median[1], logdp_span(paper[median[1]].n_req, 5.0)))):
        scaled = rescale_instance(paper[idx])[0]
        R_pad, S_pad = bucket_shape(scaled)
        *arrays, S = prepare_batch([scaled], dtype=torch.float64, R_pad=R_pad, S_pad=S_pad, device=dev)
        kw = dict(S=S, span=span, disjoint=False, cand_tile=ltsp_dp.DEFAULT_CAND_TILE)
        Tk, Ck = ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw)
        t1 = sync_now()
        Tp, Cp = ltsp_dp_tables_ref(*arrays, **kw)
        plain_s = sync_now() - t1
        if not (torch.equal(Tk, Tp) and torch.equal(Ck, Cp)):
            raise SystemExit(f"phase 1 FAILED: paper tape {idx} kernel != plain (span={span})")
        max_err = max(max_err, float((Tk - Tp).abs().max()))
        del Tp, Cp
        if j == 0:
            kernel_ms = events_ms(lambda: ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw), reps=3)
            t1 = sync_now()
            Ck.cpu()
            copy_ms = 1e3 * (time.perf_counter() - t1)
            b_ms, b_by = bound_ms(R_pad, S_pad, 1, "float64", None, False)
            timing = {"tape": idx, "R_pad": R_pad, "S_pad": S_pad, "ms": kernel_ms,
                      "plain_ms": 1e3 * plain_s, "copy_ms": copy_ms, "bound_ms": b_ms,
                      "bound_by": b_by}
            log(f"phase 1b: paper tape {idx} ({R_pad}, {S_pad}) f64 dp: kernel {kernel_ms:.3f} ms, "
                f"plain {1e3 * plain_s:.3f} ms, C to host {copy_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
        else:
            log(f"phase 1b: paper tape {idx} ({R_pad}, {S_pad}) f64 span={span}: bit-equal")
        del Tk, Ck
    torch.cuda.empty_cache()
    phases["1 kernel vs plain"] = time.perf_counter() - t0
    log(f"phase 1: all bit-equal, max_abs_err {max_err}, {phases['1 kernel vs plain']:.3f} s")

    # ---- phase 2: cuda == python on the bench profile ----------------------
    t0 = time.perf_counter()
    bench = generate_dataset(BENCH_PROFILE)
    f64 = ExecutionContext(backend="cuda", numeric_policy="f64", device=dev)
    for policy in ("dp", "logdp1", "logdp5", "simpledp"):
        got = solve_batch(bench, policy, context=f64)
        for inst, res in zip(bench, got):
            ref = solve(inst, policy)
            if (res.cost, res.detours) != (ref.cost, ref.detours):
                raise SystemExit(f"phase 2 FAILED: {policy} cuda != python")
    phases["2 bench exactness"] = time.perf_counter() - t0
    log(f"phase 2: {len(bench)} bench tapes x 4 policies, cuda == python, "
        f"{phases['2 bench exactness']:.3f} s")

    # ---- phase 3: the main path at paper scale ------------------------------
    fits = [i for i, inst in enumerate(paper) if bucket_shape(inst)[0] <= DENSE_R_MAX]
    ltsp_dp.reset_launches()
    t0 = time.perf_counter()
    dp_res = solve_batch([paper[i] for i in fits], "dp", context=f64)
    main_launches = dict(ltsp_dp.LAUNCHES)
    torch.cuda.synchronize()
    phases["3 dp main path"] = time.perf_counter() - t0
    for i, res in zip(fits, dp_res):
        if res.cost != evaluate_detours(paper[i], res.detours):
            raise SystemExit(f"phase 3 FAILED: tape {i} dp cost != oracle")
    log(f"phase 3: dp on {len(fits)} tapes (R_pad <= {DENSE_R_MAX}) in "
        f"{phases['3 dp main path']:.3f} s, "
        f"launches {main_launches}")
    if sum(main_launches.values()) == 0:
        raise SystemExit("phase 3 FAILED: the main path launched no kernel")
    # restricted policies on the median bucket, and the five heuristics
    t0 = time.perf_counter()
    ltsp_dp.reset_launches()
    median_insts = [paper[i] for i in median]
    dp_of = {i: r for i, r in zip(fits, dp_res)}
    for policy in ("logdp5", "simpledp"):
        got = solve_batch(median_insts, policy, context=f64)
        for i, res in zip(median, got):
            if res.cost != evaluate_detours(paper[i], res.detours) or dp_of[i].cost > res.cost:
                raise SystemExit(f"phase 3 FAILED: tape {i} {policy} cost check")
    restricted_launches = dict(ltsp_dp.LAUNCHES)
    phases["3 logdp5+simpledp (median bucket)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for policy in ("nodetour", "gs", "fgs", "nfgs", "lognfgs5"):
        for i in fits:
            if dp_of[i].cost > solve(paper[i], policy).cost:
                raise SystemExit(f"phase 3 FAILED: dp beaten by {policy} on tape {i}")
    phases["3 heuristics (host)"] = time.perf_counter() - t0
    log(f"phase 3: logdp5 + simpledp on {len(median)} median tapes "
        f"({phases['3 logdp5+simpledp (median bucket)']:.3f} s, launches {restricted_launches}); "
        f"dp <= all five heuristics on {len(fits)} tapes")
    # the next bucket up (R_pad = 512) if the clock allows; the largest never fit
    big = [i for i, inst in enumerate(paper) if bucket_shape(inst)[0] == 2 * DENSE_R_MAX]
    huge = [i for i, inst in enumerate(paper) if bucket_shape(inst)[0] > 2 * DENSE_R_MAX]
    R_m, S_m = MEDIAN_BUCKET
    per_cand_s = timing["ms"] / 1e3 / (((R_m ** 3 - R_m) / 6) * S_m)
    per_cell_s = timing["copy_ms"] / 1e3 / (R_m * R_m * S_m)
    R_b = 2 * DENSE_R_MAX
    est_512 = sum(((R_b ** 3 - R_b) / 6 * per_cand_s + R_b * R_b * per_cell_s)
                  * bucket_shape(paper[i])[1] for i in big)
    elapsed = time.perf_counter() - t_start
    if elapsed + 1.5 * est_512 < BUDGET_S:
        t0 = time.perf_counter()
        got = solve_batch([paper[i] for i in big], "dp", context=f64)
        for i, res in zip(big, got):
            if res.cost != evaluate_detours(paper[i], res.detours):
                raise SystemExit(f"phase 3 FAILED: tape {i} dp cost != oracle")
        phases[f"3 dp (R_pad = {R_b})"] = time.perf_counter() - t0
        log(f"phase 3: dp on the {len(big)} R_pad = {R_b} tapes in "
            f"{phases[f'3 dp (R_pad = {R_b})']:.3f} s (estimated {est_512:.3f} s)")
    else:
        log(f"phase 3: left out the {len(big)} R_pad = {R_b} tapes (estimated {est_512:.0f} s "
            f"of kernel and copy time after {elapsed:.0f} s)")
    t_gib = [8 * bucket_shape(paper[i])[0] ** 2 * bucket_shape(paper[i])[1] / 2**30 for i in huge]
    log(f"phase 3: left out the {len(huge)} tapes with R_pad > {R_b}: a dense f64 T alone is "
        f"{min(t_gib):.0f}-{max(t_gib):.0f} GiB, more than the card holds")

    # ---- phase 4: a served schedule -----------------------------------------
    t0 = time.perf_counter()
    ltsp_dp.reset_launches()
    lib = TapeLibrary(capacity_per_tape=PAPER_PROFILE.tape_capacity, u_turn=u_half, context=f64)
    src = paper[median[2]]
    names = []
    for t in range(3):
        for f, size in enumerate((src.right - src.left).tolist()):
            names.append(f"t{t}f{f:03d}")
            lib.store(names[-1], int(size) * (2 + t))
    req_rng = np.random.default_rng(7)
    reqs = {n: int(req_rng.integers(1, 12)) for n in req_rng.choice(names, min(300, len(names) // 2), replace=False)}
    plans = lib.schedule(reqs, policy="dp")
    for plan in plans:
        inst, _ = lib.tapes[[t.tape_id for t in lib.tapes].index(plan.tape_id)].instance(
            {n: reqs[n] for n in plan.order})
        if plan.total_cost != replay_schedule(inst, plan.detours).cost:
            raise SystemExit(f"phase 4 FAILED: {plan.tape_id} plan cost != simulator")
    phases["4 served schedule"] = time.perf_counter() - t0
    log(f"phase 4: {len(plans)} cartridges scheduled, plan costs == simulator, "
        f"launches {dict(ltsp_dp.LAUNCHES)}, {phases['4 served schedule']:.3f} s")

    # ---- phase 5: kernel time per bucket of the main path --------------------
    t0 = time.perf_counter()
    buckets = []
    for shape in sorted({bucket_shape(paper[i]) for i in fits}):
        idx = by_bucket[shape][0]
        scaled = rescale_instance(paper[idx])[0]
        *arrays, S = prepare_batch([scaled], dtype=torch.float64, R_pad=shape[0],
                                   S_pad=shape[1], device=dev)
        kw = dict(S=S, span=None, disjoint=False, cand_tile=ltsp_dp.DEFAULT_CAND_TILE)
        ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw)
        k_ms = events_ms(lambda: ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw), reps=2)
        T, C = ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw)
        t1 = sync_now()
        C.cpu()
        c_ms = 1e3 * (time.perf_counter() - t1)
        del T, C
        b_ms, b_by = bound_ms(shape[0], shape[1], 1, "float64", None, False)
        n_tapes = len(by_bucket[shape])
        buckets.append({"R_pad": shape[0], "S_pad": shape[1], "tapes": n_tapes, "kernel_ms": k_ms,
                        "copy_ms": c_ms, "bound_ms": b_ms, "bound_by": b_by})
        log(f"  bucket {shape}: {n_tapes} tapes, kernel {k_ms:.3f} ms, C to host {c_ms:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by})")
    torch.cuda.empty_cache()
    kern_total = sum(b["kernel_ms"] * b["tapes"] for b in buckets) / 1e3
    copy_total = sum(b["copy_ms"] * b["tapes"] for b in buckets) / 1e3
    phases["5 per-bucket timing"] = time.perf_counter() - t0
    log(f"phase 5: dp main path = {kern_total:.3f} s kernel + {copy_total:.3f} s C to host "
        f"(per-bucket CUDA events x tapes) of {phases['3 dp main path']:.3f} s wall")

    for name, secs in phases.items():
        log(f"wall {name}: {secs:.3f} s")
    log(f"total wall {time.perf_counter() - t_start:.3f} s")
    log("kernels: ltsp_wavefront builds int32/float32/float64 (sm_90a), "
        f"main-path launches {main_launches}")
    log(json.dumps({"kernels": [{
        "name": "ltsp_wavefront",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ltsp_dp/csrc/ltsp_wavefront.cu",
        "replaces": "src/repro/kernels/ltsp_dp/ltsp_dp.py:101",
        "launches": sum(main_launches.values()),
        "max_abs_err": max_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
