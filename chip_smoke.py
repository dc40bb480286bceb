#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

Builds the hand-written CUDA kernels from ``src/repro_torch`` (one ``nvcc``
per source, all at once) and holds each against its plain torch version: the
tiled table build (``far_fold_kernel`` and ``near_fold_kernel``) and the
device traceback (``traceback_kernel``), in int32, float32 and float64.  Then it drives the
port's main path at the paper's IN2P3 scale: the exact DP solve of every
``PAPER_PROFILE`` tape whose padded table fits the card, through
``solve_batch(..., ExecutionContext(backend="cuda", numeric_policy="f64"))``,
to a ``TapeLibrary`` read plan.  Every phase fails the run on any mismatch.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py

It imports neither ``jax`` nor the JAX package.  Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.  The last line of
its output is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels with their launches, errors and times.
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
#: the paper profile's median shape bucket (R_pad, S_pad), the largest R_pad
#: of the timed dp main path, and the largest R_pad whose dense f64 tables fit
#: the card (T and C of a (512, 16384) tape are 51.5 GB).
MEDIAN_BUCKET = (256, 8192)
MAIN_R_MAX = 256
DENSE_R_MAX = 512


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


def tiled_candidates(R: int, Tb: int) -> tuple[int, int]:
    """(far, near) detour starts of one unrestricted table per lane under
    tile ``Tb``: a window of tile diagonal D >= 1 has (D - 1) Tb + 1 far
    starts, the rest of its b - a starts are near."""
    far = near = 0
    for a in range(R):
        for b in range(a + 1, R):
            n_far = max(0, (b // Tb - a // Tb - 1) * Tb + 1)
            far += n_far
            near += b - a - n_far
    return far, near


def traceback_bound_ms(R: int, B: int) -> tuple[float, str]:
    """Least time for one traceback: each walk reads R - 1 cells of C (every
    step narrows its windows by one file), R multiplicities, and writes R
    detour rows and a count; its operations are a few per step."""
    moved = B * ((R - 1) * 4 + R * 4 + R * 2 * 4 + 4)
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


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
    from repro_torch.kernels.ltsp_dp import build, ltsp_dp, ops
    from repro_torch.kernels.ltsp_dp.ops import (
        _table_bound, bucket_shape, prepare_batch, rescale_instance, traceback_detours,
    )
    from repro_torch.kernels.ltsp_dp.ref import (
        far_fold, init_tables, ltsp_dp_tables_ref, ltsp_dp_tables_tiled_ref, near_update,
        tile_schedule, traceback_ref,
    )
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
    t0 = time.perf_counter()
    built = build.build_all()
    for name, (path, secs, ptxas) in built.items():
        log(f"build: {path.name} in {secs:.3f} s (0 = already built)")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
    for name in built:
        build.load(name)
    log(f"build: {len(built)} libraries in {time.perf_counter() - t0:.3f} s wall")

    # ---- phase 1: each kernel vs its plain version, bit for bit -------------
    t0 = time.perf_counter()
    max_err = {"tiled": 0.0, "traceback": 0.0}
    n_cases = 0
    tb_checked = 0

    def diff(a, b) -> float:
        return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0

    def check_traceback(C, x, label):
        nonlocal tb_checked
        dets, counts = ltsp_dp.ltsp_traceback(C, x)
        dets_p, counts_p = traceback_ref(C, x)
        torch.cuda.synchronize()
        max_err["traceback"] = max(max_err["traceback"], diff(dets, dets_p), diff(counts, counts_p))
        if not (torch.equal(dets, dets_p) and torch.equal(counts, counts_p)) or (counts < 0).any():
            raise SystemExit(f"phase 1 FAILED: traceback kernel != plain walk ({label})")
        tb_checked += C.shape[0]

    def compare(insts, dtype, span, disjoint, cand_tile, B_pad=None, label="", walk=True):
        nonlocal n_cases
        *arrays, S = prepare_batch(insts, dtype=dtype, B_pad=B_pad, device=dev)
        kw = dict(S=S, span=span, disjoint=disjoint, cand_tile=cand_tile)
        Tk, Ck = ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw)
        Tp, Cp = ltsp_dp_tables_ref(*arrays, **kw)
        torch.cuda.synchronize()
        max_err["tiled"] = max(max_err["tiled"], diff(Tk, Tp))
        n_cases += 1
        if not (torch.equal(Tk, Tp) and torch.equal(Ck, Cp)):
            bad = int(((Tk != Tp) | (Ck != Cp)).sum())
            raise SystemExit(
                f"phase 1 FAILED: tiled build != plain version ({label}, {dtype}, span={span}, "
                f"disjoint={disjoint}, cand_tile={cand_tile}): {bad} cells differ")
        if walk:
            check_traceback(Cp, arrays[2], label)

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

    configs = ((None, False, 128), (3, False, 128), (None, True, 128), (None, False, 4),
               (2, False, 4), (None, True, 4))
    for dtype in (torch.int32, torch.float32, torch.float64):
        for R_lo, R_hi in ((1, 2), (2, 3), (3, 24)):
            for span, disjoint, tile in configs:
                insts = [random_inst(R_lo, R_hi) for _ in range(3)]
                compare(insts, dtype, span, disjoint, tile, B_pad=4, label="batched")
                compare(insts[:1], dtype, span, disjoint, tile, label="single")
    # int32 cells past the sentinel and past 2**31 (wrapping), both scan forms;
    # such planes are no DP's, so the traceback is not walked there
    for tile in (128, 3):
        for span, disjoint in ((None, False), (2, False), (None, True)):
            compare([random_inst(3, 10, scale=10**6)], torch.int32, span, disjoint, tile,
                    label="int32 wrap", walk=False)
    n_small = n_cases
    # several tile diagonals, ragged last tiles
    for dtype in (torch.int32, torch.float32, torch.float64):
        for span, disjoint, tile in configs:
            compare([random_inst(17, 90) for _ in range(2)], dtype, span, disjoint, tile,
                    B_pad=2, label="tiled")
    log(f"phase 1a: {n_small} small cases + {n_cases - n_small} multi-tile cases bit-equal "
        f"(tiled build vs plain, int32, float32, float64); "
        f"traceback kernel == plain walk on {tb_checked} planes")

    # every launch of the tiled build against its plain step, from one state
    n_steps = 0
    for dtype in (torch.int32, torch.float32, torch.float64):
        for span, disjoint, tile in configs[:3]:
            insts = [random_inst(40, 70) for _ in range(2)]
            *arrays, S = prepare_batch(insts, dtype=dtype, device=dev)
            R = arrays[0].shape[1]
            Tb = ltsp_dp.TILE[str(dtype).removeprefix("torch.")]
            T, C = init_tables(arrays[0], arrays[1], arrays[3], S)
            for step, D, k in tile_schedule(R, Tb):
                Tk, Ck = T.clone(), C.clone()
                if step == "far":
                    ltsp_dp.ltsp_far_fold(Tk, Ck, *arrays, D, span=span, disjoint=disjoint)
                    far_fold(T, C, *arrays, D, Tb=Tb, span=span, disjoint=disjoint)
                else:
                    ltsp_dp.ltsp_near_fold(Tk, Ck, *arrays, D, k, span=span, disjoint=disjoint,
                                           cand_tile=tile)
                    near_update(T, C, *arrays, D, k, Tb=Tb, span=span, disjoint=disjoint,
                                static_tile=R - 1 <= tile)
                torch.cuda.synchronize()
                max_err["tiled"] = max(max_err["tiled"], diff(Tk, T))
                if not (torch.equal(Tk, T) and torch.equal(Ck, C)):
                    raise SystemExit(f"phase 1 FAILED: {step}_fold_kernel (D={D}, k={k}) != "
                                     f"its plain step ({dtype}, span={span}, disjoint={disjoint})")
                n_steps += 1
    log(f"phase 1a: far_fold_kernel and near_fold_kernel == their plain steps on {n_steps} "
        f"launches")

    u_half = u_turn_values(generate_dataset(PAPER_PROFILE))["half_seg"]
    paper = generate_dataset(PAPER_PROFILE, u_turn=u_half)
    by_bucket: dict[tuple[int, int], list[int]] = {}
    for i, inst in enumerate(paper):
        by_bucket.setdefault(bucket_shape(inst), []).append(i)
    wide = [i for i, inst in enumerate(paper) if _table_bound(rescale_instance(inst)[0]) >= 2**31]
    log(f"paper profile: {len(paper)} tapes, U = {u_half}, {len(wide)} fail the int32 guard")
    median = by_bucket[MEDIAN_BUCKET]

    def tape_arrays(idx):
        scaled = rescale_instance(paper[idx])[0]
        R_pad, S_pad = bucket_shape(scaled)
        *arrays, S = prepare_batch([scaled], dtype=torch.float64, R_pad=R_pad, S_pad=S_pad,
                                   device=dev)
        return arrays, S

    timing: dict = {}
    for j, (idx, span) in enumerate(((median[0], None),
                                     (median[1], logdp_span(paper[median[1]].n_req, 5.0)))):
        arrays, S = tape_arrays(idx)
        R_pad = arrays[0].shape[1]
        kw = dict(S=S, span=span, disjoint=False, cand_tile=ltsp_dp.DEFAULT_CAND_TILE)
        Tk, Ck = ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw)
        t1 = sync_now()
        Tp, Cp = ltsp_dp_tables_ref(*arrays, **kw)
        plain_s = sync_now() - t1
        if not (torch.equal(Tk, Tp) and torch.equal(Ck, Cp)):
            raise SystemExit(f"phase 1 FAILED: paper tape {idx} tiled build != plain (span={span})")
        max_err["tiled"] = max(max_err["tiled"], diff(Tk, Tp))
        del Tp, Cp
        t1 = sync_now()
        Tt, Ct = ltsp_dp_tables_tiled_ref(*arrays, Tb=ltsp_dp.TILE["float64"], **kw)
        tiled_plain_s = sync_now() - t1
        if not (torch.equal(Tk, Tt) and torch.equal(Ck, Ct)):
            raise SystemExit(f"phase 1 FAILED: paper tape {idx} tiled build != tiled plain")
        del Tt, Ct
        if j == 0:
            tiled_ms = events_ms(lambda: ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw), reps=3)
            # the split of the tiled build: table set-up and the far launches
            # are each timed alone (the far launches re-run on the finished
            # tables, which changes none of their work); the rest is a
            # difference, not a measurement
            init_ms = events_ms(lambda: init_tables(arrays[0], arrays[1], arrays[3], S), reps=3)
            n_tiles = -(-R_pad // ltsp_dp.TILE["float64"])
            far_ms = events_ms(lambda: [ltsp_dp.ltsp_far_fold(Tk, Ck, *arrays, D, span=None)
                                        for D in range(1, n_tiles)], reps=2)
            b_ms, b_by = bound_ms(R_pad, S, 1, "float64", None, False)
            # modelled bytes from device memory: the far fold loads 2 * 8 / Tb
            # bytes per far candidate, the near fold both operands (16 bytes)
            far_c, near_c = tiled_candidates(R_pad, ltsp_dp.TILE["float64"])
            far_gb = far_c * S * 16 / ltsp_dp.TILE["float64"] / 1e9
            near_gb = near_c * S * 16 / 1e9
            near_ms = tiled_ms - init_ms - far_ms
            timing = {"tape": idx, "R_pad": R_pad, "S_pad": S, "ms": tiled_ms,
                      "plain_ms": 1e3 * tiled_plain_s, "bound_ms": b_ms, "bound_by": b_by}
            log(f"phase 1b: paper tape {idx} ({R_pad}, {S}) f64 dp: tiled build {tiled_ms:.3f} ms "
                f"(set-up alone {init_ms:.3f} ms, far launches alone {far_ms:.3f} ms, build - "
                f"set-up - far {near_ms:.3f} ms), bound {b_ms:.3f} ms "
                f"({b_by}); plain: tiled {1e3 * tiled_plain_s:.3f} ms, per-diagonal "
                f"{1e3 * plain_s:.3f} ms")
            log(f"phase 1b: modelled bytes: far fold {far_gb:.3f} GB for {far_c * S} far "
                f"candidates, {far_gb / far_ms:.3f} TB/s over the far launches alone; near fold "
                f"{near_gb:.3f} GB for {near_c * S} near candidates, {near_gb / near_ms:.3f} TB/s "
                f"over build - set-up - far")
        else:
            log(f"phase 1b: paper tape {idx} ({R_pad}, {S}) f64 span={span}: bit-equal")
        del Tk, Ck
    torch.cuda.empty_cache()
    phases["1 kernels vs plain"] = time.perf_counter() - t0
    log(f"phase 1: all bit-equal, max_abs_err {max_err}, {phases['1 kernels vs plain']:.3f} s")

    # ---- phase 1c: the device traceback against the host walk ----------------
    t0 = time.perf_counter()
    tb_ms = tb_plain_ms = None
    for n, idx in enumerate(median):
        arrays, S = tape_arrays(idx)
        _, C = ltsp_dp.ltsp_dp_tables(*arrays, device=dev, S=S)
        dets, counts = ltsp_dp.ltsp_traceback(C, arrays[2])
        host = traceback_detours(C[0].cpu().numpy(), arrays[2][0].cpu().numpy())
        got = [tuple(d) for d in dets[0, :int(counts[0])].tolist()]
        if got != host:
            raise SystemExit(f"phase 1c FAILED: tape {idx} device traceback != traceback_detours")
        if n == 0:
            check_traceback(C, arrays[2], f"paper tape {idx}")
            tb_ms = events_ms(lambda: ltsp_dp.ltsp_traceback(C, arrays[2]), reps=5)
            t1 = sync_now()
            traceback_ref(C, arrays[2])
            tb_plain_ms = 1e3 * (sync_now() - t1)
        del C
    torch.cuda.empty_cache()
    tb_bound, tb_by = traceback_bound_ms(MEDIAN_BUCKET[0], 1)
    phases["1c traceback vs host walk"] = time.perf_counter() - t0
    log(f"phase 1c: ltsp_traceback == traceback_detours on {len(median)} median-bucket tapes; "
        f"at ({MEDIAN_BUCKET[0]}, {MEDIAN_BUCKET[1]}) kernel {tb_ms:.4f} ms, plain walk "
        f"{tb_plain_ms:.3f} ms, bound {tb_bound:.7f} ms ({tb_by}), "
        f"{phases['1c traceback vs host walk']:.3f} s")

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
    fits = [i for i, inst in enumerate(paper) if bucket_shape(inst)[0] <= MAIN_R_MAX]
    ltsp_dp.reset_launches()
    host_before = ops.HOST_BYTES["copied"]
    t0 = time.perf_counter()
    dp_res = solve_batch([paper[i] for i in fits], "dp", context=f64)
    main_launches = dict(ltsp_dp.LAUNCHES)
    torch.cuda.synchronize()
    phases["3 dp main path"] = time.perf_counter() - t0
    host_bytes = ops.HOST_BYTES["copied"] - host_before
    for i, res in zip(fits, dp_res):
        if res.cost != evaluate_detours(paper[i], res.detours):
            raise SystemExit(f"phase 3 FAILED: tape {i} dp cost != oracle")
    most = max(8 + 8 * bucket_shape(paper[i])[0] + 4 for i in fits)
    log(f"phase 3: dp on {len(fits)} tapes (R_pad <= {MAIN_R_MAX}) in "
        f"{phases['3 dp main path']:.3f} s, launches {main_launches}")
    log(f"phase 3: host bytes {host_bytes} in all, {host_bytes / len(fits):.1f} per tape "
        f"(root value + detours + count: at most {most} per tape)")
    if host_bytes > len(fits) * most:
        raise SystemExit("phase 3 FAILED: the main path copied more than O(R) bytes per tape")
    for name in ("far_fold_kernel", "near_fold_kernel", "traceback_kernel"):
        if main_launches[name] == 0:
            raise SystemExit(f"phase 3 FAILED: the main path launched no {name}")
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
    # the next bucket up, and the largest tapes, which never fit
    big = [i for i, inst in enumerate(paper) if bucket_shape(inst)[0] == DENSE_R_MAX]
    huge = [i for i, inst in enumerate(paper) if bucket_shape(inst)[0] > DENSE_R_MAX]
    t0 = time.perf_counter()
    host_before = ops.HOST_BYTES["copied"]
    got = solve_batch([paper[i] for i in big], "dp", context=f64)
    for i, res in zip(big, got):
        if res.cost != evaluate_detours(paper[i], res.detours):
            raise SystemExit(f"phase 3 FAILED: tape {i} dp cost != oracle")
    torch.cuda.empty_cache()
    phases[f"3 dp (R_pad = {DENSE_R_MAX})"] = time.perf_counter() - t0
    log(f"phase 3: dp on the {len(big)} R_pad = {DENSE_R_MAX} tapes in "
        f"{phases[f'3 dp (R_pad = {DENSE_R_MAX})']:.3f} s, host bytes "
        f"{ops.HOST_BYTES['copied'] - host_before}")
    t_gib = [8 * bucket_shape(paper[i])[0] ** 2 * bucket_shape(paper[i])[1] / 2**30 for i in huge]
    log(f"phase 3: left out the {len(huge)} tapes with R_pad > {DENSE_R_MAX}: a dense f64 T "
        f"alone is {min(t_gib):.0f}-{max(t_gib):.0f} GiB, more than the card holds")

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

    # ---- phase 5: kernel times per bucket of the main path -------------------
    t0 = time.perf_counter()
    buckets = []
    for shape in sorted({bucket_shape(paper[i]) for i in fits}):
        idx = by_bucket[shape][0]
        arrays, S = tape_arrays(idx)
        kw = dict(S=S, span=None, disjoint=False, cand_tile=ltsp_dp.DEFAULT_CAND_TILE)
        ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw)
        k_ms = events_ms(lambda: ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw), reps=2)
        T, C = ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw)
        t_ms = events_ms(lambda: ltsp_dp.ltsp_traceback(C, arrays[2]), reps=3)
        dets, counts = ltsp_dp.ltsp_traceback(C, arrays[2])
        t1 = sync_now()
        for t in (T[:, 0, shape[0] - 1, 0], dets, counts):
            t.cpu()
        c_ms = 1e3 * (time.perf_counter() - t1)
        del T, C
        b_ms, b_by = bound_ms(shape[0], shape[1], 1, "float64", None, False)
        n_tapes = len(by_bucket[shape])
        buckets.append({"R_pad": shape[0], "S_pad": shape[1], "tapes": n_tapes,
                        "kernel_ms": k_ms, "traceback_ms": t_ms,
                        "copy_ms": c_ms, "bound_ms": b_ms, "bound_by": b_by})
        log(f"  bucket {shape}: {n_tapes} tapes, tiled build {k_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), traceback {t_ms:.4f} ms, copy to host {c_ms:.4f} ms")
    torch.cuda.empty_cache()
    kern_total = sum(b["kernel_ms"] * b["tapes"] for b in buckets) / 1e3
    rest_total = sum((b["traceback_ms"] + b["copy_ms"]) * b["tapes"] for b in buckets) / 1e3
    phases["5 per-bucket timing"] = time.perf_counter() - t0
    log(f"phase 5: dp main path = {kern_total:.3f} s tiled build + {rest_total:.3f} s traceback "
        f"and copy (per-bucket CUDA events and host clock x tapes) of "
        f"{phases['3 dp main path']:.3f} s wall")

    for name, secs in phases.items():
        log(f"wall {name}: {secs:.3f} s")
    log(f"total wall {time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"kernels": [{
        "name": "ltsp_tiled",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ltsp_dp/csrc/ltsp_tiled.cu",
        "replaces": "src/repro/kernels/ltsp_dp/ltsp_dp.py:101",
        "launches": main_launches["far_fold_kernel"] + main_launches["near_fold_kernel"],
        "max_abs_err": max_err["tiled"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }, {
        "name": "ltsp_traceback",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ltsp_dp/csrc/ltsp_traceback.cu",
        "replaces": "src/repro/kernels/ltsp_dp/ops.py:263",
        "launches": main_launches["traceback_kernel"],
        "max_abs_err": max_err["traceback"],
        "ms": tb_ms,
        "plain_ms": tb_plain_ms,
        "bound_ms": tb_bound,
        "bound_by": tb_by,
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
