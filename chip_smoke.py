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



#: the reference serving tests' seed (demo-library scale, phase 6)
SERVE_SEED = 20260731
#: phase 7: paper tapes whose requested files make the library's cartridges,
#: and the seeded request trace served against them (see PERF.md section 4)
IN2P3_TAPES = 8
IN2P3_NREQ = (64, 256)
IN2P3_TRACE = dict(n_requests=70_000, mean_interarrival=2_500, seed=SERVE_SEED, skew=0.6)
IN2P3_SERVE = dict(window=40_000_000, n_drives=4)
#: mount, unmount and seek to the load point: 90 s, 60 s, 20 s at 300 MB/s
IN2P3_DRIVE_COSTS = dict(mount=27_000, unmount=18_000, load_seek=6_000)
#: the paper's Table 1 ranges of requested files and of requests per tape
PAPER_NREQ, PAPER_N = (31, 852), (1_182, 15_477)


def serving_exactness(dev: str) -> None:
    """Phase 6: serve the reference's serving scenarios on ``cuda`` and on
    ``python`` and require the same timelines, summaries and journals.

    The cell counters (``cells_evaluated``/``cells_reused``) count dense
    device cells on the device backends and real DP cells on ``python``, in
    the JAX package too, so they are held against ``torch`` on the same card
    instead.
    """
    import dataclasses
    import shutil

    from repro_torch.data.traces import qos_poisson_trace, to_requests
    from repro_torch.kernels.ltsp_dp import ltsp_dp
    from repro_torch.obs import Observability
    from repro_torch.serving import (
        DriveCosts, FaultPlan, RetryPolicy, SolverFault, demo_library, poisson_trace,
        recover_server, seeded_fault_plan, serve_trace,
    )

    costs = DriveCosts(mount=150_000, unmount=60_000, load_seek=30_000)
    jdir = ROOT / "build" / "chip_smoke"
    shutil.rmtree(jdir, ignore_errors=True)
    jdir.mkdir(parents=True)

    def trace(n, rate):
        return poisson_trace(demo_library(SERVE_SEED), n, rate, seed=SERVE_SEED)

    records = qos_poisson_trace(demo_library(SERVE_SEED), n_requests=200,
                                mean_interarrival=250_000, seed=SERVE_SEED,
                                tightness=8_000_000)
    qtrace, qos = to_requests(records, demo_library(SERVE_SEED))
    ftrace = trace(200, 100_000)
    pool = dict(window=400_000, n_drives=2, drive_costs=costs)
    scenarios = {
        "accumulate": (trace(200, 250_000), "accumulate", lambda b: dict(window=400_000)),
        "batched-2-drives": (trace(200, 250_000), "batched", lambda b: pool),
        "edf-global-qos": (qtrace, "edf-global", lambda b: dict(pool, qos=qos)),
        "preempt-warm": (trace(240, 150_000), "preempt",
                         lambda b: dict(window=400_000, warm_start=True)),
        "seeded-faults": (ftrace, "accumulate", lambda b: dict(
            pool, retry=RetryPolicy(), faults=seeded_fault_plan(
                demo_library(SERVE_SEED), ftrace, seed=3, n_drives=2,
                solver_faults=2, backend=b))),
    }

    def serve(name, backend, device=dev, obs=None, **extra):
        tr, admission, kw = scenarios[name]
        lib = demo_library(SERVE_SEED)
        path = jdir / f"{name}-{backend}-{device}.jsonl"
        path.unlink(missing_ok=True)  # the journal appends
        report = serve_trace(lib, tr, admission, policy="dp", journal=str(path),
                             context=lib.context.replace(backend=backend, device=device, obs=obs,
                                                         numeric_policy="f64"),
                             **dict(kw(backend), **extra))
        return report, path

    cells = ("cells_evaluated", "cells_reused", "cells_per_batch")

    def timeline(report, with_cells=False):
        summary = {k: v for k, v in report.summary().items()
                   if k != "backend" and (with_cells or k not in cells)}
        batches = [dataclasses.astuple(dataclasses.replace(
            b, degraded_to=None if b.degraded_to is None else "fallback",
            **({} if with_cells else {"cells_evaluated": 0, "cells_reused": 0})))
            for b in report.batches]
        return (list(summary.items()), [dataclasses.astuple(r) for r in report.served],
                [dataclasses.astuple(f) for f in report.failed], batches)

    launches: dict[str, int] = {}
    for name in scenarios:
        t0 = time.perf_counter()
        ltsp_dp.reset_launches()
        cuda, cuda_path = serve(name, "cuda")
        for k, v in ltsp_dp.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        t_cuda = time.perf_counter() - t0
        py, py_path = serve(name, "python")
        if timeline(cuda) != timeline(py):
            raise SystemExit(f"phase 6 FAILED: {name}: cuda timeline or summary != python")
        if cuda_path.read_bytes() != py_path.read_bytes():
            raise SystemExit(f"phase 6 FAILED: {name}: cuda journal != python journal")
        plain, _ = serve(name, "torch")
        if timeline(cuda, with_cells=True) != timeline(plain, with_cells=True):
            raise SystemExit(f"phase 6 FAILED: {name}: cuda cell counters != torch on the card")
        if any(b.degraded_to is not None for b in cuda.batches):
            raise SystemExit(f"phase 6 FAILED: {name}: cuda fell back with no fault on cuda")
        log(f"phase 6: {name}: {cuda.n_served} served, {len(cuda.batches)} batches, cuda == "
            f"python (timelines, summaries, journal {len(cuda_path.read_bytes())} bytes), cells "
            f"{cuda.cells_evaluated} evaluated / {cuda.cells_reused} reused == torch on the "
            f"card; cuda run {t_cuda:.3f} s")
        if name == "preempt-warm" and cuda.cells_reused == 0:
            raise SystemExit("phase 6 FAILED: the warm run reused no cell")

    # recovery from a torn journal, on the card
    full, path = serve("seeded-faults", "cuda")
    data = path.read_bytes()
    cut = jdir / "seeded-faults-cut.jsonl"
    cut.write_bytes(data[: len(data) // 2])
    tr, admission, kw = scenarios["seeded-faults"]
    lib = demo_library(SERVE_SEED)
    rec = recover_server(lib, tr, str(cut), admission=admission, policy="dp",
                         context=lib.context.replace(backend="cuda", device=dev,
                                                     numeric_policy="f64"),
                         **kw("cuda"))
    if cut.read_bytes() != data or timeline(rec, True) != timeline(full, True):
        raise SystemExit("phase 6 FAILED: recover_server on cuda is not byte-identical")
    # a fault that exhausts the cuda tier degrades to torch, same schedules
    down, _ = serve("accumulate", "cuda", retry=RetryPolicy(),
                    faults=FaultPlan(solver_faults=(SolverFault("cuda", count=3),)))
    py, _ = serve("accumulate", "python")
    if ([dataclasses.astuple(r) for r in down.served] != [dataclasses.astuple(r) for r in py.served]
            or down.fault_stats["fallbacks"] < 1 or down.batches[0].degraded_to != "torch"):
        raise SystemExit("phase 6 FAILED: cuda -> torch degradation changed the timeline")
    # observability on the card: the run is unchanged, the kernel profile fills
    obs = Observability.enabled(wall=True)
    bare, _ = serve("batched-2-drives", "cuda")
    seen, _ = serve("batched-2-drives", "cuda", obs=obs)
    prof = obs.kernel
    if (timeline(seen, True) != timeline(bare, True) or not prof.launches
            or any(r.interpret or not r.wall_ns for r in prof.launches)
            or obs.metrics.counter("batches_total") != len(seen.batches)):
        raise SystemExit("phase 6 FAILED: an observed cuda run differs or recorded nothing")
    log(f"phase 6: recover_server from a journal cut at {len(data) // 2} of {len(data)} bytes "
        f"is byte-identical; cuda -> torch after 3 faults ({down.fault_stats['fallbacks']} "
        f"fallbacks) serves python's timeline; observed run == bare run, "
        f"{len(prof.launches)} profiled launches; cuda launches {launches}")
    if launches["near_fold_kernel"] == 0:
        raise SystemExit("phase 6 FAILED: the cuda runs launched no near_fold_kernel")
    shutil.rmtree(jdir, ignore_errors=True)


def in2p3_serve() -> dict:
    """Phase 7's server options (besides policy, context and verify)."""
    from repro_torch.serving import DriveCosts

    return dict(IN2P3_SERVE, drive_costs=DriveCosts(**IN2P3_DRIVE_COSTS))


def in2p3_library(paper: list, u_turn: int, context):
    """Phase 7's library: one cartridge per paper tape of :data:`IN2P3_NREQ`
    (the first :data:`IN2P3_TAPES`), holding that tape's requested files,
    their sizes scaled in proportion to fill the 20 TB cartridge exactly, so
    no cartridge shares files with another.  Returns ``(library, tapes)``."""
    import numpy as np

    from repro_torch.data import PAPER_PROFILE
    from repro_torch.storage.tape import TapeLibrary

    cap = PAPER_PROFILE.tape_capacity
    lo, hi = IN2P3_NREQ
    tapes = [i for i, inst in enumerate(paper) if lo < inst.n_req <= hi][:IN2P3_TAPES]
    lib = TapeLibrary(capacity_per_tape=cap, u_turn=u_turn, context=context)
    for k, i in enumerate(tapes):
        sizes = (paper[i].right - paper[i].left).astype(np.int64)
        sizes = sizes * cap // int(sizes.sum())
        sizes[-1] += cap - int(sizes.sum())
        for f, size in enumerate(sizes.tolist()):
            lib.store(f"c{k}f{f:03d}", int(size))
    if len(lib.tapes) != len(tapes):
        raise SystemExit("phase 7 FAILED: a cartridge holds files of two paper tapes")
    return lib, tapes


def in2p3_serving(paper: list, u_turn: int, dev: str) -> None:
    """Phase 7: serve an IN2P3-scale request trace on ``cuda``, timed.

    The library is :func:`in2p3_library`'s.  The table build, the copies to
    the host, the traceback, the server's solves and its verify are wrapped
    with timers for the run; the wrappers call the originals unchanged.
    """
    import collections
    import resource

    import torch

    from repro_torch.core import ExecutionContext
    from repro_torch.kernels.ltsp_dp import ltsp_dp, ops
    from repro_torch.serving import poisson_trace, serve_trace
    from repro_torch.serving import queue as squeue

    lib, tapes = in2p3_library(paper, u_turn, ExecutionContext(
        backend="cuda", numeric_policy="f64", device=dev))
    trace = poisson_trace(lib, **IN2P3_TRACE)
    log(f"phase 7: library of {len(tapes)} cartridges from paper tapes {tapes} "
        f"(n_req {[paper[i].n_req for i in tapes]}), U = {u_turn}; trace {IN2P3_TRACE}, "
        f"{IN2P3_SERVE}")

    events, host = [], collections.defaultdict(float)
    dispatch = []
    originals = (ops.ltsp_dp_tables, ops._to_host, ops.traceback_detours,
                 squeue.solve_warm, squeue.verify_schedule)

    def tables(*args, **kwargs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        out = originals[0](*args, **kwargs)
        stop.record()
        stop.synchronize()
        host["build"] += time.perf_counter() - t1
        events.append((start, stop))
        return out

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t1 = time.perf_counter()
            out = fn(*args, **kwargs)
            host[key] += time.perf_counter() - t1
            return out
        return wrapper

    def solve(inst, **kwargs):
        before = dict(host)
        t1 = time.perf_counter()
        out = originals[3](inst, **kwargs)
        dispatch.append((inst, time.perf_counter() - t1,
                         {k: host[k] - before.get(k, 0.0) for k in host}))
        return out

    ops.ltsp_dp_tables, ops._to_host = tables, timed("copy", originals[1])
    ops.traceback_detours, squeue.solve_warm = timed("traceback", originals[2]), solve
    squeue.verify_schedule = timed("verify", originals[4])
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    host_before = ops.HOST_BYTES["copied"]
    try:
        ltsp_dp.reset_launches()
        t0 = time.perf_counter()
        report = serve_trace(lib, trace, "accumulate", policy="dp", context=lib.context, verify=True,
                             warm_start=False, **in2p3_serve())
        wall = time.perf_counter() - t0
        launches = dict(ltsp_dp.LAUNCHES)
    finally:
        (ops.ltsp_dp_tables, ops._to_host, ops.traceback_detours,
         squeue.solve_warm, squeue.verify_schedule) = originals
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    host_bytes = ops.HOST_BYTES["copied"] - host_before

    if report.n_served != len(trace):
        raise SystemExit(f"phase 7 FAILED: served {report.n_served} of {len(trace)}")
    if report.backend != "cuda":
        raise SystemExit(f"phase 7 FAILED: served on {report.backend}, not cuda")
    for b in report.batches:
        if not b.verified or b.solver_cost != b.replay_cost:
            raise SystemExit(f"phase 7 FAILED: {b.tape_id} schedule cost != replay_schedule")
    n_fallbacks = sum(b.degraded_to is not None for b in report.batches)
    if n_fallbacks or not launches["far_fold_kernel"] or not launches["near_fold_kernel"]:
        raise SystemExit(f"phase 7 FAILED: fallbacks {n_fallbacks}, launches {launches}")
    if len(dispatch) != len(report.batches) or len(events) != len(dispatch):
        raise SystemExit("phase 7 FAILED: a dispatch did not build its tables on the card")

    build_ms = [start.elapsed_time(stop) for start, stop in events]
    rows = []
    for (inst, secs, parts), kernel_ms in zip(dispatch, build_ms):
        R_pad, S_pad = ops.bucket_shape(inst)
        rows.append({"R_pad": R_pad, "S_pad": S_pad, "n_req": inst.n_req, "n": inst.n,
                     "solve_ms": 1e3 * secs, "build_ms": kernel_ms,
                     "copy_ms": 1e3 * parts.get("copy", 0.0),
                     "traceback_ms": 1e3 * parts.get("traceback", 0.0),
                     "other_ms": 1e3 * (secs - parts.get("build", 0.0) - parts.get("copy", 0.0)
                                        - parts.get("traceback", 0.0))})
    hist = collections.Counter((r["R_pad"], r["S_pad"]) for r in rows)
    r_pads = sorted(r["R_pad"] for r in rows)
    inside = sum(PAPER_NREQ[0] <= r["n_req"] <= PAPER_NREQ[1] and PAPER_N[0] <= r["n"] <= PAPER_N[1]
                 for r in rows)
    log(f"phase 7: {len(rows)} dispatches, (R_pad, S_pad) histogram "
        f"{sorted(hist.items())}; n_req {min(r['n_req'] for r in rows)}-"
        f"{max(r['n_req'] for r in rows)}, n {min(r['n'] for r in rows)}-"
        f"{max(r['n'] for r in rows)}; {inside} of {len(rows)} inside the paper's Table 1 "
        f"ranges (n_req {PAPER_NREQ}, n {PAPER_N})")
    for r in rows:
        log(f"  dispatch ({r['R_pad']}, {r['S_pad']}) n_req {r['n_req']} n {r['n']}: solve "
            f"{r['solve_ms']:.3f} ms = build {r['build_ms']:.3f} (CUDA events) + copy to host "
            f"{r['copy_ms']:.3f} + host traceback {r['traceback_ms']:.3f} + other "
            f"{r['other_ms']:.3f} (DenseStore copies, packing, guards)")
    if r_pads[len(r_pads) // 2] < 128 or r_pads.count(256) < 3:
        raise SystemExit(f"phase 7 FAILED: dispatch sizes {r_pads} miss the targets")
    solve_s = sum(r["solve_ms"] for r in rows) / 1e3
    other_s = solve_s - host["build"] - host["copy"] - host["traceback"]
    log(f"phase 7: {report.n_served} requests served in {wall:.3f} s wall: table build "
        f"{sum(build_ms) / 1e3:.3f} s (CUDA events), copies of T/C to the host "
        f"{host['copy']:.3f} s, DenseStore copies and packing {other_s:.3f} s, "
        f"host traceback {host['traceback']:.3f} s, verify {host['verify']:.3f} s, "
        f"rest of the event loop {wall - solve_s - host['verify']:.3f} s")
    log(f"phase 7: host bytes {host_bytes} ({host_bytes / 2**30:.3f} GiB), peak host RSS "
        f"{rss1 / 2**20:.3f} GiB (before the phase {rss0 / 2**20:.3f} GiB), fallbacks 0, "
        f"launches {launches}")


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

    # ---- phase 6: serving exactness on the card ----------------------------
    t0 = time.perf_counter()
    serving_exactness(dev)
    phases["6 serving exactness"] = time.perf_counter() - t0

    # ---- phase 7: an IN2P3-scale trace served on the card, timed -------------
    t0 = time.perf_counter()
    in2p3_serving(paper, u_half, dev)
    phases["7 IN2P3-scale serving"] = time.perf_counter() - t0

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
