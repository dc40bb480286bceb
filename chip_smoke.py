#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

Builds the hand-written CUDA kernels from ``src/repro_torch`` (one ``nvcc``
per source, all at once) and holds each against its plain torch version: the
tiled table build (``far_fold_kernel`` and ``near_fold_kernel``) and the
device traceback (``traceback_kernel``), in int32, float32 and float64.  Then it drives the
port's main path at the paper's IN2P3 scale: the exact DP solve of every
``PAPER_PROFILE`` tape whose padded table fits the card, through
``solve_batch(..., ExecutionContext(backend="cuda", numeric_policy="f64"))``,
to a ``TapeLibrary`` read plan.  Phase 1c also times the dependent-load
latency behind the traceback's bound (``csrc/pointer_chase.cu``).  Phase 1d
runs the card-only tests under this machine's torch: the ``cuda`` cases of
every ``tests/test_torch_*.py`` that marks one, and the four-rank tests of
``tests/test_torch_four_ranks.py``, in two child processes started together;
every case they select must pass.  Phases 6
and 7 serve request traces on the card (the reference's scenarios against
``python``, then an IN2P3-scale trace, timed); phase 8 serves the fleet
federation: 8a the reference's fleet under three placements with a shard
outage, ``recover_fleet`` and the launcher's tape modes, all against
``python``; 8b and 8c a three-library federation of paper-tape cartridges
through an outage, timed per shard: 8b a burst that every shard drains in one
window, 8c a trace three windows long that dispatches before and after the
outage and has batches in flight when it strikes; 8d runs every example of
``examples/torch/`` with its defaults (the card) and on ``python``, and holds
their numbers equal.  Phase 9 serves a language model: 9a Qwen2.5-3B at full
width on the card (float32 decode against forward, then bf16 serving,
timed); 9b the restore of its checkpoint from tape, planned under ``dp`` and
``simpledp`` through the CUDA kernels and held equal to ``python``, the
launcher's ``--restore-from-tape`` on ``cuda`` and ``python`` and its LM mode
on the card (its default command, and every dense decoder); 9c the
``tape_restore`` and ``serve_batched`` examples.  Phase 10 trains: 10a
Qwen2.5-3B at full width through the training launcher's loop, 20 steps,
timed and profiled; 10b the reduced dense decoders' loss and gradients on
the card against the CPU, and 4 microbatches against the whole batch; 10c
the training example's corpus plan through the CUDA kernels against
``python``, the example with its defaults, and the launcher checkpointed
and resumed.  Phase 11 runs the MoE and MLA paths: 11a DeepSeek-V2 at full
width cut to 3 layers (float32 decode against forward, then bf16 serving,
timed and profiled); 11b the restore of the whole DeepSeek-V2 and Kimi-K2
checkpoints from 20 TB cartridges, planned through the CUDA kernels and
held equal to ``python``; 11c both MoE archs reduced on the card against
the CPU (forward, decode, routing, greedy tokens, a train step under both
dispatch modes) and through both launchers.  Phase 12 runs the Mamba and
xLSTM paths: 12a Jamba at full width cut to one period (8 layers) and 12b
xLSTM-1.3B whole (float32 decode against forward over 512 tokens, two of
Jamba's Mamba chunks, then bf16 serving, timed and profiled); 12c the
restore of both whole checkpoints from 20 TB cartridges through the CUDA
kernels, held equal to ``python``; 12d both archs reduced on the card
against the CPU and through both launchers.  Phase 13 runs cross-attention
and the encoder-decoder path: 13a Llama-3.2-Vision at full width cut to two
periods (10 layers, two of them ``xattn``) over 1601 random vision
embeddings and 13b SeamlessM4T-large-v2 whole over 1500 random frames
through its encoder (float32 decode against warmed cross caches against the
forward over the memory, then the memory prefill and bf16 serving, timed and
profiled); 13c the restore of both whole checkpoints from 20 TB cartridges
through the CUDA kernels, held equal to ``python``; 13d both archs reduced
on the card against the CPU and through both launchers; 13e SeamlessM4T
trained at full width through the training launcher's loop.  Phase 14 runs
the mesh path on the card's world of one rank (a NCCL group over a
``FileStore``): 14a Qwen2.5-3B trained at full width on the plain path and
on the mesh path, every parameter and moment a ``DTensor``, held equal bit
for bit, and the dry run's tracker (arguments plus temporaries of the
step, on ``meta`` tensors on the CPU) within 10% of the allocator's
high-water mark over one step on each path; 14b its bf16 serving on both,
the cache placed by ``cache_pspecs``, greedy tokens held equal; 14c
``--mesh pod|multipod`` raising the reference's ``RuntimeError`` and
``compressed_grads`` on the trained model's gradients; 14d the dry run's
Qwen2.5-3B ``train_4k`` and ``prefill_32k`` cells on both production
meshes, on the CPU, each device's flops held within 5% of the JAX package's
count of the same cell.  Every phase fails the run on any mismatch.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py

It imports neither ``jax`` nor the JAX package.  Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.  The last line of
its output is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels with their launches, errors and times.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks used for the bound (NVIDIA data sheet, dense, non-tensor
#: for the table types, tensor cores for bf16): HBM3 bandwidth and the
#: per-type operation rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12, "int32": 33.5e12,
                  "bfloat16": 989e12}
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
    """Least time for one table build: outputs written once vs candidate ops.
    The outputs are the packed tables the solver's uncaptured builds store,
    the windows ``a <= b`` alone."""
    item = 4 if type_name != "float64" else 8
    out_bytes = B * R * (R + 1) // 2 * S * (item + 4)  # T and C, packed
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


#: dependent loads timed by the pointer chase of phase 1c
CHASE_STEPS = 100_000


def dependent_load_ns(dev: str, R: int, S: int) -> float:
    """Phase 1c: nanoseconds per dependent load from device memory, by the
    one-thread pointer chase of ``csrc/pointer_chase.cu`` along one random
    cycle through a buffer the size of one ``(R, S)`` int32 argmin plane.
    The chain's first steps are held against the same walk on the host."""
    import torch

    from repro_torch.kernels.ltsp_dp import build

    lib = build.load("pointer_chase")
    n = R * R * S
    gen = torch.Generator(device=dev).manual_seed(20211217)
    order = torch.randperm(n, device=dev, generator=gen)
    nxt = torch.empty(n, dtype=torch.int32, device=dev)
    nxt[order] = order.roll(-1).to(torch.int32)
    start = int(order[0])
    del order
    out = torch.empty(1, dtype=torch.int32, device=dev)

    def chase(steps: int, first: int) -> None:
        rc = lib.pointer_chase(nxt.data_ptr(), steps, first, out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pointer_chase_kernel failed to launch: CUDA error {rc}")

    chase(16, start)
    walk = start
    for _ in range(16):
        walk = int(nxt[walk])
    if int(out[0]) != walk:
        raise SystemExit("phase 1c FAILED: pointer_chase_kernel != the walk on the host")
    times = []
    for _ in range(3):
        first = int(out[0])
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        chase(CHASE_STEPS, first)
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end) * 1e6 / CHASE_STEPS)
    del nxt
    torch.cuda.empty_cache()
    return sorted(times)[1]


#: phase 1d, the card-only tests: a port test file takes part when its
#: source marks a case ``cuda`` (its ``cuda`` cases run), and the four-rank
#: file runs whole; pytest's ``-m`` selects by marker, not by file, so each
#: set runs in a child process of its own, both started together
CUDA_MARK = re.compile(r"\bpytest\.mark\.cuda\b")
FOUR_RANK_TESTS = "tests/test_torch_four_ranks.py"
PYTEST = (sys.executable, "-m", "pytest", "-p", "no:cacheprovider")
CARD_COLLECT_TIMEOUT = 180
CARD_TESTS_TIMEOUT = 600


def card_test_files() -> list[str]:
    """The port's test files whose source marks a case ``cuda``."""
    return sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / "tests").glob("test_torch_*.py")
                  if CUDA_MARK.search(p.read_text()))


def card_suites() -> dict[str, tuple[list[str], list[str]]]:
    """Phase 1d's two sets of tests: ``{name: (pytest's selection arguments,
    the files selected)}``."""
    cuda_files = card_test_files()
    return {"cuda": (["-m", "cuda", *cuda_files], cuda_files),
            "four_ranks": ([FOUR_RANK_TESTS], [FOUR_RANK_TESTS])}


def card_tests_env() -> dict[str, str]:
    """A child's environment: the port and the tests' helpers on the path,
    torch on one thread as in the CPU suite."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    from torch_threads import ONE_THREAD_ENV

    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(ROOT / "tests")]),
                **ONE_THREAD_ENV)


def run_together(cmds: dict[str, list[str]], env: dict, timeout: float,
                 logs: Path) -> dict[str, tuple[int | None, float]]:
    """Run each command from the root of the checkout, all started together,
    each in a process group of its own with its output in ``logs/<name>.log``:
    ``{name: (exit code, or None when it ran past ``timeout``, seconds)}``.
    Every group is killed before this returns, whatever its child left running."""
    logs.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, cmd in cmds.items():
        with open(logs / f"{name}.log", "w") as out:
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                           stderr=subprocess.STDOUT, start_new_session=True)
    done: dict[str, tuple[int | None, float]] = {}
    try:
        while len(done) < len(procs) and time.perf_counter() - t0 < timeout:
            for name, proc in procs.items():
                if name not in done and proc.poll() is not None:
                    done[name] = (proc.returncode, time.perf_counter() - t0)
            time.sleep(0.2)
    finally:
        for proc in procs.values():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    return {name: done.get(name, (None, time.perf_counter() - t0)) for name in procs}


def collect_card_suites(logs: Path, pytest: tuple = PYTEST) -> dict[str, dict[str, int]]:
    """``--collect-only`` of phase 1d's two sets, both at once: ``{name: {file:
    cases selected}}``.  Fails the run when a collection fails."""
    suites = card_suites()
    cmds = {name: [*pytest, "--collect-only", "-q", *args] for name, (args, _) in suites.items()}
    counts = {}
    for name, (rc, _) in run_together(cmds, card_tests_env(), CARD_COLLECT_TIMEOUT, logs).items():
        out = (logs / f"{name}.log").read_text()
        if rc != 0:
            raise SystemExit(f"phase 1d FAILED: collecting the {name} tests exited {rc}:\n"
                             f"{out[-4000:]}")
        counts[name] = dict.fromkeys(suites[name][1], 0)
        for line in out.splitlines():
            path = line.split("::", 1)[0]
            if "::" in line and path in counts[name]:
                counts[name][path] += 1
    return counts


def card_suite_verdict(junit_xml: Path, selected_files: list[str], collected: dict[str, int],
                       returncode: int | None) -> dict[str, tuple[int, int]]:
    """Phase 1d's verdict on one child: ``{file: (cases collected, passed)}``.

    Fails the run (``SystemExit("phase 1d FAILED: ...")``) when the child
    exited non-zero or ran past its time limit (``returncode`` None), when
    its junit report holds a failure, an error or a skip (a ``cuda`` case
    that skips on the card fails here), a case of no selected file, a
    selected file that selects no case or passes none, or fewer passed
    cases in a file than ``--collect-only`` selected there (``collected``).
    """
    import xml.etree.ElementTree as ET

    def fail(why: str):
        raise SystemExit(f"phase 1d FAILED: {why}")

    if returncode is None:
        fail(f"{junit_xml.name}: the tests ran past their time limit")
    if returncode != 0:
        fail(f"{junit_xml.name}: pytest exited {returncode}")
    if not junit_xml.is_file():
        fail(f"{junit_xml.name}: no junit report")
    tree = ET.parse(junit_xml)
    module = {f.removesuffix(".py").replace("/", "."): f for f in selected_files}
    passed = dict.fromkeys(selected_files, 0)
    for case in tree.iter("testcase"):
        cls = case.get("classname", "")
        label = f"{cls}::{case.get('name')}"
        outcome = next((c.tag for c in case if c.tag in ("failure", "error", "skipped")), None)
        if outcome is not None:
            fail(f"{label}: {outcome}")
        owner = next((f for m, f in module.items() if cls == m or cls.startswith(m + ".")), None)
        if owner is None:
            fail(f"{label}: a case of no selected file")
        passed[owner] += 1
    for suite in tree.iter("testsuite"):
        counts = {k: int(suite.get(k, 0)) for k in ("failures", "errors", "skipped")}
        if any(counts.values()):
            fail(f"{junit_xml.name}: {counts}")
    for f in selected_files:
        if not collected.get(f):
            fail(f"{f} selects no case")
        if passed[f] == 0:
            fail(f"{f}: no case passed")
        if passed[f] < collected[f]:
            fail(f"{f}: {passed[f]} passed of {collected[f]} collected")
    return {f: (collected[f], passed[f]) for f in selected_files}


def card_only_tests(card: str) -> float:
    """Phase 1d: collect, then run, the card-only tests in two child
    processes started together, and hold each to :func:`card_suite_verdict`.
    The children load the kernel libraries that phase 1 built into
    ``build/kernels/``.  Returns the phase's wall seconds."""
    import shutil

    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"phase 1d: this process holds {torch.cuda.memory_reserved()} bytes of card memory "
        f"({torch.cuda.memory_allocated()} allocated)")
    work = ROOT / "build" / "chip_smoke_card_tests"
    shutil.rmtree(work, ignore_errors=True)
    collected = collect_card_suites(work / "collect")
    suites = card_suites()
    cmds = {name: [*PYTEST, "-q", f"--junitxml={work / f'{name}.xml'}", *args]
            for name, (args, _) in suites.items()}
    ran = run_together(cmds, card_tests_env(), CARD_TESTS_TIMEOUT, work)
    for name, (rc, secs) in ran.items():
        if rc != 0:
            log((work / f"{name}.log").read_text()[-6000:])
        verdict = card_suite_verdict(work / f"{name}.xml", suites[name][1], collected[name], rc)
        for f, (n_collected, n_passed) in verdict.items():
            log(f"phase 1d: {f}: {n_collected} collected, {n_passed} passed, 0 failed, "
                f"0 errors, 0 skipped")
        log(f"phase 1d: the {name} tests: {sum(p for _, p in verdict.values())} passed in "
            f"{secs:.3f} s")
    secs = time.perf_counter() - t0
    log(f"phase 1d: the card-only tests in {secs:.3f} s wall, torch {torch.__version__}, "
        f"card {card}")
    return secs


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
#: phase 8a: the reference's fleet at its own scale (``demo_fleet``, the
#: fleet example's trace rate and length, deadlines as the launcher draws them)
FLEET_DEMO = dict(n_shards=3, replicas=2)
FLEET_DEMO_TRACE = dict(n_requests=180, mean_interarrival=30_000, seed=SERVE_SEED,
                        tightness=8_000_000)
#: phase 8a's launcher runs, each on cuda and python (and the queue on torch)
FLEET_LAUNCHER_ARGS = {
    "fleet": ["--serve-tape-fleet", "--tape-requests", "90", "--fleet-outage-at", "1500000",
              "--fleet-outage-shard", "1", "--tape-drives", "2", "--tape-mount-cost", "150000"],
    "queue": ["--serve-tape-queue", "--tape-requests", "150", "--tape-drives", "2",
              "--tape-mount-cost", "150000"],
}
#: phase 8b: three shard libraries over twelve paper-tape cartridges, each
#: cartridge on two shards, and the trace served against them (PERF.md
#: section 4); the capture copies are capped so the phase fits host memory
FLEET_TAPES, FLEET_SHARDS, FLEET_REPLICAS = 12, 3, 2
FLEET_TRACE = dict(n_requests=60_000, mean_interarrival=600, seed=SERVE_SEED, skew=0.6)
FLEET_MAX_HOST_BYTES = 55 * 10**9
#: phase 8c: the same federation under a trace three windows long
FLEET_SPREAD_TRACE = dict(n_requests=50_000, mean_interarrival=2_400, seed=SERVE_SEED,
                          skew=0.6)
#: phase 8d: the examples, and the rows a device backend prints differently
#: from ``python`` by design (its budget prices dense table cells; its solver
#: fault degrades through ``torch`` where ``python`` has no tier to fall to)
EXAMPLES = ("quickstart", "online_serving", "qos_serving", "fault_serving", "fleet_serving",
            "observability")
EXAMPLE_DEVICE_ROWS = {"fault_serving": "fail-stop", "online_serving": "dp (fixed)"}
#: phase 9: the language model served at full width, and its restore
LM_ARCH = "qwen2.5-3b"
#: 9a: the float32 decode-vs-forward check (the reference's own bound,
#: tests/test_models.py) and the bf16 serving run
LM_CHECK = dict(batch=2, seq=16, rel_bound=2e-3)
LM_SERVE = dict(batch=8, prompt=128, new=64)
#: 9b: the tape_restore example's library, four bytes an element, two
#: consumers a shard and eight for the embedding
LM_ARCHIVE = dict(capacity_per_tape=4 * 10**9, u_turn=20_000_000)
#: 9b: the launcher's --restore-from-tape runs, each on cuda and python,
#: and the launcher's LM mode on the card: its default command (Qwen2.5-3B at
#: full width) and the other dense decoders reduced
LM_LAUNCHER_ARCHS = ("qwen2.5-3b", "granite-8b")
LM_LAUNCHER_SERVES = {"default": [], "yi-34b": ["--arch", "yi-34b", "--reduced"],
                      "deepseek-coder-33b": ["--arch", "deepseek-coder-33b", "--reduced"]}
#: phase 10a: the training launcher's loop at full width, steps 5-20 timed,
#: then two more steps under the profiler
TRAIN_FULL = ["--arch", "qwen2.5-3b", "--steps", "20", "--batch", "4", "--seq", "512",
              "--ckpt-every", "1000"]
TRAIN_TIMED_FROM = 5
#: phase 10b: the dense decoders, reduced, float32 on the card against the
#: CPU; gradients within TRAIN_GRAD_REL of each leaf's largest element, and
#: the reference's own bound between 4 microbatches and the whole batch
#: (tests/test_distributed.py)
TRAIN_ARCHS = ("deepseek-coder-33b", "granite-8b", "qwen2.5-3b", "yi-34b")
TRAIN_GRAD_REL = 1e-4
TRAIN_MICRO_BOUND = 2e-5
#: phase 10c: the launcher reduced, checkpointed every 10 steps, then resumed
TRAIN_RESUME = (["--reduced", "--steps", "30", "--ckpt-every", "10"],
                ["--reduced", "--steps", "40", "--ckpt-every", "10", "--resume"])

#: phase 11a: DeepSeek-V2 at full width, its depth cut to three layers (the
#: dense prologue layer and two MoE periods: 9,330,795,520 float32
#: parameters, 34.76 GiB; four periods would need 69 GB of parameters)
MOE_ARCH = "deepseek-v2-236b"
MOE_LAYERS = 3
MOE_PARAMS = 9_330_795_520
#: 11b: the whole checkpoints, planned from their shapes (``meta``), each on
#: a library of 20 TB cartridges (the paper's IN2P3 ones, as phase 7 scales
#: to; in bytes, with the paper's half-segment U-turn turned into bytes too):
#: the largest leaves are 297 GB and 1.35 TB, past LM_ARCHIVE's 4 GB
MOE_RESTORE_ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b")
MOE_TAPE_BYTES = 20 * 10**12
#: 11c: the MoE archs reduced, float32 on the card against the CPU port
#: (phase 10b's tolerances), then both launchers on the card
MOE_ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b")
MOE_TOL = 1e-4  # rtol = atol, as tests/test_torch_lm_device.py holds them
LAUNCHER_RUNS = {"serve": ["-m", "repro_torch.launch.serve", "--reduced"],
                     "train": ["-m", "repro_torch.launch.train", "--reduced", "--steps", "10"]}
#: phase 12a: Jamba at full width, its depth cut to one period (8 layers: 7
#: Mamba and 1 attention, MoE of 16 experts on the 4 odd positions):
#: 13,295,235,072 float32 parameters, 49.53 GiB; two periods would need 95 GiB
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_LAYERS = 8
JAMBA_PARAMS = 13_295_235_072
#: 12b: xLSTM-1.3B whole (48 layers, a 7:1 mLSTM to sLSTM period)
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_PARAMS = 1_062_607_184
#: 12a/12b: the float32 decode-vs-forward check over 512 tokens, two of
#: Jamba's 256-token Mamba chunks, so the scan carries its state across a
#: chunk boundary at the published widths (the reference's bound)
RECURRENT_CHECK = dict(batch=2, seq=512, rel_bound=2e-3)
#: 12b: xLSTM-1.3B's float32 forward at full width is not determined to the
#: reference's 2e-3 (one-ulp noise on its parameters moves its logits by up
#: to 6.7e-3 over 512 tokens; ``tools/recurrent_drift.py card``).  So its
#: decode is held against its forward in float64, a copy of the parameters
#: computed in float64 throughout, to the reference's bound; and the float32
#: decode's distance from that float64 forward must stay within
#: ``f32_factor`` times the float32 forward's own distance from it
XLSTM_CHECK = dict(RECURRENT_CHECK, witness="float64", f32_factor=4)
#: 12c: the whole checkpoints' restore, as 11b plans the MoE ones
RECURRENT_RESTORE_ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")
#: 12d: both archs reduced, cuda against the CPU port, then both launchers;
#: the reduced archs are 16 recurrent layers deep, where one-ulp noise on
#: the parameters alone moves a gradient by up to 4.5e-5 of its leaf's
#: largest element (tests/test_torch_lm_device.py holds them to 5e-4)
RECURRENT_ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")
RECURRENT_GRAD_REL = 5e-4
#: the training launcher's default sequence is 128 tokens, from which on
#: the parallel mLSTM gives NaN gradients in the reference and the port
#: alike (a masked exp(a[s] - amax[t]) that overflows; ROADMAP C), so xLSTM
#: trains at 64
LAUNCHER_EXTRA = {("xlstm-1.3b", "train"): ["--seq", "64"]}
#: phase 13a: Llama-3.2-Vision at full width, its depth cut to two periods
#: (10 layers: 8 attention and 2 ``xattn``, each with a SwiGLU FFN of width
#: 28672): 10,657,898,496 float32 parameters, 39.70 GiB; one period would
#: leave the stacking of the xattn caches over periods untested, the whole
#: model is 326.6 GiB.  Its memory is 1601 random vision embeddings a row
VLM_ARCH = "llama-3.2-vision-90b"
VLM_LAYERS = 10
VLM_PARAMS = 10_657_898_496
#: 13b: SeamlessM4T-large-v2 whole (a 24-layer encoder over 1500 random
#: frames, a 24-layer decoder with a cross-attention sub-block in each)
SEAMLESS_ARCH = "seamless-m4t-large-v2"
SEAMLESS_PARAMS = 2_034_784_256
#: 13c: both whole checkpoints' restore, as 11b plans the MoE ones; 13d: both
#: archs reduced, cuda against the CPU port (phase 10b's tolerances), then
#: both launchers
CROSS_ARCHS = (VLM_ARCH, SEAMLESS_ARCH)
#: 13e: Seamless trained at full width through the launcher's loop, steps
#: 3-10 timed, on random frames: on the reference launcher's zero frames its
#: 24 encoder layers overflow the first step's gradients to NaN (ROADMAP C)
TRAIN_SEAMLESS = ["--arch", SEAMLESS_ARCH, "--steps", "10", "--batch", "4", "--seq", "512",
                  "--ckpt-every", "1000", "--frontend-seed", "0"]
TRAIN_SEAMLESS_TIMED_FROM = 3

#: phase 14: the mesh path on the card's world of one rank (a NCCL group over
#: a FileStore under build/): Qwen2.5-3B trained at full width 5 steps at
#: 4 x 512 on the plain path and on the mesh path, the dry run's step
#: memory at world 1 against the card's allocator on one such step (14a),
#: served bf16 at batch 8 with the cache placed by cache_pspecs (14b), the
#: production meshes and the gradient compressors on 14a's last gradients
#: (14c), and the dry run's cells on the CPU (14d)
MESH_TRAIN = ["--arch", LM_ARCH, "--steps", "5", "--batch", "4", "--seq", "512",
              "--ckpt-every", "1000"]
MESH_SERVE = dict(batch=8, prompt=8, new=16)
MESH_COMPRESS_RATIO = 0.01
MESH_DRYRUN_SHAPES = ("train_4k", "prefill_32k")
MESH_DRYRUN_TIMEOUT = 600
#: 14d: the JAX package's per-device flops of the same cells (``python -m
#: repro.launch.dryrun --arch qwen2.5-3b``: XLA's cost analysis of the
#: compiled SPMD step on 512 CPU host devices, JAX 0.9.0, the elementwise
#: work included), and the most the port's count (products only) may exceed
#: them: a device that repeats another's attention heads, logits or weight
#: gradients counts up to 10 times as many
MESH_REFERENCE_FLOPS = {("train_4k", "pod16x16"): 1.141e14,
                        ("train_4k", "pod2x16x16"): 5.705e13,
                        ("prefill_32k", "pod16x16"): 6.590e13,
                        ("prefill_32k", "pod2x16x16"): 3.288e13}
MESH_FLOPS_REL = 1.05


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

    timeline = report_rows

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
    """Phase 7's and 8b's server options (besides policy, context and verify)."""
    from repro_torch.serving import DriveCosts

    return dict(IN2P3_SERVE, drive_costs=DriveCosts(**IN2P3_DRIVE_COSTS))


def paper_cartridges(paper: list, count: int) -> list[tuple[int, list[int]]]:
    """The first ``count`` paper tapes of :data:`IN2P3_NREQ` as cartridges:
    ``(paper tape, file sizes)``, the tape's requested files with their sizes
    scaled in proportion to fill the 20 TB cartridge exactly."""
    import numpy as np

    from repro_torch.data import PAPER_PROFILE

    cap = PAPER_PROFILE.tape_capacity
    lo, hi = IN2P3_NREQ
    out = []
    for i in [i for i, inst in enumerate(paper) if lo < inst.n_req <= hi][:count]:
        sizes = (paper[i].right - paper[i].left).astype(np.int64)
        sizes = sizes * cap // int(sizes.sum())
        sizes[-1] += cap - int(sizes.sum())
        out.append((i, [int(v) for v in sizes.tolist()]))
    return out


def in2p3_library(paper: list, u_turn: int, context):
    """Phase 7's library: one cartridge per paper tape of :data:`IN2P3_NREQ`
    (the first :data:`IN2P3_TAPES`, :func:`paper_cartridges`), so no cartridge
    shares files with another.  Returns ``(library, tapes)``."""
    from repro_torch.data import PAPER_PROFILE
    from repro_torch.storage.tape import TapeLibrary

    carts = paper_cartridges(paper, IN2P3_TAPES)
    lib = TapeLibrary(capacity_per_tape=PAPER_PROFILE.tape_capacity, u_turn=u_turn,
                      context=context)
    for k, (_, sizes) in enumerate(carts):
        for f, size in enumerate(sizes):
            lib.store(f"c{k}f{f:03d}", size)
    if len(lib.tapes) != len(carts):
        raise SystemExit("phase 7 FAILED: a cartridge holds files of two paper tapes")
    return lib, [i for i, _ in carts]


def in2p3_fleet(paper: list, u_turn: int):
    """Phase 8b's federation: :data:`FLEET_SHARDS` libraries over the first
    :data:`FLEET_TAPES` cartridges of :func:`paper_cartridges`, cartridge
    ``k`` stored whole on shards ``k % 3`` and ``(k + 1) % 3``, so every shard
    holds eight cartridges and no cartridge shares files with another.
    Returns ``(libraries, replica map, tapes)``."""
    from repro_torch.data import PAPER_PROFILE
    from repro_torch.fleet import ReplicaMap
    from repro_torch.storage.tape import TapeLibrary

    carts = paper_cartridges(paper, FLEET_TAPES)
    libs = [TapeLibrary(capacity_per_tape=PAPER_PROFILE.tape_capacity, u_turn=u_turn)
            for _ in range(FLEET_SHARDS)]
    for k, (_, sizes) in enumerate(carts):
        for shard in sorted({(k + j) % FLEET_SHARDS for j in range(FLEET_REPLICAS)}):
            for f, size in enumerate(sizes):
                libs[shard].store(f"c{k}f{f:03d}", size)
    per_shard = len(carts) * FLEET_REPLICAS // FLEET_SHARDS
    if any(len(lib.tapes) != per_shard for lib in libs):
        raise SystemExit("phase 8b FAILED: a shard does not hold whole cartridges")
    return libs, ReplicaMap.from_libraries(libs), [i for i, _ in carts]


def fleet_trace_and_outage(libs, rmap, trace_kw: dict):
    """Phase 8b's or 8c's trace (``trace_kw``, :data:`FLEET_TRACE` or
    :data:`FLEET_SPREAD_TRACE`) over the federation's catalogue, and the
    outage of shard 0 at the trace's median arrival time."""
    from repro_torch.fleet import fleet_catalog
    from repro_torch.serving import ShardOutage, poisson_trace

    trace = poisson_trace(fleet_catalog(libs, rmap), **trace_kw)
    at = sorted(r.time for r in trace)[len(trace) // 2]
    return trace, (ShardOutage(at=at, shard=0),)


class PeakRss:
    """The peak resident set of this process during a block, in GiB, sampled
    every 10 ms from ``/proc/self/statm``: the chip machine's kernel keeps no
    high-water mark that a phase could reset.  Where ``statm`` is missing the
    peak is the process's since it started (``ru_maxrss``), and ``since``
    says which."""

    def __enter__(self):
        import threading

        self.since = "this phase"
        try:
            self.start = self.peak = self._now()
        except OSError:
            self.since, self.start = "the process started", None
            return self
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _now() -> float:
        import os

        pages = int(Path("/proc/self/statm").read_text().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2**30

    def _sample(self) -> None:
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._now())

    def __exit__(self, *exc):
        import resource

        if self.since == "this phase":
            self._stop.set()
            self._thread.join()
            self.peak = max(self.peak, self._now())
        else:
            self.peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        return False


class SolveTimers:
    """Times every serving solve of one run, by part: the table build (CUDA
    events, then a synchronisation so the copies time only themselves), the
    copies of ``T``/``C`` to the host, the host traceback, the server's
    solves and its verify.  The wrappers call the originals unchanged and go
    on exit.  Each dispatch records the shard whose server solved it."""

    def __enter__(self):
        import collections

        from repro_torch.kernels.ltsp_dp import ops
        from repro_torch.serving import queue as squeue

        self.events, self.host, self.dispatch = [], collections.defaultdict(float), []
        self.by_shard = collections.defaultdict(lambda: collections.defaultdict(float))
        self._shard = 0
        self._originals = (ops.ltsp_dp_tables, ops._to_host, ops.traceback_detours,
                           squeue.solve_warm, squeue.verify_schedule,
                           squeue.OnlineTapeServer._solve_one)
        tables, to_host, walk, solve_warm, verify, solve_one = self._originals

        def timed_tables(*args, **kwargs):
            import torch

            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            start.record()
            out = tables(*args, **kwargs)
            stop.record()
            stop.synchronize()
            self.host["build"] += time.perf_counter() - t1
            self.by_shard[self._shard]["build"] += time.perf_counter() - t1
            self.events.append((start, stop))
            return out

        def timed(key, fn):
            def wrapper(*args, **kwargs):
                t1 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.host[key] += time.perf_counter() - t1
                self.by_shard[self._shard][key] += time.perf_counter() - t1
                return out
            return wrapper

        def timed_solve(inst, **kwargs):
            before = dict(self.host)
            t1 = time.perf_counter()
            out = solve_warm(inst, **kwargs)
            self.dispatch.append((self._shard, inst, time.perf_counter() - t1,
                                  {k: self.host[k] - before.get(k, 0.0) for k in self.host}))
            return out

        def shard_solve(server, *args, **kwargs):
            self._shard = server._obs_shard
            return solve_one(server, *args, **kwargs)

        ops.ltsp_dp_tables, ops._to_host = timed_tables, timed("copy", to_host)
        ops.traceback_detours, squeue.solve_warm = timed("traceback", walk), timed_solve
        squeue.verify_schedule = timed("verify", verify)
        squeue.OnlineTapeServer._solve_one = shard_solve
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.ltsp_dp import ops
        from repro_torch.serving import queue as squeue

        (ops.ltsp_dp_tables, ops._to_host, ops.traceback_detours, squeue.solve_warm,
         squeue.verify_schedule, squeue.OnlineTapeServer._solve_one) = self._originals
        return False

    def rows(self) -> list[dict]:
        """One row per dispatch: its shape, shard and the split of its solve."""
        from repro_torch.kernels.ltsp_dp import ops

        out = []
        for (shard, inst, secs, parts), (start, stop) in zip(self.dispatch, self.events):
            R_pad, S_pad = ops.bucket_shape(inst)
            out.append({"shard": shard, "R_pad": R_pad, "S_pad": S_pad, "n_req": inst.n_req,
                        "n": inst.n, "solve_ms": 1e3 * secs,
                        "build_ms": start.elapsed_time(stop),
                        "copy_ms": 1e3 * parts.get("copy", 0.0),
                        "traceback_ms": 1e3 * parts.get("traceback", 0.0),
                        "other_ms": 1e3 * (secs - parts.get("build", 0.0)
                                           - parts.get("copy", 0.0)
                                           - parts.get("traceback", 0.0))})
        return out


def check_served(phase: str, reports, timers: SolveTimers, launches: dict) -> None:
    """Every schedule's cost equals ``replay_schedule``'s, no batch fell back,
    every dispatch built its tables on the card."""
    batches = [b for r in reports for b in r.batches]
    for b in batches:
        if not b.verified or b.solver_cost != b.replay_cost:
            raise SystemExit(f"phase {phase} FAILED: {b.tape_id} schedule cost != replay_schedule")
    n_fallbacks = sum(b.degraded_to is not None for b in batches)
    if n_fallbacks or not launches["far_fold_kernel"] or not launches["near_fold_kernel"]:
        raise SystemExit(f"phase {phase} FAILED: fallbacks {n_fallbacks}, launches {launches}")
    if len(timers.dispatch) != len(batches) or len(timers.events) != len(batches):
        raise SystemExit(f"phase {phase} FAILED: a dispatch did not build its tables on the card")


def dispatch_summary(rows: list[dict]) -> tuple[str, int]:
    """The (R_pad, S_pad) histogram and n_req/n ranges of some dispatches, and
    how many of them lie inside the paper's Table 1 ranges."""
    import collections

    if not rows:
        return "no dispatch", 0
    hist = collections.Counter((r["R_pad"], r["S_pad"]) for r in rows)
    inside = sum(PAPER_NREQ[0] <= r["n_req"] <= PAPER_NREQ[1]
                 and PAPER_N[0] <= r["n"] <= PAPER_N[1] for r in rows)
    text = (f"{len(rows)} dispatches, (R_pad, S_pad) histogram {sorted(hist.items())}; n_req "
            f"{min(r['n_req'] for r in rows)}-{max(r['n_req'] for r in rows)}, n "
            f"{min(r['n'] for r in rows)}-{max(r['n'] for r in rows)}; {inside} of {len(rows)} "
            f"inside the paper's Table 1 ranges (n_req {PAPER_NREQ}, n {PAPER_N})")
    return text, inside


def log_split(phase: str, rows: list[dict], host: dict, n_served: int | None = None,
              wall: float | None = None) -> None:
    """Where the solves' time went (phase 7's split), and with ``wall`` the
    rest of the event loop."""
    solve_s = sum(r["solve_ms"] for r in rows) / 1e3
    other_s = solve_s - host["build"] - host["copy"] - host["traceback"]
    split = (f"table build {sum(r['build_ms'] for r in rows) / 1e3:.3f} s (CUDA events), "
             f"copies of T/C to the host {host['copy']:.3f} s, DenseStore copies and packing "
             f"{other_s:.3f} s, host traceback {host['traceback']:.3f} s, verify "
             f"{host['verify']:.3f} s")
    if wall is None:
        log(f"phase {phase}: {split}")
    else:
        log(f"phase {phase}: {n_served} requests served in {wall:.3f} s wall: {split}, rest "
            f"of the event loop {wall - solve_s - host['verify']:.3f} s")


def in2p3_serving(paper: list, u_turn: int, dev: str) -> dict:
    """Phase 7: serve an IN2P3-scale request trace on ``cuda``, timed
    (:class:`SolveTimers`).  The library is :func:`in2p3_library`'s."""
    from repro_torch.core import ExecutionContext
    from repro_torch.kernels.ltsp_dp import ltsp_dp, ops
    from repro_torch.serving import poisson_trace, serve_trace

    lib, tapes = in2p3_library(paper, u_turn, ExecutionContext(
        backend="cuda", numeric_policy="f64", device=dev))
    trace = poisson_trace(lib, **IN2P3_TRACE)
    log(f"phase 7: library of {len(tapes)} cartridges from paper tapes {tapes} "
        f"(n_req {[paper[i].n_req for i in tapes]}), U = {u_turn}; trace {IN2P3_TRACE}, "
        f"{IN2P3_SERVE}")
    host_before = ops.HOST_BYTES["copied"]
    with PeakRss() as rss, SolveTimers() as timers:
        ltsp_dp.reset_launches()
        t0 = time.perf_counter()
        report = serve_trace(lib, trace, "accumulate", policy="dp", context=lib.context,
                             verify=True, warm_start=False, **in2p3_serve())
        wall = time.perf_counter() - t0
        launches = dict(ltsp_dp.LAUNCHES)
    host_bytes = ops.HOST_BYTES["copied"] - host_before

    if report.n_served != len(trace):
        raise SystemExit(f"phase 7 FAILED: served {report.n_served} of {len(trace)}")
    if report.backend != "cuda":
        raise SystemExit(f"phase 7 FAILED: served on {report.backend}, not cuda")
    check_served("7", [report], timers, launches)
    rows = timers.rows()
    text, _ = dispatch_summary(rows)
    log(f"phase 7: {text}")
    for r in rows:
        log(f"  dispatch ({r['R_pad']}, {r['S_pad']}) n_req {r['n_req']} n {r['n']}: solve "
            f"{r['solve_ms']:.3f} ms = build {r['build_ms']:.3f} (CUDA events) + copy to host "
            f"{r['copy_ms']:.3f} + host traceback {r['traceback_ms']:.3f} + other "
            f"{r['other_ms']:.3f} (DenseStore copies, packing, guards)")
    r_pads = sorted(r["R_pad"] for r in rows)
    if r_pads[len(r_pads) // 2] < 128 or r_pads.count(256) < 3:
        raise SystemExit(f"phase 7 FAILED: dispatch sizes {r_pads} miss the targets")
    log_split("7", rows, timers.host, report.n_served, wall)
    log(f"phase 7: host bytes {host_bytes} ({host_bytes / 2**30:.3f} GiB), peak host RSS "
        f"{rss.peak:.3f} GiB (since {rss.since}; {rss.start or 0:.3f} GiB at its start), "
        f"fallbacks 0, launches {launches}")
    return launches


def report_rows(report, with_cells: bool = False) -> tuple:
    """A serving report as plain data without its backend: the summary, the
    served and failed rows and the batch records, the cell counters zeroed
    unless ``with_cells`` (they count dense device cells on the device
    backends and real DP cells on ``python``, in the JAX package too)."""
    import dataclasses

    cells = ("cells_evaluated", "cells_reused", "cells_per_batch")
    summary = {k: v for k, v in report.summary().items()
               if k != "backend" and (with_cells or k not in cells)}
    batches = [dataclasses.astuple(dataclasses.replace(
        b, degraded_to=None if b.degraded_to is None else "fallback",
        **({} if with_cells else {"cells_evaluated": 0, "cells_reused": 0})))
        for b in report.batches]
    return (list(summary.items()), [dataclasses.astuple(r) for r in report.served],
            [dataclasses.astuple(f) for f in report.failed], batches)


def fleet_rows(fr, with_cells: bool = False) -> tuple:
    """A :class:`FleetReport` as plain data: the merged and per-shard reports
    (:func:`report_rows`) and the federation's own facts."""
    return (report_rows(fr.merged, with_cells), [report_rows(r, with_cells) for r in fr.shards],
            fr.placement, fr.n_shards, fr.routes, fr.n_rerouted, fr.outages)


def launcher_table(out: str) -> list[str]:
    """The table a launcher run printed, each row's wall time dropped."""
    import re

    lines = out.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith(("admission,", "placement,")))
    rows = []
    for line in lines[start:]:
        if "," not in line:
            break
        rows.append(re.sub(r" \(\d+ ms wall(\)$|; )",
                           lambda m: "" if m.group(1) == ")" else " (", line))
    return rows


def fleet_exactness(dev: str) -> dict:
    """Phase 8a: the reference's fleet at its own scale on ``cuda`` and on
    ``python``, under three placements with a mid-trace shard outage;
    ``recover_fleet`` from torn journals; the launcher's two tape modes.
    Returns the kernel launches of the ``cuda`` fleet runs."""
    import json
    import os
    import shutil

    from repro_torch.core import ExecutionContext, FleetOptions, SolveCache
    from repro_torch.data.traces import qos_poisson_trace, to_requests
    from repro_torch.fleet import (
        demo_fleet, fleet_catalog, merge_journals, recover_fleet, serve_fleet_trace,
        shard_journal_path,
    )
    from repro_torch.kernels.ltsp_dp import ltsp_dp
    from repro_torch.serving import DriveCosts, RetryPolicy, ShardOutage

    # the launcher runs start first: they are separate processes and overlap
    # with the in-process runs below
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {}
    for mode, args in FLEET_LAUNCHER_ARGS.items():
        for backend in ("cuda", "python", "torch"):
            if mode == "fleet" and backend == "torch":
                continue
            procs[mode, backend] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.serve", *args, "--tape-backend",
                 backend, "--tape-device", dev],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    try:
        jdir = ROOT / "build" / "chip_smoke_fleet"
        shutil.rmtree(jdir, ignore_errors=True)
        jdir.mkdir(parents=True)
        libs, rmap = demo_fleet(SERVE_SEED, **FLEET_DEMO)
        trace, qos = to_requests(qos_poisson_trace(fleet_catalog(libs, rmap), **FLEET_DEMO_TRACE))
        outages = (ShardOutage(at=sorted(r.time for r in trace)[len(trace) // 2], shard=1),)
        costs = DriveCosts(mount=150_000, unmount=60_000, load_seek=30_000)

        def serve(placement, backend, journal, recover=False):
            libs, rmap = demo_fleet(SERVE_SEED, **FLEET_DEMO)
            ctx = ExecutionContext(backend=backend, device=dev, numeric_policy="f64",
                                   cache=SolveCache(), fleet=FleetOptions(
                                       placement=placement, **FLEET_DEMO))
            kw = dict(replica_map=rmap, outages=outages, qos=qos, window=400_000, policy="dp",
                      n_drives=2, drive_costs=costs, retry=RetryPolicy(on_exhausted="drop"),
                      context=ctx)
            if recover:
                return recover_fleet(libs, trace, str(journal), "accumulate", **kw)
            return serve_fleet_trace(libs, trace, "accumulate", journal=str(journal), **kw)

        def journal_bytes(base):
            return [Path(shard_journal_path(base, i)).read_bytes()
                    for i in range(FLEET_DEMO["n_shards"])]

        launches = dict.fromkeys(ltsp_dp.LAUNCHES, 0)
        for placement in ("static-hash", "least-loaded", "replica-affinity"):
            bases = {b: jdir / f"{placement}-{b}.journal" for b in ("cuda", "python", "torch")}
            t0 = time.perf_counter()
            ltsp_dp.reset_launches()
            cuda = serve(placement, "cuda", bases["cuda"])
            for k, v in ltsp_dp.LAUNCHES.items():
                launches[k] += v
            t_cuda = time.perf_counter() - t0
            py = serve(placement, "python", bases["python"])
            plain = serve(placement, "torch", bases["torch"])
            if (fleet_rows(cuda) != fleet_rows(py)
                    or cuda.summary()["fleet"] != py.summary()["fleet"]):
                raise SystemExit(f"phase 8a FAILED: {placement}: cuda report != python")
            if fleet_rows(cuda, with_cells=True) != fleet_rows(plain, with_cells=True):
                raise SystemExit(f"phase 8a FAILED: {placement}: cuda cell counters != torch")
            if journal_bytes(bases["cuda"]) != journal_bytes(bases["python"]):
                raise SystemExit(f"phase 8a FAILED: {placement}: cuda shard journals != python")
            merged = json.dumps(merge_journals(bases["cuda"], FLEET_DEMO["n_shards"]))
            if merged != json.dumps(merge_journals(bases["python"], FLEET_DEMO["n_shards"])):
                raise SystemExit(f"phase 8a FAILED: {placement}: merge_journals differs")
            if any(b.degraded_to is not None for r in cuda.shards for b in r.batches):
                raise SystemExit(f"phase 8a FAILED: {placement}: a cuda batch fell back")
            # torn journals: every shard cut at half its bytes, recovered on cuda
            whole = journal_bytes(bases["cuda"])
            for i, data in enumerate(whole):
                Path(shard_journal_path(bases["cuda"], i)).write_bytes(data[: len(data) // 2])
            rec = serve(placement, "cuda", bases["cuda"], recover=True)
            if (journal_bytes(bases["cuda"]) != whole
                    or fleet_rows(rec, True) != fleet_rows(cuda, True)):
                raise SystemExit(f"phase 8a FAILED: {placement}: recover_fleet is not "
                                 f"byte-identical")
            log(f"phase 8a: {placement}: {cuda.n_served} served, {cuda.n_failed} failed, "
                f"{cuda.n_rerouted} re-routed after shard 1's outage at {outages[0].at}, routes "
                f"{cuda.routes}; cuda == python (summary, per-shard timelines, {len(merged)} bytes "
                f"of merge_journals, shard journals {[len(b) for b in whole]} bytes), cells == "
                f"torch on the card; recover_fleet from journals cut at half is byte-identical; "
                f"cuda run {t_cuda:.3f} s")
        if not launches["near_fold_kernel"] or not launches["far_fold_kernel"]:
            raise SystemExit(f"phase 8a FAILED: the cuda fleet runs launched {launches}")

        tables = {}
        for (mode, backend), proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise SystemExit(f"phase 8a FAILED: launcher --serve-tape-{mode} on {backend} "
                                 f"exited {proc.returncode}:\n{err[-3000:]}")
            tables[mode, backend] = launcher_table(out)

        def no_cells(rows):  # the queue table's cells and reused columns
            return [",".join(row.split(",")[:9] + row.split(",")[11:]) for row in rows]

        if tables["fleet", "cuda"] != tables["fleet", "python"]:
            raise SystemExit("phase 8a FAILED: launcher --serve-tape-fleet: cuda table != python")
        if (no_cells(tables["queue", "cuda"]) != no_cells(tables["queue", "python"])
                or tables["queue", "cuda"] != tables["queue", "torch"]):
            raise SystemExit("phase 8a FAILED: launcher --serve-tape-queue: cuda table != python "
                             "(cells aside) or != torch on the card")
        for mode in FLEET_LAUNCHER_ARGS:
            log(f"phase 8a: launcher --serve-tape-{mode} ({len(tables[mode, 'cuda']) - 1} rows): "
                f"cuda == python" + (" (cells aside), == torch on the card" if mode == "queue"
                                     else ""))
            for row in tables[mode, "cuda"]:
                log(f"  {row}")
        log(f"phase 8a: cuda fleet launches {launches}")
        shutil.rmtree(jdir, ignore_errors=True)
    finally:  # no launcher process outlives the phase, whatever failed
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return launches


def in2p3_fleet_serving(paper: list, u_turn: int, dev: str, spread: bool) -> dict:
    """Phase 8b (``spread=False``) or 8c: serve an IN2P3-scale federation on
    ``cuda`` through an outage of shard 0, timed like phase 7
    (:class:`SolveTimers`), per shard and in all.  8b's burst arrives within
    one window: every dispatch drains a whole replica's queue after the
    trace, all inside Table 1's ranges.  8c's trace spans three windows:
    every shard dispatches before the outage, shard 0 has batches in flight
    when it strikes, and the survivors serve on while arrivals continue; its
    dispatch sizes are printed against Table 1, not held to it (a window's
    first and last dispatches are smaller).  Returns the kernel launches."""
    from repro_torch.core import ExecutionContext, FleetOptions
    from repro_torch.fleet import serve_fleet_trace
    from repro_torch.kernels.ltsp_dp import ltsp_dp, ops
    from repro_torch.serving import RetryPolicy

    phase, trace_kw = ("8c", FLEET_SPREAD_TRACE) if spread else ("8b", FLEET_TRACE)
    libs, rmap, tapes = in2p3_fleet(paper, u_turn)
    trace, outages = fleet_trace_and_outage(libs, rmap, trace_kw)
    at = outages[0].at
    ctx = ExecutionContext(backend="cuda", numeric_policy="f64", device=dev, fleet=FleetOptions(
        n_shards=FLEET_SHARDS, placement="replica-affinity", replicas=FLEET_REPLICAS))
    log(f"phase {phase}: {FLEET_SHARDS} shards x 8 of {len(tapes)} cartridges from paper tapes "
        f"{tapes} (n_req {[paper[i].n_req for i in tapes]}), each on shards k % 3 and "
        f"(k + 1) % 3; U = {u_turn}; trace {trace_kw}, arrivals {trace[0].time}-"
        f"{trace[-1].time}; {IN2P3_SERVE} per shard, replica-affinity, shard 0 dark at {at}")
    host_before = ops.HOST_BYTES["copied"]
    with PeakRss() as rss, SolveTimers() as timers:
        ltsp_dp.reset_launches()
        t0 = time.perf_counter()
        fr = serve_fleet_trace(libs, trace, "accumulate", replica_map=rmap, outages=outages,
                               policy="dp", context=ctx, verify=True, warm_start=False,
                               retry=RetryPolicy(on_exhausted="drop"), **in2p3_serve())
        wall = time.perf_counter() - t0
        launches = dict(ltsp_dp.LAUNCHES)
    host_bytes = ops.HOST_BYTES["copied"] - host_before

    if fr.n_served != len(trace) or fr.n_failed:
        raise SystemExit(f"phase {phase} FAILED: served {fr.n_served}, failed {fr.n_failed} of "
                         f"{len(trace)}")
    if fr.n_rerouted == 0 or fr.merged.backend != "cuda":
        raise SystemExit(f"phase {phase} FAILED: {fr.n_rerouted} re-routed, on "
                         f"{fr.merged.backend}")
    check_served(phase, fr.shards, timers, launches)
    rows = timers.rows()
    # each shard's solves run in its batches' order
    batches = {i: iter(r.batches) for i, r in enumerate(fr.shards)}
    matched = [(r, next(batches[r["shard"]])) for r in rows]
    if any((r["n_req"], r["n"]) != (b.n_files, b.n_requests) for r, b in matched):
        raise SystemExit(f"phase {phase} FAILED: a timed solve is not its shard's batch")
    in_flight = sum(b.aborted_by == "drive-failure" for b in fr.shards[0].batches)
    for shard in range(FLEET_SHARDS):
        mine = [r for r in rows if r["shard"] == shard]
        before = sum(b.dispatched < at for b in fr.shards[shard].batches)
        text, _ = dispatch_summary(mine)
        log(f"phase {phase}: shard {shard}: {fr.shards[shard].n_served} served, "
            f"{fr.routes[shard]} routed here, {before} dispatches before the outage and "
            f"{len(mine) - before} after; {text}")
        log_split(f"{phase} shard {shard}", mine, timers.by_shard[shard])
        if spread and (before == 0 or (shard != 0 and before == len(mine))):
            raise SystemExit(f"phase 8c FAILED: shard {shard} dispatched {before} of "
                             f"{len(mine)} before the outage")
    text, inside = dispatch_summary(rows)
    log(f"phase {phase}: in all {text}")
    for r, b in matched:
        log(f"  shard {r['shard']} dispatch at {b.dispatched} ({r['R_pad']}, {r['S_pad']}) n_req "
            f"{r['n_req']} n {r['n']}: solve {r['solve_ms']:.3f} ms = build "
            f"{r['build_ms']:.3f} + copy {r['copy_ms']:.3f} + traceback "
            f"{r['traceback_ms']:.3f} + other {r['other_ms']:.3f}")
    log_split(phase, rows, timers.host, fr.n_served, wall)
    log(f"phase {phase}: {fr.n_rerouted} requests re-routed by the outage, {in_flight} of shard "
        f"0's batches in flight when it struck; host bytes {host_bytes} "
        f"({host_bytes / 2**30:.3f} GiB), peak host RSS {rss.peak:.3f} GiB (since "
        f"{rss.since}; {rss.start or 0:.3f} GiB at its start), fallbacks 0, every schedule == "
        f"replay_schedule, launches {launches}")
    largest = max((r["R_pad"], r["S_pad"]) for r in rows)
    if largest[0] > MAIN_R_MAX or max(r["S_pad"] for r in rows) > 16384:
        raise SystemExit(f"phase {phase} FAILED: largest dispatch {largest}")
    if not spread and inside != len(rows):
        raise SystemExit(f"phase 8b FAILED: {len(rows) - inside} dispatches outside Table 1")
    if spread and not in_flight:
        raise SystemExit("phase 8c FAILED: the outage found no batch in flight on shard 0")
    if host_bytes > FLEET_MAX_HOST_BYTES:
        raise SystemExit(f"phase {phase} FAILED: {host_bytes} bytes to the host, over "
                         f"{FLEET_MAX_HOST_BYTES}")
    return launches


def example_numbers(out: str, drop_rows: str | None) -> list[str]:
    """The numbers an example printed, without the rows ``drop_rows`` starts."""
    import re

    lines = [line for line in out.splitlines()
             if drop_rows is None or not line.startswith(drop_rows)]
    return re.findall(r"-?\d+(?:[.,]\d+)*(?:e[+-]?\d+)?", "\n".join(lines))


def examples_on_the_card() -> None:
    """Phase 8d: every example of ``examples/torch/`` with its default
    arguments (the CUDA kernels on the card) and with ``--backend python``,
    all as processes at once, each in a directory of its own; the numbers
    they print must be equal, but for :data:`EXAMPLE_DEVICE_ROWS`."""
    import os
    import shutil

    env = dict(os.environ, PYTHONPATH=str(SRC))
    work = ROOT / "build" / "chip_smoke_examples"
    shutil.rmtree(work, ignore_errors=True)
    procs = {}
    try:
        for name in EXAMPLES:
            for backend, args in (("cuda", []), ("python", ["--backend", "python"])):
                cwd = work / f"{name}-{backend}"
                cwd.mkdir(parents=True)
                procs[name, backend] = subprocess.Popen(
                    [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"), *args],
                    cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
        printed = {}
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise SystemExit(f"phase 8d FAILED: example {key[0]} on {key[1]} exited "
                                 f"{proc.returncode}:\n{err[-3000:]}")
            printed[key] = out
        for name in EXAMPLES:
            drop = EXAMPLE_DEVICE_ROWS.get(name)
            cuda = example_numbers(printed[name, "cuda"], drop)
            if cuda != example_numbers(printed[name, "python"], drop) or len(cuda) <= 5:
                raise SystemExit(f"phase 8d FAILED: example {name}: cuda numbers != python")
            log(f"phase 8d: example {name}: {len(cuda)} numbers, cuda (default) == python"
                + (f" but for the rows starting {drop!r}" if drop else ""))
            for line in printed[name, "cuda"].splitlines():
                if drop and line.startswith(drop):
                    log(f"  cuda: {line}")
        shutil.rmtree(work, ignore_errors=True)
    finally:  # no example process outlives the phase, whatever failed
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def lm_serving(dev: str):
    """Phase 9a: Qwen2.5-3B at full width on the card (see
    :func:`serve_full_width`).  Returns the parameters, for 9b."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[LM_ARCH]
    return serve_full_width("9a", cfg, dev, check_overrides={})


#: operators whose own kernel time makes each part of a decode step's split
OP_GROUPS = {
    "casts (float32 -> bf16 weights)": ("aten::copy_",),
    "products": ("aten::mm", "aten::bmm", "aten::addmm"),
    "attention (softmax, mask)": ("aten::_softmax", "aten::masked_fill_"),
    "index, sort and scatter work (the MoE dispatch, the embedding lookup)": (
        "aten::sort", "aten::argsort", "aten::cumsum", "aten::index", "aten::index_put_",
        "aten::_index_put_impl_", "aten::index_add_", "aten::index_add", "aten::scatter_add_",
        "aten::where", "aten::clamp", "aten::repeat_interleave", "aten::lt", "aten::sub",
        "aten::gather"),
    "elementwise (the Mamba conv and state step, the xLSTM gates; also the norms)": (
        "aten::mul", "aten::add", "aten::mul_", "aten::add_", "aten::addcmul_", "aten::exp",
        "aten::logaddexp", "aten::silu", "aten::cat", "aten::sigmoid", "aten::tanh",
        "aten::maximum", "aten::div", "aten::neg", "aten::abs", "aten::clamp_min"),
}


def frontend_embeds(cfg, batch: int, device: str, seed: int) -> dict:
    """The frontend's embeddings a cross-attention arch takes, drawn from a
    generator seeded ``seed`` on ``device``: ``{"enc_embeds": [B, frames,
    D]}`` for an enc-dec model, ``{"vision_embeds": [B, tokens, D]}`` for a
    VLM, ``{}`` for the others (float32)."""
    import torch

    M = cfg.num_enc_frames if cfg.enc_layers else cfg.num_vision_tokens
    if not M:
        return {}
    embeds = torch.randn((batch, M, cfg.d_model), device=device,
                         generator=torch.Generator(device).manual_seed(seed))
    return {"enc_embeds" if cfg.enc_layers else "vision_embeds": embeds}


def cross_memory(model, cfg, embeds: dict):
    """The memory the decoder attends to: the encoder's output over
    ``enc_embeds``, the ``vision_embeds`` themselves, or ``None``."""
    from repro_torch.models.model import encode

    if "enc_embeds" in embeds:
        return encode(model, cfg, embeds["enc_embeds"])
    return embeds.get("vision_embeds")


def warmed_cache(model, cfg, batch: int, max_len: int, memory, device: str) -> dict:
    """A decode cache, its cross caches filled from ``memory`` (if any)."""
    from repro_torch.models.model import init_cache, warm_cross_cache

    cache = init_cache(cfg, batch, max_len, device=device)
    return cache if memory is None else warm_cross_cache(model, cfg, cache, memory)


def step_bytes(cfg, params, cache, batch: int) -> dict:
    """The bytes a decode step must move at the least: the parameters it
    reads, once (the decoder stack and the head, not the encoder; of an
    untied embedding only the ``batch`` rows it gathers), the cross K/V
    caches read once (decode never writes them: the ``"cross"`` leaves and
    the ``xattn`` layers' ``"mix"``), and the recurrent state read and
    written once (every other cache leaf but the self-attention caches)."""
    from repro_torch.distributed.checkpoint import named_leaves

    out = {"params": 0, "cross": 0, "state": 0}
    for name, t in named_leaves(params):
        top = name.split("::")[0]
        if top == "embed" and not cfg.tie_embeddings:
            out["params"] += batch * cfg.d_model * t.element_size()
        elif top not in ("encoder", "enc_norm"):
            out["params"] += t.numel() * t.element_size()
    for name, t in named_leaves(cache):
        parts, nbytes = name.split("::"), t.numel() * t.element_size()
        if "cross" in parts or (parts[0] == "periods"
                                and cfg.block_pattern[int(parts[1][1:])] == "xattn"):
            out["cross"] += nbytes
        elif parts[-1] not in ("k", "v", "ckv", "kr"):
            out["state"] += 2 * nbytes
    return out


def serve_full_width(phase: str, cfg, dev: str, check_overrides: dict, cut: str = "",
                     check: dict = LM_CHECK):
    """A language model at full width on the card: parameters from a seed,
    float32 decode at every position must reproduce the full-sequence
    forward within ``check``'s bound (``check_overrides`` on top of float32
    compute, at ``check``'s batch and length).  With a ``float64`` witness
    the bound holds the float64 decode against the float64 forward, and the
    float32 decode must stay within ``f32_factor`` times the float32
    forward's distance from the float64 forward.  Then the config's own bf16
    compute serves a batch through ``make_serve_step``, timed, with every
    logit finite, and four steps run under the profiler.  A cross-attention
    arch's memory comes from random frontend embeddings (through the encoder
    of an enc-dec model): both checks decode against cross caches that
    ``warm_cross_cache`` filled from it, the forward reads it, and the bf16
    run times its prefill (``encode``, ``warm_cross_cache``) on its own.  A
    step's bound is :func:`step_bytes` over the card's memory rate.
    Returns the parameters."""
    import copy
    import dataclasses

    import torch

    from repro_torch.distributed.checkpoint import named_leaves
    from repro_torch.models.model import (
        decode_step, forward, init_cache, init_model, warm_cross_cache,
    )
    from repro_torch.serving.serve import make_serve_step

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise SystemExit(f"phase {phase} FAILED: float32 products would run in TF32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    moe = (f", {cfg.num_experts} experts top {cfg.top_k} + {cfg.num_shared_experts} shared of "
           f"width {cfg.moe_d_ff}, {cfg.first_k_dense} dense layer of width {cfg.dense_d_ff}"
           if cfg.num_experts else "")
    mla = (f", MLA (q rank {cfg.q_lora_rank}, kv rank {cfg.kv_lora_rank})" if cfg.use_mla
           else "")
    if cfg.is_subquadratic:
        mla += f", period {'/'.join(cfg.block_pattern)}"
    if "mamba" in cfg.block_pattern:
        mla += (f" (Mamba d_state {cfg.mamba_d_state}, d_conv {cfg.mamba_d_conv}, expand "
                f"{cfg.mamba_expand}, chunk {cfg.mamba_chunk})")
    if cfg.num_vision_tokens:
        mla += f", period {'/'.join(cfg.block_pattern)} over {cfg.num_vision_tokens} vision tokens"
    if cfg.enc_layers:
        n_enc = sum(t.numel() for name, t in named_leaves(params)
                    if name.split("::")[0] in ("encoder", "enc_norm"))
        mla += (f", a {cfg.enc_layers}-layer encoder over {cfg.num_enc_frames} frames ({n_enc} "
                f"parameters), a cross-attention sub-block in every decoder layer")
    log(f"phase {phase}: {cfg.arch_id} at full width{cut} ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads{mla}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}{moe}): {n_params} parameters, {n_params * 4 / 2**30:.3f} GiB in "
        f"float32, initialised in {time.perf_counter() - t0:.3f} s (peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB)")

    # decode at every position against the full-sequence forward, in float32
    # (and in float64 where the check has a float64 witness)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", **check_overrides)
    B, L = check["batch"], check["seq"]
    tokens = torch.randint(0, cfg.vocab_size, (B, L), device=dev,
                           generator=torch.Generator(dev).manual_seed(2))
    t0 = time.perf_counter()

    def decode_and_forward(model, c):
        memory = cross_memory(model, c, frontend_embeds(c, B, dev, seed=3))
        cache = warmed_cache(model, c, B, L, memory, dev)
        dec = torch.stack([decode_step(model, c, tokens[:, t : t + 1], cache, t)[0][:, 0]
                           for t in range(L)], dim=1)
        return dec, forward(model, c, tokens, memory=memory)[0]

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    dec, full = decode_and_forward(params, cfg32)
    finite, what, f32 = bool(torch.isfinite(full).all()), "float32", ""
    if check.get("witness") == "float64":
        cfg64 = dataclasses.replace(cfg32, compute_dtype="float64", param_dtype="float64")
        dec64, full64 = decode_and_forward(copy.deepcopy(params).double(), cfg64)
        what, err = "float64", rel(dec64, full64)
        e_fwd, e_dec = rel(full, full64), rel(dec, full64)
        finite &= bool(torch.isfinite(full64).all())
        f32 = (f"; float32 decode {rel(dec, full):.3e} from the float32 forward, the "
               f"float32 forward {e_fwd:.3e} and decode {e_dec:.3e} from the float64 "
               f"forward, decode within {e_dec / max(e_fwd, 1e-30):.2f} <= "
               f"{check['f32_factor']} x the forward's")
        if not e_dec <= check["f32_factor"] * e_fwd:
            raise SystemExit(f"phase {phase} FAILED: the float32 decode is {e_dec} from the "
                             f"float64 forward, the float32 forward {e_fwd}")
        del dec64, full64
    else:
        err = rel(dec, full)
    if not (err < check["rel_bound"] and finite):
        raise SystemExit(f"phase {phase} FAILED: {what} decode != forward, rel {err} (bound "
                         f"{check['rel_bound']})")
    memory = (f", decode against the warmed cross caches, forward over the memory of "
              f"{cfg.num_enc_frames or cfg.num_vision_tokens} rows" if cfg.enc_layers or
              cfg.num_vision_tokens else "")
    log(f"phase {phase}: {what} decode at all {L} positions == forward (B={B}{memory}"
        f"{''.join(f', {k} {v}' for k, v in check_overrides.items())}): rel "
        f"max|dec - full| / max|full| = {err:.3e} < {check['rel_bound']}{f32} "
        f"({time.perf_counter() - t0:.3f} s)")
    del full, dec
    torch.cuda.empty_cache()

    # bf16 (the config's compute dtype): a batch served through make_serve_step
    Bs, P, N = LM_SERVE["batch"], LM_SERVE["prompt"], LM_SERVE["new"]
    serve = make_serve_step(cfg)
    cache = init_cache(cfg, Bs, P + N, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (Bs, P), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    finite = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    embeds = frontend_embeds(cfg, Bs, dev, seed=4)
    if embeds:  # the memory prefill, each part timed on its own (its second call)
        times = {}
        for _ in range(2):
            t0 = time.perf_counter()
            memory = cross_memory(params, cfg, embeds)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            warm_cross_cache(params, cfg, cache, memory)
            torch.cuda.synchronize()
            times.setdefault("first", (t1 - t0, time.perf_counter() - t1))
            times["second"] = (t1 - t0, time.perf_counter() - t1)
        M = next(iter(embeds.values())).shape[1]
        what = "encode" if cfg.enc_layers else "the vision embeddings (drawn, no encoder)"
        log(f"phase {phase}: memory prefill at batch {Bs} x {M} rows: {what} "
            f"{1e3 * times['second'][0]:.3f} ms, warm_cross_cache "
            f"{1e3 * times['second'][1]:.3f} ms (first calls {1e3 * times['first'][0]:.3f} and "
            f"{1e3 * times['first'][1]:.3f} ms); memory finite: "
            f"{bool(torch.isfinite(memory).all())}")
        if not bool(torch.isfinite(memory).all()):
            raise SystemExit(f"phase {phase} FAILED: the memory is not finite")
        del memory, embeds
    t0 = time.perf_counter()
    for t in range(P - 1):  # teacher-forced prefill, as the launcher does
        _, logits, cache = serve(params, cache, prompts[:, t : t + 1], t)
        finite &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    tok, outs = prompts[:, -1:], []
    t0 = time.perf_counter()
    for t in range(N):
        tok, logits, cache = serve(params, cache, tok, P - 1 + t)
        finite &= torch.isfinite(logits).all()
        outs.append(tok)
    out = torch.cat(outs, 1).cpu()
    t_decode = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    in_range = 0 <= out.min() and out.max() < cfg.vocab_size
    if not bool(finite) or out.shape != (Bs, N) or not in_range:
        raise SystemExit(f"phase {phase} FAILED: a bf16 logit is not finite or a token is out "
                         f"of range")
    step_ms = 1e3 * t_decode / N
    moved = step_bytes(cfg, params, cache, Bs)
    bound = sum(moved.values()) / HBM_BYTES_PER_S * 1e3
    parts = [f"{moved['params'] / 1e9:.3f} GB of float32 parameters read once"
             + ("" if cfg.tie_embeddings else f" (the embedding's {Bs} rows)")
             + (", not the encoder's" if cfg.enc_layers else "")]
    if moved["cross"]:
        parts.append(f"{moved['cross'] / 1e9:.3f} GB of cross K/V caches read once")
    if moved["state"]:
        parts.append(f"{moved['state'] / 1e9:.3f} GB of recurrent state read and written")
    log(f"phase {phase}: bf16 serving, batch {Bs}: prefill {P - 1} steps in {t_prefill:.3f} s "
        f"({1e3 * t_prefill / (P - 1):.3f} ms a step); decode {N} steps in {t_decode:.3f} s: "
        f"{step_ms:.3f} ms a step, {Bs * N / t_decode:.1f} tok/s; bound of a step "
        f"({'; '.join(parts)}) {bound:.3f} ms, the step at {step_ms / bound:.2f}x it; peak "
        f"device memory {peak / 2**30:.3f} GiB; all logits finite; first sequence "
        f"{out[0, :12].tolist()}")

    # where a decode step's time goes: four steps under the profiler, its
    # kernel events (device time) apart from its operator events (host)
    try:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                tok, _, cache = serve(params, cache, tok, P + N - 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        split = profile_split(prof, 4)
        total = split["kernel_ms"]
        log(f"phase {phase}: profiler, 4 decode steps: {1e3 * wall / 4:.3f} ms wall and "
            f"{total:.3f} ms of kernel time a step ({100 * total / 250 / wall:.1f}% "
            f"busy), {split['kernels']:.0f} kernels and {split['ops']:.0f} aten "
            f"operators a step")
        grouped = {name: sum(row[0] for row in split["by_op"] if row[1] in ops) / 4e3
                   for name, ops in OP_GROUPS.items()}
        grouped["other"] = total - sum(grouped.values())
        log(f"phase {phase}: kernel time a step by part: " + "; ".join(
            f"{name} {ms:.3f} ms ({100 * ms / max(total, 1e-9):.1f}%)"
            for name, ms in grouped.items()))
        for dev_us, key, count in split["by_kernel"][:8]:
            log(f"  {100 * dev_us / 4e3 / max(total, 1e-9):5.1f}% {dev_us / 4e3:8.3f} ms/step "
                f"x{count // 4}: {key[:100]}")
    except RuntimeError as e:  # the profiler is not needed for any check
        log(f"phase {phase}: profiler not measured ({e})")
    del cache
    return params


def lm_restore(params, dev: str) -> dict:
    """Phase 9b: the full-width checkpoint archived to tape and its restore
    planned under ``dp`` and ``simpledp`` on the card, in float64 tables,
    held equal to ``python``.  Returns the launches of the plans."""
    import dataclasses

    import torch

    from repro_torch.core import ExecutionContext
    from repro_torch.distributed.checkpoint import archive_to_tape, plan_restore
    from repro_torch.kernels.ltsp_dp import ltsp_dp
    from repro_torch.storage.tape import TapeLibrary

    lib = TapeLibrary(**LM_ARCHIVE)
    shards = archive_to_tape(lib, LM_ARCH, params, bytes_per_elem=4)
    consumers = {s: 8 if "embed" in s else 2 for s in shards}
    cuda = ExecutionContext(backend="cuda", device=dev, numeric_policy="f64")
    ltsp_dp.reset_launches()
    plans, walls = {}, {}
    for policy in ("dp", "simpledp"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plans[policy] = plan_restore(lib, shards, consumers, policy=policy, context=cuda)
        torch.cuda.synchronize()
        walls[policy] = time.perf_counter() - t0
    launches = dict(ltsp_dp.LAUNCHES)

    def plain(read_plans):
        return [dataclasses.replace(p, backend="") for p in read_plans]

    for policy, got in plans.items():
        want = plan_restore(lib, shards, consumers, policy=policy,
                            context=ExecutionContext(backend="python"))
        if plain(got) != plain(want) or any(p.backend != "cuda" for p in got):
            raise SystemExit(f"phase 9b FAILED: {policy} restore plans on cuda != python")
    if launches["far_fold_kernel"] + launches["near_fold_kernel"] == 0 or \
            launches["traceback_kernel"] == 0:
        raise SystemExit(f"phase 9b FAILED: the restore plans launched {launches}")
    n_req = sum(consumers.values())
    for policy, got in plans.items():
        mean = sum(p.total_cost for p in got) / n_req
        log(f"phase 9b: {policy}: {len(shards)} shards on {len(lib.tapes)} cartridges "
            f"({[len(p.order) for p in got]} shards each), mean arrival {mean:.6g}, planned on "
            f"cuda in {1e3 * walls[policy]:.3f} ms wall, == python")
    log(f"phase 9b: launches of the restore plans {launches}")
    return launches


def restore_line(out: str) -> tuple[str, str]:
    """The launcher's restore line: (backend, the line without its two times)."""
    import re

    m = re.search(r"^tape restore \[(\w+)/(\w+)\]: (.*) \(planned in \d+ ms; re-plan \d+ ms, "
                  r"(cache .*)\)$", out, re.M)
    if m is None:
        raise SystemExit(f"phase 9b FAILED: the launcher printed no restore line:\n{out[-2000:]}")
    return m.group(2), f"[{m.group(1)}]: {m.group(3)} ({m.group(4)})"


def served_line(out: str, phase: str = "9b") -> str:
    """The launcher's LM serving line (tokens in seconds, tok/s)."""
    import re

    served = re.search(r"^\S+: \d+x\d+ tokens in [\d.]+s \(\d+ tok/s\)$", out, re.M)
    if served is None or "first sequence: [" not in out:
        raise SystemExit(f"phase {phase} FAILED: the launcher served nothing:\n{out[-2000:]}")
    return served.group(0)


def lm_processes() -> None:
    """Phases 9b (the launcher) and 9c (the two new examples), all as
    processes at once, each in a directory of its own: the launcher's
    ``--reduced --restore-from-tape`` on ``cuda`` and on ``python`` must
    print the same restore line but for its times, its LM mode must serve
    on the card (the default command, Qwen2.5-3B at full width, and the
    other dense decoders reduced), ``tape_restore`` the
    same numbers with its default (``cuda``) and ``--backend python``, and
    ``serve_batched`` must serve on the card (its default) and on the CPU."""
    import os
    import re
    import shutil

    env = dict(os.environ, PYTHONPATH=str(SRC))
    work = ROOT / "build" / "chip_smoke_lm"
    shutil.rmtree(work, ignore_errors=True)
    example = ROOT / "examples" / "torch"
    runs = {}
    for arch in LM_LAUNCHER_ARCHS:
        for backend in ("cuda", "python"):
            runs["launcher", arch, backend] = [
                "-m", "repro_torch.launch.serve", "--arch", arch, "--reduced",
                "--restore-from-tape", "--tape-backend", backend]
    for name, args in LM_LAUNCHER_SERVES.items():
        runs["launcher", name] = ["-m", "repro_torch.launch.serve", *args]
    runs["tape_restore", "cuda"] = [str(example / "tape_restore.py")]
    runs["tape_restore", "python"] = [str(example / "tape_restore.py"), "--backend", "python"]
    runs["serve_batched", "cuda"] = [str(example / "serve_batched.py")]
    runs["serve_batched", "cpu"] = [str(example / "serve_batched.py"), "--device", "cpu"]
    procs = {}
    try:
        for key, args in runs.items():
            cwd = work / "-".join(key)
            cwd.mkdir(parents=True)
            procs[key] = subprocess.Popen([sys.executable, *args], cwd=cwd, env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True)
        printed = {}
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise SystemExit(f"phase 9 FAILED: {' '.join(key)} exited {proc.returncode}:\n"
                                 f"{err[-3000:]}")
            printed[key] = out
        for arch in LM_LAUNCHER_ARCHS:
            lines = {b: restore_line(printed["launcher", arch, b]) for b in ("cuda", "python")}
            if lines["cuda"] != ("cuda", lines["python"][1]) or lines["python"][0] != "python":
                raise SystemExit(f"phase 9b FAILED: launcher --arch {arch} --reduced "
                                 f"--restore-from-tape: cuda {lines['cuda']} != python "
                                 f"{lines['python']}")
            served = served_line(printed["launcher", arch, "cuda"])
            log(f"phase 9b: launcher --arch {arch} --reduced --restore-from-tape: restore line "
                f"cuda == python ({lines['cuda'][1]}); {served}")
        for name in LM_LAUNCHER_SERVES:
            log(f"phase 9b: launcher {' '.join(runs['launcher', name][2:]) or '(defaults)'} on "
                f"the card: {served_line(printed['launcher', name])}")
        cuda = example_numbers(printed["tape_restore", "cuda"], None)
        if cuda != example_numbers(printed["tape_restore", "python"], None) or len(cuda) <= 5:
            raise SystemExit("phase 9c FAILED: example tape_restore: cuda numbers != python")
        log(f"phase 9c: example tape_restore: {len(cuda)} numbers, cuda (default) == python")
        for line in printed["tape_restore", "cuda"].splitlines():
            if line.startswith(("dp ", "simpledp ")):
                log(f"  cuda: {line}")
        for device in ("cuda", "cpu"):
            out = printed["serve_batched", device]
            decode = re.search(r"^decode: .*tok/s batch-aggregate\)$", out, re.M)
            if f"device={device}" not in out or decode is None or "  seq2: [" not in out:
                raise SystemExit(f"phase 9c FAILED: example serve_batched on {device}:\n{out}")
            log(f"phase 9c: example serve_batched on {device}: {decode.group(0)}")
        shutil.rmtree(work, ignore_errors=True)
    finally:  # no process outlives the phase, whatever failed
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

def profile_split(prof, steps: int) -> dict:
    """Kernel time and counts a step from a ``torch.profiler`` run: kernel
    events (device time) apart from operator events (host), the device time
    of each operator's own kernels, and that of the kernels launched inside
    the ``adamw_update`` range."""
    from torch.autograd import DeviceType

    def dev_us(evt, total: bool = False):
        names = ("device_time_total", "cuda_time_total") if total else \
            ("self_device_time_total", "self_cuda_time_total")
        for name in names:
            if hasattr(evt, name):
                return getattr(evt, name)
        return 0.0

    kernels, ops, n_ops, adamw = [], [], 0, 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            if evt.key != "adamw_update":  # the range's mark on the device, not a kernel
                kernels.append((dev_us(evt), evt.key, evt.count))
        elif evt.key.startswith("aten::"):
            n_ops += evt.count
            ops.append((dev_us(evt), evt.key, evt.count, dev_us(evt, total=True)))
        elif evt.key == "adamw_update":
            adamw = dev_us(evt, total=True)
    return {"kernel_ms": sum(k[0] for k in kernels) / 1e3 / steps,  # per step
            # (self device us, name, count[, device us with the operators it calls])
            "kernels": sum(k[2] for k in kernels) / steps, "ops": n_ops / steps,
            "by_kernel": sorted(kernels, reverse=True), "by_op": sorted(ops, reverse=True),
            "adamw_ms": adamw / 1e3 / steps}


def train_step_bound_ms(cfg, n_params: int, batch: int, seq: int) -> tuple[float, str, dict]:
    """The least time a remat-``full`` train step of a dense decoder, or of an
    encoder-decoder, could take on the card: its products (forward, the
    checkpointed layers' forward again, backward twice the forward), the
    projections and head in bf16 at the tensor cores' peak, the attention
    scores in float32 off them (both L x L products, as the masked score
    matrix is computed whole), against the parameters, ``m`` and ``v`` read
    and written once.  An encoder-decoder adds its encoder over the frames
    (the same layer, non-causal M x M scores) and each decoder layer's
    cross-attention: queries and output of the tokens, keys and values of
    the frames, L x M scores."""
    D, dh, L, Hq = cfg.d_model, cfg.head_dim, seq, cfg.num_heads
    layer = D * dh * (Hq * 2 + cfg.num_kv_heads * 2) + 3 * D * cfg.d_ff
    periods = 2 * batch * L * layer * cfg.num_layers
    head = 2 * batch * L * D * cfg.vocab_size
    attn = 4 * batch * Hq * L * L * dh * cfg.num_layers
    if cfg.enc_layers:
        M = cfg.num_enc_frames
        periods += 2 * batch * M * layer * cfg.enc_layers
        attn += 4 * batch * Hq * M * M * dh * cfg.enc_layers
        periods += 2 * batch * D * dh * (L * Hq * 2 + M * cfg.num_kv_heads * 2) * cfg.num_layers
        attn += 4 * batch * Hq * L * M * dh * cfg.num_layers
    flops = {"bf16": 3 * (periods + head) + periods, "float32": 4 * attn,
             "bytes": 6 * 4 * n_params}
    ops_ms = 1e3 * (flops["bf16"] / PEAK_OPS_PER_S["bfloat16"] +
                    flops["float32"] / PEAK_OPS_PER_S["float32"])
    bytes_ms = 1e3 * flops["bytes"] / HBM_BYTES_PER_S
    return max(ops_ms, bytes_ms), "operations" if ops_ms > bytes_ms else "bytes", flops


def lm_training(phase: str, argv: list[str], timed_from: int, dev: str) -> None:
    """Phases 10a and 13e: a model trained at full width through the
    launcher's loop (``launch.train.train``) on ``argv``, no checkpoint.
    Every loss and gradient norm must be finite, the last loss below the
    first, every parameter leaf moved and the optimizer at the last step;
    then two more steps run under the profiler.  An enc-dec model trains on
    random frames (``--frontend-seed``); on the launcher's default zero
    frames one step's gradients are then measured (not checked: they are
    non-finite in the reference too)."""
    import shutil
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from repro_torch.distributed.checkpoint import named_leaves
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import init_model
    from repro_torch.training import OptConfig, loss_fn, make_train_step

    work = ROOT / "build" / f"chip_smoke_train_{phase}"
    shutil.rmtree(work, ignore_errors=True)
    args = launch_train.build_parser().parse_args([*argv, "--device", dev, "--ckpt-dir",
                                                   str(work / "full")])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = launch_train.train(args)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cfg, params, opt, hist = run["cfg"], run["params"], run["opt_state"], run["history"]
    n_params = sum(p.numel() for p in params.parameters())
    losses = [h["loss"] for h in hist]
    finite = all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    if not finite or len(hist) != args.steps or not losses[-1] < losses[0]:
        raise SystemExit(f"phase {phase} FAILED: losses {losses}, grad norms "
                         f"{[h['grad_norm'] for h in hist]}")
    if int(opt["step"]) != args.steps or (work / "full").exists():
        raise SystemExit(f"phase {phase} FAILED: optimizer at step {int(opt['step'])}, or a "
                         f"checkpoint was written")
    fresh = init_model(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    still = [name for (name, a), b in zip(params.named_parameters(), fresh.parameters())
             if torch.equal(a, b)]
    del fresh
    if still:
        raise SystemExit(f"phase {phase} FAILED: parameter leaves that did not move: {still}")
    secs = [h["seconds"] for h in hist[timed_from - 1:]]
    step_s = statistics.median(secs)
    tokens = args.batch * args.seq
    bound, bound_by, flops = train_step_bound_ms(cfg, n_params, args.batch, args.seq)
    frames = (f" over {cfg.num_enc_frames} random frames (--frontend-seed "
              f"{args.frontend_seed})" if cfg.enc_layers else "")
    log(f"phase {phase}: {cfg.arch_id} trained at full width ({n_params} parameters, not cut), "
        f"{args.steps} steps at batch {args.batch} x {args.seq}{frames} in {wall:.3f} s with the "
        f"initialisation; loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad norm "
        f"{hist[0]['grad_norm']:.3f} -> {hist[-1]['grad_norm']:.3f}, every leaf moved, "
        f"optimizer at step {int(opt['step'])}")
    log(f"phase {phase}: steps {timed_from}-{args.steps}: median {1e3 * step_s:.3f} ms a step "
        f"(min {1e3 * min(secs):.3f}, max {1e3 * max(secs):.3f}), {tokens / step_s:.1f} "
        f"tokens/s; first step {1e3 * hist[0]['seconds']:.3f} ms; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    log(f"phase {phase}: bound of a step {bound:.3f} ms ({bound_by}: {flops['bf16']:.4g} FLOP of "
        f"bf16 products, {flops['float32']:.4g} of float32 attention products; parameters, m "
        f"and v read and written once, {flops['bytes']:.4g} bytes): the step at "
        f"{1e3 * step_s / bound:.2f}x its bound")

    # where a step's time goes: two more steps under the profiler
    try:
        step = make_train_step(cfg, OptConfig(learning_rate=args.lr, warmup_steps=20,
                                              total_steps=args.steps + 2))
        rng = np.random.default_rng(1)
        gen = (None if args.frontend_seed is None
               else torch.Generator(dev).manual_seed(args.frontend_seed + 1))
        batches = [launch_train.train_batch(cfg, np.minimum(
            rng.zipf(1.2, size=(args.batch, args.seq)), cfg.vocab_size - 1), dev, gen)
            for _ in range(2)]
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in batches:
                step(params, opt, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        split = profile_split(prof, 2)
        per, kern = 1e3 * wall / 2, max(split["kernel_ms"], 1e-9)
        log(f"phase {phase}: profiler, 2 steps: {per:.3f} ms wall and {split['kernel_ms']:.3f} ms "
            f"of kernel time a step ({100 * split['kernel_ms'] / per:.1f}% busy), "
            f"{split['kernels']:.0f} kernels and {split['ops']:.0f} aten operators a step; "
            f"adamw_update {split['adamw_ms']:.3f} ms of kernel time a step "
            f"({100 * split['adamw_ms'] / kern:.1f}%)")
        names = {"aten::mm": "products", "aten::bmm": "attention products (float32)",
                 "aten::copy_": "casts: float32 -> bf16 weights, bf16 -> float32 gradients",
                 "aten::stack": "unbind backward: each leaf's period gradients stacked",
                 "aten::select_backward": "select backward: no period is selected, only the "
                                          "label pick's [..., 0]"}
        top = split["by_op"][:12]
        named = [row for row in split["by_op"][12:] if row[1] in names]
        for us, key, count, incl in top + named:
            log(f"  {100 * us / 2e3 / kern:5.1f}% {us / 2e3:9.3f} ms/step "
                f"x{count // 2}: {key} {('(' + names[key] + ')') if key in names else ''}"
                f"{f'; {incl / 2e3:.3f} ms/step with the operators it calls' if incl > us else ''}")
        for key in names:
            if not any(row[1] == key for row in split["by_op"]):
                log(f"  0 calls: {key} ({names[key]})")
        for us, key, count in split["by_kernel"][:10]:
            log(f"  kernel {100 * us / 2e3 / kern:5.1f}% "
                f"{us / 2e3:9.3f} ms/step x{count // 2}: {key[:110]}")
    except RuntimeError as e:  # the profiler is not needed for any check
        log(f"phase {phase}: profiler not measured ({e})")
    if cfg.enc_layers:  # the launcher's default zero frames, measured
        batch = launch_train.train_batch(cfg, np.zeros((args.batch, args.seq), np.int32), dev)
        names, leaves = zip(*named_leaves(params))
        grads = torch.autograd.grad(loss_fn(params, cfg, batch)[0], leaves)
        bad = [name for name, g in zip(names, grads) if not bool(torch.isfinite(g).all())]
        log(f"phase {phase}: on the launcher's default zero frames one step's gradients are "
            f"non-finite in {len(bad)} of {len(names)} leaves {bad[:6]} (every encoder layer "
            f"sees zero rows; the reference's are non-finite too)")
        del grads
    del params, opt, run
    torch.cuda.empty_cache()


def reduced_training(dev: str) -> None:
    """Phase 10b: the dense decoders, reduced, in float32: one train step's
    loss and every gradient on the card against the CPU port, and one step
    with 4 microbatches against one with the whole batch."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed.checkpoint import named_leaves
    from repro_torch.training import OptConfig, init_train_state, loss_fn, make_train_step

    for arch in TRAIN_ARCHS:
        cfg = dataclasses.replace(reduced(ARCHS[arch]), compute_dtype="float32")
        cpu, _ = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        tokens = torch.from_numpy(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (8, 16)).astype(np.int32))
        grads, totals = {}, {}
        for name, model, toks in (("cpu", cpu, tokens), ("cuda", card, tokens.to(dev))):
            total, _ = loss_fn(model, cfg, {"tokens": toks})
            grads[name] = torch.autograd.grad(total, [p for _, p in named_leaves(model)])
            totals[name] = float(total.detach())
        rel = max(float((g.cpu() - w).abs().max() / w.abs().max())
                  for g, w in zip(grads["cuda"], grads["cpu"]))
        loss_rel = abs(totals["cuda"] - totals["cpu"]) / abs(totals["cpu"])
        if not (rel <= TRAIN_GRAD_REL and loss_rel <= 1e-5):
            raise SystemExit(f"phase 10b FAILED: {arch}: cuda gradients rel {rel}, loss rel "
                             f"{loss_rel} against the CPU")
        # the reference's microbatching test, on the card
        mcfg = dataclasses.replace(reduced(ARCHS[arch], periods=1), vocab_size=64, remat=False,
                                   compute_dtype="float32")
        mtok = torch.from_numpy(np.random.default_rng(1).integers(
            0, 64, (8, 16)).astype(np.int32)).to(dev)
        after = []
        for k in (1, 4):
            params, opt = init_train_state(torch.Generator(dev).manual_seed(0), mcfg, device=dev)
            make_train_step(mcfg, OptConfig(warmup_steps=1, total_steps=10), microbatches=k)(
                params, opt, {"tokens": mtok})
            after.append(params)
        micro = max(float((a - b).detach().abs().max())
                    for a, b in zip(after[0].parameters(), after[1].parameters()))
        if not micro < TRAIN_MICRO_BOUND:
            raise SystemExit(f"phase 10b FAILED: {arch}: 4 microbatches != 1 on the card, "
                             f"max |dp| {micro}")
        log(f"phase 10b: {arch} reduced, float32: loss rel {loss_rel:.3e}, gradients within "
            f"{rel:.3e} of each leaf's largest element of the CPU's (held at {TRAIN_GRAD_REL}); "
            f"4 microbatches vs 1: max |dp| {micro:.3e} < {TRAIN_MICRO_BOUND}")
    torch.cuda.empty_cache()


def moe_serving(dev: str) -> None:
    """Phase 11a: DeepSeek-V2 at full width, cut to three layers.  Its
    float32 check runs with the capacity factor raised to the number of
    experts: every assignment is then kept (C = T * K), in the full-sequence
    forward and in each decode step alike, as the reference's own
    decode-vs-forward test raises it (tests/test_models.py); the bf16
    serving keeps the config's 1.25, which drops at decode (C = 1)."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS[MOE_ARCH], num_layers=MOE_LAYERS)
    params = serve_full_width("11a", cfg, dev,
                              check_overrides={"capacity_factor": float(cfg.num_experts)},
                              cut=f", depth cut from {ARCHS[MOE_ARCH].num_layers} to "
                                  f"{MOE_LAYERS} layers")
    n_params = sum(p.numel() for p in params.parameters())
    del params
    torch.cuda.empty_cache()
    if n_params != MOE_PARAMS:
        raise SystemExit(f"phase 11a FAILED: {n_params} parameters, not {MOE_PARAMS}")


def recurrent_serving(dev: str) -> None:
    """Phases 12a and 12b: Jamba at full width cut to one period, then
    xLSTM-1.3B whole (see :func:`serve_full_width`), each checked over 512
    tokens.  Jamba's check raises the capacity factor to the number of
    experts, as 11a does, so that nothing drops; its bf16 serving keeps the
    config's 1.25 (``C = 1`` at batch 8).  xLSTM's check runs against its
    float64 forward (``XLSTM_CHECK``).  A step's bound adds the recurrent
    state (Mamba's ``conv`` and ``ssm``; the mLSTM ``C``, ``n`` and ``m``, the
    sLSTM ``c``, ``n``, ``h`` and ``m``) read and written once."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS

    for phase, arch, cfg, overrides, cut, check, want in (
            ("12a", JAMBA_ARCH, dataclasses.replace(ARCHS[JAMBA_ARCH], num_layers=JAMBA_LAYERS),
             {"capacity_factor": float(ARCHS[JAMBA_ARCH].num_experts)},
             f", depth cut from {ARCHS[JAMBA_ARCH].num_layers} to {JAMBA_LAYERS} layers (one "
             f"period)", RECURRENT_CHECK, JAMBA_PARAMS),
            ("12b", XLSTM_ARCH, ARCHS[XLSTM_ARCH], {}, ", not cut", XLSTM_CHECK, XLSTM_PARAMS)):
        torch.cuda.empty_cache()
        log(f"phase {phase}: device memory before: {torch.cuda.memory_allocated() / 2**30:.3f} "
            f"GiB allocated")
        params = serve_full_width(phase, cfg, dev, check_overrides=overrides, cut=cut,
                                  check=check)
        n_params = sum(p.numel() for p in params.parameters())
        del params
        torch.cuda.empty_cache()
        if n_params != want:
            raise SystemExit(f"phase {phase} FAILED: {arch}: {n_params} parameters, not {want}")


def cross_serving(dev: str) -> None:
    """Phases 13a and 13b: Llama-3.2-Vision at full width cut to two periods,
    then SeamlessM4T-large-v2 whole (see :func:`serve_full_width`), each
    checked at ``LM_CHECK``'s batch and length against its memory: random
    vision embeddings, or random frames through the encoder."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS

    for phase, cfg, cut, want in (
            ("13a", dataclasses.replace(ARCHS[VLM_ARCH], num_layers=VLM_LAYERS),
             f", depth cut from {ARCHS[VLM_ARCH].num_layers} to {VLM_LAYERS} layers (two "
             f"periods)", VLM_PARAMS),
            ("13b", ARCHS[SEAMLESS_ARCH], ", not cut", SEAMLESS_PARAMS)):
        torch.cuda.empty_cache()
        params = serve_full_width(phase, cfg, dev, check_overrides={}, cut=cut)
        n_params = sum(p.numel() for p in params.parameters())
        del params
        torch.cuda.empty_cache()
        if n_params != want:
            raise SystemExit(f"phase {phase} FAILED: {cfg.arch_id}: {n_params} parameters, not "
                             f"{want}")


def checkpoint_restore(phase: str, archs, dev: str, u_turn_mb: int) -> dict:
    """Phases 11b, 12c and 13c: the restore of whole checkpoints from tape,
    planned under ``dp`` and ``simpledp`` on the card in float64 tables and
    held equal to ``python``.  The trees hold shapes only (``meta``); the
    U-turn is the paper profile's, in MB, turned into bytes.  Returns the
    launches of the plans."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core import ExecutionContext
    from repro_torch.distributed.checkpoint import archive_to_tape, plan_restore
    from repro_torch.kernels.ltsp_dp import ltsp_dp
    from repro_torch.models.model import init_model
    from repro_torch.storage.tape import TapeLibrary

    cuda = ExecutionContext(backend="cuda", device=dev, numeric_policy="f64")
    libs = {}
    for arch in archs:
        params = init_model(torch.Generator().manual_seed(0), ARCHS[arch], device="meta")
        sizes = [p.numel() for p in params.parameters()]
        lib = TapeLibrary(capacity_per_tape=MOE_TAPE_BYTES, u_turn=u_turn_mb * 10**6)
        shards = archive_to_tape(lib, arch, params, bytes_per_elem=4)
        libs[arch] = (lib, shards, {s: 8 if "embed" in s else 2 for s in shards}, sizes)
        del params
    ltsp_dp.reset_launches()
    plans, walls = {}, {}
    for arch, (lib, shards, consumers, _) in libs.items():
        for policy in ("dp", "simpledp"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plans[arch, policy] = plan_restore(lib, shards, consumers, policy=policy,
                                               context=cuda)
            torch.cuda.synchronize()
            walls[arch, policy] = time.perf_counter() - t0
    launches = dict(ltsp_dp.LAUNCHES)

    def plain(read_plans):
        return [dataclasses.replace(p, backend="") for p in read_plans]

    for (arch, policy), got in plans.items():
        lib, shards, consumers, sizes = libs[arch]
        want = plan_restore(lib, shards, consumers, policy=policy,
                            context=ExecutionContext(backend="python"))
        if plain(got) != plain(want) or any(p.backend != "cuda" for p in got):
            raise SystemExit(f"phase {phase} FAILED: {arch} {policy} restore plans on cuda "
                             f"!= python")
        mean = sum(p.total_cost for p in got) / sum(consumers.values())
        log(f"phase {phase}: {arch} whole ({sum(sizes)} parameters, {len(shards)} shards, largest "
            f"{4 * max(sizes) / 1e9:.1f} GB) on {len(lib.tapes)} cartridge(s) of "
            f"{MOE_TAPE_BYTES / 1e12:.0f} TB: {policy} mean arrival {mean:.6g}, "
            f"planned on cuda in {1e3 * walls[arch, policy]:.3f} ms wall, == python")
    if launches["far_fold_kernel"] + launches["near_fold_kernel"] == 0 or \
            launches["traceback_kernel"] == 0:
        raise SystemExit(f"phase {phase} FAILED: the restore plans launched {launches}")
    log(f"phase {phase}: launches of the restore plans {launches}")
    return launches


def reduced_on_the_card(phase: str, archs, dev: str, grad_rel: float) -> None:
    """Phases 11c, 12d and 13d: ``archs`` reduced, float32, on the card against
    the CPU port: forward and its aux loss, every decode step, the greedy
    tokens, and one train step's loss, aux loss and gradients (within
    ``grad_rel`` of each leaf's largest element); in an MoE arch also each
    period's routing (integer: exactly) and the train step under both
    dispatch modes; a cross-attention arch takes random frontend embeddings
    (its encoder's output held too), decodes against warmed cross caches and
    trains on a batch that carries them.  Then the serve and train launchers
    on the card, as processes."""
    import copy
    import dataclasses
    import math
    import os
    import re
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed.checkpoint import named_leaves
    from repro_torch.models.common import moe_route, moe_slots
    from repro_torch.models.model import decode_step, forward
    from repro_torch.serving.serve import make_serve_step
    from repro_torch.training import init_train_state, loss_fn

    work = ROOT / "build" / f"chip_smoke_{phase}"
    shutil.rmtree(work, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {}
    try:
        for arch in archs:  # the launchers run while the in-process checks do
            for name, args in LAUNCHER_RUNS.items():
                cwd = work / f"{arch}-{name}"
                cwd.mkdir(parents=True)
                extra = ["--ckpt-dir", str(cwd / "ckpt")] if name == "train" else []
                extra += LAUNCHER_EXTRA.get((arch, name), [])
                procs[arch, name] = subprocess.Popen(
                    [sys.executable, *args, "--arch", arch, *extra], cwd=cwd, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        for arch in archs:
            cfg = dataclasses.replace(reduced(ARCHS[arch]), compute_dtype="float32")
            cpu, _ = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
            cpu.requires_grad_(False)
            card = copy.deepcopy(cpu).to(dev)
            tokens = torch.from_numpy(np.random.default_rng(11).integers(
                0, cfg.vocab_size, (2, 16)).astype(np.int32))
            embeds = frontend_embeds(cfg, 2, "cpu", seed=13)
            mems = {d: cross_memory(m, cfg, {k: v.to(d) for k, v in embeds.items()})
                    for d, m in ((dev, card), ("cpu", cpu))}
            pairs = {"forward": (forward(card, cfg, tokens.to(dev), memory=mems[dev]),
                                 forward(cpu, cfg, tokens, memory=mems["cpu"]))}
            pairs["aux"] = (pairs["forward"][0][1], pairs["forward"][1][1])
            pairs["forward"] = (pairs["forward"][0][0], pairs["forward"][1][0])
            if cfg.enc_layers:
                pairs["encode"] = (mems[dev], mems["cpu"])
            caches = (warmed_cache(card, cfg, 2, 16, mems[dev], dev),
                      warmed_cache(cpu, cfg, 2, 16, mems["cpu"], "cpu"))
            for t in range(16):
                pairs[f"decode {t}"] = (
                    decode_step(card, cfg, tokens[:, t : t + 1].to(dev), caches[0], t)[0],
                    decode_step(cpu, cfg, tokens[:, t : t + 1], caches[1], t)[0])
            err = {k: float((got.cpu() - want).abs().max()) for k, (got, want) in pairs.items()}
            if not all(torch.allclose(got.cpu(), want, rtol=MOE_TOL, atol=MOE_TOL)
                       for got, want in pairs.values()):
                raise SystemExit(f"phase {phase} FAILED: {arch}: cuda != cpu, max abs errors "
                                 f"{err}")
            err["decode"] = max(v for k, v in err.items() if k.startswith("decode "))
            # each period's routing of one input, exactly
            x = torch.from_numpy(np.random.default_rng(3).normal(
                size=(32, cfg.d_model)).astype(np.float32))
            moe = next((f"l{i}" for i in range(len(cfg.block_pattern)) if cfg.is_moe_layer(i)),
                       None)
            for i in range(cfg.n_periods if moe else 0):
                router = cpu["periods"][moe]["moe"]["router"]
                routed = [(top_e.cpu(), moe_slots(top_e, cfg)[1].cpu()) for top_e in (
                    moe_route(router[i].to(d), x.to(d), cfg)[2] for d in ("cpu", dev))]
                if not all(torch.equal(a, b) for a, b in zip(*routed)):
                    raise SystemExit(f"phase {phase} FAILED: {arch}: period {i} routes "
                                     f"differently on cuda")
            # the greedy tokens: 4 teacher-forced, then 8 greedy
            serve, seqs = make_serve_step(cfg), {}
            for d, model in (("cpu", cpu), (dev, card)):
                cache = warmed_cache(model, cfg, 2, 12, mems[d], d)
                tok, seq = tokens[:, :1].to(d), []
                for t in range(12):
                    nxt, _, cache = serve(model, cache, tok, t)
                    tok = tokens[:, t + 1 : t + 2].to(d) if t + 1 < 4 else nxt
                    seq += [nxt.cpu()] if t + 1 >= 4 else []
                seqs[d] = torch.cat(seq, 1)
            if not torch.equal(seqs["cpu"], seqs[dev]):
                raise SystemExit(f"phase {phase} FAILED: {arch}: greedy tokens on cuda != cpu")
            # one train step's loss, aux loss and gradients, both dispatch modes
            train = {}
            for gather in (False, True) if moe else (False,):
                gcfg = dataclasses.replace(cfg, moe_gather_dispatch=gather)
                batch = {"tokens": torch.from_numpy(np.random.default_rng(11).integers(
                    0, cfg.vocab_size, (8, 16)).astype(np.int32)),
                    **frontend_embeds(cfg, 8, "cpu", seed=14)}
                res = {}
                for d, model in (("cpu", cpu), (dev, card)):
                    model.requires_grad_(True)
                    total, metrics = loss_fn(model, gcfg,
                                             {k: v.to(d) for k, v in batch.items()})
                    grads = torch.autograd.grad(total, [p for _, p in named_leaves(model)])
                    res[d] = (float(total.detach()), float(metrics["aux_loss"].detach()), grads)
                    model.requires_grad_(False)
                (tc, ac, gc), (tg, ag, gg) = res["cpu"], res[dev]
                rel = max(float((g.cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30))
                          for g, w in zip(gg, gc))
                loss_rel = abs(tg - tc) / abs(tc)
                aux_rel = abs(ag - ac) / abs(ac) if ac else abs(ag)  # 0 without MoE layers
                if not (rel <= grad_rel and loss_rel <= 1e-5 and aux_rel <= 1e-5):
                    raise SystemExit(f"phase {phase} FAILED: {arch} (gather {gather}): gradients "
                                     f"rel {rel}, loss rel {loss_rel}, aux rel {aux_rel}")
                train[gather] = (loss_rel, aux_rel, rel)
            routing = f"routing of {cfg.n_periods} periods equal, " if moe else ""
            memory = (f" over {next(iter(embeds.values())).shape[1]} random frontend rows"
                      + (f" (encoder output {err['encode']:.3e})" if cfg.enc_layers else "")
                      + ", decode against warmed cross caches" if embeds else "")
            log(f"phase {phase}: {arch} reduced, float32, cuda vs cpu{memory}: forward "
                f"{err['forward']:.3e}, aux {err['aux']:.3e}, decode {err['decode']:.3e} (max "
                f"abs), {routing}greedy tokens equal; train step "
                + "; ".join(f"{'gather' if g else 'scatter'} dispatch: loss rel {lr:.3e}, aux "
                            f"rel {ar:.3e}, gradients within {gr:.3e} of each leaf's largest "
                            f"element" for g, (lr, ar, gr) in train.items()))
            del cpu, card

        for (arch, name), proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise SystemExit(f"phase {phase} FAILED: {name} launcher --arch {arch} exited "
                                 f"{proc.returncode}:\n{err[-3000:]}")
            if name == "serve":
                line = served_line(out, phase)
                numbers = re.findall(r"[\d.]+(?=s \()|\d+(?= tok/s)", line)
            else:  # the step line as the launcher prints it: a nan or inf does not match
                step = re.search(r"^step +10 loss=(\d+\.\d{4}) lr=(\S+) gnorm=(\d+\.\d{2})$",
                                 out, re.M)
                line, numbers = (step.group(0), step.groups()) if step else ("", ())
                if out.splitlines()[-1:] != ["done"]:
                    line = ""
            if not line or len(numbers) != 3 - (name == "serve") or \
                    not all(math.isfinite(float(v)) for v in numbers):
                raise SystemExit(f"phase {phase} FAILED: {name} launcher --arch {arch} "
                                 f"--reduced printed:\n{out[-2000:]}")
            args = " ".join(["--reduced", *LAUNCHER_EXTRA.get((arch, name), [])])
            log(f"phase {phase}: {name} launcher --arch {arch} {args} on the card: {line}")
        shutil.rmtree(work, ignore_errors=True)
    finally:  # no process outlives the phase, whatever failed
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    torch.cuda.empty_cache()


def training_paths(dev: str) -> dict:
    """Phase 10c: the training example's corpus plan on the card == python
    (its launches are this path's), the example with its defaults and with
    ``--backend python`` as processes, and the launcher reduced,
    checkpointed, then resumed.  Returns the launches of the plan."""
    import importlib.util
    import os
    import re
    import shutil

    from repro_torch.core import ExecutionContext
    from repro_torch.kernels.ltsp_dp import ltsp_dp
    from repro_torch.launch import train as launch_train

    work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    script = ROOT / "examples" / "torch" / "train_e2e.py"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {}
    try:
        for backend, extra in (("cuda", []), ("python", ["--backend", "python"])):
            cwd = work / f"example-{backend}"
            cwd.mkdir(parents=True)
            procs[backend] = subprocess.Popen(
                [sys.executable, str(script), "--ckpt-dir", str(cwd / "ckpt"), *extra], cwd=cwd,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        spec = importlib.util.spec_from_file_location("train_e2e", script)
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        streams = {}
        for backend in ("python", "cuda"):
            ctx = ExecutionContext(backend=backend, device=dev, numeric_policy="f64")
            lib, shards = example.build_corpus_on_tape(12, 8 * 128 * 16, 512, context=ctx)
            ltsp_dp.reset_launches()
            streams[backend] = [(name, t) for name, _, t in example.scheduled_shard_stream(lib,
                                                                                        shards)]
            launches = dict(ltsp_dp.LAUNCHES)
        if streams["cuda"] != streams["python"]:
            raise SystemExit("phase 10c FAILED: the corpus plan on cuda != python")
        if launches["far_fold_kernel"] + launches["near_fold_kernel"] == 0 or \
                launches["traceback_kernel"] == 0:
            raise SystemExit(f"phase 10c FAILED: the corpus plan launched {launches}")
        log(f"phase 10c: corpus plan (simpledp, {len(streams['cuda'])} shards) on cuda == "
            f"python, first shard at t={streams['cuda'][0][1]:,}, launches {launches}")

        runs = []
        for argv in TRAIN_RESUME:
            args = launch_train.build_parser().parse_args(
                [*argv, "--device", dev, "--ckpt-dir", str(work / "launcher")])
            runs.append(launch_train.train(args))
        first, second = runs
        if second["start"] != 30 or len(second["history"]) != 10 or \
                int(second["opt_state"]["step"]) != 40:
            raise SystemExit(f"phase 10c FAILED: the launcher resumed at {second['start']} "
                             f"and ran {len(second['history'])} steps")
        log(f"phase 10c: launcher --reduced: 30 steps, checkpoints every 10, then --resume "
            f"--steps 40 resumed from step {second['start']}: loss "
            f"{first['history'][0]['loss']:.4f} -> {second['history'][-1]['loss']:.4f}")
        del runs, first, second

        printed = {}
        for backend, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise SystemExit(f"phase 10c FAILED: train_e2e on {backend} exited "
                                 f"{proc.returncode}:\n{err[-3000:]}")
            printed[backend] = out.splitlines()
        cuda = printed["cuda"]
        preempt = [line for line in cuda if re.match(r"step \d+: restored from checkpoint", line)]
        if cuda[0] != printed["python"][0] or preempt != ["step 60: restored from checkpoint, "
                                                          "continuing"] or \
                not cuda[-1].endswith("loss decreased: True"):
            raise SystemExit("phase 10c FAILED: example train_e2e:\n" + "\n".join(cuda))
        log(f"phase 10c: example train_e2e (defaults, cuda): {cuda[0]} (== python); "
            f"{preempt[0]}; {cuda[-1]}")
        shutil.rmtree(work, ignore_errors=True)
        return launches
    finally:  # no process outlives the phase, whatever failed
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def profiled_ops(step, steps: int = 1) -> dict:
    """One call of ``step`` (``steps`` steps) under the profiler: its
    :func:`profile_split` per step and wall ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {**profile_split(prof, steps), "wall_ms": 1e3 * wall / steps}


def mesh_training(dev: str, store: Path) -> dict:
    """Phase 14a: Qwen2.5-3B trained at full width through the launcher's
    loop (``launch.train.train``), first on the plain path, then with a
    process group of one rank up, on the mesh path: every parameter and
    moment a ``DTensor`` on the ``{'data': 1, 'model': 1}`` mesh.  Losses and
    final parameters must be equal bit for bit.  On each path the
    allocator's high-water mark over one more step is read, for
    :func:`check_step_memory`.  Returns the mesh path's config, parameters
    and optimizer state, and each path's measurements."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.checkpoint import named_leaves
    from repro_torch.distributed.context import mesh_scope
    from repro_torch.distributed.sharding import batch_pspecs, full_tree, place_tree
    from repro_torch.launch import train as launch_train
    from repro_torch.training import OptConfig, make_train_step

    def args_of(run: str):
        return launch_train.build_parser().parse_args(
            [*MESH_TRAIN, "--device", dev, "--ckpt-dir", str(store.parent / f"ckpt_{run}")])

    def step_in(mesh, step, params, opt, batch):
        with mesh_scope(mesh):
            step(params, opt, batch)

    def one_run(run: str, mesh_path: bool):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = launch_train.train(args_of(run))
        wall = time.perf_counter() - t0
        cfg, params, opt = out["cfg"], out["params"], out["opt_state"]
        # one more step under the profiler, on a batch of its own
        rng = np.random.default_rng(3)
        step = make_train_step(cfg, OptConfig(learning_rate=3e-4, warmup_steps=20,
                                              total_steps=6))
        batch = launch_train.train_batch(cfg, np.minimum(rng.zipf(1.2, size=(4, 512)),
                                                         cfg.vocab_size - 1), dev)
        if mesh_path:
            batch = place_tree(batch, batch_pspecs(batch, out["mesh"]), out["mesh"])
        peak = torch.cuda.max_memory_allocated()
        # the allocator's high-water mark over this one step, against the tracker
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        step_in(out["mesh"], step, params, opt, batch)
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated()
        split = profiled_ops(lambda: step_in(out["mesh"], step, params, opt, batch))
        secs = [h["seconds"] for h in out["history"][1:]]
        return out, {"wall": wall, "step_ms": 1e3 * statistics.median(secs),
                     "min_ms": 1e3 * min(secs), "max_ms": 1e3 * max(secs),
                     "peak": peak, "held": held, "step_peak": step_peak, "split": split}

    if dist.is_initialized():
        raise SystemExit("phase 14a FAILED: a process group is up before the plain run")
    plain, plain_t = one_run("plain", False)
    if plain["mesh"] is not None:
        raise SystemExit("phase 14a FAILED: the plain run took the mesh path")
    losses = [h["loss"] for h in plain["history"]]
    want = {name: p.detach().cpu() for name, p in named_leaves(plain["params"])}
    del plain
    torch.cuda.empty_cache()

    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1)
    mesh_run, mesh_t = one_run("mesh", True)
    mesh = mesh_run["mesh"]
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    kinds = {type(p).__name__ for p in mesh_run["params"].parameters()} | \
        {type(t).__name__ for _, t in named_leaves(mesh_run["opt_state"]["m"])}
    if axes != {"data": 1, "model": 1} or kinds != {"DTensor"}:
        raise SystemExit(f"phase 14a FAILED: mesh {axes}, leaves {kinds}")
    mesh_losses = [h["loss"] for h in mesh_run["history"]]
    full = full_tree(mesh_run["params"])
    differ = [name for name, t in named_leaves(full) if not torch.equal(t.cpu(), want[name])]
    worst = max(float((t.cpu() - want[name]).abs().max()) for name, t in named_leaves(full))
    del full, want
    if mesh_losses != losses or differ:
        raise SystemExit(f"phase 14a FAILED: mesh path != plain path: losses {mesh_losses} vs "
                         f"{losses}; {len(differ)} parameter leaves differ {differ[:5]}, "
                         f"max abs {worst:.3g}")
    n_params = sum(p.numel() for p in mesh_run["params"].parameters())
    log(f"phase 14a: {LM_ARCH} trained at full width ({n_params} parameters, not cut), "
        f"5 steps at 4 x 512 on the plain path and on the mesh path {axes} (every parameter "
        f"and moment a DTensor): losses {losses} equal bit for bit, all final parameters "
        f"equal bit for bit (max abs difference {worst})")
    for name, t in (("plain", plain_t), ("mesh", mesh_t)):
        sp = t["split"]
        log(f"phase 14a: {name} path: steps 2-5 median {t['step_ms']:.3f} ms a step (min "
            f"{t['min_ms']:.3f}, max {t['max_ms']:.3f}), run with init {t['wall']:.3f} s, peak "
            f"device memory {t['peak'] / 2**30:.3f} GiB; profiled step {sp['wall_ms']:.3f} ms "
            f"wall, {sp['kernel_ms']:.3f} ms of kernel time, {sp['kernels']:.0f} kernels and "
            f"{sp['ops']:.0f} aten operators")
    return mesh_run, {"plain": plain_t, "mesh": mesh_t}


#: phase 14a's tracker: the dry run's per-device memory of 14a's step at
#: world 1, on ``meta`` tensors in a CPU process, on the plain path and on a
#: one-rank mesh of the ``fake`` backend
STEP_MEMORY_CODE = """
import json, sys
from repro_torch.configs import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import train as launch_train

args = launch_train.build_parser().parse_args(sys.argv[1:] + ["--device", "cpu"])
cfg = launch_train.make_config(args)
shape = InputShape("train_step", args.seq, args.batch, "train")
dryrun.start_fake_group(1)
print(json.dumps({name: dryrun.analyse(cfg, shape, mesh)["memory"] for name, mesh in
                  (("plain", None), ("mesh", launch_train._auto_mesh("auto", "cpu")))}))
"""
#: the most the card's high-water mark over a step may differ from the
#: tracker's arguments + temporaries, as a fraction of the tracker's
STEP_MEMORY_REL = 0.10


def step_memory_tracker(work: Path) -> subprocess.Popen:
    """Phase 14a's tracker run, started in a CPU process of its own that
    writes ``work/tracker.out`` and ``work/tracker.err``."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    with open(work / "tracker.out", "w") as out, open(work / "tracker.err", "w") as err:
        return subprocess.Popen([sys.executable, "-c", STEP_MEMORY_CODE, *MESH_TRAIN],
                                stdout=out, stderr=err, env=env, cwd=ROOT)


def check_step_memory(tracker: subprocess.Popen, work: Path, measured: dict) -> None:
    """Phase 14a: the tracker's world-1 peak (the step's arguments plus its
    temporaries, computed on the CPU) against the card allocator's
    ``max_memory_allocated`` over one step of 14a, on each path."""
    try:
        code = tracker.wait(timeout=MESH_DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        raise SystemExit(f"phase 14a FAILED: the tracker took over {MESH_DRYRUN_TIMEOUT} s")
    if code != 0:
        raise SystemExit(f"phase 14a FAILED: the tracker exited {code}: "
                         f"{(work / 'tracker.err').read_text()[-2000:]}")
    predicted = json.loads((work / "tracker.out").read_text().splitlines()[-1])
    for name, t in measured.items():
        mem = predicted[name]
        want = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        ratio = t["step_peak"] / want
        log(f"phase 14a: {name} path, one step at 4 x 512: tracker (computed on the CPU, "
            f"meta tensors, world 1) arguments {mem['argument_size_in_bytes']} B + "
            f"temporaries {mem['temp_size_in_bytes']} B = {want} B ({want / 2**30:.3f} GiB); "
            f"card max_memory_allocated {t['step_peak']} B ({t['step_peak'] / 2**30:.3f} GiB), "
            f"{t['held']} B held before the step; measured / tracker {ratio:.4f} on "
            f"{card_line()}")
        if abs(ratio - 1) > STEP_MEMORY_REL:
            raise SystemExit(f"phase 14a FAILED: {name} path: the card's step peak is "
                             f"{ratio:.4f} x the tracker's (bound {STEP_MEMORY_REL})")


def mesh_compression(run: dict, dev: str) -> None:
    """Phase 14c: the reference's gradient compressors on the gradients of
    one more batch at 14a's trained mesh parameters (gathered), with both
    methods: top-k keeps at most ``max(1, int(n * ratio))`` elements a leaf,
    int8 reconstructs within half its scale, and in both the reconstruction
    plus the new residual is the target (gradient plus old residual)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.distributed.checkpoint import named_leaves
    from repro_torch.distributed.compression import compressed_grads, init_error_feedback
    from repro_torch.distributed.context import mesh_scope
    from repro_torch.distributed.sharding import batch_pspecs, full_tree, place_tree
    from repro_torch.launch import train as launch_train
    from repro_torch.training import loss_fn

    cfg, params, mesh = run["cfg"], run["params"], run["mesh"]
    run.clear()  # the optimizer state goes: the gradients and the compressors need the room
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 14c: {torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card with 14a's "
        f"parameters alone")
    batch = launch_train.train_batch(cfg, np.minimum(np.random.default_rng(4).zipf(
        1.2, size=(4, 512)), cfg.vocab_size - 1), dev)
    names, leaves = zip(*named_leaves(params))
    with mesh_scope(mesh):
        # only the total: the metrics' graph would keep the parameters alive
        total = loss_fn(params, cfg, place_tree(batch, batch_pspecs(batch, mesh), mesh))[0]
        grads = list(torch.autograd.grad(total, leaves))
    del params, leaves, total
    for i, g in enumerate(grads):  # gathered one leaf at a time
        grads[i] = full_tree(g)
    grads = dict(zip(names, grads))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 14c: {torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card with the "
        f"gathered gradients alone")
    n = sum(g.numel() for g in grads.values())
    for method in ("topk", "int8"):
        ef = init_error_feedback(grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec, resid, ratio = compressed_grads(grads, ef, method, ratio=MESH_COMPRESS_RATIO)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        kept, bad = 0, []
        for name, g in grads.items():
            target = g.float() + ef[name]
            if method == "topk":
                k = int((rec[name] != 0).sum())
                kept += k
                ok = k <= max(1, int(g.numel() * MESH_COMPRESS_RATIO)) and \
                    torch.equal(rec[name] + resid[name], target)
            else:
                scale = target.abs().max().clamp_min(1e-12) / 127.0
                ok = float((rec[name] - target).abs().max()) <= float(scale) * 0.5 + 1e-6 and \
                    bool(torch.allclose(rec[name] + resid[name], target, rtol=0,
                                        atol=float(scale) * 1e-6))
            if not ok:
                bad.append(name)
        if bad or ratio != {"topk": 2 * MESH_COMPRESS_RATIO, "int8": 0.25}[method]:
            raise SystemExit(f"phase 14c FAILED: {method}: invariants fail on {bad[:5]}, "
                             f"bytes ratio {ratio}")
        share = f", kept {kept} of {n} elements ({100 * kept / n:.3f}%)" if method == "topk" else ""
        log(f"phase 14c: compressed_grads {method} on {len(grads)} gradient leaves ({n} "
            f"elements) in {ms:.3f} ms, bytes ratio {ratio}{share}; reconstruction + residual "
            f"= target on every leaf")
        del rec, resid, ef
        gc.collect()
        torch.cuda.empty_cache()


def mesh_serving(dev: str) -> None:
    """Phase 14b: Qwen2.5-3B at full width, bf16 compute, batch 8: a prefill
    of ``MESH_SERVE["prompt"]`` tokens through the decode step and
    ``MESH_SERVE["new"]`` greedy steps, on the plain path and on the mesh
    path (parameters by ``param_pspecs``, the cache by ``cache_pspecs``,
    prompts by batch; the process group of 14a up).  The tokens must be
    equal; each path's ms a step and aten operators a step are recorded."""
    import statistics

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.distributed.context import is_sharded, mesh_scope
    from repro_torch.distributed.sharding import cache_pspecs, dp_axes, param_pspecs, place, \
        place_tree
    from repro_torch.launch.train import _auto_mesh
    from repro_torch.models.model import init_cache, init_model
    from repro_torch.serving.serve import make_serve_step

    cfg = ARCHS[LM_ARCH]
    B, P, N = MESH_SERVE["batch"], MESH_SERVE["prompt"], MESH_SERVE["new"]
    serve = make_serve_step(cfg)
    params = init_model(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    mesh = _auto_mesh("auto")
    out = {}
    for name in ("plain", "mesh"):
        cache = init_cache(cfg, B, P + N + 1, device=dev)
        toks = prompts
        on = mesh if name == "mesh" else None
        if on is not None:
            place_tree(params, param_pspecs(params), mesh)
            cache = place_tree(cache, cache_pspecs(cache, mesh), mesh)
            toks = place(prompts, (dp_axes(mesh), None), mesh)
        with mesh_scope(on):
            for t in range(P - 1):
                _, _, cache = serve(params, cache, toks[:, t:t + 1], t)
            tok, seq, secs = toks[:, -1:], [], []
            for t in range(N):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tok, _, cache = serve(params, cache, tok, P - 1 + t)
                seq.append(tok)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            seq = torch.cat(seq, 1)
            split = profiled_ops(lambda: serve(params, cache, tok, P + N - 1))
        out[name] = {"tokens": (seq.full_tensor() if is_sharded(seq) else seq).cpu(),
                     "ms": 1e3 * statistics.median(secs[1:]), "split": split}
    if not torch.equal(out["plain"]["tokens"], out["mesh"]["tokens"]):
        raise SystemExit("phase 14b FAILED: the mesh path's greedy tokens != the plain path's")
    log(f"phase 14b: {LM_ARCH} bf16 at batch {B}, {P} prompt tokens, {N} greedy steps: the "
        f"mesh path's tokens == the plain path's ({out['plain']['tokens'][0, :8].tolist()} ...)")
    for name, r in out.items():
        sp = r["split"]
        log(f"phase 14b: {name} path: median {r['ms']:.3f} ms a step (steps 2-{N}), "
            f"{B * 1e3 / r['ms']:.1f} tokens/s; profiled step {sp['wall_ms']:.3f} ms wall, "
            f"{sp['kernel_ms']:.3f} ms of kernel time, {sp['kernels']:.0f} kernels and "
            f"{sp['ops']:.0f} aten operators")
    del params, cache
    torch.cuda.empty_cache()


def production_meshes_raise() -> None:
    """Phase 14c: ``--mesh pod`` and ``--mesh multipod`` on one card raise
    the reference's ``RuntimeError`` (256 and 512 ranks needed, one here),
    through ``_auto_mesh`` and through both launchers."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    for kind, n in (("pod", 256), ("multipod", 512)):
        head = f"need {n} devices for mesh"
        for label, call in (("_auto_mesh", lambda: launch_train._auto_mesh(kind)),
                            ("train", lambda: launch_train.main(["--mesh", kind])),
                            ("serve", lambda: launch_serve.main(["--mesh", kind]))):
            try:
                call()
            except RuntimeError as e:
                if not str(e).startswith(head) or "have 1" not in str(e):
                    raise SystemExit(f"phase 14c FAILED: {label} --mesh {kind} raised {e}")
                continue
            raise SystemExit(f"phase 14c FAILED: {label} --mesh {kind} did not raise")
        log(f"phase 14c: --mesh {kind} on one card raises the reference's RuntimeError "
            f"('{head} ...; have 1') through _auto_mesh and both launchers")


def mesh_dryrun() -> None:
    """Phase 14d: the dry run of Qwen2.5-3B's ``train_4k`` and
    ``prefill_32k`` cells on both production meshes, one process of its own
    on the CPU for each shape (each starts a fake process group of 512
    ranks), both started together; prints each cell's per-device bytes,
    flops and collectives with the torch release, and fails where a cell's
    flops exceed the reference's by more than ``MESH_FLOPS_REL``."""
    import os

    import torch

    out = ROOT / "build" / "dryrun_14d"
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    procs = {shape: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", LM_ARCH, "--shape", shape,
         "--mesh", "both", "--out", str(out), "--force"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT) for shape in MESH_DRYRUN_SHAPES}
    try:
        outputs = {shape: proc.communicate(timeout=MESH_DRYRUN_TIMEOUT)
                   for shape, proc in procs.items()}
    except subprocess.TimeoutExpired:
        raise SystemExit(f"phase 14d FAILED: the dry run took over {MESH_DRYRUN_TIMEOUT} s")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for shape, (stdout, stderr) in outputs.items():
        if procs[shape].returncode != 0:
            raise SystemExit(f"phase 14d FAILED: {shape}: exit {procs[shape].returncode}: "
                             f"{stdout[-2000:]} {stderr[-2000:]}")
        for line in stdout.splitlines():
            if line.startswith(("PASS", "FAIL", "dry-run")):
                log(f"phase 14d: {line}")
    over = []
    for (shape, name), want in MESH_REFERENCE_FLOPS.items():
        rec = json.loads((out / f"{LM_ARCH}__{shape}__{name}.json").read_text())
        mem = rec["memory"]
        log(f"phase 14d: {shape} {name}: per device (computed on the CPU by torch "
            f"{torch.__version__}, not measured on a card) {rec['flops']:.6g} FLOP of products "
            f"({rec['flops'] / want:.4f} x the reference's {want:.4g}), arguments "
            f"{mem['argument_size_in_bytes']} B, outputs {mem['output_size_in_bytes']} B "
            f"({mem['output_size_in_bytes'] / 2**30:.3f} GiB), temporaries "
            f"{mem['temp_size_in_bytes']} B ({mem['temp_size_in_bytes'] / 2**30:.3f} GiB), "
            f"{rec['bytes_accessed']} B accessed (unfused), collectives "
            f"{json.dumps(rec['collectives'])} B ({rec['collective_bytes']:.6g} B), step run in "
            f"{rec['full_compile_s']} s")
        if rec["flops"] > MESH_FLOPS_REL * want:
            over.append(f"{shape} {name} {rec['flops']:.4g} > {MESH_FLOPS_REL} x {want:.4g}")
    if over:
        raise SystemExit(f"phase 14d FAILED: a device does more than its share: {over}")
    log(f"phase 14d: dry run of {LM_ARCH} {' and '.join(MESH_DRYRUN_SHAPES)} on both meshes "
        f"exit 0 in {wall:.3f} s, every cell's flops within {MESH_FLOPS_REL} x the reference's")


def mesh_path(dev: str, phases: dict) -> None:
    """Phase 14, each part timed into ``phases``; the process group and the
    tracker process it starts are stopped whatever fails."""
    import shutil

    import torch.distributed as dist

    work = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    tracker = step_memory_tracker(work)
    try:
        t0 = time.perf_counter()
        run, measured = mesh_training(dev, work / "store")
        check_step_memory(tracker, work, measured)
        phases["14a Qwen2.5-3B trained on the mesh path"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh_compression(run, dev)
        del run
        phases["14c gradient compression"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh_serving(dev)
        phases["14b Qwen2.5-3B served on the mesh path"] = time.perf_counter() - t0
    finally:
        if tracker.poll() is None:
            tracker.kill()
            tracker.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
    t0 = time.perf_counter()
    production_meshes_raise()
    phases["14c production meshes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_dryrun()
    phases["14d dry-run cells"] = time.perf_counter() - t0


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
        _table_bound, bucket_shape, prepare_batch, rescale_instance, tight_shape,
        traceback_detours,
    )
    from repro_torch.kernels.ltsp_dp.ref import (
        far_fold, init_tables, ltsp_dp_tables_ref, ltsp_dp_tables_tiled_ref, near_update,
        root_values, tile_schedule, traceback_ref,
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

    def tape_arrays(idx, shape=tight_shape):
        # at the shape an uncaptured f64 solve builds at, unless told otherwise
        scaled = rescale_instance(paper[idx])[0]
        R_pad, S_pad = shape(scaled)
        *arrays, S = prepare_batch([scaled], dtype=torch.float64, R_pad=R_pad, S_pad=S_pad,
                                   device=dev)
        return arrays, S

    timing: dict = {}
    for j, (idx, span) in enumerate(((median[0], None),
                                     (median[1], logdp_span(paper[median[1]].n_req, 5.0)))):
        arrays, S = tape_arrays(idx)
        R_pad = arrays[0].shape[1]
        # packed, as the solver's uncaptured builds store them
        kw = dict(S=S, span=span, disjoint=False, cand_tile=ltsp_dp.DEFAULT_CAND_TILE,
                  packed=True)
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
            init_ms = events_ms(lambda: init_tables(arrays[0], arrays[1], arrays[3], S, True),
                                reps=3)
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
            log(f"phase 1b: paper tape {idx} ({R_pad}, {S}) f64 dp: packed tiled build "
                f"{tiled_ms:.3f} ms "
                f"(set-up alone {init_ms:.3f} ms, far launches alone {far_ms:.3f} ms, build - "
                f"set-up - far {near_ms:.3f} ms), bound {b_ms:.3f} ms "
                f"({b_by}); plain: tiled {1e3 * tiled_plain_s:.3f} ms, per-diagonal "
                f"{1e3 * plain_s:.3f} ms")
            log(f"phase 1b: modelled bytes: far fold {far_gb:.3f} GB for {far_c * S} far "
                f"candidates, {far_gb / far_ms:.3f} TB/s over the far launches alone; near fold "
                f"{near_gb:.3f} GB for {near_c * S} near candidates, {near_gb / near_ms:.3f} TB/s "
                f"over build - set-up - far")
        else:
            log(f"phase 1b: paper tape {idx} ({R_pad}, {S}) f64 span={span}: packed, bit-equal")
        del Tk, Ck
    # LogDP(1) on the widest narrow tape: the far fold stages only the starts
    # each block's span leaves live (ltsp_tiled.cu, schedule step 1)
    idx = max((i for i, inst in enumerate(paper) if bucket_shape(inst)[0] <= DENSE_R_MAX),
              key=lambda i: paper[i].n_req)
    arrays, S = tape_arrays(idx)
    R_pad = arrays[0].shape[1]
    span = logdp_span(paper[idx].n_req, 1.0)
    kw = dict(S=S, span=span, disjoint=False, cand_tile=ltsp_dp.DEFAULT_CAND_TILE, packed=True)
    stages = dict(ltsp_dp.FAR_STAGES)
    Tk, Ck = ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw)
    staged, full = (ltsp_dp.FAR_STAGES[k] - stages[k] for k in ("staged", "full"))
    Tp, Cp = ltsp_dp_tables_ref(*arrays, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(Tk, Tp) and torch.equal(Ck, Cp)):
        raise SystemExit(f"phase 1 FAILED: paper tape {idx} LogDP(1) tiled build != plain")
    del Tp, Cp
    n_tiles = -(-R_pad // ltsp_dp.TILE["float64"])
    far_ms = events_ms(lambda: [ltsp_dp.ltsp_far_fold(Tk, Ck, *arrays, D, span=span)
                                for D in range(1, n_tiles)], reps=3)
    del Tk, Ck
    build_ms = events_ms(lambda: ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw), reps=3)
    log(f"phase 1b: widest narrow tape {idx} (n_req {paper[idx].n_req}, ({R_pad}, {S})) f64 "
        f"LogDP(1), span {span}: packed tiled build {build_ms:.3f} ms, far launches alone "
        f"{far_ms:.3f} ms; the far fold staged {staged} of {full} block-stages "
        f"({staged / full:.4f}); bit-equal to the per-diagonal plain version")
    torch.cuda.empty_cache()
    phases["1 kernels vs plain"] = time.perf_counter() - t0
    log(f"phase 1: all bit-equal, max_abs_err {max_err}, {phases['1 kernels vs plain']:.3f} s")

    # ---- phase 1c: the device traceback against the host walk ----------------
    # the kernel walks the packed C the solver's uncaptured builds store; the
    # host walk replays the dense C of the same tape
    t0 = time.perf_counter()
    tb_ms = tb_plain_ms = None
    for n, idx in enumerate(median):
        arrays, S = tape_arrays(idx, bucket_shape)  # MEDIAN_BUCKET, as its bound
        C_dense = ltsp_dp.ltsp_dp_tables(*arrays, device=dev, S=S)[1]  # T freed at once
        host = traceback_detours(C_dense[0].cpu().numpy(), arrays[2][0].cpu().numpy())
        del C_dense
        C = ltsp_dp.ltsp_dp_tables(*arrays, device=dev, S=S, packed=True)[1]
        dets, counts = ltsp_dp.ltsp_traceback(C, arrays[2])
        got = [tuple(d) for d in dets[0, :int(counts[0])].tolist()]
        if got != host:
            raise SystemExit(f"phase 1c FAILED: tape {idx} device traceback != traceback_detours")
        if n == 0:
            check_traceback(C, arrays[2], f"paper tape {idx}")
            tb_ms = events_ms(lambda: ltsp_dp.ltsp_traceback(C, arrays[2]), reps=5)
            # the same walk with L2 flushed before each one (256 MB written)
            flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
            cold = []
            for _ in range(5):
                flush.zero_()
                cold.append(events_ms(lambda: ltsp_dp.ltsp_traceback(C, arrays[2])))
            tb_cold_ms = sorted(cold)[len(cold) // 2]
            del flush
            t1 = sync_now()
            traceback_ref(C, arrays[2])
            tb_plain_ms = 1e3 * (sync_now() - t1)
        del C
    torch.cuda.empty_cache()
    tb_bound, tb_by = traceback_bound_ms(MEDIAN_BUCKET[0], 1)
    load_ns = dependent_load_ns(dev, *MEDIAN_BUCKET)
    tb_latency_ms = (MEDIAN_BUCKET[0] - 1) * load_ns / 1e6
    phases["1c traceback vs host walk"] = time.perf_counter() - t0
    log(f"phase 1c: ltsp_traceback on packed C == traceback_detours on dense C on "
        f"{len(median)} median-bucket tapes; "
        f"at ({MEDIAN_BUCKET[0]}, {MEDIAN_BUCKET[1]}) kernel {tb_ms:.4f} ms (L2 flushed "
        f"first: {tb_cold_ms:.4f} ms), plain walk {tb_plain_ms:.3f} ms, bound "
        f"{tb_bound:.7f} ms ({tb_by}), {phases['1c traceback vs host walk']:.3f} s")
    log(f"phase 1c: dependent load from device memory {load_ns:.1f} ns (one-thread pointer "
        f"chase, {CHASE_STEPS} steps over a {MEDIAN_BUCKET[0]}x{MEDIAN_BUCKET[0]}x"
        f"{MEDIAN_BUCKET[1]} int32 buffer); latency bound of the traceback (R - 1 = "
        f"{MEDIAN_BUCKET[0] - 1} such loads) {tb_latency_ms:.4f} ms: the kernel with L2 "
        f"flushed first runs at {100 * tb_latency_ms / tb_cold_ms:.1f}% of it; the warm "
        f"walk ({tb_ms:.4f} ms, the same walk repeated, its cells in L2) is not comparable "
        f"with a bound of loads from device memory")

    # ---- phase 1d: the card-only tests, under this machine's torch ------------
    phases["1d card-only tests"] = card_only_tests(card)

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
    # T (float64) and C (int32) of a tape at a shape, in GB
    tc_gb = [[12 * R * R * S / 1e9 for R, S in (bucket_shape(paper[i]), tight_shape(paper[i]))]
             for i in huge]
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    log(f"phase 3: left out the {len(huge)} tapes with R_pad > {DENSE_R_MAX}: T and C "
        f"{min(b for b, _ in tc_gb):.0f}-{max(b for b, _ in tc_gb):.0f} GB at the bucket "
        f"shape, {min(t for _, t in tc_gb):.1f}-{max(t for _, t in tc_gb):.1f} GB at the tight "
        f"one, {sum(t < card_gb for _, t in tc_gb)} of them below the card's {card_gb:.1f} GB")

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
        arrays, S = tape_arrays(idx, bucket_shape)
        kw = dict(S=S, span=None, disjoint=False, cand_tile=ltsp_dp.DEFAULT_CAND_TILE,
                  packed=True)
        ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw)
        k_ms = events_ms(lambda: ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw), reps=2)
        T, C = ltsp_dp.ltsp_dp_tables(*arrays, device=dev, **kw)
        t_ms = events_ms(lambda: ltsp_dp.ltsp_traceback(C, arrays[2]), reps=3)
        dets, counts = ltsp_dp.ltsp_traceback(C, arrays[2])
        t1 = sync_now()
        for t in (root_values(T, shape[0]), dets, counts):
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
    log(f"phase 5: dp main path at bucket shapes, packed = {kern_total:.3f} s tiled build + "
        f"{rest_total:.3f} s traceback and copy (per-bucket CUDA events and host clock x "
        f"tapes); phase 3 built at tight shapes in {phases['3 dp main path']:.3f} s wall")

    # ---- phase 6: serving exactness on the card ----------------------------
    t0 = time.perf_counter()
    serving_exactness(dev)
    phases["6 serving exactness"] = time.perf_counter() - t0

    # ---- phase 7: an IN2P3-scale trace served on the card, timed -------------
    t0 = time.perf_counter()
    path_launches = {"3 dp main path": main_launches}
    path_launches["7 IN2P3-scale serving"] = in2p3_serving(paper, u_half, dev)
    phases["7 IN2P3-scale serving"] = time.perf_counter() - t0

    # ---- phase 8: the fleet federation on the card ---------------------------
    t0 = time.perf_counter()
    path_launches["8a fleet exactness"] = fleet_exactness(dev)
    phases["8a fleet exactness"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_launches["8b IN2P3-scale federation, one window"] = in2p3_fleet_serving(
        paper, u_half, dev, spread=False)
    phases["8b IN2P3-scale federation, one window"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_launches["8c IN2P3-scale federation, three windows"] = in2p3_fleet_serving(
        paper, u_half, dev, spread=True)
    phases["8c IN2P3-scale federation, three windows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    examples_on_the_card()
    phases["8d examples on the card"] = time.perf_counter() - t0

    # ---- phase 9: the language model at full width, and its restore ----------
    t0 = time.perf_counter()
    params = lm_serving(dev)
    phases["9a Qwen2.5-3B at full width"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_launches["9b restore plans"] = lm_restore(params, dev)
    del params
    torch.cuda.empty_cache()
    phases["9b restore plans"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm_processes()
    phases["9b/9c launcher and examples"] = time.perf_counter() - t0

    # ---- phase 10: training ---------------------------------------------------
    t0 = time.perf_counter()
    lm_training("10a", TRAIN_FULL, TRAIN_TIMED_FROM, dev)
    phases["10a Qwen2.5-3B trained at full width"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reduced_training(dev)
    phases["10b reduced decoders, cuda vs cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_launches["10c corpus plan"] = training_paths(dev)
    phases["10c example and launcher"] = time.perf_counter() - t0

    # ---- phase 11: the MoE and MLA paths -----------------------------------------
    t0 = time.perf_counter()
    moe_serving(dev)
    phases["11a DeepSeek-V2 at full width (3 layers)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_launches["11b MoE checkpoint restore plans"] = checkpoint_restore(
        "11b", MOE_RESTORE_ARCHS, dev, u_half)
    phases["11b MoE checkpoint restore plans"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reduced_on_the_card("11c", MOE_ARCHS, dev, TRAIN_GRAD_REL)
    phases["11c reduced MoE archs, cuda vs cpu, launchers"] = time.perf_counter() - t0

    # ---- phase 12: the Mamba and xLSTM paths ------------------------------------
    t0 = time.perf_counter()
    recurrent_serving(dev)
    phases["12a/12b Jamba (one period) and xLSTM-1.3B at full width"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_launches["12c recurrent checkpoint restore plans"] = checkpoint_restore(
        "12c", RECURRENT_RESTORE_ARCHS, dev, u_half)
    phases["12c recurrent checkpoint restore plans"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reduced_on_the_card("12d", RECURRENT_ARCHS, dev, RECURRENT_GRAD_REL)
    phases["12d reduced Jamba and xLSTM, cuda vs cpu, launchers"] = time.perf_counter() - t0

    # ---- phase 13: cross-attention and the encoder-decoder path -----------------
    t0 = time.perf_counter()
    cross_serving(dev)
    phases["13a/13b Llama-3.2-Vision (2 periods) and SeamlessM4T at full width"] = \
        time.perf_counter() - t0
    t0 = time.perf_counter()
    path_launches["13c cross-attention checkpoint restore plans"] = checkpoint_restore(
        "13c", CROSS_ARCHS, dev, u_half)
    phases["13c cross-attention checkpoint restore plans"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reduced_on_the_card("13d", CROSS_ARCHS, dev, TRAIN_GRAD_REL)
    phases["13d reduced Llama-3.2-Vision and SeamlessM4T, cuda vs cpu, launchers"] = \
        time.perf_counter() - t0
    t0 = time.perf_counter()
    lm_training("13e", TRAIN_SEAMLESS, TRAIN_SEAMLESS_TIMED_FROM, dev)
    phases["13e SeamlessM4T trained at full width"] = time.perf_counter() - t0

    # ---- phase 14: the mesh path ---------------------------------------------------
    ltsp_dp.reset_launches()
    mesh_path(dev, phases)
    path_launches["14 mesh path"] = dict(ltsp_dp.LAUNCHES)

    # the kernels line counts the launches of every path, each path's counts
    # set to 0 just before it and read just after
    launches = {k: sum(p[k] for p in path_launches.values()) for k in ltsp_dp.LAUNCHES}
    for path, counts in path_launches.items():
        log(f"launches on path {path}: {counts}")

    for name, secs in phases.items():
        log(f"wall {name}: {secs:.3f} s")
    log(f"total wall {time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"kernels": [{
        "name": "ltsp_tiled",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ltsp_dp/csrc/ltsp_tiled.cu",
        "replaces": "src/repro/kernels/ltsp_dp/ltsp_dp.py:101",
        "launches": launches["far_fold_kernel"] + launches["near_fold_kernel"],
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
        "replaces": "src/repro/kernels/ltsp_dp/ops.py:265",
        "launches": launches["traceback_kernel"],
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
