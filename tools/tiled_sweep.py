#!/usr/bin/env python3
"""Time the tiled table build of ``csrc/ltsp_tiled.cu`` at other values of
its three build constants, on one NVIDIA card.

The constants are the tile size (``Tile<V>::value``), the cp.async stages in
flight (``kStages``) and the detour starts per stage (``kStageC``).  Each
variant is a copy of the source with those three lines changed, compiled by
``nvcc`` with the port's own flags into ``build/kernels/sweep/`` (all at
once) and loaded with ``ctypes``.  On the float64 tables of one paper tape
per bucket (the median bucket (256, 8192) among them), every variant must
give the committed build's tables bit for bit; then each is timed with CUDA
events, in rounds whose order alternates (forward, backward, ...), and the
median of the rounds is printed beside every reading.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python3 tools/tiled_sweep.py [--reps 5]

It prints the card's name and power limit first and exits non-zero without a
card or on any mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: (tile, stages, starts per stage); the first is the committed build.
VARIANTS = ((8, 2, 8), (8, 2, 4), (8, 2, 16), (8, 3, 8), (12, 2, 8), (12, 3, 8), (16, 2, 8))
BUCKETS = ((128, 4096), (256, 8192), (256, 16384))

_CONSTANTS = (
    (r"(static constexpr int value = )\d+;", 0),
    (r"(constexpr int kStages = )\d+;", 1),
    (r"(constexpr int kStageC = )\d+;", 2),
)


def variant_source(text: str, variant: tuple[int, int, int]) -> str:
    for pattern, slot in _CONSTANTS:
        text, n = re.subn(pattern, rf"\g<1>{variant[slot]};", text)
        if n != 1:
            raise SystemExit(f"tiled_sweep: {pattern!r} matched {n} lines of ltsp_tiled.cu")
    return text


def build_variants(variants) -> dict[tuple[int, int, int], ctypes.CDLL]:
    """Compile every variant, one ``nvcc`` each, all started together."""
    from repro_torch.kernels.ltsp_dp import build

    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "ltsp_tiled.cu").read_text()
    procs = {}
    for v in variants:
        src = out_dir / "ltsp_tiled_t{}_s{}_c{}.cu".format(*v)
        src.write_text(variant_source(text, v))
        lib = src.with_suffix(".so")
        procs[v] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for v, (path, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"tiled_sweep: nvcc failed on variant {v}:\n{out}\n{err}")
        lib = ctypes.CDLL(str(path))
        fn = lib.ltsp_tiled_tables_f64
        fn.argtypes, fn.restype = build.SOURCES["ltsp_tiled"]["ltsp_tiled_tables_f64"]
        if lib.ltsp_tile_size_f64() != v[0]:
            raise SystemExit(f"tiled_sweep: variant {v} reports tile {lib.ltsp_tile_size_f64()}")
        libs[v] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=5, help="timed rounds per bucket")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("tiled_sweep: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data import PAPER_PROFILE, generate_dataset, u_turn_values
    from repro_torch.kernels.ltsp_dp import ltsp_dp
    from repro_torch.kernels.ltsp_dp.ops import bucket_shape, prepare_batch, rescale_instance
    from repro_torch.kernels.ltsp_dp.ref import init_tables

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    libs = build_variants(VARIANTS)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.3f} s", flush=True)

    paper = generate_dataset(PAPER_PROFILE,
                             u_turn=u_turn_values(generate_dataset(PAPER_PROFILE))["half_seg"])
    results = []
    for shape in BUCKETS:
        idx = next(i for i, inst in enumerate(paper) if bucket_shape(inst) == shape)
        scaled = rescale_instance(paper[idx])[0]
        *arrays, S = prepare_batch([scaled], dtype=torch.float64, R_pad=shape[0],
                                   S_pad=shape[1], device="cuda")
        T_ref, C_ref = ltsp_dp.ltsp_dp_tables(*arrays, S=S)
        stream = torch.cuda.current_stream().cuda_stream
        n_far, n_near = ctypes.c_int(0), ctypes.c_int(0)
        n_stages, n_stages_full = ctypes.c_longlong(0), ctypes.c_longlong(0)

        def run(v, T, C):
            err = libs[v].ltsp_tiled_tables_f64(
                *(t.data_ptr() for t in (T, C, *arrays)), 1, shape[0], S, -1, 0,
                int(shape[0] - 1 <= ltsp_dp.DEFAULT_CAND_TILE), 0, ctypes.byref(n_far),
                ctypes.byref(n_near), ctypes.byref(n_stages), ctypes.byref(n_stages_full),
                stream)
            if err != 0:
                raise SystemExit(f"tiled_sweep: variant {v} launch failed: cudaError {err}")

        for v in VARIANTS:
            T, C = init_tables(arrays[0], arrays[1], arrays[3], S)
            run(v, T, C)
            torch.cuda.synchronize()
            if not (torch.equal(T, T_ref) and torch.equal(C, C_ref)):
                raise SystemExit(f"tiled_sweep: variant {v} != the committed build at {shape}")
        readings = {v: [] for v in VARIANTS}
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for r in range(args.reps):
            # a finished table rebuilds with the same work: every launch
            # rewrites its cells before any later launch reads them
            for v in (VARIANTS if r % 2 == 0 else VARIANTS[::-1]):
                start.record()
                run(v, T, C)
                stop.record()
                stop.synchronize()
                readings[v].append(start.elapsed_time(stop))
        for v in VARIANTS:
            row = {"R": shape[0], "S": S, "tape": idx, "tile": v[0], "stages": v[1],
                   "starts_per_stage": v[2], "ms_median": statistics.median(readings[v]),
                   "ms": readings[v]}
            results.append(row)
            print(f"({shape[0]}, {S}) tile {v[0]} stages {v[1]} starts/stage {v[2]}: median "
                  f"{row['ms_median']:.3f} ms of {['%.3f' % x for x in readings[v]]}", flush=True)
        del T, C, T_ref, C_ref
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "sweep": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
