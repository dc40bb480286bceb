#!/usr/bin/env python3
"""A/B of a bf16 decode step on the card between two source trees.

Each tree's ``repro_torch`` serves one architecture at full width with the
schedule of ``chip_smoke.py``'s LM phases (batch 8, 127 teacher-forced
prefill steps, 64 greedy steps timed on the host clock, then 4 steps under
``torch.profiler``), each run in its own process, in the order A, B, B, A,
so that the two trees share one machine and its drift.  Each run prints ms
a step, the profiled wall and kernel time a step, the aten operators a step
and the first greedy tokens (equal trees give equal tokens).

Run from the repo root on a machine with a card; ``TREE`` is a directory
holding ``src/repro_torch`` (for instance a ``git archive`` of the parent
unpacked under ``build/``)::

    python3 tools/serving_step_ab.py --arch xlstm-1.3b build/parent .
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

BATCH, PROMPT, NEW = 8, 128, 64


def one(arch: str, label: str) -> None:
    """One serving run of ``arch`` from the ``repro_torch`` on the path."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.models.model import init_cache, init_model
    from repro_torch.serving.serve import make_serve_step

    cfg = ARCHS[arch]
    params = init_model(torch.Generator("cuda").manual_seed(0), cfg, device="cuda")
    serve = make_serve_step(cfg)
    cache = init_cache(cfg, BATCH, PROMPT + NEW + 4, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))
    for t in range(PROMPT - 1):
        _, _, cache = serve(params, cache, prompts[:, t : t + 1], t)
    torch.cuda.synchronize()
    tok, outs = prompts[:, -1:], []
    t0 = time.perf_counter()
    for t in range(NEW):
        tok, _, cache = serve(params, cache, tok, PROMPT - 1 + t)
        outs.append(tok)
    out = torch.cat(outs, 1).cpu()
    step_ms = 1e3 * (time.perf_counter() - t0) / NEW
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            tok, _, cache = serve(params, cache, tok, PROMPT + NEW - 1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 4
    events = prof.key_averages()
    kernel_ms = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                    for e in events if e.device_type == DeviceType.CUDA) / 4e3
    ops = sum(e.count for e in events if e.key.startswith("aten::")) / 4
    print(f"{label}: {arch} bf16 batch {BATCH}: {step_ms:.3f} ms a step; profiled "
          f"{wall_ms:.3f} ms wall, {kernel_ms:.3f} ms of kernel time, {ops:.0f} aten operators "
          f"a step; first tokens {out[0, :8].tolist()}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="*", type=Path)
    args = ap.parse_args(argv)
    if args.one:
        one(args.arch, args.one)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees, A and B")
    a, b = args.trees
    for label, tree in (("A", a), ("B", b), ("B", b), ("A", a)):
        env = dict(os.environ, PYTHONPATH=str(tree.resolve() / "src"))
        rc = subprocess.call([sys.executable, __file__, "--arch", args.arch, "--one",
                              f"{label} {tree}"], env=env)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
