"""Multi-pod checkpoint restore from the tape archive, scheduled by the
paper's DP — the framework feature the paper becomes.

A 2-pod cluster restores a sharded checkpoint (reduced DeepSeek-V2: MLA +
MoE) from the tape tier.  Every shard is requested once per consumer pod
(plus extra consumers for the embedding and router shards every host needs
early).  The LTSP schedulers order the reads; mean shard arrival time
directly bounds how soon pods can begin resharding/loading.

The plan reads only the shards' sizes, so the checkpoint is initialised on
the ``meta`` device (shapes without storage).  ``dp`` and ``simpledp`` plan
every cartridge on ``--backend`` (the CUDA kernels on the card by default;
``torch`` their plain version, ``python`` the exact host DP), in exact
float64 tables where the byte-scale positions pass the int32 guard, with no
fallback; the heuristic policies have no device backend and run on
``python``, as the last column says.

Run: PYTHONPATH=src python examples/torch/tape_restore.py
     [--backend cuda|torch|python] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core import ExecutionContext
from repro_torch.core.solver import BACKENDS
from repro_torch.distributed.checkpoint import archive_to_tape, plan_restore
from repro_torch.models.model import init_model
from repro_torch.storage.tape import TapeLibrary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cuda", choices=list(BACKENDS),
                    help="solver backend of the DP policies")
    ap.add_argument("--device", default="cuda", help="torch device of that backend")
    args = ap.parse_args()
    cfg = reduced(ARCHS["deepseek-v2-236b"], periods=2)
    params = init_model(torch.Generator().manual_seed(0), cfg, device="meta")

    lib = TapeLibrary(capacity_per_tape=4 * 10**9, u_turn=20_000_000)
    shards = archive_to_tape(lib, "step5000", params, bytes_per_elem=4096)
    print(f"archived {len(shards)} shards on {len(lib.tapes)} tape(s)")

    consumers = {s: 2 for s in shards}  # both pods need every shard
    for s in shards:
        if "embed" in s or "router" in s:
            consumers[s] = 8  # hot shards: every host group wants them early

    print(f"\n{'policy':<10} {'mean arrival':>14} {'last arrival':>14} {'vs dp':>7}  (backend)")
    results = {}
    for policy in ("nodetour", "gs", "fgs", "simpledp", "dp"):
        if policy in ("dp", "simpledp"):
            ctx = ExecutionContext(backend=args.backend, device=args.device, numeric_policy="f64")
        else:
            ctx = ExecutionContext(backend="python")
        plans = plan_restore(lib, shards, consumers, policy=policy, context=ctx)
        n_req = sum(consumers.values())
        mean = sum(p.total_cost for p in plans) / n_req
        last = max(max(p.service_time.values()) for p in plans)
        results[policy] = (mean, last)
        vs = f"{mean / results['dp'][0]:>6.3f}x" if "dp" in results else " " * 7
        print(f"{policy:<10} {mean:>14.3g} {last:>14.3g} {vs}  ({ctx.backend})")

    dp_mean = results["dp"][0]
    nd_mean = results["nodetour"][0]
    print(f"\nDP-scheduled restore improves mean shard arrival by "
          f"{100 * (1 - dp_mean / nd_mean):.1f}% over the positional sweep.")


if __name__ == "__main__":
    main()
