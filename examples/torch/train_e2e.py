"""End-to-end training example: data pipeline from the tape tier, training
loop with checkpoint/restart, straggler monitoring, and a simulated
preemption mid-run.

The corpus lives as shards on the simulated tape library; each epoch's shard
fetch order is scheduled with the paper's SimpleDP (low-cost near-optimal),
so time-to-first-batch is minimised — the paper's contribution wired into the
training data path.  The plan runs on ``--backend`` (the CUDA kernels on the
card by default; ``torch`` their plain version, ``python`` the exact host
DP) in exact float64 tables, and the model trains on ``--device``.  Nothing
falls back: without a card the default run raises.

Defaults train a reduced granite-8b for 120 steps; ``--arch``/``--steps``
scale it up (--preset 100m gives the ~100M-parameter configuration).

Run: PYTHONPATH=src python examples/torch/train_e2e.py --steps 120
     [--backend cuda|torch|python] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core import ExecutionContext
from repro_torch.core.solver import BACKENDS
from repro_torch.distributed.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.distributed.fault_tolerance import StragglerMonitor, should_checkpoint
from repro_torch.models.model import check_device
from repro_torch.storage.tape import TapeLibrary
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_step import init_train_state, make_train_step


def build_corpus_on_tape(n_shards: int, shard_tokens: int, vocab: int, seed: int = 0,
                         context: ExecutionContext | None = None):
    """Synthesise a token corpus and archive it as shards on tape."""
    rng = np.random.default_rng(seed)
    lib = TapeLibrary(capacity_per_tape=10**10, u_turn=5_000_000, context=context)
    shards = {}
    for i in range(n_shards):
        name = f"corpus/shard{i:03d}"
        # Zipf unigrams: a learnable marginal so the loss visibly decreases
        data = np.minimum(rng.zipf(1.2, size=shard_tokens), vocab - 1).astype(np.int32)
        shards[name] = data
        lib.store(name, int(data.nbytes))
    return lib, shards


def scheduled_shard_stream(lib, shards, policy="simpledp"):
    """Yield shards in LTSP-scheduled order (per tape), minimising the mean
    arrival time of training data; the plan runs on the library's context."""
    requests = {name: 1 for name in shards}
    for plan in lib.schedule(requests, policy=policy):
        for name in plan.order:
            yield name, shards[name], plan.service_time[name]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--preempt-at", type=int, default=None,
                    help="simulate a preemption at this step (default: midway)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--backend", default="cuda", choices=list(BACKENDS),
                    help="solver backend of the shard plan")
    ap.add_argument("--device", default="cuda", help="torch device of the model and the plan")
    args = ap.parse_args()

    device = torch.device(args.device)
    check_device(device)
    cfg = reduced(ARCHS[args.arch], periods=2)
    if args.preset == "100m":
        cfg = dataclasses.replace(
            cfg, d_model=768, num_heads=12, num_kv_heads=4, d_ff=2048,
            num_layers=cfg.first_k_dense + 12 * len(cfg.block_pattern),
            vocab_size=32768,
        )
    cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 32768))
    preempt_at = args.preempt_at or args.steps // 2

    # --- corpus on tape, fetch order scheduled by the paper's algorithm ----
    lib, shards = build_corpus_on_tape(
        n_shards=12, shard_tokens=args.batch * args.seq * 16, vocab=cfg.vocab_size,
        context=ExecutionContext(backend=args.backend, device=args.device,
                                 numeric_policy="f64"),
    )
    stream = list(scheduled_shard_stream(lib, shards))
    print(f"corpus: {len(stream)} shards; first shard ready at simulated "
          f"t={stream[0][2]:,} (LTSP-scheduled)")

    tokens_pool = np.concatenate([d for _, d, _ in stream])
    n_batches = len(tokens_pool) // (args.batch * args.seq)
    batches = torch.from_numpy(tokens_pool[: n_batches * args.batch * args.seq].reshape(
        n_batches, args.batch, args.seq
    )).to(device)

    params, opt = init_train_state(torch.Generator(device).manual_seed(0), cfg, device=device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.arch_id} (reduced) params={n_params/1e6:.1f}M steps={args.steps}")

    step_fn = make_train_step(cfg, OptConfig(
        learning_rate=3e-4, warmup_steps=20, total_steps=args.steps))
    monitor = StragglerMonitor()
    ckpt = pathlib.Path(args.ckpt_dir)

    def batch_at(i):
        return {"tokens": batches[i % n_batches]}

    i = 0
    preempted = False
    losses = []
    while i < args.steps:
        t0 = time.time()
        params, opt, m = step_fn(params, opt, batch_at(i))
        losses.append(float(m["loss"]))
        dt = time.time() - t0
        monitor.record("worker0", i, dt)
        i += 1
        if should_checkpoint(i, every=25, alarms=monitor.stragglers()):
            save_checkpoint(ckpt, i, params=params, opt_state=opt)
        if i == preempt_at and not preempted:
            preempted = True
            print(f"step {i}: simulating preemption — dropping live state")
            save_checkpoint(ckpt, i, params=params, opt_state=opt)
            del params, opt
            # restore through the public API (templates from a fresh init)
            p0, o0 = init_train_state(torch.Generator(device).manual_seed(0), cfg,
                                      device=device)
            step_no, trees = load_checkpoint(ckpt, params=p0, opt_state=o0)
            params, opt = trees["params"], trees["opt_state"]
            assert step_no == i
            print(f"step {i}: restored from checkpoint, continuing")
        if i % 20 == 0 or i == args.steps:
            print(f"step {i:>4d} loss={losses[-1]:.4f} lr={float(m['lr']):.2e} "
                  f"{dt*1000:.0f} ms/step")

    print(f"\nfinal loss {losses[-1]:.4f} (started {losses[0]:.4f}); "
          f"loss decreased: {losses[-1] < losses[0]}")


if __name__ == "__main__":
    main()
