#!/usr/bin/env python3
"""Where one AdamW step of a reduced MoE model on the card moves apart from
the same step on the CPU.

Both MoE architectures, reduced, float32 (the constant leaves moved off
their constants, as ``tests/test_torch_lm_device.py`` builds them), remat
``full`` with the scatter dispatch and ``dots`` with the gather dispatch:
one loss and its gradients on both devices, then one train step on each.
For every parameter element that ends more than ``--atol`` apart it prints
the leaf, the largest difference, how many elements exceed the bound, and
the element's gradient on the CPU and on the card beside the leaf's
largest gradient.  Run on a machine with a CUDA card, from the repo root::

    PYTHONPATH=src python3 tools/moe_step_drift.py
"""

from __future__ import annotations

import argparse
import copy
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed.checkpoint import named_leaves
from repro_torch.training import OptConfig, adamw_init, init_train_state, loss_fn, make_train_step

MOE = ("deepseek-v2-236b", "kimi-k2-1t-a32b")
CASES = (("full", False), ("dots", True))


def cpu_model(arch: str, **overrides):
    cfg = dataclasses.replace(reduced(ARCHS[arch]), compute_dtype="float32", **overrides)
    params, _ = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for p in params.parameters():
            if bool((p == p.flatten()[0]).all()):
                p += torch.from_numpy(rng.normal(0.0, 0.1, tuple(p.shape)).astype(np.float32))
    return cfg, params


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--atol", type=float, default=2e-5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_step_drift: torch sees no CUDA device")
        return 2
    for arch in MOE:
        for remat, gather in CASES:
            cfg, cpu = cpu_model(arch, remat_policy=remat, moe_gather_dispatch=gather)
            card = copy.deepcopy(cpu).to("cuda").requires_grad_(True)
            tokens = torch.from_numpy(np.random.default_rng(11).integers(
                0, cfg.vocab_size, (4, 16)).astype(np.int32))
            grads = {}
            for device, model in (("cpu", cpu), ("cuda", card)):
                total, _ = loss_fn(model, cfg, {"tokens": tokens.to(device)})
                grads[device] = [g.cpu() for g in torch.autograd.grad(
                    total, [p for _, p in named_leaves(model)])]
            oc = OptConfig(warmup_steps=1, total_steps=10)
            for device, model in (("cpu", cpu), ("cuda", card)):
                make_train_step(cfg, oc)(model, adamw_init(model), {"tokens": tokens.to(device)})
            moved = 0
            for i, ((name, a), (_, b)) in enumerate(zip(named_leaves(card), named_leaves(cpu))):
                diff = (a.detach().cpu() - b.detach()).abs()
                if float(diff.max()) <= args.atol:
                    continue
                moved += 1
                j = int(diff.argmax())
                print(f"{arch} remat {remat} gather {gather}: {name} {tuple(a.shape)}: max |dp| "
                      f"{float(diff.max()):.3e}, {int((diff > args.atol).sum())} elements over "
                      f"{args.atol}; there the gradient is {float(grads['cpu'][i].flatten()[j]):.3e}"
                      f" on the CPU and {float(grads['cuda'][i].flatten()[j]):.3e} on the card, "
                      f"the leaf's largest {float(grads['cpu'][i].abs().max()):.3e}")
            print(f"{arch} remat {remat} gather {gather}: {moved} leaves over {args.atol}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
