#!/usr/bin/env python3
"""Where the mesh path's gradients leave the one-device port's.

Four gloo ranks on the CPU lay a ``(data 2, model 2)`` mesh over
themselves, as ``tests/torch_mesh_worker.py`` does, and take the gradient of
one loss of a reduced architecture in float32 on the mesh and on one device
from the same parameters and batch.  Rank 0 prints the torch version, both
losses, the leaves with the largest relative difference (the largest
absolute difference over the leaf's largest element) beside the mesh
gradient's placements, and how many leaves differ by more than 1e-4.  It
imports no JAX, so it runs on the card's machine too, whose torch release
differs from this one's.

Run from the repo root::

    PYTHONPATH=src python3 tools/mesh_grad_check.py OUT [ARCH]

``OUT`` is a directory for the process group's ``FileStore``; ``ARCH``
defaults to ``deepseek-v2-236b``.
"""

import dataclasses
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 4
BATCH, SEQ = 4, 16
SHOWN = 12


def gradients(params, cfg, batch, mesh):
    from repro_torch.distributed.checkpoint import named_leaves
    from repro_torch.distributed.context import mesh_scope
    from repro_torch.training import loss_fn

    with mesh_scope(mesh):
        total, _ = loss_fn(params, cfg, batch)
        leaves = [p for _, p in named_leaves(params)]
        return total, torch.autograd.grad(total, leaves, materialize_grads=True)


def child(rank: int, out: str, arch: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(out) / "store"), WORLD),
                            rank=rank, world_size=WORLD)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.configs import ARCHS, reduced
        from repro_torch.distributed.checkpoint import named_leaves
        from repro_torch.distributed.sharding import batch_pspecs, param_pspecs, place_tree
        from repro_torch.launch.train import host_float, train_batch
        from repro_torch.models.model import init_model

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(reduced(ARCHS[arch]), compute_dtype="float32")
        tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, SEQ))
        batch = train_batch(cfg, tokens, "cpu")

        def fresh():
            return init_model(torch.Generator().manual_seed(0), cfg,
                              device="cpu").requires_grad_(True)

        plain = fresh()
        want_loss, want = gradients(plain, cfg, batch, None)
        sharded = place_tree(fresh(), param_pspecs(plain), mesh)
        got_loss, got = gradients(sharded, cfg, place_tree(batch, batch_pspecs(batch, mesh), mesh),
                                  mesh)
        mesh_loss = host_float(got_loss)  # a collective: on every rank
        rows = []
        for (name, _), g, w in zip(named_leaves(plain), got, want):
            full = g.full_tensor() if hasattr(g, "full_tensor") else g
            top = float(w.abs().max())
            rows.append((float((full - w).abs().max()) / (top + 1e-30), name,
                         str(getattr(g, "placements", "plain"))))
        if rank == 0:
            rows.sort(reverse=True)
            print(f"torch {torch.__version__} {arch}: loss {mesh_loss} on the mesh, "
                  f"{float(want_loss)} on one device")
            for rel, name, placements in rows[:SHOWN]:
                print(f"  {rel:.3e} {name} {placements}")
            print(f"leaves over 1e-4 relative: {sum(r[0] > 1e-4 for r in rows)} of {len(rows)}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    out = sys.argv[1]
    os.makedirs(out, exist_ok=True)
    os.environ["OMP_NUM_THREADS"] = "1"
    mp.spawn(child, args=(out, sys.argv[2] if len(sys.argv) > 2 else "deepseek-v2-236b"),
             nprocs=WORLD)
