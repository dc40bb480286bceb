"""Training launcher of the port: one device or a mesh of them, periodic
hot-tier checkpoints, straggler telemetry and ``--resume``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
      --reduced --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 5

The reference launcher's flags, defaults, token stream (numpy ``zipf(1.2)``
from ``default_rng(0)``, drawn anew from the first step run, also after a
resume) and printed lines; ``--set k=v`` forwards any ``ModelConfig``
override (``remat_policy``, ``microbatches``, ``logits_bf16_ce``, ...).  It
trains on the card (``--device cuda``, the default; without a card it
raises, and nothing falls back) or where ``--device`` says.  Every
architecture trains: the MoE ones with
their aux loss weighed in, the recurrent ones (Jamba, xLSTM), and the two
with cross-attention, whose batches carry zero frontend embeddings as the
reference's do (Seamless's ``enc_embeds`` through its encoder,
Llama-3.2-Vision's ``vision_embeds``).  On zero frames every encoder layer
sees zero rows, where ``rms_norm``'s gradient is ``1/sqrt(eps)`` times its
input's: Seamless's 24 encoder layers overflow its gradients to NaN in the
first step, the reference's too.  ``--frontend-seed N``, the port's own
flag, draws the embeddings from a normal distribution instead (a generator
seeded ``N`` on the device).  xLSTM's parallel mLSTM gives NaN gradients
from about 128 tokens on, as the reference's does.
A step's time, fed to the straggler monitor, runs until its loss is read
on the host, so it is the step's time on the device.

The mesh path.  When a process group is up (under ``torchrun``, which this
launcher then joins with NCCL on ``cuda`` and gloo on ``cpu``, or one the
caller started) the launcher trains on a
:class:`~torch.distributed.device_mesh.DeviceMesh` at any world size, one
included: :func:`_auto_mesh` builds the reference's mesh over the group's
ranks, the parameters and AdamW moments are ``DTensor`` s placed by
``param_pspecs``, each batch by ``batch_pspecs``, and the steps run with the
mesh active (``mesh_scope``); the mesh line prints its axes, a checkpoint
is written gathered by rank 0.  Without a process group ``--mesh auto`` is
the one-device path (``mesh: {'data': 1, 'model': 1}``), and ``--mesh
pod|multipod`` raises the reference's ``RuntimeError`` (``need 256
devices ...``), as it does with too few ranks::

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced --device cpu --steps 3
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

from ..configs import ARCHS, reduced
from ..distributed.checkpoint import load_checkpoint, save_checkpoint
from ..distributed.context import is_sharded, mesh_scope
from ..distributed.fault_tolerance import StragglerMonitor, should_checkpoint
from ..distributed.sharding import batch_pspecs, param_pspecs, place_tree
from ..models.model import check_device, init_model
from ..training.optimizer import OptConfig, adamw_init
from ..training.train_step import make_train_step
from .cli import parse_overrides
from .mesh import make_production_mesh


def start_process_group(device) -> bool:
    """Join the process group ``torchrun`` describes in the environment
    (NCCL on ``cuda``, gloo on ``cpu``) unless one is up already; whether this
    call started it.  Without one up and outside ``torchrun``, nothing."""
    import torch.distributed as dist

    if dist.is_initialized() or "TORCHELASTIC_RUN_ID" not in os.environ:
        return False
    dist.init_process_group("nccl" if torch.device(device).type == "cuda" else "gloo")
    return True


def group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def rank_device(device) -> torch.device:
    """This rank's device: on the mesh path a ``cuda`` rank takes the card
    of its local rank (``LOCAL_RANK``, else its rank modulo the cards)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not group_up():
        return device
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def _auto_mesh(kind: str, device_type: str | None = None):
    """The reference's mesh rule over the process group's ranks:
    ``pod``/``multipod`` the production mesh (which raises with too few
    ranks), ``auto`` the largest ``(data, model)`` grid, ``model`` the
    largest power of two up to 8 that divides the world."""
    if kind in ("pod", "multipod"):
        return make_production_mesh(multi_pod=kind == "multipod", device_type=device_type)
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    model = 1
    while model * 2 <= min(8, n) and n % (model * 2) == 0:
        model *= 2
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))


def host_float(x) -> float:
    """A 0-d tensor as a Python float; a ``DTensor`` gathered first (a
    collective)."""
    return float(x.full_tensor() if is_sharded(x) else x)


def build_parser() -> argparse.ArgumentParser:
    """The reference launcher's flags, plus ``--device`` and ``--frontend-seed``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-8b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true", help="CPU-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="auto", choices=["auto", "pod", "multipod"],
                    help="device mesh: 'auto' the largest (data, model) grid over the "
                         "process group's ranks (one device without a group); 'pod' "
                         "16x16, 'multipod' 2x16x16")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_launch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--set", nargs="*", default=None, metavar="K=V")
    ap.add_argument("--device", default="cuda", help="torch device of the model")
    ap.add_argument("--frontend-seed", type=int, default=None,
                    help="draw the frontend embeddings of a cross-attention architecture "
                         "from a normal distribution seeded so, not the reference's zeros")
    return ap


def make_config(args):
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg, periods=2)
        cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 32768))
    overrides = parse_overrides(args.set or [])
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def train_batch(cfg, tokens: np.ndarray, device,
                gen: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """A batch of ``tokens`` ``[B, L]`` on ``device``; a cross-attention
    architecture's also carries frontend embeddings in the compute dtype:
    Seamless's ``enc_embeds`` ``[B, num_enc_frames, D]``, Llama-3.2-Vision's
    ``vision_embeds`` ``[B, num_vision_tokens, D]``.  They are zeros, as the
    reference launcher's, or drawn from ``gen`` (a generator on
    ``device``)."""
    B = tokens.shape[0]
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device)}
    for name, rows in (("enc_embeds", cfg.enc_layers and cfg.num_enc_frames),
                       ("vision_embeds", cfg.num_vision_tokens)):
        if not rows:
            continue
        shape = (B, rows, cfg.d_model)
        batch[name] = (torch.zeros(shape, dtype=cfg.cdtype, device=device) if gen is None else
                       torch.randn(shape, generator=gen, device=device).to(cfg.cdtype))
    return batch


def train(args) -> dict:
    """The training loop on ``args`` -> the config, the trained parameters and
    optimizer state, the step it started from and each step's record
    (``loss``, ``grad_norm``, ``lr``, ``seconds``)."""
    cfg = make_config(args)
    mesh = _auto_mesh(args.mesh) if group_up() or args.mesh != "auto" else None
    check_device(args.device)
    device = rank_device(args.device)
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None else \
        {"data": 1, "model": 1}
    print(f"mesh: {axes}  arch: {cfg.arch_id}")

    params = init_model(torch.Generator(device).manual_seed(0), cfg, device=device)
    params.requires_grad_(True)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"params: {n_params/1e6:.1f}M")
    if mesh is not None:
        place_tree(params, param_pspecs(params), mesh)
    opt_state = adamw_init(params)

    step_fn = make_train_step(cfg, OptConfig(learning_rate=args.lr, warmup_steps=20,
                                             total_steps=args.steps))

    start = 0
    ckpt = pathlib.Path(args.ckpt_dir)
    if args.resume and (ckpt / "manifest.json").exists():
        start, trees = load_checkpoint(ckpt, params=params, opt_state=opt_state)
        params, opt_state = trees["params"], trees["opt_state"]
        print(f"resumed from step {start}")

    rng = np.random.default_rng(0)
    frontend = (None if args.frontend_seed is None
                else torch.Generator(device).manual_seed(args.frontend_seed))
    monitor = StragglerMonitor()
    history = []
    for i in range(start, args.steps):
        tokens = np.minimum(rng.zipf(1.2, size=(args.batch, args.seq)), cfg.vocab_size - 1)
        batch = train_batch(cfg, tokens, device, frontend)
        if mesh is not None:
            batch = place_tree(batch, batch_pspecs(batch, mesh), mesh)
        t0 = time.perf_counter()
        with mesh_scope(mesh):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = host_float(metrics["loss"])
        dt = time.perf_counter() - t0
        history.append({"loss": loss, "grad_norm": host_float(metrics["grad_norm"]),
                        "lr": host_float(metrics["lr"]), "seconds": dt})
        monitor.record("self", i, dt)
        if should_checkpoint(i + 1, args.ckpt_every, monitor.stragglers()):
            save_checkpoint(ckpt, i + 1, params=params, opt_state=opt_state)
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            print(f"step {i+1:>5d} loss={loss:.4f} "
                  f"lr={history[-1]['lr']:.2e} "
                  f"gnorm={history[-1]['grad_norm']:.2f}")
    print("done")
    return {"cfg": cfg, "params": params, "opt_state": opt_state, "start": start,
            "history": history, "mesh": mesh}


def main(argv=None) -> int:
    """Run the launcher on ``argv`` (default: the command line); returns the
    exit status."""
    args = build_parser().parse_args(argv)
    started = start_process_group(args.device)
    try:
        train(args)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
