"""Training launcher of the port: one device, periodic hot-tier checkpoints,
straggler telemetry and ``--resume``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
      --reduced --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 5

The reference launcher's flags, defaults, token stream (numpy ``zipf(1.2)``
from ``default_rng(0)``, drawn anew from the first step run, also after a
resume) and printed lines; ``--set k=v`` forwards any ``ModelConfig``
override (``remat_policy``, ``microbatches``, ``logits_bf16_ce``, ...).  It
trains on the card (``--device cuda``, the default; without a card it
raises, and nothing falls back) or where ``--device`` says.  One device
trains: ``--mesh pod|multipod`` needs the sharding slice of the port
(ROADMAP A9.6) and exits 2.  Every architecture trains: the MoE ones with
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
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from ..configs import ARCHS, reduced
from ..distributed.checkpoint import load_checkpoint, save_checkpoint
from ..distributed.fault_tolerance import StragglerMonitor, should_checkpoint
from ..models.model import check_device
from ..training.optimizer import OptConfig
from ..training.train_step import init_train_state, make_train_step
from .cli import parse_overrides

MESH_MESSAGE = (
    "--mesh {mesh} shards the model over many devices, which needs the sharding "
    "slice of the port (ROADMAP item A9.6); --mesh auto trains on one device"
)


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
                    help="device mesh: 'auto' is one device (the multi-device meshes "
                         "are refused: ROADMAP item A9.6)")
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
    device = torch.device(args.device)
    check_device(device)
    print(f"mesh: {{'data': 1, 'model': 1}}  arch: {cfg.arch_id}")

    params, opt_state = init_train_state(torch.Generator(device).manual_seed(0), cfg,
                                         device=device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"params: {n_params/1e6:.1f}M")

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
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        history.append({"loss": loss, "grad_norm": float(metrics["grad_norm"]),
                        "lr": float(metrics["lr"]), "seconds": dt})
        monitor.record("self", i, dt)
        if should_checkpoint(i + 1, args.ckpt_every, monitor.stragglers()):
            save_checkpoint(ckpt, i + 1, params=params, opt_state=opt_state)
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            print(f"step {i+1:>5d} loss={loss:.4f} "
                  f"lr={history[-1]['lr']:.2e} "
                  f"gnorm={history[-1]['grad_norm']:.2f}")
    print("done")
    return {"cfg": cfg, "params": params, "opt_state": opt_state, "start": start,
            "history": history}


def main(argv=None) -> int:
    """Run the launcher on ``argv`` (default: the command line); returns the
    exit status."""
    args = build_parser().parse_args(argv)
    if args.mesh != "auto":
        print(MESH_MESSAGE.format(mesh=args.mesh), file=sys.stderr)
        return 2
    train(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
