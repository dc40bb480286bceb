"""AdamW with global-norm clipping and warmup+cosine schedule.

The port's copy of the JAX package's ``training/optimizer.py``.  The state
mirrors the parameter tree: ``m`` and ``v`` are nested dicts of float32
tensors under the parameters' names (a module as the dict of its parameters
and children, an ``nn.ModuleList`` as a list), so the hot tier writes them
under the reference's file names.  ``step`` is an int32 0-d tensor, so its
``step.npy`` is the reference's byte for byte.

The schedule, the clip scale and the bias corrections are float32 tensors on
the parameters' device, as the reference's weakly typed scalars compute in
float32.  One difference, for memory: :func:`adamw_update` updates ``p``,
``m`` and ``v`` in place, leaf by leaf, where the reference builds new trees.
At Qwen2.5-3B's full width old and new trees together would need 34.5 GiB
more than the 46 GiB of parameters, gradients and moments; in place each
leaf's update holds a few transients of that leaf's size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..distributed.checkpoint import _as_container, named_leaves


@dataclasses.dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% of peak (float32)."""
    step = step.to(torch.float32)
    warm = step / max(1, cfg.warmup_steps)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0, 1
    )
    cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * torch.minimum(warm, cos)


def _map(fn, tree):
    """``tree``'s containers as plain dicts and lists with ``fn`` at each leaf."""
    tree = _as_container(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def adamw_init(params) -> dict[str, Any]:
    def zeros(p):  # laid out as p: a DTensor parameter's moments are DTensors
        return torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)

    step = torch.zeros((), dtype=torch.int32, device=next(iter(named_leaves(params)))[1].device)
    return {"m": _map(zeros, params), "v": _map(zeros, params), "step": step}


def global_norm(tree) -> torch.Tensor:
    """Square root of the sum, in pytree order, of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(leaf.to(torch.float32) ** 2) for _, leaf in named_leaves(tree)))


@torch.no_grad()
@torch.profiler.record_function("adamw_update")
def adamw_update(cfg: OptConfig, grads, state, params):
    """One AdamW step in place -> ``(params, state, metrics)``, the objects given.

    ``grads`` (a tree, or a list in the parameters' pytree order),
    ``state["m"]``, ``state["v"]`` and ``params`` are trees whose leaves
    pair up in pytree order.  Each leaf's arithmetic is the reference's,
    operation for operation and in its order; a float32 gradient is scaled
    in place.  Under ``torch.profiler`` the update is one range,
    ``adamw_update``.
    """
    step = state["step"]
    step += 1
    gnorm = global_norm(grads)
    clip = torch.tensor(cfg.clip_norm, dtype=torch.float32, device=gnorm.device)
    scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    leaves = zip(named_leaves(params), named_leaves(grads), named_leaves(state["m"]),
                 named_leaves(state["v"]))
    for (_, p), (_, g), (_, m), (_, v) in leaves:
        g = g.mul_(scale) if g.dtype == torch.float32 else g.to(torch.float32) * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.mul(1 - b2).mul_(g))
        del g
        delta = m / bc1
        denom = (v / bc2).sqrt_().add_(cfg.eps)
        delta.div_(denom)
        torch.mul(p.to(torch.float32), cfg.weight_decay, out=denom)
        delta.add_(denom).mul_(lr)
        del denom
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.to(torch.float32) - delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
