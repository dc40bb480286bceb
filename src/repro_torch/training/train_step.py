"""Train-step factory: loss, gradient accumulation (microbatching), optimizer.

The port's copy of the JAX package's ``training/train_step.py``.
``make_train_step(cfg, opt_cfg, microbatches=k)`` returns
``(params, opt_state, batch) -> (params, opt_state, metrics)``; the
parameters and the optimizer state are updated in place and returned.
Gradient accumulation keeps the reference's arithmetic: microbatch ``i`` is
``x.reshape(-1, k, ...)[:, i]`` (batch axis outermost), the gradients are
summed in float32 from zeros and divided by ``k``, and ``metrics`` holds the
*last* microbatch's ``loss`` and ``aux_loss`` (the reference's scan carry
replaces them each iteration).
"""

from __future__ import annotations

from typing import Any

import torch

from ..distributed.checkpoint import named_leaves
from ..models.common import ModelConfig, softmax_cross_entropy
from ..models.model import encode, forward, init_model
from .optimizer import OptConfig, adamw_init, adamw_update

AUX_LOSS_WEIGHT = 0.01


def loss_fn(params, cfg: ModelConfig, batch) -> tuple[torch.Tensor, dict[str, Any]]:
    memory = None
    if cfg.enc_layers:  # enc-dec: the encoder runs inside the loss, so its gradients flow
        memory = encode(params, cfg, batch["enc_embeds"])
    elif cfg.num_vision_tokens:  # VLM: the stub frontend supplies patch embeddings
        memory = batch["vision_embeds"]
    logits, aux = forward(params, cfg, batch["tokens"], memory=memory)
    loss = softmax_cross_entropy(
        logits[:, :-1], batch["tokens"][:, 1:], sharded_vocab=cfg.logits_bf16_ce
    )
    total = loss + AUX_LOSS_WEIGHT * aux
    return total, {"loss": loss, "aux_loss": aux}


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, microbatches: int | None = None):
    """Build the train step (optionally gradient-accumulated)."""

    microbatches = microbatches if microbatches is not None else cfg.microbatches

    def grad_fn(params, leaves, batch):
        total, metrics = loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(total, leaves, materialize_grads=True)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def micro(batch, i):
        return {k: x.reshape(-1, microbatches, *x.shape[1:])[:, i] if x.ndim >= 1 else x
                for k, x in batch.items()}

    def accumulate(params, batch):
        leaves = [p for _, p in named_leaves(params)]
        if microbatches == 1:
            return grad_fn(params, leaves, batch)
        grads = [torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format) for p in leaves]
        for i in range(microbatches):
            part, metrics = grad_fn(params, leaves, micro(batch, i))
            for acc, g in zip(grads, part):
                acc.add_(g)
            del part
        return [g.div_(microbatches) for g in grads], metrics

    def train_step(params, opt_state, batch):
        grads, metrics = accumulate(params, batch)
        params, opt_state, opt_metrics = adamw_update(opt_cfg, grads, opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Parameters drawn from ``gen`` on ``device``, with gradients on, and
    their AdamW state."""
    params = init_model(gen, cfg, device=device)
    params.requires_grad_(True)
    return params, adamw_init(params)
