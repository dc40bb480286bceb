"""Serve-step factory: batched single-token decode with greedy sampling.

``make_serve_step(cfg)`` returns ``(params, cache, tokens, pos) ->
(next_tokens, logits, cache)``, the port's copy of the JAX package's
``serving/serve.py``.  Greedy sampling takes the first maximum of the last
logits (``torch.argmax``, as ``jnp.argmax``) and returns int32 tokens
``[B, 1]``.  ``warm_cross_cache`` fills the cross-attention caches from
the memory before decoding.

This module is deliberately *not* re-exported from
:mod:`repro_torch.serving`: it pulls in the language-model stack
(:mod:`repro_torch.models`), which the tape-serving event loop and its
callers never need.  Import it directly, as
:mod:`repro_torch.launch.serve` does.
"""

from __future__ import annotations

import torch

from ..models.common import ModelConfig
from ..models.model import decode_step, forward, init_cache, warm_cross_cache


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens, pos):
        logits, cache = decode_step(params, cfg, tokens, cache, pos)
        next_tokens = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tokens[:, None], logits, cache

    return serve_step


def make_prefill(cfg: ModelConfig):
    """Full-sequence forward used for prompt processing."""

    def prefill(params, tokens, memory=None):
        logits, _ = forward(params, cfg, tokens, memory=memory)
        return logits

    return prefill


__all__ = ["make_serve_step", "make_prefill", "init_cache", "warm_cross_cache"]
