"""Gradient compression for cross-pod sync: top-k + error feedback, int8.

The port's copy of the JAX package's ``distributed/compression.py``.  At 2+
pods the gradient all-reduce over the inter-pod links is the scarce
resource.  Two standard compressors are provided as pure functions;
``compressed_grads`` wraps either around a gradient tree with persistent
error-feedback state so the training loop can compress before the pod-axis
reduction and decompress after.

``jax.lax.top_k`` puts equal values in index order; the port keeps that with
a stable descending sort (``torch.topk`` does not promise it).
``jnp.round`` and ``torch.round`` both round half to even.
"""

from __future__ import annotations

import torch

from .checkpoint import named_leaves

__all__ = [
    "topk_compress",
    "topk_decompress",
    "int8_compress",
    "int8_decompress",
    "init_error_feedback",
    "compressed_grads",
]


def topk_compress(g: torch.Tensor, ratio: float):
    """Keep the largest-|g| ``ratio`` fraction -> (values, flat indices)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx


def topk_decompress(values, idx, shape, dtype=torch.float32):
    n = 1
    for s in shape:
        n *= int(s)
    flat = values.new_zeros((n,), dtype=dtype)
    flat[idx] = values.to(dtype)
    return flat.reshape(shape)


def int8_compress(g: torch.Tensor):
    """Symmetric per-tensor int8 quantisation -> (q, scale)."""
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q, scale, dtype=torch.float32):
    return q.to(dtype) * scale


def init_error_feedback(params) -> dict:
    """``{leaf name: float32 zeros}`` of a parameter tree."""
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in named_leaves(params)}


def compressed_grads(grads, ef_state, method: str = "topk", ratio: float = 0.01):
    """Compress+decompress a gradient tree with error feedback.

    ``grads`` and ``ef_state`` are trees (or a list) whose leaves pair up in
    pytree order.  Returns ``(effective_grads, new_ef_state, bytes_ratio)``
    where ``effective_grads`` is what the optimizer sees (decompressed) and
    the residual (what compression dropped) is carried to the next step,
    each ``{leaf name: tensor}`` under the names of ``grads``.
    """

    def one(g, e):
        target = g.to(torch.float32) + e
        if method == "topk":
            vals, idx = topk_compress(target, ratio)
            rec = topk_decompress(vals, idx, target.shape)
        elif method == "int8":
            q, s = int8_compress(target)
            rec = int8_decompress(q, s)
        else:
            raise ValueError(method)
        return rec, target - rec

    named = named_leaves(grads)
    out = [one(g, e) for (_, g), (_, e) in zip(named, named_leaves(ef_state))]
    bytes_ratio = {"topk": ratio * 2.0, "int8": 0.25}[method]  # vs f32
    return ({n: rec for (n, _), (rec, _) in zip(named, out)},
            {n: res for (n, _), (_, res) in zip(named, out)},
            bytes_ratio)
