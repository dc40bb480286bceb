"""Sequence-mixer and FFN blocks: every mixer's parameters and decode cache,
and the attention and FFN paths.

The port's copy of the JAX package's ``models/blocks.py``.  Every mixer has
``init_<kind>(gen, cfg, *, device) -> params`` and its cache initialiser, so
that every architecture's parameter tree has the reference's names and
shapes (the tape archive and its restore plans depend on them).  Of the
``apply_<kind>(p, x, cfg, ctx, cache=None) -> (y, new_cache)`` paths the
port has attention and Multi-head Latent Attention (full sequence and
single-token decode; MLA decodes absorbed, over its compressed cache) and
the FFN; the other mixers raise :class:`NotImplementedError` naming
themselves and the ROADMAP item that ports them.

``cache is None`` selects the full-sequence path (prefill); otherwise the
single-token decode path runs and writes the cache in place.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .common import (
    ModelConfig,
    apply_rope,
    causal_attention,
    chunked_causal_attention,
    dense_init,
    rms_norm,
    rope_freqs,
    swiglu,
)


@dataclasses.dataclass
class Ctx:
    """Side inputs threaded through the layer stack."""

    positions: torch.Tensor | None = None  # [B, L] token positions
    pos: int | None = None  # decode position
    memory: torch.Tensor | None = None  # encoder output / vision embeddings
    causal: bool = True


# ---------------------------------------------------------------------------
# grouped-query attention (optionally with QKV bias — Qwen2.5)
# ---------------------------------------------------------------------------
def init_attn(gen, cfg: ModelConfig, *, device) -> dict:
    D, Hq, Hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (D, Hq * dh), cfg.pdtype, device=device),
        "wk": dense_init(gen, (D, Hkv * dh), cfg.pdtype, device=device),
        "wv": dense_init(gen, (D, Hkv * dh), cfg.pdtype, device=device),
        "wo": dense_init(gen, (Hq * dh, D), cfg.pdtype, scale=(Hq * dh) ** -0.5,
                         device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((Hq * dh,), dtype=cfg.pdtype, device=device)
        p["bk"] = torch.zeros((Hkv * dh,), dtype=cfg.pdtype, device=device)
        p["bv"] = torch.zeros((Hkv * dh,), dtype=cfg.pdtype, device=device)
    return p


def _proj(x, w, b=None):
    """``x @ w`` in x's dtype: the weight is cast on every call, as in the
    reference."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _cache_slot(pos: int, S: int) -> int:
    """The cache slot decode writes at ``pos``: the reference's
    ``dynamic_update_slice`` clamps the start index into the cache, so a
    position at or past ``max_len`` writes the last slot."""
    return min(max(pos, 0), S - 1)


def _attend(q, k, v, cfg: ModelConfig, ctx: Ctx, scale: float):
    """Full-sequence attention, chunked over queries where the config asks
    and the sequence divides into more than one chunk."""
    L = q.shape[1]
    if cfg.attn_q_chunk and ctx.causal and L % cfg.attn_q_chunk == 0 and L > cfg.attn_q_chunk:
        return chunked_causal_attention(q, k, v, scale=scale, chunk=cfg.attn_q_chunk,
                                        scores_f32=cfg.attn_scores_f32)
    return causal_attention(q, k, v, scale=scale, causal=ctx.causal,
                            scores_f32=cfg.attn_scores_f32)


def apply_attn(p, x, cfg: ModelConfig, ctx: Ctx, cache=None):
    B, L, D = x.shape
    Hq, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, L, Hq, dh)
    k = _proj(x, p["wk"], p.get("bk")).reshape(B, L, Hkv, dh)
    v = _proj(x, p["wv"], p.get("bv")).reshape(B, L, Hkv, dh)

    scale = dh**-0.5
    if cache is None:
        cos, sin = rope_freqs(ctx.positions, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = _attend(q, k, v, cfg, ctx, scale)
        new_cache = None
    else:
        # decode: write one token into the cache, attend over the full cache
        pos = ctx.pos
        cos, sin = rope_freqs(torch.full((1, 1), pos, dtype=torch.float32, device=x.device),
                              dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_cache, v_cache = cache["k"], cache["v"]
        S = k_cache.shape[1]
        slot = _cache_slot(pos, S)
        k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
        mask = torch.arange(S, device=x.device) <= pos  # valid prefix
        qg = q.reshape(B, 1, Hkv, Hq // Hkv, dh)
        logits = torch.einsum("blhgd,bmhd->bhglm", qg, k_cache).float() * scale
        logits = logits.masked_fill(~mask, -1e30)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhglm,bmhd->blhgd", w.to(v_cache.dtype), v_cache)
        out = out.reshape(B, 1, Hq, dh)
        new_cache = {"k": k_cache, "v": v_cache}
    y = out.reshape(B, -1, Hq * dh) @ p["wo"].to(x.dtype)
    return y, new_cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def init_xattn_cache(cfg: ModelConfig, batch: int, mem_len: int, *, device) -> dict:
    return init_attn_cache(cfg, batch, mem_len, device=device)


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2; absorbed decode)
# ---------------------------------------------------------------------------
def init_mla(gen, cfg: ModelConfig, *, device) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "wq_a": dense_init(gen, (D, qr), cfg.pdtype, device=device),
        "q_norm": torch.ones((qr,), dtype=cfg.pdtype, device=device),
        "wq_b": dense_init(gen, (qr, H * (nd + rd)), cfg.pdtype, device=device),
        "wkv_a": dense_init(gen, (D, kr + rd), cfg.pdtype, device=device),
        "kv_norm": torch.ones((kr,), dtype=cfg.pdtype, device=device),
        "wk_b": dense_init(gen, (kr, H * nd), cfg.pdtype, device=device),
        "wv_b": dense_init(gen, (kr, H * vd), cfg.pdtype, device=device),
        "wo": dense_init(gen, (H * vd, D), cfg.pdtype, scale=(H * vd) ** -0.5, device=device),
    }


def apply_mla(p, x, cfg: ModelConfig, ctx: Ctx, cache=None):
    """MLA: queries through the ``q_lora_rank`` bottleneck, keys and values
    from the ``kv_lora_rank`` latent ``ckv`` plus one shared RoPE key.

    Decode keeps only ``ckv`` and the RoPE key in the cache and absorbs
    ``wk_b`` into the query and ``wv_b`` into the output, as the reference
    does; its logits are made in ``x.dtype`` and widened after their sum.
    """
    B, L, D = x.shape
    H = cfg.num_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    scale = (nd + rd) ** -0.5

    q = rms_norm(x @ p["wq_a"].to(x.dtype), p["q_norm"])
    q = (q @ p["wq_b"].to(x.dtype)).reshape(B, L, H, nd + rd)
    qn, qr_ = q[..., :nd], q[..., nd:]

    kv_a = x @ p["wkv_a"].to(x.dtype)
    ckv = rms_norm(kv_a[..., :kr], p["kv_norm"])  # [B, L, kr]
    k_rope = kv_a[..., kr:].reshape(B, L, 1, rd)

    if cache is None:
        cos, sin = rope_freqs(ctx.positions, rd, cfg.rope_theta)
        qr_ = apply_rope(qr_, cos, sin)
        k_rope = apply_rope(k_rope, cos, sin)
        kn = (ckv @ p["wk_b"].to(x.dtype)).reshape(B, L, H, nd)
        v = (ckv @ p["wv_b"].to(x.dtype)).reshape(B, L, H, vd)
        k = torch.cat([kn, k_rope.expand(B, L, H, rd)], -1)
        out = _attend(torch.cat([qn, qr_], -1), k, v, cfg, ctx, scale)
        return out.reshape(B, L, H * vd) @ p["wo"].to(x.dtype), None

    # ---- absorbed decode over the compressed cache -------------------------
    pos = ctx.pos
    cos, sin = rope_freqs(torch.full((1, 1), pos, dtype=torch.float32, device=x.device),
                          rd, cfg.rope_theta)
    qr_ = apply_rope(qr_, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    ckv_cache, kr_cache = cache["ckv"], cache["kr"]
    S = ckv_cache.shape[1]
    slot = _cache_slot(pos, S)
    ckv_cache[:, slot] = ckv[:, 0].to(ckv_cache.dtype)
    kr_cache[:, slot] = k_rope[:, 0, 0].to(kr_cache.dtype)
    wk_b = p["wk_b"].to(x.dtype).reshape(kr, H, nd)
    q_abs = torch.einsum("blhn,khn->blhk", qn, wk_b)  # [B, 1, H, kr]
    logits = (torch.einsum("blhk,bsk->bhls", q_abs, ckv_cache)
              + torch.einsum("blhr,bsr->bhls", qr_, kr_cache)).float() * scale
    mask = torch.arange(S, device=x.device) <= pos
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    out_c = torch.einsum("bhls,bsk->blhk", w.to(ckv_cache.dtype), ckv_cache)
    wv_b = p["wv_b"].to(x.dtype).reshape(kr, H, vd)
    out = torch.einsum("blhk,khv->blhv", out_c, wv_b)
    y = out.reshape(B, 1, H * vd) @ p["wo"].to(x.dtype)
    return y, {"ckv": ckv_cache, "kr": kr_cache}


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> dict:
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=cfg.cdtype, device=device),
        "kr": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=cfg.cdtype, device=device),
    }


# ---------------------------------------------------------------------------
# Mamba (S6 selective scan): parameters and cache
# ---------------------------------------------------------------------------
def init_mamba(gen, cfg: ModelConfig, *, device) -> dict:
    D = cfg.d_model
    dI = cfg.mamba_expand * D
    dS = cfg.mamba_d_state
    dC = cfg.mamba_d_conv
    dt_rank = max(1, math.ceil(D / 16))
    a = torch.arange(1, dS + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, (D, 2 * dI), cfg.pdtype, device=device),
        "conv_w": dense_init(gen, (dC, dI), cfg.pdtype, scale=dC**-0.5, device=device),
        "conv_b": torch.zeros((dI,), dtype=cfg.pdtype, device=device),
        "x_proj": dense_init(gen, (dI, dt_rank + 2 * dS), cfg.pdtype, device=device),
        "dt_proj": dense_init(gen, (dt_rank, dI), cfg.pdtype, device=device),
        "dt_bias": torch.zeros((dI,), dtype=cfg.pdtype, device=device),
        "A_log": torch.log(a.expand(dI, dS)).contiguous(),
        "D_skip": torch.ones((dI,), dtype=cfg.pdtype, device=device),
        "out_proj": dense_init(gen, (dI, D), cfg.pdtype, scale=dI**-0.5, device=device),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    dI = cfg.mamba_expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, dI), dtype=cfg.cdtype, device=device),
        "ssm": torch.zeros((batch, dI, cfg.mamba_d_state), dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# xLSTM cells: parameters and caches
# ---------------------------------------------------------------------------
def init_mlstm(gen, cfg: ModelConfig, *, device) -> dict:
    D, H, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (D, H * dh), cfg.pdtype, device=device),
        "wk": dense_init(gen, (D, H * dh), cfg.pdtype, device=device),
        "wv": dense_init(gen, (D, H * dh), cfg.pdtype, device=device),
        "w_if": dense_init(gen, (D, 2 * H), cfg.pdtype, scale=0.02, device=device),
        "b_if": torch.zeros((2 * H,), dtype=cfg.pdtype, device=device),
        "wo": dense_init(gen, (H * dh, D), cfg.pdtype, scale=(H * dh) ** -0.5, device=device),
        "ln_out": torch.ones((H * dh,), dtype=cfg.pdtype, device=device),
    }


def init_mlstm_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    H, dh = cfg.num_heads, cfg.head_dim
    return {
        "m": torch.full((batch, H), -1e30, dtype=torch.float32, device=device),
        "C": torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
    }


def init_slstm(gen, cfg: ModelConfig, *, device) -> dict:
    D, H, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        # input projections for (z, i, f, o)
        "w_in": dense_init(gen, (D, 4 * H * dh), cfg.pdtype, device=device),
        "b_in": torch.zeros((4 * H * dh,), dtype=cfg.pdtype, device=device),
        # per-head recurrent (block-diagonal) matrices for (z, i, f, o)
        "r": dense_init(gen, (4, H, dh, dh), cfg.pdtype, device=device),
        "wo": dense_init(gen, (H * dh, D), cfg.pdtype, scale=(H * dh) ** -0.5, device=device),
    }


def init_slstm_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    H, dh = cfg.num_heads, cfg.head_dim
    def z():
        return torch.zeros((batch, H, dh), dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, H, dh), -1e30, dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------
def init_ffn(gen, cfg: ModelConfig, d_ff: int | None = None, *, device) -> dict:
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, (D, F_), cfg.pdtype, device=device),
        "w_in": dense_init(gen, (D, F_), cfg.pdtype, device=device),
        "w_out": dense_init(gen, (F_, D), cfg.pdtype, scale=F_**-0.5, device=device),
    }


def apply_ffn(p, x, cfg: ModelConfig):
    return swiglu(x, p["w_gate"].to(x.dtype), p["w_in"].to(x.dtype), p["w_out"].to(x.dtype))


# ---------------------------------------------------------------------------
# mixers whose apply path is not in this slice
# ---------------------------------------------------------------------------
#: mixer -> the ROADMAP item that ports its apply path
NOT_PORTED = {"mamba": "A9.2", "mlstm": "A9.3", "slstm": "A9.3", "xattn": "A9.4"}


def not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {kind!r} apply path is not ported to repro_torch yet "
        f"(ROADMAP item {NOT_PORTED[kind]}); the port applies 'attn', 'mla', the dense "
        f"FFN and the MoE")


def _refused(kind: str):
    def apply(p, x, cfg: ModelConfig, ctx: Ctx, cache=None):
        raise not_ported(kind)
    apply.__name__ = f"apply_{kind}"
    return apply


MIXER_INIT = {
    "attn": init_attn,
    "xattn": init_attn,
    "mla": init_mla,
    "mamba": init_mamba,
    "mlstm": init_mlstm,
    "slstm": init_slstm,
}
MIXER_APPLY = {
    "attn": apply_attn,
    "xattn": _refused("xattn"),
    "mla": apply_mla,
    "mamba": _refused("mamba"),
    "mlstm": _refused("mlstm"),
    "slstm": _refused("slstm"),
}
