"""Sequence-mixer and FFN blocks: every mixer's parameters and decode cache,
and the attention and FFN paths.

The port's copy of the JAX package's ``models/blocks.py``.  Every mixer has
``init_<kind>(gen, cfg, *, device) -> params`` and its cache initialiser, so
that every architecture's parameter tree has the reference's names and
shapes (the tape archive and its restore plans depend on them).  Of the
``apply_<kind>(p, x, cfg, ctx, cache=None) -> (y, new_cache)`` paths the
port has all of the reference's: attention, Multi-head Latent Attention
(MLA decodes absorbed, over its compressed cache), cross-attention to a
static memory (the VLM image layers and the enc-dec decoder's sub-block),
the Mamba selective scan, the xLSTM cells (mLSTM and sLSTM) and the FFN,
each over the full sequence and at single-token decode.

``cache is None`` selects the full-sequence path (prefill); otherwise the
single-token decode path runs and writes the cache in place: ``decode_step``
hands back the cache it was given, so a mixer whose state is not written
into it would decode every token from its initial state.  The recurrent
mixers update each state from its old value in place (``mul_``/``add_``),
or compute it whole and ``copy_`` it in; a float64 model keeps their
states and gates in float64 (:func:`state_dtype`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..distributed.context import (
    gathered, local_attention, merge_dims, replicated_apply, rows_matmul, split_dim, unshard,
    width_replicated, width_sharded, write_at,
)
from .common import (
    ModelConfig,
    apply_rope,
    causal_attention,
    chunked_causal_attention,
    dense_init,
    rms_norm,
    rope_freqs,
    swiglu,
    wide,
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
    reference.  The weights are column-sharded, so on the mesh path the
    output keeps its width on "model" (:func:`width_sharded`)."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return width_sharded(y)


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
    q = split_dim(_proj(x, p["wq"], p.get("bq")), -1, Hq, dh)
    k = split_dim(_proj(x, p["wk"], p.get("bk")), -1, Hkv, dh)
    v = split_dim(_proj(x, p["wv"], p.get("bv")), -1, Hkv, dh)

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
        write_at(k_cache, 1, slot, k[:, 0].to(k_cache.dtype))
        write_at(v_cache, 1, slot, v[:, 0].to(v_cache.dtype))
        mask = torch.arange(S, device=x.device) <= pos  # valid prefix
        qg = split_dim(unshard(q, 2), 2, Hkv, Hq // Hkv)
        logits = torch.einsum("blhgd,bmhd->bhglm", qg, k_cache).float() * scale
        logits = logits.masked_fill(~mask, -1e30)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhglm,bmhd->blhgd", w.to(v_cache.dtype), v_cache)
        out = out.reshape(B, 1, Hq, dh)
        new_cache = {"k": k_cache, "v": v_cache}
    y = width_sharded(merge_dims(out, 2, 2)) @ p["wo"].to(x.dtype)
    return y, new_cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


# ---------------------------------------------------------------------------
# cross-attention to a static memory (VLM image layers / enc-dec decoder)
# ---------------------------------------------------------------------------
def apply_xattn(p, x, cfg: ModelConfig, ctx: Ctx, cache=None):
    """Queries from ``x`` attend, without a mask and without RoPE, to keys and
    values of the memory (the encoder output or the vision embeddings).

    Over the full sequence, or at decode with a cache that has no ``"k"``,
    the keys and values are projected from ``ctx.memory`` cast to ``x``'s
    dtype; otherwise they are the cache's, which
    :func:`~repro_torch.models.model.warm_cross_cache` filled.  Decode reads
    the cache and never writes it, and hands back the cache it was given."""
    B, L, D = x.shape
    Hq, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_dim(_proj(x, p["wq"], p.get("bq")), -1, Hq, dh)
    if cache is None or "k" not in cache:
        mem = ctx.memory.to(x.dtype)
        M = mem.shape[1]
        k = split_dim(_proj(mem, p["wk"], p.get("bk")), -1, Hkv, dh)
        v = split_dim(_proj(mem, p["wv"], p.get("bv")), -1, Hkv, dh)
    else:
        k, v = cache["k"], cache["v"]
    out = causal_attention(q, k, v, scale=dh**-0.5, causal=False,
                           scores_f32=cfg.attn_scores_f32)
    return width_sharded(merge_dims(out, 2, 2)) @ p["wo"].to(x.dtype), cache


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

    q = rms_norm(rows_matmul(x, p["wq_a"].to(x.dtype)), p["q_norm"])
    q = split_dim(width_sharded(q @ p["wq_b"].to(x.dtype)), -1, H, nd + rd)
    qn, qr_ = q[..., :nd], q[..., nd:]

    kv_a = rows_matmul(x, p["wkv_a"].to(x.dtype))
    ckv = rms_norm(kv_a[..., :kr], p["kv_norm"])  # [B, L, kr]
    k_rope = kv_a[..., kr:].reshape(B, L, 1, rd)

    if cache is None:
        cos, sin = rope_freqs(ctx.positions, rd, cfg.rope_theta)
        qr_ = apply_rope(qr_, cos, sin)
        k_rope = apply_rope(k_rope, cos, sin)
        kn = split_dim(width_sharded(ckv @ p["wk_b"].to(x.dtype)), -1, H, nd)
        v = split_dim(width_sharded(ckv @ p["wv_b"].to(x.dtype)), -1, H, vd)
        k = torch.cat([kn, k_rope.expand(B, L, H, rd)], -1)
        out = _attend(torch.cat([qn, qr_], -1), k, v, cfg, ctx, scale)
        return width_sharded(merge_dims(out, 2, 2)) @ p["wo"].to(x.dtype), None

    # ---- absorbed decode over the compressed cache -------------------------
    pos = ctx.pos
    cos, sin = rope_freqs(torch.full((1, 1), pos, dtype=torch.float32, device=x.device),
                          rd, cfg.rope_theta)
    qr_ = apply_rope(qr_, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    ckv_cache, kr_cache = cache["ckv"], cache["kr"]
    S = ckv_cache.shape[1]
    slot = _cache_slot(pos, S)
    write_at(ckv_cache, 1, slot, ckv[:, 0].to(ckv_cache.dtype))
    write_at(kr_cache, 1, slot, k_rope[:, 0, 0].to(kr_cache.dtype))
    wk_b = split_dim(p["wk_b"].to(x.dtype), -1, H, nd)
    q_abs = unshard(torch.einsum("blhn,khn->blhk", qn, wk_b), 2)  # [B, 1, H, kr]
    logits = (torch.einsum("blhk,bsk->bhls", q_abs, ckv_cache)
              + torch.einsum("blhr,bsr->bhls", unshard(qr_, 2), kr_cache)).float() * scale
    mask = torch.arange(S, device=x.device) <= pos
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    out_c = torch.einsum("bhls,bsk->blhk", w.to(ckv_cache.dtype), ckv_cache)
    wv_b = split_dim(p["wv_b"].to(x.dtype), -1, H, vd)
    out = torch.einsum("blhk,khv->blhv", out_c, wv_b)
    y = merge_dims(out, 2, 2) @ p["wo"].to(x.dtype)
    return y, {"ckv": ckv_cache, "kr": kr_cache}


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> dict:
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=cfg.cdtype, device=device),
        "kr": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=cfg.cdtype, device=device),
    }


# ---------------------------------------------------------------------------
# Mamba (S6 selective scan, chunked)
# ---------------------------------------------------------------------------
def state_dtype(cfg: ModelConfig) -> torch.dtype:
    """The recurrent mixers' state and gate dtype: float32, as in the
    reference, or float64 in a float64 model."""
    return torch.promote_types(cfg.cdtype, torch.float32)


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
        "ssm": torch.zeros((batch, dI, cfg.mamba_d_state), dtype=state_dtype(cfg),
                           device=device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every ``x``.  (``F.softplus``
    returns ``x`` itself past its threshold of 20, which differs by up to
    ``exp(-20)``.)"""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _mamba_ssm_inputs(p, u, cfg: ModelConfig):
    """u [B, L, dI] -> (dA, dBu, C), the selective scan's elements (float32,
    or float64 in a float64 model).

    ``dt`` is made in ``u``'s dtype and widened after its softplus, as in the
    reference."""
    dS = cfg.mamba_d_state
    dt_rank = p["dt_proj"].shape[0]
    # a partial sum over "model", reduced before the column-sharded dt_proj
    proj = width_replicated(u @ p["x_proj"].to(u.dtype))
    dt = wide(_softplus(proj[..., :dt_rank] @ p["dt_proj"].to(u.dtype)
                   + p["dt_bias"].to(u.dtype)))  # [B, L, dI]
    Bc = wide(proj[..., dt_rank : dt_rank + dS])  # [B, L, dS]
    Cc = wide(proj[..., dt_rank + dS :])  # [B, L, dS]
    A = -torch.exp(p["A_log"].to(dt.dtype))  # [dI, dS]
    dA = torch.exp(dt[..., None] * A)  # [B, L, dI, dS]
    dBu = (dt * wide(u))[..., None] * Bc[..., None, :]  # [B, L, dI, dS]
    return dA, dBu, Cc


def _conv1d_causal(u, w, b, state=None):
    """Depthwise causal conv over ``u`` [B, L, dI] -> (out, new state); the
    state [B, dC-1, dI] holds the last inputs, so decode streams through it."""
    dC = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], dC - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    out = sum(full[:, i : i + u.shape[1]] * w[i].to(u.dtype) for i in range(dC)) \
        + b.to(u.dtype)
    new_state = full[:, -(dC - 1) :] if dC > 1 else pad
    return out, new_state


def _scan_chunk(dA, dBu):
    """Inclusive scan over axis 1 of the pairs ``(dA, dBu)`` [B, Ck, dI, dS]
    under ``(l, r) -> (r.A * l.A, r.A * l.B + r.B)`` (``l`` the earlier):
    ``(prod_{s<=t} dA[s], sum_{s<=t} prod_{s<r<=t} dA[r] * dBu[s])``.

    The reference calls ``jax.lax.associative_scan``; this is a Hillis-Steele
    sweep in ``log2(Ck)`` rounds.  Its order of summation: round ``j``
    (offset ``d = 2**j``) folds the pair ending at ``t - d`` into the pair
    ending at ``t`` for every ``t >= d``, so element ``t`` sums the blocks
    ``[t-2d+1, t-d]`` and ``[t-d+1, t]`` of the previous round, the earlier
    one scaled by the later one's product.  It differs from the reference's
    odd-even recursion only in float32 rounding."""
    d = 1
    while d < dA.shape[1]:
        dA, dBu = (torch.cat([dA[:, :d], dA[:, d:] * dA[:, :-d]], dim=1),
                   torch.cat([dBu[:, :d], dA[:, d:] * dBu[:, :-d] + dBu[:, d:]], dim=1))
        d *= 2
    return dA, dBu


def apply_mamba(p, x, cfg: ModelConfig, ctx: Ctx, cache=None):
    """Mamba's S6 block: in-projection, causal conv, the selective scan, the
    gate and the out-projection.

    The full sequence is scanned in chunks of ``cfg.mamba_chunk`` (or the
    whole sequence if shorter; it must divide the sequence, as the
    reference asserts): a scan within each chunk (:func:`_scan_chunk`), the
    state ``h0`` [B, dI, dS] carried across chunks.  Decode takes one step
    of the recurrence from the cache's ``ssm`` and ``conv`` states and
    writes both back in place."""
    B, L, D = x.shape
    dI = cfg.mamba_expand * D
    # the halves of a column-sharded product: gathered (its gradient goes
    # back sharded), then each sharded over "model" again
    uz = gathered(x @ p["in_proj"].to(x.dtype), -1)
    u, z = width_sharded(uz[..., :dI]), width_sharded(uz[..., dI:])

    if cache is None:
        u, _ = _conv1d_causal(u, p["conv_w"], p["conv_b"])
        u = width_sharded(F.silu(u))
        dA, dBu, Cc = _mamba_ssm_inputs(p, u, cfg)
        Ck = min(cfg.mamba_chunk, L)
        assert L % Ck == 0, (L, Ck)
        h = torch.zeros((B, dI, cfg.mamba_d_state), dtype=dA.dtype, device=x.device)
        ys = []
        for c in range(0, L, Ck):
            Acum, Bcum = _scan_chunk(dA[:, c : c + Ck], dBu[:, c : c + Ck])
            h_all = Acum * h[:, None] + Bcum  # [B, Ck, dI, dS]
            ys.append(torch.einsum("blds,bls->bld", h_all, Cc[:, c : c + Ck]))
            h = h_all[:, -1]
        y = torch.cat(ys, dim=1)
        y = y.to(x.dtype) + u * p["D_skip"].to(x.dtype)
    else:
        u_c, conv_state = _conv1d_causal(u, p["conv_w"], p["conv_b"], cache["conv"])
        u_c = F.silu(u_c)
        dA, dBu, Cc = _mamba_ssm_inputs(p, u_c, cfg)
        h = cache["ssm"].mul_(dA[:, 0]).add_(dBu[:, 0])  # [B, dI, dS], in place
        y = torch.einsum("bds,bs->bd", h, Cc[:, 0])[:, None]
        y = y.to(x.dtype) + u_c * p["D_skip"].to(x.dtype)
        cache["conv"].copy_(conv_state)
    out = (y * F.silu(z)) @ p["out_proj"].to(x.dtype)
    return out, cache


# ---------------------------------------------------------------------------
# xLSTM cells
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


def _mlstm_parallel(q, Fc, amax, k, v, a, row_offset: int):
    """The parallel mLSTM over query rows ``row_offset ..`` of ``q``, ``Fc``
    and ``amax`` [B, Lq, H(, dh)] against every key of ``k``, ``v`` and
    ``a`` [B, L, H(, dh)]."""
    # Dmat[t, s] = exp(F[t]-F[s]+i[s]-m[t]), m[t] = F[t] + amax[t]
    dmat = torch.exp(a[:, None] - amax[:, :, None])  # [B, t, s, H]
    t_idx = torch.arange(q.shape[1], device=q.device) + row_offset
    s_idx = torch.arange(k.shape[1], device=q.device)
    causal = (t_idx[:, None] >= s_idx[None, :])[None, :, :, None]
    dmat = torch.where(causal, dmat, 0.0)
    scores = wide(torch.einsum("blhd,bmhd->blmh", q, k)) * dmat
    norm = torch.maximum(scores.sum(dim=2).abs(), torch.exp(-(Fc + amax)))  # [B, L, H]
    return torch.einsum("blmh,bmhd->blhd", (scores / norm[:, :, None]).to(v.dtype), v)


def apply_mlstm(p, x, cfg: ModelConfig, ctx: Ctx, cache=None):
    """Matrix-memory LSTM [arXiv:2405.04517]: the parallel stabilised form
    over the full sequence, the O(1) recurrent form with the ``(m, C, n)``
    state at decode (written back in place), ``rms_norm`` on the output.

    The parallel form computes ``exp(a[s] - amax[t])`` for every ``(t, s)``
    and masks ``s > t`` after, as the reference does; past about 130 steps
    the masked entries overflow to ``inf`` (the output does not see them)."""
    B, L, D = x.shape
    H, dh = cfg.num_heads, cfg.head_dim
    q = split_dim(_proj(x, p["wq"]), -1, H, dh)
    k = split_dim(_proj(x, p["wk"]), -1, H, dh) * dh**-0.5
    v = split_dim(_proj(x, p["wv"]), -1, H, dh)
    gates = wide(rows_matmul(x, p["w_if"].to(x.dtype)) + p["b_if"].to(x.dtype))
    i_raw, f_raw = gates[..., :H], gates[..., H:]  # [B, L, H]
    log_f = -_softplus(-f_raw)  # log sigmoid(f)

    if cache is None:
        Fc = replicated_apply(lambda t: torch.cumsum(t, dim=1), log_f)  # [B, L, H]
        a = i_raw - Fc  # i[s] - F[s]
        amax = replicated_apply(lambda t: torch.cummax(t, dim=1).values, a)
        h = local_attention(_mlstm_parallel, (q, Fc, amax), (k, v, a))
    else:
        q, k, v = unshard(q, 2), unshard(k, 2), unshard(v, 2)
        m0, C0, n0 = cache["m"], cache["C"], cache["n"]
        lf, ii = log_f[:, 0], i_raw[:, 0]  # [B, H]
        m1 = torch.maximum(lf + m0, ii)
        c_f = torch.exp(lf + m0 - m1)[..., None, None]
        c_i = torch.exp(ii - m1)[..., None, None]
        m0.copy_(m1)
        k0, qh = wide(k[:, 0]), wide(q[:, 0])
        kv = torch.einsum("bhd,bhe->bhde", k0, wide(v[:, 0]))
        C0.mul_(c_f).addcmul_(c_i, kv)  # c_f * C + c_i * kv, in place
        n0.mul_(c_f[..., 0]).addcmul_(c_i[..., 0], k0)
        num = torch.einsum("bhd,bhde->bhe", qh, C0)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qh, n0).abs(), torch.exp(-m1))
        h = (num / den[..., None]).to(x.dtype)[:, None]
    h = rms_norm(merge_dims(unshard(h, 2), 2, 2), p["ln_out"])
    return width_sharded(h) @ p["wo"].to(x.dtype), cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    H, dh = cfg.num_heads, cfg.head_dim
    return {
        "m": torch.full((batch, H), -1e30, dtype=state_dtype(cfg), device=device),
        "C": torch.zeros((batch, H, dh, dh), dtype=state_dtype(cfg), device=device),
        "n": torch.zeros((batch, H, dh), dtype=state_dtype(cfg), device=device),
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


def _slstm_step(p, carry, xt, cfg: ModelConfig):
    """One sLSTM step -> (new carry, h); ``xt`` [B, 4*H*dh] are the step's
    pre-projected inputs, ``carry`` the ``(c, n, h, m)`` state [B, H, dh]
    each.  The recurrent matrices are block-diagonal (one per head and
    gate), the forget gate is a log-sigmoid and ``m`` stabilises the
    exponential gates; float32 throughout (float64 in a float64 model)."""
    H, dh = cfg.num_heads, cfg.head_dim
    c0, n0, h0, m0 = carry
    r = p["r"].to(h0.dtype)
    rec = torch.einsum("bhd,ghde->gbhe", h0, r)  # [4, B, H, dh]
    pre = split_dim(xt, -1, 4, H, dh).transpose(0, 1) + rec
    z = torch.tanh(pre[0])
    i_t, f_t, o_t = pre[1], pre[2], torch.sigmoid(pre[3])
    lf = -_softplus(-f_t)  # log sigmoid(f)
    m1 = torch.maximum(lf + m0, i_t)
    c1 = torch.exp(lf + m0 - m1) * c0 + torch.exp(i_t - m1) * z
    n1 = torch.exp(lf + m0 - m1) * n0 + torch.exp(i_t - m1)
    h1 = o_t * c1 / torch.clamp(n1, min=1e-6)
    return (c1, n1, h1, m1), h1


def apply_slstm(p, x, cfg: ModelConfig, ctx: Ctx, cache=None):
    """Scalar-memory LSTM [arXiv:2405.04517]: the inputs projected once,
    then :func:`_slstm_step` over the sequence from the zero state (``m``
    at -1e30), or one step from the cache's state, written back in place."""
    B, L, D = x.shape
    H, dh = cfg.num_heads, cfg.head_dim
    pre = wide(_proj(x, p["w_in"], p["b_in"]))

    if cache is None:
        def zeros():
            return torch.zeros((B, H, dh), dtype=pre.dtype, device=x.device)
        carry = (zeros(), zeros(), zeros(),
                 torch.full((B, H, dh), -1e30, dtype=pre.dtype, device=x.device))
        hs = []
        for t in range(L):
            carry, h1 = _slstm_step(p, carry, pre[:, t], cfg)
            hs.append(h1)
        h = merge_dims(torch.stack(hs, dim=1), 2, 2).to(x.dtype)
        h = width_sharded(h)
    else:
        carry, h1 = _slstm_step(p, (cache["c"], cache["n"], cache["h"], cache["m"]),
                                pre[:, 0], cfg)
        for name, new in zip(("c", "n", "h", "m"), carry):
            cache[name].copy_(new)
        h = h1.reshape(B, 1, H * dh).to(x.dtype)
    return h @ p["wo"].to(x.dtype), cache


def init_slstm_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    H, dh = cfg.num_heads, cfg.head_dim
    def z():
        return torch.zeros((batch, H, dh), dtype=state_dtype(cfg), device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, H, dh), -1e30, dtype=state_dtype(cfg), device=device)}


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
    "xattn": apply_xattn,
    "mla": apply_mla,
    "mamba": apply_mamba,
    "mlstm": apply_mlstm,
    "slstm": apply_slstm,
}
