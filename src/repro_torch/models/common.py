"""Shared model substrate: config, init helpers, primitives, attention, MoE.

The port's copy of the JAX package's ``models/common.py`` in PyTorch.
Parameters are tensors drawn from an explicit :class:`torch.Generator` on an
explicit device; every ``apply`` is a plain function of tensors.  The matrix
products stay plain ``@``/``torch.einsum`` calls, as the reference leaves
them to XLA: the language-model path has no hand-written kernel.  The MoE's
expert products are three batched products over the ``[E, C, D]`` dispatch
buffer, as in the reference, so that remat ``dots`` (which saves only the
unbatched ``aten.mm`` outputs) recomputes them as the reference's
``dots_with_no_batch_dims_saveable`` does.

On the mesh path the tensors are ``DTensor`` s, and the same code runs: the
head splits and merges go through ``split_dim``/``merge_dims``, the
attention operands through ``unshard``, and the gather cross-entropy
replicates its logits (:mod:`repro_torch.distributed.context`), each the
identity on a plain tensor.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..distributed.context import (
    dp_spec, merge_dims, replicated, replicated_apply, replicated_grad, shard_hint, split_dim,
    unshard,
)
from ..distributed.sharding import MODEL

#: the dtype names a config may carry, as torch dtypes
DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
}


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0  # leading dense layers (DeepSeek/Kimi style)
    moe_every: int = 1  # MoE on layers with (idx % moe_every == moe_every-1)
    dense_d_ff: int = 0  # FFN width of the leading dense layers
    # --- MLA (DeepSeek-V2 / Kimi) -------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- layer pattern (one period, stacked) --------------------------------
    # entries: "attn" | "mamba" | "mlstm" | "slstm" | "xattn" (vision cross)
    block_pattern: tuple[str, ...] = ("attn",)
    # --- Mamba --------------------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk: int = 256
    # --- encoder-decoder (audio) / VLM stub frontends -----------------------
    enc_layers: int = 0  # >0: enc-dec; num_layers counts decoder layers
    num_vision_tokens: int = 0  # VLM: precomputed patch embeddings
    num_enc_frames: int = 0  # audio: precomputed frame embeddings
    # --- numerics / training -----------------------------------------------
    # The fields below are the reference's; the serving path reads
    # compute_dtype, param_dtype, tie_embeddings, logits_bf16_ce,
    # attn_scores_f32 and attn_q_chunk.  The others steer the reference's
    # compilation, sharding and training, and are kept so that a config is
    # the reference's value for value.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    capacity_factor: float = 1.25
    tie_embeddings: bool = False
    remat_policy: str = "full"  # full | dots | none
    decode_mla_absorb: bool = True  # absorbed MLA decode (compressed cache)
    logits_bf16_ce: bool = False  # logits kept in the compute dtype
    act_hints: bool = False  # sharding constraints on block boundaries
    seq_parallel: bool = False  # shard sequence over "model" between blocks
    moe_hints: bool = False  # constrain MoE dispatch buffers (EP placement)
    attn_scores_f32: bool = True  # False: scores materialised in compute dtype
    microbatches: int = 1  # gradient-accumulation microbatches per step
    moe_gather_dispatch: bool = False  # permutation-gather MoE dispatch
    attn_q_chunk: int = 0  # >0: chunked causal attention over KV prefixes

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.num_heads

    @property
    def n_periods(self) -> int:
        assert self.layers_after_prologue % len(self.block_pattern) == 0, (
            self.arch_id,
            self.layers_after_prologue,
            self.block_pattern,
        )
        return self.layers_after_prologue // len(self.block_pattern)

    @property
    def layers_after_prologue(self) -> int:
        return self.num_layers - self.first_k_dense

    def is_moe_layer(self, pos_in_pattern: int) -> bool:
        """Static MoE placement within one period."""
        if self.num_experts == 0:
            return False
        return pos_in_pattern % self.moe_every == self.moe_every - 1

    @property
    def is_subquadratic(self) -> bool:
        """Supports the 500k-token long-context decode shape."""
        return any(k in ("mamba", "mlstm", "slstm") for k in self.block_pattern)

    @property
    def cdtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None, *,
               device) -> torch.Tensor:
    """Normal draw scaled by ``fan_in ** -0.5`` (or ``scale``), in float32
    and then cast, as the reference draws it."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in**-0.5
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, *, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in at least float32: the reference's ``astype(float32)`` for
    the narrower types, while a float64 tensor stays float64 (so that a
    float64 model computes in float64 throughout)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = wide(x)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * wide(w)).to(dt)


def rope_freqs(positions: torch.Tensor, dim: int, theta: float):
    """positions [*, L] -> (cos, sin) [*, L, dim/2]."""
    arange = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (theta ** (arange / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., L, H, D] with (cos, sin) [..., L, D/2] (broadcast over heads).

    Half-split rotation: the first and second halves of the head dimension
    are the two coordinates of each rotated pair.
    """
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def causal_attention(q, k, v, *, scale: float, causal: bool = True,
                     q_offset: int | None = None, scores_f32: bool = True):
    """Grouped-query attention.

    q [B, Lq, Hq, D], k/v [B, Lk, Hkv, D(v)] with Hq % Hkv == 0.
    ``q_offset``: position of q_i is ``q_offset + i`` (None means Lq == Lk
    aligned).  Scores are float32 when ``scores_f32`` (the operands are
    widened first, which is exact, so the products accumulate in float32 as
    the reference's ``preferred_element_type`` asks), else the compute dtype.
    Masked scores are -30000, not -inf, as in the reference.
    """
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q, k, v = unshard(q, 2), unshard(k, 2), unshard(v, 2)
    qg = split_dim(q, 2, Hkv, G)
    sdt = torch.float32 if scores_f32 else q.dtype
    logits = torch.einsum("blhgd,bmhd->bhglm", qg.to(sdt), k.to(sdt))
    logits = logits * torch.tensor(scale, dtype=sdt)  # the scale rounded to sdt first
    if causal:
        qpos = torch.arange(Lq, device=q.device)[:, None] + (q_offset or 0)
        mask = qpos >= torch.arange(Lk, device=q.device)[None, :]
        logits = logits.masked_fill(~mask, -30000.0)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhglm,bmhe->blhge", w.to(v.dtype), v)
    return merge_dims(unshard(out, 2, 3), 2, 2)


def chunked_causal_attention(q, k, v, *, scale: float, chunk: int,
                             scores_f32: bool = True):
    """Causal attention computed one query chunk at a time.

    Chunk ``i`` attends only to the key prefix ``[: (i+1)*chunk]``, so
    compute is triangular and the live score buffer is ``chunk x Lk``.
    """
    B, Lq, Hq, Dh = q.shape
    Lk = k.shape[1]
    assert Lq == Lk and Lq % chunk == 0, (Lq, Lk, chunk)
    outs = []
    for i in range(Lq // chunk):
        hi = (i + 1) * chunk
        outs.append(causal_attention(
            q[:, i * chunk : hi], k[:, :hi], v[:, :hi], scale=scale, causal=True,
            q_offset=i * chunk, scores_f32=scores_f32,
        ))
    return torch.cat(outs, dim=1)


def swiglu(x, w_gate, w_in, w_out):
    h = F.silu(x @ w_gate) * (x @ w_in)
    return h @ w_out


def softmax_cross_entropy(logits, labels, z_loss: float = 1e-4,
                          sharded_vocab: bool = False):
    """Mean next-token loss with z-loss; logits [B, L, V], labels [B, L].

    ``sharded_vocab=True`` is the reference's iota-select form: the label's
    logit is picked by comparing an ``arange`` over the vocabulary with the
    label (``torch.where``) and summing, where the other form gathers it.
    Both compute in float32.
    """
    if sharded_vocab:
        lse = torch.logsumexp(logits.float(), dim=-1)
        iota = torch.arange(logits.shape[-1], device=logits.device)
        onehot_sel = torch.where(iota == labels[..., None], logits.float(), 0.0)
        ll = onehot_sel.sum(dim=-1)
    else:
        logits = replicated(logits).float()  # the DTensor gather of a sharded vocab fails
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse**2
    return loss.mean()


# ---------------------------------------------------------------------------
# permutation gather whose gradient is also a gather (MoE dispatch primitive)
# ---------------------------------------------------------------------------
class _PermGather(torch.autograd.Function):
    """``out[i] = src[idx[i]]`` whose backward is ALSO a gather (via ``inv_idx``).

    ``src`` [N+1, D] (last row a zero pad for sentinel indices); ``idx`` [M]
    indices into src; ``inv_idx`` carries the inverse mapping backward needs:

    * ``k_axis == 0``: ``inv_idx`` [N, K] lists the <= K output rows fed by
      each src row (sentinel M), so backward sums K gathered cotangents;
    * ``k_axis < 0``: ``inv_idx`` [N] is a plain inverse permutation
      (sentinel M), so backward is one gather.

    The pad row gets a zero gradient; ``idx`` and ``inv_idx`` get none.
    """

    @staticmethod
    def forward(src, idx, inv_idx, k_axis):
        return src[idx]

    @staticmethod
    def setup_context(ctx, inputs, output):
        src, _, inv_idx, k_axis = inputs
        ctx.save_for_backward(inv_idx)
        ctx.k_axis, ctx.n1 = k_axis, src.shape[0]

    @staticmethod
    def backward(ctx, g):
        (inv_idx,) = ctx.saved_tensors
        zero = g.new_zeros((1, g.shape[1]))
        gpad = torch.cat([g, zero], 0)
        dsrc = gpad[inv_idx].sum(1) if ctx.k_axis == 0 else gpad[inv_idx]
        return torch.cat([dsrc, zero], 0)[: ctx.n1], None, None, None


def _perm_gather(src, idx, inv_idx, k_axis: int):
    return _PermGather.apply(src, idx, inv_idx, k_axis)


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based dispatch with capacity)
# ---------------------------------------------------------------------------
def init_moe(gen: torch.Generator, cfg: ModelConfig, *, device) -> dict:
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": dense_init(gen, (D, E), torch.float32, device=device),  # router in f32
        "w_gate": dense_init(gen, (E, D, F_), cfg.pdtype, device=device),
        "w_in": dense_init(gen, (E, D, F_), cfg.pdtype, device=device),
        "w_out": dense_init(gen, (E, F_, D), cfg.pdtype, scale=F_**-0.5, device=device),
    }
    if cfg.num_shared_experts:
        Fs = F_ * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, (D, Fs), cfg.pdtype, device=device),
            "w_in": dense_init(gen, (D, Fs), cfg.pdtype, device=device),
            "w_out": dense_init(gen, (Fs, D), cfg.pdtype, scale=Fs**-0.5, device=device),
        }
    return p


def moe_route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig):
    """The float32 router over tokens ``xt`` [T, D] -> (probs [T, E], top_p,
    top_e [T, K]): the K largest probabilities, renormalised, and their
    experts.  ``jax.lax.top_k`` puts equal values in index order, which a
    stable descending sort keeps (``torch.topk`` does not promise it)."""
    probs = torch.softmax((xt.float() @ router).float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, : cfg.top_k], top_e[:, : cfg.top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)  # renormalise
    return probs, top_p, top_e


def moe_slots(top_e: torch.Tensor, cfg: ModelConfig):
    """The sort-based dispatch of ``top_e`` [T, K] -> (order, keep, slot, C):
    assignments sorted stably by expert (``order``), their rank within the
    expert kept below the capacity ``C`` (``keep``), and their row of the
    ``[E * C]`` buffer (``slot``; every dropped one the sentinel ``E * C``)."""
    E = cfg.num_experts
    S = top_e.numel()
    flat_e = top_e.reshape(S)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    # counted by a scatter, not ``torch.bincount``, whose output size waits
    # for the largest index on the host
    counts = torch.zeros(E, dtype=se.dtype, device=se.device).scatter_add(
        0, se, torch.ones_like(se))
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    rank = torch.arange(S, device=top_e.device) - starts[se]
    C = max(1, int(cfg.capacity_factor * S / E))
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)  # overflow -> dropped row
    return order, keep, slot, C


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig):
    """Top-k token-choice MoE with sort-based dispatch and capacity drop.

    x [B, L, D] -> ([B, L, D], the load-balancing aux loss).  ``moe_hints``
    pins the dispatch buffer to expert-parallel placement and the output to
    the batch's (:func:`~repro_torch.distributed.context.shard_hint`, the
    identity without an active mesh).  The index buffers of the dispatch
    are filled out of place (``scatter_add``, ``index_add``, ``index_put``):
    on the mesh path they meet ``DTensor`` indices as replicated constants,
    and DTensor has strategies for these forms in every torch release.
    """
    B, L, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    cdt = cfg.cdtype
    T = B * L
    xt = x.reshape(T, D)

    probs, top_p, top_e = moe_route(p["router"], xt, cfg)
    # aux load-balancing loss (Switch-style); the integer bookkeeping runs
    # on the whole of top_e (replicated on the mesh path)
    def counts(e):
        ones = torch.ones(T * K, dtype=torch.float32, device=e.device)
        return torch.zeros(E, dtype=torch.float32, device=e.device).index_add(
            0, e.reshape(-1), ones)

    density = replicated_apply(counts, top_e) / (T * K)
    aux = E * torch.sum(density * probs.mean(0))

    order, keep, slot, C = replicated_apply(lambda e: moe_slots(e, cfg), top_e)
    S = T * K
    stok = torch.arange(T, device=x.device).repeat_interleave(K)[order]
    if cfg.moe_gather_dispatch:
        # integer index maps; the only repeated index is the sentinel E * C
        def full(n, value):
            return torch.full((n,), value, dtype=torch.int64, device=x.device)

        inv_tok = full(E * C + 1, T).index_put((slot,), stok)
        slot_tk = full(S, E * C).index_put((order,), slot)
        slot_tk = slot_tk.reshape(T, K)  # token -> its <= K slots
        inv_flat = full(E * C + 1, S).index_put((slot,), order)
        xt1 = torch.cat([xt.to(cdt), xt.new_zeros((1, D), dtype=cdt)], 0)
        buf = _perm_gather(xt1, inv_tok[: E * C], slot_tk, 0).reshape(E, C, D)
    else:
        buf = torch.zeros((E * C + 1, D), dtype=cdt, device=x.device)
        # the scatter and the gathers below on replicated operands (GSPMD's
        # all-gathers), their gradients replicated too
        xs = replicated_grad(replicated(xt)[stok]).to(cdt)
        buf = replicated_grad(buf.index_put((slot,), xs))
        buf = buf[: E * C].reshape(E, C, D)
    if cfg.moe_hints:  # pin the dispatch buffer to expert-parallel placement
        buf = shard_hint(buf, lambda m: (MODEL, None, None))

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(cdt)))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["w_in"].to(cdt))
    y = torch.einsum("ecf,efd->ecd", h, p["w_out"].to(cdt))

    y_flat = y.reshape(E * C, D)
    if cfg.moe_gather_dispatch:
        # combine: each token's <= K expert outputs gathered back
        y1 = torch.cat([y_flat, y_flat.new_zeros((1, D))], 0)
        z = _perm_gather(y1, slot_tk.reshape(-1), inv_flat[: E * C], -1).reshape(T, K, D)
        out = (z * top_p[..., None].to(z.dtype)).sum(1)
    else:
        sw = replicated_grad(replicated(top_p).reshape(S)[order])
        picked = replicated_grad(replicated(y_flat)[slot.clamp(0, E * C - 1)])
        gathered = torch.where(keep[:, None], picked, 0.0)
        out = replicated_grad(torch.zeros((T, D), dtype=cdt, device=x.device).index_add(
            0, stok, replicated(gathered * sw[:, None].to(cdt))))
    if cfg.moe_hints:
        out = shard_hint(out, lambda m: (dp_spec(m), None))

    if cfg.num_shared_experts:
        sh = p["shared"]
        out = out + swiglu(xt.to(cdt), sh["w_gate"].to(cdt), sh["w_in"].to(cdt),
                           sh["w_out"].to(cdt))
    return out.reshape(B, L, D), aux
