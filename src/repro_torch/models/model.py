"""Model assembly: embeddings + stacked layer periods + head.

The port's copy of the JAX package's ``models/model.py``.  The parameters
are an :class:`torch.nn.Module` tree (:class:`ParamTree`) whose
``named_parameters()``, with ``.`` read as ``::``, are the reference's
pytree paths and whose shapes are its leaves: every period of the layer
pattern is stacked on a leading ``n_periods`` axis (``periods.l0.mixer.wq``
of Qwen2.5-3B is one ``[36, 2048, 2048]`` parameter) and the leading dense
layers are an ``nn.ModuleList`` (``prologue.0...``).  So a checkpoint
archived from the port has the reference's shard names and sizes, and its
restore plans are the reference's.

The stack runs as a Python loop over the period index, the counterpart of
the reference's ``lax.scan`` (``scan_layers`` chooses how XLA compiles the
same arithmetic; here there is one way).  ``forward`` takes the periods
through one ``unbind`` per stacked leaf, so that backward stacks each leaf's
period gradients once (indexing a period instead would write a zero tensor
of the whole stack per period in backward); ``decode_step`` indexes them
(``_at``) and writes its cache in place.  While gradients are recorded each
period runs under ``torch.utils.checkpoint`` as ``remat``/``remat_policy``
ask, the counterpart of ``jax.checkpoint`` (:func:`_remat`).  The sharding
hints (``act_hints``, ``seq_parallel`` between periods, the vocab-sharded
logits under ``logits_bf16_ce``) are
:func:`~repro_torch.distributed.context.shard_hint` calls where the
reference has them: the identity without an active mesh, a redistribution
of the ``DTensor`` activations on the mesh path.  MoE layers (``"moe" in lp``) replace the FFN and add their
load-balancing loss to the aux loss that ``forward`` returns, summed over
the prologue and the periods as the reference sums it; decode drops it.
The recurrent mixers (Mamba, mLSTM, sLSTM) keep an O(1) state in the
decode cache and write it in place, as attention writes its KV slot.
Cross-attention reads a static memory: the vision embeddings of a VLM, or
the output of :func:`encode` (the enc-dec encoder stack); before decoding,
:func:`warm_cross_cache` projects it once into the cross K/V caches, in
place, and decode reads them and never writes them.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..distributed.context import dp_spec, lookup, shard_hint
from ..distributed.sharding import MODEL
from .blocks import (
    MIXER_APPLY,
    MIXER_INIT,
    Ctx,
    _proj,
    apply_ffn,
    apply_xattn,
    init_attn,
    init_attn_cache,
    init_ffn,
    init_mamba_cache,
    init_mla_cache,
    init_mlstm_cache,
    init_slstm_cache,
    init_xattn_cache,
)
from .common import ModelConfig, apply_moe, embed_init, init_moe, rms_norm


class ParamTree(nn.Module):
    """A nested dict of tensors as a module tree: a dict becomes a submodule,
    a list an ``nn.ModuleList``, a tensor a parameter (``requires_grad``
    off, so serving builds no graph; training turns it on with
    ``requires_grad_(True)``).  Indexing by name, ``get``, ``in`` and
    ``items`` read it as the dict it was built from."""

    def __init__(self, tree: dict[str, Any]):
        super().__init__()
        for name, sub in tree.items():
            if isinstance(sub, dict):
                self.add_module(name, ParamTree(sub))
            elif isinstance(sub, list):
                self.add_module(name, nn.ModuleList(ParamTree(t) for t in sub))
            else:
                self.register_parameter(name, nn.Parameter(sub, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default

    def items(self):
        return [*self._parameters.items(), *self._modules.items()]


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts or :class:`ParamTree` s, as dicts."""
    if isinstance(tree, (dict, ParamTree)):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _at(tree, i: int):
    """Period ``i`` of a stacked tree: views, so a write reaches the stack."""
    return _tree_map(lambda a: a[i], tree)


def _stacked(make, n: int):
    """``n`` draws of ``make()`` stacked on a leading axis (the reference's
    ``jax.vmap`` over an init), each copied into place as it is drawn and
    dropped before the next is drawn.  A single draw is stacked as a view of
    itself, without a copy, so that a period as large as half the card can
    be stacked."""
    draw = make()
    if n == 1:
        return _tree_map(lambda a: a.unsqueeze(0), draw)
    out = _tree_map(lambda a: a.new_empty((n, *a.shape)), draw)
    for i in range(n):
        draw = draw if i == 0 else make()
        _tree_map(lambda o, a: o[i].copy_(a), out, draw)
        draw = None
    return out


def _resolved_kind(cfg: ModelConfig, kind: str) -> str:
    return "mla" if (kind == "attn" and cfg.use_mla) else kind


def _layer_has_cross(cfg: ModelConfig) -> bool:
    """Enc-dec decoders put a cross-attention sub-block in every layer."""
    return cfg.enc_layers > 0


def check_device(device) -> None:
    """Raise unless ``device`` can be used: a CUDA device needs a card."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but torch sees no CUDA device")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(gen, cfg: ModelConfig, kind: str, *, is_moe: bool, cross: bool, device,
                d_ff: int | None = None) -> dict:
    def ones():
        return torch.ones((cfg.d_model,), dtype=cfg.pdtype, device=device)

    p = {"ln1": ones(), "mixer": MIXER_INIT[_resolved_kind(cfg, kind)](gen, cfg, device=device)}
    if cross and kind != "xattn":
        p["lnx"] = ones()
        p["xmixer"] = init_attn(gen, cfg, device=device)
    if is_moe:
        p["ln2"] = ones()
        p["moe"] = init_moe(gen, cfg, device=device)
    elif (d_ff or cfg.d_ff) > 0:
        p["ln2"] = ones()
        p["ffn"] = init_ffn(gen, cfg, d_ff=d_ff, device=device)
    return p


def _init_period(gen, cfg: ModelConfig, device) -> dict:
    return {
        f"l{i}": _init_layer(gen, cfg, kind, is_moe=cfg.is_moe_layer(i),
                             cross=_layer_has_cross(cfg), device=device)
        for i, kind in enumerate(cfg.block_pattern)
    }


def init_model(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> ParamTree:
    """The model's parameters on ``device``, drawn from ``gen`` (a generator
    on that device; ``device="meta"`` takes a CPU generator and allocates
    nothing, which is enough for anything that reads only shapes)."""
    check_device(device)
    D, V = cfg.d_model, cfg.vocab_size
    params: dict[str, Any] = {
        "embed": embed_init(gen, (V, D), cfg.pdtype, device=device),
        "final_norm": torch.ones((D,), dtype=cfg.pdtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, (D, V), cfg.pdtype, device=device)
    # prologue: leading dense layers outside the stack (DeepSeek/Kimi style)
    if cfg.first_k_dense:
        params["prologue"] = [
            _init_layer(gen, cfg, "attn", is_moe=False, cross=_layer_has_cross(cfg),
                        device=device, d_ff=cfg.dense_d_ff or cfg.d_ff)
            for _ in range(cfg.first_k_dense)
        ]
    params["periods"] = _stacked(lambda: _init_period(gen, cfg, device), cfg.n_periods)
    # encoder stack (enc-dec only): uniform self-attention layers
    if cfg.enc_layers:
        params["encoder"] = _stacked(
            lambda: _init_layer(gen, cfg, "attn", is_moe=False, cross=False, device=device),
            cfg.enc_layers)
        params["enc_norm"] = torch.ones((D,), dtype=cfg.pdtype, device=device)
    return ParamTree(params)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------
def _add_aux(total, aux):
    """The running aux loss: ``None`` stands for the reference's float32
    zero, which adding leaves every sum unchanged."""
    return aux if total is None else (total if aux is None else total + aux)


def _apply_layer(lp, x, cfg: ModelConfig, kind: str, ctx: Ctx, cache):
    """-> (x, new cache or None, the MoE aux loss or None)."""
    rk = _resolved_kind(cfg, kind)
    y, new_cache = MIXER_APPLY[rk](lp["mixer"], rms_norm(x, lp["ln1"]), cfg, ctx,
                                   cache=cache.get("mix") if cache else None)
    x = x + y
    new_cache = {"mix": new_cache} if new_cache is not None else {}
    if "xmixer" in lp:
        y, xc = apply_xattn(lp["xmixer"], rms_norm(x, lp["lnx"]), cfg, ctx,
                            cache=cache.get("cross") if cache else None)
        x = x + y
        if xc is not None:
            new_cache["cross"] = xc
    aux = None
    if "moe" in lp:
        y, aux = apply_moe(lp["moe"], rms_norm(x, lp["ln2"]), cfg)
        x = x + y
    elif "ffn" in lp:
        x = x + apply_ffn(lp["ffn"], rms_norm(x, lp["ln2"]), cfg)
    return x, (new_cache or None), aux


def _apply_period(pp, x, cfg: ModelConfig, ctx: Ctx, caches):
    new_caches, aux_total = {}, None
    for i, kind in enumerate(cfg.block_pattern):
        c = caches[f"l{i}"] if caches is not None else None
        x, nc, aux = _apply_layer(pp[f"l{i}"], x, cfg, kind, ctx, c)
        aux_total = _add_aux(aux_total, aux)
        if nc is not None:
            new_caches[f"l{i}"] = nc
    if (cfg.act_hints or cfg.seq_parallel) and x.ndim == 3:
        if cfg.seq_parallel:
            x = shard_hint(x, lambda m: (dp_spec(m), MODEL, None))
        else:
            x = shard_hint(x, lambda m: (dp_spec(m), None, None))
    return x, (new_caches or None), aux_total


def _remat(fn, cfg: ModelConfig):
    """``fn`` under activation checkpointing, as ``cfg`` asks: ``"full"``
    recomputes everything in backward, ``"dots"`` saves the outputs of the
    unbatched products (``aten.mm``, what ``dots_with_no_batch_dims_saveable``
    saves; the batched attention products are recomputed)."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            [torch.ops.aten.mm.default])

    def remat(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return remat


def _remat_if_training(fn, params, cfg: ModelConfig):
    """``fn`` under :func:`_remat` only while a gradient is recorded, so
    serving runs the layers as they are."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in params.parameters()):
        return _remat(fn, cfg)
    return fn


def _run_stack(params, x, cfg: ModelConfig, ctx: Ctx):
    """Train/prefill pass over the prologue and the periods, each period
    checkpointed while training."""
    aux_total = None
    for lp in params.get("prologue", []):
        x, _, aux = _apply_layer(lp, x, cfg, "attn", ctx, None)
        aux_total = _add_aux(aux_total, aux)

    def body(h, pp):
        h, _, aux = _apply_period(pp, h, cfg, ctx, None)
        return h, aux

    body = _remat_if_training(body, params, cfg)
    periods = _tree_map(lambda a: a.unbind(0), params["periods"])
    for i in range(cfg.n_periods):
        x, aux = body(x, _tree_map(lambda slices: slices[i], periods))
        aux_total = _add_aux(aux_total, aux)
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux_total


def encode(params, cfg: ModelConfig, enc_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder stack (enc-dec models) over the frontend's embeddings
    ``[B, M, D]``, cast to the compute dtype: non-causal self-attention at
    positions ``0..M-1``, each layer checkpointed while training, then the
    encoder's final norm."""
    B, M = enc_embeds.shape[:2]
    ctx = Ctx(positions=torch.arange(M, device=enc_embeds.device).expand(B, M), causal=False)

    def body(h, lp):
        return _apply_layer(lp, h, cfg, "attn", ctx, None)[0]

    body = _remat_if_training(body, params, cfg)
    layers = _tree_map(lambda a: a.unbind(0), params["encoder"])
    x = enc_embeds.to(cfg.cdtype)
    for i in range(cfg.enc_layers):
        x = body(x, _tree_map(lambda slices: slices[i], layers))
    return rms_norm(x, params["enc_norm"])


def _head(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            memory: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits [B, L, V] f32, MoE aux loss).

    The aux loss is the MoE load-balancing term summed over the MoE layers,
    a float32 0 in a model without one."""
    B, L = tokens.shape
    x = lookup(params["embed"], tokens).to(cfg.cdtype)
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    ctx = Ctx(positions=positions, memory=memory, causal=True)
    x, aux = _run_stack(params, x, cfg, ctx)
    logits = _head(params, cfg, x)
    if cfg.logits_bf16_ce:
        # kept in the compute dtype, model-sharded over the vocab axis; the
        # iota-select cross-entropy never gathers the full vocabulary
        logits = shard_hint(logits, lambda m: (dp_spec(m), None, MODEL))
    else:
        logits = logits.float()
    return logits, aux


# ---------------------------------------------------------------------------
# decode (single token, cached)
# ---------------------------------------------------------------------------
def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      cross_len: int, device) -> dict:
    rk = _resolved_kind(cfg, kind)
    c: dict[str, Any] = {}
    if rk == "attn":
        c["mix"] = init_attn_cache(cfg, batch, max_len, device=device)
    elif rk == "mla":
        c["mix"] = init_mla_cache(cfg, batch, max_len, device=device)
    elif rk == "mamba":
        c["mix"] = init_mamba_cache(cfg, batch, device=device)
    elif rk == "mlstm":
        c["mix"] = init_mlstm_cache(cfg, batch, device=device)
    elif rk == "slstm":
        c["mix"] = init_slstm_cache(cfg, batch, device=device)
    elif rk == "xattn":
        c["mix"] = init_xattn_cache(cfg, batch, cross_len, device=device)
    if _layer_has_cross(cfg) and kind != "xattn":
        c["cross"] = init_xattn_cache(cfg, batch, cross_len, device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    """Decode cache: nested dicts of tensors, the period caches stacked to
    match the stacked parameters, the prologue's a list."""
    check_device(device)
    cross_len = cfg.num_vision_tokens or cfg.num_enc_frames or 1

    def one_period():
        return {f"l{i}": _init_layer_cache(cfg, kind, batch, max_len, cross_len, device)
                for i, kind in enumerate(cfg.block_pattern)}

    cache: dict[str, Any] = {"periods": _stacked(one_period, cfg.n_periods)}
    if cfg.first_k_dense:
        cache["prologue"] = [_init_layer_cache(cfg, "attn", batch, max_len, cross_len, device)
                             for _ in range(cfg.first_k_dense)]
    return cache


def warm_cross_cache(params, cfg: ModelConfig, cache: dict, memory: torch.Tensor) -> dict:
    """Fill the cross-attention K/V caches from the static ``memory`` (the
    serving stack's prefill of the encoder output or the vision
    embeddings), cast to the compute dtype: the ``"mix"`` caches of the VLM
    ``xattn`` layers and the ``"cross"`` caches of the enc-dec layers, the
    prologue's included.  Each period's slice of the stacked caches is
    written in place, one period's projection at a time, so no second cache
    is allocated.  Returns ``cache`` itself; afterwards ``decode_step``
    never reads ``memory``."""
    mem = memory.to(cfg.cdtype)
    B, M, _ = mem.shape

    def fill(kv, attn_p):
        for name in ("k", "v"):
            y = _proj(mem, attn_p[f"w{name}"], attn_p.get(f"b{name}"))
            kv[name].copy_(y.reshape(B, M, cfg.num_kv_heads, cfg.head_dim))

    for i, kind in enumerate(cfg.block_pattern):
        key = f"l{i}"
        for n in range(cfg.n_periods):
            pp, pc = _at(params["periods"][key], n), _at(cache["periods"][key], n)
            if kind == "xattn":  # VLM image layers: the memory's K/V are the mixer's cache
                fill(pc["mix"], pp["mixer"])
            elif _layer_has_cross(cfg):
                fill(pc["cross"], pp["xmixer"])
    if cfg.first_k_dense and _layer_has_cross(cfg):
        for lp, lc in zip(params["prologue"], cache["prologue"]):
            fill(lc["cross"], lp["xmixer"])
    return cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict, pos, *,
                memory: torch.Tensor | None = None):
    """One decode step -> (logits [B, 1, V] f32, cache).

    ``pos`` is the current position (an int, or a 0-d tensor read once on
    the host).  Every cache is written in place: the attention caches at
    ``pos`` clamped into the cache, as the reference's
    ``dynamic_update_slice`` clamps it, and the recurrent mixers' states
    whole; the cross-attention caches are read, never written, and
    ``memory`` is not read once they exist, as in the reference.  The
    returned cache is ``cache`` itself.
    """
    pos = int(pos)
    x = lookup(params["embed"], tokens).to(cfg.cdtype)
    ctx = Ctx(pos=pos, memory=memory, causal=True)
    for lp, lc in zip(params.get("prologue", []), cache.get("prologue", [])):
        x = _apply_layer(lp, x, cfg, "attn", ctx, lc)[0]
    for i in range(cfg.n_periods):  # the MoE aux loss is dropped, as the reference drops it
        x = _apply_period(_at(params["periods"], i), x, cfg, ctx, _at(cache["periods"], i))[0]
    return _head(params, cfg, x).float(), cache
