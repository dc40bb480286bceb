"""The port's MoE and MLA apply paths against the JAX package's.

Both packages run the reference's weights (carried into the port by
``models/convert.load_params``; JAX and torch draw different numbers from
one seed) in float32 on the CPU, within ``rtol = atol = 1e-4`` as
``tests/test_torch_models.py`` holds the dense decoders (the same float32
products, summed in each framework's own order).  The routing is integer:
the experts each token picks (``top_e``), which assignments the capacity
keeps (``keep``) and the buffer row of each (``slot``) must be equal, read
from the reference's own calls while it runs.  Gradients are held within
1e-5 of each leaf's largest element, as ``tests/test_torch_training.py``
holds the dense ones.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import blocks as ref_blocks
from repro.models import common as ref_common
from repro.models.common import ModelConfig as RefModelConfig
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed.checkpoint import named_leaves
from repro_torch.models import blocks, common, convert
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import ParamTree
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 1e-5


def moe_cfgs(**kw):
    """A small MoE layer's config in both packages (8 experts, top 2)."""
    base = dict(arch_id="t", family="moe", num_layers=1, d_model=32, num_heads=2,
                num_kv_heads=2, d_ff=48, vocab_size=64, num_experts=8, top_k=2,
                moe_d_ff=48, compute_dtype="float32", capacity_factor=8.0)
    base.update(kw)
    return RefModelConfig(**base), ModelConfig(**base)


def moe_pair(seed: int = 0, zero_router: bool = False, **kw):
    """``(ref_cfg, ref_params, cfg, port params)`` on the same weights."""
    ref_cfg, cfg = moe_cfgs(**kw)
    tree = jax.tree.map(np.asarray, ref_common.init_moe(jax.random.PRNGKey(seed), ref_cfg))
    if zero_router:
        tree["router"] = np.zeros_like(tree["router"])
    params = convert.load_params(
        ParamTree(common.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")), tree)
    return ref_cfg, jax.tree.map(jnp.asarray, tree), cfg, params


def inputs(shape=(2, 8, 32), seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


class _Recorder:
    """Stands in for a module in the reference's namespace and records the
    outputs of the calls named in ``record``."""

    def __init__(self, module, record):
        self._module, self.calls = module, collections.defaultdict(list)
        self._record = record

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if name not in self._record:
            return fn

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls[name].append((args, out))
            return out

        return call


def reference_routing(ref_p, ref_cfg, x, monkeypatch):
    """Run the reference's ``apply_moe`` eagerly and read its routing from
    its own calls: ``top_e`` from ``jax.lax.top_k``, ``keep`` and ``slot``
    from the first ``jnp.where`` (``slot = where(keep, se * C + rank,
    E * C)``)."""
    lax = _Recorder(jax.lax, {"top_k"})
    jnp_rec = _Recorder(jnp, {"where"})
    fake_jax = _Recorder(jax, set())
    fake_jax.__dict__["lax"] = lax
    monkeypatch.setattr(ref_common, "jax", fake_jax)
    monkeypatch.setattr(ref_common, "jnp", jnp_rec)
    try:
        out, aux = ref_common.apply_moe(ref_p, jnp.asarray(x), ref_cfg)
    finally:
        monkeypatch.undo()
    (_, (_, top_e)), = lax.calls["top_k"]
    (keep, _, _), slot = jnp_rec.calls["where"][0]
    return out, aux, np.asarray(top_e), np.asarray(keep), np.asarray(slot)


def port_routing(params, cfg, x):
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    _, _, top_e = common.moe_route(params["router"], xt, cfg)
    _, keep, slot, _ = common.moe_slots(top_e, cfg)
    return top_e.numpy(), keep.numpy(), slot.numpy()


def assert_grads_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(got[name] - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()) + 1e-30, (name, err)


def objective(out, aux):
    return (out**2).sum() + aux


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
def test_apply_moe_matches_reference(dispatch, cf, shared, monkeypatch):
    """Output, aux loss and routing, then the gradients of both with respect
    to every parameter and the input."""
    kw = dict(capacity_factor=cf, num_shared_experts=shared,
              moe_gather_dispatch=dispatch == "gather")
    ref_cfg, ref_p, cfg, params = moe_pair(**kw)
    x = inputs()
    ref_out, ref_aux, ref_top_e, ref_keep, ref_slot = reference_routing(ref_p, ref_cfg, x,
                                                                        monkeypatch)
    top_e, keep, slot = port_routing(params, cfg, x)
    assert np.array_equal(top_e, ref_top_e) and np.array_equal(keep, ref_keep)
    assert np.array_equal(slot, ref_slot)
    if cf < 1:
        assert not keep.all()  # the capacity drops assignments
    elif cf == 8.0:
        assert keep.all()

    params.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = common.apply_moe(params, tx, cfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(ref_aux), **TOL)

    names, leaves = zip(*named_leaves(params))
    grads = torch.autograd.grad(objective(out, aux), [*leaves, tx])
    ref_gp, ref_gx = jax.grad(lambda p, xx: objective(*ref_common.apply_moe(p, xx, ref_cfg)),
                              argnums=(0, 1))(ref_p, jnp.asarray(x))
    got = {n: g.numpy() for n, g in zip(names, grads)}
    got["x"] = grads[-1].numpy()
    assert_grads_close(got, {**dict(named_leaves(ref_gp)), "x": ref_gx})


def test_zero_router_picks_the_first_experts(monkeypatch):
    """Every probability equal: ``jax.lax.top_k`` picks experts 0..K-1 for
    every token, and so must the port (``torch.topk`` promises no order
    among ties)."""
    ref_cfg, ref_p, cfg, params = moe_pair(zero_router=True, capacity_factor=1.25)
    x = inputs()
    ref_out, ref_aux, ref_top_e, ref_keep, _ = reference_routing(ref_p, ref_cfg, x,
                                                                 monkeypatch)
    top_e, keep, _ = port_routing(params, cfg, x)
    first = np.broadcast_to(np.arange(cfg.top_k), top_e.shape)
    assert np.array_equal(ref_top_e, first) and np.array_equal(top_e, first)
    assert np.array_equal(keep, ref_keep) and not keep.all()  # experts 0 and 1 overflow
    out, aux = common.apply_moe(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    assert float(aux) == float(ref_aux) == 1.0  # E * (1 / E): the least it can be


# the reference's MoE property tests (tests/test_models.py), on the port
def port_moe(**kw):
    cfg = moe_cfgs(d_model=16, num_experts=4, moe_d_ff=32, d_ff=32, **kw)[1]
    return cfg, ParamTree(common.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu"))


def test_moe_identical_tokens_identical_outputs():
    cfg, p = port_moe()
    x = torch.randn((1, 1, 16), generator=torch.Generator().manual_seed(1)).expand(2, 8, 16)
    y, aux = common.apply_moe(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), np.broadcast_to(y[:1, :1].numpy(), y.shape),
                               rtol=2e-5, atol=2e-5)
    assert float(aux) >= 1.0 - 1e-6  # aux loss is >= 1 at any routing


def test_moe_capacity_drops_tokens():
    cfg, p = port_moe(capacity_factor=0.25)
    x = torch.randn((2, 16, 16), generator=torch.Generator().manual_seed(1))
    y, _ = common.apply_moe(p, x, cfg)
    assert torch.isfinite(y).all()
    _, _, top_e = common.moe_route(p["router"], x.reshape(-1, 16), cfg)
    assert not common.moe_slots(top_e, cfg)[1].all()


@pytest.mark.parametrize("cf", [8.0, 0.3])
def test_moe_gather_dispatch_equals_scatter(cf):
    """The permutation-gather dispatch (custom backward) is the scatter path:
    forward, parameter gradients and input gradients, with and without
    drops."""
    cfg0, p = port_moe(capacity_factor=cf, num_shared_experts=1)
    cfg1 = dataclasses.replace(cfg0, moe_gather_dispatch=True)
    p.requires_grad_(True)
    x = torch.randn((2, 8, 16), generator=torch.Generator().manual_seed(1), requires_grad=True)
    y0, a0 = common.apply_moe(p, x, cfg0)
    y1, a1 = common.apply_moe(p, x, cfg1)
    np.testing.assert_allclose(y0.detach().numpy(), y1.detach().numpy(), rtol=1e-5, atol=1e-6)
    assert float(a0.detach()) == float(a1.detach())
    leaves = [*p.parameters(), x]
    g0 = torch.autograd.grad((y0**2).sum(), leaves)
    g1 = torch.autograd.grad((y1**2).sum(), leaves)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# _perm_gather
# ---------------------------------------------------------------------------
class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def dispatch_maps(seed: int = 0, T: int = 10, K: int = 2, E: int = 4, cf: float = 0.6):
    """The index maps of a dispatch that drops assignments: ``(inv_tok,
    slot_tk, inv_flat, E * C)`` as ``apply_moe`` builds them."""
    rng = np.random.default_rng(seed)
    top_e = torch.from_numpy(np.stack([rng.choice(E, K, replace=False) for _ in range(T)]))
    cfg = moe_cfgs(num_experts=E, top_k=K, capacity_factor=cf)[1]
    order, keep, slot, C = common.moe_slots(top_e, cfg)
    assert not keep.all()
    S = T * K
    stok = torch.arange(T).repeat_interleave(K)[order]
    inv_tok = torch.full((E * C + 1,), T, dtype=torch.int64)
    inv_tok[slot] = stok
    slot_tk = torch.full((S,), E * C, dtype=torch.int64)
    slot_tk[order] = slot
    inv_flat = torch.full((E * C + 1,), S, dtype=torch.int64)
    inv_flat[slot] = order
    return inv_tok[: E * C], slot_tk.reshape(T, K), inv_flat[: E * C], E * C


@pytest.mark.parametrize("k_axis", [0, -1])
def test_perm_gather_vjp_matches_reference(k_axis):
    """Forward and VJP against ``jax.vjp`` of the reference's
    ``_perm_gather``; backward runs gathers only, the pad row and every
    source row that feeds nothing get a zero gradient."""
    inv_tok, slot_tk, inv_flat, EC = dispatch_maps()
    T, K = slot_tk.shape
    if k_axis == 0:  # dispatch: tokens (plus a pad row) into the expert buffer
        idx, inv_idx, n_src = inv_tok, slot_tk, T + 1
    else:  # combine: the buffer (plus a pad row) back to each token's K slots
        idx, inv_idx, n_src = slot_tk.reshape(-1), inv_flat, EC + 1
    rng = np.random.default_rng(1)
    src = rng.normal(size=(n_src, 6)).astype(np.float32)
    src[-1] = 0.0
    g = rng.normal(size=(idx.shape[0], 6)).astype(np.float32)
    ref_out, vjp = jax.vjp(lambda s: ref_common._perm_gather(
        s, jnp.asarray(idx.numpy()), jnp.asarray(inv_idx.numpy()), k_axis), jnp.asarray(src))
    (ref_dsrc,) = vjp(jnp.asarray(g))
    tsrc = torch.from_numpy(src).requires_grad_(True)
    out = common._perm_gather(tsrc, idx, inv_idx, k_axis)
    assert np.array_equal(out.detach().numpy(), np.asarray(ref_out))
    with OpCount() as ops:
        (dsrc,) = torch.autograd.grad(out, tsrc, torch.from_numpy(g))
    assert not {"index_put", "index_put_", "index_add", "index_add_", "scatter",
                "scatter_add", "scatter_add_"} & set(ops.counts), ops.counts
    np.testing.assert_allclose(dsrc.numpy(), np.asarray(ref_dsrc), rtol=1e-6, atol=1e-6)
    assert not dsrc[-1].any()
    fed = set(idx.tolist())
    assert all(not dsrc[i].any() for i in range(n_src) if i not in fed)


# ---------------------------------------------------------------------------
# apply_mla
# ---------------------------------------------------------------------------
def mla_pair(**kw):
    """DeepSeek-V2's MLA at reduced widths, float32, on the same weights."""
    arch = "deepseek-v2-236b"
    ref_cfg = dataclasses.replace(ref_reduced(REF_ARCHS[arch]), compute_dtype="float32", **kw)
    cfg = dataclasses.replace(reduced(ARCHS[arch]), compute_dtype="float32", **kw)
    tree = jax.tree.map(np.asarray, ref_blocks.init_mla(jax.random.PRNGKey(4), ref_cfg))
    rng = np.random.default_rng(5)
    for name in ("q_norm", "kv_norm"):  # norm weights off their constant ones
        tree[name] = tree[name] + rng.normal(0.0, 0.1, tree[name].shape).astype(np.float32)
    params = convert.load_params(
        ParamTree(blocks.init_mla(torch.Generator().manual_seed(0), cfg, device="cpu")), tree)
    return ref_cfg, jax.tree.map(jnp.asarray, tree), cfg, params


@pytest.mark.parametrize("chunk", [0, 4], ids=["whole", "chunked"])
def test_apply_mla_prefill_matches_reference(chunk):
    ref_cfg, ref_p, cfg, params = mla_pair(attn_q_chunk=chunk)
    x = inputs((2, 16, cfg.d_model))
    positions = np.broadcast_to(np.arange(16), (2, 16))
    want, _ = ref_blocks.apply_mla(ref_p, jnp.asarray(x), ref_cfg,
                                   ref_blocks.Ctx(positions=jnp.asarray(positions)))
    got, cache = blocks.apply_mla(params, torch.from_numpy(x), cfg,
                                  blocks.Ctx(positions=torch.from_numpy(positions.copy())))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("max_len", [16, 4], ids=["in-cache", "past-max-len"])
def test_apply_mla_absorbed_decode_matches_reference(max_len):
    """Every step's output and the compressed cache after it; past
    ``max_len`` the write clamps to the last slot, as the reference's
    ``dynamic_update_slice`` clamps it."""
    ref_cfg, ref_p, cfg, params = mla_pair()
    B, steps = 2, 7 if max_len < 16 else 16
    x = inputs((B, steps, cfg.d_model), seed=6)
    ref_cache = ref_blocks.init_mla_cache(ref_cfg, B, max_len)
    cache = blocks.init_mla_cache(cfg, B, max_len, device="cpu")
    for t in range(steps):
        want, ref_cache = ref_blocks.apply_mla(ref_p, jnp.asarray(x[:, t : t + 1]), ref_cfg,
                                               ref_blocks.Ctx(pos=jnp.int32(t)), ref_cache)
        got, new = blocks.apply_mla(params, torch.from_numpy(x[:, t : t + 1]), cfg,
                                    blocks.Ctx(pos=t), cache)
        assert new["ckv"] is cache["ckv"] and new["kr"] is cache["kr"]  # written in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=str(t))
        for name in ("ckv", "kr"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(ref_cache[name]), **TOL)
    if max_len < steps:  # the last slot holds the last position written
        assert cache["ckv"][:, -1].any()


def test_absorbed_decode_reproduces_the_prefill():
    """The decode path at every position against the full-sequence path of
    the port itself (the reference's own decode-vs-forward check, on one
    block)."""
    _, _, cfg, params = mla_pair()
    x = torch.from_numpy(inputs((2, 12, cfg.d_model), seed=7))
    full, _ = blocks.apply_mla(params, x, cfg,
                               blocks.Ctx(positions=torch.arange(12).expand(2, 12)))
    cache = blocks.init_mla_cache(cfg, 2, 12, device="cpu")
    dec = torch.cat([blocks.apply_mla(params, x[:, t : t + 1], cfg, blocks.Ctx(pos=t), cache)[0]
                     for t in range(12)], 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **TOL)
