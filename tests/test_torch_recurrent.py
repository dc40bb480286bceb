"""The port's recurrent mixers (Mamba, mLSTM, sLSTM) against the JAX package's.

Both packages run the reference's weights (carried into the port by
``models/convert.load_params``; JAX and torch draw different numbers from
one seed) in float32 on the CPU.  Outputs and decode states are held within
``rtol = atol = 1e-4``, as ``tests/test_torch_moe.py`` holds the MoE, and
gradients within 1e-5 of each leaf's largest element.  The Mamba scan within
a chunk sums in another order than ``jax.lax.associative_scan`` (a
Hillis-Steele sweep against an odd-even recursion, both in float32); at
these widths and lengths the drift stays inside the same bounds, so no
looser one is needed.

Decode writes every recurrent state into the cache it was given (the port's
``decode_step`` hands back that cache), and a single stacked period is a
view of its draw: both are checked here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import blocks as ref_blocks
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed.checkpoint import named_leaves
from repro_torch.models import blocks, convert
from repro_torch.models.model import ParamTree, _stacked, decode_step, forward, init_cache, \
    init_model
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 1e-5
#: each mixer and the architecture whose reduced config it is drawn from
MIXERS = {"mamba": "jamba-v0.1-52b", "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b"}


def cfgs(kind: str, **kw):
    """A mixer's reduced config in float32 in both packages."""
    arch = MIXERS[kind]
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(ref_reduced(REF_ARCHS[arch]), **kw),
            dataclasses.replace(reduced(ARCHS[arch]), **kw))


def mixer_pair(kind: str, seed: int = 4, **kw):
    """``(ref_cfg, ref_params, cfg, port params)`` of one mixer on the same
    weights; the constant leaves (biases of zeros, norm weights of ones,
    ``D_skip``) are moved off their constants so that they matter."""
    ref_cfg, cfg = cfgs(kind, **kw)
    tree = jax.tree.map(np.asarray, ref_blocks.MIXER_INIT[kind](jax.random.PRNGKey(seed),
                                                                ref_cfg))
    rng = np.random.default_rng(5)
    for name, a in tree.items():
        if a.size > 1 and np.all(a == a.flat[0]):
            tree[name] = a + rng.normal(0.0, 0.1, a.shape).astype(a.dtype)
    params = convert.load_params(
        ParamTree(blocks.MIXER_INIT[kind](torch.Generator().manual_seed(0), cfg,
                                          device="cpu")), tree)
    return ref_cfg, jax.tree.map(jnp.asarray, tree), cfg, params


def ref_cache_of(kind: str, ref_cfg, B: int):
    return getattr(ref_blocks, f"init_{kind}_cache")(ref_cfg, B)


def cache_of(kind: str, cfg, B: int):
    return getattr(blocks, f"init_{kind}_cache")(cfg, B, device="cpu")


def inputs(shape, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def assert_grads_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(got[name] - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()) + 1e-30, (name, err)


def check_full_sequence(kind: str, L: int, **kw):
    """Output of the full-sequence path, then the gradients of ``sum(y**2)``
    with respect to every parameter and the input."""
    ref_cfg, ref_p, cfg, params = mixer_pair(kind, **kw)
    apply, ref_apply = blocks.MIXER_APPLY[kind], ref_blocks.MIXER_APPLY[kind]
    x = inputs((2, L, cfg.d_model))
    want, _ = ref_apply(ref_p, jnp.asarray(x), ref_cfg, ref_blocks.Ctx())
    params.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got, cache = apply(params, tx, cfg, blocks.Ctx())
    assert cache is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    names, leaves = zip(*named_leaves(params))
    grads = torch.autograd.grad((got**2).sum(), [*leaves, tx])
    ref_gp, ref_gx = jax.grad(
        lambda p, xx: (ref_apply(p, xx, ref_cfg, ref_blocks.Ctx())[0] ** 2).sum(),
        argnums=(0, 1))(ref_p, jnp.asarray(x))
    got_g = {n: g.numpy() for n, g in zip(names, grads)}
    got_g["x"] = grads[-1].numpy()
    assert_grads_close(got_g, {**dict(named_leaves(ref_gp)), "x": ref_gx})
    return got.detach()


def check_decode(kind: str, steps: int, **kw):
    """Every decode step's output and the whole state after it, the state
    written into the cache tensors the step was given."""
    ref_cfg, ref_p, cfg, params = mixer_pair(kind, **kw)
    apply, ref_apply = blocks.MIXER_APPLY[kind], ref_blocks.MIXER_APPLY[kind]
    B = 2
    x = inputs((B, steps, cfg.d_model), seed=6)
    ref_cache, cache = ref_cache_of(kind, ref_cfg, B), cache_of(kind, cfg, B)
    tensors = dict(cache)
    outs = []
    for t in range(steps):
        want, ref_cache = ref_apply(ref_p, jnp.asarray(x[:, t : t + 1]), ref_cfg,
                                    ref_blocks.Ctx(pos=jnp.int32(t)), ref_cache)
        got, new = apply(params, torch.from_numpy(x[:, t : t + 1]), cfg, blocks.Ctx(pos=t),
                         cache)
        assert new is cache and all(cache[k] is v for k, v in tensors.items())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=str(t))
        assert sorted(cache) == sorted(ref_cache)
        for name in cache:
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(ref_cache[name]),
                                       **TOL, err_msg=f"{name} at {t}")
        outs.append(got)
    return params, cfg, x, torch.cat(outs, 1)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("state", [False, True], ids=["zero-pad", "streamed"])
def test_conv1d_causal_matches_reference(state):
    _, _, cfg, params = mixer_pair("mamba")
    dI = cfg.mamba_expand * cfg.d_model
    u = inputs((2, 7, dI))
    s = inputs((2, cfg.mamba_d_conv - 1, dI), seed=4) if state else None
    want, want_state = ref_blocks._conv1d_causal(
        jnp.asarray(u), jnp.asarray(params["conv_w"].numpy()),
        jnp.asarray(params["conv_b"].numpy()), None if s is None else jnp.asarray(s))
    got, got_state = blocks._conv1d_causal(
        torch.from_numpy(u), params["conv_w"], params["conv_b"],
        None if s is None else torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


def test_mamba_ssm_inputs_match_reference():
    """``dA``, ``dBu`` and ``C``, with inputs large enough that some ``dt``
    pre-activations pass 20, where ``F.softplus`` would return its argument
    and the port's ``logaddexp(x, 0)`` (the reference's softplus) does not."""
    ref_cfg, ref_p, cfg, params = mixer_pair("mamba")
    u = 40.0 * inputs((2, 8, cfg.mamba_expand * cfg.d_model))
    dt_rank = params["dt_proj"].shape[0]
    pre = (torch.from_numpy(u) @ params["x_proj"])[..., :dt_rank] @ params["dt_proj"]
    assert bool((pre > 20).any())
    want = ref_blocks._mamba_ssm_inputs(ref_p, jnp.asarray(u), ref_cfg)
    got = blocks._mamba_ssm_inputs(params, torch.from_numpy(u), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


#: (mamba_chunk, L): one chunk; four chunks carrying ``h0`` across each
#: boundary; a chunk longer than the sequence (the whole sequence one chunk)
CHUNKS = {"chunk=L": (16, 16), "L=4*chunk": (4, 16), "chunk>L": (32, 12)}


@pytest.mark.parametrize("case", sorted(CHUNKS))
def test_apply_mamba_full_sequence_matches_reference(case):
    chunk, L = CHUNKS[case]
    check_full_sequence("mamba", L, mamba_chunk=chunk)


def test_apply_mamba_refuses_a_chunk_that_does_not_divide_the_sequence():
    """The reference asserts ``L % chunk == 0`` on the full-sequence path
    (prefill and training); so does the port."""
    _, _, cfg, params = mixer_pair("mamba", mamba_chunk=8)
    with pytest.raises(AssertionError):
        blocks.apply_mamba(params, torch.zeros((1, 12, cfg.d_model)), cfg, blocks.Ctx())


def test_apply_mamba_decode_matches_reference():
    check_decode("mamba", steps=10)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_full_sequence_matches_reference(kind):
    check_full_sequence(kind, 16)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_decode_matches_reference(kind):
    check_decode(kind, steps=12)


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_decode_reproduces_the_full_sequence(kind):
    """The recurrent form at every step against the port's own full-sequence
    form, for each mixer (the Mamba one over three chunks)."""
    params, cfg, x, dec = check_decode(kind, steps=12, mamba_chunk=4)
    full, _ = blocks.MIXER_APPLY[kind](params, torch.from_numpy(x), cfg, blocks.Ctx())
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **TOL)


def test_mlstm_masked_exponent_gradient_matches_reference():
    """A reference behaviour that carries over: the parallel mLSTM computes
    ``exp(a[s] - amax[t])`` for ``s > t`` too and masks it with ``where``.
    Once the sequence outlasts about 128 steps (``-log_f`` is about 0.69 a
    step at init) a masked entry overflows to ``inf``; the output does not
    see it, but its gradient is ``0 * inf``: the gate weights' and the
    input's gradients are NaN in both packages, and the other leaves'
    gradients agree."""
    ref_cfg, ref_p, cfg, params = mixer_pair("mlstm")
    x = inputs((2, 160, cfg.d_model))
    want, (ref_gp, ref_gx) = jax.value_and_grad(
        lambda p, xx: (ref_blocks.apply_mlstm(p, xx, ref_cfg, ref_blocks.Ctx())[0] ** 2).sum(),
        argnums=(0, 1))(ref_p, jnp.asarray(x))
    params.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = (blocks.apply_mlstm(params, tx, cfg, blocks.Ctx())[0] ** 2).sum()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    names, leaves = zip(*named_leaves(params))
    grads = dict(zip([*names, "x"], torch.autograd.grad(got, [*leaves, tx])))
    want_g = {**dict(named_leaves(ref_gp)), "x": ref_gx}
    nan = {n for n, g in want_g.items() if not np.isfinite(np.asarray(g)).all()}
    assert nan == {"w_if", "b_if", "x"}
    assert {n for n, g in grads.items() if not bool(torch.isfinite(g).all())} == nan
    assert_grads_close({n: g.numpy() for n, g in grads.items() if n not in nan},
                       {n: g for n, g in want_g.items() if n not in nan})


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_float64_mixer_decodes_its_full_sequence_to_float64_rounding(kind):
    """In a float64 model each recurrent mixer computes in float64 (gates,
    scan and state, where the reference widens to float32): decode
    reproduces the full sequence (the Mamba one over three chunks) within
    1e-10, where a float32 step would leave ~1e-7."""
    cfg = dataclasses.replace(reduced(ARCHS[MIXERS[kind]]), compute_dtype="float64",
                              param_dtype="float64", mamba_chunk=4)
    params = ParamTree(blocks.MIXER_INIT[kind](torch.Generator().manual_seed(0), cfg,
                                               device="cpu"))
    apply, L = blocks.MIXER_APPLY[kind], 12
    x = torch.from_numpy(inputs((2, L, cfg.d_model))).double()
    cache = cache_of(kind, cfg, 2)
    assert {t.dtype for t in cache.values()} == {torch.float64}
    with torch.no_grad():
        full, _ = apply(params, x, cfg, blocks.Ctx())
        dec = torch.cat([apply(params, x[:, t : t + 1], cfg, blocks.Ctx(pos=t), cache)[0]
                         for t in range(L)], 1)
    assert full.dtype == dec.dtype == torch.float64
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# the model: in-place decode, the single-period stack, float64
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_decode_step_writes_the_stacked_states_in_place(arch):
    """``decode_step`` returns the cache it was given, with every recurrent
    state tensor of the stack the same object, changed by the step."""
    cfg = dataclasses.replace(reduced(ARCHS[arch]), compute_dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = init_cache(cfg, 2, 4, device="cpu")
    before = {n: (t, t.clone()) for n, t in named_leaves(cache)}
    states = [n for n in before if n.rsplit("::", 1)[1] in ("conv", "ssm", "m", "C", "n",
                                                            "c", "h")]
    assert states
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 2)).astype(np.int32))
    for t in range(2):
        _, out = decode_step(model, cfg, tokens[:, t : t + 1], cache, t)
        assert out is cache
    after = dict(named_leaves(cache))
    for name in states:
        tensor, old = before[name]
        assert after[name] is tensor, name
        assert not torch.equal(tensor, old), name


def test_stacked_single_period_shares_its_draw():
    """One period is stacked as a view of its draw (Jamba's period is 47.5
    GiB: a copy would not fit the card beside it); two are copied."""
    draws = []

    def make():
        draws.append({"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}})
        return draws[-1]

    one = _stacked(make, 1)
    assert one["a"].shape == (1, 2, 3) and one["b"]["c"].shape == (1, 4)
    assert one["a"].data_ptr() == draws[0]["a"].data_ptr()
    assert one["b"]["c"].data_ptr() == draws[0]["b"]["c"].data_ptr()
    two = _stacked(make, 2)
    assert two["a"].shape == (2, 2, 3)
    assert all(two["a"].data_ptr() != d["a"].data_ptr() for d in draws[1:])
    assert torch.equal(two["a"][1], draws[2]["a"])


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_decode_matches_forward(arch):
    """The reference's own test (``tests/test_models.py``) on the port:
    step-by-step decode reproduces the full-sequence forward within 2e-3,
    with ``mamba_chunk = 8`` over 16 tokens (two chunks) and the capacity
    raised so that nothing drops."""
    cfg = dataclasses.replace(reduced(ARCHS[arch]), compute_dtype="float32", mamba_chunk=8,
                              capacity_factor=16.0)
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    B, L = 2, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, L), generator=torch.Generator().manual_seed(1))
    full, _ = forward(model, cfg, tokens)
    cache = init_cache(cfg, B, L, device="cpu")
    dec = torch.stack([decode_step(model, cfg, tokens[:, t : t + 1], cache, t)[0][:, 0]
                       for t in range(L)], dim=1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 2e-3, rel


def test_float64_xlstm_decode_matches_forward_to_float32_rounding():
    """The reduced xLSTM (16 layers) in float64, as ``chip_smoke.py`` phase
    12b checks xLSTM-1.3B at full width: decode reproduces the forward to
    the float32 rounding of the logits both return (rel < 1e-6; it is 0 on
    the CPU, where the float32 model's is 3.0e-05 over these 64 tokens)."""
    cfg = dataclasses.replace(reduced(ARCHS["xlstm-1.3b"]), compute_dtype="float64",
                              param_dtype="float64")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    B, L = 2, 64
    tokens = torch.randint(0, cfg.vocab_size, (B, L), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full, _ = forward(model, cfg, tokens)
        cache = init_cache(cfg, B, L, device="cpu")
        dec = torch.stack([decode_step(model, cfg, tokens[:, t : t + 1], cache, t)[0][:, 0]
                           for t in range(L)], dim=1)
    assert {t.dtype for _, t in named_leaves(cache)} == {torch.float64}
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 1e-6, rel
