"""The port's language-model scaffolding against the JAX package's.

Parameter and cache trees must have the reference's names, shapes and dtypes
for all ten architectures, at reduced size and at full width (the port on
the ``meta`` device, the reference through ``jax.eval_shape``; neither
allocates).  On the dense decoders, the two MoE architectures (MLA and
GQA), Jamba (Mamba, attention and MoE) and xLSTM the port runs the
reference's weights, carried over by
:func:`repro_torch.models.convert.load_params` (JAX and torch draw different
numbers from one seed), in float32: ``forward`` logits, its MoE aux loss and
step-by-step ``decode_step`` logits must equal the reference's within
``rtol = atol = 1e-4`` and the greedy tokens of ``make_serve_step`` must be
the same.  The primitives are held one by one, and the cache write past
``max_len`` must clamp as the reference's.  Cross-attention, the encoder
and the cross caches are held in ``tests/test_torch_cross.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import reduced as ref_reduced
from repro.configs import runnable_shapes as ref_runnable_shapes
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro.serving.serve import make_serve_step as ref_make_serve_step
from repro_torch.configs import ARCHS, SHAPES, reduced, runnable_shapes
from repro_torch.distributed.checkpoint import named_leaves
from repro_torch.models import blocks, common, convert
from repro_torch.models.model import decode_step, forward, init_cache, init_model
from repro_torch.serving.serve import make_prefill, make_serve_step
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

#: the dense decoders, the MoE architectures and the recurrent ones (the
#: Mamba hybrid Jamba, with MoE layers, and xLSTM), which the port runs end
#: to end
DENSE = ["deepseek-coder-33b", "granite-8b", "qwen2.5-3b", "yi-34b"]
MOE = ["deepseek-v2-236b", "kimi-k2-1t-a32b"]
RECURRENT = ["jamba-v0.1-52b", "xlstm-1.3b"]
#: float32 parity: both frameworks sum the same float32 products in their
#: own order, over widths of at most 128 and two periods
TOL = dict(rtol=1e-4, atol=1e-4)
B, L = 2, 16


def ref_names(tree) -> dict[str, tuple]:
    """The reference's ``path -> (shape, dtype)`` of a (possibly abstract) tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in flat:
        name = "::".join(str(p.key) if isinstance(p, jax.tree_util.DictKey) else str(p.idx)
                         for p in path)
        out[name] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def port_names(tree) -> dict[str, tuple]:
    return {name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for name, t in named_leaves(tree)}


def cpu_gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_configs_match_reference(arch):
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for port_cfg, ref_cfg in ((ARCHS[arch], REF_ARCHS[arch]),
                              (reduced(ARCHS[arch]), ref_reduced(REF_ARCHS[arch])),
                              (reduced(ARCHS[arch], periods=1),
                               ref_reduced(REF_ARCHS[arch], periods=1))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        assert (port_cfg.head_dim, port_cfg.n_periods, port_cfg.is_subquadratic) == \
            (ref_cfg.head_dim, ref_cfg.n_periods, ref_cfg.is_subquadratic)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    assert sorted(runnable_shapes(ARCHS[arch])) == sorted(ref_runnable_shapes(REF_ARCHS[arch]))


@pytest.mark.parametrize("scale", ["reduced", "full"])
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_param_tree_matches_reference(arch, scale):
    """Names, shapes and dtypes of every parameter, and their order (the
    order the archive writes shards in)."""
    ref_cfg, cfg = REF_ARCHS[arch], ARCHS[arch]
    if scale == "reduced":
        ref_cfg, cfg = ref_reduced(ref_cfg), reduced(cfg)
    want = ref_names(jax.eval_shape(lambda k: ref_model.init_model(k, ref_cfg),
                                    jax.random.PRNGKey(0)))
    model = init_model(cpu_gen(), cfg, device="cpu" if scale == "reduced" else "meta")
    got = port_names(model)
    assert list(got) == list(want)
    assert got == want
    assert {n.replace(".", "::") for n, _ in model.named_parameters()} == set(want)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_cache_tree_matches_reference(arch):
    ref_cfg, cfg = ref_reduced(REF_ARCHS[arch]), reduced(ARCHS[arch])
    want = ref_names(jax.eval_shape(lambda: ref_model.init_cache(ref_cfg, 3, 20)))
    got = port_names(init_cache(cfg, 3, 20, device="cpu"))
    assert list(got) == list(want)
    assert got == want


def perturbed(params, seed: int = 5):
    """The reference's parameters as numpy, with its constant leaves (norm
    weights of ones, biases of zeros) moved off their constants so that
    they matter to the comparison."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.flat[0]):
            a = a + rng.normal(0.0, 0.1, a.shape).astype(a.dtype)
        return a

    return jax.tree.map(move, params)


@pytest.fixture(scope="module", params=DENSE + MOE + RECURRENT)
def dense(request):
    """A decoder (dense, MoE at the config's own capacity factor, or
    recurrent) in float32 in both packages, on the same weights."""
    arch = request.param
    ref_cfg = dataclasses.replace(ref_reduced(REF_ARCHS[arch]), compute_dtype="float32")
    cfg = dataclasses.replace(reduced(ARCHS[arch]), compute_dtype="float32")
    tree = perturbed(ref_model.init_model(jax.random.PRNGKey(0), ref_cfg))
    model = convert.load_params(init_model(cpu_gen(), cfg, device="cpu"), tree)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    return dict(arch=arch, ref_cfg=ref_cfg, cfg=cfg, ref_params=jax.tree.map(jnp.asarray, tree),
                model=model, tokens=tokens)


def test_forward_matches_reference(dense):
    ref_logits, ref_aux = jax.jit(ref_model.forward, static_argnums=1)(
        dense["ref_params"], dense["ref_cfg"], jnp.asarray(dense["tokens"]))
    logits, aux = forward(dense["model"], dense["cfg"], torch.from_numpy(dense["tokens"]))
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), **TOL)
    assert (float(aux) > 0) == (dense["cfg"].num_experts > 0)
    prefill = make_prefill(dense["cfg"])(dense["model"], torch.from_numpy(dense["tokens"]))
    assert torch.equal(prefill, logits)


def test_decode_matches_reference(dense):
    """Every step's logits, and the cache after the last step."""
    ref_step = jax.jit(ref_model.decode_step, static_argnums=1)
    ref_cache = ref_model.init_cache(dense["ref_cfg"], B, L)
    cache = init_cache(dense["cfg"], B, L, device="cpu")
    for t in range(L):
        ref_lg, ref_cache = ref_step(dense["ref_params"], dense["ref_cfg"],
                                     jnp.asarray(dense["tokens"][:, t : t + 1]), ref_cache,
                                     jnp.int32(t))
        lg, cache = decode_step(dense["model"], dense["cfg"],
                                torch.from_numpy(dense["tokens"][:, t : t + 1]), cache, t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL)
    ref_leaves = dict(zip(ref_names(ref_cache), jax.tree.leaves(ref_cache)))
    for name, leaf in named_leaves(cache):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref_leaves[name]), **TOL)


def test_greedy_tokens_match_reference(dense):
    """Teacher-forced over a 4-token prompt, then 8 greedy steps."""
    prompt, steps = 4, 8
    ref_serve = jax.jit(ref_make_serve_step(dense["ref_cfg"]))
    serve = make_serve_step(dense["cfg"])
    ref_cache = ref_model.init_cache(dense["ref_cfg"], B, prompt + steps)
    cache = init_cache(dense["cfg"], B, prompt + steps, device="cpu")
    ref_tok = jnp.asarray(dense["tokens"][:, :1])
    tok = torch.from_numpy(dense["tokens"][:, :1])
    ref_out, out = [], []
    for t in range(prompt + steps):
        ref_next, _, ref_cache = ref_serve(dense["ref_params"], ref_cache, ref_tok, jnp.int32(t))
        nxt, _, cache = serve(dense["model"], cache, tok, t)
        assert nxt.dtype == torch.int32 and nxt.shape == (B, 1)
        if t + 1 < prompt:
            ref_tok = jnp.asarray(dense["tokens"][:, t + 1 : t + 2])
            tok = torch.from_numpy(dense["tokens"][:, t + 1 : t + 2])
        else:
            ref_tok, tok = ref_next, nxt
            ref_out.append(np.asarray(ref_next))
            out.append(nxt.numpy())
    assert np.array_equal(np.concatenate(out, 1), np.concatenate(ref_out, 1))
    assert len(out) == steps + 1


def test_cache_write_clamps_past_max_len():
    """``dynamic_update_slice`` clamps the write position into the cache, so
    decoding at ``pos >= max_len`` overwrites the last slot; the port does
    the same (torch indexing would raise)."""
    arch = "qwen2.5-3b"
    ref_cfg = dataclasses.replace(ref_reduced(REF_ARCHS[arch]), compute_dtype="float32")
    cfg = dataclasses.replace(reduced(ARCHS[arch]), compute_dtype="float32")
    tree = perturbed(ref_model.init_model(jax.random.PRNGKey(1), ref_cfg))
    model = convert.load_params(init_model(cpu_gen(), cfg, device="cpu"), tree)
    ref_params = jax.tree.map(jnp.asarray, tree)
    max_len = 4
    ref_cache = ref_model.init_cache(ref_cfg, B, max_len)
    cache = init_cache(cfg, B, max_len, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 7)).astype(np.int32)
    ref_step = jax.jit(ref_model.decode_step, static_argnums=1)
    for t in range(7):
        ref_lg, ref_cache = ref_step(ref_params, ref_cfg, jnp.asarray(tokens[:, t : t + 1]),
                                     ref_cache, jnp.int32(t))
        lg, cache = decode_step(model, cfg, torch.from_numpy(tokens[:, t : t + 1]), cache, t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL)
    k = cache["periods"]["l0"]["mix"]["k"]
    np.testing.assert_allclose(k.numpy(), np.asarray(ref_cache["periods"]["l0"]["mix"]["k"]),
                               **TOL)
    # slots 0..2 hold positions 0..2, the last slot the last position written
    assert not torch.equal(k[:, :, max_len - 1], torch.zeros_like(k[:, :, max_len - 1]))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def both(x: np.ndarray, dtype: str):
    """One float32 array in both frameworks, rounded to ``dtype`` by each
    (both round to nearest even)."""
    return jnp.asarray(x, dtype=dtype), torch.from_numpy(x).to(common.DTYPES[dtype])


def as_np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t.astype(jnp.float32))


#: tolerance per dtype: float32 sums in another order; bfloat16 a few ulps
#: of 2**-7 where the values are about 1
DTYPE_TOL = {"float32": TOL, "bfloat16": dict(rtol=2e-2, atol=3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    jx, tx = both(rng.normal(0, 2.0, (3, 5, 64)).astype(np.float32), dtype)
    jw, tw = both(rng.normal(1, 0.1, 64).astype(np.float32), "float32")
    got, want = common.rms_norm(tx, tw), ref_common.rms_norm(jx, jw)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_allclose(as_np(got), as_np(want), **DTYPE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(1)
    positions = np.arange(2 * 9).reshape(2, 9) * 37
    jcos, jsin = ref_common.rope_freqs(jnp.asarray(positions), 32, 1_000_000.0)
    cos, sin = common.rope_freqs(torch.from_numpy(positions), 32, 1_000_000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=1e-5, atol=1e-5)
    jx, tx = both(rng.normal(size=(2, 9, 3, 32)).astype(np.float32), dtype)
    got, want = common.apply_rope(tx, cos, sin), ref_common.apply_rope(jx, jcos, jsin)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_allclose(as_np(got), as_np(want), **DTYPE_TOL[dtype])


ATTENTION = {
    "causal": dict(),
    "not-causal": dict(causal=False),
    "offset": dict(q_offset=5, Lq=3),
    "mha": dict(Hkv=4),
    "bf16-scores": dict(scores_f32=False, dtype="bfloat16"),
    "bf16-f32-scores": dict(dtype="bfloat16"),
    "chunked": dict(chunk=4),
    "chunked-bf16-scores": dict(chunk=4, scores_f32=False, dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(ATTENTION))
def test_causal_attention_matches_reference(case):
    kw = dict(ATTENTION[case])
    dtype, chunk = kw.pop("dtype", "float32"), kw.pop("chunk", None)
    Lq, Hkv = kw.pop("Lq", 12), kw.pop("Hkv", 2)
    rng = np.random.default_rng(2)
    jq, tq = both(rng.normal(size=(2, Lq, 4, 16)).astype(np.float32), dtype)
    jk, tk = both(rng.normal(size=(2, 12, Hkv, 16)).astype(np.float32), dtype)
    jv, tv = both(rng.normal(size=(2, 12, Hkv, 16)).astype(np.float32), dtype)
    if chunk:
        got = common.chunked_causal_attention(tq, tk, tv, scale=0.25, chunk=chunk, **kw)
        want = ref_common.chunked_causal_attention(jq, jk, jv, scale=0.25, chunk=chunk, **kw)
        assert torch.allclose(got, common.causal_attention(tq, tk, tv, scale=0.25, **kw),
                              **DTYPE_TOL[dtype])
    else:
        got = common.causal_attention(tq, tk, tv, scale=0.25, **kw)
        want = ref_common.causal_attention(jq, jk, jv, scale=0.25, **kw)
    assert got.shape == want.shape
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_allclose(as_np(got), as_np(want), **DTYPE_TOL[dtype])


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm", "xattn"])
def test_recurrent_mixers_are_ported(kind):
    """The Mamba and xLSTM paths (ROADMAP A9.2, A9.3) and cross-attention
    (A9.4), refused until they were ported, map to their apply functions;
    the ``dense`` fixture runs Jamba and xLSTM against the reference, and
    ``tests/test_torch_cross.py`` the two cross-attention architectures."""
    assert blocks.MIXER_APPLY[kind] is getattr(blocks, f"apply_{kind}")


def test_load_params_refuses_a_mismatched_tree_by_name():
    cfg = reduced(ARCHS["granite-8b"])
    tree = jax.tree.map(np.asarray, ref_model.init_model(jax.random.PRNGKey(0),
                                                         ref_reduced(REF_ARCHS["granite-8b"])))
    model = init_model(cpu_gen(), cfg, device="cpu")
    before = model.embed.clone()
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match=r"missing \['lm_head'\], extra \[\]"):
        convert.load_params(model, missing)
    with pytest.raises(ValueError, match=r"missing \[\], extra \['head'\]"):
        convert.load_params(model, {**tree, "head": tree["lm_head"]})
    wrong = {**tree, "final_norm": np.ones(3, np.float32)}
    with pytest.raises(ValueError, match=r"final_norm: \(3,\) torch.float32 for \(64,\)"):
        convert.load_params(model, wrong)
    wrong = {**tree, "final_norm": tree["final_norm"].astype(np.float64)}
    with pytest.raises(ValueError, match=r"final_norm: \(64,\) torch.float64"):
        convert.load_params(model, wrong)
    assert torch.equal(model.embed, before)  # nothing copied
    convert.load_params(model, tree)
    assert np.array_equal(model.embed.numpy(), tree["embed"])


def test_init_on_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
        init_model(cpu_gen(), reduced(ARCHS["qwen2.5-3b"]))
    with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
        init_cache(reduced(ARCHS["qwen2.5-3b"]), 1, 4)
