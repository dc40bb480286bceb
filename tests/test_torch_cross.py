"""Cross-attention and the encoder-decoder path of the port against the JAX
package's.

Both packages run the reference's weights (carried into the port by
``models/convert.load_params``; JAX and torch draw different numbers from one
seed), their constant leaves (norm weights of ones, biases of zeros) moved off
their constants so that they matter, in float32 compute on the CPU, on inputs
drawn with numpy from fixed seeds.  ``apply_xattn`` is held on its own over
the full sequence and at decode, with and without the QKV bias; ``encode``
on the reduced SeamlessM4T; ``warm_cross_cache`` leaf by leaf, written in
place.  The reduced Llama-3.2-Vision (two periods of four attention layers
and one ``xattn`` layer) and SeamlessM4T (two encoder and two decoder
layers, each decoder layer with a cross-attention sub-block) are held in
forward with their memory, at every decode step after the caches are
warmed, in their greedy tokens, and in loss and every gradient under each
remat policy; and decoding against the cold (zero) cross caches, what the
reference's serving launcher does, gives the reference's logits.  On the
training launchers' zero frames a 24-layer encoder's gradients overflow in
both packages; the port's ``--frontend-seed`` trains it.

Tolerances: logits within ``rtol = atol = 1e-4`` (both frameworks sum the
same float32 products in their own order over widths of at most 128, as in
``tests/test_torch_models.py``); the loss within ``rtol = 1e-5`` and every
gradient within 1e-5 of its leaf's largest element, as
``tests/test_torch_training.py`` holds the dense decoders.
"""

import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.launch import train as ref_launch_train
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.serving.serve import make_serve_step as ref_make_serve_step
from repro.training import train_step as ref_train
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed.checkpoint import named_leaves
from repro_torch.launch import train as port_launch_train
from repro_torch.models import blocks, convert
from repro_torch.models.model import (
    decode_step,
    encode,
    forward,
    init_cache,
    init_model,
    warm_cross_cache,
)
from repro_torch.serving.serve import make_serve_step
from repro_torch.training import init_train_state, loss_fn
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

CROSS = ["llama-3.2-vision-90b", "seamless-m4t-large-v2"]
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 1e-5
REMAT = {"off": dict(remat=False, remat_policy="full"), "full": dict(remat=True),
         "dots": dict(remat=True, remat_policy="dots")}
B, L = 2, 16


def perturbed(params, seed: int = 5):
    """The reference's parameters as numpy, with its constant leaves moved
    off their constants."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.flat[0]):
            a = a + rng.normal(0.0, 0.1, a.shape).astype(a.dtype)
        return a

    return jax.tree.map(move, params)


def configs(arch: str, **overrides):
    kw = dict(compute_dtype="float32", **overrides)
    return (dataclasses.replace(ref_reduced(REF_ARCHS[arch]), **kw),
            dataclasses.replace(reduced(ARCHS[arch]), **kw))


def frontend(cfg, seed: int = 13) -> np.ndarray:
    """The frontend's embeddings ``[B, M, D]``: speech frames of an enc-dec
    model, projected patches of a VLM."""
    M = cfg.num_enc_frames or cfg.num_vision_tokens
    return np.random.default_rng(seed).normal(size=(B, M, cfg.d_model)).astype(np.float32)


def ref_ctx(memory):
    return ref_blocks.Ctx(memory=None if memory is None else jnp.asarray(memory))


def as_np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# apply_xattn on its own
# ---------------------------------------------------------------------------
def xattn_pair(qkv_bias: bool):
    """One cross-attention mixer's parameters in both packages."""
    ref_cfg, cfg = configs("llama-3.2-vision-90b", qkv_bias=qkv_bias)
    tree = perturbed(ref_blocks.init_attn(jax.random.PRNGKey(3), ref_cfg))
    assert ("bq" in tree) == qkv_bias
    return (ref_cfg, {k: jnp.asarray(v) for k, v in tree.items()}, cfg,
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_apply_xattn_full_sequence_matches_reference(qkv_bias):
    """Queries from 16 tokens against a memory of 24 (``Lq != Lk``), no mask,
    no RoPE; the full-sequence path hands back no cache."""
    ref_cfg, ref_p, cfg, p = xattn_pair(qkv_bias)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, L, cfg.d_model)).astype(np.float32)
    memory = frontend(cfg)
    want, want_cache = ref_blocks.apply_xattn(ref_p, jnp.asarray(x), ref_cfg,
                                              ref_ctx(memory))
    got, cache = blocks.apply_xattn(p, torch.from_numpy(x), cfg,
                                    blocks.Ctx(memory=torch.from_numpy(memory)))
    assert want_cache is None and cache is None
    assert got.shape == want.shape == (B, L, cfg.d_model)
    np.testing.assert_allclose(as_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_apply_xattn_decode_reads_the_cache_and_never_writes_it(qkv_bias):
    """One token against a cache of 24 keys and values: the memory is not
    read (the context holds none), the cache comes back as it was given."""
    ref_cfg, ref_p, cfg, p = xattn_pair(qkv_bias)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    kv = {name: rng.normal(size=(B, 24, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
          for name in ("k", "v")}
    want, want_cache = ref_blocks.apply_xattn(ref_p, jnp.asarray(x), ref_cfg, ref_ctx(None),
                                              cache={k: jnp.asarray(v) for k, v in kv.items()})
    cache = {k: torch.from_numpy(v.copy()) for k, v in kv.items()}
    got, got_cache = blocks.apply_xattn(p, torch.from_numpy(x), cfg, blocks.Ctx(), cache=cache)
    np.testing.assert_allclose(as_np(got), np.asarray(want), **TOL)
    assert got_cache is cache
    assert all(np.array_equal(cache[k].numpy(), kv[k]) for k in kv)
    assert all(np.array_equal(np.asarray(want_cache[k]), kv[k]) for k in kv)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=CROSS)
def cross(request):
    """A reduced cross-attention arch in float32 in both packages, on the same
    weights, with its tokens and its frontend's embeddings."""
    arch = request.param
    ref_cfg, cfg = configs(arch)
    tree = perturbed(ref_model.init_model(jax.random.PRNGKey(0), ref_cfg))
    model = convert.load_params(init_model(torch.Generator().manual_seed(0), cfg, device="cpu"),
                                tree)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    return dict(arch=arch, ref_cfg=ref_cfg, cfg=cfg, ref_params=jax.tree.map(jnp.asarray, tree),
                model=model, tokens=tokens, embeds=frontend(cfg))


def memories(c):
    """The memory the decoder attends to, in both packages: the encoder's
    output of an enc-dec model, the vision embeddings of a VLM."""
    if c["cfg"].enc_layers:
        return (jax.jit(ref_model.encode, static_argnums=1)(c["ref_params"], c["ref_cfg"],
                                                           jnp.asarray(c["embeds"])),
                encode(c["model"], c["cfg"], torch.from_numpy(c["embeds"])))
    return jnp.asarray(c["embeds"]), torch.from_numpy(c["embeds"])


def test_encode_matches_reference():
    """The reduced SeamlessM4T's encoder on random frames and on the
    training launcher's zero frames (all-zero rows through ``rms_norm``
    stay finite)."""
    ref_cfg, cfg = configs("seamless-m4t-large-v2")
    tree = perturbed(ref_model.init_model(jax.random.PRNGKey(0), ref_cfg))
    model = convert.load_params(init_model(torch.Generator().manual_seed(0), cfg, device="cpu"),
                                tree)
    ref_encode = jax.jit(ref_model.encode, static_argnums=1)
    for embeds in (frontend(cfg), np.zeros_like(frontend(cfg))):
        want = ref_encode(jax.tree.map(jnp.asarray, tree), ref_cfg, jnp.asarray(embeds))
        got = encode(model, cfg, torch.from_numpy(embeds))
        assert got.shape == (B, cfg.num_enc_frames, cfg.d_model) and got.dtype == torch.float32
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_warm_cross_cache_matches_reference(cross):
    """Every cache leaf equal to the reference's; the cache is written in
    place and handed back itself, the self-attention caches untouched."""
    ref_mem, mem = memories(cross)
    ref_cache = ref_model.warm_cross_cache(cross["ref_params"], cross["ref_cfg"],
                                           ref_model.init_cache(cross["ref_cfg"], B, L), ref_mem)
    cache = init_cache(cross["cfg"], B, L, device="cpu")
    before = dict(named_leaves(cache))
    got = warm_cross_cache(cross["model"], cross["cfg"], cache, mem)
    assert got is cache
    ref_leaves = dict(zip([n for n, _ in named_leaves(ref_cache)], jax.tree.leaves(ref_cache)))
    leaves = dict(named_leaves(cache))
    assert list(leaves) == list(ref_leaves)
    warmed = 0
    for name, leaf in leaves.items():
        assert leaf is before[name]
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref_leaves[name]), **TOL,
                                   err_msg=name)
        warmed += bool(leaf.any())
    # the stacked k and v of every xattn layer (VLM) or cross sub-block (enc-dec)
    pattern = cross["cfg"].block_pattern
    n_cross = pattern.count("xattn") if cross["cfg"].num_vision_tokens else len(pattern)
    assert warmed == 2 * n_cross


def test_forward_with_memory_matches_reference(cross):
    ref_mem, mem = memories(cross)
    ref_logits, _ = jax.jit(ref_model.forward, static_argnums=1)(
        cross["ref_params"], cross["ref_cfg"], jnp.asarray(cross["tokens"]), memory=ref_mem)
    logits, aux = forward(cross["model"], cross["cfg"], torch.from_numpy(cross["tokens"]),
                          memory=mem)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)


def check_decode(c, warm: bool) -> None:
    """Every decode step's logits, and every cache leaf after the last; with
    ``warm`` the cross caches are filled from the memory first, else decode
    runs against the zero caches ``init_cache`` gives."""
    ref_mem, mem = memories(c)
    ref_step = jax.jit(ref_model.decode_step, static_argnums=1)
    ref_cache = ref_model.init_cache(c["ref_cfg"], B, L)
    cache = init_cache(c["cfg"], B, L, device="cpu")
    if warm:
        ref_cache = ref_model.warm_cross_cache(c["ref_params"], c["ref_cfg"], ref_cache, ref_mem)
        warm_cross_cache(c["model"], c["cfg"], cache, mem)
    for t in range(L):
        ref_lg, ref_cache = ref_step(c["ref_params"], c["ref_cfg"],
                                     jnp.asarray(c["tokens"][:, t : t + 1]), ref_cache,
                                     jnp.int32(t))
        lg, got = decode_step(c["model"], c["cfg"], torch.from_numpy(c["tokens"][:, t : t + 1]),
                              cache, t)
        assert got is cache
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL, err_msg=f"step {t}")
    ref_leaves = dict(zip([n for n, _ in named_leaves(ref_cache)], jax.tree.leaves(ref_cache)))
    for name, leaf in named_leaves(cache):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref_leaves[name]), **TOL,
                                   err_msg=name)


def test_decode_with_warm_caches_matches_reference(cross):
    check_decode(cross, warm=True)


def test_decode_with_cold_caches_matches_reference(cross):
    """The reference's serving launcher warms no cross cache: it decodes
    against zeros, and so does the port's."""
    check_decode(cross, warm=False)


def test_decode_ignores_memory_once_the_caches_exist(cross):
    """``decode_step`` reads the warmed caches, not ``memory``: a memory of
    other values gives the same logits."""
    _, mem = memories(cross)
    cfg, tok = cross["cfg"], torch.from_numpy(cross["tokens"][:, :1])
    logits = []
    for memory in (None, mem, torch.full_like(mem, 3.0)):
        cache = warm_cross_cache(cross["model"], cfg, init_cache(cfg, B, L, device="cpu"), mem)
        logits.append(decode_step(cross["model"], cfg, tok, cache, 0, memory=memory)[0])
    assert all(torch.equal(logits[0], lg) for lg in logits[1:])


def test_greedy_tokens_match_reference(cross):
    """Caches warmed, teacher-forced over a 4-token prompt, then 8 greedy
    steps through ``make_serve_step``."""
    prompt, steps = 4, 8
    ref_mem, mem = memories(cross)
    ref_serve = jax.jit(ref_make_serve_step(cross["ref_cfg"]))
    serve = make_serve_step(cross["cfg"])
    ref_cache = ref_model.warm_cross_cache(cross["ref_params"], cross["ref_cfg"],
                                           ref_model.init_cache(cross["ref_cfg"], B,
                                                                prompt + steps), ref_mem)
    cache = warm_cross_cache(cross["model"], cross["cfg"],
                             init_cache(cross["cfg"], B, prompt + steps, device="cpu"), mem)
    ref_tok = jnp.asarray(cross["tokens"][:, :1])
    tok = torch.from_numpy(cross["tokens"][:, :1])
    ref_out, out = [], []
    for t in range(prompt + steps):
        ref_next, _, ref_cache = ref_serve(cross["ref_params"], ref_cache, ref_tok, jnp.int32(t))
        nxt, _, cache = serve(cross["model"], cache, tok, t)
        if t + 1 < prompt:
            ref_tok = jnp.asarray(cross["tokens"][:, t + 1 : t + 2])
            tok = torch.from_numpy(cross["tokens"][:, t + 1 : t + 2])
        else:
            ref_tok, tok = ref_next, nxt
            ref_out.append(np.asarray(ref_next))
            out.append(nxt.numpy())
    assert np.array_equal(np.concatenate(out, 1), np.concatenate(ref_out, 1))


def test_vlm_forward_without_memory_fails_as_in_the_reference():
    """The ``xattn`` layers read ``memory`` in the full-sequence pass; without
    one both packages fail there (``None`` has no cast)."""
    ref_cfg, cfg = configs("llama-3.2-vision-90b")
    tokens = np.zeros((1, 4), dtype=np.int32)
    ref_params = ref_model.init_model(jax.random.PRNGKey(0), ref_cfg)
    with pytest.raises(AttributeError):
        ref_model.forward(ref_params, ref_cfg, jnp.asarray(tokens))
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(AttributeError):
        forward(model, cfg, torch.from_numpy(tokens))


@pytest.mark.parametrize("remat", sorted(REMAT))
@pytest.mark.parametrize("arch", CROSS)
def test_loss_and_grads_match_reference(arch, remat):
    """``loss_fn`` with the frontend's embeddings in the batch: Seamless's
    encoder runs inside the loss, so its leaves have gradients; the loss
    and every gradient against ``jax.value_and_grad``, and under remat
    bit-equal to the run without."""
    ref_cfg, cfg = configs(arch, **REMAT[remat])
    tree = perturbed(ref_model.init_model(jax.random.PRNGKey(0), ref_cfg))
    params, _ = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    convert.load_params(params, tree)
    key = "enc_embeds" if cfg.enc_layers else "vision_embeds"
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    batch = {"tokens": tokens, key: frontend(cfg)}
    (ref_total, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_train.loss_fn(p, ref_cfg, b), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, metrics = loss_fn(params, cfg, tbatch)
    names, leaves = zip(*named_leaves(params))
    grads = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"].detach()), float(ref_metrics["loss"]),
                               rtol=1e-5)
    want = dict(zip([n for n, _ in named_leaves(ref_grads)], jax.tree.leaves(ref_grads)))
    assert list(names) == list(want)
    for name, g in zip(names, grads):
        w = np.asarray(want[name])
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()) + 1e-30, (name, err)
    if cfg.enc_layers:  # the encoder is trained end to end
        assert all(bool(g.any()) for n, g in zip(names, grads) if n.startswith("encoder::"))
    if cfg.remat:  # recomputation repeats the same arithmetic: bit-equal
        plain = torch.autograd.grad(
            loss_fn(params, dataclasses.replace(cfg, remat=False), tbatch)[0], leaves)
        assert all(torch.equal(a, b) for a, b in zip(grads, plain))


def test_train_launcher_frontend_seed_trains_a_deep_encoder(tmp_path, capsys, monkeypatch):
    """On the training launchers' zero frames every encoder layer sees zero
    rows; 24 of them (SeamlessM4T's depth) overflow the first step's
    gradients, in the reference's launcher and in the port's.  The port's
    ``--frontend-seed`` draws the frames from a normal distribution: the
    same model's gradients are finite."""
    args = ["--arch", "seamless-m4t-large-v2", "--reduced", "--steps", "1", "--batch", "2",
            "--seq", "16", "--set", "num_layers=24", "enc_layers=24"]
    monkeypatch.setattr(sys, "argv", ["train", *args, "--ckpt-dir", str(tmp_path / "ref")])
    ref_launch_train.main()
    assert " gnorm=nan" in capsys.readouterr().out
    port = port_launch_train.build_parser().parse_args([*args, "--device", "cpu", "--ckpt-dir",
                                                        str(tmp_path / "port")])
    (zero,) = port_launch_train.train(port)["history"]
    assert math.isfinite(zero["loss"]) and math.isnan(zero["grad_norm"])
    port.frontend_seed = 0
    run = port_launch_train.train(port)
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in run["history"])
    batch = port_launch_train.train_batch(run["cfg"], np.zeros((2, 4), np.int32), "cpu",
                                          torch.Generator().manual_seed(0))
    assert batch["enc_embeds"].shape == (2, run["cfg"].num_enc_frames, 64)
    assert batch["enc_embeds"].dtype == run["cfg"].cdtype and bool(batch["enc_embeds"].any())
