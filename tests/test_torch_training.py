"""The port's training against the JAX package's.

Both packages run the reference's weights (carried into the port by
``models/convert.load_params``; JAX and torch draw different numbers from
one seed) in float32 compute on the CPU.  Tolerances, each from what the
two frameworks do differently:

* the cross-entropy, ``lr_at`` and ``global_norm`` compute the same float32
  operations, but sum and take ``logsumexp``/``cos`` with their own
  kernels: ``rtol = 1e-6`` (a few ulps);
* ``adamw_update`` on identical inputs repeats the reference's arithmetic
  operation for operation: bit-equal while the clip does not act; when it
  acts, ``global_norm`` (summed in another order) moves the clip scale by an
  ulp, so each leaf of the update is held within 1e-6 of its largest
  element (an element of ``m`` near a cancellation moves by more, relative
  to itself);
* loss and gradients of ``loss_fn`` through two periods of a reduced model
  (widths 64-128): the products sum in another order, which moves each
  gradient leaf by about 1e-6 of its largest element (measured 1.4e-6 at
  most); held within 1e-5 of the leaf's largest element, the loss within
  ``rtol = 1e-5``;
* after one and three train steps the parameters within 2e-5 (the
  reference's own bound between microbatched and whole-batch steps,
  ``tests/test_distributed.py``; at learning rate 3e-4 a step moves an
  element by about 3e-4, so a gradient whose sign flipped would show),
  ``m`` and ``v`` within 1e-5 of the leaf's largest element;
* the reduced Jamba and xLSTM, 16 recurrent layers deep, are held to the
  looser bounds of ``DEEP_TOLERANCES`` (gradients within 5e-4 of the leaf's
  largest element, the parameters after a step within 2e-4, still under
  the ~3e-4 a flipped gradient sign moves an element): their gradients
  move by up to 4.5e-5 under one-ulp noise on the parameters alone
  (``tools/recurrent_drift.py grads``).

The remat policies must recompute what they say (counted ``aten`` products),
serving must record no graph, and the hot-tier files of an optimizer state
must be byte-identical both ways.  The dense decoders on the card are held
against this CPU port in ``tests/test_torch_lm_device.py``, which imports no
JAX.
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
from repro.distributed import checkpoint as ref_ckpt
from repro.distributed import fault_tolerance as ref_ft
from repro.launch.cli import parse_overrides as ref_parse_overrides
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro.training import optimizer as ref_opt
from repro.training import train_step as ref_train
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import checkpoint as port_ckpt
from repro_torch.distributed import fault_tolerance as port_ft
from repro_torch.distributed.checkpoint import named_leaves
from repro_torch.launch.cli import parse_overrides
from repro_torch.models import common, convert
from repro_torch.models.model import decode_step, forward, init_cache, init_model
from repro_torch.training import (
    OptConfig,
    adamw_init,
    adamw_update,
    global_norm,
    init_train_state,
    loss_fn,
    lr_at,
    make_train_step,
)
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

DENSE = ["deepseek-coder-33b", "granite-8b", "qwen2.5-3b", "yi-34b"]
MOE = ["deepseek-v2-236b", "kimi-k2-1t-a32b"]
RECURRENT = ["jamba-v0.1-52b", "xlstm-1.3b"]  # Jamba's MoE layers add an aux loss
#: the cross-attention archs: their batches carry the frontend's embeddings
CROSS = ["llama-3.2-vision-90b", "seamless-m4t-large-v2"]
#: the bounds of the module docstring, and the looser ones of the reduced
#: recurrent archs: 16 layers (two 8-layer periods) where the others have
#: 2-3.  Their gradients are ill-conditioned in the parameters: one-ulp
#: noise on the parameters alone moves the port's own gradients by 4.4e-5
#: (Jamba) and 4.5e-5 (xLSTM) of each leaf's largest element, against
#: 1.8e-6 for Granite-8B (all measured on the CPU by
#: ``tools/recurrent_drift.py grads``).  Against the reference
#: they drift by up to 4.0e-5 and 1.25e-4 (gradients), 4.6e-5 (the gradient
#: norm), 6.6e-5 (parameters after a step) and 1.2e-3 (``v`` after three).
TOLERANCES = {"grad_rel": 1e-5, "grad_norm_rtol": 1e-5, "param_atol": 2e-5,
              "moment_rel": 1e-5}
DEEP_TOLERANCES = {"grad_rel": 5e-4, "grad_norm_rtol": 2e-4, "param_atol": 2e-4,
                   "moment_rel": 5e-3}


def tolerances(arch: str) -> dict:
    return DEEP_TOLERANCES if arch in RECURRENT else TOLERANCES
REMAT = {"off": dict(remat=False, remat_policy="full"), "full": dict(remat=True),
         "dots": dict(remat=True, remat_policy="dots"), "none": dict(remat_policy="none")}
aten = torch.ops.aten


def perturbed(params, seed: int = 5):
    """The reference's parameters as numpy, its constant leaves (norm weights
    of ones, biases of zeros) moved off their constants."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.flat[0]):
            a = a + rng.normal(0.0, 0.1, a.shape).astype(a.dtype)
        return a

    return jax.tree.map(move, params)


def pair(arch: str, *, periods: int = 2, **overrides):
    """A reduced decoder in float32 in both packages, on the same weights:
    ``(ref_cfg, ref_params, cfg, port params with gradients on)``."""
    kw = dict(compute_dtype="float32", **overrides)
    ref_cfg = dataclasses.replace(ref_reduced(REF_ARCHS[arch], periods=periods), **kw)
    cfg = dataclasses.replace(reduced(ARCHS[arch], periods=periods), **kw)
    tree = perturbed(ref_model.init_model(jax.random.PRNGKey(0), ref_cfg))
    params, _ = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    convert.load_params(params, tree)
    return ref_cfg, jax.tree.map(jnp.asarray, tree), cfg, params


def tokens_of(cfg, shape=(2, 16), seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def batch_of(cfg, tokens: np.ndarray, seed: int = 13) -> dict[str, np.ndarray]:
    """A train batch of ``tokens``; a cross-attention arch's also carries
    its frontend's embeddings (Seamless's ``enc_embeds``, the VLM's
    ``vision_embeds``), drawn from ``seed``."""
    batch = {"tokens": tokens}
    shape = (tokens.shape[0], cfg.num_enc_frames or cfg.num_vision_tokens, cfg.d_model)
    rng = np.random.default_rng(seed)
    if cfg.enc_layers:
        batch["enc_embeds"] = rng.normal(size=shape).astype(np.float32)
    elif cfg.num_vision_tokens:
        batch["vision_embeds"] = rng.normal(size=shape).astype(np.float32)
    return batch


def as_named(tree) -> dict[str, np.ndarray]:
    return {n: (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                else np.asarray(leaf)) for n, leaf in named_leaves(tree)}


def assert_leaves_close(got, want, rel: float):
    """Every leaf of ``got`` within ``rel`` of ``want``'s largest element."""
    got, want = as_named(got), as_named(want)
    assert list(got) == list(want)
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max())
        assert err <= rel * float(np.abs(w).max()) + 1e-30, (name, err)


# ---------------------------------------------------------------------------
# cross-entropy, schedule, norm, AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
@pytest.mark.parametrize("sharded_vocab", [False, True])
def test_softmax_cross_entropy_matches_reference(sharded_vocab, z_loss, dtype):
    """Value and gradient with respect to the logits."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    jx = jnp.asarray(logits, dtype=dtype)
    tx = torch.from_numpy(logits).to(common.DTYPES[dtype]).requires_grad_(True)
    kw = dict(z_loss=z_loss, sharded_vocab=sharded_vocab)
    want, want_grad = jax.value_and_grad(
        lambda x: ref_common.softmax_cross_entropy(x, jnp.asarray(labels), **kw))(jx)
    got = common.softmax_cross_entropy(tx, torch.from_numpy(labels), **kw)
    (got_grad,) = torch.autograd.grad(got, tx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_grad.float().numpy(), np.asarray(want_grad, np.float32),
                               rtol=1e-5, atol=1e-8 if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("cfg", [dict(), dict(warmup_steps=20, total_steps=100)])
def test_lr_at_matches_reference(cfg):
    """Across warmup, the turn, the cosine and past the end (float32)."""
    steps = [0, 1, 5, 19, 20, 21, 50, 99, 100, 101, 5000, 9999, 10000, 20000]
    for step in steps:
        got = lr_at(OptConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        want = ref_opt.lr_at(ref_opt.OptConfig(**cfg), jnp.int32(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=str(step))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = {"b": [rng.standard_normal((40, 30)).astype(np.float32)],
            "a": {"w": (rng.standard_normal(1000) * 1e-3).astype(np.float32),
                  "h": rng.standard_normal((3, 5)).astype(np.float16)}}
    got = global_norm(jax.tree.map(torch.from_numpy, tree))
    want = ref_opt.global_norm(jax.tree.map(jnp.asarray, tree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


#: (gradient scale, step before the update): the clip acts when the norm is
#: above 1, which the scale 3 makes it
ADAMW_CASES = {"first-step": (0.01, 0), "first-step-clipped": (3.0, 0),
               "later-step": (0.01, 7), "later-step-clipped": (3.0, 41)}


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_update_matches_reference(case):
    gscale, step0 = ADAMW_CASES[case]
    rng = np.random.default_rng(2)

    def tree(scale):
        return {"a": (rng.standard_normal((3, 40, 17)) * scale).astype(np.float32),
                "b": {"w": (rng.standard_normal(64) * scale).astype(np.float32),
                      "c": (rng.standard_normal((5, 9)) * scale).astype(np.float32)}}

    p, g, m, v = tree(1.0), tree(gscale), tree(0.01), jax.tree.map(np.abs, tree(1e-2))
    if step0 == 0:
        m, v = jax.tree.map(np.zeros_like, m), jax.tree.map(np.zeros_like, v)
    cfg = dict(warmup_steps=5, total_steps=50)
    J = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    T = lambda t: jax.tree.map(lambda a: torch.from_numpy(a.copy()), t)  # noqa: E731
    ref_p, ref_state, ref_metrics = ref_opt.adamw_update(
        ref_opt.OptConfig(**cfg), J(g), {"m": J(m), "v": J(v), "step": jnp.int32(step0)}, J(p))
    params, state = T(p), {"m": T(m), "v": T(v), "step": torch.tensor(step0, dtype=torch.int32)}
    got_p, got_state, metrics = adamw_update(OptConfig(**cfg), T(g), state, params)
    assert got_p is params and got_state is state  # updated in place
    assert state["step"].dtype == torch.int32 and int(state["step"]) == step0 + 1
    assert float(metrics["lr"]) == float(ref_metrics["lr"])
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(ref_metrics["grad_norm"]),
                               rtol=1e-6)
    clipped = float(ref_metrics["grad_norm"]) > 1.0
    assert clipped == ("clipped" in case)
    for got, want in ((params, ref_p), (state["m"], ref_state["m"]),
                      (state["v"], ref_state["v"])):
        if clipped:
            assert_leaves_close(got, want, rel=1e-6)
        else:
            got, want = as_named(got), as_named(want)
            assert all(np.array_equal(got[name], w) for name, w in want.items())


# ---------------------------------------------------------------------------
# loss, gradients, remat
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", ["off", "full", "dots"])
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_loss_and_grads_match_reference(arch, remat):
    """Loss, MoE aux loss (0 in a model without MoE layers) and every
    gradient, the aux loss's included, against ``jax.value_and_grad``."""
    check_loss_and_grads(*pair(arch, **REMAT[remat]), ARCHS[arch].num_experts > 0,
                         rel=tolerances(arch)["grad_rel"])


@pytest.mark.parametrize("arch", MOE)
def test_gather_dispatch_loss_and_grads_match_reference(arch):
    """The permutation-gather dispatch (its custom backward) through the
    whole model, under remat ``dots``."""
    check_loss_and_grads(*pair(arch, moe_gather_dispatch=True, **REMAT["dots"]), True)


def check_loss_and_grads(ref_cfg, ref_params, cfg, params, moe: bool,
                         rel: float = TOLERANCES["grad_rel"]):
    tokens = tokens_of(cfg)
    (ref_total, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_train.loss_fn(p, ref_cfg, b), has_aux=True))(
            ref_params, {"tokens": jnp.asarray(tokens)})
    total, metrics = loss_fn(params, cfg, {"tokens": torch.from_numpy(tokens)})
    leaves = [p for _, p in named_leaves(params)]
    grads = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"].detach()), float(ref_metrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux_loss"].detach()),
                               float(ref_metrics["aux_loss"]), rtol=1e-5)
    assert (float(metrics["aux_loss"].detach()) > 0) == moe
    assert_leaves_close(dict(zip([n for n, _ in named_leaves(params)], grads)),
                        dict(named_leaves(ref_grads)), rel=rel)
    if cfg.remat:  # recomputation repeats the same arithmetic: bit-equal
        cfg_off = dataclasses.replace(cfg, remat=False)
        plain = torch.autograd.grad(loss_fn(params, cfg_off,
                                            {"tokens": torch.from_numpy(tokens)})[0], leaves)
        assert all(torch.equal(a, b) for a, b in zip(grads, plain))


class OpCount(TorchDispatchMode):
    """Counts the ``aten`` operators that reach the kernels."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["off", "none", "full", "dots", "serving"])
def test_remat_policies_recompute_what_they_say(remat):
    """Products run in one loss and its gradient: backward runs two products
    for each forward product; ``full`` recomputes the periods' products (but
    the last of each period, the FFN's output product: recomputation stops
    once it has rebuilt what backward saves), ``dots`` only the batched
    (attention) ones, and a model without gradients (serving) is not
    checkpointed and records no graph."""
    _, _, cfg, params = pair("qwen2.5-3b", **REMAT["full" if remat == "serving" else remat])
    tokens = {"tokens": torch.from_numpy(tokens_of(cfg))}
    with torch.no_grad(), OpCount() as fwd:
        loss_fn(params, cfg, tokens)
    mm, bmm = fwd.counts[aten.mm.default], fwd.counts[aten.bmm.default]
    period_mm = mm - 1  # all but the head's product run in the periods
    assert period_mm == 7 * cfg.n_periods and bmm == 2 * cfg.n_periods
    if remat == "serving":
        params.requires_grad_(False)
    with OpCount() as run:
        total, _ = loss_fn(params, cfg, tokens)
        if remat != "serving":
            torch.autograd.grad(total, [p for _, p in named_leaves(params)])
    want = {"off": (3 * mm, 3 * bmm), "none": (3 * mm, 3 * bmm),
            "full": (3 * mm + period_mm - cfg.n_periods, 4 * bmm), "dots": (3 * mm, 4 * bmm),
            "serving": (mm, bmm)}[remat]
    assert (run.counts[aten.mm.default], run.counts[aten.bmm.default]) == want
    if remat == "serving":
        assert total.grad_fn is None


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_moe_remat_recomputes_what_it_says(remat):
    """DeepSeek-V2 reduced: a dense prologue layer (not checkpointed: six
    MLA products, three FFN products and two attention products) and two
    MoE periods (six MLA products, the router's, three of the shared expert;
    two attention products and the experts' three batched products).
    ``full`` recomputes the periods' products but the last of each (the
    shared expert's output product), ``dots`` only the batched ones, as the
    reference's ``dots_with_no_batch_dims_saveable`` saves only unbatched
    products: so the expert products stay batched."""
    _, _, cfg, params = pair("deepseek-v2-236b", **REMAT[remat])
    n = cfg.n_periods
    tokens = {"tokens": torch.from_numpy(tokens_of(cfg))}
    with torch.no_grad(), OpCount() as fwd:
        loss_fn(params, cfg, tokens)
    mm, bmm = fwd.counts[aten.mm.default], fwd.counts[aten.bmm.default]
    period_mm, period_bmm = 10 * n, 5 * n
    assert (mm, bmm) == (9 + period_mm + 1, 2 + period_bmm)
    with OpCount() as run:
        total, _ = loss_fn(params, cfg, tokens)
        torch.autograd.grad(total, [p for _, p in named_leaves(params)])
    want = {"full": (3 * mm + period_mm - n, 3 * bmm + period_bmm),
            "dots": (3 * mm, 3 * bmm + period_bmm)}[remat]
    assert (run.counts[aten.mm.default], run.counts[aten.bmm.default]) == want


def test_serving_params_record_no_graph_and_training_params_do():
    cfg = reduced(ARCHS["qwen2.5-3b"])
    served = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert not any(p.requires_grad for p in served.parameters())
    params, opt = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(p.requires_grad for p in params.parameters())
    assert all(torch.equal(a, b) for a, b in zip(served.parameters(), params.parameters()))
    assert [n for n, _ in named_leaves(opt["m"])] == [n for n, _ in named_leaves(params)]
    assert all(t.dtype == torch.float32 and not t.any()
               for _, t in named_leaves({"m": opt["m"], "v": opt["v"]}))
    assert opt["step"].dtype == torch.int32 and opt["step"].shape == ()
    tokens = torch.zeros((1, 3), dtype=torch.int64)
    logits, _ = decode_step(served, cfg, tokens[:, :1], init_cache(cfg, 1, 4, device="cpu"), 0)
    assert logits.grad_fn is None and forward(served, cfg, tokens)[0].grad_fn is None
    assert forward(params, cfg, tokens)[0].grad_fn is not None


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + CROSS)
def test_train_steps_match_reference(arch, microbatches):
    """Three steps (warmup of 2, so the schedule turns), held after the first
    and the third; ``metrics`` is the last microbatch's loss and aux loss in
    both.  The cross-attention archs' batches carry their frontend's
    embeddings, split into microbatches with the tokens."""
    ref_cfg, ref_params, cfg, params = pair(arch)
    opt = adamw_init(params)
    ref_state = ref_opt.adamw_init(ref_params)
    batch = batch_of(cfg, tokens_of(cfg, (8, 16)))
    ref_step = jax.jit(ref_train.make_train_step(
        ref_cfg, ref_opt.OptConfig(warmup_steps=2, total_steps=10), microbatches=microbatches))
    step = make_train_step(cfg, OptConfig(warmup_steps=2, total_steps=10),
                           microbatches=microbatches)
    for n in range(1, 4):
        ref_params, ref_state, ref_metrics = ref_step(
            ref_params, ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        got_params, got_opt, metrics = step(params, opt,
                                            {k: torch.from_numpy(v) for k, v in batch.items()})
        assert got_params is params and got_opt is opt
        if n == 2:
            continue
        assert int(opt["step"]) == int(ref_state["step"]) == n
        assert float(metrics["lr"]) == float(ref_metrics["lr"])
        tol = tolerances(arch)
        for key in ("loss", "aux_loss"):
            np.testing.assert_allclose(float(metrics[key]), float(ref_metrics[key]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(ref_metrics["grad_norm"]),
                                   rtol=tol["grad_norm_rtol"])
        got, want = as_named(params), as_named(ref_params)
        assert list(got) == list(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=tol["param_atol"],
                                       err_msg=name)
        assert_leaves_close(opt["m"], ref_state["m"], rel=tol["moment_rel"])
        assert_leaves_close(opt["v"], ref_state["v"], rel=tol["moment_rel"])


@pytest.mark.parametrize("arch", DENSE)
def test_microbatching_matches_full_batch(arch):
    """The reference's own test on the port: one step with 4 microbatches
    equals one with the whole batch within 2e-5."""
    cfg = dataclasses.replace(reduced(ARCHS[arch], periods=1), vocab_size=64, remat=False,
                              compute_dtype="float32")
    tokens = torch.from_numpy(tokens_of(cfg, (8, 16), seed=1))
    oc = OptConfig(warmup_steps=1, total_steps=10)
    out = []
    for k in (1, 4):
        params, opt = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
        make_train_step(cfg, oc, microbatches=k)(params, opt, {"tokens": tokens})
        out.append(params)
    err = max(float((a - b).abs().max()) for a, b in zip(out[0].parameters(),
                                                         out[1].parameters()))
    assert err < 2e-5, err


def test_training_reduces_loss():
    cfg = dataclasses.replace(reduced(ARCHS["granite-8b"], periods=1), vocab_size=64,
                              remat=False)
    params, opt = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = make_train_step(cfg, OptConfig(learning_rate=1e-2, warmup_steps=2, total_steps=60))
    batch = {"tokens": torch.from_numpy(tokens_of(cfg, (4, 16), seed=1))}  # overfit one batch
    losses = []
    for _ in range(25):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[:3] + losses[-3:]
    assert int(opt["step"]) == 25


# ---------------------------------------------------------------------------
# checkpoint/restart and the hot tier
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_bitexact(tmp_path):
    """The reference's test on the port: three steps, a checkpoint, two more;
    a restore from the checkpoint continues to the same bits."""
    cfg = dataclasses.replace(reduced(ARCHS["qwen2.5-3b"], periods=1), vocab_size=64,
                              remat=False)
    params, opt = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = make_train_step(cfg, OptConfig(warmup_steps=1, total_steps=50))
    batch = {"tokens": torch.from_numpy(tokens_of(cfg, (4, 16), seed=2))}
    for _ in range(3):
        params, opt, _ = step(params, opt, batch)
    port_ckpt.save_checkpoint(tmp_path / "ck", 3, params=params, opt_state=opt)
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)

    r_params, r_opt = init_train_state(torch.Generator().manual_seed(1), cfg, device="cpu")
    step_no, trees = port_ckpt.load_checkpoint(tmp_path / "ck", params=r_params, opt_state=r_opt)
    assert step_no == 3 and trees["params"] is r_params
    r_opt = trees["opt_state"]
    assert r_opt["step"].dtype == torch.int32 and int(r_opt["step"]) == 3
    assert all(t.dtype == torch.float32 for _, t in named_leaves({"m": r_opt["m"],
                                                                   "v": r_opt["v"]}))
    for _ in range(2):
        r_params, r_opt, _ = step(r_params, r_opt, batch)
    for a, b in zip(params.parameters(), r_params.parameters()):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(opt),
                                                             named_leaves(r_opt)))


def written(path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.fixture(scope="module")
def trained_pair():
    """One reference train step and one port step on the same weights: two
    optimizer states with moved moments and ``step`` 1."""
    ref_cfg, ref_params, cfg, params = pair("qwen2.5-3b", periods=1)
    tokens = tokens_of(cfg, (2, 16))
    ref_params, ref_state, _ = jax.jit(ref_train.make_train_step(
        ref_cfg, ref_opt.OptConfig(warmup_steps=1, total_steps=10)))(
            ref_params, ref_opt.adamw_init(ref_params), {"tokens": jnp.asarray(tokens)})
    opt = adamw_init(params)
    make_train_step(cfg, OptConfig(warmup_steps=1, total_steps=10))(
        params, opt, {"tokens": torch.from_numpy(tokens)})
    return dict(ref_params=jax.tree.map(np.asarray, ref_params),
                ref_state=jax.tree.map(np.asarray, ref_state), cfg=cfg, params=params, opt=opt)


def test_opt_state_hot_tier_reference_saves_port_loads(trained_pair, tmp_path):
    """The port loads the reference's files into a fresh state (float32
    moments and an int32 step, as tensors) and writes the same bytes."""
    ref_ckpt.save_checkpoint(tmp_path / "ref", 1, params=trained_pair["ref_params"],
                             opt_state=trained_pair["ref_state"])
    params, opt = init_train_state(torch.Generator().manual_seed(3), trained_pair["cfg"],
                                   device="cpu")
    step, trees = port_ckpt.load_checkpoint(tmp_path / "ref", params=params, opt_state=opt)
    assert step == 1
    state = trees["opt_state"]
    assert isinstance(state["step"], torch.Tensor) and state["step"].dtype == torch.int32
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
               for _, t in named_leaves({"m": state["m"], "v": state["v"]}))
    port_ckpt.save_checkpoint(tmp_path / "port", step, params=trees["params"], opt_state=state)
    assert written(tmp_path / "port") == written(tmp_path / "ref")


def test_opt_state_hot_tier_port_saves_reference_loads(trained_pair, tmp_path):
    port_ckpt.save_checkpoint(tmp_path / "port", 1, params=trained_pair["params"],
                              opt_state=trained_pair["opt"])
    step, trees = ref_ckpt.load_checkpoint(tmp_path / "port",
                                           params=trained_pair["ref_params"],
                                           opt_state=trained_pair["ref_state"])
    assert step == 1
    assert np.asarray(trees["opt_state"]["step"]).dtype == np.int32
    ref_ckpt.save_checkpoint(tmp_path / "ref", step, **trees)
    assert written(tmp_path / "ref") == written(tmp_path / "port")


def test_numpy_template_still_loads_numpy_and_a_mismatched_tensor_refuses(tmp_path):
    state = {"m": {"w": np.ones((2, 3), np.float32)}, "step": np.int32(4)}
    port_ckpt.save_checkpoint(tmp_path, 4, opt_state=state)
    _, trees = port_ckpt.load_checkpoint(tmp_path, opt_state=state)
    assert isinstance(trees["opt_state"]["m"]["w"], np.ndarray)
    wrong = {"m": {"w": torch.zeros((3, 2))}, "step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError, match=r"\(2, 3\) torch.float32 does not match its "
                                         r"template \(3, 2\)"):
        port_ckpt.load_checkpoint(tmp_path, opt_state=wrong)


# ---------------------------------------------------------------------------
# fault tolerance and the command-line overrides, case by case
# ---------------------------------------------------------------------------
STRAGGLER_CASES = {
    "one-slow": [(f"w{w}", s, 1.0 if w else 3.5) for s in range(6) for w in range(8)],
    "alone": [("self", s, 0.1 * (s + 1)) for s in range(5)],
    "late-joiner": [("a", 0, 1.0), ("b", 0, 1.0), ("a", 1, 1.1), ("c", 4, 9.0), ("b", 5, 1.0)],
    "spike": [("a", s, 1.0) for s in range(4)] + [("b", s, 1.0 if s < 3 else 20.0)
                                                  for s in range(4)],
}


@pytest.mark.parametrize("case", sorted(STRAGGLER_CASES))
def test_straggler_monitor_matches_reference(case):
    ref, port = ref_ft.StragglerMonitor(), port_ft.StragglerMonitor(alpha=0.2)
    for worker, step, secs in STRAGGLER_CASES[case]:
        ref.record(worker, step, secs)
        port.record(worker, step, secs)
    assert port.ema == ref.ema and port.last_seen == ref.last_seen
    for threshold in (1.5, 2.0, 3.0):
        assert port.stragglers(threshold) == ref.stragglers(threshold)
    for step in (0, 3, 5, 10):
        for lag in (0, 3):
            assert port.dead(step, lag) == ref.dead(step, lag)


REMESH_CASES = [(240, (16, 16)), (256, (16, 16)), (12, (16, 16)), (1, (16, 16)),
                (7, (2, 4)), (384, (2, 16, 16)), (500, (2, 16, 16)), (10, (2, 16, 16)),
                (96, (4, 8, 4)), (3, (1, 1))]


@pytest.mark.parametrize("alive,shape", REMESH_CASES)
def test_remesh_plan_matches_reference(alive, shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    got = port_ft.remesh_plan(alive, shape, axis_names=names)
    want = ref_ft.remesh_plan(alive, shape, axis_names=names)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_should_checkpoint_matches_reference():
    for step in (0, 1, 7, 50, 99, 100, 200):
        for every in (1, 25, 100):
            for alarms in ([], ["w0"], ()):
                assert port_ft.should_checkpoint(step, every, iter(alarms)) == \
                    ref_ft.should_checkpoint(step, every, iter(alarms))


def test_parse_overrides_matches_reference():
    items = ["remat_policy=dots", "microbatches=4", "logits_bf16_ce=true", "remat=False",
             "lr=3e-4", "x=1.5", "name=a=b", "flag=True", "neg=-2", "empty=", "big=1e400"]
    got, want = parse_overrides(items), ref_parse_overrides(items)
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]
    assert parse_overrides(None) == ref_parse_overrides(None) == {}
    with pytest.raises(ValueError):
        parse_overrides(["novalue"])
    with pytest.raises(ValueError):
        ref_parse_overrides(["novalue"])
