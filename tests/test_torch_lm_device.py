"""The port's decoders on the card against the port on the CPU.

Marked ``cuda``: they skip without a card, and this module imports neither
JAX nor the JAX package, so that it collects where the card is.  The four
dense decoders, the two MoE architectures (DeepSeek-V2 with MLA, Kimi-K2
with GQA; the train step under both MoE dispatch modes) and the recurrent
ones (Jamba: Mamba, attention and MoE; xLSTM), reduced, in float32
compute, with weights from one seed (the
constant leaves, norm weights of ones and biases of zeros, moved off their
constants so that they matter): forward and every decode step within
``rtol = atol = 1e-4`` of the CPU (cuBLAS sums the same float32 products in
its own order; TF32 is off, and checked), the same greedy tokens, and one
train step: loss within ``rtol = 1e-5``, every gradient within 1e-4 of its
leaf's largest element, the parameters after the step within 2e-5 (a
flipped gradient sign would move an element by 2 x 3e-4).  The MoE's
scatter-add sums in atomic order on the card, so its floats are held at
these tolerances, never bit for bit; its routing is integer and held
exactly.  In the MoE archs a few router gradient elements cancel to float
noise around zero (measured on an H100: 4.1e-9 on the CPU against 5.9e-10
on the card, where the leaf's largest is 6.0e-3, well inside the gradient
check); the first AdamW step moves such an element by ``lr * g / (|g| +
eps)``, anywhere up to ``lr``, so there the elements whose gradient is
within the gradient check's tolerance of zero are held within twice the
learning rate (the most two such moves can differ) and every other element
within 2e-5.  The reduced Jamba and xLSTM are 16 recurrent layers deep, and
one-ulp noise on their parameters alone moves their gradients by up to
4.5e-5 of a leaf's largest element (measured on the CPU by
``tools/recurrent_drift.py grads``): their gradients
are held within 5e-4, and the same rule holds their near-zero ones after
the step.  The two cross-attention archs (Llama-3.2-Vision, SeamlessM4T)
take their frontend's embeddings, drawn from one seed: the forward reads
the memory (Seamless's through its encoder), decode the cross caches
``warm_cross_cache`` fills from it, the train step's batch carries the
embeddings; they are held to the dense decoders' bounds.  The mesh path
at world 1 (a NCCL group of one rank, every parameter, moment, batch and
cache a ``DTensor``) is held to the plain path on the card: the first loss
and the greedy tokens bit for bit, the second loss within ``rtol = 1e-6``
and the parameters after two steps within 2e-5 (DTensor sums a few
gradients in another order).
Run them on a card with ``pytest -m cuda tests/test_torch_lm_device.py``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed.checkpoint import named_leaves
from repro_torch.models.model import decode_step, encode, forward, init_cache, warm_cross_cache
from repro_torch.serving.serve import make_serve_step
from repro_torch.training import OptConfig, adamw_init, init_train_state, loss_fn, make_train_step
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = [pytest.mark.port, pytest.mark.cuda]

DENSE = ["deepseek-coder-33b", "granite-8b", "qwen2.5-3b", "yi-34b"]
MOE = ["deepseek-v2-236b", "kimi-k2-1t-a32b"]
RECURRENT = ["jamba-v0.1-52b", "xlstm-1.3b"]
CROSS = ["llama-3.2-vision-90b", "seamless-m4t-large-v2"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return "cuda"


def cpu_model(arch: str, **overrides):
    """A reduced decoder in float32 on the CPU, gradients on."""
    cfg = dataclasses.replace(reduced(ARCHS[arch]), compute_dtype="float32", **overrides)
    params, _ = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for p in params.parameters():
            if bool((p == p.flatten()[0]).all()):
                p += torch.from_numpy(rng.normal(0.0, 0.1, tuple(p.shape)).astype(np.float32))
    return cfg, params


def on_card(model, device: str, grad: bool):
    """A copy of ``model`` on ``device``, with gradients on or off."""
    return copy.deepcopy(model).to(device).requires_grad_(grad)


def tokens_of(cfg, shape=(2, 16)) -> torch.Tensor:
    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int32))


def frontend_of(cfg, batch: int) -> dict[str, torch.Tensor]:
    """The frontend's embeddings a cross-attention arch's batch carries
    (Seamless's ``enc_embeds``, the VLM's ``vision_embeds``); none for the
    others."""
    if not (cfg.enc_layers or cfg.num_vision_tokens):
        return {}
    M = cfg.num_enc_frames or cfg.num_vision_tokens
    embeds = np.random.default_rng(13).normal(size=(batch, M, cfg.d_model)).astype(np.float32)
    return {"enc_embeds" if cfg.enc_layers else "vision_embeds": torch.from_numpy(embeds)}


def memory_of(model, cfg, embeds: dict[str, torch.Tensor], device: str):
    """The memory the decoder attends to, on ``device``: the encoder's output
    or the vision embeddings (``None`` without cross-attention)."""
    if "enc_embeds" in embeds:
        return encode(model, cfg, embeds["enc_embeds"].to(device))
    return embeds["vision_embeds"].to(device) if embeds else None


def warm_cache(model, cfg, batch: int, max_len: int, memory, device: str) -> dict:
    """A decode cache on ``device``, its cross caches filled from ``memory``."""
    cache = init_cache(cfg, batch, max_len, device=device)
    return cache if memory is None else warm_cross_cache(model, cfg, cache, memory)


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + CROSS)
def test_cuda_forward_and_decode_match_cpu(arch, cuda_device):
    cfg, cpu = cpu_model(arch)
    cpu.requires_grad_(False)
    card = on_card(cpu, cuda_device, grad=False)
    tokens = tokens_of(cfg)
    B, L = tokens.shape
    embeds = frontend_of(cfg, B)
    mems = memory_of(cpu, cfg, embeds, "cpu"), memory_of(card, cfg, embeds, cuda_device)
    if embeds:
        np.testing.assert_allclose(mems[1].cpu().numpy(), mems[0].numpy(), **TOL)
    want, want_aux = forward(cpu, cfg, tokens, memory=mems[0])
    got, aux = forward(card, cfg, tokens.to(cuda_device), memory=mems[1])
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    caches = (warm_cache(cpu, cfg, B, L, mems[0], "cpu"),
              warm_cache(card, cfg, B, L, mems[1], cuda_device))
    for t in range(L):
        want, _ = decode_step(cpu, cfg, tokens[:, t : t + 1], caches[0], t)
        got, _ = decode_step(card, cfg, tokens[:, t : t + 1].to(cuda_device), caches[1], t)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("arch", MOE + ["jamba-v0.1-52b"])
def test_cuda_moe_routing_matches_cpu(arch, cuda_device):
    """Each MoE layer's routing on its own input: the experts picked and the
    assignments kept, exactly."""
    from repro_torch.models.common import moe_route, moe_slots

    cfg, cpu = cpu_model(arch)
    cpu.requires_grad_(False)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(32, cfg.d_model)).astype(np.float32))
    moe = next(f"l{i}" for i in range(len(cfg.block_pattern)) if cfg.is_moe_layer(i))
    router = cpu["periods"][moe]["moe"]["router"]
    for i in range(cfg.n_periods):
        routed = {}
        for device in ("cpu", cuda_device):
            _, _, top_e = moe_route(router[i].to(device), x.to(device), cfg)
            routed[device] = (top_e.cpu(), moe_slots(top_e, cfg)[1].cpu())
        assert all(torch.equal(a, b) for a, b in zip(routed["cpu"], routed[cuda_device]))


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + CROSS)
def test_cuda_greedy_tokens_match_cpu(arch, cuda_device):
    """Teacher-forced over a 4-token prompt, then 8 greedy steps."""
    cfg, cpu = cpu_model(arch)
    cpu.requires_grad_(False)
    card = on_card(cpu, cuda_device, grad=False)
    tokens = tokens_of(cfg)
    prompt, steps = 4, 8
    serve = make_serve_step(cfg)
    embeds = frontend_of(cfg, 2)
    out = {}
    for device, model in (("cpu", cpu), (cuda_device, card)):
        cache = warm_cache(model, cfg, 2, prompt + steps,
                           memory_of(model, cfg, embeds, device), device)
        tok, seq = tokens[:, :1].to(device), []
        for t in range(prompt + steps):
            nxt, _, cache = serve(model, cache, tok, t)
            if t + 1 < prompt:
                tok = tokens[:, t + 1 : t + 2].to(device)
            else:
                tok = nxt
                seq.append(nxt.cpu())
        out[device] = torch.cat(seq, 1)
    assert torch.equal(out[cuda_device], out["cpu"]) and out["cpu"].shape == (2, steps + 1)


TRAIN_CASES = [(arch, remat, {}) for arch in DENSE + RECURRENT + CROSS
               for remat in ("full", "dots")] + [
    (arch, remat, {"moe_gather_dispatch": gather}) for arch in MOE
    for remat in ("full", "dots") for gather in (False, True)]


@pytest.mark.parametrize("arch,remat,overrides", TRAIN_CASES,
                         ids=[f"{a}-{r}{'-gather' if o.get('moe_gather_dispatch') else ''}"
                              for a, r, o in TRAIN_CASES])
def test_cuda_train_step_matches_cpu(arch, remat, overrides, cuda_device):
    """One step's loss and every gradient on the card against the CPU, then
    the step itself."""
    cfg, cpu = cpu_model(arch, remat_policy=remat, **overrides)
    card = on_card(cpu, cuda_device, grad=True)
    batch = {"tokens": tokens_of(cfg, (4, 16)), **frontend_of(cfg, 4)}
    totals, grads = {}, {}
    for device, model in (("cpu", cpu), (cuda_device, card)):
        total, _ = loss_fn(model, cfg, {k: v.to(device) for k, v in batch.items()})
        grads[device] = torch.autograd.grad(total, [p for _, p in named_leaves(model)])
        totals[device] = float(total.detach())
    np.testing.assert_allclose(totals[cuda_device], totals["cpu"], rtol=1e-5)
    rel = 5e-4 if arch in RECURRENT else 1e-4
    for (name, _), got, want in zip(named_leaves(cpu), grads[cuda_device], grads["cpu"]):
        err = float((got.cpu() - want).abs().max())
        assert err <= rel * float(want.abs().max()), (name, err)
    oc = OptConfig(warmup_steps=1, total_steps=10)
    for device, model in (("cpu", cpu), (cuda_device, card)):
        make_train_step(cfg, oc)(model, adamw_init(model),
                                 {k: v.to(device) for k, v in batch.items()})
    for (name, a), (_, b), g in zip(named_leaves(card), named_leaves(cpu), grads["cpu"]):
        atol = torch.full(g.shape, 2e-5)
        if arch not in DENSE + CROSS:  # a gradient within float noise of zero moves by up to lr
            atol[g.abs() <= rel * g.abs().max()] = 2 * oc.learning_rate
        diff = (a.detach().cpu() - b.detach()).abs()
        assert bool((diff <= atol).all()), (name, float(diff.max()),
                                            int((diff > atol).sum()))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-236b"])
def test_cuda_mesh_path_at_world_one_equals_the_plain_path(arch, cuda_device, tmp_path):
    """The mesh path on the card at world 1 (a NCCL group of one rank over a
    ``FileStore``, the ``{'data': 1, 'model': 1}`` mesh): every parameter and
    moment a ``DTensor``, two train steps and greedy decoding against the
    plain path.  Each rank's shard is the whole tensor, so the forward runs
    the same kernels on the same data: the first loss and the tokens are
    equal bit for bit.  A few gradients DTensor reduces in another order (a
    bias summed over batch and sequence, the tied embedding's two products;
    measured at float32 rounding, 9.3e-10 on the CPU), so the parameters
    after the steps are held within 2e-5, as the training tests hold them,
    and the second loss within ``rtol = 1e-6``."""
    import torch.distributed as dist

    from repro_torch.distributed.context import mesh_scope
    from repro_torch.distributed.sharding import (
        batch_pspecs, cache_pspecs, dp_axes, full_tree, param_pspecs, place, place_tree)
    from repro_torch.launch.train import _auto_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = _auto_mesh("auto")
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1, "model": 1}
        cfg, cpu = cpu_model(arch)
        plain, sharded = on_card(cpu, cuda_device, True), on_card(cpu, cuda_device, True)
        place_tree(sharded, param_pspecs(sharded), mesh)
        opts = [adamw_init(plain), adamw_init(sharded)]
        step = make_train_step(cfg, OptConfig(warmup_steps=1, total_steps=10))
        for n in range(2):
            batch = {"tokens": tokens_of(cfg, (4, 16)).roll(n, 1).to(cuda_device)}
            _, _, want = step(plain, opts[0], batch)
            with mesh_scope(mesh):
                _, _, got = step(sharded, opts[1], place_tree(batch, batch_pspecs(batch, mesh),
                                                              mesh))
            if n == 0:
                assert float(got["loss"].full_tensor()) == float(want["loss"])
            else:
                np.testing.assert_allclose(float(got["loss"].full_tensor()),
                                           float(want["loss"]), rtol=1e-6)
        for (name, a), (_, b) in zip(named_leaves(full_tree(sharded)), named_leaves(plain)):
            torch.testing.assert_close(a, b.detach(), rtol=0, atol=2e-5, msg=name)
        serve = make_serve_step(cfg)
        prompts = tokens_of(cfg, (2, 6)).to(cuda_device)
        out = []
        for model, on_mesh in ((plain, False), (sharded, True)):
            model.requires_grad_(False)
            cache = init_cache(cfg, 2, 12, device=cuda_device)
            toks = prompts
            if on_mesh:
                cache = place_tree(cache, cache_pspecs(cache, mesh), mesh)
                toks = place(prompts, (dp_axes(mesh), None), mesh)
            with mesh_scope(mesh if on_mesh else None):
                seq = []
                for t in range(10):
                    tok, _, cache = serve(model, cache, toks[:, t:t + 1] if t < 6 else tok, t)
                    seq.append(tok)
                seq = torch.cat(seq, 1)
            out.append(seq.full_tensor() if on_mesh else seq)
        assert torch.equal(out[0], out[1])
    finally:
        dist.destroy_process_group()
