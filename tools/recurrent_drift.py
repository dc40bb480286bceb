#!/usr/bin/env python3
"""How finely float32 determines the recurrent models' outputs and gradients.

Three measurements, one per subcommand:

``card`` (needs a CUDA card): xLSTM-1.3B at full width (48 layers, and cut
to 8), float32, B = 2 over 512 tokens: by prefix length, the relative
distance of step-by-step decode from the full-sequence forward, beside the
forward's own drift when every parameter is multiplied by ``1 + 6e-8 * N(0,
1)`` (one-ulp noise), and the forward over 16 tokens against the first 16
positions of the forward over 512.  The seeds are ``chip_smoke.py`` phase
12b's.

``reference`` (CPU; imports the JAX package): xLSTM at reduced width, 48
layers (6 periods), over 512 tokens: decode against forward in the JAX
package and in the port on the reference's weights, and the two forwards
against each other.

``grads`` (CPU; imports the JAX package): for the reduced Jamba, xLSTM and
Granite-8B, the largest per-leaf relative change of the port's gradients
under one-ulp parameter noise, the port's gradients against the
reference's, and after one and three train steps the gradient norm, the
parameters and ``m``/``v`` against the reference's (the parity tests'
cases in ``tests/test_torch_training.py``).

Run from the repo root::

    PYTHONPATH=src python3 tools/recurrent_drift.py card
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/recurrent_drift.py reference
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/recurrent_drift.py grads
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.models.model import decode_step, forward, init_cache, init_model

ULP_NOISE = 6e-8


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def perturb_(params, seed: int, device) -> list:
    """Multiply every parameter by ``1 + ULP_NOISE * N(0, 1)`` in place;
    returns copies of the originals."""
    saved = [p.detach().clone() for p in params.parameters()]
    gen = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        for p in params.parameters():
            p.mul_(1 + ULP_NOISE * torch.randn(p.shape, generator=gen, device=device))
    return saved


def card() -> None:
    dev = "cuda"
    for layers in (48, 8):
        cfg = dataclasses.replace(ARCHS["xlstm-1.3b"], compute_dtype="float32",
                                  num_layers=layers)
        params = init_model(torch.Generator(dev).manual_seed(0), cfg, device=dev)
        B, L = 2, 512
        tokens = torch.randint(0, cfg.vocab_size, (B, L), device=dev,
                               generator=torch.Generator(dev).manual_seed(2))
        t0 = time.perf_counter()
        with torch.no_grad():
            full, _ = forward(params, cfg, tokens)
            cache = init_cache(cfg, B, L, device=dev)
            dec = torch.stack([decode_step(params, cfg, tokens[:, t : t + 1], cache, t)[0][:, 0]
                               for t in range(L)], dim=1)
            saved = perturb_(params, 3, dev)
            noisy, _ = forward(params, cfg, tokens)
            for p, kept in zip(params.parameters(), saved):
                p.copy_(kept)
            full16, _ = forward(params, cfg, tokens[:, :16])
        for n in (16, 32, 64, 128, 256, 384, 512):
            print(f"xlstm-1.3b {layers} layers, prefix {n}: decode vs forward "
                  f"{rel(dec[:, :n], full[:, :n]):.3e}, one-ulp drift "
                  f"{rel(noisy[:, :n], full[:, :n]):.3e}")
        print(f"xlstm-1.3b {layers} layers: forward over 16 vs the first 16 of 512: "
              f"{rel(full16, full[:, :16]):.3e} ({time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.get_device_name(0)})", flush=True)
        del params, saved, cache
        torch.cuda.empty_cache()


def reference() -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import reduced as ref_reduced
    from repro.models import model as ref_model
    from repro_torch.models import convert

    periods, L, arch = 6, 512, "xlstm-1.3b"
    ref_cfg = dataclasses.replace(ref_reduced(REF_ARCHS[arch], periods=periods),
                                  compute_dtype="float32")
    key = jax.random.PRNGKey(0)
    ref_params = ref_model.init_model(key, ref_cfg)
    tokens = np.asarray(jax.random.randint(key, (2, L), 0, ref_cfg.vocab_size))
    ref_full, _ = jax.jit(ref_model.forward, static_argnums=1)(ref_params, ref_cfg,
                                                               jnp.asarray(tokens))
    step = jax.jit(ref_model.decode_step, static_argnums=1)
    cache, outs = ref_model.init_cache(ref_cfg, 2, L), []
    for t in range(L):
        lg, cache = step(ref_params, ref_cfg, jnp.asarray(tokens[:, t : t + 1]), cache,
                         jnp.int32(t))
        outs.append(lg[:, 0])
    ref_full = torch.from_numpy(np.array(ref_full))
    ref_dec = torch.from_numpy(np.array(jnp.stack(outs, 1)))
    cfg = dataclasses.replace(reduced(ARCHS[arch], periods=periods), compute_dtype="float32")
    model = convert.load_params(init_model(torch.Generator().manual_seed(0), cfg, device="cpu"),
                                jax.tree.map(np.asarray, ref_params))
    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        full, _ = forward(model, cfg, tt)
        cache = init_cache(cfg, 2, L, device="cpu")
        dec = torch.stack([decode_step(model, cfg, tt[:, t : t + 1], cache, t)[0][:, 0]
                           for t in range(L)], 1)
    print(f"{arch} reduced, {cfg.num_layers} layers, {L} tokens: decode vs forward, reference "
          f"{rel(ref_dec, ref_full):.3e}, port {rel(dec, full):.3e}; port forward vs "
          f"reference forward {rel(full, ref_full):.3e}")


def grads() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
    import jax
    import jax.numpy as jnp
    import test_torch_training as T

    for arch in ("jamba-v0.1-52b", "xlstm-1.3b", "granite-8b"):
        ref_cfg, ref_params, cfg, params = T.pair(arch, **T.REMAT["off"])
        tokens = T.tokens_of(cfg)
        names, leaves = zip(*T.named_leaves(params))
        batch = {"tokens": torch.from_numpy(tokens)}
        g0 = torch.autograd.grad(T.loss_fn(params, cfg, batch)[0], leaves)
        (_, _), ref_g = jax.jit(jax.value_and_grad(
            lambda p, b: T.ref_train.loss_fn(p, ref_cfg, b), has_aux=True))(
                ref_params, {"tokens": jnp.asarray(tokens)})
        ref_g = {n: torch.from_numpy(np.array(g)) for n, g in T.named_leaves(ref_g)}
        vs_ref = max(rel(g, ref_g[n]) for n, g in zip(names, g0))
        perturb_(params, 0, "cpu")
        g1 = torch.autograd.grad(T.loss_fn(params, cfg, batch)[0], leaves)
        noise = max(rel(a, b) for a, b in zip(g1, g0))
        print(f"{arch} reduced ({cfg.num_layers} layers): gradients under one-ulp noise "
              f"{noise:.3e}, against the reference {vs_ref:.3e} (of each leaf's largest)")
    for arch in ("jamba-v0.1-52b", "xlstm-1.3b"):
        for mb in (1, 4):
            ref_cfg, ref_params, cfg, params = T.pair(arch)
            opt, ref_state = T.adamw_init(params), T.ref_opt.adamw_init(ref_params)
            tokens = T.tokens_of(cfg, (8, 16))
            ref_step = jax.jit(T.ref_train.make_train_step(
                ref_cfg, T.ref_opt.OptConfig(warmup_steps=2, total_steps=10), microbatches=mb))
            step = T.make_train_step(cfg, T.OptConfig(warmup_steps=2, total_steps=10),
                                     microbatches=mb)
            for n in range(1, 4):
                ref_params, ref_state, ref_m = ref_step(ref_params, ref_state,
                                                        {"tokens": jnp.asarray(tokens)})
                _, _, m = step(params, opt, {"tokens": torch.from_numpy(tokens)})
                if n == 2:
                    continue
                got, want = T.as_named(params), T.as_named(ref_params)
                moments = {k: max(float(np.abs(T.as_named(opt[k])[n_] -
                                              T.as_named(ref_state[k])[n_]).max() /
                                       np.abs(T.as_named(ref_state[k])[n_]).max())
                                  for n_ in want) for k in ("m", "v")}
                gn = abs(float(m["grad_norm"]) - float(ref_m["grad_norm"])) / \
                    abs(float(ref_m["grad_norm"]))
                print(f"{arch} microbatches {mb}, step {n}: gradient norm rel {gn:.3e}, "
                      f"parameters {max(float(np.abs(got[k] - want[k]).max()) for k in want):.3e}"
                      f" (max abs), m {moments['m']:.3e}, v {moments['v']:.3e} (of each leaf's "
                      f"largest)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["card", "reference", "grads"])
    {"card": card, "reference": reference, "grads": grads}[ap.parse_args(argv).what]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
