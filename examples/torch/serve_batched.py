"""Batched serving: prefill a batch of prompts, then greedy-decode with the
cached serve step.

Serves a reduced ``--arch`` on ``--device`` (the card by default; ``cpu``
runs without one): parameters drawn from a generator seeded 0, prompts from
one seeded 1, the prompt teacher-forced through the decode step, then
greedy tokens.

Run: PYTHONPATH=src python examples/torch/serve_batched.py --arch qwen2.5-3b
     [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.models.model import check_device, init_cache, init_model
from repro_torch.serving.serve import make_serve_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="torch device of the model")
    args = ap.parse_args()

    device = torch.device(args.device)
    check_device(device)
    cfg = reduced(ARCHS[args.arch], periods=2)
    params = init_model(torch.Generator(device).manual_seed(0), cfg, device=device)
    max_len = args.prompt_len + args.new_tokens
    cache = init_cache(cfg, args.batch, max_len=max_len, device=device)

    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), device=device,
                            generator=torch.Generator(device).manual_seed(1))

    # prefill through the decode path (teacher-forcing the prompt)
    serve = make_serve_step(cfg)
    t0 = time.time()
    for t in range(args.prompt_len - 1):
        _, _, cache = serve(params, cache, prompts[:, t : t + 1], t)
    prompts[:1, :1].cpu()  # waits for the prefill
    t_prefill = time.time() - t0

    generated = [prompts[:, -1:]]
    t0 = time.time()
    tok = prompts[:, -1:]
    for t in range(args.new_tokens):
        tok, logits, cache = serve(params, cache, tok, args.prompt_len - 1 + t)
        generated.append(tok)
    out = torch.cat(generated, dim=1).cpu()  # waits for the last step
    t_decode = time.time() - t0

    print(f"arch={cfg.arch_id} (reduced) batch={args.batch} device={device}")
    print(f"prefill: {args.prompt_len} tokens in {t_prefill:.2f}s")
    print(
        f"decode:  {args.new_tokens} tokens in {t_decode:.2f}s "
        f"({args.batch * args.new_tokens / t_decode:.0f} tok/s batch-aggregate)"
    )
    print("sample continuations (token ids):")
    for b in range(min(3, args.batch)):
        print(f"  seq{b}: {out[b, :12].tolist()} ...")


if __name__ == "__main__":
    main()
