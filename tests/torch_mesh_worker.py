"""The port's mesh path on four gloo ranks, for ``tests/test_torch_distributed.py``.

``python tests/torch_mesh_worker.py OUT`` spawns four processes that join a
gloo process group through a ``FileStore`` under ``OUT`` (no TCP port), lay
a ``(data 2, model 2)`` mesh over them and, for the reduced granite-8b and
DeepSeek-V2 in float32, run on the mesh and on one device from the same
parameters: two train steps, then greedy decoding.  Rank 0 writes what the
test compares to ``OUT/result.json``; the hot-tier checkpoint of the trained
sharded trees goes to ``OUT/<arch>/mesh`` and the same values written as
plain tensors to ``OUT/<arch>/plain``.  Each child runs one thread.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch_threads import ONE_THREAD_ENV, one_thread  # noqa: E402

ARCHS = ("granite-8b", "deepseek-v2-236b")
WORLD = 4
STEPS = 2
BATCH, SEQ = 4, 16
PROMPT, NEW = 3, 4


def leaf_errors(got, want) -> dict:
    """Per leaf: the largest absolute difference and the leaf's largest element."""
    from repro_torch.distributed.checkpoint import named_leaves

    return {name: [float((a - b).abs().max()), float(b.abs().max())]
            for (name, a), (_, b) in zip(named_leaves(got), named_leaves(want))}


def run_arch(arch: str, mesh, out: Path) -> dict:
    from repro_torch.configs import ARCHS as ALL, reduced
    from repro_torch.distributed.checkpoint import save_checkpoint
    from repro_torch.distributed.context import mesh_scope
    from repro_torch.distributed.sharding import (
        batch_pspecs, cache_pspecs, dp_axes, full_tree, param_pspecs, place, place_tree,
    )
    from repro_torch.launch.train import host_float, train_batch
    from repro_torch.models.convert import load_params
    from repro_torch.models.model import init_cache, init_model
    from repro_torch.serving.serve import make_serve_step
    from repro_torch.training import OptConfig, adamw_init, make_train_step

    cfg = dataclasses.replace(reduced(ALL[arch]), compute_dtype="float32")
    rng = np.random.default_rng(1)
    batches = [train_batch(cfg, rng.integers(0, cfg.vocab_size, (BATCH, SEQ)), "cpu")
               for _ in range(STEPS)]
    step = make_train_step(cfg, OptConfig(warmup_steps=2, total_steps=10))

    def fresh():
        params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
        return params.requires_grad_(True)

    plain = fresh()
    plain_opt = adamw_init(plain)
    sharded = place_tree(fresh(), param_pspecs(plain), mesh)
    sharded_opt = adamw_init(sharded)
    losses = []
    for batch in batches:
        plain, plain_opt, want = step(plain, plain_opt, batch)
        with mesh_scope(mesh):
            sharded, sharded_opt, got = step(
                sharded, sharded_opt, place_tree(batch, batch_pspecs(batch, mesh), mesh))
        losses.append({k: [host_float(got[k]), float(want[k])]
                       for k in ("loss", "aux_loss", "grad_norm", "lr")})
    trained = {"params": full_tree(sharded), "m": full_tree(sharded_opt["m"]),
               "v": full_tree(sharded_opt["v"])}
    result = {
        "losses": losses,
        "params": leaf_errors(trained["params"], plain),
        "m": leaf_errors(trained["m"], plain_opt["m"]),
        "v": leaf_errors(trained["v"], plain_opt["v"]),
        "step": [int(sharded_opt["step"]), int(plain_opt["step"])],
        "placed": sorted({type(p).__name__ for p in sharded.parameters()}),
    }
    save_checkpoint(out / arch / "mesh", STEPS, params=sharded, opt_state=sharded_opt)
    if dist.get_rank() == 0:
        save_checkpoint(out / arch / "plain", STEPS, params=trained["params"],
                        opt_state={"m": trained["m"], "step": sharded_opt["step"],
                                   "v": trained["v"]})

    # greedy decoding of the trained model, on the mesh and on one device
    with torch.no_grad():
        serve = make_serve_step(cfg)
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))).int()
        params = load_params(init_model(torch.Generator().manual_seed(0), cfg, device="cpu"),
                             trained["params"])
        sharded.requires_grad_(False)

        def decode(p, cache, toks, on_mesh):
            with mesh_scope(mesh if on_mesh else None):
                for t in range(PROMPT - 1):
                    _, _, cache = serve(p, cache, toks[:, t:t + 1], t)
                tok, outs = toks[:, -1:], []
                for t in range(NEW):
                    tok, _, cache = serve(p, cache, tok, PROMPT - 1 + t)
                    outs.append(tok)
                return torch.cat(outs, 1)

        cache = init_cache(cfg, BATCH, PROMPT + NEW, device="cpu")
        want = decode(params, cache, prompts, False)
        cache = init_cache(cfg, BATCH, PROMPT + NEW, device="cpu")
        cache = place_tree(cache, cache_pspecs(cache, mesh), mesh)
        got = decode(sharded, cache, place(prompts, (dp_axes(mesh), None), mesh), True)
        result["tokens"] = [got.full_tensor().tolist(), want.tolist()]
    return result


def child(rank: int, out: str) -> None:
    one_thread()  # four ranks with a thread per core each oversubscribe the CPU
    out = Path(out)
    dist.init_process_group("gloo", store=dist.FileStore(str(out / "store"), WORLD),
                            rank=rank, world_size=WORLD)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.launch.train import _auto_mesh

        auto = _auto_mesh("auto")
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        result = {"auto_mesh": dict(zip(auto.mesh_dim_names, auto.shape))}
        for arch in ARCHS:
            result[arch] = run_arch(arch, mesh, out)
        if rank == 0:
            (out / "result.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    os.environ.update(ONE_THREAD_ENV)
    mp.spawn(child, args=(sys.argv[1],), nprocs=WORLD)
