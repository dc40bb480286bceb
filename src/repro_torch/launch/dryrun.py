"""Multi-pod dry run: every (arch x shape x mesh) cell's step run on abstract
tensors laid out over the production mesh.

The port's copy of the JAX package's ``launch/dryrun.py``.  Where the
reference forces 512 host devices and ``lower().compile()`` s each cell, the
port starts a process group of 256 or 512 ranks on the ``fake`` backend (in
:func:`main`, never at import) and, as rank 0, runs the cell's step eagerly
on ``meta`` tensors placed as ``DTensor`` s by the sharding rules: that
proves the shardings divide and the step runs.  Each cell writes the
reference's JSON keys under ``results/dryrun/``:

* ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes`` per
  device, summed over the local shards of the step's arguments and outputs;
  ``temp_size_in_bytes`` and ``generated_code_size_in_bytes`` are ``null``:
  they describe XLA's compiled buffer assignment and code, and eager torch
  has neither;
* ``flops``: per device, the products' floating-point operations
  (``torch.utils.flop_counter``'s formulas: matrix products, attention,
  convolutions; not the elementwise work XLA's cost analysis also counts)
  over the local shards, counted at full depth: eager torch runs every layer,
  so the reference's two-point depth extrapolation is not needed
  (``flops_scanned`` and ``collectives_scanned``, the scanned compile's
  counts, are ``null``); ``bytes_accessed`` is ``null``: XLA's post-fusion
  bytes have no eager counterpart;
* ``collectives``: bytes moved per device by each collective the
  redistributions issue, recorded as DTensor's functional collectives reach
  the local tensors (their size and group), under the reference's ring
  model (:func:`ring_bytes`).

``full_compile_s`` is the seconds of the full-depth step run (there is no
compile).  A decode cell runs at position ``seq_len - 1``.  The numbers are
computed on the host; no device runs.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \
      --shape train_4k --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, SHAPES, runnable_shapes
from ..distributed.checkpoint import named_leaves
from ..distributed.context import mesh_scope
from ..distributed.sharding import batch_pspecs, cache_pspecs, dp_axes, param_pspecs, place, \
    place_tree
from ..launch.specs import input_specs
from ..models.model import decode_step, encode, forward
from ..training.optimizer import OptConfig
from ..training.train_step import make_train_step
from .mesh import PODS, POD_SHAPE, make_production_mesh


def ring_bytes(op: str, size: int, group: int) -> float:
    """Per-device bytes one collective moves (the reference's ring model).

    ``size`` is the per-device size the reference reads off the partitioned
    HLO: the operand of an all-reduce, all-to-all or collective-permute, the
    *output* of an all-gather or reduce-scatter.  Ring factors: all-reduce
    2s(g-1)/g, all-gather s_out(g-1)/g, reduce-scatter s_out(g-1), all-to-all
    s(g-1)/g, collective-permute s."""
    g = group
    if op == "all-reduce":
        return 2 * size * (g - 1) / g
    if op == "all-gather":
        return size * (g - 1) / g
    if op == "reduce-scatter":
        return size * (g - 1)
    if op == "all-to-all":
        return size * (g - 1) / g
    return size  # collective-permute, and any other point-to-point move


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: functional collective -> (the reference's op name, its per-device size
#: from the operand's bytes and the group size)
_COLLECTIVES = {
    "all_reduce": ("all-reduce", lambda s, g: s),
    "all_reduce_": ("all-reduce", lambda s, g: s),
    "all_gather_into_tensor": ("all-gather", lambda s, g: s * g),
    "all_gather_into_tensor_out": ("all-gather", lambda s, g: s * g),
    "reduce_scatter_tensor": ("reduce-scatter", lambda s, g: s // g),
    "all_to_all_single": ("all-to-all", lambda s, g: s),
    "broadcast": ("collective-permute", lambda s, g: s),
    "broadcast_": ("collective-permute", lambda s, g: s),
}


class LocalCost(TorchDispatchMode):
    """Counts what the local shards do: the flops of each local operation
    (``torch.utils.flop_counter``'s formulas) and the bytes of each
    functional collective.  A ``DTensor`` operation is handed on to DTensor
    (``NotImplemented``), which then runs its local operations and
    collectives under this mode."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives: dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out  # DTensor's shape propagation on global fake tensors, not local work
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace == "_c10d_functional" and packet.__name__ in _COLLECTIVES:
            op, size_of = _COLLECTIVES[packet.__name__]
            group = _group_size(args[-1])
            moved = ring_bytes(op, size_of(_nbytes(args[0]), group), group)
            self.collectives[op] = self.collectives.get(op, 0.0) + moved
        return out


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for _, leaf in named_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += _nbytes(leaf.to_local() if isinstance(leaf, DTensor) else leaf)
    return total


def _step_and_args(cfg, shape, mesh):
    """(fn, placed arguments) of the cell's step."""
    specs = input_specs(cfg, shape)
    pspecs = param_pspecs(specs["params"])
    params = place_tree(specs["params"], pspecs, mesh)
    if shape.kind == "train":
        params.requires_grad_(True)
        opt = specs["opt_state"]
        opt = {"m": place_tree(opt["m"], pspecs, mesh), "v": place_tree(opt["v"], pspecs, mesh),
               "step": opt["step"]}
        batch = place_tree(specs["batch"], batch_pspecs(specs["batch"], mesh), mesh)
        return make_train_step(cfg, OptConfig()), (params, opt, batch)
    if shape.kind == "prefill":
        def prefill(params, batch):
            memory = None
            if cfg.enc_layers:
                memory = encode(params, cfg, batch["enc_embeds"])
            elif cfg.num_vision_tokens:
                memory = batch["vision_embeds"]
            return forward(params, cfg, batch["tokens"], memory=memory)[0]

        batch = place_tree(specs["batch"], batch_pspecs(specs["batch"], mesh), mesh)
        return prefill, (params, batch)

    def serve(params, cache, tokens, pos):
        logits, cache = decode_step(params, cfg, tokens, cache, pos)
        return torch.argmax(logits[:, -1], dim=-1), cache

    cache = place_tree(specs["cache"], cache_pspecs(specs["cache"], mesh), mesh)
    tokens = place(specs["tokens"], (dp_axes(mesh), None), mesh)
    return serve, (params, cache, tokens, shape.seq_len - 1)


def analyse(cfg, shape, mesh) -> dict:
    """Run one cell's step on ``mesh``; its per-device memory, flops and
    collectives."""
    fn, args = _step_and_args(cfg, shape, mesh)
    arg_bytes = _local_bytes(list(args))
    cost = LocalCost()
    t0 = time.time()
    # the cost mode below mesh_scope's: a DTensor operation reaches it after
    # its constants were replicated, and is handed on to DTensor from there
    with cost, mesh_scope(mesh), torch.set_grad_enabled(shape.kind == "train"):
        out = fn(*args)
    seconds = time.time() - t0
    return {
        "seconds": seconds,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": _local_bytes(
                       list(out) if isinstance(out, tuple) else [out]),
                   "temp_size_in_bytes": None,
                   "generated_code_size_in_bytes": None},
        "flops": float(cost.flops),
        "collectives": cost.collectives,
    }


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: pathlib.Path,
             cfg_override=None, mesh=None) -> dict:
    """One cell -> its record, also written to ``out_dir``.  ``mesh``
    defaults to the production mesh (the process group must have its
    ranks)."""
    cfg = cfg_override if cfg_override is not None else ARCHS[arch]
    shape = SHAPES[shape_name]
    name = mesh_name(multi_pod)
    out_path = out_dir / f"{arch}__{shape_name}__{name}.json"
    rec = {"arch": arch, "shape": shape_name, "mesh": name, "kind": shape.kind, "ok": False}
    t0 = time.time()
    try:
        if shape_name not in runnable_shapes(cfg):
            rec["skipped"] = "full-attention arch: long-context decode inapplicable"
            rec["ok"] = True
            out_path.write_text(json.dumps(rec, indent=1))
            print(f"SKIP {arch} {shape_name} {name}")
            return rec
        if mesh is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        full = analyse(cfg, shape, mesh)
        colls = full["collectives"]
        rec.update(
            ok=True,
            total_s=round(time.time() - t0, 2),
            full_compile_s=round(full["seconds"], 2),
            n_periods=cfg.n_periods,
            flops=full["flops"],
            bytes_accessed=None,
            flops_scanned=None,
            memory=full["memory"],
            collectives=colls,
            collective_bytes=sum(colls.values()),
            collectives_scanned=None,
        )
        mem = full["memory"]
        print(f"PASS {arch} {shape_name} {name} ({rec['total_s']:.0f}s flops={rec['flops']:.3g} "
              f"coll={rec['collective_bytes']:.3g}B args={mem['argument_size_in_bytes']/2**30:.2f}GiB "
              f"out={mem['output_size_in_bytes']/2**30:.2f}GiB per device)")
    except Exception:
        rec["error"] = traceback.format_exc()
        print(f"FAIL {arch} {shape_name} {name}")
        print(rec["error"][-2000:])
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def start_fake_group(world_size: int) -> None:
    """This process as rank 0 of a ``world_size``-rank process group on the
    ``fake`` backend (its collectives move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true", help="recompute existing")
    ap.add_argument("--set", nargs="*", default=None, metavar="K=V",
                    help="config overrides for perf variants, e.g. "
                         "--set logits_bf16_ce=true remat_policy=dots")
    args = ap.parse_args(argv)
    from .cli import parse_overrides

    overrides = parse_overrides(args.set or [])

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    world = PODS * POD_SHAPE[0] * POD_SHAPE[1] if True in meshes else POD_SHAPE[0] * POD_SHAPE[1]
    start_fake_group(world)

    n_pass = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                f = out_dir / f"{arch}__{shape}__{mesh_name(mp)}.json"
                if f.exists() and not args.force:
                    rec = json.loads(f.read_text())
                    print(("PASS" if rec.get("ok") else "FAIL")
                          + f" {arch} {shape} {mesh_name(mp)} (cached)")
                else:
                    cfg_override = (dataclasses.replace(ARCHS[arch], **overrides)
                                    if overrides else None)
                    rec = run_cell(arch, shape, mp, out_dir, cfg_override=cfg_override)
                n_pass += bool(rec.get("ok"))
                n_fail += not rec.get("ok")
    print(f"\ndry-run complete: {n_pass} pass / {n_fail} fail")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
