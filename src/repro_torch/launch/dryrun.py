"""Multi-pod dry run: every (arch x shape x mesh) cell's step run on abstract
tensors laid out over the production mesh.

The port's copy of the JAX package's ``launch/dryrun.py``.  Where the
reference forces 512 host devices and ``lower().compile()`` s each cell, the
port starts a process group of 256 or 512 ranks on the ``fake`` backend (in
:func:`main`, never at import) and, as rank 0, runs the cell's step eagerly
on ``meta`` tensors placed as ``DTensor`` s by the sharding rules: that
proves the shardings divide and the step runs.  Each cell writes the
reference's JSON keys under ``results/dryrun/``:

* ``memory``: per device, ``argument_size_in_bytes`` and
  ``output_size_in_bytes``, summed over the local shards of the step's
  arguments and outputs, and ``temp_size_in_bytes``, the high-water mark of
  the bytes held by the storages that the local operations create during
  the step, other than the outputs' (:class:`LocalCost`): each storage
  counts once, from the operation that creates it until it dies, so views
  and in-place updates add nothing, and the activations that autograd saves,
  the remat recompute and the gradients count as they come and go.  It
  counts what eager torch allocates, not XLA's buffer assignment; on the
  card the step's peak is about arguments + outputs + temporaries.
  ``generated_code_size_in_bytes`` is ``null``: eager torch compiles no
  code;
* ``flops``: per device, the products' floating-point operations
  (``torch.utils.flop_counter``'s formulas: matrix products, attention,
  convolutions; not the elementwise work XLA's cost analysis also counts)
  over the local shards, counted at full depth: eager torch runs every layer,
  so the reference's two-point depth extrapolation is not needed
  (``flops_scanned`` and ``collectives_scanned``, the scanned compile's
  counts, are ``null``); ``bytes_accessed``, per device, the bytes each
  local operation reads and writes (its tensor inputs' bytes plus its
  outputs'; a view or metadata operation counts nothing, a mutated argument
  is read once and written once), summed.  That is an unfused count: an
  upper bound on XLA's post-fusion "bytes accessed", and not comparable
  with the reference's, as the flops are not;
* ``collectives``: bytes moved per device by each collective the
  redistributions issue, recorded as DTensor's functional collectives reach
  the local tensors (their size and group), under the reference's ring
  model (:func:`ring_bytes`).  They are not in ``bytes_accessed``.

``full_compile_s`` is the seconds of the full-depth step run (there is no
compile).  A decode cell runs at position ``seq_len - 1``.  The numbers are
computed on the host; no device runs.  With ``mesh=None``,
:func:`analyse` runs the plain step of one device (no ``DTensor``).

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
import weakref

import torch
from torch.utils import _pytree as pytree
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


#: operations that allocate without reading or writing any element
_UNTOUCHED = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.layout == torch.strided]


class LocalCost(TorchDispatchMode):
    """Counts what the local shards do: the flops of each local operation
    (``torch.utils.flop_counter``'s formulas), the bytes it reads and
    writes, the bytes of each functional collective, and the storages it
    creates.  A ``DTensor`` operation is handed on to DTensor
    (``NotImplemented``), which then runs its local operations and
    collectives under this mode; so does autograd's backward, on whatever
    thread it runs (a dispatch mode is part of the state autograd carries
    into its threads).

    A storage is known by ``untyped_storage()``, which every view of it
    shares: the first operation that outputs a storage not known yet creates
    it, and it lives until torch frees it (a weak reference says when).
    The arguments' storages (``args``) are known from the start, so their
    in-place updates and views create nothing.  :meth:`temp_bytes` is the
    high-water mark of the created storages' bytes."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: dict[str, float] = {}
        self._clock = 0
        #: storage -> None for an argument's, [bytes, born, died] for a created one
        self._known = weakref.WeakKeyDictionary()
        self._made: list[list] = []
        for t in _tensors(args):
            self._known[t.untyped_storage()] = None

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _died(self, rec: list) -> None:
        rec[2] = self._tick()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(issubclass(t, FakeTensor) for t in types) or \
                any(isinstance(t, FakeTensor) for t in outs):
            return out  # DTensor's shape propagation on global fake tensors, not local work
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        ins = _tensors((args, kwargs))
        if func.namespace == "_c10d_functional":
            if packet.__name__ in _COLLECTIVES:
                op, size_of = _COLLECTIVES[packet.__name__]
                group = _group_size(args[-1])
                moved = ring_bytes(op, size_of(_nbytes(args[0]), group), group)
                self.collectives[op] = self.collectives.get(op, 0.0) + moved
        elif not _moves_no_data(func, ins, outs):
            self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            storage = t.untyped_storage()
            if storage not in self._known:
                rec = [storage.nbytes(), self._tick(), None]
                self._known[storage] = rec
                self._made.append(rec)
                weakref.finalize(storage, self._died, rec).atexit = False
        return out

    def temp_bytes(self, outputs=()) -> int:
        """The high-water mark of the bytes of the storages created so far
        and alive together, the storages of ``outputs`` left out."""
        kept = {id(self._known.get(t.untyped_storage())) for t in _tensors(outputs)}
        events = sorted((tick, size) for size, born, died in
                        (r for r in self._made if id(r) not in kept)
                        for tick, size in ((born, size), (died, -size)) if tick is not None)
        live = peak = 0
        for _, size in events:
            live += size
            peak = max(peak, live)
        return peak


def _moves_no_data(func, ins, outs) -> bool:
    """A view or metadata operation: it allocates without touching an
    element, or every output is an input's storage and nothing is written."""
    if func.is_view or func._overloadpacket.__name__ in _UNTOUCHED:
        return True
    if func._schema.is_mutable:
        return False
    storages = {id(t.untyped_storage()) for t in ins}
    return bool(outs) and all(id(t.untyped_storage()) in storages for t in outs)


def _local_leaves(tree) -> list[torch.Tensor]:
    from torch.distributed.tensor import DTensor

    return [leaf.to_local() if isinstance(leaf, DTensor) else leaf
            for _, leaf in named_leaves(tree) if isinstance(leaf, torch.Tensor)]


def _step_and_args(cfg, shape, mesh):
    """(fn, arguments) of the cell's step, placed over ``mesh`` (plain
    tensors with ``mesh=None``)."""
    specs = input_specs(cfg, shape)

    def lay(tree, pspecs_of):
        return tree if mesh is None else place_tree(tree, pspecs_of(tree), mesh)

    pspecs = param_pspecs(specs["params"])
    params = lay(specs["params"], lambda _: pspecs)
    if shape.kind == "train":
        params.requires_grad_(True)
        opt = specs["opt_state"]
        opt = {"m": lay(opt["m"], lambda _: pspecs), "v": lay(opt["v"], lambda _: pspecs),
               "step": opt["step"]}
        batch = lay(specs["batch"], lambda b: batch_pspecs(b, mesh))
        return make_train_step(cfg, OptConfig()), (params, opt, batch)
    if shape.kind == "prefill":
        def prefill(params, batch):
            memory = None
            if cfg.enc_layers:
                memory = encode(params, cfg, batch["enc_embeds"])
            elif cfg.num_vision_tokens:
                memory = batch["vision_embeds"]
            return forward(params, cfg, batch["tokens"], memory=memory)[0]

        return prefill, (params, lay(specs["batch"], lambda b: batch_pspecs(b, mesh)))

    def serve(params, cache, tokens, pos):
        logits, cache = decode_step(params, cfg, tokens, cache, pos)
        return torch.argmax(logits[:, -1], dim=-1), cache

    cache = lay(specs["cache"], lambda c: cache_pspecs(c, mesh))
    tokens = specs["tokens"] if mesh is None else place(specs["tokens"], (dp_axes(mesh), None),
                                                       mesh)
    return serve, (params, cache, tokens, shape.seq_len - 1)


def run_step(fn, args, mesh, grad: bool) -> dict:
    """``fn(*args)`` run under :class:`LocalCost` (and ``mesh_scope(mesh)``);
    its seconds, per-device memory, flops, bytes accessed and collectives."""
    leaves = _local_leaves(list(args))
    cost = LocalCost(leaves)
    t0 = time.time()
    # the cost mode below mesh_scope's: a DTensor operation reaches it after
    # its constants were replicated, and is handed on to DTensor from there
    with cost, mesh_scope(mesh), torch.set_grad_enabled(grad):
        out = fn(*args)
    seconds = time.time() - t0
    outs = _local_leaves(list(out) if isinstance(out, tuple) else [out])
    return {
        "seconds": seconds,
        "memory": {"argument_size_in_bytes": sum(map(_nbytes, leaves)),
                   "output_size_in_bytes": sum(map(_nbytes, outs)),
                   "temp_size_in_bytes": cost.temp_bytes(outs),
                   "generated_code_size_in_bytes": None},
        "flops": float(cost.flops),
        "bytes_accessed": cost.bytes_accessed,
        "collectives": cost.collectives,
    }


def analyse(cfg, shape, mesh) -> dict:
    """Run one cell's step on ``mesh`` (one device's plain step with
    ``mesh=None``); its per-device memory, flops, bytes accessed and
    collectives."""
    fn, args = _step_and_args(cfg, shape, mesh)
    return run_step(fn, args, mesh, shape.kind == "train")


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
            bytes_accessed=full["bytes_accessed"],
            flops_scanned=None,
            memory=full["memory"],
            collectives=colls,
            collective_bytes=sum(colls.values()),
            collectives_scanned=None,
        )
        mem = full["memory"]
        print(f"PASS {arch} {shape_name} {name} ({rec['total_s']:.0f}s flops={rec['flops']:.3g} "
              f"coll={rec['collective_bytes']:.3g}B args={mem['argument_size_in_bytes']/2**30:.2f}GiB "
              f"out={mem['output_size_in_bytes']/2**30:.2f}GiB "
              f"temp={mem['temp_size_in_bytes']/2**30:.2f}GiB per device)")
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
