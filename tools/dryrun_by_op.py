#!/usr/bin/env python3
"""One dry-run cell's products per device, by operator and operand shapes.

Runs the cell's step as ``repro_torch.launch.dryrun`` does (``meta``
tensors placed over a mesh of a ``fake`` process group, this process rank
0), with its ``LocalCost`` mode extended to sum the flops of each local
product by ``(operator, operand shapes)``, and prints the largest of them,
the per-device totals (flops, temporaries, outputs, collective bytes) and
the even-share ratio: the per-device flops times the number of devices over
the flops of the same step on one device (``mesh=None``).  A ratio above 1
is work some device repeats.  A diagnostic, not part of the package.

Run from the repo root::

    PYTHONPATH=src python3 tools/dryrun_by_op.py --arch qwen2.5-3b --shape train_4k --mesh 16x16
    PYTHONPATH=src python3 tools/dryrun_by_op.py --arch qwen2.5-3b --reduced \\
        --shape train:256:8 --mesh 2x4 --ratio

``--mesh`` is ``DxM`` (axes data, model) or ``PxDxM`` (pod, data, model);
``--shape`` a named shape or ``kind:seq:batch``.
"""

import argparse
import collections
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, InputShape, reduced  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cli import parse_overrides  # noqa: E402


class ByOp(dryrun.LocalCost):
    """``LocalCost`` that also sums each product's flops by its operator and
    operand shapes."""

    def __init__(self, args=()):
        super().__init__(args)
        self.by_op = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.flops != before:
            shapes = tuple(tuple(t.shape) for t in dryrun._tensors((args, kwargs or {})))
            self.by_op[(func._overloadpacket.__name__, shapes)] += self.flops - before
        return out


def parse_shape(text: str) -> InputShape:
    if text in SHAPES:
        return SHAPES[text]
    kind, seq, batch = text.split(":")
    return InputShape(text, int(seq), int(batch), kind)


def make_mesh(text: str):
    """The mesh ``text`` names over a fake process group of its size (started
    here) -> (mesh, number of devices)."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(int(s) for s in text.split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    n = 1
    for s in shape:
        n *= s
    dryrun.start_fake_group(n)
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=names), n


def measure(cfg, shape, mesh):
    """(the dry run's record of the cell, its products by operator)."""
    fn, args = dryrun._step_and_args(cfg, shape, mesh)
    leaves = dryrun._local_leaves(list(args))
    cost = ByOp(leaves)
    with cost, dryrun.mesh_scope(mesh), torch.set_grad_enabled(shape.kind == "train"):
        out = fn(*args)
    outs = dryrun._local_leaves(list(out) if isinstance(out, tuple) else [out])
    return {"flops": float(cost.flops), "temp": cost.temp_bytes(outs),
            "out": sum(map(dryrun._nbytes, outs)),
            "coll": sum(cost.collectives.values())}, cost.by_op


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--ratio", action="store_true",
                    help="also run the one-device step and print the even-share ratio")
    ap.add_argument("--set", nargs="*", default=None, metavar="K=V")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    cfg = reduced(cfg) if args.reduced else cfg
    cfg = dataclasses.replace(cfg, **parse_overrides(args.set or []))
    shape = parse_shape(args.shape)
    mesh, n = make_mesh(args.mesh)
    rec, by_op = measure(cfg, shape, mesh)
    print(f"torch {torch.__version__}: {args.arch}{' reduced' if args.reduced else ''} "
          f"{shape.name} on {args.mesh}, per device (computed on the CPU): "
          f"{rec['flops']:.6g} FLOP of products, temporaries {rec['temp']} B "
          f"({rec['temp'] / 2**30:.3f} GiB), outputs {rec['out']} B "
          f"({rec['out'] / 2**30:.3f} GiB), collectives {rec['coll']:.6g} B")
    for (op, shapes), flops in by_op.most_common(args.top):
        print(f"  {flops:14.6g} FLOP {flops / rec['flops']:7.2%}  {op} "
              + " x ".join(str(s) for s in shapes))
    if args.ratio:
        one = dryrun.analyse(cfg, shape, None)["flops"]
        print(f"even-share ratio: {rec['flops']:.6g} x {n} / {one:.6g} = "
              f"{rec['flops'] * n / one:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
