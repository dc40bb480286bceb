"""Checkpointing with LTSP-scheduled archive restore.

Two tiers:

* **hot tier** — a plain directory of ``.npy`` leaves + ``manifest.json``
  (:func:`save_checkpoint`/:func:`load_checkpoint`: bit-exact, the
  reference's file names and manifest keys, so either package reads what
  the other wrote);
* **archive tier** — a checkpoint's shards are written sequentially to the simulated tape library
(:func:`archive_to_tape`).  A multi-pod restore requests every shard once per
consumer pod (that multiplicity is exactly LTSP's request multiplicity); the
restore read order is produced by the paper's DP/SimpleDP schedulers
(:func:`plan_restore`), minimising the *mean* shard arrival time so pods
start resharding work as early as possible instead of waiting for a
positional sweep.

Leaf names follow the JAX package's pytree paths: nested ``dict``/``list``/
``tuple`` containers of numpy arrays or torch tensors flatten depth-first,
dict keys in sorted order, sequence entries by index, ``None`` as an empty
subtree, joined with ``::``.  A :class:`torch.nn.Module` flattens as the
dict of its parameters and children (an ``nn.ModuleList`` as a list), so
the port's model archives under the reference's names.
"""

from __future__ import annotations

import json
import pathlib
import re
from typing import Any

import numpy as np
import torch
from torch import nn

from ..storage.tape import ReadPlan, TapeLibrary

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "archive_to_tape",
    "plan_restore",
    "named_leaves",
]

_SEP = "::"


def _as_container(tree):
    """A module as the container it stands for: an ``nn.ModuleList`` as a
    list, any other module as the dict of its parameters and children."""
    if isinstance(tree, nn.ModuleList):
        return list(tree)
    if isinstance(tree, nn.Module):
        return {**dict(tree.named_parameters(recurse=False)), **dict(tree.named_children())}
    return tree


def _leaves(tree, path: tuple[str, ...] = ()):
    """``(path, leaf)`` pairs of a nested container, in pytree order."""
    if tree is None:
        return
    tree = _as_container(tree)
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*path, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, (*path, str(i)))
    else:
        yield path, tree


def _numel(leaf: Any) -> int:
    return leaf.numel() if isinstance(leaf, torch.Tensor) else np.asarray(leaf).size


def named_leaves(tree) -> list[tuple[str, Any]]:
    """``(name, leaf)`` of every leaf, in pytree order."""
    return [(_SEP.join(path), leaf) for path, leaf in _leaves(tree)]


def _flatten_with_names(tree) -> list[tuple[str, int]]:
    """``(name, numel)`` of every leaf, in pytree order."""
    return [(name, _numel(leaf)) for name, leaf in named_leaves(tree)]


def _structure(tree) -> str:
    """The tree's containers in ``PyTreeDef`` notation (``*`` a leaf), which
    is what JAX's ``str(treedef)`` prints for dicts, lists, tuples and None."""
    tree = _as_container(tree)
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(t) for t in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(t) for t in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a numpy array; a ``DTensor`` leaf gathered whole first
    (a collective: every rank of its mesh calls it)."""
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _laid_out_as(tensor: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """``tensor`` (the whole leaf) on ``template``'s device; for a ``DTensor``
    template laid out as it, each rank keeping its own shard."""
    if not _is_dtensor(template):
        return tensor.to(template.device)
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(tensor.to(template.device), template.device_mesh,
                             template.placements, src_data_rank=None)


def _is_writer() -> bool:
    """Whether this process writes files: the only one, or rank 0 of the
    process group."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _file_name(i: int, tree_name: str, leaf_name: str) -> str:
    return f"{i:05d}_" + re.sub(r"[^A-Za-z0-9_.-]", "_", f"{tree_name}{_SEP}{leaf_name}") + ".npy"


# ---------------------------------------------------------------------------
# hot tier
# ---------------------------------------------------------------------------
def save_checkpoint(path: str | pathlib.Path, step: int, **trees: Any) -> None:
    """Write named trees (e.g. ``params=model``) as ``.npy`` leaves + manifest.

    The file names and manifest keys are the reference's.  Its ``treedef``
    entry is JAX's ``str(treedef)``, which needs JAX; the port writes its own
    rendering of the tree's containers there (:func:`_structure`: the same
    text for dicts, lists, tuples and None, a module written as the dict of
    its parameters and children).  Neither package reads the entry back:
    both load by a template.

    Trees of ``DTensor`` s (the mesh path) are written gathered, so the
    files are the one-device port's byte for byte; every rank gathers and
    rank 0 of the process group writes.
    """
    path = pathlib.Path(path)
    writer = _is_writer()
    if writer:
        path.mkdir(parents=True, exist_ok=True)
    manifest: dict[str, Any] = {"step": int(step), "trees": {}}
    for tree_name, tree in trees.items():
        leaves = [(n, _to_numpy(leaf)) for n, leaf in named_leaves(tree)]
        manifest["trees"][tree_name] = {
            "treedef": f"PyTreeDef({_structure(tree)})",
            "leaves": [
                {"name": n, "shape": list(a.shape), "dtype": str(a.dtype)}
                for n, a in leaves
            ],
        }
        files = [_file_name(i, tree_name, n) for i, (n, _) in enumerate(leaves)]
        if writer:
            for f, (_, arr) in zip(files, leaves):
                np.save(path / f, arr)
        manifest["trees"][tree_name]["files"] = files
    if writer:
        (path / "manifest.json").write_text(json.dumps(manifest))


def _unflatten(template, arrays):
    """``template``'s containers with its leaves taken from ``arrays`` in
    pytree order (dicts come back with their keys sorted, as JAX's do).  A
    tensor leaf of the template comes back as a tensor on its device, of its
    shape and dtype (or the load refuses), laid out as it if it is a
    ``DTensor``; any other leaf as the array."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], arrays) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(t, arrays) for t in template)
    arr = next(arrays)
    if not isinstance(template, torch.Tensor):
        return arr
    leaf = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if leaf.shape != template.shape or leaf.dtype != template.dtype:
        raise ValueError(f"checkpoint leaf {tuple(leaf.shape)} {leaf.dtype} does not match "
                         f"its template {tuple(template.shape)} {template.dtype}")
    return _laid_out_as(leaf, template)


def load_checkpoint(path: str | pathlib.Path, **templates: Any):
    """Restore trees by structure templates -> ``(step, {name: tree})``.

    A container template comes back as the same containers holding numpy
    arrays, or tensors on the device of each tensor leaf of the template (an
    optimizer state goes back to the card as float32 moments and an int32
    step); a module template (the port's model) has the arrays copied into
    its parameters, each checked by name, shape and dtype
    (:func:`repro_torch.models.convert.load_named`), and comes back itself.
    """
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    out = {}
    for tree_name, template in templates.items():
        info = manifest["trees"][tree_name]
        arrays = [np.load(path / f) for f in info["files"]]
        if isinstance(template, nn.Module):
            from ..models.convert import load_named

            names = [leaf["name"] for leaf in info["leaves"]]
            out[tree_name] = load_named(template, dict(zip(names, arrays)))
        else:
            out[tree_name] = _unflatten(template, iter(arrays))
    return manifest["step"], out


# ---------------------------------------------------------------------------
# archive tier (tape-backed) — the paper's technique as a framework feature
# ---------------------------------------------------------------------------
def archive_to_tape(
    library: TapeLibrary, ckpt_name: str, params, bytes_per_elem: int = 4
) -> list[str]:
    """Append every leaf of a checkpoint sequentially to the tape library."""
    names = []
    for leaf_name, numel in _flatten_with_names(params):
        fname = f"{ckpt_name}/{leaf_name}"
        library.store(fname, max(1, numel * bytes_per_elem))
        names.append(fname)
    return names


def plan_restore(
    library: TapeLibrary,
    shard_names: list[str],
    consumers_per_shard: int | dict[str, int] = 1,
    policy: str = "simpledp",
    backend: str | None = None,
    cache=None,
    *,
    context=None,
) -> list[ReadPlan]:
    """LTSP-scheduled restore: order shard reads to minimise mean arrival.

    ``consumers_per_shard`` is the request multiplicity (e.g. the number of
    pods that need the shard before they can start their reshard step).
    ``policy`` selects any registered solver; ``context`` (an
    :class:`repro_torch.core.ExecutionContext`, defaulting to the library's own)
    selects backend/cache/numeric options — with the library context carrying
    a :class:`repro_torch.core.SolveCache`, a restore re-planned against an
    unchanged archive is pure cache hits.  Device backends plan every
    cartridge in a few size-bucketed launches.  ``backend=``/``cache=`` are
    the deprecated pre-context spellings (warn, then fold into a context).
    """
    from ..core.context import resolve_context

    ctx = resolve_context(
        context, backend=backend, cache=cache, default=library.context
    )
    if isinstance(consumers_per_shard, int):
        requests = {n: consumers_per_shard for n in shard_names}
    else:
        requests = dict(consumers_per_shard)
    return library.schedule(requests, policy=policy, context=ctx)
