"""Named-axis sharding rules (MaxText-style logical rules, path-based).

The port's copy of the JAX package's ``distributed/sharding.py``.  Mesh axes:
``("data", "model")`` single-pod, ``("pod", "data", "model")`` multi-pod.
The pod axis is pure data parallelism (gradient all-reduce rides the
inter-pod links once per step); "model" carries tensor/expert parallelism;
decode KV caches are sequence-sharded over "model" (split-K decode), which
keeps every architecture's cache shardable regardless of its KV head count.

A *spec* is the port's ``PartitionSpec``: a tuple with one entry per tensor
dimension, each ``None`` (replicated), an axis name, or a tuple of names
(the dimension split over several mesh axes, the first one major).  A
*mesh* is anything with named axis sizes: a
:class:`~torch.distributed.device_mesh.DeviceMesh` whose ``mesh_dim_names``
are the axes, or a plain ``{axis: size}`` dict, which is enough for the
rules (the counterpart of JAX's ``AbstractMesh``).

On a multi-pod mesh the "pod" and "data" axes only ever shard a dimension
together (:func:`dp_axes`), pod-major, which is one shard of 32 over the
two axes flattened: tensors are laid out over :func:`layout_mesh`, a 2-D
view ``("pod_data", "model")`` of the mesh.  (Over the 3-D mesh DTensor
plans each reshape of a batch dimension split over two mesh axes with a
search that takes minutes per operation at 2x16x16.)

``param_pspecs``/``cache_pspecs``/``batch_pspecs`` assign a spec to every
leaf of a tree from suffix rules on its path, the leaf names of
:func:`~repro_torch.distributed.checkpoint.named_leaves` split on ``::`` (the
reference's pytree paths); they return ``{leaf name: spec}``.  Stacked-layer
leaves carry one extra leading axis; the rule table is written for the
unstacked layer and a leading ``None`` is prepended automatically when the
leaf has one more dimension than its rule.

:func:`to_placements` turns a spec into DTensor placements over a
``DeviceMesh`` (the counterpart of ``NamedSharding``): mesh dimension ``i``
is ``Shard(d)`` when tensor dimension ``d`` names its axis, ``Replicate()``
otherwise; :func:`place` and :func:`place_tree` lay tensors out so.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .checkpoint import _as_container, named_leaves

MODEL = "model"
#: the "pod" and "data" axes of a multi-pod mesh flattened
POD_DATA = "pod_data"

Spec = tuple


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh):
    """Batch ("data-parallel") mesh axes, including the pod axis if present."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


# --- parameter rules: (path suffix) -> base spec (unstacked layer) ----------
_PARAM_RULES: list[tuple[tuple[str, ...], Spec]] = [
    # embeddings / head
    (("embed",), (MODEL, None)),
    (("lm_head",), (None, MODEL)),
    # attention / mlstm projections
    (("mixer", "wq"), (None, MODEL)),
    (("mixer", "wk"), (None, MODEL)),
    (("mixer", "wv"), (None, MODEL)),
    (("mixer", "wo"), (MODEL, None)),
    (("mixer", "bq"), (MODEL,)),
    (("mixer", "bk"), (MODEL,)),
    (("mixer", "bv"), (MODEL,)),
    (("xmixer", "wq"), (None, MODEL)),
    (("xmixer", "wk"), (None, MODEL)),
    (("xmixer", "wv"), (None, MODEL)),
    (("xmixer", "wo"), (MODEL, None)),
    # MLA
    (("mixer", "wq_a"), (None, None)),
    (("mixer", "wq_b"), (None, MODEL)),
    (("mixer", "wkv_a"), (None, None)),
    (("mixer", "wk_b"), (None, MODEL)),
    (("mixer", "wv_b"), (None, MODEL)),
    # dense FFN
    (("ffn", "w_gate"), (None, MODEL)),
    (("ffn", "w_in"), (None, MODEL)),
    (("ffn", "w_out"), (MODEL, None)),
    # MoE (expert-parallel over "model")
    (("moe", "router"), (None, None)),
    (("moe", "w_gate"), (MODEL, None, None)),
    (("moe", "w_in"), (MODEL, None, None)),
    (("moe", "w_out"), (MODEL, None, None)),
    (("shared", "w_gate"), (None, MODEL)),
    (("shared", "w_in"), (None, MODEL)),
    (("shared", "w_out"), (MODEL, None)),
    # Mamba
    (("mixer", "in_proj"), (None, MODEL)),
    (("mixer", "conv_w"), (None, MODEL)),
    (("mixer", "conv_b"), (MODEL,)),
    (("mixer", "x_proj"), (MODEL, None)),
    (("mixer", "dt_proj"), (None, MODEL)),
    (("mixer", "dt_bias"), (MODEL,)),
    (("mixer", "A_log"), (MODEL, None)),
    (("mixer", "D_skip"), (MODEL,)),
    (("mixer", "out_proj"), (MODEL, None)),
    # xLSTM
    (("mixer", "w_if"), (None, None)),
    (("mixer", "b_if"), (None,)),
    (("mixer", "ln_out"), (MODEL,)),
    (("mixer", "w_in"), (None, MODEL)),  # slstm input proj
    (("mixer", "b_in"), (MODEL,)),
    (("mixer", "r"), (None, None, MODEL, None)),
]


def _cache_rules(mesh) -> list[tuple[tuple[str, ...], Spec]]:
    """Self-attention KV and MLA compressed caches are sequence-sharded over
    "model" (split-K decode); recurrent states shard their channel dim;
    cross caches (vision/encoder memory) replicate over "model" (small)."""
    dp = dp_axes(mesh)
    return [
        (("cross", "k"), (dp, None, None, None)),
        (("cross", "v"), (dp, None, None, None)),
        (("mix", "k"), (dp, MODEL, None, None)),
        (("mix", "v"), (dp, MODEL, None, None)),
        (("mix", "ckv"), (dp, MODEL, None)),
        (("mix", "kr"), (dp, MODEL, None)),
        (("mix", "conv"), (dp, None, MODEL)),
        (("mix", "ssm"), (dp, MODEL, None)),
        (("mix", "C"), (dp, None, MODEL, None)),
        (("mix", "n"), (dp, None, MODEL)),
        (("mix", "m"), (dp, None)),
        (("mix", "c"), (dp, None, MODEL)),
        (("mix", "h"), (dp, None, MODEL)),
    ]


def _match(names: tuple[str, ...], suffix: tuple[str, ...]) -> bool:
    if len(suffix) > len(names):
        return False
    return names[-len(suffix):] == suffix


def _fit(spec: Spec, ndim: int) -> Spec:
    """Prepend Nones for stacked-layer leading axes; sanity-check rank."""
    if len(spec) == ndim:
        return spec
    if len(spec) < ndim:
        return (None,) * (ndim - len(spec)) + tuple(spec)
    raise ValueError(f"spec {spec} has more dims than leaf rank {ndim}")


def _axes(entry) -> tuple[str, ...]:
    """The mesh axes a spec entry names, in order (none for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def safe_pspec(spec: Spec, shape, mesh) -> Spec:
    """Drop sharding on any axis the mesh axes do not divide (replicate it).

    Keeps every (arch x shape) cell shardable: e.g. ``long_500k`` has global
    batch 1 (sequence/state dims carry the parallelism instead), and vision /
    encoder memory lengths (1601, 1500) do not divide the model axis.
    """
    sizes = axis_sizes(mesh)
    out = []
    for ax, s in enumerate(spec):
        size = 1
        for a in _axes(s):
            size *= sizes[a]
        out.append(s if s is not None and shape[ax] % size == 0 else None)
    return tuple(out)


def _assign(tree, rule) -> dict[str, Spec]:
    return {name: rule(tuple(name.split("::")), leaf) for name, leaf in named_leaves(tree)}


def param_pspecs(params) -> dict[str, Spec]:
    """``{leaf name: spec}`` of a parameter tree (norms replicate)."""

    def assign(names, leaf):
        for suffix, spec in _PARAM_RULES:
            if _match(names, suffix):
                return _fit(spec, leaf.ndim)
        # norms, small biases, routers not matched above: replicate
        return (None,) * leaf.ndim

    return _assign(params, assign)


def cache_pspecs(cache, mesh) -> dict[str, Spec]:
    """``{leaf name: spec}`` of a decode cache, divisibility-guarded (see
    :func:`_cache_rules`)."""
    rules = _cache_rules(mesh)

    def assign(names, leaf):
        for suffix, spec in rules:
            if _match(names, suffix):
                return safe_pspec(_fit(spec, leaf.ndim), leaf.shape, mesh)
        return (None,) * leaf.ndim

    return _assign(cache, assign)


def batch_pspecs(batch, mesh) -> dict[str, Spec]:
    """Inputs: shard the leading (batch) axis over all data axes."""
    dp = dp_axes(mesh)

    def assign(names, leaf):
        if leaf.ndim == 0:
            return ()
        return safe_pspec((dp,) + (None,) * (leaf.ndim - 1), leaf.shape, mesh)

    return _assign(batch, assign)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------
def layout_mesh(mesh):
    """The ``DeviceMesh`` tensors are laid out over: ``mesh`` itself, or for
    a multi-pod mesh the 2-D mesh ``(POD_DATA, "model")`` over the same
    ranks, pod-major (made once per mesh, and kept on it)."""
    if "pod" not in mesh.mesh_dim_names:
        return mesh
    layout = getattr(mesh, "_pod_data_layout", None)
    if layout is None:
        from torch.distributed.device_mesh import DeviceMesh

        ranks = mesh.mesh.reshape(-1, mesh.size(mesh.mesh_dim_names.index(MODEL)))
        layout = DeviceMesh(mesh.device_type, ranks, mesh_dim_names=(POD_DATA, MODEL))
        mesh._pod_data_layout = layout
    return layout


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over :func:`layout_mesh` of the
    ``DeviceMesh`` ``mesh``: one per mesh dimension, ``Shard(d)`` where tensor
    dimension ``d`` names its axis, else ``Replicate()``.  A dimension split
    over several axes must name them in the mesh's order (pod-major, as JAX
    splits it); on a multi-pod mesh "pod" and "data" only together."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(layout_mesh(mesh).mesh_dim_names)
    placements = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if POD_DATA in names and {"pod", "data"} & set(axes):
            if axes[:2] != ("pod", "data"):
                raise ValueError(f"spec entry {entry} splits the pod and data axes")
            axes = (POD_DATA, *axes[2:])
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in dims:
            placements[i] = Shard(d)
    return tuple(placements)


def place(tensor: torch.Tensor, spec: Spec, mesh):
    """``tensor`` (the same full value on every rank) as a ``DTensor`` laid
    out by ``spec`` guarded by :func:`safe_pspec` (over the axis sizes of
    ``mesh``); each rank keeps its own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    spec = safe_pspec(spec, tensor.shape, mesh)
    return distribute_tensor(tensor, layout_mesh(mesh), to_placements(spec, mesh),
                             src_data_rank=None)


def place_tree(tree, specs: dict[str, Spec], mesh):
    """A tree with every leaf placed by ``specs`` (``{leaf name: spec}``).

    A module's parameters are replaced in it by parameters over their
    ``DTensor`` (``requires_grad`` kept) and the module is returned; dicts
    and lists come back as new containers of the placed leaves."""
    def walk(node, path):
        if isinstance(node, nn.Module) and not isinstance(node, nn.ModuleList):
            for name, p in list(node.named_parameters(recurse=False)):
                key = "::".join((*path, name))
                node._parameters[name] = nn.Parameter(place(p.detach(), specs[key], mesh),
                                                      requires_grad=p.requires_grad)
            for name, child in node.named_children():
                walk(child, (*path, name))
            return node
        if isinstance(node, nn.ModuleList):
            for i, child in enumerate(node):
                walk(child, (*path, str(i)))
            return node
        node = _as_container(node)
        if isinstance(node, dict):
            return {k: walk(v, (*path, str(k))) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, (*path, str(i))) for i, v in enumerate(node)]
        return place(node, specs["::".join(path)], mesh)

    return walk(tree, ())


def full_tree(tree):
    """A tree of ``DTensor`` leaves gathered into plain tensors (dicts and
    lists; a module as the dict of its parameters)."""
    from torch.distributed.tensor import DTensor

    node = _as_container(tree)
    if isinstance(node, dict):
        return {k: full_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [full_tree(v) for v in node]
    return node.full_tensor() if isinstance(node, DTensor) else node


__all__ = ["MODEL", "POD_DATA", "axis_sizes", "batch_pspecs", "cache_pspecs", "dp_axes",
           "full_tree", "layout_mesh", "param_pspecs", "place", "place_tree", "safe_pspec",
           "to_placements"]
