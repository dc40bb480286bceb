"""Active-mesh context: lets model code emit sharding hints without taking a
mesh argument through every layer.

The port's copy of the JAX package's ``distributed/context.py``.
``set_active_mesh(mesh)`` is called by the launchers and the dry run around
the steps; ``shard_hint(x, spec_fn)`` returns ``x`` unchanged when no mesh is
active (the CPU tests, one device without a process group), so model code
is unchanged off the mesh path.  With a mesh active it redistributes the
``DTensor`` ``x`` to the divisibility-guarded spec, the counterpart of
``with_sharding_constraint``.

While a mesh is active the model's own constants (RoPE tables, masks, zero
states, index vectors) are plain tensors, identical on every rank; they
meet the ``DTensor`` parameters and activations under
:class:`ReplicateConstants`, a dispatch mode that :func:`mesh_scope`
enters: a plain tensor in an operation on ``DTensor`` s is taken as a
``DTensor`` replicated over their mesh.  This is what DTensor's
``implicit_replication`` (experimental) does, but a dispatch mode is part of
the state autograd carries into its backward threads (on the card backward
runs on a thread of its own, and the remat recompute makes constants there),
where that flag is not in every torch release.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

_MESH = None


class ReplicateConstants(TorchDispatchMode):
    """Plain tensors in an operation on ``DTensor`` s become ``DTensor`` s
    replicated over the first one's mesh (their values are the same on every
    rank); other operations run as they are."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            flat, spec = pytree.tree_flatten((args, kwargs))
            mesh = next(t.device_mesh for t in flat if isinstance(t, DTensor))
            rep = [Replicate()] * mesh.ndim
            flat = [DTensor.from_local(t, mesh, rep, run_check=False)
                    if isinstance(t, torch.Tensor) and not isinstance(t, DTensor) else t
                    for t in flat]
            args, kwargs = pytree.tree_unflatten(flat, spec)
        return func(*args, **kwargs)


def set_active_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def active_mesh():
    return _MESH


@contextlib.contextmanager
def mesh_scope(mesh):
    """``mesh`` active, and plain tensors taken as replicated in ``DTensor``
    operations (:class:`ReplicateConstants`), for the duration; ``mesh=None``
    changes nothing."""
    if mesh is None:
        yield
        return
    previous = _MESH
    set_active_mesh(mesh)
    try:
        with ReplicateConstants():
            yield
    finally:
        set_active_mesh(previous)


def is_sharded(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a tensor of the mesh path)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard_hint(x: torch.Tensor, spec_fn: Callable) -> torch.Tensor:
    """Redistribute ``x`` to ``spec_fn(mesh)`` if a mesh is active
    (divisibility-guarded); identity otherwise."""
    if _MESH is None or not is_sharded(x):
        return x
    from .sharding import safe_pspec, to_placements

    spec = safe_pspec(spec_fn(_MESH), x.shape, _MESH)
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` replicated over its mesh, for an operation that has no sharding
    strategy (GSPMD inserts the same all-gather); a plain tensor as it is."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


class _ReplicatedGrad(torch.autograd.Function):
    """The identity, whose backward replicates the gradient."""

    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return replicated(g)


def replicated_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient replicated over the mesh before it
    reaches the operation that made ``x``: the index operations of the dense
    MoE dispatch, whose backward on a sharded or partial gradient DTensor
    gets wrong in torch 2.11 (``index_add``'s source gradient) and which on
    replicated operands run locally.  A plain tensor as it is."""
    if not is_sharded(x):
        return x
    return _ReplicatedGrad.apply(x)


def _unsharded(x: torch.Tensor, dims: set[int]) -> torch.Tensor:
    from torch.distributed.tensor import Replicate

    placements = [Replicate() if p.is_shard() and p.dim in dims else p for p in x.placements]
    if list(placements) == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


class _Unshard(torch.autograd.Function):
    """:func:`unshard` forward, and the same for the gradient backward."""

    @staticmethod
    def forward(x, dims):
        out = _unsharded(x, dims)
        return x.view_as(x) if out is x else out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dims = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _unsharded(g, ctx.dims) if is_sharded(g) else g, None


def unshard(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with the mesh dimensions that shard any of ``dims`` replicated,
    and its gradient likewise: the head dimensions of the attention operands
    and outputs, which the batched products and their backward merge with
    the batch dimension (DTensor cannot merge a sharded dimension that is
    not the leading one in every torch release, so the heads are gathered
    there; GSPMD would choose its own layout).  A plain tensor as it is."""
    if not is_sharded(x):
        return x
    return _Unshard.apply(x, frozenset(d % x.ndim for d in dims))


class _Lookup(torch.autograd.Function):
    """``table[idx]`` whose backward scatters the gradient into zeros with
    both replicated (DTensor's strategy for the sharded scatter is not
    sound in every torch release, nor its in-place form registered); the same
    accumulating ``index_put`` the plain lookup's backward makes."""

    @staticmethod
    def forward(table, idx):
        return table[idx]

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, idx = inputs
        ctx.save_for_backward(idx)
        ctx.shape = table.shape

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g = replicated(g)
        return g.new_zeros(ctx.shape).index_put((replicated(idx),), g, accumulate=True), None


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``; on the mesh path through :class:`_Lookup`."""
    if not (is_sharded(table) or is_sharded(idx)):
        return table[idx]
    return _Lookup.apply(table, idx)


def _split(x: torch.Tensor, dim: int, sizes: tuple[int, ...]) -> torch.Tensor:
    shape = (*x.shape[:dim], *sizes, *x.shape[dim + 1:])
    if is_sharded(x):
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        over = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
        ranks = 1
        for i in over:
            ranks *= mesh.size(i)
        if sizes[0] % ranks:
            x = x.redistribute(mesh, [Replicate() if i in over else p
                                      for i, p in enumerate(x.placements)])
    return x.reshape(shape)


class _Split(torch.autograd.Function):
    """:func:`split_dim`'s reshape whose backward merges the gradient with
    :func:`merge_dims`'s guard."""

    @staticmethod
    def forward(x, dim, sizes):
        return _split(x, dim, sizes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.dim, ctx.sizes = inputs

    @staticmethod
    def backward(ctx, g):
        return merge_dims(g, ctx.dim, len(ctx.sizes)), None, None


def split_dim(x: torch.Tensor, dim: int, *sizes: int) -> torch.Tensor:
    """``x`` with dimension ``dim`` split into ``sizes`` (a reshape).  A
    ``DTensor`` sharded on ``dim`` over more ranks than divide ``sizes[0]``
    (two KV heads over a 16-wide "model" axis) is first replicated over
    those mesh dimensions, where DTensor's reshape would refuse; GSPMD
    reshards there the same way.  Its gradient is merged back by
    :func:`merge_dims`, which keeps only the leading dimension sharded."""
    dim = dim % x.ndim
    if not is_sharded(x):
        return _split(x, dim, sizes)
    return _Split.apply(x, dim, tuple(sizes))


def replicated_apply(fn: Callable, x: torch.Tensor):
    """``fn(x)`` for an operation DTensor has no strategy for in every torch
    release (``cummax``; ``cumsum``, whose backward flips): on the whole of
    ``x``, gathered, its tensor results replicated again, differentiably; a
    plain ``x`` goes to ``fn`` as it is."""
    if not is_sharded(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate

    mesh, rep = x.device_mesh, [Replicate()] * x.device_mesh.ndim
    out = fn(x.full_tensor())
    return pytree.tree_map_only(torch.Tensor, lambda t: DTensor.from_local(
        t, mesh, rep, run_check=False), out)


class _Merge(torch.autograd.Function):
    """A reshape merging dimensions whose backward splits the gradient with
    :func:`split_dim`'s guard."""

    @staticmethod
    def forward(x, dim, sizes):
        return x.flatten(dim, dim + len(sizes) - 1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.dim, ctx.sizes = inputs

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, *ctx.sizes), None, None


def merge_dims(x: torch.Tensor, dim: int, count: int) -> torch.Tensor:
    """``x`` with dimensions ``dim .. dim + count - 1`` merged into one (a
    reshape).  For a ``DTensor`` only the leading one of them may stay
    sharded (:func:`unshard` replicates the others), and the gradient, which
    arrives sharded on the merged dimension, is split back with
    :func:`split_dim`'s guard (DTensor's own reshape backward would refuse to
    split two KV heads over 16 ranks)."""
    dim = dim % x.ndim
    if not is_sharded(x):
        return x.flatten(dim, dim + count - 1)
    x = unshard(x, *range(dim + 1, dim + count))  # only the leading one may stay sharded
    return _Merge.apply(x, dim, tuple(x.shape[dim:dim + count]))


def write_at(dst: torch.Tensor, dim: int, index: int, value: torch.Tensor) -> None:
    """``dst.select(dim, index).copy_(value)``, in place.  For a ``DTensor``
    ``dst`` (a decode cache, its sequence sharded over "model") ``value`` is
    laid out as ``dst`` without ``dim`` and each rank writes it into its own
    shard only where that shard holds ``index``."""
    if not is_sharded(dst):
        dst.select(dim, index).copy_(value)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = dst.device_mesh
    if not is_sharded(value):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim, run_check=False)
    placements = []
    for p in dst.placements:
        if isinstance(p, Shard) and p.dim >= dim:
            p = Replicate() if p.dim == dim else Shard(p.dim - 1)
        placements.append(p)
    local = value.redistribute(mesh, placements).to_local()
    shape, offset = compute_local_shape_and_global_offset(dst.shape, mesh, dst.placements)
    if offset[dim] <= index < offset[dim] + shape[dim]:
        dst.to_local().select(dim, index - offset[dim]).copy_(local)


def dp_spec(mesh):
    from .sharding import dp_axes

    return dp_axes(mesh)
