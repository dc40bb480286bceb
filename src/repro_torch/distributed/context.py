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

DTensor chooses each operation's layout to communicate least, and may so
leave both operands of a product replicated over "model" (or one a partial
sum), which repeats the product on every "model" rank.  The layouts that
give each rank only its share are set here, as GSPMD sets the reference's:
:func:`local_attention` (attention on each rank's batch rows and query
heads or rows), :func:`rows_matmul` (a product with a weight the rules
replicate, on each rank's rows), :func:`gathered` and :func:`take_last`
(the cross-entropy on each rank's rows), and Megatron's layout for the
residual stream and the products (:func:`width_replicated`,
:func:`width_sharded`), whose gradients :func:`shard_hint` constrains too.
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


class _Hint(torch.autograd.Function):
    """``x`` laid out by ``placements`` (:func:`_laid_out`), and its gradient
    likewise, also where ``x`` already was."""

    @staticmethod
    def forward(x, placements):
        out = _laid_out(x, placements)
        return x.view_as(x) if out is x else out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.placements = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _laid_out(g, ctx.placements), None


def shard_hint(x: torch.Tensor, spec_fn: Callable) -> torch.Tensor:
    """Redistribute ``x`` to ``spec_fn(mesh)`` if a mesh is active
    (divisibility-guarded), and its gradient likewise, as
    ``with_sharding_constraint`` constrains the cotangent too (DTensor's own
    redistribution hands the gradient back in ``x``'s layout); identity
    otherwise."""
    if _MESH is None or not is_sharded(x):
        return x
    from .sharding import safe_pspec, to_placements

    spec = safe_pspec(spec_fn(_MESH), x.shape, _MESH)
    return _Hint.apply(x, to_placements(spec, x.device_mesh))


def width_sharded(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its batch on the data axes and its last dimension over
    "model", its gradient too (:func:`shard_hint`): the output of a product
    with a weight whose columns the rules shard over "model", and the input
    of one whose rows they shard.  Without it DTensor, which chooses the
    layout that communicates least, may leave that dimension replicated and
    the other operand too, and a product of two replicated operands (a
    weight gradient, most often) repeats on every "model" rank."""
    from .sharding import MODEL

    return shard_hint(x, lambda m: (dp_spec(m),) + (None,) * (x.ndim - 2) + (MODEL,))


def width_replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its batch on the data axes and replicated over "model",
    its gradient too: the residual stream as a block reads it, where a
    partial sum (a product with a partial-sum activation repeats on every
    "model" rank) or a sharded model width (it leaves a partial sum as wide
    as the product's output) would otherwise flow in."""
    return shard_hint(x, lambda m: (dp_spec(m),) + (None,) * (x.ndim - 1))


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
    and its gradient likewise: the head dimensions of the decode step's
    attention operands, which its batched products merge with the batch
    dimension, and the dimensions :func:`merge_dims` merges after the
    leading one (DTensor cannot merge a sharded dimension that is not the
    leading one in every torch release).  A plain tensor as it is."""
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
    :func:`merge_dims`'s guard and lays it out as the input was (where the
    forward replicated it, a partial-sum gradient would otherwise reach the
    product that made the input, which then repeats on every rank)."""

    @staticmethod
    def forward(x, dim, sizes):
        return _split(x, dim, sizes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.dim, ctx.sizes = inputs
        ctx.placements = x.placements

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        g = merge_dims(g, ctx.dim, len(ctx.sizes))
        if is_sharded(g):
            want = [Replicate() if p.is_partial() else p for p in ctx.placements]
            if list(g.placements) != want:
                g = g.redistribute(g.device_mesh, want)
        return g, None, None


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


def _as_dtensor(x: torch.Tensor, mesh):
    """``x``, a plain tensor taken as replicated over ``mesh``."""
    if is_sharded(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _laid_out(x, want):
    """The ``DTensor`` ``x`` laid out by ``want``, one placement per mesh
    dimension, except that a mesh dimension of size 1 keeps ``x``'s own
    placement (its local tensor is the whole either way): a layout on a
    one-rank mesh moves and copies nothing."""
    mesh = x.device_mesh
    target = [w if mesh.size(i) > 1 else p for i, (w, p) in enumerate(zip(want, x.placements))]
    return x if target == list(x.placements) else x.redistribute(mesh, target)


def local_attention(body: Callable, queries: tuple, keys: tuple) -> torch.Tensor:
    """``body(*queries, *keys, row_offset)`` on each rank's share, for a
    mixer that is O(L^2) in the sequence; the identity's counterpart on
    plain tensors (``row_offset`` 0).

    Every operand is ``[B, L, H, ...]``: the query-like ones (``queries``,
    the first of them the queries, ``Hq`` heads) index the output's rows,
    the key-like ones (``keys``, ``Hk`` heads dividing ``Hq``, a key head
    serving ``Hq // Hk`` consecutive query heads) the positions attended
    to, and ``body`` returns ``[B, Lq, Hq, ...]``.  On the mesh path the
    batch is sharded over the data axes and the queries over "model" by
    heads, or by rows where "model" does not divide the heads (each rank
    then masks with its rows' global offset, ``row_offset``); the keys are
    replicated over "model" and each rank takes the key heads its query
    heads read.  ``body`` runs on the local tensors, forward and backward
    (the keys' gradients are partial sums over "model" where the queries
    are sharded there), and its output is laid out as the queries, as
    GSPMD lays out the reference's attention."""
    operands = (*queries, *keys)
    if not any(is_sharded(t) for t in operands):
        return body(*operands, 0)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from .sharding import MODEL

    mesh = next(t for t in operands if is_sharded(t)).device_mesh
    B, Lq, Hq = queries[0].shape[:3]
    names = list(mesh.mesh_dim_names)
    m = names.index(MODEL)
    data_ranks = mesh.size() // mesh.size(m)
    batch = Shard(0) if B % data_ranks == 0 else Replicate()
    M = mesh.size(m)
    rows = Replicate()
    if M > 1 and Hq % M == 0:
        rows = Shard(2)
    elif M > 1 and Lq % M == 0:
        rows = Shard(1)
    q_want = [rows if i == m else batch for i in range(mesh.ndim)]
    k_want = [Replicate() if i == m else batch for i in range(mesh.ndim)]
    coord = mesh.get_coordinate()[m] if M > 1 else 0

    local = []
    for t in queries:
        t = _laid_out(_as_dtensor(t, mesh), q_want)
        local.append(t.to_local())
    for t in keys:
        t = _laid_out(_as_dtensor(t, mesh), k_want)
        grad = [Partial() if i == m and rows.is_shard() else p
                for i, p in enumerate(t.placements)]
        t = t.to_local(grad_placements=grad)
        if rows.is_shard(2):  # the key heads this rank's query heads read
            hl, G = Hq // M, Hq // t.shape[2]
            lo = coord * hl
            if hl % G == 0:
                t = t[:, :, lo // G:(lo + hl) // G]
            elif G % hl == 0:
                t = t[:, :, lo // G:lo // G + 1]
            else:
                t = t.index_select(2, torch.arange(lo, lo + hl, device=t.device) // G)
        local.append(t)
    offset = coord * (Lq // M) if rows.is_shard(1) else 0
    out = body(*local, offset)
    placements = [rows if i == m else batch if mesh.size(i) > 1 else Replicate()
                  for i in range(mesh.ndim)]
    return DTensor.from_local(out, mesh, placements, run_check=False)


def rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a weight ``w`` that the rules replicate over "model".
    On the mesh path each rank multiplies its share of ``x``'s rows by the
    whole of ``w``, on the local tensors: the batch over the data axes, and
    the dimension before the last (the sequence, or a flattened batch's
    tokens) over "model" where "model" divides it (on a replicated
    activation the product would repeat on every "model" rank).  ``w``'s
    gradient is a partial sum over the mesh dimensions that shard ``x``.
    The output comes back gathered over "model" (the rules' replicated
    weights make narrow outputs), as the next products take their input:
    torch 2.11's DTensor cannot flatten a sharded sequence into a
    product's rows."""
    if not (is_sharded(x) or is_sharded(w)):
        return x @ w
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from .sharding import MODEL

    mesh = (x if is_sharded(x) else w).device_mesh
    m = list(mesh.mesh_dim_names).index(MODEL)
    M = mesh.size(m)
    data_ranks = mesh.size() // M
    rows = x.ndim - 2  # 0 for [tokens, D]: sharded over the data axes and "model" together
    batch = Shard(0) if x.shape[0] % data_ranks == 0 else Replicate()
    split = x.shape[rows] // (data_ranks if rows == 0 and batch.is_shard() else 1)
    model = Shard(rows) if split % M == 0 else Replicate()
    xl = _laid_out(_as_dtensor(x, mesh), [model if i == m else batch for i in range(mesh.ndim)])
    wl = _laid_out(_as_dtensor(w, mesh), [Replicate()] * mesh.ndim)
    grad = [Partial() if p.is_shard() else Replicate() for p in xl.placements]
    out = xl.to_local() @ wl.to_local(grad_placements=grad)
    out = DTensor.from_local(out, mesh, xl.placements, run_check=False)
    return _laid_out(out, [Replicate() if i == m else batch for i in range(mesh.ndim)])


def gathered(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with the mesh dimensions that shard ``dim`` or hold a partial
    sum replicated: DTensor's redistribution, whose gradient goes back to
    ``x``'s layout (where :func:`unshard` gathers the gradient too).  A
    plain tensor as it is."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate

    dim = dim % x.ndim
    placements = [Replicate() if p.is_partial() or p.is_shard(dim) else p for p in x.placements]
    if list(placements) == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` elementwise (``torch.gather`` on the last dimension,
    ``idx`` of ``x``'s shape without it).  On the mesh path each rank picks
    on its own shard of the other dimensions, the last one gathered first
    (:func:`gathered`) and ``idx`` laid out as ``x``; the backward scatters
    into the rank's own shard (DTensor's gather of a sharded last dimension
    fails, and replicating ``x`` whole gathers every dimension)."""
    if not (is_sharded(x) or is_sharded(idx)):
        return torch.gather(x, -1, idx[..., None].long())[..., 0]
    from torch.distributed.tensor import DTensor

    mesh = (x if is_sharded(x) else idx).device_mesh
    x = gathered(_as_dtensor(x, mesh), -1)
    idx = _as_dtensor(idx, mesh)
    if idx.placements != x.placements:
        idx = idx.redistribute(mesh, x.placements)
    out = torch.gather(x.to_local(), -1, idx.to_local()[..., None].long())[..., 0]
    return DTensor.from_local(out, mesh, x.placements, run_check=False)


def dp_spec(mesh):
    from .sharding import dp_axes

    return dp_axes(mesh)
