"""The LTSP DP tables and traceback on an NVIDIA card: launch wrappers and
table driver.

The exact DP fills a dense table ``T[B, R, R, S]`` (instance, window start
``a``, window end ``b``, skip count ``s``) together with the argmin plane
``C`` (-1 = "skip b", else the winning detour start ``c``), which a
traceback replays into a detour list.  The hand-written CUDA kernels in
``csrc/`` (built and bound by :mod:`.build`) replace the JAX package's
Pallas kernel (``wavefront_kernel`` / ``ltsp_dp_wavefront`` /
``ltsp_dp_tables`` in ``src/repro/kernels/ltsp_dp/ltsp_dp.py``); each
source's header states what it computes and what bounds it.

* :func:`ltsp_dp_tables` builds the tables by the tiled schedule of
  ``csrc/ltsp_tiled.cu``: per tile diagonal one :func:`ltsp_far_fold`
  launch, then one :func:`ltsp_near_fold` launch per cell diagonal inside
  the tiles, all issued by one C call.  This is the main path.
* :func:`ltsp_traceback` walks ``C`` on the card (``csrc/ltsp_traceback.cu``)
  so that only the detours, and not the plane, go to the host.

Table types: ``int32`` (exact below 2**31, the solver's default), ``float32``
(exact below 2**24, the value-only wrappers) and ``float64`` (exact below
2**53, the ``numeric_policy="f64"`` path, native on this card).

Tensors on the CPU take the plain versions (:mod:`.ref`) instead of the
kernels; a CUDA tensor always launches a kernel, and any failure to build or
launch it raises.  :data:`LAUNCHES` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import far_fold, fill_tiled, init_tables, near_update, tile_schedule, traceback_ref

__all__ = [
    "DEFAULT_CAND_TILE", "TILE", "FAR_LANES", "LAUNCHES", "reset_launches", "ltsp_far_fold",
    "ltsp_near_fold", "ltsp_dp_tables", "ltsp_traceback",
]

#: default candidate-chunk height of the JAX kernel's banded scan.  It is
#: part of the solve-cache key and of the launch profile signature; here it
#: only picks which scan form's sentinel semantics to reproduce.
DEFAULT_CAND_TILE = 128

#: tile size of the tiled table build per table type: ``Tile<V>`` in
#: ``csrc/ltsp_tiled.cu`` (checked against the library when it loads); the
#: plain version on the CPU runs the same schedule.
TILE = {"int32": 8, "float32": 8, "float64": 8}

#: s lanes per block of the far fold (``kLanes`` in ``csrc/ltsp_tiled.cu``):
#: on a CUDA device a table with more than one tile diagonal needs ``S`` to
#: be a multiple of it.  The solver pads ``S`` to a multiple of 128.
FAR_LANES = 32

#: kernel launches per ``__global__`` function since the last
#: :func:`reset_launches`.
LAUNCHES: dict[str, int] = {
    name: 0 for name in ("far_fold_kernel", "near_fold_kernel", "traceback_kernel")
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _type_name(dtype: torch.dtype) -> str:
    name = str(dtype).removeprefix("torch.")
    if name not in build.TYPE_SUFFIX:
        raise TypeError(f"unsupported table type {dtype}; use int32, float32 or float64")
    return name


def _check_tables(T, C, left, right, x, nl, u) -> tuple[str, int, int, int]:
    """Validate the table workspace and inputs: ``(type name, B, R, S)``."""
    if T.dim() != 4:
        raise ValueError(f"T must be [B, R, R, S], got shape {tuple(T.shape)}")
    B, R, R2, S = T.shape
    name = _type_name(T.dtype)
    if R2 != R or tuple(C.shape) != tuple(T.shape) or C.dtype != torch.int32:
        raise ValueError("C must be an int32 tensor of T's shape [B, R, R, S]")
    for label, t, dtype, shape in (
        ("left", left, T.dtype, (B, R)), ("right", right, T.dtype, (B, R)),
        ("x", x, torch.int32, (B, R)), ("nl", nl, T.dtype, (B, R)),
        ("u", u, T.dtype, (B,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{label} must be {dtype} of shape {shape}, got {t.dtype} {tuple(t.shape)}"
            )
    _check_device(T, C, left, right, x, nl, u)
    return name, B, R, S


def _check_device(*tensors) -> None:
    """One device for all; a CUDA device also needs contiguous tensors."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all kernel tensors must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no LTSP kernel for device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernels need contiguous tensors")


def _check_lanes(device: torch.device, name: str, R: int, S: int) -> None:
    """The far fold stages whole lane slices: on a CUDA device a table with
    a far launch (``R`` above the tile) needs ``S % FAR_LANES == 0``."""
    if device.type == "cuda" and R > TILE[name] and S % FAR_LANES:
        raise ValueError(f"S={S} must be a multiple of {FAR_LANES} for the CUDA table build "
                         f"at R={R} > tile {TILE[name]}; pad S (the solver pads it to 128)")


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    if name == "ltsp_tiled":
        for type_name, suffix in build.TYPE_SUFFIX.items():
            got = getattr(lib, f"ltsp_tile_size_{suffix}")()
            if got != TILE[type_name]:
                raise RuntimeError(f"ltsp_tiled.cu tiles {type_name} by {got}, TILE says "
                                   f"{TILE[type_name]}")
    return lib


def _launch(device: torch.device, source: str, fn_name: str, *args, shape: str) -> None:
    """Call one C entry point on ``device``'s current stream; raise on a
    launch error."""
    fn = getattr(_library(source), fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err} ({shape})")


def _span_arg(span: int | None) -> int:
    return -1 if span is None else int(span)


def ltsp_far_fold(T, C, left, right, x, nl, u, D: int, *, span: int | None,
                  disjoint: bool = False) -> None:
    """Far partials of tile diagonal ``D >= 1`` into ``T`` and ``C``, in
    place (see :func:`.ref.far_fold`): one launch of ``far_fold_kernel`` on
    a CUDA tensor, the plain version on the CPU.

    ``T`` ``[B, R, R, S]`` (table type) and ``C`` (int32, same shape) are
    updated in place from ``left``, ``right``, ``nl`` ``[B, R]`` (table type),
    ``x`` ``[B, R]`` (int32) and ``u`` ``[B]`` (table type); ``span`` is the
    LOGDP clip, ``disjoint`` the SIMPLEDP one.  On a CUDA device ``S`` must
    be a multiple of :data:`FAR_LANES`.
    """
    name, B, R, S = _check_tables(T, C, left, right, x, nl, u)
    if not 1 <= D < -(-R // TILE[name]):
        raise ValueError(f"tile diagonal D={D} out of range for R={R}")
    _check_lanes(T.device, name, R, S)
    if T.device.type == "cpu":
        far_fold(T, C, left, right, x, nl, u, D, Tb=TILE[name], span=span,
                 disjoint=disjoint)
        return
    _launch(T.device, "ltsp_tiled", f"ltsp_far_fold_{build.TYPE_SUFFIX[name]}",
            *(t.data_ptr() for t in (T, C, right, nl, u)), B, R, S, D, _span_arg(span),
            int(bool(disjoint)), shape=f"B={B}, R={R}, S={S}, D={D}")
    LAUNCHES["far_fold_kernel"] += 1


def ltsp_near_fold(T, C, left, right, x, nl, u, D: int, k: int, *, span: int | None,
                   disjoint: bool = False, cand_tile: int = DEFAULT_CAND_TILE) -> None:
    """Finish the cells of tile diagonal ``D`` on cell diagonal ``k`` inside
    their tiles, in place (see :func:`.ref.near_update`): one launch of
    ``near_fold_kernel`` on a CUDA tensor, the plain version on the CPU.
    Arguments as for :func:`ltsp_far_fold`; ``cand_tile`` picks the
    reference's scan form (one static tile when ``R - 1 <= cand_tile``)."""
    name, B, R, S = _check_tables(T, C, left, right, x, nl, u)
    if ("near", D, k) not in _schedule(R, TILE[name]):
        raise ValueError(f"(D={D}, k={k}) is no step of the tiled build for R={R}")
    static_tile = R - 1 <= cand_tile
    if T.device.type == "cpu":
        near_update(T, C, left, right, x, nl, u, D, k, Tb=TILE[name], span=span,
                    disjoint=disjoint, static_tile=static_tile)
        return
    _launch(T.device, "ltsp_tiled", f"ltsp_near_fold_{build.TYPE_SUFFIX[name]}",
            *(t.data_ptr() for t in (T, C, left, right, x, nl, u)), B, R, S, D, k,
            _span_arg(span), int(bool(disjoint)), int(static_tile),
            shape=f"B={B}, R={R}, S={S}, D={D}, k={k}")
    LAUNCHES["near_fold_kernel"] += 1


@functools.cache
def _schedule(R: int, Tb: int) -> tuple:
    return tuple(tile_schedule(R, Tb))


def ltsp_dp_tables(
    left: torch.Tensor,  # [B, R]
    right: torch.Tensor,  # [B, R]
    x: torch.Tensor,  # [B, R] int32
    nl: torch.Tensor,  # [B, R]
    u: torch.Tensor,  # [B]
    *,
    S: int,
    span: int | None = None,
    disjoint: bool = False,
    cand_tile: int = DEFAULT_CAND_TILE,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full batched DP tables ``(T, C)``, each ``[B, R, R, S]``, on ``device``.

    ``T`` starts as zeros with the base diagonal ``2(r_b - l_b)(s + nl_b)``
    and ``C`` as ``-1``s; then the tiled schedule (:func:`.ref.tile_schedule`
    with the type's :data:`TILE`) fills the rest: on a CUDA device every
    far-fold and near-fold launch is issued by one C call on the current
    stream, on the CPU the plain versions run the same steps.  Inputs are
    tensors on any device (they are moved to ``device``); the table type is
    ``left``'s.  On a CUDA device ``S`` must be a multiple of
    :data:`FAR_LANES` once ``R`` exceeds the tile (any ``S`` on the CPU).
    """
    _check_lanes(torch.device(device), _type_name(left.dtype), left.shape[-1], S)
    left, right, x, nl, u = (t.to(device).contiguous() for t in (left, right, x, nl, u))
    T, C = init_tables(left, right, nl, S)
    name, B, R, S = _check_tables(T, C, left, right, x, nl, u)
    if T.device.type == "cpu":
        fill_tiled(T, C, left, right, x, nl, u, Tb=TILE[name], span=span, disjoint=disjoint,
                   cand_tile=cand_tile)
        return T, C
    n_far, n_near = ctypes.c_int(0), ctypes.c_int(0)
    try:
        _launch(T.device, "ltsp_tiled", f"ltsp_tiled_tables_{build.TYPE_SUFFIX[name]}",
                *(t.data_ptr() for t in (T, C, left, right, x, nl, u)), B, R, S,
                _span_arg(span), int(bool(disjoint)), int(R - 1 <= cand_tile),
                ctypes.byref(n_far), ctypes.byref(n_near), shape=f"B={B}, R={R}, S={S}")
    finally:
        LAUNCHES["far_fold_kernel"] += n_far.value
        LAUNCHES["near_fold_kernel"] += n_near.value
    return T, C


def ltsp_traceback(C: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Detours of every instance from its argmin planes ``C[B, R, R, S]``
    and multiplicities ``x[B, R]``: ``(detours [B, R, 2], counts [B])``, int32
    on ``C``'s device, in the emission order of ``ops.traceback_detours``
    (see :func:`.ref.traceback_ref`; ``counts[i] = -1`` marks a plane that is
    not a DP's).  A CUDA tensor launches ``traceback_kernel`` on the current
    stream (no synchronisation); a CPU tensor runs the plain walk."""
    if C.dim() != 4 or C.dtype != torch.int32 or C.shape[1] != C.shape[2]:
        raise ValueError(f"C must be an int32 tensor [B, R, R, S], got {C.dtype} "
                         f"{tuple(C.shape)}")
    B, R, _, S = C.shape
    if x.dtype != torch.int32 or tuple(x.shape) != (B, R):
        raise ValueError(f"x must be torch.int32 of shape {(B, R)}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    _check_device(C, x)
    if C.device.type == "cpu":
        return traceback_ref(C, x)
    dets = torch.zeros((B, R, 2), dtype=torch.int32, device=C.device)
    counts = torch.empty((B,), dtype=torch.int32, device=C.device)
    stack = torch.empty((B, R, 3), dtype=torch.int32, device=C.device)
    _launch(C.device, "ltsp_traceback", "ltsp_traceback",
            *(t.data_ptr() for t in (C, x, dets, counts, stack)), B, R, S,
            shape=f"B={B}, R={R}, S={S}")
    LAUNCHES["traceback_kernel"] += 1
    return dets, counts
