"""The LTSP DP wavefront on an NVIDIA card: launch wrapper and table driver.

The exact DP fills a dense table ``T[B, R, R, S]`` (instance, window start
``a``, window end ``b``, skip count ``s``) one anti-diagonal ``d = b - a`` at
a time, together with the argmin plane ``C`` (-1 = "skip b", else the
winning detour start ``c``) that the host traceback in :mod:`.ops` replays
into a detour list.  Each diagonal is one launch of the hand-written CUDA
kernel in ``csrc/ltsp_wavefront.cu`` (built and bound by :mod:`.build`), which
replaces the JAX package's Pallas kernel (``wavefront_kernel`` /
``ltsp_dp_wavefront`` / ``ltsp_dp_tables`` in
``src/repro/kernels/ltsp_dp/ltsp_dp.py``); its header states what it computes
and what bounds it.

Table types: ``int32`` (exact below 2**31, the solver's default), ``float32``
(exact below 2**24, the value-only wrappers) and ``float64`` (exact below
2**53, the ``numeric_policy="f64"`` path, native on this card).

Tensors on the CPU take the plain version (:mod:`.ref`) instead of the
kernel; a CUDA tensor always launches the kernel, and any failure to build
or launch it raises.  :data:`LAUNCHES` counts kernel launches per table type.
"""

from __future__ import annotations

import torch

from . import build
from .ref import diagonal_update, init_tables

__all__ = ["DEFAULT_CAND_TILE", "LAUNCHES", "reset_launches", "ltsp_dp_wavefront", "ltsp_dp_tables"]

#: default candidate-chunk height of the JAX kernel's banded scan.  It is
#: part of the solve-cache key and of the launch profile signature; here it
#: only picks which scan form's sentinel semantics to reproduce.
DEFAULT_CAND_TILE = 128

#: kernel launches per table type since the last :func:`reset_launches`.
LAUNCHES: dict[str, int] = {name: 0 for name in build.TYPE_SUFFIX}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _type_name(dtype: torch.dtype) -> str:
    name = str(dtype).removeprefix("torch.")
    if name not in build.TYPE_SUFFIX:
        raise TypeError(f"unsupported table type {dtype}; use int32, float32 or float64")
    return name


def ltsp_dp_wavefront(
    T: torch.Tensor,  # [B, R, R, S] table type, updated in place
    C: torch.Tensor,  # [B, R, R, S] int32, updated in place
    left: torch.Tensor,  # [B, R] table type
    right: torch.Tensor,  # [B, R] table type
    x: torch.Tensor,  # [B, R] int32
    nl: torch.Tensor,  # [B, R] table type
    u: torch.Tensor,  # [B] table type
    d: int,
    *,
    span: int | None,
    disjoint: bool = False,
    cand_tile: int = DEFAULT_CAND_TILE,
) -> None:
    """Fill diagonal ``d`` of ``T`` and ``C`` for every instance, in place.

    Reads only diagonals ``< d``.  CUDA tensors launch the kernel on the
    current stream (no synchronisation); CPU tensors run the plain version.
    """
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
    tensors = (T, C, left, right, x, nl, u)
    if any(t.device != T.device for t in tensors):
        raise ValueError("all wavefront tensors must lie on one device")
    if not 1 <= d < R:
        raise ValueError(f"diagonal d={d} out of range for R={R}")
    static_tile = R - 1 <= cand_tile
    if T.device.type == "cpu":
        diagonal_update(T, C, left, right, x, nl, u, d, S=S, span=span,
                        disjoint=disjoint, static_tile=static_tile)
        return
    if T.device.type != "cuda":
        raise ValueError(f"no wavefront kernel for device {T.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA wavefront needs contiguous tensors")
    fn = getattr(build.load(), f"ltsp_wavefront_{build.TYPE_SUFFIX[name]}")
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        err = fn(
            *(t.data_ptr() for t in tensors), B, R, S, d,
            -1 if span is None else int(span), int(bool(disjoint)),
            int(static_tile), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ltsp_wavefront_{build.TYPE_SUFFIX[name]} launch failed: "
            f"cudaError {err} (B={B}, R={R}, S={S}, d={d})"
        )
    LAUNCHES[name] += 1


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
    and ``C`` as ``-1``s; then diagonals ``d = 1..R-1`` are filled by
    :func:`ltsp_dp_wavefront`, one launch each.  Inputs are tensors
    on any device (they are moved to ``device``); the table type is
    ``left``'s.
    """
    left, right, x, nl, u = (t.to(device).contiguous() for t in (left, right, x, nl, u))
    T, C = init_tables(left, right, nl, S)
    for d in range(1, left.shape[1]):
        ltsp_dp_wavefront(T, C, left, right, x, nl, u, d, span=span,
                          disjoint=disjoint, cand_tile=cand_tile)
    return T, C
