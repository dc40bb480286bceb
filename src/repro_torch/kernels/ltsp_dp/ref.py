"""Plain eager-torch version of the LTSP DP wavefront (values *and* argmins).

The exact Python DP (:mod:`repro_torch.core.dp`) memoises only reachable
``(a, b, n_skip)`` cells; the device formulation instead materialises the
full table ``T[B, R, R, S]`` over every skip count ``s in [0, S)`` and fills
it one anti-diagonal ``d = b - a`` at a time.  Every recurrence is valid for
an arbitrary ``s`` parameter, so the dense table contains no garbage: the
only approximation is the clamped gather ``T[a, b-1, min(s + x_b, S-1)]``,
which can only be hit from cells that are themselves unreachable from the
root ``(0, R-1, 0)``.

This module holds the plain versions of the hand-written CUDA kernels in
``csrc/``: :func:`far_fold` and :func:`near_update` compute what one launch
of each kernel of the tiled build (``ltsp_tiled.cu``) computes, and
:func:`traceback_ref` what the device traceback (``ltsp_traceback.cu``)
returns.  :func:`diagonal_update` fills one whole anti-diagonal, the JAX
package's own schedule, from which :func:`ltsp_dp_tables_ref` builds the
tables every other version is held against.  They share the operation order,
the clamp and masks, the sentinels and the tie-break (skip wins ties; among
detours the smallest ``c`` wins), so each agrees with its kernel bit for
bit.  They run on any torch device: the CPU tests use them, the ``"torch"``
backend builds its tables with :func:`ltsp_dp_tables_ref`, and
``chip_smoke.py`` holds each kernel against its plain version on the card.
Unlike the JAX package's value-only oracle they also produce the argmin
plane ``C`` (-1 = skip, else the winning detour start ``c``).
"""

from __future__ import annotations

import torch

__all__ = [
    "INT32_BIG",
    "sentinel",
    "base_diagonal",
    "init_tables",
    "diagonal_update",
    "tile_schedule",
    "far_fold",
    "near_update",
    "fill_tiled",
    "ltsp_dp_tables_ref",
    "ltsp_dp_tables_tiled_ref",
    "traceback_ref",
    "ltsp_dp_table_ref",
    "ltsp_opt_ref",
]

#: masked-candidate sentinel of the int32 table (the floats use +inf).
INT32_BIG = (2**31 - 1) // 2


def sentinel(dtype: torch.dtype) -> float | int:
    """Value of a masked candidate in a table of ``dtype``."""
    return INT32_BIG if dtype == torch.int32 else float("inf")


def base_diagonal(right, left, nl, S: int, dtype=torch.float32):
    """``T[..., b, b, s] = 2 s(b) (s + n_l(b))`` for all b, s (batched or not)."""
    size = (right - left).to(dtype)
    svec = torch.arange(S, dtype=dtype, device=size.device)
    return 2 * size[..., None] * (svec + nl.to(dtype)[..., None])


def init_tables(left, right, nl, S: int):
    """``(T, C)`` workspace of shape ``[B, R, R, S]``: zeros and ``-1``s, with
    the base diagonal written into ``T``."""
    B, R = left.shape
    T = torch.zeros((B, R, R, S), dtype=left.dtype, device=left.device)
    C = torch.full((B, R, R, S), -1, dtype=torch.int32, device=left.device)
    rr = torch.arange(R, device=left.device)
    T[:, rr, rr, :] = base_diagonal(right, left, nl, S, left.dtype)
    return T, C


def _window_start(a, b, span: int | None, disjoint: bool):
    """Smallest live detour start ``c_lo`` of each cell ``(a, b)``: ``a + 1``,
    raised to ``b - span`` under LOGDP, and ``b + 1`` (no detour) for
    ``a > 0`` under SIMPLEDP."""
    c_lo = a + 1
    if span is not None:
        c_lo = torch.maximum(c_lo, b - span)
    if disjoint:
        c_lo = torch.where(a > 0, b + 1, c_lo)
    return c_lo


def _folder(T, right, nl, u, a, b):
    """The fold step of cells ``(a, b)`` (index vectors of length ``N``):
    ``fold(c, live, best, arg)`` folds one detour start per cell, ``c[n]``
    for cell ``(a[n], b[n])``, into the running ``(best, arg)`` of shape
    ``[B, N, S]``: a strict ``<`` fold where the first live candidate is
    always taken.  ``live`` masks the starts (``None``: all live); ``c`` must
    lie in ``[a + 1, b]`` everywhere."""
    dtype, S = T.dtype, T.shape[-1]
    svec = torch.arange(S, dtype=dtype, device=T.device)
    s_nl_a = svec + nl[:, a, None]
    r_b = right[:, b]
    two_u = (2 * u)[:, None, None]

    def fold(c, live, best, arg):
        cand = (
            (T[:, a, c - 1, :] + T[:, c, b, :])
            + (2 * (r_b - right[:, c - 1]))[:, :, None] * s_nl_a
        ) + two_u * (svec + nl[:, c, None])
        better = (arg < 0) | (cand < best)
        if live is not None:
            better &= live[None, :, None]
        return (torch.where(better, cand, best),
                torch.where(better, c.to(torch.int32)[None, :, None], arg))

    return fold


def _empty_fold(T, n: int):
    """``(best, arg)`` of ``n`` cells before any candidate: sentinel, -1."""
    B, S = T.shape[0], T.shape[-1]
    best = torch.full((B, n, S), sentinel(T.dtype), dtype=T.dtype, device=T.device)
    return best, torch.full((B, n, S), -1, dtype=torch.int32, device=T.device)


def _settle(T, C, left, right, x, nl, a, b, best, arg, c_lo, static_tile: bool) -> None:
    """Finish cells ``(a, b)`` from their folded detours ``(best, arg)``:
    apply the JAX kernel's sentinel semantics, take the skip term, and write
    ``T[:, a, b, :]`` and ``C[:, a, b, :]`` in place.

    ``static_tile`` selects which of the JAX kernel's two scan forms decides
    the cells whose live candidates all reach the sentinel (see
    ``csrc/ltsp_common.cuh``); it never changes any other cell.
    """
    R, S = left.shape[1], T.shape[-1]
    dev, dtype = T.device, T.dtype
    big = torch.tensor(sentinel(dtype), dtype=dtype, device=dev)
    svec = torch.arange(S, dtype=dtype, device=dev)
    s_nl_a = svec + nl[:, a, None]  # [B, N, S]
    r_b = right[:, b]
    r_bm1 = right[:, b - 1]
    x_b = x[:, b]

    # ---- skip b --------------------------------------------------------
    idx = (torch.arange(S, device=dev) + x_b[:, :, None].long()).clamp(0, S - 1)
    shifted = T[:, a, b - 1, :].gather(2, idx)
    skip = (
        shifted
        + (2 * (r_b - r_bm1))[:, :, None] * s_nl_a
        + ((2 * (left[:, b] - r_bm1)) * x_b.to(dtype))[:, :, None]
    )

    # ---- the JAX kernel's sentinel semantics ----------------------------
    has = arg >= 0
    if static_tile:
        one = torch.ones_like(arg)
        first_masked = torch.where(c_lo > 1, 1, b + 1).to(torch.int32)[None, :, None]
        lead_masked = (c_lo > 1)[None, :, None]
        all_live = ((c_lo <= 1) & (b >= R - 1))[None, :, None]
        keep = has & ((best < big) | ((best > big) & all_live))
        det = torch.where(keep, best, big)
        argc = torch.where(
            ~has, one,
            torch.where(
                keep, arg,
                torch.where(best == big, torch.where(lead_masked, one, arg),
                            first_masked.expand_as(arg)),
            ),
        )
    else:
        keep = has & (best < big)
        det = torch.where(keep, best, big)
        argc = torch.where(keep, arg, torch.zeros_like(arg))

    take_skip = skip <= det
    T[:, a, b, :] = torch.where(take_skip, skip, det)
    C[:, a, b, :] = torch.where(take_skip, torch.full_like(argc, -1), argc)


def diagonal_update(
    T, C, left, right, x, nl, u, d: int, *,
    S: int, span: int | None, disjoint: bool, static_tile: bool,
) -> None:
    """Write ``T[:, a, a+d, :]`` and ``C[:, a, a+d, :]`` for every window
    start ``a`` in place, reading only diagonals ``< d``: one step of the
    JAX package's per-diagonal schedule.  Detour starts fold in ascending
    ``c``."""
    R = left.shape[1]
    a = torch.arange(R - d, device=T.device)
    b = a + d
    c_lo = _window_start(a, b, span, disjoint)
    fold = _folder(T, right, nl, u, a, b)
    best, arg = _empty_fold(T, R - d)
    # c = a + k >= c_lo  <=>  k >= k_min for every a (the span clip is
    # relative to b = a + d); only the disjoint clip depends on a itself
    k_min = 1 if span is None else max(1, d - span)
    root_only = a == 0 if disjoint else None
    for k in range(k_min, d + 1):
        best, arg = fold(a + k, root_only, best, arg)
    _settle(T, C, left, right, x, nl, a, b, best, arg, c_lo, static_tile)


# ---------------------------------------------------------------------------
# the tiled schedule (csrc/ltsp_tiled.cu)
# ---------------------------------------------------------------------------
def tile_schedule(R: int, Tb: int):
    """Launch order of the tiled table build for ``R`` files and tile size
    ``Tb``: ``("far", D, 0)`` before the ``("near", D, k)`` steps of each
    tile diagonal ``D``, with ``k`` the cell diagonal inside the tile
    (``b - a = D * Tb + k``)."""
    n_tiles = -(-R // Tb)
    for D in range(n_tiles):
        if D:
            yield "far", D, 0
        for k in range(1, Tb) if D == 0 else range(1 - Tb, Tb):
            if 1 <= D * Tb + k <= R - 1:
                yield "near", D, k


def _tile_cells(R: int, Tb: int, D: int, k: int | None, device):
    """Cells ``(a, b)`` with ``a`` in block ``A`` and ``b`` in block
    ``A + D`` (and, for an int ``k``, ``b - a = D * Tb + k``), with the
    block ``A`` of each; ragged tiles at the end are cut at ``R``."""
    n_tiles = -(-R // Tb)
    cells = []
    for A in range(n_tiles - D):
        for ii in range(Tb):
            jjs = range(Tb) if k is None else [ii + k]
            for jj in jjs:
                a, b = A * Tb + ii, (A + D) * Tb + jj
                if 0 <= jj < Tb and a < b < R:
                    cells.append((a, b, A))
    a, b, A = torch.tensor(cells, dtype=torch.long, device=device).reshape(-1, 3).unbind(1)
    return a, b, A


def far_fold(T, C, left, right, x, nl, u, D: int, *, Tb: int, span: int | None,
             disjoint: bool) -> None:
    """Far partials of tile diagonal ``D >= 1``, in place: for every cell
    ``(a, b)`` of a tile ``(A, A + D)``, the strict ascending fold over the
    detour starts ``c`` in ``[(A + 1) Tb, (A + D) Tb]`` goes to
    ``T[:, a, b, :]`` (the sentinel where no start is live) and its argmin
    to ``C[:, a, b, :]`` (-1 where none is).  Both operands of these starts
    lie on tile diagonals ``< D``, so every one is final."""
    a, b, A = _tile_cells(left.shape[1], Tb, D, None, T.device)
    c_lo = _window_start(a, b, span, disjoint)
    fold = _folder(T, right, nl, u, a, b)
    best, arg = _empty_fold(T, a.numel())
    for t in range((D - 1) * Tb + 1):
        c = (A + 1) * Tb + t  # in [a + 1, b]: far starts lie inside every window
        best, arg = fold(c, c >= c_lo, best, arg)
    T[:, a, b, :] = best
    C[:, a, b, :] = arg


def near_update(T, C, left, right, x, nl, u, D: int, k: int, *, Tb: int,
                span: int | None, disjoint: bool, static_tile: bool) -> None:
    """Finish the cells of tile diagonal ``D`` on cell diagonal ``k`` inside
    their tiles, in place.  Each cell folds its near starts below the far
    range (``c < (A + 1) Tb``), merges its far partial (``D >= 1``), folds
    its near starts above it (``c > (A + D) Tb``), then settles as
    :func:`diagonal_update` does.  The near starts read the tiles
    ``(A, A)`` and ``(A + D, A + D)`` and earlier cell diagonals of its own
    tile."""
    R = left.shape[1]
    a, b, A = _tile_cells(R, Tb, D, k, T.device)
    c_lo = _window_start(a, b, span, disjoint)
    fold = _folder(T, right, nl, u, a, b)
    best, arg = _empty_fold(T, a.numel())
    low_hi = torch.minimum(b, (A + 1) * Tb - 1)
    for q in range(1, Tb):
        c = a + q
        live = (c >= c_lo) & (c <= low_hi)
        best, arg = fold(torch.minimum(c, b), live, best, arg)
    if D:
        far_best, far_arg = T[:, a, b, :], C[:, a, b, :]
        take = (far_arg >= 0) & ((arg < 0) | (far_best < best))
        best = torch.where(take, far_best, best)
        arg = torch.where(take, far_arg, arg)
        for q in range(1, Tb):
            c = (A + D) * Tb + q
            live = (c >= c_lo) & (c <= b)
            best, arg = fold(torch.minimum(c, b), live, best, arg)
    _settle(T, C, left, right, x, nl, a, b, best, arg, c_lo, static_tile)


def fill_tiled(T, C, left, right, x, nl, u, *, Tb: int, span: int | None,
               disjoint: bool, cand_tile: int) -> None:
    """Run every step of the tiled schedule (:func:`tile_schedule`) with
    tile size ``Tb`` on tables fresh from :func:`init_tables`, in place."""
    R = left.shape[1]
    for kind, D, k in tile_schedule(R, Tb):
        if kind == "far":
            far_fold(T, C, left, right, x, nl, u, D, Tb=Tb, span=span, disjoint=disjoint)
        else:
            near_update(T, C, left, right, x, nl, u, D, k, Tb=Tb, span=span,
                        disjoint=disjoint, static_tile=R - 1 <= cand_tile)


def ltsp_dp_tables_tiled_ref(
    left, right, x, nl, u, *,
    S: int, Tb: int, span: int | None = None, disjoint: bool = False,
    cand_tile: int = 128,
):
    """Full batched DP tables ``(T, C)`` built by the plain versions of the
    tiled schedule with tile size ``Tb``; equal, bit for bit, to
    :func:`ltsp_dp_tables_ref` for every ``Tb >= 1``."""
    T, C = init_tables(left, right, nl, S)
    fill_tiled(T, C, left, right, x, nl, u, Tb=Tb, span=span, disjoint=disjoint,
               cand_tile=cand_tile)
    return T, C


def ltsp_dp_tables_ref(
    left, right, x, nl, u, *,
    S: int, span: int | None = None, disjoint: bool = False,
    cand_tile: int = 128,
):
    """Full batched DP tables ``(T, C)``, each ``[B, R, R, S]``, built by the
    plain version on the inputs' device."""
    B, R = left.shape
    T, C = init_tables(left, right, nl, S)
    for d in range(1, R):
        diagonal_update(
            T, C, left, right, x, nl, u, d, S=S, span=span, disjoint=disjoint,
            static_tile=R - 1 <= cand_tile,
        )
    return T, C


def traceback_ref(C, x):
    """Walk the argmin planes ``C[B, R, R, S]`` of every instance into its
    detours: ``(detours [B, R, 2], counts [B])``, both int32 on ``C``'s
    device, row ``n < counts[i]`` of ``detours[i]`` the ``n``-th detour
    ``(c, b)`` and the rest zeros.  The walk is ``ops.traceback_detours``'s
    pre-order walk from the root cell ``(0, R-1, 0)`` (``x`` holds the
    multiplicities ``[B, R]``).  A walk that leaves the plane or meets a
    choice outside ``(a, b]`` (a plane that is not a DP's) stops there with
    ``counts[i] = -1``."""
    B, R, _, S = C.shape
    dets = torch.zeros((B, R, 2), dtype=torch.int32)
    counts = torch.zeros((B,), dtype=torch.int32)
    for i in range(B):
        n = 0
        work = [(0, R - 1, 0)]
        while work and n >= 0:
            a, b, s = work.pop()
            while a < b:
                c = int(C[i, a, b, s]) if s < S else None
                if c == -1:
                    s += int(x[i, b])
                    b -= 1
                elif c is None or not a < c <= b:
                    n = -1
                    break
                else:
                    dets[i, n] = torch.tensor((c, b), dtype=torch.int32)
                    n += 1
                    work.append((a, c - 1, s))
                    a = c
        counts[i] = n
    return dets.to(C.device), counts.to(C.device)


def ltsp_dp_table_ref(left, right, x, nl, u_turn, S: int):
    """Dense single-instance f32 value table (plain version)."""
    f32 = torch.float32
    T, _ = ltsp_dp_tables_ref(
        left.to(f32)[None], right.to(f32)[None], x.to(torch.int32)[None],
        nl.to(f32)[None], torch.tensor([u_turn], dtype=f32, device=left.device),
        S=S,
    )
    return T[0]


def ltsp_opt_ref(left, right, x, nl, u_turn, m, S: int):
    """Optimal objective value: ``T[0, R-1, 0] + VirtualLB`` (f32)."""
    R = left.shape[0]
    T = ltsp_dp_table_ref(left, right, x, nl, u_turn, S)
    f32 = torch.float32
    virt = torch.sum(x.to(f32) * (m - left + (right - left) + u_turn).to(f32))
    return T[0, R - 1, 0] + virt
