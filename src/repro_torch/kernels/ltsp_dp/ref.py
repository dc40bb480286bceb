"""Plain eager-torch version of the LTSP DP wavefront (values *and* argmins).

The exact Python DP (:mod:`repro_torch.core.dp`) memoises only reachable
``(a, b, n_skip)`` cells; the device formulation instead materialises the
full table ``T[B, R, R, S]`` over every skip count ``s in [0, S)`` and fills
it one anti-diagonal ``d = b - a`` at a time.  Every recurrence is valid for
an arbitrary ``s`` parameter, so the dense table contains no garbage: the
only approximation is the clamped gather ``T[a, b-1, min(s + x_b, S-1)]``,
which can only be hit from cells that are themselves unreachable from the
root ``(0, R-1, 0)``.

This module is the plain version of the hand-written CUDA kernel in
``csrc/ltsp_wavefront.cu``: :func:`diagonal_update` computes exactly what one
kernel launch computes, with the same operation order, the same clamp and
masks, the same sentinels and the same tie-break (skip wins ties; among
detours the smallest ``c`` wins), so the two agree bit for bit.  It runs on
any torch device: the CPU tests use it, the ``"torch"`` backend builds its
tables with it, and ``chip_smoke.py`` holds the kernel against it on the
card.  Unlike the JAX package's value-only oracle it also produces the
argmin plane ``C`` (-1 = skip, else the winning detour start ``c``).
"""

from __future__ import annotations

import torch

__all__ = [
    "INT32_BIG",
    "sentinel",
    "base_diagonal",
    "init_tables",
    "diagonal_update",
    "ltsp_dp_tables_ref",
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


def diagonal_update(
    T, C, left, right, x, nl, u, d: int, *,
    S: int, span: int | None, disjoint: bool, static_tile: bool,
) -> None:
    """Write ``T[:, a, a+d, :]`` and ``C[:, a, a+d, :]`` for every window
    start ``a`` in place, reading only diagonals ``< d``.

    ``static_tile`` selects which of the JAX kernel's two scan forms decides
    the cells whose live candidates all reach the sentinel (see
    ``csrc/ltsp_wavefront.cu``); it never changes any other cell.
    """
    B, R = left.shape
    dev, dtype = T.device, T.dtype
    big = torch.tensor(sentinel(dtype), dtype=dtype, device=dev)
    a = torch.arange(R - d, device=dev)
    b = a + d
    svec = torch.arange(S, dtype=dtype, device=dev)
    s_nl_a = svec + nl[:, a, None]  # [B, n_a, S]
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

    # ---- detour band: strict fold over c = a + k, k ascending ---------
    c_lo = a + 1
    if span is not None:
        c_lo = torch.maximum(c_lo, b - span)
    if disjoint:
        c_lo = torch.where(a > 0, b + 1, c_lo)
    two_u = (2 * u)[:, None, None]
    best = big.expand(B, R - d, S).clone()
    arg = torch.full((B, R - d, S), -1, dtype=torch.int32, device=dev)
    # c = a + k >= c_lo  <=>  k >= k_min for every a (the span clip is
    # relative to b = a + d); only the disjoint clip depends on a itself
    k_min = 1 if span is None else max(1, d - span)
    root_only = (a == 0)[None, :, None] if disjoint else None
    for k in range(k_min, d + 1):
        c = a + k
        cand = (
            (T[:, a, c - 1, :] + T[:, c, b, :])
            + (2 * (r_b - right[:, c - 1]))[:, :, None] * s_nl_a
        ) + two_u * (svec + nl[:, c, None])
        better = (arg < 0) | (cand < best)
        if root_only is not None:
            better &= root_only
        best = torch.where(better, cand, best)
        arg = torch.where(better, c.to(torch.int32)[None, :, None], arg)

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
