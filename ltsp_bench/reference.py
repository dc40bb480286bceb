"""The plain reference: the paper's DP in plain torch, and an independent
score of a schedule.

Nothing here imports the program.  :func:`dp_solve` computes the table of
the paper's recurrence (arXiv:2112.09384 §4.3) window width by window
width, every skip count at once, in the type it is given, and returns the
root value (the optimum relative to *VirtualLB*) with a detour list walked
from its argmin plane.  In float64 every value of the benchmark's tapes is
an integer below 2**53, so the reference is exact; in float32 it is the
control, which cannot be.  The table ``T`` and its argmin plane ``C`` hold
the windows ``a <= b`` only, window ``(a, b)`` at row
``p(a, b) = a R - a (a - 1) / 2 + (b - a)`` of ``R (R + 1) / 2``: they take
``(item + 4) R (R + 1) / 2 S`` bytes, 63.1 GB for the widest IN2P3 tape in
float64 (``R`` 710, ``S`` 20,822), which fits the card once the program's
state is freed.  :func:`schedule_cost` replays a detour list as a head
trajectory in Python integers and returns its objective, the sum of the
requests' service times; :func:`virtual_lb` is the paper's lower bound.

The recurrence, for files ``a < b`` of the window and ``s`` skipped
requests (``n_l`` the requests left of a file, ``x`` its multiplicity)::

  T[b, b, s]  = 2 size(b) (s + n_l(b))
  skip        = T[a, b-1, s + x(b)] + 2 (r(b) - r(b-1)) (s + n_l(a))
                + 2 (l(b) - r(b-1)) x(b)
  detour_c    = T[a, c-1, s] + T[c, b, s] + 2 (r(b) - r(c-1)) (s + n_l(a))
                + 2 U (s + n_l(c)),     max(a + 1, b - span) <= c <= b
  T[a, b, s]  = min(skip, min_c detour_c)
"""

from __future__ import annotations

import torch

#: elements of one block of candidates (windows x detour starts x skip
#: counts) folded at once: bounds the reference's temporaries to a few GB
BLOCK_ELEMENTS = 1 << 25


def virtual_lb(left, size, mult, m: int, u_turn: int) -> int:
    """Each request served by its own head: ``sum x (m - l + size + U)``."""
    return sum(int(x) * (m - int(lo) + int(sz) + u_turn)
               for lo, sz, x in zip(left, size, mult))


def row(a, b, R: int):
    """Row of the window ``(a, b)``, ``a <= b``, in the tables ``a <= b``:
    the windows ordered by ``a``, then ``b``."""
    return a * R - a * (a - 1) // 2 + (b - a)


def dp_solve(left, size, mult, u_turn: int, span: int | None, dtype: torch.dtype,
             device) -> tuple[float, list[tuple[int, int]]]:
    """``(T[0, R-1, 0], detours)`` of one tape's DP table in ``dtype``."""
    R = len(left)
    n = int(sum(int(v) for v in mult))
    S = n + 1
    l = torch.tensor([int(v) for v in left], dtype=torch.int64, device=device)
    r = l + torch.tensor([int(v) for v in size], dtype=torch.int64, device=device)
    x = torch.tensor([int(v) for v in mult], dtype=torch.int64, device=device)
    nl = torch.cumsum(x, 0) - x
    lf, rf, xf, nlf = (v.to(dtype) for v in (l, r, x, nl))
    s_int = torch.arange(S, device=device)
    s = s_int.to(dtype)
    inf = torch.tensor(float("inf"), dtype=dtype, device=device)

    T = torch.full((R * (R + 1) // 2, S), float("inf"), dtype=dtype, device=device)
    C = torch.full((R * (R + 1) // 2, S), -1, dtype=torch.int32, device=device)
    diag = torch.arange(R, device=device)
    T[row(diag, diag, R)] = 2 * (rf - lf)[:, None] * (s[None, :] + nlf[:, None])
    for d in range(1, R):
        k_lo = 1 if span is None else max(1, d - span)
        k = torch.arange(k_lo, d + 1, device=device)
        step = max(1, BLOCK_ELEMENTS // (len(k) * S))
        for a0 in range(0, R - d, step):
            a = torch.arange(a0, min(R - d, a0 + step), device=device)
            b = a + d
            # skip b: s + x(b) skipped requests one file to the left
            shifted = s_int[None, :] + x[b][:, None]
            skip = torch.gather(T[row(a, b - 1, R)], 1, shifted.clamp(max=S - 1))
            skip = torch.where(shifted < S, skip, inf)
            skip = (skip + 2 * (rf[b] - rf[b - 1])[:, None] * (s[None, :] + nlf[a][:, None])
                    + (2 * (lf[b] - rf[b - 1]) * xf[b])[:, None])
            # detour (c, b), c = a + k
            c = a[:, None] + k[None, :]
            det = T[row(a[:, None], c - 1, R)] + T[row(c, b[:, None], R)]
            det += (2 * (rf[b][:, None] - rf[c - 1]))[..., None] * (s[None, None, :]
                                                                   + nlf[a][:, None, None])
            det += 2 * u_turn * (s[None, None, :] + nlf[c][..., None])
            best, arg = det.min(dim=1)
            take = best < skip
            p = row(a, b, R)
            T[p] = torch.where(take, best, skip)
            C[p] = torch.where(take, (a[:, None] + k_lo + arg).to(torch.int32), -1)
    root = float(T[row(0, R - 1, R), 0])
    return root, _walk(C, [int(v) for v in mult], R)


def solve(tape: dict, span: int | None, dtype: torch.dtype, device) -> tuple[int, tuple]:
    """``(cost, detours)`` of a tape (a dict of ``left``, ``size``, ``mult``,
    ``m``, ``u_turn``): the table's root plus *VirtualLB*, rounded to an
    integer, and the detours of its argmin plane."""
    root, detours = dp_solve(tape["left"], tape["size"], tape["mult"], tape["u_turn"], span,
                             dtype, device)
    vlb = virtual_lb(tape["left"], tape["size"], tape["mult"], tape["m"], tape["u_turn"])
    return int(round(root)) + vlb, tuple(detours)


def _walk(C: torch.Tensor, x: list[int], R: int) -> list[tuple[int, int]]:
    """The detours of the argmin plane, from the root window ``(0, R-1, 0)``."""
    detours: list[tuple[int, int]] = []
    work = [(0, R - 1, 0)]
    while work:
        a, b, s = work.pop()
        while a < b:
            c = int(C[row(a, b, R), s])
            if c == -1:
                s += x[b]
                b -= 1
                continue
            detours.append((c, b))
            work.append((a, c - 1, s))
            a = c
    return detours


def schedule_cost(left, size, mult, m: int, u_turn: int, detours) -> int:
    """The objective of a detour list, replayed as a head trajectory.

    The head starts at ``m`` moving left.  It runs the detours in the order
    it reaches their starts, rightmost first: at ``l(c)`` it turns, reads
    right to ``r(b)``, serving every file of ``c .. b`` not served yet,
    and turns again; each turn costs ``U``.  At the end it goes to ``l(0)``,
    turns and reads every file left.  A request's service time is the time
    at which its file has been read left to right.
    """
    R = len(left)
    lo = [int(v) for v in left]
    hi = [lo[i] + int(size[i]) for i in range(R)]
    served: list[int | None] = [None] * R
    t, p = 0, int(m)
    for c, b in sorted(detours, key=lambda cb: (-cb[0], cb[1])):
        if not 0 <= c <= b < R:
            raise ValueError(f"detour {(c, b)} outside the tape's {R} files")
        t += abs(p - lo[c]) + u_turn
        for f in range(c, b + 1):
            if served[f] is None:
                served[f] = t + hi[f] - lo[c]
        t += hi[b] - lo[c] + u_turn
        p = hi[b]
    t += abs(p - lo[0]) + u_turn
    return sum(int(mult[f]) * (served[f] if served[f] is not None else t + hi[f] - lo[0])
               for f in range(R))
