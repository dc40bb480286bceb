"""Brute-force LTSP optima for validating the DP on small instances.

Two independent oracles:

* :func:`bruteforce_trajectory` — Dijkstra over exact head trajectories.
  States are (position, direction, served-mask, last-right-turn).  Turn points
  are restricted to requested-file edges (Lemma 1 shows this is WLOG).  The
  objective accrues at rate ``pending(mask)`` per time unit, which makes the
  sum-of-service-times objective additive along edges.  This oracle does not
  assume anything about detour structure, so it also validates Lemma 1.

* :func:`bruteforce_laminar` — enumerate every strictly laminar detour family
  and score it with the trajectory simulator.  Validates the simulator and the
  detour abstraction against the trajectory oracle.

Plus the polynomial-time schedule validity checker every serving-path caller
uses: :func:`verify_schedule` structurally validates an emitted detour list
and recomputes its cost through the *independent* discrete-event replay in
:mod:`repro_torch.serving.sim`, cross-checked against the inline evaluator in
:mod:`repro_torch.core.schedule` — both must agree with each other (and with the
solver-claimed cost, when given) exactly, in integer arithmetic.
"""

from __future__ import annotations

import heapq
import itertools

import numpy as np

from .instance import Instance
from .schedule import evaluate_detours

__all__ = [
    "bruteforce_trajectory",
    "bruteforce_laminar",
    "laminar_families",
    "verify_schedule",
]


def verify_schedule(
    inst: Instance,
    detours: list[tuple[int, int]],
    cost: int | None = None,
    replay=None,
) -> int:
    """Validate an emitted schedule and return its independently-derived cost.

    Checks, raising ``ValueError`` on the first failure:

    1. **structure** — every detour is an integer pair ``(a, b)`` with
       ``0 <= a <= b < n_req``;
    2. **validity** — the replayed trajectory serves every requested file;
    3. **cost** — the discrete-event replay (:mod:`repro_torch.serving.sim`), the
       inline evaluator (:func:`repro_torch.core.schedule.evaluate_detours`), and —
       when given — the solver-claimed ``cost`` all agree exactly.

    This is the oracle every online serving path runs against each schedule
    it emits; it is polynomial (no brute force), so it scales to paper-size
    instances.  A caller that already replayed the schedule can pass its
    :class:`repro_torch.serving.sim.Replay` as ``replay`` to avoid a second
    trajectory build; the cross-checks still run in full.
    """
    for d in detours:
        a, b = d  # unpacking failure -> malformed pair, let it raise
        if int(a) != a or int(b) != b:
            raise ValueError(f"detour {d!r} has non-integer endpoints")
        if not (0 <= a <= b < inst.n_req):
            raise ValueError(
                f"detour {d!r} out of range for n_req={inst.n_req}"
            )
    if replay is None:
        # deferred import: core must stay importable without the serving layer
        from ..serving.sim import replay_schedule

        replay = replay_schedule(inst, detours)  # raises if a file goes unserved
    inline = evaluate_detours(inst, detours)
    if replay.cost != inline:
        raise ValueError(
            f"replay cost {replay.cost} != inline evaluator cost {inline} "
            f"(simulator/evaluator divergence — this is a bug)"
        )
    if cost is not None and replay.cost != cost:
        raise ValueError(
            f"claimed cost {cost} != independently recomputed cost {replay.cost}"
        )
    return replay.cost


def bruteforce_trajectory(inst: Instance, max_states: int = 2_000_000) -> int:
    """Exact optimum by Dijkstra over head trajectories (small R only)."""
    R = inst.n_req
    if R > 12:
        raise ValueError("trajectory brute force is exponential in n_req")
    left = inst.left.tolist()
    right = inst.right.tolist()
    x = inst.mult.tolist()
    U = inst.u_turn

    # candidate positions: file edges + start position m
    points = sorted({*left, *right, inst.m})
    pidx = {p: i for i, p in enumerate(points)}
    P = len(points)
    full = (1 << R) - 1

    def pending(mask: int) -> int:
        return sum(x[i] for i in range(R) if not (mask >> i) & 1)

    pend = [pending(m_) for m_ in range(1 << R)]

    # state: (pos index, dir(0=left,1=right), mask, q = pos index of last
    # right-turn; only meaningful while dir == 1, else canonicalised to pos)
    start = (pidx[inst.m], 0, 0, pidx[inst.m])
    dist: dict[tuple[int, int, int, int], int] = {start: 0}
    heap: list[tuple[int, tuple[int, int, int, int]]] = [(0, start)]
    visited = set()

    while heap:
        d, st = heapq.heappop(heap)
        if st in visited:
            continue
        visited.add(st)
        if len(visited) > max_states:  # pragma: no cover - guard
            raise RuntimeError("state explosion")
        p, direc, mask, q = st
        if mask == full:
            return d
        pen = pend[mask]
        succs: list[tuple[tuple[int, int, int, int], int]] = []
        if direc == 0:  # moving left
            if p > 0:
                succs.append(((p - 1, 0, mask, p - 1), (points[p] - points[p - 1]) * pen))
            # U-turn to the right (q := here)
            succs.append(((p, 1, mask, p), U * pen))
        else:  # moving right from q (last right-turn)
            if p + 1 < P:
                np_, cost = p + 1, (points[p + 1] - points[p]) * pen
                nmask = mask
                # serve any file whose right edge is the arrival point and
                # whose left edge is right of (or at) the last right-turn
                for i in range(R):
                    if not (nmask >> i) & 1 and right[i] == points[p + 1] and left[i] >= points[q]:
                        nmask |= 1 << i
                succs.append(((np_, 1, nmask, q), cost))
            # U-turn back to the left
            succs.append(((p, 0, mask, p), U * pen))
        for nst, w in succs:
            nd = d + w
            if nst not in dist or nd < dist[nst]:
                dist[nst] = nd
                heapq.heappush(heap, (nd, nst))
    raise RuntimeError("no schedule served all files")  # pragma: no cover


def _laminar_compatible(d1: tuple[int, int], d2: tuple[int, int]) -> bool:
    (a1, b1), (a2, b2) = d1, d2
    if b1 < a2 or b2 < a1:  # disjoint
        return True
    # strict nesting
    return (a1 < a2 and b2 < b1) or (a2 < a1 and b1 < b2)


def laminar_families(n_req: int):
    """Yield every strictly laminar set of detours over ``n_req`` files."""
    pairs = [(a, b) for a in range(n_req) for b in range(a, n_req)]
    for k in range(len(pairs) + 1):
        for combo in itertools.combinations(pairs, k):
            ok = all(
                _laminar_compatible(combo[i], combo[j])
                for i in range(len(combo))
                for j in range(i + 1, len(combo))
            )
            if ok:
                yield list(combo)


def bruteforce_laminar(inst: Instance) -> tuple[int, list[tuple[int, int]]]:
    """Exact optimum over strictly laminar detour families (tiny R only)."""
    R = inst.n_req
    if R > 5:
        raise ValueError("laminar enumeration is doubly exponential in n_req")
    best = None
    best_d: list[tuple[int, int]] = []
    for fam in laminar_families(R):
        c = evaluate_detours(inst, fam)
        if best is None or c < best:
            best, best_d = c, fam
    assert best is not None
    return best, best_d
