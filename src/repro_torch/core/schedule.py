"""Exact trajectory simulator for LTSP detour schedules.

A *schedule* is described by a list of detours ``(a, b)`` over requested-file
indices (paper §4.1): while sweeping left from the right end of the tape, when
the head first reaches ``l(a)`` it U-turns, moves right to ``r(b)``, U-turns,
and resumes the leftward sweep.  Detours are executed in non-increasing order
of their left endpoint.  After the leftmost requested file is reached the head
performs the final left-to-right pass which serves every file still unread
(the implicit global detour ``(f_1, f_{n_f})``).

A request on file ``f`` is served the first time ``f`` is fully traversed
left-to-right.  Every U-turn costs ``U`` time.  This simulator is the single
source of truth against which every algorithm (DP included) is scored, exactly
as the paper scores the list of detours emitted by each algorithm.

Everything is exact integer arithmetic.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from .instance import Instance, virtual_lb

__all__ = [
    "evaluate_detours",
    "service_times",
    "no_detour_cost",
    "schedule_makespan",
    "lower_bound_gap",
]


def _normalise(detours: Iterable[tuple[int, int]], n_req: int) -> list[tuple[int, int]]:
    """Sort detours for execution and sanity-check indices."""
    seen = set()
    out = []
    for a, b in detours:
        a, b = int(a), int(b)
        if not (0 <= a <= b < n_req):
            raise ValueError(f"detour ({a},{b}) out of range for n_req={n_req}")
        if (a, b) not in seen:
            seen.add((a, b))
            out.append((a, b))
    # executed while sweeping left: decreasing left endpoint; for equal left
    # endpoints execute the shorter detour first (it is encountered "inside").
    out.sort(key=lambda ab: (-ab[0], ab[1]))
    return out


def service_times(inst: Instance, detours: Iterable[tuple[int, int]]) -> np.ndarray:
    """Exact service time of each requested file under the detour schedule.

    Returns ``t`` with ``t[i]`` = time at which file ``i``'s requests are all
    served (they are served simultaneously: a file is read once).
    """
    R = inst.n_req
    dets = _normalise(detours, R)
    left, right = inst.left, inst.right
    U = inst.u_turn

    served = np.zeros(R, dtype=bool)
    t_serve = np.full(R, -1, dtype=np.int64)

    t = 0  # clock
    pos = inst.m  # head position, currently sweeping left

    def pass_right(to: int) -> None:
        """U-turn at ``pos`` then move right to ``to``, serving files."""
        nonlocal t, pos
        t += U  # U-turn penalty before the rightward movement
        # files fully inside [pos, to] and not yet served
        idx = np.nonzero((~served) & (left >= pos) & (right <= to))[0]
        for i in idx:
            t_serve[i] = t + (right[i] - pos)
            served[i] = True
        t += to - pos
        pos = to

    def move_left(to: int) -> None:
        nonlocal t, pos
        if to > pos:
            raise ValueError("leftward move target is right of head")
        t += pos - to
        pos = to

    for a, b in dets:
        if left[a] > pos:
            # Detour starts right of the head: it was nested inside an earlier
            # detour with the same or righter span and reads nothing new.
            # Execute it as a null movement (matches 'useless detour' in Fig 2
            # being representable); a well-formed algorithm never emits this.
            continue
        move_left(left[a])
        pass_right(right[b])
        t += U  # U-turn at r(b) back to the leftward sweep

    # final pass: reach the leftmost requested file, then serve the rest
    move_left(left[0])
    if not served.all():
        to = right[int(np.nonzero(~served)[0].max())]
        pass_right(to)
    if not served.all():  # pragma: no cover - defensive
        raise AssertionError("schedule failed to serve every file")
    return t_serve


def evaluate_detours(inst: Instance, detours: Iterable[tuple[int, int]]) -> int:
    """Sum of service times (the LTSP objective) of a detour schedule."""
    t = service_times(inst, detours)
    # Python-int accumulation to avoid int64 overflow on extreme instances.
    return sum(int(m) * int(ti) for m, ti in zip(inst.mult, t))


def no_detour_cost(inst: Instance) -> int:
    """Cost of the NODETOUR schedule (empty detour list)."""
    return evaluate_detours(inst, [])


def schedule_makespan(inst: Instance, detours: Iterable[tuple[int, int]]) -> int:
    """Time at which the last request is served."""
    return int(service_times(inst, detours).max())


def lower_bound_gap(inst: Instance, cost: int) -> float:
    """cost / VirtualLB, a unitless quality measure (>= 1 is not guaranteed
    for VirtualLB == 0 degenerate instances; guarded)."""
    lb = virtual_lb(inst)
    return float(cost) / float(lb) if lb > 0 else float("inf")
