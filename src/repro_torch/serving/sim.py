"""Deterministic schedule replay: the independent scorer of a detour list.

Only the schedule-replay half of the reference's serving simulator is ported
so far (the online-serving clock, arrival traces and report types come with
the serving stack).  :func:`replay_schedule` turns a detour list into the
explicit head trajectory (:class:`Leg` segments: leftward seeks, U-turn
dwells, rightward reads) and *independently* recomputes every requested
file's service time, the LTSP objective, and the makespan from those
segments.  It shares the detour-execution semantics of
:mod:`repro_torch.core.schedule` (same normalisation, same degenerate-detour
handling) but none of its code: service times are derived by scanning the
materialised trajectory, so a bug in either implementation shows up as a
cost mismatch.  :func:`repro_torch.core.verify.verify_schedule` uses it as
the independent scorer.

Timing model (consistent with :mod:`repro_torch.core.instance`): positions
are integers (bytes), the head seeks *and* reads at unit speed (1 time unit
per byte), every U-turn dwells ``U`` time units, and a batch ends with a
rewind to the load point ``m`` (one U-turn plus the seek back).  Everything
is exact Python-int arithmetic — no floats anywhere near a cost.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from ..core.instance import Instance

__all__ = [
    "Leg",
    "Replay",
    "replay_schedule",
    "head_position",
    "rewind_time",
]


# ---------------------------------------------------------------------------
# schedule replay: detours -> trajectory -> service times (the oracle)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Leg:
    """One constant-velocity (or dwelling) segment of the head trajectory."""

    t0: int
    t1: int
    p0: int
    p1: int
    kind: str  # "seek-left" | "uturn" | "read"


@dataclasses.dataclass(frozen=True)
class Replay:
    """Independent replay of a detour schedule (all exact integers)."""

    service_time: tuple[int, ...]  # per requested file, trajectory-derived
    cost: int  # sum of mult[i] * service_time[i]
    makespan: int  # last service completion
    head_at_makespan: int  # head position when the last request is served
    legs: tuple[Leg, ...]
    distance: int  # total head travel (no dwells)
    n_uturns: int


def _execution_order(
    detours: Iterable[tuple[int, int]], n_req: int
) -> list[tuple[int, int]]:
    """Detours in execution order: decreasing left endpoint, shorter first on
    ties (the semantics of :mod:`repro_torch.core.schedule`), duplicates dropped."""
    seen: set[tuple[int, int]] = set()
    out: list[tuple[int, int]] = []
    for a, b in detours:
        a, b = int(a), int(b)
        if not (0 <= a <= b < n_req):
            raise ValueError(f"detour ({a},{b}) out of range for n_req={n_req}")
        if (a, b) not in seen:
            seen.add((a, b))
            out.append((a, b))
    out.sort(key=lambda ab: (-ab[0], ab[1]))
    return out


def replay_schedule(inst: Instance, detours: Iterable[tuple[int, int]]) -> Replay:
    """Materialise the head trajectory of a detour schedule and score it.

    Builds the full trajectory first (legs), then derives service times by
    scanning the rightward legs: a file is served the first time a single
    rightward run covers it end to end, at the instant its right edge is
    reached.  Raises if the trajectory fails to serve every file.
    """
    R = inst.n_req
    left = inst.left.tolist()
    right = inst.right.tolist()
    mult = inst.mult.tolist()
    U = int(inst.u_turn)

    # ---- pass 1: trajectory ------------------------------------------------
    legs: list[Leg] = []
    t = 0
    pos = int(inst.m)

    def emit(kind: str, to: int | None = None) -> None:
        nonlocal t, pos
        if kind == "uturn":
            legs.append(Leg(t, t + U, pos, pos, "uturn"))
            t += U
            return
        assert to is not None
        legs.append(Leg(t, t + abs(to - pos), pos, to, kind))
        t += abs(to - pos)
        pos = to

    for a, b in _execution_order(detours, R):
        if left[a] > pos:
            # degenerate nested detour starting right of the head: reads
            # nothing, executed as a null movement (matches core.schedule)
            continue
        emit("seek-left", left[a])
        emit("uturn")
        emit("read", right[b])
        emit("uturn")

    emit("seek-left", left[0])
    # final left-to-right pass over whatever a quick scan says is uncovered;
    # service attribution below decides what each rightward run actually reads
    covered = [False] * R
    for lg in legs:
        if lg.kind == "read":
            for i in range(R):
                if not covered[i] and lg.p0 <= left[i] and right[i] <= lg.p1:
                    covered[i] = True
    if not all(covered):
        emit("uturn")
        emit("read", max(right[i] for i in range(R) if not covered[i]))

    # ---- pass 2: service times from the trajectory -------------------------
    t_serve = [-1] * R
    for lg in legs:
        if lg.kind != "read":
            continue
        for i in range(R):
            if t_serve[i] < 0 and lg.p0 <= left[i] and right[i] <= lg.p1:
                t_serve[i] = lg.t0 + (right[i] - lg.p0)
    if any(ts < 0 for ts in t_serve):
        raise ValueError("schedule failed to serve every requested file")

    cost = sum(x * ts for x, ts in zip(mult, t_serve))
    makespan = max(t_serve)
    distance = sum(abs(lg.p1 - lg.p0) for lg in legs)
    n_uturns = sum(lg.kind == "uturn" for lg in legs)
    return Replay(
        service_time=tuple(t_serve),
        cost=cost,
        makespan=makespan,
        head_at_makespan=head_position(legs, makespan),
        legs=tuple(legs),
        distance=distance,
        n_uturns=n_uturns,
    )


def head_position(legs: Sequence[Leg], t: int) -> int:
    """Head position at trajectory-relative time ``t`` (clamped to the ends).

    ``t < 0`` clamps to the trajectory start — a drive preempted during its
    mount legs (before ``service_start``) reads as parked at the load point.
    """
    if not legs or t <= legs[0].t0:
        return legs[0].p0 if legs else 0
    for lg in legs:
        if t <= lg.t1:
            if lg.p1 == lg.p0:  # dwell (U-turn or zero-length seek)
                return lg.p0
            step = t - lg.t0
            return lg.p0 + step if lg.p1 >= lg.p0 else lg.p0 - step
    return legs[-1].p1


def rewind_time(m: int, u_turn: int, pos: int) -> int:
    """Time to return the head to the load point ``m`` (one U-turn + seek)."""
    if pos == m:
        return 0
    return int(u_turn) + abs(int(m) - int(pos))
