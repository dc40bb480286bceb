"""Deterministic discrete-event tape simulator: the serving test oracle.

Two roles, one integer-exact model:

* **Schedule replay oracle** — :func:`replay_schedule` turns a detour list
  into the explicit head trajectory (:class:`Leg` segments: leftward seeks,
  U-turn dwells, rightward reads) and *independently* recomputes every
  requested file's service time, the LTSP objective, and the makespan from
  those segments.  It shares the detour-execution semantics of
  :mod:`repro_torch.core.schedule` (same normalisation, same degenerate-detour
  handling) but none of its code: service times are derived by scanning the
  materialised trajectory, so a bug in either implementation shows up as a
  cost mismatch.  ``repro_torch.core.verify.verify_schedule`` uses it as the
  independent scorer for every schedule the online queue service emits.

* **Online-serving clock** — :func:`poisson_trace` draws a seeded arrival
  trace (integer virtual time, geometric inter-arrivals, Zipf-skewed file
  popularity) against a :class:`~repro_torch.storage.tape.TapeLibrary`, and the
  drive-model helpers (:func:`head_position`, :func:`rewind_time`) plus the
  report types (:class:`ServedRequest`, :class:`BatchRecord`,
  :class:`ServiceReport`) give :mod:`repro_torch.serving.queue` everything it needs
  to advance virtual time deterministically and report per-request
  wait/service-time distributions.

Timing model (consistent with :mod:`repro_torch.core.instance`): positions are
integers (bytes), the head seeks *and* reads at unit speed (1 time unit per
byte), every U-turn dwells ``U`` time units, and a batch ends with a rewind
to the load point ``m`` (one U-turn plus the seek back) so the next batch
starts from the state the LTSP instance model assumes.  Everything is exact
Python-int arithmetic — no floats anywhere near a cost.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from ..core.instance import Instance

__all__ = [
    "Leg",
    "Replay",
    "replay_schedule",
    "head_position",
    "rewind_time",
    "Request",
    "poisson_trace",
    "demo_library",
    "ServedRequest",
    "FailedRequest",
    "BatchRecord",
    "ServiceReport",
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


# ---------------------------------------------------------------------------
# seeded arrival traces
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, order=True)
class Request:
    """One online read request (ordered by arrival time, then id)."""

    time: int
    req_id: int
    tape_id: str
    name: str


def poisson_trace(
    library,
    n_requests: int,
    mean_interarrival: int,
    seed: int,
    skew: float = 1.1,
) -> list[Request]:
    """Seeded arrival trace against a :class:`~repro_torch.storage.tape.TapeLibrary`.

    Inter-arrival gaps are geometric with the given integer mean (the discrete
    analogue of a Poisson process), file popularity is Zipf-skewed over a
    seeded permutation of the stored files.  Deterministic given ``seed``.
    """
    if mean_interarrival < 1:
        raise ValueError("mean_interarrival must be >= 1")
    names = sorted(library.location)
    if not names:
        raise ValueError("library holds no files")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(names))
    weights = 1.0 / (1.0 + np.arange(len(names))) ** skew
    weights = weights[np.argsort(perm)]
    weights /= weights.sum()
    gaps = rng.geometric(1.0 / float(mean_interarrival), size=n_requests)
    times = np.cumsum(gaps.astype(np.int64))
    picks = rng.choice(len(names), size=n_requests, p=weights)
    return [
        Request(
            time=int(times[i]),
            req_id=i,
            tape_id=library.location[names[int(picks[i])]],
            name=names[int(picks[i])],
        )
        for i in range(n_requests)
    ]


def demo_library(
    seed: int,
    n_files: int = 48,
    capacity: int = 4_000_000,
    u_turn: int = 20_000,
    with_cache: bool = True,
):
    """Seeded multi-cartridge archive shared by every online-serving surface.

    The benchmark sweep, the ``--serve-tape-queue`` launcher, the example,
    and the acceptance tests all serve traces against this same library, so
    their numbers stay comparable by construction (100-600 KB objects packed
    onto ~4 MB cartridges; the library's
    :class:`~repro_torch.core.ExecutionContext` carries one
    :class:`~repro_torch.core.SolveCache` unless ``with_cache=False``).
    """
    from ..core.solver import ExecutionContext, SolveCache
    from ..storage.tape import TapeLibrary

    lib = TapeLibrary(
        capacity_per_tape=capacity,
        u_turn=u_turn,
        context=ExecutionContext(cache=SolveCache() if with_cache else None),
    )
    rng = np.random.default_rng(seed)
    for i in range(n_files):
        lib.store(f"obj{i:04d}", int(rng.integers(100_000, 600_000)))
    return lib


# ---------------------------------------------------------------------------
# report types
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServedRequest:
    """One completed request with its full timeline."""

    req_id: int
    name: str
    tape_id: str
    arrival: int
    dispatched: int  # when its batch was handed to the drive
    completed: int  # absolute service completion
    #: the request was touched by a fault before completing (requeued by a
    #: drive failure / media abort, or delayed by transient mount retries)
    faulted: bool = False

    @property
    def sojourn(self) -> int:
        """Service time experienced by the user: completion - arrival."""
        return self.completed - self.arrival


@dataclasses.dataclass(frozen=True)
class FailedRequest:
    """A request the fault layer gave up on (typed; only under
    ``RetryPolicy(on_exhausted="drop")`` / ``failover=False``).

    ``reason`` is one of ``"mount-failed"`` (transient mount retries
    exhausted), ``"media-error"`` (bad-span read retries exhausted),
    ``"drive-failure"`` (in-flight on a failed drive, failover disabled),
    ``"solver-failed"`` (every degradation-chain tier exhausted) or
    ``"no-drive"`` (still queued when the last drive died).
    """

    req_id: int
    name: str
    tape_id: str
    arrival: int
    failed_at: int
    reason: str


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    """One dispatched batch (one LTSP solve against one cartridge).

    ``mount_delay`` is the mount leg the drive pool charged before the
    schedule's trajectory started (unmount of the previous cartridge + mount
    + seek to the load point; 0 when the cartridge was already threaded) —
    the replayed completions below all shift by it.
    """

    tape_id: str
    dispatched: int
    n_requests: int
    n_files: int
    solver_cost: int
    replay_cost: int
    makespan: int
    rewind: int
    verified: bool
    preempted: bool = False
    n_completed: int | None = None  # only set when preempted
    drive: int = 0  # drive the pool assigned
    mount_delay: int = 0
    #: exact DP work accounting for this batch's solve (see repro_torch.core.warm):
    #: recurrence folds performed vs. cells transferred from a WarmState;
    #: ``warm_mode`` is the WarmStats mode ("cold"/"warm"/"cache"/...).
    cells_evaluated: int = 0
    cells_reused: int = 0
    warm_mode: str = "cold"
    #: fault that aborted this batch mid-flight ("drive-failure" /
    #: "media-error"); None for clean batches and admission preemptions
    aborted_by: str | None = None
    #: transient mount failures retried (with backoff) before this dispatch
    mount_retries: int = 0
    #: backend that actually solved after a degradation-chain fallback
    #: (None: the requested backend, possibly after same-tier retries)
    degraded_to: str | None = None
    #: policy a SolverSelector picked for this tick (None: no selector ran —
    #: the batch was solved with the server's configured policy)
    policy_used: str | None = None
    #: virtual time the batch's solve work cost under the context's
    #: ComputeBudget (cells_evaluated priced at solve_time_num/den; the
    #: dispatch's service start was delayed by exactly this much)
    solve_delay: int = 0


@dataclasses.dataclass
class ServiceReport:
    """Outcome of one online-serving simulation run."""

    admission: str
    policy: str
    backend: str
    window: int
    served: list[ServedRequest]
    batches: list[BatchRecord]
    n_preemptions: int
    horizon: int  # virtual time when the last drive went idle
    cache_stats: dict[str, int] | None = None
    #: drive-pool accounting (n_drives, mounts, unmounts, mount_time)
    pool_stats: dict[str, int] | None = None
    #: mount-scheduler the pool ran (see repro_torch.serving.drives.MOUNT_SCHEDULERS)
    scheduler: str = "greedy"
    #: req_id -> QoSSpec the server attached at enqueue (None: QoS unset).
    #: Typed loosely to keep sim importable without the QoS layer; entries
    #: only need ``.deadline``.  repro_torch.serving.qos.slo_report joins on it.
    qos: dict | None = None
    #: whether the server carried WarmStates across this run's solves
    warm_start: bool = False
    #: typed FailedRequest rows (only the drop/fail-stop retry policies)
    failed: list = dataclasses.field(default_factory=list)
    #: exact fault/retry accounting (drive_failures, mount_retries,
    #: media_aborts, solver_faults, fallbacks, requeued, retry_delay);
    #: None when the run had no fault plan and no explicit retry policy —
    #: fault-free reports stay key-for-key identical to the fault-unaware format
    fault_stats: dict | None = None
    #: SolverSelector the server consulted per tick (None: adaptive
    #: dispatch off — reports stay key-for-key identical to the fixed-policy format)
    selector: str | None = None

    # -- exact aggregates (ints, safe to assert on) --------------------------
    @property
    def n_served(self) -> int:
        return len(self.served)

    @property
    def total_sojourn(self) -> int:
        return sum(r.sojourn for r in self.served)

    @property
    def makespan(self) -> int:
        return max((r.completed for r in self.served), default=0)

    @property
    def n_failed(self) -> int:
        """Requests the fault layer dropped (typed rows in ``failed``)."""
        return len(self.failed)

    @property
    def n_faulted(self) -> int:
        """Served requests that were touched by a fault on the way."""
        return sum(1 for r in self.served if r.faulted)

    @property
    def completion_rate(self) -> float:
        """Served / (served + dropped); 1.0 on a fault-free run."""
        total = self.n_served + self.n_failed
        return self.n_served / total if total else 0.0

    @property
    def cells_evaluated(self) -> int:
        """Total DP recurrence folds across every batch solve (exact)."""
        return sum(b.cells_evaluated for b in self.batches)

    @property
    def cells_reused(self) -> int:
        """Total DP cells transferred from warm states instead of folded."""
        return sum(b.cells_reused for b in self.batches)

    @property
    def total_solve_delay(self) -> int:
        """Virtual time charged for solver compute across all batches."""
        return sum(b.solve_delay for b in self.batches)

    @property
    def policy_mix(self) -> dict[str, int]:
        """Batches per policy the selector actually dispatched ({} = off)."""
        mix: dict[str, int] = {}
        for b in self.batches:
            if b.policy_used is not None:
                mix[b.policy_used] = mix.get(b.policy_used, 0) + 1
        return mix

    # -- float conveniences for tables ---------------------------------------
    @property
    def mean_sojourn(self) -> float:
        return self.total_sojourn / self.n_served if self.served else 0.0

    def sojourn_quantile(self, q: float) -> float:
        if not self.served:
            return 0.0
        return float(np.quantile([r.sojourn for r in self.served], q))

    # -- deadline outcomes (exact ints; require a qos map) -------------------
    @property
    def n_deadlines(self) -> int:
        """Served requests that carried a deadline (0 when QoS is unset)."""
        if not self.qos:
            return 0
        return sum(
            1
            for r in self.served
            if (spec := self.qos.get(r.req_id)) is not None
            and spec.deadline is not None
        )

    @property
    def n_missed(self) -> int:
        """Served requests completed strictly after their deadline."""
        if not self.qos:
            return 0
        return sum(
            1
            for r in self.served
            if (spec := self.qos.get(r.req_id)) is not None
            and spec.deadline is not None
            and r.completed > spec.deadline
        )

    @property
    def miss_rate(self) -> float:
        return self.n_missed / self.n_deadlines if self.n_deadlines else 0.0

    def summary(self) -> dict:
        """Machine-readable row for benchmarks (``--record``)."""
        # DrivePool.stats() now always reports alive_drives, but this row's
        # key shape (and order) is pinned by recorded benchmark JSON: keep
        # alive_drives out of fault-free rows and after drive_failures
        # otherwise, exactly as the pre-observability pool reported it.
        pool = dict(self.pool_stats) if self.pool_stats else {}
        alive = pool.pop("alive_drives", None)
        if "drive_failures" in pool and alive is not None:
            pool["alive_drives"] = alive
        out = {
            "admission": self.admission,
            "policy": self.policy,
            "backend": self.backend,
            "window": self.window,
            "scheduler": self.scheduler,
            "n_served": self.n_served,
            "n_batches": len(self.batches),
            "n_preemptions": self.n_preemptions,
            "total_sojourn": self.total_sojourn,
            "mean_sojourn": self.mean_sojourn,
            "p50_sojourn": self.sojourn_quantile(0.50),
            "p95_sojourn": self.sojourn_quantile(0.95),
            "p99_sojourn": self.sojourn_quantile(0.99),
            "max_sojourn": max((r.sojourn for r in self.served), default=0),
            "makespan": self.makespan,
            "horizon": self.horizon,
            "all_verified": all(b.verified for b in self.batches),
            "warm_start": self.warm_start,
            "cells_evaluated": self.cells_evaluated,
            "cells_reused": self.cells_reused,
            "cells_per_batch": (
                self.cells_evaluated / len(self.batches) if self.batches else 0.0
            ),
            **pool,
            **({"cache": dict(self.cache_stats)} if self.cache_stats else {}),
        }
        if self.qos:
            out["n_deadlines"] = self.n_deadlines
            out["n_missed"] = self.n_missed
            out["miss_rate"] = self.miss_rate
        if self.fault_stats is not None:
            out["faults"] = dict(self.fault_stats)
            out["n_failed"] = self.n_failed
            out["n_faulted"] = self.n_faulted
            out["completion_rate"] = self.completion_rate
        if self.selector is not None:
            out["selector"] = self.selector
            out["policy_mix"] = self.policy_mix
            out["total_solve_delay"] = self.total_solve_delay
        return out
