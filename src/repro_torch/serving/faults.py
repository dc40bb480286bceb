"""Deterministic fault injection + crash recovery for the serving loop.

Real tape libraries are mechanical: drives die mid-read, mounts fail and
succeed on retry, media develops bad spans, and device solvers hiccup.  This
module models all of that *deterministically* — faults are declared up front
in a :class:`FaultPlan` (or drawn from a seed by :func:`seeded_fault_plan`)
and consumed at exact virtual-time instants by a :class:`FaultInjector`, so
two runs with the same plan are bit-identical and every recovery path is
assertable to the integer.

Fault classes (one frozen record type each, all opt-in):

* :class:`DriveFailure` — drive ``drive`` hard-fails at virtual time ``at``:
  it is removed from the :class:`~repro_torch.serving.drives.DrivePool` (and from
  every mount scheduler's view), its in-flight batch is aborted with
  completions at or before the failure standing, the unserved requests are
  requeued (head state discarded — the drive is gone), and the cartridge
  remounts on a surviving drive at full remount cost.
* :class:`MountFault` — the next ``count`` mount attempts of a cartridge
  fail transiently; each failed attempt charges the
  :class:`~repro_torch.serving.drives.RetryPolicy` exponential backoff in exact
  virtual time before the retry.
* :class:`MediaFault` — the next ``count`` read passes over the byte span
  ``[lo, hi]`` of a tape fail: the batch aborts at the exact instant the
  head first touches the span (the ``preempt`` rewind mechanism), backoff is
  charged, and the surviving requests requeue for a retry read.
* :class:`SolverFault` — the next ``count`` solve attempts on a backend
  raise :class:`~repro_torch.core.solver.TransientSolverError`; the solver engine
  degrades ``cuda → torch → python``
  (:func:`~repro_torch.core.solver.solve_warm_degraded`), bit-identically.

Exhausted retry budgets surface as typed errors
(:class:`MountFailedError`, :class:`MediaReadError`,
:class:`~repro_torch.serving.drives.NoDriveAvailableError`,
:class:`~repro_torch.core.solver.SolverUnavailableError`) or, under
``RetryPolicy(on_exhausted="drop")``, as typed
:class:`~repro_torch.serving.sim.FailedRequest` rows on the
:class:`~repro_torch.serving.sim.ServiceReport`.

Crash recovery: the write-ahead event journal
---------------------------------------------
:class:`EventJournal` is an append-only JSONL log of the server's
observable events (``start``/``enqueue``/``batch``/``serve``/``abort``/
``drive-fail``/``end``), flushed per event — the same torn-line-tolerant
idiom as :class:`~repro_torch.core.cache.JsonlCacheBackend`.  Because the server
is a deterministic function of ``(library, trace, configuration)``, the
journal does not need to be *replayed into* state: :func:`recover_server`
truncates a crashed journal to its last intact line, re-executes the run
from the start, and cross-checks every re-produced event against the
journaled prefix (any divergence raises :class:`JournalReplayError` —
redo-validated write-ahead logging).  Past the prefix the run continues
live, appending to the same journal, so the final
:class:`~repro_torch.serving.sim.ServiceReport` is bit-identical to the
uninterrupted run *and* the journal ends complete.  A solve memo
(:class:`~repro_torch.core.cache.JsonlCacheBackend`) makes the redo phase cheap:
every re-executed solve is a cache hit.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..core.solver import TransientSolverError
from .sim import Leg

__all__ = [
    "DriveFailure",
    "ShardOutage",
    "MountFault",
    "MediaFault",
    "SolverFault",
    "FaultPlan",
    "FaultInjector",
    "seeded_fault_plan",
    "MountFailedError",
    "MediaReadError",
    "EventJournal",
    "JournalReplayError",
    "recover_server",
]


# ---------------------------------------------------------------------------
# typed recovery errors
# ---------------------------------------------------------------------------
class MountFailedError(RuntimeError):
    """A cartridge's transient mount failures exhausted the retry budget."""

    def __init__(self, tape_id: str, attempts: int):
        self.tape_id = tape_id
        self.attempts = attempts
        super().__init__(
            f"mount of {tape_id!r} still failing after {attempts} attempt(s)"
        )


class MediaReadError(RuntimeError):
    """A bad media span kept failing reads past the retry budget."""

    def __init__(self, span: tuple, attempts: int):
        self.span = span
        self.attempts = attempts
        tape_id, lo, hi = span
        super().__init__(
            f"media span [{lo}, {hi}] of {tape_id!r} still failing after "
            f"{attempts} read attempt(s)"
        )


class JournalReplayError(RuntimeError):
    """Journal replay diverged from the deterministic re-execution."""


# ---------------------------------------------------------------------------
# fault records + plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DriveFailure:
    """Drive ``drive`` hard-fails (permanently) at virtual time ``at``."""

    at: int
    drive: int

    def __post_init__(self) -> None:
        if self.at < 0:
            raise ValueError("failure time must be >= 0")
        if self.drive < 0:
            raise ValueError("drive id must be >= 0")


@dataclasses.dataclass(frozen=True)
class ShardOutage:
    """Every drive of federation shard ``shard`` hard-fails at time ``at``.

    The shared-fault-domain analogue of :class:`DriveFailure`: a whole
    robotic library (one shard of :mod:`repro_torch.fleet`) goes dark at one
    virtual instant — power loss, arm jam, network partition.  The fleet
    layer (:class:`~repro_torch.fleet.FleetServer`) expands it into per-drive hard failures on the shard (each
    through the standard :meth:`OnlineTapeServer._fail_drive` abort/requeue
    machinery) and then re-routes every orphaned queued request that has a
    replica on a surviving shard.  Requests without a surviving replica
    follow the shard's own :class:`~repro_torch.serving.drives.RetryPolicy`
    exhaustion path (typed raise or typed drop).
    """

    at: int
    shard: int

    def __post_init__(self) -> None:
        if self.at < 0:
            raise ValueError("outage time must be >= 0")
        if self.shard < 0:
            raise ValueError("shard index must be >= 0")


@dataclasses.dataclass(frozen=True)
class MountFault:
    """The next ``count`` mount attempts of ``tape_id`` fail transiently."""

    tape_id: str
    count: int = 1

    def __post_init__(self) -> None:
        if self.count < 1:
            raise ValueError("count must be >= 1")


@dataclasses.dataclass(frozen=True)
class MediaFault:
    """The next ``count`` read passes over ``[lo, hi]`` of ``tape_id`` fail."""

    tape_id: str
    lo: int
    hi: int
    count: int = 1

    def __post_init__(self) -> None:
        if not (0 <= self.lo <= self.hi):
            raise ValueError("need 0 <= lo <= hi")
        if self.count < 1:
            raise ValueError("count must be >= 1")


@dataclasses.dataclass(frozen=True)
class SolverFault:
    """The next ``count`` solve attempts on ``backend`` raise transiently."""

    backend: str
    count: int = 1

    def __post_init__(self) -> None:
        if self.count < 1:
            raise ValueError("count must be >= 1")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A declarative, deterministic fault schedule for one serving run.

    An empty plan is falsy; the server treats ``faults=None`` and
    ``faults=FaultPlan()`` identically (no injector, the fault-free fast
    path).
    """

    drive_failures: tuple[DriveFailure, ...] = ()
    mount_faults: tuple[MountFault, ...] = ()
    media_faults: tuple[MediaFault, ...] = ()
    solver_faults: tuple[SolverFault, ...] = ()

    def __bool__(self) -> bool:
        return bool(
            self.drive_failures
            or self.mount_faults
            or self.media_faults
            or self.solver_faults
        )


class FaultInjector:
    """Mutable per-run consumption state over a frozen :class:`FaultPlan`.

    The injector owns the remaining-count bookkeeping: each query consumes
    at most one planned fault and increments the matching ``fired`` counter,
    so a plan is a *budget* and the report's fault statistics say exactly
    how much of it the run actually hit.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._mount_left = {
            mf.tape_id: mf.count for mf in plan.mount_faults
        }
        self._media = list(plan.media_faults)
        self._media_left = [mf.count for mf in self._media]
        self._solver_left = {
            sf.backend: sf.count for sf in plan.solver_faults
        }
        self.fired = {"drive": 0, "mount": 0, "media": 0, "solver": 0}

    def drive_failures(self) -> tuple[DriveFailure, ...]:
        """The planned hard failures, sorted by time then drive id."""
        return tuple(sorted(self.plan.drive_failures,
                            key=lambda f: (f.at, f.drive)))

    def drive_failed(self) -> None:
        self.fired["drive"] += 1

    def mount_fails(self, tape_id: str) -> bool:
        """Consume one pending transient mount failure for this cartridge."""
        left = self._mount_left.get(tape_id, 0)
        if left <= 0:
            return False
        self._mount_left[tape_id] = left - 1
        self.fired["mount"] += 1
        return True

    def media_fault(
        self, tape_id: str, legs: tuple[Leg, ...]
    ) -> tuple[int, tuple] | None:
        """Earliest failing read over this trajectory, if any (consumes it).

        Scans the replayed read legs against the cartridge's still-armed bad
        spans and returns ``(t_rel, span_key)`` for the earliest instant the
        head touches a faulty byte — ``t_rel`` is trajectory-relative exact
        virtual time, ``span_key`` identifies the span for per-span retry
        accounting.  ``None`` when no armed span is read.
        """
        best: tuple[int, tuple, int] | None = None
        for i, mf in enumerate(self._media):
            if mf.tape_id != tape_id or self._media_left[i] <= 0:
                continue
            for lg in legs:
                if lg.kind != "read":
                    continue
                lo = max(mf.lo, min(lg.p0, lg.p1))
                hi = min(mf.hi, max(lg.p0, lg.p1))
                if lo > hi:
                    continue
                t = lg.t0 + abs(lo - lg.p0)
                if best is None or t < best[0]:
                    best = (t, (tape_id, mf.lo, mf.hi), i)
                break  # legs are time-ordered: first hit is earliest for mf
        if best is None:
            return None
        t, key, i = best
        self._media_left[i] -= 1
        self.fired["media"] += 1
        return t, key

    def solver_fails(self, backend: str) -> bool:
        """Consume one pending transient solver fault for this backend."""
        left = self._solver_left.get(backend, 0)
        if left <= 0:
            return False
        self._solver_left[backend] = left - 1
        self.fired["solver"] += 1
        return True

    def solver_hook(self, backend: str) -> None:
        """``fault_hook`` for :func:`repro_torch.core.solver.solve_warm_degraded`."""
        if self.solver_fails(backend):
            raise TransientSolverError(backend)

    def remaining(self) -> dict[str, int]:
        """Planned faults not yet consumed (budget left), per class."""
        return {
            "drive": len(self.plan.drive_failures) - self.fired["drive"],
            "mount": sum(self._mount_left.values()),
            "media": sum(self._media_left),
            "solver": sum(self._solver_left.values()),
        }


def seeded_fault_plan(
    library,
    trace,
    seed: int,
    *,
    n_drives: int,
    drive_failures: int = 1,
    mount_faults: int = 1,
    media_faults: int = 1,
    solver_faults: int = 1,
    mount_count: int = 2,
    media_count: int = 1,
    solver_count: int = 1,
    backend: str = "python",
) -> FaultPlan:
    """Draw a deterministic :class:`FaultPlan` from a seed.

    Drive failures land at distinct drives, at times spread over the middle
    of the trace's arrival horizon (so they hit live traffic); mount and
    solver faults target seeded cartridges/the given backend; media faults
    cover each chosen cartridge's whole occupied span so the first read
    after arming is guaranteed to trip them.  ``drive_failures`` is clamped
    to ``n_drives``.
    """
    rng = np.random.default_rng(seed)
    horizon = max((r.time for r in trace), default=0)
    tapes = sorted(library.tapes, key=lambda t: t.tape_id)
    tape_ids = [t.tape_id for t in tapes]

    n_fail = min(drive_failures, n_drives)
    drives = [int(d) for d in rng.permutation(n_drives)[:n_fail]]
    lo_t, hi_t = horizon // 4, max(horizon // 4 + 1, (3 * horizon) // 4)
    fail_times = sorted(int(t) for t in rng.integers(lo_t, hi_t, size=n_fail))
    dfs = tuple(DriveFailure(at=t, drive=d) for t, d in zip(fail_times, drives))

    def pick_tapes(k: int) -> list:
        k = min(k, len(tapes))
        return [tapes[int(i)] for i in rng.permutation(len(tape_ids))[:k]]

    mfs = tuple(
        MountFault(t.tape_id, count=mount_count) for t in pick_tapes(mount_faults)
    )
    meds = tuple(
        MediaFault(t.tape_id, 0, t.used, count=media_count)
        for t in pick_tapes(media_faults)
        if t.used > 0
    )
    sfs = (
        (SolverFault(backend, count=solver_count * solver_faults),)
        if solver_faults > 0
        else ()
    )
    return FaultPlan(
        drive_failures=dfs,
        mount_faults=mfs,
        media_faults=meds,
        solver_faults=sfs,
    )


# ---------------------------------------------------------------------------
# write-ahead event journal
# ---------------------------------------------------------------------------
class EventJournal:
    """Append-only JSONL write-ahead log of serving events.

    One JSON object per line (``{"ev": "...", ...}``, JSON-primitive values
    only), flushed per append so a crash loses at most the line being
    written.  :meth:`load` tolerates a torn tail; :meth:`resume` truncates
    the file to its last intact line and returns the surviving prefix for
    :func:`recover_server`'s redo cross-check.  Unlike the solve-memo
    journal (which skips foreign lines and keeps going), replay stops at
    the first corrupt line: a WAL's suffix is untrustworthy past a tear.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._fh = open(self.path, "a", encoding="utf-8")

    def append(self, ev: dict) -> None:
        self._fh.write(json.dumps(ev, sort_keys=True) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def _scan(path: str | os.PathLike) -> tuple[list[dict], int]:
        """Valid event prefix + its byte length (tolerating a torn tail)."""
        with open(path, "rb") as fh:
            raw = fh.read()
        events: list[dict] = []
        pos = valid = 0
        while True:
            nl = raw.find(b"\n", pos)
            if nl < 0:
                break  # unterminated tail: a torn write, not an event
            line = raw[pos:nl]
            pos = nl + 1
            if not line.strip():
                valid = pos
                continue
            try:
                ev = json.loads(line)
                if not isinstance(ev, dict) or "ev" not in ev:
                    raise ValueError("not an event object")
            except (ValueError, UnicodeDecodeError, RecursionError):
                # corrupt interior line: the suffix is untrustworthy.  A
                # *newline-terminated* garbage line (half-flushed, then
                # padded by the crash) must truncate like a torn tail, not
                # raise — json.loads escalates pathological bytes (e.g. a
                # deeply nested "[[[[…" run) to RecursionError, not just
                # ValueError
                break
            events.append(ev)
            valid = pos
        return events, valid

    @classmethod
    def load(cls, path: str | os.PathLike) -> list[dict]:
        """The journal's valid event prefix (read-only, no truncation)."""
        return cls._scan(path)[0]

    @classmethod
    def resume(cls, path: str | os.PathLike) -> tuple["EventJournal", list[dict]]:
        """Truncate to the last intact line and reopen for appending.

        Returns ``(journal, prefix_events)``; the journal's write position
        is exactly after the last intact event, so a recovered run extends
        the same file into a complete log.
        """
        events, valid = cls._scan(path)
        with open(path, "r+b") as fh:
            fh.truncate(valid)
        return cls(path), events


def recover_server(
    library,
    trace,
    journal: "EventJournal | str | os.PathLike",
    admission: str = "accumulate",
    **kwargs,
):
    """Resume a crashed serving run from its write-ahead journal.

    Re-executes the run from the start against the *same* ``(library,
    trace, configuration)`` — the server is deterministic, so re-execution
    *is* recovery — while cross-checking every re-produced event against
    the journal's surviving prefix (divergence raises
    :class:`JournalReplayError`: the journal belongs to a different run).
    Past the prefix the run continues live and appends to the same journal
    file, so it ends complete.  Returns the final
    :class:`~repro_torch.serving.sim.ServiceReport`, bit-identical to the
    uninterrupted run's.  Configure the context with a persistent solve
    memo (:class:`~repro_torch.core.cache.JsonlCacheBackend`) to make the redo
    phase near-free.
    """
    from collections import deque

    from .queue import OnlineTapeServer  # local import: avoids a cycle

    path = journal.path if isinstance(journal, EventJournal) else os.fspath(journal)
    jr, expected = EventJournal.resume(path)
    server = OnlineTapeServer(library, admission, journal=jr, **kwargs)
    server._expect = deque(expected)
    report = server.run(trace)
    if server._expect:
        raise JournalReplayError(
            f"{len(server._expect)} journaled event(s) were never re-produced: "
            f"the journal does not belong to this (library, trace, config)"
        )
    return report
