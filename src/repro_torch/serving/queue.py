"""Online tape-serving subsystem: a shared drive pool + admission policies.

This is the robotic-arm layer of the ROADMAP's north star: read requests
arrive over (virtual) time against a :class:`~repro_torch.storage.tape.TapeLibrary`,
accumulate in per-cartridge queues (:class:`~repro_torch.storage.tape.PendingQueue`),
and an *admission policy* decides **when** a cartridge's queue becomes an LTSP
batch and **which cartridge a drive mounts next**.  Service runs on a
:class:`~repro_torch.serving.drives.DrivePool` — ``n_drives`` drives shared across
all cartridges with an explicit mount/unmount/seek-to-load-point cost model
(:class:`~repro_torch.serving.drives.DriveCosts`).  The one-drive-per-cartridge
server is the ``n_drives = len(tapes)``, zero-mount-cost special case of this
loop, bit-identically.

Solving dispatches through the solver engine under an
:class:`~repro_torch.core.ExecutionContext` (:func:`repro_torch.core.solve_warm` /
:func:`repro_torch.core.solve_batch_warm` — any registered policy × backend); the
pre-context ``backend=``/``cache=`` keywords survive as warning-emitting
deprecation shims.  The discrete-event simulator in :mod:`repro_torch.serving.sim`
advances virtual time and independently re-scores every emitted schedule, so
online-vs-offline regret, batching-vs-FIFO improvements, and
mount-contention penalties are exact integers, not anecdotes.

Warm-started re-solving and the cache backend
---------------------------------------------
Consecutive solves of one cartridge are usually *perturbations* of each
other — ``preempt`` re-plans the surviving multiset plus one newcomer, and
every ``accumulate``/``slack-accumulate`` tick re-plans whatever overlaps
the previous mix — so the server threads one
:class:`~repro_torch.core.warm.WarmState` per ``(cartridge, policy)`` through its
dispatches (``warm_start=True``, the default): each solve receives the
state captured by the cartridge's previous solve and returns a fresh one,
and only the DP cells invalidated by the multiset diff are re-evaluated.
Warm-starting is a pure accelerator — results are bit-identical with it on,
off, or with states evicted mid-run (differentially asserted in the tests
and the warm benchmark sweep) — and the exact evaluated/reused cell
counters land per batch in :class:`~repro_torch.serving.sim.BatchRecord` and
aggregate on :class:`~repro_torch.serving.sim.ServiceReport`.  With
``warm_start=False`` every solve runs cold but the counters still record,
so warm-vs-cold sweeps compare like for like.

Warm states live wherever the context's cache backend lives: any
:class:`~repro_torch.core.cache.CacheBackend` on the
:class:`~repro_torch.core.ExecutionContext` stores them next to its memoised full
solves (``get_warm``/``put_warm`` keyed ``("warm", tape_id, policy)``), so
servers sharing a cache share warm states; without a cache they live on the
server for the run.  A memoised *solve* hit short-circuits warm handling
entirely (zero DP work beats any warm start) and keeps the cartridge's
previous state for the next miss.  Warm states are advisory and in-memory
only — a persistent backend (:class:`~repro_torch.core.cache.JsonlCacheBackend`)
rewarms a restarted fleet through its journaled solves, then rebuilds warm
states on the first post-restart miss per cartridge.

Admission policies
------------------
Cartridge-cadence policies (when does a queue dispatch):

``fifo`` / ``fifo-global``
    Per-request solving in global arrival order: whenever a drive is
    available, the oldest pending request whose cartridge can be mounted is
    served alone.  Every request pays a full seek from the load point — the
    baseline any batching policy must beat.  (``fifo`` is the legacy
    name; on a pool both spell the same rule.)
``accumulate`` / ``per-drive-accumulate``
    Accumulate-then-solve with a re-plan window: a cartridge becomes
    *mount-ready* once its oldest pending request has waited ``window`` time
    units; a free drive mounts the mount-ready cartridge with the oldest
    head-of-queue request and serves its whole queue as one batch.
    ``window=0`` degenerates to greedy batching.
``preempt``
    Greedy batching plus preemptive re-solve on arrival: a request arriving
    for a cartridge that is mid-batch aborts the in-flight plan at that
    instant — requests already served keep their completion times, the head
    rewinds from wherever it is, and the survivors plus the newcomer are
    re-solved as one batch.  Wins when late arrivals would otherwise wait
    out a long plan; loses the rewind penalty when arrivals are dense.
``batched``
    Cross-cartridge device batching: in one event tick, *all* mount-ready
    cartridges (up to the number of assignable drives) are gathered and
    planned through a **single** :func:`repro_torch.core.solve_batch` call — on a
    device backend that is one bucketed wavefront launch for the whole tick
    instead of one launch per cartridge.  Scheduling results are identical
    to ``per-drive-accumulate``; only the solve batching differs.

Deadline-aware (QoS) admissions — these read the ``qos`` mapping
(``req_id`` -> :class:`~repro_torch.serving.qos.QoSSpec`) attached at construction;
requests without a spec/deadline are best-effort and sort last:

``edf-global``
    Earliest-deadline-first per-request serving: the next mount is chosen by
    the most urgent *queued* request across all pending queues (live
    deadline, then arrival, then id), and that single request is served —
    the deadline-aware counterpart of ``fifo-global`` (same batching
    discipline, different order).  Expired deadlines demote to best-effort:
    a request already past its deadline is missed regardless, so it must
    not starve still-meetable ones (the EDF overload domino).
``slack-accumulate``
    ``per-drive-accumulate`` whose hold window collapses as slack burns
    down: a cartridge becomes mount-ready at ``min(head arrival + window,
    earliest live queued deadline - window)``, i.e. the moment any queued
    request's slack drops below the hold window itself the whole queue
    dispatches — early enough that the deadline is still reachable.
    Mount-ready cartridges are served most-urgent-first.

Every dispatched schedule is checked by :func:`repro_torch.core.verify.verify_schedule`
(structural validity + the simulator's independent cost recomputation must
equal the solver-reported cost exactly) unless ``verify=False``.  Mount legs
are charged ahead of each batch's trajectory: completions shift by the
drive's mount delay and the pool's mount/unmount accounting lands in the
:class:`~repro_torch.serving.sim.ServiceReport`.

Load-adaptive dispatch and overload control (opt-in)
----------------------------------------------------
Under heavy traffic the exact DP's own runtime is a service-time component:
``selector=`` names a registered :class:`~repro_torch.core.solver.SolverSelector`
(``"fixed"`` / ``"depth-threshold"`` / ``"cost-model"``, see
:mod:`repro_torch.core.solver`) that the server consults at every dispatch tick
with the tick's load (total queued requests, batch size, the run's recorded
per-policy solve timings) and the context's
:class:`~repro_torch.core.context.ComputeBudget` — picking the exact DP while
queues are shallow and restricted DP / heuristics as depth grows.  The
server applies ``budget.hysteresis`` per cartridge (a differing choice must
repeat that many consecutive ticks before it takes effect) so the policy
doesn't flap, and keys warm states per ``(cartridge, policy)`` so switching
never seeds one policy's DP table from another's.  When the budget prices
compute (``solve_time_num/solve_time_den``), every dispatch charges its
solve's evaluated DP cells into the timeline as extra pre-trajectory delay
— the per-batch ``policy_used``/``solve_delay`` land in
:class:`~repro_torch.serving.sim.BatchRecord` and the mix in
:meth:`~repro_torch.serving.sim.ServiceReport.summary`.  Two further overload
controls ride the QoS layer: ``preempt_urgent=True`` lets an urgent arrival
abort a *different* cartridge's all-lax in-flight batch (plain ``preempt``
only ever aborts the arriving cartridge's own batch), and
``class_weights=`` adds per-class virtual time to deadlines as the
scheduler sees them — spending ``batch``-class slack to protect
``interactive`` — while SLO reporting keeps judging the true deadlines.
With ``selector``/``preempt_urgent``/``class_weights`` unset, every
timeline is bit-identical to the pre-adaptive server.

Fault tolerance and crash recovery (opt-in)
-------------------------------------------
``faults=`` takes a deterministic :class:`~repro_torch.serving.faults.FaultPlan`
(drive hard-failures, transient mount failures, bad media spans, transient
solver faults) and ``retry=`` a :class:`~repro_torch.serving.drives.RetryPolicy`
(attempt budgets, exponential backoff charged in exact virtual time,
failover vs. fail-stop, typed-error vs. typed-drop exhaustion).  A failed
drive leaves the pool for good: its in-flight batch aborts through the
``preempt`` machinery (completions at or before the failure stand, the
survivors requeue marked ``faulted``) and its cartridge remounts on a
surviving drive at full remount cost.  Media faults abort at the exact
instant the head touches the bad span; mount faults charge backoff before
the retry; solver faults degrade through
:func:`repro_torch.core.solver.solve_warm_degraded` (``cuda →
torch → python``, bit-identical, warm states invalidated on
fallback).  All counts land in :class:`~repro_torch.serving.sim.BatchRecord` /
:class:`~repro_torch.serving.sim.ServiceReport`.  ``journal=`` appends every
observable event to a :class:`~repro_torch.serving.faults.EventJournal`
write-ahead log; :func:`repro_torch.serving.faults.recover_server` resumes a
killed run from it, bit-identical.  With all three unset, every code path
and report is bit-identical to the fault-unaware server.

Observability (opt-in)
----------------------
An :class:`~repro_torch.obs.Observability` bundle on the context
(``context.replace(obs=Observability.enabled())``) makes the server record
*where virtual time goes*: mount / solve-delay / batch spans per drive
lane, arrival / preempt / fault instants, and exact-int counters and
histograms (queue depth, sojourns, deadline outcomes, retry backoff, DP
cell work) into the bundle's tracer and metrics registry — exported by
:mod:`repro_torch.obs.export` as JSONL, Prometheus text, and Chrome trace JSON.
Every hook records integers the loop already computed, after the journal
write, so with ``obs`` unset (the default) timelines, reports, and
journals are bit-identical to the uninstrumented server.
"""

from __future__ import annotations

import dataclasses
import heapq
import os
from collections import deque
from typing import Mapping

from ..core.context import DEFAULT_BUDGET, ExecutionContext, resolve_context
from ..core.solver import (
    LoadView,
    SolveCache,
    SolverSelector,
    SolverUnavailableError,
    get_selector,
    solve_batch_warm,
    solve_batch_warm_degraded,
    solve_warm,
    solve_warm_degraded,
)
from ..core.verify import verify_schedule
from ..storage.tape import PendingQueue, TapeLibrary
from .drives import (
    DriveCosts,
    DrivePool,
    GreedyScheduler,
    MountScheduler,
    MountView,
    NoDriveAvailableError,
    PoolDrive,
    RetryPolicy,
)
from .faults import (
    EventJournal,
    FaultInjector,
    FaultPlan,
    JournalReplayError,
    MediaReadError,
    MountFailedError,
)
from .qos import QoSSpec
from .sim import (
    BatchRecord,
    FailedRequest,
    Replay,
    Request,
    ServedRequest,
    ServiceReport,
    head_position,
    replay_schedule,
    rewind_time,
)

__all__ = [
    "ADMISSIONS",
    "LEGACY_ADMISSIONS",
    "POOL_ADMISSIONS",
    "QOS_ADMISSIONS",
    "WINDOWED_ADMISSIONS",
    "OnlineTapeServer",
    "serve_trace",
]

#: legacy names from the one-drive-per-cartridge era (still fully supported).
LEGACY_ADMISSIONS = ("fifo", "accumulate", "preempt")
#: pool-era names (cross-cartridge; ``batched`` adds one-launch-per-tick).
POOL_ADMISSIONS = ("fifo-global", "per-drive-accumulate", "batched")
#: deadline-aware admissions (read the ``qos`` map; see module docstring).
QOS_ADMISSIONS = ("edf-global", "slack-accumulate")
ADMISSIONS = LEGACY_ADMISSIONS + POOL_ADMISSIONS + QOS_ADMISSIONS

#: admissions whose dispatch is gated on the accumulate ``window`` (callers
#: sweeping admissions use this to decide which ones take a window argument).
WINDOWED_ADMISSIONS = (
    "accumulate",
    "per-drive-accumulate",
    "batched",
    "slack-accumulate",
)

#: admissions that dispatch one request at a time (global arrival order, or
#: global deadline order for ``edf-global``).
_ONE_SHOT = {"fifo", "fifo-global", "edf-global"}
_WINDOWED = set(WINDOWED_ADMISSIONS)
_DEADLINE = set(QOS_ADMISSIONS)


class OnlineTapeServer:
    """Event-driven online serving of an arrival trace against a library.

    One instance simulates one run: virtual time advances over arrival,
    window-expiry, and drive-free events; all arithmetic is exact integers,
    so two runs with the same trace and configuration are bit-identical.

    ``n_drives`` defaults to one drive per cartridge and ``drive_costs`` to
    the all-zero model — exactly the one-drive-per-cartridge server.  Shrink the pool and/or
    price the mount legs to simulate a real robotic library.

    QoS is opt-in: ``qos`` attaches a :class:`~repro_torch.serving.qos.QoSSpec`
    (deadline + priority class) per request id at enqueue time, enabling
    the deadline-aware admissions and the SLO statistics
    (:func:`repro_torch.serving.qos.slo_report`); ``mount_scheduler`` selects the
    :class:`~repro_torch.serving.drives.MountScheduler` eviction policy.  With
    both left at their defaults every admission reproduces the QoS-less
    behaviour bit for bit.
    """

    def __init__(
        self,
        library: TapeLibrary,
        admission: str = "accumulate",
        *,
        window: int = 0,
        policy: str = "dp",
        n_drives: int | None = None,
        drive_costs: DriveCosts | None = None,
        qos: Mapping[int, QoSSpec] | None = None,
        mount_scheduler: str | MountScheduler = "greedy",
        context: ExecutionContext | None = None,
        backend: str | None = None,
        cache: SolveCache | None = None,
        verify: bool = True,
        warm_start: bool = True,
        faults: FaultPlan | None = None,
        retry: RetryPolicy | None = None,
        journal: EventJournal | str | os.PathLike | None = None,
        selector: str | SolverSelector | None = None,
        preempt_urgent: bool = False,
        class_weights: Mapping[str, int] | None = None,
    ):
        if admission not in ADMISSIONS:
            raise ValueError(
                f"unknown admission policy {admission!r}; choose from {ADMISSIONS}"
            )
        if window < 0:
            raise ValueError("window must be >= 0")
        if n_drives is not None and n_drives < 1:
            raise ValueError("n_drives must be >= 1")
        if preempt_urgent and admission not in _DEADLINE:
            raise ValueError(
                "preempt_urgent needs a deadline-aware admission "
                f"(one of {QOS_ADMISSIONS}); got {admission!r}"
            )
        if class_weights:
            for cls, w in class_weights.items():
                if not isinstance(w, int) or w < 0:
                    raise ValueError(
                        f"class weight for {cls!r} must be a non-negative "
                        f"int of virtual time, got {w!r}"
                    )
        self.lib = library
        self.admission = admission
        self.window = int(window)
        self.policy = policy
        self.context = resolve_context(context, backend=backend, cache=cache)
        self.n_drives = n_drives
        self.drive_costs = drive_costs if drive_costs is not None else DriveCosts()
        self.qos: dict[int, QoSSpec] = dict(qos) if qos else {}
        self.mount_scheduler = mount_scheduler
        self.verify = verify
        self.warm_start = warm_start
        self.faults = faults if faults else None  # empty plan == no plan
        self._retry_given = retry is not None
        self.retry = retry if retry is not None else RetryPolicy()
        if isinstance(journal, EventJournal) or journal is None:
            self._journal = journal
        else:
            self._journal = EventJournal(journal)
        # adaptive dispatch (all opt-in; None/False reproduces the fixed-policy server bit-exact)
        self.selector: SolverSelector | None = (
            get_selector(selector) if selector is not None else None
        )
        self.selector_name = self.selector.name if self.selector else None
        self.budget = (
            self.context.budget if self.context.budget is not None else DEFAULT_BUDGET
        )
        self.preempt_urgent = bool(preempt_urgent)
        self.class_weights: dict[str, int] | None = (
            dict(class_weights) if class_weights else None
        )
        # journal-replay cross-check prefix; recover_server fills it
        self._expect: deque = deque()
        # per-(cartridge, policy) WarmState store for runs without a cache
        # backend; with one, states live on the backend (get_warm/put_warm)
        self._warm_local: dict[tuple, object] = {}
        # observability (opt-in, see repro_torch.obs): every hook below is guarded
        # by ``obs is not None`` and records already-computed exact integers,
        # so an unset obs reproduces the uninstrumented run bit for bit
        self.obs = self.context.obs
        self._obs_shard = 0  # the fleet layer stamps each shard's index here

    # -- event plumbing ------------------------------------------------------
    def _push(self, when: int, kind: str, data) -> None:
        self._seq += 1
        heapq.heappush(self._events, (when, self._seq, kind, data))

    # -- warm-state plumbing (see the module docstring) ----------------------
    def _warm_key(self, tape_id: str, policy: str | None = None) -> tuple:
        # keys carry the *solving* policy: with a selector switching policies
        # per tick, each (cartridge, policy) pair keeps its own warm lineage —
        # a warm state from one policy's DP table must never seed another's
        return ("warm", tape_id, policy if policy is not None else self.policy)

    def _get_warm(self, tape_id: str, policy: str | None = None):
        if not self.warm_start:
            return None
        cache = self.context.cache
        if cache is not None and hasattr(cache, "get_warm"):
            return cache.get_warm(self._warm_key(tape_id, policy))
        return self._warm_local.get(self._warm_key(tape_id, policy))

    def _put_warm(self, tape_id: str, state, policy: str | None = None) -> None:
        if not self.warm_start or state is None:
            return
        cache = self.context.cache
        if cache is not None and hasattr(cache, "put_warm"):
            cache.put_warm(self._warm_key(tape_id, policy), state)
        else:
            self._warm_local[self._warm_key(tape_id, policy)] = state

    def _drop_warm(self, tape_id: str, policy: str | None = None) -> None:
        """Invalidate a cartridge's warm state (degradation-chain fallback)."""
        cache = self.context.cache
        if cache is not None and hasattr(cache, "put_warm"):
            cache.put_warm(self._warm_key(tape_id, policy), None)
        else:
            self._warm_local.pop(self._warm_key(tape_id, policy), None)

    # -- adaptive dispatch (see repro_torch.core.solver.SolverSelector) ------------
    def _select_policy(self, key: str, depth: int, n_requests: int, now: int) -> str:
        """The tick's solving policy for ``key`` (a cartridge, or ``"*"``).

        Consults the selector with a :class:`LoadView` and applies
        ``budget.hysteresis``: a differing choice must repeat for that many
        consecutive ticks before it replaces the active policy, so a queue
        depth oscillating around a threshold cannot flap the policy (and
        thrash warm states) every tick.
        """
        want = self.selector.select(
            LoadView(
                depth=depth, n_requests=n_requests, now=now,
                timings=self._sel_timings,
            ),
            self.budget,
        )
        if want is None:
            want = self.policy
        active = self._sel_active.get(key, self.policy)
        if want == active:
            self._sel_pending.pop(key, None)
            return active
        pol, streak = self._sel_pending.get(key, (want, 0))
        streak = streak + 1 if pol == want else 1
        if streak >= self.budget.hysteresis:
            self._sel_pending.pop(key, None)
            self._sel_active[key] = want
            return want
        self._sel_pending[key] = (want, streak)
        return active

    def _note_timing(self, policy: str, n_requests: int, stats) -> None:
        """Feed one real solve's cell count into the cost model's history.

        Cache hits are skipped: they report ``cells_evaluated == 0`` for
        work the cache did earlier, which would teach the cost model that
        solves are free.
        """
        if stats.mode == "cache":
            return
        cells, cubes = self._sel_timings.get(policy, (0, 0))
        self._sel_timings[policy] = (
            cells + stats.cells_evaluated,
            cubes + max(1, n_requests) ** 3,
        )

    # -- write-ahead journal (see repro_torch.serving.faults) ----------------------
    def _log(self, **ev) -> None:
        """Journal one event — or, while recovering, cross-check it.

        Values must be JSON primitives (ints/strs/lists) so a journaled
        event round-trips to an equal dict.  While the recovery prefix
        (``self._expect``) lasts, re-produced events are verified against
        it instead of re-written; any divergence means the journal belongs
        to a different run and raises :class:`JournalReplayError`.
        """
        if self._journal is None:
            return
        if self._expect:
            want = self._expect.popleft()
            if want != ev:
                raise JournalReplayError(
                    f"journal replay diverged: journaled {want!r}, "
                    f"re-execution produced {ev!r}"
                )
            return
        self._journal.append(ev)

    # -- fault handling (see repro_torch.serving.faults) ---------------------------
    def _record_served(self, drive: PoolDrive, pairs) -> None:
        for req, completed in pairs:
            self._served.append(
                ServedRequest(
                    req_id=req.req_id,
                    name=req.name,
                    tape_id=req.tape_id,
                    arrival=req.time,
                    dispatched=drive.dispatched,
                    completed=completed,
                    faulted=req.req_id in self._faulted,
                )
            )
            if self.obs is not None:
                self.obs.inc("requests_served_total")
                self.obs.observe("sojourn", completed - req.time)
                spec = self.qos.get(req.req_id)
                if spec is not None and spec.deadline is not None:
                    self.obs.inc("deadlines_total")
                    if completed > spec.deadline:
                        self.obs.inc("deadline_misses_total")

    def _fail_requests(self, reqs: list[Request], reason: str, now: int) -> None:
        for req in reqs:
            self._failed.append(
                FailedRequest(
                    req_id=req.req_id,
                    name=req.name,
                    tape_id=req.tape_id,
                    arrival=req.time,
                    failed_at=now,
                    reason=reason,
                )
            )
        if self.obs is not None and reqs:
            self.obs.inc("requests_failed_total", len(reqs), reason=reason)
            self.obs.event(
                "drop", now, track="queue", shard=self._obs_shard,
                reason=reason, n=len(reqs),
            )

    def _requeue(self, pending: list[Request], reason: str, now: int) -> list[int]:
        """Re-enqueue aborted in-flight requests (failover) or drop them.

        Requeued requests keep their original arrival times, so they sort
        back to the head of their queue deterministically — same rule as an
        admission preemption.
        """
        if not pending:
            return []
        if self.retry.failover:
            for req in pending:
                self.lib.enqueue(req.name, req)
                self._faulted.add(req.req_id)
            self._n_requeued += len(pending)
        else:
            self._fail_requests(pending, reason, now)
        return [r.req_id for r in pending]

    def _fail_drive(self, drive: PoolDrive, now: int) -> None:
        """Hard drive failure: abort in-flight work, remove from the pool.

        Completions at or before the failure stand (those bytes were read);
        the survivors requeue (failover) or drop (fail-stop).  The head
        state dies with the drive — no rewind to charge — and the pool
        extracts the cartridge so it can remount elsewhere at full remount
        cost.  If fault-injection ever targets an already-failed drive the
        event is a no-op.
        """
        if drive.failed:
            return
        if self._injector is not None:
            self._injector.drive_failed()
        requeued: list[int] = []
        if drive.busy and drive.inflight:
            done = [(r, c) for r, c in drive.inflight if c <= now]
            pending = [r for r, c in drive.inflight if c > now]
            self._record_served(drive, done)
            aborted = self._batches[drive.batch_idx]
            self._batches[drive.batch_idx] = dataclasses.replace(
                aborted, aborted_by="drive-failure", n_completed=len(done)
            )
            requeued = self._requeue(pending, "drive-failure", now)
        drive.epoch += 1  # invalidate any scheduled free/media-abort event
        drive.inflight = []
        drive.legs = ()
        self.pool.fail_drive(drive)
        self._log(ev="drive-fail", t=now, drive=drive.drive_id, requeued=requeued)
        if self.obs is not None:
            self.obs.event(
                "drive-fail", now, track=f"drive{drive.drive_id}",
                shard=self._obs_shard, requeued=len(requeued),
            )

    def _media_abort(self, drive: PoolDrive, now: int, span: tuple) -> None:
        """A read pass hit a bad media span: abort at the touch instant.

        Works like a preemption — completions before the fault stand, the
        head rewinds from its exact trajectory position — plus the retry
        policy's backoff charged before the drive frees.  Survivors requeue
        for a retry read until the span's attempt budget is exhausted, then
        the typed error/drop path applies.
        """
        self._n_media_aborts += 1
        done = [(r, c) for r, c in drive.inflight if c <= now]
        pending = [r for r, c in drive.inflight if c > now]
        self._record_served(drive, done)
        attempts = self._media_attempts.get(span, 0)
        requeued: list[int] = []
        if attempts >= self.retry.attempts("media"):
            if self.retry.on_exhausted == "error":
                raise MediaReadError(span, attempts)
            self._fail_requests(pending, "media-error", now)
        else:
            requeued = self._requeue(pending, "media-error", now)
        aborted = self._batches[drive.batch_idx]
        self._batches[drive.batch_idx] = dataclasses.replace(
            aborted, aborted_by="media-error", n_completed=len(done)
        )
        backoff = self.retry.backoff(max(1, attempts))
        self._retry_delay += backoff
        pos = head_position(drive.legs, now - drive.service_start)
        free_at = now + rewind_time(drive.load_point, drive.u_turn, pos) + backoff
        drive.epoch += 1
        drive.inflight = []
        drive.legs = ()
        drive.service_end = now
        drive.busy_until = free_at
        drive.busy = True
        self._log(
            ev="abort", t=now, drive=drive.drive_id, reason="media-error",
            requeued=requeued,
        )
        if self.obs is not None:
            self.obs.inc("media_aborts_total")
            self.obs.event(
                "media-abort", now, track=f"drive{drive.drive_id}",
                shard=self._obs_shard,
            )
        self._push(drive.busy_until, "free", (drive.drive_id, drive.epoch))

    def _acquire(
        self, tid: str, now: int, view: MountView | None
    ) -> tuple[PoolDrive, int, int] | None:
        """:meth:`DrivePool.acquire` plus transient-mount retry handling.

        Returns ``(drive, delay, retries)`` with the retry backoff folded
        into the mount delay (exact virtual time), or ``None`` when the
        mount budget is exhausted under the drop policy (the cartridge's
        queued requests have been recorded as failed).
        """
        retries = 0
        extra = 0
        if self._injector is not None and self.pool.drive_of(tid) is None:
            while self._injector.mount_fails(tid):
                retries += 1
                self._n_mount_retries += 1
                if retries >= self.retry.attempts("mount"):
                    if self.retry.on_exhausted == "error":
                        raise MountFailedError(tid, retries)
                    reqs = self.lib.pending(tid).drain()
                    self._fail_requests(reqs, "mount-failed", now)
                    self._log(
                        ev="mount-failed", t=now, tape=tid,
                        dropped=[r.req_id for r in reqs],
                    )
                    return None
                extra += self.retry.backoff(retries)
                self._retry_delay += self.retry.backoff(retries)
                if self.obs is not None:
                    self.obs.inc("mount_retries_total")
                    self.obs.inc(
                        "retry_backoff_total", self.retry.backoff(retries)
                    )
        drive, delay = self.pool.acquire(tid, now=now, view=view)
        return drive, delay + extra, retries

    def run(self, trace: list[Request]) -> ServiceReport:
        """Serve a full arrival trace; returns the per-request report."""
        self._begin(trace)
        while self._events:
            self._step()
        return self._finish()

    # -- stepping primitives (the fleet layer drives these) ----
    # ``run`` is begin -> step-until-drained -> finish, so a federation can
    # interleave several servers in one shared virtual clock by always
    # stepping the server whose next event is globally earliest.  A shard
    # driven this way receives its arrivals one at a time (_on_arrival)
    # instead of pre-seeded, and stays an unmodified OnlineTapeServer.
    def _begin(self, trace: list[Request]) -> None:
        """Initialise run state and seed the event heap (no events popped)."""
        self._events: list = []
        self._seq = 0
        n = self.n_drives if self.n_drives is not None else max(1, len(self.lib.tapes))
        self.pool = DrivePool(
            n, self.drive_costs, scheduler=self.mount_scheduler, retry=self.retry
        )
        if self.obs is not None:
            self.pool.obs = self.obs
            cache = self.context.cache
            if cache is not None and hasattr(cache, "obs"):
                cache.obs = self.obs
        self._served: list[ServedRequest] = []
        self._batches: list[BatchRecord] = []
        self._next_wake: dict[str, int] = {}  # tape_id -> pending window timer
        self._n_preempt = 0
        self._injector = FaultInjector(self.faults) if self.faults else None
        self._failed: list[FailedRequest] = []
        self._faulted: set[int] = set()  # req_ids touched by a fault
        self._media_attempts: dict[tuple, int] = {}  # span -> read attempts
        self._n_mount_retries = 0
        self._n_media_aborts = 0
        self._n_solver_faults = 0
        self._n_fallbacks = 0
        self._n_requeued = 0
        self._retry_delay = 0  # total backoff charged, exact virtual time
        # adaptive-dispatch state: per-policy (cells, n^3) solve history for
        # the cost model, and per-cartridge active/pending-switch hysteresis
        self._sel_timings: dict[str, tuple[int, int]] = {}
        self._sel_active: dict[str, str] = {}
        self._sel_pending: dict[str, tuple[str, int]] = {}
        self._horizon = 0

        for req in sorted(trace):
            self._push(req.time, "arrival", req)
        if self._injector is not None:
            for f in self._injector.drive_failures():
                if f.drive >= n:
                    raise ValueError(
                        f"fault plan fails drive {f.drive} but the pool has "
                        f"only {n} drive(s)"
                    )
                self._push(f.at, "drive-fail", f.drive)
        self._log(
            ev="start", admission=self.admission, policy=self.policy,
            window=self.window, n_trace=len(trace),
        )

    def _next_time(self) -> int | None:
        """Virtual time of the next queued event (None: heap drained)."""
        return self._events[0][0] if self._events else None

    def _on_arrival(self, req: Request, now: int) -> None:
        """Admit one arriving request at ``now`` (the arrival event body)."""
        self._horizon = max(self._horizon, now)
        tape_id = self.lib.enqueue(req.name, req)
        self._log(ev="enqueue", t=now, req=req.req_id, tape=tape_id)
        if self.obs is not None:
            self.obs.event(
                "arrival", now, track="queue", shard=self._obs_shard,
                req=req.req_id, tape=tape_id,
            )
            self.obs.inc("requests_arrived_total")
            self.obs.observe(
                "queue_depth", sum(len(q) for q in self.lib.queues.values())
            )
        if self.admission == "preempt":
            drive = self.pool.drive_of(tape_id)
            if drive is not None and drive.busy and now < drive.service_end:
                self._preempt(drive, now)
        if self.preempt_urgent:
            self._maybe_preempt_urgent(req, tape_id, now)
        self._schedule(now)

    def _step(self) -> None:
        """Pop and process exactly one event from the heap."""
        now, _, kind, data = heapq.heappop(self._events)
        self._horizon = max(self._horizon, now)
        if kind == "arrival":
            self._on_arrival(data, now)
        elif kind == "free":
            drive_id, epoch = data
            drive = self.pool.drives[drive_id]
            if epoch != drive.epoch or not drive.busy:
                return  # superseded by a preemption
            self._complete(drive)
            self._schedule(now)
        elif kind == "wake":
            tape_id, when = data
            if self._next_wake.get(tape_id) != when:
                return  # superseded timer
            del self._next_wake[tape_id]
            self._schedule(now)
        elif kind == "drive-fail":
            self._fail_drive(self.pool.drives[data], now)
            self._schedule(now)
        elif kind == "media-abort":
            drive_id, epoch, span = data
            drive = self.pool.drives[drive_id]
            if epoch != drive.epoch or not drive.busy or drive.failed:
                return  # batch already gone (preempted / drive died)
            self._media_abort(drive, now, span)
            self._schedule(now)

    def _finish(self) -> ServiceReport:
        """Drain unservable leftovers and assemble the final report."""
        horizon = self._horizon
        self._drain_unservable(horizon)
        horizon = max([horizon] + [d.busy_until for d in self.pool.alive])
        fault_stats = None
        if self._injector is not None or self._retry_given:
            fault_stats = {
                "drive_failures": self.pool.n_drive_failures,
                "mount_retries": self._n_mount_retries,
                "media_aborts": self._n_media_aborts,
                "solver_faults": self._n_solver_faults,
                "fallbacks": self._n_fallbacks,
                "requeued": self._n_requeued,
                "retry_delay": self._retry_delay,
            }
        report = ServiceReport(
            admission=self.admission,
            policy=self.policy,
            backend=self.context.backend,
            window=self.window,
            served=sorted(self._served, key=lambda r: (r.completed, r.req_id)),
            batches=self._batches,
            n_preemptions=self._n_preempt,
            horizon=horizon,
            cache_stats=(
                self.context.cache.stats() if self.context.cache is not None else None
            ),
            pool_stats=self.pool.stats(),
            scheduler=self.pool.scheduler.name,
            qos=self.qos or None,
            warm_start=self.warm_start,
            failed=self._failed,
            fault_stats=fault_stats,
            selector=self.selector_name,
        )
        self._log(
            ev="end", horizon=horizon, n_served=report.n_served,
            n_failed=report.n_failed, total_sojourn=report.total_sojourn,
        )
        return report

    def _drain_unservable(self, now: int) -> None:
        """End-of-loop backstop: requests still queued with no drive left.

        The event loop only ends with non-empty queues when every drive has
        hard-failed (nothing can ever free or dispatch again).  Typed raise
        with the requests left queued under ``on_exhausted="error"``;
        typed :class:`~repro_torch.serving.sim.FailedRequest` drops otherwise.
        """
        leftover = sorted(
            (r for q in self.lib.queues.values() for r in q),
            key=lambda r: (r.time, r.req_id),
        )
        if not leftover:
            return
        assert not self.pool.alive, "queued requests with live drives at exit"
        if self.retry.on_exhausted == "error":
            raise NoDriveAvailableError(len(leftover))
        for tid in sorted(self.lib.queues):
            self.lib.queues[tid].drain()
        self._fail_requests(leftover, "no-drive", now)

    # -- admission -----------------------------------------------------------
    def _deadline_of(self, req: Request) -> int | None:
        """The request's deadline *as the scheduler sees it*.

        With ``class_weights`` set, a class's weight (virtual time) is added
        to its members' deadlines for every scheduling decision — a
        ``batch``-class request with weight ``w`` yields as if its deadline
        were ``w`` later, spending its slack to protect lighter classes
        (``interactive`` at weight 0 keeps its true urgency).  SLO reporting
        (:func:`repro_torch.serving.qos.slo_report`) reads the unweighted specs, so
        misses are always judged against the real deadlines.
        """
        spec = self.qos.get(req.req_id)
        if spec is None or spec.deadline is None:
            return None
        if self.class_weights:
            return spec.deadline + self.class_weights.get(spec.qos_class, 0)
        return spec.deadline

    def _queue_deadline(
        self, queue: PendingQueue, now: int | None = None
    ) -> int | None:
        """Earliest deadline among a cartridge's queued requests, if any.

        With ``now`` given, only *live* deadlines (not yet expired) count —
        an expired deadline is missed no matter what happens next, so it
        must not keep reading as maximally urgent.
        """
        deadlines = [
            d
            for d in (self._deadline_of(r) for r in queue)
            if d is not None and (now is None or d > now)
        ]
        return min(deadlines) if deadlines else None

    def _candidates(self, now: int) -> list[str]:
        """Dispatch-ready cartridges, oldest head-of-queue request first.

        Window-gated admissions also (re)arm a wake timer per not-yet-ready
        cartridge; timers deduplicate on the ready instant, and a stale timer
        is discarded on pop when its instant no longer matches.
        """
        if self.admission in _DEADLINE:
            return self._qos_candidates(now)
        ready: list[tuple[int, int, str]] = []
        for tid in sorted(self.lib.queues):
            queue = self.lib.queues[tid]
            if len(queue) == 0:
                continue
            head = queue.peek()
            if self.admission in _WINDOWED:
                at = head.time + self.window
                if now < at:
                    if self._next_wake.get(tid) != at:
                        self._next_wake[tid] = at
                        self._push(at, "wake", (tid, at))
                    continue
            ready.append((head.time, head.req_id, tid))
        ready.sort()
        return [tid for _, _, tid in ready]

    def _qos_candidates(self, now: int) -> list[str]:
        """Dispatch-ready cartridges for the deadline-aware admissions.

        Readiness: ``edf-global`` is always ready (per-request, like
        ``fifo-global``); ``slack-accumulate`` holds a queue until
        ``min(head arrival + window, earliest live deadline - window)`` —
        the accumulate hold collapses once any queued request's slack burns
        below the hold window itself, so the batch dispatches while the
        deadline is still reachable (a new arrival with a nearer deadline
        re-arms the wake timer earlier; the stale timer is discarded on
        pop).  Ready cartridges are ordered most-urgent-first: earliest
        live queued deadline, then head arrival/id; queues with no live
        deadline sort last.
        """
        ready: list[tuple[int, int, int, int, str]] = []
        for tid in sorted(self.lib.queues):
            queue = self.lib.queues[tid]
            if len(queue) == 0:
                continue
            head = queue.peek()
            dmin = self._queue_deadline(queue, now)
            if self.admission == "slack-accumulate":
                at = head.time + self.window
                if dmin is not None:
                    at = min(at, dmin - self.window)
                if now < at:
                    if self._next_wake.get(tid) != at:
                        self._next_wake[tid] = at
                        self._push(at, "wake", (tid, at))
                    continue
            urgency = (1, 0) if dmin is None else (0, dmin)
            ready.append((*urgency, head.time, head.req_id, tid))
        ready.sort()
        return [t[-1] for t in ready]

    def _pop_urgent(self, queue: PendingQueue, now: int) -> Request:
        """Remove the most urgent queued request (EDF, arrival/id tie-break).

        Expired deadlines are demoted to best-effort: a request already past
        its deadline is missed no matter when it is served, so letting it
        keep outranking still-meetable requests would cascade misses (the
        classic EDF overload domino).
        """
        items = queue.drain()
        pick = min(items, key=lambda r: self._edf_key(r, now))
        for r in items:
            if r is not pick:
                queue.push(r)
        return pick

    def _edf_key(self, req: Request, now: int) -> tuple[int, int, int, int]:
        """Total EDF order — ties are deterministic by construction.

        Live deadlines sort first by deadline; two requests sharing a
        deadline order by ``(arrival, req_id)``.  Best-effort requests and
        expired-demoted ones share a single trailing bucket ``(1, 0, ...)``
        — demotion deliberately erases the stale deadline so an
        expired-deadline request ties a live best-effort one and the same
        ``(arrival, req_id)`` rule breaks it (an expired deadline is missed
        no matter what; letting it keep outranking meetable work would
        cascade misses).  ``req_id`` is unique per trace, so the key is a
        total order and `min` is seed-stable.
        """
        d = self._deadline_of(req)
        if d is None or d <= now:  # best-effort, or already missed
            return (1, 0, req.time, req.req_id)
        return (0, d, req.time, req.req_id)

    def _mount_view(self, now: int) -> MountView | None:
        """Queue-state snapshot for the pool's mount scheduler.

        ``None`` under the default greedy scheduler, which ignores the view
        — the per-event depth/urgency scan is only paid when a scheduler
        actually decides on it (``acquire`` substitutes a bare view).
        """
        if isinstance(self.pool.scheduler, GreedyScheduler):
            return None
        pending = {
            tid: q for tid, q in self.lib.queues.items() if len(q) > 0
        }
        return MountView(
            now=now,
            costs=self.drive_costs,
            depth={tid: len(q) for tid, q in pending.items()},
            urgency=(
                {tid: self._queue_deadline(q, now) for tid, q in pending.items()}
                if self.qos
                else {}
            ),
        )

    def _schedule(self, now: int) -> None:
        """Dispatch every cartridge the admission policy admits at ``now``."""
        cands = self._candidates(now)
        if not cands:
            return
        view = self._mount_view(now)
        # the tick's load (total queued requests) is snapshotted before any
        # queue drains, so every selection this tick sees the same depth
        depth = (
            sum(len(q) for q in self.lib.queues.values())
            if self.selector is not None
            else 0
        )
        if self.admission == "batched":
            # one event tick -> one solve_batch over every admitted cartridge
            picks: list[tuple[PoolDrive, int, int, list[Request]]] = []
            for tid in cands:
                if not self.pool.can_serve(tid):
                    continue
                acq = self._acquire(tid, now, view)
                if acq is None:
                    continue  # mount budget exhausted: requests dropped
                drive, delay, retries = acq
                drive.busy = True  # reserve; _dispatch fills in the timeline
                picks.append((drive, delay, retries, self.lib.pending(tid).drain()))
            if not picks:
                return
            # one launch serves the whole tick, so one policy choice covers
            # it (hysteresis keyed on the reserved cross-cartridge key "*")
            pol = (
                self._select_policy(
                    "*", depth, sum(len(b) for *_, b in picks), now
                )
                if self.selector is not None
                else None
            )
            prepared = []
            for _, _, _, batch in picks:
                tape = self.lib.tape_of(batch[0].name)
                inst, names = tape.instance(_multiset(batch))
                prepared.append((tape, inst, names))
            try:
                results, new_warms, stats, rec = self._solve_batch_tick(
                    [inst for _, inst, _ in prepared],
                    [self._get_warm(t.tape_id, pol) for t, _, _ in prepared],
                    policy=pol,
                )
            except SolverUnavailableError:
                if self.retry.on_exhausted == "error":
                    raise
                # one tick = one launch = one fault domain: the whole tick's
                # work drops as typed failures, the reserved drives free up
                for drive, _, _, batch in picks:
                    drive.busy = False
                    self._fail_requests(batch, "solver-failed", now)
                    self._log(
                        ev="solve-failed", t=now, drive=drive.drive_id,
                        dropped=[r.req_id for r in batch],
                    )
                return
            degraded_to = rec.used if rec is not None and rec.fell_back else None
            for (drive, delay, retries, batch), (tape, inst, names), res, warm, st in zip(
                picks, prepared, results, new_warms, stats
            ):
                if rec is not None and rec.n_faults:
                    self._drop_warm(tape.tape_id, pol)  # invalidated on fallback
                else:
                    self._put_warm(tape.tape_id, warm, pol)
                self._dispatch(
                    drive, batch, now, delay, (tape, inst, names, res, st),
                    mount_retries=retries, degraded_to=degraded_to, policy=pol,
                )
            return
        for tid in cands:
            if not self.pool.can_serve(tid):
                continue
            acq = self._acquire(tid, now, view)
            if acq is None:
                continue  # mount budget exhausted: requests dropped
            drive, delay, retries = acq
            queue = self.lib.pending(tid)
            if self.admission == "edf-global":
                batch = [self._pop_urgent(queue, now)]
            elif self.admission in _ONE_SHOT:
                batch = [queue.pop()]
            else:
                batch = queue.drain()
            pol = (
                self._select_policy(tid, depth, len(batch), now)
                if self.selector is not None
                else None
            )
            self._dispatch(drive, batch, now, delay, mount_retries=retries, policy=pol)

    # -- solving (direct, or through the degradation chain under faults) -----
    def _solve_one(self, tape_id: str, inst, policy: str | None = None):
        """One cartridge's solve; returns ``(result, stats, degraded_to)``.

        ``policy`` overrides the server's configured policy for this tick
        (a selector's choice); warm states are read and written under the
        policy that actually solved.
        """
        pol = policy if policy is not None else self.policy
        warm = self._get_warm(tape_id, pol)
        if self._injector is None:
            res, new_warm, stats = solve_warm(
                inst, policy=pol, context=self.context, warm=warm
            )
            self._put_warm(tape_id, new_warm, pol)
            return res, stats, None
        res, new_warm, stats, rec = solve_warm_degraded(
            inst,
            policy=pol,
            context=self.context,
            warm=warm,
            fault_hook=self._injector.solver_hook,
            attempts_per_backend=self.retry.attempts("solver"),
        )
        if rec.n_faults:
            self._n_solver_faults += rec.n_faults
            self._n_fallbacks += rec.fell_back
            self._drop_warm(tape_id, pol)  # invalidated on fallback (new_warm None)
        else:
            self._put_warm(tape_id, new_warm, pol)
        return res, stats, rec.used if rec.fell_back else None

    def _solve_batch_tick(self, insts, warms, policy: str | None = None):
        """The ``batched`` admission's one-launch-per-tick solve."""
        pol = policy if policy is not None else self.policy
        if self._injector is None:
            results, new_warms, stats = solve_batch_warm(
                insts, policy=pol, context=self.context, warms=warms
            )
            return results, new_warms, stats, None
        results, new_warms, stats, rec = solve_batch_warm_degraded(
            insts,
            policy=pol,
            context=self.context,
            warms=warms,
            fault_hook=self._injector.solver_hook,
            attempts_per_backend=self.retry.attempts("solver"),
        )
        if rec.n_faults:
            self._n_solver_faults += rec.n_faults
            self._n_fallbacks += rec.fell_back
        return results, new_warms, stats, rec

    # -- drive actions -------------------------------------------------------
    def _dispatch(
        self,
        drive: PoolDrive,
        batch: list[Request],
        now: int,
        delay: int,
        prepared=None,
        mount_retries: int = 0,
        degraded_to: str | None = None,
        policy: str | None = None,
    ) -> None:
        pol = policy if policy is not None else self.policy
        if prepared is None:
            tape = self.lib.tape_of(batch[0].name)
            inst, names = tape.instance(_multiset(batch))
            try:
                res, stats, degraded_to = self._solve_one(tape.tape_id, inst, pol)
            except SolverUnavailableError:
                if self.retry.on_exhausted == "error":
                    raise
                self._fail_requests(batch, "solver-failed", now)
                self._log(
                    ev="solve-failed", t=now, drive=drive.drive_id,
                    dropped=[r.req_id for r in batch],
                )
                return
        else:
            tape, inst, names, res, stats = prepared
        if self.selector is not None:
            self._note_timing(pol, len(batch), stats)
        assert drive.mounted == tape.tape_id
        replay: Replay = replay_schedule(inst, res.detours)
        # the independent recomputation always lands in the BatchRecord; with
        # verify=True a disagreement (or structural defect) raises right here
        verified = replay.cost == res.cost
        if self.verify:
            verify_schedule(inst, res.detours, cost=res.cost, replay=replay)
        idx = {name: i for i, name in enumerate(names)}
        rewind = rewind_time(inst.m, inst.u_turn, replay.head_at_makespan)
        # mount legs and the budget-priced solve work are both charged before
        # the trajectory begins (with no ComputeBudget the charge is 0)
        solve_delay = self.budget.charge(stats.cells_evaluated)
        start = now + delay + solve_delay

        drive.busy = True
        drive.epoch += 1
        drive.dispatched = now
        drive.service_start = start
        drive.service_end = start + replay.makespan
        drive.busy_until = drive.service_end + rewind
        drive.legs = replay.legs
        drive.load_point = inst.m
        drive.u_turn = inst.u_turn
        drive.inflight = [
            (req, start + replay.service_time[idx[req.name]]) for req in batch
        ]
        drive.batch_idx = len(self._batches)
        if mount_retries:
            for req in batch:  # retried mounts delayed every request aboard
                self._faulted.add(req.req_id)
        self._batches.append(
            BatchRecord(
                tape_id=tape.tape_id,
                dispatched=now,
                n_requests=len(batch),
                n_files=inst.n_req,
                solver_cost=res.cost,
                replay_cost=replay.cost,
                makespan=replay.makespan,
                rewind=rewind,
                verified=verified,
                drive=drive.drive_id,
                mount_delay=delay,
                cells_evaluated=stats.cells_evaluated,
                cells_reused=stats.cells_reused,
                warm_mode=stats.mode,
                mount_retries=mount_retries,
                degraded_to=degraded_to,
                policy_used=pol if self.selector is not None else None,
                solve_delay=solve_delay,
            )
        )
        self._log(
            ev="batch", t=now, tape=tape.tape_id, drive=drive.drive_id,
            reqs=[r.req_id for r in batch], delay=delay, cost=res.cost,
            makespan=replay.makespan,
        )
        if self.obs is not None:
            track = f"drive{drive.drive_id}"
            if delay:
                self.obs.span(
                    "mount", now, now + delay, track=track,
                    shard=self._obs_shard, tape=tape.tape_id,
                )
            if solve_delay:
                self.obs.span(
                    "solve-delay", now + delay, start, track=track,
                    shard=self._obs_shard,
                )
            self.obs.span(
                "batch", start, drive.service_end, track=track,
                shard=self._obs_shard, tape=tape.tape_id,
                n_requests=len(batch), policy=pol,
                cells=stats.cells_evaluated,
            )
            self.obs.inc("batches_total")
            self.obs.inc("mount_delay_total", delay)
            self.obs.inc("solve_delay_total", solve_delay)
            self.obs.inc("cells_evaluated_total", stats.cells_evaluated)
            self.obs.inc("cells_reused_total", stats.cells_reused)
            if self.selector is not None:
                self.obs.inc("selector_decisions_total", policy=pol)
            if degraded_to:
                self.obs.inc("degraded_dispatches_total", backend=degraded_to)
        if self._injector is not None:
            hit = self._injector.media_fault(tape.tape_id, replay.legs)
            if hit is not None:
                t_rel, span = hit
                self._media_attempts[span] = self._media_attempts.get(span, 0) + 1
                self._push(
                    start + t_rel, "media-abort",
                    (drive.drive_id, drive.epoch, span),
                )
        self._push(drive.busy_until, "free", (drive.drive_id, drive.epoch))

    def _complete(self, drive: PoolDrive) -> None:
        self._record_served(drive, drive.inflight)
        self._log(
            ev="serve", t=drive.busy_until, drive=drive.drive_id,
            reqs=[[r.req_id, c] for r, c in drive.inflight],
        )
        drive.inflight = []
        drive.busy = False

    def _maybe_preempt_urgent(self, req: Request, tape_id: str, now: int) -> None:
        """Cross-cartridge preemption: abort a lax batch for an urgent arrival.

        The plain ``preempt`` admission only ever aborts the arriving
        cartridge's *own* in-flight batch; under drive contention an urgent
        arrival can instead be starved by a long lax batch on a *different*
        cartridge.  With ``preempt_urgent=True``, an arrival carrying a live
        (class-weighted) deadline that no drive can currently serve may
        abort one busy drive — but only a drive whose every unserved
        in-flight request is *lax* relative to the arrival (best-effort, or
        deadline strictly later), so urgent work never preempts equally
        urgent work.  Among eligible victims the fewest-survivors drive
        (ties by drive id) is aborted through the standard preemption
        machinery: completions stand, survivors requeue, the head rewinds,
        and the freed drive remounts under the admission's urgency order.
        """
        d = self._deadline_of(req)
        if d is None or d <= now:
            return  # best-effort or already missed: nothing to protect
        if self.pool.can_serve(tape_id):
            return  # a drive can take it without aborting anyone
        victim: PoolDrive | None = None
        victim_key: tuple[int, int] | None = None
        for drive in self.pool.alive:
            if not drive.busy or not drive.inflight:
                continue
            pending = [r for r, c in drive.inflight if c > now]
            if not pending:
                continue  # everything aboard already completed
            lax = all(
                (dl := self._deadline_of(r)) is None or dl > d for r in pending
            )
            if not lax:
                continue
            key = (len(pending), drive.drive_id)
            if victim_key is None or key < victim_key:
                victim, victim_key = drive, key
        if victim is not None:
            self._preempt(victim, now, reason="preempt-urgent")

    def _preempt(self, drive: PoolDrive, now: int, reason: str = "preempt") -> None:
        """Abort the in-flight batch at ``now``; requeue unserved requests.

        Completions at or before ``now`` stand; the head rewinds from its
        current trajectory position (one U-turn + seek to the load point)
        before the next dispatch.  The drive stays busy for the rewind.  A
        preemption landing inside the mount legs (before ``service_start``)
        cannot conjure the head to the load point early: the robot is
        already threading, so the drive stays busy until the mount
        completes (``service_start``), head then parked at the load point,
        no rewind to charge.
        """
        done = [(r, c) for r, c in drive.inflight if c <= now]
        pending = [r for r, c in drive.inflight if c > now]
        self._record_served(drive, done)
        for req in pending:
            self.lib.enqueue(req.name, req)
        if now < drive.service_start:
            # aborted mid-mount: the in-flight mount still runs to completion
            free_at = drive.service_start
        else:
            pos = head_position(drive.legs, now - drive.service_start)
            free_at = now + rewind_time(drive.load_point, drive.u_turn, pos)
        aborted = self._batches[drive.batch_idx]
        assert aborted.tape_id == drive.mounted
        assert aborted.dispatched == drive.dispatched
        self._batches[drive.batch_idx] = dataclasses.replace(
            aborted, preempted=True, n_completed=len(done)
        )
        drive.epoch += 1  # invalidate the scheduled drive-free event
        drive.inflight = []
        drive.legs = ()
        drive.service_end = now
        drive.busy_until = free_at
        drive.busy = True
        self._n_preempt += 1
        self._log(
            ev="abort", t=now, drive=drive.drive_id, reason=reason,
            requeued=[r.req_id for r in pending],
        )
        if self.obs is not None:
            self.obs.inc("preemptions_total", reason=reason)
            self.obs.event(
                "preempt", now, track=f"drive{drive.drive_id}",
                shard=self._obs_shard, reason=reason,
            )
        self._push(drive.busy_until, "free", (drive.drive_id, drive.epoch))


def _multiset(batch: list[Request]) -> dict[str, int]:
    multiset: dict[str, int] = {}
    for req in batch:
        multiset[req.name] = multiset.get(req.name, 0) + 1
    return multiset


def serve_trace(
    library: TapeLibrary,
    trace: list[Request],
    admission: str = "accumulate",
    *,
    window: int = 0,
    policy: str = "dp",
    n_drives: int | None = None,
    drive_costs: DriveCosts | None = None,
    qos: Mapping[int, QoSSpec] | None = None,
    mount_scheduler: str | MountScheduler = "greedy",
    context: ExecutionContext | None = None,
    backend: str | None = None,
    cache: SolveCache | None = None,
    verify: bool = True,
    warm_start: bool = True,
    faults: FaultPlan | None = None,
    retry: RetryPolicy | None = None,
    journal: EventJournal | str | os.PathLike | None = None,
    selector: str | SolverSelector | None = None,
    preempt_urgent: bool = False,
    class_weights: Mapping[str, int] | None = None,
) -> ServiceReport:
    """One-shot convenience: build an :class:`OnlineTapeServer` and run it."""
    server = OnlineTapeServer(
        library,
        admission,
        window=window,
        policy=policy,
        n_drives=n_drives,
        drive_costs=drive_costs,
        qos=qos,
        mount_scheduler=mount_scheduler,
        context=context,
        backend=backend,
        cache=cache,
        verify=verify,
        warm_start=warm_start,
        faults=faults,
        retry=retry,
        journal=journal,
        selector=selector,
        preempt_urgent=preempt_urgent,
        class_weights=class_weights,
    )
    return server.run(trace)
