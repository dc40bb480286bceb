"""``DrivePool``: N shared tape drives serving all cartridges.

A real mass-storage system (the CC-IN2P3 setting the paper's logs come from)
does not own one drive per cartridge: a robotic arm moves a small pool of
drives across a large cartridge archive, and *which cartridge to mount next*
is a scheduling decision layered on top of the per-cartridge LTSP sequencing.
This module models that layer:

* :class:`DriveCosts` — the explicit mount/unmount/seek-to-load-point cost
  model, in the same integer virtual-time units as the simulator (1 unit per
  byte of head travel).  ``unmount`` is charged when an occupied drive gives
  its cartridge up for another, ``mount`` when a cartridge is threaded, and
  ``load_seek`` for positioning the freshly threaded tape at its load point.
  The all-zero default makes the pool collapse to the one-drive-per-
  cartridge model exactly.
* :class:`PoolDrive` — one drive's full timeline state: which cartridge is
  mounted, the in-flight batch (legs, service window, completions), and the
  epoch counter that invalidates stale drive-free events after a preemption.
* :class:`DrivePool` — the allocator: deterministic drive selection
  (prefer the drive that already holds the cartridge — its head is parked at
  the load point after the post-batch rewind, so re-serving it costs no mount
  leg; otherwise a pluggable :class:`MountScheduler` picks among the free
  drives), cartridge exclusivity (a physical tape can be mounted in at most
  one drive), and mount/unmount accounting that the
  :class:`~repro_torch.serving.sim.ServiceReport` surfaces.

Mount scheduling (which drive to use / evict)
---------------------------------------------
Eviction used to be a hardcoded loop; it is now a context-visible choice.
A :class:`MountScheduler` picks the drive for a cartridge that is not
currently mounted, given the free drives and a :class:`MountView` of the
queue state (virtual ``now``, per-cartridge queue depth, per-cartridge
earliest queued deadline, and the cost model).  Registered implementations
(:data:`MOUNT_SCHEDULERS`):

``greedy`` (alias ``lowest-numbered``, the default)
    The original pool rule, bit-identical: lowest-numbered empty free drive, else
    evict the lowest-numbered free occupied drive.  Ignores the view.
``lru``
    Evict the least-recently-*used* free drive (smallest ``last_used``
    acquisition time, drive id breaking ties): cartridges that served
    recently tend to be asked for again (the Zipf head), so their drives
    are kept threaded.
``lookahead``
    Keep the cartridge the queues will want next: every eviction candidate's
    mounted cartridge gets a keep-score ``queue depth x remount cost x
    deadline urgency`` (urgency doubles when the cartridge's earliest queued
    deadline is within one remount of ``now``), and the drive with the
    *lowest* keep-score is evicted.  Exact-int, deterministic.

Failure model and retries
-------------------------
A drive can hard-fail (:meth:`DrivePool.fail_drive`, driven by the fault
layer in :mod:`repro_torch.serving.faults`): a failed drive is excluded from every
allocation path — :meth:`DrivePool.drive_of`, :meth:`DrivePool.can_serve`,
:meth:`DrivePool.acquire`, and therefore from every
:class:`MountScheduler`'s candidate list — and its cartridge is extracted so
it can remount on a surviving drive (at full remount cost, charged through
the normal :meth:`DrivePool.acquire` accounting).  When every drive has
failed while requests are still queued, the serving loop raises the typed
:class:`NoDriveAvailableError` (requests stay queued) or drops them as typed
failures, per the pool's :class:`RetryPolicy`.

:class:`RetryPolicy` is the pool's knob set for *transient* faults: maximum
attempts (overridable per fault class — ``mount``/``media``/``solver``),
exponential backoff charged in exact virtual time between attempts, whether
aborted in-flight requests fail over (requeue) or fail stop (drop), and
whether exhausted budgets raise typed errors or record typed
:class:`~repro_torch.serving.sim.FailedRequest` rows.  The policy is pure data;
the event loop in :mod:`repro_torch.serving.queue` enforces it.

The event loop that drives a pool lives in :mod:`repro_torch.serving.queue`
(:class:`~repro_torch.serving.queue.OnlineTapeServer`); everything here is plain
deterministic state — no clocks, no randomness.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Protocol, runtime_checkable

from .sim import Leg, Request

__all__ = [
    "DriveCosts",
    "PoolDrive",
    "DrivePool",
    "MountView",
    "MountScheduler",
    "MOUNT_SCHEDULERS",
    "GreedyScheduler",
    "LRUScheduler",
    "LookaheadScheduler",
    "resolve_scheduler",
    "RetryPolicy",
    "FAIL_STOP",
    "NoDriveAvailableError",
]


class NoDriveAvailableError(RuntimeError):
    """Every drive in the pool has failed while requests are still queued.

    Raised by the serving loop under ``RetryPolicy(on_exhausted="error")``
    (the default); the undispatched requests stay in their pending queues so
    a caller can inspect or re-drive them against a repaired pool.
    """

    def __init__(self, n_queued: int):
        self.n_queued = n_queued
        super().__init__(
            f"all drives have failed with {n_queued} request(s) still queued"
        )


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How the serving loop reacts to transient faults (pure data, exact-int).

    ``max_attempts`` bounds the attempts per fault site — mount attempts per
    cartridge acquisition, read attempts per bad media span, solve attempts
    per backend tier — with optional per-class overrides.  Between attempts
    the loop charges ``backoff(attempt)`` virtual time units, exponential in
    the attempt number (solver retries are exempt: solving is instantaneous
    in virtual time).  ``failover`` decides whether requests aborted by a
    drive failure or media error are requeued onto surviving capacity
    (``True``, the default) or dropped fail-stop; ``on_exhausted`` decides
    whether an exhausted budget raises the typed error (``"error"``) or
    records the affected requests as typed
    :class:`~repro_torch.serving.sim.FailedRequest` rows (``"drop"``).
    """

    max_attempts: int = 3
    backoff_base: int = 10_000
    backoff_factor: int = 2
    mount_attempts: int | None = None
    media_attempts: int | None = None
    solver_attempts: int | None = None
    failover: bool = True
    on_exhausted: str = "error"  # "error" | "drop"

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_base < 0 or self.backoff_factor < 1:
            raise ValueError("backoff_base must be >= 0, backoff_factor >= 1")
        for name in ("mount_attempts", "media_attempts", "solver_attempts"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1 when set")
        if self.on_exhausted not in ("error", "drop"):
            raise ValueError("on_exhausted must be 'error' or 'drop'")

    def attempts(self, fault_class: str) -> int:
        """Attempt budget for ``"mount"``/``"media"``/``"solver"``."""
        override = getattr(self, f"{fault_class}_attempts")
        return override if override is not None else self.max_attempts

    def backoff(self, attempt: int) -> int:
        """Virtual-time delay charged after failed attempt ``attempt`` (>=1)."""
        if attempt < 1:
            raise ValueError("attempt numbers start at 1")
        return self.backoff_base * self.backoff_factor ** (attempt - 1)


#: no retries, no failover, no typed raise: aborted/unservable requests are
#: dropped as FailedRequest rows — the baseline the availability sweep beats.
FAIL_STOP = RetryPolicy(max_attempts=1, failover=False, on_exhausted="drop")


@dataclasses.dataclass(frozen=True)
class DriveCosts:
    """Mount-leg cost model, in simulator virtual-time units (exact ints).

    ``switch`` (mount + load_seek) is charged whenever a cartridge is
    threaded into a drive; ``unmount`` is additionally charged when the drive
    first has to give up the cartridge it holds.  A drive re-serving the
    cartridge it already holds pays nothing — the post-batch rewind already
    parked the head at the load point.
    """

    mount: int = 0
    unmount: int = 0
    load_seek: int = 0

    def __post_init__(self) -> None:
        for name in ("mount", "unmount", "load_seek"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} cost must be >= 0")

    @property
    def switch(self) -> int:
        """Cost of threading + positioning a newly mounted cartridge."""
        return self.mount + self.load_seek


@dataclasses.dataclass
class PoolDrive:
    """One drive's state (all times absolute virtual time)."""

    drive_id: int
    mounted: str | None = None  # tape_id threaded into this drive
    busy: bool = False
    epoch: int = 0  # invalidates stale drive-free events after preemption
    dispatched: int = 0  # when the in-flight batch was handed over
    service_start: int = 0  # dispatched + mount legs (trajectory t=0)
    service_end: int = 0  # service_start + makespan (last completion)
    busy_until: int = 0  # service_end + rewind-to-load-point
    legs: tuple[Leg, ...] = ()
    inflight: list[tuple[Request, int]] = dataclasses.field(default_factory=list)
    batch_idx: int = -1  # index of the in-flight batch's BatchRecord
    load_point: int = 0  # in-flight instance's m (rewind target)
    u_turn: int = 0  # in-flight instance's U-turn penalty
    last_used: int = 0  # virtual time of the last acquire (LRU eviction)
    failed: bool = False  # hard-failed: permanently out of the pool


@dataclasses.dataclass(frozen=True)
class MountView:
    """Queue-state snapshot a :class:`MountScheduler` decides against.

    ``depth`` maps tape id -> pending queue length, ``urgency`` maps tape id
    -> earliest queued deadline (absent/None when no queued request carries
    one).  Both cover only cartridges with pending requests; a mounted
    cartridge absent from ``depth`` has nothing queued.
    """

    now: int = 0
    costs: DriveCosts = dataclasses.field(default_factory=DriveCosts)
    depth: Mapping[str, int] = dataclasses.field(default_factory=dict)
    urgency: Mapping[str, int | None] = dataclasses.field(default_factory=dict)


@runtime_checkable
class MountScheduler(Protocol):
    """Eviction policy: which free drive serves a not-mounted cartridge.

    ``pick`` receives the free drives in drive-id order (never empty — the
    pool checks :meth:`DrivePool.can_serve` first) and the current
    :class:`MountView`; it must return one of them, deterministically.  The
    holder-drive fast path (cartridge already threaded) never reaches the
    scheduler: re-serving a threaded cartridge is free and always preferred.
    """

    name: str

    def pick(
        self, free: list[PoolDrive], view: MountView
    ) -> PoolDrive:  # pragma: no cover - protocol signature
        ...


class GreedyScheduler:
    """The original default, bit-identical: lowest empty drive, else lowest free."""

    name = "greedy"

    def pick(self, free: list[PoolDrive], view: MountView) -> PoolDrive:
        empty = [d for d in free if d.mounted is None]
        return empty[0] if empty else free[0]


class LRUScheduler:
    """Evict the least-recently-acquired free drive (empty drives first)."""

    name = "lru"

    def pick(self, free: list[PoolDrive], view: MountView) -> PoolDrive:
        empty = [d for d in free if d.mounted is None]
        pool = empty if empty else free
        return min(pool, key=lambda d: (d.last_used, d.drive_id))


class LookaheadScheduler:
    """Evict the mounted cartridge the queues want least.

    Keep-score of an eviction candidate's cartridge =
    ``queue depth x remount cost x urgency`` where urgency is 2 when the
    cartridge's earliest queued deadline is within one remount of ``now``
    (evicting it would likely blow that deadline on the round trip back)
    and 1 otherwise.  The lowest keep-score is evicted, drive id breaking
    ties; empty drives (keep-score 0 by construction) always win.
    """

    name = "lookahead"

    def pick(self, free: list[PoolDrive], view: MountView) -> PoolDrive:
        empty = [d for d in free if d.mounted is None]
        if empty:
            return empty[0]
        remount = max(1, view.costs.unmount + view.costs.switch)

        def keep_score(d: PoolDrive) -> int:
            depth = view.depth.get(d.mounted, 0)
            deadline = view.urgency.get(d.mounted)
            urgent = deadline is not None and deadline - view.now <= remount
            return depth * remount * (2 if urgent else 1)

        return min(free, key=lambda d: (keep_score(d), d.drive_id))


#: registered mount schedulers (``lowest-numbered`` aliases the default).
MOUNT_SCHEDULERS: dict[str, type] = {
    "greedy": GreedyScheduler,
    "lowest-numbered": GreedyScheduler,
    "lru": LRUScheduler,
    "lookahead": LookaheadScheduler,
}


def resolve_scheduler(scheduler: str | MountScheduler) -> MountScheduler:
    """Name -> registered instance; a scheduler object passes through."""
    if isinstance(scheduler, str):
        if scheduler not in MOUNT_SCHEDULERS:
            raise ValueError(
                f"unknown mount scheduler {scheduler!r}; choose from "
                f"{sorted(MOUNT_SCHEDULERS)}"
            )
        return MOUNT_SCHEDULERS[scheduler]()
    if not isinstance(scheduler, MountScheduler):
        raise TypeError(f"not a MountScheduler: {scheduler!r}")
    return scheduler


class DrivePool:
    """N drives shared by every cartridge, with deterministic allocation."""

    def __init__(
        self,
        n_drives: int,
        costs: DriveCosts | None = None,
        scheduler: str | MountScheduler = "greedy",
        retry: RetryPolicy | None = None,
    ):
        if n_drives < 1:
            raise ValueError("a drive pool needs at least one drive")
        self.costs = costs if costs is not None else DriveCosts()
        self.scheduler = resolve_scheduler(scheduler)
        self.retry = retry if retry is not None else RetryPolicy()
        self.drives = [PoolDrive(i) for i in range(n_drives)]
        self.n_mounts = 0
        self.n_unmounts = 0
        self.mount_time = 0  # total charged mount/unmount/seek time
        self.n_drive_failures = 0
        # optional Observability bundle (set by the serving loop when the
        # context carries one); reads pre-computed ints only — never state
        self.obs = None

    @property
    def n_drives(self) -> int:
        return len(self.drives)

    @property
    def alive(self) -> list[PoolDrive]:
        """Drives still in service (hard-failed ones are gone for good)."""
        return [d for d in self.drives if not d.failed]

    def fail_drive(self, drive: PoolDrive) -> None:
        """Hard-fail a drive: out of every allocation path, cartridge freed.

        The cartridge (if any) is extracted by the robot so it can remount
        on a surviving drive — the remount cost is charged by the next
        :meth:`acquire` like any other mount.  The caller (the serving
        loop's fault handler) is responsible for aborting the in-flight
        batch and requeueing its unserved requests first.
        """
        if drive.failed:
            return
        drive.failed = True
        drive.mounted = None
        drive.busy = False
        self.n_drive_failures += 1
        if self.obs is not None:
            self.obs.inc("drive_failures_total")
            self.obs.gauge("alive_drives", len(self.alive))

    def drive_of(self, tape_id: str) -> PoolDrive | None:
        """The drive holding ``tape_id``, if any (cartridge exclusivity)."""
        for d in self.drives:
            if d.mounted == tape_id and not d.failed:
                return d
        return None

    def can_serve(self, tape_id: str) -> bool:
        """Whether a dispatch for this cartridge could start right now.

        A mounted cartridge can only be served by its own drive (a physical
        tape exists once); an unmounted one needs any free surviving drive.
        """
        holder = self.drive_of(tape_id)
        if holder is not None:
            return not holder.busy
        return any(not d.busy and not d.failed for d in self.drives)

    def acquire(
        self, tape_id: str, now: int = 0, view: MountView | None = None
    ) -> tuple[PoolDrive, int]:
        """Pick the drive for a dispatch; returns ``(drive, mount_delay)``.

        Only call when :meth:`can_serve` is true.  Selection is deterministic:
        the holder drive (delay 0) always wins — the cartridge is already
        threaded; otherwise the pool's :class:`MountScheduler` picks among
        the free drives (empty: mount + load_seek; occupied: unmount + mount
        + load_seek).  ``view`` gives deadline/queue-aware schedulers their
        decision context; the default greedy scheduler ignores it.
        Mount/unmount counters and the total charged mount time accumulate
        on the pool.
        """
        holder = self.drive_of(tape_id)
        if holder is not None:
            assert not holder.busy, f"{tape_id} is mid-batch in drive {holder.drive_id}"
            holder.last_used = now
            if self.obs is not None:
                self.obs.inc("drive_holder_hits_total")
            return holder, 0
        free = [d for d in self.drives if not d.busy and not d.failed]
        assert free, "acquire() without a free drive; check can_serve() first"
        if view is None:
            view = MountView(now=now, costs=self.costs)
        drive = self.scheduler.pick(free, view)
        assert not drive.busy, "scheduler picked a busy drive"
        delay = 0
        evicted = drive.mounted is not None
        if evicted:
            delay += self.costs.unmount
            self.n_unmounts += 1
        delay += self.costs.switch
        self.n_mounts += 1
        self.mount_time += delay
        if self.obs is not None:
            self.obs.inc("drive_mounts_total")
            if evicted:
                self.obs.inc("drive_evictions_total")
            self.obs.inc("mount_time_total", delay)
        drive.mounted = tape_id
        drive.last_used = now
        return drive, delay

    def stats(self) -> dict[str, int]:
        """Pool counters with a stable schema for metric scrapes.

        ``alive_drives`` is always present (``n_drives`` counts the
        configured drives, dead ones included) so scrapers never branch on
        key existence; ``drive_failures`` stays conditional so fault-free
        reports keep the pre-fault-layer key set.  Human-facing ``summary()``
        surfaces preserve the old conditional ``alive_drives`` shape — see
        :meth:`~repro_torch.serving.sim.ServiceReport.summary`.
        """
        out = {
            "n_drives": self.n_drives,
            "mounts": self.n_mounts,
            "unmounts": self.n_unmounts,
            "mount_time": self.mount_time,
            "alive_drives": len(self.alive),
        }
        if self.n_drive_failures:
            out["drive_failures"] = self.n_drive_failures
        return out
