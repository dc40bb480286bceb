"""Sharded multi-library serving: N tape servers under one exact clock.

A :class:`FleetServer` federates N *shards* — each an **unmodified**
:class:`~repro_torch.serving.queue.OnlineTapeServer` over its own
:class:`~repro_torch.storage.tape.TapeLibrary` and
:class:`~repro_torch.serving.drives.DrivePool` — behind a single arrival stream.
Every arriving request names a logical file; a
:class:`~repro_torch.fleet.placement.PlacementStrategy` picks which
replica-holding shard serves it (the request's ``tape_id`` is rewritten to
that shard's cartridge), and all shards advance in **shared exact virtual
time**.  Two execution paths, chosen by configuration:

* **Static pre-partition** — when the placement is static (``single``,
  ``static-hash``) and no :class:`~repro_torch.serving.faults.ShardOutage` is
  injected, routing depends only on file names, so the trace is partitioned
  up front and each shard runs its event loop standalone.  A one-shard
  ``single`` federation is therefore *bit-identical* to a standalone
  server: same events, same journal, same report.
* **Lock-step interleave** — dynamic placements (and any outage) need live
  shard state at each arrival instant, so the fleet drives the shards'
  stepping primitives (``_begin``/``_step``/``_finish``) directly: a fleet
  heap holds arrivals and outages, and at every iteration the globally
  earliest event fires — a fleet event when its time is at or before every
  shard's next event (outages strike before same-instant arrivals, so
  those arrivals already route away from the dark shard), else one
  ``_step()`` of the earliest shard (lowest index on ties).  All
  tie-breaks are total orders over exact ints: the interleave is
  deterministic.

Shared fault domains: a :class:`~repro_torch.serving.faults.ShardOutage` fails
every surviving drive of one shard at one virtual instant (each through the
standard abort/requeue machinery, in drive-id order), then re-routes every
orphaned queued request that still has a replica on a surviving shard —
re-picked by the placement strategy over the surviving holders and injected
as a fresh arrival at the outage instant, marked ``faulted``.  Requests
with no surviving replica stay queued on the dark shard and follow its
:class:`~repro_torch.serving.drives.RetryPolicy` exhaustion path at finish
(typed raise, or typed ``no-drive`` drops).

Crash recovery composes shard-wise: each shard journals through its own
:class:`~repro_torch.serving.faults.EventJournal` (``<base>.shardNN``), and
:func:`recover_fleet` resumes every journal's valid prefix, re-executes the
whole federation (deterministic re-execution *is* recovery, exactly as in
:func:`~repro_torch.serving.faults.recover_server`), cross-checks every
re-produced event, and finishes byte-identically from any cut point.
:func:`merge_journals` flattens the per-shard logs into one
deterministically ordered federation stream for inspection.
"""

from __future__ import annotations

import dataclasses
import heapq
import os
from collections import deque
from typing import Mapping, Sequence

import numpy as np

from ..serving.faults import EventJournal, JournalReplayError, ShardOutage
from ..serving.qos import QoSSpec
from ..serving.queue import OnlineTapeServer
from ..serving.sim import Request
from .placement import (
    FleetView,
    PlacementStrategy,
    ReplicaMap,
    ShardView,
    SinglePlacement,
    get_placement,
)
from .report import FleetReport, merge_reports

__all__ = [
    "FleetServer",
    "serve_fleet_trace",
    "recover_fleet",
    "merge_journals",
    "shard_journal_path",
    "demo_fleet",
    "fleet_catalog",
]


def shard_journal_path(base: str | os.PathLike, shard: int) -> str:
    """Shard ``shard``'s journal path under the fleet's base path."""
    return f"{os.fspath(base)}.shard{shard:02d}"


class _Catalog:
    """Minimal ``.location`` facade: logical file -> primary shard's tape.

    :func:`repro_torch.serving.sim.poisson_trace` (and the QoS trace generator on
    top of it) only ever read ``library.location``, so this facade lets the
    existing seeded generators draw federation-wide traces unchanged.
    """

    def __init__(self, location: dict[str, str]):
        self.location = location


def fleet_catalog(libraries: Sequence, replica_map: ReplicaMap | None = None):
    """The federation's unified file catalogue (for trace generation).

    Each logical file maps to its *primary* holder's tape id — a
    placeholder the router rewrites per routed shard at dispatch.
    """
    rmap = replica_map if replica_map is not None else ReplicaMap.from_libraries(libraries)
    rmap.validate(libraries)
    return _Catalog(
        {
            name: libraries[rmap.primary(name)].location[name]
            for name in sorted(rmap.holders_of)
        }
    )


def demo_fleet(
    seed: int,
    n_shards: int = 2,
    n_files: int = 48,
    replicas: int = 1,
    capacity: int = 4_000_000,
    u_turn: int = 20_000,
    with_cache: bool = True,
) -> tuple[list, ReplicaMap]:
    """Seeded N-shard archive: the fleet twin of ``demo_library``.

    Returns ``(libraries, replica_map)``.  File ``i``'s primary shard is
    ``i % n_shards`` (every shard stores files as long as ``n_files >=
    n_shards``) and ``replicas - 1`` further holders are drawn from the
    seed; every replica of a file has the identical size — it is the same
    logical object.  Sizes match :func:`~repro_torch.serving.sim.demo_library`'s
    regime (100-600 KB objects on ~4 MB cartridges), so fleet and
    single-library numbers stay comparable.  The libraries' contexts are the
    default (``python``) one, with a :class:`SolveCache` when
    ``with_cache``; pass a device context to the server, not here.
    """
    from ..core.solver import ExecutionContext, SolveCache
    from ..storage.tape import TapeLibrary

    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if not (1 <= replicas <= n_shards):
        raise ValueError(f"need 1 <= replicas <= n_shards, got {replicas}")
    rng = np.random.default_rng(seed)
    libs = [
        TapeLibrary(
            capacity_per_tape=capacity,
            u_turn=u_turn,
            context=ExecutionContext(cache=SolveCache() if with_cache else None),
        )
        for _ in range(n_shards)
    ]
    for i in range(n_files):
        size = int(rng.integers(100_000, 600_000))
        holders = {i % n_shards}
        while len(holders) < replicas:
            holders.add(int(rng.integers(0, n_shards)))
        for s in sorted(holders):
            libs[s].store(f"obj{i:04d}", size)
    return libs, ReplicaMap.from_libraries(libs)


class FleetServer:
    """N per-library shards, one placement strategy, one exact clock.

    ``libraries`` are the shard archives (one unmodified
    :class:`~repro_torch.serving.queue.OnlineTapeServer` is built per library
    with the shared ``admission``/``**kwargs``); ``placement`` names a
    registered strategy (or passes an instance).  ``None`` placement reads
    the strategy from ``kwargs["context"].fleet`` when present, else
    ``"single"`` — and a context carrying
    :class:`~repro_torch.core.context.FleetOptions` must agree with
    ``len(libraries)`` on the shard count.  ``replica_map`` defaults to
    what the libraries actually store and is always validated against
    them.  ``outages`` are :class:`~repro_torch.serving.faults.ShardOutage`
    records; ``journal`` is a base path journaled per shard
    (``<base>.shardNN``).

    The ``single`` strategy requires exactly one shard (it is the pinned
    bit-identical NoOp default, not a router).

    ``kwargs["context"]`` is handed to every shard's server, so it picks the
    backend all shards solve on: ``ExecutionContext(backend="cuda",
    numeric_policy="f64")`` builds every dispatch's tables on the card.
    Without ``context=`` the shards run on the default (``python``) context,
    not on their libraries' own.
    """

    def __init__(
        self,
        libraries: Sequence,
        admission: str = "accumulate",
        *,
        placement: str | PlacementStrategy | None = None,
        replica_map: ReplicaMap | None = None,
        outages: Sequence[ShardOutage] = (),
        journal: str | os.PathLike | None = None,
        qos: Mapping[int, QoSSpec] | None = None,
        **kwargs,
    ):
        if not libraries:
            raise ValueError("a fleet needs at least one shard library")
        ctx = kwargs.get("context")
        fleet_opts = getattr(ctx, "fleet", None) if ctx is not None else None
        if placement is None:
            placement = fleet_opts.placement if fleet_opts is not None else "single"
        if fleet_opts is not None and fleet_opts.n_shards != len(libraries):
            raise ValueError(
                f"context.fleet says {fleet_opts.n_shards} shard(s) but "
                f"{len(libraries)} librar{'y was' if len(libraries) == 1 else 'ies were'} given"
            )
        self.placement = get_placement(placement)
        if isinstance(self.placement, SinglePlacement) and len(libraries) != 1:
            raise ValueError(
                f"the 'single' placement is the one-shard NoOp default; "
                f"got {len(libraries)} shards — pick a routing strategy"
            )
        self.libraries = list(libraries)
        self.replicas = (
            replica_map
            if replica_map is not None
            else ReplicaMap.from_libraries(self.libraries)
        )
        self.replicas.validate(self.libraries)
        for o in outages:
            if not isinstance(o, ShardOutage):
                raise TypeError(f"outages must be ShardOutage records, got {o!r}")
            if o.shard >= len(self.libraries):
                raise ValueError(
                    f"outage targets shard {o.shard} but the fleet has "
                    f"only {len(self.libraries)} shard(s)"
                )
        self.outages = tuple(sorted(outages, key=lambda o: (o.at, o.shard)))
        self.journal_base = os.fspath(journal) if journal is not None else None
        self.shards = [
            OnlineTapeServer(
                lib,
                admission,
                qos=qos,
                journal=(
                    shard_journal_path(self.journal_base, i)
                    if self.journal_base is not None
                    else None
                ),
                **kwargs,
            )
            for i, lib in enumerate(self.libraries)
        ]
        self.routes: dict[int, int] = {i: 0 for i in range(len(self.shards))}
        self.n_rerouted = 0
        # observability (opt-in): shards record under their own index, the
        # router under a "router" lane; unset obs changes nothing
        self.obs = ctx.obs if ctx is not None else None
        for i, sh in enumerate(self.shards):
            sh._obs_shard = i

    # -- routing --------------------------------------------------------------
    def _view(self, now: int, name: str, candidates: tuple[int, ...]) -> FleetView:
        """Snapshot every shard's routing-relevant state at ``now``."""
        views = []
        for i, sh in enumerate(self.shards):
            views.append(
                ShardView(
                    shard=i,
                    depth=sum(len(q) for q in sh.lib.queues.values()),
                    n_drives=len(sh.pool.drives),
                    n_alive=len(sh.pool.alive),
                    mounted=frozenset(
                        d.mounted for d in sh.pool.alive if d.mounted is not None
                    ),
                    costs=sh.drive_costs,
                )
            )
        return FleetView(
            now=now,
            shards=tuple(views),
            tapes={i: self.libraries[i].location[name] for i in candidates},
        )

    def _routed(self, req: Request, dest: int) -> Request:
        """The request as shard ``dest`` sees it (its own replica's tape)."""
        return dataclasses.replace(
            req, tape_id=self.libraries[dest].location[req.name]
        )

    def _route_arrival(self, req: Request, now: int) -> None:
        """Pick a holder shard for one live arrival and inject it there."""
        cands = self.replicas.holders(req.name)
        dest = self.placement.pick(req.name, cands, self._view(now, req.name, cands))
        self.routes[dest] += 1
        if self.obs is not None:
            self.obs.event(
                "route", now, track="router", shard=dest, req=req.req_id
            )
            self.obs.inc("fleet_routed_total", shard=str(dest))
        self.shards[dest]._on_arrival(self._routed(req, dest), now)

    # -- shared fault domain --------------------------------------------------
    def _apply_outage(self, outage: ShardOutage) -> None:
        """One shard goes dark; orphans with surviving replicas re-route.

        Drives fail in drive-id order through the shard's own
        ``_fail_drive`` (in-flight batches abort, completions stand,
        survivors requeue into the shard's queues first — so they are
        orphans too and re-route below with everything else).
        """
        now = outage.at
        sh = self.shards[outage.shard]
        if self.obs is not None:
            self.obs.inc("fleet_outages_total")
            self.obs.event("outage", now, track="router", shard=outage.shard)
        for drive in sorted(sh.pool.alive, key=lambda d: d.drive_id):
            sh._fail_drive(drive, now)
        alive = {i for i, s in enumerate(self.shards) if s.pool.alive}
        reroute: list[Request] = []
        for tid in sorted(sh.lib.queues):
            queue = sh.lib.queues[tid]
            if len(queue) == 0:
                continue
            items = queue.drain()
            for r in items:
                if any(i in alive for i in self.replicas.holders(r.name)):
                    reroute.append(r)
                else:
                    # no surviving replica anywhere: stays on the dark
                    # shard for its RetryPolicy exhaustion path at finish
                    queue.push(r)
        for r in sorted(reroute, key=lambda r: (r.time, r.req_id)):
            cands = tuple(
                i for i in self.replicas.holders(r.name) if i in alive
            )
            dest = self.placement.pick(r.name, cands, self._view(now, r.name, cands))
            self.routes[dest] += 1
            self.n_rerouted += 1
            if self.obs is not None:
                self.obs.inc("fleet_rerouted_total", shard=str(dest))
                self.obs.event(
                    "reroute", now, track="router", shard=dest, req=r.req_id
                )
            self.shards[dest]._faulted.add(r.req_id)
            self.shards[dest]._on_arrival(self._routed(r, dest), now)

    # -- execution ------------------------------------------------------------
    def run(self, trace: list[Request]) -> FleetReport:
        """Serve a federation-wide trace; returns the per-shard + merged report."""
        trace = sorted(trace)
        for req in trace:
            self.replicas.holders(req.name)  # unknown files fail fast
        if not self.placement.dynamic and not self.outages:
            reports = self._run_static(trace)
        else:
            reports = self._run_lockstep(trace)
        if self.obs is not None:
            for i, rep in enumerate(reports):
                self.obs.gauge("shard_served", rep.n_served, shard=str(i))
                self.obs.gauge("shard_failed", rep.n_failed, shard=str(i))
                self.obs.gauge(
                    "shard_routed", self.routes.get(i, 0), shard=str(i)
                )
        return FleetReport(
            shards=tuple(reports),
            merged=merge_reports(reports),
            placement=self.placement.name,
            n_shards=len(self.shards),
            routes=dict(self.routes),
            n_rerouted=self.n_rerouted,
            outages=self.outages,
        )

    def _run_static(self, trace: list[Request]) -> list:
        """Static placements, no outages: pre-partition and run standalone.

        Routing depends only on file names here, so each shard's sub-trace
        is known up front and its event loop runs exactly as a standalone
        server would — the one-shard ``single`` federation is bit-identical
        to no federation at all.  Static strategies see an empty shard
        snapshot (there is no runtime state before the runs start).
        """
        subs: list[list[Request]] = [[] for _ in self.shards]
        for req in trace:
            cands = self.replicas.holders(req.name)
            view = FleetView(
                now=0,
                shards=(),
                tapes={i: self.libraries[i].location[req.name] for i in cands},
            )
            dest = self.placement.pick(req.name, cands, view)
            self.routes[dest] += 1
            subs[dest].append(self._routed(req, dest))
        return [sh.run(sub) for sh, sub in zip(self.shards, subs)]

    def _run_lockstep(self, trace: list[Request]) -> list:
        """Dynamic placements / outages: interleave shards on one clock.

        The fleet heap holds arrivals (priority 1) and outages (priority
        0: an outage at ``t`` strikes before arrivals at ``t`` are routed,
        so those arrivals already steer away from the dark shard).  Every
        iteration fires the globally earliest event — fleet events win
        time ties against shard events, shard ties break by index — so the
        interleave is a total order over exact ints.
        """
        for sh in self.shards:
            sh._begin([])
        fleet_events: list[tuple[int, int, int, str, object]] = []
        seq = 0
        for o in self.outages:
            heapq.heappush(fleet_events, (o.at, 0, seq, "outage", o))
            seq += 1
        for req in trace:
            heapq.heappush(fleet_events, (req.time, 1, seq, "arrival", req))
            seq += 1
        while True:
            t_fleet = fleet_events[0][0] if fleet_events else None
            t_shard, i_shard = None, None
            for i, sh in enumerate(self.shards):
                ti = sh._next_time()
                if ti is not None and (t_shard is None or ti < t_shard):
                    t_shard, i_shard = ti, i
            if t_fleet is None and t_shard is None:
                break
            if t_fleet is not None and (t_shard is None or t_fleet <= t_shard):
                now, _, _, kind, data = heapq.heappop(fleet_events)
                if kind == "outage":
                    self._apply_outage(data)
                else:
                    self._route_arrival(data, now)
            else:
                self.shards[i_shard]._step()
        return [sh._finish() for sh in self.shards]


def serve_fleet_trace(
    libraries: Sequence,
    trace: list[Request],
    admission: str = "accumulate",
    *,
    placement: str | PlacementStrategy | None = None,
    replica_map: ReplicaMap | None = None,
    outages: Sequence[ShardOutage] = (),
    journal: str | os.PathLike | None = None,
    qos: Mapping[int, QoSSpec] | None = None,
    **kwargs,
) -> FleetReport:
    """One-shot convenience: build a :class:`FleetServer` and run it."""
    fleet = FleetServer(
        libraries,
        admission,
        placement=placement,
        replica_map=replica_map,
        outages=outages,
        journal=journal,
        qos=qos,
        **kwargs,
    )
    return fleet.run(trace)


def recover_fleet(
    libraries: Sequence,
    trace: list[Request],
    journal: str | os.PathLike,
    admission: str = "accumulate",
    *,
    placement: str | PlacementStrategy | None = None,
    replica_map: ReplicaMap | None = None,
    outages: Sequence[ShardOutage] = (),
    qos: Mapping[int, QoSSpec] | None = None,
    **kwargs,
) -> FleetReport:
    """Resume a crashed federation from its per-shard journals.

    Each shard's ``<base>.shardNN`` journal is truncated to its valid
    prefix; the whole federation then re-executes from the start against
    the same ``(libraries, trace, configuration)`` — the fleet is
    deterministic, so re-execution *is* recovery — with every re-produced
    shard event cross-checked against its journaled prefix (divergence,
    or a journaled event never re-produced, raises
    :class:`~repro_torch.serving.faults.JournalReplayError`).  Past the
    prefixes the run continues live and appends, so every shard journal
    ends complete and **byte-identical** to the uninterrupted run's,
    whatever the cut point.
    """
    base = os.fspath(journal)
    fleet = FleetServer(
        libraries,
        admission,
        placement=placement,
        replica_map=replica_map,
        outages=outages,
        journal=None,
        qos=qos,
        **kwargs,
    )
    for i, sh in enumerate(fleet.shards):
        jr, expected = EventJournal.resume(shard_journal_path(base, i))
        sh._journal = jr
        sh._expect = deque(expected)
    report = fleet.run(trace)
    for i, sh in enumerate(fleet.shards):
        if sh._expect:
            raise JournalReplayError(
                f"shard {i}: {len(sh._expect)} journaled event(s) were never "
                f"re-produced: the journal does not belong to this "
                f"(libraries, trace, config)"
            )
    return report


def merge_journals(journal: str | os.PathLike, n_shards: int) -> list[dict]:
    """Flatten per-shard journals into one deterministic federation stream.

    Each event gains a ``shard`` key; ordering is a total order — start
    events first (by shard), timed events by ``(t, shard, per-shard
    position)``, end events last (by shard) — and preserves every shard's
    internal causal order, so merging the journals of two identical runs
    yields identical streams.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    rows: list[tuple[int, int, int, int, dict]] = []
    for i in range(n_shards):
        events = EventJournal.load(shard_journal_path(journal, i))
        for idx, ev in enumerate(events):
            kind = ev.get("ev")
            phase = 0 if kind == "start" else 2 if kind == "end" else 1
            rows.append((phase, int(ev.get("t", 0)), i, idx, {"shard": i, **ev}))
    rows.sort(key=lambda r: r[:4])
    return [r[4] for r in rows]
