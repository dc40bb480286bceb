"""Fleet federation: sharded multi-library serving on one exact clock.

The serving stack (:mod:`repro_torch.serving`) simulates *one* robotic tape
library.  This package federates N of them — each shard an unmodified
:class:`~repro_torch.serving.queue.OnlineTapeServer` over its own
:class:`~repro_torch.storage.tape.TapeLibrary` — behind a single arrival stream
in shared exact virtual time:

* :mod:`~repro_torch.fleet.placement` — :class:`ReplicaMap` (logical file ->
  replica-holding shards, validated against the libraries) and the
  :class:`PlacementStrategy` protocol + registry: ``single`` (one-shard
  NoOp default, pinned bit-identical to a standalone server),
  ``static-hash``, ``least-loaded``, and ``replica-affinity`` (queue depth
  x drive health x remount cost);
* :mod:`~repro_torch.fleet.server` — :class:`FleetServer` /
  :func:`serve_fleet_trace` (static pre-partition or lock-step interleave),
  :class:`~repro_torch.serving.faults.ShardOutage` handling with cross-shard
  requeue of orphaned replicas, per-shard write-ahead journals with
  :func:`recover_fleet` (byte-identical redo recovery from any cut point)
  and :func:`merge_journals`, plus the :func:`demo_fleet` seeded archive
  and :func:`fleet_catalog` trace-generation facade;
* :mod:`~repro_torch.fleet.report` — :func:`merge_reports` /
  :class:`FleetReport`: one federated
  :class:`~repro_torch.serving.sim.ServiceReport` with exact-int merged
  accounting, feeding :func:`repro_torch.serving.qos.slo_report` unchanged.

Everything is exact-integer and deterministic: same trace + same federation
configuration => bit-identical routing, timelines, journals, and reports.
"""

from .placement import (
    PLACEMENTS,
    FleetView,
    LeastLoadedPlacement,
    PlacementStrategy,
    ReplicaAffinityPlacement,
    ReplicaMap,
    ShardView,
    SinglePlacement,
    StaticHashPlacement,
    get_placement,
    list_placements,
    register_placement,
)
from .report import FleetReport, merge_reports
from .server import (
    FleetServer,
    demo_fleet,
    fleet_catalog,
    merge_journals,
    recover_fleet,
    serve_fleet_trace,
    shard_journal_path,
)

__all__ = [
    "PLACEMENTS",
    "FleetView",
    "ShardView",
    "PlacementStrategy",
    "SinglePlacement",
    "StaticHashPlacement",
    "LeastLoadedPlacement",
    "ReplicaAffinityPlacement",
    "ReplicaMap",
    "register_placement",
    "get_placement",
    "list_placements",
    "FleetReport",
    "merge_reports",
    "FleetServer",
    "serve_fleet_trace",
    "recover_fleet",
    "merge_journals",
    "shard_journal_path",
    "demo_fleet",
    "fleet_catalog",
]
