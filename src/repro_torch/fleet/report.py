"""Merged federation accounting: per-shard reports -> one exact report.

:func:`merge_reports` folds the shards'
:class:`~repro_torch.serving.sim.ServiceReport` rows into a single federated
report — served/failed rows re-sorted under the same total orders the
single-server report uses, counters summed, horizon maximised, all exact
integers — so every downstream consumer (SLO accounting via
:func:`repro_torch.serving.qos.slo_report`, benchmark summaries, assertions)
reads a fleet exactly like it reads one server.  :class:`FleetReport`
carries the merged report next to the per-shard originals plus the
federation-level facts (placement, routing counts, cross-shard reroutes,
injected outages).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..serving.faults import ShardOutage
from ..serving.sim import ServiceReport

__all__ = ["FleetReport", "merge_reports"]


def _sum_dicts(dicts: list[dict | None]) -> dict | None:
    """Key-wise integer sum over the non-None dicts (union of keys)."""
    present = [d for d in dicts if d is not None]
    if not present:
        return None
    out: dict = {}
    for d in present:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def merge_reports(reports: Sequence[ServiceReport]) -> ServiceReport:
    """One federated :class:`~repro_torch.serving.sim.ServiceReport` from shards.

    The merge is exact and deterministic: served rows re-sort under the
    single-server order ``(completed, req_id)``, failed rows under
    ``(failed_at, req_id)``, batch rows concatenate in shard order,
    counters and pool/cache/fault statistics sum key-wise (conditional
    sections stay absent when absent on *every* shard, so a fault-free
    fleet report is key-for-key shaped like a fault-free single-server
    report), the horizon is the latest shard's, and the QoS map is the
    union — request ids are fleet-global, so
    :func:`repro_torch.serving.qos.slo_report` on the merged report yields the
    federation's exact-int quantiles directly.  Shards must agree on the
    run configuration (admission/policy/backend/window/scheduler/
    warm-start/selector); with a cache backend *shared* across shards,
    the summed cache statistics count that backend once per shard.
    """
    reports = list(reports)
    if not reports:
        raise ValueError("merge_reports needs at least one shard report")
    first = reports[0]
    for i, r in enumerate(reports[1:], start=1):
        for field in (
            "admission",
            "policy",
            "backend",
            "window",
            "scheduler",
            "warm_start",
            "selector",
        ):
            if getattr(r, field) != getattr(first, field):
                raise ValueError(
                    f"shard {i} disagrees on {field}: "
                    f"{getattr(r, field)!r} != {getattr(first, field)!r}"
                )
    qos: dict = {}
    for r in reports:
        if r.qos:
            qos.update(r.qos)
    return ServiceReport(
        admission=first.admission,
        policy=first.policy,
        backend=first.backend,
        window=first.window,
        served=sorted(
            (s for r in reports for s in r.served),
            key=lambda s: (s.completed, s.req_id),
        ),
        batches=[b for r in reports for b in r.batches],
        n_preemptions=sum(r.n_preemptions for r in reports),
        horizon=max(r.horizon for r in reports),
        cache_stats=_sum_dicts([r.cache_stats for r in reports]),
        pool_stats=_sum_dicts([r.pool_stats for r in reports]),
        scheduler=first.scheduler,
        qos=qos or None,
        warm_start=first.warm_start,
        failed=sorted(
            (f for r in reports for f in r.failed),
            key=lambda f: (f.failed_at, f.req_id),
        ),
        fault_stats=_sum_dicts([r.fault_stats for r in reports]),
        selector=first.selector,
    )


@dataclasses.dataclass(frozen=True)
class FleetReport:
    """Outcome of one federated serving run (per-shard + merged views)."""

    shards: tuple[ServiceReport, ...]
    merged: ServiceReport
    placement: str
    n_shards: int
    #: shard index -> requests the placement routed there (reroutes included)
    routes: dict[int, int]
    #: queued orphans re-routed cross-shard by outages (``faulted`` rows)
    n_rerouted: int
    outages: tuple[ShardOutage, ...] = ()

    # -- merged-view conveniences (exact ints) -------------------------------
    @property
    def n_served(self) -> int:
        return self.merged.n_served

    @property
    def n_failed(self) -> int:
        return self.merged.n_failed

    @property
    def total_sojourn(self) -> int:
        return self.merged.total_sojourn

    @property
    def n_missed(self) -> int:
        return self.merged.n_missed

    def summary(self) -> dict:
        """Machine-readable row: the merged summary plus federation facts."""
        out = self.merged.summary()
        out["fleet"] = {
            "n_shards": self.n_shards,
            "placement": self.placement,
            "routes": {str(k): v for k, v in sorted(self.routes.items())},
            "n_rerouted": self.n_rerouted,
            "n_outages": len(self.outages),
            "per_shard_served": [r.n_served for r in self.shards],
        }
        return out
