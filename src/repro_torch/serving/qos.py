"""QoS layer: per-request deadlines/priority classes and SLO reporting.

The paper's stated aim is improving the *quality of service* experienced by
users of tape storage systems, not only the peak performance; the
priority-/due-date-flavoured LTSP variants of Cardonha & Villa Real (2018)
and Cardonha, Cire & Villa Real (2021) ground the deadline model.  This
module is the request-facing half of that layer:

* :class:`QoSSpec` — one request's service-level contract: an (absolute,
  virtual-time) ``deadline`` and a ``qos_class`` label.  Specs are attached
  at ``enqueue`` time — :class:`~repro_torch.serving.queue.OnlineTapeServer` takes
  a ``qos`` mapping ``req_id -> QoSSpec`` next to the trace — so the request
  type itself (:class:`~repro_torch.serving.sim.Request`) and every QoS-unaware
  code path stay bit-identical.

* :class:`SLOReport` / :class:`ClassSLO` — derived from a
  :class:`~repro_torch.serving.sim.ServiceReport` by :func:`slo_report`: per-class
  and overall p50/p99 sojourn (exact nearest-rank integers, see
  :func:`int_quantile`), deadline-miss counts/rate, and total/max lateness.
  Everything except the float ``miss_rate`` convenience is exact-int virtual
  time, safe to assert on.  When serving ran under fault injection
  (:mod:`repro_torch.serving.faults`), ``n_missed_faulted`` attributes deadline
  misses to requests a fault touched (retried mount, media abort, drive
  failover requeue) so operators can separate SLO debt caused by hardware
  events from scheduling debt.

The deadline-aware admissions themselves (``edf-global``,
``slack-accumulate``) live with the other admission policies in
:mod:`repro_torch.serving.queue`; the deadline-aware mount scheduling
(``lookahead``) with the other :class:`~repro_torch.serving.drives.MountScheduler`
implementations in :mod:`repro_torch.serving.drives`.  QoS is opt-in everywhere:
with no ``qos`` mapping and the default scheduler, serving reproduces the
QoS-less behaviour bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

from .sim import ServiceReport

__all__ = [
    "DEFAULT_CLASS",
    "QoSSpec",
    "ClassSLO",
    "SLOReport",
    "slo_report",
    "int_quantile",
]

#: class label a request gets when no spec (or no class) is attached.
DEFAULT_CLASS = "default"


@dataclasses.dataclass(frozen=True)
class QoSSpec:
    """One request's service-level contract (attached at ``enqueue``).

    ``deadline`` is an *absolute* virtual-time instant (same exact-integer
    clock as the simulator): the request's service level is met iff its
    completion lands at or before it.  ``None`` means best-effort — the
    request never counts toward deadline-miss statistics.  ``qos_class`` is
    a free-form label used only for grouping in the :class:`SLOReport`.
    """

    deadline: int | None = None
    qos_class: str = DEFAULT_CLASS

    def __post_init__(self) -> None:
        if self.deadline is not None and self.deadline < 0:
            raise ValueError("deadline must be an absolute virtual time >= 0")
        if not self.qos_class:
            raise ValueError("qos_class must be a non-empty label")

    def slack(self, now: int) -> int | None:
        """Remaining slack at ``now`` (negative once the deadline passed)."""
        return None if self.deadline is None else self.deadline - now


def int_quantile(values: Iterable[int], num: int, den: int) -> int:
    """Exact nearest-rank quantile of integer ``values`` (no floats).

    Returns the smallest element whose rank is >= ``ceil(num/den * n)``
    (the classic nearest-rank definition), computed entirely in integer
    arithmetic so p50/p99 of virtual times are assertable exactly.  An empty
    input returns 0.
    """
    if not (0 <= num <= den) or den <= 0:
        raise ValueError(f"quantile {num}/{den} out of [0, 1]")
    ordered = sorted(values)
    if not ordered:
        return 0
    rank = -(-num * len(ordered) // den)  # ceil without floats
    return ordered[max(rank, 1) - 1]


@dataclasses.dataclass(frozen=True)
class ClassSLO:
    """SLO aggregates for one QoS class (all virtual-time ints exact).

    ``n_deadlines``/``n_missed`` count *dropped* deadline-carrying requests
    too: a request the fault layer dropped never completes, which is the
    definitive way to miss a deadline — before this accounting a class whose
    deadline work was entirely dropped vanished from the report with a
    vacuous 0.0 miss rate.  Dropped requests have no completion instant, so
    they contribute to no sojourn quantile or lateness aggregate.
    """

    qos_class: str
    n: int  # served requests in this class
    p50_sojourn: int  # nearest-rank, exact (over served requests)
    p99_sojourn: int  # nearest-rank, exact (over served requests)
    n_deadlines: int  # requests that carried a deadline (served + dropped)
    n_missed: int  # completed strictly after their deadline, or dropped
    total_lateness: int  # sum of max(0, completed - deadline); served only
    max_lateness: int
    n_missed_faulted: int = 0  # misses on requests a fault touched (retry/requeue)
    n_failed: int = 0  # requests the fault layer dropped (never completed)

    @property
    def miss_rate(self) -> float:
        """Fraction of deadline-carrying requests late or dropped (0.0 if none)."""
        return self.n_missed / self.n_deadlines if self.n_deadlines else 0.0


@dataclasses.dataclass(frozen=True)
class SLOReport:
    """Per-class + overall SLO view of one serving run.

    Derived from a :class:`~repro_torch.serving.sim.ServiceReport` by
    :func:`slo_report`; ``overall`` aggregates every served request (class
    label ``"*"``), ``classes`` holds one :class:`ClassSLO` per observed
    class, sorted by name.
    """

    admission: str
    scheduler: str
    overall: ClassSLO
    classes: tuple[ClassSLO, ...]

    @property
    def n_missed(self) -> int:
        return self.overall.n_missed

    @property
    def n_deadlines(self) -> int:
        return self.overall.n_deadlines

    @property
    def miss_rate(self) -> float:
        return self.overall.miss_rate

    @property
    def n_missed_faulted(self) -> int:
        """Deadline misses on requests that a fault touched (retry/requeue)."""
        return self.overall.n_missed_faulted

    @property
    def n_failed(self) -> int:
        """Requests the fault layer dropped (deadline-carrying ones count missed)."""
        return self.overall.n_failed

    def for_class(self, qos_class: str) -> ClassSLO:
        for c in self.classes:
            if c.qos_class == qos_class:
                return c
        raise KeyError(f"no served requests in class {qos_class!r}")

    def summary(self) -> dict:
        """Machine-readable row for benchmarks and launchers."""
        return {
            "admission": self.admission,
            "scheduler": self.scheduler,
            "n_served": self.overall.n,
            "n_deadlines": self.n_deadlines,
            "n_missed": self.n_missed,
            "n_missed_faulted": self.n_missed_faulted,
            "n_failed": self.n_failed,
            "miss_rate": self.miss_rate,
            "p50_sojourn": self.overall.p50_sojourn,
            "p99_sojourn": self.overall.p99_sojourn,
            "total_lateness": self.overall.total_lateness,
            "max_lateness": self.overall.max_lateness,
            "classes": {
                c.qos_class: {
                    "n": c.n,
                    "p50_sojourn": c.p50_sojourn,
                    "p99_sojourn": c.p99_sojourn,
                    "n_missed": c.n_missed,
                    "n_failed": c.n_failed,
                    "miss_rate": c.miss_rate,
                    "max_lateness": c.max_lateness,
                }
                for c in self.classes
            },
        }


def _class_slo(
    label: str,
    rows: Sequence[tuple[int, int | None, bool]],
    n_failed: int = 0,
    n_failed_deadlines: int = 0,
) -> ClassSLO:
    """Aggregate ``(sojourn, lateness-or-None, faulted)`` rows into one ClassSLO.

    ``n_failed``/``n_failed_deadlines`` fold in the class's dropped
    requests: every dropped deadline-carrying request is a miss (it will
    never complete), but contributes no sojourn or lateness.
    """
    sojourns = [s for s, _, _ in rows]
    late = [(l, f) for _, l, f in rows if l is not None]
    return ClassSLO(
        qos_class=label,
        n=len(rows),
        p50_sojourn=int_quantile(sojourns, 1, 2),
        p99_sojourn=int_quantile(sojourns, 99, 100),
        n_deadlines=len(late) + n_failed_deadlines,
        n_missed=sum(1 for l, _ in late if l > 0) + n_failed_deadlines,
        total_lateness=sum(l for l, _ in late if l > 0),
        max_lateness=max((l for l, _ in late if l > 0), default=0),
        n_missed_faulted=sum(1 for l, f in late if l > 0 and f),
        n_failed=n_failed,
    )


def slo_report(
    report: ServiceReport, qos: Mapping[int, QoSSpec] | None = None
) -> SLOReport:
    """Join a service report against its QoS map into per-class SLO stats.

    ``qos`` defaults to the map the server recorded on the report (a run
    without QoS yields an all-best-effort report: 0 deadlines, 0 misses).
    Requests absent from the map count as best-effort ``default``-class.

    Requests the fault layer *dropped* (``report.failed``) are joined too:
    a dropped deadline-carrying request counts as a deadline and a miss in
    its class (it will never complete), so a class whose deadline work was
    entirely dropped still appears — with a 1.0 miss rate instead of
    silently vanishing from the report.
    """
    specs: Mapping[int, QoSSpec] = (
        qos if qos is not None else (report.qos or {})
    )
    default = QoSSpec()
    per_class: dict[str, list[tuple[int, int | None, bool]]] = {}
    everything: list[tuple[int, int | None, bool]] = []
    for r in report.served:
        spec = specs.get(r.req_id, default)
        lateness = None if spec.deadline is None else r.completed - spec.deadline
        row = (r.sojourn, lateness, r.faulted)
        per_class.setdefault(spec.qos_class, []).append(row)
        everything.append(row)
    failed_by_class: dict[str, tuple[int, int]] = {}  # cls -> (n, n_deadlines)
    n_failed = n_failed_deadlines = 0
    for f in getattr(report, "failed", ()) or ():
        spec = specs.get(f.req_id, default)
        has_deadline = int(spec.deadline is not None)
        n, nd = failed_by_class.get(spec.qos_class, (0, 0))
        failed_by_class[spec.qos_class] = (n + 1, nd + has_deadline)
        per_class.setdefault(spec.qos_class, [])  # class appears even if 0 served
        n_failed += 1
        n_failed_deadlines += has_deadline
    return SLOReport(
        admission=report.admission,
        scheduler=report.scheduler,
        overall=_class_slo("*", everything, n_failed, n_failed_deadlines),
        classes=tuple(
            _class_slo(name, rows, *failed_by_class.get(name, (0, 0)))
            for name, rows in sorted(per_class.items())
        ),
    )
