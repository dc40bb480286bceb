"""Observability: virtual-time tracing, exact-int metrics, and exporters.

The serving stack reports quality of service *after the fact*
(:class:`~repro_torch.serving.sim.ServiceReport`, ``slo_report``); this package
shows **where virtual time and solve work go inside a run** — mount legs
vs seek legs vs solve delay vs retry backoff, per drive and per shard —
without perturbing a single byte of it.

Observability
-------------
Everything hangs off one opt-in :class:`Observability` bundle, attached
through :class:`~repro_torch.core.context.ExecutionContext` (``obs=`` field,
``context.replace(obs=Observability.enabled())``):

* :class:`~repro_torch.obs.trace.Tracer` — spans/events keyed by the exact
  virtual-time integer clock (optional wall-clock stamps); the
  :class:`~repro_torch.obs.trace.NullTracer` no-op and the unset default are
  both pinned bit-identical to an uninstrumented run.
* :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters / gauges /
  exact-int histograms (nearest-rank quantiles via
  :func:`repro_torch.serving.qos.int_quantile`), fed by hooks in the solver
  (per-policy solves, cells, selector decisions, degradation fallbacks),
  the cache (hits/misses/evictions per backend), the drive pool
  (mount/unmount/evict legs, failures), the event loop (arrivals, queue
  depth, batch dispatches, retry backoff, fault events), and the fleet
  (routing, re-routes, outages, per-shard rollups).
* :class:`~repro_torch.obs.kernel.KernelProfile` — per-launch device records:
  bucket shape, exact real-vs-padded cell counts (padding waste), and
  compile-vs-execute wall time.
* :mod:`~repro_torch.obs.export` — a byte-deterministic JSONL span log, a
  Prometheus text snapshot whose integers match the report types exactly,
  and a Chrome ``trace_event`` JSON (one lane per drive, one process per
  shard, virtual microseconds) loadable in Perfetto.

Every hook is guarded by ``obs is not None`` and hands over
already-computed exact integers: with ``obs`` unset the instrumented code
paths are pinned bit-identical (timelines, journals, benchmark records)
to the uninstrumented stack — gated by ``tests/test_obs.py``.
"""

from __future__ import annotations

import dataclasses

from .export import (
    chrome_trace,
    prometheus_text,
    spans_jsonl,
    write_chrome_trace,
    write_prometheus,
    write_spans_jsonl,
)
from .kernel import KernelProfile, LaunchRecord
from .metrics import MetricsRegistry
from .trace import NullTracer, Span, Tracer

__all__ = [
    "Observability",
    "Tracer",
    "NullTracer",
    "Span",
    "MetricsRegistry",
    "KernelProfile",
    "LaunchRecord",
    "spans_jsonl",
    "write_spans_jsonl",
    "prometheus_text",
    "write_prometheus",
    "chrome_trace",
    "write_chrome_trace",
]


@dataclasses.dataclass
class Observability:
    """The opt-in bundle a context carries: tracer + metrics + kernel profile.

    Any part may be ``None`` (that aspect records nothing); the
    convenience recorders below are safe to call either way, so
    instrumentation sites need exactly one guard: ``if obs is not None``.
    The all-``None`` default bundle is as much of a no-op as not attaching
    one at all.
    """

    tracer: Tracer | None = None
    metrics: MetricsRegistry | None = None
    kernel: KernelProfile | None = None

    @classmethod
    def enabled(cls, *, wall: bool = False) -> "Observability":
        """A fully-armed bundle (wall-clock span stamps opt-in)."""
        return cls(
            tracer=Tracer(wall=wall),
            metrics=MetricsRegistry(),
            kernel=KernelProfile(wall=wall),
        )

    # -- no-op-safe recorders ----------------------------------------------
    def span(self, name: str, t0: int, t1: int, **kwargs) -> None:
        if self.tracer is not None:
            self.tracer.span(name, t0, t1, **kwargs)

    def event(self, name: str, t: int, **kwargs) -> None:
        if self.tracer is not None:
            self.tracer.event(name, t, **kwargs)

    def inc(self, name: str, value: int = 1, **labels: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, value, **labels)

    def gauge(self, name: str, value: int, **labels: str) -> None:
        if self.metrics is not None:
            self.metrics.gauge(name, value, **labels)

    def observe(self, name: str, value: int, **labels: str) -> None:
        if self.metrics is not None:
            self.metrics.observe(name, value, **labels)
