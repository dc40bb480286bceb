"""Exporters: JSONL span logs, Prometheus text, Chrome ``trace_event`` JSON.

Three machine-readable views of one instrumented run:

* :func:`spans_jsonl` — one sorted-key JSON object per line, in span
  emission order.  With wall-clock capture off (the tracer default) the
  bytes are fully determined by the run's exact virtual-time events, so
  two identical seeded runs export **byte-identical** logs (gated in CI).
* :func:`prometheus_text` — the classic text exposition of a
  :class:`~repro_torch.obs.metrics.MetricsRegistry`: counters and gauges as
  ``name{labels} value`` lines, histograms as exact nearest-rank
  summaries (``quantile="0.5"/"0.95"/"0.99"`` plus ``_sum``/``_count``).
  Every value is an exact integer; series are sorted, so the snapshot is
  byte-deterministic too.
* :func:`chrome_trace` — the Chrome ``trace_event`` format (loadable in
  Perfetto / ``chrome://tracing``): one *process* per fleet shard, one
  *thread lane* per span track (one per drive, plus queue/router lanes),
  timestamps in **virtual microseconds** (``ts``/``dur`` are the exact
  virtual-time integers; the UI's microsecond unit is nominal).  With
  ``host=`` (a :class:`~repro_torch.obs.trace.HostTracer`) the host-clock
  spans join in a process lane of their own, ``ts`` in host-clock
  microseconds (Unix epoch, a ``torch.profiler`` trace's clock), so the
  document loads beside a profiler trace.
"""

from __future__ import annotations

import json
import os

from .metrics import MetricsRegistry
from .trace import HostTracer, Span, Tracer

__all__ = [
    "spans_jsonl",
    "write_spans_jsonl",
    "prometheus_text",
    "write_prometheus",
    "chrome_trace",
    "write_chrome_trace",
]


# ---------------------------------------------------------------------------
# JSONL span log
# ---------------------------------------------------------------------------
def _span_row(s: Span) -> dict:
    row = {
        "name": s.name,
        "cat": s.cat,
        "t0": s.t0,
        "t1": s.t1,
        "track": s.track,
        "shard": s.shard,
        "seq": s.seq,
        "attrs": dict(s.attrs),
    }
    if s.wall_ns is not None:
        row["wall_ns"] = s.wall_ns
    return row


def spans_jsonl(tracer: Tracer) -> str:
    """The tracer's spans as JSONL (sorted keys, emission order)."""
    return "".join(
        json.dumps(_span_row(s), sort_keys=True, separators=(",", ":")) + "\n"
        for s in tracer.spans
    )


def write_spans_jsonl(tracer: Tracer, path: str | os.PathLike) -> int:
    """Write the JSONL span log; returns the number of spans written."""
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(spans_jsonl(tracer))
    return len(tracer.spans)


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------
def _labelled(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry in the Prometheus text exposition format.

    Counters keep their monotonic totals, gauges their last write, and
    each histogram series becomes a summary: exact nearest-rank p50/p95/p99
    (``quantile`` label) plus ``_sum`` and ``_count``.  All integers, all
    series sorted — the output is byte-deterministic.
    """
    from ..serving.qos import int_quantile  # lazy: avoids an import cycle

    lines: list[str] = []
    typed: set[str] = set()

    def head(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for (name, labels), value in sorted(registry._counters.items()):
        head(name, "counter")
        lines.append(f"{_labelled(name, labels)} {value}")
    for (name, labels), value in sorted(registry._gauges.items()):
        head(name, "gauge")
        lines.append(f"{_labelled(name, labels)} {value}")
    for (name, labels), values in sorted(registry._hists.items()):
        head(name, "summary")
        for q_label, num, den in (("0.5", 1, 2), ("0.95", 95, 100), ("0.99", 99, 100)):
            q_labels = labels + (("quantile", q_label),)
            lines.append(f"{_labelled(name, q_labels)} {int_quantile(values, num, den)}")
        lines.append(f"{_labelled(name + '_sum', labels)} {sum(values)}")
        lines.append(f"{_labelled(name + '_count', labels)} {len(values)}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(registry: MetricsRegistry, path: str | os.PathLike) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(prometheus_text(registry))


# ---------------------------------------------------------------------------
# Chrome trace_event JSON (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------
def chrome_trace(tracer: Tracer | None, host: HostTracer | None = None) -> dict:
    """The tracer's spans in Chrome ``trace_event`` form.

    One *process* (``pid``) per shard, one *thread* (``tid``) per distinct
    span track within a shard — so a drive-pool run renders one lane per
    drive.  Complete spans emit ``ph: "X"`` with ``ts``/``dur`` in virtual
    microseconds; instants emit thread-scoped ``ph: "i"`` marks.  Metadata
    records name every process/lane, and all ordering is deterministic.
    ``host``'s spans follow in one more process, ``host``, a lane per
    thread, ``ts``/``dur`` in host-clock microseconds, each span's ``seq``,
    ``parent`` and ``solve`` among its ``args``; without it the document is
    the virtual-time one alone.
    """
    spans = tracer.spans if tracer is not None else []
    tracks: dict[int, list[str]] = {}
    for s in spans:
        names = tracks.setdefault(s.shard, [])
        if s.track not in names:
            names.append(s.track)
    for names in tracks.values():
        names.sort()

    events: list[dict] = []
    for shard in sorted(tracks):
        events.append(
            {
                "ph": "M",
                "pid": shard,
                "tid": 0,
                "name": "process_name",
                "args": {"name": f"shard{shard}"},
            }
        )
        for tid, track in enumerate(tracks[shard]):
            events.append(
                {
                    "ph": "M",
                    "pid": shard,
                    "tid": tid,
                    "name": "thread_name",
                    "args": {"name": track},
                }
            )
    for s in spans:
        tid = tracks[s.shard].index(s.track)
        ev = {
            "name": s.name,
            "cat": s.cat,
            "pid": s.shard,
            "tid": tid,
            "ts": s.t0,
            "args": dict(s.attrs),
        }
        if s.instant:
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = s.duration
        events.append(ev)
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"clock": "virtual-microseconds"},
    }
    if host is not None:
        _add_host_lane(doc, host)
    return doc


def _add_host_lane(doc: dict, host: HostTracer) -> None:
    events = doc["traceEvents"]
    pid = 1 + max((e["pid"] for e in events), default=-1)
    lanes = sorted({s.track for s in host.spans})
    events.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                   "args": {"name": "host"}})
    for tid, lane in enumerate(lanes):
        events.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                       "args": {"name": lane}})
    for s in sorted(host.spans, key=lambda s: s.seq):
        events.append({
            "name": s.name, "cat": s.cat, "ph": "X", "pid": pid, "tid": lanes.index(s.track),
            "ts": s.t0 / 1e3, "dur": (s.t1 - s.t0) / 1e3,
            "args": {**s.attrs, "seq": s.seq, "parent": s.parent, "solve": s.solve},
        })
    doc["otherData"]["host_clock"] = "unix-epoch-microseconds"
    doc["otherData"]["host_dropped"] = host.dropped


def write_chrome_trace(tracer: Tracer | None, path: str | os.PathLike,
                       host: HostTracer | None = None) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(chrome_trace(tracer, host), fh, sort_keys=True, separators=(",", ":"))
        fh.write("\n")
