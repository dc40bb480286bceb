"""Exact-integer metrics: counters, gauges, and nearest-rank histograms.

Everything a :class:`MetricsRegistry` holds is an exact Python integer on
the serving stack's virtual-time scale (sojourns, cells, backoff charges,
queue depths) — never a float — so metric values can be asserted with
``==`` against :class:`~repro_torch.serving.sim.ServiceReport` /
:class:`~repro_torch.serving.qos.SLOReport` fields.  Histogram quantiles reuse
:func:`repro_torch.serving.qos.int_quantile` (exact nearest-rank, no floats),
so a scraped ``p99`` equals the SLO report's ``p99_sojourn`` bit for bit.

Metrics are keyed by ``(name, sorted label items)``; the rendered form
(``name{k="v",...}``) matches the Prometheus text exposition the exporter
emits, and every iteration order is sorted, so snapshots are
byte-deterministic.
"""

from __future__ import annotations

from typing import Iterator

__all__ = ["MetricsRegistry", "metric_key"]

_Key = tuple[str, tuple[tuple[str, str], ...]]


def metric_key(name: str, labels: dict[str, str]) -> _Key:
    """Canonical registry key: name + label items sorted by label name."""
    return (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))


def _render(key: _Key) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


def _check_int(name: str, value) -> int:
    if isinstance(value, bool) or not isinstance(value, int):
        raise TypeError(
            f"metric {name!r} takes exact integers, got {value!r} "
            f"({type(value).__name__}) — convert wall times to integer "
            f"microseconds/nanoseconds before recording"
        )
    return value


class MetricsRegistry:
    """Counters / gauges / exact-int histograms behind one scrape surface.

    * ``inc(name, value=1, **labels)`` — monotonic counter (value >= 0);
    * ``gauge(name, value, **labels)`` — last-write-wins point value;
    * ``observe(name, value, **labels)`` — histogram sample (all samples
      retained, so any nearest-rank quantile is exact).

    Readbacks: :meth:`counter`, :meth:`gauge_value`, :meth:`samples`,
    :meth:`quantile`, and the deterministic :meth:`snapshot`.
    """

    def __init__(self) -> None:
        self._counters: dict[_Key, int] = {}
        self._gauges: dict[_Key, int] = {}
        self._hists: dict[_Key, list[int]] = {}

    # -- recording ----------------------------------------------------------
    def inc(self, name: str, value: int = 1, **labels: str) -> None:
        value = _check_int(name, value)
        if value < 0:
            raise ValueError(f"counter {name!r} cannot decrease (got {value})")
        key = metric_key(name, labels)
        self._counters[key] = self._counters.get(key, 0) + value

    def gauge(self, name: str, value: int, **labels: str) -> None:
        self._gauges[metric_key(name, labels)] = _check_int(name, value)

    def observe(self, name: str, value: int, **labels: str) -> None:
        self._hists.setdefault(metric_key(name, labels), []).append(
            _check_int(name, value)
        )

    # -- readback -----------------------------------------------------------
    def counter(self, name: str, **labels: str) -> int:
        return self._counters.get(metric_key(name, labels), 0)

    def gauge_value(self, name: str, **labels: str) -> int | None:
        return self._gauges.get(metric_key(name, labels))

    def samples(self, name: str, **labels: str) -> list[int]:
        return list(self._hists.get(metric_key(name, labels), ()))

    def quantile(self, name: str, num: int, den: int, **labels: str) -> int:
        """Exact nearest-rank ``num/den`` quantile of a histogram (0 if empty)."""
        from ..serving.qos import int_quantile  # lazy: avoids an import cycle

        return int_quantile(self._hists.get(metric_key(name, labels), ()), num, den)

    def counters_named(self, name: str) -> Iterator[tuple[_Key, int]]:
        """All counter series sharing ``name`` (sorted by labels)."""
        for key in sorted(self._counters):
            if key[0] == name:
                yield key, self._counters[key]

    def __len__(self) -> int:
        return len(self._counters) + len(self._gauges) + len(self._hists)

    # -- snapshots ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain nested dict of everything, deterministically ordered.

        Histograms summarise to exact ``count``/``sum``/``min``/``max`` and
        nearest-rank p50/p95/p99 (the raw samples stay queryable via
        :meth:`samples`).
        """
        from ..serving.qos import int_quantile  # lazy: avoids an import cycle

        hists = {}
        for key in sorted(self._hists):
            vs = self._hists[key]
            hists[_render(key)] = {
                "count": len(vs),
                "sum": sum(vs),
                "min": min(vs) if vs else 0,
                "max": max(vs) if vs else 0,
                "p50": int_quantile(vs, 1, 2),
                "p95": int_quantile(vs, 95, 100),
                "p99": int_quantile(vs, 99, 100),
            }
        return {
            "counters": {_render(k): self._counters[k] for k in sorted(self._counters)},
            "gauges": {_render(k): self._gauges[k] for k in sorted(self._gauges)},
            "histograms": hists,
        }

    def render_key(self, key: _Key) -> str:
        return _render(key)
