"""Virtual-time tracing: structured spans/events on the simulator's clock.

A :class:`Tracer` collects :class:`Span` records keyed by the serving
stack's **exact virtual time** — the same integer clock every event loop,
drive leg, and solve delay runs on — so a trace of a run is as
deterministic as the run itself.  Wall-clock capture is opt-in
(``Tracer(wall=True)`` stamps each span with ``perf_counter_ns``); with it
off (the default) the span stream of two identical seeded runs is
byte-identical through :func:`repro_torch.obs.export.spans_jsonl`.

:class:`NullTracer` is the pinned no-op: every recording method is a
``pass``, so attaching one (or attaching nothing at all — the
``ExecutionContext.obs`` default is ``None``) leaves every timeline,
journal, and report bit-identical to an uninstrumented run.

Spans carry a ``track`` (one per drive / queue / router — the Chrome
trace exporter renders one thread lane per track) and a ``shard`` (the
fleet sets it per federated server; standalone runs use shard 0, which
the exporters render as one process).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping

__all__ = ["Span", "Tracer", "NullTracer"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One traced interval (or instant, when ``t0 == t1``) of virtual time.

    ``t0``/``t1`` are exact virtual-time integers; ``seq`` is the tracer's
    emission index (a total order even among zero-length spans at the same
    instant); ``attrs`` holds free-form JSON-serialisable attributes
    (tape ids, policies, exact cell counts).  ``wall_ns`` is only stamped
    when the tracer was built with ``wall=True``.
    """

    name: str
    t0: int
    t1: int
    cat: str = "serving"
    track: str = "main"
    shard: int = 0
    seq: int = 0
    attrs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    wall_ns: int | None = None

    @property
    def duration(self) -> int:
        return self.t1 - self.t0

    @property
    def instant(self) -> bool:
        return self.t0 == self.t1


class Tracer:
    """Collects spans/events in emission order (deterministic per run).

    Recording never inspects or mutates the run it observes: hooks hand it
    already-computed exact integers, so an attached tracer cannot perturb
    virtual time, journal bytes, or schedules.
    """

    def __init__(self, *, wall: bool = False):
        self.wall = bool(wall)
        self.spans: list[Span] = []
        self._seq = 0

    def span(
        self,
        name: str,
        t0: int,
        t1: int,
        *,
        cat: str = "serving",
        track: str = "main",
        shard: int = 0,
        **attrs: Any,
    ) -> None:
        """Record a completed virtual-time interval ``[t0, t1]``."""
        if t1 < t0:
            raise ValueError(f"span {name!r} ends before it starts: {t0} > {t1}")
        self.spans.append(
            Span(
                name=name,
                t0=int(t0),
                t1=int(t1),
                cat=cat,
                track=track,
                shard=int(shard),
                seq=self._seq,
                attrs=attrs,
                wall_ns=time.perf_counter_ns() if self.wall else None,
            )
        )
        self._seq += 1

    def event(
        self,
        name: str,
        t: int,
        *,
        cat: str = "serving",
        track: str = "main",
        shard: int = 0,
        **attrs: Any,
    ) -> None:
        """Record an instantaneous event (a zero-length span)."""
        self.span(name, t, t, cat=cat, track=track, shard=shard, **attrs)

    def __len__(self) -> int:
        return len(self.spans)


class NullTracer(Tracer):
    """The no-op tracer: accepts every call, records nothing.

    Attaching one is indistinguishable (bit for bit) from attaching no
    tracer at all — pinned by ``tests/test_obs.py``.
    """

    def span(self, name, t0, t1, **kwargs) -> None:  # noqa: D102
        return None

    def event(self, name, t, **kwargs) -> None:  # noqa: D102
        return None
