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

Host clock
----------
:data:`HOST_SPANS`, a :class:`HostTracer`, is the process's one log of
spans on the **host clock** (``time.time_ns``, the clock of a
``torch.profiler`` trace's events): the solve path's layer boundaries
(``ltsp.solve`` → ``ltsp.prepare`` / ``ltsp.tables`` / ``ltsp.wait`` /
``ltsp.traceback`` / ``ltsp.finish``, and ``ltsp.dispatch`` above a
served solve), read back as :class:`Span` records.  It records only while
armed: while a ``torch.profiler`` session records (each span then also
opens a profiler range of its name, so it lands among the trace's host
events), or inside :meth:`HostTracer.recording`.  Unarmed, a span site
costs one check and returns :data:`NULL_SPAN`.  It never shares a span
with the virtual-time tracers above, whose exports stay byte-deterministic.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Mapping

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

__all__ = ["Span", "Tracer", "NullTracer", "HostTracer", "HOST_SPANS", "HOST_SPANS_KEPT",
           "NULL_SPAN"]


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
    #: host-clock spans only: the ``seq`` of the enclosing span, and the id
    #: of the solve (or dispatch) the span belongs to, shared by its tree
    parent: int | None = None
    solve: int | None = None

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


class _NullSpan:
    """What an unarmed span site gets: false, and a no-op context."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


#: the one object every unarmed span site shares
NULL_SPAN = _NullSpan()

#: how many of the newest host-clock spans a :class:`HostTracer` keeps
HOST_SPANS_KEPT = 65_536


class _OpenSpan:
    """A host-clock span being recorded; ``attrs`` may be filled while it
    is open (and after: the kept record shares the dict)."""

    __slots__ = ("log", "name", "range", "attrs", "seq", "parent", "solve", "track", "t0")

    def __init__(self, log: "HostTracer", name: str, profiled: bool):
        self.log, self.name = log, name
        self.range = _RecordFunctionFast(name) if profiled else None
        self.attrs: dict[str, Any] = {}

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "_OpenSpan":
        if self.range is not None:
            self.range.__enter__()
        log = self.log
        stack, self.track = log._thread()
        self.seq = log._seq
        log._seq += 1
        if stack:
            self.parent, self.solve = stack[-1].seq, stack[-1].solve
        else:
            log._solves += 1
            self.parent, self.solve = None, log._solves
        stack.append(self)
        log._n_open += 1
        self.t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.time_ns()
        log = self.log
        log._thread()[0].pop()
        log._n_open -= 1
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        kept = log._kept
        if len(kept) == HOST_SPANS_KEPT:
            log.dropped += 1
        # a plain tuple: the Span is built only when the log is read
        kept.append((self.name, self.t0, t1, self.track, self.seq, self.attrs,
                     self.parent, self.solve))
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)


class HostTracer:
    """Spans on the host clock (``time.time_ns`` nanoseconds), nested.

    ``with log.open(name) as sp:`` records one span around the block when
    the log is armed; its ``parent`` is the span open around it on the
    same thread, and a span opened with none around it starts a new solve
    id that its whole tree shares.  A site fills attributes only under
    ``if sp:``, so an unarmed site computes none.  :meth:`count_copy` adds
    a host↔device copy and its bytes to the innermost open span.

    The log keeps the newest :data:`HOST_SPANS_KEPT` spans in closing
    order (children before their parent) and counts the older ones it
    dropped in ``dropped``; :attr:`spans` reads them as :class:`Span`
    records (``cat="host"``, ``track`` the thread's name), which the
    exporters of :mod:`repro_torch.obs.export` take.
    """

    def __init__(self):
        self._kept: collections.deque[tuple] = collections.deque(maxlen=HOST_SPANS_KEPT)
        self.dropped = 0
        self._explicit = 0
        self._n_open = 0
        self._seq = 0
        self._solves = 0
        self._local = threading.local()

    def open(self, name: str):
        """The span ``name`` around a ``with`` block: a new open span when
        armed, else :data:`NULL_SPAN`."""
        profiled = _profiler_enabled()
        if not (profiled or self._explicit):
            return NULL_SPAN
        return _OpenSpan(self, name, profiled)

    @contextlib.contextmanager
    def recording(self):
        """Arm the log for the block, without a profiler (nests)."""
        self._explicit += 1
        try:
            yield self
        finally:
            self._explicit -= 1

    def count_copy(self, tensor) -> None:
        """One copy of ``tensor`` between host and device, charged to the
        innermost open span (``copies``, ``bytes``); nothing when none is."""
        if not self._n_open:
            return
        stack = self._thread()[0]
        if stack:
            attrs = stack[-1].attrs
            attrs["copies"] = attrs.get("copies", 0) + 1
            attrs["bytes"] = attrs.get("bytes", 0) + tensor.numel() * tensor.element_size()

    @property
    def spans(self) -> list[Span]:
        """The kept spans, in closing order."""
        return [Span(name=name, t0=t0, t1=t1, cat="host", track=track, seq=seq, attrs=attrs,
                     parent=parent, solve=solve)
                for name, t0, t1, track, seq, attrs, parent, solve in self._kept]

    def clear(self) -> None:
        """Forget every kept span and the count of dropped ones."""
        self._kept.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._kept)

    def _thread(self) -> tuple[list[_OpenSpan], str]:
        """This thread's stack of open spans, and its name (the spans' track)."""
        try:
            return self._local.state
        except AttributeError:
            self._local.state = ([], threading.current_thread().name)
            return self._local.state


#: the process's host-clock span log of the solve path
HOST_SPANS = HostTracer()
