"""Recorded request traces: a JSONL format with deadlines and QoS classes.

The paper evaluates against *replayed logs of a real mass-storage system*;
this module gives the online-serving stack the same capability: a trace is a
list of :class:`TraceRecord` rows (arrival, tape, file, multiplicity,
deadline, class), serialised one JSON object per line.  The writer is
byte-deterministic (sorted keys, fixed separators), so a trace round-trips
**bit-exactly** through ``write_trace -> read_trace`` — and, expanded by
:func:`to_requests`, replays to the identical
:class:`~repro_torch.serving.sim.ServiceReport` timeline.

Three surfaces:

* :func:`write_trace` / :func:`read_trace` — the JSONL round trip.
* :func:`to_requests` — expand records (multiplicity becomes that many
  requests) into the ``(trace, qos)`` pair
  :func:`repro_torch.serving.queue.serve_trace` consumes: a sorted
  :class:`~repro_torch.serving.sim.Request` list plus the ``req_id ->``
  :class:`~repro_torch.serving.qos.QoSSpec` map.  :func:`records_of` is the
  inverse (one record per request).
* :func:`qos_poisson_trace` — the deadline/class-annotated extension of
  :func:`repro_torch.serving.sim.poisson_trace`: identical seeded arrival process
  (same seed -> same arrivals/files), plus a seeded class draw
  (:data:`DEFAULT_QOS_CLASSES`) assigning each request a slack multiplier;
  ``deadline = arrival + tightness * slack_multiplier``, exact ints.  The
  ``tightness`` knob sweeps deadline pressure without touching arrivals.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterable, Mapping, Sequence

import numpy as np

from ..serving.qos import DEFAULT_CLASS, QoSSpec
from ..serving.sim import Request, poisson_trace

__all__ = [
    "TRACE_SCHEMA",
    "TRACE_SCHEMA_V2",
    "DEFAULT_QOS_CLASSES",
    "TraceRecord",
    "write_trace",
    "read_trace",
    "to_requests",
    "records_of",
    "qos_poisson_trace",
]

#: schema tag written into (and required from) every trace file's header line.
#: v1 traces carry no ``library`` field; the writer only emits the v2 tag
#: when at least one record uses it, so a v1 file round-trips byte-identically.
TRACE_SCHEMA = "ltsp-trace/v1"
TRACE_SCHEMA_V2 = "ltsp-trace/v2"
_TRACE_SCHEMAS = (TRACE_SCHEMA, TRACE_SCHEMA_V2)

#: (class name, draw weight, slack multiplier): interactive users get tight
#: deadlines, batch jobs sixteen times the slack.  Weights are relative.
DEFAULT_QOS_CLASSES: tuple[tuple[str, float, int], ...] = (
    ("interactive", 0.25, 1),
    ("production", 0.50, 4),
    ("batch", 0.25, 16),
)


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    """One recorded arrival: ``multiplicity`` reads of ``file`` on ``tape``.

    ``deadline`` is absolute virtual time (``None`` = best-effort) and
    applies to every expanded request of the record; ``qos_class`` is the
    priority-class label carried into the
    :class:`~repro_torch.serving.qos.QoSSpec`.
    """

    arrival: int
    tape: str
    file: str
    multiplicity: int = 1
    deadline: int | None = None
    qos_class: str = DEFAULT_CLASS
    #: origin-library label for federated (multi-library) traces; ``None``
    #: (the default, and the only v1 value) expands and replays identically
    #: to a pre-fleet record — the field is advisory routing metadata, never
    #: part of the expansion.
    library: str | None = None

    def __post_init__(self) -> None:
        if self.arrival < 0:
            raise ValueError("arrival must be >= 0")
        if self.multiplicity < 1:
            raise ValueError("multiplicity must be >= 1")
        if self.deadline is not None and self.deadline < self.arrival:
            raise ValueError(
                f"deadline {self.deadline} precedes arrival {self.arrival}"
            )
        if not self.qos_class:
            raise ValueError("qos_class must be a non-empty label")
        if self.library is not None and not self.library:
            raise ValueError("library must be a non-empty label (or None)")


def write_trace(path, records: Iterable[TraceRecord]) -> pathlib.Path:
    """Serialise records as JSONL (schema header + one object per line).

    Output bytes are deterministic: sorted keys, fixed separators, ``\\n``
    line ends — ``write(read(write(r)))`` is byte-identical to
    ``write(r)``.
    """
    path = pathlib.Path(path)
    records = list(records)
    # schema-versioned: the v2 tag (and the ``library`` key) only appear when
    # a record actually carries a library, so pre-fleet traces keep writing
    # the exact v1 bytes they always did
    fleet = any(rec.library is not None for rec in records)
    schema = TRACE_SCHEMA_V2 if fleet else TRACE_SCHEMA
    lines = [json.dumps({"schema": schema}, sort_keys=True, separators=(",", ":"))]
    for rec in records:
        row = dataclasses.asdict(rec)
        if row["library"] is None:
            del row["library"]
        lines.append(json.dumps(row, sort_keys=True, separators=(",", ":")))
    path.write_text("\n".join(lines) + "\n")
    return path


def read_trace(path) -> list[TraceRecord]:
    """Parse a JSONL trace written by :func:`write_trace` (strict)."""
    path = pathlib.Path(path)
    fields = {f.name for f in dataclasses.fields(TraceRecord)}
    records: list[TraceRecord] = []
    schema: str | None = None
    for lineno, line in enumerate(path.read_text().splitlines(), start=1):
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}:{lineno}: not valid JSON ({e})") from None
        if not isinstance(obj, dict):
            raise ValueError(f"{path}:{lineno}: expected a JSON object")
        if "schema" in obj:
            if obj["schema"] not in _TRACE_SCHEMAS:
                raise ValueError(
                    f"{path}:{lineno}: unsupported schema {obj['schema']!r} "
                    f"(expected one of {_TRACE_SCHEMAS})"
                )
            schema = obj["schema"]
            continue
        unknown = set(obj) - fields
        if unknown:
            raise ValueError(f"{path}:{lineno}: unknown field(s) {sorted(unknown)}")
        if "library" in obj and schema == TRACE_SCHEMA:
            # strictness the schema tag buys: a v1 file smuggling the v2
            # field is malformed, not silently accepted
            raise ValueError(
                f"{path}:{lineno}: 'library' needs a {TRACE_SCHEMA_V2!r} header"
            )
        try:
            records.append(TraceRecord(**obj))
        except (TypeError, ValueError) as e:
            raise ValueError(f"{path}:{lineno}: bad record ({e})") from None
    if schema is None:
        raise ValueError(f"{path}: missing {TRACE_SCHEMA!r} schema header line")
    return records


def to_requests(
    records: Sequence[TraceRecord], library=None
) -> tuple[list[Request], dict[int, QoSSpec]]:
    """Expand records into the ``(trace, qos)`` pair the server consumes.

    Records are ordered by arrival (stable on ties, so the file's row order
    is the tie-break) and each record expands into ``multiplicity`` requests
    with consecutive ids — deterministic, so replaying a read-back trace
    reproduces the original run bit for bit.  Passing the target
    :class:`~repro_torch.storage.tape.TapeLibrary` validates that every record's
    file exists and lives on the tape the record claims.
    """
    if library is not None:
        for rec in records:
            actual = library.location.get(rec.file)
            if actual is None:
                raise ValueError(f"trace file {rec.file!r} not in the library")
            if actual != rec.tape:
                raise ValueError(
                    f"trace file {rec.file!r} is on {actual}, not {rec.tape!r}"
                )
    trace: list[Request] = []
    qos: dict[int, QoSSpec] = {}
    rid = 0
    for rec in sorted(records, key=lambda r: r.arrival):
        spec = QoSSpec(deadline=rec.deadline, qos_class=rec.qos_class)
        for _ in range(rec.multiplicity):
            trace.append(
                Request(time=rec.arrival, req_id=rid, tape_id=rec.tape, name=rec.file)
            )
            qos[rid] = spec
            rid += 1
    return trace, qos


def records_of(
    trace: Sequence[Request], qos: Mapping[int, QoSSpec] | None = None
) -> list[TraceRecord]:
    """One record per request (multiplicity 1): the :func:`to_requests` inverse."""
    qos = qos or {}
    default = QoSSpec()
    out = []
    for req in sorted(trace):
        spec = qos.get(req.req_id, default)
        out.append(
            TraceRecord(
                arrival=req.time,
                tape=req.tape_id,
                file=req.name,
                multiplicity=1,
                deadline=spec.deadline,
                qos_class=spec.qos_class,
            )
        )
    return out


def qos_poisson_trace(
    library,
    n_requests: int,
    mean_interarrival: int,
    seed: int,
    skew: float = 1.1,
    tightness: int = 4_000_000,
    classes: tuple[tuple[str, float, int], ...] = DEFAULT_QOS_CLASSES,
    libraries: Sequence[str] | None = None,
) -> list[TraceRecord]:
    """Deadline/class-annotated seeded trace (extends ``poisson_trace``).

    The arrival process is *exactly* :func:`repro_torch.serving.sim.poisson_trace`
    with the same arguments — a QoS-annotated trace and its plain twin share
    arrivals bit for bit, so miss-rate comparisons isolate the admission
    policy.  An independent seeded stream then draws each request's class
    from ``classes`` and sets ``deadline = arrival + tightness *
    slack_multiplier`` (exact ints; ``tightness`` is the deadline-pressure
    knob the benchmarks sweep).

    ``libraries`` names the shards of a federation: when given, a *third*
    independent seeded stream draws each record's origin ``library`` label
    uniformly from the sequence.  The draw never perturbs arrivals, files,
    classes, or deadlines (separate :class:`numpy.random.SeedSequence`
    branch), so a fleet trace and its single-library twin replay the same
    workload — and the labels round-trip through :func:`write_trace` under
    the v2 schema.
    """
    if tightness < 1:
        raise ValueError("tightness must be >= 1")
    if not classes:
        raise ValueError("classes must be non-empty")
    if libraries is not None and not libraries:
        raise ValueError("libraries must be non-empty when given")
    base = poisson_trace(library, n_requests, mean_interarrival, seed, skew)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x51A0]))
    weights = np.array([w for _, w, _ in classes], dtype=float)
    weights /= weights.sum()
    picks = rng.choice(len(classes), size=len(base), p=weights)
    lib_labels: list[str | None] = [None] * len(base)
    if libraries is not None:
        lib_rng = np.random.default_rng(np.random.SeedSequence([seed, 0xF1EE]))
        draws = lib_rng.integers(0, len(libraries), size=len(base))
        lib_labels = [str(libraries[int(d)]) for d in draws]
    records = []
    for req, pick, lib_label in zip(base, picks, lib_labels):
        name, _, slack_mult = classes[int(pick)]
        records.append(
            TraceRecord(
                arrival=req.time,
                tape=req.tape_id,
                file=req.name,
                multiplicity=1,
                deadline=req.time + tightness * int(slack_mult),
                qos_class=name,
                library=lib_label,
            )
        )
    return records
