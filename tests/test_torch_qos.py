"""The port's QoS layer and trace format against the JAX package's.

The scenarios of ``tests/test_qos.py`` on the ``python`` backend: deadline-
aware admissions, mount schedulers and the SLO reports must match the
reference field for field, and ``write_trace`` must write the same
``ltsp-trace/v1`` and ``v2`` bytes, so a trace written by either package
replays through the other.
"""

import dataclasses

import pytest

import repro.data.traces as ref_traces
import repro.serving as ref_serving
import repro_torch.data as port_data
import repro_torch.data.traces as port_traces
import repro_torch.serving as port_serving
from torch_parity import PORT, REF, context, costs, library, qos_trace, run_both, trace
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def qos_run(P, backend, journal, admission, tightness=8_000_000, n_requests=240, **kw):
    tr, qos = qos_trace(P, tightness, n_requests=n_requests)
    lib = library(P)
    return P.serving.serve_trace(lib, tr, admission, policy="dp", qos=qos, journal=journal,
                                 context=context(P, lib, backend), **kw)


@scenario
def edf_global_pool(P, backend, journal):
    return qos_run(P, backend, journal, "edf-global", window=400_000, n_drives=2,
                   drive_costs=costs(P))


@scenario
def slack_accumulate_pool(P, backend, journal):
    return qos_run(P, backend, journal, "slack-accumulate", window=400_000, n_drives=2,
                   drive_costs=costs(P))


@scenario
def edf_global_tight(P, backend, journal):
    return qos_run(P, backend, journal, "edf-global", tightness=2_000_000, window=400_000,
                   n_drives=2, drive_costs=costs(P))


@scenario
def slack_accumulate_dedicated(P, backend, journal):
    return qos_run(P, backend, journal, "slack-accumulate", n_requests=160, window=400_000)


@scenario
def accumulate_with_deadlines(P, backend, journal):
    return qos_run(P, backend, journal, "accumulate", n_requests=120, window=400_000)


@scenario
def fifo_global_with_deadlines(P, backend, journal):
    return qos_run(P, backend, journal, "fifo-global", window=400_000, n_drives=2,
                   drive_costs=costs(P))


@scenario
def lookahead_with_deadlines(P, backend, journal):
    return qos_run(P, backend, journal, "edf-global", window=400_000, n_drives=2,
                   drive_costs=costs(P), mount_scheduler="lookahead")


@scenario
def lru_per_drive_accumulate(P, backend, journal):
    lib = library(P)
    return P.serving.serve_trace(lib, trace(P), "per-drive-accumulate", window=400_000,
                                 policy="dp", n_drives=2, drive_costs=costs(P),
                                 mount_scheduler="lru", journal=journal,
                                 context=context(P, lib, backend))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_qos_scenario_matches_reference(name, tmp_path):
    (ref, ref_journal), (port, port_journal) = run_both(SCENARIOS[name], tmp_path)
    assert port == ref
    assert port_journal == ref_journal


def _slo_view(slo):
    return (slo.summary(), dataclasses.astuple(slo.overall),
            [dataclasses.astuple(c) for c in slo.classes])


@pytest.mark.parametrize("admission", ["edf-global", "slack-accumulate", "accumulate"])
def test_slo_report_matches_reference(admission):
    views = []
    for P in (REF, PORT):
        tr, qos = qos_trace(P, 8_000_000, n_requests=160)
        report = P.serving.serve_trace(library(P), tr, admission, window=400_000,
                                       policy="dp", qos=qos)
        views.append((_slo_view(P.serving.slo_report(report)),
                      _slo_view(P.serving.slo_report(report, qos))))
    assert views[1] == views[0]


def test_qos_primitives_match_reference():
    for vals, num, den in (([10, 20, 30, 40], 1, 2), ([10, 20, 30, 40], 99, 100),
                           ([7], 99, 100), ([], 1, 2), (list(range(99)), 99, 100),
                           ([5, 5, 1, 9, 3], 0, 1)):
        assert port_serving.int_quantile(vals, num, den) == \
            ref_serving.int_quantile(vals, num, den)
    spec = port_serving.QoSSpec(deadline=500, qos_class="interactive")
    ref_spec = ref_serving.QoSSpec(deadline=500, qos_class="interactive")
    assert dataclasses.astuple(spec) == dataclasses.astuple(ref_spec)
    assert port_serving.DEFAULT_CLASS == ref_serving.DEFAULT_CLASS
    for P in (REF, PORT):
        with pytest.raises(ValueError):
            P.serving.QoSSpec(deadline=-1)
        with pytest.raises(ValueError):
            P.serving.resolve_scheduler("no-such-scheduler")


def test_mount_schedulers_pick_the_same_victims():
    picks = []
    for P in (REF, PORT):
        row = []
        for name in ("greedy", "lru", "lookahead"):
            p = P.serving.DrivePool(3, costs(P), scheduler=name)
            for tape in ("A", "B", "C", "A", "D", "B", "E"):
                d, delay = p.acquire(tape)
                row.append((name, tape, d.drive_id, delay))
            row.append(p.stats())
        picks.append(row)
    assert picks[1] == picks[0]


# ---------------------------------------------------------------------------
# the trace format
# ---------------------------------------------------------------------------
def test_trace_schema_and_classes_match_reference():
    assert port_traces.TRACE_SCHEMA == ref_traces.TRACE_SCHEMA == "ltsp-trace/v1"
    assert port_traces.TRACE_SCHEMA_V2 == ref_traces.TRACE_SCHEMA_V2
    assert port_traces.DEFAULT_QOS_CLASSES == ref_traces.DEFAULT_QOS_CLASSES
    assert port_data.TRACE_SCHEMA == port_traces.TRACE_SCHEMA


@pytest.mark.parametrize("libraries", [None, ("lib-a", "lib-b", "lib-c")])
@pytest.mark.parametrize("tightness", [2_000_000, 8_000_000])
def test_write_trace_bytes_match_reference(tmp_path, libraries, tightness):
    recs = {}
    for P in (REF, PORT):
        recs[P.name] = P.traces.qos_poisson_trace(
            library(P), n_requests=120, mean_interarrival=250_000, seed=20260731,
            tightness=tightness, libraries=libraries)
        P.traces.write_trace(tmp_path / f"{P.name}.jsonl", recs[P.name])
    assert [dataclasses.astuple(r) for r in recs["port"]] == [
        dataclasses.astuple(r) for r in recs["ref"]]
    data = (tmp_path / "port.jsonl").read_bytes()
    assert data == (tmp_path / "ref.jsonl").read_bytes()
    schema = b"ltsp-trace/v2" if libraries else b"ltsp-trace/v1"
    assert schema in data.split(b"\n", 1)[0]
    # each package reads the other's file back to the same records
    assert port_traces.read_trace(tmp_path / "ref.jsonl") == recs["port"]
    assert ref_traces.read_trace(tmp_path / "port.jsonl") == recs["ref"]


def test_to_requests_and_records_of_match_reference():
    out = []
    for P in (REF, PORT):
        recs = P.traces.qos_poisson_trace(library(P), n_requests=60, mean_interarrival=250_000,
                                          seed=5, tightness=4_000_000)
        name = sorted(library(P).location)[0]
        recs.append(P.traces.TraceRecord(arrival=recs[-1].arrival, tape=library(P).location[name],
                                         file=name, multiplicity=3, deadline=None))
        tr, qos = P.traces.to_requests(recs, library(P))
        back = P.traces.records_of(tr, qos)
        out.append(([dataclasses.astuple(r) for r in tr],
                    sorted((k, dataclasses.astuple(v)) for k, v in qos.items()),
                    [dataclasses.astuple(r) for r in back]))
    assert out[1] == out[0]


def test_trace_validation_errors_match_reference(tmp_path):
    bad_records = [dict(arrival=-1, tape="T", file="f"),
                   dict(arrival=0, tape="T", file="f", multiplicity=0),
                   dict(arrival=10, tape="T", file="f", deadline=9),
                   dict(arrival=0, tape="T", file="f", qos_class="")]
    for kw in bad_records:
        errors = []
        for P in (REF, PORT):
            with pytest.raises(ValueError) as err:
                P.traces.TraceRecord(**kw)
            errors.append(str(err.value))
        assert errors[1] == errors[0]
    bad_files = {
        "no_header": '{"arrival":0,"file":"f","tape":"T"}\n',
        "bad_schema": '{"schema":"ltsp-trace/v999"}\n',
        "unknown": '{"schema":"ltsp-trace/v1"}\n{"arrival":0,"file":"f","tape":"T","prio":1}\n',
        "not_json": '{"schema":"ltsp-trace/v1"}\nnot json\n',
    }
    for name, text in bad_files.items():
        path = tmp_path / f"{name}.jsonl"
        path.write_text(text)
        errors = []
        for P in (REF, PORT):
            with pytest.raises(ValueError) as err:
                P.traces.read_trace(path)
            errors.append(str(err.value))
        assert errors[1] == errors[0], name
    lib = library(PORT)
    name = sorted(lib.location)[0]
    with pytest.raises(ValueError, match="not in the library"):
        port_traces.to_requests([port_traces.TraceRecord(arrival=0, tape=lib.location[name],
                                                         file="ghost")], lib)
