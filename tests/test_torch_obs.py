"""The port's observability layer against the JAX package's.

The serving runs of ``tests/test_obs.py``, instrumented in both packages on
the ``python`` backend: the span log (JSONL), the Prometheus snapshot and
the Chrome ``trace_event`` document must come out byte for byte the same,
and an instrumented run must serve the bare run's timeline and journal.
"""

import json

import pytest

import repro.obs as ref_obs
import repro_torch.core as port_core
import repro_torch.obs as port_obs
from torch_parity import PORT, REF, context, costs, library, qos_trace, report_view, trace
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port


def pool_run(P, obs=None, tr=None, n_drives=3, admission="accumulate", journal=None, **kw):
    lib = library(P)
    ctx = context(P, lib, "python", **({"obs": obs} if obs is not None else {}))
    return P.serving.serve_trace(lib, trace(P) if tr is None else tr, admission, window=400_000,
                                 policy="dp", n_drives=n_drives, drive_costs=costs(P),
                                 context=ctx, journal=journal, **kw)


RUNS = {
    "accumulate-3-drives": lambda P, obs: pool_run(P, obs),
    "preempt-2-drives": lambda P, obs: pool_run(P, obs, n_drives=2, admission="preempt"),
    "fifo-global-40": lambda P, obs: pool_run(P, obs, tr=trace(P, 40), admission="fifo-global"),
    "slack-accumulate-qos": lambda P, obs: pool_run(
        P, obs, *qos_trace(P, 8_000_000)[:1], admission="slack-accumulate",
        qos=qos_trace(P, 8_000_000)[1]),
    "faults-2-drives": lambda P, obs: pool_run(
        P, obs, tr=trace(P, 120, 100_000), n_drives=2, retry=P.serving.RetryPolicy(),
        faults=P.serving.seeded_fault_plan(library(P), trace(P, 120, 100_000), seed=3,
                                           n_drives=2, solver_faults=2)),
    "selector-cost-model": lambda P, obs: pool_run(P, obs, tr=trace(P, 120, 30_000),
                                                   n_drives=2, admission="per-drive-accumulate",
                                                   selector="cost-model", warm_start=False),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_exporters_are_byte_identical_to_reference(name, tmp_path):
    out = {}
    for P in (REF, PORT):
        obs = P.obs.Observability.enabled()
        report = RUNS[name](P, obs)
        base = tmp_path / P.name
        n = P.obs.write_spans_jsonl(obs.tracer, f"{base}.spans.jsonl")
        P.obs.write_prometheus(obs.metrics, f"{base}.prom")
        P.obs.write_chrome_trace(obs.tracer, f"{base}.chrome.json")
        out[P.name] = (
            report_view(report), n,
            *(open(f"{base}{ext}", "rb").read() for ext in
              (".spans.jsonl", ".prom", ".chrome.json")),
            P.obs.spans_jsonl(obs.tracer), P.obs.prometheus_text(obs.metrics),
            json.dumps(P.obs.chrome_trace(obs.tracer), sort_keys=True),
            obs.metrics.snapshot(),
        )
    assert out["port"] == out["ref"]
    assert out["port"][1] > 0


@pytest.mark.parametrize("name", ["accumulate-3-drives", "faults-2-drives"])
def test_instrumented_run_equals_bare_run(name, tmp_path):
    for P in (REF, PORT):
        bare = report_view(RUNS[name](P, None))
        seen = report_view(RUNS[name](P, P.obs.Observability.enabled()))
        null = report_view(RUNS[name](P, P.obs.Observability(tracer=P.obs.NullTracer())))
        assert seen == bare == null, P.name
    journals = []
    for obs in (None, port_obs.Observability.enabled()):
        path = tmp_path / f"{len(journals)}.journal"
        pool_run(PORT, obs, tr=trace(PORT, 60), journal=str(path))
        journals.append(path.read_bytes())
    assert journals[0] == journals[1]


def test_tracer_and_registry_match_reference():
    rows = []
    for P in (REF, PORT):
        tr = P.obs.Tracer()
        tr.span("batch", 10, 50, track="drive0", tape="T1")
        tr.event("arrival", 30, track="queue", req=7)
        with pytest.raises(ValueError, match="ends before it starts"):
            tr.span("bad", 5, 4)
        m = P.obs.MetricsRegistry()
        m.inc("b_total", 2, policy="dp")
        m.inc("a_total")
        m.gauge("g", 7, shard="0")
        m.gauge("g", 3, shard="0")
        for v in (5, 9, 1):
            m.observe("h", v)
        errors = []
        for bad in (lambda: m.inc("c", 1.5), lambda: m.observe("h", True),
                    lambda: m.gauge("g", 0.0), lambda: m.inc("c", -1)):
            with pytest.raises((TypeError, ValueError)) as err:
                bad()
            errors.append(str(err.value))
        null = P.obs.NullTracer()
        null.span("s", 0, 1)
        rows.append((P.obs.spans_jsonl(tr), P.obs.prometheus_text(m), m.snapshot(),
                     m.quantile("h", 1, 2), m.counter("b_total", policy="dp"),
                     m.gauge_value("g", shard="0"), len(m), errors, len(null),
                     P.obs.spans_jsonl(null)))
    assert rows[1] == rows[0]


def test_kernel_profile_matches_reference():
    summaries = []
    for P in (REF, PORT):
        prof = P.obs.KernelProfile(wall=False)
        sig = (4, 8, 2, "int32", True, 0, False, None)
        prof.record(signature=sig, n_instances=2, R_pad=4, S_pad=8, B_pad=2, real_cells=100,
                    interpret=True)
        prof.record(signature=sig, n_instances=1, R_pad=4, S_pad=8, B_pad=2, real_cells=40,
                    interpret=True)
        summaries.append((prof.summary(), [r.waste for r in prof.launches],
                          [r.cold for r in prof.launches], len(prof)))
    assert summaries[1] == summaries[0]
    assert port_obs.__all__ == ref_obs.__all__


def test_context_takes_an_observability_bundle():
    ctx = port_core.ExecutionContext(obs=port_obs.Observability.enabled())
    assert ctx.obs.tracer is not None and ctx.obs.kernel is not None
    assert ctx.replace(obs=None).obs is None
    for bad in (42, object(), ref_obs.Observability.enabled()):
        with pytest.raises(TypeError, match="obs must be an Observability bundle"):
            port_core.ExecutionContext(obs=bad)


def test_solve_counters_and_cache_sink():
    obs = port_obs.Observability.enabled()
    lib = library(PORT)
    report = PORT.serving.serve_trace(lib, trace(PORT, 80), "accumulate", window=400_000,
                                      policy="dp", context=lib.context.replace(obs=obs))
    m = obs.metrics
    s = report.summary()
    assert m.counter("cache_hits_total", cache="SolveCache") == s["cache"]["hits"]
    assert m.counter("cache_misses_total", cache="SolveCache") == s["cache"]["misses"]
    solves = sum(v for _, v in m.counters_named("solves_total"))
    assert solves == len(report.batches)
    assert m.counter("cells_evaluated_total") == s["cells_evaluated"]
