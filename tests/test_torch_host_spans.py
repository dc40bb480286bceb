"""The host-clock span log of the solve path (``repro_torch.obs.trace``).

Spans are stamped with ``time.time_ns``, the clock of a ``torch.profiler``
trace: under the profiler each is also a ``record_function`` range, and the
operators the profiler records under a range fall inside the span.
Unarmed, a span site records, stamps, allocates and opens nothing, and
armed or not, every solve returns the same result.  The virtual-time
exports stay byte for byte what ``tests/test_torch_obs.py`` holds.
"""

import json
import tracemalloc

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import repro_torch.obs.trace as trace
import repro_torch.serving as serving
from repro_torch.core.instance import make_instance
from repro_torch.core.solver import (
    ExecutionContext,
    solve,
    solve_batch,
    solve_batch_warm,
    solve_warm,
)
from repro_torch.kernels.ltsp_dp import ops
from repro_torch.obs import Observability, chrome_trace, spans_jsonl
from repro_torch.obs.trace import HOST_SPANS, NULL_SPAN, HostTracer
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

CTX = ExecutionContext(backend="torch", device="cpu", numeric_policy="f64")
CHILDREN = {"ltsp.prepare", "ltsp.tables", "ltsp.wait", "ltsp.traceback", "ltsp.finish"}


def instance(seed: int, n_req: int = 12):
    rng = np.random.default_rng(seed)
    left = np.sort(rng.choice(2000, n_req, replace=False)) * 10
    size = rng.integers(1, 8, n_req)
    return make_instance(left, size, rng.integers(1, 4, n_req), m=int(left[-1] + 99),
                         u_turn=int(rng.integers(5, 40)))


INSTS = [instance(1), instance(2, 9)]
#: every public entry that reaches the device path, on one or two instances
ENTRIES = {
    "solve": lambda: [solve(INSTS[0], "dp", context=CTX)],
    "solve_batch": lambda: solve_batch(INSTS, "logdp1", context=CTX),
    "solve_warm": lambda: [solve_warm(INSTS[0], "dp", context=CTX)[0]],
    "solve_batch_warm": lambda: solve_batch_warm(INSTS, "dp", context=CTX)[0],
}


def fresh_spans():
    HOST_SPANS.clear()
    return HOST_SPANS


def roots(log):
    return [s for s in log.spans if s.name == "ltsp.solve" and s.parent is None]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_a_profiled_solve_records_one_root_and_its_children(entry):
    log = fresh_spans()
    bare = ENTRIES[entry]()
    with profile(activities=[ProfilerActivity.CPU]):
        seen = ENTRIES[entry]()
    assert seen == bare
    [root] = roots(log)
    tree = sorted((s for s in log.spans if s.solve == root.solve), key=lambda s: s.seq)
    assert len(tree) == len(log.spans)
    assert {s.name for s in tree[1:]} == CHILDREN
    by_seq = {s.seq: s for s in tree}
    for s in tree[1:]:
        parent = by_seq[s.parent]
        assert s.solve == root.solve and parent.t0 <= s.t0 <= s.t1 <= parent.t1
    batch = entry.startswith("solve_batch")
    insts = INSTS if batch else INSTS[:1]
    n_req = [i.n_req for i in insts]
    assert root.attrs["n_req"] == (n_req if batch else n_req[0])
    assert root.attrs["n"] == ([i.n for i in insts] if batch else insts[0].n)
    assert root.attrs["backend"] == "torch" and root.attrs["policy"] in ("dp", "logdp1")
    # five copies to the device a table build, the root value and the
    # detours and their counts back; where the warm entries capture, the
    # whole planes C and T and x instead of the detours
    builds = len([s for s in tree if s.name == "ltsp.tables"])
    per_build = 9 if entry.endswith("warm") else 8
    assert sum(s.attrs.get("copies", 0) for s in tree) == per_build * builds


def test_spans_share_the_profilers_clock():
    """Every operator the profiler recorded under a span's range lies inside
    the span, to within 50 us: the spans are on the trace's clock."""
    log = fresh_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve(INSTS[0], "dp", context=CTX)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    ranges = sorted((e for e in events if e.name().startswith("ltsp.")), key=lambda e: e.start_ns())
    spans = sorted(log.spans, key=lambda s: s.seq)
    assert [e.name() for e in ranges] == [s.name for s in spans]
    checked = 0
    for rng, span in zip(ranges, spans):
        assert rng.start_ns() <= span.t0 <= span.t1 <= rng.end_ns()
        for e in events:
            if e.name().startswith("aten::") and rng.start_ns() <= e.start_ns() <= rng.end_ns():
                assert span.t0 - 50_000 <= e.start_ns() and e.end_ns() <= span.t1 + 50_000
                checked += 1
    assert checked > 0


class Refused:
    """Stands in for every clock, range and event a span could use."""

    def __init__(self, *args, **kwargs):
        raise AssertionError("an unarmed span site used the clock, a range or an event")

    time_ns = __init__


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_an_unarmed_solve_records_nothing_and_returns_the_same(entry, monkeypatch):
    log = fresh_spans()
    with log.recording():
        armed = ENTRIES[entry]()
    assert roots(log)
    log.clear()
    for name in ("time", "_RecordFunctionFast", "_OpenSpan"):
        monkeypatch.setattr(trace, name, Refused)
    monkeypatch.setattr(torch.cuda, "Event", Refused)
    assert ENTRIES[entry]() == armed
    assert len(log.spans) == 0


def test_an_unarmed_span_site_allocates_nothing():
    log = HostTracer()
    t = torch.zeros(4)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with log.open("ltsp.x") as sp:
                if sp:
                    sp.attrs["n"] = 1
                log.count_copy(t)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == trace.__file__ and d.size_diff > 0]
    assert grown == [] and log.open("ltsp.x") is NULL_SPAN and len(log) == 0


def test_an_armed_capture_solve_records_planes_and_stores():
    log = fresh_spans()
    with log.recording():
        [res], [store] = ops.ltsp_solve_batch([INSTS[0]], backend="torch", device="cpu",
                                              numeric_policy="f64", capture=True)
    R, S = ops.bucket_shape(INSTS[0])
    assert len(store) == R * R * S
    plane_bytes = len(store) * (4 + 4)  # T and C int32: the coordinates fit int32
    [planes] = [s for s in log.spans if s.attrs.get("what") == "planes"]
    assert planes.name == "ltsp.wait" and planes.attrs["copies"] == 3
    assert planes.attrs["bytes"] == plane_bytes + R * 4  # and int32 x
    [finish] = [s for s in log.spans if s.name == "ltsp.finish"]
    assert finish.attrs["store_bytes"] == plane_bytes
    assert res == ops.ltsp_solve_batch([INSTS[0]], backend="torch", device="cpu",
                                       numeric_policy="f64")[0]


@pytest.mark.parametrize("backend, capture, layout", [
    ("torch", False, "packed"), ("cuda", False, "packed"), ("torch", True, "dense")])
def test_an_armed_build_records_its_layout_and_bytes(backend, capture, layout):
    """``ltsp.tables`` carries the tables' layout and bytes when armed: the
    packed ones of an uncaptured build (on the ``cuda`` backend here its
    plain version, on the CPU) and the dense planes of a captured one; no
    allocator count off the card.  Unarmed, nothing is recorded."""
    inst = INSTS[0]
    scaled, g = ops.rescale_instance(inst)
    R, S = ops.tight_shape(scaled)

    def build():
        out, _ = ops._solve_packed([inst], [scaled], [g], R, S, None, None, backend,
                                   ops.DEFAULT_CAND_TILE, dtype=torch.float64,
                                   capture=capture, device="cpu")
        return out

    log = fresh_spans()
    bare = build()
    assert len(log.spans) == 0
    with log.recording():
        assert build() == bare
    [tables] = [s for s in log.spans if s.name == "ltsp.tables"]
    cells = R * (R + 1) // 2 * S if layout == "packed" else R * R * S
    assert tables.attrs["layout"] == layout
    assert tables.attrs["table_bytes"] == cells * (8 + 4)
    assert "alloc_retries" not in tables.attrs and "device_ns" not in tables.attrs
    assert "far_stages" not in tables.attrs and "far_stages_full" not in tables.attrs


def test_the_bounded_log_counts_what_it_drops():
    log = HostTracer()
    with log.recording():
        for k in range(trace.HOST_SPANS_KEPT + 3):
            with log.open(f"s{k}"):
                pass
    assert len(log) == trace.HOST_SPANS_KEPT and log.dropped == 3
    spans = log.spans
    assert [s.name for s in spans[:2]] == ["s3", "s4"] and spans[-1].name == f"s{len(spans) + 2}"
    assert [s.solve for s in spans[:2]] == [4, 5]


@pytest.mark.parametrize("admission", ["accumulate", "batched"])
def test_served_solves_nest_under_their_dispatches(admission):
    tr = serving.poisson_trace(serving.demo_library(7), n_requests=40,
                               mean_interarrival=250_000, seed=7)

    def serve(armed: bool):
        lib = serving.demo_library(7)  # a library of its own: no solve cached
        obs = Observability.enabled()
        ctx = lib.context.replace(backend="torch", device="cpu", obs=obs)
        log = fresh_spans()
        if armed:
            with log.recording():
                report = serving.serve_trace(lib, tr, admission, window=400_000, policy="dp",
                                             context=ctx)
        else:
            report = serving.serve_trace(lib, tr, admission, window=400_000, policy="dp",
                                         context=ctx)
        return report, spans_jsonl(obs.tracer), list(log.spans)

    bare, bare_virtual, none = serve(False)
    report, virtual, spans = serve(True)
    assert none == [] and virtual == bare_virtual
    assert report.summary() == bare.summary()
    by_seq = {s.seq: s for s in spans}
    dispatches = [s for s in spans if s.name == "ltsp.dispatch"]
    solves = [s for s in spans if s.name == "ltsp.solve"]
    assert dispatches and len(solves) == len(dispatches)
    for s in solves:
        parent = by_seq[s.parent]
        assert parent.name == "ltsp.dispatch" and parent.solve == s.solve
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    assert sum(d.attrs["n_requests"] for d in dispatches) == sum(
        b.n_requests for b in bare.batches)
    assert sorted({d.attrs["t"] for d in dispatches}) == sorted({b.dispatched for b in
                                                                 bare.batches})


def test_the_chrome_trace_gives_the_host_log_a_process_of_its_own():
    log = fresh_spans()
    with log.recording():
        solve(INSTS[0], "dp", context=CTX)
    virtual = trace.Tracer()
    virtual.span("batch", 10, 50, track="drive0")
    alone = chrome_trace(virtual)
    doc = json.loads(json.dumps(chrome_trace(virtual, host=log)))
    assert doc["traceEvents"][:len(alone["traceEvents"])] == alone["traceEvents"]
    host = [e for e in doc["traceEvents"] if e["pid"] == 1]
    assert host[0]["args"] == {"name": "host"}
    spans = sorted(log.spans, key=lambda s: s.seq)
    timed = [e for e in host if e["ph"] == "X"]
    assert [e["name"] for e in timed] == [s.name for s in spans]
    assert [e["ts"] for e in timed] == [s.t0 / 1e3 for s in spans]
    assert doc["otherData"]["host_clock"] == "unix-epoch-microseconds"
    assert "host_clock" not in chrome_trace(virtual)["otherData"]


# ---------------------------------------------------------------------------
# on the card: the CUDA events' device times (skip without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["dp", "logdp1"])
def test_cuda_armed_solve_times_the_build(cuda_device, policy):
    ctx = ExecutionContext(backend="cuda", device=cuda_device, numeric_policy="f64")
    inst = instance(3, 40)
    bare = solve(inst, policy, context=ctx)
    log = fresh_spans()
    for _ in range(2):  # the second solve reuses the first one's events
        log.clear()
        with log.recording():
            assert solve(inst, policy, context=ctx) == bare
        spans = {s.attrs.get("what", s.name): s for s in log.spans}
        tables = spans["ltsp.tables"]
        assert 0 < tables.attrs["device_ns"] <= spans["root"].t1 - tables.t0
        assert "device_ns" not in spans["ltsp.traceback"].attrs
        staged, full = tables.attrs["far_stages"], tables.attrs["far_stages_full"]
        assert 0 < staged <= full and (staged == full) == (policy == "dp")
        assert sum(s.attrs.get("copies", 0) for s in log.spans) == 8


@pytest.mark.cuda
def test_cuda_armed_solve_records_a_packed_build_and_the_allocators_retries(cuda_device):
    ctx = ExecutionContext(backend="cuda", device=cuda_device, numeric_policy="f64")
    inst = instance(4, 40)
    bare = solve(inst, "dp", context=ctx)
    log = fresh_spans()
    with log.recording():
        assert solve(inst, "dp", context=ctx) == bare
    [tables] = [s for s in log.spans if s.name == "ltsp.tables"]
    R, S = ops.bucket_shape(inst)  # an int32 build: its coordinates fit
    assert tables.attrs["layout"] == "packed"
    assert tables.attrs["table_bytes"] == R * (R + 1) // 2 * S * (4 + 4)
    assert tables.attrs["alloc_retries"] == 0
