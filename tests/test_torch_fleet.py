"""The port's fleet federation against the JAX package's.

Every test of ``tests/test_fleet.py`` has its counterpart here, under the
same name.  A serving run goes through both packages: on ``python``, and on
the port's ``torch`` backend (the kernels' plain version, on the CPU)
against the reference's ``pallas-interpret``, with backend names mapped
(:mod:`torch_parity`).  Merged and per-shard reports, routes, re-route
counts and journal bytes must agree with ``==``, and the reference's sha /
total-sojourn pins hold on the port.

The one-shard pins serve ``demo_library``'s 240-request trace, whose larger
dispatches fail the int32 device guard under ``numeric_policy="strict"`` in
both packages (checked below), and the reference's float64 fallback does not
run on the installed JAX.  So on the device backend the port serves those
pins with ``numeric_policy="f64"`` and is held to the pins, to its own
standalone server and to the reference's ``python`` timeline.
"""

import dataclasses
import hashlib
from pathlib import Path

import pytest

from torch_parity import PORT, REF, TO_REF, backend_for, report_view
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = [pytest.mark.port, pytest.mark.fleet]

SEED = 20260731
#: ``tests/test_fleet.py``'s pins: the one-shard ``single`` federation must
#: reproduce them bit for bit.
NO_FAULT_BASELINE = {
    "fifo": ("1a79c55063c3f802", 56_368_550_889),
    "accumulate": ("df9ed258ac816c37", 3_809_190_213),
    "preempt": ("668366586042762a", 7_347_259_813),
    "fifo-global": ("1a79c55063c3f802", 56_368_550_889),
    "per-drive-accumulate": ("df9ed258ac816c37", 3_809_190_213),
    "batched": ("df9ed258ac816c37", 3_809_190_213),
}
#: backends in the reference's naming; the port runs ``python`` and ``torch``
BACKENDS = ("python", "pallas-interpret")
PLACEMENTS = ("static-hash", "least-loaded", "replica-affinity")


def costs(P):
    return P.serving.DriveCosts(mount=150_000, unmount=60_000, load_seek=30_000)


def context(P, backend, **changes):
    """A fresh context on ``backend`` (the reference's naming) for ``P``; the
    port's ``torch`` backend runs on the CPU."""
    name = backend_for(P, backend)
    if name == "torch":
        changes.setdefault("device", "cpu")
    return P.core.ExecutionContext(backend=name, **changes)


def build_library(P):
    return P.serving.demo_library(SEED)


def build_trace(P, n_requests=240, rate=250_000):
    return P.serving.poisson_trace(build_library(P), n_requests=n_requests,
                                   mean_interarrival=rate, seed=SEED)


def build_fleet(P, n_shards=3, replicas=2):
    return P.fleet.demo_fleet(SEED, n_shards=n_shards, replicas=replicas)


def fleet_trace(P, libs, rmap, n_requests=120, rate=30_000):
    return P.serving.poisson_trace(P.fleet.fleet_catalog(libs, rmap), n_requests=n_requests,
                                   mean_interarrival=rate, seed=SEED)


def served_sha(report):
    served = tuple((r.req_id, r.arrival, r.dispatched, r.completed) for r in report.served)
    return hashlib.sha256(repr(served).encode()).hexdigest()[:16]


def timeline(report):
    return [
        (r.req_id, r.arrival, r.dispatched, r.completed, r.faulted) for r in report.served
    ] + [(f.req_id, f.failed_at, f.reason) for f in report.failed]


def fleet_view(fr) -> tuple:
    """Everything a :class:`FleetReport` says, backend names mapped."""
    summary = fr.summary()
    summary["backend"] = TO_REF.get(summary["backend"], summary["backend"])
    return (list(summary.items()), report_view(fr.merged),
            [report_view(r) for r in fr.shards], fr.placement, fr.n_shards, fr.routes,
            fr.n_rerouted, [dataclasses.astuple(o) for o in fr.outages])


def serve_fleet(P, backend, placement, n_shards=3, replicas=2, n_requests=120,
                outages=(), drop=False, journal=None, numeric_policy="strict", **kw):
    libs, rmap = build_fleet(P, n_shards, replicas)
    trace = fleet_trace(P, libs, rmap, n_requests)
    if drop:
        kw["retry"] = P.serving.RetryPolicy(on_exhausted="drop")
    return P.fleet.serve_fleet_trace(
        libs, trace, "accumulate", placement=placement, replica_map=rmap,
        outages=tuple(P.serving.ShardOutage(at=at, shard=s) for at, s in outages),
        window=400_000, n_drives=2, drive_costs=costs(P), journal=journal,
        context=context(P, backend, numeric_policy=numeric_policy), **kw)


def both(run):
    """``run(P)`` for the reference, then for the port."""
    return run(REF), run(PORT)


# ---------------------------------------------------------------------------
# acceptance: the one-shard `single` fleet is bit-identical to no fleet
# ---------------------------------------------------------------------------
def _single(P, admission, ctx):
    fr = P.fleet.serve_fleet_trace(
        [build_library(P)], build_trace(P), admission, placement="single",
        window=400_000, policy="dp", n_drives=2, drive_costs=costs(P), context=ctx)
    standalone = P.serving.serve_trace(
        build_library(P), build_trace(P), admission, window=400_000, policy="dp",
        n_drives=2, drive_costs=costs(P), context=ctx)
    return fr, standalone


def _check_single(fr, standalone, admission, n_trace):
    sha, total = NO_FAULT_BASELINE[admission]
    assert (served_sha(fr.merged), fr.merged.total_sojourn) == (sha, total)
    assert timeline(fr.merged) == timeline(standalone)
    assert timeline(fr.shards[0]) == timeline(standalone)
    assert fr.placement == "single" and fr.n_shards == 1
    assert fr.routes == {0: n_trace} and fr.n_rerouted == 0
    merged_summary = fr.summary()
    assert merged_summary.pop("fleet")["n_shards"] == 1
    assert merged_summary == standalone.summary()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("admission", sorted(NO_FAULT_BASELINE))
def test_single_placement_matches_standalone_pin(admission, backend):
    ref, ref_solo = _single(REF, admission, context(REF, "python"))
    _check_single(ref, ref_solo, admission, len(build_trace(REF)))
    if backend == "python":
        port, port_solo = _single(PORT, admission, context(PORT, "python"))
        assert fleet_view(port) == fleet_view(ref)
        assert report_view(port_solo) == report_view(ref_solo)
    else:
        port, port_solo = _single(PORT, admission,
                                  context(PORT, backend, numeric_policy="f64"))
        assert timeline(port.merged) == timeline(ref.merged)
    _check_single(port, port_solo, admission, len(build_trace(PORT)))


def test_single_pin_trace_fails_the_int32_guard_in_both_packages():
    """Why the device-backend pins run under ``numeric_policy="f64"``: the
    reference's ``pallas-interpret`` and the port's ``torch`` refuse the same
    dispatch with the same message under ``"strict"``."""
    errors = []
    for P in (REF, PORT):
        with pytest.raises(ValueError, match="even after gcd rescaling") as err:
            _single(P, "accumulate", context(P, "pallas-interpret"))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_placement_journal_is_byte_identical(backend, tmp_path):
    """The degenerate federation's write-ahead journal must be the
    standalone server's journal, byte for byte, and the reference's."""
    journals = []
    for P in (REF, PORT):
        name = "python" if P is REF else backend
        ctx = context(P, name, numeric_policy="f64" if P is PORT else "strict")
        solo = tmp_path / f"{P.name}-solo.journal"
        P.serving.serve_trace(build_library(P), build_trace(P), "accumulate", window=400_000,
                              policy="dp", n_drives=2, drive_costs=costs(P),
                              journal=str(solo), context=ctx)
        base = tmp_path / f"{P.name}-fleet.journal"
        P.fleet.serve_fleet_trace([build_library(P)], build_trace(P), "accumulate",
                                  placement="single", window=400_000, policy="dp", n_drives=2,
                                  drive_costs=costs(P), journal=str(base), context=ctx)
        fleet_bytes = Path(P.fleet.shard_journal_path(base, 0)).read_bytes()
        assert fleet_bytes == solo.read_bytes()
        journals.append(fleet_bytes)
    assert journals[0] == journals[1]


# ---------------------------------------------------------------------------
# replica map
# ---------------------------------------------------------------------------
def test_replica_map_from_demo_fleet():
    (ref_libs, ref_map), (libs, rmap) = both(lambda P: build_fleet(P, 3, 2))
    assert dict(rmap.holders_of) == dict(ref_map.holders_of)
    assert len(rmap) == 48
    for name, holders in rmap.holders_of.items():
        assert len(holders) == 2
        assert list(holders) == sorted(set(holders))
        sizes = {libs[s].tape_of(name).files[name].size for s in holders}
        assert len(sizes) == 1
        assert sizes == {ref_libs[s].tape_of(name).files[name].size for s in holders}
    for i in range(48):
        name = f"obj{i:04d}"
        assert i % 3 in rmap.holders(name)
        assert rmap.primary(name) == min(rmap.holders(name))
    assert [lib.location for lib in libs] == [lib.location for lib in ref_libs]
    assert all(lib.context.backend == "python" for lib in libs)
    rmap.validate(libs)


def test_replica_map_validation_errors():
    messages = []
    for P in (REF, PORT):
        libs, _ = build_fleet(P, n_shards=2, replicas=1)
        got = []
        for match, call in (
            ("no replica holders", lambda: P.fleet.ReplicaMap({"f": ()})),
            ("sorted and unique", lambda: P.fleet.ReplicaMap({"f": (1, 0)})),
            ("negative", lambda: P.fleet.ReplicaMap({"f": (-1,)})),
            ("only 2 shard", lambda: P.fleet.ReplicaMap({"obj0000": (0, 5)}).validate(libs)),
            ("does not store", lambda: P.fleet.ReplicaMap({"obj0000": (0, 1)}).validate(libs)),
            ("not stored on any shard",
             lambda: P.fleet.ReplicaMap.from_libraries(libs).holders("nope")),
        ):
            with pytest.raises(ValueError, match=match) as err:
                call()
            got.append(str(err.value))
        messages.append(got)
    assert messages[0] == messages[1]


def test_fleet_catalog_maps_primaries():
    def catalog(P):
        libs, rmap = build_fleet(P, n_shards=2, replicas=1)
        cat = P.fleet.fleet_catalog(libs, rmap)
        assert cat.location["obj0000"] == libs[0].location["obj0000"]
        assert cat.location["obj0001"] == libs[1].location["obj0001"]
        assert set(cat.location) == set(rmap.holders_of)
        return cat.location

    ref, port = both(catalog)
    assert port == ref


def test_demo_fleet_validates_replication():
    for P in (REF, PORT):
        with pytest.raises(ValueError, match="replicas"):
            P.fleet.demo_fleet(SEED, n_shards=2, replicas=3)
        with pytest.raises(ValueError, match="n_shards"):
            P.fleet.demo_fleet(SEED, n_shards=0)


# ---------------------------------------------------------------------------
# placement registry
# ---------------------------------------------------------------------------
def test_placement_registry():
    from repro_torch.fleet import PLACEMENTS, get_placement, list_placements

    assert list_placements() == sorted(PLACEMENTS) == REF.fleet.list_placements()
    assert {"single", "static-hash", "least-loaded", "replica-affinity"} <= set(PLACEMENTS)
    assert get_placement("static-hash").name == "static-hash"
    inst = get_placement("least-loaded")
    assert get_placement(inst) is inst
    assert all(get_placement(n).dynamic == REF.fleet.get_placement(n).dynamic
               for n in PLACEMENTS)
    with pytest.raises(ValueError, match="unknown placement"):
        get_placement("round-robin")
    with pytest.raises(TypeError, match="not a PlacementStrategy"):
        get_placement(42)


def test_register_custom_placement():
    from repro_torch.fleet import PLACEMENTS, get_placement, register_placement

    class EverySecond:
        name = "every-second"
        dynamic = False

        def pick(self, name, candidates, view):
            return candidates[-1]

    try:
        register_placement(EverySecond)
        assert get_placement("every-second").pick("f", (0, 1), None) == 1
        assert "every-second" not in REF.fleet.PLACEMENTS  # registries are separate
    finally:
        PLACEMENTS.pop("every-second", None)
    with pytest.raises(ValueError, match="string name"):
        register_placement(object)


def test_static_hash_is_stable_and_feasible():
    from repro_torch.fleet import placement as port_placement
    from repro.fleet import placement as ref_placement

    names = ["obj0000", "obj0017", "anything", ""] + [f"obj{i:04d}" for i in range(200)]
    assert [port_placement._stable_hash(n) for n in names] == \
        [ref_placement._stable_hash(n) for n in names]
    picks = []
    for P in (REF, PORT):
        pl = P.fleet.get_placement("static-hash")
        view = P.fleet.FleetView(now=0, shards=())
        for name in ("obj0000", "obj0017", "anything"):
            got = {pl.pick(name, (0, 2, 5), view) for _ in range(3)}
            assert len(got) == 1 and got <= {0, 2, 5}
        assert pl.pick("obj0000", (3,), view) == 3
        picks.append([pl.pick(n, (0, 1, 2), view) for n in names])
    assert picks[0] == picks[1]


# ---------------------------------------------------------------------------
# construction validation
# ---------------------------------------------------------------------------
def test_single_with_many_shards_raises():
    for P in (REF, PORT):
        libs, rmap = build_fleet(P, n_shards=2, replicas=1)
        with pytest.raises(ValueError, match="one-shard NoOp default"):
            P.fleet.FleetServer(libs, placement="single", replica_map=rmap)


def test_context_fleet_options_must_agree_on_shard_count():
    for P in (REF, PORT):
        libs, rmap = build_fleet(P, n_shards=2, replicas=1)
        ctx = P.core.ExecutionContext(
            fleet=P.core.FleetOptions(n_shards=3, placement="least-loaded"))
        with pytest.raises(ValueError, match="context.fleet says 3"):
            P.fleet.FleetServer(libs, replica_map=rmap, context=ctx)
        ctx = P.core.ExecutionContext(
            fleet=P.core.FleetOptions(n_shards=2, placement="least-loaded"))
        fleet = P.fleet.FleetServer(libs, replica_map=rmap, context=ctx)
        assert fleet.placement.name == "least-loaded"


def test_outage_validation():
    for P in (REF, PORT):
        libs, rmap = build_fleet(P, n_shards=2, replicas=1)
        with pytest.raises(ValueError, match="only 2 shard"):
            P.fleet.FleetServer(libs, placement="static-hash", replica_map=rmap,
                                outages=(P.serving.ShardOutage(at=10, shard=5),))
        with pytest.raises(TypeError, match="ShardOutage"):
            P.fleet.FleetServer(libs, placement="static-hash", replica_map=rmap,
                                outages=("shard-1",))


def test_fleet_options_validate():
    from repro_torch.core import FleetOptions

    for bad in (dict(n_shards=0), dict(n_shards=2, replicas=0), dict(n_shards=2, replicas=3)):
        with pytest.raises(ValueError):
            FleetOptions(**bad)
    opts = FleetOptions(n_shards=2, replicas=2).replace(placement="static-hash")
    assert opts.placement == "static-hash" and opts.n_shards == 2
    assert dataclasses.astuple(opts) == dataclasses.astuple(
        REF.core.FleetOptions(n_shards=2, replicas=2, placement="static-hash"))


def test_unknown_file_fails_fast():
    for P in (REF, PORT):
        libs, rmap = build_fleet(P, n_shards=2, replicas=1)
        trace = fleet_trace(P, libs, rmap, n_requests=4)
        ghost = dataclasses.replace(trace[0], name="ghost", req_id=999)
        with pytest.raises(ValueError, match="not stored on any shard"):
            P.fleet.serve_fleet_trace(libs, trace + [ghost], placement="static-hash",
                                      replica_map=rmap, n_drives=2)


# ---------------------------------------------------------------------------
# routing: determinism, feasibility, conservation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_placements_conserve_and_repeat(placement, backend):
    ref = serve_fleet(REF, backend, placement)
    runs = []
    for _ in range(2):
        fr = serve_fleet(PORT, backend, placement)
        libs, rmap = build_fleet(PORT)
        assert fr.n_served + fr.n_failed == 120
        assert fr.n_failed == 0
        assert sum(fr.routes.values()) == 120
        for i, shard_report in enumerate(fr.shards):
            for r in shard_report.served:
                assert i in rmap.holders(r.name)
        runs.append(fleet_view(fr))
    assert runs[0] == runs[1] == fleet_view(ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_merged_report_sums_shards(backend):
    ref = serve_fleet(REF, backend, "least-loaded")
    fr = serve_fleet(PORT, backend, "least-loaded")
    assert fleet_view(fr) == fleet_view(ref)
    assert fr.n_served == sum(r.n_served for r in fr.shards)
    assert fr.merged.horizon == max(r.horizon for r in fr.shards)
    assert fr.total_sojourn == sum(r.total_sojourn for r in fr.shards)
    assert len(fr.merged.batches) == sum(len(r.batches) for r in fr.shards)
    keys = [(r.completed, r.req_id) for r in fr.merged.served]
    assert keys == sorted(keys)
    assert fr.merged.pool_stats["n_drives"] == sum(r.pool_stats["n_drives"] for r in fr.shards)


def _busy_idle(P, backend):
    libs, rmap = build_fleet(P, n_shards=2, replicas=1)
    trace = fleet_trace(P, libs, rmap, n_requests=24)
    kw = dict(window=400_000, n_drives=2, drive_costs=costs(P), context=context(P, backend))
    busy = P.serving.serve_trace(libs[0], [r for r in trace if rmap.primary(r.name) == 0],
                                 "accumulate", **kw)
    idle = P.serving.serve_trace(libs[1], [], "accumulate", **kw)
    return busy, idle


@pytest.mark.parametrize("backend", BACKENDS)
def test_merge_reports_with_empty_shard_reports(backend):
    views = []
    for P in (REF, PORT):
        busy, idle = _busy_idle(P, backend)
        merged = P.fleet.merge_reports([busy, idle])
        assert merged.n_served == busy.n_served and merged.n_failed == 0
        assert merged.horizon == busy.horizon
        assert merged.total_sojourn == busy.total_sojourn
        assert timeline(merged) == timeline(busy)
        assert merged.pool_stats["n_drives"] == 4
        assert merged.pool_stats["mounts"] == busy.pool_stats["mounts"]
        empty = P.fleet.merge_reports([idle, idle])
        assert empty.n_served == 0 and empty.horizon == 0 and empty.served == []
        views.append((report_view(merged), report_view(empty)))
    assert views[0] == views[1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_merge_reports_zero_completions_nonzero_drops(backend):
    def run(P):
        return serve_fleet(P, backend, "static-hash", n_shards=2, replicas=1, n_requests=24,
                           outages=((0, 0), (0, 1)), drop=True)

    ref, fr = both(run)
    assert fleet_view(fr) == fleet_view(ref)
    merged = fr.merged
    assert merged.n_served == 0 and merged.n_failed == 24
    assert merged.total_sojourn == 0
    keys = [(f.failed_at, f.req_id) for f in merged.failed]
    assert keys == sorted(keys)
    s = fr.summary()
    assert s["n_served"] == 0 and s["mean_sojourn"] == 0
    assert s["p50_sojourn"] == 0 and s["p99_sojourn"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_merge_reports_sums_fault_stats(backend):
    ref, fr = both(lambda P: serve_fleet(P, backend, "replica-affinity",
                                         outages=((1_500_000, 1),), drop=True))
    assert fleet_view(fr) == fleet_view(ref)
    per_shard = [r.fault_stats for r in fr.shards if r.fault_stats]
    assert per_shard
    want: dict = {}
    for d in per_shard:
        for k, v in d.items():
            want[k] = want.get(k, 0) + v
    assert fr.merged.fault_stats == want
    calm = serve_fleet(PORT, backend, "replica-affinity")
    assert calm.merged.fault_stats is None
    assert all(r.fault_stats is None for r in calm.shards)


def test_merge_reports_rejects_mixed_configs():
    messages = []
    for P in (REF, PORT):
        libs, rmap = build_fleet(P, n_shards=2, replicas=1)
        trace = fleet_trace(P, libs, rmap, n_requests=24)
        a = P.serving.serve_trace(libs[0], [r for r in trace if rmap.primary(r.name) == 0],
                                  "accumulate", window=400_000, n_drives=2,
                                  drive_costs=costs(P))
        b = P.serving.serve_trace(libs[1], [r for r in trace if rmap.primary(r.name) == 1],
                                  "fifo", n_drives=2, drive_costs=costs(P))
        with pytest.raises(ValueError, match="disagrees on admission") as err:
            P.fleet.merge_reports([a, b])
        with pytest.raises(ValueError, match="at least one"):
            P.fleet.merge_reports([])
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------
# shared fault domain: a whole shard goes dark
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_outage_reroutes_orphans_to_surviving_replicas(backend):
    at = 1_500_000
    results = {}
    for placement in ("static-hash", "replica-affinity"):
        def run(P, backend=backend, **kw):
            return serve_fleet(P, backend, placement, outages=((at, 1),), drop=True, **kw)

        if backend == "python" or placement == "replica-affinity":
            ref, port = both(run)
            assert fleet_view(port) == fleet_view(ref)
        else:
            # static-hash piles the dark shard's share onto fewer cartridges:
            # a dispatch fails the int32 guard in both packages, so the port
            # serves it in float64 and keeps the reference's python timeline
            messages = []
            for P in (REF, PORT):
                with pytest.raises(ValueError, match="even after gcd rescaling") as err:
                    run(P)
                messages.append(str(err.value))
            assert messages[0] == messages[1]
            port = run(PORT, numeric_policy="f64")
            ref = run(REF, backend="python")
            assert timeline(port.merged) == timeline(ref.merged)
            assert (port.routes, port.n_rerouted) == (ref.routes, ref.n_rerouted)
        results[placement] = port
    affinity, static = results["replica-affinity"], results["static-hash"]
    assert affinity.n_rerouted > 0
    rerouted = [r for r in affinity.merged.served if r.faulted]
    assert len(rerouted) >= affinity.n_rerouted
    assert affinity.n_served > static.n_served
    assert affinity.n_failed == 0
    assert static.n_failed > 0
    for r in affinity.shards[1].served:
        assert r.dispatched < at
    assert affinity.shards[1].pool_stats["alive_drives"] == 0
    assert affinity.shards[1].pool_stats["drive_failures"] == 2
    for fr in results.values():
        assert fr.n_served + fr.n_failed == 120


@pytest.mark.parametrize("backend", BACKENDS)
def test_outage_before_arrivals_routes_away_immediately(backend):
    ref, fr = both(lambda P: serve_fleet(P, backend, "least-loaded", n_shards=2, replicas=2,
                                         n_requests=40, outages=((0, 0),), drop=True))
    assert fleet_view(fr) == fleet_view(ref)
    assert fr.n_served == 40 and fr.n_failed == 0
    assert fr.shards[0].n_served == 0


# ---------------------------------------------------------------------------
# journal-merge determinism from every cut point
# ---------------------------------------------------------------------------
def _journaled(P, backend, outages, journal, trace_rate=30_000):
    libs, rmap = build_fleet(P, n_shards=2, replicas=2)
    trace = fleet_trace(P, libs, rmap, n_requests=60, rate=trace_rate)
    kw = dict(placement="replica-affinity", replica_map=rmap,
              outages=tuple(P.serving.ShardOutage(at=at, shard=s) for at, s in outages),
              window=400_000, n_drives=2, drive_costs=costs(P),
              retry=P.serving.RetryPolicy(on_exhausted="drop"), context=context(P, backend))
    return libs, trace, kw


@pytest.mark.parametrize("backend", BACKENDS)
def test_recover_fleet_from_every_cut_point(backend, tmp_path):
    """The port's journals are the reference's bytes, and the port recovers
    from every cut of them byte for byte."""
    n_shards, outages = 2, ((1_500_000, 0),)
    ref_base, base = tmp_path / "ref.journal", tmp_path / "port.journal"
    libs, trace, kw = _journaled(REF, backend, outages, ref_base)
    REF.fleet.serve_fleet_trace(libs, trace, "accumulate", journal=str(ref_base), **kw)
    libs, trace, kw = _journaled(PORT, backend, outages, base)
    reference = PORT.fleet.serve_fleet_trace(libs, trace, "accumulate", journal=str(base), **kw)
    paths = [Path(PORT.fleet.shard_journal_path(base, i)) for i in range(n_shards)]
    ref_bytes = {i: p.read_bytes() for i, p in enumerate(paths)}
    assert ref_bytes == {i: Path(REF.fleet.shard_journal_path(ref_base, i)).read_bytes()
                         for i in range(n_shards)}
    ref_timeline = timeline(reference.merged)
    for shard in range(n_shards):
        n = len(ref_bytes[shard])
        for cut in (0, 10, n // 3, n // 2, n - 5, n):
            for i, p in enumerate(paths):
                p.write_bytes(ref_bytes[i])
            paths[shard].write_bytes(ref_bytes[shard][:cut])
            libs, trace, kw = _journaled(PORT, backend, outages, base)
            recovered = PORT.fleet.recover_fleet(libs, trace, str(base), "accumulate", **kw)
            assert timeline(recovered.merged) == ref_timeline, (
                f"shard {shard} cut at byte {cut} diverged")
            for i, p in enumerate(paths):
                assert p.read_bytes() == ref_bytes[i], (
                    f"shard {i} journal not byte-identical (cut {cut})")


def test_recover_fleet_rejects_foreign_journal(tmp_path):
    for P in (REF, PORT):
        base = tmp_path / f"{P.name}.journal"
        libs, trace, kw = _journaled(P, "python", (), base)
        P.fleet.serve_fleet_trace(libs, trace, "accumulate", journal=str(base), **kw)
        libs, trace, kw = _journaled(P, "python", (), base, trace_rate=25_000)
        with pytest.raises(P.serving.JournalReplayError):
            P.fleet.recover_fleet(libs, trace, str(base), "accumulate", **kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_merge_journals_is_deterministic(backend, tmp_path):
    streams = []
    for P in (REF, PORT):
        base = tmp_path / f"{P.name}.journal"
        libs, trace, kw = _journaled(P, backend, ((1_500_000, 0),), base)
        P.fleet.serve_fleet_trace(libs, trace, "accumulate", journal=str(base), **kw)
        stream = P.fleet.merge_journals(base, 2)
        assert stream == P.fleet.merge_journals(base, 2)
        assert all("shard" in ev for ev in stream)
        assert {ev["shard"] for ev in stream} == {0, 1}
        assert stream[0]["ev"] == "start" and stream[-1]["ev"] == "end"
        timed = [ev for ev in stream if ev["ev"] not in ("start", "end")]
        keys = [(ev["t"], ev["shard"]) for ev in timed]
        assert keys == sorted(keys)
        with pytest.raises(ValueError, match="n_shards"):
            P.fleet.merge_journals(base, 0)
        streams.append(stream)
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# trace schema v2: the optional origin-library label
# ---------------------------------------------------------------------------
def _qos_records(P, n_requests=12, **kw):
    return P.traces.qos_poisson_trace(build_library(P), n_requests=n_requests,
                                      mean_interarrival=50_000, seed=SEED, **kw)


def test_v1_trace_bytes_are_unchanged(tmp_path):
    texts = []
    for P in (REF, PORT):
        recs = _qos_records(P)
        assert all(r.library is None for r in recs)
        path = P.traces.write_trace(tmp_path / f"{P.name}.jsonl", recs)
        text = path.read_text()
        assert P.traces.TRACE_SCHEMA in text.splitlines()[0]
        assert "library" not in text
        assert P.traces.read_trace(path) == recs
        texts.append(path.read_bytes())
    assert texts[0] == texts[1]


def test_v2_trace_round_trips_library_labels(tmp_path):
    texts = []
    for P in (REF, PORT):
        recs = _qos_records(P, libraries=("shard0", "shard1", "shard2"))
        assert all(r.library in {"shard0", "shard1", "shard2"} for r in recs)
        path = P.traces.write_trace(tmp_path / f"{P.name}.jsonl", recs)
        assert P.traces.TRACE_SCHEMA_V2 in path.read_text().splitlines()[0]
        assert P.traces.read_trace(path) == recs
        texts.append(path.read_bytes())
    assert texts[0] == texts[1]


def test_v1_file_with_library_field_is_rejected(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text(
        '{"schema":"ltsp-trace/v1"}\n'
        '{"arrival":0,"tape":"t0","file":"f","library":"shard0"}\n'
    )
    for P in (REF, PORT):
        with pytest.raises(ValueError, match="needs a 'ltsp-trace/v2' header"):
            P.traces.read_trace(path)
        with pytest.raises(ValueError, match="non-empty label"):
            P.traces.TraceRecord(arrival=0, tape="t0", file="f", library="")


def test_library_draw_is_independent_of_the_workload():
    draws = []
    for P in (REF, PORT):
        plain = _qos_records(P, 24)
        labelled = _qos_records(P, 24, libraries=("a", "b"))
        assert [dataclasses.replace(r, library=None) for r in labelled] == plain
        assert labelled == _qos_records(P, 24, libraries=("a", "b"))
        assert {r.library for r in labelled} == {"a", "b"}
        with pytest.raises(ValueError, match="non-empty"):
            P.traces.qos_poisson_trace(build_library(P), n_requests=4,
                                       mean_interarrival=50_000, seed=SEED, libraries=())
        draws.append([dataclasses.astuple(r) for r in labelled])
    assert draws[0] == draws[1]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _demo_fleet_run(backend, tmp_path):
    """``chip_smoke.py`` phase 8a's replica-affinity case: the reference's
    fleet with a deadline trace and shard 1 dark from the median arrival."""
    libs, rmap = build_fleet(PORT)
    trace, qos = PORT.traces.to_requests(PORT.traces.qos_poisson_trace(
        PORT.fleet.fleet_catalog(libs, rmap), n_requests=180, mean_interarrival=30_000,
        seed=SEED, tightness=8_000_000))
    outage = PORT.serving.ShardOutage(at=sorted(r.time for r in trace)[90], shard=1)
    base = tmp_path / f"{backend}.journal"
    fr = PORT.fleet.serve_fleet_trace(
        libs, trace, "accumulate", placement="replica-affinity", replica_map=rmap,
        outages=(outage,), qos=qos, window=400_000, n_drives=2, drive_costs=costs(PORT),
        retry=PORT.serving.RetryPolicy(on_exhausted="drop"), journal=str(base),
        context=PORT.core.ExecutionContext(backend=backend, numeric_policy="f64"))
    return fr, PORT.fleet.merge_journals(base, 3)


@pytest.mark.cuda
def test_cuda_fleet_matches_python(tmp_path):
    import torch

    from repro_torch.kernels.ltsp_dp import ltsp_dp

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ltsp_dp.reset_launches()
    cuda, cuda_stream = _demo_fleet_run("cuda", tmp_path)
    assert ltsp_dp.LAUNCHES["near_fold_kernel"] > 0
    py, py_stream = _demo_fleet_run("python", tmp_path)
    cells = ("backend", "cells_evaluated", "cells_reused", "cells_per_batch")

    def view(fr):
        summary = [(k, v) for k, v in fr.summary().items() if k not in cells]
        return summary, [timeline(r) for r in fr.shards], fr.routes, fr.n_rerouted

    assert cuda.n_rerouted > 0
    assert view(cuda) == view(py)
    assert cuda_stream == py_stream
    assert all(b.degraded_to is None for r in cuda.shards for b in r.batches)
