"""The port's online serving loop and drive pool against the JAX package's.

The scenarios of ``tests/test_serving.py`` and ``tests/test_drives.py``, served
through both packages on the ``python`` backend from the same seeded library
and trace: the served timelines, batch records, ``summary()`` rows (key order
included) and the write-ahead journal bytes must be identical.  The schedule
replay oracle (``replay_schedule``, ``verify_schedule``) and the simulator's
primitives are held against the reference on seeded instances as well.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro.serving as ref_serving
import repro_torch.core as port_core
import repro_torch.serving as port_serving
from repro.core.verify import verify_schedule as ref_verify
from repro_torch.core.instance import make_instance as port_make_instance
from repro_torch.core.verify import verify_schedule as port_verify
from torch_parity import PORT, REF, context, costs, library, run_both, trace
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def serve_trace(P, backend, journal, admission, *, tr=None, lib=None, ctx_changes=None, **kw):
    lib = library(P) if lib is None else lib
    return P.serving.serve_trace(
        lib, trace(P) if tr is None else tr, admission, policy=kw.pop("policy", "dp"),
        context=context(P, lib, backend, **(ctx_changes or {})), journal=journal, **kw,
    )


# ---------------------------------------------------------------------------
# tests/test_serving.py scenarios
# ---------------------------------------------------------------------------
@scenario
def fifo_240(P, backend, journal):
    return serve_trace(P, backend, journal, "fifo")


@scenario
def accumulate_240(P, backend, journal):
    return serve_trace(P, backend, journal, "accumulate", window=400_000)


@scenario
def preempt_240_fast(P, backend, journal):
    return serve_trace(P, backend, journal, "preempt", tr=trace(P, 240, 150_000))


@scenario
def accumulate_whole_horizon(P, backend, journal):
    tr = trace(P, 100)
    return serve_trace(P, backend, journal, "accumulate", tr=tr, window=tr[-1].time + 1)


@scenario
def nodetour_policy(P, backend, journal):
    return serve_trace(P, backend, journal, "accumulate", tr=trace(P, 60),
                       window=400_000, policy="nodetour")


@scenario
def simpledp_policy(P, backend, journal):
    return serve_trace(P, backend, journal, "accumulate", tr=trace(P, 60),
                       window=400_000, policy="simpledp")


@scenario
def cold_no_verify(P, backend, journal):
    return serve_trace(P, backend, journal, "preempt", tr=trace(P, 120),
                       verify=False, warm_start=False)


# ---------------------------------------------------------------------------
# tests/test_drives.py scenarios: the shared drive pool
# ---------------------------------------------------------------------------
def pool(P, backend, journal, admission, **kw):
    return serve_trace(P, backend, journal, admission, window=400_000, n_drives=2,
                       drive_costs=costs(P), **kw)


@scenario
def pool_fifo_global(P, backend, journal):
    return pool(P, backend, journal, "fifo-global")


@scenario
def pool_per_drive_accumulate(P, backend, journal):
    return pool(P, backend, journal, "per-drive-accumulate")


@scenario
def pool_batched(P, backend, journal):
    return pool(P, backend, journal, "batched")


@scenario
def pool_preempt(P, backend, journal):
    return pool(P, backend, journal, "preempt", tr=trace(P, 240, 150_000))


@scenario
def pool_lru_scheduler(P, backend, journal):
    return pool(P, backend, journal, "per-drive-accumulate", mount_scheduler="lru")


@scenario
def pool_lookahead_scheduler(P, backend, journal):
    return pool(P, backend, journal, "fifo-global", mount_scheduler="lookahead")


@scenario
def pool_three_drives_no_warm(P, backend, journal):
    return serve_trace(P, backend, journal, "batched", window=300_000, n_drives=3,
                       drive_costs=costs(P), warm_start=False)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_serving_scenario_matches_reference(name, tmp_path):
    (ref, ref_journal), (port, port_journal) = run_both(SCENARIOS[name], tmp_path)
    assert port == ref
    assert port_journal == ref_journal


@pytest.mark.parametrize("admission", sorted(ref_serving.ADMISSIONS))
def test_every_admission_matches_reference(admission):
    views = []
    for P in (REF, PORT):
        report = P.serving.serve_trace(library(P), trace(P, 220), admission,
                                       window=300_000, policy="dp")
        views.append((report.summary(), [dataclasses.astuple(r) for r in report.served],
                      [dataclasses.astuple(b) for b in report.batches]))
    assert views[1] == views[0]


def test_admission_registries_match_reference():
    for name in ("ADMISSIONS", "LEGACY_ADMISSIONS", "POOL_ADMISSIONS", "QOS_ADMISSIONS",
                 "WINDOWED_ADMISSIONS", "MOUNT_SCHEDULERS"):
        assert list(getattr(port_serving, name)) == list(getattr(ref_serving, name)), name
    assert sorted(port_serving.__all__) == sorted(ref_serving.__all__)
    for P in (REF, PORT):
        with pytest.raises(ValueError, match="admission"):
            P.serving.OnlineTapeServer(library(P), "lifo")


def test_shared_cache_across_runs_matches_reference():
    stats = []
    for P in (REF, PORT):
        cache = P.core.SolveCache()
        ctx = P.core.ExecutionContext(cache=cache)
        totals = [P.serving.serve_trace(library(P), trace(P, 80), "accumulate", window=300_000,
                                        policy="dp", context=ctx).total_sojourn
                  for _ in range(2)]
        stats.append((totals, cache.hits, cache.misses, len(cache)))
    assert stats[1] == stats[0]


def test_drive_pool_primitives_match_reference():
    out = []
    for P in (REF, PORT):
        p = P.serving.DrivePool(2, costs(P))
        trail = [(d.drive_id, delay) for d, delay in (p.acquire(t) for t in "ABAC")]
        trail.append(p.stats())
        trail.append(p.drive_of("A"))
        out.append(trail)
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# simulator primitives and the schedule replay oracle
# ---------------------------------------------------------------------------
def test_poisson_trace_and_demo_library_match_reference():
    for seed in (1, 2, 7):
        ref_lib, port_lib = library(REF, seed), library(PORT, seed)
        assert port_lib.location == ref_lib.location
        assert [(t.tape_id, t.used) for t in port_lib.tapes] == [
            (t.tape_id, t.used) for t in ref_lib.tapes]
        for skew in (1.1, 0.4):
            ref_tr = ref_serving.poisson_trace(ref_lib, 50, 100_000, seed=seed, skew=skew)
            port_tr = port_serving.poisson_trace(port_lib, 50, 100_000, seed=seed, skew=skew)
            assert [dataclasses.astuple(r) for r in port_tr] == [
                dataclasses.astuple(r) for r in ref_tr]
    for P in (REF, PORT):
        with pytest.raises(ValueError, match="mean_interarrival"):
            P.serving.poisson_trace(library(P), 5, 0, seed=1)


def _instance_pair(rng):
    R = int(rng.integers(2, 12))
    sizes = rng.integers(1, 60, size=R)
    gaps = rng.integers(0, 50, size=R + 1)
    left, pos = [], int(gaps[0])
    for i in range(R):
        left.append(pos)
        pos += int(sizes[i] + gaps[i + 1])
    mult = rng.integers(1, 8, size=R)
    u = int(rng.integers(0, 40))
    m = pos + int(rng.integers(0, 30))
    return (port_make_instance(left, sizes, mult, m=m, u_turn=u),
            ref_core.make_instance(left, sizes, mult, m=m, u_turn=u))


@pytest.mark.parametrize("tag", range(4))
def test_replay_oracle_matches_reference(tag):
    rng = np.random.default_rng([20260731, tag])
    for _ in range(10):
        port_inst, ref_inst = _instance_pair(rng)
        for policy in ("dp", "simpledp", "gs", "nodetour"):
            res = ref_core.solve(ref_inst, policy)
            ref_rep = ref_serving.replay_schedule(ref_inst, res.detours)
            port_rep = port_serving.replay_schedule(port_inst, res.detours)
            assert (port_rep.cost, port_rep.makespan, port_rep.n_uturns,
                    port_rep.head_at_makespan, list(port_rep.service_time)) == (
                ref_rep.cost, ref_rep.makespan, ref_rep.n_uturns, ref_rep.head_at_makespan,
                list(ref_rep.service_time))
            assert [dataclasses.astuple(leg) for leg in port_rep.legs] == [
                dataclasses.astuple(leg) for leg in ref_rep.legs]
            for t in (0, ref_rep.makespan // 3, ref_rep.makespan):
                assert port_serving.head_position(port_rep.legs, t) == \
                    ref_serving.head_position(ref_rep.legs, t)
            assert port_serving.rewind_time(port_inst.m, port_inst.u_turn,
                                            port_rep.head_at_makespan) == \
                ref_serving.rewind_time(ref_inst.m, ref_inst.u_turn, ref_rep.head_at_makespan)
            assert port_verify(port_inst, res.detours, cost=res.cost) == \
                ref_verify(ref_inst, res.detours, cost=res.cost)
        res = port_core.solve(port_inst, "dp")
        with pytest.raises(ValueError, match="claimed cost"):
            port_verify(port_inst, res.detours, cost=res.cost - 1)


# ---------------------------------------------------------------------------
# tests/test_properties.py: the replay oracle on arbitrary detour lists
# ---------------------------------------------------------------------------
def _port_twin(inst):
    return port_make_instance(inst.left.tolist(), (inst.right - inst.left).tolist(),
                              inst.mult.tolist(), m=int(inst.m), u_turn=int(inst.u_turn))


@pytest.mark.parametrize("seed", [20260731, 11, 12])
def test_replay_oracle_on_arbitrary_detours_matches_reference(seed):
    from conftest import fallback_instances

    for inst in fallback_instances(25, seed=seed, max_u=18, max_head_offset=25):
        twin = _port_twin(inst)
        R = inst.n_req
        rng = np.random.default_rng(int(inst.m) + R)
        for _ in range(4):
            a = int(rng.integers(0, R))
            dets = [(a, int(rng.integers(a, R)))]
            if rng.random() < 0.5:
                a2 = int(rng.integers(0, R))
                dets.append((a2, int(rng.integers(a2, R))))
            ref = ref_serving.replay_schedule(inst, dets)
            port = port_serving.replay_schedule(twin, dets)
            assert dataclasses.astuple(port) == dataclasses.astuple(ref), dets
            assert port.cost == port_core.evaluate_detours(twin, dets)


def test_verify_schedule_rejects_malformed_detours_like_reference():
    from conftest import fallback_instances

    inst = fallback_instances(1, seed=7, min_files=3, max_files=3)[0]
    twin = _port_twin(inst)
    bad = [([(0, 3)], None), ([(-1, 1)], None),
           ([], ref_core.solve(inst, "nodetour").cost + 1)]
    for dets, cost in bad:
        errors = []
        for verify, i in ((ref_verify, inst), (port_verify, twin)):
            with pytest.raises(ValueError) as err:
                verify(i, dets, cost=cost)
            errors.append(str(err.value))
        assert errors[1] == errors[0]
