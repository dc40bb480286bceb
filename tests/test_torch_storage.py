"""The port's tape library, data generator and replay oracle against the
JAX package's: identical read plans per policy, bit-identical datasets from
the same seeds, identical schedule replays."""

import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.data import generator as ref_generator
from repro.data import paper_instances as ref_paper
from repro.serving.sim import replay_schedule as ref_replay
from repro.storage.tape import Tape as RefTape
from repro.storage.tape import TapeLibrary as RefLibrary
from repro.storage.tape import schedule_reads as ref_schedule_reads
from repro_torch.data import generator as port_generator
from repro_torch.data import paper_instances as port_paper
from repro_torch.serving.sim import replay_schedule as port_replay
from repro_torch.storage.tape import PendingQueue, Tape, TapeLibrary, schedule_reads
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

POLICIES = ["nodetour", "gs", "fgs", "nfgs", "lognfgs5", "logdp1", "logdp5", "simpledp", "dp"]


def _libraries(n_files=36, seed=3):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(20_000, 120_000, size=n_files)]
    ours = TapeLibrary(capacity_per_tape=1_000_000, u_turn=700)
    theirs = RefLibrary(capacity_per_tape=1_000_000, u_turn=700)
    for i, size in enumerate(sizes):
        ours.store(f"f{i:03d}", size)
        theirs.store(f"f{i:03d}", size)
    reqs = {f"f{i:03d}": int(rng.integers(1, 8)) for i in rng.choice(n_files, 24, replace=False)}
    return ours, theirs, reqs


def _plan_fields(plan):
    return dataclasses.astuple(plan)


@pytest.mark.parametrize("policy", POLICIES)
def test_library_plans_match_reference(policy):
    ours, theirs, reqs = _libraries()
    assert len(ours.tapes) == len(theirs.tapes) >= 3
    assert [_plan_fields(p) for p in ours.schedule(reqs, policy=policy)] == [
        _plan_fields(p) for p in theirs.schedule(reqs, policy=policy)]


@pytest.mark.parametrize("policy", ["dp", "logdp5", "simpledp"])
def test_library_torch_backend_plans_equal_python(policy):
    ours, _, reqs = _libraries(seed=4)
    python = ours.schedule(reqs, policy=policy)
    device = ours.schedule(
        reqs, policy=policy, context=port_core.ExecutionContext(backend="torch", device="cpu"))
    for a, b in zip(python, device):
        assert (a.order, a.total_cost, a.detours, a.service_time) == (
            b.order, b.total_cost, b.detours, b.service_time)
        assert b.backend == "torch"
        tape = ours.tapes[[t.tape_id for t in ours.tapes].index(b.tape_id)]
        inst, _ = tape.instance({n: reqs[n] for n in b.order})
        assert b.total_cost == port_replay(inst, b.detours).cost


def test_schedule_reads_matches_reference():
    rng = np.random.default_rng(1)
    ours, theirs = Tape("T0", 10_000_000, 1000), RefTape("T0", 10_000_000, 1000)
    for i in range(25):
        size = int(rng.integers(1000, 400_000))
        ours.append(f"f{i:03d}", size)
        theirs.append(f"f{i:03d}", size)
    names = list(ours.files)
    reqs = {n: int(rng.integers(1, 20)) for n in rng.choice(names, 12, replace=False)}
    for policy in ("dp", "simpledp", "logdp1", "gs", "nodetour"):
        assert _plan_fields(schedule_reads(ours, reqs, policy=policy)) == _plan_fields(
            ref_schedule_reads(theirs, reqs, policy=policy))


def test_pending_queue_orders_oldest_first():
    q = PendingQueue()
    for item in ((5, "b"), (1, "a"), (9, "c"), (1, "0")):
        q.push(item)
    assert len(q) == 4 and q.peek() == (1, "0")
    assert q.pop() == (1, "0") and q.drain() == [(1, "a"), (5, "b"), (9, "c")]
    assert len(q) == 0


@pytest.mark.parametrize("profile", ["PAPER_PROFILE", "SMALL_PROFILE", "BENCH_PROFILE"])
def test_generator_is_bit_identical(profile):
    ours = port_generator.generate_dataset(getattr(port_generator, profile), u_turn=1234)
    theirs = ref_generator.generate_dataset(getattr(ref_generator, profile), u_turn=1234)
    assert len(ours) == len(theirs) == getattr(ref_generator, profile).n_tapes
    for a, b in zip(ours, theirs):
        for field in ("left", "right", "mult"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert (a.m, a.u_turn) == (b.m, b.u_turn)
    assert port_generator.u_turn_values(ours) == ref_generator.u_turn_values(theirs)


def test_paper_families_are_identical():
    for name, args in (("gs_worst_case", ()), ("gs_worst_case", (300, 40)),
                       ("simpledp_worst_case", ()), ("simpledp_worst_case", (7,)),
                       ("logdp_worst_case", ()), ("logdp_worst_case", (9,))):
        ours, theirs = getattr(port_paper, name)(*args), getattr(ref_paper, name)(*args)
        assert np.array_equal(ours.left, theirs.left) and np.array_equal(ours.mult, theirs.mult)
        assert np.array_equal(ours.right, theirs.right)
        assert (ours.m, ours.u_turn) == (theirs.m, theirs.u_turn)


def test_replay_and_verify_match_reference():
    from repro.core.verify import verify_schedule as ref_verify
    from repro_torch.core.verify import verify_schedule

    rng = np.random.default_rng(9)
    for _ in range(10):
        R = int(rng.integers(2, 10))
        left = np.cumsum(rng.integers(1, 60, size=R)).tolist()
        sizes = rng.integers(1, 30, size=R).tolist()
        left = [l + sum(sizes[:i]) for i, l in enumerate(left)]
        mult = rng.integers(1, 6, size=R).tolist()
        ours = port_core.make_instance(left, sizes, mult, u_turn=int(rng.integers(0, 20)))
        theirs = ref_core.make_instance(left, sizes, mult, u_turn=ours.u_turn)
        cost, dets = port_core.dp_schedule(ours)
        a, b = port_replay(ours, dets), ref_replay(theirs, dets)
        assert (a.service_time, a.cost, a.makespan, a.distance, a.n_uturns) == (
            b.service_time, b.cost, b.makespan, b.distance, b.n_uturns)
        assert [dataclasses.astuple(x) for x in a.legs] == [dataclasses.astuple(y) for y in b.legs]
        assert verify_schedule(ours, dets, cost) == ref_verify(theirs, dets, cost) == cost
    with pytest.raises(ValueError, match="claimed cost"):
        verify_schedule(ours, dets, cost + 1)
