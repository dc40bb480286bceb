"""The comparison that decides ``correct``: the reference against the
program's exact DP, its float32 control failing, and runs whose timed path
is broken underneath coming out not correct."""

import numpy as np
import pytest
import torch

from ltsp_bench import reference, roofline
from ltsp_bench import tapes as tapegen
from ltsp_bench.drivers import mounts

from .test_bench_frozen import BENCH
from .tiny import run_tiny, tiny_cell

WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def random_tape(rng, R: int) -> dict:
    sizes = rng.integers(1, 50, size=R)
    gaps = rng.integers(0, 30, size=R)
    left = np.cumsum(gaps + np.concatenate([[0], sizes[:-1]]))
    return {"left": left, "size": sizes, "mult": rng.integers(1, 5, size=R),
            "m": int(left[-1] + sizes[-1] + rng.integers(0, 50)),
            "u_turn": int(rng.integers(0, 40))}


@pytest.mark.parametrize("span", [None, 1, 2, 3])
def test_reference_equals_the_programs_python_dp(span):
    from repro_torch.core.dp import dp_schedule
    from repro_torch.core.instance import make_instance, virtual_lb

    rng = np.random.default_rng(7 if span is None else span)
    for _ in range(60):
        t = random_tape(rng, int(rng.integers(1, 10)))
        inst = make_instance(t["left"], t["size"], t["mult"], m=t["m"], u_turn=t["u_turn"])
        cost, dets = dp_schedule(inst, span=span)
        root, rdets = reference.dp_solve(t["left"], t["size"], t["mult"], t["u_turn"], span,
                                         torch.float64, "cpu")
        vlb = reference.virtual_lb(t["left"], t["size"], t["mult"], t["m"], t["u_turn"])
        assert vlb == virtual_lb(inst)
        assert int(root) + vlb == cost
        for d in (dets, rdets):
            assert reference.schedule_cost(t["left"], t["size"], t["mult"], t["m"],
                                           t["u_turn"], d) == cost


@pytest.mark.parametrize("span", [None, 1, 3])
def test_reference_in_blocks_inside_a_width_equals_the_programs_python_dp(monkeypatch, span):
    """Tapes of 20-40 files, with blocks so small that a window width folds
    in several: the tables ``a <= b`` still give the optimum, and the
    detours walked from them replay to it."""
    from repro_torch.core.dp import dp_schedule
    from repro_torch.core.instance import make_instance

    rng = np.random.default_rng(40 if span is None else 40 + span)
    for _ in range(4):
        t = random_tape(rng, int(rng.integers(20, 41)))
        # a width of k candidates folds 5 // k windows a block: the first
        # widths in blocks of several, from 5 one window a block
        monkeypatch.setattr(reference, "BLOCK_ELEMENTS", 5 * (int(t["mult"].sum()) + 1))
        inst = make_instance(t["left"], t["size"], t["mult"], m=t["m"], u_turn=t["u_turn"])
        cost, _ = dp_schedule(inst, span=span)
        got, dets = reference.solve(t, span, torch.float64, "cpu")
        assert got == cost
        assert reference.schedule_cost(t["left"], t["size"], t["mult"], t["m"], t["u_turn"],
                                       dets) == cost


def paper_tapes(count: int = 3) -> list[dict]:
    """The configuration's ``count`` smallest paper tapes."""
    from .test_bench_frozen import config

    ds = config("in2p3-dp")["dataset"]
    tapes = tapegen.generate_tapes(ds["profile"], ds["base_seed"], ds["u_turn"])
    return sorted(tapes, key=lambda t: len(t["left"]))[:count]


@pytest.mark.parametrize("policy", ["dp", "logdp1"])
def test_float32_control_fails_where_float64_passes(policy):
    """The reference in float32, put in the program's place, reads a gap on
    paper tapes; in float64 it reads none."""
    control = {"cost": 0, "plan": 0}
    for tape in paper_tapes():
        opt, dets = mounts.reference_answer(tape, policy, torch.float64, "cpu")
        assert mounts.compare(tape, [(opt, dets)], opt) == {"cost": 0, "plan": 0}
        answer = mounts.reference_answer(tape, policy, torch.float32, "cpu")
        for k, v in mounts.compare(tape, [answer], opt).items():
            control[k] = max(control[k], v)
    assert max(control.values()) > mounts.LIMITS["answer_gap"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_each_tiny_cell(workload):
    """``control.py``'s readings at a tiny size: each seed's float32
    answers, through the driver's own check, read a gap over a limit."""
    from ltsp_bench import cell as cells
    from ltsp_bench.control import control_readings

    cell = tiny_cell(workload)
    driver = cells.load_driver(cell.traffic["kind"])
    for seed in (1, 2**31 + 9, 77):
        gaps = control_readings(cell, driver, seed, "cpu")
        assert gaps["answer_gap"] > driver.LIMITS["answer_gap"], gaps


def suboptimal(monkeypatch, alter_cost: bool = False):
    """Break the timed path underneath: every device solve returns the plan
    with no detour at its true cost (or the optimal plan with its cost
    altered)."""
    from repro_torch.kernels.ltsp_dp import ops

    real = ops.ltsp_solve_batch

    def broken(instances, *args, **kwargs):
        out = real(instances, *args, **kwargs)
        results = out[0] if isinstance(out, tuple) else out
        for j, inst in enumerate(instances):
            cost, dets = results[j]
            if alter_cost:
                results[j] = (cost + 1, dets)
            else:
                results[j] = (reference.schedule_cost(inst.left, inst.size, inst.mult, inst.m,
                                                      inst.u_turn, []), [])
        return out

    monkeypatch.setattr(ops, "ltsp_solve_batch", broken)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("alter_cost", [False, True])
def test_a_broken_answer_is_not_correct(monkeypatch, workload, alter_cost):
    """An answer altered where it is produced: a suboptimal plan at its own
    cost, or the optimal plan with its cost off by one."""
    suboptimal(monkeypatch, alter_cost)
    out = run_tiny(tiny_cell(workload), seconds=0.3)
    assert not out["correct"]
    assert out["failed"] > 0 or any(c["value"] > c["limit"] for c in out["checks"].values())


def test_a_detour_outside_the_tape_reads_a_gap():
    tape = paper_tapes(1)[0]
    opt, dets = mounts.reference_answer(tape, "dp", torch.float64, "cpu")
    R = len(tape["left"])
    assert mounts.compare(tape, [(opt, dets + ((0, R),))], opt)["plan"] > 0


def test_a_failed_solve_is_counted(monkeypatch):
    from repro_torch.kernels.ltsp_dp import ops

    cell = tiny_cell("in2p3-dp.mounts")
    state = mounts.setup(cell, "cpu", "torch")

    def raising(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ops, "ltsp_solve_batch", raising)
    run = mounts.window(state, 5, 0.05, False)
    assert run["failed"] == run["attempted"] > 0


def test_seeded_streams_take_large_seeds():
    a = tapegen.seeded(2**31 + 3, 0).permutation(10)
    assert np.array_equal(a, tapegen.seeded(2**31 + 3, 0).permutation(10))
    assert not np.array_equal(a, tapegen.seeded(2**31 + 4, 0).permutation(10))
    assert roofline.policy_span("logdp1", 2) == 1
