"""The metrics read from the program's host-clock spans: found only in the
traced pass, matched to its solves mount for mount, and silent where the
spans do not line up or carry no device time."""

import pytest

from ltsp_bench import cell as cells
from ltsp_bench.drivers import mounts

from .tiny import run_tiny, tiny_cell, tiny_config

READERS = ("host_ms_per_tape", "host_copies_per_tape", "build_device_ms_p95")


def reader(name: str):
    return cells.load_reader(cells.ROOT / cells.FOLDER / "metrics" / f"{name}.py")


@pytest.fixture(scope="module")
def traced():
    out = run_tiny(tiny_cell("in2p3-dp.mounts"), trace=True)
    assert out["correct"]
    return out


def test_a_traced_run_reads_the_host_time_and_eight_copies(traced):
    assert traced["metrics"]["host_ms_per_tape"]["value"] > 0
    assert traced["metrics"]["host_copies_per_tape"]["value"] == 8
    assert reader("host_copies_per_tape")(traced["run"]) == 8


def test_the_build_has_no_device_time_off_the_card(traced):
    assert "build_device_ms_p95" not in traced["metrics"]
    assert reader("build_device_ms_p95")(traced["run"]) is None


@pytest.mark.parametrize("name", READERS)
def test_a_log_shifted_by_one_solve_reads_nothing(name, traced):
    """One more root after the traced pass's: the last roots no longer
    match the traced solves, so no reader takes them for the pass."""
    from repro_torch.core.instance import make_instance
    from repro_torch.core.solver import ExecutionContext, solve
    from repro_torch.obs.trace import HOST_SPANS

    run = traced["run"]
    t = dict(mounts.tape_set(tiny_config()))[run["profile"]["solves"][0]["tape"]]
    with HOST_SPANS.recording():
        solve(make_instance(t["left"], t["size"], t["mult"], m=t["m"], u_turn=t["u_turn"]),
              "dp", context=ExecutionContext(backend="torch", device="cpu",
                                              numeric_policy="f64"))
    assert reader(name)(run) is None


@pytest.mark.parametrize("name", READERS)
def test_an_untraced_run_reads_nothing(name):
    assert reader(name)({"kind": "mounts", "solves": [], "profile": None}) is None
