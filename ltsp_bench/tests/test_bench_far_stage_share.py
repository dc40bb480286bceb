"""The far fold's share of block-stages staged, read from the counts the
card's table builds record on their ``ltsp.tables`` spans: the ratio of
their sums where every build carries them, silent where the run carries
nothing to read."""

import pytest

from ltsp_bench import cell as cells
from ltsp_bench import host_spans
from ltsp_bench.drivers import mounts

from .tiny import run_tiny, tiny_cell, tiny_config

KEYS = ("far_stages", "far_stages_full")


def share(run: dict):
    return cells.load_reader(cells.ROOT / cells.FOLDER / "metrics" / "far_stage_share.py")(run)


@pytest.fixture(scope="module")
def traced():
    out = run_tiny(tiny_cell("in2p3-dp.mounts"), trace=True)
    assert out["correct"]
    return out


def test_the_far_stage_share_is_read_on_the_card_only(traced):
    """Off the card the spans carry no block-stage counts, so nothing is
    read; counts on every build give their sums' ratio, and one build
    without them (a parent program's) leaves the share unread."""
    from repro_torch.obs.trace import HOST_SPANS

    run = traced["run"]
    assert "far_stage_share" not in traced["metrics"]
    assert share(run) is None
    builds = [s for _, tree in host_spans.traced_mounts(run) for s in tree
              if s.name == "ltsp.tables"]
    assert len(builds) >= 2
    try:
        for k, s in enumerate(builds):
            s.attrs.update(far_stages=k, far_stages_full=3 * k + 1)
        want = sum(range(len(builds))) / sum(3 * k + 1 for k in range(len(builds)))
        assert share(run) == pytest.approx(want, rel=1e-12)
        for s in builds:
            s.attrs.update(far_stages=0, far_stages_full=0)
        assert share(run) is None  # no build had a far launch
        for s in builds:
            s.attrs.update(far_stages=5, far_stages_full=5)
        assert share(run) == 1.0
        del builds[0].attrs["far_stages_full"]
        assert share(run) is None
    finally:
        for s in builds:
            for key in KEYS:
                s.attrs.pop(key, None)
    assert HOST_SPANS.spans and share(run) is None


def test_an_untraced_run_reads_nothing():
    assert share({"kind": "mounts", "solves": [], "profile": None}) is None


def test_a_log_shifted_by_one_solve_reads_nothing(traced):
    """One more root after the traced pass's, with counts on every build:
    the last roots no longer match the traced solves, so the reader does
    not take them for the pass."""
    from repro_torch.core.instance import make_instance
    from repro_torch.core.solver import ExecutionContext, solve
    from repro_torch.obs.trace import HOST_SPANS

    run = traced["run"]
    t = dict(mounts.tape_set(tiny_config()))[run["profile"]["solves"][0]["tape"]]
    with HOST_SPANS.recording():
        solve(make_instance(t["left"], t["size"], t["mult"], m=t["m"], u_turn=t["u_turn"]),
              "dp", context=ExecutionContext(backend="torch", device="cpu",
                                              numeric_policy="f64"))
    builds = [s for s in HOST_SPANS.spans if s.name == "ltsp.tables"]
    try:
        for s in builds:
            s.attrs.update(far_stages=1, far_stages_full=2)
        assert share(run) is None
    finally:
        for s in builds:
            for key in KEYS:
                s.attrs.pop(key, None)
