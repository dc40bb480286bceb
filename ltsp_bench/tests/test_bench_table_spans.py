"""The metrics read from the table build's span attributes and from each
tape's own mounts: the layout and bytes every traced build records, the
allocator's retries summed over the traced pass, and the slowest tape's
median wait; silent where the run carries nothing to read."""

import pytest

from ltsp_bench import cell as cells
from ltsp_bench import host_spans
from ltsp_bench.drivers import mounts

from .tiny import run_tiny, tiny_cell, tiny_config

SPAN_READERS = ("alloc_retries_per_pass",)
READERS = SPAN_READERS + ("slowest_tape_solve_ms",)


def reader(name: str):
    return cells.load_reader(cells.ROOT / cells.FOLDER / "metrics" / f"{name}.py")


@pytest.fixture(scope="module")
def traced():
    out = run_tiny(tiny_cell("in2p3-dp.mounts"), trace=True)
    assert out["correct"]
    return out


def test_every_traced_build_stores_its_tables_packed(traced):
    """The mounts' solves are uncaptured, so each one's build stores ``T`` and
    ``C`` packed, over the windows ``a <= b`` of the shape it was built at:
    float64 at the tight shape past the int32 guard, int32 at the bucket
    shape inside it."""
    from repro_torch.core.instance import make_instance
    from repro_torch.kernels.ltsp_dp import ops

    tapes = dict(mounts.tape_set(tiny_config()))
    run = traced["run"]
    traced_mounts = host_spans.traced_mounts(run)
    assert len(traced_mounts) == len(run["profile"]["solves"])
    for (_, tree), solve in zip(traced_mounts, run["profile"]["solves"]):
        t = tapes[solve["tape"]]
        inst = make_instance(t["left"], t["size"], t["mult"], m=t["m"], u_turn=t["u_turn"])
        wide = ops._table_bound(ops.rescale_instance(inst)[0]) >= 2**31
        R, S = ops.tight_shape(inst) if wide else ops.bucket_shape(inst)
        [tables] = host_spans.named(tree, "ltsp.tables")
        assert tables.attrs["layout"] == "packed"
        assert tables.attrs["table_bytes"] == R * (R + 1) // 2 * S * (12 if wide else 8)


def test_the_allocator_retries_are_read_on_the_card_only(traced):
    """Off the card the spans carry no allocator count, so nothing is read;
    a count on every build is summed over the pass."""
    from repro_torch.obs.trace import HOST_SPANS

    run = traced["run"]
    assert "alloc_retries_per_pass" not in traced["metrics"]
    assert reader("alloc_retries_per_pass")(run) is None
    builds = [s for _, tree in host_spans.traced_mounts(run) for s in tree
              if s.name == "ltsp.tables"]
    assert len(builds) == len(run["profile"]["solves"])
    try:
        for k, s in enumerate(builds):
            s.attrs["alloc_retries"] = k % 3
        assert reader("alloc_retries_per_pass")(run) == sum(k % 3 for k in range(len(builds)))
    finally:
        for s in builds:
            s.attrs.pop("alloc_retries")
    assert HOST_SPANS.spans and reader("alloc_retries_per_pass")(run) is None


def test_the_slowest_tape_is_the_largest_median_of_its_own_mounts(traced):
    """Each tape's median over its own mounts, the largest of them: one
    slow mount of a tape (such as the traced pass's) does not move it."""
    slowest = reader("slowest_tape_solve_ms")
    solves = [{"tape": 3, "seconds": v, "ok": True} for v in (0.5, 0.7, 9.0)]
    solves += [{"tape": 5, "seconds": v, "ok": True} for v in (0.6, 0.6)]
    solves += [{"tape": 7, "seconds": 50.0, "ok": False}]
    assert slowest({"kind": "mounts", "solves": solves}) == pytest.approx(700.0)
    assert slowest({"kind": "mounts", "solves": solves[-1:]}) is None
    assert slowest({"kind": "mounts", "solves": []}) is None
    by_tape = {}
    for s in traced["run"]["solves"]:
        by_tape.setdefault(s["tape"], []).append(s["seconds"])
    medians = [sorted(v)[len(v) // 2] if len(v) % 2 else sum(sorted(v)[len(v) // 2 - 1:
               len(v) // 2 + 1]) / 2 for v in by_tape.values()]
    assert slowest(traced["run"]) == pytest.approx(1e3 * max(medians), rel=1e-12)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_log_shifted_by_one_solve_reads_nothing(name, traced):
    """One more root after the traced pass's: the last roots no longer
    match the traced solves, so no reader of the spans takes them for the
    pass."""
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
