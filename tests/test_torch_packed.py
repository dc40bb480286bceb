"""Packed tables: ``T`` and ``C`` over the windows ``a <= b`` alone.

A packed table ``[B, R(R+1)/2, S]`` holds window ``(a, b)`` at row
``a R - a(a-1)/2 + (b - a)``, the row order of the benchmark's reference
(``ltsp_bench/reference.py``).  On the CPU the plain packed build must equal
the dense build on every window ``a <= b``, ``T`` and ``C`` bit for bit, under
every policy and table type and at ``R`` from 1 to 40 (0 to 4 tile diagonals,
ragged last tiles, both scan forms); the packed traceback must walk as the
dense one and ``ops.traceback_detours`` do; the solver's packed path must
answer as the benchmark's reference does.

The tests marked ``cuda`` hold the card's packed build and traceback against
its dense ones, and a ``solve`` on ``cuda`` against ``backend="python"``;
they skip without a card: ``pytest -m cuda tests/test_torch_packed.py``.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core.dp import logdp_span
from repro_torch.core.instance import make_instance
from repro_torch.kernels.ltsp_dp import ltsp_dp, ops, ref
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

SEED = 20211229
#: policy -> (span rule, disjoint)
POLICIES = {
    "dp": (None, False),
    "logdp1": (1.0, False),
    "logdp5": (5.0, False),
    "simpledp": (None, True),
}
#: 0 to 4 tile diagonals at the tile of 8, full and ragged last tiles
RS = [1, 2, 7, 8, 9, 23, 40]
#: the candidate tile of the reference's scan: R - 1 <= 8 takes the static
#: form, the wider tables the banded one
CAND_TILE = 8


def policy_kwargs(policy: str, R: int) -> dict:
    lam, disjoint = POLICIES[policy]
    return {"span": None if lam is None else logdp_span(R, lam), "disjoint": disjoint}


def random_instance(rng, n_req: int):
    left = np.sort(rng.choice(40 * n_req + 10, n_req, replace=False)) * 3
    size = np.minimum(rng.integers(1, 6, n_req), np.diff(np.append(left, left[-1] + 9)))
    return make_instance(left, size, rng.integers(1, 4, n_req), m=int(left[-1] + 50),
                         u_turn=int(rng.integers(0, 20)))


@functools.cache
def tables(policy: str, dtype_name: str, R: int):
    """``(arrays, S, dense, packed)``: two instances (the second narrower,
    padded with phantom files) built dense and packed by the plain tiled
    version of the table driver."""
    rng = np.random.default_rng([SEED, R, list(POLICIES).index(policy)])
    insts = [random_instance(rng, R), random_instance(rng, max(1, R - 3))]
    *arrays, S = ops.prepare_batch(insts, dtype=getattr(torch, dtype_name), R_pad=R,
                                   device="cpu")
    kw = dict(S=S, cand_tile=CAND_TILE, device="cpu", **policy_kwargs(policy, R))
    dense = ltsp_dp.ltsp_dp_tables(*arrays, **kw)
    packed = ltsp_dp.ltsp_dp_tables(*arrays, packed=True, **kw)
    return arrays, S, dense, packed


def upper(t: torch.Tensor) -> torch.Tensor:
    """The windows ``a <= b`` of a dense table, in the packed row order."""
    a, b = torch.triu_indices(t.shape[1], t.shape[1])
    return t[:, a, b, :]


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("dtype_name", ["float64", "float32", "int32"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_plain_packed_build_equals_the_dense_on_every_window(policy, dtype_name, R):
    _, _, (Td, Cd), (Tp, Cp) = tables(policy, dtype_name, R)
    assert Tp.shape == (2, R * (R + 1) // 2, Td.shape[-1]) and Tp.dtype == Td.dtype
    assert torch.equal(Tp, upper(Td)) and torch.equal(Cp, upper(Cd))


@pytest.mark.parametrize("R", [1, 9, 40])
@pytest.mark.parametrize("policy", ["dp", "simpledp"])
def test_per_diagonal_packed_build_equals_the_tiled(policy, R):
    """The reference's own schedule (one anti-diagonal a step) builds the
    same packed tables as the tiled one."""
    arrays, S, _, (Tp, Cp) = tables(policy, "float64", R)
    T, C = ref.ltsp_dp_tables_ref(*arrays, S=S, cand_tile=CAND_TILE, packed=True,
                                  **policy_kwargs(policy, R))
    assert torch.equal(T, Tp) and torch.equal(C, Cp)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("policy", list(POLICIES))
def test_packed_traceback_equals_the_dense_walk(policy, R):
    arrays, _, (_, Cd), (_, Cp) = tables(policy, "float64", R)
    x = arrays[2]
    dets, counts = ltsp_dp.ltsp_traceback(Cp, x)
    dets_d, counts_d = ref.traceback_ref(Cd, x)
    assert torch.equal(dets, dets_d) and torch.equal(counts, counts_d)
    for i in range(x.shape[0]):
        walked = ops.traceback_detours(Cd[i].numpy(), x[i].numpy())
        assert [tuple(d) for d in dets[i, :counts[i]].tolist()] == walked


@pytest.mark.parametrize("R", RS)
def test_the_root_is_packed_row_R_minus_1(R):
    _, _, (Td, _), (Tp, _) = tables("dp", "float64", R)
    assert ref.cell_row(0, R - 1, R) == R - 1
    assert torch.equal(Tp[:, R - 1, 0], Td[:, 0, R - 1, 0])
    assert torch.equal(ref.root_values(Tp, R), Td[:, 0, R - 1, 0])
    assert torch.equal(ref.root_values(Td, R), Td[:, 0, R - 1, 0])


@pytest.mark.parametrize("R", [1, 2, 9, 714])
def test_the_row_formula_is_the_benchmarks_reference(R):
    from ltsp_bench import reference

    a, b = torch.triu_indices(R, R)
    rows = torch.arange(ref.packed_rows(R))
    assert torch.equal(ref.cell_row(a, b, R), rows)
    assert torch.equal(reference.row(a, b, R), rows)


#: the far fold stages 8 detour starts at a time: LOGDP spans inside one
#: stage, at and across its boundary, and SIMPLEDP (``None``)
BAND_SPANS = [1, 3, 7, 8, 9, 15, 16, 17, None]
#: seven tiles of 8, the last ragged
BAND_R = 53


def band_kwargs(span: int | None) -> dict:
    return {"span": span, "disjoint": span is None}


@functools.cache
def band_arrays(dtype_name: str, device: str):
    """Two instances of ``BAND_R`` files (the second narrower, padded with
    phantom files) at ``R = BAND_R``: ``(arrays, S)``."""
    rng = np.random.default_rng([SEED, 92, BAND_R])
    insts = [random_instance(rng, BAND_R), random_instance(rng, BAND_R - 5)]
    *arrays, S = ops.prepare_batch(insts, dtype=getattr(torch, dtype_name), R_pad=BAND_R,
                                   device=device)
    return arrays, S


@pytest.mark.parametrize("dtype_name", ["float64", "float32", "int32"])
@pytest.mark.parametrize("span", BAND_SPANS)
def test_banded_far_fold_builds_the_per_diagonal_tables(span, dtype_name):
    """The plain tiled build, whose far fold starts at each tile's lowest
    live start under a span, gives the reference's per-diagonal tables on
    every window, dense and packed, over seven tiles with a ragged last one."""
    arrays, S = band_arrays(dtype_name, "cpu")
    kw = dict(S=S, cand_tile=CAND_TILE, **band_kwargs(span))
    Td, Cd = ref.ltsp_dp_tables_ref(*arrays, **kw)
    for packed in (False, True):
        T, C = ref.ltsp_dp_tables_tiled_ref(*arrays, Tb=ltsp_dp.TILE[dtype_name],
                                            packed=packed, **kw)
        assert torch.equal(T, upper(Td) if packed else Td)
        assert torch.equal(C, upper(Cd) if packed else Cd)


#: (R, S, B, span) -> (staged, full), counted by hand: R 20 and 30 are three
#: and four tiles of 8, S 64 two lane slices of 32
STAGE_CASES = {
    (20, 64, 1, None): (8, 8),  # D = 1: 2 x 2 blocks of 1 stage; D = 2: 2 x 1 of 2
    (20, 64, 1, 3): (6, 8),  # D = 2 stages once from b0 - 3
    (20, 64, 1, 9): (8, 8),  # b0 - 9 lies below the first far start
    (30, 64, 1, 8): (18, 20),  # D = 3: 2 blocks of 2 stages, not 3
    (30, 64, 2, 8): (36, 40),
}


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_far_stage_counts_by_hand(case):
    R, S, B, span = case
    assert ref.far_stage_counts(R, S, B, span, False) == STAGE_CASES[case]
    assert ref.far_stage_counts(R, S, B, span, True) == STAGE_CASES[case]


@pytest.mark.parametrize("disjoint", [False, True])
@pytest.mark.parametrize("R", [1, 8, 9, 53, 512, 714])
def test_far_stage_counts_stage_every_start_without_a_span(R, disjoint):
    staged, full = ref.far_stage_counts(R, 128, 3, None, disjoint)
    assert staged == full == sum(4 * (-(-R // 8) - D) * 3 * D for D in range(1, -(-R // 8)))


def test_far_stage_counts_stage_once_a_block_at_span_7():
    """At ``R`` 512 (64 tiles) and span 7 every block of every tile
    diagonal stages once; without the band a block of diagonal D stages D
    times."""
    staged, full = ref.far_stage_counts(512, 128, 1, 7, False)
    blocks = [4 * (64 - D) for D in range(1, 64)]
    assert staged == sum(blocks)
    assert full == sum(D * n for D, n in zip(range(1, 64), blocks))
    assert staged / full == pytest.approx(3 / 65)


def tiny_tapes():
    """Tapes of the benchmark's tiny paper profile (at most 20 files)."""
    from ltsp_bench import tapes as tapegen
    from ltsp_bench.tests.tiny import tiny_config

    ds = tiny_config("in2p3-dp")["dataset"]
    return tapegen.generate_tapes(ds["profile"], ds["base_seed"] + 7, ds["u_turn"])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("policy", ["dp", "logdp1"])
def test_the_packed_solve_answers_as_the_benchmarks_reference(policy, backend):
    """The solver's packed path (the ``cuda`` backend's build, run here on
    the plain version, and the ``torch`` backend's) at each tape's tight
    shape, float64, against ``ltsp_bench/reference.py``."""
    from ltsp_bench import reference, roofline

    for tape in tiny_tapes():
        inst = make_instance(tape["left"], tape["size"], tape["mult"], m=tape["m"],
                             u_turn=tape["u_turn"])
        span = roofline.policy_span(policy, inst.n_req)
        scaled, g = ops.rescale_instance(inst)
        R, S = ops.tight_shape(scaled)
        [got], [store] = ops._solve_packed([inst], [scaled], [g], R, S, None, span, backend,
                                           ltsp_dp.DEFAULT_CAND_TILE, dtype=torch.float64,
                                           device="cpu")
        assert store is None
        assert (got[0], tuple(got[1])) == reference.solve(tape, span, torch.float64, "cpu")


# ---------------------------------------------------------------------------
# on the card (skip without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@functools.cache
def paper_like(R: int, n: int, policy: str):
    """One instance of ``R`` files and ``n`` requests whose byte-scale
    coordinates pass the int32 guard only in float64, and its policy's
    keywords."""
    rng = np.random.default_rng([SEED, 90, R, n])
    left = np.cumsum(rng.integers(10**6, 10**7, R))
    size = rng.integers(10**5, 10**6, R)
    mult = 1 + rng.multinomial(n - R, np.ones(R) / R)
    inst = make_instance(left, size, mult, m=int(left[-1] + 10**7),
                         u_turn=int(rng.integers(10**5, 10**6)))
    return inst, policy_kwargs(policy, R)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["dp", "logdp1"])
@pytest.mark.parametrize("shape", [(64, 1024), (136, 2048)])
def test_cuda_packed_build_and_traceback_equal_the_dense(cuda_device, shape, policy):
    R, S = shape
    inst, kw = paper_like(R, S - 100, policy)  # n + 1 = S - 99 requests, padded to S
    *arrays, S = ops.prepare_batch([ops.rescale_instance(inst)[0]], dtype=torch.float64,
                                   R_pad=R, S_pad=S, device=cuda_device)
    before = dict(ltsp_dp.LAUNCHES)
    Td, Cd = ltsp_dp.ltsp_dp_tables(*arrays, S=S, device=cuda_device, **kw)
    Tp, Cp = ltsp_dp.ltsp_dp_tables(*arrays, S=S, device=cuda_device, packed=True, **kw)
    dets, counts = ltsp_dp.ltsp_traceback(Cp, arrays[2])
    dets_d, counts_d = ltsp_dp.ltsp_traceback(Cd, arrays[2])
    torch.cuda.synchronize()
    assert torch.equal(Tp, upper(Td)) and torch.equal(Cp, upper(Cd))
    assert counts.item() > 0
    assert torch.equal(dets, dets_d) and torch.equal(counts, counts_d)
    launched = {k: ltsp_dp.LAUNCHES[k] - before[k] for k in before}
    steps = list(ref.tile_schedule(R, ltsp_dp.TILE["float64"]))
    assert launched == {"far_fold_kernel": 2 * sum(s[0] == "far" for s in steps),
                        "near_fold_kernel": 2 * sum(s[0] == "near" for s in steps),
                        "traceback_kernel": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["dp", "logdp1", "simpledp"])
def test_cuda_solve_equals_python(cuda_device, policy):
    """One float64 instance and an int32 batch of three, solved on the
    card's packed path, against the exact python DP."""
    from repro_torch.core.solver import ExecutionContext, solve, solve_batch

    card = ExecutionContext(backend="cuda", device=cuda_device, numeric_policy="f64")
    python = ExecutionContext(backend="python")
    inst, _ = paper_like(40, 300, policy)
    assert ops._table_bound(ops.rescale_instance(inst)[0]) >= 2**31
    got, want = (solve(inst, policy, context=ctx) for ctx in (card, python))
    assert (got.cost, got.detours) == (want.cost, want.detours)
    rng = np.random.default_rng([SEED, 91, list(POLICIES).index(policy)])
    batch = [random_instance(rng, n) for n in (5, 17, 30)]
    got = solve_batch(batch, policy, context=card)
    want = solve_batch(batch, policy, context=python)
    assert [(r.cost, r.detours) for r in got] == [(r.cost, r.detours) for r in want]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype_name", ["float64", "float32", "int32"])
@pytest.mark.parametrize("span", BAND_SPANS)
def test_cuda_banded_build_equals_the_tiled_plain_version(cuda_device, span, dtype_name,
                                                          packed):
    """The card's build, whose far fold stages from each block's lowest live
    start under a span, equals the plain tiled build bit for bit, and its C
    loop counts the block-stages that ``ref.far_stage_counts`` counts."""
    arrays, S = band_arrays(dtype_name, cuda_device)
    kw = dict(S=S, cand_tile=CAND_TILE, packed=packed, **band_kwargs(span))
    before = dict(ltsp_dp.FAR_STAGES)
    T, C = ltsp_dp.ltsp_dp_tables(*arrays, device=cuda_device, **kw)
    staged, full = (ltsp_dp.FAR_STAGES[k] - before[k] for k in ("staged", "full"))
    T_plain, C_plain = ref.ltsp_dp_tables_tiled_ref(*arrays, Tb=ltsp_dp.TILE[dtype_name], **kw)
    torch.cuda.synchronize()
    assert torch.equal(T, T_plain) and torch.equal(C, C_plain)
    assert (staged, full) == ref.far_stage_counts(BAND_R, S, 2, **band_kwargs(span))
    assert (staged < full) == (span is not None and span < 5 * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("span", BAND_SPANS)
def test_cuda_banded_solve_plans_equal_the_python_dp(cuda_device, span):
    """An int32 solve and a float64 one on the card's packed path give the
    port's python DP's plan under each span (SIMPLEDP's for ``None``)."""
    from repro_torch.core import dp_schedule, simpledp_schedule

    def python(inst):
        return simpledp_schedule(inst) if span is None else dp_schedule(inst, span=span)

    rng = np.random.default_rng([SEED, 93])
    narrow = random_instance(rng, BAND_R)
    got = ops.ltsp_solve_batch([narrow], device=cuda_device, **band_kwargs(span))
    assert got == [python(narrow)]
    wide, _ = paper_like(BAND_R, 300, "dp")
    assert ops._table_bound(ops.rescale_instance(wide)[0]) >= 2**31
    got = ops.ltsp_solve_batch([wide], device=cuda_device, numeric_policy="f64",
                               **band_kwargs(span))
    assert got == [python(wide)]
