"""Uncaptured float64 solves build their tables at the tight shape.

An instance past the int32 guard solves through a float64 table, alone.
Without ``capture`` its tables never leave the device, so ``ltsp_solve_batch``
builds them at ``ops.tight_shape`` (``R`` to the float64 tile, ``S = n + 1``
to 128); with ``capture=True`` the ``DenseStore`` sizes become
``WarmStats.cells_evaluated`` and the launch keeps ``ops.bucket_shape``, as
int32 launches do.  The answers are held against the reference's exact python
DP (its own f64 device path needs ``jax.experimental.enable_x64``, which the
installed JAX lacks), on the plain version of the kernels.
"""

import numpy as np
import pytest

from repro_torch.core.instance import make_instance
from repro_torch.kernels.ltsp_dp import ops
from repro_torch.kernels.ltsp_dp.ltsp_dp import DEFAULT_CAND_TILE, TILE
from repro_torch.obs.kernel import KernelProfile
from test_torch_kernels import random_port_instance, to_reference
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

SEED = 20211218


def wide_instance(rng, n_req):
    """An instance with coprime byte-scale coordinates: past the int32 guard
    even after gcd rescaling, inside the float64 one."""
    sizes = rng.integers(10**6, 10**7, size=n_req)
    gaps = rng.integers(10**6, 10**7, size=n_req + 1)
    left, pos = [], int(gaps[0])
    for i in range(n_req):
        left.append(pos)
        pos += int(sizes[i] + gaps[i + 1])
    mult = rng.integers(1, 3, size=n_req)
    inst = make_instance(left, sizes, mult, m=pos, u_turn=int(rng.integers(10**6, 10**7)))
    scaled = ops.rescale_instance(inst)[0]
    assert 2**31 <= ops._table_bound(scaled) < 2**53
    return inst


def expected(inst, policy):
    from repro.core import dp_schedule, logdp_span, simpledp_schedule

    ref = to_reference(inst)
    if policy == "simpledp":
        return simpledp_schedule(ref)
    return dp_schedule(ref, span=logdp_span(inst.n_req, 1.0) if policy == "logdp1" else None)


def solve(insts, policy, **kw):
    from repro.core import logdp_span

    span = logdp_span(insts[0].n_req, 1.0) if policy == "logdp1" else None
    return ops.ltsp_solve_batch(insts, span=span, disjoint=policy == "simpledp",
                                backend="torch", device="cpu", numeric_policy="f64", **kw)


def test_tight_shape_is_whole_tiles_and_never_above_the_bucket():
    for n_req in range(1, 600, 7):
        for n in (n_req, n_req + 126, 3 * n_req + 200):
            inst = make_instance(list(range(0, 2 * n_req, 2)), [1] * n_req,
                                 [1] * (n_req - 1) + [n - n_req + 1])
            (R, S), (R_b, S_b) = ops.tight_shape(inst), ops.bucket_shape(inst)
            assert n_req <= R <= R_b and n + 1 <= S <= S_b and S % 128 == 0
            assert R % TILE["float64"] == 0 if n_req > TILE["float64"] else R == R_b
            assert (R - 1 <= DEFAULT_CAND_TILE) == (R_b - 1 <= DEFAULT_CAND_TILE)


# n_req off the tile and n + 1 off 128; 128 and 129 straddle the scan form's
# switch at R - 1 <= cand_tile (the python dp takes ~35 s a tape there, so
# only the banded policies cross it here; the card's test crosses it with dp)
CASES = [(p, n) for p in ("dp", "logdp1", "simpledp") for n in (13, 45)] + [
    (p, n) for p in ("logdp1", "simpledp") for n in (128, 129)]


@pytest.mark.parametrize("policy,n_req", CASES)
def test_uncaptured_f64_solve_runs_at_its_tight_shape(policy, n_req):
    inst = wide_instance(np.random.default_rng([SEED, n_req]), n_req)
    assert n_req % 8 or n_req == 128
    assert (inst.n + 1) % 128
    prof = KernelProfile(wall=False)
    assert solve([inst], policy, profile=prof) == [expected(inst, policy)]
    [row] = prof.launches
    assert (row.R_pad, row.S_pad, row.B_pad) == (*ops.tight_shape(inst), 1)
    assert row.real_cells == n_req * n_req * (inst.n + 1)


# cand_tile between the two shapes' R - 1: 23 <= 30 < 31 and 95 <= 100 < 127
STRADDLES = [("dp", 21, 30), ("logdp1", 90, 100), ("simpledp", 90, 100)]


@pytest.mark.parametrize("policy,n_req,cand_tile", STRADDLES)
def test_f64_solve_keeps_the_bucket_scan_form_where_cand_tile_straddles(policy, n_req,
                                                                        cand_tile):
    inst = wide_instance(np.random.default_rng([SEED, 3, n_req]), n_req)
    (R_t, _), (R_b, _) = ops.tight_shape(inst), ops.bucket_shape(inst)
    assert R_t - 1 <= cand_tile < R_b - 1
    prof = KernelProfile(wall=False)
    assert solve([inst], policy, cand_tile=cand_tile, profile=prof) == [expected(inst, policy)]
    [row] = prof.launches
    assert (row.R_pad, row.S_pad) == ops.bucket_shape(inst)


@pytest.mark.parametrize("policy", ["dp", "logdp1", "simpledp"])
def test_captured_f64_solve_keeps_the_bucket_shape(policy):
    inst = wide_instance(np.random.default_rng([SEED, 1, 45]), 45)
    assert ops.tight_shape(inst) != ops.bucket_shape(inst)
    prof = KernelProfile(wall=False)
    got, [store] = solve([inst], policy, capture=True, profile=prof)
    assert got == [expected(inst, policy)]
    R, S = ops.bucket_shape(inst)
    [row] = prof.launches
    assert (row.R_pad, row.S_pad) == (R, S) and len(store) == R * R * S


def test_int32_launches_of_an_f64_batch_keep_the_bucket_shape():
    rng = np.random.default_rng([SEED, 2])
    wide = wide_instance(rng, 21)
    narrow = [random_port_instance(rng, 9, 20) for _ in range(3)]
    prof = KernelProfile(wall=False)
    got = solve([wide, *narrow], "dp", profile=prof)
    assert got == [expected(inst, "dp") for inst in (wide, *narrow)]
    shapes = {(r.R_pad, r.S_pad, r.B_pad) for r in prof.launches}
    assert (*ops.tight_shape(wide), 1) in shapes
    assert shapes - {(*ops.tight_shape(wide), 1)} == {
        (*shape, ops._pow2(len(idx)))
        for shape, idx in ops.plan_buckets([ops.rescale_instance(i)[0] for i in narrow]).items()}
