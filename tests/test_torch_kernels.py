"""The port's DP wavefront against the JAX package's Pallas kernel.

On the CPU the port's ``ltsp_dp_tables(device="cpu")`` runs the plain torch
version; it must equal the reference's ``ltsp_dp_tables(interpret=True)``
bit for bit in both planes (values ``T`` and argmins ``C``), for int32 and
float32 tables, unrestricted, LOGDP-spanned, SIMPLEDP-disjoint, banded
(``cand_tile`` below ``R - 1``) and batched with phantom padding.  The f64
route is held against the exact python DP (the reference's own f64 device
path needs ``jax.experimental.enable_x64``, which the installed JAX lacks).

The tests marked ``cuda`` hold the CUDA kernel against the plain version on
the card and skip without one.  They import no JAX, so on a machine with a
card and without JAX they run alone: ``pytest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.instance import make_instance as port_make_instance
from repro_torch.kernels.ltsp_dp import ltsp_dp as port_ltsp_dp
from repro_torch.kernels.ltsp_dp import ops as port_ops
from repro_torch.kernels.ltsp_dp.ref import ltsp_dp_tables_ref, tile_schedule
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

SEED = 20211217


def random_port_instance(rng, lo=2, hi=20, scale=1, max_u=30):
    """``conftest.random_instance``'s draw, built as a port ``Instance``."""
    R = int(rng.integers(lo, hi))
    sizes = rng.integers(1, 50, size=R) * scale
    gaps = rng.integers(0, 40, size=R + 1) * scale
    left, pos = [], int(gaps[0])
    for i in range(R):
        left.append(pos)
        pos += int(sizes[i] + gaps[i + 1])
    mult = rng.integers(1, 10, size=R)
    return port_make_instance(left, sizes, mult, m=pos, u_turn=int(rng.integers(0, max_u)) * scale)


def to_reference(inst):
    from repro.core.instance import Instance

    return Instance(left=inst.left.copy(), right=inst.right.copy(),
                    mult=inst.mult.copy(), m=inst.m, u_turn=inst.u_turn)


def reference_planes(insts, dtype_name, span, disjoint, cand_tile, B_pad=None, S_pad=None):
    import jax.numpy as jnp

    from repro.kernels.ltsp_dp.ltsp_dp import ltsp_dp_tables
    from repro.kernels.ltsp_dp.ops import prepare_batch

    *arrays, S = prepare_batch([to_reference(i) for i in insts], dtype=getattr(jnp, dtype_name),
                               B_pad=B_pad, S_pad=S_pad)
    T, C = ltsp_dp_tables(*arrays, S=S, span=span, disjoint=disjoint, cand_tile=cand_tile,
                          interpret=True)
    return np.asarray(T), np.asarray(C)


def port_planes(insts, dtype_name, span, disjoint, cand_tile, B_pad=None, S_pad=None,
                device="cpu"):
    *arrays, S = port_ops.prepare_batch(insts, dtype=getattr(torch, dtype_name), B_pad=B_pad,
                                        S_pad=S_pad, device=device)
    return port_ltsp_dp.ltsp_dp_tables(*arrays, S=S, span=span, disjoint=disjoint,
                                       cand_tile=cand_tile, device=device)


CONFIGS = {
    # name: (span, disjoint, cand_tile, batch size, B_pad)
    "dp": (None, False, 128, 1, None),
    "logdp-span": (3, False, 128, 1, None),
    "simpledp-disjoint": (None, True, 128, 1, None),
    "banded": (None, False, 4, 1, None),
    "banded-span": (2, False, 4, 1, None),
    "batched-padded": (None, False, 128, 3, 4),
    "batched-banded-disjoint": (None, True, 4, 3, 4),
}


@pytest.mark.parametrize("dtype_name", ["int32", "float32"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_tables_match_reference_bit_for_bit(config, dtype_name):
    span, disjoint, cand_tile, n_inst, B_pad = CONFIGS[config]
    rng = np.random.default_rng([SEED, list(CONFIGS).index(config)])
    insts = [random_port_instance(rng) for _ in range(n_inst)]
    S_pad = 256 if config.startswith("batched") else None
    T_ref, C_ref = reference_planes(insts, dtype_name, span, disjoint, cand_tile, B_pad, S_pad)
    T, C = port_planes(insts, dtype_name, span, disjoint, cand_tile, B_pad, S_pad)
    assert T.dtype == getattr(torch, dtype_name) and C.dtype == torch.int32
    np.testing.assert_array_equal(T.numpy(), T_ref)
    np.testing.assert_array_equal(C.numpy(), C_ref)


@pytest.mark.parametrize("cand_tile", [128, 3])
def test_int32_sentinel_and_wraparound_match_reference(cand_tile):
    """Byte-scale coordinates push dense cells (large ``s``) past the int32
    sentinel and past 2**31: the port reproduces the reference's wrapping
    arithmetic and both scan forms' sentinel handling, bit for bit."""
    rng = np.random.default_rng([SEED, 99, cand_tile])
    inst = random_port_instance(rng, 6, 10, scale=10**6)
    for span, disjoint in ((None, False), (2, False), (None, True)):
        T_ref, C_ref = reference_planes([inst], "int32", span, disjoint, cand_tile)
        T, C = port_planes([inst], "int32", span, disjoint, cand_tile)
        assert (T_ref >= (2**31 - 1) // 2).any() and (T_ref < 0).any()
        np.testing.assert_array_equal(T.numpy(), T_ref)
        np.testing.assert_array_equal(C.numpy(), C_ref)


def test_single_file_and_pair_tables():
    """R = 1 (no diagonal to fill) and R = 2 (one launch) match the reference."""
    for n_files in (1, 2):
        inst = port_make_instance(list(range(0, 20 * n_files, 20)), [7] * n_files,
                                  [3] * n_files, u_turn=5)
        for dtype_name in ("int32", "float32"):
            T_ref, C_ref = reference_planes([inst], dtype_name, None, False, 128)
            T, C = port_planes([inst], dtype_name, None, False, 128)
            np.testing.assert_array_equal(T.numpy(), T_ref)
            np.testing.assert_array_equal(C.numpy(), C_ref)


def test_f32_wrappers_match_reference():
    from repro.kernels.ltsp_dp import ops as ref_ops

    rng = np.random.default_rng([SEED, 7])
    inst = random_port_instance(rng, 5, 9)
    l, r, x, nl, S = port_ops.prepare_arrays(inst, device="cpu")
    rl, rr, rx, rnl, rS = ref_ops.prepare_arrays(to_reference(inst))
    assert S == rS
    for ours, theirs in ((l, rl), (r, rr), (x, rx), (nl, rnl)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    T = port_ops.ltsp_dp_table(l, r, x, nl, float(inst.u_turn), S, device="cpu")
    T_ref = ref_ops.ltsp_dp_table(rl, rr, rx, rnl, float(inst.u_turn), S, interpret=True)
    np.testing.assert_array_equal(T.numpy(), np.asarray(T_ref))
    opt = port_ops.ltsp_opt_instance(inst, device="cpu")
    assert opt == ref_ops.ltsp_opt_instance(to_reference(inst), interpret=True)
    from repro_torch.core import dp_schedule

    assert opt == float(dp_schedule(inst)[0])


def test_plain_version_opt_equals_exact_dp():
    from repro_torch.core import dp_schedule
    from repro_torch.kernels.ltsp_dp.ref import ltsp_opt_ref

    rng = np.random.default_rng([SEED, 8])
    inst = random_port_instance(rng, 4, 8)
    l, r, x, nl, S = port_ops.prepare_arrays(inst, device="cpu")
    v = ltsp_opt_ref(l, r, x, nl, float(inst.u_turn), float(inst.m), S)
    assert float(v) == float(dp_schedule(inst)[0])


def test_prepare_batch_and_buckets_match_reference():
    from repro.kernels.ltsp_dp import ops as ref_ops

    rng = np.random.default_rng([SEED, 11])
    insts = [random_port_instance(rng, 2, 40, max_u=200) for _ in range(12)]
    refs = [to_reference(i) for i in insts]
    assert port_ops.plan_buckets(insts) == ref_ops.plan_buckets(refs)
    assert [port_ops.bucket_shape(i) for i in insts] == [ref_ops.bucket_shape(i) for i in refs]
    ours = port_ops.prepare_batch(insts, R_pad=64, S_pad=512, B_pad=16, device="cpu")
    theirs = ref_ops.prepare_batch(refs, R_pad=64, S_pad=512, B_pad=16)
    assert ours[-1] == theirs[-1]
    for a, b in zip(ours[:-1], theirs[:-1]):
        assert str(a.dtype).removeprefix("torch.") == np.asarray(b).dtype.name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for inst, ref in zip(insts, refs):
        scaled, g = port_ops.rescale_instance(inst)
        rscaled, rg = ref_ops.rescale_instance(ref)
        assert g == rg and port_ops._table_bound(scaled) == ref_ops._table_bound(rscaled)
        np.testing.assert_array_equal(scaled.left, rscaled.left)


def test_traceback_matches_reference_on_shared_planes():
    from repro.kernels.ltsp_dp import ops as ref_ops

    rng = np.random.default_rng([SEED, 12])
    inst = random_port_instance(rng, 8, 16)
    _, C = port_planes([inst], "int32", None, False, 128)
    C0 = C[0].numpy()
    assert port_ops.traceback_detours(C0, inst.mult) == ref_ops.traceback_detours(C0, inst.mult)


def _coprime_instance():
    return port_make_instance(
        [0, 2 * 10**9 + 1, 3 * 10**9 + 7], [10**6 + 1, 10**6 + 3, 5 * 10**5 + 9], [3, 1, 4],
        u_turn=10**7 + 1,
    )


def test_guard_messages_match_reference():
    from repro.kernels.ltsp_dp import ops as ref_ops

    wide = port_ops.rescale_instance(_coprime_instance())[0]
    huge = port_ops.rescale_instance(port_make_instance(
        [0, 2 * 10**15 + 1], [10**6 + 1, 10**6 + 3], [3, 3], u_turn=10**7 + 1))[0]
    for check, inst in (("_check_int32_safe", wide), ("_check_f64_safe", huge)):
        with pytest.raises(ValueError) as ours:
            getattr(port_ops, check)([inst])
        with pytest.raises(ValueError) as theirs:
            getattr(ref_ops, check)([to_reference(inst)])
        assert str(ours.value) == str(theirs.value)


class _Profile:
    wall = False

    def __init__(self):
        self.rows = []

    def record(self, **row):
        self.rows.append(row)


@pytest.mark.parametrize("policy", ["dp", "logdp1", "simpledp"])
def test_f64_route_is_exact_against_python_dp(policy):
    """Instances past the int32 guard solve through the float64 table, one
    tight build each, bit-identical to the reference's exact python DP."""
    from repro.core import dp_schedule, logdp_span, simpledp_schedule

    inst = _coprime_instance()
    ref = to_reference(inst)
    span = logdp_span(inst.n_req, 1.0) if policy == "logdp1" else None
    expected = simpledp_schedule(ref) if policy == "simpledp" else dp_schedule(ref, span=span)
    log = _Profile()
    got = port_ops.ltsp_solve_instance(
        inst, span=span, backend="torch", device="cpu", numeric_policy="f64",
        disjoint=policy == "simpledp", profile=log,
    )
    assert got == expected
    [row] = log.rows
    assert row["signature"][3] == "float64" and row["B_pad"] == 1
    with pytest.raises(ValueError, match="int32"):
        port_ops.ltsp_solve_instance(inst, backend="torch", device="cpu")


def test_cpu_wrapper_runs_plain_version_without_counting():
    rng = np.random.default_rng([SEED, 13])
    inst = random_port_instance(rng, 4, 8)
    before = dict(port_ltsp_dp.LAUNCHES)
    T, C = port_planes([inst], "int32", None, False, 128)
    *arrays, S = port_ops.prepare_batch([inst], device="cpu")
    T2, C2 = ltsp_dp_tables_ref(*arrays, S=S)
    assert torch.equal(T, T2) and torch.equal(C, C2)
    assert port_ltsp_dp.LAUNCHES == before


def test_wrapper_validates_its_inputs():
    *arrays, S = port_ops.prepare_batch([port_make_instance([0, 10], [4, 4], [1, 2])],
                                        device="cpu")
    left, right, x, nl, u = arrays
    T = torch.zeros((1, 2, 2, S), dtype=torch.int32)
    C = torch.full((1, 2, 2, S), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="x must be"):
        port_ltsp_dp.ltsp_near_fold(T, C, left, right, x.float(), nl, u, 0, 1, span=None)
    with pytest.raises(ValueError, match="C must be"):
        port_ltsp_dp.ltsp_near_fold(T, C.float(), left, right, x, nl, u, 0, 1, span=None)
    with pytest.raises(ValueError, match="out of range"):
        port_ltsp_dp.ltsp_far_fold(T, C, left, right, x, nl, u, 1, span=None)
    with pytest.raises(TypeError, match="unsupported table type"):
        port_ltsp_dp.ltsp_near_fold(T.to(torch.int16), C, left, right, x, nl, u, 0, 1,
                                    span=None)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version (skip without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["int32", "float32", "float64"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_cuda_kernel_matches_plain_version(cuda_device, config, dtype_name):
    span, disjoint, cand_tile, n_inst, B_pad = CONFIGS[config]
    rng = np.random.default_rng([SEED, 50, list(CONFIGS).index(config)])
    insts = [random_port_instance(rng, 2, 40) for _ in range(n_inst)]
    *arrays, S = port_ops.prepare_batch(insts, dtype=getattr(torch, dtype_name), B_pad=B_pad,
                                        device=cuda_device)
    kw = dict(S=S, span=span, disjoint=disjoint, cand_tile=cand_tile)
    before = dict(port_ltsp_dp.LAUNCHES)
    T, C = port_ltsp_dp.ltsp_dp_tables(*arrays, device=cuda_device, **kw)
    T_plain, C_plain = ltsp_dp_tables_ref(*arrays, **kw)
    torch.cuda.synchronize()
    steps = list(tile_schedule(arrays[0].shape[1], port_ltsp_dp.TILE[dtype_name]))
    assert port_ltsp_dp.LAUNCHES["near_fold_kernel"] - before["near_fold_kernel"] == sum(
        kind == "near" for kind, _, _ in steps)
    assert torch.equal(T, T_plain) and torch.equal(C, C_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("cand_tile", [128, 3])
def test_cuda_int32_wraparound_matches_plain_version(cuda_device, cand_tile):
    rng = np.random.default_rng([SEED, 60, cand_tile])
    inst = random_port_instance(rng, 6, 12, scale=10**6)
    for span, disjoint in ((None, False), (2, False), (None, True)):
        *arrays, S = port_ops.prepare_batch([inst], device=cuda_device)
        kw = dict(S=S, span=span, disjoint=disjoint, cand_tile=cand_tile)
        T, C = port_ltsp_dp.ltsp_dp_tables(*arrays, device=cuda_device, **kw)
        T_plain, C_plain = ltsp_dp_tables_ref(*arrays, **kw)
        assert torch.equal(T, T_plain) and torch.equal(C, C_plain)


@pytest.mark.cuda
def test_cuda_solver_f64_equals_python(cuda_device):
    from repro_torch.core import ExecutionContext, solve

    inst = _coprime_instance()
    ctx = ExecutionContext(backend="cuda", numeric_policy="f64", device=cuda_device)
    for policy in ("dp", "logdp1", "simpledp"):
        got = solve(inst, policy, context=ctx)
        ref = solve(inst, policy)
        assert (got.cost, got.detours) == (ref.cost, ref.detours)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_mixed_devices(cuda_device):
    *arrays, S = port_ops.prepare_batch([port_make_instance([0, 10], [4, 4], [1, 2])],
                                        device=cuda_device)
    left, right, x, nl, u = arrays
    T = torch.zeros((1, 2, 2, S), dtype=torch.int32, device=cuda_device)
    C = torch.full((1, 2, 2, S), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="one device"):
        port_ltsp_dp.ltsp_near_fold(T, C, left, right, x, nl, u, 0, 1, span=None)
