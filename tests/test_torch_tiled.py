"""The tiled table build and the device traceback of the port.

On the CPU the plain versions of the tiled schedule (``ref.far_fold``,
``ref.near_update`` driven by ``ref.ltsp_dp_tables_tiled_ref``) must give
the JAX package's ``ltsp_dp_tables(interpret=True)`` planes bit for bit, for
every tile size ``Tb`` (1 is the per-diagonal schedule, ``R`` a single tile,
2-4 leave ragged tiles at the end), in int32 and float32, including the int32
cells past the sentinel and past 2**31.  The float64 route is held against the
exact python DP.  The plain traceback, in the kernel's ``[B, R, 2]`` + count
layout, must give the reference's ``traceback_detours`` on the reference's
planes.

The tests marked ``cuda`` hold each new kernel against its plain version on
the card and skip without one: ``pytest -m cuda tests/test_torch_tiled.py``.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core.instance import make_instance as port_make_instance
from repro_torch.kernels.ltsp_dp import ltsp_dp as port_ltsp_dp
from repro_torch.kernels.ltsp_dp import ops as port_ops
from repro_torch.kernels.ltsp_dp import ref as port_ref
from test_torch_kernels import CONFIGS, SEED, random_port_instance, reference_planes, to_reference

pytestmark = pytest.mark.port

TILE_SIZES = [1, 2, 3, 4, "R"]


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The plain versions run thousands of tiny tensor operations, which
    one thread does far faster than a pool; the setting is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _config_case(config, dtype_name):
    """The reference planes of one ``CONFIGS`` entry and the port's inputs."""
    span, disjoint, cand_tile, n_inst, B_pad = CONFIGS[config]
    rng = np.random.default_rng([SEED, 30, list(CONFIGS).index(config)])
    insts = [random_port_instance(rng) for _ in range(n_inst)]
    S_pad = 256 if config.startswith("batched") else None
    planes = reference_planes(insts, dtype_name, span, disjoint, cand_tile, B_pad, S_pad)
    *arrays, S = port_ops.prepare_batch(insts, dtype=getattr(torch, dtype_name), B_pad=B_pad,
                                        S_pad=S_pad, device="cpu")
    return insts, planes, arrays, S


def _tb(Tb, R):
    return R if Tb == "R" else Tb


@pytest.mark.parametrize("Tb", TILE_SIZES)
@pytest.mark.parametrize("dtype_name", ["int32", "float32"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_tiled_driver_matches_reference_bit_for_bit(config, dtype_name, Tb):
    span, disjoint, cand_tile, _, _ = CONFIGS[config]
    _, (T_ref, C_ref), arrays, S = _config_case(config, dtype_name)
    R = arrays[0].shape[1]
    T, C = port_ref.ltsp_dp_tables_tiled_ref(*arrays, S=S, Tb=_tb(Tb, R), span=span,
                                             disjoint=disjoint, cand_tile=cand_tile)
    np.testing.assert_array_equal(T.numpy(), T_ref)
    np.testing.assert_array_equal(C.numpy(), C_ref)


@pytest.mark.parametrize("Tb", TILE_SIZES)
@pytest.mark.parametrize("cand_tile", [128, 3])
def test_tiled_int32_sentinel_and_wraparound_match_reference(cand_tile, Tb):
    """Byte-scale coordinates push dense cells past the int32 sentinel and
    past 2**31; every tile size reproduces the reference's wrapping
    arithmetic and both scan forms' sentinel handling."""
    rng = np.random.default_rng([SEED, 31, cand_tile])
    inst = random_port_instance(rng, 9, 14, scale=10**6)
    *arrays, S = port_ops.prepare_batch([inst], device="cpu")
    R = arrays[0].shape[1]
    for span, disjoint in ((None, False), (2, False), (None, True)):
        T_ref, C_ref = reference_planes([inst], "int32", span, disjoint, cand_tile)
        T, C = port_ref.ltsp_dp_tables_tiled_ref(*arrays, S=S, Tb=_tb(Tb, R), span=span,
                                                 disjoint=disjoint, cand_tile=cand_tile)
        assert (T_ref >= (2**31 - 1) // 2).any() and (T_ref < 0).any()
        np.testing.assert_array_equal(T.numpy(), T_ref)
        np.testing.assert_array_equal(C.numpy(), C_ref)


def _wide_instance(rng, lo, hi):
    """An instance whose coordinates share no factor, so its tables stay at
    byte scale (past the int32 guard, inside the float64 one)."""
    inst = random_port_instance(rng, lo, hi, scale=10**5)
    left = inst.left.copy()
    left[1:] += 1
    return port_make_instance(left, inst.right - inst.left, inst.mult, m=int(inst.right[-1]) + 1,
                              u_turn=inst.u_turn + 1)


@pytest.mark.parametrize("Tb", [1, 2, 3, 5])
@pytest.mark.parametrize("policy", ["dp", "logdp1", "simpledp"])
def test_tiled_f64_tables_give_the_exact_python_dp(policy, Tb):
    from repro.core import dp_schedule, logdp_span, simpledp_schedule

    rng = np.random.default_rng([SEED, 32, Tb])
    inst = _wide_instance(rng, 11, 16)
    scaled, g = port_ops.rescale_instance(inst)
    assert port_ops._table_bound(scaled) >= 2**31  # the f64 route, not int32
    ref = to_reference(inst)
    span = logdp_span(inst.n_req, 1.0) if policy == "logdp1" else None
    expected = simpledp_schedule(ref) if policy == "simpledp" else dp_schedule(ref, span=span)
    *arrays, S = port_ops.prepare_batch([scaled], dtype=torch.float64, device="cpu")
    T, C = port_ref.ltsp_dp_tables_tiled_ref(*arrays, S=S, Tb=Tb, span=span,
                                             disjoint=policy == "simpledp")
    R = arrays[0].shape[1]
    cost = g * int(T[0, 0, R - 1, 0]) + port_ops.virtual_lb(inst)
    dets = port_ops.traceback_detours(C[0].numpy(), arrays[2][0].numpy())
    assert (cost, dets) == expected


def test_tile_schedule_covers_every_cell_once():
    """Each cell a < b lies in exactly one near step, and every far step
    precedes the near steps of its tile diagonal."""
    for R in (2, 5, 16, 17, 33):
        for Tb in (1, 2, 3, 4, 16, R):
            seen = []
            far_done = set()
            for kind, D, k in port_ref.tile_schedule(R, Tb):
                if kind == "far":
                    far_done.add(D)
                    continue
                assert D == 0 or D in far_done
                a, b, _ = port_ref._tile_cells(R, Tb, D, k, "cpu")
                seen += list(zip(a.tolist(), b.tolist()))
            assert sorted(seen) == [(a, b) for a in range(R) for b in range(a + 1, R)]


def test_single_steps_compose_to_the_tables():
    """The CPU wrappers of the two kernels, stepped by hand through the
    schedule, build the same tables as the wrapper's own driver."""
    rng = np.random.default_rng([SEED, 33])
    insts = [random_port_instance(rng, 20, 40) for _ in range(2)]
    *arrays, S = port_ops.prepare_batch(insts, dtype=torch.float32, B_pad=3, device="cpu")
    R = arrays[0].shape[1]
    T, C = port_ref.init_tables(arrays[0], arrays[1], arrays[3], S)
    for kind, D, k in port_ref.tile_schedule(R, port_ltsp_dp.TILE["float32"]):
        if kind == "far":
            port_ltsp_dp.ltsp_far_fold(T, C, *arrays, D, span=4)
        else:
            port_ltsp_dp.ltsp_near_fold(T, C, *arrays, D, k, span=4)
    T2, C2 = port_ltsp_dp.ltsp_dp_tables(*arrays, S=S, span=4, device="cpu")
    T3, C3 = port_ref.ltsp_dp_tables_ref(*arrays, S=S, span=4)
    assert torch.equal(T, T2) and torch.equal(C, C2)
    assert torch.equal(T, T3) and torch.equal(C, C3)


def test_step_wrappers_validate_their_steps():
    *arrays, S = port_ops.prepare_batch([port_make_instance([0, 10, 30], [4, 4, 4], [1, 2, 1])],
                                        device="cpu")
    T, C = port_ref.init_tables(arrays[0], arrays[1], arrays[3], S)
    with pytest.raises(ValueError, match="out of range"):
        port_ltsp_dp.ltsp_far_fold(T, C, *arrays, 1, span=None)  # R = 3 is one tile
    with pytest.raises(ValueError, match="no step"):
        port_ltsp_dp.ltsp_near_fold(T, C, *arrays, 0, 3, span=None)
    with pytest.raises(ValueError, match="x must be"):
        port_ltsp_dp.ltsp_traceback(C, arrays[2].float())
    with pytest.raises(ValueError, match="C must be"):
        port_ltsp_dp.ltsp_traceback(C[0], arrays[2])


def test_cuda_table_build_refuses_ragged_lane_slices():
    """The far fold stages whole lane slices, so a CUDA table build with more
    than one tile diagonal refuses an ``S`` that is no multiple of
    ``FAR_LANES``, naming it, before any tensor moves to the card; the plain
    version on the CPU takes any ``S``."""
    rng = np.random.default_rng([SEED, 80])
    inst = random_port_instance(rng, 12, 16)
    *arrays, S = port_ops.prepare_batch([inst], device="cpu")
    ragged = S + 1
    assert ragged % port_ltsp_dp.FAR_LANES and arrays[0].shape[1] > port_ltsp_dp.TILE["int32"]
    with pytest.raises(ValueError, match=f"S={ragged} must be a multiple of 32"):
        port_ltsp_dp.ltsp_dp_tables(*arrays, S=ragged, device="cuda")
    with pytest.raises(ValueError, match="must be a multiple of 32"):
        port_ops.ltsp_dp_table(*(t[0] for t in arrays[:4]), float(inst.u_turn), ragged)
    T, C = port_ltsp_dp.ltsp_dp_tables(*arrays, S=ragged, device="cpu")
    T_ref, C_ref = port_ref.ltsp_dp_tables_ref(*arrays, S=ragged)
    assert torch.equal(T, T_ref) and torch.equal(C, C_ref)
    # a single tile has no far launch, and a padded S passes
    cuda = torch.device("cuda")
    port_ltsp_dp._check_lanes(cuda, "float64", port_ltsp_dp.TILE["float64"], ragged)
    port_ltsp_dp._check_lanes(cuda, "float64", 256, 8192)


# ---------------------------------------------------------------------------
# the traceback in the kernel's layout
# ---------------------------------------------------------------------------
def _walks(dets, counts, n):
    return [[tuple(d) for d in dets[i, :counts[i]].tolist()] for i in range(n)]


TRACEBACK_CASES = {
    # name: (R range, span, disjoint, instances, B_pad)
    "single-file": ((1, 2), None, False, 1, None),
    "pair": ((2, 3), None, False, 2, None),
    "phantom-rows": ((3, 18), None, False, 3, 8),
    "logdp": ((6, 18), 2, False, 2, 4),
    "simpledp": ((6, 18), None, True, 2, 4),
}


@pytest.mark.parametrize("case", list(TRACEBACK_CASES))
def test_plain_traceback_matches_reference_walk(case):
    from repro.kernels.ltsp_dp import ops as ref_ops

    (lo, hi), span, disjoint, n_inst, B_pad = TRACEBACK_CASES[case]
    rng = np.random.default_rng([SEED, 34, list(TRACEBACK_CASES).index(case)])
    insts = [random_port_instance(rng, lo, hi) for _ in range(n_inst)]
    T_ref, C_ref = reference_planes(insts, "int32", span, disjoint, 128, B_pad)
    *arrays, _ = port_ops.prepare_batch(insts, B_pad=B_pad, device="cpu")
    x = arrays[2]
    dets, counts = port_ltsp_dp.ltsp_traceback(torch.from_numpy(C_ref.copy()), x)
    B, R = x.shape
    assert dets.shape == (B, R, 2) and counts.shape == (B,)
    assert dets.dtype == counts.dtype == torch.int32
    expected = [ref_ops.traceback_detours(C_ref[i], x[i].numpy()) for i in range(B)]
    assert _walks(dets, counts, B) == expected
    assert (dets[torch.arange(R)[None, :] >= counts[:, None]] == 0).all()
    if B_pad:
        assert (counts[n_inst:] == 0).all()  # phantom rows only skip


def test_plain_traceback_flags_a_plane_that_is_not_a_dps():
    C = torch.full((2, 3, 3, 4), -1, dtype=torch.int32)
    C[0, 0, 2, 0] = 0  # a start outside the window (0, 2]
    x = torch.ones((2, 3), dtype=torch.int32)
    x[1, 2] = 9  # walks the skip count past the plane
    dets, counts = port_ltsp_dp.ltsp_traceback(C, x)
    assert counts.tolist() == [-1, -1]


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version (skip without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _card_arrays(dtype_name, config, device, lo=17, hi=60):
    span, disjoint, cand_tile, n_inst, B_pad = CONFIGS[config]
    rng = np.random.default_rng([SEED, 70, list(CONFIGS).index(config)])
    insts = [random_port_instance(rng, lo, hi) for _ in range(n_inst)]
    *arrays, S = port_ops.prepare_batch(insts, dtype=getattr(torch, dtype_name), B_pad=B_pad,
                                        device=device)
    return insts, arrays, S, dict(span=span, disjoint=disjoint)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["int32", "float32", "float64"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_cuda_far_and_near_folds_match_plain_versions(cuda_device, config, dtype_name):
    """Every launch of the tiled build, from the same state, equals its plain
    version's step bit for bit."""
    _, arrays, S, kw = _card_arrays(dtype_name, config, cuda_device)
    cand_tile = CONFIGS[config][2]
    R = arrays[0].shape[1]
    T, C = port_ref.init_tables(arrays[0], arrays[1], arrays[3], S)
    before = dict(port_ltsp_dp.LAUNCHES)
    for kind, D, k in port_ref.tile_schedule(R, port_ltsp_dp.TILE[dtype_name]):
        Tk, Ck = T.clone(), C.clone()
        if kind == "far":
            port_ltsp_dp.ltsp_far_fold(Tk, Ck, *arrays, D, **kw)
            port_ref.far_fold(T, C, *arrays, D, Tb=port_ltsp_dp.TILE[dtype_name], **kw)
        else:
            port_ltsp_dp.ltsp_near_fold(Tk, Ck, *arrays, D, k, cand_tile=cand_tile, **kw)
            port_ref.near_update(T, C, *arrays, D, k, Tb=port_ltsp_dp.TILE[dtype_name],
                                 static_tile=R - 1 <= cand_tile, **kw)
        torch.cuda.synchronize()
        assert torch.equal(Tk, T) and torch.equal(Ck, C), (kind, D, k)
    assert port_ltsp_dp.LAUNCHES["far_fold_kernel"] > before["far_fold_kernel"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["int32", "float32", "float64"])
def test_cuda_tiled_tables_match_tiled_plain_version(cuda_device, dtype_name):
    _, arrays, S, kw = _card_arrays(dtype_name, "batched-padded", cuda_device, 40, 90)
    R = arrays[0].shape[1]
    before = dict(port_ltsp_dp.LAUNCHES)
    T, C = port_ltsp_dp.ltsp_dp_tables(*arrays, S=S, device=cuda_device, **kw)
    T_plain, C_plain = port_ref.ltsp_dp_tables_tiled_ref(
        *arrays, S=S, Tb=port_ltsp_dp.TILE[dtype_name], **kw)
    torch.cuda.synchronize()
    assert torch.equal(T, T_plain) and torch.equal(C, C_plain)
    steps = list(port_ref.tile_schedule(R, port_ltsp_dp.TILE[dtype_name]))
    for kind, name in (("far", "far_fold_kernel"), ("near", "near_fold_kernel")):
        assert port_ltsp_dp.LAUNCHES[name] - before[name] == sum(s[0] == kind for s in steps)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TRACEBACK_CASES))
def test_cuda_traceback_matches_plain_walk(cuda_device, case):
    (lo, hi), span, disjoint, n_inst, B_pad = TRACEBACK_CASES[case]
    rng = np.random.default_rng([SEED, 71, list(TRACEBACK_CASES).index(case)])
    insts = [random_port_instance(rng, lo, hi + 40) for _ in range(n_inst)]
    *arrays, S = port_ops.prepare_batch(insts, B_pad=B_pad, device=cuda_device)
    _, C = port_ltsp_dp.ltsp_dp_tables(*arrays, S=S, span=span, disjoint=disjoint,
                                       device=cuda_device)
    before = port_ltsp_dp.LAUNCHES["traceback_kernel"]
    dets, counts = port_ltsp_dp.ltsp_traceback(C, arrays[2])
    dets_plain, counts_plain = port_ref.traceback_ref(C, arrays[2])
    torch.cuda.synchronize()
    assert port_ltsp_dp.LAUNCHES["traceback_kernel"] == before + 1
    assert torch.equal(dets, dets_plain) and torch.equal(counts, counts_plain)


@pytest.mark.cuda
def test_cuda_solve_brings_only_detours_to_the_host(cuda_device):
    """Without capture, the cuda backend copies O(B R) integers, not planes."""
    from repro_torch.core import dp_schedule

    rng = np.random.default_rng([SEED, 72])
    insts = [random_port_instance(rng, 20, 60) for _ in range(5)]
    before = port_ops.HOST_BYTES["copied"]
    got = port_ops.ltsp_solve_batch(insts, device=cuda_device)
    copied = port_ops.HOST_BYTES["copied"] - before
    assert got == [dp_schedule(inst) for inst in insts]
    R_pad = max(port_ops.bucket_shape(inst)[0] for inst in insts)
    assert 0 < copied <= len(insts) * 2 * (R_pad * 8 + 8)
