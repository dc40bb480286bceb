"""The port's solver engine against the JAX package's.

All nine policies give the same ``(cost, detours)`` in both packages on the
``python`` backend; the device policies on the port's ``torch`` backend (on
the CPU) match the reference's ``pallas-interpret``; and the plumbing around
them — contexts, the degradation chain, solve caches, capture planes, warm
work counters, launch profiles — agrees.  ``backend="cuda"`` never falls
back to the plain version: without a card it raises.
"""

import warnings

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro_torch.core.instance import make_instance as port_make_instance
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

SEED = 20211218
POLICIES = ["nodetour", "gs", "fgs", "nfgs", "lognfgs5", "logdp1", "logdp5", "simpledp", "dp"]
DEVICE_POLICIES = ["dp", "logdp1", "logdp5", "simpledp"]
PORT_CPU = port_core.ExecutionContext(backend="torch", device="cpu")
REF_DEV = ref_core.ExecutionContext(backend="pallas-interpret")


def random_pair(rng, lo=2, hi=14, max_u=30):
    """One seeded draw built in both packages from the same numpy arrays."""
    R = int(rng.integers(lo, hi))
    sizes = rng.integers(1, 50, size=R)
    gaps = rng.integers(0, 40, size=R + 1)
    left, pos = [], int(gaps[0])
    for i in range(R):
        left.append(pos)
        pos += int(sizes[i] + gaps[i + 1])
    mult = rng.integers(1, 10, size=R)
    u = int(rng.integers(0, max_u))
    return (port_make_instance(left, sizes, mult, m=pos, u_turn=u),
            ref_core.make_instance(left, sizes, mult, m=pos, u_turn=u))


def pairs(tag, n, **kw):
    rng = np.random.default_rng([SEED, tag])
    return [random_pair(rng, **kw) for _ in range(n)]


def outcome(res):
    return res.cost, [tuple(map(int, d)) for d in res.detours]


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------
def test_registry_matches_reference():
    assert port_core.list_solvers() == ref_core.list_solvers() == POLICIES
    for name in POLICIES:
        ours, theirs = port_core.get_solver(name), ref_core.get_solver(name)
        assert (ours.kind, ours.description, ours.supports_device, ours.supports_warm) == (
            theirs.kind, theirs.description, theirs.supports_device, theirs.supports_warm)


@pytest.mark.parametrize("policy", POLICIES)
def test_python_backend_matches_reference(policy):
    for port_inst, ref_inst in pairs(POLICIES.index(policy), 12):
        assert outcome(port_core.solve(port_inst, policy)) == outcome(
            ref_core.solve(ref_inst, policy))


def test_python_backend_matches_reference_on_bench_tapes():
    from repro.data import BENCH_PROFILE as REF_BENCH
    from repro.data import generate_dataset as ref_generate
    from repro_torch.data import BENCH_PROFILE, generate_dataset

    ours = [i for i in generate_dataset(BENCH_PROFILE) if i.n_req <= 12]
    theirs = [i for i in ref_generate(REF_BENCH) if i.n_req <= 12]
    assert len(ours) == len(theirs) >= 5
    for policy in POLICIES:
        got = port_core.solve_batch(ours, policy)
        want = ref_core.solve_batch(theirs, policy)
        assert [outcome(r) for r in got] == [outcome(r) for r in want], policy


@pytest.mark.parametrize("policy", DEVICE_POLICIES)
def test_torch_backend_matches_pallas_interpret(policy):
    batch = pairs(100 + DEVICE_POLICIES.index(policy), 6, hi=12)
    got = port_core.solve_batch([p for p, _ in batch], policy, context=PORT_CPU)
    want = ref_core.solve_batch([r for _, r in batch], policy, context=REF_DEV)
    python = port_core.solve_batch([p for p, _ in batch], policy)
    assert [outcome(r) for r in got] == [outcome(r) for r in want] == [
        outcome(r) for r in python]
    assert {r.backend for r in got} == {"torch"}


def test_unbucketed_and_banded_torch_backend_match_python():
    batch = [p for p, _ in pairs(110, 5, hi=12)]
    python = [outcome(r) for r in port_core.solve_batch(batch, "dp")]
    for ctx in (PORT_CPU.replace(bucketed=False), PORT_CPU.replace(cand_tile=3)):
        assert [outcome(r) for r in port_core.solve_batch(batch, "dp", context=ctx)] == python


def test_heuristics_have_no_device_backend():
    inst, _ = pairs(120, 1)[0]
    with pytest.raises(port_core.UnsupportedBackendError) as err:
        port_core.solve(inst, "gs", context=PORT_CPU)
    assert str(err.value) == "policy 'gs' has no 'torch' backend (supported: ('python',))"


# ---------------------------------------------------------------------------
# context, shims and the degradation chain
# ---------------------------------------------------------------------------
def test_context_backends_device_and_obs():
    from repro_torch.core.solver import DEGRADATION_CHAIN

    assert port_core.BACKENDS == ("python", "torch", "cuda")
    assert DEGRADATION_CHAIN == ("cuda", "torch", "python")
    ctx = port_core.ExecutionContext()
    assert (ctx.backend, ctx.device, ctx.numeric_policy, ctx.bucketed) == (
        "python", "cuda", "strict", True)
    with pytest.raises(KeyError):
        port_core.ExecutionContext(backend="pallas")
    from repro_torch.obs import Observability

    bundle = Observability.enabled()
    assert port_core.ExecutionContext(obs=bundle).obs is bundle
    with pytest.raises(TypeError, match="obs must be an Observability bundle"):
        port_core.ExecutionContext(obs=object())
    with pytest.raises(ValueError, match="numeric_policy"):
        port_core.ExecutionContext(numeric_policy="f16")


def test_deprecated_keywords_warn_and_match_context():
    inst, _ = pairs(130, 1)[0]
    with pytest.warns(DeprecationWarning, match="deprecated"):
        legacy = port_core.solve(inst, "dp", backend="python")
    assert outcome(legacy) == outcome(port_core.solve(inst, "dp"))
    with pytest.warns(DeprecationWarning, match="backend string"):
        port_core.get_solver("dp").solve(inst, "python")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_core.solve(inst, "dp", context=PORT_CPU)


def test_cuda_backend_without_a_card_raises_instead_of_falling_back():
    """No silent fallback: the cuda backend on a CPU-only machine raises, and
    the error is neither transient nor unsupported, so the degradation chain
    does not swallow it either."""
    from repro_torch.core.solver import solve_warm_degraded

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    inst, _ = pairs(140, 1)[0]
    for ctx, err in ((port_core.ExecutionContext(backend="cuda"), RuntimeError),
                     (port_core.ExecutionContext(backend="cuda", device="cpu"), ValueError)):
        for call in (lambda: port_core.solve(inst, "dp", context=ctx),
                     lambda: port_core.solve_batch([inst, inst], "simpledp", context=ctx),
                     lambda: solve_warm_degraded(inst, "dp", context=ctx)):
            with pytest.raises(err) as caught:
                call()
            assert not isinstance(caught.value, (port_core.UnsupportedBackendError,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_core.solve(inst, "dp", context=PORT_CPU.replace(device="cuda"))


def test_degradation_chain_walks_cuda_torch_python():
    from repro_torch.core.solver import (
        SolverUnavailableError, TransientSolverError, solve_batch_warm_degraded,
        solve_warm_degraded,
    )

    inst, ref_inst = pairs(150, 1)[0]
    ctx = port_core.ExecutionContext(backend="cuda", device="cpu")

    def cuda_faults(backend):
        if backend == "cuda":
            raise TransientSolverError(backend)

    res, warm, stats, record = solve_warm_degraded(inst, "dp", context=ctx, fault_hook=cuda_faults)
    assert (record.requested, record.used, record.failed) == ("cuda", "torch", ("cuda",))
    assert warm is None and outcome(res) == outcome(ref_core.solve(ref_inst, "dp"))
    results, _, _, record = solve_batch_warm_degraded(
        [inst], "logdp1", context=ctx,
        fault_hook=lambda b: cuda_faults(b) if b == "cuda" else None)
    assert record.used == "torch"

    def all_fault(backend):
        raise TransientSolverError(backend)

    with pytest.raises(SolverUnavailableError):
        solve_warm_degraded(inst, "dp", context=ctx, fault_hook=all_fault)


def test_partial_batch_types_guard_failures():
    good, _ = pairs(160, 1)[0]
    bad = port_make_instance([0, 2 * 10**9 + 1], [10**6 + 1, 10**6 + 3], [3, 3],
                             u_turn=10**7 + 1)
    out = port_core.solve_batch([good, bad], "dp", context=PORT_CPU, partial=True)
    assert isinstance(out[0], port_core.SolveResult)
    from repro_torch.core.solver import FailedSolve

    assert isinstance(out[1], FailedSolve) and out[1].index == 1
    assert "int32" in str(out[1].error)
    f64 = port_core.solve(bad, "dp", context=PORT_CPU.replace(numeric_policy="f64"))
    assert outcome(f64) == outcome(port_core.solve(bad, "dp"))


# ---------------------------------------------------------------------------
# caches, capture planes, warm state, launch profiles
# ---------------------------------------------------------------------------
def test_solve_cache_keys_and_hits_match_reference():
    inst, ref_inst = pairs(170, 1)[0]
    assert port_core.SolveCache.key(inst, "dp", "python", "f64", 8) == \
        ref_core.SolveCache.key(ref_inst, "dp", "python", "f64", 8)
    cache = port_core.SolveCache(maxsize=2)
    ctx = PORT_CPU.replace(cache=cache)
    first = port_core.solve(inst, "dp", context=ctx)
    again = port_core.solve(inst, "dp", context=ctx)
    assert outcome(first) == outcome(again) and cache.stats()["hits"] == 1
    assert again.detours is not first.detours


def test_jsonl_cache_backend_rewarms(tmp_path):
    inst, _ = pairs(180, 1)[0]
    path = tmp_path / "memo.jsonl"
    cache = port_core.JsonlCacheBackend(path)
    try:
        res = port_core.solve(inst, "dp", context=PORT_CPU.replace(cache=cache))
    finally:
        cache.close()
    cache = port_core.JsonlCacheBackend(path)
    try:
        hit = cache.get(inst, "dp", "torch")
    finally:
        cache.close()
    assert hit is not None and outcome(hit) == outcome(res)


def test_capture_planes_and_warm_counters_match_reference():
    from repro.kernels.ltsp_dp import ops as ref_ops
    from repro_torch.kernels.ltsp_dp import ops as port_ops

    batch = pairs(190, 4, hi=10)
    ours, our_stores = port_ops.ltsp_solve_batch(
        [p for p, _ in batch], backend="torch", device="cpu", capture=True)
    theirs, their_stores = ref_ops.ltsp_solve_batch(
        [r for _, r in batch], interpret=True, capture=True)
    assert ours == theirs
    for a, b in zip(our_stores, their_stores):
        assert len(a) == len(b) and a._g == b._g and a._prefix == b._prefix
        np.testing.assert_array_equal(a._table, b._table)
        np.testing.assert_array_equal(a._choice, b._choice)
    _, _, our_stats = port_ops.ltsp_solve_batch_warm(
        [p for p, _ in batch], backend="torch", device="cpu")
    _, _, their_stats = ref_ops.ltsp_solve_batch_warm([r for _, r in batch], interpret=True)
    assert [s.cells_evaluated for s in our_stats] == [s.cells_evaluated for s in their_stats]


def _bump(inst, make, i):
    mult = [int(v) for v in inst.mult]
    mult[i % len(mult)] += 1
    return make(inst.left.tolist(), (inst.right - inst.left).tolist(), mult, m=inst.m,
                u_turn=inst.u_turn)


def test_warm_chains_match_reference():
    """``dp_schedule_warm`` and the device warm path reuse the same cells and
    return the same schedules as the reference along a perturbation chain."""
    from repro.kernels.ltsp_dp import ops as ref_ops
    from repro_torch.kernels.ltsp_dp import ops as port_ops

    for port_inst, ref_inst in pairs(200, 3, lo=4, hi=10):
        warm_p = warm_r = None
        dwarm_p = dwarm_r = None
        for step in range(3):
            cp, dp_, warm_p, sp = port_core.dp_schedule_warm(port_inst, warm=warm_p)
            cr, dr, warm_r, sr = ref_core.dp_schedule_warm(ref_inst, warm=warm_r)
            assert (cp, dp_, sp.cells_evaluated, sp.cells_reused, sp.mode) == (
                cr, dr, sr.cells_evaluated, sr.cells_reused, sr.mode)
            *res_p, dwarm_p, dsp = port_ops.ltsp_solve_instance_warm(
                port_inst, warm=dwarm_p, backend="torch", device="cpu")
            *res_r, dwarm_r, dsr = ref_ops.ltsp_solve_instance_warm(
                ref_inst, warm=dwarm_r, interpret=True)
            assert res_p == res_r
            assert (dsp.cells_evaluated, dsp.cells_reused, dsp.mode) == (
                dsr.cells_evaluated, dsr.cells_reused, dsr.mode)
            port_inst = _bump(port_inst, port_make_instance, step)
            ref_inst = _bump(ref_inst, ref_core.make_instance, step)


def test_launch_profile_records_match_reference():
    """The reference's ``KernelProfile`` takes the port's records unchanged:
    same shapes, cell counts and signatures (the plain version stands where
    the reference's interpreter stood)."""
    from repro.kernels.ltsp_dp import ops as ref_ops
    from repro.obs import KernelProfile
    from repro_torch.kernels.ltsp_dp import ops as port_ops

    batch = pairs(210, 5, hi=20)
    ours, theirs = KernelProfile(wall=False), KernelProfile(wall=False)
    port_ops.ltsp_solve_batch([p for p, _ in batch], backend="torch", device="cpu",
                              profile=ours)
    ref_ops.ltsp_solve_batch([r for _, r in batch], interpret=True, profile=theirs)
    assert ours.launches == theirs.launches and ours._seen == theirs._seen
    assert ours.summary() == theirs.summary()


def test_selectors_match_reference():
    from repro.core.solver import LoadView as RefView
    from repro_torch.core.solver import LoadView

    assert port_core.list_selectors() == ref_core.list_selectors()
    budget_p = port_core.ComputeBudget(per_tick=5000, shallow_depth=2, deep_depth=6)
    budget_r = ref_core.ComputeBudget(per_tick=5000, shallow_depth=2, deep_depth=6)
    for depth in (1, 3, 8):
        for n in (5, 20, 60):
            timings = {"logdp1": (900, 1000)}
            for name in port_core.list_selectors():
                assert port_core.get_selector(name).select(
                    LoadView(depth, n, timings=timings), budget_p) == ref_core.get_selector(
                    name).select(RefView(depth, n, timings=timings), budget_r)
            for policy in ("dp", "logdp1", "nfgs"):
                assert port_core.predict_cells(policy, n, timings) == ref_core.predict_cells(
                    policy, n, timings)
