"""The serving loop on the port's device backends.

On the CPU the port's ``torch`` backend (the kernels' plain version) serves
a few small scenarios against the reference's ``pallas-interpret``, with the
backend names mapped: timelines, batch records (cell counters included),
``summary()`` rows, journals and kernel-profile records must agree.  The
tests marked ``cuda`` serve a demo-library trace through the CUDA kernels
against the exact ``python`` backend; they skip without a card and run on
one with ``pytest -m cuda tests/test_torch_serving_device.py``.
"""

import dataclasses

import pytest
import torch

from torch_parity import PORT, REF, context, costs, library, report_view, run_both, trace
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def serve(P, backend, journal, admission, tr, obs=None, **kw):
    lib = library(P)
    changes = {"obs": obs} if obs is not None else {}
    return P.serving.serve_trace(lib, tr, admission, policy="dp", journal=journal,
                                 context=context(P, lib, backend, **changes), **kw)


@scenario
def accumulate_warm(P, backend, journal):
    return serve(P, backend, journal, "accumulate", trace(P, 60), window=400_000)


@scenario
def batched_pool(P, backend, journal):
    return serve(P, backend, journal, "batched", trace(P, 40), window=400_000, n_drives=2,
                 drive_costs=costs(P))


@scenario
def preempt_warm(P, backend, journal):
    return serve(P, backend, journal, "preempt", trace(P, 60, 150_000))


@scenario
def solver_faults_degrade(P, backend, journal):
    plan = P.serving.FaultPlan(solver_faults=(P.serving.SolverFault(backend, count=3),))
    return serve(P, backend, journal, "accumulate", trace(P, 40), window=400_000,
                 faults=plan, retry=P.serving.RetryPolicy())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_torch_backend_matches_reference_interpret(name, tmp_path):
    (ref, ref_journal), (port, port_journal) = run_both(SCENARIOS[name], tmp_path,
                                                        backend="pallas-interpret")
    assert port == ref
    assert port_journal == ref_journal


def test_kernel_profile_records_match_reference_interpret():
    records = []
    for P in (REF, PORT):
        obs = P.obs.Observability.enabled(wall=True)
        backend = "torch" if P is PORT else "pallas-interpret"
        report = serve(P, backend, None, "batched", trace(P, 40), obs=obs, window=400_000,
                       n_drives=2, drive_costs=costs(P))
        assert report.n_served == 40
        launches = obs.kernel.launches
        assert launches and all(isinstance(r.wall_ns, int) and r.wall_ns > 0 for r in launches)
        records.append(([dataclasses.replace(r, wall_ns=None) for r in launches],
                        obs.kernel.summary()))
    port, ref = records
    assert [dataclasses.astuple(r) for r in port[0]] == [dataclasses.astuple(r) for r in ref[0]]
    assert port[1] == ref[1]
    assert all(r.interpret for r in port[0])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _serve_on(P, backend, tmp_path, admission, **kw):
    path = tmp_path / f"{backend}.jsonl"
    lib = library(P)
    report = P.serving.serve_trace(lib, trace(P, 200), admission, policy="dp",
                                   journal=str(path), context=lib.context.replace(
                                       backend=backend, numeric_policy="f64"), **kw)
    return report, path.read_bytes()


def _timeline(report):
    view = report_view(report)
    cells = ("backend", "cells_evaluated", "cells_reused", "cells_per_batch")
    summary = [(k, v) for k, v in view[0] if k not in cells]
    batches = [dataclasses.astuple(dataclasses.replace(b, cells_evaluated=0, cells_reused=0))
               for b in report.batches]
    return summary, view[1], view[2], batches


@pytest.mark.cuda
@pytest.mark.parametrize("admission,kw", [
    ("accumulate", dict(window=400_000)),
    ("batched", dict(window=400_000, n_drives=2)),
])
def test_cuda_serving_matches_python(cuda_device, tmp_path, admission, kw):
    from repro_torch.kernels.ltsp_dp import ltsp_dp

    ltsp_dp.reset_launches()
    cuda, cuda_journal = _serve_on(PORT, "cuda", tmp_path, admission, **kw)
    assert ltsp_dp.LAUNCHES["near_fold_kernel"] > 0
    py, py_journal = _serve_on(PORT, "python", tmp_path, admission, **kw)
    assert _timeline(cuda) == _timeline(py)
    assert cuda_journal == py_journal
    assert all(b.degraded_to is None for b in cuda.batches)
    plain, _ = _serve_on(PORT, "torch", tmp_path, admission, **kw)
    assert report_view(cuda)[1:] == report_view(plain)[1:]
