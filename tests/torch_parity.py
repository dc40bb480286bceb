"""Shared helpers of the port's serving-layer parity tests.

A scenario is a function of one package namespace (:data:`REF` for the JAX
package, :data:`PORT` for the port) and the backend to solve on; it returns
the :class:`ServiceReport` of one serving run.  :func:`run_both` serves the
same scenario through both packages, each journaling its events, and
:func:`report_view` turns a report into plain data with the backend names
mapped (``cuda``/``torch``/``python`` of the port onto ``pallas``/
``pallas-interpret``/``python`` of the reference), so a parity test is one
``==`` over the views and one over the journal bytes.
"""

import dataclasses
import types

import repro.core
import repro.data.traces
import repro.fleet
import repro.obs
import repro.serving
import repro.storage.tape
import repro_torch.core
import repro_torch.data.traces
import repro_torch.fleet
import repro_torch.obs
import repro_torch.serving
import repro_torch.storage.tape

REF = types.SimpleNamespace(
    name="ref", core=repro.core, serving=repro.serving, traces=repro.data.traces,
    obs=repro.obs, tape=repro.storage.tape, fleet=repro.fleet,
)
PORT = types.SimpleNamespace(
    name="port", core=repro_torch.core, serving=repro_torch.serving,
    traces=repro_torch.data.traces, obs=repro_torch.obs, tape=repro_torch.storage.tape,
    fleet=repro_torch.fleet,
)

#: the port's backend names onto the JAX package's
TO_REF = {"cuda": "pallas", "torch": "pallas-interpret", "python": "python"}
#: the port's backend that plays each reference backend's role
PORT_BACKEND = {ref: port for port, ref in TO_REF.items()}

SEED = 20260731


def backend_for(P, backend: str) -> str:
    """``backend`` (a reference name) in package ``P``'s naming."""
    return PORT_BACKEND[backend] if P is PORT else backend


def costs(P):
    return P.serving.DriveCosts(mount=150_000, unmount=60_000, load_seek=30_000)


def library(P, seed: int = SEED, **kw):
    return P.serving.demo_library(seed, **kw)


def trace(P, n_requests: int = 240, rate: int = 250_000, seed: int = SEED, **lib_kw):
    return P.serving.poisson_trace(
        library(P, seed, **lib_kw), n_requests=n_requests, mean_interarrival=rate, seed=seed
    )


def context(P, lib, backend: str, **changes):
    """``lib``'s context on ``backend`` (``P``'s naming); the port's plain
    ``torch`` backend runs on the CPU here."""
    if P is PORT and backend == "torch":
        changes.setdefault("device", "cpu")
    return lib.context.replace(backend=backend, **changes)


def qos_trace(P, tightness: int, n_requests: int = 240, rate: int = 250_000, seed: int = SEED):
    records = P.traces.qos_poisson_trace(
        library(P, seed), n_requests=n_requests, mean_interarrival=rate, seed=seed,
        tightness=tightness,
    )
    return P.traces.to_requests(records, library(P, seed))


def _mapped(name):
    return TO_REF.get(name, name) if name is not None else None


def report_view(report) -> tuple:
    """Everything a report says, as plain data, with backend names mapped."""
    summary = report.summary()
    summary["backend"] = _mapped(summary["backend"])
    batches = [
        dataclasses.astuple(dataclasses.replace(b, degraded_to=_mapped(b.degraded_to)))
        for b in report.batches
    ]
    qos = sorted((k, dataclasses.astuple(v)) for k, v in (report.qos or {}).items())
    return (
        list(summary.items()),
        [dataclasses.astuple(r) for r in report.served],
        [dataclasses.astuple(f) for f in report.failed],
        batches,
        qos,
        report.fault_stats,
        report.policy_mix,
    )


def serve(P, scenario, backend: str, journal=None):
    """One run of ``scenario`` in package ``P`` (``backend`` in the
    reference's naming); returns ``(report, journal bytes or None)``."""
    report = scenario(P, backend_for(P, backend),
                      journal=None if journal is None else str(journal))
    return report, (journal.read_bytes() if journal is not None else None)


def run_both(scenario, tmp_path, backend: str = "python"):
    """Serve ``scenario`` through both packages (``backend`` in the
    reference's naming); returns the two ``(view, journal bytes)`` pairs."""
    ref, ref_journal = serve(REF, scenario, backend, tmp_path / "ref.jsonl")
    port, port_journal = serve(PORT, scenario, backend, tmp_path / "port.jsonl")
    return (report_view(ref), ref_journal), (report_view(port), port_journal)
