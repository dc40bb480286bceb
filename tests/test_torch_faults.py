"""The port's fault layer and write-ahead journal against the JAX package's.

The scenarios of ``tests/test_faults.py`` on the ``python`` backend — seeded
fault plans, drive failover, mount and media retries and their exhaustion,
solver faults, QoS accounting under failover — must give the reference's
reports and journal bytes, and ``recover_server`` must rebuild a torn journal
byte for byte, the same bytes the reference writes.
"""

import pytest

import repro.serving as ref_serving
import repro_torch.serving as port_serving
from torch_parity import PORT, REF, context, library, report_view, run_both, serve
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

SMALL_SEED = 7
SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def small_library(P):
    return library(P, SMALL_SEED)


def small_trace(P, n_requests=24):
    return P.serving.poisson_trace(small_library(P), n_requests=n_requests,
                                   mean_interarrival=40_000, seed=SMALL_SEED)


def serve_small(P, backend, journal=None, admission="accumulate", **kw):
    lib = small_library(P)
    return P.serving.serve_trace(lib, small_trace(P), admission, window=200_000, n_drives=2,
                                 journal=journal, context=context(P, lib, backend), **kw)


def first_batch(P, backend):
    return serve_small(P, backend).batches[0]


def whole_tape_fault(P, tape_id, count=1):
    tape = next(t for t in small_library(P).tapes if t.tape_id == tape_id)
    return P.serving.MediaFault(tape_id, 0, tape.used, count=count)


def seeded(admission, seed, failover):
    def run(P, backend, journal):
        plan = P.serving.seeded_fault_plan(small_library(P), small_trace(P), seed=seed,
                                           n_drives=2, backend=backend)
        retry = P.serving.RetryPolicy(on_exhausted="drop") if not failover else \
            P.serving.RetryPolicy()
        return serve_small(P, backend, journal, admission, faults=plan, retry=retry)
    return run


for _adm in ("fifo", "accumulate", "preempt", "fifo-global", "per-drive-accumulate", "batched"):
    for _seed in (3, 11):
        SCENARIOS[f"seeded_{_adm}_{_seed}_drop"] = seeded(_adm, _seed, failover=False)
SCENARIOS["seeded_accumulate_3_failover"] = seeded("accumulate", 3, failover=True)


@scenario
def drive_failover(P, backend, journal):
    b = first_batch(P, backend)
    plan = P.serving.FaultPlan(drive_failures=(
        P.serving.DriveFailure(at=b.dispatched + b.mount_delay + 1, drive=0),))
    return serve_small(P, backend, journal, faults=plan, retry=P.serving.RetryPolicy())


@scenario
def fail_stop(P, backend, journal):
    b = first_batch(P, backend)
    plan = P.serving.FaultPlan(drive_failures=(
        P.serving.DriveFailure(at=b.dispatched + b.mount_delay + 1, drive=0),))
    return serve_small(P, backend, journal, faults=plan, retry=P.serving.FAIL_STOP)


@scenario
def all_drives_failed_drop(P, backend, journal):
    plan = P.serving.FaultPlan(drive_failures=(
        P.serving.DriveFailure(at=1, drive=0), P.serving.DriveFailure(at=1, drive=1)))
    return serve_small(P, backend, journal, faults=plan,
                       retry=P.serving.RetryPolicy(on_exhausted="drop"))


@scenario
def mount_retry_backoff(P, backend, journal):
    plan = P.serving.FaultPlan(mount_faults=(
        P.serving.MountFault(first_batch(P, backend).tape_id, count=2),))
    return serve_small(P, backend, journal, faults=plan,
                       retry=P.serving.RetryPolicy(backoff_base=10_000, backoff_factor=2))


@scenario
def mount_exhaustion_drop(P, backend, journal):
    plan = P.serving.FaultPlan(mount_faults=(
        P.serving.MountFault(first_batch(P, backend).tape_id, count=99),))
    return serve_small(P, backend, journal, faults=plan,
                       retry=P.serving.RetryPolicy(mount_attempts=2, on_exhausted="drop"))


@scenario
def media_abort_retry(P, backend, journal):
    plan = P.serving.FaultPlan(media_faults=(
        whole_tape_fault(P, first_batch(P, backend).tape_id),))
    return serve_small(P, backend, journal, faults=plan, retry=P.serving.RetryPolicy())


@scenario
def media_exhaustion_drop(P, backend, journal):
    plan = P.serving.FaultPlan(media_faults=(
        whole_tape_fault(P, first_batch(P, backend).tape_id, count=99),))
    return serve_small(P, backend, journal, faults=plan,
                       retry=P.serving.RetryPolicy(media_attempts=2, on_exhausted="drop"))


@scenario
def solver_faults_retried(P, backend, journal):
    plan = P.serving.FaultPlan(solver_faults=(P.serving.SolverFault(backend, count=2),))
    return serve_small(P, backend, journal, faults=plan, retry=P.serving.RetryPolicy())


@scenario
def solver_exhaustion_fail_stop(P, backend, journal):
    plan = P.serving.FaultPlan(solver_faults=(P.serving.SolverFault(backend, count=99),))
    return serve_small(P, backend, journal, "batched", faults=plan, retry=P.serving.FAIL_STOP)


def qos_failover(admission):
    def run(P, backend, journal):
        tr = small_trace(P)
        qos = {r.req_id: P.serving.QoSSpec(deadline=r.time + 2_000_000, qos_class="batch")
               for r in tr}
        base = serve_small(P, backend, None, admission, qos=qos)
        b = base.batches[0]
        plan = P.serving.FaultPlan(drive_failures=(
            P.serving.DriveFailure(at=b.dispatched + b.mount_delay + 1, drive=0),))
        return serve_small(P, backend, journal, admission, qos=qos, faults=plan,
                           retry=P.serving.RetryPolicy())
    return run


SCENARIOS["qos_failover_edf_global"] = qos_failover("edf-global")
SCENARIOS["qos_failover_slack_accumulate"] = qos_failover("slack-accumulate")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fault_scenario_matches_reference(name, tmp_path):
    (ref, ref_journal), (port, port_journal) = run_both(SCENARIOS[name], tmp_path)
    assert port == ref
    assert port_journal == ref_journal


def test_qos_failover_slo_report_matches_reference():
    views = []
    for P in (REF, PORT):
        report = SCENARIOS["qos_failover_edf_global"](P, "python", None)
        slo = P.serving.slo_report(report)
        views.append((slo.summary(), slo.n_missed_faulted))
    assert views[1] == views[0]


@pytest.mark.parametrize("fault", ["no-drive", "mount", "media", "unknown-drive"])
def test_typed_errors_match_reference(fault):
    errors = []
    for P in (REF, PORT):
        S = P.serving
        tid = first_batch(P, "python").tape_id
        plan, retry = {
            "no-drive": (S.FaultPlan(drive_failures=(S.DriveFailure(at=1, drive=0),
                                                     S.DriveFailure(at=1, drive=1))),
                         S.RetryPolicy()),
            "mount": (S.FaultPlan(mount_faults=(S.MountFault(tid, count=99),)),
                      S.RetryPolicy(mount_attempts=2)),
            "media": (S.FaultPlan(media_faults=(whole_tape_fault(P, tid, count=99),)),
                      S.RetryPolicy(media_attempts=2)),
            "unknown-drive": (S.FaultPlan(drive_failures=(S.DriveFailure(at=1, drive=7),)),
                              None),
        }[fault]
        with pytest.raises(Exception) as err:
            serve_small(P, "python", faults=plan, retry=retry)
        errors.append((type(err.value).__name__, str(err.value)))
    assert errors[1] == errors[0]


def test_seeded_fault_plans_match_reference():
    for seed in (3, 11, 29):
        plans = []
        for P in (REF, PORT):
            plan = P.serving.seeded_fault_plan(small_library(P), small_trace(P), seed=seed,
                                               n_drives=3, drive_failures=2, media_faults=2,
                                               solver_faults=2)
            plans.append(repr(plan).replace("repro_torch.", "repro."))
        assert plans[1] == plans[0]


def test_retry_policy_and_injector_match_reference():
    for kw in ({}, dict(backoff_base=10_000, backoff_factor=3), dict(max_attempts=5)):
        ref_p, port_p = ref_serving.RetryPolicy(**kw), port_serving.RetryPolicy(**kw)
        for cls in ("mount", "media", "solver"):
            assert port_p.attempts(cls) == ref_p.attempts(cls)
        assert [port_p.backoff(a) for a in (1, 2, 3)] == [ref_p.backoff(a) for a in (1, 2, 3)]
    for P in (REF, PORT):
        with pytest.raises(ValueError):
            P.serving.RetryPolicy(max_attempts=0)
        with pytest.raises(ValueError):
            P.serving.RetryPolicy(on_exhausted="ignore")
    trails = []
    for P in (REF, PORT):
        backend = "python"
        inj = P.serving.FaultInjector(P.serving.FaultPlan(
            solver_faults=(P.serving.SolverFault(backend, count=2),)))
        trails.append([inj.solver_fails(backend) for _ in range(4)])
    assert trails[1] == trails[0] == [True, True, False, False]


# ---------------------------------------------------------------------------
# the write-ahead journal and crash recovery
# ---------------------------------------------------------------------------
def test_journal_recovery_at_every_cut_matches_reference(tmp_path):
    (ref_full, ref_data), (port_full, port_data) = run_both(
        lambda P, backend, journal: serve_small(P, backend, journal), tmp_path)
    assert port_data == ref_data and port_full == ref_full
    for cut in (0, 10, len(port_data) // 3, len(port_data) // 2, len(port_data) - 5,
                len(port_data)):
        p = tmp_path / f"cut{cut}.jsonl"
        p.write_bytes(port_data[:cut])
        lib = small_library(PORT)
        report = port_serving.recover_server(lib, small_trace(PORT), str(p),
                                             admission="accumulate", window=200_000,
                                             n_drives=2, context=context(PORT, lib, "python"))
        assert report_view(report) == port_full, cut
        assert p.read_bytes() == ref_data, cut


def test_journal_recovery_under_faults_matches_reference(tmp_path):
    def faulted(P, backend, journal):
        plan = P.serving.seeded_fault_plan(small_library(P), small_trace(P), seed=3, n_drives=2)
        return serve_small(P, backend, journal, faults=plan, retry=P.serving.RetryPolicy())

    (ref_full, ref_data), (port_full, port_data) = run_both(faulted, tmp_path)
    assert port_full == ref_full and port_data == ref_data
    p = tmp_path / "cut.jsonl"
    p.write_bytes(port_data[: len(port_data) // 2])
    plan = port_serving.seeded_fault_plan(small_library(PORT), small_trace(PORT), seed=3,
                                          n_drives=2)
    lib = small_library(PORT)
    report = port_serving.recover_server(lib, small_trace(PORT), str(p),
                                         admission="accumulate", window=200_000, n_drives=2,
                                         faults=plan, retry=port_serving.RetryPolicy(),
                                         context=context(PORT, lib, "python"))
    assert report_view(report) == port_full
    assert p.read_bytes() == ref_data


def test_journal_scan_tolerates_tears_like_reference(tmp_path):
    _, data = serve(PORT, lambda P, b, journal: serve_small(P, b, journal), "python",
                    tmp_path / "j.jsonl")
    lines = data.split(b"\n")
    variants = {
        "torn": data[:-7],
        "corrupt-interior": b"\n".join(lines[:3] + [b"{not json"] + lines[4:]),
        "newline-garbage": b"\n".join(lines[:5]) + b"\n" + b"[" * 5000 + b"\n",
        "foreign-object": b"\n".join(lines[:2]) + b"\n[1, 2]\n",
    }
    for name, raw in variants.items():
        p = tmp_path / f"{name}.jsonl"
        p.write_bytes(raw)
        assert port_serving.EventJournal.load(p) == ref_serving.EventJournal.load(p), name
        port_j, port_events = port_serving.EventJournal.resume(p)
        port_j.close()
        truncated = p.read_bytes()
        p.write_bytes(raw)
        ref_j, ref_events = ref_serving.EventJournal.resume(p)
        ref_j.close()
        assert (port_events, truncated) == (ref_events, p.read_bytes()), name


def test_journal_of_another_run_raises_like_reference(tmp_path):
    errors = []
    for P in (REF, PORT):
        path = tmp_path / f"{P.name}.jsonl"
        serve_small(P, "python", str(path))
        with pytest.raises(P.serving.JournalReplayError) as err:
            lib = small_library(P)
            P.serving.recover_server(lib, small_trace(P, 20), str(path),
                                     admission="accumulate", window=200_000, n_drives=2)
        errors.append(str(err.value))
    assert errors[1] == errors[0]
