"""The port's adaptive dispatch against the JAX package's.

The serving scenarios of ``tests/test_adaptive.py`` on the ``python`` backend:
solver selectors under a ``ComputeBudget``, hysteresis, priced solves, warm
states across policy switches, urgent cross-cartridge preemption, class
weights, and all of it composed with the fault layer.  Reports, policy mixes
and journal bytes must match the reference exactly.
"""

import pytest

from torch_parity import PORT, REF, SEED, context, costs, library, run_both
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def lib40(P):
    return library(P, SEED, n_files=40)


def trace40(P, n_requests=120, rate=150_000):
    return P.serving.poisson_trace(lib40(P), n_requests=n_requests, mean_interarrival=rate,
                                   seed=SEED)


def adaptive(P, backend, journal, admission="per-drive-accumulate", *, tr=None, budget=None,
             **kw):
    lib = lib40(P)
    ctx = context(P, lib, backend, **({"budget": P.core.ComputeBudget(**budget)}
                                      if budget is not None else {}))
    kw.setdefault("window", 400_000)
    kw.setdefault("n_drives", 2)
    kw.setdefault("drive_costs", costs(P))
    return P.serving.serve_trace(lib, trace40(P) if tr is None else tr, admission,
                                 policy="dp", context=ctx, journal=journal, **kw)


@scenario
def fixed_selector(P, backend, journal):
    return adaptive(P, backend, journal, selector="fixed")


@scenario
def fixed_selector_preempt(P, backend, journal):
    return adaptive(P, backend, journal, "preempt", selector="fixed")


@scenario
def depth_threshold(P, backend, journal):
    return adaptive(P, backend, journal, tr=trace40(P, 160), selector="depth-threshold",
                    budget=dict(shallow_depth=2, deep_depth=6, hysteresis=1))


@scenario
def depth_threshold_damped(P, backend, journal):
    return adaptive(P, backend, journal, tr=trace40(P, 160), selector="depth-threshold",
                    budget=dict(shallow_depth=2, deep_depth=6, hysteresis=10**6))


@scenario
def depth_threshold_cold(P, backend, journal):
    return adaptive(P, backend, journal, tr=trace40(P, 160), selector="depth-threshold",
                    budget=dict(shallow_depth=2, deep_depth=6, hysteresis=1), warm_start=False)


@scenario
def priced_budget(P, backend, journal):
    return adaptive(P, backend, journal, tr=trace40(P, 80), selector="fixed", warm_start=False,
                    budget=dict(solve_time_num=7, solve_time_den=3))


@scenario
def cost_model(P, backend, journal):
    return adaptive(P, backend, journal, tr=trace40(P, 160, 30_000), selector="cost-model",
                    warm_start=False,
                    budget=dict(solve_time_num=10_000, per_tick=120, hysteresis=1))


def two_tape_library(P):
    lib = P.tape.TapeLibrary(capacity_per_tape=100_000, u_turn=100)
    for name in ("a0", "a1", "a2"):
        lib.store(name, 30_000)
    lib.store("b0", 2_000)
    return lib


def urgent(preempt, lax=False):
    def run(P, backend, journal):
        lib = two_tape_library(P)
        a, b = lib.location["a0"], lib.location["b0"]
        R = P.serving.Request
        if lax:
            tr = [R(time=0, req_id=0, tape_id=a, name="a0"),
                  R(time=0, req_id=1, tape_id=a, name="a1"),
                  R(time=5_000, req_id=2, tape_id=b, name="b0")]
            qos = {0: P.serving.QoSSpec(deadline=20_000), 1: P.serving.QoSSpec(deadline=20_000),
                   2: P.serving.QoSSpec(deadline=10**9)}
        else:
            tr = [R(time=0, req_id=i, tape_id=a, name=f"a{i}") for i in range(3)]
            tr.append(R(time=5_000, req_id=3, tape_id=b, name="b0"))
            qos = {3: P.serving.QoSSpec(deadline=30_000, qos_class="interactive")}
        return P.serving.serve_trace(lib, tr, "edf-global", window=0, policy="dp", n_drives=1,
                                     qos=qos, preempt_urgent=preempt, journal=journal,
                                     context=context(P, lib, backend))
    return run


SCENARIOS["urgent_waits"] = urgent(False)
SCENARIOS["urgent_preempts"] = urgent(True)
SCENARIOS["urgent_ignores_lax_arrivals"] = urgent(True, lax=True)


def weighted(weights):
    def run(P, backend, journal):
        records = P.traces.qos_poisson_trace(lib40(P), n_requests=160,
                                             mean_interarrival=100_000, seed=SEED,
                                             tightness=8_000_000)
        tr, qos = P.traces.to_requests(records, lib40(P))
        return adaptive(P, backend, journal, "edf-global", tr=tr, qos=qos,
                        class_weights=weights)
    return run


SCENARIOS["class_weights_batch"] = weighted({"batch": 8_000_000})
SCENARIOS["class_weights_empty"] = weighted({})


def fault_plan(P, tr, **kw):
    return P.serving.seeded_fault_plan(lib40(P), tr, seed=3, n_drives=2, **kw)


@scenario
def fixed_selector_under_faults(P, backend, journal):
    tr = trace40(P, 96, 100_000)
    plan = fault_plan(P, tr, drive_failures=1, mount_faults=1, media_faults=1,
                      solver_faults=2, backend=backend)
    return adaptive(P, backend, journal, tr=tr, selector="fixed", faults=plan,
                    retry=P.serving.RetryPolicy())


@scenario
def cost_model_under_faults(P, backend, journal):
    tr = trace40(P, 96, 100_000)
    plan = fault_plan(P, tr, drive_failures=1, mount_faults=1, media_faults=1,
                      solver_faults=2, backend=backend)
    return adaptive(P, backend, journal, tr=tr, selector="cost-model", warm_start=False,
                    faults=plan, retry=P.serving.RetryPolicy(),
                    budget=dict(solve_time_num=10_000, per_tick=120, hysteresis=1))


@scenario
def full_stack(P, backend, journal):
    records = P.traces.qos_poisson_trace(lib40(P), n_requests=96, mean_interarrival=100_000,
                                         seed=SEED, tightness=8_000_000)
    tr, qos = P.traces.to_requests(records, lib40(P))
    plan = fault_plan(P, tr, drive_failures=1, mount_faults=1)
    return adaptive(P, backend, journal, "slack-accumulate", tr=tr, qos=qos,
                    selector="cost-model", preempt_urgent=True,
                    class_weights={"batch": 4_000_000}, warm_start=False, faults=plan,
                    retry=P.serving.RetryPolicy(),
                    budget=dict(solve_time_num=10_000, per_tick=120, hysteresis=1))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_adaptive_scenario_matches_reference(name, tmp_path):
    (ref, ref_journal), (port, port_journal) = run_both(SCENARIOS[name], tmp_path)
    assert port == ref
    assert port_journal == ref_journal


def test_selector_errors_match_reference():
    errors = []
    for P in (REF, PORT):
        row = []
        for kw in (dict(selector="ghost"), dict(preempt_urgent=True),
                   dict(class_weights={"batch": -5}), dict(class_weights={"batch": 1.5})):
            admission = "edf-global" if "class_weights" in kw else "per-drive-accumulate"
            with pytest.raises((KeyError, ValueError)) as err:
                P.serving.serve_trace(lib40(P), trace40(P, 10), admission, window=400_000,
                                      **kw)
            row.append((type(err.value).__name__, str(err.value)))
        errors.append(row)
    assert errors[1] == errors[0]
