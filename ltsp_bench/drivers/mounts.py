"""Traffic kind ``mounts``: a closed loop of tape mounts, one solve each.

One caller solves one tape per mount through the program's entry,
``repro_torch.core.solver.solve(inst, policy, context=...)``, and waits
for the plan on the host before the next mount.  The mounts cycle through
the configuration's tape set, each pass in a new order drawn from the
seed, with every shape bucket spread evenly through it; the set itself is
the configuration's and does not change with the seed, and any stretch of
a pass holds each bucket in proportion, so a window's work does not hang
on where its last pass is cut.  Set-up solves every tape once, so every
shape is built and every table allocated before the window.  With ``--trace 1`` the second pass of
the window runs under the profiler, whole.

After the window, the check recomputes a sample of the tapes with the
reference: the one with the most work, one drawn from the seed in every
other shape bucket solved, and a few more drawn from the seed.  It holds
every solve of those tapes in the window to it: the reported cost against the
reference's optimum (the table values), and the detour list, replayed
independently, against it too (the traceback).  Both gaps go into one
number, ``answer_gap``.
"""

from __future__ import annotations

import contextlib
import sys
import time
import traceback

from ltsp_bench import profiling, reference, roofline, tapes as tapegen

#: the number the check compares, with its limit: the largest gap of a
#: checked solve's reported cost, or of its detours' replayed objective, from
#: the reference's optimum; exact
LIMITS = {"answer_gap": 0}


def tape_set(config: dict) -> list[tuple[int, dict]]:
    """``(index in the dataset, tape)`` of the configuration's served tapes:
    those whose table's padded window count stays within ``max_r_pad``."""
    ds = config["dataset"]
    tapes = tapegen.generate_tapes(ds["profile"], ds["base_seed"], ds["u_turn"])
    kept = [(i, t) for i, t in enumerate(tapes)
            if tapegen.pow2(len(t["left"])) <= config["max_r_pad"]]
    if len(kept) != config["tapes_served"]:
        raise RuntimeError(f"the tape set has {len(kept)} tapes, the configuration "
                           f"states {config['tapes_served']}")
    return kept


def setup(cell, device: str, backend: str) -> dict:
    """The program's context and instances, every tape solved once."""
    from repro_torch.core.instance import make_instance
    from repro_torch.core.solver import ExecutionContext, solve

    cfg = cell.config
    kept = tape_set(cfg)
    insts = {i: make_instance(t["left"], t["size"], t["mult"], m=t["m"], u_turn=t["u_turn"])
             for i, t in kept}
    ctx = ExecutionContext(backend=backend, numeric_policy=cfg["numeric_policy"],
                           device=device)
    for i, _ in kept:
        solve(insts[i], cfg["policy"], context=ctx)
    return {"tapes": dict(kept), "insts": insts, "ctx": ctx, "device": device,
            "buckets": {i: tapegen.bucket(len(t["left"]), int(t["mult"].sum()))
                        for i, t in kept},
            "backend": backend, "policy": cfg["policy"], "type_name": cfg["table_type"]}


def window(state: dict, seed: int, seconds: float, trace: bool) -> dict:
    """Mounts for ``seconds`` (and, traced, through the whole second pass)."""
    from repro_torch.core.solver import solve
    from repro_torch.kernels.ltsp_dp import ltsp_dp
    from repro_torch.obs import Observability
    from repro_torch.obs.kernel import KernelProfile

    order_rng = tapegen.seeded(seed, 0)
    ids = sorted(state["insts"])
    groups = [state["buckets"][i] for i in ids]
    solves, results = [], {}
    profile = None
    first_error = None
    clock = time.perf_counter
    t0 = clock()
    passes, pass_s = 0, []
    while True:
        traced = trace and passes == 1
        ctx = state["ctx"]
        if traced:
            kprof = KernelProfile(wall=False)
            ctx = ctx.replace(obs=Observability(kernel=kprof))
            ltsp_dp.reset_launches()
            first = len(solves)
        guard = profiling.profiled(state["device"]) if traced else contextlib.nullcontext({})
        t_pass = clock()
        with guard as box:
            for i in tapegen.spread_order(ids, groups, order_rng):
                t1 = clock()
                try:
                    res = solve(state["insts"][i], state["policy"], context=ctx)
                    ok = res.backend == state["backend"]
                    results.setdefault(i, []).append((res.cost, tuple(res.detours)))
                except Exception:  # a failed solve is counted, the loop goes on
                    ok = False
                    first_error = first_error or traceback.format_exc()
                t2 = clock()
                solves.append({"tape": i, "seconds": t2 - t1, "ok": ok})
                if not traced and t2 - t0 >= seconds:
                    break
            else:
                pass_s.append(clock() - t_pass)
        if traced:
            profile = profiling.device_summary(box["prof"])
            profile["solves"] = solves[first:]
            profile["launches"] = dict(ltsp_dp.LAUNCHES)
            profile["cells"] = [(r.real_cells, r.padded_cells) for r in kprof.launches]
        passes += 1
        if clock() - t0 >= seconds and (not trace or passes > 1):
            break
    elapsed = clock() - t0
    if first_error:
        print(first_error, file=sys.stderr)
    print("whole passes (s): " + " ".join(f"{v:.4f}" for v in pass_s), file=sys.stderr)
    tapes = state["tapes"]
    for s in solves:
        t = tapes[s["tape"]]
        s["n_req"], s["n"] = len(t["left"]), int(t["mult"].sum())
        s["least_s"] = roofline.least_seconds(
            s["n_req"], s["n"], roofline.policy_span(state["policy"], s["n_req"]),
            state["type_name"])
    return {"kind": "mounts", "solves": solves, "results": results, "window_s": elapsed,
            "attempted": len(solves), "failed": sum(not s["ok"] for s in solves),
            "profile": profile}


def sample(state: dict, run: dict, seed: int, extra: int) -> list[int]:
    """Tapes to recompute: the one with the most work solved in the window,
    one drawn from the seed in every other shape bucket solved, and
    ``extra`` more drawn from the seed among the others solved."""
    solved = sorted(run["results"])
    tapes = state["tapes"]
    work = [roofline.table_work(len(tapes[i]["left"]), int(tapes[i]["mult"].sum()), None,
                                "float64")[0] for i in solved]
    groups = [tapegen.bucket(len(tapes[i]["left"]), int(tapes[i]["mult"].sum()))
              for i in solved]
    return tapegen.draw_sample(solved, work, groups, extra, tapegen.seeded(seed, 1))


def reference_answer(tape: dict, policy: str, dtype, device: str) -> tuple[int, tuple]:
    """``(cost, detours)`` of the reference under ``policy``, in ``dtype``."""
    return reference.solve(tape, roofline.policy_span(policy, len(tape["left"])), dtype, device)


def compare(tape: dict, answers: list[tuple[int, tuple]], opt: int) -> dict:
    """The largest gaps of a tape's answers from the reference's optimum
    ``opt``: of their reported costs, and of their detours replayed."""
    scores = {}
    for _, dets in answers:
        if dets not in scores:
            try:
                scores[dets] = reference.schedule_cost(tape["left"], tape["size"],
                                                       tape["mult"], tape["m"], tape["u_turn"],
                                                       dets)
            except ValueError:  # a detour outside the tape: as far off as can be
                scores[dets] = opt + abs(opt) + 1
    return {"cost": max(abs(c - opt) for c, _ in answers),
            "plan": max(abs(scores[d] - opt) for _, d in answers)}


def check(state: dict, run: dict, seed: int, extra: int) -> dict:
    """``{number: (value, limit)}`` of the comparison with the reference."""
    import torch

    gaps = {"cost": 0, "plan": 0}
    picked = sample(state, run, seed, extra)
    for i in picked:
        tape = state["tapes"][i]
        opt, _ = reference_answer(tape, state["policy"], torch.float64, state["device"])
        for k, v in compare(tape, run["results"][i], opt).items():
            gaps[k] = max(gaps[k], v)
    run["checked"] = {"tapes": len(picked),
                      "solves": sum(len(run["results"][i]) for i in picked), "gaps": gaps}
    return {"answer_gap": (max(gaps.values()), LIMITS["answer_gap"])}


def release(state: dict) -> None:
    """Drop the program's state before the reference runs."""
    state.pop("insts", None)
    state.pop("ctx", None)
