"""Online tape serving: admission policies vs per-request FIFO, oracle-checked.

Requests for archived objects arrive over virtual time against a robotic tape
library; per-cartridge queues and an admission policy decide when a queue
becomes an LTSP batch for the solver engine.  The discrete-event simulator
replays every emitted schedule and independently recomputes its cost, so the
batching-vs-FIFO improvement printed below is an exact integer fact about the
trace, not a wall-clock anecdote.

A second table shrinks the drive pool below one-drive-per-cartridge under an
explicit mount/unmount/load-seek cost model — the robotic-arm layer: the
cross-cartridge admissions decide which cartridge each freed drive mounts
next, and ``batched`` plans every mount-ready cartridge of an event tick in
one ``solve_batch`` device launch.  Every solve runs on ``--backend``: the
CUDA kernels on the card by default.

A third table prices the solver itself: a :class:`repro_torch.core.ComputeBudget`
charges virtual time per DP cell evaluated, so the exact DP's optimal
schedules are no longer free under load.  The ``cost-model`` selector
re-picks the policy each tick from queue depth and the recorded per-tick
solve timings — exact DP while queues are shallow, heuristics as depth
grows — and the table shows the per-batch policy mix it actually used.
Its ``dp (fixed)`` arm solves on ``--backend``; there the budget prices the
cells that backend evaluates (a device backend counts dense table cells, so
its row differs from ``python``'s).  The ``nfgs (fixed)`` and ``cost-model``
arms run on ``python``, as the table says: the heuristics of the selector's
ladder have no device backend, in this package or in the reference.

Run: PYTHONPATH=src python examples/torch/online_serving.py
"""

from __future__ import annotations

import argparse

from repro_torch.core import ComputeBudget
from repro_torch.serving.drives import DriveCosts
from repro_torch.serving.queue import LEGACY_ADMISSIONS, POOL_ADMISSIONS, serve_trace
from repro_torch.serving.sim import demo_library, poisson_trace


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--rate", type=int, default=200_000,
                    help="mean inter-arrival time (virtual units = bytes)")
    ap.add_argument("--window", type=int, default=400_000,
                    help="accumulate-then-solve re-plan window")
    ap.add_argument("--policy", default="dp")
    ap.add_argument("--backend", default="cuda",
                    help="solver backend: cuda (the CUDA kernels), torch, python")
    ap.add_argument("--device", default="cuda", help="torch device of cuda/torch")
    ap.add_argument("--mount-cost", type=int, default=150_000)
    ap.add_argument("--unmount-cost", type=int, default=60_000)
    ap.add_argument("--load-seek", type=int, default=30_000)
    ap.add_argument("--seed", type=int, default=20260731)
    args = ap.parse_args()

    trace = poisson_trace(
        demo_library(args.seed),
        n_requests=args.requests,
        mean_interarrival=args.rate,
        seed=args.seed,
    )
    n_tapes = len({r.tape_id for r in trace})
    # the demo's coordinates pass the int32 device guard only in part: the
    # device backends solve the rest in an exact float64 table
    device = dict(backend=args.backend, device=args.device, numeric_policy="f64")
    print(
        f"{args.requests} requests over {n_tapes} cartridges, horizon "
        f"{trace[-1].time:,} (virtual); solver {args.policy}/{args.backend}\n"
    )

    def run(admission, window, n_drives=None, costs=None):
        lib = demo_library(args.seed)
        report = serve_trace(
            lib,
            trace,
            admission,
            window=window,
            policy=args.policy,
            n_drives=n_drives,
            drive_costs=costs,
            context=lib.context.replace(**device),
        )
        return report.summary()

    print("one drive per cartridge, free mounts (the dedicated-drive special case):")
    print(f"{'admission':<12}{'mean':>12}{'p95':>12}{'batches':>9}"
          f"{'preempts':>10}{'verified':>10}")
    baseline = None
    for admission in LEGACY_ADMISSIONS:
        s = run(admission, args.window if admission == "accumulate" else 0)
        if admission == "fifo":
            baseline = s["mean_sojourn"]
        print(
            f"{admission:<12}{s['mean_sojourn']:>12.4g}{s['p95_sojourn']:>12.4g}"
            f"{s['n_batches']:>9}{s['n_preemptions']:>10}"
            f"{'yes' if s['all_verified'] else 'NO':>10}"
        )
    print(
        f"\naccumulate-then-solve vs FIFO: every schedule oracle-verified; "
        f"FIFO mean sojourn is the {baseline:,.0f}-unit baseline the batching "
        f"policies beat above."
    )

    costs = DriveCosts(mount=args.mount_cost, unmount=args.unmount_cost,
                       load_seek=args.load_seek)
    print(
        f"\nshared drive pool (mount={costs.mount:,}, unmount="
        f"{costs.unmount:,}, load_seek={costs.load_seek:,}):"
    )
    print(f"{'admission':<22}{'drives':>7}{'mean':>12}{'p95':>12}"
          f"{'mounts':>8}{'unmounts':>9}")
    for admission in POOL_ADMISSIONS:
        for n_drives in (1, 2, n_tapes):
            s = run(admission, args.window, n_drives=n_drives, costs=costs)
            print(
                f"{admission:<22}{n_drives:>7}{s['mean_sojourn']:>12.4g}"
                f"{s['p95_sojourn']:>12.4g}{s['mounts']:>8}{s['unmounts']:>9}"
            )
    print(
        "\nfewer drives -> more mount contention; 'batched' schedules "
        "identically to per-drive-accumulate but plans each event tick in "
        "one bucketed solve_batch device launch."
    )

    budget = ComputeBudget(solve_time_num=10_000, per_tick=120, hysteresis=1)
    print(
        f"\nload-adaptive solver selection (priced solves: "
        f"{budget.solve_time_num:,} units/DP cell, cost-model budget "
        f"{budget.per_tick} cells/tick, cold re-solves):"
    )
    print(f"{'arm':<18}{'mean':>12}{'p95':>12}{'solve_delay':>13}"
          f"  policy_mix  (backend)")
    for label, policy, selector, arm_device in (
        ("dp (fixed)", "dp", "fixed", device),
        ("nfgs (fixed)", "nfgs", "fixed", dict(backend="python")),
        ("cost-model", "dp", "cost-model", dict(backend="python")),
    ):
        lib = demo_library(args.seed)
        report = serve_trace(
            lib, trace, "per-drive-accumulate", window=args.window,
            policy=policy, selector=selector, n_drives=2, drive_costs=costs,
            context=lib.context.replace(**arm_device, budget=budget),
            warm_start=False,
        )
        s = report.summary()
        mix = "+".join(f"{p}:{n}" for p, n in sorted(s["policy_mix"].items()))
        print(
            f"{label:<18}{s['mean_sojourn']:>12.4g}{s['p95_sojourn']:>12.4g}"
            f" {s['total_solve_delay']:>12,}  {mix}  ({arm_device['backend']})"
        )
    print(
        "\nthe selector spends exact-DP cells only where the cost model "
        "predicts they fit the per-tick budget; with --tape-selector unset "
        "(and everywhere above) serving is bit-identical to a pinned policy."
    )


if __name__ == "__main__":
    main()
