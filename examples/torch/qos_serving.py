"""QoS tape serving: deadlines, SLO reports, and recorded-trace replay.

Requests arrive with a per-request :class:`~repro_torch.serving.qos.QoSSpec`
(absolute deadline + priority class) drawn by the annotated trace generator
(``repro_torch.data.traces.qos_poisson_trace``: interactive requests get tight
deadlines, batch jobs sixteen times the slack).  The trace is written to a
JSONL file and read back — the round trip is bit-exact, and serving the
read-back trace reproduces the original run bit for bit — then served
through the deadline-blind baseline (``fifo-global``) and the
deadline-aware admissions (``edf-global``, ``slack-accumulate``).  The
per-class SLO table (exact nearest-rank p50/p99 sojourn, deadline-miss
rate, max lateness) comes from :func:`repro_torch.serving.qos.slo_report`; every
emitted schedule still passes the discrete-event simulator oracle.  Every
solve runs on ``--backend``: the CUDA kernels on the card by default.

Run: PYTHONPATH=src python examples/torch/qos_serving.py
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from repro_torch.data.traces import qos_poisson_trace, read_trace, to_requests, write_trace
from repro_torch.serving import MOUNT_SCHEDULERS, demo_library, serve_trace, slo_report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=240)
    ap.add_argument("--rate", type=int, default=250_000,
                    help="mean inter-arrival time (virtual units = bytes)")
    ap.add_argument("--window", type=int, default=400_000,
                    help="accumulate-then-solve hold window")
    ap.add_argument("--tightness", type=int, default=8_000_000,
                    help="deadline = arrival + tightness * class slack mult")
    ap.add_argument("--policy", default="dp")
    ap.add_argument("--backend", default="cuda",
                    help="solver backend: cuda (the CUDA kernels), torch, python")
    ap.add_argument("--device", default="cuda", help="torch device of cuda/torch")
    ap.add_argument("--scheduler", default="greedy",
                    choices=sorted(MOUNT_SCHEDULERS))
    ap.add_argument("--seed", type=int, default=20260731)
    args = ap.parse_args()

    records = qos_poisson_trace(
        demo_library(args.seed),
        n_requests=args.requests,
        mean_interarrival=args.rate,
        seed=args.seed,
        tightness=args.tightness,
    )

    # recorded-trace round trip: write -> read is bit-exact
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.jsonl"
        write_trace(path, records)
        replayed = read_trace(path)
        assert replayed == records, "JSONL trace round-trip must be bit-exact"
        print(f"trace round-trip OK: {len(records)} records through {path.name}")

    trace, qos = to_requests(records, demo_library(args.seed))
    n_deadlines = sum(1 for s in qos.values() if s.deadline is not None)
    print(
        f"{len(trace)} requests ({n_deadlines} with deadlines, tightness "
        f"{args.tightness:,}), {len({r.tape_id for r in trace})} cartridges, "
        f"solver {args.policy}/{args.backend}, scheduler {args.scheduler}\n"
    )

    def run(admission, window):
        lib = demo_library(args.seed)
        return serve_trace(
            lib,
            trace,
            admission,
            window=window,
            policy=args.policy,
            qos=qos,
            mount_scheduler=args.scheduler,
            # float64 tables for the dispatches past the int32 device guard
            context=lib.context.replace(backend=args.backend, device=args.device,
                                        numeric_policy="f64"),
        )

    sweep = [
        ("fifo-global", 0),  # deadline-blind baseline
        ("edf-global", 0),
        ("per-drive-accumulate", args.window),
        ("slack-accumulate", args.window),
    ]
    print(f"{'admission':<22}{'missed':>10}{'miss_rate':>11}"
          f"{'p50':>12}{'p99':>14}")
    missed = {}
    for admission, window in sweep:
        report = run(admission, window)
        slo = slo_report(report)
        missed[admission] = report.n_missed
        print(
            f"{admission:<22}{report.n_missed:>7}/{report.n_deadlines:<4}"
            f"{slo.miss_rate:>9.3f}{slo.overall.p50_sojourn:>12,}"
            f"{slo.overall.p99_sojourn:>14,}"
        )
    assert missed["edf-global"] < missed["fifo-global"]
    assert missed["slack-accumulate"] < missed["fifo-global"]

    report = run("slack-accumulate", args.window)
    slo = slo_report(report)
    print("\nslack-accumulate per-class SLO (exact ints):")
    print(f"{'class':<14}{'n':>5}{'missed':>8}{'miss_rate':>11}"
          f"{'p50':>12}{'p99':>14}{'max_late':>12}")
    for c in slo.classes:
        print(
            f"{c.qos_class:<14}{c.n:>5}{c.n_missed:>8}{c.miss_rate:>11.3f}"
            f"{c.p50_sojourn:>12,}{c.p99_sojourn:>14,}{c.max_lateness:>12,}"
        )
    print(
        "\ndeadline-aware admissions beat the deadline-blind baseline at "
        "this tightness; every schedule passed the simulator oracle."
    )


if __name__ == "__main__":
    main()
