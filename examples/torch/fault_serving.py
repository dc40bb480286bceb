"""Fault-tolerant tape serving: failover, retries, and crash recovery.

A seeded :class:`~repro_torch.serving.faults.FaultPlan` injects a drive
hard-failure mid-batch, transient mount failures, a bad media span, and a
transient solver fault into the online serving loop — all at exact
virtual-time instants, so every run is bit-deterministic.  The demo
contrasts three retry policies on the same faulted trace:

* the **no-fault baseline** (serving without the fault layer, bit-identical);
* **fail-stop** (:data:`~repro_torch.serving.drives.FAIL_STOP`): aborted and
  unservable requests drop as typed ``FailedRequest`` rows;
* **retry + failover** (:class:`~repro_torch.serving.drives.RetryPolicy`):
  mounts retry with exponential backoff charged in virtual time, media
  aborts re-read, the solver degrades through its backend chain, and the
  failed drive's work remounts on surviving capacity — everything
  completes.

It then crashes a journaled run mid-file (truncating the write-ahead event
journal at an arbitrary byte) and shows :func:`~repro_torch.serving.recover_server`
resuming it bit-identically while completing the journal.

Every solve runs on ``--backend`` (the CUDA kernels on the card by default),
and the plan's solver fault targets that backend.

Run: PYTHONPATH=src python examples/torch/fault_serving.py
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from repro_torch.serving import (
    FAIL_STOP,
    DriveCosts,
    EventJournal,
    RetryPolicy,
    demo_library,
    poisson_trace,
    recover_server,
    seeded_fault_plan,
    serve_trace,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=120)
    ap.add_argument("--rate", type=int, default=150_000,
                    help="mean inter-arrival time (virtual units = bytes)")
    ap.add_argument("--window", type=int, default=400_000,
                    help="accumulate-then-solve hold window")
    ap.add_argument("--drives", type=int, default=3)
    ap.add_argument("--seed", type=int, default=20260731)
    ap.add_argument("--fault-seed", type=int, default=3)
    ap.add_argument("--backend", default="cuda",
                    help="solver backend: cuda (the CUDA kernels), torch, python")
    ap.add_argument("--device", default="cuda", help="torch device of cuda/torch")
    args = ap.parse_args()

    costs = DriveCosts(mount=150_000, unmount=60_000, load_seek=30_000)

    def build_trace():
        return poisson_trace(
            demo_library(args.seed), n_requests=args.requests,
            mean_interarrival=args.rate, seed=args.seed,
        )

    def context(lib):
        # float64 tables for the dispatches past the int32 device guard
        return lib.context.replace(backend=args.backend, device=args.device,
                                   numeric_policy="f64")

    def run(faults=None, retry=None, journal=None):
        lib = demo_library(args.seed)
        return serve_trace(
            lib, build_trace(), "per-drive-accumulate", window=args.window,
            n_drives=args.drives, drive_costs=costs, context=context(lib),
            faults=faults, retry=retry, journal=journal,
        )

    plan = seeded_fault_plan(
        demo_library(args.seed), build_trace(), seed=args.fault_seed,
        n_drives=args.drives, backend=args.backend,
    )
    print(
        f"{args.requests} requests over {args.drives} drives; seeded fault "
        f"plan: {len(plan.drive_failures)} drive failure(s), "
        f"{len(plan.mount_faults)} mount fault(s), "
        f"{len(plan.media_faults)} media fault(s), "
        f"{len(plan.solver_faults)} solver fault(s)\n"
    )

    baseline = run()
    arms = [
        ("no faults", baseline),
        ("fail-stop", run(faults=plan, retry=FAIL_STOP)),
        ("retry+failover", run(faults=plan, retry=RetryPolicy(on_exhausted="drop"))),
    ]
    print(f"{'policy':<16}{'completed':>10}{'failed':>8}{'requeued':>10}"
          f"{'retries':>9}{'p95 sojourn':>14}")
    for name, report in arms:
        s = report.summary()
        f = report.fault_stats or {}
        print(
            f"{name:<16}{report.n_served:>6}/{len(build_trace()):<4}"
            f"{report.n_failed:>7}{f.get('requeued', 0):>10}"
            f"{f.get('mount_retries', 0):>9}{s['p95_sojourn']:>14,}"
        )
    failstop, failover = arms[1][1], arms[2][1]
    assert failover.n_served > failstop.n_served, (
        "retry+failover must complete strictly more than fail-stop"
    )
    assert failover.n_served == args.requests, "failover completes everything"

    # -- crash a journaled run mid-file, then recover it --------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "journal.jsonl"
        full = run(faults=plan, retry=RetryPolicy(on_exhausted="drop"),
                   journal=str(path))
        data = path.read_bytes()
        cut = len(data) * 2 // 3  # tear mid-line, mid-run
        path.write_bytes(data[:cut])
        n_events = len(EventJournal.load(path))
        lib = demo_library(args.seed)
        recovered = recover_server(
            lib, build_trace(), str(path), admission="per-drive-accumulate",
            window=args.window, n_drives=args.drives, drive_costs=costs,
            context=context(lib), faults=plan,
            retry=RetryPolicy(on_exhausted="drop"),
        )
        assert [(r.req_id, r.completed) for r in recovered.served] == \
               [(r.req_id, r.completed) for r in full.served]
        assert path.read_bytes() == data, "journal completed byte-identically"
        print(
            f"\ncrash recovery: journal torn at byte {cut}/{len(data)} "
            f"({n_events} intact events) -> re-executed, cross-checked, and "
            f"completed; report bit-identical to the uninterrupted run."
        )


if __name__ == "__main__":
    main()
