"""Observability: virtual-time tracing, exact-int metrics, and exporters.

One seeded constrained-pool serving run (``--requests`` requests, 3 shared
drives under a nonzero mount cost model) executes twice — once bare, once
with the opt-in :class:`~repro_torch.obs.Observability` bundle attached to the
:class:`~repro_torch.core.ExecutionContext` — and the demo proves the three
properties the layer is built on:

* **no-op identity** — the instrumented run's served timeline is
  bit-identical to the bare run's: hooks only *read* already-computed
  exact integers, so attaching a tracer/registry never perturbs a
  schedule, a virtual clock, or a journal byte;
* **exact agreement** — the Prometheus counters reconcile with the
  :class:`~repro_torch.serving.sim.ServiceReport` exactly (served requests,
  batches, solve-cache hits/misses, DP cells): same integers, no sampling,
  no estimation;
* **byte determinism** — two identical seeded runs export byte-identical
  JSONL span logs (spans are keyed by exact virtual time; wall clocks are
  opt-in and off here).

The run's artefacts land in ``--out-dir``: the JSONL span log, a
Prometheus text snapshot, and a Chrome ``trace_event`` file (one thread
lane per drive plus the queue lane — load it in Perfetto / chrome://tracing
to scrub through mounts, solve delays, and batch service on the virtual
clock).

Both runs solve on ``--backend`` (the CUDA kernels on the card by default).

Run: PYTHONPATH=src python examples/torch/observability.py
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.obs import (
    Observability,
    chrome_trace,
    prometheus_text,
    spans_jsonl,
    write_chrome_trace,
    write_prometheus,
    write_spans_jsonl,
)
from repro_torch.serving import DriveCosts, demo_library, poisson_trace, serve_trace


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=240)
    ap.add_argument("--rate", type=int, default=250_000,
                    help="mean inter-arrival time (virtual units = bytes)")
    ap.add_argument("--window", type=int, default=400_000,
                    help="accumulate-then-solve hold window")
    ap.add_argument("--drives", type=int, default=3,
                    help="shared drive-pool size")
    ap.add_argument("--seed", type=int, default=20260731)
    ap.add_argument("--backend", default="cuda",
                    help="solver backend: cuda (the CUDA kernels), torch, python")
    ap.add_argument("--device", default="cuda", help="torch device of cuda/torch")
    ap.add_argument("--out-dir", default="results/obs",
                    help="where the span log / metrics / Chrome trace land")
    args = ap.parse_args()

    costs = DriveCosts(mount=150_000, unmount=60_000, load_seek=30_000)
    trace = poisson_trace(
        demo_library(args.seed), n_requests=args.requests,
        mean_interarrival=args.rate, seed=args.seed,
    )

    def run(obs=None):
        lib = demo_library(args.seed)  # fresh library: runs never share state
        # float64 tables for the dispatches past the int32 device guard
        ctx = lib.context.replace(backend=args.backend, device=args.device,
                                  numeric_policy="f64", obs=obs)
        return serve_trace(
            lib, trace, "accumulate", window=args.window,
            n_drives=args.drives, drive_costs=costs, context=ctx,
        )

    def timeline(report):
        return [
            (r.req_id, r.arrival, r.dispatched, r.completed)
            for r in report.served
        ]

    bare = run()
    obs = Observability.enabled()
    report = run(obs)
    s = report.summary()

    # -- no-op identity: instrumentation never perturbs the run --------------
    assert timeline(report) == timeline(bare), (
        "attaching observability changed the served timeline"
    )

    # -- exact agreement: registry counters == report integers ---------------
    m = obs.metrics
    checks = {
        "requests_served_total": report.n_served,
        "batches_total": s["n_batches"],
        "cache_hits_total": s["cache"]["hits"],
        "cache_misses_total": s["cache"]["misses"],
        "cells_evaluated_total": s["cells_evaluated"],
    }
    for name, want in checks.items():
        got = sum(v for _, v in m.counters_named(name))
        assert got == want, f"{name}: counter {got} != report {want}"

    # -- byte determinism: same seed, same bytes ------------------------------
    obs2 = Observability.enabled()
    run(obs2)
    assert spans_jsonl(obs.tracer) == spans_jsonl(obs2.tracer), (
        "two identical seeded runs must export byte-identical span logs"
    )

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = write_spans_jsonl(obs.tracer, out / "spans.jsonl")
    write_prometheus(m, out / "metrics.prom")
    write_chrome_trace(obs.tracer, out / "trace.chrome.json")

    tracks = sorted({sp.track for sp in obs.tracer.spans})
    print(
        f"{args.requests} requests on {args.drives} shared drives: "
        f"{s['n_batches']} batches, {s['mounts']} mounts, mean sojourn "
        f"{s['mean_sojourn']:.4g}\n"
        f"instrumented run is bit-identical to the bare run; "
        f"{len(checks)} counters reconcile exactly with the report\n"
        f"{n} spans (tracks: {', '.join(tracks)}) -> {out / 'spans.jsonl'}\n"
        f"Chrome trace -> {out / 'trace.chrome.json'} "
        f"({len(chrome_trace(obs.tracer)['traceEvents'])} events; open in "
        f"Perfetto)\nPrometheus snapshot -> {out / 'metrics.prom'}"
    )
    sojourn_lines = [
        ln for ln in prometheus_text(m).splitlines() if ln.startswith("sojourn")
    ]
    print("\nsojourn distribution (exact nearest-rank, virtual time):")
    for ln in sojourn_lines:
        print(f"  {ln}")
    # the JSONL log round-trips: every line is one span, sorted keys
    first = json.loads((out / "spans.jsonl").read_text().splitlines()[0])
    print(f"\nfirst span: {first}")


if __name__ == "__main__":
    main()
