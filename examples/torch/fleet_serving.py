"""Fleet federation: sharded serving, replica routing, and shard outages.

A seeded N-shard archive (:func:`~repro_torch.fleet.demo_fleet`) stores every
logical file on ``--replicas`` shards; one federation-wide arrival trace is
served under three placement strategies while a
:class:`~repro_torch.serving.ShardOutage` darkens a whole shard mid-run:

* **static-hash** — oblivious content-hash routing: keeps hashing requests
  into the dead shard, which strands every post-outage arrival whose other
  replica it ignores;
* **least-loaded** / **replica-affinity** — dynamic routing over live shard
  state (queue depth; depth x drive health x remount cost): both steer
  around the dark shard, and the outage's orphaned requests re-route to
  surviving replicas.

The demo then crashes a journaled federation run (truncating each shard's
write-ahead journal at an arbitrary byte) and shows
:func:`~repro_torch.fleet.recover_fleet` re-executing it bit-identically while
completing every shard journal — recovery works from any cut point.

Every shard solves on ``--backend`` (the CUDA kernels on the card by
default): the context passed to the fleet is handed to each shard's server.

Run: PYTHONPATH=src python examples/torch/fleet_serving.py
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from repro_torch.core import ExecutionContext
from repro_torch.fleet import (
    demo_fleet,
    fleet_catalog,
    merge_journals,
    recover_fleet,
    serve_fleet_trace,
    shard_journal_path,
)
from repro_torch.serving import DriveCosts, RetryPolicy, ShardOutage, poisson_trace

PLACEMENTS = ("static-hash", "least-loaded", "replica-affinity")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=180)
    ap.add_argument("--rate", type=int, default=30_000,
                    help="mean inter-arrival time (virtual units = bytes)")
    ap.add_argument("--window", type=int, default=400_000,
                    help="accumulate-then-solve hold window")
    ap.add_argument("--shards", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--drives", type=int, default=2,
                    help="drive-pool size per shard")
    ap.add_argument("--outage-at", type=int, default=1_500_000,
                    help="virtual instant the outage darkens a shard")
    ap.add_argument("--outage-shard", type=int, default=1)
    ap.add_argument("--seed", type=int, default=20260731)
    ap.add_argument("--backend", default="cuda",
                    help="solver backend: cuda (the CUDA kernels), torch, python")
    ap.add_argument("--device", default="cuda", help="torch device of cuda/torch")
    args = ap.parse_args()

    costs = DriveCosts(mount=150_000, unmount=60_000, load_seek=30_000)
    outages = (ShardOutage(at=args.outage_at, shard=args.outage_shard),)
    # float64 tables for the dispatches past the int32 device guard
    context = ExecutionContext(backend=args.backend, device=args.device,
                               numeric_policy="f64")

    def build_fleet():
        return demo_fleet(args.seed, n_shards=args.shards,
                          replicas=args.replicas)

    libs, rmap = build_fleet()
    trace = poisson_trace(
        fleet_catalog(libs, rmap), n_requests=args.requests,
        mean_interarrival=args.rate, seed=args.seed,
    )

    def run(placement, journal=None):
        libs, rmap = build_fleet()  # fresh shards: runs never share state
        return serve_fleet_trace(
            libs, trace, "accumulate", placement=placement,
            replica_map=rmap, outages=outages, window=args.window,
            n_drives=args.drives, drive_costs=costs,
            retry=RetryPolicy(on_exhausted="drop"), journal=journal,
            context=context,
        )

    print(
        f"{args.requests} requests over {args.shards} shards x "
        f"{args.drives} drives, {args.replicas}-way replicas; shard "
        f"{args.outage_shard} goes dark at t={args.outage_at:,}\n"
    )
    print(f"{'placement':<18}{'completed':>10}{'failed':>8}{'rerouted':>10}"
          f"{'p95 sojourn':>14}  routes")
    results = {}
    for pl in PLACEMENTS:
        fr = run(pl)
        results[pl] = fr
        s = fr.summary()
        routes = "/".join(str(fr.routes[i]) for i in range(args.shards))
        print(
            f"{pl:<18}{fr.n_served:>6}/{len(trace):<4}{fr.n_failed:>7}"
            f"{fr.n_rerouted:>10}{int(s['p95_sojourn']):>14,}  {routes}"
        )
    assert results["replica-affinity"].n_served > results["static-hash"].n_served, (
        "replica routing must complete strictly more than oblivious hashing "
        "under a shard outage"
    )
    assert results["replica-affinity"].n_rerouted > 0, (
        "the outage must have re-routed orphaned replicas cross-shard"
    )

    # -- crash a journaled federation mid-run, then recover it ---------------
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp) / "fleet.journal"
        full = run("replica-affinity", journal=str(base))
        ref = {
            i: Path(shard_journal_path(base, i)).read_bytes()
            for i in range(args.shards)
        }
        for i, data in ref.items():  # tear every shard at a different byte
            cut = len(data) * (i + 1) // (args.shards + 1)
            Path(shard_journal_path(base, i)).write_bytes(data[:cut])
        libs, rmap = build_fleet()
        recovered = recover_fleet(
            libs, trace, str(base), "accumulate",
            placement="replica-affinity", replica_map=rmap, outages=outages,
            window=args.window, n_drives=args.drives, drive_costs=costs,
            retry=RetryPolicy(on_exhausted="drop"), context=context,
        )
        assert [(r.req_id, r.completed) for r in recovered.merged.served] == \
               [(r.req_id, r.completed) for r in full.merged.served]
        assert all(
            Path(shard_journal_path(base, i)).read_bytes() == ref[i]
            for i in range(args.shards)
        ), "every shard journal completed byte-identically"
        stream = merge_journals(base, args.shards)
        print(
            f"\ncrash recovery: {args.shards} shard journals torn at "
            f"arbitrary bytes -> re-executed, cross-checked, and completed "
            f"byte-identically ({len(stream)} events in the merged stream)."
        )


if __name__ == "__main__":
    main()
