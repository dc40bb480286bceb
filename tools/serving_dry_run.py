#!/usr/bin/env python3
"""Dry run of ``chip_smoke.py``'s phase 7 (or, with ``--fleet``, phase 8b, and
with ``--fleet --spread`` phase 8c) on the CPU: which dispatches the
IN2P3-scale trace produces, without solving a dense table.

It builds the phase's library (:func:`chip_smoke.in2p3_library`) or
federation (:func:`chip_smoke.in2p3_fleet`, three shards, every cartridge on
two of them, shard 0 dark from the trace's median arrival on) and trace, and
serves it on the ``python`` backend under a cheap policy (``nfgs`` by
default; its schedules, and so the dispatch times, come close to ``dp``'s),
then prints the (R_pad, S_pad) histogram of the dispatches (per shard for the
federation), their n_req and n ranges against the paper's Table 1, the
dispatches before and after the outage, the batches it found in flight, the
requests it re-routed, and the bytes of the dense f64 ``T`` and int32
``C`` planes that the ``cuda`` backend's capture branch would copy to the
host.  The trace and server options default to the phase's and can be
changed to tune them.

Usage, from the root of a checkout (seconds)::

    python3 tools/serving_dry_run.py [--fleet [--spread]] [--requests N]
        [--interarrival T] [--window W] [--drives D] [--policy nfgs]
"""

from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def pad(v: int, lo: int) -> int:
    return max(lo, 1 << (v - 1).bit_length())


def describe(label: str, batches, outage_at: int | None = None) -> None:
    """Print the dispatch histogram, the Table 1 check and the capture bytes,
    and with ``outage_at`` the dispatches before and after it."""
    if not batches:
        print(f"{label}: no dispatch")
        return
    if outage_at is not None:
        before = sum(b.dispatched < outage_at for b in batches)
        in_flight = sum(b.aborted_by == "drive-failure" for b in batches)
        print(f"{label}: {before} dispatches before the outage, {len(batches) - before} "
              f"after, {in_flight} in flight when it struck")
    shapes = [(pad(b.n_files, 1), pad(b.n_requests + 1, 128)) for b in batches]
    r_pads = sorted(r for r, _ in shapes)
    (nreq_lo, nreq_hi), (n_lo, n_hi) = chip_smoke.PAPER_NREQ, chip_smoke.PAPER_N
    inside = sum(nreq_lo <= b.n_files <= nreq_hi and n_lo <= b.n_requests <= n_hi
                 for b in batches)
    print(f"{label}: {len(shapes)} dispatches, (R_pad, S_pad) histogram "
          f"{sorted(collections.Counter(shapes).items())}")
    print(f"{label}: median R_pad {r_pads[len(r_pads) // 2]}, {r_pads.count(256)} at R_pad 256; "
          f"n_req {min(b.n_files for b in batches)}-{max(b.n_files for b in batches)}, "
          f"n {min(b.n_requests for b in batches)}-{max(b.n_requests for b in batches)}; "
          f"{inside} of {len(shapes)} inside Table 1's ranges")
    print(f"{label}: capture planes (f64 T + int32 C): "
          f"{sum(r * r * s * 12 for r, s in shapes) / 1e9:.1f} GB")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--fleet", action="store_true",
                        help="phase 8b's federation instead of phase 7's library")
    parser.add_argument("--spread", action="store_true",
                        help="with --fleet: phase 8c's trace, three windows long")
    parser.add_argument("--requests", type=int, default=None)
    parser.add_argument("--interarrival", type=int, default=None)
    parser.add_argument("--window", type=int, default=chip_smoke.IN2P3_SERVE["window"])
    parser.add_argument("--drives", type=int, default=chip_smoke.IN2P3_SERVE["n_drives"])
    parser.add_argument("--policy", default="nfgs")
    args = parser.parse_args()

    from repro_torch.core import ExecutionContext
    from repro_torch.data import PAPER_PROFILE, generate_dataset, u_turn_values
    from repro_torch.fleet import serve_fleet_trace
    from repro_torch.serving import RetryPolicy, poisson_trace, serve_trace

    if args.fleet:
        trace_kw = chip_smoke.FLEET_SPREAD_TRACE if args.spread else chip_smoke.FLEET_TRACE
    else:
        trace_kw = chip_smoke.IN2P3_TRACE
    changes = {k: v for k, v in (("n_requests", args.requests),
                                 ("mean_interarrival", args.interarrival)) if v is not None}
    serve = dict(chip_smoke.in2p3_serve(), window=args.window, n_drives=args.drives)
    u_turn = u_turn_values(generate_dataset(PAPER_PROFILE))["half_seg"]
    paper = generate_dataset(PAPER_PROFILE, u_turn=u_turn)
    if args.fleet:
        libs, rmap, tapes = chip_smoke.in2p3_fleet(paper, u_turn)
        trace, outages = chip_smoke.fleet_trace_and_outage(libs, rmap,
                                                           dict(trace_kw, **changes))
        fr = serve_fleet_trace(libs, trace, "accumulate", placement="replica-affinity",
                               replica_map=rmap, outages=outages, policy=args.policy,
                               context=ExecutionContext(), verify=False, warm_start=False,
                               retry=RetryPolicy(on_exhausted="drop"), **serve)
        reports = list(fr.shards)
        extra = (f"; shard 0 dark at {outages[0].at}: {fr.n_rerouted} requests re-routed, "
                 f"{fr.n_served} served, {fr.n_failed} failed, routes {fr.routes}")
    else:
        lib, tapes = chip_smoke.in2p3_library(paper, u_turn, ExecutionContext())
        trace = poisson_trace(lib, **dict(trace_kw, **changes))
        reports = [serve_trace(lib, trace, "accumulate", policy=args.policy, context=lib.context,
                               verify=False, warm_start=False, **serve)]
        extra = ""
    trace_kw = dict(trace_kw, **changes)
    print(f"paper tapes {tapes}; {trace_kw['n_requests']} requests, mean inter-arrival "
          f"{trace_kw['mean_interarrival']}, window {args.window}, {args.drives} drives, "
          f"policy {args.policy}{extra}")
    if args.fleet:
        for shard, report in enumerate(reports):
            describe(f"shard {shard}", report.batches, outages[0].at)
    describe("in all", [b for r in reports for b in r.batches])
    return 0


if __name__ == "__main__":
    sys.exit(main())
