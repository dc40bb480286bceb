#!/usr/bin/env python3
"""Dry run of ``chip_smoke.py``'s phase 7 on the CPU: which dispatches the
IN2P3-scale trace produces, without solving a dense table.

It builds phase 7's library (:func:`chip_smoke.in2p3_library`) and trace and
serves it on the ``python`` backend under a cheap policy (``nfgs`` by
default; its schedules, and so the dispatch times, come close to ``dp``'s),
then prints the (R_pad, S_pad) histogram of the dispatches, their n_req and
n ranges against the paper's Table 1, and the bytes of the dense f64 ``T``
and int32 ``C`` planes that the ``cuda`` backend's capture branch would copy
to the host.  The trace and server options default to phase 7's and can be
changed to tune them.

Usage, from the root of a checkout (about two seconds)::

    python3 tools/serving_dry_run.py [--requests N] [--interarrival T]
        [--window W] [--drives D] [--policy nfgs]
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


def main() -> int:
    trace_kw, serve_kw = chip_smoke.IN2P3_TRACE, chip_smoke.IN2P3_SERVE
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--requests", type=int, default=trace_kw["n_requests"])
    parser.add_argument("--interarrival", type=int, default=trace_kw["mean_interarrival"])
    parser.add_argument("--window", type=int, default=serve_kw["window"])
    parser.add_argument("--drives", type=int, default=serve_kw["n_drives"])
    parser.add_argument("--policy", default="nfgs")
    args = parser.parse_args()

    from repro_torch.core import ExecutionContext
    from repro_torch.data import PAPER_PROFILE, generate_dataset, u_turn_values
    from repro_torch.serving import poisson_trace, serve_trace

    u_turn = u_turn_values(generate_dataset(PAPER_PROFILE))["half_seg"]
    paper = generate_dataset(PAPER_PROFILE, u_turn=u_turn)
    lib, tapes = chip_smoke.in2p3_library(paper, u_turn, ExecutionContext())
    trace = poisson_trace(lib, **dict(trace_kw, n_requests=args.requests,
                                      mean_interarrival=args.interarrival))
    serve = dict(chip_smoke.in2p3_serve(), window=args.window, n_drives=args.drives)
    report = serve_trace(lib, trace, "accumulate", policy=args.policy, context=lib.context,
                         verify=False, warm_start=False, **serve)

    def pad(v: int, lo: int) -> int:
        return max(lo, 1 << (v - 1).bit_length())

    shapes = [(pad(b.n_files, 1), pad(b.n_requests + 1, 128)) for b in report.batches]
    r_pads = sorted(r for r, _ in shapes)
    (nreq_lo, nreq_hi), (n_lo, n_hi) = chip_smoke.PAPER_NREQ, chip_smoke.PAPER_N
    inside = sum(nreq_lo <= b.n_files <= nreq_hi and n_lo <= b.n_requests <= n_hi
                 for b in report.batches)
    print(f"paper tapes {tapes}; {args.requests} requests, mean inter-arrival "
          f"{args.interarrival}, window {args.window}, {args.drives} drives, policy {args.policy}")
    print(f"{len(shapes)} dispatches, (R_pad, S_pad) histogram "
          f"{sorted(collections.Counter(shapes).items())}")
    print(f"median R_pad {r_pads[len(r_pads) // 2]}, {r_pads.count(256)} at R_pad 256; n_req "
          f"{min(b.n_files for b in report.batches)}-{max(b.n_files for b in report.batches)}, "
          f"n {min(b.n_requests for b in report.batches)}-"
          f"{max(b.n_requests for b in report.batches)}; {inside} of {len(shapes)} inside "
          f"Table 1's ranges")
    print(f"capture planes (f64 T + int32 C): {sum(r * r * s * 12 for r, s in shapes) / 1e9:.1f} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
