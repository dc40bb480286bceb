#!/usr/bin/env python3
"""What arming the host-clock spans of the solve path costs, and where a
mount's host time goes.

It sets a benchmark cell up as ``ltsp_bench/run.py`` does and runs the
mounts driver's own window, ``--windows`` times unarmed and as many armed
through ``HOST_SPANS.recording()``, alternating (off, on, on, off, ...),
each ``--seconds`` long; then one traced window, whose second pass runs
under ``torch.profiler`` as a ``--trace 1`` run's does.  The last line is
one JSON object: each window's tapes/s, the armed cost in ms a pass and
us a mount (each tape's median solve time armed less unarmed, the mean
over the tapes), the ms a mount in each span
(``ltsp_bench.host_spans.split``) of the last armed window and of the
traced pass with ``host_ms_per_tape``'s reading, and the traced pass's
window, busy time and idle gaps.

Usage, from the root of a checkout, on a machine with a card::

    python3 tools/host_span_cost.py --workload in2p3-dp.mounts [--windows 3] [--seconds 10]

``--tiny`` runs the cell's tiny configuration on the CPU's plain version,
to rehearse.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="in2p3-dp.mounts")
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=2**31 + 7)
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args()

    from ltsp_bench import cell as cells
    from ltsp_bench.host_spans import mounts_of, split, traced_mounts
    from ltsp_bench.metrics.host_ms_per_tape import read as host_ms_per_tape
    from repro_torch.obs.trace import HOST_SPANS

    if args.tiny:
        from ltsp_bench.tests.tiny import tiny_cell

        cell, device, backend = tiny_cell(args.workload), "cpu", "torch"
    else:
        cell, device = cells.resolve(args.workload), "cuda:0"
        backend = cell.config["backend"]
    driver = cells.load_driver(cell.traffic["kind"])
    state = driver.setup(cell, device, backend)
    mounts = len(state["insts"])

    rates: dict[str, list[float]] = {"off": [], "on": []}
    seconds: dict[str, dict] = {"off": collections.defaultdict(list),
                                "on": collections.defaultdict(list)}
    for k in range(2 * args.windows):
        mode = ("off", "on")[(k + 1) // 2 % 2]
        if mode == "on":
            with HOST_SPANS.recording():
                run = driver.window(state, args.seed + k, args.seconds, False)
            armed = split(mounts_of(run["solves"]))
        else:
            run = driver.window(state, args.seed + k, args.seconds, False)
        rates[mode].append(run["attempted"] / run["window_s"])
        for s in run["solves"]:
            seconds[mode][s["tape"]].append(s["seconds"])
    # paired by tape: a window cuts its last pass, so the mix of tapes in
    # two windows differs
    both = seconds["on"].keys() & seconds["off"].keys()
    cost_s = statistics.mean(statistics.median(seconds["on"][t]) - statistics.median(
        seconds["off"][t]) for t in both)

    traced = driver.window(state, args.seed + 2 * args.windows, 0.1, True)
    prof = traced["profile"]
    print(json.dumps({
        "workload": args.workload, "mounts": mounts, "tapes_per_s": rates,
        "armed_cost_ms_a_pass": cost_s * mounts * 1e3, "armed_cost_us_a_mount": cost_s * 1e6,
        "split_armed": armed, "split_traced": split(traced_mounts(traced)),
        "host_ms_per_tape_traced": host_ms_per_tape(traced),
        "traced_window_s": prof["window_s"], "traced_busy_s": prof["busy_s"],
        "idle_gaps": prof["idle_gaps"], "dropped": HOST_SPANS.dropped,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
