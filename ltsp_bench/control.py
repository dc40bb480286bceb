"""The control of the comparison that decides ``correct``, at a cell's size.

The control is the reference put in the program's place and computed one
precision below the configuration's float64: float32.  For each seed it
draws the sample a run of the cell would check, answers it with the float32
reference, and hands those answers to the driver's own check, which holds
them to the float64 reference as a run's are held.  Every seed has to read
a gap over the limit.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python3 ltsp_bench/control.py --workload <name> --seeds <n> [<n> ...]

It prints one line per seed and a last line ``{"workload", "readings",
"limits", "all_fail"}``.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(cell, driver, seed: int, device: str) -> dict:
    """The control's numbers on the sample a run of ``cell`` with ``seed``
    would check (every tape solved), through the driver's own check."""
    import torch

    policy = cell.config["policy"]
    tapes = dict(driver.tape_set(cell.config))
    state = {"tapes": tapes, "policy": policy, "device": device}
    run = {"results": {i: None for i in tapes}}
    for i in driver.sample(state, run, seed, cell.traffic["check_extra"]):
        run["results"][i] = [driver.reference_answer(tapes[i], policy, torch.float32, device)]
    checks = driver.check(state, run, seed, cell.traffic["check_extra"])
    return {**{k: v for k, (v, _) in checks.items()}, **run["checked"]["gaps"]}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))
    import torch

    from ltsp_bench import cell as cells

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = cells.resolve(args.workload)
    driver = cells.load_driver(cell.traffic["kind"])
    readings = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        gaps = control_readings(cell, driver, seed, "cuda:0")
        readings.append({"seed": seed, **gaps})
        print(f"seed {seed}: {gaps} ({time.perf_counter() - t0:.1f} s)", flush=True)
    limits = dict(driver.LIMITS)
    all_fail = all(any(r[k] > lim for k, lim in limits.items()) for r in readings)
    print(json.dumps({"workload": args.workload, "readings": readings, "limits": limits,
                      "all_fail": all_fail}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
