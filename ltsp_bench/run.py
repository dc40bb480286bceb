"""Run one cell of the benchmark once, on the CUDA cards of this machine.

Usage, from the root of a checkout::

    python3 ltsp_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is ``BENCHMARK.json``'s workload ``<name>``: its configuration,
its traffic mix (``ltsp_bench/traffic/``, run by the driver of its kind in
``ltsp_bench/drivers/``) and its metrics (``ltsp_bench/metrics/``).  The
run sets up (inputs from the configuration and the seed, every shape the
window uses built and warmed), measures for ``--seconds``, frees the
program's state and checks what the window produced against the plain
reference (``ltsp_bench/reference.py``).  Its last line on standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, the metrics
(end to end, or per layer with ``--trace 1``), the device and the numbers
compared with their limits.  The same numbers close standard error.

It drives ``repro_torch`` only.  Without enough CUDA cards, outside a
checkout, or if ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded once
the window has closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, backend: str,
             start: float) -> dict:
    """Set up, measure and check one run of ``cell``: the result's fields
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``checks``, and
    with ``trace`` the profile's ``breakdown``) and the device's readings."""
    import torch

    from ltsp_bench import cell as cells

    driver = cells.load_driver(cell.traffic["kind"])
    on_card = device.startswith("cuda")
    state = driver.setup(cell, device, backend)
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - start
    run = driver.window(state, seed, seconds, trace)
    run["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        stats = torch.cuda.memory_stats()
        print("allocator: " + ", ".join(f"{k} {stats.get(k)}" for k in (
            "num_device_alloc", "num_device_free", "num_alloc_retries",
            "reserved_bytes.all.peak")), file=sys.stderr)
    driver.release(state)
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = driver.check(state, run, seed, cell.traffic["check_extra"])
    run["check_s"] = time.perf_counter() - t_check
    print(f"set-up {setup_s:.3f} s, window {run['window_s']:.3f} s, check "
          f"{run['check_s']:.3f} s of {run.get('checked')}", file=sys.stderr)
    correct = run["failed"] == 0 and all(v <= lim for v, lim in checks.values())
    out = {
        "correct": bool(correct), "attempted": run["attempted"], "failed": run["failed"],
        "metrics": cells.read_metrics(cell, run, trace),
        "memory_peak_bytes": peak, "run": run,
        "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
    }
    if trace and run.get("profile"):
        prof = run["profile"]
        out["busy_s"], out["window_s"] = prof["busy_s"], prof["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    return out


def main(argv: list[str] | None = None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))
    if not (ROOT / "BENCHMARK.json").is_file() or not (ROOT / "src" / "repro_torch").is_dir():
        print(f"{ROOT} is not a checkout of the repository: no BENCHMARK.json or no "
              f"src/repro_torch", file=sys.stderr)
        return 2
    import torch

    from ltsp_bench import cell as cells

    cell = cells.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                   cell.config["backend"], START)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules that may not be loaded are: {loaded}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        if "busy_s" not in out:
            print("the traced run holds no profile", file=sys.stderr)
            return 4
        device["busy_s"], device["window_s"] = out["busy_s"], out["window_s"]
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": device}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
