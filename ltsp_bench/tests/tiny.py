"""Tiny cells for the CPU tests: the configurations' shapes at a size the
plain version solves in milliseconds."""

import copy
import json

from ltsp_bench import cell as cells
from ltsp_bench import tapes as tapegen

#: a small paper-like profile: 12 tapes of at most 20 requested files
TINY_PROFILE = dict(n_tapes=12, nf_median=40.0, nf_clip=[16, 80], n_req_cap=20, mult_cap=20)


def tiny_config(config: str | dict = "in2p3-dp", max_r_pad: int = 16) -> dict:
    """``config`` (a configuration, or the name of one under ``configs/``) on
    the tiny profile, serving the tapes that pad to at most ``max_r_pad``
    windows."""
    if isinstance(config, str):
        config = json.loads((cells.ROOT / cells.FOLDER / "configs" / f"{config}.json")
                            .read_text())
    cfg = copy.deepcopy(config)
    ds = cfg["dataset"]
    ds["profile"].update(TINY_PROFILE)
    tapes = tapegen.generate_tapes(ds["profile"], ds["base_seed"], ds["u_turn"])
    cfg["max_r_pad"] = max_r_pad
    cfg["tapes_served"] = sum(tapegen.pow2(len(t["left"])) <= max_r_pad for t in tapes)
    return cfg


def tiny_cell(workload: str):
    """The workload of ``BENCHMARK.json`` with a tiny configuration."""
    cell = cells.resolve(workload)
    cell.config = tiny_config(cell.config)
    cell.traffic.update(check_extra=2)
    return cell


def run_tiny(cell, seed: int = 2**31 + 11, seconds: float = 0.5, trace: bool = False):
    import time

    from ltsp_bench.run import run_cell

    return run_cell(cell, seed, seconds, trace, "cpu", "torch", time.perf_counter())
