"""Resolve a cell of ``BENCHMARK.json`` to the files that define it.

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own, found by name: the configuration at the ``file``
its entry gives, the traffic mix at ``ltsp_bench/traffic/<traffic>.json``,
each metric's reader at ``ltsp_bench/metrics/<name>.py``.  A traffic mix
names its ``kind``, the driver in ``ltsp_bench/drivers/<kind>.py`` that
runs it.  A later cell, mix or metric is added as new files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

#: the checkout's root: BENCHMARK.json and ``src/`` live here
ROOT = Path(__file__).resolve().parents[1]
#: the benchmark's folder, relative to a root
FOLDER = "ltsp_bench"


@dataclasses.dataclass
class Cell:
    """One workload of the benchmark with its configuration, its traffic
    mix and the metrics it reports, end to end and per layer."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    readers: dict


def load_reader(path: Path):
    """The ``read(run)`` function of a metric's reader file."""
    spec = importlib.util.spec_from_file_location(
        f"ltsp_bench_metric_{path.stem.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _find(root: Path, rel: str) -> Path:
    """``root / rel``, or the checkout's own where ``root`` lacks it (a tree
    of added files resolves beside the benchmark's)."""
    path = root / rel
    return path if path.is_file() else ROOT / rel


def _for_cell(metrics: list[dict], workload: str) -> list[dict]:
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def resolve(workload: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The :class:`Cell` named ``workload`` in ``root``'s ``BENCHMARK.json``
    (or in ``bench``, with files under ``root``)."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads(_find(root, configs[w["config"]]["file"]).read_text())
    traffic = json.loads(_find(root, f"{FOLDER}/traffic/{w['traffic']}.json").read_text())
    e2e = _for_cell(bench["end_to_end"], workload)
    per_layer = _for_cell(bench["per_layer"], workload)
    readers = {m["name"]: load_reader(_find(root, f"{FOLDER}/metrics/{m['name']}.py"))
               for m in e2e + per_layer}
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer, readers)


def read_metrics(cell: Cell, run: dict, trace: bool) -> dict:
    """``{name: {"value", "unit"}}`` of the metrics a run reports: the
    cell's end-to-end metrics, or with ``trace`` its per-layer ones.  A
    reader that finds nothing to read returns ``None`` and its metric is
    left out."""
    out = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.readers[m["name"]](run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def load_driver(kind: str, root: Path = ROOT):
    """The driver module that runs traffic of ``kind``."""
    path = _find(root, f"{FOLDER}/drivers/{kind}.py")
    spec = importlib.util.spec_from_file_location(f"ltsp_bench_driver_{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
