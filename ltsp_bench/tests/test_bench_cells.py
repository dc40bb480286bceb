"""Cells resolve from files found by name, so a later configuration,
traffic mix or metric is added as new files; and ``BENCHMARK.json`` keeps
to the benchmark's contract."""

import json
import re
import subprocess
import sys

import pytest

from ltsp_bench import cell as cells

from .tiny import run_tiny, tiny_cell, tiny_config

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ltsp_bench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("ltsp_bench/") and (cells.ROOT / c["file"]).is_file()
        assert json.loads((cells.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in names
        cell = cells.resolve(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    cell = cells.resolve(workload)
    assert cell.traffic["kind"] == "mounts"
    assert set(cell.readers) == {m["name"] for m in cell.end_to_end + cell.per_layer}


def test_a_cell_added_as_new_files_runs(tmp_path):
    """A throwaway configuration, traffic mix and metric, each a new file
    under a root of their own, resolve and run at a tiny size."""
    folder = tmp_path / cells.FOLDER
    for sub in ("configs", "traffic", "metrics"):
        (folder / sub).mkdir(parents=True)
    cfg = tiny_config("in2p3-logdp1")
    cfg["name"] = "throwaway"
    (folder / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    traffic = json.loads((cells.ROOT / cells.FOLDER / "traffic" / "mounts.json").read_text())
    traffic["check_extra"] = 1
    (folder / "traffic" / "throwaway-mounts.json").write_text(json.dumps(traffic))
    (folder / "metrics" / "mounts_seen.py").write_text(
        "def read(run):\n    return float(len(run['solves']))\n")
    bench = {
        "configs": [{"name": "throwaway", "source": "test", "reduced": [],
                     "file": f"{cells.FOLDER}/configs/throwaway.json", "why": "test"}],
        "workloads": [{"name": "throwaway.mounts", "config": "throwaway",
                       "traffic": "throwaway-mounts", "chips": 1, "why": "test"}],
        "end_to_end": [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
        + [{"name": "mounts_seen", "unit": "mounts", "better": "higher", "bound": 0.05,
            "source": "host_clock"}],
        "per_layer": [],
    }
    before = sorted(p.relative_to(cells.ROOT) for p in (cells.ROOT / cells.FOLDER).rglob("*")
                    if "__pycache__" not in p.parts)
    cell = cells.resolve("throwaway.mounts", root=tmp_path, bench=bench)
    out = run_tiny(cell, seconds=0.3)
    assert out["correct"] and out["failed"] == 0
    assert out["metrics"]["mounts_seen"]["value"] == out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "mounts_seen"}
    after = sorted(p.relative_to(cells.ROOT) for p in (cells.ROOT / cells.FOLDER).rglob("*")
                   if "__pycache__" not in p.parts)
    assert before == after


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_runs_at_a_tiny_size(workload, trace):
    out = run_tiny(tiny_cell(workload), trace=trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] == 0 == c["limit"] for c in out["checks"].values())
    expected = {m["name"] for m in (cells.resolve(workload).per_layer if trace
                                    else cells.resolve(workload).end_to_end)}
    assert set(out["metrics"]) <= expected
    if not trace:
        assert set(out["metrics"]) == expected
    else:
        assert "breakdown" in out and out["window_s"] > 0


def test_run_refuses_without_a_card_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, str(cells.ROOT / cells.FOLDER / "run.py"), "--workload",
         "in2p3-dp.mounts", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, env={"CUDA_VISIBLE_DEVICES": "",
                                                        "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""


def test_run_refuses_outside_a_checkout(tmp_path):
    import shutil

    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(cells.ROOT / cells.FOLDER, tmp_path / cells.FOLDER,
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "ltsp_bench/run.py", "--workload", "in2p3-dp.mounts", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
