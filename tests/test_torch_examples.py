"""The port's examples (``examples/torch/``) against their reference twins.

Each example runs on the CPU, once on ``python`` and once on the ``torch``
backend (the kernels' plain version, ``--device cpu``), and must print the
numbers its twin in ``examples/`` prints; each also asserts what its twin
asserts.  Three differences are by design and named where they apply: the
reference's online-serving example labels a table with a change number (a
number that is no result); the online example's ``dp (fixed)`` priced-solve
arm runs on the device backend, whose budget prices dense table cells; and
the fault example's seeded solver fault targets the run's backend, so on a
device backend its fail-stop row degrades through ``torch -> python`` where
the reference's ``python`` run has no tier to fall to.  With a card present,
each example's default run (the CUDA kernels) must print the numbers of its
own ``python`` run.  The batched-serving example draws other weights than its
twin (JAX and torch generators differ), so it is held to its twin's lines
with the numbers taken out.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
NUM = re.compile(r"-?\d+(?:[.,]\d+)*(?:e[+-]?\d+)?")

#: example -> arguments both twins take (small sizes for the CPU)
EXAMPLES = {
    "quickstart": [],
    "online_serving": ["--requests", "120"],
    "qos_serving": ["--requests", "120"],
    "fault_serving": ["--requests", "60"],
    "fleet_serving": ["--requests", "120"],
    "observability": ["--requests", "120"],
    "tape_restore": [],
}
BACKENDS = {"python": ["--backend", "python"], "torch": ["--backend", "torch", "--device", "cpu"]}
#: the rows a device backend prints differently from ``python``, by design
DEVICE_ROWS = {"fault_serving": "fail-stop", "online_serving": "dp (fixed)"}


def run(script: Path, args: list[str], cwd: Path = ROOT) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(script), *args], capture_output=True, text=True,
                          env=env, cwd=cwd, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def numbers(out: str, drop_rows: str | None = None) -> list[str]:
    out = re.sub(r"\(the [A-Z]+-\d+ special case\)", "", out)
    lines = [line for line in out.splitlines()
             if drop_rows is None or not line.startswith(drop_rows)]
    return NUM.findall("\n".join(lines))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_prints_its_reference_twins_numbers(name, backend, tmp_path):
    args = list(EXAMPLES[name])
    if name == "observability":
        args += ["--out-dir", str(tmp_path / "obs")]
    ref = run(ROOT / "examples" / f"{name}.py", args)
    port = run(ROOT / "examples" / "torch" / f"{name}.py", [*args, *BACKENDS[backend]])
    drop = DEVICE_ROWS.get(name) if backend == "torch" else None
    assert numbers(port, drop) == numbers(ref, drop)
    assert len(numbers(port)) > 5


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_defaults_to_the_card(name, tmp_path):
    """Without ``--backend``, an example solves with the CUDA kernels.  With no
    card it stops with the device error and serves nothing; on a card its
    default run prints the numbers of its ``python`` run."""
    import torch

    script = ROOT / "examples" / "torch" / f"{name}.py"
    if torch.cuda.is_available():
        printed = {}
        for label, args in (("cuda", []), ("python", ["--backend", "python"])):
            (tmp_path / label).mkdir()  # the observability example writes into its cwd
            printed[label] = run(script, args, cwd=tmp_path / label)
        drop = DEVICE_ROWS.get(name)
        assert numbers(printed["cuda"], drop) == numbers(printed["python"], drop)
        assert len(numbers(printed["cuda"])) > 5
        return
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(script), *EXAMPLES[name]], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert "torch sees no CUDA device" in proc.stderr


SERVE_ARGS = ["--batch", "2", "--prompt-len", "6", "--new-tokens", "8"]


def shape_of(out: str) -> list[str]:
    """The printed lines with every number taken out."""
    return [NUM.sub("#", line) for line in out.splitlines()]


def test_serve_batched_prints_its_reference_twins_lines():
    ref = run(ROOT / "examples" / "serve_batched.py", SERVE_ARGS)
    port = run(ROOT / "examples" / "torch" / "serve_batched.py", [*SERVE_ARGS, "--device", "cpu"])
    assert shape_of(port.replace(" device=cpu", "")) == shape_of(ref)
    assert re.search(r"^  seq1: \[(\d+, ){8}\d+\] \.\.\.$", port, re.M)


def test_serve_batched_defaults_to_the_card():
    """Without ``--device`` the model serves on the card; with no card the
    example stops with the device error."""
    import torch

    script = ROOT / "examples" / "torch" / "serve_batched.py"
    if torch.cuda.is_available():
        assert "device=cuda" in run(script, SERVE_ARGS)
        return
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(script), *SERVE_ARGS], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert "torch sees no CUDA device" in proc.stderr
