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
with the numbers taken out.  The training example draws other weights too:
its corpus, its shard plan (order and service times, on ``torch``/CPU and
``python``), its parameter count, its preemption and restore lines and each
step's learning rate are its twin's, its losses are held for shape.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import ONE_THREAD_ENV, one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
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
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", **ONE_THREAD_ENV)
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
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD_ENV)
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
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD_ENV)
    proc = subprocess.run([sys.executable, str(script), *SERVE_ARGS], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert "torch sees no CUDA device" in proc.stderr


# ---------------------------------------------------------------------------
# the training example
# ---------------------------------------------------------------------------
TRAIN_ARGS = ["--steps", "6", "--batch", "4", "--seq", "32"]
TRAIN_STEP = re.compile(r"^(step +\d+) loss=\d+\.\d{4} (lr=\S+) \d+ ms/step$")
FINAL = re.compile(r"^final loss \d+\.\d{4} \(started \d+\.\d{4}\); loss decreased: (\w+)$")


def train_lines(out: str) -> list[str]:
    """The printed lines, the losses and times taken out."""
    lines = []
    for line in out.splitlines():
        step, final = TRAIN_STEP.match(line), FINAL.match(line)
        lines.append(" ".join(step.groups()) if step else
                     "loss decreased: True or False" if final else line)
    return lines


def load_example(path: Path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{path.parent.name}_{path.stem}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("backend", ["torch", "python"])
def test_train_e2e_plans_its_twins_shard_stream(backend):
    """Same corpus, same LTSP-scheduled shard order and service times."""
    from repro_torch.core import ExecutionContext

    ref = load_example(ROOT / "examples" / "train_e2e.py")
    port = load_example(ROOT / "examples" / "torch" / "train_e2e.py")
    ref_lib, ref_shards = ref.build_corpus_on_tape(12, 4 * 32 * 16, 512)
    ctx = ExecutionContext(backend=backend, device="cpu", numeric_policy="f64")
    lib, shards = port.build_corpus_on_tape(12, 4 * 32 * 16, 512, context=ctx)
    want = list(ref.scheduled_shard_stream(ref_lib, ref_shards))
    got = list(port.scheduled_shard_stream(lib, shards))
    assert [(n, t) for n, _, t in got] == [(n, t) for n, _, t in want]
    assert all(np.array_equal(a, b) for (_, a, _), (_, b, _) in zip(got, want))
    assert len(got) == 12 and lib.tapes[0].files and lib.context.backend == backend


def test_train_e2e_prints_its_twins_lines_and_resumes(tmp_path):
    ref = run(ROOT / "examples" / "train_e2e.py", [*TRAIN_ARGS, "--ckpt-dir",
                                                   str(tmp_path / "ref")])
    port = run(ROOT / "examples" / "torch" / "train_e2e.py",
               [*TRAIN_ARGS, "--backend", "torch", "--device", "cpu", "--ckpt-dir",
                str(tmp_path / "port")])
    assert train_lines(port) == train_lines(ref)
    lines = train_lines(port)
    assert lines[0].startswith("corpus: 12 shards; first shard ready at simulated t=")
    assert "step 3: simulating preemption — dropping live state" in lines
    assert "step 3: restored from checkpoint, continuing" in lines
    assert FINAL.match(port.splitlines()[-1])


def test_train_e2e_defaults_to_the_card(tmp_path):
    """Without ``--backend``/``--device`` the plan runs on the CUDA kernels
    and the model on the card; with no card the example stops with the
    device error."""
    import torch

    script = ROOT / "examples" / "torch" / "train_e2e.py"
    args = [*TRAIN_ARGS, "--ckpt-dir", str(tmp_path / "ckpt")]
    if torch.cuda.is_available():  # the default length, over which the loss falls
        cuda = run(script, ["--ckpt-dir", str(tmp_path / "cuda")])
        python = run(script, ["--ckpt-dir", str(tmp_path / "python"), "--backend", "python"])
        assert cuda.splitlines()[0] == python.splitlines()[0]
        assert cuda.splitlines()[-1].endswith("loss decreased: True")
        return
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD_ENV)
    proc = subprocess.run([sys.executable, str(script), *args], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert "torch sees no CUDA device" in proc.stderr
