"""The port stands alone: it imports neither JAX nor the JAX package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
from torch_threads import ONE_THREAD_ENV, one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any attempt to import jax now raises ImportError
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
print(len(names), leaked)
"""


def test_every_module_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD_ENV)
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, leaked = proc.stdout.split(maxsplit=1)
    assert int(count) >= 20 + len(SERVING_SLICE) + len(LM_SLICE) + len(TRAINING_SLICE) - 1 + \
        len(MESH_SLICE)
    assert leaked.strip() == "[]"


SERVING_SLICE = [
    "repro_torch.serving", "repro_torch.serving.sim", "repro_torch.serving.qos",
    "repro_torch.serving.drives", "repro_torch.serving.faults", "repro_torch.serving.queue",
    "repro_torch.data.traces", "repro_torch.distributed", "repro_torch.distributed.checkpoint",
    "repro_torch.obs", "repro_torch.obs.trace", "repro_torch.obs.metrics",
    "repro_torch.obs.kernel", "repro_torch.obs.export",
    "repro_torch.fleet", "repro_torch.fleet.placement", "repro_torch.fleet.report",
    "repro_torch.fleet.server", "repro_torch.launch", "repro_torch.launch.serve",
]
#: the language-model serving path and the configs it serves
LM_SLICE = [
    "repro_torch.models", "repro_torch.models.common", "repro_torch.models.blocks",
    "repro_torch.models.model", "repro_torch.models.convert", "repro_torch.configs",
    "repro_torch.configs.qwen2_5_3b", "repro_torch.serving.serve",
]

#: training, its fault tolerance and its launcher
TRAINING_SLICE = [
    "repro_torch.training", "repro_torch.training.optimizer", "repro_torch.training.train_step",
    "repro_torch.distributed.fault_tolerance", "repro_torch.launch.cli",
    "repro_torch.launch.train",
]


#: the sharding rules, mesh hints, gradient compression, production mesh,
#: abstract specs and the dry run
MESH_SLICE = [
    "repro_torch.distributed.sharding", "repro_torch.distributed.context",
    "repro_torch.distributed.compression", "repro_torch.launch.mesh",
    "repro_torch.launch.specs", "repro_torch.launch.dryrun",
]


@pytest.mark.parametrize("module", SERVING_SLICE + LM_SLICE + TRAINING_SLICE + MESH_SLICE)
def test_serving_slice_imports_with_jax_blocked(module):
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"importlib.import_module({module!r})\n"
        "print(sorted(m for m in sys.modules if m == 'repro' or m.startswith('repro.')))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD_ENV)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in
                                        [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
                                         *(ROOT / "examples" / "torch").glob("*.py")]))
def test_no_import_of_jax_or_the_jax_package(path):
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")
    offending = [line for line in (ROOT / path).read_text().splitlines() if pattern.match(line)]
    assert offending == []
