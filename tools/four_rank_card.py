#!/usr/bin/env python3
"""The four-rank tests on a machine without JAX.

``tests/test_torch_four_ranks.py`` imports neither JAX nor the JAX package,
so it collects on the card's machine, whose torch release (and DTensor)
differs from the one the CPU suite runs on.  This script runs pytest on it
there: the ``four_ranks`` fixture (``tests/torch_mesh_worker.py`` on four
gloo ranks of the CPU) and its 16 cases.  ``chip_smoke.py`` phase 1d runs
the same file; this is the way to run it alone.

Run from the repo root::

    python3 tools/four_rank_card.py
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from torch_threads import ONE_THREAD_ENV  # noqa: E402


def main() -> int:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               **ONE_THREAD_ENV)
    return subprocess.call([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                            "tests/test_torch_four_ranks.py"], cwd=ROOT, env=env)


if __name__ == "__main__":
    raise SystemExit(main())
