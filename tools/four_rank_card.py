#!/usr/bin/env python3
"""The four-rank tests of ``tests/test_torch_distributed.py`` on a machine
without JAX.

That module imports the JAX package for its other tests, so it does not
collect on the card's machine, whose torch release (and DTensor) differs
from this sandbox's.  This script copies the module's section "the mesh
path on four gloo ranks" verbatim into ``build/test_four_ranks.py`` under
the imports it needs, and runs pytest on it: the same fixture and the same
seven tests (``tests/torch_mesh_worker.py`` on four gloo ranks of the CPU).

Run from the repo root::

    python3 tools/four_rank_card.py
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEAD = '''import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path({root!r})
sys.path.insert(0, str(ROOT / "tests"))
from torch_threads import ONE_THREAD_ENV  # noqa: E402
'''


def main() -> int:
    src = (ROOT / "tests" / "test_torch_distributed.py").read_text()
    start = src.rindex("\n# ----", 0, src.index("# the mesh path on four gloo ranks"))
    end = src.rindex("\n# ----", 0, src.index("# the launchers' mesh rule"))
    out = ROOT / "build" / "test_four_ranks.py"
    out.parent.mkdir(exist_ok=True)
    out.write_text(HEAD.format(root=str(ROOT)) + src[start:end] + "\n")
    return subprocess.call([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                            str(out)], cwd=ROOT)


if __name__ == "__main__":
    raise SystemExit(main())
