"""The benchmark's CPU tests: the repository's root and ``src`` on the
path, torch on one thread (the tier-1 run starts several workers)."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)
torch.set_num_threads(1)
