"""Build and bind the hand-written CUDA wavefront kernel.

``csrc/ltsp_wavefront.cu`` has a plain C interface, so it is compiled by
``nvcc`` alone (no PyTorch headers) into a shared library for ``sm_90a`` and
loaded with :mod:`ctypes`.  The library lands in ``build/kernels/`` at the
root of the checkout, named by a hash of the source and the flags: the first
call builds it, later calls and processes reuse it, and an edited source
builds anew.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "NVCC_FLAGS", "TYPE_SUFFIX", "library_path", "build", "load"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ltsp_wavefront.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: table type name -> suffix of its C entry point ``ltsp_wavefront_<suffix>``
TYPE_SUFFIX = {"int32": "i32", "float32": "f32", "float64": "f64"}


def _nvcc() -> str:
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA wavefront kernel cannot be built"
        )
    return found


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libltsp_wavefront-{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the library if it is missing: ``(path, seconds, ptxas log)``.

    ``seconds`` is 0.0 when the library was already built.  The log holds
    ``nvcc``'s report of registers, shared memory and spills per kernel.
    """
    path = library_path()
    log_path = path.with_suffix(".log")
    if path.is_file():
        return path, 0.0, log_path.read_text() if log_path.is_file() else ""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {SOURCE.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, seconds, log


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library, built first if needed, with every entry point's
    argument and result types declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for suffix in TYPE_SUFFIX.values():
        fn = getattr(lib, f"ltsp_wavefront_{suffix}")
        # T, C, left, right, x, nl, u, B, R, S, d, span, disjoint, static_tile, stream
        fn.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        fn.restype = i32
    return lib
