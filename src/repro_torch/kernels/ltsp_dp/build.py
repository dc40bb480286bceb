"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/<name>.cu`` has a plain C interface, so it is compiled by
``nvcc`` alone (no PyTorch headers) into its own shared library for
``sm_90a`` and loaded with :mod:`ctypes`.  The libraries land in
``build/kernels/`` at the root of the checkout, each named by a hash of its
source, the shared headers (``csrc/*.cuh``) and the flags: the first call
builds it, later calls and processes reuse it, and an edited source builds
anew.  :func:`build_all` starts one ``nvcc`` per source, all at once.
Nothing here runs at import time.
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

__all__ = [
    "CSRC", "BUILD_DIR", "NVCC_FLAGS", "TYPE_SUFFIX", "SOURCES",
    "library_path", "build", "build_all", "load",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: table type name -> suffix of its C entry points (``ltsp_far_fold_<suffix>`` ...)
TYPE_SUFFIX = {"int32": "i32", "float32": "f32", "float64": "f64"}

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
#: source name -> {C entry point: (argument types, result type)}
SOURCES: dict[str, dict[str, tuple[list, type]]] = {
    "ltsp_tiled": {
        **{f"ltsp_tile_size_{t}": ([], _I) for t in TYPE_SUFFIX.values()},
        # T, C, right, nl, u, B, R, S, D, span, disjoint, stream
        **{f"ltsp_far_fold_{t}": ([_P] * 5 + [_I] * 6 + [_P], _I) for t in TYPE_SUFFIX.values()},
        # T, C, left, right, x, nl, u, B, R, S, D, k, span, disjoint, static_tile, stream
        **{f"ltsp_near_fold_{t}": ([_P] * 7 + [_I] * 8 + [_P], _I) for t in TYPE_SUFFIX.values()},
        # T, C, left, right, x, nl, u, B, R, S, span, disjoint, static_tile, n_far,
        # n_near, stream
        **{f"ltsp_tiled_tables_{t}": ([_P] * 7 + [_I] * 6 + [_IP, _IP, _P], _I)
           for t in TYPE_SUFFIX.values()},
    },
    "ltsp_traceback": {
        # C, x, dets, counts, stack, B, R, S, stream
        "ltsp_traceback": ([_P] * 5 + [_I] * 3 + [_P], _I),
    },
}


def _nvcc() -> str:
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` for the current sources and
    flags lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, tuple[Path, float, str]]:
    """Compile the libraries that are missing, one ``nvcc`` per source, all
    started together: ``{name: (path, seconds, ptxas log)}``.

    ``seconds`` is 0.0 for a library that was already built.  The log holds
    ``nvcc``'s report of registers, shared memory and spills per kernel.
    """
    names = sorted(SOURCES) if names is None else list(names)
    started = {}
    done: dict[str, tuple[Path, float, str]] = {}
    for name in names:
        path = library_path(name)
        log_path = path.with_suffix(".log")
        if path.is_file():
            done[name] = (path, 0.0, log_path.read_text() if log_path.is_file() else "")
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        started[name] = (path, tmp, proc, time.perf_counter())
    failures = []
    for name, (path, tmp, proc, t0) in started.items():
        out, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n{out}\n{err}")
            continue
        path.with_suffix(".log").write_text(out + err)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        done[name] = (path, seconds, out + err)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: done[name] for name in names}


def build(name: str) -> tuple[Path, float, str]:
    """Compile one library if it is missing (see :func:`build_all`)."""
    return build_all([name])[name]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    every entry point's argument and result types declared."""
    path, _, _ = build(name)
    lib = ctypes.CDLL(str(path))
    for fn_name, (argtypes, restype) in SOURCES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
