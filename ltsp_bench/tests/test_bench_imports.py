"""Nothing the harness or the reference imports is JAX or the JAX package:
a walk of every module they import, top-level names compared whole."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

from ltsp_bench import cell as cells

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCH_DIR = cells.ROOT / cells.FOLDER
SRC = cells.ROOT / "src"


def imported(path: Path) -> set[str]:
    """Absolute module names a source file imports, anywhere in it."""
    package = path.parent.relative_to(SRC if SRC in path.parents else cells.ROOT).parts
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = list(package[:len(package) - node.level + 1])
                mod = ".".join(base + ([node.module] if node.module else []))
                out.add(mod)
                out.update(f"{mod}.{a.name}" for a in node.names)
            else:
                out.add(node.module)
                out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


def source_of(module: str) -> Path | None:
    """The file of a module of this repository, if it is one."""
    parts = module.split(".")
    for root in (cells.ROOT, SRC):
        base = root.joinpath(*parts)
        for path in (base.with_suffix(".py"), base / "__init__.py"):
            if path.is_file() and (parts[0] in ("ltsp_bench", "repro_torch")):
                return path
    return None


def walk(start: list[Path], files: set | None = None) -> set[str]:
    """Top-level names of every module reachable from ``start`` (and in
    ``files``, the sources walked)."""
    seen = set() if files is None else files
    todo, tops = list(start), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for mod in imported(path):
            tops.add(mod.split(".")[0])
            src = source_of(mod)
            if src is not None:
                todo.append(src)
    return tops


def harness_files() -> list[Path]:
    return [p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.relative_to(BENCH_DIR).parts]


def test_the_walk_reaches_the_program():
    files: set = set()
    tops = walk([BENCH_DIR / "run.py"] + harness_files(), files)
    assert {"ltsp_bench", "repro_torch", "torch", "numpy"} <= tops
    for module in ("core/solver.py", "kernels/ltsp_dp/ops.py", "kernels/ltsp_dp/ltsp_dp.py"):
        assert SRC / "repro_torch" / module in files


def test_no_module_reached_is_jax_or_the_jax_package():
    tops = walk([BENCH_DIR / "run.py"] + harness_files())
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "tapes.py", "roofline.py"):
        tops = walk([BENCH_DIR / name])
        assert tops <= {"__future__", "torch", "numpy", "math"}, (name, tops)


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU, then ``sys.modules`` as ``run.py``
    reads it once the window has closed."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(cells.ROOT)!r}, {str(SRC)!r}]
        import torch
        torch.set_num_threads(1)
        from ltsp_bench.tests.tiny import run_tiny, tiny_cell
        from ltsp_bench.run import forbidden_modules
        from ltsp_bench.tests.test_bench_frozen import BENCH
        for wl in [w["name"] for w in BENCH["workloads"]]:
            assert run_tiny(tiny_cell(wl), seconds=0.2)["correct"]
        print(forbidden_modules())
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
