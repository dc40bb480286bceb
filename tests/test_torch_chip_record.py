"""Phase 1d of ``chip_smoke.py``, the card-only tests, on the CPU.

The phase runs the ``cuda`` cases of every port test file that marks one,
and ``tests/test_torch_four_ranks.py`` whole, on the card's machine, and
fails the run unless every case it selects passes.  Here its verdict is held
to canned junit reports, one per way a run can fall short, and to reports
that pytest itself writes; its file scan is collected in a child process
with JAX blocked, as on the card's machine, which has no JAX.

``chip_smoke.py`` imports only the standard library at module level, so it
is imported here by path.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

#: the files that held ``cuda`` cases when the phase was written
CARD_FILES = ["tests/test_torch_fleet.py", "tests/test_torch_kernels.py",
              "tests/test_torch_lm_device.py", "tests/test_torch_serving_device.py",
              "tests/test_torch_tiled.py"]
#: pytest in a child process that cannot import JAX
JAX_BLOCKED_PYTEST = (sys.executable, "-c", "import sys; sys.modules['jax'] = None; "
                      "import pytest; sys.exit(pytest.main(sys.argv[1:]))",
                      "-p", "no:cacheprovider")

A, B = "tests/test_torch_a.py", "tests/test_torch_b.py"


def junit(cases) -> str:
    """A junit report as pytest writes it: ``cases`` are ``(classname, name,
    outcome)``, the outcome ``None`` for a pass, else the child element's tag."""
    body, counts = [], {"failure": 0, "error": 0, "skipped": 0}
    for cls, name, outcome in cases:
        if outcome is None:
            body.append(f'<testcase classname="{cls}" name="{name}" time="0.010" />')
        else:
            counts[outcome] += 1
            body.append(f'<testcase classname="{cls}" name="{name}" time="0.010">'
                        f'<{outcome} message="m">detail</{outcome}></testcase>')
    return ('<?xml version="1.0" encoding="utf-8"?><testsuites name="pytest tests">'
            f'<testsuite name="pytest" errors="{counts["error"]}" '
            f'failures="{counts["failure"]}" skipped="{counts["skipped"]}" '
            f'tests="{len(cases)}" time="0.100" hostname="h">{"".join(body)}'
            '</testsuite></testsuites>')


PASSED = [("tests.test_torch_a", "test_x[1]", None), ("tests.test_torch_a", "test_x[2]", None),
          ("tests.test_torch_b.TestY", "test_y", None)]
FAILED_Y = PASSED[:2] + [("tests.test_torch_b.TestY", "test_y", "failure")]
VERDICTS = {
    # name: (report, collected, exit code, the verdict or the failure's words)
    "all passed": (junit(PASSED), {A: 2, B: 1}, 0, {A: (2, 2), B: (1, 1)}),
    "one failure": (junit(FAILED_Y), {A: 2, B: 1}, 1, "exited 1"),
    "one failure, exit 0": (junit(FAILED_Y), {A: 2, B: 1}, 0, "TestY::test_y: failure"),
    "one error": (junit(PASSED + [("tests.test_torch_a", "test_z", "error")]), {A: 3, B: 1}, 0,
                  "test_z: error"),
    "an error outside any case": (junit(PASSED).replace('errors="0"', 'errors="1"'),
                                  {A: 2, B: 1}, 0, "'errors': 1"),
    "one skip": (junit(PASSED[:1] + [("tests.test_torch_a", "test_x[2]", "skipped")]
                       + PASSED[2:]), {A: 2, B: 1}, 0, r"test_x\[2\]: skipped"),
    "a selected file with no case": (junit(PASSED[:2]), {A: 2, B: 0}, 0, "selects no case"),
    "a selected file with no passed case": (junit(PASSED[:2]), {A: 2, B: 1}, 0,
                                            "no case passed"),
    "fewer passed than collected": (junit(PASSED), {A: 3, B: 1}, 0, "2 passed of 3 collected"),
    "a case of no selected file": (junit(PASSED + [("tests.test_torch_c", "test_w", None)]),
                                   {A: 2, B: 1}, 0, "no selected file"),
    "timed out": (junit(PASSED), {A: 2, B: 1}, None, "time limit"),
}


@pytest.mark.parametrize("case", list(VERDICTS))
def test_verdict_on_canned_reports(case, tmp_path):
    report, collected, rc, want = VERDICTS[case]
    xml = tmp_path / "cuda.xml"
    xml.write_text(report)
    if isinstance(want, dict):
        assert chip_smoke.card_suite_verdict(xml, [A, B], collected, rc) == want
    else:
        with pytest.raises(SystemExit, match=f"^phase 1d FAILED: .*{want}"):
            chip_smoke.card_suite_verdict(xml, [A, B], collected, rc)


def test_verdict_without_a_report(tmp_path):
    with pytest.raises(SystemExit, match="^phase 1d FAILED: .*no junit report"):
        chip_smoke.card_suite_verdict(tmp_path / "cuda.xml", [A], {A: 1}, 0)


@pytest.mark.parametrize("second", ["passes", "skips"])
def test_verdict_on_reports_pytest_writes(second, tmp_path):
    """A report written by pytest itself: its class names map onto the
    selected file, and a skipped case fails the verdict."""
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "tests").mkdir()
    body = "import pytest\n\ndef test_one():\n    pass\n\nclass TestTwo:\n    def test_two(self):\n"
    body += "        pass\n" if second == "passes" else "        pytest.skip('no card')\n"
    (tmp_path / "tests" / "test_torch_demo.py").write_text(body)
    xml = tmp_path / "demo.xml"
    proc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                           f"--junitxml={xml}", "tests/test_torch_demo.py"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env=chip_smoke.card_tests_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr
    files = ["tests/test_torch_demo.py"]
    if second == "passes":
        assert chip_smoke.card_suite_verdict(xml, files, {files[0]: 2}, 0) == {files[0]: (2, 2)}
    else:
        with pytest.raises(SystemExit, match="TestTwo::test_two: skipped"):
            chip_smoke.card_suite_verdict(xml, files, {files[0]: 2}, 0)


def test_the_scan_finds_every_file_with_card_cases():
    files = chip_smoke.card_test_files()
    assert set(CARD_FILES) <= set(files)
    assert chip_smoke.FOUR_RANK_TESTS not in files
    assert "tests/test_torch_chip_record.py" not in files
    suites = chip_smoke.card_suites()
    assert suites["cuda"] == (["-m", "cuda", *files], files)
    assert suites["four_ranks"] == ([chip_smoke.FOUR_RANK_TESTS], [chip_smoke.FOUR_RANK_TESTS])


def test_the_phase_collects_without_jax(tmp_path):
    """What the phase selects collects with JAX blocked, every file with at
    least one case: the card's machine has no JAX."""
    counts = chip_smoke.collect_card_suites(tmp_path, pytest=JAX_BLOCKED_PYTEST)
    assert set(counts) == {"cuda", "four_ranks"}
    for name, per_file in counts.items():
        assert per_file and all(n >= 1 for n in per_file.values()), (name, per_file)
    assert counts["four_ranks"] == {chip_smoke.FOUR_RANK_TESTS: 16}


def test_chip_smoke_imports_only_the_standard_library():
    code = ("import sys; sys.modules['jax'] = None; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; print(sorted(m for m in ('torch', 'numpy', 'repro', "
            "'repro_torch') if m in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
