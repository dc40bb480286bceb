"""The port's tape-serving launcher against the JAX package's.

``python -m repro_torch.launch.serve --serve-tape-queue|--serve-tape-fleet``
must print the reference launcher's tables on the same seeds: on ``python``
against the reference's ``python``, and on ``torch --tape-device cpu`` (the
kernels' plain version) against the reference's ``pallas-interpret``, with
the wall-time column of each row dropped.  Its language-model mode serves
on the CPU with ``--tape-device cpu`` and prints the reference's two lines;
its ``--restore-from-tape`` line is the reference's but for the times, and at
full width the archive raises the reference's ``tape ... full``.  It serves
every architecture, the two with cross-attention against zero cross caches
as the reference does.  The port's launcher runs on the card by default,
never falls back to another backend; ``--mesh pod|multipod`` without the
ranks for it raises the reference's ``RuntimeError``.

The training launcher (``python -m repro_torch.launch.train``) trains on the
CPU with ``--device cpu`` and prints the reference launcher's lines: the
mesh and parameter lines and every step's learning rate exactly, the loss
and gradient norm as numbers (the two draw different weights from one
seed); its checkpoint resumes at the step the reference's resumes at.  It
too runs on the card by default and raises the reference's ``RuntimeError``
on ``--mesh pod|multipod`` here (one rank, no process group).
"""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from torch_threads import ONE_THREAD_ENV, one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]

SCENARIOS = {
    "queue": ["--serve-tape-queue", "--tape-requests", "80"],
    "queue-pool-qos": ["--serve-tape-queue", "--tape-requests", "80", "--tape-drives", "2",
                       "--tape-mount-cost", "150000", "--tape-tightness", "8000000"],
    "queue-heavy-faults": ["--serve-tape-queue", "--tape-requests", "60", "--tape-drives", "2",
                           "--tape-fault-profile", "heavy", "--tape-admission",
                           "per-drive-accumulate"],
    "queue-selector": ["--serve-tape-queue", "--tape-requests", "60", "--tape-selector",
                       "cost-model", "--tape-budget", "120", "--tape-admission", "accumulate"],
    "fleet-outage": ["--serve-tape-fleet", "--tape-requests", "90", "--fleet-outage-at",
                     "1500000", "--fleet-outage-shard", "1", "--tape-drives", "2",
                     "--tape-mount-cost", "150000"],
    "fleet-qos": ["--serve-tape-fleet", "--tape-requests", "60", "--tape-tightness", "8000000",
                  "--fleet-placement", "replica-affinity"],
}
#: the port's backend flags standing for each reference backend
PORT_FLAGS = {
    "python": ["--tape-backend", "python"],
    "pallas-interpret": ["--tape-backend", "torch", "--tape-device", "cpu"],
}
WALL = re.compile(r" \(\d+ ms wall(?:\)$|; )")


def table(out: str) -> list[str]:
    """The printed table (header and rows), each row's wall time dropped."""
    lines = out.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith(("admission,", "placement,")))
    rows = []
    for line in lines[start:]:
        if "," not in line:
            break
        rows.append(WALL.sub(lambda m: " (" if m.group(0).endswith("; ") else "", line))
    return rows


def run_ref(args, capsys, monkeypatch) -> tuple[int, str]:
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    with pytest.raises(SystemExit) as done:
        ref_serve.main()
    return done.value.code, capsys.readouterr().out


def run_port(args, capsys) -> tuple[int, str]:
    code = port_serve.main(args)
    return code, capsys.readouterr().out


#: the selector's ladder reaches heuristics, which run only on ``python``
CASES = [(name, backend) for name in sorted(SCENARIOS) for backend in sorted(PORT_FLAGS)
         if not (name == "queue-selector" and backend != "python")]


@pytest.mark.parametrize("name,backend", CASES)
def test_tables_match_reference_launcher(name, backend, capsys, monkeypatch):
    ref_code, ref_out = run_ref([*SCENARIOS[name], "--tape-backend", backend], capsys,
                                monkeypatch)
    code, out = run_port([*SCENARIOS[name], *PORT_FLAGS[backend]], capsys)
    assert code == ref_code == 0
    assert table(out) == table(ref_out)
    assert len(table(out)) > 1


def test_selector_heuristics_refuse_a_device_backend_in_both(capsys, monkeypatch):
    args = SCENARIOS["queue-selector"]
    with pytest.raises(ValueError) as ref_err:
        run_ref([*args, "--tape-backend", "pallas-interpret"], capsys, monkeypatch)
    with pytest.raises(ValueError) as err:
        run_port([*args, *PORT_FLAGS["pallas-interpret"]], capsys)
    assert type(err.value).__name__ == type(ref_err.value).__name__ == "UnsupportedBackendError"
    assert str(err.value) == str(ref_err.value).replace("pallas-interpret", "torch")


def test_defaults_run_on_the_card():
    args = port_serve.build_parser().parse_args([])
    assert (args.tape_backend, args.tape_device) == ("cuda", "cuda")
    assert port_serve._device_context(args) == dict(backend="cuda", device="cuda",
                                                    numeric_policy="f64")
    assert (args.tape_requests, args.tape_window, args.tape_seed) == (300, 400_000, 20260731)
    assert (args.fleet_shards, args.fleet_replicas) == (3, 2)


def test_cuda_backend_on_the_cpu_raises(capsys):
    with pytest.raises(ValueError, match="needs a CUDA device"):
        port_serve.main(["--serve-tape-queue", "--tape-requests", "10", "--tape-admission",
                         "accumulate", "--tape-device", "cpu"])


def test_cuda_backend_without_a_card_raises(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda backend runs")
    for mode in ("--serve-tape-queue", "--serve-tape-fleet"):
        with pytest.raises(RuntimeError, match="sees no CUDA device"):
            port_serve.main([mode, "--tape-requests", "10"])


def test_int32_guard_failure_raises_without_fallback(capsys):
    """Under the strict policy a device backend raises the guard's own message
    and does not re-route to ``python``; the launcher solves such instances
    in exact float64 tables, and its table then matches ``python``'s."""
    from repro_torch.core.solver import ExecutionContext
    from repro_torch.serving.drives import DriveCosts
    from repro_torch.serving.queue import serve_trace
    from repro_torch.serving.sim import demo_library, poisson_trace

    seed = 20260731
    trace = poisson_trace(demo_library(seed, n_files=48), n_requests=240,
                          mean_interarrival=250_000, seed=seed)
    lib = demo_library(seed, n_files=48)
    strict = ExecutionContext(backend="torch", device="cpu", numeric_policy="strict")
    with pytest.raises(ValueError, match="even after gcd rescaling"):
        serve_trace(lib, trace, "accumulate", window=400_000, n_drives=2,
                    drive_costs=DriveCosts(mount=150_000), context=strict)
    args = ["--serve-tape-queue", "--tape-requests", "240", "--tape-admission", "accumulate",
            "--tape-files", "48", "--tape-drives", "2", "--tape-mount-cost", "150000"]
    code, out = run_port([*args, "--tape-backend", "torch", "--tape-device", "cpu"], capsys)
    python_code, python_out = run_port([*args, "--tape-backend", "python"], capsys)
    assert code == python_code == 0
    cells = slice(-2, None)  # cells, reused: dense table cells on a device backend
    assert [row.split(",")[:9] for row in table(out)] == \
        [row.split(",")[:9] for row in table(python_out)]
    assert [row.split(",")[cells] for row in table(out)][1:] != \
        [row.split(",")[cells] for row in table(python_out)][1:]


def mesh_error(kind: str) -> str:
    """The reference's ``_auto_mesh`` error on this one-device CPU, up to
    its hint (``XLA_FLAGS`` there, ``torchrun`` in the port)."""
    with pytest.raises(RuntimeError) as err:
        ref_train._auto_mesh(kind)
    return str(err.value).split(" (")[0]


@pytest.mark.parametrize("kind", ["pod", "multipod"])
def test_lm_modes_raise_the_references_mesh_error(kind):
    with pytest.raises(RuntimeError) as err:
        port_serve.main(["--mesh", kind, "--reduced", "--tape-device", "cpu"])
    assert str(err.value).split(" (")[0] == mesh_error(kind)


LM_ARGS = ["--reduced", "--batch", "2", "--prompt-len", "4", "--new-tokens", "4"]
RESTORE = re.compile(r"^tape restore \[dp/[\w-]+\]: .* "
                     r"\(planned in \d+ ms; re-plan \d+ ms, cache .*\)$", re.M)


def lm_lines(out: str) -> tuple[str, str]:
    """The two lines LM serving prints: throughput, then the first sequence."""
    served = re.search(r"^[\w.-]+: \d+x\d+ tokens in [\d.]+s \(\d+ tok/s\)$", out, re.M)
    first = re.search(r"^first sequence: \[(\d+(, )?)+\] \.\.\.$", out, re.M)
    assert served and first, out
    return served.group(0), first.group(0)


def restore_line(out: str) -> str:
    """The restore line with its two times dropped."""
    m = RESTORE.search(out)
    assert m, out
    return re.sub(r" \(planned in \d+ ms; re-plan \d+ ms, ", " (", m.group(0))


def test_lm_mode_serves_on_the_cpu(capsys):
    code, out = run_port(["--arch", "granite-8b", *LM_ARGS, "--tape-device", "cpu"], capsys)
    assert code == 0
    served, first = lm_lines(out)
    assert served.startswith("granite-8b: 2x4 tokens in ")
    assert len(re.findall(r"\d+", first.split(":")[1])) == 4


def check_lm_mode_serves(arch: str, capsys) -> None:
    code, out = run_port(["--arch", arch, *LM_ARGS, "--tape-device", "cpu"], capsys)
    assert code == 0
    served, first = lm_lines(out)
    assert served.startswith(f"{arch}: 2x4 tokens in ")
    assert math.isfinite(float(re.search(r"tokens in ([\d.]+)s", served).group(1)))
    assert len(re.findall(r"\d+", first.split(":")[1])) == 4


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_lm_mode_serves_the_moe_archs_on_the_cpu(arch, capsys):
    check_lm_mode_serves(arch, capsys)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_lm_mode_serves_the_recurrent_archs_on_the_cpu(arch, capsys):
    check_lm_mode_serves(arch, capsys)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "seamless-m4t-large-v2"])
def test_lm_mode_serves_the_cross_attention_archs_on_the_cpu(arch, capsys, monkeypatch):
    """Both decode against the zero cross caches ``init_cache`` gives, as the
    reference launcher does; ``--restore-from-tape`` prints the reference
    launcher's restore line."""
    check_lm_mode_serves(arch, capsys)
    args = ["--arch", arch, *LM_ARGS, "--restore-from-tape", "--tape-backend", "python"]
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    ref_serve.main()
    ref_out = capsys.readouterr().out
    code, out = run_port([*args, "--tape-device", "cpu"], capsys)
    assert code == 0
    assert restore_line(out) == restore_line(ref_out)
    lm_lines(out)


@pytest.mark.parametrize("arch", ["granite-8b", "qwen2.5-3b"])
def test_restore_line_matches_reference_launcher(arch, capsys, monkeypatch):
    # the reference's LM mode returns from main() instead of raising SystemExit
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, *LM_ARGS, "--restore-from-tape",
                                      "--tape-backend", "python"])
    ref_serve.main()
    ref_out = capsys.readouterr().out
    code, out = run_port(["--arch", arch, *LM_ARGS, "--restore-from-tape", "--tape-backend",
                          "python", "--tape-device", "cpu"], capsys)
    assert code == 0
    assert restore_line(out) == restore_line(ref_out)
    assert "cache 1 hits / " in restore_line(out)
    lm_lines(out)
    # the plain device tables plan the same restore
    code, out_torch = run_port(["--arch", arch, *LM_ARGS, "--restore-from-tape",
                                "--tape-backend", "torch", "--tape-device", "cpu"], capsys)
    assert code == 0
    assert restore_line(out_torch) == restore_line(out).replace("[dp/python]", "[dp/torch]")


def test_full_width_restore_raises_the_references_tape_full():
    """Qwen2.5-3B's 311 M-element embedding shard does not fit the launcher's
    4 MB cartridges: the reference's archive raises, and so does the port's
    (the trees carry shapes only: ``meta`` tensors, broadcast numpy views)."""
    import jax
    import numpy as np

    from repro.configs import ARCHS as REF_ARCHS
    from repro.models.model import init_model as ref_init_model
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_model

    shapes = jax.eval_shape(lambda k: ref_init_model(k, REF_ARCHS["qwen2.5-3b"]),
                            jax.random.PRNGKey(0))
    ref_params = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    with pytest.raises(ValueError) as ref_err:
        ref_serve._restore_from_tape(ref_params, "dp", "python")
    params = init_model(torch.Generator(), ARCHS["qwen2.5-3b"], device="meta")
    with pytest.raises(ValueError) as err:
        port_serve._restore_from_tape(params, "dp", dict(backend="python", device="cpu",
                                                         numeric_policy="f64"))
    assert str(err.value) == str(ref_err.value)
    assert re.fullmatch(r"tape \S+ full", str(err.value))


def test_lm_mode_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the model serves on it")
    with pytest.raises(RuntimeError, match="sees no CUDA device"):
        port_serve.main(LM_ARGS)


def test_module_entry_point_runs_without_jax():
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.argv = ['serve', '--serve-tape-fleet', '--tape-requests', '30',\n"
            "            '--tape-backend', 'python']\n"
            "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD_ENV)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert table(proc.stdout)[0].startswith("placement,served,failed,rerouted")


@pytest.mark.parametrize("mode", ["--serve-tape-queue", "--serve-tape-fleet"])
def test_written_files_match_reference_launcher(mode, tmp_path, capsys, monkeypatch):
    """The files a run writes (span log, Chrome trace, Prometheus snapshot,
    and for the queue the recorded trace and the event journal) are the
    reference launcher's bytes on ``python``."""
    written = {}
    for name in ("ref", "port"):
        out = tmp_path / name
        out.mkdir()
        args = [mode, "--tape-requests", "60", "--tape-drives", "2", "--tape-mount-cost",
                "150000", "--tape-backend", "python", "--tape-trace-out", str(out / "spans.jsonl"),
                "--tape-metrics-out", str(out / "metrics.prom")]
        if mode == "--serve-tape-queue":
            args += ["--tape-admission", "accumulate", "--tape-journal", str(out / "journal"),
                     "--record-trace", str(out / "trace.jsonl")]
        else:
            args += ["--fleet-placement", "replica-affinity", "--fleet-outage-at", "1500000"]
        if name == "ref":
            code, printed = run_ref(args, capsys, monkeypatch)
        else:
            code, printed = run_port(args, capsys)
        assert code == 0
        written[name] = (table(printed), {p.name: p.read_bytes() for p in sorted(out.iterdir())})
    assert written["port"] == written["ref"]
    assert len(written["port"][1]) == (5 if mode == "--serve-tape-queue" else 3)


# ---------------------------------------------------------------------------
# the training launcher
# ---------------------------------------------------------------------------
TRAIN_ARGS = ["--reduced", "--steps", "12", "--batch", "4", "--seq", "32", "--ckpt-every", "5"]
STEP = re.compile(r"^step +(\d+) loss=(\d+\.\d{4}) lr=(\S+) gnorm=(\d+\.\d{2})$")


def train_lines(out: str) -> list:
    """Each printed line, a step line as (step, lr) with its loss and norm
    checked for shape only."""
    lines = []
    for line in out.splitlines():
        m = STEP.match(line)
        lines.append((m.group(1), m.group(3)) if m else line)
    return lines


def test_train_launcher_prints_the_reference_lines_and_resumes(tmp_path, capsys, monkeypatch):
    printed = {}
    for name, extra in (("first", []), ("resume", ["--resume", "--steps", "14"])):
        monkeypatch.setattr(sys, "argv", ["train", *TRAIN_ARGS, "--ckpt-dir",
                                          str(tmp_path / "ref"), *extra])
        ref_train.main()
        ref_out = capsys.readouterr().out
        code = port_train.main([*TRAIN_ARGS, "--device", "cpu", "--ckpt-dir",
                                str(tmp_path / "port"), *extra])
        assert code == 0
        printed[name] = (train_lines(capsys.readouterr().out), train_lines(ref_out))
    port, ref = printed["first"]
    assert port == ref
    assert port[:2] == ["mesh: {'data': 1, 'model': 1}  arch: granite-8b", "params: 0.1M"]
    assert port[2:] == [("10", "1.50e-04"), ("12", "1.80e-04"), "done"]
    port, ref = printed["resume"]
    assert port == ref and port[2] == "resumed from step 10"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())


def test_train_launcher_returns_each_steps_record(tmp_path):
    args = port_train.build_parser().parse_args(
        [*TRAIN_ARGS, "--device", "cpu", "--ckpt-dir", str(tmp_path), "--set",
         "remat_policy=dots", "microbatches=2"])
    run = port_train.train(args)
    assert run["cfg"].remat_policy == "dots" and run["cfg"].microbatches == 2
    assert run["start"] == 0 and len(run["history"]) == 12 and int(run["opt_state"]["step"]) == 12
    assert all(np.isfinite(h["loss"]) and h["seconds"] > 0 for h in run["history"])


def check_train_launcher_trains(arch: str, tmp_path, capsys) -> None:
    code = port_train.main(["--arch", arch, *TRAIN_ARGS[:1], "--steps", "10", *TRAIN_ARGS[3:],
                            "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert code == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"mesh: {{'data': 1, 'model': 1}}  arch: {arch}"
    step = STEP.match(lines[2])
    assert step and step.group(1) == "10" and lines[3:] == ["done"]
    assert all(math.isfinite(float(step.group(k))) for k in (2, 3, 4))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_train_launcher_trains_the_moe_archs_on_the_cpu(arch, tmp_path, capsys):
    check_train_launcher_trains(arch, tmp_path, capsys)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_train_launcher_trains_the_recurrent_archs_on_the_cpu(arch, tmp_path, capsys):
    """At ``TRAIN_ARGS``' sequence of 32: from about 128 tokens on, the
    reference's parallel mLSTM gives NaN gradients, and so does the port
    (``tests/test_torch_recurrent.py``)."""
    check_train_launcher_trains(arch, tmp_path, capsys)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "seamless-m4t-large-v2"])
def test_train_launcher_trains_the_cross_attention_archs_on_the_cpu(arch, tmp_path, capsys):
    """Their batches carry zero frontend embeddings, as the reference
    launcher's do; Seamless's run through its encoder inside the loss."""
    check_train_launcher_trains(arch, tmp_path, capsys)


@pytest.mark.parametrize("kind", ["pod", "multipod"])
def test_train_launcher_raises_the_references_mesh_error(kind):
    """With the default device too: the mesh is built before the device is
    checked, as the reference builds it before initialising."""
    with pytest.raises(RuntimeError) as err:
        port_train.main(["--mesh", kind])
    assert str(err.value).split(" (")[0] == mesh_error(kind)


def test_train_launcher_defaults_to_the_card():
    args = port_train.build_parser().parse_args([])
    assert (args.device, args.arch, args.steps, args.ckpt_every) == ("cuda", "granite-8b", 100, 50)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="sees no CUDA device"):
        port_train.main(["--reduced", "--steps", "1"])
