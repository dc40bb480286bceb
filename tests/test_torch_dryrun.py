"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX package's.

The port runs each cell's step eagerly on ``meta`` tensors placed as
``DTensor`` s over a process group of the ``fake`` backend, where the
reference compiles it.  Held here: the ring factors against the reference's
``parse_collectives`` on hand-written HLO lines, one per collective; the
per-device flop count against ``FlopCounterMode`` of the plain step on a
one-rank mesh, and its depth extrapolation (the reference's two-point
formula from depths 1 and 2 reproduces the full-depth count, which the port
writes); a reduced model's cells over a small fake mesh, with the
reference's JSON keys; and the command line on one full-width cell.  The
memory and traffic counts, which the reference reads off XLA, are held to
counts worked out by hand on one linear layer, to the same step on real CPU
tensors, to the remat policy they must follow, and to the backward pass they
must see; a tracker that raises fails its cell.  Each device's share of the
work: a reduced dense arch's per-device flops times the ranks against one
device's step, and the reduced Qwen2.5-3B's against the reference's own
ratio from XLA's cost analysis of its SPMD step (in a process of its own,
JAX on 8 host devices); and the largest storage the cross-entropy creates.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, InputShape, reduced
from repro_torch.launch import dryrun
from torch_threads import ONE_THREAD_ENV, one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"train": InputShape("train_small", 32, 8, "train"),
         "prefill": InputShape("prefill_small", 32, 8, "prefill"),
         "decode": InputShape("decode_small", 32, 8, "decode")}
KEYS = {"arch", "shape", "mesh", "kind", "ok", "total_s", "full_compile_s", "n_periods", "flops",
        "bytes_accessed", "flops_scanned", "memory", "collectives", "collective_bytes",
        "collectives_scanned"}


def reference_parse_collectives():
    """The reference's ``parse_collectives``.  Its module sets ``XLA_FLAGS``
    for 512 host devices when imported: JAX's backend is brought up first
    (so this process keeps its devices) and the variable is put back (so no
    process started later inherits it)."""
    import jax

    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import parse_collectives
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return parse_collectives


@pytest.fixture
def fake_group():
    """An 8-rank process group of the ``fake`` backend, this process rank 0,
    destroyed after the test."""
    import torch.distributed as dist

    dryrun.start_fake_group(8)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def four_rank_group():
    """A 4-rank process group of the ``fake`` backend, this process rank 0,
    destroyed after the test."""
    import torch.distributed as dist

    dryrun.start_fake_group(4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_of(shape, names):
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=names)


@pytest.mark.parametrize(("op", "hlo_op", "sig", "size"), [
    ("all-reduce", "all-reduce", "f32[1024]{0}", 4096),
    ("all-gather", "all-gather", "bf16[64,32]{1,0}", 4096),
    ("reduce-scatter", "reduce-scatter", "f32[16,8]{1,0}", 512),
    ("all-to-all", "all-to-all", "s32[4,256]{1,0}", 4096),
    ("collective-permute", "collective-permute", "f32[100]{0}", 400),
])
@pytest.mark.parametrize("group", [2, 4, 16])
def test_ring_factors_match_parse_collectives(op, hlo_op, sig, size, group):
    ids = ",".join(str(i) for i in range(group))
    line = (f"  %c.1 = {sig} {hlo_op}({sig} %p.0), channel_id=1, "
            f"replica_groups={{{{{ids}}}}}, to_apply=%add\n")
    want = reference_parse_collectives()(line)
    if op == "collective-permute":  # its groups are source-target pairs, not replica groups
        assert want == {op: float(size)}
    else:
        assert want == {op: pytest.approx(dryrun.ring_bytes(op, size, group))}
    assert dryrun.ring_bytes(op, size, group) == pytest.approx(want[op])


def test_collectives_are_recorded_with_their_group(fake_group):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = mesh_of((2, 4), ("data", "model"))
    x = distribute_tensor(torch.empty((64, 32), device="meta"), mesh, [Replicate(), Shard(0)],
                          src_data_rank=None)
    cost = dryrun.LocalCost()
    with cost:
        x.redistribute(mesh, [Replicate(), Replicate()])
    full = 64 * 32 * 4
    assert cost.collectives == {"all-gather": dryrun.ring_bytes("all-gather", full, 4)}


def test_flops_on_one_rank_equal_flop_counter_of_the_plain_step(fake_group):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.specs import input_specs
    from repro_torch.training import OptConfig, make_train_step

    cfg = reduced(ARCHS["qwen2.5-3b"])
    one = mesh_of((1, 1), ("data", "model"))
    got = dryrun.analyse(cfg, SMALL["train"], one)
    args = input_specs(cfg, SMALL["train"])
    args["params"].requires_grad_(True)
    with FlopCounterMode(display=False) as counter:
        make_train_step(cfg, OptConfig())(args["params"], args["opt_state"], args["batch"])
    assert got["flops"] == counter.get_total_flops() > 0
    assert got["collectives"] == {}


def test_depth_extrapolation_reproduces_the_full_depth_count(fake_group):
    """``cost(L) = d1 + (n_periods - 1) * (d2 - d1)``, the reference's formula,
    from depths 1 and 2 equals the count at depth 3 (eager torch runs every
    layer, so the port writes that count)."""
    mesh = mesh_of((2, 2), ("data", "model"))
    counts = {}
    for periods in (1, 2, 3):
        cfg = reduced(ARCHS["granite-8b"], periods=periods)
        counts[periods] = dryrun.analyse(cfg, SMALL["train"], mesh)
    d1, d2, d3 = (counts[k]["flops"] for k in (1, 2, 3))
    assert d1 < d2 < d3
    assert d1 + 2 * (d2 - d1) == d3


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-236b"])
def test_reduced_cells_over_a_small_fake_mesh(arch, fake_group, tmp_path):
    """Every kind of step runs over a (pod 2, data 2, model 2) mesh; the
    record has the reference's keys, per-device bytes and flops."""
    mesh = mesh_of((2, 2, 2), ("pod", "data", "model"))
    cfg = reduced(ARCHS[arch])
    for kind, shape in SMALL.items():
        got = dryrun.analyse(cfg, shape, mesh)
        mem = got["memory"]
        assert mem["argument_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
        assert mem["temp_size_in_bytes"] > 0 and got["bytes_accessed"] > 0, kind
        assert got["flops"] > 0, kind
    rec = dryrun.run_cell(arch, "decode_32k", True, tmp_path,
                          cfg_override=dataclasses.replace(cfg, compute_dtype="float32"),
                          mesh=mesh)
    assert rec["ok"], rec.get("error")
    assert KEYS <= set(rec)
    assert json.loads((tmp_path / f"{arch}__decode_32k__pod2x16x16.json").read_text()) == rec


def test_command_line_runs_a_full_width_cell(tmp_path):
    """``main`` in a process of its own (it starts the 512-rank fake group):
    Qwen2.5-3B's decode cell on both production meshes, then the cache."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD_ENV)
    args = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2.5-3b",
            "--shape", "decode_32k", "--mesh", "both", "--out", str(tmp_path)]
    proc = subprocess.run(args, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "PASS qwen2.5-3b decode_32k pod16x16" in proc.stdout
    assert "PASS qwen2.5-3b decode_32k pod2x16x16" in proc.stdout
    assert "dry-run complete: 2 pass / 0 fail" in proc.stdout
    assert proc.stdout.count("GiB temp=") == 2
    for name in ("pod16x16", "pod2x16x16"):
        rec = json.loads((tmp_path / f"qwen2.5-3b__decode_32k__{name}.json").read_text())
        assert KEYS <= set(rec) and rec["ok"] and rec["memory"]["argument_size_in_bytes"] > 0
        for n in (rec["memory"]["temp_size_in_bytes"], rec["bytes_accessed"]):
            assert isinstance(n, int) and n > 0
    again = subprocess.run(args, capture_output=True, text=True, env=env, timeout=300)
    assert again.returncode == 0 and "(cached)" in again.stdout


def linear_step(x, w):
    """One linear layer, forward and backward: the gradient of
    ``sum(x @ w.T)`` with respect to ``w``."""
    y = torch.mm(x, w.t())
    loss = y.sum()
    (grad,) = torch.autograd.grad(loss, [w])
    return grad


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_linear_layer_counts_what_was_worked_out_by_hand(device):
    """x [4, 8] and w [16, 8] in float32 (128 and 512 bytes).  The
    operations: ``t(w)`` and ``expand`` and the ``t`` s of the backward are
    views (0 bytes); ``mm(x, w.T)`` reads 128 + 512 and writes y [4, 16]
    (256): 896; ``sum(y)`` reads 256 and writes 4: 260; the seed gradient
    ``ones_like(loss)`` reads 4 and writes 4: 8; the backward's
    ``mm(x.T, ones.expand(4, 16))`` reads 128 + 256 and writes the gradient
    [8, 16] (512): 896.  2060 bytes in all.  The created storages are y
    (256), loss (4), the seed (4) and the gradient (512); the gradient is
    the output, and the other three are alive together when the seed is
    made: 264 bytes of temporaries."""
    x = torch.randn(4, 8, device=device)
    w = torch.randn(16, 8, device=device, requires_grad=True)
    got = dryrun.run_step(linear_step, (x, w), None, True)
    assert got["memory"] == {"argument_size_in_bytes": 128 + 512, "output_size_in_bytes": 512,
                             "temp_size_in_bytes": 264, "generated_code_size_in_bytes": None}
    assert got["bytes_accessed"] == 896 + 260 + 8 + 896
    assert got["flops"] == 2 * (2 * 4 * 8 * 16)
    assert got["collectives"] == {}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_linear_layer_on_a_one_rank_mesh_counts_the_same(device, four_rank_group):
    """The same layer with ``x`` and ``w`` replicated ``DTensor`` s over a
    one-rank mesh: the local operations are the plain ones.  DTensor's
    shape propagation builds global fake copies of the operands (``mm``'s
    128 + 512 bytes, with ``empty_strided``, a factory); were they counted,
    the temporaries would be 776 bytes."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh = mesh_of((1, 1), ("data", "model"))
    rep = [Replicate(), Replicate()]
    x = distribute_tensor(torch.randn(4, 8, device=device), mesh, rep, src_data_rank=None)
    w = distribute_tensor(torch.randn(16, 8, device=device), mesh, rep, src_data_rank=None)
    got = dryrun.run_step(linear_step, (x, w.requires_grad_(True)), mesh, True)
    assert got["memory"]["temp_size_in_bytes"] == 264
    assert got["bytes_accessed"] == 2060 and got["flops"] == 2048


def real_train_args(cfg, shape):
    """The train step's arguments on the CPU, drawn from a seed."""
    import numpy as np

    from repro_torch.launch.train import train_batch
    from repro_torch.models.model import init_model
    from repro_torch.training import adamw_init

    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    params.requires_grad_(True)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (shape.global_batch, shape.seq_len))
    return params, adamw_init(params), train_batch(cfg, tokens, "cpu")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-236b"])
def test_the_tracker_on_meta_equals_it_on_cpu_tensors(arch):
    """One device's train step (``mesh=None``): on ``meta`` tensors, as the
    dry run runs it, and on real CPU tensors, every count is the same."""
    from repro_torch.training import OptConfig, make_train_step

    cfg = reduced(ARCHS[arch])
    meta = dryrun.analyse(cfg, SMALL["train"], None)
    real = dryrun.run_step(make_train_step(cfg, OptConfig()), real_train_args(cfg, SMALL["train"]),
                           None, True)
    meta.pop("seconds"), real.pop("seconds")
    assert meta == real
    assert meta["memory"]["temp_size_in_bytes"] > 0 and meta["bytes_accessed"] > 0


def test_remat_keeps_fewer_temporaries_than_no_remat():
    cfg = reduced(ARCHS["granite-8b"])
    temp = {policy: dryrun.analyse(dataclasses.replace(cfg, remat_policy=policy), SMALL["train"],
                                   None)["memory"]["temp_size_in_bytes"]
            for policy in ("none", "dots", "full")}
    assert temp["none"] > temp["dots"] > temp["full"] > 0


def test_the_backward_is_counted(four_rank_group):
    """Without remat the train step's products are the forward's three times
    over (the forward, and two products a product in the backward): what
    the backward runs reaches the counts, on whatever thread autograd runs
    it, on the plain path and on a one-rank mesh."""
    from repro_torch.training import loss_fn

    cfg = dataclasses.replace(reduced(ARCHS["qwen2.5-3b"]), remat_policy="none")
    for mesh in (None, mesh_of((1, 1), ("data", "model"))):
        step = dryrun.analyse(cfg, SMALL["train"], mesh)
        fn, (params, _, batch) = dryrun._step_and_args(cfg, SMALL["train"], mesh)
        fwd = dryrun.run_step(lambda p, b: loss_fn(p, cfg, b)[0], (params, batch), mesh, True)
        assert step["flops"] == 3 * fwd["flops"] > 0
        assert step["memory"]["temp_size_in_bytes"] > fwd["memory"]["temp_size_in_bytes"]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-236b"])
def test_a_one_rank_mesh_creates_the_plain_steps_temporaries(arch, four_rank_group):
    """At world 1 each shard is the whole tensor, so the mesh path creates
    the plain step's storages, to within a scalar or two, and runs the same
    products.  DTensor's shape propagation makes global fake tensors of its
    own (factories too, with no tensor among their inputs): they are left
    out."""
    cfg = reduced(ARCHS[arch])
    plain = dryrun.analyse(cfg, SMALL["train"], None)
    mesh = dryrun.analyse(cfg, SMALL["train"], mesh_of((1, 1), ("data", "model")))
    assert mesh["flops"] == plain["flops"]
    assert abs(mesh["memory"]["temp_size_in_bytes"] - plain["memory"]["temp_size_in_bytes"]) <= 16


def test_a_tracker_error_fails_the_cell(four_rank_group, tmp_path, monkeypatch):
    """The cell is written with its traceback and ``ok`` false, never with a
    ``null`` where the tracker's count belongs."""
    def broken(self, outputs=()):
        raise RuntimeError("tracker broke")

    monkeypatch.setattr(dryrun.LocalCost, "temp_bytes", broken)
    cfg = reduced(ARCHS["qwen2.5-3b"])
    rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", False, tmp_path, cfg_override=cfg,
                          mesh=mesh_of((1, 1), ("data", "model")))
    assert not rec["ok"] and "RuntimeError: tracker broke" in rec["error"]
    assert "memory" not in rec and "bytes_accessed" not in rec
    assert json.loads((tmp_path / "qwen2.5-3b__decode_32k__pod16x16.json").read_text()) == rec


# ---------------------------------------------------------------------------
# each device's share of the work
# ---------------------------------------------------------------------------
SHARE = {"train": InputShape("train_share", 256, 8, "train"),
         "prefill": InputShape("prefill_share", 256, 8, "prefill")}
SHARE_MESHES = {"2x4": ((2, 4), ("data", "model")),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
#: the most a dense arch's per-device flops times the ranks may exceed one
#: device's: attention, the logits head and the cross-entropy run on each
#: rank's share of the batch, heads and vocabulary
EVEN_SHARE = 1.02


@functools.lru_cache(maxsize=None)
def one_device_flops(arch: str, kind: str) -> float:
    return dryrun.analyse(reduced(ARCHS[arch]), SHARE[kind], None)["flops"]


def share_ratio(arch: str, kind: str, mesh_name: str) -> float:
    """Per-device flops times the 8 ranks of ``mesh_name`` over one device's
    flops, of the reduced ``arch``'s step at 8 x 256."""
    shape, names = SHARE_MESHES[mesh_name]
    got = dryrun.analyse(reduced(ARCHS[arch]), SHARE[kind], mesh_of(shape, names))
    return got["flops"] * 8 / one_device_flops(arch, kind)


@pytest.mark.parametrize("mesh_name", list(SHARE_MESHES))
@pytest.mark.parametrize("kind", list(SHARE))
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-8b", "seamless-m4t-large-v2",
                                  "llama-3.2-vision-90b"])
def test_each_device_computes_its_share(arch, kind, mesh_name, fake_group):
    """A dense arch's step over 8 ranks does the one-device step's products
    once in all, to within ``EVEN_SHARE``: no rank repeats another's
    attention heads, logits or weight gradients."""
    assert share_ratio(arch, kind, mesh_name) <= EVEN_SHARE


#: the JAX package's per-device flops (XLA's cost analysis of the compiled
#: SPMD step) times the ranks over its one-device flops, on 8 host devices
REFERENCE_SHARE_CODE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()  # the backend comes up with 8 devices before repro's dryrun sets 512
import numpy as np
from repro.configs import ARCHS, reduced
from repro.configs.base import InputShape
from repro.distributed.context import set_active_mesh
from repro.launch import dryrun

cfg = reduced(ARCHS[sys.argv[1]])
shape = InputShape("train_share", 256, 8, "train")
flops = {}
for name, dims, axes in (("1", (1, 1), ("data", "model")), ("2x4", (2, 4), ("data", "model")),
                         ("2x2x2", (2, 2, 2), ("pod", "data", "model"))):
    n = int(np.prod(dims))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(dims), axes)
    set_active_mesh(mesh)
    try:
        with mesh:
            flops[name] = dryrun._analyse(cfg, shape, mesh)["cost"]["flops"] * n
    finally:
        set_active_mesh(None)
print(json.dumps({k: v / flops["1"] for k, v in flops.items() if k != "1"}))
"""


@pytest.fixture(scope="module")
def reference_shares():
    """The reference's share ratios of the reduced Qwen2.5-3B's train step
    on (2, 4) and (2, 2, 2), computed in a process of its own (JAX must
    start with 8 host devices)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", **ONE_THREAD_ENV)
    proc = subprocess.run([sys.executable, "-c", REFERENCE_SHARE_CODE, "qwen2.5-3b"],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("mesh_name", list(SHARE_MESHES))
def test_share_is_no_worse_than_the_reference(mesh_name, reference_shares, fake_group):
    """Qwen2.5-3B reduced, a train step at 8 x 256: the port repeats no
    more of the one-device step's products than GSPMD's layout of the
    reference does (1.0715 on (2, 4) and 1.0296 on (2, 2, 2) with JAX 0.9;
    its count includes elementwise work, the port's products only)."""
    want = reference_shares[mesh_name]
    assert 1.0 <= want < 1.2
    assert share_ratio("qwen2.5-3b", "train", mesh_name) <= want


def test_the_loss_creates_no_storage_larger_than_the_local_logits(fake_group):
    """The gather cross-entropy gathers the vocabulary only: on (2, 4) the
    largest storage the train step creates on a device holds at most the
    local batch's float32 logits (replicating them would hold all 8
    sequences')."""
    from repro_torch.distributed.context import mesh_scope

    cfg = reduced(ARCHS["qwen2.5-3b"])
    shape, names = SHARE_MESHES["2x4"]
    mesh = mesh_of(shape, names)
    fn, args = dryrun._step_and_args(cfg, SHARE["train"], mesh)
    cost = dryrun.LocalCost(dryrun._local_leaves(list(args)))
    with cost, mesh_scope(mesh), torch.enable_grad():
        fn(*args)
    local_batch = SHARE["train"].global_batch // shape[0]
    largest = max(size for size, _, _ in cost._made)
    assert largest <= local_batch * SHARE["train"].seq_len * cfg.vocab_size * 4
