"""The port's sharding rules, mesh hints, gradient compression and production
meshes against the JAX package's, and its mesh path on four gloo ranks.

The reference meshes are built the JAX 0.9 way, ``AbstractMesh(shape,
names)``; the port's rules read the same axis sizes from a dict.  Specs are
compared entry by entry after normalising an entry to the tuple of axes it
names (JAX writes a one-axis tuple as the axis itself).  The port's
per-rank shard shapes come from its DTensor placements over the production
``DeviceMesh`` es, on a 512-rank process group of the ``fake`` backend.

The four-rank run (``tests/torch_mesh_worker.py``: gloo, a ``(data 2,
model 2)`` mesh, the reduced granite-8b and DeepSeek-V2 in float32) is held
against the one-device port from the same parameters, with the bounds of
``tests/test_torch_training.py``: the products sum in another order on the
mesh (partial sums over "model", gathered halves), so after two train steps
the parameters are held within 2e-5 (at learning rate 3e-4 a flipped
gradient sign moves an element by about 3e-4; measured at most 1.1e-5),
``m`` and ``v`` within 1e-5 of each leaf's largest element, the loss, aux
loss and gradient norm within ``rtol = 1e-5``; the greedy tokens and the
hot-tier checkpoint files are equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import runnable_shapes as ref_runnable
from repro.distributed import compression as ref_comp
from repro.distributed import sharding as ref_sharding
from repro.launch import specs as ref_specs
from repro.launch import train as ref_train
from repro_torch.configs import ARCHS, SHAPES, runnable_shapes
from repro_torch.distributed.checkpoint import named_leaves
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding
from repro_torch.distributed.context import active_mesh, mesh_scope, set_active_mesh, shard_hint
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import specs
from repro_torch.launch import train as port_train
from torch_threads import ONE_THREAD_ENV, one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def ref_mesh(name):
    return AbstractMesh(*MESHES[name])


def port_mesh_sizes(name):
    shape, names = MESHES[name]
    return dict(zip(names, shape))


def norm(spec):
    return [None if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec]


def ref_named(tree, specs_tree):
    """``{leaf name: (abstract leaf, spec)}`` of a reference tree and its spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree_util.tree_leaves(specs_tree, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for (path, leaf), spec in zip(leaves, spec_leaves):
        name = "::".join(str(k.key) if hasattr(k, "key") else str(k.idx) for k in path)
        out[name] = (leaf, spec)
    return out


def guarded(ref_tree, ref_specs, port_tree, port_specs, name):
    """Both packages' specs, guarded by ``safe_pspec`` on mesh ``name``:
    ``{leaf: (shape, ref spec, port spec)}``."""
    mesh, sizes = ref_mesh(name), port_mesh_sizes(name)
    ref = {n: (tuple(leaf.shape), norm(ref_sharding.safe_pspec(s, leaf.shape, mesh)))
           for n, (leaf, s) in ref_named(ref_tree, ref_specs).items()}
    port = {n: (tuple(leaf.shape), norm(sharding.safe_pspec(port_specs[n], leaf.shape, sizes)))
            for n, leaf in named_leaves(port_tree)}
    assert list(ref) == list(port)
    return {n: (ref[n][0], ref[n][1], port[n][1]) for n in ref if ref[n][0] == port[n][0]}


def assert_specs_equal(table):
    bad = {n: (r, p) for n, (_, r, p) in table.items() if r != p}
    assert bad == {}


@pytest.fixture(scope="module")
def param_trees():
    return {arch: (ref_specs.abstract_params(REF_ARCHS[arch]), specs.abstract_params(ARCHS[arch]))
            for arch in ARCHS}


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------
def test_rule_tables_are_the_references():
    assert [(s, norm(p)) for s, p in ref_sharding._PARAM_RULES] == \
        [(s, norm(p)) for s, p in sharding._PARAM_RULES]
    assert len(sharding._PARAM_RULES) == 43
    for name in MESHES:
        assert sharding.dp_axes(port_mesh_sizes(name)) == ref_sharding.dp_axes(ref_mesh(name))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_match_reference(arch, mesh, param_trees):
    """Every leaf at full width, guarded on the production mesh."""
    ref_tree, port_tree = param_trees[arch]
    table = guarded(ref_tree, ref_sharding.param_pspecs(ref_tree), port_tree,
                    sharding.param_pspecs(port_tree), mesh)
    assert len(table) == len(named_leaves(port_tree))
    assert_specs_equal(table)


#: the decode cells: ``long_500k`` only where it is runnable (the sub-quadratic archs)
DECODE_CELLS = [(arch, shape) for arch in ARCHS for shape in ("decode_32k", "long_500k")
                if shape in runnable_shapes(ARCHS[arch])]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize(("arch", "shape"), DECODE_CELLS)
def test_cache_specs_match_reference(arch, shape, mesh):
    assert sorted(ref_runnable(REF_ARCHS[arch])) == sorted(runnable_shapes(ARCHS[arch]))
    s = SHAPES[shape]
    ref_tree = ref_specs.abstract_cache(REF_ARCHS[arch], s.global_batch, s.seq_len)
    port_tree = specs.abstract_cache(ARCHS[arch], s.global_batch, s.seq_len)
    table = guarded(ref_tree, ref_sharding.cache_pspecs(ref_tree, ref_mesh(mesh)), port_tree,
                    sharding.cache_pspecs(port_tree, port_mesh_sizes(mesh)), mesh)
    assert len(table) == len(named_leaves(port_tree))
    assert_specs_equal(table)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_specs_match_reference(arch, mesh):
    for name in SHAPES:
        ref_tree = ref_specs.batch_specs(REF_ARCHS[arch], REF_SHAPES[name])
        port_tree = specs.batch_specs(ARCHS[arch], SHAPES[name])
        table = guarded(ref_tree, ref_sharding.batch_pspecs(ref_tree, ref_mesh(mesh)), port_tree,
                        sharding.batch_pspecs(port_tree, port_mesh_sizes(mesh)), mesh)
        assert len(table) == len(port_tree)
        assert_specs_equal(table)


def test_abstract_specs_match_reference():
    """``input_specs`` of every kind: the same leaves, shapes and dtypes."""
    arch = "seamless-m4t-large-v2"
    for name, shape in SHAPES.items():
        ref = ref_specs.input_specs(REF_ARCHS[arch], REF_SHAPES[name])
        port = specs.input_specs(ARCHS[arch], shape)
        assert sorted(ref) == sorted(port)
        for key in ref:
            if key == "pos":
                assert tuple(port[key].shape) == ref[key].shape == ()
                continue
            want = {n: (tuple(leaf.shape), str(leaf.dtype))
                    for n, (leaf, _) in ref_named(ref[key], jax.tree.map(lambda _: P(), ref[key]))
                    .items()}
            got = {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                   for n, t in named_leaves(port[key])}
            assert got == want, (name, key)
    opt = specs.abstract_opt_state(ARCHS[arch])
    assert opt["step"].dtype == torch.int32 and opt["m"]["embed"].device.type == "meta"


# ---------------------------------------------------------------------------
# placements over the production DeviceMeshes
# ---------------------------------------------------------------------------
@pytest.fixture
def production_meshes():
    """Both production meshes over a 512-rank fake process group, destroyed
    after the test (the tests without one see no process group)."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import start_fake_group

    start_fake_group(512)
    try:
        yield {name: port_mesh.make_production_mesh(multi_pod=name == "pod2x16x16",
                                                    device_type="cpu")
               for name in MESHES}
    finally:
        dist.destroy_process_group()


class TestOverProductionMeshes:
    """Tests over the production ``DeviceMesh`` es of a fake process group."""

    @pytest.mark.parametrize("mesh", list(MESHES))
    @pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-236b", "jamba-v0.1-52b",
                                      "llama-3.2-vision-90b"])
    def test_shard_shapes_match_named_sharding(self, arch, mesh, param_trees, production_meshes):
        """Each leaf's shard on rank 0, from the port's placements, equals
        ``NamedSharding(mesh, spec).shard_shape``: parameters, the decode cache
        and a training batch."""
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        device_mesh = production_meshes[mesh]
        assert dict(zip(device_mesh.mesh_dim_names, device_mesh.shape)) == port_mesh_sizes(mesh)
        s = SHAPES["decode_32k"]
        params = param_trees[arch][1]
        cache = specs.abstract_cache(ARCHS[arch], s.global_batch, s.seq_len)
        batch = specs.batch_specs(ARCHS[arch], SHAPES["train_4k"])
        n = 0
        for tree, tree_specs in ((params, sharding.param_pspecs(params)),
                                 (cache, sharding.cache_pspecs(cache, device_mesh)),
                                 (batch, sharding.batch_pspecs(batch, device_mesh))):
            for name, leaf in named_leaves(tree):
                spec = sharding.safe_pspec(tree_specs[name], leaf.shape, device_mesh)
                placements = sharding.to_placements(spec, device_mesh)
                local, _ = compute_local_shape_and_global_offset(
                    leaf.shape, sharding.layout_mesh(device_mesh), placements)
                ref_spec = P(*spec)
                assert tuple(local) == NamedSharding(ref_mesh(mesh), ref_spec).shard_shape(
                    tuple(leaf.shape)), (name, spec)
                n += 1
        assert n > 10
        placed = sharding.place(torch.empty((256, 4096), device="meta"),
                                (("pod", "data") if mesh == "pod2x16x16" else "data", "model"),
                                device_mesh)
        assert tuple(placed.to_local().shape) == (256 // (32 if mesh == "pod2x16x16" else 16), 256)

    def test_replicated_grad_replicates_the_gradient_alone(self, production_meshes):
        """``replicated_grad`` is the identity forward, the placement kept,
        and hands its input a replicated gradient (so the dense MoE
        dispatch's index operations run their backward on whole tensors); a
        plain tensor comes back as it is."""
        from torch.distributed.tensor import Replicate

        from repro_torch.distributed.context import replicated_grad

        plain = torch.ones(3, requires_grad=True)
        assert replicated_grad(plain) is plain
        mesh = production_meshes["pod16x16"]
        x = sharding.place(torch.empty((256, 64), device="meta"), ("data", None), mesh)
        x.requires_grad_(True)
        y = replicated_grad(x)
        assert y.placements == x.placements and y.shape == x.shape
        (g,) = torch.autograd.grad(y, x, torch.ones_like(y))
        assert g.placements == (Replicate(), Replicate()) and g.shape == x.shape

    def test_production_mesh_shapes(self, production_meshes):
        for name, (shape, names) in MESHES.items():
            assert tuple(production_meshes[name].shape) == shape
            assert production_meshes[name].mesh_dim_names == names
        assert port_mesh.PODS == 2 and port_mesh.POD_SHAPE == (16, 16)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_raises_as_reference_without_ranks(multi_pod):
    """No process group here: one rank, as the reference sees one device."""
    import repro.launch.mesh as ref_mesh_mod

    with pytest.raises(RuntimeError) as ref_err:
        ref_mesh_mod.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError) as port_err:
        port_mesh.make_production_mesh(multi_pod=multi_pod)
    head = str(ref_err.value).split(" (")[0]
    assert str(port_err.value).split(" (")[0] == head
    assert "torchrun" in str(port_err.value)


# ---------------------------------------------------------------------------
# shard_hint and the active mesh
# ---------------------------------------------------------------------------
def test_shard_hint_is_the_identity_without_a_mesh():
    x = torch.randn(4, 6)
    assert active_mesh() is None
    assert shard_hint(x, lambda m: ("data", None)) is x
    with mesh_scope(None):
        assert shard_hint(x, lambda m: ("data", "model")) is x
    set_active_mesh({"data": 2, "model": 2})  # a mesh, but x is a plain tensor
    try:
        assert shard_hint(x, lambda m: ("data", None)) is x
    finally:
        set_active_mesh(None)


# ---------------------------------------------------------------------------
# gradient compression, exactly the reference's
# ---------------------------------------------------------------------------
def pair_compress(g: np.ndarray, ratio: float):
    vals, idx = ref_comp.topk_compress(jax.numpy.asarray(g), ratio)
    pvals, pidx = comp.topk_compress(torch.from_numpy(g), ratio)
    np.testing.assert_array_equal(np.asarray(idx), pidx.numpy())
    np.testing.assert_array_equal(np.asarray(vals), pvals.numpy())
    rec = ref_comp.topk_decompress(vals, idx, g.shape)
    np.testing.assert_array_equal(np.asarray(rec), comp.topk_decompress(pvals, pidx, g.shape).numpy())
    q, s = ref_comp.int8_compress(jax.numpy.asarray(g))
    pq, ps = comp.int8_compress(torch.from_numpy(g))
    np.testing.assert_array_equal(np.asarray(q), pq.numpy())
    assert float(s) == float(ps)
    np.testing.assert_array_equal(np.asarray(ref_comp.int8_decompress(q, s)),
                                  comp.int8_decompress(pq, ps).numpy())


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
def test_compressors_match_reference(ratio):
    rng = np.random.default_rng(3)
    pair_compress(rng.standard_normal((37, 29)).astype(np.float32), ratio)
    # ties: few distinct magnitudes (top_k keeps the lower index), exact halves for round
    ties = (rng.integers(-3, 4, (40, 25)) * 0.5).astype(np.float32)
    pair_compress(ties, ratio)
    pair_compress(np.zeros((8, 8), np.float32), ratio)


@pytest.mark.parametrize("method", ["topk", "int8"])
def test_error_feedback_matches_reference_over_ten_steps(method):
    rng = np.random.default_rng(5)
    shapes = {"a": (16, 12), "b": {"c": (7,), "d": (3, 5, 4)}}

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                rng.standard_normal(v).astype(np.float32) for k, v in tree.items()}

    first = draw(shapes)
    ref_ef = ref_comp.init_error_feedback(jax.tree.map(jax.numpy.asarray, first))
    ef = comp.init_error_feedback(jax.tree.map(torch.from_numpy, first))
    for step in range(10):
        grads = first if step == 0 else draw(shapes)
        ref_rec, ref_ef, ref_ratio = ref_comp.compressed_grads(
            jax.tree.map(jax.numpy.asarray, grads), ref_ef, method, ratio=0.1)
        before = ef
        rec, ef, ratio = comp.compressed_grads(jax.tree.map(torch.from_numpy, grads), ef,
                                               method, ratio=0.1)
        assert ratio == ref_ratio
        for tree, ref_tree in ((rec, ref_rec), (ef, ref_ef)):
            want = {n: np.asarray(v) for n, (v, _) in
                    ref_named(ref_tree, jax.tree.map(lambda _: P(), ref_tree)).items()}
            assert list(tree) == list(want)
            for name, value in tree.items():
                np.testing.assert_array_equal(value.numpy(), want[name], err_msg=f"{step} {name}")
        # reconstruction + residual = target (the gradient plus the carried residual)
        for name, g in named_leaves(jax.tree.map(torch.from_numpy, grads)):
            torch.testing.assert_close(rec[name] + ef[name], g + before[name], rtol=0, atol=1e-6)
        if method == "topk":  # the kept share
            kept = sum(int((v != 0).sum()) for v in rec.values())
            assert kept <= sum(max(1, int(v.numel() * 0.1)) for v in rec.values())


# ---------------------------------------------------------------------------
# the mesh path on four gloo ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD_ENV)
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
                           str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out, json.loads((out / "result.json").read_text())


def test_auto_mesh_at_four_ranks_is_the_references(four_ranks):
    _, result = four_ranks
    assert result["auto_mesh"] == {"data": 1, "model": 4}


@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-v2-236b"])
def test_four_rank_train_steps_match_one_device(arch, four_ranks):
    _, result = four_ranks
    r = result[arch]
    assert r["placed"] == ["DTensor"] and r["step"] == [2, 2]
    for step in r["losses"]:
        for key, (got, want) in step.items():
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=key)
    for name, (err, _) in r["params"].items():
        assert err <= 2e-5, name
    for tree in ("m", "v"):
        for name, (err, top) in r[tree].items():
            assert err <= 1e-5 * top + 1e-30, (tree, name)


@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-v2-236b"])
def test_four_rank_greedy_tokens_equal_one_device(arch, four_ranks):
    got, want = four_ranks[1][arch]["tokens"]
    assert got == want


@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-v2-236b"])
def test_four_rank_checkpoint_is_byte_identical(arch, four_ranks):
    out, _ = four_ranks
    mesh, plain = out / arch / "mesh", out / arch / "plain"
    names = sorted(p.name for p in plain.iterdir())
    assert sorted(p.name for p in mesh.iterdir()) == names and len(names) > 10
    for name in names:
        assert (mesh / name).read_bytes() == (plain / name).read_bytes(), name


# ---------------------------------------------------------------------------
# the launchers' mesh rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["pod", "multipod"])
def test_auto_mesh_production_kinds_raise_as_reference(kind):
    with pytest.raises(RuntimeError) as ref_err:
        ref_train._auto_mesh(kind)
    with pytest.raises(RuntimeError) as port_err:
        port_train._auto_mesh(kind)
    assert str(port_err.value).split(" (")[0] == str(ref_err.value).split(" (")[0]
