"""The port's tape-backed checkpoint restore against the JAX package's.

``archive_to_tape`` must name and size the leaves of a checkpoint exactly as
the reference's pytree flattening does (dict keys sorted, sequence indices,
``::`` between levels, ``None`` an empty subtree), for numpy arrays and torch
tensors alike, and ``plan_restore`` must produce the reference's read plan
for every policy, on ``python`` and on the port's ``torch`` backend.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.distributed import checkpoint as ref_ckpt
from repro.storage.tape import TapeLibrary as RefLibrary
from repro_torch.distributed import archive_to_tape, plan_restore
from repro_torch.distributed import checkpoint as port_ckpt
from repro_torch.storage.tape import TapeLibrary as PortLibrary
from torch_parity import TO_REF
from torch_threads import one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port


@pytest.fixture(scope="module")
def model_params():
    """The reference test's checkpoint: a reduced qwen2.5-3b, as numpy."""
    from repro.configs import ARCHS, reduced
    from repro.models.model import init_model

    params = init_model(jax.random.PRNGKey(0), reduced(ARCHS["qwen2.5-3b"], periods=1))
    return jax.tree.map(np.asarray, params)


def nested_tree(rng):
    return {
        "b": [rng.standard_normal((3, 2)), (rng.standard_normal(5), None),
              {"z": rng.standard_normal(1), "a": np.float32(2.0)}],
        "a": {"w": rng.standard_normal((4, 4)), "empty": None, 10: rng.standard_normal(2)},
        "c": (),
        "d": [[rng.standard_normal((2, 2, 2))]],
    }


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return tree if tree is None else torch.tensor(np.asarray(tree))


def names_and_sizes(flat):
    return [(name, int(np.asarray(leaf).size) if not isinstance(leaf, int) else leaf)
            for name, leaf in flat]


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_leaf_names_match_reference_flattening(kind, model_params):
    trees = [model_params, nested_tree(np.random.default_rng(0))]
    trees[1]["a"].pop(10)  # jax cannot sort mixed key types; keep the keys comparable
    for tree in trees:
        want = names_and_sizes(ref_ckpt._flatten_with_names(tree))
        got = port_ckpt._flatten_with_names(tree if kind == "numpy" else to_torch(tree))
        assert got == want
    # the reference test's count: one shard per leaf
    assert len(port_ckpt._flatten_with_names(model_params)) == len(jax.tree.leaves(model_params))


def plans(read_plans):
    """Read plans as plain data, the backend named as in the reference."""
    return [dict(dataclasses.asdict(p), backend=TO_REF.get(p.backend, p.backend))
            for p in read_plans]


def _archive(Library, archive, tree, u_turn=10_000):
    lib = Library(capacity_per_tape=10**9, u_turn=u_turn)
    return lib, archive(lib, "step100", tree)


@pytest.mark.parametrize("policy", ["dp", "simpledp", "logdp1", "gs", "nodetour"])
def test_restore_plans_match_reference(policy, model_params):
    ref_lib, ref_names = _archive(RefLibrary, ref_ckpt.archive_to_tape, model_params)
    port_lib, port_names = _archive(PortLibrary, archive_to_tape, to_torch(model_params))
    assert port_names == ref_names
    assert port_lib.location == ref_lib.location
    consumers = {s: 2 for s in ref_names}
    for s in ref_names[::5]:
        consumers[s] = 8
    ref_plans = ref_ckpt.plan_restore(ref_lib, ref_names, consumers, policy=policy)
    port_plans = plan_restore(port_lib, port_names, consumers, policy=policy)
    assert plans(port_plans) == plans(ref_plans)
    # the reference test's claim: the DP restore beats the naive sweep
    naive = plan_restore(port_lib, port_names, consumers, policy="nodetour")
    if policy == "dp":
        assert sum(p.total_cost for p in port_plans) <= sum(p.total_cost for p in naive)


def test_restore_on_the_plain_device_backend_matches_reference_interpret():
    """Several small cartridges, uniform consumers, solved on the port's
    ``torch`` backend against the reference's ``pallas-interpret``."""
    rng = np.random.default_rng(3)
    tree = {f"layer{i}": {"w": rng.standard_normal(int(rng.integers(200, 900))),
                          "b": rng.standard_normal(int(rng.integers(10, 60)))}
            for i in range(6)}
    ref_lib = RefLibrary(capacity_per_tape=6_000, u_turn=500)
    port_lib = PortLibrary(capacity_per_tape=6_000, u_turn=500)
    ref_names = ref_ckpt.archive_to_tape(ref_lib, "ckpt", tree)
    port_names = archive_to_tape(port_lib, "ckpt", to_torch(tree))
    assert port_names == ref_names and len(port_lib.tapes) >= 2
    ref_plans = ref_ckpt.plan_restore(ref_lib, ref_names, 3, policy="dp",
                                      context=ref_core.ExecutionContext(backend="pallas-interpret"))
    port_plans = plan_restore(port_lib, port_names, 3, policy="dp",
                              context=port_core.ExecutionContext(backend="torch", device="cpu"))
    assert plans(port_plans) == plans(ref_plans)


# ---------------------------------------------------------------------------
# hot tier: .npy leaves + manifest, read by either package
# ---------------------------------------------------------------------------
def port_model(model_params):
    """The port's reduced qwen2.5-3b module holding ``model_params``."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import init_model, load_params

    model = init_model(torch.Generator().manual_seed(0), reduced(ARCHS["qwen2.5-3b"], periods=1),
                       device="cpu")
    return load_params(model, model_params)


def written(path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.mark.parametrize("kind", ["module", "numpy", "torch"])
def test_hot_tier_writes_the_reference_bytes(kind, model_params, tmp_path):
    """Same file names, same ``.npy`` bytes and the same manifest, for the
    port's model and for nested containers (tuples, ``None``, scalars)."""
    nested = nested_tree(np.random.default_rng(1))
    nested["a"].pop(10)
    trees = {"params": model_params, "extra": nested}
    port_trees = {"params": port_model(model_params) if kind == "module" else
                  (to_torch(model_params) if kind == "torch" else model_params),
                  "extra": to_torch(nested) if kind == "torch" else nested}
    ref_ckpt.save_checkpoint(tmp_path / "ref", 12, **trees)
    port_ckpt.save_checkpoint(tmp_path / "port", 12, **port_trees)
    assert written(tmp_path / "port") == written(tmp_path / "ref")
    assert len(written(tmp_path / "ref")) == len(jax.tree.leaves(trees)) + 1


@pytest.mark.parametrize("template", ["module", "tree"])
def test_hot_tier_reference_saves_port_loads(template, model_params, tmp_path):
    ref_ckpt.save_checkpoint(tmp_path, 7, params=model_params)
    if template == "module":
        model = port_model(jax.tree.map(np.zeros_like, model_params))
        step, out = port_ckpt.load_checkpoint(tmp_path, params=model)
        assert out["params"] is model
    else:
        step, out = port_ckpt.load_checkpoint(tmp_path, params=model_params)
    assert step == 7
    got = dict(port_ckpt.named_leaves(out["params"]))
    want = dict(port_ckpt.named_leaves(model_params))
    assert list(got) == list(want)
    for name, arr in want.items():
        leaf = got[name]
        leaf = leaf.detach().numpy() if isinstance(leaf, torch.Tensor) else leaf
        assert leaf.dtype == arr.dtype and np.array_equal(leaf, arr), name


def test_hot_tier_port_saves_reference_loads(model_params, tmp_path):
    nested = nested_tree(np.random.default_rng(2))
    nested["a"].pop(10)
    port_ckpt.save_checkpoint(tmp_path, 9, params=port_model(model_params), extra=nested)
    step, out = ref_ckpt.load_checkpoint(tmp_path, params=model_params, extra=nested)
    assert step == 9
    for tree, template in ((out["params"], model_params), (out["extra"], nested)):
        assert jax.tree.structure(tree) == jax.tree.structure(template)
        for got, want in zip(jax.tree.leaves(tree), jax.tree.leaves(template)):
            want = np.asarray(want)
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_hot_tier_refuses_a_module_of_another_shape(model_params, tmp_path):
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import init_model

    ref_ckpt.save_checkpoint(tmp_path, 1, params=model_params)
    other = init_model(torch.Generator().manual_seed(0), reduced(ARCHS["granite-8b"], periods=1),
                       device="cpu")
    with pytest.raises(ValueError, match=r"missing \['lm_head'\]"):
        port_ckpt.load_checkpoint(tmp_path, params=other)
