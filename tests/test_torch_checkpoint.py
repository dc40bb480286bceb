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
