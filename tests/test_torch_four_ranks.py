"""The port's mesh path on four gloo ranks of the CPU.

``tests/torch_mesh_worker.py`` runs four gloo ranks with a ``(data 2, model
2)`` mesh; the reduced granite-8b and DeepSeek-V2 in float32 are trained,
decoded and checkpointed there and held against the one-device port from
the same parameters, with the bounds of ``tests/test_torch_training.py``:
the products sum in another order on the mesh (partial sums over "model",
gathered halves), so after two train steps the parameters are held within
2e-5 (at learning rate 3e-4 a flipped gradient sign moves an element by
about 3e-4; measured at most 1.1e-5), ``m`` and ``v`` within 1e-5 of each
leaf's largest element, the loss, aux loss and gradient norm within ``rtol
= 1e-5``; the greedy tokens and the hot-tier checkpoint files are equal.
Each branch of ``local_attention`` (query heads or rows per rank) runs there
too, in float64, against the plain call.

The module imports neither JAX nor the JAX package, so it collects on a
machine without JAX: ``chip_smoke.py`` phase 1d runs it there under the
card machine's own torch release.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_threads import ONE_THREAD_ENV, one_thread

one_thread()  # six test workers with a thread per core each oversubscribe the CPU
pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]


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


@pytest.mark.parametrize("case", ["grouped", "one_kv_head", "kv_head_per_two_ranks",
                                  "kv_per_query_head", "rows", "rows_offset", "replicated",
                                  "mlstm_heads", "mlstm_rows"])
def test_four_rank_attention_on_local_shards_equals_the_plain_call(case, four_ranks):
    """Attention and the parallel mLSTM on each rank's share (its batch rows
    and query heads, or query rows) in float64: the output and every
    operand's gradient equal the plain call's but for the order of the
    gradient's sums over ranks (relative to each tensor's largest element or 1)."""
    assert four_ranks[1]["attention"][case] <= 1e-12
