"""Checkpoint archive restore planned by the LTSP solvers (the tape half).

A checkpoint's shards are written sequentially to the simulated tape library
(:func:`archive_to_tape`).  A multi-pod restore requests every shard once per
consumer pod (that multiplicity is exactly LTSP's request multiplicity); the
restore read order is produced by the paper's DP/SimpleDP schedulers
(:func:`plan_restore`), minimising the *mean* shard arrival time so pods
start resharding work as early as possible instead of waiting for a
positional sweep.

Shard names follow the JAX package's pytree paths: nested ``dict``/``list``/
``tuple`` containers of numpy arrays or torch tensors flatten depth-first,
dict keys in sorted order, sequence entries by index, ``None`` as an empty
subtree, joined with ``::``.  The hot tier (``save_checkpoint``/
``load_checkpoint``) is not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..storage.tape import ReadPlan, TapeLibrary

__all__ = ["archive_to_tape", "plan_restore"]

_SEP = "::"


def _leaves(tree, path: tuple[str, ...] = ()):
    """``(path, leaf)`` pairs of a nested container, in pytree order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*path, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, (*path, str(i)))
    else:
        yield path, tree


def _numel(leaf: Any) -> int:
    return leaf.numel() if isinstance(leaf, torch.Tensor) else np.asarray(leaf).size


def _flatten_with_names(tree) -> list[tuple[str, int]]:
    """``(name, numel)`` of every leaf, in pytree order."""
    return [(_SEP.join(path), _numel(leaf)) for path, leaf in _leaves(tree)]


# ---------------------------------------------------------------------------
# archive tier (tape-backed) — the paper's technique as a framework feature
# ---------------------------------------------------------------------------
def archive_to_tape(
    library: TapeLibrary, ckpt_name: str, params, bytes_per_elem: int = 4
) -> list[str]:
    """Append every leaf of a checkpoint sequentially to the tape library."""
    names = []
    for leaf_name, numel in _flatten_with_names(params):
        fname = f"{ckpt_name}/{leaf_name}"
        library.store(fname, max(1, numel * bytes_per_elem))
        names.append(fname)
    return names


def plan_restore(
    library: TapeLibrary,
    shard_names: list[str],
    consumers_per_shard: int | dict[str, int] = 1,
    policy: str = "simpledp",
    backend: str | None = None,
    cache=None,
    *,
    context=None,
) -> list[ReadPlan]:
    """LTSP-scheduled restore: order shard reads to minimise mean arrival.

    ``consumers_per_shard`` is the request multiplicity (e.g. the number of
    pods that need the shard before they can start their reshard step).
    ``policy`` selects any registered solver; ``context`` (an
    :class:`repro_torch.core.ExecutionContext`, defaulting to the library's own)
    selects backend/cache/numeric options — with the library context carrying
    a :class:`repro_torch.core.SolveCache`, a restore re-planned against an
    unchanged archive is pure cache hits.  Device backends plan every
    cartridge in a few size-bucketed launches.  ``backend=``/``cache=`` are
    the deprecated pre-context spellings (warn, then fold into a context).
    """
    from ..core.context import resolve_context

    ctx = resolve_context(
        context, backend=backend, cache=cache, default=library.context
    )
    if isinstance(consumers_per_shard, int):
        requests = {n: consumers_per_shard for n in shard_names}
    else:
        requests = dict(consumers_per_shard)
    return library.schedule(requests, policy=policy, context=ctx)
