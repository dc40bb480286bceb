"""Carry a parameter tree across into the port's module tree.

JAX and torch draw different random numbers from the same seed, so the port
is held against the JAX package on the *same* weights: the reference's
parameters, brought to numpy (``jax.tree.map(np.asarray, params)``), are
copied into the module :func:`repro_torch.models.model.init_model` built.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from ..distributed.checkpoint import _laid_out_as, named_leaves


def load_params(model: nn.Module, tree) -> nn.Module:
    """Copy ``tree`` (nested dicts and lists of numpy arrays, named as the
    reference's pytree paths) into ``model``'s parameters; returns ``model``."""
    return load_named(model, dict(named_leaves(tree)))


def load_named(model: nn.Module, arrays: dict[str, Any]) -> nn.Module:
    """Copy ``arrays`` (``"a::b::c"`` name -> array) into ``model``'s
    parameters of the same names.  Refuses, naming them, a parameter that
    ``arrays`` lacks, an array that names no parameter, and an array of
    another shape or dtype; nothing is copied then.  A ``DTensor``
    parameter takes its own shard of its array."""
    params = dict(named_leaves(model))
    missing, extra = sorted(params.keys() - arrays.keys()), sorted(arrays.keys() - params.keys())
    if missing or extra:
        raise ValueError(f"parameter tree does not match the model: missing {missing}, "
                         f"extra {extra}")
    tensors = {name: torch.from_numpy(np.require(arrays[name], requirements=["C", "W"]))
               for name in params}
    bad = [f"{name}: {tuple(t.shape)} {t.dtype} for {tuple(params[name].shape)} "
           f"{params[name].dtype}" for name, t in tensors.items()
           if t.shape != params[name].shape or t.dtype != params[name].dtype]
    if bad:
        raise ValueError(f"parameter tree does not match the model: {bad}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(_laid_out_as(tensors[name], p))
    return model
