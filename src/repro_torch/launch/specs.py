"""Abstract stand-ins for every model input (no device allocation).

The port's copy of the JAX package's ``launch/specs.py``: tensors on the
``meta`` device take the place of ``jax.ShapeDtypeStruct``; they carry shape
and dtype, and the model runs on them (the dry run places them as
``DTensor`` s and runs the step).  ``input_specs(cfg, shape)`` returns the
abstract arguments of the step function selected by the shape kind:

* ``train``   -> (params, opt_state, batch)            for ``train_step``
* ``prefill`` -> (params, batch)                       for ``prefill``
* ``decode``  -> (params, cache, tokens, pos)          for ``serve_step``

Stub modality frontends: the audio encoder consumes precomputed frame
embeddings, the VLM consumes precomputed projected patch embeddings.
"""

from __future__ import annotations

import torch

from ..configs.base import InputShape
from ..models.common import ModelConfig
from ..models.model import ParamTree, init_cache, init_model
from ..training.optimizer import adamw_init

__all__ = ["abstract_params", "abstract_opt_state", "batch_specs", "abstract_cache",
           "input_specs"]

META = "meta"


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def abstract_params(cfg: ModelConfig) -> ParamTree:
    """The parameter tree on ``meta`` (no memory)."""
    return init_model(torch.Generator(), cfg, device=META)


def abstract_opt_state(cfg: ModelConfig, params_abs=None) -> dict:
    params_abs = params_abs if params_abs is not None else abstract_params(cfg)
    return adamw_init(params_abs)


def batch_specs(cfg: ModelConfig, shape: InputShape) -> dict[str, torch.Tensor]:
    """Training/prefill batch stand-ins."""
    B, L = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((B, L), torch.int32)}
    if cfg.enc_layers:
        batch["enc_embeds"] = _sds((B, cfg.num_enc_frames, cfg.d_model), cfg.cdtype)
    if cfg.num_vision_tokens:
        batch["vision_embeds"] = _sds((B, cfg.num_vision_tokens, cfg.d_model), cfg.cdtype)
    return batch


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    return init_cache(cfg, batch, max_len, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Abstract step-function arguments for an (arch x input-shape) cell."""
    params = abstract_params(cfg)
    if shape.kind == "train":
        return {
            "params": params,
            "opt_state": abstract_opt_state(cfg, params),
            "batch": batch_specs(cfg, shape),
        }
    if shape.kind == "prefill":
        return {"params": params, "batch": batch_specs(cfg, shape)}
    if shape.kind == "decode":
        B = shape.global_batch
        return {
            "params": params,
            "cache": abstract_cache(cfg, B, shape.seq_len),
            "tokens": _sds((B, 1), torch.int32),
            "pos": _sds((), torch.int32),
        }
    raise ValueError(shape.kind)
