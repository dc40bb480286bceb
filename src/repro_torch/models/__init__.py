"""The language-model scaffolding of the port: config and primitives
(``common``), mixer and FFN blocks (``blocks``), model assembly with its
decode cache (``model``) and the weight carry-over from the JAX package's
parameter trees (``convert``).  Every mixer of the ten architectures
applies, over the full sequence and at decode."""

from .common import ModelConfig
from .convert import load_params
from .model import (
    ParamTree,
    decode_step,
    encode,
    forward,
    init_cache,
    init_model,
    warm_cross_cache,
)

__all__ = ["ModelConfig", "ParamTree", "decode_step", "encode", "forward", "init_cache",
           "init_model", "load_params", "warm_cross_cache"]
