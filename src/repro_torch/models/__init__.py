"""The language-model scaffolding of the port: config and primitives
(``common``), mixer and FFN blocks (``blocks``), model assembly with its
decode cache (``model``) and the weight carry-over from the JAX package's
parameter trees (``convert``).  Only the dense decoder's apply path is
ported; the other mixers have their parameters and caches and refuse to
apply (ROADMAP A9)."""

from .common import ModelConfig
from .convert import load_params
from .model import ParamTree, decode_step, forward, init_cache, init_model

__all__ = ["ModelConfig", "ParamTree", "decode_step", "forward", "init_cache", "init_model",
           "load_params"]
