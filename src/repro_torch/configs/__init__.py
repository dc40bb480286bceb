"""Architecture registry: ``--arch <id>`` resolves here."""

from .base import SHAPES, InputShape, reduced, runnable_shapes
from .granite_8b import CONFIG as GRANITE_8B
from .deepseek_coder_33b import CONFIG as DEEPSEEK_CODER_33B
from .qwen2_5_3b import CONFIG as QWEN2_5_3B
from .yi_34b import CONFIG as YI_34B
from .jamba_v0_1_52b import CONFIG as JAMBA_V0_1_52B
from .xlstm_1_3b import CONFIG as XLSTM_1_3B
from .kimi_k2_1t_a32b import CONFIG as KIMI_K2_1T_A32B
from .deepseek_v2_236b import CONFIG as DEEPSEEK_V2_236B
from .seamless_m4t_large_v2 import CONFIG as SEAMLESS_M4T_LARGE_V2
from .llama_3_2_vision_90b import CONFIG as LLAMA_3_2_VISION_90B

ARCHS = {
    c.arch_id: c
    for c in [
        GRANITE_8B,
        DEEPSEEK_CODER_33B,
        QWEN2_5_3B,
        YI_34B,
        JAMBA_V0_1_52B,
        XLSTM_1_3B,
        KIMI_K2_1T_A32B,
        DEEPSEEK_V2_236B,
        SEAMLESS_M4T_LARGE_V2,
        LLAMA_3_2_VISION_90B,
    ]
}

__all__ = ["ARCHS", "SHAPES", "InputShape", "reduced", "runnable_shapes"]
