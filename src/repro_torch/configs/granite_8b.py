"""IBM Granite-8B (code) — llama-style dense decoder [arXiv:2405.04324; hf]."""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10_000.0,
)
