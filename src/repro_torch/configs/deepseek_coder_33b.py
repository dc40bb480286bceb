"""DeepSeek-Coder-33B — llama-style dense decoder [arXiv:2401.14196; hf]."""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
)
