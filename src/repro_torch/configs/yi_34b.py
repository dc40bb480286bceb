"""Yi-34B — llama-style dense GQA decoder [arXiv:2403.04652; hf]."""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
)
