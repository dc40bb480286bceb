"""Qwen2.5-3B — dense GQA decoder with QKV bias, tied embeddings
[hf:Qwen/Qwen2.5-3B]."""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
