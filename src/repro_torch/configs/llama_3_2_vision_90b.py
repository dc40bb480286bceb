"""Llama-3.2-Vision-90B — dense decoder with cross-attention image layers
every 5th layer [hf:meta-llama/Llama-3.2-90B-Vision; unverified].  The vision
tower is a stub: ``input_specs`` provides precomputed, projected patch
embeddings (1601 tokens) that the ``xattn`` layers attend to."""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "xattn"),
    num_vision_tokens=1601,
    rope_theta=500_000.0,
)
