"""Jamba-v0.1-52B — Mamba+attention 1:7 hybrid with MoE every other layer
[arXiv:2403.19887; hf].  One scanned period = 8 layers with attention at
position 4 (the Jamba paper's placement); MoE on odd positions."""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_every=2,
    block_pattern=(
        "mamba", "mamba", "mamba", "mamba",
        "attn", "mamba", "mamba", "mamba",
    ),
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
)
