"""Kimi K2 (1T total / 32B active) — trillion-parameter MoE per the
paper-table assignment [arXiv:2501.kimi2; unverified]: 61L, GQA 64H/kv8,
384 experts top-8 with d_ff=2048 per expert, one shared expert, first layer
dense."""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    top_k=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_k_dense=1,
    dense_d_ff=18432,
    rope_theta=50_000.0,
)
