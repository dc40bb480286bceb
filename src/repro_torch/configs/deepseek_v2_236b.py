"""DeepSeek-V2-236B — MLA (kv_lora=512) + fine-grained MoE: 160 routed
experts top-6, 2 shared experts, first layer dense [arXiv:2405.04434; hf]."""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    num_experts=160,
    top_k=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    first_k_dense=1,
    dense_d_ff=12288,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
)
