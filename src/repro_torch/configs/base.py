"""Config infrastructure: input shapes, reduced (smoke) configs, registry."""

from __future__ import annotations

import dataclasses

from ..models.common import ModelConfig

__all__ = ["InputShape", "SHAPES", "reduced", "runnable_shapes"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


#: The assigned LM shape grid (seq_len x global_batch).  ``decode_*`` /
#: ``long_*`` lower ``serve_step`` (one token against a seq_len KV cache).
SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def runnable_shapes(cfg: ModelConfig) -> dict[str, InputShape]:
    """Shapes applicable to an architecture.

    ``long_500k`` needs sub-quadratic sequence mixing: full-attention stacks
    would hold a 500k-token KV cache per layer, so the cell is skipped for
    them (DESIGN.md §Arch-applicability) and kept for SSM/hybrid stacks whose
    decode state is O(1) in sequence length.
    """
    out = dict(SHAPES)
    if not cfg.is_subquadratic:
        out.pop("long_500k")
    return out


def reduced(cfg: ModelConfig, periods: int = 2) -> ModelConfig:
    """Smoke-test-scale config of the same family (CPU-runnable).

    Keeps the layer pattern, MoE/MLA/cross structure and head grouping ratio;
    shrinks widths, depths, vocab and expert counts.
    """
    pat = cfg.block_pattern
    heads = 4
    kv = max(1, min(cfg.num_kv_heads, heads // max(1, cfg.num_heads // max(1, cfg.num_kv_heads))))
    kv = heads if cfg.num_kv_heads == cfg.num_heads else max(1, min(2, kv))
    return dataclasses.replace(
        cfg,
        num_layers=cfg.first_k_dense + periods * len(pat),
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        d_head=16 if cfg.d_head else 0,
        d_ff=cfg.d_ff and 128,
        dense_d_ff=cfg.dense_d_ff and 160,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 8),
        top_k=min(cfg.top_k, 2),
        num_shared_experts=min(cfg.num_shared_experts, 1),
        moe_d_ff=cfg.moe_d_ff and 96,
        q_lora_rank=cfg.q_lora_rank and 48,
        kv_lora_rank=cfg.kv_lora_rank and 32,
        qk_nope_dim=16 if cfg.use_mla else cfg.qk_nope_dim,
        qk_rope_dim=8 if cfg.use_mla else cfg.qk_rope_dim,
        v_head_dim=16 if cfg.use_mla else cfg.v_head_dim,
        enc_layers=min(cfg.enc_layers, 2),
        num_vision_tokens=min(cfg.num_vision_tokens, 24),
        num_enc_frames=min(cfg.num_enc_frames, 24),
        mamba_d_state=8,
        mamba_chunk=32,
    )
