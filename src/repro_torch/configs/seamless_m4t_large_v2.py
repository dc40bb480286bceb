"""SeamlessM4T-large-v2 — encoder-decoder transformer backbone
[arXiv:2308.11596; hf].  The modality frontend is a stub: ``input_specs``
provides precomputed speech-frame embeddings for the 24-layer encoder; the
24-layer decoder cross-attends to the encoder output (24L per stack)."""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,  # decoder layers (each with a cross-attention sub-block)
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    enc_layers=24,
    num_enc_frames=1500,
    rope_theta=10_000.0,
)
