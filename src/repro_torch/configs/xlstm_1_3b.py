"""xLSTM-1.3B — mLSTM + sLSTM block stack, no FFN (d_ff = 0)
[arXiv:2405.04517; unverified].  Period of 8: seven matrix-memory blocks and
one scalar-memory (recurrent) block, matching the paper's 7:1 ratio."""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(
        "mlstm", "mlstm", "mlstm", "mlstm",
        "mlstm", "mlstm", "mlstm", "slstm",
    ),
)
