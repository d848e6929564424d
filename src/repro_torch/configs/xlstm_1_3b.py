"""xLSTM-1.3B — sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM).
[arXiv:2405.04517; unverified] 48L d_model=2048 4H d_ff=0 (cells carry
their own projections) vocab=50304.  Pure recurrence -> runs long_500k
with O(1) decode state."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    slstm_offset=7,
    xlstm_expand=2.0,
    supports_long_context=True,
))
