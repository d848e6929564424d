"""MiniCPM-2B — llama-like dense MHA (kv=36), WSD LR schedule.
[arXiv:2404.06395; hf] 40L d_model=2304 36H (kv=36) d_ff=5760
vocab=122753 (padded to 122880, a multiple of 512)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    rope_theta=1e4,
))
