"""Nemotron-4 340B — dense GQA with squared-ReLU FFN.
[arXiv:2402.16819; unverified] 96L d_model=18432 96H (GQA kv=8)
d_ff=73728 vocab=256000."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    rope_theta=1e4,
))
