"""Command R+ 104B — dense GQA, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75e6,
))
