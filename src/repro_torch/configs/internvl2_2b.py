"""InternVL2-2B backbone — InternLM2-1.8B decoder + InternViT stub.
[arXiv:2404.16821; hf] 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 (padded).  The ViT frontend is a stub: ``input_specs``
provides 256 precomputed patch embeddings per example which are
prepended to the token sequence; loss only on token positions."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend="patch_stub",
    n_frontend_tokens=256,
    rope_theta=1e6,
))
