"""Qwen3-30B-A3B — 128-expert top-8 MoE. [hf:Qwen/Qwen3-30B-A3B; hf]
48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert) vocab=151936.
head_dim=128 per the HF config (q/k/v project to 4096, not d_model)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    moe_every=1,
    moe_offset=0,
    rope_theta=1e6,
))
