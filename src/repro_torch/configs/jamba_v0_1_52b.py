"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536.  Attention sits at position 4 of each 8-layer block; MoE on
every second layer (per the paper's e=16 top-2, 1-in-2 MoE frequency).
Runs long_500k: the Mamba layers give O(1) state and the 4 attention
layers carry a (sharded) 500k KV cache.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    d_state=16,
    d_conv=4,
    ssm_expand=2,
    supports_long_context=True,
))
