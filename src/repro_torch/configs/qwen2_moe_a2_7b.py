"""Qwen1.5-MoE-A2.7B — 4 shared + 60 routed experts top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 24L d_model=2048 16H (kv=16)
d_ff=1408 (per expert) vocab=151936.  60 experts do not divide any mesh
axis: the reference shards expert weights on their matrix dims instead;
the port serves them whole on one card."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    moe_every=1,
    moe_offset=0,
    rope_theta=1e6,
))
