"""Whisper-medium backbone — encoder-decoder, conv frontend stubbed.
[arXiv:2212.04356; unverified] 24L (x2: 24 enc + 24 dec) d_model=1024
16H (kv=16) d_ff=4096 vocab=51865.  ``input_specs`` provides precomputed
frame embeddings (B, S, d); decoder length = seq_len // 4 for training
shapes (audio-to-text compression); decode shapes exercise the decoder
with self-KV of seq_len and cross-KV over the encoder output."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    activation="gelu",
    frontend="audio_stub",
))
