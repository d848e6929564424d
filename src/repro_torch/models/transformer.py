"""Decoder-only LM for the dense family: embed, attention blocks, logits.

Counterpart of ``repro/models/transformer.py`` for ``layer_kind == "attn"``
with a dense FFN (MiniCPM, Yi, the llama-like stacks).  The reference scans
over groups of layers with remat; here :class:`DecoderLM` is an
``nn.Module`` and the forward passes loop over its blocks in Python (no
scan, no remat).  Parameters keep the reference's layout and distributions
(:func:`init_decoder`), and :mod:`repro_torch.convert` carries the
reference's parameter pytree onto the module.

Not ported: MoE layers (qwen2-moe, qwen3-moe), mamba (jamba), xLSTM and the
vlm front end; each raises ``NotImplementedError`` naming its ROADMAP item.
The module serves (no gradients): its backward comes with the training
slice.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import Embedding, Linear, Norm, embed, \
    linear, rmsnorm

_UNPORTED = {
    "moe": "MoE layers",
    "hybrid": "mamba layers (hybrid family)",
    "ssm": "xLSTM layers (ssm family)",
    "vlm": "the vision front end (vlm family)",
    "encdec": "the encoder-decoder (encdec family)",
}


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a configuration whose layers are not ported yet."""
    family = "moe" if cfg.n_experts else cfg.family
    if family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: {_UNPORTED.get(family, family)} are not ported yet "
            "(ROADMAP modules item 14); the port runs the dense decoder "
            "family")


class Block(nn.Module):
    """One residual block: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        d = cfg.d_model
        self.ln1 = Norm(torch.empty((d,), device=device, dtype=torch.float32))
        self.attn = attn_mod.Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.head_dim_, device=device,
                                       dtype=dtype)
        self.ln2 = Norm(torch.empty((d,), device=device, dtype=torch.float32))
        self.mlp = ffn_mod.FFN(d, cfg.d_ff, activation=cfg.activation,
                               device=device, dtype=dtype)


class DecoderLM(nn.Module):
    """``embed``, ``blocks`` (a ``ModuleList`` of :class:`Block`),
    ``final_norm`` and ``lm_head``; parameters uninitialised (see
    :func:`init_decoder`).  Matrices are in ``dtype``, norm scales in
    float32, as in the reference."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.padded_vocab
        self.embed = Embedding(torch.empty((v, d), device=device,
                                           dtype=dtype))
        self.blocks = nn.ModuleList(
            Block(cfg, device=device, dtype=dtype)
            for _ in range(cfg.n_layers))
        self.final_norm = Norm(torch.empty((d,), device=device,
                                           dtype=torch.float32))
        self.lm_head = Linear(torch.empty((d, v), device=device,
                                          dtype=dtype))

    @property
    def device(self) -> torch.device:
        return self.embed.w.device


def matrix_param_count(model: nn.Module) -> int:
    """Elements of the model's matrices: what ``ArchConfig.param_count()``
    counts (it leaves out the norm scales)."""
    return sum(p.numel() for p in model.parameters() if p.ndim >= 2)


@torch.no_grad()
def init_decoder(cfg: ArchConfig, *, generator: torch.Generator, device,
                 dtype=torch.bfloat16) -> DecoderLM:
    """A :class:`DecoderLM` on ``device`` with the reference's
    distributions, drawn in float32 from ``generator`` (which must live on
    ``device``) and cast to ``dtype``: normal / sqrt(d_in) for the linears,
    normal * 0.02 for the embedding, ones for the norms.  Draw order:
    embedding, lm_head, then each block's wq, wk, wv, wo, w1, w3, w2."""
    model = DecoderLM(cfg, device=device, dtype=dtype)

    def draw(p: torch.Tensor, scale: float) -> None:
        x = torch.randn(p.shape, generator=generator, device=device,
                        dtype=torch.float32)
        p.copy_(x * scale)

    draw(model.embed.w, 0.02)
    for mat in [model.lm_head.w] + [
            lin.w for blk in model.blocks
            for lin in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                        *(getattr(blk.mlp, n) for n in ("w1", "w3", "w2")
                          if hasattr(blk.mlp, n)))]:
        draw(mat, mat.shape[0] ** -0.5)
    for norm in [model.final_norm] + [n for blk in model.blocks
                                      for n in (blk.ln1, blk.ln2)]:
        norm.scale.fill_(1.0)
    return model


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _apply_block(blk: Block, x: torch.Tensor, cfg: ArchConfig, *,
                 cache: attn_mod.KVCache | None = None,
                 cache_pos: int | None = None) -> torch.Tensor:
    """One residual block (cache written in place)."""
    h = rmsnorm(blk.ln1, x, cfg.norm_eps)
    out, _ = attn_mod.attention_forward(
        blk.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window, kv_chunk=cfg.kv_chunk,
        cache=cache, cache_pos=cache_pos,
    )
    x = x + out
    h2 = rmsnorm(blk.ln2, x, cfg.norm_eps)
    return x + ffn_mod.ffn(blk.mlp, h2, activation=cfg.activation)


def embed_tokens(model: DecoderLM, tokens: torch.Tensor) -> torch.Tensor:
    return embed(model.embed, tokens)


@torch.no_grad()
def forward_hidden(model: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    """Scoring forward through the stack (causal, no cache); x: (B, S, d).
    Returns the final-normed hidden state.  (The reference also returns
    the MoE auxiliary losses, which a dense stack does not have.)"""
    cfg = model.cfg
    for blk in model.blocks:
        x = _apply_block(blk, x, cfg)
    return rmsnorm(model.final_norm, x, cfg.norm_eps)


@torch.no_grad()
def logits_from_hidden(model: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    """float32 logits; padded vocabulary slots are -1e30."""
    cfg = model.cfg
    logits = linear(model.lm_head, x).float()
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


@torch.no_grad()
def forward_with_cache(model: DecoderLM, x: torch.Tensor,
                       caches: attn_mod.KVCache,
                       cache_pos: int) -> tuple[torch.Tensor,
                                                attn_mod.KVCache]:
    """Prefill (T > 1) or decode (T == 1) against the stacked caches of
    :func:`init_caches`, written in place; returns (hidden, caches)."""
    cfg = model.cfg
    for i, blk in enumerate(model.blocks):
        x = _apply_block(blk, x, cfg,
                         cache=attn_mod.KVCache(caches.k[i], caches.v[i]),
                         cache_pos=cache_pos)
    return rmsnorm(model.final_norm, x, cfg.norm_eps), caches


def init_caches(cfg: ArchConfig, b: int, max_seq: int, *, device,
                dtype=torch.bfloat16) -> attn_mod.KVCache:
    """One zeroed tensor each for K and V, (n_layers, B, max_seq, K, hd),
    bf16 as in the reference (whatever the parameters' dtype)."""
    check_supported(cfg)
    shape = (cfg.n_layers, b, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    return attn_mod.KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )
