"""Whisper-style encoder-decoder backbone (modality front end stubbed).

Counterpart of ``repro/models/encdec.py``.  The conv stem is a stub: the
batch carries precomputed frame embeddings (B, S_enc, d_model), and a
linear ``frontend_adapter`` stands in for the stem's output projection.
Encoder layers are bidirectional self-attention; decoder layers are causal
self-attention, cross-attention over the encoder's output and the FFN.
Both stacks add :func:`~repro_torch.models.layers.sinusoidal_positions`
to their input and rotate q and k with ``attention_forward``'s default
theta (1e4), as the reference's, whatever ``cfg.rope_theta`` says.  Every
attention call goes to the flash kernel: the encoder's and the
cross-attention's without a causal mask.

:class:`EncDecLM` keeps the reference's leaves: ``frontend_adapter``,
``embed``, ``enc_layers`` (``ln1``, ``attn``, ``ln2``, ``mlp``),
``enc_norm``, ``dec_layers`` (``ln1``, ``attn``, ``ln_x``, ``xattn``,
``ln2``, ``mlp``), ``dec_norm`` and ``lm_head``; the reference stacks each
layer list on a leading axis (``transformer.reference_leaves``).  With
``cfg.remat`` and grad mode on, each layer is checkpointed, as the
reference's ``jax.checkpoint`` around its scan body.

Serving state (:class:`EncDecCaches`): the decoder's self K/V (L, B, S_dec,
K, hd), written in place as the dense stack's, and the cross K/V (L, B,
S_enc, K, hd), which prefill computes once from the encoder's output
(:func:`make_cross_kv`) and decode reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import shard
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.transformer import gathered
from repro_torch.models.layers import Embedding, Linear, Norm, embed, \
    linear, rmsnorm, sinusoidal_positions


class EncDecCaches(NamedTuple):
    self_kv: attn_mod.KVCache        # (L, B, S_dec, K, hd)
    cross_kv: attn_mod.KVCache       # (L, B, S_enc, K, hd)


def _norm(d: int, device) -> Norm:
    return Norm(torch.empty((d,), device=device, dtype=torch.float32))


def _attention(cfg: ArchConfig, device, dtype) -> attn_mod.Attention:
    return attn_mod.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim_, device=device, dtype=dtype)


class EncLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.ln1 = _norm(cfg.d_model, device)
        self.attn = _attention(cfg, device, dtype)
        self.ln2 = _norm(cfg.d_model, device)
        self.mlp = ffn_mod.FFN(cfg.d_model, cfg.d_ff,
                               activation=cfg.activation, device=device,
                               dtype=dtype)


class DecLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.ln1 = _norm(cfg.d_model, device)
        self.attn = _attention(cfg, device, dtype)
        self.ln_x = _norm(cfg.d_model, device)
        self.xattn = _attention(cfg, device, dtype)
        self.ln2 = _norm(cfg.d_model, device)
        self.mlp = ffn_mod.FFN(cfg.d_model, cfg.d_ff,
                               activation=cfg.activation, device=device,
                               dtype=dtype)


class EncDecLM(nn.Module):
    """The encoder-decoder's parameters, uninitialised (see
    :func:`init_encdec`): matrices in ``dtype``, norm scales float32."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name} is not an encoder-decoder")
        self.cfg = cfg
        d, v = cfg.d_model, cfg.padded_vocab
        self.frontend_adapter = Linear(torch.empty((d, d), device=device,
                                                   dtype=dtype))
        self.embed = Embedding(torch.empty((v, d), device=device,
                                           dtype=dtype))
        self.enc_layers = nn.ModuleList(
            EncLayer(cfg, device=device, dtype=dtype)
            for _ in range(cfg.n_layers))
        self.enc_norm = _norm(d, device)
        self.dec_layers = nn.ModuleList(
            DecLayer(cfg, device=device, dtype=dtype)
            for _ in range(cfg.n_dec_layers))
        self.dec_norm = _norm(d, device)
        self.lm_head = Linear(torch.empty((d, v), device=device,
                                          dtype=dtype))

    @property
    def device(self) -> torch.device:
        return self.embed.w.device


@torch.no_grad()
def init_encdec(cfg: ArchConfig, *, generator: torch.Generator, device,
                dtype=torch.bfloat16) -> EncDecLM:
    """An :class:`EncDecLM` on ``device`` with the reference's
    distributions, drawn in float32 from ``generator`` (on ``device``) and
    cast to ``dtype``: normal / sqrt(d_in) for the linears, normal * 0.02
    for the embedding, ones for the norms.  Draw order: frontend_adapter,
    embedding, lm_head, then each encoder layer (attention's wq, wk, wv, wo;
    the FFN's w1, w2) and each decoder layer (self-attention,
    cross-attention, FFN)."""
    model = EncDecLM(cfg, device=device, dtype=dtype)

    def draw(p: torch.Tensor, scale: float) -> None:
        x = torch.randn(p.shape, generator=generator, device=device,
                        dtype=torch.float32)
        p.copy_(x * scale)

    def mats(mlp: ffn_mod.FFN) -> None:
        for name in ("w1", "w3", "w2"):
            if hasattr(mlp, name):
                w = getattr(mlp, name).w
                draw(w, w.shape[0] ** -0.5)

    draw(model.frontend_adapter.w, cfg.d_model ** -0.5)
    draw(model.embed.w, 0.02)
    draw(model.lm_head.w, cfg.d_model ** -0.5)
    for layer in model.enc_layers:
        attn_mod.init_attention(layer.attn, generator=generator)
        mats(layer.mlp)
    for layer in model.dec_layers:
        attn_mod.init_attention(layer.attn, generator=generator)
        attn_mod.init_cross_attention(layer.xattn, generator=generator)
        mats(layer.mlp)
    for name, p in model.named_parameters():
        if name.endswith("scale"):
            p.fill_(1.0)
    return model


def _layers(body, x: torch.Tensor, layers, cfg: ArchConfig) -> torch.Tensor:
    """``x = body(layer, x)`` over ``layers``, each layer checkpointed with
    ``cfg.remat`` and grad mode on."""
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in layers:
        x = checkpoint(body, layer, x, use_reentrant=False) if remat \
            else body(layer, x)
    return x


def encode(model: EncDecLM, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, d) stub embeddings, in the model's dtype -> the
    encoder's final-normed output (B, S_enc, d)."""
    cfg = model.cfg
    _, s, d = frames.shape
    x = linear(model.frontend_adapter, frames)
    x = x + sinusoidal_positions(s, d, device=x.device).to(x.dtype)
    x = shard(x, "dp", "tp", None)

    def body(layer: EncLayer, h: torch.Tensor) -> torch.Tensor:
        a, _ = attn_mod.attention_forward(
            layer.attn, gathered(rmsnorm(layer.ln1, h, cfg.norm_eps)),
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim_, causal=False, kv_chunk=cfg.kv_chunk)
        h = h + gathered(a)
        h = h + gathered(ffn_mod.ffn(
            layer.mlp, gathered(rmsnorm(layer.ln2, h, cfg.norm_eps)),
            activation=cfg.activation))
        return shard(h, "dp", "tp", None)

    x = _layers(body, x, model.enc_layers, cfg)
    return rmsnorm(model.enc_norm, x, cfg.norm_eps)


def _dec_layer_apply(layer: DecLayer, h: torch.Tensor, cfg: ArchConfig, *,
                     enc_out: torch.Tensor | None = None,
                     cross_kv: attn_mod.KVCache | None = None,
                     self_cache: attn_mod.KVCache | None = None,
                     cache_pos: int | None = None) -> torch.Tensor:
    """One decoder layer: causal self-attention (into ``self_cache`` in
    place when given), cross-attention over ``cross_kv`` (projected from
    ``enc_out`` when None), the FFN."""
    a, _ = attn_mod.attention_forward(
        layer.attn, gathered(rmsnorm(layer.ln1, h, cfg.norm_eps)),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, causal=True, kv_chunk=cfg.kv_chunk,
        cache=self_cache, cache_pos=cache_pos)
    h = h + gathered(a)
    if cross_kv is None:
        cross_kv = attn_mod.cross_attention_kv(
            layer.xattn, gathered(enc_out), n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim_)
    h = h + gathered(attn_mod.cross_attention_forward(
        layer.xattn, gathered(rmsnorm(layer.ln_x, h, cfg.norm_eps)), cross_kv,
        n_heads=cfg.n_heads, head_dim=cfg.head_dim_, kv_chunk=cfg.kv_chunk))
    h = h + gathered(ffn_mod.ffn(
        layer.mlp, gathered(rmsnorm(layer.ln2, h, cfg.norm_eps)),
        activation=cfg.activation))
    return shard(h, "dp", "tp", None)


def decode_train(model: EncDecLM, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder pass -> final-normed hidden states (B,
    S_dec, d)."""
    cfg = model.cfg
    s = tokens.shape[1]
    x = embed(model.embed, tokens)
    x = x + sinusoidal_positions(s, cfg.d_model, device=x.device).to(x.dtype)
    x = shard(x, "dp", "tp", None)
    x = _layers(lambda layer, h: _dec_layer_apply(layer, h, cfg,
                                                  enc_out=enc_out),
                x, model.dec_layers, cfg)
    return rmsnorm(model.dec_norm, x, cfg.norm_eps)


def make_cross_kv(model: EncDecLM, enc_out: torch.Tensor) -> attn_mod.KVCache:
    """Every decoder layer's cross K/V of ``enc_out``, stacked: (L, B,
    S_enc, K, hd) each."""
    cfg = model.cfg
    kvs = [attn_mod.cross_attention_kv(layer.xattn, gathered(enc_out),
                                       n_kv_heads=cfg.n_kv_heads,
                                       head_dim=cfg.head_dim_)
           for layer in model.dec_layers]
    return attn_mod.KVCache(k=torch.stack([kv.k for kv in kvs]),
                            v=torch.stack([kv.v for kv in kvs]))


def position_rows(table: torch.Tensor, start: int, t: int) -> torch.Tensor:
    """``table[start:start + t]`` with ``start`` clamped to [0, S - t], as
    ``jax.lax.dynamic_slice_in_dim`` clamps it."""
    start = min(max(int(start), 0), table.shape[0] - t)
    return table[start:start + t]


def decode_with_cache(model: EncDecLM, tokens: torch.Tensor,
                      caches: EncDecCaches, cache_pos: int) -> tuple:
    """Prefill (T > 1) or a one-token decode step of the decoder against
    ``caches`` (the self K/V written in place).  The position table has
    the self cache's S_dec rows and is read at ``cache_pos`` through
    :func:`position_rows`.  Returns (final-normed hidden, caches)."""
    cfg = model.cfg
    t = tokens.shape[1]
    x = embed(model.embed, tokens)
    table = sinusoidal_positions(caches.self_kv.k.shape[2], cfg.d_model,
                                 device=x.device)
    x = x + position_rows(table, cache_pos, t).to(x.dtype)
    for i, layer in enumerate(model.dec_layers):
        x = _dec_layer_apply(
            layer, x, cfg,
            cross_kv=attn_mod.KVCache(caches.cross_kv.k[i],
                                      caches.cross_kv.v[i]),
            self_cache=attn_mod.KVCache(caches.self_kv.k[i],
                                        caches.self_kv.v[i]),
            cache_pos=cache_pos)
    return rmsnorm(model.dec_norm, x, cfg.norm_eps), caches


def init_encdec_caches(cfg: ArchConfig, b: int, s_dec: int, s_enc: int, *,
                       device, dtype=torch.bfloat16) -> EncDecCaches:
    """Zeroed self K/V of ``s_dec`` rows and cross K/V of ``s_enc`` rows, in
    ``dtype`` (bf16 as in the reference, whatever the parameters')."""
    def kv(s):
        shape = (cfg.n_dec_layers, b, s, cfg.n_kv_heads, cfg.head_dim_)
        return attn_mod.KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device))

    return EncDecCaches(self_kv=kv(s_dec), cross_kv=kv(s_enc))
