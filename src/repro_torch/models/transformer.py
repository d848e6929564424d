"""Decoder-only LM for the dense and MoE families: embed, attention blocks,
logits.

Counterpart of ``repro/models/transformer.py`` for ``layer_kind == "attn"``
with a dense FFN (MiniCPM, Yi, the llama-like stacks) or an MoE FFN
(qwen2-moe, qwen3-moe) on the layers of ``cfg.layer_has_moe``.  The
reference groups layers by the pattern's period P (``cfg.pattern()``) and
scans over the groups with remat; here :class:`DecoderLM` is an
``nn.Module`` whose blocks follow the same pattern (block *i* holds ``moe``
where ``cfg.layer_has_moe(i % P)`` and ``mlp`` otherwise) and the forward
passes loop over them in Python (no scan).  With ``cfg.remat`` and grad
mode on, :func:`forward_hidden` wraps each block in
``torch.utils.checkpoint`` (non-reentrant), the reference's
``jax.checkpoint(..., nothing_saveable)`` around a group: only the block's
input is kept, and its backward runs the block again.  Parameters keep the
reference's layout and distributions (:func:`init_decoder`), and
:mod:`repro_torch.convert` carries the reference's parameter pytree onto
the module (:func:`reference_leaves`).  The parameters are trainable; the
serving passes (``models/model.py``' prefill and decode,
:func:`forward_with_cache`, ``serve/engine.py``'s embedder) run under
``torch.no_grad``.

Not ported: mamba (jamba, the hybrid family), xLSTM (the ssm family), the
vlm front end and the encoder-decoder; each raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import Embedding, Linear, Norm, embed, \
    linear, rmsnorm

_UNPORTED = {
    "hybrid": "mamba layers (hybrid family)",
    "ssm": "xLSTM layers (ssm family)",
    "vlm": "the vision front end (vlm family)",
    "encdec": "the encoder-decoder (encdec family)",
}


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a configuration whose layers are not ported yet."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: {_UNPORTED.get(cfg.family, cfg.family)} are not "
            "ported yet (ROADMAP modules item 14); the port runs the dense "
            "and MoE decoder families")


class Block(nn.Module):
    """One residual block: ``ln1``, ``attn``, ``ln2``, then ``moe``
    (:class:`~repro_torch.models.moe.MoE`) where ``has_moe``, else ``mlp``."""

    def __init__(self, cfg: ArchConfig, *, has_moe: bool = False,
                 device=None, dtype=torch.bfloat16):
        super().__init__()
        d = cfg.d_model
        self.ln1 = Norm(torch.empty((d,), device=device, dtype=torch.float32))
        self.attn = attn_mod.Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.head_dim_, device=device,
                                       dtype=dtype)
        self.ln2 = Norm(torch.empty((d,), device=device, dtype=torch.float32))
        if has_moe:
            self.moe = moe_mod.MoE(d, cfg.d_ff, cfg.n_experts,
                                   n_shared_experts=cfg.n_shared_experts,
                                   device=device, dtype=dtype)
        else:
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
        period, _ = cfg.pattern()
        self.blocks = nn.ModuleList(
            Block(cfg, has_moe=cfg.layer_has_moe(i % period), device=device,
                  dtype=dtype)
            for i in range(cfg.n_layers))
        self.final_norm = Norm(torch.empty((d,), device=device,
                                           dtype=torch.float32))
        self.lm_head = Linear(torch.empty((d, v), device=device,
                                          dtype=dtype))

    @property
    def device(self) -> torch.device:
        return self.embed.w.device


def reference_leaves(model: nn.Module) -> dict:
    """{path in the reference's parameter pytree: the names of
    ``model.named_parameters()`` that form it}.  A top-level tensor is one
    name (``("embed", "w")``); block *i*'s tensor sits at index ``i // P``
    of the reference's stacked leaf for pattern position ``i % P`` (P the
    pattern's period), so each leaf lists its blocks in layer order
    (``("layers", 0, "attn", "wq", "w")``: ``blocks.0.attn.wq.w``,
    ``blocks.P.attn.wq.w``, ...)."""
    period, _ = model.cfg.pattern()
    out: dict = {}
    for name, _ in model.named_parameters():
        parts = tuple(name.split("."))
        if parts[0] == "blocks":
            path = ("layers", int(parts[1]) % period, *parts[2:])
        else:
            path = parts
        out.setdefault(path, []).append(name)
    return out


def param_groups(model: nn.Module) -> list:
    """The parameter names grouped by the reference's pytree leaves (see
    :func:`reference_leaves`): what the reference treats as one tensor."""
    return list(reference_leaves(model).values())


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
    normal * 0.02 for the embedding, ones for the norms, an MoE block's
    FFN by ``moe.init_moe`` (its router float32).  Draw order: embedding,
    lm_head, then each block's wq, wk, wv, wo, and its FFN: w1, w3, w2, or
    the MoE's leaves (``MoE.leaves``)."""
    model = DecoderLM(cfg, device=device, dtype=dtype)

    def draw(p: torch.Tensor, scale: float) -> None:
        x = torch.randn(p.shape, generator=generator, device=device,
                        dtype=torch.float32)
        p.copy_(x * scale)

    draw(model.embed.w, 0.02)
    draw(model.lm_head.w, cfg.d_model ** -0.5)
    for blk in model.blocks:
        for lin in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo):
            draw(lin.w, lin.w.shape[0] ** -0.5)
        if hasattr(blk, "moe"):
            moe_mod.init_moe(blk.moe, generator=generator)
            continue
        for name in ("w1", "w3", "w2"):
            if hasattr(blk.mlp, name):
                w = getattr(blk.mlp, name).w
                draw(w, w.shape[0] ** -0.5)
    for norm in [model.final_norm] + [n for blk in model.blocks
                                      for n in (blk.ln1, blk.ln2)]:
        norm.scale.fill_(1.0)
    return model


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _apply_block(blk: Block, x: torch.Tensor, cfg: ArchConfig, *,
                 cache: attn_mod.KVCache | None = None,
                 cache_pos: int | None = None) -> tuple:
    """One residual block (cache written in place); returns (x, the MoE's
    aux dict, or None for a dense block)."""
    h = rmsnorm(blk.ln1, x, cfg.norm_eps)
    out, _ = attn_mod.attention_forward(
        blk.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window, kv_chunk=cfg.kv_chunk,
        cache=cache, cache_pos=cache_pos,
    )
    x = x + out
    h2 = rmsnorm(blk.ln2, x, cfg.norm_eps)
    if hasattr(blk, "moe"):
        y, aux = moe_mod.moe(blk.moe, h2, top_k=cfg.top_k)
        return x + y, aux
    return x + ffn_mod.ffn(blk.mlp, h2, activation=cfg.activation), None


def embed_tokens(model: DecoderLM, tokens: torch.Tensor) -> torch.Tensor:
    return embed(model.embed, tokens)


def forward_hidden(model: DecoderLM,
                   x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Training/scoring forward through the stack (causal, no cache); x:
    (B, S, d).  Returns the final-normed hidden state and the MoE
    auxiliary metrics summed over the MoE layers (float32 zeros for a
    dense stack), as the reference.  With ``cfg.remat`` and grad mode on,
    each block is checkpointed."""
    cfg = model.cfg
    remat = cfg.remat and torch.is_grad_enabled()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"load_balance_loss": zero, "dropped_fraction": zero}
    for blk in model.blocks:
        if remat:
            x, layer_aux = checkpoint(_apply_block, blk, x, cfg,
                                      use_reentrant=False)
        else:
            x, layer_aux = _apply_block(blk, x, cfg)
        if layer_aux is not None:
            aux = {key: aux[key] + layer_aux[key] for key in aux}
    return rmsnorm(model.final_norm, x, cfg.norm_eps), aux


def logits_from_hidden(model: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    """float32 logits; padded vocabulary slots are -1e30 (out of place, as
    the reference's ``jnp.where``)."""
    cfg = model.cfg
    logits = linear(model.lm_head, x).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab,
                           device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


@torch.no_grad()
def forward_with_cache(model: DecoderLM, x: torch.Tensor,
                       caches: attn_mod.KVCache,
                       cache_pos: int) -> tuple[torch.Tensor,
                                                attn_mod.KVCache]:
    """Prefill (T > 1) or decode (T == 1) against the stacked caches of
    :func:`init_caches`, written in place; returns (hidden, caches).  The
    MoE auxiliary metrics are dropped, as the reference drops them."""
    cfg = model.cfg
    for i, blk in enumerate(model.blocks):
        x, _ = _apply_block(blk, x, cfg,
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
