"""Decoder-only LM: embed, residual blocks, logits.

Counterpart of ``repro/models/transformer.py`` for the dense, MoE, hybrid,
ssm and vlm families.  A block's mixer is attention (``cfg.layer_kind ==
"attn"``: MiniCPM, Yi, the llama-like stacks, InternVL2's decoder), mamba
(``"mamba"``: Jamba's recurrent layers, ``models/mamba.py``) or an xLSTM
cell (``"mlstm"``, ``"slstm"``: ``models/xlstm.py``), and its FFN an MoE
(``cfg.layer_has_moe``: qwen2-moe, qwen3-moe, every second jamba layer) or
a dense one; an xLSTM block has no FFN and no ``ln2`` (its cell carries its
own projections).  The reference groups layers by the pattern's period P
(``cfg.pattern()``; jamba's is 8: attention at position 4, MoE at odd
positions; xlstm's is 8: the sLSTM at position 7) and scans over the groups
with remat; here :class:`DecoderLM` is
an ``nn.Module`` whose block *i* follows pattern position ``i % P``, and the
forward passes loop over the blocks in Python (no scan).  With
``cfg.remat`` and grad mode on, :func:`forward_hidden` wraps each block in
``torch.utils.checkpoint`` (non-reentrant), the reference's
``jax.checkpoint(..., nothing_saveable)`` around a group: only the block's
input is kept, and its backward runs the block again.  Parameters keep the
reference's layout and distributions (:func:`init_decoder`), and
:mod:`repro_torch.convert` carries the reference's parameter pytree onto
the module (:func:`reference_leaves`).  The parameters are trainable; the
serving passes (``models/model.py``' prefill and decode,
:func:`forward_with_cache`, ``serve/engine.py``'s embedder) run under
``torch.no_grad``.

Serving state (:func:`init_caches`): a stack of attention layers keeps one
stacked ``KVCache`` of (n_layers, B, max_seq, K, hd); a hybrid or xLSTM
stack keeps a list with one entry a layer, a ``KVCache`` of (B, max_seq, K,
hd) for an attention layer, a mamba layer's ``(conv_state, ssm_state)``,
an mLSTM layer's float32 ``(C, n, m)`` and an sLSTM layer's ``(c, n, m,
h)``.  The encoder-decoder (whisper) is ``models/encdec.py``'s
:class:`~repro_torch.models.encdec.EncDecLM`.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import shard
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import Embedding, Linear, Norm, embed, \
    linear, rmsnorm

# the reference's parameter pytree stacks these leaves' layers on a
# leading axis: the decoder's pattern groups, whisper's encoder and decoder
STACKED = ("layers", "enc_layers", "dec_layers")


class Block(nn.Module):
    """One residual block: ``ln1``, the mixer of ``kind`` (``attn``, or
    ``mamba``: :class:`~repro_torch.models.mamba.Mamba`), ``ln2``, then
    ``moe`` (:class:`~repro_torch.models.moe.MoE`) where ``has_moe``, else
    ``mlp``; or ``ln1`` and an xLSTM ``cell`` (kind ``mlstm``:
    :class:`~repro_torch.models.xlstm.MLSTM`, ``slstm``:
    :class:`~repro_torch.models.xlstm.SLSTM`) and nothing more."""

    def __init__(self, cfg: ArchConfig, *, kind: str = "attn",
                 has_moe: bool = False, device=None, dtype=torch.bfloat16):
        super().__init__()
        d = cfg.d_model
        self.ln1 = Norm(torch.empty((d,), device=device, dtype=torch.float32))
        if kind == "attn":
            self.attn = attn_mod.Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                           cfg.head_dim_, device=device,
                                           dtype=dtype)
        elif kind == "mamba":
            self.mamba = mamba_mod.Mamba(d, d_state=cfg.d_state,
                                         d_conv=cfg.d_conv,
                                         expand=cfg.ssm_expand,
                                         device=device, dtype=dtype)
        elif kind == "mlstm":
            self.cell = xlstm_mod.MLSTM(d, n_heads=cfg.n_heads,
                                        expand=cfg.xlstm_expand,
                                        device=device, dtype=dtype)
            return
        elif kind == "slstm":
            self.cell = xlstm_mod.SLSTM(d, n_heads=cfg.n_heads,
                                        device=device, dtype=dtype)
            return
        else:
            raise ValueError(f"layer kind {kind!r}")
        self.ln2 = Norm(torch.empty((d,), device=device, dtype=torch.float32))
        if has_moe:
            self.moe = moe_mod.MoE(d, cfg.d_ff, cfg.n_experts,
                                   n_shared_experts=cfg.n_shared_experts,
                                   device=device, dtype=dtype)
        else:
            self.mlp = ffn_mod.FFN(d, cfg.d_ff, activation=cfg.activation,
                                   device=device, dtype=dtype)


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Each layer's mixer, in stack order: ``cfg.layer_kind`` of its
    position in the pattern (``attn``, ``mamba``, ``mlstm`` or
    ``slstm``)."""
    period, _ = cfg.pattern()
    return [cfg.layer_kind(i % period) for i in range(cfg.n_layers)]


class DecoderLM(nn.Module):
    """``embed``, ``blocks`` (a ``ModuleList`` of :class:`Block`),
    ``final_norm`` and ``lm_head``; parameters uninitialised (see
    :func:`init_decoder`).  Matrices are in ``dtype``, norm scales in
    float32, as in the reference."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name} is an encoder-decoder: "
                             "models/encdec.py's EncDecLM")
        self.cfg = cfg
        d, v = cfg.d_model, cfg.padded_vocab
        self.embed = Embedding(torch.empty((v, d), device=device,
                                           dtype=dtype))
        period, _ = cfg.pattern()
        self.blocks = nn.ModuleList(
            Block(cfg, kind=kind, has_moe=cfg.layer_has_moe(i % period),
                  device=device, dtype=dtype)
            for i, kind in enumerate(layer_kinds(cfg)))
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
    ``blocks.P.attn.wq.w``, ...).  An encoder-decoder's layer *i* of
    ``enc_layers`` or ``dec_layers`` sits at index *i* of the leaf of that
    name (``("dec_layers", "xattn", "wq", "w")``)."""
    period, _ = model.cfg.pattern()
    out: dict = {}
    for name, _ in model.named_parameters():
        parts = tuple(name.split("."))
        if parts[0] == "blocks":
            path = ("layers", int(parts[1]) % period, *parts[2:])
        elif parts[0] in STACKED:
            path = (parts[0], *parts[2:])
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
    counts (it leaves out the norm scales), less :func:`param_count_gap`."""
    return sum(p.numel() for p in model.parameters() if p.ndim >= 2)


def param_count_gap(cfg: ArchConfig) -> int:
    """``cfg.param_count()`` less :func:`matrix_param_count` of its module,
    exactly.  The formula also counts each mamba layer's two 1-D leaves
    (``dt_bias`` and ``d_skip``: 2 d_inner), and reckons the layer's
    ``dt_rank`` as d // 16 where the layer has ``max(16, d // 16)``
    (``mamba.dt_rank_of``), so below d = 256 it misses 2 d_inner for each
    rank short (``x_proj``'s columns and ``dt_proj``'s rows).  It counts
    each sLSTM layer's GeGLU ``w_ff`` as 4 d^2 where its ``w1`` and ``w2``
    hold 3 d^2, and leaves out an encoder-decoder's ``frontend_adapter``
    (d^2).  Zero for a stack of attention and mLSTM layers."""
    kinds = layer_kinds(cfg)
    d = cfg.d_model
    short = mamba_mod.dt_rank_of(d) - d // 16
    gap = kinds.count("mamba") * 2 * cfg.ssm_expand * d * (1 - short) \
        + kinds.count("slstm") * d * d
    return gap - d * d if cfg.family == "encdec" else gap


@torch.no_grad()
def init_decoder(cfg: ArchConfig, *, generator: torch.Generator, device,
                 dtype=torch.bfloat16) -> DecoderLM:
    """A :class:`DecoderLM` on ``device`` with the reference's
    distributions, drawn in float32 from ``generator`` (which must live on
    ``device``) and cast to ``dtype``: normal / sqrt(d_in) for the linears,
    normal * 0.02 for the embedding, ones for the norms, a mamba mixer by
    ``mamba.init_mamba`` (its ``dt_bias``, ``a_log`` and ``d_skip``
    float32), an xLSTM cell by ``xlstm.init_mlstm`` or ``init_slstm`` (its
    ``norm_scale`` float32 ones), an MoE block's FFN by ``moe.init_moe``
    (its router float32).  Draw order: embedding, lm_head, then each
    block's mixer (attention's wq, wk, wv, wo, mamba's in_proj, conv_w,
    x_proj, dt_proj, out_proj, or the cell's leaves) and its FFN: w1, w3,
    w2, or the MoE's leaves (``MoE.leaves``)."""
    model = DecoderLM(cfg, device=device, dtype=dtype)

    def draw(p: torch.Tensor, scale: float) -> None:
        x = torch.randn(p.shape, generator=generator, device=device,
                        dtype=torch.float32)
        p.copy_(x * scale)

    draw(model.embed.w, 0.02)
    draw(model.lm_head.w, cfg.d_model ** -0.5)
    for blk in model.blocks:
        if hasattr(blk, "cell"):
            init = xlstm_mod.init_mlstm \
                if isinstance(blk.cell, xlstm_mod.MLSTM) \
                else xlstm_mod.init_slstm
            init(blk.cell, generator=generator)
            blk.ln1.scale.fill_(1.0)
            continue
        if hasattr(blk, "mamba"):
            mamba_mod.init_mamba(blk.mamba, generator=generator)
        else:
            attn_mod.init_attention(blk.attn, generator=generator)
        if hasattr(blk, "moe"):
            moe_mod.init_moe(blk.moe, generator=generator)
            continue
        for name in ("w1", "w3", "w2"):
            if hasattr(blk.mlp, name):
                w = getattr(blk.mlp, name).w
                draw(w, w.shape[0] ** -0.5)
    for norm in [model.final_norm] + [n for blk in model.blocks
                                      if hasattr(blk, "ln2")
                                      for n in (blk.ln1, blk.ln2)]:
        norm.scale.fill_(1.0)
    return model


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _mix(blk: Block, h: torch.Tensor, cfg: ArchConfig, cache,
         cache_pos: int | None) -> tuple:
    """The block's mixer over ``h``: (out, its serving state): the
    ``KVCache`` written in place, or mamba's new ``(conv, ssm)`` pair or
    the xLSTM cell's new state (each from zeros when ``cache`` is
    None)."""
    if hasattr(blk, "cell"):
        block = xlstm_mod.mlstm_block \
            if isinstance(blk.cell, xlstm_mod.MLSTM) \
            else xlstm_mod.slstm_block
        return block(blk.cell, h, n_heads=cfg.n_heads, state=cache)
    if hasattr(blk, "mamba"):
        conv, ssm = (None, None) if cache is None else cache
        return mamba_mod.mamba(blk.mamba, h, conv, ssm)
    return attn_mod.attention_forward(
        blk.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window, kv_chunk=cfg.kv_chunk,
        cache=cache, cache_pos=cache_pos,
    )


def gathered(h: torch.Tensor) -> torch.Tensor:
    """An activation (B, T, d) entering or leaving a block's matrices, with
    its sequence whole under a mesh (a no-op outside one): batch on dp
    only.  With the residual's sequence on tp (``seq_sharded_residual``)
    this is the all-gather of Megatron's sequence parallelism going in,
    and the reduction of the block's partial output coming out, whose
    backward hands the matrices a gradient with its sequence whole:
    DTensor cannot flatten (B, T) for a matmul with both dims sharded."""
    return shard(h, "dp", None, None)


def _residual_shard(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The residual stream's layout under a mesh (a no-op outside one):
    batch on dp and the sequence on tp (``cfg.seq_sharded_residual``), or
    batch on dp with d_model replicated (the recurrent mixers)."""
    if cfg.seq_sharded_residual:
        return shard(x, "dp", "tp", None)
    return shard(x, "dp", None, None)


def _apply_block(blk: Block, x: torch.Tensor, cfg: ArchConfig, *,
                 cache=None, cache_pos: int | None = None) -> tuple:
    """One residual block; returns (x, the MoE's aux dict or None for a
    dense FFN or an xLSTM cell, the mixer's serving state (see
    :func:`_mix`))."""
    h = gathered(rmsnorm(blk.ln1, x, cfg.norm_eps))
    out, state = _mix(blk, h, cfg, cache, cache_pos)
    x = _residual_shard(x + gathered(out), cfg)
    if not hasattr(blk, "ln2"):
        return x, None, state
    h2 = gathered(rmsnorm(blk.ln2, x, cfg.norm_eps))
    if hasattr(blk, "moe"):
        y, aux = moe_mod.moe(blk.moe, h2, top_k=cfg.top_k,
                             serving=cache is not None)
        return _residual_shard(x + gathered(y), cfg), aux, state
    x = x + gathered(ffn_mod.ffn(blk.mlp, h2, activation=cfg.activation))
    return _residual_shard(x, cfg), None, state


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
    x = _residual_shard(x, cfg)
    for blk in model.blocks:
        if remat:
            x, layer_aux, _ = checkpoint(_apply_block, blk, x, cfg,
                                         use_reentrant=False)
        else:
            x, layer_aux, _ = _apply_block(blk, x, cfg)
        if layer_aux is not None:
            aux = {key: aux[key] + layer_aux[key] for key in aux}
    return rmsnorm(model.final_norm, x, cfg.norm_eps), aux


def logits_from_hidden(model: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    """float32 logits; padded vocabulary slots are -1e30 (out of place, as
    the reference's ``jnp.where``)."""
    cfg = model.cfg
    logits = shard(linear(model.lm_head, gathered(x)).float(), "dp", None,
                   "tp")
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab,
                           device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


@torch.no_grad()
def forward_with_cache(model: DecoderLM, x: torch.Tensor, caches,
                       cache_pos: int) -> tuple:
    """Prefill (T > 1) or decode (T == 1) against the serving state of
    :func:`init_caches`; returns (hidden, caches).  A stacked ``KVCache`` is
    written in place; a hybrid or xLSTM stack's list is updated in place,
    each attention layer's ``KVCache`` written into and each recurrent
    layer's state replaced by its new one (mamba: float32 ``ssm``; ``conv``
    in the promoted dtype of the old state and the activations, as the
    reference's concatenation gives it: bf16 for a bf16 model; an xLSTM
    cell's float32 state).  The MoE auxiliary
    metrics are dropped, as the reference drops them."""
    cfg = model.cfg
    stacked = isinstance(caches, attn_mod.KVCache)
    for i, blk in enumerate(model.blocks):
        cache = attn_mod.KVCache(caches.k[i], caches.v[i]) if stacked \
            else caches[i]
        x, _, state = _apply_block(blk, x, cfg, cache=cache,
                                   cache_pos=cache_pos)
        if not stacked:
            caches[i] = state
    return rmsnorm(model.final_norm, x, cfg.norm_eps), caches


def init_caches(cfg: ArchConfig, b: int, max_seq: int, *, device,
                dtype=torch.bfloat16):
    """Zeroed serving state, bf16 as in the reference (whatever the
    parameters' dtype).  A stack of attention layers: one tensor each for K
    and V, (n_layers, B, max_seq, K, hd).  A hybrid or xLSTM stack: a list
    of one entry a layer, ``KVCache`` (B, max_seq, K, hd) for attention,
    ``mamba.init_mamba_state``'s ``(conv (B, d_conv - 1, d_inner), ssm (B,
    d_inner, d_state) float32)`` for mamba, ``xlstm.init_mlstm_state``'s
    ``(C, n, m)`` for an mLSTM and ``xlstm.init_slstm_state``'s ``(c, n,
    m, h)`` for an sLSTM (float32; ``max_seq`` does not size them)."""
    kinds = layer_kinds(cfg)
    kv = (b, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    if all(kind == "attn" for kind in kinds):
        shape = (cfg.n_layers, *kv)
        return attn_mod.KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )

    def state(kind):
        if kind == "attn":
            return attn_mod.KVCache(
                k=torch.zeros(kv, dtype=dtype, device=device),
                v=torch.zeros(kv, dtype=dtype, device=device))
        if kind == "mamba":
            return mamba_mod.init_mamba_state(
                b, cfg.d_model, d_state=cfg.d_state, d_conv=cfg.d_conv,
                expand=cfg.ssm_expand, device=device, dtype=dtype)
        if kind == "mlstm":
            return xlstm_mod.init_mlstm_state(
                b, cfg.d_model, n_heads=cfg.n_heads,
                expand=cfg.xlstm_expand, device=device)
        return xlstm_mod.init_slstm_state(b, cfg.d_model,
                                          n_heads=cfg.n_heads, device=device)

    return [state(kind) for kind in kinds]
