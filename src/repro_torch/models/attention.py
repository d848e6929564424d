"""GQA self-attention with a KV cache, on the hand-written flash kernel.

Counterpart of ``repro/models/attention.py``.  Every attention call (train
mode for the embedder, prefill, decode) goes to
``repro_torch.kernels.flash_attention``: the CUDA kernel on the card, its
plain version on the CPU.  The reference's two formulations (a one-pass
softmax for ``Tq <= 8`` and a chunked scan over ``kv_chunk`` keys above)
compute the same function, so both go to the one kernel.

The cache is updated in place: prefill writes ``cache[:, 0:T]``, decode one
row at ``cache_pos`` (the reference writes a new cache with
``dynamic_update_slice`` and donates the old one).  Attention then runs over
the whole ``max_seq`` cache with ``kv_valid_len = cache_pos + T`` and
``q_offset = cache_pos``.

Cross-attention (whisper's decoder, ``models/encdec.py``) holds the same
four matrices as self-attention: :func:`cross_attention_kv` projects the
encoder's output to K/V once a sequence, and :func:`cross_attention_forward`
attends over them without a causal mask and without rotary, through the same
kernel.

``sliding_window`` > 0 masks each row's keys at or before ``q_pos - window``
as the reference does (``repro/models/attention.py:78-79, 125-126``); the
kernels skip the key tiles wholly outside the window.  No configuration
sets it (the reference's ``ArchConfig`` defaults it to 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.dist.sharding import _axis_size, _spec_for, active_ctx, \
    is_dtensor, placements, shard, split_heads
from repro_torch.kernels import flash_attention as kflash
from repro_torch.models.layers import Linear, apply_rope, linear


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S, K, hd), or (n_layers, B, S, K, hd) for a stack
    v: torch.Tensor


class Attention(nn.Module):
    """``wq`` (d, H hd), ``wk`` and ``wv`` (d, K hd), ``wo`` (H hd, d)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, *, device=None, dtype=torch.bfloat16):
        super().__init__()

        def mat(d_in, d_out):
            return Linear(torch.empty((d_in, d_out), device=device,
                                      dtype=dtype))

        self.wq = mat(d_model, n_heads * head_dim)
        self.wk = mat(d_model, n_kv_heads * head_dim)
        self.wv = mat(d_model, n_kv_heads * head_dim)
        self.wo = mat(n_heads * head_dim, d_model)


@torch.no_grad()
def init_attention(p: Attention, *, generator: torch.Generator) -> Attention:
    """The reference's distributions: ``wq``, ``wk``, ``wv`` and ``wo``
    normal / sqrt(d_in), drawn in float32 from ``generator`` in that order
    and cast to their dtype."""
    for lin in (p.wq, p.wk, p.wv, p.wo):
        x = torch.randn(lin.w.shape, generator=generator,
                        device=lin.w.device, dtype=torch.float32)
        lin.w.copy_(x * lin.w.shape[0] ** -0.5)
    return p


# a decoder layer's cross-attention has self-attention's leaves and draws
init_cross_attention = init_attention


def flash_attention(
    q: torch.Tensor,            # (B, Tq, H, hd)
    k: torch.Tensor,            # (B, Tk, K, hd)
    v: torch.Tensor,            # (B, Tk, K, hd)
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_valid_len: int | None = None,
    sliding_window: int = 0,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Masked softmax attention; returns (B, Tq, H, hd) in ``q``'s dtype.
    ``kv_chunk`` is the reference's scan chunk and does not change the
    function; the kernel tiles keys its own way."""
    del kv_chunk
    return kflash.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  kv_valid_len=kv_valid_len,
                                  sliding_window=sliding_window)


def _attend(q, k, v, *, cache: KVCache | None = None, pos: int = 0,
            **kw) -> torch.Tensor:
    """The attention core: :func:`flash_attention` over ``q`` and ``k``,
    ``v``, or, with ``cache``, ``k`` and ``v`` written into it at ``pos``
    (in place) and the attention over the cache.

    Under a mesh (``dist.sharding.use_mesh``) with DTensor activations the
    kernels cannot take DTensors, so the core runs over local shards
    (``dist/compat.py``'s ``local_map``): the batch on dp and the heads on
    tp where they divide.  Where the query heads divide tp and the KV heads
    do not, K and V (and the cache) stay replicated over tp and each rank
    attends with the KV heads of its query heads; their gradients are then
    partial over tp.  A cache laid out otherwise (``cache_shardings`` puts
    axis 2 of a stacked cache, the sequence, on tp) is redistributed for the
    call and written back after it.  The plain route runs the same path on
    the CPU."""
    ctx = active_ctx()
    if ctx is None or not is_dtensor(q):
        if cache is not None:
            t = k.shape[1]
            cache.k[:, pos:pos + t] = k.to(cache.k.dtype)
            cache.v[:, pos:pos + t] = v.to(cache.v.dtype)
            k, v = cache.k, cache.v
        return flash_attention(q, k, v, **kw)
    from repro_torch.dist.compat import local_map

    mesh, lmap = ctx
    dims = ("dp", None, "tp", None)
    q_spec = _spec_for(mesh, lmap, tuple(q.shape), dims)
    kv_spec = _spec_for(mesh, lmap, tuple(k.shape), dims)
    if q_spec[2] is None:
        kv_spec = (kv_spec[0], None, None, None)
    h, kh = q.shape[2], k.shape[2]
    heads = slice(0, kh)
    sliced = q_spec[2] is not None and kv_spec[2] is None
    if sliced:
        # this rank's query heads [r Hl, (r + 1) Hl) read KV heads
        # [r Hl // g, ((r + 1) Hl - 1) // g + 1)
        tp = _axis_size(mesh, lmap["tp"])
        r = 0
        for a in lmap["tp"]:
            r = r * _axis_size(mesh, (a,)) + mesh.get_local_rank(a)
        hl, g = h // tp, h // kh
        heads = slice(r * hl // g, ((r + 1) * hl - 1) // g + 1)
        if hl % (heads.stop - heads.start):
            raise ValueError(f"{h} query heads over {tp} tp ranks do not "
                             f"group onto {kh} KV heads")
    q_pl, kv_pl = placements(mesh, q_spec), placements(mesh, kv_spec)
    grad_pl = None
    if sliced:
        from torch.distributed.tensor import Partial

        tp_dims = {mesh.mesh_dim_names.index(a) for a in lmap["tp"]}
        part = tuple(Partial() if i in tp_dims else p_
                     for i, p_ in enumerate(kv_pl))
        grad_pl = (q_pl, part, part) + ((kv_pl, kv_pl) if cache else ())

    def core(q_l, k_l, v_l, ck_l=None, cv_l=None):
        if ck_l is not None:
            t = k_l.shape[1]
            ck_l[:, pos:pos + t] = k_l.to(ck_l.dtype)
            cv_l[:, pos:pos + t] = v_l.to(cv_l.dtype)
            k_l, v_l = ck_l, cv_l
        return flash_attention(q_l, k_l[:, :, heads], v_l[:, :, heads], **kw)

    if cache is None:
        return local_map(core, mesh=mesh, in_placements=(q_pl, kv_pl, kv_pl),
                         out_placements=(q_pl,), in_grad_placements=grad_pl)(
            q, k, v)
    # the cache (B, S, K, hd) is laid out as K and V (the sequence whole)
    ck, cv = cache.k, cache.v
    moved = tuple(ck.placements) != tuple(kv_pl)
    if moved:
        ck, cv = ck.redistribute(mesh, kv_pl), cv.redistribute(mesh, kv_pl)
    out = local_map(core, mesh=mesh,
                    in_placements=(q_pl, kv_pl, kv_pl, kv_pl, kv_pl),
                    out_placements=(q_pl,), in_grad_placements=grad_pl)(
        q, k, v, ck, cv)
    if moved:
        cache.k.copy_(ck.redistribute(mesh, cache.k.placements))
        cache.v.copy_(cv.redistribute(mesh, cache.v.placements))
    return out


def attention_forward(
    p: Attention,
    x: torch.Tensor,                 # (B, T, d)
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float = 1e4,
    positions: torch.Tensor | None = None,
    causal: bool = True,
    sliding_window: int = 0,
    kv_chunk: int = 1024,
    cache: KVCache | None = None,
    cache_pos: int | None = None,
) -> tuple[torch.Tensor, KVCache | None]:
    """Self-attention in train / prefill / decode modes.

    * train:    cache=None                      -> attends within x
    * prefill:  cache=empty, cache_pos=0        -> fills cache[:, 0:T]
    * decode:   cache=filled, cache_pos=t, T==1 -> attends over cache[:, :t+1]

    ``cache`` is written in place and returned.
    """
    b, t, _ = x.shape
    if positions is None:
        base = 0 if cache_pos is None else int(cache_pos)
        positions = base + torch.arange(t, device=x.device)[None, :]

    q = split_heads(linear(p.wq, x), b, t, n_heads, head_dim)
    k = split_heads(linear(p.wk, x), b, t, n_kv_heads, head_dim)
    v = split_heads(linear(p.wv, x), b, t, n_kv_heads, head_dim)
    q = shard(q, "dp", None, "tp", None)
    k = shard(k, "dp", None, "tp", None)
    v = shard(v, "dp", None, "tp", None)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if cache is not None:
        if cache_pos is None:
            raise ValueError("a cache needs cache_pos")
        pos = int(cache_pos)
        if pos + t > cache.k.shape[1]:
            raise ValueError(f"positions {pos}..{pos + t} exceed the cache's "
                             f"{cache.k.shape[1]}")
        out = _attend(q, k, v, cache=cache, pos=pos, causal=True,
                      q_offset=pos, kv_valid_len=pos + t,
                      sliding_window=sliding_window, kv_chunk=kv_chunk)
    else:
        out = _attend(q, k, v, causal=causal, sliding_window=sliding_window,
                      kv_chunk=kv_chunk)
    out = out.reshape(b, t, n_heads * head_dim)
    return linear(p.wo, out), cache


def cross_attention_kv(p: Attention, enc_out: torch.Tensor, *,
                       n_kv_heads: int, head_dim: int) -> KVCache:
    """The encoder side's K/V (B, S_enc, K, hd), computed once a sequence
    (whisper's decoder); no rotary."""
    b, s, _ = enc_out.shape
    k = split_heads(linear(p.wk, enc_out), b, s, n_kv_heads, head_dim)
    v = split_heads(linear(p.wv, enc_out), b, s, n_kv_heads, head_dim)
    return KVCache(k=shard(k, "dp", None, "tp", None),
                   v=shard(v, "dp", None, "tp", None))


def cross_attention_forward(
    p: Attention,
    x: torch.Tensor,                 # (B, T, d)
    enc_kv: KVCache,                 # (B, S_enc, K, hd)
    *,
    n_heads: int,
    head_dim: int,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Every query row over every encoder key (``causal=False``), through
    the flash kernel: the tensor-core kernel for T > 1 in bf16, the
    split-KV decode for T = 1."""
    b, t, _ = x.shape
    q = split_heads(linear(p.wq, x), b, t, n_heads, head_dim)
    q = shard(q, "dp", None, "tp", None)
    out = _attend(q, enc_kv.k, enc_kv.v, causal=False, kv_chunk=kv_chunk)
    return linear(p.wo, out.reshape(b, t, n_heads * head_dim))
