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

Not ported: ``sliding_window`` (jamba, ROADMAP modules item 14, the hybrid
family) and cross-attention (whisper, the encdec family); both raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

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
    if sliding_window:
        raise NotImplementedError(
            "sliding-window attention is not ported yet (jamba, the hybrid "
            "family: ROADMAP modules item 14)")
    return kflash.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  kv_valid_len=kv_valid_len)


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

    q = linear(p.wq, x).reshape(b, t, n_heads, head_dim)
    k = linear(p.wk, x).reshape(b, t, n_kv_heads, head_dim)
    v = linear(p.wv, x).reshape(b, t, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if cache is not None:
        if cache_pos is None:
            raise ValueError("a cache needs cache_pos")
        pos = int(cache_pos)
        if pos + t > cache.k.shape[1]:
            raise ValueError(f"positions {pos}..{pos + t} exceed the cache's "
                             f"{cache.k.shape[1]}")
        cache.k[:, pos:pos + t] = k.to(cache.k.dtype)
        cache.v[:, pos:pos + t] = v.to(cache.v.dtype)
        out = flash_attention(q, cache.k, cache.v, causal=True, q_offset=pos,
                              kv_valid_len=pos + t,
                              sliding_window=sliding_window,
                              kv_chunk=kv_chunk)
    else:
        out = flash_attention(q, k, v, causal=causal,
                              sliding_window=sliding_window,
                              kv_chunk=kv_chunk)
    out = out.reshape(b, t, n_heads * head_dim)
    return linear(p.wo, out), cache


def cross_attention_forward(*args, **kwargs):
    """Cross-attention over encoder K/V (whisper's decoder): not ported."""
    raise NotImplementedError(
        "cross-attention is not ported yet (whisper, the encdec family: "
        "ROADMAP modules item 14)")
