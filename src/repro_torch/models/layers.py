"""Shared building blocks: norms, linears, embeddings, rotary, activations.

Counterpart of ``repro/models/layers.py``.  Parameters live in small
``nn.Module``s (:class:`Linear`, :class:`Norm`, :class:`Embedding`) whose
tensors keep the reference's layout, so ``x @ w`` is the same product:
a linear's ``w`` is ``(d_in, d_out)``, an embedding's ``(vocab, d)``.  The
functions take those modules where the reference takes its param dicts.
Compute follows the reference: matrices in their own dtype (bf16 by
default), norms and rotary in float32 and cast back.  Parameters are
trainable; the serving entry points run under ``torch.no_grad``.
"""

from __future__ import annotations

import torch
from torch import nn


class Linear(nn.Module):
    """``x @ w`` with ``w`` of shape (d_in, d_out)."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)


class Norm(nn.Module):
    """An RMSNorm's float32 ``scale`` of shape (d,)."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale)


class Embedding(nn.Module):
    """A token table ``w`` of shape (vocab, d)."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    return x @ p.w


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p.scale).to(x.dtype)


def embed(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``p.w`` at ``tokens`` (``F.embedding``: a gather whose
    backward DTensor shards in every torch release this repository runs,
    where ``p.w[tokens]``'s ``index_put`` backward is refused by torch
    2.11's DTensor on a batch-sharded index)."""
    return torch.nn.functional.embedding(tokens, p.w)


# -- rotary -----------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    # a Python-scalar base: no host-to-device copy (which would synchronise
    # the host with the card twice a layer)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., T, H, hd); positions: (..., T) integers.  Each head is split
    into two halves (``x1, x2``), not interleaved pairs; computed in
    float32 and cast back to ``x``'s dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)       # (hd/2,)
    angles = positions[..., :, None].float() * freqs            # (.., T, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                   # (.., T, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(t: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (T, d), float32: the sines
    of ``pos / 10000^(2i / d)`` for i < d / 2, then their cosines.  The
    angles are taken in float64, as the reference's numpy does, and
    rounded once."""
    pos = torch.arange(t, dtype=torch.float64)[:, None]
    i = torch.arange(d // 2, dtype=torch.float64)[None, :]
    angles = pos / (10000 ** (2 * i / d))
    out = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    return out.to(device=device, dtype=torch.float32)


# -- activations -------------------------------------------------------------


def silu(x):
    return x * torch.sigmoid(x)


def squared_relu(x):
    r = torch.clamp(x, min=0)
    return r * r


def gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "silu": silu,
    "gelu": gelu,
    "squared_relu": squared_relu,
}
