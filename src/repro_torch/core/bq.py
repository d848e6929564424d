"""2-bit Sign-Magnitude binary quantization (QuIVer §3.1), in torch.

Counterpart of ``repro/core/bq.py``.  Encoding (training-free):

    tau_v    = mean(|v_1| ... |v_D|)
    pos_i    = 1[v_i > 0]
    strong_i = 1[|v_i| > tau_v]

A packed signature matrix is ``(N, 2W)`` with ``W = ceil(D/32)``: columns
``[0, W)`` hold the sign words, ``[W, 2W)`` the magnitude words, bit ``d``
at bit ``d % 32`` of word ``d // 32``.  torch's uint32 support is thin, so
words are held as **int32 bit views** of the reference's uint32 words
(``np.ndarray.view(np.int32)`` / ``.view(np.uint32)`` at the numpy
boundary).  Two consequences run through this module: ``>>`` on a negative
int32 is arithmetic, and ``~`` sets the padding bits, so shifted or
complemented words are masked (or widened to int64) before they are used.

``encode`` goes through ``repro_torch.kernels.binarize`` (the CUDA kernel
for CUDA tensors, its plain version on the CPU).  The similarity here is
the plain broadcasting form; the hot path scores through
``repro_torch.kernels.dispatch``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# the codec's word layout lives with the encode kernel; re-exported here
from repro_torch.kernels.binarize import (  # noqa: F401
    WORD_BITS,
    binarize,
    n_words,
    pack_bits,
    threshold_plain,
)


def valid_mask(dim: int, device=None) -> torch.Tensor:
    """(W,) int32 words with ones at bit positions < dim."""
    bits = torch.arange(n_words(dim) * WORD_BITS, device=device) < dim
    return pack_bits(bits)


class Signature(NamedTuple):
    """Packed 2-bit Sign-Magnitude signatures (struct-of-arrays)."""

    words: torch.Tensor  # (..., 2W) int32 — [pos words | strong words]
    dim: int             # original float dimensionality D

    @property
    def w(self) -> int:
        return self.words.shape[-1] // 2

    @property
    def pos(self) -> torch.Tensor:
        return self.words[..., : self.w]

    @property
    def strong(self) -> torch.Tensor:
        return self.words[..., self.w:]

    @property
    def nbytes_per_vector(self) -> int:
        return 2 * self.w * 4


def unpack_bits(words: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> (..., dim) bool."""
    shifts = torch.arange(WORD_BITS, device=words.device, dtype=torch.int32)
    # arithmetic shift of a negative word fills with ones, but bit 0 of
    # (word >> s) is still bit s of the word
    bits = (words[..., None] >> shifts) & 1
    bits = bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS)
    return bits[..., :dim].bool()


def sign_magnitude_bits(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Float vectors (..., D) -> (pos, strong) bool planes, each (..., D)."""
    flat = x.reshape(-1, x.shape[-1])
    tau = threshold_plain(flat).reshape(*x.shape[:-1], 1)
    return x > 0, x.abs() > tau


def encode(x: torch.Tensor) -> Signature:
    """Encode float32 vectors (..., D) -> packed :class:`Signature`."""
    d = x.shape[-1]
    flat = x.reshape(-1, d).to(torch.float32).contiguous()
    words = binarize(flat)
    return Signature(words=words.reshape(*x.shape[:-1], -1), dim=d)


def decode_levels(sig: Signature) -> torch.Tensor:
    """Reconstruction levels +-1 / +-2 (weak/strong), (..., D) float32."""
    pos = unpack_bits(sig.pos, sig.dim).to(torch.float32)
    strong = unpack_bits(sig.strong, sig.dim).to(torch.float32)
    return (2.0 * pos - 1.0) * (1.0 + strong)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 bit views (SWAR on int64) -> int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def symmetric_similarity_words(pa, sa, pb, sb, mask) -> torch.Tensor:
    """Table-1 weighted similarity from word arrays.

    The four word arrays broadcast over leading dims; the last dim is W
    words and ``mask`` the (W,) valid-bit mask.  Returns int32 with shape
    = broadcast(leading dims).
    """
    diff = pa ^ pb  # padding bits are 0 in both planes
    same = ~diff & mask
    both_strong = sa & sb
    one_strong = sa ^ sb
    both_weak = ~(sa | sb) & mask

    def pc(v):
        return popcount(v).sum(dim=-1, dtype=torch.int32)

    return (
        4 * pc(same & both_strong)
        + 2 * pc(same & one_strong)
        + pc(same & both_weak)
        - 4 * pc(diff & both_strong)
        - 2 * pc(diff & one_strong)
        - pc(diff & both_weak)
    )


def pairwise_distance(queries: Signature, base: Signature) -> torch.Tensor:
    """(Q, 2W) x (N, 2W) signatures -> (Q, N) int32 distances (-similarity)."""
    if queries.dim != base.dim:
        raise ValueError(f"dims differ: {queries.dim} vs {base.dim}")
    mask = valid_mask(queries.dim, device=base.words.device)
    qp = queries.pos[..., :, None, :]
    qs = queries.strong[..., :, None, :]
    bp = base.pos[..., None, :, :]
    bs = base.strong[..., None, :, :]
    return -symmetric_similarity_words(qp, qs, bp, bs, mask)


def hamming_distance_1bit(a: Signature, b: Signature) -> torch.Tensor:
    """1-bit SimHash Hamming distance (sign plane only), int32; padding
    bits are 0 in both planes, so they never count."""
    if a.dim != b.dim:
        raise ValueError(f"dims differ: {a.dim} vs {b.dim}")
    return popcount(a.pos ^ b.pos).sum(dim=-1, dtype=torch.int32)


def pairwise_hamming_1bit(queries: Signature, base: Signature) -> torch.Tensor:
    """(Q, 2W) x (N, 2W) signatures -> (Q, N) int32 Hamming distances."""
    x = queries.pos[..., :, None, :] ^ base.pos[..., None, :, :]
    return popcount(x).sum(dim=-1, dtype=torch.int32)


def adc_distance(query_f32: torch.Tensor, base: Signature) -> torch.Tensor:
    """Asymmetric distance -<q, decode(sig)>: (Q, D) float32 queries x
    (N, 2W) signatures -> (Q, N) float32 (the §3.3 ablation baseline)."""
    return -(query_f32 @ decode_levels(base).T)


def distance_upper_bound(dim: int) -> int:
    """Max possible |distance| value: every dim both-strong mismatched."""
    return 4 * dim


def signature_bytes(n: int, dim: int) -> int:
    """Hot-path signature memory for n vectors (paper Table 2 accounting)."""
    return n * 2 * n_words(dim) * 4
