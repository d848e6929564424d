"""binarize: float32 rows -> packed 2-bit Sign-Magnitude words.

The CUDA kernel ``csrc/binarize.cu`` replaces the Pallas TPU kernel
``repro/kernels/binarize.py::_binarize_kernel``: per row, the threshold
tau = sum|x| / D, the sign plane x > 0 and the magnitude plane |x| > tau,
packed little-endian into 32-bit words ``[pos words | strong words]``.

:func:`binarize` follows the tensor's device: a CPU tensor takes the plain
version :func:`binarize_plain`, a CUDA tensor launches the kernel.  The plain
version sums |x| in the kernel's own order (each of 32 lanes sums every 32nd
element in turn, then a xor butterfly), so the two agree bit for bit.

The threshold is a float sum, and other implementations (``jnp.mean``, the
Pallas kernel's ``sum / true_dim``) add in other orders: a strong bit may
flip where |x| lies within a few ulps of tau.  :func:`strong_bit_flips`
states that tolerance and counts such flips.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

WORD_BITS = 32
_LANES = 32


def n_words(dim: int) -> int:
    """Words per bit-plane for a ``dim``-dimensional vector."""
    return (dim + WORD_BITS - 1) // WORD_BITS


def _padded(x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., W, 32), zero-padded past D."""
    *lead, d = x.shape
    w = n_words(d)
    if w * WORD_BITS != d:
        x = torch.nn.functional.pad(x, (0, w * WORD_BITS - d))
    return x.reshape(*lead, w, WORD_BITS)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack (..., D) bool into (..., W) int32 words: bit d lands at bit
    d % 32 of word d // 32 (little-endian within a word)."""
    g = _padded(bits).to(torch.int64)
    shifts = torch.arange(WORD_BITS, device=bits.device, dtype=torch.int64)
    v = (g << shifts).sum(-1)                     # in [0, 2**32)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def threshold_plain(x: torch.Tensor) -> torch.Tensor:
    """(N, D) float32 -> (N, 1) tau, summed in the kernel's order."""
    a = _padded(x.abs())
    lane_sum = torch.zeros_like(a[:, 0])          # (N, 32): one per lane
    for j in range(a.shape[1]):
        lane_sum = lane_sum + a[:, j]
    lanes = torch.arange(_LANES, device=x.device)
    off = _LANES // 2
    while off:                                    # __shfl_xor_sync butterfly
        lane_sum = lane_sum + lane_sum[:, lanes ^ off]
        off //= 2
    # a tensor divisor: division by a Python scalar may become a multiply
    # by its reciprocal, which rounds differently
    return lane_sum[:, :1] / torch.full_like(lane_sum[:, :1], x.shape[1])


def binarize_plain(x: torch.Tensor) -> torch.Tensor:
    """(N, D) float32 -> (N, 2W) int32 words; the kernel's plain version."""
    tau = threshold_plain(x)
    return torch.cat([pack_bits(x > 0), pack_bits(x.abs() > tau)], dim=-1)


def _lib() -> ctypes.CDLL:
    lib = build.load("binarize")
    fn = lib.quiver_binarize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def binarize_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a (N, D) float32 CUDA tensor."""
    if not x.is_cuda:
        raise ValueError("binarize_cuda needs a CUDA tensor")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(
            f"binarize takes a contiguous (N, D) float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype}"
        )
    n, d = x.shape
    if d == 0 or n >= 2**31:
        raise ValueError(f"binarize cannot take shape {(n, d)}")
    out = torch.empty((n, 2 * n_words(d)), dtype=torch.int32,
                      device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.quiver_binarize(x.data_ptr(), out.data_ptr(), n, d, stream)
    build.LAUNCHES["binarize"] += 1
    build.check(status, "binarize")
    return out


def binarize(x: torch.Tensor) -> torch.Tensor:
    """(N, D) float32 -> (N, 2W) int32 packed words, on ``x``'s device."""
    if x.device.type == "cpu":
        return binarize_plain(x)
    return binarize_cuda(x)


def strong_bit_flips(words: np.ndarray, ref_words: np.ndarray,
                     x: np.ndarray, *, ulps: int = 4) -> int:
    """Count strong-plane bits that differ between two encodings of ``x``.

    The tolerance between two implementations of the encode: sign words
    are equal, and a strong bit may differ only at a coordinate where
    ``| |x| - tau | <= ulps * ulp(tau)``, with tau the row's mean |x|
    taken in float64.  Raises ``AssertionError`` on anything else.
    Words may be int32 or uint32 views; ``x`` is (N, D) float32.
    """
    a = np.ascontiguousarray(words).view(np.uint32)
    b = np.ascontiguousarray(ref_words).view(np.uint32)
    x = np.asarray(x, dtype=np.float32)
    n, d = x.shape
    w = n_words(d)
    assert a.shape == b.shape == (n, 2 * w), (a.shape, b.shape, (n, 2 * w))
    bad = np.nonzero((a[:, :w] != b[:, :w]).any(axis=1))[0]
    assert bad.size == 0, f"sign words differ in rows {bad[:8].tolist()}"
    diff = a[:, w:] ^ b[:, w:]
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    flipped = ((diff[:, :, None] >> shifts) & 1).reshape(n, -1)[:, :d] > 0
    absx = np.abs(x)
    tau = absx.astype(np.float64).mean(axis=1, keepdims=True)
    band = ulps * np.spacing(tau.astype(np.float32)).astype(np.float64)
    inside = np.abs(absx - tau) <= band
    rows, cols = np.nonzero(flipped & ~inside)
    assert rows.size == 0, (
        f"{rows.size} strong bits differ outside the {ulps}-ulp band of tau, "
        f"first at (row, dim) {(int(rows[0]), int(cols[0]))}"
    )
    return int(flipped.sum())
