"""list_scan: similarity of every query to every IVF list centroid.

The CUDA kernel ``csrc/list_scan.cu`` replaces the Pallas TPU kernel
``repro/kernels/list_scan.py::_list_scan_kernel``: ``(Q, 2W)`` query words
against ``(L, 2W)`` centroid words -> ``(Q, L)`` int32 **positive** Table-1
similarity (larger = nearer), the IVF layer's coarse-routing primitive.
Unlike the Pallas kernel, whose caller pads Q to 8 and L to 128 with zero
signatures, it takes any Q and L and masks the ragged edges itself.

The similarity is the integer dot product of the signatures' levels
(:func:`int8_levels`: +-1 by sign, x2 where strong, 0 at a masked padding
bit), which the kernel decodes into shared memory chunk by chunk and
multiplies on the int8 tensor cores (``mma.sync`` m16n8k32, int32 sums).

:func:`scan` follows the tensors' device: CPU tensors take the plain version
:func:`scan_plain` (a matmul of the same levels, exact in float32), CUDA
tensors launch the kernel.  Results are integers, so kernel and plain
version agree exactly.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bq_distance import _check, masked_levels


def int8_levels(words, mask) -> torch.Tensor:
    """(R, 2W) words -> (R, 32W) int8 levels: the level of dimension
    32w + i (bit i of word w of each plane) in column 32w + i, +-1 by the
    sign bit, x2 where the strong bit is set, 0 past the valid bits.  A
    similarity is the integer dot product of two rows.  The kernel stages
    the same levels in shared memory with the 32 columns of each word in
    an order of its own (``csrc/int8_levels.cuh``), which a dot product of
    two rows staged alike does not see."""
    return masked_levels(words, mask).to(torch.int8)


def scan_plain(q_words, cent_words, mask) -> torch.Tensor:
    """The similarity matrix is Lq @ Lc^T of the decoded levels."""
    lq = masked_levels(q_words, mask)
    lc = masked_levels(cent_words, mask)
    return torch.matmul(lq, lc.T).to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = build.load("list_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quiver_list_scan.argtypes = [p, p, p, p, i, i, i, p]
    lib.quiver_list_scan.restype = i
    return lib


def scan(q_words: torch.Tensor, cent_words: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """(Q, 2W) query words x (L, 2W) centroid words -> (Q, L) int32
    similarity; ``mask`` is the ``(W,)`` valid-bit mask."""
    _check(cent_words, mask, q_words=q_words)
    if q_words.ndim != 2 or q_words.shape[1] != cent_words.shape[1]:
        raise ValueError(f"q_words must be (Q, {cent_words.shape[1]}), got "
                         f"{tuple(q_words.shape)}")
    if cent_words.device.type == "cpu":
        return scan_plain(q_words, cent_words, mask)
    n_q, n_l = q_words.shape[0], cent_words.shape[0]
    out = torch.empty((n_q, n_l), dtype=torch.int32,
                      device=cent_words.device)
    stream = torch.cuda.current_stream(cent_words.device).cuda_stream
    status = _lib().quiver_list_scan(
        q_words.data_ptr(), cent_words.data_ptr(), mask.data_ptr(),
        out.data_ptr(), n_q, n_l, mask.shape[0], stream,
    )
    build.LAUNCHES["list_scan"] += 1
    build.check(status, "list_scan")
    return out
