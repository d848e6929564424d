"""list_scan: similarity of every query to every IVF list centroid.

The CUDA kernel ``csrc/list_scan.cu`` replaces the Pallas TPU kernel
``repro/kernels/list_scan.py::_list_scan_kernel``: ``(Q, 2W)`` query words
against ``(L, 2W)`` centroid words -> ``(Q, L)`` int32 **positive** Table-1
similarity (larger = nearer), the IVF layer's coarse-routing primitive.
Unlike the Pallas kernel, whose caller pads Q to 8 and L to 128 with zero
signatures, it takes any Q and L and masks the ragged edges itself, and it
tiles the centroids, so no L is too large for a block's shared memory.

:func:`scan` follows the tensors' device: CPU tensors take the plain version
:func:`scan_plain` (a matmul of the decoded +-1/+-2 levels, exact in
float32), CUDA tensors launch the kernel.  Results are integers, so kernel
and plain version agree exactly.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bq_distance import _check, masked_levels


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
