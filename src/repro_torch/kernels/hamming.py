"""hamming: gather-fused 1-bit SimHash Hamming distance over the sign plane.

The CUDA kernels in ``csrc/hamming.cu`` replace the Pallas TPU kernel
``repro/kernels/hamming.py::_hamming_kernel``.  Unlike it, they take row
*ids* into the ``(N, 2W)`` signature table and read the sign plane (the
first W words of each row) in place, so no gathered copy and no sign-plane
copy of the table is made; they return the Hamming **distance** as int32
(``repro_torch.kernels.dispatch.bq1_ops`` negates it into a similarity, as
the reference's dispatch does).

* :func:`dist_rows` — ``q (B, W)``, ``ids (B, K)`` -> ``(B, K)``
* :func:`pairwise`  — ``ids (B, C)`` -> ``(B, C, C)``

Words are int32 bit views of the reference's uint32 words; ids are int32
and must lie in ``[0, N)``.  No valid-bit mask is needed: padding bits are
0 in the sign plane of every signature (query and table alike), so their
xor is 0.  Each entry point follows the table's device: a CPU tensor takes
the plain version (``*_plain``: xor and a SWAR popcount, word by word), a
CUDA tensor launches the kernel.  Results are integers, so kernel and
plain version agree exactly.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bq
from repro_torch.kernels import build

# one block's shared memory on an H100 (bytes), for the pairwise pool
_MAX_SMEM = 232_448

# elements per int64 temporary of the plain versions (2 MiB, cache-sized)
_BLOCK_ELEMS = 1 << 18


def _hamming_words(a, b, lead: int) -> torch.Tensor:
    """popcount(a ^ b) summed over the last (word) axis; ``a`` and ``b``
    broadcast to ``lead`` elements a word, which sets the block of words
    each int64 temporary holds."""
    w = a.shape[-1]
    step = max(1, _BLOCK_ELEMS // max(1, lead))
    out = None
    for i in range(0, w, step):
        j = min(i + step, w)
        s = bq.popcount(a[..., i:j] ^ b[..., i:j]).sum(dim=-1,
                                                       dtype=torch.int32)
        out = s if out is None else out + s
    return out


def dist_rows_plain(q, ids, table) -> torch.Tensor:
    """Hamming distance of ``q[b]`` to the sign plane of rows ``ids[b]``."""
    w = q.shape[1]
    rows = table[ids.long(), :w]                      # (B, K, W)
    return _hamming_words(q[:, None, :], rows, ids.numel())


def pairwise_plain(ids, table) -> torch.Tensor:
    """All-pairs Hamming distance within each pool of sign rows."""
    w = table.shape[1] // 2
    rows = table[ids.long(), :w]                      # (B, C, W)
    b, c = ids.shape
    return _hamming_words(rows[:, :, None, :], rows[:, None, :, :], b * c * c)


def _check(table, **named):
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no hamming route for {table.device}")
    if table.dtype != torch.int32 or table.ndim != 2 or table.shape[1] % 2:
        raise ValueError(f"table must be (N, 2W) int32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    for name, t in (("table", table), *named.items()):
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on "
                             f"{table.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if t.is_cuda and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib() -> ctypes.CDLL:
    lib = build.load("hamming")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.quiver_hamming_dist_rows.argtypes = [p, p, p, p, i, i, i, ll, p]
    lib.quiver_hamming_dist_rows.restype = i
    lib.quiver_hamming_pairwise.argtypes = [p, p, p, i, i, i, ll, p]
    lib.quiver_hamming_pairwise.restype = i
    return lib


def dist_rows(q: torch.Tensor, ids: torch.Tensor,
              table: torch.Tensor) -> torch.Tensor:
    """Hamming distance of query ``b`` to rows ``ids[b]``: (B, W) sign words
    x (B, K) ids -> (B, K) int32."""
    _check(table, q=q, ids=ids)
    b, k = ids.shape
    w = table.shape[1] // 2
    if q.shape != (b, w):
        raise ValueError(f"q must be {(b, w)}, got {tuple(q.shape)}")
    if table.device.type == "cpu":
        return dist_rows_plain(q, ids, table)
    out = torch.empty((b, k), dtype=torch.int32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    status = _lib().quiver_hamming_dist_rows(
        q.data_ptr(), ids.data_ptr(), table.data_ptr(), out.data_ptr(),
        b, k, w, table.shape[0], stream,
    )
    build.LAUNCHES["hamming_dist_rows"] += 1
    build.check(status, "hamming_dist_rows")
    return out


def pairwise(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance within each pool: (B, C) ids ->
    (B, C, C) int32."""
    _check(table, ids=ids)
    b, c = ids.shape
    if table.device.type == "cpu":
        return pairwise_plain(ids, table)
    w = table.shape[1] // 2
    if c > 1024 or c * (w + 1) * 4 > _MAX_SMEM:
        raise ValueError(f"pool of {c} rows x {w} words does not fit "
                         "one block")
    out = torch.empty((b, c, c), dtype=torch.int32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    status = _lib().quiver_hamming_pairwise(
        ids.data_ptr(), table.data_ptr(), out.data_ptr(), b, c, w,
        table.shape[0], stream,
    )
    build.LAUNCHES["hamming_pairwise"] += 1
    build.check(status, "hamming_pairwise")
    return out
