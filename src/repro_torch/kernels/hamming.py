"""hamming: gather-fused 1-bit SimHash Hamming distance over the sign plane.

The CUDA kernels in ``csrc/hamming.cu`` replace the Pallas TPU kernel
``repro/kernels/hamming.py::_hamming_kernel``.  They are the 1-bit cases of
the kernels ``bq_distance`` runs for the 2-bit space (the gather in
``csrc/bq_gather.cuh``, the pool in ``csrc/bq_pool.cuh``).  Unlike the
Pallas kernel, they take row *ids* into the ``(N, 2W)`` signature table and
read the sign plane (the first W words of each row) in place, so no
gathered copy and no sign-plane copy of the table is made; they return the
Hamming **distance** as int32 (``repro_torch.kernels.dispatch.bq1_ops``
negates it into a similarity, as the reference's dispatch does).

* :func:`dist_rows` — ``q (B, W)``, ``ids (B, K)`` -> ``(B, K)``: a gather,
  groups of lanes reading 16-byte vectors of each row's sign plane (4-byte
  words where W is not a multiple of 4: the ``hamming_dist_rows_vec4`` and
  ``hamming_dist_rows_vec1`` variants), one popcount of the xor a word
  pair.  Padding bits are 0 in the sign plane of every signature (query and
  table alike), so their xor is 0 and no mask is needed.
* :func:`pairwise`  — ``ids (B, C)``, ``mask (W,)`` -> ``(B, C, C)``: the
  pool's sign bits decoded to +-1 int8 levels (0 at a masked bit) and
  multiplied on the tensor cores, the tiles on and above the diagonal only,
  each written as ``(D - s) // 2`` with its mirror
  (:func:`hamming_from_levels` is that arithmetic in torch).

Words are int32 bit views of the reference's uint32 words; ``mask`` is the
``(W,)`` valid-bit mask (``repro_torch.core.bq.valid_mask``); ids are int32
and must lie in ``[0, N)``.  Each entry point follows the table's device: a
CPU tensor takes the plain version (``*_plain``: xor and a SWAR popcount,
word by word), a CUDA tensor launches the kernel.  Results are integers, so
kernel and plain version agree exactly.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bq
from repro_torch.kernels import build
from repro_torch.kernels.bq_distance import launch_pool, rows_vector_words

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


def pairwise_plain(ids, table, mask) -> torch.Tensor:
    """All-pairs Hamming distance within each pool of sign rows, over the
    bits of the ``(W,)`` valid-bit mask (as the kernel counts them: a set
    bit outside it differs from nothing)."""
    rows = table[ids.long(), :mask.shape[0]] & mask   # (B, C, W)
    b, c = ids.shape
    return _hamming_words(rows[:, :, None, :], rows[:, None, :, :], b * c * c)


def hamming_from_levels(pa, pb, mask) -> torch.Tensor:
    """The Hamming distance as the ``pairwise`` kernel reckons it, from
    broadcasting ``(..., W)`` sign words and the ``(W,)`` valid-bit mask.

    Each valid bit decodes to a level of +1 (set) or -1 (clear), each
    padding bit to 0; over the D valid bits, h of them differing, the dot
    product of two rows' levels is s = D - 2h, so h = (D - s) // 2."""
    dim = mask.shape[0] * bq.WORD_BITS
    keep = bq.unpack_bits(mask, dim).to(torch.int32)

    def levels(words):
        return (2 * bq.unpack_bits(words, dim).to(torch.int32) - 1) * keep

    s = (levels(pa) * levels(pb)).sum(dim=-1, dtype=torch.int32)
    return (keep.sum(dtype=torch.int32) - s) // 2


def _check(table, mask=None, **named):
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no hamming route for {table.device}")
    if table.dtype != torch.int32 or table.ndim != 2 or table.shape[1] % 2:
        raise ValueError(f"table must be (N, 2W) int32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if mask is not None:
        if mask.shape != (table.shape[1] // 2,):
            raise ValueError(f"mask must be ({table.shape[1] // 2},), got "
                             f"{tuple(mask.shape)}")
        named["mask"] = mask
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
    lib.quiver_hamming_dist_rows.argtypes = [p, p, p, p, i, i, i, ll, i, p]
    lib.quiver_hamming_dist_rows.restype = i
    lib.quiver_hamming_pairwise.argtypes = [p, p, p, p, i, i, i, ll, p]
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
    vec = rows_vector_words(w)
    if vec == 4 and any(t.data_ptr() % 16 for t in (q, table)):
        raise ValueError("dist_rows reads q and table in 16-byte vectors: "
                         "their data must be 16-byte aligned")
    out = torch.empty((b, k), dtype=torch.int32, device=table.device)
    lib = _lib()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    status = lib.quiver_hamming_dist_rows(
        q.data_ptr(), ids.data_ptr(), table.data_ptr(), out.data_ptr(),
        b, k, w, table.shape[0], vec, stream,
    )
    build.LAUNCHES["hamming_dist_rows"] += 1
    build.LAUNCHES[f"hamming_dist_rows_vec{vec}"] += 1
    build.check(status, "hamming_dist_rows")
    return out


def pairwise(ids: torch.Tensor, table: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance within each pool: (B, C) ids ->
    (B, C, C) int32."""
    _check(table, mask, ids=ids)
    if table.device.type == "cpu":
        return pairwise_plain(ids, table, mask)
    return launch_pool(_lib().quiver_hamming_pairwise, "hamming_pairwise",
                       ids, table, mask)
