"""bq_distance: gather-fused symmetric 2-bit Sign-Magnitude similarity.

The CUDA kernels in ``csrc/bq_distance.cu`` (the 2-bit cases of the gather
in ``csrc/bq_gather.cuh`` and the pool in ``csrc/bq_pool.cuh``) replace the
Pallas TPU kernel ``repro/kernels/bq_distance.py::_bq_distance_kernel``.
Unlike it, they take
row *ids* into the ``(N, 2W)`` signature table and read the rows themselves
(no gathered copy), and they return the Table-1 **similarity** as int32 (the
Pallas kernel emits its negation, which ``repro.kernels.dispatch`` undoes).

* :func:`dist_rows` — ``q (B, 2W)``, ``ids (B, K)`` -> ``(B, K)``: a gather,
  groups of lanes reading 16-byte vectors of each row (4-byte words where
  W is not a multiple of 4: the ``bq_dist_rows_vec4`` and
  ``bq_dist_rows_word`` variants), scored by the three-popcount identity of
  :func:`similarity_three_popcounts`.
* :func:`pairwise`  — ``ids (B, C)`` -> ``(B, C, C)``: the pool's int8
  levels multiplied on the tensor cores, the tiles on and above the
  diagonal only, each written with its mirror.

Words are int32 bit views of the reference's uint32 words; ``mask`` is the
``(W,)`` valid-bit mask (``repro_torch.core.bq.valid_mask``); ids are int32
and must lie in ``[0, N)``.  Each entry point follows the table's device: a
CPU tensor takes the plain version (``*_plain``: Table 1's popcount formula
for ``dist_rows``, a matmul of decoded +-1/+-2 levels for ``pairwise``), a
CUDA tensor launches the kernel.  Results are integers, so kernel and plain
version agree exactly.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bq
from repro_torch.kernels import build

# the pool kernels (csrc/bq_pool.cuh, launched by launch_pool): pool rows a
# tile; the tile pairs above the diagonal are one grid dimension, at most
# 65 535 (362 tiles)
_POOL_TILE = 128
_MAX_POOL = 362 * _POOL_TILE
# dist_rows_plain: elements per int64 temporary (2 MiB, cache-sized)
_BLOCK_ELEMS = 1 << 18


def dist_rows_plain(q, ids, table, mask) -> torch.Tensor:
    """Table 1's popcount formula over the gathered rows, in blocks of
    words that keep each int64 temporary near ``_BLOCK_ELEMS``."""
    rows = table[ids.long()]                          # (B, K, 2W)
    a = q[:, None, :]
    w = mask.shape[0]
    step = max(1, _BLOCK_ELEMS // max(1, rows.shape[0] * rows.shape[1]))
    out = None
    for i in range(0, w, step):
        j = min(i + step, w)
        s = bq.symmetric_similarity_words(
            a[..., i:j], a[..., w + i:w + j],
            rows[..., i:j], rows[..., w + i:w + j], mask[i:j],
        )
        out = s if out is None else out + s
    return out


def similarity_three_popcounts(pa, sa, pb, sb, mask) -> torch.Tensor:
    """Table 1's similarity as the ``dist_rows`` kernel reckons it, from
    the same broadcasting word arrays as
    :func:`repro_torch.core.bq.symmetric_similarity_words`.

    With d = pa ^ pb, x = sa ^ sb and o = sa | sb, a valid bit's weight is
    1 + 3 o - 2 (d ^ x) - 6 (d & o): +-1 where both are weak, +-2 where one
    is strong, +-4 where both are, positive where the signs agree.  Padding
    bits are 0 in every plane and weigh 0 but for the 1, so
    sim = D + 3 pop(o) - 2 pop(d ^ x) - 6 pop(d & o): three popcounts a
    word pair and no mask, where Table 1's formula takes six and the
    mask."""
    d = pa ^ pb
    o = sa | sb

    def pc(v):
        return bq.popcount(v).sum(dim=-1, dtype=torch.int32)

    return pc(mask) + 3 * pc(o) - 2 * pc(d ^ sa ^ sb) - 6 * pc(d & o)


def masked_levels(words, mask) -> torch.Tensor:
    """(..., 2W) words -> (..., 32W) float32 +-1/+-2 levels, 0 past the
    valid bits.  Table 1's weights are the products of these levels, so a
    similarity is their dot product: a whole number below 2**24, exact in
    float32 in any order."""
    dim = mask.shape[0] * bq.WORD_BITS
    # padding dims decode to -1; the mask zeroes them
    keep = bq.unpack_bits(mask, dim).to(torch.float32)
    return bq.decode_levels(bq.Signature(words, dim)) * keep


def pairwise_plain(ids, table, mask) -> torch.Tensor:
    """A pool's similarity matrix is L @ L^T of its rows' levels."""
    levels = masked_levels(table[ids.long()], mask)   # (B, C, 32W)
    return torch.bmm(levels, levels.transpose(1, 2)).to(torch.int32)


def _check(table, mask, **named):
    w = mask.shape[0]
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bq_distance route for {table.device}")
    if table.dtype != torch.int32 or table.ndim != 2 \
            or table.shape[1] != 2 * w:
        raise ValueError(
            f"table must be (N, {2 * w}) int32, got "
            f"{tuple(table.shape)} {table.dtype}"
        )
    for name, t in (("table", table), ("mask", mask), *named.items()):
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on "
                             f"{table.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if t.is_cuda and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib() -> ctypes.CDLL:
    lib = build.load("bq_distance")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.quiver_bq_dist_rows.argtypes = [p, p, p, p, p, i, i, i, ll, i, p]
    lib.quiver_bq_dist_rows.restype = i
    lib.quiver_bq_pairwise.argtypes = [p, p, p, p, i, i, i, ll, p]
    lib.quiver_bq_pairwise.restype = i
    return lib


def rows_vector_words(w: int) -> int:
    """Words a lane of ``dist_rows`` reads at once: 4 (a 16-byte vector)
    where a plane's W words split into whole vectors, else 1."""
    return 4 if w % 4 == 0 else 1


def dist_rows(q: torch.Tensor, ids: torch.Tensor, table: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Similarity of query ``b`` to rows ``ids[b]``: (B, 2W) x (B, K) ->
    (B, K) int32."""
    _check(table, mask, q=q, ids=ids)
    b, k = ids.shape
    if q.shape != (b, table.shape[1]):
        raise ValueError(f"q must be {(b, table.shape[1])}, got "
                         f"{tuple(q.shape)}")
    if table.device.type == "cpu":
        return dist_rows_plain(q, ids, table, mask)
    w = mask.shape[0]
    vec = rows_vector_words(w)
    if vec == 4 and any(t.data_ptr() % 16 for t in (q, table, mask)):
        raise ValueError("dist_rows reads q, table and mask in 16-byte "
                         "vectors: their data must be 16-byte aligned")
    out = torch.empty((b, k), dtype=torch.int32, device=table.device)
    lib = _lib()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    status = lib.quiver_bq_dist_rows(
        q.data_ptr(), ids.data_ptr(), table.data_ptr(), mask.data_ptr(),
        out.data_ptr(), b, k, w, table.shape[0], vec, stream,
    )
    build.LAUNCHES["bq_dist_rows"] += 1
    build.LAUNCHES["bq_dist_rows_vec4" if vec == 4
                   else "bq_dist_rows_word"] += 1
    build.check(status, "bq_dist_rows")
    return out


def launch_pool(fn, name: str, ids: torch.Tensor, table: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Launch a pool kernel of ``csrc/bq_pool.cuh`` through ``fn``, its
    library's ``quiver_*_pairwise`` entry point, on checked CUDA tensors:
    (B, C) ids -> (B, C, C) int32.  Counts the call under ``name``, under
    ``<name>_c<C>`` by pool size (the build's chunks, prune_pool, against
    consolidation's, R_total) and, for C > 128, the second launch, over the
    tiles above the diagonal, under ``<name>_offdiag``."""
    b, c = ids.shape
    if c > _MAX_POOL:
        raise ValueError(f"pairwise takes pools of at most {_MAX_POOL} "
                         f"rows, got {c}")
    out = torch.empty((b, c, c), dtype=torch.int32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    status = fn(ids.data_ptr(), table.data_ptr(), mask.data_ptr(),
                out.data_ptr(), b, c, mask.shape[0], table.shape[0], stream)
    build.LAUNCHES[name] += 1
    build.LAUNCHES[f"{name}_c{c}"] += 1
    if c > _POOL_TILE:
        build.LAUNCHES[f"{name}_offdiag"] += 1
    build.check(status, name)
    return out


def pairwise(ids: torch.Tensor, table: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """All-pairs similarity within each pool: (B, C) ids -> (B, C, C) int32."""
    _check(table, mask, ids=ids)
    if table.device.type == "cpu":
        return pairwise_plain(ids, table, mask)
    return launch_pool(_lib().quiver_bq_pairwise, "bq_pairwise", ids, table,
                       mask)
