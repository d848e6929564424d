"""IVF-over-BQ: k-means-free coarse partition in signature space.

Counterpart of ``repro/ivf/partition.py``: split the corpus into L ~ sqrt(N)
inverted lists whose centroids are majority signatures in 2-bit
Sign-Magnitude space, with no k-means and no float training pass:

1. a seeded permutation picks L seed signatures, one uniform draw per
   random shard, so seed density follows data density;
2. a few rounds of majority-vote refinement over a node subsample: each
   round assigns the subsample to the current centroids with the list-scan
   kernel (``kernels.dispatch.list_scan_ops``), then re-encodes every
   list's mean decoded +-1/+-2 level vector as its new centroid;
3. one full assignment scan maps every node to a refined centroid, capped
   at ``ceil(balance * N / L)`` members a list;
4. a contiguous layout: ``member_ids`` is one (N,) permutation,
   ``offsets`` its (L+1,) prefix, and ``list_ids`` the (L, cap) -1-padded
   gather view; ``cent_ids`` snaps each list to its nearest real member
   (``linking.shard_medoids``).

Signatures, ``cent_words`` and ``list_ids`` live on the signatures' device;
the host parts (the seeded permutation, the subsample, the capped
assignment's ``argpartition`` and greedy loop, the layout) stay numpy and
make the same calls on the same int32 arrays as the reference, so ties
break the same way.  The partition is a pure function of (signatures,
n_lists, seed, sample).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import bq, linking
from repro_torch.core.metric import MetricArrays, make_backend
from repro_torch.kernels import dispatch

_PREFIX = "ivf_"
_ASSIGN_CHUNK = 8192
# refinement subsample: ~this many members per list feed each round's
# majority vote (the final assignment always scans every node)
_REFINE_PER_LIST = 32
# capacity-bounded assignment keeps this many ranked list choices per
# node before falling back to the globally emptiest list
_BALANCE_PREFS = 8


def default_n_lists(n: int) -> int:
    """~sqrt(N) lists (each list ~sqrt(N) members), clamped for tiny corpora."""
    return max(2, min(n, round(math.sqrt(max(n, 1)))))


@dataclasses.dataclass
class IVFPartition:
    """The coarse list structure (hot: ``cent_words`` + ``list_ids``).

    ``member_ids``/``offsets`` are the canonical contiguous layout (list
    l's members are ``member_ids[offsets[l]:offsets[l+1]]``); ``list_ids``
    is the derived (L, cap) -1-padded view that search gathers with one
    ``list_ids[top_p]``; cap is the largest list rounded up to 8.
    """

    cent_words: torch.Tensor         # (L, 2W) int32 words — device-hot
    list_ids: torch.Tensor           # (L, cap) int32, -1 padded — device-hot
    cent_ids: np.ndarray             # (L,) int32 medoid node ids
    assign: np.ndarray               # (N,) int32 list id per node
    offsets: np.ndarray              # (L+1,) int64 contiguous-layout prefix
    member_ids: np.ndarray           # (N,) int32 contiguous layout
    dim: int
    seed: int = 0

    @property
    def n_lists(self) -> int:
        return int(self.cent_words.shape[0])

    @property
    def cap(self) -> int:
        return int(self.list_ids.shape[1])

    @property
    def default_probes(self) -> int:
        """Serve-time top-p default: ~L/3 probed lists."""
        return min(self.n_lists, max(2, -(-self.n_lists // 3)))

    @property
    def build_probes(self) -> int:
        """Construction-time top-p default: ~4 sqrt(L) probed lists."""
        return min(self.n_lists,
                   max(2, round(4 * math.sqrt(self.n_lists))))

    def memory_bytes(self) -> int:
        """Hot bytes of the IVF tier (centroid signatures + list layout),
        as ``memory_breakdown`` reports them."""
        return int(
            self.cent_words.numel() * 4
            + self.list_ids.numel() * 4
            + self.offsets.size * 8
        )

    # -- persistence (merged into index npz archives) ----------------------

    def to_npz_fields(self, prefix: str = _PREFIX) -> dict:
        return {
            prefix + "cent_words":
                self.cent_words.cpu().numpy().view(np.uint32),
            prefix + "cent_ids": self.cent_ids,
            prefix + "assign": self.assign,
            prefix + "offsets": self.offsets,
            prefix + "member_ids": self.member_ids,
            prefix + "dim": np.int64(self.dim),
            prefix + "seed": np.int64(self.seed),
            prefix + "cap": np.int64(self.cap),
        }

    @classmethod
    def from_npz(cls, z, device, prefix: str = _PREFIX):
        """Rebuild from an index archive onto ``device``; None when the
        archive carries no partition."""
        if prefix + "cent_words" not in z:
            return None
        offsets = z[prefix + "offsets"].astype(np.int64)
        member_ids = z[prefix + "member_ids"].astype(np.int32)
        words = np.ascontiguousarray(z[prefix + "cent_words"]).view(np.int32)
        list_ids = _layout_to_list_ids(member_ids, offsets,
                                       int(z[prefix + "cap"][()]))
        return cls(
            cent_words=torch.tensor(words, device=device),
            list_ids=torch.tensor(list_ids, device=device),
            cent_ids=z[prefix + "cent_ids"].astype(np.int32),
            assign=z[prefix + "assign"].astype(np.int32),
            offsets=offsets,
            member_ids=member_ids,
            dim=int(z[prefix + "dim"][()]),
            seed=int(z[prefix + "seed"][()]),
        )


def _xla_chunk_bounds(d: int) -> list[int]:
    """Where XLA's CPU backend cuts a row of ``d`` values into windows of
    32 when it sums it: a reduction of more than 32 values is rewritten as
    a window-32 reduction padded at both ends (the smaller pad first), so
    ``32 + d % 32`` values (when ``d % 32`` is not 0) are shared between a
    first window (the larger half) and a last one.  A row of at most 32
    values is one window."""
    if d <= 32:
        return [0, d]
    extra = 32 + d % 32
    if extra == 32:
        return list(range(0, d + 1, 32))
    head = (extra + 1) // 2
    return [0, *range(head, d - (extra - head) + 1, 32), d]


def _xla_window_sums(a: torch.Tensor) -> torch.Tensor:
    """(R, d) -> (R, n_windows): each window of :func:`_xla_chunk_bounds`
    summed left to right."""
    d = a.shape[1]
    b = _xla_chunk_bounds(d)
    if len(b) == 2:
        s = a[:, 0]
        for j in range(1, d):
            s = s + a[:, j]
        return s[:, None]
    head, tail = b[1], d - b[-2]
    sums = []
    for lo, hi in ((0, head), (d - tail, d)):
        s = a[:, lo]
        for j in range(lo + 1, hi):
            s = s + a[:, j]
        sums.append(s[:, None])
    # the full middle windows side by side: 32 steps for all of them
    mid = a[:, head:d - tail].reshape(a.shape[0], -1, 32)
    mid_sum = mid[:, :, 0]
    for j in range(1, 32):
        mid_sum = mid_sum + mid[:, :, j]
    return torch.cat([sums[0], mid_sum, sums[1]], dim=1)


def xla_row_sum(a: torch.Tensor) -> torch.Tensor:
    """(R, D) float32 -> (R,) row sums in the order the reference's
    compiled ``jnp.sum``/``jnp.mean`` over the last axis takes on the CPU:
    XLA's CPU backend sums windows of 32 (:func:`_xla_chunk_bounds`) and
    then the window sums the same way, level by level, until one is left.
    Found by probing the reduction tree, then held bit for bit over 10^5
    random rows at D in {100, 384, 768}, and over 4 000 (500 above 4 096)
    at D in {17, 1024, 1025, 1100, 1536, 2000, 2304, 3072, 4096, 4100,
    5000, 9999, 33000, 40000}."""
    while a.shape[1] > 1:
        a = _xla_window_sums(a)
    return a[:, 0]


def majority_words(mean: torch.Tensor) -> torch.Tensor:
    """Re-encode (L, D) mean level vectors as bq2 words, with the threshold
    tau the reference's encode gives them: its row sum in XLA's order, times
    the float32 reciprocal of D (``jnp.mean``).  A list's mean is made of
    multiples of 1/count, so |x| = tau exactly is common here, and a tau one
    ulp off flips strong bits (ROADMAP queue 3)."""
    d = mean.shape[1]
    absx = mean.abs()
    tau = xla_row_sum(absx) * float(np.float32(1) / np.float32(d))
    return torch.cat([bq.pack_bits(mean > 0),
                      bq.pack_bits(absx > tau[:, None])], dim=1)


def _layout_to_list_ids(member_ids, offsets, cap) -> np.ndarray:
    """Contiguous layout -> (L, cap) padded gather view."""
    n_lists = offsets.shape[0] - 1
    out = np.full((n_lists, cap), -1, dtype=np.int32)
    counts = np.diff(offsets)
    rank = np.arange(member_ids.shape[0]) - np.repeat(offsets[:-1], counts)
    rows = np.repeat(np.arange(n_lists), counts)
    out[rows, rank] = member_ids
    return out


def build_partition(
    sigs: bq.Signature,
    *,
    n_lists: int | None = None,
    seed: int = 0,
    sample: int = 256,
    refine: int = 3,
    balance: float | None = 1.5,
) -> IVFPartition:
    """Partition ``sigs`` into L inverted lists (see the module docstring).

    ``sample`` bounds how many list members feed each majority signature;
    ``refine`` is the number of majority-vote rounds; ``balance`` caps every
    list at ``ceil(balance * N / L)`` members in the final assignment
    (None disables): nodes claim their nearest list in order of confidence
    (the similarity margin between their first and second choice) and spill
    to their next choice once a list is full.  Runs on the signatures'
    device; deterministic under ``seed``.
    """
    n = sigs.words.shape[0]
    dev = sigs.words.device
    n_lists = n_lists or default_n_lists(n)
    n_lists = max(2, min(n_lists, n))
    backend = make_backend("bq2", MetricArrays(sigs=sigs))
    scan = dispatch.list_scan_ops(sigs.dim, dev).scan

    def rows(ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(ids).to(dev).long()

    def assign_to(words, cent_words) -> np.ndarray:
        # torch.argmax returns the first maximum, as jnp.argmax does
        return torch.cat([
            scan(words[s:s + _ASSIGN_CHUNK], cent_words).argmax(dim=-1)
            for s in range(0, words.shape[0], _ASSIGN_CHUNK)
        ]).cpu().numpy().astype(np.int32)

    def assign_capped(words, cent_words, frac: float) -> np.ndarray:
        """Greedy capacity-bounded assignment (see ``balance``)."""
        m = words.shape[0]
        k = min(_BALANCE_PREFS, n_lists)
        pref = np.empty((m, k), dtype=np.int32)
        psim = np.empty((m, k), dtype=np.float32)
        for s in range(0, m, _ASSIGN_CHUNK):
            block = words[s:s + _ASSIGN_CHUNK]
            # host-side top-k over the small (rows, L) block, with the
            # reference's numpy calls so that ties break the same way
            sim = scan(block, cent_words).cpu().numpy()
            part_k = np.argpartition(-sim, k - 1, axis=-1)[:, :k]
            vals = np.take_along_axis(sim, part_k, axis=-1)
            order_k = np.argsort(-vals, axis=-1, kind="stable")
            pref[s:s + block.shape[0]] = np.take_along_axis(
                part_k, order_k, axis=-1
            )
            psim[s:s + block.shape[0]] = np.take_along_axis(
                vals, order_k, axis=-1
            )
        margin = psim[:, 0] - (psim[:, 1] if k > 1 else 0.0)
        order = np.argsort(-margin, kind="stable")
        cap_limit = max(8, -(-int(m * frac) // n_lists))
        counts = np.zeros((n_lists,), dtype=np.int64)
        out = np.empty((m,), dtype=np.int32)
        for i in order:
            for li in pref[i]:
                if counts[li] < cap_limit:
                    out[i] = li
                    counts[li] += 1
                    break
            else:
                # all k preferred lists full: take the emptiest
                li = int(np.argmin(counts))
                out[i] = li
                counts[li] += 1
        return out

    def layout(assign):
        member_ids = np.argsort(assign, kind="stable").astype(np.int32)
        counts = np.bincount(assign, minlength=n_lists)
        offsets = np.zeros((n_lists + 1,), dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        cap = max(8, int(-(-int(counts.max()) // 8) * 8))
        return member_ids, counts, offsets, cap

    # 1. density-following seeds: one uniform draw per random shard
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n).astype(np.int32)
    per = -(-n // n_lists)                         # ceil division
    padded = (np.concatenate([perm, perm[:per * n_lists - n]])
              if per * n_lists - n else perm)
    seed_ids = padded.reshape(n_lists, per)[:, 0].copy()

    # 2. majority-vote refinement on a subsample: every non-empty list's
    # centroid becomes the re-encoded mean of its sampled members' levels
    cent_words = sigs.words[rows(seed_ids)]
    r_n = min(n, max(_REFINE_PER_LIST * n_lists, 2048))
    sub_words = sigs.words[rows(np.sort(perm[:r_n]))]
    for _ in range(max(refine, 0)):
        assign_s = assign_to(sub_words, cent_words)
        member_s, counts_s, offsets_s, cap_s = layout(assign_s)
        grid = torch.from_numpy(_layout_to_list_ids(
            member_s, offsets_s, cap_s
        )[:, : min(cap_s, max(8, sample))]).to(dev)
        levels = bq.decode_levels(bq.Signature(
            sub_words[grid.clamp_min(0).long()], sigs.dim))   # (L, S', D)
        ok = (grid >= 0)[..., None]
        # level sums are exact; the mean is a true division by the count
        mean = (torch.where(ok, levels, 0.0).sum(dim=1)
                / ok.sum(dim=1).clamp_min(1))
        majority = majority_words(mean)
        # empty lists keep their previous signature (stay recoverable)
        keep = torch.from_numpy(counts_s > 0).to(dev)[:, None]
        cent_words = torch.where(keep, majority, cent_words)

    # 3. the single full assignment scan + contiguous layout
    if balance is not None:
        assign = assign_capped(sigs.words, cent_words, balance)
    else:
        assign = assign_to(sigs.words, cent_words)
    member_ids, counts, offsets, cap = layout(assign)
    list_ids = torch.from_numpy(
        _layout_to_list_ids(member_ids, offsets, cap)).to(dev)

    # 4. snap each list to its nearest real member; routing keeps the
    # majority signatures
    medoids = linking.shard_medoids(backend, cent_words, list_ids)
    cent_ids = np.where(counts > 0, medoids.cpu().numpy(),
                        seed_ids).astype(np.int32)

    return IVFPartition(
        cent_words=cent_words,
        list_ids=list_ids,
        cent_ids=cent_ids,
        assign=assign,
        offsets=offsets,
        member_ids=member_ids,
        dim=sigs.dim,
        seed=seed,
    )
