"""Sample-based, training-free probe statistics, in torch.

Counterpart of ``repro/probe/diagnostics.py``.  Everything here is computed
from a corpus slice — no training, no codebooks, no labels.  The host draws
the deterministic sample (``np.random.default_rng(seed)``, the reference's
calls) and boxes the scalars into a
:class:`~repro_torch.probe.report.CompatibilityReport`; the numeric cores
run on the sample's device.

Two entry points:

* :func:`probe_corpus`     — float32 vectors available (build time, the
  common case): full report including the falsifiable BQ-vs-float32
  top-k agreement.  Its dense bq2 ranking is the list-scan primitive
  (``kernels.dispatch.list_scan_ops``): on the card, the ``list_scan``
  kernel.
* :func:`probe_signatures` — packed signatures only (vector-free
  indexes): bit-plane statistics, agreement = NaN, verdict capped at
  amber.

Ties and rounding follow the reference where a decision depends on them:
``lax.top_k`` gives a tie to the lower index (stable sorts here); XLA
compiles a division by a constant into a multiply by its float32
reciprocal (copied); and ``jnp.percentile``'s linear interpolation, which
XLA on the CPU contracts into a fused multiply-add, is repeated on the host
(:func:`percentile_linear`), so the margin threshold of an amber policy is
the reference's to the bit.  The other float statistics sum in torch's
order and agree to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bq
from repro_torch.core.metric import normalize
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.probe.report import (
    DEFAULT_THRESHOLDS,
    CompatibilityReport,
    Thresholds,
)

DEFAULT_SAMPLE = 1024
DEFAULT_QUERIES = 64
DEFAULT_K = 10
# neighborhood width of the cluster-concentration statistic: the mean
# similarity of each sample row's top-m neighbors stands in for the
# row's coarse (IVF-list-level) cluster
DEFAULT_CLUSTER_M = 16


def _recip(n) -> float:
    """The float32 reciprocal XLA multiplies by where JAX divides by ``n``."""
    return float(np.float32(1) / np.float32(n))


def binary_entropy(p: np.ndarray) -> np.ndarray:
    """Elementwise entropy of a Bernoulli(p) bit, in bits (host side)."""
    p = np.clip(np.asarray(p, dtype=np.float64), 1e-12, 1.0 - 1e-12)
    return -(p * np.log2(p) + (1.0 - p) * np.log2(1.0 - p))


def entropy_from_counts(counts: np.ndarray, n: int) -> float:
    """Mean per-dimension bit entropy from set-bit ``counts`` over ``n``
    rows — the one formula both the sampled probe and the incremental
    accumulator use."""
    if n <= 0:
        return 0.0
    return float(binary_entropy(counts / n).mean())


def percentile_linear(values: np.ndarray, pct: float) -> float:
    """``jnp.percentile(values, pct)`` of a float32 vector, bit for bit.

    Linear interpolation between the two order statistics around
    ``q = pct/100 * (n - 1)``, all in float32, with the low term fused into
    the sum as XLA fuses it (``fma(low, 1 - w, float32(high * w))``; the
    float64 product of two float32 numbers is exact)."""
    f32 = np.float32
    a = np.sort(np.asarray(values, dtype=f32))
    q = f32(f32(pct) / f32(100)) * f32(len(a) - 1)
    lo, hi = int(np.floor(q)), int(np.ceil(q))
    w_hi = f32(q - f32(lo))
    w_lo = f32(f32(1) - w_hi)
    high = np.float64(f32(a[hi] * w_hi))
    return float(f32(np.float64(a[lo]) * np.float64(w_lo) + high))


# ---------------------------------------------------------------------------
# numeric cores (on the sample's device)
# ---------------------------------------------------------------------------


def _cosine_moments(sample: torch.Tensor) -> tuple[float, float]:
    """Mean/std of off-diagonal pairwise cosine in a unit-vector sample."""
    sims = sample @ sample.T
    s = sample.shape[0]
    off = ~torch.eye(s, dtype=torch.bool, device=sample.device)
    inv = _recip(s * (s - 1))
    mean = torch.where(off, sims, 0.0).sum() * inv
    var = torch.where(off, (sims - mean) ** 2, 0.0).sum() * inv
    return float(mean), float(torch.sqrt(var))


def _plane_counts(bits: torch.Tensor) -> np.ndarray:
    """(S, D) bool bit plane -> (D,) set-bit counts."""
    return bits.sum(dim=0, dtype=torch.int64).cpu().numpy()


def _sign_corr(bits: torch.Tensor) -> float:
    """Mean |Pearson corr| between sign bits across dimension pairs.

    Zero-variance dimensions (constant bits) are excluded from the mean —
    they carry no information, which the entropy statistic already
    reports.
    """
    x = bits.to(torch.float32)
    s, d = x.shape
    xc = x - x.sum(dim=0) * _recip(s)
    std = torch.sqrt((xc * xc).sum(dim=0) * _recip(s))
    ok = std > 1e-6
    z = (xc / torch.where(ok, std, 1.0)) * ok
    corr = (z.T @ z) * _recip(s)
    eye = torch.eye(d, dtype=torch.bool, device=x.device)
    pair = ok[:, None] & ok[None, :] & ~eye
    total = pair.sum().clamp_min(1)
    return float(torch.where(pair, corr.abs(), 0.0).sum() / total)


def _neighbor_mean(sample: torch.Tensor, m: int) -> float:
    """Mean cosine of each row's top-``m`` neighbors in a unit sample.

    The raw gap between this and the overall mean pairwise cosine is the
    cluster-concentration statistic (see the reference module).
    """
    sims = sample @ sample.T
    eye = torch.eye(sample.shape[0], dtype=torch.bool, device=sample.device)
    sims = torch.where(eye, -torch.inf, sims)
    top = torch.sort(sims, dim=1, descending=True).values[:, :m]
    return float(top.mean())


def _topk_agreement(q_vecs, base_vecs, q_words, base_words, *, k: int,
                    dim: int) -> tuple[float, float]:
    """Top-k overlap of exact-cosine vs symmetric-BQ ranking, plus the 30th
    percentile of the per-query normalized k-th-neighbor margin.

    Queries and base rows are disjoint slices of the sample, so there is no
    self-match to exclude; ties inside either ranking go to the lower
    index on both sides, as ``lax.top_k`` gives them.  The bq2 ranking is
    the (Q, N) Table-1 similarity of the list-scan primitive; the margin
    ``sim_k / 4D`` is ``beam_margin``'s ``(neutral - d_k) / neutral`` on
    the calibrated scale ``d = 4D - sim``.
    """
    exact = torch.sort(q_vecs @ base_vecs.T, dim=1, descending=True,
                       stable=True).indices[:, :k]
    scan = dispatch.list_scan_ops(dim, q_words.device).scan
    sim = scan(q_words, base_words)
    top_sim, quant = torch.sort(sim, dim=1, descending=True, stable=True)
    top_sim, quant = top_sim[:, :k], quant[:, :k]
    hits = (exact[:, :, None] == quant[:, None, :]).any(dim=-1)
    agreement = float(np.float32(int(hits.sum()))
                      * np.float32(_recip(hits.numel())))
    margin = top_sim[:, -1].to(torch.float32) * _recip(4 * dim)
    return agreement, percentile_linear(margin.cpu().numpy(), 30.0)


# ---------------------------------------------------------------------------
# host side: sampling and the report
# ---------------------------------------------------------------------------


def _sample_rows(n: int, take: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if take >= n:
        return np.arange(n, dtype=np.int64)
    return rng.choice(n, size=take, replace=False)


def probe_corpus(
    vectors,
    *,
    sample: int = DEFAULT_SAMPLE,
    queries: int = DEFAULT_QUERIES,
    k: int = DEFAULT_K,
    seed: int = 0,
    thresholds: Thresholds = DEFAULT_THRESHOLDS,
    device=None,
) -> CompatibilityReport:
    """Probe a float32 corpus (or slice): the full boundary report.

    ``sample`` rows are drawn without replacement (deterministic in
    ``seed``); the first ``queries`` of them are held out as agreement
    queries against the remaining rows.  Cost is O(sample^2 * D).
    ``vectors`` is an (N, D) tensor or array; the statistics are computed
    on ``device`` (default: the CUDA card).
    """
    device = resolve_device(device)
    if isinstance(vectors, torch.Tensor):
        vectors = vectors.to(device=device, dtype=torch.float32)
    else:
        vectors = torch.as_tensor(np.asarray(vectors, dtype=np.float32),
                                  device=device)
    if vectors.ndim != 2:
        raise ValueError(f"expected (N, D) vectors, got "
                         f"{tuple(vectors.shape)}")
    n, dim = vectors.shape
    take = min(sample, n)
    nq = max(1, min(queries, take // 4))
    if take - nq < k:
        raise ValueError(
            f"sample of {take} rows is too small to probe top-{k} "
            f"agreement with {nq} queries"
        )
    rows = torch.from_numpy(_sample_rows(n, take, seed)).to(device)
    sample_v = normalize(vectors[rows])
    sigs = bq.encode(sample_v)

    cos_mean, cos_std = _cosine_moments(sample_v)
    pos_bits = bq.unpack_bits(sigs.pos, dim)
    strong_bits = bq.unpack_bits(sigs.strong, dim)
    agreement, margin_p30 = _topk_agreement(
        sample_v[:nq], sample_v[nq:],
        sigs.words[:nq], sigs.words[nq:],
        k=k, dim=dim,
    )
    m = max(1, min(DEFAULT_CLUSTER_M, take - 1))
    # float64 difference of two float32 scalars, as the reference's
    # float(...) - float(...)
    cluster = _neighbor_mean(sample_v, m) - cos_mean
    return CompatibilityReport(
        n_sampled=int(take),
        n_queries=int(nq),
        k=int(k),
        dim=int(dim),
        seed=int(seed),
        cos_mean=cos_mean,
        cos_std=cos_std,
        sign_entropy=entropy_from_counts(_plane_counts(pos_bits), take),
        strong_entropy=entropy_from_counts(_plane_counts(strong_bits), take),
        inter_bit_corr=_sign_corr(pos_bits),
        bq_agreement=agreement,
        margin_p30=margin_p30,
        cluster_concentration=cluster,
        thresholds=thresholds,
    )


def probe_signatures(
    words,
    dim: int,
    *,
    sample: int = DEFAULT_SAMPLE,
    k: int = DEFAULT_K,
    seed: int = 0,
    thresholds: Thresholds = DEFAULT_THRESHOLDS,
    device=None,
) -> CompatibilityReport:
    """Probe packed signatures alone (vector-free indexes).

    ``words`` is the ``(N, 2W)`` table: int32 bit views (a tensor) or the
    reference's uint32 words (an array).  Without float32 ground truth
    there is no agreement probe and no cosine spread; the report carries
    the bit-plane statistics, NaN for the rest, and its verdict never
    reaches green.  ``cos_std`` is set at the red threshold so the verdict
    is decided by the sign entropy.
    """
    device = resolve_device(device)
    if not isinstance(words, torch.Tensor):
        arr = np.ascontiguousarray(words)
        words = torch.from_numpy(
            arr.view(np.int32) if arr.dtype == np.uint32 else arr)
    words = words.to(device)
    n = words.shape[0]
    take = min(sample, n)
    if take == 0:
        raise ValueError("cannot probe an empty signature set")
    rows = torch.from_numpy(_sample_rows(n, take, seed)).to(device)
    sigs = bq.Signature(words=words[rows], dim=dim)
    pos_bits = bq.unpack_bits(sigs.pos, dim)
    strong_bits = bq.unpack_bits(sigs.strong, dim)
    return CompatibilityReport(
        n_sampled=int(take),
        n_queries=0,
        k=int(k),
        dim=int(dim),
        seed=int(seed),
        cos_mean=float("nan"),
        cos_std=thresholds.cos_std_red,   # unknown: leave to sign entropy
        sign_entropy=entropy_from_counts(_plane_counts(pos_bits), take),
        strong_entropy=entropy_from_counts(_plane_counts(strong_bits), take),
        inter_bit_corr=_sign_corr(pos_bits),
        bq_agreement=float("nan"),
        thresholds=thresholds,
    )


def report_from_accumulator(
    acc,
    *,
    k: int = DEFAULT_K,
    thresholds: Thresholds = DEFAULT_THRESHOLDS,
) -> CompatibilityReport:
    """Re-probe a live :class:`~repro_torch.probe.incremental.ProbeAccumulator`.

    The accumulator already holds exact bit-plane counts for the live row
    set, so this costs two entropy evaluations — no sampling, no device
    work.  Like :func:`probe_signatures` the verdict is capped at amber.
    """
    n = int(acc.n)
    if n <= 0:
        raise ValueError("cannot re-probe an empty accumulator")
    return CompatibilityReport(
        n_sampled=n,
        n_queries=0,
        k=int(k),
        dim=int(acc.dim),
        seed=0,
        cos_mean=float("nan"),
        cos_std=thresholds.cos_std_red,   # unknown: leave to sign entropy
        sign_entropy=float(acc.sign_entropy),
        strong_entropy=float(acc.strong_entropy),
        inter_bit_corr=float("nan"),
        bq_agreement=float("nan"),
        thresholds=thresholds,
    )
