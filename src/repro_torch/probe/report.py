"""CompatibilityReport — the applicability boundary as a runtime object.

Counterpart of ``repro/probe/report.py`` (numpy only; the port keeps its
own copy, since it imports nothing of the reference package).

The paper's central contribution is the *boundary* (Table 7 / §6):
BQ-native topology is safe on cosine-native contrastive embeddings,
marginal on cosine-native non-contrastive data, and unusable on
Euclidean-native or structureless distributions.  This module turns
that post-hoc observation into a falsifiable, training-free verdict
computed from a corpus sample (``repro_torch.probe.diagnostics``):

* ``sign_entropy``   — mean per-dimension entropy of the sign plane.
  Euclidean-native CV features (SIFT/GIST) are non-negative, so after
  L2-norm every sign bit is constant: entropy ~0 and the paper's
  Finding 1 collapse is detectable *before* building anything.
* ``cos_std``        — spread of pairwise cosine similarity in the
  sample.  Structureless data concentrates at 1/sqrt(D) (concentration
  of measure): there is no neighborhood structure for any quantizer to
  preserve.
* ``bq_agreement``   — mean top-k overlap between exact float32 cosine
  and symmetric 2-bit SM ranking inside the sample: the directly
  falsifiable criterion (if BQ cannot rank a 1k sample, it cannot rank
  the corpus).
* ``strong_entropy`` / ``inter_bit_corr`` / ``cos_mean`` — secondary
  diagnostics reported for inspection (redundant bit planes, hubness).

Calibrated thresholds (measured on the paper-tier surrogate corpora,
see DESIGN.md §10) map the statistics to a green/amber/red verdict;
``repro_torch.probe.policy`` maps the verdict to a navigation policy.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

VERDICTS = ("green", "amber", "red")


@dataclasses.dataclass(frozen=True)
class Thresholds:
    """Verdict calibration (DESIGN.md §10 records the measurements).

    Measured at sample=1024 on the Table-7 surrogate tiers: contrastive
    surrogates score agreement ~0.74-0.78, GloVe-like ~0.66, random
    sphere ~0.42; sign entropy is ~1.0 everywhere except the
    non-negative CV tiers (0.0); cos_std is >= 0.08 on every usable
    tier and <= 0.04 on the structureless/CV tiers.
    """

    sign_entropy_red: float = 0.20   # sign plane ~constant -> collapse
    cos_std_red: float = 0.05        # concentration of measure -> no structure
    agreement_red: float = 0.45      # BQ cannot rank even a small sample
    agreement_green: float = 0.70    # BQ ranking ~matches float32
    # coarse cluster structure: raw gap between the mean top-m neighbor
    # cosine and the overall mean pairwise cosine in the sample.
    # Clustered green tiers measure 0.21-0.52; structureless data
    # (random sphere 0.09, sift-like 0.08) has no gap for an IVF
    # partition to exploit.  Gates the green -> ivf auto-selection.
    cluster_strong: float = 0.15

DEFAULT_THRESHOLDS = Thresholds()

_FLOAT_FIELDS = (
    "cos_mean", "cos_std", "sign_entropy", "strong_entropy",
    "inter_bit_corr", "bq_agreement", "margin_p30",
    "cluster_concentration",
)
_INT_FIELDS = ("n_sampled", "n_queries", "k", "dim", "seed")


@dataclasses.dataclass(frozen=True)
class CompatibilityReport:
    """Training-free compatibility diagnostics for one corpus (slice).

    ``bq_agreement`` is NaN for signature-only probes (no cold float32
    vectors to rank against); the verdict then degrades to the bit-plane
    statistics alone and never reaches green (no falsifiable evidence).
    """

    n_sampled: int            # base sample rows the stats were computed on
    n_queries: int            # held-out query rows for the agreement probe
    k: int                    # top-k depth of the agreement probe
    dim: int
    seed: int
    cos_mean: float           # mean pairwise cosine in the sample
    cos_std: float            # spread of pairwise cosine (structure signal)
    sign_entropy: float       # mean per-dim entropy of the sign plane, bits
    strong_entropy: float     # mean per-dim entropy of the magnitude plane
    inter_bit_corr: float     # mean |corr| between sign bits (redundancy)
    bq_agreement: float       # BQ-vs-float32 top-k overlap; NaN if unknown
    # 30th percentile of the sample's normalized k-th-neighbor BQ score
    # margin (see repro_torch.core.beam.beam_margin): the corpus-calibrated
    # escalation threshold of the adaptive-rerank schedule.
    margin_p30: float = float("nan")
    # mean top-m-neighbor cosine minus the overall mean pairwise cosine
    # in the sample: how much nearer a row's coarse neighborhood is than
    # the bulk.  NaN for signature-only probes (needs cosine geometry).
    # >= thresholds.cluster_strong means the corpus has list-level
    # structure an IVF partition can exploit.
    cluster_concentration: float = float("nan")
    thresholds: Thresholds = DEFAULT_THRESHOLDS

    @property
    def verdict(self) -> str:
        """``green`` (BQ-native safe) / ``amber`` (escalate) / ``red``."""
        t = self.thresholds
        if self.sign_entropy < t.sign_entropy_red:
            return "red"
        if self.cos_std < t.cos_std_red:
            return "red"
        if math.isnan(self.bq_agreement):
            # signature-only probe: no falsifiable ranking evidence, so
            # the best available verdict is amber
            return "amber"
        if self.bq_agreement < t.agreement_red:
            return "red"
        if self.bq_agreement >= t.agreement_green:
            return "green"
        return "amber"

    def summary(self) -> str:
        return (
            f"{self.verdict}: agreement@{self.k}={self.bq_agreement:.3f} "
            f"sign_entropy={self.sign_entropy:.3f} "
            f"cos_std={self.cos_std:.3f} "
            f"(sample={self.n_sampled}, dim={self.dim})"
        )

    # -- persistence (merged into index npz archives) ----------------------

    def to_npz_fields(self, prefix: str = "probe_") -> dict:
        out = {
            prefix + name: np.float64(getattr(self, name))
            for name in _FLOAT_FIELDS
        }
        out.update({
            prefix + name: np.int64(getattr(self, name))
            for name in _INT_FIELDS
        })
        out[prefix + "thresholds"] = np.asarray(
            [getattr(self.thresholds, f.name)
             for f in dataclasses.fields(Thresholds)],
            dtype=np.float64,
        )
        return out

    @classmethod
    def from_npz(cls, z, prefix: str = "probe_"):
        """Rebuild from an index archive; None when it carries no probe."""
        if prefix + "cos_mean" not in z:
            return None
        # archives written before a statistic existed simply omit it:
        # missing floats load as NaN (the "unknown" value every verdict
        # rule already handles), missing thresholds keep their defaults
        kw = {
            name: float(z[prefix + name][()])
            for name in _FLOAT_FIELDS if prefix + name in z
        }
        kw.update(
            {name: int(z[prefix + name][()]) for name in _INT_FIELDS}
        )
        th = z[prefix + "thresholds"]
        names = [f.name for f in dataclasses.fields(Thresholds)]
        kw["thresholds"] = Thresholds(
            **{n: float(v) for n, v in zip(names, th)}
        )
        return cls(**kw)


def merge_reports(reports) -> CompatibilityReport:
    """Fleet-wide report: sample-count-weighted merge of shard reports.

    Means (cosine moments, entropies, correlation, agreement) are
    weighted by each shard's sample size; ``cos_std`` merges through the
    second moment.  NaN agreements (signature-only shards) are excluded
    from the agreement merge — if every shard is NaN, so is the fleet.
    The merged verdict is therefore the verdict of the pooled sample,
    which is what the fan-out search actually serves.
    """
    reports = list(reports)
    if not reports:
        raise ValueError("nothing to merge")
    if len({r.dim for r in reports}) != 1:
        raise ValueError(f"dim mismatch: {[r.dim for r in reports]}")
    if len({r.k for r in reports}) != 1:
        raise ValueError(f"k mismatch: {[r.k for r in reports]}")
    w = np.asarray([r.n_sampled for r in reports], dtype=np.float64)
    if w.sum() <= 0:
        raise ValueError("merge needs at least one non-empty report")
    w = w / w.sum()

    def wmean(name):
        return float(sum(wi * getattr(r, name) for wi, r in zip(w, reports)))

    def nan_wmean(name):
        # weighted mean over the shards that measured the statistic;
        # NaN when none did (signature-only fleets)
        pairs = [
            (wi, getattr(r, name)) for wi, r in zip(w, reports)
            if not math.isnan(getattr(r, name))
        ]
        if not pairs:
            return float("nan")
        tot = sum(wi for wi, _ in pairs)
        return float(sum(wi * v for wi, v in pairs) / max(tot, 1e-12))

    # pooled variance: E[x^2] - E[x]^2 over the weighted mixture
    cos_mean = wmean("cos_mean")
    second = sum(
        wi * (r.cos_std ** 2 + r.cos_mean ** 2)
        for wi, r in zip(w, reports)
    )
    cos_std = float(np.sqrt(max(second - cos_mean ** 2, 0.0)))

    return CompatibilityReport(
        n_sampled=int(sum(r.n_sampled for r in reports)),
        n_queries=int(sum(r.n_queries for r in reports)),
        k=reports[0].k,
        dim=reports[0].dim,
        seed=reports[0].seed,
        cos_mean=cos_mean,
        cos_std=cos_std,
        sign_entropy=wmean("sign_entropy"),
        strong_entropy=wmean("strong_entropy"),
        inter_bit_corr=wmean("inter_bit_corr"),
        bq_agreement=nan_wmean("bq_agreement"),
        # weighted mean approximates the pooled percentile; exact
        # pooling would need the per-shard margin samples themselves
        margin_p30=nan_wmean("margin_p30"),
        cluster_concentration=nan_wmean("cluster_concentration"),
        thresholds=reports[0].thresholds,
    )
