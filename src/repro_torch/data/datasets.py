"""Evaluation dataset generators (paper Table 4, offline-container edition).

The container has no network access, so the paper's two *synthetic*
datasets are generated exactly per its recipes, and the real-embedding
tiers are emulated by distribution surrogates with the structural
properties the paper identifies as causal (§5.4, §6):

* ``random_sphere``        — uniform unit vectors, seed 42 (paper's
  structureless lower bound; predicted recall ~0).
* ``synthetic_lr``         — 256 Zipf-weighted clusters in a 64-d
  subspace -> 768-d via random orthogonal basis, eps=0.05 full-rank
  noise, L2-norm (paper's causal probe; predicted recall ~50%).
* ``contrastive_surrogate``— hierarchical anisotropic clusters on the
  sphere with low effective dimensionality: a stand-in for the
  MiniLM/Cohere/DBpedia tier (predicted recall >91% at matching dims).
* ``clip_surrogate``       — two contrastive sub-distributions (image/
  text "modalities") sharing a space with a modality-gap offset: the
  RedCaps tier (predicted recall between GloVe and MiniLM tiers).
* ``euclidean_cv_surrogate``— non-negative, concentrated-positive
  features (SIFT/GIST-like); after L2-norm the sign bits carry ~no
  information -> predicted collapse (<6%).
* ``glove_like``           — cosine-native but non-contrastive: moderate
  rank, heavy-tailed cluster sizes (predicted ~50%).

This is the port's own copy of ``repro/data/datasets.py`` (numpy only,
same generators and seeds, so both packages see the same corpora).
"""

from __future__ import annotations

import numpy as np


def _l2norm(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def random_sphere(n: int = 10_000, d: int = 768, seed: int = 42) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return _l2norm(rng.standard_normal((n, d)).astype(np.float32))


def synthetic_lr(
    n: int = 10_000,
    d: int = 768,
    intrinsic: int = 64,
    clusters: int = 256,
    eps: float = 0.05,
    zipf_a: float = 1.2,
    seed: int = 0,
) -> np.ndarray:
    """Paper §5.1 Synthetic-LR: low-rank Zipf clusters + eps noise."""
    rng = np.random.default_rng(seed)
    # Zipf cluster weights
    w = 1.0 / np.arange(1, clusters + 1) ** zipf_a
    w /= w.sum()
    assign = rng.choice(clusters, size=n, p=w)
    centers = rng.standard_normal((clusters, intrinsic)).astype(np.float32)
    centers = _l2norm(centers)
    within = 0.35 * rng.standard_normal((n, intrinsic)).astype(np.float32)
    low_rank = centers[assign] + within
    # random orthogonal basis into ambient dims
    basis, _ = np.linalg.qr(rng.standard_normal((d, intrinsic)))
    x = low_rank @ basis.T.astype(np.float32)
    x += eps * rng.standard_normal((n, d)).astype(np.float32)
    return _l2norm(x.astype(np.float32))


def contrastive_surrogate(
    n: int = 10_000,
    d: int = 384,
    n_topics: int = 64,
    subclusters: int = 16,
    intrinsic: int | None = None,
    seed: int = 1,
) -> np.ndarray:
    """Single-modality contrastive-embedding surrogate (MiniLM tier).

    Hierarchical semantic clustering + low effective dimensionality +
    anisotropic within-cluster spread — the three properties §5.4 names.
    """
    rng = np.random.default_rng(seed)
    intrinsic = intrinsic or max(48, d // 8)
    topics = _l2norm(rng.standard_normal((n_topics, intrinsic)))
    sub = topics[:, None, :] + 0.45 * rng.standard_normal(
        (n_topics, subclusters, intrinsic)
    )
    sub = _l2norm(sub.reshape(-1, intrinsic))
    assign = rng.integers(0, sub.shape[0], size=n)
    # anisotropic within-cluster noise (decaying spectrum)
    spectrum = 1.0 / np.sqrt(1.0 + np.arange(intrinsic))
    within = rng.standard_normal((n, intrinsic)) * spectrum * 0.35
    low = sub[assign] + within
    basis, _ = np.linalg.qr(rng.standard_normal((d, intrinsic)))
    x = low @ basis.T
    x += 0.02 * rng.standard_normal((n, d))
    return _l2norm(x.astype(np.float32))


def clip_surrogate(
    n: int = 10_000, d: int = 512, seed: int = 2
) -> np.ndarray:
    """Multimodal (RedCaps/CLIP) surrogate: two modalities, shared space,
    modality-gap offset + per-modality covariance mismatch."""
    rng = np.random.default_rng(seed)
    half = n // 2
    base_img = contrastive_surrogate(half, d, seed=seed + 10)
    base_txt = contrastive_surrogate(n - half, d, seed=seed + 11)
    gap = _l2norm(rng.standard_normal((1, d)).astype(np.float32))
    # CLIP's measured modality gap is moderate (|mu_img - mu_txt| ~ 0.8
    # of unit norm pre-normalization); 0.3 reproduces the paper's
    # "high but sub-SOTA" RedCaps tier rather than a bimodal collapse.
    img = _l2norm(base_img + 0.3 * gap)
    txt = _l2norm(base_txt - 0.3 * gap)
    x = np.concatenate([img, txt], axis=0)
    perm = rng.permutation(n)
    return x[perm].astype(np.float32)


def glove_like(n: int = 10_000, d: int = 100, seed: int = 3) -> np.ndarray:
    """Cosine-native, non-contrastive word-vector surrogate (GloVe tier)."""
    rng = np.random.default_rng(seed)
    intrinsic = d // 2
    clusters = 512
    w = 1.0 / np.arange(1, clusters + 1) ** 1.05   # heavy-tailed sizes
    w /= w.sum()
    assign = rng.choice(clusters, size=n, p=w)
    centers = rng.standard_normal((clusters, intrinsic))
    low = centers[assign] + 0.9 * rng.standard_normal((n, intrinsic))
    basis, _ = np.linalg.qr(rng.standard_normal((d, intrinsic)))
    x = low @ basis.T + 0.15 * rng.standard_normal((n, d))
    return _l2norm(x.astype(np.float32))


def euclidean_cv_surrogate(
    n: int = 10_000, d: int = 128, seed: int = 4
) -> np.ndarray:
    """SIFT/GIST-like: non-negative concentrated histograms; after
    L2-norm the sign plane is constant -> BQ collapse (paper Finding 1)."""
    rng = np.random.default_rng(seed)
    clusters = 128
    assign = rng.integers(0, clusters, size=n)
    centers = np.abs(rng.standard_normal((clusters, d))) + 0.5
    x = centers[assign] + 0.3 * np.abs(rng.standard_normal((n, d)))
    return _l2norm(x.astype(np.float32))


DATASET_REGISTRY = {
    # name: (factory, default_dim, paper tier)
    "random-sphere": (random_sphere, 768, "collapse"),
    "synthetic-lr": (synthetic_lr, 768, "usable"),
    "minilm-surrogate": (
        lambda n, d=384, seed=1: contrastive_surrogate(n, d, seed=seed),
        384, "sota",
    ),
    "cohere-surrogate": (
        lambda n, d=768, seed=5: contrastive_surrogate(n, d, seed=seed),
        768, "sota",
    ),
    "dbpedia-surrogate": (
        lambda n, d=1536, seed=6: contrastive_surrogate(n, d, seed=seed),
        1536, "sota",
    ),
    "redcaps-surrogate": (clip_surrogate, 512, "high"),
    "glove-like": (glove_like, 100, "usable"),
    "sift-like": (euclidean_cv_surrogate, 128, "collapse"),
    "gist-like": (
        lambda n, d=960, seed=8: euclidean_cv_surrogate(n, d, seed=seed),
        960, "collapse",
    ),
}


def make_dataset(name: str, n: int, queries: int = 100, seed: int = 1234):
    """Returns (base (n, d), queries (q, d)) float32, unit-norm."""
    factory, d, _tier = DATASET_REGISTRY[name]
    base = factory(n + queries)
    rng = np.random.default_rng(seed)
    qidx = rng.choice(len(base), size=queries, replace=False)
    mask = np.ones(len(base), dtype=bool)
    mask[qidx] = False
    q = base[qidx] + 0.02 * rng.standard_normal(
        (queries, base.shape[1])
    ).astype(np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return base[mask][:n], q
