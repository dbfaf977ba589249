"""Seeded synthetic benchmark data: a copy of ``synthetic_clustered``,
``synthetic_heavy_tailed`` and ``Dataset`` from
``hnsw_rs_tpu/utils/datasets.py``. The same seed draws
the same numpy stream, so both packages see bit-identical vectors. The
ann-benchmarks HDF5 loader is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Dataset:
    """ann-benchmarks-shaped evaluation bundle."""

    name: str
    train: np.ndarray  # float32 [N, d]
    test: np.ndarray  # float32 [Q, d]
    neighbors: np.ndarray | None  # int32 [Q, k] ground truth (may be None)
    distances: np.ndarray | None  # float32 [Q, k]
    metric: str = "l2"  # "l2" | "cosine"


def synthetic_clustered(
    n: int,
    d: int = 128,
    n_queries: int = 1024,
    seed: int = 0,
    n_clusters: int | None = None,
    noise: float = 0.05,
    name: str | None = None,
) -> Dataset:
    """Seeded SIFT-like synthetic data: a mixture of Gaussian clusters,
    queries drawn from the same mixture. Ground truth is not included —
    compute it in quantized space (``models.flat.FlatIndex``).

    Generated in float32 blocks to bound peak host memory at large N.
    """
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(64, min(n // 100, 16384))
    centers = rng.random((n_clusters, d), np.float32)
    train = np.empty((n, d), np.float32)
    block = 1 << 18
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        a = rng.integers(0, n_clusters, hi - lo)
        train[lo:hi] = centers[a] + rng.normal(0, noise, (hi - lo, d)).astype(
            np.float32
        )
    qa = rng.integers(0, n_clusters, n_queries)
    test = (
        centers[qa] + rng.normal(0, noise, (n_queries, d)).astype(np.float32)
    )
    return Dataset(
        name or f"synthetic-clustered-{n}x{d}", train, test, None, None, "l2"
    )


def synthetic_heavy_tailed(
    n: int,
    d: int = 128,
    n_queries: int = 1024,
    seed: int = 0,
    n_clusters: int | None = None,
    name: str | None = None,
) -> Dataset:
    """Seeded hard synthetic regime (a copy of the JAX package's
    ``synthetic_heavy_tailed``): Zipf-distributed cluster sizes (a few
    giant clusters and a long tail of rare ones) with a per-cluster scale
    spread (x0.5..x4 noise) and 20% of the queries drawn from the rare
    tail. The skewed density is the adversarial case for pivot seeding:
    most pivots land in the head clusters while tail queries need the
    graph, or the shortlist probe, to reach their neighbors."""
    rng = np.random.default_rng(seed + 1)
    if n_clusters is None:
        n_clusters = max(64, min(n // 100, 16384))
    centers = rng.random((n_clusters, d), np.float32)
    # Zipf-ish sizes: p(c) ~ 1 / (rank + 10)
    w = 1.0 / (np.arange(n_clusters) + 10.0)
    p = w / w.sum()
    scales = (0.5 * 8.0 ** rng.random(n_clusters) * 0.05).astype(np.float32)
    train = np.empty((n, d), np.float32)
    block = 1 << 18
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        a = rng.choice(n_clusters, size=hi - lo, p=p)
        train[lo:hi] = centers[a] + (
            rng.standard_normal((hi - lo, d)).astype(np.float32)
            * scales[a, None]
        )
    # 20% tail queries: clusters from the rarest half
    nq_tail = n_queries // 5
    qa_head = rng.choice(n_clusters, size=n_queries - nq_tail, p=p)
    qa_tail = rng.integers(n_clusters // 2, n_clusters, nq_tail)
    qa = np.concatenate([qa_head, qa_tail])
    test = centers[qa] + (
        rng.standard_normal((n_queries, d)).astype(np.float32) * scales[qa, None]
    )
    return Dataset(
        name or f"synthetic-heavy-tailed-{n}x{d}", train, test, None, None, "l2"
    )
