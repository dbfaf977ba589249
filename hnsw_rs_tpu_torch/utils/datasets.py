"""Benchmark datasets: the ann-benchmarks HDF5 layout and seeded
synthetic stand-ins. A copy of ``hnsw_rs_tpu/utils/datasets.py``: the
same seed draws the same numpy stream, so both packages see
bit-identical vectors, and either package reads the HDF5 files the
other writes (datasets ``train``, ``test``, ``neighbors``,
``distances``; attribute ``distance``). ``h5py`` is imported only by
the two HDF5 functions.
"""

from __future__ import annotations

import dataclasses
import os

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


def load_ann_benchmarks_hdf5(path: str, limit: int = 0) -> Dataset:
    """Read an ann-benchmarks HDF5 file (glove-*-angular,
    sift-128-euclidean, ...). ``limit`` truncates the train set; the
    ground truth then refers to the full set and is dropped."""
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("h5py is required to read ann-benchmarks HDF5 "
                           "files") from e
    with h5py.File(path, "r") as f:
        train = np.asarray(f["train"], np.float32)
        test = np.asarray(f["test"], np.float32)
        neighbors = np.asarray(f["neighbors"], np.int32) if "neighbors" in f else None
        distances = np.asarray(f["distances"], np.float32) if "distances" in f else None
        metric = f.attrs.get("distance", b"euclidean")
        if isinstance(metric, bytes):
            metric = metric.decode()
    if limit and limit < train.shape[0]:
        train = train[:limit]
        neighbors = distances = None
    name = os.path.splitext(os.path.basename(path))[0]
    metric = "cosine" if metric in ("angular", "cosine") else "l2"
    return Dataset(name, train, test, neighbors, distances, metric)


def write_ann_benchmarks_hdf5(path: str, ds: Dataset) -> None:
    """Write the ann-benchmarks layout (fixtures and round trips)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("train", data=ds.train)
        f.create_dataset("test", data=ds.test)
        if ds.neighbors is not None:
            f.create_dataset("neighbors", data=ds.neighbors)
        if ds.distances is not None:
            f.create_dataset("distances", data=ds.distances)
        f.attrs["distance"] = "angular" if ds.metric == "cosine" else "euclidean"


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
