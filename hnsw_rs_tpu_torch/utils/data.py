"""Dataset partitioning and ground-truth fixtures (``hnsw/src/helpers/
data.rs``): ``split`` (contiguous id partitions, ``data.rs:6-32``) and
brute-force ground-truth JSON fixtures (``data.rs:34-62``). A copy of
``hnsw_rs_tpu/utils/data.py``: either package reads the other's
fixtures."""

from __future__ import annotations

import json
import os

import numpy as np


def split(n: int, k: int) -> list[np.ndarray]:
    """Split ids 0..n into k contiguous chunks (sizes differ by <= 1)."""
    bounds = np.linspace(0, n, k + 1).astype(int)
    return [np.arange(bounds[i], bounds[i + 1], dtype=np.int32) for i in range(k)]


def save_bf_data(path: str, neighbors: np.ndarray) -> None:
    """Write precomputed brute-force neighbors as a JSON fixture:
    {query_idx: [neighbor ids...]}."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({str(i): row.tolist() for i, row in enumerate(neighbors)}, f)


def load_bf_data(path: str) -> np.ndarray:
    """Read a fixture written by :func:`save_bf_data` -> int32[Q, k]."""
    with open(path) as f:
        d = json.load(f)
    return np.asarray([d[str(i)] for i in range(len(d))], dtype=np.int32)
