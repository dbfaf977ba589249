"""Random test vectors (``gen_rand_vecs``, ``vectors/src/lib.rs:29-37``).
A copy of ``hnsw_rs_tpu/utils/rand.py``: the same seed gives the same
array in both packages."""

from __future__ import annotations

import numpy as np


def gen_rand_vecs(n: int, dim: int, seed: int | None = None) -> np.ndarray:
    """Uniform random float32 vectors in [0, 1), shape [n, dim]."""
    rng = np.random.default_rng(seed)
    return rng.random((n, dim), dtype=np.float32)
