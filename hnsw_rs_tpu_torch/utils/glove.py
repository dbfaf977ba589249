"""GloVe text-embedding loading and exact-NN ground truth (port of
``hnsw_rs_tpu/utils/glove.py``, the reference's ``hnsw/src/helpers/glove.rs``).

``load_glove_array`` parses "word v1 v2 ..." rows (``glove.rs:14-71``)
with the native parser (``native/fastio.cpp``), or in Python without
``g++``; ``brute_force_nns`` (``glove.rs:73-109``) computes exact
neighbors in the direct (diff-square) form on the store's device, tiled
over the queries and over the collection.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.distance import pairwise_l2sq_exact
from ..ops.quant import dequantize, quantize
from ..ops.topk import INF, PAD_ID, topk_dist_id

_TEMP_BYTES = 1 << 28  # bound of the direct form's [b, tile, d] f32 temporary


def load_glove_array(path: str, limit: int = 0,
                     verbose: bool = False) -> tuple[list[str], np.ndarray]:
    """Load up to ``limit`` rows (0 = all) of a GloVe text file: (words,
    float32[N, d]). Raises on ragged rows, as the reference does
    (``glove.rs:56-65``). The native parser reads it where ``g++`` is on
    ``PATH`` (``native.load_glove_native``); the Python loop below is its
    plain version."""
    from ..native import load_glove_native

    native = load_glove_native(path, limit)
    if native is not None:
        if verbose:
            print(f"loaded {len(native[0])} rows from {path}", flush=True)
        return native
    words: list[str] = []
    vecs: list[np.ndarray] = []
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            if limit and i >= limit:
                break
            parts = line.rstrip("\n").split(" ")
            v = np.asarray(parts[1:], dtype=np.float32)
            if vecs and v.shape[0] != vecs[0].shape[0]:
                raise ValueError(f"ragged GloVe row {i}: got dim {v.shape[0]}, "
                                 f"expected {vecs[0].shape[0]}")
            words.append(parts[0])
            vecs.append(v)
    if verbose:
        print(f"loaded {len(vecs)} rows from {path}", flush=True)
    return words, np.stack(vecs) if vecs else np.zeros((0, 0), np.float32)


def brute_force_nns(queries, codes: torch.Tensor, scales: torch.Tensor,
                    k: int, batch: int = 256) -> np.ndarray:
    """Exact top-k ids [B, k] of each query over the quantized store,
    ordered by (d2, id) (``graph/src/dist.rs:30-38``).

    Queries are quantized and dequantized first, as the reference's
    recall gate computes its ground truth in quantized space
    (``template.rs:531-541``). The direct form
    (:func:`~hnsw_rs_tpu_torch.ops.distance.pairwise_l2sq_exact`)
    materializes a [b, t, d] temporary, so the collection is walked in
    tiles of ``t`` rows with ``b * t * d * 4 <= _TEMP_BYTES`` and a running
    (d2, id) top-k is merged tile by tile."""
    n, d = codes.shape
    x = torch.as_tensor(np.asarray(queries, np.float32), device=codes.device)
    q = dequantize(*quantize(torch.atleast_2d(x)))
    out = []
    for i in range(0, q.shape[0], batch):
        qb = q[i:i + batch]
        b = qb.shape[0]
        tile = max(1, _TEMP_BYTES // (b * max(d, 1) * 4))
        best_d = torch.full((b, k), INF, device=q.device)
        best_i = torch.full((b, k), PAD_ID, dtype=torch.int32, device=q.device)
        for lo in range(0, n, tile):
            d2 = pairwise_l2sq_exact(qb, codes[lo:lo + tile], scales[lo:lo + tile])
            ids = torch.arange(lo, lo + d2.shape[1], dtype=torch.int32,
                               device=q.device).expand(b, -1)
            best_d, best_i = topk_dist_id(torch.cat([best_d, d2], 1),
                                          torch.cat([best_i, ids], 1), k)
        out.append(best_i.cpu().numpy())
    return np.concatenate(out, axis=0)
