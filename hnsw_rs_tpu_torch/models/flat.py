"""Exact (brute-force) nearest-neighbor index (port of
``hnsw_rs_tpu/models/flat.py``): the ground truth behind every recall
gate. Quantized (u8 codes) or raw float rows, L2 or cosine, the affine
fast form, the direct ``exact`` form, and the fused distance + group-min
kernel; ``save``/``load`` in the JAX package's ``hnsw_rs_tpu.flat.v1``
format, so either package loads the other's directory.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..errors import DimensionMismatch
from ..ops.distance import (
    normalize,
    pairwise_l2sq_exact,
    pairwise_l2sq_mxu,
    point_normsq,
)
from ..ops.groupmin import flat_topk_fused
from ..ops.quant import dequantize, quantize
from ..ops.topk import PAD_ID, sort_dist_id, topk_dist_id, topk_lowest

FORMAT = "hnsw_rs_tpu.flat.v1"
# up to this many rows one two-key sort of [B, N] is cheap and breaks
# distance ties strictly by id; above it the tiled path takes over
_SORT_PATH_MAX = 32768
_TILE = 131072  # collection rows per streaming step
_TEMP_BYTES = 1 << 28  # bound of the direct form's [b, t, d] f32 temporary


def _pairwise_exact_tiled(q, codes, scales):
    """``pairwise_l2sq_exact`` -> [B, N], filled tile by tile: eager
    PyTorch materializes the [b, t, d] difference, so queries and rows go
    through in tiles that keep it under ``_TEMP_BYTES``."""
    b, d = q.shape
    n = codes.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    tn = max(1, min(n, _TEMP_BYTES // (max(d, 1) * 4)))
    tb = max(1, min(b, _TEMP_BYTES // (tn * max(d, 1) * 4)))
    for qlo in range(0, b, tb):
        for lo in range(0, n, tn):
            out[qlo:qlo + tb, lo:lo + tn] = pairwise_l2sq_exact(
                q[qlo:qlo + tb], codes[lo:lo + tn], scales[lo:lo + tn])
    return out


def _flat_search(q, codes, scales, normsq, k: int, exact: bool):
    """Top-k of every query: the tiled path past ``_SORT_PATH_MAX`` rows,
    else the whole [B, N] matrix (direct form under ``exact``) and one
    (d2, id) sort. Returns (sqrt(d2) [B, k], ids [B, k])."""
    n = codes.shape[0]
    if n > _SORT_PATH_MAX and not exact:
        return _flat_search_tiled(q, codes, scales, normsq, k)
    if exact:
        d2 = _pairwise_exact_tiled(q, codes, scales)
    else:
        d2 = pairwise_l2sq_mxu(q, codes, scales, normsq)
    ids = torch.arange(n, dtype=torch.int32, device=q.device).expand(d2.shape)
    td, ti = topk_dist_id(d2, ids, k)
    return torch.sqrt(td), ti


def _flat_search_tiled(q, codes, scales, normsq, k: int):
    """Streaming exact top-k: affine distances one tile of the collection
    at a time, merged into a running (d2, id)-sorted top-k, so no [B, N]
    matrix is ever sorted. Returns (sqrt(d2) [B, k], ids [B, k]). As in the
    JAX package, exact distance ties at the k-th place inside one tile are
    broken by ``topk_lowest``, not by id."""
    b = q.shape[0]
    n = codes.shape[0]
    qsq = (q * q).sum(dim=-1, keepdim=True)
    qsum = q.sum(dim=-1, keepdim=True)
    bd = torch.full((b, k), float("inf"), device=q.device)
    bi = torch.full((b, k), PAD_ID, dtype=torch.int32, device=q.device)
    for lo in range(0, n, _TILE):
        hi = min(lo + _TILE, n)
        s = scales[lo:hi]
        qdotc = q @ codes[lo:hi].to(torch.float32).T
        qdotx = s[:, 1][None] * qdotc + s[:, 0][None] * qsum
        d2 = torch.clamp_min(qsq + normsq[lo:hi][None] - 2.0 * qdotx, 0.0)
        td, ti = topk_lowest(d2, min(k, hi - lo))
        md = torch.cat([bd, td], dim=1)
        mi = torch.cat([bi, (ti + lo).to(torch.int32)], dim=1)
        sd, si = sort_dist_id(md, mi)
        bd, bi = sd[:, :k], si[:, :k]
    return torch.sqrt(bd), bi


class FlatIndex:
    """Exact k-NN over a quantized (or raw float) collection held on
    ``device``."""

    def __init__(self, dim: int, device: torch.device | str,
                 quantized: bool = True, metric: str = "l2"):
        if metric not in ("l2", "cosine"):
            raise ValueError(f"unknown metric {metric!r}")
        self.dim = int(dim)
        self.device = torch.device(device)
        self.quantized = quantized
        self.metric = metric
        self.codes = torch.zeros(
            (0, dim), dtype=torch.uint8 if quantized else torch.float32,
            device=self.device)
        self.scales = torch.zeros((0, 2), dtype=torch.float32, device=self.device)
        self._normsq = torch.zeros((0,), dtype=torch.float32, device=self.device)

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    def add(self, vectors) -> np.ndarray:
        """Append vectors; returns their ids (row positions). Every call
        recomputes the norms of the whole collection, as the JAX package
        does: add in bulk."""
        x = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        x = torch.atleast_2d(x)
        if x.shape[-1] != self.dim:
            raise DimensionMismatch(f"index dim {self.dim}, got {x.shape[-1]}")
        if self.metric == "cosine":
            x = normalize(x)
        if self.quantized:
            codes, scales = quantize(x)
        else:
            # raw f32 rows with identity scales (``vectors/src/full.rs``):
            # the same distance forms then compute exact L2
            codes = x
            scales = torch.tensor([[0.0, 1.0]], device=self.device).repeat(
                x.shape[0], 1)
        start = len(self)
        self.codes = torch.cat([self.codes, codes])
        self.scales = torch.cat([self.scales, scales])
        self._normsq = point_normsq(self.codes, self.scales)
        return np.arange(start, start + x.shape[0], dtype=np.int32)

    def search(self, queries, k: int, exact: bool = False,
               fused: bool = False):
        """Exact top-k: (distances [B, k], ids [B, k]) as numpy arrays.

        Queries of a quantized collection are quantized first
        (``hnsw/src/template.rs:313``), so distances live in the same
        quantized space as the HNSW path. ``exact=True`` uses the direct
        (cancellation-free) distance form, for oracle use; the default is
        the affine form: one (d2, id) sort up to ``_SORT_PATH_MAX`` rows,
        the streaming tiled search above. ``fused=True`` runs the
        distance + group-min kernel (:func:`ops.groupmin.flat_topk_fused`,
        the [B, N] matrix never reaches memory); it needs a quantized
        collection."""
        x = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        x = torch.atleast_2d(x)
        if self.metric == "cosine":
            x = normalize(x)
        q = dequantize(*quantize(x)) if self.quantized else x
        if fused:
            if not self.quantized:
                raise ValueError("fused path requires a quantized collection")
            d2, i = flat_topk_fused(q, self.codes, self.scales, self._normsq, k)
            d = torch.sqrt(d2)
        else:
            d, i = _flat_search(q, self.codes, self.scales, self._normsq, k,
                                exact)
        return d.cpu().numpy(), i.cpu().numpy()

    # -- persistence ----------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint to a directory: ``params.json`` + ``arrays.npz``."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "params.json"), "w") as f:
            json.dump({"format": FORMAT, "dim": self.dim,
                       "quantized": self.quantized, "metric": self.metric},
                      f, indent=2)
        np.savez_compressed(os.path.join(path, "arrays.npz"),
                            codes=self.codes.cpu().numpy(),
                            scales=self.scales.cpu().numpy())

    @classmethod
    def load(cls, path: str, device: torch.device | str) -> "FlatIndex":
        """Restore from either package's :meth:`save`."""
        with open(os.path.join(path, "params.json")) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT:
            raise ValueError(f"unknown index format in {path}")
        index = cls(meta["dim"], device, quantized=meta["quantized"],
                    metric=meta["metric"])
        with np.load(os.path.join(path, "arrays.npz")) as z:
            index.codes = torch.from_numpy(z["codes"]).to(index.device)
            index.scales = torch.from_numpy(z["scales"]).to(index.device)
        index._normsq = point_normsq(index.codes, index.scales)
        return index
