"""Exact k nearest neighbours in the index's stored space, in float64.

Plain PyTorch: the squared L2 distance ``|q|^2 + |x|^2 - 2 q.x`` of
every query to every point in float64 (norms of ~1e2 leave an error near
1e-14, far below any gap between two stored points), then ``topk``, in
blocks of queries so that a [block, N] float64 slab fits. TF32 plays no
part in float64 products. Imports nothing of the program.
"""

from __future__ import annotations

import torch


def exact_topk(points: torch.Tensor, queries: torch.Tensor, k: int,
               slab_bytes: int = 4 << 30) -> torch.Tensor:
    """Ids int64[Q, k] of the k nearest stored points to each query,
    nearest first. ``points`` and ``queries`` are the stored (quantized,
    then dequantized) float32 vectors."""
    x = points.to(torch.float64)
    xn = (x * x).sum(dim=1)
    n = x.shape[0]
    block = max(1, min(queries.shape[0], slab_bytes // (8 * n)))
    out = torch.empty((queries.shape[0], k), dtype=torch.int64,
                      device=points.device)
    for lo in range(0, queries.shape[0], block):
        q = queries[lo:lo + block].to(torch.float64)
        d2 = (q * q).sum(dim=1, keepdim=True) + xn[None, :] - 2.0 * (q @ x.T)
        out[lo:lo + block] = torch.topk(d2, k, dim=1, largest=False).indices
        del d2
    return out


def pair_d2(points: torch.Tensor, queries: torch.Tensor,
            qidx: torch.Tensor, ids: torch.Tensor):
    """Direct float64 ``sum((q - x)^2)`` of each (query, id) pair, and
    ``|q|^2 + |x|^2`` beside it (the scale a float32 product's rounding
    error grows with). ``ids`` int64[B, k], valid."""
    q = queries[qidx].to(torch.float64)[:, None, :]
    x = points[ids].to(torch.float64)
    d2 = ((q - x) ** 2).sum(dim=-1)
    scale = (q * q).sum(dim=-1) + (x * x).sum(dim=-1)
    return d2, scale
