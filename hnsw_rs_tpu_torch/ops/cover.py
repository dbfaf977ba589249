"""Coverage-driven pivot selection: batch-greedy k-center fill (port of
``hnsw_rs_tpu/ops/cover.py``).

k-center (farthest-point) fill picks the points farthest from the current
pivot set — the regions density-proportional sampling starves — giving a
2-approximate k-center cover regardless of density. The point table is
processed in row chunks so no [N, P] distance matrix is materialized.
"""

from __future__ import annotations

import numpy as np
import torch

from .topk import topk_lowest

_ROWS = 65536  # row chunk: bounds every temp at [_ROWS, batch]


def _min_d2_to(x: torch.Tensor, xn: torch.Tensor, vecs: torch.Tensor,
               mind: torch.Tensor) -> torch.Tensor:
    """``min(mind, min_j ||x - vecs_j||^2)``, chunked along the rows of x."""
    vn = (vecs * vecs).sum(dim=-1)
    out = torch.empty_like(mind)
    for lo in range(0, x.shape[0], _ROWS):
        hi = lo + _ROWS
        d2 = xn[lo:hi, None] + vn[None, :] - 2.0 * (x[lo:hi] @ vecs.T)
        out[lo:hi] = torch.minimum(mind[lo:hi], d2.amin(dim=1))
    return out


def _kcenter(x: torch.Tensor, base_ids: np.ndarray, budget: int, batch: int,
             n_alive: int | None = None) -> np.ndarray:
    """Greedy k-center picks over the rows of ``x`` (f32[N, d]), in pick
    order: ``budget // batch`` rounds, each taking the ``batch`` rows
    farthest from ``base_ids`` and every earlier pick (farthest first,
    ties to the lower row). Rows at or past ``n_alive`` start at -inf, so
    they are picked only once every live row has been. Returns int64
    row ids (``budget`` of them; a picked row is never picked again while
    a live row is left)."""
    n = x.shape[0]
    xn = (x * x).sum(dim=-1)
    mind = torch.full((n,), float("inf"), device=x.device)
    if n_alive is not None:
        mind[n_alive:] = -float("inf")
    base = torch.from_numpy(np.asarray(base_ids, np.int64)).to(x.device)
    for lo in range(0, base.shape[0], batch):
        mind = _min_d2_to(x, xn, x[base[lo:lo + batch]], mind)
    picks = []
    for _ in range(budget // batch):
        _, top = topk_lowest(-mind, batch)  # farthest first
        mind = _min_d2_to(x, xn, x[top], mind)
        mind[top] = -float("inf")  # picked rows are never re-picked
        picks.append(top)
    return torch.cat(picks).cpu().numpy().astype(np.int64)


def kcenter_fill(x: torch.Tensor, base_ids: np.ndarray, need: int,
                 batch: int = 256) -> np.ndarray:
    """Pick ``need`` coverage pivots from ``x`` (f32[N, d]) farthest from
    ``base_ids``' rows, ``batch`` picks per greedy round (farthest first,
    ties to the lower row). Returns int64 ids deduped against
    ``base_ids``; the count can fall below ``need`` when exact duplicate
    points tie."""
    n = x.shape[0]
    base_ids = np.asarray(base_ids, np.int64)
    need = int(min(need, max(0, n - base_ids.size)))
    if need <= 0:
        return np.zeros((0,), np.int64)
    batch = int(min(batch, need))
    picks = _kcenter(x, base_ids, -(-need // batch) * batch, batch)[:need]
    return np.unique(picks[~np.isin(picks, base_ids)])
