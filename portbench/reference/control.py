"""The control: the reference put in the program's place, computed one
precision below the configuration's float32, in TF32.

It is an index family like ``portbench/indexes/*.py`` (``build``,
``search``), so the harness drives it through the same traffic and the
same judge; it has to come out not correct. The product's operands are
rounded to TF32 (a 10-bit mantissa) and multiplied with float32 sums,
which is what a TF32 tensor core computes, over the stored vectors of
the configuration's ``metric`` (``quant.stored``, as the judge takes
them). The rounding is done here and not left to ``allow_tf32``, since
cuBLAS takes a path without tensor cores for some shapes (one query: a
matrix-vector product) and would then compute in float32.
``python portbench/control.py`` runs it.
"""

from __future__ import annotations

import numpy as np
import torch

from .quant import stored


class ControlIndex:
    def __init__(self, points: torch.Tensor, metric: str):
        self.points, self.metric = points, metric
        self.norms = (points * points).sum(dim=1)
        self.points_tf32 = _tf32(points)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def build(config: dict, train: np.ndarray, devices: list[torch.device]):
    """The points in the stored space on the first device; no graph.
    Returns (index, spans)."""
    device = devices[0]
    pts = stored(torch.from_numpy(train).to(device), config["metric"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (ControlIndex(pts, config["metric"]),
            {"insert_bulk_s": 0.0, "finalize_s": 0.0})


def search(index: ControlIndex, queries: np.ndarray, k: int, rung: dict):
    """Exact top-k by ``|q|^2 + |x|^2 - 2 q.x`` with the product in TF32;
    (sqrt(d2), ids) as numpy, as the program's ``ann_batch`` returns."""
    q = stored(torch.from_numpy(np.asarray(queries, np.float32))
               .to(index.points.device), index.metric)
    x = index.points
    block = max(1, (2 << 30) // (4 * x.shape[0]))
    ds, ids = [], []
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        for lo in range(0, q.shape[0], block):
            qb = q[lo:lo + block]
            prod = _tf32(qb) @ index.points_tf32.T
            d2 = (qb * qb).sum(1, keepdim=True) + index.norms[None, :] - 2.0 * prod
            v, i = torch.topk(d2, k, dim=1, largest=False)
            ds.append(torch.sqrt(v.clamp_min(0.0)))
            ids.append(i.to(torch.int32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.cat(ds).cpu().numpy(), torch.cat(ids).cpu().numpy()
