"""Query data-parallelism over a replicated index (port of
``hnsw_rs_tpu/parallel/replicated.py``).

The serving fan-out: the index tensors (adjacency, serving table, scales)
are copied once to every device of the mesh's ``data`` axis, a query
batch is split over those devices, each slice runs the hierarchical
search pipeline (``search.ann_search``) on its copy, and the results are
concatenated in batch order. This is the answer to the reference's
one-query-at-a-time serving loop (``hnsw/src/template.rs:306-335``)."""

from __future__ import annotations

import numpy as np
import torch

from ..models.hnsw import HNSW
from ..ops.quant import dequantize, quantize
from ..search import ann_search
from .mesh import Mesh


class ReplicatedHNSW:
    """Wraps a built :class:`HNSW` for data-parallel batched queries."""

    def __init__(self, index: HNSW, mesh: Mesh):
        index.flush()
        self.index = index
        self.mesh = mesh
        self.ep = int(index.params.ep)
        table = index._serving_table()
        # one copy per distinct device (a device may repeat in the grid)
        self._copies = {}
        for dev in mesh.data_devices:
            if dev not in self._copies:
                self._copies[dev] = (
                    [a.to(dev) for a in index.graph.adjs], table.to(dev),
                    index.points.scales.to(dev))

    def ann_batch(self, queries, n: int, ef: int, max_iters: int | None = None):
        """(distances [B, n], ids [B, n]) as numpy arrays: the single
        index's hierarchical search, each data device answering its slice
        of the batch."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        ef = max(ef, n)
        if max_iters is None:
            max_iters = 2 * ef + 16
        devs = self.mesh.data_devices
        parts = np.array_split(np.arange(queries.shape[0]), len(devs))
        d_out, i_out = [], []
        for dev, rows in zip(devs, parts):
            x = torch.from_numpy(queries[rows]).to(dev)
            # cosine indexes store unit vectors: normalize the queries the
            # way HNSW.ann_batch does, so distances are the 2 - 2cos values
            q = dequantize(*quantize(self.index._maybe_normalize(x)))
            adjs, table, scales = self._copies[dev]
            d, i = ann_search(adjs, table, scales, q, self.ep, ef, n, max_iters)
            d_out.append(d.cpu().numpy())
            i_out.append(i.cpu().numpy())
        return np.concatenate(d_out), np.concatenate(i_out)
