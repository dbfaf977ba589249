"""Layered graph topology as dense fixed-slot adjacency tensors (port of
``hnsw_rs_tpu/graphs.py``).

Each layer is an ``int32[N, cap]`` tensor whose row ``i`` lists node
``i``'s out-neighbors, padded with ``SENTINEL`` (-1); ``cap = 2m`` at
layer 0 and ``m`` above. Node ``i`` belongs to layer ``l`` iff
``levels[i] >= l``. Beside each layer the graph keeps its in-degree
ledger, ``int32[N]``, which the wave builder updates with every edge it
writes and reads for its isolate protection. The per-edge mutation API of
the JAX package is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.topk import SENTINEL


def degrees(adj: torch.Tensor) -> torch.Tensor:
    """Out-degree of every row: count of non-sentinel slots, int32[N]."""
    return (adj >= 0).sum(dim=-1, dtype=torch.int32)


def recount_indeg(adj: torch.Tensor) -> torch.Tensor:
    """In-degree of every row of ``adj``, int32[N]."""
    n = adj.shape[0]
    return torch.bincount(adj[adj >= 0].long(), minlength=n).to(torch.int32)


class LayeredGraph:
    """Stack of dense adjacency layers sharing one row space of ``n`` ids."""

    def __init__(self, m: int, n: int, device: torch.device | str):
        self.m = int(m)
        self.n = int(n)
        self.device = torch.device(device)
        self.adjs: list[torch.Tensor] = []
        self._indegs: list[torch.Tensor | None] = []

    def __len__(self) -> int:
        return len(self.adjs)

    def layer_cap(self, layer_nb: int) -> int:
        """Degree cap: ``2m`` at layer 0, ``m`` above."""
        return self.m * 2 if layer_nb == 0 else self.m

    def ensure_level(self, level: int) -> None:
        """Grow the layer stack so layers ``0..=level`` exist."""
        while len(self.adjs) <= level:
            cap = self.layer_cap(len(self.adjs))
            self.adjs.append(torch.full(
                (self.n, cap), SENTINEL, dtype=torch.int32, device=self.device
            ))
            self._indegs.append(
                torch.zeros(self.n, dtype=torch.int32, device=self.device)
            )

    def ensure_nodes(self, n: int) -> None:
        """Grow every layer's row space to at least ``n`` rows; the new
        rows are empty, so the in-degree ledgers stay valid zero-padded."""
        if n <= self.n:
            return
        for i, adj in enumerate(self.adjs):
            pad = adj.new_full((n - adj.shape[0], adj.shape[1]), SENTINEL)
            self.adjs[i] = torch.cat([adj, pad])
            d = self._indegs[i]
            if d is not None:
                self._indegs[i] = torch.cat([d, d.new_zeros(n - d.shape[0])])
        self.n = n

    def get_layer(self, layer_nb: int) -> torch.Tensor:
        if layer_nb >= len(self.adjs):
            raise IndexError(f"layer {layer_nb} not found")
        return self.adjs[layer_nb]

    def set_layer(
        self, layer_nb: int, adj: torch.Tensor,
        indeg: torch.Tensor | None = None,
    ) -> None:
        """Replace a layer's adjacency and, optionally, its known in-degree
        vector (None recounts it lazily)."""
        self.adjs[layer_nb] = adj
        self._indegs[layer_nb] = indeg

    def indeg(self, layer_nb: int) -> torch.Tensor:
        """In-degree of every node at a layer (cached)."""
        if self._indegs[layer_nb] is None:
            self._indegs[layer_nb] = recount_indeg(self.adjs[layer_nb])
        return self._indegs[layer_nb]

    def layer_degrees(self, layer_nb: int, levels: np.ndarray) -> np.ndarray:
        """Out-degrees of the nodes belonging to ``layer_nb``
        (``HNSW::layer_degrees``, ``hnsw/src/template.rs:158-163``)."""
        degs = degrees(self.adjs[layer_nb]).cpu().numpy()
        return degs[np.asarray(levels) >= layer_nb]

    def nb_nodes(self, layer_nb: int, levels: np.ndarray) -> int:
        return int(np.sum(np.asarray(levels) >= layer_nb))
