"""Layered graph topology as dense fixed-slot adjacency tensors (port of
``hnsw_rs_tpu/graphs.py``).

Each layer is an ``int32[N, cap]`` tensor whose row ``i`` lists node
``i``'s out-neighbors, padded with ``SENTINEL`` (-1); ``cap = 2m`` at
layer 0 and ``m`` above. Node ``i`` belongs to layer ``l`` iff
``levels[i] >= l``. Beside each layer the graph keeps its in-degree
ledger, ``int32[N]``, which the wave builder updates with every edge it
writes and reads for its isolate protection.

The small per-edge API (``add_edge``, ``remove_edge``, ``isolate_node``,
``replace_neighbors``, ``make_rand``) is the JAX package's, with the
reference's undirected semantics (``graph/src/graph.rs:37-137``); it
writes rows in place on the graph's device and keeps each layer's ledger
equal to :func:`recount_indeg`, where the JAX package drops its cached
ledger. The build paths never go through it.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import IsolatedNode, MExceeded, NodeNotInGraph, SelfConnection
from .ops.topk import SENTINEL


def empty_adjacency(n: int, cap: int, device: torch.device | str) -> torch.Tensor:
    """All-sentinel adjacency for ``n`` nodes with degree cap ``cap``."""
    return torch.full((n, cap), SENTINEL, dtype=torch.int32, device=device)


def row_insert(row: torch.Tensor, value: int) -> torch.Tensor:
    """``row`` with ``value`` in its first sentinel slot (set semantics:
    unchanged if already present or if the row is full). Pure."""
    free = row < 0
    slot = torch.argmax(free.to(torch.int32))  # the first free slot
    can = ~(row == value).any() & free.any()
    at = can & (torch.arange(row.shape[0], device=row.device) == slot)
    return torch.where(at, torch.full_like(row, value), row)


def row_remove(row: torch.Tensor, value: int) -> torch.Tensor:
    """``row`` with ``value`` replaced by the sentinel. Pure."""
    return torch.where(row == value, torch.full_like(row, SENTINEL), row)


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
            self.adjs.append(empty_adjacency(self.n, cap, self.device))
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

    # -- per-edge API (undirected, like the reference's Graph) -------------

    def _check(self, layer_nb: int, node: int) -> None:
        if node < 0 or node >= self.n:
            raise NodeNotInGraph(node)

    def _write_row(self, layer_nb: int, node: int, row: torch.Tensor) -> None:
        """Write ``node``'s row in place and move the layer's ledger from
        the old row's ids to the new row's."""
        adj = self.adjs[layer_nb]
        indeg = self.indeg(layer_nb)
        old, new = adj[node], row[row >= 0]
        old = old[old >= 0]
        indeg.index_add_(0, old.long(), torch.full_like(old, -1))
        indeg.index_add_(0, new.long(), torch.ones_like(new))
        adj[node] = row

    def add_edge(self, layer_nb: int, a: int, b: int) -> None:
        """Undirected edge insert; rejects self-loops
        (``graph/src/graph.rs:37-52``) and raises :class:`MExceeded` when
        an endpoint's row is full and lacks the other endpoint."""
        if a == b:
            raise SelfConnection(a)
        self._check(layer_nb, a)
        self._check(layer_nb, b)
        adj = self.adjs[layer_nb]
        rows = adj[[a, b]].cpu().numpy()
        for node, other, row in ((a, b, rows[0]), (b, a, rows[1])):
            if other not in row and not np.any(row < 0):
                raise MExceeded(node, int(row.shape[0]))
        self._write_row(layer_nb, a, row_insert(adj[a], b))
        self._write_row(layer_nb, b, row_insert(adj[b], a))

    def remove_edge(self, layer_nb: int, a: int, b: int) -> None:
        """Undirected edge removal (``graph/src/graph.rs:72-83``)."""
        self._check(layer_nb, a)
        self._check(layer_nb, b)
        adj = self.adjs[layer_nb]
        self._write_row(layer_nb, a, row_remove(adj[a], b))
        self._write_row(layer_nb, b, row_remove(adj[b], a))

    def neighbors(self, layer_nb: int, node: int) -> np.ndarray:
        """Valid neighbor ids of ``node`` (``graph/src/graph.rs:96-125``)."""
        self._check(layer_nb, node)
        row = self.adjs[layer_nb][node].cpu().numpy()
        return row[row >= 0]

    def degree(self, layer_nb: int, node: int) -> int:
        self._check(layer_nb, node)
        return int((self.adjs[layer_nb][node] >= 0).sum())

    def isolate_node(self, layer_nb: int, node: int, strict: bool = False) -> None:
        """Remove ``node``'s edges both ways, skipping a neighbor that
        would drop to degree 0 (``Graph::isolate_node``,
        ``graph/src/graph.rs:85-94``); with ``strict=True`` such a neighbor
        raises :class:`IsolatedNode` instead."""
        self._check(layer_nb, node)
        for nb in self.neighbors(layer_nb, node):
            if self.degree(layer_nb, int(nb)) > 1:
                self.remove_edge(layer_nb, node, int(nb))
            elif strict:
                raise IsolatedNode(int(nb))

    def replace_neighbors(self, layer_nb: int, node: int, new_neighbors) -> None:
        """Replace ``node``'s outgoing list: first occurrences of the
        non-negative ids, cut at the cap (the directed analogue of
        ``Graph::replace_neighbors``, ``graph/src/graph.rs:128-137``)."""
        self._check(layer_nb, node)
        cap = self.adjs[layer_nb].shape[1]
        new = np.full((cap,), SENTINEL, dtype=np.int32)
        uniq = [x for x in dict.fromkeys(int(v) for v in new_neighbors) if x >= 0]
        new[: min(len(uniq), cap)] = uniq[:cap]
        self._write_row(layer_nb, node, torch.from_numpy(new).to(self.device))

    @classmethod
    def make_rand(cls, n: int, m: int, n_edges: int, seed: int = 0, *,
                  device: torch.device | str) -> "LayeredGraph":
        """Random single-layer graph for tests (``make_rand_graph``,
        ``graph/src/graph.rs:254-273``); the same seed draws the same
        edges as the JAX package's."""
        g = cls(m, n, device)
        g.ensure_level(0)
        rng = np.random.default_rng(seed)
        added = 0
        while added < n_edges:
            a, b = (int(x) for x in rng.integers(0, n, 2))
            if (a == b or b in g.neighbors(0, a)
                    or g.degree(0, a) >= g.layer_cap(0)
                    or g.degree(0, b) >= g.layer_cap(0)):
                continue
            g.add_edge(0, a, b)
            added += 1
        return g

    # -- introspection -------------------------------------------------------

    def layer_degrees(self, layer_nb: int, levels: np.ndarray) -> np.ndarray:
        """Out-degrees of the nodes belonging to ``layer_nb``
        (``HNSW::layer_degrees``, ``hnsw/src/template.rs:158-163``)."""
        degs = degrees(self.adjs[layer_nb]).cpu().numpy()
        return degs[np.asarray(levels) >= layer_nb]

    def nb_nodes(self, layer_nb: int, levels: np.ndarray) -> int:
        return int(np.sum(np.asarray(levels) >= layer_nb))
