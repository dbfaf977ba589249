"""Graph refinement: synchronous NN-descent rounds over a built layer
(port of ``hnsw_rs_tpu/refine.py``).

One round recomputes every node's out-row from its 2-hop out-neighborhood
(own row + the first ``hop_w`` slots of each out-neighbor's row), scored
exactly and re-selected with the Algorithm-4 accept chain
(``heuristic._accept_from_pool`` with the ``keep_pruned`` fill, the
reference's ``prune_connections`` semantics applied to a richer pool).
This is the NN-descent local join (Dong et al., WWW'11) restricted to the
directed out-graph, which after the cluster-bulk build's reverse-edge union
merge already carries both edge directions' information.

Why it exists: the cluster-bulk build's pools are k-means-local. On
regimes whose natural blob granularity fights the clustering (heavy-tailed
Zipf blobs with a scale spread) some true kNN edges never enter any pool,
and no serving-side budget recovers them. One refinement round gives every
node a pool that its current neighborhood votes for.

The round is synchronous: every chunk reads the OLD adjacency and the new
rows go into a fresh tensor, so the result does not depend on the chunk
order. The [r, P, d] pool temp is bounded by ``batch`` and ``hop_w``
(P = cap + cap * hop_w rows per node).
"""

from __future__ import annotations

import torch

from .build_cluster import repair_orphans
from .graphs import recount_indeg
from .heuristic import _accept_from_pool
from .ops.quant import dequantize
from .ops.topk import INF, PAD_ID, dedup_ids, sort_dist_id

__all__ = ["refine_layer"]


def _refine_chunk_impl(codes, scales, adj, off: int, r: int, hop_w: int,
                       pool_p: int, cap: int, use_alg4: bool):
    """New rows [r, cap] for nodes ``off .. off+r`` from the old ``adj``."""
    n = adj.shape[0]
    rows = torch.arange(off, off + r, dtype=torch.int32, device=adj.device)
    own = adj[off:off + r]  # [r, cap]
    hop = adj[torch.where(own >= 0, own, 0).long()][:, :, :hop_w]  # [r, cap, hop_w]
    hop = torch.where(own[:, :, None] >= 0, hop, -1)
    pool = torch.cat([own, hop.reshape(r, -1)], dim=1)  # [r, P]
    pool = torch.where(pool == rows[:, None], -1, pool)  # drop self
    psafe = torch.where(pool >= 0, pool, 0).clamp(0, n - 1).long()

    qvec = dequantize(codes[off:off + r], scales[off:off + r])  # [r, d]
    pvec = dequantize(codes[psafe], scales[psafe])  # [r, P, d]
    # expanded matmul form, as in the JAX package
    qc = torch.bmm(pvec, qvec[:, :, None])[:, :, 0]  # [r, P]
    d2 = torch.clamp_min(
        (qvec * qvec).sum(1)[:, None] + (pvec * pvec).sum(2) - 2.0 * qc, 0.0)
    del pvec
    d2 = torch.where(pool >= 0, d2, INF)
    ids = torch.where(pool >= 0, pool, PAD_ID)
    d2, ids = dedup_ids(d2, ids)
    d2, ids = sort_dist_id(d2, ids)
    p = min(max(pool_p, cap), ids.shape[1])
    d2, ids = d2[:, :p], ids[:, :p]
    if use_alg4:
        _, sel = _accept_from_pool(codes, scales, qvec, d2, ids, cap,
                                   keep_pruned=True)
    else:
        sel = ids[:, :cap]
    return torch.where(sel == PAD_ID, -1, sel)


def refine_layer(graph, store, layer_nb: int = 0, rounds: int = 1,
                 hop_w: int = 8, pool_p: int = 192, use_alg4: bool = True,
                 batch: int = 1024) -> None:
    """Run ``rounds`` synchronous NN-descent rounds over layer
    ``layer_nb`` of ``graph`` in place, then recount the in-degrees and
    re-run the orphan-repair fixpoint (refinement can evict a node's last
    in-edge, as the merge can)."""
    n = len(store)
    if n == 0 or rounds <= 0:
        return
    codes, scales = store.codes[:n], store.scales[:n]
    full = graph.get_layer(layer_nb)
    adj = full[:n]
    cap = adj.shape[1]
    r = min(batch, n)
    for _ in range(rounds):
        new = torch.empty_like(adj)
        for off in range(0, n, r):
            h = min(r, n - off)
            new[off:off + h] = _refine_chunk_impl(
                codes, scales, adj, off, h, hop_w, pool_p, cap, use_alg4)
        adj = new
    adj, indeg = repair_orphans(adj, recount_indeg(adj))
    if full.shape[0] != n:  # capacity rows past the live ones stay empty
        full = full.clone()
        full[:n] = adj
        adj, indeg = full, None
    graph.set_layer(layer_nb, adj, indeg)
