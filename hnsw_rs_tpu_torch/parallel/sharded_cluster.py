"""Shard-concurrent cluster-bulk construction (port of
``hnsw_rs_tpu/parallel/sharded_cluster.py``; ``ShardedHNSW.insert_bulk(
cluster_build=True)``).

The single-index cluster-bulk builder (``build_cluster.py``) run for every
shard of a mesh, in the JAX package's five phases, each a loop over the
shards where the JAX package runs one ``shard_map`` program:

1. **prep**: per-shard k-means over the shard's members and the 1-D
   spatial projection used to chunk oversized clusters. The centroid
   count ``k`` comes from the largest shard; a smaller shard keeps
   ``ceil(members / points_per_cluster)`` live centroids and the rest are
   dead sentinels, so every shard is clustered at the same granularity.
2. **host**: per-shard ``_split_oversized`` + ``_member_tables`` (numpy,
   member-local, the single-index code).
3. **tables**: exact per-row centroids and representatives
   (``_table_centroids``) and the nearest-cluster fan-out, pad clusters
   masked out of it.
4. **select**: ``_cluster_sel_step_impl`` over each shard's cluster groups.
5. **merge**: ``_sel_pos`` + the global reverse-edge union-prune
   (``_global_merge`` / ``_global_merge_rows``), an in-degree recount and
   the round-varied orphan-repair fixpoint (``repair_orphans``). There is
   no host repair backstop: residual orphans are counted and logged.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..build_cluster import (
    _assign_only,
    _cluster_sel_step_impl,
    _global_merge,
    _global_merge_rows,
    _lloyd_iter,
    _member_tables,
    _nbr_clusters,
    _sel_pos,
    _split_oversized,
    _table_centroids,
    repair_orphans,
)
from ..graphs import recount_indeg
from ..ops.quant import dequantize

__all__ = ["sharded_cluster_layer"]

log = logging.getLogger(__name__)

# Dead-centroid sentinel: the assignment score is x.c - |c|^2/2, so a
# centroid at (DEAD, DEAD, ...) scores ~ -d*DEAD^2/2 and never wins the
# argmax for any real point; empty clusters keep their centroid in
# _lloyd_iter, so a dead centroid stays dead through every iteration.
# (d * DEAD^2 / 2 must stay inside f32: 2048 * 1e30 / 2 ~ 1e33 < 3.4e38.)
_DEAD_CENT = 1.0e15


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


def _prep_shard(codes, scales, rows, rpad: int, k: int, iters: int,
                train_per_cluster: int, chunk: int, ppc: int):
    """One shard's k-means over its members ``rows`` (int64 local row
    ids, dense member-first). Mirrors ``build_cluster.kmeans`` with the
    sample positions spread over the member count, the static sizes taken
    from ``rpad`` (the largest shard's member count rounded up to 8, as
    in the JAX package's padded stacks) and ``ksh = ceil(members / ppc)``
    live centroids of ``k``. Returns (assignment i32[members] against the
    final centroids, projection f32[members])."""
    rcount = rows.shape[0]
    dev = codes.device
    mcodes, mscales = codes[rows], scales[rows]
    train_n = min(rpad, max(k * train_per_cluster, 4096))
    span = _f32(max(rcount, 1)) - 1.0
    ksh = min(max((rcount + ppc - 1) // ppc, 1), k)

    def spread(count, denom):
        # the JAX package's f32 positions, divided tensor by tensor
        pos = torch.arange(count, dtype=torch.float32) * span / _f32(denom)
        return torch.round(pos).long().clamp(0, rcount - 1).to(dev)

    tpos = spread(train_n, max(train_n - 1, 1))
    tcodes, tscales = mcodes[tpos], mscales[tpos]
    ipos = spread(k, max(ksh - 1, 1))
    cent = dequantize(mcodes[ipos], mscales[ipos])
    cent[ksh:] = _DEAD_CENT
    tchunk = min(chunk, train_n)
    for _ in range(max(iters, 1)):
        cent, _ = _lloyd_iter(tcodes, tscales, cent, tchunk)
    assign = _assign_only(mcodes, mscales, cent, min(chunk, rpad))
    # split projection: one fixed random direction (build_cluster's
    # rng(11); it only has to be a consistent spatial key)
    r = np.random.default_rng(11).standard_normal(codes.shape[1]).astype(np.float32)
    proj = dequantize(mcodes, mscales) @ torch.from_numpy(r).to(dev)
    return assign, proj


def _tables_shard(codes, scales, tpad, rchunk: int, c_fan: int):
    """One shard's (nearest-cluster fan-out, representatives) for every
    member-table row; ``tpad`` i32[Kpad, smax] local ids (-1 pad). Pad
    clusters are masked out of everyone's fan-out."""
    cent, reps = _table_centroids(codes, scales, tpad, rchunk)
    return _nbr_clusters(cent, c_fan, live=(tpad >= 0).any(dim=1)), reps


def _merge_shard(adj, qflat, sel_d2, sel_ids, rows, codes, scales, slots: int,
                 rchunk: int, rows_mode: bool, heuristic: bool,
                 repair_rounds: int):
    """One shard's row map, union-prune merge, in-degree recount and the
    round-varied orphan-repair fixpoint (at most ``repair_rounds``
    rounds, one host check each). Returns (adj, indeg)."""
    pos = _sel_pos(qflat, adj.shape[0])
    if rows_mode:
        adj = _global_merge_rows(adj, pos, qflat, sel_d2, sel_ids, rows, codes,
                                 scales, slots, rchunk, heuristic)
    else:
        adj = _global_merge(adj, pos, qflat, sel_d2, sel_ids, codes, scales,
                            slots, rchunk, heuristic)
    return repair_orphans(adj, recount_indeg(adj), repair_rounds)


def sharded_cluster_layer(
    mesh,
    codes_s,
    scales_s,
    adj_s,
    counts: np.ndarray,
    levels: np.ndarray,
    layer_nb: int,
    cap: int,
    m: int,
    fanout: int = 12,
    pool_p: int = 512,
    points_per_cluster: int = 256,
    kmeans_iters: int = 4,
    smax_headroom: float = 1.75,
    batch_queries: int = 4096,
    pool_approx: bool = False,
    merge_heuristic: bool = True,
    select_alg4: bool = True,
    merge_slots: int = 0,
    exact_layers: int = 0,
    train_per_cluster: int = 8,
    repair_rounds: int = 10,
):
    """Cluster-build layer ``layer_nb`` of every shard.

    ``codes_s`` / ``scales_s`` / ``adj_s``: per-shard u8[ns, d] /
    f32[ns, 2] / i32[ns, cap] (``adj_s`` empty, rewritten in place);
    ``counts`` host i64[S] live rows per shard; ``levels`` host i32[S, ns]
    per-row levels (-1 dead). ``mesh`` is not read: each shard's tensors
    lie on its device already. Returns (adj_s, indeg_s, reps host
    i32[S, Kpad] with -1 pads: layer 0's serving pivot hints per shard,
    else None).

    ``merge_slots`` mirrors the single-index knob (0 = ``2 * cap``).
    ``exact_layers`` is accepted for ``cluster_kwargs`` compatibility and
    ignored, as in the JAX package: every layer takes the clustered
    select. ``pool_approx`` is accepted and ignored: the port's pool top-P
    is exact (the JAX package's ``approx_max_k`` is exact on its CPU
    backend).
    """
    S = len(codes_s)
    ns = codes_s[0].shape[0]
    mems = []
    for s in range(S):
        c = int(counts[s])
        mems.append(np.arange(c) if layer_nb == 0
                    else np.flatnonzero(levels[s, :c] >= layer_nb))
    rmax = max((mm.size for mm in mems), default=0)
    if rmax == 0:
        return adj_s, None, None
    rpad = -(-rmax // 8) * 8
    k = max(1, min(rpad, -(-rmax // points_per_cluster)))
    chunk = min(16384, rpad)
    smax = max(8, int(np.ceil(rpad / k * smax_headroom / 8)) * 8)
    rows_d = [torch.from_numpy(mm.astype(np.int64)).to(codes_s[s].device)
              for s, mm in enumerate(mems)]

    # phases 1 and 2: per-shard k-means, then the host split and tables
    tables, ks = [], []
    for s, mm in enumerate(mems):
        if mm.size == 0:
            tables.append(np.full((0, smax), -1, np.int32))
            ks.append(0)
            continue
        assign, proj = _prep_shard(
            codes_s[s], scales_s[s], rows_d[s], rpad, k, kmeans_iters,
            train_per_cluster, chunk, points_per_cluster)
        # the k-means ran with the global k centroids on every shard, so
        # assignments are already in [0, k); a smaller shard leaves the
        # dead ones empty, and empty rows become pad clusters
        a, ksp = _split_oversized(assign.cpu().numpy(), k, smax,
                                  keys=proj.cpu().numpy())
        t, ov = _member_tables(a, ksp, smax)
        if ov:
            raise AssertionError(f"member-table overflow ({ov}) after _split_oversized")
        tables.append(np.where(t >= 0, mm[np.clip(t, 0, mm.size - 1)], -1)
                      .astype(np.int32))
        ks.append(ksp)
    kmax = max(ks)
    rch = min(1024, max(8, 1 << max(kmax - 1, 1).bit_length()))
    kpad = -(-kmax // rch) * rch
    c_fan = min(fanout, kmax)
    g = max(1, batch_queries // smax)
    selp = min(max(pool_p, m), c_fan * smax)
    slots = merge_slots or 2 * cap
    rows_mode = layer_nb != 0
    rlim = 16384 if merge_heuristic else 65536
    rchunk = min(rlim, max(1024, 1 << max((rmax if rows_mode else ns) - 1, 1)
                           .bit_length()))

    indeg_s = []
    reps = np.full((S, kpad), -1, np.int32) if layer_nb == 0 else None
    resid = []
    for s in range(S):
        codes, scales = codes_s[s], scales_s[s]
        dev = codes.device
        if ks[s] == 0:
            indeg_s.append(torch.zeros((ns,), dtype=torch.int32, device=dev))
            resid.append(0)
            continue
        # phase 3: tables, padded to kpad rows as in the JAX stacks
        tpad = np.full((kpad, smax), -1, np.int32)
        tpad[: ks[s]] = tables[s]
        tpad_d = torch.from_numpy(tpad).to(dev)
        nbrcl, reps_d = _tables_shard(codes, scales, tpad_d, rch, c_fan)
        # phase 4: the select, one group of g clusters per step
        sels = []
        for base in range(0, ks[s], g):
            cl = np.full((g,), -1, np.int32)
            take = min(g, ks[s] - base)
            cl[:take] = np.arange(base, base + take, dtype=np.int32)
            sels.append(_cluster_sel_step_impl(
                codes, scales, tpad_d, nbrcl, torch.from_numpy(cl).to(dev), m=m,
                pool_p=selp, select_alg4=select_alg4))
        qflat = torch.cat([x[0] for x in sels])
        sel_d2 = torch.cat([x[1] for x in sels])
        sel_ids = torch.cat([x[2] for x in sels])
        del sels
        # phase 5: merge and the orphan fixpoint
        adj, indeg = _merge_shard(
            adj_s[s], qflat, sel_d2, sel_ids, rows_d[s], codes, scales,
            slots=slots, rchunk=rchunk, rows_mode=rows_mode,
            heuristic=merge_heuristic, repair_rounds=repair_rounds)
        adj_s[s] = adj
        indeg_s.append(indeg)
        resid.append(int((((adj >= 0).sum(dim=1) > 0) & (indeg == 0)).sum()))
        if reps is not None:
            r = reps_d[: ks[s]].cpu().numpy()
            reps[s, : ks[s]] = np.where(r >= 0, r, -1)
    # the fixpoint is capped at repair_rounds per shard and nothing backs
    # it up here: surface any residual orphans instead of assuming it
    # converged
    if sum(resid):
        log.warning("orphan fixpoint hit the %d-round cap on layer %d with "
                    "unreachable rows remaining per shard: %s", repair_rounds,
                    layer_nb, resid)
    return adj_s, indeg_s, reps
