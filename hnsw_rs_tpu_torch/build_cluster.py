"""Cluster-bulk layer construction (port of ``hnsw_rs_tpu/build_cluster.py``).

Builds a layer without construction beam searches:

1. k-means over the layer's members (a few Lloyd iterations on a strided
   subsample, then one full assignment pass);
2. per-cluster dense candidate pools: each member's pool is the members
   of its cluster's ``fanout`` nearest clusters, scored with one batched
   product per group of clusters;
3. selection (the m nearest pool candidates, or the Algorithm-4 accept
   chain with ``select_alg4``), then one global apply: a sorted sweep
   resolving every reverse edge with the accept chain per row
   (:func:`_global_merge`), an in-degree recount and orphan repair.

Small upper layers (at most ``exact_layers`` members) score every member
against every other instead (:func:`_exact_sel_step_impl`). Graph quality
is recall-gated, not structure-pinned, as in the JAX package.

Random draws stay numpy with the JAX package's seeds (the strided k-means
subsample and init, the split projection), so both packages make the same
picks. Float sums that PyTorch takes in another order (the centroid
scatter-add, matrix products) can move near-ties.
"""

from __future__ import annotations

import numpy as np
import torch

from .graphs import recount_indeg
from .heuristic import _accept_from_pool
from .ops.quant import dequantize
from .ops.topk import INF, PAD_ID, lex_perm, sort_dist_id, topk_lowest
from .utils.logging import span

__all__ = ["kmeans", "build_layer0_clustered"]


def _lloyd_iter(codes, scales, cent, chunk: int):
    """One Lloyd iteration, chunked over points: returns (new centroids,
    assignment against the INPUT centroids). Assignment is argmax of
    ``x.c - |c|^2/2`` (ties -> lowest cluster id). Empty clusters keep
    their old centroid."""
    n, d = codes.shape
    k = cent.shape[0]
    half_c2 = 0.5 * (cent * cent).sum(dim=1)
    sums = torch.zeros((k, d), dtype=torch.float32, device=cent.device)
    cnts = torch.zeros(k, dtype=torch.int32, device=cent.device)
    assign = []
    for lo in range(0, n, chunk):
        vec = dequantize(codes[lo:lo + chunk], scales[lo:lo + chunk])
        a = torch.argmax(vec @ cent.T - half_c2[None, :], dim=1)
        sums.index_add_(0, a, vec)
        cnts.index_add_(0, a, torch.ones_like(a, dtype=torch.int32))
        assign.append(a.to(torch.int32))
    new_cent = torch.where((cnts > 0)[:, None],
                           sums / torch.clamp_min(cnts, 1)[:, None].to(torch.float32),
                           cent)
    return new_cent, torch.cat(assign)


def _assign_only(codes, scales, cent, chunk: int):
    """Assignment against fixed centroids, chunked; no centroid update."""
    half_c2 = 0.5 * (cent * cent).sum(dim=1)
    out = []
    for lo in range(0, codes.shape[0], chunk):
        vec = dequantize(codes[lo:lo + chunk], scales[lo:lo + chunk])
        out.append(torch.argmax(vec @ cent.T - half_c2[None, :], dim=1)
                   .to(torch.int32))
    return torch.cat(out)


def kmeans(codes, scales, k: int, iters: int = 4, chunk: int = 16384,
           train_per_cluster: int = 8):
    """Deterministic k-means: evenly spaced init, ``iters`` Lloyd
    iterations over an evenly strided training subsample of
    ``~train_per_cluster * k`` points, then one full assignment pass.
    Returns (centroids f32[K, d], assign i32[N] against the final
    centroids)."""
    n = codes.shape[0]
    dev = codes.device
    chunk = min(chunk, max(n, 1))
    train_n = min(n, max(k * train_per_cluster, 4096))
    if train_n < n:
        sel = np.linspace(0, n - 1, train_n).round().astype(np.int64)
    else:
        sel = np.arange(n, dtype=np.int64)
    tchunk = min(chunk, train_n)
    init = np.linspace(0, train_n - 1, k).round().astype(np.int64)
    sel_t = torch.from_numpy(sel).to(dev)
    tcodes, tscales = codes[sel_t], scales[sel_t]
    init_t = torch.from_numpy(init).to(dev)
    cent = dequantize(tcodes[init_t], tscales[init_t])
    for _ in range(max(iters, 1)):
        cent, _ = _lloyd_iter(tcodes, tscales, cent, tchunk)
    return cent, _assign_only(codes, scales, cent, chunk)


def _split_oversized(
    assign_np: np.ndarray, k: int, smax: int, keys: np.ndarray | None = None
):
    """Split clusters with more than ``smax`` members into pseudo-clusters
    of at most ``smax``, chunked in ``keys`` order (a 1-D projection) so
    each chunk is a coherent sub-blob. Returns (new_assign, k_total).
    A copy of the JAX package's host function."""
    counts = np.bincount(assign_np, minlength=k)
    big = np.flatnonzero(counts > smax)
    if big.size == 0:
        return assign_np, k
    new_assign = assign_np.copy()
    order = np.argsort(assign_np, kind="stable")
    starts = np.searchsorted(assign_np[order], np.arange(k))
    nxt = k
    for c in big:
        s, cnt = int(starts[c]), int(counts[c])
        ids = order[s : s + cnt]
        if keys is not None:
            ids = ids[np.argsort(keys[ids], kind="stable")]
        for off in range(smax, cnt, smax):
            new_assign[ids[off : off + smax]] = nxt
            nxt += 1
    return new_assign, nxt


def _member_tables(assign_np: np.ndarray, k: int, smax: int):
    """Host-side [K, Smax] member table (pad -1). Returns (table,
    n_overflow). A copy of the JAX package's host function."""
    order = np.argsort(assign_np, kind="stable").astype(np.int32)
    sa = assign_np[order]
    starts = np.searchsorted(sa, np.arange(k))
    cnt = np.searchsorted(sa, np.arange(k) + 1) - starts
    rank = np.arange(order.size, dtype=np.int64) - starts[sa]
    keep = rank < smax
    table = np.full((k, smax), -1, np.int32)
    table[sa[keep], rank[keep]] = order[keep]
    overflow = int(np.sum(np.maximum(cnt - smax, 0)))
    return table, overflow


def _table_centroids(codes, scales, table, rchunk: int):
    """Exact per-member-table-row centroids f32[K, d] (empty rows -> 0)
    and each row's representative: the member nearest its row centroid,
    i32[K], -1 for empty rows. Chunked over rows."""
    n = codes.shape[0]
    k2, smax = table.shape
    cents, reps = [], []
    for lo in range(0, k2, rchunk):
        rws = table[lo:lo + rchunk]
        r = rws.shape[0]
        safe = rws.clamp(0, n - 1).reshape(-1).long()
        v = dequantize(codes[safe], scales[safe]).view(r, smax, -1)
        msk = (rws >= 0)[..., None]
        s = torch.where(msk, v, 0.0).sum(dim=1)
        c = msk.sum(dim=1).to(torch.float32)
        mean = s / torch.clamp_min(c, 1.0)
        d2 = ((v - mean[:, None, :]) ** 2).sum(dim=-1)
        d2 = torch.where(msk[..., 0], d2, INF)
        pos = torch.argmin(d2, dim=1)
        cents.append(mean)
        reps.append(rws.gather(1, pos[:, None])[:, 0])
    return torch.cat(cents), torch.cat(reps)


def _nbr_clusters(cent, c_fan: int, live=None):
    """Nearest-cluster fan-out i32[K, c_fan], self exactly first, then the
    ``c_fan - 1`` nearest other clusters; clusters outside the bool[K]
    ``live`` mask (empty pad rows) are no one's neighbor. Where fewer than
    ``c_fan - 1`` live others exist (a shard with fewer clusters than the
    mesh's largest), the missing picks are -1, which the select skips.
    The JAX package takes ``top_k``'s first index among the masked ties
    there, which can repeat self and so duplicate edges in a row."""
    k = cent.shape[0]
    iota = torch.arange(k, dtype=torch.int32, device=cent.device)
    if c_fan == 1:
        return iota[:, None]
    c2 = (cent * cent).sum(dim=1)
    cd2 = torch.clamp_min(c2[:, None] + c2[None, :] - 2.0 * (cent @ cent.T), 0.0)
    if live is not None:
        cd2 = torch.where(live[None, :], cd2, INF)
    cd2.fill_diagonal_(INF)
    d2, nbr = topk_lowest(cd2, c_fan - 1)
    nbr = torch.where(torch.isinf(d2), -1, nbr)
    return torch.cat([iota[:, None], nbr.to(torch.int32)], dim=1)


def _pool_select(codes, scales, qvec, d2, cand_ids, m: int, pool_p: int,
                 select_alg4: bool):
    """Shared tail of the selection steps: top-P pool of the masked
    distances ``d2`` [..., NQ, CS] (candidate ids gathered from
    ``cand_ids`` [..., CS]), re-sorted to the (d2, id) order, then the
    m nearest or the accept chain. Returns (sel_d2, sel_ids) [T, m]."""
    p = min(max(pool_p, m), d2.shape[-1])
    vals, pos = topk_lowest(d2, p)
    lead = d2.shape[:-2]
    nq = d2.shape[-2]
    flat_pos = pos.reshape(*lead, nq * p)
    pool_ids = cand_ids.gather(-1, flat_pos).reshape(-1, p)
    pool_d2 = vals.reshape(-1, p)
    # INF lanes are underfull-pool pads: their gathered id is arbitrary
    pool_ids = torch.where(torch.isinf(pool_d2), PAD_ID, pool_ids)
    pool_d2, pool_ids = sort_dist_id(pool_d2, pool_ids)
    if select_alg4:
        return _accept_from_pool(codes, scales, qvec.reshape(-1, qvec.shape[-1]),
                                 pool_d2, pool_ids, m, keep_pruned=True)
    return pool_d2[:, :m], pool_ids[:, :m]


def _cluster_sel_step_impl(codes, scales, member, nbrcl, cl_ids, m: int,
                           pool_p: int, select_alg4: bool = True):
    """Selected neighbors for every member of ``cl_ids``' clusters.
    ``member`` i32[K, Smax] (pad -1), ``nbrcl`` i32[K, C] nearest-cluster
    ids (self first), ``cl_ids`` i32[G] this group's clusters (pad -1).
    Returns (qflat i32[G*NQ], sel_d2 [G*NQ, m], sel_ids [G*NQ, m])."""
    n = codes.shape[0]
    g = cl_ids.shape[0]
    kk, smax = member.shape
    c_fan = nbrcl.shape[1]
    cl_safe = cl_ids.clamp(0, kk - 1).long()
    qids = torch.where((cl_ids >= 0)[:, None], member[cl_safe], -1)  # [G, S]
    nb = nbrcl[cl_safe]  # [G, C]
    cand = member[nb.clamp(0, kk - 1).long()]  # [G, C, Smax]
    cand = torch.where((nb >= 0)[:, :, None], cand, -1).reshape(g, c_fan * smax)

    qsafe = qids.clamp(0, n - 1).reshape(-1).long()
    qvec = dequantize(codes[qsafe], scales[qsafe]).view(g, smax, -1)
    csafe = cand.clamp(0, n - 1).reshape(-1).long()
    cvec = dequantize(codes[csafe], scales[csafe]).view(g, c_fan * smax, -1)
    qq = (qvec * qvec).sum(dim=2)
    cc = (cvec * cvec).sum(dim=2)
    d2 = torch.clamp_min(qq[:, :, None] + cc[:, None, :]
                         - 2.0 * torch.bmm(qvec, cvec.transpose(1, 2)), 0.0)
    bad = ((cand < 0)[:, None, :] | (qids < 0)[:, :, None]
           | (cand[:, None, :] == qids[:, :, None]))  # pads and self
    d2 = torch.where(bad, INF, d2)
    sel_d2, sel_ids = _pool_select(codes, scales, qvec, d2, cand, m, pool_p,
                                   select_alg4)
    return qids.reshape(-1), sel_d2, sel_ids


def _exact_sel_step_impl(codes, scales, qids, mem_all, m: int, pool_p: int,
                         select_alg4: bool = True):
    """Exact-pool variant for small layers: every query's candidates are
    ALL layer members ``mem_all`` i32[NM_pad] (pad -1), scored against the
    query chunk ``qids`` i32[B] (pad -1) with one product. Same contract
    as :func:`_cluster_sel_step_impl`."""
    n = codes.shape[0]
    qsafe = qids.clamp(0, n - 1).long()
    qvec = dequantize(codes[qsafe], scales[qsafe])
    csafe = mem_all.clamp(0, n - 1).long()
    cvec = dequantize(codes[csafe], scales[csafe])
    qq = (qvec * qvec).sum(dim=1)
    cc = (cvec * cvec).sum(dim=1)
    d2 = torch.clamp_min(qq[:, None] + cc[None, :] - 2.0 * (qvec @ cvec.T), 0.0)
    bad = ((mem_all < 0)[None, :] | (qids < 0)[:, None]
           | (mem_all[None, :] == qids[:, None]))
    d2 = torch.where(bad, INF, d2)
    sel_d2, sel_ids = _pool_select(codes, scales, qvec, d2[None],
                                   mem_all[None], m, pool_p, select_alg4)
    return qids, sel_d2, sel_ids


def _sel_pos(qflat, n: int):
    """The row -> selection-index map ``pos`` i32[n] (-1 for rows with no
    query). Every point is the query of at most one selection row, so the
    scatter has unique targets."""
    pos = torch.full((n,), -1, dtype=torch.int32, device=qflat.device)
    ok = qflat >= 0
    pos[qflat[ok].long()] = torch.arange(
        qflat.shape[0], dtype=torch.int32, device=qflat.device)[ok]
    return pos


def _sorted_reverse_edges(qflat, sel_d2, sel_ids, n: int):
    """Every (target, d2, source) reverse edge of the selection, sorted by
    the three keys: each target's incoming edges form one contiguous run,
    best first. Invalid edges carry target ``n`` and sort last."""
    t, m = sel_ids.shape
    ok = (sel_ids != PAD_ID) & (qflat >= 0)[:, None]
    tgt = torch.where(ok, sel_ids, n).reshape(-1)
    src = qflat[:, None].expand(t, m).reshape(-1)
    ed2 = torch.where(ok, sel_d2, INF).reshape(-1)
    perm = lex_perm(tgt, ed2, src)
    return tgt[perm].contiguous(), ed2[perm], src[perm]


def _merge_rows(posc, rows, s, cnt, sel_d2, sel_ids, ed2_s, src_s, codes,
                scales, n: int, cap: int, slots: int, heuristic: bool):
    """New adjacency rows for ``rows``: the union of each row's own
    selection (through the row map ``posc``) with its first ``slots``
    incoming edges (run start ``s``, length ``cnt``), mutual selections
    deduplicated, then the accept chain over the (d2, id)-sorted union
    (or its nearest ``cap`` without ``heuristic``)."""
    t = sel_ids.shape[0]
    e = src_s.shape[0]
    iota_s = torch.arange(slots, device=codes.device)[None, :]
    psafe = posc.clamp(0, max(t - 1, 0)).long()
    raw = sel_ids[psafe]
    okc = (posc >= 0)[:, None] & (raw != PAD_ID)
    ex_ids = torch.where(okc, raw, -1)
    ex_d2 = torch.where(okc, sel_d2[psafe], INF)
    off = (s[:, None] + iota_s).clamp(0, max(e - 1, 0))
    take = iota_s < torch.clamp_max(cnt, slots)[:, None]
    inc_ids = torch.where(take, src_s[off], -1)
    inc_d2 = torch.where(take, ed2_s[off], INF)
    # a mutual selection already sits in the own row: a second copy would
    # burn a slot in every beam's top-k
    dup = (inc_ids[:, :, None]
           == torch.where(ex_ids >= 0, ex_ids, n)[:, None, :]).any(dim=-1)
    inc_ids = torch.where(dup, -1, inc_ids)
    inc_d2 = torch.where(dup, INF, inc_d2)
    uni_ids = torch.cat([torch.where(ex_ids >= 0, ex_ids, PAD_ID),
                         torch.where(inc_ids >= 0, inc_ids, PAD_ID)], dim=1)
    uni_d2, uni_ids = sort_dist_id(torch.cat([ex_d2, inc_d2], dim=1), uni_ids)
    if heuristic:
        tvec = dequantize(codes[rows], scales[rows])
        _, acc_ids = _accept_from_pool(codes, scales, tvec, uni_d2, uni_ids,
                                       cap, keep_pruned=True)
        return torch.where(acc_ids == PAD_ID, -1, acc_ids)
    return torch.where(uni_ids[:, :cap] == PAD_ID, -1, uni_ids[:, :cap])


def _global_merge(adj, pos, qflat, sel_d2, sel_ids, codes, scales,
                  slots: int, rchunk: int, heuristic: bool = True):
    """Global reverse-edge union-prune over every row of ``adj``, in
    ``rchunk`` row blocks; rewrites ``adj`` in place and returns it. The
    incoming edges past ``slots`` per row drop d2-worst first."""
    n, cap = adj.shape
    tgt_s, ed2_s, src_s = _sorted_reverse_edges(qflat, sel_d2, sel_ids, n)
    bounds = torch.searchsorted(
        tgt_s, torch.arange(n + 1, dtype=torch.int32, device=adj.device))
    for base in range(0, n, rchunk):
        hi = min(base + rchunk, n)
        rows = torch.arange(base, hi, device=adj.device)
        s = bounds[base:hi]
        new = _merge_rows(
            pos[base:hi], rows, s, bounds[base + 1:hi + 1] - s, sel_d2,
            sel_ids, ed2_s, src_s, codes, scales, n, cap, slots, heuristic)
        # a union narrower than cap (m + slots < cap) leaves the tail slots
        adj[base:hi, : new.shape[1]] = new
    return adj


def _global_merge_rows(adj, pos, qflat, sel_d2, sel_ids, rows, codes, scales,
                       slots: int, rchunk: int, heuristic: bool = True):
    """Member-subset variant of :func:`_global_merge` for upper layers:
    only ``rows`` (this layer's members, unique) are rewritten."""
    n, cap = adj.shape
    tgt_s, ed2_s, src_s = _sorted_reverse_edges(qflat, sel_d2, sel_ids, n)
    for base in range(0, rows.shape[0], rchunk):
        rc = rows[base:base + rchunk].to(torch.int32)
        s = torch.searchsorted(tgt_s, rc)
        cnt = torch.searchsorted(tgt_s, rc, right=True) - s
        rl = rc.long()
        new = _merge_rows(pos[rl], rl, s, cnt, sel_d2, sel_ids, ed2_s, src_s,
                          codes, scales, n, cap, slots, heuristic)
        adj[rl, : new.shape[1]] = new
    return adj


def _any_orphan(adj, indeg) -> bool:
    """True iff any connected node (outdeg > 0) has in-degree 0."""
    return bool((((adj >= 0).sum(dim=1) > 0) & (indeg == 0)).any())


def _orphan_fix(adj, indeg, round_: int = 0):
    """One global orphan-repair pass, in place: every connected node
    (outdeg > 0) with indeg == 0 is written into an out-neighbor's worst
    slot, ranked so colliding orphans take distinct slots. ``round_``
    picks which out-neighbor (slot ``round_``, else slot 0), so repeated
    rounds spread collisions over distinct targets. Returns the rows
    written and each one's position in the target-sorted orphan order
    (the wave builder repacks the first ``_FIX_CAP`` of them)."""
    n, cap = adj.shape
    dev = adj.device
    outdeg = (adj >= 0).sum(dim=1)
    orphan = (outdeg > 0) & (indeg == 0)
    alt = adj[:, min(round_, cap - 1)]
    tchoice = torch.where(alt >= 0, alt, adj[:, 0])
    tfix = torch.where(orphan, tchoice, n)
    all_ids = torch.arange(n, device=dev)
    tfix_s, src_s = torch.sort(tfix, stable=True)
    ffirst = torch.empty(n, dtype=torch.bool, device=dev)
    ffirst[:1] = tfix_s[:1] < n
    ffirst[1:] = (tfix_s[1:] < n) & (tfix_s[1:] != tfix_s[:-1])
    frank = all_ids - torch.cummax(torch.where(ffirst, all_ids, -1), dim=0).values
    fslot = cap - 1 - frank.clamp(0, cap - 1)
    f_ok = (tfix_s < n) & (frank < cap)
    frow, fslot, src = tfix_s[f_ok].long(), fslot[f_ok], src_s[f_ok]
    evicted = adj[frow, fslot]
    evicted = evicted[evicted >= 0].long()
    indeg.index_add_(0, evicted, torch.full_like(evicted, -1, dtype=indeg.dtype))
    adj[frow, fslot] = src.to(adj.dtype)
    indeg.index_add_(0, src, torch.ones_like(src, dtype=indeg.dtype))
    return frow, f_ok.nonzero()[:, 0]


def _orphan_repair(adj, indeg, round_: int = 0):
    """:func:`_orphan_fix`, returning the repaired (adj, indeg)."""
    _orphan_fix(adj, indeg, round_)
    return adj, indeg


def repair_orphans(adj, indeg, rounds: int = 10):
    """Iterate :func:`_orphan_repair` until no orphan is left (an eviction
    can orphan the node whose only in-edge sat in the evicted slot)."""
    for r in range(rounds):
        adj, indeg = _orphan_repair(adj, indeg, round_=r)
        if not _any_orphan(adj, indeg):
            break
    return adj, indeg


def build_layer0_clustered(
    graph,
    store,
    params,
    fanout: int = 12,
    pool_p: int = 512,
    points_per_cluster: int = 256,
    kmeans_iters: int = 4,
    smax_headroom: float = 1.75,
    batch_queries: int = 4096,
    merge_heuristic: bool = True,
    select_alg4: bool = True,
    merge_slots: int = 0,
    exact_layers: int = 65536,
    layer_nb: int = 0,
    member_ids: np.ndarray | None = None,
    phase_s: dict | None = None,
):
    """Build layer ``layer_nb`` of ``graph`` for ``member_ids`` (default:
    all points, layer 0) with the cluster-bulk pipeline; mutates ``graph``
    in place (the layer must be empty). Returns the per-cluster
    representatives (the serving pivots) for layer 0, else None.

    ``merge_slots`` (0 = ``2 * cap``): incoming reverse-edge slots per row
    in the merge union. ``exact_layers``: upper layers with at most this
    many members take the all-members exact pool. ``phase_s``: when a
    dict, seconds per phase (kmeans, tables, select, merge, repair;
    prefixed ``upper_`` above layer 0) are added to it; the caller has
    drained the device before the call."""
    n = len(store)
    if n == 0:
        return None
    dev = store.device
    pre = "" if layer_nb == 0 else "upper_"
    codes, scales = store.codes, store.scales
    if member_ids is None:
        nm = n
        mem = None
    else:
        mem = np.asarray(member_ids, np.int32)
        nm = mem.size
        if nm == 0:
            return None
    adj = graph.get_layer(layer_nb)
    m = params.m
    cap = graph.layer_cap(layer_nb)
    reps = None

    if mem is not None and layer_nb > 0 and nm <= exact_layers:
        with span("hnsw.build.select", phase_s, dev, key=pre + "select",
                  layer=layer_nb):
            nm_pad = max(256, 1 << (nm - 1).bit_length())
            mem_pad = np.full((nm_pad,), -1, np.int32)
            mem_pad[:nm] = mem
            mem_all = torch.from_numpy(mem_pad).to(dev)
            bq = min(batch_queries, nm_pad)
            sels = []
            for base in range(0, nm, bq):
                qc = np.full((bq,), -1, np.int32)
                take = min(bq, nm - base)
                qc[:take] = mem[base : base + take]
                sels.append(_exact_sel_step_impl(
                    codes, scales, torch.from_numpy(qc).to(dev), mem_all,
                    m=m, pool_p=pool_p, select_alg4=select_alg4,
                ))
    else:
        with span("hnsw.build.kmeans", phase_s, dev, key=pre + "kmeans",
                  layer=layer_nb):
            if mem is None:
                mcodes, mscales = codes, scales
            else:
                mem_dev = torch.from_numpy(mem.astype(np.int64)).to(dev)
                mcodes, mscales = codes[mem_dev], scales[mem_dev]
            k = max(1, min(nm, -(-nm // points_per_cluster)))
            _, assign = kmeans(mcodes, mscales, k, iters=kmeans_iters)

        with span("hnsw.build.tables", phase_s, dev, key=pre + "tables",
                  layer=layer_nb):
            smax = max(8, int(np.ceil(nm / k * smax_headroom / 8)) * 8)
            # spatial key for chunking oversized clusters: one random
            # projection with the JAX package's seed
            r = np.random.default_rng(11).standard_normal(
                mcodes.shape[1]).astype(np.float32)
            proj = (dequantize(mcodes, mscales)
                    @ torch.from_numpy(r).to(dev)).cpu().numpy()
            assign_np, k = _split_oversized(assign.cpu().numpy(), k, smax,
                                            keys=proj)
            table, overflow = _member_tables(assign_np, k, smax)
            if overflow:
                raise AssertionError(
                    f"member-table overflow ({overflow}) after _split_oversized")
            if mem is not None:
                # member tables hold member-local positions: map to global ids
                table = np.where(table >= 0, mem[np.clip(table, 0, nm - 1)], -1)
            member_dev = torch.from_numpy(table).to(dev)
            # exact per-row centroids after the split (Lloyd centroids are
            # stale for pseudo-clusters, and identical siblings would tie)
            rch = min(1024, max(8, 1 << max(k - 1, 1).bit_length()))
            cent, reps_dev = _table_centroids(codes, scales, member_dev, rch)
            nbrcl = _nbr_clusters(cent, min(fanout, k))

        with span("hnsw.build.select", phase_s, dev, key=pre + "select",
                  layer=layer_nb):
            g = max(1, batch_queries // smax)
            sels = []
            for base in range(0, k, g):
                cl = np.full((g,), -1, np.int32)
                take = min(g, k - base)
                cl[:take] = np.arange(base, base + take, dtype=np.int32)
                sels.append(_cluster_sel_step_impl(
                    codes, scales, member_dev, nbrcl,
                    torch.from_numpy(cl).to(dev),
                    m=m, pool_p=pool_p, select_alg4=select_alg4,
                ))
            if layer_nb == 0:
                reps = reps_dev.cpu().numpy()
                reps = reps[reps >= 0].astype(np.int32)

    with span("hnsw.build.merge", phase_s, dev, key=pre + "merge",
              layer=layer_nb):
        qflat = torch.cat([s[0] for s in sels])
        sel_d2 = torch.cat([s[1] for s in sels])
        sel_ids = torch.cat([s[2] for s in sels])
        del sels
        pos = _sel_pos(qflat, n)

        # the accept-chain union keeps its per-chunk [R, C, d] gather temps
        # bounded through a smaller row chunk
        rlim = 16384 if merge_heuristic else 65536
        slots = merge_slots or 2 * cap
        if mem is None:
            rchunk = min(rlim, max(1024, 1 << (n - 1).bit_length()))
            adj = _global_merge(adj, pos, qflat, sel_d2, sel_ids, codes,
                                scales, slots=slots, rchunk=rchunk,
                                heuristic=merge_heuristic)
        else:
            rchunk = min(rlim, max(1024, 1 << (nm - 1).bit_length()))
            adj = _global_merge_rows(adj, pos, qflat, sel_d2, sel_ids,
                                     torch.from_numpy(mem).to(dev), codes,
                                     scales, slots=slots, rchunk=rchunk,
                                     heuristic=merge_heuristic)
    with span("hnsw.build.repair", phase_s, dev, key=pre + "repair",
              layer=layer_nb):
        adj, indeg = repair_orphans(adj, recount_indeg(adj))
        graph.set_layer(layer_nb, adj, indeg)
    return reps
