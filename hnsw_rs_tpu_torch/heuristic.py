"""Batched neighbor selection, HNSW Algorithm 4 (port of
``hnsw_rs_tpu/heuristic.py``), as the insert path uses it
(``inserter.rs:115-123``, ``extend_cands`` and ``keep_pruned`` true):

1. the candidate pool is the construction beam, extended with every
   candidate's current neighbors at their true distance to the query,
   deduplicated and sorted by (dist, id) (:func:`build_candidate_pool`,
   or :func:`build_candidate_pool_packed` over the packed rows);
2. the accept chain (:func:`_accept_from_pool`) below.

The pool is ``ef * (1 + cap)`` wide (3,168 per query at ef_cons=96,
M=16), so its distances are computed in fixed-size chunks of ids or beam
entries; the JAX package's chunk constants are kept.

Accept chain: walk a (d2, id)-sorted, deduplicated pool best-first: accept candidate
``e`` iff ``(d(e, q), id_e) < (min_s d(e, s), id_s*)`` over the already
selected ``s`` (``results.rs:69-77``), stop at ``m`` accepted; with
``keep_pruned``, backfill rejected candidates in pool order up to ``m``
(``searcher.rs:141-146``).

The chain is resolved in chunks of G candidates. Every distance the
sequential chain can need within a chunk is precomputed with two batched
products ([B, G, m] against the selected set, [B, G, G] within the
chunk); the chain then resolves with a first-passer loop of [B, G]
elementwise updates, one iteration per acceptance. The chunk loop stops
as soon as every query has ``m`` acceptances, which is exact: later
positions can be neither accepted nor backfilled.
"""

from __future__ import annotations

import torch

from .ops.distance import l2sq
from .ops.topk import INF, PAD_ID, dedup_ids, sort_dist_id
from .search import _gather_vecs, unpack_rows

_ACCEPT_CHUNK = 128  # G: chunk count vs the [B, G, G] pairwise temp
_D2_CHUNK = 256  # pool-distance tile: bounds gather temps to [B, 256, d]
_POOL_PACK_CHUNK = 8  # beam entries decoded per step: [B, 8, cap, d] temps


def _chunked_d2(codes, scales, q, ids):
    """Distances from each query to a wide id set [B, E], ``_D2_CHUNK``
    ids at a time, so the [B, E, d] gather temp never materializes."""
    b, e = ids.shape
    out = torch.empty((b, e), dtype=torch.float32, device=q.device)
    for lo in range(0, e, _D2_CHUNK):
        vecs = _gather_vecs(codes, scales, ids[:, lo:lo + _D2_CHUNK])
        out[:, lo:lo + _D2_CHUNK] = l2sq(q[:, None, :], vecs)
    return out


def _finish_pool(pool_d2, pool_ids, forbid):
    """Drop the forbidden id, deduplicate, sort by (d2, id)."""
    if forbid is not None:
        bad = pool_ids == forbid[:, None]
        pool_d2 = torch.where(bad, INF, pool_d2)
        pool_ids = torch.where(bad, PAD_ID, pool_ids)
    return sort_dist_id(*dedup_ids(pool_d2, pool_ids))


def build_candidate_pool(adj, codes, scales, q, cand_d2, cand_ids,
                         extend: bool, forbid):
    """Sorted, deduplicated candidate pool [B, C] for the heuristic: the
    beam (``cand_d2``/``cand_ids`` [B, ef]) and, with ``extend``, every
    candidate's neighbors with their true distance to ``q``
    (C = ef + ef*cap)."""
    if not extend:
        return _finish_pool(cand_d2, cand_ids, forbid)
    b, ef = cand_ids.shape
    safe = torch.where(cand_ids == PAD_ID, 0, cand_ids).clamp(0, adj.shape[0] - 1)
    nbrs = adj[safe.long()]  # [B, ef, cap]
    nvalid = ((nbrs >= 0) & (cand_ids != PAD_ID)[:, :, None]).reshape(b, -1)
    nbrs = nbrs.reshape(b, -1)
    nd2 = torch.where(nvalid, _chunked_d2(codes, scales, q,
                                          torch.where(nvalid, nbrs, 0)), INF)
    nids = torch.where(nvalid, nbrs, PAD_ID)
    return _finish_pool(torch.cat([cand_d2, nd2], 1),
                        torch.cat([cand_ids, nids], 1), forbid)


def build_candidate_pool_packed(packed, q, cand_d2, cand_ids, extend: bool,
                                forbid):
    """:func:`build_candidate_pool` over the packed-neighbor layout
    (``search.pack_layer``): one row gather per beam entry supplies its
    neighbors' ids, codes and scales, ``_POOL_PACK_CHUNK`` entries at a
    time. The same distances as the plain path (the same codes and
    scales feed the same dequantize and ``l2sq``)."""
    if not extend:
        return _finish_pool(cand_d2, cand_ids, forbid)
    b, ef = cand_ids.shape
    n, wrow = packed.shape
    d = q.shape[1]
    cap = wrow // (d + 12)
    nbrs = torch.empty((b, ef, cap), dtype=torch.int32, device=q.device)
    nd2 = torch.empty((b, ef, cap), dtype=torch.float32, device=q.device)
    for lo in range(0, ef, _POOL_PACK_CHUNK):
        ch = cand_ids[:, lo:lo + _POOL_PACK_CHUNK].clamp(0, n - 1).long()
        ids_c, vecs = unpack_rows(packed[ch], cap, d)  # [B, ech, cap(, d)]
        nbrs[:, lo:lo + _POOL_PACK_CHUNK] = ids_c
        nd2[:, lo:lo + _POOL_PACK_CHUNK] = l2sq(q[:, None, None, :], vecs)
    nvalid = ((nbrs >= 0) & (cand_ids != PAD_ID)[:, :, None]).reshape(b, -1)
    nd2 = torch.where(nvalid, nd2.reshape(b, -1), INF)
    nids = torch.where(nvalid, nbrs.reshape(b, -1), PAD_ID)
    return _finish_pool(torch.cat([cand_d2, nd2], 1),
                        torch.cat([cand_ids, nids], 1), forbid)


def select_heuristic(adj, codes, scales, q, cand_d2, cand_ids, m: int,
                     extend_cands: bool = True, keep_pruned: bool = True,
                     forbid=None):
    """Batched Algorithm-4 selection (``searcher.rs:109-153``): the
    selected neighbors of queries ``q`` [B, d] from the beam ``cand_d2``/
    ``cand_ids`` [B, ef], as (d2 [B, m], ids [B, m]) in (d2, id) order,
    (inf, PAD_ID) padded."""
    pool_d2, pool_ids = build_candidate_pool(adj, codes, scales, q, cand_d2,
                                             cand_ids, extend_cands, forbid)
    return _accept_from_pool(codes, scales, q, pool_d2, pool_ids, m,
                             keep_pruned)


def select_heuristic_packed(packed, codes, scales, q, cand_d2, cand_ids,
                            m: int, extend_cands: bool = True,
                            keep_pruned: bool = True, forbid=None):
    """:func:`select_heuristic` with the extend pool built from the packed
    rows; the same results."""
    pool_d2, pool_ids = build_candidate_pool_packed(packed, q, cand_d2,
                                                    cand_ids, extend_cands,
                                                    forbid)
    return _accept_from_pool(codes, scales, q, pool_d2, pool_ids, m,
                             keep_pruned)


def _pairwise_d2(a: torch.Tensor, an: torch.Tensor, b: torch.Tensor,
                 bn: torch.Tensor) -> torch.Tensor:
    """Batched ``max(|a|^2 + |b|^2 - 2 a.b, 0)``: [B, X, d] x [B, Y, d]."""
    ab = torch.bmm(a, b.transpose(1, 2))
    return torch.clamp_min(an[:, :, None] + bn[:, None, :] - 2.0 * ab, 0.0)


def _accept_from_pool(codes, scales, q, pool_d2, pool_ids, m: int,
                      keep_pruned: bool):
    """Resolve the accept chain over a sorted, deduplicated pool
    ``(pool_d2, pool_ids)`` [B, C] of candidates for queries ``q``
    [B, d]. Returns the selected ``(d2 [B, m], ids [B, m])`` in (d2, id)
    order, PAD-padded."""
    b, c = pool_ids.shape
    d = q.shape[1]
    dev = q.device
    g = min(_ACCEPT_CHUNK, c)
    cp = -(-c // g) * g
    pool_d2p = torch.cat([pool_d2, pool_d2.new_full((b, cp - c), INF)], 1)
    pool_idsp = torch.cat([pool_ids, pool_ids.new_full((b, cp - c), PAD_ID)], 1)

    sel_vecs = torch.zeros((b, m, d), dtype=torch.float32, device=dev)
    sel_ids = torch.full((b, m), PAD_ID, dtype=torch.int32, device=dev)
    sel_valid = torch.zeros((b, m), dtype=torch.bool, device=dev)
    nacc = torch.zeros(b, dtype=torch.int32, device=dev)
    stop = torch.full((b,), cp, dtype=torch.int32, device=dev)
    accepted = torch.zeros((b, cp), dtype=torch.bool, device=dev)
    m_iota = torch.arange(m, device=dev)[None, None, :]
    g_iota = torch.arange(g, device=dev)[None, :]

    # the sort puts PAD lanes last: chunks that are all-PAD for every query
    # are exact no-ops
    live = (pool_idsp != PAD_ID).any(dim=0).nonzero()
    valid_chunks = 0 if live.numel() == 0 else int(live[-1, 0]) // g + 1

    for ci in range(valid_chunks):
        if not bool((nacc < m).any()):
            break
        cbase = ci * g
        cd2 = pool_d2p[:, cbase:cbase + g]
        cids = pool_idsp[:, cbase:cbase + g]
        cvecs = _gather_vecs(codes, scales, torch.where(cids == PAD_ID, 0, cids))
        cvalid = cids != PAD_ID
        cnormsq = (cvecs * cvecs).sum(dim=-1)

        # (a) nearest already-selected (previous chunks) per candidate
        d2s = _pairwise_d2(cvecs, cnormsq, sel_vecs, (sel_vecs * sel_vecs).sum(-1))
        d2s = torch.where(sel_valid[:, None, :], d2s, INF)
        rm_d2 = d2s.amin(dim=-1)
        rm_id = torch.where(d2s == rm_d2[..., None], sel_ids[:, None, :],
                            PAD_ID).amin(dim=-1)
        # (b) intra-chunk pairwise distances
        pw = _pairwise_d2(cvecs, cnormsq, cvecs, cnormsq)

        def pass_mask(rm_d2, rm_id, nacc_r, taken):
            ok = (cd2 < rm_d2) | ((cd2 == rm_d2) & (cids < rm_id))
            return cvalid & ~taken & ok & (nacc_r < m)[:, None]

        # one iteration per acceptance: accept the first passer in pool
        # order and fold its pairwise row into the running nearest; a
        # candidate that failed once fails forever (the selected set only
        # grows), so re-testing the mask is exact
        taken = torch.zeros((b, g), dtype=torch.bool, device=dev)
        pm = pass_mask(rm_d2, rm_id, nacc, taken)
        while bool(pm.any()):
            has = pm.any(dim=1)
            f = torch.where(has, torch.where(pm, g_iota, g).amin(dim=1), 0)
            e_id = cids.gather(1, f[:, None])[:, 0]
            taken = taken | (pm & (g_iota == f[:, None]))
            nacc = nacc + has.to(torch.int32)
            stop = torch.where(has & (nacc == m), cbase + f.to(torch.int32), stop)
            prow = pw.gather(1, f[:, None, None].expand(b, 1, g))[:, 0]
            prow = torch.where(has[:, None], prow, INF)
            closer = prow < rm_d2
            tie = prow == rm_d2
            rm_id = torch.where(closer, e_id[:, None], torch.where(
                tie, torch.minimum(rm_id, e_id[:, None]), rm_id))
            rm_d2 = torch.where(closer, prow, rm_d2)
            pm = pass_mask(rm_d2, rm_id, nacc, taken)

        # pack this chunk's acceptances into the selected slots: slot =
        # count before the chunk + rank among the chunk's acceptances
        nacc_in = nacc - taken.sum(dim=1, dtype=torch.int32)
        slot = nacc_in[:, None] + taken.cumsum(dim=1, dtype=torch.int32) - 1
        onehot = taken[:, :, None] & (slot[:, :, None] == m_iota)
        upd = onehot.any(dim=1)
        ids_new = torch.where(onehot, cids[:, :, None], 0).sum(dim=1,
                                                               dtype=torch.int32)
        vecs_new = torch.bmm(onehot.to(torch.float32).transpose(1, 2), cvecs)
        sel_ids = torch.where(upd, ids_new, sel_ids)
        sel_vecs = torch.where(upd[:, :, None], vecs_new, sel_vecs)
        sel_valid = sel_valid | upd
        accepted[:, cbase:cbase + g] = taken
    accepted = accepted[:, :c]

    if keep_pruned:
        # processed-and-rejected candidates (before the m-th acceptance) in
        # pool order fill the remaining slots
        pos = torch.arange(c, device=dev)[None, :]
        rejected = (pool_ids != PAD_ID) & ~accepted & (pos < stop[:, None])
        rej_rank = rejected.cumsum(dim=1) - 1
        fill = torch.clamp_min(m - nacc, 0)[:, None]
        in_final = accepted | (rejected & (rej_rank < fill))
    else:
        in_final = accepted
    out_d2 = torch.where(in_final, pool_d2, INF)
    out_ids = torch.where(in_final, pool_ids, PAD_ID)
    out_d2, out_ids = sort_dist_id(out_d2, out_ids)
    return out_d2[:, :m], out_ids[:, :m]
