"""Batched lockstep graph traversal (port of ``hnsw_rs_tpu/search.py``):
the hierarchical descent, the layer beam and the pivot-seeded layer-0
serving path.

A whole batch of queries traverses layer 0 in lockstep. Each query keeps
one sorted **flagged beam**, fixed ``ef``-wide tensors ``(d2, id,
expanded)`` in (dist asc, id asc) order; the best unexpanded entry is the
reference's ``candidates.pop_first()`` and "no unexpanded entry left" is
its termination test (``searcher.rs:35-44``). "Already known" is *in the
beam* or *in a ring of the last ``ring_size`` discovered ids*: a node once
evicted from the top-ef can never re-enter it, so a rediscovered node
costs one wasted distance row at worst.

One entry is expanded per iteration at E=1 (the reference's exact
pop-one semantics); ``expand_e`` > 1 pops the E best unexpanded entries
together, the lockstep serving mode. Beside the exact packed rows there
are the PQ-packed layout (ADC scores from a per-query table, exact
rerank at the end) and the shortlist-probe seed stage (each probed
pivot's nearest stored points enter the beam exactly scored at
iteration 0). The JAX package's ``while_loop``s are Python loops here,
with one host read of the convergence flag per iteration and the same
iteration bounds. Eager PyTorch fuses nothing, so the probe stages run
over chunks of queries (:func:`_query_chunk`) where the JAX package
relies on XLA to keep their temporaries small.
"""

from __future__ import annotations

import torch

from .ops.distance import l2sq
from .ops.pq import adc_score, adc_score16, pq_lut
from .ops.quant import dequantize
from .ops.topk import (
    INF,
    PAD_ID,
    dedup_ids,
    merge_sorted_dist_id,
    sort_dist_id,
    topk_lowest,
)


def _gather_vecs(codes: torch.Tensor, scales: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Dequantized vectors for (possibly invalid) ids; invalid rows are
    garbage and must be masked by the caller. ``codes`` may also be an
    already-dequantized float32 table (the serving cache)."""
    safe = ids.clamp(0, codes.shape[0] - 1).long()
    if codes.dtype == torch.uint8:
        return dequantize(codes[safe], scales[safe])
    return codes[safe]


def _pack_exp_id(ids: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """Pack the beam's ``expanded`` flag into the id's LSB: ``2*id + exp``
    for real ids, PAD_ID unchanged. Order-preserving under the (d2, id)
    compare because every real id in a merge is unique. Requires
    ``2*id + 1 < PAD_ID``, i.e. N < 2^30."""
    return torch.where(ids == PAD_ID, PAD_ID, 2 * ids + exp.to(torch.int32))


def _unpack_exp_id(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`_pack_exp_id`; PAD entries decode as expanded."""
    pad = packed == PAD_ID
    ids = torch.where(pad, PAD_ID, packed >> 1)
    return ids, pad | ((packed & 1) == 1)


def _row_min_dist_id(d2: torch.Tensor, ids: torch.Tensor):
    """(min d2, min id among the argmins) along the last axis: the
    (dist, id)-order minimum."""
    min_d2 = d2.amin(dim=-1)
    min_id = torch.where(d2 == min_d2[..., None], ids, PAD_ID).amin(dim=-1)
    return min_d2, min_id


def greedy_descent(adj: torch.Tensor, codes: torch.Tensor,
                   scales: torch.Tensor, q: torch.Tensor,
                   cur_d2: torch.Tensor, cur_ids: torch.Tensor,
                   forbid: torch.Tensor | None = None, max_iters: int = 128):
    """Batched ef=1 layer traversal, a strict-improvement hill climb
    (``search_layer`` with ef = 1, ``searcher.rs:23-103``): move to the
    neighbor nearest to ``q`` iff it is strictly better than the current
    node under the (dist, id) order. Used for the upper-layer descent of
    queries (``template.rs:322-324``) and inserts (``inserter.rs:70-89``).
    ``forbid`` [B]: an id never to move to (a node must not route through
    itself while it is inserted). Strict improvement cannot cycle;
    ``max_iters`` is a safety bound. Returns (cur_d2 [B], cur_ids [B])."""
    n = codes.shape[0]
    for _ in range(max_iters):
        nbrs = adj[cur_ids.clamp(0, n - 1).long()]
        valid = nbrs >= 0
        if forbid is not None:
            valid = valid & (nbrs != forbid[:, None])
        d2 = torch.where(valid, l2sq(q[:, None, :],
                                     _gather_vecs(codes, scales, nbrs)), INF)
        best_d2, best_id = _row_min_dist_id(d2, torch.where(valid, nbrs, PAD_ID))
        better = (best_d2 < cur_d2) | ((best_d2 == cur_d2) & (best_id < cur_ids))
        cur_d2 = torch.where(better, best_d2, cur_d2)
        cur_ids = torch.where(better, best_id, cur_ids)
        if not bool(better.any()):
            break
    return cur_d2, cur_ids


def init_beam(entry_d2: torch.Tensor, entry_ids: torch.Tensor, ef: int):
    """An ef-wide sorted flagged beam from entry points [B, k]. Invalid
    entries must carry (inf, PAD_ID); they start expanded so they never
    fire."""
    b, k = entry_ids.shape
    if k < ef:
        entry_d2 = torch.cat(
            [entry_d2, entry_d2.new_full((b, ef - k), INF)], dim=1)
        entry_ids = torch.cat(
            [entry_ids, entry_ids.new_full((b, ef - k), PAD_ID)], dim=1)
    d2, ids = sort_dist_id(entry_d2, entry_ids)
    d2, ids = d2[:, :ef], ids[:, :ef]
    return d2, ids, ids == PAD_ID


def _beam_loop(fetch, n: int, cap: int, q: torch.Tensor,
               entry_d2: torch.Tensor, entry_ids: torch.Tensor, ef: int,
               max_iters: int, forbid: torch.Tensor | None = None,
               ring_size: int = 0, expand_e: int = 1, scored: bool = False):
    """Shared flagged-beam loop. ``fetch(cand_ids [B]) -> (nbrs [B, cap],
    vecs f32[B, cap, d])`` supplies each expanded node's neighbor ids and
    dequantized vectors. Returns the sorted beam ``(d2 [B, ef], ids
    [B, ef])``. The loop ends when every query has converged or after
    ``max_iters`` iterations (one host sync per iteration reads the
    convergence flag).

    ``scored=True`` switches the fetch contract to ``fetch(cand_ids [B])
    -> (nbrs [B, cap], d2 f32[B, cap])``: the candidates arrive already
    scored (the PQ layout, where no candidate vector exists) and ``q``
    only gives the batch size.

    ``expand_e`` > 1 expands the E best unexpanded entries per iteration
    (``fetch`` then sees [B*E] and returns [B*E, cap] shapes). E=1 is the
    reference's exact pop-one semantics (``searcher.rs:35-44``); E>1 is a
    lockstep serving mode: the per-iteration fixed costs (sorts, launches,
    the host read) amortize over E pops, the discovered set is a superset
    of some E=1 prefix, and termination is unchanged."""
    b = q.shape[0]
    e = max(1, min(int(expand_e), ef))
    if ring_size <= 0:
        ring_size = max(2 * cap, 64, e * cap)
    beam_d2, beam_ids, beam_exp = init_beam(entry_d2, entry_ids, ef)
    k0 = entry_ids.shape[1]
    if ring_size > k0:
        ring = torch.cat(
            [entry_ids, entry_ids.new_full((b, ring_size - k0), PAD_ID)], dim=1)
    else:
        ring = entry_ids[:, :ring_size]
    slot_iota = torch.arange(ef, device=q.device)[None, :]
    for _ in range(max_iters):
        unexp = ~beam_exp
        if not bool(unexp.any()):
            break
        if e == 1:
            active = unexp.any(dim=1)
            # first unexpanded slot = best candidate (the beam is sorted)
            pos = torch.where(unexp, slot_iota, ef).amin(dim=1)
            pos = torch.where(active, pos, 0)
            cand = beam_ids.gather(1, pos[:, None])[:, 0]
            beam_exp = beam_exp | (active[:, None] & (slot_iota == pos[:, None]))
            nbrs, pay = fetch(cand.clamp(0, n - 1))
            valid = (nbrs >= 0) & active[:, None]
        else:
            # the E best unexpanded slots: sort the masked slot indices and
            # take the first E (ef = "no such slot")
            pos_e = torch.sort(torch.where(unexp, slot_iota, ef),
                               dim=-1).values[:, :e]
            act_e = pos_e < ef
            cand = beam_ids.gather(1, torch.where(act_e, pos_e, 0))  # [B, E]
            beam_exp = beam_exp | (
                slot_iota[:, None, :] == pos_e[:, :, None]).any(dim=1)
            nbrs, pay = fetch(cand.clamp(0, n - 1).reshape(-1))
            nbrs = nbrs.reshape(b, e * cap)
            pay = pay.reshape(b, e * cap) if scored else pay.reshape(b, e * cap, -1)
            valid = (nbrs >= 0) & act_e[:, :, None].expand(b, e, cap).reshape(
                b, e * cap)
        if forbid is not None:
            valid = valid & (nbrs != forbid[:, None])
        nbrs_safe = torch.where(valid, nbrs, 0)
        known = (nbrs_safe[:, :, None] == beam_ids[:, None, :]).any(dim=-1) | (
            nbrs_safe[:, :, None] == ring[:, None, :]).any(dim=-1)
        new = valid & ~known
        ring = torch.cat(
            [torch.where(new, nbrs, PAD_ID), ring[:, : ring_size - e * cap]], dim=1)

        nd2 = torch.where(new, pay if scored else l2sq(q[:, None, :], pay), INF)
        nids = torch.where(new, nbrs, PAD_ID)
        if e > 1:
            # the E expanded rows may share neighbors: dedup before the
            # merge so the beam never holds one id twice
            nd2, nids = dedup_ids(nd2, nids)
        # a new entry is unexpanded iff it is real, so its flag needs no
        # sort payload; the merge carries (d2, packed id) only
        nd2, nids = sort_dist_id(nd2, nids)
        md2, mpk = merge_sorted_dist_id(
            beam_d2, _pack_exp_id(beam_ids, beam_exp),
            nd2, _pack_exp_id(nids, nids == PAD_ID),
        )
        beam_ids, beam_exp = _unpack_exp_id(mpk[:, :ef])
        beam_d2 = md2[:, :ef]
    return beam_d2, beam_ids


def search_layer(adj: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                 q: torch.Tensor, entry_d2: torch.Tensor,
                 entry_ids: torch.Tensor, ef: int, max_iters: int,
                 forbid: torch.Tensor | None = None, ring_size: int = 0,
                 expand_e: int = 1):
    """Batched beam search over one layer (HNSW Algorithm 2;
    ``searcher.rs:23-103``) with plain adjacency and vector gathers.
    Returns the sorted beam ``(d2 [B, ef], ids [B, ef])``."""
    def fetch(cand_safe):
        nbrs = adj[cand_safe.long()]
        return nbrs, _gather_vecs(codes, scales, torch.where(nbrs >= 0, nbrs, 0))

    return _beam_loop(fetch, codes.shape[0], adj.shape[1], q, entry_d2,
                      entry_ids, ef, max_iters, forbid, ring_size, expand_e)


def pack_layer(adj: torch.Tensor, codes: torch.Tensor,
               scales: torch.Tensor) -> torch.Tensor:
    """The packed-neighbor serving layout: one u8 row per node holding its
    neighbors' codes, scales and ids, so a beam expansion is one row
    gather. Row layout (``cap*(d+12)`` bytes): ``codes u8[cap*d] | scales
    f32-bytes[cap*8] | ids i32-bytes[cap*4]``, little-endian — the same
    bytes as the JAX package's ``pack_layer``. Assembled in ~64 MB row
    chunks so the gather temps stay bounded."""
    n, cap = adj.shape
    d = codes.shape[1]
    wrow = cap * (d + 12)
    out = torch.empty((n, wrow), dtype=torch.uint8, device=adj.device)
    ch = max(1, min(n, (64 << 20) // max(wrow, 1)))
    for lo in range(0, n, ch):
        a = adj[lo:lo + ch].contiguous()
        h = a.shape[0]
        safe = torch.where(a >= 0, a, 0).long()
        out[lo:lo + h, : cap * d] = codes[safe].view(h, cap * d)
        out[lo:lo + h, cap * d : cap * (d + 8)] = (
            scales[safe].contiguous().view(torch.uint8).view(h, cap * 8))
        out[lo:lo + h, cap * (d + 8):] = a.view(torch.uint8).view(h, cap * 4)
    return out


def comb_table(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Combined per-point byte table ``u8[N, d+8]`` = ``codes ‖
    f32-bytes(scales)``: one gather fetches a point's code and scale
    bytes together (the build's incremental repack)."""
    n = codes.shape[0]
    return torch.cat([codes, scales.contiguous().view(torch.uint8).view(n, 8)],
                     dim=1)


def empty_packed(n: int, cap: int, d: int,
                 device: torch.device | str) -> torch.Tensor:
    """Packed table of an all-empty layer: id bytes 0xFF (SENTINEL),
    code and scale bytes zero (masked by the ids at decode)."""
    out = torch.zeros((n, cap * (d + 12)), dtype=torch.uint8, device=device)
    out[:, cap * (d + 8):] = 255
    return out


def unpack_rows(row: torch.Tensor, cap: int, d: int):
    """Decode packed rows (any leading shape) into (neighbor ids
    [..., cap], dequantized vectors f32[..., cap, d])."""
    lead = row.shape[:-1]
    crow = row[..., : cap * d].reshape(*lead, cap, d)
    srow = row[..., cap * d : cap * (d + 8)].contiguous().view(
        torch.float32).view(*lead, cap, 2)
    nbrs = row[..., cap * (d + 8):].contiguous().view(
        torch.int32).view(*lead, cap)
    return nbrs, dequantize(crow, srow)


def search_layer_packed(packed: torch.Tensor, q: torch.Tensor,
                        entry_d2: torch.Tensor, entry_ids: torch.Tensor,
                        ef: int, max_iters: int, ring_size: int = 0,
                        expand_e: int = 1,
                        forbid: torch.Tensor | None = None):
    """:func:`search_layer` over the packed-neighbor layout — the same
    semantics and distances (at ``expand_e=1``), one row gather per
    expansion; ``expand_e`` > 1 pops E entries per iteration."""
    n, w = packed.shape
    d = q.shape[1]
    cap = w // (d + 12)

    def fetch(cand_safe):
        return unpack_rows(packed[cand_safe.long()], cap, d)

    return _beam_loop(fetch, n, cap, q, entry_d2, entry_ids, ef, max_iters,
                      forbid, ring_size, expand_e)


def pack_layer_pq(adj: torch.Tensor, pq_codes: torch.Tensor) -> torch.Tensor:
    """PQ variant of :func:`pack_layer`: one u8 row per node holding its
    neighbors' PQ codes and ids, ``cap*(m_pq+4)`` bytes per point instead
    of ``cap*(d+12)``. Row layout ``pqcodes u8[cap*m_pq] | ids
    i32-bytes[cap*4]``, the JAX package's bytes. Distances are ADC lookups
    against the per-query table (``ops.pq.pq_lut``), so this layout
    carries no scales."""
    n, cap = adj.shape
    m_pq = pq_codes.shape[1]
    wrow = cap * (m_pq + 4)
    out = torch.empty((n, wrow), dtype=torch.uint8, device=adj.device)
    ch = max(1, min(n, (64 << 20) // max(wrow, 1)))
    for lo in range(0, n, ch):
        a = adj[lo:lo + ch].contiguous()
        h = a.shape[0]
        out[lo:lo + h, : cap * m_pq] = pq_codes[
            torch.where(a >= 0, a, 0).long()].view(h, cap * m_pq)
        out[lo:lo + h, cap * m_pq:] = a.view(torch.uint8).view(h, cap * 4)
    return out


def unpack_rows_pq(row: torch.Tensor, cap: int, m_pq: int):
    """Decode :func:`pack_layer_pq` rows (any leading shape) into
    (neighbor ids [..., cap], PQ codes u8[..., cap, m_pq])."""
    lead = row.shape[:-1]
    codes = row[..., : cap * m_pq].reshape(*lead, cap, m_pq)
    nbrs = row[..., cap * m_pq:].contiguous().view(torch.int32).view(*lead, cap)
    return nbrs, codes


def search_layer_pq(packed: torch.Tensor, lut: torch.Tensor, m_pq: int,
                    entry_d2: torch.Tensor, entry_ids: torch.Tensor, ef: int,
                    max_iters: int, ring_size: int = 0, expand_e: int = 1):
    """:func:`search_layer` over the PQ-packed layout: the traversal
    order and termination are the exact beam's, but candidate distances
    are ADC approximations read from ``lut`` (f32[B, m_sub, nv], one per
    query); no candidate vector is fetched. ``m_pq`` is the bytes per
    point in the rows. The caller rescores the final top-k exactly
    (:func:`ann_search_pq`)."""
    n, w = packed.shape
    cap = w // (m_pq + 4)
    b = lut.shape[0]
    # 16-entry tables mean nibble-packed 4-bit codes
    score = adc_score16 if lut.shape[2] == 16 else adc_score

    def fetch(cand_safe):  # [R] with R = b * e
        nbrs, codes = unpack_rows_pq(packed[cand_safe.long()], cap, m_pq)
        d2 = score(lut, codes.reshape(b, -1, m_pq))  # [b, R / b * cap]
        return nbrs, d2.reshape(nbrs.shape)

    # a scored loop never computes l2sq: q only gives the batch size
    return _beam_loop(fetch, n, cap, lut[:, :, 0], entry_d2, entry_ids, ef,
                      max_iters, None, ring_size, expand_e, scored=True)


def pq_beam(packed0: torch.Tensor, codebooks: torch.Tensor,
            pq_codes: torch.Tensor, pivot_ids: torch.Tensor,
            pivot_vecs: torch.Tensor, q: torch.Tensor, ef: int,
            max_iters: int, expand_e: int = 1,
            rot: torch.Tensor | None = None):
    """Pivot-seeded ADC beam over a PQ-packed layer 0, the head of
    :func:`ann_search_pq`. Returns the whole ADC-scored (beam_d2,
    beam_ids); callers rerank."""
    lut = pq_lut(q if rot is None else q @ rot, codebooks)  # [B, m_sub, nv]
    # seed selection uses the exact pivot table (small, dense); the seed
    # scores that enter the beam are ADC, so evictions compare like with
    # like
    _, e_ids = _pivot_seeds(pivot_ids, pivot_vecs, q, ef)
    safe = torch.where(e_ids == PAD_ID, 0, e_ids).clamp(
        0, pq_codes.shape[0] - 1).long()
    score = adc_score16 if codebooks.shape[1] == 16 else adc_score
    e_d2 = torch.where(e_ids == PAD_ID, INF, score(lut, pq_codes[safe]))
    # bytes per point in the packed rows: nibble-packed for 4-bit
    # codebooks, one byte per subspace for 8-bit
    return search_layer_pq(packed0, lut, pq_codes.shape[1], e_d2, e_ids, ef,
                           max_iters, expand_e=expand_e)


def ann_search_pq(packed0: torch.Tensor, codebooks: torch.Tensor,
                  pq_codes: torch.Tensor, pivot_ids: torch.Tensor,
                  pivot_vecs: torch.Tensor, codes: torch.Tensor,
                  scales: torch.Tensor, q: torch.Tensor, ef: int, k: int,
                  max_iters: int, rerank: int, expand_e: int = 1,
                  rot: torch.Tensor | None = None):
    """Pivot-seeded serving over the PQ-packed layout: the packed exact
    rows cost ``cap*(d+12)`` bytes per point, these ``cap*(m_pq+4)``,
    plus ``m_pq`` for the seed-score table and the exact codes kept for
    reranking.

    ``rot`` (optional f32[d, d]): the OPQ rotation the codes were trained
    under; the ADC table is then built from ``q @ rot`` while seed
    selection and the exact rerank stay in the original space.

    Pipeline: exact pivot seed selection, seeds re-scored with ADC, the
    ADC beam over the PQ rows, then an exact re-score of the top
    ``max(k, rerank)`` survivors against the u8 codes. Returns
    (sqrt(d2) [B, k], ids [B, k])."""
    _, beam_ids = pq_beam(packed0, codebooks, pq_codes, pivot_ids, pivot_vecs,
                          q, ef, max_iters, expand_e, rot)
    r = min(max(k, rerank), beam_ids.shape[1])
    cand = beam_ids[:, :r]
    csafe = torch.where(cand == PAD_ID, 0, cand).clamp(
        0, codes.shape[0] - 1).long()
    d2 = torch.empty(cand.shape, dtype=torch.float32, device=q.device)
    step = _query_chunk(q.shape[0], r * q.shape[1] * 9, q.device)
    for lo in range(0, q.shape[0], step):
        c = csafe[lo:lo + step]
        d2[lo:lo + step] = l2sq(q[lo:lo + step, None, :],
                                dequantize(codes[c], scales[c]))
    d2 = torch.where(cand == PAD_ID, INF, d2)
    sd, si = sort_dist_id(d2, cand)
    return torch.sqrt(sd[:, :k]), si[:, :k]


def _query_chunk(b: int, bytes_per_query: int, device) -> int:
    """How many queries a stage whose temporaries take ``bytes_per_query``
    each may run at once: the stage's temps are kept under 2 GiB, and on
    a CUDA device under a quarter of the free memory."""
    budget = 2 << 30
    if torch.device(device).type == "cuda":
        budget = min(budget, torch.cuda.mem_get_info(device)[0] // 4)
    return max(1, min(b, budget // max(bytes_per_query, 1)))


def _pivot_seeds(pivot_ids, pivot_vecs, q, ef):
    """Top-ef pivot seeds per query (see :func:`_pivot_seeds_pos`)."""
    e_d2, e_ids, _ = _pivot_seeds_pos(pivot_ids, pivot_vecs, q, ef)
    return e_d2, e_ids


def _pivot_seeds_pos(pivot_ids: torch.Tensor, pivot_vecs: torch.Tensor,
                     q: torch.Tensor, ef: int):
    """Top-ef pivot seeds per query: one [B, P] product and an exact
    top-ef (the JAX package's oversampled ``approx_max_k`` refined by
    ``top_k`` is exact on its CPU backend; this is the same selection).
    Returns (d2, ids, positions into the pivot table)."""
    d2p = ((q * q).sum(dim=1, keepdim=True) - 2.0 * (q @ pivot_vecs.T)
           + (pivot_vecs * pivot_vecs).sum(dim=1)[None, :])
    d2p = torch.where(pivot_ids[None, :] >= 0, d2p, INF)
    s = min(ef, pivot_ids.shape[0])
    vals, pos = topk_lowest(d2p, s)
    e_ids = pivot_ids[pos]
    real = e_ids >= 0
    e_d2 = torch.where(real, torch.clamp_min(vals, 0.0), INF)
    return e_d2, torch.where(real, e_ids, PAD_ID), pos


def ann_search_seeded(packed0: torch.Tensor, pivot_ids: torch.Tensor,
                      pivot_vecs: torch.Tensor, q: torch.Tensor, ef: int,
                      k: int, max_iters: int, expand_e: int = 1):
    """Pivot-seeded serving: one product against the pivot table seeds the
    layer-0 beam over the packed rows, replacing the upper-layer descent.
    Seed distances use the expanded matmul form and the beam the
    diff-square form, so a surviving seed's d2 may differ from the packed
    path's in the last ulps. Returns (sqrt(d2) [B, k], ids [B, k])."""
    e_d2, e_ids, _ = _pivot_seeds_pos(pivot_ids, pivot_vecs, q, ef)
    beam_d2, beam_ids = search_layer_packed(packed0, q, e_d2, e_ids, ef,
                                            max_iters, expand_e=expand_e)
    return torch.sqrt(beam_d2[:, :k]), beam_ids[:, :k]


def _top_ef_dedup_oversampled(md2: torch.Tensor, mids: torch.Tensor, ef: int):
    """Deduplicated (d2, id)-sorted survivors of a wide candidate pool:
    the 4*ef lowest entries first, then the dedup and the exact two-key
    sort over those only, instead of both at full width
    ([B, probes*T + ef]). Reducing before the dedup means duplicate ids
    (overlapping probed shortlists) crowd the oversampled pool; 4x
    oversampling hedges that. The JAX package reduces with the TPU's
    ``approx_max_k``; here the reduction is the exact
    ``ops.topk.topk_lowest``. Callers take the first ef columns."""
    s = min(4 * ef, md2.shape[1])
    if md2.shape[1] > s:
        md2, idx = topk_lowest(md2, s)
        mids = mids.gather(1, idx)
    md2, mids = dedup_ids(md2, mids)
    return sort_dist_id(md2, mids)


def _probe_seeds(score_probe, pivot_ids, pivot_vecs, q, ef: int, probes: int,
                 per_query_bytes: int):
    """The seed stage of the probed routes, over chunks of queries: pivot
    seeds, each of the ``probes`` nearest pivots' shortlist scored exactly
    by ``score_probe(q_chunk, pivot_pos [b]) -> (d2 [b, T], ids [b, T])``,
    the merged pool reduced to the ef best distinct candidates. Returns
    (d2 [B, ef'], ids [B, ef']) with ef' = min(ef, pool width)."""
    b = q.shape[0]
    step = _query_chunk(b, per_query_bytes, q.device)
    out_d2, out_ids = [], []
    for lo in range(0, b, step):
        qc = q[lo:lo + step]
        e_d2, e_ids, pos = _pivot_seeds_pos(pivot_ids, pivot_vecs, qc, ef)
        d2_parts, id_parts = [e_d2], [e_ids]
        for i in range(min(probes, pos.shape[1])):
            d2_i, ids_i = score_probe(qc, pos[:, i])
            d2_parts.append(torch.where(ids_i >= 0, d2_i, INF))
            id_parts.append(torch.where(ids_i >= 0, ids_i, PAD_ID))
        md2, mids = _top_ef_dedup_oversampled(
            torch.cat(d2_parts, dim=1), torch.cat(id_parts, dim=1), ef)
        out_d2.append(md2[:, :ef])
        out_ids.append(mids[:, :ef])
    return torch.cat(out_d2), torch.cat(out_ids)


_PROBE_CHUNK = 64  # shortlist members scored at once: a [b, 64, d] f32 temp


def _score_probe_narrow(shortlist, codes, scales, qc, pos):
    """One probe of the narrow route: the members of pivots ``pos`` [b]
    scored exactly against ``qc`` [b, d], one narrow row gather each.
    Returns (d2 [b, T], ids [b, T] with -1 pads)."""
    cand = shortlist[pos]
    safe = torch.where(cand >= 0, cand, 0).clamp(0, codes.shape[0] - 1).long()
    parts = []
    for c0 in range(0, cand.shape[1], _PROBE_CHUNK):
        c = safe[:, c0:c0 + _PROBE_CHUNK]
        parts.append(l2sq(qc[:, None, :], dequantize(codes[c], scales[c])))
    return torch.cat(parts, dim=1), cand


def _score_probe_packed(shortlist_pack, t: int, d: int, qc, pos):
    """One probe of the packed route: one wide row per query
    (``pack_layer`` layout over the shortlist), decoded and scored
    ``_PROBE_CHUNK`` members at a time. Returns (d2 [b, T], ids [b, T])."""
    rows = shortlist_pack[pos]  # [b, T*(d+12)] u8: the one gather
    parts = []
    for c0 in range(0, t, _PROBE_CHUNK):
        c1 = min(c0 + _PROBE_CHUNK, t)
        crow = rows[:, c0 * d:c1 * d].reshape(-1, c1 - c0, d)
        srow = rows[:, t * d + c0 * 8:t * d + c1 * 8].contiguous().view(
            torch.float32).view(-1, c1 - c0, 2)
        parts.append(l2sq(qc[:, None, :], dequantize(crow, srow)))
    nbrs = rows[:, t * (d + 8):].contiguous().view(torch.int32)
    return torch.cat(parts, dim=1), nbrs


def _probe_bytes_per_query(t: int, d: int, p: int, ef: int, probes: int,
                           packed: bool) -> int:
    """Temporaries of the probed seed stage per query: the gathered row
    (packed route), the dequantized chunk and its difference, the [P]
    seed distances, and the merged pool through its copies."""
    return ((t * (d + 12) if packed else 0) + min(_PROBE_CHUNK, t) * d * 9
            + p * 8 + (ef + probes * t) * 40)


def ann_search_seeded_probe(packed0: torch.Tensor, pivot_ids: torch.Tensor,
                            pivot_vecs: torch.Tensor, shortlist: torch.Tensor,
                            codes: torch.Tensor, scales: torch.Tensor,
                            q: torch.Tensor, ef: int, k: int, max_iters: int,
                            probes: int, expand_e: int = 1):
    """Pivot-seeded serving with shortlist probing, the seed stage for
    regimes where beam walks cannot reach every true neighbor in bounded
    iterations (heavy-tailed data: the misses are candidates the beam
    never walked to).

    ``shortlist`` i32[P, T]: each pivot's T nearest stored points (built
    by ``finalize(pivot_shortlist=T)``). At query time the ``probes``
    nearest pivots' shortlist members are scored exactly (one narrow row
    gather each and the dequantize-l2sq, 64 members at a time) and
    merged into the seed set: a true neighbor in any probed region's
    shortlist is in the beam from iteration 0 with its exact distance.
    The same exact (d2, id)-ordered beam follows."""
    t = shortlist.shape[1]
    md2, mids = _probe_seeds(
        lambda qc, pos: _score_probe_narrow(shortlist, codes, scales, qc, pos),
        pivot_ids, pivot_vecs, q, ef, probes,
        _probe_bytes_per_query(t, q.shape[1], pivot_ids.shape[0], ef, probes,
                               packed=False))
    beam_d2, beam_ids = search_layer_packed(packed0, q, md2, mids, ef,
                                            max_iters, expand_e=expand_e)
    return torch.sqrt(beam_d2[:, :k]), beam_ids[:, :k]


def ann_search_seeded_probe_packed(packed0: torch.Tensor,
                                   pivot_ids: torch.Tensor,
                                   pivot_vecs: torch.Tensor,
                                   shortlist_pack: torch.Tensor, t: int, d: int,
                                   q: torch.Tensor, ef: int, k: int,
                                   max_iters: int, probes: int,
                                   expand_e: int = 1):
    """:func:`ann_search_seeded_probe` over a packed shortlist table
    (``pack_layer(shortlist, codes, scales)``: the shortlist is
    adjacency-shaped i32[P, T], so the packed layout reuses the beam's
    row format). The same candidates and exact scores from ``probes``
    wide-row gathers per query instead of ``probes * T`` narrow ones."""
    md2, mids = _probe_seeds(
        lambda qc, pos: _score_probe_packed(shortlist_pack, t, d, qc, pos),
        pivot_ids, pivot_vecs, q, ef, probes,
        _probe_bytes_per_query(t, d, pivot_ids.shape[0], ef, probes,
                               packed=True))
    beam_d2, beam_ids = search_layer_packed(packed0, q, md2, mids, ef,
                                            max_iters, expand_e=expand_e)
    return torch.sqrt(beam_d2[:, :k]), beam_ids[:, :k]


def ann_search_seeded_plain(adj0: torch.Tensor, codes: torch.Tensor,
                            scales: torch.Tensor, pivot_ids: torch.Tensor,
                            pivot_vecs: torch.Tensor, q: torch.Tensor,
                            ef: int, k: int, max_iters: int,
                            expand_e: int = 1):
    """Pivot-seeded serving without the packed rows (plain adjacency and
    vector gathers); same results as :func:`ann_search_seeded` given the
    same seeds."""
    e_d2, e_ids, _ = _pivot_seeds_pos(pivot_ids, pivot_vecs, q, ef)
    beam_d2, beam_ids = search_layer(adj0, codes, scales, q, e_d2, e_ids, ef,
                                     max_iters, expand_e=expand_e)
    return torch.sqrt(beam_d2[:, :k]), beam_ids[:, :k]


def seed_entry(codes: torch.Tensor, scales: torch.Tensor, q: torch.Tensor,
               ep: int):
    """Distance of every query to the global entry point, the search seed
    (``template.rs:316-319`` / ``inserter.rs:53-68``): (d2 [B, 1],
    ids [B, 1])."""
    ep_ids = torch.full((q.shape[0],), int(ep), dtype=torch.int32,
                        device=q.device)
    d2 = l2sq(q, _gather_vecs(codes, scales, ep_ids))
    return d2[:, None], ep_ids[:, None]


def _descend(adjs_upper, codes, scales, q, ep):
    """Seed at the entry point and greedy-descend layers top..1
    (``adjs_upper`` ordered bottom-up); returns the layer-0 entry."""
    entry_d2, entry_ids = seed_entry(codes, scales, q, ep)
    cur_d2, cur_ids = entry_d2[:, 0], entry_ids[:, 0]
    for adj in reversed(adjs_upper):
        cur_d2, cur_ids = greedy_descent(adj, codes, scales, q, cur_d2, cur_ids)
    return cur_d2[:, None], cur_ids[:, None]


def ann_search(adjs, codes: torch.Tensor, scales: torch.Tensor,
               q: torch.Tensor, ep: int, ef: int, k: int, max_iters: int):
    """The full batched query pipeline (``HNSW::ann_by_vector``,
    ``template.rs:306-335``): seed at the entry point, greedy descent
    through layers top..1, a width-``ef`` beam at layer 0. ``adjs`` is
    ordered layer 0 first; ``codes`` may be the dequantized f32 table.
    Returns (sqrt(d2) [B, k], ids [B, k])."""
    e_d2, e_ids = _descend(adjs[1:], codes, scales, q, ep)
    beam_d2, beam_ids = search_layer(adjs[0], codes, scales, q, e_d2, e_ids,
                                     ef, max_iters)
    return torch.sqrt(beam_d2[:, :k]), beam_ids[:, :k]


def ann_search_packed(adjs_upper, packed0: torch.Tensor, codes: torch.Tensor,
                      scales: torch.Tensor, q: torch.Tensor, ep: int, ef: int,
                      k: int, max_iters: int, expand_e: int = 1):
    """:func:`ann_search` with the layer-0 beam over the packed rows
    (``adjs_upper`` = layers 1.. ordered bottom-up; the descent stays on
    plain gathers). The same results as :func:`ann_search` at
    ``expand_e=1``."""
    e_d2, e_ids = _descend(adjs_upper, codes, scales, q, ep)
    beam_d2, beam_ids = search_layer_packed(packed0, q, e_d2, e_ids, ef,
                                            max_iters, expand_e=expand_e)
    return torch.sqrt(beam_d2[:, :k]), beam_ids[:, :k]
