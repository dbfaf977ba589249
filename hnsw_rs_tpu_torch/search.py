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

Only one entry is expanded per iteration (E=1, the reference's exact
pop-one semantics); the E>1 serving mode and the PQ and probed layouts
are not ported yet. The JAX package's ``while_loop``s are Python loops
here, with one host read of the convergence flag per iteration and the
same iteration bounds.
"""

from __future__ import annotations

import torch

from .ops.distance import l2sq
from .ops.quant import dequantize
from .ops.topk import (
    INF,
    PAD_ID,
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
               ring_size: int = 0):
    """Shared flagged-beam loop (E=1). ``fetch(cand_ids [B]) -> (nbrs
    [B, cap], vecs f32[B, cap, d])`` supplies each expanded node's
    neighbor ids and dequantized vectors. Returns the sorted beam
    ``(d2 [B, ef], ids [B, ef])``. The loop ends when every query has
    converged or after ``max_iters`` iterations (one host sync per
    iteration reads the convergence flag)."""
    b = q.shape[0]
    if ring_size <= 0:
        ring_size = max(2 * cap, 64)
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
        active = unexp.any(dim=1)
        # first unexpanded slot = best candidate (the beam is sorted)
        pos = torch.where(unexp, slot_iota, ef).amin(dim=1)
        pos = torch.where(active, pos, 0)
        cand = beam_ids.gather(1, pos[:, None])[:, 0]
        beam_exp = beam_exp | (active[:, None] & (slot_iota == pos[:, None]))

        nbrs, pay = fetch(cand.clamp(0, n - 1))
        valid = (nbrs >= 0) & active[:, None]
        if forbid is not None:
            valid = valid & (nbrs != forbid[:, None])
        nbrs_safe = torch.where(valid, nbrs, 0)
        known = (nbrs_safe[:, :, None] == beam_ids[:, None, :]).any(dim=-1) | (
            nbrs_safe[:, :, None] == ring[:, None, :]).any(dim=-1)
        new = valid & ~known
        ring = torch.cat(
            [torch.where(new, nbrs, PAD_ID), ring[:, : ring_size - cap]], dim=1)

        nd2 = torch.where(new, l2sq(q[:, None, :], pay), INF)
        nids = torch.where(new, nbrs, PAD_ID)
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
                 forbid: torch.Tensor | None = None, ring_size: int = 0):
    """Batched beam search over one layer (HNSW Algorithm 2;
    ``searcher.rs:23-103``) with plain adjacency and vector gathers.
    Returns the sorted beam ``(d2 [B, ef], ids [B, ef])``."""
    def fetch(cand_safe):
        nbrs = adj[cand_safe.long()]
        return nbrs, _gather_vecs(codes, scales, torch.where(nbrs >= 0, nbrs, 0))

    return _beam_loop(fetch, codes.shape[0], adj.shape[1], q, entry_d2,
                      entry_ids, ef, max_iters, forbid, ring_size)


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
                        forbid: torch.Tensor | None = None):
    """:func:`search_layer` over the packed-neighbor layout — the same
    semantics and distances, one row gather per expansion."""
    n, w = packed.shape
    d = q.shape[1]
    cap = w // (d + 12)

    def fetch(cand_safe):
        return unpack_rows(packed[cand_safe.long()], cap, d)

    return _beam_loop(fetch, n, cap, q, entry_d2, entry_ids, ef, max_iters,
                      forbid, ring_size)


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
                      k: int, max_iters: int):
    """Pivot-seeded serving: one product against the pivot table seeds the
    layer-0 beam over the packed rows, replacing the upper-layer descent.
    Seed distances use the expanded matmul form and the beam the
    diff-square form, so a surviving seed's d2 may differ from the packed
    path's in the last ulps. Returns (sqrt(d2) [B, k], ids [B, k])."""
    e_d2, e_ids, _ = _pivot_seeds_pos(pivot_ids, pivot_vecs, q, ef)
    beam_d2, beam_ids = search_layer_packed(packed0, q, e_d2, e_ids, ef,
                                            max_iters)
    return torch.sqrt(beam_d2[:, :k]), beam_ids[:, :k]


def ann_search_seeded_plain(adj0: torch.Tensor, codes: torch.Tensor,
                            scales: torch.Tensor, pivot_ids: torch.Tensor,
                            pivot_vecs: torch.Tensor, q: torch.Tensor,
                            ef: int, k: int, max_iters: int):
    """Pivot-seeded serving without the packed rows (plain adjacency and
    vector gathers); same results as :func:`ann_search_seeded` given the
    same seeds."""
    e_d2, e_ids, _ = _pivot_seeds_pos(pivot_ids, pivot_vecs, q, ef)
    beam_d2, beam_ids = search_layer(adj0, codes, scales, q, e_d2, e_ids, ef,
                                     max_iters)
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
                      k: int, max_iters: int):
    """:func:`ann_search` with the layer-0 beam over the packed rows
    (``adjs_upper`` = layers 1.. ordered bottom-up; the descent stays on
    plain gathers). The same results as :func:`ann_search`."""
    e_d2, e_ids = _descend(adjs_upper, codes, scales, q, ep)
    beam_d2, beam_ids = search_layer_packed(packed0, q, e_d2, e_ids, ef,
                                            max_iters)
    return torch.sqrt(beam_d2[:, :k]), beam_ids[:, :k]
