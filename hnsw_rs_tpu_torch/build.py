"""Index construction (port of ``hnsw_rs_tpu/build.py``): the wave
builder, the cluster-bulk branch and the connectivity backstop.

The wave builder keeps the reference's top-down layer schedule
(``HNSW::insert_bulk``, ``template.rs:388-445``) and inserts each layer's
home nodes in **waves**: every node of a wave runs the whole insertion
pipeline (greedy descent above its layer, then beam search and
``select_heuristic`` at each of its layers, ``inserter.rs:40-126``) in
lockstep against the same graph snapshot, then all of the wave's edges
are applied at once (``_apply_wave_impl``): own rows, reverse edges by a
sort-based group-by-target with a union prune to the degree cap that
never evicts a neighbor's only in-edge, and orphan repair. Wave sizes
grow geometrically (``wave_schedule``).

Where the JAX package's functional updates donate their buffers, the
port updates the adjacency, in-degree ledgers and the packed layer-0
table in place. The JAX package pads waves to a few bucket sizes to bound
XLA recompiles; padded lanes carry -1 and change nothing, so the port
runs unpadded waves. Not ported yet: the stop-layer wave insert of the
sharded builds (ROADMAP.md queue A).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .build_cluster import _mark, _orphan_fix, build_layer0_clustered, repair_orphans
from .graphs import LayeredGraph
from .heuristic import select_heuristic, select_heuristic_packed
from .ops.distance import l2sq, point_normsq
from .ops.quant import dequantize
from .ops.topk import INF, PAD_ID, SENTINEL, lex_perm
from .params import Params
from .search import (
    _gather_vecs,
    _pivot_seeds,
    comb_table,
    empty_packed,
    greedy_descent,
    pack_layer,
    search_layer,
    search_layer_packed,
    seed_entry,
)
from .store import PointStore

log = logging.getLogger(__name__)

# Packed-build gates for the CPU, the JAX package's constants (sized for a
# TPU with 7-8 GB of usable memory), kept so the parity tests take the
# same branch as the JAX package; on a CUDA device the gate is half the
# free device memory (_packed_limit). _FIX_CAP bounds the orphan-repair
# rows repacked per wave; an overflow sets a stale flag that triggers a
# full repack, checked every _STALE_CHECK_EVERY waves and at the end of
# each layer.
PACKED_BUILD_LIMIT = int(3.5 * (1 << 30))
PACKED_DEFERRED_LIMIT = int(4.0 * (1 << 30))
_FIX_CAP = 4096
_STALE_CHECK_EVERY = 16
_EX_CHUNK = 8192  # reverse-edge targets per distance step: [8192, cap, d] temps


def wave_schedule(count: int, base: int = 16, growth: float = 0.5,
                  cap: int = 4096) -> list[int]:
    """Split ``count`` home nodes into geometrically growing wave sizes:
    small waves while the layer is sparse, so early nodes see each other,
    then waves of up to ``cap`` nodes."""
    sizes = []
    done = 0
    while done < count:
        w = min(max(base, int(done * growth)), cap, count - done)
        sizes.append(w)
        done += w
    return sizes


def _packed_limit(device: torch.device, pack_lag: int) -> int:
    """Largest packed layer-0 table ``packed_build="auto"`` builds: half
    the device's free memory on a CUDA device (the rest holds the wave
    transients and a full repack), the JAX package's constants on the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0] // 2
    return PACKED_BUILD_LIMIT if pack_lag <= 1 else PACKED_DEFERRED_LIMIT


def _wave_layer_step_impl(adj, codes, scales, ids_w, entry_d2, entry_ids,
                          ef: int, m: int, max_iters: int,
                          extend_cands: bool = True, expand_e: int = 1,
                          packed=None, phase_s: dict | None = None):
    """One layer of the insertion pipeline for a whole wave
    (``inserter.rs:91-126``): beam search with ``ef`` (= ef_cons), then
    ``select_heuristic(m, extend, keep_pruned=True)``, each wave node
    forbidden to itself. With ``packed`` (the layer's packed rows, kept
    up to date by :func:`_apply_wave_impl`) the beam and the extend pool
    read one wide row per expansion; the results are the same. Returns
    the selected (d2 [W, m], ids [W, m]), also the next layer's entry.
    ``expand_e`` > 1 pops E beam entries per lockstep iteration of the
    construction search (``insert_bulk(build_expand=...)``): fewer, wider
    iterations at a held pool quality; E=1 is the reference's order.
    ``phase_s``: when a dict, the seconds of the beam and of the select
    are added to its ``wave_beam`` and ``wave_select``."""
    t0 = time.perf_counter()
    safe = ids_w.clamp(0, codes.shape[0] - 1).long()
    q = dequantize(codes[safe], scales[safe])
    if packed is not None:
        beam_d2, beam_ids = search_layer_packed(
            packed, q, entry_d2, entry_ids, ef, max_iters, expand_e=expand_e,
            forbid=ids_w)
        t0 = _mark(phase_s, "wave_beam", t0, codes.device)
        sel = select_heuristic_packed(
            packed, codes, scales, q, beam_d2, beam_ids, m,
            extend_cands=extend_cands, keep_pruned=True, forbid=ids_w)
    else:
        beam_d2, beam_ids = search_layer(adj, codes, scales, q, entry_d2,
                                         entry_ids, ef, max_iters, forbid=ids_w,
                                         expand_e=expand_e)
        t0 = _mark(phase_s, "wave_beam", t0, codes.device)
        sel = select_heuristic(adj, codes, scales, q, beam_d2, beam_ids, m,
                               extend_cands=extend_cands, keep_pruned=True,
                               forbid=ids_w)
    _mark(phase_s, "wave_select", t0, codes.device)
    return sel


def _pack_rows(comb, adj, rows, d: int):
    """Packed rows (``search.pack_layer`` layout) of ``rows`` from the
    adjacency and the combined code and scale bytes (``comb_table``)."""
    n, cap = adj.shape
    r = rows.shape[0]
    nbr = adj[rows.clamp(0, n - 1).long()]
    cs = comb[torch.where(nbr >= 0, nbr, 0).long()]  # [R, cap, d+8]
    return torch.cat([cs[..., :d].reshape(r, cap * d),
                      cs[..., d:].reshape(r, cap * 8),
                      nbr.view(torch.uint8).reshape(r, cap * 4)], dim=1)


def _prot_sort(prot, d2, ids):
    """Three-key sort along the last axis: protected first, then (d2 asc,
    id asc). Returns (d2, ids)."""
    perm = lex_perm(torch.where(prot, 0, 1), d2, ids)
    return d2.gather(-1, perm), ids.gather(-1, perm)


def _add(indeg, ids, value: int) -> None:
    ids = ids.long()
    indeg.index_add_(0, ids, torch.full_like(ids, value, dtype=indeg.dtype))


def _apply_wave_impl(adj, indeg, codes, scales, ids_w, nbr_d2, nbr_ids,
                     packed=None, comb=None, repack: bool = True,
                     set_own: bool = True, dedup: bool = False):
    """Apply one wave's connections at one layer, in place.

    ``ids_w`` int32[W] (invalid lanes < 0), ``nbr_d2``/``nbr_ids`` [W, m]
    the heuristic's selections ((inf, PAD_ID) padded), ``indeg`` int32[N]
    the layer's in-degree ledger. Returns (adj, indeg), or with
    ``packed`` (adj, indeg, packed, stale).

    1. Own rows (``set_own``): each wave node's row is its selection;
       every target gains an in-edge. ``dedup`` first releases the old
       row's in-edges and drops reverse edges a target already holds (a
       re-waved existing node); ``set_own=False`` is the cluster-bulk
       apply, whose own rows were written beforehand.
    2. Reverse edges: the (target, source, d2) triples are sorted by
       target; each target's incoming sources (at most ``2 * cap``) join
       its row, and the union is pruned to ``cap`` by (d2, id), entries
       holding a neighbor's only in-edge (``indeg <= 1``) kept first
       (``template.rs:209-238``, with the isolate protection of
       ``graph.rs:85-94``). Distances to the existing neighbors are
       recomputed, ``_EX_CHUNK`` targets at a time.
    3. Orphan repair: every connected node left with in-degree 0 is
       written into its nearest out-neighbor's worst slot.
    4. With ``packed``: the rows this wave rewrote (own rows, changed
       targets, the first ``_FIX_CAP`` repaired rows) are repacked from
       the final adjacency, in place (the JAX package rewrites the whole
       table with a gather and a select, which works around the TPU's
       slow wide-row scatter); ``stale`` is set when repaired rows beyond
       the cap were left for a full repack. ``repack=False`` (the
       deferred mode) leaves the table to the caller's periodic refresh.
    """
    n, cap = adj.shape
    w, m = nbr_ids.shape
    dev = adj.device
    nbr_ok = (nbr_ids != PAD_ID) & (ids_w >= 0)[:, None]
    own_rows = ids_w[ids_w >= 0].long()

    if set_own:
        if dedup:
            old = adj[own_rows]
            _add(indeg, old[old >= 0], -1)
        own = torch.where(nbr_ok, nbr_ids, SENTINEL)
        if m < cap:
            own = torch.cat([own, own.new_full((w, cap - m), SENTINEL)], 1)
        adj[own_rows] = own[ids_w >= 0, :cap]
        _add(indeg, nbr_ids[nbr_ok], 1)
    else:
        own_rows = own_rows[:0]

    # 2. reverse edges, grouped by target with one stable sort; the
    # per-target rows are built for the distinct targets only
    tgt = torch.where(nbr_ok, nbr_ids, n).reshape(-1)
    tgt, perm = torch.sort(tgt, stable=True)
    nv = int((tgt < n).sum())
    tgt, perm = tgt[:nv], perm[:nv]
    src = ids_w[:, None].expand(w, m).reshape(-1)[perm]
    ed2 = nbr_d2.reshape(-1)[perm]
    first = torch.ones(nv, dtype=torch.bool, device=dev)
    first[1:] = tgt[1:] != tgt[:-1]
    idx = torch.arange(nv, device=dev)
    pos = idx - torch.cummax(torch.where(first, idx, -1), dim=0).values
    grp = torch.cumsum(first, 0) - 1
    targets_u = tgt[first].long()
    u = targets_u.shape[0]
    slots = 2 * cap  # more same-target edges in one wave are dropped
    inc_ids = torch.full((u, slots), SENTINEL, dtype=torch.int32, device=dev)
    inc_d2 = torch.full((u, slots), INF, dtype=torch.float32, device=dev)
    fits = pos < slots
    inc_ids[grp[fits], pos[fits]] = src[fits]
    inc_d2[grp[fits], pos[fits]] = ed2[fits]

    ex = adj[targets_u]  # [U, cap]
    if not set_own or dedup:
        # an edge the target's row already holds is a set-insert no-op
        dup = (inc_ids[:, :, None] == torch.where(ex >= 0, ex, n)[:, None, :]).any(-1)
        inc_ids = torch.where(dup, SENTINEL, inc_ids)
        inc_d2 = torch.where(dup, INF, inc_d2)
    exd2 = torch.empty((u, cap), dtype=torch.float32, device=dev)
    for lo in range(0, u, _EX_CHUNK):
        tvec = _gather_vecs(codes, scales, targets_u[lo:lo + _EX_CHUNK])
        exvec = _gather_vecs(codes, scales, ex[lo:lo + _EX_CHUNK])
        exd2[lo:lo + _EX_CHUNK] = l2sq(tvec[:, None, :], exvec)
    exd2 = torch.where(ex >= 0, exd2, INF)
    ex_prot = (ex >= 0) & (indeg[ex.clamp(min=0).long()] <= 1)

    uni_ids = torch.cat([torch.where(ex >= 0, ex, PAD_ID),
                         torch.where(inc_ids >= 0, inc_ids, PAD_ID)], 1)
    uni_d2 = torch.cat([exd2, inc_d2], 1)
    uni_prot = torch.cat([ex_prot, torch.zeros_like(inc_ids, dtype=torch.bool)], 1)
    _, uni_ids = _prot_sort(uni_prot, uni_d2, uni_ids)
    new_rows = torch.where(uni_ids[:, :cap] == PAD_ID, SENTINEL, uni_ids[:, :cap])
    _add(indeg, ex[ex >= 0], -1)
    _add(indeg, new_rows[new_rows >= 0], 1)
    # most reverse edges lose the prune and leave the row as it was: only
    # changed rows are repacked below
    tgt_changed = (new_rows != ex).any(dim=1)
    adj[targets_u] = new_rows

    # 3. orphan repair: a new node every target pruned away, or an old
    # node whose in-edges two rows of this wave evicted together
    frow, fpos = _orphan_fix(adj, indeg, 0)
    if packed is None:
        return adj, indeg
    if not repack:
        return adj, indeg, packed, torch.zeros((), dtype=torch.bool, device=dev)

    # 4. repack the rewritten rows in place
    stale = (fpos >= _FIX_CAP).any()
    rows = torch.cat([own_rows, targets_u[tgt_changed], frow[fpos < _FIX_CAP]])
    packed.index_copy_(0, rows, _pack_rows(comb, adj, rows, codes.shape[1]))
    return adj, indeg, packed, stale


def _insert_wave_fused_impl(adjs: list, indegs: list, codes, scales, ids_w,
                            ep: int, ef: int, m: int, max_iters: int,
                            layer_nb: int, extend_cands: bool = True,
                            expand_e: int = 1, packed0=None, comb=None,
                            repack: bool = True, pivot_ids=None,
                            pivot_vecs=None, phase_s: dict | None = None):
    """One whole wave: greedy descent from the entry point down to the
    wave's home layer ``layer_nb``, then (beam search, select) at every
    layer from ``layer_nb`` down to 0, all against the pre-wave graph;
    then the applies, layer by layer, in place. ``adjs``/``indegs`` are
    the full layer stacks, layer 0 first. With ``packed0``/``comb``
    (together) layer 0 searches and pools read the packed rows and its
    apply repacks what it rewrote. With ``pivot_ids``/``pivot_vecs`` a
    layer-0 wave is seeded (``build_seeded``): every node of level >= 1
    is inserted before any layer-0 home wave, so one product against that
    skeleton hands the beam ef good seeds instead of one descent entry
    (the build-side analogue of ``search.ann_search_seeded``). Returns
    (adjs, indegs) or (adjs, indegs, packed0, stale). ``phase_s``: when a dict, the stages'
    seconds are added to its ``wave_descent``, ``wave_beam``,
    ``wave_select`` and ``wave_apply`` (the device is drained at each
    stage's end)."""
    t0 = time.perf_counter()
    safe = ids_w.clamp(0, codes.shape[0] - 1).long()
    q = dequantize(codes[safe], scales[safe])
    if pivot_vecs is not None and layer_nb == 0:
        entry_d2, entry_ids = _pivot_seeds(pivot_ids, pivot_vecs, q, ef)
    else:
        e_d2, e_ids = seed_entry(codes, scales, q, ep)
        cur_d2, cur_ids = e_d2[:, 0], e_ids[:, 0]
        for lam in range(len(adjs) - 1, layer_nb, -1):
            cur_d2, cur_ids = greedy_descent(adjs[lam], codes, scales, q,
                                             cur_d2, cur_ids, forbid=ids_w)
        entry_d2, entry_ids = cur_d2[:, None], cur_ids[:, None]
    _mark(phase_s, "wave_descent", t0, codes.device)
    results = []
    for lam in range(layer_nb, -1, -1):
        entry_d2, entry_ids = _wave_layer_step_impl(
            adjs[lam], codes, scales, ids_w, entry_d2, entry_ids, ef=ef, m=m,
            max_iters=max_iters, extend_cands=extend_cands, expand_e=expand_e,
            packed=packed0 if lam == 0 else None, phase_s=phase_s)
        results.append((lam, entry_d2, entry_ids))
    t0 = time.perf_counter()
    adjs, indegs = list(adjs), list(indegs)
    for lam, sel_d2, sel_ids in results:
        if lam == 0 and packed0 is not None:
            adjs[0], indegs[0], packed0, stale = _apply_wave_impl(
                adjs[0], indegs[0], codes, scales, ids_w, sel_d2, sel_ids,
                packed=packed0, comb=comb, repack=repack)
        else:
            adjs[lam], indegs[lam] = _apply_wave_impl(
                adjs[lam], indegs[lam], codes, scales, ids_w, sel_d2, sel_ids)
    _mark(phase_s, "wave_apply", t0, codes.device)
    if packed0 is None:
        return adjs, indegs
    return adjs, indegs, packed0, stale


def _any_bad(adj, indeg, member_mask) -> bool:
    """True iff any layer member has out-degree 0, or in-degree 0 with
    out-degree > 0."""
    outdeg = (adj >= 0).sum(dim=1)
    return bool((member_mask & ((outdeg == 0) | ((indeg == 0) & (outdeg > 0))))
                .any())


def _fill_empty_member_rows(graph: LayeredGraph, store: PointStore,
                            layer_nb: int, member: np.ndarray) -> int:
    """``select_simple`` fill for layer members whose row is empty: each
    gets its ``min(cap, |member| - 1)`` nearest members as out-neighbors
    through the tiled flat search. Returns the number of rows filled."""
    from .models.flat import _flat_search_tiled

    adj = graph.get_layer(layer_nb)
    dev = adj.device
    empty = np.zeros(len(store), bool)
    empty[member] = True
    empty &= ((adj >= 0).sum(dim=1) == 0).cpu().numpy()
    bad = np.flatnonzero(empty)
    if bad.size == 0:
        return 0
    cap = adj.shape[1]
    mem_dev = torch.from_numpy(member.astype(np.int64)).to(dev)
    mcodes, mscales = store.codes[mem_dev], store.scales[mem_dev]
    bad_dev = torch.from_numpy(bad.astype(np.int64)).to(dev)
    q = dequantize(store.codes[bad_dev], store.scales[bad_dev])
    k = min(cap + 1, int(member.size))
    _, ti = _flat_search_tiled(q, mcodes, mscales, point_normsq(mcodes, mscales), k)
    loc = ti.cpu().numpy()  # member-local indices
    rows = np.full((bad.size, cap), -1, np.int32)
    for i, x in enumerate(bad):
        ids = member[loc[i][loc[i] >= 0]]
        ids = ids[ids != x][:cap]
        rows[i, : ids.size] = ids
    adj[bad_dev] = torch.from_numpy(rows).to(dev)
    graph.set_layer(layer_nb, adj, indeg=None)
    return int(bad.size)


def repair_connectivity(graph: LayeredGraph, store: PointStore,
                        max_rounds: int = 5) -> int:
    """Enforce the reference's min-degree invariant on every layer
    (``template.rs:356-367``): members with an empty row get their nearest
    members as out-neighbors, and members with in-degree 0 are written
    into a neighbor's row. Detection and the orphan fixpoint run on the
    device; a host sweep over the layer is the last resort. Returns the
    number of repairs the host-side fills applied."""
    levels = np.asarray(store.levels)
    n = len(store)
    fixes = 0
    for layer_nb in range(len(graph)):
        member = np.flatnonzero(levels >= layer_nb)
        if member.size <= 1:
            continue
        mask = torch.from_numpy(levels >= layer_nb).to(graph.device)
        if not _any_bad(graph.get_layer(layer_nb), graph.indeg(layer_nb), mask):
            continue
        adj, indeg = repair_orphans(graph.get_layer(layer_nb),
                                    graph.indeg(layer_nb))
        graph.set_layer(layer_nb, adj, indeg)
        if not _any_bad(adj, indeg, mask):
            continue
        filled = _fill_empty_member_rows(graph, store, layer_nb, member)
        log.warning("repair_connectivity layer %d: %d empty member rows "
                    "filled on the device", layer_nb, filled)
        if filled:
            fixes += filled
            adj, indeg = repair_orphans(graph.get_layer(layer_nb),
                                        graph.indeg(layer_nb))
            graph.set_layer(layer_nb, adj, indeg)
            if not _any_bad(adj, indeg, mask):
                continue
        log.warning("repair_connectivity layer %d: falling back to the "
                    "host sweep", layer_nb)
        adj = graph.get_layer(layer_nb).cpu().numpy()
        vals = None
        changed = False
        for _ in range(max_rounds):
            outdeg = (adj[member] >= 0).sum(1)
            indeg = np.bincount(adj[adj >= 0], minlength=n)
            bad_out = member[outdeg == 0]
            bad_in = member[(indeg[member] == 0) & (outdeg > 0)]
            if bad_out.size == 0 and bad_in.size == 0:
                break
            if vals is None:
                codes = store.codes.cpu().numpy()
                scales = store.scales.cpu().numpy()
                vals = (codes[member].astype(np.float32) * scales[member, 1:2]
                        + scales[member, 0:1])
            changed = True
            for x in np.concatenate([bad_out, bad_in]):
                xi = np.searchsorted(member, x)
                d2x = np.einsum("md,md->m", vals - vals[xi], vals - vals[xi],
                                dtype=np.float32)
                d2x[xi] = np.inf
                order = member[np.argsort(d2x, kind="stable")]
                if (adj[x] >= 0).sum() == 0:  # empty row: nearest members
                    k = min(adj.shape[1], order.size)
                    adj[x, :k] = order[:k]
                    fixes += 1
                # reverse edge into the nearest member's row
                t = int(order[0])
                if x in adj[t]:
                    continue
                free = np.flatnonzero(adj[t] < 0)
                if free.size:
                    adj[t, free[0]] = x
                else:
                    evictable = np.flatnonzero(indeg[adj[t]] > 1)
                    slot = int(evictable[-1]) if evictable.size else adj.shape[1] - 1
                    adj[t, slot] = x
                fixes += 1
        if changed:
            graph.set_layer(layer_nb, torch.from_numpy(adj).to(graph.device),
                            indeg=None)
    return fixes


class PackedBuildState:
    """Carrier of the build-time packed layer-0 table through the waves.

    ``packed0`` is updated in place by every wave; ``comb`` is the
    read-only combined code and scale byte table. Staleness (the rare
    orphan-repair overflow, see :func:`_apply_wave_impl`) is OR-ed into a
    device flag so waves never wait on the host; :meth:`maybe_refresh`
    reads it at checkpoints and repacks the whole table when it is set.
    ``lag`` > 1 is the deferred mode: no per-wave repack, a full one
    every ``lag`` waves."""

    def __init__(self, packed0, comb, lag: int = 1):
        self.packed0 = packed0
        self.comb = comb
        self.lag = int(lag)
        self.dirty = 0  # waves since the table was last known fresh
        self._stale = torch.zeros((), dtype=torch.bool, device=comb.device)

    def note_stale(self, stale) -> None:
        self._stale |= stale

    def note_wave(self, graph: LayeredGraph, store: PointStore) -> None:
        """Per-wave bookkeeping of the deferred mode: refresh every lag."""
        self.dirty += 1
        if self.dirty >= self.lag:
            self.refresh(graph, store)

    def maybe_refresh(self, graph: LayeredGraph, store: PointStore) -> None:
        if self.dirty or bool(self._stale):
            self.refresh(graph, store)

    def refresh(self, graph: LayeredGraph, store: PointStore) -> None:
        n = self.packed0.shape[0]
        self.packed0 = None  # release the old table before packing anew
        self.packed0 = pack_layer(graph.get_layer(0)[:n], store.codes[:n],
                                  store.scales[:n])
        self._stale.zero_()
        self.dirty = 0


def insert_waves(graph: LayeredGraph, store: PointStore, params: Params,
                 home_ids: np.ndarray, layer_nb: int, ep: int,
                 max_iters: int, wave_base: int = 16,
                 wave_growth: float = 0.5, wave_cap: int = 4096,
                 build_expand: int = 1,
                 packed_state: PackedBuildState | None = None,
                 pivots: tuple | None = None,
                 phase_s: dict | None = None) -> None:
    """Insert ``home_ids`` (all of level ``layer_nb``) wave by wave into
    ``graph``, in place: the per-layer analogue of the thread fan-out at
    ``template.rs:403-440``. ``packed_state`` carries the packed layer-0
    table through the waves; ``pivots`` (ids, vectors) seeds layer-0
    waves; ``phase_s`` collects the waves' stage seconds
    (:func:`_insert_wave_fused_impl`)."""
    codes, scales = store.codes, store.scales
    nlayers = len(graph)
    kw = dict(ef=params.ef_cons, m=params.m, max_iters=max_iters,
              layer_nb=layer_nb, extend_cands=params.extend_cands,
              expand_e=build_expand, phase_s=phase_s)
    if pivots is not None:
        kw["pivot_ids"], kw["pivot_vecs"] = pivots
    home = torch.from_numpy(np.asarray(home_ids, np.int32)).to(store.device)
    off = 0
    for wave_i, wsize in enumerate(
            wave_schedule(len(home_ids), wave_base, wave_growth, wave_cap), 1):
        ids_w = home[off:off + wsize]
        off += wsize
        adjs = [graph.get_layer(lam) for lam in range(nlayers)]
        indegs = [graph.indeg(lam) for lam in range(nlayers)]
        if packed_state is None:
            adjs, indegs = _insert_wave_fused_impl(adjs, indegs, codes, scales,
                                                   ids_w, ep, **kw)
        else:
            adjs, indegs, packed_state.packed0, stale = _insert_wave_fused_impl(
                adjs, indegs, codes, scales, ids_w, ep, **kw,
                packed0=packed_state.packed0, comb=packed_state.comb,
                repack=packed_state.lag <= 1)
            packed_state.note_stale(stale)
        # the graph is current before a refresh reads it
        for lam in range(nlayers):
            graph.set_layer(lam, adjs[lam], indegs[lam])
        if packed_state is not None:
            if packed_state.lag > 1:
                packed_state.note_wave(graph, store)
            elif wave_i % _STALE_CHECK_EVERY == 0:
                packed_state.maybe_refresh(graph, store)
    if packed_state is not None:
        packed_state.maybe_refresh(graph, store)


def wave_projection(codes: torch.Tensor, scales: torch.Tensor) -> np.ndarray:
    """Every point's projection onto one seeded random direction
    (``default_rng(7)``), float32[N] on the host: the key ``wave_sort``
    orders a layer's home nodes by. Computed from the codes as the JAX
    package does: ``min * sum(r) + delta * (codes . r)``."""
    r = np.random.default_rng(7).standard_normal(codes.shape[1]).astype(np.float32)
    cdot = codes.to(torch.float32) @ torch.from_numpy(r).to(codes.device)
    return (scales[:, 0] * float(r.sum()) + scales[:, 1] * cdot).cpu().numpy()


def build_index(store: PointStore, params: Params, verbose: bool = False,
                max_iters: int | None = None, wave_base: int = 16,
                wave_growth: float = 0.5, wave_cap: int = 4096,
                build_expand: int = 1, packed_build: bool | str = "auto",
                pack_lag: int = 1, wave_sort: bool = False,
                build_seeded: bool = False, build_pivot_cap: int = 8192,
                cluster_build: bool = False,
                cluster_kwargs: dict | None = None,
                phase_s: dict | None = None):
    """Build the full layered graph for ``store`` (``insert_bulk``,
    ``template.rs:388-445``). Returns (graph, entry_point, packed0,
    cluster_pivots), the JAX package's tuple.

    The default is the wave builder: per layer top-down, wave-insert that
    layer's home nodes; ``max_iters`` (default ``2 * ef_cons + 16``)
    bounds each construction beam. ``packed_build`` keeps a packed
    layer-0 table (``search.pack_layer``) across the build, so layer-0
    searches and pools read one wide row per expansion; ``"auto"``
    enables it while the table fits :func:`_packed_limit`. The final
    table is returned as ``packed0`` (it is the serving pack). ``pack_lag``
    1 repacks the rewritten rows in every wave (the graph is bit-identical
    to a plain build); K > 1 repacks the whole table every K waves.

    ``build_expand`` E > 1 pops E beam entries per iteration of every
    construction search. ``wave_sort`` orders each layer's home nodes by
    a 1-D random projection, so that the lockstep waves hold spatially
    coherent queries (the beam and accept loops run to the slowest lane
    of a wave); the insertion order changes, so the graph differs from
    the input-order build. ``build_seeded`` starts the layer-0
    construction searches from ef pivot seeds out of the level >= 1
    skeleton (at most ``build_pivot_cap`` of it, an even deterministic
    subsample) instead of one greedy-descent entry.

    ``cluster_build=True`` runs the cluster-bulk builder on every layer
    instead (``build_cluster.build_layer0_clustered``, forwarding
    ``cluster_kwargs``), then the connectivity backstop; it returns the
    per-cluster representatives and no packed table.

    ``phase_s``: when a dict, build seconds per phase are added to it
    (``layer<l>``, the waves' ``wave_descent``, ``wave_beam``,
    ``wave_select`` and ``wave_apply`` summed over all layers, and
    ``connectivity`` for the wave builder)."""
    n = len(store)
    dev = store.device
    levels = store.levels
    top = int(levels.max()) if n else 0
    graph = LayeredGraph(params.m, n, dev)
    graph.ensure_level(top)
    # the entry point: the first node of the top layer (deterministic)
    ep = int(np.flatnonzero(levels == top)[0]) if n else 0

    if cluster_build:
        kw = cluster_kwargs or {}
        for layer_nb in range(top, 0, -1):
            mem = np.flatnonzero(levels >= layer_nb).astype(np.int32)
            build_layer0_clustered(graph, store, params, layer_nb=layer_nb,
                                   member_ids=mem, phase_s=phase_s, **kw)
        cluster_pivots = build_layer0_clustered(graph, store, params,
                                                phase_s=phase_s, **kw)
        t0 = time.perf_counter()
        repair_connectivity(graph, store)
        _mark(phase_s, "connectivity", t0, dev)
        return graph, ep, None, cluster_pivots

    if max_iters is None:
        max_iters = 2 * params.ef_cons + 16
    d = int(store.codes.shape[1])
    cap0 = graph.layer_cap(0)
    packed_bytes = n * cap0 * (d + 12)
    use_packed = packed_build is True or (
        packed_build == "auto"
        and 0 < packed_bytes <= _packed_limit(dev, pack_lag))
    state = PackedBuildState(empty_packed(n, cap0, d, dev),
                             comb_table(store.codes, store.scales),
                             lag=pack_lag) if use_packed else None
    proj = wave_projection(store.codes[:n], store.scales[:n]) if (
        wave_sort and n) else None
    pivots = None
    if build_seeded and top >= 1:
        piv = np.flatnonzero(levels >= 1).astype(np.int32)
        if piv.size > build_pivot_cap > 0:
            # cap the seed set: the seed stage holds [W, P] distance temps
            piv = piv[np.unique(np.linspace(0, piv.size - 1, build_pivot_cap)
                                .round().astype(np.int64))]
        if piv.size:
            piv_dev = torch.from_numpy(piv).to(dev)
            pivots = (piv_dev, dequantize(store.codes[piv_dev.long()],
                                          store.scales[piv_dev.long()]))
    for layer_nb in range(top, -1, -1):
        t0 = time.perf_counter()
        home = np.flatnonzero(levels == layer_nb).astype(np.int32)
        if proj is not None and home.size > 1:
            home = home[np.argsort(proj[home], kind="stable")]
        insert_waves(graph, store, params, home, layer_nb, ep, max_iters,
                     wave_base, wave_growth, wave_cap, build_expand,
                     packed_state=state,
                     pivots=pivots if layer_nb == 0 else None, phase_s=phase_s)
        _mark(phase_s, f"layer{layer_nb}", t0, dev)
        if verbose:
            print(f"building HNSW index: layer {layer_nb}, {home.size} nodes "
                  f"in {time.perf_counter() - t0:.2f}s", flush=True)
    t0 = time.perf_counter()
    fixes = repair_connectivity(graph, store)
    if state is not None and fixes:
        state.refresh(graph, store)  # the host repair bypassed the tracking
    _mark(phase_s, "connectivity", t0, dev)
    return graph, ep, (state.packed0 if state is not None else None), None
