"""Sharded HNSW (port of ``hnsw_rs_tpu/parallel/sharded.py``): one
sub-graph per shard and a top-k merge over the shards.

The memory scale-out path (SURVEY.md §2.6, BASELINE.json configs 4-5):
the collection is partitioned into contiguous shards, each shard builds
an independent HNSW sub-graph over its slice, and a query fans out to
every shard — the same lockstep beam search on each sub-index — after
which the per-shard top-k candidates are merged: concatenated in shard
order and sorted by (dist, id). The reference has no analogue (single
process, ``hnsw/src/template.rs:422-439``). After :meth:`ShardedHNSW.finalize`
a shard serves as a finalized ``HNSW`` does: pivot-seeded over packed
rows, or with ``pivot_shortlist`` through the probed route
(``search.ann_search_seeded_probe_packed``); ``serving_route()`` names
the branch.

Fan-out. A query's slices are copied to every shard's device first (a
cross-device copy runs on the source device's stream, so one issued after
shard 0's search would wait for it), then the shards' searches are issued
in turn from the calling thread, and nothing reads the device back until
the merge has been issued. The cards still take turns where a shard's
search issues more kernels than its card's launch queue holds: the host
blocks on that queue and reaches the next card only when most of the
shard's work has run (one host thread a card is slower still: the
threads hand the GIL to each other at every operation).

Layout. The JAX package stacks every shard's state on a leading
``[S, ns, ...]`` axis and runs each step as one ``shard_map`` program. The
port keeps one tensor per shard on that shard's mesh device (a device may
repeat: eight shards on one card is the normal case) and runs each step
as a loop over the shards. Every shard is padded to the same row count
``ns``, as in the JAX stacks, so ``save`` writes the JAX package's
``hnsw_rs_tpu.sharded.v1`` arrays and either package loads what the
other saved. ``parallel.multihost`` is the form with one process per
shard.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..build import _insert_wave_fused_impl, wave_schedule
from ..build_cluster import _orphan_fix
from ..models.hnsw import HNSW, _build_shortlist
from ..ops.cover import _kcenter
from ..ops.quant import dequantize, quantize
from ..ops.topk import PAD_ID, sort_dist_id
from ..params import Params
from ..search import (ann_search, ann_search_seeded,
                      ann_search_seeded_probe_packed, pack_layer)
from ..store import sample_levels
from ..utils.logging import count, span
from .mesh import Mesh

FORMAT = "hnsw_rs_tpu.sharded.v1"


def _global_ids(ids, gids):
    """Map local row ids to global ids through the shard's owner table."""
    safe = ids.clamp(0, gids.shape[0] - 1).long()
    return torch.where(ids == PAD_ID, PAD_ID, gids[safe])


def _local_search(adjs, codes, scales, gids, ep, q, ef, k, max_iters):
    """One shard's search: local beam search, then map local row ids to
    global ids through the shard's owner table."""
    d, ids = ann_search(adjs, codes, scales, q, ep, ef, k, max_iters)
    return d, _global_ids(ids, gids)


def merge_topk(parts, k: int, device):
    """The per-shard top-k merge: every shard's (d, global id) block
    concatenated in shard order on ``device``, then one (dist, id)
    sort."""
    d = torch.cat([p[0].to(device) for p in parts], dim=1)
    i = torch.cat([p[1].to(device) for p in parts], dim=1)
    md, mi = sort_dist_id(d, i)
    return md[:, :k], mi[:, :k]


def _per_row(mesh: Mesh, q, k: int, search_shard):
    """Split ``q`` over the mesh's data rows; in row ``r`` every shard
    ``s`` answers the row's slice on device ``mesh.devices[r, s]``
    (``search_shard(s, dev, q_slice)``), and the results are merged on
    ``q``'s device and concatenated in batch order.

    Every slice is on its device before any search is issued (the
    module's fan-out note). Spans: ``hnsw.sharded.shard`` (field
    ``shard``, on the shard's device) around each search,
    ``hnsw.sharded.merge`` (on ``q``'s device) around the copies back and
    the merges; counter ``sharded.shards_searched``."""
    rows = [(r, [qr.to(dev) for dev in mesh.devices[r]])
            for r, qr in enumerate(torch.tensor_split(q, mesh.devices.shape[0]))
            if qr.shape[0]]
    parts = []
    for r, qs in rows:
        parts.append([])
        for s, qr in enumerate(qs):
            with span("hnsw.sharded.shard", device=mesh.devices[r, s], shard=s):
                parts[-1].append(search_shard(s, mesh.devices[r, s], qr))
                count("sharded.shards_searched")
    with span("hnsw.sharded.merge", device=q.device):
        merged = [merge_topk(p, k, q.device) for p in parts]
    return torch.cat([m[0] for m in merged]), torch.cat([m[1] for m in merged])


def sharded_query(mesh: Mesh, adjs_s, codes_s, scales_s, gids_s, eps_s, q,
                  ef: int, k: int, max_iters: int):
    """Mesh-wide batched query over per-shard state.

    ``adjs_s`` is a tuple over layers (layer 0 first) of per-shard
    int32[ns, cap] tensors; ``codes_s``, ``scales_s``, ``gids_s`` are
    per-shard tensors and ``eps_s`` the per-shard entry points. Each shard
    searches its sub-index, then the shards' top-k are merged. Returns
    (distances [B, k], global ids [B, k]) on ``q``'s device."""

    def one(s, dev, qr):
        return _local_search([a[s].to(dev) for a in adjs_s], codes_s[s].to(dev),
                             scales_s[s].to(dev), gids_s[s].to(dev),
                             int(eps_s[s]), qr, ef, k, max_iters)

    return _per_row(mesh, q, k, one)


def sharded_query_seeded(mesh: Mesh, packed_s, pivot_ids_s, pivot_vecs_s,
                         gids_s, q, ef: int, k: int, max_iters: int,
                         expand_e: int = 1):
    """Mesh-wide pivot-seeded query over per-shard packed layouts: every
    shard runs one product against its pivot skeleton, seeds its local
    layer-0 beam over its packed rows (``search.ann_search_seeded``), and
    the shards' top-k are merged as in :func:`sharded_query`.

    ``packed_s`` u8[ns, cap*(d+12)] per shard; ``pivot_ids_s`` i32[P]
    (pad -1); ``pivot_vecs_s`` f32[P, d]. The seed product is taken in
    float32 (the JAX package's ``Precision.HIGHEST``) and its top-ef is
    exact where the JAX package calls ``approx_max_k(recall_target=0.95)``:
    that is exact on the JAX CPU backend, so CPU parity is id for id, and
    a TPU run may differ. Returns global-id (sqrt distance, id) top-k."""

    def one(s, dev, qr):
        d, ids = ann_search_seeded(packed_s[s].to(dev), pivot_ids_s[s].to(dev),
                                   pivot_vecs_s[s].to(dev), qr, ef, k,
                                   max_iters, expand_e)
        return d, _global_ids(ids, gids_s[s].to(dev))

    return _per_row(mesh, q, k, one)


def sharded_query_probe_packed(mesh: Mesh, packed_s, pivot_ids_s, pivot_vecs_s,
                               shortlist_pack_s, t: int, gids_s, q, ef: int,
                               k: int, max_iters: int, probes: int,
                               expand_e: int = 1):
    """Mesh-wide probed query: every shard seeds from its pivots, scores
    the ``probes`` nearest pivots' shortlists exactly and walks its local
    layer-0 beam over its packed rows
    (``search.ann_search_seeded_probe_packed``, a finalized ``HNSW``'s
    ``probe_packed`` route), and the shards' top-k are merged as in
    :func:`sharded_query`. ``shortlist_pack_s`` u8[P, t*(d+12)] per shard:
    ``pack_layer`` over the shard's pivot shortlists (local ids). Returns
    global-id (sqrt distance, id) top-k."""
    d = q.shape[1]

    def one(s, dev, qr):
        dist, ids = ann_search_seeded_probe_packed(
            packed_s[s].to(dev), pivot_ids_s[s].to(dev), pivot_vecs_s[s].to(dev),
            shortlist_pack_s[s].to(dev), t, d, qr, ef, k, max_iters, probes,
            expand_e)
        return dist, _global_ids(ids, gids_s[s].to(dev))

    return _per_row(mesh, q, k, one)


def sharded_wave_step(mesh: Mesh, adjs_s, indegs_s, codes_s, scales_s,
                      ids_w_s, eps_s, *, ef: int, m: int, max_iters: int,
                      layer_nb: int = 0, extend_cands: bool = True,
                      dedup: bool = False) -> None:
    """One wave of sharded bulk construction: every shard runs the whole
    fused insertion wave (``build._insert_wave_fused_impl``: greedy
    descent above the home layer, per-layer beam search, select, apply)
    on its own sub-graph — the multi-chip form of the reference's
    per-layer thread fan-out (``hnsw/src/template.rs:403-440``).

    ``adjs_s``/``indegs_s``: tuples (layer 0 first) of per-shard lists,
    updated in place; ``ids_w_s``: each shard's wave (local row ids, any
    length, possibly empty) on the shard's device. A shard whose wave is
    empty runs only the apply's orphan repair, as the JAX program does on
    its all-pad lanes."""
    for s, ids_w in enumerate(ids_w_s):
        adjs = [a[s] for a in adjs_s]
        indegs = [d[s] for d in indegs_s]
        if ids_w.numel() == 0:
            for lam in range(layer_nb, -1, -1):
                _orphan_fix(adjs[lam], indegs[lam], 0)
            continue
        adjs, indegs = _insert_wave_fused_impl(
            adjs, indegs, codes_s[s], scales_s[s], ids_w, int(eps_s[s]), ef=ef,
            m=m, max_iters=max_iters, layer_nb=layer_nb,
            extend_cands=extend_cands, dedup=dedup)
        for lam in range(len(adjs)):
            adjs_s[lam][s], indegs_s[lam][s] = adjs[lam], indegs[lam]


def _grow(t: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``t`` with ``rows`` more rows of ``fill`` at its end."""
    return torch.cat([t, t.new_full((rows,) + tuple(t.shape[1:]), fill)])


class ShardedHNSW:
    """HNSW over a device mesh: one sub-index per shard, shard ``s`` on
    ``mesh.shard_devices[s]``."""

    def __init__(self, m: int, dim: int, n_shards: int,
                 ef_cons: int | None = None, *, mesh: Mesh):
        self.params = (Params.from_m_efcons(m, ef_cons, dim) if ef_cons
                       else Params.from_m(m, dim))
        self.n_shards = int(n_shards)
        if mesh.devices.shape[1] != self.n_shards:
            raise ValueError(f"the mesh has {mesh.devices.shape[1]} shard "
                             f"columns, not {self.n_shards}")
        self.mesh = mesh
        self.shards: list[HNSW] = []
        # per-shard state: codes, scales, gids (lists of tensors, one per
        # shard, each padded to ns rows), eps (host int32[S]) and adjs (a
        # tuple over layers of per-shard lists)
        self._stacked = None
        self._levels = None  # host i32[S, ns] per-shard point levels
        self._counts = None  # host i64[S] live points per shard
        self._offsets = np.zeros(0, np.int64)  # global id of each shard's row 0
        self._level_calls = 0  # deterministic level-stream position
        # packed + pivot-seeded serving state (finalize()); _pack_n tracks
        # freshness like HNSW._packed_n — any add() invalidates it
        self._packed = None
        self._pack_n = -1
        self.serve_expand = 1
        # per-shard pivot shortlists (finalize(pivot_shortlist=T)): (i32[P, T]
        # local ids, their pack_layer rows) per shard, or None; made and
        # gone stale with _packed. serve_probes = pivots probed per query
        self._shortlist = None
        self.serve_probes = 16
        # per-shard cluster-representative pivot hints (LOCAL row ids,
        # [S, K] -1-padded) from the concurrent cluster build; finalize
        # seeds from them first, like HNSW._cluster_pivots
        self._cluster_reps = None

    def __len__(self) -> int:
        if self._counts is not None:
            return int(self._counts.sum())
        return sum(len(s) for s in self.shards)

    def _dev(self, s: int) -> torch.device:
        return self.mesh.shard_devices[s]

    # -- build -------------------------------------------------------------

    def insert_bulk(self, vectors, verbose: bool = False,
                    concurrent: bool = True, partition_bounds=None,
                    **build_kwargs) -> "ShardedHNSW":
        """Partition contiguously and build every shard's sub-index.

        ``partition_bounds`` (optional, S+1 ascending ints) overrides the
        even split: caller-directed placement, the main producer of the
        load imbalance :meth:`rebalance` repairs.

        ``concurrent=True`` (default): the shards build together, each
        wave one :func:`sharded_wave_step` over every shard.
        ``concurrent=False`` builds the shards one by one with the
        single-index builder (the cross-check path). ``cluster_build=True``
        with ``concurrent=True`` runs the cluster-bulk builder for every
        shard (``parallel.sharded_cluster``); other ``build_kwargs`` go to
        the per-shard builder and force the sequential path.

        Calling this on a built object replaces the index with a fresh
        build over ``vectors``."""
        vectors = np.asarray(vectors, np.float32)
        self.shards = []
        self._stacked = None
        self._packed = self._shortlist = None
        self._pack_n = -1
        self._cluster_reps = None
        n = vectors.shape[0]
        if partition_bounds is None:
            bounds = np.linspace(0, n, self.n_shards + 1).astype(int)
        else:
            bounds = np.asarray(partition_bounds, int)
            if (bounds.shape != (self.n_shards + 1,) or bounds[0] != 0
                    or bounds[-1] != n or np.any(np.diff(bounds) < 0)):
                raise ValueError(
                    "partition_bounds must be S+1 ascending ints from 0 to n")
        self._offsets = bounds[:-1].astype(np.int64)
        if concurrent and build_kwargs.pop("cluster_build", False):
            cluster_kwargs = build_kwargs.pop("cluster_kwargs", None) or {}
            if build_kwargs:
                # validate before the expensive build: a typo'd kwarg must
                # not cost a full build and leave a built object
                raise TypeError("unsupported kwargs with concurrent cluster "
                                f"build: {sorted(build_kwargs)}")
            self._build_concurrent_cluster(vectors, bounds, cluster_kwargs)
            return self
        if build_kwargs:
            concurrent = False
        if not concurrent:
            for s in range(self.n_shards):
                sub = HNSW(self.params.m, self.params.ef_cons, self.params.dim,
                           device=self._dev(s))
                sub.insert_bulk(vectors[bounds[s]:bounds[s + 1]], verbose=verbose,
                                **build_kwargs)
                self.shards.append(sub)
            self._stack()
            return self
        self._build_concurrent(vectors, bounds)
        return self

    def _fresh_shards(self, vectors: np.ndarray, bounds: np.ndarray) -> int:
        """Quantize every shard's slice onto its device, draw its levels
        (``sample_levels(k, ml, seed=s)``) and entry point (the first row
        at the top level); sets ``_stacked`` without layers, ``_levels``
        and ``_counts``. Returns the padded row count ns."""
        S = self.n_shards
        p = self.params
        ns = int(np.diff(bounds).max())
        self._levels = np.full((S, ns), -1, np.int32)
        eps = np.zeros((S,), np.int32)
        codes, scales, gids = [], [], []
        for s in range(S):
            k = int(bounds[s + 1] - bounds[s])
            dev = self._dev(s)
            c = torch.zeros((ns, p.dim), dtype=torch.uint8, device=dev)
            sc = torch.zeros((ns, 2), dtype=torch.float32, device=dev)
            g = torch.full((ns,), -1, dtype=torch.int32, device=dev)
            if k:
                c[:k], sc[:k] = quantize(torch.from_numpy(
                    vectors[bounds[s]:bounds[s + 1]]).to(dev))
                g[:k] = torch.arange(int(self._offsets[s]), int(self._offsets[s]) + k,
                                     dtype=torch.int32, device=dev)
                lv = sample_levels(k, p.ml, seed=s)
                self._levels[s, :k] = lv
                eps[s] = int(np.flatnonzero(lv == lv.max())[0])
            codes.append(c)
            scales.append(sc)
            gids.append(g)
        self._stacked = {"codes": codes, "scales": scales, "gids": gids,
                         "eps": eps, "adjs": ()}
        self._counts = np.diff(bounds).astype(np.int64)
        return ns

    def _waves(self, homes: list, layer_nb: int, indegs, dedup: bool = False) -> None:
        """Wave-insert each shard's ``homes[s]`` (local rows of level
        ``layer_nb``) into the shards' sub-graphs, in place: every wave
        takes the next ``wsize`` homes of every shard under one
        ``wave_schedule`` over the largest shard's count."""
        st = self._stacked
        p = self.params
        maxhome = max((h.size for h in homes), default=0)
        off = 0
        for wsize in wave_schedule(maxhome):
            ids_w = [torch.from_numpy(h[off:off + wsize].astype(np.int32))
                     .to(self._dev(s)) for s, h in enumerate(homes)]
            off += wsize
            sharded_wave_step(
                self.mesh, st["adjs"], indegs, st["codes"], st["scales"], ids_w,
                st["eps"], ef=p.ef_cons, m=p.m, max_iters=2 * p.ef_cons + 16,
                layer_nb=layer_nb, extend_cands=p.extend_cands, dedup=dedup)

    def _build_concurrent(self, vectors: np.ndarray, bounds: np.ndarray) -> None:
        """Shard-concurrent wave build over the mesh."""
        S = self.n_shards
        p = self.params
        ns = self._fresh_shards(vectors, bounds)
        top = int(self._levels.max())
        self._stacked["adjs"] = tuple(
            [torch.full((ns, p.layer_cap(lam)), -1, dtype=torch.int32,
                        device=self._dev(s)) for s in range(S)]
            for lam in range(top + 1))
        indegs = tuple([torch.zeros((ns,), dtype=torch.int32, device=self._dev(s))
                        for s in range(S)] for _ in range(top + 1))
        for layer_nb in range(top, -1, -1):
            homes = [np.flatnonzero(self._levels[s] == layer_nb) for s in range(S)]
            self._waves(homes, layer_nb, indegs)

    def _build_concurrent_cluster(self, vectors: np.ndarray, bounds: np.ndarray,
                                  cluster_kwargs: dict) -> None:
        """Shard-concurrent cluster-bulk build: every layer is one
        clustered bulk pass over its members on every shard
        (``parallel.sharded_cluster.sharded_cluster_layer``).
        Connectivity is owned by its orphan fixpoint; the host repair
        backstop of the single-index builder runs only in the sequential
        path."""
        from .sharded_cluster import sharded_cluster_layer

        S = self.n_shards
        p = self.params
        ns = self._fresh_shards(vectors, bounds)
        st = self._stacked
        adjs = []
        for layer_nb in range(int(self._levels.max()), -1, -1):
            cap = p.layer_cap(layer_nb)
            adj_s = [torch.full((ns, cap), -1, dtype=torch.int32, device=self._dev(s))
                     for s in range(S)]
            adj_s, _, reps = sharded_cluster_layer(
                self.mesh, st["codes"], st["scales"], adj_s, self._counts,
                self._levels, layer_nb, cap=cap, m=p.m, **cluster_kwargs)
            adjs.append(adj_s)
            if layer_nb == 0:
                self._cluster_reps = reps
        st["adjs"] = tuple(reversed(adjs))  # layer 0 first

    def _stack(self) -> None:
        """Per-shard state padded to a uniform row count from the
        sequential path's sub-indexes."""
        S = self.n_shards
        ns = max(len(s) for s in self.shards)
        nl = max(len(s.graph) for s in self.shards)
        d = self.params.dim
        self._levels = np.full((S, ns), -1, np.int32)
        codes, scales, gids = [], [], []
        eps = np.zeros((S,), np.int32)
        adjs = tuple([] for _ in range(nl))
        for s, sub in enumerate(self.shards):
            k = len(sub)
            dev = self._dev(s)
            c = torch.zeros((ns, d), dtype=torch.uint8, device=dev)
            sc = torch.zeros((ns, 2), dtype=torch.float32, device=dev)
            g = torch.full((ns,), -1, dtype=torch.int32, device=dev)
            c[:k], sc[:k] = sub.points.codes[:k], sub.points.scales[:k]
            g[:k] = torch.arange(int(self._offsets[s]), int(self._offsets[s]) + k,
                                 dtype=torch.int32, device=dev)
            codes.append(c)
            scales.append(sc)
            gids.append(g)
            eps[s] = sub.params.ep
            self._levels[s, :k] = np.asarray(sub.points.levels)[:k]
            for lam in range(nl):
                a = torch.full((ns, self.params.layer_cap(lam)), -1,
                               dtype=torch.int32, device=dev)
                if lam < len(sub.graph):
                    a[:k] = sub.graph.get_layer(lam)[:k]
                adjs[lam].append(a)
        self._stacked = {"codes": codes, "scales": scales, "gids": gids,
                         "eps": eps, "adjs": adjs}
        self._counts = np.asarray([len(s) for s in self.shards], np.int64)

    # -- incremental insert ------------------------------------------------

    def add(self, vectors) -> np.ndarray:
        """Incremental insert into the built sharded index, no rebuild.

        New vectors are assigned round-robin starting from the least-
        loaded shards (balanced under skewed add streams), appended to
        each shard's tail rows (the padded row count grows geometrically),
        and wave-inserted into the existing sub-graphs with the same
        :func:`sharded_wave_step` the concurrent builder uses. Returns the
        new points' global ids (stable, insertion-ordered)."""
        if self._stacked is None:
            raise ValueError("index is empty: call insert_bulk first")
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        n_new = vectors.shape[0]
        if n_new == 0:
            return np.zeros((0,), np.int64)
        S = self.n_shards
        # balanced round-robin assignment: least-loaded shards first
        order = np.argsort(self._counts, kind="stable")
        shard_of = order[np.arange(n_new) % S]
        new_gids = int(self._counts.sum()) + np.arange(n_new)
        lv_new = sample_levels(n_new, self.params.ml, seed=S + self._level_calls)
        self._level_calls += 1
        codes_new, scales_new = quantize(torch.from_numpy(vectors).to(self._dev(0)))
        self._insert_rows(codes_new.cpu().numpy(), scales_new.cpu().numpy(),
                          new_gids, lv_new, shard_of)
        return new_gids

    def _insert_rows(self, codes_new, scales_new, gids_new, lv_new, shard_of,
                     extra=None, dedup: bool = False) -> np.ndarray:
        """Write pre-quantized rows at shard tails and wave-insert them
        into the existing sub-graphs: the machinery :meth:`add` and
        :meth:`rebalance` share. ``extra``: optional ``(shard, row,
        level)`` int arrays of existing rows to re-wave in place
        (rebalance's repair; pass ``dedup=True`` with it, since existing
        nodes still have in-edges, see ``build._apply_wave_impl``).
        Returns the new rows' local row ids (aligned with ``gids_new``)."""
        S = self.n_shards
        p = self.params
        st = self._stacked
        self._packed = self._shortlist = None  # the serving pack goes stale
        self._pack_n = -1
        n_new = int(gids_new.shape[0])

        k_s = np.bincount(shard_of, minlength=S) if n_new else np.zeros(S, np.int64)
        ns_old = int(self._levels.shape[1])
        need = int((self._counts + k_s).max())
        ns = ns_old if need <= ns_old else max(need, 2 * ns_old)
        if ns != ns_old:
            pad = ns - ns_old
            st["codes"] = [_grow(t, pad, 0) for t in st["codes"]]
            st["scales"] = [_grow(t, pad, 0) for t in st["scales"]]
            st["gids"] = [_grow(t, pad, -1) for t in st["gids"]]
            st["adjs"] = tuple([_grow(t, pad, -1) for t in a] for a in st["adjs"])
            self._levels = np.pad(self._levels, ((0, 0), (0, pad)),
                                  constant_values=-1)

        # grow the layer stack if a new node draws a new top level
        top_old = len(st["adjs"]) - 1
        lv_max = int(lv_new.max()) if n_new else 0
        if extra is not None and extra[2].size:
            lv_max = max(lv_max, int(extra[2].max()))
        top_new = max(top_old, lv_max)
        st["adjs"] = st["adjs"] + tuple(
            [torch.full((ns, p.layer_cap(lam)), -1, dtype=torch.int32,
                        device=self._dev(s)) for s in range(S)]
            for lam in range(top_old + 1, top_new + 1))

        # write the new rows (codes, scales, gids, levels) per shard
        local_of = np.empty(n_new, np.int64)
        for s in range(S):
            sel = np.flatnonzero(shard_of == s)
            if sel.size == 0:
                continue
            rows = int(self._counts[s]) + np.arange(sel.size)
            local_of[sel] = rows
            dev = self._dev(s)
            r = torch.from_numpy(rows).to(dev)
            st["codes"][s][r] = torch.from_numpy(codes_new[sel]).to(dev)
            st["scales"][s][r] = torch.from_numpy(scales_new[sel]).to(dev)
            st["gids"][s][r] = torch.from_numpy(
                np.asarray(gids_new[sel], np.int32)).to(dev)
            self._levels[s, rows] = lv_new[sel]
            self._counts[s] += sel.size
        # eps are not retargeted here even when a new node draws a new
        # per-shard top level: a node becomes the entry point only after
        # its own insertion (below, per layer group). Swapping first points
        # every wave's searches at an edge-less row, and the old residents
        # end up a directed island. The reference swaps ep after the
        # insert too (hnsw/src/template.rs:403-440).
        eps = st["eps"].copy()
        ep_lv = np.array([int(self._levels[s, int(eps[s])]) for s in range(S)])

        # per-layer in-degrees are not kept after a build: recount them
        indegs = tuple([_indeg_stacked(t) for t in a] for a in st["adjs"])

        # wave members: the new tail rows plus any existing rows the
        # caller wants re-waved in place (rebalance's repair set)
        all_sh = np.asarray(shard_of, np.int64)
        all_rows = local_of
        all_lv = np.asarray(lv_new, np.int64)
        if extra is not None:
            all_sh = np.concatenate([all_sh, np.asarray(extra[0], np.int64)])
            all_rows = np.concatenate([all_rows, np.asarray(extra[1], np.int64)])
            all_lv = np.concatenate([all_lv, np.asarray(extra[2], np.int64)])
        for layer_nb in range(top_new, -1, -1):
            homes = [all_rows[(all_sh == s) & (all_lv == layer_nb)]
                     for s in range(S)]
            if max(h.size for h in homes) == 0:
                continue
            self._waves(homes, layer_nb, indegs, dedup=dedup)
            # freshly inserted top nodes anchor the remaining (lower)
            # layer groups' descents (see the eps note above)
            for s in range(S):
                if homes[s].size and layer_nb > ep_lv[s]:
                    eps[s] = int(homes[s][0])
                    ep_lv[s] = layer_nb
            st["eps"] = eps.copy()
        return local_of

    # -- rebalancing -------------------------------------------------------

    def rebalance(self, tol: float = 0.05, verbose: bool = False) -> int:
        """Even out shard loads by moving points between sub-graphs.

        Overloaded shards give up their tail rows (row storage stays
        dense), the movers' in-edges are scrubbed (:func:`_scrub_stacked`,
        rows compacted), alive nodes the scrub touched or left with
        layer-0 in-degree 0 are re-inserted in place, and the movers are
        re-inserted into the deficit shards with their global ids and
        levels kept: queries before and after see the same id space.
        Returns the number of points moved: 0 when the worst deviation is
        within ``tol`` of the mean shard load."""
        if self._stacked is None:
            raise ValueError("index is empty: call insert_bulk first")
        S = self.n_shards
        counts = self._counts.astype(np.int64)
        total = int(counts.sum())
        base, rem_n = divmod(total, S)
        # the currently largest shards keep the remainder: minimal movement
        order = np.argsort(-counts, kind="stable")
        target = np.full(S, base, np.int64)
        target[order[:rem_n]] += 1
        surplus = counts - target
        n_move = int(surplus[surplus > 0].sum())
        if n_move == 0 or int(np.abs(surplus).max()) <= tol * max(base, 1):
            return 0
        st = self._stacked
        self._packed = self._shortlist = None
        self._pack_n = -1
        ns = int(self._levels.shape[1])

        # 1. movers = tail rows of every overloaded shard (the tail keeps
        # the surviving rows dense: alive rows are exactly [0, counts))
        rem_rows = np.zeros((S, ns), bool)
        mv_codes, mv_scales, mv_gids, mv_lv = [], [], [], []
        for s in np.flatnonzero(surplus > 0):
            k = int(surplus[s])
            c0 = int(counts[s])
            rem_rows[s, c0 - k:c0] = True
            mv_codes.append(st["codes"][s][c0 - k:c0].cpu().numpy())
            mv_scales.append(st["scales"][s][c0 - k:c0].cpu().numpy())
            mv_gids.append(st["gids"][s][c0 - k:c0].cpu().numpy().astype(np.int64))
            mv_lv.append(self._levels[s, c0 - k:c0].astype(np.int32))
            self._levels[s, c0 - k:c0] = -1
            self._counts[s] -= k
        mv_codes = np.concatenate(mv_codes)
        mv_scales = np.concatenate(mv_scales)
        mv_gids = np.concatenate(mv_gids)
        mv_lv = np.concatenate(mv_lv)
        dst = np.repeat(np.flatnonzero(surplus < 0), -surplus[surplus < 0])

        # 2. scrub: edges into movers die, mover rows are wiped, every row
        # left-compacted; dead rows get neutral codes and gid -1 so they
        # can never look near nor surface a stale global id
        changed = np.zeros((S, ns), bool)
        for s in range(S):
            rem = torch.from_numpy(rem_rows[s]).to(self._dev(s))
            for a in st["adjs"]:
                a[s], ch = _scrub_stacked(a[s], rem, rem)
                changed[s] |= ch.cpu().numpy()
            st["gids"][s] = _mask_i32(st["gids"][s], rem)
            st["codes"][s] = _zero_rows(st["codes"][s], rem)
            st["scales"][s] = _zero_rows(st["scales"][s], rem)

        # source shards whose entry point moved away pick a new one
        eps = st["eps"]
        for s in np.flatnonzero(surplus > 0):
            c = int(self._counts[s])
            if c and int(eps[s]) >= c:
                eps[s] = int(np.argmax(self._levels[s, :c]))

        # 3. repair set: every alive node the scrub touched (lost out-edges
        # at any layer, emptied rows included) plus any node left with
        # layer-0 in-degree 0 (unreachable; the ep is reachable by
        # construction and exempt). They are re-waved in place: a fresh
        # search and heuristic rebuild their rows at full out-degree, with
        # dedup=True guarding their surviving in-edges against duplicates.
        # Without this, survivors of a heavy move serve permanently
        # degraded rows.
        eprows = np.zeros((S, ns), bool)
        eprows[np.arange(S), eps.astype(np.int64)] = True
        indeg0 = np.stack([_indeg_stacked(a).cpu().numpy() for a in st["adjs"][0]])
        need = (changed | ((indeg0 == 0) & ~eprows)) & (self._levels >= 0)
        extra = None
        o_s, o_r = np.nonzero(need)
        if o_s.size:
            extra = (o_s.astype(np.int64), o_r.astype(np.int64),
                     self._levels[o_s, o_r].astype(np.int64))
        if verbose:
            print(f"rebalance: moving {n_move} points "
                  f"({int(surplus[surplus > 0].max())} max surplus), "
                  f"re-waving {o_s.size} scrub-affected rows")

        # 4. one shared insert pass: movers into the deficit shards (new
        # tail rows, gids and levels kept) and the repairs in place
        self._insert_rows(mv_codes, mv_scales, mv_gids, mv_lv, dst, extra=extra,
                          dedup=True)
        return n_move

    # -- serving layouts ---------------------------------------------------

    def finalize(self, expand: int = 1, pivots: int = 2048,
                 pivot_fill: str = "cover", pivot_cover: float = 0.25,
                 pivot_shortlist: int = 0) -> "ShardedHNSW":
        """Build the packed and pivot-seeded serving state per shard (the
        single index's ``HNSW.finalize`` scaled out): each shard gets
        packed layer-0 rows and its own pivot skeleton. A stale pack
        (after :meth:`add`) is detected and bypassed, never served.
        ``pivots`` is per shard and must be > 0 (the seeded path replaces
        the upper-layer descent at query time).

        ``pivot_fill``/``pivot_cover`` mirror ``HNSW.finalize``: under
        ``"cover"`` (default) each shard's structural picks are capped at
        ``1 - pivot_cover`` of the budget and the rest are k-center
        coverage picks (:meth:`_cover_fill_sharded`).

        ``pivot_shortlist=T`` also builds, on each shard's device, each of
        its pivots' top-T nearest live rows (``models.hnsw._build_shortlist``;
        local ids, -1 pads, a pad pivot's row all -1) and their packed
        rows, and serving takes the probed route
        (:func:`sharded_query_probe_packed`, ``serve_probes`` pivots probed
        per query)."""
        if self._stacked is None:
            raise ValueError("index is empty: call insert_bulk first")
        self._packed = self._shortlist = None
        self._pack_n = -1
        if pivots <= 0:
            return self
        st = self._stacked
        S = self.n_shards
        cap = pivots if pivot_fill == "stride" else max(
            1, pivots - int(round(pivots * float(pivot_cover))))
        packed_s = [pack_layer(st["adjs"][0][s], st["codes"][s], st["scales"][s])
                    for s in range(S)]

        # per-shard pivot ids (HNSW.finalize's selection, shard-local):
        # cluster-build representatives first, then level-based picks,
        # then a fill so the budget is met (an unfilled budget and
        # level-only sampling both leave micro-regions seedless)
        pid = np.full((S, pivots), -1, np.int32)
        need = np.zeros(S, np.int64)
        for s in range(S):
            k = int(self._counts[s])
            lv = self._levels[s, :k]
            ids = None
            for level in range(int(lv.max()) if k else 0, 0, -1):
                cand = np.flatnonzero(lv >= level)
                if cand.size >= min(cap, k) or level == 1:
                    ids = cand
                    break
            if ids is None or ids.size == 0:
                ids = np.arange(k)
            if ids.size > cap:
                ids = ids[np.unique(
                    np.linspace(0, ids.size - 1, cap).round().astype(np.int64))]
            if self._cluster_reps is not None:
                reps = self._cluster_reps[s]
                reps = reps[reps >= 0]
                reps = reps if reps.size else None
            elif s < len(self.shards) and self.shards[s]._cluster_pivots is not None:
                reps = self.shards[s]._cluster_pivots
            else:
                reps = None
            if reps is not None:
                # drop representatives whose rows no longer live here
                # (rebalance moves tail rows; the sub-index hints are static)
                reps = np.asarray(reps, np.int64)
                reps = reps[reps < k]
                if reps.size > cap:
                    reps = reps[np.unique(np.linspace(0, reps.size - 1, cap)
                                          .round().astype(np.int64))]
                seen = set(reps.tolist())
                extra = [i for i in ids.tolist() if i not in seen]
                ids = np.concatenate([
                    reps, np.asarray(extra[: max(0, cap - reps.size)], np.int64)])
            if ids.size < min(pivots, k) and pivot_fill == "stride":
                stride = np.linspace(0, k - 1, min(pivots, k)).round().astype(np.int64)
                seen2 = set(ids.tolist())
                fill = [i for i in stride.tolist() if i not in seen2]
                ids = np.concatenate([np.asarray(ids, np.int64),
                                      np.asarray(fill[: pivots - ids.size], np.int64)])
            need[s] = min(pivots, k) - ids.size
            pid[s, : ids.size] = ids
        if pivot_fill == "cover" and int(need.max()) > 0:
            pid = self._cover_fill_sharded(pid, need)
        pid_s, pvecs_s = [], []
        for s in range(S):
            dev = self._dev(s)
            ids = torch.from_numpy(pid[s]).to(dev)
            safe = ids.clamp(0, st["codes"][s].shape[0] - 1).long()
            vec = dequantize(st["codes"][s][safe], st["scales"][s][safe])
            pid_s.append(ids)
            pvecs_s.append(torch.where((ids >= 0)[:, None], vec, 0.0))
        if pivot_shortlist > 0:
            sl_s, slp_s = [], []
            for s in range(S):
                k = int(self._counts[s])
                codes, scales = st["codes"][s], st["scales"][s]
                sl = _build_shortlist(pvecs_s[s], codes[:k], scales[:k],
                                      int(pivot_shortlist))
                # -1 pads (adjacency's), for pad pivots and past k rows
                sl = torch.where((pid_s[s] >= 0)[:, None] & (sl < k), sl, -1)
                sl_s.append(sl)
                slp_s.append(pack_layer(sl, codes, scales))
            self._shortlist = (sl_s, slp_s)
        self._packed = (packed_s, pid_s, pvecs_s)
        self._pack_n = len(self)
        self.serve_expand = int(expand)
        return self

    def _cover_fill_sharded(self, pid: np.ndarray, need: np.ndarray,
                            batch: int = 256) -> np.ndarray:
        """k-center coverage fill of every shard's pivot budget (the single
        index's ``finalize(pivot_fill="cover")`` per shard). ``pid``
        int32[S, pivots] structural picks (-1 pad), ``need`` int64[S]
        per-shard fill counts; returns ``pid`` with the coverage picks
        appended per row. Every shard runs the same number of greedy
        rounds (the largest ``need``, rounded up to ``batch``), rows past
        its live count never win, and its picks are kept in pick order,
        skipping rows already held, up to its own ``need``. The points are
        dequantized one shard at a time."""
        st = self._stacked
        batch = int(min(batch, max(1, int(need.max()))))
        budget = -(-int(need.max()) // batch) * batch
        pid = pid.copy()
        for s in range(self.n_shards):
            if need[s] <= 0:
                continue
            k = int(self._counts[s])
            have = pid[s][pid[s] >= 0]
            x = dequantize(st["codes"][s], st["scales"][s])
            picks = _kcenter(x, have.astype(np.int64), budget, batch, n_alive=k)
            del x
            held = set(have.tolist())
            take = []
            for p in picks.tolist():
                # drop picks past the shard's live rows (the budget is the
                # largest over shards) and exact-duplicate degenerate picks
                if p < k and p not in held:
                    held.add(p)
                    take.append(p)
                    if len(take) == int(need[s]):
                        break
            pid[s, have.size:have.size + len(take)] = take
        return pid

    # -- persistence -------------------------------------------------------

    def to_numpy(self) -> tuple[dict, dict[str, np.ndarray]]:
        """The ``params.json`` dict and the npz arrays :meth:`save` writes:
        the JAX package's ``hnsw_rs_tpu.sharded.v1`` layout, every
        per-shard array stacked on a leading [S] axis (``codes``,
        ``scales``, ``gids``, ``eps``, ``levels``, ``counts``, ``offsets``,
        ``adj_<l>``)."""
        if self._stacked is None:
            raise ValueError("index is empty: nothing to save")
        st = self._stacked
        meta = {"format": FORMAT, "params": self.params.to_dict(),
                "n_shards": self.n_shards, "n_layers": len(st["adjs"]),
                "level_calls": self._level_calls}

        def stack(ts):
            return np.stack([t.cpu().numpy() for t in ts])

        arrays = {"codes": stack(st["codes"]), "scales": stack(st["scales"]),
                  "gids": stack(st["gids"]), "eps": np.asarray(st["eps"], np.int32),
                  "levels": self._levels, "counts": self._counts,
                  "offsets": np.asarray(self._offsets)}
        for i, a in enumerate(st["adjs"]):
            arrays[f"adj_{i}"] = stack(a)
        return meta, arrays

    @classmethod
    def from_numpy(cls, meta: dict, arrays, mesh: Mesh) -> "ShardedHNSW":
        """An index on ``mesh`` from the dict and arrays either package's
        ``save`` writes. Call :meth:`finalize` afterwards for the packed,
        seeded serving mode."""
        if meta.get("format") != FORMAT:
            raise ValueError(f"unknown index format {meta.get('format')!r}")
        params = Params.from_dict(meta["params"])
        S = int(meta["n_shards"])
        index = cls(params.m, params.dim, S, mesh=mesh)
        index.params = params

        def split(name, dtype):
            a = np.asarray(arrays[name], dtype)
            return [torch.from_numpy(a[s].copy()).to(index._dev(s)) for s in range(S)]

        index._stacked = {
            "codes": split("codes", np.uint8),
            "scales": split("scales", np.float32),
            "gids": split("gids", np.int32),
            "eps": np.array(arrays["eps"], np.int32),
            "adjs": tuple(split(f"adj_{i}", np.int32)
                          for i in range(int(meta["n_layers"]))),
        }
        index._levels = np.array(arrays["levels"], np.int32)
        index._counts = np.array(arrays["counts"], np.int64)
        if np.asarray(arrays["offsets"]).size:
            index._offsets = np.array(arrays["offsets"], np.int64)
        index._level_calls = int(meta.get("level_calls", 0))
        return index

    def save(self, path: str) -> None:
        """Checkpoint the sharded state to a directory (``params.json`` +
        ``arrays.npz``), the JAX package's format."""
        meta, arrays = self.to_numpy()
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "params.json"), "w") as f:
            json.dump(meta, f, indent=2)
        np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)

    @classmethod
    def load(cls, path: str, mesh: Mesh) -> "ShardedHNSW":
        """Restore from either package's :meth:`save` onto ``mesh``."""
        with open(os.path.join(path, "params.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return cls.from_numpy(meta, arrays, mesh)

    # -- query -------------------------------------------------------------

    def serving_route(self) -> str:
        """The ``ann_batch`` branch the index serves through now, by
        ``HNSW.serving_route``'s names: ``"probe_packed"`` (pivot seeds and
        the probed shortlists, packed rows), ``"seeded"`` (pivot seeds,
        packed rows) while the pack from :meth:`finalize` is fresh, else
        ``"plain"`` (hierarchical descent, plain gathers). An insert makes
        the pack stale until :meth:`finalize`."""
        if self._packed is None or self._pack_n != len(self):
            return "plain"
        return "probe_packed" if self._shortlist is not None else "seeded"

    def ann_batch(self, queries, n: int, ef: int, max_iters: int | None = None):
        """Batched sharded query: (distances [B, n], global ids [B, n]) as
        numpy arrays, through the branch :meth:`serving_route` names. The
        answers are read back once, after the merge (span
        ``hnsw.ann_batch`` on the data device)."""
        dev = self.mesh.data_devices[0]
        with span("hnsw.ann_batch", device=dev):
            route = self.serving_route()
            queries = np.atleast_2d(np.asarray(queries, np.float32))
            ef = max(ef, n)
            if max_iters is None:
                max_iters = 2 * ef + 16
            q = dequantize(*quantize(torch.from_numpy(queries).to(dev)))
            st = self._stacked
            if route == "plain":
                d, i = sharded_query(self.mesh, st["adjs"], st["codes"],
                                     st["scales"], st["gids"], st["eps"], q, ef,
                                     n, max_iters)
            elif route == "seeded":
                d, i = sharded_query_seeded(self.mesh, *self._packed, st["gids"],
                                            q, ef, n, max_iters,
                                            expand_e=self.serve_expand)
            else:
                sl_s, slp_s = self._shortlist
                d, i = sharded_query_probe_packed(
                    self.mesh, *self._packed, slp_s, sl_s[0].shape[1],
                    st["gids"], q, ef, n, max_iters, self.serve_probes,
                    expand_e=self.serve_expand)
            return d.cpu().numpy(), i.cpu().numpy()


def _scrub_stacked(a: torch.Tensor, rem_edges: torch.Tensor,
                   rem_rows: torch.Tensor):
    """Rebalance scrub over adjacency ``a`` int32[..., ns, cap] (one shard
    or a stack): drop every edge pointing into a ``rem_edges`` row
    (bool[..., ns]), wipe ``rem_rows`` own rows entirely, then
    left-compact each row with a stable sort on validity — the row order
    is distance order and must survive (slot 0 is "nearest" for the
    orphan repair). Returns (adjacency, changed) where ``changed``
    bool[..., ns] marks the surviving rows that lost at least one edge."""
    ns, cap = a.shape[-2:]
    safe = a.clamp(0, ns - 1).reshape(*a.shape[:-2], ns * cap).long()
    bad = torch.gather(rem_edges, -1, safe).reshape(a.shape) & (a >= 0)
    changed = bad.any(dim=-1) & ~rem_rows
    a = torch.where(bad | rem_rows[..., None], -1, a)
    perm = torch.sort((a < 0).to(torch.int8), dim=-1, stable=True).indices
    return a.gather(-1, perm), changed


def _indeg_stacked(a: torch.Tensor) -> torch.Tensor:
    """int32[..., ns]: the in-degree of every local row of ``a``
    int32[..., ns, cap] (integer adds: exact in any order)."""
    ns, cap = a.shape[-2:]
    flat = torch.where(a >= 0, a, ns).reshape(-1, ns * cap).long()
    z = torch.zeros((flat.shape[0], ns + 1), dtype=torch.int32, device=a.device)
    z.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    return z[:, :ns].reshape(a.shape[:-1])


def _mask_i32(x: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    return torch.where(rem, -1, x)


def _zero_rows(x: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    return torch.where(rem[..., None], torch.zeros((), dtype=x.dtype, device=x.device), x)
