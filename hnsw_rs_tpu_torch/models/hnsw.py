"""The HNSW index (port of ``hnsw_rs_tpu/models/hnsw.py``): bulk builds
(the wave builder, or the cluster-bulk builder with automatic
pivot-seeded serving), incremental inserts batched into waves,
hierarchical-descent serving over packed or plain layer-0 rows,
``finalize`` into pivot-seeded, shortlist-probed or PQ-coded serving
(each with E>1 expansion), NN-descent ``refine``, and persistence in the
JAX package's ``hnsw_rs_tpu.v1`` format, so either package loads an index
the other saved.

Not ported yet: the cosine metric.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..build import build_index, insert_waves, repair_connectivity
from ..errors import DimensionMismatch
from ..graphs import LayeredGraph, degrees
from ..ops.quant import dequantize, quantize
from ..params import Params
from ..search import (
    ann_search,
    ann_search_packed,
    ann_search_pq,
    ann_search_seeded,
    ann_search_seeded_plain,
    ann_search_seeded_probe,
    ann_search_seeded_probe_packed,
    pack_layer,
    pack_layer_pq,
)
from ..store import PointStore

FORMAT = "hnsw_rs_tpu.v1"
# build_index options that concern a whole bulk build; extending a built
# index drops them, so insert_bulk takes the same keywords either way
_BULK_ONLY = ("cluster_build", "cluster_kwargs", "packed_build", "pack_lag",
              "build_seeded", "build_pivot_cap", "wave_sort")


@dataclasses.dataclass
class Point:
    """View of a stored point (the reference's ``Point``,
    ``points/src/point.rs:5-10``)."""

    id: int
    level: int
    values: np.ndarray


def _build_shortlist(vecs, codes, scales, t: int, chunk: int = 2048):
    """Per-pivot top-``t`` shortlists (``finalize(pivot_shortlist=T)``):
    each pivot's t nearest stored points through tiled flat searches, so
    [P, N] never materializes. The pivots go through in chunks: one
    tiled step holds a [chunk, tile] f32 distance block (1 GiB at 2,048
    pivots against a 131,072-row tile). Returns i32[P, t]."""
    from ..ops.distance import point_normsq
    from .flat import _flat_search_tiled

    normsq = point_normsq(codes, scales)
    parts = [_flat_search_tiled(vecs[lo:lo + chunk], codes, scales, normsq, t)[1]
             for lo in range(0, vecs.shape[0], chunk)]
    return torch.cat(parts).to(torch.int32)


class HNSW:
    """Hierarchical Navigable Small World index held on ``device``."""

    def __init__(self, m: int, ef_cons: int | None = None, dim: int = 0,
                 params: Params | None = None, *,
                 device: torch.device | str):
        if params is None:
            if ef_cons is not None:
                params = Params.from_m_efcons(m, ef_cons, dim)
            else:
                params = Params.from_m(m, dim)
        if params.metric != "l2":
            raise NotImplementedError(
                f"metric {params.metric!r} is not ported yet (l2 only)")
        self.params = params
        self.device = torch.device(device)
        self.points = PointStore.empty(params.dim, self.device)
        self.graph = LayeredGraph(params.m, 0, self.device)
        self._level_rng_calls = 0  # deterministic level stream position
        # serving-path dequantized table cache, kept while it fits
        self.f32_cache_limit = 2 << 30
        self._f32_table = None
        self._f32_n = -1
        # packed layer-0 serving rows (search.pack_layer) and the point
        # count they were built at: a packed build or finalize makes them,
        # and serving uses them only while that count is current
        self._packed0 = None
        self._packed_n = -1
        # beam entries popped per serving iteration (search._beam_loop)
        self.serve_expand = 1
        # pivot-seeded serving: (pivot ids i32[P], pivot vectors f32[P, d])
        # and the point count they were chosen at
        self._pivots = None
        self._pivots_n = -1
        # per-pivot shortlists i32[P, T] (finalize(pivot_shortlist=T)) and
        # their packed rows (pack_layer over the shortlist: it is
        # adjacency-shaped); serve_probes = pivots probed per query
        self._pivot_shortlist = None
        self._pivot_sl_pack = None
        self.serve_probes = 16
        # PQ-coded serving (finalize(pq_m=...)): (codebooks, pq codes,
        # PQ-packed layer 0, OPQ rotation or None) and their point count
        self._pq = None
        self._pq_n = -1
        self.pq_rerank = 0  # exact re-score width; 0 means max(4k, ef)
        # per-cluster representatives from the cluster build
        self._cluster_pivots = None
        # seconds per build phase of the last insert_bulk
        self.build_phase_s: dict[str, float] = {}
        # insert_vec calls buffered into one wave insert, applied on any
        # read or at pending_flush_size
        self._pending: list[np.ndarray] = []
        self.pending_flush_size = 1024

    def __len__(self) -> int:
        return len(self.points) + len(self._pending)

    @property
    def ep(self) -> int:
        return self.params.ep

    def distance(self, a: int, b: int) -> float:
        """True L2 between stored points (``template.rs:150-152``)."""
        self.flush()
        return self.points.distance(a, b)

    def get_point(self, point_id: int) -> Point | None:
        if point_id < 0 or point_id >= len(self):
            return None
        self.flush()
        return Point(id=point_id, level=int(self.points.levels[point_id]),
                     values=self.points.get_values(point_id))

    def _check_dim(self, d: int) -> None:
        if self.params.dim and d != self.params.dim:
            raise DimensionMismatch(
                f"index dimension is {self.params.dim}, got vectors of "
                f"dimension {d}")

    # -- construction ------------------------------------------------------

    def insert_bulk(self, vectors, verbose: bool = False,
                    **build_kwargs) -> "HNSW":
        """Bulk build or bulk extend (``insert_bulk``,
        ``template.rs:388-445``). Returns self.

        On an empty index this is a fresh build through
        ``build.build_index``: the wave builder by default, whose packed
        layer-0 table (``packed_build``) becomes the serving pack; or,
        with ``cluster_build=True``, the cluster-bulk builder followed by
        the automatic switch to pivot-seeded serving without packed rows
        (``finalize`` upgrades it). On a built index the new points are
        wave-inserted per layer, top down (:meth:`_extend_built`).
        ``build_kwargs``: ``build_index``'s options (``max_iters``,
        ``wave_base``/``wave_growth``/``wave_cap``, ``build_expand``,
        ``wave_sort``, ``build_seeded``, ``build_pivot_cap``,
        ``packed_build``, ``pack_lag``, ``cluster_build``,
        ``cluster_kwargs``)."""
        self.flush()
        x = torch.as_tensor(np.asarray(vectors, np.float32), device=self.device)
        x = torch.atleast_2d(x)
        self._check_dim(x.shape[-1])
        if self.params.dim == 0:
            self.params.dim = int(x.shape[-1])
            self.points = PointStore.empty(self.params.dim, self.device)
        fresh = len(self) == 0
        t0 = time.perf_counter()
        new = PointStore.from_vectors(x, self.params.ml, self.device,
                                      seed=self._level_seed())
        del x
        new_ids = self.points.extend(new)
        if not fresh:
            self._extend_built(new_ids, verbose=verbose, **build_kwargs)
            return self
        self.build_phase_s = {}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.build_phase_s["quantize"] = time.perf_counter() - t0
        self.graph, ep, packed0, creps = build_index(
            self.points, self.params, verbose=verbose,
            phase_s=self.build_phase_s, **build_kwargs)
        self.params.ep = ep
        self._cluster_pivots = creps
        self._packed0, self._packed_n = None, -1
        if packed0 is not None:
            # a packed build kept the serving layout as it went
            self._packed0, self._packed_n = packed0, len(self.points)
        if creps is not None and len(self):
            # cluster-built graphs clear the recall gate pivot-seeded, not
            # through hierarchical descent: serve seeded from the start
            t0 = time.perf_counter()
            self.finalize(pivots=max(1024, int(1.5 * creps.size)), packed=False)
            self.build_phase_s["auto_finalize"] = time.perf_counter() - t0
        return self

    def insert_vec(self, vector) -> int:
        """Incremental single-vector insert (``insert_vec``,
        ``template.rs:165-173``). Returns the new point id.

        Inserts are buffered and applied as one wave insert on any read
        (query, save, get_point, distance) or once ``pending_flush_size``
        have accumulated: a point is searchable by the time anything can
        search. :meth:`flush` forces it."""
        vector = np.asarray(vector, np.float32).reshape(-1)
        self._check_dim(vector.shape[-1])
        if self.params.dim == 0:
            self.params.dim = int(vector.shape[-1])
            self.points = PointStore.empty(self.params.dim, self.device)
        new_id = len(self)
        self._pending.append(vector)
        if len(self._pending) >= self.pending_flush_size:
            self.flush()
        return new_id

    def flush(self) -> "HNSW":
        """Apply buffered :meth:`insert_vec` calls as one wave insert (a
        fresh build if the index was empty)."""
        if not self._pending:
            return self
        vectors = np.stack(self._pending)
        self._pending = []
        # one seeded level draw for the batch: the level stream advances
        # once per store call, as in a bulk insert
        new = PointStore.from_vectors(vectors, self.params.ml, self.device,
                                      seed=self._level_seed())
        new_ids = self.points.extend(new)
        if len(self.points) == vectors.shape[0]:  # was empty: fresh build
            self.graph, ep, packed0, creps = build_index(self.points,
                                                         self.params)
            self._cluster_pivots = creps
            self.params.ep = ep
            if packed0 is not None:
                self._packed0, self._packed_n = packed0, len(self.points)
        else:
            self._extend_built(new_ids, verbose=False)
        return self

    def _level_seed(self) -> int:
        # a distinct deterministic seed per store call (the reference
        # reuses seed 0, which gives every incremental insert one level)
        s = self._level_rng_calls
        self._level_rng_calls += 1
        return s

    def _extend_built(self, new_ids: np.ndarray, verbose: bool,
                      **build_kwargs) -> None:
        """Wave-insert new points into the built graph, per layer top
        down, then the connectivity backstop; a new point above the old
        top level becomes the entry point (the reference leaves that
        dangling, ``template.rs:285-289``). Bulk-only build options are
        dropped; the packed rows and pivots go stale (serving falls back
        to the plain hierarchical branch until :meth:`finalize`)."""
        levels = self.points.levels
        old_top = len(self.graph) - 1
        new_lv = levels[new_ids]
        new_top = int(new_lv.max())
        self.graph.ensure_nodes(self.points.capacity)
        self.graph.ensure_level(max(old_top, new_top))
        max_iters = build_kwargs.pop("max_iters", None) or (
            2 * self.params.ef_cons + 16)
        for key in _BULK_ONLY:
            build_kwargs.pop(key, None)
        for layer_nb in range(new_top, -1, -1):
            t0 = time.perf_counter()
            home = np.asarray(new_ids)[new_lv == layer_nb].astype(np.int32)
            if home.size == 0:
                continue
            insert_waves(self.graph, self.points, self.params, home, layer_nb,
                         self.params.ep, max_iters, **build_kwargs)
            if verbose:
                print(f"inserting: layer {layer_nb}, {home.size} nodes in "
                      f"{time.perf_counter() - t0:.2f}s", flush=True)
        repair_connectivity(self.graph, self.points)
        if new_top > old_top:
            self.params.ep = int(new_ids[np.argmax(new_lv)])

    # -- serving -----------------------------------------------------------

    def refine(self, rounds: int = 1, layer: int = 0, hop_w: int = 8,
               pool_p: int = 192, use_alg4: bool = True,
               batch: int = 1024) -> "HNSW":
        """Synchronous NN-descent refinement of a built layer
        (``refine.refine_layer``): every node re-selects its out-row from
        its 2-hop neighborhood through the Algorithm-4 accept chain. Lifts
        graph quality where the data's blob granularity fights the
        cluster-bulk build's k-means pools (heavy-tailed data). Drops the packed and
        PQ layouts of a refined layer 0 (re-run :meth:`finalize`); the
        pivots stay valid, they are a property of the points and not of
        the edges. Returns self."""
        from ..refine import refine_layer

        self.flush()
        if len(self) == 0:
            return self
        refine_layer(self.graph, self.points, layer_nb=layer, rounds=rounds,
                     hop_w=hop_w, pool_p=pool_p, use_alg4=use_alg4, batch=batch)
        if layer == 0:
            self._packed0, self._packed_n = None, -1
            self._pq, self._pq_n = None, -1
        return self

    def _train_pq(self, pq_m: int, pq_iters: int, pq_opq: bool, pq_bits: int):
        """Train the product quantizer on the stored points, encode them
        and pack layer 0 as PQ rows: ``self._pq``."""
        from ..ops.pq import encode_pq, opq_train, pack_nibbles, train_pq

        n = len(self)
        m_sub = pq_m if pq_bits == 8 else 2 * pq_m
        nv = 1 << pq_bits
        codes, scales = self.points.codes[:n], self.points.scales[:n]
        # train on a deterministic even subsample: a Lloyd step holds
        # [Ntrain, m_sub, nv] temps, tens of GB at a million rows, and 64k
        # samples train codebooks to the same distortion
        ts = min(n, 65536)
        if ts < n:
            pick = torch.from_numpy(np.linspace(0, n - 1, ts).round().astype(
                np.int64)).to(self.device)
            sample = dequantize(codes[pick], scales[pick])
        else:
            sample = dequantize(codes, scales)
        rot = None
        if pq_opq:
            rot, cb = opq_train(sample, m_sub, pq_iters=pq_iters, seed=0,
                                train_n=ts, nv=nv)
        else:
            cb = train_pq(sample, m_sub, iters=pq_iters, seed=0, nv=nv)
        del sample
        # encode in chunks for the same temp reason
        ch = 1 << 16
        parts = []
        for lo in range(0, n, ch):
            x = dequantize(codes[lo:lo + ch], scales[lo:lo + ch])
            parts.append(encode_pq(x if rot is None else x @ rot, cb))
        pq_codes = torch.cat(parts)
        if pq_bits == 4:
            # stored and packed nibble-packed: pq_m bytes per point either
            # way (search dispatches on the codebook size)
            pq_codes = pack_nibbles(pq_codes)
        packed_pq = pack_layer_pq(self.graph.get_layer(0)[:n], pq_codes)
        self._pq = (cb, pq_codes, packed_pq, rot)
        self._pq_n = n

    def finalize(self, expand: int = 1, pivots: int = 0, packed: bool = True,
                 pq_m: int = 0, pq_iters: int = 12, pq_rerank: int = 0,
                 pq_opq: bool = False, pq_bits: int = 8,
                 pivot_fill: str = "cover", pivot_cover: float = 0.25,
                 pivot_shortlist: int = 0) -> "HNSW":
        """Set the serving mode; every call sets it from its arguments
        alone (``pivots`` is absolute state, not a delta: ``finalize(
        expand=E)`` with the default ``pivots=0`` turns a pivot-seeded mode
        off). Re-run after inserts: stale rows and pivots are never
        served. Returns self.

        ``packed=True`` builds the packed layer-0 rows (``cap*(dim+12)``
        bytes per point, one gather per beam expansion). ``expand`` E > 1
        pops E beam entries per lockstep iteration (``search._beam_loop``).

        ``pivots > 0`` enables pivot-seeded serving from a table of that
        many points: the cluster representatives and level picks first
        (capped at ``1 - pivot_cover`` of the budget under
        ``pivot_fill="cover"``), then k-center picks over the points
        (``"cover"``) or evenly strided ids (``"stride"``).

        ``pivot_shortlist=T`` (with ``pivots`` > 0) also builds each
        pivot's top-T nearest-points shortlist (one tiled flat search) and
        switches serving to the probed mode
        (``search.ann_search_seeded_probe_packed``): the ``serve_probes``
        nearest pivots' shortlist members enter the beam exactly scored at
        iteration 0, the fix for walk-limited regimes.

        ``pq_m > 0`` (requires ``pivots`` > 0) enables PQ-coded serving
        instead: a product quantizer of ``pq_m`` bytes per point is trained
        on the stored points (seed-fixed, so safe to re-run after
        :meth:`load`), layer 0 is packed as ``cap*(pq_m+4)`` bytes per
        point, and queries run ADC beams with an exact re-score of the top
        ``pq_rerank`` (default ``max(4k, ef)``) survivors
        (``search.ann_search_pq``). It replaces the exact packed table
        (``packed`` is forced off). ``pq_opq`` trains an OPQ rotation
        first; ``pq_bits=4`` keeps ``pq_m`` bytes per point but splits
        them into ``2 * pq_m`` subspaces with 16-entry codebooks,
        nibble-packed."""
        if pivot_fill not in ("cover", "stride"):
            raise ValueError(f"unknown pivot_fill {pivot_fill!r}")
        self.flush()
        n = len(self)
        if pq_m > 0:
            if pivots <= 0:
                raise ValueError("pq_m > 0 requires pivots > 0 "
                                 "(PQ serving seeds from the pivot table)")
            if pq_bits not in (4, 8):
                raise ValueError(f"pq_bits must be 4 or 8, got {pq_bits}")
            m_sub = pq_m if pq_bits == 8 else 2 * pq_m
            if self.params.dim % m_sub != 0:
                raise ValueError(f"{m_sub} subspaces (pq_m {pq_m} at {pq_bits} "
                                 f"bits) must divide dim {self.params.dim}")
            packed = False  # the PQ pack replaces the exact-code pack
            if n > 0:
                self._train_pq(pq_m, pq_iters, pq_opq, pq_bits)
            self.pq_rerank = int(pq_rerank)
        else:
            self._pq, self._pq_n = None, -1
        if not packed:
            self._packed0, self._packed_n = None, -1
        elif len(self.graph) > 0 and self._packed_n != n:
            # a packed build already left fresh rows; pack after a load, a
            # plain build or inserts
            self._packed0 = pack_layer(self.graph.get_layer(0),
                                       self.points.codes, self.points.scales)
            self._packed_n = n
        self.serve_expand = int(expand)
        if pivots <= 0 or n == 0:
            if pivots == 0:
                self._pivots, self._pivots_n = None, -1
                self._pivot_shortlist = self._pivot_sl_pack = None
            return self
        budget = min(pivots, n)
        cap = budget if pivot_fill == "stride" else max(
            1, budget - int(round(budget * float(pivot_cover))))
        levels = self.points.levels[:n]
        # smallest level whose member count fits the cap, then an even
        # deterministic subsample if even level 1 is too big
        ids = None
        for lv in range(int(levels.max()), 0, -1):
            cand = np.flatnonzero(levels >= lv)
            if cand.size >= min(cap, n) or lv == 1:
                ids = cand
                break
        if ids is None or ids.size == 0:  # single-layer graph
            ids = np.arange(n)
        if ids.size > cap:
            ids = ids[np.unique(
                np.linspace(0, ids.size - 1, cap).round().astype(np.int64))]
        if self._cluster_pivots is not None:
            # cluster-built graphs: the per-cluster representatives cover
            # every region by construction; seed from them first, topped up
            # with the level picks to the cap
            reps = np.asarray(self._cluster_pivots, np.int64)
            if reps.size > cap:
                reps = reps[np.unique(
                    np.linspace(0, reps.size - 1, cap).round().astype(np.int64))]
            seen = set(reps.tolist())
            extra = [i for i in np.asarray(ids).tolist()
                     if i not in seen][: max(0, cap - reps.size)]
            ids = np.concatenate([reps, np.asarray(extra, np.int64)])
        if ids.size < budget:
            need = budget - ids.size
            if pivot_fill == "cover":
                from ..ops.cover import kcenter_fill

                x = dequantize(self.points.codes[:n], self.points.scales[:n])
                fill = kcenter_fill(x, np.asarray(ids, np.int64), need)
                del x
            else:
                stride = np.linspace(0, n - 1, budget).round().astype(np.int64)
                seen2 = set(np.asarray(ids).tolist())
                fill = np.asarray(
                    [i for i in stride.tolist() if i not in seen2][:need],
                    np.int64)
            ids = np.concatenate([np.asarray(ids, np.int64), fill])
        self._set_pivots(np.asarray(ids))
        self._pivot_shortlist = self._pivot_sl_pack = None
        if pivot_shortlist > 0:
            codes, scales = self.points.codes[:n], self.points.scales[:n]
            self._pivot_shortlist = _build_shortlist(
                self._pivots[1], codes, scales, int(pivot_shortlist))
            if packed:
                self._pivot_sl_pack = pack_layer(self._pivot_shortlist, codes,
                                                 scales)
        return self

    def _set_pivots(self, ids: np.ndarray) -> None:
        idt = torch.tensor(np.asarray(ids, np.int32), device=self.device)
        vecs = dequantize(self.points.codes[idt.long()],
                          self.points.scales[idt.long()])
        self._pivots = (idt, vecs)
        self._pivots_n = len(self)

    def _serving_table(self) -> torch.Tensor:
        """uint8 codes, or the cached dequantized f32 table of the whole
        capacity when it fits (identical distances: dequantization is
        exact either way)."""
        if self.points.capacity * max(self.params.dim, 1) * 4 > self.f32_cache_limit:
            return self.points.codes
        if self._f32_table is None or self._f32_n != len(self.points):
            self._f32_table = dequantize(self.points.codes, self.points.scales)
            self._f32_n = len(self.points)
        return self._f32_table

    def serving_route(self) -> str:
        """The ``ann_batch`` branch the index serves through now, in the
        order they are tried: ``"pq"`` (pivot seeds, ADC beam over PQ
        rows, exact rerank), ``"probe_packed"`` and ``"probe"`` (pivot
        seeds plus the probed shortlists, packed or narrow, over packed
        rows), ``"seeded"`` (pivot seeds, packed rows), ``"packed"``
        (hierarchical descent, packed layer-0 rows), ``"seeded_plain"``
        (pivot seeds, plain gathers) or ``"plain"`` (hierarchical
        descent, plain gathers). Packed rows, PQ rows and pivots serve
        only while they were made at the current point count: an insert
        makes them stale until :meth:`finalize`."""
        self.flush()
        pack_fresh = self._packed0 is not None and self._packed_n == len(self)
        piv_fresh = self._pivots is not None and self._pivots_n == len(self)
        pq_fresh = self._pq is not None and self._pq_n == len(self)
        if pq_fresh and piv_fresh:
            return "pq"
        if pack_fresh and piv_fresh:
            if self._pivot_sl_pack is not None:
                return "probe_packed"
            return "probe" if self._pivot_shortlist is not None else "seeded"
        if pack_fresh:
            return "packed"
        return "seeded_plain" if piv_fresh else "plain"

    def ann_by_vector(self, vector, n: int, ef: int) -> np.ndarray:
        """Top-n approximate neighbor ids of one query (``ann_by_vector``,
        ``template.rs:306-335``)."""
        return self.ann_batch(np.asarray(vector, np.float32)[None, :], n, ef)[1][0]

    def ann_batch(self, queries, n: int, ef: int,
                  max_iters: int | None = None):
        """Batched queries: (distances [B, n], ids [B, n]) as numpy arrays,
        through the branch :meth:`serving_route` names. Queries are
        quantized then dequantized (the index lives in quantized space,
        ``template.rs:313``)."""
        route = self.serving_route()
        x = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        x = torch.atleast_2d(x)
        self._check_dim(x.shape[-1])
        ef = max(ef, n)
        if max_iters is None:
            max_iters = 2 * ef + 16
        q = dequantize(*quantize(x))
        e = self.serve_expand
        if route not in ("packed", "plain"):
            piv_ids, piv_vecs = self._pivots
        if route == "pq":
            cb, pq_codes, packed_pq, rot = self._pq
            # default: exact-rescore the whole beam, one [B, ef] gather at
            # the end of the query; ADC ordering noise inside a
            # neighborhood is the PQ mode's recall wall
            d, i = ann_search_pq(
                packed_pq, cb, pq_codes, piv_ids, piv_vecs, self.points.codes,
                self.points.scales, q, ef, n, max_iters,
                self.pq_rerank or max(4 * n, ef), e, rot)
        elif route == "probe_packed":
            d, i = ann_search_seeded_probe_packed(
                self._packed0, piv_ids, piv_vecs, self._pivot_sl_pack,
                self._pivot_shortlist.shape[1], self.params.dim, q, ef, n,
                max_iters, self.serve_probes, e)
        elif route == "probe":
            d, i = ann_search_seeded_probe(
                self._packed0, piv_ids, piv_vecs, self._pivot_shortlist,
                self.points.codes, self.points.scales, q, ef, n, max_iters,
                self.serve_probes, e)
        elif route == "seeded":
            d, i = ann_search_seeded(self._packed0, piv_ids, piv_vecs, q, ef,
                                     n, max_iters, e)
        elif route == "packed":
            d, i = ann_search_packed(
                self.graph.adjs[1:], self._packed0, self.points.codes,
                self.points.scales, q, self.params.ep, ef, n, max_iters, e)
        elif route == "seeded_plain":
            d, i = ann_search_seeded_plain(
                self.graph.get_layer(0), self._serving_table(),
                self.points.scales, piv_ids, piv_vecs, q, ef, n, max_iters, e)
        else:
            d, i = ann_search(self.graph.adjs, self._serving_table(),
                              self.points.scales, q, self.params.ep, ef, n,
                              max_iters)
        return d.cpu().numpy(), i.cpu().numpy()

    # -- introspection -----------------------------------------------------

    def layer_degrees(self, layer_nb: int) -> np.ndarray:
        """Out-degrees of the layer's member nodes
        (``template.rs:158-163``)."""
        self.flush()
        return self.graph.layer_degrees(layer_nb, self.points.levels)

    def assert_param_compliance(self, verbose: bool = True) -> bool:
        """Degree caps respected and no isolated member node
        (``assert_param_compliance``, ``template.rs:341-370``). The
        adjacency is directed, so the reference's undirected min-degree
        >= 1 means both out-degree and in-degree >= 1."""
        self.flush()
        ok = True
        for layer_nb in range(len(self.graph)):
            cap = self.params.layer_cap(layer_nb)
            adj = self.graph.get_layer(layer_nb)
            degs = degrees(adj).cpu().numpy()
            member = self.points.levels >= layer_nb
            if np.any(degs[member] > cap):
                ok = False
                if verbose:
                    print(f"layer {layer_nb}: degree cap {cap} exceeded")
            if int(member.sum()) <= 1:
                continue
            if np.any(degs[member] == 0):
                ok = False
                if verbose:
                    bad = np.flatnonzero(member & (degs == 0))
                    print(f"layer {layer_nb}: {bad.size} isolated nodes {bad[:10]}")
            a = adj.cpu().numpy()
            indeg = np.bincount(a[a >= 0], minlength=self.points.capacity)
            if np.any(indeg[member] == 0):
                ok = False
                if verbose:
                    bad = np.flatnonzero(member & (indeg == 0))
                    print(f"layer {layer_nb}: {bad.size} nodes with "
                          f"in-degree 0 {bad[:10]}")
        if ok and verbose:
            print("Index complies with params.")
        return ok

    def print_index(self) -> None:
        """Dump index stats (``print_index``, ``template.rs:372-385``)."""
        self.flush()
        p = self.params
        print(f"m = {p.m}\nmmax = {p.mmax}\nmmax0 = {p.mmax0}")
        print(f"ml = {p.ml}\nef_cons = {p.ef_cons}")
        print(f"Nb. layers = {len(self.graph)}")
        print(f"Nb. of points = {len(self)}")
        for idx in range(len(self.graph)):
            print(f"Nb. nodes in layer {idx}: "
                  f"{self.graph.nb_nodes(idx, self.points.levels)}")
        print(f"ep: {p.ep}")

    # -- persistence -------------------------------------------------------

    def to_numpy(self) -> tuple[dict, dict[str, np.ndarray]]:
        """The ``params.json`` dict and the npz arrays that :meth:`save`
        writes (``codes``, ``scales``, ``levels``, ``adj_<i>`` and, for a
        cluster-built index, ``cluster_pivots``): the live rows only, not
        the capacity rows."""
        self.flush()
        n = len(self)
        meta = {
            "format": FORMAT,
            "params": self.params.to_dict(),
            "n_layers": len(self.graph),
            "level_rng_calls": self._level_rng_calls,
        }
        arrays = {
            "codes": self.points.codes[:n].cpu().numpy(),
            "scales": self.points.scales[:n].cpu().numpy(),
            "levels": np.asarray(self.points.levels[:n]),
        }
        for i in range(len(self.graph)):
            arrays[f"adj_{i}"] = self.graph.get_layer(i)[:n].cpu().numpy()
        if self._cluster_pivots is not None:
            arrays["cluster_pivots"] = np.asarray(self._cluster_pivots, np.int32)
        return meta, arrays

    @classmethod
    def from_numpy(cls, meta: dict, arrays, device: torch.device | str,
                   pivot_ids: np.ndarray | None = None) -> "HNSW":
        """An index from the ``params.json`` dict and npz arrays either
        package's ``save`` writes. ``pivot_ids``, when given, enables
        packed pivot-seeded serving from exactly those pivots (for
        instance the JAX index's ``_pivots[0]``); otherwise call
        :meth:`finalize`."""
        if meta.get("format") != FORMAT:
            raise ValueError(f"unknown index format {meta.get('format')!r}")
        params = Params.from_dict(meta["params"])
        index = cls(params.m, params=params, device=device)
        dev = index.device
        index.points = PointStore(
            torch.tensor(np.asarray(arrays["codes"], np.uint8), device=dev),
            torch.tensor(np.asarray(arrays["scales"], np.float32), device=dev),
            np.asarray(arrays["levels"], np.int32),
        )
        index.graph = LayeredGraph(params.m, len(index.points), dev)
        n_layers = int(meta["n_layers"])
        if n_layers:
            index.graph.ensure_level(n_layers - 1)
            for i in range(n_layers):
                adj = np.asarray(arrays[f"adj_{i}"], np.int32)
                index.graph.set_layer(i, torch.tensor(adj, device=dev))
        if "cluster_pivots" in arrays:
            index._cluster_pivots = np.asarray(arrays["cluster_pivots"], np.int32)
        index._level_rng_calls = int(meta.get("level_rng_calls", 1))
        if pivot_ids is not None:
            index.finalize()
            index._set_pivots(np.asarray(pivot_ids))
        return index

    def save(self, path: str) -> None:
        """Checkpoint to a directory: ``params.json`` + ``arrays.npz`` in
        the JAX package's format (``template.rs:43-73``)."""
        meta, arrays = self.to_numpy()
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "params.json"), "w") as f:
            json.dump(meta, f, indent=2)
        np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)

    @classmethod
    def load(cls, path: str, device: torch.device | str) -> "HNSW":
        """Restore from either package's ``save`` (``template.rs:75-131``)."""
        with open(os.path.join(path, "params.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return cls.from_numpy(meta, arrays, device)
