"""The HNSW index (port of ``hnsw_rs_tpu/models/hnsw.py``): bulk builds
(the wave builder, or the cluster-bulk builder with automatic
pivot-seeded serving), incremental inserts batched into waves,
hierarchical-descent serving over packed or plain layer-0 rows,
``finalize`` into pivot-seeded serving, and persistence in the JAX
package's ``hnsw_rs_tpu.v1`` format, so either package loads an index the
other saved.

Not ported yet: E>1 expansion, the PQ and shortlist-probe serving modes,
the cosine metric and ``refine``.
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
    ann_search_seeded,
    ann_search_seeded_plain,
    pack_layer,
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
        # pivot-seeded serving: (pivot ids i32[P], pivot vectors f32[P, d])
        # and the point count they were chosen at
        self._pivots = None
        self._pivots_n = -1
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
        ``wave_base``/``wave_growth``/``wave_cap``, ``packed_build``,
        ``pack_lag``, ``cluster_build``, ``cluster_kwargs``)."""
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

    def finalize(self, pivots: int = 0, packed: bool = True,
                 pivot_fill: str = "cover", pivot_cover: float = 0.25,
                 pq_m: int = 0, pivot_shortlist: int = 0) -> "HNSW":
        """Set the serving mode. ``packed=True`` builds the packed
        layer-0 rows (``cap*(dim+12)`` bytes per point, one gather per
        beam expansion); ``pivots > 0`` enables pivot-seeded serving from
        a table of that many points: the cluster representatives and
        level picks first (capped at ``1 - pivot_cover`` of the budget
        under ``pivot_fill="cover"``), then k-center picks over the points
        (``"cover"``) or evenly strided ids (``"stride"``). ``pivots=0``
        turns pivot seeding off. Re-run after inserts: stale rows and
        pivots are never served. The PQ and shortlist modes are not
        ported yet. Returns self."""
        if pq_m or pivot_shortlist:
            raise NotImplementedError(
                "PQ and shortlist-probe serving are not ported yet "
                "(ROADMAP.md queue A, item 10)")
        if pivot_fill not in ("cover", "stride"):
            raise ValueError(f"unknown pivot_fill {pivot_fill!r}")
        self.flush()
        n = len(self)
        if not packed:
            self._packed0, self._packed_n = None, -1
        elif len(self.graph) > 0 and self._packed_n != n:
            # a packed build already left fresh rows; pack after a load, a
            # plain build or inserts
            self._packed0 = pack_layer(self.graph.get_layer(0),
                                       self.points.codes, self.points.scales)
            self._packed_n = n
        if pivots <= 0 or n == 0:
            self._pivots, self._pivots_n = None, -1
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
        """The ``ann_batch`` branch the index serves through now:
        ``"seeded"`` (pivot seeds, packed rows), ``"packed"``
        (hierarchical descent, packed layer-0 rows), ``"seeded_plain"``
        (pivot seeds, plain gathers) or ``"plain"`` (hierarchical
        descent, plain gathers). Packed rows and pivots serve only while
        they were made at the current point count: an insert makes them
        stale until :meth:`finalize`."""
        self.flush()
        pack_fresh = self._packed0 is not None and self._packed_n == len(self)
        piv_fresh = self._pivots is not None and self._pivots_n == len(self)
        if pack_fresh:
            return "seeded" if piv_fresh else "packed"
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
        if route in ("seeded", "seeded_plain"):
            piv_ids, piv_vecs = self._pivots
        if route == "seeded":
            d, i = ann_search_seeded(self._packed0, piv_ids, piv_vecs, q, ef,
                                     n, max_iters)
        elif route == "packed":
            d, i = ann_search_packed(
                self.graph.adjs[1:], self._packed0, self.points.codes,
                self.points.scales, q, self.params.ep, ef, n, max_iters)
        elif route == "seeded_plain":
            d, i = ann_search_seeded_plain(
                self.graph.get_layer(0), self._serving_table(),
                self.points.scales, piv_ids, piv_vecs, q, ef, n, max_iters)
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
