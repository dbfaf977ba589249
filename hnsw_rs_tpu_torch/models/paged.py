"""Out-of-core HNSW serving: beam search over a disk-resident index (port
of ``hnsw_rs_tpu/models/paged.py``; the ambition behind the reference's
``HNSWDisk``, ``hnsw/src/disk.rs:22-109``, whose graph half is stubs).
Layout (a DiskANN-style split):

- upper layers (a ~1/m fraction of nodes) live in memory: they are the
  routing skeleton and tiny;
- layer 0's fixed-slot adjacency is a disk ``memmap`` (the OS page cache
  is the natural LRU for hot graph regions);
- layer 0's vectors page through :class:`..store_paged.BlockStore`'s
  block LRU (arithmetic block offsets, positioned reads).

:class:`PagedHNSW` runs the beam on the host in numpy with the exact
flagged-beam semantics of ``search.search_layer`` (the same (d2, id)
order, beam-membership and ring dedup, the same termination): the paged
regime is IO-bound by construction, and each lockstep iteration needs a
random set of neighbor codes from disk. It holds nothing on a device.
:class:`HybridPagedHNSW` adds a device tier (hot packed rows, or
PQ-packed rows) and takes its device explicitly.

Working set: O(batch * ef + block cache + OS page cache), whatever N is.
The directory is the JAX package's, file by file: either package serves
what the other saved.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..ops.quant import quantize
from ..params import Params
from ..store_paged import BlockStore, write_block_store

PAD_ID = np.iinfo(np.int32).max
_ADJ_FILE = "layer0.adj"
_UPPER_FILE = "upper.npz"
_POINTS_FILE = "points.blocks"
_META_FILE = "paged.json"


def save_paged(index, path: str) -> None:
    """Write an :class:`..models.hnsw.HNSW` index in the paged layout."""
    index.flush()
    os.makedirs(path, exist_ok=True)
    n = len(index)
    codes = index.points.codes[:n].cpu().numpy()
    scales = index.points.scales[:n].cpu().numpy()
    levels = np.asarray(index.points.levels)[:n]
    write_block_store(os.path.join(path, _POINTS_FILE), codes, scales, levels)
    adj0 = np.ascontiguousarray(
        index.graph.get_layer(0)[:n].cpu().numpy(), dtype=np.int32)
    adj0.tofile(os.path.join(path, _ADJ_FILE))
    upper = {f"adj_{i}": index.graph.get_layer(i)[:n].cpu().numpy()
             for i in range(1, len(index.graph))}
    upper["levels"] = levels
    # persist finalize()'s exact pivot seed set when it is current: the
    # hybrid tier must seed as the in-memory index does to return its
    # answers, and the selection rule (cluster representatives, level
    # picks, a cover or stride fill) cannot be rebuilt from the levels
    if index._pivots is not None and index._pivots_n == n:
        upper["pivot_ids"] = index._pivots[0].cpu().numpy().astype(np.int32)
    np.savez_compressed(os.path.join(path, _UPPER_FILE), **upper)
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump({"n": int(n), "cap0": int(adj0.shape[1]),
                   "n_layers": len(index.graph),
                   "params": index.params.to_dict()}, f)


def _quantized_queries(queries, metric: str) -> np.ndarray:
    """Queries as the index sees them (``template.rs:313``): normalized
    under the cosine metric, then quantized and dequantized; on the host."""
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    if metric == "cosine":
        nn = np.linalg.norm(queries, axis=-1, keepdims=True)
        queries = queries / np.where(nn > 0, nn, 1.0)
    c, s = (t.numpy() for t in quantize(torch.from_numpy(queries)))
    return c.astype(np.float32) * s[:, 1:2] + s[:, 0:1]


class PagedHNSW:
    """Query-only HNSW over the paged on-disk layout: a host-side numpy
    reader that holds nothing on a device."""

    def __init__(self, path: str, cache_blocks: int = 1024):
        with open(os.path.join(path, _META_FILE)) as f:
            meta = json.load(f)
        self.n = int(meta["n"])
        self.params = Params.from_dict(meta["params"])
        self.store = BlockStore(os.path.join(path, _POINTS_FILE),
                                cache_blocks=cache_blocks)
        self.adj0 = np.memmap(os.path.join(path, _ADJ_FILE), dtype=np.int32,
                              mode="r", shape=(self.n, int(meta["cap0"])))
        with np.load(os.path.join(path, _UPPER_FILE)) as z:
            self.upper = [z[f"adj_{i}"] for i in range(1, int(meta["n_layers"]))]
            self.levels = z["levels"]
            self.pivot_ids = z["pivot_ids"] if "pivot_ids" in z.files else None

    def __len__(self) -> int:
        return self.n

    def close(self) -> None:
        """Close the block file."""
        self.store.close()

    # -- paged vector access -------------------------------------------------

    def _values(self, ids: np.ndarray) -> np.ndarray:
        """Dequantized vectors of a flat id array, block-batched through
        the BlockStore LRU (one lookup per touched block)."""
        codes, scales = self.store.gather(ids)
        return codes.astype(np.float32) * scales[:, 1:2] + scales[:, 0:1]

    def _d2(self, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Squared L2 from per-row queries to per-row id sets:
        q [B, d], ids [B, K] -> [B, K] (invalid ids give garbage:
        callers mask)."""
        b, k = ids.shape
        vec = self._values(np.clip(ids, 0, self.n - 1)).reshape(b, k, -1)
        diff = vec - q[:, None, :]
        return np.einsum("bkd,bkd->bk", diff, diff, dtype=np.float32)

    # -- query ----------------------------------------------------------------

    def ann_batch(self, queries, n: int, ef: int, max_iters: int | None = None):
        """Batched query with ``search.search_layer`` semantics: greedy
        upper-layer descent, a flagged beam over layer 0 paged from disk.
        Returns (distances [B, n], ids [B, n])."""
        q = _quantized_queries(queries, self.params.metric)
        ef = max(ef, n)
        if max_iters is None:
            max_iters = 2 * ef + 16
        b = q.shape[0]

        cur = np.full((b,), self.params.ep, np.int32)
        cur_d2 = self._d2(q, cur[:, None])[:, 0]
        for adj in reversed(self.upper):  # greedy ef=1 descent
            while True:
                nbrs = np.asarray(adj[cur])  # [B, cap]
                valid = nbrs >= 0
                d2 = np.where(valid, self._d2(q, nbrs), np.inf)
                nids = np.where(valid, nbrs, PAD_ID)
                j = np.lexsort((nids, d2), axis=-1)[:, 0]
                bd = d2[np.arange(b), j]
                bi = nids[np.arange(b), j]
                better = (bd < cur_d2) | ((bd == cur_d2) & (bi < cur))
                if not better.any():
                    break
                cur_d2 = np.where(better, bd, cur_d2)
                cur = np.where(better, bi, cur).astype(np.int32)

        # layer-0 flagged beam (search.search_layer semantics)
        cap = self.adj0.shape[1]
        ring_size = max(2 * cap, 64)
        beam_d2 = np.full((b, ef), np.inf, np.float32)
        beam_ids = np.full((b, ef), PAD_ID, np.int32)
        beam_exp = np.ones((b, ef), bool)
        beam_d2[:, 0] = cur_d2
        beam_ids[:, 0] = cur
        beam_exp[:, 0] = False
        ring = np.full((b, ring_size), PAD_ID, np.int32)
        ring[:, 0] = cur
        rows = np.arange(b)

        for _ in range(max_iters):
            unexp = ~beam_exp
            active = unexp.any(axis=1)
            if not active.any():
                break
            pos = unexp.argmax(axis=1)
            cand = beam_ids[rows, pos]
            beam_exp[rows, pos] = True

            nbrs = np.asarray(self.adj0[np.clip(cand, 0, self.n - 1)])
            valid = (nbrs >= 0) & active[:, None]
            safe = np.where(valid, nbrs, 0)
            known = (safe[:, :, None] == beam_ids[:, None, :]).any(-1) | (
                safe[:, :, None] == ring[:, None, :]).any(-1)
            new = valid & ~known
            ring = np.concatenate(
                [np.where(new, nbrs, PAD_ID), ring[:, : ring_size - cap]], 1)
            nd2 = np.where(new, self._d2(q, safe), np.inf)
            nids = np.where(new, nbrs, PAD_ID)

            md = np.concatenate([beam_d2, nd2], 1)
            mi = np.concatenate([beam_ids, nids], 1)
            me = np.concatenate([beam_exp, ~new], 1)
            order = np.lexsort((mi, md), axis=-1)[:, :ef]
            beam_d2 = np.take_along_axis(md, order, 1)
            beam_ids = np.take_along_axis(mi, order, 1)
            beam_exp = np.take_along_axis(me, order, 1)

        return np.sqrt(beam_d2[:, :n]), beam_ids[:, :n]

    def ann_by_vector(self, vector, n: int, ef: int) -> np.ndarray:
        return self.ann_batch(np.asarray(vector, np.float32)[None], n, ef)[1][0]

    # -- shared host-side helpers of the hybrid tier -------------------------

    def _codes_scales(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Raw (codes u8[K, d], scales f32[K, 2]) of a flat id array,
        block-batched through the BlockStore LRU."""
        return self.store.gather(ids)

    def _packed_rows_host(self, ids: np.ndarray) -> np.ndarray:
        """Packed rows (``search.pack_layer``'s byte layout: ``cap*d`` code
        bytes, ``cap*8`` little-endian scale bytes, ``cap*4`` id bytes) of
        ``ids``, assembled on the host in numpy from the memmap adjacency
        and the paged blocks (whose scales are big-endian on disk)."""
        ids = np.asarray(ids, np.int64).ravel()
        cap = self.adj0.shape[1]
        d = self.store.dim
        adj = np.asarray(self.adj0[np.clip(ids, 0, self.n - 1)])  # [K, cap]
        safe = np.where(adj >= 0, adj, 0).ravel()
        codes, scales = self._codes_scales(safe)
        k = ids.size
        return np.concatenate([
            codes.reshape(k, cap * d),
            np.ascontiguousarray(scales, "<f4").view(np.uint8).reshape(k, cap * 8),
            adj.astype("<i4").view(np.uint8).reshape(k, cap * 4),
        ], axis=1)


def _hyb_expand(hot_packed, slot, rows_cold, lanes, beam_d2, beam_ids,
                beam_exp, ring, q, active, cap: int, d: int, e: int):
    """One iteration's expansion on the device (the pops come from
    ``search._beam_pick``): the popped lanes' packed
    rows come from the hot tier (``slot`` i32[B*E], -1 where cold) with the
    cold lanes' rows (``rows_cold`` u8[K, wrow] for ``lanes`` i64[K])
    scattered over them, then the beam merge of ``search._beam_loop``."""
    from ..search import _beam_merge, unpack_rows

    rows = hot_packed[slot.clamp(0, hot_packed.shape[0] - 1).long()]
    if lanes.numel():
        rows[lanes] = rows_cold
    nbrs, vecs = unpack_rows(rows, cap, d)  # [B*E, cap(, d)]
    return _beam_merge(beam_d2, beam_ids, beam_exp, ring, q, active, nbrs,
                       vecs, e, cap)


class HybridPagedHNSW(PagedHNSW):
    """Paged serving with a hot tier on ``device``.

    Device-resident (bounded by ``hot_bytes``): the packed layer-0 rows of
    the highest in-degree nodes (hub rows serve most beam expansions), a
    global id -> hot-slot map, and a pivot skeleton that seeds each query's
    beam with one product. Cold expansions page their packed row from disk
    (BlockStore LRU and the memmap adjacency) and ride one compact staging
    upload per beam iteration, batched across the whole query batch.

    The beam body is ``search._beam_loop``'s iteration (the same (d2, id)
    order, beam-membership and ring dedup, the same termination), so the
    results are the in-memory packed index's given the same seeds; the hot
    tier only changes where a row is fetched from. Working set:
    O(hot_bytes + batch * ef + block cache), whatever N is."""

    def __init__(self, path: str, hot_bytes: int = 512 << 20,
                 pivots: int = 8192, cache_blocks: int = 1024,
                 prefetch: int = 0, pq_m: int = 0, pq_bits: int = 4,
                 pq_iters: int = 12, *, device: torch.device | str):
        """``prefetch > 0`` enables speculative cold staging: each beam
        iteration also names its ``prefetch`` next-best unexpanded
        candidates, whose packed rows a worker thread assembles into a
        host row cache while the device expands the popped ones; the next
        iteration's cold staging then starts from warm rows. Results are
        unchanged: the prefetch only warms caches, and its thread touches
        numpy arrays only.

        ``pq_m > 0`` selects the PQ tier instead: the device holds
        PQ-packed layer-0 rows (``cap * (pq_m + 4)`` bytes per point,
        several times smaller than the exact packed rows) and the pivot
        skeleton; the whole beam runs on the device with ADC scores
        (``search.pq_beam``), and exact vectors are paged from disk once
        per batch for the final rerank. No staging per iteration;
        the results are an approximate beam with an exact rerank, gated by
        recall parity, not equal to the in-memory index's."""
        super().__init__(path, cache_blocks=cache_blocks)
        self.device = torch.device(device)
        cap = self.adj0.shape[1]
        d = self.store.dim
        self._cap, self._d = cap, d
        self._wrow = cap * (d + 12)
        self.pq_m = int(pq_m)
        self.hits = 0  # hot-tier expansion counters
        self.misses = 0
        self.dispatches = 0  # beam iterations of the last ann_batch
        self.device_bytes = 0

        if pq_m > 0:
            self._build_pq_tier(pq_m, pq_bits, pq_iters)
            self.hot_rows = 0
        else:
            h = int(min(self.n, max(1, hot_bytes // self._wrow)))
            # hot set = the top in-degree rows, one chunked memmap pass
            indeg = np.zeros(self.n, np.int64)
            ch = 1 << 16
            for lo in range(0, self.n, ch):
                rows = np.asarray(self.adj0[lo:lo + ch])
                indeg += np.bincount(rows[rows >= 0], minlength=self.n)
            hot_ids = np.argpartition(-indeg, h - 1)[:h]
            hot_ids.sort()
            slot = np.full(self.n, -1, np.int32)
            slot[hot_ids] = np.arange(h, dtype=np.int32)
            self._slot_host = slot
            self._slot = torch.from_numpy(slot).to(self.device)
            self._hot_packed = torch.from_numpy(
                self._packed_rows_host(hot_ids)).to(self.device)
            self.hot_rows = h
            self.device_bytes = int(self._hot_packed.numel() + self._slot.numel() * 4)

        # pivot skeleton: the saved index's finalize() seed set when
        # present (the in-memory answers need the same seeds); otherwise
        # the level >= 1 nodes, evenly subsampled or stride-filled to the
        # budget
        if self.pivot_ids is not None:
            piv = np.asarray(self.pivot_ids, np.int64)
        else:
            piv = np.flatnonzero(self.levels >= 1)
            if piv.size == 0:
                piv = np.arange(min(self.n, max(1, pivots)))
            if piv.size > pivots:
                pick = np.unique(
                    np.linspace(0, piv.size - 1, pivots).round().astype(np.int64))
                piv = piv[pick]
            elif piv.size < min(pivots, self.n):
                stride = np.linspace(
                    0, self.n - 1, min(pivots, self.n)).round().astype(np.int64)
                seen = set(piv.tolist())
                fill = [i for i in stride.tolist() if i not in seen]
                piv = np.concatenate([
                    piv.astype(np.int64),
                    np.asarray(fill[: pivots - piv.size], np.int64)])
        pc, ps = self._codes_scales(piv)
        self._pivot_ids = torch.from_numpy(piv.astype(np.int32)).to(self.device)
        self._pivot_vecs = torch.from_numpy(
            pc.astype(np.float32) * ps[:, 1:2] + ps[:, 0:1]).to(self.device)
        # device_bytes counts the tier (hot rows and slot map, or PQ rows,
        # codes and codebooks), as the JAX package's does; the pivot
        # skeleton both modes share is counted apart
        self.pivot_bytes = int(self._pivot_ids.numel() * 4
                               + self._pivot_vecs.numel() * 4)

        # speculative prefetch state (see above)
        self.prefetch = int(prefetch)
        self._row_cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._row_cache_cap = 0  # sized per batch in ann_batch
        self._row_lock = threading.Lock()
        self._pf_pool = None  # a one-thread pool, made at first use
        self.prefetch_hits = 0

    def close(self) -> None:
        """Stop the prefetch thread and close the block file."""
        if self._pf_pool is not None:
            self._pf_pool.shutdown(wait=True)
            self._pf_pool = None
        super().close()

    def _build_pq_tier(self, pq_m: int, pq_bits: int, pq_iters: int) -> None:
        """Train PQ on a paged subsample, encode every stored point
        (sequential block reads) and pack layer 0's neighbor (code, id)
        rows on the device: the one-time cost of the staging-free mode.
        Codes live in the same quantized space as the in-memory index."""
        from ..ops.pq import encode_pq, pack_nibbles, train_pq
        from ..search import pack_layer_pq

        if pq_bits not in (4, 8):
            raise ValueError(f"pq_bits must be 4 or 8, got {pq_bits}")
        m_sub = pq_m if pq_bits == 8 else 2 * pq_m
        if self.store.dim % m_sub != 0:
            raise ValueError(f"{m_sub} subspaces (pq_m {pq_m} at {pq_bits} bits) "
                             f"must divide dim {self.store.dim}")
        n = self.n
        ts = min(n, 65536)
        pick = np.linspace(0, n - 1, ts).round().astype(np.int64)
        cb = train_pq(torch.from_numpy(self._values(pick)).to(self.device),
                      m_sub, iters=pq_iters, seed=0, nv=1 << pq_bits)
        ch = 1 << 16
        parts = []
        for lo in range(0, n, ch):
            ids = np.arange(lo, min(lo + ch, n), dtype=np.int64)
            parts.append(encode_pq(
                torch.from_numpy(self._values(ids)).to(self.device), cb))
        pq_codes = parts[0] if len(parts) == 1 else torch.cat(parts)
        if pq_bits == 4:
            pq_codes = pack_nibbles(pq_codes)
        self._pq_cb = cb
        self._pq_codes = pq_codes
        self._pq_packed = pack_layer_pq(
            torch.from_numpy(np.array(self.adj0)).to(self.device),
            pq_codes)
        self.device_bytes = int(self._pq_packed.numel() + pq_codes.numel()
                                + cb.numel() * 4)

    def _ann_batch_pq(self, q: np.ndarray, n: int, ef: int, max_iters: int,
                      expand_e: int, rerank: int):
        """PQ-tier query: one ADC beam on the device (no staging per
        iteration), then one disk-paged exact rerank of the top ``rerank``
        survivors per query in numpy (the host flops are small next to
        the block reads)."""
        from ..search import pq_beam

        b = q.shape[0]
        _, beam_ids = pq_beam(
            self._pq_packed, self._pq_cb, self._pq_codes, self._pivot_ids,
            self._pivot_vecs, torch.from_numpy(q).to(self.device), ef,
            max_iters, expand_e)
        r = min(max(n, rerank or ef), int(beam_ids.shape[1]))
        cand = beam_ids[:, :r].cpu().numpy()  # [b, r]: one small fetch
        safe = np.clip(np.where(cand == PAD_ID, 0, cand), 0, self.n - 1)
        vec = self._values(safe.ravel()).reshape(b, r, -1)
        diff = vec - q[:, None, :]
        d2 = np.einsum("brd,brd->br", diff, diff, dtype=np.float32)
        d2 = np.where(cand == PAD_ID, np.inf, d2)
        order = np.lexsort((cand, d2), axis=-1)[:, :n]
        return (np.sqrt(np.take_along_axis(d2, order, 1)),
                np.take_along_axis(cand, order, 1))

    def _cache_rows(self, ids, rows) -> None:
        """Rows into the host row cache, oldest evicted past its cap."""
        with self._row_lock:
            for i, r in zip(ids, rows):
                self._row_cache[int(i)] = r
            while len(self._row_cache) > self._row_cache_cap:
                self._row_cache.popitem(last=False)

    def _prefetch_rows(self, ids: np.ndarray) -> None:
        """Worker-thread body: assemble the packed rows of ``ids`` into
        the host row cache (ids already cached are skipped). Numpy only."""
        with self._row_lock:
            todo = [i for i in ids.tolist() if i not in self._row_cache]
        if todo:
            self._cache_rows(todo, self._packed_rows_host(np.asarray(todo, np.int64)))

    def _cold_rows(self, ids: np.ndarray) -> np.ndarray:
        """Packed rows of cold ids, from the prefetch row cache where
        warm, assembled (and cached) otherwise."""
        out = np.empty((ids.size, self._wrow), np.uint8)
        miss = []
        with self._row_lock:
            for j, i in enumerate(ids.tolist()):
                r = self._row_cache.get(i)
                if r is None:
                    miss.append(j)
                else:
                    self._row_cache.move_to_end(i)
                    out[j] = r
        self.prefetch_hits += ids.size - len(miss)
        if miss:
            rows = self._packed_rows_host(ids[miss])
            out[miss] = rows
            self._cache_rows(ids[miss], rows)
        return out

    def _stage(self, rows: np.ndarray) -> torch.Tensor:
        """Host rows onto the device, through pinned memory on a CUDA
        device so that the copy does not wait for the stream to drain."""
        t = torch.from_numpy(rows)
        if self.device.type == "cuda" and t.numel():
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def ann_batch(self, queries, n: int, ef: int, max_iters: int | None = None,
                  expand_e: int = 1):
        """Batched hybrid query: a device beam over the hot tier, cold
        rows staged per iteration. ``expand_e > 1`` pops the E best
        unexpanded entries per iteration in one pick and one cold staging
        upload: the paged regime's cost per iteration is the host round
        trip (one read of the pops, one upload), so iterations per query
        drop about E-fold at the same recall per ef or better
        (``search._beam_loop``'s E>1 semantics). Returns (distances
        [B, n], ids [B, n]) as numpy arrays."""
        from ..search import _beam_pick, _init_ring, _pivot_seeds, init_beam

        qh = _quantized_queries(queries, self.params.metric)
        ef = max(ef, n)
        if max_iters is None:
            max_iters = 2 * ef + 16
        if self.pq_m:
            return self._ann_batch_pq(qh, n, ef, max_iters, expand_e, 0)
        q = torch.from_numpy(qh).to(self.device)
        b = int(q.shape[0])
        cap = self._cap
        e = max(1, min(int(expand_e), ef))
        ring_size = max(2 * cap, 64, e * cap)

        e_d2, e_ids = _pivot_seeds(self._pivot_ids, self._pivot_vecs, q, ef)
        beam_d2, beam_ids, beam_exp = init_beam(e_d2, e_ids, ef)
        ring = _init_ring(e_ids, ring_size)

        look = max(0, int(self.prefetch))
        pf_pending = None
        if look:
            self._row_cache_cap = max(self._row_cache_cap, 8 * b * max(e, look))
            if self._pf_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pf_pool = ThreadPoolExecutor(
                    1, thread_name_prefix="hyb-prefetch")

        self.dispatches = 0
        for _ in range(max_iters):
            cand, active, beam_exp, spec = _beam_pick(beam_ids, beam_exp, e, look)
            slot = self._slot[cand.clamp(0, self.n - 1).reshape(-1).long()]
            # the iteration's one host read: the pops, which of them are
            # live, and the lookahead
            got = torch.cat([cand.reshape(-1), active.reshape(-1).to(torch.int32),
                             spec.reshape(-1)]).cpu().numpy()
            cand_h, act_h, spec_h = got[:b * e], got[b * e:2 * b * e] != 0, got[2 * b * e:]
            if not act_h.any():
                break
            self.dispatches += 1
            cold_lanes = np.flatnonzero(
                act_h & (self._slot_host[np.clip(cand_h, 0, self.n - 1)] < 0))
            self.misses += int(cold_lanes.size)
            self.hits += int(act_h.sum()) - int(cold_lanes.size)
            # compact cold staging: exactly the cold lanes' rows go up
            rows_cold = np.zeros((0, self._wrow), np.uint8)
            if cold_lanes.size:
                if pf_pending is not None:
                    pf_pending.result()  # rows may still be in flight
                    pf_pending = None
                rows_cold = (self._cold_rows(cand_h[cold_lanes]) if look
                             else self._packed_rows_host(cand_h[cold_lanes]))
            beam_d2, beam_ids, beam_exp, ring = _hyb_expand(
                self._hot_packed, slot, self._stage(rows_cold),
                self._stage(cold_lanes.astype(np.int64)), beam_d2, beam_ids,
                beam_exp, ring, q, active, cap, self._d, e)
            if look:
                # speculative staging: the worker thread assembles the
                # lookahead candidates' cold rows while the device expands
                spec_h = spec_h[(spec_h >= 0) & (spec_h < self.n)]
                spec_cold = spec_h[self._slot_host[spec_h] < 0]
                if spec_cold.size:
                    if pf_pending is not None:
                        pf_pending.result()  # every future's result is read
                    pf_pending = self._pf_pool.submit(
                        self._prefetch_rows, np.unique(spec_cold))
        if pf_pending is not None:
            pf_pending.result()
        return (torch.sqrt(beam_d2[:, :n]).cpu().numpy(),
                beam_ids[:, :n].cpu().numpy())
