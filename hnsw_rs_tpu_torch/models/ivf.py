"""IVF-Flat: inverted-file index with exact in-list distances (port of
``hnsw_rs_tpu/models/ivf.py``).

HNSW's per-neighbor row gathers are latency bound; IVF reads whole
contiguous cluster blocks instead:

1. coarse quantizer: k-means centroids trained on the device (batched
   Lloyd's iterations: assignment is one product and an argmin, the
   update one product with the one-hot assignment);
2. storage: points sorted by list, each list padded to a shared width, so
   a probe is one [Lmax, d] block load. Blocks hold u8 codes and
   per-point scales by default; ``quantized_blocks=False`` keeps a
   dequantized f32 copy instead. Distances are the same either way
   (dequantization is exact);
3. search: centroid distances [B, C], the ``n_probe`` nearest lists,
   their blocks gathered and scored in the direct form, a (dist, id)
   top-k.

Incremental :meth:`IVFFlatIndex.add` after training is amortized O(1) per
vector: new rows are scattered into per-list tail slots of
capacity-grown block buffers (a full repack happens only when some list
outgrows the shared width). :meth:`IVFFlatIndex.retrain` re-runs k-means
over everything stored; ``save``/``load`` use the JAX package's
``hnsw_rs_tpu.ivf.v1`` format, so either package loads the other's
directory.

Where the JAX package scatter-adds each list's members in Lloyd's step,
:func:`_kmeans` multiplies by the one-hot assignment in row chunks:
``index_add_`` on a GPU sums with atomics in no fixed order, a product
sums in one order every time, so the centroids are the same run after
run.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..build_cluster import kmeans as _kmeans_chunked
from ..errors import DimensionMismatch
from ..ops.distance import l2sq, normalize
from ..ops.quant import dequantize, quantize
from ..ops.topk import INF, PAD_ID, sort_dist_id, topk_dist_id, topk_lowest
from ..search import _query_chunk
from ..utils.logging import span

FORMAT = "hnsw_rs_tpu.ivf.v1"
# Dense Lloyd holds an [N, C] f32 distance block per step (here in row
# chunks, but the work is still N * C * d); past this many bytes the
# coarse quantizer goes through the cluster-bulk build's subsampled kmeans
# (build_cluster.kmeans). Module-level so tests can force that path.
DENSE_KMEANS_LIMIT = 1 << 30
# One-shot [B, p, Lmax, d] f32 scoring temp cap of _ivf_search: under it
# every probed list is scored in one pass and the results get one exact
# (d2, id) sort; above it the scanned path takes over.
DENSE_IVF_SEARCH_LIMIT = 1 << 30
_SCAN_TEMP = 1 << 29  # the scanned path's [B, chunk, d] f32 scoring temp
_ROW_CHUNK_BYTES = 1 << 28  # Lloyd's [rows, C] f32 blocks


def _sq_dists(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Expanded-form squared distances [rows, C] (not clamped)."""
    return ((x * x).sum(dim=1, keepdim=True) - 2.0 * (x @ cent.T)
            + (cent * cent).sum(dim=1)[None, :])


def _argmin_first(d2: torch.Tensor) -> torch.Tensor:
    """Position of each row's minimum, the lowest among equal minima
    (``jnp.argmin``'s rule), taken as the minimum of (value, position)."""
    c = d2.shape[1]
    iota = torch.arange(c, device=d2.device)[None, :]
    return torch.where(d2 == d2.amin(dim=1, keepdim=True), iota, c).amin(dim=1)


def _row_chunk(n: int, c: int) -> int:
    return max(1, min(n, _ROW_CHUNK_BYTES // (max(c, 1) * 4)))


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment i32[N] (the JAX package's
    ``_assign_jit``): one product and an argmin per chunk of rows."""
    n, c = x.shape[0], centroids.shape[0]
    ch = _row_chunk(n, c)
    out = [_argmin_first(_sq_dists(x[lo:lo + ch], centroids))
           for lo in range(0, n, ch)]
    return torch.cat(out).to(torch.int32) if out else torch.zeros(
        0, dtype=torch.int32, device=x.device)


def _kmeans(x: torch.Tensor, init_idx: torch.Tensor, c: int, iters: int):
    """Batched Lloyd's k-means on the device of ``x``: f32[N, d] ->
    (centroids f32[c, d], assignment i32[N]). Empty clusters keep their
    previous centroid. The member sums are one-hot products over chunks of
    rows, accumulated in row order: the same centroids on every run."""
    n = x.shape[0]
    cent = x[init_idx.long()]
    ch = _row_chunk(n, c)
    for _ in range(iters):
        sums = torch.zeros_like(cent)
        counts = torch.zeros(c, dtype=torch.float32, device=x.device)
        for lo in range(0, n, ch):
            xc = x[lo:lo + ch]
            a = _argmin_first(_sq_dists(xc, cent))
            onehot = torch.nn.functional.one_hot(a, c).to(torch.float32)
            sums += onehot.T @ xc
            counts += onehot.sum(dim=0)
        cent = torch.where(counts[:, None] > 0,
                           sums / counts.clamp_min(1.0)[:, None], cent)
    return cent, _assign(x, cent)


def _coarse_kmeans(codes, scales, c: int, iters: int, seed: int):
    """Coarse-quantizer k-means, dispatched by size: the dense batched
    Lloyd (seeded random init) under ``DENSE_KMEANS_LIMIT``, the cluster
    build's subsampled, chunked kmeans above it (evenly strided init).
    Returns (centroids f32[c, d], assign i32[N])."""
    n = codes.shape[0]
    if n * c * 4 > DENSE_KMEANS_LIMIT:
        return _kmeans_chunked(codes, scales, c, iters=iters)
    x = dequantize(codes, scales)
    rng = np.random.default_rng(seed)
    init = torch.from_numpy(rng.choice(n, size=c, replace=False)).to(x.device)
    return _kmeans(x, init, c, iters)


def _probe_lists(q, centroids, n_probe: int) -> torch.Tensor:
    """The ``n_probe`` nearest lists of each query, i64[B, p], nearest
    first, equal distances by list position."""
    return topk_lowest(_sq_dists(q, centroids), n_probe)[1]


def _ivf_search(q, centroids, blocks, bscales, block_ids, n_probe: int, k: int):
    """q f32[B, d]; blocks u8/f32[C, Lmax, d]; bscales f32[C, Lmax, 2] or
    None (f32 blocks); block_ids i32[C, Lmax]. Returns (sqrt(d2) [B, k],
    ids [B, k]).

    Small shapes score every probed list in one pass and sort once by
    (d2, id): full probe then equals the exact search. Large shapes scan
    one probed list per step: the probed block is gathered once as it is
    stored, dequantized and scored in slices of at most ``_SCAN_TEMP``
    bytes, and merged into the running top-k by the exact two-key order.
    On a CUDA device the scanned path also runs over sub-batches of
    queries sized from the free memory."""
    b, d = q.shape
    lmax = blocks.shape[1]
    if b * n_probe * lmax * d * 4 <= DENSE_IVF_SEARCH_LIMIT:
        probe = _probe_lists(q, centroids, n_probe)
        cand = blocks[probe]  # [B, p, Lmax, d]: whole blocks
        ids = block_ids[probe].reshape(b, n_probe * lmax)
        if bscales is not None:
            cand = dequantize(cand, bscales[probe])
        d2 = l2sq(q[:, None, None, :], cand).reshape(b, n_probe * lmax)
        d2 = torch.where(ids >= 0, d2, INF)
        ids = torch.where(ids >= 0, ids, PAD_ID)
        sd, si = sort_dist_id(d2, ids)
        return torch.sqrt(sd[:, :k]), si[:, :k]

    # per query: the gathered block with scales and ids, the merge's
    # copies of [k + Lmax] entries; the scoring slices are capped apart
    step = _query_chunk(b, lmax * (d + 12) + (k + lmax) * 48, q.device)
    outs = [_ivf_scan(q[lo:lo + step], centroids, blocks, bscales, block_ids,
                      n_probe, k) for lo in range(0, b, step)]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _ivf_scan(q, centroids, blocks, bscales, block_ids, n_probe: int, k: int):
    """The scanned branch of :func:`_ivf_search` for one sub-batch: a loop
    of ``n_probe`` steps with no host read inside it."""
    b, d = q.shape
    lmax = blocks.shape[1]
    probe = _probe_lists(q, centroids, n_probe)
    ch = min(lmax, max(64, _SCAN_TEMP // max(b * d * 4, 1)))
    bd = torch.full((b, k), INF, dtype=torch.float32, device=q.device)
    bi = torch.full((b, k), PAD_ID, dtype=torch.int32, device=q.device)
    for pi in range(n_probe):
        li = probe[:, pi]
        cand = blocks[li]  # [B, Lmax, d] as stored: one block per query
        sc = None if bscales is None else bscales[li]
        ids = block_ids[li]
        parts = []
        for c0 in range(0, lmax, ch):
            candc = cand[:, c0:c0 + ch]
            if sc is not None:
                candc = dequantize(candc, sc[:, c0:c0 + ch])
            parts.append(l2sq(q[:, None, :], candc))
        d2 = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        d2 = torch.where(ids >= 0, d2, INF)
        ids = torch.where(ids >= 0, ids, PAD_ID)
        bd, bi = topk_dist_id(torch.cat([bd, d2], dim=1),
                              torch.cat([bi, ids], dim=1), k)
    return torch.sqrt(bd), bi


def _tail_slots(assign: np.ndarray, counts: np.ndarray):
    """Per-list tail positions of a batch of new rows: (order, lists,
    slots) with ``order`` the stable sort of the batch by list, ``lists``
    the sorted list ids and ``slots[i] = counts[list] + rank of the row
    among the batch's rows of the same list``."""
    n_new = assign.shape[0]
    order = np.argsort(assign, kind="stable")
    srt = assign[order]
    idx = np.arange(n_new, dtype=np.int64)
    first = np.r_[True, srt[1:] != srt[:-1]] if n_new else np.zeros(0, bool)
    grp_start = np.maximum.accumulate(np.where(first, idx, 0))
    return order, srt, counts[srt] + (idx - grp_start)


def _list_layout(assign: np.ndarray, c: int):
    """Sorted-by-list layout of ``assign`` i32[N]: (order, lists, slots,
    counts, lmax), the padded width with ~25% headroom so that later adds
    scatter into tail slots instead of repacking."""
    n = assign.shape[0]
    order = np.argsort(assign, kind="stable")
    srt = assign[order]
    counts = np.bincount(srt, minlength=c)
    starts = np.zeros(c + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(n, dtype=np.int64) - starts[srt]
    lmax = max(1, int(counts.max()))
    lmax += min(max(lmax // 4, 8), 1024)
    return order, srt, within, counts, lmax


class IVFFlatIndex:
    """Inverted-file index with exact (quantized-space) distances, held on
    ``device``."""

    def __init__(self, dim: int, n_lists: int = 0, n_probe: int = 8,
                 kmeans_iters: int = 10, seed: int = 0, metric: str = "l2",
                 quantized_blocks: bool = True, *,
                 device: torch.device | str):
        if metric not in ("l2", "cosine"):
            raise ValueError(f"unknown metric {metric!r}")
        self.metric = metric
        self.dim = int(dim)
        self.device = torch.device(device)
        self.n_lists = int(n_lists)
        self.n_probe = int(n_probe)
        self.kmeans_iters = int(kmeans_iters)
        self.seed = seed
        self.quantized_blocks = quantized_blocks
        self.centroids = None  # f32[C, d]
        self.blocks = None  # u8 (or f32) [C, Lmax, d]
        self.bscales = None  # f32[C, Lmax, 2] when quantized_blocks
        self.block_ids = None  # i32[C, Lmax]
        self.codes = None  # u8[cap, d]: what repacks and saves read
        self.scales = None  # f32[cap, 2]
        self._assign = None  # i32[N] list assignment, on the host
        self._counts = None  # i64[C] live entries per list
        self._n = 0  # live rows in codes/scales (capacity-padded buffers)
        # seconds per build phase of the last train_add
        self.build_phase_s: dict[str, float] = {}

    def __len__(self) -> int:
        return self._n

    # -- construction --------------------------------------------------

    def train_add(self, vectors) -> np.ndarray:
        """Train the coarse quantizer and add all vectors (bulk build).
        Quantization runs on the device; the codes come back to the host
        once, for the repack."""
        self.build_phase_s = phases = {}
        with span("ivf.build.quantize", phases, self.device):
            x = self._prep(vectors)
            n = x.shape[0]
            if self.n_lists <= 0:
                self.n_lists = max(1, int(np.sqrt(n)))
            c = min(self.n_lists, n)
            self.n_lists = c
            self.codes, self.scales = quantize(x)
            del x
            self._n = n
        with span("ivf.build.kmeans", phases, self.device):
            cent, assign = _coarse_kmeans(self.codes, self.scales, c,
                                          self.kmeans_iters, self.seed)
            self.centroids = cent
            self._assign = assign.cpu().numpy()
        with span("ivf.build.pack", phases, self.device):
            self._pack()
        return np.arange(n, dtype=np.int32)

    def add(self, vectors) -> np.ndarray:
        """Incremental add after training, amortized O(1) per vector.

        Each new vector is assigned to its nearest centroid and scattered
        into its list's tail slot on the device; the world is never
        repacked. The row buffer grows by doubling, and the shared
        per-list block width grows geometrically when some list fills.
        Ids are stable row positions. On an untrained index this is
        :meth:`train_add`."""
        if self.centroids is None:
            return self.train_add(vectors)
        x = self._prep(vectors)
        n_new = x.shape[0]
        codes, scales = quantize(x)
        assign = _assign(dequantize(codes, scales), self.centroids).cpu().numpy()
        start = self._n

        cap = int(self.codes.shape[0])
        if start + n_new > cap:
            new_cap = max(start + n_new, 2 * cap)
            self.codes = torch.cat([self.codes, self.codes.new_zeros(
                (new_cap - cap, self.dim))])
            pad_sc = torch.tensor([[0.0, 1.0]], device=self.device).repeat(
                new_cap - cap, 1)
            self.scales = torch.cat([self.scales, pad_sc])
        self.codes[start:start + n_new] = codes
        self.scales[start:start + n_new] = scales
        self._assign = np.concatenate([self._assign, assign])
        self._n += n_new

        order, srt, within = _tail_slots(assign, self._counts)
        if within.size and int(within.max()) >= int(self.blocks.shape[1]):
            self._grow_blocks(int(within.max()) + 1)
        rows = torch.from_numpy(srt.astype(np.int64)).to(self.device)
        slots = torch.from_numpy(within.astype(np.int64)).to(self.device)
        order_t = torch.from_numpy(order).to(self.device)
        if self.quantized_blocks:
            self.blocks[rows, slots] = codes[order_t]
            self.bscales[rows, slots] = scales[order_t]
        else:
            self.blocks[rows, slots] = dequantize(codes, scales)[order_t]
        self.block_ids[rows, slots] = (start + order_t).to(torch.int32)
        np.add.at(self._counts, assign, 1)
        return np.arange(start, start + n_new, dtype=np.int32)

    def _grow_blocks(self, need: int) -> None:
        """Widen the shared per-list block width geometrically (pad rows
        keep id -1 and the identity scale, so the search masks them as
        before)."""
        old = int(self.blocks.shape[1])
        pad = max(need, 2 * old, 8) - old
        c = self.blocks.shape[0]
        self.blocks = torch.cat(
            [self.blocks, self.blocks.new_zeros((c, pad, self.dim))], dim=1)
        if self.bscales is not None:
            ident = torch.tensor([0.0, 1.0], device=self.device).expand(c, pad, 2)
            self.bscales = torch.cat([self.bscales, ident], dim=1)
        self.block_ids = torch.cat(
            [self.block_ids, self.block_ids.new_full((c, pad), -1)], dim=1)

    def retrain(self, kmeans_iters: int | None = None) -> "IVFFlatIndex":
        """Re-run k-means over everything stored (the distribution has
        drifted after many :meth:`add` calls) and repack. Ids stay."""
        if self._n == 0:
            raise ValueError("nothing stored to retrain on")
        x = dequantize(self.codes[: self._n], self.scales[: self._n])
        rng = np.random.default_rng(self.seed + 1)
        c = min(self.n_lists, self._n)
        self.n_lists = c
        init = torch.from_numpy(
            rng.choice(self._n, size=c, replace=False)).to(self.device)
        cent, assign = _kmeans(x, init, c, kmeans_iters or self.kmeans_iters)
        self.centroids = cent
        self._assign = assign.cpu().numpy()
        self._pack()
        return self

    def _prep(self, vectors) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(vectors, np.float32), device=self.device)
        x = torch.atleast_2d(x)
        if x.shape[-1] != self.dim:
            raise DimensionMismatch(f"index dim {self.dim}, got {x.shape[-1]}")
        return normalize(x) if self.metric == "cosine" else x

    def _pack(self) -> None:
        """Repack codes and scales into padded per-list blocks (sorted by
        list, position = (list, rank within the list)) on the host in
        numpy, then upload."""
        c, n, d = self.n_lists, self._n, self.dim
        order, srt, within, counts, lmax = _list_layout(self._assign[:n], c)
        bids = np.full((c, lmax), -1, np.int32)
        bids[srt, within] = order.astype(np.int32)
        codes_np = self.codes[:n].cpu().numpy()
        scales_np = self.scales[:n].cpu().numpy()
        if self.quantized_blocks:
            blocks = np.zeros((c, lmax, d), np.uint8)
            bsc = np.zeros((c, lmax, 2), np.float32)
            bsc[..., 1] = 1.0  # identity scale on pad rows
            blocks[srt, within] = codes_np[order]
            bsc[srt, within] = scales_np[order]
            self.bscales = torch.from_numpy(bsc).to(self.device)
        else:
            blocks = np.zeros((c, lmax, d), np.float32)
            deq = codes_np.astype(np.float32) * scales_np[:, 1:2] + scales_np[:, 0:1]
            blocks[srt, within] = deq[order]
            self.bscales = None
        self.blocks = torch.from_numpy(blocks).to(self.device)
        self.block_ids = torch.from_numpy(bids).to(self.device)
        self._counts = counts.astype(np.int64)

    # -- persistence ----------------------------------------------------

    def to_numpy(self) -> tuple[dict, dict[str, np.ndarray]]:
        """The ``params.json`` dict and the npz arrays :meth:`save` writes
        (``codes``, ``scales``, ``assign`` and, once trained,
        ``centroids``): the live rows only."""
        n = self._n
        meta = {
            "format": FORMAT, "dim": self.dim, "n_lists": self.n_lists,
            "n_probe": self.n_probe, "kmeans_iters": self.kmeans_iters,
            "seed": self.seed, "metric": self.metric,
            "quantized_blocks": self.quantized_blocks, "n": n,
        }
        arrays = {}
        if self.codes is not None:
            arrays = {"codes": self.codes[:n].cpu().numpy(),
                      "scales": self.scales[:n].cpu().numpy(),
                      "assign": np.asarray(self._assign)[:n]}
        if self.centroids is not None:
            arrays["centroids"] = self.centroids.cpu().numpy()
        return meta, arrays

    @classmethod
    def from_numpy(cls, meta: dict, arrays,
                   device: torch.device | str) -> "IVFFlatIndex":
        """An index from the ``params.json`` dict and npz arrays either
        package's ``save`` writes: the trained quantizer is taken as it
        is (k-means is not re-run) and the blocks are repacked from the
        codes and the assignment."""
        if meta.get("format") != FORMAT:
            raise ValueError(f"unknown index format {meta.get('format')!r}")
        index = cls(meta["dim"], n_lists=meta["n_lists"],
                    n_probe=meta["n_probe"], kmeans_iters=meta["kmeans_iters"],
                    seed=meta["seed"], metric=meta["metric"],
                    quantized_blocks=meta["quantized_blocks"], device=device)
        dev = index.device
        index.codes = torch.tensor(np.asarray(arrays["codes"], np.uint8), device=dev)
        index.scales = torch.tensor(np.asarray(arrays["scales"], np.float32),
                                    device=dev)
        index._assign = np.array(arrays["assign"], np.int32)
        if "centroids" in arrays:
            index.centroids = torch.tensor(
                np.asarray(arrays["centroids"], np.float32), device=dev)
        index._n = int(meta["n"])
        if index.centroids is not None and index._n:
            index._pack()
        return index

    def save(self, path: str) -> None:
        """Checkpoint to a directory (``params.json`` + ``arrays.npz``).
        The trained centroids and the list assignment are saved, so
        :meth:`load` never re-runs k-means."""
        meta, arrays = self.to_numpy()
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "params.json"), "w") as f:
            json.dump(meta, f, indent=2)
        np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)

    @classmethod
    def load(cls, path: str, device: torch.device | str) -> "IVFFlatIndex":
        """Restore from either package's :meth:`save`."""
        with open(os.path.join(path, "params.json")) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT:
            raise ValueError(f"unknown index format in {path}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return cls.from_numpy(meta, arrays, device)

    # -- queries --------------------------------------------------------

    def _prep_queries(self, queries) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        x = torch.atleast_2d(x)
        if self.metric == "cosine":
            x = normalize(x)
        return dequantize(*quantize(x))

    def search(self, queries, k: int, n_probe: int | None = None):
        """Batched top-k: (distances [B, k], ids [B, k]) as numpy arrays."""
        if self.centroids is None:
            raise ValueError("index is untrained: call train_add/add first")
        q = self._prep_queries(queries)
        p = min(n_probe or self.n_probe, self.n_lists)
        d, i = _ivf_search(q, self.centroids, self.blocks, self.bscales,
                           self.block_ids, p, k)
        return d.cpu().numpy(), i.cpu().numpy()
