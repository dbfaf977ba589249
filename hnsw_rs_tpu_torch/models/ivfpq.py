"""IVF-PQ: inverted file + product quantization, the memory axis (port of
``hnsw_rs_tpu/models/ivfpq.py``): PQ stores ``m_pq`` bytes per point
where the u8 codes store one byte per dimension.

- coarse quantizer: k-means centroids trained on the device (shared with
  ``models.ivf``);
- product quantizer: the residual (x - coarse centroid) is split into
  ``m_pq`` subspaces; each gets a 256-entry codebook, all trained at once
  (``ops.pq.pq_train``). Storage per point: ``m_pq`` code bytes and 4 id
  bytes;
- search (ADC): per query and probed list the distance decomposes as
  ``d2(q, x) ~ sum_m |(q - centroid)_m - cb_m[c_m]|^2``, which needs only
  the per-subspace table ``LUT[b, m, v]`` (one batched product against
  the codebooks) and a table take along the code axis. Optionally the top
  ``rerank`` ADC candidates are re-scored exactly against the u8 codes
  kept on the device (``keep_codes=True``).

ADC is an approximation: the recall / speed / memory trade is the point.
``save``/``load`` use the JAX package's ``hnsw_rs_tpu.ivfpq.v1`` format;
``load`` re-encodes the PQ codes from the saved u8 codes and codebooks.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..errors import DimensionMismatch
from ..ops.distance import l2sq, normalize
from ..ops.pq import opq_train, pq_encode, pq_train
from ..ops.quant import dequantize, quantize
from ..ops.topk import INF, PAD_ID, sort_dist_id, topk_dist_id
from ..search import _query_chunk
from ..utils.logging import span
from .ivf import _assign, _coarse_kmeans, _list_layout, _probe_lists, _tail_slots

FORMAT = "hnsw_rs_tpu.ivfpq.v1"
# PQ codebook training subsample cap (see train_add): Lloyd's step and the
# encoder both hold [rows, m_pq, 256]-shaped temps.
_PQ_TRAIN_MAX = 65536
_ENCODE_CHUNK = 1 << 16
_TAKE_TEMP = 1 << 29  # the [B, m, chunk] table-take temp of one scan step


def _ivfpq_search(q, centroids, codebooks, blocks, block_ids, rot,
                  n_probe: int, k: int):
    """ADC search. q f32[B, d]; codebooks f32[m_pq, 256, ds]; blocks
    u8[C, Lmax, m_pq]; block_ids i32[C, Lmax]; ``rot`` f32[d, d] OPQ
    rotation (identity when disabled: residuals are scored in the rotated
    space, where ``(q - c) @ R = qR - cR`` lets both operands be rotated
    once outside the probe loop). Returns (sqrt(d2) [B, k], ids [B, k]).

    One probed list per step with a running sorted top-k merge, a loop of
    ``n_probe`` steps with no host read inside it. On a CUDA device the
    queries go through in sub-batches sized from the free memory."""
    b = q.shape[0]
    m_pq, nv, _ = codebooks.shape
    lmax = blocks.shape[1]
    cbn = (codebooks * codebooks).sum(-1)  # [m_pq, nv]
    centr = centroids @ rot
    # per query: the table, the gathered block and ids, the merge's copies
    step = _query_chunk(b, m_pq * nv * 12 + lmax * (m_pq + 4)
                        + (k + lmax) * 48, q.device)
    outs = [_ivfpq_scan(q[lo:lo + step], centroids, centr, codebooks, cbn,
                        blocks, block_ids, rot, n_probe, k)
            for lo in range(0, b, step)]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _ivfpq_scan(q, centroids, centr, codebooks, cbn, blocks, block_ids, rot,
                n_probe: int, k: int):
    b = q.shape[0]
    m_pq, _, ds = codebooks.shape
    lmax = blocks.shape[1]
    probe = _probe_lists(q, centroids, n_probe)
    qr = q @ rot
    # the take's temp per cell: an i64 index and an f32 value
    ch = min(lmax, max(64, _TAKE_TEMP // max(b * m_pq * 12, 1)))
    bd = torch.full((b, k), INF, dtype=torch.float32, device=q.device)
    bi = torch.full((b, k), PAD_ID, dtype=torch.int32, device=q.device)
    for pi in range(n_probe):
        pl = probe[:, pi]
        rs = (qr - centr[pl]).reshape(b, m_pq, ds)  # rotated residual
        cross = torch.einsum("bms,mvs->bmv", rs, codebooks)
        lut = (rs * rs).sum(-1)[..., None] - 2.0 * cross + cbn[None]
        cand = blocks[pl]  # [B, Lmax, m_pq] u8: one block per query
        cand_ids = block_ids[pl]
        parts = []
        for c0 in range(0, lmax, ch):
            idx = cand[:, c0:c0 + ch].long().transpose(1, 2)  # [B, m, ch]
            parts.append(lut.gather(2, idx).sum(dim=1).clamp_min(0.0))
        d2 = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        d2 = torch.where(cand_ids >= 0, d2, INF)
        ids = torch.where(cand_ids >= 0, cand_ids, PAD_ID)
        bd, bi = topk_dist_id(torch.cat([bd, d2], dim=1),
                              torch.cat([bi, ids], dim=1), k)
    return torch.sqrt(bd), bi


def _rerank(q, codes, scales, cand_d, cand_ids, k: int):
    """Exact re-score of ADC candidates against the u8 code table, over
    chunks of queries (the gathered [b, R, d] rows are the temp)."""
    b, r = cand_ids.shape
    pad = cand_ids == PAD_ID
    safe = torch.where(pad, 0, cand_ids).clamp(0, codes.shape[0] - 1).long()
    d2 = torch.empty((b, r), dtype=torch.float32, device=q.device)
    step = _query_chunk(b, r * q.shape[1] * 13, q.device)
    for lo in range(0, b, step):
        s = safe[lo:lo + step]
        d2[lo:lo + step] = l2sq(q[lo:lo + step, None, :],
                                dequantize(codes[s], scales[s]))
    d2 = torch.where(pad, INF, d2)
    sd, si = sort_dist_id(d2, cand_ids)
    return torch.sqrt(sd[:, :k]), si[:, :k]


class IVFPQIndex:
    """Inverted file with product-quantized residual storage, held on
    ``device``."""

    def __init__(self, dim: int, n_lists: int = 0, m_pq: int = 16,
                 n_probe: int = 8, kmeans_iters: int = 10, pq_iters: int = 12,
                 rerank: int = 0, keep_codes: bool | None = None,
                 seed: int = 0, metric: str = "l2", opq: bool = False,
                 opq_iters: int = 6, *, device: torch.device | str):
        if metric not in ("l2", "cosine"):
            raise ValueError(f"unknown metric {metric!r}")
        if dim % m_pq != 0:
            raise ValueError(f"m_pq {m_pq} must divide dim {dim}")
        self.metric = metric
        self.dim = int(dim)
        self.device = torch.device(device)
        self.m_pq = int(m_pq)
        self.n_lists = int(n_lists)
        self.n_probe = int(n_probe)
        self.kmeans_iters = int(kmeans_iters)
        self.pq_iters = int(pq_iters)
        self.rerank = int(rerank)
        # keep the exact u8 codes on the device for reranking (on by
        # default when rerank > 0); otherwise they live on the host
        self.keep_codes = bool(rerank) if keep_codes is None else keep_codes
        self.seed = seed
        # OPQ: a learned orthogonal rotation applied to residuals before
        # the subspace split (ops.pq.opq_train); identity when disabled
        self.opq = bool(opq)
        self.opq_iters = int(opq_iters)
        self.rot = None  # f32[d, d]
        self.centroids = None  # f32[C, d]
        self.codebooks = None  # f32[m_pq, 256, ds]
        self.blocks = None  # u8[C, Lmax, m_pq]
        self.block_ids = None  # i32[C, Lmax]
        self.codes = None  # u8[N, d]: a tensor on the device if keep_codes,
        self.scales = None  # f32[N, 2]  else numpy arrays on the host
        self._assign = None
        self._n = 0
        # seconds per build phase of the last train_add
        self.build_phase_s: dict[str, float] = {}

    def __len__(self) -> int:
        return self._n

    # -- construction --------------------------------------------------

    def train_add(self, vectors) -> np.ndarray:
        self.build_phase_s = phases = {}
        with span("ivfpq.build.coarse", phases, self.device):
            x = self._prep(vectors)
            n = x.shape[0]
            if self.n_lists <= 0:
                self.n_lists = max(1, int(np.sqrt(n)))
            c = min(self.n_lists, n)
            self.n_lists = c
            codes, scales = quantize(x)
            self._n = n
            x = dequantize(codes, scales)
            rng = np.random.default_rng(self.seed)
            cent, assign = _coarse_kmeans(codes, scales, c, self.kmeans_iters,
                                          self.seed)
            self.centroids = cent
            self._assign = assign.cpu().numpy()
        with span("ivfpq.build.pq_train", phases, self.device):
            res_flat = x - cent[assign.long()]  # [n, d] residuals
            del x
            # past _PQ_TRAIN_MAX rows the codebooks train on an evenly
            # strided subsample: Lloyd's step holds [m_pq, Ntrain, 256]
            # temps, and 64k samples train codebooks to the same distortion
            ts = min(n, _PQ_TRAIN_MAX)
            ds_sub = self.dim // self.m_pq
            if self.opq:
                self.rot, self.codebooks = opq_train(
                    res_flat, self.m_pq, pq_iters=self.pq_iters,
                    opq_iters=self.opq_iters, seed=self.seed, train_n=ts)
                res_flat = res_flat @ self.rot
            else:
                self.rot = torch.eye(self.dim, dtype=torch.float32,
                                     device=self.device)
                res_train = res_flat
                if ts < n:
                    pick = np.linspace(0, n - 1, ts).round().astype(np.int64)
                    res_train = res_flat[torch.from_numpy(pick).to(self.device)]
                pq_init = rng.choice(ts, size=min(256, ts), replace=False)
                if ts < 256:  # tiny collections: repeat row 0 to fill the codebook
                    pq_init = np.concatenate([pq_init,
                                              np.zeros(256 - ts, np.int64)])
                self.codebooks = pq_train(
                    res_train.reshape(ts, self.m_pq, ds_sub),
                    torch.from_numpy(pq_init).to(self.device), self.pq_iters)
                del res_train
        with span("ivfpq.build.encode", phases, self.device):
            pq_codes = self._encode(res_flat)
            del res_flat
        with span("ivfpq.build.pack", phases, self.device):
            self._pack(pq_codes)
            self._store_codes(codes, scales)
        return np.arange(n, dtype=np.int32)

    def _encode(self, res_flat: torch.Tensor) -> np.ndarray:
        """PQ codes u8[n, m_pq] of (rotated) residuals, in row chunks for
        the encoder's [rows, m_pq, 256] temp; on the host for the repack."""
        ds_sub = self.dim // self.m_pq
        return np.concatenate([
            pq_encode(res_flat[s:s + _ENCODE_CHUNK].reshape(-1, self.m_pq, ds_sub),
                      self.codebooks).cpu().numpy()
            for s in range(0, res_flat.shape[0], _ENCODE_CHUNK)])

    def _store_codes(self, codes: torch.Tensor, scales: torch.Tensor) -> None:
        if self.keep_codes:
            self.codes, self.scales = codes, scales
        else:  # spill to host memory
            self.codes, self.scales = codes.cpu().numpy(), scales.cpu().numpy()

    def _device_codes(self):
        """The exact code table as tensors on the device (uploaded when it
        lives on the host)."""
        if isinstance(self.codes, torch.Tensor):
            return self.codes, self.scales
        return (torch.from_numpy(self.codes).to(self.device),
                torch.from_numpy(self.scales).to(self.device))

    def add(self, vectors) -> np.ndarray:
        """Incremental add: assign to the coarse list, PQ-encode the
        residual, scatter into the list's tail (the codebooks are not
        retrained)."""
        if self.centroids is None:
            return self.train_add(vectors)
        xin = self._prep(vectors)
        n_new = xin.shape[0]
        codes, scales = quantize(xin)
        x = dequantize(codes, scales)
        assign_t = _assign(x, self.centroids)
        assign = assign_t.cpu().numpy()
        pq_codes = self._encode((x - self.centroids[assign_t.long()]) @ self.rot)
        start = self._n
        if self.keep_codes:
            self.codes = torch.cat([self.codes, codes])
            self.scales = torch.cat([self.scales, scales])
        else:
            self.codes = np.concatenate([self.codes, codes.cpu().numpy()])
            self.scales = np.concatenate([self.scales, scales.cpu().numpy()])
        counts = np.bincount(self._assign[:start], minlength=self.n_lists)
        self._assign = np.concatenate([self._assign, assign])
        self._n += n_new

        order, srt, within = _tail_slots(assign, counts)
        lmax = int(self.blocks.shape[1])
        if within.size and int(within.max()) >= lmax:
            pad = max(int(within.max()) + 1, 2 * lmax) - lmax
            c = self.blocks.shape[0]
            self.blocks = torch.cat(
                [self.blocks, self.blocks.new_zeros((c, pad, self.m_pq))], dim=1)
            self.block_ids = torch.cat(
                [self.block_ids, self.block_ids.new_full((c, pad), -1)], dim=1)
        rows = torch.from_numpy(srt.astype(np.int64)).to(self.device)
        slots = torch.from_numpy(within.astype(np.int64)).to(self.device)
        self.blocks[rows, slots] = torch.from_numpy(pq_codes[order]).to(self.device)
        self.block_ids[rows, slots] = torch.from_numpy(
            (start + order).astype(np.int32)).to(self.device)
        return np.arange(start, start + n_new, dtype=np.int32)

    def _prep(self, vectors) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(vectors, np.float32), device=self.device)
        x = torch.atleast_2d(x)
        if x.shape[-1] != self.dim:
            raise DimensionMismatch(f"index dim {self.dim}, got {x.shape[-1]}")
        return normalize(x) if self.metric == "cosine" else x

    def _pack(self, pq_codes: np.ndarray) -> None:
        """PQ codes into padded per-list blocks, on the host in numpy."""
        c = self.n_lists
        order, srt, within, _, lmax = _list_layout(self._assign[: self._n], c)
        blocks = np.zeros((c, lmax, self.m_pq), np.uint8)
        bids = np.full((c, lmax), -1, np.int32)
        blocks[srt, within] = pq_codes[order]
        bids[srt, within] = order.astype(np.int32)
        self.blocks = torch.from_numpy(blocks).to(self.device)
        self.block_ids = torch.from_numpy(bids).to(self.device)

    # -- queries --------------------------------------------------------

    def search(self, queries, k: int, n_probe: int | None = None,
               rerank: int | None = None):
        """Batched approximate top-k through ADC, as numpy arrays; the top
        ``rerank`` ADC candidates are optionally re-scored exactly (needs
        ``keep_codes``)."""
        if self.centroids is None:
            raise ValueError("index is untrained: call train_add/add first")
        x = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        x = torch.atleast_2d(x)
        if self.metric == "cosine":
            x = normalize(x)
        q = dequantize(*quantize(x))
        p = min(n_probe or self.n_probe, self.n_lists)
        r = self.rerank if rerank is None else int(rerank)
        d, i = _ivfpq_search(q, self.centroids, self.codebooks, self.blocks,
                             self.block_ids, self.rot, p, max(k, r))
        if r > 0:
            if not self.keep_codes:
                raise ValueError("rerank requires keep_codes=True")
            d, i = _rerank(q, *self._device_codes(), d, i, k)
        return d[:, :k].cpu().numpy(), i[:, :k].cpu().numpy()

    # -- persistence ----------------------------------------------------

    def to_numpy(self) -> tuple[dict, dict[str, np.ndarray]]:
        """The ``params.json`` dict and the npz arrays :meth:`save`
        writes: ``codes``, ``scales``, ``assign``, ``centroids``,
        ``codebooks``, ``rot``."""
        n = self._n
        meta = {
            "format": FORMAT, "dim": self.dim, "m_pq": self.m_pq,
            "n_lists": self.n_lists, "n_probe": self.n_probe,
            "kmeans_iters": self.kmeans_iters, "pq_iters": self.pq_iters,
            "rerank": self.rerank, "keep_codes": self.keep_codes,
            "seed": self.seed, "metric": self.metric, "n": n,
            "opq": self.opq, "opq_iters": self.opq_iters,
        }

        def host(a):
            return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

        arrays = {
            "codes": host(self.codes)[:n], "scales": host(self.scales)[:n],
            "assign": np.asarray(self._assign)[:n],
            "centroids": host(self.centroids), "codebooks": host(self.codebooks),
            "rot": host(self.rot),
        }
        return meta, arrays

    @classmethod
    def from_numpy(cls, meta: dict, arrays,
                   device: torch.device | str) -> "IVFPQIndex":
        """An index from the ``params.json`` dict and npz arrays either
        package's ``save`` writes: the trained centroids, codebooks and
        rotation are taken as they are. The PQ codes are re-encoded from
        the u8 codes, unless ``arrays`` also holds ``pq_codes`` u8[n,
        m_pq] (one row per point), which are then packed as given."""
        if meta.get("format") != FORMAT:
            raise ValueError(f"unknown index format {meta.get('format')!r}")
        index = cls(
            meta["dim"], n_lists=meta["n_lists"], m_pq=meta["m_pq"],
            n_probe=meta["n_probe"], kmeans_iters=meta["kmeans_iters"],
            pq_iters=meta["pq_iters"], rerank=meta["rerank"],
            keep_codes=meta["keep_codes"], seed=meta["seed"],
            metric=meta["metric"], opq=meta.get("opq", False),
            opq_iters=meta.get("opq_iters", 6), device=device)
        dev = index.device

        def up(name, dtype):
            return torch.tensor(np.asarray(arrays[name], dtype), device=dev)

        codes, scales = up("codes", np.uint8), up("scales", np.float32)
        index._assign = np.array(arrays["assign"], np.int32)
        index.centroids = up("centroids", np.float32)
        index.codebooks = up("codebooks", np.float32)
        index.rot = (up("rot", np.float32) if "rot" in arrays
                     else torch.eye(index.dim, dtype=torch.float32, device=dev))
        index._n = int(meta["n"])
        if index._n:
            if "pq_codes" in arrays:
                pq_codes = np.asarray(arrays["pq_codes"], np.uint8)
            else:
                assign_t = torch.from_numpy(index._assign).to(dev).long()
                pq_codes = index._encode(
                    (dequantize(codes, scales) - index.centroids[assign_t])
                    @ index.rot)
            index._pack(pq_codes)
        index._store_codes(codes, scales)
        return index

    def save(self, path: str) -> None:
        meta, arrays = self.to_numpy()
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "params.json"), "w") as f:
            json.dump(meta, f, indent=2)
        np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)

    @classmethod
    def load(cls, path: str, device: torch.device | str) -> "IVFPQIndex":
        """Restore from either package's :meth:`save`."""
        with open(os.path.join(path, "params.json")) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT:
            raise ValueError(f"unknown index format in {path}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return cls.from_numpy(meta, arrays, device)
