"""Paged on-disk point storage and out-of-core exact search (port of
``hnsw_rs_tpu/store_paged.py``; the reference's paged store and disk
reader, ``points/src/points/block_points.rs`` and ``hnsw/src/disk.rs:
22-109``, are work in progress there).

- :class:`BlockStore`: fixed-size blocks on disk, arithmetic offsets
  (``id = block_id * 32 + pos``, ``block_points.rs:101-108``), positioned
  reads (``os.pread``), an LRU block cache (the ``PointsDisk`` buffer,
  ``disk.rs:35-99``);
- streaming exact search: blocks go through the device in large
  contiguous chunks (sequential reads, no per-point gather) with a
  running top-k merge, so a collection far larger than the device's
  memory is searched exactly.

Block file layout, byte for byte the JAX package's (a file written by one
package is read by the other): ``magic 'HTBS' | version u32 | point_size
u32 | max_per_block u32``, then per block ``block_id u16 | nb_points u16 |
point_size u16`` (the ``BlockHeader`` fields, ``block/header.rs:5-45``)
and ``max_per_block`` point records ``level u8 | min f32 BE | delta f32
BE | codes u8[d]`` (the reference's Point codec,
``points/src/point.rs:46-76``).
"""

from __future__ import annotations

import collections
import os
import struct
import threading

import numpy as np
import torch

MAGIC = b"HTBS"
VERSION = 1
MAX_PER_BLOCK = 32
FILE_HEADER = 16
BLOCK_HEADER = 6
_TEMP_BYTES = 1 << 28  # bound of the direct form's [b, chunk, d] f32 temporary


def _record_size(dim: int) -> int:
    return 9 + dim  # level + min + delta + codes


def write_block_store(path: str, codes: np.ndarray, scales: np.ndarray,
                      levels: np.ndarray) -> None:
    """Write a quantized collection as a paged block file."""
    n, d = codes.shape
    ps = _record_size(d)
    nb = max(1, -(-n // MAX_PER_BLOCK))
    rec = np.zeros((nb * MAX_PER_BLOCK, ps), np.uint8)
    rec[:n, 0] = np.asarray(levels, np.uint8)
    rec[:n, 1:5] = np.frombuffer(
        np.asarray(scales[:, 0], ">f4").tobytes(), np.uint8).reshape(n, 4)
    rec[:n, 5:9] = np.frombuffer(
        np.asarray(scales[:, 1], ">f4").tobytes(), np.uint8).reshape(n, 4)
    rec[:n, 9:] = codes
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<III", VERSION, ps, MAX_PER_BLOCK))
        for b in range(nb):
            lo = b * MAX_PER_BLOCK
            hi = min(n, lo + MAX_PER_BLOCK)
            f.write(struct.pack("<HHH", b, hi - lo, ps))
            f.write(rec[lo:lo + MAX_PER_BLOCK].tobytes())


def _decode_records(raw: np.ndarray, dim: int):
    """records u8[k, 9+d] -> (codes, scales, levels)."""
    levels = raw[:, 0].astype(np.int32)
    mins = np.frombuffer(raw[:, 1:5].tobytes(), ">f4").astype(np.float32)
    deltas = np.frombuffer(raw[:, 5:9].tobytes(), ">f4").astype(np.float32)
    return raw[:, 9:], np.stack([mins, deltas], 1), levels


class BlockStore:
    """Read-side paged access to a block file with an LRU block cache. It
    holds nothing on a device; :meth:`search_streaming` takes the device
    its chunks go through."""

    def __init__(self, path: str, cache_blocks: int = 256):
        self.path = path
        self._fd = None
        self._fd = os.open(path, os.O_RDONLY)
        head = os.pread(self._fd, FILE_HEADER, 0)
        if head[:4] != MAGIC:
            self.close()
            raise ValueError(f"{path} is not a block store")
        self.version, self.point_size, self.max_per_block = struct.unpack(
            "<III", head[4:16])
        self.dim = self.point_size - 9
        self._block_bytes = BLOCK_HEADER + self.max_per_block * self.point_size
        size = os.path.getsize(path)
        self.nb_blocks = (size - FILE_HEADER) // self._block_bytes
        self._cache: collections.OrderedDict[int, tuple] = collections.OrderedDict()
        self._cache_blocks = cache_blocks
        # the LRU is shared with HybridPagedHNSW's prefetch thread
        # (models/paged.py): guard its mutation; the lock is cheap next to
        # the positioned read it protects
        self._cache_lock = threading.Lock()
        # count of points in the last block
        _, _, lv = self._load_block(self.nb_blocks - 1)
        self._n = (self.nb_blocks - 1) * self.max_per_block + lv.shape[0]

    def __len__(self) -> int:
        return self._n

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self):
        self.close()

    def _block_offset(self, block_id: int) -> int:
        # arithmetic offset (block_points.rs:101-108 / disk.rs:72-81)
        return FILE_HEADER + block_id * self._block_bytes

    def _read_bytes(self, offset: int, nbytes: int) -> np.ndarray:
        """A positioned read: no shared file position, so the prefetch
        thread reads beside the query thread."""
        return np.frombuffer(os.pread(self._fd, nbytes, offset), np.uint8)

    def _load_block(self, block_id: int):
        """Block (codes, scales, levels), through the LRU cache."""
        with self._cache_lock:
            hit = self._cache.get(block_id)
            if hit is not None:
                self._cache.move_to_end(block_id)
                return hit
        raw = self._read_bytes(self._block_offset(block_id), self._block_bytes)
        _, nb_points, _ = struct.unpack("<HHH", raw[:BLOCK_HEADER].tobytes())
        rec = raw[BLOCK_HEADER:].reshape(self.max_per_block, self.point_size)
        out = _decode_records(rec[:nb_points], self.dim)
        with self._cache_lock:
            self._cache[block_id] = out
            if len(self._cache) > self._cache_blocks:
                self._cache.popitem(last=False)
        return out

    def get_point(self, idx: int):
        """(codes u8[d], (min, delta), level) of a point id
        (``PointsDisk::get_point``, ``disk.rs:35-99``)."""
        if idx < 0 or idx >= self._n:
            return None
        codes, scales, levels = self._load_block(idx // self.max_per_block)
        pos = idx % self.max_per_block
        return codes[pos], scales[pos], int(levels[pos])

    def get_values(self, idx: int) -> np.ndarray:
        """Dequantized values of one point."""
        codes, scales, _level = self.get_point(idx)
        return codes.astype(np.float32) * scales[1] + scales[0]

    def gather(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Raw (codes u8[K, d], scales f32[K, 2]) of a flat id array, one
        cache lookup per touched block."""
        ids = np.asarray(ids, np.int64).ravel()
        blocks = ids // self.max_per_block
        pos = ids % self.max_per_block
        ub, inv = np.unique(blocks, return_inverse=True)
        bc = np.zeros((ub.size, self.max_per_block, self.dim), np.uint8)
        bs = np.zeros((ub.size, self.max_per_block, 2), np.float32)
        for j, b in enumerate(ub.tolist()):
            c, s, _ = self._load_block(b)
            bc[j, : c.shape[0]] = c
            bs[j, : s.shape[0]] = s
        return bc[inv, pos], bs[inv, pos]

    def iter_chunks(self, chunk_blocks: int = 64):
        """Stream (codes, scales, start_id) over contiguous block chunks:
        large sequential reads, the out-of-core access pattern."""
        for b0 in range(0, self.nb_blocks, chunk_blocks):
            bks = min(chunk_blocks, self.nb_blocks - b0)
            raw = self._read_bytes(self._block_offset(b0), bks * self._block_bytes)
            raw = raw.reshape(bks, self._block_bytes)
            counts = np.frombuffer(
                raw[:, :BLOCK_HEADER].tobytes(), "<u2").reshape(bks, 3)[:, 1]
            rec = raw[:, BLOCK_HEADER:].reshape(
                bks * self.max_per_block, self.point_size)
            keep = (np.arange(bks * self.max_per_block) % self.max_per_block
                    < np.repeat(counts, self.max_per_block))
            codes, scales, _ = _decode_records(rec[keep], self.dim)
            yield codes, scales, b0 * self.max_per_block

    def search_streaming(self, queries, k: int, chunk_blocks: int = 256, *,
                         device: torch.device | str):
        """Exact top-k over the whole on-disk collection: chunks stream
        through ``device`` with a running (dist, id) merge. Memory use is
        O(chunk + k), whatever the collection's size. The direct form's
        [b, chunk, d] temporary is kept under ``_TEMP_BYTES`` by tiling
        over the queries. Returns (distances [B, k], ids [B, k]) as numpy
        arrays."""
        from .ops.distance import pairwise_l2sq_exact
        from .ops.quant import dequantize, quantize
        from .ops.topk import PAD_ID, topk_dist_id

        dev = torch.device(device)
        x = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
        qf = dequantize(*quantize(torch.atleast_2d(x)))
        b = qf.shape[0]
        best_d = torch.full((b, k), float("inf"), device=dev)
        best_i = torch.full((b, k), PAD_ID, dtype=torch.int32, device=dev)
        for codes, scales, start in self.iter_chunks(chunk_blocks):
            c = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
            s = torch.from_numpy(scales).to(dev)
            ids = torch.arange(start, start + c.shape[0], dtype=torch.int32,
                               device=dev)
            tb = max(1, min(b, _TEMP_BYTES // max(c.shape[0] * self.dim * 4, 1)))
            for lo in range(0, b, tb):
                d2 = pairwise_l2sq_exact(qf[lo:lo + tb], c, s)
                best_d[lo:lo + tb], best_i[lo:lo + tb] = topk_dist_id(
                    torch.cat([best_d[lo:lo + tb], d2], dim=1),
                    torch.cat([best_i[lo:lo + tb], ids.expand(d2.shape)], dim=1),
                    k)
        return torch.sqrt(best_d).cpu().numpy(), best_i.cpu().numpy()
