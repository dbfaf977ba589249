"""Reference-format index codec (port of
``hnsw_rs_tpu/utils/serializer.py``): import and export the Rust
workspace's on-disk directory format, so an hnsw_rs index moves to the
port and back. The file codecs are copies of the JAX package's, and both
packages write the same bytes for the same index arrays.

Directory layout (``hnsw/src/template.rs:43-131``):
- ``points``  — SimplePoints: u64 BE count | u64 BE point_size | packed
  points, each ``u8 level | f32 BE min | f32 BE delta | dim x u8 codes``
  (``points/src/points.rs:119-146``, ``points/src/point.rs:46-76``,
  ``vectors/src/quant.rs:90-110``); ids are positions.
- ``params``  — ``m, mmax, mmax0`` u64 BE | ``ml`` f32 BE | ``ef_cons,
  dim, ep`` u64 BE (``hnsw/src/params.rs:78-114``).
- ``layers/<idx>`` — Graph: ``level u8 | nb_nodes u32 BE | m u16 BE`` then
  per node ``node_id u32 BE | m x u32 BE neighbors`` padded with
  ``u32::MAX`` (``graph/src/graph.rs:165-252``) — exactly a dense [N, m]
  adjacency row dump, which is why import is a pure numpy reshape.

All parsing is vectorized numpy on big-endian dtypes (no per-byte
loops). ``NODE_MAX`` (u32::MAX) on disk is -1 in memory, both ways.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

NODE_MAX = np.uint32(0xFFFFFFFF)


# -- points ----------------------------------------------------------------


def read_points(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a SimplePoints file -> (codes u8[N, d], scales f32[N, 2],
    levels i32[N])."""
    raw = np.fromfile(path, dtype=np.uint8)
    count = int(np.frombuffer(raw[:8].tobytes(), dtype=">u8")[0])
    point_size = int(np.frombuffer(raw[8:16].tobytes(), dtype=">u8")[0])
    dim = point_size - 9  # 1 level + 4 min + 4 delta
    body = raw[16 : 16 + count * point_size].reshape(count, point_size)
    levels = body[:, 0].astype(np.int32)
    mins = np.frombuffer(body[:, 1:5].tobytes(), dtype=">f4").astype(np.float32)
    deltas = np.frombuffer(body[:, 5:9].tobytes(), dtype=">f4").astype(np.float32)
    codes = body[:, 9:].copy()
    scales = np.stack([mins, deltas], axis=1)
    return codes, scales, levels.reshape(count)


def write_points(path: str, codes: np.ndarray, scales: np.ndarray, levels: np.ndarray) -> None:
    n, d = codes.shape
    point_size = 9 + d
    body = np.empty((n, point_size), np.uint8)
    body[:, 0] = np.asarray(levels, np.uint8)
    body[:, 1:5] = np.frombuffer(
        np.asarray(scales[:, 0], ">f4").tobytes(), np.uint8
    ).reshape(n, 4)
    body[:, 5:9] = np.frombuffer(
        np.asarray(scales[:, 1], ">f4").tobytes(), np.uint8
    ).reshape(n, 4)
    body[:, 9:] = codes
    with open(path, "wb") as f:
        f.write(struct.pack(">QQ", n, point_size))
        f.write(body.tobytes())


# -- params ----------------------------------------------------------------


def read_params(path: str) -> dict:
    raw = open(path, "rb").read()
    m, mmax, mmax0 = struct.unpack(">QQQ", raw[:24])
    (ml,) = struct.unpack(">f", raw[24:28])
    ef_cons, dim, ep = struct.unpack(">QQQ", raw[28:52])
    return dict(m=m, mmax=mmax, mmax0=mmax0, ml=ml, ef_cons=ef_cons, dim=dim, ep=ep)


def write_params(path: str, p: dict) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack(">QQQ", p["m"], p["mmax"], p["mmax0"]))
        f.write(struct.pack(">f", p["ml"]))
        f.write(struct.pack(">QQQ", p["ef_cons"], p["dim"], p["ep"]))


# -- graph layers ----------------------------------------------------------


def read_layer(path: str, n_total: int) -> tuple[int, np.ndarray]:
    """Parse one Graph file -> (level, adjacency int32[n_total, m] with -1
    sentinels). Rows for nodes absent from the layer stay all-sentinel."""
    raw = np.fromfile(path, dtype=np.uint8)
    level = int(raw[0])
    nb_nodes = int(np.frombuffer(raw[1:5].tobytes(), dtype=">u4")[0])
    m = int(np.frombuffer(raw[5:7].tobytes(), dtype=">u2")[0])
    rows = np.frombuffer(
        raw[7 : 7 + nb_nodes * 4 * (m + 1)].tobytes(), dtype=">u4"
    ).reshape(nb_nodes, m + 1)
    node_ids = rows[:, 0].astype(np.int64)
    nbrs = rows[:, 1:]
    # the reference's decoder stops each row at the first MAX sentinel
    # (graph.rs:185-198); mask everything at/after it
    stop = np.cumsum(nbrs == NODE_MAX, axis=1) > 0
    adj_rows = np.where(stop, -1, nbrs.astype(np.int64)).astype(np.int32)
    adj = np.full((n_total, m), -1, np.int32)
    adj[node_ids] = adj_rows
    return level, adj


def write_layer(path: str, level: int, adj: np.ndarray, member: np.ndarray) -> None:
    """Write one layer: rows for member nodes only, reference layout."""
    node_ids = np.flatnonzero(member).astype(np.uint32)
    m = adj.shape[1]
    rows = adj[node_ids].astype(np.int64)
    rows = np.where(rows < 0, int(NODE_MAX), rows).astype(">u4")
    out = np.empty((node_ids.size, m + 1), dtype=">u4")
    out[:, 0] = node_ids.astype(">u4")
    out[:, 1:] = rows
    with open(path, "wb") as f:
        f.write(struct.pack(">B", level))
        f.write(struct.pack(">I", node_ids.size))
        f.write(struct.pack(">H", m))
        f.write(out.tobytes())


# -- whole-index import/export --------------------------------------------


def import_reference_index(path: str, device: torch.device | str):
    """Load a reference-format index directory into an :class:`HNSW` on
    ``device``. The store is exactly sized (a later insert grows it into
    poisoned capacity rows), and every layer's in-degree ledger is
    recounted from its rows, so inserts into the imported index repair
    orphans against the true in-degrees."""
    from ..graphs import LayeredGraph, recount_indeg
    from ..models.hnsw import HNSW
    from ..params import Params
    from ..store import PointStore

    codes, scales, levels = read_points(os.path.join(path, "points"))
    pd = read_params(os.path.join(path, "params"))
    params = Params(
        m=int(pd["m"]), dim=int(pd["dim"]), mmax=int(pd["mmax"]),
        mmax0=int(pd["mmax0"]), ml=float(pd["ml"]),
        ef_cons=int(pd["ef_cons"]), ep=int(pd["ep"]),
    )
    index = HNSW(params.m, params=params, device=device)
    dev = index.device
    index.points = PointStore(torch.from_numpy(codes).to(dev),
                              torch.from_numpy(scales).to(dev), levels)
    graph = LayeredGraph(params.m, codes.shape[0], dev)
    layers_dir = os.path.join(path, "layers")
    for fname in sorted(os.listdir(layers_dir), key=int):
        level, adj = read_layer(os.path.join(layers_dir, fname), codes.shape[0])
        graph.ensure_level(level)
        adj = torch.from_numpy(adj).to(dev)
        graph.set_layer(level, adj, recount_indeg(adj))
    index.graph = graph
    return index


def export_reference_index(index, path: str) -> None:
    """Write an :class:`HNSW` in the reference's directory format: live
    rows only, and each layer's rows for its member nodes only.

    The adjacency is directed here; the reference treats neighbor sets
    as undirected. A re-imported index searches the same either way."""
    index.flush()
    os.makedirs(os.path.join(path, "layers"), exist_ok=True)
    n = len(index)
    levels = np.asarray(index.points.levels[:n])
    write_points(os.path.join(path, "points"),
                 index.points.codes[:n].cpu().numpy(),
                 index.points.scales[:n].cpu().numpy(), levels)
    p = index.params
    write_params(os.path.join(path, "params"),
                 dict(m=p.m, mmax=p.mmax, mmax0=p.mmax0, ml=p.ml,
                      ef_cons=p.ef_cons, dim=p.dim, ep=p.ep))
    for layer_nb in range(len(index.graph)):
        write_layer(os.path.join(path, "layers", str(layer_nb)), layer_nb,
                    index.graph.get_layer(layer_nb)[:n].cpu().numpy(),
                    levels >= layer_nb)
