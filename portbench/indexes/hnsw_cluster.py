"""The HNSW index, cluster-built, through the port's public API only:
``HNSW(m, ef_cons, dim, metric=, device=)``, ``insert_bulk(cluster_build=True,
cluster_kwargs=...)``, ``finalize(...)``, the ``serve_probes`` attribute
and ``ann_batch``. The configuration's ``metric`` and its ``index``
section give every argument. One card: the first of the cell's devices."""

from __future__ import annotations

import time

import numpy as np
import torch


def _drain(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(config: dict, train: np.ndarray, devices: list[torch.device]):
    """Build and finalize; returns (index, spans) with the seconds of
    ``insert_bulk`` and of ``finalize``, each ended with the device
    drained."""
    from hnsw_rs_tpu_torch import HNSW

    index_cfg, device = config["index"], devices[0]
    t0 = time.perf_counter()
    index = HNSW(index_cfg["m"], ef_cons=index_cfg["ef_cons"],
                 dim=train.shape[1], metric=config["metric"], device=device)
    index.insert_bulk(train, cluster_build=True,
                      cluster_kwargs=dict(index_cfg["cluster_kwargs"]))
    _drain(device)
    t1 = time.perf_counter()
    index.finalize(**index_cfg["finalize"])
    if "serve_probes" in index_cfg:
        index.serve_probes = int(index_cfg["serve_probes"])
    _drain(device)
    t2 = time.perf_counter()
    route = index.serving_route()
    if route != index_cfg["route"]:
        raise RuntimeError(f"the index serves through {route!r}, the "
                           f"configuration states {index_cfg['route']!r}")
    return index, {"insert_bulk_s": t1 - t0, "finalize_s": t2 - t1}


def search(index, queries: np.ndarray, k: int, rung: dict):
    """(distances [B, k], ids [B, k]) as numpy, at the cell's rung."""
    return index.ann_batch(queries, k, rung["ef"], max_iters=rung["max_iters"])
