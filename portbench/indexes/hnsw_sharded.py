"""The sharded HNSW index through the port's public API only:
``make_mesh(1, len(devices), devices)``, ``ShardedHNSW(m, dim, shards,
ef_cons, mesh=)``, ``insert_bulk(cluster_build=True, cluster_kwargs=...)``,
``finalize(...)``, the ``serve_probes`` attribute, ``serving_route()`` and
``ann_batch``. The configuration's ``index`` section gives every argument;
its ``shards`` must equal the cell's devices, one shard a device. The
points are placed by the even contiguous split of their order.

A program whose ``ShardedHNSW`` lacks ``serving_route`` or
``finalize(pivot_shortlist=)`` cannot serve the probed route: loading
this family then raises at once, before any data is made."""

from __future__ import annotations

import inspect
import time

import numpy as np
import torch


def _require_probed_sharding() -> None:
    from hnsw_rs_tpu_torch.parallel import ShardedHNSW

    if (not hasattr(ShardedHNSW, "serving_route")
            or "pivot_shortlist" not in inspect.signature(
                ShardedHNSW.finalize).parameters):
        raise RuntimeError("this ShardedHNSW has no serving_route() or no "
                           "finalize(pivot_shortlist=): it cannot serve the "
                           "probed route")


_require_probed_sharding()


def _drain(devices):
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def build(config: dict, train: np.ndarray, devices: list[torch.device]):
    """Build and finalize over ``devices``; returns (index, spans) with the
    seconds of ``insert_bulk`` and of ``finalize``, each ended with every
    device drained."""
    from hnsw_rs_tpu_torch.parallel import ShardedHNSW, make_mesh

    index_cfg = config["index"]
    shards = int(index_cfg["shards"])
    if shards != len(devices):
        raise ValueError(f"{shards} shards on {len(devices)} devices: the "
                         "family places one shard a device")
    if config["metric"] != "l2":
        raise ValueError(f"ShardedHNSW serves L2 only, not {config['metric']!r}")
    t0 = time.perf_counter()
    index = ShardedHNSW(index_cfg["m"], train.shape[1], shards,
                        index_cfg["ef_cons"], mesh=make_mesh(1, shards, devices))
    index.insert_bulk(train, cluster_build=True,
                      cluster_kwargs=dict(index_cfg["cluster_kwargs"]))
    _drain(devices)
    t1 = time.perf_counter()
    index.finalize(**index_cfg["finalize"])
    if "serve_probes" in index_cfg:
        index.serve_probes = int(index_cfg["serve_probes"])
    _drain(devices)
    t2 = time.perf_counter()
    route = index.serving_route()
    if route != index_cfg["route"]:
        raise RuntimeError(f"the index serves through {route!r}, the "
                           f"configuration states {index_cfg['route']!r}")
    return index, {"insert_bulk_s": t1 - t0, "finalize_s": t2 - t1}


def search(index, queries: np.ndarray, k: int, rung: dict):
    """(distances [B, k], global ids [B, k]) as numpy, at the cell's rung."""
    return index.ann_batch(queries, k, rung["ef"], max_iters=rung["max_iters"])
