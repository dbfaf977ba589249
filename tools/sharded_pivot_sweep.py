"""Recall of a sharded cluster-built index per pivot budget and per
(ef, max_iters) rung, against exact ground truth.

    python3 tools/sharded_pivot_sweep.py --device cpu --n 40000 --shards 8 \\
        --pivots 82,164,328,655,1310 [--sequential] [--package torch,jax]

The points are ``synthetic_clustered(n, 96, seed=42)``, whose clusters
hold ~100 points each at any n, so n=40,000 over 8 shards gives each
shard ~12 points of every cluster, as 1M over 8 shards does: a small
analog of ``chip_smoke.py``'s sharded phase that runs on the CPU.
``ShardedHNSW(24, 96, shards, ef_cons=128)`` is built with
``chip_smoke.py``'s cluster kwargs (``--sequential``: the same build one
shard at a time with the single-index builder, before the concurrent
one). Each build prints the plain hierarchical route's recall@10 per
rung; then, per pivot budget a shard, the seeded route's after
``finalize(pivots=...)``. ``scaled`` is the budget times 10,000 over the
data's cluster count: the budget at 1M with the same pivots per
cluster. One JSON line per result, tagged with its ``package``.

``--package jax`` runs the same builds and queries through the JAX
package (``hnsw_rs_tpu.parallel``) on a virtual CPU mesh of ``shards``
devices: the reference's own recall on the same points, as a witness
beside the port's. It needs ``--device cpu`` and JAX installed.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hnsw_rs_tpu_torch import FlatIndex  # noqa: E402
from hnsw_rs_tpu_torch.parallel import ShardedHNSW, make_mesh  # noqa: E402
from hnsw_rs_tpu_torch.utils.datasets import synthetic_clustered  # noqa: E402

CLUSTER_KWARGS = {"pool_p": 96, "points_per_cluster": 96, "fanout": 5,
                  "select_alg4": False, "merge_slots": 48}
RUNGS = [(16, 8), (24, 12), (32, 16), (48, 28), (64, 40), (128, 112), (256, 280)]


def _port_factory(device, shards):
    dev = torch.device(device)
    return lambda: ShardedHNSW(24, 96, shards, ef_cons=128,
                               mesh=make_mesh(1, shards, [dev] * shards))


def _jax_factory(device, shards):
    if device != "cpu":
        raise SystemExit("--package jax runs on the CPU only: pass --device cpu")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_num_cpu_devices", shards)
    from hnsw_rs_tpu.parallel import ShardedHNSW as JSharded
    from hnsw_rs_tpu.parallel import make_mesh as j_make_mesh

    return lambda: JSharded(24, 96, shards, ef_cons=128,
                            mesh=j_make_mesh(1, shards))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", required=True)
    ap.add_argument("--n", type=int, default=40000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--pivots", default="82,164,328,655,1310")
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--sequential", action="store_true")
    ap.add_argument("--package", default="torch",
                    help="comma-separated: torch (the port), jax (the reference)")
    a = ap.parse_args()
    d = 96
    ds = synthetic_clustered(a.n, d, n_queries=a.queries, seed=42)
    flat = FlatIndex(d, torch.device(a.device))
    flat.add(ds.train)
    q = ds.test[:a.queries]
    _, truth = flat.search(q, 10, exact=True)

    def recall(ids):
        return round(float(np.mean([len(set(x) & set(t)) / 10
                                    for x, t in zip(ids, truth)])), 4)

    def ladder(sh):
        return {f"{e},{m}": recall(sh.ann_batch(q, 10, e, max_iters=m)[1])
                for e, m in RUNGS}

    scale = 10000 / (a.n // 100)
    modes = ([{"concurrent": False}] if a.sequential else []) + [{}]
    factories = {"torch": _port_factory, "jax": _jax_factory}
    for package in a.package.split(","):
        make = factories[package](a.device, a.shards)
        for mode in modes:
            t0 = time.perf_counter()
            sh = make()
            sh.insert_bulk(ds.train, cluster_build=True,
                           cluster_kwargs=CLUSTER_KWARGS, **mode)
            build_s = time.perf_counter() - t0
            print(json.dumps({"package": package,
                              "build": "sequential" if mode else "concurrent",
                              "build_s": round(build_s, 3), "route": "plain",
                              "recall": ladder(sh)}), flush=True)
        for piv in (int(p) for p in a.pivots.split(",")):
            sh.finalize(pivots=piv)
            print(json.dumps({"package": package, "pivots": piv,
                              "scaled": round(piv * scale), "route": "seeded",
                              "recall": ladder(sh)}), flush=True)


if __name__ == "__main__":
    main()
