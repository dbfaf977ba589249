"""Entry points of the port: the twin of the repository's
``__graft_entry__.py`` (which imports JAX), on torch devices.

- :func:`entry` returns ``(fn, example_args)``: the batched HNSW query
  step (greedy upper-layer descent, then the flagged beam at layer 0) over
  an index of the first 512 vectors of ``test-data/store.txt``;
- :func:`dryrun_multichip` runs the sharded steps of the JAX function on
  a mesh of ``n_devices`` cells, with its shapes and assertions: the
  concurrent wave build, plain and pivot-seeded serving, an incremental
  add, recall against brute force, then the concurrent cluster build.
  On one card the mesh repeats that card (``parallel.Mesh`` allows it).

Run: ``python -m hnsw_rs_tpu_torch.entry --device cuda`` (both).
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np
import torch

_STORE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "test-data", "store.txt")


def entry(device: torch.device | str = "cuda"):
    """``(fn, example_args)``: ``fn`` is :func:`..search.ann_search` at
    ef=64, k=10, max_iters=144; the arguments are the layers, codes,
    scales and entry point of an index over the bundled GloVe vectors
    (512 of them; seeded random ones when the file is absent) and 64 of
    those vectors quantized and dequantized as queries, all on
    ``device``."""
    from .models.hnsw import HNSW
    from .ops.quant import dequantize, quantize
    from .search import ann_search
    from .utils.glove import load_glove_array

    device = torch.device(device)
    if os.path.exists(_STORE):
        _, vectors = load_glove_array(_STORE, limit=512)
    else:
        vectors = np.random.default_rng(0).random((512, 50), np.float32)
    index = HNSW(12, dim=vectors.shape[1], device=device)
    index.insert_bulk(vectors)
    q = dequantize(*quantize(torch.from_numpy(vectors[:64]).to(device)))
    fn = functools.partial(ann_search, ef=64, k=10, max_iters=144)
    example_args = (tuple(index.graph.adjs), index.points.codes,
                    index.points.scales, q, int(index.params.ep))
    return fn, example_args


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda") -> None:
    """The JAX ``dryrun_multichip``'s sharded steps on an ``n_devices``
    mesh of ``device``: ``(n_data, n_shard)`` = ``(2, n/2)`` for an even
    ``n >= 4``, else ``(1, n)``; raises AssertionError on a failed check
    and prints one ``dryrun_multichip ok on N devices: ...`` line."""
    from .parallel.mesh import make_mesh
    from .parallel.sharded import ShardedHNSW

    n_data = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_shard = n_devices // n_data
    mesh = make_mesh(n_data, n_shard, [device] * n_devices)

    # the concurrent multi-layer sharded wave build, plain and seeded
    # serving, and a rebuild-free incremental add, on tiny shapes
    S, K, d, m = n_shard, 40, 16, 4
    rng = np.random.default_rng(0)
    vecs = rng.random((S * K, d), np.float32)
    index = ShardedHNSW(m, d, n_shards=S, ef_cons=16, mesh=mesh)
    index.insert_bulk(vecs, concurrent=True)
    n_layers = len(index._stacked["adjs"])
    assert n_layers >= 2, f"want a multi-layer graph, got {n_layers} layer(s)"

    _, ids = index.ann_batch(vecs[:8], 5, 16)
    assert ids.shape == (8, 5)
    assert np.all(ids[:, 0] == np.arange(8)), ids[:, 0]  # plain self-match

    index.finalize(pivots=16)  # per-shard packed rows + pivot skeleton
    _, ids = index.ann_batch(vecs[:8], 5, 16)
    assert np.all(ids[:, 0] == np.arange(8)), ids[:, 0]  # seeded self-match

    new_gids = index.add(vecs[:4] + 0.001)
    _, ids = index.ann_batch(vecs[:8], 5, 16)  # the stale pack is bypassed
    assert np.all(ids[:, 0] == np.arange(8)), ids[:, 0]
    assert len(index) == S * K + 4 and new_gids[0] == S * K

    # recall against brute force over the whole collection, for fresh
    # queries; an added near-duplicate S*K+j counts as its original j
    queries = rng.random((32, d), np.float32)
    truth = np.argsort(
        ((vecs[None, :, :] - queries[:, None, :]) ** 2).sum(-1), axis=1)[:, :5]
    _, ids = index.ann_batch(queries, 5, 24)
    ids_t = np.where(ids >= S * K, ids - S * K, ids)
    rec = np.mean([len(set(a) & set(t)) / 5
                   for a, t in zip(ids_t.tolist(), truth.tolist())])
    assert rec >= 0.9, f"sharded wave-build recall vs bruteforce {rec}"

    # the concurrent sharded cluster build, against the same truth
    cidx = ShardedHNSW(m, d, n_shards=S, ef_cons=16, mesh=mesh)
    cidx.insert_bulk(vecs, cluster_build=True,
                     cluster_kwargs=dict(points_per_cluster=16, fanout=3, pool_p=32))
    cidx.finalize(pivots=max(16, (S * K) // 8))
    _, cids = cidx.ann_batch(queries, 5, 24)
    crec = np.mean([len(set(int(x) for x in a) & set(t)) / 5
                    for a, t in zip(cids.tolist(), truth.tolist())])
    assert crec >= 0.9, f"sharded cluster-build recall vs bruteforce {crec}"

    print(f"dryrun_multichip ok on {n_devices} devices: mesh "
          f"(data={n_data}, shard={n_shard}), {n_layers} layers, "
          f"self-match 8/8 plain+seeded, incremental add ok, "
          f"recall vs bruteforce wave={rec:.3f} cluster={crec:.3f}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hnsw_rs_tpu_torch.entry",
                                description="Run entry() once, then "
                                "dryrun_multichip(8), on one device.")
    p.add_argument("--device", required=True,
                   help="torch device (cpu, cuda, cuda:1)")
    args = p.parse_args(argv)
    fn, example_args = entry(args.device)
    dist, ids = fn(*example_args)
    print("entry ok:", tuple(dist.shape), tuple(ids.shape), flush=True)
    dryrun_multichip(8, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
