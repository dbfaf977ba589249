"""Parity of the port's NN-descent refinement (``hnsw_rs_tpu_torch.refine``,
``HNSW.refine``) with the JAX package on the CPU: the same cluster-built
graph (built once by the JAX package, N=2000, d=32) goes through
``refine_layer`` on both sides.

Tolerances: a refined chunk's rows, and the refined layer's rows, equal on
>= 95% (the accept chain compares candidate-to-query distances in the
diff-square form with candidate-to-selected distances in the matmul form,
so an ulp decides some acceptances; a differing row shares most of its
ids); recall@10 of the refined graph within 0.01 of the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_rs_tpu import HNSW as JHNSW
from hnsw_rs_tpu import refine as jrefine
from hnsw_rs_tpu_torch import FlatIndex, HNSW
from hnsw_rs_tpu_torch import refine as trefine
from hnsw_rs_tpu_torch.utils.datasets import synthetic_heavy_tailed

N, D, K = 2000, 32, 10


def _recall(ids, truth):
    return float(np.mean([len(set(a) & set(t)) / K for a, t in zip(ids, truth)]))


@pytest.fixture(scope="module")
def pair():
    ds = synthetic_heavy_tailed(N, D, n_queries=128, seed=3)
    jidx = JHNSW(8, ef_cons=32, dim=D)
    jidx.insert_bulk(ds.train, cluster_build=True,
                     cluster_kwargs={"select_alg4": False})
    meta, arrays = {"format": "hnsw_rs_tpu.v1", "params": jidx.params.to_dict(),
                    "n_layers": len(jidx.graph), "level_rng_calls": 1}, {
        "codes": np.asarray(jidx.points.codes), "scales": np.asarray(jidx.points.scales),
        "levels": np.asarray(jidx.points.levels),
        "cluster_pivots": np.asarray(jidx._cluster_pivots),
        **{f"adj_{i}": np.asarray(a) for i, a in enumerate(jidx.graph.adjs)}}
    tidx = HNSW.from_numpy(meta, arrays, "cpu")
    flat = FlatIndex(D, "cpu")
    flat.add(ds.train)
    _, truth = flat.search(ds.test, K, fused=True)
    return ds, jidx, tidx, truth


@pytest.mark.parametrize("use_alg4,hop_w,pool_p", [(True, 8, 192), (False, 4, 64),
                                                    (True, 3, 20)])
def test_refine_chunk_matches_jax(pair, use_alg4, hop_w, pool_p):
    _, jidx, tidx, _ = pair
    adj = np.array(jidx.graph.get_layer(0))
    cap = adj.shape[1]
    off, r = 700, 256
    jrows = np.asarray(jrefine._refine_chunk_impl(
        jidx.points.codes, jidx.points.scales, jnp.asarray(adj), jnp.int32(off),
        r=r, hop_w=hop_w, pool_p=pool_p, cap=cap, use_alg4=use_alg4))
    trows = trefine._refine_chunk_impl(
        tidx.points.codes, tidx.points.scales, torch.from_numpy(adj), off, r,
        hop_w, pool_p, cap, use_alg4).numpy()
    same = (trows == jrows).all(axis=1)
    print(f"refined rows equal: {same.mean():.4f}")
    assert same.mean() >= 0.95
    assert not (trows == np.arange(off, off + r)[:, None]).any()  # no self edge
    for a, b in zip(trows[~same], jrows[~same]):
        assert len(set(a[a >= 0]) & set(b[b >= 0])) >= 0.5 * (b >= 0).sum()


def test_refine_layer_matches_jax_and_keeps_the_invariants(pair):
    ds, jidx, tidx, truth = pair
    before = tidx.graph.get_layer(0).clone()
    tidx.finalize(pivots=128)
    rec0 = _recall(tidx.ann_batch(ds.test, K, 24)[1], truth)
    jidx.refine(rounds=1, batch=512)
    assert tidx.refine(rounds=1, batch=512) is tidx
    # refine drops the packed rows of layer 0; the pivots stay
    assert tidx._packed0 is None and tidx._pivots is not None
    assert tidx.serving_route() == "seeded_plain"
    ja = np.asarray(jidx.graph.get_layer(0))
    ta = tidx.graph.get_layer(0).numpy()
    assert not np.array_equal(ta, before.numpy())
    same = (ta == ja).all(axis=1)
    print(f"refined layer rows equal: {same.mean():.4f}")
    assert same.mean() >= 0.95
    assert tidx.assert_param_compliance(verbose=False)
    np.testing.assert_array_equal(
        tidx.graph.indeg(0).numpy(),
        np.bincount(ta[ta >= 0], minlength=N))
    jidx.finalize(pivots=128)
    tidx.finalize(pivots=128)
    rj = _recall(jidx.ann_batch(ds.test, K, 24)[1], truth)
    rt = _recall(tidx.ann_batch(ds.test, K, 24)[1], truth)
    print(f"recall@10 at ef=24: before {rec0:.4f}, refined {rt:.4f}, JAX {rj:.4f}")
    assert abs(rt - rj) <= 0.01, (rt, rj)
    assert rt >= rec0 - 0.01


def test_refine_edge_cases():
    ds = synthetic_heavy_tailed(300, 16, n_queries=8, seed=1)
    idx = HNSW(6, ef_cons=24, dim=16, device="cpu")
    assert idx.refine() is idx  # empty index: nothing to do
    idx.insert_bulk(ds.train)
    idx.finalize(pivots=32, pq_m=4)
    assert idx.serving_route() == "pq"
    a0 = idx.graph.get_layer(0).clone()
    idx.refine(rounds=0)
    assert torch.equal(idx.graph.get_layer(0), a0)
    idx.refine(rounds=2, hop_w=4, pool_p=32, batch=128)  # ragged last chunk
    assert idx._pq is None and idx._packed0 is None
    assert idx.assert_param_compliance(verbose=False)
    a1 = idx.graph.get_layer(0).clone()
    idx.refine(layer=1)  # an upper layer leaves layer 0 and its layouts alone
    assert torch.equal(idx.graph.get_layer(0), a1)
    # every chunk reads the old adjacency: the chunk size changes nothing
    x, y = (HNSW(6, ef_cons=24, dim=16, device="cpu") for _ in range(2))
    for i, b in ((x, 64), (y, 300)):
        i.insert_bulk(ds.train)
        i.refine(batch=b)
    assert torch.equal(x.graph.get_layer(0), y.graph.get_layer(0))
