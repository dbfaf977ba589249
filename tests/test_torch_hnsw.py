"""The whole slice — cluster-bulk build, finalize, pivot-seeded serving,
persistence — in the PyTorch port against the JAX package on the CPU, at
the size of tests/test_cluster_build.py (N=4000, d=32, M=12).

Graphs are recall-gated, as the JAX package gates its own: the port's
recall@10 must clear 0.95 and sit within 0.02 of JAX's. Given the JAX
package's graph and pivots, serving must return the same ids on >= 99% of
entries (near-ties may swap where the two sides sum in different
orders) and the same recall within 0.005. Saved indexes load across the
packages bit for bit.
"""

import json

import numpy as np
import pytest

from hnsw_rs_tpu import HNSW as JHNSW
from hnsw_rs_tpu.models.flat import FlatIndex as JFlatIndex
from hnsw_rs_tpu_torch import FlatIndex, HNSW, Params
from hnsw_rs_tpu_torch.utils.datasets import synthetic_clustered

N, D, K, EF = 4000, 32, 10, 48


def _recall(ids, truth):
    return float(np.mean([len(set(a) & set(t)) / K for a, t in zip(ids, truth)]))


@pytest.fixture(scope="module")
def built():
    ds = synthetic_clustered(N, D, n_queries=128, seed=11)
    jidx = JHNSW(12, ef_cons=48, dim=D)
    jidx.insert_bulk(ds.train, cluster_build=True)
    jidx.finalize(pivots=256)
    tidx = HNSW(12, ef_cons=48, dim=D, device="cpu")
    tidx.insert_bulk(ds.train, cluster_build=True)
    tidx.finalize(pivots=256)
    flat = FlatIndex(D, "cpu")
    flat.add(ds.train)
    _, truth = flat.search(ds.test, K, fused=True)
    return ds, jidx, tidx, truth


def test_store_and_ground_truth_match_jax(built):
    ds, jidx, tidx, truth = built
    np.testing.assert_array_equal(tidx.points.codes.numpy(), np.asarray(jidx.points.codes))
    np.testing.assert_array_equal(tidx.points.scales.numpy(), np.asarray(jidx.points.scales))
    np.testing.assert_array_equal(tidx.points.levels, jidx.points.levels)
    assert tidx.ep == jidx.ep and len(tidx.graph) == len(jidx.graph)
    jflat = JFlatIndex(D)
    jflat.add(ds.train)
    jd, ji = jflat.search(ds.test, K)
    np.testing.assert_array_equal(truth, ji)
    flat = FlatIndex(D, "cpu")
    flat.add(ds.train)
    td, ti = flat.search(ds.test, K)
    np.testing.assert_array_equal(ti, ji)
    # the affine form cancels |q|^2 + |x|^2 (~20 here): its d2 error is a
    # few ulps of that, absolute
    np.testing.assert_allclose(td ** 2, jd ** 2, rtol=1e-5, atol=5e-5)


def test_port_build_recall_matches_jax(built):
    ds, jidx, tidx, truth = built
    rj = _recall(jidx.ann_batch(ds.test, K, EF)[1], truth)
    rt = _recall(tidx.ann_batch(ds.test, K, EF)[1], truth)
    assert rt >= 0.95, rt
    assert abs(rt - rj) <= 0.02, (rt, rj)


def test_jax_index_serves_the_same_in_the_port(built, tmp_path):
    ds, jidx, _, truth = built
    jidx.save(str(tmp_path / "j"))
    with open(tmp_path / "j" / "params.json") as f:
        meta = json.load(f)
    with np.load(tmp_path / "j" / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    port = HNSW.from_numpy(meta, arrays, "cpu",
                           pivot_ids=np.asarray(jidx._pivots[0]))
    jd, ji = jidx.ann_batch(ds.test, K, EF)
    td, ti = port.ann_batch(ds.test, K, EF)
    assert np.mean(ti == ji) >= 0.99
    assert abs(_recall(ti, truth) - _recall(ji, truth)) <= 0.005
    np.testing.assert_allclose(td[ti == ji], jd[ti == ji], rtol=1e-5, atol=1e-5)


def _same_arrays(a, b):
    for name, x in a.items():
        np.testing.assert_array_equal(np.asarray(x), np.asarray(b[name]), err_msg=name)
    assert set(a) == set(b)


def test_cross_load_both_directions(built, tmp_path):
    ds, jidx, tidx, truth = built
    jidx.save(str(tmp_path / "from_jax"))
    loaded = HNSW.load(str(tmp_path / "from_jax"), "cpu")
    with np.load(tmp_path / "from_jax" / "arrays.npz") as z:
        _same_arrays(loaded.to_numpy()[1], {k: z[k] for k in z.files})
    loaded.finalize(pivots=256)
    # on the same graph, finalize picks the JAX package's pivots: cluster
    # reps, level picks, then the k-center fill
    np.testing.assert_array_equal(loaded._pivots[0].numpy(),
                                  np.asarray(jidx._pivots[0]))
    assert _recall(loaded.ann_batch(ds.test, K, EF)[1], truth) >= 0.95
    loaded.finalize(pivots=300, pivot_fill="stride", packed=False)
    jstride = JHNSW.load(str(tmp_path / "from_jax"))
    jstride.finalize(pivots=300, pivot_fill="stride", packed=False)
    np.testing.assert_array_equal(loaded._pivots[0].numpy(),
                                  np.asarray(jstride._pivots[0]))
    assert loaded._packed0 is None
    assert _recall(loaded.ann_batch(ds.test, K, EF)[1], truth) >= 0.95

    tidx.save(str(tmp_path / "from_port"))
    jloaded = JHNSW.load(str(tmp_path / "from_port"))
    _same_arrays(tidx.to_numpy()[1], {
        "codes": jloaded.points.codes, "scales": jloaded.points.scales,
        "levels": jloaded.points.levels,
        "cluster_pivots": jloaded._cluster_pivots,
        **{f"adj_{i}": a for i, a in enumerate(jloaded.graph.adjs)},
    })
    jloaded.finalize(pivots=256)
    assert _recall(jloaded.ann_batch(ds.test, K, EF)[1], truth) >= 0.95


def test_unported_routes_raise(built):
    """What the port does not carry yet raises: PQ serving, E>1
    construction, wave_sort, build_seeded and the cosine metric. A
    cluster-built index without pivots now serves through hierarchical
    descent, and extending it wave-inserts."""
    ds, _, tidx, _ = built
    with pytest.raises(NotImplementedError):
        tidx.finalize(pivots=256, pq_m=8)
    for kw in ({"build_expand": 2}, {"wave_sort": True}, {"build_seeded": True}):
        with pytest.raises(NotImplementedError):
            HNSW(8, dim=D, device="cpu").insert_bulk(ds.train[:100], **kw)
    with pytest.raises(NotImplementedError, match="metric"):
        HNSW(8, params=Params(m=8, dim=D, metric="cosine"), device="cpu")
    plain = HNSW(8, dim=D, device="cpu")
    plain.insert_bulk(ds.train[:500], cluster_build=True)
    plain.finalize(pivots=0)
    assert plain.serving_route() == "packed"
    _, ids = plain.ann_batch(ds.train[:20], K, EF)
    assert np.mean(ids[:, 0] == np.arange(20)) >= 0.95
    plain.insert_bulk(ds.train[500:600], cluster_build=True)
    assert len(plain) == 600 and plain.serving_route() == "plain"
    assert plain.assert_param_compliance(verbose=False)
