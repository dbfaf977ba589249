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
    """Nothing of ``HNSW`` raises as unported any more. The cosine metric,
    the last route that did, builds and serves (a scaled query gets the
    same answer; an unknown metric is a ``ValueError``), as do the four
    before it: PQ serving, E>1 construction, ``wave_sort`` and
    ``build_seeded``. A cluster-built index without pivots serves through
    hierarchical descent, and extending it wave-inserts."""
    ds, _, tidx, truth = built
    cos = HNSW(8, params=Params(m=8, dim=D, metric="cosine"), device="cpu")
    cos.insert_bulk(ds.train[:300])
    _, ids = cos.ann_batch(ds.train[:20] * 3.0, K, EF)
    assert np.mean(ids[:, 0] == np.arange(20)) >= 0.95
    with pytest.raises(ValueError, match="metric"):
        HNSW(8, params=Params(m=8, dim=D, metric="dot"), device="cpu")
    pq = HNSW.from_numpy(*tidx.to_numpy(), "cpu")
    pq.finalize(pivots=256, pq_m=8)
    assert pq.serving_route() == "pq" and pq._packed0 is None
    assert _recall(pq.ann_batch(ds.test, K, 96)[1], truth) >= 0.9
    for kw in ({"build_expand": 2}, {"wave_sort": True}, {"build_seeded": True}):
        small = HNSW(8, dim=D, device="cpu")
        small.insert_bulk(ds.train[:300], **kw)
        assert small.serving_route() == "packed"
        assert small.assert_param_compliance(verbose=False)
        _, ids = small.ann_batch(ds.train[:20], K, EF)
        assert np.mean(ids[:, 0] == np.arange(20)) >= 0.95, kw
    plain = HNSW(8, dim=D, device="cpu")
    plain.insert_bulk(ds.train[:500], cluster_build=True)
    plain.finalize(pivots=0)
    assert plain.serving_route() == "packed"
    _, ids = plain.ann_batch(ds.train[:20], K, EF)
    assert np.mean(ids[:, 0] == np.arange(20)) >= 0.95
    plain.insert_bulk(ds.train[500:600], cluster_build=True, wave_sort=True,
                      build_seeded=True, build_pivot_cap=64)
    assert len(plain) == 600 and plain.serving_route() == "plain"
    assert plain.assert_param_compliance(verbose=False)


def test_finalize_state_semantics(built):
    """``finalize`` sets the serving mode from its arguments alone, as the
    JAX package's tests hold it: ``pivots=0`` clears pivots and
    shortlists, ``pq_m`` needs pivots and must divide dim, ``pq_m=0``
    clears the PQ mode and brings the packed rows back."""
    ds, jidx, tidx, _ = built
    idx = HNSW.from_numpy(*tidx.to_numpy(), "cpu")
    assert idx.serving_route() == "plain"
    idx.finalize(expand=2, pivots=128, pivot_shortlist=8)
    assert idx.serve_expand == 2 and idx.serving_route() == "probe_packed"
    assert idx._pivot_shortlist.shape == (128, 8)
    assert idx._pivot_sl_pack.shape == (128, 8 * (D + 12))
    idx.finalize(pivots=128)  # without the flag the probed mode is gone
    assert idx._pivot_shortlist is None and idx._pivot_sl_pack is None
    assert idx.serve_expand == 1 and idx.serving_route() == "seeded"
    idx.finalize(expand=4)  # pivots are absolute state, not a delta
    assert idx._pivots is None and idx.serving_route() == "packed"
    idx.finalize(pivots=128, pivot_shortlist=8, packed=False)
    assert idx._pivot_sl_pack is None and idx._pivot_shortlist is not None
    assert idx.serving_route() == "seeded_plain"  # no packed rows: no probe
    with pytest.raises(ValueError, match="requires pivots"):
        idx.finalize(pq_m=8)
    with pytest.raises(ValueError, match="must divide"):
        idx.finalize(pivots=64, pq_m=7)
    with pytest.raises(ValueError, match="pq_bits"):
        idx.finalize(pivots=64, pq_m=8, pq_bits=5)
    with pytest.raises(ValueError, match="pivot_fill"):
        idx.finalize(pivots=64, pivot_fill="nope")
    idx.finalize(pivots=64, pq_m=8, pq_rerank=30)
    assert idx._pq is not None and idx.pq_rerank == 30 and idx._packed0 is None
    idx.finalize(pivots=64)  # pq_m=0 clears the PQ mode
    assert idx._pq is None and idx._packed0 is not None
    idx.finalize(pivots=64, pq_m=8, pq_bits=4, pq_opq=True, pq_iters=3)
    cb, pq_codes, packed_pq, rot = idx._pq
    assert cb.shape[:2] == (16, 16) and pq_codes.shape == (N, 8)  # pq_m bytes
    assert packed_pq.shape == (N, 24 * (8 + 4)) and rot.shape == (D, D)
    idx.insert_vec(ds.test[0])  # an insert makes every layout stale
    assert idx.serving_route() == "plain"


@pytest.mark.parametrize("mode", [
    {"pivots": 256, "expand": 2}, {"pivots": 256, "pivot_shortlist": 16},
    {"pivots": 256, "pq_m": 8, "pq_iters": 6},
    {"pivots": 256, "pq_m": 8, "pq_bits": 4, "pq_iters": 6}, {"expand": 4}],
    ids=["seeded_e2", "probe_packed", "pq8", "pq4", "packed_e4"])
def test_serving_modes_match_jax_on_the_same_graph(built, mode):
    """Each new ``ann_batch`` branch on the JAX package's graph: the same
    pivots and shortlists, recall within 0.01 of the JAX package's in the
    exact modes and 0.03 in the PQ modes (their codebooks are trained on
    each side), ids equal on >= 99% of entries in the exact modes."""
    ds, jidx, _, truth = built
    j = jidx
    j.finalize(**mode)
    port = HNSW.from_numpy(
        {"format": "hnsw_rs_tpu.v1", "params": j.params.to_dict(),
         "n_layers": len(j.graph), "level_rng_calls": 1},
        {"codes": np.asarray(j.points.codes), "scales": np.asarray(j.points.scales),
         "levels": np.asarray(j.points.levels),
         "cluster_pivots": np.asarray(j._cluster_pivots),
         **{f"adj_{i}": np.asarray(a) for i, a in enumerate(j.graph.adjs)}}, "cpu")
    port.finalize(**mode)
    if "pivots" in mode:
        np.testing.assert_array_equal(port._pivots[0].numpy(), np.asarray(j._pivots[0]))
    jd, ji = j.ann_batch(ds.test, K, EF)
    td, ti = port.ann_batch(ds.test, K, EF)
    rj, rt = _recall(ji, truth), _recall(ti, truth)
    print(f"{port.serving_route()}: recall port {rt:.4f}, JAX {rj:.4f}, "
          f"ids equal {np.mean(ti == ji):.4f}")
    if "pq_m" in mode:
        assert port.serving_route() == "pq" and abs(rt - rj) <= 0.03, (rt, rj)
    else:
        assert abs(rt - rj) <= 0.01 and np.mean(ti == ji) >= 0.99
        if "pivot_shortlist" in mode:
            assert port.serving_route() == "probe_packed"
            assert np.mean(port._pivot_shortlist.numpy()
                           == np.asarray(j._pivot_shortlist)) >= 0.995
    j.finalize(pivots=256)  # the module's fixture goes back as it was
