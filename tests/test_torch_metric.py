"""The complete ``FlatIndex`` (raw-float rows, ``exact``, the one-sort
path, persistence) and the cosine metric through ``HNSW``, ``FlatIndex``
and ``IVFFlatIndex`` in the PyTorch port against the JAX package on the
CPU, at the sizes of tests/test_metric.py and tests/test_ivf.py.

Tolerances. ``normalize`` sums d squares in another order than XLA, so a
unit vector may differ in the last float32 ulps (held to 1e-6 relative);
the quantization codes of normalized vectors are therefore equal except
where such an ulp crosses a rounding boundary (at most 0.1% of the codes,
counted, each off by one level). Ids from ``exact=True`` on the same
stored codes: equal. Distances: 1e-5 relative on d2. Saved directories
load in the other package bit for bit.
"""

import numpy as np
import pytest
import torch

from hnsw_rs_tpu import HNSW as JHNSW
from hnsw_rs_tpu import FlatIndex as JFlatIndex
from hnsw_rs_tpu.models.ivf import IVFFlatIndex as JIVFFlatIndex
from hnsw_rs_tpu.ops import normalize as j_normalize
from hnsw_rs_tpu.utils import gen_rand_vecs
from hnsw_rs_tpu_torch import FlatIndex, HNSW, IVFFlatIndex, Params
from hnsw_rs_tpu_torch.models import flat as flat_mod
from hnsw_rs_tpu_torch.ops.distance import normalize


def _recall(ids, truth, k=10):
    return float(np.mean([len(set(a) & set(t)) / k for a, t in zip(ids, truth)]))


def test_normalize_matches_jax():
    x = gen_rand_vecs(300, 24, seed=0) - 0.5
    x[7] = 0.0  # a zero vector passes through
    got = normalize(torch.from_numpy(x)).numpy()
    want = np.asarray(j_normalize(x))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.all(got[7] == 0.0)
    np.testing.assert_allclose(np.linalg.norm(np.delete(got, 7, 0), axis=1), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("quantized", [True, False], ids=["u8", "raw_f32"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_flat_matches_jax(quantized, metric):
    """The same vectors through both packages' ``FlatIndex``: stored codes
    (bit for bit under l2; counted ulp flips under cosine), then, on the
    JAX package's stored rows, ids equal in the ``exact`` and default
    forms and d2 within 1e-5."""
    store = gen_rand_vecs(400, 24, seed=0) - 0.5
    queries = gen_rand_vecs(16, 24, seed=1) - 0.5
    j = JFlatIndex(24, quantized=quantized, metric=metric)
    j.add(store)
    t = FlatIndex(24, "cpu", quantized=quantized, metric=metric)
    ids = t.add(store)
    assert ids[0] == 0 and ids[-1] == 399 and len(t) == 400
    jc = np.asarray(j.codes)
    if metric == "l2":
        np.testing.assert_array_equal(t.codes.numpy(), jc)
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    elif quantized:
        off = t.codes.numpy().astype(np.int32) - jc.astype(np.int32)
        assert np.abs(off).max() <= 1 and np.mean(off != 0) <= 1e-3
    else:
        np.testing.assert_allclose(t.codes.numpy(), jc, rtol=1e-6)
    # the search alone: the JAX package's stored rows in the port's index
    t.codes = torch.from_numpy(jc.copy())
    t.scales = torch.from_numpy(np.asarray(j.scales).copy())
    t._normsq = flat_mod.point_normsq(t.codes, t.scales)
    for exact in (True, False):
        jd, ji = j.search(queries, 10, exact=exact)
        td, ti = t.search(queries, 10, exact=exact)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td ** 2, jd ** 2, rtol=1e-5, atol=2e-6)


def test_flat_sort_path_breaks_ties_by_id(monkeypatch):
    """Up to ``_SORT_PATH_MAX`` rows one (d2, id) sort decides: duplicated
    points come back in id order, as in the JAX package; past it the tiled
    path serves and still finds them."""
    base = gen_rand_vecs(40, 12, seed=3)
    store = np.concatenate([base, base, base])  # every point three times
    j = JFlatIndex(12)
    j.add(store)
    t = FlatIndex(12, "cpu")
    t.add(store)
    _, ji = j.search(base[:8], 3)
    _, ti = t.search(base[:8], 3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ti, np.arange(8)[:, None] + [0, 40, 80])
    monkeypatch.setattr(flat_mod, "_SORT_PATH_MAX", 50)
    monkeypatch.setattr(flat_mod, "_TILE", 64)
    _, tt = t.search(base[:8], 3)
    assert np.array_equal(np.sort(tt, axis=1), ti)
    monkeypatch.setattr(flat_mod, "_TEMP_BYTES", 4096)  # exact, tile by tile
    _, te = t.search(base[:8], 3, exact=True)
    np.testing.assert_array_equal(te, ti)


def test_flat_fused_refuses_raw_float_and_unknown_metric():
    t = FlatIndex(8, "cpu", quantized=False)
    t.add(gen_rand_vecs(50, 8, seed=4))
    with pytest.raises(ValueError, match="quantized"):
        t.search(gen_rand_vecs(2, 8, seed=5), 3, fused=True)
    with pytest.raises(ValueError, match="metric"):
        FlatIndex(8, "cpu", metric="dot")
    with pytest.raises(ValueError, match="metric"):
        HNSW(8, dim=8, metric="ip", device="cpu")
    with pytest.raises(ValueError, match="metric"):
        IVFFlatIndex(8, metric="dot", device="cpu")


def test_flat_cosine_scale_invariance_and_fused():
    store = gen_rand_vecs(200, 16, seed=2) - 0.5
    idx = FlatIndex(16, "cpu", metric="cosine")
    idx.add(store)
    _, i1 = idx.search(store[3], 5)
    _, i2 = idx.search(store[3] * 37.0, 5)  # scaling keeps the cosine order
    np.testing.assert_array_equal(i1, i2)
    assert i1[0, 0] == 3
    _, i3 = idx.search(store[:20], 5, fused=True)
    _, i4 = idx.search(store[:20], 5, exact=True)
    assert _recall(i3, i4, 5) >= 0.99


@pytest.mark.parametrize("quantized", [True, False], ids=["u8", "raw_f32"])
def test_flat_save_load_across_packages(tmp_path, quantized):
    vecs = gen_rand_vecs(300, 14, seed=20)
    queries = gen_rand_vecs(12, 14, seed=21)
    t = FlatIndex(14, "cpu", quantized=quantized, metric="cosine")
    t.add(vecs)
    td, ti = t.search(queries, 6, exact=True)
    t.save(str(tmp_path / "port"))
    j = JFlatIndex.load(str(tmp_path / "port"))
    assert j.quantized == quantized and j.metric == "cosine" and len(j) == 300
    np.testing.assert_array_equal(np.asarray(j.codes), t.codes.numpy())
    np.testing.assert_array_equal(np.asarray(j.scales), t.scales.numpy())
    jd, ji = j.search(queries, 6, exact=True)
    np.testing.assert_array_equal(ji, ti)
    j.save(str(tmp_path / "jax"))
    back = FlatIndex.load(str(tmp_path / "jax"), "cpu")
    assert back.quantized == quantized and back.metric == "cosine"
    assert torch.equal(back.codes, t.codes) and torch.equal(back.scales, t.scales)
    bd, bi = back.search(queries, 6, exact=True)
    np.testing.assert_array_equal(bi, ti)
    np.testing.assert_allclose(bd, td, rtol=0, atol=0)
    with open(tmp_path / "jax" / "params.json", "w") as f:
        f.write('{"format": "other"}')
    with pytest.raises(ValueError, match="format"):
        FlatIndex.load(str(tmp_path / "jax"), "cpu")


def _cosine_truth(index_codes, index_scales, queries, k=10):
    """Exact top-k in the quantized, normalized space through the JAX
    package's oracle form, on the given stored rows."""
    j = JFlatIndex(index_codes.shape[1], metric="cosine")
    j.codes, j.scales = index_codes, index_scales
    from hnsw_rs_tpu.ops.distance import point_normsq

    j._normsq = point_normsq(j.codes, j.scales)
    return j.search(queries, k, exact=True)[1]


def test_hnsw_cosine_recall_and_persistence(tmp_path):
    """``metric="cosine"`` through the port's HNSW (``insert_bulk``,
    ``insert_vec``, ``ann_batch``, ``save``/``load``): recall@10 > 0.95 at
    the JAX test's size and within 0.03 of the JAX package's, and the
    metric survives a round trip through either package."""
    store = gen_rand_vecs(500, 20, seed=3) - 0.5
    queries = gen_rand_vecs(30, 20, seed=4) - 0.5
    t = HNSW(12, dim=20, metric="cosine", device="cpu")
    t.insert_bulk(store[:499])
    assert t.insert_vec(store[499] * 9.0) == 499  # normalized on the way in
    t.flush()
    norms = np.linalg.norm(t.points.get_values(np.arange(500)), axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=0.02)
    j = JHNSW(12, dim=20, metric="cosine")
    j.insert_bulk(store)
    truth = _cosine_truth(np.asarray(t.points.codes[:500]),
                          np.asarray(t.points.scales[:500]), queries)
    jtruth = _cosine_truth(np.asarray(j.points.codes)[:500],
                           np.asarray(j.points.scales)[:500], queries)
    rt = _recall(t.ann_batch(queries, 10, 80)[1], truth)
    rj = _recall(j.ann_batch(queries, 10, ef=80)[1], jtruth)
    assert rt > 0.95 and abs(rt - rj) <= 0.03, (rt, rj)
    _, scaled = t.ann_batch(queries * 5.0, 10, 80)
    np.testing.assert_array_equal(scaled, t.ann_batch(queries, 10, 80)[1])

    t.save(str(tmp_path / "port"))
    jl = JHNSW.load(str(tmp_path / "port"))
    assert jl.params.metric == "cosine"
    assert _recall(jl.ann_batch(queries, 10, ef=80)[1], truth) > 0.95
    j.save(str(tmp_path / "jax"))
    tl = HNSW.load(str(tmp_path / "jax"), "cpu")
    assert tl.params.metric == "cosine"
    jd, ji = j.ann_batch(queries, 10, ef=80)
    td, ti = tl.ann_batch(queries, 10, 80)
    assert np.mean(ti == ji) >= 0.99
    p = HNSW(8, params=Params(m=8, dim=20, metric="cosine"), device="cpu")
    assert p.params.metric == "cosine"


def test_ivf_cosine_full_probe_is_exact():
    store = gen_rand_vecs(600, 16, seed=6) - 0.5
    queries = gen_rand_vecs(16, 16, seed=7) - 0.5
    ivf = IVFFlatIndex(16, n_lists=12, metric="cosine", device="cpu")
    ivf.train_add(store)
    truth = _cosine_truth(ivf.codes.numpy(), ivf.scales.numpy(), queries)
    _, ids = ivf.search(queries, 10, n_probe=12)  # all lists: exact
    np.testing.assert_array_equal(ids, truth)
    j = JIVFFlatIndex(16, n_lists=12, metric="cosine")
    j.train_add(store)
    _, jids = j.search(queries, 10, n_probe=12)
    assert _recall(ids, jids) >= 0.99  # the codes may differ by an ulp flip
