"""IVF-Flat in the PyTorch port against the JAX package on the CPU, at the
sizes of tests/test_ivf.py (N = 600-2,000, d = 8-24, 8-32 lists).

Tolerances. Quantization codes, list assignment given the same centroids,
block ids and the ``_pack`` layout: exact. ``_kmeans`` from the same init:
centroids within 1e-5 relative (the port sums each list's members by a
one-hot product, the JAX package by a scatter-add), assignment equal on
>= 99.5% of the points (counted). ``_ivf_search`` with the JAX run's
quantizer handed over (``from_numpy`` / ``load``): ids equal on both
branches, d2 within 1e-5 relative. The scanned branch, which no test of
the JAX package reaches, is reached in both packages by setting
``DENSE_IVF_SEARCH_LIMIT = 0`` before the first call at a fresh shape.
Full-probe IVF equals ``FlatIndex``.
"""

import numpy as np
import pytest
import torch

from hnsw_rs_tpu import FlatIndex as JFlatIndex
from hnsw_rs_tpu.models import ivf as j_ivf
from hnsw_rs_tpu.models.ivf import IVFFlatIndex as JIVFFlatIndex
from hnsw_rs_tpu.utils import gen_rand_vecs
from hnsw_rs_tpu_torch import FlatIndex, IVFFlatIndex
from hnsw_rs_tpu_torch.models import ivf as t_ivf

N, D, C = 2000, 24, 32


def _recall(ids, truth, k=10):
    return float(np.mean([len(set(a) & set(t)) / k for a, t in zip(ids, truth)]))


def _j_arrays(j):
    """The arrays a JAX index's ``save`` would write, straight from it."""
    n = len(j)
    return {"codes": np.asarray(j.codes)[:n], "scales": np.asarray(j.scales)[:n],
            "assign": np.asarray(j._assign)[:n],
            "centroids": np.asarray(j.centroids)}


def _j_meta(j):
    return {"format": "hnsw_rs_tpu.ivf.v1", "dim": j.dim, "n_lists": j.n_lists,
            "n_probe": j.n_probe, "kmeans_iters": j.kmeans_iters, "seed": j.seed,
            "metric": j.metric, "quantized_blocks": j.quantized_blocks,
            "n": len(j)}


@pytest.fixture(scope="module")
def built():
    vecs = gen_rand_vecs(N, D, seed=0)
    queries = gen_rand_vecs(32, D, seed=1)
    j = JIVFFlatIndex(D, n_lists=C, kmeans_iters=8)
    j.train_add(vecs)
    t = IVFFlatIndex(D, n_lists=C, kmeans_iters=8, device="cpu")
    ids = t.train_add(vecs)
    assert ids[0] == 0 and ids[-1] == N - 1 and len(t) == N
    assert set(t.build_phase_s) == {"quantize", "kmeans", "pack"}
    return vecs, queries, j, t


def test_kmeans_matches_jax_from_the_same_init(built):
    vecs, _, j, t = built
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=1e-5, atol=1e-6)
    same = float(np.mean(t._assign == np.asarray(j._assign)))
    print(f"assignment equal on {same:.4f} of {N} points")
    assert same >= 0.995
    # the function alone, one more shape, with empty clusters kept: two
    # init rows are the same point, so one of the two lists stays empty
    x = torch.from_numpy(gen_rand_vecs(500, 8, seed=2))
    init = np.asarray([3, 3, 10, 200, 450], np.int64)
    tc, ta = t_ivf._kmeans(x, torch.from_numpy(init), 5, 4)
    jc, ja = j_ivf._kmeans(x.numpy(), init.astype(np.int32), 5, 4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    assert np.mean(ta.numpy() == np.asarray(ja)) >= 0.995
    # after one step list 1 is still empty (the tie went to list 0, the
    # lowest) and keeps its centroid, the init row
    tc1, _ = t_ivf._kmeans(x, torch.from_numpy(init), 5, 1)
    jc1, _ = j_ivf._kmeans(x.numpy(), init.astype(np.int32), 5, 1)
    np.testing.assert_array_equal(tc1[1].numpy(), x[3].numpy())
    np.testing.assert_array_equal(np.asarray(jc1)[1], x[3].numpy())
    assert not np.array_equal(tc1[0].numpy(), x[3].numpy())


def test_assignment_and_pack_are_exact_given_the_jax_quantizer(built):
    vecs, _, j, _ = built
    x = torch.from_numpy(np.asarray(j_ivf.dequantize(j.codes, j.scales)))
    got = t_ivf._assign(x, torch.from_numpy(np.asarray(j.centroids)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j._assign))
    port = IVFFlatIndex.from_numpy(_j_meta(j), _j_arrays(j), "cpu")
    np.testing.assert_array_equal(port.blocks.numpy(), np.asarray(j.blocks))
    np.testing.assert_array_equal(port.bscales.numpy(), np.asarray(j.bscales))
    np.testing.assert_array_equal(port.block_ids.numpy(), np.asarray(j.block_ids))
    np.testing.assert_array_equal(port._counts, j._counts)


@pytest.mark.parametrize("quantized_blocks", [True, False], ids=["u8", "f32"])
def test_search_matches_jax_on_both_branches(built, monkeypatch, quantized_blocks):
    """The JAX run's quantizer in the port; ids equal and d2 within 1e-5,
    first on the one-shot branch, then (a fresh query count, so the JAX
    function is traced again and reads the constant) on the scanned one."""
    vecs, queries, j, _ = built
    meta = dict(_j_meta(j), quantized_blocks=quantized_blocks)
    port = IVFFlatIndex.from_numpy(meta, _j_arrays(j), "cpu")
    jj = JIVFFlatIndex(D, n_lists=C, quantized_blocks=quantized_blocks)
    jj.codes, jj.scales, jj._assign = j.codes, j.scales, j._assign
    jj.centroids, jj._n = j.centroids, N
    jj._pack()
    assert (port.bscales is None) == (not quantized_blocks)
    for p in (1, 6, C):
        jd, ji = jj.search(queries, 10, n_probe=p)
        td, ti = port.search(queries, 10, n_probe=p)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td ** 2, jd ** 2, rtol=1e-5, atol=1e-7)
    one_shot = port.search(queries[:29], 10, n_probe=6)
    monkeypatch.setattr(j_ivf, "DENSE_IVF_SEARCH_LIMIT", 0)
    monkeypatch.setattr(t_ivf, "DENSE_IVF_SEARCH_LIMIT", 0)
    monkeypatch.setattr(t_ivf, "_SCAN_TEMP", 29 * D * 4 * 7)  # several slices
    calls = []
    real = t_ivf._ivf_scan
    monkeypatch.setattr(t_ivf, "_ivf_scan",
                        lambda *a: calls.append(1) or real(*a))
    nq = 29 if quantized_blocks else 27  # shapes the JAX function never saw
    for p in (6, C):
        jd, ji = jj.search(queries[:nq], 10, n_probe=p)
        td, ti = port.search(queries[:nq], 10, n_probe=p)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td ** 2, jd ** 2, rtol=1e-5, atol=1e-7)
    assert len(calls) == 2
    # the two branches of the port agree with each other
    scanned = port.search(queries[:29], 10, n_probe=6)
    np.testing.assert_array_equal(scanned[1], one_shot[1])
    np.testing.assert_allclose(scanned[0], one_shot[0], rtol=1e-6)


def test_full_probe_equals_flat_and_probes_are_monotone(built):
    vecs, queries, j, t = built
    flat = FlatIndex(D, "cpu")
    flat.add(vecs)
    fd, truth = flat.search(queries, 10, exact=True)
    r = {}
    for p in (1, 4, 16, C):
        d, ids = t.search(queries, 10, n_probe=p)
        assert np.all(np.diff(d, axis=1) >= 0)
        r[p] = _recall(ids, truth)
    _, ids = t.search(queries, 10, n_probe=C)
    np.testing.assert_array_equal(ids, truth)  # probing every list is exact
    assert r[16] >= r[4] >= r[1] - 1e-9 and r[16] > 0.9
    _, self_ids = t.search(vecs[:64], 1, n_probe=4)
    assert np.mean(self_ids[:, 0] == np.arange(64)) == 1.0
    with pytest.raises(ValueError, match="untrained"):
        IVFFlatIndex(8, device="cpu").search(queries[:, :8], 3)


def test_add_is_a_tail_scatter_and_matches_jax():
    """``add`` after training: ids are stable row positions, small adds
    land in the headroom (the block width stays), a big one grows the
    blocks, and blocks, ids and counts equal the JAX package's after the
    same calls on the same quantizer."""
    d = 12
    first, second = gen_rand_vecs(600, d, seed=7), gen_rand_vecs(250, d, seed=8)
    queries = gen_rand_vecs(20, d, seed=9)
    j = JIVFFlatIndex(d, n_lists=16)
    j.train_add(first)
    t = IVFFlatIndex.from_numpy(_j_meta(j), _j_arrays(j), "cpu")
    w0 = int(t.blocks.shape[1])
    rng = np.random.default_rng(18)
    for _ in range(3):
        small = rng.standard_normal((7, d)).astype(np.float32)
        np.testing.assert_array_equal(t.add(small), j.add(small))
    assert int(t.blocks.shape[1]) == w0 and len(t) == 621
    ids1 = t.add(second)
    j.add(second)
    assert ids1[0] == 621 and ids1[-1] == 870 and len(t) == 871
    # one list swallowing a whole batch outgrows the shared width
    same = np.repeat(first[:1], 3 * w0, axis=0)
    t.add(same)
    j.add(same)
    assert int(t.blocks.shape[1]) > w0
    for a, b in ((t.blocks, j.blocks), (t.bscales, j.bscales),
                 (t.block_ids, j.block_ids)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(t._counts, j._counts)
    n = len(t)
    np.testing.assert_array_equal(t.codes[:n].numpy(), np.asarray(j.codes)[:n])
    jd, ji = j.search(queries, 10, n_probe=16)
    td, ti = t.search(queries, 10, n_probe=16)
    np.testing.assert_array_equal(ti, ji)
    _, self_ids = t.search(second[:32], 1, n_probe=4)
    assert np.mean(self_ids[:, 0] == 621 + np.arange(32)) == 1.0
    # add on an untrained index trains
    u = IVFFlatIndex(d, n_lists=8, device="cpu")
    assert u.add(first[:300])[-1] == 299 and u.centroids is not None


def test_f32_blocks_match_u8_blocks_and_grow():
    vecs = gen_rand_vecs(800, 20, seed=5)
    queries = gen_rand_vecs(16, 20, seed=6)
    a = IVFFlatIndex(20, n_lists=16, quantized_blocks=True, device="cpu")
    b = IVFFlatIndex(20, n_lists=16, quantized_blocks=False, device="cpu")
    a.train_add(vecs)
    b.train_add(vecs)
    for idx in (a, b):
        idx.add(np.repeat(vecs[:1], 200, axis=0))
    assert b.bscales is None and b.blocks.dtype == torch.float32
    da, ia = a.search(queries, 8, n_probe=6)
    db, ib = b.search(queries, 8, n_probe=6)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, rtol=1e-6, atol=1e-6)


def test_retrain_rebalances_and_uses_the_jax_seed():
    d = 16
    base = gen_rand_vecs(500, d, seed=11)
    drift = gen_rand_vecs(500, d, seed=12) + 4.0  # a far-away mode
    queries = drift[:24] + 0.01
    flat = FlatIndex(d, "cpu")
    flat.add(np.concatenate([base, drift]))
    _, truth = flat.search(queries, 10, exact=True)
    j = JIVFFlatIndex(d, n_lists=25, n_probe=3)
    j.train_add(base)
    t = IVFFlatIndex.from_numpy(_j_meta(j), _j_arrays(j), "cpu")
    t.add(drift)
    j.add(drift)
    lmax_before, occ_before = int(t.blocks.shape[1]), int(t._counts.max())
    # one Lloyd step from the seed + 1 init on the same rows: the same
    # centroids wherever no near-tie flipped a member (the far mode's
    # |x|^2 ~ 300 makes the expanded form's last bits noisy); another
    # seed would match nowhere
    t.retrain(kmeans_iters=1)
    j.retrain(kmeans_iters=1)
    close = np.isclose(t.centroids.numpy(), np.asarray(j.centroids),
                       rtol=1e-4, atol=1e-4).all(axis=1)
    same = float(np.mean(t._assign == np.asarray(j._assign)))
    print(f"retrain: {int(close.sum())} of 25 centroids equal, assignment "
          f"equal on {same:.4f}")
    assert close.sum() >= 20 and same >= 0.97
    t.retrain()
    assert int(t._counts.max()) < 0.5 * occ_before
    assert int(t.blocks.shape[1]) < 0.6 * lmax_before
    _, ids_after = t.search(queries, 10, n_probe=12)
    assert _recall(ids_after, truth) > 0.95
    with pytest.raises(ValueError, match="nothing stored"):
        IVFFlatIndex(d, device="cpu").retrain()


def test_save_load_across_packages(built, tmp_path):
    vecs, queries, j, t = built
    t.save(str(tmp_path / "port"))
    jl = JIVFFlatIndex.load(str(tmp_path / "port"))
    assert len(jl) == N and jl.n_lists == C
    td, ti = t.search(queries, 8, n_probe=5)
    jd, ji = jl.search(queries, 8, n_probe=5)
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_allclose(jd, td, rtol=1e-5, atol=1e-6)
    j.save(str(tmp_path / "jax"))
    tl = IVFFlatIndex.load(str(tmp_path / "jax"), "cpu")
    assert len(tl) == N and tl.n_probe == j.n_probe
    jd, ji = j.search(queries, 8)
    td, ti = tl.search(queries, 8)
    np.testing.assert_array_equal(ti, ji)
    more = gen_rand_vecs(50, D, seed=16)  # a loaded index keeps growing
    assert tl.add(more)[0] == N and len(tl) == N + 50
    _, self_ids = tl.search(more[:16], 1, n_probe=C)
    assert np.mean(self_ids[:, 0] == N + np.arange(16)) == 1.0
    meta, arrays = tl.to_numpy()
    assert meta["n"] == N + 50 and arrays["codes"].shape == (N + 50, D)


def test_chunked_kmeans_path(monkeypatch):
    """Past ``DENSE_KMEANS_LIMIT`` the coarse quantizer goes through the
    cluster-bulk build's kmeans: forced at toy size, full probe stays exact
    and partial probe a working ANN, as the JAX package's test holds it."""
    monkeypatch.setattr(t_ivf, "DENSE_KMEANS_LIMIT", 0)
    vecs = gen_rand_vecs(N, D, seed=7)
    queries = gen_rand_vecs(32, D, seed=8)
    flat = FlatIndex(D, "cpu")
    flat.add(vecs)
    _, truth = flat.search(queries, 10, exact=True)
    ivf = IVFFlatIndex(D, n_lists=C, kmeans_iters=8, device="cpu")
    ivf.train_add(vecs)
    assert _recall(ivf.search(queries, 10, n_probe=C)[1], truth) == 1.0
    assert _recall(ivf.search(queries, 10, n_probe=16)[1], truth) > 0.9
