"""IVF-PQ in the PyTorch port against the JAX package on the CPU, at the
sizes of tests/test_ivfpq.py (N = 1,100-4,000, d = 16-32, 16-32 lists).

Tolerances. With the JAX run's whole state handed over (``from_numpy``
with its centroids, codebooks, rotation and PQ codes), ``_ivfpq_search``
sums the m_pq table entries of a candidate in another order than XLA, so
an ADC d2 may differ in its last float32 ulps: ids must be equal except
where two candidates swap whose ADC d2 lie within 1e-5 relative of each
other (near-ties, counted and held under 1% of the entries), and after
``_rerank`` (exact distances) the ids are equal. PQ codes re-encoded by
the port from the JAX codebooks equal the JAX package's on >= 99.9% of
the bytes (an argmin near-tie may flip one). Trained from the same seeds
on both sides, recall agrees within 0.02.
"""

import numpy as np
import pytest
import torch

from hnsw_rs_tpu import FlatIndex as JFlatIndex
from hnsw_rs_tpu.models import ivf as j_ivf
from hnsw_rs_tpu.models import ivfpq as j_ivfpq
from hnsw_rs_tpu.models.ivfpq import IVFPQIndex as JIVFPQIndex
from hnsw_rs_tpu_torch.models import ivf as t_ivf
from hnsw_rs_tpu_torch.models import ivfpq as t_ivfpq
from hnsw_rs_tpu_torch.models.ivfpq import IVFPQIndex

N, D, C, M_PQ = 4000, 32, 32, 8


def _recall(ids, truth, k=10):
    return float(np.mean([len(set(a) & set(t)) / k for a, t in zip(ids, truth)]))


def _clustered(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.random((32, d), np.float32)
    a = rng.integers(0, 32, n)
    return (centers[a] + rng.normal(0, 0.05, (n, d))).astype(np.float32)


def _correlated(n, d, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 1, (n, 6)).astype(np.float32)
    w = rng.normal(0, 1, (6, d)).astype(np.float32)
    return (z @ w + rng.normal(0, 0.05, (n, d))).astype(np.float32)


def _handover(j, with_pq_codes=True):
    """(meta, arrays) of a JAX index, straight from its attributes; the PQ
    codes are read back out of its packed blocks."""
    n = len(j)
    meta = {"format": "hnsw_rs_tpu.ivfpq.v1", "dim": j.dim, "m_pq": j.m_pq,
            "n_lists": j.n_lists, "n_probe": j.n_probe,
            "kmeans_iters": j.kmeans_iters, "pq_iters": j.pq_iters,
            "rerank": j.rerank, "keep_codes": j.keep_codes, "seed": j.seed,
            "metric": j.metric, "n": n, "opq": j.opq, "opq_iters": j.opq_iters}
    arrays = {"codes": np.asarray(j.codes)[:n], "scales": np.asarray(j.scales)[:n],
              "assign": np.asarray(j._assign)[:n],
              "centroids": np.asarray(j.centroids),
              "codebooks": np.asarray(j.codebooks), "rot": np.asarray(j.rot)}
    if with_pq_codes:
        bids, blocks = np.asarray(j.block_ids), np.asarray(j.blocks)
        pq_codes = np.zeros((n, j.m_pq), np.uint8)
        pq_codes[bids[bids >= 0]] = blocks[bids >= 0]
        arrays["pq_codes"] = pq_codes
    return meta, arrays


@pytest.fixture(scope="module")
def built():
    vecs = _clustered(N, D, 0)
    queries = _clustered(64, D, 1)
    flat = JFlatIndex(D)
    flat.add(vecs)
    _, truth = flat.search(queries, 10, exact=True)
    j = JIVFPQIndex(D, n_lists=C, m_pq=M_PQ, rerank=40)
    j.train_add(vecs)
    t = IVFPQIndex(D, n_lists=C, m_pq=M_PQ, rerank=40, device="cpu")
    ids = t.train_add(vecs)
    assert ids[-1] == N - 1 and len(t) == N
    assert set(t.build_phase_s) == {"coarse", "pq_train", "encode", "pack"}
    return vecs, queries, truth, j, t


def _adc_swaps_are_near_ties(td, ti, jd, ji):
    """Entries whose id differs; each must sit beside an ADC d2 within
    1e-5 relative of its own in the other package's row."""
    diff = ti != ji
    for r, c in zip(*np.nonzero(diff)):
        near = np.isclose(jd[r] ** 2, td[r, c] ** 2, rtol=1e-5, atol=1e-9)
        assert near.sum() >= 2 or np.isclose(td[r, c], jd[r, c], rtol=1e-5), (r, c)
    return int(diff.sum())


def test_training_matches_jax_from_the_same_seeds(built):
    """Both random streams copied: the coarse init from ``default_rng(seed)``
    and the PQ init from a second generator with the same seed."""
    vecs, queries, truth, j, t = built
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=1e-5, atol=1e-6)
    assert np.mean(t._assign == np.asarray(j._assign)) >= 0.995
    np.testing.assert_allclose(t.codebooks.numpy(), np.asarray(j.codebooks),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t.rot.numpy(), np.eye(D, dtype=np.float32))
    assert t.blocks.shape == tuple(j.blocks.shape) and t.blocks.shape[-1] == M_PQ
    same = np.mean(t.blocks.numpy() == np.asarray(j.blocks))
    print(f"PQ block bytes equal: {same:.5f}")
    assert same >= 0.999
    np.testing.assert_array_equal(t.block_ids.numpy(), np.asarray(j.block_ids))


def test_search_matches_jax_given_its_state(built):
    vecs, queries, truth, j, _ = built
    port = IVFPQIndex.from_numpy(*_handover(j), "cpu")
    np.testing.assert_array_equal(port.blocks.numpy(), np.asarray(j.blocks))
    np.testing.assert_array_equal(port.block_ids.numpy(), np.asarray(j.block_ids))
    swaps = total = 0
    for p in (1, 8, C):
        jd, ji = j.search(queries, 10, n_probe=p, rerank=0)
        td, ti = port.search(queries, 10, n_probe=p, rerank=0)
        swaps += _adc_swaps_are_near_ties(td, ti, jd, ji)
        total += ti.size
        np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=2e-5,
                                   atol=1e-6)
        jd, ji = j.search(queries, 10, n_probe=p)  # ADC, then the rerank
        td, ti = port.search(queries, 10, n_probe=p)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td ** 2, jd ** 2, rtol=1e-5, atol=1e-7)
    print(f"ADC near-tie swaps: {swaps} of {total} entries")
    assert swaps <= 0.01 * total


def test_reencode_and_take_chunks(built, monkeypatch):
    """``load`` re-encodes the PQ codes from the u8 codes and codebooks:
    the bytes equal the JAX package's but for argmin near-ties; and the
    table take in slices gives what the whole take gives."""
    vecs, queries, truth, j, _ = built
    port = IVFPQIndex.from_numpy(*_handover(j, with_pq_codes=False), "cpu")
    same = np.mean(port.blocks.numpy() == np.asarray(j.blocks))
    print(f"re-encoded PQ bytes equal: {same:.5f}")
    assert same >= 0.999
    whole = port.search(queries, 10, n_probe=8, rerank=0)
    monkeypatch.setattr(t_ivfpq, "_TAKE_TEMP", 64 * M_PQ * 12 * 70)  # ~70 a slice
    sliced = port.search(queries, 10, n_probe=8, rerank=0)
    np.testing.assert_array_equal(sliced[1], whole[1])
    # the sum over the m_pq entries may round differently at another width
    np.testing.assert_allclose(sliced[0], whole[0], rtol=1e-6)


def test_recall_rerank_lift_and_probe_monotonicity(built):
    vecs, queries, truth, j, t = built
    r_adc = _recall(t.search(queries, 10, n_probe=8, rerank=0)[1], truth)
    r_rr = _recall(t.search(queries, 10, n_probe=8)[1], truth)
    rj_adc = _recall(j.search(queries, 10, n_probe=8, rerank=0)[1], truth)
    rj_rr = _recall(j.search(queries, 10, n_probe=8)[1], truth)
    print(f"recall ADC {r_adc:.4f} (JAX {rj_adc:.4f}), reranked {r_rr:.4f} "
          f"(JAX {rj_rr:.4f})")
    assert r_adc > 0.6 and r_rr >= r_adc - 1e-9 and r_rr > 0.9
    assert abs(r_adc - rj_adc) <= 0.02 and abs(r_rr - rj_rr) <= 0.02
    r = {p: _recall(t.search(queries, 10, n_probe=p)[1], truth) for p in (1, 4, 16)}
    assert r[16] >= r[4] >= r[1] - 1e-9 and r[16] > 0.9
    with pytest.raises(ValueError, match="must divide"):
        IVFPQIndex(30, m_pq=7, device="cpu")
    with pytest.raises(ValueError, match="untrained"):
        IVFPQIndex(32, m_pq=8, device="cpu").search(queries, 3)
    no_codes = IVFPQIndex.from_numpy(
        dict(_handover(j)[0], keep_codes=False), _handover(j)[1], "cpu")
    assert isinstance(no_codes.codes, np.ndarray)  # spilled to the host
    with pytest.raises(ValueError, match="keep_codes"):
        no_codes.search(queries, 3, rerank=10)
    assert _recall(no_codes.search(queries, 10, rerank=0)[1], truth) > 0.6


@pytest.mark.parametrize("keep_codes", [True, False], ids=["device", "host"])
def test_incremental_add_matches_jax(keep_codes):
    d = 16
    first, second = _clustered(900, d, 4), _clustered(200, d, 5)
    j = JIVFPQIndex(d, n_lists=16, m_pq=4, rerank=20, keep_codes=keep_codes)
    j.train_add(first)
    t = IVFPQIndex.from_numpy(*_handover(j), "cpu")
    ids = t.add(second)
    j.add(second)
    assert ids[0] == 900 and ids[-1] == 1099 and len(t) == 1100
    same = np.repeat(first[:1], 3 * int(t.blocks.shape[1]), axis=0)
    t.add(same)  # one list outgrows the shared width
    j.add(same)
    assert t.blocks.shape == tuple(j.blocks.shape)
    np.testing.assert_array_equal(t.block_ids.numpy(), np.asarray(j.block_ids))
    assert np.mean(t.blocks.numpy() == np.asarray(j.blocks)) >= 0.999
    n = len(t)
    codes = t.codes.numpy() if keep_codes else t.codes
    assert isinstance(t.codes, torch.Tensor) == keep_codes
    np.testing.assert_array_equal(codes[:n], np.asarray(j.codes)[:n])
    if keep_codes:
        _, self_ids = t.search(second[:32], 1, n_probe=16)
        assert np.mean(self_ids[:, 0] == 900 + np.arange(32)) > 0.9
    u = IVFPQIndex(d, n_lists=8, m_pq=4, device="cpu")  # add on an untrained index
    assert u.add(first[:300])[-1] == 299 and u.codebooks is not None


@pytest.mark.parametrize("opq", [False, True], ids=["pq", "opq"])
def test_save_load_across_packages(tmp_path, opq):
    n, d = 2000, 32
    vecs = _correlated(n, d, 8)
    queries = _correlated(32, d, 9)
    t = IVFPQIndex(d, n_lists=16, m_pq=4, rerank=20, opq=opq, opq_iters=3,
                   pq_iters=6, device="cpu")
    t.train_add(vecs)
    if opq:
        rot = t.rot.numpy()
        np.testing.assert_allclose(rot.T @ rot, np.eye(d), atol=1e-4)
    td, ti = t.search(queries, 5)
    t.save(str(tmp_path / "port"))
    jl = JIVFPQIndex.load(str(tmp_path / "port"))
    assert len(jl) == n and jl.opq == opq
    jd, ji = jl.search(queries, 5)
    assert np.mean(ji == ti) >= 0.98  # the JAX side re-encodes: near-ties
    back = IVFPQIndex.load(str(tmp_path / "port"), "cpu")
    bd, bi = back.search(queries, 5)
    np.testing.assert_array_equal(bi, ti)
    np.testing.assert_allclose(bd, td, rtol=1e-6)

    j = JIVFPQIndex(d, n_lists=16, m_pq=4, rerank=20, opq=opq, opq_iters=3,
                    pq_iters=6)
    j.train_add(vecs)
    j.save(str(tmp_path / "jax"))
    tl = IVFPQIndex.load(str(tmp_path / "jax"), "cpu")
    assert tl.opq == opq and len(tl) == n
    np.testing.assert_array_equal(tl.rot.numpy(), np.asarray(j.rot))
    jd, ji = j.search(queries, 5)
    td, ti = tl.search(queries, 5)
    assert np.mean(ti == ji) >= 0.98
    # same memory, better codes: OPQ's ADC recall holds on both sides
    flat = JFlatIndex(d)
    flat.add(vecs)
    _, truth = flat.search(queries, 10, exact=True)
    rt = _recall(t.search(queries, 10, n_probe=8, rerank=0)[1], truth)
    rj = _recall(j.search(queries, 10, n_probe=8, rerank=0)[1], truth)
    print(f"opq={opq}: ADC recall port {rt:.4f}, JAX {rj:.4f}")
    assert abs(rt - rj) <= 0.05


def test_subsampled_train_path(monkeypatch):
    """The large-N code path at toy size: chunked coarse kmeans, PQ
    codebooks trained on an evenly strided subsample, chunked encode."""
    for mod in (j_ivf, t_ivf):
        monkeypatch.setattr(mod, "DENSE_KMEANS_LIMIT", 0)
    for mod in (j_ivfpq, t_ivfpq):
        monkeypatch.setattr(mod, "_PQ_TRAIN_MAX", 512)
    monkeypatch.setattr(t_ivfpq, "_ENCODE_CHUNK", 700)
    n, d = 3000, 32
    vecs = _clustered(n, d, seed=3)
    queries = _clustered(64, d, seed=4)
    flat = JFlatIndex(d)
    flat.add(vecs)
    _, truth = flat.search(queries, 10, exact=True)
    t = IVFPQIndex(d, n_lists=32, m_pq=8, kmeans_iters=6, rerank=64, device="cpu")
    t.train_add(vecs)
    j = JIVFPQIndex(d, n_lists=32, m_pq=8, kmeans_iters=6, rerank=64)
    j.train_add(vecs)
    rt = _recall(t.search(queries, 10, n_probe=16)[1], truth)
    rj = _recall(j.search(queries, 10, n_probe=16)[1], truth)
    print(f"subsampled path: recall port {rt:.4f}, JAX {rj:.4f}")
    assert rt > 0.8 and abs(rt - rj) <= 0.02
