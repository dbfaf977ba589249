"""Out-of-core serving in the PyTorch port against the JAX package on the
CPU: ``BlockStore``, ``PagedHNSW`` and ``HybridPagedHNSW`` at the sizes of
tests/test_paged.py (N = 77-900, d = 12-20).

Tolerances. The block file and the paged directory: byte for byte the JAX
package's (each package reads the other's). Packed rows assembled from
disk: equal to ``search.pack_layer``'s rows. ``PagedHNSW.ann_batch``
(numpy on both sides): ids equal to the JAX reader's on a JAX-written and
on a port-written directory, distances to 1e-6. The hybrid exact tier:
ids equal to the port's in-memory seeded answers at E=1 and E=4, with
``hits + misses`` and ``dispatches`` equal to the JAX run's on the same
directory. The PQ tier (codebooks trained on each side): recall within
0.02 of the JAX run's.
"""

import filecmp
import json

import numpy as np
import pytest
import torch

from hnsw_rs_tpu import HNSW as JHNSW
from hnsw_rs_tpu.models import paged as j_paged
from hnsw_rs_tpu import store_paged as j_store
from hnsw_rs_tpu.utils import brute_force_nns as j_brute_force_nns
from hnsw_rs_tpu.utils import gen_rand_vecs
from hnsw_rs_tpu_torch import FlatIndex, HNSW
from hnsw_rs_tpu_torch import store_paged as t_store
from hnsw_rs_tpu_torch.models.paged import (
    HybridPagedHNSW,
    PagedHNSW,
    _quantized_queries,
    save_paged,
)
from hnsw_rs_tpu_torch.ops.distance import point_normsq
from hnsw_rs_tpu_torch.ops.quant import quantize
from hnsw_rs_tpu_torch.search import pack_layer
from hnsw_rs_tpu_torch.store import sample_levels

N, D, K, EF = 900, 16, 10, 48


def _recall(ids, truth, k=K):
    return float(np.mean([len(set(a) & set(t)) / k for a, t in zip(ids, truth)]))


def _store(tmp_path, n, d, seed):
    vecs = gen_rand_vecs(n, d, seed=seed)
    codes, scales = (t.numpy() for t in quantize(torch.from_numpy(vecs)))
    levels = sample_levels(n, 0.4, seed=seed)
    tp, jp = str(tmp_path / "port.blocks"), str(tmp_path / "jax.blocks")
    t_store.write_block_store(tp, codes, scales, levels)
    j_store.write_block_store(jp, codes, scales, levels)
    return tp, jp, codes, scales, levels


def test_block_file_is_the_jax_packages_byte_for_byte(tmp_path):
    tp, jp, codes, scales, levels = _store(tmp_path, 77, 16, 0)  # ragged last block
    assert filecmp.cmp(tp, jp, shallow=False)
    for path in (tp, jp):
        bs = t_store.BlockStore(path, cache_blocks=2)
        assert len(bs) == 77 and bs.nb_blocks == -(-77 // t_store.MAX_PER_BLOCK)
        for i in range(77):
            c, s, lv = bs.get_point(i)
            np.testing.assert_array_equal(c, codes[i])
            np.testing.assert_array_equal(s, scales[i])
            assert lv == levels[i]
        assert bs.get_point(77) is None and bs.get_point(-1) is None
        assert len(bs._cache) <= 2  # the LRU holds its bound
        want = codes[5].astype(np.float32) * scales[5, 1] + scales[5, 0]
        np.testing.assert_array_equal(bs.get_values(5), want)
        ids = np.asarray([76, 0, 33, 33, 64, 5])
        gc, gs = bs.gather(ids)
        np.testing.assert_array_equal(gc, codes[ids])
        np.testing.assert_array_equal(gs, scales[ids])
        bs.close()
    jbs = j_store.BlockStore(tp)  # the JAX reader on the port's file
    np.testing.assert_array_equal(jbs.get_point(70)[0], codes[70])
    (tmp_path / "junk").write_bytes(b"nope" * 8)
    with pytest.raises(ValueError, match="not a block store"):
        t_store.BlockStore(str(tmp_path / "junk"))


def test_chunks_and_streaming_search_match_jax(tmp_path, monkeypatch):
    tp, jp, codes, scales, _ = _store(tmp_path, 300, 12, 3)
    bs = t_store.BlockStore(tp)
    seen = 0
    for (c, s, start), (jc, js, jstart) in zip(
            bs.iter_chunks(chunk_blocks=3),
            j_store.BlockStore(jp).iter_chunks(chunk_blocks=3)):
        assert start == seen == jstart
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(c, codes[seen:seen + c.shape[0]])
        seen += c.shape[0]
    assert seen == 300
    queries = gen_rand_vecs(9, 12, seed=4)
    jd, ji = j_store.BlockStore(jp).search_streaming(queries, 10, chunk_blocks=2)
    # a temp budget of 3 queries a tile: the query tiling is exercised
    monkeypatch.setattr(t_store, "_TEMP_BYTES", 3 * 64 * 12 * 4)
    td, ti = bs.search_streaming(queries, 10, chunk_blocks=2, device="cpu")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    np.testing.assert_array_equal(
        ti, np.asarray(j_brute_force_nns(queries, codes, scales, 10)))
    flat = FlatIndex(12, "cpu")
    flat.codes, flat.scales = torch.from_numpy(codes), torch.from_numpy(scales)
    flat._normsq = point_normsq(flat.codes, flat.scales)
    np.testing.assert_array_equal(ti, flat.search(queries, 10, exact=True)[1])


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """One JAX wave build; the same graph and pivots in the port; the paged
    directory written by each package."""
    root = tmp_path_factory.mktemp("paged")
    vecs = gen_rand_vecs(N, D, seed=31)
    queries = gen_rand_vecs(24, D, seed=32)
    j = JHNSW(8, ef_cons=32, dim=D)
    j.insert_bulk(vecs)
    j.finalize(pivots=4096)
    j.save(str(root / "jidx"))
    with open(root / "jidx" / "params.json") as f:
        meta = json.load(f)
    with np.load(root / "jidx" / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    t = HNSW.from_numpy(meta, arrays, "cpu", pivot_ids=np.asarray(j._pivots[0]))
    jdir, tdir = str(root / "jax_dir"), str(root / "port_dir")
    j_paged.save_paged(j, jdir)
    save_paged(t, tdir)
    return vecs, queries, j, t, jdir, tdir


def test_paged_directory_is_the_jax_packages(built):
    _, _, j, t, jdir, tdir = built
    for name in ("points.blocks", "layer0.adj"):
        assert filecmp.cmp(f"{jdir}/{name}", f"{tdir}/{name}", shallow=False), name
    with open(f"{jdir}/paged.json") as f, open(f"{tdir}/paged.json") as g:
        assert json.load(f) == json.load(g)
    with np.load(f"{jdir}/upper.npz") as a, np.load(f"{tdir}/upper.npz") as b:
        assert sorted(a.files) == sorted(b.files) and "pivot_ids" in a.files
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
            assert a[name].dtype == b[name].dtype, name


def test_packed_rows_from_disk_equal_pack_layer(built):
    _, _, _, t, jdir, tdir = built
    n = len(t)
    want = pack_layer(t.graph.get_layer(0)[:n], t.points.codes[:n],
                      t.points.scales[:n]).numpy()
    ids = np.asarray([0, 899, 17, 17, 450, 31, 32, 33])
    for path in (jdir, tdir):
        pg = PagedHNSW(path, cache_blocks=4)
        np.testing.assert_array_equal(pg._packed_rows_host(ids), want[ids])
        c, s = pg._codes_scales(ids)
        np.testing.assert_array_equal(c, t.points.codes[ids].numpy())
        np.testing.assert_array_equal(s, t.points.scales[ids].numpy())
        jrows = j_paged.PagedHNSW(path)._packed_rows_host(ids)
        np.testing.assert_array_equal(pg._packed_rows_host(ids), jrows)


@pytest.mark.parametrize("which", ["jax_dir", "port_dir"])
def test_paged_reader_matches_jax_reader(built, which):
    vecs, queries, j, t, jdir, tdir = built
    path = jdir if which == "jax_dir" else tdir
    pg = PagedHNSW(path, cache_blocks=4)  # a tiny cache: real paging
    jd, ji = j_paged.PagedHNSW(path, cache_blocks=4).ann_batch(queries, K, 40)
    td, ti = pg.ann_batch(queries, K, 40)
    assert len(pg) == N
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    # the in-memory index through hierarchical descent gives the same ids
    plain = HNSW.from_numpy(*t.to_numpy(), "cpu")
    md, mi = plain.ann_batch(queries, K, 40)
    np.testing.assert_array_equal(ti, mi)
    np.testing.assert_allclose(td, md, rtol=1e-5)
    assert int(pg.ann_by_vector(vecs[7], 1, 40)[0]) == 7


@pytest.mark.parametrize("e", [1, 4])
def test_hybrid_exact_tier_matches_in_memory_and_jax_counters(built, e):
    """Hot tier = a tenth of the rows (cold staging on most expansions),
    then every row hot: the port's in-memory seeded answers either way,
    and the JAX run's expansion and iteration counts."""
    vecs, queries, j, t, jdir, tdir = built
    t.serve_expand = e
    md, mi = t.ann_batch(queries, K, EF)
    t.serve_expand = 1
    wrow = t.graph.get_layer(0).shape[1] * (D + 12)
    jh = j_paged.HybridPagedHNSW(jdir, hot_bytes=(N // 10) * wrow, pivots=4096)
    jd, ji = jh.ann_batch(queries, K, EF, expand_e=e)
    for path in (jdir, tdir):
        hy = HybridPagedHNSW(path, hot_bytes=(N // 10) * wrow, pivots=4096,
                             device="cpu")
        assert hy.hot_rows <= N // 10
        assert hy.device_bytes == hy.hot_rows * wrow + N * 4
        assert hy.pivot_bytes == hy._pivot_ids.numel() * (4 + D * 4)
        hd, hi = hy.ann_batch(queries, K, EF, expand_e=e)
        np.testing.assert_array_equal(hi, mi)
        np.testing.assert_allclose(hd, md, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(hi, ji)
        assert hy.misses > 0 and hy.hits > 0
        assert hy.hits + hy.misses == jh.hits + jh.misses
        assert (hy.hits, hy.misses) == (jh.hits, jh.misses)
        assert hy.dispatches == jh.dispatches
    hot_all = HybridPagedHNSW(tdir, hot_bytes=N * wrow, pivots=4096, device="cpu")
    ad, ai = hot_all.ann_batch(queries, K, EF, expand_e=e)
    assert hot_all.misses == 0 and hot_all.hits > 0  # no cold lane at all
    np.testing.assert_array_equal(ai, mi)


def test_hybrid_expand_and_prefetch(built):
    """E=4 takes under half the iterations of E=1 at no lower recall, and
    the speculative prefetch only warms caches: the same answers, with
    lookahead rows served from the row cache."""
    vecs, queries, j, t, jdir, tdir = built
    flat = FlatIndex(D, "cpu")
    flat.add(vecs)
    _, truth = flat.search(queries, K, exact=True)
    wrow = t.graph.get_layer(0).shape[1] * (D + 12)
    hy = HybridPagedHNSW(tdir, hot_bytes=(N // 10) * wrow, pivots=4096, device="cpu")
    d1, i1 = hy.ann_batch(queries, K, EF, expand_e=1)
    disp1 = hy.dispatches
    _, i4 = hy.ann_batch(queries, K, EF, expand_e=4)
    assert hy.dispatches < disp1 / 2
    assert _recall(i4, truth) >= _recall(i1, truth) - 1e-9
    pf = HybridPagedHNSW(tdir, hot_bytes=(N // 10) * wrow, pivots=4096,
                         prefetch=8, device="cpu")
    d2, i2 = pf.ann_batch(queries, K, EF)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_array_equal(d2, d1)
    assert pf.prefetch_hits > 0 and hy.prefetch_hits == 0
    jpf = j_paged.HybridPagedHNSW(jdir, hot_bytes=(N // 10) * wrow, pivots=4096,
                                  prefetch=8)
    jpf.ann_batch(queries, K, EF)
    assert pf.dispatches == jpf.dispatches
    # without persisted pivots the level rule picks the seeds, as in the
    # JAX package
    nop = HybridPagedHNSW(tdir, hot_bytes=N * wrow, pivots=64, device="cpu")
    nop_j = j_paged.HybridPagedHNSW(jdir, hot_bytes=N * wrow, pivots=64)
    assert nop._pivot_ids.shape == tuple(nop_j._pivot_ids.shape)


def test_caches_hold_under_concurrent_readers(built):
    """The block LRU and the prefetch row cache are shared between the
    query thread and the prefetch thread: under eight threads on a short
    switch interval every read still returns the right rows and both
    caches keep their bounds."""
    import sys
    import threading

    _, _, _, t, _, tdir = built
    n = len(t)
    want = pack_layer(t.graph.get_layer(0)[:n], t.points.codes[:n],
                      t.points.scales[:n]).numpy()
    hy = HybridPagedHNSW(tdir, hot_bytes=1, pivots=64, cache_blocks=3,
                         prefetch=4, device="cpu")
    hy._row_cache_cap = 16
    errors = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(30):
                ids = rng.integers(0, n, 12)
                if seed % 2:
                    hy._prefetch_rows(np.unique(ids))
                else:
                    np.testing.assert_array_equal(hy._cold_rows(ids), want[ids])
        except Exception as exc:  # reported below, from the main thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(s,)) for s in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert len(hy._row_cache) <= 16 and len(hy.store._cache) <= 3
    assert hy.prefetch_hits > 0
    hy.close()
    assert hy.store._fd is None


@pytest.mark.parametrize("pq_m,pq_bits", [(4, 4), (8, 8)], ids=["4bit", "8bit"])
def test_hybrid_pq_tier_recall_matches_jax(built, pq_m, pq_bits):
    vecs, queries, j, t, jdir, tdir = built
    flat = FlatIndex(D, "cpu")
    flat.add(vecs)
    _, truth = flat.search(queries, K, exact=True)
    hy = HybridPagedHNSW(tdir, pivots=4096, pq_m=pq_m, pq_bits=pq_bits,
                         device="cpu")
    jh = j_paged.HybridPagedHNSW(jdir, pivots=4096, pq_m=pq_m, pq_bits=pq_bits)
    cap = t.graph.get_layer(0).shape[1]
    assert hy.device_bytes == jh.device_bytes < N * (D + 12) * cap
    hd, hi = hy.ann_batch(queries, K, EF)
    jd, ji = jh.ann_batch(queries, K, EF)
    assert hy.misses == 0 and hy.hits == 0  # no hot or cold staging ran
    rt, rj = _recall(hi, truth), _recall(ji, truth)
    print(f"PQ tier m={pq_m} bits={pq_bits}: recall port {rt:.4f}, JAX {rj:.4f}")
    assert rt >= 0.9 and abs(rt - rj) <= 0.02
    x = t.points.get_values(hi[0])  # the distances are the reranked, exact ones
    qd = _quantized_queries(queries[:1], "l2")  # queries live in quantized space
    np.testing.assert_allclose(hd[0], np.sqrt(((x - qd) ** 2).sum(-1)),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="pq_bits"):
        HybridPagedHNSW(tdir, pq_m=4, pq_bits=5, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        HybridPagedHNSW(tdir, pq_m=5, pq_bits=8, device="cpu")


def test_paged_cosine_metric(tmp_path):
    """``PagedHNSW`` normalizes queries under the cosine metric: the ids of
    the in-memory cosine index, for queries of any length."""
    store = gen_rand_vecs(400, 12, seed=5) - 0.5
    queries = gen_rand_vecs(12, 12, seed=6) - 0.5
    idx = HNSW(8, dim=12, metric="cosine", device="cpu")
    idx.insert_bulk(store)
    save_paged(idx, str(tmp_path / "cos"))
    pg = PagedHNSW(str(tmp_path / "cos"))
    assert pg.params.metric == "cosine"
    plain = HNSW.from_numpy(*idx.to_numpy(), "cpu")
    _, mi = plain.ann_batch(queries, 5, 40)
    _, pi = pg.ann_batch(queries * 7.0, 5, 40)
    np.testing.assert_array_equal(pi, mi)
    jpg = j_paged.PagedHNSW(str(tmp_path / "cos"))
    np.testing.assert_array_equal(jpg.ann_batch(queries, 5, 40)[1], pi)
