"""The port's small modules against the JAX package on the CPU: random
vectors, id splits and ground-truth fixtures, progress bars, logging and
``torch.profiler`` traces, the ann-benchmarks HDF5 pair, the graph's
per-edge API with its in-degree ledger, the store's point distances, and
the host quantizer.

Ids, codes, adjacency rows and ledgers must be equal; distances are held
to rtol 1e-6 (one f32 rounding apart where XLA fuses a multiply-add).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_rs_tpu import graphs as jgraphs
from hnsw_rs_tpu.errors import IsolatedNode as JIsolatedNode
from hnsw_rs_tpu.ops import distance as jdist
from hnsw_rs_tpu.ops import quant as jquant
from hnsw_rs_tpu.store import PointStore as JPointStore
from hnsw_rs_tpu.utils import data as jdata
from hnsw_rs_tpu.utils import datasets as jdatasets
from hnsw_rs_tpu.utils import rand as jrand
from hnsw_rs_tpu_torch import graphs as tgraphs
from hnsw_rs_tpu_torch.errors import IsolatedNode, MExceeded, SelfConnection
from hnsw_rs_tpu_torch.graphs import LayeredGraph, degrees, empty_adjacency, recount_indeg
from hnsw_rs_tpu_torch.ops import distance as tdist
from hnsw_rs_tpu_torch.ops import quant as tquant
from hnsw_rs_tpu_torch.store import PointStore
from hnsw_rs_tpu_torch.utils import (
    ProgressBar, gen_rand_vecs, get_logger, load_bf_data, profile_trace,
    progress_iter, save_bf_data, split, timed)
from hnsw_rs_tpu_torch.utils import datasets as tdatasets
from hnsw_rs_tpu_torch.utils.logging import TRACE


@pytest.mark.parametrize("seed", [0, 7, None])
def test_gen_rand_vecs_match_jax(seed):
    got = gen_rand_vecs(50, 9, seed=seed)
    assert got.shape == (50, 9) and got.dtype == np.float32
    assert np.all((got >= 0) & (got < 1))
    if seed is not None:
        np.testing.assert_array_equal(got, jrand.gen_rand_vecs(50, 9, seed=seed))


@pytest.mark.parametrize("n,k", [(10, 3), (7, 7), (100, 6), (5, 1)])
def test_split_matches_jax(n, k):
    parts = split(n, k)
    want = jdata.split(n, k)
    assert len(parts) == k
    for a, b in zip(parts, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32
    assert np.concatenate(parts).tolist() == list(range(n))
    assert max(map(len, parts)) - min(map(len, parts)) <= 1


def test_bf_fixtures_read_across_packages(tmp_path):
    nn = np.random.default_rng(0).integers(0, 1000, (13, 10)).astype(np.int32)
    save_bf_data(str(tmp_path / "t" / "bf.json"), nn)
    jdata.save_bf_data(str(tmp_path / "j.json"), nn)
    assert (tmp_path / "t" / "bf.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    np.testing.assert_array_equal(load_bf_data(str(tmp_path / "j.json")), nn)
    np.testing.assert_array_equal(jdata.load_bf_data(str(tmp_path / "t" / "bf.json")), nn)


def test_progress_bar_and_iter(capsys):
    bar = ProgressBar("rows", total=4)
    bar.start -= 1.0  # a second has passed: a finite rate
    bar.inc(2)
    bar.finish()
    err = capsys.readouterr().err
    assert "rows: 2/4 (50.0%)" in err and err.endswith("\n")
    assert list(progress_iter(range(5), desc="it")) == list(range(5))
    assert "it: 5" in capsys.readouterr().err
    quiet = ProgressBar("q", enabled=False)
    quiet.inc()
    quiet.finish()
    assert quiet.count == 1 and capsys.readouterr().err == ""


def test_logger_levels_and_timed(caplog):
    log = get_logger("test")
    assert log.name == "hnsw_rs_tpu.test"
    assert logging.getLevelName(TRACE) == "TRACE"
    with caplog.at_level(logging.INFO, logger="hnsw_rs_tpu"):
        with timed("a step", log, device="cpu"):
            sum(range(1000))
        with timed("default logger"):
            pass
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("a step: ") and m.endswith("s") for m in msgs)
    assert any(m.startswith("default logger: ") for m in msgs)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with profile_trace(str(tmp_path / "tr"), "cpu") as prof:
        (x @ x).sum()
    path = tmp_path / "tr" / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    assert any("mm" in e.name for e in prof.events())


def test_ann_benchmarks_hdf5_across_packages(tmp_path):
    pytest.importorskip("h5py")
    rng = np.random.default_rng(3)
    ds = tdatasets.Dataset("glove-8-angular", rng.random((40, 8), np.float32),
                           rng.random((5, 8), np.float32),
                           rng.integers(0, 40, (5, 3)).astype(np.int32),
                           rng.random((5, 3), np.float32), "cosine")
    tdatasets.write_ann_benchmarks_hdf5(str(tmp_path / "glove-8-angular.hdf5"), ds)
    jds = jdatasets.load_ann_benchmarks_hdf5(str(tmp_path / "glove-8-angular.hdf5"))
    tds = tdatasets.load_ann_benchmarks_hdf5(str(tmp_path / "glove-8-angular.hdf5"))
    for got in (jds, tds):
        assert got.name == "glove-8-angular" and got.metric == "cosine"
        for f in ("train", "test", "neighbors", "distances"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ds, f))
    ds.metric, ds.neighbors, ds.distances = "l2", None, None
    jdatasets.write_ann_benchmarks_hdf5(str(tmp_path / "sift.hdf5"), ds)
    cut = tdatasets.load_ann_benchmarks_hdf5(str(tmp_path / "sift.hdf5"), limit=10)
    assert cut.metric == "l2" and cut.train.shape == (10, 8)
    assert cut.neighbors is None and cut.distances is None


# -- the graph's per-edge API -------------------------------------------------


def _ledger_ok(g, layer=0):
    return torch.equal(g.indeg(layer), recount_indeg(g.adjs[layer]))


def test_isolate_node_protects_last_edge():
    g = LayeredGraph(4, 4, "cpu")
    g.ensure_level(0)
    g.add_edge(0, 0, 1)
    g.add_edge(0, 0, 2)
    g.add_edge(0, 2, 3)
    g.isolate_node(0, 0)  # node 1's only edge is to 0: kept
    assert set(g.neighbors(0, 0)) == {1}
    assert set(g.neighbors(0, 2)) == {3}
    assert _ledger_ok(g)


def test_make_rand_graph():
    g = LayeredGraph.make_rand(30, m=4, n_edges=40, seed=1, device="cpu")
    degs = [g.degree(0, i) for i in range(30)]
    assert sum(degs) == 80  # undirected: every edge counted twice
    assert max(degs) <= g.layer_cap(0)
    assert _ledger_ok(g)


def test_point_store_push():
    ps = PointStore.empty(8, "cpu")
    v = gen_rand_vecs(1, 8, seed=2)[0]
    assert ps.push(v, level=2) == 0 and len(ps) == 1 and ps.levels[0] == 2
    np.testing.assert_allclose(ps.get_values(0), v, atol=0.01)
    assert ps.push(v * 2, level=0) == 1 and len(ps) == 2


def test_add_edge_m_exceeded():
    g = LayeredGraph(1, 4, "cpu")  # layer 0 cap = 2
    g.ensure_level(0)
    g.add_edge(0, 0, 1)
    g.add_edge(0, 0, 2)
    g.add_edge(0, 0, 1)  # re-adding an existing edge is fine
    with pytest.raises(MExceeded):
        g.add_edge(0, 0, 3)
    with pytest.raises(MExceeded):
        g.add_edge(0, 3, 0)
    assert set(g.neighbors(0, 0)) == {1, 2}
    assert _ledger_ok(g)


def test_isolate_node_strict_raises():
    g = LayeredGraph(4, 4, "cpu")
    g.ensure_level(0)
    g.add_edge(0, 0, 1)
    g.add_edge(0, 0, 2)
    g.add_edge(0, 2, 3)
    with pytest.raises(IsolatedNode):
        g.isolate_node(0, 0, strict=True)
    g.isolate_node(0, 0)
    assert set(g.neighbors(0, 0)) == {1}
    assert _ledger_ok(g)


def test_graph_edges_self_loops_replace_and_caps():
    g = LayeredGraph(4, 10, "cpu")
    g.ensure_level(1)
    assert g.layer_cap(0) == 8 and g.layer_cap(1) == 4
    with pytest.raises(SelfConnection):
        g.add_edge(0, 1, 1)
    g.add_edge(0, 1, 2)
    g.add_edge(0, 1, 2)
    g.add_edge(0, 1, 3)
    assert set(g.neighbors(0, 1)) == {2, 3} and g.degree(0, 2) == 1
    g.remove_edge(0, 1, 2)
    assert set(g.neighbors(0, 1)) == {3} and g.degree(0, 2) == 0
    g.replace_neighbors(0, 1, [4, 5, 4, -1, 6])
    assert g.neighbors(0, 1).tolist() == [4, 5, 6]
    assert _ledger_ok(g)
    adj = empty_adjacency(4, 3, "cpu")
    assert adj.dtype == torch.int32 and int(degrees(adj).sum()) == 0
    row = torch.tensor([5, -1, 7, -1], dtype=torch.int32)
    assert tgraphs.row_insert(row, 9).tolist() == [5, 9, 7, -1]
    assert tgraphs.row_insert(row, 7).tolist() == [5, -1, 7, -1]
    assert tgraphs.row_remove(row, 7).tolist() == [5, -1, -1, -1]


def _twin_graphs(seed):
    t = LayeredGraph.make_rand(40, m=3, n_edges=55, seed=seed, device="cpu")
    j = jgraphs.LayeredGraph.make_rand(40, m=3, n_edges=55, seed=seed)
    return t, j


def _same(t, j):
    np.testing.assert_array_equal(t.adjs[0].numpy(), np.asarray(j.adjs[0]))
    np.testing.assert_array_equal(t.indeg(0).numpy(), np.asarray(j.indeg(0)))
    assert _ledger_ok(t)


@pytest.mark.parametrize("seed", [0, 4])
def test_per_edge_ops_match_jax(seed):
    t, j = _twin_graphs(seed)
    _same(t, j)
    rng = np.random.default_rng(seed)
    for _ in range(12):
        a, b = (int(x) for x in rng.integers(0, 40, 2))
        nb = t.neighbors(0, a)
        np.testing.assert_array_equal(nb, j.neighbors(0, a))
        assert t.degree(0, a) == j.degree(0, a)
        if nb.size:
            t.remove_edge(0, a, int(nb[0]))
            j.remove_edge(0, a, int(nb[0]))
        if a != b and t.degree(0, a) < 6 and t.degree(0, b) < 6:
            t.add_edge(0, a, b)
            j.add_edge(0, a, b)
        _same(t, j)
    for node in (3, 17):
        t.isolate_node(0, node)
        j.isolate_node(0, node)
        _same(t, j)
    t.replace_neighbors(0, 9, [1, 2, 2, 30, -1])
    j.replace_neighbors(0, 9, [1, 2, 2, 30, -1])
    _same(t, j)
    busy = next(i for i in range(40) if any(t.degree(0, int(x)) == 1
                                           for x in t.neighbors(0, i)))
    with pytest.raises(IsolatedNode):
        t.isolate_node(0, busy, strict=True)
    with pytest.raises(JIsolatedNode):
        j.isolate_node(0, busy, strict=True)
    _same(t, j)


# -- store distances, l2, l2sq_quant and the host quantizer ---------------------


def test_store_point_distances_match_jax():
    x = gen_rand_vecs(60, 12, seed=5) * 4.0 - 2.0
    t = PointStore.empty(12, "cpu")
    assert t.dim is None and t.ids().size == 0
    t.extend(PointStore.from_vectors(x, 0.4, "cpu"))
    j = JPointStore.from_vectors(x, 0.4)
    assert t.dim == j.dim == 12
    np.testing.assert_array_equal(t.ids(), j.ids())
    v = gen_rand_vecs(3, 12, seed=6)
    for i in (0, 17, 59):
        for q in v:
            np.testing.assert_allclose(t.distance_to_vector(q, i),
                                       j.distance_to_vector(q, i), rtol=1e-6)
        np.testing.assert_allclose(t.distance(i, 3), j.distance(i, 3), rtol=1e-6)


def test_l2_and_l2sq_quant_match_jax():
    rng = np.random.default_rng(8)
    a = rng.normal(0, 2, (7, 1, 20)).astype(np.float32)
    b = rng.normal(0, 2, (1, 9, 20)).astype(np.float32)
    np.testing.assert_allclose(tdist.l2(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jdist.l2(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)
    c, s = jquant.quantize_np(rng.normal(0, 2, (9, 20)).astype(np.float32))
    got = tdist.l2sq_quant(torch.from_numpy(a), torch.from_numpy(c), torch.from_numpy(s))
    want = jdist.l2sq_quant(jnp.asarray(a), jnp.asarray(c), jnp.asarray(s))
    assert got.shape == (7, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("n", [300, 2048])
def test_quantize_np_bit_equal(n):
    """Below 1,024 rows numpy, from 1,024 the native quantizer (where g++
    is on PATH): codes and scales equal to the port's ``quantize`` on the
    CPU and to the JAX ``quantize_np`` either way."""
    rng = np.random.default_rng(n)
    x = rng.normal(0, 3, (n, 51)).astype(np.float32)
    x[7] = 1.25  # delta == 0
    x[100:110] *= 1e-6
    c, s = tquant.quantize_np(x)
    tc, ts = tquant.quantize(torch.from_numpy(x))
    jc, js = jquant.quantize_np(x)
    np.testing.assert_array_equal(c, tc.numpy())
    np.testing.assert_array_equal(s.view(np.uint32), ts.numpy().view(np.uint32))
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(s.view(np.uint32), js.view(np.uint32))
    assert c.dtype == np.uint8 and s.dtype == np.float32
