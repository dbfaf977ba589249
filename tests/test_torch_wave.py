"""The wave builder, incremental inserts and hierarchical-descent serving
of the PyTorch port against the JAX package on the CPU: the same numpy
inputs go through both.

Tolerances: ids, adjacency rows, packed bytes and stores must be equal;
d2 values are held to rtol 1e-6 (both sides compute the same diff-square
sums, in orders that can differ by an ulp). Whole builds are compared by
the share of identical rows (reported, and >= 0.95) and by recall@10
(within 0.01 of JAX's); the port's in-degree ledgers must equal a
recount of its adjacency.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_rs_tpu import HNSW as JHNSW
from hnsw_rs_tpu import build as jbuild
from hnsw_rs_tpu import heuristic as jheur
from hnsw_rs_tpu import search as jsearch
from hnsw_rs_tpu.ops.quant import quantize_np
from hnsw_rs_tpu.store import PointStore as JStore
from hnsw_rs_tpu_torch import HNSW
from hnsw_rs_tpu_torch import build as tbuild
from hnsw_rs_tpu_torch import heuristic as theur
from hnsw_rs_tpu_torch import search as tsearch
from hnsw_rs_tpu_torch.graphs import LayeredGraph, recount_indeg
from hnsw_rs_tpu_torch.store import POISON_MIN, PointStore
from hnsw_rs_tpu_torch.utils.glove import brute_force_nns

K = 10


def J(*a):
    return [jnp.asarray(x) for x in a]


def T(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _state(seed, n=900, live=700, d=20, cap=16):
    """A layer mid-build: rows of the first ``live`` points hold a kNN-ish
    graph among themselves (ragged rows, a few random long edges); the
    rest are fresh, empty and unreferenced. Also dequantized queries."""
    rng = np.random.default_rng(seed)
    cent = rng.random((30, d), np.float32)
    x = (cent[rng.integers(0, 30, n)] + rng.normal(0, 0.05, (n, d))).astype(np.float32)
    codes, scales = quantize_np(x)
    xd = codes.astype(np.float32) * scales[:, 1:2] + scales[:, 0:1]
    d2 = ((xd[:live, None] - xd[None, :live]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    near = np.argsort(d2, axis=1, kind="stable")[:, : cap // 2]
    far = rng.integers(0, live, (live, cap // 2))
    adj = np.full((n, cap), -1, np.int32)
    adj[:live] = np.concatenate([near, far], 1)
    adj[adj == np.arange(n)[:, None]] = -1
    adj[:live][rng.random((live, cap)) < 0.2] = -1
    qc, qs = quantize_np(cent[rng.integers(0, 30, 40)]
                         + rng.normal(0, 0.05, (40, d)).astype(np.float32))
    q = (qc.astype(np.float32) * qs[:, 1:2] + qs[:, 0:1]).astype(np.float32)
    return codes, scales, adj, q


def _wave(live, w=64, pad=4):
    ids = np.full((w + pad,), -1, np.int32)
    ids[:w] = np.arange(live, live + w)
    return ids


# -- store and graph --------------------------------------------------------


def test_store_capacity_growth_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 12)).astype(np.float32)
    codes, scales = quantize_np(x)
    lv = np.arange(50, dtype=np.int32) % 3
    js, ts = JStore.empty(12), PointStore.empty(12, "cpu")
    assert len(ts) == 0 and ts.capacity == 0
    for lo, hi in ((0, 10), (10, 11), (11, 50)):
        jn = js.extend(JStore(*J(codes[lo:hi], scales[lo:hi]), lv[lo:hi]))
        tn = ts.extend(PointStore(*T(codes[lo:hi], scales[lo:hi]), lv[lo:hi]))
        np.testing.assert_array_equal(tn, jn)
        assert len(ts) == len(js) and ts.capacity == js.capacity
    assert ts.capacity == 64  # 10 exact, then powers of two from 64
    np.testing.assert_array_equal(ts.codes.numpy(), np.asarray(js.codes))
    np.testing.assert_array_equal(ts.scales.numpy(), np.asarray(js.scales))
    np.testing.assert_array_equal(ts.levels, js.levels)
    # capacity rows are poisoned: far away, in no layer
    assert np.all(ts.scales[50:].numpy() == np.float32([POISON_MIN, 0.0]))
    assert np.all(ts.levels[50:] == -1)
    v = rng.standard_normal(12).astype(np.float32)
    assert ts.push(v, 2) == js.push(v, 2) == 50
    np.testing.assert_array_equal(ts.codes.numpy(), np.asarray(js.codes))
    np.testing.assert_array_equal(ts.get_values(7), js.get_values(7))
    np.testing.assert_allclose(ts.distance(3, 40), js.distance(3, 40), rtol=1e-6)


def test_ensure_nodes_keeps_rows_and_ledgers():
    g = LayeredGraph(4, 5, "cpu")
    g.ensure_level(1)
    adj = torch.tensor([[1, 2, -1, -1, -1, -1, -1, -1]] * 5, dtype=torch.int32)
    g.set_layer(0, adj, recount_indeg(adj))
    g.ensure_nodes(9)
    assert g.n == 9 and g.get_layer(0).shape == (9, 8)
    assert g.get_layer(1).shape == (9, 4)
    assert torch.equal(g.get_layer(0)[:5], adj)
    assert bool((g.get_layer(0)[5:] == -1).all())
    assert torch.equal(g.indeg(0), recount_indeg(g.get_layer(0)))
    levels = np.array([1, 0, 0, 1, 0, 0, 0, 0, 0], np.int32)
    np.testing.assert_array_equal(g.layer_degrees(0, levels), [2] * 5 + [0] * 4)
    assert g.nb_nodes(1, levels) == 2


# -- search -----------------------------------------------------------------


@pytest.mark.parametrize("forbid", [False, True])
def test_greedy_descent_matches_jax(forbid):
    codes, scales, adj, q = _state(1, live=900)
    rng = np.random.default_rng(2)
    start = rng.integers(0, 900, q.shape[0]).astype(np.int32)
    x = codes[start].astype(np.float32) * scales[start, 1:2] + scales[start, 0:1]
    d2 = ((x - q) ** 2).sum(1).astype(np.float32)
    fb = rng.integers(0, 900, q.shape[0]).astype(np.int32) if forbid else None
    jd, ji = jsearch.greedy_descent(*J(adj, codes, scales, q, d2, start),
                                    forbid=None if fb is None else jnp.asarray(fb))
    td, ti = tsearch.greedy_descent(*T(adj, codes, scales, q, d2, start),
                                    forbid=None if fb is None else torch.from_numpy(fb))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    assert np.all(td.numpy() <= d2)  # a hill climb never gets worse
    if fb is not None:
        assert not np.any((ti.numpy() == fb) & (ti.numpy() != start))


@pytest.mark.parametrize("ef", [12, 40])
def test_ann_search_matches_jax(ef):
    codes, scales, adj0, q = _state(3, live=900)
    rng = np.random.default_rng(4)
    upper = np.flatnonzero(rng.random(900) < 0.15)
    adj1 = np.full((900, 8), -1, np.int32)
    for i in upper:
        adj1[i] = rng.choice(upper[upper != i], 8, replace=False)
    ep = int(upper[0])
    jd, ji = jsearch.ann_search(tuple(J(adj0, adj1)), *J(codes, scales, q), ep,
                                ef, K, 2 * ef + 16)
    td, ti = tsearch.ann_search(T(adj0, adj1), *T(codes, scales, q), ep, ef, K,
                                2 * ef + 16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    tp = tsearch.pack_layer(*T(adj0, codes, scales))
    pd, pi = tsearch.ann_search_packed(T(adj1), tp, *T(codes, scales, q), ep, ef,
                                       K, 2 * ef + 16)
    jp = jsearch.pack_layer(*J(adj0, codes, scales))
    jpd, jpi = jsearch.ann_search_packed(tuple(J(adj1)), jp, *J(codes, scales, q),
                                         ep, ef, K, 2 * ef + 16)
    np.testing.assert_array_equal(pi.numpy(), ti.numpy())
    np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))
    sd, si = tsearch.seed_entry(*T(codes, scales, q), ep)
    jsd, jsi = jsearch.seed_entry(*J(codes, scales, q), jnp.int32(ep))
    np.testing.assert_array_equal(si.numpy(), np.asarray(jsi))
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), rtol=1e-6)


# -- heuristic --------------------------------------------------------------


def _beam(seed, ef=24):
    codes, scales, adj, q = _state(seed, live=900)
    e = np.zeros((q.shape[0], 1), np.int32)
    x = codes[0].astype(np.float32) * scales[0, 1] + scales[0, 0]
    ed2 = ((q - x) ** 2).sum(1, keepdims=True).astype(np.float32)
    bd, bi = jsearch.search_layer(*J(adj, codes, scales, q, ed2, e), ef, 2 * ef + 16)
    return codes, scales, adj, q, np.array(bd), np.array(bi)


@pytest.mark.parametrize("extend,forbid", [(True, True), (True, False), (False, True)])
def test_candidate_pools_match_jax(extend, forbid):
    codes, scales, adj, q, bd, bi = _beam(5)
    fb = bi[:, 3].copy() if forbid else None
    jf = None if fb is None else jnp.asarray(fb)
    tf = None if fb is None else torch.from_numpy(fb)
    jd, ji = jheur.build_candidate_pool(*J(adj, codes, scales, q, bd, bi), extend, jf)
    td, ti = theur.build_candidate_pool(*T(adj, codes, scales, q, bd, bi), extend, tf)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    tp = tsearch.pack_layer(*T(adj, codes, scales))
    pd, pi = theur.build_candidate_pool_packed(tp, *T(q, bd, bi), extend, tf)
    jp = jsearch.pack_layer(*J(adj, codes, scales))
    jpd, jpi = jheur.build_candidate_pool_packed(jp, *J(q, bd, bi), extend, jf)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))
    np.testing.assert_array_equal(pi.numpy(), ti.numpy())
    np.testing.assert_array_equal(pd.numpy(), td.numpy())  # same sums


@pytest.mark.parametrize("m,keep", [(8, True), (5, False)])
def test_select_heuristic_matches_jax(m, keep):
    codes, scales, adj, q, bd, bi = _beam(6)
    fb = bi[:, 0].copy()
    jd, ji = jheur.select_heuristic(*J(adj, codes, scales, q, bd, bi), m,
                                    keep_pruned=keep, forbid=jnp.asarray(fb))
    td, ti = theur.select_heuristic(*T(adj, codes, scales, q, bd, bi), m,
                                    keep_pruned=keep, forbid=torch.from_numpy(fb))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    tp = tsearch.pack_layer(*T(adj, codes, scales))
    pd, pi = theur.select_heuristic_packed(tp, *T(codes, scales, q, bd, bi), m,
                                           keep_pruned=keep,
                                           forbid=torch.from_numpy(fb))
    np.testing.assert_array_equal(pi.numpy(), ti.numpy())


# -- one wave ---------------------------------------------------------------


def _selections(codes, scales, adj, ids_w, ef=32, m=8):
    """Realistic wave selections from the JAX package's layer step."""
    safe = np.clip(ids_w, 0, codes.shape[0] - 1)
    q = codes[safe].astype(np.float32) * scales[safe, 1:2] + scales[safe, 0:1]
    x0 = codes[0].astype(np.float32) * scales[0, 1] + scales[0, 0]
    e_d2 = ((q - x0) ** 2).sum(1, keepdims=True).astype(np.float32)
    e_ids = np.zeros_like(e_d2, np.int32)
    return e_d2, e_ids, [np.array(a) for a in jbuild._wave_layer_step(
        *J(adj, codes, scales, ids_w, e_d2, e_ids), ef=ef, m=m,
        max_iters=2 * ef + 16)]


def test_wave_layer_step_matches_jax():
    """The whole layer step (beam, pool, accept chain) on a wave of fresh
    nodes. Its stages match JAX exactly on the same inputs (the tests
    above); chained, an ulp of difference in the beam's sums can flip a
    near-tie of the accept test, which compares a diff-square distance
    with a product-form one, so rows are held to a >= 0.95 share. The
    packed variant equals the port's plain one bit for bit."""
    codes, scales, adj, _ = _state(7)
    ids_w = _wave(700, pad=0)
    e_d2, e_ids, (jd, ji) = _selections(codes, scales, adj, ids_w)
    args = T(adj, codes, scales, ids_w, e_d2, e_ids)
    td, ti = tbuild._wave_layer_step_impl(*args, ef=32, m=8, max_iters=80)
    same = (ti.numpy() == ji).all(1)
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_allclose(td.numpy()[same], jd[same], rtol=1e-6)
    assert not np.any(ti.numpy() == ids_w[:, None])  # never selects itself
    tp = tsearch.pack_layer(*T(adj, codes, scales))
    pd, pi = tbuild._wave_layer_step_impl(*args, ef=32, m=8, max_iters=80, packed=tp)
    assert torch.equal(pi, ti) and torch.equal(pd, td)


@pytest.mark.parametrize("set_own,dedup", [(True, False), (True, True), (False, False)])
def test_apply_wave_matches_jax(set_own, dedup):
    codes, scales, adj, _ = _state(8)
    ids_w = _wave(700)
    _, _, (sd, si) = _selections(codes, scales, adj, ids_w)
    indeg = np.bincount(adj[adj >= 0], minlength=adj.shape[0]).astype(np.int32)
    jadj, jin = jbuild._apply_wave_impl(*J(adj, indeg, codes, scales, ids_w, sd, si),
                                        set_own=set_own, dedup=dedup)
    tadj, tin = tbuild._apply_wave_impl(*T(adj, indeg, codes, scales, ids_w, sd, si),
                                        set_own=set_own, dedup=dedup)
    np.testing.assert_array_equal(tadj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(tin.numpy(), recount_indeg(tadj).numpy())
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    if set_own:
        assert np.all((tadj.numpy()[ids_w[ids_w >= 0]] >= 0).sum(1) > 0)


def test_apply_wave_repacks_exactly_the_rewritten_rows():
    codes, scales, adj, _ = _state(9)
    ids_w = _wave(700)
    _, _, (sd, si) = _selections(codes, scales, adj, ids_w)
    indeg = np.bincount(adj[adj >= 0], minlength=adj.shape[0]).astype(np.int32)
    jp = jsearch.pack_layer(*J(adj, codes, scales))
    jadj, _, jpk, jstale = jbuild._apply_wave_impl(
        *J(adj, indeg, codes, scales, ids_w, sd, si), packed=jp,
        comb=jsearch.comb_table(*J(codes, scales)))
    tp = tsearch.pack_layer(*T(adj, codes, scales))
    comb = tsearch.comb_table(*T(codes, scales))
    np.testing.assert_array_equal(comb.numpy(),
                                  np.asarray(jsearch.comb_table(*J(codes, scales))))
    tadj, _, tpk, tstale = tbuild._apply_wave_impl(
        *T(adj, indeg, codes, scales, ids_w, sd, si), packed=tp, comb=comb)
    np.testing.assert_array_equal(tadj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    assert torch.equal(tpk, tsearch.pack_layer(tadj, *T(codes, scales)))
    assert not bool(tstale) and not bool(jstale)
    e = tsearch.empty_packed(5, 16, 20, "cpu")
    np.testing.assert_array_equal(e.numpy(), np.asarray(jsearch.empty_packed(5, 16, 20)))


# -- whole builds -----------------------------------------------------------


N, D, M, EF_CONS = 600, 16, 8, 32


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(123)
    v = rng.standard_normal((N, D)).astype(np.float32)
    qs = rng.standard_normal((64, D)).astype(np.float32)
    extra = rng.standard_normal((24, D)).astype(np.float32)
    j = JHNSW(M, ef_cons=EF_CONS, dim=D)
    j.insert_bulk(v)
    t = HNSW(M, ef_cons=EF_CONS, dim=D, device="cpu")
    t.insert_bulk(v)
    return v, qs, extra, j, t


def _recall(ids, truth):
    return float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, truth)]))


def _same_rows(jgraph, tgraph, levels):
    shares = []
    for lam in range(len(jgraph)):
        mem = levels >= lam
        ja = np.asarray(jgraph.adjs[lam])[: len(levels)][mem]
        ta = tgraph.adjs[lam].numpy()[: len(levels)][mem]
        shares.append(float((ja == ta).all(1).mean()))
    return shares


def test_wave_build_matches_jax(built):
    v, qs, _, j, t = built
    np.testing.assert_array_equal(t.points.codes.numpy(), np.asarray(j.points.codes))
    np.testing.assert_array_equal(t.points.levels, j.points.levels)
    assert t.ep == j.ep and len(t.graph) == len(j.graph)
    shares = _same_rows(j.graph, t.graph, j.points.levels)
    print(f"share of identical rows per layer: {shares}")
    assert min(shares) >= 0.95, shares
    assert t.serving_route() == "packed"
    truth = brute_force_nns(qs, t.points.codes, t.points.scales, K)
    rt = _recall(t.ann_batch(qs, K, 48)[1], truth)
    rj = _recall(j.ann_batch(qs, K, 48)[1], truth)
    assert abs(rt - rj) <= 0.01 and rt >= 0.95, (rt, rj)
    assert t.assert_param_compliance(verbose=False)
    for lam in range(len(t.graph)):
        assert torch.equal(t.graph.indeg(lam), recount_indeg(t.graph.adjs[lam]))


def test_port_wave_index_serves_the_same_in_jax(built, tmp_path):
    """A port-built index loaded by the JAX package returns the same ids
    through JAX's ann_batch as through the port's, before and after
    insert_vec; both packages insert the same vectors the same way."""
    v, qs, extra, _, _ = built
    t = HNSW(M, ef_cons=EF_CONS, dim=D, device="cpu")
    t.insert_bulk(v)
    t.save(str(tmp_path / "a"))
    j = JHNSW.load(str(tmp_path / "a"))
    assert t.serving_route() == "packed"
    np.testing.assert_array_equal(t.ann_batch(qs, K, 40)[1], j.ann_batch(qs, K, 40)[1])
    ids = [t.insert_vec(x) for x in extra]
    jids = [j.insert_vec(x) for x in extra]
    assert ids == jids == list(range(N, N + len(extra)))
    assert t.serving_route() == "plain"  # the packed rows went stale
    j.flush()
    assert t.points.capacity == j.points.capacity == 1024
    shares = _same_rows(j.graph, t.graph, j.points.levels[: len(j)])
    assert min(shares) >= 0.95, shares
    td, ti = t.ann_batch(qs, K, 40)
    jd, ji = j.ann_batch(qs, K, 40)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    t.save(str(tmp_path / "b"))
    jb = JHNSW.load(str(tmp_path / "b"))
    np.testing.assert_array_equal(jb.ann_batch(qs, K, 40)[1], ti)
    assert t.ann_batch(extra, 1, 40)[1][:, 0].tolist() == ids
    assert t.assert_param_compliance(verbose=False)


def test_hnsw_introspection_matches_jax(built, capsys):
    v, qs, _, j, t = built
    p = t.get_point(17)
    jp = j.get_point(17)
    assert (p.id, p.level) == (jp.id, jp.level)
    np.testing.assert_array_equal(p.values, jp.values)
    assert t.get_point(N) is None and t.get_point(-1) is None
    np.testing.assert_allclose(t.distance(3, 99), j.distance(3, 99), rtol=1e-6)
    for lam in range(len(t.graph)):
        np.testing.assert_array_equal(t.layer_degrees(lam), j.layer_degrees(lam))
    j.print_index()
    want = capsys.readouterr().out
    t.print_index()
    assert capsys.readouterr().out == want
    assert t.ann_by_vector(v[5], K, 32)[0] == 5


def test_packed_build_is_bit_identical_to_plain(built):
    v = built[0]
    a = HNSW(M, ef_cons=EF_CONS, dim=D, device="cpu")
    a.insert_bulk(v)
    assert a._packed0 is not None and a._packed_n == len(a)
    b = HNSW(M, ef_cons=EF_CONS, dim=D, device="cpu")
    b.insert_bulk(v, packed_build=False)
    assert b._packed0 is None and b.serving_route() == "plain"
    assert all(torch.equal(x, y) for x, y in zip(a.graph.adjs, b.graph.adjs))
    assert torch.equal(a._packed0, tsearch.pack_layer(b.graph.get_layer(0),
                                                      b.points.codes, b.points.scales))
    # deferred repack: rows may serve stale during the build, fresh at its end
    c = HNSW(M, ef_cons=EF_CONS, dim=D, device="cpu")
    c.insert_bulk(v, pack_lag=4)
    assert torch.equal(c._packed0, tsearch.pack_layer(c.graph.get_layer(0),
                                                      c.points.codes, c.points.scales))
    assert c.assert_param_compliance(verbose=False)


def test_unpadded_waves_equal_padded(built):
    """The JAX package pads each wave to a bucket size (16, 64, 256, ...)
    with -1 lanes; the port runs waves unpadded. A build whose waves are
    padded as JAX pads them yields the same graph and packed rows."""
    v = built[0]
    ref = HNSW(M, ef_cons=EF_CONS, dim=D, device="cpu")
    ref.insert_bulk(v)
    store = ref.points
    params = ref.params
    graph = LayeredGraph(M, N, "cpu")
    top = int(store.levels.max())
    graph.ensure_level(top)
    ep = int(np.flatnonzero(store.levels == top)[0])
    packed = tsearch.empty_packed(N, 2 * M, D, "cpu")
    comb = tsearch.comb_table(store.codes, store.scales)
    for lam in range(top, -1, -1):
        home = np.flatnonzero(store.levels == lam).astype(np.int32)
        off = 0
        for w in tbuild.wave_schedule(home.size):
            ids = np.full((jbuild._bucket(w),), -1, np.int32)
            ids[:w] = home[off:off + w]
            off += w
            adjs, indegs, packed, _ = tbuild._insert_wave_fused_impl(
                graph.adjs, [graph.indeg(i) for i in range(len(graph))],
                store.codes, store.scales, torch.from_numpy(ids), ep,
                ef=EF_CONS, m=M, max_iters=2 * EF_CONS + 16, layer_nb=lam,
                packed0=packed, comb=comb)
            for i in range(len(graph)):
                graph.set_layer(i, adjs[i], indegs[i])
    assert all(torch.equal(x, y) for x, y in zip(graph.adjs, ref.graph.adjs))
    assert torch.equal(packed, ref._packed0)


def test_insert_bulk_on_a_built_index_equals_insert_vec(built):
    """Extending a built index with insert_bulk wave-inserts the points as
    one batch of buffered insert_vec calls does (one level draw each),
    and drops the bulk-only build options."""
    v, _, extra, _, _ = built
    a = HNSW(M, ef_cons=EF_CONS, dim=D, device="cpu")
    a.insert_bulk(v[:400])
    a.insert_bulk(extra, cluster_build=True, packed_build=False, pack_lag=3)
    b = HNSW(M, ef_cons=EF_CONS, dim=D, device="cpu")
    b.insert_bulk(v[:400])
    for x in extra:
        b.insert_vec(x)
    assert len(b) == len(a) == 400 + len(extra)
    b.flush()
    np.testing.assert_array_equal(a.points.levels, b.points.levels)
    assert a.ep == b.ep and len(a.graph) == len(b.graph)
    assert all(torch.equal(x, y) for x, y in zip(a.graph.adjs, b.graph.adjs))


# -- the wave build's options -------------------------------------------------


def test_wave_projection_matches_jax(built):
    """``wave_sort``'s key: the projection equals the JAX package's
    formula within float32 rounding, and the stable order of a layer's
    home nodes is the same wherever adjacent projections differ by more
    than 1e-5."""
    v, _, _, j, t = built
    r = np.random.default_rng(7).standard_normal(D).astype(np.float32)
    codes, scales = np.asarray(j.points.codes)[:N], np.asarray(j.points.scales)[:N]
    want = np.asarray(
        jnp.asarray(scales[:, 0]) * float(r.sum()) + jnp.asarray(scales[:, 1])
        * jnp.einsum("nd,d->n", jnp.asarray(codes).astype(jnp.float32), jnp.asarray(r)))
    got = tbuild.wave_projection(t.points.codes[:N], t.points.scales[:N])
    assert got.dtype == np.float32 and got.shape == (N,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    home = np.flatnonzero(j.points.levels == 0)
    oj = home[np.argsort(want[home], kind="stable")]
    ot = home[np.argsort(got[home], kind="stable")]
    clear = np.abs(np.diff(want[oj])) > 1e-5
    settled = np.concatenate([[True], clear]) & np.concatenate([clear, [True]])
    np.testing.assert_array_equal(ot[settled], oj[settled])


@pytest.mark.parametrize("option", [{"wave_sort": True}, {"build_seeded": True},
                                    {"build_expand": 2},
                                    {"build_seeded": True, "build_pivot_cap": 16,
                                     "build_expand": 2, "wave_sort": True}],
                         ids=["wave_sort", "build_seeded", "build_expand",
                              "all_three"])
def test_wave_build_options_match_jax(built, option):
    """One build each with ``wave_sort``, ``build_seeded``,
    ``build_expand=2`` (and all three with a capped pivot set): recall@10
    within 0.02 of the JAX package's build with the same option, the
    degree rules hold, the ledgers equal a recount."""
    v, qs, _, _, base = built
    j = JHNSW(M, ef_cons=EF_CONS, dim=D)
    j.insert_bulk(v, **option)
    t = HNSW(M, ef_cons=EF_CONS, dim=D, device="cpu")
    t.insert_bulk(v, **option)
    assert t.ep == j.ep and len(t.graph) == len(j.graph)
    shares = _same_rows(j.graph, t.graph, j.points.levels)
    print(f"{option}: share of identical rows per layer: {shares}")
    truth = brute_force_nns(qs, t.points.codes, t.points.scales, K)
    rt = _recall(t.ann_batch(qs, K, 48)[1], truth)
    rj = _recall(j.ann_batch(qs, K, 48)[1], truth)
    assert abs(rt - rj) <= 0.02 and rt >= 0.95, (rt, rj)
    assert t.assert_param_compliance(verbose=False)
    for lam in range(len(t.graph)):
        assert torch.equal(t.graph.indeg(lam), recount_indeg(t.graph.adjs[lam]))
    # the option changed the build (a different insertion order or other
    # seeds; E=2 alone converges to the E=1 beams at this size), and the
    # packed table still mirrors the graph
    if set(option) != {"build_expand"}:
        assert not torch.equal(t.graph.get_layer(0), base.graph.get_layer(0))
    assert torch.equal(t._packed0, tsearch.pack_layer(
        t.graph.get_layer(0), t.points.codes, t.points.scales))


def test_seeded_wave_takes_pivot_seeds_only_at_layer_0():
    """``_insert_wave_fused_impl`` with pivots: a layer-0 wave equals the
    JAX package's seeded wave; a wave homed above layer 0 ignores them."""
    codes, scales, adj, _ = _state(11)
    ids_w = _wave(700, pad=0)
    indeg = np.bincount(adj[adj >= 0], minlength=adj.shape[0]).astype(np.int32)
    piv = np.arange(0, 700, 9, dtype=np.int32)
    pv = codes[piv].astype(np.float32) * scales[piv, 1:2] + scales[piv, 0:1]
    kw = dict(ef=24, m=8, max_iters=64, layer_nb=0)
    (jadj,), _ = jbuild._insert_wave_fused_impl(
        (jnp.asarray(adj),), (jnp.asarray(indeg),), *J(codes, scales, ids_w),
        jnp.int32(0), pivot_ids=jnp.asarray(piv), pivot_vecs=jnp.asarray(pv), **kw)
    (tadj,), _ = tbuild._insert_wave_fused_impl(
        T(adj), T(indeg), *T(codes, scales, ids_w), 0,
        pivot_ids=torch.from_numpy(piv), pivot_vecs=torch.from_numpy(pv), **kw)
    same = (tadj.numpy() == np.asarray(jadj)).all(1)
    assert same.mean() >= 0.95, same.mean()
    (plain,), _ = tbuild._insert_wave_fused_impl(
        T(adj), T(indeg), *T(codes, scales, ids_w), 0, **kw)
    assert not torch.equal(plain, tadj)
