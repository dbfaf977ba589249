"""Parity of the port's cluster-bulk builder (``hnsw_rs_tpu_torch``
``build_cluster``, ``heuristic``, ``build``, ``ops.cover``) with the JAX
package on the CPU, sub-step by sub-step on identical inputs, plus the
row invariants of a port-built graph.

Tolerances: selections, adjacency rows, assignments and pivot picks must
be equal (ids); centroids and distances are held to rtol 1e-5 (sums in
another order). The full build is recall-gated in test_torch_hnsw.py,
as the JAX package gates its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_rs_tpu import build_cluster as jbc
from hnsw_rs_tpu.build import repair_connectivity as j_repair
from hnsw_rs_tpu.graphs import LayeredGraph as JGraph
from hnsw_rs_tpu.heuristic import _accept_from_pool as j_accept
from hnsw_rs_tpu.ops.cover import kcenter_fill as j_kcenter_fill
from hnsw_rs_tpu.ops.quant import quantize_np
from hnsw_rs_tpu.ops.topk import PAD_ID
from hnsw_rs_tpu.store import PointStore as JStore
from hnsw_rs_tpu.store import sample_levels as j_sample_levels
from hnsw_rs_tpu.utils.datasets import synthetic_clustered as j_synthetic
from hnsw_rs_tpu_torch import HNSW
from hnsw_rs_tpu_torch import build_cluster as tbc
from hnsw_rs_tpu_torch.build import build_index
from hnsw_rs_tpu_torch.build import repair_connectivity as t_repair
from hnsw_rs_tpu_torch.graphs import LayeredGraph as TGraph
from hnsw_rs_tpu_torch.graphs import recount_indeg
from hnsw_rs_tpu_torch.heuristic import _accept_from_pool as t_accept
from hnsw_rs_tpu_torch.ops.cover import kcenter_fill as t_kcenter_fill
from hnsw_rs_tpu_torch.params import Params
from hnsw_rs_tpu_torch.store import PointStore, sample_levels
from hnsw_rs_tpu_torch.utils.datasets import synthetic_clustered


def _data(seed, n=1500, d=16, k=25):
    rng = np.random.default_rng(seed)
    cent = rng.random((k, d), np.float32)
    x = (cent[rng.integers(0, k, n)] + rng.normal(0, 0.05, (n, d))).astype(np.float32)
    codes, scales = quantize_np(x)
    return codes, scales


def J(*a):
    return [jnp.asarray(x) for x in a]


def T(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def test_host_copies_and_seeded_draws_match():
    np.testing.assert_array_equal(sample_levels(5000, 1 / np.log(12), seed=3),
                                  j_sample_levels(5000, 1 / np.log(12), seed=3))
    a, b = synthetic_clustered(3000, 24, 50, seed=4), j_synthetic(3000, 24, 50, seed=4)
    np.testing.assert_array_equal(a.train, b.train)
    np.testing.assert_array_equal(a.test, b.test)
    assign = np.random.default_rng(0).integers(0, 9, 700).astype(np.int32)
    keys = np.random.default_rng(1).random(700).astype(np.float32)
    ta, tk = tbc._split_oversized(assign, 9, 40, keys)
    ja, jk = jbc._split_oversized(assign, 9, 40, keys)
    np.testing.assert_array_equal(ta, ja)
    assert tk == jk
    for t, j in zip(tbc._member_tables(ta, tk, 40), jbc._member_tables(ja, jk, 40)):
        np.testing.assert_array_equal(t, j)


def test_kmeans_assignment_given_centroids_is_equal():
    codes, scales = _data(0)
    cent = np.random.default_rng(2).random((37, 16)).astype(np.float32)
    ja = jbc._assign_only(*J(codes, scales, cent), chunk=256)
    ta = tbc._assign_only(*T(codes, scales, cent), chunk=256)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    jc, jl = jbc._lloyd_iter(*J(codes, scales, cent), chunk=512)
    tc, tl = tbc._lloyd_iter(*T(codes, scales, cent), chunk=512)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    # the whole k-means: the same strided subsample and init picks
    jcent, jassign = jbc.kmeans(*J(codes, scales), 20, iters=3)
    tcent, tassign = tbc.kmeans(*T(codes, scales), 20, iters=3)
    np.testing.assert_allclose(tcent.numpy(), np.asarray(jcent), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tassign.numpy(), np.asarray(jassign))


def _tables(codes, scales, k=20, smax=128, fan=4):
    _, assign = jbc.kmeans(*J(codes, scales), k, iters=2)
    assign_np, k2 = jbc._split_oversized(np.asarray(assign), k, smax)
    table, _ = jbc._member_tables(assign_np, k2, smax)
    return table, k2, fan


def test_table_centroids_and_fanout_match():
    codes, scales = _data(1)
    table, k2, fan = _tables(codes, scales)
    rch = 8
    kpad = -(-k2 // rch) * rch
    tpad = np.full((kpad, table.shape[1]), -1, np.int32)
    tpad[:k2] = table
    jc, jr = jbc._table_centroids(*J(codes, scales, tpad), rchunk=rch)
    tc, tr = tbc._table_centroids(*T(codes, scales, table), rch)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc)[:k2], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr)[:k2])
    np.testing.assert_array_equal(tbc._nbr_clusters(tc, fan).numpy(),
                                  np.asarray(jbc._nbr_clusters(jnp.asarray(tc.numpy()), fan)))


@pytest.mark.parametrize("alg4", [False, True])
def test_cluster_sel_step_matches(alg4):
    codes, scales = _data(2)
    table, k2, fan = _tables(codes, scales)
    cent, _ = jbc._table_centroids(*J(codes, scales, table), rchunk=k2)
    nbrcl = np.asarray(jbc._nbr_clusters(cent, fan))
    cl = np.full((8,), -1, np.int32)
    cl[:6] = np.arange(3, 9)
    want = jbc._cluster_sel_step(*J(codes, scales, table, nbrcl, cl), m=8,
                                 pool_p=40, select_alg4=alg4)
    got = tbc._cluster_sel_step_impl(*T(codes, scales, table, nbrcl, cl), m=8,
                                     pool_p=40, select_alg4=alg4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # pool distances take the expanded form |q|^2 + |c|^2 - 2 q.c, whose
    # error is ~1e-6 absolute here (terms of ~8): selections may swap
    # near-ties closer than that, so ids agree on >= 99% of the lanes and
    # the sorted distances to 1e-5 absolute
    assert np.mean(got[2].numpy() == np.asarray(want[2])) >= 0.99
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)


def test_exact_sel_step_matches_numpy_oracle():
    """The small-layer path without the accept chain: exactly the m
    nearest other members in quantized space, (d2, id) ordered, PAD
    padded, including pad query lanes and member pads."""
    rng = np.random.default_rng(7)
    n, d, m = 61, 8, 5
    codes, scales = quantize_np(rng.standard_normal((n, d)).astype(np.float32))
    deq = codes.astype(np.float64) * scales[:, 1:2] + scales[:, 0:1]
    mem = np.arange(0, n, 2, dtype=np.int32)
    mem_pad = np.full((64,), -1, np.int32)
    mem_pad[: mem.size] = mem
    qids = np.full((mem.size + 2,), -1, np.int32)
    qids[: mem.size] = mem
    qflat, sel_d2, sel_ids = tbc._exact_sel_step_impl(
        *T(codes, scales, qids, mem_pad), m=m, pool_p=16, select_alg4=False)
    assert np.array_equal(qflat.numpy(), qids)
    for i, q in enumerate(qids):
        if q < 0:
            assert np.all(sel_ids[i].numpy() == PAD_ID)
            continue
        others = mem[mem != q]
        d2 = np.sum((deq[others] - deq[q]) ** 2, axis=1)
        order = np.lexsort((others, d2))[:m]
        np.testing.assert_array_equal(sel_ids[i].numpy(), others[order])
        np.testing.assert_allclose(sel_d2[i].numpy(), d2[order], rtol=1e-5)
    want = jbc._exact_sel_step(*J(codes, scales, qids, mem_pad), m=m, pool_p=16,
                               select_alg4=True)
    got = tbc._exact_sel_step_impl(*T(codes, scales, qids, mem_pad), m=m,
                                   pool_p=16, select_alg4=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("m,c,keep", [(8, 40, True), (12, 300, True), (6, 50, False)])
def test_accept_from_pool_matches(m, c, keep):
    codes, scales = _data(3)
    rng = np.random.default_rng(m + c)
    b = 33
    q = (codes[:b].astype(np.float32) * scales[:b, 1:2] + scales[:b, 0:1]).astype(np.float32)
    ids = np.stack([rng.choice(np.arange(b, codes.shape[0]), c, replace=False)
                    for _ in range(b)]).astype(np.int32)
    x = codes[ids].astype(np.float32) * scales[ids][..., 1:2] + scales[ids][..., 0:1]
    d2 = ((x - q[:, None]) ** 2).sum(-1).astype(np.float32)
    ids[rng.random(ids.shape) < 0.1] = PAD_ID  # ragged pools
    d2 = np.where(ids == PAD_ID, np.inf, d2).astype(np.float32)
    order = np.lexsort((ids, d2), axis=1)
    d2, ids = np.take_along_axis(d2, order, 1), np.take_along_axis(ids, order, 1)
    jd, ji = j_accept(*J(codes, scales, q, d2, ids), m, keep)
    td, ti = t_accept(*T(codes, scales, q, d2, ids), m, keep)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("heuristic,slots", [(True, 0), (False, 0), (True, 5),
                                             (True, 7)])
def test_sel_pos_and_global_merge_match(heuristic, slots):
    codes, scales = _data(4, n=900)
    n, m, cap = codes.shape[0], 6, 12
    slots = slots or 2 * cap
    qids = np.full((1024,), -1, np.int32)
    qids[:n] = np.random.default_rng(5).permutation(n)
    mem_all = np.arange(1024, dtype=np.int32)
    mem_all[n:] = -1
    qflat, sel_d2, sel_ids = (np.array(a) for a in jbc._exact_sel_step(
        *J(codes, scales, qids, mem_all), m=m, pool_p=24, select_alg4=False))
    jpos = jbc._sel_pos(jnp.asarray(qflat), n=n)
    tpos = tbc._sel_pos(torch.from_numpy(qflat), n)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    adj0 = np.full((n, cap), -1, np.int32)
    jadj = jbc._global_merge(jnp.asarray(adj0), jpos, *J(qflat, sel_d2, sel_ids,
                             codes, scales), slots=slots, rchunk=256,
                             heuristic=heuristic)
    tadj = tbc._global_merge(torch.from_numpy(adj0.copy()), tpos,
                             *T(qflat, sel_d2, sel_ids, codes, scales),
                             slots=slots, rchunk=256, heuristic=heuristic)
    np.testing.assert_array_equal(tadj.numpy(), np.asarray(jadj))
    if m + slots < cap:
        return  # a union narrower than a row: the JAX subset variant refuses it
    # the member-subset variant rewrites only its rows, the same way
    rows = np.arange(0, n, 3, dtype=np.int32)
    rows_pad = np.full((-(-rows.size // 128) * 128,), -1, np.int32)
    rows_pad[: rows.size] = rows
    jsub = jbc._global_merge_rows(jnp.asarray(adj0), jpos, *J(
        qflat, sel_d2, sel_ids, rows_pad, codes, scales), slots=slots,
        rchunk=128, heuristic=heuristic)
    tsub = tbc._global_merge_rows(torch.from_numpy(adj0.copy()), tpos, *T(
        qflat, sel_d2, sel_ids, rows, codes, scales), slots=slots, rchunk=128,
        heuristic=heuristic)
    np.testing.assert_array_equal(tsub.numpy(), np.asarray(jsub))


@pytest.mark.parametrize("round_", [0, 1, 4])
def test_orphan_repair_matches(round_):
    rng = np.random.default_rng(6)
    n, cap = 400, 6
    # rows are sets, and the in-edges pile onto ids 0..39: most nodes are
    # orphans and many collide on one target
    adj = np.stack([rng.choice(40, cap, replace=False) for _ in range(n)])
    adj = adj.astype(np.int32)
    adj[rng.random((n, cap)) < 0.3] = -1
    adj[:5] = -1  # empty rows are not orphans
    jadj, jin = jnp.asarray(adj), jbc._recount_indeg(jnp.asarray(adj))
    tadj = torch.from_numpy(adj.copy())
    tin = recount_indeg(tadj)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    jadj, jin = jbc._orphan_repair(jadj, jin, round_=round_)
    tadj, tin = tbc._orphan_repair(tadj, tin, round_=round_)
    np.testing.assert_array_equal(tadj.numpy(), np.asarray(jadj))
    # the port's in-degree ledger stays equal to its adjacency's (the JAX
    # ledger drifts from its own recount on this collision-heavy input, so
    # the two ledgers are not compared with each other)
    np.testing.assert_array_equal(tin.numpy(), recount_indeg(tadj).numpy())
    jrec = jbc._recount_indeg(jadj)
    assert tbc._any_orphan(tadj, tin) == bool(jbc._any_orphan(jadj, jrec))


def test_kcenter_fill_matches():
    codes, scales = _data(7, n=2000)
    x = (codes.astype(np.float32) * scales[:, 1:2] + scales[:, 0:1]).astype(np.float32)
    base = np.arange(0, 2000, 50)
    want = j_kcenter_fill(jnp.asarray(x), base, 70, batch=32)
    got = t_kcenter_fill(torch.from_numpy(x), base, 70, batch=32)
    np.testing.assert_array_equal(got, want)


def test_port_built_rows_are_sets_without_orphans():
    """The row invariants tests/test_cluster_build.py checks for the JAX
    build: no self-loops, no duplicate row entries, the in-degree ledger
    equals the adjacency's, and every connected node has an in-edge."""
    ds = synthetic_clustered(3000, 24, n_queries=8, seed=13)
    idx = HNSW(8, ef_cons=32, dim=24, device="cpu")
    idx.insert_bulk(ds.train, cluster_build=True,
                    cluster_kwargs={"smax_headroom": 0.5, "select_alg4": False})
    n = len(idx)
    for layer in range(len(idx.graph)):
        adj = idx.graph.get_layer(layer).numpy()
        member = idx.points.levels >= layer
        assert not np.any(adj == np.arange(n)[:, None]), "self-loop"
        for r in np.flatnonzero(member)[::17]:
            row = adj[r][adj[r] >= 0]
            assert row.size == np.unique(row).size, f"dup in row {r}"
        indeg = np.bincount(adj[adj >= 0], minlength=n)
        np.testing.assert_array_equal(idx.graph.indeg(layer).numpy(), indeg)
        outdeg = (adj >= 0).sum(1)
        assert not np.any((outdeg > 0) & (indeg == 0)), "orphan"
        if member.sum() > 1:
            assert np.all(outdeg[member] > 0), "empty member row"
    assert idx.build_phase_s["merge"] > 0.0


def test_repair_connectivity_matches():
    """The connectivity backstop on a broken layer 0 (empty member rows
    and orphans): the same repaired adjacency as the JAX package's."""
    codes, scales = _data(8, n=300)
    rng = np.random.default_rng(9)
    adj = np.stack([rng.choice(60, 8, replace=False) for _ in range(300)])
    adj = adj.astype(np.int32)
    adj[adj == np.arange(300)[:, None]] = -1
    adj[[3, 77, 150]] = -1  # empty member rows
    levels = np.zeros(300, np.int32)
    jg = JGraph(4, 300)
    jg.ensure_level(0)
    jg.set_layer(0, jnp.asarray(adj))
    tg = TGraph(4, 300, "cpu")
    tg.ensure_level(0)
    tg.set_layer(0, torch.from_numpy(adj.copy()))
    j_repair(jg, JStore(*J(codes, scales), levels))
    t_repair(tg, PointStore(*T(codes, scales), levels))
    tadj = tg.get_layer(0).numpy()
    np.testing.assert_array_equal(tadj, np.asarray(jg.get_layer(0)))
    indeg = np.bincount(tadj[tadj >= 0], minlength=300)
    assert np.all((tadj >= 0).sum(1) > 0) and np.all(indeg > 0)


def test_wave_builder_is_not_ported():
    """The wave build's options that used to raise here (E>1 expansion,
    wave_sort, build_seeded) build now, as its default E=1 path does.
    ``stop_layer`` belongs to ``insert_waves`` alone, as in the JAX
    package, so ``build_index`` refuses it. The name dates from when the
    whole wave build raised."""
    store = PointStore.from_vectors(np.zeros((4, 3), np.float32), 0.5, "cpu")
    for kw in ({}, {"build_expand": 2}, {"wave_sort": True},
               {"build_seeded": True}):
        graph, ep, packed0, creps = build_index(store, Params(m=4, dim=3), **kw)
        assert creps is None and packed0 is not None and len(graph) >= 1, kw
    with pytest.raises(TypeError, match="stop_layer"):
        build_index(store, Params(m=4, dim=3), stop_layer=1)


def test_insert_waves_stop_layer_matches_jax():
    """``insert_waves(stop_layer=1)``: the level >= 1 nodes inserted top
    down into an empty graph in both packages give the JAX package's
    upper layers row for row, and layer 0 stays empty (a cluster builder
    owns it)."""
    from hnsw_rs_tpu.build import insert_waves as j_insert_waves
    from hnsw_rs_tpu.params import Params as JParams
    from hnsw_rs_tpu_torch.build import insert_waves as t_insert_waves

    codes, scales = _data(21, n=600)
    levels = sample_levels(600, 1 / np.log(8), seed=0)
    top = int(levels.max())
    ep = int(np.flatnonzero(levels == top)[0])
    jg, tg = JGraph(8, 600), TGraph(8, 600, "cpu")
    jg.ensure_level(top)
    tg.ensure_level(top)
    js, ts = JStore(*J(codes, scales), levels), PointStore(*T(codes, scales), levels)
    jp, tp = JParams(m=8, dim=16, ef_cons=24), Params(m=8, dim=16, ef_cons=24)
    for lam in range(top, 0, -1):
        home = np.flatnonzero(levels == lam).astype(np.int32)
        j_insert_waves(jg, js, jp, home, lam, ep, 64, stop_layer=1)
        t_insert_waves(tg, ts, tp, home, lam, ep, 64, stop_layer=1)
    assert top >= 2
    for lam in range(1, top + 1):
        np.testing.assert_array_equal(tg.get_layer(lam).numpy(),
                                      np.asarray(jg.get_layer(lam)))
        assert torch.equal(tg.indeg(lam), recount_indeg(tg.get_layer(lam)))
    assert bool((tg.get_layer(0) == -1).all()) and not bool(tg.indeg(0).any())
    assert bool((np.asarray(jg.get_layer(0)) == -1).all())
