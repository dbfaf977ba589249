"""The scale-out layer of the PyTorch port (``hnsw_rs_tpu_torch.parallel``)
against the JAX package on the CPU (its 8-device virtual mesh from
``conftest.py``).

One JAX sharded index is built (sequentially, over skewed bounds) and
saved once per module; every parity test reads that state. Tolerances:
ids, pivot rows, gids, levels and adjacency rows must be equal;
distances are held to rtol 1e-5 (the same sums, possibly in another
order). The concurrent builds are recall- and structure-gated, as the
JAX package gates its own.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from hnsw_rs_tpu.parallel import ShardedHNSW as JSharded
from hnsw_rs_tpu.parallel import make_mesh as j_make_mesh
from hnsw_rs_tpu_torch import HNSW, FlatIndex
from hnsw_rs_tpu_torch.parallel import ReplicatedHNSW, ShardedHNSW, make_mesh

N, D, M, K, EF = 240, 16, 8, 10, 40
BOUNDS = [0, 100, 165, 210, 240]  # skewed: dead tail rows, uneven budgets
PIVOTS = 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _recall(ids, truth):
    return float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, truth)]))


def _mesh(n_shard=4):
    return make_mesh(1, n_shard, ["cpu"] * n_shard)


def _capture(index):
    """Record the arguments of ``index._insert_rows`` (the wave insert
    that ``add`` and ``rebalance`` end in) and skip the insert."""
    calls = []
    index._insert_rows = lambda *a, **k: calls.append((a, k))
    return calls


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's sequential sharded build (even bounds: the four
    sub-builds share their compiled programs), saved, with its plain
    answers, its seeded answers and pivot rows after ``finalize``, and
    what its ``add`` hands the wave insert; then a port-built skewed
    index saved and read by the JAX package: its pivot rows after
    ``finalize`` and what its ``rebalance`` hands the wave insert."""
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((24, D)).astype(np.float32)
    more = rng.standard_normal((40, D)).astype(np.float32)
    root = tmp_path_factory.mktemp("sharded")
    out = dict(vecs=vecs, queries=queries, more=more, root=root)
    j = JSharded(M, D, 4, mesh=j_make_mesh(1, 4))
    j.insert_bulk(vecs, concurrent=False)
    j.save(str(root / "built"))
    out["plain"] = j.ann_batch(queries, K, EF)
    j.finalize(pivots=PIVOTS)
    out["seeded"] = j.ann_batch(queries, K, EF)
    calls = _capture(j)
    out["gids"] = j.add(more)
    out["add_args"] = calls[0]

    t = ShardedHNSW(M, D, 4, mesh=_mesh())
    t.insert_bulk(vecs, partition_bounds=BOUNDS)
    t.save(str(root / "skewed"))
    js = JSharded.load(str(root / "skewed"), mesh=j_make_mesh(1, 4))
    js.finalize(pivots=PIVOTS, pivot_cover=0.5)
    out["skewed_pid"] = np.asarray(js._packed[1])
    js = JSharded.load(str(root / "skewed"), mesh=j_make_mesh(1, 4))
    calls = _capture(js)
    out["moved"] = js.rebalance()
    out["rebalance_args"] = calls[0]

    flat = FlatIndex(D, "cpu")
    flat.add(vecs)
    out["truth"] = flat.search(queries, K, exact=True)[1]
    return out


def _npz(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def _same_args(got, want):
    (ga, gk), (wa, wk) = got, want
    assert len(ga) == len(wa) and gk.keys() == wk.keys()
    for x, y in zip(ga, wa):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for key in wk:
        if wk[key] is None or isinstance(wk[key], bool):
            assert gk[key] == wk[key], key
        else:
            for x, y in zip(gk[key], wk[key]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), key)


@pytest.mark.parametrize("route", ["plain", "seeded"])
def test_loaded_jax_index_answers_the_same(ref, route):
    """A JAX-saved sharded index loaded by the port answers with the JAX
    ids, through the plain hierarchical query and, after ``finalize``,
    the pivot-seeded one (``sharded_query``, ``sharded_query_seeded``,
    the merge and ``load``, apart from any build)."""
    t = ShardedHNSW.load(str(ref["root"] / "built"), _mesh())
    assert len(t) == N and list(t._counts) == [N // 4] * 4
    if route == "seeded":
        t.finalize(pivots=PIVOTS)
    d, i = t.ann_batch(ref["queries"], K, EF)
    jd, ji = ref[route]
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=1e-5)
    assert _recall(i, ref["truth"]) > 0.9


def test_cover_fill_pivots_match_jax(ref):
    """``finalize``'s per-shard pivot rows on a skewed state (level picks,
    then the k-center fill over each shard's live rows, in pick order, up
    to the shard's own need) equal the JAX package's."""
    t = ShardedHNSW.load(str(ref["root"] / "skewed"), _mesh())
    t.finalize(pivots=PIVOTS, pivot_cover=0.5)
    pid = np.stack([p.numpy() for p in t._packed[1]])
    np.testing.assert_array_equal(pid, ref["skewed_pid"])
    for s, row in enumerate(pid):
        live = row[row >= 0]
        assert live.size == min(PIVOTS, int(t._counts[s]))
        assert np.unique(live).size == live.size and live.max() < t._counts[s]


def test_port_save_loads_in_jax(ref, tmp_path):
    """The port's ``save`` writes the JAX package's directory: the JAX
    package loads it and answers with the same ids; the arrays equal the
    ones it was loaded from."""
    t = ShardedHNSW.load(str(ref["root"] / "built"), _mesh())
    t.save(str(tmp_path / "port"))
    want, got = _npz(ref["root"] / "built"), _npz(tmp_path / "port")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    j = JSharded.load(str(tmp_path / "port"), mesh=j_make_mesh(1, 4))
    np.testing.assert_array_equal(j.ann_batch(ref["queries"], K, EF)[1],
                                  ref["plain"][1])


def test_sequential_build_matches_jax(ref):
    """``insert_bulk(concurrent=False)`` builds each shard with the single
    index's builder: the same levels, entry points and adjacency as the
    JAX package's sequential build, and the same answers."""
    t = ShardedHNSW(M, D, 4, mesh=_mesh())
    t.insert_bulk(ref["vecs"], concurrent=False)
    want = _npz(ref["root"] / "built")
    _, got = t.to_numpy()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(t.ann_batch(ref["queries"], K, EF)[1],
                                  ref["plain"][1])


def test_add_places_like_jax(ref):
    """``add`` on the loaded state hands the wave insert what the JAX
    package's ``add`` hands it: the same codes, global ids, level draws
    (seed S + calls) and least-loaded round-robin shard assignment; then
    the new points are inserted and find themselves."""
    t = ShardedHNSW.load(str(ref["root"] / "built"), _mesh())
    calls = []
    insert = t._insert_rows
    t._insert_rows = lambda *a, **k: (calls.append((a, k)), insert(*a, **k))[1]
    gids = t.add(ref["more"])
    np.testing.assert_array_equal(gids, ref["gids"])
    _same_args(calls[0], ref["add_args"])
    assert len(t) == N + 40 and t._level_calls == 1
    _, ids = t.ann_batch(ref["more"], 1, EF)
    assert np.mean(ids[:, 0] == gids) >= 0.9
    _structure_ok(t)


def _structure_ok(t):
    """Degree caps, no self-edges, no edge into a dead row, and every live
    row of every shard reachable from its entry point at layer 0."""
    st = t._stacked
    for s in range(t.n_shards):
        k = int(t._counts[s])
        for lam, a in enumerate(st["adjs"]):
            a = a[s].numpy()
            cap = t.params.layer_cap(lam)
            assert a.shape[1] == cap
            rows = np.arange(a.shape[0])[:, None]
            assert not np.any(a == rows), (s, lam)
            assert not np.any(a >= k), (s, lam)
            member = np.flatnonzero(t._levels[s] >= lam)
            assert np.all((a[member] >= 0).sum(1) > 0) or member.size <= 1
        a0 = st["adjs"][0][s].numpy()
        seen = np.zeros(a0.shape[0], bool)
        frontier = [int(st["eps"][s])]
        seen[frontier] = True
        while frontier:
            nxt = a0[frontier].ravel()
            nxt = np.unique(nxt[nxt >= 0])
            nxt = nxt[~seen[nxt]]
            seen[nxt] = True
            frontier = nxt.tolist()
        assert seen[:k].all(), (s, int((~seen[:k]).sum()))


@pytest.mark.parametrize("kw", [{}, {"cluster_build": True}], ids=["wave", "cluster"])
def test_concurrent_builds_clear_recall_and_structure(ref, kw):
    """The shard-concurrent wave build and cluster build (the latter with
    no host repair backstop) clear recall against brute force, plain and
    seeded, and keep the graph's structure."""
    t = ShardedHNSW(M, D, 4, mesh=_mesh())
    t.insert_bulk(ref["vecs"], **kw)
    assert len(t) == N and not t.shards
    _structure_ok(t)
    assert _recall(t.ann_batch(ref["queries"], K, EF)[1], ref["truth"]) > 0.95
    t.finalize(pivots=PIVOTS)
    assert _recall(t.ann_batch(ref["queries"], K, EF)[1], ref["truth"]) > 0.95
    if kw:
        reps = t._cluster_reps
        assert reps.shape[0] == 4 and all((r[r >= 0] < c).all()
                                          for r, c in zip(reps, t._counts))


def test_rebalance_moves_like_jax_and_keeps_recall(ref):
    """``rebalance`` on the skewed state moves the JAX package's count and
    hands the wave insert what the JAX package's hands it (the movers'
    codes, global ids, levels and destinations, and the scrubbed rows to
    re-wave); after the insert every global id is served once, the
    structure holds and so does recall."""
    t = ShardedHNSW.load(str(ref["root"] / "skewed"), _mesh())
    before = _recall(t.ann_batch(ref["queries"], K, EF)[1], ref["truth"])
    calls = []
    insert = t._insert_rows
    t._insert_rows = lambda *a, **k: (calls.append((a, k)), insert(*a, **k))[1]
    moved = t.rebalance()
    assert moved == ref["moved"] > 0
    _same_args(calls[0], ref["rebalance_args"])
    assert list(t._counts) == [N // 4] * 4
    _, got = t.to_numpy()
    assert sorted(got["gids"][got["gids"] >= 0].tolist()) == list(range(N))
    _structure_ok(t)
    r = _recall(t.ann_batch(ref["queries"], K, EF)[1], ref["truth"])
    assert r >= before - 0.05 and r > 0.9, (before, r)
    assert t.rebalance() == 0


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_replicated_matches_single_index(ref, metric):
    """``ReplicatedHNSW`` over four data rows answers with the single
    index's ids (cosine queries normalized as ``HNSW.ann_batch`` does)."""
    v = ref["vecs"] + (0.5 if metric == "cosine" else 0.0)
    index = HNSW(M, dim=D, metric=metric, device="cpu")
    index.insert_bulk(v)
    q = ref["queries"][:18] * 3.0
    d1, i1 = index.ann_batch(q, 5, EF)
    rep = ReplicatedHNSW(index, make_mesh(4, 1, ["cpu"] * 4))
    d2, i2 = rep.ann_batch(q, 5, EF)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_allclose(d2, d1, rtol=1e-6)


def test_stray_kwargs_refused_before_the_build(ref):
    t = ShardedHNSW(M, D, 4, mesh=_mesh())
    with pytest.raises(TypeError, match="wave_sort"):
        t.insert_bulk(ref["vecs"], cluster_build=True, wave_sort=True)
    assert t._stacked is None and len(t) == 0
    with pytest.raises(ValueError, match="partition_bounds"):
        t.insert_bulk(ref["vecs"], partition_bounds=[0, 10, 5, N, N])
    with pytest.raises(ValueError, match="shard columns"):
        ShardedHNSW(M, D, 3, mesh=_mesh())


def test_two_process_gloo_query_matches_in_process(ref, tmp_path):
    """The rank form (``multihost``: each of two processes reads only its
    own two shards, one ``all_gather`` and one sort) returns the
    in-process ``sharded_query`` ids."""
    t = ShardedHNSW.load(str(ref["root"] / "built"), _mesh())
    want = t.ann_batch(ref["queries"], K, 48)[1]
    np.save(tmp_path / "q.npy", ref["queries"])
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hnsw_rs_tpu_torch.parallel.multihost",
         "--device", "cpu", "--backend", "gloo", "--coordinator", f"tcp://localhost:{port}", "--world", "2",
         "--rank", str(r), "--index", str(ref["root"] / "built"),
         "--queries", str(tmp_path / "q.npy"), "--out", str(tmp_path / "ids.npy"),
         "--k", str(K), "--ef", "48"], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=60)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    np.testing.assert_array_equal(np.load(tmp_path / "ids.npy"), want)
