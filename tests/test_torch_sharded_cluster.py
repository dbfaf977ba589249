"""The shard-concurrent builders of the PyTorch port against the JAX
package's, on the CPU (its 8-device virtual mesh from ``conftest.py``).

The JAX package runs each phase of ``sharded_cluster_layer`` as one
``shard_map`` program over stacked ``[S, ns, ...]`` inputs; the port
runs the same phase shard by shard. Here the same stacked inputs (N=960
clustered points over four skewed shards) go through both, phase by
phase and for layers 0 and 1, each phase fed the JAX package's own
output of the phase before: ``_prep_shard`` (k-means assignment and the
split projection), ``_tables_shard`` (fan-out and representatives), the
select loop, ``_merge_shard`` (union-prune merge and orphan fixpoint),
then the whole layer and the whole concurrent builds, cluster and wave.

One defect of the JAX package is set aside: where a shard has fewer
live clusters than the fan-out (an upper layer of a small shard), its
``_tables_shard`` fills the missing fan-out picks with ``top_k``'s first
index among masked ties, which can be the cluster itself; the select
then sees each member twice and the merge writes duplicate edges into a
row. The port leaves those picks at -1. Every JAX phase after the
tables here runs on the fan-out with those picks at -1 (``_fan_out``,
also patched into the JAX package's whole layer and build, in this test
process only), and ``test_tables_shard_matches_jax`` shows the raw
picks that differ are exactly the masked ones.

Tolerances: assignments, fan-outs, representatives, merged adjacency and
in-degrees must be equal; projections and selection distances are held
to rtol 1e-5 (the same sums in another order), and selection ids to 99%
of the lanes, as ``test_torch_build.py`` holds the single builder's
select (its pool distances may swap near-ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from hnsw_rs_tpu import build_cluster as jbc
from hnsw_rs_tpu.ops.quant import quantize_np
from hnsw_rs_tpu.parallel import ShardedHNSW as JSharded
from hnsw_rs_tpu.parallel import make_mesh as j_make_mesh
from hnsw_rs_tpu.parallel import sharded_cluster as jsc
from hnsw_rs_tpu.store import sample_levels
from hnsw_rs_tpu_torch.build_cluster import _cluster_sel_step_impl
from hnsw_rs_tpu_torch.params import Params
from hnsw_rs_tpu_torch.parallel import ShardedHNSW, make_mesh
from hnsw_rs_tpu_torch.parallel import sharded_cluster as tsc

N, D, M, S = 960, 16, 8, 4
BOUNDS = [0, 300, 540, 780, 960]  # uneven shards: pad rows and pad clusters
KW = {"points_per_cluster": 32, "fanout": 4, "pool_p": 40}
ITERS, TPC, REPAIR = 4, 8, 10  # sharded_cluster_layer's defaults


def _smap(mesh, body, n_in, n_out):
    """``body`` on every shard's slice of ``n_in`` stacked inputs, as
    ``sharded_cluster_layer`` runs each phase."""
    return jax.jit(jax.shard_map(
        lambda *a: tuple(x[None] for x in body(*(y[0] for y in a))), mesh=mesh,
        in_specs=(P("shard"),) * n_in, out_specs=(P("shard"),) * n_out,
        check_vma=False))


def _fan_out(c, sc, t, rchunk, c_fan):
    """The JAX package's ``_tables_shard`` with the fan-out picks that
    name a masked cluster (itself past column 0, or an empty pad) at
    -1, as the port's are."""
    nbrcl, reps = _JAX_TABLES(c, sc, t, rchunk=rchunk, c_fan=c_fan)
    live = jnp.any(t >= 0, axis=1)
    own = nbrcl == jnp.arange(nbrcl.shape[0], dtype=nbrcl.dtype)[:, None]
    masked = (own | ~live[nbrcl]).at[:, 0].set(False)
    return jnp.where(masked, -1, nbrcl), reps


_JAX_TABLES = jsc._tables_shard


def _points():
    rng = np.random.default_rng(3)
    cent = rng.random((30, D), np.float32)
    return (cent[rng.integers(0, 30, N)]
            + rng.normal(0, 0.05, (N, D))).astype(np.float32)


@pytest.fixture(scope="module")
def stacked():
    """The four shards' codes, scales and levels, stacked and padded to
    the largest shard as ``ShardedHNSW._build_concurrent_cluster`` does."""
    v = _points()
    ns = int(np.diff(BOUNDS).max())
    codes = np.zeros((S, ns, D), np.uint8)
    scales = np.zeros((S, ns, 2), np.float32)
    levels = np.full((S, ns), -1, np.int32)
    ml = Params.from_m(M, D).ml
    for s in range(S):
        lo, hi = BOUNDS[s], BOUNDS[s + 1]
        codes[s, :hi - lo], scales[s, :hi - lo] = quantize_np(v[lo:hi])
        levels[s, :hi - lo] = sample_levels(hi - lo, ml, seed=s)
    return dict(v=v, codes=codes, scales=scales, levels=levels,
                counts=np.diff(BOUNDS).astype(np.int64))


@pytest.fixture(scope="module", params=[0, 1], ids=["layer0", "layer1"])
def phases(request, stacked):
    """The JAX package's phases of ``sharded_cluster_layer`` for one
    layer, run one by one with its own sizing arithmetic; every phase's
    stacked inputs and outputs are kept."""
    layer = request.param
    codes, scales, levels = stacked["codes"], stacked["scales"], stacked["levels"]
    mesh = j_make_mesh(1, S)
    put = lambda x: jax.device_put(np.asarray(x), NamedSharding(mesh, P("shard")))  # noqa: E731
    jc, js = put(codes), put(scales)
    ns = codes.shape[1]
    cap = Params.from_m(M, D).layer_cap(layer)
    mems = [np.arange(c, dtype=np.int32) if layer == 0 else
            np.flatnonzero(levels[s, :c] >= layer).astype(np.int32)
            for s, c in enumerate(stacked["counts"])]
    rmax = max(mm.size for mm in mems)
    rpad = -(-rmax // 8) * 8
    rows = np.full((S, rpad), -1, np.int32)
    for s, mm in enumerate(mems):
        rows[s, :mm.size] = mm
    rcounts = np.asarray([mm.size for mm in mems], np.int32)
    ppc = KW["points_per_cluster"]
    k = max(1, min(rpad, -(-rmax // ppc)))
    chunk = min(16384, rpad)
    out = dict(layer=layer, mems=mems, rpad=rpad, k=k, chunk=chunk, cap=cap)

    assign, proj = _smap(mesh, lambda c, sc, r, rc: jsc._prep_shard(
        c, sc, r, rc, k=k, iters=ITERS, train_per_cluster=TPC, chunk=chunk,
        ppc=ppc), 4, 2)(jc, js, put(rows), put(rcounts))
    out["assign"], out["proj"] = np.asarray(assign), np.asarray(proj)

    smax = max(8, int(np.ceil(rpad / k * 1.75 / 8)) * 8)
    tables, ks = [], []
    for s, mm in enumerate(mems):
        a, ksp = jbc._split_oversized(out["assign"][s, :mm.size].copy(), k, smax,
                                      keys=out["proj"][s, :mm.size])
        t, ov = jbc._member_tables(a, ksp, smax)
        assert not ov
        tables.append(np.where(t >= 0, mm[np.clip(t, 0, mm.size - 1)], -1))
        ks.append(ksp)
    kmax = max(ks)
    rch = min(1024, max(8, 1 << max(kmax - 1, 1).bit_length()))
    kpad = -(-kmax // rch) * rch
    tpad = np.full((S, kpad, smax), -1, np.int32)
    for s in range(S):
        tpad[s, :ks[s]] = tables[s]
    c_fan = min(KW["fanout"], kmax)
    raw, _ = _smap(mesh, lambda c, sc, t: _JAX_TABLES(
        c, sc, t, rchunk=rch, c_fan=c_fan), 3, 2)(jc, js, put(tpad))
    nbrcl, reps = _smap(mesh, lambda c, sc, t: _fan_out(
        c, sc, t, rchunk=rch, c_fan=c_fan), 3, 2)(jc, js, put(tpad))
    out.update(ks=ks, smax=smax, rch=rch, tpad=tpad, c_fan=c_fan,
               nbrcl_raw=np.asarray(raw), nbrcl=np.asarray(nbrcl),
               reps=np.asarray(reps))

    g = max(1, 4096 // smax)
    selp = min(max(KW["pool_p"], M), c_fan * smax)
    sel = _smap(mesh, lambda c, sc, t, nb, cl: jbc._cluster_sel_step_impl(
        c, sc, t, nb, cl, m=M, pool_p=selp, select_alg4=True), 5, 3)
    groups, sels = [], []
    for base in range(0, kmax, g):
        cl = np.full((S, g), -1, np.int32)
        for s in range(S):
            take = max(0, min(g, ks[s] - base))
            cl[s, :take] = np.arange(base, base + take, dtype=np.int32)
        groups.append(cl)
        sels.append([np.asarray(x) for x in sel(jc, js, put(tpad), nbrcl, put(cl))])
    out.update(g=g, selp=selp, groups=groups,
               **{name: np.concatenate([x[i] for x in sels], axis=1)
                  for i, name in enumerate(["qflat", "sel_d2", "sel_ids"])})

    rows_mode = layer != 0
    rchunk = min(16384, max(1024, 1 << max((rmax if rows_mode else ns) - 1, 1)
                            .bit_length()))
    mrows = np.full((S, -(-rmax // rchunk) * rchunk if rows_mode else 1), -1,
                    np.int32)
    if rows_mode:
        for s, mm in enumerate(mems):
            mrows[s, :mm.size] = mm
    adj0 = np.full((S, ns, cap), -1, np.int32)
    adj, indeg = _smap(mesh, lambda a, q, sd, si, r, c, sc: jsc._merge_shard(
        a, q, sd, si, r, c, sc, slots=2 * cap, rchunk=rchunk, rows_mode=rows_mode,
        heuristic=True, repair_rounds=REPAIR), 7, 2)(
        put(adj0), put(out["qflat"]), put(out["sel_d2"]), put(out["sel_ids"]),
        put(mrows), jc, js)
    out.update(rchunk=rchunk, adj=np.asarray(adj), indeg=np.asarray(indeg))
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


def test_prep_shard_matches_jax(stacked, phases):
    """Per shard: the k-means over the shard's members with the global k
    (dead centroids past its own share) assigns every member to the same
    centroid, and the split projection agrees."""
    for s, mm in enumerate(phases["mems"]):
        assign, proj = tsc._prep_shard(
            _t(stacked["codes"][s]), _t(stacked["scales"][s]), _t(mm.astype(np.int64)),
            phases["rpad"], phases["k"], ITERS, TPC, phases["chunk"],
            KW["points_per_cluster"])
        np.testing.assert_array_equal(assign.numpy(), phases["assign"][s, :mm.size])
        np.testing.assert_allclose(proj.numpy(), phases["proj"][s, :mm.size],
                                   rtol=1e-5, atol=1e-5)


def test_tables_shard_matches_jax(stacked, phases):
    """Per shard, on the same member tables (pad clusters included): each
    cluster's representative and its nearest-cluster fan-out. Where a
    shard has fewer live clusters than the fan-out, the port's missing
    picks are -1; there, and only there, the JAX package's raw picks
    name the cluster itself or an empty pad."""
    for s, ks in enumerate(phases["ks"]):
        nbrcl, reps = tsc._tables_shard(
            _t(stacked["codes"][s]), _t(stacked["scales"][s]),
            _t(phases["tpad"][s]), phases["rch"], phases["c_fan"])
        got, raw = nbrcl.numpy()[:ks], phases["nbrcl_raw"][s, :ks]
        np.testing.assert_array_equal(got, phases["nbrcl"][s, :ks])
        live = (phases["tpad"][s] >= 0).any(1)
        others = live.sum() - live[:ks]
        assert np.all((got >= 0).sum(1) == 1 + np.minimum(phases["c_fan"] - 1, others))
        gone = raw[got < 0]
        assert np.all(~live[gone] | (gone == np.nonzero(got < 0)[0]))
        np.testing.assert_array_equal(got[got >= 0], raw[got >= 0])
        np.testing.assert_array_equal(reps.numpy()[:ks], phases["reps"][s, :ks])
    if phases["layer"] == 1:  # this layer of this data holds the defect
        assert any((phases["nbrcl_raw"][s, :ks, 1:]
                    == np.arange(ks)[:, None]).any()
                   for s, ks in enumerate(phases["ks"]))


def test_select_matches_jax(stacked, phases):
    """Per shard, the select over every group of clusters (the JAX
    package's lanes past a shard's own clusters are pads, and select
    nothing) on the same tables and fan-out."""
    for s in range(S):
        got = [_cluster_sel_step_impl(
            _t(stacked["codes"][s]), _t(stacked["scales"][s]), _t(phases["tpad"][s]),
            _t(phases["nbrcl"][s]), _t(cl[s]), m=M, pool_p=phases["selp"],
            select_alg4=True) for cl in phases["groups"]]
        qflat, d2, ids = (torch.cat([x[i] for x in got]).numpy() for i in range(3))
        np.testing.assert_array_equal(qflat, phases["qflat"][s])
        live = qflat >= 0
        assert np.mean(ids[live] == phases["sel_ids"][s][live]) >= 0.99
        np.testing.assert_allclose(d2[live], phases["sel_d2"][s][live],
                                   rtol=1e-5, atol=1e-5)


def test_merge_shard_matches_jax(stacked, phases):
    """Per shard, on the JAX package's own selection: the row map, the
    union-prune merge (member rows only above layer 0), the in-degree
    recount and the orphan fixpoint give the same adjacency and
    in-degrees."""
    for s, mm in enumerate(phases["mems"]):
        ns = stacked["codes"].shape[1]
        adj, indeg = tsc._merge_shard(
            torch.full((ns, phases["cap"]), -1, dtype=torch.int32),
            _t(phases["qflat"][s]), _t(phases["sel_d2"][s]), _t(phases["sel_ids"][s]),
            _t(mm.astype(np.int64)), _t(stacked["codes"][s]), _t(stacked["scales"][s]),
            slots=2 * phases["cap"], rchunk=phases["rchunk"],
            rows_mode=phases["layer"] != 0, heuristic=True, repair_rounds=REPAIR)
        np.testing.assert_array_equal(adj.numpy(), phases["adj"][s], err_msg=f"shard {s}")
        np.testing.assert_array_equal(indeg.numpy(), phases["indeg"][s])


def _share(got, want):
    """The share of rows that are equal."""
    return float((got == want).all(1).mean())


def _is_set(rows):
    return all(np.unique(r[r >= 0]).size == (r >= 0).sum() for r in rows)


def test_cluster_layer_matches_jax(stacked, phases, monkeypatch):
    """The whole layer, through each package's ``sharded_cluster_layer``
    (the JAX package's with ``_fan_out``): the same layer-0 serving
    representatives, and the same adjacency on at least 99% of every
    shard's member rows (the select's near-tie swaps carry into the
    merge). The port's rows are sets."""
    layer, cap = phases["layer"], phases["cap"]
    ns = stacked["codes"].shape[1]
    monkeypatch.setattr(jsc, "_tables_shard", _fan_out)
    mesh = make_mesh(1, S, ["cpu"] * S)
    adj_s, _, reps = tsc.sharded_cluster_layer(
        mesh, [_t(c) for c in stacked["codes"]], [_t(c) for c in stacked["scales"]],
        [torch.full((ns, cap), -1, dtype=torch.int32) for _ in range(S)],
        stacked["counts"], stacked["levels"], layer, cap=cap, m=M, **KW)
    shares = [_share(adj_s[s].numpy()[mm], phases["adj"][s][mm])
              for s, mm in enumerate(phases["mems"])]
    assert min(shares) >= 0.99, shares
    assert all(_is_set(a.numpy()) for a in adj_s)
    if layer == 0:
        want = np.where(phases["reps"] >= 0, phases["reps"], -1)
        for s, ks in enumerate(phases["ks"]):
            np.testing.assert_array_equal(reps[s, :ks], want[s, :ks])


@pytest.mark.parametrize("kw", [{}, {"cluster_build": True, "cluster_kwargs": KW}],
                         ids=["wave", "cluster"])
def test_concurrent_build_matches_jax(stacked, kw, tmp_path, monkeypatch):
    """The whole shard-concurrent build on skewed bounds, in each package
    (the JAX package's cluster build with ``_fan_out``): the same codes,
    scales, global ids, levels, entry points and counts; the wave build's
    adjacency equal on every layer, the cluster build's on at least 99%
    of each shard's member rows, and its representatives equal."""
    monkeypatch.setattr(jsc, "_tables_shard", _fan_out)
    j = JSharded(M, D, S, mesh=j_make_mesh(1, S))
    j.insert_bulk(stacked["v"], partition_bounds=BOUNDS, **kw)
    j.save(str(tmp_path / "jax"))
    with np.load(tmp_path / "jax" / "arrays.npz") as z:
        want = {k: z[k] for k in z.files}
    t = ShardedHNSW(M, D, S, mesh=make_mesh(1, S, ["cpu"] * S))
    t.insert_bulk(stacked["v"], partition_bounds=BOUNDS, **kw)
    _, got = t.to_numpy()
    assert set(got) == set(want)
    for k in want:
        if not k.startswith("adj_") or not kw:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            continue
        lam = int(k[4:])
        for s in range(S):
            mem = want["levels"][s] >= lam
            assert not mem.any() or _share(got[k][s][mem], want[k][s][mem]) >= 0.99, (k, s)
            assert _is_set(got[k][s])
    if kw:
        np.testing.assert_array_equal(t._cluster_reps, j._cluster_reps)
