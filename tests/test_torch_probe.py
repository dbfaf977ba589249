"""Parity of the port's shortlist-probe serving
(``search.ann_search_seeded_probe``, ``ann_search_seeded_probe_packed``,
``_top_ef_dedup_oversampled``, ``models.hnsw._build_shortlist``) with the
JAX package on the CPU, on the same numpy inputs.

Shortlists are equal except where two members' distances tie to the
last ulp (>= 99.5% of the entries, the rest counted). The JAX package reduces the merged probe pool with ``lax.approx_max_k``,
a TPU primitive; on the CPU backend it is exact (held below), so the
port's exact top-4*ef selects the same candidates and ids must be equal.
The pools here are wider than 4*ef, so the reduction really runs. Exact
ties at the 4*ef boundary may be broken differently and are counted.
Distances: seed lanes carry matmul-form distances (absolute error, a few
ulps of |q|^2 + |p|^2), probed lanes the diff-square form: rtol 1e-5 with
an absolute floor of 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_rs_tpu import search as jsearch
from hnsw_rs_tpu.models.hnsw import _build_shortlist as j_build_shortlist
from hnsw_rs_tpu.ops.quant import quantize_np
from hnsw_rs_tpu.ops.topk import PAD_ID
from hnsw_rs_tpu_torch import search as tsearch
from hnsw_rs_tpu_torch.models.hnsw import _build_shortlist

T = torch.from_numpy


def _setup(seed, n=1600, d=24, cap=16, p=80, t=48, b=40):
    """Heavy-tailed-ish points (clusters of very different spread), a
    ragged kNN graph, pivots with one invalid slot, shortlists with -1
    pads, dequantized queries."""
    rng = np.random.default_rng(seed)
    cent = rng.random((20, d), np.float32)
    spread = (0.02 * 8.0 ** rng.random(20)).astype(np.float32)
    a = rng.integers(0, 20, n)
    x = (cent[a] + rng.standard_normal((n, d)).astype(np.float32)
         * spread[a, None]).astype(np.float32)
    codes, scales = quantize_np(x)
    xd = codes.astype(np.float32) * scales[:, 1:2] + scales[:, 0:1]
    d2 = ((xd[:, None] - xd[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    adj = np.argsort(d2, axis=1, kind="stable")[:, :cap].astype(np.int32)
    adj[rng.random((n, cap)) < 0.2] = -1
    piv = rng.choice(n, p, replace=False).astype(np.int32)
    pv = xd[np.maximum(piv, 0)]
    qa = rng.integers(0, 20, b)
    qx = (cent[qa] + rng.standard_normal((b, d)).astype(np.float32)
          * spread[qa, None]).astype(np.float32)
    qc, qs = quantize_np(qx)
    q = (qc.astype(np.float32) * qs[:, 1:2] + qs[:, 0:1]).astype(np.float32)
    return codes, scales, adj, piv, pv.astype(np.float32), q, t


def test_approx_max_k_is_exact_on_the_cpu_backend():
    """What the id-equality below rests on."""
    x = np.random.default_rng(0).normal(size=(16, 3000)).astype(np.float32)
    v, i = jax.lax.approx_max_k(jnp.asarray(-x), 64, recall_target=0.95)
    want = np.sort(x, axis=1)[:, :64]
    np.testing.assert_array_equal(np.sort(-np.asarray(v), axis=1), want)
    np.testing.assert_array_equal(np.take_along_axis(x, np.asarray(i), 1),
                                  -np.asarray(v))


def test_build_shortlist_matches_jax():
    codes, scales, _, piv, pv, _, t = _setup(0)
    js = np.asarray(j_build_shortlist(jnp.asarray(pv), jnp.asarray(codes),
                                      jnp.asarray(scales), t, chunk=32))
    ts = _build_shortlist(T(pv), T(codes), T(scales), t, chunk=32)
    assert ts.dtype == torch.int32 and ts.shape == (len(piv), t)
    # the affine form's product sums in another order on the two sides, so
    # two members within an ulp of each other may swap places (counted)
    same = ts.numpy() == js
    print(f"shortlist entries that differ (near-ties): {int((~same).sum())}")
    assert same.mean() >= 0.995
    # every pivot heads its own shortlist
    assert np.array_equal(ts.numpy()[:, 0], piv)


@pytest.mark.parametrize("ef,width", [(8, 200), (16, 65), (16, 40)])
def test_top_ef_dedup_oversampled_matches_jax(ef, width):
    rng = np.random.default_rng(ef + width)
    ids = rng.integers(0, 90, (30, width)).astype(np.int32)  # many duplicates
    d2 = (ids * 0.37 % 5.0).astype(np.float32)  # equal ids carry equal d2
    pad = rng.random((30, width)) < 0.1
    ids[pad], d2[pad] = PAD_ID, np.inf
    jd, ji = jsearch._top_ef_dedup_oversampled(jnp.asarray(d2), jnp.asarray(ids), ef)
    td, ti = tsearch._top_ef_dedup_oversampled(T(d2), T(ids), ef)
    # the first ef columns are what the callers read; distinct ids with
    # equal d2 straddling the 4*ef cut may be kept differently (counted)
    same = (ti.numpy()[:, :ef] == np.asarray(ji)[:, :ef]).all(axis=1)
    print(f"rows with a tie at the 4*ef boundary: {int((~same).sum())} of 30")
    assert same.mean() >= 0.9
    np.testing.assert_array_equal(td.numpy()[:, :ef], np.asarray(jd)[:, :ef])
    for row in ti.numpy()[:, :ef]:
        real = row[row != PAD_ID]
        assert len(set(real.tolist())) == real.size


@pytest.mark.parametrize("ef,probes,expand_e", [(8, 6, 1), (16, 3, 1), (12, 4, 2)])
def test_probe_routes_match_jax(ef, probes, expand_e):
    codes, scales, adj, piv, pv, q, t = _setup(ef)
    piv = piv.copy()
    piv[7] = -1  # an invalid pivot slot is never a seed nor probed
    sl = np.array(j_build_shortlist(jnp.asarray(pv), jnp.asarray(codes),
                                    jnp.asarray(scales), t))
    sl[:, -5:] = -1  # padded shortlist members
    assert ef + probes * t > 4 * ef  # the oversampled reduction runs
    jp = jsearch.pack_layer(jnp.asarray(adj), jnp.asarray(codes), jnp.asarray(scales))
    jslp = jsearch.pack_layer(jnp.asarray(sl), jnp.asarray(codes), jnp.asarray(scales))
    tp = tsearch.pack_layer(T(adj), T(codes), T(scales))
    tslp = tsearch.pack_layer(T(sl), T(codes), T(scales))
    np.testing.assert_array_equal(tslp.numpy(), np.asarray(jslp))
    k, mi, d = 10, 2 * ef + 16, codes.shape[1]
    jd, ji = jsearch.ann_search_seeded_probe(
        jp, jnp.asarray(piv), jnp.asarray(pv), jnp.asarray(sl), jnp.asarray(codes),
        jnp.asarray(scales), jnp.asarray(q), ef, min(k, ef), mi, probes, expand_e)
    td, ti = tsearch.ann_search_seeded_probe(
        tp, T(piv), T(pv), T(sl), T(codes), T(scales), T(q), ef, min(k, ef), mi,
        probes, expand_e)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    jd2, ji2 = jsearch.ann_search_seeded_probe_packed(
        jp, jnp.asarray(piv), jnp.asarray(pv), jslp, t, d, jnp.asarray(q), ef,
        min(k, ef), mi, probes, expand_e)
    td2, ti2 = tsearch.ann_search_seeded_probe_packed(
        tp, T(piv), T(pv), tslp, t, d, T(q), ef, min(k, ef), mi, probes, expand_e)
    np.testing.assert_array_equal(ti2.numpy(), np.asarray(ji2))
    # the packed and the narrow route score the same candidates
    np.testing.assert_array_equal(ti2.numpy(), ti.numpy())
    np.testing.assert_array_equal(td2.numpy(), td.numpy())


def test_probe_seeds_do_not_depend_on_the_query_chunk(monkeypatch):
    """The probed seed stage runs over chunks of queries; the chunk size
    changes nothing."""
    codes, scales, adj, piv, pv, q, t = _setup(3)
    sl = _build_shortlist(T(pv), T(codes), T(scales), t)
    tp = tsearch.pack_layer(T(adj), T(codes), T(scales))
    tslp = tsearch.pack_layer(sl, T(codes), T(scales))
    args = (tp, T(piv), T(pv), tslp, t, codes.shape[1], T(q), 12, 10, 40, 5)
    whole = tsearch.ann_search_seeded_probe_packed(*args)
    monkeypatch.setattr(tsearch, "_query_chunk", lambda b, per, dev: 7)
    parts = tsearch.ann_search_seeded_probe_packed(*args)
    assert torch.equal(whole[1], parts[1]) and torch.equal(whole[0], parts[0])
    narrow = tsearch.ann_search_seeded_probe(
        tp, T(piv), T(pv), sl, T(codes), T(scales), T(q), 12, 10, 40, 5)
    assert torch.equal(narrow[1], whole[1])


@pytest.mark.parametrize("n,d,nq,seed,n_clusters", [(2000, 16, 64, 42, None),
                                                    (700, 8, 33, 0, 70)])
def test_synthetic_heavy_tailed_is_the_jax_packages(n, d, nq, seed, n_clusters):
    from hnsw_rs_tpu.utils.datasets import synthetic_heavy_tailed as j_ht
    from hnsw_rs_tpu_torch.utils.datasets import synthetic_heavy_tailed as t_ht

    a = j_ht(n, d, n_queries=nq, seed=seed, n_clusters=n_clusters)
    b = t_ht(n, d, n_queries=nq, seed=seed, n_clusters=n_clusters)
    np.testing.assert_array_equal(b.train, a.train)
    np.testing.assert_array_equal(b.test, a.test)
    assert b.name == a.name and b.metric == a.metric and b.neighbors is None
    assert b.train.dtype == np.float32 and b.test.shape == (nq, d)
