"""Parity of the port's product-quantization primitives and PQ serving
(``hnsw_rs_tpu_torch.ops.pq``, ``search.ann_search_pq``) with the JAX
package on the CPU, on the same numpy inputs.

Tolerances: ``pack_nibbles``, ``pack_layer_pq`` and codes from equal
codebooks are equal; LUTs and ADC scores agree to 1e-5 (relative, with an
absolute floor of 1e-5 times the largest entry: the expanded form cancels);
codebook entries from ``train_pq`` agree to 1e-4 on >= 99% of the entries
and codes on >= 99% (Lloyd's sums run in different orders, a scatter-add
there and a one-hot product here; and where a point is equally near two
centroids to the last ulp, the two sides' products may assign it
differently, which moves both cells' centroids: such entries are
counted); OPQ is held to orthogonality (|R^T R - I| <= 1e-4) and to the JAX
run's distortion within 2%, not to R element by element (six rounds of
retraining amplify ulp differences between the two SVDs);
``ann_search_pq`` given equal codebooks returns equal ids except where
two ADC scores tie to the last ulps (such rows are counted, at most 2
of 48, or 8 of 48 under an OPQ rotation, where the two sides' ``q @ R``
differ in the last ulp; a differing row shares >= 8 of its 10 ids).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_rs_tpu import search as jsearch
from hnsw_rs_tpu.ops import pq as jpq
from hnsw_rs_tpu.ops.quant import quantize_np
from hnsw_rs_tpu_torch import search as tsearch
from hnsw_rs_tpu_torch.ops import pq as tpq


def _points(seed, n=1500, d=32):
    rng = np.random.default_rng(seed)
    cent = rng.random((24, d), np.float32)
    return (cent[rng.integers(0, 24, n)]
            + rng.normal(0, 0.08, (n, d))).astype(np.float32)


def _codebooks_close(tcb, jcb):
    """>= 99% of the codebook entries within 1e-4; the rest (assignment
    flips at exact near-ties) are counted."""
    ok = (np.abs(tcb - jcb) <= 1e-4 + 1e-4 * np.abs(jcb)).all(axis=-1)
    print(f"codebook entries that differ: {int((~ok).sum())} of {ok.size}")
    assert ok.mean() >= 0.99, ok.mean()


@pytest.mark.parametrize("m_pq,nv", [(8, 256), (16, 16), (4, 16)])
def test_train_pq_and_encode_match_jax(m_pq, nv):
    x = _points(m_pq)
    jcb = np.asarray(jpq.train_pq(jnp.asarray(x), m_pq, iters=6, seed=0, nv=nv))
    tcb = tpq.train_pq(torch.from_numpy(x), m_pq, iters=6, seed=0, nv=nv)
    assert tcb.shape == (m_pq, nv, x.shape[1] // m_pq)
    _codebooks_close(tcb.numpy(), jcb)
    jc = np.asarray(jpq.encode_pq(jnp.asarray(x), jnp.asarray(jcb)))
    tc = tpq.encode_pq(torch.from_numpy(x), tcb)
    assert tc.dtype == torch.uint8 and np.mean(tc.numpy() == jc) >= 0.99
    # equal codebooks give equal codes, and decoding is exact
    te = tpq.encode_pq(torch.from_numpy(x), torch.from_numpy(jcb.copy()))
    assert np.mean(te.numpy() == jc) >= 0.999
    np.testing.assert_array_equal(
        tpq.pq_decode(torch.from_numpy(jc), torch.from_numpy(jcb)).numpy(),
        np.asarray(jpq.pq_decode(jnp.asarray(jc), jnp.asarray(jcb))))


def test_train_pq_is_deterministic_and_checks_shapes():
    x = torch.from_numpy(_points(3, n=100, d=16))
    a = tpq.train_pq(x, 4, iters=4, nv=256)  # fewer rows than entries
    assert torch.equal(a, tpq.train_pq(x, 4, iters=4, nv=256))
    _codebooks_close(a.numpy(), np.asarray(
        jpq.train_pq(jnp.asarray(x.numpy()), 4, iters=4, nv=256)))
    with pytest.raises(ValueError, match="must divide"):
        tpq.train_pq(x, 5)
    with pytest.raises(ValueError, match="must divide"):
        tpq.opq_train(x, 5)


def test_nibbles_match_jax():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 16, (7, 5, 12)).astype(np.uint8)
    tp = tpq.pack_nibbles(torch.from_numpy(c))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jpq.pack_nibbles(jnp.asarray(c))))
    np.testing.assert_array_equal(tpq.unpack_nibbles(tp).numpy(), c)


@pytest.mark.parametrize("nv", [256, 16])
def test_lut_and_adc_scores_match_jax(nv):
    rng = np.random.default_rng(nv)
    m, ds, b, c = 8, 4, 12, 40
    cb = rng.normal(0, 1, (m, nv, ds)).astype(np.float32)
    q = rng.normal(0, 1, (b, m * ds)).astype(np.float32)
    jl = np.asarray(jpq.pq_lut(jnp.asarray(q), jnp.asarray(cb)))
    tl = tpq.pq_lut(torch.from_numpy(q), torch.from_numpy(cb))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=1e-5 * np.abs(jl).max())
    codes = rng.integers(0, nv, (b, c, m)).astype(np.uint8)
    if nv == 16:
        packed = np.asarray(jpq.pack_nibbles(jnp.asarray(codes)))
        js = np.asarray(jpq.adc_score16(jnp.asarray(jl), jnp.asarray(packed)))
        ts = tpq.adc_score16(torch.from_numpy(jl), torch.from_numpy(packed))
    else:
        js = np.asarray(jpq.adc_score(jnp.asarray(jl), jnp.asarray(codes)))
        ts = tpq.adc_score(torch.from_numpy(jl), torch.from_numpy(codes))
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5 * np.abs(js).max())
    assert bool((ts >= 0).all())


def _distortion(x, rot, cb, mod, asarray):
    xr = asarray(x @ rot)
    n, d = x.shape
    m = cb.shape[0]
    codes = mod.pq_encode(xr.reshape(n, m, d // m), asarray(cb))
    xhat = np.asarray(mod.pq_decode(codes, asarray(cb)))
    return float(((np.asarray(xr) - xhat) ** 2).sum(1).mean())


def test_opq_is_orthogonal_and_matches_jax_distortion():
    x = _points(5, n=1200, d=16)
    jrot, jcb = jpq.opq_train(jnp.asarray(x), 4, pq_iters=4, opq_iters=3, nv=16)
    trot, tcb = tpq.opq_train(torch.from_numpy(x), 4, pq_iters=4, opq_iters=3, nv=16)
    rtr = trot.T @ trot
    assert float((rtr - torch.eye(16)).abs().max()) <= 1e-4
    dj = _distortion(x, np.asarray(jrot), np.asarray(jcb), jpq, jnp.asarray)
    dt = _distortion(x, trot.numpy(), tcb.numpy(), tpq, torch.from_numpy)
    assert abs(dt - dj) <= 0.02 * dj, (dt, dj)
    # the rotation pays: lower distortion than plain PQ on the same rows
    plain = tpq.train_pq(torch.from_numpy(x), 4, iters=4, nv=16)
    assert dt <= _distortion(x, np.eye(16, dtype=np.float32), plain.numpy(),
                             tpq, torch.from_numpy) * 1.02
    # a subsample is strided, as in the JAX package
    r2, _ = tpq.opq_train(torch.from_numpy(x), 4, pq_iters=2, opq_iters=1,
                          train_n=300, nv=16)
    j2, _ = jpq.opq_train(jnp.asarray(x), 4, pq_iters=2, opq_iters=1,
                          train_n=300, nv=16)
    assert float((r2.T @ r2 - torch.eye(16)).abs().max()) <= 1e-4
    assert np.asarray(j2).shape == tuple(r2.shape)


def _pq_graph(seed, bits, n=1200, d=32, cap=16, m_sub=8):
    rng = np.random.default_rng(seed)
    x = _points(seed, n, d)
    codes, scales = quantize_np(x)
    xd = codes.astype(np.float32) * scales[:, 1:2] + scales[:, 0:1]
    d2 = ((xd[:, None] - xd[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    adj = np.argsort(d2, axis=1, kind="stable")[:, :cap].astype(np.int32)
    adj[rng.random((n, cap)) < 0.15] = -1
    nv = 1 << bits
    cb = np.asarray(jpq.train_pq(jnp.asarray(xd), m_sub, iters=5, seed=0, nv=nv))
    pqc = np.asarray(jpq.encode_pq(jnp.asarray(xd), jnp.asarray(cb)))
    if bits == 4:
        pqc = np.asarray(jpq.pack_nibbles(jnp.asarray(pqc)))
    piv = rng.choice(n, 96, replace=False).astype(np.int32)
    pv = xd[piv]
    qc, qs = quantize_np(x[rng.integers(0, n, 48)]
                         + rng.normal(0, 0.02, (48, d)).astype(np.float32))
    q = qc.astype(np.float32) * qs[:, 1:2] + qs[:, 0:1]
    return codes, scales, adj, cb, pqc, piv, pv, q


@pytest.mark.parametrize("bits,expand_e,opq", [(8, 1, False), (4, 1, False),
                                                (8, 2, False), (4, 4, True)])
def test_ann_search_pq_matches_jax(bits, expand_e, opq):
    codes, scales, adj, cb, pqc, piv, pv, q = _pq_graph(bits + expand_e, bits)
    rot = None
    if opq:  # any orthogonal matrix: both sides get the same one
        rot = np.linalg.qr(np.random.default_rng(1).normal(
            size=(32, 32)))[0].astype(np.float32)
    jpk = jsearch.pack_layer_pq(jnp.asarray(adj), jnp.asarray(pqc))
    tpk = tsearch.pack_layer_pq(torch.from_numpy(adj), torch.from_numpy(pqc))
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    nbrs, got = tsearch.unpack_rows_pq(tpk[::5], adj.shape[1], pqc.shape[1])
    np.testing.assert_array_equal(nbrs.numpy(), adj[::5])
    np.testing.assert_array_equal(got.numpy(), pqc[np.where(adj[::5] >= 0, adj[::5], 0)])
    ef, k, mi, rr = 24, 10, 40, 24
    jd, ji = jsearch.ann_search_pq(
        jpk, jnp.asarray(cb), jnp.asarray(pqc), jnp.asarray(piv), jnp.asarray(pv),
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(q), ef, k, mi, rr,
        expand_e, None if rot is None else jnp.asarray(rot))
    t = torch.from_numpy
    td, ti = tsearch.ann_search_pq(
        tpk, t(cb), t(pqc), t(piv), t(pv), t(codes), t(scales), t(q), ef, k, mi,
        rr, expand_e, None if rot is None else t(rot))
    ji, jd = np.asarray(ji), np.asarray(jd)
    # ADC scores sum their m terms in different orders on the two sides, so
    # a near-tie inside a beam may swap: such rows are counted and bounded
    bad = np.flatnonzero((ti.numpy() != ji).any(axis=1))
    print(f"ann_search_pq rows that differ (ADC near-ties): {bad.size} of {len(q)}")
    # with a rotation the two sides' q @ R differ in the last ulp, which
    # moves every table entry: more near-ties swap, one id a row
    assert bad.size <= (8 if opq else 2)
    for r in bad:
        assert len(set(ti.numpy()[r]) & set(ji[r])) >= k - 2
    same = ti.numpy() == ji
    np.testing.assert_allclose(td.numpy()[same], jd[same], rtol=1e-5, atol=1e-6)
