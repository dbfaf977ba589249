"""Parity of the port's layer-0 serving path (``hnsw_rs_tpu_torch.search``)
with the JAX package on the CPU.

Tolerances: packed bytes, neighbor ids and beam ids must be equal; beam
d2 is held to rtol 1e-6 (both sides compute the same diff-square sums, in
orders that can differ by an ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_rs_tpu import search as jsearch
from hnsw_rs_tpu.ops.quant import dequantize as j_dequantize
from hnsw_rs_tpu.ops.quant import quantize_np
from hnsw_rs_tpu.ops.topk import PAD_ID
from hnsw_rs_tpu_torch import search as tsearch


def _graph(seed, n=900, d=20, cap=16):
    """Clustered points, a kNN-ish random graph with ragged rows, and
    dequantized queries."""
    rng = np.random.default_rng(seed)
    cent = rng.random((30, d), np.float32)
    x = (cent[rng.integers(0, 30, n)]
         + rng.normal(0, 0.05, (n, d))).astype(np.float32)
    codes, scales = quantize_np(x)
    xd = codes.astype(np.float32) * scales[:, 1:2] + scales[:, 0:1]
    d2 = ((xd[:, None] - xd[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    near = np.argsort(d2, axis=1, kind="stable")[:, : cap // 2]
    far = rng.integers(0, n, (n, cap // 2))
    adj = np.concatenate([near, far], 1).astype(np.int32)
    adj[adj == np.arange(n)[:, None]] = -1
    adj[rng.random((n, cap)) < 0.2] = -1
    qc, qs = quantize_np(cent[rng.integers(0, 30, 40)]
                         + rng.normal(0, 0.05, (40, d)).astype(np.float32))
    q = (qc.astype(np.float32) * qs[:, 1:2] + qs[:, 0:1]).astype(np.float32)
    return codes, scales, adj, q


def test_pack_layer_bytes_equal_and_round_trip():
    codes, scales, adj, _ = _graph(0)
    jp = np.asarray(jsearch.pack_layer(jnp.asarray(adj), jnp.asarray(codes),
                                       jnp.asarray(scales)))
    tp = tsearch.pack_layer(torch.from_numpy(adj), torch.from_numpy(codes),
                            torch.from_numpy(scales))
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(tp.numpy(), jp)
    cap, d = adj.shape[1], codes.shape[1]
    nbrs, vecs = tsearch.unpack_rows(tp[::7], cap, d)
    np.testing.assert_array_equal(nbrs.numpy(), adj[::7])
    safe = np.where(adj[::7] >= 0, adj[::7], 0)
    want = codes[safe].astype(np.float32) * scales[safe][..., 1:2] + scales[safe][..., 0:1]
    np.testing.assert_array_equal(vecs.numpy(), want)


def _entries(q, codes, scales, k, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, codes.shape[0], (q.shape[0], k)).astype(np.int32)
    ids[:, 0] = ids[:, 1]  # a duplicate entry id
    x = np.asarray(j_dequantize(jnp.asarray(codes[ids]), jnp.asarray(scales[ids])))
    d2 = ((x - q[:, None]) ** 2).sum(-1).astype(np.float32)
    ids[3, 2:] = PAD_ID  # a query with mostly invalid entries
    d2[3, 2:] = np.inf
    return d2, ids


@pytest.mark.parametrize("ef,max_iters,k0", [(24, 40, 5), (16, 6, 3), (48, 200, 64)])
def test_search_layer_packed_matches_jax(ef, max_iters, k0):
    codes, scales, adj, q = _graph(1)
    e_d2, e_ids = _entries(q, codes, scales, k0, seed=ef)
    jp = jsearch.pack_layer(jnp.asarray(adj), jnp.asarray(codes), jnp.asarray(scales))
    jd, ji = jsearch.search_layer_packed(jp, jnp.asarray(q), jnp.asarray(e_d2),
                                         jnp.asarray(e_ids), ef, max_iters)
    tp = tsearch.pack_layer(torch.from_numpy(adj), torch.from_numpy(codes),
                            torch.from_numpy(scales))
    td, ti = tsearch.search_layer_packed(tp, torch.from_numpy(q),
                                         torch.from_numpy(e_d2),
                                         torch.from_numpy(e_ids), ef, max_iters)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    # the plain-gather layout runs the same beam
    pd, pi = tsearch.search_layer(torch.from_numpy(adj), torch.from_numpy(codes),
                                  torch.from_numpy(scales), torch.from_numpy(q),
                                  torch.from_numpy(e_d2), torch.from_numpy(e_ids),
                                  ef, max_iters)
    np.testing.assert_array_equal(pi.numpy(), ti.numpy())


def test_pack_exp_id_round_trip():
    ids = torch.tensor([[0, 5, PAD_ID, 2**30 - 2]], dtype=torch.int32)
    exp = torch.tensor([[True, False, False, True]])
    got_ids, got_exp = tsearch._unpack_exp_id(tsearch._pack_exp_id(ids, exp))
    assert torch.equal(got_ids, ids)
    assert got_exp.tolist() == [[True, False, True, True]]  # PAD decodes expanded
    want = jsearch._pack_exp_id(jnp.asarray(ids.numpy()), jnp.asarray(exp.numpy()))
    np.testing.assert_array_equal(tsearch._pack_exp_id(ids, exp).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("ef", [8, 30])
def test_seeded_serving_matches_jax(ef):
    codes, scales, adj, q = _graph(2)
    rng = np.random.default_rng(ef)
    piv = rng.choice(codes.shape[0], 64, replace=False).astype(np.int32)
    piv[5] = -1  # an invalid pivot slot is never a seed
    pv = (codes[piv].astype(np.float32) * scales[piv, 1:2] + scales[piv, 0:1])
    jargs = [jnp.asarray(a) for a in (piv, pv, q)]
    targs = [torch.from_numpy(a) for a in (piv, pv, q)]
    jd2, jids, jpos = jsearch._pivot_seeds_pos(*jargs, ef)
    td2, tids, tpos = tsearch._pivot_seeds_pos(*targs, ef)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    # the expanded form |q|^2 - 2 q.p + |p|^2 cancels terms of ~10 here, so
    # its error is absolute: a few ulps of 10
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-5)

    jp = jsearch.pack_layer(jnp.asarray(adj), jnp.asarray(codes), jnp.asarray(scales))
    tp = tsearch.pack_layer(torch.from_numpy(adj), torch.from_numpy(codes),
                            torch.from_numpy(scales))
    jd, ji = jsearch.ann_search_seeded(jp, *jargs, ef, 10, 2 * ef + 16)
    td, ti = tsearch.ann_search_seeded(tp, *targs, ef, 10, 2 * ef + 16)
    # seed lanes carry matmul-form distances (absolute error as above):
    # ids exactly, distances to the same absolute bound
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    pd, pi = tsearch.ann_search_seeded_plain(
        torch.from_numpy(adj), torch.from_numpy(codes), torch.from_numpy(scales),
        *targs, ef, 10, 2 * ef + 16)
    np.testing.assert_array_equal(pi.numpy(), ti.numpy())


@pytest.mark.parametrize("expand_e", [2, 4])
@pytest.mark.parametrize("ef,max_iters,k0", [(24, 40, 5), (16, 3, 3), (48, 200, 64)])
def test_expand_e_beams_match_jax(expand_e, ef, max_iters, k0):
    """E > 1 pops: every id of the beam equals the JAX package's, over the
    packed and the plain layout; E=1 stays what it was (the tests above)."""
    codes, scales, adj, q = _graph(3)
    e_d2, e_ids = _entries(q, codes, scales, k0, seed=ef + expand_e)
    jp = jsearch.pack_layer(jnp.asarray(adj), jnp.asarray(codes), jnp.asarray(scales))
    jd, ji = jsearch.search_layer_packed(
        jp, jnp.asarray(q), jnp.asarray(e_d2), jnp.asarray(e_ids), ef, max_iters,
        expand_e=expand_e)
    tp = tsearch.pack_layer(torch.from_numpy(adj), torch.from_numpy(codes),
                            torch.from_numpy(scales))
    targs = [torch.from_numpy(a) for a in (q, e_d2, e_ids)]
    td, ti = tsearch.search_layer_packed(tp, *targs, ef, max_iters,
                                         expand_e=expand_e)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    jd2, ji2 = jsearch.search_layer(
        jnp.asarray(adj), jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(q),
        jnp.asarray(e_d2), jnp.asarray(e_ids), ef, max_iters, expand_e=expand_e)
    pd, pi = tsearch.search_layer(torch.from_numpy(adj), torch.from_numpy(codes),
                                  torch.from_numpy(scales), *targs, ef, max_iters,
                                  expand_e=expand_e)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji2))
    # the E rows' shared neighbors are deduplicated: beyond the duplicate
    # that _entries plants among the entry ids, no id appears twice
    for row in ti.numpy():
        real = row[row != PAD_ID]
        assert real.size - len(set(real.tolist())) <= 1


@pytest.mark.parametrize("expand_e", [1, 2, 4])
def test_expand_e_with_forbid_and_ring_matches_jax(expand_e):
    codes, scales, adj, q = _graph(4)
    e_d2, e_ids = _entries(q, codes, scales, 4, seed=expand_e)
    forbid = np.asarray(adj[:40, 0].clip(0), np.int32)
    jp = jsearch.pack_layer(jnp.asarray(adj), jnp.asarray(codes), jnp.asarray(scales))
    tp = torch.from_numpy(np.array(jp))
    jd, ji = jsearch.search_layer_packed(
        jp, jnp.asarray(q), jnp.asarray(e_d2), jnp.asarray(e_ids), 20, 30,
        ring_size=100, expand_e=expand_e, forbid=jnp.asarray(forbid))
    td, ti = tsearch.search_layer_packed(
        tp, torch.from_numpy(q), torch.from_numpy(e_d2), torch.from_numpy(e_ids),
        20, 30, ring_size=100, expand_e=expand_e, forbid=torch.from_numpy(forbid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert not (ti.numpy() == forbid[:, None]).any()


@pytest.mark.parametrize("expand_e", [2, 4])
def test_seeded_and_hierarchical_serving_with_expand_match_jax(expand_e):
    codes, scales, adj, q = _graph(5)
    rng = np.random.default_rng(expand_e)
    piv = rng.choice(codes.shape[0], 64, replace=False).astype(np.int32)
    pv = (codes[piv].astype(np.float32) * scales[piv, 1:2] + scales[piv, 0:1])
    jargs = [jnp.asarray(a) for a in (piv, pv, q)]
    targs = [torch.from_numpy(a) for a in (piv, pv, q)]
    jp = jsearch.pack_layer(jnp.asarray(adj), jnp.asarray(codes), jnp.asarray(scales))
    tp = torch.from_numpy(np.array(jp))
    ef = 16
    _, ji = jsearch.ann_search_seeded(jp, *jargs, ef, 10, 48, expand_e)
    _, ti = tsearch.ann_search_seeded(tp, *targs, ef, 10, 48, expand_e)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _, ji = jsearch.ann_search_seeded_plain(
        jnp.asarray(adj), jnp.asarray(codes), jnp.asarray(scales), *jargs, ef, 10,
        48, expand_e)
    _, pi = tsearch.ann_search_seeded_plain(
        torch.from_numpy(adj), torch.from_numpy(codes), torch.from_numpy(scales),
        *targs, ef, 10, 48, expand_e)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    upper = adj[:, :8].copy()  # a second layer over the same ids
    _, ji = jsearch.ann_search_packed(
        (jnp.asarray(upper),), jp, jnp.asarray(codes), jnp.asarray(scales),
        jnp.asarray(q), jnp.int32(3), ef, 10, 48, expand_e)
    _, hi = tsearch.ann_search_packed(
        [torch.from_numpy(upper)], tp, torch.from_numpy(codes),
        torch.from_numpy(scales), torch.from_numpy(q), 3, ef, 10, 48, expand_e)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(ji))
