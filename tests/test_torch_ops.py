"""Parity of the PyTorch port's ops (``hnsw_rs_tpu_torch.ops``) with the
JAX package on the CPU: the same numpy inputs go through both.

Tolerances: quantization codes, scales and every (dist, id) ordering
primitive must be bit-equal (IEEE f32 elementwise ops, integer ids);
distance reductions are held to rtol 1e-5 because PyTorch and XLA sum
the d products in different orders.
"""

import ast
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_rs_tpu.ops import distance as jdist
from hnsw_rs_tpu.ops import quant as jquant
from hnsw_rs_tpu.ops import topk as jtopk
from hnsw_rs_tpu_torch.ops import distance as tdist
from hnsw_rs_tpu_torch.ops import quant as tquant
from hnsw_rs_tpu_torch.ops import topk as ttopk

PKG = pathlib.Path(__file__).resolve().parents[1] / "hnsw_rs_tpu_torch"

# Under pytest-xdist every worker imports every test file while it
# collects, so this sets torch's intra-op threads for each whole worker:
# n workers that each run one thread per core oversubscribe the host, and
# torch's threads then wait on one another (the port's test files under
# six workers on an 8-core host: 688-822 s with one thread per core in
# each worker, 145-162 s with this).
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def _vectors(seed, n=3000, d=96):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, d), np.float32) * rng.uniform(0.1, 50.0, (n, 1))
         + rng.normal(0, 3.0, (n, 1))).astype(np.float32)
    x[5] = 1.25  # constant row: delta == 0
    x[6, :] = -0.0
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_bit_equal_to_jax_and_numpy(seed):
    x = _vectors(seed)
    tc, ts = tquant.quantize(torch.from_numpy(x))
    jc, js = jquant.quantize(jnp.asarray(x))
    nc, ns = jquant.quantize_np(x)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), nc)
    np.testing.assert_array_equal(ts.numpy(), ns)
    assert tc.dtype == torch.uint8 and ts.dtype == torch.float32


def test_dequantize_matches_jax():
    x = _vectors(2)
    c, s = jquant.quantize_np(x)
    got = tquant.dequantize(torch.from_numpy(c), torch.from_numpy(s)).numpy()
    want = np.asarray(jquant.dequantize(jnp.asarray(c), jnp.asarray(s)))
    # one rounding of codes*delta + min: at most one ulp apart if XLA fuses
    # the multiply-add
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _quantized(seed, n, d, b):
    rng = np.random.default_rng(seed)
    c, s = jquant.quantize_np(rng.random((n, d), np.float32))
    qc, qs = jquant.quantize_np(rng.random((b, d), np.float32))
    q = (qc.astype(np.float32) * qs[:, 1:2] + qs[:, 0:1]).astype(np.float32)
    return c, s, q


def test_distances_match_jax():
    c, s, q = _quantized(3, 700, 40, 33)
    tc, ts, tq = torch.from_numpy(c), torch.from_numpy(s), torch.from_numpy(q)
    jc, js, jq = jnp.asarray(c), jnp.asarray(s), jnp.asarray(q)
    nsq_t = tdist.point_normsq(tc, ts)
    nsq_j = jdist.point_normsq(jc, js)
    np.testing.assert_allclose(nsq_t.numpy(), np.asarray(nsq_j), rtol=1e-5)
    np.testing.assert_allclose(
        tdist.pairwise_l2sq_mxu(tq, tc, ts, nsq_t).numpy(),
        np.asarray(jdist.pairwise_l2sq_mxu(jq, jc, js, nsq_j)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tdist.pairwise_l2sq_exact(tq, tc, ts).numpy(),
        np.asarray(jdist.pairwise_l2sq_exact(jq, jc, js)), rtol=1e-5)
    np.testing.assert_allclose(
        tdist.l2sq(tq[:, None], tq[None]).numpy(),
        np.asarray(jdist.l2sq(jq[:, None], jq[None])), rtol=1e-5, atol=1e-6)


def _dist_id_rows(seed, b=17, w=53):
    """Rows with repeated distances (id tie-breaks) and (inf, PAD) pads."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 12, (b, w)).astype(np.float32) / 4.0
    ids = np.stack([rng.permutation(10_000)[:w] for _ in range(b)]).astype(np.int32)
    pad = rng.random((b, w)) < 0.15
    d[pad] = np.inf
    ids[pad] = jtopk.PAD_ID
    return d, ids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_dist_id_equal(seed):
    d, ids = _dist_id_rows(seed)
    extra = np.arange(d.size, dtype=np.int32).reshape(d.shape)
    got = ttopk.sort_dist_id(torch.from_numpy(d), torch.from_numpy(ids),
                             torch.from_numpy(extra))
    want = jtopk.sort_dist_id(jnp.asarray(d), jnp.asarray(ids), jnp.asarray(extra))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gd, gi = ttopk.topk_dist_id(torch.from_numpy(d), torch.from_numpy(ids), 7)
    wd, wi = jtopk.topk_dist_id(jnp.asarray(d), jnp.asarray(ids), 7)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("la,lb", [(16, 48), (24, 24), (5, 11)])
def test_merge_sorted_dist_id_equal(la, lb):
    rng = np.random.default_rng(la * 100 + lb)
    ids = np.stack([rng.permutation(50_000)[: la + lb] for _ in range(9)]).astype(np.int32)
    d = rng.integers(0, 30, ids.shape).astype(np.float32)
    pad = rng.random(ids.shape) < 0.2
    d[pad], ids[pad] = np.inf, jtopk.PAD_ID
    runs = []
    for sl in (slice(0, la), slice(la, la + lb)):
        sd, si = jtopk.sort_dist_id(jnp.asarray(d[:, sl]), jnp.asarray(ids[:, sl]))
        runs += [np.array(sd), np.array(si)]
    want = jtopk.merge_sorted_dist_id(*(jnp.asarray(r) for r in runs))
    got = ttopk.merge_sorted_dist_id(*(torch.from_numpy(r) for r in runs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dedup_ids_equal():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 20, (11, 40)).astype(np.int32)
    d = (ids * 0.5 + 1.0).astype(np.float32)  # one distance per id, as in a beam
    got = ttopk.dedup_ids(torch.from_numpy(d), torch.from_numpy(ids))
    want = jtopk.dedup_ids(jnp.asarray(d), jnp.asarray(ids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_topk_lowest_breaks_ties_by_position():
    x = torch.tensor([[3.0, 1.0, 2.0, 1.0, 0.5, 1.0]])
    v, p = ttopk.topk_lowest(x, 4)
    assert v.tolist() == [[0.5, 1.0, 1.0, 1.0]]
    assert p.tolist() == [[4, 1, 3, 5]]


def test_port_imports_no_jax():
    """The port must run where JAX is not installed: no module of the
    package, and not chip_smoke.py, imports jax, jaxlib or the JAX
    package."""
    banned = ("jax", "jaxlib", "hnsw_rs_tpu")
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert len(files) >= 15
    assert {PKG / "parallel" / f"{m}.py" for m in (
        "mesh", "replicated", "sharded", "sharded_cluster", "multihost")} <= set(files)
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{f}: imports {name}"
