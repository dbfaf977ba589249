"""Tests of the port that need an NVIDIA GPU: the sm_90a group-min (K2)
and all-pairs L2 (K1) kernels against their plain versions, and the
port's device paths (cluster and wave builds, serving, inserts) against
its own CPU paths. Every test is marked ``cuda`` and skips without a
card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernels take q.c exactly on the int8 tensor cores (query
limbs, ``ops/limbs.py``) and cuBLAS takes it in float32, so the two differ
by a few float32 ulps of the |q|^2 + |x|^2 that the affine form cancels.
K2's d2 is held within 1e-5 * d2 + 2e-6 * (|q|^2 + |x|^2) of the plain
version's; its group rows must be equal except where the plain d2 of both
rows lies within that tolerance (a tie; such ties are counted and
printed). ``flat_topk_fused`` ids must equal the plain route's. K1 within
2e-6 of |q|^2 + |x|^2. The cases span both layouts of the shared core:
resident query limbs up to d = 256, streamed chunks past it (d = 300,
520, 700, 768: two and three chunks). Graphs built on the card and on the CPU are held to
recall@10 within 0.01 of each other.
"""

import numpy as np
import pytest
import torch

from hnsw_rs_tpu_torch import HNSW
from hnsw_rs_tpu_torch.ops import groupmin, l2_kernel
from hnsw_rs_tpu_torch.ops.distance import point_normsq
from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize
from hnsw_rs_tpu_torch.utils.datasets import synthetic_clustered
from hnsw_rs_tpu_torch.utils.glove import brute_force_nns

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _collection(dev, n, d, b, seed):
    rng = np.random.default_rng(seed)
    cent = rng.random((64, d), np.float32)
    x = cent[rng.integers(0, 64, n)] + rng.normal(0, 0.05, (n, d)).astype(np.float32)
    qx = cent[rng.integers(0, 64, b)] + rng.normal(0, 0.05, (b, d)).astype(np.float32)
    codes, scales = quantize(torch.from_numpy(x).to(dev))
    q = dequantize(*quantize(torch.from_numpy(qx).to(dev)))
    return q, codes, scales, point_normsq(codes, scales)


def check_group_min(q, codes, scales, normsq, kd, ki, pd, pi):
    """Holds K2's (kd, ki) to the plain version's (pd, pi) as the module
    docstring says; returns the number of rows that differ (ties)."""
    mag = (q * q).sum(dim=1, keepdim=True) + normsq[ki.long()]
    tol = 1e-5 * pd.abs() + 2e-6 * mag
    assert bool(((kd - pd).abs() <= tol).all())
    diff = ki != pi
    bs = diff.nonzero()[:, 0]

    def plain_d2(rows):
        r = rows.long()
        dot = (q[bs] * codes[r].float()).sum(dim=1)
        qdotx = scales[r, 1] * dot + scales[r, 0] * q[bs].sum(dim=1)
        return torch.clamp_min((q[bs] * q[bs]).sum(dim=1) + normsq[r] - 2.0 * qdotx, 0.0)

    assert bool(((plain_d2(ki[diff]) - plain_d2(pi[diff])).abs() <= tol[diff]).all())
    return int(diff.sum())


@pytest.mark.parametrize("n,d,b", [(50_000, 96, 300), (20_000, 24, 64),
                                   (9_000, 100, 1), (30_000, 200, 129),
                                   (12_000, 7, 1), (40_000, 50, 129),
                                   (25_000, 7, 129), (15_000, 50, 1),
                                   (20_000, 300, 129), (8_000, 768, 64),
                                   (5_000, 520, 1)])
def test_group_min_kernel_matches_plain(dev, n, d, b):
    q, codes, scales, normsq = _collection(dev, n, d, b, seed=d)
    pc, ps, pn = groupmin.pad_to_groups(codes, scales, normsq)
    before = groupmin.group_min_d2.launches
    kd, ki = groupmin.group_min_d2(q, pc, ps, pn)
    pd, pi = groupmin.group_min_d2_plain(q, pc, ps, pn)
    torch.cuda.synchronize()
    assert groupmin.group_min_d2.launches == before + 1
    assert kd.shape == (b, pc.shape[0] // 128) and ki.dtype == torch.int32
    ties = check_group_min(q, pc, ps, pn, kd, ki, pd, pi)
    print(f"group rows that differ from the plain version (ties): {ties}")


def test_flat_topk_fused_matches_plain_route(dev):
    q, codes, scales, normsq = _collection(dev, 70_001, 96, 200, seed=1)
    fd, fi = groupmin.flat_topk_fused(q, codes, scales, normsq, 10)
    pc, ps, pn = groupmin.pad_to_groups(codes, scales, normsq)
    gd, gi = groupmin.group_min_d2_plain(q, pc, ps, pn)
    rd, ri = groupmin.rescore_groups(q, pc, ps, pn, gd, gi, 10, codes.shape[0])
    assert torch.equal(fi, ri)
    assert int(fi.max()) < codes.shape[0]
    torch.testing.assert_close(fd, rd, rtol=1e-5, atol=0.0)


def test_group_min_rejects_mixed_devices(dev):
    q, codes, scales, normsq = _collection(dev, 1024, 16, 4, seed=2)
    with pytest.raises(ValueError, match="is on"):
        groupmin.group_min_d2(q, codes.cpu(), scales, normsq)


def test_quantize_on_card_equals_cpu(dev):
    x = np.random.default_rng(3).normal(0, 5, (20_000, 96)).astype(np.float32)
    c_cpu, s_cpu = quantize(torch.from_numpy(x))
    c_gpu, s_gpu = quantize(torch.from_numpy(x).to(dev))
    assert torch.equal(c_cpu, c_gpu.cpu()) and torch.equal(s_cpu, s_gpu.cpu())


def test_port_serves_the_same_on_card_as_on_cpu(dev):
    """A CPU-built index moved to the card through ``from_numpy`` with the
    same pivots serves the same ids (>= 99% of entries: the card's
    products may swap near-ties)."""
    ds = synthetic_clustered(4000, 32, n_queries=128, seed=11)
    cpu = HNSW(12, ef_cons=48, dim=32, device="cpu")
    cpu.insert_bulk(ds.train, cluster_build=True,
                    cluster_kwargs={"select_alg4": False})
    cpu.finalize(pivots=256)
    meta, arrays = cpu.to_numpy()
    card = HNSW.from_numpy(meta, arrays, dev,
                           pivot_ids=cpu._pivots[0].numpy())
    _, ci = cpu.ann_batch(ds.test, 10, 48)
    _, gi = card.ann_batch(ds.test, 10, 48)
    assert np.mean(ci == gi) >= 0.99
    built = HNSW(12, ef_cons=48, dim=32, device=dev)
    built.insert_bulk(ds.train, cluster_build=True,
                      cluster_kwargs={"select_alg4": False})
    built.finalize(pivots=256)
    _, bi = built.ann_batch(ds.test, 10, 48)
    recall = np.mean([len(set(a) & set(t)) / 10 for a, t in zip(bi, ci)])
    assert recall >= 0.95


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("n,d,b", [(300, 50, 70), (70_001, 96, 1030),
                                   (1, 7, 1), (5_000, 200, 129),
                                   (3_000, 150, 65), (3_000, 180, 64),
                                   (2_000, 256, 33), (4_000, 300, 70),
                                   (2_000, 768, 129), (1_000, 700, 1)])
def test_l2_kernel_matches_plain(dev, n, d, b, fast):
    q, codes, scales, normsq = _collection(dev, n, d, b, seed=n + d)
    before = l2_kernel.pairwise_l2sq_kernel.launches
    k = l2_kernel.pairwise_l2sq_kernel(q, codes, scales, normsq, fast)
    p = l2_kernel.pairwise_l2sq_plain(q, codes, scales, normsq, fast)
    torch.cuda.synchronize()
    assert l2_kernel.pairwise_l2sq_kernel.launches == before + 1
    assert k.shape == (b, n) and k.dtype == torch.float32
    mag = (q * q).sum(dim=1, keepdim=True) + normsq[None, :]
    assert bool(((k - p).abs() <= 2e-6 * mag).all())
    assert bool((k >= 0).all())


def test_l2_kernel_rejects_mixed_devices_and_dtypes(dev):
    q, codes, scales, normsq = _collection(dev, 1024, 16, 4, seed=2)
    with pytest.raises(ValueError, match="is on"):
        l2_kernel.pairwise_l2sq_kernel(q, codes.cpu(), scales, normsq)
    with pytest.raises(ValueError, match="is on"):
        l2_kernel.pairwise_l2sq_kernel(q.cpu(), codes, scales, normsq)
    with pytest.raises(TypeError, match="q must be"):
        l2_kernel.pairwise_l2sq_kernel(q.half(), codes, scales, normsq)
    with pytest.raises(TypeError, match="codes must be"):
        l2_kernel.pairwise_l2sq_kernel(q, codes.float(), scales, normsq)
    with pytest.raises(ValueError, match="contiguous"):
        l2_kernel.pairwise_l2sq_kernel(q.T.contiguous().T, codes, scales, normsq)
    wide = torch.zeros((2, 800), device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        l2_kernel.pairwise_l2sq_kernel(
            wide, torch.zeros((3, 800), dtype=torch.uint8, device=dev),
            scales[:3].contiguous(), normsq[:3].contiguous())


def test_wave_build_on_card_matches_cpu(dev):
    """A 20k-point wave build (packed) on the card and the same build on
    the CPU clear the same recall; inserts on the card serve through the
    plain hierarchical branch."""
    ds = synthetic_clustered(20_000, 32, n_queries=256, seed=5)
    built = {}
    for where in ("cpu", dev):
        idx = HNSW(12, ef_cons=48, dim=32, device=where)
        idx.insert_bulk(ds.train)
        assert idx.serving_route() == "packed"
        built[str(where)] = idx
    card, cpu = built[str(dev)], built["cpu"]
    truth = brute_force_nns(ds.test, cpu.points.codes, cpu.points.scales, 10)
    rec = {}
    for name, idx in built.items():
        _, ids = idx.ann_batch(ds.test, 10, 64)
        rec[name] = np.mean([len(set(a) & set(t)) / 10 for a, t in zip(ids, truth)])
    assert rec[str(dev)] >= 0.95 and abs(rec[str(dev)] - rec["cpu"]) <= 0.01, rec
    assert card.assert_param_compliance(verbose=False)
    same = (card.graph.get_layer(0).cpu() == cpu.graph.get_layer(0)).all(1)
    print(f"share of identical layer-0 rows, card vs cpu: {float(same.float().mean()):.4f}")
    for x in ds.test[:64]:
        card.insert_vec(x)
    assert card.serving_route() == "plain"
    _, ids = card.ann_batch(ds.test[:64], 10, 64)
    assert np.mean([20_000 + i in row for i, row in enumerate(ids)]) >= 0.95
