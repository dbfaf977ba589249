"""Tests of the port that need an NVIDIA GPU: the sm_90a group-min (K2)
and all-pairs L2 (K1) kernels against their plain versions, and the
port's device paths (cluster and wave builds, serving, inserts, the IVF
families, the flat forms, the paged tiers and the sharded layer) against
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

from hnsw_rs_tpu_torch import FlatIndex, HNSW, IVFFlatIndex
from hnsw_rs_tpu_torch.models.ivfpq import IVFPQIndex
from hnsw_rs_tpu_torch.ops import groupmin, l2_kernel, limbs
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


def _limb_rows(b, d, seed):
    """Float32 queries [b, d] with the split's corner cases in the first
    rows: all zero, a maximum that is an exact power of two, a row below
    2^-96, and halves after scaling (ties of the rounding, both signs)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 3, (b, d)).astype(np.float32)
    q[0] = 0.0
    if b > 1:
        q[1] = rng.uniform(-1, 1, d).astype(np.float32)
        q[1, 0] = -4.0  # max |q| = 2^2: scale 2^-28
    if b > 2:
        q[2] = (rng.uniform(-1, 1, d) * 2.0 ** -100).astype(np.float32)
    if b > 3:
        # max 1.5 -> e = 1, scale 2^-29: (k + 0.5) * 2^-29 rounds at a tie
        k = rng.integers(-1000, 1000, d).astype(np.float64)
        q[3] = ((k + 0.5) * 2.0 ** -29).astype(np.float32)
        q[3, -1] = 1.5
    return q


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("b", [1, 33, 300, 4096])
@pytest.mark.parametrize("d", [7, 96, 300, 768])
def test_limb_split_kernel_matches_plain(dev, b, d, fast):
    """The on-card limb split against ``query_limbs``: limbs and scale
    bit for bit; |q|^2 and sum(q), summed in the kernel's own order,
    within 1e-6 of sum(q^2) and of sum(|q|)."""
    q = torch.from_numpy(_limb_rows(b, d, seed=b + d)).to(dev)
    before = limbs.query_operands.launches
    kl, ks, kq, ksum = limbs.query_operands(q, fast)
    torch.cuda.synchronize()
    assert limbs.query_operands.launches == before + 1
    pl, ps, pq, psum = limbs.query_operands_plain(q, fast)
    cl, cs, _, _ = limbs.query_operands_plain(q.cpu(), fast)
    assert kl.shape == (limbs.N_LIMBS, b, limbs.padded_dim(d)) and kl.dtype == torch.int8
    assert torch.equal(kl, pl) and torch.equal(ks, ps)
    assert torch.equal(kl.cpu(), cl) and torch.equal(ks.cpu(), cs)
    assert bool(((kq - pq).abs() <= 1e-6 * pq).all())
    assert bool(((ksum - psum).abs() <= 1e-6 * q.abs().sum(dim=1)).all())


def test_limb_split_counts_inside_the_distance_kernels(dev):
    """K1 and K2 run the limb split inside their own C call: one count
    each, and the same results as from limbs split beforehand (the
    kernels are deterministic, so the outputs repeat bit for bit)."""
    q, codes, scales, normsq = _collection(dev, 4096, 50, 33, seed=9)
    before = limbs.query_operands.launches
    a = l2_kernel.pairwise_l2sq_kernel(q, codes, scales, normsq)
    kd, ki = groupmin.group_min_d2(q, codes, scales, normsq)
    assert limbs.query_operands.launches == before + 2
    assert torch.equal(a, l2_kernel.pairwise_l2sq_kernel(q, codes, scales, normsq))
    assert torch.equal(a.view(33, 32, 128).amin(dim=2), kd) or bool(
        ((a.view(33, 32, 128).amin(dim=2) - kd).abs()
         <= 2e-6 * ((q * q).sum(1, keepdim=True) + normsq.max())).all())
    with pytest.raises(ValueError, match="contiguous float32"):
        limbs.query_operands(q.double())


# -- the serving routes, refine and the build options on the card -----------------


def _recall10(ids, truth):
    return float(np.mean([len(set(a) & set(t)) / 10 for a, t in zip(ids, truth)]))


def _cpu_index_20k():
    ds = synthetic_clustered(20_000, 32, n_queries=256, seed=7)
    cpu = HNSW(12, ef_cons=48, dim=32, device="cpu")
    cpu.insert_bulk(ds.train, cluster_build=True,
                    cluster_kwargs={"select_alg4": False})
    truth = brute_force_nns(ds.test, cpu.points.codes, cpu.points.scales, 10)
    return ds, cpu, truth


def test_serving_routes_on_card_match_cpu(dev):
    """Every new serving route on the card against the same route on the
    CPU, on one CPU-built 20k index whose state is copied to the card
    (the same pivots, shortlists, codebooks and PQ codes): ids equal on
    >= 99% of the entries (the card's products may swap near-ties; the
    share is printed), recall@10 within 0.01."""
    ds, cpu, truth = _cpu_index_20k()
    card = HNSW.from_numpy(*cpu.to_numpy(), dev)

    def copy_state():
        card.serve_expand, card.serve_probes = cpu.serve_expand, cpu.serve_probes
        card.pq_rerank = cpu.pq_rerank
        card._packed0 = None if cpu._packed0 is None else cpu._packed0.to(dev)
        card._packed_n = cpu._packed_n
        card._pivots = tuple(t.to(dev) for t in cpu._pivots)
        card._pivots_n = cpu._pivots_n
        card._pivot_shortlist, card._pivot_sl_pack = (
            None if t is None else t.to(dev)
            for t in (cpu._pivot_shortlist, cpu._pivot_sl_pack))
        card._pq = None if cpu._pq is None else tuple(
            None if t is None else t.to(dev) for t in cpu._pq)
        card._pq_n = cpu._pq_n

    modes = [({"pivots": 512, "expand": 4}, "seeded"),
             ({"pivots": 512, "pivot_shortlist": 32}, "probe_packed"),
             ({"pivots": 512, "pq_m": 8}, "pq"),
             ({"pivots": 512, "pq_m": 8, "pq_bits": 4, "pq_opq": True}, "pq"),
             ({"pivots": 512, "packed": False, "expand": 2}, "seeded_plain")]
    for kw, route in modes:
        cpu.finalize(**kw)
        cpu.serve_probes = 6
        copy_state()
        assert card.serving_route() == cpu.serving_route() == route
        _, ci = cpu.ann_batch(ds.test, 10, 48)
        _, gi = card.ann_batch(ds.test, 10, 48)
        print(f"{route} {kw}: ids equal on the card and the CPU: {np.mean(ci == gi):.4f}")
        floor = 0.95 if route == "pq" else 0.99  # ADC sums tie more often
        assert np.mean(ci == gi) >= floor, (kw, np.mean(ci == gi))
        assert abs(_recall10(gi, truth) - _recall10(ci, truth)) <= 0.01
    # the narrow probe route, which finalize never selects
    cpu.finalize(pivots=512, pivot_shortlist=32)
    copy_state()
    card._pivot_sl_pack = cpu._pivot_sl_pack = None
    assert card.serving_route() == "probe"
    _, ci = cpu.ann_batch(ds.test, 10, 48)
    _, gi = card.ann_batch(ds.test, 10, 48)
    assert np.mean(ci == gi) >= 0.99
    # and finalize itself on the card: its own pivots, shortlists and PQ
    for kw in ({"pivots": 512, "pivot_shortlist": 32}, {"pivots": 512, "pq_m": 8}):
        cpu.finalize(**kw)
        card.finalize(**kw)
        assert card.serving_route() == cpu.serving_route()
        rc = _recall10(cpu.ann_batch(ds.test, 10, 48)[1], truth)
        rg = _recall10(card.ann_batch(ds.test, 10, 48)[1], truth)
        assert abs(rc - rg) <= 0.02, (kw, rc, rg)


def test_refine_on_card_matches_cpu(dev):
    ds, cpu, truth = _cpu_index_20k()
    card = HNSW.from_numpy(*cpu.to_numpy(), dev)
    cpu.refine(rounds=1, batch=4096)
    card.refine(rounds=1, batch=4096)
    same = (card.graph.get_layer(0).cpu() == cpu.graph.get_layer(0)).all(1)
    print(f"refined rows equal on the card and the CPU: {float(same.float().mean()):.4f}")
    assert float(same.float().mean()) >= 0.95
    assert card.assert_param_compliance(verbose=False)
    for idx in (cpu, card):
        idx.finalize(pivots=512)
    rc = _recall10(cpu.ann_batch(ds.test, 10, 32)[1], truth)
    rg = _recall10(card.ann_batch(ds.test, 10, 32)[1], truth)
    assert abs(rc - rg) <= 0.01, (rc, rg)


@pytest.mark.parametrize("kw", [{"wave_sort": True}, {"build_seeded": True},
                                {"build_expand": 2}], ids=str)
def test_wave_build_options_on_card(dev, kw):
    """The wave build's options on the card against the same build on
    the CPU at N=5,000: recall@10 at ef=64 >= 0.95 and within 0.02."""
    ds = synthetic_clustered(5_000, 32, n_queries=128, seed=9)
    rec = {}
    for where in ("cpu", dev):
        idx = HNSW(12, ef_cons=48, dim=32, device=where)
        idx.insert_bulk(ds.train, **kw)
        assert idx.serving_route() == "packed"
        assert idx.assert_param_compliance(verbose=False)
        truth = brute_force_nns(ds.test, idx.points.codes, idx.points.scales, 10)
        rec[str(where)] = _recall10(idx.ann_batch(ds.test, 10, 64)[1], truth)
    assert min(rec.values()) >= 0.95 and abs(rec["cpu"] - rec[str(dev)]) <= 0.02, rec


# -- the other index families and out-of-core serving on the card -----------------


def test_kmeans_on_card_repeats_bit_for_bit(dev):
    """Lloyd's member sums are one-hot products in row chunks, not
    ``index_add_`` (atomics, no fixed order): two runs on the card give
    the same centroids and assignment bit for bit, and the same
    assignment as the CPU on >= 99.5% of the points."""
    from hnsw_rs_tpu_torch.models import ivf

    ds = synthetic_clustered(20_000, 32, n_queries=8, seed=3)
    x = dequantize(*quantize(torch.from_numpy(ds.train).to(dev)))
    init = torch.from_numpy(
        np.random.default_rng(0).choice(20_000, size=256, replace=False)).to(dev)
    c1, a1 = ivf._kmeans(x, init, 256, 6)
    c2, a2 = ivf._kmeans(x, init, 256, 6)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    cc, ac = ivf._kmeans(x.cpu(), init.cpu(), 256, 6)
    same = float((a1.cpu() == ac).float().mean())
    print(f"k-means assignment on the card equals the CPU's on {same:.4f}")
    assert same >= 0.995
    # exact ties go to the lowest list on the card too
    d2 = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.5, 0.5, 0.5, 0.5]], device=dev)
    assert ivf._argmin_first(d2).tolist() == [1, 0]
    assert ivf._argmin_first(d2.repeat(1, 600)).tolist() == [1, 0]


def _families_data():
    ds = synthetic_clustered(20_000, 32, n_queries=256, seed=7)
    flat = FlatIndex(32, "cpu")
    flat.add(ds.train)
    return ds, flat.search(ds.test, 10)[1]


@pytest.mark.parametrize("scanned", [False, True], ids=["one_shot", "scanned"])
def test_ivf_flat_on_card_matches_cpu(dev, monkeypatch, scanned):
    """IVF-Flat at N=20k built on the CPU, its state handed to the card:
    both search branches return the CPU's ids on >= 99.9% of the entries;
    built on the card itself, recall within 0.01; ``add`` scatters on the
    card as on the CPU."""
    from hnsw_rs_tpu_torch.models import ivf

    if scanned:
        monkeypatch.setattr(ivf, "DENSE_IVF_SEARCH_LIMIT", 0)
    ds, truth = _families_data()
    cpu = IVFFlatIndex(32, n_lists=128, kmeans_iters=6, device="cpu")
    cpu.train_add(ds.train)
    card = IVFFlatIndex.from_numpy(*cpu.to_numpy(), dev)
    assert card.blocks.is_cuda and torch.equal(card.blocks.cpu(), cpu.blocks)
    for p in (4, 16, 128):
        _, ci = cpu.search(ds.test, 10, n_probe=p)
        _, gi = card.search(ds.test, 10, n_probe=p)
        assert np.mean(ci == gi) >= 0.999, (p, np.mean(ci == gi))
    assert _recall10(gi, truth) >= 0.999  # full probe is the exact search
    own = IVFFlatIndex(32, n_lists=128, kmeans_iters=6, device=dev)
    own.train_add(ds.train)
    rc = _recall10(cpu.search(ds.test, 10, n_probe=8)[1], truth)
    rg = _recall10(own.search(ds.test, 10, n_probe=8)[1], truth)
    assert abs(rc - rg) <= 0.01, (rc, rg)
    extra = ds.test[:100] + 0.01
    np.testing.assert_array_equal(cpu.add(extra), card.add(extra))
    assert torch.equal(card.block_ids.cpu(), cpu.block_ids)
    assert torch.equal(card.blocks.cpu(), cpu.blocks)


def test_ivf_pq_on_card_matches_cpu(dev):
    """IVF-PQ at N=20k: the CPU's trained state on the card returns its
    reranked ids on >= 99% of the entries and its ADC ids on >= 95% (ADC
    sums tie more often); trained on the card, recall within 0.02."""
    ds, truth = _families_data()
    cpu = IVFPQIndex(32, n_lists=128, m_pq=8, kmeans_iters=6, rerank=40,
                     device="cpu")
    cpu.train_add(ds.train)
    meta, arrays = cpu.to_numpy()
    pq_codes = np.zeros((len(cpu), 8), np.uint8)
    bids = cpu.block_ids.numpy()
    pq_codes[bids[bids >= 0]] = cpu.blocks.numpy()[bids >= 0]
    card = IVFPQIndex.from_numpy(meta, dict(arrays, pq_codes=pq_codes), dev)
    assert card.blocks.is_cuda and torch.equal(card.blocks.cpu(), cpu.blocks)
    _, ci = cpu.search(ds.test, 10, n_probe=8)
    _, gi = card.search(ds.test, 10, n_probe=8)
    assert np.mean(ci == gi) >= 0.99
    _, ca = cpu.search(ds.test, 10, n_probe=8, rerank=0)
    _, ga = card.search(ds.test, 10, n_probe=8, rerank=0)
    print(f"ADC ids equal on the card and the CPU: {np.mean(ca == ga):.4f}")
    assert np.mean(ca == ga) >= 0.95
    own = IVFPQIndex(32, n_lists=128, m_pq=8, kmeans_iters=6, rerank=40,
                     device=dev)
    own.train_add(ds.train)
    rc, rg = _recall10(ci, truth), _recall10(own.search(ds.test, 10, n_probe=8)[1], truth)
    assert rg >= 0.8 and abs(rc - rg) <= 0.02, (rc, rg)


def test_flat_forms_and_cosine_on_card(dev):
    """Raw-float rows, ``exact`` and the one-sort path on the card against
    the CPU (ids equal on >= 99.9%), and the fused kernel under the cosine
    metric against ``exact``."""
    ds, _ = _families_data()
    for kw in ({"quantized": False}, {"metric": "cosine"}, {}):
        cpu, card = FlatIndex(32, "cpu", **kw), FlatIndex(32, dev, **kw)
        cpu.add(ds.train)
        card.add(ds.train)
        for exact in (True, False):
            _, ci = cpu.search(ds.test[:64], 10, exact=exact)
            _, gi = card.search(ds.test[:64], 10, exact=exact)
            assert np.mean(ci == gi) >= 0.999, (kw, exact)
        if kw.get("quantized", True):
            _, fi = card.search(ds.test[:64], 10, fused=True)
            assert _recall10(fi, ci) >= 0.999


def test_paged_tiers_on_card_match_in_memory(dev, tmp_path):
    """The 20k wave build on the card, saved paged: the host reader, the
    hybrid exact tier at E=1 and E=4 (with no cold lane at all, and with
    every lane cold: one hot row of 20,000) return the in-memory index's
    ids; the PQ tier keeps recall parity >= 0.9; the streaming exact
    search equals ``FlatIndex``."""
    from hnsw_rs_tpu_torch.models.paged import (
        HybridPagedHNSW, PagedHNSW, save_paged)

    ds = synthetic_clustered(20_000, 32, n_queries=64, seed=7)
    idx = HNSW(12, ef_cons=48, dim=32, device=dev)
    idx.insert_bulk(ds.train)
    idx.finalize(pivots=1024)
    path = str(tmp_path / "paged")
    save_paged(idx, path)
    plain = HNSW.from_numpy(*idx.to_numpy(), dev)
    _, pi = plain.ann_batch(ds.test, 10, 48)
    _, hi = PagedHNSW(path, cache_blocks=256).ann_batch(ds.test, 10, 48)
    assert np.mean(hi == pi) >= 0.99  # numpy sums against the card's
    wrow = idx.graph.get_layer(0).shape[1] * (32 + 12)
    for e in (1, 4):
        idx.serve_expand = e
        _, mi = idx.ann_batch(ds.test, 10, 48)
        for hot in (20_000 * wrow, wrow, 10_000 * wrow):
            hy = HybridPagedHNSW(path, hot_bytes=hot, pivots=1024, device=dev)
            assert hy._hot_packed.is_cuda and hy._pivot_vecs.is_cuda
            _, yi = hy.ann_batch(ds.test, 10, 48, expand_e=e)
            np.testing.assert_array_equal(yi, mi)
            if hot == 20_000 * wrow:
                assert hy.misses == 0 and hy.hits > 0
            elif hot == wrow:
                assert hy.hot_rows == 1 and hy.misses > 50 * hy.hits
    idx.serve_expand = 1
    pq = HybridPagedHNSW(path, pivots=1024, pq_m=8, pq_bits=4, device=dev)
    assert pq._pq_packed.is_cuda
    _, qi = pq.ann_batch(ds.test, 10, 96)
    _, mi = idx.ann_batch(ds.test, 10, 96)
    assert _recall10(qi, mi) >= 0.9
    flat = FlatIndex(32, dev)
    flat.add(ds.train)
    _, si = PagedHNSW(path).store.search_streaming(ds.test, 10, device=dev)
    np.testing.assert_array_equal(si, flat.search(ds.test, 10, exact=True)[1])


def _sharded_state(n, shards, device, seed=3):
    from hnsw_rs_tpu_torch.parallel import ShardedHNSW, make_mesh

    ds = synthetic_clustered(n, 32, n_queries=256, seed=seed)
    index = ShardedHNSW(8, 32, shards, mesh=make_mesh(1, shards, [device] * shards))
    index.insert_bulk(ds.train)
    return ds, index


def test_sharded_query_on_card_matches_cpu(dev, tmp_path):
    """The in-process sharded query answers on ``cuda:0`` as the same
    saved state does on the CPU: the plain route, then the seeded one
    after ``finalize`` with the CPU's pivots (ids equal on >= 99% of the
    entries: the card's products may swap near-ties). The card's own
    ``finalize`` meets every shard's budget with distinct live rows; its
    rows are not compared with the CPU's, because one swapped near-tie in
    the farthest-first k-center fill changes every later pick."""
    from hnsw_rs_tpu_torch.parallel import ShardedHNSW, make_mesh

    ds, cpu = _sharded_state(4000, 4, "cpu")
    cpu.save(str(tmp_path / "s"))
    card = ShardedHNSW.load(str(tmp_path / "s"), make_mesh(1, 4, [dev] * 4))
    assert all(t.device.type == dev.type for t in card._stacked["codes"])
    same = np.mean(card.ann_batch(ds.test, 10, 48)[1]
                   == cpu.ann_batch(ds.test, 10, 48)[1])
    assert same >= 0.99, same
    cpu.finalize(pivots=256)
    card.finalize(pivots=256)
    for s, row in enumerate(card._packed[1]):
        row = row.cpu().numpy()
        assert row.size == 256 and np.unique(row).size == 256, s
        assert row.min() >= 0 and row.max() < card._counts[s], s
    card._packed = (card._packed[0], [t.to(dev) for t in cpu._packed[1]],
                    [t.to(dev) for t in cpu._packed[2]])
    same = np.mean(card.ann_batch(ds.test, 10, 48)[1]
                   == cpu.ann_batch(ds.test, 10, 48)[1])
    assert same >= 0.99, same


def test_sharded_scrub_and_indegree_on_card_match_cpu(dev):
    """``_scrub_stacked`` (stable left-compaction) and ``_indeg_stacked``
    (integer scatter-add) on the card equal the CPU's, stacked and per
    shard."""
    from hnsw_rs_tpu_torch.parallel.sharded import _indeg_stacked, _scrub_stacked

    rng = np.random.default_rng(0)
    a = rng.integers(-1, 5000, (3, 5000, 16)).astype(np.int32)
    rem = rng.random((3, 5000)) < 0.1
    at, rt = torch.from_numpy(a), torch.from_numpy(rem)
    want_a, want_c = _scrub_stacked(at, rt, rt)
    got_a, got_c = _scrub_stacked(at.to(dev), rt.to(dev), rt.to(dev))
    assert torch.equal(got_a.cpu(), want_a) and torch.equal(got_c.cpu(), want_c)
    assert torch.equal(_indeg_stacked(at.to(dev)).cpu(), _indeg_stacked(at))
    assert torch.equal(_indeg_stacked(at[1].to(dev)).cpu(), _indeg_stacked(at)[1])


def test_sharded_cluster_build_on_card_clears_recall(dev):
    """A 20k concurrent cluster build over 4 shards on the card clears
    recall@10 0.95 through the seeded route, and its orphan fixpoint
    leaves every live layer-0 row with an out-edge and an in-edge."""
    from hnsw_rs_tpu_torch.parallel import ShardedHNSW, make_mesh

    ds = synthetic_clustered(20_000, 32, n_queries=256, seed=4)
    index = ShardedHNSW(12, 32, 4, ef_cons=48, mesh=make_mesh(1, 4, [dev] * 4))
    index.insert_bulk(ds.train, cluster_build=True,
                      cluster_kwargs={"pool_p": 96, "points_per_cluster": 96,
                                      "fanout": 5, "select_alg4": False,
                                      "merge_slots": 48})
    assert all(t.device.type == dev.type for t in index._stacked["adjs"][0])
    index.finalize(pivots=1024)
    truth = brute_force_nns(ds.test, *quantize(torch.from_numpy(ds.train).to(dev)), 10)
    ids = index.ann_batch(ds.test, 10, 64)[1]
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, truth)])
    assert rec >= 0.95, rec
    for s, a0 in enumerate(index._stacked["adjs"][0]):
        a0 = a0.cpu().numpy()[: int(index._counts[s])]
        indeg = np.bincount(a0[a0 >= 0], minlength=a0.shape[0])
        assert np.all((a0 >= 0).sum(1) > 0) and np.all(indeg > 0), s


def test_hybrid_tier_on_the_native_assembler(dev, tmp_path, monkeypatch):
    """The hybrid exact tier with half its rows cold: every cold row comes
    from the native assembler (counted), byte for byte its numpy version's,
    and the tier returns the in-memory index's ids at E=1 and E=4."""
    from hnsw_rs_tpu_torch import native
    from hnsw_rs_tpu_torch.models.paged import HybridPagedHNSW, save_paged

    assert native.get_lib() is not None, "g++ is needed on the card's host"
    ds = synthetic_clustered(20_000, 32, n_queries=64, seed=9)
    idx = HNSW(12, ef_cons=48, dim=32, device=dev)
    idx.insert_bulk(ds.train)
    idx.finalize(pivots=1024)
    path = str(tmp_path / "paged")
    save_paged(idx, path)
    calls = []
    real = native.assemble_packed_rows
    monkeypatch.setattr(native, "assemble_packed_rows",
                        lambda *a: calls.append(len(a[-1])) or real(*a))
    wrow = idx.graph.get_layer(0).shape[1] * (32 + 12)
    hy = HybridPagedHNSW(path, hot_bytes=10_000 * wrow, pivots=1024, device=dev)
    ids = np.arange(0, 20_000, 97)
    np.testing.assert_array_equal(hy._packed_rows_host(ids), hy._packed_rows_numpy(ids))
    for e in (1, 4):
        idx.serve_expand = e
        _, mi = idx.ann_batch(ds.test, 10, 48)
        calls.clear()
        hy.misses = 0
        _, yi = hy.ann_batch(ds.test, 10, 48, expand_e=e)
        np.testing.assert_array_equal(yi, mi)
        assert hy.misses > 0 and sum(calls) == hy.misses
    hy.close()


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_annb_adapters_on_card(dev, metric):
    """The three ann-benchmarks adapters on the card: HNSW recall@10 >=
    0.95 against the exact adapter, within 0.01 of the same adapter on
    the CPU; IVF at full probe exact; the single query equals the batch's
    first row."""
    from hnsw_rs_tpu_torch.annb import (
        ANNBenchmarksFlat, ANNBenchmarksHNSW, ANNBenchmarksIVF)

    ds = synthetic_clustered(20_000, 48, n_queries=128, seed=5)
    exact = ANNBenchmarksFlat(metric)
    exact.fit(ds.train)
    exact.batch_query(ds.test, 10)
    truth = exact.get_batch_results()
    assert exact._index.codes.is_cuda
    recs = []
    for device in ("cuda", "cpu"):
        algo = ANNBenchmarksHNSW(metric, {"M": 16, "efConstruction": 96}, device=device)
        algo.fit(ds.train)
        algo.set_query_arguments(64)
        algo.batch_query(ds.test, 10)
        recs.append(_recall10(algo.get_batch_results(), truth))
        assert list(algo.query(ds.test[0], 10)) == list(algo.get_batch_results()[0])
        assert algo.get_memory_usage() > 0
    assert recs[0] >= 0.95 and abs(recs[0] - recs[1]) <= 0.01, recs
    ivf = ANNBenchmarksIVF(metric, {"n_list": 64})
    ivf.fit(ds.train)
    ivf.set_query_arguments(64)
    ivf.batch_query(ds.test, 10)
    assert _recall10(ivf.get_batch_results(), truth) >= 0.999


def test_entry_on_card(dev, capsys):
    """``entry("cuda")``'s step on the card returns the CPU step's ids on
    >= 99% of entries, and ``dryrun_multichip(8, "cuda")`` passes."""
    from hnsw_rs_tpu_torch.entry import dryrun_multichip, entry

    fn, args = entry("cuda")
    assert args[1].is_cuda and args[3].is_cuda
    dist, ids = fn(*args)
    cfn, cargs = entry("cpu")
    _, cids = cfn(*cargs)
    assert ids.shape == (64, 10) and bool(torch.isfinite(dist).all())
    assert np.mean(ids.cpu().numpy() == cids.numpy()) >= 0.99
    dryrun_multichip(8, "cuda")
    assert "dryrun_multichip ok on 8 devices" in capsys.readouterr().out
