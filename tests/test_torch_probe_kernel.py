"""The probe-stage kernel (``ops/probe.py``, ``csrc/probe_packed.cu``) and
the selection it rests on.

On the CPU (no JAX here): a model of the kernel's reduce (the pool's s lowest
entries by (d2, position), each id's lowest (d2, position) entry, or its first
position when the pool is no wider than s, then a (d2, id) sort) gives
``search._top_ef_dedup_oversampled``'s seeds on pools with duplicate ids
wherever the plain reduce is itself exact (no two ids tied at the s-th key:
``torch.topk`` keeps an arbitrary one of them); CPU tensors never reach the
kernel; shapes past the kernel's limits raise.

On the card (marked ``cuda``, skipping without one): the kernel against the
plain path (``search._probe_seeds`` over ``search._score_probe_packed``) on the
same CUDA inputs, and against the model on the plain path's pool, over two
kinds of data:

- *exact*: integer vectors holding 0 and 255, so every code dequantizes to
  itself (delta 1, min 0) and every d2 is an integer below 2^24, exact in any
  order of summation; ids and d2 must be equal. One case repeats every
  point's vector four times under other ids, so that many ids tie at the s-th
  key.
- *float*: clustered float vectors. d2 must lie within 1e-6 * d2 + 1e-7 *
  (|q|^2 + |x|^2) of the plain path's at every slot, and ids must be equal
  except where the plain d2 of the two ids lie within that tolerance (a
  near-tie from the order of summation; counted and printed). A row whose
  ids differ otherwise ("apart") needs two distances that the order of
  summation moves across each other, or one it moves across the s-th key,
  which changes the distinct survivors when duplicate ids crowd the s
  lowest entries. These cases show none and allow none; at the cells' ef
  over tens of thousands of rows such moves across the s-th key do occur
  (``chip_smoke.py`` and ``tools/time_kernels.py --kernel k4`` count them
  and hold each to that key).

Run on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_probe_kernel.py``.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hnsw_rs_tpu_torch import HNSW
from hnsw_rs_tpu_torch import search as tsearch
from hnsw_rs_tpu_torch.ops import probe as probe_kernel
from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize
from hnsw_rs_tpu_torch.ops.topk import PAD_ID, lex_perm, sort_dist_id
from hnsw_rs_tpu_torch.utils import counters, reset_spans, traced_spans

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _fresh_spans():
    reset_spans()
    yield
    reset_spans()


def _model_reduce(pd2, pids, ef):
    """``csrc/probe_packed.cu``'s reduce of a pool (d2, ids) [b, W] in plain
    PyTorch: (d2 [b, ef'], ids [b, ef'])."""
    b, w = pd2.shape
    s = min(4 * ef, w)
    pos = torch.arange(w, device=pd2.device).expand(b, w)
    topk = w > s
    if topk:
        sel = lex_perm(pd2, pos)[:, :s]
        pd2, pids, pos = pd2.gather(1, sel), pids.gather(1, sel), sel
    order = lex_perm(pids, pd2, pos) if topk else lex_perm(pids, pos)
    si = pids.gather(1, order)
    first = torch.ones_like(si, dtype=torch.bool)
    first[:, 1:] = si[:, 1:] != si[:, :-1]
    keep = torch.zeros_like(first).scatter(1, order, first)
    d2, ids = sort_dist_id(torch.where(keep, pd2, math.inf),
                           torch.where(keep, pids, PAD_ID))
    return d2[:, :ef], ids[:, :ef]


def _pool(seed, b, w, ef, n_ids):
    """A pool like the probe stage's: ``ef`` seeds, then members whose ids
    repeat across probes with equal d2 (one id, one vector), some seeds
    repeating a member's id with a d2 a few ulps apart (the matmul form),
    and (inf, PAD) pads. Distinct ids never share a d2."""
    rng = np.random.default_rng(seed)
    base = rng.permutation(np.arange(1, 1 + 4 * n_ids, dtype=np.float32))
    base = (base[:n_ids] / 7.0).astype(np.float32)
    ids = rng.integers(0, n_ids, (b, w))
    d2 = base[ids]
    near = rng.random((b, ef)) < 0.3
    d2[:, :ef] = np.where(near, np.nextafter(d2[:, :ef], np.float32(
        np.inf if seed % 2 else 0)), d2[:, :ef])
    pad = rng.random((b, w)) < 0.05
    d2 = np.where(pad, np.inf, d2).astype(np.float32)
    ids = np.where(pad, PAD_ID, ids).astype(np.int32)
    return T(d2), T(ids)


@pytest.mark.parametrize("b,w,ef,n_ids", [
    (40, 9600, 384, 3000), (40, 9600, 384, 20000), (64, 808, 8, 300),
    (50, 88, 64, 40), (30, 256, 64, 120), (30, 257, 64, 120)])
def test_kernel_reduce_model_gives_the_plain_reduce(b, w, ef, n_ids):
    """Duplicate ids across probes and between seeds and probes, pads, a pool
    four times wider than s, one no wider than s and one just wider."""
    pd2, pids = _pool(w + ef, b, w, ef, n_ids)
    want = tsearch._top_ef_dedup_oversampled(pd2, pids, ef)
    got = _model_reduce(pd2, pids, ef)
    assert torch.equal(got[1], want[1][:, :ef])
    assert torch.equal(got[0], want[0][:, :ef])


# -- the data ----------------------------------------------------------------

def _case(seed, n, d, p, t, b, exact, dup_vecs=False, n_clusters=32):
    """Clustered points (``exact``: integers in [0, 255] with coordinates 0
    and 1 fixed at 0 and 255, so codes equal the values; ``dup_vecs``: every
    vector four times, under four ids), ``p`` pivots with ~5% invalid (-1),
    shortlists whose first member is the pivot itself, the rest from its
    cluster and anywhere, ~10% -1 members, and dequantized queries near the
    clusters. Returns CPU tensors (codes, scales, pivot_ids, pivot_vecs,
    shortlist, q)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_clusters, n)
    qa = rng.integers(0, n_clusters, b)
    if exact:
        cent = rng.integers(40, 216, (n_clusters, d))
        x = np.clip(cent[a] + rng.integers(-12, 13, (n, d)), 0, 255)
        qx = np.clip(cent[qa] + rng.integers(-12, 13, (b, d)), 0, 255)
        x[:, :2] = qx[:, :2] = (0, 255)
    else:
        cent = rng.random((n_clusters, d))
        x = cent[a] + rng.normal(0, 0.05, (n, d))
        qx = cent[qa] + rng.normal(0, 0.05, (b, d))
    if dup_vecs:
        x = x[np.arange(n) // 4 * 4]
        a = a[np.arange(n) // 4 * 4]
    codes, scales = quantize(T(x.astype(np.float32)))
    q = dequantize(*quantize(T(qx.astype(np.float32))))
    piv = rng.choice(n, p, replace=False)
    members = [np.flatnonzero(a == c) for c in range(n_clusters)]
    sl = np.empty((p, t), np.int64)
    for j, pv in enumerate(piv):
        m = members[a[pv]]
        own = rng.choice(m, min(t - 1, m.size, (t - 1) // 2 + 1), replace=False)
        rest = rng.choice(n, t - 1 - own.size, replace=False)
        sl[j] = np.concatenate([[pv], own, rest])
    sl[rng.random((p, t)) < 0.1] = -1
    piv[rng.random(p) < 0.05] = -1
    safe = np.maximum(piv, 0)
    pvecs = dequantize(codes[safe], scales[safe])
    return (codes, scales, T(piv.astype(np.int32)), pvecs,
            T(sl.astype(np.int32)), q)


def _stage(dev, case, exact, seed):
    """The plain path's and the kernel's seeds on the card, and the model's
    on the plain path's pool."""
    n, d, p, t, b, ef, probes, dup = case
    codes, scales, piv, pvecs, sl, q = _case(seed, n, d, p, t, b, exact, dup)
    codes, scales, q = codes.to(dev), scales.to(dev), q.to(dev)
    piv, pvecs = piv.to(dev), pvecs.to(dev)
    pack = tsearch.pack_layer(sl.to(dev), codes, scales)

    def score(qc, pos):
        return tsearch._score_probe_packed(pack, t, d, qc, pos)

    per = tsearch._probe_bytes_per_query(t, d, p, ef, probes, packed=True)
    plain = tsearch._probe_seeds(
        lambda qc, e_d2, e_ids, pos: tsearch._probe_stage(
            score, qc, e_d2, e_ids, pos, ef, probes), piv, pvecs, q, ef, per)
    launches = probe_kernel.probe_packed.launches
    got = tsearch._probe_seeds(tsearch._packed_probe_stage(pack, t, d, ef, probes),
                               piv, pvecs, q, ef, per)
    torch.cuda.synchronize()
    assert probe_kernel.probe_packed.launches == launches + 1
    assert counters()["probe.kernel_calls"] == 1
    # the model on the plain path's own pool
    e_d2, e_ids, pos = tsearch._pivot_seeds_pos(piv, pvecs, q, ef)
    parts_d2, parts_ids = [e_d2], [e_ids]
    for i in range(min(probes, pos.shape[1])):
        d2_i, ids_i = score(q, pos[:, i])
        parts_d2.append(torch.where(ids_i >= 0, d2_i, math.inf))
        parts_ids.append(torch.where(ids_i >= 0, ids_i, PAD_ID))
    model = _model_reduce(torch.cat(parts_d2, 1), torch.cat(parts_ids, 1), ef)
    return codes, scales, q, plain, got, model


# -- the dispatch and the limits -----------------------------------------------

def test_cpu_probe_route_takes_the_plain_path():
    rng = np.random.default_rng(4)
    x = (rng.random((16, 16))[rng.integers(0, 16, 2000)]
         + rng.normal(0, 0.05, (2000, 16))).astype(np.float32)
    idx = HNSW(8, ef_cons=32, dim=16, device="cpu")
    idx.insert_bulk(x, cluster_build=True,
                    cluster_kwargs=dict(pool_p=16, points_per_cluster=32,
                                        fanout=3, select_alg4=False,
                                        merge_slots=16))
    idx.finalize(pivots=128, pivot_shortlist=32)
    idx.serve_probes = 4
    assert idx.serving_route() == "probe_packed"
    launches = probe_kernel.probe_packed.launches
    with profile(activities=[ProfilerActivity.CPU]):
        idx.ann_batch(x[:20], 10, 24)
    probes = [r for r in traced_spans() if r["name"] == "hnsw.search.probe"]
    assert len(probes) == 1
    assert "probe.kernel_calls" not in probes[0]["counts"]
    assert "probe.kernel_calls" not in counters()
    assert probe_kernel.probe_packed.launches == launches


@pytest.mark.parametrize("shape,ok", [
    ((32_768, 256, 96, 384, 36, 10_000), True),   # deep5m.probed
    ((16_384, 256, 96, 384, 36, 10_000), True),   # a deep10m.sharded4 shard
    ((32_768, 256, 96, 40, 36, 10_000), True),    # bench_second_regime.py
    ((32_768, 256, 96, 512, 36, 1_024), True),    # chip_smoke's last rung
    ((1000, 6, 17, 64, 4, 3), True),
    ((1000, 256, 96, 384, 36, 0), True),
    ((1000, 256, 769, 16, 4, 4), False),          # d
    ((1000, 4097, 8, 16, 1, 4), False),           # T
    ((1000, 16, 96, 4097, 4, 4), False),          # ef
    ((1000, 2048, 16, 384, 36, 4), False),        # pool wider than 65,535
    ((1000, 256, 768, 16, 4, 4), False),          # two row stages: 396 KB
    ((1000, 16, 96, 4096, 700, 4), False)])       # the selection's scratch
def test_kernel_limits(shape, ok):
    """Shapes past the kernel's limits raise ValueError before anything else
    is looked at; shapes within them get as far as the device check
    (TypeError on the CPU). The rows are views of one row: no memory."""
    p, t, d, ef, probes, b = shape
    pack = torch.zeros((1, t * (d + 12)), dtype=torch.uint8).expand(p, -1)
    e = min(ef, p)
    q = torch.zeros((b, d))
    e_d2, e_ids = torch.zeros((b, e)), torch.zeros((b, e), dtype=torch.int32)
    pos = torch.zeros((b, e), dtype=torch.int64)
    with pytest.raises(TypeError if ok else ValueError):
        probe_kernel.probe_packed(pack, t, q, e_d2, e_ids, pos, ef, probes)


def test_two_blocks_share_an_sm_at_the_cells_shape():
    """The cells' block (T 256, d 96, 36 probes, ef 384) fits twice into an
    H100 SM's 228 KB with 1 KB reserved a block."""
    assert 2 * (probe_kernel.smem_bytes(256, 96, 384, 36, 384) + 1024) <= 228 * 1024


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = [  # n, d, P, T, b, ef, probes, duplicate vectors
    (20_000, 96, 512, 256, 1000, 384, 36, False),  # the cells' stage
    (5_000, 32, 256, 40, 500, 24, 12, False),      # T not a multiple of 64
    (5_000, 20, 64, 100, 300, 8, 12, False),       # probes > pos width
    (3_000, 17, 128, 6, 200, 64, 4, False),        # pool no wider than s
    (2_000, 48, 32, 64, 200, 64, 8, False),        # fewer pivots than ef
    (8_000, 96, 256, 256, 500, 64, 36, True),      # ties at the s-th key
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_probe_kernel_equals_plain_path_on_exact_data(dev, case):
    _, _, _, (d2, ids), (kd2, kids), (md2, mids) = _stage(
        dev, case, True, seed=case[5] + case[1])
    assert torch.equal(kids, mids) and torch.equal(kd2, md2)
    assert torch.equal(kids, ids)
    assert torch.equal(kd2, d2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_probe_kernel_matches_plain_path_on_float_data(dev, case):
    b = case[4]
    codes, scales, q, (d2, ids), (kd2, kids), _ = _stage(
        dev, case, False, seed=case[5] + case[1] + 7)
    real = ids != PAD_ID
    safe = torch.where(real, ids, 0).long()
    x = dequantize(codes[safe], scales[safe])
    mag = (q * q).sum(-1, keepdim=True) + (x * x).sum(-1)
    tol = torch.where(real, 1e-6 * d2.abs() + 1e-7 * mag, 0.0)
    both_inf = torch.isinf(d2) & torch.isinf(kd2)
    close = ((kd2 - d2).abs() <= tol) | both_inf
    diff = kids != ids
    safe_k = torch.where(kids != PAD_ID, kids, 0).long()
    xk = dequantize(codes[safe_k], scales[safe_k])
    plain_d2_k = ((q[:, None, :] - xk) ** 2).sum(-1)
    tie = close & ((plain_d2_k - d2).abs() <= tol)
    apart = (~close | (diff & ~tie)).any(1)
    print(f"{case}: {int(diff.sum())} near-tie slots in "
          f"{int(diff.any(1).sum())} of {b} rows, {int(apart.sum())} rows apart")
    assert int(apart.sum()) == 0


@pytest.mark.cuda
def test_empty_batch_launches_nothing(dev):
    codes, scales, piv, pvecs, sl, q = _case(6, 500, 32, 16, 8, 1, True)
    pack = tsearch.pack_layer(sl.to(dev), codes.to(dev), scales.to(dev))
    q0 = q[:0].to(dev)
    e_d2 = torch.zeros((0, 16), device=dev)
    e_ids = torch.zeros((0, 16), dtype=torch.int32, device=dev)
    pos = torch.zeros((0, 16), dtype=torch.int64, device=dev)
    launches = probe_kernel.probe_packed.launches
    d2, ids = probe_kernel.probe_packed(pack, 8, q0, e_d2, e_ids, pos, 16, 4)
    assert probe_kernel.probe_packed.launches == launches
    assert d2.shape == ids.shape == (0, 16) and d2.is_cuda and ids.is_cuda


@pytest.mark.cuda
def test_probe_route_counts_one_kernel_call_per_probe_span(dev, monkeypatch):
    rng = np.random.default_rng(5)
    x = (rng.random((64, 32))[rng.integers(0, 64, 20_000)]
         + rng.normal(0, 0.05, (20_000, 32))).astype(np.float32)
    idx = HNSW(12, ef_cons=48, dim=32, device=dev)
    idx.insert_bulk(x, cluster_build=True,
                    cluster_kwargs={"select_alg4": False})
    idx.finalize(pivots=512, pivot_shortlist=32)
    idx.serve_probes = 6
    assert idx.serving_route() == "probe_packed"
    monkeypatch.setattr(tsearch, "_query_chunk", lambda b, per, device: 200)
    launches = probe_kernel.probe_packed.launches
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        idx.ann_batch(x[:500], 10, 48)
    spans = [r for r in traced_spans() if r["name"] == "hnsw.search.probe"]
    assert len(spans) == 3
    assert all(r["counts"]["probe.kernel_calls"] == 1 for r in spans)
    assert counters()["probe.kernel_calls"] == 3
    assert probe_kernel.probe_packed.launches == launches + 3
