"""The packed layer-0 beam kernel (``ops/beam.py``, ``csrc/beam_packed.cu``)
and the premise it rests on.

On the CPU (no JAX here): each query's row of a batched ``_beam_loop``
equals the loop run on that query alone, with iterations the largest
per-query count and live lanes their sum, which is what lets the kernel
walk each query on its own; a model of the kernel's algorithm (per-query
walk, circular ring, flag on the last of equal entries, merge by ranks)
gives the loop's beams and tallies; CPU tensors and E > 1 never reach the
kernel.

On the card (marked ``cuda``, skipping without one): the kernel against
``search._search_layer_packed_loop`` (``_beam_loop``) on the same CUDA
inputs, over two kinds of data:

- *exact*: integer vectors holding 0 and 255, so every code dequantizes
  to itself (delta 1, min 0) and every d2 is an integer below 2^24, exact
  in any order of summation. Ids, d2, iterations and tallies must be equal.
- *float*: clustered float vectors. In a row, d2 must lie within
  1e-6 * d2 + 1e-7 * (|q|^2 + |x|^2) of the loop's at every slot, and ids
  must be equal except where the loop's d2 of the two ids lie within that
  tolerance (a near-tie from the order of summation; counted and printed).
  A near-tie between the two best unexpanded entries swaps the order in
  which the walk expands them, and over hundreds of expansions at ef 384
  that can end a walk on another beam: such rows ("apart") are counted and
  printed, and may be at most 1 in 4,096 (the most seen on the card); the
  tallies may then differ by at most 1e-4 of their values. The exact data
  show that nothing but the order of summation differs.

Run on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_beam_kernel.py``.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hnsw_rs_tpu_torch import HNSW
from hnsw_rs_tpu_torch import search as tsearch
from hnsw_rs_tpu_torch.ops import beam as beam_kernel
from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize
from hnsw_rs_tpu_torch.ops.topk import PAD_ID
from hnsw_rs_tpu_torch.utils import counters, reset_spans, traced_spans

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _fresh_spans():
    reset_spans()
    yield
    reset_spans()


def _graph(seed, n, d, cap, b, exact, n_clusters=64):
    """Clustered points (``exact``: integers in [0, 255] with coordinates
    0 and 1 fixed at 0 and 255, so codes equal the values), a graph of
    ragged rows (half the row from the point's cluster, half from
    anywhere, ~15% -1 holes), dequantized queries. Numpy arrays."""
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
    codes, scales = quantize(T(x.astype(np.float32)))
    q = dequantize(*quantize(T(qx.astype(np.float32))))
    members = [np.flatnonzero(a == c) for c in range(n_clusters)]
    half = cap // 2
    adj = np.empty((n, cap), np.int64)
    for c, m in enumerate(members):
        adj[m, :half] = rng.choice(m, (m.size, half))
    adj[:, half:] = rng.integers(0, n, (n, cap - half))
    adj[adj == np.arange(n)[:, None]] = -1
    adj[rng.random((n, cap)) < 0.15] = -1
    return codes, scales, T(adj.astype(np.int32)), q


def _entries(q, codes, scales, k0, seed, dup=True):
    """Pivot-like seeds: the k0 nearest of 4*k0 random points by exact
    d2, some rows cut short with (inf, PAD) lanes and, with ``dup``, one
    row holding a duplicate entry id."""
    g = torch.Generator().manual_seed(seed)
    b, n = q.shape[0], codes.shape[0]
    piv = torch.randint(0, n, (4 * k0,), generator=g, dtype=torch.int64)
    x = dequantize(codes[piv], scales[piv])
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    vals, pos = torch.sort(d2, dim=1, stable=True)
    e_d2, e_ids = vals[:, :k0].contiguous(), piv[pos[:, :k0]].to(torch.int32)
    cut = torch.randint(1, k0 + 1, (b,), generator=g)
    lane = torch.arange(k0)[None, :]
    short = (torch.arange(b) % 3 == 1)[:, None] & (lane >= cut[:, None])
    e_d2 = torch.where(short, math.inf, e_d2)
    e_ids = torch.where(short, PAD_ID, e_ids)
    if dup and b > 2 and k0 > 2:
        e_ids[2, 1], e_d2[2, 1] = e_ids[2, 0], e_d2[2, 0]
    return e_d2, e_ids


def _loop(packed, q, e_d2, e_ids, ef, max_iters, ring=0, forbid=None):
    """The plain loop under the profiler: (d2, ids, counts of the beam
    span)."""
    with profile(activities=[ProfilerActivity.CPU]):
        d2, ids = tsearch._search_layer_packed_loop(
            packed, q, e_d2, e_ids, ef, max_iters, ring, forbid=forbid)
    (beam,) = [r for r in traced_spans() if r["name"] == "hnsw.search.beam"]
    reset_spans()
    return d2, ids, beam["counts"]


# -- the premise: a query's walk does not depend on its batch ---------------

@pytest.mark.parametrize("ef,max_iters,k0,ring,forbid", [
    (24, 40, 5, 0, False), (16, 6, 3, 0, True), (48, 200, 64, 0, False),
    (20, 30, 4, 100, True)])
def test_batched_loop_rows_equal_single_query_loops(ef, max_iters, k0, ring,
                                                    forbid):
    codes, scales, adj, q = _graph(1, 900, 20, 16, 12, exact=True)
    packed = tsearch.pack_layer(adj, codes, scales)
    e_d2, e_ids = _entries(q, codes, scales, k0, seed=ef)
    fb = adj[:12, 0].clamp(min=0) if forbid else None
    d2, ids, counts = _loop(packed, q, e_d2, e_ids, ef, max_iters, ring, fb)
    its = []
    for i in range(q.shape[0]):
        d1, i1, c1 = _loop(packed, q[i:i + 1], e_d2[i:i + 1], e_ids[i:i + 1],
                           ef, max_iters, ring, None if fb is None else fb[i:i + 1])
        assert torch.equal(i1[0], ids[i]) and torch.equal(d1[0], d2[i])
        its.append(c1["beam.iterations"])
    assert counts["beam.iterations"] == max(its)
    assert counts["beam.live_lanes"] == sum(its)


# -- a model of the kernel's algorithm against the loop ----------------------

def _kernel_model(packed, q, e_d2, e_ids, ef, max_iters, ring, forbid=None):
    """``csrc/beam_packed.cu``'s walk in Python, query by query: returns
    (d2, ids, iterations, tally) like the loop's."""
    n, w = packed.shape
    b, d = q.shape
    cap = w // (d + 12)
    k0 = e_ids.shape[1]
    out_d2 = torch.empty((b, ef))
    out_ids = torch.empty((b, ef), dtype=torch.int32)
    tally = [0] * (1 + 2 * cap)
    most = 0
    for qi in range(b):
        ents = [(float(e_d2[qi, i]), PAD_ID if int(e_ids[qi, i]) == PAD_ID
                 else 2 * int(e_ids[qi, i]), i) for i in range(k0)]
        beam = [(dv, pv) for dv, pv, _ in sorted(ents)[:ef]]
        beam += [(math.inf, PAD_ID)] * (ef - len(beam))
        rbuf = [int(e_ids[qi, i]) if i < k0 else PAD_ID for i in range(ring)]
        forb = -1 if forbid is None else int(forbid[qi])
        head = it = 0
        while it < max_iters:
            first = next((i for i, (_, pv) in enumerate(beam)
                          if pv != PAD_ID and pv % 2 == 0), ef)
            if first >= ef:
                break
            cand = beam[first][1] >> 1
            last = first
            while last + 1 < ef and beam[last + 1] == beam[first]:
                last += 1
            beam[last] = (beam[last][0], beam[last][1] | 1)
            nbrs, vecs = tsearch.unpack_rows(
                packed[min(max(cand, 0), n - 1)], cap, d)
            nd2 = ((q[qi][None, :] - vecs) ** 2).sum(-1)
            head = (head - cap) % ring
            ids_in_beam = {pv >> 1 for _, pv in beam if pv != PAD_ID}
            nb = [int(v) for v in nbrs]
            valid = [v >= 0 and v != forb for v in nb]
            new = [ok and v not in ids_in_beam and v not in rbuf
                   for v, ok in zip(nb, valid)]
            for s in range(cap):  # the ring is written after the test
                rbuf[(head + s) % ring] = nb[s] if new[s] else PAD_ID
                tally[1 + s] += valid[s]
                tally[1 + cap + s] += new[s]
            fresh = sorted((float(nd2[s]), 2 * nb[s])
                           for s in range(cap) if new[s])
            merged = [None] * ef
            for i, key in enumerate(beam):
                dest = i + sum(1 for f in fresh if f < key)
                if dest < ef:
                    merged[dest] = key
            for j, key in enumerate(fresh):
                dest = j + sum(1 for k in beam if k <= key)
                if dest < ef:
                    merged[dest] = key
            beam = merged
            it += 1
        most = max(most, it)
        tally[0] += it
        out_d2[qi] = torch.tensor([dv for dv, _ in beam])
        out_ids[qi] = torch.tensor([PAD_ID if pv == PAD_ID else pv >> 1
                                    for _, pv in beam], dtype=torch.int32)
    return out_d2, out_ids, most, tally


@pytest.mark.parametrize("ef,max_iters,k0,ring,forbid", [
    (24, 40, 5, 0, False), (16, 6, 3, 0, True), (40, 120, 64, 0, False),
    (20, 30, 4, 100, True), (12, 25, 30, 20, False)])
def test_kernel_model_gives_the_loop_beams_and_tallies(ef, max_iters, k0,
                                                       ring, forbid):
    """Duplicate entries, forbid, k0 above ef and above the ring, a ring
    that is no multiple of cap and a cut walk: exact data, so the model
    and the loop must agree to the bit."""
    codes, scales, adj, q = _graph(2, 700, 16, 16, 9, exact=True)
    packed = tsearch.pack_layer(adj, codes, scales)
    e_d2, e_ids = _entries(q, codes, scales, k0, seed=k0)
    fb = adj[:9, 1].clamp(min=0) if forbid else None
    ring_size = ring or max(2 * 16, 64)
    d2, ids, counts = _loop(packed, q, e_d2, e_ids, ef, max_iters, ring, fb)
    md2, mids, most, tally = _kernel_model(packed, q, e_d2, e_ids, ef,
                                           max_iters, ring_size, fb)
    assert torch.equal(mids, ids)
    assert torch.equal(md2, d2)
    assert counts == {"beam.iterations": most, "beam.live_lanes": tally[0],
                      "beam.rows_fetched": sum(tally[1:17]),
                      "beam.rows_new": sum(tally[17:])}


# -- the dispatch ------------------------------------------------------------

@pytest.mark.parametrize("expand_e", [1, 2, 4])
def test_cpu_and_wide_pops_take_the_loop(expand_e):
    codes, scales, adj, q = _graph(3, 600, 16, 16, 8, exact=True)
    packed = tsearch.pack_layer(adj, codes, scales)
    e_d2, e_ids = _entries(q, codes, scales, 6, seed=3)
    launches = beam_kernel.beam_packed.launches
    got = tsearch.search_layer_packed(packed, q, e_d2, e_ids, 16, 30,
                                      expand_e=expand_e)
    want = tsearch._search_layer_packed_loop(packed, q, e_d2, e_ids, 16, 30,
                                             expand_e=expand_e)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert beam_kernel.beam_packed.launches == launches
    assert "beam.kernel_calls" not in counters()
    assert counters()["beam.iterations"] > 0


@pytest.mark.parametrize("route", ["seeded", "probe_packed"])
def test_cpu_serving_routes_take_the_loop(route):
    rng = np.random.default_rng(4)
    x = (rng.random((16, 16))[rng.integers(0, 16, 2000)]
         + rng.normal(0, 0.05, (2000, 16))).astype(np.float32)
    idx = HNSW(8, ef_cons=32, dim=16, device="cpu")
    idx.insert_bulk(x, cluster_build=True,
                    cluster_kwargs=dict(pool_p=16, points_per_cluster=32,
                                        fanout=3, select_alg4=False,
                                        merge_slots=16))
    if route == "seeded":
        idx.finalize(pivots=128)
    else:
        idx.finalize(pivots=128, pivot_shortlist=32)
        idx.serve_probes = 4
    assert idx.serving_route() == route
    reset_spans()
    idx.ann_batch(x[:20], 10, 24)
    assert "beam.kernel_calls" not in counters()
    assert counters()["beam.iterations"] > 0


@pytest.mark.parametrize("shape,ok", [
    ((1000, 48, 128, 16, 96, 1), True),
    ((5_000_000, 48, 96, 384, 96, 10_000), True),
    ((1000, 128, 768, 4096, 8192, 4), True),
    ((1000, 129, 96, 16, 258, 4), False),
    ((1000, 48, 769, 16, 96, 4), False),
    ((1000, 48, 96, 4097, 96, 4), False),
    ((1000, 48, 96, 16, 47, 4), False),
    ((1000, 48, 96, 16, 8193, 4), False),
    ((1000, 48, 96, 16, 96, 0), True),
    ((2**30, 48, 96, 16, 96, 4), False)])
def test_kernel_limits(shape, ok):
    """Shapes past the kernel's limits raise ValueError before anything
    else is looked at; shapes within them get as far as the device check
    (TypeError on the CPU). The rows are views of one row: no memory."""
    n, cap, d, ef, ring, b = shape
    packed = torch.zeros((1, cap * (d + 12)), dtype=torch.uint8).expand(n, -1)
    q = torch.zeros((b, d))
    e_d2, e_ids = torch.zeros((b, 1)), torch.zeros((b, 1), dtype=torch.int32)
    with pytest.raises(TypeError if ok else ValueError):
        beam_kernel.beam_packed(packed, q, e_d2, e_ids, ef, 10, ring)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(dev, n, d, cap, ef, max_iters, b, forbid, exact, seed):
    codes, scales, adj, q = _graph(seed, n, d, cap, b, exact)
    k0 = min(ef, 64)
    e_d2, e_ids = _entries(q, codes, scales, k0, seed=seed + 1)
    packed = tsearch.pack_layer(adj.to(dev), codes.to(dev), scales.to(dev))
    # forbid the first neighbour of each row's best seed: one the walk meets
    fb = (adj[e_ids[:, 0].clamp(0, n - 1).long(), 0].clamp(0, n - 1).to(dev)
          if forbid else None)
    q, e_d2, e_ids = q.to(dev), e_d2.to(dev), e_ids.to(dev)
    d2, ids, counts = _loop(packed, q, e_d2, e_ids, ef, max_iters, 0, fb)
    launches = beam_kernel.beam_packed.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        kd2, kids = tsearch.search_layer_packed(packed, q, e_d2, e_ids, ef,
                                                max_iters, forbid=fb)
    torch.cuda.synchronize()
    assert beam_kernel.beam_packed.launches == launches + 1
    (beam,) = [r for r in traced_spans() if r["name"] == "hnsw.search.beam"]
    kcounts = dict(beam["counts"])
    assert kcounts.pop("beam.kernel_calls") == 1
    if fb is not None:  # never entered from a row (an entry may hold it)
        entered = (kids == fb[:, None]) & ~(e_ids == fb[:, None]).any(
            1, keepdim=True)
        assert not bool(entered.any())
    return codes.to(dev), scales.to(dev), q, (d2, ids, counts), (kd2, kids, kcounts)


CARD_CASES = [  # n, d, cap, ef, max_iters, b, forbid
    (20_000, 128, 48, 16, 8, 4096, False),    # the batch cell's walk
    (20_000, 128, 48, 16, 8, 1, False),       # the online cell's
    (20_000, 96, 48, 384, 500, 4096, False),  # the probed cell's
    (20_000, 96, 48, 384, 500, 257, True),
    (20_000, 128, 24, 64, 500, 257, True),    # cap < 32: ring 64
    (8_000, 300, 32, 64, 3, 257, False),      # d >= 300, cut short
    (20_000, 96, 48, 64, 40, 1, True),
    (20_000, 128, 48, 384, 20, 257, False),   # cut short at ef 384
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_beam_kernel_equals_loop_on_exact_data(dev, case):
    n, d, cap, ef, max_iters, b, forbid = case
    _, _, _, (d2, ids, counts), (kd2, kids, kcounts) = _card_case(
        dev, n, d, cap, ef, max_iters, b, forbid, True, seed=ef + d)
    assert torch.equal(kids, ids)
    assert torch.equal(kd2, d2)
    assert kcounts == counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_beam_kernel_matches_loop_on_float_data(dev, case):
    n, d, cap, ef, max_iters, b, forbid = case
    codes, scales, q, (d2, ids, counts), (kd2, kids, kcounts) = _card_case(
        dev, n, d, cap, ef, max_iters, b, forbid, False, seed=ef + d + 7)
    real = ids != PAD_ID
    x = dequantize(codes[torch.where(real, ids, 0).long()],
                   scales[torch.where(real, ids, 0).long()])
    mag = (q * q).sum(-1, keepdim=True) + (x * x).sum(-1)
    tol = torch.where(real, 1e-6 * d2.abs() + 1e-7 * mag, 0.0)
    both_inf = torch.isinf(d2) & torch.isinf(kd2)
    close = ((kd2 - d2).abs() <= tol) | both_inf
    diff = kids != ids
    # a differing slot holds two ids whose d2 the loop's arithmetic puts
    # within the tolerance of each other
    safe_k = torch.where(kids != PAD_ID, kids, 0).long()
    xk = dequantize(codes[safe_k], scales[safe_k])
    loop_d2_k = ((q[:, None, :] - xk) ** 2).sum(-1)
    tie = close & ((loop_d2_k - d2).abs() <= tol)
    bad = (~close | (diff & ~tie)).any(1)
    print(f"{case}: {int(diff.sum())} near-tie slots in "
          f"{int(diff.any(1).sum())} of {b} rows, {int(bad.sum())} rows "
          f"apart; counts {kcounts} vs {counts}")
    assert int(bad.sum()) <= b // 4096
    if not bool(diff.any()):
        assert kcounts == counts
    for key, want in counts.items():
        assert abs(kcounts[key] - want) <= 1e-4 * want


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["seeded", "probe_packed"])
def test_serving_routes_count_one_kernel_call_per_beam(dev, route):
    rng = np.random.default_rng(5)
    x = (rng.random((64, 32))[rng.integers(0, 64, 20_000)]
         + rng.normal(0, 0.05, (20_000, 32))).astype(np.float32)
    idx = HNSW(12, ef_cons=48, dim=32, device=dev)
    idx.insert_bulk(x, cluster_build=True,
                    cluster_kwargs={"select_alg4": False})
    if route == "seeded":
        idx.finalize(pivots=512)
    else:
        idx.finalize(pivots=512, pivot_shortlist=32)
        idx.serve_probes = 6
    assert idx.serving_route() == route
    reset_spans()
    launches = beam_kernel.beam_packed.launches
    for b in (1, 300, 2000):
        idx.ann_batch(x[:b], 10, 48)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        idx.ann_batch(x[:500], 10, 48)
    beams = [r for r in traced_spans() if r["name"] == "hnsw.search.beam"]
    assert len(beams) == 1 and beams[0]["counts"]["beam.kernel_calls"] == 1
    assert counters()["beam.kernel_calls"] == 4
    assert beam_kernel.beam_packed.launches == launches + 4
    occupancy = beams[0]["counts"]["beam.live_lanes"] / (
        beams[0]["counts"]["beam.iterations"] * 500)
    assert 0 < occupancy <= 1


@pytest.mark.cuda
def test_empty_batch_launches_nothing(dev):
    codes, scales, adj, q = _graph(6, 500, 32, 16, 1, exact=True)
    packed = tsearch.pack_layer(adj.to(dev), codes.to(dev), scales.to(dev))
    q0 = q[:0].to(dev)
    e_d2 = torch.zeros((0, 4), device=dev)
    e_ids = torch.zeros((0, 4), dtype=torch.int32, device=dev)
    launches = beam_kernel.beam_packed.launches
    got = tsearch.search_layer_packed(packed, q0, e_d2, e_ids, 16, 10)
    want = tsearch._search_layer_packed_loop(packed, q0, e_d2, e_ids, 16, 10)
    assert beam_kernel.beam_packed.launches == launches
    for g, w in zip(got, want):
        assert g.shape == w.shape == (0, 16) and g.dtype == w.dtype and g.is_cuda
