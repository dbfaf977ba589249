"""Smoke run of the PyTorch port (``hnsw_rs_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each with its time:

1. device: requires CUDA, prints the card's name and power limit and pins
   float32 matrix products (both TF32 switches off);
2. build: compiles every kernel from ``hnsw_rs_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together, and counts the tensor-core
   instructions (``IGMMA``/``HGMMA``/``IMMA``) in each library's SASS;
3. kernel vs plain on the card: ``group_min_d2`` (K2) against
   ``group_min_d2_plain`` at B=256, N=262,144, d=96 (d2 within
   1e-5 * d2 + 2e-6 * (|q|^2 + |x|^2), rows equal except ties inside that
   bound, counted), ``flat_topk_fused`` both ways (ids equal), and
   quantization codes on the card equal to the CPU's;
4. ``pairwise_l2sq_kernel`` (K1), the counterpart of the JAX package's
   ``pairwise_l2sq_pallas``, through its own entry point at B=1,024,
   N=1M, d=96; that output and a ``fast=True`` one, each whole, against
   ``pairwise_l2sq_plain`` on the same inputs, and the same at the
   unaligned B=70, N=300, d=50: error within 2e-6 of |q|^2 + |x|^2; and
   ``torch.cdist`` on the dequantized points timed beside it as a
   yardstick (the port never calls it);
5. the cluster path at ``bench.py``'s configuration: a cluster-bulk build
   of N=1M, d=96 synthetic clustered points (M=24, ef_cons=128),
   ``finalize(pivots=16384)``, exact ground truth for 4,096 queries
   through ``FlatIndex.search(fused=True)`` (K2), the (ef, max_iters)
   ladder until recall@10 >= 0.99, and timed QPS over 32,768 queries;
6. the wave path at ``benchmarks/bench_wave_quality.py``'s configuration:
   a wave build of the same 1M points (M=16, ef_cons=96, the default
   wave schedule, packed build), hierarchical-descent ``ann_batch``
   without ``finalize`` over an ef ladder until recall@10 >= 0.99 on the
   packed branch, timed QPS over 32,768 queries, where the build's time
   went (its stages over all waves, and one real 4,096-node wave again
   under the profiler) and where a serving batch's goes, then 2,048
   ``insert_vec`` calls, self-recall of the inserted points, ground
   truth over N + 2,048 points (K2) and recall@10 >= 0.99 on the plain
   branch;
7. the probed path at ``benchmarks/bench_second_regime.py``'s
   configuration, not cut: heavy-tailed 1M x 96 points, the cluster
   build, ground truth of 1,024 queries through K2,
   ``finalize(pivots=32768, pivot_cover=0.5, pivot_shortlist=256)`` with
   36 probes; the (ef, max_iters) ladder to the first rung with
   recall@10 >= 0.99 for the probe-packed route (through ``ann_batch``;
   it must clear one), the narrow probe route and the plain seeded
   route, each route's QPS over 32,768 queries and bytes/point, one
   probed batch by stage in CUDA events (seeds, the probe kernel K4,
   the beam); then ``refine(rounds=1)``, its
   seconds and the seeded route's recall at the first rungs before and
   after;
8. on the cluster path's index: ``finalize(expand=4)`` beside E=1 at the
   same rung, and PQ serving at (24 bytes, 4 bits) and (48 bytes, 8
   bits): training and packing seconds, recall at ef 64, 128, 256 (the
   run fails under 0.5), QPS, bytes/point;
9. the wave build's options at N=65,536 (M=16, ef_cons=96): a default
   build and one each with ``wave_sort``, ``build_seeded`` and
   ``build_expand=2``: seconds and recall@10 at ef=128, each >= 0.95;
10. ``python -m hnsw_rs_tpu_torch.eval_glove --device cuda`` on the
   bundled ``test-data``: the GloVe gate on the card, then ``--model
   ivf`` and ``--model pq`` on the same data;
11. IVF-Flat at ``benchmarks/bench_families.py``'s configuration, not
   cut: the cluster path's 1M points and K2 ground truth,
   ``IVFFlatIndex(96, n_lists=8196, kmeans_iters=6)``, the probe ladder to
   the first rung with recall@10 >= 0.99 (it must clear one), QPS over
   32,768 queries through ``search``, bytes/point, build seconds by phase,
   one batch by stage in CUDA events; then 2,048 points added in one
   batch (ground truth over N + 2,048 through K2) and ``save`` -> ``load``
   -> the same ids;
12. IVF-PQ at the same source's: ``IVFPQIndex(96, n_lists=8196, m_pq=24,
   kmeans_iters=6, rerank=40)``, the (probes, rerank) ladder (the run
   fails only under 0.9; ``gate_met`` says whether 0.99 was reached), QPS,
   bytes/point, build seconds by phase, one batch by stage;
13. out-of-core serving at ``benchmarks/bench_paged_hybrid.py``'s 200k
   contract, not cut: a wave build (M=16, ef_cons=96) of 200,000 x 96
   points, ``finalize(pivots=4096)``, ``save_paged``; the in-memory
   answers at ef=64; ``PagedHNSW``: QPS and parity; ``HybridPagedHNSW``
   with half the packed rows hot at ``expand_e`` 1 and 4: parity 1.0 with
   the in-memory seeded answers, hit rate, iterations; the PQ tier at
   (24 B, ef 64) and (48 B, ef 128); ``BlockStore.search_streaming`` equal
   to ``FlatIndex``;
14. the cosine metric at N=131,072: a wave build with ``metric="cosine"``,
   recall@10 >= 0.95 at ef=128 against ``FlatIndex(metric="cosine")``
   through K2; and the raw-float ``FlatIndex(quantized=False)`` against
   ``exact=True`` on 16,384 points;
15. on the cluster path's index, ``ReplicatedHNSW`` over ``[cuda:0]``:
   ids equal to the index's packed hierarchical route;
16. the scale-out layer (``parallel``): the cluster path's 1M points over
   8 shards on ``cuda:0`` (``ShardedHNSW(24, 96, 8, ef_cons=128)``, the
   concurrent cluster build), 65,536 pivots a shard, the (ef, max_iters)
   ladder to recall@10 >= 0.99 on the cluster path's truth, QPS, build
   seconds and QPS beside the single index's, device bytes/point; 2,048 ``add``s served on the plain route (truth over
   N + 2,048 through K2), ``save`` -> ``load`` -> the same ids, then
   seeded again; at N=65,536 over 4 shards on skewed bounds the
   concurrent wave build against the sequential one, ``rebalance`` and
   its recall; the rank form's ``all_gather`` merge on NCCL at world
   size 1 equal to the in-process ids.
17. the native host helpers (``native/``): both libraries built with
   ``g++`` (the run fails without them), the GloVe parse equal to
   Python's; then, with the kernel builds finished and nothing else
   running, the single-core C++ baseline on the host's CPU at
   ``bench.py:147-158``'s slice (the first 50,000 of the cluster path's
   points, M=24, ef_cons=128): build vec/s, QPS of 1,000 queries at ef=64
   one at a time, recall@10 against exact truth over the slice, ``nproc``
   and the CPU model;
18. in the paged path, before the hybrid tier's phases (which now take
   their cold rows from the native assembler): the same cold ids
   assembled natively and in numpy, bytes equal, ms a call of 128 rows;
19. on the cluster path's index after ``ReplicatedHNSW``:
   ``export_reference_index`` into ``build/`` and
   ``import_reference_index`` on the card: codes, scales, levels, params,
   every layer's rows and the recounted in-degree ledgers equal, and
   equal ids for 4,096 queries through the packed hierarchical route;
20. the ann-benchmarks protocol at ``glove-100-angular``'s shape (d=100,
   angular, 10,000 queries, k=10; N cut from 1,183,514 to 131,072): truth
   through ``FlatIndex(metric="cosine").search(fused=True)`` (K2),
   ``ANNBenchmarksFlat`` (recall >= 0.999), ``ANNBenchmarksHNSW(M=16,
   efConstruction=96)`` over ef 16...256 (recall and QPS a rung, the run
   fails under 0.95 at ef=256; ``get_memory_usage``) and
   ``ANNBenchmarksIVF(n_list=512)`` over probes 1...64; ``query`` equal to
   the first row of ``batch_query`` on each;
21. the entry points (``entry.py``, the twin of ``__graft_entry__.py``):
   ``entry("cuda")``'s step and its output
   shapes, then ``dryrun_multichip(8, "cuda")`` and its line.

Before the paths, the query limb split (the pre-pass K1 and K2 launch
ahead of their kernels) against ``ops/limbs.query_limbs``: limbs and
scale bit for bit, the two sums within 1e-6.

After the two paths, K2 again at the main path's shape (B=4,096,
N=1,000,064) against its plain version, with ``flat_topk_fused`` ids
held equal to the plain route's there too; then K3 (``ops.beam.beam_packed``,
the packed layer-0 beam in one launch) against ``_search_layer_packed_loop``
on the same card inputs at the cluster path's shape (32,768 queries at the
chosen rung), and again at the probed path's (its merged entries, its
rung): d2 within 1e-6 * d2 + 1e-7 * (|q|^2 + |x|^2), ids equal but for
near-ties inside that bound, and at most 1 in 4,096 rows apart (all
counted). K3's launches are counted on every path. On the probed path K4
(``ops.probe.probe_packed``, a query chunk's probe stage in one launch)
against its plain version ``search._probe_stage`` on the same seeds, each
in its own path's query chunks, at the chosen rung's ef and at the probed
cells' ef 384, to the same bound, each row beyond it differing only by
ids at the pool's s-th key (counted); K4's launches are counted on the
route's ladder and QPS runs alone. It prints the kernels' JSON
line (each kernel's time, plain and library times, the least time the
card could take for the same work, and its launches on each path), then
as its last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the exit
code is then not 0; without a CUDA device it exits non-zero at once.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N, D, K, M, EF_CONS, NQ, NQ_RECALL, PIVOTS = (
    1_000_000, 96, 10, 24, 128, 32768, 4096, 16384)
# the wave path: benchmarks/bench_wave_quality.py:40-68 (M=16, ef_cons=96)
# cut to half the points: the four new phases share the command's time
WAVE_N, WAVE_M, WAVE_EF_CONS, N_INSERT = 524_288, 16, 96, 2048
WAVE_LADDER = [16, 24, 32, 48, 64, 96, 128, 192, 256]
K1_B, K1_TOL = 1024, 2e-6  # K1 error bound, relative to |q|^2 + |x|^2
# K2: d2 within K2_RTOL * d2 + K1_TOL * (|q|^2 + |x|^2); rows equal but for ties
K2_RTOL = 1e-5
# H100 SXM peaks (NVIDIA's data sheet): int8 dense tensor rate, f32 CUDA-core
# rate, memory rate; the kernels' products are int8, one per query limb
INT8_OPS, F32_FLOPS, MEM_BPS = 1979e12, 67e12, 3.35e12
CLUSTER_KWARGS = {"pool_p": 96, "points_per_cluster": 96, "fanout": 5,
                  "select_alg4": False, "merge_slots": 48}
# cheapest (ef, max_iters) first, as bench.py:184-188
LADDER = [(16, 8), (24, 10), (24, 12), (32, 16), (40, 20), (40, 24),
          (48, 24), (48, 28), (48, 32), (64, 40), (64, 56), (96, 80),
          (128, 112), (192, 200), (256, 280)]
# the probed path: benchmarks/bench_second_regime.py:43-50,72-86,194-196
PROBE_PIVOTS, PROBE_COVER, PROBE_T, PROBES, PROBE_NQ_RECALL = (
    32768, 0.5, 256, 36, 1024)
PROBE_CELLS_EF = 384  # the probed cells' ef, where K4 is held again
PROBE_LADDER = [(40, 24), (40, 28), (48, 28), (48, 32), (64, 40), (64, 56),
                (96, 80), (128, 112), (192, 200), (256, 280), (384, 500),
                (512, 700)]
# PQ serving on the cluster index: benchmarks/bench_serving_memory.py:246-247
PQ_MODES = [(24, 4), (48, 8)]
PQ_EFS = [64, 128, 256]
OPT_N = 131072  # the cosine metric's wave build is driven at this depth
# the wave build's options and the sharded wave builds and rebalance: cut
# from OPT_N when the sharded phases joined, to keep the command in time
CUT_N = 65536
# IVF-Flat and IVF-PQ: benchmarks/bench_families.py:45-52,119,135,218,253
IVF_LISTS, IVF_ITERS = max(64, N // 122), 6
IVF_PROBES = [8, 16, 32, 64, 128, 256]
IVFPQ_M, IVFPQ_RERANK = 24, 40
IVFPQ_LADDER = [(8, 40), (16, 40), (16, 100), (16, 200), (16, 400)]
# out-of-core serving: benchmarks/bench_paged_hybrid.py:206-207,219,229,
# 250-251,279-282 (the 200k contract)
PAGED_N, PAGED_NQ, PAGED_EF, PAGED_PIVOTS, PAGED_CACHE = 200_000, 256, 64, 4096, 4096
PAGED_PQ = [(24, 64), (48, 128)]  # (pq_m at 4 bits, ef)
RAW_N = 16384  # the raw-float FlatIndex against its exact form
# the sharded path: bench.py's configuration over 8 shards on one card
# (benchmarks/SHARDED_SCALING.json's widest row, dryrun_multichip(8)); the
# pivot budget a shard, over the cluster path's (ef, max_iters) ladder.
# The single index's 16,384 split eight ways (2,048 a shard) is not
# driven: a shard holds ~12 points of each of the data's 10,000 clusters,
# its layer 0 is not one component, and a cluster without a pivot is
# seldom reached. On an H100 (PERF.md), 2,048 a shard reached recall@10
# 0.9293 at (512, 700); 32,768 cleared only at (256, 280), 0.9908, 1,629
# QPS; 65,536 clears at (96, 80), 0.9906, then 0.9924 and 0.9952 at the
# next two rungs, at 5,868 QPS
SHARDS, OPT_SHARDS, PLAIN_EF = 8, 4, 128
SHARD_PIVOTS = 65536
OPT_SPLIT = [0.0, 0.3, 0.55, 0.8, 1.0]
# the single-core C++ baseline on bench.py:147-158's slice of the cluster
# path's points (the whole 1M would take hours on one core)
BASE_N, BASE_NQ, BASE_EF = 50_000, 1000, 64
# the paged tier's cold-row assembly: calls of ~an E=1 iteration's cold rows
ASSEMBLY_ROWS, ASSEMBLY_CALLS = 128, 40
# ann-benchmarks at the shape of its glove-100-angular set (d=100, angular,
# 10,000 queries, k=10), N cut from 1,183,514 for the clock
ANNB_N, ANNB_D, ANNB_NQ = 131_072, 100, 10_000
ANNB_EFS = [16, 32, 64, 128, 256]  # hnsw_rs_tpu/annb.py:20-26's query-args
ANNB_PROBES = [1, 2, 4, 8, 16, 32, 64]
LIMB_SRC = "hnsw_rs_tpu_torch/csrc/dist_core.cuh"
KERNEL_SRC = "hnsw_rs_tpu_torch/csrc/group_min.cu"
KERNEL_REPLACES = "hnsw_rs_tpu/ops/pallas/l2_groupmin.py:78"
K1_SRC = "hnsw_rs_tpu_torch/csrc/l2_kernel.cu"
K1_REPLACES = "hnsw_rs_tpu/ops/pallas/l2_kernel.py:66"
# K3 replaces no TPU kernel: the JAX package's lax.while_loop of the beam
K3_SRC = "hnsw_rs_tpu_torch/csrc/beam_packed.cu"
K3_REPLACES = "hnsw_rs_tpu/search.py:327"
# K3: d2 within K3_RTOL * d2 + K3_ATOL * (|q|^2 + |x|^2) of the plain loop's;
# ids equal but for near-ties inside that bound (counted); walks that a
# near-tie sends apart (counted) at most 1 in K3_APART rows
K3_RTOL, K3_ATOL, K3_APART = 1e-6, 1e-7, 4096
# K4 replaces no TPU kernel: the JAX package leaves the probe stage to XLA
K4_SRC = "hnsw_rs_tpu_torch/csrc/probe_packed.cu"
K4_REPLACES = "hnsw_rs_tpu/search.py:_top_ef_dedup_oversampled"


def phase(name, t0, **kv):
    dt = time.perf_counter() - t0
    extra = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[phase] {name} {dt:.3f}s {extra}".rstrip(), flush=True)
    return time.perf_counter()


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the card (CUDA events, one warm-up)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_profile(fn):
    """(device busy share of one call's wall time, top kernels by device
    ms) from torch.profiler; ("not measured", []) when the profiler
    records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - ts) * 1e6
    per_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            per_name[e.name] = per_name.get(e.name, 0.0) + us
    if not per_name:
        return "not measured", []
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    busy = f"{sum(per_name.values()) / wall_us:.3f}"
    return busy, [[name[:60], round(us / 1000, 3)] for name, us in top]


def recall_at(ids, truth):
    return float(np.mean([len(set(a) & set(t)) / K for a, t in zip(ids, truth)]))


def fn_qps(fn, nq):
    """QPS of ``fn()`` (one batch of ``nq`` queries per call; one warm
    call, then at least 3 calls and 3 s, device drained at the end)."""
    fn()
    torch.cuda.synchronize()
    reps, ts = 0, time.perf_counter()
    while reps < 3 or time.perf_counter() - ts < 3.0:
        fn()
        reps += 1
    torch.cuda.synchronize()
    return nq * reps / (time.perf_counter() - ts), reps


def timed_qps(index, queries, ef, max_iters=None):
    """End-to-end QPS of ``ann_batch`` over ``queries`` (numpy in, numpy
    out), timed as :func:`fn_qps` does."""
    return fn_qps(lambda: index.ann_batch(queries, K, ef, max_iters=max_iters),
                  len(queries))


def first_rung(fn, ladder, queries, truth, label):
    """Walk ``ladder`` until ``fn(queries, ef, mi)`` (ids as numpy) reaches
    recall@10 >= 0.99; returns (ef, mi, recall, gate_met, ids), the last
    rung tried when none clears."""
    for ef, mi in ladder:
        ids = fn(queries, ef, mi)
        rec = recall_at(ids, truth)
        print(f"  {label} ef={ef} max_iters={mi} recall@10={rec:.4f}", flush=True)
        if rec >= 0.99:
            return ef, mi, rec, True, ids
    return ef, mi, rec, False, ids


def event_ms(stages):
    """Run ``stages`` (name, fn) in order on the stream; returns
    {name: ms} by CUDA events, a repeated name's times summed."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
    marks[0].record()
    for i, (_, fn) in enumerate(stages):
        fn()
        marks[i + 1].record()
    torch.cuda.synchronize()
    out = {}
    for i, (name, _) in enumerate(stages):
        out[name] = out.get(name, 0.0) + marks[i].elapsed_time(marks[i + 1])
    return out


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the int8 tensor work over its
    peak and the bytes over the memory rate."""
    t_ops, t_bytes = ops / INT8_OPS * 1e3, nbytes / MEM_BPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k2_check(q, codes, scales, normsq, kd, ki, pd, pi):
    """Holds K2's group minima (kd, ki) to the plain version's (pd, pi):
    d2 within K2_RTOL * d2 + K1_TOL * (|q|^2 + |x|^2), and a row that
    differs must be a tie, the plain d2 of both rows inside that bound.
    Returns (rows that differ, max abs d2 error); raises otherwise."""
    mag = (q * q).sum(dim=1, keepdim=True) + normsq[ki.long()]
    tol = K2_RTOL * pd.abs() + K1_TOL * mag
    err = (kd - pd).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"group_min_d2 d2 off by up to {float(err.max())}")
    diff = ki != pi
    bs = diff.nonzero()[:, 0]

    def plain_d2(rows):
        r = rows.long()
        dot = (q[bs] * codes[r].float()).sum(dim=1)
        qdotx = scales[r, 1] * dot + scales[r, 0] * q[bs].sum(dim=1)
        return torch.clamp_min((q[bs] * q[bs]).sum(dim=1) + normsq[r] - 2.0 * qdotx, 0.0)

    gap = (plain_d2(ki[diff]) - plain_d2(pi[diff])).abs()
    if not bool((gap <= tol[diff]).all()):
        raise AssertionError(f"group_min_d2 rows differ outside ties: "
                             f"{int((gap > tol[diff]).sum())} groups")
    return int(diff.sum()), float(err.max())


def near_ties(q, codes, scales, pd2, pids, kd2, kids):
    """Holds a kernel's sorted (d2, ids) rows to its plain version's: d2
    within K3_RTOL * d2 + K3_ATOL * (|q|^2 + |x|^2), ids equal but for
    near-ties inside that bound: where the ids of a slot differ, the plain
    row's own d2 of the kernel's id (a seed's is the matmul form's; an id
    the plain row lacks is scored here) lies within it of the slot's.
    Returns (near-tie slots, the rows apart, max abs d2 error where the ids
    agree)."""
    from hnsw_rs_tpu_torch.ops.quant import dequantize
    from hnsw_rs_tpu_torch.ops.topk import PAD_ID

    ties, apart = 0, []
    err = 0.0
    for lo in range(0, q.shape[0], 256):
        d2, ids = pd2[lo:lo + 256], pids[lo:lo + 256]
        kd, ki, qq = kd2[lo:lo + 256], kids[lo:lo + 256], q[lo:lo + 256]
        real = ids != PAD_ID
        safe = torch.where(real, ids, 0).long()
        x = dequantize(codes[safe], scales[safe])
        mag = (qq * qq).sum(-1, keepdim=True) + (x * x).sum(-1)
        tol = torch.where(real, K3_RTOL * d2.abs() + K3_ATOL * mag, 0.0)
        both_inf = torch.isinf(d2) & torch.isinf(kd)
        close = ((kd - d2).abs() <= tol) | both_inf
        diff = ki != ids
        safe_k = torch.where(ki != PAD_ID, ki, 0).long()
        xk = dequantize(codes[safe_k], scales[safe_k])
        same_id = ki[:, :, None] == ids[:, None, :]
        own = torch.where(same_id, d2[:, None, :], float("inf")).amin(-1)
        ref = torch.where(same_id.any(-1), own,
                          ((qq[:, None, :] - xk) ** 2).sum(-1))
        tie = close & ((ref - d2).abs() <= tol)
        ties += int(diff.sum())
        bad = (~close | (diff & ~tie)).any(1)
        apart += (torch.nonzero(bad).flatten() + lo).tolist()
        same = ~diff & real
        if bool(same.any()):
            err = max(err, float((kd - d2).abs()[same].max()))
    return ties, apart, err


def off_the_s_key(sl_pack, t, q, e_d2, e_ids, pos, ef, probes, codes, scales,
                  pd2, pids, kd2, kids, rows):
    """Of K4's rows apart from its plain version, those that a distance
    moved across the pool's s-th key (s = min(4 * ef, pool width)) by its
    order of summation does not explain: rows whose ids differ as sets by
    more than ids whose plain pool d2 lies within ``near_ties``' bound of
    that key, whose common ids' d2 differ beyond it, or whose kernel row is
    unsorted or repeats an id. Such a move changes
    which distinct ids survive the oversampled reduce (the duplicates of
    one id count toward s), so a row can gain or lose its last survivor.
    Returns those rows."""
    from hnsw_rs_tpu_torch import search
    from hnsw_rs_tpu_torch.ops.quant import dequantize
    from hnsw_rs_tpu_torch.ops.topk import PAD_ID

    if not rows:
        return []
    r = torch.tensor(rows, device=q.device)
    qr, d = q[r], q.shape[1]
    pool_d2, pool_ids = [e_d2[r]], [e_ids[r]]
    for i in range(min(probes, pos.shape[1])):
        d2_i, ids_i = search._score_probe_packed(sl_pack, t, d, qr, pos[r, i])
        pool_d2.append(torch.where(ids_i >= 0, d2_i, float("inf")))
        pool_ids.append(torch.where(ids_i >= 0, ids_i, PAD_ID))
    pool_d2, pool_ids = torch.cat(pool_d2, 1), torch.cat(pool_ids, 1)
    key = pool_d2.kthvalue(min(4 * ef, pool_d2.shape[1]), dim=1).values.tolist()
    qq = (qr * qr).sum(-1).tolist()
    left = []
    for j, row in enumerate(rows):
        plain = {i: v for i, v in zip(pids[row].tolist(), pd2[row].tolist())
                 if i != PAD_ID}
        kern = {i: v for i, v in zip(kids[row].tolist(), kd2[row].tolist())
                if i != PAD_ID}
        ids = sorted(set(plain) | set(kern))
        x = dequantize(*(a[torch.tensor(ids, device=q.device).long()]
                         for a in (codes, scales)))
        xx = dict(zip(ids, (x * x).sum(-1).tolist()))
        krow = kd2[row]
        ok = (bool((krow[1:] >= krow[:-1]).all())
              and len(kern) == int((kids[row] != PAD_ID).sum()))
        for i in ids:
            if i in plain and i in kern:
                ok &= abs(kern[i] - plain[i]) <= (K3_RTOL * plain[i]
                                                  + K3_ATOL * (qq[j] + xx[i]))
            else:
                m = float(pool_d2[j][pool_ids[j] == i].min())
                ok &= abs(m - key[j]) <= K3_RTOL * key[j] + K3_ATOL * (qq[j] + xx[i])
        if not ok:
            left.append(row)
    return left


def k3_check(packed, q, e_d2, e_ids, ef, mi, codes, scales, label):
    """Holds the beam kernel (``ops.beam.beam_packed``) to its plain
    version (``search._search_layer_packed_loop``) on the same card
    inputs, times both and bounds the kernel by the row bytes of the
    expansions it tallied. Returns a dict for the kernels line."""
    from hnsw_rs_tpu_torch import search
    from hnsw_rs_tpu_torch.ops import beam

    b, d = q.shape
    cap = packed.shape[1] // (d + 12)
    ring = search._default_ring(cap, 1)
    tally = torch.zeros(1 + 2 * cap, dtype=torch.int64, device=q.device)
    kd2, kids, iters = beam.beam_packed(packed, q, e_d2, e_ids, ef, mi, ring,
                                        None, tally)
    pd2, pids = search._search_layer_packed_loop(packed, q, e_d2, e_ids, ef, mi)
    torch.cuda.synchronize()
    ties, apart, err = near_ties(q, codes, scales, pd2, pids, kd2, kids)
    apart = len(apart)
    if apart > b // K3_APART:
        raise AssertionError(f"beam kernel ({label}): {apart} of {b} rows apart "
                             "from the plain loop")
    ms = cuda_ms(lambda: beam.beam_packed(packed, q, e_d2, e_ids, ef, mi, ring), 5)
    plain_ms = cuda_ms(lambda: search._search_layer_packed_loop(
        packed, q, e_d2, e_ids, ef, mi), 1)
    expansions = int(tally[0])
    nbytes = expansions * cap * (d + 12) + b * (d * 4 + e_ids.shape[1] * 8 + ef * 8)
    return {"B": b, "d": d, "cap": cap, "ef": ef, "max_iters": mi,
            "iterations": int(iters), "expansions": expansions,
            "near_tie_slots": ties, "rows_apart": apart, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / MEM_BPS * 1e3}


def k4_check(sl_pack, t, piv_ids, piv_vecs, q, ef, probes, codes, scales):
    """Holds the probe kernel (``ops.probe.probe_packed``) to its plain
    version (``search._probe_stage``) on the same card inputs and seeds,
    each in the query chunks its own path takes: ``near_ties``' bound, and
    each row beyond it explained by a distance at the pool's s-th key
    (``off_the_s_key``; counted); times both and bounds the kernel by the
    shortlist rows it gathers. Returns a dict for the kernels line."""
    from hnsw_rs_tpu_torch import search
    from hnsw_rs_tpu_torch.ops import probe

    b, d = q.shape
    p = int(piv_ids.shape[0])

    def chunks(kernel):
        step = search._query_chunk(b, search._probe_bytes_per_query(
            t, d, p, ef, probes, packed=True, kernel=kernel), q.device)
        return [slice(lo, lo + step) for lo in range(0, b, step)]

    k_chunks, p_chunks = chunks(True), chunks(False)
    e_d2, e_ids, pos = (torch.cat(x) for x in zip(*[
        search._pivot_seeds_pos(piv_ids, piv_vecs, q[c], ef) for c in k_chunks]))

    def kernel():
        return [probe.probe_packed(sl_pack, t, q[c], e_d2[c], e_ids[c], pos[c],
                                   ef, probes) for c in k_chunks]

    def plain():
        return [search._probe_stage(
            lambda qc, pp: search._score_probe_packed(sl_pack, t, d, qc, pp),
            q[c], e_d2[c], e_ids[c], pos[c], ef, probes) for c in p_chunks]

    kd2, kids = (torch.cat(x) for x in zip(*kernel()))
    pd2, pids = (torch.cat(x) for x in zip(*plain()))
    torch.cuda.synchronize()
    ties, apart, err = near_ties(q, codes, scales, pd2, pids, kd2, kids)
    left = off_the_s_key(sl_pack, t, q, e_d2, e_ids, pos, ef, probes, codes,
                         scales, pd2, pids, kd2, kids, apart)
    if left:
        raise AssertionError(f"probe kernel at ef {ef}: {len(left)} of {b} rows "
                             f"apart from the plain stage (rows {left[:8]})")
    rows = b * min(probes, pos.shape[1])
    return {"B": b, "d": d, "T": t, "ef": ef, "probes": probes,
            "launches": len(k_chunks), "plain_chunks": len(p_chunks),
            "rows_differ": int((kids != pids).any(1).sum()),
            "near_tie_slots": ties, "rows_at_s_key": len(apart),
            "rows_apart": len(left), "max_abs_err": err,
            "ms": cuda_ms(kernel, 5), "plain_ms": cuda_ms(plain, 1),
            "bound_ms": rows * t * (d + 12) / MEM_BPS * 1e3}


def sass_counts(lib):
    """Tensor-core instructions in the library's SASS (cuobjdump): int8
    warpgroup products (IGMMA), other warpgroup products (HGMMA) and warp
    products (IMMA)."""
    from hnsw_rs_tpu_torch.ops import cuda_build

    nvcc = cuda_build._nvcc()
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return {op: sass.count(op) for op in ("IGMMA", "HGMMA", "IMMA")}


def k1_check(out, plain, q, codes, scales, normsq, fast):
    """Max abs error of K1's output ``out`` against its plain version
    ``plain`` on the same inputs, whole, and the max relative to
    |q|^2 + |x|^2; raises outside K1_TOL."""
    diff = (out - plain(q, codes, scales, normsq, fast)).abs_()
    abs_err = float(diff.max())
    diff /= (q * q).sum(dim=1)[:, None] + normsq[None, :]
    rel_err = float(diff.max())
    del diff
    torch.cuda.empty_cache()
    if rel_err > K1_TOL:
        raise AssertionError(f"pairwise_l2sq_kernel (fast={fast}) off by "
                             f"{rel_err} of |q|^2 + |x|^2")
    return abs_err, rel_err


def limb_check(limbs, q, fast):
    """Holds the on-card limb split of ``q`` to its plain version: limbs
    and scale bit for bit, |q|^2 and sum(q) within 1e-6 (of sum q^2 and
    sum |q|). Returns the largest relative error of the two sums."""
    kl, ks, kq, ksum = limbs.query_operands(q, fast)
    pl, ps, pq, psum = limbs.query_operands_plain(q, fast)
    torch.cuda.synchronize()
    if not (torch.equal(kl, pl) and torch.equal(ks, ps)):
        raise AssertionError(f"limb split differs from query_limbs at "
                             f"{tuple(q.shape)}, fast={fast}")
    tiny = torch.finfo(torch.float32).tiny
    err = max(float(((kq - pq).abs() / pq.clamp_min(tiny)).max()),
              float(((ksum - psum).abs()
                     / q.abs().sum(dim=1).clamp_min(tiny)).max()))
    if err > 1e-6:
        raise AssertionError(f"limb split sums off by {err} at {tuple(q.shape)}")
    return err


def probed_path(dev, t0):
    """The probed path at ``benchmarks/bench_second_regime.py``'s
    configuration (heavy-tailed 1M x 96, not cut), then ``refine``.
    Returns K2's launches on this path, K3's (before its own check), K3's
    check at this path's beam, K4's launches on the probe_packed route's
    ladder and QPS runs, and K4's checks at this path's probe stage (its
    rung's ef and the probed cells' ef 384)."""
    from hnsw_rs_tpu_torch import FlatIndex, HNSW, search
    from hnsw_rs_tpu_torch.ops import beam as beam_kernel
    from hnsw_rs_tpu_torch.ops import groupmin
    from hnsw_rs_tpu_torch.ops import probe as probe_kernel
    from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize
    from hnsw_rs_tpu_torch.utils.datasets import synthetic_heavy_tailed

    probe_kernel.probe_packed.launches = 0
    ht = synthetic_heavy_tailed(N, D, n_queries=NQ, seed=42)
    t0 = phase("probe_data", t0, n=N, d=D, queries=NQ)
    torch.cuda.reset_peak_memory_stats(dev)
    idx = HNSW(M, ef_cons=EF_CONS, dim=D, device=dev)
    idx.insert_bulk(ht.train, cluster_build=True, cluster_kwargs=CLUSTER_KWARGS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = phase("probe_build", t0, vec_per_s=f"{N / build_s:.1f}",
               layers=len(idx.graph))

    flat = FlatIndex(D, dev)
    flat.add(ht.train)
    gt_d, truth = flat.search(ht.test[:PROBE_NQ_RECALL], K, fused=True)
    del flat
    launches = groupmin.group_min_d2.launches
    if (launches < 1 or truth.shape != (PROBE_NQ_RECALL, K)
            or not np.all(np.isfinite(gt_d))):
        raise AssertionError("probed path: no group_min_d2 launch, or a ground "
                             "truth of the wrong shape or values")
    t0 = phase("probe_ground_truth", t0, queries=PROBE_NQ_RECALL, launches=launches)

    idx.finalize(pivots=PROBE_PIVOTS, pivot_cover=PROBE_COVER,
                 pivot_shortlist=PROBE_T)
    idx.serve_probes = PROBES
    torch.cuda.synchronize()
    piv_ids, piv_vecs = idx._pivots
    shortlist, sl_pack, packed0 = idx._pivot_shortlist, idx._pivot_sl_pack, idx._packed0
    codes, scales = idx.points.codes, idx.points.scales
    if (idx.serving_route() != "probe_packed"
            or tuple(shortlist.shape) != (piv_ids.shape[0], PROBE_T)
            or int(shortlist.min()) < 0 or int(shortlist.max()) >= N):
        raise AssertionError("finalize(pivot_shortlist=...) did not set up the "
                             "probe-packed route")
    t0 = phase("probe_finalize", t0, pivots=int(piv_ids.shape[0]),
               shortlist=f"{PROBE_T}x{int(shortlist.shape[0])}", probes=PROBES)

    def to_q(x):
        return dequantize(*quantize(torch.from_numpy(x).to(dev)))

    routes = {
        "probe_packed": lambda x, ef, mi: idx.ann_batch(x, K, ef, max_iters=mi)[1],
        "probe_narrow": lambda x, ef, mi: search.ann_search_seeded_probe(
            packed0, piv_ids, piv_vecs, shortlist, codes, scales, to_q(x), ef, K,
            mi, PROBES)[1].cpu().numpy(),
        "seeded": lambda x, ef, mi: search.ann_search_seeded(
            idx._packed0, piv_ids, piv_vecs, to_q(x), ef, K, mi)[1].cpu().numpy(),
    }
    base_bytes = (packed0.numel() + piv_vecs.numel() * 4 + piv_ids.numel() * 4
                  + N * D + N * 8 + sum(a.numel() * 4 for a in idx.graph.adjs))
    extra_bytes = {"probe_packed": sl_pack.numel(),
                   "probe_narrow": shortlist.numel() * 4, "seeded": 0}
    chosen = {}
    for name, fn in routes.items():
        ef, mi, rec, met, ids = first_rung(fn, PROBE_LADDER, ht.test[:PROBE_NQ_RECALL],
                                           truth, name)
        if ids.shape != (PROBE_NQ_RECALL, K) or ids.min() < 0 or ids.max() >= N:
            raise AssertionError(f"{name}: results of the wrong shape or values")
        if name == "probe_packed" and not met:
            raise AssertionError("the probe-packed route clears no rung of the "
                                 "ladder at recall@10 >= 0.99")
        qps, reps = fn_qps(lambda: fn(ht.test, ef, mi), NQ)
        chosen[name] = (ef, mi)
        t0 = phase(f"probe_serve_{name}", t0, ef=ef, max_iters=mi,
                   recall=f"{rec:.4f}", gate_met=met, qps=f"{qps:.1f}", batch=NQ,
                   reps=reps,
                   bytes_per_point=f"{(base_bytes + extra_bytes[name]) / N:.1f}")
    # K4's launches are the probe_packed route's alone: the other routes
    # never launch it, and the staged calls below come after this count
    k4_launches = probe_kernel.probe_packed.launches
    if k4_launches < 1:
        raise AssertionError("the probe_packed route never launched the probe "
                             "kernel")

    # one probed batch of 32,768 by stage, on the stream, in the query
    # chunks the route itself uses: pivot seeds, the probe stage (K4, one
    # launch a chunk), the beam
    ef, mi = chosen["probe_packed"]
    qd = to_q(ht.test)
    step = search._query_chunk(NQ, search._probe_bytes_per_query(
        PROBE_T, D, int(piv_ids.shape[0]), ef, PROBES, packed=True,
        kernel=True), dev)
    chunks = [qd[lo:lo + step] for lo in range(0, NQ, step)]
    st = {}

    def seeds():
        st["seeds"] = [search._pivot_seeds_pos(piv_ids, piv_vecs, qc, ef)
                       for qc in chunks]

    def probe():
        stage = search._packed_probe_stage(sl_pack, PROBE_T, D, ef, PROBES)
        tops = [stage(qc, *sd) for qc, sd in zip(chunks, st["seeds"])]
        st["entry"] = (torch.cat([t[0] for t in tops]),
                       torch.cat([t[1] for t in tops]))

    def beam():
        st["beam"] = search.search_layer_packed(packed0, qd, *st["entry"], ef, mi)

    stages = [("seeds_ms", seeds), ("probe_ms", probe), ("beam_ms", beam)]
    event_ms(stages)  # warm
    st.clear()
    torch.cuda.empty_cache()
    ms = event_ms(stages)
    _, want = search.ann_search_seeded_probe_packed(
        packed0, piv_ids, piv_vecs, sl_pack, PROBE_T, D, qd, ef, K, mi, PROBES)
    if not torch.equal(st["beam"][1][:, :K], want):
        raise AssertionError("the staged probed batch differs from the route")
    k4 = {"probed": k4_check(sl_pack, PROBE_T, piv_ids, piv_vecs, qd, ef,
                             PROBES, codes, scales),
          "cells_ef": k4_check(sl_pack, PROBE_T, piv_ids, piv_vecs, qd,
                               PROBE_CELLS_EF, PROBES, codes, scales)}
    for name, check in k4.items():
        print(f"  probe kernel at the probed shape ({name}):", json.dumps(check),
              flush=True)
    k3_launches = beam_kernel.beam_packed.launches
    k3 = k3_check(packed0, qd, *st["entry"], ef, mi, codes, scales, "probed")
    print("  beam kernel at the probed shape:", json.dumps(k3), flush=True)
    st.clear()
    del qd, chunks, want
    torch.cuda.empty_cache()
    t0 = phase("probe_breakdown", t0, ef=ef, max_iters=mi, query_chunk=step,
               **{k: f"{v:.3f}" for k, v in ms.items()},
               stages_ms=f"{sum(ms.values()):.3f}",
               peak_mem_gib=f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")

    # refine: what one NN-descent round buys the plain seeded route here
    rungs = PROBE_LADDER[:3]
    q1k = ht.test[:PROBE_NQ_RECALL]
    before = [recall_at(routes["seeded"](q1k, ef, mi), truth) for ef, mi in rungs]
    del packed0, shortlist, sl_pack
    t0 = time.perf_counter()
    idx.refine(rounds=1)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    if idx.serving_route() != "seeded_plain" or not idx.assert_param_compliance(False):
        raise AssertionError("refine: the packed rows were kept, or the graph "
                             "breaks the degree rules")
    idx.finalize(pivots=PROBE_PIVOTS, pivot_cover=PROBE_COVER)
    if idx.serving_route() != "seeded" or not torch.equal(idx._pivots[0], piv_ids):
        raise AssertionError("finalize after refine: wrong route or other pivots")
    after = [recall_at(routes["seeded"](q1k, ef, mi), truth) for ef, mi in rungs]
    if min(after) < min(before) - 0.02:
        raise AssertionError(f"refine lowered recall: {before} -> {after}")
    phase("probe_refine", t0, refine_s=f"{refine_s:.3f}",
          rungs=json.dumps(rungs).replace(" ", ""),
          recall_before=json.dumps([round(r, 4) for r in before]).replace(" ", ""),
          recall_after=json.dumps([round(r, 4) for r in after]).replace(" ", ""))
    return launches, k3_launches, k3, k4_launches, k4


def on_card(*tensors):
    """Raises unless every tensor lies on a CUDA device."""
    for t in tensors:
        if not t.is_cuda:
            raise AssertionError("a tensor of a device path lies on the CPU")


def scratch_dir(prefix):
    """A fresh directory under ``build/`` (listed in ``.gitignore``)."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=os.path.join(ROOT, "build"))


def ivf_flat_path(dev, ds, truth, t0):
    """IVF-Flat at ``benchmarks/bench_families.py``'s configuration on the
    cluster path's points and ground truth."""
    from hnsw_rs_tpu_torch import FlatIndex, IVFFlatIndex
    from hnsw_rs_tpu_torch.models import ivf as ivf_mod
    from hnsw_rs_tpu_torch.ops.distance import l2sq
    from hnsw_rs_tpu_torch.ops.quant import dequantize
    from hnsw_rs_tpu_torch.ops.topk import INF, PAD_ID, topk_dist_id

    torch.cuda.reset_peak_memory_stats(dev)
    ivf = IVFFlatIndex(D, n_lists=IVF_LISTS, kmeans_iters=IVF_ITERS, device=dev)
    ivf.train_add(ds.train)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    on_card(ivf.centroids, ivf.blocks, ivf.bscales, ivf.block_ids, ivf.codes)
    lmax = int(ivf.blocks.shape[1])
    if (len(ivf) != N or ivf.n_lists != IVF_LISTS
            or int(ivf._counts.sum()) != N or int(ivf.block_ids.max()) != N - 1):
        raise AssertionError("IVF-Flat build: wrong list count or missing points")
    dev_bytes = (ivf.blocks.numel() + ivf.bscales.numel() * 4
                 + ivf.block_ids.numel() * 4 + ivf.centroids.numel() * 4)
    t0 = phase("ivf_flat_build", t0, vec_per_s=f"{N / build_s:.1f}",
               lists=IVF_LISTS, lmax=lmax, largest_list=int(ivf._counts.max()),
               **{f"{k}_s": f"{v:.3f}" for k, v in ivf.build_phase_s.items()},
               bytes_per_point=f"{dev_bytes / N:.1f}")

    chosen = None
    for p in IVF_PROBES:
        dist, ids = ivf.search(ds.test[:NQ_RECALL], K, n_probe=p)
        rec = recall_at(ids, truth)
        print(f"  ivf-flat probes={p} recall@10={rec:.4f}", flush=True)
        if rec >= 0.99:
            chosen = (p, rec)
            break
    if chosen is None:
        raise AssertionError("IVF-Flat clears no rung of its probe ladder")
    p, rec = chosen
    if (ids.shape != (NQ_RECALL, K) or not np.all(np.isfinite(dist))
            or ids.min() < 0 or ids.max() >= N):
        raise AssertionError("IVF-Flat results have the wrong shape or values")
    qps, reps = fn_qps(lambda: ivf.search(ds.test, K, n_probe=p), NQ)
    t0 = phase("ivf_flat_serve", t0, n_probe=p, recall=f"{rec:.4f}",
               qps=f"{qps:.1f}", batch=NQ, reps=reps,
               bytes_per_point=f"{dev_bytes / N:.1f}",
               peak_mem_gib=f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")

    # one batch of 4,096 by stage on the stream: the centroid top-p, then
    # per probe the block gather, the dequantize + L2 in the search's own
    # slices, and the running merge
    q = ivf._prep_queries(ds.test[:NQ_RECALL])
    b = q.shape[0]
    ch = min(lmax, max(64, ivf_mod._SCAN_TEMP // (b * D * 4)))
    st = {}

    def top_p():
        st["probe"] = ivf_mod._probe_lists(q, ivf.centroids, p)
        st["bd"] = torch.full((b, K), INF, dtype=torch.float32, device=dev)
        st["bi"] = torch.full((b, K), PAD_ID, dtype=torch.int32, device=dev)

    def gather(pi):
        li = st["probe"][:, pi]
        st["cand"], st["sc"], st["ids"] = ivf.blocks[li], ivf.bscales[li], ivf.block_ids[li]

    def score():
        st["d2"] = torch.cat([
            l2sq(q[:, None, :], dequantize(st["cand"][:, c0:c0 + ch],
                                           st["sc"][:, c0:c0 + ch]))
            for c0 in range(0, lmax, ch)], dim=1)

    def merge():
        ok = st["ids"] >= 0
        st["bd"], st["bi"] = topk_dist_id(
            torch.cat([st["bd"], torch.where(ok, st["d2"], INF)], dim=1),
            torch.cat([st["bi"], torch.where(ok, st["ids"], PAD_ID)], dim=1), K)

    stages = [("centroid_top_p_ms", top_p)]
    for pi in range(p):
        stages += [("block_gather_ms", lambda pi=pi: gather(pi)),
                   ("dequantize_l2_ms", score), ("merge_ms", merge)]
    event_ms(stages)  # warm
    ms = event_ms(stages)
    _, want = ivf_mod._ivf_search(q, ivf.centroids, ivf.blocks, ivf.bscales,
                                  ivf.block_ids, p, K)
    if not torch.equal(st["bi"], want):
        raise AssertionError("the staged IVF-Flat batch differs from the search")
    st.clear()
    # what one batch must move: each probed block read once as stored
    block_bytes = b * p * lmax * (D + 12)
    t0 = phase("ivf_flat_breakdown", t0, batch=b, n_probe=p, slice=ch,
               **{k: f"{v:.3f}" for k, v in ms.items()},
               stages_ms=f"{sum(ms.values()):.3f}",
               block_bytes_bound_ms=f"{block_bytes / MEM_BPS * 1e3:.3f}")

    # 2,048 adds in one batch, then truth over N + 2,048 through K2
    new = ds.test[NQ - N_INSERT:]
    new_ids = ivf.add(new)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    if not np.array_equal(new_ids, np.arange(N, N + N_INSERT)) or len(ivf) != N + N_INSERT:
        raise AssertionError("IVFFlatIndex.add returned unexpected ids")
    _, self_ids = ivf.search(new, 1, n_probe=p)
    self_rec = float(np.mean(self_ids[:, 0] == new_ids))
    flat = FlatIndex(D, dev)
    flat.add(np.concatenate([ds.train, new]))
    if not torch.equal(flat.codes, ivf.codes[:N + N_INSERT]):
        raise AssertionError("flat index codes differ from the IVF store")
    _, truth2 = flat.search(ds.test[:NQ_RECALL], K, fused=True)
    del flat
    _, ids = ivf.search(ds.test[:NQ_RECALL], K, n_probe=p)
    rec2 = recall_at(ids, truth2)
    if self_rec < 0.99 or rec2 < 0.99:
        raise AssertionError(f"after IVF adds: self recall {self_rec:.4f}, "
                             f"recall@10 {rec2:.4f} at n_probe={p}")
    t0 = phase("ivf_flat_add", t0, added=N_INSERT, add_s=f"{add_s:.3f}",
               lmax=int(ivf.blocks.shape[1]), self_recall=f"{self_rec:.4f}",
               recall=f"{rec2:.4f}")

    path = scratch_dir("ivf_")
    try:
        ivf.save(path)
        save_s = time.perf_counter() - t0
        back = IVFFlatIndex.load(path, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0 - save_s
        on_card(back.blocks, back.centroids)
        _, ids_back = back.search(ds.test[:NQ_RECALL], K, n_probe=p)
        if len(back) != len(ivf) or not np.array_equal(ids_back, ids):
            raise AssertionError("a loaded IVF-Flat index answers differently")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return phase("ivf_flat_save_load", t0, save_s=f"{save_s:.3f}",
                 load_s=f"{load_s:.3f}", ids_equal=True)


def ivf_pq_path(dev, ds, truth, t0):
    """IVF-PQ at ``benchmarks/bench_families.py``'s configuration on the
    cluster path's points and ground truth."""
    from hnsw_rs_tpu_torch.models import ivfpq as pq_mod
    from hnsw_rs_tpu_torch.models.ivf import _probe_lists
    from hnsw_rs_tpu_torch.models.ivfpq import IVFPQIndex
    from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize
    from hnsw_rs_tpu_torch.ops.topk import INF, PAD_ID, topk_dist_id

    torch.cuda.reset_peak_memory_stats(dev)
    pq = IVFPQIndex(D, n_lists=IVF_LISTS, m_pq=IVFPQ_M, kmeans_iters=IVF_ITERS,
                    rerank=IVFPQ_RERANK, device=dev)
    pq.train_add(ds.train)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    on_card(pq.centroids, pq.codebooks, pq.blocks, pq.block_ids, pq.rot, pq.codes)
    lmax = int(pq.blocks.shape[1])
    if len(pq) != N or tuple(pq.codebooks.shape) != (IVFPQ_M, 256, D // IVFPQ_M):
        raise AssertionError("IVF-PQ build: wrong size or codebook shape")
    # keep_codes (the rerank mode) holds the exact u8 codes on the card too
    dev_bytes = (pq.blocks.numel() + pq.block_ids.numel() * 4
                 + pq.centroids.numel() * 4 + pq.codebooks.numel() * 4
                 + pq.rot.numel() * 4 + pq.codes.numel() + pq.scales.numel() * 4)
    t0 = phase("ivf_pq_build", t0, vec_per_s=f"{N / build_s:.1f}", lmax=lmax,
               **{f"{k}_s": f"{v:.3f}" for k, v in pq.build_phase_s.items()},
               bytes_per_point=f"{dev_bytes / N:.1f}")

    for p, rr in IVFPQ_LADDER:
        dist, ids = pq.search(ds.test[:NQ_RECALL], K, n_probe=p, rerank=rr)
        rec = recall_at(ids, truth)
        print(f"  ivf-pq probes={p} rerank={rr} recall@10={rec:.4f}", flush=True)
        if rec >= 0.99:
            break
    if (rec < 0.9 or ids.shape != (NQ_RECALL, K) or not np.all(np.isfinite(dist))
            or ids.min() < 0 or ids.max() >= N):
        raise AssertionError(f"IVF-PQ: recall@10 {rec:.4f} at its last rung, or "
                             "results of the wrong shape or values")
    qps, reps = fn_qps(lambda: pq.search(ds.test, K, n_probe=p, rerank=rr), NQ)
    t0 = phase("ivf_pq_serve", t0, n_probe=p, rerank=rr, recall=f"{rec:.4f}",
               gate_met=rec >= 0.99, qps=f"{qps:.1f}", batch=NQ, reps=reps,
               bytes_per_point=f"{dev_bytes / N:.1f}",
               peak_mem_gib=f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")

    # one batch of 4,096 by stage: per probe the table, the block gather,
    # the table take and sum, the merge; the exact rerank at the end
    q = dequantize(*quantize(torch.from_numpy(ds.test[:NQ_RECALL]).to(dev)))
    b, kk = q.shape[0], max(K, rr)
    m_pq, _, ds_sub = pq.codebooks.shape
    cbn = (pq.codebooks * pq.codebooks).sum(-1)
    centr = pq.centroids @ pq.rot
    ch = min(lmax, max(64, pq_mod._TAKE_TEMP // (b * m_pq * 12)))
    st = {}

    def start():
        st["probe"] = _probe_lists(q, pq.centroids, p)
        st["qr"] = q @ pq.rot
        st["bd"] = torch.full((b, kk), INF, dtype=torch.float32, device=dev)
        st["bi"] = torch.full((b, kk), PAD_ID, dtype=torch.int32, device=dev)

    def lut(pi):
        rs = (st["qr"] - centr[st["probe"][:, pi]]).reshape(b, m_pq, ds_sub)
        cross = torch.einsum("bms,mvs->bmv", rs, pq.codebooks)
        st["lut"] = (rs * rs).sum(-1)[..., None] - 2.0 * cross + cbn[None]

    def gather(pi):
        pl = st["probe"][:, pi]
        st["cand"], st["ids"] = pq.blocks[pl], pq.block_ids[pl]

    def adc():
        st["d2"] = torch.cat([
            st["lut"].gather(2, st["cand"][:, c0:c0 + ch].long().transpose(1, 2))
            .sum(dim=1).clamp_min(0.0) for c0 in range(0, lmax, ch)], dim=1)

    def merge():
        ok = st["ids"] >= 0
        st["bd"], st["bi"] = topk_dist_id(
            torch.cat([st["bd"], torch.where(ok, st["d2"], INF)], dim=1),
            torch.cat([st["bi"], torch.where(ok, st["ids"], PAD_ID)], dim=1), kk)

    def rerank():
        st["out"] = pq_mod._rerank(q, pq.codes, pq.scales, torch.sqrt(st["bd"]),
                                   st["bi"], K)

    stages = [("centroid_top_p_ms", start)]
    for pi in range(p):
        stages += [("lut_ms", lambda pi=pi: lut(pi)),
                   ("gather_ms", lambda pi=pi: gather(pi)),
                   ("adc_sum_ms", adc), ("merge_ms", merge)]
    stages.append(("rerank_ms", rerank))
    event_ms(stages)  # warm
    ms = event_ms(stages)
    if not np.array_equal(st["out"][1].cpu().numpy(), ids):
        raise AssertionError("the staged IVF-PQ batch differs from the search")
    st.clear()
    return phase("ivf_pq_breakdown", t0, batch=b, n_probe=p, rerank=rr, slice=ch,
                 **{k: f"{v:.3f}" for k, v in ms.items()},
                 stages_ms=f"{sum(ms.values()):.3f}")


def paged_path(dev, t0):
    """Out-of-core serving at ``benchmarks/bench_paged_hybrid.py``'s 200k
    contract."""
    from hnsw_rs_tpu_torch import HNSW
    from hnsw_rs_tpu_torch.models.paged import save_paged
    from hnsw_rs_tpu_torch.utils.datasets import synthetic_clustered

    ds = synthetic_clustered(PAGED_N, D, n_queries=PAGED_NQ, seed=7)
    index = HNSW(WAVE_M, ef_cons=WAVE_EF_CONS, dim=D, device=dev)
    index.insert_bulk(ds.train)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index.finalize(pivots=PAGED_PIVOTS)
    if index.serving_route() != "seeded":
        raise AssertionError("the paged path's index does not serve seeded")
    path = scratch_dir("paged_")
    try:
        save_paged(index, path)
        disk = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t0 = phase("paged_build", t0, n=PAGED_N, build_s=f"{build_s:.3f}",
                   pivots=int(index._pivots[0].shape[0]),
                   disk_bytes_per_point=f"{disk / PAGED_N:.1f}")
        return _paged_serve(dev, ds, index, path, t0)
    finally:
        shutil.rmtree(path, ignore_errors=True)


def _paged_serve(dev, ds, index, path, t0):
    from hnsw_rs_tpu_torch import FlatIndex
    from hnsw_rs_tpu_torch.models.paged import HybridPagedHNSW, PagedHNSW

    def parity(ids, ref):
        return float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, ref)]))

    mem = {}
    for e in (1, 4):
        index.serve_expand = e
        mem[e] = index.ann_batch(ds.test, K, PAGED_EF)[1]
    index.serve_expand = 1

    host = PagedHNSW(path, cache_blocks=PAGED_CACHE)
    ts = time.perf_counter()
    _, ids_host = host.ann_batch(ds.test, K, PAGED_EF)
    dt = time.perf_counter() - ts
    par = parity(ids_host, mem[1])
    if par < 0.95 or ids_host.min() < 0 or ids_host.max() >= PAGED_N:
        raise AssertionError(f"PagedHNSW parity {par:.4f} with the in-memory answers")
    t0 = phase("paged_host", t0, qps=f"{PAGED_NQ / dt:.1f}", parity=f"{par:.4f}",
               ef=PAGED_EF, cache_blocks=PAGED_CACHE)

    cap0 = index.graph.get_layer(0).shape[1]
    wrow = cap0 * (D + 12)
    hyb = HybridPagedHNSW(path, hot_bytes=(PAGED_N // 2) * wrow,
                          pivots=PAGED_PIVOTS, cache_blocks=PAGED_CACHE, device=dev)
    on_card(hyb._hot_packed, hyb._slot, hyb._pivot_ids, hyb._pivot_vecs)
    if not torch.equal(hyb._pivot_ids, index._pivots[0]):
        raise AssertionError("the hybrid tier seeds from other pivots")
    hyb.ann_batch(ds.test[:32], K, PAGED_EF)  # warm
    t0 = phase("paged_hybrid_open", t0, hot_rows=hyb.hot_rows,
               device_bytes_per_point=f"{(hyb.device_bytes + hyb.pivot_bytes) / PAGED_N:.1f}")
    t0 = paged_assembly(hyb, t0)
    for e in (1, 4):
        hyb.hits = hyb.misses = 0
        ts = time.perf_counter()
        _, ids_hyb = hyb.ann_batch(ds.test, K, PAGED_EF, expand_e=e)
        dt = time.perf_counter() - ts
        par = parity(ids_hyb, mem[e])
        exp = hyb.hits + hyb.misses
        if par != 1.0:
            raise AssertionError(f"hybrid tier at expand_e={e}: parity {par:.4f} "
                                 "with the in-memory seeded answers, not 1.0")
        t0 = phase(f"paged_hybrid_e{e}", t0, qps=f"{PAGED_NQ / dt:.1f}",
                   parity=f"{par:.4f}", ids_equal=bool(np.array_equal(ids_hyb, mem[e])),
                   hit_rate=f"{hyb.hits / max(exp, 1):.4f}", expansions=exp,
                   dispatches=hyb.dispatches)
    hyb.close()
    del hyb

    for pq_m, ef in PAGED_PQ:
        pq = HybridPagedHNSW(path, pivots=PAGED_PIVOTS, pq_m=pq_m, pq_bits=4,
                             cache_blocks=PAGED_CACHE, device=dev)
        on_card(pq._pq_packed, pq._pq_codes, pq._pq_cb)
        open_s = time.perf_counter() - t0
        pq.ann_batch(ds.test[:32], K, ef)  # warm
        ts = time.perf_counter()
        dist, ids_pq = pq.ann_batch(ds.test, K, ef)
        dt = time.perf_counter() - ts
        par = parity(ids_pq, mem[1])
        if par < 0.9 or not np.all(np.isfinite(dist)) or pq.hits or pq.misses:
            raise AssertionError(f"PQ tier pq_m={pq_m} ef={ef}: parity {par:.4f}")
        t0 = phase(f"paged_pq_tier_m{pq_m}_ef{ef}", t0, open_s=f"{open_s:.3f}",
                   qps=f"{PAGED_NQ / dt:.1f}", parity=f"{par:.4f}",
                   device_bytes_per_point=f"{pq.device_bytes / PAGED_N:.1f}",
                   exact_packed_bytes_per_point=wrow)
        pq.close()
        del pq

    flat = FlatIndex(D, dev)
    flat.add(ds.train)
    _, fused_ids = flat.search(ds.test, K, fused=True)
    _, exact_ids = flat.search(ds.test, K, exact=True)
    ts = time.perf_counter()
    sd, si = host.store.search_streaming(ds.test, K, device=dev)
    dt = time.perf_counter() - ts
    host.close()
    if not np.array_equal(si, exact_ids) or parity(si, fused_ids) < 0.999:
        raise AssertionError("search_streaming differs from FlatIndex")
    return phase("paged_streaming", t0, qps=f"{PAGED_NQ / dt:.1f}",
                 ids_equal_flat_exact=True,
                 fused_id_match=f"{parity(si, fused_ids):.4f}")


def python_glove(path):
    """The GloVe parse in Python: the native parser's reference."""
    words, vecs = [], []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            words.append(parts[0])
            vecs.append(np.asarray(parts[1:], np.float32))
    return words, np.stack(vecs)


def native_build(t0):
    """Both native libraries built from the checkout's sources (``g++``
    required), and the native GloVe parse against the Python one."""
    from hnsw_rs_tpu_torch import native

    ts = time.perf_counter()
    lib, base = native.get_lib(), native.get_baseline_lib()
    compile_s = time.perf_counter() - ts
    if lib is None or base is None:
        raise AssertionError("no g++ on PATH: the native libraries were not built")
    store = os.path.join(ROOT, "test-data", "store.txt")
    nw, nv = native.load_glove_native(store)
    pw, pv = python_glove(store)
    err = float(np.abs(nv - pv).max())
    if nw != pw or nv.shape != pv.shape or err > 2e-6:
        raise AssertionError(f"native GloVe parse differs from Python (max err {err})")
    return phase("native_build", t0, libraries="fastio,baseline_hnsw",
                 compile_s=f"{compile_s:.3f}", glove_rows=len(nw),
                 glove_max_abs_err=err)


def cpu_baseline(dev, ds, t0):
    """The single-core C++ HNSW baseline on this host's CPU: a build of
    the first ``BASE_N`` points at M=24, ef_cons=128 (vec/s), then
    ``BASE_NQ`` queries one at a time at ef=64 (QPS) over the same index,
    which ``baseline_query_rate`` builds again first (untimed); recall@10
    against exact truth over the slice. The two calls run one after the
    other, with nothing else on the host."""
    from hnsw_rs_tpu_torch import FlatIndex, native

    base = ds.train[:BASE_N]
    secs, rate = native.baseline_build_rate(base, M, EF_CONS)
    qps, ids = native.baseline_query_rate(base, ds.test[:BASE_NQ], M, BASE_EF, K, EF_CONS)
    flat = FlatIndex(D, dev)
    flat.add(base)
    _, truth = flat.search(ds.test[:BASE_NQ], K, exact=True)
    rec = recall_at(ids, truth)
    cpu = native.cpu_info()
    if rec < 0.9 or ids.min() < 0 or ids.max() >= BASE_N:
        raise AssertionError(f"CPU baseline: recall@10 {rec:.4f}, or ids out of range")
    return phase("cpu_baseline", t0, n=BASE_N, m=M, ef_cons=EF_CONS,
                 build_s=f"{secs:.3f}", vec_per_s=f"{rate:.1f}", ef=BASE_EF,
                 queries=BASE_NQ, qps=f"{qps:.1f}", recall=f"{rec:.4f}",
                 nproc=os.cpu_count(),
                 cpu=repr(cpu["model name"]), vendor=cpu.get("vendor_id"),
                 family_model=f"{cpu.get('cpu family')}/{cpu.get('model')}")


def paged_assembly(hyb, t0):
    """The hybrid tier's cold rows assembled both ways on the same ids:
    the native assembler and its numpy version, bytes equal, ms a call."""
    cold = np.flatnonzero(hyb._slot_host < 0)
    rng = np.random.default_rng(5)
    calls = [rng.choice(cold, ASSEMBLY_ROWS, replace=False)
             for _ in range(ASSEMBLY_CALLS)]
    for ids in calls[:4]:
        if not np.array_equal(hyb._packed_rows_host(ids), hyb._packed_rows_numpy(ids)):
            raise AssertionError("the native cold-row assembler differs from numpy")
    ms = {}
    for name, fn in (("native", hyb._packed_rows_host), ("numpy", hyb._packed_rows_numpy),
                     ("native2", hyb._packed_rows_host), ("numpy2", hyb._packed_rows_numpy)):
        ts = time.perf_counter()
        for ids in calls:
            fn(ids)
        ms[name] = (time.perf_counter() - ts) * 1e3 / ASSEMBLY_CALLS
    return phase("paged_assembly", t0, rows_per_call=ASSEMBLY_ROWS,
                 calls=ASSEMBLY_CALLS, bytes_equal=True,
                 native_ms=f"{ms['native']:.3f},{ms['native2']:.3f}",
                 numpy_ms=f"{ms['numpy']:.3f},{ms['numpy2']:.3f}",
                 row_bytes=hyb._wrow)


def annb_path(dev, t0):
    """The ann-benchmarks protocol at glove-100-angular's shape through the
    three adapters, against exact truth from ``FlatIndex(fused=True)``
    (K2)."""
    from hnsw_rs_tpu_torch import FlatIndex
    from hnsw_rs_tpu_torch.annb import (
        ANNBenchmarksFlat, ANNBenchmarksHNSW, ANNBenchmarksIVF)
    from hnsw_rs_tpu_torch.utils.datasets import synthetic_clustered

    ds = synthetic_clustered(ANNB_N, ANNB_D, n_queries=ANNB_NQ, seed=42)
    train, test = ds.train, ds.test
    flat = FlatIndex(ANNB_D, dev, metric="cosine")
    flat.add(train)
    _, truth = flat.search(test, K, fused=True)
    del flat
    t0 = phase("annb_data", t0, n=ANNB_N, cut_from=1_183_514, d=ANNB_D,
               metric="angular", queries=ANNB_NQ)

    def ladder(algo, args):
        rows = {}
        for a in args:
            algo.set_query_arguments(a)
            algo.batch_query(test, K)  # warm
            torch.cuda.synchronize()
            ts = time.perf_counter()
            algo.batch_query(test, K)
            dt = time.perf_counter() - ts
            ids = algo.get_batch_results()
            if ids.shape != (ANNB_NQ, K) or list(algo.query(test[0], K)) != list(ids[0]):
                raise AssertionError(f"{algo}: query() differs from batch_query()")
            rows[a] = (recall_at(ids, truth), ANNB_NQ / dt)
        return rows

    exact = ANNBenchmarksFlat("angular", device=dev)
    exact.fit(train)
    (rec_flat, qps_flat), = ladder(exact, [None]).values()
    if rec_flat < 0.999:
        raise AssertionError(f"ANNBenchmarksFlat recall@10 {rec_flat:.4f}")
    t0 = phase("annb_flat", t0, recall=f"{rec_flat:.4f}", qps=f"{qps_flat:.1f}")
    del exact

    algo = ANNBenchmarksHNSW("angular", {"M": 16, "efConstruction": 96}, device=dev)
    algo.fit(train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    on_card(algo._index.points.codes, algo._index._packed0)
    rows = ladder(algo, ANNB_EFS)
    if rows[ANNB_EFS[-1]][0] < 0.95:
        raise AssertionError(f"ANNBenchmarksHNSW recall@10 {rows[ANNB_EFS[-1]][0]:.4f} "
                             f"at ef={ANNB_EFS[-1]}")
    t0 = phase("annb_hnsw", t0, fit_s=f"{fit_s:.3f}", route=algo._index.serving_route(),
               memory_kb=algo.get_memory_usage(),
               **{f"ef{a}": f"{r:.4f}@{q:.1f}qps" for a, (r, q) in rows.items()})
    del algo

    ivf = ANNBenchmarksIVF("angular", {"n_list": 512}, device=dev)
    ivf.fit(train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rows = ladder(ivf, ANNB_PROBES)
    return phase("annb_ivf", t0, fit_s=f"{fit_s:.3f}", n_list=512,
                 **{f"p{a}": f"{r:.4f}@{q:.1f}qps" for a, (r, q) in rows.items()})


def codec_path(dev, index, ef, mi, queries, t0):
    """``export_reference_index`` of the cluster path's index, then
    ``import_reference_index`` on the card: equal arrays and ledgers, and
    equal ids through the packed hierarchical route."""
    from hnsw_rs_tpu_torch.graphs import recount_indeg
    from hnsw_rs_tpu_torch.utils.serializer import (
        export_reference_index, import_reference_index)

    path = scratch_dir("codec_")
    try:
        ts = time.perf_counter()
        export_reference_index(index, path)
        write_s = time.perf_counter() - ts
        disk = sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(path) for f in fs)
        ts = time.perf_counter()
        back = import_reference_index(path, dev)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - ts
    finally:
        shutil.rmtree(path, ignore_errors=True)
    n = len(index)
    on_card(back.points.codes, back.points.scales, *back.graph.adjs)
    p, q = index.params, back.params
    same = (len(back) == n and len(back.graph) == len(index.graph)
            and torch.equal(back.points.codes, index.points.codes[:n])
            and torch.equal(back.points.scales, index.points.scales[:n])
            and np.array_equal(back.points.levels, index.points.levels[:n])
            and all(getattr(p, f) == getattr(q, f)
                    for f in ("m", "mmax", "mmax0", "ef_cons", "dim", "ep"))
            and abs(p.ml - q.ml) <= 1e-7 * p.ml)
    for lay in range(len(index.graph)):
        adj = index.graph.get_layer(lay)[:n]
        same = (same and torch.equal(back.graph.get_layer(lay), adj)
                and torch.equal(back.graph.indeg(lay), recount_indeg(adj)))
    if not same:
        raise AssertionError("the imported index differs from the exported one")
    back.finalize()
    _, ids = index.ann_batch(queries, K, ef, max_iters=mi)
    _, back_ids = back.ann_batch(queries, K, ef, max_iters=mi)
    if back.serving_route() != index.serving_route() or not np.array_equal(ids, back_ids):
        raise AssertionError("the imported index answers differently")
    return phase("codec", t0, n=n, layers=len(index.graph), write_s=f"{write_s:.3f}",
                 read_s=f"{read_s:.3f}", disk_bytes_per_point=f"{disk / n:.1f}",
                 arrays_equal=True, ledgers_equal=True, route=back.serving_route(),
                 queries=len(queries), ids_equal=True)


def entry_path(dev, t0):
    """The port's entry points (``entry.py``) on the card."""
    from hnsw_rs_tpu_torch.entry import dryrun_multichip, entry

    fn, args = entry(dev)
    on_card(args[1], args[2], args[3], *args[0])
    dist, ids = fn(*args)
    if (tuple(dist.shape) != (64, 10) or tuple(ids.shape) != (64, 10)
            or not bool(torch.isfinite(dist).all())):
        raise AssertionError("entry(): the step's outputs have the wrong shape or values")
    dryrun_multichip(8, dev)
    return phase("entry", t0, step_out=[tuple(dist.shape), tuple(ids.shape)],
                 self_match=f"{float((ids[:, 0].cpu() == torch.arange(64)).float().mean()):.4f}",
                 dryrun_devices=8)


def cosine_path(dev, ds, t0):
    """The cosine metric through a wave build at N=131,072, and the
    raw-float ``FlatIndex`` against its exact form."""
    from hnsw_rs_tpu_torch import FlatIndex, HNSW

    train, test = ds.train[:OPT_N] - 0.5, ds.test[:NQ_RECALL] - 0.5
    flat = FlatIndex(D, dev, metric="cosine")
    flat.add(train)
    gt_d, truth = flat.search(test, K, fused=True)
    norms = torch.sqrt(flat._normsq)
    if float((norms - 1.0).abs().max()) > 0.02 or not np.all(np.isfinite(gt_d)):
        raise AssertionError("cosine FlatIndex: stored rows are not unit vectors")
    index = HNSW(WAVE_M, ef_cons=WAVE_EF_CONS, dim=D, metric="cosine", device=dev)
    index.insert_bulk(train)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    on_card(index.points.codes, index._packed0)
    if not torch.equal(flat.codes, index.points.codes[:OPT_N]):
        raise AssertionError("cosine: flat index codes differ from the HNSW store")
    _, ids = index.ann_batch(test, K, 128)
    rec = recall_at(ids, truth)
    _, scaled = index.ann_batch(test[:256] * 7.0, K, 128)
    if rec < 0.95 or not np.array_equal(scaled, ids[:256]):
        raise AssertionError(f"cosine wave build: recall@10 {rec:.4f} at ef=128, "
                             "or scaled queries answer differently")
    t0 = phase("cosine_hnsw", t0, n=OPT_N, build_s=f"{build_s:.3f}",
               recall_ef128=f"{rec:.4f}", scale_invariant=True)
    del index, flat

    raw = FlatIndex(D, dev, quantized=False)
    raw.add(ds.train[:RAW_N])
    on_card(raw.codes)
    if raw.codes.dtype != torch.float32:
        raise AssertionError("the raw-float FlatIndex does not hold float32 rows")
    q = ds.test[:256]
    fd, fi = raw.search(q, K)
    ed, ei = raw.search(q, K, exact=True)
    match = recall_at(fi, ei)
    d2_err = float(np.abs(fd ** 2 - ed ** 2).max())
    if match < 0.999 or d2_err > 1e-4:
        raise AssertionError(f"raw-float FlatIndex: id match {match:.4f}, d2 err "
                             f"{d2_err} against exact=True")
    try:
        raw.search(q, K, fused=True)
    except ValueError:
        pass
    else:
        raise AssertionError("fused=True accepted a raw-float collection")
    return phase("flat_raw_float", t0, n=RAW_N, id_match=f"{match:.4f}",
                 d2_err=d2_err, fused_refused=True)


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _sharded_bytes(sh):
    """Device bytes of a sharded index's serving state: every shard's
    codes, scales, gids, adjacency layers, packed rows and pivots."""
    st = sh._stacked
    tensors = list(st["codes"]) + list(st["scales"]) + list(st["gids"])
    tensors += [a for layer in st["adjs"] for a in layer]
    if sh._packed is not None:
        tensors += [t for part in sh._packed for t in part]
    return sum(t.numel() * t.element_size() for t in tensors)


def sharded_path(dev, ds, truth, single_build_s, single_qps, t0):
    """The scale-out layer on one card: ``bench.py``'s configuration over
    8 shards on ``cuda:0`` (cluster build, ``finalize``, the ladder, QPS,
    ``add``, ``save``/``load``), then 4 shards at ``CUT_N`` over skewed
    bounds (the concurrent and the sequential wave build, ``rebalance``)
    and the rank form's all_gather merge on NCCL at world size 1."""
    from hnsw_rs_tpu_torch import FlatIndex
    from hnsw_rs_tpu_torch.parallel import ShardedHNSW, make_mesh, multihost
    from hnsw_rs_tpu_torch.parallel.sharded import sharded_query
    from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize

    torch.cuda.reset_peak_memory_stats(dev)
    sh = ShardedHNSW(M, D, n_shards=SHARDS, ef_cons=EF_CONS,
                     mesh=make_mesh(1, SHARDS, [dev] * SHARDS))
    sh.insert_bulk(ds.train, cluster_build=True, cluster_kwargs=CLUSTER_KWARGS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st = sh._stacked
    on_card(*st["codes"], *st["adjs"][0])
    if len(sh) != N or list(sh._counts) != [N // SHARDS] * SHARDS:
        raise AssertionError("sharded build: wrong point count per shard")
    t0 = phase("sharded_build", t0, n=N, shards=SHARDS, build_s=f"{build_s:.3f}",
               vec_per_s=f"{N / build_s:.1f}", single_build_s=f"{single_build_s:.3f}",
               work_vs_single=f"{build_s / single_build_s:.3f}",
               layers=len(st["adjs"]))
    # the pivot budget, then the (ef, max_iters) ladder to the first rung
    # with recall@10 >= 0.99
    piv = SHARD_PIVOTS
    t0 = time.perf_counter()
    sh.finalize(pivots=piv)
    torch.cuda.synchronize()
    fin_s = time.perf_counter() - t0
    if sum(int((p >= 0).sum()) for p in sh._packed[1]) != SHARDS * piv:
        raise AssertionError("sharded finalize: a shard's pivot budget is unmet")
    ef, mi, rec, met, ids = first_rung(
        lambda x, ef_, mi_: sh.ann_batch(x, K, ef_, max_iters=mi_)[1],
        LADDER, ds.test[:NQ_RECALL], truth, f"sharded pivots={piv}")
    t0 = phase("sharded_finalize", t0, pivots_per_shard=piv,
               pivots=SHARDS * piv, finalize_s=f"{fin_s:.3f}", gate_met=met,
               ef=ef, max_iters=mi, recall=f"{rec:.4f}")
    if not met or ids.shape != (NQ_RECALL, K) or ids.min() < 0 or ids.max() >= N:
        raise AssertionError("the sharded index clears no rung at recall@10 >= "
                             "0.99, or its ids have the wrong shape or values")
    qps, reps = timed_qps(sh, ds.test, ef, mi)
    t0 = phase("sharded_serve", t0, pivots_per_shard=piv, ef=ef, max_iters=mi,
               recall=f"{rec:.4f}",
               qps=f"{qps:.1f}", batch=NQ, reps=reps, single_qps=f"{single_qps:.1f}",
               serve_work_vs_single=f"{single_qps / qps:.3f}",
               bytes_per_point=f"{_sharded_bytes(sh) / N:.1f}",
               peak_mem_gib=f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")

    # add 2,048 points: the pack goes stale, so the plain hierarchical
    # route serves, held to its own recall before the add; truth over
    # N + 2,048 through K2
    qd = dequantize(*quantize(torch.from_numpy(ds.test[:NQ_RECALL]).to(dev)))
    _, before = sharded_query(sh.mesh, st["adjs"], st["codes"], st["scales"],
                              st["gids"], st["eps"], qd, PLAIN_EF, K, 2 * PLAIN_EF + 16)
    rec_before = recall_at(before.cpu().numpy(), truth)
    new = ds.test[NQ - N_INSERT:]
    t0 = time.perf_counter()
    gids = sh.add(new)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    if not np.array_equal(gids, np.arange(N, N + N_INSERT)) or len(sh) != N + N_INSERT:
        raise AssertionError("ShardedHNSW.add returned unexpected ids")
    _, self_ids = sh.ann_batch(new, K, PLAIN_EF)
    self_plain = float(np.mean([g in row for g, row in zip(gids, self_ids)]))
    flat = FlatIndex(D, dev)
    flat.add(np.concatenate([ds.train, new]))
    _, truth2 = flat.search(ds.test[:NQ_RECALL], K, fused=True)
    del flat
    _, plain_ids = sh.ann_batch(ds.test[:NQ_RECALL], K, PLAIN_EF)
    rec_plain = recall_at(plain_ids, truth2)
    if rec_plain < rec_before - 0.01:
        raise AssertionError(f"after sharded adds: plain recall@10 {rec_plain:.4f} "
                             f"against {rec_before:.4f} before them")
    t0 = phase("sharded_add", t0, added=N_INSERT, add_s=f"{add_s:.3f}",
               counts=json.dumps(sh._counts.tolist()).replace(" ", ""),
               plain_self_recall=f"{self_plain:.4f}", plain_ef=PLAIN_EF,
               plain_recall_before=f"{rec_before:.4f}", plain_recall=f"{rec_plain:.4f}")

    path = scratch_dir("sharded_")
    try:
        sh.save(path)
        save_s = time.perf_counter() - t0
        del sh, st
        torch.cuda.empty_cache()
        back = ShardedHNSW.load(path, make_mesh(1, SHARDS, [dev] * SHARDS))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0 - save_s
    finally:
        shutil.rmtree(path, ignore_errors=True)
    on_card(*back._stacked["codes"])
    _, back_ids = back.ann_batch(ds.test[:NQ_RECALL], K, PLAIN_EF)
    if len(back) != N + N_INSERT or not np.array_equal(back_ids, plain_ids):
        raise AssertionError("a loaded sharded index answers differently")
    back.finalize(pivots=piv)
    _, ids2 = back.ann_batch(ds.test[:NQ_RECALL], K, ef, max_iters=mi)
    rec2 = recall_at(ids2, truth2)
    _, self_ids = back.ann_batch(new, K, PLAIN_EF)
    self_rec = float(np.mean([g in row for g, row in zip(gids, self_ids)]))
    if rec2 < rec - 0.01:
        raise AssertionError(f"seeded after the add: recall@10 {rec2:.4f} against "
                             f"{rec:.4f} before it")
    t0 = phase("sharded_save_load", t0, save_s=f"{save_s:.3f}", load_s=f"{load_s:.3f}",
               ids_equal=True, ef=ef, max_iters=mi, seeded_recall=f"{rec2:.4f}",
               seeded_self_recall_ef128=f"{self_rec:.4f}")
    del back
    torch.cuda.empty_cache()

    # 4 shards at CUT_N over skewed bounds: the concurrent wave build, the
    # sequential one on the same bounds, then rebalance
    flat = FlatIndex(D, dev)
    flat.add(ds.train[:CUT_N])
    _, truth_opt = flat.search(ds.test[:NQ_RECALL], K, fused=True)
    del flat
    bounds = (np.asarray(OPT_SPLIT) * CUT_N).astype(int)
    mesh4 = make_mesh(1, OPT_SHARDS, [dev] * OPT_SHARDS)
    recs = {}
    for name, kw in (("concurrent", {}), ("sequential", {"concurrent": False})):
        t0 = time.perf_counter()
        idx = ShardedHNSW(WAVE_M, D, OPT_SHARDS, ef_cons=WAVE_EF_CONS, mesh=mesh4)
        idx.insert_bulk(ds.train[:CUT_N], partition_bounds=bounds, **kw)
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t0
        recs[name] = recall_at(idx.ann_batch(ds.test[:NQ_RECALL], K, PLAIN_EF)[1],
                               truth_opt)
        t0 = phase(f"sharded_wave_{name}", t0, n=CUT_N, shards=OPT_SHARDS,
                   counts=json.dumps(np.diff(bounds).tolist()).replace(" ", ""),
                   build_s=f"{b_s:.3f}", recall_ef128=f"{recs[name]:.4f}")
        if name == "concurrent":
            conc = idx
        del idx
    if recs["concurrent"] < 0.95 or recs["concurrent"] < recs["sequential"] - 0.02:
        raise AssertionError(f"concurrent wave build recall@10 {recs['concurrent']:.4f}"
                             f" against the sequential {recs['sequential']:.4f}")
    moved = conc.rebalance()
    torch.cuda.synchronize()
    reb_s = time.perf_counter() - t0
    _, ids_r = conc.ann_batch(ds.test[:NQ_RECALL], K, PLAIN_EF)
    rec_r = recall_at(ids_r, truth_opt)
    if (moved != int(np.maximum(np.diff(bounds) - CUT_N // OPT_SHARDS, 0).sum())
            or list(conc._counts) != [CUT_N // OPT_SHARDS] * OPT_SHARDS
            or rec_r < recs["concurrent"] - 0.01):
        raise AssertionError(f"rebalance moved {moved} to {conc._counts.tolist()}, "
                             f"recall@10 {rec_r:.4f}")
    t0 = phase("sharded_rebalance", t0, moved=moved, rebalance_s=f"{reb_s:.3f}",
               recall_ef128=f"{rec_r:.4f}")

    # the rank form at world size 1 on NCCL: the rank holds all 4 shards,
    # read from a save, and one all_gather merges them
    path = scratch_dir("nccl_")
    try:
        conc.save(path)
        multihost.init_distributed(f"tcp://localhost:{_free_port()}", 1, 0, "nccl")
        try:
            local = multihost.local_shards(path, multihost.global_mesh(dev),
                                           range(OPT_SHARDS))
            _, rank_ids = multihost.rank_sharded_query(
                local, qd, PLAIN_EF, K, 2 * PLAIN_EF + 16)
            backend = torch.distributed.get_backend()
        finally:
            torch.distributed.destroy_process_group()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    if backend != "nccl" or not np.array_equal(rank_ids.cpu().numpy(), ids_r):
        raise AssertionError("the NCCL all_gather merge differs from the in-process ids")
    del conc, local, qd
    torch.cuda.empty_cache()
    return phase("sharded_nccl", t0, backend=backend, world_size=1,
                 shards=OPT_SHARDS, ids_equal=True)


def main():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs one GPU")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    sys.path.insert(0, ROOT)
    from hnsw_rs_tpu_torch import FlatIndex, HNSW
    from hnsw_rs_tpu_torch.build import _insert_wave_fused_impl
    from hnsw_rs_tpu_torch.ops import beam, cuda_build, groupmin, l2_kernel, limbs
    from hnsw_rs_tpu_torch.ops.distance import point_normsq
    from hnsw_rs_tpu_torch.ops.limbs import N_LIMBS, padded_dim
    from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize
    from hnsw_rs_tpu_torch.parallel import ReplicatedHNSW, make_mesh
    from hnsw_rs_tpu_torch.search import (
        _descend, _pivot_seeds_pos, comb_table, search_layer_packed)
    from hnsw_rs_tpu_torch.utils.datasets import synthetic_clustered
    t0 = phase("device", t0, kind=repr(kind))

    libs = cuda_build.build("group_min", "l2_kernel", "query_limbs", "beam_packed",
                            "probe_packed")
    tensor_ops = {}
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line or "C75" in line and "C7519" not in line:
                print(f"  ptxas {lib.name}:", line.strip())
        ops = tensor_ops[lib.name] = sass_counts(lib)
        print(f"  sass {lib.name}:", json.dumps(ops), flush=True)
        if (lib.name.startswith(("group_min", "l2_kernel"))
                and ops["IGMMA"] + ops["IMMA"] == 0):
            raise AssertionError(f"{lib.name} has no int8 tensor-core instruction")
    t0 = phase("build", t0, libraries=",".join(lib.name for lib in libs),
               tensor_core_instructions=json.dumps(tensor_ops).replace(" ", ""))

    t0 = native_build(t0)

    ds = synthetic_clustered(N, D, n_queries=NQ, seed=42)
    t0 = phase("data", t0, n=N, d=D, queries=NQ)
    # the host's single-core baseline, with the kernel builds finished and
    # nothing else running
    t0 = cpu_baseline(dev, ds, t0)

    # -- the query limb split vs its plain version --------------------------------
    # corner rows first (all zero, a power-of-two maximum, a row below
    # 2^-96, rounding ties of both signs), at four shapes and both modes;
    # then the main path's shape (B=4096, d=96), checked and timed
    rng = np.random.default_rng(1)
    limb_err = 0.0
    for b, d in ((1, 7), (33, 96), (300, 300), (4096, 768)):
        qx = rng.normal(0, 3, (b, d)).astype(np.float32)
        qx[0] = 0.0
        if b > 3:
            qx[1] = rng.uniform(-1, 1, d)
            qx[1, 0] = -4.0
            qx[2] = rng.uniform(-1, 1, d) * 2.0 ** -100
            qx[3] = (rng.integers(-1000, 1000, d) + 0.5) * 2.0 ** -29
            qx[3, -1] = 1.5
        for fast in (False, True):
            limb_err = max(limb_err, limb_check(limbs, torch.from_numpy(qx).to(dev), fast))
    ql = dequantize(*quantize(torch.from_numpy(ds.test[:NQ_RECALL]).to(dev)))
    limb_err = max(limb_err, limb_check(limbs, ql, False))
    ms_limb = cuda_ms(lambda: limbs.query_operands(ql), 50)
    ms_limb_plain = cuda_ms(lambda: limbs.query_operands_plain(ql), 50)
    # a few integer operations per component against 4 B in and 4 B out
    # per padded component: the bytes bound it
    limb_bound = NQ_RECALL * (D * 4 + padded_dim(D) * N_LIMBS + 12) / MEM_BPS * 1e3
    del ql
    t0 = phase("limbs_vs_plain", t0, B=NQ_RECALL, d=D, limbs_and_scale="equal",
               sums_rel_err=f"{limb_err:.3e}", ms=f"{ms_limb:.4f}",
               plain_ms=f"{ms_limb_plain:.4f}", bound_ms=f"{limb_bound:.5f}")

    # -- kernel vs plain on the card -----------------------------------------
    x = torch.from_numpy(ds.train[:262144]).to(dev)
    codes, scales = quantize(x)
    normsq = point_normsq(codes, scales)
    q = dequantize(*quantize(torch.from_numpy(ds.test[:256]).to(dev)))
    kd, ki = groupmin.group_min_d2(q, codes, scales, normsq)
    pd, pi = groupmin.group_min_d2_plain(q, codes, scales, normsq)
    torch.cuda.synchronize()
    ties, max_err = k2_check(q, codes, scales, normsq, kd, ki, pd, pi)
    ms_k = cuda_ms(lambda: groupmin.group_min_d2(q, codes, scales, normsq), 20)
    ms_p = cuda_ms(lambda: groupmin.group_min_d2_plain(q, codes, scales, normsq), 20)
    fd, fi = groupmin.flat_topk_fused(q, codes, scales, normsq, K)
    gd, gi = groupmin.group_min_d2_plain(q, codes, scales, normsq)
    rd, ri = groupmin.rescore_groups(q, codes, scales, normsq, gd, gi, K,
                                     codes.shape[0])
    if not torch.equal(fi, ri):
        raise AssertionError("flat_topk_fused ids differ from the plain route")

    def plain_topk():
        g_d, g_i = groupmin.group_min_d2_plain(q, codes, scales, normsq)
        return groupmin.rescore_groups(q, codes, scales, normsq, g_d, g_i, K,
                                       codes.shape[0])

    ms_fk = cuda_ms(lambda: groupmin.flat_topk_fused(q, codes, scales, normsq, K), 20)
    ms_fp = cuda_ms(plain_topk, 20)
    xc = torch.from_numpy(ds.train[:100_000])
    c_cpu, s_cpu = quantize(xc)
    c_gpu, s_gpu = quantize(xc.to(dev))
    if not (torch.equal(c_cpu, c_gpu.cpu()) and torch.equal(s_cpu, s_gpu.cpu())):
        raise AssertionError("quantize on the card differs from the CPU")
    del x, codes, scales, normsq, kd, pd, gd
    t0 = phase("kernel_vs_plain", t0, B=256, N=262144, max_abs_err=max_err,
               row_ties=ties,
               group_min_ms=f"{ms_k:.4f}", plain_ms=f"{ms_p:.4f}",
               flat_topk_ms=f"{ms_fk:.4f}", flat_topk_plain_ms=f"{ms_fp:.4f}",
               quantize_100k_equal=True)

    # -- K1 through its own entry point, then against its plain version ----------
    x = torch.from_numpy(ds.train).to(dev)
    codes, scales = quantize(x)
    del x
    normsq = point_normsq(codes, scales)
    q = dequantize(*quantize(torch.from_numpy(ds.test[:K1_B]).to(dev)))
    kern, plain = l2_kernel.pairwise_l2sq_kernel, l2_kernel.pairwise_l2sq_plain
    kern.launches = 0
    out = kern(q, codes, scales, normsq)
    torch.cuda.synchronize()
    k1_launches = kern.launches
    if (k1_launches < 1 or tuple(out.shape) != (K1_B, N)
            or not bool(torch.isfinite(out).all()) or float(out.min()) < 0.0):
        raise AssertionError("pairwise_l2sq_kernel: no launch, or an output "
                             "of the wrong shape or values")
    # the entry point's output, then a fast=True launch at the same shape,
    # each held whole against the plain version on the same inputs
    k1 = {}
    for fast in (False, True):
        if fast:
            out = kern(q, codes, scales, normsq, True)
        abs_e, rel_e = k1_check(out, plain, q, codes, scales, normsq, fast)
        del out
        ms_k1 = cuda_ms(lambda: kern(q, codes, scales, normsq, fast), 5)
        torch.cuda.empty_cache()
        ms_k1p = cuda_ms(lambda: plain(q, codes, scales, normsq, fast), 5)
        torch.cuda.empty_cache()
        k1[fast] = (abs_e, rel_e, ms_k1, ms_k1p)
    xd = dequantize(codes, scales)  # outside the timed window
    ms_k1_lib = cuda_ms(lambda: torch.cdist(
        q, xd, compute_mode="use_mm_for_euclid_dist"), 5)
    del xd
    torch.cuda.empty_cache()
    k1_bound = bound(2 * K1_B * N * padded_dim(D) * N_LIMBS,
                     K1_B * D * 4 + N * (D + 12) + K1_B * N * 4)
    rng = np.random.default_rng(0)
    cs, ss = quantize(torch.from_numpy(rng.random((300, 50), np.float32)).to(dev))
    qs = dequantize(*quantize(torch.from_numpy(rng.random((70, 50), np.float32)).to(dev)))
    ns = point_normsq(cs, ss)
    small = [k1_check(kern(qs, cs, ss, ns, fast), plain, qs, cs, ss, ns, fast)
             for fast in (False, True)]
    del codes, scales, normsq, q
    torch.cuda.empty_cache()
    k1_abs = max([v[0] for v in k1.values()] + [v[0] for v in small])
    t0 = phase("l2_kernel_vs_plain", t0, B=K1_B, N=N, d=D,
               launches=k1_launches,
               rel_err=f"{k1[False][1]:.3e}", rel_err_fast=f"{k1[True][1]:.3e}",
               rel_err_70x300x50=f"{max(v[1] for v in small):.3e}",
               max_abs_err=k1_abs, ms=f"{k1[False][2]:.4f}",
               plain_ms=f"{k1[False][3]:.4f}", ms_fast=f"{k1[True][2]:.4f}",
               plain_ms_fast=f"{k1[True][3]:.4f}", library_ms=f"{ms_k1_lib:.4f}",
               bound_ms=f"{k1_bound[0]:.4f}", bound_by=k1_bound[1],
               f32_bound_ms=f"{2 * K1_B * N * D / F32_FLOPS * 1e3:.4f}")

    # -- main path -------------------------------------------------------------
    groupmin.group_min_d2.launches = kern.launches = 0
    limbs.query_operands.launches = beam.beam_packed.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    index = HNSW(M, ef_cons=EF_CONS, dim=D, device=dev)
    index.insert_bulk(ds.train, cluster_build=True, cluster_kwargs=CLUSTER_KWARGS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print("  build phases (s):", json.dumps(
        {k: round(v, 4) for k, v in index.build_phase_s.items()}), flush=True)
    t0 = phase("index_build", t0, vec_per_s=f"{N / build_s:.1f}",
               layers=len(index.graph))
    index.finalize(pivots=PIVOTS)
    torch.cuda.synchronize()
    t0 = phase("finalize", t0, pivots=int(index._pivots[0].shape[0]))

    flat = FlatIndex(D, dev)
    flat.add(ds.train)
    if not torch.equal(flat.codes, index.points.codes):
        raise AssertionError("flat index codes differ from the HNSW store")
    gt_d, truth = flat.search(ds.test[:NQ_RECALL], K, fused=True)
    # reference: the streaming tiled search (no kernel) on 256 queries. Its
    # products sum in another order, so near-ties may swap places: the id
    # sets agree to >= 99.5%, and the sorted d2 to 1e-4 absolute, a few
    # ulps of the |q|^2 + |x|^2 (~50 here) that the affine form cancels
    ref_d, ref_i = flat.search(ds.test[:256], K)
    if truth.shape != (NQ_RECALL, K) or not np.all(np.isfinite(gt_d)):
        raise AssertionError("ground truth has the wrong shape or non-finite d")
    id_match = recall_at(truth[:256], ref_i)
    d2_err = float(np.abs(gt_d[:256] ** 2 - ref_d ** 2).max())
    if d2_err > 1e-4 or id_match < 0.995:
        raise AssertionError(f"fused ground truth disagrees with the tiled "
                             f"search (id match {id_match}, d2 err {d2_err})")
    t0 = phase("ground_truth", t0, queries=NQ_RECALL,
               launches=groupmin.group_min_d2.launches,
               tiled_id_match=f"{id_match:.4f}", tiled_d2_err=d2_err)

    chosen = None
    for ef, mi in LADDER:
        dist, ids = index.ann_batch(ds.test[:NQ_RECALL], K, ef, max_iters=mi)
        rec = recall_at(ids, truth)
        print(f"  ladder ef={ef} max_iters={mi} recall@10={rec:.4f}", flush=True)
        if rec >= 0.99:
            chosen = (ef, mi, rec)
            break
    if chosen is None:
        raise AssertionError("no (ef, max_iters) rung reaches recall@10 >= 0.99")
    ef, mi, rec = chosen
    if (ids.shape != (NQ_RECALL, K) or not np.all(np.isfinite(dist))
            or ids.min() < 0 or ids.max() >= N):
        raise AssertionError("served results have the wrong shape or values")
    t0 = phase("ladder", t0, ef=ef, max_iters=mi, recall=f"{rec:.4f}")

    qps, reps = timed_qps(index, ds.test, ef, mi)
    launches = groupmin.group_min_d2.launches
    cluster_k1 = kern.launches
    limb_launches = {"cluster": limbs.query_operands.launches}
    beam_launches = {"cluster": beam.beam_packed.launches}
    if launches < 1 or limb_launches["cluster"] < 1 or beam_launches["cluster"] < 1:
        raise AssertionError("the main path never launched group_min_d2, "
                             "its limb split or the beam kernel")

    piv_ids, piv_vecs = index._pivots
    serve_bytes = (index._packed0.numel() + piv_vecs.numel() * 4
                   + piv_ids.numel() * 4 + N * D + N * 8
                   + sum(a.numel() * 4 for a in index.graph.adjs))
    t0 = phase("serve", t0, qps=f"{qps:.1f}", batch=NQ, reps=reps,
               bytes_per_point=f"{serve_bytes / N:.1f}",
               peak_mem_gib=f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")

    # where a serving batch's time goes: the seed product + top-ef and the
    # beam loop on the stream (CUDA events; the beam's per-iteration
    # convergence read is inside), and the device's busy share of one
    # whole ann_batch call under torch.profiler
    qd = dequantize(*quantize(torch.from_numpy(ds.test).to(dev)))
    e_d2, e_ids, _ = _pivot_seeds_pos(piv_ids, piv_vecs, qd, ef)
    seed_ms = cuda_ms(lambda: _pivot_seeds_pos(piv_ids, piv_vecs, qd, ef), 3)
    beam_ms = cuda_ms(lambda: search_layer_packed(
        index._packed0, qd, e_d2, e_ids, ef, mi), 3)
    busy, top = device_profile(lambda: index.ann_batch(ds.test, K, ef, max_iters=mi))
    print("  top device kernels of one batch (ms):", json.dumps(top), flush=True)
    t0 = phase("serve_breakdown", t0, seeds_ms=f"{seed_ms:.3f}",
               beam_ms=f"{beam_ms:.3f}", batch_ms=f"{1000 * NQ / qps:.3f}",
               device_busy_share=busy)

    # the kernel at the main path's shape (B=4096, N=1M), beside its plain
    # version; these launches come after the count was read
    qg = dequantize(*quantize(torch.from_numpy(ds.test[:NQ_RECALL]).to(dev)))
    cg, sg, ng = groupmin.pad_to_groups(flat.codes, flat.scales, flat._normsq)
    kd, ki = groupmin.group_min_d2(qg, cg, sg, ng)
    pd, pi = groupmin.group_min_d2_plain(qg, cg, sg, ng)
    torch.cuda.synchronize()
    ties_main, err_main = k2_check(qg, cg, sg, ng, kd, ki, pd, pi)
    rd, ri = groupmin.rescore_groups(qg, cg, sg, ng, pd, pi, K, N)
    fd, fi = groupmin.flat_topk_fused(qg, flat.codes, flat.scales, flat._normsq, K)
    if not torch.equal(fi, ri):
        raise AssertionError("flat_topk_fused ids at B=4096, N=1M differ from "
                             "the plain route")
    del kd, pd, rd, fd
    ms_main = cuda_ms(lambda: groupmin.group_min_d2(qg, cg, sg, ng), 5)
    ms_main_plain = cuda_ms(lambda: groupmin.group_min_d2_plain(qg, cg, sg, ng), 5)
    n_pad = int(cg.shape[0])
    k2_bound = bound(2 * NQ_RECALL * n_pad * padded_dim(D) * N_LIMBS,
                     NQ_RECALL * D * 4 + n_pad * (D + 12)
                     + NQ_RECALL * (n_pad // groupmin.GROUP) * 8)
    t0 = phase("kernel_main_shape", t0, B=NQ_RECALL, N=n_pad,
               max_abs_err=err_main, row_ties=ties_main, topk_ids_equal=True,
               ms=f"{ms_main:.4f}", plain_ms=f"{ms_main_plain:.4f}",
               bound_ms=f"{k2_bound[0]:.4f}", bound_by=k2_bound[1],
               f32_bound_ms=f"{2 * NQ_RECALL * n_pad * D / F32_FLOPS * 1e3:.4f}")

    # K3 at the main path's shape (B=32,768, the chosen rung) beside its
    # plain version; these launches, too, come after the count was read
    k3_main = k3_check(index._packed0, qd, e_d2, e_ids, ef, mi,
                       index.points.codes, index.points.scales, "cluster")
    t0 = phase("beam_kernel_main_shape", t0, **k3_main)

    del qg, cg, sg, ng, ki, pi, qd, e_d2, e_ids
    torch.cuda.empty_cache()
    beam.beam_packed.launches = 0

    # -- E>1 and PQ serving on the cluster path's index ---------------------------
    index.finalize(expand=4, pivots=PIVOTS)
    _, ids4 = index.ann_batch(ds.test[:NQ_RECALL], K, ef, max_iters=mi)
    rec4 = recall_at(ids4, truth)
    if index.serve_expand != 4 or index.serving_route() != "seeded" or rec4 < rec - 0.005:
        raise AssertionError(f"expand=4: route {index.serving_route()!r}, "
                             f"recall@10 {rec4:.4f} against E=1's {rec:.4f}")
    qps4, reps = timed_qps(index, ds.test, ef, mi)
    t0 = phase("serve_expand4", t0, ef=ef, max_iters=mi, recall=f"{rec4:.4f}",
               recall_e1=f"{rec:.4f}", qps=f"{qps4:.1f}", qps_e1=f"{qps:.1f}",
               reps=reps)
    for pq_m, bits in PQ_MODES:
        index.finalize(pivots=PIVOTS, pq_m=pq_m, pq_bits=bits)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        if index.serving_route() != "pq" or index._packed0 is not None:
            raise AssertionError("finalize(pq_m=...) did not switch to PQ serving")
        recs = {}
        for pef in PQ_EFS:
            dist, ids = index.ann_batch(ds.test[:NQ_RECALL], K, pef)
            recs[pef] = recall_at(ids, truth)
            if not (np.all(np.isfinite(dist)) and recs[pef] >= 0.5):
                raise AssertionError(f"PQ serving pq_m={pq_m} bits={bits} ef={pef}: "
                                     f"recall@10 {recs[pef]}, or non-finite d")
        pq_qps, reps = timed_qps(index, ds.test, 128)
        cb, pq_codes, packed_pq, _ = index._pq
        pq_bytes = (packed_pq.numel() + pq_codes.numel() + cb.numel() * 4
                    + piv_vecs.numel() * 4 + piv_ids.numel() * 4 + N * D + N * 8
                    + sum(a.numel() * 4 for a in index.graph.adjs))
        t0 = phase(f"serve_pq{pq_m}x{bits}bit", t0, train_pack_s=f"{train_s:.3f}",
                   **{f"recall_ef{e_}": f"{r_:.4f}" for e_, r_ in recs.items()},
                   qps_ef128=f"{pq_qps:.1f}", reps=reps,
                   bytes_per_point=f"{pq_bytes / N:.1f}",
                   packed_bytes_per_point=f"{packed_pq.numel() / N:.1f}")
    # ReplicatedHNSW over [cuda:0]: the hierarchical search on its copy
    # answers as the index's own packed hierarchical route does
    index.finalize()
    rep = ReplicatedHNSW(index, make_mesh(1, 1, [dev]))
    _, rep_ids = rep.ann_batch(ds.test[:NQ_RECALL], K, ef, max_iters=mi)
    _, one_ids = index.ann_batch(ds.test[:NQ_RECALL], K, ef, max_iters=mi)
    if index.serving_route() != "packed" or not np.array_equal(rep_ids, one_ids):
        raise AssertionError("ReplicatedHNSW answers differently from the index")
    t0 = phase("replicated", t0, route="packed", ef=ef, max_iters=mi,
               queries=NQ_RECALL, ids_equal=True)
    t0 = codec_path(dev, index, ef, mi, ds.test[:NQ_RECALL], t0)
    beam_launches["replicated_codec"] = beam.beam_packed.launches
    del index, flat, cb, pq_codes, packed_pq, piv_ids, piv_vecs, rep
    torch.cuda.empty_cache()

    # -- the scale-out layer: 8 shards of the same 1M points on this card -------
    groupmin.group_min_d2.launches = limbs.query_operands.launches = 0
    beam.beam_packed.launches = 0
    t0 = sharded_path(dev, ds, truth, build_s, qps, time.perf_counter())
    sharded_launches = groupmin.group_min_d2.launches
    limb_launches["sharded"] = limbs.query_operands.launches
    beam_launches["sharded"] = beam.beam_packed.launches
    torch.cuda.empty_cache()

    # -- IVF-Flat and IVF-PQ on the cluster path's points and ground truth ---------
    groupmin.group_min_d2.launches = limbs.query_operands.launches = 0
    beam.beam_packed.launches = 0
    t0 = ivf_flat_path(dev, ds, truth, time.perf_counter())
    t0 = ivf_pq_path(dev, ds, truth, t0)
    ivf_launches = groupmin.group_min_d2.launches
    limb_launches["ivf"] = limbs.query_operands.launches
    beam_launches["ivf"] = beam.beam_packed.launches
    torch.cuda.empty_cache()

    # -- the probed path: heavy-tailed 1M, shortlist probes, refine ---------------
    groupmin.group_min_d2.launches = limbs.query_operands.launches = 0
    beam.beam_packed.launches = 0
    (probe_launches, beam_launches["probe"], k3_probe, k4_launches,
     k4_probe) = probed_path(dev, t0)
    limb_launches["probe"] = limbs.query_operands.launches
    if beam_launches["probe"] < 1:
        raise AssertionError("the probed path never launched the beam kernel")
    t0 = time.perf_counter()

    # -- the wave path: wave build, hierarchical serving, inserts ----------------
    groupmin.group_min_d2.launches = kern.launches = 0
    limbs.query_operands.launches = beam.beam_packed.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    wave = HNSW(WAVE_M, ef_cons=WAVE_EF_CONS, dim=D, device=dev)
    wave.insert_bulk(ds.train[:WAVE_N], max_iters=2 * WAVE_EF_CONS + 16)
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    print("  wave build phases (s):", json.dumps(
        {k: round(v, 4) for k, v in wave.build_phase_s.items()}), flush=True)
    if wave.serving_route() != "packed" or not wave.assert_param_compliance(False):
        raise AssertionError(f"wave build: route {wave.serving_route()!r}, or "
                             "the graph breaks the degree rules")
    t0 = phase("wave_build", t0, n=WAVE_N, vec_per_s=f"{WAVE_N / wave_s:.1f}",
               seconds=f"{wave_s:.3f}", layers=len(wave.graph),
               peak_mem_gib=f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")

    if WAVE_N != N:
        flat = FlatIndex(D, dev)
        flat.add(ds.train[:WAVE_N])
        _, truth = flat.search(ds.test[:NQ_RECALL], K, fused=True)
    chosen = None
    for ef in WAVE_LADDER:
        dist, ids = wave.ann_batch(ds.test[:NQ_RECALL], K, ef)
        rec = recall_at(ids, truth)
        print(f"  wave ladder ef={ef} max_iters={2 * ef + 16} recall@10={rec:.4f}",
              flush=True)
        if rec >= 0.99:
            chosen = (ef, rec)
            break
    if chosen is None:
        raise AssertionError("no wave ef rung reaches recall@10 >= 0.99")
    wave_ef, wave_rec = chosen
    if (ids.shape != (NQ_RECALL, K) or not np.all(np.isfinite(dist))
            or ids.min() < 0 or ids.max() >= WAVE_N):
        raise AssertionError("wave serving results have the wrong shape or values")
    t0 = phase("wave_ladder", t0, route=wave.serving_route(), ef=wave_ef,
               max_iters=2 * wave_ef + 16, recall=f"{wave_rec:.4f}")
    wave_qps, reps = timed_qps(wave, ds.test, wave_ef)
    if wave.serving_route() != "packed":
        raise AssertionError("the packed hierarchical branch did not serve")
    wave_bytes = (wave._packed0.numel() + WAVE_N * D + WAVE_N * 8
                  + sum(a.numel() * 4 for a in wave.graph.adjs))
    t0 = phase("wave_serve", t0, route="packed", qps=f"{wave_qps:.1f}",
               batch=NQ, reps=reps, ef=wave_ef,
               bytes_per_point=f"{wave_bytes / WAVE_N:.1f}")

    # where the wave build's time went: its stages summed over every wave
    # of every layer, as the builder itself timed them (device drained at
    # each stage's end); then one real layer-0 wave of 4,096 nodes run
    # again on copies of the built tables, timed by stage and under
    # torch.profiler (the copies are made inside each call); then the
    # stages of a serving batch (CUDA events) and its device busy share
    stages = {k: round(v, 4) for k, v in wave.build_phase_s.items()
              if k.startswith("wave_")}
    print("  wave build stages over all waves (s):", json.dumps(stages), flush=True)
    codes, scales, packed0 = wave.points.codes, wave.points.scales, wave._packed0
    ids_w = torch.from_numpy(np.flatnonzero(wave.points.levels == 0)[:4096]
                             .astype(np.int32)).to(dev)
    comb = comb_table(codes, scales)
    g = wave.graph

    def one_wave(phase_s=None):
        return _insert_wave_fused_impl(
            [g.get_layer(lam).clone() for lam in range(len(g))],
            [g.indeg(lam).clone() for lam in range(len(g))], codes, scales,
            ids_w, wave.ep, WAVE_EF_CONS, WAVE_M, 2 * WAVE_EF_CONS + 16, 0,
            wave.params.extend_cands, packed0=packed0.clone(), comb=comb,
            phase_s=phase_s)

    stage_s = {}
    one_wave(stage_s)
    stage_s = {k: round(v, 4) for k, v in stage_s.items()}
    wave_busy, wave_top = device_profile(one_wave)
    del comb
    print("  one build wave of 4096 (s):", json.dumps(stage_s), flush=True)
    print("  top device kernels of one build wave (ms):",
          json.dumps(wave_top), flush=True)
    qd = dequantize(*quantize(torch.from_numpy(ds.test).to(dev)))
    d_ms = cuda_ms(lambda: _descend(wave.graph.adjs[1:], codes, scales, qd,
                                    wave.ep), 3)
    e_d2, e_ids = _descend(wave.graph.adjs[1:], codes, scales, qd, wave.ep)
    b_ms = cuda_ms(lambda: search_layer_packed(packed0, qd, e_d2, e_ids, wave_ef,
                                               2 * wave_ef + 16), 3)
    serve_busy, serve_top = device_profile(lambda: wave.ann_batch(ds.test, K, wave_ef))
    print("  top device kernels of one wave-serving batch (ms):",
          json.dumps(serve_top), flush=True)
    del qd, e_d2, e_ids
    t0 = phase("wave_breakdown", t0, wave_s=f"{sum(stage_s.values()):.4f}",
               wave_busy_share=wave_busy, descent_ms=f"{d_ms:.3f}",
               beam_ms=f"{b_ms:.3f}", batch_ms=f"{1000 * NQ / wave_qps:.3f}",
               serve_busy_share=serve_busy)

    new = ds.test[NQ - N_INSERT:]
    new_ids = [wave.insert_vec(v) for v in new]
    wave.flush()
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    if new_ids != list(range(WAVE_N, WAVE_N + N_INSERT)):
        raise AssertionError("insert_vec returned unexpected ids")
    route = wave.serving_route()
    if route != "plain" or not wave.assert_param_compliance(False):
        raise AssertionError(f"after inserts: route {route!r}, or the graph "
                             "breaks the degree rules")
    _, ids = wave.ann_batch(new, K, wave_ef)
    self_rec = float(np.mean([i in row for i, row in zip(new_ids, ids)]))
    if self_rec < 0.99:
        raise AssertionError(f"inserted points find themselves in only "
                             f"{self_rec:.4f} of their top-10")
    flat = FlatIndex(D, dev)
    flat.add(np.concatenate([ds.train[:WAVE_N], new]))
    if not torch.equal(flat.codes, wave.points.codes[:WAVE_N + N_INSERT]):
        raise AssertionError("flat index codes differ from the HNSW store")
    _, truth2 = flat.search(ds.test[:NQ_RECALL], K, fused=True)
    dist, ids = wave.ann_batch(ds.test[:NQ_RECALL], K, wave_ef)
    rec2 = recall_at(ids, truth2)
    wave_launches = groupmin.group_min_d2.launches
    wave_k1 = kern.launches
    limb_launches["wave"] = limbs.query_operands.launches
    beam_launches["wave"] = beam.beam_packed.launches
    if rec2 < 0.99 or wave_launches < 1 or beam_launches["wave"] < 1:
        raise AssertionError(f"after inserts: recall@10 {rec2:.4f} at ef="
                             f"{wave_ef}, group_min_d2 launches {wave_launches}, "
                             f"beam kernel launches {beam_launches['wave']}")
    t0 = phase("wave_extend", t0, inserted=N_INSERT, insert_s=f"{insert_s:.3f}",
               route=route, self_recall=f"{self_rec:.4f}", ef=wave_ef,
               recall=f"{rec2:.4f}", n=len(wave), launches=wave_launches)
    del wave, flat
    torch.cuda.empty_cache()

    # -- the wave build's options, at a smaller depth ------------------------------
    groupmin.group_min_d2.launches = limbs.query_operands.launches = 0
    beam.beam_packed.launches = 0
    flat = FlatIndex(D, dev)
    flat.add(ds.train[:CUT_N])
    _, truth_opt = flat.search(ds.test[:NQ_RECALL], K, fused=True)
    del flat
    opt_launches = groupmin.group_min_d2.launches
    limb_launches["wave_options"] = limbs.query_operands.launches
    t0 = time.perf_counter()
    for name, kw in (("default", {}), ("wave_sort", {"wave_sort": True}),
                     ("build_seeded", {"build_seeded": True}),
                     ("build_expand2", {"build_expand": 2})):
        w = HNSW(WAVE_M, ef_cons=WAVE_EF_CONS, dim=D, device=dev)
        w.insert_bulk(ds.train[:CUT_N], max_iters=2 * WAVE_EF_CONS + 16, **kw)
        torch.cuda.synchronize()
        opt_s = time.perf_counter() - t0
        _, ids = w.ann_batch(ds.test[:NQ_RECALL], K, 128)
        rec_o = recall_at(ids, truth_opt)
        if rec_o < 0.95 or not w.assert_param_compliance(False):
            raise AssertionError(f"wave build ({name}) at N={CUT_N}: recall@10 "
                                 f"{rec_o:.4f} at ef=128, or the degree rules broke")
        stages = {k: round(v, 3) for k, v in w.build_phase_s.items()
                  if k.startswith("wave_")}
        del w
        t0 = phase(f"wave_option_{name}", t0, n=CUT_N, build_s=f"{opt_s:.3f}",
                   recall_ef128=f"{rec_o:.4f}",
                   stages=json.dumps(stages).replace(" ", ""))
    beam_launches["wave_options"] = beam.beam_packed.launches
    torch.cuda.empty_cache()

    # -- out-of-core serving, then the cosine metric and raw-float rows -----------
    groupmin.group_min_d2.launches = limbs.query_operands.launches = 0
    beam.beam_packed.launches = 0
    t0 = paged_path(dev, time.perf_counter())
    paged_launches = groupmin.group_min_d2.launches
    limb_launches["paged"] = limbs.query_operands.launches
    beam_launches["paged"] = beam.beam_packed.launches
    torch.cuda.empty_cache()
    groupmin.group_min_d2.launches = limbs.query_operands.launches = 0
    beam.beam_packed.launches = 0
    t0 = cosine_path(dev, ds, t0)
    cosine_launches = groupmin.group_min_d2.launches
    limb_launches["cosine"] = limbs.query_operands.launches
    beam_launches["cosine"] = beam.beam_packed.launches
    torch.cuda.empty_cache()
    groupmin.group_min_d2.launches = limbs.query_operands.launches = 0
    beam.beam_packed.launches = 0
    t0 = annb_path(dev, t0)
    annb_launches = groupmin.group_min_d2.launches
    limb_launches["annb"] = limbs.query_operands.launches
    beam_launches["annb"] = beam.beam_packed.launches
    torch.cuda.empty_cache()
    if min(ivf_launches, paged_launches, cosine_launches, sharded_launches,
           annb_launches) < 1:
        raise AssertionError("a new path's ground truth never launched group_min_d2")

    # -- the GloVe gate through the port's CLI, on the card ----------------------
    def glove(*flags):
        res = subprocess.run(
            [sys.executable, "-m", "hnsw_rs_tpu_torch.eval_glove", "--device",
             "cuda", *flags], cwd=ROOT, capture_output=True, text=True, timeout=300)
        rows = [ln.split() for ln in res.stdout.splitlines() if len(ln.split()) == 3
                and (ln.split()[0].isdigit() or ln.split()[0].startswith("probe="))]
        if res.returncode != 0 or not rows:
            print(res.stdout[-2000:], res.stderr[-2000:], flush=True)
            raise AssertionError(f"eval_glove {' '.join(flags)} on the card failed")
        return res.stdout, rows

    out, rows = glove()
    if float(rows[0][1]) <= 0.99 or "Index complies with params." not in out:
        print(out[-2000:], flush=True)
        raise AssertionError("eval_glove on the card failed its gate")
    t0 = phase("eval_glove", t0, ef=rows[0][0], recall=rows[0][1], qps=rows[0][2])
    # 31 lists for the 1,000 stored words: every list probed is the exact search
    for model, floor in (("ivf", 1.0), ("pq", 0.9)):
        _, rows = glove("--model", model, "--probe", "8", "31", "--quiet")
        if float(rows[-1][1]) < floor:
            raise AssertionError(f"eval_glove --model {model}: recall@10 "
                                 f"{rows[-1][1]} at full probe")
        t0 = phase(f"eval_glove_{model}", t0, **{
            r[0].replace("=", ""): f"{r[1]}@{r[2]}qps" for r in rows})

    t0 = entry_path(dev, t0)

    print(json.dumps({"kernels": [{
        "name": "group_min_d2", "route": "cuda", "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES,
        "launches": (launches + ivf_launches + probe_launches + wave_launches
                     + opt_launches + paged_launches + cosine_launches
                     + sharded_launches + annb_launches),
        "max_abs_err": max(max_err, err_main), "ms": ms_main,
        "plain_ms": ms_main_plain, "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1], "library_ms": None,
        "main_path_launches": {"cluster": launches, "ivf": ivf_launches,
                               "probe": probe_launches, "wave": wave_launches,
                               "wave_options": opt_launches,
                               "paged": paged_launches,
                               "cosine": cosine_launches,
                               "sharded": sharded_launches,
                               "annb": annb_launches},
    }, {
        "name": "pairwise_l2sq_kernel", "route": "cuda", "source": K1_SRC,
        "replaces": K1_REPLACES, "launches": k1_launches,
        "max_abs_err": k1_abs, "ms": k1[False][2], "plain_ms": k1[False][3],
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
        "library_ms": ms_k1_lib,
        "main_path_launches": {"entry_point": k1_launches,
                               "cluster": cluster_k1, "wave": wave_k1},
    }, {
        # the pre-pass of both kernels' tensor-core form: it makes the
        # limbs they take in place of the Pallas kernels' float queries
        "name": "query_limbs", "route": "cuda", "source": LIMB_SRC,
        "replaces": KERNEL_REPLACES, "launches": sum(limb_launches.values()),
        "max_abs_err": limb_err, "ms": ms_limb, "plain_ms": ms_limb_plain,
        "bound_ms": limb_bound, "bound_by": "bytes", "library_ms": None,
        "main_path_launches": limb_launches,
    }, {
        # K3: the whole E=1 layer-0 walk of every query in one launch
        "name": "beam_packed", "route": "cuda", "source": K3_SRC,
        "replaces": K3_REPLACES, "launches": sum(beam_launches.values()),
        "max_abs_err": max(k3_main["max_abs_err"], k3_probe["max_abs_err"]),
        "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"],
        "bound_ms": k3_main["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "main_path_launches": beam_launches,
        "shapes": {"cluster": k3_main, "probed": k3_probe},
    }, {
        # K4: a query chunk's whole probe stage in one launch
        "name": "probe_packed", "route": "cuda", "source": K4_SRC,
        "replaces": K4_REPLACES, "launches": k4_launches,
        "max_abs_err": max(c["max_abs_err"] for c in k4_probe.values()),
        "ms": k4_probe["probed"]["ms"], "plain_ms": k4_probe["probed"]["plain_ms"],
        "bound_ms": k4_probe["probed"]["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "main_path_launches": {"probe": k4_launches},
        "shapes": k4_probe,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
