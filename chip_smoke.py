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
7. ``python -m hnsw_rs_tpu_torch.eval_glove --device cuda`` on the
   bundled ``test-data``: the GloVe gate on the card.

After the two paths, K2 again at the main path's shape (B=4,096,
N=1,000,064) against its plain version, with ``flat_topk_fused`` ids
held equal to the plain route's there too. It prints the kernels' JSON
line (each kernel's time, plain and library times, the least time the
card could take for the same work, and its launches on each path), then
as its last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the exit
code is then not 0; without a CUDA device it exits non-zero at once.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N, D, K, M, EF_CONS, NQ, NQ_RECALL, PIVOTS = (
    1_000_000, 96, 10, 24, 128, 32768, 4096, 16384)
# the wave path: benchmarks/bench_wave_quality.py:40-68 (M=16, ef_cons=96)
WAVE_N, WAVE_M, WAVE_EF_CONS, N_INSERT = N, 16, 96, 2048
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
KERNEL_SRC = "hnsw_rs_tpu_torch/csrc/group_min.cu"
KERNEL_REPLACES = "hnsw_rs_tpu/ops/pallas/l2_groupmin.py:78"
K1_SRC = "hnsw_rs_tpu_torch/csrc/l2_kernel.cu"
K1_REPLACES = "hnsw_rs_tpu/ops/pallas/l2_kernel.py:66"


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


def timed_qps(index, queries, ef, max_iters=None):
    """End-to-end QPS of ``ann_batch`` over ``queries`` (one warm call,
    then at least 3 calls and 3 s)."""
    index.ann_batch(queries, K, ef, max_iters=max_iters)
    torch.cuda.synchronize()
    reps, ts = 0, time.perf_counter()
    while reps < 3 or time.perf_counter() - ts < 3.0:
        index.ann_batch(queries, K, ef, max_iters=max_iters)
        reps += 1
    torch.cuda.synchronize()
    return len(queries) * reps / (time.perf_counter() - ts), reps


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
    from hnsw_rs_tpu_torch.ops import cuda_build, groupmin, l2_kernel
    from hnsw_rs_tpu_torch.ops.distance import point_normsq
    from hnsw_rs_tpu_torch.ops.limbs import N_LIMBS, padded_dim
    from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize
    from hnsw_rs_tpu_torch.search import (
        _descend, _pivot_seeds_pos, comb_table, search_layer_packed)
    from hnsw_rs_tpu_torch.utils.datasets import synthetic_clustered
    t0 = phase("device", t0, kind=repr(kind))

    libs = cuda_build.build("group_min", "l2_kernel")
    tensor_ops = {}
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line or "C75" in line and "C7519" not in line:
                print(f"  ptxas {lib.name}:", line.strip())
        ops = tensor_ops[lib.name] = sass_counts(lib)
        print(f"  sass {lib.name}:", json.dumps(ops), flush=True)
        if ops["IGMMA"] + ops["IMMA"] == 0:
            raise AssertionError(f"{lib.name} has no int8 tensor-core instruction")
    t0 = phase("build", t0, libraries=",".join(lib.name for lib in libs),
               tensor_core_instructions=json.dumps(tensor_ops).replace(" ", ""))

    ds = synthetic_clustered(N, D, n_queries=NQ, seed=42)
    t0 = phase("data", t0, n=N, d=D, queries=NQ)

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
    if launches < 1:
        raise AssertionError("the main path never launched group_min_d2")

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

    del qg, cg, sg, ng, index
    torch.cuda.empty_cache()

    # -- the wave path: wave build, hierarchical serving, inserts ----------------
    groupmin.group_min_d2.launches = kern.launches = 0
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
    if rec2 < 0.99 or wave_launches < 1:
        raise AssertionError(f"after inserts: recall@10 {rec2:.4f} at ef="
                             f"{wave_ef}, group_min_d2 launches {wave_launches}")
    t0 = phase("wave_extend", t0, inserted=N_INSERT, insert_s=f"{insert_s:.3f}",
               route=route, self_recall=f"{self_rec:.4f}", ef=wave_ef,
               recall=f"{rec2:.4f}", n=len(wave), launches=wave_launches)
    del wave, flat
    torch.cuda.empty_cache()

    # -- the GloVe gate through the port's CLI, on the card ----------------------
    res = subprocess.run(
        [sys.executable, "-m", "hnsw_rs_tpu_torch.eval_glove", "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    rows = [ln.split() for ln in res.stdout.splitlines()
            if len(ln.split()) == 3 and ln.split()[0].isdigit()]
    if (res.returncode != 0 or not rows or float(rows[0][1]) <= 0.99
            or "Index complies with params." not in res.stdout):
        print(res.stdout[-2000:], res.stderr[-2000:], flush=True)
        raise AssertionError("eval_glove on the card failed its gate")
    t0 = phase("eval_glove", t0, ef=rows[0][0], recall=rows[0][1], qps=rows[0][2])

    print(json.dumps({"kernels": [{
        "name": "group_min_d2", "route": "cuda", "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES, "launches": launches + wave_launches,
        "max_abs_err": max(max_err, err_main), "ms": ms_main,
        "plain_ms": ms_main_plain, "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1], "library_ms": None,
        "main_path_launches": {"cluster": launches, "wave": wave_launches},
    }, {
        "name": "pairwise_l2sq_kernel", "route": "cuda", "source": K1_SRC,
        "replaces": K1_REPLACES, "launches": k1_launches,
        "max_abs_err": k1_abs, "ms": k1[False][2], "plain_ms": k1[False][3],
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
        "library_ms": ms_k1_lib,
        "main_path_launches": {"entry_point": k1_launches,
                               "cluster": cluster_k1, "wave": wave_k1},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
