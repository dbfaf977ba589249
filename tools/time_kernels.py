"""Times the port's kernels through their wrappers on one GPU, so that two
checkouts can be compared in one run on the same card.

    python3 tools/time_kernels.py [--root DIR] [--kernel k2|k1|k3|k4]
                                  [--batches 1,256] [--n 262144] [--d 96]

``--root`` is the checkout whose ``hnsw_rs_tpu_torch`` is imported (this
one by default; an older one unpacked with ``git archive`` works too, as
long as its wrappers are ``groupmin.group_min_d2`` and
``l2_kernel.pairwise_l2sq_kernel``). Its kernels are built from its own
sources first. Inputs are made from a seed with numpy: uniform points
quantized by the checkout's own ``quantize``, queries dequantized from
their codes. For each batch size it prints one JSON line:

- ``call_ms``: the wrapper, CUDA events around back-to-back calls. When the
  host issues calls more slowly than the card runs them, this is the
  host's rate.
- ``host_ms``: the host's time to issue one call (perf_counter around the
  same loop, stopped before the final sync).
- ``device_ms``: the card's busy time per call, all kernels of the call
  summed (torch.profiler), ``kernel_device_ms`` the distance kernel's
  share of it and ``kernels_per_call`` how many kernels one call runs;
  "not measured" when the profiler sees no device activity.
- ``operands_ms``: the query's limb split alone. Where the checkout splits
  the limbs on the card (``ops/limbs.query_operands``) that is one kernel
  through its own entry point; where it has
  ``ops/limbs.tensor_core_operands`` (plain PyTorch) that preparation,
  and then also ``launch_ms``, the C launch alone with the operands made
  outside the timed window.

``--kernel k3`` times the packed layer-0 beam (``ops/beam.beam_packed``)
at the three serving cells' walks instead (``--batches`` and ``--d`` are
not read): ``batch`` (B 10,000, ef 16, 8 expansions, d 128), ``probed``
(B 10,000, ef 384, up to 500 expansions, d 96) and ``online`` (B 1, as
``batch``), cap 48, over ``--n`` points (default 1M for k3) in 1,000
Gaussian clusters and a graph whose rows hold 24 random members of the
point's cluster and 24 random points, seeded from the top-ef of 16,384
random pivots. Each line gives ``call_ms`` (CUDA events), ``host_ms``,
``device_ms``, ``kernel_device_ms`` and ``kernels_per_call`` as above,
``expansions`` (summed over the queries, from the kernel's tally),
``bound_ms`` (those rows' bytes over 3.35 TB/s), ``share`` (``bound_ms``
over the kernel's device time) and ``plain_ms``: the plain version
(``search._search_layer_packed_loop``, the lockstep loop) on the same
inputs, by CUDA events.

``--kernel k4`` times the probe stage (``ops/probe.probe_packed``) at the
probed cells' shape instead (``--batches`` and ``--d`` are not read): B
10,000 queries, P 32,768 pivots, shortlists of T 256, d 96, 36 probes, ef
384, over ``--n`` points (default 1M for k4) in 1,000 Gaussian clusters,
each pivot's shortlist 256 random members of its cluster, the seeds
(``search._pivot_seeds_pos``) made once and given to both versions. The
line gives ``call_ms``, ``host_ms``, ``device_ms``, ``kernel_device_ms`` and
``kernels_per_call`` as above, ``rows`` (shortlist rows gathered),
``bound_ms`` (those rows' bytes over 3.35 TB/s), ``share``, ``plain_ms``:
the plain version (``search._probe_stage`` over the query chunks the plain
path takes) on the same seeds, by CUDA events, ``rows_differ``: rows whose
ids differ between the two, and those differences sorted by
``chip_smoke.near_ties``' rule (``near_tie_slots``, ``max_abs_err``) and,
beyond it, ``chip_smoke.off_the_s_key``'s (``rows_at_s_key``: rows whose
survivors differ by a distance at the pool's s-th key; ``rows_apart``: the
rest, which make the run exit non-zero).

The first line printed is the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def events_ms(fn, reps):
    """(mean ms per call by CUDA events, mean host ms to issue a call)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    ts = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - ts) * 1e3 / reps
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, host


def profiled(fn, reps, kernel_words):
    """(device ms per call, the distance kernel's ms per call, kernels per
    call) from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return "not measured", "not measured", "not measured"
    us = [e.time_range.end - e.time_range.start for e in dev]
    mine = sum(u for e, u in zip(dev, us)
               if any(w in e.name for w in kernel_words))
    return sum(us) / reps / 1e3, mine / reps / 1e3, len(dev) / reps


K3_WALKS = {  # name: (B, ef, max_iters, d)
    "batch": (10_000, 16, 8, 128),
    "probed": (10_000, 384, 500, 96),
    "online": (1, 16, 8, 128),
}


def time_beam(n, seed):
    """One JSON line per walk of ``K3_WALKS`` (module docstring)."""
    from hnsw_rs_tpu_torch import search
    from hnsw_rs_tpu_torch.ops import beam, cuda_build
    from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize

    dev = torch.device("cuda", 0)
    cuda_build.build("beam_packed")
    cap, k = 48, 1000
    g = torch.Generator(device=dev).manual_seed(seed)
    for walk, (b, ef, max_iters, d) in K3_WALKS.items():
        cent = torch.rand((k, d), generator=g, device=dev)
        lab = torch.randint(0, k, (n,), generator=g, device=dev)
        codes, scales = quantize(cent[lab] + 0.05 * torch.randn(
            (n, d), generator=g, device=dev))
        order = torch.argsort(lab)
        size = torch.bincount(lab, minlength=k)
        start = torch.cumsum(size, 0) - size
        pick = (torch.rand((n, cap // 2), generator=g, device=dev)
                * size[lab][:, None]).long() + start[lab][:, None]
        adj = torch.cat([order[pick], torch.randint(
            0, n, (n, cap - cap // 2), generator=g, device=dev)], 1).int()
        packed = search.pack_layer(adj, codes, scales)
        del adj, pick, order
        qlab = torch.randint(0, k, (b,), generator=g, device=dev)
        q = dequantize(*quantize(cent[qlab] + 0.05 * torch.randn(
            (b, d), generator=g, device=dev)))
        piv = torch.randint(0, n, (16_384,), generator=g, device=dev).int()
        e_d2, e_ids = search._pivot_seeds(
            piv, dequantize(codes[piv.long()], scales[piv.long()]), q, ef)
        ring = max(2 * cap, 64)
        tally = torch.zeros(1 + 2 * cap, dtype=torch.int64, device=dev)
        beam.beam_packed(packed, q, e_d2, e_ids, ef, max_iters, ring,
                         tally=tally)
        expansions = int(tally[0])

        def call():
            return beam.beam_packed(packed, q, e_d2, e_ids, ef, max_iters, ring)

        reps = 200 if b == 1 else 20
        call_ms, host_ms = events_ms(call, reps)
        dev_ms, kern_ms, per_call = profiled(call, min(reps, 20),
                                             ("beam_kernel",))
        plain_ms = events_ms(lambda: search._search_layer_packed_loop(
            packed, q, e_d2, e_ids, ef, max_iters), 2 if b > 1 else 20)[0]
        bound_ms = expansions * cap * (d + 12) / 3.35e12 * 1e3
        share = (bound_ms / kern_ms if isinstance(kern_ms, float) and kern_ms
                 else "not measured")
        print(json.dumps({
            "kernel": "k3", "walk": walk, "B": b, "N": n, "d": d, "cap": cap,
            "ef": ef, "max_iters": max_iters, "expansions": expansions,
            "call_ms": call_ms, "host_ms": host_ms, "device_ms": dev_ms,
            "kernel_device_ms": kern_ms, "kernels_per_call": per_call,
            "bound_ms": bound_ms, "share": share, "plain_ms": plain_ms}),
            flush=True)
        del packed, codes, scales
        torch.cuda.empty_cache()


def time_probe(n, seed):
    """The line of ``--kernel k4`` (module docstring)."""
    from hnsw_rs_tpu_torch import search
    from hnsw_rs_tpu_torch.ops import cuda_build, probe
    from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize
    from chip_smoke import near_ties, off_the_s_key

    dev = torch.device("cuda", 0)
    cuda_build.build("probe_packed")
    b, p, t, d, probes, ef, k = 10_000, 32_768, 256, 96, 36, 384, 1000
    g = torch.Generator(device=dev).manual_seed(seed)
    cent = torch.rand((k, d), generator=g, device=dev)
    lab = torch.randint(0, k, (n,), generator=g, device=dev)
    codes, scales = quantize(cent[lab] + 0.05 * torch.randn(
        (n, d), generator=g, device=dev))
    order = torch.argsort(lab)
    size = torch.bincount(lab, minlength=k)
    start = torch.cumsum(size, 0) - size
    piv = torch.randint(0, n, (p,), generator=g, device=dev)
    pick = (torch.rand((p, t), generator=g, device=dev)
            * size[lab[piv]][:, None]).long() + start[lab[piv]][:, None]
    pack = search.pack_layer(order[pick].int(), codes, scales)
    pvecs = dequantize(codes[piv], scales[piv])
    qlab = torch.randint(0, k, (b,), generator=g, device=dev)
    q = dequantize(*quantize(cent[qlab] + 0.05 * torch.randn(
        (b, d), generator=g, device=dev)))
    del order, pick, lab
    e_d2, e_ids, pos = search._pivot_seeds_pos(piv.int(), pvecs, q, ef)

    def call():
        return probe.probe_packed(pack, t, q, e_d2, e_ids, pos, ef, probes)

    step = search._query_chunk(b, search._probe_bytes_per_query(
        t, d, p, ef, probes, packed=True), dev)

    def plain():
        def score(qc, pp):
            return search._score_probe_packed(pack, t, d, qc, pp)
        outs = [search._probe_stage(score, q[lo:lo + step], e_d2[lo:lo + step],
                                    e_ids[lo:lo + step], pos[lo:lo + step],
                                    ef, probes) for lo in range(0, b, step)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    call_ms, host_ms = events_ms(call, 20)
    dev_ms, kern_ms, per_call = profiled(call, 20, ("probe_kernel",))
    plain_ms = events_ms(plain, 2)[0]
    kd2, kids = call()
    pd2, pids = plain()
    rows_differ = int((kids != pids).any(1).sum())
    ties, at_key, err = near_ties(q, codes, scales, pd2, pids, kd2, kids)
    apart = off_the_s_key(pack, t, q, e_d2, e_ids, pos, ef, probes, codes,
                          scales, pd2, pids, kd2, kids, at_key)
    rows = b * min(probes, pos.shape[1])
    bound_ms = rows * t * (d + 12) / 3.35e12 * 1e3
    share = (bound_ms / kern_ms if isinstance(kern_ms, float) and kern_ms
             else "not measured")
    print(json.dumps({
        "kernel": "k4", "B": b, "N": n, "P": p, "T": t, "d": d,
        "probes": probes, "ef": ef, "rows": rows, "call_ms": call_ms,
        "host_ms": host_ms, "device_ms": dev_ms, "kernel_device_ms": kern_ms,
        "kernels_per_call": per_call, "bound_ms": bound_ms, "share": share,
        "plain_ms": plain_ms, "plain_chunk": step, "rows_differ": rows_differ,
        "near_tie_slots": ties, "rows_at_s_key": len(at_key) - len(apart),
        "rows_apart": len(apart), "max_abs_err": err}), flush=True)
    if apart:
        raise SystemExit(f"probe kernel: {len(apart)} of {b} rows apart from "
                         "the plain stage")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--kernel", choices=("k2", "k1", "k3", "k4"), default="k2")
    ap.add_argument("--batches", default="1,256")
    ap.add_argument("--n", type=int, default=None,
                    help="points (default 262,144; 1,000,000 for k3, k4)")
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if args.kernel == "k3":
        return time_beam(args.n or 1_000_000, args.seed)
    if args.kernel == "k4":
        return time_probe(args.n or 1_000_000, args.seed)
    args.n = args.n or 262_144
    from hnsw_rs_tpu_torch.ops import cuda_build, groupmin, l2_kernel
    from hnsw_rs_tpu_torch.ops.distance import point_normsq
    from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize

    dev = torch.device("cuda", 0)
    name = "group_min" if args.kernel == "k2" else "l2_kernel"
    cuda_build.build(name)
    rng = np.random.default_rng(args.seed)
    codes, scales = quantize(torch.from_numpy(
        rng.random((args.n, args.d), np.float32)).to(dev))
    normsq = point_normsq(codes, scales)
    try:
        from hnsw_rs_tpu_torch.ops import limbs as limbs_mod
    except ImportError:  # a checkout from before the tensor-core kernels
        limbs_mod = None
    tensor_core_operands = getattr(limbs_mod, "tensor_core_operands", None)
    query_operands = getattr(limbs_mod, "query_operands", None)
    if query_operands is not None:
        cuda_build.build("query_limbs")
    for b in (int(x) for x in args.batches.split(",")):
        q = dequantize(*quantize(torch.from_numpy(
            rng.random((b, args.d), np.float32)).to(dev)))
        if args.kernel == "k2":
            def call():
                return groupmin.group_min_d2(q, codes, scales, normsq)
        else:
            def call():
                return l2_kernel.pairwise_l2sq_kernel(q, codes, scales, normsq)
        reps = 200 if b * args.n <= 1 << 26 else 20
        call_ms, host_ms = events_ms(call, reps)
        dev_ms, kern_ms, per_call = profiled(
            call, min(reps, 20), ("dist_kernel", "group_min", "l2_kernel", "l2sq"))
        row = {"root": root, "kernel": args.kernel, "B": b, "N": args.n,
               "d": args.d, "reps": reps, "call_ms": call_ms, "host_ms": host_ms,
               "device_ms": dev_ms, "kernel_device_ms": kern_ms,
               "kernels_per_call": per_call}
        if query_operands is not None:
            row["operands_ms"] = events_ms(lambda: query_operands(q), reps)[0]
        elif tensor_core_operands is not None:
            row["operands_ms"] = events_ms(lambda: tensor_core_operands(
                q, codes, scales, normsq), reps)[0]
            ops = tensor_core_operands(q, codes, scales, normsq)
            limbs, qscale, qsq, qsum, codes_g, scales_g, normsq_g, d_pad, d_g = ops
            n = codes.shape[0]
            if args.kernel == "k2":
                out_d = torch.empty((b, n // 128), dtype=torch.float32, device=dev)
                out_i = torch.empty((b, n // 128), dtype=torch.int32, device=dev)
                sym, argtypes, outs = ("group_min_d2_launch", groupmin._ARGTYPES,
                                       (out_d.data_ptr(), out_i.data_ptr()))
            else:
                out = torch.empty((b, n), dtype=torch.float32, device=dev)
                sym, argtypes, outs = ("pairwise_l2sq_launch", l2_kernel._ARGTYPES,
                                       (out.data_ptr(),))
            ptrs = [t.data_ptr() for t in (limbs, qscale, qsq, qsum, codes_g,
                                           scales_g, normsq_g)]
            row["launch_ms"] = events_ms(lambda: cuda_build.launch(
                name, sym, argtypes, dev, *ptrs, *outs, b, n, d_pad, d_g), reps)[0]
        print(json.dumps(row), flush=True)
        del q
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
