"""Times the port's distance kernels through their wrappers on one GPU, so
that two checkouts can be compared in one session on the same card.

    python3 tools/time_kernels.py [--root DIR] [--kernel k2|k1]
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
- where the checkout has ``ops/limbs.tensor_core_operands`` (the tensor-core
  kernels): ``operands_ms``, that preparation alone, and ``launch_ms``,
  the C launch alone with the operands made outside the timed window.

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--kernel", choices=("k2", "k1"), default="k2")
    ap.add_argument("--batches", default="1,256")
    ap.add_argument("--n", type=int, default=262_144)
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
        from hnsw_rs_tpu_torch.ops.limbs import tensor_core_operands
    except ImportError:
        tensor_core_operands = None
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
        if tensor_core_operands is not None:
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
