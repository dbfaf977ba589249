"""Closed-loop single queries: one caller sends one query per call and
waits for it, cycling through the query set in an order drawn from the
seed, at the cell's fixed rung. Each request's latency is read from CUDA
events recorded on the device's stream before the call and after it
returns (the host clock on a CPU run). Parameters: ``warmup_requests``,
``traced_requests``."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.lib.seeds import derive


def run(cell) -> dict:
    train, queries = cell.make_data()
    index, _ = cell.build(train)
    nq = queries.shape[0]
    order = np.random.default_rng(derive(cell.seed, "online-order")).permutation(nq)
    cuda = cell.device.type == "cuda"
    for r in range(int(cell.params["warmup_requests"])):
        j = order[r % nq]
        cell.search(index, queries[j:j + 1])
    cell.drain()
    gc.collect()
    answers, marks = [], []
    r = 0
    t0 = time.perf_counter()
    end = t0 + cell.seconds
    while True:
        j = order[r % nq]
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            e0.record()
            d, i = cell.search(index, queries[j:j + 1])
            e1.record()
            marks.append((e0, e1))
        else:
            h0 = time.perf_counter()
            d, i = cell.search(index, queries[j:j + 1])
            marks.append(time.perf_counter() - h0)
        answers.append((order[r % nq:r % nq + 1], d, i))
        r += 1
        if time.perf_counter() >= end:
            break
    t1 = time.perf_counter()
    cell.drain()
    lat = ([e0.elapsed_time(e1) for e0, e1 in marks] if cuda
           else [1e3 * s for s in marks])
    rec = {"window_start": t0, "window_s": t1 - t0, "answers": answers,
           "latencies_ms": lat, "requests": r}
    if cell.trace:
        n = int(cell.params["traced_requests"])
        picks = [order[(r + s) % nq] for s in range(n)]
        outs, rec["trace"] = cell.traced(
            lambda: [cell.search(index, queries[j:j + 1]) for j in picks])
        answers.extend((np.array([j]), d, i) for j, (d, i) in zip(picks, outs))
        rec["traced_calls"] = rec["traced_queries"] = n
    return rec
