"""Closed-loop batches: one caller sends every query of the set in one
call, again and again, at the cell's fixed rung (ann-benchmarks' batch
mode). Parameters: ``warmup_calls``, ``traced_calls``, and
``judged_share``: the window's first call is judged, and each later one
with this probability, drawn from the seed. Keeping every call's answers
alive through the window makes the host map fresh memory on every call,
which slows the calls by a varying few percent."""

from __future__ import annotations

import gc
import time

import numpy as np

from portbench.lib.seeds import derive


def run(cell) -> dict:
    train, queries = cell.make_data()
    index, _ = cell.build(train)
    qidx = np.arange(queries.shape[0])
    share = float(cell.params["judged_share"])
    pick = np.random.default_rng(derive(cell.seed, "batch-judged"))
    for _ in range(int(cell.params["warmup_calls"])):
        cell.search(index, queries)
    gc.collect()
    answers, calls = [], 0
    t0 = time.perf_counter()
    end = t0 + cell.seconds
    while True:
        d, i = cell.search(index, queries)
        if calls == 0 or pick.random() < share:
            answers.append((qidx, d, i))
        calls += 1
        if time.perf_counter() >= end:
            break
    t1 = time.perf_counter()
    rec = {"window_start": t0, "window_s": t1 - t0, "answers": answers,
           "queries_answered": calls * queries.shape[0]}
    if cell.trace:
        n = int(cell.params["traced_calls"])
        outs, rec["trace"] = cell.traced(
            lambda: [cell.search(index, queries) for _ in range(n)])
        answers.extend((qidx, d, i) for d, i in outs)
        rec["traced_calls"], rec["traced_queries"] = n, n * queries.shape[0]
    return rec
