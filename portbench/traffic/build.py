"""Bulk re-indexing: the window builds the configuration's index from
the same points again and again, whole builds (``build`` of the index
family: ``insert_bulk`` then ``finalize``) one after another, each
dropping the index before it; the build in flight when the clock ends is
finished and counted. Set-up makes one build of the same points (every
shape warm). After the window the last index answers the query set at
the cell's rung; those answers are judged. With tracing, one more whole
build runs under the profiler."""

from __future__ import annotations

import gc
import time

import numpy as np


def run(cell) -> dict:
    train, queries = cell.make_data()
    index, _ = cell.build(train)
    index = None
    gc.collect()
    builds = []
    t0 = time.perf_counter()
    end = t0 + cell.seconds
    while True:
        index = None
        gc.collect()
        index, spans = cell.build(train)
        builds.append(spans)
        if time.perf_counter() >= end:
            break
    t1 = time.perf_counter()
    d, i = cell.search(index, queries)
    answers = [(np.arange(queries.shape[0]), d, i)]
    rec = {"window_start": t0, "window_s": t1 - t0, "answers": answers,
           "points_built": len(builds) * train.shape[0], "builds": builds}
    if cell.trace:
        index = None
        gc.collect()
        (index, _), rec["trace"] = cell.traced(lambda: cell.build(train))
        rec["traced_calls"], rec["traced_queries"] = 1, 0
    index = None
    return rec
