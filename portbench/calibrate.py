"""Find a cell's rung once, on the card: walk the workload file's
``ladder`` of (ef, max_iters) on a few seeds and print each rung's
recall@10 over the whole query set (the judge's number) and the seconds
of one call. The chosen rung is written into the workload file by hand,
with its readings in PERF.md; runs never search for one.

    python3 portbench/calibrate.py --workload sift1m.batch --seeds 11,12,13
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# rungs walked past the first one that meets the gate
PAST = 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from portbench.lib.cell import Cell
    from portbench.lib.layout import Layout
    from portbench.reference.judge import Reference

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    layout = Layout(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = Cell(layout, args.workload, seed, 0, False, dev)
        t0 = time.perf_counter()
        train, queries = cell.make_data()
        t1 = time.perf_counter()
        index, spans = cell.build(train)
        ref = Reference(train, queries, cell.k, dev, cell.config["metric"])
        qidx = np.arange(queries.shape[0])
        print(json.dumps({"seed": seed, "data_s": t1 - t0, **spans}), flush=True)
        past = None
        for rung in cell.workload["ladder"]:
            cell.rung = rung
            cell.search(index, queries)
            cell.drain()
            t = time.perf_counter()
            d, i = cell.search(index, queries)
            call_s = time.perf_counter() - t
            num = ref.judge([(qidx, d, i)])
            print(json.dumps({"seed": seed, **rung, "recall": num["recall_at_10"],
                              "dist_err": num["dist_err"], "call_s": call_s}),
                  flush=True)
            if num["recall_at_10"] >= 0.99:
                past = 0 if past is None else past + 1
            else:
                past = None
            if past is not None and past >= PAST:
                break
        del index, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
