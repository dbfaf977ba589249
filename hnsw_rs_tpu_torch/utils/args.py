"""CLI argument parsing (port of ``hnsw_rs_tpu/utils/args.py``), with a
required ``--device``: the port picks no device by itself."""

from __future__ import annotations

import argparse


def eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hnsw_rs_tpu_torch.eval_glove",
        description="Build an HNSW index over GloVe embeddings and evaluate "
        "recall/QPS against exact brute force.",
    )
    p.add_argument("--device", required=True,
                   help="torch device to hold the index on (cpu, cuda, cuda:1)")
    p.add_argument("--model", choices=("hnsw", "flat", "ivf", "pq"), default="hnsw",
                   help="index family to evaluate")
    p.add_argument("--n-lists", type=int, default=0,
                   help="IVF lists (0 = sqrt(N))")
    p.add_argument("--probe", type=int, nargs="+", default=[8],
                   help="IVF n_probe value(s) to sweep")
    p.add_argument("--metric", choices=("l2", "cosine"), default="l2")
    p.add_argument("--store", default="test-data/store.txt",
                   help="GloVe text file with stored vectors")
    p.add_argument("--queries", default="test-data/queries.txt",
                   help="GloVe text file with query vectors")
    p.add_argument("--lim", type=int, default=0,
                   help="max rows to load (0 = all)")
    p.add_argument("--m", type=int, default=12, help="HNSW M parameter")
    p.add_argument("--ef-cons", type=int, default=None,
                   help="construction beam width (default 2*M)")
    p.add_argument("--ef", type=int, nargs="+", default=[100],
                   help="query beam width(s) to sweep")
    p.add_argument("--build-expand", type=int, default=1,
                   help="beam pops per construction-search iteration "
                   "(E>1: fewer, wider lockstep iterations)")
    p.add_argument("--build-seeded", action="store_true",
                   help="seed layer-0 construction searches from the "
                   "level>=1 pivot skeleton (one product) instead of "
                   "greedy descent; pair with a tighter --build-mi")
    p.add_argument("--cluster-build", action="store_true",
                   help="cluster-bulk build instead of the wave builder")
    p.add_argument("--build-mi", type=int, default=None,
                   help="construction-search iteration cap (default "
                   "2*ef_cons+16)")
    p.add_argument("--expand", type=int, default=1,
                   help="beam pops per serving-search iteration (E>1 "
                   "amortizes the per-iteration fixed costs)")
    p.add_argument("--pivots", type=int, default=0,
                   help="enable pivot-seeded serving with this many pivots")
    p.add_argument("--pq-m", type=int, default=0,
                   help="enable PQ-coded serving with this many bytes per "
                   "point (requires --pivots; ADC beams and an exact rerank)")
    p.add_argument("--k", type=int, default=10, help="neighbors per query")
    p.add_argument("--batch", type=int, default=0,
                   help="query batch size for the QPS measurement "
                   "(0 = one pass over the query set)")
    p.add_argument("--save", default=None, help="save the index to this dir")
    p.add_argument("--load", default=None, help="load an index instead of building")
    p.add_argument("--import-reference", default=None,
                   help="import a reference-format (Rust hnsw_rs) index dir")
    p.add_argument("--words", action="store_true",
                   help="interactive nearest-word REPL after evaluation")
    p.add_argument("--quiet", action="store_true")
    return p
