"""GloVe evaluation CLI (port of ``hnsw_rs_tpu/eval_glove.py``, the
reference's ``eval_glove`` binary, ``eval_glove/src/main.rs:17-121``): a
timed bulk build, one incremental insert, exact brute-force truth, a
recall/QPS sweep over ef values, an optional save/reload round trip, the
compliance check and the nearest-word REPL; ``--import-reference DIR``
evaluates an index in the Rust reference's directory format
(``utils.serializer``) in place of a build; ``--model flat|ivf|pq``
evaluates the other families on the same data.

Run: ``python -m hnsw_rs_tpu_torch.eval_glove --device cuda [--m 12] [--ef 50 100]``
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .models.hnsw import HNSW
from .utils.args import eval_parser
from .utils.glove import brute_force_nns, load_glove_array


def recall_at_k(ann: np.ndarray, truth: np.ndarray, k: int) -> float:
    return float(
        np.mean([len(set(a[:k]) & set(t[:k])) / k for a, t in zip(ann, truth)]))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    args = eval_parser().parse_args(argv)
    device = torch.device(args.device)
    verbose = not args.quiet

    words, stored = load_glove_array(args.store, args.lim, verbose=verbose)
    _, queries = load_glove_array(args.queries or args.store, args.lim,
                                  verbose=verbose)
    if args.model != "hnsw":
        return eval_other_model(args, stored, queries, device)
    if args.load:
        t0 = time.time()
        index = HNSW.load(args.load, device)
        print(f"loaded index from {args.load} in {time.time() - t0:.2f}s")
    elif args.import_reference:
        from .utils.serializer import import_reference_index

        t0 = time.time()
        index = import_reference_index(args.import_reference, device)
        print(f"imported reference index from {args.import_reference} in "
              f"{time.time() - t0:.2f}s")
    else:
        index = HNSW(args.m, ef_cons=args.ef_cons, dim=stored.shape[1],
                     metric=args.metric, device=device)
        kw = {"build_expand": args.build_expand}
        if args.build_seeded:
            kw["build_seeded"] = True
        if args.cluster_build:
            kw["cluster_build"] = True
        if args.build_mi is not None:
            kw["max_iters"] = args.build_mi
        t0 = time.time()
        index.insert_bulk(stored, verbose=verbose, **kw)
        _sync(device)
        dt = time.time() - t0
        print(f"built index: {len(index)} vectors in {dt:.2f}s "
              f"({len(index) / dt:.0f} vec/s, includes kernel builds)")
        # one incremental insert, like the reference binary (main.rs:40)
        index.insert_vec(stored[0])
        print(f"insert_vec -> id {len(index) - 1} (len {len(index)})")

    index.print_index()
    truth = brute_force_nns(queries, index.points.codes, index.points.scales,
                            args.k)
    if args.expand > 1 or args.pivots > 0 or args.pq_m > 0:
        index.finalize(expand=args.expand, pivots=args.pivots, pq_m=args.pq_m)
    print(f"\n ef    recall@{args.k}   QPS   route={index.serving_route()}")
    batch = args.batch or len(queries)
    big = np.tile(queries, (-(-batch // len(queries)), 1))[:batch]
    for ef in args.ef:
        _, ann = index.ann_batch(queries, args.k, ef)
        rec = recall_at_k(ann, truth, args.k)
        index.ann_batch(big, args.k, ef)  # warm
        t0 = time.time()
        iters = 0
        while time.time() - t0 < 1.0:
            index.ann_batch(big, args.k, ef)
            iters += 1
        qps = batch * iters / (time.time() - t0)
        print(f"{ef:4d}   {rec:.4f}   {qps:10.0f}")

    if args.save:
        t0 = time.time()
        index.save(args.save)
        print(f"saved to {args.save} in {time.time() - t0:.2f}s")
        t0 = time.time()
        HNSW.load(args.save, device)
        print(f"reloaded in {time.time() - t0:.2f}s")

    index.assert_param_compliance(verbose=verbose)
    if args.words:
        show_nn_words(index, words, args.k)
    return 0


def eval_other_model(args, stored, queries, device: torch.device) -> int:
    """Evaluate the Flat, IVF-Flat or IVF-PQ family on the same data."""
    from .models.flat import FlatIndex
    from .models.ivf import IVFFlatIndex
    from .models.ivfpq import IVFPQIndex

    k, d = args.k, stored.shape[1]
    if args.metric == "cosine":
        from .ops.distance import normalize

        stored = normalize(torch.from_numpy(stored)).numpy()
        queries = normalize(torch.from_numpy(queries)).numpy()
    sweeps = [(f"probe={p}", {"n_probe": p}) for p in args.probe]
    t0 = time.time()
    if args.model == "flat":
        index = FlatIndex(d, device, metric=args.metric)
        index.add(stored)
        sweeps = [("exact", {})]
        what = "flat add"
    elif args.model == "pq":
        m_pq = next(m for m in (16, 10, 8, 5, 4, 2, 1) if d % m == 0)
        index = IVFPQIndex(d, n_lists=args.n_lists, m_pq=m_pq,
                           metric=args.metric, rerank=4 * k, device=device)
        index.train_add(stored)
        what = f"ivf-pq train+add ({index.n_lists} lists, m_pq={m_pq})"
    else:
        index = IVFFlatIndex(d, n_lists=args.n_lists, metric=args.metric,
                             device=device)
        index.train_add(stored)
        what = f"ivf train+add ({index.n_lists} lists)"
    _sync(device)
    print(f"{what}: {len(index)} vectors in {time.time() - t0:.2f}s")

    truth = brute_force_nns(queries, index.codes[:len(index)],
                            index.scales[:len(index)], k)
    batch = args.batch or len(queries)
    big = np.tile(queries, (-(-batch // len(queries)), 1))[:batch]
    print(f"\n setting    recall@{k}   QPS")
    for label, kw in sweeps:
        _, ann = index.search(queries, k, **kw)
        rec = recall_at_k(ann, truth, k)
        index.search(big, k, **kw)  # warm
        t0 = time.time()
        iters = 0
        while time.time() - t0 < 1.0:
            index.search(big, k, **kw)
            iters += 1
        qps = batch * iters / (time.time() - t0)
        print(f"{label:>9s}   {rec:.4f}   {qps:10.0f}")
    return 0


def show_nn_words(index: HNSW, words: list[str], k: int) -> None:
    """Interactive nearest-word REPL (``eval_glove/src/main.rs:102-121``)."""
    by_word = {w: i for i, w in enumerate(words)}
    print("type a word (empty line to quit):")
    for line in sys.stdin:
        w = line.strip()
        if not w:
            break
        if w not in by_word:
            print(f"  {w!r} not in vocabulary")
            continue
        v = index.get_point(by_word[w]).values
        ids = [int(i) for i in index.ann_by_vector(v, k + 1, ef=1000)
               if 0 <= int(i) < len(words)]
        names = [words[i] for i in ids if i != by_word[w]][:k]
        print(f"  {w}: {', '.join(names)}")


if __name__ == "__main__":
    raise SystemExit(main())
