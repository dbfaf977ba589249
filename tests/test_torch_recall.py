"""The GloVe quality gate in the PyTorch port on the CPU (the port's twin
of tests/test_recall.py and tests/test_cli.py): recall@10 > 0.99 at
M=12, ef=100 on the bundled test-data, against the port's exact
``brute_force_nns``, whose ids are held to the JAX package's.

Brute-force tolerance: the two packages sum the d squared differences in
different orders, so a d2 may differ by a few float32 ulps. Ids must be
equal, except where two neighbors swap places whose d2 differ by less
than 8 ulps of the larger (a near-tie either order may resolve).
"""

import os

import numpy as np
import pytest
import torch

from conftest import TEST_DATA
from hnsw_rs_tpu.utils import brute_force_nns as j_brute_force_nns
from hnsw_rs_tpu.utils import load_glove_array as j_load_glove_array
from hnsw_rs_tpu_torch import HNSW
from hnsw_rs_tpu_torch.eval_glove import main, recall_at_k
from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize
from hnsw_rs_tpu_torch.utils import glove
from hnsw_rs_tpu_torch.utils.glove import brute_force_nns, load_glove_array

M, EF, K = 12, 100, 10
STORE = os.path.join(TEST_DATA, "store.txt")
QUERIES = os.path.join(TEST_DATA, "queries.txt")


def _assert_same_truth(got, want, codes, scales, queries):
    """Ids equal up to swaps of neighbors within 8 ulps of each other."""
    if np.array_equal(got, want):
        return
    x = dequantize(torch.from_numpy(codes), torch.from_numpy(scales)).numpy()
    q = dequantize(*quantize(torch.from_numpy(queries))).numpy()
    for r in np.flatnonzero((got != want).any(1)):
        d_got = ((x[got[r]] - q[r]) ** 2).sum(1)
        d_want = ((x[want[r]] - q[r]) ** 2).sum(1)
        # position by position, a differing id is a near-tie of the one
        # it replaced
        np.testing.assert_allclose(d_got, d_want, rtol=8 * 1.2e-7, atol=0)


def test_glove_loader_matches_jax():
    words, stored = load_glove_array(STORE)
    jwords, jstored = j_load_glove_array(STORE)
    assert words == jwords and stored.shape == (1000, 50)
    np.testing.assert_array_equal(stored, jstored)
    _, head = load_glove_array(QUERIES, limit=7)
    assert head.shape == (7, 50)


def test_glove_recall_gate():
    _, stored = load_glove_array(STORE)
    _, queries = load_glove_array(QUERIES)
    index = HNSW(M, dim=stored.shape[1], device="cpu")
    index.insert_bulk(stored)
    assert index.serving_route() == "packed"
    truth = brute_force_nns(queries, index.points.codes, index.points.scales, K)
    jtruth = np.asarray(j_brute_force_nns(queries, index.points.codes.numpy(),
                                          index.points.scales.numpy(), K))
    _assert_same_truth(truth, jtruth, index.points.codes.numpy(),
                       index.points.scales.numpy(), queries)
    _, ann = index.ann_batch(queries, K, EF)
    recall = recall_at_k(ann, truth, K)
    print(f"recall@{K} = {recall}")
    assert recall > 0.99, recall
    assert index.assert_param_compliance(verbose=True)


def test_brute_force_is_tiled_over_the_collection(monkeypatch):
    """With a temporary budget far below the untiled [b, N, d] size the
    direct form is computed tile by tile, and the ids still equal the JAX
    package's brute force."""
    _, stored = load_glove_array(STORE)
    _, queries = load_glove_array(QUERIES)
    codes, scales = quantize(torch.from_numpy(stored))
    budget = 1 << 20
    b, n, d = 64, stored.shape[0], stored.shape[1]
    assert b * n * d * 4 > 10 * budget  # the untiled temp would not fit
    shapes = []
    real = glove.pairwise_l2sq_exact

    def spy(q, c, s):
        shapes.append((q.shape[0], c.shape[0], c.shape[1]))
        return real(q, c, s)

    monkeypatch.setattr(glove, "pairwise_l2sq_exact", spy)
    monkeypatch.setattr(glove, "_TEMP_BYTES", budget)
    got = brute_force_nns(queries, codes, scales, K, batch=b)
    assert max(bb * t * dd * 4 for bb, t, dd in shapes) <= budget
    assert len(shapes) > 10
    want = np.asarray(j_brute_force_nns(queries, codes.numpy(), scales.numpy(), K))
    _assert_same_truth(got, want, codes.numpy(), scales.numpy(), queries)


def test_eval_cli_end_to_end(tmp_path, capsys):
    rc = main(["--device", "cpu", "--store", STORE, "--queries", QUERIES,
               "--lim", "300", "--m", "8", "--ef", "64",
               "--save", str(tmp_path / "idx"), "--quiet"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "recall@10" in out and "route=plain" in out
    assert os.path.exists(tmp_path / "idx" / "arrays.npz")
    rc = main(["--device", "cpu", "--store", STORE, "--lim", "300", "--ef", "64",
               "--load", str(tmp_path / "idx"), "--quiet"])
    assert rc == 0
    row = [ln.split() for ln in capsys.readouterr().out.splitlines()
           if ln.split()[:1] == ["64"]][0]
    assert float(row[1]) > 0.99


def test_eval_cli_needs_a_device_and_rejects_unported_models(capsys):
    """``--device`` is required; every route is ported now, so
    ``--import-reference`` of a directory that does not exist fails on
    the missing file (its working run is in ``test_torch_serializer.py``);
    ``--model flat``, which used to raise, runs and is exact."""
    with pytest.raises(SystemExit):
        main(["--store", STORE])
    with pytest.raises(FileNotFoundError, match="points"):
        main(["--device", "cpu", "--store", STORE, "--lim", "10",
              "--import-reference", "no_such_dir"])
    rc = main(["--device", "cpu", "--store", STORE, "--queries", QUERIES,
               "--lim", "300", "--model", "flat", "--quiet"])
    assert rc == 0
    row = [ln.split() for ln in capsys.readouterr().out.splitlines()
           if ln.split()[:1] == ["exact"]][0]
    assert float(row[1]) == 1.0


@pytest.mark.parametrize("flags,label,floor", [
    (["--model", "ivf", "--n-lists", "16", "--probe", "4", "16"], "probe=16", 1.0),
    (["--model", "ivf", "--metric", "cosine", "--probe", "8"], "probe=8", 0.8),
    (["--model", "pq", "--n-lists", "8", "--probe", "8"], "probe=8", 0.9),
    (["--model", "flat", "--metric", "cosine"], "exact", 1.0)],
    ids=["ivf", "ivf_cosine", "pq", "flat_cosine"])
def test_eval_cli_other_families(flags, label, floor, capsys):
    """``--model flat|ivf|pq`` with ``--n-lists``, ``--probe`` and
    ``--metric``: each sweep row prints its recall against the exact truth
    over the family's own stored codes; full probe is exact."""
    rc = main(["--device", "cpu", "--store", STORE, "--queries", QUERIES,
               "--lim", "400", "--quiet", *flags])
    assert rc == 0
    out = capsys.readouterr().out
    row = [ln.split() for ln in out.splitlines() if ln.split()[:1] == [label]][0]
    assert float(row[1]) >= floor, out


def test_eval_cli_cosine_hnsw(capsys):
    rc = main(["--device", "cpu", "--store", STORE, "--queries", QUERIES,
               "--lim", "300", "--m", "8", "--ef", "64", "--metric", "cosine",
               "--quiet"])
    assert rc == 0
    row = [ln.split() for ln in capsys.readouterr().out.splitlines()
           if ln.split()[:1] == ["64"]][0]
    assert float(row[1]) > 0.99


@pytest.mark.parametrize("flags,route", [
    (["--build-expand", "2", "--build-seeded", "--build-mi", "40"], "plain"),
    (["--expand", "2", "--pivots", "64"], "seeded"),
    (["--pivots", "64", "--pq-m", "10"], "pq"),
    (["--expand", "2"], "packed")])
def test_eval_cli_serving_and_build_flags(flags, route, capsys):
    """The JAX CLI's build and serving flags reach ``insert_bulk`` and
    ``finalize``: the route is the one the flags ask for, and the gate
    holds on the bundled data (the PQ mode is held to 0.9)."""
    rc = main(["--device", "cpu", "--store", STORE, "--queries", QUERIES,
               "--lim", "300", "--m", "8", "--ef", "64", "--quiet", *flags])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"route={route}" in out
    row = [ln.split() for ln in out.splitlines() if ln.split()[:1] == ["64"]][0]
    assert float(row[1]) > (0.9 if route == "pq" else 0.99)
