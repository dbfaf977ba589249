"""The plain reference: the frozen 8-bit and normalization rules, exact
top-k and the judge, in the stored space of either metric."""

import numpy as np
import pytest
import torch

from portbench.reference.exact import exact_topk
from portbench.reference.judge import Reference, limits, verdict
from portbench.reference.norm import normalize
from portbench.reference.quant import quantize_dequantize


def _np_rule(x):
    mn = x.min(axis=1, keepdims=True)
    mx = x.max(axis=1, keepdims=True)
    delta = (mx - mn) / np.float32(255.0)
    safe = np.where(delta > 0, delta, np.float32(1.0)).astype(np.float32)
    t = np.where(delta > 0, (x - mn) / safe, 0).astype(np.float32)
    codes = np.clip(np.floor(t + np.float32(0.5)), 0, 255).astype(np.float32)
    return codes * delta + mn


def _data(n=500, d=24, q=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d), dtype=np.float32)
    x[3] = 0.25  # a constant row: all-zero codes
    return x, rng.random((q, d), dtype=np.float32)


def test_rule_matches_numpy_and_the_port():
    from hnsw_rs_tpu_torch.ops.quant import dequantize, quantize

    x, _ = _data()
    ref = quantize_dequantize(torch.from_numpy(x), block=64).numpy()
    assert np.array_equal(ref, _np_rule(x))
    assert np.array_equal(ref, dequantize(*quantize(torch.from_numpy(x))).numpy())


def test_exact_topk_matches_brute_force():
    x, q = _data()
    ids = exact_topk(torch.from_numpy(x), torch.from_numpy(q), 10,
                     slab_bytes=8 * 500 * 7).numpy()
    d2 = ((q.astype(np.float64)[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    want = np.argsort(d2, axis=1, kind="stable")[:, :10]
    assert np.array_equal(np.sort(ids, 1), np.sort(want, 1))
    assert np.all(np.diff(np.take_along_axis(d2, ids, 1), axis=1) >= 0)


def _stored(x, metric):
    if metric == "cosine":
        x = normalize(torch.from_numpy(x)).numpy()
    return _np_rule(x)


def _exact_answers(x, q, k=10, metric="l2"):
    xs = _stored(x, metric).astype(np.float64)
    qs = _stored(q, metric).astype(np.float64)
    d2 = ((qs[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
    ids = np.argsort(d2, axis=1, kind="stable")[:, :k]
    dist = np.sqrt(np.take_along_axis(d2, ids, 1)).astype(np.float32)
    return dist, ids.astype(np.int32)


def test_judge_passes_exact_answers_and_catches_each_fault():
    x, q = _data()
    ref = Reference(x, q, 10, torch.device("cpu"), "l2")
    lims = limits({"recall_at_10_min": 0.99, "dist_err_max": 1e-5})
    dist, ids = _exact_answers(x, q)
    qi = np.arange(q.shape[0])
    good = ref.judge([(qi, dist, ids)])
    assert good["recall_at_10"] == 1.0 and good["dist_err"] < 1e-6
    assert verdict(good, lims)[0]

    swapped = ids.copy()
    swapped[:, 0] = (swapped[:, 0] + 7) % x.shape[0]  # an id altered
    n = ref.judge([(qi, dist, swapped)])
    assert n["dist_err"] > 1e-3 and not verdict(n, lims)[0]

    n = ref.judge([(qi, dist[:20], ids[:20])])  # half the batch left out
    assert n["bad_rows"] == 20 and not verdict(n, lims)[0]

    dup = ids.copy()
    dup[0, 1] = dup[0, 0]
    assert ref.judge([(qi, dist, dup)])["dup_rows"] == 1

    rev = dist.copy()
    rev[5] = rev[5][::-1]
    assert ref.judge([(qi, rev, ids)])["unsorted_rows"] == 1

    bad = ids.copy()
    bad[2, 3] = x.shape[0]
    n = ref.judge([(qi, dist, bad)])
    assert n["bad_rows"] == 1 and n["attempted"] == q.shape[0]


@pytest.mark.parametrize("rows", [1, 3, 40])
def test_judge_reblocks_single_query_answers(rows):
    x, q = _data()
    ref = Reference(x, q, 10, torch.device("cpu"), "l2")
    dist, ids = _exact_answers(x, q)
    answers = [(np.array([j]), dist[j:j + 1], ids[j:j + 1]) for j in range(40)]
    n = ref.judge(answers, rows_per_block=rows)
    assert n["attempted"] == 40 and n["recall_at_10"] == 1.0


def test_control_rounds_to_tf32():
    from portbench.reference.control import _tf32

    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 3.14159265])
    y = _tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2.0 ** -10
    assert y[1] in (1.0, 1.0 + 2.0 ** -10)
    assert abs(float(y[3]) - 3.14159265) <= 2.0 ** -10 * 2
    assert torch.all((y.view(torch.int32) & 0x1FFF) == 0)


@pytest.mark.parametrize("d", [16, 100, 128])
def test_normalize_matches_the_port(d):
    from hnsw_rs_tpu_torch.ops.distance import normalize as port_normalize

    x = np.random.default_rng(d).normal(size=(300, d)).astype(np.float32)
    x[7] = 0.0  # a zero row passes through
    x[8] *= 1e-20
    t = torch.from_numpy(x)
    ref, port = normalize(t), port_normalize(t)
    assert ref.dtype == torch.float32
    assert torch.equal(ref.view(torch.int32), port.view(torch.int32))
    assert torch.all(ref[7] == 0.0)


def test_cosine_reference_judges_in_the_unit_space():
    x, q = _data()
    x[7] = 0.0
    ref = Reference(x, q, 10, torch.device("cpu"), "cosine")
    lims = limits({"recall_at_10_min": 0.99, "dist_err_max": 2e-5})
    qi = np.arange(q.shape[0])
    good = ref.judge([(qi, *_exact_answers(x, q, metric="cosine"))])
    assert good["recall_at_10"] == 1.0 and good["dist_err"] < 1e-6
    assert verdict(good, lims)[0]
    # the raw space's exact answers are wrong distances in the unit space
    raw = ref.judge([(qi, *_exact_answers(x, q))])
    assert raw["dist_err"] > 1e-2 and not verdict(raw, lims)[0]


@pytest.mark.parametrize("metric", ["ip", "L2", "angular", ""])
def test_reference_refuses_an_unknown_metric(metric):
    x, q = _data()
    with pytest.raises(ValueError, match="unknown metric"):
        Reference(x, q, 10, torch.device("cpu"), metric)
