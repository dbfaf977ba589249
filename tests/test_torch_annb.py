"""The port's ann-benchmarks adapters (``annb``) against the JAX package's
on the CPU, driven as the harness drives them (fit ->
set_query_arguments -> query / batch_query), at the sizes of
tests/test_annb.py.

Tolerances: the exact adapter's ids equal to the JAX adapter's; IVF at
full probe equal to them too; HNSW recall@10 >= 0.95 against the exact
ids and top-10 overlap >= 0.98 with the JAX adapter's (the graphs are
built on each side and gated on recall, as the JAX package gates its
own); ``get_memory_usage`` equal to the JAX adapter's kB.
"""

import numpy as np
import pytest

from hnsw_rs_tpu.annb import ANNBenchmarksFlat as JFlat
from hnsw_rs_tpu.annb import ANNBenchmarksHNSW as JHNSW
from hnsw_rs_tpu.annb import ANNBenchmarksIVF as JIVF
from hnsw_rs_tpu_torch.annb import ANNBenchmarksFlat, ANNBenchmarksHNSW, ANNBenchmarksIVF
from hnsw_rs_tpu_torch.utils import gen_rand_vecs


def _recall(ids, truth, k):
    return np.mean([len(set(a[:k]) & set(t[:k])) / k for a, t in zip(ids, truth)])


@pytest.fixture(scope="module", params=["euclidean", "angular"])
def fitted(request):
    metric = request.param
    train = gen_rand_vecs(1200, 24, seed=0)
    test = gen_rand_vecs(32, 24, seed=1)
    out = {}
    for side, flat_cls, hnsw_cls, kw in (("jax", JFlat, JHNSW, {}),
                                         ("torch", ANNBenchmarksFlat,
                                          ANNBenchmarksHNSW, {"device": "cpu"})):
        exact = flat_cls(metric, **kw)
        exact.fit(train)
        exact.batch_query(test, 10)
        algo = hnsw_cls(metric, {"M": 12, "efConstruction": 64}, **kw)
        algo.fit(train)
        algo.set_query_arguments(80)
        algo.batch_query(test, 10)
        out[side] = (exact, algo)
    return metric, test, out


def test_adapter_protocol_and_recall(fitted):
    _, test, out = fitted
    exact, algo = out["torch"]
    truth = exact.get_batch_results()
    assert _recall(algo.get_batch_results(), truth, 10) >= 0.95
    one = algo.query(test[0], 10)  # the single-query path agrees with the batch
    assert list(one) == list(algo.get_batch_results()[0])
    assert list(exact.query(test[3], 10)) == list(truth[3])
    assert algo.get_memory_usage() > 0
    assert "M=12" in str(algo) and str(exact) == "hnsw_rs_tpu_torch_flat"
    assert algo.get_additional() == {} and algo.done() is None


def test_adapters_match_jax(fitted):
    _, _, out = fitted
    np.testing.assert_array_equal(out["torch"][0].get_batch_results(),
                                  out["jax"][0].get_batch_results())
    ids, jids = out["torch"][1].get_batch_results(), out["jax"][1].get_batch_results()
    assert _recall(ids, jids, 10) >= 0.98
    assert out["torch"][1].get_memory_usage() == out["jax"][1].get_memory_usage()


def test_adapter_ivf():
    train = gen_rand_vecs(1500, 16, seed=2)
    test = gen_rand_vecs(24, 16, seed=3)
    exact = ANNBenchmarksFlat("euclidean", device="cpu")
    exact.fit(train)
    exact.batch_query(test, 10)
    truth = exact.get_batch_results()
    algo = ANNBenchmarksIVF("euclidean", {"n_list": 30}, device="cpu")
    algo.fit(train)
    algo.set_query_arguments(30)  # probe every list: exact
    algo.batch_query(test, 10)
    assert _recall(algo.get_batch_results(), truth, 10) == 1.0
    assert list(algo.query(test[5], 10)) == list(algo.get_batch_results()[5])
    jalgo = JIVF("euclidean", {"n_list": 30})
    jalgo.fit(train)
    jalgo.set_query_arguments(30)
    jalgo.batch_query(test, 10)
    np.testing.assert_array_equal(algo.get_batch_results(), jalgo.get_batch_results())


def test_adapter_rejects_unknown_metric():
    with pytest.raises(ValueError):
        ANNBenchmarksHNSW("hamming", device="cpu")
    assert ANNBenchmarksHNSW("angular")._device.type == "cuda"  # the default
