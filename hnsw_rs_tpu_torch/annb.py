"""ann-benchmarks adapters (port of ``hnsw_rs_tpu/annb.py``): the port's
indexes under the https://github.com/erikbern/ann-benchmarks harness's
``BaseANN`` protocol, for recall/QPS curves beside hnswlib, faiss and the
Rust reference.

The harness builds an algorithm from the constructor arguments in its
YAML config, then calls ``fit(X)`` -> ``set_query_arguments(...)`` ->
``query`` / ``batch_query``. The protocol is duck-typed, so nothing here
imports ``ann_benchmarks``, and a local sweep works standalone:

    algo = ANNBenchmarksHNSW("angular", {"M": 16, "efConstruction": 96},
                             device="cuda")
    algo.fit(train)
    algo.set_query_arguments(64)
    algo.batch_query(test, 10)
    ids = algo.get_batch_results()

Config stanza for the harness (the JAX package's, with this module):

    hnsw-rs-tpu-torch:
      constructor: ANNBenchmarksHNSW
      module: hnsw_rs_tpu_torch.annb
      run-groups:
        M-16:
          arg-groups: [{"M": 16, "efConstruction": 96}]
          query-args: [[16, 32, 64, 128, 256]]

Every adapter takes the JAX package's constructor arguments plus the
keyword ``device`` (default ``"cuda"``): it runs on the card unless the
caller asks for the CPU. As with the JAX adapter, the protocol is taken
from ``BaseANN``'s source and held by fixture tests
(``tests/test_torch_annb.py``); it has not run under the harness itself.
"""

from __future__ import annotations

import numpy as np
import torch


def _resolve_metric(metric: str) -> str:
    m = {"angular": "cosine", "cosine": "cosine", "euclidean": "l2", "l2": "l2"}
    try:
        return m[metric]
    except KeyError:
        raise ValueError(f"unsupported metric {metric!r}") from None


class _Base:
    """Shared BaseANN plumbing (batch result stash, lifecycle no-ops)."""

    name = "hnsw_rs_tpu_torch"

    def __init__(self, device: torch.device | str) -> None:
        self._device = torch.device(device)
        self._batch_ids: np.ndarray | None = None

    def done(self) -> None:  # harness lifecycle hook
        pass

    def get_batch_results(self) -> np.ndarray:
        assert self._batch_ids is not None, "call batch_query first"
        return self._batch_ids

    def get_additional(self) -> dict:
        return {}

    def __str__(self) -> str:
        return self.name


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ANNBenchmarksHNSW(_Base):
    """HNSW under the protocol. Constructor arguments follow the harness's
    hnswlib conventions, ``M`` and ``efConstruction``; the query argument
    is ``ef``."""

    def __init__(self, metric: str, method_param: dict | None = None, *,
                 device: torch.device | str = "cuda", **kw):
        super().__init__(device)
        p = dict(method_param or {})
        p.update(kw)
        self._m = int(p.get("M", p.get("m", 16)))
        self._ef_cons = int(p.get("efConstruction", p.get("ef_cons", 2 * self._m)))
        self._metric = _resolve_metric(metric)
        self._ef = 64
        self._index = None
        self.name = f"hnsw_rs_tpu_torch(M={self._m}, efC={self._ef_cons})"

    def fit(self, X: np.ndarray) -> None:
        from .models.hnsw import HNSW

        X = np.asarray(X, np.float32)
        self._index = HNSW(self._m, ef_cons=self._ef_cons, dim=X.shape[1],
                           metric=self._metric, device=self._device)
        self._index.insert_bulk(X)
        self._index.finalize()

    def set_query_arguments(self, ef: int) -> None:
        self._ef = max(int(ef), 1)

    def query(self, q: np.ndarray, n: int) -> np.ndarray:
        return self._index.ann_by_vector(np.asarray(q, np.float32), n, self._ef)

    def batch_query(self, X: np.ndarray, n: int) -> None:
        _, ids = self._index.ann_batch(np.asarray(X, np.float32), n,
                                       max(self._ef, n))
        self._batch_ids = ids

    def get_memory_usage(self) -> int | None:
        """kB of the index: the live rows of the store and of every layer,
        plus each serving layout ``fit`` made (the packed layer-0 rows,
        ~cap*(d+12) bytes a point, dominate), over the JAX adapter's
        items."""
        if self._index is None:
            return None
        idx = self._index
        n = len(idx)
        total = _nbytes(idx.points.codes[:n]) + _nbytes(idx.points.scales[:n])
        total += sum(_nbytes(adj[:n]) for adj in idx.graph.adjs)
        if idx._packed0 is not None:
            total += _nbytes(idx._packed0)
        if idx._pivots is not None:
            total += _nbytes(idx._pivots[0]) + _nbytes(idx._pivots[1])
        if idx._f32_table is not None:
            total += _nbytes(idx._f32_table[:n])
        if idx._pq is not None:
            cb, pq_codes, packed_pq, rot = idx._pq
            total += _nbytes(packed_pq) + _nbytes(pq_codes) + _nbytes(cb)
            if rot is not None:
                total += _nbytes(rot)
        return total // 1024  # the harness expects kB


class ANNBenchmarksFlat(_Base):
    """Exact search under the same protocol (recall 1)."""

    def __init__(self, metric: str, method_param: dict | None = None, *,
                 device: torch.device | str = "cuda", **kw):
        super().__init__(device)
        self._metric = _resolve_metric(metric)
        self._index = None
        self.name = "hnsw_rs_tpu_torch_flat"

    def fit(self, X: np.ndarray) -> None:
        from .models.flat import FlatIndex

        X = np.asarray(X, np.float32)
        self._index = FlatIndex(X.shape[1], self._device, metric=self._metric)
        self._index.add(X)

    def set_query_arguments(self, *args) -> None:
        pass

    def query(self, q: np.ndarray, n: int) -> np.ndarray:
        return self._index.search(np.asarray(q, np.float32)[None], n)[1][0]

    def batch_query(self, X: np.ndarray, n: int) -> None:
        self._batch_ids = self._index.search(np.asarray(X, np.float32), n)[1]


class ANNBenchmarksIVF(_Base):
    """IVF-Flat under the protocol: constructor ``n_list``, query argument
    ``n_probe`` (faiss-ivf conventions)."""

    def __init__(self, metric: str, method_param: dict | None = None, *,
                 device: torch.device | str = "cuda", **kw):
        super().__init__(device)
        p = dict(method_param or {})
        p.update(kw)
        self._n_lists = int(p.get("n_list", p.get("n_lists", 0)))
        self._metric = _resolve_metric(metric)
        self._n_probe = 8
        self._index = None
        self.name = f"hnsw_rs_tpu_torch_ivf(n_list={self._n_lists})"

    def fit(self, X: np.ndarray) -> None:
        from .models.ivf import IVFFlatIndex

        X = np.asarray(X, np.float32)
        self._index = IVFFlatIndex(X.shape[1], n_lists=self._n_lists,
                                   metric=self._metric, device=self._device)
        self._index.train_add(X)

    def set_query_arguments(self, n_probe: int) -> None:
        self._n_probe = max(int(n_probe), 1)

    def query(self, q: np.ndarray, n: int) -> np.ndarray:
        return self._index.search(np.asarray(q, np.float32)[None], n,
                                  self._n_probe)[1][0]

    def batch_query(self, X: np.ndarray, n: int) -> None:
        self._batch_ids = self._index.search(np.asarray(X, np.float32), n,
                                             self._n_probe)[1]
