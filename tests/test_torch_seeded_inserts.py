"""Points wave-inserted into a cluster-built index, served through the
pivot-seeded route: the port against the JAX package on the CPU.

The same cluster index (N=4000, d=32, M=12, ef_cons=48, the cluster
options ``chip_smoke.py`` builds with) takes the same 64 ``insert_vec``
calls in both packages. Served through the hierarchical route, the
inserted points find themselves (top-10 self-recall at ef=128 >= 0.99);
after ``finalize(pivots=P)`` the seeded route finds fewer of them, the
fewer the pivots, because an inserted point is reached only through the
pivots' neighborhoods. The JAX package reads the same self-recall as the
port, within 0.03, at each pivot budget: this is the reference's
behaviour, not a fault of the port.
"""

import numpy as np
import pytest

from hnsw_rs_tpu import HNSW as JHNSW
from hnsw_rs_tpu_torch import HNSW
from hnsw_rs_tpu_torch.utils.datasets import synthetic_clustered

N, D, N_NEW, EF = 4000, 32, 64, 128
CLUSTER_KWARGS = {"pool_p": 96, "points_per_cluster": 96, "fanout": 5,
                  "select_alg4": False, "merge_slots": 48}


def _self_recall(index, new):
    ids = index.ann_batch(new, 10, EF)[1]
    return float(np.mean([i in row for i, row in zip(range(N, N + N_NEW), ids)]))


@pytest.fixture(scope="module")
def inserted():
    ds = synthetic_clustered(N, D, n_queries=N_NEW, seed=3)
    out = {}
    for name, index in (("jax", JHNSW(12, ef_cons=48, dim=D)),
                        ("torch", HNSW(12, ef_cons=48, dim=D, device="cpu"))):
        index.insert_bulk(ds.train, cluster_build=True, cluster_kwargs=CLUSTER_KWARGS)
        for v in ds.test:
            index.insert_vec(v)
        index.flush()
        out[name] = (index, _self_recall(index, ds.test))
    return ds.test, out


@pytest.mark.parametrize("pivots", [64, 256])
def test_seeded_self_recall_after_inserts_matches_jax(inserted, pivots):
    new, out = inserted
    seeded = {}
    for name, (index, plain) in out.items():
        assert len(index) == N + N_NEW
        assert plain >= 0.99, (name, plain)
        index.finalize(pivots=pivots)
        seeded[name] = _self_recall(index, new)
    assert out["torch"][0].serving_route() == "seeded"
    assert abs(seeded["torch"] - seeded["jax"]) <= 0.03, seeded
