"""The port's native host helpers (``native/fastio.cpp``,
``native/baseline_hnsw.cpp``, copies of the JAX package's) against the
Python and numpy versions and against the JAX package's own native
library, on the CPU. Every case skips where no ``g++`` is on ``PATH``,
the one condition under which the port's native entry points return None.

Tolerances: the GloVe parse within 2e-6 of Python's float parse (the
parser sums decimal digits in double) and equal to the JAX library's;
block bytes, packed rows, codes and scales equal; the baseline's ids
equal to the JAX library's (the same source and flags, one thread, one
seed) and its recall@10 >= 0.9 against brute force.

``tests/test_native.py::test_native_speedup`` (a timing ratio) is not
twinned: a timing assertion under six test workers is unsteady.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from conftest import TEST_DATA
from hnsw_rs_tpu import native as jnative
from hnsw_rs_tpu.models.paged import PagedHNSW as JPagedHNSW
from hnsw_rs_tpu.ops import quant as jquant
from hnsw_rs_tpu_torch import HNSW, native
from hnsw_rs_tpu_torch.models.paged import PagedHNSW, save_paged
from hnsw_rs_tpu_torch.ops.quant import quantize
from hnsw_rs_tpu_torch.store_paged import BlockStore
from hnsw_rs_tpu_torch.utils import gen_rand_vecs
from hnsw_rs_tpu_torch.utils.glove import load_glove_array

STORE = os.path.join(TEST_DATA, "store.txt")


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native helpers are not built")


def python_load(path, limit=0):
    words, vecs = [], []
    with open(path) as f:
        for i, line in enumerate(f):
            if limit and i >= limit:
                break
            parts = line.rstrip("\n").split(" ")
            words.append(parts[0])
            vecs.append(np.asarray(parts[1:], np.float32))
    return words, np.stack(vecs)


def test_libraries_build_into_build_native():
    lib, base = native.get_lib(), native.get_baseline_lib()
    assert lib is not None and base is not None
    for name, src in (("fastio", native._SRC), ("baseline_hnsw", native._BASE_SRC)):
        so = native._library_path(src)
        assert so.exists() and so.parent == native._CACHE
        assert so.name.startswith(name + "_")
    assert native._CACHE.parts[-2:] == ("build", "native")


def test_native_glove_matches_python_and_jax():
    pw, pv = python_load(STORE)
    nw, nv = native.load_glove_native(STORE)
    jw, jv = jnative.load_glove_native(STORE)
    assert nw == pw == jw
    np.testing.assert_allclose(nv, pv, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(nv, jv)
    w, v = load_glove_array(STORE)  # the loader takes the native parse
    assert w == nw and np.array_equal(v, nv)


def test_native_glove_limit_and_ragged(tmp_path):
    nw, nv = native.load_glove_native(STORE, limit=17)
    assert len(nw) == 17 and nv.shape == (17, 50)
    bad = tmp_path / "bad.txt"
    bad.write_text("a 1.0 2.0\nb 1.0\n")
    with pytest.raises(ValueError):
        native.load_glove_native(str(bad))
    with pytest.raises(ValueError):
        load_glove_array(str(bad))
    (tmp_path / "empty.txt").write_text("")
    w, v = native.load_glove_native(str(tmp_path / "empty.txt"))
    assert w == [] and v.size == 0


def test_pread_block(tmp_path):
    p = tmp_path / "blob"
    data = np.arange(256, dtype=np.uint8)
    p.write_bytes(data.tobytes())
    np.testing.assert_array_equal(native.pread_block(str(p), 100, 32), data[100:132])
    np.testing.assert_array_equal(native.pread_block(str(p), 250, 32), data[250:])
    with pytest.raises(OSError):
        native.pread_block(str(tmp_path / "missing"), 0, 8)


@pytest.fixture(scope="module")
def paged_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nat") / "p")
    index = HNSW(6, ef_cons=24, dim=12, device="cpu")
    index.insert_bulk(gen_rand_vecs(300, 12, seed=44))
    save_paged(index, path)
    return path


def test_pread_block_reads_the_store_blocks(paged_dir):
    store = BlockStore(os.path.join(paged_dir, "points.blocks"))
    for b in (0, 3, store.nb_blocks - 1):
        off, nb = store._block_offset(b), store._block_bytes
        np.testing.assert_array_equal(native.pread_block(store.path, off, nb),
                                      store._read_bytes(off, nb))
    store.close()


def test_packed_row_assembly_matches_numpy_and_jax(paged_dir):
    pg, jpg = PagedHNSW(paged_dir), JPagedHNSW(paged_dir)
    ids = np.asarray([0, 5, 7, 123, 299, 150, -3, 400])  # clipped like the numpy path
    native_rows = native.assemble_packed_rows(
        pg._adj_path, pg.n, pg.adj0.shape[1], pg._blocks_path, pg.store.dim,
        pg.store.max_per_block, ids)
    assert native_rows.shape == (ids.size, pg.adj0.shape[1] * (12 + 12))
    np.testing.assert_array_equal(native_rows, pg._packed_rows_numpy(ids))
    np.testing.assert_array_equal(native_rows, pg._packed_rows_host(ids))
    np.testing.assert_array_equal(native_rows, jpg._packed_rows_host(ids))
    pg.close()


def test_native_quantize_matches_quantize_and_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(0, 3, (2048, 51)).astype(np.float32)
    x[7, :] = 1.25  # delta == 0
    x[100:110] *= 1e-6
    codes, scales = native.quantize_rows(x)
    tc, ts = quantize(torch.from_numpy(x))
    jc, js = jquant.quantize_np(x)
    np.testing.assert_array_equal(codes, tc.numpy())
    np.testing.assert_array_equal(scales.view(np.uint32), ts.numpy().view(np.uint32))
    np.testing.assert_array_equal(codes, jc)
    np.testing.assert_array_equal(scales.view(np.uint32), js.view(np.uint32))


def test_baseline_matches_jax_and_brute_force():
    rng = np.random.default_rng(5)
    vecs = rng.random((2000, 16), np.float32)
    queries = rng.random((100, 16), np.float32)
    secs, rate = native.baseline_build_rate(vecs, 8, 32, seed=1)
    assert secs > 0 and rate > 0
    qps, ids = native.baseline_query_rate(vecs, queries, 8, 64, 10, 32, seed=1)
    _, jids = jnative.baseline_query_rate(vecs, queries, 8, 64, 10, 32, seed=1)
    assert qps > 0 and ids.shape == (100, 10)
    np.testing.assert_array_equal(ids, jids)
    truth = np.argsort(((queries[:, None] - vecs[None]) ** 2).sum(-1), axis=1)[:, :10]
    rec = np.mean([len(set(a) & set(t)) / 10 for a, t in zip(ids, truth)])
    assert rec >= 0.9, rec
