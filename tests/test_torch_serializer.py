"""The reference-format codec (``utils.serializer``) of the port against
the JAX package's on the CPU: byte-level round trips of the Rust
workspace's files, directories written by one package and read by the
other with equal arrays, equal bytes from both exporters for the same
index arrays, inserts into an imported index with its in-degree ledgers
equal to their recount, and ``eval_glove --import-reference``.

Codes, scales, levels, params and every layer's rows must be equal
(``NODE_MAX`` on disk is -1 in memory); the two CLIs' recall within
0.005 (the port serves a JAX-built graph with the same ids on >= 99% of
entries; near-ties may swap where the two sums differ in order).
"""

import json
import os
import struct

import numpy as np
import pytest
import torch

from conftest import TEST_DATA
from hnsw_rs_tpu import HNSW as JHNSW
from hnsw_rs_tpu.eval_glove import main as jmain
from hnsw_rs_tpu.utils import serializer as jser
from hnsw_rs_tpu_torch import HNSW
from hnsw_rs_tpu_torch.eval_glove import main as tmain
from hnsw_rs_tpu_torch.graphs import recount_indeg
from hnsw_rs_tpu_torch.ops.quant import quantize
from hnsw_rs_tpu_torch.utils import gen_rand_vecs, load_bf_data, save_bf_data, split
from hnsw_rs_tpu_torch.utils.glove import load_glove_array
from hnsw_rs_tpu_torch.utils.serializer import (
    NODE_MAX, export_reference_index, import_reference_index, read_layer,
    read_params, read_points, write_layer, write_params, write_points)

STORE = os.path.join(TEST_DATA, "store.txt")
LIM = 300


def test_points_roundtrip(tmp_path):
    vecs = gen_rand_vecs(20, 8, seed=0)
    codes, scales = (t.numpy() for t in quantize(torch.from_numpy(vecs)))
    levels = np.random.default_rng(0).integers(0, 4, 20).astype(np.int32)
    p = str(tmp_path / "points")
    write_points(p, codes, scales, levels)
    for read in (read_points, jser.read_points):
        c2, s2, l2 = read(p)
        np.testing.assert_array_equal(codes, c2)
        np.testing.assert_array_equal(scales, s2)
        np.testing.assert_array_equal(levels, l2)


def test_points_binary_layout(tmp_path):
    # u64 count | u64 size | per point u8 level, f32 BE min, f32 BE delta, codes
    p = str(tmp_path / "points")
    write_points(p, np.asarray([[7, 9]], np.uint8),
                 np.asarray([[0.5, 0.25]], np.float32), np.asarray([3], np.int32))
    raw = open(p, "rb").read()
    assert struct.unpack(">QQ", raw[:16]) == (1, 11)
    assert raw[16] == 3
    assert struct.unpack(">f", raw[17:21])[0] == 0.5
    assert struct.unpack(">f", raw[21:25])[0] == 0.25
    assert raw[25:] == bytes([7, 9])


def test_params_roundtrip(tmp_path):
    p = dict(m=12, mmax=12, mmax0=24, ml=0.40242961, ef_cons=24, dim=50, ep=269)
    path = str(tmp_path / "params")
    write_params(path, p)
    for read in (read_params, jser.read_params):
        got = read(path)
        assert got["m"] == 12 and got["ep"] == 269 and got["dim"] == 50
        assert abs(got["ml"] - p["ml"]) < 1e-7
    assert len(open(path, "rb").read()) == 52


def test_layer_roundtrip(tmp_path):
    n, m = 10, 4
    adj = np.full((n, m), -1, np.int32)
    adj[2] = [3, 5, -1, -1]
    adj[3] = [2, -1, -1, -1]
    adj[5] = [2, 3, 7, 9]
    member = np.zeros(n, bool)
    member[[2, 3, 5, 7, 9]] = True
    path = str(tmp_path / "0")
    write_layer(path, 1, adj, member)
    raw = np.fromfile(path, np.uint8)
    rows = np.frombuffer(raw[7:].tobytes(), ">u4").reshape(5, m + 1)
    assert rows[0].tolist() == [2, 3, 5, NODE_MAX, NODE_MAX]
    for read in (read_layer, jser.read_layer):
        level, adj2 = read(path, n)
        assert level == 1
        np.testing.assert_array_equal(adj2[member], adj[member])
        assert np.all(adj2[~member] == -1)


def test_whole_index_export_import(tmp_path):
    vecs = gen_rand_vecs(120, 12, seed=1)
    index = HNSW(8, dim=12, device="cpu")
    index.insert_bulk(vecs)
    path = str(tmp_path / "refidx")
    export_reference_index(index, path)
    loaded = import_reference_index(path, "cpu")
    assert len(loaded) == len(index) and loaded.device == torch.device("cpu")
    assert loaded.params.ep == index.params.ep
    np.testing.assert_array_equal(loaded.points.levels, index.points.levels)
    for lay in range(len(index.graph)):
        a = index.graph.get_layer(lay).numpy()
        b = loaded.graph.get_layer(lay).numpy()
        for i in range(len(index)):
            assert set(a[i][a[i] >= 0]) == set(b[i][b[i] >= 0]), (lay, i)
    q = gen_rand_vecs(5, 12, seed=2)
    np.testing.assert_array_equal(index.ann_batch(q, 5, 30)[1],
                                  loaded.ann_batch(q, 5, 30)[1])


def test_split_and_bf_fixtures(tmp_path):
    parts = split(10, 3)
    assert sum(len(p) for p in parts) == 10
    assert np.concatenate(parts).tolist() == list(range(10))
    nn = np.asarray([[1, 2], [0, 2], [0, 1]], np.int32)
    path = str(tmp_path / "bf.json")
    save_bf_data(path, nn)
    np.testing.assert_array_equal(load_bf_data(path), nn)


# -- across the packages ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A JAX index over the first 300 GloVe rows, exported by the JAX
    package; with its save directory for the port's own copy."""
    root = tmp_path_factory.mktemp("ser")
    _, vecs = load_glove_array(STORE, LIM)
    jidx = JHNSW(8, dim=vecs.shape[1])
    jidx.insert_bulk(vecs)
    jser.export_reference_index(jidx, str(root / "jax_ref"))
    jidx.save(str(root / "jax_save"))
    return root, jidx


def _port_twin(root):
    with open(root / "jax_save" / "params.json") as f:
        meta = json.load(f)
    with np.load(root / "jax_save" / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return HNSW.from_numpy(meta, arrays, "cpu")


def _assert_same_index(t, j):
    n = len(t)
    assert n == len(j) and len(t.graph) == len(j.graph)
    np.testing.assert_array_equal(t.points.codes[:n].numpy(), np.asarray(j.points.codes)[:n])
    np.testing.assert_array_equal(t.points.scales[:n].numpy(), np.asarray(j.points.scales)[:n])
    np.testing.assert_array_equal(t.points.levels[:n], j.points.levels[:n])
    for f in ("m", "mmax", "mmax0", "ml", "ef_cons", "dim", "ep"):
        assert getattr(t.params, f) == getattr(j.params, f), f
    for lay in range(len(t.graph)):
        np.testing.assert_array_equal(t.graph.get_layer(lay)[:n].numpy(),
                                      np.asarray(j.graph.get_layer(lay))[:n])
        np.testing.assert_array_equal(t.graph.indeg(lay)[:n].numpy(),
                                      np.asarray(j.graph.indeg(lay))[:n])


def test_jax_export_read_by_port(jax_dir):
    root, _ = jax_dir
    port = import_reference_index(str(root / "jax_ref"), "cpu")
    _assert_same_index(port, jser.import_reference_index(str(root / "jax_ref")))
    for lay in range(len(port.graph)):
        assert torch.equal(port.graph.indeg(lay), recount_indeg(port.graph.adjs[lay]))


def test_port_export_read_by_jax(jax_dir, tmp_path):
    root, jidx = jax_dir
    export_reference_index(_port_twin(root), str(tmp_path / "port_ref"))
    back = jser.import_reference_index(str(tmp_path / "port_ref"))
    _assert_same_index(import_reference_index(str(tmp_path / "port_ref"), "cpu"), back)
    np.testing.assert_array_equal(np.asarray(back.points.codes), np.asarray(jidx.points.codes))
    for lay in range(len(jidx.graph)):
        np.testing.assert_array_equal(np.asarray(back.graph.get_layer(lay)),
                                      np.asarray(jidx.graph.get_layer(lay)))


def test_exporters_write_equal_bytes(jax_dir, tmp_path):
    root, _ = jax_dir
    export_reference_index(_port_twin(root), str(tmp_path / "port_ref"))
    files = ["points", "params"] + [
        os.path.join("layers", f) for f in os.listdir(root / "jax_ref" / "layers")]
    assert sorted(os.listdir(tmp_path / "port_ref" / "layers")) == sorted(
        os.listdir(root / "jax_ref" / "layers"))
    for f in files:
        assert (tmp_path / "port_ref" / f).read_bytes() == (root / "jax_ref" / f).read_bytes(), f


def test_imported_index_takes_inserts(jax_dir):
    root, _ = jax_dir
    index = import_reference_index(str(root / "jax_ref"), "cpu")
    _, vecs = load_glove_array(STORE)
    new = vecs[LIM:LIM + 64]
    ids = [index.insert_vec(v) for v in new]
    index.flush()
    assert ids == list(range(LIM, LIM + 64)) and len(index) == LIM + 64
    for lay in range(len(index.graph)):
        assert torch.equal(index.graph.indeg(lay), recount_indeg(index.graph.adjs[lay]))
    assert index.assert_param_compliance(verbose=False)
    found = index.ann_batch(new, 10, 64)[1]
    assert np.mean([i in row for i, row in zip(ids, found)]) >= 0.95


def _recall_rows(out):
    rows = [ln.split() for ln in out.splitlines()]
    return {int(r[0]): float(r[1]) for r in rows if len(r) == 3 and r[0].isdigit()}


def test_eval_glove_import_reference_matches_jax(jax_dir, capsys):
    root, _ = jax_dir
    common = ["--store", STORE, "--queries", os.path.join(TEST_DATA, "queries.txt"),
              "--lim", str(LIM), "--ef", "48", "--quiet",
              "--import-reference", str(root / "jax_ref")]
    assert jmain(common) == 0
    want = _recall_rows(capsys.readouterr().out)
    assert tmain(["--device", "cpu", *common]) == 0
    out = capsys.readouterr().out
    got = _recall_rows(out)
    assert "imported reference index" in out and set(got) == set(want) == {48}
    assert abs(got[48] - want[48]) <= 0.005, (got, want)
    assert got[48] >= 0.9
