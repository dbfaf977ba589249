"""The harness finds everything by name, and BENCHMARK.json keeps to the
contract's shape; a cell is added with new files and entries alone."""

import json
import re

import pytest

from portbench.lib.layout import Layout

from . import tinyroot

ROOT = tinyroot.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves():
    lay = Layout(ROOT)
    for w in lay.spec["workloads"]:
        wl = lay.workload(w["name"])
        cfg = lay.config(wl["config"])
        assert lay.module("traffic", wl["traffic"]).run
        assert lay.module("indexes", cfg["index"]["family"]).search
        assert lay.module("data", cfg["data"]["generator"]).make
        for kind in ("end_to_end", "per_layer"):
            for m in lay.metrics(w["name"], kind):
                assert lay.module("metrics", m["name"]).read


def test_benchmark_json_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    cfgs = {c["name"] for c in spec["configs"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in spec["per_layer"]:
        # each cell that reports a per-layer metric reports what it moves
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        lay = Layout(ROOT)
        assert len(lay.metrics(cell, "end_to_end")) >= 2
        assert lay.metrics(cell, "per_layer")


def test_a_cell_added_by_files_alone_runs(tmp_path):
    root = tinyroot.make(tmp_path)
    lay = Layout(root)
    assert lay.workload("tiny.batch")["config"] == "tiny"
    assert [m["name"] for m in lay.metrics("tiny.batch", "end_to_end")] == [
        "qps", "recall_at_10", "setup_s"]
    # and a new metric: a reader file and an entry
    (root / "portbench/metrics/calls.py").write_text(
        "def read(rec):\n    return rec.get('queries_answered', 0) / 200\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "calls", "unit": "calls", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["tiny.batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    import torch

    from portbench.run import run_cell

    out = run_cell(root, "tiny.batch", 11, 0.3, False, torch.device("cpu"))
    assert out["correct"]
    assert set(out["metrics"]) == {"qps", "recall_at_10", "setup_s", "calls"}
    assert out["metrics"]["calls"]["value"] >= 1


HALVES = """
import gc, time
import numpy as np


def run(cell):
    train, queries = cell.make_data()
    index, _ = cell.build(train)
    half = queries.shape[0] // 2
    answers = []
    gc.collect()
    t0 = time.perf_counter()
    while not answers or time.perf_counter() < t0 + cell.seconds:
        for lo in (0, half):
            d, i = cell.search(index, queries[lo:lo + half])
            answers.append((np.arange(lo, lo + half), d, i))
    return {"window_start": t0, "window_s": time.perf_counter() - t0,
            "answers": answers, "queries_answered": len(answers) * half}
"""


def test_a_traffic_kind_added_by_files_alone_runs(tmp_path):
    root = tinyroot.make(tmp_path)
    (root / "portbench/traffic/halves.py").write_text(HALVES)
    wl = json.loads((root / "portbench/workloads/tiny.batch.json").read_text())
    wl.update(traffic="halves")
    (root / "portbench/workloads/tiny.halves.json").write_text(json.dumps(wl))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.halves", "config": "tiny",
                              "traffic": "halves", "chips": 1, "why": "halves"})
    next(m for m in spec["end_to_end"] if m["name"] == "qps")["workloads"].append(
        "tiny.halves")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    import torch

    from portbench.run import run_cell

    out = run_cell(root, "tiny.halves", 12, 0.3, False, torch.device("cpu"))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"qps", "recall_at_10", "setup_s"}


@pytest.mark.parametrize("key, value", [("config", "sift1m"), ("traffic", "online")])
def test_mismatched_workload_file_is_refused(tmp_path, key, value):
    root = tinyroot.make(tmp_path)
    p = root / "portbench/workloads/tiny.batch.json"
    wl = json.loads(p.read_text())
    wl[key] = value
    p.write_text(json.dumps(wl))
    with pytest.raises(ValueError):
        Layout(root).workload("tiny.batch")


@pytest.mark.parametrize("bad", ["../x", "a b", "", "a/b"])
def test_names_outside_the_alphabet_are_refused(bad):
    with pytest.raises((ValueError, FileNotFoundError)):
        Layout(ROOT).module("metrics", bad)
