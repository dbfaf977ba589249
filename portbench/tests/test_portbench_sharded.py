"""The sharded family (``indexes/hnsw_sharded.py``) and the readers of the
``deep10m.sharded4`` cell: on made-up span records, on a tiny four-shard
copy of the cell run over four CPU stand-ins, and against a program whose
``ShardedHNSW`` cannot serve the probed route."""

import json

import pytest
import torch

import hnsw_rs_tpu_torch.utils.logging as plog
from hnsw_rs_tpu_torch.parallel import ShardedHNSW
from portbench.lib.layout import Layout
from portbench.run import run_cell

from . import tinyroot

LAY = Layout(tinyroot.ROOT)
READERS = ("shard_skew.sharded4", "merge_share.sharded4")


def read(name, rec):
    return LAY.module("metrics", name).read(rec)


def _span(i, name, parent, call, t0, device_s, **fields):
    return {"name": name, "index": i, "parent": parent, "call": call,
            "t0": t0, "t1": t0 + 1.0, "device_s": device_s, "counts": {},
            **fields}


def _call(i, call, t0, total, shard_s, merge_s):
    out = [_span(i, "hnsw.ann_batch", None, call, t0, total)]
    out += [_span(i + 1 + s, "hnsw.sharded.shard", i, call, t0, v, shard=s)
            for s, v in enumerate(shard_s)]
    out.append(_span(i + 1 + len(shard_s), "hnsw.sharded.merge", i, call, t0, merge_s))
    return out


MADE_UP = (_call(0, 0, 1.0, 9.0, [9.0, 9.0, 9.0, 9.0], 1.0)  # before the window
           + _call(10, 1, 20.0, 0.5, [0.4, 0.4, 0.4, 0.4], 0.01)
           + _call(20, 2, 21.0, 0.7, [0.6, 0.3, 0.3, 0.4], 0.03))


def test_readers_on_made_up_records(monkeypatch):
    monkeypatch.setattr(plog, "traced_spans", lambda: MADE_UP)
    rec = {"window_start": 5.0, "window_s": 10.0, "trace": {"events": []}}
    assert read("shard_skew.sharded4", rec) == pytest.approx((1.0 + 0.6 / 0.4) / 2)
    assert read("merge_share.sharded4", rec) == pytest.approx(0.04 / 1.2)
    for name in READERS:
        assert read(name, {"window_start": 5.0, "window_s": 10.0}) is None
        assert read(name, {"trace": {"events": []}}) is None


@pytest.mark.parametrize("records", ["cpu_clock", "no_shard_spans"])
def test_readers_find_nothing_to_read(monkeypatch, records):
    """Device-clock readings on the CPU, and a program older than the
    sharded spans (its calls open no ``hnsw.sharded.*`` span), read None."""
    if records == "cpu_clock":
        recs = [dict(r, device_s=None) for r in MADE_UP]
    else:
        recs = [r for r in MADE_UP if not r["name"].startswith("hnsw.sharded.")]
    monkeypatch.setattr(plog, "traced_spans", lambda: recs)
    rec = {"window_start": 5.0, "window_s": 10.0, "trace": {"events": []}}
    for name in READERS:
        assert read(name, rec) is None


def _add_tiny_sharded_cell(root):
    """``tinyd`` (``deep10m`` at 4,000 points, with ``tinyroot``'s tiny
    probed index arguments and rung) and the cell ``tinyd.sharded4`` on
    four chips, as files and ``BENCHMARK.json`` entries; returns the
    cell's name."""
    bench_dir = root / "portbench"
    cfg = json.loads((bench_dir / "configs/deep10m.json").read_text())
    cfg.update(name="tinyd", points=4000, dim=16, queries=200)
    cfg["data"]["clusters"] = 40
    cfg["index"].update(tinyroot.SMALL_INDEX, finalize={
        "pivots": 256, "pivot_cover": 0.5, "pivot_shortlist": 32}, serve_probes=6)
    (bench_dir / "configs/tinyd.json").write_text(json.dumps(cfg, indent=1))
    wl = json.loads((bench_dir / "workloads/deep10m.sharded4.json").read_text())
    wl.update(config="tinyd", rung={"ef": 32, "max_iters": 40})
    (bench_dir / "workloads/tinyd.sharded4.json").write_text(json.dumps(wl, indent=1))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tinyd.sharded4", "config": "tinyd",
                               "traffic": "batch", "chips": 4,
                               "why": "a tiny deep10m.sharded4"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "deep10m.sharded4" in m.get("workloads", []):
            m["workloads"].append("tinyd.sharded4")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return "tinyd.sharded4"


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_sharded_cell_runs_on_four_stand_ins(tmp_path, trace):
    root = tinyroot.make(tmp_path)
    cell = _add_tiny_sharded_cell(root)
    out = run_cell(root, cell, 2**31 + 57, 0.3, bool(trace), torch.device("cpu"))
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    if not trace:
        assert set(out["metrics"]) == {"qps", "recall_at_10", "setup_s"}


def test_a_program_without_the_probed_route_stops_at_once(monkeypatch):
    """Loading the family against a ``ShardedHNSW`` without
    ``serving_route`` raises before any data is made."""
    monkeypatch.delattr(ShardedHNSW, "serving_route")
    with pytest.raises(RuntimeError, match="probed route"):
        LAY.module("indexes", "hnsw_sharded")
