"""The readers of the program's own spans and beam counters
(``lib/spans.py`` and the metrics on it): on made-up records, and on
tiny CPU runs of every traffic kind, where the stage spans must partition
each traced ``ann_batch`` call and the phase spans each build."""

import gc

import pytest
import torch

import hnsw_rs_tpu_torch.utils.logging as plog
from portbench.lib import spans
from portbench.lib.cell import Cell
from portbench.lib.layout import Layout
from portbench.lib.trace import breakdown

from . import tinyroot

LAY = Layout(tinyroot.ROOT)
SHARES = ("seeds_share.batch", "probe_share.probed", "beam_share.online")
PHASES = ("kmeans", "tables", "select", "merge", "repair")
STAGES = ("quantize", "seeds", "probe", "beam", "result")


def read(name, rec):
    return LAY.module("metrics", name).read(rec)


def _span(i, name, parent, call, t0, t1, device_s, counts=None, **fields):
    return {"name": name, "index": i, "parent": parent, "call": call,
            "t0": t0, "t1": t1, "device_s": device_s,
            "counts": counts or {}, **fields}


MADE_UP = [
    # before the window's end: not this run's traced span
    _span(0, "hnsw.ann_batch", None, 0, 1.0, 2.0, 9.0),
    _span(1, "hnsw.search.beam", 0, 0, 1.1, 1.9, 9.0),
    # two traced calls
    _span(2, "hnsw.ann_batch", None, 1, 20.0, 21.0, 1.0),
    _span(3, "hnsw.search.seeds", 2, 1, 20.0, 20.1, 0.1),
    _span(4, "hnsw.search.probe", 2, 1, 20.1, 20.3, 0.2),
    _span(5, "hnsw.search.beam", 2, 1, 20.3, 21.0, 0.6, batch=4,
          counts={"beam.iterations": 10, "beam.live_lanes": 30,
                  "beam.rows_fetched": 200, "beam.rows_new": 50}),
    _span(6, "hnsw.ann_batch", None, 2, 22.0, 25.0, 3.0),
    _span(7, "hnsw.search.seeds", 6, 2, 22.0, 22.5, 0.5),
    _span(8, "hnsw.search.beam", 6, 2, 22.5, 25.0, 2.0, batch=1,
          counts={"beam.iterations": 40}),
    # one traced build, two layers
    _span(9, "hnsw.insert_bulk", None, 3, 30.0, 40.0, 10.0),
    _span(10, "hnsw.build.select", 9, 3, 30.0, 31.0, 0.25, layer=1),
    _span(11, "hnsw.build.kmeans", 9, 3, 31.0, 32.0, 1.5, layer=0),
    _span(12, "hnsw.build.select", 9, 3, 32.0, 33.0, 0.75, layer=0),
    # a beam outside any ann_batch call (a wave build's) is not counted
    _span(13, "hnsw.search.beam", 9, 3, 33.0, 34.0, 1.0, batch=8,
          counts={"beam.iterations": 5, "beam.live_lanes": 40}),
]


def test_readers_on_made_up_records(monkeypatch):
    monkeypatch.setattr(plog, "traced_spans", lambda: MADE_UP)
    rec = {"window_start": 5.0, "window_s": 10.0, "trace": {"events": []}}
    assert read("seeds_share.batch", rec) == pytest.approx(0.6 / 4.0)
    assert read("probe_share.probed", rec) == pytest.approx(0.2 / 4.0)
    assert read("beam_share.online", rec) == pytest.approx(2.6 / 4.0)
    assert read("beam_occupancy.probed", rec) == pytest.approx(30 / 40)
    assert read("beam_new_share.probed", rec) == pytest.approx(50 / 200)
    assert read("kmeans_s.build", rec) == pytest.approx(1.5)
    assert read("select_s.build", rec) == pytest.approx(1.0)
    for ph in ("tables", "merge", "repair"):
        assert read(f"{ph}_s.build", rec) is None
    assert spans.stage_share(rec, "hnsw.search.seeds", "host") == pytest.approx(0.6 / 4.0)
    # nothing to read: no trace, no window, or a host-only record
    names = SHARES + ("beam_occupancy.probed", "beam_new_share.probed") + tuple(
        f"{ph}_s.build" for ph in PHASES)
    for name in names:
        assert read(name, {"window_start": 5.0, "window_s": 10.0}) is None
        assert read(name, {"trace": {"events": []}}) is None
    cpu = [dict(r, device_s=None) for r in MADE_UP]
    monkeypatch.setattr(plog, "traced_spans", lambda: cpu)
    for name in SHARES + ("kmeans_s.build", "select_s.build"):
        assert read(name, rec) is None
    assert read("beam_occupancy.probed", rec) == pytest.approx(30 / 40)


def test_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(plog, "traced_spans")
    rec = {"window_start": 5.0, "window_s": 10.0, "trace": {"events": []}}
    for name in SHARES + ("beam_occupancy.probed", "kmeans_s.build"):
        assert read(name, rec) is None


def test_breakdown_charges_a_gap_inside_a_program_span_to_it():
    ev = lambda name, dev, t0, t1: {"name": name, "device": dev,
                                    "kernel": dev, "t0": t0, "t1": t1}
    trace = {"t0": 0, "t1": 1000, "events": [
        ev("portbench.traced_span", False, 0, 1000),
        ev("hnsw.ann_batch", False, 0, 880),
        ev("hnsw.search.beam", False, 150, 850),
        ev("aten::mm", False, 100, 130),
        ev("k1", True, 100, 200),
        ev("k2", True, 400, 500),
        ev("k3", True, 700, 800),
    ]}
    gaps = dict((k, v) for k, v in breakdown(trace)["idle_gaps"])
    # [0, 100] lies in ann_batch before the beam; [200, 400] and [500, 700]
    # in the beam, whose span is shorter; [800, 1000]'s midpoint is past
    # ann_batch
    assert gaps == pytest.approx({"hnsw.ann_batch": 100e-9,
                                  "hnsw.search.beam": 400e-9,
                                  "host (no operator)": 200e-9})


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tinyroot.make(tmp_path_factory.mktemp("spans"))


def _traced_record(root, cell):
    plog.reset_spans()
    c = Cell(Layout(root), cell, 2**31 + 29, 0.3, True, torch.device("cpu"))
    # a collector pause between two stages is no stage's time: keep it out
    # of the partition check
    gc.disable()
    try:
        rec = LAY.module("traffic", c.workload["traffic"]).run(c)
    finally:
        gc.enable()
    rec.pop("answers")
    return rec


@pytest.mark.parametrize("cell", ["tiny.batch", "tinyp.probed", "tiny.online"])
def test_stage_spans_partition_each_traced_call(tiny_root, cell):
    rec = _traced_record(tiny_root, cell)
    recs = spans.records(rec)
    calls = spans.roots(recs, spans.CALL)
    assert len(calls) == rec["traced_calls"]
    # per pivot chunk: the seeds, then on the probed route the probe
    middle = ["seeds", "probe"] if cell == "tinyp.probed" else ["seeds"]
    uncovered, wholes = [], []
    for call in calls:
        stages = [r for r in recs if r["parent"] == call["index"]]
        names = [r["name"].rsplit(".", 1)[-1] for r in stages]
        assert names[0] == "quantize" and names[-3:] == ["beam", "result", "result"]
        chunk = names[1:-3]
        assert chunk == middle * (len(chunk) // len(middle)) and chunk
        # one after another inside the call
        edges = [call["t0"]] + [t for r in stages for t in (r["t0"], r["t1"])]
        assert edges == sorted(edges) and edges[-1] <= call["t1"]
        wholes.append(spans.seconds(call, "host"))
        uncovered.append(
            wholes[-1] - sum(spans.seconds(r, "host") for r in stages))
    # the stages cover all but 2% of the median call and of all the calls
    # together: on a loaded CPU a scheduler pause of several ms can land
    # between two stages of a ~20-ms call, so no single call decides
    shares = sorted(u / w for u, w in zip(uncovered, wholes))
    assert shares[len(shares) // 2] <= 0.02, shares
    assert sum(uncovered) <= 0.02 * sum(wholes), shares
    for stage in STAGES:
        share = spans.stage_share(rec, f"hnsw.search.{stage}", "host")
        assert 0.0 <= share <= 1.0
    # the device-clock readers have nothing to read on the CPU
    for name in SHARES:
        assert read(name, rec) is None
    c = spans.beam_counts(rec)
    if cell == "tiny.online":
        assert "beam.live_lanes" not in c and c["beam.iterations"] > 0
    else:
        for name in ("beam_occupancy.probed", "beam_new_share.probed"):
            assert 0.0 < read(name, rec) <= 1.0


def test_phase_spans_of_a_traced_build(tiny_root):
    rec = _traced_record(tiny_root, "tiny.build")
    for ph in PHASES:
        assert spans.phase_s(rec, ph, "host") > 0.0
        assert read(f"{ph}_s.build", rec) is None  # no device clock here
    recs = spans.records(rec)
    (build,) = spans.roots(recs, spans.BUILD)
    parts = sum(spans.phase_s(rec, ph, "host") for ph in PHASES)
    assert parts < spans.seconds(build, "host")
