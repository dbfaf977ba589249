"""Each metric reader on a recorded event list and a made-up record."""

import json
from pathlib import Path

import pytest

from portbench.lib.layout import Layout
from portbench.lib.trace import breakdown, busy_window_s

from . import tinyroot

TRACE = json.loads((Path(__file__).parent / "data/events.json").read_text())
LAY = Layout(tinyroot.ROOT)


def read(name, rec):
    return LAY.module("metrics", name).read(rec)


@pytest.mark.parametrize("kind", ["batch", "probed", "online", "build"])
def test_device_idle(kind):
    # device busy: [1500, 4000] + [6000, 6500] + [9000, 10000] + [10500, 11000]
    assert read(f"device_idle.{kind}", {"trace": TRACE}) == pytest.approx(0.55)
    assert read(f"device_idle.{kind}", {}) is None
    cpu_only = {"t0": 0, "t1": 10, "events": [
        {"name": "aten::mm", "device": False, "t0": 1, "t1": 2}]}
    assert read(f"device_idle.{kind}", {"trace": cpu_only}) is None


def test_busy_window():
    assert busy_window_s(TRACE) == pytest.approx((4500e-9, 10000e-9))


def _two_cards(devices=None):
    # card 0 busy [1000, 3000], card 1 busy [2000, 7000]: no card busy in
    # [0, 1000] (a launch covers its midpoint) and [7000, 10000]
    tr = {"t0": 0, "t1": 10000, "events": [
        {"name": "portbench.traced_span", "device": False, "kernel": False,
         "t0": 0, "t1": 10000},
        {"name": "cudaLaunchKernel", "device": False, "kernel": False,
         "t0": 400, "t1": 900},
        {"name": "gemm_kernel", "device": True, "kernel": True,
         "t0": 1000, "t1": 3000, "device_index": 0},
        {"name": "gemm_kernel", "device": True, "kernel": True,
         "t0": 2000, "t1": 7000, "device_index": 1}]}
    if devices is not None:
        tr["devices"] = devices
    return tr


@pytest.mark.parametrize("devices, idle", [
    (None, (0.8 + 0.5) / 2),        # the cards the records name
    ([0, 1], (0.8 + 0.5) / 2),
    ([0, 1, 2, 3], (0.8 + 0.5 + 1.0 + 1.0) / 4),  # two cards idle all through
])
@pytest.mark.parametrize("kind", ["batch", "probed", "online", "build"])
def test_device_idle_is_the_mean_over_cards(kind, devices, idle):
    tr = _two_cards(devices)
    assert read(f"device_idle.{kind}", {"trace": tr}) == pytest.approx(idle)
    busy, window = busy_window_s(tr)
    assert window == pytest.approx(1e-5) and 1 - busy / window == pytest.approx(idle)


def test_breakdown_over_cards():
    b = breakdown(_two_cards([0, 1]))
    assert b["device_ops"] == [["gemm_kernel", pytest.approx(7000e-9)]]
    assert dict((k, v) for k, v in b["idle_gaps"]) == pytest.approx(
        {"host (no operator)": 3000e-9, "cudaLaunchKernel": 1000e-9})


def test_syncs_and_launches():
    rec = {"trace": TRACE, "traced_calls": 2, "traced_queries": 4}
    assert read("syncs_per_call.batch", rec) == 1.0  # two stream syncs
    assert read("syncs_per_call.probed", rec) == 1.0
    # kernels starting in the span: 1500, 3000, 9000, 10500 (the copy is none)
    assert read("launches_per_query.online", rec) == 1.0
    assert read("syncs_per_call.batch", {"trace": TRACE}) is None
    assert read("syncs_per_call.probed", {"trace": TRACE}) is None


def test_breakdown():
    b = breakdown(TRACE)
    assert b["device_ops"][0] == ["gemm_kernel", pytest.approx(3500e-9)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps == pytest.approx({"host (no operator)": 3000e-9,
                                  "cudaMemcpyAsync": 2000e-9,
                                  "cudaLaunchKernel": 500e-9})
    assert sum(gaps.values()) == pytest.approx(5500e-9)


def test_end_to_end_readers():
    rec = {"setup_s": 12.5, "window_s": 2.0, "queries_answered": 50000,
           "latencies_ms": list(range(1, 101)), "points_built": 3_000_000,
           "judge": {"recall_at_10": 0.995},
           "builds": [{"insert_bulk_s": 4.0, "finalize_s": 1.0},
                      {"insert_bulk_s": 6.0, "finalize_s": 2.0}]}
    assert read("setup_s", rec) == 12.5
    assert read("qps", rec) == 25000.0
    assert read("qps.probed", rec) == 25000.0
    assert read("latency_p95_ms", rec) == pytest.approx(95.05)
    assert read("recall_at_10", rec) == 0.995
    assert read("build_vec_per_s", rec) == 1_500_000.0
    assert read("insert_bulk_s.build", rec) == 5.0
    assert read("finalize_s.build", rec) == 1.5
    for name in ("qps", "qps.probed", "latency_p95_ms", "build_vec_per_s",
                 "insert_bulk_s.build", "finalize_s.build"):
        assert read(name, {"setup_s": 1.0, "window_s": 1.0}) is None
