"""The port's stage spans and counters (``utils.logging.span``, ``count``,
``traced_spans``, ``counters``) on the CPU: the off path records nothing,
spans nest under ``torch.profiler`` with parent and call id, counters
match a hand count, answers do not change with the profiler on, the beam
counters match a hand-stepped loop, and ``build_phase_s`` keeps its keys.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hnsw_rs_tpu_torch import HNSW, build_cluster
from hnsw_rs_tpu_torch import search as tsearch
from hnsw_rs_tpu_torch.models.ivf import IVFFlatIndex
from hnsw_rs_tpu_torch.models.ivfpq import IVFPQIndex
from hnsw_rs_tpu_torch.utils import count, counters, reset_spans, span, traced_spans
from hnsw_rs_tpu_torch.utils.logging import recording

CLUSTER_KW = dict(pool_p=16, points_per_cluster=32, fanout=3,
                  select_alg4=False, merge_slots=16)


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _fresh_spans():
    reset_spans()
    yield
    reset_spans()


def _points(n, d=16, seed=0):
    rng = np.random.default_rng(seed)
    cent = rng.random((24, d), np.float32)
    x = cent[rng.integers(0, 24, n)] + 0.05 * rng.standard_normal(
        (n, d)).astype(np.float32)
    return x.astype(np.float32)


def test_off_path_records_nothing_and_shares_one_context():
    assert not recording()
    a, b = span("hnsw.a"), span("hnsw.b", device="cpu", layer=1)
    assert a is b
    with a:
        with span("hnsw.c"):
            count("t.off")
    assert traced_spans() == []
    assert counters() == {"t.off": 1}
    phases = {}
    timer = span("hnsw.build.kmeans", phases, "cpu", key="upper_kmeans")
    assert timer is not a
    with timer:
        sum(range(1000))
    with span("hnsw.build.merge", phases, "cpu"):
        pass
    assert set(phases) == {"upper_kmeans", "merge"}
    assert all(v >= 0.0 for v in phases.values())
    assert traced_spans() == []


def test_spans_nest_under_the_profiler_with_parent_and_call_id():
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    phases = {}
    with _profiler() as prof:
        assert recording()
        with span("hnsw.outer", device="cpu", batch=8):
            with span("hnsw.outer.first", phases, "cpu"):
                (x @ x).sum()
            with span("hnsw.outer.second", device="cpu"):
                with span("hnsw.outer.second.inner"):
                    x.sum()
        with span("hnsw.other"):
            pass
    assert not recording()
    recs = traced_spans()
    assert [r["name"] for r in recs] == [
        "hnsw.outer", "hnsw.outer.first", "hnsw.outer.second",
        "hnsw.outer.second.inner", "hnsw.other"]
    assert [r["parent"] for r in recs] == [None, 0, 0, 2, None]
    assert [r["index"] for r in recs] == list(range(5))
    assert len({recs[i]["call"] for i in range(4)}) == 1
    assert recs[4]["call"] != recs[0]["call"]
    assert recs[0]["batch"] == 8
    assert all(r["device_s"] is None for r in recs)  # no CUDA device
    for r in recs:
        assert r["t0"] <= r["t1"]
    for child, parent in ((1, 0), (2, 0), (3, 2)):
        assert recs[parent]["t0"] <= recs[child]["t0"]
        assert recs[child]["t1"] <= recs[parent]["t1"]
    assert set(phases) == {"first"}
    # the same ranges, nested the same way, on the profiler's own clock
    ev = {e.name: e for e in prof.events() if e.name.startswith("hnsw.")}
    assert set(ev) == {r["name"] for r in recs}
    for child, parent in (("hnsw.outer.first", "hnsw.outer"),
                          ("hnsw.outer.second.inner", "hnsw.outer.second")):
        c, p = ev[child].time_range, ev[parent].time_range
        assert p.start <= c.start and c.end <= p.end


def test_count_totals_match_a_hand_count():
    hand = {}
    rng = np.random.default_rng(5)
    with _profiler():
        with span("hnsw.c"):
            for step in rng.integers(1, 9, 40).tolist():
                count("t.steps", step)
                hand["t.steps"] = hand.get("t.steps", 0) + step
            count("t.dev", torch.tensor(7))
            count("t.dev", torch.tensor(5))
        count("t.steps")  # outside every span: the total only
    hand["t.steps"] += 1
    assert counters() == {**hand, "t.dev": 12}
    (rec,) = traced_spans()
    assert rec["counts"] == {"t.steps": hand["t.steps"] - 1, "t.dev": 12}
    reset_spans()
    assert counters() == {} and traced_spans() == []


class _OtherCard(torch.Tensor):
    """A CPU scalar standing for one on a second card: it says so, and,
    as CUDA tensors do, refuses arithmetic with a tensor of another card."""

    @property
    def device(self):
        return torch.device("cuda", 1)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if any(type(t) is not cls for t in tensors) and len(tensors) > 1:
            raise RuntimeError("Expected all tensors to be on the same device")
        return super().__torch_function__(func, types, args, kwargs or {})


def test_device_scalars_count_per_device_and_only_while_recording():
    """Shards on two cards count their beams into one counter without
    adding across the cards; with tracing off a device scalar costs no
    device work and is not counted."""
    count("t.dev", torch.tensor(4))
    assert counters() == {}
    with _profiler():
        with span("hnsw.a"):
            count("t.dev", torch.tensor(7))
        with span("hnsw.b"):
            count("t.dev", torch.tensor(5).as_subclass(_OtherCard))
        count("t.dev", torch.tensor(2))
        count("t.dev", torch.tensor(1).as_subclass(_OtherCard))
        count("t.dev", 3)
    assert counters() == {"t.dev": 18}
    assert [r["counts"] for r in traced_spans()] == [{"t.dev": 7}, {"t.dev": 5}]


@pytest.fixture(scope="module")
def cluster_index():
    idx = HNSW(8, ef_cons=32, dim=16, device="cpu")
    idx.insert_bulk(_points(3000), cluster_build=True,
                    cluster_kwargs=CLUSTER_KW)
    return idx


# the result stage: the answer's sqrt and slice, then the host reads
RESULT = ["hnsw.search.result"] * 2
ROUTE_STAGES = {
    "seeded": ["hnsw.search.quantize", "hnsw.search.seeds",
               "hnsw.search.beam"] + RESULT,
    "probe_packed": ["hnsw.search.quantize", "hnsw.search.seeds",
                     "hnsw.search.probe", "hnsw.search.beam"] + RESULT,
    "plain": ["hnsw.search.quantize", "hnsw.search.beam"] + RESULT,
}


@pytest.mark.parametrize("route", list(ROUTE_STAGES))
def test_ann_batch_answers_are_the_same_with_the_profiler_on(cluster_index,
                                                             route):
    idx = cluster_index
    if route == "seeded":
        idx.finalize(pivots=256)
    elif route == "probe_packed":
        idx.finalize(pivots=256, pivot_shortlist=32)
        idx.serve_probes = 6
    else:
        idx.finalize(packed=False)
    assert idx.serving_route() == route
    q = _points(64, seed=3)
    d_off, i_off = idx.ann_batch(q, 10, 32, max_iters=40)
    assert traced_spans() == []
    with _profiler():
        d_on, i_on = idx.ann_batch(q, 10, 32, max_iters=40)
    np.testing.assert_array_equal(i_on, i_off)
    np.testing.assert_array_equal(d_on, d_off)
    recs = traced_spans()
    assert recs[0]["name"] == "hnsw.ann_batch" and recs[0]["parent"] is None
    stages = [r["name"] for r in recs if r["parent"] == 0]
    assert stages == ROUTE_STAGES[route]
    assert {r["call"] for r in recs} == {recs[0]["call"]}
    (beam,) = [r for r in recs if r["name"] == "hnsw.search.beam"]
    assert beam["batch"] == 64
    assert 0 < beam["counts"]["beam.iterations"] <= 40
    assert set(beam["counts"]) == {"beam.iterations", "beam.live_lanes",
                                   "beam.rows_fetched", "beam.rows_new"}


def _hand_stepped(packed, q, entry_d2, entry_ids, ef, max_iters):
    """``_beam_loop`` over packed rows, stepped here: iterations, live
    lanes, fetched and new neighbor entries."""
    n, w = packed.shape
    d = q.shape[1]
    cap = w // (d + 12)
    ring_size = max(2 * cap, 64)
    beam_d2, beam_ids, beam_exp = tsearch.init_beam(entry_d2, entry_ids, ef)
    ring = tsearch._init_ring(entry_ids, ring_size)
    it = live = fetched = new = 0
    for _ in range(max_iters):
        if bool(beam_exp.all()):
            break
        cand, active, beam_exp, _ = tsearch._beam_pick(beam_ids, beam_exp, 1)
        nbrs, vecs = tsearch.unpack_rows(packed[cand.clamp(0, n - 1).long()],
                                         cap, d)
        valid = (nbrs >= 0) & active[:, None]
        known = ((nbrs[:, :, None] == beam_ids[:, None, :]).any(-1)
                 | (nbrs[:, :, None] == ring[:, None, :]).any(-1))
        it += 1
        live += int(active.sum())
        fetched += int(valid.sum())
        new += int((valid & ~known).sum())
        beam_d2, beam_ids, beam_exp, ring = tsearch._beam_merge(
            beam_d2, beam_ids, beam_exp, ring, q, active, nbrs, vecs, 1, cap)
    return beam_d2, beam_ids, {"beam.iterations": it, "beam.live_lanes": live,
                               "beam.rows_fetched": fetched,
                               "beam.rows_new": new}


@pytest.mark.parametrize("b", [1, 7])
def test_beam_counters_match_a_hand_stepped_loop(cluster_index, b):
    idx = cluster_index
    idx.finalize(pivots=256)
    q = idx._maybe_normalize(torch.from_numpy(_points(b, seed=11)))
    piv_ids, piv_vecs = idx._pivots
    e_d2, e_ids = tsearch._pivot_seeds(piv_ids, piv_vecs, q, 24)
    want_d2, want_ids, want = _hand_stepped(idx._packed0, q, e_d2, e_ids,
                                            24, 30)
    with _profiler():
        got_d2, got_ids = tsearch.search_layer_packed(idx._packed0, q, e_d2,
                                                      e_ids, 24, 30)
    torch.testing.assert_close(got_d2, want_d2, rtol=0, atol=0)
    assert torch.equal(got_ids, want_ids)
    (beam,) = [r for r in traced_spans() if r["name"] == "hnsw.search.beam"]
    if b == 1:  # one query: no device tallies, the live count is the iterations
        assert beam["counts"] == {"beam.iterations": want["beam.iterations"]}
        assert want["beam.live_lanes"] == want["beam.iterations"]
    else:
        assert beam["counts"] == want
        it = want["beam.iterations"]
        assert it <= want["beam.live_lanes"] <= b * it
    assert counters()["beam.iterations"] == want["beam.iterations"]


def _hnsw_cluster():
    idx = HNSW(8, ef_cons=32, dim=16, device="cpu")
    idx.insert_bulk(_points(3000), cluster_build=True, cluster_kwargs=CLUSTER_KW)
    return idx


def _hnsw_wave():
    idx = HNSW(8, ef_cons=32, dim=16, device="cpu")
    idx.insert_bulk(_points(1500))
    return idx


def _ivf():
    idx = IVFFlatIndex(16, n_lists=16, device="cpu")
    idx.train_add(_points(2000))
    return idx


def _ivfpq():
    idx = IVFPQIndex(16, n_lists=16, m_pq=4, pq_iters=2, device="cpu")
    idx.train_add(_points(2000))
    return idx


@pytest.mark.parametrize("make, keys", [
    (_hnsw_cluster, {"quantize", "kmeans", "tables", "select", "merge",
                     "repair", "upper_select", "upper_merge", "upper_repair",
                     "connectivity", "auto_finalize"}),
    (_hnsw_wave, {"quantize", "wave_descent", "wave_beam", "wave_select",
                  "wave_apply", "connectivity"}),
    (_ivf, {"quantize", "kmeans", "pack"}),
    (_ivfpq, {"coarse", "pq_train", "encode", "pack"}),
], ids=["hnsw_cluster", "hnsw_wave", "ivf", "ivfpq"])
@pytest.mark.parametrize("traced", [False, True])
def test_build_phase_keys_stay(make, keys, traced):
    assert not hasattr(build_cluster, "_mark")
    if traced:
        with _profiler():
            idx = make()
    else:
        idx = make()
    got = set(idx.build_phase_s)
    layers = {k for k in got if k.startswith("layer")}
    assert got - layers == keys
    if make is _hnsw_wave:
        assert layers == {f"layer{lv}" for lv in range(len(idx.graph))}
    assert all(v >= 0.0 for v in idx.build_phase_s.values())
    recs = traced_spans()
    if not traced:
        assert recs == []
    elif make is _hnsw_cluster:
        assert recs[0]["name"] == "hnsw.insert_bulk"
        phases = [r for r in recs if r["name"].split(".")[-1] in
                  ("kmeans", "tables", "select", "merge", "repair")]
        assert {r["layer"] == 0 for r in phases} == {True, False}
        assert {r["call"] for r in recs} == {recs[0]["call"]}
