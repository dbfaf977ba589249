"""The program's own stage spans and beam counters, as the per-layer
metrics read them: ``hnsw_rs_tpu_torch.utils.logging.traced_spans()``,
which the port fills while a profiler records (the traced span runs after
the measured window). A record is ``{"name", "index", "parent", "call",
"t0", "t1", "device_s", "counts", ...}``: ``call`` is shared by every
span of one public call, ``device_s`` is the stage's time on the device
clock (CUDA events on the stream; None on the CPU), ``t0``/``t1`` the
host clock.

Every reader returns None where there is nothing to read: a program that
records no spans (one older than them), a run without a trace, or a
device-clock reading on the CPU.
"""

from __future__ import annotations

CALL = "hnsw.ann_batch"
BUILD = "hnsw.insert_bulk"
BEAM = "hnsw.search.beam"


def records(rec) -> list[dict] | None:
    """The spans of this run's traced span: those that started after the
    record's measured window ended."""
    try:
        from hnsw_rs_tpu_torch.utils.logging import traced_spans
    except ImportError:
        return None
    if "window_start" not in rec or not rec.get("trace"):
        return None
    start = rec["window_start"] + rec["window_s"]
    return [r for r in traced_spans() if r["t0"] >= start] or None


def seconds(r: dict, clock: str) -> float | None:
    """A span's seconds on the ``"device"`` clock (None without one) or
    the ``"host"`` clock."""
    return r["device_s"] if clock == "device" else r["t1"] - r["t0"]


def roots(recs: list[dict], name: str) -> list[dict]:
    return [r for r in recs if r["name"] == name and r["parent"] is None]


def in_calls(recs: list[dict], name: str, root: str) -> list[dict]:
    """Spans named ``name`` inside the calls that ``root`` spans open."""
    calls = {r["call"] for r in roots(recs, root)}
    return [r for r in recs if r["name"] == name and r["call"] in calls]


def stage_share(rec, stage: str, clock: str = "device") -> float | None:
    """Σ ``stage`` seconds / Σ ``hnsw.ann_batch`` seconds over the traced
    calls."""
    recs = records(rec)
    if not recs:
        return None
    calls = [seconds(r, clock) for r in roots(recs, CALL)]
    parts = [seconds(r, clock) for r in in_calls(recs, stage, CALL)]
    if not calls or None in calls or None in parts or sum(calls) <= 0:
        return None
    return sum(parts) / sum(calls)


def beam_counts(rec) -> dict | None:
    """The beam counters summed over the traced calls' beam spans, with
    ``lanes`` = Σ iterations x batch over the spans that tallied lanes
    (batches of more than one query)."""
    recs = records(rec)
    if not recs:
        return None
    out = {"lanes": 0}
    for r in in_calls(recs, BEAM, CALL):
        c = r["counts"]
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
        if "beam.live_lanes" in c:
            out["lanes"] += c["beam.iterations"] * r["batch"]
    return out


def ratio(num: str, den: str):
    """A reader of ``counts[num] / counts[den]`` over :func:`beam_counts`."""
    def read(rec):
        c = beam_counts(rec)
        if not c or not c.get(den) or num not in c:
            return None
        return c[num] / c[den]
    return read


def phase_s(rec, phase: str, clock: str = "device") -> float | None:
    """Seconds of the cluster build's ``hnsw.build.<phase>`` spans (every
    layer) per traced ``insert_bulk``."""
    recs = records(rec)
    if not recs:
        return None
    builds = roots(recs, BUILD)
    parts = [seconds(r, clock)
             for r in in_calls(recs, f"hnsw.build.{phase}", BUILD)]
    if not builds or not parts or None in parts:
        return None
    return sum(parts) / len(builds)
