"""The traced span: ``torch.profiler`` (CUPTI) over a bounded number of
calls, reduced in memory to a list of plain records; nothing is written
to disk. The arithmetic follows ``hnsw_rs_tpu_torch/utils/logging.py``'s
``profile_trace`` and ``chip_smoke.py``'s ``device_profile``, with the
busy time taken as the union of device intervals (kernels that overlap
on two streams count once) and not as a sum of durations.

A record is ``{"name": str, "device": bool, "kernel": bool, "t0": ns,
"t1": ns}``: ``device`` marks work on a card (kernels, copies, sets),
``kernel`` a kernel among them (one launch each); the rest is host
activity (operators, CUDA runtime calls, the span's own marker). A device
record also carries ``device_index``, its card (0 where a record lacks
it). The profiler's device-side copies of annotation spans are not work
and are dropped. The trace lists the cell's cards under ``devices``.

Over several cards: ``busy_s`` and the idle share are each card's own,
1 - busy union / span, averaged over the cell's cards (a card with no
record is idle all through); ``breakdown``'s device operations sum every
card's, and its idle gaps are the stretches in which no card is busy.
With one card all three read as they would without the index.
"""

from __future__ import annotations

SPAN = "portbench.traced_span"
# blocking host waits: the runtime's synchronisations and the synchronous
# copies under ``.cpu()`` / ``.item()``
SYNC_NAMES = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize", "cuMemcpyDtoH_v2", "cuMemcpyDtoH"})


def profile_span(fn, cards):
    """Run ``fn()`` once under the profiler, inside a marker span that
    ends after every one of ``cards`` (CUDA devices; none on the CPU) has
    drained. Returns ``(fn's result, trace)`` with ``trace = {"events":
    [...], "t0": ns, "t1": ns, "devices": [card indices]}``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if cards:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            out = fn()
            for d in cards:
                torch.cuda.synchronize(d)
    raw = [(e.name(), e.device_type() != torch.autograd.DeviceType.CPU,
            int(e.start_ns()), int(e.end_ns()), int(e.device_index()))
           for e in prof.profiler.kineto_results.events()]
    # an annotation's device-side copy carries its host span's name; no
    # kernel or copy is named like a host operator or runtime call
    host_names = {name for name, dev, _, _, _ in raw if not dev}
    events = []
    for name, dev, t0, t1, idx in raw:
        if dev and name in host_names:
            continue
        e = {"name": name, "device": dev,
             "kernel": dev and not name.startswith(("Memcpy", "Memset")),
             "t0": t0, "t1": t1}
        if dev:
            e["device_index"] = idx
        events.append(e)
    span = [e for e in events if e["name"] == SPAN and not e["device"]]
    if not span:
        raise RuntimeError("the profiler recorded no span marker")
    return out, {"events": events, "t0": span[0]["t0"], "t1": span[0]["t1"],
                 "devices": [d.index for d in cards]}


def trace_cards(trace) -> list[int]:
    """The cell's cards: those the trace lists, else those its device
    records name."""
    return list(trace.get("devices") or sorted(
        {e.get("device_index", 0) for e in trace["events"] if e["device"]}))


def device_intervals(trace, card: int | None = None) -> list[tuple[int, int]]:
    """Merged busy intervals of one card, clipped to the span; with
    ``card`` None, of all cards together (some card busy)."""
    lo, hi = trace["t0"], trace["t1"]
    iv = sorted((max(e["t0"], lo), min(e["t1"], hi)) for e in trace["events"]
                if e["device"] and e["t1"] > lo and e["t0"] < hi
                and (card is None or e.get("device_index", 0) == card))
    merged: list[list[int]] = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_window_s(trace) -> tuple[float, float]:
    """(seconds in which some operation ran on a card, averaged over the
    cell's cards; span seconds)."""
    cards = trace_cards(trace)
    busy = (sum(sum(b - a for a, b in device_intervals(trace, c)) for c in cards)
            / len(cards) if cards else 0)
    return busy / 1e9, (trace["t1"] - trace["t0"]) / 1e9


def idle_share(trace) -> float | None:
    """Each card's 1 - busy union / span, averaged over the cell's cards;
    None when the span saw no device operation (a CPU run): nothing to
    read."""
    busy, window = busy_window_s(trace)
    if busy <= 0 or window <= 0:
        return None
    return 1.0 - busy / window


def read_idle(rec) -> float | None:
    """The reader of every ``device_idle.<cells>`` metric: the idle share
    of the record's traced span, None without one."""
    tr = rec.get("trace")
    return idle_share(tr) if tr else None


def read_syncs_per_call(rec) -> float | None:
    """The reader of every ``syncs_per_call.<cells>`` metric: blocking host
    waits (``SYNC_NAMES``) per traced call, None without a device trace."""
    tr = rec.get("trace")
    if not tr or not has_device(tr) or not rec.get("traced_calls"):
        return None
    return count_host(tr, lambda n: n in SYNC_NAMES) / rec["traced_calls"]


def count_host(trace, pred) -> int:
    """Host records inside the span whose name satisfies ``pred``."""
    lo, hi = trace["t0"], trace["t1"]
    return sum(1 for e in trace["events"]
               if not e["device"] and lo <= e["t0"] <= hi and pred(e["name"]))


def count_kernels(trace) -> int:
    """Kernels that started on the device inside the span."""
    lo, hi = trace["t0"], trace["t1"]
    return sum(1 for e in trace["events"]
               if e.get("kernel") and lo <= e["t0"] <= hi)


def has_device(trace) -> bool:
    return any(e["device"] for e in trace["events"])


def breakdown(trace, top: int = 10) -> dict:
    """The device operations that took most time, summed over every card,
    and the idle gaps by what the host was doing: each gap in which no
    card is busy is charged to the shortest host record that covers its
    midpoint (the innermost operator or runtime call), or to "host (no
    operator)"."""
    lo, hi = trace["t0"], trace["t1"]
    per_op: dict[str, float] = {}
    for e in trace["events"]:
        if e["device"] and e["t1"] > lo and e["t0"] < hi:
            dt = (min(e["t1"], hi) - max(e["t0"], lo)) / 1e9
            per_op[e["name"]] = per_op.get(e["name"], 0.0) + dt
    host = sorted((e for e in trace["events"]
                   if not e["device"] and e["name"] != SPAN),
                  key=lambda e: e["t0"])
    gaps: dict[str, float] = {}
    edge, nxt, active = lo, 0, []
    # one sweep: gap midpoints rise, so the records open at a midpoint are
    # those started before it and not yet ended (a call stack per thread)
    for a, b in device_intervals(trace) + [(hi, hi)]:
        if a > edge:
            mid = (a + edge) // 2
            while nxt < len(host) and host[nxt]["t0"] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [e for e in active if e["t1"] >= mid]
            best = min(active, key=lambda e: e["t1"] - e["t0"], default=None)
            name = best["name"] if best else "host (no operator)"
            gaps[name] = gaps.get(name, 0.0) + (a - edge) / 1e9
        edge = max(edge, b)

    def top_n(d):
        return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_n(per_op), "idle_gaps": top_n(gaps)}
