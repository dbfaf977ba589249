"""Logging and profiling helpers (port of ``hnsw_rs_tpu/utils/logging.py``).

The reference logs through the ``log`` crate under ``RUST_LOG``
(``eval_glove/src/main.rs:18``). Here: stdlib logging under the
``hnsw_rs_tpu`` namespace, its level set by the JAX package's own
``HNSW_LOG`` variable (trace/debug/info/warn/error); :func:`timed`, a
wall-clock timer that drains a CUDA device before it reads the clock;
and :func:`profile_trace`, a ``torch.profiler`` trace in place of the
JAX package's ``jax.profiler`` one; and the port's stage spans and
counters (:func:`span`, :func:`count`, :func:`traced_spans`,
:func:`counters`), which cost a flag check while no profiler records.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time

import torch

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    level = _LEVELS.get(os.environ.get("HNSW_LOG", "warn").lower(), logging.WARNING)
    root = logging.getLogger("hnsw_rs_tpu")
    root.setLevel(level)
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s"))
        root.addHandler(h)


def get_logger(name: str) -> logging.Logger:
    """Logger under the ``hnsw_rs_tpu`` namespace; level set by
    ``HNSW_LOG`` (the ``RUST_LOG`` analogue)."""
    _configure()
    return logging.getLogger(f"hnsw_rs_tpu.{name}")


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile_trace(path: str, device: torch.device | str):
    """Record a ``torch.profiler`` trace of the block: CPU activity
    always, CUDA activity too when ``device`` is a CUDA device. The
    Chrome trace (``chrome://tracing``, Perfetto) is written to
    ``path/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync(device)
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


@contextlib.contextmanager
def timed(label: str, logger: logging.Logger | None = None,
          device: torch.device | str | None = None):
    """Wall-clock timer, logged at INFO. With a CUDA ``device`` it drains
    the device before each clock read, so the time is the card's."""
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    dt = time.perf_counter() - t0
    (logger or get_logger("timing")).info("%s: %.4fs", label, dt)


# -- stage spans and counters -------------------------------------------------
#
# A span names one stage of a public call. While no ``torch.profiler``
# profile records, ``span`` returns a shared no-op context (or, when handed
# a ``phases`` dict, a host-clock phase timer that drains the device at its
# end). While one records, the span also opens a ``record_function`` range
# on the profiler's clock and appends a record: name, parent, call id, host
# clock, a CUDA event pair on the current stream (stage time on the device
# clock, resolved only when the records are read) and the counts added
# inside it.

_NOOP = contextlib.nullcontext()
_records: list[dict] = []
_totals: dict = {}
_calls = itertools.count()
_local = threading.local()  # each thread's stack of open span records
_lock = threading.Lock()  # the record list and the totals are shared


def recording() -> bool:
    """True while a ``torch.profiler`` profile records in this process."""
    return torch._C._autograd._profiler_enabled()


def _open_spans() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Phase:
    """Host-clock seconds of a block, added to ``phases[key]`` after the
    device has drained."""

    __slots__ = ("phases", "key", "device", "t0")

    def __init__(self, phases: dict, key: str, device):
        self.phases, self.key, self.device = phases, key, device

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        _sync(self.device)
        self.phases[self.key] = (self.phases.get(self.key, 0.0)
                                 + time.perf_counter() - self.t0)
        return False


class _Span(_Phase):
    """A :class:`_Phase` (when ``phases`` is a dict) that also records
    itself: a ``record_function`` range and an entry in the span list."""

    __slots__ = ("name", "rec", "rf", "ev1")

    def __init__(self, name: str, phases, key: str, device, fields: dict):
        super().__init__(phases, key, device)
        self.name = name
        self.rec = fields

    def __enter__(self):
        self.t0 = time.perf_counter()
        st = _open_spans()
        parent = st[-1] if st else None
        rec = self.rec
        rec.update(name=self.name, t0=self.t0, t1=None, counts={},
                   parent=parent["index"] if parent else None,
                   call=parent["call"] if parent else next(_calls),
                   events=None)
        with _lock:
            rec["index"] = len(_records)
            _records.append(rec)
        st.append(rec)
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()
        dev = None if self.device is None else torch.device(self.device)
        if dev is not None and dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record(torch.cuda.current_stream(dev))
            self.ev1 = torch.cuda.Event(enable_timing=True)
            rec["events"] = (e0, self.ev1)
        else:
            self.ev1 = None

    def __exit__(self, *exc):
        if self.phases is not None:
            _sync(self.device)
            self.phases[self.key] = (self.phases.get(self.key, 0.0)
                                     + time.perf_counter() - self.t0)
        if self.ev1 is not None:
            self.ev1.record(torch.cuda.current_stream(torch.device(self.device)))
        self.rf.__exit__(*exc)
        _open_spans().pop()
        self.rec["t1"] = time.perf_counter()
        return False


def span(name: str, phases: dict | None = None, device=None,
         key: str | None = None, **fields):
    """Context manager naming one stage (``hnsw.search.beam``).

    ``phases``: when a dict, the block's host-clock seconds, taken after
    ``device`` has drained, are added to ``phases[key]`` (``key`` defaults
    to the name's last part). While a ``torch.profiler`` profile records,
    the block is also a ``record_function`` range and a record of
    :func:`traced_spans`, with ``fields`` copied into it and, on a CUDA
    ``device``, a pair of events on the current stream; nothing waits on
    the device but the ``phases`` drain. Otherwise it is a shared no-op
    context, or just the phase timer."""
    if recording():
        return _Span(name, phases, key or name.rsplit(".", 1)[-1], device,
                     fields)
    if phases is None:
        return _NOOP
    return _Phase(phases, key or name.rsplit(".", 1)[-1], device)


def count(name: str, n=1) -> None:
    """Add ``n`` to the process counter ``name`` and, inside a recorded
    span, to that span's counts. ``n`` may be a device scalar tensor: it
    is counted only while a profiler records (otherwise nothing runs on
    the device for it), stays on its device until the counts are read,
    and is summed with the scalars of its own device only, so shards on
    several cards never add across them."""
    key = name
    if isinstance(n, torch.Tensor):
        if not recording():
            return
        key = (name, n.device)
    with _lock:
        _totals[key] = _totals.get(key, 0) + n
    st = getattr(_local, "stack", None)
    if st:
        c = st[-1]["counts"]
        c[name] = c.get(name, 0) + n


def counters() -> dict[str, int]:
    """The process totals of :func:`count` (device tallies read now)."""
    with _lock:
        totals = dict(_totals)
    out = {}
    for k, v in totals.items():
        name = k if isinstance(k, str) else k[0]
        out[name] = out.get(name, 0) + int(v)
    return out


def traced_spans() -> list[dict]:
    """The spans recorded while a profiler ran, in the order they opened:
    ``name``, ``index``, ``parent`` (an index, or None), ``call`` (shared
    by every span of one outermost call), host ``t0``/``t1``
    (``time.perf_counter`` seconds), ``device_s`` (seconds between the
    span's two events on the device clock, None without a CUDA device),
    ``counts`` and the span's fields. Waits for the events and device
    tallies it reads."""
    out = []
    with _lock:
        recs = list(_records)
    for r in recs:
        o = {k: v for k, v in r.items() if k != "events"}
        o["counts"] = {k: int(v) for k, v in r["counts"].items()}
        ev = r["events"]
        o["device_s"] = None
        if ev is not None and r["t1"] is not None:
            ev[1].synchronize()
            o["device_s"] = ev[0].elapsed_time(ev[1]) / 1e3
        out.append(o)
    return out


def reset_spans() -> None:
    """Forget the recorded spans and the counters."""
    with _lock:
        _records.clear()
        _totals.clear()
