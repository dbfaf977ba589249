"""Logging and profiling helpers (port of ``hnsw_rs_tpu/utils/logging.py``).

The reference logs through the ``log`` crate under ``RUST_LOG``
(``eval_glove/src/main.rs:18``). Here: stdlib logging under the
``hnsw_rs_tpu`` namespace, its level set by the JAX package's own
``HNSW_LOG`` variable (trace/debug/info/warn/error); :func:`timed`, a
wall-clock timer that drains a CUDA device before it reads the clock;
and :func:`profile_trace`, a ``torch.profiler`` trace in place of the
JAX package's ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import logging
import os
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
