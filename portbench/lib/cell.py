"""One run of one cell: what a traffic module is handed.

A traffic module (``portbench/traffic/<kind>.py``) gets a :class:`Cell`
and returns a record. The cell makes the data from the seed, builds and
queries through the configuration's index family, and runs the bounded
traced span. It holds the devices its ``chips`` ask for, ``devices``
(``cuda:0`` ... ``cuda:chips-1``; on the CPU as many stand-ins of the
one CPU device), and ``device``, the first of them, where the data is
made and the judge runs. The record holds what the metric readers read
and the answers the judge compares:

- ``window_start`` (perf_counter seconds) and ``window_s``: the measured
  window, which starts after every warm-up;
- ``answers``: ``(query indices, distances, ids)`` for every call whose
  answers are due, the window's and the traced span's;
- whatever the kind measures (``queries_answered``, ``latencies_ms``,
  ``points_built``, ``builds``), and with tracing ``trace`` plus its
  ``traced_calls`` / ``traced_queries``.
"""

from __future__ import annotations

import numpy as np
import torch

from .layout import Layout
from .trace import profile_span


def cell_devices(device: torch.device, chips: int) -> list[torch.device]:
    """The devices of a cell on ``chips`` cards of ``device``'s kind:
    ``cuda:0`` ... ``cuda:chips-1``, or ``chips`` stand-ins of the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [device] * chips


class Cell:
    def __init__(self, layout: Layout, name: str, seed: int, seconds: float,
                 trace: bool, device: torch.device, family=None):
        self.name = name
        self.workload = layout.workload(name)
        self.config = layout.config(self.workload["config"])
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.devices = cell_devices(device, int(layout.cell_entry(name)["chips"]))
        self.device = self.devices[0]
        # each card once, in order: what is drained, traced and read for peaks
        self.cards = [d for d in dict.fromkeys(self.devices) if d.type == "cuda"]
        self.params = self.workload.get("params", {})
        self.rung = self.workload.get("rung", {})
        self.k = int(self.config["k"])
        self.generator = layout.module("data", self.config["data"]["generator"])
        self.family = family or layout.module("indexes",
                                              self.config["index"]["family"])
        self.train: np.ndarray | None = None
        self.queries: np.ndarray | None = None

    def make_data(self) -> tuple[np.ndarray, np.ndarray]:
        """Points and queries from the seed, drawn on the device; the
        program and the reference are handed the same host arrays."""
        c = self.config
        spec = dict(c["data"], points=c["points"], dim=c["dim"],
                    queries=c["queries"])
        tr, q = self.generator.make(spec, self.seed, self.device)
        self.train, self.queries = tr.cpu().numpy(), q.cpu().numpy()
        del tr, q
        return self.train, self.queries

    def build(self, train: np.ndarray):
        """(index, spans) through the family, handed the configuration
        and the cell's devices; the family drains what it used."""
        return self.family.build(self.config, train, self.devices)

    def search(self, index, queries: np.ndarray):
        return self.family.search(index, queries, self.k, self.rung)

    def drain(self) -> None:
        """Wait for every one of the cell's cards."""
        for d in self.cards:
            torch.cuda.synchronize(d)

    def traced(self, fn):
        """``fn()`` under the profiler: (result, trace)."""
        return profile_span(fn, self.cards)
