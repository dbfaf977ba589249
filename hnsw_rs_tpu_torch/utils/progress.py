"""Progress reporting on stderr (the reference's ``indicatif`` bars with
throughput and ETA, ``hnsw/src/helpers.rs:7-23``). A copy of
``hnsw_rs_tpu/utils/progress.py``."""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, desc: str, total: int | None = None, enabled: bool = True):
        self.desc = desc
        self.total = total
        self.enabled = enabled
        self.count = 0
        self.start = time.perf_counter()
        self._last_render = 0.0

    def inc(self, n: int = 1) -> None:
        self.count += n
        now = time.perf_counter()
        if self.enabled and (now - self._last_render > 0.25):
            self._last_render = now
            self._render(now)

    def _render(self, now: float) -> None:
        elapsed = now - self.start
        rate = self.count / elapsed if elapsed > 0 else 0.0
        msg = f"\r{self.desc}: {self.count}"
        if self.total:
            pct = 100.0 * self.count / self.total
            eta = (self.total - self.count) / rate if rate > 0 else float("inf")
            msg += f"/{self.total} ({pct:.1f}%) [{rate:.0f}/s, eta {eta:.0f}s]"
        else:
            msg += f" [{rate:.0f}/s]"
        sys.stderr.write(msg)
        sys.stderr.flush()

    def finish(self) -> None:
        if self.enabled:
            self._render(time.perf_counter())
            sys.stderr.write("\n")


def progress_iter(iterable, desc: str = "", total: int | None = None,
                  enabled: bool = True):
    bar = ProgressBar(desc, total, enabled)
    for item in iterable:
        yield item
        bar.inc()
    bar.finish()
