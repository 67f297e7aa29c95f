"""Per-stage times of a render loop, on the device's own clock.

`StageClock.lap(name)` closes the stage that began at the previous lap (or
at `start()`).  On a CUDA device each lap records an event on the current
stream, so the stages are timed without a synchronise between them;
`totals_ms()` synchronises once and sums.  On the CPU, where PyTorch runs
each op to completion before it returns, the host clock is the device
clock.  Host-side work (PNG encoding) is added with `add_host_ms`, and the
binning counters of each frame with `add_counters`.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class StageClock:
    def __init__(self, device: str | torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self._laps: list[tuple[str, object, object]] = []
        self._last = None
        self._host_ms: dict[str, float] = defaultdict(float)
        self._counters: list[dict] = []

    def _now(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def start(self) -> None:
        self._last = self._now()

    def lap(self, name: str) -> None:
        now = self._now()
        self._laps.append((name, self._last, now))
        self._last = now

    def add_host_ms(self, name: str, ms: float) -> None:
        self._host_ms[name] += ms

    def add_counters(self, counters: dict) -> None:
        self._counters.append(counters)

    def totals_ms(self) -> dict[str, float]:
        """Summed milliseconds per stage name."""
        if self.cuda:
            torch.cuda.synchronize()
        out: dict[str, float] = defaultdict(float)
        for name, a, b in self._laps:
            out[name] += a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        for name, ms in self._host_ms.items():
            out[name] += ms
        return dict(out)

    def counters(self) -> list[dict[str, int]]:
        """Per-frame counters as host ints (synchronises)."""
        return [{k: int(v) for k, v in c.items()} for c in self._counters]
