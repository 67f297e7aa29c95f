"""Structured progress events + stage timing (port of `omfs4d.core.logging`).

Every stage emits machine-readable JSONL events alongside human-readable
logs, and `stage_timer` wraps a stage with the wall clock and, when asked, a
`torch.profiler` trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from pathlib import Path

_LOGGERS: dict[str, logging.Logger] = {}


def get_logger(tag: str) -> logging.Logger:
    if tag in _LOGGERS:
        return _LOGGERS[tag]
    logger = logging.getLogger(f"omfs4d_torch.{tag}")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(f"[{tag}] %(message)s"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("OMFS4D_LOGLEVEL", "INFO"))
        logger.propagate = False
    _LOGGERS[tag] = logger
    return logger


class EventLogger:
    """Append-only JSONL event stream.  With no path the records are only
    returned to the caller."""

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def emit(self, event: str, **fields):
        record = {"t": time.time(), "event": event, **fields}
        if self.path:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(record, default=float) + "\n")
        return record


@contextlib.contextmanager
def _profiler_trace(out_dir: Path):
    """A `torch.profiler` trace of the block (CPU activity, and the card's
    when there is one), written as a Chrome trace to `out_dir/trace.json`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out_dir / "trace.json"))


@contextlib.contextmanager
def stage_timer(name: str, events: EventLogger | None = None, profile_dir: str | None = None):
    """Time a pipeline stage; with `profile_dir`, also capture a
    `torch.profiler` trace under `profile_dir/name/`."""
    log = get_logger("pipeline")
    events = events or EventLogger()
    events.emit("stage_start", stage=name)
    t0 = time.perf_counter()
    trace_cm = contextlib.nullcontext()
    if profile_dir:
        trace_cm = _profiler_trace(Path(profile_dir) / name)
    try:
        with trace_cm:
            yield events
    finally:
        dt = time.perf_counter() - t0
        events.emit("stage_end", stage=name, seconds=dt)
        log.info(f"stage {name} finished in {dt:.2f}s")
