"""Pipeline progress mapping for UI progress bars.

Port of `omfs4d.app.progress` (verbatim): the port's pipeline emits the same
event records (`omfs4d_torch.core.logging.EventLogger`).

The reference drives a streamlit progress bar by regex-matching VHAP's
stdout against a stage table (ref: app.py:1279-1323).  Here the pipeline
emits structured JSONL events (core/logging.py), so progress is a pure
function of the event stream — no log scraping, works for any frontend.
"""

from __future__ import annotations

import json
from pathlib import Path

#: (event, stage-prefix) -> (percent, status text).  Ordered; the highest
#: matching percent wins, so progress is monotone even if events repeat.
STAGE_PROGRESS: tuple[tuple[str, str, int, str], ...] = (
    ("stage_start", "preprocess",            5,  "Extracting video frames..."),
    ("stage_end",   "preprocess",           15,  "Frames + masks ready"),
    ("stage_start", "track",                25,  "Detecting facial landmarks..."),
    ("track_stage", "lmk_init_rigid",       40,  "Landmark init (rigid)..."),
    ("track_stage", "lmk_init_all",         45,  "Landmark init (all)..."),
    ("track_stage", "rgb_init_texture",     50,  "RGB texture optimization..."),
    ("track_stage", "rgb_init_all",         60,  "RGB full optimization..."),
    ("track_stage", "rgb_init_offset",      65,  "RGB offset optimization..."),
    ("track_stage", "rgb_sequential_tracking", 70, "Sequential tracking..."),
    ("track_stage", "global_optimization",  80,  "Global optimization..."),
    ("stage_end",   "track",                85,  "Exporting tracked dataset..."),
    ("stage_start", "train",                88,  "Training gaussian avatar..."),
    ("stage_end",   "train",                95,  "Avatar trained"),
    ("stage_start", "render",               97,  "Rendering prediction..."),
    ("stage_end",   "render",              100,  "Prediction complete"),
)


def progress_of_events(events: list[dict]) -> tuple[int, str]:
    """Map an event-record list to (percent, status text)."""
    pct, status = 0, "Waiting..."
    for rec in events:
        ev = rec.get("event", "")
        stage = str(rec.get("stage", ""))
        for t_ev, t_stage, t_pct, t_status in STAGE_PROGRESS:
            if ev == t_ev and stage.startswith(t_stage) and t_pct > pct:
                pct, status = t_pct, t_status
    return pct, status


def read_progress(events_path: str | Path) -> tuple[int, str]:
    """(percent, status) from an events.jsonl file (missing file -> 0%)."""
    p = Path(events_path)
    if not p.exists():
        return 0, "Waiting..."
    records = []
    for line in p.read_text(encoding="utf-8").splitlines():
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return progress_of_events(records)
