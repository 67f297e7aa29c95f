"""Pipeline auto-continue: chain train -> render -> report when tracking ends.

Port of `omfs4d.pipeline.watch`.  Parity with the reference's log-polling
watcher (ref: continue_pipeline_when_track_finishes.ps1:24-107), but watching the
structured JSONL event stream instead of scraping a terminal log for an
`exit_code:` regex.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from omfs4d_torch.core.logging import get_logger

log = get_logger("watch")


def wait_for_event(events_path: Path, event: str, stage: str | None = None,
                   timeout: float = 24 * 3600, poll: float = 5.0) -> dict | None:
    """Tail an events.jsonl until a matching record appears."""
    deadline = time.time() + timeout
    offset = 0
    while time.time() < deadline:
        if events_path.exists():
            with open(events_path, "r", encoding="utf-8") as f:
                f.seek(offset)
                for line in f:
                    offset += len(line.encode("utf-8"))
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("event") == event and (
                        stage is None or rec.get("stage") == stage
                    ):
                        return rec
        time.sleep(poll)
    return None


def continue_when_track_finishes(
    workdir: Path,
    data_dir: Path,
    model_dir: Path,
    output_video: Path,
    lefort_mm: float,
    bsso_mm: float,
    deterministic_indices: list[int] | None = None,
    timeout: float = 24 * 3600,
    device=None,
) -> dict | None:
    """Block until the tracking stage completes, then run train -> render ->
    strict report (default deterministic indices match the reference's
    watcher, ref: continue_pipeline_when_track_finishes.ps1:12).  The stages
    run on `device`: None is the CUDA card, and raises when there is none."""
    from omfs4d_torch.core.config import Config
    from omfs4d_torch.pipeline.runner import Pipeline

    events_path = Path(workdir) / "events.jsonl"
    log.info(f"waiting for track completion in {events_path} …")
    rec = wait_for_event(events_path, "stage_end", stage="track", timeout=timeout)
    if rec is None:
        log.error("timed out waiting for tracking to finish")
        return None
    log.info(f"tracking finished in {rec.get('seconds', 0):.1f}s — continuing")

    if deterministic_indices is None:
        deterministic_indices = [0, 10, 20, 30, 40, 50, 60, 70, 80, 90]

    pipe = Pipeline(Config(), workdir, device=device)
    pipe.train(data_dir, model_dir)
    det_dir = Path(workdir) / "deterministic_frames"
    idx_file = Path(workdir) / "deterministic_indices.json"
    idx_file.write_text(json.dumps({"indices": deterministic_indices}))
    result = pipe.render_surgery(
        model_dir, data_dir, output_video, lefort_mm, bsso_mm,
        export_frames_dir=str(det_dir),
        deterministic_indices=str(idx_file),
    )
    report = pipe.report(model_dir, det_dir)
    return {"render": result, "report": report}
