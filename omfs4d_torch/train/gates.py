"""Pre-train dataset quality gates (port of `omfs4d.train.gates`; pure
Python, carried across verbatim)."""

from __future__ import annotations

import json
from pathlib import Path

from omfs4d_torch.core.logging import get_logger

log = get_logger("train")


class QualityGateError(RuntimeError):
    pass


def run_quality_gates(data_dir: str | Path, min_frames: int = 50) -> dict:
    """Fail fast on bad datasets:
      * >= `min_frames` training frames
      * timeline gaps <= max(10, N/10)
      * fg masks (when present) >= N/2
    """
    data_path = Path(data_dir)
    train_json = data_path / "transforms_train.json"
    with open(train_json, "r", encoding="utf-8") as f:
        train_data = json.load(f)
    frames = train_data.get("frames", [])
    if len(frames) < min_frames:
        raise QualityGateError(
            f"Quality gate failed: only {len(frames)} training frames; "
            f"need at least {min_frames}."
        )

    timestep_indices = [int(fr.get("timestep_index", i)) for i, fr in enumerate(frames)]
    gaps = sum(
        1 for i in range(1, len(timestep_indices))
        if (timestep_indices[i] - timestep_indices[i - 1]) > 1
    )
    if gaps > max(10, len(timestep_indices) // 10):
        raise QualityGateError(
            f"Quality gate failed: too many timeline gaps in train split ({gaps})."
        )

    masks_dir = data_path / "fg_masks"
    n_masks = None
    if masks_dir.exists():
        n_masks = len([f for f in masks_dir.iterdir() if f.suffix.lower() == ".png"])
        if n_masks < len(frames) // 2:
            raise QualityGateError(
                f"Quality gate failed: only {n_masks} fg masks for "
                f"{len(frames)} train frames."
            )

    log.info(f"Quality gates passed: frames={len(frames)}, timeline_gaps={gaps}")
    return {"frames": len(frames), "timeline_gaps": gaps, "fg_masks": n_masks}
