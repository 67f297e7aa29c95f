"""Runtime preflight gates for detected landmarks and foreground masks.

Port of `omfs4d.track.preflight` (NumPy only; the port's own copy).  A real
capture can fail in ways no synthetic test family anticipates (lighting,
compression, a face the detector never saw), and a silently bad landmark or
mask set poisons everything downstream: the tracker converges to garbage and
the avatar trains on a broken dataset.

This module scores a detector's outputs on the actual input frames, with
signals that need no ground truth:

  landmarks: valid-frame fraction, in-bounds fraction, per-frame landmark
  spread (a soft-argmax detector collapsing to the heatmap center shows
  near-zero spread), and temporal jitter (faces move smoothly at video rate;
  frame-to-frame median displacement beyond ~10% of the image diagonal is
  detector noise, not motion);

  masks: foreground-area fraction bounds (all-background / all-foreground
  classifications), per-frame sanity rate, and temporal IoU stability (a
  static-camera capture's foreground overlaps heavily across adjacent
  frames).

A caller falls back to another landmark or mask source, with a warning
event, when a report is not ok.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PreflightReport(NamedTuple):
    ok: bool
    reasons: tuple[str, ...]
    stats: dict

    def asdict(self) -> dict:
        return {"ok": self.ok, "reasons": list(self.reasons),
                **{k: float(v) for k, v in self.stats.items()}}


def landmark_preflight(
    lmk: np.ndarray,
    valid: np.ndarray,
    width: int,
    height: int,
    min_valid_frac: float = 0.5,
    min_inbounds_frac: float = 0.9,
    min_spread_frac: float = 0.02,
    max_jitter_frac: float = 0.10,
) -> PreflightReport:
    """Sanity-score (T, L, 2) pixel landmarks + (T,) validity flags."""
    lmk = np.asarray(lmk, np.float32)
    valid = np.asarray(valid, bool)
    T = len(valid)
    diag = float(np.hypot(width, height))
    reasons: list[str] = []

    valid_frac = float(valid.mean()) if T else 0.0
    if valid_frac < min_valid_frac:
        reasons.append(
            f"valid-frame fraction {valid_frac:.2f} < {min_valid_frac}")

    lv = lmk[valid] if valid.any() else np.zeros((0,) + lmk.shape[1:],
                                                 np.float32)
    if len(lv):
        margin = 0.05
        inb = ((lv[..., 0] >= -margin * width)
               & (lv[..., 0] <= (1 + margin) * width)
               & (lv[..., 1] >= -margin * height)
               & (lv[..., 1] <= (1 + margin) * height))
        inbounds_frac = float(inb.mean())
        # per-frame landmark cloud extent: a collapsed detector (every
        # landmark at the same soft-argmax attractor) has ~zero spread
        ext = lv.max(axis=1) - lv.min(axis=1)            # (Tv, 2)
        spread_frac = float(np.median(np.hypot(ext[:, 0], ext[:, 1])) / diag)
    else:
        inbounds_frac = 0.0
        spread_frac = 0.0
    if inbounds_frac < min_inbounds_frac:
        reasons.append(
            f"in-bounds landmark fraction {inbounds_frac:.2f} "
            f"< {min_inbounds_frac}")
    if spread_frac < min_spread_frac:
        reasons.append(
            f"landmark spread {spread_frac:.3f} of image diag "
            f"< {min_spread_frac} (detector collapse)")

    # jitter over consecutive valid-valid frame pairs only
    jitter_frac = 0.0
    if T >= 2:
        pair = valid[:-1] & valid[1:]
        if pair.any():
            d = np.linalg.norm(lmk[1:][pair] - lmk[:-1][pair], axis=-1)
            jitter_frac = float(np.median(d.mean(axis=1)) / diag)
            if jitter_frac > max_jitter_frac:
                reasons.append(
                    f"temporal jitter {jitter_frac:.3f} of image diag "
                    f"> {max_jitter_frac}")

    stats = {"valid_frac": valid_frac, "inbounds_frac": inbounds_frac,
             "spread_frac": spread_frac, "jitter_frac": jitter_frac}
    return PreflightReport(not reasons, tuple(reasons), stats)


def mask_preflight(
    masks: np.ndarray,
    min_area: float = 0.02,
    max_area: float = 0.97,
    min_sane_frac: float = 0.8,
    min_temporal_iou: float = 0.5,
) -> PreflightReport:
    """Sanity-score (T, H, W) float foreground masks."""
    m = np.asarray(masks, np.float32) > 0.5
    T = len(m)
    reasons: list[str] = []

    area = m.mean(axis=(1, 2)) if T else np.zeros(0)
    mean_area = float(area.mean()) if T else 0.0
    if not (min_area <= mean_area <= max_area):
        reasons.append(
            f"mean foreground area {mean_area:.3f} outside "
            f"[{min_area}, {max_area}]")
    sane_frac = (float(((area > 0.01) & (area < 0.99)).mean()) if T else 0.0)
    if sane_frac < min_sane_frac:
        reasons.append(
            f"only {sane_frac:.2f} of frames have a plausible foreground "
            f"area (>= {min_sane_frac} required)")

    temporal_iou = 1.0
    if T >= 2:
        inter = np.logical_and(m[1:], m[:-1]).sum(axis=(1, 2))
        union = np.logical_or(m[1:], m[:-1]).sum(axis=(1, 2))
        temporal_iou = float(np.median(inter / np.maximum(union, 1)))
        if temporal_iou < min_temporal_iou:
            reasons.append(
                f"median frame-to-frame mask IoU {temporal_iou:.2f} "
                f"< {min_temporal_iou}")

    stats = {"mean_area": mean_area, "sane_frac": sane_frac,
             "temporal_iou": temporal_iou}
    return PreflightReport(not reasons, tuple(reasons), stats)
