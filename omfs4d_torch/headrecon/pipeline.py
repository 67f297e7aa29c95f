"""Multi-sequence full-head reconstruction.

Port of `omfs4d.headrecon.pipeline`: host NumPy, carried across as written;
`fit_shared_shape` drives this package's `FlameTracker`.  It covers the
surface of the reference's head_recon package (ref:
02_Visual_Engine/head_recon/*.py — a placeholder scaffold there) and
promotes it to a working multi-sequence path:

  * `ingest_sequences`      — probe a capture root, write a manifest
  * `register_sequences`    — REAL rigid registration between sequences
                              from their tracked FLAME head poses
                              (identity fallback when no tracking exists)
  * `fit_shared_shape`      — joint FLAME identity across sequences: one
                              shared shape vector, per-sequence frame params
  * `build_canonical_head`  — canonical asset npz consumed by the
                              hybrid_full_head rig mode (ref:
                              render_surgery.py:74-85)
  * `evaluate_head_coverage`/`evaluate_multi_coverage` — temporal-bucket
                              coverage, per sequence and merged
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from omfs4d_torch.core.logging import get_logger
from omfs4d_torch.eval.reporting import bucket

log = get_logger("head_recon")

_IMAGE_SUFFIXES = frozenset({".jpg", ".jpeg", ".png"})


def _probe_sequence(seq_dir: Path) -> dict | None:
    """Inspect one candidate sequence directory.

    A directory qualifies if it carries a train-split transforms file or an
    images/ folder.  Frame count prefers the transforms file (the dataset
    contract's source of truth) over a raw image-file census.
    """
    transforms = seq_dir / "transforms_train.json"
    images = seq_dir / "images"
    has_transforms = transforms.is_file()
    image_count = 0
    if images.is_dir():
        image_count = sum(
            1 for p in images.iterdir() if p.suffix.lower() in _IMAGE_SUFFIXES
        )
    if not has_transforms and image_count == 0 and not images.is_dir():
        return None
    record = {
        "name": seq_dir.name,
        "path": str(seq_dir.resolve()),
        "transforms_train": str(transforms.resolve()) if has_transforms else "",
        "image_count": image_count,
        "tracked": (seq_dir / "flame_param.npz").is_file(),
    }
    if has_transforms:
        try:
            payload = json.loads(transforms.read_text(encoding="utf-8"))
            record["frame_count"] = len(payload.get("frames", []))
        except (json.JSONDecodeError, OSError):
            record["frame_count"] = image_count
    else:
        record["frame_count"] = image_count
    return record


def ingest_sequences(capture_root: Path, output_dir: Path) -> Path:
    """Scan a capture root for sequence dirs; write sequence_manifest.json."""
    capture_root = Path(capture_root)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    candidates = sorted(
        (d for d in capture_root.iterdir() if d.is_dir()),
        key=lambda d: d.name,
    )
    records = list(filter(None, map(_probe_sequence, candidates)))

    out_path = output_dir / "sequence_manifest.json"
    out_path.write_text(
        json.dumps(
            {
                "capture_root": str(capture_root.resolve()),
                "sequence_count": len(records),
                "sequences": records,
            },
            indent=2,
        ),
        encoding="utf-8",
    )
    log.info(f"sequence manifest ({len(records)} sequences): {out_path}")
    return out_path


# ── rigid registration from tracked head poses ───────────────────────────


def _aa_to_matrix(aa: np.ndarray) -> np.ndarray:
    """Axis-angle -> rotation matrix (numpy Rodrigues; host-side tool)."""
    theta = float(np.linalg.norm(aa))
    if theta < 1e-12:
        return np.eye(3)
    k = np.asarray(aa, np.float64) / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def _head_pose(seq_dir: Path) -> tuple[np.ndarray, np.ndarray] | None:
    """(R, t) of the head in frame 0 of a tracked sequence, else None."""
    params_file = Path(seq_dir) / "flame_param.npz"
    if not params_file.is_file():
        return None
    with np.load(params_file) as z:
        if "rotation" not in z or "translation" not in z:
            return None
        rot = np.atleast_2d(z["rotation"])[0]
        trans = np.atleast_2d(z["translation"])[0]
    return _aa_to_matrix(rot), np.asarray(trans, np.float64)


def register_sequences(manifest_path: Path, output_dir: Path) -> Path:
    """Registration table mapping every sequence into the canonical frame.

    The first sequence is canonical.  For tracked sequences the transform is
    computed from FLAME head poses: both captures see the same rigid head, so
    the camera-frame-k -> canonical-camera-frame map is
    ``T_canon @ inv(T_k)`` with ``T = [R|t]`` of the frame-0 head pose.
    Untracked sequences fall back to identity with residual -1 (unknown).
    """
    manifest_path = Path(manifest_path)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    manifest = json.loads(manifest_path.read_text(encoding="utf-8"))
    sequences = manifest.get("sequences", [])

    canon_pose = _head_pose(Path(sequences[0]["path"])) if sequences else None

    rows = []
    for i, seq in enumerate(sequences):
        transform = np.eye(4)
        residual = -1.0
        if i == 0:
            residual = 0.0
        elif canon_pose is not None:
            pose_k = _head_pose(Path(seq["path"]))
            if pose_k is not None:
                R0, t0 = canon_pose
                Rk, tk = pose_k
                R_rel = R0 @ Rk.T
                t_rel = t0 - R_rel @ tk
                transform[:3, :3] = R_rel
                transform[:3, 3] = t_rel
                # residual: how far the relative rotation is from aligning
                # the two poses exactly (0 by construction up to fp error)
                residual = float(
                    np.linalg.norm(R_rel @ Rk - R0) + np.linalg.norm(
                        (R_rel @ tk + t_rel) - t0)
                )
        rows.append({
            "name": seq["name"],
            "canonical": i == 0,
            "transform": transform.tolist(),
            "residual": residual,
        })

    out_path = output_dir / "registration_table.json"
    out_path.write_text(json.dumps({"registrations": rows}, indent=2),
                        encoding="utf-8")
    log.info(f"registration table: {out_path}")
    return out_path


# ── shared-identity fitting across sequences ─────────────────────────────


def fit_shared_shape(
    tracker,
    sequence_landmarks: list[tuple[np.ndarray, np.ndarray]],
    frames: list[np.ndarray] | None = None,
) -> tuple[np.ndarray, list[dict]]:
    """Fit ONE FLAME identity (shape vector) jointly over several sequences.

    The tracker already optimizes a single global ``shape`` over its whole
    batch, so multi-sequence identity fusion is exactly a concatenation of
    the sequences' T axes followed by one staged fit; the result is split
    back into per-sequence parameter sets.

    Args:
      tracker: an ``omfs4d_torch.track.fitter.FlameTracker`` (same camera
        for all sequences — monocular capture rig).
      sequence_landmarks: per sequence, ``(landmarks (T,L,2), valid (T,))``.
      frames: optional per-sequence RGB stacks for photometric stages.

    Returns:
      (shared shape (300,), per-sequence dataset-contract param dicts).
    """
    lengths = [lmk.shape[0] for lmk, _ in sequence_landmarks]
    lmk_all = np.concatenate([lmk for lmk, _ in sequence_landmarks], axis=0)
    valid_all = np.concatenate([v for _, v in sequence_landmarks], axis=0)
    frames_all = (np.concatenate(frames, axis=0)
                  if frames is not None else None)

    result = tracker.fit(lmk_all, valid_all, frames=frames_all)
    params = result.params

    per_seq: list[dict] = []
    offset = 0
    for n in lengths:
        sl = slice(offset, offset + n)
        seq_params = {}
        for k, v in params.items():
            if k in ("shape", "static_offset"):
                seq_params[k] = v
            else:
                seq_params[k] = v[sl]
        per_seq.append(seq_params)
        offset += n
    return params["shape"], per_seq


def build_canonical_head(registration_path: Path, output_path: Path,
                         flame_shape: np.ndarray | None = None) -> Path:
    """Canonical head asset npz (consumed by the hybrid_full_head rig mode,
    ref: render_surgery.py:74-85).  Carries the shared identity and the
    per-sequence registration transforms."""
    registration_path = Path(registration_path)
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    table = json.loads(registration_path.read_text(encoding="utf-8"))
    regs = table.get("registrations", [])
    np.savez(
        output_path,
        version=np.array([2]),
        n_sequences=np.array([len(regs)]),
        shape=(np.asarray(flame_shape, np.float32)
               if flame_shape is not None else np.zeros(300, np.float32)),
        transforms=np.stack(
            [np.asarray(r["transform"], np.float32) for r in regs]
        ) if regs else np.zeros((0, 4, 4), np.float32),
        names=np.array([r["name"] for r in regs]),
    )
    log.info(f"canonical head asset: {output_path}")
    return output_path


# ── coverage reporting ───────────────────────────────────────────────────


def _bucket_census(n_frames: int) -> dict:
    counts = {"front": 0, "profile": 0, "rear": 0}
    span = max(1, n_frames - 1)
    for i in range(n_frames):
        counts[bucket(i / span)] += 1
    return counts


def evaluate_head_coverage(data_dir: Path, output_dir: Path) -> dict:
    """Temporal-bucket coverage report over one dataset's train split."""
    data_dir = Path(data_dir)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    payload = json.loads(
        (data_dir / "transforms_train.json").read_text(encoding="utf-8"))
    n = len(payload.get("frames", []))
    counts = _bucket_census(n)
    report = {
        "total_frames": n,
        "buckets": counts,
        "covered": {k: v > 0 for k, v in counts.items()},
    }
    out_path = output_dir / "head_coverage_report.json"
    out_path.write_text(json.dumps(report, indent=2), encoding="utf-8")
    log.info(f"head coverage report: {out_path}")
    return report


def evaluate_multi_coverage(manifest_path: Path, output_dir: Path) -> dict:
    """Merged coverage over every sequence in a manifest: a view bucket is
    covered if ANY registered sequence covers it."""
    manifest_path = Path(manifest_path)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    manifest = json.loads(manifest_path.read_text(encoding="utf-8"))

    per_seq = {}
    merged = {"front": 0, "profile": 0, "rear": 0}
    for seq in manifest.get("sequences", []):
        counts = _bucket_census(int(seq.get("frame_count", 0)))
        per_seq[seq["name"]] = counts
        for k, v in counts.items():
            merged[k] += v
    report = {
        "sequence_count": len(per_seq),
        "per_sequence": per_seq,
        "merged_buckets": merged,
        "covered": {k: v > 0 for k, v in merged.items()},
    }
    out_path = output_dir / "multi_coverage_report.json"
    out_path.write_text(json.dumps(report, indent=2), encoding="utf-8")
    log.info(f"multi-sequence coverage report: {out_path}")
    return report
