"""Surgical plan -> FLAME parameter mapping (the surgery->pixels bridge).

Behavioral parity with the reference's render_surgery.py:35-242:

  * `compute_offset`: mm * sensitivity * 0.001 (SCALE_FACTOR)
  * Le Fort I advancement -> translation[trans_axis] += offset
    BSSO advancement     -> jaw_pose[jaw_axis]   += offset
    (axes/scales overridable by a deformation-map JSON, used by the
    hybrid_full_head rig mode)
  * `create_modified_dataset` builds a temp dataset: symlinked images,
    per-frame + batched params rewritten, canonical npz + points3d copied,
    transforms pointed at the per-frame files.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any

import numpy as np

SCALE_FACTOR = 0.001  # mm -> FLAME internal units


def compute_offset(input_mm: float, sensitivity: float) -> float:
    """Convert clinical mm to FLAME-space offset."""
    return input_mm * sensitivity * SCALE_FACTOR


def load_deformation_map(path: str | None) -> dict[str, Any]:
    """Optional region-aware deformation controls from a JSON file.

    Returns {} when no path is given (behavioral contract with the
    reference's deformation-map flag, render_surgery.py:60-71)."""
    if not path:
        return {}
    payload = json.loads(Path(path).read_text(encoding="utf-8"))
    if not isinstance(payload, dict):
        raise ValueError(
            f"deformation map {path!r}: expected a top-level JSON object, "
            f"got {type(payload).__name__}")
    return payload


def choose_rig_mode(requested_mode: str,
                    canonical_head_asset: str | None) -> tuple[str, str]:
    """Resolve the effective rig mode, falling back gracefully.

    hybrid_full_head needs the canonical head asset on disk; without it the
    prediction still renders in flame_only mode (contract:
    render_surgery.py:74-85).  Returns (mode, reason)."""
    have_asset = bool(canonical_head_asset
                      and Path(canonical_head_asset).exists())
    if requested_mode == "flame_only":
        return "flame_only", "flame_only explicitly requested"
    if not have_asset:
        return "flame_only", ("falling back: hybrid_full_head needs a "
                              "canonical head asset, but it is missing")
    return "hybrid_full_head", "canonical head asset present"


def apply_surgical_offsets(
    params: dict,
    lefort_offset: float,
    bsso_offset: float,
    deformation_map: dict[str, Any] | None = None,
) -> dict:
    """Pure-array version of the parameter surgery (works on 1-D and batched
    forms).  Does not mutate the input."""
    deformation_map = deformation_map or {}
    trans_axis = int(deformation_map.get("translation_axis", 1))
    jaw_axis = int(deformation_map.get("jaw_axis", 0))
    lefort_scale = float(deformation_map.get("lefort_scale", 1.0))
    bsso_scale = float(deformation_map.get("bsso_scale", 1.0))

    out = dict(params)
    if "translation" in out:
        trans = np.array(out["translation"], copy=True)
        if trans.ndim == 1:
            trans[trans_axis] += lefort_offset * lefort_scale
        else:
            trans[:, trans_axis] += lefort_offset * lefort_scale
        out["translation"] = trans
    if "jaw_pose" in out:
        jaw = np.array(out["jaw_pose"], copy=True)
        if jaw.ndim == 1:
            jaw[jaw_axis] += bsso_offset * bsso_scale
        else:
            jaw[:, jaw_axis] += bsso_offset * bsso_scale
        out["jaw_pose"] = jaw
    return out


def modify_flame_params(
    source_npz: str,
    output_npz: str,
    lefort_offset: float,
    bsso_offset: float,
    deformation_map: dict[str, Any] | None = None,
) -> None:
    """npz -> npz surgical modification (file-level contract)."""
    data = dict(np.load(source_npz, allow_pickle=True))
    out = apply_surgical_offsets(data, lefort_offset, bsso_offset, deformation_map)
    np.savez(output_npz, **out)


def create_modified_dataset(
    data_dir: str,
    lefort_offset: float,
    bsso_offset: float,
    deformation_map: dict[str, Any] | None = None,
    refined_params: str | None = None,
) -> str:
    """Temp dataset with surgically modified FLAME params.

    Mirrors the reference's structure handling (render_surgery.py:144-242):
    images symlinked, per-frame + batched npz rewritten, canonical asset +
    points3d copied, transforms updated to point at per-frame params.

    `refined_params`: path to a batched npz of FLAME params co-optimized
    during avatar training (model_dir/flame_param_refined.npz).  When
    given, those replace the dataset's tracked params as the base the
    surgical offsets apply to — the avatar was optimized against the
    refined poses, so rendering with the originals reintroduces exactly
    the per-frame tracking error co-optimization absorbed.
    """
    temp_dir = tempfile.mkdtemp(prefix="surgical_render_")

    src_images = os.path.join(data_dir, "images")
    dst_images = os.path.join(temp_dir, "images")
    if os.path.isdir(src_images):
        try:
            os.symlink(os.path.abspath(src_images), dst_images,
                       target_is_directory=True)
        except (OSError, NotImplementedError):
            shutil.copytree(src_images, dst_images)

    for extra in ("fg_masks",):
        src = os.path.join(data_dir, extra)
        dst = os.path.join(temp_dir, extra)
        if os.path.isdir(src):
            try:
                os.symlink(os.path.abspath(src), dst, target_is_directory=True)
            except (OSError, NotImplementedError):
                shutil.copytree(src, dst)

    src_flame_params = os.path.join(data_dir, "flame_param")
    dst_flame_params = os.path.join(temp_dir, "flame_param")
    if refined_params is not None and os.path.exists(refined_params):
        ref = {k: np.asarray(v) for k, v in np.load(refined_params).items()}
        os.makedirs(dst_flame_params, exist_ok=True)
        T = ref["expr"].shape[0]
        for i in range(T):
            per = {
                k: (v if k == "shape"
                    or (v.ndim == 3 and v.shape[0] == 1) else v[i:i + 1])
                for k, v in ref.items()
            }
            base = os.path.join(dst_flame_params, f"{i:05d}.base.npz")
            np.savez(base, **per)
            modify_flame_params(
                base, os.path.join(dst_flame_params, f"{i:05d}.npz"),
                lefort_offset, bsso_offset, deformation_map=deformation_map,
            )
            os.remove(base)
        base = os.path.join(temp_dir, "flame_param.base.npz")
        np.savez(base, **ref)
        modify_flame_params(
            base, os.path.join(temp_dir, "flame_param.npz"),
            lefort_offset, bsso_offset, deformation_map=deformation_map,
        )
        os.remove(base)
    else:
        if os.path.isdir(src_flame_params):
            os.makedirs(dst_flame_params, exist_ok=True)
            for fname in os.listdir(src_flame_params):
                if fname.endswith(".npz"):
                    modify_flame_params(
                        os.path.join(src_flame_params, fname),
                        os.path.join(dst_flame_params, fname),
                        lefort_offset, bsso_offset,
                        deformation_map=deformation_map,
                    )

        src_flame = os.path.join(data_dir, "flame_param.npz")
        if os.path.exists(src_flame):
            modify_flame_params(
                src_flame, os.path.join(temp_dir, "flame_param.npz"),
                lefort_offset, bsso_offset, deformation_map=deformation_map,
            )

    for fname in ("points3d.ply", "canonical_flame_param.npz"):
        src = os.path.join(data_dir, fname)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(temp_dir, fname))

    for json_name in ("transforms_train.json", "transforms_test.json",
                      "transforms_val.json", "transforms.json"):
        src_json = os.path.join(data_dir, json_name)
        if not os.path.exists(src_json):
            continue
        with open(src_json, "r") as f:
            transforms = json.load(f)
        for frame in transforms.get("frames", []):
            timestep = frame.get("timestep_index", 0)
            individual = f"flame_param/{timestep:05d}.npz"
            if os.path.exists(os.path.join(temp_dir, individual)):
                frame["flame_param_path"] = individual
        with open(os.path.join(temp_dir, json_name), "w") as f:
            json.dump(transforms, f, indent=2)

    return temp_dir


def export_deterministic_frames(
    frames_dir: str,
    output_dir: str,
    index_file: str | None = None,
    max_frames: int = 24,
) -> str:
    """Deterministic frame-subset export + manifest for strict A/B eval
    (parity: render_surgery.py:365-409)."""
    os.makedirs(output_dir, exist_ok=True)
    frames = sorted(f for f in os.listdir(frames_dir) if f.endswith(".png"))
    if not frames:
        raise FileNotFoundError(f"No PNG frames in {frames_dir}")

    if index_file:
        with open(index_file, "r", encoding="utf-8") as f:
            payload = json.load(f)
        indices = payload.get("indices", payload)
        if not isinstance(indices, list) or not all(isinstance(i, int) for i in indices):
            raise ValueError(
                "index_file must contain a JSON list of frame indices or "
                "{'indices': [...]}"
            )
        selected = [i for i in indices if 0 <= i < len(frames)]
    else:
        sample_count = max(1, min(max_frames, len(frames)))
        if sample_count == 1:
            selected = [0]
        else:
            selected = sorted(set(
                int(round(i * (len(frames) - 1) / (sample_count - 1)))
                for i in range(sample_count)
            ))

    manifest = {"source_frames_dir": frames_dir, "selected_indices": selected,
                "exports": []}
    for i in selected:
        src_name = frames[i]
        dst_name = f"idx_{i:05d}.png"
        shutil.copy2(os.path.join(frames_dir, src_name),
                     os.path.join(output_dir, dst_name))
        manifest["exports"].append(
            {"index": i, "source": src_name, "exported": dst_name}
        )

    with open(os.path.join(output_dir, "deterministic_indices_manifest.json"),
              "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2)
    return output_dir
