"""GaussianAvatars-format dataset reader/writer — the L4 data contract.

Port of `omfs4d.io.dataset` (numpy; near verbatim).  Datasets written by
either package load in the other: the layout, npz keys and PNG pixels are
the same.

Layout (ref: preprocess_video.py:9-19, 200-426; SURVEY.md L4):

    data_dir/
      images/00000.png ...            RGB frames
      fg_masks/00000.png ...          optional foreground masks
      flame_param/00000.npz ...       per-frame FLAME params
      flame_param.npz                 batched params (shape (300,), expr (T,100), ...)
      canonical_flame_param.npz       neutral pose (loader-type trigger)
      points3d.ply                    init point cloud
      transforms_train.json / _test / _val / .json

This framework keeps the contract byte-compatible so datasets produced by
the reference pipeline load directly, and vice versa.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from omfs4d_torch.io.ply import load_ply, save_ply
from omfs4d_torch.io.video import read_image, write_image

PARAM_KEYS = ("shape", "expr", "rotation", "neck_pose", "jaw_pose",
              "eyes_pose", "translation", "static_offset", "dynamic_offset")


def default_flame_params(T: int, n_verts: int = 5143) -> dict:
    """Zero-filled batched parameter dict with the contract's shapes
    (ref padding rules: preprocess_video.py:311-333)."""
    return {
        "shape": np.zeros((300,), np.float32),
        "expr": np.zeros((T, 100), np.float32),
        "rotation": np.zeros((T, 3), np.float32),
        "neck_pose": np.zeros((T, 3), np.float32),
        "jaw_pose": np.zeros((T, 3), np.float32),
        "eyes_pose": np.zeros((T, 6), np.float32),
        "translation": np.zeros((T, 3), np.float32),
        "static_offset": np.zeros((1, n_verts, 3), np.float32),
        "dynamic_offset": np.zeros((T, n_verts, 3), np.float32),
    }


class FrameDataset:
    """In-memory view of one split of a dataset directory."""

    def __init__(self, data_dir, split: str = "train"):
        self.data_dir = Path(data_dir)
        self.split = split
        tpath = self.data_dir / f"transforms_{split}.json"
        if not tpath.exists():
            tpath = self.data_dir / "transforms.json"
        with open(tpath, "r", encoding="utf-8") as f:
            self.transforms = json.load(f)
        self.frames = self.transforms.get("frames", [])

        batched = self.data_dir / "flame_param.npz"
        self.flame_params = (
            {k: np.asarray(v) for k, v in np.load(batched).items()}
            if batched.exists() else None
        )
        canon = self.data_dir / "canonical_flame_param.npz"
        self.canonical_params = (
            {k: np.asarray(v) for k, v in np.load(canon).items()}
            if canon.exists() else None
        )

    def __len__(self) -> int:
        return len(self.frames)

    @property
    def intrinsics(self) -> dict:
        t = self.transforms
        return {k: t[k] for k in ("fl_x", "fl_y", "cx", "cy", "w", "h") if k in t}

    def frame_meta(self, i: int) -> dict:
        return self.frames[i]

    def load_image(self, i: int) -> np.ndarray:
        return read_image(self.data_dir / self.frames[i]["file_path"])

    def load_mask(self, i: int):
        rel = self.frames[i].get("fg_mask_path")
        if not rel:
            return None
        p = self.data_dir / rel
        if not p.exists():
            return None
        img = read_image(p)
        return img[..., 0].astype(np.float32) / 255.0

    def load_frame_params(self, i: int) -> dict:
        """Per-frame FLAME params: prefer the per-frame npz, fall back to a
        slice of the batched file (ref precedence: render_surgery.py:203-218)."""
        rel = self.frames[i].get("flame_param_path")
        if rel and (self.data_dir / rel).exists():
            return {k: np.asarray(v) for k, v in np.load(self.data_dir / rel).items()}
        ts = int(self.frames[i].get("timestep_index", i))
        out = {}
        for k, v in (self.flame_params or {}).items():
            if k == "shape" or (k == "static_offset" and v.ndim == 3 and v.shape[0] == 1):
                out[k] = v
            else:
                out[k] = v[ts : ts + 1]
        return out

    def camera(self, i: int, device="cpu"):
        from omfs4d_torch.ops.camera import camera_from_nerf

        fr = self.frames[i]
        intr = self.intrinsics
        w = int(fr.get("w", intr.get("w", 512)))
        h = int(fr.get("h", intr.get("h", 512)))
        fl_x = float(intr.get("fl_x", 0.0))
        if not fl_x:
            fov = float(fr.get("camera_angle_x", self.transforms.get("camera_angle_x")))
            fl_x = w / (2.0 * math.tan(fov / 2.0))
        fl_y = float(intr.get("fl_y", fl_x))
        cx = float(intr.get("cx", w / 2.0))
        cy = float(intr.get("cy", h / 2.0))
        return camera_from_nerf(np.asarray(fr["transform_matrix"]), fl_x, fl_y,
                                cx, cy, w, h, device=device)

    def points3d(self):
        p = self.data_dir / "points3d.ply"
        if not p.exists():
            return None
        v = load_ply(p)["vertex"]
        return np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)


def write_dataset(
    data_dir,
    images: np.ndarray,              # (T, H, W, 3) uint8/float
    c2w_nerf: np.ndarray,            # (T, 4, 4) NeRF-convention cam-to-world
    fl_x: float, fl_y: float, cx: float, cy: float,
    flame_params: dict | None = None,
    masks: np.ndarray | None = None,
    points3d: np.ndarray | None = None,
    train_fraction: float = 0.9,
    n_verts: int = 5143,
) -> Path:
    """Write a complete dataset directory in the contract format."""
    out = Path(data_dir)
    (out / "images").mkdir(parents=True, exist_ok=True)
    T, H, W = images.shape[:3]
    flame_params = flame_params or default_flame_params(T, n_verts)

    frames = []
    for i in range(T):
        write_image(out / "images" / f"{i:05d}.png", images[i])
        if masks is not None:
            (out / "fg_masks").mkdir(exist_ok=True)
            write_image(out / "fg_masks" / f"{i:05d}.png",
                        (np.asarray(masks[i]) * 255).astype(np.uint8))
        entry = {
            "file_path": f"images/{i:05d}.png",
            "flame_param_path": f"flame_param/{i:05d}.npz",
            "transform_matrix": np.asarray(c2w_nerf[i]).tolist(),
            "timestep_index": i,
            "camera_index": 0,
            "camera_angle_x": 2.0 * math.atan(W / (2.0 * fl_x)),
            "w": W,
            "h": H,
        }
        if masks is not None:
            entry["fg_mask_path"] = f"fg_masks/{i:05d}.png"
        frames.append(entry)

    # per-frame params
    (out / "flame_param").mkdir(exist_ok=True)
    for i in range(T):
        per = {}
        for k, v in flame_params.items():
            if k == "shape":
                per[k] = v
            elif k == "static_offset":
                per[k] = v
            else:
                per[k] = v[i : i + 1]
        np.savez(out / "flame_param" / f"{i:05d}.npz", **per)

    np.savez(out / "flame_param.npz", **flame_params)

    canonical = default_flame_params(1, n_verts)
    canonical["shape"] = flame_params["shape"]
    canonical["static_offset"] = flame_params.get(
        "static_offset", canonical["static_offset"]
    )
    np.savez(out / "canonical_flame_param.npz", **canonical)

    if points3d is not None:
        save_ply(out / "points3d.ply", points3d)

    meta = {
        "camera_angle_x": 2.0 * math.atan(W / (2.0 * fl_x)),
        "camera_angle_y": 2.0 * math.atan(H / (2.0 * fl_y)),
        "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy, "w": W, "h": H,
        "timestep_indices": list(range(T)),
        "camera_indices": [0],
    }
    if train_fraction >= 1.0:
        split_idx = T
    elif train_fraction == 0.9:
        # reference's exact 90/10 rule (preprocess_video.py:403-406)
        split_idx = max(1, T - T // 10)
    else:
        split_idx = max(1, int(T * train_fraction))

    with open(out / "transforms_train.json", "w") as f:
        json.dump({**meta, "frames": frames[:split_idx]}, f, indent=2)
    test_payload = {**meta, "frames": frames[split_idx:] or frames[-1:]}
    with open(out / "transforms_test.json", "w") as f:
        json.dump(test_payload, f, indent=2)
    with open(out / "transforms_val.json", "w") as f:
        json.dump(test_payload, f, indent=2)
    with open(out / "transforms.json", "w") as f:
        json.dump({**meta, "frames": frames}, f, indent=2)
    return out
