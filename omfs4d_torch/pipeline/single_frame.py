"""Single-frame overfit experiment: the end-to-end sanity harness of training.

Port of `omfs4d.pipeline.single_frame`: carve a 1-frame dataset out of an
existing dataset, train an avatar on it, render the same pose, and save a
GT/render PNG pair and the PSNR.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

from omfs4d_torch.core.logging import get_logger
from omfs4d_torch.io.dataset import FrameDataset
from omfs4d_torch.io.video import write_image
from omfs4d_torch.models.flame import FlameModel, flame_forward
from omfs4d_torch.train.losses import psnr
from omfs4d_torch.train.trainer import AvatarTrainer

log = get_logger("single_frame")


def build_single_frame_dataset(data_dir: str | Path, out_dir: str | Path,
                               frame_index: int = 0) -> Path:
    """Copy one frame's worth of dataset into `out_dir` (contract format)."""
    src = Path(data_dir)
    out = Path(out_dir)
    (out / "images").mkdir(parents=True, exist_ok=True)
    ds = FrameDataset(src, split="train")
    meta = dict(ds.frame_meta(frame_index))

    img_name = Path(meta["file_path"]).name
    shutil.copy2(src / meta["file_path"], out / "images" / img_name)
    meta["file_path"] = f"images/{img_name}"

    if meta.get("fg_mask_path"):
        (out / "fg_masks").mkdir(exist_ok=True)
        mask_name = Path(meta["fg_mask_path"]).name
        shutil.copy2(src / meta["fg_mask_path"], out / "fg_masks" / mask_name)
        meta["fg_mask_path"] = f"fg_masks/{mask_name}"

    (out / "flame_param").mkdir(exist_ok=True)
    params = ds.load_frame_params(frame_index)
    np.savez(out / "flame_param" / "00000.npz", **params)
    meta["flame_param_path"] = "flame_param/00000.npz"
    meta["timestep_index"] = 0

    np.savez(out / "flame_param.npz", **params)
    for extra in ("canonical_flame_param.npz", "points3d.ply"):
        if (src / extra).exists():
            shutil.copy2(src / extra, out / extra)

    payload = {k: v for k, v in ds.transforms.items() if k != "frames"}
    payload["frames"] = [meta]
    payload["timestep_indices"] = [0]
    for name in ("transforms_train.json", "transforms_test.json",
                 "transforms_val.json", "transforms.json"):
        with open(out / name, "w") as f:
            json.dump(payload, f, indent=2)
    return out


def run_single_frame_experiment(
    data_dir: str | Path,
    flame_model: FlameModel,
    out_dir: str | Path,
    iterations: int = 3000,
    frame_index: int = 0,
    **trainer_kw,
) -> dict:
    """1-frame overfit: train -> render -> save GT/render pair + PSNR.  Runs
    on the FLAME model's device; `trainer_kw` go to `AvatarTrainer`."""
    from omfs4d_torch.core.config import TrainConfig

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    sf_data = build_single_frame_dataset(data_dir, out / "dataset", frame_index)
    dev = flame_model.v_template.device

    ds = FrameDataset(sf_data, split="train")
    img = ds.load_image(0)
    H, W = img.shape[:2]
    cam = ds.camera(0, device=dev)
    params = {k: v for k, v in ds.load_frame_params(0).items() if k != "dynamic_offset"}
    with torch.no_grad():
        verts = flame_forward(flame_model, params)[0]

    cfg = TrainConfig(iterations=iterations, opacity_reset_interval=0,
                      max_gaussians=50_000)
    trainer = AvatarTrainer(flame_model.faces.cpu().numpy(), cfg, W, H,
                            device=dev, **trainer_kw)
    data = {
        "images": img[None],
        "verts": verts[None],
        "w2c": cam.w2c[None],
        "fx": cam.fx[None], "fy": cam.fy[None],
        "cx": cam.cx[None], "cy": cam.cy[None],
    }
    state = trainer.train(data, output_dir=out / "model")

    render = trainer.render_frame(state, verts, cam)
    gt = torch.as_tensor(img, dtype=torch.float32, device=dev) / 255.0
    score = float(psnr(render, gt))
    write_image(out / "single_frame_gt.png", img)
    write_image(out / "single_frame_render.png", render.cpu().numpy())
    log.info(f"single-frame overfit PSNR: {score:.2f} dB")
    return {"psnr": score, "gt": str(out / "single_frame_gt.png"),
            "render": str(out / "single_frame_render.png")}
