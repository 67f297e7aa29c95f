"""Synthetic ground-truth scenes and datasets (tests + benchmarks).

Port of `omfs4d.io.synthetic`: a procedurally textured head avatar
(gaussians on the synthetic FLAME mesh), an orbiting camera and an animated
jaw, rendered by this package's own rasterizer into a contract-format
dataset.  Everything comes from seeds; no licensed data is needed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from omfs4d_torch.io.dataset import default_flame_params, write_dataset
from omfs4d_torch.models.assets import synthetic_flame_asset
from omfs4d_torch.models.flame import FlameModel, flame_forward
from omfs4d_torch.models.gaussians import GaussianAvatar, init_gaussians_on_mesh
from omfs4d_torch.ops.camera import camera_from_nerf
from omfs4d_torch.render.rasterize import render_avatar_frame


def textured_gt_avatar(model: FlameModel, capacity: int | None = None,
                       seed: int = 0) -> GaussianAvatar:
    """Gaussians on every face with a smooth position-based 'texture', on
    the model's device."""
    faces = model.faces.cpu().numpy()
    capacity = capacity or len(faces)
    g = init_gaussians_on_mesh(faces, capacity, init_opacity=0.95,
                               init_scale=0.6, seed=seed,
                               device=model.v_template.device)
    verts = model.v_template.cpu().numpy()
    centers = verts[faces[g.parent_face.cpu().numpy()]].mean(axis=1)
    # smooth rainbow texture from position
    c = np.stack([
        0.5 + 0.45 * np.sin(centers[:, 0] * 40.0),
        0.5 + 0.45 * np.sin(centers[:, 1] * 40.0 + 2.0),
        0.5 + 0.45 * np.cos(centers[:, 2] * 40.0 + 4.0),
    ], axis=1)
    c = np.clip(c, 0.02, 0.98)
    with torch.no_grad():
        g.color.copy_(torch.from_numpy(np.log(c / (1 - c)).astype(np.float32)))
    return g


def orbit_c2w_nerf(T: int, radius: float = 0.6, height: float = 0.0,
                   center=(0.0, 0.0, 0.0), sweep_deg: float = 60.0) -> np.ndarray:
    """NeRF-convention camera-to-world orbit around the head (z-forward
    face).  Cameras sweep +-sweep/2 degrees around the front of the face."""
    center = np.asarray(center, dtype=np.float64)
    out = np.zeros((T, 4, 4))
    angles = np.radians(np.linspace(-sweep_deg / 2, sweep_deg / 2, T))
    for i, a in enumerate(angles):
        eye = center + np.array([radius * np.sin(a), height, radius * np.cos(a)])
        fwd = center - eye
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        # NeRF/OpenGL: columns = [right, up, -forward], position
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = true_up
        c2w[:3, 2] = -fwd
        c2w[:3, 3] = eye
        out[i] = c2w
    return out


def animated_flame_params(T: int, n_verts: int, jaw_amp: float = 0.15,
                          yaw_amp: float = 0.1, seed: int = 0) -> dict:
    p = default_flame_params(T, n_verts)
    t = np.linspace(0, 2 * np.pi, T, endpoint=False)
    p["jaw_pose"][:, 0] = jaw_amp * (0.5 - 0.5 * np.cos(t))        # opens/closes
    p["rotation"][:, 1] = yaw_amp * np.sin(t * 0.5)
    rng = np.random.default_rng(seed)
    p["expr"][:, :4] = 0.3 * rng.normal(size=(T, 4)).astype(np.float32)
    return p


def make_synthetic_dataset(
    out_dir: str | Path,
    n_frames: int = 60,
    width: int = 128,
    height: int = 128,
    n_vertices: int = 1500,
    fl: float | None = None,
    seed: int = 0,
    device: str | torch.device = "cpu",
) -> dict:
    """Render a synthetic GT capture on `device` and write the contract
    dataset.  Returns dict with the model, gt gaussians, dataset path and
    the FLAME params."""
    model = FlameModel.from_asset(
        synthetic_flame_asset(n_vertices=n_vertices, seed=seed), device=device)
    gt = textured_gt_avatar(model, seed=seed)
    V = model.n_vertices
    params = animated_flame_params(n_frames, V, seed=seed)
    c2w = orbit_c2w_nerf(n_frames)
    fl = fl or (width * 1.8)

    images = np.zeros((n_frames, height, width, 3), np.uint8)
    masks = np.zeros((n_frames, height, width), np.float32)
    with torch.inference_mode():
        verts = flame_forward(model, params)
        for i in range(n_frames):
            cam = camera_from_nerf(c2w[i], fl, fl, width / 2, height / 2,
                                   width, height, device=device)
            # one-shot GT generation: never spill-clip (large_frac=1.0)
            img, aux = render_avatar_frame(gt, verts[i], model.faces, cam,
                                           width, height, large_frac=1.0)
            images[i] = np.clip(img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
            masks[i] = aux["alpha"].cpu().numpy() > 0.5
        points3d = verts[0].cpu().numpy()

    path = write_dataset(
        out_dir, images, c2w, fl, fl, width / 2, height / 2,
        flame_params=params, masks=masks, points3d=points3d, n_verts=V,
    )
    return {"model": model, "gt_gaussians": gt, "path": path, "params": params}
