"""Pinhole camera model + 3DGS EWA projection math, in PyTorch.

Port of `omfs4d.ops.camera`.  The dataset contract stores NeRF-convention
camera-to-world matrices; they are converted to OpenCV convention (+z in
front of the camera).  `project_gaussians` returns camera-space depth, the
conic of the projected 2x2 covariance and the 3-sigma screen radius.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Camera:
    """Static pinhole camera: float32 tensors on one device, plus the image
    size as ints."""

    w2c: torch.Tensor    # (4, 4) world -> camera (OpenCV: +z forward)
    fx: torch.Tensor     # () each
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int

    @property
    def position(self) -> torch.Tensor:
        """Camera centre in world coordinates, (3,)."""
        return -self.w2c[:3, :3].T @ self.w2c[:3, 3]


def _camera(w2c: np.ndarray, fx, fy, cx, cy, width, height, device) -> Camera:
    def scalar(v):
        return torch.tensor(np.float32(v), device=device)

    return Camera(
        w2c=torch.tensor(np.asarray(w2c, np.float32), device=device),
        fx=scalar(fx), fy=scalar(fy), cx=scalar(cx), cy=scalar(cy),
        width=int(width), height=int(height),
    )


def camera_from_nerf(
    c2w_nerf: np.ndarray,
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int,
    device: str | torch.device = "cpu",
) -> Camera:
    """Build a Camera from a NeRF/OpenGL camera-to-world matrix
    (camera looks along -z, y up) as stored in transforms_*.json."""
    c2w = np.asarray(c2w_nerf, dtype=np.float64).copy()
    c2w[:3, 1:3] *= -1.0           # OpenGL -> OpenCV axis flip
    return _camera(np.linalg.inv(c2w), fx, fy, cx, cy, width, height, device)


def look_at_camera(
    eye, target, up=(0.0, 1.0, 0.0),
    fx: float = 1000.0, fy: float | None = None,
    width: int = 512, height: int = 512,
    cx: float | None = None, cy: float | None = None,
    device: str | torch.device = "cpu",
) -> Camera:
    """Synthetic camera for tests/benches: OpenCV convention (+z forward)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    upv = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, upv)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)   # rows: x right, y down, z fwd
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return _camera(w2c, fx, fy if fy is not None else fx,
                   cx if cx is not None else width / 2.0,
                   cy if cy is not None else height / 2.0,
                   width, height, device)


def project_points(cam: Camera, pts: torch.Tensor):
    """World points (..., 3) -> (uv (..., 2), depth (...)); float32 throughout."""
    p = pts @ cam.w2c[:3, :3].T + cam.w2c[:3, 3]
    z = p[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = cam.fx * p[..., 0] / safe_z + cam.cx
    v = cam.fy * p[..., 1] / safe_z + cam.cy
    return torch.stack([u, v], dim=-1), z


def project_gaussians(
    cam: Camera,
    means: torch.Tensor,       # (N, 3)
    rotations: torch.Tensor,   # (N, 3, 3)
    scales: torch.Tensor,      # (N, 3)
    near: float = 0.01,
    blur: float = 0.3,
):
    """EWA splatting projection (per gaussian, vectorized).

    Returns dict with:
      uv (N, 2) pixel centers, depth (N,), conic (N, 3) = (a, b, c) of the
      inverse 2x2 covariance [[a, b], [b, c]], radius (N,) 3-sigma extent in
      pixels, in_front (N,) bool validity.
    """
    W = cam.w2c[:3, :3]
    t = means @ W.T + cam.w2c[:3, 3]
    z = t[:, 2]
    in_front = z > near
    safe_z = torch.clamp_min(z, near)

    u = cam.fx * t[:, 0] / safe_z + cam.cx
    v = cam.fy * t[:, 1] / safe_z + cam.cy
    uv = torch.stack([u, v], dim=-1)

    # 2D covariance = M Mᵀ with M = J W R S  (N, 2, 3)
    RS = rotations * scales[:, None, :]                       # (N, 3, 3)
    # rows of W @ RS: wr[i][:, k] = sum_j W[i, j] * RS[:, j, k]
    wr = [
        W[i, 0] * RS[:, 0, :] + W[i, 1] * RS[:, 1, :] + W[i, 2] * RS[:, 2, :]
        for i in range(3)
    ]                                                          # 3 x (N, 3)
    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z
    # J rows: [fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]
    m0 = cam.fx * (inv_z[:, None] * wr[0] - (t[:, 0] * inv_z2)[:, None] * wr[2])
    m1 = cam.fy * (inv_z[:, None] * wr[1] - (t[:, 1] * inv_z2)[:, None] * wr[2])

    a = torch.sum(m0 * m0, dim=-1) + blur
    b = torch.sum(m0 * m1, dim=-1)
    c = torch.sum(m1 * m1, dim=-1) + blur
    det = torch.clamp_min(a * c - b * b, 1e-12)
    conic = torch.stack([c / det, -b / det, a / det], dim=-1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))

    return {
        "uv": uv,
        "depth": z,
        "conic": conic,
        "radius": radius,
        "in_front": in_front,
    }
