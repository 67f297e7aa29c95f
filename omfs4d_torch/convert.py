"""Move parameters between the JAX package and this port as numpy arrays.

The `*_from_numpy` functions take the fields of the JAX NamedTuples as numpy
arrays (in a test: `jax.tree_util.tree_map(np.asarray, x)._asdict()`) and
return this package's objects on `device`; `to_numpy` goes the other way.
Both packages then compute on the same numbers.
"""

from __future__ import annotations

import torch

from omfs4d_torch.models.flame import FlameModel
from omfs4d_torch.models.gaussians import FIELDS as GAUSSIAN_FIELDS
from omfs4d_torch.models.gaussians import GaussianAvatar
from omfs4d_torch.ops.camera import Camera, _camera


def flame_model_from_numpy(fields: dict, device: str | torch.device = "cpu") -> FlameModel:
    return FlameModel(**fields).to(device)


def gaussians_from_numpy(fields: dict, device: str | torch.device = "cpu") -> GaussianAvatar:
    return GaussianAvatar(**{k: fields[k] for k in GAUSSIAN_FIELDS}).to(device)


def camera_from_numpy(w2c, fx, fy, cx, cy, width, height,
                      device: str | torch.device = "cpu") -> Camera:
    return _camera(w2c, fx, fy, cx, cy, width, height, device)


def to_numpy(x):
    """A tensor -> numpy array; a module (its parameters and buffers), a
    Camera or a dict -> dict of numpy arrays (other values pass through)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, torch.nn.Module):
        return {k: to_numpy(v) for k, v in
                list(x.named_parameters()) + list(x.named_buffers())}
    if isinstance(x, Camera):
        return {k: to_numpy(getattr(x, k)) for k in
                ("w2c", "fx", "fy", "cx", "cy", "width", "height")}
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x
