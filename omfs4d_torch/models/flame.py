"""FLAME head model with full kinematic linear blend skinning, in PyTorch.

Port of `omfs4d.models.flame`:

    v = LBS( v_template + S.beta + E.psi + posedirs.(R-I) + offsets,
             J_regressor, weights, [global, neck, jaw, eye_l, eye_r] )
        + translation

`FlameModel` is an `nn.Module` that holds the asset as buffers, so
`.to(device)` moves it whole.  `flame_forward` is batched over frames.

Parameter dict schema == the dataset contract:
    shape (300,) | (B, 300)   expr (B, 100)      rotation (B, 3)
    neck_pose (B, 3)          jaw_pose (B, 3)    eyes_pose (B, 6)
    translation (B, 3)        static_offset (1|B, V, 3)
    dynamic_offset (B, V, 3)
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_BUFFERS = ("v_template", "shapedirs_shape", "shapedirs_expr", "posedirs",
            "J_regressor", "lbs_weights", "parents", "faces", "lmk_faces_idx",
            "lmk_bary_coords", "uv_coords")
_INT_BUFFERS = ("parents", "faces", "lmk_faces_idx")


class FlameModel(nn.Module):
    """FLAME asset as module buffers (same names and layouts as the JAX
    NamedTuple: v_template (V, 3), shapedirs_shape (V, 3, 300),
    shapedirs_expr (V, 3, 100), posedirs (V, 3, 36), J_regressor (J, V),
    lbs_weights (V, J), parents (J,) int32, faces (F, 3) int32,
    lmk_faces_idx (L,) int32, lmk_bary_coords (L, 3), uv_coords (V, 2))."""

    def __init__(self, **fields):
        super().__init__()
        if fields.get("uv_coords") is None:
            fields["uv_coords"] = default_uv_coords(fields["v_template"])
        for name in _BUFFERS:
            dtype = torch.int32 if name in _INT_BUFFERS else torch.float32
            self.register_buffer(name, torch.tensor(np.asarray(fields[name]), dtype=dtype))
        # the kinematic chain is walked on the host: keep it off the device
        self.parent_list = tuple(int(p) for p in np.asarray(fields["parents"]))

    @classmethod
    def from_asset(cls, asset: dict, device: str | torch.device = "cpu") -> "FlameModel":
        return cls(**{k: asset.get(k) for k in _BUFFERS}).to(device)

    @property
    def n_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def n_joints(self) -> int:
        return self.J_regressor.shape[0]


def default_uv_coords(v_template: np.ndarray) -> np.ndarray:
    """Deterministic cylindrical UV unwrap of a head mesh (numpy; verbatim
    from the JAX package): u = azimuth around the vertical axis with the seam
    at the back of the head, v = normalized height."""
    v = np.asarray(v_template, np.float32)
    c = v.mean(axis=0, keepdims=True)
    d = v - c
    theta = np.arctan2(d[:, 0], d[:, 2])          # [-pi, pi], 0 at +z
    u = (theta / np.pi + 1.0) * 0.5
    y = v[:, 1]
    vmin, vmax = float(y.min()), float(y.max())
    vv = (y - vmin) / max(vmax - vmin, 1e-8)
    return np.stack([u, vv], axis=1).astype(np.float32)


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    # eps inside the sqrt keeps the gradient finite at aa == 0
    angle = torch.sqrt(torch.sum(aa * aa, dim=-1, keepdim=True) + 1e-16)
    axis = aa / angle
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zeros, -z, y], dim=-1),
        torch.stack([z, zeros, -x], dim=-1),
        torch.stack([-y, x, zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    sin = torch.sin(angle)[..., None]
    cos = torch.cos(angle)[..., None]
    return eye + sin * K + (1.0 - cos) * (K @ K)


def _rigid_chain(rot_mats: torch.Tensor, joints: torch.Tensor, parents) -> tuple:
    """Forward kinematics along the joint chain.

    rot_mats : (B, J, 3, 3)  joints : (B, J, 3)  parents : host ints
    Returns (posed_joints (B, J, 3), rel_transforms (B, J, 4, 4)) where
    rel_transforms map rest-pose points to posed points (rest pose removed).
    """
    parents = [int(p) for p in parents]
    B, J = joints.shape[:2]
    # parents gathered as views and the bottom row made on the device: an
    # index list or a tensor literal would copy to the card and wait
    parent_joints = torch.stack([joints[:, p] for p in parents[1:]], dim=1)
    rel = torch.cat([joints[:, :1], joints[:, 1:] - parent_joints], dim=1)
    bottom = torch.zeros((B, 1, 4), dtype=rot_mats.dtype, device=rot_mats.device)
    bottom[..., 3] = 1.0

    def make44(R, t):
        return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)

    local = [make44(rot_mats[:, j], rel[:, j]) for j in range(J)]
    world = [local[0]]
    for j in range(1, J):
        world.append(world[parents[j]] @ local[j])
    world = torch.stack(world, dim=1)                                 # (B, J, 4, 4)

    posed_joints = world[..., :3, 3]
    # remove rest pose: A = W @ [I, -j; 0, 1]
    tj = world[..., :3, :3] @ joints[..., None]                       # (B, J, 3, 1)
    rel_tf = torch.cat([
        torch.cat([world[..., :3, :3], world[..., :3, 3:] - tj], dim=-1),
        world[..., 3:, :],
    ], dim=-2)
    return posed_joints, rel_tf


def _param(params: dict, key: str, default_shape, device) -> torch.Tensor:
    value = params.get(key)
    if value is None:
        return torch.zeros(default_shape, dtype=torch.float32, device=device)
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def flame_forward(model: FlameModel, params: dict, return_landmarks: bool = False):
    """Batched FLAME forward pass on the model's device.

    `params` values may be numpy arrays or tensors.  Returns verts
    (B, V, 3) [and landmarks (B, L, 3) when requested].
    """
    dev = model.v_template.device
    expr = torch.as_tensor(params["expr"], dtype=torch.float32, device=dev)
    B = expr.shape[0]
    shape = torch.as_tensor(params["shape"], dtype=torch.float32, device=dev)
    if shape.ndim == 1:
        shape = shape[None].expand(B, shape.shape[0])

    rotation = _param(params, "rotation", (B, 3), dev)
    neck = _param(params, "neck_pose", (B, 3), dev)
    jaw = _param(params, "jaw_pose", (B, 3), dev)
    eyes = _param(params, "eyes_pose", (B, 6), dev)
    translation = _param(params, "translation", (B, 3), dev)

    V = model.n_vertices
    n_shape = model.shapedirs_shape.shape[2]
    n_expr = model.shapedirs_expr.shape[2]

    # 1. shape + expression blendshapes — one (V*3, k) @ (k, B) product each
    def blend(dirs, coeff):
        flat = dirs.reshape(V * 3, -1)
        k = min(flat.shape[1], coeff.shape[1])   # tracker may use fewer modes
        return (flat[:, :k] @ coeff[:, :k].T).T.reshape(B, V, 3)

    v = model.v_template[None] + blend(model.shapedirs_shape, shape[:, :n_shape])
    v = v + blend(model.shapedirs_expr, expr[:, :n_expr])

    if params.get("static_offset") is not None:
        v = v + _param(params, "static_offset", None, dev)[..., :V, :]
    if params.get("dynamic_offset") is not None:
        v = v + _param(params, "dynamic_offset", None, dev)[..., :V, :]

    # 2. joints from the shaped template
    joints = torch.einsum("jv,bvc->bjc", model.J_regressor, v)

    # 3. per-joint rotations
    pose = torch.stack([rotation, neck, jaw, eyes[:, :3], eyes[:, 3:]], dim=1)  # (B, 5, 3)
    rot_mats = axis_angle_to_matrix(pose)                                        # (B, 5, 3, 3)

    # 4. pose-dependent corrective blendshapes
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)                        # (B, 36)
    v = v + blend(model.posedirs, pose_feature)

    # 5. LBS
    _, rel_tf = _rigid_chain(rot_mats, joints, model.parent_list)                # (B, J, 4, 4)
    T = torch.einsum("vj,bjmn->bvmn", model.lbs_weights, rel_tf)                 # (B, V, 4, 4)
    v = torch.einsum("bvmn,bvn->bvm", T[..., :3, :3], v) + T[..., :3, 3]

    # 6. global translation
    v = v + translation[:, None, :]

    if not return_landmarks:
        return v
    return v, flame_landmarks(model, v)


def flame_landmarks(model: FlameModel, verts: torch.Tensor) -> torch.Tensor:
    """Barycentric landmark extraction from posed vertices (B, V, 3)."""
    lmk_faces = model.faces[model.lmk_faces_idx.long()].long()   # (L, 3)
    lmk_verts = verts[:, lmk_faces]                               # (B, L, 3, 3)
    return torch.einsum("blkc,lk->blc", lmk_verts, model.lmk_bary_coords)


def canonical_params(model: FlameModel, T: int = 1, n_shape: int = 300,
                     n_expr: int = 100) -> dict:
    """Neutral parameter set (numpy; the canonical_flame_param.npz contract)."""
    V = model.n_vertices
    return {
        "shape": np.zeros((n_shape,), np.float32),
        "expr": np.zeros((T, n_expr), np.float32),
        "rotation": np.zeros((T, 3), np.float32),
        "neck_pose": np.zeros((T, 3), np.float32),
        "jaw_pose": np.zeros((T, 3), np.float32),
        "eyes_pose": np.zeros((T, 6), np.float32),
        "translation": np.zeros((T, 3), np.float32),
        "static_offset": np.zeros((1, V, 3), np.float32),
        "dynamic_offset": np.zeros((T, V, 3), np.float32),
    }
