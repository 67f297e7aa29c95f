"""Mesh-bound 3D gaussians (the avatar representation), in PyTorch.

Port of `omfs4d.models.gaussians`: every gaussian stores LOCAL
(triangle-frame) position / rotation / scale, `bind_to_mesh` maps them to
world space for one posed FLAME mesh, and capacity is fixed (`alive` mask)
so densify/prune never change shapes.

`GaussianAvatar` is an `nn.Module` of fixed-capacity `nn.Parameter`s plus
the `parent_face` and `alive` buffers.  The render path runs it under
`torch.inference_mode()`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

PARAM_FIELDS = ("mu_local", "quat_local", "log_scale", "opacity_logit", "color", "sh")
FIELDS = ("parent_face",) + PARAM_FIELDS + ("alive",)


class GaussianAvatar(nn.Module):
    """Fixed-capacity gaussian cloud bound to mesh triangles.

    parent_face (N,) int32 buffer — triangle each gaussian rides
    mu_local (N, 3)      position in the triangle frame
    quat_local (N, 4)    rotation in the triangle frame (wxyz)
    log_scale (N, 3)     log scale relative to triangle size
    opacity_logit (N,)
    color (N, 3)         DC rgb in [0, 1] via sigmoid at render
    sh (N, S, 3)         SH rest coeffs; S in {0, 3, 8, 15}
    alive (N,) bool buffer — capacity mask
    """

    def __init__(self, parent_face, mu_local, quat_local, log_scale,
                 opacity_logit, color, sh, alive):
        """Fields as arrays or tensors; the module owns a copy of each, on
        the device a tensor field is on."""
        super().__init__()
        self.register_buffer("parent_face", _owned(parent_face, torch.int32))
        for name, value in zip(PARAM_FIELDS, (mu_local, quat_local, log_scale,
                                              opacity_logit, color, sh)):
            setattr(self, name, nn.Parameter(_owned(value, torch.float32)))
        self.register_buffer("alive", _owned(alive, torch.bool))

    @property
    def capacity(self) -> int:
        return self.mu_local.shape[0]


def _owned(value, dtype) -> torch.Tensor:
    if torch.is_tensor(value):
        return value.detach().to(dtype).clone()
    return torch.tensor(np.asarray(value), dtype=dtype)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix.

    eps INSIDE the sqrt: `norm(q) + eps` has a NaN gradient at q == 0, and
    zero-padded dead slots do hit q == 0."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)
    q = q / norm
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def triangle_frames(verts: torch.Tensor, faces: torch.Tensor):
    """Per-face orthonormal frame, centroid and scale.

    verts (V, 3), faces (F, 3) ->
      R (F, 3, 3) columns = [edge dir, in-plane perp, normal]
      t (F, 3) centroid,  s (F,) scale (mean edge length)
    """
    tri = verts[faces.long()]                  # (F, 3, 3)
    t = tri.mean(dim=1)
    e0 = tri[:, 1] - tri[:, 0]
    e1 = tri[:, 2] - tri[:, 0]
    n = torch.linalg.cross(e0, e1)
    n = n / (_norm(n, keepdim=True) + 1e-12)
    x = e0 / (_norm(e0, keepdim=True) + 1e-12)
    y = torch.linalg.cross(n, x)
    R = torch.stack([x, y, n], dim=-1)         # (F, 3, 3)
    e2 = tri[:, 2] - tri[:, 1]
    s = (_norm(e0) + _norm(e1) + _norm(e2)) / 3.0
    return R, t, s


def bind_to_mesh(g: GaussianAvatar, verts: torch.Tensor, faces: torch.Tensor):
    """Local -> world gaussian parameters for one posed mesh.

    Returns (means (N, 3), rotations (N, 3, 3), scales (N, 3),
             opacities (N,), colors (N, 3)).
    """
    R_f, t_f, s_f = triangle_frames(verts, faces)
    F = faces.shape[0]
    # one fused (F, 13) row gather per gaussian
    face_data = torch.cat([R_f.reshape(F, 9), t_f, s_f[:, None]], dim=1)
    gd = face_data[g.parent_face.long()]                   # (N, 13)
    Rp = gd[:, :9].reshape(-1, 3, 3)
    tp = gd[:, 9:12]
    sp = gd[:, 12]

    mu = g.mu_local
    means = tp + sp[:, None] * (
        Rp[:, :, 0] * mu[:, 0:1] + Rp[:, :, 1] * mu[:, 1:2]
        + Rp[:, :, 2] * mu[:, 2:3]
    )
    rot = Rp @ quat_to_matrix(g.quat_local)
    scales = sp[:, None] * torch.exp(g.log_scale)
    opac = torch.sigmoid(g.opacity_logit) * g.alive.to(torch.float32)
    colors = torch.sigmoid(g.color)
    return means, rot, scales, opac, colors


SH1_C = 0.4886025119  # sqrt(3 / (4*pi)) — degree-1 real SH constant
# degree-2/3 real SH constants (the CUDA rasterizer's computeColorFromSH table)
SH2_C = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH3_C = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

#: SH rest-coefficient count per degree (DC excluded)
SH_DIM = {0: 0, 1: 3, 2: 8, 3: 15}


def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis values (rest only, no DC) for unit dirs (N, 3) ->
    (N, SH_DIM[degree]).  Degree 0 has no rest terms: (N, 0)."""
    if degree == 0:
        return d[:, :0]
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    cols = [-SH1_C * y, SH1_C * z, -SH1_C * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        cols += [
            SH2_C[0] * x * y, SH2_C[1] * y * z,
            SH2_C[2] * (2.0 * zz - xx - yy),
            SH2_C[3] * x * z, SH2_C[4] * (xx - yy),
        ]
    if degree >= 3:
        cols += [
            SH3_C[0] * y * (3.0 * xx - yy),
            SH3_C[1] * x * y * z,
            SH3_C[2] * y * (4.0 * zz - xx - yy),
            SH3_C[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH3_C[4] * x * (4.0 * zz - xx - yy),
            SH3_C[5] * z * (xx - yy),
            SH3_C[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(cols, dim=1)


def sh_degree_of(g: GaussianAvatar) -> int:
    return {v: k for k, v in SH_DIM.items()}[g.sh.shape[1]]


def eval_colors(g: GaussianAvatar, means: torch.Tensor, cam_pos: torch.Tensor):
    """View-dependent color: sigmoid DC + SH rest along the view direction
    (SH evaluated at each gaussian center toward the camera).  Zero `sh`, or
    SH degree 0, reduces exactly to the DC color."""
    dc = torch.sigmoid(g.color)                        # (N, 3)
    d = means - cam_pos[None, :]
    d = d / (_norm(d, keepdim=True) + 1e-9)
    basis = sh_basis(d, sh_degree_of(g))               # (N, S)
    view = torch.einsum("nb,nbc->nc", basis, g.sh)     # (N, 3)
    return torch.clamp(dc + view, 0.0, 1.0)


def inverse_sigmoid(x: float) -> float:
    return float(np.log(x / (1.0 - x)))


def init_gaussians_on_mesh(
    faces: np.ndarray,
    capacity: int,
    init_opacity: float = 0.1,
    init_color: float = 0.5,
    init_scale: float = 0.5,
    seed: int = 0,
    sh_degree: int = 3,
    ref_verts: np.ndarray | None = None,
    device: str | torch.device = "cpu",
) -> GaussianAvatar:
    """One gaussian per triangle (GaussianAvatars' binding init), padded to
    a fixed capacity.  The numbers come from numpy with `seed`, as in the
    JAX package, so both packages start from the same cloud.

    `ref_verts` (V, 3): when given, per-face init scales follow the CUDA
    3DGS / simple-knn convention: world-space init sigma = mean distance to
    the 3 nearest triangle centroids, expressed in the parent triangle's
    local units and never above `init_scale`."""
    F = len(faces)
    n = min(F, capacity)
    rng = np.random.default_rng(seed)

    parent = np.zeros(capacity, dtype=np.int32)
    parent[:n] = np.arange(n) % F
    quat = np.zeros((capacity, 4), dtype=np.float32)
    quat[:, 0] = 1.0
    mu = np.zeros((capacity, 3), dtype=np.float32)
    log_scale = np.full((capacity, 3), np.log(init_scale), dtype=np.float32)
    if ref_verts is not None:
        from omfs4d_torch.ops.knn import knn_mean_distance
        _, t_, s = triangle_frames(torch.as_tensor(np.asarray(ref_verts, np.float32)),
                                   torch.as_tensor(np.asarray(faces)))
        s = np.maximum(s.numpy(), 1e-9)
        d_knn = knn_mean_distance(t_, k=3).numpy()          # (F,)
        local = np.clip(d_knn / s, None, init_scale)        # never grow
        log_scale = np.log(np.maximum(local[parent], 1e-6)
                           ).astype(np.float32)[:, None].repeat(3, 1)
    opac = np.full((capacity,), inverse_sigmoid(init_opacity), dtype=np.float32)
    color = np.full((capacity, 3), inverse_sigmoid(np.clip(init_color, 1e-3, 1 - 1e-3)),
                    dtype=np.float32)
    color[:n] += rng.normal(0, 0.05, size=(n, 3)).astype(np.float32)
    alive = np.zeros(capacity, dtype=bool)
    alive[:n] = True

    return GaussianAvatar(
        parent_face=parent, mu_local=mu, quat_local=quat, log_scale=log_scale,
        opacity_logit=opac, color=color,
        sh=np.zeros((capacity, SH_DIM[sh_degree], 3), np.float32),
        alive=alive,
    ).to(device)


def init_gaussians_from_points(
    points: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    capacity: int,
    init_opacity: float = 0.1,
    init_color: float = 0.5,
    sh_degree: int = 3,
    device: str | torch.device = "cpu",
) -> GaussianAvatar:
    """Initialize gaussians from a point cloud (the points3d.ply contract):
    per-point scale from the mean distance to the 3 nearest neighbours, each
    point bound to its nearest canonical FLAME triangle centroid and
    expressed in that triangle's local frame."""
    from omfs4d_torch.ops.knn import knn_mean_distance

    points = np.asarray(points, dtype=np.float32)
    n = min(len(points), capacity)
    pts = points[:n]

    R_f, t_f, s_f = triangle_frames(torch.as_tensor(np.asarray(verts, np.float32)),
                                    torch.as_tensor(np.asarray(faces, np.int32)))
    R_f, t_f, s_f = R_f.numpy(), t_f.numpy(), s_f.numpy()

    # nearest face centroid per point (blocked to bound memory)
    parent = np.zeros(n, dtype=np.int32)
    for start in range(0, n, 8192):
        chunk = pts[start : start + 8192]
        d2 = ((chunk[:, None, :] - t_f[None, :, :]) ** 2).sum(-1)
        parent[start : start + len(chunk)] = d2.argmin(1).astype(np.int32)

    # local frame coordinates: mu = R^T (p - t) / s
    rel = pts - t_f[parent]
    mu = np.einsum("nij,ni->nj", R_f[parent], rel) / s_f[parent][:, None]

    knn_d = knn_mean_distance(pts, k=3).numpy()
    local_scale = np.clip(knn_d / np.maximum(s_f[parent], 1e-8), 1e-3, 10.0)

    g = init_gaussians_on_mesh(np.asarray(faces), capacity,
                               init_opacity=init_opacity, init_color=init_color,
                               sh_degree=sh_degree)
    fields = {k: v.detach().numpy().copy() for k, v in
              list(g.named_parameters()) + list(g.named_buffers())}
    fields["parent_face"][:n] = parent
    fields["mu_local"][:n] = mu
    fields["log_scale"][:n] = np.log(local_scale)[:, None]
    fields["alive"][:] = False
    fields["alive"][:n] = True
    return GaussianAvatar(**fields).to(device)


def n_alive(g: GaussianAvatar) -> torch.Tensor:
    return g.alive.sum()
