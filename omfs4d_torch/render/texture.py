"""UV texture atlas sampling + deferred textured-mesh rendering, in PyTorch.

Port of `omfs4d.render.texture`: the photometric FLAME tracker optimizes a
(R, R, 3) texture atlas instead of per-face colors, so appearance resolution
is decoupled from mesh resolution.  Rendering is deferred: the mesh
rasterizer interpolates per-vertex UV as a 2-channel attribute image
(barycentric, `omfs4d_torch.render.mesh_raster`), then one bilinear texture
sample per output pixel produces RGB.  Both the sample positions (-> vertex
gradients) and the texel fetch (-> texture gradients) are differentiable.
"""

from __future__ import annotations

import torch


def clip_like_jnp(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)` with its gradient: 1 inside, 0 outside and one
    half at a tie with either bound (`torch.clamp` passes all of it there)."""
    inside = ((x > lo) & (x < hi)).to(x.dtype)
    tie = ((x == lo) | (x == hi)).to(x.dtype)
    slope = inside + 0.5 * tie
    return torch.clamp(x, lo, hi).detach() + slope * (x - x.detach())


def bilinear_sample(texture: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample `texture` (R_v, R_u, C) at `uv` (..., 2) in [0, 1]^2.

    u indexes columns, v rows (v = 0 at row 0).  Clamped at the border (no
    wraparound: the cylindrical unwrap puts its seam at the back of the head
    where there is no photometric evidence).  Differentiable in both `uv`
    and `texture`."""
    Rv, Ru = texture.shape[0], texture.shape[1]
    x = clip_like_jnp(uv[..., 0] * (Ru - 1), 0.0, Ru - 1.0)
    y = clip_like_jnp(uv[..., 1] * (Rv - 1), 0.0, Rv - 1.0)
    x0 = torch.floor(x).detach().long()
    y0 = torch.floor(y).detach().long()
    x1 = torch.clamp_max(x0 + 1, Ru - 1)
    y1 = torch.clamp_max(y0 + 1, Rv - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    t00 = texture[y0, x0]
    t01 = texture[y0, x1]
    t10 = texture[y1, x0]
    t11 = texture[y1, x1]
    top = t00 * (1.0 - fx) + t01 * fx
    bot = t10 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def face_center_uv(uv_coords: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(F, 2) atlas coordinates at each face centroid (splat-backend use)."""
    return uv_coords[faces.long()].mean(dim=1)


def render_textured_mesh(
    verts: torch.Tensor,           # (V, 3)
    faces: torch.Tensor,           # (F, 3)
    uv_coords: torch.Tensor,       # (V, 2)
    texture: torch.Tensor,         # (R, R, 3) linear color
    camera,
    width: int,
    height: int,
    background: torch.Tensor | None = None,
    **raster_kw,
):
    """Deferred textured render: UV attribute pass -> one bilinear sample.

    Returns (image (H, W, 3), aux {alpha, overflow}).  Gradients reach
    `verts` (silhouette + UV shift), `texture` (texel fetch), and any
    rasterizer inputs."""
    from omfs4d_torch.render.mesh_raster import rasterize_mesh

    dev = verts.device
    if background is None:
        background = torch.ones(3, dtype=torch.float32, device=dev)
    uv_img, aux = rasterize_mesh(
        verts, faces, uv_coords, camera, width, height,
        background=torch.zeros(2, dtype=torch.float32, device=dev),
        vertex_interp=True, **raster_kw,
    )
    alpha = aux["alpha"]
    # the aggregation premultiplies attributes by alpha: unpremultiply to get
    # the foreground UV, then composite the sampled color over the background
    uv = uv_img / torch.clamp_min(alpha, 1e-6)[..., None]
    uv = clip_like_jnp(uv, 0.0, 1.0)
    rgb = bilinear_sample(texture, uv)
    img = rgb * alpha[..., None] + background * (1.0 - alpha)[..., None]
    return img, aux
