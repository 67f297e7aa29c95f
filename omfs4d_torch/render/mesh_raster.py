"""Differentiable triangle-mesh rasterizer (soft halfplane coverage), in PyTorch.

Port of `omfs4d.render.mesh_raster`.  Same architecture as the gaussian
rasterizer (project -> tile-bin with one sort -> fixed-K per-tile lists ->
composite) with the gaussian falloff replaced by a soft triangle-coverage
term:

    d_i(p)      = signed pixel distance to edge i (halfplane function)
    coverage(p) = sigmoid(d_0/s) * sigmoid(d_1/s) * sigmoid(d_2/s)
    alpha       = face_opacity * coverage

s -> 0 approaches hard rasterization; s of ~1 pixel gives usable silhouette
gradients (SoftRas-style).  Colors are either flat per-face or
barycentrically interpolated per-vertex attributes via `vertex_interp` (used
by render/texture.py for deferred UV texturing).

Two aggregation modes:
  * `over`    : front-to-back transmittance compositing (matches the
    gaussian path).  Along an interior shared edge the two adjacent faces
    each reach coverage 0.5 and compose to 0.75 alpha in a ~2s seam.
  * `softmax` : SoftRas partition-of-unity aggregation: per pixel,
    w_f = cov_f * exp(z'_f/g) / sum(cov * exp(z'/g)) with z' the depth
    normalized into [0, 1] (near = 1).  Seam-free interiors and soft depth
    ordering; the default for opaque photometric rendering.

The composite is plain PyTorch on every device, a loop over chunks of
`chunk_tiles` tiles (the reference leaves it to XLA as a `lax.map` over the
same chunks): one (K, P) plane over all tiles of a 256^2 image at K = 256 is
67 MB, and autograd keeps several.
"""

from __future__ import annotations

import torch

from omfs4d_torch.ops.camera import Camera
from omfs4d_torch.render.rasterize import (
    ALPHA_CAP,
    ALPHA_CUTOFF,
    _grid,
    _tile_pixel_centers,
    assemble_tiles,
    bin_gaussians,
)
from omfs4d_torch.render.texture import clip_like_jnp


def _relu_like_jnp(x: torch.Tensor) -> torch.Tensor:
    """`jnp.maximum(x, 0)`: exact, and its gradient at a tie is one half."""
    return 0.5 * (x + torch.abs(x))


class _ProdNonzero(torch.autograd.Function):
    """Product over dim 1 of a tensor with no zero in it (1 - alpha >= 0.01).
    `torch.prod`'s backward looks for zeros first and reads the answer on the
    host; this one divides the product by each factor and never waits."""

    @staticmethod
    def forward(ctx, x):
        out = torch.prod(x, dim=1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (grad * out)[:, None] / x


def project_faces(cam: Camera, verts: torch.Tensor, faces: torch.Tensor,
                  near: float = 0.01, sigma: float = 1.0):
    """Project mesh faces to screen space.

    Returns
    -------
    edges : (F, 9) halfplane coefficients, rows of (nx, ny, c) per edge so
            that d_i(p) = nx*px + ny*py + c is the signed pixel distance
            (positive inside the face).
    proj  : binning dict (uv = centroid, radius, depth, in_front) shaped
            like `project_gaussians` output so `bin_gaussians` is reused.
    """
    faces = faces.long()
    p = verts @ cam.w2c[:3, :3].T + cam.w2c[:3, 3]           # (V, 3) cam space
    z = p[:, 2]
    safe_z = torch.clamp_min(z, near)
    sx = cam.fx * p[:, 0] / safe_z + cam.cx
    sy = cam.fy * p[:, 1] / safe_z + cam.cy
    screen = torch.stack([sx, sy], dim=1)                    # (V, 2)

    tri = screen[faces]                                      # (F, 3, 2)
    tz = z[faces]                                            # (F, 3)
    centroid = tri.mean(dim=1)                               # (F, 2)
    depth = tz.mean(dim=1)
    in_front = torch.all(tz > near, dim=1)

    # signed area: positive = CCW on screen; flip edge normals for CW faces
    e01 = tri[:, 1] - tri[:, 0]
    e02 = tri[:, 2] - tri[:, 0]
    area2 = e01[:, 0] * e02[:, 1] - e01[:, 1] * e02[:, 0]    # (F,)
    orient = torch.where(area2 >= 0, 1.0, -1.0)

    def edge_coeffs(a, b):
        # d(p) = ((b - a) x (p - a)) / |b - a|  (CCW-inside positive)
        d = b - a                                            # (F, 2)
        length = torch.clamp_min(torch.sqrt(torch.sum(d * d, dim=1)), 1e-8)
        nx = -d[:, 1] / length
        ny = d[:, 0] / length
        c = -(nx * a[:, 0] + ny * a[:, 1])
        return torch.stack([nx, ny, c], dim=1) * orient[:, None]

    edges = torch.cat([
        edge_coeffs(tri[:, 0], tri[:, 1]),
        edge_coeffs(tri[:, 1], tri[:, 2]),
        edge_coeffs(tri[:, 2], tri[:, 0]),
    ], dim=1)                                                # (F, 9)

    off = tri - centroid[:, None, :]
    radius = torch.amax(torch.sqrt(torch.sum(off * off, dim=-1)), dim=1) + 4.0 * sigma
    # degenerate / behind-camera faces never bin
    radius = torch.where(in_front, radius, 0.0)

    proj = {
        "uv": centroid,
        "depth": depth,
        "radius": radius,
        "in_front": in_front,
        "conic": torch.zeros((faces.shape[0], 3), dtype=torch.float32,
                             device=verts.device),           # unused
    }
    return edges, proj


def composite_mesh_tiles(
    edges, colors, opacity, depths,
    lists: torch.Tensor, counts: torch.Tensor, pix: torch.Tensor,
    sigma: float = 1.0,
    chunk_tiles: int = 64,
    aggregation: str = "softmax",
    gamma: float = 0.03,
    z_near: float = 0.05,
    z_far: float = 5.0,
    vertex_colors=None,
):
    """Per-tile soft-coverage compositing ((T, P, C) colors, (T, P) alpha).

    `vertex_colors` (F, 3, C) switches from flat per-face color to smooth
    barycentric interpolation: the barycentric weight of a vertex is the
    normalized signed distance to its opposite edge, reusing the halfplane
    values already computed.
    """
    num_tiles, K = lists.shape
    k_ids = torch.arange(K, device=lists.device)
    # normalized depth of every face, once: (F,)
    zn_all = clip_like_jnp((z_far - depths) / (z_far - z_near), 0.0, 1.0)
    neg_inf = float("-inf")

    colors_out, alphas_out = [], []
    for s in range(0, num_tiles, chunk_tiles):
        idx = lists[s:s + chunk_tiles].long()                 # (c, K)
        e = edges[idx]                                        # (c, K, 9)
        ok = opacity[idx]                                     # (c, K)
        valid = k_ids[None, :] < counts[s:s + chunk_tiles, None]   # (c, K)
        px = pix[s:s + chunk_tiles, None, :, 0]               # (c, 1, P)
        py = pix[s:s + chunk_tiles, None, :, 1]

        def dist(i):
            return (e[..., 3 * i, None] * px + e[..., 3 * i + 1, None] * py
                    + e[..., 3 * i + 2, None])                # (c, K, P)

        d0, d1, d2 = dist(0), dist(1), dist(2)
        cov = (torch.sigmoid(d0 / sigma) * torch.sigmoid(d1 / sigma)
               * torch.sigmoid(d2 / sigma))                   # (c, K, P)
        alpha = torch.clamp_max(ok[..., None] * cov, ALPHA_CAP)
        alpha = torch.where(alpha < ALPHA_CUTOFF, 0.0, alpha)
        alpha = torch.where(valid[..., None], alpha, 0.0)

        if vertex_colors is None:
            ck = colors[idx]                                  # (c, K, C)

            def color_term(w):                                # w: (c, K, P)
                return torch.einsum("ckp,ckx->cpx", w, ck)
        else:
            vc = vertex_colors[idx]                           # (c, K, 3, C)
            # edge 0 = (v0,v1) opposite v2; edge 1 = (v1,v2) opposite v0;
            # edge 2 = (v2,v0) opposite v1
            b0 = _relu_like_jnp(d1)
            b1 = _relu_like_jnp(d2)
            b2 = _relu_like_jnp(d0)
            bsum = torch.clamp_min(b0 + b1 + b2, 1e-8)
            # per-pixel interpolated color (c, K, P, C)
            ckp = (b0[..., None] * vc[:, :, None, 0]
                   + b1[..., None] * vc[:, :, None, 1]
                   + b2[..., None] * vc[:, :, None, 2]) / bsum[..., None]

            def color_term(w):
                return torch.einsum("ckp,ckpx->cpx", w, ckp)

        if aggregation == "softmax":
            # SoftRas-style: foreground color is a depth-softmax over faces;
            # total alpha is the probabilistic union, which carries the
            # silhouette gradient
            zn = zn_all[idx]                                  # (c, K)
            logits = torch.where(valid, zn, neg_inf) / gamma
            # an empty tile has no finite logit: its max is taken as 0, so
            # that no (-inf) - (-inf) is ever formed, and its s is 0 anyway
            m = torch.amax(logits, dim=1, keepdim=True)
            m = torch.where(torch.isfinite(m), m, 0.0)
            shifted = torch.where(valid, logits - m, neg_inf)
            sw = alpha * torch.exp(shifted)[..., None]        # (c, K, P)
            denom = torch.sum(sw, dim=1, keepdim=True)
            w = sw / torch.clamp_min(denom, 1e-12)
            a_union = 1.0 - _ProdNonzero.apply(1.0 - alpha)     # (c, P)
            colors_out.append(color_term(w) * a_union[..., None])
            alphas_out.append(a_union)
        else:
            trans = torch.cumprod(1.0 - alpha, dim=1)
            t_excl = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
            colors_out.append(color_term(alpha * t_excl))
            alphas_out.append(1.0 - trans[:, -1])
    return torch.cat(colors_out), torch.cat(alphas_out)


def rasterize_mesh(
    verts: torch.Tensor,          # (V, 3) world-space mesh vertices
    faces: torch.Tensor,          # (F, 3) int32
    face_colors: torch.Tensor,    # (F, C) flat, or (V, C) when
                                  # vertex_interp=True (smooth shading)
    camera: Camera,
    width: int,
    height: int,
    face_opacity: torch.Tensor | float = 1.0,
    background: torch.Tensor | None = None,
    tile: int = 16,
    max_per_tile: int = 128,
    max_tiles_per_face: int = 16,
    sigma: float = 1.0,
    aggregation: str = "softmax",
    gamma: float = 0.03,
    vertex_interp: bool = False,
):
    """Differentiable mesh render (flat or barycentric-smooth shading).

    Returns (image (H, W, C), aux {alpha, overflow}).
    """
    dev = verts.device
    F = faces.shape[0]
    if torch.is_tensor(face_opacity):
        face_opacity = face_opacity.to(dev, torch.float32).expand(F)
    else:       # a number: filled on the device, no copy from the host
        face_opacity = torch.full((F,), float(face_opacity), dtype=torch.float32, device=dev)

    edges, proj = project_faces(camera, verts, faces, sigma=sigma)
    binning = bin_gaussians(
        {k: v.detach() for k, v in proj.items()}, face_opacity.detach(),
        width, height, tile, max_per_tile, max_tiles_per_face,
    )

    grid_w, grid_h = _grid(width, height, tile)
    pix = _tile_pixel_centers(grid_w, grid_h, tile, dev)
    if vertex_interp:
        per_face_vcols = face_colors[faces.long()]            # (F, 3 verts, C)
        flat_cols = per_face_vcols.mean(dim=1)
        colors_out, alphas_out = composite_mesh_tiles(
            edges, flat_cols, face_opacity, proj["depth"],
            binning.tile_lists, binning.tile_counts, pix, sigma,
            aggregation=aggregation, gamma=gamma,
            vertex_colors=per_face_vcols,
        )
    else:
        colors_out, alphas_out = composite_mesh_tiles(
            edges, face_colors, face_opacity, proj["depth"],
            binning.tile_lists, binning.tile_counts, pix, sigma,
            aggregation=aggregation, gamma=gamma,
        )
    img, alpha = assemble_tiles(colors_out, alphas_out, width, height, tile)
    if background is None:
        background = torch.ones(3, dtype=torch.float32, device=dev)
    img = img + (1.0 - alpha)[..., None] * background
    return img, {"alpha": alpha, "overflow": binning.overflow}
