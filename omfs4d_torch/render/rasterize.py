"""3D Gaussian Splatting rasterizer in PyTorch: project -> bin -> composite.

Port of `omfs4d.render.rasterize`:

  * projection/culling: vectorized EWA math (omfs4d_torch.ops.camera);
  * binning: (gaussian, tile) pair expansion with a static per-gaussian tile
    window, one stable sort by a fused [tile | quantized depth] key;
  * per-tile lists: fixed capacity `max_per_tile`; the sort keeps the K
    *nearest* gaussians of a tile on overflow;
  * compositing: front to back per pixel (alpha cap 0.99, 1/255 cutoff).
    A CUDA tensor goes through the hand-written kernel in
    `omfs4d_torch.render.composite`; a CPU tensor through the plain PyTorch
    version here (`composite_tiles_torch`).

Binning is index arithmetic on a stable sort, so it never needs a host
synchronise: a frame runs from the posed mesh to the image without leaving
the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from omfs4d_torch.ops.camera import Camera, project_gaussians

ALPHA_CUTOFF = 1.0 / 255.0
ALPHA_CAP = 0.99


class TileBinning(NamedTuple):
    """Static-shape per-tile gaussian lists."""

    tile_lists: torch.Tensor     # (num_tiles, K) int32 gaussian indices (pad 0)
    tile_counts: torch.Tensor    # (num_tiles,) int32 — valid entries per tile
    overflow: torch.Tensor       # () int32 — pairs dropped by the K cap
    window_clipped: torch.Tensor # () int32 — gaussians larger than the window
    spilled: torch.Tensor        # () int32 — mid-size gaussians past the
    #                                large-class budget (two-class binning only)


def _grid(width: int, height: int, tile: int) -> tuple[int, int]:
    return (width + tile - 1) // tile, (height + tile - 1) // tile


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum().to(torch.int32)


def bin_gaussians(
    proj: dict,
    opacity: torch.Tensor,
    width: int,
    height: int,
    tile: int = 16,
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 16,
    small_tiles_per_gaussian: int = 4,
    large_frac: float = 0.125,
    two_class_min_n: int = 4096,
    large_min: int = 1024,
) -> TileBinning:
    """Build depth-sorted per-tile gaussian lists.

    A gaussian covers the tiles intersecting its 3-sigma screen box,
    enumerated as a static (kh, kw) window.  For scenes with
    >= `two_class_min_n` gaussians the window budget is two-class: every
    gaussian gets the `small_tiles_per_gaussian` window, and the
    `max(large_min, n*large_frac)` largest-by-radius gaussians whose box
    exceeds it get the full `max_tiles_per_gaussian` window.  Smaller
    scenes get the uniform `max_tiles_per_gaussian` window.

    Equal keys keep their pair order (`torch.sort(stable=True)`).  The JAX
    package's `lax.sort` does not promise that, so lists agree across the
    two packages only where the valid keys of a tile are distinct.
    """
    grid_w, grid_h = _grid(width, height, tile)
    num_tiles = grid_w * grid_h
    dev = opacity.device

    uv, radius, depth = proj["uv"], proj["radius"], proj["depth"]
    n = uv.shape[0]

    visible = (
        proj["in_front"]
        & (radius > 0)
        & (opacity > ALPHA_CUTOFF)
        & (uv[:, 0] + radius > 0)
        & (uv[:, 0] - radius < width)
        & (uv[:, 1] + radius > 0)
        & (uv[:, 1] - radius < height)
    )

    def tile_coord(c, hi):
        return torch.clamp(torch.floor(c / tile), 0, hi - 1).to(torch.int32)

    x0 = tile_coord(uv[:, 0] - radius, grid_w)
    x1 = tile_coord(uv[:, 0] + radius, grid_w)
    y0 = tile_coord(uv[:, 1] - radius, grid_h)
    y1 = tile_coord(uv[:, 1] + radius, grid_h)

    # single fused int32 key [tile | quantized depth]: positive-float bit
    # patterns are monotone, so the top `depth_bits` of the f32 encoding sort
    # like the value
    tile_bits = int(num_tiles + 1).bit_length()
    depth_bits = 31 - tile_bits
    d_q1 = torch.clamp_min(depth, 0.0).view(torch.int32) >> (31 - depth_bits)

    def window_pairs(g_x0, g_y0, g_x1, g_y1, ok, g_dq, g_idx, kh, kw):
        """Flat (tile, idx, depth-key) pair arrays for one window class."""
        dy = torch.arange(kh, dtype=torch.int32, device=dev)
        dx = torch.arange(kw, dtype=torch.int32, device=dev)
        ty = g_y0[:, None, None] + dy[None, :, None]       # (g, kh, 1)
        tx = g_x0[:, None, None] + dx[None, None, :]       # (g, 1, kw)
        pair_ok = (
            ok[:, None, None]
            & (ty <= g_y1[:, None, None])
            & (tx <= g_x1[:, None, None])
        )                                                   # (g, kh, kw)
        tid = ty * grid_w + tx
        f_tile = torch.where(pair_ok, tid, num_tiles).reshape(-1).to(torch.int32)
        f_idx = g_idx[:, None, None].expand(pair_ok.shape).reshape(-1)
        f_dq = g_dq[:, None, None].expand(pair_ok.shape).reshape(-1)
        return f_tile, f_idx, f_dq

    kw_l = int(max(1, round(max_tiles_per_gaussian ** 0.5)))
    kh_l = (max_tiles_per_gaussian + kw_l - 1) // kw_l
    kw_s = int(max(1, round(small_tiles_per_gaussian ** 0.5)))
    kh_s = (small_tiles_per_gaussian + kw_s - 1) // kw_s
    idx_all = torch.arange(n, dtype=torch.int32, device=dev)
    span_x, span_y = x1 - x0 + 1, y1 - y0 + 1

    if n >= two_class_min_n and max_tiles_per_gaussian > small_tiles_per_gaussian:
        needs_large = visible & ((span_x > kw_s) | (span_y > kh_s))
        m = min(n, max(large_min, int(round(n * large_frac))))
        # exact top-m by radius through one full sort
        neg_score = torch.where(needs_large, -radius,
                                torch.tensor(3.4e38, dtype=radius.dtype, device=dev))
        large_sel = torch.sort(neg_score, stable=True).indices[:m]
        sel_ok = needs_large[large_sel]
        is_large = torch.zeros(n, dtype=torch.bool, device=dev)
        is_large[large_sel] = sel_ok
        ft_s, fi_s, fd_s = window_pairs(
            x0, y0, x1, y1, visible & ~is_large, d_q1, idx_all, kh_s, kw_s)
        ft_l, fi_l, fd_l = window_pairs(
            x0[large_sel], y0[large_sel], x1[large_sel], y1[large_sel],
            sel_ok, d_q1[large_sel], large_sel.to(torch.int32), kh_l, kw_l)
        flat_tile = torch.cat([ft_s, ft_l])
        flat_idx = torch.cat([fi_s, fi_l])
        d_q = torch.cat([fd_s, fd_l])
        # `spilled` is relieved by growing `large_frac`, `window_clipped` by
        # growing `max_tiles_per_gaussian`
        spilled = _count(needs_large & ~is_large)
        window_clipped = _count(
            sel_ok & ((span_x[large_sel] > kw_l) | (span_y[large_sel] > kh_l)))
    else:
        flat_tile, flat_idx, d_q = window_pairs(
            x0, y0, x1, y1, visible, d_q1, idx_all, kh_l, kw_l)
        window_clipped = _count(visible & ((span_x > kw_l) | (span_y > kh_l)))
        spilled = torch.zeros((), dtype=torch.int32, device=dev)

    key = (flat_tile << depth_bits) | d_q

    # sorted by (tile, depth): nearest-first inside each tile
    s_key, order = torch.sort(key, stable=True)
    s_idx = flat_idx[order]
    s_tile = s_key >> depth_bits

    # pairs are tile-contiguous: segment starts by one searchsorted, then the
    # per-tile lists are a gather  tile_lists[t, k] = s_idx[starts[t] + k]
    starts = torch.searchsorted(
        s_tile, torch.arange(num_tiles + 1, dtype=s_tile.dtype, device=dev),
        right=False)                                         # int64
    counts_raw = starts[1:] - starts[:-1]
    tile_counts = torch.clamp_max(counts_raw, max_per_tile).to(torch.int32)
    overflow = torch.clamp_min(counts_raw - max_per_tile, 0).sum().to(torch.int32)

    n_pairs = s_idx.shape[0]
    k_ids = torch.arange(max_per_tile, device=dev)
    pos = starts[:-1, None] + k_ids[None, :]
    valid = k_ids[None, :] < counts_raw[:, None]
    tile_lists = torch.where(valid, s_idx[torch.clamp(pos, 0, n_pairs - 1)], 0)

    return TileBinning(tile_lists.to(torch.int32), tile_counts, overflow,
                       window_clipped, spilled)


def _tile_pixel_centers(grid_w: int, grid_h: int, tile: int,
                        device: str | torch.device = "cpu") -> torch.Tensor:
    """(num_tiles, tile*tile, 2) pixel-center coordinates per tile."""
    ty, tx = torch.meshgrid(torch.arange(grid_h, device=device),
                            torch.arange(grid_w, device=device), indexing="ij")
    py, px = torch.meshgrid(torch.arange(tile, device=device),
                            torch.arange(tile, device=device), indexing="ij")
    x = tx.reshape(-1, 1) * tile + px.reshape(1, -1) + 0.5   # (T, P)
    y = ty.reshape(-1, 1) * tile + py.reshape(1, -1) + 0.5
    return torch.stack([x, y], dim=-1).to(torch.float32)     # (T, P, 2)


def composite_tiles_torch(
    uv, conic, colors, opacity,
    lists: torch.Tensor,       # (T, K) per-tile gaussian indices
    counts: torch.Tensor,      # (T,)
    pix: torch.Tensor,         # (T, P, 2) pixel centers
    chunk_tiles: int = 64,
):
    """Per-tile compositing in plain PyTorch over any tile subset, in chunks
    of `chunk_tiles` tiles to bound the (chunk, K, P) working set.

    Returns ((T, P, 3) colors, (T, P) alpha)."""
    num_tiles, K = lists.shape
    P = pix.shape[1]
    col_out = uv.new_empty((num_tiles, P, 3))
    alpha_out = uv.new_empty((num_tiles, P))
    k_ids = torch.arange(K, device=lists.device)
    for s in range(0, num_tiles, chunk_tiles):
        idx = lists[s:s + chunk_tiles].long()                 # (c, K)
        uvk, conick = uv[idx], conic[idx]                     # (c, K, 2|3)
        ok, ck = opacity[idx], colors[idx]                    # (c, K), (c, K, 3)
        valid = k_ids[None, :] < counts[s:s + chunk_tiles, None]

        d = pix[s:s + chunk_tiles, None, :, :] - uvk[:, :, None, :]   # (c, K, P, 2)
        dx, dy = d[..., 0], d[..., 1]
        power = (
            -0.5 * (conick[..., 0:1] * dx * dx + conick[..., 2:3] * dy * dy)
            - conick[..., 1:2] * dx * dy
        )
        alpha = torch.clamp_max(ok[..., None] * torch.exp(power), ALPHA_CAP)
        alpha = torch.where(alpha < ALPHA_CUTOFF, 0.0, alpha)
        alpha = torch.where(valid[..., None], alpha, 0.0)             # (c, K, P)

        trans = torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
        w = alpha * t_excl                                            # (c, K, P)
        col_out[s:s + chunk_tiles] = torch.einsum("ckp,ckx->cpx", w, ck)
        alpha_out[s:s + chunk_tiles] = 1.0 - trans[:, -1]
    return col_out, alpha_out


def assemble_tiles(colors_out, alphas_out, width, height, tile):
    """(T, P, C) per-tile results -> (H, W, C) image (any channel count)."""
    grid_w, grid_h = _grid(width, height, tile)
    C = colors_out.shape[-1]
    img = colors_out.reshape(grid_h, grid_w, tile, tile, C)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_h * tile, grid_w * tile, C)
    alp = alphas_out.reshape(grid_h, grid_w, tile, tile)
    alp = alp.permute(0, 2, 1, 3).reshape(grid_h * tile, grid_w * tile)
    return img[:height, :width], alp[:height, :width]


def composite_reference(
    uv: torch.Tensor,          # (N, 2)
    conic: torch.Tensor,       # (N, 3)
    colors: torch.Tensor,      # (N, 3)
    opacity: torch.Tensor,     # (N,)
    binning: TileBinning,
    width: int,
    height: int,
    tile: int = 16,
    tile_base: int = 0,
    chunk_tiles: int = 64,
):
    """Plain PyTorch tile compositing.  Returns (image (H, W, 3), alpha (H, W)).

    The lists cover tiles `tile_base .. tile_base + T - 1` of the image
    (all of them by default); pixels of other tiles are 0."""
    grid_w, grid_h = _grid(width, height, tile)
    num_tiles = grid_w * grid_h
    T = binning.tile_lists.shape[0]
    pix = _tile_pixel_centers(grid_w, grid_h, tile, uv.device)
    colors_out, alphas_out = composite_tiles_torch(
        uv, conic, colors, opacity, binning.tile_lists, binning.tile_counts,
        pix[tile_base:tile_base + T], chunk_tiles)
    if T != num_tiles:
        pad = (tile_base, num_tiles - tile_base - T)
        colors_out = torch.nn.functional.pad(colors_out, (0, 0, 0, 0) + pad)
        alphas_out = torch.nn.functional.pad(alphas_out, (0, 0) + pad)
    return assemble_tiles(colors_out, alphas_out, width, height, tile)


def rasterize(
    means: torch.Tensor,        # (N, 3) world
    rotations: torch.Tensor,    # (N, 3, 3)
    scales: torch.Tensor,       # (N, 3)
    opacity: torch.Tensor,      # (N,)
    colors: torch.Tensor,       # (N, 3)
    camera: Camera,
    width: int,
    height: int,
    background: torch.Tensor | None = None,
    tile: int = 16,
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 16,
    small_tiles_per_gaussian: int = 4,
    large_frac: float = 0.125,
    two_class_min_n: int = 4096,
    clock=None,
):
    """Rasterize one frame.  Returns (image (H, W, 3), aux dict with alpha
    and the binning counters).

    The composite is picked by the device of `means`: the CUDA kernel for a
    CUDA tensor, the plain PyTorch version for a CPU tensor.  `clock`, a
    `omfs4d_torch.core.timing.StageClock`, times the project / bin /
    composite stages when given."""
    from omfs4d_torch.render.composite import composite

    dev = means.device
    if background is None:
        background = torch.ones(3, dtype=torch.float32, device=dev)
    if means.shape[0] == 0:
        # empty cloud (every gaussian pruned): binning and gathers assume
        # N >= 1, so emit pure background
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (background.expand(height, width, 3).clone(),
                {"alpha": torch.zeros((height, width), dtype=torch.float32, device=dev),
                 "overflow": zero, "window_clipped": zero, "spilled": zero})
    proj = project_gaussians(camera, means, rotations, scales)
    if clock is not None:
        clock.lap("project")

    binning = bin_gaussians(
        {k: v.detach() for k, v in proj.items()}, opacity.detach(),
        width, height, tile, max_per_tile, max_tiles_per_gaussian,
        small_tiles_per_gaussian=small_tiles_per_gaussian,
        large_frac=large_frac, two_class_min_n=two_class_min_n,
    )
    if clock is not None:
        clock.lap("bin")

    img, alpha = composite(proj["uv"], proj["conic"], colors, opacity, binning,
                           width, height, tile)
    img = img + (1.0 - alpha)[..., None] * background
    if clock is not None:
        clock.lap("composite")
    return img, {"alpha": alpha, "overflow": binning.overflow,
                 "window_clipped": binning.window_clipped,
                 "spilled": binning.spilled}


def render_avatar_frame(
    gaussians,
    flame_verts: torch.Tensor,
    faces: torch.Tensor,
    camera: Camera,
    width: int,
    height: int,
    background: torch.Tensor | None = None,
    clock=None,
    **kw,
):
    """Bind mesh-rigged gaussians to a posed FLAME mesh and rasterize."""
    from omfs4d_torch.models.gaussians import bind_to_mesh, eval_colors

    means, rot, scales, opac, _ = bind_to_mesh(gaussians, flame_verts, faces)
    cols = eval_colors(gaussians, means, camera.position)
    if clock is not None:
        clock.lap("bind_colors")
    return rasterize(means, rot, scales, opac, cols, camera, width, height,
                     background=background, clock=clock, **kw)


def render_depth(
    means, rotations, scales, opacity,
    camera: Camera,
    width: int,
    height: int,
    **kw,
):
    """Expected-depth map E[z | hit] and alpha for a gaussian cloud: the
    rasterizer composites camera depth as the "color", normalized by alpha.
    Background (alpha ~ 0) pixels return 0."""
    proj = project_gaussians(camera, means, rotations, scales)
    z = torch.clamp_min(proj["depth"], 0.0)
    depth_colors = torch.stack([z, z, z], dim=1)
    img, aux = rasterize(
        means, rotations, scales, opacity, depth_colors, camera, width, height,
        background=torch.zeros(3, dtype=torch.float32, device=means.device), **kw,
    )
    alpha = aux["alpha"]
    depth = torch.where(alpha > 1e-3, img[..., 0] / torch.clamp_min(alpha, 1e-3), 0.0)
    return depth, alpha
