"""Spatial (tile) and gaussian (depth-slice) sharding of a frame's render.

Port of `omfs4d.parallel.shard`, written SPMD: every function runs on every
rank of the mesh axis it names, each rank with its own part of the work and
the collectives of `omfs4d_torch.parallel.collectives` between them.

  * Tile sharding: a frame's tile grid is embarrassingly parallel.  Every
    rank projects and bins the (replicated) gaussians, composites its
    contiguous slab of tiles (`composite_lists` with the slab's first global
    tile: K1 on a card) and the slabs are all-gathered.
  * Gaussian sharding: each rank owns N/n gaussians.  The camera-space depth
    range is cut into n slices, fixed-capacity send buffers route every
    gaussian to its slice's rank (`all_to_all`), each rank bins and
    composites its slice over the full grid (K1 forward, K2 backward on a
    card), and the per-slice (colour, transmittance) pairs are all-gathered
    and merged with the associative "over" operator:

        C = sum_s C_s * prod_{r<s} T_r ,   T = prod_s T_s

Gradients follow `collectives`' rule (the global loss is computed once):
the gathered slices hand each rank its own cotangent, the routed channels'
cotangents ride the `all_to_all` back to their owner, and replicated inputs
(`verts`; on a 2-D mesh the gaussian shards across the data rows) sum their
ranks' cotangents.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from omfs4d_torch.ops.camera import Camera, project_gaussians
from omfs4d_torch.parallel import collectives as C
from omfs4d_torch.parallel.mesh import Mesh
from omfs4d_torch.render.composite import composite_lists
from omfs4d_torch.render.rasterize import assemble_tiles, bin_gaussians

N_CHAN = 11  # ux uy | conic a b c | r g b | opac | depth | radius


class GaussianFields(NamedTuple):
    """The fields `bind_to_mesh` and `eval_colors` read, as plain tensors:
    unlike a `GaussianAvatar`, which owns copies, the record keeps each
    float field in the graph of what was passed in."""

    parent_face: torch.Tensor
    mu_local: torch.Tensor
    quat_local: torch.Tensor
    log_scale: torch.Tensor
    opacity_logit: torch.Tensor
    color: torch.Tensor
    sh: torch.Tensor
    alive: torch.Tensor


def fields_of(g, floats: dict | None = None) -> GaussianFields:
    """`g`'s fields, with the float ones taken from `floats` where given."""
    floats = floats or {}
    return GaussianFields(**{k: floats.get(k, getattr(g, k))
                             for k in GaussianFields._fields})


def _grid(width: int, height: int, tile: int) -> tuple[int, int]:
    return (width + tile - 1) // tile, (height + tile - 1) // tile


def composite_tile_sharded(uv, conic, colors, opacity, binning, width: int, height: int,
                           tile: int, mesh: Mesh, axis: str):
    """Composite with the tile grid sharded over `axis`: each rank
    composites its contiguous slab (the grid padded to a multiple of the
    axis size; the last slab's padding has count 0) and the slabs are
    all-gathered.  Returns the replicated (image (H, W, 3), alpha (H, W))."""
    n_dev = mesh.axis_size(axis)
    grid_w, grid_h = _grid(width, height, tile)
    num_tiles = grid_w * grid_h
    pad = (-num_tiles) % n_dev
    lists, counts = binning.tile_lists, binning.tile_counts
    if pad:
        lists = torch.nn.functional.pad(lists, (0, 0, 0, pad))
        counts = torch.nn.functional.pad(counts, (0, pad))
    local_t = (num_tiles + pad) // n_dev
    base = mesh.axis_index(axis) * local_t
    uv, conic, colors, opacity = C.replicated(mesh, axis, uv, conic, colors, opacity)
    col, alp = composite_lists(uv, conic, colors, opacity,
                               lists[base:base + local_t].contiguous(),
                               counts[base:base + local_t].contiguous(),
                               tile, grid_w, tile_base=base, num_tiles=num_tiles)
    col = C.all_gather_grad(col, mesh, axis).reshape(-1, tile * tile, 3)[:num_tiles]
    alp = C.all_gather_grad(alp, mesh, axis).reshape(-1, tile * tile)[:num_tiles]
    return assemble_tiles(col, alp, width, height, tile)


def rasterize_tile_sharded(means, rotations, scales, opacity, colors, camera: Camera,
                           width: int, height: int, mesh: Mesh, axis: str = "tile",
                           background=None, tile: int = 16, max_per_tile: int = 512,
                           max_tiles_per_gaussian: int = 36):
    """One frame's rasterization with the tile grid sharded over `axis`;
    projection and binning run on every rank (replicated)."""
    proj = project_gaussians(camera, means, rotations, scales)
    binning = bin_gaussians({k: v.detach() for k, v in proj.items()}, opacity.detach(),
                            width, height, tile, max_per_tile, max_tiles_per_gaussian)
    img, alpha = composite_tile_sharded(proj["uv"], proj["conic"], colors, opacity, binning,
                                        width, height, tile, mesh, axis)
    if background is None:
        background = torch.ones(3, dtype=torch.float32, device=means.device)
    img = img + (1.0 - alpha)[..., None] * background
    return img, {"alpha": alpha, "overflow": binning.overflow}


# ── gaussian-axis (model-parallel) sharding ─────────────────


def _pack_channels(proj: dict, colors, opacity) -> torch.Tensor:
    """(n, N_CHAN) rows to route.  Depth and radius only bin the slice, so
    they travel without a gradient (a culled gaussian's radius has none to
    give: its zero cotangent times an infinite derivative would be NaN)."""
    return torch.cat([proj["uv"], proj["conic"], colors, opacity[:, None],
                      proj["depth"].detach()[:, None], proj["radius"].detach()[:, None]],
                     dim=1)


def _route(proj: dict, colors, opac_eff, live, depth_key, mesh: Mesh, axis: str,
           cap: int):
    """Depth-slice routing of this rank's gaussians: slice edges from the
    global live depth range, fixed-capacity per-slice send buffers, the
    `all_to_all`.  Returns (the received (n * cap, N_CHAN) channels, the
    sent gaussians that did not fit a buffer)."""
    n_dev = mesh.axis_size(axis)
    dev = opac_eff.device
    inf = torch.tensor(math.inf, device=dev)
    dmin = C.pmin(torch.where(live, depth_key, inf).min(), mesh, axis)
    dmax = C.pmax(torch.where(live, depth_key, -inf).max(), mesh, axis)
    span = torch.clamp_min(dmax - dmin, 1e-6)
    edges = dmin + span * torch.arange(1, n_dev, dtype=torch.float32, device=dev) / n_dev
    slice_id = torch.clamp(torch.searchsorted(edges, torch.where(live, depth_key, dmin)),
                           0, n_dev - 1).to(torch.int32)

    chans = _pack_channels(proj, colors, opac_eff)            # (n_local, N_CHAN)
    n_local = chans.shape[0]
    order = torch.argsort(slice_id, stable=True)
    sorted_sid = slice_id[order]
    sorted_ch = chans[order]
    starts = torch.searchsorted(
        sorted_sid, torch.arange(n_dev + 1, dtype=torch.int32, device=dev)).to(torch.int32)
    counts = starts[1:] - starts[:-1]
    k = torch.arange(cap, dtype=torch.int32, device=dev)
    pos = starts[:-1, None] + k[None, :]
    valid = k[None, :] < counts[:, None]
    send = torch.where(valid[..., None], sorted_ch[torch.clamp(pos, 0, n_local - 1).long()],
                       0.0)                                   # (n_dev, cap, N_CHAN)
    overflow = torch.clamp_min(counts - cap, 0).sum()
    recv = C.all_to_all_grad(send, mesh, axis)
    return recv.reshape(n_dev * cap, N_CHAN), overflow


def _slice_composite(ch, width: int, height: int, tile: int, max_per_tile: int,
                     max_tiles_per_gaussian: int, large_frac: float | None):
    """Bin and composite one depth slice over the full grid.  Returns
    ((T, P, 3) colour, (T, P) transmittance, binning)."""
    # K1 takes contiguous (N, .) tensors
    uv, conic, cols = ch[:, 0:2].contiguous(), ch[:, 2:5].contiguous(), ch[:, 5:8].contiguous()
    opac = ch[:, 8].contiguous()
    lit = opac > 0
    proj_slice = {"uv": uv.detach(), "conic": conic.detach(),
                  "depth": torch.where(lit, ch[:, 9], math.inf).detach(),
                  "radius": ch[:, 10].detach(), "in_front": lit}
    kw = {} if large_frac is None else {"large_frac": large_frac}
    binning = bin_gaussians(proj_slice, opac.detach(), width, height, tile, max_per_tile,
                            max_tiles_per_gaussian, **kw)
    grid_w, _ = _grid(width, height, tile)
    col, alp = composite_lists(uv, conic, cols, opac, binning.tile_lists,
                               binning.tile_counts, tile, grid_w)
    return col, 1.0 - alp, binning


def _merge_slices(col_s, trans_s, mesh: Mesh, axis: str):
    """Depth-ordered "over" merge of the ranks' slices.  Returns the
    replicated ((T, P, 3) colour, (T, P) alpha)."""
    all_col = C.all_gather_grad(col_s, mesh, axis)            # (D, T, P, 3)
    all_trans = C.all_gather_grad(trans_s, mesh, axis)        # (D, T, P)
    log_t = torch.log(torch.clamp_min(all_trans, 1e-20))
    cum = torch.cumsum(log_t, dim=0)
    t_excl = torch.exp(torch.cat([torch.zeros_like(cum[:1]), cum[:-1]], dim=0))
    color = torch.sum(all_col * t_excl[..., None], dim=0)
    return color, 1.0 - torch.exp(cum[-1])


def render_gaussian_sharded(means, rotations, scales, opacity, colors, camera: Camera,
                            width: int, height: int, mesh: Mesh, axis: str = "gauss",
                            background=None, tile: int = 16, max_per_tile: int = 512,
                            max_tiles_per_gaussian: int = 36,
                            slice_capacity_factor: float = 2.0, near: float = 0.01):
    """Rasterize with the gaussian axis sharded over `axis`: the inputs are
    this rank's (N/n, ...) shard.  Returns the replicated (image, aux)."""
    n_local = means.shape[0]
    cap = int(math.ceil(slice_capacity_factor * n_local))
    if background is None:
        background = torch.ones(3, dtype=torch.float32, device=means.device)
    proj = project_gaussians(camera, means, rotations, scales, near=near)
    live = proj["in_front"] & (opacity > 1.0 / 255.0)
    opac_eff = torch.where(live, opacity, 0.0)
    depth = torch.where(live, proj["depth"], math.inf).detach()
    ch, send_overflow = _route(proj, colors, opac_eff, live, depth, mesh, axis, cap)
    col_s, trans_s, binning = _slice_composite(ch, width, height, tile, max_per_tile,
                                               max_tiles_per_gaussian, None)
    color, alpha_t = _merge_slices(col_s, trans_s, mesh, axis)
    overflow = C.all_reduce_((binning.overflow + send_overflow).to(torch.int64), mesh, axis)
    img, alpha = assemble_tiles(color, alpha_t, width, height, tile)
    img = img + (1.0 - alpha)[..., None] * background
    return img, {"alpha": alpha, "overflow": overflow}


def _frame_loss(g, verts, faces, cam: Camera, gt, probe, mesh: Mesh, axis: str, cap: int,
                background, tile, max_per_tile, max_tiles_per_gaussian, large_frac,
                lambda_dssim):
    """One frame against this rank's gaussian shard: (loss, aux)."""
    from omfs4d_torch.models.gaussians import bind_to_mesh, eval_colors
    from omfs4d_torch.train.losses import dssim_loss

    width, height = cam.width, cam.height
    means, rot, scales, opac, _ = bind_to_mesh(g, verts, faces)
    cols = eval_colors(g, means, cam.position)
    proj = dict(project_gaussians(cam, means, rot, scales))
    proj["uv"] = proj["uv"] + probe
    live = proj["in_front"] & (opac > 1.0 / 255.0)
    opac_eff = torch.where(live, opac, 0.0)
    # depth-slice edges are a routing decision: no gradient through them
    depth_sg = proj["depth"].detach()
    ch, _ = _route(proj, cols, opac_eff, live, depth_sg, mesh, axis, cap)
    col_s, trans_s, binning = _slice_composite(ch, width, height, tile, max_per_tile,
                                               max_tiles_per_gaussian, large_frac)
    color, alpha_t = _merge_slices(col_s, trans_s, mesh, axis)
    img, a = assemble_tiles(color, alpha_t, width, height, tile)
    img = img + (1.0 - a)[..., None] * background
    l1 = torch.mean(torch.abs(img - gt))
    if lambda_dssim > 0.0:
        loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * dssim_loss(img, gt)
    else:
        loss = l1
    counters = torch.stack([binning.overflow, binning.window_clipped,
                            binning.spilled]).to(torch.int64)
    C.all_reduce_(counters, mesh, axis)
    return loss, counters, img


def avatar_loss_gaussian_sharded(gaussians, verts, faces, camera: Camera, gt_image,
                                 mesh: Mesh, axis: str = "gauss", background=None,
                                 tile: int = 16, max_per_tile: int = 512,
                                 max_tiles_per_gaussian: int = 16,
                                 slice_capacity_factor: float = 2.0,
                                 large_frac: float = 0.125, probe=None,
                                 lambda_dssim: float = 0.0, return_aux: bool = False,
                                 data_axis: str | None = None):
    """Photometric loss of a mesh-bound avatar with the gaussian axis sharded
    over `axis`: `gaussians` (a `GaussianAvatar` or `GaussianFields`) and
    `probe` ((N/n, 2), added to the screen-space means; its gradient is the
    densification pressure) are this rank's shard of capacity N/n.

    `data_axis` is the 2-D (data x gauss) mesh: `verts` (B, V, 3),
    `gt_image` (B, H, W, 3) and the camera's tensors (B, ...) are the whole
    batch, B the data-axis size, and data row d fits frame d against the
    gaussian shards; the loss is the mean over the frames.  The loss is
    replicated; each rank's gradients are those of the global loss with
    respect to its inputs: its shard, and the whole of `verts`.

    `return_aux` adds {"overflow", "window_clipped", "spilled"} summed over
    the mesh, and the rendered image of this rank's frame."""
    g = fields_of(gaussians)
    n_local = g.mu_local.shape[0]
    cap = int(math.ceil(slice_capacity_factor * n_local))
    dev = g.mu_local.device
    if background is None:
        background = torch.ones(3, dtype=torch.float32, device=dev)
    if probe is None:
        probe = torch.zeros((n_local, 2), dtype=torch.float32, device=dev)
    faces = torch.as_tensor(faces, device=dev)
    floats = {k: getattr(g, k) for k in ("mu_local", "quat_local", "log_scale",
                                         "opacity_logit", "color", "sh")}
    cam = camera
    gt = gt_image
    if data_axis is not None:
        # the gaussian shard and the probe are replicated over the data rows
        *fl, probe = C.replicated(mesh, data_axis, *floats.values(), probe)
        floats = dict(zip(floats, fl))
        d = mesh.axis_index(data_axis)
        (verts,) = C.replicated(mesh, data_axis, verts)
        verts, gt = verts[d], gt_image[d]
        cam = Camera(w2c=camera.w2c[d], fx=camera.fx[d], fy=camera.fy[d], cx=camera.cx[d],
                     cy=camera.cy[d], width=camera.width, height=camera.height)
    # every shard binds to the same mesh: verts is a replicated input
    (verts,) = C.replicated(mesh, axis, verts)
    g = fields_of(g, floats)
    loss, counters, img = _frame_loss(g, verts, faces, cam, gt, probe, mesh, axis, cap,
                                      background, tile, max_per_tile,
                                      max_tiles_per_gaussian, large_frac, lambda_dssim)
    if data_axis is not None:
        loss = C.pmean(loss, mesh, data_axis)
        C.all_reduce_(counters, mesh, data_axis)
    if not return_aux:
        return loss
    return loss, {"overflow": counters[0], "window_clipped": counters[1],
                  "spilled": counters[2], "image": img}
