"""Tile composite, forward and backward: the hand-written CUDA kernels K1
and K2 behind one `torch.autograd.Function`, and their plain PyTorch version.

Port of `omfs4d.render.pallas_kernels` (`composite_pallas` ->
`composite_tiles`, a `jax.custom_vjp` over `_call_fwd` / `_fwd_kernel` and
`_call_bwd` / `_bwd_kernel`).  The kernel sources are
`omfs4d_torch/csrc/composite_fwd.cu` (K1) and `composite_bwd.cu` (K2); their
headers say what bounds each on the card and what the design does about it.

`composite` is the wrapper.  A CPU tensor takes `composite_plain`, with
PyTorch autograd through it.  A CUDA tensor launches K1, through
`_Composite` when a gradient is wanted, whose backward launches K2, or the
call raises: there is no fallback.  The Function saves its inputs, the
image, and the per-pixel final transmittance T_tot and heaviest-first tile
order that K1 writes on request (no (T, K, P) residual): K2 recomputes
alpha, as the reference's backward does, in one front-to-back pass from
C_tot and T_tot.  `composite.launches` counts K1 launches,
`composite.backward_launches` K2.

`pack_lists` is the reference's `_pack_lists`: the (T, 9, K) per-tile table
that the TPU kernels read.  K1 and K2 gather from the (N, .) tensors
themselves; the packed table feeds the K2 ablation variants
(`omfs4d_torch.scripts.profile_composite_variants`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from omfs4d_torch import _build
from omfs4d_torch.render.rasterize import TileBinning, composite_reference

#: the kernel's plain PyTorch version: same arguments, same outputs
composite_plain = composite_reference

# rows of the packed (T, 9, K) table, in the reference's order
ROW_UX, ROW_UY = 0, 1
ROW_CA, ROW_CB, ROW_CC = 2, 3, 4
ROW_R, ROW_G, ROW_B = 5, 6, 7
ROW_OPAC = 8
N_ROWS = 9


def _gather_packed(params9: torch.Tensor, lists: torch.Tensor) -> torch.Tensor:
    """(N, 9) table + (T, K) per-tile indices -> (T, 9, K)."""
    return params9[lists.long()].transpose(1, 2)


def pack_lists(uv, conic, colors, opacity, lists, counts) -> torch.Tensor:
    """Gather the (T, 9, K) packed per-tile parameter table (rows ux, uy,
    conic a/b/c, r, g, b, opacity), with opacity 0 past each tile's count,
    so that those entries' alpha is exactly 0."""
    K = lists.shape[1]
    params9 = torch.cat([uv, conic, colors, opacity[:, None]], dim=1)
    packed = _gather_packed(params9, lists)
    k_valid = torch.arange(K, device=lists.device)[None, :] < counts[:, None]
    opac_row = torch.where(k_valid, packed[:, ROW_OPAC], 0.0)
    return torch.cat([packed[:, :ROW_OPAC], opac_row[:, None]], dim=1)


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


@functools.cache
def _kernel():
    fn = _build.load_library().omfs4d_composite_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load_library().omfs4d_composite_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _error_string(err: int) -> str:
    fn = _build.load_library().omfs4d_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def launch_on(device: torch.device, kernel, *args) -> int:
    """kernel(*args, stream) on `device`'s current stream, with `device`
    made current for the call only when it is not already.  The stream's
    handle comes as a raw int (`torch.cuda.current_stream().cuda_stream`
    builds a Stream object first, ~8 us of host time on an H100's host)."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        return kernel(*args, stream)
    with torch.cuda.device(device):
        return kernel(*args, stream)


_F32, _I32 = torch.float32, torch.int32
_NAMES = ("uv", "conic", "colors", "opacity", "tile_lists", "tile_counts")


def _check_inputs(uv, conic, colors, opacity, lists, counts, width, height,
                  tile, tile_base):
    named = (uv, conic, colors, opacity, lists, counts)
    dev = uv.device
    for i, t in enumerate(named):
        if (t.dtype is not (_I32 if i >= 4 else _F32) or t.device != dev
                or not t.is_contiguous() or _device_type(t) != "cuda"):
            _refuse(_NAMES[i], t, uv)
    n = uv.shape[0]
    shapes_ok = (uv.shape == (n, 2) and conic.shape == (n, 3)
                 and colors.shape == (n, 3) and opacity.shape == (n,)
                 and lists.ndim == 2 and counts.shape == lists.shape[:1])
    if not shapes_ok or n == 0 or lists.shape[0] == 0 or lists.shape[1] == 0:
        raise ValueError(
            "composite: expected uv (N, 2), conic (N, 3), colors (N, 3), "
            "opacity (N,), tile_lists (T, K), tile_counts (T,) with N, T, K "
            f">= 1; got {[tuple(t.shape) for t in named]}")
    grid_w = (width + tile - 1) // tile
    num_tiles = grid_w * ((height + tile - 1) // tile)
    if not 1 <= tile * tile <= 1024:
        raise ValueError(f"composite: tile {tile} gives {tile * tile} pixels "
                         "per block; the kernels take 1..1024")
    if tile_base < 0 or tile_base + lists.shape[0] > num_tiles:
        raise ValueError(f"composite: tiles {tile_base}..{tile_base + lists.shape[0] - 1} "
                         f"outside the {num_tiles}-tile grid")
    return grid_w


def _refuse(name, t, uv):
    if _device_type(t) != "cuda" or t.device != uv.device:
        raise ValueError(f"composite: {name} is on {t.device}, expected "
                         f"the CUDA device of uv ({uv.device})")
    if not t.is_contiguous():
        raise ValueError(f"composite: {name} must be contiguous")
    want = _I32 if name.startswith("tile_") else _F32
    raise ValueError(f"composite: {name} is {t.dtype}, expected {want}")


def _launch_fwd(uv, conic, colors, opacity, lists, counts, width, height,
                tile, tile_base, grid_w, residual=False):
    """K1 on checked inputs.  Returns (image (H, W, 3), alpha (H, W), the
    residual K2 reads or None): with `residual`, (T_tot (H, W), the
    heaviest-first order of the list rows (T,) that K1 took them in)."""
    kernel = _kernel()
    dev = uv.device
    n_lists = lists.shape[0]
    # every pixel is written when the lists cover the whole grid
    full = tile_base == 0 and n_lists == grid_w * ((height + tile - 1) // tile)
    alloc = torch.empty if full else torch.zeros
    img = alloc((height, width, 3), dtype=_F32, device=dev)
    alpha = alloc((height, width), dtype=_F32, device=dev)
    trans = torch.empty((height, width), dtype=_F32, device=dev) if residual else None
    order = torch.empty(n_lists, dtype=_I32, device=dev)
    err = launch_on(dev, kernel, uv.data_ptr(), conic.data_ptr(), colors.data_ptr(),
                    opacity.data_ptr(), lists.data_ptr(), counts.data_ptr(),
                    uv.shape[0], n_lists, lists.shape[1], tile_base, tile, grid_w,
                    width, height, img.data_ptr(), alpha.data_ptr(),
                    None if trans is None else trans.data_ptr(), order.data_ptr())
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: {_error_string(err)} ({err})")
    composite.launches += 1
    return img, alpha, (trans, order) if residual else None


def _launch_bwd(uv, conic, colors, opacity, lists, counts, img, trans, order, dimg, dalpha,
                width, height, tile, tile_base, grid_w):
    """K2 on checked inputs, the forward's image and residual (T_tot and the
    order, `_launch_fwd` with `residual`) and the cotangents.  Returns the
    gradients of uv, conic, colors and opacity: views of one (N, 9) buffer."""
    if dimg.shape != (height, width, 3) or dalpha.shape != (height, width):
        raise ValueError(f"composite backward: cotangents {tuple(dimg.shape)}, "
                         f"{tuple(dalpha.shape)} for a {height}x{width} image")
    dimg = dimg.to(_F32).contiguous()
    dalpha = dalpha.to(_F32).contiguous()
    kernel = _bwd_kernel()
    grad = torch.zeros((uv.shape[0], N_ROWS), dtype=_F32, device=uv.device)
    err = launch_on(uv.device, kernel, uv.data_ptr(), conic.data_ptr(), colors.data_ptr(),
                    opacity.data_ptr(), lists.data_ptr(), counts.data_ptr(),
                    dimg.data_ptr(), dalpha.data_ptr(), img.data_ptr(), trans.data_ptr(),
                    order.data_ptr(),
                    uv.shape[0], lists.shape[0], lists.shape[1], tile_base, tile,
                    grid_w, width, height, grad.data_ptr())
    if err != 0:
        raise RuntimeError(f"composite_bwd launch failed: {_error_string(err)} ({err})")
    composite.backward_launches += 1
    return (grad[:, ROW_UX:ROW_UY + 1], grad[:, ROW_CA:ROW_CC + 1],
            grad[:, ROW_R:ROW_B + 1], grad[:, ROW_OPAC])


class _Composite(torch.autograd.Function):
    """K1 forward, K2 backward.  Saves the inputs, the lists, the image and
    K1's T_tot and tile order: K2 walks each list once from them.  An in-place edit of the
    returned image before the backward makes autograd raise."""

    @staticmethod
    def forward(ctx, uv, conic, colors, opacity, lists, counts, width, height,
                tile, tile_base, grid_w):
        img, alpha, (trans, order) = _launch_fwd(uv, conic, colors, opacity, lists, counts,
                                                 width, height, tile, tile_base, grid_w,
                                                 residual=True)
        ctx.save_for_backward(uv, conic, colors, opacity, lists, counts, img, trans, order)
        ctx.geometry = (width, height, tile, tile_base, grid_w)
        return img, alpha

    @staticmethod
    def backward(ctx, dimg, dalpha):
        grads = _launch_bwd(*ctx.saved_tensors, dimg, dalpha, *ctx.geometry)
        return *grads, *([None] * 7)


def composite(uv, conic, colors, opacity, binning: TileBinning,
              width: int, height: int, tile: int = 16, tile_base: int = 0):
    """Front-to-back composite of per-tile lists, differentiable with
    respect to uv, conic, colors and opacity.

    uv (N, 2), conic (N, 3), colors (N, 3), opacity (N,) float32; binning
    holds tile_lists (T, K) and tile_counts (T,) int32 for tiles
    `tile_base .. tile_base + T - 1` of the image.  Returns (image (H, W, 3),
    alpha (H, W)) float32, 0 outside those tiles; no background blend.
    """
    if _device_type(uv) == "cpu":
        return composite_plain(uv, conic, colors, opacity, binning,
                               width, height, tile, tile_base)
    lists, counts = binning.tile_lists, binning.tile_counts
    grid_w = _check_inputs(uv, conic, colors, opacity, lists, counts,
                           width, height, tile, tile_base)
    if torch.is_grad_enabled() and (uv.requires_grad or conic.requires_grad
                                    or colors.requires_grad or opacity.requires_grad):
        return _Composite.apply(uv, conic, colors, opacity, lists, counts,
                                width, height, tile, tile_base, grid_w)
    # no graph (inference_mode, no_grad, constants): no residual either
    img, alpha, _ = _launch_fwd(uv, conic, colors, opacity, lists, counts, width,
                                height, tile, tile_base, grid_w)
    return img, alpha


composite.launches = 0
composite.backward_launches = 0
