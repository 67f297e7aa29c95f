"""Forward tile composite: the hand-written CUDA kernel K1 and its plain
PyTorch version.

Port of the forward half of `omfs4d.render.pallas_kernels`
(`composite_pallas` -> `_call_fwd` -> `_fwd_kernel`).  The kernel source is
`omfs4d_torch/csrc/composite_fwd.cu`; its header says what bounds it on the
card and what the design does about that.

`composite` is the wrapper.  A CPU tensor takes `composite_plain`.  A CUDA
tensor launches the kernel, or the call raises: there is no fallback.  The
gradient (kernel K2) is not ported yet, so an input that requires grad
while grad is enabled is refused rather than silently cut off.
`composite.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from omfs4d_torch import _build
from omfs4d_torch.render.rasterize import TileBinning, composite_reference

#: the kernel's plain PyTorch version: same arguments, same outputs
composite_plain = composite_reference


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


@functools.cache
def _kernel():
    fn = _build.load_library().omfs4d_composite_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def _error_string(err: int) -> str:
    fn = _build.load_library().omfs4d_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def _check_inputs(uv, conic, colors, opacity, lists, counts, width, height,
                  tile, tile_base):
    named = {"uv": uv, "conic": conic, "colors": colors, "opacity": opacity,
             "tile_lists": lists, "tile_counts": counts}
    for name, t in named.items():
        if _device_type(t) != "cuda" or t.device != uv.device:
            raise ValueError(f"composite: {name} is on {t.device}, expected "
                             f"the CUDA device of uv ({uv.device})")
        if not t.is_contiguous():
            raise ValueError(f"composite: {name} must be contiguous")
        want = torch.int32 if name.startswith("tile_") else torch.float32
        if t.dtype != want:
            raise ValueError(f"composite: {name} is {t.dtype}, expected {want}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in named.values()):
        raise ValueError("composite: the CUDA kernel has no backward yet; call it "
                         "under torch.no_grad() / inference_mode()")
    n = uv.shape[0]
    shapes_ok = (uv.shape == (n, 2) and conic.shape == (n, 3)
                 and colors.shape == (n, 3) and opacity.shape == (n,)
                 and lists.ndim == 2 and counts.shape == lists.shape[:1])
    if not shapes_ok or n == 0 or lists.shape[0] == 0 or lists.shape[1] == 0:
        raise ValueError(
            "composite: expected uv (N, 2), conic (N, 3), colors (N, 3), "
            "opacity (N,), tile_lists (T, K), tile_counts (T,) with N, T, K "
            f">= 1; got {[tuple(t.shape) for t in named.values()]}")
    grid_w = (width + tile - 1) // tile
    num_tiles = grid_w * ((height + tile - 1) // tile)
    if not 1 <= tile * tile <= 1024:
        raise ValueError(f"composite: tile {tile} gives {tile * tile} threads "
                         "per block; the kernel takes 1..1024")
    if tile_base < 0 or tile_base + lists.shape[0] > num_tiles:
        raise ValueError(f"composite: tiles {tile_base}..{tile_base + lists.shape[0] - 1} "
                         f"outside the {num_tiles}-tile grid")
    return grid_w


def composite(uv, conic, colors, opacity, binning: TileBinning,
              width: int, height: int, tile: int = 16, tile_base: int = 0):
    """Front-to-back composite of per-tile lists.

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
    kernel = _kernel()
    img = torch.zeros((height, width, 3), dtype=torch.float32, device=uv.device)
    alpha = torch.zeros((height, width), dtype=torch.float32, device=uv.device)
    with torch.cuda.device(uv.device):
        err = kernel(uv.data_ptr(), conic.data_ptr(), colors.data_ptr(),
                     opacity.data_ptr(), lists.data_ptr(), counts.data_ptr(),
                     uv.shape[0], lists.shape[0], lists.shape[1], tile_base, tile,
                     grid_w, width, height, img.data_ptr(), alpha.data_ptr(),
                     torch.cuda.current_stream(uv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: {_error_string(err)} ({err})")
    composite.launches += 1
    return img, alpha


composite.launches = 0
