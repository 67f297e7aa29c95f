"""Take the composite backward's cost apart on the card: the K2 ablation
variants (kernel V), beside K1, K2 and the binning sort.

    python -m omfs4d_torch.scripts.profile_composite_variants

Port of `scripts/profile_composite_variants.py`, which keeps its names.  It
times, on one seeded table of T = 1024 tiles at full occupancy (K = 512,
P = 256 pixels a tile), the forward K1 and backward K2 alone ("current"; the
table given as T*K gaussians with identity lists), the five ablations of the backward that
kernel V computes (`omfs4d_torch/csrc/composite_variants.cu`, whose header
says what each mode keeps), and the binning sort at the reference's sizes.
Times are medians of CUDA-event laps on the card named in the first line.
With no CUDA card it exits non-zero and prints no table.

`make_variant_kernel(mode)` is V's wrapper: a CUDA tensor launches V or the
call raises; a CPU tensor takes `variant_plain`, its plain PyTorch version
(dense (P, K) tensors per tile, as the reference's body).  `launches` counts
V's launches per mode.
"""

from __future__ import annotations

import ctypes
import functools
import statistics
import subprocess
import sys

import numpy as np
import torch

from omfs4d_torch import _build
from omfs4d_torch.render import composite as _composite
from omfs4d_torch.render.composite import (N_ROWS, ROW_B, ROW_CA, ROW_CB, ROW_CC,
                                           ROW_OPAC, ROW_R, ROW_UX, ROW_UY)
from omfs4d_torch.render.rasterize import ALPHA_CAP, ALPHA_CUTOFF, TileBinning

T, K, TILE = 1024, 512, 16
GRID_W = 32
P = TILE * TILE
N_PAIRS = 131_072 * 16       # the sort rows' pair count (2.1 M)
MODES = ("copy", "elementwise", "matmuls", "bf16_matmuls", "full_bf16")

#: V against variant_plain (`compare`; tests/test_torch_composite_variants.py
#: derives it): copy exact; in every other mode, the bf16 ones included,
#: each element within atol * s + rtol * |plain|, s its row's scale
#: (`row_scale`), with the reference's gradient bound (atol, rtol).
BOUND = (2e-4, 2e-3)

#: V launches per mode
launches = dict.fromkeys(MODES, 0)

_PLAIN_ELEMS = 1 << 24       # (tiles, P, K) elements per chunk of the plain version


@functools.cache
def _kernel():
    fn = _build.load_library().omfs4d_composite_variant
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(packed, dcol, dalpha, tile, grid_w):
    dev = packed.device
    for t in (packed, dcol, dalpha):
        if (t.dtype is not torch.float32 or t.device != dev or not t.is_contiguous()
                or _composite._device_type(t) != "cuda"):
            _refuse(packed, dcol, dalpha)
    n, _, k = packed.shape
    p = tile * tile
    if (packed.shape != (n, N_ROWS, k) or dcol.shape != (n, 3, p)
            or dalpha.shape != (n, 1, p) or n == 0 or k == 0):
        raise ValueError(
            f"composite variant: expected packed (T, {N_ROWS}, K), dcol (T, 3, {p}), "
            f"dalpha (T, 1, {p}) with T, K >= 1; got "
            f"{[tuple(t.shape) for t in (packed, dcol, dalpha)]}")
    if not 1 <= p <= 1024 or grid_w < 1:
        raise ValueError(f"composite variant: tile {tile} ({p} threads a block, the "
                         f"kernel takes 1..1024), grid_w {grid_w}")


def _refuse(packed, dcol, dalpha):
    for name, t in {"packed": packed, "dcol": dcol, "dalpha": dalpha}.items():
        if _composite._device_type(t) != "cuda" or t.device != packed.device:
            raise ValueError(f"composite variant: {name} is on {t.device}, expected "
                             f"the CUDA device of packed ({packed.device})")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"composite variant: {name} must be contiguous float32, "
                             f"got {t.dtype}")


def make_variant_kernel(mode: str):
    """mode: copy | elementwise | matmuls | bf16_matmuls | full_bf16.

    Returns call(packed (T, 9, K), dcol (T, 3, P), dalpha (T, 1, P),
    tile=TILE, grid_w=GRID_W) -> (T, 9, K) float32."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    mode_id = MODES.index(mode)

    def call(packed, dcol, dalpha, tile: int = TILE, grid_w: int = GRID_W):
        if _composite._device_type(packed) == "cpu":
            return variant_plain(mode, packed, dcol, dalpha, tile, grid_w)
        _check_inputs(packed, dcol, dalpha, tile, grid_w)
        kernel = _kernel()
        out = torch.empty_like(packed)
        err = _composite.launch_on(packed.device, kernel, mode_id, packed.data_ptr(),
                                   dcol.data_ptr(), dalpha.data_ptr(), packed.shape[0],
                                   packed.shape[2], tile, grid_w, out.data_ptr())
        if err != 0:
            raise RuntimeError(f"composite_variant launch failed: "
                               f"{_composite._error_string(err)} ({err})")
        launches[mode] += 1
        return out

    return call


def _excl_prefix(v: torch.Tensor) -> torch.Tensor:
    """out[..., k] = sum_{j<k} v[..., j]"""
    out = torch.zeros_like(v)
    out[..., 1:] = torch.cumsum(v, dim=-1)[..., :-1]
    return out


def _excl_suffix(v: torch.Tensor) -> torch.Tensor:
    """out[..., k] = sum_{j>k} v[..., j]"""
    out = torch.zeros_like(v)
    out[..., :-1] = torch.flip(torch.cumsum(torch.flip(v, [-1]), dim=-1), [-1])[..., 1:]
    return out


def _variant_tiles(mode, packed, dcol, dalpha, t0, tile, grid_w, rounded):
    """The reference's body on tiles t0 .. t0 + len(packed) - 1."""
    n, _, k = packed.shape
    rnd = ((lambda v: v.to(torch.bfloat16).to(v.dtype))
           if rounded and mode in ("bf16_matmuls", "full_bf16") else (lambda v: v))
    tid = torch.arange(t0, t0 + n, device=packed.device)[:, None]
    pid = torch.arange(tile * tile, device=packed.device)
    x = ((tid % grid_w) * tile + pid % tile).to(packed.dtype)[..., None] + 0.5   # (n, P, 1)
    y = ((tid // grid_w) * tile + pid // tile).to(packed.dtype)[..., None] + 0.5

    def row(r):
        return packed[:, r, None, :]                                         # (n, 1, K)

    ca, cb, cc, o = row(ROW_CA), row(ROW_CB), row(ROW_CC), row(ROW_OPAC)
    dx, dy = x - row(ROW_UX), y - row(ROW_UY)                               # (n, P, K)
    power = torch.clamp_max(-0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy, 0.0)
    a_full = o * torch.exp(power)
    capped = a_full > ALPHA_CAP
    a = torch.where(capped, ALPHA_CAP, a_full)
    cut = a < ALPHA_CUTOFF
    a = torch.where(cut, 0.0, a)
    grad_ok = ~(capped | cut)
    one_minus = torch.clamp_min(1.0 - a, 1e-6)
    lg = torch.log(one_minus)
    colors = packed[:, ROW_R:ROW_B + 1]                                     # (n, 3, K)
    dA = dalpha.reshape(n, -1, 1)                                           # (n, P, 1)
    zeros = torch.zeros((n, 1, k), dtype=packed.dtype, device=packed.device)

    if mode in ("matmuls", "bf16_matmuls", "full_bf16"):
        t_excl = torch.exp(_excl_prefix(rnd(lg)))
        w = a * t_excl
        dcol_r, colors_r = rnd(dcol), rnd(colors)
        dw = sum(dcol_r[:, c, :, None] * colors_r[:, c, None, :] for c in range(3))
        m = rnd(dw * w)
        suffix = _excl_suffix(m)
        dcolors = torch.matmul(dcol_r, rnd(w))                              # (n, 3, K)
        if mode != "full_bf16":
            return torch.cat([suffix.sum(1, keepdim=True), zeros.expand(n, 5, k),
                              dcolors], dim=1)
    else:  # elementwise: stand-ins for the scans
        t_excl = one_minus
        suffix = a * 0.5
        dw = a + 0.1
    t_total = torch.exp(lg.sum(-1, keepdim=True))
    da = dw * t_excl - suffix / one_minus + dA * t_total / one_minus
    da = torch.where(grad_ok, da, 0.0)
    e = a_full / torch.clamp_min(o, 1e-12)
    do = (da * e).sum(1, keepdim=True)
    dq = da * a_full
    d_geom = [(dq * (ca * dx + cb * dy)).sum(1, keepdim=True),
              (dq * (cc * dy + cb * dx)).sum(1, keepdim=True),
              (dq * (-0.5 * dx * dx)).sum(1, keepdim=True),
              (dq * (-dx * dy)).sum(1, keepdim=True),
              (dq * (-0.5 * dy * dy)).sum(1, keepdim=True)]
    middle = zeros.expand(n, 3, k) if mode == "elementwise" else dcolors
    return torch.cat([*d_geom, middle, do], dim=1)


def variant_plain(mode: str, packed, dcol, dalpha, tile: int = TILE, grid_w: int = GRID_W,
                  rounded: bool = True):
    """The plain PyTorch version of V: the reference's per-tile body on dense
    (P, K) tensors, in chunks of tiles so that T = 1024, K = 512 fits, with
    the same bf16 roundings.  rounded=False leaves them out: the control
    that `compare` must reject in the bf16 modes."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if mode == "copy":
        return packed * 2.0
    n, _, k = packed.shape
    chunk = max(1, _PLAIN_ELEMS // (tile * tile * k))
    return torch.cat([_variant_tiles(mode, packed[s:s + chunk], dcol[s:s + chunk],
                                     dalpha[s:s + chunk], s, tile, grid_w, rounded)
                      for s in range(0, n, chunk)])


def row_scale(ref: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """s per element of a (T, 9, K) output: max |ref| over its row of its
    tile, taken apart over the entries whose conic is indefinite
    (ca * cc < cb^2; power clamps to 0, so a = o at any distance and their
    geometry gradients grow with the squared distance, ~1e6 times the
    others' on the reference's table) and over the rest."""
    indefinite = (packed[:, ROW_CA] * packed[:, ROW_CC] < packed[:, ROW_CB] ** 2)[:, None]
    mag = ref.abs()
    s_indef = torch.where(indefinite, mag, 0.0).amax(-1, keepdim=True)
    s_rest = torch.where(indefinite, 0.0, mag).amax(-1, keepdim=True)
    return torch.where(indefinite, s_indef, s_rest)


def compare(mode: str, got: torch.Tensor, ref: torch.Tensor, packed: torch.Tensor) -> dict:
    """V's output `got` against variant_plain's `ref` on the table `packed`:
    max_abs_err, the largest |got - ref|; outside, the elements outside the
    bound (NaN included), and their share of ref's nonzero elements; ok."""
    diff = (got - ref).abs()
    if mode == "copy":
        bad = got != ref
    else:
        bad = ~(diff <= BOUND[0] * row_scale(ref, packed) + BOUND[1] * ref.abs())
    outside = int(bad.sum())
    return {"max_abs_err": diff.max().item() if diff.numel() else 0.0, "outside": outside,
            "share": outside / max(1, int((ref != 0).sum())), "ok": outside == 0}


def synthetic_inputs(seed: int = 0, T: int = T, K: int = K):
    """The reference script's inputs (its `main()`), as numpy: the packed
    (T, 9, K) table with every entry live, the cotangents dcol (T, 3, P) and
    dalpha (T, 1, P), and the int32 sort keys of its sort rows."""
    rng = np.random.default_rng(seed)
    packed = np.zeros((T, N_ROWS, K), np.float32)
    packed[:, 0] = rng.uniform(0, 512, (T, K))       # ux
    packed[:, 1] = rng.uniform(0, 512, (T, K))       # uy
    packed[:, 2] = rng.uniform(0.01, 0.3, (T, K))    # ca
    packed[:, 3] = rng.uniform(-0.05, 0.05, (T, K))  # cb
    packed[:, 4] = rng.uniform(0.01, 0.3, (T, K))    # cc
    packed[:, 5:8] = rng.uniform(0, 1, (T, 3, K))
    packed[:, 8] = rng.uniform(0, 0.9, (T, K))       # opacity (all "live")
    dcol = rng.normal(0, 1, (T, 3, P)).astype(np.float32)
    dalpha = rng.normal(0, 1, (T, 1, P)).astype(np.float32)
    keys = rng.integers(0, 2**31, N_PAIRS).astype(np.int32)
    return packed, dcol, dalpha, keys


def as_gaussians(packed: torch.Tensor):
    """The packed table as N = T*K gaussians, with identity lists (tile t
    holds gaussians t*K .. t*K + K - 1) and every count K: the arguments of
    `composite` that make K1 and K2 walk the same entries as V."""
    n, _, k = packed.shape
    flat = packed.transpose(1, 2).reshape(n * k, N_ROWS)
    lists = torch.arange(n * k, dtype=torch.int32, device=packed.device).reshape(n, k)
    counts = torch.full((n,), k, dtype=torch.int32, device=packed.device)
    zero = torch.zeros((), dtype=torch.int32, device=packed.device)
    return (flat[:, ROW_UX:ROW_UY + 1].contiguous(), flat[:, ROW_CA:ROW_CC + 1].contiguous(),
            flat[:, ROW_R:ROW_B + 1].contiguous(), flat[:, ROW_OPAC].contiguous(),
            TileBinning(lists, counts, zero, zero, zero))


def to_image(dcol: torch.Tensor, dalpha: torch.Tensor, tile: int = TILE,
             grid_w: int = GRID_W):
    """Per-tile (T, 3, P) and (T, 1, P) -> image (H, W, 3) and (H, W), as the
    reference's composite_pallas assembles its tiles."""
    grid_h = dcol.shape[0] // grid_w
    img = dcol.reshape(grid_h, grid_w, 3, tile, tile).permute(0, 3, 1, 4, 2)
    alpha = dalpha.reshape(grid_h, grid_w, tile, tile).permute(0, 2, 1, 3)
    return (img.reshape(grid_h * tile, grid_w * tile, 3).contiguous(),
            alpha.reshape(grid_h * tile, grid_w * tile).contiguous())


def to_tiles(img: torch.Tensor, alpha: torch.Tensor, tile: int = TILE):
    """The inverse of `to_image`, for an image of whole tiles."""
    height, width = alpha.shape
    if height % tile or width % tile:
        raise ValueError(f"to_tiles: {height}x{width} is not whole {tile}-px tiles")
    gh, gw = height // tile, width // tile
    dcol = img.reshape(gh, tile, gw, tile, 3).permute(0, 2, 4, 1, 3)
    da = alpha.reshape(gh, tile, gw, tile).permute(0, 2, 1, 3)
    return (dcol.reshape(gh * gw, 3, tile * tile).contiguous(),
            da.reshape(gh * gw, 1, tile * tile).contiguous())


def timed(fn, *args, n: int = 30, label: str = "") -> float:
    """Median ms of `n` calls of fn(*args) after one warm-up, each between
    two CUDA events on the current stream; prints a line when labelled."""
    fn(*args)
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    dt = statistics.median(times)
    if label:
        print(f"{label:<44s} {dt:8.4f} ms", flush=True)
    return dt


def current_times(uv, conic, colors, opacity, binning, width, height, dimg, dalpha,
                  n: int = 30, labelled: bool = False) -> tuple[float, float]:
    """K1 and K2 on the same inputs, each through the launch function that
    `composite`'s autograd Function calls (checked inputs, outputs
    allocated, the kernel), as the reference times `_call_fwd` and
    `_call_bwd` alone: K1 writing the residual as it does under autograd,
    K2 taking that forward's image and residual and the cotangents
    dimg (H, W, 3) and dalpha (H, W).  In ms."""
    lists, counts = binning.tile_lists, binning.tile_counts
    grid_w = _composite._check_inputs(uv, conic, colors, opacity, lists, counts,
                                      width, height, TILE, 0)
    geometry = (width, height, TILE, 0, grid_w)
    fwd_ms = timed(lambda: _composite._launch_fwd(uv, conic, colors, opacity, lists, counts,
                                                  *geometry, residual=True),
                   n=n, label="fwd (current)" if labelled else "")
    img, _, res = _composite._launch_fwd(uv, conic, colors, opacity, lists, counts,
                                         *geometry, residual=True)
    bwd_ms = timed(_composite._launch_bwd, uv, conic, colors, opacity, lists, counts,
                   img, *res, dimg, dalpha, *geometry, n=n,
                   label="bwd (current)" if labelled else "")
    return fwd_ms, bwd_ms


def _sort_gather(keys, payload):
    """bin_gaussians' sort: a stable sort of the keys, the payload gathered
    by the order."""
    s_keys, order = torch.sort(keys, dim=-1, stable=True)
    return s_keys, torch.gather(payload, -1, order)


def sort_rows(keys: torch.Tensor, n: int = 30) -> dict[str, float]:
    """The reference's sort rows on the card: 2.1 M, 1.05 M and 0.52 M pairs,
    segmented 32 x 65,536 and 1024 x 2048, and 131,072 gaussians."""
    payload = torch.arange(keys.numel(), dtype=torch.int32, device=keys.device)
    half, qtr = keys.numel() // 2, keys.numel() // 4
    rows = {f"torch.sort {keys.numel() / 1e6:.1f}M pairs": (keys, payload),
            f"torch.sort {half / 1e6:.2f}M pairs": (keys[:half], payload[:half]),
            f"torch.sort {qtr / 1e6:.2f}M pairs": (keys[:qtr], payload[:qtr]),
            "torch.sort 32 x 65k (segmented)": (keys.reshape(32, -1), payload.reshape(32, -1)),
            "torch.sort 1024 x 2048 (per-tile-ish)": (keys.reshape(1024, -1),
                                                      payload.reshape(1024, -1)),
            "torch.sort 131k (gaussian-level)": (keys[:131_072], payload[:131_072])}
    return {label: timed(_sort_gather, *args, n=n, label=label)
            for label, args in rows.items()}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
                             capture_output=True, text=True, timeout=60)
        line = res.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    return line or f"{torch.cuda.get_device_name()}, power limit not read"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_composite_variants: no CUDA device; this profiler runs only "
              "on a card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    packed, dcol, dalpha, keys = (torch.from_numpy(a).to(device) for a in synthetic_inputs(0))
    print(f"card: {card_line()}")
    print(f"T={T} K={K} P={P} (all tiles at full occupancy); median of 30 CUDA-event "
          "laps each", flush=True)
    dimg, dA = to_image(dcol, dalpha)
    current_times(*as_gaussians(packed), GRID_W * TILE, (T // GRID_W) * TILE, dimg, dA,
                  labelled=True)
    for mode in MODES:
        timed(make_variant_kernel(mode), packed, dcol, dalpha,
              label=f"bwd variant: {mode}")
    sort_rows(keys)
    return 0


if __name__ == "__main__":
    sys.exit(main())
