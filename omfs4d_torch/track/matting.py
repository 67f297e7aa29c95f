"""Foreground matting -> fg_masks (pluggable stage), port of
`omfs4d.track.matting`.

Masks are an input contract, not core compute, so this module provides a
registry: any callable (frames (T, H, W, 3) uint8) -> (T, H, W) float mask
can plug in.  Built-ins:

  * ``border_color``: the subject is centred, so the frame border is
    background.  k colour modes are fitted to border pixels on the host; the
    per-pixel classification runs on the device (only the uint8 frames go up
    and the binary mask comes back);
  * ``median_background``: a static-camera background model (per-pixel
    temporal median) + colour-distance threshold + box-blur cleanup, on the
    host;
  * ``neural``: the self-trained matting net (`track/segnet.py`);
  * ``none``: full-foreground masks.

`border_color` and `neural` take `device=`: None takes the CUDA card and
raises when there is none.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from omfs4d_torch.core.device import resolve_device

_MATTERS: dict[str, Callable] = {}


def register_matting(name: str):
    def deco(fn: Callable):
        _MATTERS[name] = fn
        return fn
    return deco


def _box_blur(mask: np.ndarray, k: int = 5) -> np.ndarray:
    """Separable box blur via cumulative sums, edges clamped."""
    pad = k // 2
    out = mask.astype(np.float32)
    for axis in (-2, -1):
        p = np.take(out, np.clip(np.arange(-pad, out.shape[axis] + pad),
                                 0, out.shape[axis] - 1), axis=axis)
        c = np.cumsum(p, axis=axis)
        lead = np.take(c, np.arange(k - 1, k - 1 + out.shape[axis]), axis=axis)
        lag = np.concatenate([
            np.zeros_like(np.take(c, [0], axis=axis)),
            np.take(c, np.arange(0, out.shape[axis] - 1), axis=axis),
        ], axis=axis)
        out = (lead - lag) / k
    return out


@register_matting("none")
def _full_fg(frames: np.ndarray, **_) -> np.ndarray:
    return np.ones(frames.shape[:3], dtype=np.float32)


def _box_blur_torch(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Batched (T, H, W) separable box blur: the tensor twin of `_box_blur`."""
    pad = k // 2
    out = mask
    for axis in (-2, -1):
        n = out.shape[axis]
        idx = torch.clamp(torch.arange(-pad, n + pad, device=mask.device), 0, n - 1)
        c = torch.cumsum(torch.index_select(out, axis, idx), dim=axis)
        lead = c.narrow(axis, k - 1, n)
        lag = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c.narrow(axis, 0, n - 1)],
                        dim=axis)
        out = (lead - lag) / k
    return out


def _classify_device(frames: np.ndarray, centers: np.ndarray, threshold: float,
                     smooth: int, device: torch.device) -> np.ndarray:
    """Distance-to-nearest-colour-mode foreground test on `device`: a pixel
    is foreground when its squared RGB distance to every centre exceeds
    threshold^2; then a box blur and a 0.5 cut."""
    f = torch.as_tensor(frames).to(device).to(torch.float32)
    cs = torch.as_tensor(np.asarray(centers, np.float32)).to(device)
    d2min = torch.full(f.shape[:3], float("inf"), dtype=torch.float32, device=device)
    for i in range(cs.shape[0]):
        diff = f - cs[i]
        d2min = torch.minimum(d2min, torch.sum(diff * diff, dim=-1))
    m = (d2min > float(threshold) ** 2).to(torch.float32)
    if smooth > 1:
        m = (_box_blur_torch(m, int(smooth)) > 0.5).to(torch.float32)
    return m.cpu().numpy()


@register_matting("median_background")
def _median_background(
    frames: np.ndarray,
    threshold: float = 30.0,
    sample_every: int = 5,
    smooth: int = 7,
    **_,
) -> np.ndarray:
    """Static-camera matting: the per-pixel temporal median is the
    background; pixels further than `threshold` (L2 in RGB) are foreground."""
    f = frames.astype(np.float32)
    bg = np.median(f[::max(sample_every, 1)], axis=0)          # (H, W, 3)
    dist = np.linalg.norm(f - bg[None], axis=-1)               # (T, H, W)
    mask = (dist > threshold).astype(np.float32)
    if smooth > 1:
        mask = np.stack([_box_blur(m, smooth) for m in mask])
        mask = (mask > 0.5).astype(np.float32)
    return mask


def border_centers(frames: np.ndarray, border: int = 8, k: int = 4) -> np.ndarray:
    """k colour modes of the frames' border pixels (Lloyd k-means on the
    host, seeded: the centres are the reference's to the bit)."""
    # border pixels only: converting the whole (T, H, W, 3) volume to f32 on
    # the host costs seconds of page faults for nothing
    bp = np.concatenate([
        frames[:, :border].reshape(-1, 3),
        frames[:, -border:].reshape(-1, 3),
        frames[:, :, :border].reshape(-1, 3),
        frames[:, :, -border:].reshape(-1, 3),
    ]).astype(np.float32)
    rng = np.random.default_rng(0)
    sample = bp[rng.choice(len(bp), size=min(len(bp), 20_000), replace=False)]
    centers = sample[rng.choice(len(sample), size=k, replace=False)]
    for _ in range(10):
        d = np.linalg.norm(sample[:, None] - centers[None], axis=-1)
        assign = d.argmin(1)
        for j in range(k):
            sel = sample[assign == j]
            if len(sel):
                centers[j] = sel.mean(0)
    return centers.astype(np.float32)


@register_matting("border_color")
def _border_color(
    frames: np.ndarray,
    threshold: float = 35.0,
    border: int = 8,
    k: int = 4,
    smooth: int = 5,
    keep_largest: bool = True,
    device: str | torch.device | None = None,
    **_,
) -> np.ndarray:
    """Head-video matting: fits k colour modes to border pixels and
    classifies pixels by distance to the nearest mode; keeps the largest
    connected foreground component and fills holes.

    This is the right default for a static selfie video with the subject
    centred, where a temporal-median background model would absorb the
    subject."""
    dev = resolve_device(device, "border_color matting")
    frames = np.asarray(frames)
    T = frames.shape[0]
    centers = border_centers(frames, border, k)
    mask = _classify_device(frames, centers, float(threshold), int(smooth), dev)

    if keep_largest:
        from scipy import ndimage
        out = np.zeros_like(mask)
        for t in range(T):
            lab, n = ndimage.label(mask[t] > 0.5)
            if n:
                sizes = ndimage.sum(mask[t] > 0.5, lab, range(1, n + 1))
                keep = lab == (1 + int(np.argmax(sizes)))
                out[t] = ndimage.binary_fill_holes(keep).astype(np.float32)
        mask = out
    return mask


@register_matting("neural")
def _neural(frames: np.ndarray, model=None, weights=None,
            image_size: int = 96, train_steps: int = 800,
            device: str | torch.device | None = None, **_) -> np.ndarray:
    """Self-trained matting net (`track/segnet.py`).  Trains on
    domain-randomized synthetic renders on first use; afterwards one forward
    per chunk of frames."""
    from omfs4d_torch.track import segnet

    if model is None:
        from omfs4d_torch.models.assets import synthetic_flame_asset
        from omfs4d_torch.models.flame import FlameModel
        model = FlameModel.from_asset(synthetic_flame_asset())
    net = segnet.get_or_train_segnet(
        model, weights=weights, image_size=image_size, steps=train_steps, device=device)
    return segnet.predict_masks(net, np.asarray(frames), image_size=image_size)


def compute_masks(frames: np.ndarray, method: str = "border_color",
                  **kwargs) -> np.ndarray:
    """Run a registered matting method -> (T, H, W) float32 in {0, 1}."""
    if method not in _MATTERS:
        raise KeyError(
            f"matting method {method!r} not registered; "
            f"available: {sorted(_MATTERS)}"
        )
    return _MATTERS[method](np.asarray(frames), **kwargs)
