"""Image losses for 3DGS avatar training: L1 + D-SSIM (the 0.8/0.2 mix the
GaussianAvatars trainer uses), plus PSNR.

Port of `omfs4d.train.losses`, formula for formula.  The SSIM window is the
reference's own: an 11-tap, sigma 1.5 separable blur as shifted FMAs with
zero padding (no `conv2d`, which would run in TF32 through cuDNN, and no
library SSIM), the variance clamp, the Cauchy-Schwarz covariance clip with
its bound detached, and the mean over the interior only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    # |d| written so that its gradient at d == 0 is 1, as jnp.abs's is
    # (torch.abs gives 0): rendered background equals a white GT exactly
    d = pred - target
    return torch.mean(torch.where(d >= 0, d, -d))


def _taps(size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _band_matrix(n: int, size: int, sigma: float) -> torch.Tensor:
    """(n, n) banded gaussian-blur matrix (same coefficients as the separable
    window; border rows are truncated).  Kept for the parity test of
    `_sep_blur`."""
    g = _taps(size, sigma)
    idx = torch.arange(n)
    offs = idx[:, None] - idx[None, :] + (size - 1) // 2        # (n, n)
    inband = (offs >= 0) & (offs < size)
    return torch.where(inband, g[torch.clamp(offs, 0, size - 1)], 0.0)


def _sep_blur(img: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of an (H, W, C) image as shifted-slice FMAs
    with zero padding, rows then columns."""
    g = _taps(size, sigma, img.device)
    half = size // 2
    H, W, _ = img.shape
    p = F.pad(img, (0, 0, 0, 0, half, half))
    out = g[0] * p[0:H]
    for k in range(1, size):
        out = out + g[k] * p[k:k + H]
    p = F.pad(out, (0, 0, half, half))
    out = g[0] * p[:, 0:W]
    for k in range(1, size):
        out = out + g[k] * p[:, k:k + W]
    return out


def ssim(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Windowed SSIM over (H, W, C) images in [0, 1].  Border rows and
    columns (half a window) are left out of the mean, as a VALID-padded
    window would."""
    H, W, _ = pred.shape

    def filt(img):
        return _sep_blur(img, window_size, 1.5)

    mu_x = filt(pred)
    mu_y = filt(target)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    # clamp: windowed variance is mathematically >= 0.  torch.maximum (not
    # clamp_min) so that a tie at exactly 0 splits the gradient in half, as
    # jnp.maximum does; clamp_min would pass all of it
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    sig_x = torch.maximum(filt(pred * pred) - mu_x2, zero)
    sig_y = torch.maximum(filt(target * target) - mu_y2, zero)
    sig_xy = filt(pred * target) - mu_xy
    # Cauchy-Schwarz |cov| <= sqrt(var_x var_y); the bound is detached
    # (sqrt'(0) is inf, and the clip only corrects rounding-scale excess)
    bound = torch.sqrt(sig_x * sig_y).detach()
    sig_xy = torch.minimum(torch.maximum(sig_xy, -bound), bound)

    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    s = ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2)
    )
    half = window_size // 2
    return torch.mean(s[half:H - half, half:W - half])


def dssim_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (1.0 - ssim(pred, target)) / 2.0


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp_min(mse, 1e-12))
