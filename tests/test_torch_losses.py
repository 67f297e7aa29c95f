"""Training losses of the port (`omfs4d_torch.train.losses`) against the JAX
package's, on the CPU: values and gradients of l1, ssim, dssim and psnr on
seeded images, and the shifted-FMA blur against the band-matrix form.

Tolerances.  Values agree to 2e-6 and gradients to 1e-5 of the largest
gradient (rtol 1e-4): both packages sum the same f32 terms, but their
11-tap blur coefficients come from two exp implementations and differ by
an ulp (~3e-8).  Images here are textured
everywhere or flat at exactly 0, where the variance is exactly 0 in both;
flat windows at 1.0 are left out on purpose (see test_train_step_* in
test_torch_train.py for why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omfs4d.train import losses as jl
from omfs4d_torch.train import losses as tl

FNS = ("l1_loss", "ssim", "dssim_loss", "psnr")


def images(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        a = rng.uniform(0, 1, (37, 52, 3))
        b = rng.uniform(0, 1, (37, 52, 3))
    elif kind == "close":          # a render near its target: the training regime
        b = rng.uniform(0.2, 0.8, (40, 33, 3))
        a = b + rng.normal(0, 0.02, b.shape)
    else:                          # a black background around textured patches
        a = np.zeros((40, 40, 3))
        b = np.zeros((40, 40, 3))
        a[8:30, 10:32] = rng.uniform(0, 1, (22, 22, 3))
        b[12:28, 12:28] = rng.uniform(0, 1, (16, 16, 3))
        b[0:6, 0:6] = a[0:6, 0:6]   # equal pixels: the |d| gradient at d == 0
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "close", "black_background"])
@pytest.mark.parametrize("fn", FNS)
def test_loss_value_and_gradient_match_jax(fn, kind):
    a, b = images(kind)
    jv, jg = jax.value_and_grad(getattr(jl, fn))(jnp.asarray(a), jnp.asarray(b))
    x = torch.tensor(a, requires_grad=True)
    tv = getattr(tl, fn)(x, torch.tensor(b))
    (tg,) = torch.autograd.grad(tv, x)
    scale = 100.0 if fn == "psnr" else 1.0          # psnr is in dB
    assert abs(float(jv) - float(tv.detach())) <= 2e-6 * scale
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5 * float(np.abs(np.asarray(jg)).max()) + 1e-12)


def test_ssim_of_identical_images_is_one():
    a, _ = images("random")
    x = torch.tensor(a)
    assert float(tl.ssim(x, x)) == pytest.approx(1.0, abs=1e-6)
    assert float(tl.dssim_loss(x, x)) == pytest.approx(0.0, abs=1e-6)


def test_sep_blur_matches_band_matrix_and_jax():
    """The shifted-FMA blur equals the band-matrix form it replaced (zero
    padding = the band matrix's missing out-of-range taps), and the JAX
    package's blur."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (37, 52, 3)).astype(np.float32)
    bh = tl._band_matrix(37, 11, 1.5).double()
    bw = tl._band_matrix(52, 11, 1.5).double()
    ref = torch.einsum("hk,kwc->hwc", bh, torch.tensor(img, dtype=torch.float64))
    ref = torch.einsum("hkc,wk->hwc", ref, bw)
    got = tl._sep_blur(torch.tensor(img), 11, 1.5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(tl._band_matrix(37, 11, 1.5).numpy(),
                               np.asarray(jl._band_matrix(37, 11, 1.5)), atol=1e-7)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jl._sep_blur(jnp.asarray(img), 11, 1.5)),
                               atol=1e-6)
