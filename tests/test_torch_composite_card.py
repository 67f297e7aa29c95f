"""Kernel K1 (`omfs4d_torch/csrc/composite_fwd.cu`) against its plain
PyTorch version, on a CUDA card.  Without a card every test here skips.

This file imports only the port (no jax), so it also runs on a machine
without JAX:  python -m pytest --noconftest tests/test_torch_composite_card.py
Tolerance atol = rtol = 1e-4, the bound of the reference's own
Pallas-vs-XLA test; the two sum the same terms in another order.
"""

import numpy as np
import pytest
import torch

from omfs4d_torch.ops.camera import look_at_camera, project_gaussians
from omfs4d_torch.render import composite as tc
from omfs4d_torch.render.rasterize import TileBinning, bin_gaussians

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the composite kernel has no CPU mode")
    return torch.device("cuda", 0)


def scene(n, width, height, tile, K, device, seed=0):
    """Random gaussians in front of a look-at camera, projected and binned
    on `device`; returns the composite's arguments."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    cam = look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=1.5 * width,
                         width=width, height=height, device=device)
    proj = project_gaussians(cam, t(rng.normal(0, 0.4, (n, 3))), t(rot),
                             t(rng.uniform(0.01, 0.06, (n, 3))))
    opacity, colors = t(rng.uniform(0.1, 0.95, n)), t(rng.uniform(0, 1, (n, 3)))
    binning = bin_gaussians(proj, opacity, width, height, tile=tile, max_per_tile=K)
    return proj["uv"], proj["conic"], colors, opacity, binning


@pytest.mark.parametrize("width,height,tile,K,n", [
    (48, 32, 16, 64, 40),          # the Pallas test's shape
    (77, 45, 16, 512, 3000),       # ragged edge, lists longer than a block
    (50, 30, 8, 32, 500),          # 8-px tiles: 64-thread blocks, overflow
    (512, 512, 16, 256, 65_536),   # the render path's shape
])
def test_kernel_matches_plain_on_card(cuda_device, width, height, tile, K, n):
    args = scene(n, width, height, tile, K, cuda_device)
    before = tc.composite.launches
    with torch.no_grad():
        img_k, alpha_k = tc.composite(*args, width, height, tile)
        torch.cuda.synchronize()
        img_p, alpha_p = tc.composite_plain(*args, width, height, tile)
    assert tc.composite.launches == before + 1
    assert img_k.shape == (height, width, 3) and alpha_k.shape == (height, width)
    torch.testing.assert_close(img_k, img_p, **TOL)
    torch.testing.assert_close(alpha_k, alpha_p, **TOL)
    assert alpha_k.max() > 0.5


def test_kernel_tile_slab_on_card(cuda_device):
    uv, conic, colors, opacity, b = scene(300, 77, 45, 16, 128, cuda_device)
    slab = TileBinning(b.tile_lists[3:9].contiguous(), b.tile_counts[3:9].contiguous(),
                       *b[2:])
    with torch.no_grad():
        img_k, alpha_k = tc.composite(uv, conic, colors, opacity, slab, 77, 45, 16,
                                      tile_base=3)
        img_p, alpha_p = tc.composite_plain(uv, conic, colors, opacity, slab, 77, 45, 16,
                                            tile_base=3)
    torch.testing.assert_close(img_k, img_p, **TOL)
    torch.testing.assert_close(alpha_k, alpha_p, **TOL)


def test_kernel_refuses_grad_on_card(cuda_device):
    uv, conic, colors, opacity, b = scene(40, 48, 32, 16, 64, cuda_device)
    with pytest.raises(ValueError, match="backward"):
        tc.composite(uv.requires_grad_(), conic, colors, opacity, b, 48, 32)
