"""Kernels K1 (`omfs4d_torch/csrc/composite_fwd.cu`) and K2
(`composite_bwd.cu`) against their plain PyTorch version, on a CUDA card.
Without a card every test here skips.

This file imports only the port (no jax), so it also runs on a machine
without JAX:  python -m pytest --noconftest tests/test_torch_composite_card.py
Forward tolerance atol = rtol = 1e-4, the bound of the reference's own
Pallas-vs-XLA test; the two sum the same terms in another order.  Gradient
tolerance atol = 2e-4 * max|plain grad|, rtol = 2e-3, the reference's own
gradient bound (tests/test_pallas_composite.py): K2 scatters with float
atomics, whose order changes from run to run.
"""

import numpy as np
import pytest
import torch

from omfs4d_torch.ops.camera import look_at_camera, project_gaussians
from omfs4d_torch.render import composite as tc
from omfs4d_torch.render.rasterize import TileBinning, bin_gaussians

TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = ("uv", "conic", "colors", "opacity")


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


def grads(fn, inputs, binning, width, height, tile, tile_base=0, seed=1):
    """d/d(uv, conic, colors, opacity) of a seeded random linear loss on the
    composite's image and alpha (the cotangents K2 receives)."""
    gen = torch.Generator(device=inputs[0].device).manual_seed(seed)
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    img, alpha = fn(*leaves, binning, width, height, tile, tile_base=tile_base)
    w_img = torch.randn(img.shape, generator=gen, device=img.device)
    w_alpha = torch.randn(alpha.shape, generator=gen, device=img.device)
    loss = (img * w_img).sum() + (alpha * w_alpha).sum()
    return torch.autograd.grad(loss, leaves)


def assert_grads_close(g_k, g_p):
    for name, a, b in zip(NAMES, g_k, g_p):
        scale = max(b.abs().max().item(), 1e-6)
        torch.testing.assert_close(a, b, atol=2e-4 * scale, rtol=2e-3,
                                   msg=lambda m: f"grad {name}: {m}")


@pytest.mark.parametrize("width,height,tile,K,n", [
    (48, 32, 16, 64, 40),          # the Pallas test's shape
    (77, 45, 16, 512, 3000),       # ragged edge, lists longer than a block
    (50, 30, 8, 32, 500),          # 8-px tiles: 64-thread blocks, overflow
    (512, 512, 16, 256, 65_536),   # the training path's shape
])
def test_backward_kernel_matches_plain_on_card(cuda_device, width, height, tile, K, n):
    uv, conic, colors, opacity, b = scene(n, width, height, tile, K, cuda_device)
    before = tc.composite.backward_launches
    g_k = grads(tc.composite, (uv, conic, colors, opacity), b, width, height, tile)
    torch.cuda.synchronize()
    assert tc.composite.backward_launches == before + 1
    g_p = grads(tc.composite_plain, (uv, conic, colors, opacity), b, width, height, tile)
    assert_grads_close(g_k, g_p)
    # gaussians in no list get exactly 0
    listed = torch.zeros(n, dtype=torch.bool, device=cuda_device)
    k_ids = torch.arange(K, device=cuda_device)
    valid = k_ids[None, :] < b.tile_counts[:, None].long()
    listed[b.tile_lists[valid].long()] = True
    for g in g_k:
        assert bool((g[~listed] == 0).all())


def test_backward_kernel_tile_slab_on_card(cuda_device):
    uv, conic, colors, opacity, b = scene(300, 77, 45, 16, 128, cuda_device)
    slab = TileBinning(b.tile_lists[3:9].contiguous(), b.tile_counts[3:9].contiguous(),
                       *b[2:])
    args = ((uv, conic, colors, opacity), slab, 77, 45, 16)
    assert_grads_close(grads(tc.composite, *args, tile_base=3),
                       grads(tc.composite_plain, *args, tile_base=3))


def test_gradient_flows_through_both_kernels_on_card(cuda_device):
    uv, conic, colors, opacity, b = scene(40, 48, 32, 16, 64, cuda_device)
    fwd, bwd = tc.composite.launches, tc.composite.backward_launches
    uv = uv.detach().requires_grad_()
    img, alpha = tc.composite(uv, conic, colors, opacity, b, 48, 32)
    assert img.requires_grad and alpha.requires_grad
    (img.sum() + alpha.sum()).backward()
    torch.cuda.synchronize()
    assert tc.composite.launches == fwd + 1
    assert tc.composite.backward_launches == bwd + 1
    assert uv.grad is not None and bool(torch.isfinite(uv.grad).all())
    assert uv.grad.abs().max() > 0
