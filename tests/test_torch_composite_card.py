"""Kernels K1 (`omfs4d_torch/csrc/composite_fwd.cu`) and K2
(`composite_bwd.cu`) against their plain PyTorch version, on a CUDA card.
Without a card every test here skips.

This file imports only the port (no jax), so it also runs on a machine
without JAX:  python -m pytest --noconftest tests/test_torch_composite_card.py
K1 writes the final transmittance T_tot on request and K2 walks each list
once from it and the forward's image; both take their alpha and step from
`csrc/composite_common.cuh`.
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


def test_residual_leaves_k1_bits_unchanged_and_orders_tiles_on_card(cuda_device):
    """K1 with and without the T_tot pointer gives the same bits, alpha is
    1 - T_tot, and the order K1 leaves for K2 is a permutation of the list
    rows, heaviest first."""
    uv, conic, colors, opacity, b = scene(3000, 77, 45, 16, 512, cuda_device)
    args = (uv, conic, colors, opacity, b.tile_lists, b.tile_counts, 77, 45, 16, 0,
            tc._check_inputs(uv, conic, colors, opacity, b.tile_lists, b.tile_counts,
                             77, 45, 16, 0))
    before = tc.composite.launches
    img, alpha, none = tc._launch_fwd(*args)
    img_r, alpha_r, (trans, order) = tc._launch_fwd(*args, residual=True)
    torch.cuda.synchronize()
    assert none is None and tc.composite.launches == before + 2
    assert torch.equal(img_r, img) and torch.equal(alpha_r, alpha)
    assert torch.equal(alpha, 1.0 - trans)
    assert torch.equal(torch.sort(order).values,
                       torch.arange(len(order), device=cuda_device, dtype=order.dtype))
    assert bool((torch.diff(b.tile_counts[order.long()]) <= 0).all())
    assert b.tile_counts.min() < b.tile_counts.max()        # an order to keep


def saturated_scene(device, n=60, width=48, height=32, tile=16, K=64):
    """Wide, nearly opaque gaussians over the whole image, every one in every
    tile's list (by hand: no sort, no ties), so that T underflows to 0 in
    f32 after ~25 entries; a few capped at 0.99, and cut ones at the end."""
    rng = np.random.default_rng(4)
    uv = np.stack([rng.uniform(0, width, n), rng.uniform(0, height, n)], 1)
    sigma = rng.uniform(30, 60, n)
    conic = np.stack([1 / sigma ** 2, rng.uniform(-0.1, 0.1, n) / sigma ** 2, 1 / sigma ** 2], 1)
    opacity = np.where(np.arange(n) % 9 == 4, 1.0, 0.98)
    opacity[-3:] = 0.002                                   # cut everywhere
    colors = rng.uniform(0, 1, (n, 3))
    grid = -(-width // tile) * -(-height // tile)
    lists = np.zeros((grid, K), np.int32)
    lists[:, :n] = np.arange(n)
    counts = np.full(grid, n, np.int32)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    binning = TileBinning(t(lists, torch.int32), t(counts, torch.int32),
                          *[torch.zeros((), dtype=torch.int32, device=device)] * 3)
    return (t(uv), t(conic), t(colors), t(opacity), binning), width, height, tile


def test_backward_kernel_matches_plain_where_t_underflows_on_card(cuda_device):
    (uv, conic, colors, opacity, b), width, height, tile = saturated_scene(cuda_device)
    with torch.no_grad():
        _, alpha = tc.composite(uv, conic, colors, opacity, b, width, height, tile)
    assert (alpha == 1.0).float().mean() > 0.9            # T_tot = 0 in f32
    g_k = grads(tc.composite, (uv, conic, colors, opacity), b, width, height, tile)
    g_p = grads(tc.composite_plain, (uv, conic, colors, opacity), b, width, height, tile)
    assert_grads_close(g_k, g_p)
    assert all(bool(torch.isfinite(g).all()) for g in g_k)


def test_in_place_edit_of_the_image_before_backward_raises_on_card(cuda_device):
    """K2 reads the image K1 returned as C_tot: autograd's version counter
    refuses a backward after the caller modified it in place."""
    uv, conic, colors, opacity, b = scene(40, 48, 32, 16, 64, cuda_device)
    uv = uv.detach().requires_grad_()
    img, alpha = tc.composite(uv, conic, colors, opacity, b, 48, 32)
    img.mul_(0.5)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        (img.sum() + alpha.sum()).backward()


def test_one_k2_launch_per_backward_on_card(cuda_device):
    uv, conic, colors, opacity, b = scene(300, 77, 45, 16, 128, cuda_device)
    leaves = [t.detach().requires_grad_() for t in (uv, conic, colors, opacity)]
    fwd, bwd = tc.composite.launches, tc.composite.backward_launches
    img, alpha = tc.composite(*leaves, b, 77, 45)
    loss = img.square().sum() + alpha.sum()
    first = torch.autograd.grad(loss, leaves, retain_graph=True)
    assert tc.composite.backward_launches == bwd + 1
    second = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert (tc.composite.launches, tc.composite.backward_launches) == (fwd + 1, bwd + 2)
    for a, c in zip(first, second):
        torch.testing.assert_close(a, c, atol=1e-6 * max(c.abs().max().item(), 1e-6),
                                   rtol=1e-5)
    with torch.no_grad():
        img_ng, _ = tc.composite(*leaves, b, 77, 45)
    assert img_ng.grad_fn is None and tc.composite.backward_launches == bwd + 2
