"""Gradient of the port's composite on the CPU (PyTorch autograd through
`composite_plain`) against the JAX package's: `composite_pallas` (the
custom VJP over the Pallas kernels, in interpret mode) and
`composite_reference` (JAX autodiff), on tests/test_pallas_composite.py's
scene and its two-level occupancy case; the finite-difference check on
opacity; and the arithmetic of kernel K2 (`csrc/composite_bwd.cu`: one
front-to-back pass from the forward's colour C_tot and transmittance T_tot,
suffix_k = dcol . (C_tot - C_<=k)) written out in numpy and held to the same
autograd.  tests/test_torch_composite_onepass.py transcribes it in f32, in
the kernel's order of sums.

Tolerance atol = 2e-4 * max|reference grad|, rtol = 2e-3: the reference's
own gradient bound (tests/test_pallas_composite.py); the packages sum the
same terms in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omfs4d.ops.camera import look_at_camera
from omfs4d.ops.camera import project_gaussians
from omfs4d.render.pallas_kernels import composite_pallas
from omfs4d.render.rasterize import bin_gaussians, composite_reference
from omfs4d_torch.render import composite as tc
from omfs4d_torch.render.rasterize import TileBinning
from tests.test_rasterize import random_scene

NAMES = ("uv", "conic", "colors", "opacity")
W, H = 48, 32


def pallas_scene():
    cam = look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=150.0, width=W, height=H)
    means, rot, scales, opacity, colors = random_scene(40, seed=7)
    proj = project_gaussians(cam, jnp.asarray(means), jnp.asarray(rot), jnp.asarray(scales))
    binning = bin_gaussians(proj, jnp.asarray(opacity), W, H, tile=16, max_per_tile=64)
    return proj, binning, opacity, colors


def two_level_scene():
    """200 coincident gaussians in the centre tile (> 128 entries) and 30
    spread out (< 128): both occupancy levels of the Pallas kernel."""
    cam = look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=150.0, width=W, height=H)
    rng = np.random.default_rng(3)
    n_dense, n_sparse = 200, 30
    n = n_dense + n_sparse
    means = np.concatenate([rng.normal(0, 0.01, (n_dense, 3)),
                            rng.normal(0, 0.6, (n_sparse, 3))]).astype(np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    scales = np.full((n, 3), 0.02, np.float32)
    opacity = rng.uniform(0.2, 0.8, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    proj = project_gaussians(cam, jnp.asarray(means), jnp.asarray(rot), jnp.asarray(scales))
    binning = bin_gaussians(proj, jnp.asarray(opacity), W, H, tile=16, max_per_tile=512)
    assert int(binning.tile_counts.max()) > 128
    assert int((binning.tile_counts < 128).sum()) > 0
    return proj, binning, opacity, colors


SCENES = {"pallas_scene": pallas_scene, "two_level": two_level_scene}


def t_(x):
    return torch.from_numpy(np.array(x))


def loss_jax(fn, binning, uv, conic, cols, opac):
    img, alpha = fn(uv, conic, cols, opac, binning, W, H, tile=16)
    return jnp.sum(img ** 2) + 0.3 * jnp.sum(alpha ** 2)


def port_grads(proj, binning, opacity, colors):
    leaves = [t_(x).requires_grad_() for x in (proj["uv"], proj["conic"], colors, opacity)]
    b = TileBinning(*(t_(x) for x in binning))
    img, alpha = tc.composite(*leaves, b, W, H, 16)
    loss = torch.sum(img ** 2) + 0.3 * torch.sum(alpha ** 2)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("reference", ["composite_pallas", "composite_reference"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_composite_gradient_matches_jax(scene, reference):
    proj, binning, opacity, colors = SCENES[scene]()
    fn = composite_pallas if reference == "composite_pallas" else composite_reference
    args = (proj["uv"], proj["conic"], jnp.asarray(colors), jnp.asarray(opacity))
    g_j = jax.grad(lambda *a: loss_jax(fn, binning, *a), argnums=(0, 1, 2, 3))(*args)
    before = (tc.composite.launches, tc.composite.backward_launches)
    g_t = port_grads(proj, binning, opacity, colors)
    assert (tc.composite.launches, tc.composite.backward_launches) == before
    for name, a, b in zip(NAMES, g_t, g_j):
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, atol=2e-4 * scale, rtol=2e-3,
                                   err_msg=f"grad mismatch for {name}")


def test_gradcheck_finite_difference_on_opacity():
    proj, binning, opacity, colors = pallas_scene()
    b = TileBinning(*(t_(x) for x in binning))
    uv, conic, cols = t_(proj["uv"]), t_(proj["conic"]), t_(colors)
    ramp = torch.linspace(0, 1, W)[None, :, None]

    def loss(opac):
        img, _ = tc.composite(uv, conic, cols, opac, b, W, H, 16)
        return torch.sum(img * ramp)

    op = t_(opacity).requires_grad_()
    (g,) = torch.autograd.grad(loss(op), op)
    rng = np.random.default_rng(0)
    for i in rng.choice(len(opacity), size=4, replace=False):
        eps = 1e-3
        hi, lo = t_(opacity), t_(opacity)
        hi[i] += eps
        lo[i] -= eps
        fd = (float(loss(hi)) - float(loss(lo))) / (2 * eps)
        assert abs(fd - float(g[i])) < 2e-2 * max(abs(fd), 1.0), (i, fd, float(g[i]))


def k2_numpy(uv, conic, rgb, opac, lists, counts, img, trans, dimg, dalpha, width, height,
             tile):
    """Kernel K2's arithmetic, vectorised over a tile's pixels: one pass
    front to back from the forward's C_tot (img) and T_tot (trans), with
    suffix_k = dcol . (C_tot - C_<=k)."""
    grid_w = (width + tile - 1) // tile
    out = [np.zeros_like(uv), np.zeros_like(conic), np.zeros_like(rgb), np.zeros_like(opac)]
    p = np.arange(tile * tile)
    for t in range(lists.shape[0]):
        px, py = (t % grid_w) * tile + p % tile, (t // grid_w) * tile + p // tile
        inside = (px < width) & (py < height)
        x, y = px + 0.5, py + 0.5
        cy, cx = np.minimum(py, height - 1), np.minimum(px, width - 1)
        d = np.where(inside[:, None], dimg[cy, cx], 0)
        dA = np.where(inside, dalpha[cy, cx], 0)
        c_tot = np.where(inside[:, None], img[cy, cx], 0)
        t_tot = np.where(inside, trans[cy, cx], 1)

        trans_k, c_le = np.ones(len(p)), np.zeros((len(p), 3))
        for g in lists[t, :counts[t]]:
            dx, dy = x - uv[g, 0], y - uv[g, 1]
            a_, b_, c_ = conic[g]
            e = np.exp(np.minimum(-0.5 * (a_ * dx * dx + c_ * dy * dy) - b_ * dx * dy, 0))
            a_full = opac[g] * e
            ok = (a_full <= 0.99) & (np.minimum(a_full, 0.99) >= 1 / 255)
            a = np.where(np.minimum(a_full, 0.99) < 1 / 255, 0, np.minimum(a_full, 0.99))
            w = a * trans_k
            c_le += w[:, None] * rgb[g]
            om = np.maximum(1 - a, 1e-6)
            da = (d @ rgb[g]) * trans_k - np.sum(d * (c_tot - c_le), 1) / om + dA * t_tot / om
            dq = np.where(ok, da, 0) * a_full
            out[0][g] += [np.sum(dq * (a_ * dx + b_ * dy)), np.sum(dq * (c_ * dy + b_ * dx))]
            out[1][g] += [np.sum(-0.5 * dq * dx * dx), np.sum(-dq * dx * dy),
                          np.sum(-0.5 * dq * dy * dy)]
            out[2][g] += np.sum(d * w[:, None], 0)
            out[3][g] += np.sum(np.where(ok, da, 0) * e)
            trans_k = trans_k * (1 - a)
    return out


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_k2_arithmetic_matches_autograd(scene):
    proj, binning, opacity, colors = SCENES[scene]()
    rng = np.random.default_rng(5)
    dimg, dalpha = rng.normal(size=(H, W, 3)), rng.normal(size=(H, W))
    leaves = [t_(x).double().requires_grad_()
              for x in (proj["uv"], proj["conic"], colors, opacity)]
    b = TileBinning(*(t_(x) for x in binning))
    img, alpha = tc.composite_plain(*leaves, b, W, H, 16)
    loss = (img * t_(dimg)).sum() + (alpha * t_(dalpha)).sum()
    g_ref = torch.autograd.grad(loss, leaves)
    g_k2 = k2_numpy(*(x.detach().numpy() for x in leaves), np.asarray(binning.tile_lists),
                    np.asarray(binning.tile_counts), img.detach().numpy(),
                    1 - alpha.detach().numpy(), dimg, dalpha, W, H, 16)
    for name, a, ref in zip(NAMES, g_k2, g_ref):
        ref = ref.numpy()
        np.testing.assert_allclose(a, ref, atol=1e-9 * max(np.abs(ref).max(), 1.0),
                                   rtol=1e-7, err_msg=name)
