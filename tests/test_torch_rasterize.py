"""The port's rasterizer against the JAX package's, on the CPU.

The same numpy inputs go through `omfs4d.render.rasterize` (and the Pallas
composite in interpret mode) and `omfs4d_torch.render.rasterize`.  Binning
parity is exact; it holds because the fixtures' quantized depth keys are
distinct (asserted), so the JAX sort's tie order never matters.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omfs4d.ops.camera import look_at_camera as j_look_at_camera
from omfs4d.ops.camera import project_gaussians as j_project
from omfs4d.render.pallas_kernels import composite_pallas
from omfs4d_torch.ops.camera import look_at_camera as t_look_at_camera
from omfs4d_torch.render import composite as tc
from omfs4d_torch.render import rasterize as tr
from tests.test_rasterize import random_scene

# `omfs4d.render` re-exports the function `rasterize`, which hides the module
jr = importlib.import_module("omfs4d.render.rasterize")

TOL = dict(atol=1e-4, rtol=1e-4)


def t_(x):
    return torch.from_numpy(np.array(x))


def proj_to_torch(proj):
    return {k: t_(v) for k, v in proj.items()}


def binning_to_torch(b):
    return tr.TileBinning(*(t_(x) for x in b))


def assert_unique_depth_keys(proj, opacity, num_tiles):
    """No two drawable gaussians share a quantized depth key, so no tile's
    list has a tie and the sort order is the same in both packages."""
    depth_bits = 31 - int(num_tiles + 1).bit_length()
    d = np.maximum(np.asarray(proj["depth"]), 0).astype(np.float32)
    keys = d.view(np.int32) >> (31 - depth_bits)
    live = np.asarray(proj["in_front"]) & (np.asarray(opacity) > 1 / 255)
    assert len(np.unique(keys[live])) == int(live.sum())


def scene_proj(n, seed, width, height, fx, scale_mult=None):
    means, rot, scales, opacity, colors = random_scene(n, seed=seed)
    if scale_mult is not None:
        rng = np.random.default_rng(seed + 100)
        scales = (scales * rng.uniform(*scale_mult, (n, 1))).astype(np.float32)
    cam = j_look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=fx,
                           width=width, height=height)
    proj = j_project(cam, jnp.asarray(means), jnp.asarray(rot), jnp.asarray(scales))
    return proj, opacity, colors


BIN_CASES = {
    # uniform window (n below two_class_min_n)
    "uniform": dict(n=60, seed=0, width=64, height=48, fx=200.0, scale_mult=None,
                    kw=dict(max_per_tile=12)),
    # two-class windows with a large-class budget of 5 < gaussians needing it
    "two_class": dict(n=300, seed=0, width=96, height=80, fx=200.0,
                      scale_mult=(0.5, 3.0),
                      kw=dict(max_per_tile=64, two_class_min_n=100, large_frac=0.01,
                              large_min=5)),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_bin_gaussians_matches_jax(case):
    c = BIN_CASES[case]
    proj, opacity, _ = scene_proj(c["n"], c["seed"], c["width"], c["height"],
                                  c["fx"], c["scale_mult"])
    num_tiles = -(-c["width"] // 16) * -(-c["height"] // 16)
    assert_unique_depth_keys(proj, opacity, num_tiles)
    jb = jr.bin_gaussians(proj, jnp.asarray(opacity), c["width"], c["height"], **c["kw"])
    tb = tr.bin_gaussians(proj_to_torch(proj), t_(opacity), c["width"], c["height"],
                          **c["kw"])
    for name in tr.TileBinning._fields:
        got, want = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert int(tb.overflow) > 0
    if case == "two_class":
        assert int(tb.spilled) > 0 and int(tb.window_clipped) > 0
        # the top-m radius selection is unambiguous on this fixture
        r = np.asarray(proj["radius"])
        m = 5
        needs = np.sort(-r[r > 0])
        assert needs[m - 1] != needs[m]


@pytest.fixture(scope="module")
def pallas_scene():
    """tests/test_pallas_composite.py's fixture."""
    proj, opacity, colors = scene_proj(40, 7, 48, 32, 150.0)
    binning = jr.bin_gaussians(proj, jnp.asarray(opacity), 48, 32,
                               tile=16, max_per_tile=64)
    return proj, binning, opacity, colors


def t_composite_args(proj, binning, opacity, colors):
    return (t_(proj["uv"]), t_(proj["conic"]), t_(colors), t_(opacity),
            binning_to_torch(binning))


@pytest.mark.parametrize("reference", ["composite_reference", "composite_pallas"])
def test_composite_plain_matches_jax(pallas_scene, reference):
    proj, binning, opacity, colors = pallas_scene
    fn = composite_pallas if reference == "composite_pallas" else jr.composite_reference
    img_j, alpha_j = fn(proj["uv"], proj["conic"], jnp.asarray(colors),
                        jnp.asarray(opacity), binning, 48, 32, tile=16)
    img_t, alpha_t = tc.composite_plain(*t_composite_args(proj, binning, opacity, colors),
                                        48, 32, 16)
    assert img_t.shape == (32, 48, 3) and alpha_t.shape == (32, 48)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), **TOL)
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), **TOL)


def test_composite_on_cpu_is_the_plain_version(pallas_scene):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    args = t_composite_args(*pallas_scene)
    before = tc.composite.launches
    img, alpha = tc.composite(*args, 48, 32)
    img_p, alpha_p = tc.composite_plain(*args, 48, 32)
    assert tc.composite.launches == before
    assert torch.equal(img, img_p) and torch.equal(alpha, alpha_p)


def test_composite_tile_slab_matches_full_grid(pallas_scene):
    """Lists for a contiguous slab of tiles (`tile_base`) composite those
    tiles of the image exactly as the full grid does, and nothing else."""
    uv, conic, cols, opac, b = t_composite_args(*pallas_scene)
    full_img, full_alpha = tc.composite_plain(uv, conic, cols, opac, b, 48, 32)
    slab = tr.TileBinning(b.tile_lists[2:5], b.tile_counts[2:5], *b[2:])
    img, alpha = tc.composite(uv, conic, cols, opac, slab, 48, 32, 16, tile_base=2)
    # 3 x 2 grid of 16-px tiles: tile 2 is (row 0, col 2), 3 and 4 are
    # (row 1, cols 0 and 1)
    inside = torch.zeros(32, 48, dtype=torch.bool)
    inside[0:16, 32:48] = True
    inside[16:32, 0:32] = True
    assert torch.equal(img[inside], full_img[inside])
    assert torch.equal(alpha[inside], full_alpha[inside])
    assert not img[~inside].any() and not alpha[~inside].any()


def test_mixed_occupancy_matches_jax():
    """A dense tile (> 128 entries) beside sparse ones, as in
    test_two_level_k_paths_match_reference (forward only)."""
    rng = np.random.default_rng(3)
    n_dense, n_sparse = 200, 30
    n = n_dense + n_sparse
    means = np.concatenate([rng.normal(0, 0.01, (n_dense, 3)),
                            rng.normal(0, 0.6, (n_sparse, 3))]).astype(np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    scales = np.full((n, 3), 0.02, np.float32)
    opacity = rng.uniform(0.2, 0.8, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cam = j_look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=150.0,
                           width=48, height=32)
    proj = j_project(cam, jnp.asarray(means), jnp.asarray(rot), jnp.asarray(scales))
    binning = jr.bin_gaussians(proj, jnp.asarray(opacity), 48, 32, tile=16,
                               max_per_tile=512)
    assert int(binning.tile_counts.max()) > 128
    assert int((binning.tile_counts < 128).sum()) > 0
    img_t, alpha_t = tc.composite_plain(*t_composite_args(proj, binning, opacity, colors),
                                        48, 32, 16)
    for fn in (jr.composite_reference, composite_pallas):
        img_j, alpha_j = fn(proj["uv"], proj["conic"], jnp.asarray(colors),
                            jnp.asarray(opacity), binning, 48, 32, tile=16)
        np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), **TOL)
        np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), **TOL)


@pytest.mark.parametrize("background", [None, (0.2, 0.4, 0.6)])
def test_rasterize_matches_jax(background):
    means, rot, scales, opacity, colors = random_scene(60)
    assert_unique_depth_keys(
        j_project(j_look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=200.0,
                                   width=64, height=64),
                  jnp.asarray(means), jnp.asarray(rot), jnp.asarray(scales)),
        opacity, 16)
    kw = dict(tile=16, max_per_tile=128)
    jcam = j_look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=200.0,
                            width=64, height=64)
    tcam = t_look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=200.0,
                            width=64, height=64)
    img_j, aux_j = jr.rasterize(
        *(jnp.asarray(a) for a in (means, rot, scales, opacity, colors)), jcam,
        64, 64, background=None if background is None else jnp.asarray(background),
        backend="never", **kw)
    img_t, aux_t = tr.rasterize(
        *(t_(a) for a in (means, rot, scales, opacity, colors)), tcam, 64, 64,
        background=None if background is None else torch.tensor(background), **kw)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), **TOL)
    np.testing.assert_allclose(aux_t["alpha"].numpy(), np.asarray(aux_j["alpha"]), **TOL)
    for k in ("overflow", "window_clipped", "spilled"):
        assert int(aux_t[k]) == int(aux_j[k]), k


def test_rasterize_empty_cloud_is_background():
    cam = t_look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=200.0,
                           width=40, height=24)
    empty = torch.zeros((0, 3))
    bg = torch.tensor([0.1, 0.2, 0.3])
    img, aux = tr.rasterize(empty, torch.zeros((0, 3, 3)), empty, torch.zeros(0),
                            empty, cam, 40, 24, background=bg)
    assert img.shape == (24, 40, 3) and torch.equal(img, bg.expand(24, 40, 3))
    assert aux["alpha"].shape == (24, 40) and not aux["alpha"].any()
    assert all(int(aux[k]) == 0 for k in ("overflow", "window_clipped", "spilled"))
    white, _ = tr.rasterize(empty, torch.zeros((0, 3, 3)), empty, torch.zeros(0),
                            empty, cam, 40, 24)
    assert torch.equal(white, torch.ones(24, 40, 3))


def test_render_depth_matches_jax():
    means, rot, scales, opacity, _ = random_scene(50, seed=2)
    kw = dict(eye=(0, 0, -2.5), target=(0, 0, 0), fx=200.0, width=48, height=48)
    d_j, a_j = jr.render_depth(*(jnp.asarray(a) for a in (means, rot, scales, opacity)),
                               j_look_at_camera(**kw), 48, 48, backend="never",
                               max_per_tile=128)
    d_t, a_t = tr.render_depth(*(t_(a) for a in (means, rot, scales, opacity)),
                               t_look_at_camera(**kw), 48, 48, max_per_tile=128)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **TOL)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)


def test_tile_pixel_centers_and_assemble_match_jax():
    np.testing.assert_array_equal(tr._tile_pixel_centers(3, 2, 4).numpy(),
                                  np.asarray(jr._tile_pixel_centers(3, 2, 4)))
    x = np.random.default_rng(0).normal(size=(6, 16, 2)).astype(np.float32)
    a = x[..., 0]
    got = tr.assemble_tiles(t_(x), t_(a), 11, 7, 4)
    want = jr.assemble_tiles(jnp.asarray(x), jnp.asarray(a), 11, 7, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
