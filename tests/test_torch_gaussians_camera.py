"""The port's gaussian binding, SH colour and EWA projection against the JAX
package's, on the CPU.  float32 on both sides: atol/rtol 1e-5, the conic
(a quotient by a small determinant) at rtol 1e-4, integer radii exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omfs4d.models import gaussians as jg
from omfs4d.models.assets import synthetic_flame_asset
from omfs4d.ops import camera as jc
from omfs4d_torch.convert import camera_from_numpy, gaussians_from_numpy, to_numpy
from omfs4d_torch.models import gaussians as tg
from omfs4d_torch.ops import camera as tcam
from tests.test_rasterize import random_scene

TOL = dict(atol=1e-5, rtol=1e-5)


def t_(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def mesh():
    asset = synthetic_flame_asset(n_vertices=300, seed=2)
    return asset["v_template"], asset["faces"]


def random_avatar(faces, n=500, sh_degree=3, seed=0):
    """A JAX GaussianAvatar with random fields and a few dead slots."""
    rng = np.random.default_rng(seed)
    g = jg.init_gaussians_on_mesh(faces, n, sh_degree=sh_degree, seed=seed)
    f = lambda *s, sc=1.0: jnp.asarray((sc * rng.normal(size=s)).astype(np.float32))  # noqa: E731
    return g._replace(
        parent_face=jnp.asarray(rng.integers(0, len(faces), n).astype(np.int32)),
        mu_local=f(n, 3, sc=0.3), quat_local=f(n, 4), log_scale=f(n, 3, sc=0.5),
        opacity_logit=f(n), color=f(n, 3), sh=f(n, jg.SH_DIM[sh_degree], 3, sc=0.3),
        alive=jnp.asarray(rng.uniform(size=n) > 0.1))


def to_port(g):
    return gaussians_from_numpy(jax.tree_util.tree_map(np.asarray, g)._asdict())


def test_quat_to_matrix_matches_jax():
    q = np.random.default_rng(0).normal(size=(50, 4)).astype(np.float32)
    q[0] = 0.0                                   # dead slot: eps inside the sqrt
    np.testing.assert_allclose(tg.quat_to_matrix(t_(q)).numpy(),
                               np.asarray(jg.quat_to_matrix(jnp.asarray(q))), **TOL)


def test_triangle_frames_match_jax(mesh):
    verts, faces = mesh
    verts = verts + np.random.default_rng(1).normal(0, 1e-3, verts.shape).astype(np.float32)
    got = tg.triangle_frames(t_(verts), t_(faces))
    want = jg.triangle_frames(jnp.asarray(verts), jnp.asarray(faces))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_bind_to_mesh_matches_jax(mesh):
    verts, faces = mesh
    g = random_avatar(faces)
    got = tg.bind_to_mesh(to_port(g), t_(verts), t_(faces))
    want = jg.bind_to_mesh(g, jnp.asarray(verts), jnp.asarray(faces))
    names = ["means", "rotations", "scales", "opacity", "colors"]
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=name, **TOL)
    assert not got[3][~to_port(g).alive].any()   # dead slots draw nothing


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_colors_matches_jax(mesh, degree):
    verts, faces = mesh
    g = random_avatar(faces, sh_degree=degree, seed=degree)
    means = np.random.default_rng(5).normal(0, 0.1, (500, 3)).astype(np.float32)
    cam_pos = np.array([0.1, -0.05, 0.6], np.float32)
    got = tg.eval_colors(to_port(g), t_(means), t_(cam_pos)).detach().numpy()
    if degree == 0:
        # the JAX eval_colors raises for degree 0 (a 3-column basis against
        # 0 coefficients); its documented meaning is the DC colour alone
        want = np.clip(np.asarray(jax.nn.sigmoid(g.color)), 0.0, 1.0)
    else:
        want = np.asarray(jg.eval_colors(g, jnp.asarray(means), jnp.asarray(cam_pos)))
        np.testing.assert_allclose(
            tg.sh_basis(t_(means / np.linalg.norm(means, axis=1, keepdims=True)),
                        degree).numpy(),
            np.asarray(jg.sh_basis(jnp.asarray(means / np.linalg.norm(
                means, axis=1, keepdims=True)), degree)), **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    assert tg.sh_degree_of(to_port(g)) == degree


def test_init_gaussians_on_mesh_matches_jax(mesh):
    _, faces = mesh
    want = jax.tree_util.tree_map(np.asarray, jg.init_gaussians_on_mesh(faces, 700, seed=4))
    got = to_numpy(tg.init_gaussians_on_mesh(faces, 700, seed=4))
    for name, value in want._asdict().items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    assert int(tg.n_alive(tg.init_gaussians_on_mesh(faces, 700))) == len(faces)


@pytest.fixture(scope="module")
def cameras():
    kw = dict(fx=210.0, fy=190.0, width=80, height=60, cx=41.0, cy=29.5)
    jcam = jc.look_at_camera(eye=(0.2, 0.1, -2.5), target=(0, 0, 0), **kw)
    tcam_ = tcam.look_at_camera(eye=(0.2, 0.1, -2.5), target=(0, 0, 0), **kw)
    return jcam, tcam_


def test_cameras_match_jax(cameras):
    jcam, tcam_ = cameras
    for name, value in to_numpy(tcam_).items():
        np.testing.assert_array_equal(value, np.asarray(getattr(jcam, name)), err_msg=name)
    c2w = np.linalg.inv(np.asarray(jcam.w2c, np.float64))
    c2w[:3, 1:3] *= -1.0
    jn = jc.camera_from_nerf(c2w, 200.0, 201.0, 40.0, 30.0, 80, 60)
    tn = tcam.camera_from_nerf(c2w, 200.0, 201.0, 40.0, 30.0, 80, 60)
    np.testing.assert_array_equal(tn.w2c.numpy(), np.asarray(jn.w2c))
    conv = camera_from_numpy(**jax.tree_util.tree_map(np.asarray, jn)._asdict())
    assert torch.equal(conv.w2c, tn.w2c) and conv.width == 80 and float(conv.fy) == 201.0
    np.testing.assert_allclose(tcam_.position.numpy(),
                               np.asarray(-jcam.w2c[:3, :3].T @ jcam.w2c[:3, 3]), **TOL)


def test_project_points_matches_jax(cameras):
    jcam, tcam_ = cameras
    pts = np.random.default_rng(3).normal(0, 0.5, (40, 3)).astype(np.float32)
    got = tcam.project_points(tcam_, t_(pts))
    want = jc.project_points(jcam, jnp.asarray(pts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_project_gaussians_matches_jax(cameras):
    jcam, tcam_ = cameras
    means, rot, scales, _, _ = random_scene(200, seed=11)
    means[:5, 2] = -3.0                           # behind the camera
    got = tcam.project_gaussians(tcam_, t_(means), t_(rot), t_(scales))
    want = jc.project_gaussians(jcam, jnp.asarray(means), jnp.asarray(rot),
                                jnp.asarray(scales))
    np.testing.assert_allclose(got["uv"].numpy(), np.asarray(want["uv"]), rtol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=1e-5)
    np.testing.assert_allclose(got["conic"].numpy(), np.asarray(want["conic"]), rtol=1e-4)
    np.testing.assert_array_equal(got["radius"].numpy(), np.asarray(want["radius"]))
    np.testing.assert_array_equal(got["in_front"].numpy(), np.asarray(want["in_front"]))
    assert not got["in_front"][:5].any()
