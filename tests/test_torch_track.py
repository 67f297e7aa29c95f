"""The port's FLAME tracker losses against the JAX package's, on the CPU.

Both trackers get the same 700-vertex synthetic asset, the same camera, the
same seeded parameters (all 11 keys away from zero), the same landmark targets
and the same uint8 frames (a 4-frame 64^2 clip rendered by the port's textured
ground-truth avatar).  The JAX tracker runs with `use_pallas="never"`, as its
own tests run it on the CPU.

Tolerances: `_landmark_loss` and `_regularizers` value rel 1e-5,
`_photometric_loss` value rel 1e-4; the gradient of every key atol
2e-4 * max|g|, rtol 2e-3.  The splat backend renders coplanar neighbour
splats whose order hangs on a quantized depth key, so values and gradients are
compared to these tolerances and never as lists or bits.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omfs4d.core.config import TrackConfig as JTrackConfig
from omfs4d.models import flame as jf
from omfs4d.models.assets import synthetic_flame_asset
from omfs4d.ops.camera import look_at_camera as j_look_at_camera
from omfs4d.track.fitter import FlameTracker as JFlameTracker
from omfs4d_torch.convert import flame_model_from_numpy, to_numpy, tracker_params_from_numpy
from omfs4d_torch.core.config import TrackConfig
from omfs4d_torch.io.synthetic import animated_flame_params, textured_gt_avatar
from omfs4d_torch.models.flame import flame_forward
from omfs4d_torch.ops.camera import look_at_camera as t_look_at_camera
from omfs4d_torch.render.rasterize import render_avatar_frame
from omfs4d_torch.track.fitter import FlameTracker
from omfs4d_torch.track.landmarks import detect_landmarks

T = 4
S = 64
K = 128
GRAD_TOL = 2e-4, 2e-3      # atol * max|reference gradient|, rtol


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tracker's steps are hundreds of tiny ops: with several test workers
    on one machine, intra-op threads only contend for the cores (a fit slows
    down 25-fold).  The tracker's other test files import this fixture."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.cache
def models():
    jm = jf.FlameModel.from_asset(synthetic_flame_asset(n_vertices=700, seed=0))
    return jm, flame_model_from_numpy(jax.tree_util.tree_map(np.asarray, jm)._asdict())


def cameras(size=S, fx_scale=1.6):
    kw = dict(eye=(0, 0, 0.5), target=(0, 0, 0), fx=size * fx_scale, width=size, height=size)
    return j_look_at_camera(**kw), t_look_at_camera(**kw)


def trackers(size=S, max_per_tile=K, **cfg_kw):
    """The JAX tracker and the port's, with one configuration."""
    cfg_kw = dict(dict(n_shape=10, n_expr=10, texture_res=32, lr=0.015), **cfg_kw)
    jm, tm = models()
    jcam, tcam = cameras(size)
    return (JFlameTracker(jm, JTrackConfig(**cfg_kw), jcam, (size, size),
                          max_per_tile=max_per_tile, use_pallas="never"),
            FlameTracker(tm, TrackConfig(**cfg_kw), tcam, (size, size),
                         max_per_tile=max_per_tile, device="cpu"))


@functools.cache
def clip(n_frames=T, size=S):
    """(ground-truth params, landmarks (T, 68, 2), uint8 frames (T, S, S, 3))
    of a clip with a static camera and a moving head."""
    _, tm = models()
    _, tcam = cameras(size)
    gt = animated_flame_params(n_frames, tm.n_vertices, jaw_amp=0.1)
    gt["translation"][:, 0] += 0.01
    lmk, _ = detect_landmarks(None, method="synthetic", model=tm, params=gt, cameras=tcam)
    avatar = textured_gt_avatar(tm, seed=0)
    with torch.no_grad():
        verts = flame_forward(tm, gt)
        frames = np.stack([
            np.clip(render_avatar_frame(avatar, verts[i], tm.faces, tcam, size, size,
                                        max_per_tile=K)[0].numpy() * 255, 0, 255
                    ).astype(np.uint8) for i in range(n_frames)])
    return gt, lmk, frames


def random_params(tracker, n_frames=T, seed=0):
    """All 11 tracker keys away from zero, as numpy (shapes of `init_params`)."""
    rng = np.random.default_rng(seed)
    scale = {"shape": 0.5, "expr": 0.3, "rotation": 0.1, "neck_pose": 0.05,
             "jaw_pose": 0.1, "eyes_pose": 0.05, "translation": 0.005, "texture": 1.0,
             "static_offset": 1e-3, "dynamic_offset": 1e-3, "focal_log_scale": 0.05}
    return {k: (scale[k] * rng.normal(size=tuple(v.shape))).astype(np.float32)
            for k, v in tracker.init_params(n_frames).items()}


def to_jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def leaves(p):
    return {k: v.requires_grad_() for k, v in tracker_params_from_numpy(p).items()}


def assert_value_close(got, want, rel, name):
    assert np.isfinite(got) and abs(got - want) <= rel * abs(want), (name, got, want)


def assert_grads_close(loss_t, p_t, grads_j, need=()):
    """The gradient of every key; a key the loss does not reach is zero in
    JAX and absent (or zero) in the port.  `need` lists keys whose gradient
    must not vanish."""
    grads_t = torch.autograd.grad(loss_t, list(p_t.values()), allow_unused=True)
    for (k, _), gt_ in zip(p_t.items(), grads_t):
        want = np.asarray(grads_j[k])
        assert np.isfinite(want).all(), k
        scale = np.abs(want).max()
        if scale == 0:
            assert gt_ is None or not gt_.any(), k
            assert k not in need, k
            continue
        assert gt_ is not None and bool(torch.isfinite(gt_).all()), k
        np.testing.assert_allclose(gt_.numpy(), want, atol=GRAD_TOL[0] * scale,
                                   rtol=GRAD_TOL[1], err_msg=k)


# ── parameters and cameras ───────────────────────────────────


def test_init_params_match_the_reference_and_round_trip():
    jt_, tt_ = trackers()
    pj, pt = jt_.init_params(T), tt_.init_params(T)
    assert list(pj) == list(pt)
    for k in pj:
        assert tuple(pt[k].shape) == tuple(pj[k].shape) and not pt[k].any(), k
        assert pt[k].dtype == torch.float32
    p = random_params(tt_)
    back = to_numpy(tracker_params_from_numpy(p))
    assert all(np.array_equal(back[k], p[k]) for k in p)
    with pytest.raises(KeyError, match="texture"):
        tracker_params_from_numpy({k: v for k, v in p.items() if k != "texture"})


@pytest.mark.parametrize("mode,backend,shape", [
    ("uv", "splat", (32, 32, 3)), ("flat", "splat", (1396, 3)), ("flat", "mesh", (700, 3))])
def test_texture_shape_follows_mode_and_backend(mode, backend, shape):
    jt_, tt_ = trackers(texture_mode=mode, photometric_backend=backend)
    assert tt_._texture_shape() == jt_._texture_shape() == shape


def test_scaled_and_downsampled_cameras_match_jax():
    jt_, tt_ = trackers(rgb_downsample=2)
    p = random_params(tt_)
    cj = jt_._scaled_camera(jt_.p_camera, to_jax(p))
    ct = tt_._scaled_camera(tt_.p_camera, tracker_params_from_numpy(p))
    assert (ct.width, ct.height) == (cj.width, cj.height) == (S // 2, S // 2)
    for k in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(float(getattr(ct, k)), float(getattr(cj, k)), rtol=1e-6)
    assert tt_._scaled_camera(tt_.camera, {}) is tt_.camera


# ── landmark loss and regularizers ───────────────────────────


@pytest.mark.parametrize("case", ["all_valid", "one_invalid", "single_frame", "offsets_off"])
def test_landmark_loss_matches_jax(case):
    n = 1 if case == "single_frame" else T
    jt_, tt_ = trackers(use_static_offset=case != "offsets_off",
                        use_dynamic_offset=case != "offsets_off")
    p = random_params(tt_, n)
    rng = np.random.default_rng(2)
    lmk = (clip()[1][:n] + rng.normal(0, 1.5, (n, 68, 2))).astype(np.float32)
    valid = np.ones(n, bool)
    if case == "one_invalid":
        valid[1] = False
    want, grads = jax.value_and_grad(
        lambda q: jt_._landmark_loss(q, jnp.asarray(lmk), jnp.asarray(valid)))(to_jax(p))
    p_t = leaves(p)
    got = tt_._landmark_loss(p_t, torch.from_numpy(lmk), torch.from_numpy(valid))
    assert_value_close(float(got.detach()), float(want), 1e-5, case)
    need = ("rotation", "focal_log_scale", "shape") + (
        () if case == "offsets_off" else ("static_offset", "dynamic_offset"))
    assert_grads_close(got, p_t, grads, need)


@pytest.mark.parametrize("n", [1, T], ids=["T1", "T4"])
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_regularizers_match_jax(n, dynamic):
    jt_, tt_ = trackers(use_dynamic_offset=dynamic, use_static_offset=False)
    p = random_params(tt_, n)
    want, grads = jax.value_and_grad(jt_._regularizers)(to_jax(p))
    p_t = leaves(p)
    got = tt_._regularizers(p_t)
    assert_value_close(float(got.detach()), float(want), 1e-5, "regularizers")
    # the static offset is regularized whether or not it is in use
    need = ("shape", "expr", "jaw_pose", "static_offset") + (
        ("dynamic_offset",) if dynamic else ()) + (("rotation",) if n > 1 else ())
    assert_grads_close(got, p_t, grads, need)


# ── photometric loss ─────────────────────────────────────────


PHOTO_CASES = {
    "splat_uv": dict(photometric_backend="splat", texture_mode="uv"),
    "splat_flat": dict(photometric_backend="splat", texture_mode="flat"),
    "mesh_uv": dict(photometric_backend="mesh", texture_mode="uv"),
    "mesh_flat": dict(photometric_backend="mesh", texture_mode="flat"),
    "splat_uv_down2": dict(photometric_backend="splat", texture_mode="uv", rgb_downsample=2),
}


@pytest.mark.parametrize("case", sorted(PHOTO_CASES))
def test_photometric_loss_matches_jax(case):
    jt_, tt_ = trackers(**PHOTO_CASES[case])
    p = random_params(tt_)
    p["focal_log_scale"] = np.float32(0.02)
    frames = clip()[2]
    fj, ft = jt_._prep_frames(frames), tt_._prep_frames(frames)
    if "down2" in case:
        # the loss is held on the same pixels: the port's own resize is
        # checked on its own, within a grey level, below
        ft = torch.from_numpy(np.array(fj))
    idx = [2, 0, 3]
    want, grads = jax.value_and_grad(
        lambda q: jt_._photometric_loss(q, fj, jnp.asarray(idx, jnp.int32)))(to_jax(p))
    p_t = leaves(p)
    got = tt_._photometric_loss(p_t, ft, idx)
    assert_value_close(float(got.detach()), float(want), 1e-4, case)
    assert_grads_close(got, p_t, grads,
                       need=("texture", "rotation", "translation", "shape", "expr",
                             "static_offset", "focal_log_scale"))


def test_texture_avatar_keeps_the_texture_in_the_graph():
    from omfs4d_torch.track.fitter import _texture_avatar

    _, tm = models()
    logits = torch.randn(tm.faces.shape[0], 3, requires_grad=True)
    avatar = _texture_avatar(tm, logits)
    assert avatar.color is logits
    assert avatar.parent_face.dtype == torch.int32 and bool(avatar.alive.all())
    np.testing.assert_allclose(avatar.log_scale[0].numpy(),
                               np.log([0.7, 0.7, 0.14]).astype(np.float32), rtol=1e-6)
    np.testing.assert_allclose(torch.sigmoid(avatar.opacity_logit[:1]).numpy(), [0.98],
                               rtol=1e-6)


@pytest.mark.parametrize("d", [2, 3])
def test_prep_frames_downsamples_within_a_grey_level(d):
    jt_, tt_ = trackers(rgb_downsample=d)
    rng = np.random.default_rng(d)
    frames = clip()[2].copy()
    frames[1] = rng.integers(0, 256, frames[1].shape)       # a frame of noise
    frames[2, ::2] = 255                                    # saturated stripes
    want = np.asarray(jt_._prep_frames(frames))
    got = tt_._prep_frames(frames)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (T, S // d, S // d, 3)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    assert tt_._prep_frames(None) is None


def test_prep_frames_keeps_full_resolution_frames():
    _, tt_ = trackers()
    frames = clip()[2]
    got = tt_._prep_frames(frames)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), frames)
    assert np.array_equal(tt_._prep_frames(torch.from_numpy(frames)).numpy(), frames)


def test_config_copy_matches_the_reference():
    assert dataclasses.asdict(TrackConfig()) == dataclasses.asdict(JTrackConfig())
