"""`FlameTracker.fit` end to end in the port alone, on the CPU: the port's
copies of the reference's tracker tests (known parameters recovered from
projected landmarks, a wrong focal guess refined, contract shapes), a short
photometric fit whose rgb stages lower the photometric loss, and the path from
a directory of frames to a dataset that reads back.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from omfs4d_torch.core.config import TrackConfig
from omfs4d_torch.core.logging import EventLogger
from omfs4d_torch.io.dataset import FrameDataset, write_dataset
from omfs4d_torch.io.synthetic import animated_flame_params, textured_gt_avatar
from omfs4d_torch.io.video import write_image
from omfs4d_torch.models.assets import synthetic_flame_asset
from omfs4d_torch.models.flame import FlameModel, flame_forward, flame_landmarks
from omfs4d_torch.ops.camera import look_at_camera, project_points
from omfs4d_torch.render.rasterize import render_avatar_frame
from omfs4d_torch.track.fitter import FlameTracker, TrackerResult
from omfs4d_torch.track.landmarks import detect_landmarks, save_landmarks
from omfs4d_torch.track.preflight import landmark_preflight

from tests.test_torch_track import one_torch_thread  # noqa: E402,F401  (autouse here too)

T = 6
W = H = 128


@pytest.fixture(scope="module")
def setup():
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=700, seed=0))
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=W * 1.6, width=W, height=H)
    rng = np.random.default_rng(1)
    gt = {
        "shape": np.zeros(300, np.float32),
        "expr": np.zeros((T, 100), np.float32),
        "rotation": np.zeros((T, 3), np.float32),
        "neck_pose": np.zeros((T, 3), np.float32),
        "jaw_pose": np.zeros((T, 3), np.float32),
        "eyes_pose": np.zeros((T, 6), np.float32),
        "translation": np.zeros((T, 3), np.float32),
    }
    gt["jaw_pose"][:, 0] = np.linspace(0.0, 0.25, T)
    gt["rotation"][:, 1] = 0.15 * np.sin(np.linspace(0, 3, T))
    gt["translation"][:, 0] = 0.01 * rng.normal(size=T)
    with torch.no_grad():
        lmk3d = flame_landmarks(model, flame_forward(model, gt))
        lmk2d = project_points(cam, lmk3d)[0].numpy()
    return model, cam, gt, lmk2d


def test_landmark_fit_recovers_pose(setup):
    model, cam, gt, lmk2d = setup
    cfg = TrackConfig(n_shape=50, n_expr=20, steps_lmk_init_rigid=200, steps_lmk_init_all=200,
                      photometric=False, lr=0.02)
    tracker = FlameTracker(model, cfg, cam, (W, H), device="cpu")
    result = tracker.fit(lmk2d, np.ones(T, bool))
    assert isinstance(result, TrackerResult)

    # reprojection error must be small (units: normalized image fraction^2)
    assert result.losses["landmark"] < 5e-5, result.losses
    # landmark-only fitting under-constrains the jaw's magnitude, but its
    # temporal trend must follow the ground truth
    jaw = result.params["jaw_pose"][:, 0]
    corr = np.corrcoef(jaw, gt["jaw_pose"][:, 0])[0, 1]
    assert corr > 0.9, (jaw, corr)

    # contract shapes, as numpy
    assert result.params["shape"].shape == (300,)
    assert result.params["expr"].shape == (T, 100)
    assert result.params["static_offset"].shape == (1, model.n_vertices, 3)
    assert result.params["dynamic_offset"].shape == (T, model.n_vertices, 3)
    assert not result.params["shape"][50:].any() and not result.params["expr"][:, 20:].any()
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
               for v in result.params.values())
    assert result.texture.shape == (128, 128, 3) and np.allclose(result.texture, 0.5)


def test_focal_optimization_recovers_wrong_guess(setup):
    """Landmarks made with the true focal, tracked from a guess 30% off: with
    optimize_focal the fit must reach the loss of a perfect guess, and beat
    the frozen-focal fit from the same wrong guess."""
    model, cam, gt, lmk2d = setup

    def fit_with(fx_scale, optimize_focal):
        bad_cam = dataclasses.replace(cam, fx=cam.fx * fx_scale, fy=cam.fy * fx_scale)
        cfg = TrackConfig(n_shape=50, n_expr=20, steps_lmk_init_rigid=250,
                          steps_lmk_init_all=250, photometric=False, lr=0.02,
                          optimize_focal=optimize_focal)
        r = FlameTracker(model, cfg, bad_cam, (W, H), device="cpu").fit(lmk2d, np.ones(T, bool))
        return r.losses["landmark"], r.focal_scale

    loss_perfect, _ = fit_with(1.0, True)
    loss_wrong_frozen, s_frozen = fit_with(1.3, False)
    loss_wrong_opt, s_opt = fit_with(1.3, True)

    assert s_frozen == 1.0
    # the refined focal moved toward the true one (scale 1/1.3 = 0.77)
    assert s_opt < 0.95, s_opt
    assert loss_wrong_opt < loss_wrong_frozen, (loss_wrong_opt, loss_wrong_frozen)
    assert loss_wrong_opt < max(5e-5, 3.0 * loss_perfect), (loss_perfect, loss_wrong_opt)


def test_fit_takes_tensors_and_init_params_and_skips_rgb_without_frames(setup):
    model, cam, gt, lmk2d = setup
    cfg = TrackConfig(n_shape=10, n_expr=10, steps_lmk_init_rigid=3, steps_lmk_init_all=3,
                      photometric=True)
    tracker = FlameTracker(model, cfg, cam, (W, H), device="cpu")
    init = tracker.init_params(T)
    init["rotation"] = init["rotation"] + 0.01
    events = []

    class Rec:
        def emit(self, event, **fields):
            events.append(fields.get("stage"))

    r = tracker.fit(torch.from_numpy(lmk2d), torch.ones(T, dtype=torch.bool), events=Rec(),
                    init_params={k: v.numpy() for k, v in init.items()})
    assert events == ["lmk_init_rigid", "lmk_init_all"]      # no frames: no rgb stage
    assert np.isfinite(r.losses["landmark"])


def photometric_clip(n_frames=4, size=64):
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=700, seed=0))
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=size * 1.8, width=size,
                         height=size)
    gt = animated_flame_params(n_frames, model.n_vertices, jaw_amp=0.1)
    gt["translation"][:, 0] += 0.01
    avatar = textured_gt_avatar(model, seed=0)
    with torch.no_grad():
        verts = flame_forward(model, gt)
        frames = np.stack([
            np.clip(render_avatar_frame(avatar, verts[i], model.faces, cam, size, size,
                                        max_per_tile=128)[0].numpy() * 255, 0, 255
                    ).astype(np.uint8) for i in range(n_frames)])
    lmk, valid = detect_landmarks(None, method="synthetic", model=model, params=gt, cameras=cam)
    return model, cam, gt, frames, lmk, valid


def logit(x):
    x = np.clip(x, 1e-3, 1 - 1e-3)
    return np.log(x / (1 - x)).astype(np.float32)


def params_of(tracker, result, n_frames):
    """The tracker dict of a TrackerResult (the contract's padding cut off)."""
    cfg = tracker.cfg
    p = tracker.init_params(n_frames)
    for k in p:
        if k == "shape":
            p[k] = torch.from_numpy(result.params["shape"][: cfg.n_shape])
        elif k == "expr":
            p[k] = torch.from_numpy(result.params["expr"][:, : cfg.n_expr])
        elif k in result.params:
            p[k] = torch.from_numpy(result.params[k])
    p["texture"] = torch.from_numpy(logit(result.texture))
    return p


@pytest.mark.parametrize("backend", ["splat", "mesh"])
def test_short_photometric_fit_lowers_the_photometric_loss(backend, tmp_path):
    """Every stage of the schedule runs (texture, all, offset, sequential,
    global), each emits its event, and the fit ends below the photometric loss
    at the untextured init."""
    n, size = 4, 64
    model, cam, gt, frames, lmk, valid = photometric_clip(n, size)
    cfg = TrackConfig(n_shape=10, n_expr=10, steps_lmk_init_rigid=40, steps_lmk_init_all=40,
                      steps_rgb_init_texture=20, steps_rgb_init_all=8, steps_rgb_init_offset=4,
                      steps_rgb_sequential=2, steps_global=6, epochs_global=1, lr=0.015,
                      photometric_backend=backend, texture_res=32)
    tracker = FlameTracker(model, cfg, cam, (size, size), max_per_tile=128, device="cpu")
    data_frames = tracker._prep_frames(frames)
    idx = list(range(n))
    with torch.no_grad():
        before = float(tracker._photometric_loss(tracker.init_params(n), data_frames, idx))
    log = tmp_path / "events.jsonl"
    result = tracker.fit(lmk, valid, frames=frames, events=EventLogger(log))
    with torch.no_grad():
        after = float(tracker._photometric_loss(params_of(tracker, result, n), data_frames, idx))
    assert after < before * 0.8, (before, after)
    assert result.texture.std() > 0.03 and result.texture.shape == (32, 32, 3)
    stages = [json.loads(line) for line in log.read_text().splitlines()]
    assert [s["stage"] for s in stages] == [
        "lmk_init_rigid", "lmk_init_all", "rgb_init_texture", "rgb_init_all",
        "rgb_init_offset", "rgb_sequential_tracking", "global_optimization_0"]
    assert all(s["event"] == "track_stage" and np.isfinite(s["loss"]) for s in stages)
    assert stages[5]["steps"] == 2 * n


def test_frames_to_dataset_through_the_tracker(tmp_path):
    """A directory of frames with landmarks -> detect_landmarks -> preflight
    -> fit -> write_dataset with the refined focal -> FrameDataset."""
    n, size = 4, 64
    model, cam, gt, frames, lmk, valid = photometric_clip(n, size)
    images = tmp_path / "capture" / "images"
    images.mkdir(parents=True)
    for i, f in enumerate(frames):
        write_image(images / f"{i:05d}.png", f)
    save_landmarks(images / "landmarks.npz", lmk, valid)

    got, ok = detect_landmarks(images, method="auto")
    np.testing.assert_allclose(got, lmk)
    assert landmark_preflight(got, ok, size, size).ok
    from omfs4d_torch.track.landmarks import _load_frames
    loaded = _load_frames(images.parent)
    assert np.array_equal(loaded, frames)

    cfg = TrackConfig(n_shape=10, n_expr=10, steps_lmk_init_rigid=30, steps_lmk_init_all=30,
                      steps_rgb_init_texture=4, steps_rgb_init_all=2, steps_rgb_init_offset=0,
                      steps_rgb_sequential=0, steps_global=2, epochs_global=1, texture_res=32)
    tracker = FlameTracker(model, cfg, cam, (size, size), max_per_tile=128, device="cpu")
    result = tracker.fit(got, ok, frames=loaded)

    c2w = np.linalg.inv(cam.w2c.numpy().astype(np.float64))
    c2w[:3, 1:3] *= -1.0
    out = write_dataset(tmp_path / "dataset", loaded, np.tile(c2w[None], (n, 1, 1)),
                        float(cam.fx) * result.focal_scale, float(cam.fy) * result.focal_scale,
                        float(cam.cx), float(cam.cy), flame_params=result.params,
                        n_verts=model.n_vertices)
    ds = FrameDataset(out, split="train")
    assert len(ds) == n - n // 10 or len(ds) == n
    assert ds.flame_params["shape"].shape == (300,)
    assert ds.flame_params["expr"].shape == (n, 100)
    np.testing.assert_allclose(ds.intrinsics["fl_x"], float(cam.fx) * result.focal_scale)
    np.testing.assert_allclose(ds.camera(0).w2c.numpy(), cam.w2c.numpy(), atol=1e-5)
    assert np.array_equal(ds.load_image(0), frames[0])
