"""The port's FLAME tracker on a CUDA card: an rgb stage step and a sequential
step make no host sync, one rgb step launches K1 and K2 once per rendered
frame (the mesh backend launches neither, and makes no host sync either), and
parameters, moments and frames stay on the card.  Without a card every test here skips.

This file imports only the port (no jax), so it also runs on a machine
without JAX:  python -m pytest --noconftest tests/test_torch_track_card.py
"""

import json

import numpy as np
import pytest
import torch

from omfs4d_torch.core.config import TrackConfig
from omfs4d_torch.core.logging import stage_timer
from omfs4d_torch.io.synthetic import animated_flame_params, textured_gt_avatar
from omfs4d_torch.models.assets import synthetic_flame_asset
from omfs4d_torch.models.flame import FlameModel, flame_forward
from omfs4d_torch.ops.camera import look_at_camera
from omfs4d_torch.render import composite as tc
from omfs4d_torch.render.rasterize import render_avatar_frame
from omfs4d_torch.track.fitter import FlameTracker
from omfs4d_torch.track.landmarks import detect_landmarks
from omfs4d_torch.train.trainer import adam_init

T = 6
S = 64
K = 128
B = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the composite kernels have no CPU mode")
    return torch.device("cuda", 0)


def capture(device):
    """A 6-frame 64^2 clip rendered on `device`: (model, camera, landmarks,
    valid, uint8 frames as numpy)."""
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=700, seed=0), device=device)
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=S * 1.8, width=S, height=S,
                         device=device)
    gt = animated_flame_params(T, model.n_vertices, jaw_amp=0.1)
    avatar = textured_gt_avatar(model, seed=0)
    with torch.no_grad():
        verts = flame_forward(model, gt)
        frames = np.stack([
            np.clip(render_avatar_frame(avatar, verts[i], model.faces, cam, S, S,
                                        max_per_tile=K)[0].cpu().numpy() * 255, 0, 255
                    ).astype(np.uint8) for i in range(T)])
    lmk, valid = detect_landmarks(None, method="synthetic", model=model, params=gt, cameras=cam)
    return model, cam, lmk, valid, frames


def stage_setup(device, **cfg_kw):
    model, cam, lmk, valid, frames = capture(device)
    cfg = TrackConfig(n_shape=10, n_expr=10, texture_res=32, **cfg_kw)
    # the CPU model and camera are copied to the card by the tracker itself
    tracker = FlameTracker(model.cpu(), cfg, look_at_camera(
        eye=(0, 0, 0.5), target=(0, 0, 0), fx=S * 1.8, width=S, height=S), (S, S),
        max_per_tile=K)
    data = {"landmarks": torch.from_numpy(lmk).to(device),
            "valid": torch.from_numpy(valid).to(device),
            "frames": tracker._prep_frames(frames)}
    return tracker, data


TRAINABLE = ("shape", "expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose",
             "translation", "texture", "static_offset")


def one_step(tracker, params, opt_state, data, idx, lmk_w=0.3):
    return tracker._stage_step(params, opt_state, data, idx, lmk_w, 1.0)


def test_tracker_takes_the_card_and_copies_its_inputs(cuda_device):
    tracker, data = stage_setup(cuda_device)
    assert tracker.device == cuda_device
    assert tracker.model.v_template.device == cuda_device
    assert tracker.camera.w2c.device == cuda_device and tracker.p_camera.fx.device == cuda_device
    assert data["frames"].device == cuda_device and data["frames"].dtype == torch.uint8
    assert all(v.device == cuda_device for v in tracker.init_params(T).values())


def test_rgb_step_launches_k1_and_k2_once_per_frame_and_never_syncs(cuda_device):
    tracker, data = stage_setup(cuda_device)
    params = tracker.init_params(T)
    opt_state = {k: adam_init({k: params[k]}) for k in TRAINABLE}
    for i in range(2):                      # warm-up: kernels built, allocator, cuBLAS
        one_step(tracker, params, opt_state, data, [i, 1, 2, 3])
    torch.cuda.synchronize()
    fwd, bwd = tc.composite.launches, tc.composite.backward_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = one_step(tracker, params, opt_state, data, [0, 5, 2, 2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tc.composite.launches - fwd == B
    assert tc.composite.backward_launches - bwd == B
    assert loss.device == cuda_device and bool(torch.isfinite(loss))
    assert all(v.device == cuda_device for v in params.values())
    for state in opt_state.values():
        assert state["count"].device == cuda_device and int(state["count"]) == 3
        assert all(m.device == cuda_device for m in state["mu"].values())
    assert float(params["texture"].abs().max()) > 0


def test_landmark_step_never_syncs_and_launches_nothing(cuda_device):
    tracker, data = stage_setup(cuda_device)
    params = tracker.init_params(T)
    keys = ("rotation", "translation", "focal_log_scale")
    opt_state = {k: adam_init({k: params[k]}) for k in keys}
    tracker._stage_step(params, opt_state, data, [0], 1.0, 0.0)
    torch.cuda.synchronize()
    fwd = tc.composite.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        tracker._stage_step(params, opt_state, data, [0], 1.0, 0.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tc.composite.launches == fwd


def test_sequential_sweep_runs_on_the_card(cuda_device):
    tracker, data = stage_setup(cuda_device)
    params = tracker.init_params(T)
    fwd, bwd = tc.composite.launches, tc.composite.backward_launches
    out = tracker._run_sequential(params, data, 2)
    assert tc.composite.launches - fwd == 2 * T == tc.composite.backward_launches - bwd
    assert all(v.device == cuda_device for v in out.values())
    assert not torch.equal(out["rotation"], params["rotation"])


@pytest.mark.parametrize("mode", ["uv", "flat"])
def test_mesh_backend_launches_no_kernel(cuda_device, mode):
    tracker, data = stage_setup(cuda_device, photometric_backend="mesh", texture_mode=mode)
    params = tracker.init_params(T)
    opt_state = {k: adam_init({k: params[k]}) for k in TRAINABLE}
    fwd, bwd = tc.composite.launches, tc.composite.backward_launches
    first = one_step(tracker, params, opt_state, data, [0, 1, 2, 3], lmk_w=0.0)
    for _ in range(3):
        one_step(tracker, params, opt_state, data, [0, 1, 2, 3], lmk_w=0.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")       # plain PyTorch, and no host sync either
    try:
        last = one_step(tracker, params, opt_state, data, [0, 1, 2, 3], lmk_w=0.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (tc.composite.launches, tc.composite.backward_launches) == (fwd, bwd)
    assert bool(torch.isfinite(last)) and float(last) < float(first)


def test_fit_on_the_card_agrees_with_the_cpu(cuda_device):
    """A landmark fit and two rgb texture steps end where the CPU's end."""
    model, cam, lmk, valid, frames = capture(cuda_device)
    cfg = TrackConfig(n_shape=10, n_expr=10, texture_res=32, steps_lmk_init_rigid=20,
                      steps_lmk_init_all=20, steps_rgb_init_texture=2, steps_rgb_init_all=0,
                      steps_rgb_init_offset=0, steps_rgb_sequential=0, epochs_global=0)
    results = {}
    for dev in ("cpu", cuda_device):
        tracker = FlameTracker(model, cfg, cam, (S, S), max_per_tile=K, device=dev)
        results[str(dev)] = tracker.fit(lmk, valid, frames=frames)
    a, b = results["cpu"], results[str(cuda_device)]
    np.testing.assert_allclose(b.losses["landmark"], a.losses["landmark"], rtol=2e-3)
    np.testing.assert_allclose(b.params["rotation"], a.params["rotation"], atol=1e-4)
    close = np.isclose(b.texture, a.texture, atol=5e-3)
    assert close.mean() > 0.98, close.mean()


def test_stage_timer_traces_the_card(cuda_device, tmp_path):
    with stage_timer("stage", profile_dir=str(tmp_path)):
        torch.ones(1024, device=cuda_device).sum()
        torch.cuda.synchronize()
    trace = json.loads((tmp_path / "stage" / "trace.json").read_text())
    assert any(e.get("cat") == "kernel" for e in trace["traceEvents"])
