"""Whole stages of the port's FLAME tracker against the JAX package's, on the
CPU: the same init, the same landmarks and frames, the same host stream of
frame indices (`np.random.default_rng(0)` per stage), Adam per group.

A landmark stage of 40 steps must end at the reference's loss (rel 2e-3) and
parameters (atol 1e-4); an rgb stage of 10 steps and a 2-frame sequential sweep
of 3 steps a frame at its loss (rel 5e-3).  The fixtures are those of
`tests/test_torch_track.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omfs4d_torch.convert import to_numpy, tracker_params_from_numpy
from omfs4d_torch.track.fitter import FRAME_KEYS, STAGES
from omfs4d.track import fitter as jfit
from tests.test_torch_track import (T, clip, one_torch_thread,  # noqa: F401  (autouse here too)
                                    random_params, to_jax, trackers)


class Recorder:
    def __init__(self):
        self.records = []

    def emit(self, event, **fields):
        self.records.append({"event": event, **fields})


def data_of(tracker, lmk, frames, as_jax):
    if as_jax:
        return {"landmarks": jnp.asarray(lmk), "valid": jnp.ones(len(lmk), bool),
                "frames": tracker._prep_frames(frames)}
    return {"landmarks": torch.from_numpy(lmk), "valid": torch.ones(len(lmk), dtype=torch.bool),
            "frames": tracker._prep_frames(frames)}


def run_both(jt_, tt_, name, p0, steps, trainable, lmk_w, rgb_w, lmk, frames):
    """One stage in both packages from the numpy params `p0`.  Returns
    (reference params, port params, reference loss, port loss)."""
    rj, rt = Recorder(), Recorder()
    pj = jt_._run_stage(name, to_jax(p0), steps, trainable, lmk_w, rgb_w,
                        data_of(jt_, lmk, frames, True), rj)
    start = tracker_params_from_numpy(p0)
    pt = tt_._run_stage(name, start, steps, trainable, lmk_w, rgb_w,
                        data_of(tt_, lmk, frames, False), rt)
    # the port's stage leaves its input as it was
    assert all(np.array_equal(start[k].numpy(), p0[k]) for k in p0)
    assert rt.records[0]["stage"] == name and rt.records[0]["steps"] == steps
    assert set(rt.records[0]) == set(rj.records[0])
    return (jax.tree_util.tree_map(np.asarray, pj), to_numpy(pt),
            rj.records[0]["loss"], rt.records[0]["loss"])


def test_stage_names_and_frame_keys_match_the_reference():
    assert STAGES == jfit.STAGES and FRAME_KEYS == jfit.FRAME_KEYS


def test_landmark_stages_match_jax():
    """lmk_init_rigid, then lmk_init_all with the focal trained, 40 steps each."""
    jt_, tt_ = trackers(optimize_focal=True, lr=0.02)
    _, lmk, frames = clip()
    p0 = to_numpy(tt_.init_params(T))
    rigid = ("rotation", "translation", "focal_log_scale")
    pj, pt, lj, lt = run_both(jt_, tt_, "lmk_init_rigid", p0, 40, rigid, 1.0, 0.0, lmk, None)
    assert abs(lt - lj) <= 2e-3 * lj, (lt, lj)
    for k in p0:
        np.testing.assert_allclose(pt[k], pj[k], atol=1e-4, err_msg=k)
        if k not in rigid:
            assert np.array_equal(pt[k], p0[k]), k         # a frozen key does not move
    assert np.abs(pt["rotation"]).max() > 1e-3 and abs(float(pt["focal_log_scale"])) > 1e-3

    every = ("shape", "expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose",
             "translation", "focal_log_scale")
    qj, qt, lj2, lt2 = run_both(jt_, tt_, "lmk_init_all", pj, 40, every, 1.0, 0.0, lmk, None)
    assert lj2 < lj
    assert abs(lt2 - lj2) <= 2e-3 * lj2, (lt2, lj2)
    for k in p0:
        np.testing.assert_allclose(qt[k], qj[k], atol=1e-4, err_msg=k)
    assert np.abs(qt["shape"]).max() > 1e-3 and not qt["texture"].any()


def test_rgb_texture_stage_matches_jax():
    """rgb_init_texture, splat backend, uv atlas, 10 steps of 4 frames."""
    jt_, tt_ = trackers()
    _, lmk, frames = clip()
    p0 = random_params(tt_)
    p0["texture"] = np.zeros_like(p0["texture"])
    pj, pt, lj, lt = run_both(jt_, tt_, "rgb_init_texture", p0, 10, ("texture",), 0.0, 1.0,
                              lmk, frames)
    assert abs(lt - lj) <= 5e-3 * lj, (lt, lj)
    assert np.abs(pt["texture"]).max() > 0.1
    # Adam's first steps move a texel by its gradient's sign: where the
    # gradient is rounding noise the two packages may step apart, elsewhere not
    close = np.isclose(pt["texture"], pj["texture"], atol=2e-2)
    assert close.mean() > 0.98, close.mean()
    for k in p0:
        if k != "texture":
            assert np.array_equal(pt[k], p0[k]), k


def test_rgb_stage_loss_is_the_last_steps_own():
    """The loss a stage reports is that of its last step, before the update,
    on that step's frames."""
    _, tt_ = trackers()
    _, lmk, frames = clip()
    p0 = tracker_params_from_numpy(random_params(tt_))
    data = data_of(tt_, lmk, frames, False)
    rec = Recorder()
    tt_._run_stage("one", p0, 1, ("texture",), 0.3, 1.0, data, rec)
    idx = np.random.default_rng(0).integers(0, T, size=(4,)).tolist()
    with torch.no_grad():
        want = (tt_._regularizers(p0)
                + 0.3 * tt_._landmark_loss(p0, data["landmarks"], data["valid"])
                + tt_._photometric_loss(p0, data["frames"], idx))
    np.testing.assert_allclose(rec.records[0]["loss"], float(want), rtol=1e-6)


def test_sequential_sweep_matches_jax():
    """2 frames, 3 steps a frame, photometric + landmark, warm-started."""
    jt_, tt_ = trackers()
    _, lmk, frames = clip()
    lmk, frames = lmk[:2], frames[:2]
    p0 = random_params(tt_, 2)
    p0["dynamic_offset"] = np.zeros_like(p0["dynamic_offset"])
    rj, rt = Recorder(), Recorder()
    pj = jt_._run_sequential(to_jax(p0), data_of(jt_, lmk, frames, True), 3, events=rj)
    pj = jax.tree_util.tree_map(np.asarray, pj)
    pt = to_numpy(tt_._run_sequential(tracker_params_from_numpy(p0),
                                      data_of(tt_, lmk, frames, False), 3, events=rt))
    lj, lt = rj.records[0]["loss"], rt.records[0]["loss"]
    assert rt.records[0]["stage"] == "rgb_sequential_tracking" and rt.records[0]["steps"] == 6
    assert abs(lt - lj) <= 5e-3 * lj, (lt, lj)
    assert set(pt) == set(pj)
    for k in p0:
        np.testing.assert_allclose(pt[k], pj[k], atol=2e-3, err_msg=k)
        if k not in FRAME_KEYS:
            assert np.array_equal(pt[k], p0[k]), k         # globals stay frozen
    # frame 1 starts from frame 0's fit, not from its own row
    assert not np.allclose(pt["rotation"][1], p0["rotation"][1], atol=1e-3)


def test_sequential_sweep_warm_starts_and_keeps_fixed_rows():
    """Port alone: only `rotation` is trained; the other per-frame rows keep
    each frame's own values, and with no steps frame t takes frame 0's row."""
    _, tt_ = trackers()
    _, lmk, frames = clip()
    p0 = tracker_params_from_numpy(random_params(tt_))
    data = data_of(tt_, lmk, frames, False)
    out = tt_._run_sequential(p0, data, 2, trainable=("rotation", "shape"), lmk_w=1.0,
                              rgb_w=0.0)
    for k in FRAME_KEYS:
        if k != "rotation":
            assert torch.equal(out[k], p0[k]), k
    assert torch.equal(out["shape"], p0["shape"])           # not a per-frame key
    assert not torch.allclose(out["rotation"], p0["rotation"])
    idle = tt_._run_sequential(p0, data, 2, trainable=("rotation",), lmk_w=0.0, rgb_w=0.0)
    assert torch.equal(idle["rotation"], p0["rotation"][:1].expand(T, 3))


@pytest.mark.parametrize("steps", [0, 3])
def test_stage_draws_frame_indices_in_landmark_stages_too(monkeypatch, steps):
    """One draw of B = min(rgb_batch, T) indices per step, whatever the stage."""
    _, tt_ = trackers()
    _, lmk, _ = clip()
    seen = []
    real = tt_._stage_step

    def spy(params, opt_state, data, frame_idx, lmk_w, rgb_w):
        seen.append(frame_idx)
        return real(params, opt_state, data, frame_idx, lmk_w, rgb_w)

    monkeypatch.setattr(tt_, "_stage_step", spy)
    tt_._run_stage("lmk", tt_.init_params(T), steps, ("rotation",), 1.0, 0.0,
                   data_of(tt_, lmk, None, False), Recorder(), rgb_batch=3)
    rng = np.random.default_rng(0)
    assert seen == [rng.integers(0, T, size=(3,)).tolist() for _ in range(steps)]
