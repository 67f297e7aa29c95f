"""Around the port's tracker, on the CPU: the landmark sources and the
preflight gates against the JAX package's, the event log and stage timer, the
tracker's device rules, and the trainer's event stream.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omfs4d.models import flame as jf
from omfs4d.models.assets import synthetic_flame_asset
from omfs4d.ops.camera import look_at_camera as j_look_at_camera
from omfs4d.track import landmarks as jl
from omfs4d.track import preflight as jp
from omfs4d_torch.convert import flame_model_from_numpy
from omfs4d_torch.core import logging as tlog
from omfs4d_torch.core.config import TrackConfig, TrainConfig
from omfs4d_torch.io.video import write_image
from omfs4d_torch.ops.camera import look_at_camera as t_look_at_camera
from omfs4d_torch.track import fitter as tfit
from omfs4d_torch.track import landmarks as tl
from omfs4d_torch.track import preflight as tp
from omfs4d_torch.train import trainer as tt
from tests.test_torch_track import one_torch_thread  # noqa: F401  (autouse here too)

W = H = 64
T, L = 12, 68


@pytest.fixture(scope="module")
def models():
    jm = jf.FlameModel.from_asset(synthetic_flame_asset(n_vertices=700, seed=0))
    return jm, flame_model_from_numpy(jax.tree_util.tree_map(np.asarray, jm)._asdict())


# ── landmark sources ─────────────────────────────────────────


def gt_params(n=5):
    rng = np.random.default_rng(1)
    gt = {"shape": 0.3 * rng.normal(size=300).astype(np.float32),
          "expr": 0.2 * rng.normal(size=(n, 100)).astype(np.float32),
          "rotation": np.zeros((n, 3), np.float32), "jaw_pose": np.zeros((n, 3), np.float32),
          "translation": np.zeros((n, 3), np.float32)}
    gt["jaw_pose"][:, 0] = np.linspace(0.0, 0.25, n)
    gt["rotation"][:, 1] = 0.15 * np.sin(np.linspace(0, 3, n))
    gt["translation"][:, 0] = 0.01 * rng.normal(size=n)
    return gt


@pytest.mark.parametrize("per_frame_cameras", [False, True], ids=["one_camera", "camera_list"])
def test_synthetic_landmarks_match_jax(models, per_frame_cameras):
    jm, tm = models
    kw = dict(eye=(0, 0, 0.5), target=(0, 0, 0), fx=128 * 1.6, width=128, height=128)
    jcam, tcam = j_look_at_camera(**kw), t_look_at_camera(**kw)
    gt = gt_params()
    want, _ = jl.detect_landmarks(None, method="synthetic", model=jm, params=gt,
                                  cameras=[jcam] * 5 if per_frame_cameras else jcam)
    got, valid = tl.detect_landmarks(None, method="synthetic", model=tm, params=gt,
                                     cameras=[tcam] * 5 if per_frame_cameras else tcam)
    assert got.dtype == np.float32 and got.shape == (5, 68, 2) and valid.all()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_file_landmarks_round_trip_in_both_packages(tmp_path):
    rng = np.random.default_rng(0)
    lmk = rng.uniform(0, 64, (4, 68, 2)).astype(np.float32)
    valid = np.array([True, False, True, True])
    tl.save_landmarks(tmp_path / "a" / "landmarks.npz", lmk, valid)
    for mod in (tl, jl):                      # a file of the port reads in both
        got, ok = mod.detect_landmarks(tmp_path / "a", method="file")
        np.testing.assert_allclose(got, lmk)
        assert np.array_equal(ok, valid)
    jl.save_landmarks(tmp_path / "b" / "landmarks.npz", lmk)
    got, ok = tl.detect_landmarks(tmp_path / "b" / "landmarks.npz", method="file")
    np.testing.assert_allclose(got, lmk)
    assert ok.all()


def test_registry_and_the_68_point_map_match_the_reference():
    assert sorted(tl._DETECTORS) == sorted(jl._DETECTORS)
    assert tl.MEDIAPIPE_TO_68 == jl.MEDIAPIPE_TO_68 and len(tl.MEDIAPIPE_TO_68) == 68

    @tl.register_detector("constant")
    def constant(source, value=1.0, **kw):
        return np.full((2, 68, 2), value, np.float32), np.ones(2, bool)

    try:
        got, _ = tl.detect_landmarks(None, method="constant", value=3.0)
        assert (got == 3.0).all()
    finally:
        del tl._DETECTORS["constant"]


def test_unknown_detector_raises():
    with pytest.raises(KeyError, match="nope"):
        tl.detect_landmarks(".", method="nope")


def test_neural_and_auto_without_a_file_are_refused(tmp_path):
    """`neural`, and `auto` when it finds no landmarks.npz, need `model=` to
    render their training set: without it they raise, as the reference does."""
    (tmp_path / "images").mkdir()
    with pytest.raises(ValueError, match="model"):
        tl.detect_landmarks(tmp_path / "images", method="neural")
    with pytest.raises(ValueError, match="model"):
        tl.detect_landmarks(tmp_path / "images", method="auto")
    with pytest.raises(ValueError, match="model"):
        tl.detect_landmarks(np.zeros((1, 8, 8, 3), np.uint8), method="auto")
    with pytest.raises(ValueError, match="model"):
        jl.detect_landmarks(np.zeros((1, 8, 8, 3), np.uint8), method="neural")
    # auto prefers a landmarks.npz beside the images directory, and needs no model
    lmk = np.ones((1, 68, 2), np.float32)
    tl.save_landmarks(tmp_path / "landmarks.npz", lmk)
    got, _ = tl.detect_landmarks(tmp_path / "images", method="auto")
    np.testing.assert_allclose(got, lmk)


@pytest.mark.parametrize("method,library", [("mediapipe", "mediapipe"),
                                            ("face_alignment", "face_alignment")])
def test_adapters_raise_when_their_library_is_missing(method, library, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, library, None)        # import fails
    with pytest.raises(RuntimeError, match="not installed"):
        tl.detect_landmarks(np.zeros((1, 8, 8, 3), np.uint8), method=method)


def test_load_frames_reads_a_directory_in_order(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (3, 8, 10, 3)).astype(np.uint8)
    (tmp_path / "images").mkdir()
    for i in (2, 0, 1):
        write_image(tmp_path / "images" / f"{i:05d}.png", frames[i])
    assert np.array_equal(tl._load_frames(tmp_path), frames)
    assert np.array_equal(tl._load_frames(tmp_path / "images"), frames)
    assert tl._load_frames(frames) is frames
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tl._load_frames(tmp_path / "empty")


def test_load_frames_refuses_jpeg(tmp_path):
    """There is no JPEG decoder here: a frame directory with JPEGs is refused
    with the reason, as `extract_frames` refuses it, not read past."""
    write_image(tmp_path / "00000.png", np.zeros((8, 10, 3), np.uint8))
    (tmp_path / "00001.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(RuntimeError, match="JPEG"):
        tl._load_frames(tmp_path)


# ── preflight gates ──────────────────────────────────────────


def good_landmarks(rng):
    base = np.stack([rng.uniform(0.3 * W, 0.7 * W, L), rng.uniform(0.3 * H, 0.7 * H, L)], axis=1)
    drift = np.cumsum(rng.normal(0, 0.3, (T, 1, 2)), axis=0)
    return (base[None] + drift).astype(np.float32), np.ones(T, bool)


def landmark_case(name):
    rng = np.random.default_rng(0)
    lmk, valid = good_landmarks(rng)
    if name == "low_valid":
        valid[: int(0.7 * T)] = False
    elif name == "out_of_bounds":
        lmk = lmk + 3 * W
    elif name == "collapse":
        lmk = np.full((T, L, 2), W / 2, np.float32)
        lmk += np.random.default_rng(0).normal(0, 0.05, lmk.shape)
    elif name == "jitter":
        lmk = np.asarray(np.random.default_rng(1).uniform(0, W, (T, L, 2)), np.float32)
    elif name == "none_valid":
        valid[:] = False
    return lmk, valid


@pytest.mark.parametrize("name,word", [
    ("good", None), ("low_valid", "valid"), ("out_of_bounds", "in-bounds"),
    ("collapse", "collapse"), ("jitter", "jitter"), ("none_valid", "valid")])
def test_landmark_preflight_matches_jax(name, word):
    lmk, valid = landmark_case(name)
    want = jp.landmark_preflight(lmk, valid, W, H)
    got = tp.landmark_preflight(lmk, valid, W, H)
    assert got.ok == want.ok == (word is None)
    assert got.reasons == want.reasons and got.stats == want.stats
    assert got.asdict() == want.asdict()
    if word:
        assert any(word in r for r in got.reasons)


def blob(cx):
    yy, xx = np.mgrid[:H, :W]
    return ((yy - H / 2) ** 2 + (xx - cx) ** 2 < (H / 4) ** 2).astype(np.float32)


MASK_CASES = {
    "stable_blob": lambda: np.stack([blob(W / 2 + 0.2 * t) for t in range(T)]),
    "all_background": lambda: np.zeros((T, H, W), np.float32),
    "all_foreground": lambda: np.ones((T, H, W), np.float32),
    "flicker": lambda: np.stack([blob(W / 4 if t % 2 else 3 * W / 4) for t in range(T)]),
}


@pytest.mark.parametrize("name", sorted(MASK_CASES))
def test_mask_preflight_matches_jax(name):
    masks = MASK_CASES[name]()
    want, got = jp.mask_preflight(masks), tp.mask_preflight(masks)
    assert got.ok == want.ok == (name == "stable_blob")
    assert got.reasons == want.reasons and got.stats == want.stats
    if name == "flicker":
        assert any("IoU" in r for r in got.reasons)


# ── events and stage timing ──────────────────────────────────


def test_event_logger_appends_jsonl(tmp_path):
    log = tlog.EventLogger(tmp_path / "deep" / "events.jsonl")
    rec = log.emit("track_stage", stage="lmk", loss=np.float32(0.25), steps=3)
    assert rec["event"] == "track_stage" and rec["t"] > 0
    log.emit("other", n=1)
    lines = [json.loads(x) for x in (tmp_path / "deep" / "events.jsonl").read_text().splitlines()]
    assert [x["event"] for x in lines] == ["track_stage", "other"]
    assert lines[0]["loss"] == 0.25 and lines[0]["steps"] == 3
    # with no path the record is only returned
    assert tlog.EventLogger().emit("x", a=1)["a"] == 1


def test_stage_timer_records_start_and_end(tmp_path):
    log = tlog.EventLogger(tmp_path / "events.jsonl")
    with pytest.raises(ValueError):
        with tlog.stage_timer("track", log) as ev:
            assert ev is log
            raise ValueError("the end is recorded all the same")
    lines = [json.loads(x) for x in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert [(x["event"], x["stage"]) for x in lines] == [("stage_start", "track"),
                                                         ("stage_end", "track")]
    assert lines[1]["seconds"] >= 0
    with tlog.stage_timer("quiet") as ev:                  # makes its own logger
        assert isinstance(ev, tlog.EventLogger)


def test_stage_timer_writes_a_profiler_trace(tmp_path):
    with tlog.stage_timer("stage", profile_dir=str(tmp_path / "prof")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "prof" / "stage" / "trace.json").read_text())
    assert trace["traceEvents"]


# ── the tracker's device ─────────────────────────────────────


def tracker_args(models):
    _, tm = models
    cam = t_look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=100.0, width=W, height=H)
    return tm, TrackConfig(n_shape=10, n_expr=10), cam, (W, H)


def test_tracker_defaults_to_the_card_and_raises_without_one(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfit.FlameTracker(*tracker_args(models))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfit.FlameTracker(*tracker_args(models), device="cuda")
    tracker = tfit.FlameTracker(*tracker_args(models), device="cpu")
    assert tracker.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in tracker.init_params(2).values())


def test_tracker_takes_a_device_mesh(models):
    """`mesh=` shards the frame axis of the batched stages (its world of 2 is
    in test_torch_parallel_pipeline); on a mesh of one rank a landmark stage
    equals the one without a mesh."""
    from omfs4d_torch.core.logging import EventLogger
    from omfs4d_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(0)
    T = 3
    data = {"landmarks": torch.as_tensor(W / 2 + rng.normal(0, W / 6, (T, 68, 2)),
                                         dtype=torch.float32),
            "valid": torch.ones(T, dtype=torch.bool), "frames": None}
    out = []
    for mesh in (Mesh(np.arange(1), ("data",)), None):
        tr = tfit.FlameTracker(*tracker_args(models), mesh=mesh, device="cpu")
        assert tr.mesh is mesh
        p = tr._run_stage("lmk_init_all", tr.init_params(T), 5, ("expr", "rotation", "jaw_pose"),
                          1.0, 0.0, data, EventLogger())
        out.append(p)
    for k in out[0]:
        np.testing.assert_allclose(out[0][k].numpy(), out[1][k].numpy(), atol=1e-6, err_msg=k)


def test_tracker_has_no_kernel_switch(models):
    """The device picks the composite: `use_pallas` is not carried over."""
    with pytest.raises(TypeError):
        tfit.FlameTracker(*tracker_args(models), use_pallas="never", device="cpu")


def test_group_rates_match_the_reference(models):
    import optax                                           # noqa: F401  (the reference's)
    from omfs4d.core.config import TrackConfig as JTrackConfig
    from omfs4d.track.fitter import FlameTracker as JFlameTracker

    jm, _ = models
    tracker = tfit.FlameTracker(*tracker_args(models), device="cpu")
    lrs = tracker.group_lr
    assert sorted(lrs) == sorted(tracker.init_params(1))
    # the reference's rates, read off its optimizer: one Adam step on a unit
    # gradient moves a parameter by its group's rate
    jt_ = JFlameTracker(jm, JTrackConfig(n_shape=10, n_expr=10),
                        j_look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=100.0,
                                         width=W, height=H), (W, H), use_pallas="never")
    p = jt_.init_params(1)
    opt = jt_._make_opt()
    updates, _ = opt.update(jax.tree_util.tree_map(jnp.ones_like, p), opt.init(p), p)
    for k, lr in lrs.items():
        np.testing.assert_allclose(-float(np.asarray(updates[k]).ravel()[0]), lr, rtol=1e-4,
                                   err_msg=k)


# ── the trainer's event stream ───────────────────────────────


def test_train_sends_its_events_to_a_given_logger_and_makes_one_otherwise(tmp_path, monkeypatch):
    from omfs4d_torch.io.synthetic import make_synthetic_dataset
    from tests.test_torch_train_resume import capture_data

    case = make_synthetic_dataset(tmp_path / "data", n_frames=2, width=W, height=H,
                                  n_vertices=700, seed=0, device="cpu")
    data = capture_data(case)
    cfg = TrainConfig(iterations=4, opacity_reset_interval=0, densify_interval=0,
                      max_gaussians=1024, batch_frames=1)
    trainer = tt.AvatarTrainer(case["model"].faces.numpy(), cfg, W, H, max_per_tile=128,
                               device="cpu")
    log = tlog.EventLogger(tmp_path / "events.jsonl")
    trainer.train(data, iterations=4, state=trainer.init_state(capacity=1024), events=log,
                  log_every=2)
    lines = [json.loads(x) for x in (tmp_path / "events.jsonl").read_text().splitlines()]
    steps = [x for x in lines if x["event"] == "train_step"]
    assert [x["iter"] for x in steps] == [2, 4]
    assert all(np.isfinite(x["loss"]) and x["capacity"] == 1024 for x in steps)

    # with no logger given the trainer makes one, as the reference does
    made = []

    def spy(*a, **kw):
        made.append(tlog.EventLogger(*a, **kw))
        return made[-1]

    monkeypatch.setattr(tt, "EventLogger", spy)
    trainer.train(data, iterations=2, state=trainer.init_state(capacity=1024), log_every=2)
    assert len(made) == 1 and made[0].path is None
