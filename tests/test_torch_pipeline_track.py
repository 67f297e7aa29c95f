"""The port's pipeline runner on the CPU: `Pipeline.preprocess` and
`Pipeline.track`, both fallback chains (the counterparts of the reference's
`TestPipelineFallback`), the landmark registry's `neural` / `auto` sources,
frame extraction, and the artifact store against the JAX package's.

A capture of JPEG frames is probed, preprocessed and tracked.  The end-to-end
case runs at 64^2 on the 700-vertex asset: a directory of PNG frames with no
landmark file -> `preprocess` -> `track(landmark_method=
"neural")` with a detector trained for a few dozen steps -> a dataset that
`FrameDataset` reads, and the second call answered by the stage cache.
"""

import json

import cv2
import numpy as np
import pytest
import torch

from omfs4d.core import artifacts as jart
from omfs4d_torch.core import artifacts as tart
from omfs4d_torch.core.config import Config
from omfs4d_torch.io import video as tvideo
from omfs4d_torch.io.dataset import FrameDataset
from omfs4d_torch.models import assets as tassets
from omfs4d_torch.ops.camera import look_at_camera
from omfs4d_torch.pipeline import runner as trunner
from omfs4d_torch.track import detector as tdet
from omfs4d_torch.track import landmarks as tl
from tests.test_torch_track import one_torch_thread  # noqa: F401  (autouse here too)
from tests.test_torch_track_io import good_landmarks

W = H = 64
T, L = 12, 68


@pytest.fixture
def small_asset(monkeypatch, tmp_path):
    """Pipelines of this file run on the 700-vertex asset, with every cache
    under the test's directory."""
    real = tassets.synthetic_flame_asset
    monkeypatch.setattr(trunner, "synthetic_flame_asset", lambda: real(n_vertices=700, seed=0))
    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))


@pytest.fixture
def pipe(small_asset, tmp_path):
    return trunner.Pipeline(Config(), tmp_path / "work", device="cpu")


def events(runner) -> list[dict]:
    path = runner.events.path
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines()]


# ── the fallback chains ──────────────────────────────────────


def test_corrupted_landmarks_fall_back_to_file(pipe, tmp_path):
    images_dir = tmp_path / "case" / "images"
    images_dir.mkdir(parents=True)
    good, valid = good_landmarks(np.random.default_rng(0))
    tl.save_landmarks(images_dir.parent / "landmarks.npz", good, valid)
    bad = np.full((T, L, 2), W / 2, np.float32)               # collapsed
    out, out_valid = pipe._landmarks_with_fallback(bad, np.ones(T, bool), images_dir, W, H)
    np.testing.assert_allclose(out, good, atol=1e-5)
    assert out_valid.all()
    evs = events(pipe)
    assert any(e["event"] == "preflight_warning" and e["stage"] == "track.landmarks"
               for e in evs)
    unavailable = [e["method"] for e in evs if e["event"] == "preflight_fallback_unavailable"]
    assert unavailable == ["face_alignment", "mediapipe"]
    fb = [e for e in evs if e["event"] == "preflight_fallback"]
    assert fb and fb[-1]["method"] == "file"


def test_good_landmarks_pass_through_silently(pipe, tmp_path):
    good, valid = good_landmarks(np.random.default_rng(0))
    out, _ = pipe._landmarks_with_fallback(good, valid, tmp_path / "none", W, H)
    np.testing.assert_array_equal(out, good)
    assert not any(e["event"].startswith("preflight") for e in events(pipe))
    # flagged landmarks with nothing to fall back to are kept, loudly
    bad = np.full((T, L, 2), W / 2, np.float32)
    out, _ = pipe._landmarks_with_fallback(bad, np.ones(T, bool), tmp_path / "none", W, H)
    np.testing.assert_array_equal(out, bad)
    assert events(pipe)[-1]["event"] == "preflight_no_fallback"


def test_corrupted_masks_fall_back_to_median(pipe):
    rng = np.random.default_rng(0)
    frames = np.tile(rng.uniform(0, 0.3, (1, H, W, 3)), (T, 1, 1, 1))
    yy, xx = np.mgrid[:H, :W]
    # the blob travels farther than its own diameter, so the per-pixel
    # temporal median sees background at every pixel
    for t in range(T):
        blob = (yy - H / 2) ** 2 + (xx - W / 4 - 4.0 * t) ** 2 < (H / 6) ** 2
        frames[t][blob] = (0.9, 0.7, 0.6)
    frames = (frames * 255).astype(np.uint8)
    out = pipe._masks_with_fallback(np.ones((T, H, W), np.float32), frames)
    assert out is not None and 0.05 < (out > 0.5).mean() < 0.5
    fb = [e for e in events(pipe) if e["event"] == "preflight_fallback"]
    assert fb and fb[-1]["method"] == "median_background"


def test_unrecoverable_masks_become_none(pipe):
    frames = np.random.default_rng(2).uniform(0, 255, (T, H, W, 3)).astype(np.uint8)
    assert pipe._masks_with_fallback(np.ones((T, H, W), np.float32), frames) is None
    assert any(e["event"] == "preflight_no_fallback" for e in events(pipe))


# ── the landmark registry's new sources ──────────────────────


def test_auto_prefers_the_landmark_file(tmp_path):
    d = tmp_path / "images"
    d.mkdir()
    tvideo.write_image(d / "00000.png", np.zeros((8, 8, 3), np.uint8))
    gt = np.full((1, 68, 2), 3.0, np.float32)
    tl.save_landmarks(d / "landmarks.npz", gt)
    lmk, valid = tl.detect_landmarks(d, method="auto")          # no model needed
    np.testing.assert_allclose(lmk, gt)
    assert valid.all()


def test_neural_detects_with_given_weights_and_auto_falls_through(small_asset, tmp_path):
    from tests.test_torch_detector import models

    _, tm = models()
    net = tdet.init_net(torch.Generator().manual_seed(0), 68, 32)
    tdet.save_detector(tmp_path / "net.npz", net)
    frames = np.random.default_rng(0).integers(0, 256, (3, 48, 40, 3)).astype(np.uint8)
    want, _ = tdet.detect(net, frames, image_size=32)
    for method in ("neural", "auto"):
        got, valid = tl.detect_landmarks(frames, method=method, model=tm,
                                         weights=tmp_path / "net.npz", image_size=32,
                                         device="cpu")
        assert got.shape == (3, 68, 2) and got.dtype == np.float32 and valid.all()
        np.testing.assert_allclose(got, want, atol=1e-4)
    assert 0 < got[..., 0].mean() < 40 and 0 < got[..., 1].mean() < 48      # pixels of (W, H)


# ── frames from a capture ────────────────────────────────────


def write_capture(directory, n=5, h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    directory.mkdir(parents=True)
    for i in range(n):
        tvideo.write_image(directory / f"frame_{i:03d}.png", frames[i])
    return frames


def test_extract_frames_from_a_directory(tmp_path):
    frames = write_capture(tmp_path / "capture")
    assert tvideo.probe_video(tmp_path / "capture") == {"width": 56, "height": 40, "fps": 30.0,
                                                        "frame_count": 5}
    paths = tvideo.extract_frames(tmp_path / "capture", tmp_path / "all")
    assert [p.name for p in paths] == [f"{i:05d}.png" for i in range(5)]
    for p, f in zip(paths, frames):
        assert np.array_equal(tvideo.read_image(p), f)
    # stride, max_frames, and an area-averaged shrink so that min(H, W) ~ target
    paths = tvideo.extract_frames(tmp_path / "capture", tmp_path / "cut", target_size=20,
                                  max_frames=2, stride=2)
    assert [p.name for p in paths] == ["00000.png", "00001.png"]
    for p, f in zip(paths, frames[::2]):
        got = tvideo.read_image(p)
        assert got.shape == (20, 28, 3)
        want = cv2.resize(f, (28, 20), interpolation=cv2.INTER_AREA)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # a target above the size leaves the frames as they are
    up = tvideo.extract_frames(tmp_path / "capture", tmp_path / "up", target_size=100)
    assert np.array_equal(tvideo.read_image(up[0]), frames[0])


def test_a_video_file_needs_ffmpeg_and_jpeg_is_refused(small_case, tmp_path, monkeypatch):
    """With no ffmpeg, a file that is no AVI or MP4 needs ffmpeg and says so;
    a Motion JPEG file does not: the capture stitched to an AVI is probed and
    extracted, each frame the decode of its JPEG in the file as cv2 reads a
    video frame (`mjpeg.frame_rgb`).  A capture of
    JPEG frames is probed, preprocessed (frames equal to cv2's decode) and
    tracked."""
    import shutil

    from omfs4d_torch.io import mjpeg

    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    (tmp_path / "clip.mp4").write_bytes(b"not a video")
    for fn in (tvideo.probe_video, lambda p: tvideo.extract_frames(p, tmp_path / "out")):
        with pytest.raises(RuntimeError, match="ffmpeg"):
            fn(tmp_path / "clip.mp4")
        with pytest.raises(FileNotFoundError):
            fn(tmp_path / "missing.mp4")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tvideo.extract_frames(tmp_path / "empty", tmp_path / "out")

    pngs = tmp_path / "frames" / "images"
    avi = tvideo.stitch_video(pngs, tmp_path / "clip.avi", fps=25)
    assert tvideo.probe_video(avi) == {"width": 32, "height": 32, "fps": 25.0,
                                       "frame_count": 4}
    extracted = tvideo.extract_frames(avi, tmp_path / "from_avi")
    jpegs = mjpeg.frames(avi)
    assert len(extracted) == len(jpegs) == 4
    for p, data in zip(extracted, jpegs):
        np.testing.assert_array_equal(tvideo.read_image(p), mjpeg.frame_rgb(data))

    jpegs = tmp_path / "jpegs"
    jpegs.mkdir()
    for p in sorted(pngs.glob("*.png")):
        cv2.imwrite(str(jpegs / f"{p.stem}.jpg"),
                    cv2.cvtColor(tvideo.read_image(p), cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert tvideo.probe_video(jpegs) == {"width": 32, "height": 32, "fps": 30.0,
                                         "frame_count": 4}
    pipe = small_pipeline(tmp_path / "work")
    frames_dir = pipe.preprocess(jpegs)
    extracted = sorted((frames_dir / "images").glob("*.png"))
    assert len(extracted) == 4
    for p, src in zip(extracted, sorted(jpegs.glob("*.jpg"))):
        want = cv2.cvtColor(cv2.imread(str(src)), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(tvideo.read_image(p), want)
    shutil.copy(pngs / "landmarks.npz", frames_dir / "images")
    out = pipe.track(frames_dir, FrameDataset(small_case["path"]).camera(0),
                     landmark_method="file")
    ds = FrameDataset(out)
    assert np.array_equal(ds.load_image(0), tvideo.read_image(extracted[0]))
    assert ds.flame_params["expr"].shape[0] == 4
    assert all(np.isfinite(v).all() for v in ds.flame_params.values())


# stands in for an ffmpeg binary: with an output pattern it "decodes" the
# frames of FAKE_FFMPEG_FRAMES into it, numbered from 1 as ffmpeg numbers
# them; with no output file it prints a stream description and fails
FAKE_FFMPEG = """#!{python}
import os, shutil, sys
from pathlib import Path
args = sys.argv[1:]
if args[-1].endswith("%05d.png"):
    for i, f in enumerate(sorted(Path(os.environ["FAKE_FFMPEG_FRAMES"]).glob("*.png"))):
        shutil.copy(f, args[-1] % (i + 1))
    sys.exit(0)
sys.stderr.write('''Input #0, mov,mp4,m4a,3gp,3g2,mj2, from 'clip.mp4':
  Metadata:
    major_brand     : isom
    encoder         : Lavf58.76.100
  Duration: 00:00:00.20, start: 0.000000, bitrate: 1205 kb/s
  Stream #0:0(und): Video: h264 (High) (avc1 / 0x31637661), yuv420p, 56x40 [SAR 1:1 DAR 7:5], \\
1200 kb/s, 25 fps, 25 tbr, 12800 tbn, 50 tbc (default)
At least one output file must be specified
''')
sys.exit(1)
"""


def test_a_video_file_goes_through_an_ffmpeg_binary(tmp_path, monkeypatch):
    """The ffmpeg branch, against a stand-in binary: the stream description is
    read for size, rate and duration, and the decoded PNGs are numbered and
    strided like a directory's."""
    import sys

    frames = write_capture(tmp_path / "decoded")
    exe = tmp_path / "bin" / "ffmpeg"
    exe.parent.mkdir()
    exe.write_text(FAKE_FFMPEG.format(python=sys.executable))
    exe.chmod(0o755)
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: str(exe))
    monkeypatch.setenv("FAKE_FFMPEG_FRAMES", str(tmp_path / "decoded"))
    (tmp_path / "clip.mp4").write_bytes(b"not a video")
    assert tvideo.probe_video(tmp_path / "clip.mp4") == {"width": 56, "height": 40, "fps": 25.0,
                                                         "frame_count": 5}
    paths = tvideo.extract_frames(tmp_path / "clip.mp4", tmp_path / "out", stride=2)
    assert [p.name for p in paths] == ["00000.png", "00001.png", "00002.png"]
    for p, f in zip(paths, frames[::2]):
        assert np.array_equal(tvideo.read_image(p), f)
    # a failing decoder is reported with its own words
    monkeypatch.delenv("FAKE_FFMPEG_FRAMES")
    with pytest.raises(RuntimeError, match="ffmpeg failed"):
        tvideo.extract_frames(tmp_path / "clip.mp4", tmp_path / "out2")


# ── the artifact store ───────────────────────────────────────


def test_artifact_store_matches_the_reference(tmp_path):
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "a.bin").write_bytes(b"abc" * 1000)
    obj = {"b": [1, 2.5, "x"], "a": {"nested": (1, 2)}}
    assert tart.sha256_obj(obj) == jart.sha256_obj(obj)
    assert tart.sha256_file(tmp_path / "in" / "a.bin") == jart.sha256_file(tmp_path / "in" / "a.bin")
    tstore, jstore = tart.ArtifactStore(tmp_path / "t"), jart.ArtifactStore(tmp_path / "j")
    for inputs in ({"file": tmp_path / "in" / "a.bin"}, {"dir": tmp_path / "in"},
                   {"value": "plain"}):
        assert tstore.stage_key("track", inputs, {"k": 1}) == \
            jstore.stage_key("track", inputs, {"k": 1})
    assert tstore.stage_key("track", {"v": 1}, {"k": 1}) != tstore.stage_key("track", {"v": 1},
                                                                             {"k": 2})
    calls = []

    def fn(out):
        calls.append(out)
        (out / "result.txt").write_text("done")
        return {"n": len(calls)}

    out = tstore.run("stage", {"v": 1}, {"k": 1}, fn)
    assert tstore.run("stage", {"v": 1}, {"k": 1}, fn) == out and len(calls) == 1
    assert json.loads((out / ".stage_complete.json").read_text())["result"] == {"n": 1}
    tstore.run("stage", {"v": 1}, {"k": 1}, fn, force=True)
    assert len(calls) == 2
    other = tstore.run("stage", {"v": 2}, {"k": 1}, fn)
    assert other != out and tstore.latest("stage") == other and tstore.latest("none") is None


def test_manifest_and_fingerprint_match_the_reference(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    (data / "transforms_train.json").write_text("{}")
    (data / "flame_param.npz").write_bytes(b"123")
    assert tart.dataset_fingerprint(data) == jart.dataset_fingerprint(data)
    assert sorted(tart.dataset_fingerprint(data)["files"]) == ["flame_param.npz",
                                                               "transforms_train.json"]
    (tmp_path / "model" / "checkpoints").mkdir(parents=True)
    (tmp_path / "model" / "checkpoints" / "iter_0000010.pt").write_bytes(b"x" * 10)
    path = tart.write_experiment_manifest(tmp_path / "model", data, {"a": 1}, extra={"it": 10})
    manifest = json.loads(path.read_text())
    assert manifest["config"] == {"a": 1} and manifest["extra"] == {"it": 10}
    assert manifest["dataset_fingerprint"] == jart.dataset_fingerprint(data)
    assert manifest["checkpoint_lineage"][0]["name"] == "iter_0000010.pt"
    assert manifest["checkpoint_lineage"][0]["size_bytes"] == 10


# ── the pipeline's device and its unported stages ────────────


def test_pipeline_takes_the_card_by_default_and_raises_without_one(small_asset, tmp_path,
                                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunner.Pipeline(Config(), tmp_path / "w")
    runner = trunner.Pipeline(Config(), tmp_path / "w", device="cpu")
    assert runner.device.type == "cpu" and runner.model.v_template.device.type == "cpu"
    assert runner.model.n_vertices == 700


@pytest.fixture
def small_case(small_asset, tmp_path):
    """A 32^2 synthetic dataset of 4 frames on the 700-vertex asset, and a
    capture of its frames with the true landmarks beside them."""
    from tests.test_torch_parallel_pipeline import small_case as make

    return make(tmp_path)


def small_pipeline(workdir, **parallel):
    from tests.test_torch_parallel_pipeline import small_pipeline as make

    return make(workdir, **parallel)


@pytest.mark.parametrize("n_gauss,n_data,match", [
    (2, 1, "n_data x n_gauss = 1x2 but only 1 ranks"),
    (1, 2, "parallel.n_data=2 but only 1 ranks"),
    (2, 2, "n_data x n_gauss = 2x2 but only 1 ranks")], ids=["n_gauss", "n_data", "both"])
def test_sharded_training_needs_the_ranks(small_case, tmp_path, n_gauss, n_data, match):
    """With fewer ranks than the mesh (here a world of one process) the
    sharded training branches raise RuntimeError naming the counts, as the
    reference does with too few devices; their runs on a world of 2 are in
    test_torch_parallel_pipeline."""
    pipe = small_pipeline(tmp_path / "work", n_gauss=n_gauss, n_data=n_data)
    with pytest.raises(RuntimeError, match=match):
        pipe.train(small_case["path"], tmp_path / "model", iterations=2)


def test_render_surgery_with_too_few_ranks_renders_unsharded(small_case, tmp_path,
                                                            monkeypatch):
    """parallel.n_tile = 2 with one rank: a warning, and the frames of the
    one-rank render."""
    from omfs4d_torch.predict import render_video
    from omfs4d_torch.train.checkpoints import export_point_cloud

    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    model_dir = tmp_path / "model"
    export_point_cloud(model_dir / "point_cloud" / "iteration_1" / "point_cloud.ply",
                       small_case["gt_gaussians"])
    warned = []
    monkeypatch.setattr(render_video.log, "warning", lambda msg, *a: warned.append(msg))
    frames = {}
    for n_tile in (2, 1):
        pipe = small_pipeline(tmp_path / f"work_{n_tile}", n_tile=n_tile)
        res = pipe.render_surgery(model_dir, small_case["path"], tmp_path / "out.mp4", 5.0, 3.0)
        frames[n_tile] = [tvideo.read_image(p) for p in sorted(
            tvideo.Path(res["renders_dir"]).glob("*.png"))]
    assert any("n_tile=2 but only 1 ranks; rendering unsharded" in w for w in warned)
    assert len(frames[2]) == 4
    for a, b in zip(frames[2], frames[1]):
        np.testing.assert_array_equal(a, b)


def test_track_with_too_few_ranks_fits_unsharded(small_case, tmp_path, monkeypatch):
    """parallel.n_data = 2 with one rank: the tracker is built without a
    mesh, and the dataset equals a track with n_data = 1."""
    built = []
    real = trunner.FlameTracker

    def recording(*a, **kw):
        built.append(kw.get("mesh"))
        return real(*a, **kw)

    monkeypatch.setattr(trunner, "FlameTracker", recording)
    cam = FrameDataset(small_case["path"]).camera(0)
    params = {}
    for n_data in (2, 1):
        out = small_pipeline(tmp_path / f"work_{n_data}", n_data=n_data).track(
            tmp_path / "frames", cam, landmark_method="file")
        params[n_data] = FrameDataset(out).flame_params
    assert built == [None, None]
    for k in ("expr", "rotation", "jaw_pose", "translation", "shape"):
        np.testing.assert_array_equal(params[2][k], params[1][k])


# ── frames -> dataset with no landmark file ──────────────────


def test_preprocess_and_track_with_the_neural_detector(small_asset, tmp_path, monkeypatch):
    from omfs4d_torch.io.synthetic import animated_flame_params, textured_gt_avatar
    from omfs4d_torch.models.flame import flame_forward
    from omfs4d_torch.render.rasterize import render_avatar_frame

    S, n = 64, 4
    cfg = Config()
    cfg.pipeline.target_size = S
    cfg.track = type(cfg.track)(
        n_shape=10, n_expr=10, texture_res=16, detector_steps=24, detector_size=32,
        steps_lmk_init_rigid=10, steps_lmk_init_all=10, steps_rgb_init_texture=2,
        steps_rgb_init_all=2, steps_rgb_init_offset=1, steps_rgb_sequential=1, steps_global=2,
        epochs_global=1)
    cfg.render.max_per_tile = 128
    runner = trunner.Pipeline(cfg, tmp_path / "work", device="cpu")
    model = runner.model
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=S * 1.8, width=S, height=S)

    # a capture: frames of the textured head at twice the target size, no landmarks.npz
    big = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=2 * S * 1.8, width=2 * S,
                         height=2 * S)
    gt = animated_flame_params(n, model.n_vertices, jaw_amp=0.1)
    avatar = textured_gt_avatar(model, seed=0)
    capture = tmp_path / "capture"
    capture.mkdir()
    with torch.no_grad():
        verts = flame_forward(model, gt)
        for i in range(n):
            img, _ = render_avatar_frame(avatar, verts[i], model.faces, big, 2 * S, 2 * S,
                                         max_per_tile=128)
            tvideo.write_image(capture / f"{i:05d}.png", img.numpy())

    frames_dir = runner.preprocess(capture)
    paths = sorted((frames_dir / "images").glob("*.png"))
    assert len(paths) == n and tvideo.read_image(paths[0]).shape == (S, S, 3)
    assert runner.preprocess(capture) == frames_dir              # cached
    assert not list(frames_dir.rglob("landmarks.npz"))

    trained = []
    real = tdet.train_detector

    def small_batches(*a, **kw):
        trained.append(kw["steps"])
        return real(*a, batch_size=4, log_every=0, **kw)

    monkeypatch.setattr(tdet, "train_detector", small_batches)
    out = runner.track(frames_dir, cam, landmark_method="neural")
    assert trained == [24]
    assert (tmp_path / "cache" / "landmark_net_sa2_torch_v700_l68_s32_t24.npz").exists()

    ds = FrameDataset(out, split="train")
    assert len(ds) == n - n // 10 and ds.flame_params["expr"].shape == (n, 100)
    assert np.array_equal(ds.load_image(0), tvideo.read_image(paths[0]))
    mask = ds.load_mask(0)
    assert mask is not None and mask.shape == (S, S) and 0.05 < (mask > 0.5).mean() < 0.95
    assert ds.points3d().shape == (model.n_vertices, 3)
    assert np.isfinite(ds.intrinsics["fl_x"]) and ds.intrinsics["w"] == S

    evs = events(runner)
    stages = [e["stage"] for e in evs if e["event"] == "stage_end"]
    assert stages == ["preprocess", "track.stage_frames", "track.landmarks", "track.matting",
                      "track"]
    assert sum(e["event"] == "track_stage" for e in evs) == 7
    done = json.loads((out / ".stage_complete.json").read_text())
    assert done["result"]["n_frames"] == n and np.isfinite(done["result"]["losses"]["landmark"])

    # the second call is answered by the stage cache: nothing runs
    monkeypatch.setattr(trunner, "detect_landmarks", None)
    assert runner.track(frames_dir, cam, landmark_method="neural") == out
    assert len(events(runner)) == len(evs)
    # another landmark source is another stage key
    assert runner.store.stage_key("track", {"frames": str(frames_dir)}, {
        "track": cfg.track.__dict__, "lmk": "file", "matting": "border_color"}) not in out.name
