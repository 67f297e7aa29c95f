"""The port's CLI (`python -m omfs4d_torch.pipeline.cli`) on the CPU, as
`tests/test_cli.py` drives the reference's: dotted overrides, `synthetic-data`,
`prepare-models` (the nets' trainers cut small), `clinical` (not ported: it
raises), and `run` from a 64^2 directory of PNG frames with a landmark file to
a prediction and its strict report with no ffmpeg (the PNG frames are the
product, `video` is None).  Then `render-surgery` and `preprocess` through a
stand-in ffmpeg binary: its encode command line is the reference's, a failing
binary raises, and a video file is decoded through it.  `render-surgery`'s
`--rig-mode` reaches the render (the reference's CLI passes it twice and
raises).
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omfs4d.core.config import config_from_args as j_config_from_args
from omfs4d_torch.core.config import Config, config_from_args
from omfs4d_torch.io import video as tvideo
from omfs4d_torch.io.synthetic import animated_flame_params, textured_gt_avatar
from omfs4d_torch.models import assets as tassets
from omfs4d_torch.models.flame import FlameModel, flame_forward
from omfs4d_torch.ops.camera import look_at_camera
from omfs4d_torch.pipeline import cli
from omfs4d_torch.pipeline import runner as trunner
from omfs4d_torch.render.rasterize import render_avatar_frame
from omfs4d_torch.track import detector as tdet
from omfs4d_torch.track import segnet as tseg
from omfs4d_torch.track.landmarks import detect_landmarks, save_landmarks
from tests.test_torch_track import one_torch_thread  # noqa: F401  (autouse here too)

S, N = 64, 12
SMALL = [
    "track.n_shape=10", "track.n_expr=10", "track.texture_res=16",
    "track.steps_lmk_init_rigid=20", "track.steps_lmk_init_all=20",
    "track.steps_rgb_init_texture=2", "track.steps_rgb_init_all=2",
    "track.steps_rgb_init_offset=1", "track.steps_rgb_sequential=1",
    "track.steps_global=2", "track.epochs_global=1",
    "pipeline.min_train_frames=2", "train.max_gaussians=2048",
    "train.densify_interval=0", "train.opacity_reset_interval=0",
    "render.max_per_tile=128",
]

# stands in for an ffmpeg binary: a decode (output pattern %05d.png) copies the
# frames of FAKE_FFMPEG_FRAMES; an H.264 encode records its command line in
# FAKE_FFMPEG_LOG and writes the output file (or fails when FAKE_FFMPEG_FAIL is
# set); with no output file it prints a stream description and fails
FAKE_FFMPEG = """#!{python}
import json, os, shutil, sys
from pathlib import Path
args = sys.argv[1:]
if args[-1].endswith("%05d.png"):
    for i, f in enumerate(sorted(Path(os.environ["FAKE_FFMPEG_FRAMES"]).glob("*.png"))):
        shutil.copy(f, args[-1] % (i + 1))
    sys.exit(0)
if "-c:v" in args:
    if os.environ.get("FAKE_FFMPEG_FAIL"):
        sys.stderr.write("Unknown encoder 'libx264'")
        sys.exit(1)
    Path(os.environ["FAKE_FFMPEG_LOG"]).write_text(json.dumps(sys.argv))
    Path(args[-1]).write_bytes(b"mp4")
    sys.exit(0)
sys.stderr.write("Input #0, mov,mp4,m4a,3gp,3g2,mj2, from 'clip.mp4':\\n"
                 "  Duration: 00:00:00.48, start: 0.000000, bitrate: 1205 kb/s\\n"
                 "  Stream #0:0(und): Video: h264 (High), yuv420p, 64x64, 25 fps, 25 tbr\\n"
                 "At least one output file must be specified\\n")
sys.exit(1)
"""


def small_asset():
    return tassets.synthetic_flame_asset(n_vertices=700, seed=0)


@pytest.fixture
def no_ffmpeg_small_asset(monkeypatch, tmp_path):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setattr(trunner, "synthetic_flame_asset", small_asset)
    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))


def test_config_overrides_match_the_reference():
    argv = ["train", "--data", "x", "train.iterations=777", "render.use_pallas=never",
            "clinical.hu_threshold=700", "--device", "cpu", "track.texture_res=16"]
    cfg, rest = config_from_args(argv)
    jcfg, jrest = j_config_from_args(argv)
    assert cfg.train.iterations == 777 and cfg.clinical.hu_threshold == 700.0
    assert cfg.to_dict() == jcfg.to_dict()
    assert rest == jrest == ["train", "--data", "x", "--device", "cpu"]


def test_unknown_override_raises():
    for key in ("train.nonexistent=1", "nogroup.iterations=1"):
        with pytest.raises(KeyError):
            config_from_args([key])
        with pytest.raises(KeyError):
            cli.main(["train", "--data", "x", key])


def test_cli_synthetic_data(tmp_path, monkeypatch):
    out = tmp_path / "data"
    assert cli.main(["synthetic-data", "--out", str(out), "--frames", "6", "--size", "48",
                     "--device", "cpu"]) == 0
    assert len(list((out / "images").glob("*.png"))) == 6
    assert (out / "flame_param.npz").exists() and (out / "transforms_train.json").exists()
    # with no --device the card is wanted, and there is none here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["synthetic-data", "--out", str(tmp_path / "d2"), "--frames", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", "--data", str(out), "--workdir", str(tmp_path / "w")])


def test_cli_prepare_models(tmp_path, monkeypatch, no_ffmpeg_small_asset):
    """Both nets trained and cached under OMFS4D_CACHE, with the config's
    step counts and sizes, on the device asked for."""
    trained = []

    def small(train, batch):
        def run(*a, **kw):
            trained.append((train.__name__, kw["steps"], str(kw["device"])))
            return train(*a, batch_size=batch, log_every=0, **kw)
        return run

    monkeypatch.setattr(tdet, "train_detector", small(tdet.train_detector, 4))
    monkeypatch.setattr(tseg, "train_segnet", small(tseg.train_segnet, 2))
    assert cli.main(["prepare-models", "--workdir", str(tmp_path / "wd"), "--device", "cpu",
                     "track.detector_steps=3", "track.detector_size=32",
                     "pipeline.matting_train_steps=2"]) == 0
    assert trained == [("train_detector", 3, "cpu"), ("train_segnet", 2, "cpu")]
    names = sorted(p.name for p in (tmp_path / "cache").iterdir())
    assert names == ["landmark_net_sa2_torch_v700_l68_s32_t3.npz",
                     "segnet_n3_torch_v700_s96_t2.npz"]
    # a second call loads both from the cache; --skip-* leaves a net alone
    assert cli.main(["prepare-models", "--workdir", str(tmp_path / "wd"), "--device", "cpu",
                     "--skip-matting", "track.detector_steps=3",
                     "track.detector_size=32"]) == 0
    assert len(trained) == 2


def test_cli_clinical_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="items 6 and 8"):
        cli.main(["clinical", "--dicom", str(tmp_path), "--out", str(tmp_path / "m.stl")])


def capture_dir(root: Path) -> Path:
    """N frames of the textured head seen by the CLI's static look-at camera,
    as PNGs, with the `synthetic` source's landmarks.npz beside them."""
    model = FlameModel.from_asset(small_asset())
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * S, width=S, height=S)
    gt = animated_flame_params(N, model.n_vertices, jaw_amp=0.1)
    avatar = textured_gt_avatar(model, seed=0)
    root.mkdir(parents=True)
    with torch.no_grad():
        verts = flame_forward(model, gt)
        for i in range(N):
            img, _ = render_avatar_frame(avatar, verts[i], model.faces, cam, S, S,
                                         max_per_tile=128)
            tvideo.write_image(root / f"{i:05d}.png", img.numpy())
    lmk, valid = detect_landmarks(None, method="synthetic", model=model, params=gt, cameras=cam)
    save_landmarks(root / "landmarks.npz", lmk, valid)
    return root


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """`preprocess`, the capture's landmark file put beside the frames, then
    `run` on the same capture (its preprocess answered by the stage cache),
    all with no ffmpeg binary."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("cli")
    mp.setattr(tvideo, "find_ffmpeg", lambda: None)
    mp.setattr(trunner, "synthetic_flame_asset", small_asset)
    mp.setenv("OMFS4D_CACHE", str(root / "cache"))
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        capture = capture_dir(root / "capture")
        wd = root / "wd"
        common = ["--workdir", str(wd), "--device", "cpu", *SMALL]
        assert cli.main(["preprocess", "--video", str(capture), *common]) == 0
        stage = next((wd / "stages").glob("preprocess-*"))
        shutil.copy(capture / "landmarks.npz", stage / "landmarks.npz")
        rc = cli.main(["run", "--video", str(capture), "--lefort-mm", "5", "--bsso-mm", "3",
                       "--iterations", "30", "--output", str(root / "pred.mp4"), *common])
    finally:
        torch.set_num_threads(before)
        mp.undo()
    return {"root": root, "wd": wd, "rc": rc, "capture": capture}


def events(wd):
    return [json.loads(line) for line in (wd / "events.jsonl").read_text().splitlines()]


def test_cli_run_on_a_frame_directory_with_no_ffmpeg(ran):
    assert ran["rc"] == 0
    wd = ran["wd"]
    evs = events(wd)
    ends = [e["stage"] for e in evs if e["event"] == "stage_end"]
    assert ends[0] == "preprocess" and ends.count("preprocess") == 1
    assert [s for s in ends if "." not in s] == ["preprocess", "track", "train",
                                                 "render_surgery", "report"]
    # the landmark file was taken: no preflight fallback, no net trained
    assert not any(e["event"].startswith("preflight") for e in evs)
    assert not list((ran["root"] / "cache").glob("landmark_net*"))
    model = wd / "model"
    assert (model / "point_cloud" / "iteration_30").exists()
    assert (model / "flame_param_refined.npz").exists()
    assert list((model / "experiment_manifests").glob("*.json"))
    det = wd / "deterministic_frames"
    manifest = json.loads((det / "deterministic_indices_manifest.json").read_text())
    scores = json.loads((model / "eval_strict" / "reports" / "strict_scores.json").read_text())
    assert len(scores["rows"]) == len(manifest["exports"]) == N - N // 10
    assert all(np.isfinite(r["psnr"]) for r in scores["rows"])
    # no ffmpeg: the product is the PNG frames
    assert not (ran["root"] / "pred.mp4").exists()
    assert len(list((model / "train" / "ours_30" / "renders").glob("*.png"))) == N - N // 10


def test_cli_report_needs_no_device(ran, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, det = ran["wd"] / "model", ran["wd"] / "deterministic_frames"
    renders = model / "train" / "ours_30" / "renders"
    assert cli.main(["report", "--model", str(model), "--frames", str(det),
                     "--out", str(tmp_path / "rep"), "--baseline-renders", str(renders)]) == 0
    rows = json.loads((tmp_path / "rep" / "strict_scores.json").read_text())["rows"]
    # the baseline is the prediction itself: nothing moved, every pixel kept
    assert rows and all(r["psnr_unchanged"] == r["psnr"] for r in rows)


def fake_ffmpeg(tmp_path, monkeypatch):
    exe = tmp_path / "bin" / "ffmpeg"
    exe.parent.mkdir()
    exe.write_text(FAKE_FFMPEG.format(python=sys.executable))
    exe.chmod(0o755)
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: str(exe))
    monkeypatch.setenv("FAKE_FFMPEG_LOG", str(tmp_path / "argv.json"))
    monkeypatch.setattr(trunner, "synthetic_flame_asset", small_asset)
    return str(exe)


def test_cli_render_surgery_through_an_ffmpeg_binary(ran, tmp_path, monkeypatch):
    exe = fake_ffmpeg(tmp_path, monkeypatch)
    wd, data = ran["wd"], next((ran["wd"] / "stages").glob("track-*"))
    out = tmp_path / "pred.mp4"
    argv = ["render-surgery", "--model", str(wd / "model"), "--data", str(data),
            "--lefort-mm", "5", "--bsso-mm", "3", "--output", str(out),
            "--workdir", str(tmp_path / "wd"), "--device", "cpu", "predict.fps=25",
            "render.max_per_tile=128"]
    assert cli.main(argv) == 0
    assert out.read_bytes() == b"mp4"
    cmd = json.loads((tmp_path / "argv.json").read_text())
    assert cmd[0] == exe and cmd[-1] == str(out)
    assert cmd == tvideo.ffmpeg_stitch_cmd(exe, cmd[cmd.index("-i") + 1], str(out), 25)
    assert cmd[cmd.index("-i") + 1].endswith("frame_%05d.png")
    # an ffmpeg that is there and fails is an error, not a missing video
    monkeypatch.setenv("FAKE_FFMPEG_FAIL", "1")
    with pytest.raises(RuntimeError, match="ffmpeg failed"):
        cli.main(argv)


def test_cli_preprocess_decodes_a_video_file_through_ffmpeg(ran, tmp_path, monkeypatch):
    fake_ffmpeg(tmp_path, monkeypatch)
    monkeypatch.setenv("FAKE_FFMPEG_FRAMES", str(ran["capture"]))
    (tmp_path / "clip.mp4").write_bytes(b"not a video")
    assert cli.main(["preprocess", "--video", str(tmp_path / "clip.mp4"),
                     "--workdir", str(tmp_path / "wd"), "--device", "cpu"]) == 0
    stage = next((tmp_path / "wd" / "stages").glob("preprocess-*"))
    done = json.loads((stage / ".stage_complete.json").read_text())["result"]
    assert done["n_frames"] == N and done["width"] == S and done["fps"] == 25.0
    frames = sorted((stage / "images").glob("*.png"))
    assert len(frames) == N
    np.testing.assert_array_equal(tvideo.read_image(frames[3]),
                                  tvideo.read_image(ran["capture"] / "00003.png"))


def test_render_surgery_takes_the_rig_mode_it_is_given(ran, tmp_path, monkeypatch):
    """The CLI hands `--rig-mode` to `Pipeline.render_surgery`, which lets it
    stand in for the config's: a canonical head asset is then taken.  The
    reference passes `rig_mode` twice there and raises TypeError."""
    from omfs4d.core.config import Config as JConfig
    from omfs4d.pipeline import runner as jrunner
    from omfs4d_torch.headrecon import build_canonical_head

    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setattr(trunner, "synthetic_flame_asset", small_asset)
    table = tmp_path / "registration_table.json"
    table.write_text(json.dumps({"registrations": []}))
    asset = build_canonical_head(table, tmp_path / "canonical.npz")
    model = tmp_path / "model"
    shutil.copytree(ran["wd"] / "model", model)
    data = next((ran["wd"] / "stages").glob("track-*"))
    pipe = trunner.Pipeline(Config(), tmp_path / "wd", device="cpu")
    pipe.cfg.render.max_per_tile = 128
    result = pipe.render_surgery(model, data, tmp_path / "p.mp4", 0.0, 0.0,
                                 rig_mode="hybrid_full_head", canonical_head_asset=str(asset))
    assert result["rig_mode"] == "hybrid_full_head"
    assert pipe.render_surgery(model, data, tmp_path / "p.mp4", 0.0, 0.0)[
        "rig_mode"] == "flame_only"
    monkeypatch.setattr(jrunner, "_enable_persistent_compile_cache", lambda: None)
    jpipe = jrunner.Pipeline(JConfig(), tmp_path / "jwd")
    with pytest.raises(TypeError, match="rig_mode"):
        jpipe.render_surgery(model, data, tmp_path / "j.mp4", 0.0, 0.0,
                             rig_mode="hybrid_full_head")
