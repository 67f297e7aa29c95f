"""The pipeline's back half in the port, on the CPU: `Pipeline.train` ->
`render_surgery` -> `report`, against the JAX package's where both can run.

(a) The train stage's inputs.  `AvatarTrainer.train` is replaced in both
    packages by a recorder, and both runners build the `data` dict, the
    trainer and its initial state from one dataset: arrays within atol 1e-5
    (the initial cloud's log-scales also rtol 1e-4), the same iterations, start iteration, trainer config and render settings.
    The hires densify cadence (300 -> 100 when left at its default) fires at
    512^2 and not at 64^2.
(b) The port's own back half at 64^2 on the 700-vertex asset (56 frames, 80
    iterations, densify off, K = 128), as the reference's
    `tests/test_pipeline.py::test_full_pipeline_e2e` and
    `::test_surgery_actually_changes_pixels` run it, with no ffmpeg: the PNG
    frames are the product; then a run killed at 40 iterations and resumed
    with `resume=True` ends where the uninterrupted run ends.
(c) Cross-package: the JAX `render_prediction` (`use_pallas="never"`) and the
    port's render the port-trained model (with its `flame_param_refined.npz`)
    under Le Fort 5 mm / BSSO 3 mm within 1 grey level on every pixel,
    and the two packages' strict reports on those frames agree within 0.05 dB.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from omfs4d.core.config import Config as JConfig
from omfs4d.eval.reporting import generate_report as j_generate_report
from omfs4d.pipeline import runner as jrunner
from omfs4d.predict.render_video import render_prediction as j_render_prediction
from omfs4d.train import trainer as jtrainer
from omfs4d_torch.core.config import Config
from omfs4d_torch.io import video as tvideo
from omfs4d_torch.io.dataset import write_dataset
from omfs4d_torch.io.synthetic import animated_flame_params, make_synthetic_dataset
from omfs4d_torch.io.video import read_image
from omfs4d_torch.pipeline import runner as trunner
from omfs4d_torch.train import trainer as ttrainer
from omfs4d_torch.train.checkpoints import load_point_cloud
from tests.test_torch_track import models, one_torch_thread  # noqa: F401  (autouse here too)

S, N_FRAMES, ITERS = 64, 56, 80


def back_half_config(cls):
    cfg = cls()
    cfg.train.iterations = ITERS
    cfg.train.densify_interval = 0
    cfg.train.opacity_reset_interval = 0
    cfg.train.max_gaussians = 2048
    cfg.render.max_per_tile = 128
    cfg.render.use_pallas = "never"
    return cfg


@pytest.fixture(autouse=True)
def no_ffmpeg_and_own_cache(monkeypatch, tmp_path):
    """No ffmpeg binary (as on the card's machine) and every cache under the
    test's directory; the JAX runner leaves XLA's compile cache alone."""
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(jrunner, "_enable_persistent_compile_cache", lambda: None)


# ── (a) the train stage's inputs ─────────────────────────────


def fabricated_dataset(root, size, n=3):
    """A contract dataset at `size`^2 with seeded frames and masks (no
    render: the train stage only reads it)."""
    rng = np.random.default_rng(size)
    _, tm = models()
    params = animated_flame_params(n, tm.n_vertices, seed=1)
    c2w = np.tile(np.eye(4), (n, 1, 1))
    c2w[:, 2, 3] = 0.6
    images = rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8)
    masks = (rng.uniform(size=(n, size, size)) > 0.3).astype(np.float32)
    return write_dataset(root, images, c2w, size * 1.8, size * 1.7, size / 2, size / 2 + 1,
                         flame_params=params, masks=masks, n_verts=tm.n_vertices)


def capture_train_inputs(monkeypatch, module, sink):
    def recorder(self, data, iterations=None, state=None, output_dir=None, events=None,
                 log_every=100, rng_seed=0, start_iteration=0):
        sink.update(trainer=self, data=data, iterations=iterations, state=state,
                    start_iteration=start_iteration, events=events)
        Path(output_dir).mkdir(parents=True, exist_ok=True)    # as a checkpoint would
        return state

    monkeypatch.setattr(module.AvatarTrainer, "train", recorder)


def host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("size", [S, 512])
def test_train_stage_inputs_match_the_reference(monkeypatch, tmp_path, size):
    jm, tm = models()
    if size == S:
        data_dir = make_synthetic_dataset(tmp_path / "data", n_frames=4, width=S, height=S,
                                          n_vertices=700, seed=0, device="cpu")["path"]
    else:
        data_dir = fabricated_dataset(tmp_path / "data", size)
    seen = {"j": {}, "t": {}}
    capture_train_inputs(monkeypatch, jtrainer, seen["j"])
    capture_train_inputs(monkeypatch, ttrainer, seen["t"])
    for key, cls, pkg, model, kw in (("j", JConfig, jrunner, jm, {}),
                                     ("t", Config, trunner, tm, {"device": "cpu"})):
        cfg = back_half_config(cls)
        cfg.train.densify_interval = 300          # the default: the override may fire
        cfg.pipeline.min_train_frames = 2
        pipe = pkg.Pipeline(cfg, tmp_path / f"work_{key}", **kw)
        pipe.model = model
        out = pipe.train(data_dir, tmp_path / f"model_{key}", iterations=ITERS)
        assert out == tmp_path / f"model_{key}"
        # the refined FLAME params and the manifest follow the (skipped) training
        assert (out / "flame_param_refined.npz").exists()
        manifest = json.loads(next((out / "experiment_manifests").glob("*.json")).read_text())
        assert manifest["extra"]["iterations"] == ITERS
        assert manifest["extra"]["resumed_from_iteration"] == 0
    j, t = seen["j"], seen["t"]
    assert sorted(t["data"]) == sorted(j["data"])
    for k in j["data"]:
        want, got = host(j["data"][k]), host(t["data"][k])
        assert got.shape == want.shape, k
        if want.dtype == np.uint8:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=k)
    assert (t["iterations"], t["start_iteration"]) == (j["iterations"], j["start_iteration"])
    tt, jt = t["trainer"], j["trainer"]
    assert dataclasses.asdict(tt.cfg) == dataclasses.asdict(jt.cfg)
    assert (tt.width, tt.height) == (jt.width, jt.height) == (size, size)
    # the port has no backend switch: the tensor's device picks the composite
    assert tt.render_cfg == {k: v for k, v in jt.render_cfg.items() if k != "use_pallas"}
    np.testing.assert_array_equal(host(tt.bg), host(jt.bg))
    assert tt.co_optimize and jt.co_optimize
    assert tt.cfg.densify_interval == (100 if size >= 384 else 300)
    # the initial state: the same seeded cloud on the mesh (its scales are logs
    # of k-NN distances between the posed vertices' face centres: rtol 1e-4)
    # and the same FLAME params
    gt_, gj = t["state"].gaussians, j["state"].gaussians
    for f in ("mu_local", "quat_local", "log_scale", "opacity_logit", "color", "sh",
              "parent_face", "alive"):
        np.testing.assert_allclose(host(getattr(gt_, f)), host(getattr(gj, f)), rtol=1e-4,
                                   atol=1e-5, err_msg=f)
    assert sorted(t["state"].flame_params) == sorted(j["state"].flame_params)
    for k, v in j["state"].flame_params.items():
        np.testing.assert_allclose(host(t["state"].flame_params[k]), host(v), atol=1e-5,
                                   err_msg=k)
    assert t["events"] is not None


def test_the_densify_override_leaves_a_chosen_interval_alone(monkeypatch, tmp_path):
    seen = {}
    capture_train_inputs(monkeypatch, ttrainer, seen)
    cfg = back_half_config(Config)
    cfg.train.densify_interval = 250
    cfg.pipeline.min_train_frames = 2
    pipe = trunner.Pipeline(cfg, tmp_path / "w", device="cpu")
    pipe.model = models()[1]
    pipe.train(fabricated_dataset(tmp_path / "data", 512), tmp_path / "model")
    assert seen["trainer"].cfg.densify_interval == 250
    assert seen["iterations"] is None                 # the trainer takes cfg.iterations


# ── (b) the port's back half ─────────────────────────────────


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The 56-frame 64^2 case, trained 80 iterations by the port's runner."""
    root = tmp_path_factory.mktemp("e2e")
    case = make_synthetic_dataset(root / "data", n_frames=N_FRAMES, width=S, height=S,
                                  n_vertices=700, seed=0, device="cpu")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pipe = trunner.Pipeline(back_half_config(Config), root / "work", device="cpu")
        pipe.model = case["model"]
        model_dir = pipe.train(case["path"], root / "model")
    finally:
        torch.set_num_threads(before)
    return {"root": root, "case": case, "pipe": pipe, "model_dir": model_dir}


def stage_ends(pipe):
    return [json.loads(line)["stage"] for line in pipe.events.path.read_text().splitlines()
            if json.loads(line)["event"] == "stage_end"]


def test_full_pipeline_e2e(trained, tmp_path):
    pipe, model_dir, data_dir = trained["pipe"], trained["model_dir"], trained["case"]["path"]
    assert (model_dir / "point_cloud" / f"iteration_{ITERS}").exists()
    assert (model_dir / "flame_param_refined.npz").exists()
    payload = json.loads(next((model_dir / "experiment_manifests").glob("*.json")).read_text())
    assert payload["dataset_fingerprint"]["dataset_hash"]
    assert [r["iteration"] for r in payload["extra"]["checkpoint_lineage"]] == [20, 40, 80]
    events = [json.loads(line) for line in pipe.events.path.read_text().splitlines()]
    steps = [e for e in events if e["event"] == "train_step"]
    assert steps and steps[-1]["iter"] == ITERS and np.isfinite(steps[-1]["loss"])

    det_dir = tmp_path / "det"
    result = pipe.render_surgery(model_dir, data_dir, tmp_path / "pred.mp4",
                                 lefort_mm=5.0, bsso_mm=3.0, export_frames_dir=str(det_dir))
    assert result["iteration"] == ITERS and abs(result["lefort_offset"] - 0.005) < 1e-9
    renders = sorted(Path(result["renders_dir"]).glob("*.png"))
    assert len(renders) == N_FRAMES - N_FRAMES // 10
    # no ffmpeg: the prediction is an H.264 (avc1) MP4 from the port's own
    # encoder, which the JAX package reads through cv2, a frame per render
    from omfs4d.io.video import probe_video as j_probe_video
    from omfs4d_torch.io import container

    assert result["video"] == str(tmp_path / "pred.mp4") and result["video_error"] is None
    assert container.index(result["video"])[2]["codec"] == "h264"
    assert j_probe_video(result["video"]) == {"width": S, "height": S, "fps": 30.0,
                                              "frame_count": len(renders)}
    assert read_image(renders[0]).std() > 0

    report = pipe.report(model_dir, det_dir)
    assert report["summary"]["count"] == 24
    scores = model_dir / "eval_strict" / "reports" / "strict_scores.json"
    assert json.loads(scores.read_text()) == json.loads(json.dumps(report))
    assert all(np.isfinite(r["psnr"]) and r["psnr"] > 10 for r in report["rows"])
    assert stage_ends(pipe)[-3:] == ["train", "render_surgery", "report"]


def test_surgery_actually_changes_pixels(trained):
    root, model_dir, data_dir = trained["root"], trained["model_dir"], trained["case"]["path"]
    cfg = back_half_config(Config)
    pipe = trunner.Pipeline(cfg, root / "work2", device="cpu")
    pipe.model = trained["case"]["model"]
    r0 = pipe.render_surgery(model_dir, data_dir, root / "p0.mp4", lefort_mm=0.0, bsso_mm=0.0)
    f0 = read_image(sorted(Path(r0["renders_dir"]).glob("*.png"))[0]).astype(np.float32)
    r1 = pipe.render_surgery(model_dir, data_dir, root / "p1.mp4", lefort_mm=0.0, bsso_mm=80.0)
    f1 = read_image(sorted(Path(r1["renders_dir"]).glob("*.png"))[0]).astype(np.float32)
    assert np.abs(f0 - f1).mean() > 0.05


def test_killed_and_resumed_training_ends_where_an_uninterrupted_run_ends(trained, tmp_path):
    """A run that stopped after 40 iterations (its checkpoint at 40 on disk)
    resumed to 80 with `resume=True`: the `train_resume` event, the manifest's
    record of it, and the uninterrupted run's avatar at 80."""
    data_dir = trained["case"]["path"]
    out = tmp_path / "model"
    pipe = trunner.Pipeline(back_half_config(Config), tmp_path / "work", device="cpu")
    pipe.model = trained["case"]["model"]
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pipe.train(data_dir, out, iterations=ITERS // 2)
        assert not (out / "point_cloud" / f"iteration_{ITERS}").exists()
        pipe.train(data_dir, out, resume=True)
    finally:
        torch.set_num_threads(before)
    resumed = [json.loads(line) for line in pipe.events.path.read_text().splitlines()
               if json.loads(line)["event"] == "train_resume"]
    assert [e["iteration"] for e in resumed] == [ITERS // 2]
    manifests = sorted((out / "experiment_manifests").glob("*.json"))
    assert json.loads(manifests[-1].read_text())["extra"]["resumed_from_iteration"] == ITERS // 2
    got = load_point_cloud(out / "point_cloud" / f"iteration_{ITERS}" / "point_cloud.ply")
    want = load_point_cloud(trained["model_dir"] / "point_cloud" / f"iteration_{ITERS}"
                            / "point_cloud.ply")
    for f in ("mu_local", "log_scale", "opacity_logit", "color", "sh"):
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   getattr(want, f).detach().numpy(), atol=1e-5, err_msg=f)
    refined_got = np.load(out / "flame_param_refined.npz")
    refined_want = np.load(trained["model_dir"] / "flame_param_refined.npz")
    for k in refined_want.files:
        np.testing.assert_allclose(refined_got[k], refined_want[k], atol=1e-5, err_msg=k)
    # resuming with nothing on disk starts fresh
    pipe.train(data_dir, tmp_path / "fresh", iterations=2, resume=True)
    assert len(resumed) == 1 and (tmp_path / "fresh" / "point_cloud" / "iteration_2").exists()


# ── (c) cross-package render and report ──────────────────────


def test_jax_and_port_render_and_score_the_port_trained_model(trained, tmp_path):
    jm, tm = models()
    data_dir = trained["case"]["path"]
    model_dir = tmp_path / "model"
    shutil.copytree(trained["model_dir"], model_dir)
    assert (model_dir / "flame_param_refined.npz").exists()
    out = {}
    for key in ("j", "t"):
        det = tmp_path / f"det_{key}"
        if key == "j":
            res = j_render_prediction(model_dir, data_dir, jm, output=tmp_path / "j.mp4",
                                      lefort_mm=5.0, bsso_mm=3.0, backend="never",
                                      max_per_tile=128, export_frames_dir=str(det))
            rep = j_generate_report(model_dir, det, tmp_path / "rep_j")
        else:
            res = trained["pipe"].render_surgery(model_dir, data_dir, tmp_path / "t.mp4",
                                                 5.0, 3.0, export_frames_dir=str(det))
            rep = trained["pipe"].report(model_dir, det, tmp_path / "rep_t")
        renders = Path(res["renders_dir"])
        out[key] = {"rep": rep, "frames": np.stack([read_image(p).astype(int) for p in
                                                    sorted(renders.glob("*.png"))])}
        shutil.copytree(renders, tmp_path / f"renders_{key}")
    diff = np.abs(out["t"]["frames"] - out["j"]["frames"])
    assert out["t"]["frames"].shape == out["j"]["frames"].shape
    assert diff.max() <= 1, (diff.max(), (diff > 1).mean())
    rows_j, rows_t = out["j"]["rep"]["rows"], out["t"]["rep"]["rows"]
    assert [r["frame"] for r in rows_t] == [r["frame"] for r in rows_j] and len(rows_t) == 24
    for rt, rj in zip(rows_t, rows_j):
        assert abs(rt["psnr"] - rj["psnr"]) <= 0.05, (rt, rj)
        assert rt["bucket"] == rj["bucket"]
    for b, sj in out["j"]["rep"]["summary"]["by_bucket"].items():
        st = out["t"]["rep"]["summary"]["by_bucket"][b]
        assert st["count"] == sj["count"]
        if sj["psnr"] is not None:
            assert abs(st["psnr"] - sj["psnr"]) <= 0.05

