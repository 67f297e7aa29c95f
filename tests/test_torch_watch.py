"""The port's pipeline watcher (`omfs4d_torch.pipeline.watch`) on the CPU: the
three `wait_for_event` cases of `tests/test_watch_and_singleframe.py`, against
the reference's function on the same event files, and
`continue_when_track_finishes` on a tiny case whose tracking has already ended
(a `stage_end` of `track` written beforehand): train -> render -> strict
report with the reference's default deterministic indices.
"""

import json
import threading
import time

import numpy as np
import pytest

from omfs4d.pipeline.watch import wait_for_event as j_wait_for_event
from omfs4d_torch.core import config as tconfig
from omfs4d_torch.io import video as tvideo
from omfs4d_torch.io.synthetic import make_synthetic_dataset
from omfs4d_torch.models import assets as tassets
from omfs4d_torch.pipeline import runner as trunner
from omfs4d_torch.pipeline.watch import continue_when_track_finishes, wait_for_event
from tests.test_torch_track import one_torch_thread  # noqa: F401  (autouse here too)


@pytest.mark.parametrize("wait", [wait_for_event, j_wait_for_event], ids=["port", "reference"])
def test_wait_for_event_finds_record(tmp_path, wait):
    events = tmp_path / "events.jsonl"

    def writer():
        time.sleep(0.2)
        with open(events, "a") as f:
            f.write("not json\n")
            f.write(json.dumps({"event": "stage_start", "stage": "track"}) + "\n")
            f.write(json.dumps({"event": "stage_end", "stage": "track",
                                "seconds": 12.5}) + "\n")

    t = threading.Thread(target=writer)
    t.start()
    rec = wait(events, "stage_end", stage="track", timeout=10.0, poll=0.1)
    t.join(timeout=10)
    assert not t.is_alive()
    assert rec is not None and rec["seconds"] == 12.5


@pytest.mark.parametrize("wait", [wait_for_event, j_wait_for_event], ids=["port", "reference"])
def test_wait_for_event_times_out(tmp_path, wait):
    assert wait(tmp_path / "none.jsonl", "stage_end", timeout=0.3, poll=0.1) is None


@pytest.mark.parametrize("wait", [wait_for_event, j_wait_for_event], ids=["port", "reference"])
def test_ignores_other_stages(tmp_path, wait):
    events = tmp_path / "events.jsonl"
    with open(events, "w") as f:
        f.write(json.dumps({"event": "stage_end", "stage": "preprocess"}) + "\n")
    assert wait(events, "stage_end", stage="track", timeout=0.3, poll=0.1) is None
    # no stage asked for: any stage_end will do
    assert wait(events, "stage_end", timeout=0.3, poll=0.1)["stage"] == "preprocess"


FullConfig = tconfig.Config


def small_config():
    cfg = FullConfig()
    cfg.train.iterations = 20
    cfg.train.densify_interval = 0
    cfg.train.opacity_reset_interval = 0
    cfg.train.max_gaussians = 2048
    cfg.render.max_per_tile = 128
    cfg.pipeline.min_train_frames = 2
    return cfg


def test_continue_when_track_finishes(tmp_path, monkeypatch):
    """The watcher builds `Pipeline(Config(), workdir)`: here `Config()` is cut
    to 20 iterations and the asset to 700 vertices."""
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setattr(tconfig, "Config", small_config)
    monkeypatch.setattr(trunner, "synthetic_flame_asset",
                        lambda: tassets.synthetic_flame_asset(n_vertices=700, seed=0))
    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))
    case = make_synthetic_dataset(tmp_path / "data", n_frames=12, width=48, height=48,
                                  n_vertices=700, seed=0, device="cpu")
    wd = tmp_path / "work"
    wd.mkdir()
    (wd / "events.jsonl").write_text(json.dumps({"event": "stage_end", "stage": "track",
                                                 "seconds": 3.0}) + "\n")
    out = continue_when_track_finishes(wd, case["path"], tmp_path / "model",
                                       tmp_path / "pred.mp4", 5.0, 3.0, timeout=5.0,
                                       device="cpu")
    assert out is not None
    # no ffmpeg: the prediction is an H.264 MP4 (the port's encoder), a frame per render
    assert out["render"]["video"] == str(tmp_path / "pred.mp4") and out["render"]["iteration"] == 20
    assert out["render"]["video_error"] is None
    assert tvideo.probe_video(tmp_path / "pred.mp4")["frame_count"] == 11
    # the reference's default indices, those inside the 11 training frames
    assert json.loads((wd / "deterministic_indices.json").read_text())["indices"] == list(
        range(0, 100, 10))
    assert [r["index"] for r in out["report"]["rows"]] == [0, 10]
    assert all(np.isfinite(r["psnr"]) for r in out["report"]["rows"])
    ends = [json.loads(line)["stage"] for line in (wd / "events.jsonl").read_text().splitlines()
            if json.loads(line)["event"] == "stage_end"]
    assert ends == ["track", "train", "render_surgery", "report"]
    # with no tracking in sight it gives up at its timeout
    assert continue_when_track_finishes(tmp_path / "none", case["path"], tmp_path / "m2",
                                        tmp_path / "p2.mp4", 0.0, 0.0, timeout=0.2,
                                        device="cpu") is None
