"""The port's pipeline back half on a CUDA card: `Pipeline.train` keeps the
avatar's state on the card and launches K1 and K2 once a step, and
`Pipeline.render_surgery` renders on the card with one K1 launch a frame, then
`Pipeline.report` scores those frames.  Without a card every test here skips.

This file imports only the port (no jax), so it also runs on a machine
without JAX:  python -m pytest --noconftest tests/test_torch_pipeline_card.py
"""

import numpy as np
import pytest
import torch

from omfs4d_torch.core.config import Config
from omfs4d_torch.io.synthetic import make_synthetic_dataset
from omfs4d_torch.io.video import probe_video, read_image
from omfs4d_torch.pipeline import runner as trunner
from omfs4d_torch.render import composite as tc
from omfs4d_torch.train import trainer as tt

S, N_FRAMES, ITERS = 64, 12, 6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the composite kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_train_render_and_report_run_on_the_card(cuda_device, tmp_path, monkeypatch):
    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))
    case = make_synthetic_dataset(tmp_path / "data", n_frames=N_FRAMES, width=S, height=S,
                                  n_vertices=700, seed=0)
    assert case["model"].v_template.device.type == "cuda"
    cfg = Config()
    cfg.train.iterations = ITERS
    cfg.train.densify_interval = 0
    cfg.train.opacity_reset_interval = 0
    cfg.train.max_gaussians = 4096
    cfg.render.max_per_tile = 128
    cfg.pipeline.min_train_frames = 2
    pipe = trunner.Pipeline(cfg, tmp_path / "work")
    assert pipe.device == cuda_device
    pipe.model = case["model"]

    states = []
    real_train = tt.AvatarTrainer.train

    def noted(self, *args, **kwargs):
        states.append(real_train(self, *args, **kwargs))
        return states[-1]

    monkeypatch.setattr(tt.AvatarTrainer, "train", noted)
    fwd, bwd = tc.composite.launches, tc.composite.backward_launches
    model_dir = pipe.train(case["path"], tmp_path / "model")
    torch.cuda.synchronize()
    state = states[0]
    assert state.gaussians.mu_local.device == cuda_device
    assert all(v.device == cuda_device for v in state.flame_params.values())
    assert tc.composite.backward_launches - bwd == ITERS
    assert tc.composite.launches - fwd == ITERS
    assert (model_dir / "flame_param_refined.npz").exists()

    fwd = tc.composite.launches
    result = pipe.render_surgery(model_dir, case["path"], tmp_path / "pred.mp4", 5.0, 3.0,
                                 export_frames_dir=str(tmp_path / "det"))
    n = N_FRAMES - N_FRAMES // 10
    assert tc.composite.launches - fwd == n
    assert pipe.model.v_template.device == cuda_device
    renders = sorted((model_dir / "train" / f"ours_{ITERS}" / "renders").glob("*.png"))
    assert len(renders) == n and read_image(renders[0]).std() > 0
    report = pipe.report(model_dir, tmp_path / "det")
    assert report["summary"]["count"] == n
    assert all(np.isfinite(r["psnr"]) for r in report["rows"])
    # H.264 where there is an ffmpeg binary, else Motion JPEG: a frame per render
    assert result["video"] == str(tmp_path / "pred.mp4") and result["video_error"] is None
    assert probe_video(tmp_path / "pred.mp4")["frame_count"] == n
