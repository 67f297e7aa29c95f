"""The port's training loop on its own, on the CPU: kill-and-resume (the
port copy of the reference's test_train_resume_matches_uninterrupted) and
a tiny single-frame overfit through `run_single_frame_experiment`, whose
checkpoint reads back through the prediction path's loaders.  Data comes
from the port's own synthetic 64^2 capture.
"""

import json

import numpy as np
import pytest
import torch

from omfs4d_torch.core.config import TrainConfig
from omfs4d_torch.io.dataset import FrameDataset
from omfs4d_torch.io.synthetic import make_synthetic_dataset
from omfs4d_torch.models.flame import flame_forward
from omfs4d_torch.pipeline.single_frame import run_single_frame_experiment
from omfs4d_torch.train import trainer as tt
from omfs4d_torch.train.checkpoints import (checkpoint_lineage, latest_checkpoint,
                                            load_point_cloud, restore_state,
                                            trained_render_meta, trained_tile_window)
from omfs4d_torch.train.losses import psnr

W = H = 64
K = 128


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return make_synthetic_dataset(tmp_path_factory.mktemp("capture") / "data", n_frames=2,
                                  width=W, height=H, n_vertices=700, seed=0, device="cpu")


def capture_data(case):
    """The trainer's `data` dict of the capture (as the pipeline builds it)."""
    ds = FrameDataset(case["path"])
    params = {k: v for k, v in ds.flame_params.items() if k != "dynamic_offset"}
    cams = [ds.camera(i) for i in range(len(ds))]
    with torch.no_grad():
        verts = flame_forward(case["model"], params)
    return {
        "images": np.stack([ds.load_image(i) for i in range(len(ds))]),
        "verts": verts.numpy(),
        "w2c": np.stack([c.w2c.numpy() for c in cams]),
        **{k: np.array([float(getattr(c, k)) for c in cams], np.float32)
           for k in ("fx", "fy", "cx", "cy")},
    }


def test_train_resume_matches_uninterrupted(case, tmp_path):
    data = capture_data(case)
    faces = case["model"].faces.numpy()
    cfg = TrainConfig(iterations=80, densify_from=10, densify_interval=30,
                  densify_until_frac=0.8, opacity_reset_interval=0,
                  max_gaussians=1024, batch_frames=1)

    def make():
        t = tt.AvatarTrainer(faces, cfg, W, H, max_per_tile=K, device="cpu")
        return t, t.init_state(capacity=1024)

    t_full, s_full = make()
    s_full = t_full.train(data, iterations=80, state=s_full, log_every=1000)

    out = tmp_path / "run"
    t_a, s_a = make()
    t_a.train(data, iterations=80, state=s_a, output_dir=out, log_every=1000)
    assert [r["iteration"] for r in checkpoint_lineage(out)] == [20, 40, 80]
    t_b, _ = make()
    s_resumed = restore_state(out / "checkpoints" / "iter_0000040")
    assert int(s_resumed.step) == 40
    s_resumed = t_b.train(data, iterations=80, state=s_resumed, log_every=1000,
                          start_iteration=40)

    for f in ("mu_local", "color", "log_scale", "opacity_logit"):
        np.testing.assert_allclose(getattr(s_resumed.gaussians, f).detach().numpy(),
                                   getattr(s_full.gaussians, f).detach().numpy(),
                                   atol=1e-5, err_msg=f)
    assert int(s_resumed.step) == int(s_full.step) == 80
    assert torch.equal(s_resumed.gaussians.alive, s_full.gaussians.alive)

    found = latest_checkpoint(out)
    assert found is not None and found[1] == 80
    t_c, s_tmpl = make()
    s_c, it_c = t_c.restore_checkpoint(out, template=s_tmpl)
    assert it_c == 80
    assert torch.equal(s_c.gaussians.mu_local, s_full.gaussians.mu_local.detach())
    for grp, st in s_full.opt_state.items():
        assert int(s_c.opt_state[grp]["count"]) == int(st["count"]) == 80


def test_single_frame_overfit(case, tmp_path):
    # the untrained avatar's PSNR on frame 0 (the experiment's own init)
    ds = FrameDataset(case["path"])
    params = {k: v for k, v in ds.load_frame_params(0).items() if k != "dynamic_offset"}
    t0 = tt.AvatarTrainer(case["model"].faces.numpy(), TrainConfig(), W, H, max_per_tile=K,
                          device="cpu")
    img0 = t0.render_frame(t0.init_state(), flame_forward(case["model"], params)[0],
                           ds.camera(0))
    p0 = float(psnr(img0, torch.tensor(ds.load_image(0) / 255.0, dtype=torch.float32)))

    res = run_single_frame_experiment(case["path"], case["model"], tmp_path / "sf",
                                      iterations=100, max_per_tile=K)
    assert res["psnr"] > p0 + 4.0, (p0, res)
    model_dir = tmp_path / "sf" / "model"
    assert {d.name for d in (model_dir / "point_cloud").iterdir()} == {
        "iteration_25", "iteration_50", "iteration_100"}
    meta = json.loads((model_dir / "checkpoints" / "iter_0000100_meta.json").read_text())
    assert set(meta) == {"iteration", "capacity", "max_tiles_per_gaussian", "large_frac",
                         "max_per_tile"}
    assert trained_render_meta(model_dir)["max_per_tile"] == K
    assert trained_tile_window(model_dir) == meta["max_tiles_per_gaussian"]
    g = load_point_cloud(model_dir / "point_cloud" / "iteration_100" / "point_cloud.ply")
    assert g.sh.shape[1] == 15 and int(g.alive.sum()) > 0


@pytest.mark.parametrize("where", ["data", "state"])
def test_train_refuses_data_or_state_on_another_device(case, where):
    """Device tensors are never moved to the trainer's device (here the
    CPU, for want of a FLAME model and a card): the call raises before any
    step.  The `meta` device stands in for a card."""
    data = capture_data(case)
    t = tt.AvatarTrainer(case["model"].faces.numpy(), TrainConfig(), W, H,
                         max_per_tile=K, device="cpu")
    state = t.init_state(capacity=1024)
    if where == "data":
        data["verts"] = torch.from_numpy(data["verts"]).to("meta")
    else:
        state = tt._map_capacity(state, lambda x: x.to("meta"))
    with pytest.raises(ValueError, match=f"{where}.* is on meta"):
        t.train(data, iterations=2, state=state, log_every=1000)
    if where == "data":
        assert int(state.step) == 0


def test_trainer_defaults_to_the_card_and_raises_without_one(case, monkeypatch):
    """With no FLAME model and no `device`, the trainer takes the CUDA card;
    with no card it raises and never carries on on the CPU.  A FLAME model
    lends its device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    faces = case["model"].faces.numpy()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.AvatarTrainer(faces, TrainConfig(), W, H, max_per_tile=K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.AvatarTrainer(faces, TrainConfig(), W, H, max_per_tile=K, device="cuda")
    assert tt.AvatarTrainer(faces, TrainConfig(), W, H, max_per_tile=K,
                            flame_model=case["model"]).device.type == "cpu"
    assert tt.AvatarTrainer(faces, TrainConfig(), W, H, max_per_tile=K,
                            device="cpu").device.type == "cpu"
