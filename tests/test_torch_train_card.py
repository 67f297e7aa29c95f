"""The port's trainer on a CUDA card: it stays on the card when handed CUDA
data with no FLAME model and no device, and its step makes no host sync.
Without a card every test here skips.

This file imports only the port (no jax), so it also runs on a machine
without JAX:  python -m pytest --noconftest tests/test_torch_train_card.py
"""

import numpy as np
import pytest
import torch

from omfs4d_torch.core.config import TrainConfig
from omfs4d_torch.io.dataset import FrameDataset
from omfs4d_torch.io.synthetic import make_synthetic_dataset
from omfs4d_torch.models.flame import flame_forward
from omfs4d_torch.render import composite as tc
from omfs4d_torch.train import trainer as tt

W = H = 64
K = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the composite kernels have no CPU mode")
    return torch.device("cuda", 0)


def capture(tmp_path, device):
    """A 2-frame 64^2 synthetic capture on `device`: (model, data, params)."""
    case = make_synthetic_dataset(tmp_path / "data", n_frames=2, width=W, height=H,
                                  n_vertices=700, seed=0, device=device)
    ds = FrameDataset(case["path"])
    params = {k: v for k, v in ds.flame_params.items() if k != "dynamic_offset"}
    cams = [ds.camera(i, device=device) for i in range(len(ds))]
    with torch.no_grad():
        verts = flame_forward(case["model"], params)
    data = {
        "images": torch.from_numpy(np.stack([ds.load_image(i) for i in range(len(ds))])
                                   ).to(device),
        "verts": verts,
        "w2c": torch.stack([c.w2c for c in cams]),
        **{k: torch.stack([getattr(c, k) for c in cams]) for k in ("fx", "fy", "cx", "cy")},
    }
    return case["model"], data, params


def test_trainer_stays_on_the_card_for_cuda_data(cuda_device, tmp_path):
    model, data, _ = capture(tmp_path, cuda_device)
    cfg = TrainConfig(iterations=3, opacity_reset_interval=0, max_gaussians=4096,
                      batch_frames=1)
    trainer = tt.AvatarTrainer(model.faces.cpu().numpy(), cfg, W, H, max_per_tile=K)
    assert trainer.device.type == "cuda"
    fwd, bwd = tc.composite.launches, tc.composite.backward_launches
    state = trainer.train(data, iterations=3, log_every=1000)
    torch.cuda.synchronize()
    assert state.gaussians.mu_local.device.type == "cuda"
    assert tc.composite.backward_launches - bwd == 3
    assert tc.composite.launches - fwd >= 3


@pytest.mark.parametrize("co_optimize", [True, False])
def test_train_step_makes_no_host_sync_on_card(cuda_device, tmp_path, co_optimize):
    model, data, params = capture(tmp_path, cuda_device)
    cfg = TrainConfig(iterations=10, opacity_reset_interval=0, max_gaussians=4096,
                      batch_frames=1)
    trainer = tt.AvatarTrainer(model.faces.cpu().numpy(), cfg, W, H, max_per_tile=K,
                               flame_model=model if co_optimize else None)
    assert trainer.co_optimize == co_optimize
    state = trainer.init_state(capacity=4096, flame_params=params)
    for i in range(2):                       # warm-up: allocator, cuBLAS handles
        state, _ = trainer.train_step(state, data, [i])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = trainer.train_step(state, data, np.array([1]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(metrics["loss"]))
