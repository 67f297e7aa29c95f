"""Training-state checkpoints, gaussian PLY snapshots and checkpoint metadata.

Port of `omfs4d.train.checkpoints`.  The layout is the reference's training
output: `checkpoints/iter_XXXXXXX/` (the state), `checkpoints/
iter_XXXXXXX_meta.json` and `point_cloud/iteration_N/point_cloud.ply`.  A
PLY written by either package loads in the other.  The state itself is in
the port's own format (orbax is the JAX package's): `state.pt` in the
checkpoint directory, a `torch.save` of plain dicts of tensors, which
`torch.load(weights_only=True)` reads back.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from omfs4d_torch.io.ply import load_ply, save_ply
from omfs4d_torch.models.gaussians import FIELDS as GAUSSIAN_FIELDS
from omfs4d_torch.models.gaussians import GaussianAvatar

STATE_FILE = "state.pt"


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return None if x is None else fn(x)


def state_to_dict(state) -> dict:
    """A TrainState as nested dicts of tensors (gaussians by field)."""
    g = state.gaussians
    return {
        "gaussians": {k: getattr(g, k).detach() for k in GAUSSIAN_FIELDS},
        "opt_state": state.opt_state,
        "step": state.step,
        "grad_accum": state.grad_accum,
        "grad_count": state.grad_count,
        "flame_params": state.flame_params,
        "flame_opt_state": state.flame_opt_state,
    }


def state_from_dict(d: dict):
    """Inverse of `state_to_dict`."""
    from omfs4d_torch.train.trainer import TrainState

    return TrainState(
        gaussians=GaussianAvatar(**d["gaussians"]),
        opt_state=d["opt_state"], step=d["step"], grad_accum=d["grad_accum"],
        grad_count=d["grad_count"], flame_params=d.get("flame_params"),
        flame_opt_state=d.get("flame_opt_state"))


def snapshot_state(state):
    """A copy of the state on its device, so a writer thread never sees the
    tensors the next training step updates in place."""
    return state_from_dict(_tree_map(lambda t: t.detach().clone(), state_to_dict(state)))


def save_state(path: str | Path, state) -> Path:
    """Write the state into directory `path` (created).  Returns `path`."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    host = _tree_map(lambda t: t.detach().cpu(), state_to_dict(state))
    tmp = path / f"{STATE_FILE}.tmp"
    torch.save(host, tmp)
    tmp.replace(path / STATE_FILE)
    return path


def restore_state(path: str | Path, device: str | torch.device = "cpu"):
    """Read a state written by `save_state` onto `device`."""
    d = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
    return state_from_dict(_tree_map(lambda t: t.to(device), d))


def latest_checkpoint(output_dir: str | Path) -> tuple[Path, int] | None:
    """Newest full-state checkpoint under `<output_dir>/checkpoints/iter_*`."""
    rows = checkpoint_lineage(output_dir)
    if not rows:
        return None
    return Path(rows[-1]["path"]), rows[-1]["iteration"]


def checkpoint_lineage(output_dir: str | Path) -> list[dict]:
    """All checkpoints on disk, oldest first."""
    ckpt_root = Path(output_dir) / "checkpoints"
    if not ckpt_root.is_dir():
        return []
    rows = []
    for d in ckpt_root.iterdir():
        if d.is_dir() and d.name.startswith("iter_"):
            try:
                rows.append({"iteration": int(d.name.split("_", 1)[1]), "path": str(d)})
            except ValueError:
                pass
    return sorted(rows, key=lambda r: r["iteration"])


def trained_render_meta(output_dir: str | Path,
                        iteration: int | None = None) -> dict:
    """Runtime render knobs the trainer ended up using (max_tiles_per_gaussian,
    max_per_tile, ...) from `checkpoints/iter_*_meta.json`.  The prediction
    renderer must render with at least these: the avatar was optimized
    against them."""
    ckpt_root = Path(output_dir) / "checkpoints"
    if not ckpt_root.is_dir():
        return {}
    metas = sorted(ckpt_root.glob("iter_*_meta.json"))
    if iteration is not None:
        exact = ckpt_root / f"iter_{iteration:07d}_meta.json"
        if exact.exists():
            metas = [exact]
    if not metas:
        return {}
    try:
        return json.loads(metas[-1].read_text())
    except (ValueError, OSError):
        return {}


def trained_tile_window(output_dir: str | Path,
                        iteration: int | None = None) -> int | None:
    """max_tiles_per_gaussian from the checkpoint meta (see
    `trained_render_meta`)."""
    return int(trained_render_meta(output_dir, iteration)
               .get("max_tiles_per_gaussian", 0)) or None


def latest_iteration(output_dir: str | Path) -> int | None:
    """Highest `point_cloud/iteration_*`."""
    pc = Path(output_dir) / "point_cloud"
    if not pc.is_dir():
        return None
    iters = []
    for d in pc.iterdir():
        if d.name.startswith("iteration_"):
            try:
                iters.append(int(d.name.split("_")[1]))
            except ValueError:
                pass
    return max(iters) if iters else None


def export_point_cloud(path: str | Path, gaussians: GaussianAvatar):
    """Write the alive gaussians as a PLY point cloud (local frame +
    attributes) — loadable by `load_point_cloud` of either package."""
    g = {k: v.detach().cpu().numpy() for k, v in
         list(gaussians.named_parameters()) + list(gaussians.named_buffers())}
    alive = g["alive"]
    mu, quat, ls, col = g["mu_local"], g["quat_local"], g["log_scale"], g["color"]
    props = {
        "x": mu[alive, 0],
        "y": mu[alive, 1],
        "z": mu[alive, 2],
        "parent_face": g["parent_face"][alive].astype(np.int32),
        "quat_w": quat[alive, 0],
        "quat_x": quat[alive, 1],
        "quat_y": quat[alive, 2],
        "quat_z": quat[alive, 3],
        "log_scale_x": ls[alive, 0],
        "log_scale_y": ls[alive, 1],
        "log_scale_z": ls[alive, 2],
        "opacity_logit": g["opacity_logit"][alive],
        "color_r": col[alive, 0],
        "color_g": col[alive, 1],
        "color_b": col[alive, 2],
    }
    # SH rest coefficients as f_rest_i (the CUDA 3DGS PLY field convention)
    sh = g["sh"][alive].reshape(-1, g["sh"].shape[1] * 3)
    for i in range(sh.shape[1]):
        props[f"f_rest_{i}"] = sh[:, i]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    save_ply(path, props)


def load_point_cloud(path: str | Path, capacity: int | None = None,
                     device: str | torch.device = "cpu") -> GaussianAvatar:
    """Read a gaussian PLY into a `GaussianAvatar` of `capacity` slots
    (default: exactly the stored gaussians, all alive) on `device`."""
    v = load_ply(path)["vertex"]
    n = len(v["x"])
    cap = capacity or n

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, dtype=x.dtype)
        out[:n] = x
        return out

    mu = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    quat = np.stack([v["quat_w"], v["quat_x"], v["quat_y"], v["quat_z"]], 1).astype(np.float32)
    ls = np.stack([v["log_scale_x"], v["log_scale_y"], v["log_scale_z"]], 1).astype(np.float32)
    col = np.stack([v["color_r"], v["color_g"], v["color_b"]], 1).astype(np.float32)
    names = v.dtype.names
    n_rest = sum(1 for name in names if name.startswith("f_rest_"))
    if n_rest:
        sh = np.stack([v[f"f_rest_{i}"] for i in range(n_rest)], 1)
        sh = sh.astype(np.float32).reshape(-1, n_rest // 3, 3)
    elif "sh1_0" in names:   # round-1 checkpoints
        sh = np.stack([v[f"sh1_{i}"] for i in range(9)], 1).astype(np.float32)
        sh = sh.reshape(-1, 3, 3)
    else:
        sh = np.zeros((n, 15, 3), np.float32)
    alive = np.zeros(cap, bool)
    alive[:n] = True
    quat_pad = pad(quat)
    quat_pad[n:, 0] = 1.0
    return GaussianAvatar(
        parent_face=pad(v["parent_face"].astype(np.int32)),
        mu_local=pad(mu),
        quat_local=quat_pad,
        log_scale=pad(ls),
        opacity_logit=pad(v["opacity_logit"].astype(np.float32)),
        color=pad(col),
        sh=pad(sh),
        alive=alive,
    ).to(device)
