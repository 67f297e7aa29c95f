"""Move parameters and training state between the JAX package and this port.

The `*_from_numpy` functions take the fields of the JAX NamedTuples as numpy
arrays (in a test: `jax.tree_util.tree_map(np.asarray, x)._asdict()`) and
return this package's objects on `device`; `to_numpy` goes the other way.
`opt_state_from_optax` and `train_state_from_jax` read the reference's
optax / TrainState objects by their attributes (no jax or optax import
here), so a test can start both trainers from the same state.
`detector_params_from_numpy` / `segnet_params_from_numpy` turn the reference's
flat weight dicts (HWIO convolutions) into this package's nets (OIHW), and
`net_params_to_numpy` goes back: one .npz serves both packages.
`sharded_state_from_jax` carries the reference's state to one rank's shard of the
port's gaussian-sharded trainer, and `gathered_state_to_numpy` gathers it back.
"""

from __future__ import annotations

import numpy as np
import torch

from omfs4d_torch.models.flame import FlameModel
from omfs4d_torch.models.gaussians import FIELDS as GAUSSIAN_FIELDS
from omfs4d_torch.models.gaussians import GaussianAvatar
from omfs4d_torch.ops.camera import Camera, _camera


def flame_model_from_numpy(fields: dict, device: str | torch.device = "cpu") -> FlameModel:
    return FlameModel(**fields).to(device)


def gaussians_from_numpy(fields: dict, device: str | torch.device = "cpu") -> GaussianAvatar:
    return GaussianAvatar(**{k: fields[k] for k in GAUSSIAN_FIELDS}).to(device)


def camera_from_numpy(w2c, fx, fy, cx, cy, width, height,
                      device: str | torch.device = "cpu") -> Camera:
    return _camera(w2c, fx, fy, cx, cy, width, height, device)


def flame_params_from_numpy(params: dict, device: str | torch.device = "cpu") -> dict:
    """FLAME parameter dict (arrays) -> float32 tensors on `device`."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in params.items()}


#: the tracker's parameter dict (`FlameTracker.init_params`)
TRACKER_KEYS = ("shape", "expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose",
                "translation", "texture", "static_offset", "dynamic_offset",
                "focal_log_scale")


def tracker_params_from_numpy(params: dict, device: str | torch.device = "cpu") -> dict:
    """The 11-key tracker dict of `FlameTracker.init_params` (arrays, in a
    test `jax.tree_util.tree_map(np.asarray, p)`) -> float32 tensors on
    `device`; `to_numpy` is the way back."""
    missing = [k for k in TRACKER_KEYS if k not in params]
    if missing:
        raise KeyError(f"tracker params lack {missing}")
    return flame_params_from_numpy({k: params[k] for k in TRACKER_KEYS}, device)


def opt_state_from_optax(state, device: str | torch.device = "cpu") -> dict:
    """An `optax.multi_transform` state of `optax.adam` groups -> the port's
    {group: {"count", "mu": {name}, "nu": {name}}}.  Groups with no Adam
    state (`set_to_zero`) are left out; masked leaves are dropped."""
    out = {}
    for group, masked in state.inner_states.items():
        inner = masked.inner_state
        if not (isinstance(inner, tuple) and inner and hasattr(inner[0], "mu")):
            continue
        adam = inner[0]

        def leaves(tree):
            return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
                    for k, v in tree.items() if hasattr(v, "shape")}

        out[group] = {"count": torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                                            device=device),
                      "mu": leaves(adam.mu), "nu": leaves(adam.nu)}
    return out


def train_state_from_jax(state, device: str | torch.device = "cpu"):
    """The reference's `TrainState` -> the port's, on `device`."""
    from omfs4d_torch.train.trainer import TrainState

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    g = {k: np.asarray(v) for k, v in state.gaussians._asdict().items()}
    return TrainState(
        gaussians=gaussians_from_numpy(g, device),
        opt_state=opt_state_from_optax(state.opt_state, device),
        step=t(state.step, torch.int32),
        grad_accum=t(state.grad_accum),
        grad_count=t(state.grad_count),
        flame_params=(None if state.flame_params is None
                      else flame_params_from_numpy(state.flame_params, device)),
        flame_opt_state=(None if state.flame_opt_state is None
                         else opt_state_from_optax(state.flame_opt_state, device)),
    )


def detector_params_from_numpy(params: dict, device: str | torch.device):
    """The reference's flat detector dict (`conv0/w` ... HWIO, `head/log_temp`,
    `meta/size`) as numpy arrays -> a `LandmarkNet` on `device`."""
    from omfs4d_torch.track.detector import LandmarkNet

    return LandmarkNet._from_flat(params, device)


def segnet_params_from_numpy(params: dict, device: str | torch.device):
    """The reference's flat matting-net dict (`enc0/w` ... HWIO) as numpy
    arrays -> a `SegNet` on `device`."""
    from omfs4d_torch.track.segnet import SegNet

    return SegNet._from_flat(params, device)


def net_params_to_numpy(net) -> dict:
    """A `LandmarkNet` or `SegNet` -> the reference's flat dict of numpy
    arrays (HWIO convolutions), what `save_detector` writes."""
    return net._flat()


def to_numpy(x):
    """A tensor -> numpy array; a module (its parameters and buffers), a
    Camera or a dict -> dict of numpy arrays (other values pass through)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, torch.nn.Module):
        return {k: to_numpy(v) for k, v in
                list(x.named_parameters()) + list(x.named_buffers())}
    if isinstance(x, Camera):
        return {k: to_numpy(getattr(x, k)) for k in
                ("w2c", "fx", "fy", "cx", "cy", "width", "height")}
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x


def sharded_state_from_jax(state, trainer):
    """The reference's `TrainState` of a whole cloud (a `ShardedAvatarTrainer`
    state is a global array on the JAX side) -> this rank's shard of the
    port's state for `trainer`, a port `ShardedAvatarTrainer`, on its
    device."""
    return trainer.shard_state(train_state_from_jax(state, trainer.device))


def gathered_state_to_numpy(trainer, state) -> dict:
    """This rank's shard -> the whole state as nested dicts of numpy arrays
    (`checkpoints.state_to_dict`'s layout).  A collective: every rank of the
    trainer's axis calls it."""
    from omfs4d_torch.train.checkpoints import state_to_dict

    return to_numpy(state_to_dict(trainer.gather_state(state)))
