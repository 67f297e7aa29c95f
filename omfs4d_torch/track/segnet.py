"""Self-trained neural foreground matting (encoder-decoder), in PyTorch.

Port of `omfs4d.track.segnet`.  Like the landmark detector
(`track/detector.py`), this module trains its own model by domain-randomized
self-supervision: the synthetic face sampler composites FLAME renders over
random backgrounds and knows the true alpha, so (image, alpha) pairs are
free.  A small strided-conv encoder and a resize-conv decoder with skip
connections predict the matte; weights are cached as the reference's flat
.npz (`enc0/w` ... in HWIO layout), which loads in either package.

Registered as ``method="neural"`` in `omfs4d_torch.track.matting`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omfs4d_torch.core.device import model_on, resolve_device
from omfs4d_torch.core.logging import get_logger
from omfs4d_torch.models.flame import FlameModel
from omfs4d_torch.track.detector import (
    SyntheticFaceSampler,
    _FlatNet,
    adam_step,
    conv_same,
    cosine_decay_schedule,
    default_cache_dir,
    frames_on,
    he_normal_,
    load_flat,
    resize_frames,
    save_flat,
    standardize,
)
from omfs4d_torch.train.trainer import adam_init

log = get_logger("segnet")

#: encoder channels per stride-2 stage; the decoder mirrors them
_ENC = (16, 32, 64, 128)


class SegNet(_FlatNet):
    """Four stride-2 encoder convs, the mirrored decoder (upsample, concat
    the skip, conv) and a 1x1 output conv."""

    def __init__(self):
        super().__init__()
        c_in = 3
        for i, c_out in enumerate(_ENC):
            setattr(self, f"enc{i}", nn.Conv2d(c_in, c_out, 3, stride=2))
            c_in = c_out
        for i in reversed(range(len(_ENC))):
            c_skip = 3 if i == 0 else _ENC[i - 1]
            c_out = max(c_skip, 16)
            setattr(self, f"dec{i}", nn.Conv2d(c_in + c_skip, c_out, 3))
            c_in = c_out
        self.out = nn.Conv2d(c_in, 1, 1)

    @classmethod
    def _from_flat(cls, params: dict, device: str | torch.device) -> "SegNet":
        """The public name is `omfs4d_torch.convert.segnet_params_from_numpy`."""
        net = cls()
        net._load_flat(params)
        return net.to(device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return segnet_apply(self, images)


def init_segnet(generator: torch.Generator, image_size: int = 96) -> SegNet:
    """He-init matting net on the generator's device (output conv N(0, 0.1),
    zero biases).  The net is fully convolutional: `image_size` is kept for
    the reference's signature."""
    net = SegNet().to(generator.device)
    for name in net.conv_names():
        conv = getattr(net, name)
        if name == "out":
            with torch.no_grad():
                conv.weight.copy_(0.1 * torch.randn(conv.weight.shape, generator=generator,
                                                    device=generator.device))
        else:
            he_normal_(conv.weight, generator)
        nn.init.zeros_(conv.bias)
    return net


def segnet_apply(net: SegNet, images: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) float [0, 1] -> (B, S, S) alpha logits.

    Per-image standardization: global gain and bias must not shift the matte
    (cf. `detector.net_apply`)."""
    x = standardize(images)
    skips = [x]
    for i in range(len(_ENC)):
        x = F.relu(conv_same(x, getattr(net, f"enc{i}")))
        skips.append(x)
    for i in reversed(range(len(_ENC))):
        skip = skips[i]
        # samples at half-pixel centres, as `jax.image.resize(..., "nearest")`
        x = F.interpolate(x, size=skip.shape[-2:], mode="nearest-exact")
        x = torch.cat([x, skip], dim=1)
        x = F.relu(conv_same(x, getattr(net, f"dec{i}")))
    return conv_same(x, net.out)[:, 0]


def segnet_loss(net: SegNet, images: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy of the logits against the (soft) alpha."""
    return F.binary_cross_entropy_with_logits(segnet_apply(net, images), alpha)


def train_segnet(
    model: FlameModel,
    steps: int = 800,
    batch_size: int = 16,
    image_size: int = 96,
    lr: float = 1e-3,
    seed: int = 0,
    device: str | torch.device | None = None,
    log_every: int = 200,
    history: list | None = None,
) -> SegNet:
    """Train on the detector's domain-randomized sampler (its alpha is the
    ground truth), on `device` (the CUDA card by default).  `history`, when
    given, receives each step's loss as a tensor on the device."""
    dev = resolve_device(device, "train_segnet")
    model = model_on(model, dev)
    sampler = SyntheticFaceSampler(model, image_size)
    generator = torch.Generator(device=dev).manual_seed(seed)
    net = init_segnet(generator, image_size)
    opt_state = adam_init(dict(net.named_parameters()))
    schedule = cosine_decay_schedule(lr, steps, alpha=0.1)

    for i in range(steps):
        images, _, alpha = sampler.batch(generator, batch_size)
        loss = segnet_loss(net, images, alpha)
        adam_step(net, opt_state, loss, schedule)
        if history is not None:
            history.append(loss.detach())
        if log_every and (i % log_every == 0 or i == steps - 1):
            log.info(f"segnet step {i}: bce {float(loss.detach()):.4f}")
    return net


def save_segnet(path: str | Path, net: SegNet) -> None:
    save_flat(path, net._flat())


def load_segnet(path: str | Path, device: str | torch.device | None = None) -> SegNet:
    """The matting net of a weights file on `device`: `device=None` takes the
    CUDA card and raises when there is none."""
    return SegNet._from_flat(load_flat(path), resolve_device(device, "load_segnet"))


def segnet_cache_path(model: FlameModel, image_size: int, steps: int) -> Path:
    """"n3" = standardized-input net on the texture-randomized, shaded
    sampler; "torch" = this package's random stream."""
    return default_cache_dir() / (
        f"segnet_n3_torch_v{model.n_vertices}_s{image_size}_t{steps}.npz")


def get_or_train_segnet(
    model: FlameModel,
    weights: str | Path | None = None,
    image_size: int = 96,
    steps: int = 800,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> SegNet:
    dev = resolve_device(device, "get_or_train_segnet")
    if weights is not None and Path(weights).exists():
        return load_segnet(weights, dev)
    cache = segnet_cache_path(model, image_size, steps)
    if weights is None and cache.exists():
        log.info(f"loading cached matting weights: {cache}")
        return load_segnet(cache, dev)
    log.info(f"training matting net ({steps} steps @ {image_size}px)...")
    net = train_segnet(model, steps=steps, image_size=image_size, seed=seed, device=dev)
    save_segnet(Path(weights) if weights else cache, net)
    return net


def predict_masks(net: SegNet, frames: np.ndarray, image_size: int = 96,
                  chunk: int = 32, threshold: float = 0.5) -> np.ndarray:
    """(T, H, W, 3) uint8/float -> (T, H, W) float32 {0, 1} masks, on the
    net's device."""
    T, H, W = frames.shape[:3]
    S = image_size
    dev = net.out.weight.device
    out = []
    with torch.no_grad():
        for i in range(0, T, chunk):
            x = resize_frames(frames_on(frames[i:i + chunk], dev), S, S)
            logits = segnet_apply(net, x)
            full = resize_frames(logits[..., None], H, W)[..., 0]
            out.append(torch.sigmoid(full).cpu().numpy())
    return (np.concatenate(out) > threshold).astype(np.float32)
