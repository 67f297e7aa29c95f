"""Self-trained neural facial-landmark detector, in PyTorch.

Port of `omfs4d.track.detector`.  The detector is first-party: a small
strided-conv regressor trained by domain-randomized self-supervision.  The
package renders its own FLAME head (random expression, pose, camera, texture,
shading, background and photometrics) with the gaussian rasterizer and
supervises on the projected ground-truth landmark positions.  No files, no
labels.

Three parts:

  * the net (`LandmarkNet`, `init_net`, `net_apply`): three stride-2 3x3
    convs, two stride-1 trunk convs and a 1x1 heatmap head read out by a
    spatial softmax (soft-argmax).  The convolutions are
    `torch.nn.functional.conv2d`, padded the way XLA's "SAME" pads;
  * the sampler (`SyntheticFaceSampler`): `draw_batch` draws every random
    quantity of a batch from an explicit `torch.Generator`, `picture` turns
    those draws into (images, labels, alpha) and draws nothing.  Everything
    but the rasterizer runs batched over the samples; the rasterizer runs once
    per sample under `torch.no_grad()`, so on a CUDA device every synthetic
    face is one launch of the composite kernel, without its residual.  A batch
    makes no host sync;
  * training and use (`train_detector`, `get_or_train_detector`, `detect`).

Weights are cached as the reference's flat .npz (`conv0/w` ... in HWIO
layout, `meta/size`), so a file written by either package loads in both.
The distributions are the reference's, range for range; the random bits are
PyTorch's, so the cache file carries a name of its own.
"""

from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omfs4d_torch.core.device import model_on, resolve_device
from omfs4d_torch.core.logging import get_logger
from omfs4d_torch.models.flame import FlameModel, flame_forward, flame_landmarks
from omfs4d_torch.ops.camera import Camera
from omfs4d_torch.train.trainer import adam_init, adam_update

log = get_logger("detector")

# strided conv stack: channels per stage (each halves the resolution), then
# two stride-1 trunk convs and a 1x1 heatmap head.  A fully convolutional
# localization head is translation-equivariant, so it cannot memorize absolute
# layouts the way a flattened regressor can.
_CHANNELS = (32, 64, 128)
_STRIDES = (2, 2, 2)   # feature grid = S/8
_TRUNK = (128, 128)


def default_cache_dir() -> Path:
    return Path(os.environ.get(
        "OMFS4D_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "omfs4d")
    ))


# ── network ──────────────────────────────────────────────────


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero-pad the last two axes as XLA's "SAME" does: the output has
    ceil(n / stride) cells and an odd total goes to the high end.  For a 3x3
    kernel at stride 2 on an even size that is (0, 1), where
    `conv2d(padding=1)` would pad (1, 1) and shift every feature."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):          # F.pad takes the last axis first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def conv_same(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    k, s = conv.kernel_size[0], conv.stride[0]
    return F.conv2d(same_pad(x, k, s), conv.weight, conv.bias, stride=s)


def standardize(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, 3, H, W), each image to zero mean and unit
    (population) standard deviation: the features do not see gain or bias."""
    mu = images.mean(dim=(1, 2, 3), keepdim=True)
    sd = images.std(dim=(1, 2, 3), keepdim=True, correction=0)
    return ((images - mu) / (sd + 1e-5)).permute(0, 3, 1, 2)


def he_normal_(weight: torch.Tensor, generator: torch.Generator, scale: float = 1.0) -> None:
    """He init of an (O, I, kh, kw) weight in place: N(0, 2 / fan_in)."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator, device=generator.device)
                     * (scale * math.sqrt(2.0 / fan_in)))


class _FlatNet(nn.Module):
    """A stack of `nn.Conv2d` that reads and writes the reference's flat
    parameter dict: `<name>/w` (kh, kw, in, out) and `<name>/b` per conv."""

    def conv_names(self) -> list[str]:
        return [n for n, m in self.named_children() if isinstance(m, nn.Conv2d)]

    def _flat(self) -> dict:
        """The reference's flat dict of numpy arrays (HWIO weights); the
        public name is `omfs4d_torch.convert.net_params_to_numpy`."""
        out = {}
        for name in self.conv_names():
            conv = getattr(self, name)
            out[f"{name}/w"] = conv.weight.detach().permute(2, 3, 1, 0).cpu().numpy().copy()
            out[f"{name}/b"] = conv.bias.detach().cpu().numpy().copy()
        return out

    def _load_flat(self, params: dict) -> None:
        with torch.no_grad():
            for name in self.conv_names():
                conv = getattr(self, name)
                w = torch.tensor(np.asarray(params[f"{name}/w"], np.float32))
                conv.weight.copy_(w.permute(3, 2, 0, 1))
                conv.bias.copy_(torch.tensor(np.asarray(params[f"{name}/b"], np.float32)))


class LandmarkNet(_FlatNet):
    """The landmark localizer.  `log_temp` is the per-landmark softmax
    sharpness (log scale, learned); `size` is the train-time input size,
    carried with the weights so that `detect` can resize inputs to the trained
    distribution (the net itself is fully convolutional)."""

    def __init__(self, n_landmarks: int, image_size: int = 96):
        super().__init__()
        c_in = 3
        for i, (c_out, s) in enumerate(zip(_CHANNELS, _STRIDES)):
            setattr(self, f"conv{i}", nn.Conv2d(c_in, c_out, 3, stride=s))
            c_in = c_out
        for i, c_out in enumerate(_TRUNK):
            setattr(self, f"trunk{i}", nn.Conv2d(c_in, c_out, 3))
            c_in = c_out
        self.head = nn.Conv2d(c_in, n_landmarks, 1)
        self.log_temp = nn.Parameter(torch.zeros(n_landmarks))
        self.register_buffer("size", torch.tensor(float(image_size)))

    def _flat(self) -> dict:
        out = super()._flat()
        out["head/log_temp"] = self.log_temp.detach().cpu().numpy().copy()
        out["meta/size"] = np.asarray(self.size.cpu().numpy(), np.float32)
        return out

    @classmethod
    def _from_flat(cls, params: dict, device: str | torch.device) -> "LandmarkNet":
        """The public name is `omfs4d_torch.convert.detector_params_from_numpy`."""
        size = int(np.asarray(params.get("meta/size", 96.0)))
        net = cls(np.asarray(params["head/b"]).shape[0], size)
        net._load_flat(params)
        with torch.no_grad():
            net.log_temp.copy_(torch.tensor(np.asarray(params["head/log_temp"], np.float32)))
        return net.to(device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return net_apply(self, images)


def init_net(generator: torch.Generator, n_landmarks: int, image_size: int = 96) -> LandmarkNet:
    """He-init landmark localizer on the generator's device (head x 0.1,
    zero biases, unit softmax temperature)."""
    net = LandmarkNet(n_landmarks, image_size).to(generator.device)
    for name in net.conv_names():
        conv = getattr(net, name)
        he_normal_(conv.weight, generator, 0.1 if name == "head" else 1.0)
        nn.init.zeros_(conv.bias)
    return net


def net_apply(net: LandmarkNet, images: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) float in [0, 1] -> (B, L, 2) normalized landmark coords.

    Per-image standardization makes the features invariant to global gain and
    bias; the soft-argmax read-out keeps localization translation-equivariant."""
    x = standardize(images)
    for i in range(len(_CHANNELS)):
        x = F.relu(conv_same(x, getattr(net, f"conv{i}")))
    for i in range(len(_TRUNK)):
        x = F.relu(conv_same(x, getattr(net, f"trunk{i}")))
    logits = conv_same(x, net.head)                                   # (B, L, h, w)
    B, L, h, w = logits.shape
    temp = torch.exp(net.log_temp)
    attn = torch.softmax((logits * temp[None, :, None, None]).reshape(B, L, h * w), dim=-1)
    attn = attn.reshape(B, L, h, w)
    # expected position over normalized cell centres
    ys = (torch.arange(h, dtype=torch.float32, device=logits.device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=logits.device) + 0.5) / w
    ex = torch.einsum("blhw,w->bl", attn, xs)
    ey = torch.einsum("blhw,h->bl", attn, ys)
    return torch.stack([ex, ey], dim=-1)                              # (B, L, 2) in [0, 1]


def save_flat(path: str | Path, params: dict) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, **params)


def load_flat(path: str | Path) -> dict:
    data = np.load(Path(path))
    return {k: data[k] for k in data.files}


def save_detector(path: str | Path, net: LandmarkNet) -> None:
    save_flat(path, net._flat())


def load_detector(path: str | Path, device: str | torch.device | None = None) -> LandmarkNet:
    """The detector of a weights file on `device`: `device=None` takes the
    CUDA card and raises when there is none."""
    return LandmarkNet._from_flat(load_flat(path), resolve_device(device, "load_detector"))


# ── domain-randomized synthetic supervision ──────────────────


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-8)


def _look_at_w2c(eye: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """OpenCV-convention look-at on tensors, batched over leading axes
    (mirrors `ops.camera.look_at_camera`): (..., 3), (..., 3) -> (..., 4, 4)."""
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
    up = torch.zeros_like(fwd)
    up[..., 1] = 1.0
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], dim=-2)
    t = -(R @ eye[..., None])
    bottom = torch.zeros_like(R[..., :1, :])
    one = torch.ones_like(t[..., :1, :])
    return torch.cat([torch.cat([R, t], dim=-1), torch.cat([bottom, one], dim=-1)], dim=-2)


def draw_batch(generator: torch.Generator, batch_size: int, n_expr: int, n_faces: int,
               image_size: int, n_textures: int) -> dict:
    """Every random quantity of a batch of synthetic faces, on the
    generator's device, each with a leading batch axis.  The ranges are the
    reference's; directions are stored as drawn (normal) and normalized by
    `picture`."""
    B, S, dev = batch_size, image_size, generator.device

    def normal(*shape):
        return torch.randn((B, *shape), generator=generator, device=dev)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand((B, *shape), generator=generator, device=dev)

    def coin(p, *shape):
        return torch.rand((B, *shape), generator=generator, device=dev) < p

    two_pi = 2 * math.pi
    return {
        # FLAME parameters
        "expr": 0.5 * normal(n_expr),
        "jaw_pose": torch.cat([uniform(0.0, 0.35, 1), 0.05 * normal(2)], dim=1),
        "rotation": torch.cat([uniform(-0.3, 0.3, 1), uniform(-0.6, 0.6, 1),
                               uniform(-0.2, 0.2, 1)], dim=1),
        "translation": 0.02 * normal(3),
        # camera on a randomized orbit
        "angle": uniform(-0.7, 0.7),
        "radius": uniform(0.45, 0.8),
        "height": 0.12 * normal(),
        "focal": S * uniform(1.3, 2.2),
        # texture family: smooth directional waves, per-face speckle, blotches
        "wave_dirs": normal(3, 3),
        "wave_freq": uniform(3.0, 25.0, 3),
        "wave_phase": uniform(0.0, two_pi, 3),
        "speckle": uniform(0.0, 1.0, n_faces, 3),
        "blotch_dir": normal(3),
        "blotch_freq": uniform(3.0, 15.0),
        "blotch_phase": uniform(0.0, two_pi),
        "palette": uniform(0.0, 1.0, 2, 3),
        "mix": uniform(0.05, 1.0, 3),
        # directional lambertian shading
        "light_dir": normal(3),
        "ambient": uniform(0.35, 0.75),
        "diffuse": uniform(0.25, 0.65),
        # bank texture or randomized family
        "bank_gain": uniform(0.7, 1.3),
        "use_bank": coin(0.5),
        "bank_index": torch.randint(0, n_textures, (B,), generator=generator, device=dev),
        # background and photometrics
        "bg_a": uniform(0.0, 1.0, 3),
        "bg_b": uniform(0.0, 1.0, 3),
        "bg_theta": uniform(0.0, two_pi),
        "bg_solid": coin(0.25),
        "gain": uniform(0.55, 1.35),
        "bias": uniform(-0.1, 0.15),
        "noise": 0.02 * normal(S, S, 3),
        "blur_sigma": uniform(0.3, 1.2),
        "blur_on": coin(0.5),
        # two cutouts: on, centre (y, x) in pixels, half size (y, x) as a
        # fraction of the image, colour
        "cut_on": coin(0.5, 2),
        "cut_center": uniform(0.0, 1.0, 2, 2) * S,
        "cut_half": uniform(0.06, 0.16, 2, 2),
        "cut_color": uniform(0.0, 1.0, 2, 3),
    }


class SyntheticFaceSampler:
    """Generator of (image, normalized-landmark, alpha) training triples.

    Pre-builds a bank of textured avatars on the FLAME mesh; each sample draws
    an avatar, FLAME params, a camera on a randomized orbit, a texture and a
    light, a gradient background and photometric jitter.  The device is the
    model's: on a CUDA device the rasterizer launches the composite kernel
    (K1), on the CPU it takes the plain version.
    """

    def __init__(self, model: FlameModel, image_size: int = 96,
                 n_textures: int = 4, max_per_tile: int = 128):
        from omfs4d_torch.io.synthetic import textured_gt_avatar

        self.model = model
        self.size = int(image_size)
        self.max_per_tile = max_per_tile
        self.device = model.v_template.device
        bank = [textured_gt_avatar(model, seed=s) for s in range(n_textures)]
        self.avatar = bank[0]          # geometry fields are the same in every bank entry
        self.bank_color = torch.stack([g.color.detach() for g in bank])     # (n_tex, N, 3)
        self.n_textures = n_textures
        faces = model.faces.long()
        self.face_centers = model.v_template[faces].mean(dim=1)             # (F, 3) canonical

    def draw(self, generator: torch.Generator, batch_size: int) -> dict:
        if generator.device != self.device:
            raise ValueError(f"SyntheticFaceSampler: the generator is on {generator.device}, "
                             f"the model on {self.device}")
        return draw_batch(generator, batch_size, self.model.shapedirs_expr.shape[-1],
                          self.model.faces.shape[0], self.size, self.n_textures)

    def scene(self, d: dict):
        """The 3D scene of each sample of the draws `d`: posed vertices
        (B, V, 3), world-to-camera matrices (B, 4, 4) and the splats' colour
        logits (B, N, 3)."""
        model, dev = self.model, self.device
        verts = flame_forward(model, {
            "shape": torch.zeros(model.shapedirs_shape.shape[-1], device=dev),
            "expr": d["expr"], "jaw_pose": d["jaw_pose"], "rotation": d["rotation"],
            "translation": d["translation"]})                              # (B, V, 3)

        eye = torch.stack([d["radius"] * torch.sin(d["angle"]), d["height"],
                           d["radius"] * torch.cos(d["angle"])], dim=-1)
        w2c = _look_at_w2c(eye, torch.zeros_like(eye))                     # (B, 4, 4)

        # texture-family domain randomization: a net trained on any fixed
        # texture family reads landmark positions off the palette and
        # transfers nothing.  Smooth directional waves x per-face speckle x
        # two-palette blotches in a random convex mix leave geometry
        # (silhouette and shading) as the only reliable cue.
        ctr = self.face_centers
        proj = torch.einsum("fc,bkc->bfk", ctr, _unit(d["wave_dirs"]))
        smooth = 0.5 + 0.35 * torch.sin(proj * d["wave_freq"][:, None] + d["wave_phase"][:, None])
        field = torch.sin(torch.einsum("fc,bc->bf", ctr, _unit(d["blotch_dir"]))
                          * d["blotch_freq"][:, None] + d["blotch_phase"][:, None])
        blotch = torch.where(field[..., None] > 0.0, d["palette"][:, None, 0],
                             d["palette"][:, None, 1])
        w = d["mix"] / d["mix"].sum(dim=1, keepdim=True)
        cols = (w[:, None, 0:1] * smooth + w[:, None, 1:2] * d["speckle"]
                + w[:, None, 2:3] * blotch)                                # (B, F, 3)

        # directional lambertian shading on the deformed face normals:
        # interior geometry that survives any texture.  |n.l|: the face
        # winding is not guaranteed outward.
        fv = verts[:, model.faces.long()]                                  # (B, F, 3, 3)
        nrm = _unit(torch.linalg.cross(fv[:, :, 1] - fv[:, :, 0], fv[:, :, 2] - fv[:, :, 0]))
        lam = (d["ambient"][:, None] + d["diffuse"][:, None]
               * torch.abs(torch.einsum("bfc,bc->bf", nrm, _unit(d["light_dir"]))))
        # mixed distribution: half the samples keep the bank texture (sharp,
        # learnable landmark detail), half get the randomized family; both are
        # always shaded
        parent = self.avatar.parent_face.long()
        bank_cols = torch.sigmoid(self.bank_color[d["bank_index"]]
                                  * d["bank_gain"][:, None, None])
        mixed = torch.where(d["use_bank"][:, None, None], bank_cols, cols[:, parent])
        shaded = torch.clamp(mixed * lam[:, parent][..., None], 0.02, 0.98)
        return verts, w2c, torch.log(shaded / (1.0 - shaded))

    def camera(self, d: dict, w2c: torch.Tensor, i: int) -> Camera:
        """Sample i's camera (views of the batched tensors: no host sync)."""
        centre = torch.full((), self.size / 2, dtype=torch.float32, device=self.device)
        return Camera(w2c=w2c[i], fx=d["focal"][i], fy=d["focal"][i], cx=centre, cy=centre,
                      width=self.size, height=self.size)

    def splats(self, logits: torch.Tensor):
        """The bank's one-splat-per-face avatar with one sample's colours."""
        from omfs4d_torch.track.fitter import FaceSplats

        g = self.avatar
        return FaceSplats(g.parent_face, g.mu_local, g.quat_local, g.log_scale,
                          g.opacity_logit, logits, g.sh, g.alive)

    def picture(self, d: dict):
        """The draws of a batch (`draw_batch`) -> (images (B, S, S, 3),
        labels (B, L, 2) normalized, alpha (B, S, S)).  Draws nothing and
        makes no host sync."""
        from omfs4d_torch.render.rasterize import render_avatar_frame

        model, S, dev = self.model, self.size, self.device
        B = d["expr"].shape[0]
        verts, w2c, logits = self.scene(d)
        black = torch.zeros(3, dtype=torch.float32, device=dev)
        imgs, alphas = [], []
        with torch.no_grad():
            for i in range(B):
                img, aux = render_avatar_frame(self.splats(logits[i]), verts[i], model.faces,
                                               self.camera(d, w2c, i), S, S, background=black,
                                               max_per_tile=self.max_per_tile)
                imgs.append(img)
                alphas.append(aux["alpha"])
        img, alpha = torch.stack(imgs), torch.stack(alphas)

        # randomized background: a linear gradient along a random direction,
        # or a solid colour
        line = torch.linspace(-0.5, 0.5, S, device=dev)
        theta = d["bg_theta"][:, None, None]
        t = line[None, :, None] * torch.sin(theta) + line[None, None, :] * torch.cos(theta) + 0.5
        t = torch.where(d["bg_solid"][:, None, None], 0.5, t)[..., None]
        bg = d["bg_a"][:, None, None] * (1 - t) + d["bg_b"][:, None, None] * t
        img = img + (1.0 - alpha[..., None]) * bg
        img = torch.clamp(img * d["gain"][:, None, None, None]
                          + d["bias"][:, None, None, None] + d["noise"], 0, 1)

        # random separable gaussian blur (sigma up to ~1.2 px, half the
        # samples): edge sharpness differs across image formations, so it must
        # not become a feature
        offs = torch.arange(-2.0, 3.0, device=dev)
        kern = torch.exp(-0.5 * (offs[None] / d["blur_sigma"][:, None]) ** 2)
        kern = kern / kern.sum(dim=1, keepdim=True)
        kern = torch.where(d["blur_on"][:, None], kern, (offs == 0).to(torch.float32)[None])
        taps = kern.repeat_interleave(3, dim=0)                            # (B * 3, 5)
        x = img.permute(0, 3, 1, 2).reshape(1, B * 3, S, S)
        x = F.conv2d(x, taps[:, None, :, None], padding=(2, 0), groups=B * 3)
        x = F.conv2d(x, taps[:, None, None, :], padding=(0, 2), groups=B * 3)
        img = x.reshape(B, 3, S, S).permute(0, 2, 3, 1)

        # cutout: 0-2 random opaque boxes.  The landmark labels stay put
        # (regress through occlusion); the alpha label is zeroed (an occluder
        # hides the foreground from matting).
        alpha_lbl = alpha
        grid = torch.arange(S, device=dev) + 0.5
        for c in range(2):
            half = d["cut_half"][:, c] * S * d["cut_on"][:, c, None].to(torch.float32)
            cyx = d["cut_center"][:, c]
            box = ((torch.abs(grid[None, :, None] - cyx[:, 0, None, None])
                    < half[:, 0, None, None])
                   & (torch.abs(grid[None, None, :] - cyx[:, 1, None, None])
                      < half[:, 1, None, None]))
            img = torch.where(box[..., None], d["cut_color"][:, c, None, None], img)
            alpha_lbl = torch.where(box, 0.0, alpha_lbl)

        lmk3d = flame_landmarks(model, verts)                              # (B, L, 3)
        p = torch.einsum("blc,bdc->bld", lmk3d, w2c[:, :3, :3]) + w2c[:, None, :3, 3]
        z = p[..., 2]
        safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        focal = d["focal"][:, None]
        uv = torch.stack([focal * p[..., 0] / safe_z + S / 2,
                          focal * p[..., 1] / safe_z + S / 2], dim=-1)
        return img, uv / S, alpha_lbl

    def batch(self, generator: torch.Generator, batch_size: int):
        """(images (B, S, S, 3), labels (B, L, 2) normalized, alpha (B, S, S)).
        `alpha` is the ground-truth foreground coverage (the matting net's
        supervision)."""
        return self.picture(self.draw(generator, batch_size))


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """`optax.cosine_decay_schedule` as a function of a count tensor."""
    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp_max(count.to(torch.float32), decay_steps)
        cos = 0.5 * (1.0 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cos + alpha)

    return schedule


def detector_loss(net: LandmarkNet, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean Huber loss (delta 0.05) of the predicted normalized landmarks."""
    return F.huber_loss(net_apply(net, images), labels, delta=0.05)


def adam_step(net: nn.Module, opt_state: dict, loss: torch.Tensor, lr) -> None:
    """One `adam_update` of every parameter of `net` on `loss`, in place."""
    params = dict(net.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    adam_update(opt_state, dict(zip(params, grads)), params, lr)


def train_detector(
    model: FlameModel,
    steps: int = 1500,
    batch_size: int = 32,
    image_size: int = 96,
    lr: float = 3e-4,
    seed: int = 0,
    device: str | torch.device | None = None,
    log_every: int = 200,
    history: list | None = None,
) -> LandmarkNet:
    """Train the regressor on domain-randomized synthetic renders, on
    `device` (the CUDA card by default).  `history`, when given, receives
    each step's loss as a tensor on the device (no host sync)."""
    dev = resolve_device(device, "train_detector")
    model = model_on(model, dev)
    sampler = SyntheticFaceSampler(model, image_size)
    generator = torch.Generator(device=dev).manual_seed(seed)
    net = init_net(generator, model.lmk_faces_idx.shape[0], image_size)
    opt_state = adam_init(dict(net.named_parameters()))
    schedule = cosine_decay_schedule(lr, steps, alpha=0.1)

    for i in range(steps):
        images, labels, _ = sampler.batch(generator, batch_size)
        loss = detector_loss(net, images, labels)
        adam_step(net, opt_state, loss, schedule)
        if history is not None:
            history.append(loss.detach())
        if log_every and (i % log_every == 0 or i == steps - 1):
            value = float(loss.detach())
            px = math.sqrt(value * 2) * image_size  # rough px scale
            log.info(f"detector step {i}: huber {value:.5f} (~{px:.1f}px)")
    return net


def detector_cache_path(model: FlameModel, image_size: int, steps: int) -> Path:
    """"sa2" = soft-argmax head trained on the texture-randomized, shaded
    sampler; "torch" = this package's random stream, so that nets trained on
    the reference's stream are never taken for these."""
    n_lmk = model.lmk_faces_idx.shape[0]
    return default_cache_dir() / (
        f"landmark_net_sa2_torch_v{model.n_vertices}_l{n_lmk}_s{image_size}_t{steps}.npz")


def get_or_train_detector(
    model: FlameModel,
    weights: str | Path | None = None,
    image_size: int = 96,
    steps: int = 1500,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> LandmarkNet:
    """Load cached weights keyed by (mesh, size, steps); train if absent."""
    dev = resolve_device(device, "get_or_train_detector")
    if weights is not None and Path(weights).exists():
        return load_detector(weights, dev)
    cache = detector_cache_path(model, image_size, steps)
    if weights is None and cache.exists():
        log.info(f"loading cached detector weights: {cache}")
        return load_detector(cache, dev)
    log.info(f"training landmark detector ({steps} steps @ {image_size}px)...")
    net = train_detector(model, steps=steps, image_size=image_size, seed=seed, device=dev)
    save_detector(Path(weights) if weights else cache, net)
    return net


def resize_frames(frames: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C), linear and antialiased when it
    shrinks (`jax.image.resize(..., "linear")`)."""
    x = F.interpolate(frames.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                      antialias=True, align_corners=False)
    return x.permute(0, 2, 3, 1)


def frames_on(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """A chunk of a frame stack (uint8, or float in [0, 1]) -> float32 in
    [0, 1] on `device`."""
    x = torch.as_tensor(frames).to(device)
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def detect(
    net: LandmarkNet,
    frames: np.ndarray,              # (T, H, W, 3) uint8 or float [0, 1]
    image_size: int | None = None,
    chunk: int = 64,
) -> tuple[np.ndarray, np.ndarray]:
    """Run the detector over a frame stack, on the net's device ->
    ((T, L, 2) px coords, valid)."""
    T, H, W = frames.shape[:3]
    S = image_size or int(net.size)
    dev = net.log_temp.device
    scale = torch.tensor([W, H], dtype=torch.float32).to(dev)
    out = []
    with torch.no_grad():
        for i in range(0, T, chunk):
            x = resize_frames(frames_on(frames[i:i + chunk], dev), S, S)
            out.append((net_apply(net, x) * scale).cpu().numpy())
    return np.concatenate(out).astype(np.float32), np.ones(T, bool)
