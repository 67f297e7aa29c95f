"""Cross-distribution robustness evaluation for the self-trained nets, port
of `omfs4d.track.robustness`.

The landmark detector (`track.detector`) and the matting net (`track.segnet`)
are trained on domain-randomized splat renders of a procedural texture
family.  Real inputs differ from that distribution, so this module measures
how much accuracy survives three deliberate shifts, none of which appears in
the training sampler:

  * held-out textures: plane-wave stripes, per-face speckle and two-tone
    faces, disjoint from the bank of `io.synthetic.textured_gt_avatar`;
  * a different image formation: frames come from the soft mesh rasterizer
    (`render.mesh_raster`), not the gaussian splatter the nets were trained
    on (edge profiles, silhouettes and interiors all differ);
  * photometrics outside the training ranges plus structured backgrounds:
    training draws gain 0.55-1.35, bias -0.1..0.15 and gradient or solid
    backgrounds; eval draws gain 0.45-0.55 or 1.4-1.5, bias -0.2..-0.12 or
    0.16-0.25, checkerboard backgrounds, and pastes 1-2 opaque boxes larger
    than the training cutouts.

The random draws come from one `np.random.Generator` in the reference's
order, so a seed gives the reference's batch.
"""

from __future__ import annotations

import numpy as np
import torch

from omfs4d_torch.models.flame import FlameModel, flame_forward, flame_landmarks
from omfs4d_torch.ops.camera import look_at_camera, project_points
from omfs4d_torch.render.mesh_raster import rasterize_mesh

TEXTURES = ("stripes", "speckle", "twotone")


def heldout_face_colors(model: FlameModel, kind: str,
                        rng: np.random.Generator) -> np.ndarray:
    """(F, 3) colours from a texture family the training bank never uses."""
    faces = model.faces.cpu().numpy()
    centers = model.v_template.cpu().numpy()[faces].mean(axis=1)
    if kind == "stripes":
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        freq = rng.uniform(60.0, 140.0)
        phase = rng.uniform(0, 2 * np.pi)
        t = 0.5 + 0.5 * np.sin(centers @ d * freq + phase)
        c_a, c_b = rng.uniform(0.05, 0.95, (2, 3))
        cols = c_a * t[:, None] + c_b * (1 - t[:, None])
    elif kind == "speckle":
        cols = rng.uniform(0.05, 0.95, (len(faces), 3))
    elif kind == "twotone":
        base, low = rng.uniform(0.1, 0.9, (2, 3))
        thresh = np.quantile(centers[:, 1], rng.uniform(0.25, 0.55))
        cols = np.where(centers[:, 1:2] < thresh, low, base)
    else:
        raise ValueError(f"unknown held-out texture {kind!r}")
    return np.clip(cols, 0.02, 0.98).astype(np.float32)


def _heldout_background(S: int, rng: np.random.Generator) -> np.ndarray:
    """Checkerboard: periodic structure outside the training family (linear
    gradients and solids)."""
    cell = max(4, S // rng.integers(4, 9))
    yy, xx = np.meshgrid(np.arange(S) // cell, np.arange(S) // cell,
                         indexing="ij")
    checker = ((yy + xx) % 2).astype(np.float32)[..., None]
    c0, c1 = rng.uniform(0, 1, (2, 3))
    return c0 * checker + c1 * (1 - checker)


def _occlude(img: np.ndarray, alpha: np.ndarray,
             rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Paste 1-2 opaque boxes; occluded pixels are background for matting."""
    S = img.shape[0]
    for _ in range(int(rng.integers(1, 3))):
        side_y = int(rng.uniform(0.15, 0.3) * S)
        side_x = int(rng.uniform(0.15, 0.3) * S)
        y0 = int(rng.integers(0, S - side_y))
        x0 = int(rng.integers(0, S - side_x))
        img[y0:y0 + side_y, x0:x0 + side_x] = rng.uniform(0, 1, 3)
        alpha[y0:y0 + side_y, x0:x0 + side_x] = 0.0
    return img, alpha


def shifted_eval_batch(
    model: FlameModel,
    n: int = 16,
    image_size: int = 64,
    seed: int = 0,
    occlude: bool = True,
    photometrics: bool = True,
    heldout_bg: bool = True,
):
    """Out-of-distribution eval set for the detector and matting nets,
    rendered on the model's device.

    Returns ``(images (n, S, S, 3) float32, labels (n, L, 2) normalized,
    alpha (n, S, S) float32)`` as numpy arrays.  Labels are ground-truth
    projected FLAME landmarks; alpha is the mesh rasterizer's coverage with
    occluded pixels zeroed (an occluder hides the foreground).
    """
    rng = np.random.default_rng(seed)
    S = int(image_size)
    dev = model.v_template.device
    n_expr = model.shapedirs_expr.shape[-1]
    faces_np = model.faces.cpu().numpy()
    images, labels, alphas = [], [], []
    for i in range(n):
        params = {
            "shape": np.zeros((model.shapedirs_shape.shape[-1],), np.float32),
            "expr": np.asarray(0.5 * rng.normal(size=(1, n_expr)), np.float32),
            "jaw_pose": np.asarray(
                [[rng.uniform(0.0, 0.35), 0.05 * rng.normal(),
                  0.05 * rng.normal()]], np.float32),
            "rotation": np.asarray(
                [[rng.uniform(-0.3, 0.3), rng.uniform(-0.6, 0.6),
                  rng.uniform(-0.2, 0.2)]], np.float32),
            "translation": np.asarray(0.02 * rng.normal(size=(1, 3)), np.float32),
        }
        with torch.no_grad():
            verts = flame_forward(model, params)[0]
        ang = rng.uniform(-0.7, 0.7)
        radius = rng.uniform(0.45, 0.8)
        eye = (radius * np.sin(ang), 0.12 * rng.normal(),
               radius * np.cos(ang))
        cam = look_at_camera(eye=eye, target=(0, 0, 0),
                             fx=S * rng.uniform(1.3, 2.2),
                             width=S, height=S, device=dev)

        cols = heldout_face_colors(model, TEXTURES[i % len(TEXTURES)], rng)
        # directional shading in the training ranges (shading itself is not
        # a shift axis: the texture family, formation and photometrics are)
        fv = verts.cpu().numpy()[faces_np]
        nrm = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True) + 1e-8
        ldir = rng.normal(size=3)
        ldir /= np.linalg.norm(ldir) + 1e-8
        lam = (rng.uniform(0.35, 0.75)
               + rng.uniform(0.25, 0.65) * np.abs(nrm @ ldir))
        cols = np.clip(cols * lam[:, None], 0.0, 1.0).astype(np.float32)
        with torch.no_grad():
            img, aux = rasterize_mesh(verts, model.faces, torch.from_numpy(cols).to(dev),
                                      cam, S, S, sigma=0.6)
        img = img.cpu().numpy().astype(np.float32)
        alpha = aux["alpha"].cpu().numpy().astype(np.float32)

        if heldout_bg:
            bg = _heldout_background(S, rng)
        else:
            c0, c1 = rng.uniform(0, 1, (2, 3))
            ramp = np.linspace(0, 1, S)[:, None, None]
            bg = (c0 * (1 - ramp) + c1 * ramp) * np.ones((1, S, 1))
        img = img + (1.0 - alpha[..., None]) * bg
        # photometrics strictly outside the training ranges
        if photometrics:
            gain = rng.uniform(0.45, 0.55) if rng.random() < 0.5 \
                else rng.uniform(1.4, 1.5)
            bias = rng.uniform(-0.2, -0.12) if rng.random() < 0.5 \
                else rng.uniform(0.16, 0.25)
        else:
            gain, bias = 1.0, 0.0
        img = np.clip(img * gain + bias
                      + 0.03 * rng.normal(size=img.shape), 0, 1)
        if occlude:
            img, alpha = _occlude(img, alpha, rng)

        with torch.no_grad():
            lmk_uv, _ = project_points(cam, flame_landmarks(model, verts[None])[0])
        images.append(img.astype(np.float32))
        labels.append(lmk_uv.cpu().numpy().astype(np.float32) / S)
        alphas.append(alpha)
    return (np.stack(images), np.stack(labels), np.stack(alphas))


def detector_px_error(net, images: np.ndarray, labels: np.ndarray) -> float:
    """Mean landmark error in pixels of the detector on an eval batch."""
    from omfs4d_torch.track.detector import net_apply

    S = images.shape[1]
    dev = net.log_temp.device
    with torch.no_grad():
        pred = net_apply(net, torch.as_tensor(images).to(dev))
        err = torch.linalg.norm((pred - torch.as_tensor(labels).to(dev)) * S, dim=-1)
    return float(err.mean())


def mask_iou(pred: np.ndarray, gt: np.ndarray,
             threshold: float = 0.5) -> float:
    """Mean IoU of thresholded predicted masks vs (soft) GT alpha."""
    p = np.asarray(pred) > threshold
    g = np.asarray(gt) > threshold
    inter = np.logical_and(p, g).sum(axis=(1, 2))
    union = np.logical_or(p, g).sum(axis=(1, 2))
    return float(np.mean(inter / np.maximum(union, 1)))
