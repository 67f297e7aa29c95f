"""3DGS avatar trainer in PyTorch: one step, fixed-capacity densification.

Port of `omfs4d.train.trainer`.  The structure follows the reference:

  * one training step runs FLAME-bound gaussians -> rasterize -> L1 + D-SSIM
    -> Adam; the frames of a batch are a loop, and the reference's
    `lax.scan` chunks become a plain loop of steps;
  * densify / clone / split / prune never change array shapes: gaussians
    live in fixed-capacity tensors with an `alive` mask;
  * densification pressure is the screen-space positional gradient, read
    through a zero `probe` added to the projected centres;
  * checkpoints at N/4, N/2 and N, each a `torch.save` of the state plus a
    `point_cloud/iteration_N` PLY snapshot, in the reference's layout.

Adam is written as plain tensor functions (`adam_init`, `adam_update`) that
reproduce optax's arithmetic, including the step count at which a schedule
is read (the count *before* the update) and one count per parameter group.

The step updates the state's tensors in place (parameters, Adam moments,
accumulators) and returns the state: the port keeps one copy of each
capacity-sized tensor where the reference donates buffers.  It reads
nothing back to the host; the loop reads metrics only at its boundaries.
"""

from __future__ import annotations

import json
import math
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from omfs4d_torch.core.config import TrainConfig
from omfs4d_torch.core.device import resolve_device
from omfs4d_torch.core.logging import EventLogger, get_logger
from omfs4d_torch.models.flame import flame_forward
from omfs4d_torch.models.gaussians import (
    PARAM_FIELDS,
    GaussianAvatar,
    bind_to_mesh,
    eval_colors,
    init_gaussians_on_mesh,
    inverse_sigmoid,
)
from omfs4d_torch.ops.camera import Camera, project_gaussians
from omfs4d_torch.render.composite import composite
from omfs4d_torch.render.rasterize import ALPHA_CUTOFF, bin_gaussians
from omfs4d_torch.train.losses import dssim_loss, l1_loss, psnr

log = get_logger("train")

FLOAT_FIELDS = PARAM_FIELDS

#: parameter group of each gaussian field (optax multi_transform labels)
PARAM_GROUPS = {
    "mu_local": "pos",
    "quat_local": "rot",
    "log_scale": "scale",
    "opacity_logit": "opac",
    "color": "color",
    "sh": "sh",
}

#: FLAME keys that co-optimization never moves (the reference's "frozen")
FLAME_FROZEN = ("shape", "static_offset")


class TrainState(NamedTuple):
    gaussians: GaussianAvatar
    opt_state: dict            # group -> {"count", "mu": {field}, "nu": {field}}
    step: torch.Tensor         # () int32
    grad_accum: torch.Tensor   # (N,) summed screen-space grad norms
    grad_count: torch.Tensor   # (N,) observations
    flame_params: dict | None = None      # co-optimized FLAME params
    flame_opt_state: dict | None = None   # "pose" / "expr" groups


def float_fields(g: GaussianAvatar) -> dict:
    """The differentiable subset of the gaussians."""
    return {k: getattr(g, k) for k in FLOAT_FIELDS}


# ── optimizer: optax.adam per group, as tensor functions ─────────────────


def adam_init(params: dict) -> dict:
    """Zero moments and a zero count for one parameter group."""
    dev = next(iter(params.values())).device
    return {"count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def adam_update(group: dict, grads: dict, params: dict, lr,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """optax.adam(lr) then optax.apply_updates, in place on `params` and
    `group`.  `lr` is a float or a schedule of the group's count."""
    count = group["count"]
    step_size = lr(count) if callable(lr) else lr        # read before the increment
    count_inc = count + 1
    exp = count_inc.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, exp)        # a Python base: no host-to-device copy
    bc2 = 1.0 - torch.pow(b2, exp)
    with torch.no_grad():
        for k, g in grads.items():
            mu = (1 - b1) * g + b1 * group["mu"][k]
            nu = (1 - b2) * (g * g) + b2 * group["nu"][k]
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            params[k].copy_(params[k] + (-step_size) * update)
            group["mu"][k].copy_(mu)
            group["nu"][k].copy_(nu)
        count.copy_(count_inc)


def _decay_horizon(cfg: TrainConfig) -> int:
    """Steps over which the decaying schedules run (then hold their floor):
    `lr_decay_horizon` capped at `iterations` (0 = `iterations`)."""
    horizon = cfg.lr_decay_horizon
    if horizon <= 0:
        return max(cfg.iterations, 1)
    return max(min(horizon, cfg.iterations), 1)


def densify_until_iter(cfg: TrainConfig, iterations: int) -> int:
    """Last iteration at which densification (and its cadenced siblings)
    may fire: a fraction of the decay horizon, not just of `iterations`."""
    horizon = cfg.lr_decay_horizon
    span = min(iterations, horizon) if horizon > 0 else iterations
    return int(span * cfg.densify_until_frac)


def _position_lr(cfg: TrainConfig):
    """optax.exponential_decay(lr_position -> lr_position * final over the
    horizon, held at the floor past it); final >= 1 keeps a constant LR."""
    final = cfg.lr_position_final_scale
    if final >= 1.0:
        return cfg.lr_position
    init, steps, end = cfg.lr_position, _decay_horizon(cfg), cfg.lr_position * final

    def schedule(count: torch.Tensor) -> torch.Tensor:
        p = count.to(torch.float32) / steps
        decayed = torch.where(count <= 0, init, init * torch.pow(final, p))
        return torch.clamp_min(decayed, end)

    return schedule


def _flame_lr(cfg: TrainConfig, peak: float):
    """FLAME co-optimization LR: optax.warmup_cosine_decay_schedule from
    peak/10 up to `peak` over the warmup, then down to
    peak * lr_flame_final_scale at the horizon; warmup 0 = constant."""
    warmup = cfg.lr_flame_warmup
    if warmup <= 0:
        return peak
    horizon = _decay_horizon(cfg)
    init = peak * 0.1
    warmup_steps = min(warmup, max(horizon // 10, 1))
    decay_steps = float(max(horizon, warmup + 1) - warmup_steps)
    end = peak * cfg.lr_flame_final_scale
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        lin = (init - peak) * (1 - torch.clamp(c, 0, warmup_steps) / warmup_steps) + peak
        cd = torch.clamp_max(c - warmup_steps, decay_steps)
        cos = 0.5 * (1 + torch.cos(math.pi * cd / decay_steps))
        return torch.where(count < warmup_steps, lin, peak * ((1 - alpha) * cos + alpha))

    return schedule


def gaussian_lrs(cfg: TrainConfig) -> dict:
    """LR (float or schedule) of each gaussian parameter group."""
    return {"pos": _position_lr(cfg), "rot": cfg.lr_rotation,
            "scale": cfg.lr_scale, "opac": cfg.lr_opacity,
            "color": cfg.lr_color,
            "sh": cfg.lr_color / 20.0}                 # 3DGS: SH rest at DC/20


def init_opt_state(g: GaussianAvatar) -> dict:
    """One Adam group per gaussian field."""
    return {grp: adam_init({k: getattr(g, k).detach()})
            for k, grp in PARAM_GROUPS.items()}


def flame_groups(keys) -> dict:
    """FLAME key -> group: "expr", "frozen" (shape, static offset) or "pose"."""
    return {k: ("expr" if k == "expr" else "frozen" if k in FLAME_FROZEN
                else "pose") for k in keys}


def init_flame_opt_state(flame_params: dict) -> dict:
    groups = flame_groups(flame_params)
    return {grp: adam_init({k: v for k, v in flame_params.items() if groups[k] == grp})
            for grp in ("pose", "expr") if grp in groups.values()}


# ── render with the densification probe ─────────────────────────────────


def _render_with_probe(gaussians, probe, verts, faces, cam: Camera,
                       width, height, bg, render_cfg, clock=None):
    """Rasterize one frame; `probe` (N, 2) is added to the screen-space
    means, so its gradient is the densification pressure signal.  Returns
    (image, (overflow, window_clipped, spilled))."""
    means, rot, scales, opac, _ = bind_to_mesh(gaussians, verts, faces)
    cols = eval_colors(gaussians, means, cam.position)
    if clock is not None:
        clock.lap("bind_colors")
    proj = dict(project_gaussians(cam, means, rot, scales))
    proj["uv"] = proj["uv"] + probe
    if clock is not None:
        clock.lap("project")
    binning = bin_gaussians(
        {k: v.detach() for k, v in proj.items()}, opac.detach(),
        width, height, render_cfg["tile"], render_cfg["max_per_tile"],
        render_cfg["max_tiles_per_gaussian"],
        small_tiles_per_gaussian=render_cfg.get("small_tiles_per_gaussian", 4),
        large_frac=render_cfg.get("large_frac", 0.125),
        two_class_min_n=render_cfg.get("two_class_min_n", 4096),
        large_min=render_cfg.get("large_min", 1024),
    )
    if clock is not None:
        clock.lap("bin")
    img, alpha = composite(proj["uv"], proj["conic"], cols, opac, binning,
                           width, height, render_cfg["tile"])
    img = img + (1.0 - alpha)[..., None] * bg
    if clock is not None:
        clock.lap("composite")
    return img, (binning.overflow, binning.window_clipped, binning.spilled)


# ── densify / prune on raw tensors ──────────────────────────────────────

# grad_count seed for "alive through an observed window with zero
# observations" (see densify_prune_arrays); any negative value works
UNSEEN_MARK = -0.25


def densify_prune_arrays(g: GaussianAvatar, grad_accum: torch.Tensor,
                         grad_count: torch.Tensor, noise, max_new: int,
                         cfg: TrainConfig):
    """Fixed-capacity densify / clone / split / prune.

    `noise` is the (max_new, 3) standard-normal draw for the children's
    offsets (`AvatarTrainer.densify_noise`; tests inject JAX's).  Returns
    (g2, slots, ok, new_grad_count); `new_grad_count` carries the
    UNSEEN_MARK streak state the zero-observation prune needs."""
    dev = grad_accum.device
    alive = g.alive
    grad_avg = grad_accum / torch.clamp_min(grad_count, 1.0)
    candidate = alive & (grad_avg > cfg.densify_grad_threshold)
    scores = torch.where(candidate, grad_avg, -1.0)
    top_scores, src = torch.topk(scores, max_new)

    # dead slots first (stable argsort on alive: False < True)
    slots = torch.argsort(alive.to(torch.int32), stable=True)[:max_new]
    ok = (top_scores > 0) & ~alive[slots]

    p = {k: getattr(g, k).detach() for k in FLOAT_FIELDS}
    max_local_scale = torch.exp(p["log_scale"][src]).max(dim=-1).values
    is_split = max_local_scale > 1.0

    noise = noise.to(dev) * torch.exp(p["log_scale"][src])
    child_mu = p["mu_local"][src] + noise
    log16 = math.log(1.6)
    child_ls = p["log_scale"][src] - torch.where(is_split[:, None], log16, 0.0)

    def put(arr, vals):
        sel = ok.reshape((-1,) + (1,) * (vals.ndim - 1))
        out = arr.clone()
        out[slots] = torch.where(sel, vals, arr[slots])
        return out

    log_scale = put(p["log_scale"], child_ls)
    # shrink split parents
    log_scale = log_scale.index_add(
        0, src, -torch.where(ok & is_split, log16, 0.0)[:, None].expand(-1, 3))
    new_alive = alive.clone()
    new_alive[slots] = ok | alive[slots]
    fields = {
        "parent_face": put(g.parent_face, g.parent_face[src]),
        "mu_local": put(p["mu_local"], child_mu),
        "quat_local": put(p["quat_local"], p["quat_local"][src]),
        "log_scale": log_scale,
        "opacity_logit": put(p["opacity_logit"], p["opacity_logit"][src]),
        "color": put(p["color"], p["color"][src]),
        "sh": put(p["sh"], p["sh"][src]),
    }

    # prune transparent and oversized gaussians (3DGS prunes both)
    pruned = (
        new_alive
        & (torch.sigmoid(fields["opacity_logit"]) > cfg.prune_opacity)
        & (torch.exp(log_scale).max(dim=-1).values < cfg.prune_scale)
    )
    obs = torch.any(grad_count > 0)
    if cfg.prune_zero_observed:
        # prune rows that stayed unobserved through two consecutive observed
        # windows (grad_count < 0 carries the previous window's mark); a
        # window with no observation at all gives no signal either way
        unobserved2 = alive & (grad_count < 0) & obs
        pruned = pruned & ~unobserved2
        fresh = torch.zeros_like(alive)
        fresh[slots] = ok
        unseen_now = pruned & ~fresh & (grad_count <= 0) & obs
        keep_mark = pruned & (grad_count < 0) & ~obs
        new_count = torch.where(unseen_now | keep_mark, UNSEEN_MARK, 0.0)
    else:
        new_count = torch.zeros_like(grad_count)
    return GaussianAvatar(**fields, alive=pruned), slots, ok, new_count


def zero_opt_rows(opt_state: dict, slots: torch.Tensor, ok: torch.Tensor,
                  capacity: int) -> dict:
    """Zero the Adam-moment rows of freshly written gaussian slots
    (`slots[ok]`) in place; counts pass through."""
    rows = slots[ok]
    for group in opt_state.values():
        for part in ("mu", "nu"):
            for k, t in group[part].items():
                if t.ndim >= 1 and t.shape[0] == capacity:
                    t[rows] = 0.0
    return opt_state


def reset_opacity_opt_state(opt_state: dict, g: GaussianAvatar) -> dict:
    """Fresh Adam state for the opacity group only (moment surgery, as CUDA
    3DGS `replace_tensor_to_optimizer` after `reset_opacity`)."""
    out = dict(opt_state)
    out["opac"] = adam_init({"opacity_logit": g.opacity_logit.detach()})
    return out


def probe_tile_spans(gaussians, faces, data: dict, width: int, height: int,
                     tile: int, n_probe: int = 4):
    """Visible per-gaussian tile-span sides over `n_probe` sampled frames
    (the exact criterion bin_gaussians clips on).  Returns
    (sides (n_frames * N,) numpy, n_frames)."""
    grid_w = (width + tile - 1) // tile
    grid_h = (height + tile - 1) // tile
    T = data["verts"].shape[0]
    probe_idx = np.unique(np.linspace(0, T - 1, min(n_probe, T)).astype(int))
    # the pipeline's `verts` cover every frame of the FLAME params, the
    # cameras only the train split: the reference's gather clamps an index
    # past the cameras to the last one, and so does this
    last_cam = data["w2c"].shape[0] - 1
    sides = []
    with torch.no_grad():
        for i in probe_idx:
            cam = _frame_camera(data, min(int(i), last_cam), width, height)
            means, rot, scales, opac, _ = bind_to_mesh(gaussians, data["verts"][i], faces)
            proj = project_gaussians(cam, means, rot, scales)
            uv, radius = proj["uv"], proj["radius"]
            visible = (
                proj["in_front"] & (radius > 0) & (opac > ALPHA_CUTOFF)
                & (uv[:, 0] + radius > 0) & (uv[:, 0] - radius < width)
                & (uv[:, 1] + radius > 0) & (uv[:, 1] - radius < height)
            )
            x0 = torch.clamp(torch.floor((uv[:, 0] - radius) / tile), 0, grid_w - 1)
            x1 = torch.clamp(torch.floor((uv[:, 0] + radius) / tile), 0, grid_w - 1)
            y0 = torch.clamp(torch.floor((uv[:, 1] - radius) / tile), 0, grid_h - 1)
            y1 = torch.clamp(torch.floor((uv[:, 1] + radius) / tile), 0, grid_h - 1)
            side = torch.maximum(x1 - x0, y1 - y0) + 1.0
            sides.append(torch.where(visible, side, 0.0).cpu().numpy())
    return np.concatenate(sides), len(probe_idx)


def size_binning_windows(sides: np.ndarray, n_frames: int, render_cfg: dict,
                         capacity: int, max_window: int,
                         allow_shrink: bool = False) -> dict:
    """Binning-window updates from probed spans (empty dict = no change).

    * max_tiles_per_gaussian = side^2 at the 99.8th percentile of visible
      spans, clipped to [current, max_window];
    * large_frac sized so the large-class budget covers 4x (2x when
      `allow_shrink`, the post-densification refit) the gaussians that
      outgrow the small window.
    With `allow_shrink` both may also shrink to what the probe says."""
    vis = sides[sides > 0]
    if vis.size == 0:
        return {}
    small_side = max(int(round(
        render_cfg.get("small_tiles_per_gaussian", 4) ** 0.5)), 1)
    side_needed = int(np.ceil(np.percentile(vis, 99.8)))
    max_side = int(round(max_window ** 0.5))
    cur_side = int(round(render_cfg["max_tiles_per_gaussian"] ** 0.5))
    lo_side = 4 if allow_shrink else cur_side     # never below a 4x4 window
    side = int(np.clip(side_needed, lo_side, max_side))
    n_large = int((vis > small_side).sum()) // max(n_frames, 1)
    margin = 2.0 if allow_shrink else 4.0
    frac_needed = min(margin * n_large / max(capacity, 1), 1.0)
    frac_needed = max(frac_needed, 0.02)
    updates = {}
    want_tiles = side * side
    if (want_tiles > render_cfg["max_tiles_per_gaussian"]
            or (allow_shrink
                and want_tiles < render_cfg["max_tiles_per_gaussian"])):
        updates["max_tiles_per_gaussian"] = want_tiles
    cur_frac = render_cfg.get("large_frac", 0.125)
    if frac_needed > cur_frac or (allow_shrink and frac_needed < cur_frac):
        updates["large_frac"] = frac_needed
    return updates


def _take(t: torch.Tensor, idx: list) -> torch.Tensor:
    """`t[idx]` for host ints, as a stack of views: indexing with a list
    would copy the index to the device and wait for it."""
    return torch.stack([t[i] for i in idx])


def _frame_camera(data: dict, i: int, width: int, height: int) -> Camera:
    return Camera(w2c=data["w2c"][i], fx=data["fx"][i], fy=data["fy"][i],
                  cx=data["cx"][i], cy=data["cy"][i], width=width, height=height)


def _map_capacity(state: TrainState, fn) -> TrainState:
    """Apply `fn` to every capacity-leading tensor of the state: gaussian
    fields, Adam moments and the densify accumulators (not FLAME)."""
    g = state.gaussians
    gaussians = GaussianAvatar(**{k: fn(getattr(g, k).detach())
                                  for k in FLOAT_FIELDS + ("parent_face", "alive")})
    opt_state = {grp: {"count": s["count"],
                       "mu": {k: fn(v) for k, v in s["mu"].items()},
                       "nu": {k: fn(v) for k, v in s["nu"].items()}}
                 for grp, s in state.opt_state.items()}
    return state._replace(gaussians=gaussians, opt_state=opt_state,
                          grad_accum=fn(state.grad_accum),
                          grad_count=fn(state.grad_count))


class AvatarTrainer:
    """Owns the training step, densification and the training loop."""

    MAX_TILE_WINDOW = 64
    WINDOW_CHECK_EVERY = 50
    WINDOW_CHECK_UNTIL = 500
    REFIT_MIN_REMAINING = 2000
    # compacted capacity rounds up to this multiple
    COMPACT_MULTIPLE = 1024
    # the reference's scan-chunk length: the window checks read the MAX of
    # window_clipped / window_spilled over such a run of steps
    CHUNK = 50

    def __init__(
        self,
        faces,
        cfg: TrainConfig,
        width: int,
        height: int,
        white_background: bool = True,
        tile: int = 16,
        max_per_tile: int = 512,
        max_tiles_per_gaussian: int = 16,
        flame_model=None,
        device: str | torch.device | None = None,
    ):
        """`flame_model` enables FLAME-parameter co-optimization
        (cfg.optimize_flame).  `device` defaults to the FLAME model's, else
        the CUDA card (as the reference runs on the default accelerator):
        with no card the trainer raises, and runs on the CPU only when the
        caller asks for it.  The composite takes the CUDA kernels on a CUDA
        device and the plain version on the CPU."""
        if device is None:
            device = flame_model.v_template.device if flame_model is not None else "cuda"
        self.device = resolve_device(device, "AvatarTrainer")
        self.flame_model = flame_model
        self.co_optimize = cfg.optimize_flame and flame_model is not None
        self.flame_lrs = ({"pose": _flame_lr(cfg, cfg.lr_flame_pose),
                           "expr": _flame_lr(cfg, cfg.lr_flame_expr)}
                          if self.co_optimize else None)
        self.faces = torch.tensor(np.asarray(faces), dtype=torch.int32,
                                  device=self.device)
        self.cfg = cfg
        self.width = width
        self.height = height
        self.bg = (torch.ones(3) if white_background else torch.zeros(3)).to(self.device)
        self.render_cfg = {
            "tile": tile,
            "max_per_tile": max_per_tile,
            "max_tiles_per_gaussian": max_tiles_per_gaussian,
            "small_tiles_per_gaussian": 4,
            "large_frac": 0.125,
            "two_class_min_n": 4096,
            "large_min": 1024,
        }
        self.lrs = gaussian_lrs(cfg)
        self._window_capped = False
        self._frac_capped = False
        self._refit_done = False
        self._flame_anchor = None
        self._ckpt_threads: list = []
        #: a `StageClock`; when set, every step laps flame, bind_colors,
        #: project, bin, composite, loss, backward and optimizer
        self.clock = None

    # ── state ────────────────────────────────────────────────
    def init_state(self, capacity: int | None = None, seed: int | None = None,
                   flame_params: dict | None = None,
                   points: np.ndarray | None = None,
                   canonical_verts: np.ndarray | None = None) -> TrainState:
        """`points` + `canonical_verts` switch to point-cloud init.
        `capacity=None` sizes 6x the initial cloud, rounded up to 16384,
        capped by cfg.max_gaussians."""
        if capacity is None:
            n_init = len(points) if points is not None else int(self.faces.shape[0])
            capacity = min(self.cfg.max_gaussians,
                           max(-(-6 * n_init // 16384) * 16384, 16384))
        faces = self.faces.cpu().numpy()
        if points is not None and canonical_verts is not None:
            from omfs4d_torch.models.gaussians import init_gaussians_from_points
            g = init_gaussians_from_points(points, canonical_verts, faces, capacity,
                                           sh_degree=self.cfg.sh_degree,
                                           device=self.device)
        else:
            g = init_gaussians_on_mesh(
                faces, capacity, seed=seed if seed is not None else self.cfg.seed,
                sh_degree=self.cfg.sh_degree, ref_verts=canonical_verts,
                device=self.device)
        if flame_params is not None:
            flame_params = {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                                ).to(self.device, torch.float32).clone()
                            for k, v in flame_params.items()}
        # anchor for the co-opt leash: a copy, taken once per run
        self._flame_anchor = (
            {k: v.clone() for k, v in flame_params.items()}
            if self.co_optimize and flame_params is not None else None)
        return TrainState(
            gaussians=g,
            opt_state=init_opt_state(g),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            grad_accum=torch.zeros(capacity, device=self.device),
            grad_count=torch.zeros(capacity, device=self.device),
            flame_params=flame_params,
            flame_opt_state=(init_flame_opt_state(flame_params)
                             if self.co_optimize and flame_params is not None
                             else None),
        )

    # ── one training step ────────────────────────────────────
    def train_step(self, state: TrainState, data: dict, idx) -> tuple[TrainState, dict]:
        """One step on frames `idx` (host ints) of `data` (device tensors).
        Returns (state, metrics of device tensors)."""
        cfg = self.cfg
        W, H = self.width, self.height
        bg = self.bg
        clock = self.clock
        idx = [int(i) for i in idx]
        if clock is not None:
            clock.start()
        g = state.gaussians
        params = float_fields(g)

        imgs = _take(data["images"], idx).to(torch.float32) / 255.0
        if "masks" in data:
            m = _take(data["masks"], idx).to(torch.float32)[..., None] / 255.0
            imgs = imgs * m + bg * (1.0 - m)

        probe = torch.zeros((g.capacity, 2), device=self.device, requires_grad=True)
        flame_leaves = {}
        if self.co_optimize:
            groups = flame_groups(state.flame_params)
            flame_leaves = {k: v.detach().requires_grad_()
                            for k, v in state.flame_params.items() if groups[k] != "frozen"}
            sliced = {k: (v if k in FLAME_FROZEN else _take(flame_leaves.get(k, v), idx))
                      for k, v in state.flame_params.items()}
            verts = flame_forward(self.flame_model, sliced)
            if clock is not None:
                clock.lap("flame")
        else:
            verts = _take(data["verts"], idx)

        losses, rendered, stats = [], [], []
        for b, i in enumerate(idx):
            cam = _frame_camera(data, i, W, H)
            img, st = _render_with_probe(g, probe, verts[b], self.faces, cam, W, H,
                                         bg, self.render_cfg, clock)
            gt = imgs[b]
            losses.append((1.0 - cfg.lambda_dssim) * l1_loss(img, gt)
                          + cfg.lambda_dssim * dssim_loss(img, gt))
            rendered.append(img)
            stats.append(st)
        loss = losses[0] if len(losses) == 1 else torch.stack(losses).mean()
        if clock is not None:
            clock.lap("loss")

        leaves = list(params.values()) + list(flame_leaves.values()) + [probe]
        grads = torch.autograd.grad(loss, leaves)
        n_p = len(params)
        g_params = dict(zip(params, grads[:n_p]))
        g_flame = dict(zip(flame_leaves, grads[n_p:-1]))
        probe_grad = grads[-1]
        if clock is not None:
            clock.lap("backward")

        for field, grp in PARAM_GROUPS.items():
            adam_update(state.opt_state[grp], {field: g_params[field]},
                        {field: params[field]}, self.lrs[grp])
        with torch.no_grad():
            q = g.quat_local
            q.copy_(q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12))

        if self.co_optimize:
            groups = flame_groups(state.flame_params)
            for grp, lr in self.flame_lrs.items():
                keys = [k for k in g_flame if groups[k] == grp]
                if keys:
                    adam_update(state.flame_opt_state[grp],
                                {k: g_flame[k] for k in keys},
                                {k: state.flame_params[k] for k in keys}, lr)
            beta = cfg.flame_anchor_decay
            if beta > 0.0 and self._flame_anchor is not None:
                # per-visit leash toward the tracked params: a frame's
                # gradient arrives in ~B/T of the steps
                T_frames = int(data["images"].shape[0])
                visits = max(cfg.batch_frames, 1) / max(T_frames, 1)
                beta = 1.0 - (1.0 - beta) ** visits
                with torch.no_grad():
                    for k, v in state.flame_params.items():
                        if k in self._flame_anchor:
                            a = self._flame_anchor[k]
                            v.copy_(a + (1.0 - beta) * (v - a))

        with torch.no_grad():
            # NDC units: d(loss)/d(uv_pixels) x (W/2), as CUDA 3DGS thresholds
            gnorm = torch.linalg.norm(probe_grad, dim=-1) * (max(W, H) * 0.5)
            state.grad_accum.add_(gnorm)
            state.grad_count.add_((gnorm > 0).to(torch.float32))
            state.step.add_(1)
            metrics = {
                "loss": loss.detach(),
                "psnr": psnr(torch.stack(rendered), imgs),
                "overflow": sum(s[0] for s in stats),
                "window_clipped": sum(s[1] for s in stats),
                "window_spilled": sum(s[2] for s in stats),
                "n_alive": g.alive.sum(),
            }
        if clock is not None:
            clock.lap("optimizer")
        return state, metrics

    # ── densify / prune ──────────────────────────────────────
    def densify_prune(self, state: TrainState, noise, max_new: int) -> TrainState:
        """One densify event.  Adam moments survive; only the freshly
        written slots get zeroed moments."""
        g2, slots, ok, new_count = densify_prune_arrays(
            state.gaussians, state.grad_accum, state.grad_count, noise,
            max_new, self.cfg)
        N = state.gaussians.capacity
        return state._replace(
            gaussians=g2,
            opt_state=zero_opt_rows(state.opt_state, slots, ok, N),
            grad_accum=torch.zeros(N, device=self.device),
            grad_count=new_count)

    def densify_noise(self, rng_seed: int, iteration: int, max_new: int) -> torch.Tensor:
        """The children's offset noise of the densify event at `iteration`:
        a generator seeded by (rng_seed, iteration), so a resumed run draws
        what the uninterrupted one drew without replaying the stream."""
        gen = torch.Generator().manual_seed(int(rng_seed) * 1_000_003 + int(iteration))
        return torch.randn((max_new, 3), generator=gen).to(self.device)

    def preflight_tile_window(self, state: TrainState, data: dict,
                              n_probe: int = 4) -> None:
        """Size the binning windows from the initial cloud, before the
        first step (the init cloud holds the run's largest gaussians)."""
        sides, n_frames = probe_tile_spans(
            state.gaussians, self.faces, data, self.width, self.height,
            self.render_cfg["tile"], n_probe)
        updates = size_binning_windows(
            sides, n_frames, self.render_cfg, int(state.gaussians.capacity),
            self.MAX_TILE_WINDOW)
        if updates:
            self.render_cfg.update(updates)
            log.info(f"preflight binning windows: max_tiles_per_gaussian="
                     f"{self.render_cfg['max_tiles_per_gaussian']} "
                     f"large_frac={self.render_cfg['large_frac']:.3f}")

    def refit_tile_window(self, state: TrainState, data: dict,
                          n_probe: int = 4) -> None:
        """Re-size the binning windows for the post-densification cloud
        (they may shrink); the runtime escalation stays live."""
        sides, n_frames = probe_tile_spans(
            state.gaussians, self.faces, data, self.width, self.height,
            self.render_cfg["tile"], n_probe)
        updates = size_binning_windows(
            sides, n_frames, self.render_cfg, int(state.gaussians.capacity),
            self.MAX_TILE_WINDOW, allow_shrink=True)
        if updates:
            self.render_cfg.update(updates)
            self._window_capped = False
            self._frac_capped = False
            log.info(f"post-densification window refit: max_tiles_per_gaussian="
                     f"{self.render_cfg['max_tiles_per_gaussian']} "
                     f"large_frac={self.render_cfg['large_frac']:.3f}")

    def grow_tile_window(self) -> bool:
        """Double max_tiles_per_gaussian (relieves `window_clipped`);
        False once at MAX_TILE_WINDOW."""
        cur = self.render_cfg["max_tiles_per_gaussian"]
        if cur >= self.MAX_TILE_WINDOW:
            log.warning(f"window_clipped pressure but max_tiles_per_gaussian "
                        f"already at cap {cur}: large gaussians are clipped")
            return False
        self.render_cfg["max_tiles_per_gaussian"] = cur * 2
        log.info(f"growing max_tiles_per_gaussian {cur} -> {cur * 2}")
        return True

    def grow_large_frac(self) -> bool:
        """Double the two-class binning's large-window budget (relieves
        `window_spilled`); False once at 1.0."""
        cur = self.render_cfg["large_frac"]
        if cur >= 1.0:
            return False
        self.render_cfg["large_frac"] = min(1.0, cur * 2)
        log.info(f"growing binning large_frac {cur} -> {self.render_cfg['large_frac']}")
        return True

    @staticmethod
    def resize_state_capacity(state: TrainState, new_capacity: int) -> TrainState:
        """Pad (grow) or slice (shrink) every capacity-leading tensor.  New
        rows are dead slots with zero moments and unit quaternions."""
        old = state.gaussians.capacity
        if new_capacity == old:
            return state

        def fix(t):
            if new_capacity < old:
                return t[:new_capacity].clone()
            pad = torch.zeros((new_capacity - old,) + t.shape[1:], dtype=t.dtype,
                              device=t.device)
            return torch.cat([t, pad])

        resized = _map_capacity(state, fix)
        if new_capacity > old:
            with torch.no_grad():
                resized.gaussians.quat_local[old:, 0] = 1.0
        return resized

    @staticmethod
    def compact_state(state: TrainState, new_capacity: int) -> TrainState:
        """Permute alive gaussians to the front (stable, so alive rows keep
        their order) and slice capacity down; every capacity-leading tensor
        moves under the same permutation."""
        if new_capacity >= state.gaussians.capacity:
            return state
        order = torch.argsort((~state.gaussians.alive).to(torch.int32),
                              stable=True)[:new_capacity]
        return _map_capacity(state, lambda t: t[order])

    def compact_to_alive(self, state: TrainState) -> TrainState:
        """Shrink capacity to ~cfg.compact_slack x the alive count, rounded
        up to COMPACT_MULTIPLE (at least one block)."""
        cap = state.gaussians.capacity
        alive = int(state.gaussians.alive.sum())
        m = self.COMPACT_MULTIPLE
        new_cap = max(int(np.ceil(alive * self.cfg.compact_slack / m) * m), m)
        if new_cap >= cap:
            return state
        log.info(f"post-densification compaction: capacity {cap} -> {new_cap} "
                 f"({alive} alive)")
        return self.compact_state(state, new_cap)

    def maybe_grow_capacity(self, state: TrainState) -> TrainState:
        """Double capacity (up to cfg.max_gaussians) when alive > 85% of it."""
        cap = state.gaussians.capacity
        if cap >= self.cfg.max_gaussians:
            return state
        alive = int(state.gaussians.alive.sum())
        if alive <= 0.85 * cap:
            return state
        new_cap = min(cap * 2, self.cfg.max_gaussians)
        log.info(f"growing gaussian capacity {cap} -> {new_cap} ({alive} alive)")
        return self.resize_state_capacity(state, new_cap)

    # ── rendering ────────────────────────────────────────────
    def render_frame(self, state_or_gaussians, verts, camera: Camera) -> torch.Tensor:
        g = getattr(state_or_gaussians, "gaussians", state_or_gaussians)
        verts = torch.as_tensor(verts, dtype=torch.float32).to(self.device)
        with torch.no_grad():
            probe = torch.zeros((g.capacity, 2), device=self.device)
            img, _ = _render_with_probe(g, probe, verts, self.faces, camera,
                                        self.width, self.height, self.bg,
                                        self.render_cfg)
        return img

    # ── opacity reset ────────────────────────────────────────
    def reset_opacity(self, state: TrainState) -> TrainState:
        """Cap opacity at 0.01 and reset only the opacity group's moments."""
        with torch.no_grad():
            state.gaussians.opacity_logit.clamp_(max=inverse_sigmoid(0.01))
        return state._replace(
            opt_state=reset_opacity_opt_state(state.opt_state, state.gaussians))

    # ── full loop ────────────────────────────────────────────
    def train(
        self,
        data: dict,
        iterations: int | None = None,
        state: TrainState | None = None,
        output_dir: str | Path | None = None,
        events=None,
        log_every: int = 100,
        rng_seed: int = 0,
        start_iteration: int = 0,
    ) -> TrainState:
        """data: images (T,H,W,3) uint8, verts (T,V,3) f32, w2c (T,4,4),
        fx/fy/cx/cy (T,), masks (T,H,W) uint8 optional; arrays or tensors.

        `start_iteration` resumes a restored state: the loop runs
        (start, iterations], and the host frame-sampling stream is replayed
        past the completed iterations, so a kill-and-resume run draws what
        an uninterrupted one draws.  `events` is any object with
        `emit(name, **fields)`; with none given an `EventLogger()` takes the
        `train_step` records."""
        cfg = self.cfg
        iterations = iterations or cfg.iterations
        events = events or EventLogger()
        # host data moves to the trainer's device; data or a state already on
        # another device is refused, never moved off it
        on = {f"data[{k!r}]": v.device for k, v in data.items()
              if torch.is_tensor(v) and v.device.type != "cpu"}
        if state is not None:
            on["state"] = state.gaussians.mu_local.device
        for name, dev in on.items():
            if dev != self.device:
                raise ValueError(f"AvatarTrainer.train: {name} is on {dev}, the "
                                 f"trainer on {self.device}; pass device= to match")
        state = state or self.init_state()
        rng = np.random.default_rng(rng_seed)

        T = data["images"].shape[0]
        B = cfg.batch_frames
        data = {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                    ).to(self.device) for k, v in data.items()}
        if start_iteration == 0:
            self.preflight_tile_window(state, data)

        save_iters = sorted({max(iterations // 4, 1), max(iterations // 2, 1),
                             iterations})
        densify_until = densify_until_iter(cfg, iterations)

        for _ in range(1, start_iteration + 1):
            rng.integers(0, T, size=(B,))

        it = start_iteration
        while it < iterations:
            window_live = not (self._window_capped and self._frac_capped)
            cands = [iterations]
            if log_every:
                cands.append((it // log_every + 1) * log_every)
            if window_live and it < self.WINDOW_CHECK_UNTIL:
                cands.append((it // self.WINDOW_CHECK_EVERY + 1) * self.WINDOW_CHECK_EVERY)
            if cfg.densify_interval > 0 and it < densify_until:
                cands.append((it // cfg.densify_interval + 1) * cfg.densify_interval)
            if cfg.opacity_reset_interval > 0 and it < densify_until:
                cands.append((it // cfg.opacity_reset_interval + 1)
                             * cfg.opacity_reset_interval)
            cands.extend(s for s in save_iters if s > it)
            target = min(c for c in cands if c > it)
            # warm-up runs step by step so the window checks react at once
            if window_live and it < self.WINDOW_CHECK_EVERY:
                target = it + 1

            metrics = None
            while it < target:
                # the reference runs CHUNK-step scans where they fit and reads
                # the chunk's max window pressure; single steps read their own
                n = self.CHUNK if target - it >= self.CHUNK else 1
                peak = None
                for _ in range(n):
                    state, metrics = self.train_step(state, data,
                                                     rng.integers(0, T, size=(B,)))
                    if n > 1:
                        cur = (metrics["window_clipped"], metrics["window_spilled"])
                        peak = cur if peak is None else tuple(
                            torch.maximum(a, b) for a, b in zip(peak, cur))
                if peak is not None:
                    metrics = dict(metrics, window_clipped=peak[0], window_spilled=peak[1])
                it += n

            if window_live and (it <= self.WINDOW_CHECK_UNTIL
                                or it % log_every == 0 or it == iterations):
                clipped = float(metrics["window_clipped"])
                spilled = float(metrics["window_spilled"])
                alive = float(metrics["n_alive"])
                if spilled / max(alive, 1.0) > 0.02 and not self._frac_capped:
                    if not self.grow_large_frac():
                        self._frac_capped = True
                if clipped / max(alive, 1.0) > 0.02 and not self._window_capped:
                    if not self.grow_tile_window():
                        self._window_capped = True

            if it % log_every == 0 or it == iterations:
                m = {k: float(v) for k, v in metrics.items()}
                log.info(f"iter {it}/{iterations} loss={m['loss']:.4f} "
                         f"psnr={m['psnr']:.2f} alive={int(m['n_alive'])}")
                import resource
                m["rss_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
                m["capacity"] = int(state.gaussians.capacity)
                m["ckpt_threads"] = sum(t.is_alive() for t in self._ckpt_threads)
                events.emit("train_step", iter=it, **m)

            if (cfg.densify_interval > 0
                    and cfg.densify_from <= it <= densify_until
                    and it % cfg.densify_interval == 0):
                state = self.maybe_grow_capacity(state)
                max_new = max(state.gaussians.capacity // 16, 1)
                state = self.densify_prune(
                    state, self.densify_noise(rng_seed, it, max_new), max_new)

            if (cfg.densify_interval > 0 and it >= densify_until
                    and iterations - it >= self.REFIT_MIN_REMAINING
                    and not self._refit_done):
                self._refit_done = True
                if cfg.compact_at_refit:
                    state = self.compact_to_alive(state)
                self.refit_tile_window(state, data)

            if (cfg.opacity_reset_interval > 0 and it % cfg.opacity_reset_interval == 0
                    and it < densify_until):
                state = self.reset_opacity(state)

            if output_dir is not None and it in save_iters:
                self.save_checkpoint(state, output_dir, it, block=(it == iterations))

        self._join_checkpoint_threads()
        return state

    # ── checkpoints ──────────────────────────────────────────
    def _join_checkpoint_threads(self):
        for t in self._ckpt_threads:
            t.join()
        self._ckpt_threads = []

    def checkpoint_meta(self, state: TrainState, iteration: int) -> dict:
        """The `iter_XXXXXXX_meta.json` record, with the reference's keys."""
        return {
            "iteration": iteration,
            "capacity": int(state.gaussians.capacity),
            "max_tiles_per_gaussian": self.render_cfg["max_tiles_per_gaussian"],
            "large_frac": self.render_cfg["large_frac"],
            # renders composite with the per-tile capacity the loss saw
            "max_per_tile": self.render_cfg["max_per_tile"],
        }

    def save_checkpoint(self, state: TrainState, output_dir: str | Path,
                        iteration: int, block: bool = True):
        """Write `checkpoints/iter_XXXXXXX/` (the state), its meta JSON and
        the `point_cloud/iteration_N` PLY.  `block=False` snapshots the
        state on the device and does the copy to the host and the writes on
        a thread; `train()` joins it before returning."""
        from omfs4d_torch.train.checkpoints import (export_point_cloud,
                                                    save_state, snapshot_state)

        out = Path(output_dir)
        meta = self.checkpoint_meta(state, iteration)
        # a thread needs a copy: the next step updates the state in place
        snap = state if block else snapshot_state(state)

        def write():
            path = save_state(out / "checkpoints" / f"iter_{iteration:07d}", snap)
            (path.parent / f"iter_{iteration:07d}_meta.json").write_text(json.dumps(meta))
            export_point_cloud(out / "point_cloud" / f"iteration_{iteration}"
                               / "point_cloud.ply", snap.gaussians)
            log.info(f"checkpoint saved at iteration {iteration}")

        if block:
            self._join_checkpoint_threads()
            write()
        else:
            t = threading.Thread(target=write, daemon=True)
            t.start()
            self._ckpt_threads.append(t)

    def restore_checkpoint(self, output_dir: str | Path,
                           template: TrainState) -> tuple[TrainState, int]:
        """Restore the newest checkpoint under output_dir onto the trainer's
        device.  Returns (state, iteration); raises FileNotFoundError when
        there is none.  The saved render windows are adopted exactly."""
        from omfs4d_torch.train.checkpoints import latest_checkpoint, restore_state

        found = latest_checkpoint(output_dir)
        if found is None:
            raise FileNotFoundError(f"no checkpoints/iter_* under {output_dir}")
        path, it = found
        meta_file = path.parent / f"{path.name}_meta.json"
        meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
        state = restore_state(path, device=self.device)
        if template.flame_params is not None and state.flame_params is None:
            raise ValueError("checkpoint holds no FLAME params but the template does")
        if meta:
            self.render_cfg["max_tiles_per_gaussian"] = min(
                int(meta.get("max_tiles_per_gaussian",
                             self.render_cfg["max_tiles_per_gaussian"])),
                self.MAX_TILE_WINDOW)
            self.render_cfg["large_frac"] = min(float(meta.get(
                "large_frac", self.render_cfg["large_frac"])), 1.0)
        log.info(f"resumed from checkpoint iter {it} ({path})")
        return state, it
