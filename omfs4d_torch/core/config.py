"""Typed configuration tree for the whole framework (PyTorch port).

Field names and defaults are those of `omfs4d.core.config`, so a config
file written for either package loads in the other.  One dataclass tree
with dotted-key overrides, e.g. ``train.iterations=30000``.

`RenderConfig.use_pallas` is kept for config-file compatibility only: the
port picks its composite by the tensor's device alone (the CUDA kernel for
a CUDA tensor, the plain PyTorch version for a CPU tensor).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ClinicalConfig:
    """CT/CBCT ingest + osteotomy defaults (ref: dicom_loader.py:109-168)."""

    hu_threshold: float = 300.0        # bone HU (300 cancellous / 700 cortical)
    smooth_iterations: int = 30
    decimate_fraction: float = 0.5     # fraction of triangles to KEEP
    label_upper: tuple = ()            # empty -> default ToothFairy3 upper set
    label_lower: tuple = ()


@dataclass
class TrackConfig:
    """Staged FLAME tracking (ref schedule: app.py:1279-1293)."""

    n_shape: int = 300
    n_expr: int = 100
    landmark_source: str = "synthetic"   # auto | file | neural | synthetic | plugin
    # self-trained neural detector budget (track/detector.py)
    detector_steps: int = 1500
    detector_size: int = 96
    # Per-stage step counts, mirroring the reference's VHAP tuning surface
    # (run_full_pipeline_conda.ps1:191-215).
    steps_lmk_init_rigid: int = 300
    steps_lmk_init_all: int = 300
    steps_rgb_init_texture: int = 150
    steps_rgb_init_all: int = 150
    steps_rgb_init_offset: int = 100     # static per-vertex offset stage
    steps_rgb_sequential: int = 30       # per-frame (warm-start scan over T)
    steps_global: int = 240              # batched steps per global epoch
    epochs_global: int = 2
    # photometric stages at 1/d resolution (ref --data.n-downsample-rgb,
    # preprocess_video.py:169; -Downsample, run_full_pipeline_conda.ps1).
    # The pipeline auto-picks 2 for >=384px frames when left at 1.
    rgb_downsample: int = 1
    lr: float = 1e-2
    photometric: bool = True
    photometric_backend: str = "splat"   # splat (gaussian) | mesh (halfplane)
    # appearance model for the rgb stages (VHAP's rgb_init_texture optimizes
    # a UV atlas, ref app.py:1283-1292): "uv" = (texture_res^2, 3) atlas
    # sampled bilinearly (deferred texturing on the mesh backend, per-splat
    # face-center samples on the splat backend); "flat" = legacy per-face /
    # per-vertex colors
    texture_mode: str = "uv"
    texture_res: int = 128
    use_static_offset: bool = True
    # refine camera focal length during the landmark stages, frozen for the
    # photometric stages (VHAP's camera refinement; the reference exposes
    # -InitialFocal as a guess, run_full_pipeline_conda.ps1:179-182)
    optimize_focal: bool = True
    temporal_smoothness: float = 1e-3
    reg_shape: float = 1e-3
    reg_expr: float = 1e-4
    reg_jaw: float = 1e-3
    # optional LATE per-frame vertex refinement into the contract's
    # dynamic_offset field (ref preprocess_video.py:311-341): heavily
    # regularized + temporally smoothed so it only absorbs the residual
    # pose/expression cannot explain
    use_dynamic_offset: bool = False
    steps_rgb_dynamic_offset: int = 100
    reg_dynamic: float = 1.0


@dataclass
class RenderConfig:
    """Differentiable gaussian rasterizer settings."""

    tile: int = 16                 # pixel tile edge (screen-space binning)
    max_per_tile: int = 256        # capped per-tile gaussian list (fixed shape;
    #   depth-sorted, so the cap keeps the NEAREST K — the early-termination
    #   analogue.  Train and render must use the same K (checkpoint meta)
    max_tiles_per_gaussian: int = 16
    white_background: bool = True
    use_pallas: str = "auto"       # read by the JAX package only


@dataclass
class TrainConfig:
    """3DGS avatar training (ref flags: train_ghost.py:227-243)."""

    iterations: int = 5000
    resolution: int = -1
    lr_position: float = 5e-4
    # exponential position-LR decay to lr_position*final_scale over
    # `iterations` — CUDA 3DGS decays position_lr 1.6e-4 -> 1.6e-6 over its
    # 30k schedule; a constant position LR measured fine at 5k iters but
    # churns the cloud at 30k (late splits from jitter gradients, psnr
    # falling after densification ends).  1.0 = constant (legacy).
    lr_position_final_scale: float = 0.01
    lr_rotation: float = 1e-3
    lr_scale: float = 5e-3
    lr_opacity: float = 5e-2
    lr_color: float = 2.5e-3
    lambda_dssim: float = 0.2
    densify_from: int = 500
    densify_until_frac: float = 0.5
    # 300 measured best end-to-end (26.6 dB selfrecon @256): CUDA's 100-iter
    # cadence churns the cloud faster than it re-converges here, costing
    # ~4.5 dB despite growing 3x more gaussians
    densify_interval: int = 300
    densify_grad_threshold: float = 2e-4
    # CUDA 3DGS resets opacity every 3000 iters to kill floaters; under
    # THIS renderer's depth-sorted per-tile K cap the reset is measurably
    # destructive at scale: a 30k 512^2 run climbed to 30.4 dB by iter 3000
    # (densification active and healthy), then every reset ratcheted
    # quality down (28.6 / 26.1 / 18.9 / 16.4 dB after the 3k/6k/9k/12k
    # resets) while post-reset gradient chaos drove the densifier to
    # balloon the cloud 9.6k -> 56k.  The zero-observation prune +
    # opacity/scale prunes already do the floater cleanup here, so resets
    # default OFF; set an interval to restore the CUDA cadence.
    opacity_reset_interval: int = 0
    prune_opacity: float = 5e-3
    prune_scale: float = 8.0        # prune gaussians larger than this (in triangle units)
    # prune gaussians that received ZERO gradient over a whole densify
    # window: under the depth-sorted per-tile K cap (the TPU analogue of
    # CUDA's per-pixel early termination) such gaussians can never recover
    # — no gradient can shrink/fade them — while still inflating the
    # binning pair budget and crowding supervised gaussians out of the
    # K-nearest lists
    prune_zero_observed: bool = True
    max_gaussians: int = 200_000
    batch_frames: int = 1           # frames per step (data-parallel axis)
    # co-optimize tracked FLAME pose/expression during avatar training —
    # GaussianAvatars' default behavior; absorbs residual per-frame
    # tracking error that otherwise caps reconstruction PSNR
    optimize_flame: bool = True
    # (GaussianAvatars uses 1e-5/1e-3-scale over 600k iters; at the 5k-iter
    # budgets here each frame is only visited ~100x, so the rates are
    # scaled up to let co-optimization actually absorb 0.05-rad-scale
    # residual tracker error — measured on the 512^2 e2e case)
    # peaks swept on the 512^2 e2e case (5k iters): 1e-4/3e-4 -> 25.0 dB,
    # 3e-4/1e-3 -> 26.6 dB, 1e-3/3e-3 -> 26.4 dB selfrecon
    lr_flame_pose: float = 3e-4
    lr_flame_expr: float = 1e-3
    # warmup-cosine schedule around those peaks: ramp over lr_flame_warmup
    # steps (gaussians settle first), decay to peak*lr_flame_final_scale by
    # `iterations` (late refinement must not churn the pose the gaussians
    # were fit against).  warmup=0 disables the schedule (constant LR).
    lr_flame_warmup: int = 300
    lr_flame_final_scale: float = 0.03
    # ABSOLUTE horizon (in iterations) over which the position exponential
    # decay and the FLAME cosine decay run; past it both hold their floor.
    # Without this, the schedules stretched with `iterations`, so a 30k run
    # held position/FLAME LRs near peak ~6x longer than the 5k runs the
    # peaks were swept on — measured on the first 30k 512^2 e2e: per-step
    # PSNR degraded monotonically while the schedules were hot (28 -> 18 dB
    # median by iter 14k) and a 20k-iteration 256^2 run diverged outright in
    # its first 800 iterations (loss 0.07 -> 0.14, then the scale prune
    # collapsed the cloud to 0 alive).  5000 = the validated operating
    # point (33.5 dB selfrecon, E2E_BF16_512.json); 0 = legacy
    # stretch-with-iterations behavior.
    lr_decay_horizon: int = 5000
    # Per-step pull of the co-optimized FLAME params toward their tracked
    # initialization: p <- anchor + (1-beta)(p - anchor).  Near a perfect
    # fit the data gradient is ~zero and Adam turns gradient NOISE into
    # full-LR random-walk steps — a walk in global translation/rotation
    # misaligns the whole head, every splat fades (opacity is the cheapest
    # way to explain misaligned pixels), and the scene death-spirals
    # (measured: GT-param 256^2 runs collapse to 0 alive within ~700 iters;
    # position-LR-only ablation is healthy, FLAME-LR-only reproduces).
    # The anchor bounds the walk at ~lr/sqrt(2*beta) while leaving
    # equilibrium room ~lr/beta for CONSISTENT corrections (0.1 rad at
    # the pose peak — 2x the tracker's residual-error scale).  0 disables.
    flame_anchor_decay: float = 3e-3
    seed: int = 0
    sh_degree: int = 3              # SH rest degree (GA default 3, ref train_ghost.py:227-243)
    # once densification ends the alive count is frozen, but capacity is
    # wherever doubling growth left it (often ~2x alive) — and EVERY
    # per-gaussian op (projection, binding, SH eval, Adam, binning pair
    # expansion, gradient scatter) is sized by capacity, not alive.
    # Compacting the state to alive*compact_slack at the refit boundary
    # (one recompile) cuts that dead-padding tax for the entire
    # refinement phase.
    compact_at_refit: bool = True
    compact_slack: float = 1.125    # capacity headroom over alive post-compact


@dataclass
class PredictConfig:
    """Surgical mm -> FLAME mapping (ref: render_surgery.py:35-141)."""

    sensitivity: float = 1.0
    scale_factor: float = 0.001     # mm -> FLAME units  (SCALE_FACTOR)
    fps: int = 30
    rig_mode: str = "flame_only"    # flame_only | hybrid_full_head
    deterministic_max_frames: int = 24


@dataclass
class ParallelConfig:
    """Device mesh layout: data shards frames, tile shards the screen grid,
    gauss shards the gaussian axis (see omfs4d.parallel)."""

    n_data: int = -1               # -1 = all remaining devices
    n_tile: int = 1
    n_gauss: int = 1


@dataclass
class PipelineConfig:
    target_size: int = 512
    max_frames: int = 0            # 0 = all
    train_fraction: float = 0.9    # 90/10 split (preprocess_video.py:403-406)
    min_train_frames: int = 50     # quality gate (train_ghost.py:110)
    # fg-mask matting for the dataset contract (ref --matting_method,
    # preprocess_video.py:132): none | border_color | median_background |
    # neural (self-trained, track/segnet.py)
    matting: str = "border_color"
    matting_train_steps: int = 800   # neural matting self-training budget


@dataclass
class Config:
    clinical: ClinicalConfig = field(default_factory=ClinicalConfig)
    track: TrackConfig = field(default_factory=TrackConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    predict: PredictConfig = field(default_factory=PredictConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        return tuple(json.loads(value)) if value.startswith("[") else tuple(
            type(current[0])(v) if current else v for v in value.split(",") if v
        )
    return value


def apply_override(cfg: Config, dotted_key: str, value: str) -> None:
    """Apply one `a.b.c=value` override in place."""
    parts = dotted_key.split(".")
    obj: Any = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"unknown config group: {dotted_key!r}")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"unknown config key: {dotted_key!r}")
    setattr(obj, leaf, _coerce(value, getattr(obj, leaf)))


def config_from_args(args: list[str]) -> tuple[Config, list[str]]:
    """Split ``key=value`` overrides out of an argv list; return (cfg, rest)."""
    cfg = Config()
    rest = []
    for a in args:
        if "=" in a and not a.startswith("-"):
            k, v = a.split("=", 1)
            apply_override(cfg, k, v)
        else:
            rest.append(a)
    return cfg, rest
