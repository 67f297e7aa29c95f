"""Post-surgical prediction rendering: modified params -> frames -> MP4.

Port of `omfs4d.predict.render_video`:

  * picks the highest `point_cloud/iteration_*` unless pinned;
  * clears stale renders, writes `train/ours_N/renders/*.png` (+ gt/);
  * optional deterministic frame export; stitches H.264/MP4 with ffmpeg
    when there is an ffmpeg binary, else the PNG frames are the product and
    the result says why there is no video.

Runs eagerly on the device of the FLAME model: one batched FLAME forward
for all frames, then one frame at a time through bind -> colours ->
project -> bin -> composite.
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path

import numpy as np
import torch

from omfs4d_torch.core.logging import get_logger
from omfs4d_torch.io.dataset import FrameDataset
from omfs4d_torch.io.video import NoFFmpegError, stitch_video, write_image
from omfs4d_torch.models.flame import FlameModel, flame_forward
from omfs4d_torch.predict.surgery import (
    choose_rig_mode,
    compute_offset,
    create_modified_dataset,
    export_deterministic_frames,
    load_deformation_map,
)
from omfs4d_torch.render.rasterize import render_avatar_frame
from omfs4d_torch.train.checkpoints import (
    latest_iteration,
    load_point_cloud,
    trained_render_meta,
)

log = get_logger("render_surgery")

COUNTERS = ("overflow", "window_clipped", "spilled")


def batched_frame_params(ds: FrameDataset) -> dict:
    """The FLAME params of every frame of a split, stacked for one batched
    forward (shape and static_offset from frame 0, dynamic_offset left
    out), as numpy arrays."""
    per_frame = [ds.load_frame_params(i) for i in range(len(ds))]
    return {k: (per_frame[0][k] if k in ("shape", "static_offset")
                else np.concatenate([np.atleast_2d(p[k]) for p in per_frame]))
            for k in per_frame[0] if k != "dynamic_offset"}


def render_dataset_frames(
    flame_model: FlameModel,
    gaussians,
    data_dir: str | Path,
    out_renders: str | Path,
    out_gt: str | Path | None = None,
    split: str = "train",
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 16,
    white_background: bool = True,
    n_tile: int = 1,
    large_frac: float = 1.0,
    clock=None,
) -> Path:
    """Render every frame of a dataset split with the given avatar, on the
    device that holds `flame_model` (and `gaussians`).

    `max_tiles_per_gaussian` must cover the window the trainer ended on.
    `large_frac` defaults to 1.0, unlike training: a loaded point cloud is
    all alive, and a fractional large-class budget would push most
    gaussians through the clipped small window.

    `clock`, a `omfs4d_torch.core.timing.StageClock`, collects per-stage
    times (flame, bind_colors, project, bin, composite on the device; png
    on the host, after the frame's copy to the host) and the per-frame
    binning counters.  Tile-sharded rendering (`n_tile` > 1) belongs to the
    parallel slice and raises NotImplementedError.
    """
    if n_tile > 1:
        raise NotImplementedError("tile-sharded rendering (n_tile > 1) is not ported yet")
    device = flame_model.v_template.device
    bg_value = 1.0 if white_background else 0.0
    ds = FrameDataset(data_dir, split=split)
    out_renders = Path(out_renders)
    out_renders.mkdir(parents=True, exist_ok=True)
    if out_gt is not None:
        Path(out_gt).mkdir(parents=True, exist_ok=True)
    T = len(ds)
    if T == 0:
        return out_renders

    batched = batched_frame_params(ds)
    cam0 = ds.camera(0)
    W, H = cam0.width, cam0.height
    bg = torch.full((3,), bg_value, dtype=torch.float32, device=device)

    def drain(i, img):
        host = img.cpu().numpy()              # waits for this frame's device work
        t0 = time.perf_counter()
        name = Path(ds.frame_meta(i)["file_path"]).name
        write_image(out_renders / name, host)
        if out_gt is not None:
            # GT composited over the configured background, as the trainer
            # composites its targets
            gt = ds.load_image(i).astype(np.float32) / 255.0
            m = ds.load_mask(i)
            if m is not None:
                gt = gt * m[..., None] + bg_value * (1.0 - m[..., None])
            write_image(Path(out_gt) / name, gt)
        if clock is not None:
            clock.add_host_ms("png", (time.perf_counter() - t0) * 1e3)

    # a small window of frames in flight: the device renders frame i+1 while
    # the host encodes frame i
    window = 4
    pending: list[tuple[int, torch.Tensor]] = []
    with torch.inference_mode():
        if clock is not None:
            clock.start()
        verts_all = flame_forward(flame_model, batched)
        if clock is not None:
            clock.lap("flame")
        for i in range(T):
            cam = ds.camera(i, device=device)
            if clock is not None:
                clock.start()
            img, aux = render_avatar_frame(
                gaussians, verts_all[i], flame_model.faces, cam, W, H,
                background=bg, max_per_tile=max_per_tile,
                max_tiles_per_gaussian=max_tiles_per_gaussian,
                large_frac=large_frac, clock=clock)
            if clock is not None:
                clock.add_counters({k: aux[k] for k in COUNTERS})
            pending.append((i, img))
            if len(pending) >= window:
                drain(*pending.pop(0))
        for entry in pending:
            drain(*entry)
    return out_renders


def render_prediction(
    model_dir: str | Path,
    data_dir: str | Path,
    flame_model: FlameModel,
    output: str | Path = "final_prediction.mp4",
    lefort_mm: float = 0.0,
    bsso_mm: float = 0.0,
    sensitivity: float = 1.0,
    fps: int = 30,
    iteration: int = -1,
    rig_mode: str = "flame_only",
    canonical_head_asset: str = "",
    deformation_map: str = "",
    export_frames_dir: str = "",
    deterministic_indices: str = "",
    deterministic_max_frames: int = 24,
    keep_modified_dataset: bool = False,
    white_background: bool = True,
    n_tile: int = 1,
    max_per_tile: int = 512,
    device: str | torch.device = "cuda",
) -> dict:
    """Full prediction pipeline on `device`: offsets -> modified dataset ->
    render -> MP4.  `flame_model` is moved to `device` in place.  It runs on
    the CUDA card unless the caller asks for the CPU, and raises when there
    is no card.

    With no ffmpeg binary the rendered PNG frames are the product: the result
    has `"video": None` and the reason under `"video_error"`.  An ffmpeg that
    is found and fails raises."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_prediction: no CUDA device; pass device='cpu' to "
                           "render on the CPU")
    flame_model = flame_model.to(device)
    lefort_offset = compute_offset(lefort_mm, sensitivity)
    bsso_offset = compute_offset(bsso_mm, sensitivity)
    effective_mode, mode_reason = choose_rig_mode(rig_mode, canonical_head_asset)
    deform = load_deformation_map(
        deformation_map if effective_mode == "hybrid_full_head" else None
    )
    log.info(f"Le Fort: {lefort_mm} mm -> offset {lefort_offset:.6f}")
    log.info(f"BSSO:    {bsso_mm} mm -> offset {bsso_offset:.6f}")
    log.info(f"Rig mode: {effective_mode} ({mode_reason})")

    model_dir = Path(model_dir)
    it = iteration if iteration > 0 else latest_iteration(model_dir)
    if it is None:
        raise FileNotFoundError(f"No point_cloud/iteration_* in {model_dir}")
    pc_path = model_dir / "point_cloud" / f"iteration_{it}" / "point_cloud.ply"
    gaussians = load_point_cloud(pc_path, device=device)
    log.info(f"Using iteration: {it} ({int(gaussians.alive.sum())} gaussians)")

    # render with (at least) the tile window and the per-tile capacity the
    # trainer used (checkpoints/iter_*_meta.json)
    meta = trained_render_meta(model_dir, it)
    window = max(16, int(meta.get("max_tiles_per_gaussian", 0)) or 16)
    if window > 16:
        log.info(f"render window: max_tiles_per_gaussian={window} "
                 f"(from training meta)")
    if meta.get("max_per_tile"):
        max_per_tile = int(meta["max_per_tile"])
        log.info(f"render per-tile capacity: max_per_tile={max_per_tile} "
                 f"(from training meta)")

    # clear stale renders
    train_dir = model_dir / "train"
    if train_dir.is_dir():
        for d in train_dir.iterdir():
            renders = d / "renders"
            if renders.is_dir():
                shutil.rmtree(renders)

    refined = model_dir / "flame_param_refined.npz"
    if refined.exists():
        log.info("using co-optimized FLAME params from training")
    modified = create_modified_dataset(
        str(data_dir), lefort_offset, bsso_offset, deformation_map=deform,
        refined_params=str(refined) if refined.exists() else None)
    try:
        renders_dir = train_dir / f"ours_{it}" / "renders"
        gt_dir = train_dir / f"ours_{it}" / "gt"
        render_dataset_frames(
            flame_model, gaussians, modified, renders_dir, out_gt=gt_dir,
            split="train", white_background=white_background,
            max_tiles_per_gaussian=window, n_tile=n_tile,
            max_per_tile=max_per_tile,
        )

        if export_frames_dir:
            export_deterministic_frames(
                str(renders_dir), export_frames_dir,
                index_file=deterministic_indices or None,
                max_frames=deterministic_max_frames,
            )

        video, video_error = None, None
        try:
            video = str(stitch_video(renders_dir, output, fps=fps))
            log.info(f"Video saved to {video}")
        except NoFFmpegError as e:
            video_error = str(e)
            log.warning(f"no video, the prediction is the PNG frames: {video_error}")
        return {
            "video": video,
            "video_error": video_error,
            "renders_dir": str(renders_dir),
            "iteration": it,
            "rig_mode": effective_mode,
            "lefort_offset": lefort_offset,
            "bsso_offset": bsso_offset,
        }
    finally:
        if not keep_modified_dataset:
            shutil.rmtree(modified, ignore_errors=True)
