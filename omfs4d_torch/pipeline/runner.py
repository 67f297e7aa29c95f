"""Pipeline runner: capture -> frames -> tracked dataset, in PyTorch.

Port of `omfs4d.pipeline.runner`: one Python process in which stages pass
arrays, cache by content hash (`ArtifactStore`) and emit JSONL progress
events.  Ported stages: `preprocess` (a capture to numbered frames) and
`track` (landmarks -> preflight and fallbacks -> matting -> FLAME tracking ->
the contract dataset).  `train`, `render_surgery` and `report` are not ported
yet and raise.

The pipeline runs on one device: `device=None` takes the CUDA card and raises
when there is none.  Sharding frames over devices (`parallel.n_data > 1`) is
not ported.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from omfs4d_torch.core.artifacts import ArtifactStore
from omfs4d_torch.core.config import Config
from omfs4d_torch.core.device import resolve_device
from omfs4d_torch.core.logging import EventLogger, get_logger, stage_timer
from omfs4d_torch.io.dataset import write_dataset
from omfs4d_torch.io.video import extract_frames, probe_video, read_image
from omfs4d_torch.models.assets import load_flame_asset, synthetic_flame_asset
from omfs4d_torch.models.flame import FlameModel, flame_forward
from omfs4d_torch.track.fitter import FlameTracker
from omfs4d_torch.track.landmarks import detect_landmarks

log = get_logger("pipeline")

_NOT_PORTED = ("Pipeline.{}: this stage is not ported yet (ROADMAP.md queue 1 item 7: the "
               "runner's train / render_surgery / report stages and the CLI); call "
               "omfs4d_torch.train.trainer.AvatarTrainer or "
               "omfs4d_torch.predict.render_video.render_prediction directly")


class Pipeline:
    def __init__(self, cfg: Config, workdir: str | Path,
                 flame_asset: str | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device, "Pipeline")
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.store = ArtifactStore(self.workdir / "stages")
        self.events = EventLogger(self.workdir / "events.jsonl")
        if flame_asset:
            asset = load_flame_asset(flame_asset)
        else:
            asset = synthetic_flame_asset()
        self.model = FlameModel.from_asset(asset, device=self.device)

    # ── stage 1: capture -> frames ───────────────────────────
    def preprocess(self, video_path: str | Path, force: bool = False) -> Path:
        cfg = self.cfg.pipeline

        def run(out: Path):
            with stage_timer("preprocess", self.events):
                info = probe_video(video_path)
                paths = extract_frames(
                    video_path, out / "images",
                    target_size=cfg.target_size,
                    max_frames=cfg.max_frames,
                )
                return {"n_frames": len(paths), **info}

        return self.store.run(
            "preprocess", {"video": str(video_path)},
            {"target_size": cfg.target_size, "max_frames": cfg.max_frames},
            run, force=force,
        )

    # ── stage 2+3: landmarks + FLAME tracking -> dataset ────
    def track(self, frames_dir: Path, camera, landmark_method: str = "file",
              landmark_kwargs: dict | None = None, force: bool = False) -> Path:
        cfg = self.cfg
        if cfg.parallel.n_data > 1:
            raise NotImplementedError(
                "Pipeline.track: parallel.n_data > 1 (sharding the frame axis over devices) "
                "waits for the port's parallel slice (ROADMAP.md queue 1 item 9)")

        def run(out: Path):
            with stage_timer("track", self.events):
                with stage_timer("track.stage_frames", self.events):
                    images_dir = Path(frames_dir) / "images"
                    frame_paths = sorted(images_dir.glob("*.png"))
                    frames = np.stack([read_image(p) for p in frame_paths])
                T, H, W = frames.shape[:3]

                lmk_kw = dict(landmark_kwargs or {})
                if landmark_method in ("neural", "auto"):
                    # the self-trained detector needs the FLAME model to
                    # synthesize its training set
                    lmk_kw.setdefault("model", self.model)
                    lmk_kw.setdefault("device", self.device)
                    lmk_kw.setdefault("train_steps", cfg.track.detector_steps)
                    lmk_kw.setdefault("image_size", cfg.track.detector_size)
                with stage_timer("track.landmarks", self.events):
                    lmk, valid = detect_landmarks(
                        images_dir, method=landmark_method, **lmk_kw,
                    )
                # runtime preflight: score the first-party detector on the
                # actual capture and fall back along neural -> adapters ->
                # landmarks file before the tracker sees a silently bad
                # landmark set
                if landmark_method in ("neural", "auto"):
                    lmk, valid = self._landmarks_with_fallback(
                        lmk, valid, images_dir, W, H)

                masks = None
                if cfg.pipeline.matting != "none":
                    from omfs4d_torch.track.matting import compute_masks
                    mat_kw = {}
                    if cfg.pipeline.matting == "neural":
                        mat_kw = dict(model=self.model,
                                      train_steps=cfg.pipeline.matting_train_steps)
                    if cfg.pipeline.matting in ("neural", "border_color"):
                        mat_kw["device"] = self.device
                    with stage_timer("track.matting", self.events):
                        masks = compute_masks(frames,
                                              method=cfg.pipeline.matting,
                                              **mat_kw)
                    masks = self._masks_with_fallback(masks, frames)
                track_cfg = cfg.track
                if track_cfg.rgb_downsample == 1 and max(W, H) >= 384:
                    # the reference's standard tuning for hi-res captures
                    track_cfg = dataclasses.replace(track_cfg,
                                                    rgb_downsample=2)
                    log.info("hires frames: photometric stages at 1/2 res")
                tracker = FlameTracker(
                    self.model, track_cfg, camera, (W, H),
                    max_per_tile=cfg.render.max_per_tile,
                    device=self.device,
                )
                result = tracker.fit(lmk, valid, frames=frames,
                                     events=self.events)

                # camera-to-world for a static camera, all frames
                w2c = camera.w2c.detach().cpu().numpy().astype(np.float64)
                c2w = np.linalg.inv(w2c)
                c2w_nerf = c2w.copy()
                c2w_nerf[:3, 1:3] *= -1.0
                c2w_all = np.tile(c2w_nerf[None], (T, 1, 1))

                with torch.no_grad():
                    verts0 = flame_forward(
                        self.model,
                        {k: v for k, v in result.params.items()
                         if k != "dynamic_offset"},
                    )[0]
                # dataset intrinsics carry the tracker's refined focal (the
                # caller's fx is only an initial guess)
                write_dataset(
                    out, frames, c2w_all,
                    float(camera.fx) * result.focal_scale,
                    float(camera.fy) * result.focal_scale,
                    float(camera.cx), float(camera.cy),
                    flame_params=result.params,
                    masks=masks,
                    points3d=verts0.cpu().numpy(),
                    n_verts=self.model.n_vertices,
                    train_fraction=cfg.pipeline.train_fraction,
                )
                return {"n_frames": T, "losses": result.losses}

        return self.store.run(
            "track", {"frames": str(frames_dir)},
            {"track": self.cfg.track.__dict__, "lmk": landmark_method,
             "matting": self.cfg.pipeline.matting},
            run, force=force,
        )

    # ── runtime preflight fallbacks (see track/preflight.py) ─
    def _landmarks_with_fallback(self, lmk, valid, images_dir, W, H):
        """Gate the first-party detector's output on the actual capture.

        Fallback chain on failure: pretrained adapters (face_alignment,
        mediapipe, when importable) -> a landmarks.npz next to the frames ->
        keep the flagged landmarks with a loud events.jsonl warning (never
        silently)."""
        from omfs4d_torch.track.preflight import landmark_preflight

        report = landmark_preflight(lmk, valid, W, H)
        if report.ok:
            return lmk, valid
        log.warning("landmark preflight FAILED: %s", "; ".join(report.reasons))
        self.events.emit("preflight_warning", stage="track.landmarks",
                         **report.asdict())
        for method in ("face_alignment", "mediapipe"):
            try:
                cand, cvalid = detect_landmarks(images_dir, method=method)
            except Exception as e:  # noqa: BLE001 — adapter likely absent
                self.events.emit("preflight_fallback_unavailable",
                                 stage="track.landmarks", method=method,
                                 error=str(e)[:200])
                continue
            crep = landmark_preflight(cand, cvalid, W, H)
            if crep.ok:
                log.warning("landmark preflight: falling back to %s", method)
                self.events.emit("preflight_fallback",
                                 stage="track.landmarks", method=method,
                                 **crep.asdict())
                return cand, cvalid
        p = Path(images_dir)
        for cand_file in (p / "landmarks.npz", p.parent / "landmarks.npz"):
            if cand_file.exists():
                log.warning("landmark preflight: falling back to %s",
                            cand_file)
                self.events.emit("preflight_fallback",
                                 stage="track.landmarks", method="file",
                                 path=str(cand_file))
                return detect_landmarks(cand_file, method="file")
        log.warning("landmark preflight failed and NO fallback is available;"
                    " proceeding with the flagged landmarks")
        self.events.emit("preflight_no_fallback", stage="track.landmarks")
        return lmk, valid

    def _masks_with_fallback(self, masks, frames):
        """Gate the matting output; fall back to median_background (the
        static-camera baseline) when the configured method produces
        implausible masks on this capture."""
        from omfs4d_torch.track.matting import compute_masks
        from omfs4d_torch.track.preflight import mask_preflight

        report = mask_preflight(masks)
        if report.ok:
            return masks
        log.warning("matting preflight FAILED: %s", "; ".join(report.reasons))
        self.events.emit("preflight_warning", stage="track.matting",
                         **report.asdict())
        if self.cfg.pipeline.matting != "median_background":
            cand = compute_masks(frames, method="median_background")
            crep = mask_preflight(cand)
            if crep.ok:
                log.warning("matting preflight: falling back to "
                            "median_background")
                self.events.emit("preflight_fallback", stage="track.matting",
                                 method="median_background", **crep.asdict())
                return cand
        log.warning("matting preflight failed and the median fallback did "
                    "not pass either; writing the dataset WITHOUT fg masks")
        self.events.emit("preflight_no_fallback", stage="track.matting")
        return None

    # ── stages 4-6: not ported yet ───────────────────────────
    def train(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("train"))

    def render_surgery(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("render_surgery"))

    def report(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("report"))
