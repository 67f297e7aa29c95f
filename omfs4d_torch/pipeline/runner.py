"""Pipeline runner: capture -> tracked dataset -> avatar -> prediction ->
strict report, in PyTorch.

Port of `omfs4d.pipeline.runner`: one Python process in which stages pass
arrays, cache by content hash (`ArtifactStore`) and emit JSONL progress
events.  Stages: `preprocess` (a capture to numbered frames), `track`
(landmarks -> preflight and fallbacks -> matting -> FLAME tracking -> the
contract dataset), `train` (the avatar), `render_surgery` (the prediction)
and `report` (strict PSNR/SSIM by view bucket).

The pipeline runs on one device: `device=None` takes the CUDA card and raises
when there is none.  Spreading a stage over devices (`parallel.n_data`,
`n_gauss` or `n_tile` > 1) waits for the port's parallel slice and raises.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from omfs4d_torch.core.artifacts import ArtifactStore, write_experiment_manifest
from omfs4d_torch.core.config import Config, TrainConfig
from omfs4d_torch.core.device import resolve_device
from omfs4d_torch.core.logging import EventLogger, get_logger, stage_timer
from omfs4d_torch.io.dataset import FrameDataset, write_dataset
from omfs4d_torch.io.video import extract_frames, probe_video, read_image
from omfs4d_torch.models.assets import load_flame_asset, synthetic_flame_asset
from omfs4d_torch.models.flame import FlameModel, flame_forward
from omfs4d_torch.track.fitter import FlameTracker
from omfs4d_torch.track.landmarks import detect_landmarks
from omfs4d_torch.train.checkpoints import checkpoint_lineage
from omfs4d_torch.train.gates import run_quality_gates
from omfs4d_torch.train.trainer import AvatarTrainer

log = get_logger("pipeline")

_SHARDED = ("Pipeline.{}: {} waits for the port's parallel slice (ROADMAP.md queue 1 "
            "item 9); run on one device")


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
            raise NotImplementedError(_SHARDED.format(
                "track", "parallel.n_data > 1 (sharding the frame axis over devices)"))

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

    # ── stage 4: avatar training ─────────────────────────────
    def train(self, data_dir: Path, output_dir: Path | None = None,
              iterations: int | None = None, force: bool = False,
              resume: bool = False) -> Path:
        cfg = self.cfg
        output_dir = Path(output_dir) if output_dir else self.workdir / "model"
        if cfg.parallel.n_gauss > 1:
            raise NotImplementedError(_SHARDED.format(
                "train", "parallel.n_gauss > 1 (the gaussian-sharded trainer)"))
        if cfg.parallel.n_data > 1:
            raise NotImplementedError(_SHARDED.format(
                "train", "parallel.n_data > 1 (frame data parallelism)"))

        run_quality_gates(data_dir, min_frames=min(cfg.pipeline.min_train_frames,
                                                   50))

        ds = FrameDataset(data_dir, split="train")
        T = len(ds)
        images = np.stack([ds.load_image(i) for i in range(T)])
        H, W = images.shape[1:3]
        masks = None
        m0 = ds.load_mask(0)
        if m0 is not None:
            masks = np.stack([
                (ds.load_mask(i) * 255).astype(np.uint8) for i in range(T)
            ])

        params = {k: v for k, v in ds.flame_params.items()
                  if k != "dynamic_offset"}
        with torch.no_grad():
            verts = flame_forward(self.model, params)

        cams = [ds.camera(i) for i in range(T)]
        data = {
            "images": images,
            "verts": verts,
            "w2c": np.stack([c.w2c.numpy() for c in cams]),
            "fx": np.asarray([float(c.fx) for c in cams], np.float32),
            "fy": np.asarray([float(c.fy) for c in cams], np.float32),
            "cx": np.asarray([float(c.cx) for c in cams], np.float32),
            "cy": np.asarray([float(c.cy) for c in cams], np.float32),
        }
        if masks is not None:
            data["masks"] = masks

        train_cfg = cfg.train
        default_interval = TrainConfig.__dataclass_fields__[
            "densify_interval"].default
        if (train_cfg.densify_interval == default_interval
                and max(W, H) >= 384):
            # measured end to end by the reference: at >= 512^2 the faster
            # cadence wins (21.8 vs 20.0 dB selfrecon), at 256^2 it loses
            # ~4.5 dB.  Only applied when the user left the default.
            train_cfg = dataclasses.replace(train_cfg, densify_interval=100)
            log.info("hires dataset: densify_interval 300 -> 100")

        trainer = AvatarTrainer(
            self.model.faces.cpu().numpy(), train_cfg, W, H,
            white_background=cfg.render.white_background,
            tile=cfg.render.tile,
            max_per_tile=cfg.render.max_per_tile,
            flame_model=self.model if cfg.train.optimize_flame else None,
            device=self.device,
        )
        state = trainer.init_state(
            flame_params=params if cfg.train.optimize_flame else None,
            canonical_verts=verts[0].cpu().numpy(),
        )
        start_iter = 0
        if resume:
            # continue a killed run from its newest checkpoint (ref lineage:
            # train_ghost.py:141-156 over GA's chkpnt*.pth)
            try:
                state, start_iter = trainer.restore_checkpoint(
                    output_dir, template=state)
                self.events.emit("train_resume", iteration=start_iter)
            except FileNotFoundError:
                log.info("resume requested but no checkpoint exists; "
                         "starting fresh")
        with stage_timer("train", self.events):
            state = trainer.train(data, iterations=iterations, state=state,
                                  output_dir=output_dir, events=self.events,
                                  start_iteration=start_iter)
        if cfg.train.optimize_flame and state.flame_params is not None:
            # export the co-optimized FLAME params: the avatar was trained
            # against these poses, so the prediction renderer re-poses from
            # them (render_prediction picks this file up)
            np.savez(output_dir / "flame_param_refined.npz",
                     **{k: v.detach().cpu().numpy()
                        for k, v in state.flame_params.items()})

        write_experiment_manifest(
            output_dir, data_dir, cfg.to_dict(),
            extra={"iterations": iterations or cfg.train.iterations,
                   "resumed_from_iteration": start_iter,
                   "checkpoint_lineage": checkpoint_lineage(output_dir)})
        return output_dir

    # ── stage 5: surgical prediction render ──────────────────
    def render_surgery(self, model_dir: Path, data_dir: Path, output: Path,
                       lefort_mm: float, bsso_mm: float, **kw) -> dict:
        """`render_prediction` on the pipeline's model and device, with the
        config's prediction and render settings; a keyword in `kw` (such as
        the CLI's `rig_mode`) takes the place of the config's."""
        from omfs4d_torch.predict.render_video import render_prediction

        opts = dict(sensitivity=self.cfg.predict.sensitivity,
                    fps=self.cfg.predict.fps,
                    rig_mode=self.cfg.predict.rig_mode,
                    white_background=self.cfg.render.white_background,
                    n_tile=max(self.cfg.parallel.n_tile, 1),
                    max_per_tile=self.cfg.render.max_per_tile)
        opts.update(kw)
        if opts["n_tile"] > 1:
            raise NotImplementedError(_SHARDED.format(
                "render_surgery", "parallel.n_tile > 1 (tile-sharded rendering)"))
        with stage_timer("render_surgery", self.events):
            return render_prediction(
                model_dir, data_dir, self.model, output=output,
                lefort_mm=lefort_mm, bsso_mm=bsso_mm, device=self.device,
                **opts)

    # ── stage 6: strict report ───────────────────────────────
    def report(self, model_dir: Path, deterministic_dir: Path,
               output_dir: Path | None = None,
               baseline_renders_dir: Path | None = None) -> dict:
        from omfs4d_torch.eval.reporting import generate_report

        output_dir = output_dir or (Path(model_dir) / "eval_strict" / "reports")
        with stage_timer("report", self.events):
            return generate_report(Path(model_dir), Path(deterministic_dir),
                                   Path(output_dir),
                                   baseline_renders_dir=baseline_renders_dir)
