"""Unified CLI of the PyTorch port (port of `omfs4d.pipeline.cli`).

    python -m omfs4d_torch.pipeline.cli clinical --dicom DIR --out mesh.stl \
        clinical.hu_threshold=700
    python -m omfs4d_torch.pipeline.cli synthetic-data --out data/ --frames 60
    python -m omfs4d_torch.pipeline.cli track --frames-dir W/stages/preprocess-x ...
    python -m omfs4d_torch.pipeline.cli train --data data/ --out model/
    python -m omfs4d_torch.pipeline.cli render-surgery --model model/ --data data/ \\
        --lefort-mm 5 --bsso-mm 3 --output pred.mp4
    python -m omfs4d_torch.pipeline.cli report --model model/ --frames det/
    python -m omfs4d_torch.pipeline.cli run --video clip.avi --lefort-mm 5 --bsso-mm 3 \
        --output pred.mp4

The subcommands and flags are the reference's.  Dotted `key=value` tokens
anywhere override the config tree.  Every subcommand that touches a model runs
on the CUDA card and raises without one; `--device cpu` asks for the CPU.  A
capture (`--video`) is a directory of PNG or JPEG frames or a video file.  With
an ffmpeg binary any codec it decodes is read and the prediction is H.264
through libx264; with none, the port reads by itself Motion JPEG (MJPG) in
`.avi` / `.mp4`, H.264 Main / High profile I, P and B pictures in `.mp4` /
`.mov` (a phone's capture, turned upright), HEVC Main and Main 10 in `.mp4` /
`.mov`, whole (an iPhone's "High Efficiency" or "HDR Video" capture, an x265
re-export) and MPEG-4 Part 2 Simple and Advanced Simple profile in `.mp4` /
`.avi` (cv2's `mp4v` / `XVID` / `DIVX` / `FMP4`, as the JAX package writes
it, and Xvid's and DivX's B-VOPs, packed bitstream, quarter-sample and MPEG
quantisation), VP8 in `.webm` / `.mkv` / `.avi` (a browser's recording,
cv2's `VP80`), VP9 profile 0 in `.webm` / `.mkv` / `.avi` / `.mp4` (a
browser's or YouTube's WebM, cv2's `VP90`) and MPEG-1 / MPEG-2 in `.mpg` /
`.mpeg` / `.vob` / `.ts` / `.avi` / `.mkv` / `.mp4` / `.mov` (cv2's `MPG1` /
`PIM1` / `MPG2`, a DVD's or a broadcast capture's progressive or interlaced
frame pictures), and MS MPEG-4 v2 / v3 (DivX 3) and WMV1 / WMV2 (WMV 7 / 8)
in `.wmv` / `.asf` / `.avi` / `.mkv` (a Windows capture cart's or Movie
Maker's export, a DivX 3 archive, cv2's `MP42` / `MP43` / `WMV1` / `WMV2`;
ASF also holds every codec above as cv2 writes it), and writes the
prediction with its own H.264 encoder (Motion JPEG AVI for a `.avi` output),
while H.264 with fields, HEVC's range extensions (4:0:0, 4:2:2, 4:4:4, above
10 bits), screen content coding, MPEG-2 field pictures, WMV2's IntraX8
pictures, MS MPEG-4 v1, WMV 9 / VC-1 and other codecs raise, naming the
codec or feature.

Under `torchrun` (WORLD_SIZE > 1) each process is one rank: the pipeline's
commands join the process group first (`init_distributed`; the backend is
nccl when every rank has a card of its own, else gloo) and `parallel.*`
overrides shard their stages, e.g.

    torchrun --nproc-per-node 2 -m omfs4d_torch.pipeline.cli run --video F/ \
        --lefort-mm 5 --bsso-mm 3 parallel.n_gauss=2
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from omfs4d_torch.core.config import config_from_args
from omfs4d_torch.core.logging import get_logger

log = get_logger("cli")


VIDEO_HELP = ("the capture: a directory of PNG or JPEG frames, or a video file; "
              "without an ffmpeg binary only Motion JPEG (MJPG) in .avi / .mp4, H.264 "
              "Main / High I, P and B pictures in .mp4 / .mov (a phone's capture), HEVC "
              "Main and Main 10 in .mp4 / .mov (hvc1 / hev1) and MPEG-4 Part 2 Simple and "
              "Advanced Simple in .mp4 / .avi (cv2's mp4v / XVID / DIVX / FMP4, Xvid's and "
              "DivX's B-VOPs, quarter-sample and MPEG quantisation), VP8 in .webm / .mkv / "
              ".avi (a browser's recording, cv2's VP80) and VP9 profile 0 in .webm / .mkv "
              "/ .avi / .mp4 (a browser's or YouTube's WebM, cv2's VP90) and MPEG-1 / MPEG-2 "
              "in .mpg / .mpeg / .vob / .ts / .avi / .mkv / .mp4 / .mov (cv2's MPG1 / MPG2, "
              "a DVD's frame pictures) and MS MPEG-4 v2 / v3 (DivX 3) and WMV1 / WMV2 in "
              ".wmv / .asf / .avi / .mkv (cv2's MP42 / MP43 / WMV1 / WMV2; ASF holding any "
              "codec above) are read (HEVC's range extensions and screen content coding, VP9 "
              "profiles 1-3, MPEG-2 field pictures and 4:2:2, WMV2's IntraX8 pictures, MS "
              "MPEG-4 v1, WMV 9 / VC-1, and other codecs, need ffmpeg)")


def _add_device(p: argparse.ArgumentParser):
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' asks for the CPU)")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--workdir", default="omfs4d_work")
    p.add_argument("--flame-asset", default="",
                   help="path to flame2023.pkl (synthetic asset if omitted)")
    _add_device(p)


def capture_camera(frames_dir: Path):
    """The static look-at camera the reference's CLI assumes for a capture,
    sized by its first frame."""
    from omfs4d_torch.io.video import read_image
    from omfs4d_torch.ops.camera import look_at_camera

    sample = next((frames_dir / "images").glob("*.png"))
    h, w = read_image(sample).shape[:2]
    return look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0),
                          fx=1.6 * max(w, h), width=w, height=h)


def main(argv: list[str] | None = None):
    argv = argv if argv is not None else sys.argv[1:]
    cfg, rest = config_from_args(argv)

    parser = argparse.ArgumentParser(prog="omfs4d_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("clinical", help="DICOM/NIfTI -> bone mesh (+ cuts)")
    p.add_argument("--dicom", default="")
    p.add_argument("--nifti-labels", default="")
    p.add_argument("--nifti-image", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--lefort-z", type=float, default=None)
    p.add_argument("--bsso-l-x", type=float, default=None)
    p.add_argument("--bsso-r-x", type=float, default=None)
    p.add_argument("--maxilla-mm", type=float, default=0.0)
    p.add_argument("--mandible-mm", type=float, default=0.0)
    _add_device(p)

    p = sub.add_parser("synthetic-data", help="generate a synthetic GT dataset")
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--size", type=int, default=128)
    _add_device(p)

    p = sub.add_parser("prepare-models",
                       help="pre-train + cache the neural landmark detector "
                            "and matting net (otherwise trained lazily on "
                            "first pipeline use)")
    _add_common(p)
    p.add_argument("--skip-detector", action="store_true")
    p.add_argument("--skip-matting", action="store_true")

    p = sub.add_parser("preprocess", help="capture -> frames")
    _add_common(p)
    p.add_argument("--video", required=True, help=VIDEO_HELP)

    p = sub.add_parser("track", help="frames -> tracked dataset")
    _add_common(p)
    p.add_argument("--frames-dir", required=True)
    p.add_argument("--landmarks", default="auto",
                   help="landmark source: auto|file|neural|synthetic|<plugin>")

    p = sub.add_parser("train", help="dataset -> avatar model")
    _add_common(p)
    p.add_argument("--data", required=True)
    p.add_argument("--out", default="")
    p.add_argument("--iterations", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in --out "
                        "(full optimizer + FLAME state restored)")

    p = sub.add_parser("render-surgery", help="surgical prediction video")
    _add_common(p)
    p.add_argument("--model", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--output", default="final_prediction.mp4")
    p.add_argument("--lefort-mm", type=float, required=True)
    p.add_argument("--bsso-mm", type=float, required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--rig-mode", default="flame_only",
                   choices=("flame_only", "hybrid_full_head"))
    p.add_argument("--canonical-head-asset", default="")
    p.add_argument("--deformation-map", default="")
    p.add_argument("--export-frames-dir", default="")
    p.add_argument("--deterministic-indices", default="")

    p = sub.add_parser("run", help="full pipeline: capture -> prediction")
    _add_common(p)
    p.add_argument("--video", required=True, help=VIDEO_HELP)
    p.add_argument("--lefort-mm", type=float, default=0.0)
    p.add_argument("--bsso-mm", type=float, default=0.0)
    p.add_argument("--output", default="final_prediction.mp4")
    p.add_argument("--landmarks", default="auto")
    p.add_argument("--iterations", type=int, default=0)

    p = sub.add_parser("report", help="strict PSNR/SSIM validation report")
    p.add_argument("--model", required=True)
    p.add_argument("--frames", required=True)
    p.add_argument("--out", default="")
    p.add_argument("--baseline-renders", default="",
                   help="zero-offset renders of the same frames; adds the "
                        "region-excluded psnr_unchanged metric")

    args = parser.parse_args(rest)

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # started by torchrun: one rank of an SPMD job.  The pipeline's
        # stages join the process group; the single-process commands run on
        # rank 0 alone
        if args.cmd in ("clinical", "synthetic-data", "report"):
            if int(os.environ.get("RANK", "0")) != 0:
                return 0
        else:
            import torch.distributed as dist

            from omfs4d_torch.parallel.distributed import init_distributed
            if not dist.is_initialized():
                args.device = init_distributed(device=args.device)

    if args.cmd == "clinical":
        return _cmd_clinical(args, cfg)
    if args.cmd == "synthetic-data":
        from omfs4d_torch.io.synthetic import make_synthetic_dataset
        out = make_synthetic_dataset(args.out, n_frames=args.frames,
                                     width=args.size, height=args.size,
                                     device=args.device)
        log.info(f"synthetic dataset at {out['path']}")
        return 0
    if args.cmd == "report":
        # host NumPy on PNG files: no model, no device
        from omfs4d_torch.eval.reporting import generate_report
        out = Path(args.out) if args.out else Path(args.model) / "eval_strict" / "reports"
        generate_report(Path(args.model), Path(args.frames), out,
                        baseline_renders_dir=Path(args.baseline_renders)
                        if args.baseline_renders else None)
        return 0

    from omfs4d_torch.pipeline.runner import Pipeline
    pipe = Pipeline(cfg, args.workdir, flame_asset=args.flame_asset or None,
                    device=args.device)

    if args.cmd == "prepare-models":
        # the self-trained nets, trained once and cached under OMFS4D_CACHE
        # (the reference's counterpart of a model-weight download)
        if not args.skip_detector:
            from omfs4d_torch.track.detector import get_or_train_detector
            get_or_train_detector(pipe.model,
                                  image_size=cfg.track.detector_size,
                                  steps=cfg.track.detector_steps,
                                  device=pipe.device)
            log.info("landmark detector ready")
        if not args.skip_matting:
            from omfs4d_torch.track.segnet import get_or_train_segnet
            get_or_train_segnet(pipe.model, steps=cfg.pipeline.matting_train_steps,
                                device=pipe.device)
            log.info("matting net ready")
        return 0
    if args.cmd == "preprocess":
        out = pipe.preprocess(args.video)
        log.info(f"frames at {out}")
    elif args.cmd == "track":
        frames_dir = Path(args.frames_dir)
        out = pipe.track(frames_dir, capture_camera(frames_dir),
                         landmark_method=args.landmarks)
        log.info(f"tracked dataset at {out}")
    elif args.cmd == "train":
        out = pipe.train(Path(args.data), Path(args.out) if args.out else None,
                         iterations=args.iterations or None,
                         resume=args.resume)
        log.info(f"model at {out}")
    elif args.cmd == "render-surgery":
        result = pipe.render_surgery(
            Path(args.model), Path(args.data), Path(args.output),
            args.lefort_mm, args.bsso_mm,
            iteration=args.iteration,
            rig_mode=args.rig_mode,
            canonical_head_asset=args.canonical_head_asset,
            deformation_map=args.deformation_map,
            export_frames_dir=args.export_frames_dir,
            deterministic_indices=args.deterministic_indices,
        )
        log.info(f"prediction: {result}")
    elif args.cmd == "run":
        # the reference's 6-stage batch pipeline in one command
        # (ref: run_full_pipeline_conda.ps1 preprocess->track->convert->
        #  train->render->report)
        frames_dir = pipe.preprocess(args.video)
        data_dir = pipe.track(frames_dir, capture_camera(frames_dir),
                              landmark_method=args.landmarks)
        model_dir = pipe.train(data_dir, iterations=args.iterations or None)
        det_dir = Path(args.workdir) / "deterministic_frames"
        result = pipe.render_surgery(
            model_dir, data_dir, Path(args.output),
            args.lefort_mm, args.bsso_mm,
            export_frames_dir=str(det_dir),
        )
        report = pipe.report(model_dir, det_dir)
        if result["video"] is not None:
            log.info(f"pipeline complete: {result['video']}")
        else:
            log.info(f"pipeline complete, no video ({result['video_error']}); "
                     f"frames in {result['renders_dir']}")
        log.info(f"strict report buckets: {report['summary']['by_bucket']}")
    return 0


def _cmd_clinical(args, cfg) -> int:
    """The reference's `clinical` as written (`omfs4d/pipeline/cli.py:209-248`),
    on `--device`: a missing `--bsso-l-x` / `--bsso-r-x` is -15 / 15 mm, and
    so is 0.0 (`or`)."""
    from omfs4d_torch.clinical.loader import (
        dicom_to_bone_mesh, nifti_image_to_bone_mesh,
        nifti_label_to_separate_meshes,
    )
    from omfs4d_torch.clinical.surgical import SurgicalCutter
    from omfs4d_torch.io.meshio import save_mesh

    c = cfg.clinical
    maxilla = mandible = None
    if args.dicom:
        maxilla = dicom_to_bone_mesh(args.dicom, c.hu_threshold, c.smooth_iterations,
                                     c.decimate_fraction, device=args.device)
    elif args.nifti_labels:
        out = nifti_label_to_separate_meshes(
            args.nifti_labels, smooth_iterations=c.smooth_iterations,
            decimate_fraction=c.decimate_fraction, device=args.device)
        maxilla, mandible = out["maxilla_mesh"], out["mandible_mesh"]
    elif args.nifti_image:
        maxilla = nifti_image_to_bone_mesh(args.nifti_image, c.hu_threshold,
                                           c.smooth_iterations, c.decimate_fraction,
                                           device=args.device)
    else:
        log.error("one of --dicom / --nifti-labels / --nifti-image required")
        return 1

    if args.lefort_z is not None:
        cutter = SurgicalCutter(maxilla, mandible)
        cutter.perform_cut(args.lefort_z, args.bsso_l_x or -15.0,
                           args.bsso_r_x or 15.0)
        moved = cutter.move_segments(args.maxilla_mm, args.mandible_mm)
        combined = None
        for seg in moved.values():
            if seg is not None and seg.n_points:
                combined = seg if combined is None else combined.merge(seg)
        save_mesh(args.out, *combined.numpy())
    else:
        mesh = maxilla if mandible is None else maxilla.merge(mandible)
        save_mesh(args.out, *mesh.numpy())
    log.info(f"mesh written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
