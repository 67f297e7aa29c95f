"""One synthetic case end to end through the port's pipeline, with timings and
fidelity: capture -> track -> train -> (a) zero-offset self-reconstruction vs
the GT frames (the fidelity number) and (b) the surgical prediction -> strict
report.  The counterpart of `scripts/e2e_case.py`, with its flags and JSON keys,
plus the card's name and power limit.

    python -m omfs4d_torch.scripts.e2e_case --size 512 --frames 60 --iters 5000 \\
        --set train.flame_anchor_decay=0

Quick CPU smoke: --size 64 --frames 4 --iters 120 --cpu

The synthetic case's frames are stitched to `input.mp4` (`stitch_video`: H.264
through ffmpeg, or the port's own H.264 encoder with none) and that video is
the capture handed to `Pipeline.preprocess`, as the reference's script does, with no
landmark file beside the extracted frames, so the `auto` source trains the
landmark net.
The result is written to `--out` (default `<workdir>/E2E_TIMING.json`) and
printed as the last line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np


def train_ips_curve(events_path: Path, since: float, iters: int) -> list[dict] | None:
    """it/s in ten buckets of the run's iterations, from the `train_step`
    events written at or after `since` (a reused workdir's events.jsonl still
    holds past runs' steps)."""
    if not events_path.exists():
        return None
    rows = []
    for line in events_path.read_text().splitlines():
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue
        if r.get("event") == "train_step" and r.get("t", 0) >= since:
            rows.append((r["iter"], r["t"], r.get("n_alive")))
    rows.sort()
    if len(rows) < 3:
        return None
    bucket = max(iters // 10, 1)
    curve = []
    for b in range(0, iters, bucket):
        seg = [r for r in rows if b < r[0] <= b + bucket]
        if len(seg) >= 2:
            dt = seg[-1][1] - seg[0][1]
            di = seg[-1][0] - seg[0][0]
            if dt > 0:
                curve.append({"iters": [seg[0][0], seg[-1][0]],
                              "it_per_sec": round(di / dt, 1), "n_alive": seg[-1][2]})
    return curve


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "omfs4d_e2e"))
    ap.add_argument("--out", default="",
                    help="result JSON (default: <workdir>/E2E_TIMING.json)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--max-per-tile", type=int, default=0,
                    help="override render.max_per_tile (0 = config default)")
    ap.add_argument("--gt-track", action="store_true",
                    help="bypass the tracker and train directly on the GT "
                         "synthetic FLAME params — isolates trainer fidelity "
                         "from tracker quality (dB attribution)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="dotted config override, e.g. "
                         "train.opacity_reset_interval=0 (repeatable)")
    args = ap.parse_args(argv)

    from omfs4d_torch.core.config import Config, apply_override
    from omfs4d_torch.core.device import resolve_device
    from omfs4d_torch.eval.reporting import find_latest_train_dir
    from omfs4d_torch.io.synthetic import make_synthetic_dataset
    from omfs4d_torch.io.video import stitch_video
    from omfs4d_torch.pipeline.cli import capture_camera
    from omfs4d_torch.pipeline.runner import Pipeline

    device = resolve_device("cpu" if args.cpu else None, "e2e_case")
    card = None
    if device.type == "cuda":
        from omfs4d_torch.scripts.profile_composite_variants import card_line
        card = card_line()
    print(f"[e2e] device={device} card={card}", flush=True)

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    S = args.size
    stages: dict[str, float] = {}

    class timed:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t = time.time()

        def __exit__(self, *exc):
            stages[self.name] = round(time.time() - self.t, 1)
            print(f"[e2e] {self.name}: {stages[self.name]}s", flush=True)

    # the synthetic "patient capture" -> a video, no landmarks anywhere on disk
    print("[e2e] generating synthetic capture...", flush=True)
    case = make_synthetic_dataset(work / "case", n_frames=args.frames,
                                  width=S, height=S, device=device)
    capture = stitch_video(Path(case["path"]) / "images", work / "input.mp4", fps=25)

    cfg = Config()
    cfg.pipeline.target_size = S
    cfg.pipeline.max_frames = args.frames
    cfg.pipeline.min_train_frames = min(50, max(args.frames - 2, 1))
    if args.max_per_tile:
        cfg.render.max_per_tile = args.max_per_tile
    cfg.train.iterations = args.iters
    for kv in args.set:
        k, _, v = kv.partition("=")
        apply_override(cfg, k, v)
    if args.frames < 20:     # smoke-scale tracking budget
        for k, v in dict(steps_lmk_init_rigid=20, steps_lmk_init_all=15,
                         steps_rgb_init_texture=5, steps_rgb_init_all=5,
                         steps_rgb_init_offset=2, steps_rgb_sequential=2,
                         steps_global=6, epochs_global=1, n_shape=10,
                         n_expr=10, detector_steps=50,
                         detector_size=64).items():
            setattr(cfg.track, k, v)
    pipe = Pipeline(cfg, work / "wd", device=device)

    t_all = time.time()
    if args.gt_track:
        # the synthetic case dir is a GT-parameter dataset in the training
        # contract: training on it measures the trainer's fidelity with a
        # perfect tracker
        pipe.model = case["model"]
        data_dir = Path(case["path"])
        print("[e2e] --gt-track: skipping preprocess/track", flush=True)
    else:
        with timed("preprocess"):
            frames_dir = pipe.preprocess(capture)
        with timed("track"):
            data_dir = pipe.track(frames_dir, capture_camera(frames_dir),
                                  landmark_method="auto")
    with timed(f"train_{args.iters}_iters"):
        model_dir = pipe.train(data_dir, iterations=args.iters)

    # (a) fidelity: zero-offset self-reconstruction vs GT frames
    det_self = work / "det_self"
    with timed("selfrecon_render"):
        selfrecon = pipe.render_surgery(model_dir, data_dir, work / "selfrecon.mp4",
                                        0.0, 0.0, export_frames_dir=str(det_self))
    with timed("selfrecon_report"):
        rep = pipe.report(model_dir, det_self, output_dir=work / "selfrecon_report")
    rows = rep.get("rows", [])
    selfrecon_psnr = float(np.mean([r["psnr"] for r in rows])) if rows else None
    per_frame = sorted(float(r["psnr"]) for r in rows)
    psnr_stats = {"min": per_frame[0], "max": per_frame[-1],
                  "std": float(np.std(per_frame))} if per_frame else None
    print(f"[e2e] selfrecon_psnr={selfrecon_psnr} stats={psnr_stats} "
          f"video={selfrecon['video']} ({selfrecon['video_error']})", flush=True)

    # the zero-offset renders are the baseline of the region-excluded metric
    # on the modified prediction (psnr_unchanged: did the prediction corrupt
    # anything the surgery did not touch?)
    baseline_renders = work / "baseline_renders"
    if baseline_renders.exists():
        shutil.rmtree(baseline_renders)
    shutil.copytree(find_latest_train_dir(Path(model_dir)) / "renders", baseline_renders)

    # (b) surgical prediction (modified params) + strict report
    det_mod = work / "det_mod"
    with timed("render_surgery"):
        pipe.render_surgery(model_dir, data_dir, work / "pred.mp4", 5.0, 3.0,
                            export_frames_dir=str(det_mod))
    with timed("report"):
        rep_mod = pipe.report(model_dir, det_mod, output_dir=work / "report",
                              baseline_renders_dir=baseline_renders)
    front = rep_mod.get("summary", {}).get("by_bucket", {}).get("front", {})

    out = {
        "e2e_minutes_per_case": round((time.time() - t_all) / 60, 2),
        "stages_sec": stages,
        "resolution": S,
        "n_frames": args.frames,
        "train_iters": args.iters,
        "backend": device.type,
        # nvidia-smi's "name, power.limit"
        "card_name": card.rpartition(", ")[0] if card else None,
        "power_limit": card.rpartition(", ")[2] if card else None,
        "selfrecon_psnr": selfrecon_psnr,
        "selfrecon_psnr_stats": psnr_stats,
        "gt_track": bool(args.gt_track),
        "front_psnr_modified": front.get("psnr"),
        "front_psnr_unchanged": front.get("psnr_unchanged"),
        "train_ips_curve": train_ips_curve(work / "wd" / "events.jsonl", t_all, args.iters),
        "overrides": args.set,
    }
    out_path = Path(args.out) if args.out else work / "E2E_TIMING.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
