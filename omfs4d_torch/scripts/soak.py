"""Endurance soak: long-horizon training health at reduced resolution, on the
card.  The counterpart of `scripts/soak.py`, with its flags and its output.

    python -m omfs4d_torch.scripts.soak --size 256 --frames 60 --iters 100000

The reference's "full quality" operating point is 600k iterations over ~8 h
(`app.py:1347`); the soak drives the long-horizon failure modes that scale
surfaces -- checkpoint-thread pileup, capacity growth, host-memory creep --
with a long GT-parameter training run: `make_synthetic_dataset` ->
`Pipeline.train`.  The trainer emits the health signals at every log tick
(`rss_mb`, `capacity`, `ckpt_threads`: `omfs4d_torch/train/trainer.py`'s
train loop); `summarize` folds those `train_step` events into the result
JSON, which a monitor thread rewrites every 60 s, so that a cut run still
leaves an honest partial record.  PyTorch compiles nothing at run time, so
the events carry no `recompiles` and `recompiles_total` comes out None.
Beside the reference's fields: the card's name and power limit in the meta,
and `cuda_max_mem_mb` (`torch.cuda.max_memory_allocated`), the device
counterpart of the host-RSS creep.  `--cpu` runs on the CPU (for the tests).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import threading
import time
from pathlib import Path

import torch


def summarize(ev_path: Path, t_start: float, meta: dict) -> dict:
    """The run so far, from its `train_step` events (those written at or
    after `t_start`): it/s, alive count and PSNR in 20 buckets of the
    iterations, and the first and last health signals."""
    rows = []
    if ev_path.exists():
        for line in ev_path.read_text().splitlines():
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("event") == "train_step" and r.get("t", 0) >= t_start:
                rows.append(r)
    rows.sort(key=lambda r: r["iter"])
    out = dict(meta)
    out["wall_minutes"] = round((time.time() - t_start) / 60, 2)
    out["n_log_ticks"] = len(rows)
    if not rows:
        return out
    iters = int(meta["iters"])
    bucket = max(iters // 20, 1)
    curve = []
    for b in range(0, iters, bucket):
        seg = [r for r in rows if b < r["iter"] <= b + bucket]
        if len(seg) >= 2:
            dt = seg[-1]["t"] - seg[0]["t"]
            di = seg[-1]["iter"] - seg[0]["iter"]
            if dt > 0:
                curve.append({
                    "iters": [seg[0]["iter"], seg[-1]["iter"]],
                    "it_per_sec": round(di / dt, 1),
                    "n_alive": seg[-1].get("n_alive"),
                    "psnr": round(seg[-1].get("psnr", 0.0), 2),
                })
    last = rows[-1]
    out.update(
        progress_iter=last["iter"],
        curve=curve,
        # the long-horizon health signals (the trainer's log tick)
        rss_mb_first=rows[0].get("rss_mb"),
        rss_mb_last=last.get("rss_mb"),
        recompiles_total=last.get("recompiles"),
        capacity_first=rows[0].get("capacity"),
        capacity_last=last.get("capacity"),
        ckpt_threads_max=max(r.get("ckpt_threads", 0) for r in rows),
        n_alive_last=last.get("n_alive"),
        psnr_last=round(last.get("psnr", 0.0), 2),
        psnr_best=round(max(r.get("psnr", 0.0) for r in rows), 2),
    )
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--iters", type=int, default=100_000)
    ap.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "omfs4d_soak"))
    ap.add_argument("--out", default="",
                    help="result JSON (default: <workdir>/E2E_SOAK_256.json)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)

    from omfs4d_torch.core.config import Config
    from omfs4d_torch.core.device import resolve_device
    from omfs4d_torch.io.synthetic import make_synthetic_dataset
    from omfs4d_torch.pipeline.runner import Pipeline

    device = resolve_device("cpu" if args.cpu else None, "soak")
    cuda = device.type == "cuda"
    card = {"device": None, "power_limit_w": None}
    if cuda:
        from omfs4d_torch.scripts.bench import power_limit_w

        card = {"device": torch.cuda.get_device_name(device), "power_limit_w": power_limit_w()}
        torch.cuda.reset_peak_memory_stats(device)
    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    print(f"[soak] device={device} card={card} size={args.size} iters={args.iters}",
          flush=True)

    case = make_synthetic_dataset(work / "case", n_frames=args.frames, width=args.size,
                                  height=args.size, device=device)
    cfg = Config()
    cfg.pipeline.target_size = args.size
    cfg.pipeline.min_train_frames = min(50, max(args.frames - 2, 1))
    cfg.train.iterations = args.iters
    pipe = Pipeline(cfg, work / "wd", device=device)
    pipe.model = case["model"]

    meta = {"soak": True, "resolution": args.size, "iters": args.iters,
            "n_frames": args.frames, "backend": device.type, **card}
    t0 = time.time()
    ev_path = work / "wd" / "events.jsonl"
    out_path = Path(args.out) if args.out else work / "E2E_SOAK_256.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    stop = threading.Event()

    def summary() -> dict:
        out = summarize(ev_path, t0, meta)
        out["cuda_max_mem_mb"] = (torch.cuda.max_memory_allocated(device) / 2 ** 20
                                  if cuda else None)
        return out

    def monitor():
        while not stop.wait(60.0):
            try:
                out_path.write_text(json.dumps(summary(), indent=2))
            except Exception as e:         # noqa: BLE001 — keep soaking
                print(f"[soak] monitor write failed: {e}", flush=True)

    watcher = threading.Thread(target=monitor, daemon=True)
    watcher.start()
    try:
        pipe.train(Path(case["path"]), iterations=args.iters)
    finally:
        stop.set()
        watcher.join(timeout=60.0)
        final = summary()
        final["completed"] = final.get("progress_iter", 0) >= args.iters
        out_path.write_text(json.dumps(final, indent=2))
        print(f"[soak] wrote {out_path}: "
              f"{json.dumps({k: final.get(k) for k in ('progress_iter', 'wall_minutes', 'rss_mb_last', 'recompiles_total', 'cuda_max_mem_mb', 'psnr_last')})}",
              flush=True)
    return final


if __name__ == "__main__":
    main()
