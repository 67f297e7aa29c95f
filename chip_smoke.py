#!/usr/bin/env python3
"""Drive the PyTorch port's render and training paths once on one CUDA card.

    python3 chip_smoke.py

Set-up: prints the card's name and power limit, builds the CUDA kernels
from omfs4d_torch/csrc with nvcc (timed).
Phase A: a full-size case made by the port itself — the synthetic 512^2
  dataset (8 frames, 5143-vertex FLAME asset, GT rendered on the card) and
  the bench-scale avatar (65,536 gaussians, SH degree 3) written as a
  trained model (point cloud + checkpoint meta with K = 256).
Phase B: a 0 mm render of frame 0 (the reference for the checks, and the
  warm-up of every shape), then the request — create_modified_dataset
  (Le Fort 5 mm, BSSO 3 mm) and render_dataset_frames, as render_prediction
  runs them (stitching is skipped: it needs an ffmpeg encoder).  The
  composite launch counter is zeroed before and read after (8 frames + the
  0 mm one); per-stage ms/frame of the request and the binning counters are
  printed.
Phase C: for every frame, the kernel against its plain PyTorch version on
  the same binning (max abs error <= 1e-4 on image and alpha), the float
  images checked (finite, alpha > 0.5 on >= 5% of pixels, equal to the
  PNGs of phase B), the 5/3 mm render held different from a 0 mm render,
  and both composites timed with CUDA events (median of 20 after warm-up).

Phase D: the training path at full width (bench.py's avatar and shapes):
  the bench avatar (65,536 alive gaussians, SH degree 3) placed in capacity
  131,072 and compacted to 73,728 (compact_to_alive), the phase-A dataset as
  the `data` dict the pipeline runner builds, FLAME co-optimization on.
  After a warm-up on a copy of the state, both launch counters are zeroed
  and AvatarTrainer.train runs 60 iterations (a densify event at 20, window
  checks, checkpoints at 15, 30, 60), then read: K2 launches must equal the
  training steps.  Printed: it/s of that run and of 20 further bare steps
  (host clock, synchronized), per-step stage laps, loss and PSNR of the
  first and last step.  Checked: loss and every parameter finite, the last
  loss below the first, one step with no host sync (it runs under
  torch.cuda.set_sync_debug_mode("error")), the final checkpoint rendered
  by render_dataset_frames.
Phase E: K2 against its plain version (autograd through composite_plain) on
  phase C's frame-0 inputs and on one training frame, with a seeded random
  cotangent on image and alpha: gradients of uv, conic, colours and opacity
  within atol 2e-4 * max|plain|, rtol 2e-3 (the reference's own bound), and
  both backwards timed with CUDA events (median of 20 after warm-up).
Phase F: the K2 ablation profiler.  Every V launch count is zeroed, then
  `omfs4d_torch.scripts.profile_composite_variants.main()` runs as a user
  runs it (K1, K2, the five modes of kernel V and the sort rows on the
  reference's seeded T = 1024, K = 512 table) and the counts are read: each
  mode must have launched.  Then, on that table and on phase E's training
  frame packed by `pack_lists` at K = 256 with phase E's seeded cotangent,
  each mode of V is held to `variant_plain` within its bound (pcv.compare),
  the bound of each bf16 mode is shown to reject `variant_plain` without
  its roundings (the control), and V and its plain version are timed beside
  K1 and K2 (their launch functions alone) on the same data (median of 20
  after warm-up).

Any failure raises and exits non-zero.  With no CUDA card the script exits
non-zero before printing any result.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# the port is imported from this script's own checkout, wherever it is run from
sys.path.insert(0, str(Path(__file__).resolve().parent))

SIZE = 512
N_FRAMES = 8
N_VERTICES = 5143
N_GAUSSIANS = 65_536
MAX_PER_TILE = 256
TILES_PER_GAUSSIAN = 16
ITERATION = 5000
LEFORT_MM, BSSO_MM = 5.0, 3.0
TOL = 1e-4
N_TIMED = 20
CAPACITY = 131_072
TRAIN_ITERS = 60
STEADY_STEPS = 20
GRAD_TOL = 2e-4, 2e-3      # atol * max|plain grad|, rtol


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bench_avatar(model, device, capacity=N_GAUSSIANS):
    """The bench-scale avatar (bench.py's recipe): the per-face textured GT
    avatar replicated to N_GAUSSIANS alive gaussians with seeded jitter,
    padded with dead slots to `capacity`."""
    from omfs4d_torch.convert import gaussians_from_numpy, to_numpy
    from omfs4d_torch.io.synthetic import textured_gt_avatar

    g0 = to_numpy(textured_gt_avatar(model))
    F = int(g0["alive"].sum())
    reps = int(np.ceil(N_GAUSSIANS / F))
    idx = np.tile(np.arange(F), reps)[:N_GAUSSIANS]
    rng = np.random.default_rng(0)
    fields = {
        "parent_face": g0["parent_face"][idx],
        "mu_local": g0["mu_local"][idx]
        + rng.normal(0, 0.3, (N_GAUSSIANS, 3)).astype(np.float32),
        "quat_local": g0["quat_local"][idx],
        "log_scale": g0["log_scale"][idx] - np.log(reps ** 0.5),
        "opacity_logit": g0["opacity_logit"][idx] - 1.5,
        "color": g0["color"][idx],
        "sh": g0["sh"][idx],
        "alive": np.ones(N_GAUSSIANS, bool),
    }
    pad = capacity - N_GAUSSIANS
    fields = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
              for k, v in fields.items()}
    fields["quat_local"][N_GAUSSIANS:, 0] = 1.0
    return gaussians_from_numpy(fields, device=device)


def training_data(model, data_dir, device):
    """The `data` dict and FLAME params the pipeline runner's train stage
    builds from a dataset (omfs4d/pipeline/runner.py:280-307)."""
    from omfs4d_torch.io.dataset import FrameDataset
    from omfs4d_torch.models.flame import flame_forward

    ds = FrameDataset(data_dir, split="train")
    T = len(ds)
    params = {k: v for k, v in ds.flame_params.items() if k != "dynamic_offset"}
    with torch.no_grad():
        verts = flame_forward(model, params)
    cams = [ds.camera(i) for i in range(T)]
    data = {
        "images": np.stack([ds.load_image(i) for i in range(T)]),
        "verts": verts,
        "w2c": np.stack([c.w2c.numpy() for c in cams]),
        **{k: np.array([float(getattr(c, k)) for c in cams], np.float32)
           for k in ("fx", "fy", "cx", "cy")},
    }
    if ds.load_mask(0) is not None:
        data["masks"] = np.stack([(ds.load_mask(i) * 255).astype(np.uint8) for i in range(T)])
    return data, params


def grad_inputs(trainer, state, data, frame):
    """The composite's inputs of one training frame (the trainer's render
    path up to the composite), detached."""
    from omfs4d_torch.models.gaussians import bind_to_mesh, eval_colors
    from omfs4d_torch.ops.camera import project_gaussians
    from omfs4d_torch.render.rasterize import bin_gaussians
    from omfs4d_torch.train.trainer import _frame_camera

    rc = trainer.render_cfg
    with torch.no_grad():
        g = state.gaussians
        means, rot, scales, opac, _ = bind_to_mesh(g, data["verts"][frame], trainer.faces)
        cam = _frame_camera(data, frame, trainer.width, trainer.height)
        cols = eval_colors(g, means, cam.position)
        proj = project_gaussians(cam, means, rot, scales)
        binning = bin_gaussians(proj, opac, trainer.width, trainer.height, rc["tile"],
                                rc["max_per_tile"], rc["max_tiles_per_gaussian"],
                                large_frac=rc["large_frac"])
    return (proj["uv"], proj["conic"], cols, opac, binning, trainer.width, trainer.height)


def seeded_cotangent(height, width, device, seed=1):
    """The seeded random cotangent of an (H, W, 3) image and (H, W) alpha."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((height, width, 3), generator=gen, device=device),
            torch.randn((height, width), generator=gen, device=device))


def composite_grads(fn, args, seed=1):
    """Gradients of uv, conic, colours and opacity under a seeded random
    cotangent on image and alpha, and a closure that reruns the backward
    alone (for timing)."""
    *inputs, binning, width, height = args
    # clones: phase C's tensors were made under inference_mode, and autograd
    # cannot save those for the backward
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    binning = type(binning)(*(t.clone() for t in binning))
    img, alpha = fn(*leaves, binning, width, height)
    dimg, dalpha = seeded_cotangent(height, width, img.device, seed)
    loss = (img * dimg).sum() + (alpha * dalpha).sum()
    grads = torch.autograd.grad(loss, leaves, retain_graph=True)
    return grads, lambda: torch.autograd.grad(loss, leaves, retain_graph=True)


def frame_inputs(model, gaussians, data_dir, device, max_tiles):
    """Per frame of a dataset: the composite's inputs exactly as the render
    path builds them (one batched FLAME forward, bind, colours, project,
    bin)."""
    from omfs4d_torch.io.dataset import FrameDataset
    from omfs4d_torch.models.flame import flame_forward
    from omfs4d_torch.models.gaussians import bind_to_mesh, eval_colors
    from omfs4d_torch.ops.camera import project_gaussians
    from omfs4d_torch.predict.render_video import batched_frame_params
    from omfs4d_torch.render.rasterize import bin_gaussians

    ds = FrameDataset(data_dir)
    verts = flame_forward(model, batched_frame_params(ds))
    for i in range(len(ds)):
        cam = ds.camera(i, device=device)
        means, rot, scales, opac, _ = bind_to_mesh(gaussians, verts[i], model.faces)
        cols = eval_colors(gaussians, means, cam.position)
        proj = project_gaussians(cam, means, rot, scales)
        binning = bin_gaussians(proj, opac, cam.width, cam.height,
                                max_per_tile=MAX_PER_TILE,
                                max_tiles_per_gaussian=max_tiles, large_frac=1.0)
        yield (proj["uv"], proj["conic"], cols, opac, binning, cam.width, cam.height)


class Recorder:
    """Keeps the trainer's per-step `train_step` events."""

    def __init__(self):
        self.steps = []

    def emit(self, event, **fields):
        if event == "train_step":
            self.steps.append(fields)


def median_ms(fn) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(N_TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def quantize(img: torch.Tensor) -> np.ndarray:
    """A float image as write_image stores it."""
    return np.clip(img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    from omfs4d_torch import _build
    from omfs4d_torch.core.timing import StageClock
    from omfs4d_torch.io.dataset import FrameDataset
    from omfs4d_torch.io.synthetic import make_synthetic_dataset
    from omfs4d_torch.io.video import read_image
    from omfs4d_torch.models.flame import flame_forward
    from omfs4d_torch.predict.render_video import render_dataset_frames
    from omfs4d_torch.predict.surgery import compute_offset, create_modified_dataset
    from omfs4d_torch.render.composite import composite, composite_plain, pack_lists
    from omfs4d_torch.scripts import profile_composite_variants as pcv
    from omfs4d_torch.render.rasterize import render_avatar_frame
    from omfs4d_torch.core.config import TrainConfig
    from omfs4d_torch.train.checkpoints import (export_point_cloud, latest_iteration,
                                                load_point_cloud, snapshot_state,
                                                trained_render_meta)
    from omfs4d_torch.train.trainer import AvatarTrainer

    device = torch.device("cuda", 0)
    card = pcv.card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ── set-up: build the kernels ───────────────────────────
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
          f"{_build.library_path().relative_to(Path(__file__).resolve().parent)}")
    print(_build.build_log().strip())

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    modified = None
    try:
        # ── phase A: the full-size case ─────────────────────
        t0 = time.perf_counter()
        case = make_synthetic_dataset(work / "data", n_frames=N_FRAMES, width=SIZE,
                                      height=SIZE, n_vertices=N_VERTICES, seed=0,
                                      device=device)
        model = case["model"]
        model_dir = work / "model"
        export_point_cloud(model_dir / "point_cloud" / f"iteration_{ITERATION}"
                           / "point_cloud.ply", bench_avatar(model, device))
        (model_dir / "checkpoints").mkdir(parents=True)
        (model_dir / "checkpoints" / f"iter_{ITERATION:07d}_meta.json").write_text(
            json.dumps({"max_per_tile": MAX_PER_TILE,
                        "max_tiles_per_gaussian": TILES_PER_GAUSSIAN}))
        print(f"phase A: {N_FRAMES} GT frames at {SIZE}^2, {model.faces.shape[0]} faces, "
              f"avatar of {N_GAUSSIANS} gaussians written in "
              f"{time.perf_counter() - t0:.2f} s")

        # ── phase B: the request, through render_prediction's stages ──
        it = latest_iteration(model_dir)
        gaussians = load_point_cloud(model_dir / "point_cloud" / f"iteration_{it}"
                                     / "point_cloud.ply", device=device)
        meta = trained_render_meta(model_dir, it)
        window = max(16, int(meta.get("max_tiles_per_gaussian", 0)) or 16)
        check(int(gaussians.alive.sum()) == N_GAUSSIANS and gaussians.sh.shape[1] == 15
              and meta["max_per_tile"] == MAX_PER_TILE, "loaded model matches phase A")
        renders = model_dir / "train" / f"ours_{it}" / "renders"

        composite.launches = 0
        # the 0 mm reference render of frame 0 comes first: it also brings
        # every kernel and allocation of the 65,536-gaussian shapes up once,
        # so the timed request below runs warm
        ds0 = FrameDataset(case["path"])
        with torch.inference_mode():
            v0 = flame_forward(model, ds0.load_frame_params(0))[0]
            img0, _ = render_avatar_frame(gaussians, v0, model.faces,
                                          ds0.camera(0, device=device), SIZE, SIZE,
                                          max_per_tile=MAX_PER_TILE,
                                          max_tiles_per_gaussian=window, large_frac=1.0)
        clock = StageClock(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        modified = create_modified_dataset(str(case["path"]), compute_offset(LEFORT_MM, 1.0),
                                           compute_offset(BSSO_MM, 1.0))
        render_dataset_frames(model, gaussians, modified, renders,
                              out_gt=renders.parent / "gt",
                              max_per_tile=int(meta["max_per_tile"]),
                              max_tiles_per_gaussian=window, clock=clock)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = composite.launches
        check(launches == N_FRAMES + 1,
              f"composite launches {launches} == {N_FRAMES} frames + 1 (0 mm)")
        totals = clock.totals_ms()
        print(f"phase B: {N_FRAMES} frames, Le Fort {LEFORT_MM} mm / BSSO {BSSO_MM} mm, "
              f"{wall_ms / N_FRAMES:.3f} ms/frame end to end (host clock, PNG and "
              f"dataset set-up included); composite launches {launches}")
        # device stages are CUDA-event laps on the stream: where the host
        # launches slower than the card runs, a lap is the launch time
        for name in ("flame", "bind_colors", "project", "bin", "composite", "png"):
            print(f"  stage {name:12s} {totals[name] / N_FRAMES:9.3f} ms/frame")
        for i, c in enumerate(clock.counters()):
            print(f"  frame {i}: binning counters {c}")
        print("  stitching skipped: no ffmpeg encoder is assumed on this machine")
        pngs = sorted(renders.glob("*.png"))
        check(len(pngs) == N_FRAMES, f"{len(pngs)} render PNGs == {N_FRAMES}")

        # ── phase C: kernel vs plain, output checks, timing ──
        errs, first = [], None
        with torch.inference_mode():
            for i, args in enumerate(frame_inputs(model, gaussians, modified, device,
                                                  window)):
                img_k, alpha_k = composite(*args)
                img_p, alpha_p = composite_plain(*args)
                err = max((img_k - img_p).abs().max().item(),
                          (alpha_k - alpha_p).abs().max().item())
                errs.append(err)
                check(err <= TOL, f"frame {i}: kernel vs plain max abs err {err} <= {TOL}")
                check(bool(torch.isfinite(img_k).all() and torch.isfinite(alpha_k).all()),
                      f"frame {i}: finite image and alpha")
                cover = (alpha_k > 0.5).float().mean().item()
                check(cover >= 0.05, f"frame {i}: alpha > 0.5 on {cover:.3f} >= 0.05 of pixels")
                blended = img_k + (1.0 - alpha_k)[..., None]
                png = read_image(pngs[i]).astype(int)
                grey = np.abs(quantize(blended).astype(int) - png).max()
                check(grey <= 1, f"frame {i}: PNG of phase B within 1 grey level ({grey})")
                print(f"  frame {i}: max abs err {err:.3e}, alpha>0.5 on {cover:.3f}, "
                      f"PNG diff {grey}")
                if i == 0:
                    first = args
                    moved = np.abs(quantize(img0).astype(int) - png)
                    check(moved.max() > 0, "5/3 mm render differs from the 0 mm render")
                    print(f"  frame 0: 5/3 mm vs 0 mm differ on {(moved.max(-1) > 0).mean():.4f} "
                          "of pixels")
            check(len(errs) == N_FRAMES, f"{len(errs)} frames compared")
            kernel_ms = median_ms(lambda: composite(*first))
            plain_ms = median_ms(lambda: composite_plain(*first))
        n_pairs = int(first[4].tile_counts.sum())
        print(f"phase C: composite at T={first[4].tile_lists.shape[0]}, K={MAX_PER_TILE}, "
              f"P=256 ({n_pairs} list entries, frame 0): kernel {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (median of {N_TIMED}); max abs err "
              f"{max(errs):.3e} over {N_FRAMES} frames [{card}]")

        # ── phase D: the training path at full width ────────
        data, flame_params = training_data(model, case["path"], device)
        cfg = TrainConfig(iterations=TRAIN_ITERS, densify_from=20, densify_interval=20,
                          opacity_reset_interval=0, batch_frames=1)
        trainer = AvatarTrainer(model.faces.cpu().numpy(), cfg, SIZE, SIZE,
                                max_per_tile=MAX_PER_TILE, flame_model=model)
        state = trainer.init_state(capacity=CAPACITY, flame_params=flame_params)
        # the bench avatar in place of the init cloud (same capacity: the
        # zero Adam moments and accumulators of init_state fit it as they are)
        state = state._replace(gaussians=bench_avatar(model, device, CAPACITY))
        state = trainer.compact_to_alive(state)
        compacted = int(np.ceil(N_GAUSSIANS * cfg.compact_slack / 1024) * 1024)   # 73,728
        check(state.gaussians.capacity == compacted
              and int(state.gaussians.alive.sum()) == N_GAUSSIANS,
              f"compacted to {state.gaussians.capacity} == {compacted} slots, "
              f"{N_GAUSSIANS} alive")
        tdata = {k: (v if torch.is_tensor(v) else torch.from_numpy(v)).to(device)
                 for k, v in data.items()}
        warm = snapshot_state(state)        # warm-up on a copy: shapes, allocator, cuBLAS
        for i in range(3):
            warm, _ = trainer.train_step(warm, tdata, [i % N_FRAMES])
        del warm
        rec = Recorder()
        train_dir = work / "train"
        composite.launches = 0
        composite.backward_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = trainer.train(data, iterations=TRAIN_ITERS, state=state,
                              output_dir=train_dir, events=rec, log_every=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_fwd, train_bwd = composite.launches, composite.backward_launches
        check(len(rec.steps) == TRAIN_ITERS, f"{len(rec.steps)} steps logged")
        check(train_bwd == TRAIN_ITERS and train_fwd == TRAIN_ITERS,
              f"K1 {train_fwd} and K2 {train_bwd} launches == {TRAIN_ITERS} training steps")
        first_m, last_m = rec.steps[0], rec.steps[-1]
        losses = [m["loss"] for m in rec.steps]
        check(all(np.isfinite(losses)), "finite losses")
        check(last_m["loss"] < first_m["loss"],
              f"loss fell: {first_m['loss']:.5f} -> {last_m['loss']:.5f}")
        params_ok = all(bool(torch.isfinite(getattr(state.gaussians, k)).all())
                        for k in ("mu_local", "quat_local", "log_scale", "opacity_logit",
                                  "color", "sh"))
        params_ok &= all(bool(torch.isfinite(v).all()) for v in state.flame_params.values())
        check(params_ok, "every gaussian and FLAME parameter finite")

        clock = StageClock(device)
        trainer.clock = clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rng = np.random.default_rng(1)
        for _ in range(STEADY_STEPS):
            state, m = trainer.train_step(state, tdata, rng.integers(0, N_FRAMES, 1))
        torch.cuda.synchronize()
        steady_s = time.perf_counter() - t0
        trainer.clock = None
        laps = clock.totals_ms()
        check(np.isfinite(float(m["loss"])), "finite loss after the steady steps")
        # one further step with every host sync made an error
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, _ = trainer.train_step(state, tdata, [0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print(f"phase D: AvatarTrainer.train, {TRAIN_ITERS} iterations at {SIZE}^2, "
              f"K={MAX_PER_TILE}, {N_GAUSSIANS} alive in capacity "
              f"{int(last_m['capacity'])} (compacted from {CAPACITY} to {compacted}; "
              f"densify at 20), FLAME co-optimization on [{card}]")
        print(f"  train(): {TRAIN_ITERS / train_s:.3f} it/s ({train_s:.3f} s, host clock, "
              f"synchronized; densify, window checks, metric reads and 3 checkpoints "
              f"included)")
        print(f"  bare steps: {STEADY_STEPS / steady_s:.3f} it/s "
              f"({steady_s / STEADY_STEPS * 1e3:.3f} ms/step over {STEADY_STEPS} steps); "
              f"a further step ran under set_sync_debug_mode('error'): no host sync")
        for name in ("flame", "bind_colors", "project", "bin", "composite", "loss",
                     "backward", "optimizer"):
            print(f"  stage {name:12s} {laps.get(name, 0.0) / STEADY_STEPS:9.3f} ms/step")
        print(f"  launches in train(): K1 {train_fwd}, K2 {train_bwd} "
              f"({TRAIN_ITERS} steps)")
        print(f"  step 1: loss {first_m['loss']:.5f} psnr {first_m['psnr']:.3f} dB; "
              f"step {TRAIN_ITERS}: loss {last_m['loss']:.5f} psnr {last_m['psnr']:.3f} dB; "
              f"alive {int(first_m['n_alive'])} -> {int(last_m['n_alive'])}")
        it_ck = latest_iteration(train_dir)
        check(it_ck == TRAIN_ITERS, f"final checkpoint iteration {it_ck}")
        trained = load_point_cloud(train_dir / "point_cloud" / f"iteration_{it_ck}"
                                   / "point_cloud.ply", device=device)
        tmeta = trained_render_meta(train_dir, it_ck)
        out = render_dataset_frames(model, trained, case["path"], train_dir / "renders",
                                    max_per_tile=int(tmeta["max_per_tile"]),
                                    max_tiles_per_gaussian=int(tmeta["max_tiles_per_gaussian"]))
        rendered = sorted(out.glob("*.png"))
        check(len(rendered) == N_FRAMES, f"{len(rendered)} renders of the trained checkpoint")
        check(read_image(rendered[0]).std() > 0, "the trained checkpoint renders an image")
        print(f"  checkpoint iteration {it_ck} ({int(trained.alive.sum())} gaussians) "
              f"rendered through render_dataset_frames: {len(rendered)} frames")

        # ── phase E: K2 against its plain version ───────────
        bwd_errs, bwd_times = [], {}
        cases = {"phase C frame 0": first,
                 "training frame 0": grad_inputs(trainer, state, tdata, 0)}
        for label, args in cases.items():
            g_k, rerun_k = composite_grads(composite, args)
            g_p, rerun_p = composite_grads(composite_plain, args)
            torch.cuda.synchronize()
            for name, a, b in zip(("uv", "conic", "colors", "opacity"), g_k, g_p):
                scale = b.abs().max().item()
                err = (a - b).abs().max().item()
                bad = ((a - b).abs() > GRAD_TOL[0] * scale + GRAD_TOL[1] * b.abs()).sum().item()
                check(bad == 0 and bool(torch.isfinite(a).all()),
                      f"{label}: K2 d{name} within atol {GRAD_TOL[0]}*{scale:.3e}, rtol "
                      f"{GRAD_TOL[1]} ({bad} outside; max abs err {err:.3e})")
                bwd_errs.append(err)
                print(f"  {label}: d{name} max abs err {err:.3e} (max |plain| {scale:.3e})")
            bwd_times[label] = (median_ms(rerun_k), median_ms(rerun_p))
            del g_p, rerun_p
            print(f"phase E: {label}: backward K2 {bwd_times[label][0]:.4f} ms, plain "
                  f"{bwd_times[label][1]:.4f} ms (median of {N_TIMED}) [{card}]")
        bwd_ms, bwd_plain_ms = bwd_times["training frame 0"]

        # ── phase F: the K2 ablation profiler, kernel V ─────
        for mode in pcv.MODES:
            pcv.launches[mode] = 0
        t0 = time.perf_counter()
        check(pcv.main() == 0, "profile_composite_variants.main() returned 0")
        v_launches = dict(pcv.launches)
        check(all(v_launches[m] > 0 for m in pcv.MODES),
              f"V launched in every mode of the profiler's run: {v_launches}")
        print(f"phase F: profile_composite_variants.main() ran in "
              f"{time.perf_counter() - t0:.2f} s; V launches {v_launches} [{card}]")
        ref_table = [torch.from_numpy(a).to(device) for a in pcv.synthetic_inputs(0)[:3]]
        uv, conic, cols, opac, tb, tw, th = cases["training frame 0"]
        dimg, d_alpha = seeded_cotangent(th, tw, device)
        tables = {
            f"reference table T={pcv.T} K={pcv.K} (identity lists)": (
                *ref_table, pcv.GRID_W,
                (*pcv.as_gaussians(ref_table[0]), pcv.GRID_W * pcv.TILE,
                 pcv.T // pcv.GRID_W * pcv.TILE,
                 *pcv.to_image(*ref_table[1:], grid_w=pcv.GRID_W))),
            f"training frame 0 K={MAX_PER_TILE} (real lists)": (
                pack_lists(uv, conic, cols, opac, tb.tile_lists, tb.tile_counts),
                *pcv.to_tiles(dimg, d_alpha), tw // pcv.TILE,
                (*cases["training frame 0"], dimg, d_alpha)),
        }
        variant_rows = {mode: [] for mode in pcv.MODES}
        print(f"phase F: bound per element, every mode but copy (exact): "
              f"{pcv.BOUND[0]:g}*s + {pcv.BOUND[1]:g}*|plain|, s its row's scale "
              f"(pcv.row_scale); the control, variant_plain without its bf16 roundings, "
              f"must fail it")
        failed = []
        for label, (packed, dcol, dalpha, grid_w, current) in tables.items():
            k1_ms, k2_ms = pcv.current_times(*current, n=N_TIMED)
            print(f"phase F: {label}: K1 {k1_ms:.4f} ms, K2 {k2_ms:.4f} ms, each through its "
                  f"launch function (median of {N_TIMED}); K2's atomics "
                  + ("never collide here" if "identity" in label else "collide here")
                  + f" [{card}]")
            for mode in pcv.MODES:
                fn = pcv.make_variant_kernel(mode)
                got = fn(packed, dcol, dalpha, grid_w=grid_w)
                ref = pcv.variant_plain(mode, packed, dcol, dalpha, grid_w=grid_w)
                res = pcv.compare(mode, got, ref, packed)
                line = (f"max abs err {res['max_abs_err']:.3e} (max |plain| "
                        f"{ref.abs().max().item():.3e}), {res['outside']} outside "
                        f"({res['share']:.3e} of the nonzero)")
                if not (res["ok"] and bool(torch.isfinite(got).all())):
                    failed.append(f"{label}: V {mode}: {line}")
                if mode in ("bf16_matmuls", "full_bf16"):
                    ctrl = pcv.compare(mode, pcv.variant_plain(mode, packed, dcol, dalpha,
                                                               grid_w=grid_w, rounded=False),
                                       ref, packed)
                    line += (f"; control: max abs err {ctrl['max_abs_err']:.3e}, "
                             f"{ctrl['outside']} outside ({ctrl['share']:.3e}), "
                             + ("passed" if ctrl["ok"] else "rejected"))
                    if ctrl["ok"]:
                        failed.append(f"{label}: the bound of {mode} passed the control")
                v_ms = pcv.timed(fn, packed, dcol, dalpha, pcv.TILE, grid_w, n=N_TIMED)
                v_plain_ms = pcv.timed(pcv.variant_plain, mode, packed, dcol, dalpha,
                                       pcv.TILE, grid_w, n=N_TIMED)
                variant_rows[mode].append((res["max_abs_err"], v_ms, v_plain_ms))
                print(f"  {mode:13s} V {v_ms:.4f} ms, plain {v_plain_ms:.4f} ms (median of "
                      f"{N_TIMED}); {line}")
            del got, ref
        check(not failed, "phase F:\n  " + "\n  ".join(failed))
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if modified is not None:
            shutil.rmtree(modified, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "composite_fwd", "route": "cuda",
        "source": "omfs4d_torch/csrc/composite_fwd.cu",
        "replaces": "omfs4d/render/pallas_kernels.py:210",
        "launches": launches + train_fwd, "max_abs_err": max(errs),
        "ms": kernel_ms, "plain_ms": plain_ms}, {
        "name": "composite_bwd", "route": "cuda",
        "source": "omfs4d_torch/csrc/composite_bwd.cu",
        "replaces": "omfs4d/render/pallas_kernels.py:305",
        "launches": train_bwd, "max_abs_err": max(bwd_errs),
        "ms": bwd_ms, "plain_ms": bwd_plain_ms}] + [{
        "name": f"composite_variant:{mode}", "route": "cuda",
        "source": "omfs4d_torch/csrc/composite_variants.cu",
        "replaces": "scripts/profile_composite_variants.py:49",
        "launches": v_launches[mode], "max_abs_err": max(r[0] for r in rows),
        "ms": rows[0][1], "plain_ms": rows[0][2]} for mode, rows in variant_rows.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
