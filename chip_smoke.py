#!/usr/bin/env python3
"""Drive the PyTorch port's render, training, tracking, video front-end and
pipeline paths once on one CUDA card.

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
  both backwards timed with CUDA events (median of 20 after warm-up).  Then
  one line per kernel, K1 (with its tile-ordering kernel, writing T_tot as in
  training) and K2, at the training frame: device us per launch
  (torch.profiler, 20 launches, through `composite` and autograd), the bound
  (`bound_us`: the FP32 instructions the function needs on this frame, from
  `pair_counts`, or its bytes, whichever takes longer) and the share of it.
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
  after warm-up).  Per mode, and for the one PyTorch call `packed * 2`:
  device us per launch (torch.profiler) warm, the table just read, and cold,
  a buffer twice the L2 written before each launch (`l2_flusher`); the share
  of the bound is taken from the cold time (warm, an 18.9 MB table stays in
  the 50 MB L2 and beats its bytes bound).  Then every mode is held to
  `variant_plain` on the hand-built table of the tests
  (`pcv.fixture_inputs`: slots that reach no pixel, singular and indefinite
  conics, capped and cut entries, a padding tile, K no multiple of 4), finite
  and with each non-finite entry of `pcv.NON_FINITE` in the middle of two
  lists (`pcv.compare_non_finite`: NaN exactly where the plain version has
  NaN).  Last, host us per call (1,000 unsynchronised calls) of K1, K2, V
  copy and `packed * 2`, and of each step of V copy's wrapper.
Phase G: the tracking path at full width (512^2 frames, the 5143-vertex
  asset with 10,282 faces, K = 256, the default TrackConfig widths: n_shape
  300, n_expr 100, texture_res 128, rgb_downsample 2 as the pipeline picks at
  >= 384 px; step counts cut, and printed).  An 8-frame clip with a static
  camera and a moving head is rendered on the card and written as PNGs with a
  landmarks.npz from the `synthetic` source; then detect_landmarks("file") ->
  landmark_preflight -> FlameTracker.fit (splat backend, uv atlas, events to
  a JSONL file) -> write_dataset with the refined focal -> FrameDataset reads
  it back.  Both launch counters are zeroed before fit and read after: K1 and
  K2 must each have launched once per rendered frame of the rgb steps.
  Checked: the landmark loss falls tenfold over the landmark stages, the
  photometric loss after fit lies below the one at landmark-only parameters,
  one rgb step and one sequential step run under
  torch.cuda.set_sync_debug_mode("error"), a track_stage event per stage, the
  contract's shapes.  K1 and K2 are held to their plain versions on frame 0's
  face splats (TOL and GRAD_TOL, as phases C and E) and timed there beside
  their bounds.  Then the mesh backend, uv and flat, 5 steps of
  rgb_init_texture each (the loss falls, no kernel launches); FLAME-fit it/s
  as the reference's bench defines it (T = 150, n_shape 100, n_expr 50,
  landmark loss + regularizers, every key an Adam group, 200 steps after a
  warm-up: host clock, CUDA events, and torch.profiler's kernel count and
  busy time per step); and ms per rgb step (B = 4, splat, 256^2) with
  StageClock laps.

Phase H: the video front end at full width (the 5143-vertex asset, 10,282 face
  splats, the nets' default widths, image_size 96, K = 128 in the sampler,
  detector batch 32, segnet batch 16; step counts cut, and printed).  K1's
  counter is zeroed, `train_detector` and then `train_segnet` run on the card
  and the counter is read after each: batch x steps launches for each net, no
  K2.  Printed: ms per sampler batch, ms per training step with and without
  the sampler, kernels and device ms per synthetic face (torch.profiler), the
  loss at the first and last step.  Checked, by the reference's own gates: the
  trained detector's held-out error on a fresh sampler batch < 0.7 x the
  untrained net's, on `shifted_eval_batch` < 0.85 x; the matting net's IoU
  against the true alpha on a fresh batch > 0.55 and > the predict-everything
  baseline + 0.1, on `shifted_eval_batch` > 0.45 and > 2 x the untrained
  net's.  K1 is held to its plain version on one sampler frame (36 tiles,
  K = 128, lists that overflow) and timed there beside its bound; one sampler
  batch and one detector step run under set_sync_debug_mode("error"); both
  nets on the card are held to themselves on the CPU.  Then the user's path:
  the 8-frame 512^2 clip as PNGs with no landmarks.npz -> Pipeline.preprocess
  -> Pipeline.track(landmark_method="neural") with border_color matting and
  the nets' weights files of the step before -> the dataset read back by
  FrameDataset with masks (K1 and K2 launches == rendered frames, detection
  error in px, preflight events, mask IoU against the rendered alpha, seconds
  per stage); the detection held to 45 px rms from the source's landmarks and
  the pipeline's fit held against phase G's fit of the same clip from the
  source's landmarks (photometric loss <= 2 x; rms distance of the posed
  landmarks from the source's <= 1.5 x the detector's own, phase G's
  printed beside it); compute_masks(method="neural") on
  the same frames; a second Pipeline.track call answered by the stage cache
  with no launch.

Phase I: the pipeline end to end at full width through the port's CLI, in
  process (`cli.main`): phase G's clip as PNG frames, `preprocess`, its
  landmarks.npz put beside the extracted frames, then `run --landmarks auto
  --iterations 1200` at Le Fort 5 mm / BSSO 3 mm (the tracker's steps cut as
  phase G cuts them; the trainer at its defaults: a gaussian per face of the
  5143-vertex asset, SH degree 3, K = 256, co-optimization on, densify every
  100 at this size: at 500 and 600), `render-surgery` at 0 mm with
  `--export-frames-dir` and `report` (the selfrecon PSNR), `render-surgery` at
  5/3 mm and `report --baseline-renders` (front psnr and psnr_unchanged).
  Checked: a stage_end event per stage, the model's artifacts, one strict row
  per exported frame, no video (no ffmpeg), K1 and K2 launches per stage (the
  tracker's rendered frames; the training iterations, to which the trainer's
  metric renders add none; one K1 a rendered frame), the loss falls,
  densification moved the cloud, the 5/3 mm frames differ from the 0 mm ones,
  the selfrecon PSNR at or above its floor.  Then `fit_shared_shape` on the
  clip as two sequences of 4 frames (landmark stages) -> ingest, register,
  `build_canonical_head` -> an asset `choose_rig_mode("hybrid_full_head")`
  takes.

    python3 chip_smoke.py --only-track
    python3 chip_smoke.py --only-nets
    python3 chip_smoke.py --only-e2e

run the set-up and phase G, H or I alone (no kernels line, no last line): for
work on the tracker, the front end or the pipeline.

    python3 chip_smoke.py --net-gates 200,240,280,320 320,400,480,560,640

trains the landmark net at each step count of the first list and the matting
net at each of the second (full width, seed 0, each count its own cosine
schedule) and reads the learning gates after each: phase H's cut step counts
are the smallest that meet them with room to spare.

    python3 chip_smoke.py --trees DIR [DIR ...]

times K1, K2 and V of other checkouts of this repository instead (for example
the parent commit unpacked with `git archive` into the git-ignored
_archive/; '.' is this one): one process per tree, in the order given, each
importing the port from its tree and building that tree's kernels.  K1 and
K2 run on the same two frames (phase C's frame 0 and the untrained training
frame 0), through `composite` and autograd alone (kernel_times, host_costs);
V, in trees that have it, runs each mode through `make_variant_kernel(mode)`
on the reference table and on that training frame packed at K = 256, warm
and with the L2 flushed before each launch (variant_times).

Any failure raises and exits non-zero.  With no CUDA card the script exits
non-zero before printing any result.  The line before the card's name holds
every kernel's launches (the sum over phases B, D, G, H and I for K1 and K2,
with each path's own under `launches_by_path`, the launches of one tracker rgb step
under `launches_per_tracker_step` and of one detector step under
`launches_per_detector_step`), error, ms, plain_ms, bound_ms (with
bound_by) and library_ms (one PyTorch call for the same function: `packed * 2` for V's
copy mode, none for the others).  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import statistics
import subprocess
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
N_HOST = 1000             # calls per host-time measurement
PROFILE_TRIES = 6         # torch.profiler traces per device time, until one holds the kernel
CAPACITY = 131_072
TRAIN_ITERS = 60
STEADY_STEPS = 20
GRAD_TOL = 2e-4, 2e-3      # atol * max|plain grad|, rtol
# phase G: the tracker's schedule with its step counts cut (the widths are
# the defaults), and the reference bench's FLAME-fit shape
TRACK_STEPS = dict(steps_lmk_init_rigid=100, steps_lmk_init_all=100,
                   steps_rgb_init_texture=20, steps_rgb_init_all=20,
                   steps_rgb_init_offset=10, steps_rgb_sequential=3,
                   steps_global=20, epochs_global=1)
RGB_BATCH = 4
MESH_STEPS = 5
FIT_FRAMES, FIT_SHAPE, FIT_EXPR, FIT_STEPS, FIT_WARMUP = 150, 100, 50, 200, 20
RGB_TIMED_STEPS = 10
# phase H: the nets' training at their default widths, the step counts cut to
# the smallest that meet the reference's learning gates with room to spare at
# full width (`--net-gates`; the reference's own tests train 160 and 240
# steps, on a 700-vertex asset whose faces fit K = 128: here they do not).
# The detector's held-out error is 0.708 x the untrained net's after 320 steps
# (the gate is 0.7) and 0.663 x after 400; the matting net's IoU 0.573 after
# 560 steps (the gate is 0.55) and 0.626 after 640 (NVIDIA H100 80GB HBM3,
# 700 W; 128 fresh sampler faces, seed 0).
NET_SIZE, NET_K = 96, 128
DET_BATCH, SEG_BATCH = 32, 16
DET_STEPS, SEG_STEPS = 400, 640      # defaults 1500 and 800
HELD_OUT = 128
NET_TIMED = 5
# the user path's landmarks and the fit from them: the detector's rms distance
# from the source's landmarks on the SIZE^2 clip (an untrained net is ~100 px
# off); the fit's photometric loss as a multiple of the one of phase G's fit
# from the source's landmarks; the rms distance of its posed landmarks from the
# source's as a multiple of the detector's own (the fit must not drift from
# what it was given).  Phase G's posed landmarks are printed beside them and
# not used: at the cut step counts they scatter 9.6-20.6 px between runs.
DETECTION_RMS_PX, NEURAL_FIT_PHOTO, NEURAL_FIT_LMK = 45.0, 2.0, 1.5
# phase I: the CLI's `run` on phase G's clip with 1,200 iterations, enough for
# the pipeline's hires densify cadence (every 100 at >= 384 px, from 500 until
# half the run) to fire at 500 and 600.  The selfrecon PSNR's floor sits more
# than 3 dB under the lowest measured: 36.40 dB over the 8 frames, 34.63 on the
# worst one (NVIDIA H100 80GB HBM3, 700 W)
E2E_ITERS, E2E_DENSIFY_INTERVAL = 1200, 100
E2E_PSNR_FLOOR = 32.0

# The bound of a kernel: the larger of its FP32 instructions over the card's
# issue rate and its bytes over its memory rate.  NVIDIA H100 SXM: 67 TFLOP/s
# FP32 outside the tensor cores, an FMA counted as 2 (so 33.5 T instructions
# a second), 3.35 TB/s.  Only the work the function needs is counted, on
# this run's data (`pair_counts`): the alpha of composite_common.cuh, ~16
# instructions, at each (pixel, entry) pair whose pixel lies in the entry's
# reach box (elsewhere a = 0 without evaluating it); the running step, ~6,
# only at live pairs (a > 0: at a = 0 it is the identity); and at live
# pairs K2's chain ~35 and its share of the sums ~9.  Bytes: each input read
# once, each output written once.
FP32_INSTR_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
ALPHA_OPS, STEP_OPS, CHAIN_OPS, SUM_OPS = 16, 6, 35, 9


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


def l2_flusher(device):
    """A function that writes a buffer twice the size of an H100's 50 MB L2
    cache: what the next kernel reads then comes from device memory (a cold
    launch, as a caller finds it whose table was not just read)."""
    buf = torch.empty(2 * 50 * 2 ** 20 // 4, dtype=torch.float32, device=device)
    return buf.zero_


def median_ms(fn, before=None) -> float:
    """Median CUDA-event ms of N_TIMED calls of fn after 3 warm-ups; `before`
    (an `l2_flusher`) runs ahead of each call, outside the events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(N_TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_us(fn, *kernels: str, before=None) -> dict[str, float]:
    """Device us per launch of each named kernel (torch.profiler, N_TIMED
    calls of fn); 0.0 for a name after the first that did not run.  A trace
    now and then comes back without the first kernel's launches, or a launch
    short: the mean is over the launches it holds when they are at least
    three in four, else the trace is taken again, up to PROFILE_TRIES tries.
    `before` (an `l2_flusher`, whose fill kernel is left out) runs ahead of
    each call: the cold time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(N_TIMED):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        per = {}
        for evt in prof.key_averages():
            for name in kernels:
                if (name in evt.key and "FillFunctor" not in evt.key
                        and N_TIMED * 3 // 4 <= evt.count <= N_TIMED):
                    total = getattr(evt, "device_time_total", None)
                    per[name] = (evt.cuda_time_total if total is None else total) / evt.count
        if kernels[0] in per:
            return {name: per.get(name, 0.0) for name in kernels}
    seen = [(evt.key[:60], evt.count) for evt in prof.key_averages()]
    raise RuntimeError(f"check failed: {kernels[0]} not in {PROFILE_TRIES} profiles of "
                       f"{N_TIMED} launches; the last one holds {seen}")


def kernel_times(args) -> dict:
    """K1's and K2's times on one frame, through `composite` and autograd
    alone, as a training step runs them (so any commit of the port since its
    trainer can be measured alike): device us per launch (torch.profiler),
    K1's with the tile-ordering kernel its launch also starts where the port
    has one, and CUDA-event ms per call (median of N_TIMED)."""
    from omfs4d_torch.render.composite import composite

    *inputs, binning, width, height = args
    leaves = [t.detach().clone().requires_grad_() for t in inputs]

    def fwd():
        return composite(*leaves, binning, width, height)

    _, bwd = composite_grads(composite, args)
    k1 = device_us(fwd, "composite_fwd_kernel", "heavy_first_kernel")
    k2 = device_us(bwd, "composite_bwd_kernel")
    return {"k1_us": k1["composite_fwd_kernel"] + k1["heavy_first_kernel"],
            "k1_kernel_us": k1["composite_fwd_kernel"], "order_us": k1["heavy_first_kernel"],
            "k2_us": k2["composite_bwd_kernel"], "k1_ms": median_ms(fwd), "k2_ms": median_ms(bwd)}


def variant_times(pcv, packed, dcol, dalpha, grid_w, flush) -> dict:
    """Per mode of V through `make_variant_kernel(mode)` on one table: device
    us per launch warm (the table just read: 20 launches in a row) and cold
    (the L2 flushed before each), torch.profiler, and CUDA-event ms per call;
    under "packed_x2" the same for the one PyTorch call `packed * 2`, copy's
    yardstick (device us None where the profile does not name its kernel)."""
    out = {}
    for mode in pcv.MODES:
        fn = pcv.make_variant_kernel(mode)

        def call():
            return fn(packed, dcol, dalpha, pcv.TILE, grid_w)

        out[mode] = {"us": device_us(call, "composite_variant")["composite_variant"],
                     "cold_us": device_us(call, "composite_variant",
                                          before=flush)["composite_variant"],
                     "ms": median_ms(call), "cold_ms": median_ms(call, before=flush)}

    def library():
        return packed * 2.0

    lib = {"ms": median_ms(library), "cold_ms": median_ms(library, before=flush)}
    for key, before in (("us", None), ("cold_us", flush)):
        try:
            lib[key] = device_us(library, "elementwise_kernel",
                                 before=before)["elementwise_kernel"]
        except RuntimeError:
            lib[key] = None
    out["packed_x2"] = lib
    return out


def host_us(fn) -> float:
    """Host us per call over N_HOST calls with no synchronisation between them."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_HOST):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / N_HOST * 1e6


def host_costs(args) -> dict:
    """Host us per call, through the public calls: K1 (`composite` under
    inference_mode) and K2 (autograd.grad through `composite`) on the first
    non-empty tile of a frame, V copy and `packed * 2` on the profiler's
    reference table."""
    from omfs4d_torch.render.composite import composite
    from omfs4d_torch.scripts import profile_composite_variants as pcv

    *inputs, b, _, _ = args
    keep = int((b.tile_counts > 0).nonzero()[0, 0])
    tiny = (*inputs, b._replace(tile_lists=b.tile_lists[keep:keep + 1].contiguous(),
                                tile_counts=b.tile_counts[keep:keep + 1].contiguous()), 16, 16)
    with torch.inference_mode():
        k1 = host_us(lambda: composite(*tiny))
    _, k2 = composite_grads(composite, tiny)
    packed, dcol, dalpha = (torch.from_numpy(a).to(inputs[0].device)
                            for a in pcv.synthetic_inputs(0)[:3])
    copy = pcv.make_variant_kernel("copy")
    return {"k1": k1, "k2": host_us(k2), "v_copy": host_us(lambda: copy(packed, dcol, dalpha)),
            "packed_x2": host_us(lambda: packed * 2.0)}


def v_copy_host_parts(packed, dcol, dalpha) -> dict:
    """Where the host time of V copy's wrapper goes: each of its steps alone,
    host us per call."""
    from omfs4d_torch.scripts import profile_composite_variants as pcv

    kernel = pcv._kernel()
    dst = torch.empty_like(packed)
    ptrs = (packed.data_ptr(), dcol.data_ptr(), dalpha.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    return {
        "check_inputs": host_us(lambda: pcv._check_inputs(packed, dcol, dalpha, 16, 32)),
        "empty_like": host_us(lambda: torch.empty_like(packed)),
        "current_device": host_us(torch.cuda.current_device),
        "raw_stream": host_us(lambda: torch._C._cuda_getCurrentRawStream(0)),
        "current_stream": host_us(lambda: torch.cuda.current_stream().cuda_stream),
        "data_ptr_x4": host_us(lambda: (packed.data_ptr(), dcol.data_ptr(),
                                        dalpha.data_ptr(), dst.data_ptr())),
        "ctypes_launch": host_us(lambda: kernel(0, *ptrs, packed.shape[0], packed.shape[2],
                                                16, 32, dst.data_ptr(), stream)),
    }


def pair_counts(packed: torch.Tensor, width: int, height: int, grid_w: int,
                tile: int = 16) -> tuple[int, int]:
    """(pixel, slot) pairs of a packed (T, 9, K) table, at pixels inside the
    image: those whose pixel centre lies in the entry's reach box (K1's
    `reach_of`: every pixel for a non-finite or ill-conditioned entry, none
    below the 1/255 opacity; outside the box a = 0), and the live ones
    (a > 0).  Opacity is 0 past each count, so padding adds none."""
    from omfs4d_torch.render.rasterize import ALPHA_CAP, ALPHA_CUTOFF

    p = torch.arange(tile * tile, device=packed.device)
    reached = live = 0
    for s in range(0, packed.shape[0], 32):
        rows = packed[s:s + 32]
        t = torch.arange(s, s + rows.shape[0], device=packed.device)[:, None]
        px, py = (t % grid_w) * tile + p % tile, (t // grid_w) * tile + p // tile
        inside = ((px < width) & (py < height))[..., None]
        ux, uy, ca, cb, cc, *_, o = (rows[:, None, i] for i in range(9))
        dx = (px.float() + 0.5)[..., None] - ux
        dy = (py.float() + 0.5)[..., None] - uy
        power = torch.clamp_max(-0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy, 0.0)
        a = torch.clamp_max(o * torch.exp(power), ALPHA_CAP)
        live += int(((a >= ALPHA_CUTOFF) & inside).sum())
        # K1's reach_of, in its order of tests
        finite = torch.isfinite(rows.sum(1))[:, None]
        det = ca * cc - cb * cb
        wide = ~((ca > 0) & (cc > 0) & (det > 1e-3 * ca * cc))
        level = 2.04 * torch.log(255.0 * o) + 1e-3
        in_box = ((dx.abs() <= torch.sqrt(level * cc / det) + 1.0)
                  & (dy.abs() <= torch.sqrt(level * ca / det) + 1.0))
        reach = ~finite | ((o >= ALPHA_CUTOFF) & (wide | in_box))
        reached += int((reach & inside).sum())
    return reached, live


def bound_us(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time for `ops` FP32 instructions and `nbytes` of traffic."""
    t_ops, t_bytes = ops / FP32_INSTR_PER_S * 1e6, nbytes / HBM_BYTES_PER_S * 1e6
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def composite_bounds(args, packed, residual: bool = True) -> dict:
    """K1's and K2's bounds (us, what sets it) on one frame's inputs, from
    its pairs in reach and its live pairs (`pair_counts`).  `residual`: K1
    also writes T_tot (as under autograd; not under no_grad)."""
    uv, _, _, _, binning, width, height = args
    entries = int(binning.tile_counts.sum())
    reached, live = pair_counts(packed, width, height, (width + 15) // 16)
    list_bytes = entries * (9 + 1) * 4 + binning.tile_lists.shape[0] * 4
    pixels = width * height
    k1 = bound_us(reached * ALPHA_OPS + live * STEP_OPS,
                  list_bytes + pixels * (3 + 1 + int(residual)) * 4)
    k2 = bound_us(reached * ALPHA_OPS + live * (STEP_OPS + CHAIN_OPS + SUM_OPS),
                  list_bytes + pixels * (3 + 1 + 3 + 1) * 4 + uv.shape[0] * 9 * 4)
    return {"composite_fwd": k1, "composite_bwd": k2, "in_lists": entries * 256,
            "reached": reached, "live": live}


def variant_bound(mode: str, packed, grid_w: int) -> tuple[float, str]:
    """V's bound on a packed (T, 9, K) table: copy moves the table twice;
    every other mode computes K2's function on it (the same counts as K2's
    bound, `pair_counts`) and reads dcol and dalpha."""
    T = packed.shape[0]
    nbytes = 2 * packed.numel() * 4
    if mode == "copy":
        return bound_us(0, nbytes)
    reached, live = pair_counts(packed, grid_w * 16, T // grid_w * 16, grid_w)
    return bound_us(reached * ALPHA_OPS + live * (STEP_OPS + CHAIN_OPS + SUM_OPS),
                    nbytes + T * 4 * 256 * 4)


def quantize(img: torch.Tensor) -> np.ndarray:
    """A float image as write_image stores it."""
    return np.clip(img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)


def tracking_clip(model, device, work: Path):
    """An 8-frame 512^2 clip with a static camera and a moving head, rendered
    on the card by the textured ground-truth avatar and written as PNGs with
    a landmarks.npz from the `synthetic` source.  Returns (images dir, camera,
    the rendered alpha > 0.5 per frame)."""
    from omfs4d_torch.io.synthetic import (animated_flame_params, orbit_c2w_nerf,
                                           textured_gt_avatar)
    from omfs4d_torch.io.video import write_image
    from omfs4d_torch.models.flame import flame_forward
    from omfs4d_torch.ops.camera import camera_from_nerf
    from omfs4d_torch.render.rasterize import render_avatar_frame
    from omfs4d_torch.track.landmarks import detect_landmarks, save_landmarks

    cam = camera_from_nerf(orbit_c2w_nerf(1)[0], SIZE * 1.8, SIZE * 1.8, SIZE / 2, SIZE / 2,
                           SIZE, SIZE, device=device)
    gt = animated_flame_params(N_FRAMES, model.n_vertices, jaw_amp=0.1)
    gt["translation"][:, 0] += 0.01
    avatar = textured_gt_avatar(model, seed=0)
    images = work / "capture" / "images"
    images.mkdir(parents=True)
    alphas = []
    with torch.inference_mode():
        verts = flame_forward(model, gt)
        for i in range(N_FRAMES):
            img, aux = render_avatar_frame(avatar, verts[i], model.faces, cam, SIZE, SIZE,
                                           max_per_tile=MAX_PER_TILE, large_frac=1.0)
            write_image(images / f"{i:05d}.png", quantize(img))
            alphas.append((aux["alpha"] > 0.5).cpu().numpy())
    lmk, valid = detect_landmarks(None, method="synthetic", model=model, params=gt, cameras=cam)
    save_landmarks(images / "landmarks.npz", lmk, valid)
    return images, cam, np.stack(alphas)


def tracker_params(tracker, result, n_frames: int) -> dict:
    """The tracker's parameter dict of a TrackerResult (the contract's padding
    cut off, the texture back in logits)."""
    cfg = tracker.cfg
    p = tracker.init_params(n_frames)
    for k in p:
        if k in ("shape", "expr"):
            n = cfg.n_shape if k == "shape" else cfg.n_expr
            p[k] = torch.from_numpy(result.params[k][..., :n]).to(tracker.device)
        elif k in result.params:
            p[k] = torch.from_numpy(result.params[k]).to(tracker.device)
    tex = np.clip(result.texture, 1e-3, 1 - 1e-3)
    p["texture"] = torch.from_numpy(np.log(tex / (1 - tex)).astype(np.float32)).to(tracker.device)
    p["focal_log_scale"] = torch.tensor(np.float32(np.log(result.focal_scale))).to(tracker.device)
    return p


def tracker_frame_inputs(tracker, p: dict, frame: int):
    """The composite's inputs of one tracker frame (the splat backend's
    render path up to the composite), detached."""
    from omfs4d_torch.models.flame import flame_forward
    from omfs4d_torch.models.gaussians import bind_to_mesh
    from omfs4d_torch.ops.camera import project_gaussians
    from omfs4d_torch.render.rasterize import bin_gaussians
    from omfs4d_torch.render.texture import bilinear_sample, face_center_uv
    from omfs4d_torch.track.fitter import _texture_avatar

    model = tracker.model
    with torch.no_grad():
        verts = flame_forward(model, tracker._flame_args(p))
        logits = bilinear_sample(p["texture"], face_center_uv(model.uv_coords, model.faces))
        means, rot, scales, opac, cols = bind_to_mesh(_texture_avatar(model, logits),
                                                      verts[frame], model.faces)
        proj = project_gaussians(tracker._scaled_camera(tracker.p_camera, p), means, rot, scales)
        binning = bin_gaussians(proj, opac, tracker.p_width, tracker.p_height, tracker.tile,
                                tracker.max_per_tile, large_frac=1.0)
    return (proj["uv"], proj["conic"], cols, opac, binning, tracker.p_width, tracker.p_height)


def hold_composite(label: str, args) -> tuple[float, float]:
    """K1 and K2 against their plain versions on one frame's inputs: image
    and alpha within TOL, the four gradients within GRAD_TOL under the
    seeded cotangent.  Returns (K1's, K2's) max abs error."""
    from omfs4d_torch.render.composite import composite, composite_plain

    with torch.no_grad():
        img_k, alpha_k = composite(*args)
        img_p, alpha_p = composite_plain(*args)
    err = max((img_k - img_p).abs().max().item(), (alpha_k - alpha_p).abs().max().item())
    check(err <= TOL and bool(torch.isfinite(img_k).all()),
          f"{label}: K1 vs plain max abs err {err} <= {TOL}")
    g_k, _ = composite_grads(composite, args)
    g_p, _ = composite_grads(composite_plain, args)
    worst = 0.0
    for name, a, b in zip(("uv", "conic", "colors", "opacity"), g_k, g_p):
        scale = b.abs().max().item()
        bad = ((a - b).abs() > GRAD_TOL[0] * scale + GRAD_TOL[1] * b.abs()).sum().item()
        check(bad == 0 and bool(torch.isfinite(a).all()),
              f"{label}: K2 d{name} within atol {GRAD_TOL[0]}*{scale:.3e}, rtol {GRAD_TOL[1]} "
              f"({bad} outside)")
        worst = max(worst, (a - b).abs().max().item())
    return err, worst


def profiled_kernels(fn, steps: int) -> tuple[float, float]:
    """(kernel launches, device busy ms) per call of fn over `steps` calls
    (torch.profiler: every CUDA kernel and memset/memcpy it records)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    count = busy_us = 0
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        total = evt.cuda_time_total if total is None else total
        if total > 0:
            count += evt.count
            busy_us += total
    return count / steps, busy_us / steps / 1e3


def phase_g(model, device, card: str, work: Path) -> dict:
    """The tracking path at full width; returns K1's and K2's launches in
    FlameTracker.fit and in one rgb step."""
    import dataclasses

    from omfs4d_torch.core.config import TrackConfig
    from omfs4d_torch.core.logging import EventLogger
    from omfs4d_torch.core.timing import StageClock
    from omfs4d_torch.io.dataset import FrameDataset, write_dataset
    from omfs4d_torch.models.flame import flame_forward
    from omfs4d_torch.render.composite import composite, pack_lists
    from omfs4d_torch.track.fitter import FlameTracker
    from omfs4d_torch.track.landmarks import _load_frames, detect_landmarks
    from omfs4d_torch.track.preflight import landmark_preflight
    from omfs4d_torch.train.trainer import adam_init

    t_phase = time.perf_counter()
    images, cam, _ = tracking_clip(model, device, work)

    # ── landmarks -> preflight -> fit -> dataset, as the pipeline's track stage ──
    frames = _load_frames(images)
    T, H, W = frames.shape[:3]
    lmk, valid = detect_landmarks(images, method="file")
    report = landmark_preflight(lmk, valid, W, H)
    check(report.ok, f"landmark preflight passes: {report.reasons}")
    cfg = TrackConfig(**TRACK_STEPS)
    if cfg.rgb_downsample == 1 and max(W, H) >= 384:
        cfg = dataclasses.replace(cfg, rgb_downsample=2)
    check((cfg.n_shape, cfg.n_expr, cfg.texture_res, cfg.photometric_backend, cfg.texture_mode)
          == (300, 100, 128, "splat", "uv"), "default TrackConfig widths and backend")
    tracker = FlameTracker(model, cfg, cam, (W, H), max_per_tile=MAX_PER_TILE)
    check(tracker.device == device, f"the tracker took the card ({tracker.device})")
    data = {"landmarks": torch.from_numpy(lmk).to(device),
            "valid": torch.from_numpy(valid).to(device),
            "frames": tracker._prep_frames(frames)}
    B = min(RGB_BATCH, T)
    # warm-up on throwaway parameters: shapes, allocator, cuBLAS handles
    warm = tracker.init_params(T)
    rgb_keys = ("shape", "expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose",
                "translation", "texture", "static_offset")
    warm_opt = {k: adam_init({k: warm[k]}) for k in rgb_keys}
    for i in range(2):
        tracker._stage_step(warm, warm_opt, data, [i, 1, 2, 3][:B], 0.3, 1.0)
    with torch.no_grad():
        lmk_init = float(tracker._landmark_loss(tracker.init_params(T), data["landmarks"],
                                                data["valid"]))
    events_path = work / "track_events.jsonl"
    composite.launches = 0
    composite.backward_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = tracker.fit(lmk, valid, frames=frames, events=EventLogger(events_path))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_fwd, fit_bwd = composite.launches, composite.backward_launches
    rgb_steps = (cfg.steps_rgb_init_texture + cfg.steps_rgb_init_all + cfg.steps_rgb_init_offset
                 + cfg.steps_global * cfg.epochs_global)
    rendered = B * rgb_steps + T * cfg.steps_rgb_sequential
    check(fit_fwd == rendered and fit_bwd == rendered,
          f"K1 {fit_fwd} and K2 {fit_bwd} launches == {rendered} rendered frames "
          f"({B} x {rgb_steps} rgb steps + {T} x {cfg.steps_rgb_sequential} sequential)")
    stages = [json.loads(line) for line in events_path.read_text().splitlines()]
    names = [s["stage"] for s in stages if s["event"] == "track_stage"]
    want = ["lmk_init_rigid", "lmk_init_all", "rgb_init_texture", "rgb_init_all",
            "rgb_init_offset", "rgb_sequential_tracking", "global_optimization_0"]
    check(names == want, f"a track_stage event per stage: {names}")
    check(all(np.isfinite(s["loss"]) for s in stages), "finite stage losses")
    lmk_end = stages[1]["loss"]
    check(lmk_end * 10 <= lmk_init,
          f"landmark loss fell tenfold over the landmark stages: {lmk_init:.6f} -> "
          f"{lmk_end:.6f} (with regularizers)")
    V = model.n_vertices
    shapes = {k: result.params[k].shape for k in ("shape", "expr", "static_offset",
                                                  "dynamic_offset")}
    check(shapes == {"shape": (300,), "expr": (T, 100), "static_offset": (1, V, 3),
                     "dynamic_offset": (T, V, 3)}, f"contract shapes: {shapes}")
    check(all(np.isfinite(v).all() for v in result.params.values())
          and np.isfinite(result.texture).all(), "finite exported parameters and texture")

    # photometric loss at landmark-only parameters (grey texture) and after fit
    lmk_only = FlameTracker(model, dataclasses.replace(cfg, photometric=False), cam, (W, H),
                            max_per_tile=MAX_PER_TILE).fit(lmk, valid)
    every = list(range(T))
    with torch.no_grad():
        p_lmk = tracker_params(tracker, lmk_only, T)
        p_lmk["texture"] = torch.zeros_like(p_lmk["texture"])
        photo_lmk = float(tracker._photometric_loss(p_lmk, data["frames"], every))
        p_fit = tracker_params(tracker, result, T)
        photo_fit = float(tracker._photometric_loss(p_fit, data["frames"], every))
    check(photo_fit < photo_lmk, f"photometric loss after fit {photo_fit:.5f} < "
          f"{photo_lmk:.5f} at the landmark-only parameters")

    # one rgb step and one sequential step with every host sync made an error
    step_opt = {k: adam_init({k: p_fit[k]}) for k in rgb_keys}
    fixed = {k: (v if k in ("shape", "texture", "static_offset", "focal_log_scale")
                 else v[:1]) for k, v in p_fit.items() if k != "rotation"}
    row = {"rotation": p_fit["rotation"][0].clone()}
    frame = {k: v[:1] for k, v in data.items()}
    before = composite.launches, composite.backward_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tracker._stage_step(p_fit, step_opt, data, [0, 1, 2, 3][:B], 0.3, 1.0)
        step_launches = (composite.launches - before[0],
                         composite.backward_launches - before[1])
        moved = tracker._row_step(row, adam_init(row), fixed, frame, 0.3, 1.0, cfg.lr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(moved and step_launches == (B, B),
          f"one rgb step launched K1 and K2 {step_launches} == ({B}, {B}) times; it and a "
          "sequential step made no host sync")

    # the dataset, with the refined focal, as the pipeline's track stage writes it
    c2w = np.linalg.inv(cam.w2c.cpu().numpy().astype(np.float64))
    c2w[:3, 1:3] *= -1.0
    with torch.no_grad():
        verts0 = flame_forward(model, {k: v for k, v in result.params.items()
                                       if k != "dynamic_offset"})[0]
    fl = float(cam.fx) * result.focal_scale
    out = write_dataset(work / "tracked", frames, np.tile(c2w[None], (T, 1, 1)), fl,
                        float(cam.fy) * result.focal_scale, float(cam.cx), float(cam.cy),
                        flame_params=result.params, points3d=verts0.cpu().numpy(),
                        n_verts=V)
    ds = FrameDataset(out, split="train")
    check(len(ds) == T - T // 10 and ds.flame_params["expr"].shape == (T, 100)
          and abs(ds.intrinsics["fl_x"] - fl) < 1e-6 * fl
          and np.array_equal(ds.load_image(0), frames[0])
          and ds.points3d().shape == (V, 3), "the tracked dataset reads back")
    print(f"phase G: FlameTracker.fit, {T} frames at {W}x{H} (photometric at "
          f"{tracker.p_width}x{tracker.p_height}), {model.faces.shape[0]} face splats, "
          f"K={MAX_PER_TILE}, n_shape {cfg.n_shape}, n_expr {cfg.n_expr}, texture "
          f"{cfg.texture_res}^2, splat/uv; steps {TRACK_STEPS} [{card}]")
    print(f"  fit(): {fit_s:.3f} s (host clock, synchronized); stages: "
          + ", ".join(f"{s['stage']} {s['steps']} steps {s['seconds']} s loss {s['loss']:.5f}"
                      for s in stages))
    print(f"  landmark loss {lmk_init:.6f} -> {lmk_end:.6f} over the landmark stages, "
          f"{result.losses['landmark']:.6f} after fit; focal x{result.focal_scale:.4f}; "
          f"photometric loss {photo_lmk:.5f} at landmark-only parameters -> "
          f"{photo_fit:.5f} after fit")
    print(f"  launches in fit(): K1 {fit_fwd}, K2 {fit_bwd} ({rendered} rendered frames); "
          f"one rgb step: K1 {step_launches[0]}, K2 {step_launches[1]}; dataset written "
          f"with fl_x {fl:.2f} and read back ({len(ds)} train frames)")

    # K1 and K2 against their plain versions at the tracker's own shapes
    targs = tracker_frame_inputs(tracker, tracker_params(tracker, result, T), 0)
    err_k1, err_k2 = hold_composite("tracker frame 0", targs)
    times = kernel_times(targs)
    tb = targs[4]
    bounds = composite_bounds(targs, pack_lists(*targs[:4], tb.tile_lists, tb.tile_counts))
    print(f"  tracker frame 0 ({targs[0].shape[0]} face splats, "
          f"{int(tb.tile_counts.sum())} list entries at {tracker.p_width}x{tracker.p_height}, "
          f"{bounds['reached']} pairs in reach, {bounds['live']} live): K1 vs plain max abs "
          f"err {err_k1:.3e}, K2 {err_k2:.3e}; device us a launch (torch.profiler, {N_TIMED} "
          f"launches): K1 {times['k1_us']:.2f} (kernel {times['k1_kernel_us']:.2f} + ordering "
          f"{times['order_us']:.2f}; bound {bounds['composite_fwd'][0]:.2f}, "
          f"{bounds['composite_fwd'][1]}), K2 {times['k2_us']:.2f} (bound "
          f"{bounds['composite_bwd'][0]:.2f}, {bounds['composite_bwd'][1]}); CUDA-event ms "
          f"K1 {times['k1_ms']:.4f}, K2 {times['k2_ms']:.4f} [{card}]")

    # ── the mesh backend: plain PyTorch, no kernel ──
    for mode in ("uv", "flat"):
        mcfg = dataclasses.replace(cfg, photometric_backend="mesh", texture_mode=mode)
        mtracker = FlameTracker(model, mcfg, cam, (W, H), max_per_tile=MAX_PER_TILE)
        p0 = tracker_params(tracker, lmk_only, T)
        p0["texture"] = torch.zeros(mtracker._texture_shape(), device=device)
        before = composite.launches, composite.backward_launches
        with torch.no_grad():
            first = float(mtracker._photometric_loss(p0, data["frames"], every[:B]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p1 = mtracker._run_stage("rgb_init_texture", p0, MESH_STEPS, ("texture",), 0.0, 1.0,
                                 data, EventLogger())
        torch.cuda.synchronize()
        mesh_ms = (time.perf_counter() - t0) / MESH_STEPS * 1e3
        with torch.no_grad():
            last = float(mtracker._photometric_loss(p1, data["frames"], every[:B]))
        check(np.isfinite(last) and last < first,
              f"mesh/{mode}: photometric loss fell over {MESH_STEPS} texture steps: "
              f"{first:.5f} -> {last:.5f}")
        check((composite.launches, composite.backward_launches) == before,
              f"mesh/{mode}: K1 and K2 launch counts did not move")
        print(f"  mesh/{mode}: {MESH_STEPS} rgb_init_texture steps, {mesh_ms:.3f} ms/step "
              f"(host clock, the first step included), loss {first:.5f} -> {last:.5f}, "
              f"K1/K2 launches 0 [{card}]")
        del mtracker, p0, p1
    torch.cuda.empty_cache()

    # ── FLAME-fit it/s, as the reference's bench defines it ──
    fcfg = TrackConfig(n_shape=FIT_SHAPE, n_expr=FIT_EXPR, photometric=False)
    ftracker = FlameTracker(model, fcfg, cam, (W, H), max_per_tile=MAX_PER_TILE)
    fp = ftracker.init_params(FIT_FRAMES)
    fdata = {"landmarks": torch.full((FIT_FRAMES, model.lmk_faces_idx.shape[0], 2), W / 2.0,
                                     device=device),
             "valid": torch.ones(FIT_FRAMES, dtype=torch.bool, device=device), "frames": None}
    fopt = {k: adam_init({k: v}) for k, v in fp.items()}       # every key an Adam group

    def fit_step():
        return ftracker._stage_step(fp, fopt, fdata, [0], 1.0, 0.0)

    for _ in range(FIT_WARMUP):
        fit_step()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(FIT_STEPS):
        loss = fit_step()
    end.record()
    torch.cuda.synchronize()
    fit_host_s = time.perf_counter() - t0
    fit_dev_ms = start.elapsed_time(end) / FIT_STEPS
    check(bool(torch.isfinite(loss)), "finite FLAME-fit loss")
    n_kernels, busy_ms = profiled_kernels(fit_step, 20)
    print(f"  FLAME-fit: {FIT_STEPS / fit_host_s:.3f} it/s (T={FIT_FRAMES}, n_shape {FIT_SHAPE}, "
          f"n_expr {FIT_EXPR}, landmark loss + regularizers, 11 Adam groups; {FIT_STEPS} steps "
          f"after {FIT_WARMUP}, host clock, synchronized at both ends: "
          f"{fit_host_s / FIT_STEPS * 1e3:.3f} ms/step); {fit_dev_ms:.3f} ms/step between CUDA "
          f"events; {n_kernels:.0f} kernels and {busy_ms:.3f} ms of device time a step "
          f"(torch.profiler, 20 steps) [{card}]")
    del ftracker, fp, fopt, fdata

    # ── ms per rgb step, with its laps ──
    p_rgb = tracker_params(tracker, result, T)
    rgb_opt = {k: adam_init({k: p_rgb[k]}) for k in rgb_keys}
    rng = np.random.default_rng(0)
    clock = StageClock(device)
    tracker.clock = clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RGB_TIMED_STEPS):
        tracker._stage_step(p_rgb, rgb_opt, data, rng.integers(0, T, size=(B,)).tolist(),
                            0.3, 1.0)
    torch.cuda.synchronize()
    rgb_ms = (time.perf_counter() - t0) / RGB_TIMED_STEPS * 1e3
    tracker.clock = None
    laps = clock.totals_ms()
    n_rgb, busy_rgb = profiled_kernels(
        lambda: tracker._stage_step(p_rgb, rgb_opt, data, [0, 1, 2, 3][:B], 0.3, 1.0), 5)
    print(f"  rgb step (rgb_init_all: B={B}, splat/uv, {tracker.p_width}x{tracker.p_height}, "
          f"landmark weight 0.3): {rgb_ms:.3f} ms/step over {RGB_TIMED_STEPS} steps (host "
          f"clock, synchronized); {n_rgb:.0f} kernels and {busy_rgb:.3f} ms of device time a "
          f"step (torch.profiler, 5 steps) [{card}]")
    for name in ("flame", "landmark", "bind", "project", "bin", "composite", "l1", "backward",
                 "optimizer"):
        print(f"  stage {name:12s} {laps.get(name, 0.0) / RGB_TIMED_STEPS:9.3f} ms/step")
    print(f"phase G ran in {time.perf_counter() - t_phase:.2f} s")
    return {"fit_fwd": fit_fwd, "fit_bwd": fit_bwd, "step_fwd": step_launches[0],
            "step_bwd": step_launches[1], "err_k1": err_k1, "err_k2": err_k2,
            # the file's landmarks are the source's: what phase H holds its fit against
            "quality": {"photo": photo_fit, "landmark": result.losses["landmark"]}}


def sampler_frame_inputs(sampler, draws, i: int):
    """The composite's inputs of sample i of a sampler batch, as `picture`
    reaches them (scene, bind, colours, project, bin), detached."""
    from omfs4d_torch.models.gaussians import bind_to_mesh, eval_colors
    from omfs4d_torch.ops.camera import project_gaussians
    from omfs4d_torch.render.rasterize import bin_gaussians

    with torch.no_grad():
        verts, w2c, logits = sampler.scene(draws)
        g = sampler.splats(logits[i])
        cam = sampler.camera(draws, w2c, i)
        means, rot, scales, opac, _ = bind_to_mesh(g, verts[i], sampler.model.faces)
        cols = eval_colors(g, means, cam.position)
        proj = project_gaussians(cam, means, rot, scales)
        binning = bin_gaussians(proj, opac, sampler.size, sampler.size,
                                max_per_tile=sampler.max_per_tile)
    return (proj["uv"], proj["conic"], cols, opac, binning, sampler.size, sampler.size)


def synced_ms(fn, n: int) -> float:
    """Host-clock ms per call over n calls, synchronized at both ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def overall_iou(masks: np.ndarray, gt: np.ndarray) -> float:
    m = masks.astype(bool)
    return float((m & gt).sum() / max((m | gt).sum(), 1))


def rms_px(landmark_loss: float) -> float:
    """The tracker's landmark loss (mean squared distance over the longer
    side squared) as a root-mean-square distance in pixels of a SIZE frame."""
    return float(np.sqrt(landmark_loss)) * SIZE


def fit_quality(tracker, result, frames, src_lmk: np.ndarray) -> dict:
    """What a fit is worth whatever landmarks it was given: its photometric
    loss over every frame and its posed landmarks' loss against the source's."""
    T = len(src_lmk)
    with torch.no_grad():
        p = tracker_params(tracker, result, T)
        photo = float(tracker._photometric_loss(p, tracker._prep_frames(frames), list(range(T))))
        lmk = float(tracker._landmark_loss(p, torch.from_numpy(src_lmk).to(tracker.device),
                                           torch.ones(T, dtype=torch.bool, device=tracker.device)))
    return {"photo": photo, "landmark": lmk}


def held_out_sets(model, sampler, device) -> dict:
    """The gates' data: HELD_OUT fresh sampler faces (16 scatter by several px
    around the mean: too few to read a gate) and 24 shifted ones."""
    from omfs4d_torch.track import robustness as rob

    imgs, lbls, alpha = sampler.batch(torch.Generator(device=device).manual_seed(123), HELD_OUT)
    s_imgs, s_lbls, s_alpha = rob.shifted_eval_batch(model, n=24, image_size=NET_SIZE, seed=0)
    return {"imgs": imgs, "lbls": lbls, "alpha": alpha, "s_imgs": s_imgs, "s_lbls": s_lbls,
            "s_alpha": s_alpha}


def detector_gates(net, sets: dict, device) -> dict:
    """The reference's gates of a trained detector (`tests/test_detector.py`):
    its px error on both sets beside an untrained net's."""
    from omfs4d_torch.track import detector as det
    from omfs4d_torch.track import robustness as rob

    untrained = det.init_net(torch.Generator(device=device).manual_seed(0),
                             sets["lbls"].shape[1], NET_SIZE)
    imgs, lbls = sets["imgs"].cpu().numpy(), sets["lbls"].cpu().numpy()
    g = {"held": rob.detector_px_error(net, imgs, lbls),
         "held_0": rob.detector_px_error(untrained, imgs, lbls),
         "shifted": rob.detector_px_error(net, sets["s_imgs"], sets["s_lbls"]),
         "shifted_0": rob.detector_px_error(untrained, sets["s_imgs"], sets["s_lbls"])}
    g["ok"] = g["held"] < 0.7 * g["held_0"] and g["shifted"] < 0.85 * g["shifted_0"]
    return g


def segnet_gates(seg, sets: dict, device) -> dict:
    """The reference's gates of a trained matting net (`tests/test_matting.py`):
    IoU against the true alpha on both sets, beside predict-everything and an
    untrained net."""
    from omfs4d_torch.track import robustness as rob
    from omfs4d_torch.track import segnet

    masks = segnet.predict_masks(seg, (sets["imgs"].cpu().numpy() * 255).astype(np.uint8),
                                 image_size=NET_SIZE)
    gt = sets["alpha"].cpu().numpy() > 0.5
    seg0 = segnet.init_segnet(torch.Generator(device=device).manual_seed(0))
    with torch.no_grad():
        s_on = torch.from_numpy(sets["s_imgs"]).to(device)
        shifted = [rob.mask_iou(torch.sigmoid(segnet.segnet_apply(n, s_on)).cpu().numpy(),
                                sets["s_alpha"]) for n in (seg, seg0)]
    g = {"iou": overall_iou(masks, gt), "base": float(gt.mean()), "shifted": shifted[0],
         "shifted_0": shifted[1]}
    g["ok"] = (g["iou"] > 0.55 and g["iou"] > g["base"] + 0.1 and g["shifted"] > 0.45
               and g["shifted"] > 2.0 * g["shifted_0"])
    return g


def gate_readings(det_counts: list[int], seg_counts: list[int]) -> int:
    """--net-gates: both nets trained at each of several step counts (seed 0,
    each count its own cosine schedule, as `train_detector(steps=...)` runs
    it) and the learning gates read after each: how phase H's counts were
    chosen."""
    from omfs4d_torch import _build
    from omfs4d_torch.models.assets import synthetic_flame_asset
    from omfs4d_torch.models.flame import FlameModel
    from omfs4d_torch.scripts.profile_composite_variants import card_line
    from omfs4d_torch.track import detector as det
    from omfs4d_torch.track import segnet

    device = torch.device("cuda", 0)
    card = card_line()
    _build.load_library()
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=N_VERTICES, seed=0),
                                  device=device)
    sets = held_out_sets(model, det.SyntheticFaceSampler(model, NET_SIZE), device)
    print(f"gates at {NET_SIZE} px, {model.faces.shape[0]} face splats, K={NET_K}, {HELD_OUT} fresh "
          f"sampler faces and 24 shifted ones, seed 0 [{card}]", flush=True)
    for steps in det_counts:
        t0 = time.perf_counter()
        net = det.train_detector(model, steps=steps, log_every=0)
        g = detector_gates(net, sets, device)
        print(f"  detector {steps:5d} steps ({time.perf_counter() - t0:6.1f} s): held-out "
              f"{g['held']:.3f} px = {g['held'] / g['held_0']:.3f} x untrained {g['held_0']:.3f} "
              f"(gate 0.7), shifted {g['shifted']:.3f} px = {g['shifted'] / g['shifted_0']:.3f} x "
              f"{g['shifted_0']:.3f} (gate 0.85): {'met' if g['ok'] else 'missed'}", flush=True)
    for steps in seg_counts:
        t0 = time.perf_counter()
        seg = segnet.train_segnet(model, steps=steps, log_every=0)
        g = segnet_gates(seg, sets, device)
        print(f"  segnet   {steps:5d} steps ({time.perf_counter() - t0:6.1f} s): IoU {g['iou']:.3f} "
              f"(gates 0.55 and {g['base']:.3f} + 0.1), shifted {g['shifted']:.3f} (gates 0.45 and "
              f"2 x {g['shifted_0']:.3f}): {'met' if g['ok'] else 'missed'}", flush=True)
    return 0


def phase_h(model, device, card: str, work: Path, file_fit: dict | None = None) -> dict:
    """The video front end at full width; returns K1's and K2's launches while
    the nets train, in one detector step and in Pipeline.track, and K1's
    figures at a sampler frame.  `file_fit`: phase G's `quality`, the fit of
    the same clip from its landmark file (made here when not given)."""
    from omfs4d_torch.core.config import Config, TrackConfig
    from omfs4d_torch.io.dataset import FrameDataset
    from omfs4d_torch.io.video import read_image
    from omfs4d_torch.pipeline.runner import Pipeline
    from omfs4d_torch.render.composite import composite, composite_plain, pack_lists
    from omfs4d_torch.track import detector as det
    from omfs4d_torch.track import segnet
    from omfs4d_torch.track.fitter import FlameTracker
    from omfs4d_torch.track.landmarks import detect_landmarks
    from omfs4d_torch.track.matting import compute_masks
    from omfs4d_torch.train.trainer import adam_init

    t_phase = time.perf_counter()
    work = work / "nets"
    work.mkdir()
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is off (the package pins f32 at import): the nets train in f32")
    n_lmk = model.lmk_faces_idx.shape[0]
    sampler = det.SyntheticFaceSampler(model, NET_SIZE)
    check(sampler.max_per_tile == NET_K and sampler.device == device,
          f"the sampler's K is {sampler.max_per_tile} and it sits on {sampler.device}")
    gen = torch.Generator(device=device).manual_seed(7)
    sampler.batch(gen, 2)            # warm-up: shapes, allocator, cuDNN

    # ── 1. both nets train on the card; K1 launches once per synthetic face ──
    trained = {}
    for name, train, batch, steps in (("detector", det.train_detector, DET_BATCH, DET_STEPS),
                                      ("segnet", segnet.train_segnet, SEG_BATCH, SEG_STEPS)):
        history = []
        composite.launches = 0
        composite.backward_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net = train(model, steps=steps, log_every=0, history=history)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fwd, bwd = composite.launches, composite.backward_launches
        check(fwd == batch * steps and bwd == 0,
              f"{name}: K1 launches {fwd} == {batch} x {steps} synthetic faces, K2 {bwd} == 0")
        losses = torch.stack(history).cpu().numpy()
        check(len(losses) == steps and bool(np.isfinite(losses).all()),
              f"{name}: {steps} finite losses")
        check(next(net.parameters()).device == device, f"{name} trained on {device}")
        trained[name] = {"net": net, "fwd": fwd, "seconds": seconds, "batch": batch,
                         "steps": steps, "first": float(losses[0]), "last": float(losses[-1]),
                         "tail": float(losses[-10:].mean()), "head": float(losses[:10].mean())}
        check(trained[name]["tail"] < trained[name]["head"],
              f"{name}: mean loss of the last 10 steps {trained[name]['tail']:.5f} < of the "
              f"first 10 {trained[name]['head']:.5f}")
    net, seg = trained["detector"]["net"], trained["segnet"]["net"]
    det.save_detector(work / "detector.npz", net)
    segnet.save_segnet(work / "segnet.npz", seg)

    # what a step costs: the sampler alone, the net's step alone on a fixed batch
    fixed = sampler.batch(gen, DET_BATCH)
    dstate = adam_init(dict(net.named_parameters()))
    sstate = adam_init(dict(seg.named_parameters()))
    flat_lr = det.cosine_decay_schedule(0.0, 10)        # rate 0: the nets stay as trained

    def det_step():
        det.adam_step(net, dstate, det.detector_loss(net, fixed[0], fixed[1]), flat_lr)

    def seg_step():
        det.adam_step(seg, sstate, segnet.segnet_loss(seg, fixed[0][:SEG_BATCH],
                                                         fixed[2][:SEG_BATCH]), flat_lr)

    batch_ms = {b: synced_ms(lambda b=b: sampler.batch(gen, b), NET_TIMED)
                for b in (DET_BATCH, SEG_BATCH)}
    step_ms = {"detector": synced_ms(det_step, 20), "segnet": synced_ms(seg_step, 20)}
    face_kernels, face_busy_ms = profiled_kernels(lambda: sampler.batch(gen, 4), 3)
    det_kernels, det_busy_ms = profiled_kernels(det_step, 5)
    print(f"phase H: the nets at full width: {model.faces.shape[0]} face splats, image_size "
          f"{NET_SIZE} (36 tiles), K={NET_K}, TF32 off; steps cut to {DET_STEPS} / {SEG_STEPS} "
          f"[{card}]")
    for name, t in trained.items():
        print(f"  {name}: batch {t['batch']} x {t['steps']} steps in {t['seconds']:.3f} s = "
              f"{t['seconds'] / t['steps'] * 1e3:.3f} ms/step with the sampler (host clock, "
              f"synchronized at both ends); sampler batch of {t['batch']} alone "
              f"{batch_ms[t['batch']]:.3f} ms, the net's step alone {step_ms[name]:.3f} ms "
              f"(fixed batch, 20 steps); K1 launches {t['fwd']}, K2 0; loss {t['first']:.5f} "
              f"-> {t['last']:.5f} (first 10 {t['head']:.5f}, last 10 {t['tail']:.5f})")
    print(f"  one synthetic face: {face_kernels / 4:.0f} kernels and {face_busy_ms / 4:.3f} ms of "
          f"device time (torch.profiler, 3 batches of 4); one detector step without the "
          f"sampler: {det_kernels:.0f} kernels and {det_busy_ms:.3f} ms of device time "
          f"(torch.profiler, 5 steps) [{card}]")

    # ── 2. the reference's own learning gates, on held-out batches large
    # enough to read them (16 faces scatter by several px around the mean) ──
    sets = held_out_sets(model, sampler, device)
    imgs = sets["imgs"]
    dg, sg = detector_gates(net, sets, device), segnet_gates(seg, sets, device)
    print(f"  gates at {NET_SIZE} px ({HELD_OUT} fresh sampler faces; 24 shifted faces): detector "
          f"held-out {dg['held']:.3f} px (untrained {dg['held_0']:.3f}), shifted "
          f"{dg['shifted']:.3f} px (untrained {dg['shifted_0']:.3f}); segnet IoU "
          f"{sg['iou']:.3f} (predict-everything {sg['base']:.3f}), shifted {sg['shifted']:.3f} "
          f"(untrained {sg['shifted_0']:.3f})")
    check(dg["ok"], f"detector held-out error {dg['held']:.3f} px < 0.7 x untrained "
          f"{dg['held_0']:.3f} px and shifted-eval error {dg['shifted']:.3f} px < 0.85 x "
          f"untrained {dg['shifted_0']:.3f} px")
    check(sg["ok"], f"segnet IoU {sg['iou']:.3f} > 0.55 and > predict-everything "
          f"{sg['base']:.3f} + 0.1; shifted-eval IoU {sg['shifted']:.3f} > 0.45 and > 2 x "
          f"untrained {sg['shifted_0']:.3f}")

    # ── 3. K1 at a sampler frame; no host sync; the card against the CPU ──
    draws = sampler.draw(torch.Generator(device=device).manual_seed(5), 4)
    errs, overflow = [], 0
    for i in range(4):
        args = sampler_frame_inputs(sampler, draws, i)
        with torch.no_grad():
            img_k, alpha_k = composite(*args)
            img_p, alpha_p = composite_plain(*args)
        errs.append(max((img_k - img_p).abs().max().item(),
                        (alpha_k - alpha_p).abs().max().item()))
        overflow += int(args[4].overflow)
        check(errs[-1] <= TOL and bool(torch.isfinite(img_k).all()),
              f"sampler frame {i}: K1 vs plain max abs err {errs[-1]} <= {TOL}")
    args = sampler_frame_inputs(sampler, draws, 0)
    fb = args[4]
    check(fb.tile_lists.shape == (36, NET_K) and args[0].shape[0] == model.faces.shape[0]
          and overflow > 0, f"sampler frames: lists {tuple(fb.tile_lists.shape)}, "
          f"{overflow} entries past K over 4 frames")
    with torch.no_grad():
        k1 = device_us(lambda: composite(*args), "composite_fwd_kernel", "heavy_first_kernel")
        k1_ms = median_ms(lambda: composite(*args))
        plain_ms = median_ms(lambda: composite_plain(*args))
    bounds = composite_bounds(args, pack_lists(*args[:4], fb.tile_lists, fb.tile_counts),
                              residual=False)
    k1_us = k1["composite_fwd_kernel"] + k1["heavy_first_kernel"]
    b_us, b_by = bounds["composite_fwd"]
    print(f"  sampler frame 0 ({args[0].shape[0]} face splats, {int(fb.tile_counts.sum())} list "
          f"entries in 36 tiles at K={NET_K}, {int(fb.overflow)} past K, {bounds['reached']} "
          f"pairs in reach, {bounds['live']} live): K1 vs plain max abs err {max(errs):.3e} "
          f"over 4 frames; K1 {k1_us:.2f} us of device time (kernel "
          f"{k1['composite_fwd_kernel']:.2f} + ordering {k1['heavy_first_kernel']:.2f}; "
          f"torch.profiler, {N_TIMED} launches), bound {b_us:.3f} us ({b_by}), "
          f"{b_us / k1_us:.1%} of the bound; CUDA-event ms K1 {k1_ms:.4f}, plain "
          f"{plain_ms:.4f} [{card}]")

    fresh = det.init_net(gen, n_lmk, NET_SIZE)
    fstate = adam_init(dict(fresh.named_parameters()))
    lr = det.cosine_decay_schedule(3e-4, 10, alpha=0.1)
    for _ in range(2):                      # the second warm-up runs at count 1, as the timed one
        det.adam_step(fresh, fstate, det.detector_loss(fresh, fixed[0], fixed[1]), lr)
    before = composite.launches, composite.backward_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b_imgs, b_lbls, _ = sampler.batch(gen, DET_BATCH)
        det.adam_step(fresh, fstate, det.detector_loss(fresh, b_imgs, b_lbls), lr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step_launches = composite.launches - before[0], composite.backward_launches - before[1]
    check(step_launches == (DET_BATCH, 0),
          f"one detector step launched K1 {step_launches[0]} == {DET_BATCH} times and K2 "
          f"{step_launches[1]} == 0; the batch and the step made no host sync")
    with torch.no_grad():
        x = imgs[:4]
        uv_card, uv_cpu = det.net_apply(net, x).cpu(), det.net_apply(
            det.load_detector(work / "detector.npz", "cpu"), x.cpu())
        lg_card, lg_cpu = segnet.segnet_apply(seg, x).cpu(), segnet.segnet_apply(
            segnet.load_segnet(work / "segnet.npz", "cpu"), x.cpu())
    uv_err = float((uv_card - uv_cpu).abs().max())
    lg_err = float((lg_card - lg_cpu).abs().max() / lg_cpu.abs().max())
    check(uv_err <= 1e-4 and lg_err <= 1e-4,
          f"card vs CPU: landmarks {uv_err:.3e} <= 1e-4 (normalized), logits {lg_err:.3e} <= "
          "1e-4 of the largest")
    print(f"  one detector step: K1 {step_launches[0]}, K2 {step_launches[1]} launches, no host "
          f"sync in the batch or the step; card vs CPU: landmarks max abs {uv_err:.3e}, logits "
          f"{lg_err:.3e} of the largest")

    # ── 4. the user's path: frames with no landmark file -> dataset ──
    images, cam, gt_alpha = tracking_clip(model, device, work)
    gt_lmk = np.load(images / "landmarks.npz")["landmarks"]
    capture = work / "frames_only"
    capture.mkdir()
    for png in sorted(images.glob("*.png")):
        shutil.copy2(png, capture / png.name)
    cfg = Config()
    cfg.track = TrackConfig(**TRACK_STEPS)
    check(cfg.pipeline.matting == "border_color" and cfg.render.max_per_tile == MAX_PER_TILE
          and cfg.pipeline.target_size == SIZE, "the pipeline's defaults: border_color, K=256")
    runner = Pipeline(cfg, work / "pipeline")
    check(runner.device == device and runner.model.n_vertices == model.n_vertices,
          f"the pipeline took the card ({runner.device}) and the full asset")
    frames_dir = runner.preprocess(capture)
    paths = sorted((frames_dir / "images").glob("*.png"))
    frames = np.stack([read_image(q) for q in paths])
    check(frames.shape == (N_FRAMES, SIZE, SIZE, 3) and not list(frames_dir.rglob("*.npz")),
          f"preprocess wrote {frames.shape} frames and no landmark file")
    lmk_kw = {"weights": work / "detector.npz"}
    det_lmk, _ = detect_landmarks(frames_dir / "images", method="neural", model=model,
                                  image_size=NET_SIZE, **lmk_kw)
    det_px = float(np.linalg.norm(det_lmk - gt_lmk, axis=-1).mean())
    det_rms = float(np.sqrt((np.linalg.norm(det_lmk - gt_lmk, axis=-1) ** 2).mean()))
    # the pipeline keeps only the dataset of its fit: the tracker and its
    # result are noted here as they pass, to hold the fit itself below
    fits, fit = [], FlameTracker.fit

    def noted_fit(self, *args, **kwargs):
        fits.append((self, fit(self, *args, **kwargs)))
        return fits[-1][1]

    composite.launches = 0
    composite.backward_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    FlameTracker.fit = noted_fit
    try:
        out = runner.track(frames_dir, cam, landmark_method="neural", landmark_kwargs=lmk_kw)
    finally:
        FlameTracker.fit = fit
    torch.cuda.synchronize()
    track_s = time.perf_counter() - t0
    pipe_fwd, pipe_bwd = composite.launches, composite.backward_launches
    tcfg = cfg.track
    B = min(RGB_BATCH, N_FRAMES)
    rendered = (B * (tcfg.steps_rgb_init_texture + tcfg.steps_rgb_init_all
                     + tcfg.steps_rgb_init_offset + tcfg.steps_global * tcfg.epochs_global)
                + N_FRAMES * tcfg.steps_rgb_sequential)
    check(pipe_fwd == rendered and pipe_bwd == rendered,
          f"Pipeline.track: K1 {pipe_fwd} and K2 {pipe_bwd} launches == {rendered} rendered "
          "frames (the detector's weights were loaded, not trained)")
    ds = FrameDataset(out, split="train")
    ds_masks = np.stack([ds.load_mask(i) for i in range(len(ds))])
    mask_iou = overall_iou(ds_masks > 0.5, gt_alpha[:len(ds)])
    check(len(ds) == N_FRAMES - N_FRAMES // 10 and np.array_equal(ds.load_image(0), frames[0])
          and ds.flame_params["expr"].shape == (N_FRAMES, 100)
          and ds.points3d().shape == (model.n_vertices, 3) and mask_iou > 0.8,
          f"the tracked dataset reads back with masks (IoU {mask_iou:.3f} against the rendered "
          "alpha > 0.8)")
    evs = [json.loads(line) for line in runner.events.path.read_text().splitlines()]
    stage_s = {e["stage"]: e["seconds"] for e in evs if e["event"] == "stage_end"}
    check(list(stage_s) == ["preprocess", "track.stage_frames", "track.landmarks",
                            "track.matting", "track"], f"the runner's stage timers: {list(stage_s)}")
    preflight = [{k: v for k, v in e.items() if k not in ("t", "stats")} for e in evs
                 if e["event"].startswith("preflight")]
    track_losses = [e["loss"] for e in evs if e["event"] == "track_stage"]
    check(len(track_losses) == 7 and bool(np.isfinite(track_losses).all()),
          f"7 finite track_stage events: {track_losses}")
    # what the fit from the detector's landmarks is worth beside the fit of
    # the same clip from the source's own landmarks (phase G's)
    check(len(fits) == 1, f"Pipeline.track made {len(fits)} fit")
    tracker, result = fits[0]
    neural_fit = fit_quality(tracker, result, frames, gt_lmk)
    if file_fit is None:              # phase H alone: phase G's fit is made here
        file_fit = fit_quality(tracker, tracker.fit(gt_lmk, np.ones(N_FRAMES, bool),
                                                    frames=frames), frames, gt_lmk)
    check(det_rms <= DETECTION_RMS_PX,
          f"detection {det_rms:.3f} px rms from the source's landmarks <= {DETECTION_RMS_PX}")
    check(neural_fit["photo"] <= NEURAL_FIT_PHOTO * file_fit["photo"]
          and rms_px(neural_fit["landmark"]) <= NEURAL_FIT_LMK * det_rms,
          f"the fit from the detector's landmarks: photometric loss {neural_fit['photo']:.5f} <= "
          f"{NEURAL_FIT_PHOTO} x {file_fit['photo']:.5f} (the fit from the source's landmarks), "
          f"posed landmarks {rms_px(neural_fit['landmark']):.3f} px rms from the source's <= "
          f"{NEURAL_FIT_LMK} x {det_rms:.3f} (the detector's own)")
    neural_masks = compute_masks(frames, method="neural", model=model,
                                 weights=work / "segnet.npz", image_size=NET_SIZE)
    neural_iou = overall_iou(neural_masks > 0.5, gt_alpha)
    check(neural_masks.shape == (N_FRAMES, SIZE, SIZE), "neural matting returns (T, H, W) masks")
    # the second call is answered by the stage cache: no kernel launches
    composite.launches = 0
    composite.backward_launches = 0
    again = runner.track(frames_dir, cam, landmark_method="neural", landmark_kwargs=lmk_kw)
    check(again == out and composite.launches == 0 and composite.backward_launches == 0
          and len(runner.events.path.read_text().splitlines()) == len(evs),
          "the second Pipeline.track call hit the stage cache: no launch, no event")
    print(f"  Pipeline.preprocess -> track(neural), {N_FRAMES} frames at {SIZE}^2, no landmark "
          f"file: detection {det_px:.3f} px from the source's landmarks (mean over 68 x "
          f"{N_FRAMES}); track() {track_s:.3f} s; K1 {pipe_fwd}, K2 {pipe_bwd} launches; stage "
          "seconds " + ", ".join(f"{k} {v:.3f}" for k, v in stage_s.items())
          + f"; dataset masks IoU {mask_iou:.3f} (border_color), neural matting IoU "
          f"{neural_iou:.3f}; second track() from the stage cache, 0 launches [{card}]")
    print(f"  preflight events: {preflight if preflight else 'none (both gates passed)'}")
    print(f"  the fit from the detector's landmarks beside the fit from the source's (phase G's "
          f"schedule, {N_FRAMES} frames): photometric loss {neural_fit['photo']:.5f} against "
          f"{file_fit['photo']:.5f}; posed landmarks {rms_px(neural_fit['landmark']):.3f} px rms "
          f"from the source's against {rms_px(file_fit['landmark']):.3f} (the detector's own "
          f"output: {det_rms:.3f} px rms) [{card}]")
    print(f"phase H ran in {time.perf_counter() - t_phase:.2f} s")
    return {"nets_fwd": trained["detector"]["fwd"] + trained["segnet"]["fwd"],
            "step_fwd": step_launches[0], "step_bwd": step_launches[1],
            "pipe_fwd": pipe_fwd, "pipe_bwd": pipe_bwd, "err_k1": max(errs),
            "k1_ms": k1_ms, "plain_ms": plain_ms, "bound_us": b_us, "bound_by": b_by}


def phase_i(model, device, card: str, work: Path) -> dict:
    """The pipeline end to end at full width through the port's CLI, in
    process; returns K1's and K2's launches over the phase and its figures."""
    import dataclasses

    from omfs4d_torch.core.config import Config, TrackConfig, apply_override
    from omfs4d_torch.headrecon import (build_canonical_head, fit_shared_shape,
                                        ingest_sequences, register_sequences)
    from omfs4d_torch.io.video import read_image
    from omfs4d_torch.pipeline import cli
    from omfs4d_torch.pipeline.runner import Pipeline
    from omfs4d_torch.predict.surgery import choose_rig_mode
    from omfs4d_torch.render.composite import composite
    from omfs4d_torch.track.fitter import FlameTracker
    from omfs4d_torch.track.landmarks import detect_landmarks
    from omfs4d_torch.train.trainer import densify_until_iter

    t_phase = time.perf_counter()
    work = work / "e2e"
    work.mkdir()
    images, cam, _ = tracking_clip(model, device, work)
    wd = work / "wd"
    overrides = ([f"track.{k}={v}" for k, v in TRACK_STEPS.items()]
                 + [f"pipeline.min_train_frames={N_FRAMES}"])
    common = ["--workdir", str(wd), *overrides]
    cfg = Config()
    for kv in overrides:
        apply_override(cfg, *kv.split("=", 1))
    tcfg = dataclasses.replace(cfg.train, densify_interval=E2E_DENSIFY_INTERVAL)
    check(cfg.train.densify_interval == 300 and tcfg.densify_from < E2E_ITERS
          and cfg.train.sh_degree == 3 and cfg.train.optimize_flame
          and cfg.render.max_per_tile == MAX_PER_TILE,
          "the trainer's defaults: densify every 300 (100 at >= 384 px), SH 3, "
          "co-optimization on, K=256")
    densify_at = [i for i in range(E2E_DENSIFY_INTERVAL, E2E_ITERS + 1, E2E_DENSIFY_INTERVAL)
                  if tcfg.densify_from <= i <= densify_until_iter(tcfg, E2E_ITERS)]
    check(len(densify_at) >= 2, f"densification fires at {densify_at}")

    # the launches of each stage, and what render_surgery returns, noted as
    # the stages pass
    stage_launches, predictions = {}, []
    wrapped = {}
    for name in ("track", "train", "render_surgery"):
        wrapped[name] = getattr(Pipeline, name)

        def noted(self, *args, _name=name, **kwargs):
            before = composite.launches, composite.backward_launches
            out = wrapped[_name](self, *args, **kwargs)
            torch.cuda.synchronize()
            stage_launches.setdefault(_name, []).append(
                (composite.launches - before[0], composite.backward_launches - before[1]))
            if _name == "render_surgery":
                predictions.append(out)
            return out

        setattr(Pipeline, name, noted)
    composite.launches = 0
    composite.backward_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        # the capture is the clip's PNG frames; its landmark file goes beside
        # the preprocessed frames, where `--landmarks auto` takes it
        check(cli.main(["preprocess", "--video", str(images), *common]) == 0, "cli preprocess")
        stage_dirs = list((wd / "stages").glob("preprocess-*"))
        check(len(stage_dirs) == 1, f"one preprocess stage directory: {stage_dirs}")
        shutil.copy2(images / "landmarks.npz", stage_dirs[0] / "landmarks.npz")
        check(cli.main(["run", "--video", str(images), "--landmarks", "auto",
                        "--iterations", str(E2E_ITERS), "--lefort-mm", str(LEFORT_MM),
                        "--bsso-mm", str(BSSO_MM), "--output", str(work / "pred.mp4"),
                        *common]) == 0, "cli run")
        run_s = time.perf_counter() - t0
        model_dir = wd / "model"
        renders = model_dir / "train" / f"ours_{E2E_ITERS}" / "renders"
        shutil.copytree(renders, work / "pred_renders")
        # the zero-offset render: the selfrecon PSNR, and the baseline of
        # psnr_unchanged on the 5/3 mm prediction
        data_dir = next((wd / "stages").glob("track-*"))
        for mm, det in ((0.0, "det_self"), (LEFORT_MM, "det_mod")):
            check(cli.main(["render-surgery", "--model", str(model_dir), "--data", str(data_dir),
                            "--lefort-mm", str(mm), "--bsso-mm", str(BSSO_MM if mm else 0.0),
                            "--output", str(work / f"{det}.mp4"),
                            "--export-frames-dir", str(work / det), *common]) == 0,
                  f"cli render-surgery {mm} mm")
            if det == "det_self":
                check(cli.main(["report", "--model", str(model_dir), "--frames",
                                str(work / det), "--out", str(work / "selfrecon")]) == 0,
                      "cli report (selfrecon)")
                shutil.copytree(renders, work / "baseline_renders")
        check(cli.main(["report", "--model", str(model_dir), "--frames", str(work / "det_mod"),
                        "--out", str(work / "report"), "--baseline-renders",
                        str(work / "baseline_renders")]) == 0, "cli report --baseline-renders")
    finally:
        for name, fn in wrapped.items():
            setattr(Pipeline, name, fn)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    fwd, bwd = composite.launches, composite.backward_launches

    # ── the checks ──
    evs = [json.loads(line) for line in (wd / "events.jsonl").read_text().splitlines()]
    stage_s = {}
    for e in evs:
        if e["event"] == "stage_end":
            stage_s.setdefault(e["stage"], []).append(e["seconds"])
    check({"preprocess", "track", "train", "render_surgery", "report"} <= set(stage_s),
          f"a stage_end event for each stage: {sorted(stage_s)}")
    check((model_dir / "point_cloud" / f"iteration_{E2E_ITERS}" / "point_cloud.ply").exists()
          and (model_dir / "flame_param_refined.npz").exists()
          and len(list((model_dir / "experiment_manifests").glob("*.json"))) == 1,
          f"point_cloud/iteration_{E2E_ITERS}, flame_param_refined.npz and a manifest")
    n_train = N_FRAMES - N_FRAMES // 10
    scores = json.loads((model_dir / "eval_strict" / "reports" / "strict_scores.json").read_text())
    exported = json.loads((wd / "deterministic_frames"
                           / "deterministic_indices_manifest.json").read_text())["exports"]
    check(len(scores["rows"]) == len(exported) == n_train,
          f"strict_scores.json: {len(scores['rows'])} rows == {len(exported)} exported frames")
    check(len(predictions) == 3 and all(
        r["video"] is None and "ffmpeg" in r["video_error"] for r in predictions)
        and not list(work.glob("*.mp4")),
        f"no video without an ffmpeg binary, and the reason: {predictions[0]['video_error']}")
    (track_k,), (train_k,) = stage_launches["track"], stage_launches["train"]
    B = min(RGB_BATCH, N_FRAMES)
    track_cfg = TrackConfig(**TRACK_STEPS)
    rendered = (B * (track_cfg.steps_rgb_init_texture + track_cfg.steps_rgb_init_all
                     + track_cfg.steps_rgb_init_offset
                     + track_cfg.steps_global * track_cfg.epochs_global)
                + N_FRAMES * track_cfg.steps_rgb_sequential)
    check(track_k == (rendered, rendered), f"track: K1, K2 {track_k} == {rendered} each")
    # the trainer's own metric renders add no launch: K1 once a step
    check(train_k == (E2E_ITERS, E2E_ITERS),
          f"train: K1, K2 {train_k} == {E2E_ITERS} training iterations each")
    check(all(k == (n_train, 0) for k in stage_launches["render_surgery"])
          and len(stage_launches["render_surgery"]) == 3,
          f"render_surgery: K1 once a frame, no K2: {stage_launches['render_surgery']}")
    check((fwd, bwd) == (rendered + E2E_ITERS + 3 * n_train, rendered + E2E_ITERS),
          f"phase I launches K1 {fwd}, K2 {bwd}")
    steps = {e["iter"]: e for e in evs if e["event"] == "train_step"}
    first, last = steps[min(steps)], steps[E2E_ITERS]
    check(np.isfinite(last["loss"]) and last["loss"] < first["loss"],
          f"the loss fell: {first['loss']:.5f} at {min(steps)} -> {last['loss']:.5f}")
    alive = {i: int(e["n_alive"]) for i, e in sorted(steps.items())}
    check(alive[E2E_ITERS] != alive[min(steps)],
          f"densification moved the cloud: alive {alive}")
    pred = [read_image(p).astype(int) for p in sorted((work / "pred_renders").glob("*.png"))]
    zero = [read_image(p).astype(int) for p in sorted((work / "baseline_renders").glob("*.png"))]
    moved = np.mean([(np.abs(a - b).max(-1) > 0).mean() for a, b in zip(pred, zero)])
    check(len(pred) == len(zero) == n_train and moved > 0,
          f"the 5/3 mm frames differ from the 0 mm ones on {moved:.4f} of pixels")
    self_rows = json.loads((work / "selfrecon" / "strict_scores.json").read_text())["rows"]
    selfrecon = float(np.mean([r["psnr"] for r in self_rows]))
    check(len(self_rows) == n_train and np.isfinite(selfrecon) and selfrecon >= E2E_PSNR_FLOOR,
          f"selfrecon PSNR {selfrecon:.3f} dB >= {E2E_PSNR_FLOOR} dB over {len(self_rows)} frames")
    front = json.loads((work / "report" / "strict_scores.json").read_text()
                       )["summary"]["by_bucket"]["front"]
    check(np.isfinite(front["psnr"]) and np.isfinite(front["psnr_unchanged"]),
          f"front bucket of the 5/3 mm prediction: {front}")
    it_s = (E2E_ITERS - min(steps)) / (last["t"] - first["t"])
    print(f"phase I: cli run, {N_FRAMES} frames at {SIZE}^2 as PNGs with a landmarks.npz, "
          f"{E2E_ITERS} iterations (densify every {E2E_DENSIFY_INTERVAL} at {densify_at}), "
          f"Le Fort {LEFORT_MM} / BSSO {BSSO_MM} mm, tracker steps {TRACK_STEPS}; the trainer "
          f"at its defaults: {model.faces.shape[0]} face gaussians, capacity "
          f"{int(last['capacity'])}, SH {cfg.train.sh_degree}, K={MAX_PER_TILE}, "
          f"co-optimization on [{card}]")
    print("  stage seconds (stage_timer): " + ", ".join(
        f"{k} " + "/".join(f"{s:.3f}" for s in v) for k, v in stage_s.items()))
    print(f"  cli run {run_s:.3f} s, the phase's CLI calls {e2e_s:.3f} s (host clock); train() "
          f"inside the pipeline {it_s:.3f} it/s (iterations {min(steps)}-{E2E_ITERS}, between "
          f"train_step events), {E2E_ITERS / stage_s['train'][0]:.3f} it/s over the train stage; "
          f"render {stage_s['render_surgery'][0] / n_train * 1e3:.3f} ms/frame (first "
          f"render_surgery stage, PNG and dataset set-up included)")
    print(f"  loss {first['loss']:.5f} (iteration {min(steps)}) -> {last['loss']:.5f}; alive "
          f"{alive}; launches: track K1/K2 {track_k}, train {train_k} (the trainer's metric "
          f"renders add none), render_surgery {stage_launches['render_surgery']}")
    print(f"  selfrecon PSNR {selfrecon:.4f} dB (floor {E2E_PSNR_FLOOR} dB; frames "
          + ", ".join(f"{r['psnr']:.2f}" for r in self_rows) + f"); 5/3 mm front psnr "
          f"{front['psnr']:.4f}, psnr_unchanged {front['psnr_unchanged']:.4f} dB; the 5/3 mm "
          f"frames differ from the 0 mm ones on {moved:.4f} of pixels; video None: "
          f"{predictions[0]['video_error']} [{card}]")

    # ── fit_shared_shape on the clip as two sequences -> canonical head ──
    t0 = time.perf_counter()
    lmk, valid = detect_landmarks(images, method="file")
    half = N_FRAMES // 2
    hcfg = TrackConfig(photometric=False, steps_lmk_init_rigid=TRACK_STEPS["steps_lmk_init_rigid"],
                       steps_lmk_init_all=TRACK_STEPS["steps_lmk_init_all"])
    tracker = FlameTracker(model, hcfg, cam, (SIZE, SIZE), max_per_tile=MAX_PER_TILE)
    before = composite.launches, composite.backward_launches
    shape, per_seq = fit_shared_shape(tracker, [(lmk[:half], valid[:half]),
                                                (lmk[half:], valid[half:])])
    check((composite.launches, composite.backward_launches) == before,
          "fit_shared_shape (landmark stages): no kernel launch")
    check(shape.shape == (300,) and np.isfinite(shape).all() and np.abs(shape).max() > 0
          and all(np.array_equal(p["shape"], shape) for p in per_seq)
          and [p["expr"].shape[0] for p in per_seq] == [half, N_FRAMES - half]
          and all(p[k].shape[0] == n for p, n in zip(per_seq, (half, N_FRAMES - half))
                  for k in ("rotation", "translation", "jaw_pose")),
          "one shared shape, per-sequence parameters in the sequences' lengths")
    root = work / "sequences"
    for i, p in enumerate(per_seq):
        seq = root / f"seq_{i}"
        (seq / "images").mkdir(parents=True)
        np.savez(seq / "flame_param.npz", **p)
    table = register_sequences(ingest_sequences(root, work / "head"), work / "head")
    asset = build_canonical_head(table, work / "head" / "canonical_head.npz", shape)
    mode, reason = choose_rig_mode("hybrid_full_head", str(asset))
    check(mode == "hybrid_full_head", f"the canonical head asset is taken: {mode} ({reason})")
    regs = json.loads(table.read_text())["registrations"]
    print(f"  fit_shared_shape: {N_FRAMES} frames as {half} + {N_FRAMES - half}, landmark stages "
          f"({hcfg.steps_lmk_init_rigid} + {hcfg.steps_lmk_init_all} steps), "
          f"{time.perf_counter() - t0:.3f} s; shared shape |max| {np.abs(shape).max():.4f}; "
          f"registration residual {regs[1]['residual']:.2e}; rig mode {mode}")
    print(f"phase I ran in {time.perf_counter() - t_phase:.2f} s")
    return {"fwd": fwd, "bwd": bwd, "selfrecon": selfrecon, "it_s": it_s}


def main(only: str | None = None) -> int:
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

    t_main = time.perf_counter()
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
        if only is not None:
            {"track": phase_g, "nets": phase_h, "e2e": phase_i}[only](model, device, card, work)
            return 0
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
        # K1 and K2 at the training frame against their bounds
        targs = cases["training frame 0"]
        tb = targs[4]
        times = kernel_times(targs)
        bounds = composite_bounds(targs, pack_lists(*targs[:4], tb.tile_lists, tb.tile_counts))
        print(f"phase E: the training frame holds {bounds['in_lists']} (pixel, entry) pairs "
              f"in its lists, {bounds['reached']} in reach, {bounds['live']} live")
        for name, label, us, what in (
                ("composite_fwd", "K1", times["k1_us"],
                 f"composite_fwd_kernel {times['k1_kernel_us']:.2f} + heavy_first_kernel "
                 f"{times['order_us']:.2f}"),
                ("composite_bwd", "K2", times["k2_us"], "composite_bwd_kernel")):
            b_us, b_by = bounds[name]
            print(f"phase E: {label} at the training frame: {us:.2f} us of device time "
                  f"({what}; torch.profiler, {N_TIMED} launches), bound {b_us:.2f} us "
                  f"({b_by}), {b_us / us:.1%} of the bound [{card}]")

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
        flush = l2_flusher(device)
        for label, (packed, dcol, dalpha, grid_w, current) in tables.items():
            k1_ms, k2_ms = pcv.current_times(*current, n=N_TIMED)
            print(f"phase F: {label}: K1 {k1_ms:.4f} ms, K2 {k2_ms:.4f} ms, each through its "
                  f"launch function (median of {N_TIMED}); K2's atomics "
                  + ("never collide here" if "identity" in label else "collide here")
                  + f" [{card}]")
            times_v = variant_times(pcv, packed, dcol, dalpha, grid_w, flush)
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
                tv = times_v[mode]
                v_plain_ms = pcv.timed(pcv.variant_plain, mode, packed, dcol, dalpha,
                                       pcv.TILE, grid_w, n=N_TIMED)
                lib_ms = times_v["packed_x2"]["ms"] if mode == "copy" else None
                v_bound = variant_bound(mode, packed, grid_w)
                variant_rows[mode].append((res["max_abs_err"], tv["ms"], v_plain_ms, v_bound,
                                           lib_ms))
                # the bytes of the bound come from device memory: only the cold
                # time is held against it (warm, the table stays in the L2)
                print(f"  {mode:13s} V {tv['ms']:.4f} ms warm, {tv['cold_ms']:.4f} ms cold, plain "
                      f"{v_plain_ms:.4f} ms (median of {N_TIMED}); device {tv['us']:.2f} us "
                      f"warm, {tv['cold_us']:.2f} us cold (torch.profiler, {N_TIMED} launches); "
                      f"bound {v_bound[0]:.2f} us ({v_bound[1]}), "
                      f"{v_bound[0] / tv['cold_us']:.1%} of the bound cold; {line}")
            lib = times_v["packed_x2"]
            print(f"  packed * 2    {lib['ms']:.4f} ms warm, {lib['cold_ms']:.4f} ms cold; device "
                  + ", ".join(f"{lib[k]:.2f} us {w}" if lib[k] is not None
                              else f"not measured {w}" for k, w in (("us", "warm"),
                                                                    ("cold_us", "cold")))
                  + " (the one PyTorch call for V copy's function)")
            del got, ref
        # the hand-built table of the tests, and a non-finite entry in the
        # middle of two of its lists: NaN where the plain version has NaN
        for kind in (None, *pcv.NON_FINITE):
            args = [torch.from_numpy(a).to(device)
                    for a in pcv.fixture_inputs(non_finite=kind)]
            worst = 0.0
            for mode in pcv.MODES:
                got = pcv.make_variant_kernel(mode)(*args, grid_w=pcv.FIXTURE_GRID_W)
                ref = pcv.variant_plain(mode, *args, grid_w=pcv.FIXTURE_GRID_W)
                res = pcv.compare_non_finite(mode, got, ref, args[0])
                if not res["ok"] or (kind is None and res["non_finite"]):
                    failed.append(f"fixture table ({kind}): V {mode}: {res}")
                worst = max(worst, res["max_abs_err"])
                if kind is None:
                    variant_rows[mode].append((res["max_abs_err"],))
            print(f"phase F: fixture table T=5 K={args[0].shape[2]} ("
                  + ("finite" if kind is None else kind)
                  + f"): every mode within its bound, non-finite where the plain version is; "
                  f"max abs err {worst:.3e}")
        check(not failed, "phase F:\n  " + "\n  ".join(failed))
        host = host_costs(first)
        parts = v_copy_host_parts(*ref_table)
        print(f"phase F: host us per call ({N_HOST} calls, unsynchronised): "
              f"K1 composite() on one tile {host['k1']:.2f}, K2 autograd.grad on one tile "
              f"{host['k2']:.2f}, V copy {host['v_copy']:.2f}, packed * 2 "
              f"{host['packed_x2']:.2f}; V copy's wrapper by step: "
              + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + f" [{card}]")

        # ── phase G: the tracking path at full width ────────
        print(f"phases A-F ran in {time.perf_counter() - t_main:.2f} s, the kernels' build "
              "included")
        track = phase_g(model, device, card, work)

        # ── phase H: the video front end at full width ──────
        nets = phase_h(model, device, card, work, track["quality"])

        # ── phase I: the pipeline end to end through the CLI ─
        e2e = phase_i(model, device, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if modified is not None:
            shutil.rmtree(modified, ignore_errors=True)

    # ms and plain_ms are each kernel's CUDA-event times (K1 at phase C's
    # frame 0, K2 at the training frame, V at the reference table); the
    # bounds are those frames' and that table's
    k1_bound = composite_bounds(first, pack_lists(*first[:4], first[4].tile_lists,
                                                  first[4].tile_counts))["composite_fwd"]
    print(f"the whole run took {time.perf_counter() - t_main:.2f} s")
    print(json.dumps({"kernels": [{
        "name": "composite_fwd", "route": "cuda",
        "source": "omfs4d_torch/csrc/composite_fwd.cu",
        "replaces": "omfs4d/render/pallas_kernels.py:210",
        "launches": (launches + train_fwd + track["fit_fwd"] + nets["nets_fwd"]
                     + nets["pipe_fwd"] + e2e["fwd"]),
        "launches_by_path": {"render": launches, "train": train_fwd, "track": track["fit_fwd"],
                             "nets": nets["nets_fwd"], "pipeline": nets["pipe_fwd"],
                             "e2e": e2e["fwd"]},
        "launches_per_tracker_step": track["step_fwd"],
        "launches_per_detector_step": nets["step_fwd"],
        "at_sampler_frame": {k: nets[k] for k in ("k1_ms", "plain_ms")}
        | {"bound_ms": nets["bound_us"] / 1e3, "bound_by": nets["bound_by"]},
        "max_abs_err": max(*errs, track["err_k1"], nets["err_k1"]),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": k1_bound[0] / 1e3,
        "bound_by": k1_bound[1], "library_ms": None}, {
        "name": "composite_bwd", "route": "cuda",
        "source": "omfs4d_torch/csrc/composite_bwd.cu",
        "replaces": "omfs4d/render/pallas_kernels.py:305",
        "launches": train_bwd + track["fit_bwd"] + nets["pipe_bwd"] + e2e["bwd"],
        "launches_by_path": {"render": 0, "train": train_bwd, "track": track["fit_bwd"],
                             "nets": 0, "pipeline": nets["pipe_bwd"], "e2e": e2e["bwd"]},
        "launches_per_tracker_step": track["step_bwd"],
        "launches_per_detector_step": nets["step_bwd"],
        "max_abs_err": max(*bwd_errs, track["err_k2"]),
        "ms": bwd_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": bounds["composite_bwd"][0] / 1e3, "bound_by": bounds["composite_bwd"][1],
        "library_ms": None}] + [{
        "name": f"composite_variant:{mode}", "route": "cuda",
        "source": "omfs4d_torch/csrc/composite_variants.cu",
        "replaces": "scripts/profile_composite_variants.py:49",
        "launches": v_launches[mode], "launches_per_tracker_step": 0,
        "launches_per_detector_step": 0,
        "max_abs_err": max(r[0] for r in rows),
        "ms": rows[0][1], "plain_ms": rows[0][2], "bound_ms": rows[0][3][0] / 1e3,
        "bound_by": rows[0][3][1], "library_ms": rows[0][4]}
        for mode, rows in variant_rows.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def save_frames(path: Path, work: Path, device) -> None:
    """The two frames of `compare_trees`, saved with torch.save: phase C's
    frame 0 (the bench avatar under Le Fort 5 mm / BSSO 3 mm) and the
    trainer's frame 0 of the compacted, untrained bench avatar."""
    from omfs4d_torch.core.config import TrainConfig
    from omfs4d_torch.io.synthetic import make_synthetic_dataset
    from omfs4d_torch.predict.surgery import compute_offset, create_modified_dataset
    from omfs4d_torch.train.trainer import AvatarTrainer

    case = make_synthetic_dataset(work / "data", n_frames=N_FRAMES, width=SIZE, height=SIZE,
                                  n_vertices=N_VERTICES, seed=0, device=device)
    model = case["model"]
    modified = create_modified_dataset(str(case["path"]), compute_offset(LEFORT_MM, 1.0),
                                       compute_offset(BSSO_MM, 1.0))
    try:
        render = next(frame_inputs(model, bench_avatar(model, device), modified, device,
                                   TILES_PER_GAUSSIAN))
    finally:
        shutil.rmtree(modified, ignore_errors=True)
    data, flame_params = training_data(model, case["path"], device)
    trainer = AvatarTrainer(model.faces.cpu().numpy(), TrainConfig(batch_frames=1), SIZE, SIZE,
                            max_per_tile=MAX_PER_TILE, flame_model=model)
    state = trainer.init_state(capacity=CAPACITY, flame_params=flame_params)
    state = trainer.compact_to_alive(
        state._replace(gaussians=bench_avatar(model, device, CAPACITY)))
    tdata = {k: (v if torch.is_tensor(v) else torch.from_numpy(v)).to(device)
             for k, v in data.items()}
    train = grad_inputs(trainer, state, tdata, 0)
    torch.save({name: (*f[:4], tuple(f[4]), *f[5:]) for name, f in
                (("render", render), ("train", train))}, path)


def measure_tree(tree: Path, frames: Path) -> dict:
    """kernel_times at both saved frames, host_costs and variant_times, with
    the port of the checkout at `tree` (imported from there, its kernels
    built there)."""
    sys.path.insert(0, str(tree.resolve()))
    import omfs4d_torch
    from omfs4d_torch.render.rasterize import TileBinning

    check(Path(omfs4d_torch.__file__).resolve().is_relative_to(tree.resolve()),
          f"omfs4d_torch imported from {omfs4d_torch.__file__}, not from {tree}")
    out = {"tree": str(tree), "frames": {}}
    loaded = torch.load(frames, map_location=torch.device("cuda", 0))
    args = {}
    for name, f in loaded.items():
        args[name] = (*f[:4], TileBinning(*f[4]), *f[5:])
        out["frames"][name] = {"entries": int(args[name][4].tile_counts.sum()),
                               **kernel_times(args[name])}
    out["host_us"] = host_costs(args["render"])
    # kernel V, in trees that have it (since its port)
    if importlib.util.find_spec("omfs4d_torch.scripts.profile_composite_variants"):
        from omfs4d_torch.render.composite import pack_lists
        from omfs4d_torch.scripts import profile_composite_variants as pcv

        device = torch.device("cuda", 0)
        flush = l2_flusher(device)
        table = [torch.from_numpy(a).to(device) for a in pcv.synthetic_inputs(0)[:3]]
        uv, conic, cols, opac, tb, tw, th = args["train"]
        packed = pack_lists(uv, conic, cols, opac, tb.tile_lists, tb.tile_counts)
        out["variants"] = {
            "reference": variant_times(pcv, *table, pcv.GRID_W, flush),
            "train": variant_times(pcv, packed, *pcv.to_tiles(*seeded_cotangent(th, tw, device)),
                                   tw // pcv.TILE, flush)}
    return out


def compare_trees(trees: list[Path]) -> int:
    """K1, K2 and V of checkouts of this repository on the same two frames
    (save_frames) and V's reference table, one process per tree, in the
    order given."""
    from omfs4d_torch.scripts.profile_composite_variants import card_line

    card = card_line()
    print(f"card: {card}", flush=True)
    runs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trees_") as tmp:
        frames = Path(tmp) / "frames.pt"
        save_frames(frames, Path(tmp), torch.device("cuda", 0))
        for tree in trees:
            res = subprocess.run([sys.executable, __file__, "--measure", str(tree), str(frames)],
                                 capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                print(res.stdout[-3000:], res.stderr[-6000:], file=sys.stderr)
                return 1
            runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    print(f"{'tree':<24s} {'frame':<7s} {'K1 us':>8s} {'order us':>9s} {'K2 us':>8s} "
          f"{'K1 ms':>8s} {'K2 ms':>8s}  [{card}]")
    for r in runs:
        for name, f in r["frames"].items():
            print(f"{r['tree']:<24s} {name:<7s} {f['k1_us']:8.2f} {f['order_us']:9.2f} "
                  f"{f['k2_us']:8.2f} {f['k1_ms']:8.4f} {f['k2_ms']:8.4f}")
        print(f"{r['tree']:<24s} host us per call: "
              + ", ".join(f"{k} {v:.2f}" for k, v in r["host_us"].items()))
    print("kernel V, device us per launch warm / cold (the L2 flushed before each launch) and "
          "CUDA-event ms per call warm, on the reference table (T=1024, K=512) and the "
          f"training frame packed at K={MAX_PER_TILE}  [{card}]")
    for r in runs:
        for name, modes in r.get("variants", {}).items():
            print(f"{r['tree']:<24s} {name:<9s} "
                  + ", ".join(f"{m} " + ("not measured" if v["us"] is None else
                                         f"{v['us']:.2f} / {v['cold_us']:.2f} us")
                              + f" {v['ms']:.4f} ms" for m, v in modes.items()))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        import argparse

        ap = argparse.ArgumentParser(description="Without arguments: the smoke run above.")
        ap.add_argument("--trees", type=Path, nargs="+",
                        help="time K1, K2 and V of these checkouts of the repository, one "
                             "process each, in this order ('.' is this one)")
        ap.add_argument("--only-track", action="store_true",
                        help="run the set-up and phase G (the tracking path) alone")
        ap.add_argument("--only-nets", action="store_true",
                        help="run the set-up and phase H (the video front end) alone")
        ap.add_argument("--only-e2e", action="store_true",
                        help="run the set-up and phase I (the pipeline through the CLI) alone")
        ap.add_argument("--net-gates", nargs=2, metavar=("DETECTOR_STEPS", "SEGNET_STEPS"),
                        help="train each net at each of these step counts (two comma-separated "
                             "lists) and read the learning gates: how phase H's counts were chosen")
        ap.add_argument("--measure", type=Path, nargs=2, help=argparse.SUPPRESS)
        opts = ap.parse_args()
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; this script runs only on a card",
                  file=sys.stderr)
            sys.exit(2)
        if opts.measure:
            print(json.dumps(measure_tree(*opts.measure)))
            sys.exit(0)
        if opts.net_gates:
            sys.exit(gate_readings(*([int(n) for n in arg.split(",") if n]
                                     for arg in opts.net_gates)))
        only = [name for name, on in (("track", opts.only_track), ("nets", opts.only_nets),
                                      ("e2e", opts.only_e2e)) if on]
        if len(only) > 1:
            ap.error("at most one --only-* option")
        if only:
            sys.exit(main(only=only[0]))
        sys.exit(compare_trees(opts.trees))
    sys.exit(main())
