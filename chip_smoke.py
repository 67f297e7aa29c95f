#!/usr/bin/env python3
"""Drive the PyTorch port's render, training, tracking, video front-end,
pipeline, clinical and parallel paths, and its bench, once on one CUDA card.

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
  busy time per step; the bench's own `flame_fit`); and ms per rgb step
  (B = 4, splat, 256^2) with StageClock laps.

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

Phase J: the clinical engine at the size of a head CBCT.  A seeded skull
  phantom (Z, Y, X) = (320, 448, 448) at 0.3 mm, built on the card (a cranial
  shell 5 mm thick, an upper jaw and an arch-shaped mandible with 32 teeth,
  air -1000 HU, bone 1200 HU with partial volume at the edges, noise of 30
  HU), is written as a DICOM series of 320 slices (`write_dicom_slice`) and
  as a ToothFairy3-style NIfTI label volume.  The DICOM path
  (`dicom_to_bone_mesh` at the config's defaults: HU 300, 30 smoothing
  iterations, keep 0.5) is timed stage by stage (the read, the copy to the
  card, threshold, active cells, emission, dedup, clean, adjacency,
  smoothing, QEM on the host); the raw marching mesh must be closed (every
  edge in two faces) and enclose a positive volume within CT_VOLUME_SHARE of
  the phantom's bone voxels; the card's mesh must equal the port's own CPU
  path on a 128^3 crop (raw marching array for array, the whole pipeline's
  faces equal and vertices within 1e-5 mm, the cut's segments); then a
  single-mesh cut, a 5/3 mm move (fixed segments untouched, mobile ones
  moved along +Y) and an STL export.  The NIfTI path
  (`nifti_label_to_separate_meshes`) feeds a `PlanningSession` with no
  device (the card): preview, cut, `set_movement` 5/3 mm, undo and redo
  (the same segments back), a distance and an angle, STL / PLY / OBJ
  exports read back equal, the preview HTML.  Then `cli.main(["clinical",
  "--dicom", ...])` at the same cut must write the DICOM path's STL byte for
  byte, and the session's `surgical_plan()` goes to `render_prediction` on
  phase A's avatar for 2 frames: K1 launches once a frame, and the PNGs equal
  phase B's 5/3 mm frames within 1 grey level.  Printed: stage seconds,
  counts at each step, peak card memory.

Phase K: the parallel package, SPMD over torch.distributed, with rank groups
  of gloo processes sharing the one card (`chip_smoke.py --k-rank ...`, one
  process each; nccl refuses two ranks on a card).  The one-process runs come
  first, in this process: the trainer over a 30-step window from phase D's
  init (the bench avatar compacted to 73,728 slots, co-optimization on, the
  frame indices drawn once), twice each for the run-to-run spread (K2 sums
  with float atomics), and the tracker's landmark stages on phase I's clip.
  Then 2 ranks: phase B's 8 frames as 2 tile slabs (bases 0 and 512) against
  one K1 launch on the same binning (1e-4, PNG within 1 grey level); the
  gaussian-sharded loss on training frame 0 (CAPACITY slots, 65,536 alive):
  at K = 256, K1 and K2 on each rank's depth slice held to the plain version
  on the slice's inputs (TOL, GRAD_TOL), and at K_EXACT = 4096 with every
  large gaussian in the large window (no list overflows in either) the loss
  and every gradient, verts included, held to one process; the overflow
  counters at K = 256 printed (a depth slice keeps its own K nearest of a
  tile, one process K in all: the results differ there, as the reference's);
  ShardedAvatarTrainer over the window at K_EXACT (the first step's Adam
  moments, (1 - b1) x its gradient, at K2's bound of one process's for every
  gaussian field and FLAME key but for <= K_MOMENT_OUTSIDE of a leaf; the
  curve within max(4 x the spread,
  K_CURVE_FLOOR) of one process) and at K = 256 (the loss falls); frame-DP
  AvatarTrainer(mesh=) with batch_frames 2 at K = 256 (the same checks; the
  replicas equal bit for bit); FlameTracker(mesh=) on the clip (the landmark
  stages within rel 2e-3 of one process, K1 and K2 on each rank in 5 rgb
  steps, the replicas equal bit for bit).  Then 4 ranks: the 2 x 2 data x
  gauss trainer at K_EXACT (the same checks).  Then `python -m
  torch.distributed.run --standalone --nproc-per-node 2 -m
  omfs4d_torch.pipeline.cli run ... parallel.n_gauss=2` on phase I's stage
  cache, and the same `run` in one process, both at K_E2E_CAPACITY
  gaussians (the selfrecon PSNRs within K_E2E_PSNR_TOL).  Printed: the
  backend, world size and ranks per card; per case its seconds and K1 / K2
  launches per rank; the sharded ms/step beside the one-process one; one
  step's bytes and ms per collective (each call wrapped here, the device
  synchronized around it); peak memory per rank.

Phase L: the port's bench as a user runs it, in a process of its own:
  `python -m omfs4d_torch.scripts.bench --iters 20` at full shapes (512^2,
  65,536 alive gaussians, K = 256; the headline's 4 chunks of 50 iterations),
  under its watchdog budget.  Held: the last line parses, its backend is
  "cuda", its three rates and its headline are finite and positive, K1 and K2
  launched, 0 < mfu_f32 < 1, and the exit code is 0.  Printed: its seconds,
  rates, flops and bytes per step, shares, device work per call and marks
  (the flops by op family).  Its launches are its own process's: the kernels
  line does not count them.

    python3 chip_smoke.py --only-track
    python3 chip_smoke.py --only-nets
    python3 chip_smoke.py --only-e2e
    python3 chip_smoke.py --only-clinical
    python3 chip_smoke.py --only-parallel
    python3 chip_smoke.py --only-bench

run the set-up and phase G, H, I, J, K or L alone (no kernels line, no last
line): for work on the tracker, the front end, the pipeline, the clinical
engine, the parallel package or the bench (J renders its own phase-B
reference frames; K makes phase A and phase I's stage cache first).

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
every kernel's launches (the sum over phases B, D, G, H, I, J and K for K1 and K2,
phase K's summed over its ranks,
with each path's own under `launches_by_path`, the launches of one tracker rgb step
under `launches_per_tracker_step` and of one detector step under
`launches_per_detector_step`), error, ms, plain_ms, bound_ms (with
bound_by) and library_ms (one PyTorch call for the same function: `packed * 2` for V's
copy mode, none for the others).  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

# the port is imported from this script's own checkout, wherever it is run from
sys.path.insert(0, str(Path(__file__).resolve().parent))

# the bench's avatar, its flop and byte counts, the composite kernels' bounds
# and the FLAME-fit rate: one copy, in the port's bench
from omfs4d_torch.scripts.bench import (  # noqa: E402
    ALPHA_OPS, CHAIN_OPS, FIT_EXPR, FIT_SHAPE, STEP_OPS, SUM_OPS, Recorder, bench_avatar,
    bound_us, composite_bounds, flame_fit, grad_inputs, pair_counts, profiled_kernels)

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
FIT_FRAMES, FIT_STEPS, FIT_WARMUP = 150, 200, 20
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
# phase J: a head CBCT's size, (Z, Y, X) voxels at 0.3 mm (64.2 M voxels),
# the skull phantom's seed and noise, the crop held against the CPU path, the
# share by which the raw mesh's enclosed volume may differ from the phantom's
# bone voxels x the voxel volume, and the frames the plan renders
CT_SHAPE, CT_SPACING, CT_SEED, CT_NOISE_HU = (320, 448, 448), 0.3, 0, 30.0
CT_CROP = 128
CROP_ORIGIN = (4, 230, 160)      # the jaws' front: z -46 ... -8, y 2 ... 40, x -19 ... 19 mm
CT_VOLUME_SHARE = 0.03
BRIDGE_FRAMES = 2
# phase K: rank groups sharing the one card; the trainers' compared window,
# from phase D's init (the bench avatar compacted to 73,728 slots); the
# tracker's rgb steps on its ranks; the torchrun pipeline's iterations
K_PAIR, K_QUAD = 2, 4
K_STEPS = 30
K_COMPACTED = 73_728
K_RGB_STEPS = 5
K_E2E_ITERS = 60
# the per-tile capacity at which no list of the bench frame overflows, in one
# process or in a depth slice: the sharded and one-process losses and curves
# are held to each other there (every large gaussian in the large window)
K_EXACT = 4096
K_TIMEOUT_S = 400
# the trainers' 30-step curves are held to one process within max(4 x the
# one-process run-to-run spread, K_CURVE_FLOOR): the floor is 2.5 x the
# largest sharded-vs-one-process difference measured (1.2e-4, on an H100 SXM at 700 W)
K_CURVE_FLOOR = 3e-4
# the torchrun `run` and the same `run` in one process: both at the
# one-process trainer's own capacity for the asset (6 x 10,282 faces rounded
# up to 16,384), the selfrecon PSNRs within K_E2E_PSNR_TOL
K_E2E_CAPACITY = 65_536
K_E2E_PSNR_TOL = 0.5
# the first step's Adam moments, sharded against one process: K2's bound on
# every element but a share of at most K_MOMENT_OUTSIDE of each leaf.  A few
# sh / colour elements of gaussians at the edge of a tile's K-list or of a
# depth slice move by more than K2's noise when the forward is reassociated
# (70 per million at most, up to 7 x their bound, on an H100 SXM); a
# wrong transpose moves every element
K_MOMENT_OUTSIDE = 1e-3
# phase L: the port's bench as a user runs it, at full shapes with its timed
# loops cut to BENCH_ITERS (the headline's 4 chunks of 50 stay), in a process
# of its own under a watchdog budget
BENCH_ITERS = 20
BENCH_BUDGET_S, BENCH_TIMEOUT_S = 420, 600


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


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

    # ── FLAME-fit it/s, as the reference's bench defines it (the bench's own code) ──
    fit = flame_fit(model, cam, W, FIT_FRAMES, FIT_STEPS, FIT_WARMUP, device)
    check(np.isfinite(fit["loss"]), "finite FLAME-fit loss")
    print(f"  FLAME-fit: {fit['it_s']:.3f} it/s (T={FIT_FRAMES}, n_shape {FIT_SHAPE}, "
          f"n_expr {FIT_EXPR}, landmark loss + regularizers, {fit['groups']} Adam groups; "
          f"{FIT_STEPS} steps after {FIT_WARMUP}, host clock, synchronized at both ends: "
          f"{fit['ms_per_step']:.3f} ms/step); {fit['event_ms_per_step']:.3f} ms/step between "
          f"CUDA events; {fit['kernels']:.0f} kernels and {fit['busy_ms']:.3f} ms of device "
          f"time a step (torch.profiler, 20 steps) [{card}]")

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


# ── phase J: the clinical engine at the size of a head CBCT ────────────


def skull_phantom(shape, spacing: float, seed: int, device):
    """A seeded synthetic head CT on `device`: (HU int16, labels uint8), both
    (Z, Y, X) with Z superior, Y anterior and X toward the patient's right, in
    mm about the volume's centre.  A cranial shell 5 mm thick; below it a
    horseshoe upper jaw with 16 teeth; 2 mm below those an arch-shaped
    mandible with its posterior branches, its rami and 16 teeth.  HU: air
    -1000, bone 1200, partial volume at the edges (a 3-voxel box blur of the
    bone), seeded Gaussian noise of CT_NOISE_HU, rounded.  Labels in
    ToothFairy3's scheme: 1 lower jaw, 2 upper jaw, 11-28 upper and 31-48
    lower teeth (FDI), 5 and 6 the maxillary sinuses (air inside the shell);
    the cranium has none."""
    Z, Y, X = shape

    def axis(n, dims):
        return ((torch.arange(n, device=device, dtype=torch.float32) - (n - 1) / 2)
                * spacing).reshape(dims)

    z, y, x = axis(Z, (Z, 1, 1)), axis(Y, (1, Y, 1)), axis(X, (1, 1, X))

    def ellipsoid(c, r):
        return (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
                + ((z - c[2]) / r[2]) ** 2) <= 1

    def zband(lo, hi):
        return (z >= lo) & (z <= hi)

    def arch(yc, r0, r1):
        rho = torch.sqrt(x ** 2 + (y - yc) ** 2)
        return (rho >= r0) & (rho <= r1) & (y >= yc)

    side = (x.abs() >= 22) & (x.abs() <= 31)
    parts = [  # (mask, label), later ones over earlier ones
        (ellipsoid((0, -4, 14), (56, 60, 30)) & ~ellipsoid((0, -4, 14), (51, 55, 25)), 0),
        (arch(8, 19, 29) & zband(-26, -12), 2),
        ((arch(6, 22, 31) | (side & (y >= -14) & (y < 6))) & zband(-44, -34), 1),
        (side & (y >= -14) & (y <= -6) & zband(-34, -20), 1),
    ]
    for i in range(16):                       # FDI: 1 at the midline, 8 at the back
        theta = np.pi * (i + 0.5) / 16
        n = 8 - i if i < 8 else i - 7
        for yc, rho, zs, quadrants in ((8, 24.0, (-30, -25), (1, 2)), (6, 26.5, (-34, -32), (4, 3))):
            cx, cy = rho * np.cos(theta), yc + rho * np.sin(theta)
            tooth = ((x - cx) ** 2 + (y - cy) ** 2 <= 2.5 ** 2) & zband(*zs)
            parts.append((tooth, 10 * quadrants[i >= 8] + n))
    bone = torch.zeros(shape, dtype=torch.bool, device=device)
    labels = torch.zeros(shape, dtype=torch.uint8, device=device)
    for mask, label in parts:
        bone |= mask
        labels = torch.where(mask, label, labels)
    for cx, label in ((15, 5), (-15, 6)):
        labels = torch.where(ellipsoid((cx, 12, -2), (6, 6, 6)), label, labels)
    frac = torch.nn.functional.avg_pool3d(bone[None, None].float(), 3, stride=1, padding=1)[0, 0]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    noise = torch.randn(shape, generator=gen, device=device) * CT_NOISE_HU
    hu = torch.round(-1000.0 + 2200.0 * frac + noise).clamp(-1024, 3071).to(torch.int16)
    return hu, labels


class StageTimer:
    """Wraps functions of the port's modules so that each call is timed on
    the host clock between two synchronisations, and optionally keeps what
    it returns; `restore` puts the originals back."""

    def __init__(self):
        self.s = defaultdict(float)
        self.calls = defaultdict(int)
        self._undo = []

    def wrap(self, owner, attr: str, name: str, keep: list | None = None) -> None:
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.s[name] += time.perf_counter() - t0
            self.calls[name] += 1
            if keep is not None:
                keep.append(out)
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()

    def line(self, names) -> str:
        return ", ".join(f"{n} {self.s[n]:.3f}" + (f" ({self.calls[n]} calls)"
                                                   if self.calls[n] > 1 else "")
                         for n in names if self.calls[n])


def closed_and_outward(verts: torch.Tensor, faces: torch.Tensor) -> tuple[int, float]:
    """(edges not in exactly two faces, signed volume) of a triangle mesh;
    the volume is positive when the faces are wound outward."""
    e = torch.cat([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]).sort(dim=1).values
    _, counts = torch.unique(e[:, 0] * len(verts) + e[:, 1], return_counts=True)
    v = verts.double()
    a, b, c = v[faces[:, 0]], v[faces[:, 1]], v[faces[:, 2]]
    return int((counts != 2).sum()), float((a * torch.linalg.cross(b, c)).sum() / 6)


def same_mesh(a, b) -> tuple[bool, float]:
    """(faces equal array for array, max abs vertex difference) of two
    TriMeshes, on the host."""
    (va, fa), (vb, fb) = a.numpy(), b.numpy()
    if fa.shape != fb.shape or va.shape != vb.shape:
        return False, float("inf")
    return bool((fa == fb).all()), float(np.abs(va - vb).max()) if len(va) else 0.0


def moved_by(before, after, mm: float) -> float:
    """Largest deviation of `after` from `before` shifted by `mm` along +Y,
    the plan's default advancement direction."""
    d = after.vertices.double() - before.vertices.double()
    d[:, 1] -= mm
    return float(d.abs().max())


def two_frame_dataset(data_dir: Path, out: Path) -> Path:
    """A copy of the dataset that lists only its first BRIDGE_FRAMES frames."""
    shutil.copytree(data_dir, out, symlinks=True)
    for t in out.glob("transforms*.json"):
        meta = json.loads(t.read_text())
        meta["frames"] = meta["frames"][:BRIDGE_FRAMES]
        t.write_text(json.dumps(meta))
    return out


def write_bench_model(model, device, model_dir: Path) -> None:
    """Phase A's trained model: the bench avatar as a point cloud and the
    checkpoint meta with K = MAX_PER_TILE."""
    from omfs4d_torch.train.checkpoints import export_point_cloud

    export_point_cloud(model_dir / "point_cloud" / f"iteration_{ITERATION}"
                       / "point_cloud.ply", bench_avatar(model, device))
    (model_dir / "checkpoints").mkdir(parents=True)
    (model_dir / "checkpoints" / f"iter_{ITERATION:07d}_meta.json").write_text(
        json.dumps({"max_per_tile": MAX_PER_TILE,
                    "max_tiles_per_gaussian": TILES_PER_GAUSSIAN}))


def phase_b_frames(model, device, data_dir: Path, model_dir: Path, out: Path) -> list[Path]:
    """The Le Fort / BSSO frames of `data_dir` rendered as phase B renders
    them (create_modified_dataset + render_dataset_frames)."""
    from omfs4d_torch.predict.render_video import render_dataset_frames
    from omfs4d_torch.predict.surgery import compute_offset, create_modified_dataset
    from omfs4d_torch.train.checkpoints import (latest_iteration, load_point_cloud,
                                                trained_render_meta)

    it = latest_iteration(model_dir)
    gaussians = load_point_cloud(model_dir / "point_cloud" / f"iteration_{it}"
                                 / "point_cloud.ply", device=device)
    meta = trained_render_meta(model_dir, it)
    modified = create_modified_dataset(str(data_dir), compute_offset(LEFORT_MM, 1.0),
                                       compute_offset(BSSO_MM, 1.0))
    try:
        render_dataset_frames(model, gaussians, modified, out,
                              max_per_tile=int(meta["max_per_tile"]),
                              max_tiles_per_gaussian=max(16, int(meta["max_tiles_per_gaussian"])))
    finally:
        shutil.rmtree(modified, ignore_errors=True)
    return sorted(out.glob("*.png"))


def phase_j(model, device, card: str, work: Path, data_dir: Path,
            model_dir: Path | None = None, reference: list[Path] | None = None) -> dict:
    """The clinical engine at the size of a head CBCT: the phantom through
    both ingest paths, the cutter, the planning session, the CLI, and the
    plan's two scalars rendered; returns K1's launches and the figures."""
    from omfs4d_torch import native
    from omfs4d_torch.app.session import PlanningSession
    from omfs4d_torch.clinical import loader
    from omfs4d_torch.clinical.surgical import SurgicalCutter
    from omfs4d_torch.core.config import Config
    from omfs4d_torch.io.dicom import write_dicom_slice
    from omfs4d_torch.io.meshio import load_mesh, save_stl
    from omfs4d_torch.io.nifti import save_nifti
    from omfs4d_torch.io.video import read_image
    from omfs4d_torch.ops import marching
    from omfs4d_torch.ops import mesh as tmesh
    from omfs4d_torch.pipeline import cli
    from omfs4d_torch.predict.render_video import render_prediction
    from omfs4d_torch.render.composite import composite

    t_phase = time.perf_counter()
    work = work / "clinical"
    work.mkdir()
    c = Config().clinical
    Z, Y, X = CT_SHAPE
    secs = {}

    # ── the phantom, written as a DICOM series and a NIfTI label volume ──
    t0 = time.perf_counter()
    hu, labels = skull_phantom(CT_SHAPE, CT_SPACING, CT_SEED, device)
    bone_voxels = int((hu >= c.hu_threshold).sum())
    hu_np = hu.cpu().numpy()
    secs["phantom"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    series = work / "series"
    series.mkdir()
    raw = (hu_np.astype(np.int32) + 1024).astype(np.int16)
    for i in range(Z):
        write_dicom_slice(series / f"{i:04d}.dcm", raw[i], position=(0.0, 0.0, i * CT_SPACING),
                          pixel_spacing=(CT_SPACING, CT_SPACING), slice_thickness=CT_SPACING,
                          rescale_intercept=-1024.0)
    nifti = work / "labels.nii.gz"
    # ToothFairy3's layout: (i, j, k) = (x, y, z) with k running inferior, so
    # that the loader's Z flip puts the upper jaw up
    save_nifti(nifti, labels.permute(2, 1, 0).flip(2).cpu().numpy(),
               affine=np.diag([CT_SPACING] * 3 + [1.0]), spacing=(CT_SPACING,) * 3)
    secs["write"] = time.perf_counter() - t0
    present = sorted(int(v) for v in torch.unique(labels).tolist())
    check(present == sorted({0, 1, 2, 5, 6} | set(range(11, 19)) | set(range(21, 29))
                            | set(range(31, 39)) | set(range(41, 49))),
          f"every label of the phantom is present: {present}")
    print(f"phase J: skull phantom {Z} x {Y} x {X} at {CT_SPACING} mm ({Z * Y * X:,} voxels, "
          f"{hu.numel() * 2 / 1e6:.1f} MB int16, {hu.numel() * 4 / 1e6:.1f} MB float32), "
          f"{bone_voxels:,} voxels >= {c.hu_threshold} HU; {len(present) - 1} labels; built in "
          f"{secs['phantom']:.3f} s, written as {Z} DICOM slices + {nifti.name} "
          f"({nifti.stat().st_size / 1e6:.2f} MB) in {secs['write']:.3f} s [{card}]")

    # ── the DICOM path at the config's defaults ──
    timer, raw_mesh, active, cleaned = StageTimer(), [], [], []
    timer.wrap(loader, "load_dicom_series", "DICOM read")
    timer.wrap(loader, "_to_device", "host->card")
    timer.wrap(loader, "marching_cubes", "marching", keep=raw_mesh)
    timer.wrap(marching, "_threshold", "threshold")
    timer.wrap(marching, "_active_cells", "active cells", keep=active)
    timer.wrap(marching, "_emit_chunk", "emission")
    timer.wrap(marching, "_dedup", "dedup")
    timer.wrap(tmesh.TriMesh, "clean", "clean", keep=cleaned)
    timer.wrap(tmesh, "vertex_adjacency", "adjacency")
    timer.wrap(tmesh, "smooth_vertices", f"{c.smooth_iterations} smoothing iterations")
    timer.wrap(native, "qem_decimate", "QEM (host)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        bone = loader.dicom_to_bone_mesh(str(series), c.hu_threshold, c.smooth_iterations,
                                         c.decimate_fraction)
    finally:
        timer.restore()
    secs["dicom path"] = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(bone.device == device and bone.n_faces > 0, f"the bone mesh is on {bone.device}")
    rv, rf = raw_mesh[0]
    open_edges, volume = closed_and_outward(rv, rf)
    voxel_volume = bone_voxels * CT_SPACING ** 3
    check(open_edges == 0, f"the raw marching mesh is closed: {open_edges} edges not in "
                           f"exactly two faces")
    check(volume > 0 and abs(volume / voxel_volume - 1) <= CT_VOLUME_SHARE,
          f"the raw mesh encloses {volume:.1f} mm^3, outward, within {CT_VOLUME_SHARE:.0%} of "
          f"the {voxel_volume:.1f} mm^3 of voxels >= {c.hu_threshold} HU")
    dicom_stages = ("DICOM read", "host->card", "threshold", "active cells", "emission",
                    "dedup", "marching", "clean", "adjacency",
                    f"{c.smooth_iterations} smoothing iterations", "QEM (host)")
    print(f"phase J: dicom_to_bone_mesh at the defaults (HU {c.hu_threshold}, "
          f"{c.smooth_iterations} smoothing iterations, keep {c.decimate_fraction}) "
          f"{secs['dicom path']:.3f} s; peak card memory {peak_gb:.3f} GB "
          f"(torch.cuda.max_memory_allocated) [{card}]")
    print("  seconds per stage (synchronized host clock): " + timer.line(dicom_stages))
    print(f"  counts: {active[0].numel():,} active cells, {len(rf):,} triangles and {len(rv):,} "
          f"vertices raw (closed: every edge in two faces; enclosed {volume:.1f} mm^3 = "
          f"{volume / voxel_volume:.4f} x the voxels'), {cleaned[0].n_points:,} vertices / "
          f"{cleaned[0].n_faces:,} faces after clean, {bone.n_points:,} / {bone.n_faces:,} "
          f"after decimation")

    # the card's mesh held to the port's own CPU path on a crop of the phantom
    t0 = time.perf_counter()
    z0, y0, x0 = CROP_ORIGIN
    crop = hu_np[z0:z0 + CT_CROP, y0:y0 + CT_CROP, x0:x0 + CT_CROP].astype(np.float32)
    spacing = (CT_SPACING,) * 3
    cpu = torch.device("cpu")
    raws = [marching.marching_cubes(crop, c.hu_threshold, spacing, device=d) for d in (device, cpu)]
    check(all(torch.equal(a.cpu(), b) for a, b in zip(*raws)),
          f"raw marching on the {CT_CROP}^3 crop: card equals CPU array for array "
          f"({len(raws[1][1]):,} faces)")
    crops = [loader.hu_volume_to_bone_mesh(crop, spacing, c.hu_threshold, c.smooth_iterations,
                                           c.decimate_fraction, device=d) for d in (device, cpu)]
    faces_eq, vdiff = same_mesh(*crops)
    check(faces_eq and vdiff <= 1e-5, f"crop mesh: faces equal {faces_eq}, vertices within "
                                      f"{vdiff:.2e} <= 1e-5 mm, card vs CPU")
    cb = crops[1].bounds
    crop_cut = dict(lefort_z=float(cb[4] + 0.5 * (cb[5] - cb[4])), bsso_l_x=-10.0, bsso_r_x=10.0)
    segs = [SurgicalCutter(m).perform_cut(**crop_cut) for m in crops]
    for k in segs[0]:
        eq, d = same_mesh(segs[0][k], segs[1][k])
        check(eq and d <= 1e-5, f"crop cut {k}: card equals CPU ({d:.2e})")
    secs["crop parity"] = time.perf_counter() - t0
    print(f"  {CT_CROP}^3 crop at {CROP_ORIGIN}: raw marching, hu_volume_to_bone_mesh "
          f"({crops[0].n_faces:,} faces, vertices within {vdiff:.2e} mm) and the cut equal on "
          f"the card and the CPU; {secs['crop parity']:.3f} s")

    # single-mesh cut and move, exported as the CLI exports it
    b = bone.bounds
    # the upper jaw's middle (z = -21 of the phantom's -44 ... 44 mm) and
    # 18 mm either side of the midline
    cut = dict(lefort_z=float(b[4] + (23 / 88) * (b[5] - b[4])),
               bsso_l_x=float((b[0] + b[1]) / 2 - 18), bsso_r_x=float((b[0] + b[1]) / 2 + 18))
    cutter = SurgicalCutter(bone)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pieces = cutter.perform_cut(**cut)
    torch.cuda.synchronize()
    secs["dicom cut"] = time.perf_counter() - t0
    check(all(m.n_points > 0 for m in pieces.values()),
          "single-mesh cut: four segments, none empty: "
          + ", ".join(f"{k} {m.n_faces}" for k, m in pieces.items()))
    t0 = time.perf_counter()
    moved = cutter.move_segments(LEFORT_MM, BSSO_MM)
    torch.cuda.synchronize()
    secs["dicom move"] = time.perf_counter() - t0
    check(moved["upper_skull"] is pieces["upper_skull"]
          and moved["proximal_rami"] is pieces["proximal_rami"], "the fixed segments stay")
    dev_max = moved_by(pieces["mobile_maxilla"], moved["mobile_maxilla"], LEFORT_MM)
    dev_mand = moved_by(pieces["distal_mandible"], moved["distal_mandible"], BSSO_MM)
    check(dev_max <= 1e-4 and dev_mand <= 1e-4,
          f"mobile segments moved {LEFORT_MM} / {BSSO_MM} mm along +Y ({dev_max:.2e}, "
          f"{dev_mand:.2e})")
    t0 = time.perf_counter()
    combined = None
    for seg in moved.values():
        if seg.n_points:
            combined = seg if combined is None else combined.merge(seg)
    dicom_stl = work / "dicom_plan.stl"
    save_stl(dicom_stl, *combined.numpy())
    secs["dicom export"] = time.perf_counter() - t0
    print(f"  single-mesh cut at Le Fort z {cut['lefort_z']:.3f}, BSSO x {cut['bsso_l_x']:.3f} / "
          f"{cut['bsso_r_x']:.3f} mm: " + ", ".join(f"{k} {m.n_points:,} / {m.n_faces:,}"
                                                   for k, m in pieces.items())
          + f" (vertices / faces); cut {secs['dicom cut']:.3f} s, move {secs['dicom move']:.3f} s, "
          f"STL export {secs['dicom export']:.3f} s ({dicom_stl.stat().st_size / 1e6:.1f} MB)")

    # ── the NIfTI path into the planning session ──
    timer = StageTimer()
    timer.wrap(loader, "load_nifti", "NIfTI read")
    timer.wrap(loader, "_to_device", "host->card")
    timer.wrap(loader, "_label_mask", "label masks")
    timer.wrap(loader, "marching_cubes", "marching")
    timer.wrap(tmesh.TriMesh, "clean", "clean")
    timer.wrap(tmesh, "smooth_vertices", f"{c.smooth_iterations} smoothing iterations")
    timer.wrap(native, "qem_decimate", "QEM (host)")
    t0 = time.perf_counter()
    try:
        jaws = loader.nifti_label_to_separate_meshes(str(nifti))
    finally:
        timer.restore()
    secs["nifti path"] = time.perf_counter() - t0
    maxilla, mandible = jaws["maxilla_mesh"], jaws["mandible_mesh"]
    check(maxilla.n_faces > 0 and mandible.n_faces > 0 and maxilla.device == device
          and maxilla.center[2] > mandible.center[2],
          "separate jaws on the card, the upper jaw above the lower")
    print(f"phase J: nifti_label_to_separate_meshes {secs['nifti path']:.3f} s: " + timer.line(
        ("NIfTI read", "host->card", "label masks", "marching", "clean",
         f"{c.smooth_iterations} smoothing iterations", "QEM (host)"))
          + f"; maxilla {maxilla.n_points:,} / {maxilla.n_faces:,}, mandible "
          f"{mandible.n_points:,} / {mandible.n_faces:,}")

    session = PlanningSession()
    check(session.device == device, f"a session with no device is on the card: {session.device}")
    session.load_meshes(maxilla, mandible)
    plan_cut = dict(lefort_z=float(maxilla.center[2]),
                    bsso_l_x=float(mandible.center[0] - 18), bsso_r_x=float(mandible.center[0] + 18))
    preview = session.preview(**plan_cut)
    check({"lefort", "bsso_l", "bsso_r"} <= set(preview), "preview planes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seg0 = session.perform_cut(**plan_cut)
    torch.cuda.synchronize()
    secs["session cut"] = time.perf_counter() - t0
    check("_warnings" not in seg0 and all(seg0[k].n_points > 0 for k in session.ALL_SEGMENTS),
          "session cut: four segments, none empty: "
          + ", ".join(f"{k} {seg0[k].n_faces}" for k in session.ALL_SEGMENTS))
    t0 = time.perf_counter()
    seg1 = session.set_movement(maxilla_mm=LEFORT_MM, mandible_mm=BSSO_MM)
    torch.cuda.synchronize()
    secs["session move"] = time.perf_counter() - t0
    check(all(seg1[k] is seg0[k] for k in ("upper_skull", "proximal_rami")),
          "fixed segments do not move")
    dev_max = moved_by(seg0["mobile_maxilla"], seg1["mobile_maxilla"], LEFORT_MM)
    dev_mand = moved_by(seg0["distal_mandible"], seg1["distal_mandible"], BSSO_MM)
    check(dev_max <= 1e-4 and dev_mand <= 1e-4,
          f"session: mobile segments moved {LEFORT_MM} / {BSSO_MM} mm along +Y")
    undone = session.undo()
    check(session.movement.maxilla_mm == 0.0 and all(
        torch.equal(undone[k].vertices, seg0[k].vertices) for k in session.ALL_SEGMENTS),
        "undo gives the cut segments back")
    redone = session.redo()
    check(session.surgical_plan() == {"maxilla_mm": LEFORT_MM, "mandible_mm": BSSO_MM}
          and all(torch.equal(redone[k].vertices, seg1[k].vertices) and torch.equal(
              redone[k].faces, seg1[k].faces) for k in session.ALL_SEGMENTS),
          "redo gives the moved segments back")
    p_max = session.measure_distance(maxilla.center, mandible.center, snap_mesh=maxilla)
    rec_d = session.add_measurement("distance", [maxilla.center, mandible.center])
    rec_a = session.add_measurement("angle", [maxilla.center, (0.0, 0.0, 0.0), mandible.center])
    check(np.isfinite(p_max) and rec_d["value"].endswith(" mm") and rec_a["value"].endswith("°"),
          f"measurements: {rec_d['value']}, {rec_a['value']}, snapped {p_max:.3f} mm")
    merged = None
    for k in session.ALL_SEGMENTS:
        merged = redone[k] if merged is None else merged.merge(redone[k])
    mv, mf = merged.numpy()
    t0 = time.perf_counter()
    for ext in ("stl", "ply", "obj"):
        path = session.export(work / f"plan.{ext}")
        lv, lf = load_mesh(path)
        if ext == "stl":    # a triangle soup, vertices rounded to 6 decimals on load
            err, same = float(np.abs(lv[lf] - mv[mf]).max()), lf.shape == mf.shape
        else:
            same = lf.shape == mf.shape and bool((lf == mf).all()) and lv.shape == mv.shape
            err = float(np.abs(lv - mv).max()) if same else float("inf")
        check(same and err <= 1e-5, f"{ext} export loads back equal ({err:.2e})")
    secs["session export"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    html = session.write_preview_html(work / "plan.html", moved=True)
    check("<canvas" in html.read_text(), "the preview HTML holds its canvas")
    secs["preview html"] = time.perf_counter() - t0
    print(f"  session: cut {secs['session cut']:.3f} s ("
          + ", ".join(f"{k} {seg0[k].n_points:,} / {seg0[k].n_faces:,}" for k in session.ALL_SEGMENTS)
          + f"), move {secs['session move']:.3f} s, undo/redo equal, {rec_d['value']} and "
          f"{rec_a['value']}, STL/PLY/OBJ exported and read back equal "
          f"{secs['session export']:.3f} s, preview HTML {secs['preview html']:.3f} s "
          f"({html.stat().st_size / 1e6:.1f} MB)")

    # ── the CLI ──
    t0 = time.perf_counter()
    cli_stl = work / "cli_plan.stl"
    check(cli.main(["clinical", "--dicom", str(series), "--lefort-z", repr(cut["lefort_z"]),
                    "--bsso-l-x", repr(cut["bsso_l_x"]), "--bsso-r-x", repr(cut["bsso_r_x"]),
                    "--maxilla-mm", str(LEFORT_MM), "--mandible-mm", str(BSSO_MM),
                    "--out", str(cli_stl)]) == 0, "cli clinical returned 0")
    secs["cli"] = time.perf_counter() - t0
    lv, lf = load_mesh(cli_stl)
    check(len(lf) == combined.n_faces and np.isfinite(lv).all()
          and cli_stl.read_bytes() == dicom_stl.read_bytes(),
          "the CLI's STL loads back and equals the DICOM path's plan byte for byte")
    print(f"phase J: cli clinical --dicom at the same cut, 5/3 mm: {secs['cli']:.3f} s, "
          f"{len(lf):,} faces, the STL equals the DICOM path's")

    # ── the bridge: the session's plan renders with K1 ──
    if model_dir is None:
        model_dir = work / "model"
        write_bench_model(model, device, model_dir)
    frames = two_frame_dataset(data_dir, work / "two_frames")
    if reference is None:
        reference = phase_b_frames(model, device, frames, model_dir, work / "phase_b")
    ref = [read_image(p).astype(int) for p in reference[:BRIDGE_FRAMES]]
    plan = session.surgical_plan()
    before = composite.launches, composite.backward_launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = render_prediction(model_dir, frames, model, work / "plan.mp4",
                               lefort_mm=plan["maxilla_mm"], bsso_mm=plan["mandible_mm"],
                               device=device)
    torch.cuda.synchronize()
    secs["bridge"] = time.perf_counter() - t0
    fwd = composite.launches - before[0]
    bwd = composite.backward_launches - before[1]
    check(fwd == BRIDGE_FRAMES and bwd == 0,
          f"K1 launches {fwd} == {BRIDGE_FRAMES} rendered frames, K2 {bwd} == 0")
    got = [read_image(p).astype(int) for p in sorted(Path(result["renders_dir"]).glob("*.png"))]
    grey = max(int(np.abs(a - r).max()) for a, r in zip(got, ref))
    check(len(got) == BRIDGE_FRAMES and grey <= 1,
          f"the plan's {len(got)} frames equal phase B's 5/3 mm frames within 1 grey level ({grey})")
    print(f"phase J: bridge {plan} -> render_prediction, {BRIDGE_FRAMES} frames in "
          f"{secs['bridge']:.3f} s, K1 launches {fwd}, max grey difference to phase B {grey}")
    secs["phase"] = time.perf_counter() - t_phase
    print(f"phase J ran in {secs['phase']:.2f} s [{card}]")
    return {"fwd": fwd, "bwd": bwd, "secs": secs}


# ── phase K: the parallel package, rank groups on the one card ──────────


def k_trainer_setup(model, data_path: Path, device, batch: int):
    """Phase D's init for the compared trainers: the bench avatar compacted
    to K_COMPACTED slots (alive rows first, as compact_to_alive leaves
    them), the phase-A data, FLAME co-optimization on, no densify or reset."""
    from omfs4d_torch.core.config import TrainConfig

    data, params = training_data(model, data_path, device)
    cfg = TrainConfig(iterations=K_STEPS, densify_interval=0, opacity_reset_interval=0,
                      batch_frames=batch)
    return cfg, data, params, bench_avatar(model, device, K_COMPACTED)


def k_frame_draws(batch: int) -> list[list[int]]:
    """The compared window's frame indices, one list per step (every rank
    and the one-process run take the same)."""
    rng = np.random.default_rng(2)
    return [rng.integers(0, N_FRAMES, size=batch).tolist() for _ in range(K_STEPS)]


def k_first_moments(tr, st) -> dict:
    """Adam's first moments after the window's first step, whole (gathered
    from a sharded trainer's rows, a collective there): (1 - b1) x that
    step's gradient, per gaussian field and co-optimized FLAME key.  A loss
    curve cannot see a gradient off by a constant factor, since Adam divides
    it out; these moments can."""
    if hasattr(tr, "gather_state"):
        st = tr.gather_state(st)
    out = {k: v.detach().clone() for grp in st.opt_state.values() for k, v in grp["mu"].items()}
    for grp in (st.flame_opt_state or {}).values():
        out.update({"flame_" + k: v.detach().clone() for k, v in grp["mu"].items()})
    return out


def k_one_process_curve(model, data_path: Path, device, batch: int, K: int,
                        large_frac: float) -> tuple[list, float, dict]:
    """The one-process trainer over the compared window at per-tile capacity
    K: (losses, ms/step, the first step's `k_first_moments`)."""
    from omfs4d_torch.train.trainer import AvatarTrainer, init_opt_state

    cfg, data, params, g = k_trainer_setup(model, data_path, device, batch)
    tr = AvatarTrainer(model.faces.cpu().numpy(), cfg, SIZE, SIZE, max_per_tile=K,
                       flame_model=model)
    tr.render_cfg["large_frac"] = large_frac
    st = tr.init_state(capacity=K_COMPACTED, flame_params=params)
    st = st._replace(gaussians=g, opt_state=init_opt_state(g))
    tdata = {k: (v if torch.is_tensor(v) else torch.from_numpy(v)).to(device)
             for k, v in data.items()}
    losses, m1 = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in k_frame_draws(batch):
        st, m = tr.train_step(st, tdata, idx)
        losses.append(m["loss"])
        m1 = m1 or k_first_moments(tr, st)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / K_STEPS * 1e3
    return [float(v) for v in losses], ms, m1


def k_rank(group: str, rank: int, world: int, port: int, work: Path) -> None:
    """One rank of a phase-K group: joins the gloo group on the card, runs
    the group's cases and writes `work/k_<group>_<rank>.json`."""
    from omfs4d_torch.models.assets import synthetic_flame_asset
    from omfs4d_torch.models.flame import FlameModel
    from omfs4d_torch.parallel import collectives as C
    from omfs4d_torch.parallel.distributed import init_distributed
    from omfs4d_torch.parallel.mesh import Mesh
    from omfs4d_torch.render.composite import composite

    device = init_distributed(f"tcp://127.0.0.1:{port}", world, rank)
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=N_VERTICES, seed=0),
                                  device=device)
    data_path = work / "data"
    out = {"backend": torch.distributed.get_backend(), "world": world,
           "ranks_per_card": world / torch.cuda.device_count(), "cases": {}}
    torch.cuda.reset_peak_memory_stats()

    def case(name, fn):
        composite.launches = composite.backward_launches = 0
        C.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        res.setdefault("k1", composite.launches)
        res.setdefault("k2", composite.backward_launches)
        res["collectives"] = {op: {"calls": C.calls[op], "bytes": C.traffic[op]}
                              for op in C.OPS}
        out["cases"][name] = res

    if group == "pair":
        mesh = Mesh(np.arange(world), ("tile",))
        case("tile", lambda: k_tile_render(model, work, device, mesh))
        gmesh = Mesh(np.arange(world), ("gauss",))
        case("gauss_loss", lambda: k_gauss_loss(model, data_path, device, gmesh))
        case("sharded_1d", lambda: k_sharded_curve(model, data_path, device, gmesh, None, 1,
                                                   K_EXACT, 1.0, "exact_1"))
        case("sharded_1d_k256", lambda: k_sharded_curve(model, data_path, device, gmesh, None,
                                                        1, MAX_PER_TILE, 0.125, None))
        dmesh = Mesh(np.arange(world), ("data",))
        case("frame_dp", lambda: k_frame_dp(model, data_path, device, dmesh))
        case("tracker", lambda: k_tracker(model, work, device, dmesh))
    else:
        mesh2 = Mesh(np.arange(world).reshape(2, world // 2), ("data", "gauss"))
        case("sharded_2d", lambda: k_sharded_curve(model, data_path, device, mesh2, "data", 2,
                                                   K_EXACT, 1.0, "exact_2"))
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    (work / f"k_{group}_{rank}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()


def k_tile_render(model, work: Path, device, mesh) -> dict:
    """Phase B's frames (the bench avatar under Le Fort 5 / BSSO 3 mm), each
    as 2 tile slabs (bases 0 and 512 of the 1,024 tiles), against one K1
    launch of the whole grid on the same binning."""
    from omfs4d_torch.io.dataset import FrameDataset
    from omfs4d_torch.models.flame import flame_forward
    from omfs4d_torch.models.gaussians import bind_to_mesh, eval_colors
    from omfs4d_torch.ops.camera import project_gaussians
    from omfs4d_torch.parallel.shard import composite_tile_sharded
    from omfs4d_torch.predict.render_video import batched_frame_params
    from omfs4d_torch.render.composite import composite
    from omfs4d_torch.render.rasterize import bin_gaussians
    from omfs4d_torch.train.checkpoints import load_point_cloud

    g = load_point_cloud(next((work / "model" / "point_cloud").glob("iteration_*"))
                         / "point_cloud.ply", device=device)
    ds = FrameDataset(work / "modified")
    errs, greys, k1 = [], [], 0
    with torch.inference_mode():
        verts = flame_forward(model, batched_frame_params(ds))
        for i in range(len(ds)):
            cam = ds.camera(i, device=device)
            means, rot, scales, opac, _ = bind_to_mesh(g, verts[i], model.faces)
            cols = eval_colors(g, means, cam.position)
            proj = project_gaussians(cam, means, rot, scales)
            b = bin_gaussians(proj, opac, SIZE, SIZE, max_per_tile=MAX_PER_TILE,
                              max_tiles_per_gaussian=36)
            before = composite.launches
            img, alpha = composite_tile_sharded(proj["uv"], proj["conic"], cols, opac, b,
                                                SIZE, SIZE, 16, mesh, "tile")
            k1 += composite.launches - before
            one, one_a = composite(proj["uv"], proj["conic"], cols, opac, b, SIZE, SIZE, 16)
            errs.append(max(float((img - one).abs().max()), float((alpha - one_a).abs().max())))
            greys.append(int(np.abs(quantize(img + (1 - alpha)[..., None]).astype(int)
                                    - quantize(one + (1 - one_a)[..., None]).astype(int)).max()))
    return {"frames": len(ds), "max_abs_err": max(errs), "grey": max(greys), "k1": k1,
            "base": mesh.axis_index("tile") * (SIZE // 16) ** 2 // mesh.axis_size("tile")}


def k_grads_within(got, want, names) -> dict:
    """Per leaf: max abs error, scale and the elements outside K2's bound.
    As in tests/test_torch_train.py, atol gains 1e-10: a gradient that is 0
    analytically (the quaternions of the isotropic bench cloud) is rounding
    noise of ~1e-11."""
    out = {}
    for k, a, b in zip(names, got, want):
        scale = max(b.abs().max().item(), 1e-12)
        ratio = (a - b).abs() / (GRAD_TOL[0] * scale + 1e-10 + GRAD_TOL[1] * b.abs())
        out[k] = {"max_abs_err": (a - b).abs().max().item(), "scale": scale,
                  "outside": int((ratio > 1).sum()), "excess": ratio.max().item(),
                  "size": b.numel(),
                  "finite": bool(torch.isfinite(a).all())}
    return out


def k_gauss_loss(model, data_path: Path, device, mesh) -> dict:
    """avatar_loss_gaussian_sharded on training frame 0, the bench avatar in
    CAPACITY slots (65,536 alive) split over the ranks.  At K = 256: K1 and
    K2 on this rank's depth slice (the inputs `composite_lists` was given)
    against the plain version on the card.  At K_EXACT, every large gaussian
    in the large window: no list overflows in either, so the sharded loss
    and every gradient are held to the one-process loss's (at K = 256 each
    depth slice keeps its own K nearest of a tile, one process K in all, as
    in the reference)."""
    from omfs4d_torch.models.gaussians import bind_to_mesh, eval_colors
    from omfs4d_torch.parallel import shard
    from omfs4d_torch.render.composite import _slab_pixel_centers, composite
    from omfs4d_torch.render.rasterize import composite_tiles_torch, rasterize
    from omfs4d_torch.train.trainer import FLOAT_FIELDS, _frame_camera

    data, _ = training_data(model, data_path, device)
    g = bench_avatar(model, device, CAPACITY)
    verts = data["verts"][0].to(device)
    cam = _frame_camera({k: torch.as_tensor(v).to(device) for k, v in data.items()}, 0,
                        SIZE, SIZE)
    gt = torch.as_tensor(data["images"][0]).to(device).float() / 255.0
    n, i = mesh.axis_size("gauss"), mesh.axis_index("gauss")
    sl = slice(i * CAPACITY // n, (i + 1) * CAPACITY // n)
    names = list(FLOAT_FIELDS) + ["verts"]

    def sharded(K, large_frac):
        fl = {k: getattr(g, k)[sl].detach().clone().requires_grad_() for k in FLOAT_FIELDS}
        v = verts.clone().requires_grad_()
        local = shard.fields_of(g, fl)._replace(parent_face=g.parent_face[sl],
                                                alive=g.alive[sl])
        loss, aux = shard.avatar_loss_gaussian_sharded(
            local, v, model.faces, cam, gt, mesh=mesh, max_per_tile=K, large_frac=large_frac,
            return_aux=True)
        return loss, torch.autograd.grad(loss, list(fl.values()) + [v]), aux

    def one(K, large_frac):
        fl = {k: getattr(g, k).detach().clone().requires_grad_() for k in FLOAT_FIELDS}
        v = verts.clone().requires_grad_()
        g1 = shard.fields_of(g, fl)
        means, rot, scales, opac, _ = bind_to_mesh(g1, v, model.faces)
        img, aux = rasterize(means, rot, scales, opac, eval_colors(g1, means, cam.position),
                             cam, SIZE, SIZE, max_per_tile=K, large_frac=large_frac)
        loss = torch.mean(torch.abs(img - gt))
        grads = torch.autograd.grad(loss, list(fl.values()) + [v])
        return loss, [gr if k == "verts" else gr[sl] for k, gr in zip(names, grads)], aux

    def timed(fn, *args):
        fn(*args)                              # the first call allocates
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # K = 256: the slice's composite, kernel against plain
    seen, real = [], shard.composite_lists
    shard.composite_lists = lambda *a, **kw: seen.append(a) or real(*a, **kw)
    try:
        before = (composite.launches, composite.backward_launches)
        (loss256, _, aux256), ms = timed(sharded, MAX_PER_TILE, 0.125)
        k1, k2 = composite.launches - before[0], composite.backward_launches - before[1]
    finally:
        shard.composite_lists = real
    uv, conic, cols, opac, lists, counts, tile, grid_w = (
        t.detach() if torch.is_tensor(t) else t for t in seen[-1])
    cot = [torch.randn((lists.shape[0], tile * tile) + s, generator=torch.Generator(
        device=device).manual_seed(3), device=device) for s in ((3,), ())]
    res = {}
    for where in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in (uv, conic, cols, opac)]
        if where == "kernel":
            col, alp = real(*leaves, lists, counts, tile, grid_w)
        else:
            pix = _slab_pixel_centers(0, lists.shape[0], tile, grid_w, device)
            col, alp = composite_tiles_torch(*leaves, lists, counts, pix)
        res[where] = [col.detach(), alp.detach(),
                      *torch.autograd.grad([col, alp], leaves, cot)]
    fwd_err = max((res["kernel"][j] - res["plain"][j]).abs().max().item() for j in (0, 1))
    slice_grads = k_grads_within(res["kernel"][2:], res["plain"][2:],
                                 ["uv", "conic", "colors", "opacity"])
    (one256, _, one_aux256), one_ms = timed(one, MAX_PER_TILE, 0.125)
    # K_EXACT: the same function in both
    loss_x, grads_x, aux_x = sharded(K_EXACT, 1.0)
    one_x, one_grads_x, one_aux_x = one(K_EXACT, 1.0)
    return {"loss": float(loss256.detach()), "one_loss": float(one256.detach()), "ms": ms,
            "one_ms": one_ms, "overflow": int(aux256["overflow"]),
            "one_overflow": int(one_aux256["overflow"]), "spilled": int(aux256["spilled"]),
            "entries": int(counts.sum()), "slice_fwd_err": fwd_err,
            "slice_grads": slice_grads, "exact_loss": float(loss_x.detach()),
            "exact_one_loss": float(one_x.detach()),
            "exact_overflow": [int(aux_x["overflow"]), int(one_aux_x["overflow"])],
            "exact_spilled": [int(aux_x["spilled"]), int(one_aux_x["spilled"])],
            "exact_grads": k_grads_within(grads_x, one_grads_x, names), "k1": k1, "k2": k2}


def k_sharded_curve(model, data_path: Path, device, mesh, data_axis, batch: int, K: int,
                    large_frac: float, ref: str | None) -> dict:
    """ShardedAvatarTrainer over the compared window from phase D's init, at
    per-tile capacity K; its first step's moments held to the one-process
    run `ref`'s."""
    from omfs4d_torch.parallel.sharded_trainer import ShardedAvatarTrainer

    cfg, data, params, g = k_trainer_setup(model, data_path, device, batch)
    tr = ShardedAvatarTrainer(model.faces.cpu().numpy(), cfg, SIZE, SIZE, mesh=mesh,
                              max_per_tile=K, flame_model=model, data_axis=data_axis)
    tr.render_cfg["large_frac"] = large_frac
    st = tr.init_state(gaussians=g, flame_params=params)
    tdata = {k: (v if torch.is_tensor(v) else torch.from_numpy(v)).to(device)
             for k, v in data.items()}
    return k_run_window(tr, st, tdata, batch, ref and data_path.parent / f"k_m1_{ref}.pt")


def k_frame_dp(model, data_path: Path, device, mesh) -> dict:
    """AvatarTrainer(mesh=) over the compared window, batch_frames 2."""
    from omfs4d_torch.train.trainer import AvatarTrainer, init_opt_state

    cfg, data, params, g = k_trainer_setup(model, data_path, device, 2)
    tr = AvatarTrainer(model.faces.cpu().numpy(), cfg, SIZE, SIZE, max_per_tile=MAX_PER_TILE,
                       flame_model=model, mesh=mesh)
    st = tr.init_state(capacity=K_COMPACTED, flame_params=params)
    st = st._replace(gaussians=g, opt_state=init_opt_state(g))
    tdata = {k: (v if torch.is_tensor(v) else torch.from_numpy(v)).to(device)
             for k, v in data.items()}
    res = k_run_window(tr, st, tdata, 2, data_path.parent / "k_m1_k256_2.pt")
    res["state_hash"] = k_state_hash(st)
    return res


def k_run_window(tr, st, tdata, batch: int, m1_ref: Path | None) -> dict:
    """K_STEPS steps on `k_frame_draws`: losses; the first step's moments
    against the one-process run's in `m1_ref` (K2's bound); ms per step over
    the steps between the first and the last (host clock, synchronized); the
    last step's collectives, bytes and ms each (`k_timed_collectives`)."""
    from omfs4d_torch.parallel import collectives as C

    draws = k_frame_draws(batch)
    st, m = tr.train_step(st, tdata, draws[0])
    losses = [m["loss"]]
    m1 = k_first_moments(tr, st)
    res = {}
    if m1_ref is not None:
        want = torch.load(m1_ref, map_location=m1["mu_local"].device)
        res["first_moments"] = k_grads_within([m1[k] for k in want], list(want.values()),
                                              list(want))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in draws[1:-1]:
        st, m = tr.train_step(st, tdata, idx)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (K_STEPS - 2) * 1e3
    C.reset_counters()
    with k_timed_collectives() as millis:
        st, m = tr.train_step(st, tdata, draws[-1])
    losses.append(m["loss"])
    step = {op: {"calls": C.calls[op], "bytes": C.traffic[op], "ms": millis[op]}
            for op in C.OPS}
    return {"losses": [float(v) for v in losses], "ms": ms, "step_collectives": step, **res}


@contextlib.contextmanager
def k_timed_collectives():
    """Wrap each collective of `omfs4d_torch.parallel.collectives` for the
    block: the ms of each call (host clock, the device synchronized before
    and after) add up in the dict it yields, by collective."""
    from omfs4d_torch.parallel import collectives as C

    millis = {op: 0.0 for op in C.OPS}
    real = {"all_reduce_": "all_reduce", "all_gather": "all_gather",
            "all_to_all": "all_to_all", "broadcast_": "broadcast"}

    def timed(fn, op):
        def inner(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            millis[op] += (time.perf_counter() - t0) * 1e3
            return out
        return inner

    fns = {name: getattr(C, name) for name in real}
    for name, op in real.items():
        setattr(C, name, timed(fns[name], op))
    try:
        yield millis
    finally:
        for name, fn in fns.items():
            setattr(C, name, fn)


def k_state_hash(st) -> str:
    import hashlib

    from omfs4d_torch.train.checkpoints import state_to_dict

    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif x is not None:
            h.update(x.detach().cpu().numpy().tobytes())

    walk(state_to_dict(st))
    return h.hexdigest()


def k_tracker_inputs(model, work: Path, device):
    from omfs4d_torch.core.config import TrackConfig
    from omfs4d_torch.io.synthetic import orbit_c2w_nerf
    from omfs4d_torch.io.video import read_image
    from omfs4d_torch.ops.camera import camera_from_nerf

    images = work / "e2e" / "capture" / "images"
    frames = np.stack([read_image(p) for p in sorted(images.glob("*.png"))])
    lmk = np.load(images / "landmarks.npz")
    cam = camera_from_nerf(orbit_c2w_nerf(1)[0], SIZE * 1.8, SIZE * 1.8, SIZE / 2, SIZE / 2,
                           SIZE, SIZE, device=device)
    cfg = TrackConfig(**TRACK_STEPS, rgb_downsample=2)
    return cfg, cam, frames, lmk["landmarks"], lmk["valid"]


def k_tracker_stages(tracker, frames, landmarks, valid, rgb_steps: int) -> dict:
    """The landmark stages (at their cut step counts), then `rgb_steps` of
    rgb_init_all; returns the stages' losses and seconds."""
    from omfs4d_torch.core.logging import EventLogger

    rec = []
    ev = EventLogger()
    ev.emit = lambda event, **f: rec.append(f)
    cfg = tracker.cfg
    data = {"landmarks": torch.as_tensor(landmarks).to(tracker.device, torch.float32),
            "valid": torch.as_tensor(valid).to(tracker.device),
            "frames": tracker._prep_frames(frames)}
    p = tracker.init_params(len(landmarks))
    p = tracker._run_stage("lmk_init_rigid", p, cfg.steps_lmk_init_rigid,
                           ("rotation", "translation", "focal_log_scale"), 1.0, 0.0, data, ev)
    p = tracker._run_stage("lmk_init_all", p, cfg.steps_lmk_init_all,
                           ("shape", "expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose",
                            "translation", "focal_log_scale"), 1.0, 0.0, data, ev)
    if rgb_steps:
        p = tracker._run_stage("rgb_init_all", p, rgb_steps,
                               ("shape", "expr", "rotation", "neck_pose", "jaw_pose",
                                "eyes_pose", "translation", "texture"), 0.3, 1.0, data, ev)
    return {"losses": {r["stage"]: r["loss"] for r in rec},
            "seconds": {r["stage"]: r["seconds"] for r in rec},
            "params_hash": k_params_hash(p)}


def k_params_hash(p: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(p):
        h.update(p[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def k_tracker(model, work: Path, device, mesh) -> dict:
    """FlameTracker(mesh=) on phase G's clip (phase I's copy): the landmark
    stages and K_RGB_STEPS rgb steps, each rank its block of the 8 frames."""
    from omfs4d_torch.track.fitter import FlameTracker

    cfg, cam, frames, lmk, valid = k_tracker_inputs(model, work, device)
    tracker = FlameTracker(model, cfg, cam, (SIZE, SIZE), max_per_tile=MAX_PER_TILE, mesh=mesh,
                           device=device)
    return k_tracker_stages(tracker, frames, lmk, valid, K_RGB_STEPS)


def k_spawn(group: str, world: int, work: Path) -> list[dict]:
    """Start `world` rank processes of `group` on the card and wait for
    them; a rank that fails fails the phase."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--k-rank", group,
                               str(r), str(world), str(port), str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.time() + K_TIMEOUT_S
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=max(deadline - time.time(), 1))[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    bad = [r for r, proc in enumerate(procs) if proc.returncode != 0]
    if bad:
        for r in bad:
            print(f"phase K rank {r} of {group} exited {procs[r].returncode}:\n{logs[r][-6000:]}",
                  file=sys.stderr)
        raise RuntimeError(f"phase K: ranks {bad} of the {group} group failed")
    return [json.loads((work / f"k_{group}_{r}.json").read_text()) for r in range(world)]


def k_curve_err(got: list, ref: list) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref)) / np.abs(np.asarray(ref))))


def k_stage_cache(model, device, work: Path) -> None:
    """Phase I's stage cache, for --only-parallel: the clip, `cli preprocess`
    and `cli track` in this process, at phase I's settings."""
    from omfs4d_torch.pipeline import cli

    images, _, _ = tracking_clip(model, device, work / "e2e")
    common = ["--workdir", str(work / "e2e" / "wd"),
              *[f"track.{k}={v}" for k, v in TRACK_STEPS.items()],
              f"pipeline.min_train_frames={N_FRAMES}"]
    check(cli.main(["preprocess", "--video", str(images), *common]) == 0, "cli preprocess")
    stage = next((work / "e2e" / "wd" / "stages").glob("preprocess-*"))
    shutil.copy2(images / "landmarks.npz", stage / "landmarks.npz")
    check(cli.main(["track", "--frames-dir", str(stage), "--landmarks", "auto", *common]) == 0,
          "cli track")


def phase_k(model, device, card: str, work: Path, modified: Path) -> dict:
    """The parallel package on the one card: rank groups of gloo processes
    sharing it (2, then 4), each case held to the one-process run made here,
    in the same call; then the CLI under torchrun.  Returns the K1 / K2
    launches summed over the ranks and cases."""
    from omfs4d_torch.core.config import TrackConfig  # noqa: F401  (the ranks' widths)
    from omfs4d_torch.track.fitter import FlameTracker

    t_phase = time.perf_counter()
    clip = work / "e2e" / "capture" / "images"
    if not clip.exists():
        tracking_clip(model, device, work / "e2e")
    if not (work / "modified").exists():
        (work / "modified").symlink_to(modified)

    # the one-process runs: the trainers' run-to-run spread (K2 sums with
    # float atomics), the curves, the tracker's landmark stages
    t0 = time.perf_counter()
    one = {}
    for key, batch, K, frac in (("exact_1", 1, K_EXACT, 1.0), ("exact_2", 2, K_EXACT, 1.0),
                                ("k256_2", 2, MAX_PER_TILE, 0.125)):
        a, ms, m1a = k_one_process_curve(model, work / "data", device, batch, K, frac)
        b, _, m1b = k_one_process_curve(model, work / "data", device, batch, K, frac)
        torch.save(m1a, work / f"k_m1_{key}.pt")
        # the first step's moments run to run: K2's atomics against its bound
        m1_spread = k_grads_within(list(m1b.values()), list(m1a.values()), list(m1a))
        one[key] = {"losses": a, "ms": ms, "spread": k_curve_err(b, a),
                    "m1_outside": sum(g["outside"] for g in m1_spread.values()),
                    "m1_excess": max(g["excess"] for g in m1_spread.values())}
    cfg, cam, frames, lmk, valid = k_tracker_inputs(model, work, device)
    tracker = FlameTracker(model, cfg, cam, (SIZE, SIZE), max_per_tile=MAX_PER_TILE,
                           device=device)
    one_track = k_tracker_stages(tracker, frames, lmk, valid, 0)
    ref_s = time.perf_counter() - t0
    bounds = {k: max(4 * v["spread"], K_CURVE_FLOOR) for k, v in one.items()}
    print(f"phase K: one-process trainer references in {ref_s:.2f} s, {K_STEPS} steps twice "
          "each: " + "; ".join(
              f"{k} {v['ms']:.3f} ms/step, run-to-run spread (max rel) {v['spread']:.3e}, "
              f"bound max(4 x spread, {K_CURVE_FLOOR:g}) {bounds[k]:.3e}, first-step moments "
              f"run to run at worst {v['m1_excess']:.3f} x K2's bound ({v['m1_outside']} "
              f"outside)" for k, v in one.items())
          + f" [{card}]")

    t0 = time.perf_counter()
    pair = k_spawn("pair", K_PAIR, work)
    pair_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    quad = k_spawn("quad", K_QUAD, work)
    quad_s = time.perf_counter() - t0
    for label, ranks, secs in (("pair", pair, pair_s), ("quad", quad, quad_s)):
        r0 = ranks[0]
        print(f"phase K: {label} group: backend {r0['backend']}, world {r0['world']}, "
              f"{r0['ranks_per_card']:g} ranks per card, CUDA tensors handed to the backend "
              f"as they are; {secs:.2f} s with start-up; peak MiB per "
              f"rank {[round(r['peak_mib'], 1) for r in ranks]}")
        for name in r0["cases"]:
            cs = [r["cases"][name] for r in ranks]
            print(f"  case {name}: {max(c['seconds'] for c in cs):.2f} s; K1 per rank "
                  f"{[c['k1'] for c in cs]}, K2 per rank {[c['k2'] for c in cs]}")
            if "step_collectives" in cs[0]:
                sc = cs[0]["step_collectives"]
                print("    one step's collectives on rank 0 (device synchronized around "
                      "each): " + ", ".join(
                          f"{op} {sc[op]['calls']}x {sc[op]['bytes'] / 2 ** 20:.3f} MiB "
                          f"{sc[op]['ms']:.3f} ms" for op in ("all_to_all", "all_gather",
                                                              "all_reduce", "broadcast")))
    checks = []
    # 1. tile-sharded render
    for r, rr in enumerate(pair):
        c = rr["cases"]["tile"]
        checks.append((c["max_abs_err"] <= TOL and c["grey"] <= 1 and c["k1"] == c["frames"]
                       and c["base"] == r * (SIZE // 16) ** 2 // K_PAIR,
                       f"tile slabs rank {r} (base {c['base']}): max abs err "
                       f"{c['max_abs_err']:.3e} <= {TOL}, PNG {c['grey']} <= 1 grey level, "
                       f"K1 {c['k1']} == {c['frames']} frames"))
    # 2. gaussian-sharded loss: K1 and K2 on each depth slice, and the loss
    # against one process where no list overflows
    for r, rr in enumerate(pair):
        c = rr["cases"]["gauss_loss"]
        rel = abs(c["exact_loss"] - c["exact_one_loss"]) / c["exact_one_loss"]
        print(f"  gauss_loss rank {r}, K = {MAX_PER_TILE}: loss {c['loss']:.6f} (one process "
              f"{c['one_loss']:.6f}); pairs dropped by K: {c['overflow']} over the depth slices, "
              f"{c['one_overflow']} in one process; spilled {c['spilled']}; step ms "
              f"{c['ms']:.3f} vs one process {c['one_ms']:.3f} (second call) [{card}]")
        print(f"    this rank's depth slice: {c['entries']} list entries; K1 vs plain max abs "
              f"err {c['slice_fwd_err']:.3e}; K2: " + ", ".join(
                  f"d{k} {gk['max_abs_err']:.3e} of {gk['scale']:.3e} ({gk['outside']} outside)"
                  for k, gk in c["slice_grads"].items()))
        print(f"    K = {K_EXACT}, large_frac 1: overflow {c['exact_overflow']}, spilled "
              f"{c['exact_spilled']} (sharded, one process); loss {c['exact_loss']:.7f} vs "
              f"{c['exact_one_loss']:.7f} (rel {rel:.2e}); " + ", ".join(
                  f"d{k} {gk['max_abs_err']:.3e} of {gk['scale']:.3e} ({gk['outside']} outside)"
                  for k, gk in c["exact_grads"].items()))
        checks.append((c["slice_fwd_err"] <= TOL and c["k1"] == 2 and c["k2"] == 2
                       and all(g["outside"] == 0 and g["finite"]
                               for g in c["slice_grads"].values()),
                       f"depth slice of rank {r}: K1 within {TOL} and K2 at its bound of the "
                       f"plain version; K1 {c['k1']} and K2 {c['k2']} == 2 (two sharded calls)"))
        checks.append((c["exact_overflow"] == [0, 0] and rel <= 1e-4
                       and all(g["outside"] == 0 and g["finite"]
                               for g in c["exact_grads"].values()),
                       f"gauss_loss rank {r} at K = {K_EXACT}: no overflow, loss rel {rel:.2e} "
                       f"<= 1e-4, every gradient (verts included) at K2's bound"))
    # 3, 4. the trainers' curves
    for label, ranks, case, ref in (("sharded 1-D", pair, "sharded_1d", "exact_1"),
                                    ("frame-DP", pair, "frame_dp", "k256_2"),
                                    ("sharded 2x2", quad, "sharded_2d", "exact_2")):
        errs = [k_curve_err(r["cases"][case]["losses"], one[ref]["losses"]) for r in ranks]
        c0 = ranks[0]["cases"][case]
        print(f"  {label} ({ref}): {K_STEPS} steps, loss {c0['losses'][0]:.5f} -> "
              f"{c0['losses'][-1]:.5f} (one process {one[ref]['losses'][0]:.5f} -> "
              f"{one[ref]['losses'][-1]:.5f}), max rel diff per rank "
              f"{[f'{e:.2e}' for e in errs]}; ms/step "
              f"{max(r['cases'][case]['ms'] for r in ranks):.3f} vs one process "
              f"{one[ref]['ms']:.3f} [{card}]")
        checks.append((max(errs) <= bounds[ref],
                       f"{label} curve within {bounds[ref]:.2e} of one process"))
        print(f"    first step's moments on rank 0 against one process: " + ", ".join(
            f"{k} {g['max_abs_err']:.3e} of {g['scale']:.3e} ({g['outside']} of "
            f"{g['size']} outside, worst {g['excess']:.2f} x its bound)"
            for k, g in c0["first_moments"].items()))
        for r, rr in enumerate(ranks):
            fm = rr["cases"][case]["first_moments"]
            worst = max(fm, key=lambda k: fm[k]["outside"] / fm[k]["size"])
            share = fm[worst]["outside"] / fm[worst]["size"]
            checks.append((share <= K_MOMENT_OUTSIDE and all(g["finite"] for g in fm.values()),
                           f"{label} rank {r}: the first step's moments (every gaussian field "
                           f"and FLAME key) at K2's bound of one process but for <= "
                           f"{K_MOMENT_OUTSIDE:g} of a leaf; worst {worst}, {share:.2e} outside"))
    c0 = pair[0]["cases"]["sharded_1d_k256"]
    print(f"  sharded 1-D at K = {MAX_PER_TILE}: loss {c0['losses'][0]:.5f} -> "
          f"{c0['losses'][-1]:.5f}, {c0['ms']:.3f} ms/step [{card}]")
    checks.append((c0["losses"][-1] < c0["losses"][0],
                   f"the sharded trainer trains at K = {MAX_PER_TILE}"))
    checks.append((len({r["cases"]["frame_dp"]["state_hash"] for r in pair}) == 1,
                   "frame-DP replicas equal bit for bit"))
    # 5. the tracker
    for r, rr in enumerate(pair):
        c = rr["cases"]["tracker"]
        for stage in ("lmk_init_rigid", "lmk_init_all"):
            rel = abs(c["losses"][stage] - one_track["losses"][stage]) / one_track["losses"][stage]
            checks.append((rel <= 2e-3, f"tracker rank {r} {stage} loss rel {rel:.2e} <= 2e-3"))
        checks.append((c["k1"] > 0 and c["k2"] > 0,
                       f"tracker rank {r}: K1 {c['k1']} and K2 {c['k2']} in the rgb steps"))
    c0 = pair[0]["cases"]["tracker"]
    print(f"  tracker: landmark stages {c0['losses']} vs one process {one_track['losses']}; "
          f"seconds {c0['seconds']} vs one process {one_track['seconds']} [{card}]")
    checks.append((len({r["cases"]["tracker"]["params_hash"] for r in pair}) == 1,
                   "tracker replicas equal bit for bit"))

    # 6. the pipeline under torchrun, on phase I's stage cache, and the same
    # `run` in this process, both at K_E2E_CAPACITY gaussians
    from omfs4d_torch.pipeline import cli

    def run_args(wd: Path, extra: list) -> list:
        shutil.copytree(work / "e2e" / "wd" / "stages", wd / "stages")
        return ["run", "--video", str(clip), "--landmarks", "auto", "--iterations",
                str(K_E2E_ITERS), "--workdir", str(wd), "--output", str(wd / "pred.mp4"),
                *[f"track.{k}={v}" for k, v in TRACK_STEPS.items()],
                f"pipeline.min_train_frames={N_FRAMES}",
                f"train.max_gaussians={K_E2E_CAPACITY}", *extra]

    def selfrecon(wd: Path) -> float:
        scores = wd / "model" / "eval_strict" / "reports" / "strict_scores.json"
        return (float(np.mean([r["psnr"] for r in json.loads(scores.read_text())["rows"]]))
                if scores.exists() else float("nan"))

    wd = work / "k_wd"
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", str(K_PAIR), "-m", "omfs4d_torch.pipeline.cli",
                          *run_args(wd, ["parallel.n_gauss=2"])],
                         cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                         timeout=K_TIMEOUT_S)
    torchrun_s = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
    checks.append((res.returncode == 0, f"torchrun cli run exited {res.returncode}"))
    wd1 = work / "k_wd1"
    t0 = time.perf_counter()
    checks.append((cli.main(run_args(wd1, [])) == 0, "one-process cli run"))
    one_s = time.perf_counter() - t0
    psnr, psnr1 = selfrecon(wd), selfrecon(wd1)
    checks.append((abs(psnr - psnr1) <= K_E2E_PSNR_TOL,
                   f"selfrecon PSNR of the torchrun run {psnr:.3f} dB within "
                   f"{K_E2E_PSNR_TOL} dB of the one-process run's {psnr1:.3f} dB"))
    print(f"  torchrun --nproc-per-node {K_PAIR} -m omfs4d_torch.pipeline.cli run "
          f"parallel.n_gauss=2 --iterations {K_E2E_ITERS} train.max_gaussians="
          f"{K_E2E_CAPACITY} (preprocess and track from phase I's stage cache): "
          f"{torchrun_s:.2f} s, selfrecon PSNR {psnr:.3f} dB; the same run in one process "
          f"{one_s:.2f} s, {psnr1:.3f} dB [{card}]")
    failed = [what for ok, what in checks if not ok]
    for ok, what in checks:
        print(f"  {'ok' if ok else 'FAILED'}: {what}")
    check(not failed, "phase K:\n  " + "\n  ".join(failed))
    fwd = sum(c["k1"] for r in pair + quad for c in r["cases"].values())
    bwd = sum(c["k2"] for r in pair + quad for c in r["cases"].values())
    print(f"phase K ran in {time.perf_counter() - t_phase:.2f} s; K1 {fwd} and K2 {bwd} "
          f"launches over the ranks' cases [{card}]")
    return {"fwd": fwd, "bwd": bwd}


def phase_l(card: str) -> dict:
    """The port's bench as a user runs it: `python -m omfs4d_torch.scripts.bench
    --iters BENCH_ITERS` in a process of its own at full shapes; its last
    line held."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "omfs4d_torch.scripts.bench", "--iters",
                          str(BENCH_ITERS)], cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
                         env=dict(os.environ, OMFS4D_BENCH_BUDGET_SECS=str(BENCH_BUDGET_S)))
    seconds = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    check(bool(lines), f"the bench printed its line (exit {res.returncode}):\n"
          f"{res.stderr[-3000:]}")
    out = json.loads(lines[-1])
    check(res.returncode == 0 and "error" not in out,
          f"the bench exited 0 with no error: exit {res.returncode}, "
          f"{out.get('error')}\n{res.stderr[-3000:]}")
    ex = out["extra"]
    rates = {"value": out["value"], **{k: ex[k] for k in (
        "train_ips_per_step_dispatch", "render_fps", "flame_fit_iters_per_sec")}}
    check(ex["backend"] == "cuda" and all(isinstance(v, float) and np.isfinite(v) and v > 0
                                          for v in rates.values()),
          f"the bench ran on the card with finite positive rates: {ex['backend']}, {rates}")
    check(ex["kernels"]["composite_fwd"] > 0 and ex["kernels"]["composite_bwd"] > 0,
          f"K1 and K2 launched in the bench: {ex['kernels']}")
    check(ex["mfu_f32"] is not None and 0 < ex["mfu_f32"] < 1,
          f"0 < mfu_f32 {ex['mfu_f32']} < 1")
    for mark in res.stderr.splitlines():
        if mark.startswith("# bench:"):
            print(f"  {mark}")
    print(f"phase L: python -m omfs4d_torch.scripts.bench --iters {BENCH_ITERS} in "
          f"{seconds:.2f} s, exit {res.returncode}: train() {out['value']:.3f} it/s "
          f"(vs_baseline {out['vs_baseline']:.3f}), bare steps "
          f"{ex['train_ips_per_step_dispatch']:.3f} it/s, render {ex['render_fps']:.3f} fps, "
          f"FLAME-fit {ex['flame_fit_iters_per_sec']:.3f} it/s; flops/step "
          f"{ex['flops_per_step']:.4e}, bytes/step {ex['bytes_per_step']:.4e}, mfu "
          f"{ex['mfu']:.3e}, mfu_f32 {ex['mfu_f32']:.3e}, {ex['roofline_bound']}-bound; "
          f"K1 {ex['kernels']['composite_fwd']}, K2 {ex['kernels']['composite_bwd']} "
          f"launches [{card}]")
    print(f"  device per call (torch.profiler): {json.dumps(ex['device_per_call'])}")
    print(f"  the line: {lines[-1]}")
    return out


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
    from omfs4d_torch.train.checkpoints import (latest_iteration, load_point_cloud,
                                                snapshot_state, trained_render_meta)
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

    if only == "bench":
        phase_l(card)
        return 0
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    modified = None
    try:
        # ── phase A: the full-size case ─────────────────────
        t0 = time.perf_counter()
        case = make_synthetic_dataset(work / "data", n_frames=N_FRAMES, width=SIZE,
                                      height=SIZE, n_vertices=N_VERTICES, seed=0,
                                      device=device)
        model = case["model"]
        if only == "clinical":
            phase_j(model, device, card, work, case["path"])
            return 0
        if only == "parallel":
            write_bench_model(model, device, work / "model")
            modified = create_modified_dataset(str(case["path"]), compute_offset(LEFORT_MM, 1.0),
                                               compute_offset(BSSO_MM, 1.0))
            k_stage_cache(model, device, work)
            phase_k(model, device, card, work, Path(modified))
            return 0
        if only is not None:
            {"track": phase_g, "nets": phase_h, "e2e": phase_i}[only](model, device, card, work)
            return 0
        model_dir = work / "model"
        write_bench_model(model, device, model_dir)
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

        # ── phase J: the clinical engine at a head CBCT's size ─
        clinical = phase_j(model, device, card, work, case["path"], model_dir,
                           pngs[:BRIDGE_FRAMES])

        # ── phase K: the parallel package, ranks sharing the card ─
        parallel = phase_k(model, device, card, work, Path(modified))

        # ── phase L: the port's bench, in a process of its own ─
        phase_l(card)
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
                     + nets["pipe_fwd"] + e2e["fwd"] + clinical["fwd"] + parallel["fwd"]),
        "launches_by_path": {"render": launches, "train": train_fwd, "track": track["fit_fwd"],
                             "nets": nets["nets_fwd"], "pipeline": nets["pipe_fwd"],
                             "e2e": e2e["fwd"], "clinical": clinical["fwd"],
                             "parallel": parallel["fwd"]},
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
        "launches": (train_bwd + track["fit_bwd"] + nets["pipe_bwd"] + e2e["bwd"]
                     + clinical["bwd"] + parallel["bwd"]),
        "launches_by_path": {"render": 0, "train": train_bwd, "track": track["fit_bwd"],
                             "nets": 0, "pipeline": nets["pipe_bwd"], "e2e": e2e["bwd"],
                             "clinical": clinical["bwd"], "parallel": parallel["bwd"]},
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
        ap.add_argument("--only-clinical", action="store_true",
                        help="run the set-up and phase J (the clinical engine) alone")
        ap.add_argument("--only-parallel", action="store_true",
                        help="run the set-up and phase K (the parallel package) alone")
        ap.add_argument("--only-bench", action="store_true",
                        help="run the set-up and phase L (the port's bench) alone")
        ap.add_argument("--k-rank", nargs=5, help=argparse.SUPPRESS)
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
        if opts.k_rank:
            group, rank, world, port, kwork = opts.k_rank
            k_rank(group, int(rank), int(world), int(port), Path(kwork))
            sys.exit(0)
        if opts.net_gates:
            sys.exit(gate_readings(*([int(n) for n in arg.split(",") if n]
                                     for arg in opts.net_gates)))
        only = [name for name, on in (("track", opts.only_track), ("nets", opts.only_nets),
                                      ("e2e", opts.only_e2e), ("clinical", opts.only_clinical),
                                      ("parallel", opts.only_parallel),
                                      ("bench", opts.only_bench))
                if on]
        if len(only) > 1:
            ap.error("at most one --only-* option")
        if only:
            sys.exit(main(only=only[0]))
        sys.exit(compare_trees(opts.trees))
    sys.exit(main())
