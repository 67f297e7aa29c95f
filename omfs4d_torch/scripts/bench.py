"""Headline benchmark of the port: 3DGS avatar training and render throughput
and FLAME-fit speed on one CUDA card.  The counterpart of `bench.py`.

    python -m omfs4d_torch.scripts.bench [--quick] [--size N] [--iters N]

Prints ONE JSON line, `bench.py`'s schema:

    {"metric": "3dgs_train_iters_per_sec@512", "value": N, "unit": "iter/s",
     "vs_baseline": N, "extra": {...}}

`value` is `AvatarTrainer.train` it/s: the trainer's production loop, run
from the bench state in its steady state (past its first
`WINDOW_CHECK_UNTIL` iterations: steps in chunks of `CHUNK` between metric
reads), as `bench.py`'s chunked headline runs the trainer's scan chunks.
`vs_baseline` divides it by the reference app's 16.7 it/s (30k iterations in
~30 min on an RTX 4070 Ti, `app.py:1347`).  In `extra`:

- `train_ips_per_step_dispatch`: bare `train_step` calls;
- `render_fps`: `render_frame` calls;
- `flame_fit_iters_per_sec`: T = 150 frames, `TrackConfig(n_shape=100,
  n_expr=50, photometric=False)`, landmark loss + regularizers, every key
  its own Adam group (the tracker's own stage step);
- `device_per_call`: torch.profiler's kernels and device-busy ms per step,
  iteration, frame or fit step, from short windows after all the timed
  loops (a profiling session slows the host's launches that follow it in
  the process, so none runs before a timed loop);
- `flops_per_step`, `bytes_per_step`: one untimed training step under a
  `TorchDispatchMode` counter (`DispatchCounter`), plus K1's and K2's flops
  and bytes counted analytically (they launch through ctypes, where the
  counter cannot see them; an FMA is 2 flops there as in the counter's
  formulas).  The count is the work of the aten ops the port dispatches, one
  by one, unfused: not XLA's post-fusion count of `bench.py`, and larger in
  bytes than any fused program moves.  Ops that only copy, index or create
  data (`DATA_MOVEMENT`) count their bytes and no flops;
- `mfu` (share of 989 TFLOP/s, bf16 dense, `bench.py`'s denominator) and
  `mfu_f32` (share of 67 TFLOP/s: the step runs in f32 with TF32 off), both
  at the bare-step rate as `bench.py` takes them; `roofline_bound`, "compute"
  or "memory", whichever of flops / 67e12 and bytes / 3.35e12 is larger;
- `kernels`: K1 (`composite_fwd`) and K2 (`composite_bwd`) launches of the
  run; `device` and `power_limit_w` (nvidia-smi); `floors` (below).

The shapes are `bench.py`'s: 512^2, capacity 131,072 with 65,536 alive
gaussians (the 5143-vertex synthetic FLAME asset's textured avatar
replicated with seeded jitter), compacted to alive x 1.125 at the refit
boundary, K = 256, T = 4 frames from `flame_forward`; `--quick`: 128^2, the
700-vertex asset, 4,096 / 2,048, K = 128, 5 iterations.

There is no fallback: with no card, or a kernel that does not build or
launch, the line carries `value: null` and `error`, and the exit code is 1;
a phase that fails leaves its metric null, names itself in `error`, and the
exit code is 1.  A watchdog (`OMFS4D_BENCH_BUDGET_SECS`, default 1000 s)
bounds every phase, and a crash still prints one valid line.  `--cpu` is for
the tests: the quick shapes on the CPU, every rate and share null, the steps
run and the final losses printed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import signal
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

BASELINE_TRAIN_ITERS_PER_SEC = 30_000 / (30 * 60)   # ~16.7 (app.py:1347)

# One NVIDIA H100 SXM (data sheet, dense, at its 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# The bound of a composite kernel: the larger of its FP32 instructions over
# the card's issue rate (67 TFLOP/s with an FMA counted as 2: 33.5 T
# instructions a second) and its bytes over the memory rate.  Only the work
# the function needs is counted, on this run's data (`pair_counts`): the
# alpha of composite_common.cuh, ~16 instructions, at each (pixel, entry)
# pair whose pixel lies in the entry's reach box (elsewhere a = 0 without
# evaluating it); the running step, ~6, only at live pairs (a > 0: at a = 0
# it is the identity); and at live pairs K2's chain ~35 and its share of the
# sums ~9.  Bytes: each input read once, each output written once.
FP32_INSTR_PER_S = PEAK_F32_FLOPS / 2
ALPHA_OPS, STEP_OPS, CHAIN_OPS, SUM_OPS = 16, 6, 35, 9
# The same work in flops, for `flops_per_step` (an FMA is 2, compares and
# selects none): alpha 13 (two differences, the quadratic form's 9, the
# exponential, the product with o), the step 9, K2's chain 40 and its sums 9
# (one add per row and pixel).
ALPHA_FLOPS, STEP_FLOPS, CHAIN_FLOPS, SUM_FLOPS = 13, 9, 40, 9

FULL = dict(size=512, iters=50, n_vertices=5143, capacity=131_072, alive=65_536,
            max_per_tile=256, fit_frames=150, chunk=50)
QUICK = dict(size=128, iters=5, n_vertices=700, capacity=4096, alive=2048,
             max_per_tile=128, fit_frames=16, chunk=10)
N_FRAMES = 4
FIT_SHAPE, FIT_EXPR, FIT_CHUNK = 100, 50, 25
PROFILE_STEPS = 5
# Regression floors of the full-size run on the card: 0.6 x the lowest
# reading of each metric over three full-size runs in one process (train()
# 26.1 it/s, render 101.3 fps, FLAME-fit 44.4 it/s; NVIDIA H100 80GB HBM3,
# 700.00 W), since the same code has read up to 1.9x apart between machines
FLOORS = {"train_ips": 15.0, "render_fps": 60.0, "flame_fit": 26.0}
BUDGET_SECS = 1000.0


def _mark(msg: str) -> None:
    print(f"# bench: {msg}", file=sys.stderr, flush=True)


# ── global deadline ──────────────────────────────────────────
# Every phase re-arms SIGALRM with min(phase cap, time to the deadline); a
# phase that trips it raises TimeoutError into its own handler, records its
# metric as null, and the next phase gets a fresh alarm.  Closer than 45 s to
# the deadline, the remaining phases are skipped so that the line prints.
_DEADLINE = [float("inf")]


def _arm(phase_cap: float = 420.0) -> bool:
    """(Re-)arm the watchdog for one phase; False when out of budget."""
    left = _DEADLINE[0] - time.monotonic()
    if left < 45.0:
        return False
    try:
        signal.alarm(max(int(min(phase_cap, left - 30.0)), 1))
    except (ValueError, OSError):
        pass
    return True


def _watchdog(sig, frame):  # noqa: ARG001
    raise TimeoutError("bench watchdog expired")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit_w() -> float | None:
    """The card's power limit in W, as nvidia-smi reads it (None when it
    cannot be read)."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits",
                              f"--id={torch.cuda.current_device()}"],
                             capture_output=True, text=True, timeout=60)
        return float(res.stdout.strip().splitlines()[0])
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        return None


# ── the bench's avatar and data ──────────────────────────────


def bench_avatar(model, device, capacity: int = FULL["alive"], alive: int = FULL["alive"]):
    """The bench-scale avatar (bench.py's recipe): the per-face textured GT
    avatar replicated to `alive` gaussians with seeded jitter, padded with
    dead slots to `capacity`."""
    from omfs4d_torch.convert import gaussians_from_numpy, to_numpy
    from omfs4d_torch.io.synthetic import textured_gt_avatar

    g0 = to_numpy(textured_gt_avatar(model))
    F = int(g0["alive"].sum())
    reps = int(np.ceil(alive / F))
    idx = np.tile(np.arange(F), reps)[:alive]
    rng = np.random.default_rng(0)
    fields = {
        "parent_face": g0["parent_face"][idx],
        "mu_local": g0["mu_local"][idx]
        + rng.normal(0, 0.3, (alive, 3)).astype(np.float32),
        "quat_local": g0["quat_local"][idx],
        "log_scale": g0["log_scale"][idx] - np.log(reps ** 0.5),
        "opacity_logit": g0["opacity_logit"][idx] - 1.5,
        "color": g0["color"][idx],
        "sh": g0["sh"][idx],
        "alive": np.ones(alive, bool),
    }
    pad = capacity - alive
    fields = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
              for k, v in fields.items()}
    fields["quat_local"][alive:, 0] = 1.0
    return gaussians_from_numpy(fields, device=device)


def bench_camera(size: int, device):
    from omfs4d_torch.ops.camera import look_at_camera

    return look_at_camera(eye=(0, 0, 0.55), target=(0, 0, 0), fx=1.7 * size,
                          width=size, height=size, device=device)


def bench_data(model, cam, size: int, device, n_frames: int = N_FRAMES) -> dict:
    """bench.py's training data: T frames of seeded noise as the GT, FLAME
    vertices of a neutral shape with a seeded jaw pose, one camera."""
    from omfs4d_torch.models.flame import flame_forward

    rng = np.random.default_rng(1)
    params = {"shape": torch.zeros(300, device=device),
              "expr": torch.zeros((n_frames, 100), device=device),
              "jaw_pose": torch.as_tensor(rng.normal(0, 0.05, (n_frames, 3)),
                                          dtype=torch.float32, device=device)}
    with torch.no_grad():
        verts = flame_forward(model, params)
    images = rng.integers(0, 255, (n_frames, size, size, 3)).astype(np.uint8)
    return {
        "images": torch.from_numpy(images).to(device),
        "verts": verts,
        "w2c": cam.w2c.to(device, torch.float32)[None].repeat(n_frames, 1, 1),
        **{k: torch.full((n_frames,), float(getattr(cam, k)), device=device)
           for k in ("fx", "fy", "cx", "cy")},
    }


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


# ── K1's and K2's work, counted on the run's data ────────────


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


def composite_work(args, packed, residual: bool = True) -> dict:
    """K1's and K2's work on one frame's inputs: (FP32 instructions, bytes)
    each and their flops (`"flops"`), from its pairs in reach and its live
    pairs (`pair_counts`), its lists and its pixels.  `residual`: K1 also writes T_tot (as under
    autograd; not under no_grad)."""
    uv, _, _, _, binning, width, height = args
    entries = int(binning.tile_counts.sum())
    reached, live = pair_counts(packed, width, height, (width + 15) // 16)
    list_bytes = entries * (9 + 1) * 4 + binning.tile_lists.shape[0] * 4
    pixels = width * height
    return {"composite_fwd": (reached * ALPHA_OPS + live * STEP_OPS,
                              list_bytes + pixels * (3 + 1 + int(residual)) * 4),
            "composite_bwd": (reached * ALPHA_OPS + live * (STEP_OPS + CHAIN_OPS + SUM_OPS),
                              list_bytes + pixels * (3 + 1 + 3 + 1) * 4 + uv.shape[0] * 9 * 4),
            "flops": {"composite_fwd": reached * ALPHA_FLOPS + live * STEP_FLOPS,
                      "composite_bwd": reached * ALPHA_FLOPS
                      + live * (STEP_FLOPS + CHAIN_FLOPS + SUM_FLOPS)},
            "in_lists": entries * 256, "reached": reached, "live": live}


def composite_bounds(args, packed, residual: bool = True) -> dict:
    """K1's and K2's bounds (us, what sets it) on one frame's inputs
    (`composite_work`)."""
    work = composite_work(args, packed, residual)
    for name in ("composite_fwd", "composite_bwd"):
        work[name] = bound_us(*work[name])
    return work


# ── the aten ops' work, counted as they are dispatched ───────


# Op families that copy, index or create data and do no arithmetic: their
# bytes count, their flops are 0 (a scatter with a reduction counts flops)
DATA_MOVEMENT = frozenset({
    "copy", "_to_copy", "clone", "_unsafe_view", "repeat", "flip", "roll", "cat", "stack",
    "constant_pad_nd", "slice_backward", "select_backward", "slice_scatter",
    "select_scatter", "as_strided_scatter", "index", "index_select", "gather", "scatter",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "empty", "empty_like",
    "empty_strided", "new_empty", "new_zeros", "new_ones", "new_full", "fill", "zero",
    "arange", "scalar_tensor", "lift_fresh"})


def _op_family(packet) -> str:
    return packet.__name__.split(".")[-1].rstrip("_")


class DispatchCounter(TorchDispatchMode):
    """Counts the work of every aten op dispatched while it is active:
    flops by `torch.utils.flop_counter`'s formula where the op has one (mm,
    bmm, addmm, convolution and their backwards), none for the families of
    `DATA_MOVEMENT`, else one per output element; bytes of every tensor
    input and output.  An op whose output is a view of an input moves and
    computes nothing, and counts nothing.  Ops that run inside an autograd
    backward are also summed apart (`backward_flops`)."""

    def __init__(self):
        super().__init__()
        self.flops: dict[str, float] = defaultdict(float)
        self.bytes: dict[str, float] = defaultdict(float)
        self.backward_flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns):
            return out
        packet = func._overloadpacket
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        family = _op_family(packet)
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        elif family in DATA_MOVEMENT and "reduce" not in func._overloadname:
            flops = 0.0
        else:
            flops = float(sum(t.numel() for t in outs))
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        self.flops[family] += flops
        self.bytes[family] += float(sum(t.numel() * t.element_size() for t in ins + outs))
        if torch._C._current_graph_task_id() != -1:
            self.backward_flops += flops
        return out

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())


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


def flame_fit(model, camera, size: int, frames: int, steps: int, warmup: int,
              device, profile_steps: int = 20) -> dict:
    """FLAME-fit it/s as the reference's bench defines it (bench.py:316-367):
    `frames` frames, TrackConfig(n_shape=100, n_expr=50, photometric=False),
    landmark loss + regularizers, every key its own Adam group, through the
    tracker's own stage step; `steps` steps after `warmup`, host clock
    synchronized at both ends.  On the card also the ms per step between CUDA
    events and torch.profiler's kernels and busy ms per step."""
    from omfs4d_torch.core.config import TrackConfig
    from omfs4d_torch.track.fitter import FlameTracker
    from omfs4d_torch.train.trainer import adam_init

    tracker = FlameTracker(model, TrackConfig(n_shape=FIT_SHAPE, n_expr=FIT_EXPR,
                                              photometric=False),
                           camera, (size, size), device=device)
    p = tracker.init_params(frames)
    data = {"landmarks": torch.full((frames, model.lmk_faces_idx.shape[0], 2), size / 2.0,
                                    device=device),
            "valid": torch.ones(frames, dtype=torch.bool, device=device), "frames": None}
    opt = {k: adam_init({k: v}) for k, v in p.items()}

    def step():
        return tracker._stage_step(p, opt, data, [0], 1.0, 0.0)

    for _ in range(warmup):
        step()
    cuda = device.type == "cuda"
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _sync(device)
    t0 = time.perf_counter()
    if cuda:
        start.record()
    for _ in range(steps):
        loss = step()
    if cuda:
        end.record()
    _sync(device)
    host_s = time.perf_counter() - t0
    out = {"it_s": steps / host_s, "ms_per_step": host_s / steps * 1e3,
           "loss": float(loss), "groups": len(opt), "steps": steps + warmup,
           "event_ms_per_step": start.elapsed_time(end) / steps if cuda else None,
           "kernels": None, "busy_ms": None}
    if cuda:
        out["kernels"], out["busy_ms"] = profiled_kernels(step, profile_steps)
    return out


# ── the run ──────────────────────────────────────────────────


def _num(x):
    """nan / inf / None -> None, so that the line is strict JSON."""
    return float(x) if x is not None and math.isfinite(float(x)) else None


class Recorder:
    """Keeps the trainer's per-step `train_step` events."""

    def __init__(self):
        self.steps = []

    def emit(self, event, **fields):
        if event == "train_step":
            self.steps.append(fields)


def run(args) -> dict:
    """Every phase of the bench; the result line (with `error` when a
    phase failed)."""
    from omfs4d_torch.core.config import TrainConfig
    from omfs4d_torch.core.device import resolve_device
    from omfs4d_torch.models.assets import synthetic_flame_asset
    from omfs4d_torch.models.flame import FlameModel
    from omfs4d_torch.render.composite import composite, pack_lists
    from omfs4d_torch.train.trainer import AvatarTrainer

    device = resolve_device("cpu" if args.cpu else None, "bench")
    cuda = device.type == "cuda"
    shapes = QUICK if (args.quick or args.cpu) else FULL
    size = args.size or shapes["size"]
    n_timed = args.iters or shapes["iters"]
    alive, capacity, K = shapes["alive"], shapes["capacity"], shapes["max_per_tile"]
    metric = f"3dgs_train_iters_per_sec@{size}"
    errors: list[str] = []
    extra: dict = {"n_gaussians": alive, "resolution": size, "iters": n_timed,
                   "backend": device.type,
                   "device": torch.cuda.get_device_name(device) if cuda else None,
                   "power_limit_w": power_limit_w() if cuda else None}

    def failed(phase: str, e: BaseException) -> None:
        errors.append(f"{phase}: {type(e).__name__}: {e}")
        _mark(f"{phase} failed: {type(e).__name__}: {e}")

    def line(value=None) -> dict:
        out = {"metric": metric, "value": _num(value), "unit": "iter/s",
               "vs_baseline": _num(value / BASELINE_TRAIN_ITERS_PER_SEC)
               if value is not None else None, "extra": extra}
        if errors:
            out["error"] = "; ".join(errors)
        return out

    # ── set-up: the kernels, the avatar, the data, the trainer ──
    _mark(f"device={device} shapes={'quick' if shapes is QUICK else 'full'} size={size}")
    if cuda:
        try:
            if not _arm(600.0):
                raise TimeoutError("bench budget exhausted before the kernels' build")
            from omfs4d_torch import _build

            t0 = time.perf_counter()
            _build.load_library()
            extra["build_s"] = time.perf_counter() - t0
        except Exception as e:                  # noqa: BLE001 — reported in the line
            failed("build", e)
            return line()
    composite.launches = 0
    composite.backward_launches = 0
    try:
        if not _arm():
            raise TimeoutError("bench budget exhausted before set-up")
        t0 = time.perf_counter()
        model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=shapes["n_vertices"]),
                                      device=device)
        cam = bench_camera(size, device)
        data = bench_data(model, cam, size, device)
        cfg = TrainConfig(batch_frames=1, max_gaussians=capacity)
        trainer = AvatarTrainer(model.faces.cpu().numpy(), cfg, size, size, max_per_tile=K,
                                device=device)
        state = trainer.init_state(capacity=capacity)
        # the bench avatar in place of the init cloud (same capacity: the zero
        # Adam moments and accumulators of init_state fit it as they are)
        state = state._replace(gaussians=bench_avatar(model, device, capacity, alive))
        # the refinement phase's steady state: compact_to_alive fires at the
        # post-densification refit and drops the dead capacity padding
        if cfg.compact_at_refit:
            state = trainer.compact_to_alive(state)
        extra["capacity"] = int(state.gaussians.capacity)
        _mark(f"set-up: capacity {capacity} -> {extra['capacity']} ({alive} alive), "
              f"{time.perf_counter() - t0:.2f} s")
    except Exception as e:                      # noqa: BLE001
        failed("setup", e)
        return line()

    steps_run: dict[str, int] = {}
    losses: dict[str, float] = {}
    device_per_call: dict[str, dict] = {}
    # train() runs past its warm-up window checks, in chunks of `chunk` steps
    chunk, start = shapes["chunk"], trainer.WINDOW_CHECK_UNTIL

    # ── bare training steps ──
    train_ips = None
    try:
        if not _arm():
            raise TimeoutError("bench budget exhausted before the step phase")
        state, m = trainer.train_step(state, data, [0])          # warm-up
        _sync(device)
        t0 = time.perf_counter()
        for i in range(n_timed):
            state, m = trainer.train_step(state, data, [i % N_FRAMES])
        _sync(device)
        train_ips = n_timed / (time.perf_counter() - t0)
        steps_run["train_step"] = n_timed + 1
        losses["train_step"] = float(m["loss"])
    except Exception as e:                      # noqa: BLE001
        failed("train_step", e)

    # ── the production loop: AvatarTrainer.train in its steady state ──
    headline = None
    try:
        if not _arm():
            raise TimeoutError("bench budget exhausted before the train phase")
        n_train = chunk if shapes is QUICK else chunk * max(n_timed // chunk, 4)
        rec = Recorder()
        _sync(device)
        t0 = time.perf_counter()
        state = trainer.train(data, iterations=start + n_train, state=state,
                              start_iteration=start, events=rec, log_every=chunk)
        _sync(device)
        headline = n_train / (time.perf_counter() - t0)
        steps_run["train"] = n_train
        losses["train"] = rec.steps[-1]["loss"]
    except Exception as e:                      # noqa: BLE001
        failed("train", e)

    # ── render-only fps ──
    render_fps = None
    try:
        if not _arm():
            raise TimeoutError("bench budget exhausted before the render phase")
        img = trainer.render_frame(state, data["verts"][0], cam)
        _sync(device)
        t0 = time.perf_counter()
        for i in range(n_timed):
            img = trainer.render_frame(state, data["verts"][i % N_FRAMES], cam)
        _sync(device)
        render_fps = n_timed / (time.perf_counter() - t0)
        steps_run["render_frame"] = n_timed + 1
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError("a rendered frame is not finite")
    except Exception as e:                      # noqa: BLE001
        failed("render", e)

    # ── FLAME-fit iters/sec (the last timed loop: its profile window follows it) ──
    flame_ips = None
    try:
        if not _arm():
            raise TimeoutError("bench budget exhausted before the flame-fit phase")
        n_fit = max((n_timed * 2) // FIT_CHUNK, 2) * FIT_CHUNK
        fit = flame_fit(model, cam, size, shapes["fit_frames"], n_fit, FIT_CHUNK, device,
                        profile_steps=20)
        flame_ips = fit["it_s"]
        steps_run["flame_fit"] = fit["steps"]
        losses["flame_fit"] = fit["loss"]
        if cuda:
            device_per_call["flame_fit_step"] = {"kernels": fit["kernels"],
                                                 "busy_ms": fit["busy_ms"],
                                                 "event_ms": fit["event_ms_per_step"]}
        if not math.isfinite(fit["loss"]):
            raise RuntimeError("the FLAME-fit loss is not finite")
    except Exception as e:                      # noqa: BLE001
        failed("flame_fit", e)

    # ── device work per call: short torch.profiler windows, after every
    # timed loop (a profiling session slows the host's launches after it) ──
    if cuda:
        try:
            if not _arm():
                raise TimeoutError("bench budget exhausted before the profile windows")

            def train_fn():
                nonlocal state
                state = trainer.train(data, iterations=start + PROFILE_STEPS, state=state,
                                      start_iteration=start, events=Recorder(),
                                      log_every=PROFILE_STEPS)

            windows = {"train_step": (lambda: trainer.train_step(state, data, [0]), 1),
                       "train": (train_fn, PROFILE_STEPS),
                       "render_frame": (lambda: trainer.render_frame(state, data["verts"][0],
                                                                     cam), 1)}
            for name, (fn, per_call) in windows.items():
                calls = PROFILE_STEPS if per_call == 1 else 1
                kernels, busy_ms = profiled_kernels(fn, calls)
                device_per_call[name] = {"kernels": kernels / per_call,
                                         "busy_ms": busy_ms / per_call}
        except Exception as e:                  # noqa: BLE001
            failed("profile", e)

    # ── the step's work: dispatched aten ops + K1 / K2 analytically ──
    flops = nbytes = None
    try:
        if not _arm(120.0):
            raise TimeoutError("bench budget exhausted before the cost count")
        counter = DispatchCounter()
        before = composite.launches, composite.backward_launches
        with counter:
            state, _ = trainer.train_step(state, data, [0])
        _sync(device)
        launched = (composite.launches - before[0], composite.backward_launches - before[1])
        flops, nbytes = counter.total_flops, counter.total_bytes
        if not 0 < counter.backward_flops < flops:
            raise RuntimeError(f"the dispatch counter saw {counter.backward_flops:.3e} of "
                               f"{flops:.3e} flops in the backward: it must see both passes")
        if launched != (0, 0):
            args_ = grad_inputs(trainer, state, data, 0)
            b = args_[4]
            work = composite_work(args_, pack_lists(*args_[:4], b.tile_lists, b.tile_counts))
            for name, n in zip(("composite_fwd", "composite_bwd"), launched):
                flops += n * work["flops"][name]
                nbytes += n * work[name][1]
            extra["composite_pairs"] = {k: work[k] for k in ("in_lists", "reached", "live")}
        top = sorted(counter.flops.items(), key=lambda kv: -kv[1])
        _mark("flops by op family (dispatch counter, one step): "
              + json.dumps({k: v for k, v in top[:16]}
                           | {"other": sum(v for _, v in top[16:])}))
        _mark(f"flops/step={flops:.4e} (backward {counter.backward_flops:.4e}, K1/K2 launched "
              f"{launched}) bytes/step={nbytes:.4e}")
    except Exception as e:                      # noqa: BLE001
        failed("cost", e)
        flops = nbytes = None

    mfu = mfu_f32 = roofline = None
    if cuda and flops is not None and train_ips is not None:
        mfu = flops * train_ips / PEAK_BF16_FLOPS
        mfu_f32 = flops * train_ips / PEAK_F32_FLOPS
        t_compute, t_memory = flops / PEAK_F32_FLOPS, nbytes / HBM_BYTES_PER_S
        roofline = "memory" if t_memory > t_compute else "compute"
        extra["roofline_ms_per_step"] = max(t_compute, t_memory) * 1e3

    floors = None
    if cuda and shapes is FULL:
        floors = dict(FLOORS)
        checks = {
            "train_ips_ok": headline is not None and headline >= FLOORS["train_ips"],
            "render_fps_ok": render_fps is not None and render_fps >= FLOORS["render_fps"],
            "flame_fit_ok": flame_ips is not None and flame_ips >= FLOORS["flame_fit"],
        }
        floors.update(checks)
        if not all(checks.values()):
            _mark(f"!! REGRESSION FLOOR VIOLATED: {checks}")

    rates = {"train_ips_per_step_dispatch": train_ips, "render_fps": render_fps,
             "flame_fit_iters_per_sec": flame_ips}
    extra.update({k: _num(v) if cuda else None for k, v in rates.items()})
    extra.update({
        "kernels": {"composite_fwd": composite.launches,
                    "composite_bwd": composite.backward_launches},
        "device_per_call": device_per_call or None,
        "mfu": _num(mfu), "mfu_f32": _num(mfu_f32), "floors": floors,
        "flops_per_step": _num(flops), "bytes_per_step": _num(nbytes),
        "roofline_bound": roofline,
    })
    if not cuda:
        extra.update({"steps": steps_run, "final_loss": losses})
    return line(headline if cuda else None)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="small shapes (CI)")
    ap.add_argument("--size", type=int, default=0)
    ap.add_argument("--iters", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="the quick shapes on the CPU, for the tests: no rate is reported")
    args = ap.parse_args(argv)
    # the port's loggers write to stdout: the bench keeps it for its one line
    for name, logger in logging.root.manager.loggerDict.items():
        if name.startswith("omfs4d_torch") and isinstance(logger, logging.Logger):
            for h in logger.handlers:
                if isinstance(h, logging.StreamHandler) and h.stream is sys.stdout:
                    h.setStream(sys.stderr)
    with contextlib.redirect_stdout(sys.stderr):
        result = run(args)
    print(json.dumps(result), flush=True)
    return 1 if "error" in result else 0


if __name__ == "__main__":
    _DEADLINE[0] = time.monotonic() + float(
        os.environ.get("OMFS4D_BENCH_BUDGET_SECS", BUDGET_SECS))
    try:
        signal.signal(signal.SIGALRM, _watchdog)
    except (ValueError, OSError):
        pass
    try:
        code = main()
    except SystemExit:
        raise
    except BaseException as e:                  # noqa: BLE001 — ALWAYS emit the line
        import traceback

        traceback.print_exc(file=sys.stderr)
        print(json.dumps({"metric": "3dgs_train_iters_per_sec@512", "value": None,
                          "unit": "iter/s", "vs_baseline": None,
                          "error": f"{type(e).__name__}: {e}"}), flush=True)
        if not isinstance(e, Exception):
            raise
        code = 1
    finally:
        try:
            signal.alarm(0)
        except (ValueError, OSError):
            pass
    sys.exit(code)
