"""Staged FLAME tracker, in PyTorch.

Port of `omfs4d.track.fitter`, with the reference's stage schedule:

    lmk_init_rigid   -> global rotation + translation from landmarks
    lmk_init_all     -> all FLAME params from landmarks
    rgb_init_texture -> texture photometrically (params frozen)
    rgb_init_all     -> params + texture jointly, photometric + landmark
    rgb_init_offset  -> static per-vertex offsets + texture
    rgb_sequential / global -> per-frame warm-start sweep, then joint
                        refinement epochs over all frames

All frames of a batched stage are optimized in one tensor program.  The
photometric term has two interchangeable differentiable backends
(cfg.photometric_backend): "splat" renders the FLAME mesh with the same
gaussian rasterizer used for avatar training (one splat per face whose frame
and scale follow the triangle), so on a CUDA device it runs the hand-written
composite kernels, forward and backward, once per rendered frame; "mesh" uses
the soft halfplane triangle rasterizer (`omfs4d_torch.render.mesh_raster`).

Adam runs per parameter group at the reference's rates (shape 0.1x, rotation
0.3x, translation 0.5x, ...) on `adam_init` / `adam_update` of the trainer.
A stage trains a subset of the keys: the others get no update, which is what
the reference's zeroed gradients give (zero gradients keep Adam's moments at
zero, and the state is made anew for every stage).  The reference's scan
chunks are a plain loop here; a step reads nothing back to the host, and the
loss is read once, at the end of a stage.  The frame indices of a step come
from the same host stream as the reference's (`np.random.default_rng(0)` per
stage), so a stage's curve can be held against it.

`mesh=` shards the frame axis of the batched stages over the ranks of its
`data_axis` (SPMD, `omfs4d_torch.parallel`): the parameters and Adam stay
replicated (they are small), and each rank computes the terms of the frames
it owns — the landmark loss of its block of frames, the per-frame and
temporal regularizers of its rows (the previous rank's last row comes by a
halo exchange), the rgb batch entries whose frame it owns (every rank draws
the same indices) — while the first rank adds the global priors.  The
gradients are all-reduced, so every rank takes the unsharded step.  The
sequential sweep runs per frame on every rank, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from omfs4d_torch.core.config import TrackConfig
from omfs4d_torch.core.device import model_on, resolve_device
from omfs4d_torch.core.logging import EventLogger, get_logger
from omfs4d_torch.models.flame import FlameModel, flame_forward, flame_landmarks
from omfs4d_torch.models.gaussians import bind_to_mesh, inverse_sigmoid
from omfs4d_torch.ops.camera import Camera, project_points
from omfs4d_torch.render.rasterize import rasterize
from omfs4d_torch.train.losses import l1_loss
from omfs4d_torch.train.trainer import adam_init, adam_update

log = get_logger("track")

STAGES = (
    "lmk_init_rigid",
    "lmk_init_all",
    "rgb_init_texture",
    "rgb_init_all",
    "rgb_init_offset",
    "rgb_sequential_tracking",
    "global_optimization",
)

#: per-frame parameter keys (leading T axis); everything else is global
FRAME_KEYS = ("expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose",
              "translation", "dynamic_offset")

#: Adam rate of each parameter group, as a multiple of cfg.lr
GROUP_LR_SCALE = {
    "shape": 0.1, "expr": 1.0, "rotation": 0.3, "neck_pose": 0.3,
    "jaw_pose": 1.0, "eyes_pose": 1.0, "translation": 0.5, "texture": 10.0,
    "static_offset": 0.1, "focal_log_scale": 0.5, "dynamic_offset": 0.1,
}


class TrackerResult(NamedTuple):
    params: dict          # dataset-contract FLAME params (numpy)
    texture: np.ndarray   # linear color: (R, R, 3) UV atlas in
    #   cfg.texture_mode="uv", (F, 3) per-face / (V, 3) per-vertex in "flat"
    losses: dict
    focal_scale: float = 1.0   # refined-focal multiplier on the init guess


class FaceSplats(NamedTuple):
    """The fields `bind_to_mesh` reads, as plain tensors: unlike a
    `GaussianAvatar`, which owns detached copies, the record keeps `color`
    in the graph of the texture being optimized."""

    parent_face: torch.Tensor
    mu_local: torch.Tensor
    quat_local: torch.Tensor
    log_scale: torch.Tensor
    opacity_logit: torch.Tensor
    color: torch.Tensor
    sh: torch.Tensor
    alive: torch.Tensor


def _texture_avatar(model: FlameModel, texture_logits: torch.Tensor,
                    opacity: float = 0.98, scale: float = 0.7) -> FaceSplats:
    """One splat per FLAME face, color given by the texture being optimized.
    Every constant field is made on the device (no host copy)."""
    n = model.faces.shape[0]
    dev = texture_logits.device
    quat = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    quat[:, 0] = 1.0
    log_scale = torch.full((n, 3), math.log(scale), dtype=torch.float32, device=dev)
    log_scale[:, 2] = math.log(scale * 0.2)        # flat along the face normal
    return FaceSplats(
        parent_face=torch.arange(n, dtype=torch.int32, device=dev),
        mu_local=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        quat_local=quat,
        log_scale=log_scale,
        opacity_logit=torch.full((n,), inverse_sigmoid(opacity), dtype=torch.float32,
                                 device=dev),
        color=texture_logits,
        sh=torch.zeros((n, 3, 3), dtype=torch.float32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
    )


class FlameTracker:
    def __init__(
        self,
        model: FlameModel,
        cfg: TrackConfig,
        camera: Camera,
        image_size: tuple[int, int],          # (W, H)
        tile: int = 16,
        max_per_tile: int = 256,
        mesh=None,
        device: str | torch.device | None = None,
        data_axis: str = "data",
    ):
        """`device` defaults to the CUDA card: with no card the tracker
        raises, and it runs on the CPU only when the caller asks for it.  A
        model or camera on another device is copied to the tracker's.  The
        splat backend's composite takes the CUDA kernels on a CUDA device and
        the plain version on the CPU."""
        self.mesh, self.data_axis = mesh, data_axis
        self.device = resolve_device(device, "FlameTracker")
        self.model = model_on(model, self.device)
        self.cfg = cfg
        self.camera = dataclasses.replace(
            camera, **{k: getattr(camera, k).to(self.device, torch.float32)
                       for k in ("w2c", "fx", "fy", "cx", "cy")})
        self.width, self.height = image_size
        self.tile = tile
        self.max_per_tile = max_per_tile
        # photometric stages may run at reduced resolution; landmark terms
        # are resolution-free so only the RGB render/compare shrinks
        d = max(int(cfg.rgb_downsample), 1)
        self.rgb_downsample = d
        self.p_width, self.p_height = self.width // d, self.height // d
        cam = self.camera
        self.p_camera = cam if d == 1 else Camera(
            w2c=cam.w2c, fx=cam.fx / d, fy=cam.fy / d, cx=cam.cx / d, cy=cam.cy / d,
            width=self.p_width, height=self.p_height)
        self._bg = torch.ones(3, dtype=torch.float32, device=self.device)
        #: Adam rate of each parameter group (the reference's `_make_opt`)
        self.group_lr = {k: cfg.lr * scale for k, scale in GROUP_LR_SCALE.items()}
        #: a `StageClock`; when set, every stage step laps flame, landmark,
        #: photometric (on the splat backend: bind, project, bin, composite,
        #: l1), backward and optimizer
        self.clock = None

    def _texture_shape(self) -> tuple:
        if self.cfg.texture_mode == "uv":
            r = int(self.cfg.texture_res)
            return (r, r, 3)
        return (self.model.n_vertices
                if self.cfg.photometric_backend == "mesh"
                else self.model.faces.shape[0], 3)

    # ── parameter dict ───────────────────────────────────────
    def init_params(self, T: int) -> dict:
        V = self.model.n_vertices

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        return {
            "shape": zeros(self.cfg.n_shape),
            "expr": zeros(T, self.cfg.n_expr),
            "rotation": zeros(T, 3),
            "neck_pose": zeros(T, 3),
            "jaw_pose": zeros(T, 3),
            "eyes_pose": zeros(T, 6),
            # the provided camera is expected to view the origin, where the
            # canonical head sits (monocular convention: static camera, head
            # pose lives in rotation/translation)
            "translation": zeros(T, 3),
            # uv mode: a (R, R, 3) atlas (logits); flat mode: per-vertex
            # (mesh backend, barycentric) or per-face (splat backend) colors
            "texture": zeros(*self._texture_shape()),
            "static_offset": zeros(1, V, 3),
            # per-frame vertex offsets (the contract's dynamic_offset field),
            # optimized only by the late optional rgb_dynamic_offset stage
            "dynamic_offset": zeros(T, V, 3),
            # log-scale multiplier on the caller's focal guess, optimized in
            # the landmark stages when cfg.optimize_focal
            "focal_log_scale": zeros(),
        }

    def _scaled_camera(self, base: Camera, p: dict) -> Camera:
        """Apply the optimized focal multiplier to a base camera."""
        if "focal_log_scale" not in p:   # externally built param dicts
            return base
        s = torch.exp(p["focal_log_scale"])
        return dataclasses.replace(base, fx=base.fx * s, fy=base.fy * s)

    # ── losses ───────────────────────────────────────────────
    def _flame_args(self, p: dict) -> dict:
        args = {k: p[k] for k in ("shape", "expr", "rotation", "neck_pose",
                                  "jaw_pose", "eyes_pose", "translation")}
        if self.cfg.use_static_offset:
            args["static_offset"] = p["static_offset"]
        if self.cfg.use_dynamic_offset:
            args["dynamic_offset"] = p["dynamic_offset"]
        return args

    def _prep_frames(self, frames):
        """uint8 frame stack (array or tensor) -> uint8 tensor on the
        tracker's device, downsampled once when the photometric stages run
        at reduced resolution (antialiased linear resize, then truncated)."""
        if frames is None:
            return None
        f = torch.as_tensor(frames).to(self.device)
        if self.rgb_downsample > 1:
            f = F.interpolate(
                f.to(torch.float32).permute(0, 3, 1, 2),
                size=(self.p_height, self.p_width), mode="bilinear",
                antialias=True, align_corners=False).permute(0, 2, 3, 1)
            f = torch.clamp(f, 0, 255).to(torch.uint8)
        return f.contiguous()

    def _landmark_loss(self, p: dict, target_lmk, valid_mask, verts=None, n_valid=None):
        """`verts`: the posed vertices of `p`, when the caller has them;
        `n_valid`: the valid frames the mean is over (default: `valid_mask`'s)."""
        if verts is None:
            verts = flame_forward(self.model, self._flame_args(p))
        lmk3d = flame_landmarks(self.model, verts)                 # (T, L, 3)
        L = lmk3d.shape[1]
        cam = self._scaled_camera(self.camera, p)
        uv, _ = project_points(cam, lmk3d)
        scale = float(max(self.width, self.height))
        diff = (uv - target_lmk) / scale
        m = valid_mask[:, None, None].to(torch.float32)
        n_valid = m.sum() if n_valid is None else n_valid
        return torch.sum(diff * diff * m) / (torch.clamp_min(n_valid, 1.0) * L)

    def _photometric_loss(self, p: dict, frames, frame_idx, verts=None):
        """Render the textured FLAME mesh for a frame subset (`frame_idx`:
        host ints), compare to RGB."""
        clock = self.clock
        if verts is None:
            verts = flame_forward(self.model, self._flame_args(p))
        model, bg = self.model, self._bg
        # rendered with the refined focal; the focal itself is only
        # trainable in the landmark stages
        p_cam = self._scaled_camera(self.p_camera, p)

        uv_mode = self.cfg.texture_mode == "uv"
        if self.cfg.photometric_backend == "mesh":
            from omfs4d_torch.render.mesh_raster import rasterize_mesh
            from omfs4d_torch.render.texture import render_textured_mesh

            tex_or_cols = torch.sigmoid(p["texture"])

            def one(v, gt):
                if uv_mode:
                    # deferred texturing: UV attribute raster -> one
                    # bilinear atlas sample per pixel
                    img, _ = render_textured_mesh(
                        v, model.faces, model.uv_coords, tex_or_cols, p_cam,
                        self.p_width, self.p_height, background=bg,
                        face_opacity=0.98, tile=self.tile,
                        max_per_tile=self.max_per_tile)
                else:
                    img, _ = rasterize_mesh(
                        v, model.faces, tex_or_cols, p_cam,
                        self.p_width, self.p_height, face_opacity=0.98,
                        background=bg, tile=self.tile,
                        max_per_tile=self.max_per_tile, vertex_interp=True)
                return l1_loss(img, gt)
        else:
            if uv_mode:
                # per-splat appearance from the atlas: each face splat
                # samples the texture at its centroid UV, in logit space
                # (bind_to_mesh applies the sigmoid)
                from omfs4d_torch.render.texture import bilinear_sample, face_center_uv

                fuv = face_center_uv(model.uv_coords, model.faces)
                avatar = _texture_avatar(model, bilinear_sample(p["texture"], fuv))
            else:
                avatar = _texture_avatar(model, p["texture"])

            def one(v, gt):
                means, rot, scales, opac, cols = bind_to_mesh(avatar, v, model.faces)
                if clock is not None:
                    clock.lap("bind")
                # every face splat that outgrows the small window gets the
                # full one (large_frac=1.0): the tracker has no
                # spill-escalation loop, and a silently clipped render
                # poisons the photometric gradient
                img, _ = rasterize(
                    means, rot, scales, opac, cols, p_cam,
                    self.p_width, self.p_height, background=bg,
                    tile=self.tile, max_per_tile=self.max_per_tile,
                    large_frac=1.0, clock=clock)
                return l1_loss(img, gt)

        losses = []
        for i in frame_idx:
            i = int(i)
            losses.append(one(verts[i], frames[i].to(torch.float32) / 255.0))
            if clock is not None:
                clock.lap("l1")
        return losses[0] if len(losses) == 1 else torch.stack(losses).mean()

    def _regularizers(self, p: dict) -> torch.Tensor:
        cfg = self.cfg
        reg = (
            cfg.reg_shape * torch.mean(p["shape"] ** 2)
            + cfg.reg_expr * torch.mean(p["expr"] ** 2)
            + cfg.reg_jaw * torch.mean(p["jaw_pose"] ** 2)
            + 1e-2 * torch.mean(p["static_offset"] ** 2)
        )
        if cfg.use_dynamic_offset:
            # strongly regularized: dynamic offsets absorb residual error
            # last, after pose/expression/static offsets have explained
            # everything they can
            reg = reg + cfg.reg_dynamic * torch.mean(p["dynamic_offset"] ** 2)
            if p["expr"].shape[0] > 1:
                reg = reg + (cfg.temporal_smoothness * 100.0
                             * torch.mean(torch.diff(p["dynamic_offset"], dim=0) ** 2))
        s = cfg.temporal_smoothness
        if p["expr"].shape[0] > 1:
            # per-key weights: articulated params (jaw, expression) carry
            # most of the frame-to-frame tracking noise; pose/translation
            # see much more of the image and need far less prior
            for k, w in (("expr", 30.0), ("jaw_pose", 300.0),
                         ("rotation", 3.0), ("translation", 3.0)):
                reg = reg + s * w * torch.mean(torch.diff(p[k], dim=0) ** 2)
        return reg

    # ── per-group optimizer; a stage trains a subset of the keys ──
    def _stage_loss(self, p: dict, data: dict, frame_idx, lmk_w: float, rgb_w: float):
        """regularizers + lmk_w * landmark + rgb_w * photometric, with one
        FLAME forward for both terms; a term with weight 0 is left out."""
        clock = self.clock
        loss = self._regularizers(p)
        verts = None
        if lmk_w > 0 or rgb_w > 0:
            verts = flame_forward(self.model, self._flame_args(p))
            if clock is not None:
                clock.lap("flame")
        if lmk_w > 0:
            loss = loss + lmk_w * self._landmark_loss(
                p, data["landmarks"], data["valid"], verts=verts)
            if clock is not None:
                clock.lap("landmark")
        if rgb_w > 0:
            loss = loss + rgb_w * self._photometric_loss(
                p, data["frames"], frame_idx, verts=verts)
        return loss

    def _frame_block(self, T: int) -> tuple[int, int]:
        """This rank's frames [a, b): balanced contiguous blocks."""
        n = self.mesh.axis_size(self.data_axis)
        if T < n:
            raise ValueError(f"FlameTracker: {T} frames for {n} ranks of the mesh")
        r = self.mesh.axis_index(self.data_axis)
        return r * T // n, (r + 1) * T // n

    def _stage_loss_sharded(self, params: dict, leaves: dict, data: dict, frame_idx,
                            lmk_w: float, rgb_w: float) -> torch.Tensor:
        """This rank's part of `_stage_loss` (the parts sum to it): the
        terms of its block of frames, and on the first rank the priors of
        the global keys.  The leaves are replicated inputs, so their
        gradients come out summed over the ranks."""
        from omfs4d_torch.parallel import collectives as C

        cfg, mesh, axis = self.cfg, self.mesh, self.data_axis
        used = dict(zip(leaves, C.replicated(mesh, axis, *leaves.values())))
        p = {**params, **used}
        T = p["expr"].shape[0]
        a, b = self._frame_block(T)
        loc = {k: (p[k][a:b] if k in FRAME_KEYS else p[k]) for k in p}

        # regularizers: per-frame means over all T frames, from this block
        def block_mean(k):
            return torch.sum(loc[k] ** 2) / p[k].numel()

        loss = cfg.reg_expr * block_mean("expr") + cfg.reg_jaw * block_mean("jaw_pose")
        if mesh.axis_index(axis) == 0:
            loss = loss + (cfg.reg_shape * torch.mean(p["shape"] ** 2)
                           + 1e-2 * torch.mean(p["static_offset"] ** 2))
        temporal = [("expr", 30.0 * cfg.temporal_smoothness),
                    ("jaw_pose", 300.0 * cfg.temporal_smoothness),
                    ("rotation", 3.0 * cfg.temporal_smoothness),
                    ("translation", 3.0 * cfg.temporal_smoothness)]
        if cfg.use_dynamic_offset:
            loss = loss + cfg.reg_dynamic * block_mean("dynamic_offset")
            temporal.insert(0, ("dynamic_offset", cfg.temporal_smoothness * 100.0))
        if T > 1:
            # one halo exchange: the previous rank's last row of every key
            last = torch.cat([loc[k][-1].reshape(-1) for k, _ in temporal])
            prev = C.halo_prev(last, mesh, axis)
            if a == 0:
                loss = C.joined(loss, prev)     # the first block has no previous frame
            at = 0
            for k, w in temporal:
                row = loc[k][-1].numel()
                rows = loc[k]
                if a > 0:
                    rows = torch.cat([prev[at:at + row].view(1, *rows.shape[1:]), rows])
                at += row
                diff = torch.diff(rows, dim=0)
                loss = loss + w * torch.sum(diff ** 2) / ((T - 1) * p[k][0].numel())
        if lmk_w > 0 or rgb_w > 0:
            verts = flame_forward(self.model, self._flame_args(loc))
        if lmk_w > 0:
            n_valid = data["valid"].to(torch.float32).sum()
            loss = loss + lmk_w * self._landmark_loss(
                loc, data["landmarks"][a:b], data["valid"][a:b], verts=verts, n_valid=n_valid)
        if rgb_w > 0:
            mine = [int(i) - a for i in frame_idx if a <= int(i) < b]
            if mine:
                loss = loss + rgb_w * len(mine) / len(frame_idx) * self._photometric_loss(
                    loc, data["frames"][a:b], mine, verts=verts)
        # every rank joins the gradient's all-reduce, whatever its terms used
        return C.joined(loss, *used.values())

    def _stage_step(self, params: dict, opt_state: dict, data: dict, frame_idx,
                    lmk_w: float, rgb_w: float) -> torch.Tensor:
        """One Adam step, in place, on the keys of `params` that `opt_state`
        holds a group for (one `adam_init` per trainable key).  Returns the
        loss before the update (a device tensor)."""
        clock = self.clock
        if clock is not None:
            clock.start()
        leaves = {k: params[k].detach().requires_grad_() for k in opt_state}
        if self.mesh is None:
            loss = self._stage_loss({**params, **leaves}, data, frame_idx, lmk_w, rgb_w)
        else:
            loss = self._stage_loss_sharded(params, leaves, data, frame_idx, lmk_w, rgb_w)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        if self.mesh is not None:
            from omfs4d_torch.parallel import collectives as C

            loss = C.all_reduce_(loss.detach().clone(), self.mesh, self.data_axis)
        if clock is not None:
            clock.lap("backward")
        for (k, state), g in zip(opt_state.items(), grads):
            # a key the loss does not reach has a zero gradient
            g = torch.zeros_like(params[k]) if g is None else g
            adam_update(state, {k: g}, {k: params[k]}, self.group_lr[k])
        if clock is not None:
            clock.lap("optimizer")
        return loss.detach()

    # ── one stage = n steps ──────────────────────────────────
    def _run_stage(
        self,
        name: str,
        params: dict,
        steps: int,
        trainable: tuple[str, ...],
        lmk_w: float,
        rgb_w: float,
        data: dict,
        events: EventLogger,
        rgb_batch: int = 4,
    ) -> dict:
        """Returns new parameters; `params` is left as it was."""
        params = {k: v.detach().clone() for k, v in params.items()}
        # Adam state is made anew for every stage, one group per trainable key
        opt_state = {k: adam_init({k: params[k]}) for k in params if k in trainable}
        T = params["expr"].shape[0]
        rng = np.random.default_rng(0)
        B = min(rgb_batch, T)
        loss = torch.zeros((), device=self.device)
        t0 = time.time()
        for _ in range(steps):
            # drawn in the landmark stages too: the stream is the reference's
            frame_idx = rng.integers(0, T, size=(B,)).tolist()
            loss = self._stage_step(params, opt_state, data, frame_idx, lmk_w, rgb_w)
        loss_f = float(loss)   # waits: wall time covers the device work
        dt = time.time() - t0
        events.emit("track_stage", stage=name, steps=steps, loss=loss_f,
                    seconds=round(dt, 2))
        log.info(f"stage {name}: {steps} steps, loss {loss_f:.5f} ({dt:.1f}s)")
        return params

    # ── sequential per-frame tracking ────────────────────────
    def _run_sequential(
        self,
        params: dict,
        data: dict,
        steps_per_frame: int,
        trainable: tuple[str, ...] = ("expr", "rotation", "neck_pose",
                                      "jaw_pose", "eyes_pose", "translation"),
        lmk_w: float = 0.3,
        rgb_w: float = 1.0,
        events: EventLogger | None = None,
        lr: float | None = None,
    ) -> dict:
        """Per-frame warm-start sweep (stage `rgb_sequential_tracking`).

        Frames are fitted in order, each initialized from the previous
        frame's solution: `steps_per_frame` Adam updates (one rate, fresh
        moments) on the frame's trainable rows; the other per-frame rows
        keep this frame's own values and the global params (shape, texture,
        static offsets) stay frozen.  This is what makes long videos with
        large motion converge: frame t starts at frame t-1's pose instead of
        at the batched average.  The regularizers are not part of a row's
        loss, as in the reference.
        """
        events = events or EventLogger()
        trainable = tuple(k for k in trainable if k in FRAME_KEYS)
        lr = lr or self.cfg.lr
        use_rgb = rgb_w > 0 and data.get("frames") is not None
        T = params["expr"].shape[0]

        frozen = {k: v.detach() for k, v in params.items() if k not in FRAME_KEYS}
        rows = {k: params[k].detach() for k in FRAME_KEYS}
        t0 = time.time()
        carry = {k: rows[k][0] for k in trainable}
        fitted = {k: [] for k in trainable}
        for t in range(T):
            # warm start trainable keys from the previous frame's fit; fixed
            # keys keep this frame's own current values
            row_opt = {k: v.clone() for k, v in carry.items()}
            fixed = {**frozen, **{k: rows[k][t:t + 1] for k in FRAME_KEYS
                                  if k not in trainable}}
            frame = {"landmarks": data["landmarks"][t:t + 1], "valid": data["valid"][t:t + 1],
                     "frames": data["frames"][t:t + 1] if use_rgb else None}
            opt_state = adam_init(row_opt)
            for _ in range(steps_per_frame):
                if not self._row_step(row_opt, opt_state, fixed, frame, lmk_w,
                                      rgb_w if use_rgb else 0.0, lr):
                    break
            for k in trainable:
                fitted[k].append(row_opt[k])
            carry = row_opt
        out = {**frozen, **rows, **{k: torch.stack(v) for k, v in fitted.items()}}
        with torch.no_grad():
            final = float(self._landmark_loss(out, data["landmarks"], data["valid"]))
        dt = time.time() - t0
        events.emit("track_stage", stage="rgb_sequential_tracking",
                    steps=steps_per_frame * T, loss=final, seconds=round(dt, 2))
        log.info(f"stage rgb_sequential_tracking: {steps_per_frame}/frame "
                 f"x {T} frames, lmk loss {final:.5f} ({dt:.1f}s)")
        return out

    def _row_step(self, row_opt: dict, opt_state: dict, fixed: dict, frame: dict,
                  lmk_w: float, rgb_w: float, lr: float) -> bool:
        """One Adam step of the sequential sweep on one frame's trainable rows
        `row_opt` (each without its frame axis), in place; `fixed` holds every
        other key, `frame` the frame's landmarks, validity and image with a
        frame axis of 1.  False when no term of the loss reaches a row (then
        nothing moves, as with the reference's zero gradients)."""
        leaves = {k: v.detach().requires_grad_() for k, v in row_opt.items()}
        p1 = {**fixed, **{k: v[None] for k, v in leaves.items()}}
        loss = self._row_loss(p1, frame, lmk_w, rgb_w)
        if not loss.requires_grad:
            return False
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        adam_update(opt_state,
                    {k: (torch.zeros_like(row_opt[k]) if g is None else g)
                     for k, g in zip(leaves, grads)}, row_opt, lr)
        return True

    def _row_loss(self, p1: dict, frame: dict, lmk_w: float, rgb_w: float) -> torch.Tensor:
        """A single frame's loss of the sequential sweep: no regularizers."""
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        if lmk_w <= 0 and rgb_w <= 0:
            return loss
        verts = flame_forward(self.model, self._flame_args(p1))
        if lmk_w > 0:
            loss = loss + lmk_w * self._landmark_loss(
                p1, frame["landmarks"], frame["valid"], verts=verts)
        if rgb_w > 0:
            loss = loss + rgb_w * self._photometric_loss(p1, frame["frames"], [0], verts=verts)
        return loss

    # ── full schedule ────────────────────────────────────────
    def fit(
        self,
        landmarks,                      # (T, L, 2) array or tensor
        valid,                          # (T,)
        frames=None,                    # (T, H, W, 3) uint8 array or tensor
        events: EventLogger | None = None,
        init_params: dict | None = None,
    ) -> TrackerResult:
        cfg = self.cfg
        events = events or EventLogger()
        T = len(landmarks)
        data = {
            "landmarks": torch.as_tensor(landmarks).to(self.device, torch.float32),
            "valid": torch.as_tensor(valid).to(self.device),
            "frames": self._prep_frames(frames),
        }
        p = (self.init_params(T) if not init_params else
             {k: torch.as_tensor(v).to(self.device, torch.float32)
              for k, v in init_params.items()})

        focal = ("focal_log_scale",) if cfg.optimize_focal else ()
        p = self._run_stage(
            "lmk_init_rigid", p, cfg.steps_lmk_init_rigid,
            ("rotation", "translation") + focal, 1.0, 0.0, data, events,
        )
        p = self._run_stage(
            "lmk_init_all", p, cfg.steps_lmk_init_all,
            ("shape", "expr", "rotation", "neck_pose", "jaw_pose",
             "eyes_pose", "translation") + focal,
            1.0, 0.0, data, events,
        )

        photometric = cfg.photometric and frames is not None
        if photometric:
            p = self._run_stage(
                "rgb_init_texture", p, cfg.steps_rgb_init_texture,
                ("texture",), 0.0, 1.0, data, events,
            )
            trainable = ["shape", "expr", "rotation", "neck_pose", "jaw_pose",
                         "eyes_pose", "translation", "texture"]
            if cfg.use_static_offset:
                trainable.append("static_offset")
            p = self._run_stage(
                "rgb_init_all", p, cfg.steps_rgb_init_all,
                tuple(trainable), 0.3, 1.0, data, events,
            )
            # dedicated static-offset stage
            if cfg.use_static_offset and cfg.steps_rgb_init_offset > 0:
                p = self._run_stage(
                    "rgb_init_offset", p, cfg.steps_rgb_init_offset,
                    ("static_offset", "texture"), 0.1, 1.0, data, events,
                )
            # per-frame warm-start sweep
            if cfg.steps_rgb_sequential > 0 and T > 1:
                p = self._run_sequential(
                    p, data, cfg.steps_rgb_sequential, events=events,
                )
            for epoch in range(cfg.epochs_global):
                p = self._run_stage(
                    f"global_optimization_{epoch}", p, cfg.steps_global,
                    tuple(trainable), 0.3, 1.0, data, events,
                )
            # late optional per-frame vertex refinement: runs last so
            # pose/expression explain the motion first and the heavily
            # regularized offsets only absorb the residual
            if cfg.use_dynamic_offset and cfg.steps_rgb_dynamic_offset > 0:
                p = self._run_stage(
                    "rgb_dynamic_offset", p, cfg.steps_rgb_dynamic_offset,
                    ("dynamic_offset",), 0.1, 1.0, data, events,
                )

        with torch.no_grad():
            final_lmk = float(self._landmark_loss(p, data["landmarks"], data["valid"]))
            focal_scale = float(torch.exp(p["focal_log_scale"]))
            texture = torch.sigmoid(p["texture"]).cpu().numpy()
        if cfg.optimize_focal:
            log.info(f"refined focal: x{focal_scale:.4f} "
                     f"(fx {float(self.camera.fx) * focal_scale:.1f})")
        return TrackerResult(
            params=self.export_params(p),
            texture=texture,
            losses={"landmark": final_lmk},
            focal_scale=focal_scale,
        )

    # ── contract export ──────────────────────────────────────
    def export_params(self, p: dict) -> dict:
        """Pad to the dataset contract (shape 300 / expr 100 / offsets), as
        numpy arrays."""
        T = p["expr"].shape[0]
        V = self.model.n_vertices

        def host(x):
            return x.detach().cpu().numpy()

        shape_full = np.zeros(300, np.float32)
        shape_full[: self.cfg.n_shape] = host(p["shape"])
        expr_full = np.zeros((T, 100), np.float32)
        expr_full[:, : self.cfg.n_expr] = host(p["expr"])
        return {
            "shape": shape_full,
            "expr": expr_full,
            "rotation": host(p["rotation"]),
            "neck_pose": host(p["neck_pose"]),
            "jaw_pose": host(p["jaw_pose"]),
            "eyes_pose": host(p["eyes_pose"]),
            "translation": host(p["translation"]),
            "static_offset": host(p["static_offset"]),
            # non-zero when the optional rgb_dynamic_offset stage ran
            "dynamic_offset": (host(p["dynamic_offset"])
                               if "dynamic_offset" in p
                               else np.zeros((T, V, 3), np.float32)),
        }
