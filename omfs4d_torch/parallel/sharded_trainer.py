"""Model-parallel avatar training: the gaussians, their Adam moments and the
densify accumulators sharded over the `gauss` axis of a mesh.

Port of `omfs4d.parallel.sharded_trainer`, SPMD: each rank owns N/n rows of
every capacity-leading tensor (rank i of the axis rows i*N/n .. (i+1)*N/n of
the global cloud) and runs the same loop as `AvatarTrainer`, whose loop,
windows and opacity reset it inherits.  Only the loss
(`avatar_loss_gaussian_sharded`: the depth-slice `all_to_all` and the slice
`all_gather`) and a few scalars cross ranks; Adam is elementwise, and
densify / clone / split / prune runs per shard into the shard's own dead
slots.  FLAME co-optimization keeps the FLAME params replicated: every rank
computes their full gradient, and the first rank's is broadcast so the
replicas stay equal bit for bit.

`data_axis` adds frame data parallelism: on a (data x gauss) mesh, each data
row fits its own sampled frame per step (B = the data-axis size).

Checkpoints are the one-process trainer's files: the mesh's first rank
gathers the state and writes them, and a restore re-shards (the capacity
must divide the axis), so a checkpoint goes either way between the two
trainers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from omfs4d_torch.core.config import TrainConfig
from omfs4d_torch.core.logging import get_logger
from omfs4d_torch.models.flame import flame_forward
from omfs4d_torch.models.gaussians import GaussianAvatar, init_gaussians_on_mesh
from omfs4d_torch.ops.camera import Camera
from omfs4d_torch.parallel import collectives as C
from omfs4d_torch.parallel.mesh import Mesh
from omfs4d_torch.parallel.shard import avatar_loss_gaussian_sharded, fields_of
from omfs4d_torch.train.trainer import (
    FLAME_FROZEN,
    PARAM_GROUPS,
    AvatarTrainer,
    TrainState,
    _map_capacity,
    _take,
    adam_update,
    densify_prune_arrays,
    flame_groups,
    float_fields,
    init_flame_opt_state,
    init_opt_state,
    probe_tile_spans,
    zero_opt_rows,
)

log = get_logger("sharded_trainer")


class ShardedAvatarTrainer(AvatarTrainer):
    """Gaussian-axis-sharded avatar training over a mesh."""

    def __init__(self, faces, cfg: TrainConfig, width: int, height: int, mesh: Mesh,
                 axis: str = "gauss", white_background: bool = True, tile: int = 16,
                 max_per_tile: int = 512, max_tiles_per_gaussian: int = 16,
                 flame_model=None, data_axis: str | None = None,
                 device: str | torch.device | None = None):
        super().__init__(faces, cfg, width, height, white_background=white_background,
                         tile=tile, max_per_tile=max_per_tile,
                         max_tiles_per_gaussian=max_tiles_per_gaussian,
                         flame_model=flame_model, device=device)
        self.mesh, self.axis = mesh, axis
        self.n_dev = mesh.shape[axis]
        self.shard = mesh.axis_index(axis)
        self.data_axis = data_axis
        #: frames per step: one per data row
        self.batch = mesh.shape[data_axis] if data_axis else 1

    # ── state ────────────────────────────────────────────────
    def shard_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global capacity-leading tensor."""
        local = t.shape[0] // self.n_dev
        return t[self.shard * local:(self.shard + 1) * local].detach().clone().to(self.device)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global tensor from every shard's rows (a collective)."""
        flag = t.dtype == torch.bool
        rows = C.all_gather(t.to(torch.uint8) if flag else t, self.mesh, self.axis)
        rows = rows.reshape((-1,) + tuple(t.shape[1:]))
        return rows.to(torch.bool) if flag else rows

    def shard_state(self, state: TrainState) -> TrainState:
        """A global state (every capacity-leading tensor whole) -> this
        rank's shard; the capacity must divide the axis."""
        cap = state.gaussians.capacity
        if cap % self.n_dev:
            raise ValueError(f"capacity {cap} not divisible by mesh axis "
                             f"{self.axis}={self.n_dev}")
        return _map_capacity(state, self.shard_rows)

    def gather_state(self, state: TrainState) -> TrainState:
        """This rank's shard -> the global state (a collective of the axis)."""
        return _map_capacity(state, self.gather_rows)

    def init_state(self, capacity: int | None = None, gaussians: GaussianAvatar | None = None,
                   seed: int | None = None, flame_params: dict | None = None) -> TrainState:
        """`gaussians` is the global cloud (every rank passes the same one);
        without it every rank makes the same seeded cloud of `capacity`."""
        if gaussians is None:
            gaussians = init_gaussians_on_mesh(
                self.faces.cpu().numpy(), capacity or self.cfg.max_gaussians,
                seed=seed if seed is not None else self.cfg.seed,
                sh_degree=self.cfg.sh_degree, device=self.device)
        capacity = gaussians.capacity
        if capacity % self.n_dev:
            raise ValueError(f"capacity {capacity} not divisible by mesh axis "
                             f"{self.axis}={self.n_dev}")
        local = GaussianAvatar(**{k: self.shard_rows(getattr(gaussians, k))
                                  for k in ("parent_face", "mu_local", "quat_local",
                                            "log_scale", "opacity_logit", "color", "sh",
                                            "alive")})
        n_local = capacity // self.n_dev
        if flame_params is not None:
            flame_params = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
                            .to(self.device, torch.float32).clone()
                            for k, v in flame_params.items()}
        self._flame_anchor = (
            {k: v.clone() for k, v in flame_params.items()}
            if self.co_optimize and flame_params is not None else None)
        return TrainState(
            gaussians=local,
            opt_state=init_opt_state(local),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            grad_accum=torch.zeros(n_local, device=self.device),
            grad_count=torch.zeros(n_local, device=self.device),
            flame_params=flame_params,
            flame_opt_state=(init_flame_opt_state(flame_params)
                             if self.co_optimize and flame_params is not None else None))

    # ── one sharded step ─────────────────────────────────────
    def _draw(self, rng: np.random.Generator, T: int):
        if self.data_axis:
            return rng.integers(0, T, size=(self.batch,))
        return [int(rng.integers(0, T))]

    def train_step(self, state: TrainState, data: dict, idx) -> tuple[TrainState, dict]:
        """`idx`: one frame index (1-D mesh) or B of them (2-D mesh), the
        same on every rank."""
        cfg = self.cfg
        idx = [int(i) for i in np.atleast_1d(np.asarray(idx))]
        g = state.gaussians
        params = float_fields(g)
        img = _take(data["images"], idx).to(torch.float32) / 255.0
        if "masks" in data:
            m = _take(data["masks"], idx).to(torch.float32)[..., None] / 255.0
            img = img * m + self.bg * (1.0 - m)
        cam = Camera(w2c=_take(data["w2c"], idx), fx=_take(data["fx"], idx),
                     fy=_take(data["fy"], idx), cx=_take(data["cx"], idx),
                     cy=_take(data["cy"], idx), width=self.width, height=self.height)
        probe = torch.zeros((g.capacity, 2), device=self.device, requires_grad=True)
        flame_leaves = {}
        if self.co_optimize:
            groups = flame_groups(state.flame_params)
            flame_leaves = {k: v.detach().requires_grad_()
                            for k, v in state.flame_params.items() if groups[k] != "frozen"}
            sliced = {k: (v if k in FLAME_FROZEN else _take(flame_leaves.get(k, v), idx))
                      for k, v in state.flame_params.items()}
            verts = flame_forward(self.flame_model, sliced)
        else:
            verts = _take(data["verts"], idx)
        if not self.data_axis:
            img, verts = img[0], verts[0]
            cam = Camera(w2c=cam.w2c[0], fx=cam.fx[0], fy=cam.fy[0], cx=cam.cx[0],
                         cy=cam.cy[0], width=self.width, height=self.height)
        opts = {k: self.render_cfg[k] for k in ("tile", "max_per_tile",
                                                "max_tiles_per_gaussian", "large_frac")}
        loss, aux = avatar_loss_gaussian_sharded(
            fields_of(g, params), verts, self.faces, cam, img, mesh=self.mesh, axis=self.axis,
            background=self.bg, probe=probe, lambda_dssim=cfg.lambda_dssim, return_aux=True,
            data_axis=self.data_axis, **opts)
        leaves = list(params.values()) + list(flame_leaves.values()) + [probe]
        grads = torch.autograd.grad(loss, leaves)
        n_p = len(params)
        g_params = dict(zip(params, grads[:n_p]))
        for field, grp in PARAM_GROUPS.items():
            adam_update(state.opt_state[grp], {field: g_params[field]},
                        {field: params[field]}, self.lrs[grp])
        with torch.no_grad():
            q = g.quat_local
            q.copy_(q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12))
        if self.co_optimize:
            g_flame = {k: C.broadcast_(gr.contiguous(), self.mesh, None)
                       for k, gr in zip(flame_leaves, grads[n_p:-1])}
            # the reference normalizes the leash by the frames per step
            self._update_flame(state, g_flame, data, self.batch)
        with torch.no_grad():
            gnorm = torch.linalg.norm(grads[-1], dim=-1) * (max(self.width, self.height) * 0.5)
            state.grad_accum.add_(gnorm)
            state.grad_count.add_((gnorm > 0).to(torch.float32))
            state.step.add_(1)
            gt = img if not self.data_axis else img[self.mesh.axis_index(self.data_axis)]
            # one all-reduce over the mesh (float64: the count stays exact):
            # each shard's alive count is held by every data row, each data
            # row's mse by every gauss rank
            packed = torch.stack([g.alive.sum().double(),
                                  ((aux["image"] - gt) ** 2).mean().double()])
            C.all_reduce_(packed, self.mesh, None)
            n_rows = self.mesh.axis_size(self.data_axis) if self.data_axis else 1
            alive = (packed[0] / n_rows).round().to(torch.int64)
            mse = (packed[1] / self.mesh.size).float()
            metrics = {"loss": loss.detach(),
                       "psnr": 10.0 * torch.log10(1.0 / torch.clamp_min(mse, 1e-12)),
                       "overflow": aux["overflow"], "window_clipped": aux["window_clipped"],
                       "window_spilled": aux["spilled"], "n_alive": alive}
        return state, metrics

    def step(self, state: TrainState, data: dict, idx) -> tuple[TrainState, dict]:
        return self.train_step(state, data, idx)

    # ── windows, densify, compaction: per shard ──────────────
    def _tile_spans(self, state: TrainState, data: dict, n_probe: int):
        sides, n_frames = probe_tile_spans(state.gaussians, self.faces, data, self.width,
                                           self.height, self.render_cfg["tile"], n_probe)
        sides = sides.reshape(n_frames, -1)
        every = C.all_gather(torch.from_numpy(sides).to(self.device), self.mesh, self.axis)
        return (every.permute(1, 0, 2).reshape(-1).cpu().numpy(), n_frames,
                int(state.gaussians.capacity) * self.n_dev)

    def maybe_grow_capacity(self, state: TrainState) -> TrainState:
        """The sharded cloud keeps its capacity (as the reference's)."""
        return state

    def densify_noise(self, rng_seed: int, iteration: int, max_new: int) -> torch.Tensor:
        """This shard's children's offset noise at `iteration`."""
        gen = torch.Generator().manual_seed(
            (int(rng_seed) * 1_000_003 + int(iteration)) * 1_009 + self.shard)
        return torch.randn((max_new, 3), generator=gen).to(self.device)

    def densify_prune(self, state: TrainState, noise, max_new: int) -> TrainState:
        """Each shard densifies into its own dead slots from its own top-k
        pressure scores (`max_new` per shard); the zero-observation prune
        sees the global observation flag."""
        observed = (state.grad_count > 0).any().to(torch.int32)
        C.all_reduce_(observed, self.mesh, self.axis, "max")
        g2, slots, ok, new_count = densify_prune_arrays(
            state.gaussians, state.grad_accum, state.grad_count, noise, max_new, self.cfg,
            window_observed=observed.bool())
        n = state.gaussians.capacity
        return state._replace(
            gaussians=g2, opt_state=zero_opt_rows(state.opt_state, slots, ok, n),
            grad_accum=torch.zeros(n, device=self.device), grad_count=new_count)

    def densify(self, state: TrainState, noise) -> TrainState:
        """One densify event with this shard's `noise` ((max_new, 3))."""
        return self.densify_prune(state, noise.to(self.device), noise.shape[0])

    def compact_to_alive(self, state: TrainState) -> TrainState:
        """Every shard moves its alive rows to the front (stably) and slices
        to the same new local capacity, sized by the fullest shard."""
        local = state.gaussians.capacity
        per_shard = C.all_gather(state.gaussians.alive.sum().to(torch.int64), self.mesh,
                                 self.axis).cpu().numpy()
        m = self.COMPACT_MULTIPLE
        new_local = max(int(math.ceil(per_shard.max() * self.cfg.compact_slack / m) * m), m)
        if new_local >= local:
            return state
        log.info(f"[sharded] post-densification compaction: local capacity {local} -> "
                 f"{new_local} x {self.n_dev} shards (per-shard alive {per_shard.tolist()})")
        return self.compact_state(state, new_local)

    # ── checkpoints: gathered, written once ──────────────────
    def save_checkpoint(self, state: TrainState, output_dir, iteration: int,
                        block: bool = True):
        """The mesh's first rank writes the gathered state, in the
        one-process trainer's layout; every rank waits for it."""
        whole = self.gather_state(state)
        super().save_checkpoint(whole, output_dir, iteration, block=True)
        C.barrier(self.mesh)

    def restore_checkpoint(self, output_dir, template: TrainState) -> tuple[TrainState, int]:
        """Every rank reads the newest checkpoint and keeps its shard; a
        one-process trainer's checkpoint loads as long as its capacity
        divides the axis."""
        state, it = super().restore_checkpoint(output_dir, template)
        return self.shard_state(state), it
