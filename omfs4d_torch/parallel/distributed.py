"""Multi-process start-up: one process per rank over `torch.distributed`.

Port of `omfs4d.parallel.distributed`.  The reference's `jax.distributed`
joins processes into one single-controller job; here each process is one
rank of an SPMD job:

  * :func:`init_distributed` — `env://` as `torchrun` sets it, or an explicit
    address, rank and world size.  The backend is `nccl` only when every rank
    of the host has its own card, else `gloo` (several ranks on one card, or
    the CPU; gloo takes the CUDA tensors as they are).  On a card the kernels
    are built once: rank 0 builds, the others wait.
  * :func:`global_mesh` — a named mesh over every rank.
  * :func:`make_global_batch` — per-process data loading: each rank keeps
    only the frames it owns (`process_local_indices`).
  * `python -m omfs4d_torch.parallel.distributed --smoke ...` — one process
    of a 2-process frame-DP training run in which each process loads only
    its frames.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from omfs4d_torch.parallel.collectives import make_wait_group
from omfs4d_torch.parallel.mesh import Mesh, world


def default_backend(device: torch.device, local_world: int) -> str:
    """`nccl` when every rank of the host has a card of its own, else
    `gloo` (NCCL refuses two ranks on one card)."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, device: str | torch.device | None = None,
                     backend: str | None = None, timeout_s: float = 600.0) -> torch.device:
    """Join the process group and return this rank's device.

    With no arguments the group comes from the environment `torchrun` sets
    (`env://`: MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE, LOCAL_RANK).
    Otherwise pass `init_method` (e.g. "tcp://127.0.0.1:29500"), `world_size`
    and `rank`.  `device=None` is the card `LOCAL_RANK % device_count`;
    "cpu" asks for the CPU.  `timeout_s` bounds each collective; a rank
    that waits while another works alone (a stage, a training run) waits on
    `collectives.wait_group`, whose timeout is a stage's."""
    import datetime

    from omfs4d_torch.core.device import resolve_device

    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass device='cpu'")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    device = resolve_device(device, "init_distributed")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or default_backend(device, local_world)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    make_wait_group()
    if device.type == "cuda":
        from omfs4d_torch import _build

        _build.load_library()
    return device


def global_mesh(axis_names: tuple[str, ...] = ("data",),
                axis_sizes: tuple[int, ...] | None = None) -> Mesh:
    """A mesh over every rank; `axis_sizes` may hold one -1 (inferred).  The
    reference's TPU topology layout (the leading axis across slices) has no
    counterpart here: ranks are laid out in order."""
    n = world()[1]
    if axis_sizes is None:
        if len(axis_names) != 1:
            raise ValueError("axis_sizes required for multi-axis meshes")
        axis_sizes = (n,)
    sizes = list(axis_sizes)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) > n:
        raise ValueError(f"mesh {sizes} needs more than {n} ranks")
    return Mesh(np.arange(int(np.prod(sizes))).reshape(sizes), axis_names)


def process_local_indices(mesh: Mesh, axis: str, global_n: int) -> np.ndarray:
    """Global indices along `axis` that this rank owns when an array of
    leading dimension `global_n` is split over the axis in contiguous
    blocks: the data loader reads only these frames."""
    n = mesh.axis_size(axis)
    per = -(-global_n // n)
    i = mesh.axis_index(axis)
    return np.arange(i * per, min((i + 1) * per, global_n))


class GlobalRows:
    """A frame-sharded array as this rank holds it: its own rows only,
    indexed by global frame index (`rows[i]` for an owned `i`), with the
    global shape."""

    def __init__(self, local: torch.Tensor, indices: np.ndarray, global_n: int):
        self.local = local
        self._at = {int(g): j for j, g in enumerate(indices)}
        self.shape = (global_n,) + tuple(local.shape[1:])
        self.device = local.device

    def __getitem__(self, i: int) -> torch.Tensor:
        i = int(i)
        if i not in self._at:
            raise IndexError(f"frame {i} is not on this rank (it holds {sorted(self._at)})")
        return self.local[self._at[i]]


def make_global_batch(local_tree: dict, mesh: Mesh, axis: str, global_n: int,
                      device: str | torch.device = "cpu") -> dict:
    """A frame batch from this rank's rows (loaded from
    `process_local_indices(...)`, in global order): each value becomes a
    `GlobalRows` on `device`."""
    idx = process_local_indices(mesh, axis, global_n)
    return {k: GlobalRows(torch.as_tensor(np.asarray(v)).to(device), idx, global_n)
            for k, v in local_tree.items()}


def replicate_global(tree, mesh: Mesh):
    """Every tensor of `tree` broadcast from the mesh's first rank."""
    from omfs4d_torch.parallel.mesh import replicate

    return replicate(tree, mesh, None)


# ── multi-process smoke worker ──────────────────────────────
def _smoke_worker(process_id: int, num_processes: int, port: int, out_path: str) -> None:
    """One SPMD process of a tiny frame-DP training run: each process loads
    only its own frames, the train step runs over a mesh of every process,
    and the losses (replicated) are written out for comparison."""
    from omfs4d_torch.core.config import TrainConfig
    from omfs4d_torch.models.assets import synthetic_flame_asset
    from omfs4d_torch.models.flame import FlameModel, flame_forward
    from omfs4d_torch.ops.camera import look_at_camera
    from omfs4d_torch.train.trainer import AvatarTrainer

    torch.set_num_threads(1)
    init_distributed(f"tcp://127.0.0.1:{port}", num_processes, process_id, device="cpu")
    S = 32
    B = num_processes
    mesh = global_mesh(("data",))
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=0))
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * S, width=S, height=S)
    with torch.no_grad():
        verts = flame_forward(model, {"shape": torch.zeros(300),
                                      "expr": torch.zeros((B, 100))}).numpy()
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (B, S, S, 3)).astype(np.uint8)

    # per-process loading: this process holds only its frames
    mine = process_local_indices(mesh, "data", B)
    local = {
        "images": images[mine], "verts": verts[mine],
        "w2c": np.tile(cam.w2c.numpy()[None], (len(mine), 1, 1)),
        "fx": np.full((len(mine),), float(cam.fx), np.float32),
        "fy": np.full((len(mine),), float(cam.fy), np.float32),
        "cx": np.full((len(mine),), float(cam.cx), np.float32),
        "cy": np.full((len(mine),), float(cam.cy), np.float32),
    }
    data = make_global_batch(local, mesh, "data", B)
    cfg = TrainConfig(batch_frames=B, max_gaussians=512, sh_degree=1,
                      densify_interval=0, opacity_reset_interval=0)
    trainer = AvatarTrainer(model.faces.numpy(), cfg, S, S, max_per_tile=64, mesh=mesh,
                            device="cpu")
    state = trainer.init_state(capacity=512)
    losses = []
    for _ in range(3):
        state, metrics = trainer.train_step(state, data, list(range(B)))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses   # it trains
    with open(out_path, "w") as f:
        f.write(repr(losses))
    dist.destroy_process_group()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--port", type=int, default=12931)
    ap.add_argument("--out", type=str, required=True)
    args = ap.parse_args(argv)
    if args.smoke:
        _smoke_worker(args.process_id, args.num_processes, args.port, args.out)


if __name__ == "__main__":
    main()
