"""A mesh of ranks with named axes, and the sharding helpers over it.

Port of `omfs4d.parallel.mesh`.  The reference is single-controller: one JAX
process sees every device, and a `jax.sharding.Mesh` names their axes.  The
port is SPMD: one process per rank (`torch.distributed`), each with its own
device, and a `Mesh` is a grid of world ranks with named axes and one process
group per row or column of each axis, which the explicit collectives of
`omfs4d_torch.parallel.collectives` run over:

  * ``data`` — frames: the tracker's and the trainer's frame batches;
  * ``tile`` — screen space: the tile grid of one frame;
  * ``gauss`` — the gaussian axis of a model-parallel avatar.

Every rank must build every mesh, in the same order: `new_group` is a
collective of the whole world.  With no process group (one process) a mesh
of size 1 works the same way and its collectives do nothing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
TILE_AXIS = "tile"
GAUSS_AXIS = "gauss"

_MESH: "Mesh | None" = None


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) with no process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """`ranks`: an int grid of world ranks, one dimension per name of
    `axis_names`.  `shape[axis]` is the axis's size, as on a JAX mesh."""

    def __init__(self, ranks, axis_names: tuple[str, ...]):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.ranks.shape} for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.rank, world_size = world()
        if self.ranks.size and int(self.ranks.max()) >= world_size:
            raise ValueError(f"mesh ranks {self.ranks.ravel().tolist()} outside a world "
                             f"of {world_size}")
        where = np.argwhere(self.ranks == self.rank)
        #: this rank's position in the grid, or None when it is not in the mesh
        self.coords = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups: dict = {}
        distributed = world_size > 1
        for i, name in enumerate(self.axis_names):
            rows = np.moveaxis(self.ranks, i, -1).reshape(-1, self.ranks.shape[i])
            for row in rows:
                self._add_group(name, row.tolist(), distributed)
        self._add_group(None, sorted(self.ranks.ravel().tolist()), distributed)

    def _add_group(self, key, members: list[int], distributed: bool) -> None:
        group = dist.new_group(members) if distributed and len(members) > 1 else None
        if self.rank in members:
            self._groups[key] = (group, members)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def contains(self) -> bool:
        return self.coords is not None

    def axis_size(self, axis: str | None) -> int:
        return self.size if axis is None else self.shape[axis]

    def axis_index(self, axis: str | None) -> int:
        """This rank's index along `axis` (`None`: its place in the mesh)."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in {self}")
        if axis is None:
            return self._groups[None][1].index(self.rank)
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str | None):
        """(process group or None for a group of one, its world ranks) of
        this rank's row along `axis`; `None` is the whole mesh."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in {self}")
        return self._groups[axis]

    def first_rank(self, axis: str | None = None) -> int:
        """The world rank at index 0 of this rank's row along `axis`."""
        return self.group(axis)[1][0] if axis is not None else int(self.ranks.ravel()[0])


def make_mesh(n_data: int = -1, n_tile: int = 1, ranks=None) -> Mesh:
    """A (data, tile) mesh over `ranks` (default: the whole world)."""
    ranks = list(range(world()[1])) if ranks is None else list(ranks)
    n = len(ranks)
    if n_data <= 0:
        n_data = n // max(n_tile, 1)
    if n_data * n_tile > n:
        raise ValueError(f"mesh {n_data}x{n_tile} > {n} ranks")
    grid = np.asarray(ranks[: n_data * n_tile]).reshape(n_data, n_tile)
    return Mesh(grid, (DATA_AXIS, TILE_AXIS))


def get_mesh() -> Mesh:
    """Process-wide default mesh (every rank on the data axis)."""
    global _MESH
    if _MESH is None:
        _MESH = make_mesh()
    return _MESH


def set_mesh(mesh: Mesh) -> None:
    global _MESH
    _MESH = mesh


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_frames(x, mesh: Mesh | None = None, axis: str = DATA_AXIS) -> torch.Tensor:
    """This rank's block of rows of axis 0, the rows first padded with zeros
    to a multiple of the axis size."""
    mesh = mesh or get_mesh()
    x = torch.as_tensor(x)
    n = mesh.axis_size(axis)
    rows = pad_to_multiple(x.shape[0], n)
    if rows != x.shape[0]:
        x = torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])
    per = rows // n
    i = mesh.axis_index(axis)
    return x[i * per:(i + 1) * per]


def shard_batch(tree: dict, mesh: Mesh | None = None, axis: str = DATA_AXIS) -> dict:
    return {k: shard_frames(v, mesh, axis) for k, v in tree.items()}


def replicate(tree, mesh: Mesh | None = None, axis: str | None = None):
    """Every tensor of `tree` (a tensor or a dict of them) broadcast in place
    from the first rank of `axis` (`None`: of the whole mesh)."""
    from omfs4d_torch.parallel.collectives import broadcast_

    mesh = mesh or get_mesh()
    if torch.is_tensor(tree):
        return broadcast_(tree, mesh, axis)
    return {k: replicate(v, mesh, axis) for k, v in tree.items()}
