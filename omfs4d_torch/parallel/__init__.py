"""SPMD parallelism over `torch.distributed`: the port of `omfs4d.parallel`.

One process per rank, each with its own device, and explicit collectives
(`collectives`) over the named axes of a `Mesh` (`mesh`): frame (data), tile
and gaussian sharding of the render and the training state (`shard`,
`sharded_trainer`), and the multi-process start-up (`distributed`).
"""

from omfs4d_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    GAUSS_AXIS,
    TILE_AXIS,
    Mesh,
    get_mesh,
    make_mesh,
    replicate,
    set_mesh,
    shard_batch,
    shard_frames,
)
