"""Explicit collectives over a `Mesh` axis, and their transposes for autograd.

The counterparts of `lax.psum / pmean / pmin / pmax / all_gather /
all_to_all` inside a JAX `shard_map` (`lax.axis_index` is
`Mesh.axis_index`), where XLA transposes each collective for the gradient.
Here every transpose is written down, derived from one rule: **the global
loss is computed once**.  Every rank computes the same replicated loss after
the collectives that build it, so

  * `all_gather` transposes to this rank's slice of the cotangent (the ranks
    hold the same cotangent; summing it over the axis would count the loss
    n times);
  * `all_to_all` transposes to the `all_to_all` back;
  * `psum` / `pmean` of per-rank partials transpose to the cotangent (/ n);
  * `pmin` / `pmax` carry no gradient;
  * a *replicated input* used by every rank for its own part of the loss
    (JAX's `P()` spec) transposes to the sum of the ranks' cotangents:
    `replicated` is the identity forward and an all-reduce backward.  A
    slice of a replicated input (JAX's `P(axis)` on a replicated array) is
    `replicated(x)[rows]`.

Every tensor goes to the backend as it is: gloo takes CUDA tensors for each
collective used here (it copies them through the host itself).  With no
process group, or an axis of size 1, every collective is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from omfs4d_torch.parallel.mesh import Mesh

OPS = ("all_reduce", "all_gather", "all_to_all", "broadcast", "barrier")

#: bytes each collective moved from this rank, and its calls
traffic: dict[str, int] = {op: 0 for op in OPS}
calls: dict[str, int] = {op: 0 for op in OPS}

#: (the default group, the world group with `STAGE_TIMEOUT_S`) of the
#: current process group: see `wait_group`
_WAIT: list = [None, None]
STAGE_TIMEOUT_S = 24 * 3600.0


def _count(op: str, t: torch.Tensor) -> None:
    calls[op] += 1
    traffic[op] += t.numel() * t.element_size()


def reset_counters() -> None:
    for d in (traffic, calls):
        for op in OPS:
            d[op] = 0


def make_wait_group(timeout_s: float = STAGE_TIMEOUT_S) -> None:
    """Make the world group on which ranks wait while one rank works alone
    (a stage's files, a whole training run): its timeout is a stage's, not a
    collective's.  Every rank calls it once, after joining the group."""
    import datetime

    _WAIT[:] = [dist.group.WORLD,
                dist.new_group(timeout=datetime.timedelta(seconds=timeout_s))]


def wait_group():
    """The group of `make_wait_group` for the current process group; None
    (the default group) when it was not made."""
    return _WAIT[1] if _WAIT[0] is not None and _WAIT[0] is dist.group.WORLD else None


# ── plain collectives (no autograd) ─────────────────────────────────────


def all_reduce_(t: torch.Tensor, mesh: Mesh, axis: str | None,
                op: str = "sum") -> torch.Tensor:
    """In place over `axis`; op "sum", "min", "max" or "mean"."""
    group, members = mesh.group(axis)
    if group is None:
        return t
    red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
           "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op]
    _count("all_reduce", t)
    dist.all_reduce(t, red, group=group)
    if op == "mean":
        t.div_(len(members))
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    """(n, *t.shape): every rank's `t`, in axis order."""
    group, members = mesh.group(axis)
    t = t.contiguous()
    if group is None:
        return t[None].clone()
    _count("all_gather", t)
    parts = [torch.empty_like(t) for _ in members]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def all_to_all(t: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    """`t` (n, ...) -> (n, ...): row i of the result is row `index` of rank
    i's `t` (JAX's `all_to_all(split_axis=0, concat_axis=0, tiled=False)`)."""
    group, members = mesh.group(axis)
    if t.shape[0] != len(members):
        raise ValueError(f"all_to_all: {t.shape[0]} rows for {len(members)} ranks")
    t = t.contiguous()
    if group is None:
        return t.clone()
    _count("all_to_all", t)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def broadcast_(t: torch.Tensor, mesh: Mesh, axis: str | None = None) -> torch.Tensor:
    """In place, from the first rank of this rank's row along `axis`."""
    group, members = mesh.group(axis)
    if group is None:
        return t
    _count("broadcast", t)
    dist.broadcast(t, members[0], group=group)
    return t


def barrier(mesh: Mesh | None = None, axis: str | None = None) -> None:
    """Wait for every rank of the mesh, or with no mesh of the world, on
    `wait_group` (a stage's timeout: one rank may be training alone)."""
    if mesh is None:
        if dist.is_initialized() and dist.get_world_size() > 1:
            calls["barrier"] += 1
            dist.barrier(group=wait_group())
        return
    group, _ = mesh.group(axis)
    if group is not None:
        calls["barrier"] += 1
        dist.barrier(group=group)


def pmin(x: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    return all_reduce_(x.detach().clone(), mesh, axis, "min")


def pmax(x: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    return all_reduce_(x.detach().clone(), mesh, axis, "max")


# ── collectives with their transposes ───────────────────────────────────


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.mesh.axis_index(ctx.axis)], None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.mesh, ctx.axis), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, mean):
        ctx.scale = 1.0 / mesh.axis_size(axis) if mean else 1.0
        return all_reduce_(x.detach().clone(), mesh, axis, "mean" if mean else "sum")

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None, None


class _Replicated(torch.autograd.Function):
    """Identity forward; backward all-reduces every cotangent (zeros for
    the unused) in one flat buffer."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=d, device=dev) if g is None else g
              for g, (s, d, dev) in zip(gs, ctx.shapes)]
        if ctx.mesh.group(ctx.axis)[0] is None:
            return (None, None, *gs)
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in gs])
        all_reduce_(flat, ctx.mesh, ctx.axis, "sum")
        out, at = [], 0
        for g in gs:
            out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
            at += g.numel()
        return (None, None, *out)


class _HaloPrev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        i = mesh.axis_index(axis)
        rows = all_gather(x, mesh, axis)
        return rows[i - 1] if i > 0 else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        i, n = ctx.mesh.axis_index(ctx.axis), ctx.mesh.axis_size(ctx.axis)
        rows = all_gather(g, ctx.mesh, ctx.axis)
        return (rows[i + 1] if i + 1 < n else torch.zeros_like(g)), None, None


def all_gather_grad(x: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    """`all_gather` whose cotangent is this rank's slice."""
    return _AllGather.apply(x, mesh, axis)


def all_to_all_grad(x: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    """`all_to_all` whose cotangent rides the `all_to_all` back."""
    return _AllToAll.apply(x, mesh, axis)


def psum(x: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    """The sum of the ranks' partials; the cotangent passes through."""
    return _Psum.apply(x, mesh, axis, False)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    """The mean of the ranks' partials; the cotangent divided by n."""
    return _Psum.apply(x, mesh, axis, True)


def replicated(mesh: Mesh, axis: str | None, *xs: torch.Tensor) -> tuple:
    """Mark replicated inputs: each rank uses them for its own part of the
    loss, so their gradient is the sum of the ranks' cotangents (one
    all-reduce for all of them)."""
    if not any(x.requires_grad for x in xs) or not torch.is_grad_enabled():
        return xs
    return _Replicated.apply(mesh, axis, *xs)


def halo_prev(x: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    """The previous rank's `x` along `axis` (zeros on the first rank): the
    one-frame halo of a temporal term.  The cotangent goes back to it."""
    return _HaloPrev.apply(x, mesh, axis)


def joined(loss: torch.Tensor, *tensors: torch.Tensor) -> torch.Tensor:
    """`loss` + 0 * (an element of each tensor): keeps this rank in the
    backward collectives that produced `tensors` when its own terms did not
    use them (every rank of a group must join each of its collectives)."""
    return loss + 0.0 * sum(t.reshape(-1)[0] for t in tensors if t.numel())
