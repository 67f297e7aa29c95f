"""Multi-process harness of the port's parallel tests, on the CPU.

`World(n, tmp).run(*scenarios)` starts n processes of this file, which join
one gloo process group over localhost (a free port) and run the named
scenarios in order; each scenario reads its inputs from `<tmp>/<name>.npz`
(written by the test, from the JAX side) and writes `<tmp>/<name>_<rank>.npz`.
The workers import torch and the port only, one thread each; the test
process runs the JAX reference meanwhile and then `wait()`s for them.

The scenarios are the functions of `SCENARIOS` below; the tests that read
their results are in `test_torch_parallel_*.py`.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """n worker processes running scenarios; `wait()` returns their
    results by scenario, then by rank."""

    def __init__(self, n: int, tmp: Path):
        self.n, self.tmp = n, Path(tmp)
        self.procs: list = []
        self.names: list[str] = []

    def run(self, *names: str, env: dict | None = None) -> "World":
        self.names = list(names)
        port = free_port()
        full_env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                    "PYTHONPATH": str(ROOT), **(env or {})}
        for rank in range(self.n):
            cmd = [sys.executable, str(Path(__file__).resolve()), str(rank), str(self.n),
                   str(port), str(self.tmp), *names]
            self.procs.append(subprocess.Popen(cmd, cwd=ROOT, env=full_env,
                                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                               text=True))
        return self

    def wait(self) -> dict:
        deadline = time.time() + TIMEOUT_S
        logs = []
        for p in self.procs:
            try:
                logs.append(p.communicate(timeout=max(deadline - time.time(), 1))[0])
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                tails = [q.communicate()[0][-3000:] for q in self.procs]
                raise AssertionError(f"workers did not finish in {TIMEOUT_S} s:\n"
                                     + "\n".join(tails))
        bad = [(r, p.returncode, log[-4000:]) for r, (p, log) in
               enumerate(zip(self.procs, logs)) if p.returncode != 0]
        assert not bad, "\n".join(f"rank {r} exit {rc}:\n{log}" for r, rc, log in bad)
        out = {}
        for name in self.names:
            out[name] = []
            for r in range(self.n):
                f = self.tmp / f"{name}_{r}.npz"
                out[name].append(dict(np.load(f, allow_pickle=False)) if f.exists() else None)
        return out


def save(tmp: Path, name: str, **arrays) -> None:
    np.savez(Path(tmp) / f"{name}.npz", **arrays)


# ── worker side ─────────────────────────────────────────────


def _load(tmp: Path, name: str) -> dict:
    f = tmp / f"{name}.npz"
    return dict(np.load(f, allow_pickle=False)) if f.exists() else {}


def _t(a, dtype=None):
    import torch

    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _np(t):
    """A copy: the trainers update their tensors in place."""
    return t.detach().cpu().numpy().copy()


def _scene(inp):
    import torch

    from omfs4d_torch.ops.camera import Camera

    f32 = torch.float32
    args = tuple(_t(inp[k], f32) for k in ("means", "rot", "scales", "opacity", "colors"))
    S = int(inp["size"])
    cam = Camera(w2c=_t(inp["w2c"], f32), fx=_t(inp["fx"], f32), fy=_t(inp["fy"], f32),
                 cx=_t(inp["cx"], f32), cy=_t(inp["cy"], f32), width=S, height=S)
    return args, cam, S


def sc_tile_render(tmp, rank, mesh_of):
    """The tile-sharded rasterizer on every rank, and the one-process one."""
    from omfs4d_torch.parallel.shard import rasterize_tile_sharded
    from omfs4d_torch.render.rasterize import rasterize

    inp = _load(tmp, "tile_render")
    args, cam, S = _scene(inp)
    mesh = mesh_of(("tile",))
    K = int(inp["max_per_tile"])
    img, aux = rasterize_tile_sharded(*args, cam, S, S, mesh=mesh, max_per_tile=K)
    one, aux1 = rasterize(*args, cam, S, S, max_per_tile=K, max_tiles_per_gaussian=36)
    return {"img": _np(img), "alpha": _np(aux["alpha"]), "one": _np(one),
            "one_alpha": _np(aux1["alpha"])}


def sc_gauss_render(tmp, rank, mesh_of):
    """The gaussian-sharded rasterizer, each rank with N/n of the scene."""
    from omfs4d_torch.parallel.shard import render_gaussian_sharded

    inp = _load(tmp, "gauss_render")
    args, cam, S = _scene(inp)
    mesh = mesh_of(("gauss",))
    n, i = mesh.axis_size("gauss"), mesh.axis_index("gauss")
    per = args[0].shape[0] // n
    mine = [a[i * per:(i + 1) * per] for a in args]
    img, aux = render_gaussian_sharded(*mine, cam, S, S, mesh=mesh,
                                       max_per_tile=int(inp["max_per_tile"]))
    return {"img": _np(img), "alpha": _np(aux["alpha"]), "overflow": _np(aux["overflow"])}


def sc_gauss_grads(tmp, rank, mesh_of):
    """d(sum img^2)/d(colors, opacity) through the gaussian-sharded render,
    and through the one-process one."""
    import torch

    from omfs4d_torch.parallel.shard import render_gaussian_sharded
    from omfs4d_torch.render.rasterize import rasterize

    inp = _load(tmp, "gauss_grads")
    (means, rot, scales, opac, cols), cam, S = _scene(inp)
    mesh = mesh_of(("gauss",))
    n, i = mesh.axis_size("gauss"), mesh.axis_index("gauss")
    per = means.shape[0] // n
    sl = slice(i * per, (i + 1) * per)
    K = int(inp["max_per_tile"])
    c, o = cols[sl].clone().requires_grad_(), opac[sl].clone().requires_grad_()
    img, _ = render_gaussian_sharded(means[sl], rot[sl], scales[sl], o, c, cam, S, S,
                                     mesh=mesh, max_per_tile=K)
    gc, go = torch.autograd.grad((img ** 2).sum(), [c, o])
    c1, o1 = cols.clone().requires_grad_(), opac.clone().requires_grad_()
    img1, _ = rasterize(means, rot, scales, o1, c1, cam, S, S, max_per_tile=K,
                        max_tiles_per_gaussian=36)
    gc1, go1 = torch.autograd.grad((img1 ** 2).sum(), [c1, o1])
    return {"gc": _np(gc), "go": _np(go), "gc_one": _np(gc1[sl]), "go_one": _np(go1[sl])}


def _avatar_inputs(inp):
    import torch

    from omfs4d_torch.ops.camera import Camera
    from omfs4d_torch.parallel.shard import GaussianFields

    f32 = torch.float32
    g = GaussianFields(**{k: _t(inp["g_" + k]) for k in GaussianFields._fields})
    S = int(inp["size"])
    cam = Camera(w2c=_t(inp["w2c"], f32), fx=_t(inp["fx"], f32), fy=_t(inp["fy"], f32),
                 cx=_t(inp["cx"], f32), cy=_t(inp["cy"], f32), width=S, height=S)
    return g, _t(inp["verts"], f32), _t(inp["faces"]), cam, _t(inp["gt"], f32), S


FLOATS = ("mu_local", "quat_local", "log_scale", "opacity_logit", "color", "sh")


def sc_avatar_loss(tmp, rank, mesh_of):
    """avatar_loss_gaussian_sharded's loss and gradients (every float field
    and verts), and the one-process loss's, at each K of the inputs."""
    import torch

    from omfs4d_torch.models.gaussians import bind_to_mesh, eval_colors
    from omfs4d_torch.parallel.shard import avatar_loss_gaussian_sharded, fields_of
    from omfs4d_torch.render.rasterize import rasterize

    inp = _load(tmp, "avatar_loss")
    g, verts, faces, cam, gt, S = _avatar_inputs(inp)
    mesh = mesh_of(("gauss",))
    n, i = mesh.axis_size("gauss"), mesh.axis_index("gauss")
    per = g.mu_local.shape[0] // n
    sl = slice(i * per, (i + 1) * per)
    out = {}
    for K in np.atleast_1d(inp["max_per_tile"]):
        K = int(K)
        fl = {k: getattr(g, k)[sl].clone().requires_grad_() for k in FLOATS}
        v = verts.clone().requires_grad_()
        gl = fields_of(g._replace(parent_face=g.parent_face[sl], alive=g.alive[sl]), fl)
        loss = avatar_loss_gaussian_sharded(gl, v, faces, cam, gt, mesh=mesh, max_per_tile=K)
        grads = torch.autograd.grad(loss, list(fl.values()) + [v])
        out[f"loss_{K}"] = _np(loss)
        for k, gr in zip(list(FLOATS) + ["verts"], grads):
            out[f"{k}_{K}"] = _np(gr)
        # the one-process loss on the same cloud
        fl1 = {k: getattr(g, k).clone().requires_grad_() for k in FLOATS}
        v1 = verts.clone().requires_grad_()
        g1 = fields_of(g, fl1)
        means, rot, scales, opac, _ = bind_to_mesh(g1, v1, faces)
        img, aux = rasterize(means, rot, scales, opac, eval_colors(g1, means, cam.position),
                             cam, S, S, max_per_tile=K)
        loss1 = torch.mean(torch.abs(img - gt))
        grads1 = torch.autograd.grad(loss1, list(fl1.values()) + [v1])
        out[f"one_loss_{K}"] = _np(loss1)
        out[f"one_overflow_{K}"] = _np(aux["overflow"])
        for k, gr in zip(list(FLOATS) + ["verts"], grads1):
            out[f"one_{k}_{K}"] = _np(gr if k == "verts" else gr[sl])
    return out


# ── trainers ────────────────────────────────────────────────

GAUSS_FIELDS = ("parent_face",) + FLOATS + ("alive",)


def _train_inputs(tmp, name):
    """(inputs, data dict of tensors, faces, g0 or None)."""
    from omfs4d_torch.models.gaussians import GaussianAvatar

    inp = _load(tmp, name)
    data = {k[5:]: _t(v) for k, v in inp.items() if k.startswith("data_")}
    g0 = (GaussianAvatar(**{k: inp["g0_" + k] for k in GAUSS_FIELDS})
          if "g0_mu_local" in inp else None)
    return inp, data, inp["faces"], g0


def _cfg(inp, **kw):
    import json

    from omfs4d_torch.core.config import TrainConfig

    return TrainConfig(**{**json.loads(str(inp["cfg"])), **kw})


def _sharded(inp, faces, mesh_of, shape=None, axes=("gauss",), cfg=None, **kw):
    from omfs4d_torch.parallel.sharded_trainer import ShardedAvatarTrainer

    S = int(inp["size"])
    mesh = mesh_of(axes, shape)
    return ShardedAvatarTrainer(faces, cfg or _cfg(inp), S, S, mesh=mesh,
                                max_per_tile=int(inp["max_per_tile"]), device="cpu", **kw)


def _gathered(tr, state) -> dict:
    from omfs4d_torch.convert import gathered_state_to_numpy

    g = gathered_state_to_numpy(tr, state)["gaussians"]
    return {"g_" + k: v for k, v in g.items()}


def sc_sharded_curve(tmp, rank, mesh_of):
    """8 steps of the sharded trainer on frame 0, then a densify event with
    every accumulator at 1 and one more step."""
    import torch

    inp, data, faces, g0 = _train_inputs(tmp, "sharded_curve")
    tr = _sharded(inp, faces, mesh_of)
    st = tr.init_state(gaussians=g0)
    losses = []
    for _ in range(8):
        st, m = tr.step(st, data, 0)
        losses.append(float(m["loss"]))
    st = st._replace(grad_accum=torch.ones_like(st.grad_accum),
                     grad_count=torch.ones_like(st.grad_count))
    before = int(tr.gather_rows(st.gaussians.alive).sum())
    max_new = max(st.gaussians.capacity // 16, 1)
    st = tr.densify(st, tr.densify_noise(1, 0, max_new))
    after = int(tr.gather_rows(st.gaussians.alive).sum())
    st, m = tr.step(st, data, 0)
    return {"losses": np.asarray(losses), "alive": np.asarray([before, after]),
            "loss_after": np.asarray(float(m["loss"])), "local": st.gaussians.capacity}


def sc_sharded_densify(tmp, rank, mesh_of):
    """One per-shard densify event on the seeded cloud, with JAX's noise of
    this shard and the inputs' accumulators."""
    inp, data, faces, g0 = _train_inputs(tmp, "sharded_densify")
    tr = _sharded(inp, faces, mesh_of)
    st = tr.init_state(gaussians=g0)
    st = st._replace(grad_accum=tr.shard_rows(_t(inp["accum"])),
                     grad_count=tr.shard_rows(_t(inp["count"])))
    st = tr.densify(st, _t(inp["noise"][tr.shard]))
    return {**_gathered(tr, st), "grad_count": _np(tr.gather_rows(st.grad_count))}


def sc_sharded_reset(tmp, rank, mesh_of):
    """12 steps with an opacity reset after every 4th."""
    inp, data, faces, g0 = _train_inputs(tmp, "sharded_reset")
    tr = _sharded(inp, faces, mesh_of)
    st = tr.init_state(gaussians=g0)
    losses = []
    for it in range(1, 13):
        st, m = tr.step(st, data, 0)
        losses.append(float(m["loss"]))
        if it % 4 == 0:
            st = tr.reset_opacity(st)
    return {"losses": np.asarray(losses)}


def sc_sharded_compact_rows(tmp, rank, mesh_of):
    """Two steps, a scattered two-thirds killed, then compact_to_alive."""
    import torch

    inp, data, faces, g0 = _train_inputs(tmp, "sharded_compact")
    tr = _sharded(inp, faces, mesh_of)
    tr.COMPACT_MULTIPLE = 128
    st = tr.init_state(gaussians=g0)
    for _ in range(2):
        st, _ = tr.step(st, data, 0)
    with torch.no_grad():
        st.gaussians.alive.copy_(tr.shard_rows(_t(inp["alive"]).bool()))
    keep = np.flatnonzero(_np(st.gaussians.alive))
    before = {k: _np(v)[keep] for k, v in (("mu", st.gaussians.mu_local),
                                           ("nu", st.opt_state["pos"]["nu"]["mu_local"]))}
    cs = tr.compact_to_alive(st)
    n = len(keep)
    return {"mu_before": before["mu"], "nu_before": before["nu"],
            "mu_after": _np(cs.gaussians.mu_local)[:n],
            "nu_after": _np(cs.opt_state["pos"]["nu"]["mu_local"])[:n],
            "alive_after": _np(cs.gaussians.alive), "local_after": np.asarray(
                cs.gaussians.capacity), "n_keep": np.asarray(n)}


def sc_sharded_cycle(tmp, rank, mesh_of):
    """60 iterations with densify, opacity resets and checkpoints; then a
    resume from iteration 30 replayed to 60; then a reset's moment surgery."""
    import shutil

    inp, data, faces, g0 = _train_inputs(tmp, "sharded_cycle")
    out = tmp / "sharded_cycle_run"
    tr_a = _sharded(inp, faces, mesh_of)
    full = tr_a.train(data, iterations=60, state=tr_a.init_state(gaussians=g0),
                      output_dir=out, rng_seed=7, log_every=1000)
    tr_b = _sharded(inp, faces, mesh_of)
    tmpl = tr_b.init_state(gaussians=g0)
    has_meta = (out / "checkpoints" / "iter_0000030_meta.json").exists()
    from omfs4d_torch.parallel import collectives as C

    C.barrier(tr_b.mesh)
    if rank == 0:
        shutil.rmtree(out / "checkpoints" / "iter_0000060")
    C.barrier(tr_b.mesh)
    res, it = tr_b.restore_checkpoint(out, template=tmpl)
    res = tr_b.train(data, iterations=60, state=res, rng_seed=7, log_every=1000,
                     start_iteration=30)
    res_opac_nu = _np(res.opt_state["opac"]["nu"]["opacity_logit"])
    pos_nu = _np(res.opt_state["pos"]["nu"]["mu_local"])
    res_opac = _np(res.gaussians.opacity_logit)
    s2 = tr_b.reset_opacity(res)
    return {"has_meta": np.asarray(has_meta), "it": np.asarray(it),
            "full_mu": _np(full.gaussians.mu_local), "res_mu": _np(res.gaussians.mu_local),
            "full_opac": _np(full.gaussians.opacity_logit),
            "res_opac": res_opac,
            "full_alive": _np(full.gaussians.alive), "res_alive": _np(res.gaussians.alive),
            "steps": np.asarray([int(full.step), int(res.step)]),
            "opac_nu_before": res_opac_nu,
            "opac_nu_after": _np(s2.opt_state["opac"]["nu"]["opacity_logit"]),
            "pos_nu_before": pos_nu, "pos_nu_after": _np(s2.opt_state["pos"]["nu"]["mu_local"])}


def sc_sharded_chunked(tmp, rank, mesh_of):
    """train() for 60 iterations against per-step calls on the same host
    stream of frame indices."""
    inp, data, faces, g0 = _train_inputs(tmp, "sharded_chunked")
    tr_a = _sharded(inp, faces, mesh_of)
    sa = tr_a.train(data, iterations=60, state=tr_a.init_state(gaussians=g0), rng_seed=5,
                    log_every=100)
    tr_b = _sharded(inp, faces, mesh_of)
    tr_b.preflight_tile_window(tr_b.init_state(gaussians=g0), data)
    sb = tr_b.init_state(gaussians=g0)
    rng = np.random.default_rng(5)
    for _ in range(60):
        sb, _ = tr_b.step(sb, data, int(rng.integers(0, 2)))
    return {"a_mu": _np(sa.gaussians.mu_local), "b_mu": _np(sb.gaussians.mu_local),
            "a_color": _np(sa.gaussians.color), "b_color": _np(sb.gaussians.color),
            "steps": np.asarray([int(sa.step), int(sb.step)])}


def _state_bytes(state) -> np.ndarray:
    """Every tensor of a replicated state, as one byte string."""
    from omfs4d_torch.train.checkpoints import state_to_dict

    parts = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif x is not None:
            parts.append(_np(x).tobytes())

    walk(state_to_dict(state))
    return np.frombuffer(b"".join(parts), dtype=np.uint8)


def _with_cloud(state, g0):
    """`state` with the cloud `g0` in place of its seeded one."""
    from omfs4d_torch.train.trainer import init_opt_state

    return state._replace(gaussians=g0, opt_state=init_opt_state(g0))


def sc_frame_dp(tmp, rank, mesh_of):
    """AvatarTrainer(mesh=) on B frames split over the ranks: 4 steps."""
    from omfs4d_torch.train.trainer import AvatarTrainer

    inp, data, faces, g0 = _train_inputs(tmp, "frame_dp")
    S, B = int(inp["size"]), int(inp["batch"])
    tr = AvatarTrainer(faces, _cfg(inp), S, S, max_per_tile=int(inp["max_per_tile"]),
                       mesh=mesh_of(("data",)), device="cpu")
    st = _with_cloud(tr.init_state(capacity=g0.capacity), g0)
    losses = []
    for _ in range(int(inp["steps"])):
        st, m = tr.train_step(st, data, list(range(B)))
        losses.append(float(m["loss"]))
    return {"losses": np.asarray(losses), "color": _np(st.gaussians.color),
            "state_bytes": _state_bytes(st)}


def sc_frame_dp_pair(tmp, rank, mesh_of):
    """One frame-DP step on a mesh of ranks 0 and 1 (the others stay out)."""
    from omfs4d_torch.parallel.mesh import Mesh
    from omfs4d_torch.train.trainer import AvatarTrainer

    inp, data, faces, g0 = _train_inputs(tmp, "frame_dp_pair")
    mesh = Mesh(np.arange(2), ("data",))
    if not mesh.contains():
        return None
    S = int(inp["size"])
    tr = AvatarTrainer(faces, _cfg(inp), S, S, max_per_tile=int(inp["max_per_tile"]),
                       mesh=mesh, device="cpu")
    st = _with_cloud(tr.init_state(capacity=g0.capacity), g0)
    st, m = tr.train_step(st, data, [0, 1])
    return {"loss": np.asarray(float(m["loss"])), "color": _np(st.gaussians.color)}


def sc_mesh_2d(tmp, rank, mesh_of):
    """The (data x gauss) trainer: 4 steps on B = 2 frames, then FLAME
    co-optimization from a wrong jaw for 25 steps."""
    inp, data, faces, g0 = _train_inputs(tmp, "mesh_2d")
    idx = [0, 1]
    tr = _sharded(inp, faces, mesh_of, shape=(2, 2), axes=("data", "gauss"), data_axis="data")
    st = tr.init_state(gaussians=g0)
    losses = []
    for _ in range(4):
        st, m = tr.step(st, data, idx)
        losses.append(float(m["loss"]))
    from omfs4d_torch.convert import flame_model_from_numpy

    model = flame_model_from_numpy({k[6:]: v for k, v in inp.items() if k.startswith("flame_")})
    tr_f = _sharded(inp, faces, mesh_of, shape=(2, 2), axes=("data", "gauss"),
                    cfg=_cfg(inp, optimize_flame=True, lr_flame_pose=2e-3),
                    data_axis="data", flame_model=model)
    wrong = {k[6:]: v for k, v in inp.items() if k.startswith("wrong_")}
    sf = tr_f.init_state(gaussians=g0, flame_params=wrong)
    for _ in range(25):
        sf, mf = tr_f.step(sf, data, idx)
    return {"losses": np.asarray(losses), "jaw": _np(sf.flame_params["jaw_pose"]),
            "loss_f": np.asarray(float(mf["loss"])), "state_bytes": _state_bytes(sf)}


def sc_checkpoints(tmp, rank, mesh_of):
    """A sharded checkpoint read by the one-process trainer, a one-process
    checkpoint read by the sharded trainer, and the JAX package's state
    (carried over by convert.py, written in the port's format) sharded."""
    from omfs4d_torch.parallel import collectives as C
    from omfs4d_torch.train.checkpoints import restore_state
    from omfs4d_torch.train.trainer import AvatarTrainer

    inp, data, faces, g0 = _train_inputs(tmp, "checkpoints")
    S = int(inp["size"])
    tr = _sharded(inp, faces, mesh_of)
    st = tr.init_state(gaussians=g0)
    for _ in range(3):
        st, _ = tr.step(st, data, 0)
    sharded_dir = tmp / "ckpt_sharded"
    tr.save_checkpoint(st, sharded_dir, 3)
    whole = _gathered(tr, st)
    out = {**{"sharded_" + k: v for k, v in whole.items()}}
    one = AvatarTrainer(faces, _cfg(inp), S, S, max_per_tile=int(inp["max_per_tile"]),
                        device="cpu")
    if rank == 0:
        # the one-process trainer reads the sharded trainer's checkpoint...
        back, it = one.restore_checkpoint(sharded_dir, template=one.init_state(capacity=1024))
        out["one_read_it"] = np.asarray(it)
        out.update({"one_read_" + k: _np(getattr(back.gaussians, k)) for k in GAUSS_FIELDS})
        # ...and writes one of its own, one step further
        back, _ = one.train_step(back, data, [0])
        one.save_checkpoint(back, tmp / "ckpt_one", 4)
        out.update({"one_wrote_" + k: _np(getattr(back.gaussians, k)) for k in GAUSS_FIELDS})
    C.barrier(tr.mesh)
    tr2 = _sharded(inp, faces, mesh_of)
    res, it = tr2.restore_checkpoint(tmp / "ckpt_one", template=tr2.init_state(gaussians=g0))
    out["sharded_read_it"] = np.asarray(it)
    out.update({"sharded_read_" + k: v for k, v in _gathered(tr2, res).items()})
    # the JAX package's sharded state, carried over and sharded
    jax_state = restore_state(tmp / "ckpt_jax", device="cpu")
    tr3 = _sharded(inp, faces, mesh_of)
    local = tr3.shard_state(jax_state)
    out.update({"jax_local_mu": _np(local.gaussians.mu_local),
                "jax_local_nu": _np(local.opt_state["pos"]["nu"]["mu_local"])})
    local, m = tr3.step(local, data, 0)
    out["jax_step_loss"] = np.asarray(float(m["loss"]))
    return out


# ── tracker and pipeline ────────────────────────────────────


def _track_config(inp, **kw):
    import json

    from omfs4d_torch.core.config import TrackConfig

    return TrackConfig(**{**json.loads(str(inp["track_cfg"])), **kw})


def sc_track_stages(tmp, rank, mesh_of):
    """A landmark stage and an rgb stage of FlameTracker(mesh=) against the
    same stages without a mesh, from the same parameters."""
    from omfs4d_torch.convert import flame_model_from_numpy
    from omfs4d_torch.core.logging import EventLogger
    from omfs4d_torch.ops.camera import Camera
    from omfs4d_torch.track.fitter import FlameTracker

    inp = _load(tmp, "track_stages")
    model = flame_model_from_numpy({k[6:]: v for k, v in inp.items() if k.startswith("flame_")})
    S = int(inp["size"])
    cam = Camera(w2c=_t(inp["w2c"]), fx=_t(inp["fx"]), fy=_t(inp["fy"]), cx=_t(inp["cx"]),
                 cy=_t(inp["cy"]), width=S, height=S)
    cfg = _track_config(inp)
    out = {}
    for name, mesh in (("sharded", mesh_of(("data",))), ("one", None)):
        tr = FlameTracker(model, cfg, cam, (S, S), max_per_tile=64, mesh=mesh, device="cpu")
        T = len(inp["landmarks"])
        data = {"landmarks": _t(inp["landmarks"]), "valid": _t(inp["valid"]),
                "frames": tr._prep_frames(inp["frames"])}
        ev = EventLogger()
        losses = []
        ev.emit = lambda event, **f: losses.append(f["loss"])
        p = tr._run_stage("lmk_init_all", tr.init_params(T), 40,
                          ("shape", "expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose",
                           "translation"), 1.0, 0.0, data, ev)
        p = tr._run_stage("rgb_init_all", p, 10,
                          ("shape", "expr", "rotation", "jaw_pose", "translation", "texture",
                           "dynamic_offset"), 0.3, 1.0, data, ev)
        out[name + "_losses"] = np.asarray(losses)
        for k, v in p.items():
            out[f"{name}_{k}"] = _np(v)
        if mesh is not None:
            out["state_bytes"] = np.frombuffer(b"".join(_np(p[k]).tobytes() for k in sorted(p)),
                                               np.uint8)
    return out


def _pipeline(inp, workdir, **parallel):
    from omfs4d_torch.core.config import Config
    from omfs4d_torch.pipeline.runner import Pipeline

    cfg = Config()
    cfg.pipeline.min_train_frames = 2
    cfg.pipeline.matting = "none"
    cfg.train.max_gaussians = 4096
    cfg.train.sh_degree = 1
    cfg.render.max_per_tile = 128
    cfg.track = _track_config(inp)
    for k, v in parallel.items():
        setattr(cfg.parallel, k, v)
    pipe = Pipeline(cfg, workdir, device="cpu")
    pipe.model = _small_model()
    return pipe


def _small_model():
    """The 700-vertex FLAME asset of the pipeline tests."""
    from omfs4d_torch.models.assets import synthetic_flame_asset
    from omfs4d_torch.models.flame import FlameModel

    return FlameModel.from_asset(synthetic_flame_asset(n_vertices=700, seed=0))


class _Writes:
    """The paths this process writes under `root` while in the `with`
    block (an audit hook: files opened for writing, renames, new
    directories, removals)."""

    hooked = False
    active: "_Writes | None" = None

    def __init__(self, root: Path):
        self.root, self.paths = str(root), []
        if not _Writes.hooked:
            sys.addaudithook(_Writes._hook)
            _Writes.hooked = True

    def __enter__(self):
        _Writes.active = self
        return self

    def __exit__(self, *exc):
        _Writes.active = None

    @staticmethod
    def _hook(event, args):
        self = _Writes.active
        if self is None or event not in ("open", "os.rename", "os.mkdir", "os.remove"):
            return
        if event == "open":
            flags = args[2] if isinstance(args[2], int) else 0
            if not flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND):
                return
        path = args[0]
        if isinstance(path, (str, bytes, os.PathLike)) and os.fsdecode(path).startswith(self.root):
            self.paths.append(f"{event} {os.fsdecode(path)}")


def sc_pipeline(tmp, rank, mesh_of):
    """Every sharded branch of the runner on a world of 2: track with
    parallel.n_data = 2, train with n_gauss = 2 and with n_data = 2, the
    RuntimeError of n_data x n_gauss = 2x2, train with only n_tile = 2 (no
    training mesh: rank 0 trains alone; the paths each rank wrote), and
    render_surgery with n_tile = 2."""
    from omfs4d_torch.io.dataset import FrameDataset

    inp = _load(tmp, "pipeline")
    data_dir, frames_dir = tmp / "data", tmp / "frames"
    cam = FrameDataset(data_dir).camera(0)
    out = {}
    pipe = _pipeline(inp, tmp / "work_track", n_data=2)
    ds_dir = pipe.track(frames_dir, cam, landmark_method="file")
    out["track_dir"] = np.asarray(str(ds_dir))
    for name, par in (("gauss", {"n_gauss": 2}), ("data", {"n_data": 2})):
        pipe = _pipeline(inp, tmp / f"work_{name}", **par)
        model_dir = pipe.train(data_dir, tmp / f"model_{name}", iterations=6)
        out[f"model_{name}"] = np.asarray(str(model_dir))
    try:
        _pipeline(inp, tmp / "work_both", n_gauss=2, n_data=2).train(
            data_dir, tmp / "model_both", iterations=2)
        out["both_error"] = np.asarray("")
    except RuntimeError as e:
        out["both_error"] = np.asarray(str(e))
    pipe = _pipeline(inp, tmp / "work_render", n_tile=2)
    with _Writes(tmp / "model_tile") as writes:
        pipe.train(data_dir, tmp / "model_tile", iterations=4)
    out["tile_train_writes"] = np.asarray(writes.paths, dtype=str)
    res = pipe.render_surgery(tmp / "model_gauss", data_dir, tmp / "pred.mp4", 5.0, 3.0)
    out["renders_dir"] = np.asarray(res["renders_dir"])
    return out


def sc_cli_train(tmp, rank, mesh_of):
    """The port's CLI started as `torchrun` starts it (the environment of a
    world of 2): `train ... parallel.n_gauss=2` joins the group itself."""
    from omfs4d_torch.models import assets
    from omfs4d_torch.pipeline import cli, runner

    real = assets.synthetic_flame_asset
    runner.synthetic_flame_asset = lambda: real(n_vertices=700, seed=0)
    assert cli.main(["train", "--data", str(tmp / "data"), "--out", str(tmp / "model_cli"),
                     "--iterations", "4", "--device", "cpu", "--workdir",
                     str(tmp / "work_cli"), "parallel.n_gauss=2", "train.max_gaussians=4096",
                     "train.sh_degree=1", "pipeline.min_train_frames=2",
                     "render.max_per_tile=128"]) == 0
    import torch.distributed as dist

    return {"world": np.asarray(dist.get_world_size()),
            "backend": np.asarray(dist.get_backend())}


def sc_collectives(tmp, rank, mesh_of):
    """Each collective and its transpose on 2 ranks, the mesh helpers, and
    an all-reduce of 1e5 random floats (its bits, for the equality of the
    replicas)."""
    import torch

    from omfs4d_torch.parallel import collectives as C
    from omfs4d_torch.parallel import mesh as M
    from omfs4d_torch.parallel.distributed import global_mesh, replicate_global

    mesh = global_mesh(("data",))
    r = float(rank + 1)
    x = torch.full((3,), r, requires_grad=True)
    out = {}
    gathered = C.all_gather_grad(x, mesh, "data")
    (gx,) = torch.autograd.grad((gathered * torch.arange(2.0)[:, None]).sum(), [x])
    out["gather"], out["gather_grad"] = _np(gathered), _np(gx)
    send = torch.stack([x * 10, x * 100])
    recv = C.all_to_all_grad(send, mesh, "data")
    (gs,) = torch.autograd.grad((recv * torch.tensor([[1.0], [2.0]])).sum(), [x])
    out["a2a"], out["a2a_grad"] = _np(recv), _np(gs)
    (rep,) = C.replicated(mesh, "data", x)
    (gr,) = torch.autograd.grad((rep * r).sum(), [x])
    out["replicated_grad"] = _np(gr)
    for name, fn in (("psum", C.psum), ("pmean", C.pmean)):
        y = fn(x.sum(), mesh, "data")
        (gy,) = torch.autograd.grad(y, [x])
        out[name], out[name + "_grad"] = _np(y), _np(gy)
    out["pmin"] = _np(C.pmin(x.sum(), mesh, "data"))
    out["pmax"] = _np(C.pmax(x.sum(), mesh, "data"))
    prev = C.halo_prev(x * 2, mesh, "data")
    (gh,) = torch.autograd.grad(C.joined((prev * 3).sum(), prev), [x])
    out["halo"], out["halo_grad"] = _np(prev), _np(gh)
    out["shard_frames"] = _np(M.shard_frames(torch.arange(5.0), mesh))
    out["replicate"] = _np(replicate_global({"a": torch.full((2,), r)}, mesh)["a"])
    big = torch.from_numpy(np.random.default_rng(rank).normal(size=100_000).astype(np.float32))
    out["allreduce_bits"] = _np(C.all_reduce_(big, mesh, "data")).view(np.uint32)
    if rank == 0:
        # a mesh of one rank makes no group: its collectives are identities
        out["solo"] = _np(C.all_gather(x.detach(), M.Mesh(np.arange(1), ("solo",)), "solo"))
    out["grid"] = np.asarray([M.make_mesh(1, 2).axis_index("tile"),
                              M.make_mesh(2, 1).axis_index("data")])
    return out


# ── on a card ───────────────────────────────────────────────


def sc_card_composite_lists(tmp, rank, mesh_of):
    """On cuda:0, each rank's slab of two grids (30 tiles: the second slab's
    base is 15; 25 tiles: 13 + 12 tiles and one row of padding): K1 and K2
    through `composite_lists` against the plain version on the same inputs,
    and the tile-sharded composite against one K1 launch of the whole grid."""
    import torch

    from omfs4d_torch.ops.camera import look_at_camera, project_gaussians
    from omfs4d_torch.parallel.shard import composite_tile_sharded
    from omfs4d_torch.render import composite as tc
    from omfs4d_torch.render.rasterize import bin_gaussians

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_of(("tile",))
    rng = np.random.default_rng(0)
    out = {}
    for name, (W, H) in (("even", (96, 80)), ("padded", (80, 80))):
        n = 3000
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        from omfs4d_torch.models.gaussians import quat_to_matrix

        rot = quat_to_matrix(torch.tensor(q, dtype=torch.float32)).to(dev)
        cam = look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=1.5 * W, width=W,
                             height=H, device=dev)
        proj = project_gaussians(cam, torch.tensor(rng.normal(0, 0.4, (n, 3)), dtype=torch.float32,
                                                   device=dev), rot,
                                 torch.tensor(rng.uniform(0.01, 0.06, (n, 3)),
                                              dtype=torch.float32, device=dev))
        opac = torch.tensor(rng.uniform(0.1, 0.95, n), dtype=torch.float32, device=dev)
        cols = torch.tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32, device=dev)
        b = bin_gaussians(proj, opac, W, H, tile=16, max_per_tile=256)
        grid_w, num = (W + 15) // 16, ((W + 15) // 16) * ((H + 15) // 16)
        per = -(-num // 2)
        base = mesh.axis_index("tile") * per
        lists = torch.nn.functional.pad(b.tile_lists, (0, 0, 0, 2 * per - num))[base:base + per]
        counts = torch.nn.functional.pad(b.tile_counts, (0, 2 * per - num))[base:base + per]
        args = [t.detach().contiguous() for t in (proj["uv"], proj["conic"], cols, opac)]
        dcol = torch.tensor(rng.normal(size=(per, 256, 3)), dtype=torch.float32, device=dev)
        dalp = torch.tensor(rng.normal(size=(per, 256)), dtype=torch.float32, device=dev)
        res = {}
        for where, d in (("k", dev), ("plain", torch.device("cpu"))):
            leaves = [a.to(d).requires_grad_() for a in args]
            before = (tc.composite.launches, tc.composite.backward_launches)
            col, alp = tc.composite_lists(*leaves, lists.to(d).contiguous(),
                                          counts.to(d).contiguous(), 16, grid_w, tile_base=base,
                                          num_tiles=num)
            grads = torch.autograd.grad([col, alp], leaves, [dcol.to(d), dalp.to(d)])
            res[where] = [col, alp, *grads]
            if where == "k":
                out[f"{name}_launches"] = np.asarray(
                    [tc.composite.launches - before[0], tc.composite.backward_launches - before[1]])
        for i, key in enumerate(("col", "alp", "duv", "dconic", "dcolors", "dopacity")):
            out[f"{name}_{key}_k"] = _np(res["k"][i])
            out[f"{name}_{key}_plain"] = _np(res["plain"][i])
        with torch.no_grad():
            img, alpha = composite_tile_sharded(*args, b, W, H, 16, mesh, "tile")
            one, one_a = tc.composite(*args, b, W, H, 16)
        out[f"{name}_sharded_err"] = np.asarray(max(float((img - one).abs().max()),
                                                    float((alpha - one_a).abs().max())))
        out[f"{name}_base"] = np.asarray(base)
    return out


SCENARIOS = {
    "collectives": sc_collectives,
    "card_composite_lists": sc_card_composite_lists,
    "track_stages": sc_track_stages,
    "pipeline": sc_pipeline,
    "cli_train": sc_cli_train,
    "tile_render": sc_tile_render,
    "gauss_render": sc_gauss_render,
    "gauss_grads": sc_gauss_grads,
    "avatar_loss": sc_avatar_loss,
    "sharded_curve": sc_sharded_curve,
    "sharded_densify": sc_sharded_densify,
    "sharded_reset": sc_sharded_reset,
    "sharded_compact": sc_sharded_compact_rows,
    "sharded_cycle": sc_sharded_cycle,
    "sharded_chunked": sc_sharded_chunked,
    "frame_dp": sc_frame_dp,
    "frame_dp_pair": sc_frame_dp_pair,
    "mesh_2d": sc_mesh_2d,
    "checkpoints": sc_checkpoints,
}


def worker(rank: int, n: int, port: int, tmp: Path, names: list[str]) -> None:
    import torch

    from omfs4d_torch.parallel.distributed import init_distributed
    from omfs4d_torch.parallel.mesh import Mesh

    torch.set_num_threads(1)
    if names[0].startswith("card_"):
        # every rank on the one card: gloo carries the CUDA tensors
        init_distributed(f"tcp://127.0.0.1:{port}", n, rank)
    elif names[0].startswith("cli_"):
        # the environment torchrun gives a rank: the CLI joins the group itself
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                          LOCAL_RANK=str(rank), WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n))
    else:
        init_distributed(f"tcp://127.0.0.1:{port}", n, rank, device="cpu")

    def mesh_of(axes: tuple[str, ...], shape: tuple[int, ...] | None = None) -> Mesh:
        shape = shape or (n,)
        return Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)

    for name in names:
        res = SCENARIOS[name](tmp, rank, mesh_of)
        if res is not None:
            np.savez(tmp / f"{name}_{rank}.npz", **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
           sys.argv[5:])
