"""Vector-Jacobian products of the port's training-path functions against
the JAX package's, on the CPU: `flame_forward` (the FLAME co-optimization
path), `bind_to_mesh`, `eval_colors` and `project_gaussians`.  The same
numpy inputs and the same seeded random cotangent go through
`jax.vjp` and `torch.autograd.grad`.

Tolerance atol = 1e-4 * max|JAX grad|, rtol = 1e-3: float32 on both
sides, sums in other orders; the conic's gradients pass through a quotient
by a small determinant.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from omfs4d.models import flame as jf
from omfs4d.models import gaussians as jg
from omfs4d.models.assets import synthetic_flame_asset
from omfs4d.ops import camera as jc
from omfs4d_torch.convert import flame_model_from_numpy
from omfs4d_torch.models import flame as tf
from omfs4d_torch.models import gaussians as tg
from omfs4d_torch.ops import camera as tcam
from tests.test_rasterize import random_scene
from tests.test_torch_flame import random_params
from tests.test_torch_gaussians_camera import random_avatar, to_port


def cotangent(out, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=np.shape(o)).astype(np.float32) for o in out]


def assert_vjp_close(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-4 * scale, rtol=1e-3,
                                   err_msg=name)


def torch_vjp(fn, inputs, cts):
    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, (tuple, list)) else (out,)
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(out, cts))
    return torch.autograd.grad(loss, leaves)


def test_flame_forward_vjp_matches_jax():
    jm = jf.FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=1))
    tm = flame_model_from_numpy(jax.tree_util.tree_map(np.asarray, jm)._asdict())
    p = random_params(jm.n_vertices, B=2)
    keys = ("expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose", "translation")
    fixed = {k: v for k, v in p.items() if k not in keys}

    def j_fn(*vals):
        return jf.flame_forward(jm, {**{k: jnp.asarray(v) for k, v in fixed.items()},
                                     **dict(zip(keys, vals))})

    def t_fn(*vals):
        return tf.flame_forward(tm, {**fixed, **dict(zip(keys, vals))})

    out, vjp = jax.vjp(j_fn, *(jnp.asarray(p[k]) for k in keys))
    (ct,) = cotangent([out], 0)
    want = vjp(jnp.asarray(ct))
    got = torch_vjp(t_fn, [p[k] for k in keys], [ct])
    assert_vjp_close(got, want, keys)


FIELDS = ("mu_local", "quat_local", "log_scale", "opacity_logit", "color", "sh")


def test_bind_to_mesh_and_eval_colors_vjp_match_jax():
    asset = synthetic_flame_asset(n_vertices=300, seed=2)
    verts = (asset["v_template"] + np.random.default_rng(1).normal(
        0, 1e-3, asset["v_template"].shape)).astype(np.float32)
    faces = asset["faces"]
    g = random_avatar(faces, n=400)
    base = jax.tree_util.tree_map(np.asarray, g)
    cam_pos = np.array([0.1, -0.2, 0.6], np.float32)

    def j_fn(v, *vals):
        gj = g._replace(**dict(zip(FIELDS, vals)))
        means, rot, scales, opac, cols = jg.bind_to_mesh(gj, v, jnp.asarray(faces))
        return means, rot, scales, opac, jg.eval_colors(gj, means, jnp.asarray(cam_pos))

    port = to_port(g)

    def t_fn(v, *vals):
        # the avatar's fields as the leaves of the graph
        gt = SimpleNamespace(parent_face=port.parent_face, alive=port.alive,
                             **dict(zip(FIELDS, vals)))
        means, rot, scales, opac, cols = tg.bind_to_mesh(gt, v, torch.from_numpy(faces))
        return means, rot, scales, opac, tg.eval_colors(gt, means, torch.from_numpy(cam_pos))

    inputs = [verts] + [np.asarray(getattr(base, k)) for k in FIELDS]
    out, vjp = jax.vjp(j_fn, *(jnp.asarray(x) for x in inputs))
    cts = cotangent(out, 1)
    want = vjp(tuple(jnp.asarray(c) for c in cts))
    got = torch_vjp(t_fn, inputs, cts)
    assert_vjp_close(got, want, ("verts",) + FIELDS)


def test_project_gaussians_vjp_matches_jax():
    kw = dict(fx=210.0, fy=190.0, width=80, height=60, cx=41.0, cy=29.5)
    jcam = jc.look_at_camera(eye=(0.2, 0.1, -2.5), target=(0, 0, 0), **kw)
    tcam_ = tcam.look_at_camera(eye=(0.2, 0.1, -2.5), target=(0, 0, 0), **kw)
    means, rot, scales, _, _ = random_scene(200, seed=11)

    def j_fn(m, r, s):
        p = jc.project_gaussians(jcam, m, r, s)
        return p["uv"], p["conic"], p["depth"]

    def t_fn(m, r, s):
        p = tcam.project_gaussians(tcam_, m, r, s)
        return p["uv"], p["conic"], p["depth"]

    inputs = [means, rot, scales]
    out, vjp = jax.vjp(j_fn, *(jnp.asarray(x) for x in inputs))
    cts = cotangent(out, 2)
    want = vjp(tuple(jnp.asarray(c) for c in cts))
    got = torch_vjp(t_fn, inputs, cts)
    assert_vjp_close(got, want, ("means", "rotations", "scales"))
