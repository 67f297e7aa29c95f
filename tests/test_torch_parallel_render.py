"""Tile- and gaussian-sharded rendering of the port (`omfs4d_torch.parallel.
shard`) on a gloo world of 4 CPU processes, held to the JAX package's sharded
renders on the conftest's virtual devices (the Pallas slab path in interpret
mode, as tests/test_multichip.py runs it) and to the port's one-process
render.  One world runs every scenario of this module (test_torch_parallel_
harness)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tests.test_rasterize import random_scene
from tests.test_torch_parallel_harness import World, save

N_RANKS = 4
IMG_TOL = 1e-4
GRAD_TOL = 2e-4, 2e-3      # atol * max|g|, rtol


def jax_mesh(axis):
    return Mesh(np.asarray(jax.devices()[:N_RANKS]).reshape(N_RANKS), (axis,))


def camera(S, fx, eye=(0, 0, -2.5)):
    from omfs4d.ops.camera import look_at_camera

    return look_at_camera(eye=eye, target=(0, 0, 0), fx=fx, width=S, height=S)


def cam_arrays(cam):
    return {k: np.asarray(getattr(cam, k), np.float32) for k in ("w2c", "fx", "fy", "cx", "cy")}


def scene_inputs(tmp, name, n, seed, S, fx, K):
    means, rot, scales, opacity, colors = random_scene(n, seed=seed)
    cam = camera(S, fx)
    save(tmp, name, means=means, rot=rot, scales=scales, opacity=opacity, colors=colors,
         size=S, max_per_tile=K, **cam_arrays(cam))
    return tuple(jnp.asarray(a) for a in (means, rot, scales, opacity, colors)), cam


def avatar_inputs(tmp):
    from omfs4d.io.synthetic import textured_gt_avatar
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward

    S = 32
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=0))
    g = textured_gt_avatar(model, capacity=796)
    cap4 = (g.capacity // 4) * 4
    g = jax.tree_util.tree_map(lambda a: a[:cap4], g)
    cam = camera(S, 1.6 * S, eye=(0, 0, 0.5))
    verts = flame_forward(model, {"shape": jnp.zeros(300), "expr": jnp.zeros((1, 100))})[0]
    gt = np.random.default_rng(0).uniform(0, 1, (S, S, 3)).astype(np.float32)
    save(tmp, "avatar_loss", **{"g_" + k: np.asarray(v) for k, v in g._asdict().items()},
         verts=np.asarray(verts), faces=np.asarray(model.faces), gt=gt, size=S,
         max_per_tile=np.asarray([1024, 256]), **cam_arrays(cam))
    return model, g, verts, cam, jnp.asarray(gt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results, and the JAX side's, computed while they run."""
    from omfs4d.parallel.shard import (avatar_loss_gaussian_sharded,
                                       rasterize_tile_sharded, render_gaussian_sharded)
    from omfs4d.render.rasterize import rasterize
    from omfs4d.train.trainer import float_fields, with_floats

    tmp = tmp_path_factory.mktemp("parallel_render")
    tile_args, tile_cam = scene_inputs(tmp, "tile_render", 80, 5, 64, 200.0, 128)
    gauss_args, gauss_cam = scene_inputs(tmp, "gauss_render", 96, 11, 64, 200.0, 128)
    grad_args, grad_cam = scene_inputs(tmp, "gauss_grads", 64, 2, 32, 150.0, 64)
    model, g, verts, acam, gt = avatar_inputs(tmp)
    world = World(N_RANKS, tmp).run("tile_render", "gauss_render", "gauss_grads",
                                    "avatar_loss")

    ref = {}
    tmesh, gmesh = jax_mesh("tile"), jax_mesh("gauss")
    ref["tile_one"] = rasterize(*tile_args, tile_cam, 64, 64, max_per_tile=128,
                                backend="never")
    for pallas in (False, True):
        ref[f"tile_sharded_{pallas}"] = jax.jit(
            lambda *a, p=pallas: rasterize_tile_sharded(*a, tile_cam, 64, 64, mesh=tmesh,
                                                        max_per_tile=128, use_pallas=p)
        )(*tile_args)
    ref["gauss_one"] = rasterize(*gauss_args, gauss_cam, 64, 64, max_per_tile=128,
                                 backend="never")
    ref["gauss_sharded"] = jax.jit(
        lambda *a: render_gaussian_sharded(*a, gauss_cam, 64, 64, mesh=gmesh, max_per_tile=128)
    )(*gauss_args)

    means, rot, scales, opacity, colors = grad_args

    def grad_loss(c, o):
        img, _ = render_gaussian_sharded(means, rot, scales, o, c, grad_cam, 32, 32,
                                         mesh=gmesh, max_per_tile=64)
        return jnp.sum(img ** 2)

    ref["gauss_grads"] = jax.jit(jax.grad(grad_loss, argnums=(0, 1)))(colors, opacity)

    for K, pallas in ((1024, False), (256, True)):
        def avatar_loss(fp, v):
            return avatar_loss_gaussian_sharded(with_floats(g, fp), v, model.faces, acam, gt,
                                                mesh=gmesh, max_per_tile=K, use_pallas=pallas)

        ref[f"avatar_{K}"] = jax.jit(jax.value_and_grad(avatar_loss, argnums=(0, 1)))(
            float_fields(g), verts)
    return world.wait(), ref


def test_tile_sharded_render_matches_jax_and_one_process(runs):
    """tests/test_multichip.py::test_tile_sharded_rasterize_matches_single
    and ::test_tile_sharded_pallas_matches_xla: 4 slabs of a 64^2 frame,
    each composited by `composite_lists` at its global tile base."""
    out, ref = runs
    one_img, one_aux = ref["tile_one"]
    for r, res in enumerate(out["tile_render"]):
        np.testing.assert_allclose(res["img"], np.asarray(one_img), atol=IMG_TOL,
                                   err_msg=f"rank {r} vs JAX one-device")
        np.testing.assert_allclose(res["alpha"], np.asarray(one_aux["alpha"]), atol=IMG_TOL)
        for pallas in (False, True):
            img, aux = ref[f"tile_sharded_{pallas}"]
            np.testing.assert_allclose(res["img"], np.asarray(img), atol=IMG_TOL,
                                       err_msg=f"rank {r} vs JAX sharded, pallas={pallas}")
            np.testing.assert_allclose(res["alpha"], np.asarray(aux["alpha"]), atol=IMG_TOL)
        np.testing.assert_array_equal(res["img"], res["one"])
        np.testing.assert_array_equal(res["img"], out["tile_render"][0]["img"])


def test_gaussian_sharded_render_matches_jax(runs):
    """::test_gaussian_sharded_rasterize_matches_single: 4 depth slices of
    96 gaussians merged "over" equal the one-device render."""
    out, ref = runs
    one_img, one_aux = ref["gauss_one"]
    sh_img, sh_aux = ref["gauss_sharded"]
    for r, res in enumerate(out["gauss_render"]):
        assert int(res["overflow"]) == 0 == int(sh_aux["overflow"])
        for img, alpha, what in ((one_img, one_aux["alpha"], "one device"),
                                 (sh_img, sh_aux["alpha"], "sharded")):
            np.testing.assert_allclose(res["img"], np.asarray(img), atol=IMG_TOL,
                                       err_msg=f"rank {r} vs JAX {what}")
            np.testing.assert_allclose(res["alpha"], np.asarray(alpha), atol=IMG_TOL)


def assert_grads_close(got, want, what, whole=None):
    """`whole`: the leaf that `want` is a shard of, whose max sets the scale."""
    scale = max(np.abs(want if whole is None else whole).max(), 1e-5)
    np.testing.assert_allclose(got, want, atol=GRAD_TOL[0] * scale, rtol=GRAD_TOL[1],
                               err_msg=what)


def test_gaussian_sharded_gradients_match_jax(runs):
    """::test_gaussian_sharded_gradients_flow: the gradients through the
    all_to_all and the slice merge, each rank's rows, against the JAX
    sharded gradients and the port's one-process ones."""
    out, ref = runs
    gc, go = (np.asarray(a) for a in ref["gauss_grads"])
    per = gc.shape[0] // N_RANKS
    for r, res in enumerate(out["gauss_grads"]):
        sl = slice(r * per, (r + 1) * per)
        assert np.abs(res["gc"]).max() > 0 and np.abs(res["go"]).max() > 0
        assert_grads_close(res["gc"], gc[sl], f"rank {r} colors vs JAX", gc)
        assert_grads_close(res["go"], go[sl], f"rank {r} opacity vs JAX", go)
        assert_grads_close(res["gc"], res["gc_one"], f"rank {r} colors vs one process", gc)
        assert_grads_close(res["go"], res["go_one"], f"rank {r} opacity vs one process", go)


@pytest.mark.parametrize("K", [1024, 256])
def test_avatar_loss_gaussian_sharded_matches_jax(runs, K):
    """::test_gaussian_sharded_training_matches_unsharded (K = 1024) and
    ::test_gaussian_sharded_loss_pallas_matches_xla (K = 256, the JAX side
    through the Pallas kernel in interpret mode): the loss, and every
    leaf's gradient, verts included, on every rank, against the JAX sharded
    loss and, at K = 1024 where no list overflows (the depth slices would
    keep other entries than one list), the port's own one-process loss."""
    out, ref = runs
    loss, (gf, gv) = ref[f"avatar_{K}"]
    per = np.asarray(gf["color"]).shape[0] // N_RANKS
    for r, res in enumerate(out["avatar_loss"]):
        sl = slice(r * per, (r + 1) * per)
        assert abs(float(res[f"loss_{K}"]) - float(loss)) < 1e-5
        if K == 1024:
            assert int(res["one_overflow_1024"]) == 0
            assert abs(float(res[f"loss_{K}"]) - float(res[f"one_loss_{K}"])) < 1e-5
        for k in list(gf) + ["verts"]:
            whole = np.asarray(gv) if k == "verts" else np.asarray(gf[k])
            want = whole if k == "verts" else whole[sl]
            assert_grads_close(res[f"{k}_{K}"], want, f"rank {r} d{k} vs JAX", whole)
            if K == 1024:
                assert_grads_close(res[f"{k}_{K}"], res[f"one_{k}_{K}"],
                                   f"rank {r} d{k} vs one process", whole)
