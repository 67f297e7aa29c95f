"""One training step of the port (`omfs4d_torch.train.trainer`) against
the JAX package's, on the CPU, from the same state; and its optimizer.

* One step at 64^2 (700-vertex synthetic FLAME asset, 2 frames with
  foreground masks, capacity 2048, K = 128), with and without FLAME
  co-optimization: the loss, each
  field's gradient (read from Adam's first moment after one step from zero
  moments: mu = 0.1 g), the FLAME gradients, the probe gradient norm and
  Adam's update where |g| >> eps.  The binning lists are asserted equal
  across the packages before anything is compared.  Gradient tolerance
  atol = 2e-4 * max|g|, rtol = 2e-3 (the composite's own bound; the
  pipeline sums the same terms in other orders).  The scene is on a black
  background: on a white one, the reference's SSIM switches its
  Cauchy-Schwarz clip on rounding noise in flat windows at 1.0 (the
  variance there is filt(1) - filt(1)^2 ~ +-1e-7, and the two packages'
  blur taps differ by an ulp), which moves single pixel gradients by tens
  of percent in either package.
* The LR schedules against optax at steps 0, 1, the horizon and past it;
  Adam against optax with injected gradients (rtol 1e-5).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omfs4d.core.config import TrainConfig as JConfig
from omfs4d.io.synthetic import orbit_c2w_nerf
from omfs4d.io.synthetic import textured_gt_avatar as j_textured_gt_avatar
from omfs4d.models.assets import synthetic_flame_asset
from omfs4d.models.flame import FlameModel as JFlame
from omfs4d.models.flame import flame_forward as j_flame_forward
from omfs4d.ops.camera import Camera as JCamera
from omfs4d.ops.camera import camera_from_nerf
from omfs4d.render.rasterize import render_avatar_frame as j_render_avatar_frame
from omfs4d_torch.convert import (flame_model_from_numpy, opt_state_from_optax, to_numpy,
                                  train_state_from_jax)
from omfs4d_torch.core.config import TrainConfig as TConfig
from omfs4d_torch.render.rasterize import bin_gaussians as t_bin
from omfs4d_torch.train import trainer as tt

jt = importlib.import_module("omfs4d.train.trainer")
jr = importlib.import_module("omfs4d.render.rasterize")

W = H = 64
T_FRAMES = 2
CAPACITY = 2048
K = 128
GRAD_TOL = 2e-4, 2e-3          # atol * max|g|, rtol


@pytest.fixture(scope="module")
def scene():
    model = JFlame.from_asset(synthetic_flame_asset(n_vertices=700, seed=0))
    gt = j_textured_gt_avatar(model, seed=0)
    rng = np.random.default_rng(1)
    params = {
        "shape": np.zeros(300, np.float32), "expr": np.zeros((T_FRAMES, 100), np.float32),
        "rotation": np.zeros((T_FRAMES, 3), np.float32),
        "neck_pose": np.zeros((T_FRAMES, 3), np.float32),
        "jaw_pose": rng.normal(0, 0.05, (T_FRAMES, 3)).astype(np.float32),
        "eyes_pose": np.zeros((T_FRAMES, 6), np.float32),
        "translation": np.zeros((T_FRAMES, 3), np.float32),
    }
    verts = j_flame_forward(model, {k: jnp.asarray(v) for k, v in params.items()})
    c2w = orbit_c2w_nerf(T_FRAMES)
    cams = [camera_from_nerf(c2w[i], W * 1.8, W * 1.8, W / 2, H / 2, W, H)
            for i in range(T_FRAMES)]
    renders = [j_render_avatar_frame(gt, verts[i], model.faces, cams[i], W, H,
                                     backend="never", background=jnp.zeros(3))
               for i in range(T_FRAMES)]
    imgs = [np.asarray(img) for img, _ in renders]
    data = {
        "images": np.clip(np.stack(imgs) * 255, 0, 255).astype(np.uint8),
        # foreground masks, composited onto the background by both steps
        "masks": np.stack([(np.asarray(aux["alpha"]) > 0.5) * 255 for _, aux in renders]
                          ).astype(np.uint8),
        "verts": np.asarray(verts),
        "w2c": np.stack([np.asarray(c.w2c) for c in cams]),
        **{k: np.array([float(getattr(c, k)) for c in cams], np.float32)
           for k in ("fx", "fy", "cx", "cy")},
    }
    t_model = flame_model_from_numpy({k: np.asarray(v) for k, v in model._asdict().items()})
    return model, t_model, params, data


def trainers(scene, co_opt, **cfg_kw):
    model, t_model, _, _ = scene
    kw = dict(iterations=100, max_gaussians=CAPACITY, batch_frames=1,
              optimize_flame=co_opt, **cfg_kw)
    j = jt.AvatarTrainer(np.asarray(model.faces), JConfig(**kw), W, H, max_per_tile=K,
                         use_pallas="never", white_background=False,
                         flame_model=model if co_opt else None)
    t = tt.AvatarTrainer(np.asarray(model.faces), TConfig(**kw), W, H, max_per_tile=K,
                         white_background=False, flame_model=t_model if co_opt else None,
                         device="cpu")
    return j, t


def assert_grads_close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = float(np.abs(b).max())
    # + 1e-10: a gradient that is 0 analytically (the quaternions of the
    # isotropic init cloud) is rounding noise of ~1e-11 in both packages
    np.testing.assert_allclose(a, b, atol=GRAD_TOL[0] * scale + 1e-10, rtol=GRAD_TOL[1],
                               err_msg=what)


def adam_mu(opt_state, group):
    """The first moment tree of one group of an optax multi_transform state."""
    return {k: np.asarray(v) for k, v in
            opt_state.inner_states[group].inner_state[0].mu.items() if hasattr(v, "shape")}


@pytest.mark.parametrize("co_opt", [False, True])
def test_train_step_matches_jax(scene, co_opt):
    model, t_model, params, data = scene
    j_tr, t_tr = trainers(scene, co_opt)
    fp = params if co_opt else None
    js = j_tr.init_state(capacity=CAPACITY,
                         flame_params=None if fp is None else
                         {k: jnp.asarray(v) for k, v in fp.items()})
    t_tr.init_state(capacity=CAPACITY, flame_params=fp)       # sets the leash anchor
    ts = train_state_from_jax(js)
    g0 = {k: v.copy() for k, v in to_numpy(ts.gaussians).items()}
    flame0 = None if fp is None else {k: v.copy() for k, v in fp.items()}
    frame = 1

    # the lists the step will composite agree across the packages
    jcam = JCamera(w2c=jnp.asarray(data["w2c"][frame]), fx=data["fx"][frame],
                   fy=data["fy"][frame], cx=data["cx"][frame], cy=data["cy"][frame],
                   width=W, height=H)
    means, rot, scales, opac, _ = jt.bind_to_mesh(js.gaussians, jnp.asarray(data["verts"][frame]),
                                                  jnp.asarray(model.faces))
    jproj = jt.project_gaussians(jcam, means, rot, scales)
    jb = jr.bin_gaussians(jproj, opac, W, H, 16, K, 16)
    tb = t_bin({k: torch.from_numpy(np.array(v)) for k, v in jproj.items()},
               torch.from_numpy(np.array(opac)), W, H, 16, K, 16)
    np.testing.assert_array_equal(tb.tile_counts.numpy(), np.asarray(jb.tile_counts))
    np.testing.assert_array_equal(tb.tile_lists.numpy(), np.asarray(jb.tile_lists))

    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    js2, jm = j_tr._step_fn(js, jdata, jnp.asarray([frame], jnp.int32))
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
    ts2, tm = t_tr.train_step(ts, tdata, [frame])

    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["psnr"]) == pytest.approx(float(jm["psnr"]), abs=1e-4)
    for k in ("overflow", "window_clipped", "window_spilled", "n_alive"):
        assert int(tm[k]) == int(jm[k]), k
    assert int(ts2.step) == int(js2.step) == 1

    # gradients: mu = (1 - 0.9) g after one step from zero moments
    for field, group in tt.PARAM_GROUPS.items():
        assert_grads_close(ts2.opt_state[group]["mu"][field].numpy(),
                           adam_mu(js2.opt_state, group)[field], field)
        assert int(ts2.opt_state[group]["count"]) == 1
    assert_grads_close(ts2.grad_accum.numpy(), np.asarray(js2.grad_accum), "probe gnorm")
    np.testing.assert_array_equal(ts2.grad_count.numpy(), np.asarray(js2.grad_count))
    assert ts2.grad_count.sum() > 0

    # Adam's update, where |g| >> eps (the first step is +-lr there)
    for field in tt.FLOAT_FIELDS:
        g = adam_mu(js2.opt_state, tt.PARAM_GROUPS[field])[field] / 0.1
        big = np.abs(g) > 1e-4
        if field == "quat_local":       # renormalized: compare whole rows
            big = np.broadcast_to(big.any(-1, keepdims=True), big.shape)
        a = getattr(ts2.gaussians, field).detach().numpy()
        b = np.asarray(getattr(js2.gaussians, field))
        np.testing.assert_allclose(a[big], b[big], atol=1e-6, err_msg=field)
        assert (a != g0[field]).any() or not big.any()
    np.testing.assert_allclose(np.linalg.norm(ts2.gaussians.quat_local.detach().numpy(), axis=-1),
                               1.0, atol=1e-6)

    if co_opt:
        for group in ("pose", "expr"):
            j_mu = adam_mu(js2.flame_opt_state, group)
            assert set(ts2.flame_opt_state[group]["mu"]) == set(j_mu)
            for k, v in j_mu.items():
                assert_grads_close(ts2.flame_opt_state[group]["mu"][k].numpy(), v, k)
        for k in flame0:
            assert_grads_close(ts2.flame_params[k].numpy() - flame0[k],
                               np.asarray(js2.flame_params[k]) - flame0[k], k)
        assert np.abs(ts2.flame_params["jaw_pose"].numpy() - flame0["jaw_pose"]).max() > 0


def test_lr_schedules_match_optax():
    cfg_kw = dict(iterations=8000, lr_decay_horizon=5000, lr_position_final_scale=0.01,
                  lr_flame_warmup=300, lr_flame_final_scale=0.03)
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    pairs = [(jt._position_lr(jcfg), tt._position_lr(tcfg)),
             (jt._flame_lr(jcfg, jcfg.lr_flame_pose), tt._flame_lr(tcfg, tcfg.lr_flame_pose)),
             (jt._flame_lr(jcfg, jcfg.lr_flame_expr), tt._flame_lr(tcfg, tcfg.lr_flame_expr))]
    for j_fn, t_fn in pairs:
        assert callable(j_fn) and callable(t_fn)
        for step in (0, 1, 299, 300, 301, 2500, 4999, 5000, 5001, 7999):
            want = float(j_fn(jnp.asarray(step, jnp.int32)))
            got = float(t_fn(torch.tensor(step, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=2e-6), step
    assert tt._decay_horizon(tcfg) == jt._decay_horizon(jcfg) == 5000
    assert tt.densify_until_iter(tcfg, 8000) == jt.densify_until_iter(jcfg, 8000)
    # constant LRs when the schedules are off
    flat = dict(lr_position_final_scale=1.0, lr_flame_warmup=0)
    assert tt._position_lr(TConfig(**flat)) == jt._position_lr(JConfig(**flat))
    assert tt._flame_lr(TConfig(**flat), 0.1) == jt._flame_lr(JConfig(**flat), 0.1)
    # SH at DC / 20
    assert tt.gaussian_lrs(tcfg)["sh"] == tcfg.lr_color / 20.0


def test_adam_matches_optax_with_injected_gradients():
    """Three steps of every gaussian group (the position group on its
    exponential schedule) from the same injected gradients."""
    cfg_kw = dict(iterations=10, lr_decay_horizon=5, lr_position_final_scale=0.01)
    rng = np.random.default_rng(0)
    shapes = {"mu_local": (64, 3), "quat_local": (64, 4), "log_scale": (64, 3),
              "opacity_logit": (64,), "color": (64, 3), "sh": (64, 15, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    opt = jt.make_optimizer(JConfig(**cfg_kw))
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = opt.init(j_params)
    t_params = {k: torch.tensor(v) for k, v in params.items()}
    t_state = {grp: tt.adam_init({k: t_params[k]}) for k, grp in tt.PARAM_GROUPS.items()}
    lrs = tt.gaussian_lrs(TConfig(**cfg_kw))
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        updates, j_state = opt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                      j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, grp in tt.PARAM_GROUPS.items():
            tt.adam_update(t_state[grp], {k: torch.tensor(grads[k])}, {k: t_params[k]}, lrs[grp])
    for k in shapes:
        np.testing.assert_allclose(t_params[k].numpy(), np.asarray(j_params[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    converted = opt_state_from_optax(j_state)
    for grp in converted:
        assert int(t_state[grp]["count"]) == int(converted[grp]["count"]) == 3
        for part in ("mu", "nu"):
            for k, v in converted[grp][part].items():
                np.testing.assert_allclose(t_state[grp][part][k].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-9)
