"""Trainer state surgery of the port against the JAX package's, on the
CPU: densify_prune_arrays with JAX's own normal noise injected and
distinct scores (`top_k` ties have no defined order), zero_opt_rows, the
opacity-reset moment surgery, compact_state as an exact permutation,
resize_state_capacity, compact_to_alive, probe_tile_spans and
size_binning_windows.  Exact, or at rtol 1e-6 where floats are recomputed
(the children's offsets, the split shrink).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omfs4d.core.config import TrainConfig as JConfig
from omfs4d_torch.convert import (gaussians_from_numpy, opt_state_from_optax, to_numpy,
                                  train_state_from_jax)
from omfs4d_torch.core.config import TrainConfig as TConfig
from omfs4d_torch.train import trainer as tt
from tests.test_torch_train import CAPACITY, H, T_FRAMES, W, scene, trainers  # noqa: F401

jt = importlib.import_module("omfs4d.train.trainer")


def cloud(seed=0, n=256, dead=64):
    """A gaussian cloud with dead slots, varied scales (some split) and
    opacities (some pruned)."""
    rng = np.random.default_rng(seed)
    alive = np.ones(n, bool)
    alive[rng.choice(n, dead, replace=False)] = False
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return {
        "parent_face": rng.integers(0, 100, n).astype(np.int32),
        "mu_local": rng.normal(size=(n, 3)).astype(np.float32),
        "quat_local": q / np.linalg.norm(q, axis=1, keepdims=True),
        "log_scale": rng.normal(0, 0.6, (n, 3)).astype(np.float32),
        "opacity_logit": rng.normal(0, 3, n).astype(np.float32),
        "color": rng.normal(size=(n, 3)).astype(np.float32),
        "sh": rng.normal(0, 0.1, (n, 15, 3)).astype(np.float32),
        "alive": alive,
    }


@pytest.mark.parametrize("zero_observed", [True, False])
def test_densify_prune_arrays_matches_jax(zero_observed):
    n, max_new = 256, 80           # more than the 64 dead slots
    fields = cloud()
    rng = np.random.default_rng(1)
    accum = rng.uniform(0, 3e-3, n).astype(np.float32)     # distinct scores
    count = rng.choice([-0.25, 0.0, 1.0, 2.0, 3.0], n).astype(np.float32)
    cfg_kw = dict(densify_grad_threshold=2e-4, prune_zero_observed=zero_observed)
    key = jax.random.PRNGKey(7)
    j_g = jt.GaussianAvatar(**{k: jnp.asarray(v) for k, v in fields.items()})
    j_out = jt.densify_prune_arrays(j_g, jnp.asarray(accum), jnp.asarray(count), key,
                                    max_new, JConfig(**cfg_kw))
    noise = np.asarray(jax.random.normal(key, (max_new, 3)))
    t_out = tt.densify_prune_arrays(gaussians_from_numpy(fields), torch.tensor(accum),
                                    torch.tensor(count), torch.tensor(noise), max_new,
                                    TConfig(**cfg_kw))
    j_g2, j_slots, j_ok, j_count = j_out
    t_g2, t_slots, t_ok, t_count = t_out
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(j_slots))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert t_ok.any() and not t_ok.all()
    np.testing.assert_array_equal(t_count.numpy(), np.asarray(j_count))
    got = to_numpy(t_g2)
    for k, v in j_g2._asdict().items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-6, atol=1e-6, err_msg=k)
    assert (got["alive"] != fields["alive"]).any()


def test_zero_opt_rows_and_opacity_reset_match_jax():
    fields = cloud(seed=3, n=128, dead=32)
    j_g = jt.GaussianAvatar(**{k: jnp.asarray(v) for k, v in fields.items()})
    opt = jt.make_optimizer(JConfig())
    fp = jt.float_fields(j_g)
    j_state = opt.init(fp)
    rng = np.random.default_rng(2)
    for _ in range(2):      # warm the moments up
        grads = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                 for k, v in fp.items()}
        _, j_state = opt.update(grads, j_state, fp)
    slots = jnp.asarray(rng.choice(128, 20, replace=False).astype(np.int32))
    ok = jnp.asarray(rng.uniform(size=20) > 0.5)

    t_state = opt_state_from_optax(j_state)
    tt.zero_opt_rows(t_state, torch.from_numpy(np.array(slots)).long(),
                     torch.from_numpy(np.array(ok)), 128)
    want = opt_state_from_optax(jt.zero_opt_rows(j_state, slots, ok, 128))
    for grp in want:
        for part in ("mu", "nu"):
            for k, v in want[grp][part].items():
                assert torch.equal(t_state[grp][part][k], v), (grp, part, k)

    # opacity reset: only the opacity group's moments (and count) start over
    t_g = gaussians_from_numpy(fields)
    before = {grp: {k: v.clone() for k, v in s["mu"].items()} for grp, s in t_state.items()}
    out = tt.reset_opacity_opt_state(t_state, t_g)
    want = opt_state_from_optax(jt.reset_opacity_opt_state(opt, j_state, fp))
    assert int(out["opac"]["count"]) == int(want["opac"]["count"]) == 0
    assert not out["opac"]["mu"]["opacity_logit"].any()
    for grp in out:
        if grp != "opac":
            for k, v in out[grp]["mu"].items():
                assert torch.equal(v, before[grp][k])


def test_compact_and_resize_state_match_jax(scene):
    model, _, _, data = scene
    fields = cloud(seed=4, n=512, dead=200)
    rng = np.random.default_rng(5)
    j_g = jt.GaussianAvatar(**{k: jnp.asarray(v) for k, v in fields.items()})
    opt = jt.make_optimizer(JConfig())
    fp = jt.float_fields(j_g)
    j_opt = opt.init(fp)
    _, j_opt = opt.update({k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                           for k, v in fp.items()}, j_opt, fp)
    j_state = jt.TrainState(gaussians=j_g, opt_state=j_opt, step=jnp.asarray(1, jnp.int32),
                            grad_accum=jnp.asarray(rng.uniform(size=512).astype(np.float32)),
                            grad_count=jnp.asarray(rng.integers(0, 4, 512).astype(np.float32)))
    t_state = train_state_from_jax(j_state)
    keep = np.flatnonzero(fields["alive"])

    for name, j_fn, t_fn, cap in [
            ("compact", jt.AvatarTrainer.compact_state, tt.AvatarTrainer.compact_state, 320),
            ("grow", jt.AvatarTrainer.resize_state_capacity,
             tt.AvatarTrainer.resize_state_capacity, 1024),
            ("shrink", jt.AvatarTrainer.resize_state_capacity,
             tt.AvatarTrainer.resize_state_capacity, 400)]:
        want = j_fn(j_state, cap)
        got = t_fn(t_state, cap)
        assert got.gaussians.capacity == cap
        g_got = to_numpy(got.gaussians)
        for k, v in want.gaussians._asdict().items():
            np.testing.assert_array_equal(g_got[k], np.asarray(v), err_msg=f"{name} {k}")
        np.testing.assert_array_equal(got.grad_accum.numpy(), np.asarray(want.grad_accum))
        np.testing.assert_array_equal(got.grad_count.numpy(), np.asarray(want.grad_count))
        w_opt = opt_state_from_optax(want.opt_state)
        for grp in w_opt:
            for part in ("mu", "nu"):
                for k, v in w_opt[grp][part].items():
                    assert torch.equal(got.opt_state[grp][part][k], v), (name, grp, k)
        if name == "compact":
            n = len(keep)
            np.testing.assert_array_equal(g_got["mu_local"][:n], fields["mu_local"][keep])

    # compact_to_alive rounds to the 1024 multiple, never below one block
    _, t_tr = trainers(scene, False)
    assert t_tr.compact_to_alive(t_state).gaussians.capacity == 512   # 312 * 1.125 -> 1024 >= 512


def test_probe_spans_and_binning_windows_match_jax(scene):
    model, _, _, data = scene
    j_tr, t_tr = trainers(scene, False)
    js = j_tr.init_state(capacity=CAPACITY)
    ts = train_state_from_jax(js)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
    j_sides, j_n = jt.probe_tile_spans(js.gaussians, model.faces, jdata, W, H, 16)
    t_sides, t_n = tt.probe_tile_spans(ts.gaussians, t_tr.faces, tdata, W, H, 16)
    assert t_n == j_n == T_FRAMES
    np.testing.assert_array_equal(t_sides, j_sides)

    rng = np.random.default_rng(0)
    sides = np.where(rng.uniform(size=4000) < 0.3, 0, rng.integers(1, 9, 4000)).astype(float)
    for cfg in ({"max_tiles_per_gaussian": 16, "large_frac": 0.125},
                {"max_tiles_per_gaussian": 64, "large_frac": 0.9}):
        for shrink in (False, True):
            assert (tt.size_binning_windows(sides, 4, cfg, 2000, 64, shrink)
                    == jt.size_binning_windows(sides, 4, cfg, 2000, 64, shrink))
    assert tt.size_binning_windows(np.zeros(10), 1, cfg, 10, 64) == {}
