"""The port's gaussian-sharded trainer (`omfs4d_torch.parallel.
sharded_trainer`) on a gloo world of 4 CPU processes, held to the JAX
package's replicated trainer on the same frames and initial cloud, and to
itself: per-shard densify (JAX's noise and `densify_prune_arrays` per shard
block), compaction, the densify / reset / resume cycle and the chunked loop.
One world runs every scenario of this module (test_torch_parallel_harness)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_multichip import _tiny_scene
from tests.test_torch_parallel_harness import World, save

N_RANKS = 4
S = 32
CURVE_REL = 2e-3


def cfg_json(**kw):
    base = dict(densify_interval=0, batch_frames=1, opacity_reset_interval=0,
                max_gaussians=1024, sh_degree=1)
    return json.dumps({**base, **kw})


def jax_cfg(js):
    from omfs4d.core.config import TrainConfig

    return TrainConfig(**json.loads(js))


def g0_arrays(faces, capacity):
    from omfs4d.models.gaussians import init_gaussians_on_mesh

    g0 = init_gaussians_on_mesh(np.asarray(faces), capacity, seed=0, sh_degree=1)
    return g0, {"g0_" + k: np.asarray(v) for k, v in g0._asdict().items()}


def data_arrays(data):
    return {"data_" + k: np.asarray(v) for k, v in data.items()}


def replicated_curve(faces, js, g0, data, steps, K, reset_every=0):
    """The JAX package's replicated AvatarTrainer on frame 0."""
    from omfs4d.train.trainer import AvatarTrainer, float_fields

    cfg = jax_cfg(js)
    rep = AvatarTrainer(np.asarray(faces), cfg, S, S, max_per_tile=K, use_pallas="never")
    g = jax.tree_util.tree_map(jnp.array, g0)
    rs = rep.init_state(capacity=g0.capacity)._replace(gaussians=g)
    rs = rs._replace(opt_state=rep.optimizer.init(float_fields(g)))
    losses = []
    for it in range(1, steps + 1):
        rs, rm = rep._step_fn(rs, data, jnp.zeros((1,), jnp.int32))
        losses.append(float(rm["loss"]))
        if reset_every and it % reset_every == 0:
            rs = rep.reset_opacity(rs)
    return np.asarray(losses)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from omfs4d.core.config import TrainConfig
    from omfs4d.train.trainer import densify_prune_arrays

    tmp = tmp_path_factory.mktemp("parallel_train")
    model, cam, data = _tiny_scene(S)
    faces = np.asarray(model.faces)
    g0, g0a = g0_arrays(faces, 1024)
    common = dict(faces=faces, size=S, **data_arrays(data))
    curve_js = cfg_json(iterations=8)
    save(tmp, "sharded_curve", cfg=curve_js, max_per_tile=512, **common, **g0a)
    reset_js = cfg_json(iterations=12, opacity_reset_interval=4, densify_until_frac=1.0)
    save(tmp, "sharded_reset", cfg=reset_js, max_per_tile=512, **common, **g0a)

    # per-shard densify: JAX's noise per shard key, the accumulators seeded
    rng = np.random.default_rng(4)
    accum = rng.uniform(0, 2e-3, 1024).astype(np.float32)
    count = rng.integers(0, 3, 1024).astype(np.float32)
    max_new = 1024 // N_RANKS // 16
    keys = jax.random.split(jax.random.PRNGKey(1), N_RANKS)
    noise = np.stack([np.asarray(jax.random.normal(k, (max_new, 3))) for k in keys])
    dens_js = cfg_json(iterations=8)
    save(tmp, "sharded_densify", cfg=dens_js, max_per_tile=512, accum=accum, count=count,
         noise=noise, **common, **g0a)

    _, g2048 = g0_arrays(faces, 2048)
    alive = np.ones(2048, bool)
    idx = np.flatnonzero(alive)
    alive[idx[np.arange(len(idx)) % 3 != 0]] = False
    save(tmp, "sharded_compact", cfg=cfg_json(iterations=4, max_gaussians=2048),
         max_per_tile=512, alive=alive, **common, **g2048)
    save(tmp, "sharded_cycle", cfg=cfg_json(
        iterations=60, densify_from=5, densify_interval=20, densify_until_frac=0.9,
        opacity_reset_interval=25, densify_grad_threshold=1e-6), max_per_tile=256,
        **common, **g0a)
    _, cam2, data2 = _tiny_scene(S, T=2)
    rng0 = np.random.default_rng(0)
    data2 = dict(data2, images=jnp.asarray(rng0.integers(0, 255, (2, S, S, 3)), jnp.uint8))
    _, g512 = g0_arrays(faces, 512)
    save(tmp, "sharded_chunked", cfg=cfg_json(iterations=60, max_gaussians=512),
         max_per_tile=256, faces=faces, size=S, **data_arrays(data2), **g512)

    world = World(N_RANKS, tmp).run("sharded_curve", "sharded_densify", "sharded_reset",
                                    "sharded_compact", "sharded_cycle", "sharded_chunked")
    ref = {"curve": replicated_curve(faces, curve_js, g0, data, 8, 512),
           "reset": replicated_curve(faces, reset_js, g0, data, 12, 512, reset_every=4)}
    # JAX's per-shard densify on each block, with the global observation flag
    cfg = jax_cfg(dens_js)
    assert isinstance(cfg, TrainConfig)
    local = 1024 // N_RANKS
    obs = jnp.any(jnp.asarray(count) > 0)
    blocks = []
    for s in range(N_RANKS):
        sl = slice(s * local, (s + 1) * local)
        gb = jax.tree_util.tree_map(lambda a: a[sl], g0)
        g2, _, _, nc = densify_prune_arrays(gb, jnp.asarray(accum[sl]), jnp.asarray(count[sl]),
                                            keys[s], max_new, cfg, window_observed=obs)
        blocks.append((g2, nc))
    ref["densify"] = {k: np.concatenate([np.asarray(getattr(b[0], k)) for b in blocks])
                      for k in g0._fields}
    ref["densify_count"] = np.concatenate([np.asarray(b[1]) for b in blocks])
    return world.wait(), ref


def test_sharded_trainer_tracks_replicated_curve_and_densifies(runs):
    """tests/test_multichip.py::test_sharded_trainer_matches_replicated_curve:
    8 steps of the sharded state (rows and Adam moments per rank) track the
    JAX replicated trainer's losses; a densify event grows the cloud per
    shard and training goes on finite."""
    out, ref = runs
    for r, res in enumerate(out["sharded_curve"]):
        np.testing.assert_allclose(res["losses"], ref["curve"], rtol=CURVE_REL,
                                   err_msg=f"rank {r}")
        assert ref["curve"][-1] < ref["curve"][0]
        before, after = res["alive"]
        assert after > before
        assert np.isfinite(res["loss_after"])
        assert int(res["local"]) == 1024 // N_RANKS
        np.testing.assert_array_equal(res["losses"], out["sharded_curve"][0]["losses"])


def test_sharded_densify_matches_jax_per_shard(runs):
    """Each shard densifies into its own dead slots from its own top-k, with
    the global observation flag: JAX's densify_prune_arrays on the shard's
    block with the shard's noise, every field."""
    out, ref = runs
    res = out["sharded_densify"][0]
    for k, want in ref["densify"].items():
        np.testing.assert_allclose(res["g_" + k], want, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(res["grad_count"], ref["densify_count"])
    for other in out["sharded_densify"][1:]:
        for k in res:
            np.testing.assert_array_equal(other[k], res[k])


def test_sharded_opacity_reset_tracks_replicated(runs):
    """::test_sharded_opacity_reset_tracks_replicated: three resets (every
    4 of 12 steps) keep the sharded curve on the replicated one."""
    out, ref = runs
    for res in out["sharded_reset"]:
        np.testing.assert_allclose(res["losses"], ref["reset"], rtol=CURVE_REL)


def test_sharded_compaction_is_exact_and_shrinks(runs):
    """::test_sharded_compaction_is_exact_and_shrinks: every shard moves its
    alive rows to the front in order (params and Adam moments bit for bit)
    and slices to the common local capacity of the fullest shard."""
    out, _ = runs
    res = out["sharded_compact"]
    keep = [int(r["n_keep"]) for r in res]
    want_local = int(np.ceil(max(keep) * jax_cfg(cfg_json()).compact_slack / 128) * 128)
    for r in res:
        assert int(r["local_after"]) == want_local < 2048 // N_RANKS
        np.testing.assert_array_equal(r["mu_after"], r["mu_before"])
        np.testing.assert_array_equal(r["nu_after"], r["nu_before"])
        assert int(r["alive_after"].sum()) == int(r["n_keep"])


def test_sharded_densify_reset_resume_cycle(runs):
    """::test_sharded_trainer_densify_reset_resume_cycle: densify at 20 and
    40, resets at 25 and 50, checkpoints at 15 / 30 / 60; a resume from 30
    equals the uninterrupted run, and a reset zeroes only the opacity
    group's moments."""
    out, _ = runs
    for r, res in enumerate(out["sharded_cycle"]):
        assert bool(res["has_meta"]) and int(res["it"]) == 30
        np.testing.assert_allclose(res["res_mu"], res["full_mu"], atol=1e-6)
        np.testing.assert_allclose(res["res_opac"], res["full_opac"], atol=1e-6)
        np.testing.assert_array_equal(res["res_alive"], res["full_alive"])
        assert list(res["steps"]) == [60, 60]
        assert np.abs(res["opac_nu_after"]).max() == 0 < np.abs(res["opac_nu_before"]).max()
        np.testing.assert_array_equal(res["pos_nu_after"], res["pos_nu_before"])


def test_sharded_chunked_loop_matches_per_step(runs):
    """::test_sharded_trainer_chunked_loop_matches_per_step: train()'s loop
    equals per-step calls on the same host stream of frame indices."""
    out, _ = runs
    for res in out["sharded_chunked"]:
        np.testing.assert_allclose(res["a_mu"], res["b_mu"], atol=1e-5)
        np.testing.assert_allclose(res["a_color"], res["b_color"], atol=1e-5)
        assert list(res["steps"]) == [60, 60]
