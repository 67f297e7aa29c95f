"""Frame data parallelism of the port on a gloo world of 4 CPU processes:
`AvatarTrainer(mesh=)` and the (data x gauss) `ShardedAvatarTrainer`, held
to the JAX package's replicated trainer on the same frames and initial cloud,
with every rank's replicated state equal bit for bit; checkpoints between
the sharded and the one-process trainers both ways and from the JAX
package's sharded trainer; and the 2-process smoke of
`python -m omfs4d_torch.parallel.distributed --smoke`, each process loading
only its frames."""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_multichip import _tiny_scene
from tests.test_torch_parallel_harness import ROOT, World, free_port, save
from tests.test_torch_parallel_train import cfg_json, data_arrays, g0_arrays, jax_cfg

N_RANKS = 4
S = 32
CURVE_REL = 2e-3


def jax_trainer(faces, js, K):
    from omfs4d.train.trainer import AvatarTrainer

    return AvatarTrainer(np.asarray(faces), jax_cfg(js), S, S, max_per_tile=K,
                         use_pallas="never")


def jax_state(rep, g0):
    """A fresh state of the cloud `g0` (the step donates its input)."""
    from omfs4d.train.trainer import float_fields

    g = jax.tree_util.tree_map(jnp.array, g0)
    st = rep.init_state(capacity=g0.capacity)._replace(gaussians=g)
    return st._replace(opt_state=rep.optimizer.init(float_fields(g)))


def random_frames(model, cam, B, seed):
    from omfs4d.models.flame import flame_forward

    rng = np.random.default_rng(seed)
    verts = flame_forward(model, {"shape": jnp.zeros(300), "expr": jnp.zeros((B, 100))})
    return {
        "images": jnp.asarray(rng.integers(0, 255, (B, S, S, 3)), jnp.uint8),
        "verts": verts,
        "w2c": jnp.tile(jnp.asarray(np.asarray(cam.w2c))[None], (B, 1, 1)),
        "fx": jnp.full((B,), cam.fx), "fy": jnp.full((B,), cam.fy),
        "cx": jnp.full((B,), cam.cx), "cy": jnp.full((B,), cam.cy),
    }


def two_pose_frames(model, cam):
    """2 frames of the textured avatar, the second with the jaw open."""
    from omfs4d.io.synthetic import textured_gt_avatar
    from omfs4d.models.flame import flame_forward
    from omfs4d.render.rasterize import render_avatar_frame

    gt_params = {"shape": jnp.zeros(300), "expr": jnp.zeros((2, 100)),
                 "jaw_pose": jnp.zeros((2, 3)).at[1, 0].set(0.2)}
    verts = flame_forward(model, gt_params)
    gt_avatar = textured_gt_avatar(model)
    images = np.stack([(np.clip(np.asarray(render_avatar_frame(
        gt_avatar, verts[i], model.faces, cam, S, S, backend="never", max_per_tile=512)[0]),
        0, 1) * 255).astype(np.uint8) for i in range(2)])
    return {"images": jnp.asarray(images), "verts": verts,
            "w2c": jnp.tile(jnp.asarray(np.asarray(cam.w2c))[None], (2, 1, 1)),
            "fx": jnp.full((2,), cam.fx), "fy": jnp.full((2,), cam.fy),
            "cx": jnp.full((2,), cam.cx), "cy": jnp.full((2,), cam.cy)}


def jax_checkpoint(tmp, faces, g0):
    """The JAX package's gaussian-sharded trainer writes a checkpoint of its
    state on its 4-device mesh (Adam moments made non-zero by one optimizer
    update of seeded gradients); it is read back by the JAX package and
    carried over with convert.py into the port's checkpoint format."""
    from jax.sharding import Mesh

    from omfs4d.parallel.sharded_trainer import ShardedAvatarTrainer
    from omfs4d.train.checkpoints import latest_checkpoint, restore_state
    from omfs4d.train.trainer import float_fields
    from omfs4d_torch.convert import train_state_from_jax
    from omfs4d_torch.train.checkpoints import save_state

    mesh = Mesh(np.asarray(jax.devices()[:N_RANKS]), ("gauss",))
    tr = ShardedAvatarTrainer(np.asarray(faces), jax_cfg(cfg_json(iterations=4)), S, S,
                              mesh=mesh, max_per_tile=512, use_pallas="never")
    st = tr.init_state(gaussians=jax.tree_util.tree_map(jnp.array, g0))
    fp = float_fields(st.gaussians)
    rng = np.random.default_rng(5)
    grads = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) for k, v in fp.items()}
    st = st._replace(opt_state=tr.optimizer.update(grads, st.opt_state, fp)[1])
    tr.save_checkpoint(st, tmp / "jax_run", 1)
    path, _ = latest_checkpoint(tmp / "jax_run")
    back = restore_state(path, template=st)
    save_state(tmp / "ckpt_jax", train_state_from_jax(back))
    return {"mu": np.asarray(back.gaussians.mu_local),
            "nu": np.asarray(back.opt_state.inner_states["pos"].inner_state[0].nu["mu_local"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel

    tmp = tmp_path_factory.mktemp("parallel_dp")
    model, cam, data1 = _tiny_scene(S)
    faces = np.asarray(model.faces)
    g0, g0a = g0_arrays(faces, 1024)

    dp_js = cfg_json(batch_frames=4)
    data4 = random_frames(model, cam, 4, seed=3)
    save(tmp, "frame_dp", cfg=dp_js, max_per_tile=128, size=S, faces=faces, batch=4, steps=4,
         **data_arrays(data4), **g0a)
    two_js = cfg_json(batch_frames=2)
    data2 = random_frames(model, cam, 2, seed=0)
    save(tmp, "frame_dp_pair", cfg=two_js, max_per_tile=512, size=S, faces=faces,
         **data_arrays(data2), **g0a)
    two = two_pose_frames(model, cam)
    fm = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=0))
    wrong = {"shape": np.zeros(300, np.float32), "expr": np.zeros((2, 100), np.float32),
             "rotation": np.zeros((2, 3), np.float32), "neck_pose": np.zeros((2, 3), np.float32),
             "jaw_pose": np.tile(np.float32([0.3, 0, 0]), (2, 1)),
             "eyes_pose": np.zeros((2, 6), np.float32),
             "translation": np.zeros((2, 3), np.float32)}
    save(tmp, "mesh_2d", cfg=two_js, max_per_tile=512, size=S, faces=faces,
         **data_arrays(two), **g0a,
         **{"flame_" + k: np.asarray(v) for k, v in fm._asdict().items()},
         **{"wrong_" + k: v for k, v in wrong.items()})
    ckpt = jax_checkpoint(tmp, faces, g0)
    save(tmp, "checkpoints", cfg=cfg_json(iterations=4), max_per_tile=512, size=S, faces=faces,
         **data_arrays(data1), **g0a)

    world = World(N_RANKS, tmp).run("frame_dp", "frame_dp_pair", "mesh_2d", "checkpoints")
    port = free_port()
    smoke = [subprocess.Popen(
        [sys.executable, "-m", "omfs4d_torch.parallel.distributed", "--smoke",
         "--process-id", str(r), "--num-processes", "2", "--port", str(port),
         "--out", str(tmp / f"smoke_{r}.txt")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
        for r in range(2)]

    ref = {}
    rep = jax_trainer(faces, dp_js, 128)
    st = jax_state(rep, g0)
    ref["dp_losses"] = []
    idx = jnp.arange(4, dtype=jnp.int32)
    for _ in range(4):
        st, m = rep._step_fn(st, data4, idx)
        ref["dp_losses"].append(float(m["loss"]))
    ref["dp_color"] = np.asarray(st.gaussians.color)
    # one compiled 2-frame step serves the pair and the 2 x 2 mesh's reference
    rep = jax_trainer(faces, two_js, 512)
    st, m = rep._step_fn(jax_state(rep, g0), data2, jnp.arange(2, dtype=jnp.int32))
    ref["pair"] = (float(m["loss"]), np.asarray(st.gaussians.color))
    st = jax_state(rep, g0)
    ref["two_losses"] = []
    for _ in range(4):
        st, m = rep._step_fn(st, two, jnp.arange(2, dtype=jnp.int32))
        ref["two_losses"].append(float(m["loss"]))
    ref["jax_ckpt"] = ckpt
    smoke_logs = [p.communicate(timeout=240)[0] for p in smoke]
    assert all(p.returncode == 0 for p in smoke), smoke_logs
    ref["smoke"] = [ast.literal_eval((tmp / f"smoke_{r}.txt").read_text()) for r in range(2)]
    return world.wait(), ref


def test_frame_dp_mesh_trainer_matches_unsharded(runs):
    """tests/test_multichip.py::test_frame_dp_mesh_trainer_matches_unsharded:
    4 frames over 4 ranks, 4 steps, against the JAX trainer on the whole
    batch; every rank's replicated state (gaussians, Adam, accumulators)
    equal bit for bit after them."""
    out, ref = runs
    for r, res in enumerate(out["frame_dp"]):
        np.testing.assert_allclose(res["losses"], ref["dp_losses"], atol=1e-4,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(res["color"], ref["dp_color"], atol=1e-3)
        np.testing.assert_array_equal(res["state_bytes"], out["frame_dp"][0]["state_bytes"])


def test_dp_gradients_match_single_device(runs):
    """::test_dp_gradients_match_single_device: one step of 2 frames on a
    mesh of ranks 0 and 1 (ranks 2 and 3 outside it) equals the JAX step."""
    out, ref = runs
    loss, color = ref["pair"]
    assert out["frame_dp_pair"][2] is None and out["frame_dp_pair"][3] is None
    for res in out["frame_dp_pair"][:2]:
        assert abs(float(res["loss"]) - loss) < 1e-5
        np.testing.assert_allclose(res["color"], color, atol=1e-4)


def test_2d_data_gauss_sharded_trainer(runs):
    """::test_2d_data_gauss_sharded_trainer on a 2 x 2 mesh: each data row
    fits its own frame against 2 gaussian shards; the loss curve follows the
    JAX replicated trainer's on the 2-frame batch, and FLAME co-optimization
    pulls a wrong jaw toward the true one through the collectives' transposes,
    every rank's state equal bit for bit."""
    out, ref = runs
    for r, res in enumerate(out["mesh_2d"]):
        np.testing.assert_allclose(res["losses"], ref["two_losses"], rtol=CURVE_REL,
                                   err_msg=f"rank {r}")
        assert np.isfinite(float(res["loss_f"]))
        jaw = res["jaw"][:, 0]
        assert (np.abs(jaw) < 0.3 - 1e-3).all(), jaw
    # the replicas of each gauss shard, across the data rows
    for a, b in ((0, 2), (1, 3)):
        np.testing.assert_array_equal(out["mesh_2d"][a]["state_bytes"],
                                      out["mesh_2d"][b]["state_bytes"])


def test_checkpoints_travel_between_trainers(runs):
    """The sharded trainer's checkpoint (gathered, written by rank 0) loads
    in the one-process trainer; the one-process trainer's loads in the
    sharded one, re-sharded; the JAX package's gaussian-sharded trainer's
    checkpoint, carried over by convert.py, loads sharded and trains on."""
    out, ref = runs
    res = out["checkpoints"]
    r0 = res[0]
    assert int(r0["one_read_it"]) == 3
    for k in ("parent_face", "mu_local", "opacity_logit", "sh", "alive"):
        np.testing.assert_array_equal(r0["one_read_" + k], r0["sharded_g_" + k])
    per = 1024 // N_RANKS
    for r, rr in enumerate(res):
        assert int(rr["sharded_read_it"]) == 4
        for k in ("mu_local", "color", "alive"):
            np.testing.assert_array_equal(rr["sharded_read_g_" + k], r0["one_wrote_" + k])
        sl = slice(r * per, (r + 1) * per)
        np.testing.assert_array_equal(rr["jax_local_mu"], ref["jax_ckpt"]["mu"][sl])
        np.testing.assert_array_equal(rr["jax_local_nu"], ref["jax_ckpt"]["nu"][sl])
        assert np.isfinite(float(rr["jax_step_loss"]))


def test_multiprocess_smoke_each_process_loads_its_frames(runs):
    """::test_multiprocess_spmd_train: 2 processes, each holding only its
    frames (`make_global_batch`), train frame-DP with the same losses on
    both, and the loss falls."""
    _, ref = runs
    a, b = ref["smoke"]
    assert a == b and len(a) == 3 and a[-1] < a[0]
