"""The sharded branches of the port's pipeline and tracker on a gloo world
of 2 CPU processes, each rank running the same calls (SPMD):

  * `FlameTracker(mesh=)`: a landmark stage and an rgb stage against the
    same stages without a mesh (loss rel 2e-3, parameters atol 1e-4), every
    rank's parameters equal bit for bit;
  * `Pipeline.track` with parallel.n_data = 2, against a one-process track;
    `Pipeline.train` with n_gauss = 2 and with n_data = 2, and the
    RuntimeError of n_data x n_gauss = 2x2 on 2 ranks; `train` with only
    n_tile = 2 on rank 0 alone, rank 1 writing nothing; `render_surgery` with
    n_tile = 2 (`render_prediction` tile-sharded) against the one-process
    render; rank 0 alone writes;
  * the CLI under the environment torchrun sets, `parallel.n_gauss=2`.

The harness is test_torch_parallel_harness; the one-process references run
here, in the test process."""

import json

import numpy as np
import pytest
import torch

from omfs4d_torch.io import video as tvideo
from omfs4d_torch.io.dataset import FrameDataset
from tests.test_torch_parallel_harness import World, save

N_RANKS = 2
S = 32
TRACK = dict(n_shape=10, n_expr=10, texture_res=16, steps_lmk_init_rigid=10,
             steps_lmk_init_all=10, steps_rgb_init_texture=2, steps_rgb_init_all=2,
             steps_rgb_init_offset=1, steps_rgb_sequential=1, steps_global=2,
             epochs_global=1)


def small_case(tmp, n_frames=4):
    """A 32^2 synthetic dataset on the 700-vertex asset, and a capture of
    its frames (`frames/images/*.png` with the true landmarks beside them)."""
    from omfs4d_torch.io.synthetic import make_synthetic_dataset
    from omfs4d_torch.models.flame import flame_forward, flame_landmarks
    from omfs4d_torch.ops.camera import project_points

    case = make_synthetic_dataset(tmp / "data", n_frames=n_frames, width=S, height=S,
                                  n_vertices=700, seed=0, device="cpu")
    ds = FrameDataset(case["path"])
    images = tmp / "frames" / "images"
    images.mkdir(parents=True)
    for i in range(len(ds)):
        tvideo.write_image(images / f"{i:05d}.png", ds.load_image(i).astype(np.float32) / 255)
    with torch.no_grad():
        verts = flame_forward(case["model"], {k: torch.as_tensor(v) for k, v in
                                              case["params"].items() if k != "dynamic_offset"})
        uv, _ = project_points(ds.camera(0), flame_landmarks(case["model"], verts))
    np.savez(images / "landmarks.npz", landmarks=uv.numpy(), valid=np.ones(len(ds), bool))
    return case


def small_pipeline(workdir, **parallel):
    """The pipeline the workers build (test_torch_parallel_harness._pipeline),
    in this process."""
    from tests.test_torch_parallel_harness import _pipeline

    return _pipeline({"track_cfg": json.dumps(TRACK)}, workdir, **parallel)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from omfs4d_torch.convert import to_numpy
    from omfs4d_torch.models.assets import synthetic_flame_asset
    from omfs4d_torch.models.flame import FlameModel
    from omfs4d_torch.ops.camera import look_at_camera

    tmp = tmp_path_factory.mktemp("parallel_pipeline")
    small_case(tmp)
    # the tracker's stages: 5 frames (blocks of 2 and 3) of a moving head
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=300, seed=0))
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * S, width=S, height=S)
    rng = np.random.default_rng(0)
    lmk = (S / 2 + rng.normal(0, S / 6, (5, 68, 2))).astype(np.float32)
    frames = rng.integers(0, 255, (5, S, S, 3)).astype(np.uint8)
    track_cfg = json.dumps(dict(TRACK, use_dynamic_offset=True))
    save(tmp, "track_stages", landmarks=lmk, valid=np.array([1, 1, 0, 1, 1], bool),
         frames=frames, size=S, track_cfg=track_cfg,
         **{k: np.asarray(v, np.float32) for k, v in to_numpy(cam).items()
            if k not in ("width", "height")},
         **{"flame_" + k: v for k, v in to_numpy(model).items()})
    save(tmp, "pipeline", track_cfg=json.dumps(TRACK))
    env = {"OMFS4D_CACHE": str(tmp / "cache")}
    world = World(N_RANKS, tmp).run("collectives", "track_stages", "pipeline", env=env)
    out = world.wait()
    cli = World(N_RANKS, tmp).run("cli_train", env=env).wait()
    return tmp, out, cli


def test_collectives_and_their_transposes(runs):
    """Each collective of `parallel.collectives` on 2 ranks (x = rank + 1 on
    each), with the transpose derived from "the global loss is computed
    once": all_gather hands back this rank's slice of the cotangent,
    all_to_all's rides back, a replicated input sums the ranks' cotangents,
    psum passes it through and pmean divides it by n, pmin / pmax carry none,
    the halo sends it to the previous rank.  An all-reduce gives both ranks
    the same bits; the mesh helpers pad, shard and broadcast."""
    _, out, _ = runs
    r0, r1 = out["collectives"]
    for rank, r in enumerate((r0, r1)):
        np.testing.assert_array_equal(r["gather"], [[1.0] * 3, [2.0] * 3])
        np.testing.assert_array_equal(r["gather_grad"], [float(rank)] * 3)
        assert float(r["psum"]) == 9.0 and float(r["pmean"]) == 4.5
        np.testing.assert_array_equal(r["psum_grad"], [1.0] * 3)
        np.testing.assert_array_equal(r["pmean_grad"], [0.5] * 3)
        assert float(r["pmin"]) == 3.0 and float(r["pmax"]) == 6.0
        np.testing.assert_array_equal(r["replicated_grad"], [3.0] * 3)   # 1 + 2
        np.testing.assert_array_equal(r["replicate"], [1.0, 1.0])
    # rank i receives row i of each rank's (10 x, 100 x)
    np.testing.assert_array_equal(r0["a2a"], [[10.0] * 3, [20.0] * 3])
    np.testing.assert_array_equal(r1["a2a"], [[100.0] * 3, [200.0] * 3])
    # d/dx of sum(recv * [1, 2]): rank 0's x went out as 10x (to 0, weight 1)
    # and 100x (to 1, weight 1); rank 1's as 10x (to 0, weight 2), 100x (weight 2)
    np.testing.assert_array_equal(r0["a2a_grad"], [110.0] * 3)
    np.testing.assert_array_equal(r1["a2a_grad"], [220.0] * 3)
    np.testing.assert_array_equal(r0["halo"], [0.0] * 3)
    np.testing.assert_array_equal(r1["halo"], [2.0] * 3)
    np.testing.assert_array_equal(r0["halo_grad"], [6.0] * 3)
    np.testing.assert_array_equal(r1["halo_grad"], [0.0] * 3)
    np.testing.assert_array_equal(r0["shard_frames"], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(r1["shard_frames"], [3.0, 4.0, 0.0])
    np.testing.assert_array_equal(r0["allreduce_bits"], r1["allreduce_bits"])
    np.testing.assert_array_equal(r0["solo"], [[1.0] * 3])
    np.testing.assert_array_equal(r0["grid"], [0, 0])
    np.testing.assert_array_equal(r1["grid"], [1, 1])


def test_tracker_stages_on_a_frame_mesh_equal_one_process(runs):
    """FlameTracker(mesh=) on 2 ranks: each rank's landmark, regularizer and
    rgb terms of its block of frames (the halo frame from its neighbour),
    all-reduced gradients; the stages' losses and parameters equal the
    unsharded tracker's, on every rank, bit for bit between them."""
    _, out, _ = runs
    res = out["track_stages"]
    for r in res:
        np.testing.assert_allclose(r["sharded_losses"], r["one_losses"], rtol=2e-3)
        for k in [k[4:] for k in r if k.startswith("one_") and k != "one_losses"]:
            np.testing.assert_allclose(r["sharded_" + k], r["one_" + k], atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(res[0]["state_bytes"], res[1]["state_bytes"])


def test_pipeline_tracks_with_frame_sharding(runs):
    """Pipeline.track with parallel.n_data = 2 on 2 ranks: rank 0 writes the
    dataset, and its FLAME params equal a one-process track's."""
    tmp, out, _ = runs
    r0, r1 = out["pipeline"]
    assert str(r0["track_dir"]) == str(r1["track_dir"])
    sharded = FrameDataset(str(r0["track_dir"])).flame_params
    one_dir = small_pipeline(tmp / "work_one_track").track(
        tmp / "frames", FrameDataset(tmp / "data").camera(0), landmark_method="file")
    one = FrameDataset(one_dir).flame_params
    for k in ("expr", "rotation", "jaw_pose", "translation", "shape"):
        np.testing.assert_allclose(sharded[k], one[k], atol=1e-4, err_msg=k)


def test_pipeline_trains_gaussian_sharded_and_frame_parallel(runs):
    """Pipeline.train with n_gauss = 2 and with n_data = 2 on 2 ranks: the
    checkpoints, the point cloud of the whole cloud (gathered by rank 0) and
    the manifest; with n_data x n_gauss = 2x2 on 2 ranks a RuntimeError
    names the counts."""
    tmp, out, _ = runs
    for name, capacity in (("gauss", 4096), ("data", None)):
        model_dir = tmp / f"model_{name}"
        assert (model_dir / "point_cloud" / "iteration_6" / "point_cloud.ply").exists()
        meta = json.loads((model_dir / "checkpoints" / "iter_0000006_meta.json").read_text())
        if capacity:
            assert meta["capacity"] == capacity
        assert any((model_dir / "experiment_manifests").iterdir())
    events = [json.loads(line) for line in
              (tmp / "work_gauss" / "events.jsonl").read_text().splitlines()]
    assert any(e["event"] == "train_step" for e in events)
    for r in out["pipeline"]:
        assert "2x2 but only 2 ranks" in str(r["both_error"])


def test_pipeline_trains_on_rank_0_alone_without_a_training_mesh(runs):
    """Pipeline.train with only n_tile = 2 on 2 ranks (the render is sharded,
    training is not): rank 0 trains and writes the model, rank 1 writes
    nothing under the model directory and waits for it."""
    tmp, out, _ = runs
    r0, r1 = out["pipeline"]
    assert (tmp / "model_tile" / "point_cloud" / "iteration_4" / "point_cloud.ply").exists()
    assert any("point_cloud.ply" in w for w in r0["tile_train_writes"].tolist())
    assert r1["tile_train_writes"].tolist() == []


def test_render_surgery_tile_sharded_equals_one_process(runs):
    """render_surgery with n_tile = 2 on 2 ranks renders each frame as two
    tile slabs (rank 0 writes the PNGs); a one-process render of the same
    model is equal within a grey level."""
    from omfs4d_torch.predict.render_video import render_prediction

    tmp, out, _ = runs
    renders = sorted(tvideo.Path(str(out["pipeline"][0]["renders_dir"])).glob("*.png"))
    assert len(renders) == 4
    sharded = [tvideo.read_image(p).astype(int) for p in renders]
    pipe = small_pipeline(tmp / "work_one_render")
    res = render_prediction(tmp / "model_gauss", tmp / "data", pipe.model,
                            output=tmp / "one.mp4", lefort_mm=5.0, bsso_mm=3.0, device="cpu",
                            max_per_tile=128)
    one = [tvideo.read_image(p).astype(int)
           for p in sorted(tvideo.Path(res["renders_dir"]).glob("*.png"))]
    for a, b in zip(sharded, one):
        assert np.abs(a - b).max() <= 1


def test_cli_under_torchrun_trains_gaussian_sharded(runs):
    """`cli train ... parallel.n_gauss=2` in the environment torchrun gives
    each of 2 processes: the CLI joins a gloo group of 2 itself (the CPU
    asked for) and the model is written once."""
    tmp, _, cli = runs
    for r in cli["cli_train"]:
        assert int(r["world"]) == 2 and str(r["backend"]) == "gloo"
    assert (tmp / "model_cli" / "point_cloud" / "iteration_4" / "point_cloud.ply").exists()
