"""The surgical-prediction render slice as a whole: the JAX package and the
port render the same modified dataset with the same avatar, on the CPU.

128^2, a 700-vertex synthetic FLAME asset, the per-face avatar replicated
with seeded jitter to 2,000 gaussians (SH degree 3), K = 128, 3 frames,
Le Fort 5 mm / BSSO 3 mm.  Equal depth keys may be ordered differently by
the two packages' sorts, so images are compared on the tiles whose lists
are identical in both (asserted to be nearly all of them): float images at
atol 1e-4 before quantisation, the decoded PNGs within 1 grey level.
"""

import importlib
import inspect
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omfs4d.models.flame import FlameModel as JFlame
from omfs4d.models.flame import flame_forward as j_flame_forward
from omfs4d.io.dataset import FrameDataset as JDataset
from omfs4d.models.gaussians import GaussianAvatar as JGaussians
from omfs4d.models.gaussians import bind_to_mesh as j_bind
from omfs4d.ops.camera import project_gaussians as j_project
from omfs4d.predict.render_video import render_dataset_frames as j_render_frames
from omfs4d.render.rasterize import render_avatar_frame as j_render_frame
from omfs4d.train.checkpoints import export_point_cloud as j_export
from omfs4d.train.checkpoints import load_point_cloud as j_load
from omfs4d_torch.convert import to_numpy
from omfs4d_torch.io.dataset import FrameDataset
from omfs4d_torch.io.synthetic import make_synthetic_dataset, textured_gt_avatar
from omfs4d_torch.io.video import read_image
from omfs4d_torch.models.flame import flame_forward as t_flame_forward
from omfs4d_torch.models.gaussians import bind_to_mesh as t_bind
from omfs4d_torch.ops.camera import project_gaussians as t_project
from omfs4d_torch.predict import render_video as trv
from omfs4d_torch.predict.surgery import compute_offset, create_modified_dataset
from omfs4d_torch.render.rasterize import bin_gaussians as t_bin
from omfs4d_torch.render.rasterize import render_avatar_frame as t_render_frame
from omfs4d_torch.train.checkpoints import load_point_cloud as t_load

jr = importlib.import_module("omfs4d.render.rasterize")

SIZE, N_FRAMES, N_VERTICES, N_GAUSSIANS, K, WINDOW = 128, 3, 700, 2000, 128, 16
TILE = 16


def replicated_avatar(model):
    """bench.py's recipe at test scale, with small random SH so the
    view-dependent colour is exercised."""
    g0 = to_numpy(textured_gt_avatar(model))
    F = len(g0["alive"])
    reps = int(np.ceil(N_GAUSSIANS / F))
    idx = np.tile(np.arange(F), reps)[:N_GAUSSIANS]
    rng = np.random.default_rng(0)
    return {
        "parent_face": g0["parent_face"][idx],
        "mu_local": g0["mu_local"][idx] + rng.normal(0, 0.3, (N_GAUSSIANS, 3)).astype(np.float32),
        "quat_local": g0["quat_local"][idx],
        "log_scale": g0["log_scale"][idx] - np.log(reps ** 0.5),
        "opacity_logit": g0["opacity_logit"][idx] - 1.5,
        "color": g0["color"][idx],
        "sh": rng.normal(0, 0.05, (N_GAUSSIANS, 15, 3)).astype(np.float32),
        "alive": np.ones(N_GAUSSIANS, bool),
    }


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    data = make_synthetic_dataset(root / "data", n_frames=N_FRAMES, width=SIZE,
                                  height=SIZE, n_vertices=N_VERTICES, seed=0, device="cpu")
    t_model = data["model"]
    fields = {k: v.numpy() for k, v in t_model.named_buffers()}
    j_model = JFlame(**fields)
    # the avatar travels as the trained model's PLY: written by the JAX
    # package, read by both
    model_dir = root / "model"
    j_avatar = JGaussians(**{k: jnp.asarray(v) for k, v in replicated_avatar(t_model).items()})
    ply = model_dir / "point_cloud" / "iteration_5000" / "point_cloud.ply"
    j_export(ply, j_avatar)
    (model_dir / "checkpoints").mkdir(parents=True)
    (model_dir / "checkpoints" / "iter_0005000_meta.json").write_text(
        json.dumps({"max_per_tile": K, "max_tiles_per_gaussian": WINDOW}))
    modified = create_modified_dataset(str(data["path"]), compute_offset(5.0, 1.0),
                                       compute_offset(3.0, 1.0))
    yield dict(root=root, data=data["path"], modified=Path(modified), model_dir=model_dir,
               ply=ply, j_model=j_model, t_model=t_model)
    shutil.rmtree(modified, ignore_errors=True)


def tile_mask(same_tiles):
    """(T,) bool per 16-px tile -> (H, W) bool per pixel."""
    g = SIZE // TILE
    return np.kron(same_tiles.reshape(g, g), np.ones((TILE, TILE), bool)).astype(bool)


def same_list_tiles(jb, tb):
    counts_j, counts_t = np.asarray(jb.tile_counts), tb.tile_counts.numpy()
    lists_j, lists_t = np.asarray(jb.tile_lists), tb.tile_lists.numpy()
    return np.array([counts_j[t] == counts_t[t]
                     and np.array_equal(lists_j[t, :counts_j[t]], lists_t[t, :counts_t[t]])
                     for t in range(len(counts_j))])


def test_render_slice_matches_jax(case):
    j_g = j_load(case["ply"])
    t_g = t_load(case["ply"])
    kw = dict(max_per_tile=K, max_tiles_per_gaussian=WINDOW)
    j_out, t_out = case["root"] / "j", case["root"] / "t"
    j_render_frames(case["j_model"], j_g, case["modified"], j_out / "renders",
                    out_gt=j_out / "gt", backend="never", **kw)
    trv.render_dataset_frames(case["t_model"], t_g, case["modified"], t_out / "renders",
                              out_gt=t_out / "gt", **kw)

    ds = FrameDataset(case["modified"])
    batched = trv.batched_frame_params(ds)
    vj = j_flame_forward(case["j_model"], {k: jnp.asarray(v) for k, v in batched.items()})
    with torch.inference_mode():
        vt = t_flame_forward(case["t_model"], batched)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5)

    jds = JDataset(case["modified"])
    n_same = 0
    for i in range(N_FRAMES):
        jcam, tcam = jds.camera(i), ds.camera(i)
        means, rot, scales, opac, _ = j_bind(j_g, vj[i], case["j_model"].faces)
        jproj = j_project(jcam, means, rot, scales)
        jb = jr.bin_gaussians(jproj, opac, SIZE, SIZE, large_frac=1.0, **kw)
        with torch.inference_mode():
            tm, trot, tsc, top, _ = t_bind(t_g, vt[i], case["t_model"].faces)
            tb = t_bin(t_project(tcam, tm, trot, tsc), top, SIZE, SIZE, large_frac=1.0, **kw)
            img_t, aux_t = t_render_frame(t_g, vt[i], case["t_model"].faces, tcam,
                                          SIZE, SIZE, large_frac=1.0, **kw)
        img_j, aux_j = j_render_frame(j_g, vj[i], case["j_model"].faces, jcam, SIZE, SIZE,
                                      backend="never", large_frac=1.0, **kw)
        same = same_list_tiles(jb, tb)
        assert same.mean() >= 0.9, f"frame {i}: lists agree on only {same.mean():.2f} of tiles"
        n_same += int(same.sum())
        m = tile_mask(same)
        np.testing.assert_allclose(img_t.numpy()[m], np.asarray(img_j)[m], atol=1e-4)
        np.testing.assert_allclose(aux_t["alpha"].numpy()[m], np.asarray(aux_j["alpha"])[m],
                                   atol=1e-4)
        assert (aux_t["alpha"].numpy() > 0.5).mean() > 0.05
        name = f"{i:05d}.png"
        png_t = read_image(t_out / "renders" / name).astype(int)
        png_j = read_image(j_out / "renders" / name).astype(int)
        assert np.abs(png_t - png_j)[m].max() <= 1
        np.testing.assert_array_equal(read_image(t_out / "gt" / name),
                                      read_image(j_out / "gt" / name))
    assert n_same > 0


def test_render_prediction_end_to_end(case, monkeypatch, tmp_path):
    stitched = {}

    def fake_stitch(frames_dir, output, fps=30):
        stitched["frames"] = sorted(Path(frames_dir).glob("*.png"))
        Path(output).write_bytes(b"")
        return Path(output)

    monkeypatch.setattr(trv, "stitch_video", fake_stitch)
    model_dir = tmp_path / "model"
    shutil.copytree(case["model_dir"], model_dir)
    result = trv.render_prediction(model_dir, case["data"], case["t_model"],
                                   output=tmp_path / "pred.mp4", lefort_mm=5.0,
                                   bsso_mm=3.0, device="cpu")
    assert result["iteration"] == 5000 and len(stitched["frames"]) == N_FRAMES
    assert abs(result["lefort_offset"] - 0.005) < 1e-12
    # same avatar, same plan, same K and window as the direct render
    direct = case["root"] / "direct"
    trv.render_dataset_frames(case["t_model"], t_load(case["ply"]), case["modified"],
                              direct, max_per_tile=K, max_tiles_per_gaussian=WINDOW)
    for png in stitched["frames"]:
        np.testing.assert_array_equal(read_image(png), read_image(direct / png.name))
    with pytest.raises(NotImplementedError):
        trv.render_dataset_frames(case["t_model"], t_load(case["ply"]), case["modified"],
                                  tmp_path / "x", n_tile=2)


def test_render_prediction_defaults_to_the_card_and_raises_without_one(case, monkeypatch,
                                                                      tmp_path):
    """With no `device` the request runs on the CUDA card; with no card it
    raises before it touches the model or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert inspect.signature(trv.render_prediction).parameters["device"].default == "cuda"
    before = case["t_model"].v_template.device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trv.render_prediction(case["model_dir"], case["data"], case["t_model"],
                              output=tmp_path / "pred.mp4", lefort_mm=5.0, bsso_mm=3.0)
    assert case["t_model"].v_template.device == before
    assert not (tmp_path / "pred.mp4").exists()
