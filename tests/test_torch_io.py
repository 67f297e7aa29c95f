"""The port's host-side IO against the JAX package's, on the CPU: the PNG
codec (against cv2), PLY point clouds and datasets across both packages,
and the surgical-plan invariants of tests/test_predict.py."""

import json
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omfs4d.io import dataset as jd
from omfs4d.io.video import write_image as j_write_image
from omfs4d.models import gaussians as jg
from omfs4d.train import checkpoints as jck
from omfs4d_torch.convert import gaussians_from_numpy, to_numpy
from omfs4d_torch.io import dataset as td
from omfs4d_torch.io import video as tv
from omfs4d_torch.io.ply import load_ply, save_ply
from omfs4d_torch.predict import surgery as ts
from omfs4d_torch.train import checkpoints as tck


def smooth_image(h, w, c, seed=0):
    """A render-like image (gradients plus noise) so cv2 picks every filter."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 3 + yy * (k + 1)) % 256 for k in range(c)], -1)
    return ((base + rng.integers(0, 12, base.shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_roundtrip(channels):
    img = smooth_image(19, 23, channels)
    got = tv.decode_png(tv.encode_png(img))
    np.testing.assert_array_equal(got, img.reshape(19, 23, channels))


@pytest.mark.parametrize("shape", [(33, 47, 3), (33, 47)], ids=["rgb", "gray"])
@pytest.mark.parametrize("level", [0, 1, 9])
def test_png_reads_cv2_and_cv2_reads_port(tmp_path, shape, level):
    img = smooth_image(*shape[:2], 3, seed=level)
    img = img if len(shape) == 3 else img[..., 0]
    bgr = img[..., ::-1] if img.ndim == 3 else img
    cv2.imwrite(str(tmp_path / "cv2.png"), bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])
    rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    np.testing.assert_array_equal(tv.read_image(tmp_path / "cv2.png"), rgb)
    tv.write_image(tmp_path / "port.png", img)
    back = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back, bgr)


def test_write_image_float_conversion_matches_jax(tmp_path):
    rgb = np.random.default_rng(1).uniform(-0.1, 1.1, (9, 11, 3)).astype(np.float32)
    j_write_image(tmp_path / "j.png", rgb)
    tv.write_image(tmp_path / "t.png", rgb)
    np.testing.assert_array_equal(tv.read_image(tmp_path / "j.png"),
                                  tv.read_image(tmp_path / "t.png"))
    with pytest.raises(FileNotFoundError):
        tv.read_image(tmp_path / "missing.png")


def test_stitch_video_without_ffmpeg_raises(tmp_path, monkeypatch):
    """With no ffmpeg an `.mp4` gets the ladder's first rung, H.264 (`avc1`),
    and an `.avi` its last, Motion JPEG, as does a frame with an odd side,
    which H.264 cannot hold; `NoFFmpegError` where nothing can be written: a
    frame wider than JPEG's 65,535 pixels."""
    from omfs4d_torch.io import container

    frames = tmp_path / "frames"
    tv.write_image(frames / "00000.png", np.zeros((4, 4, 3), np.uint8))
    odd = tmp_path / "odd"
    tv.write_image(odd / "00000.png", np.zeros((5, 4, 3), np.uint8))
    monkeypatch.setattr(tv, "find_ffmpeg", lambda: None)
    for src, name, codec, size in ((frames, "out.mp4", "h264", (4, 4)),
                                   (frames, "out.avi", "mjpeg", (4, 4)),
                                   (odd, "odd.mp4", "mjpeg", (4, 5))):
        out = tv.stitch_video(src, tmp_path / name)
        info = container.index(out)[2]
        assert out == tmp_path / name and (info["container"], info["codec"]) == (name[-3:],
                                                                                  codec)
        assert tv.probe_video(out) == {"width": size[0], "height": size[1], "fps": 30.0,
                                       "frame_count": 1}
    wide = tmp_path / "wide"
    tv.write_image(wide / "00000.png", np.zeros((1, 65536, 3), np.uint8))
    with pytest.raises(tv.NoFFmpegError, match="ffmpeg"):
        tv.stitch_video(wide, tmp_path / "wide.mp4")
    assert not (tmp_path / "wide.mp4").exists()
    assert tv.ffmpeg_stitch_cmd("ff", "p_%05d.png", "o.mp4", 30)[-1] == "o.mp4"


def jax_avatar(n=64, seed=0):
    rng = np.random.default_rng(seed)
    faces = np.arange(30, dtype=np.int32).reshape(10, 3)
    g = jg.init_gaussians_on_mesh(faces, n, seed=seed)
    return g._replace(
        mu_local=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)),
        sh=jnp.asarray(rng.normal(size=(n, 15, 3)).astype(np.float32)),
        opacity_logit=jnp.asarray(rng.normal(size=n).astype(np.float32)),
        alive=jnp.asarray(np.arange(n) % 5 != 0))


def test_point_cloud_roundtrip_across_packages(tmp_path):
    g = jax_avatar()
    alive = np.asarray(g.alive)
    jck.export_point_cloud(tmp_path / "j.ply", g)
    port = to_numpy(tck.load_point_cloud(tmp_path / "j.ply"))
    for name, value in jax.tree_util.tree_map(np.asarray, g)._asdict().items():
        np.testing.assert_array_equal(port[name], value[alive], err_msg=name)
    # and back: the port's export loads in the JAX package
    tck.export_point_cloud(tmp_path / "t.ply", gaussians_from_numpy(port))
    back = jck.load_point_cloud(tmp_path / "t.ply", capacity=80)
    back_port = to_numpy(tck.load_point_cloud(tmp_path / "t.ply", capacity=80))
    for name, value in back._asdict().items():
        np.testing.assert_array_equal(back_port[name], np.asarray(value), err_msg=name)
    assert back_port["alive"].sum() == alive.sum() and back_port["quat_local"][-1, 0] == 1


def test_ply_ascii_faces_and_checkpoint_meta(tmp_path):
    verts = np.random.default_rng(2).normal(size=(5, 3)).astype(np.float32)
    faces = np.array([[0, 1, 2], [2, 3, 4]])
    for binary in (True, False):
        save_ply(tmp_path / "m.ply", verts, faces=faces, binary=binary)
        got = load_ply(tmp_path / "m.ply")
        np.testing.assert_allclose(np.stack([got["vertex"][k] for k in "xyz"], 1),
                                   verts, rtol=1e-5)
        np.testing.assert_array_equal(got["face"], faces)
    ck = tmp_path / "checkpoints"
    ck.mkdir()
    for it, k in ((100, 128), (5000, 256)):
        (ck / f"iter_{it:07d}_meta.json").write_text(json.dumps({"max_per_tile": k}))
    (tmp_path / "point_cloud" / "iteration_100").mkdir(parents=True)
    (tmp_path / "point_cloud" / "iteration_5000").mkdir(parents=True)
    for it in (None, 100):
        assert tck.trained_render_meta(tmp_path, it) == jck.trained_render_meta(tmp_path, it)
    assert tck.latest_iteration(tmp_path) == jck.latest_iteration(tmp_path) == 5000
    assert tck.trained_render_meta(tmp_path / "nowhere") == {}


def write_small_dataset(write_dataset, root, T=3, h=20, w=24):
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (T, h, w, 3)).astype(np.uint8)
    masks = rng.uniform(size=(T, h, w)) > 0.5
    params = jd.default_flame_params(T, n_verts=50)
    params["jaw_pose"][:, 0] = np.arange(T) * 0.1
    c2w = np.tile(np.eye(4), (T, 1, 1))
    c2w[:, 2, 3] = 0.6
    write_dataset(root, images, c2w, 40.0, 41.0, 12.0, 10.0, flame_params=params,
                  masks=masks, points3d=rng.normal(size=(7, 3)), n_verts=50)
    return images, masks, params


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dataset_readable_by_both_packages(tmp_path, writer):
    write = jd.write_dataset if writer == "jax" else td.write_dataset
    images, masks, params = write_small_dataset(write, tmp_path)
    jds, tds = jd.FrameDataset(tmp_path), td.FrameDataset(tmp_path)
    assert len(tds) == len(jds) == 3 and tds.intrinsics == jds.intrinsics
    for i in range(len(tds)):
        np.testing.assert_array_equal(tds.load_image(i), images[i])
        np.testing.assert_array_equal(tds.load_image(i), jds.load_image(i))
        np.testing.assert_array_equal(tds.load_mask(i), masks[i].astype(np.float32))
        for k, v in jds.load_frame_params(i).items():
            np.testing.assert_array_equal(tds.load_frame_params(i)[k], v)
        np.testing.assert_array_equal(tds.camera(i).w2c.numpy(), np.asarray(jds.camera(i).w2c))
        assert float(tds.camera(i).fy) == float(jds.camera(i).fy)
    np.testing.assert_array_equal(tds.points3d(), jds.points3d())
    np.testing.assert_array_equal(tds.flame_params["jaw_pose"], params["jaw_pose"])


# ── predict/surgery.py: the invariants of tests/test_predict.py ──────────

@pytest.mark.parametrize("mm,sens,want", [(0.0, 1.0, 0.0), (5.0, 1.0, 0.005),
                                          (-3.0, 1.0, -0.003), (5.0, 2.5, 0.0125),
                                          (10.0, 0.0, 0.0)])
def test_compute_offset(mm, sens, want):
    assert abs(ts.compute_offset(mm, sens) - want) < 1e-12


def test_modify_flame_params_axes_scales_and_no_mutation(tmp_path):
    src, out = tmp_path / "s.npz", tmp_path / "o.npz"
    np.savez(src, jaw_pose=np.zeros((10, 3), np.float32),
             translation=np.zeros((10, 3), np.float32), shape=np.zeros(300, np.float32))
    ts.modify_flame_params(str(src), str(out), 0.005, 0.003)
    d = np.load(out)
    assert abs(d["translation"][0, 1] - 0.005) < 1e-6 and abs(d["jaw_pose"][0, 0] - 0.003) < 1e-6
    assert float(np.load(src)["translation"][0, 1]) == 0.0
    ts.modify_flame_params(str(src), str(out), 0.01, 0.02, deformation_map={
        "translation_axis": 2, "jaw_axis": 1, "lefort_scale": 2.0, "bsso_scale": 0.5})
    d = np.load(out)
    assert abs(d["translation"][0, 2] - 0.02) < 1e-6 and abs(d["jaw_pose"][0, 1] - 0.01) < 1e-6
    one = ts.apply_surgical_offsets({"translation": np.zeros(3), "jaw_pose": np.zeros(3)},
                                    0.004, 0.002)
    assert one["translation"][1] == 0.004 and one["jaw_pose"][0] == 0.002


def test_rig_mode_and_deformation_map(tmp_path):
    assert ts.choose_rig_mode("hybrid_full_head", "")[0] == "flame_only"
    asset = tmp_path / "a.npz"
    np.savez(asset, v=np.ones(1))
    assert ts.choose_rig_mode("hybrid_full_head", str(asset))[0] == "hybrid_full_head"
    assert ts.load_deformation_map("") == {}
    (tmp_path / "bad.json").write_text("[1]")
    with pytest.raises(ValueError):
        ts.load_deformation_map(str(tmp_path / "bad.json"))


def test_create_modified_dataset_and_export(tmp_path):
    images, _, params = write_small_dataset(td.write_dataset, tmp_path / "data")
    out = Path(ts.create_modified_dataset(str(tmp_path / "data"), 0.005, 0.002))
    try:
        ds = td.FrameDataset(out)
        for i in range(len(ds)):
            p = ds.load_frame_params(i)
            np.testing.assert_allclose(p["translation"][0, 1], 0.005, atol=1e-7)
            np.testing.assert_allclose(p["jaw_pose"][0, 0], params["jaw_pose"][i, 0] + 0.002,
                                       atol=1e-7)
            np.testing.assert_array_equal(ds.load_image(i), images[i])
        export = tmp_path / "export"
        ts.export_deterministic_frames(str(out / "images"), str(export), max_frames=2)
        manifest = json.loads((export / "deterministic_indices_manifest.json").read_text())
        assert manifest["selected_indices"] == [0, 2]
    finally:
        import shutil
        shutil.rmtree(out, ignore_errors=True)


def test_modified_dataset_uses_refined_params(tmp_path):
    """Co-optimized (refined) FLAME params replace the tracked ones as the
    base of the surgical offsets."""
    T = 3
    data = tmp_path / "data"
    (data / "flame_param").mkdir(parents=True)
    orig = jd.default_flame_params(T, n_verts=50)
    np.savez(data / "flame_param.npz", **orig)
    for i in range(T):
        np.savez(data / "flame_param" / f"{i:05d}.npz",
                 **{k: (v if k == "shape" or (v.ndim == 3 and v.shape[0] == 1) else v[i:i + 1])
                    for k, v in orig.items()})
    (data / "transforms_train.json").write_text(json.dumps({
        "frames": [{"timestep_index": i, "transform_matrix": np.eye(4).tolist()}
                   for i in range(T)]}))
    refined = {k: v.copy() for k, v in orig.items()}
    refined["rotation"] = refined["rotation"] + 0.123
    np.savez(tmp_path / "refined.npz", **refined)
    import shutil
    out = ts.create_modified_dataset(str(data), 0.005, 0.0,
                                     refined_params=str(tmp_path / "refined.npz"))
    out2 = ts.create_modified_dataset(str(data), 0.005, 0.0)
    try:
        got = np.load(f"{out}/flame_param/00001.npz")
        np.testing.assert_allclose(got["rotation"], refined["rotation"][1:2], atol=1e-6)
        np.testing.assert_allclose(got["translation"][:, 1], 0.005, atol=1e-6)
        np.testing.assert_allclose(np.load(f"{out}/flame_param.npz")["rotation"],
                                   refined["rotation"], atol=1e-6)
        np.testing.assert_allclose(np.load(f"{out2}/flame_param/00001.npz")["rotation"],
                                   orig["rotation"][1:2], atol=1e-6)
    finally:
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(out2, ignore_errors=True)


def test_export_deterministic_frames_explicit_indices(tmp_path):
    frames = tmp_path / "renders"
    for i in range(6):
        tv.write_image(frames / f"{i:05d}.png", np.full((8, 8, 3), i * 20, np.uint8))
    (tmp_path / "idx.json").write_text(json.dumps({"indices": [0, 3, 5, 9]}))
    ts.export_deterministic_frames(str(frames), str(tmp_path / "out"),
                                   str(tmp_path / "idx.json"))
    manifest = json.loads((tmp_path / "out" / "deterministic_indices_manifest.json").read_text())
    assert manifest["selected_indices"] == [0, 3, 5]
    np.testing.assert_array_equal(tv.read_image(tmp_path / "out" / "idx_00003.png"),
                                  np.full((8, 8, 3), 60, np.uint8))
