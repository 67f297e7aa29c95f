"""What the trainer starts from, port against the JAX package, on the CPU:
k-NN mean distances (`ops/knn.py`), the k-NN scale init of
`init_gaussians_on_mesh(ref_verts=...)`, `init_gaussians_from_points`, and
the dataset quality gates (`train/gates.py`).

Tolerance: distances at rtol 1e-5 (both take |x|^2 + |y|^2 - 2 x.y in f32,
summed in other orders); the integer bindings and masks exactly.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from omfs4d.models import gaussians as jg
from omfs4d.models.assets import synthetic_flame_asset
from omfs4d.ops import knn as jknn
from omfs4d.train import gates as jgates
from omfs4d_torch.convert import to_numpy
from omfs4d_torch.models import gaussians as tg
from omfs4d_torch.ops import knn as tknn
from omfs4d_torch.train import gates as tgates


@pytest.mark.parametrize("n,chunk", [(50, 2048), (700, 256)])
def test_knn_mean_distance_matches_jax_and_numpy(n, chunk):
    pts = np.random.default_rng(n).normal(0, 0.2, (n, 3)).astype(np.float32)
    got = tknn.knn_mean_distance(pts, k=3, chunk=chunk).numpy()
    np.testing.assert_allclose(got, np.asarray(jknn.knn_mean_distance(jnp.asarray(pts), k=3)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, tknn.knn_mean_distance_np(pts, k=3), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(tknn.knn_mean_distance_np(pts), jknn.knn_mean_distance_np(pts))


def test_init_gaussians_on_mesh_with_knn_scales_matches_jax():
    asset = synthetic_flame_asset(n_vertices=300, seed=2)
    faces, verts = asset["faces"], asset["v_template"]
    want = jg.init_gaussians_on_mesh(faces, 1024, seed=3, ref_verts=verts)
    got = to_numpy(tg.init_gaussians_on_mesh(faces, 1024, seed=3, ref_verts=verts))
    for name, value in want._asdict().items():
        np.testing.assert_allclose(got[name], np.asarray(value), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # the k-NN init never grows past init_scale and differs from the constant one
    assert got["log_scale"].max() <= np.log(0.5) + 1e-6
    assert got["log_scale"].min() < np.log(0.5) - 0.01


def test_init_gaussians_from_points_matches_jax():
    asset = synthetic_flame_asset(n_vertices=300, seed=2)
    faces, verts = asset["faces"], asset["v_template"]
    pts = (verts[::2] + np.random.default_rng(0).normal(0, 2e-3, verts[::2].shape)
           ).astype(np.float32)
    want = jg.init_gaussians_from_points(pts, verts, faces, 512)
    got = to_numpy(tg.init_gaussians_from_points(pts, verts, faces, 512))
    np.testing.assert_array_equal(got["parent_face"], np.asarray(want.parent_face))
    np.testing.assert_array_equal(got["alive"], np.asarray(want.alive))
    assert got["alive"].sum() == len(pts)
    for name in ("mu_local", "quat_local", "log_scale", "opacity_logit", "color", "sh"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def write_transforms(path, timesteps, n_masks=None):
    path.mkdir(parents=True, exist_ok=True)
    frames = [{"file_path": f"images/{i:05d}.png", "timestep_index": t}
              for i, t in enumerate(timesteps)]
    (path / "transforms_train.json").write_text(json.dumps({"frames": frames}))
    if n_masks is not None:
        (path / "fg_masks").mkdir()
        for i in range(n_masks):
            (path / "fg_masks" / f"{i:05d}.png").write_bytes(b"")


@pytest.mark.parametrize("case", ["pass", "few_frames", "gaps", "few_masks"])
def test_quality_gates_match_jax(tmp_path, case):
    timesteps = {"pass": range(60), "few_frames": range(10),
                 "gaps": range(0, 180, 3), "few_masks": range(60)}[case]
    write_transforms(tmp_path, list(timesteps), n_masks={"few_masks": 5}.get(case, 40))
    results = []
    for gates in (jgates, tgates):
        try:
            results.append(("ok", gates.run_quality_gates(tmp_path, min_frames=50)))
        except gates.QualityGateError as e:
            results.append(("error", str(e)))
    assert results[0] == results[1]
    assert results[1][0] == ("ok" if case == "pass" else "error")
