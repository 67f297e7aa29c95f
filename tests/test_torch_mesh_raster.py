"""The port's texture sampling and soft mesh rasterizer against the JAX
package's, on the CPU.

The same numpy inputs (the 700-vertex synthetic FLAME asset posed with seeded
parameters, a 64^2 camera, seeded colours) go through `omfs4d.render.texture`
/ `omfs4d.render.mesh_raster` and their counterparts.  Images agree to atol
1e-4 and gradients to atol 2e-4 * max|g|, rtol 2e-3; every gradient is finite.
The composite cases share the JAX binning's lists, so a tie in the depth sort
cannot move an entry; the whole-rasterizer cases bin on their own and their
fixture has no list overflow, so the softmax aggregation sees the same set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omfs4d.models import flame as jf
from omfs4d.models.assets import synthetic_flame_asset
from omfs4d.ops.camera import look_at_camera as j_look_at_camera
from omfs4d.render import mesh_raster as jm
from omfs4d.render import texture as jt
from omfs4d_torch.ops.camera import look_at_camera as t_look_at_camera
from omfs4d_torch.render import mesh_raster as tm
from omfs4d_torch.render import texture as tt
from omfs4d_torch.render.rasterize import _tile_pixel_centers
from tests.test_torch_track import one_torch_thread  # noqa: F401  (autouse here too)

S = 64
K = 128
S_FULL, K_FULL = 128, 512      # the whole-rasterizer cases: no list overflows
IMG_ATOL = 1e-4
GRAD_TOL = 2e-4, 2e-3      # atol * max|reference gradient|, rtol


def t_(x, grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_() if grad else t


def assert_grad_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    scale = np.abs(want).max()
    assert scale > 0, f"{name}: the reference gradient is all zero"
    np.testing.assert_allclose(got, want, atol=GRAD_TOL[0] * scale, rtol=GRAD_TOL[1],
                               err_msg=name)


@pytest.fixture(scope="module")
def scene():
    """Posed vertices, faces, UVs, seeded colours and both cameras."""
    model = jf.FlameModel.from_asset(synthetic_flame_asset(n_vertices=700, seed=0))
    rng = np.random.default_rng(3)
    params = {"shape": jnp.asarray(0.5 * rng.normal(size=20), jnp.float32),
              "expr": jnp.asarray(0.3 * rng.normal(size=(1, 10)), jnp.float32),
              "rotation": jnp.asarray([[0.05, 0.2, -0.03]], jnp.float32),
              "jaw_pose": jnp.asarray([[0.15, 0.0, 0.0]], jnp.float32)}
    verts = np.asarray(jf.flame_forward(model, params)[0])
    faces = np.asarray(model.faces)
    cam_kw = dict(eye=(0, 0, 0.5), target=(0, 0, 0), fx=S * 1.3, width=S, height=S)
    full_kw = dict(cam_kw, fx=S_FULL * 1.6, width=S_FULL, height=S_FULL)
    return {
        "verts": verts, "faces": faces, "uv": np.asarray(model.uv_coords),
        "face_colors": rng.uniform(0.05, 0.95, (len(faces), 3)).astype(np.float32),
        "vert_colors": rng.uniform(0.05, 0.95, (len(verts), 3)).astype(np.float32),
        "texture": rng.uniform(0.05, 0.95, (16, 16, 3)).astype(np.float32),
        "opacity": rng.uniform(0.6, 1.0, len(faces)).astype(np.float32),
        "jcam": j_look_at_camera(**cam_kw), "tcam": t_look_at_camera(**cam_kw),
        "jcam_full": j_look_at_camera(**full_kw), "tcam_full": t_look_at_camera(**full_kw),
        "cot": rng.normal(size=(S_FULL, S_FULL, 3)).astype(np.float32),
        "cot_a": rng.normal(size=(S_FULL, S_FULL)).astype(np.float32),
    }


# ── texture sampling ─────────────────────────────────────────


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(0)
    tex = rng.uniform(0, 1, (8, 12, 3)).astype(np.float32)
    # inside, at texel centres, past both borders, and exactly on them
    uv = np.concatenate([rng.uniform(-0.1, 1.1, (200, 2)),
                         [[3 / 11, 5 / 7], [0.0, 0.0], [1.0, 1.0], [0.0, 1.0]]]
                        ).astype(np.float32)
    cot = rng.normal(size=(len(uv), 3)).astype(np.float32)
    want = jt.bilinear_sample(jnp.asarray(tex), jnp.asarray(uv))
    g_tex, g_uv = jax.grad(lambda t, u: jnp.sum(jt.bilinear_sample(t, u) * cot),
                           argnums=(0, 1))(jnp.asarray(tex), jnp.asarray(uv))
    tex_t, uv_t = t_(tex, True), t_(uv, True)
    got = tt.bilinear_sample(tex_t, uv_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got[200].detach().numpy(), tex[5, 3], atol=1e-6)
    (got * t_(cot)).sum().backward()
    assert_grad_close(tex_t.grad, g_tex, "d texture")
    # the rows on the border tie in the clip: JAX passes half the gradient
    assert_grad_close(uv_t.grad, g_uv, "d uv")
    assert np.abs(np.asarray(g_uv)[201:]).max() > 0


def test_bilinear_sample_takes_an_image_of_uvs():
    rng = np.random.default_rng(1)
    tex = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (5, 7, 2)).astype(np.float32)
    want = jt.bilinear_sample(jnp.asarray(tex), jnp.asarray(uv))
    got = tt.bilinear_sample(t_(tex), t_(uv))
    assert got.shape == (5, 7, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_face_center_uv_matches_jax(scene):
    want = jt.face_center_uv(jnp.asarray(scene["uv"]), jnp.asarray(scene["faces"]))
    g = jax.grad(lambda u: jnp.sum(jt.face_center_uv(u, jnp.asarray(scene["faces"])) ** 2))(
        jnp.asarray(scene["uv"]))
    uv_t = t_(scene["uv"], True)
    got = tt.face_center_uv(uv_t, t_(scene["faces"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    (got ** 2).sum().backward()
    assert_grad_close(uv_t.grad, g, "d uv_coords")


# ── projection of faces ──────────────────────────────────────


def test_project_faces_matches_jax(scene):
    faces_j = jnp.asarray(scene["faces"])
    rng = np.random.default_rng(5)
    cot_e = rng.normal(size=(len(scene["faces"]), 9)).astype(np.float32)
    cot_d = rng.normal(size=len(scene["faces"])).astype(np.float32)

    def f(v):
        edges, proj = jm.project_faces(scene["jcam"], v, faces_j)
        return jnp.sum(edges * cot_e) + jnp.sum(proj["depth"] * cot_d), (edges, proj)

    (_, (edges_j, proj_j)), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(scene["verts"]))
    v_t = t_(scene["verts"], True)
    edges_t, proj_t = tm.project_faces(scene["tcam"], v_t, t_(scene["faces"]))
    np.testing.assert_allclose(edges_t.detach().numpy(), np.asarray(edges_j),
                               atol=2e-3, rtol=1e-4)     # c is in pixels, up to ~100
    for k in ("uv", "depth", "radius"):
        np.testing.assert_allclose(proj_t[k].detach().numpy(), np.asarray(proj_j[k]),
                                   atol=1e-3, rtol=1e-5, err_msg=k)
    assert np.array_equal(proj_t["in_front"].numpy(), np.asarray(proj_j["in_front"]))
    assert proj_t["conic"].shape == (len(scene["faces"]), 3)
    ((edges_t * t_(cot_e)).sum() + (proj_t["depth"] * t_(cot_d)).sum()).backward()
    assert_grad_close(v_t.grad, g, "d verts")


# ── the tile composite ───────────────────────────────────────


@pytest.fixture(scope="module")
def tiles(scene):
    """Edges, depths and the JAX binning's lists of the scene (with an empty
    tile), and a seeded cotangent per tile."""
    edges, proj = jm.project_faces(scene["jcam"], jnp.asarray(scene["verts"]),
                                   jnp.asarray(scene["faces"]))
    b = jm.bin_gaussians(proj, jnp.asarray(scene["opacity"]), S, S, 16, K, 16)
    counts = np.array(b.tile_counts)
    assert counts.max() > 20, counts
    counts[np.argmin(counts)] = 0          # the head fills the frame: empty one tile
    rng = np.random.default_rng(7)
    return {"edges": np.asarray(edges), "depth": np.asarray(proj["depth"]),
            "lists": np.asarray(b.tile_lists), "counts": counts,
            "pix": _tile_pixel_centers(S // 16, S // 16, 16).numpy(),
            "cot": rng.normal(size=(len(counts), 256, 3)).astype(np.float32),
            "cot_a": rng.normal(size=(len(counts), 256)).astype(np.float32)}


@pytest.mark.parametrize("aggregation", ["over", "softmax"])
@pytest.mark.parametrize("interp", ["flat", "vertex_colors"])
def test_composite_mesh_tiles_matches_jax(scene, tiles, aggregation, interp):
    """Four cases; the lists hold a tile with no face in it."""
    faces = scene["faces"]
    vcols = scene["vert_colors"][faces]                      # (F, 3, 3)
    lists_j, counts_j, pix_j = (jnp.asarray(tiles[k]) for k in ("lists", "counts", "pix"))

    def f(edges, colors, opacity, depths, vc):
        col, alpha = jm.composite_mesh_tiles(
            edges, colors, opacity, depths, lists_j, counts_j, pix_j,
            aggregation=aggregation, vertex_colors=vc if interp == "vertex_colors" else None)
        return jnp.sum(col * tiles["cot"]) + jnp.sum(alpha * tiles["cot_a"]), (col, alpha)

    args = (tiles["edges"], scene["face_colors"], scene["opacity"], tiles["depth"], vcols)
    (_, (col_j, alpha_j)), grads_j = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in args))

    leaves = [t_(a, True) for a in args]
    col_t, alpha_t = tm.composite_mesh_tiles(
        *leaves[:4], t_(tiles["lists"]), t_(tiles["counts"]), t_(tiles["pix"]),
        aggregation=aggregation, chunk_tiles=5,          # 16 tiles: a ragged last chunk
        vertex_colors=leaves[4] if interp == "vertex_colors" else None)
    np.testing.assert_allclose(col_t.detach().numpy(), np.asarray(col_j), atol=IMG_ATOL)
    np.testing.assert_allclose(alpha_t.detach().numpy(), np.asarray(alpha_j), atol=IMG_ATOL)
    empty = tiles["counts"] == 0
    assert (alpha_t.detach().numpy()[empty] == 0).all()
    ((col_t * t_(tiles["cot"])).sum() + (alpha_t * t_(tiles["cot_a"])).sum()).backward()
    names = ["edges", "colors", "opacity", "depths", "vertex_colors"]
    used = {"edges", "opacity"} | ({"vertex_colors"} if interp == "vertex_colors" else {"colors"})
    if aggregation == "softmax":
        used.add("depths")                # not detached in the softmax weights
    for name, leaf, gj in zip(names, leaves, grads_j):
        if name in used:
            assert_grad_close(leaf.grad, gj, f"d {name}")
        else:
            assert leaf.grad is None or not leaf.grad.any(), name
            assert not np.asarray(gj).any(), name


# ── the whole rasterizer ─────────────────────────────────────


@pytest.mark.parametrize("case", ["flat_softmax", "vertex_softmax", "flat_over"])
def test_rasterize_mesh_matches_jax(scene, case):
    interp = case.startswith("vertex")
    aggregation = case.split("_")[1]
    cols = scene["vert_colors"] if interp else scene["face_colors"]
    kw = dict(face_opacity=0.98, max_per_tile=K_FULL, aggregation=aggregation,
              vertex_interp=interp)
    faces_j = jnp.asarray(scene["faces"])

    def f(v, c):
        img, aux = jm.rasterize_mesh(v, faces_j, c, scene["jcam_full"], S_FULL, S_FULL, **kw)
        return jnp.sum(img * scene["cot"]) + jnp.sum(aux["alpha"] * scene["cot_a"]), (img, aux)

    (_, (img_j, aux_j)), (gv, gc) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(scene["verts"]), jnp.asarray(cols))
    assert int(aux_j["overflow"]) == 0

    v_t, c_t = t_(scene["verts"], True), t_(cols, True)
    img_t, aux_t = tm.rasterize_mesh(v_t, t_(scene["faces"]), c_t, scene["tcam_full"], S_FULL, S_FULL, **kw)
    assert int(aux_t["overflow"]) == 0
    np.testing.assert_allclose(img_t.detach().numpy(), np.asarray(img_j), atol=IMG_ATOL)
    np.testing.assert_allclose(aux_t["alpha"].detach().numpy(), np.asarray(aux_j["alpha"]),
                               atol=IMG_ATOL)
    ((img_t * t_(scene["cot"])).sum() + (aux_t["alpha"] * t_(scene["cot_a"])).sum()).backward()
    assert_grad_close(v_t.grad, gv, "d verts")
    assert_grad_close(c_t.grad, gc, "d colors")


def test_rasterize_mesh_defaults_match_the_reference():
    import inspect

    want = inspect.signature(jm.rasterize_mesh.__wrapped__).parameters
    got = inspect.signature(tm.rasterize_mesh).parameters
    for name in ("face_opacity", "tile", "max_per_tile", "max_tiles_per_face", "sigma",
                 "aggregation", "gamma", "vertex_interp"):
        assert got[name].default == want[name].default, name


def test_render_textured_mesh_matches_jax(scene):
    faces_j, uv_j = jnp.asarray(scene["faces"]), jnp.asarray(scene["uv"])
    kw = dict(face_opacity=0.98, max_per_tile=K_FULL)

    def f(v, tex):
        img, aux = jt.render_textured_mesh(v, faces_j, uv_j, tex, scene["jcam_full"], S_FULL, S_FULL, **kw)
        return jnp.sum(img * scene["cot"]), (img, aux)

    (_, (img_j, aux_j)), (gv, gt) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(scene["verts"]), jnp.asarray(scene["texture"]))
    v_t, tex_t = t_(scene["verts"], True), t_(scene["texture"], True)
    img_t, aux_t = tt.render_textured_mesh(v_t, t_(scene["faces"]), t_(scene["uv"]), tex_t,
                                           scene["tcam_full"], S_FULL, S_FULL, **kw)
    np.testing.assert_allclose(img_t.detach().numpy(), np.asarray(img_j), atol=IMG_ATOL)
    np.testing.assert_allclose(aux_t["alpha"].detach().numpy(), np.asarray(aux_j["alpha"]),
                               atol=IMG_ATOL)
    (img_t * t_(scene["cot"])).sum().backward()
    assert_grad_close(v_t.grad, gv, "d verts")
    assert_grad_close(tex_t.grad, gt, "d texture")
