"""The port's mesh container and ops (`omfs4d_torch.ops.mesh`,
`omfs4d_torch.ops.primitives`, `omfs4d_torch.native`) against the JAX
package's host versions on the CPU, on the same seeded NumPy meshes:

  * `clean` with coincident vertices, degenerate and duplicate faces;
  * `plane_clip` at axis-aligned and tilted normals, with vertices exactly on
    the plane;
  * `vertex_adjacency`, equal array for array;
  * `laplacian_smooth`, bit-equal to the reference's native meshkit path as it
    loads here;
  * QEM through the port's loader, equal to the reference's;
  * `decimate_cluster`, equal to the reference's grid-clustering fallback
    (the reference's `omfs4d.native._load` monkeypatched to return None);
  * `connectivity_components`, rotations, merge, bounds and center;
  * the reference's invariants (`tests/test_ops.py::TestMeshOps`) on the port.

Then the loader's rules: meshkit is built into `omfs4d_torch/_build/` under a
name hashed from its source, and a missing g++ or a failed compile raises
with the compiler's message."""

import numpy as np
import pytest
import torch

from omfs4d import native as jnative
from omfs4d.ops import marching as jm
from omfs4d.ops import mesh as jmesh
from omfs4d.ops import primitives as jp
from omfs4d_torch import native as tnative
from omfs4d_torch.ops import mesh as tmesh
from omfs4d_torch.ops import primitives as tp

CPU = "cpu"


def port(m: jmesh.TriMesh) -> tmesh.TriMesh:
    return tmesh.TriMesh(m.vertices, m.faces, device=CPU)


def assert_same(ref: jmesh.TriMesh, got: tmesh.TriMesh, atol=0.0):
    v, f = got.numpy()
    assert v.dtype == np.float32 and f.dtype == np.int32
    assert f.shape == ref.faces.shape and v.shape == ref.vertices.shape
    np.testing.assert_array_equal(f, ref.faces)
    if atol:
        np.testing.assert_allclose(v, ref.vertices, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(v, ref.vertices)


def bone_like(n=24, seed=0) -> jmesh.TriMesh:
    """A noisy closed surface from the reference's marching, in xyz."""
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2
    field = 8.0 - np.sqrt((z - c) ** 2 + (y - c) ** 2 + ((x - c) * 1.2) ** 2)
    field += np.random.default_rng(seed).normal(0, 0.4, field.shape).astype(np.float32)
    v, f = jm.marching_cubes(field, 1.0, spacing=(0.3, 0.3, 0.3))
    return jmesh.TriMesh(v[:, ::-1].copy(), f)


MESHES = {
    "bone-like": lambda: bone_like(),
    "sphere": lambda: jp.make_sphere_mesh(radius=30, center=(0, 0, 20), res=20),
    "two spheres": lambda: jp.make_sphere_mesh(10, (0, 0, 20), 12).merge(
        jp.make_sphere_mesh(10, (0, 0, -20), 12)),
}


@pytest.fixture(scope="module")
def meshes():
    return {k: f() for k, f in MESHES.items()}


# ── clean ──────────────────────────────────────────────────


def messy(seed=0) -> jmesh.TriMesh:
    """Coincident vertices (including -0.0 beside 0.0), unused vertices,
    degenerate faces and duplicate faces in both windings."""
    m = bone_like(16, seed)
    rng = np.random.default_rng(seed)
    v = m.vertices.copy()
    v[:5, 0] = 0.0
    extra = np.concatenate([v[rng.integers(0, len(v), 40)], -v[:3] * 0.0,
                            rng.normal(size=(7, 3)).astype(np.float32)])
    n = len(v)
    dup = m.faces[rng.integers(0, len(m.faces), 30)]
    faces = np.concatenate([
        m.faces, dup, dup[:10, ::-1], [[0, 0, 1], [2, 3, 2]],
        np.arange(n, n + 39).reshape(-1, 3),                  # onto the coincident copies
        rng.permutation(m.faces[:20], axis=1)])
    return jmesh.TriMesh(np.concatenate([v, extra]), faces)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clean_matches_reference(seed):
    m = messy(seed)
    assert_same(m.clean(), port(m).clean())


@pytest.mark.parametrize("tol", [0.05, 0.3])
def test_clean_with_tolerance_matches_reference(tol):
    m = bone_like(16)
    assert_same(m.clean(tol), port(m).clean(tol))


# ── plane clip ─────────────────────────────────────────────

PLANES = {
    "z through the middle": ((0, 0, 1), (0, 0, 0)),
    "-z": ((0, 0, -1), (0, 0, 3.5)),
    "x": ((1, 0, 0), (-1.25, 0, 0)),
    "tilted": ((0.3, -0.2, 0.9), (0.4, 0.1, -0.2)),
    "tilted 2": ((-0.7, 0.5, 0.2), (-0.5, 0.3, 0.1)),
    "unnormalised diagonal": ((1, 1, 0), (0.37, -0.11, 0)),
    "misses the mesh": ((0, 0, 1), (0, 0, 100)),
    "keeps the whole mesh": ((0, 0, 1), (0, 0, -100)),
}


@pytest.mark.parametrize("name", list(PLANES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_plane_clip_matches_reference(meshes, mesh_name, name):
    m = meshes[mesh_name]
    m = m.translate(-m.center)
    normal, origin = PLANES[name]
    assert_same(jmesh.plane_clip(m, normal, origin), tmesh.plane_clip(port(m), normal, origin))


def test_plane_clip_with_vertices_on_the_plane():
    """Vertices exactly on the plane (d == 0 is kept) at an axis-aligned and
    at tilted normals: a lattice whose offsets from the origin are 0 or
    powers of two, so every product of the signed distance is exact and both
    packages round its sums alike."""
    axis = np.array([-4, -2, -1, -0.5, 0, 0.5, 1, 2, 4], np.float32)
    g = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(0)
    faces = np.stack([rng.permutation(len(g))[:3] for _ in range(400)]).astype(np.int32)
    m = jmesh.TriMesh(g, faces)
    for normal, origin in [((0, 0, 1), (0, 0, 0.5)), ((1, 1, 0), (0, 0, 0)),
                           ((1, -1, 0), (0, 0, 0)), ((1, -1, 1), (0, 0, 0)),
                           ((0, 2, 2), (0, 0, 0))]:
        ref = jmesh.plane_clip(m, normal, origin)
        d = (m.vertices - np.asarray(origin, np.float32)) @ np.asarray(normal, np.float32)
        assert (d == 0).sum() > 0
        assert_same(ref, tmesh.plane_clip(port(m), normal, origin))


def test_plane_sides_differ_only_within_rounding_of_the_plane(meshes):
    """The reference's signed distance is a BLAS product, which may fuse a
    multiply and an add; the port's sums its three products in separate ops,
    the same on the card and the CPU.  So a vertex whose distance is rounding
    noise (the sphere's meridians at 135 and 315 degrees lie on this plane)
    may fall on the other side; any vertex off the plane by more than that
    falls on the same side in both packages."""
    m = meshes["sphere"]
    m = m.translate(-m.center)
    n = np.array([1.0, 1.0, 0.0]) / np.sqrt(2.0)
    d_ref = m.vertices.astype(np.float64) @ n
    d_port = tmesh._signed_distance(port(m).vertices, n, np.zeros(3)).numpy()
    np.testing.assert_allclose(d_port, d_ref, rtol=0, atol=1e-12)
    other_side = (d_ref >= 0) != (d_port >= 0)
    assert (np.abs(d_ref[other_side]) < 1e-12).all()


@pytest.mark.parametrize("invert", [False, True])
def test_clip_method_matches_reference(meshes, invert):
    m = meshes["sphere"]
    assert_same(m.clip((0.2, 0.1, 1.0), (1, 2, 20), invert=invert),
                port(m).clip((0.2, 0.1, 1.0), (1, 2, 20), invert=invert))


# ── adjacency, smoothing, decimation ───────────────────────


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("max_degree", [0, 4])
def test_vertex_adjacency_matches_reference(meshes, mesh_name, max_degree):
    m = meshes[mesh_name]
    nbr, mask = jmesh.vertex_adjacency(m.faces, m.n_points, max_degree)
    tn, tmask = tmesh.vertex_adjacency(port(m).faces, m.n_points, max_degree)
    assert tn.dtype == torch.int64 and tmask.dtype == torch.bool
    np.testing.assert_array_equal(tn.numpy(), nbr)
    np.testing.assert_array_equal(tmask.numpy(), mask)


def test_vertex_adjacency_with_isolated_vertices():
    faces = np.array([[0, 1, 2], [2, 1, 4]], np.int32)
    nbr, mask = jmesh.vertex_adjacency(faces, 7)
    tn, tmask = tmesh.vertex_adjacency(torch.from_numpy(faces), 7)
    np.testing.assert_array_equal(tn.numpy(), nbr)
    np.testing.assert_array_equal(tmask.numpy(), mask)


@pytest.fixture(scope="module")
def reference_native():
    if not jnative.available():
        pytest.skip("the reference's meshkit did not build here")
    return jnative


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("n_iter, relax", [(30, 0.01), (7, 0.3), (1, 1.0)])
def test_laplacian_smooth_bit_equal_to_native(reference_native, meshes, mesh_name, n_iter, relax):
    m = meshes[mesh_name]
    assert_same(jmesh.laplacian_smooth(m, n_iter, relax),
                tmesh.laplacian_smooth(port(m), n_iter, relax))


def test_smooth_leaves_isolated_vertices(reference_native):
    m = jmesh.TriMesh(np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32),
                      np.array([[0, 1, 2], [1, 2, 3]], np.int32))
    got = port(m).smooth(5)
    assert_same(m.smooth(5), got)
    np.testing.assert_array_equal(got.numpy()[0][4:], m.vertices[4:])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("reduction", [0.5, 0.8])
def test_qem_matches_reference(reference_native, meshes, mesh_name, reduction):
    m = meshes[mesh_name]
    assert_same(m.decimate(reduction), port(m).decimate(reduction))


def test_qem_after_smoothing_matches_reference(reference_native, meshes):
    """The decimation is a discrete heap over collapse costs: it gives the
    reference's topology only from the reference's bits."""
    m = meshes["bone-like"]
    assert_same(m.smooth(30).decimate(0.5), port(m).smooth(30).decimate(0.5))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("reduction", [0.5, 0.7])
def test_decimate_cluster_matches_reference_fallback(monkeypatch, meshes, mesh_name, reduction):
    monkeypatch.setattr(jnative, "_load", lambda: None)
    m = meshes[mesh_name]
    assert_same(m.decimate(reduction), tmesh.decimate_cluster(port(m), reduction))


def test_decimate_out_of_range_is_a_copy(meshes):
    m = port(meshes["sphere"])
    for r in (0.0, 1.0, -0.5):
        for fn in (tmesh.decimate, tmesh.decimate_cluster):
            out = fn(m, r)
            assert out is not m and torch.equal(out.faces, m.faces)


# ── transforms, topology, primitives ───────────────────────


def test_connectivity_matches_reference():
    a = jp.make_sphere_mesh(radius=5, center=(0, 0, 0), res=8)
    b = jp.make_sphere_mesh(radius=5, center=(100, 0, 0), res=8)
    m = a.merge(b)
    labels, count = m.connectivity_components()
    tl, tc = port(m).connectivity_components()
    assert tc == count == 2
    np.testing.assert_array_equal(tl, labels)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
@pytest.mark.parametrize("deg", [90.0, 13.0, -7.5])
def test_rotation_matches_reference(meshes, axis, deg):
    m = meshes["bone-like"]
    ref = getattr(m, f"rotate_{axis}")(deg, point=m.center)
    assert_same(ref, getattr(port(m), f"rotate_{axis}")(deg, point=m.center), atol=1e-5)


def test_translate_merge_bounds_center(meshes):
    a, b = meshes["sphere"], meshes["bone-like"]
    ta, tb = port(a), port(b)
    assert_same(a.translate((1.5, -2.0, 0.25)), ta.translate((1.5, -2.0, 0.25)))
    assert_same(a.merge(b), ta.merge(tb))
    assert_same(jmesh.TriMesh().merge(b), tmesh.TriMesh(device=CPU).merge(tb))
    m = b.merge(a)
    tm_ = tb.merge(ta)
    assert tm_.bounds == m.bounds and all(type(x) is type(y) for x, y in zip(tm_.bounds, m.bounds))
    assert tm_.center.dtype == m.center.dtype
    np.testing.assert_array_equal(tm_.center, m.center)
    assert tmesh.TriMesh(device=CPU).bounds == jmesh.TriMesh().bounds
    ta.translate(-ta.center, inplace=True)
    a2 = a.copy()
    a2.translate(-a2.center, inplace=True)
    assert_same(a2, ta)


@pytest.mark.parametrize("res", [8, 24])
def test_sphere_primitive_matches_reference(res):
    assert_same(jp.make_sphere_mesh(30, (0, 0, 20), res), tp.make_sphere_mesh(30, (0, 0, 20), res,
                                                                               device=CPU))


def test_numpy_and_to():
    m = tp.make_sphere_mesh(5, res=8, device=CPU)
    v, f = m.numpy()
    assert v.dtype == np.float32 and f.dtype == np.int32
    assert m.to("cpu") is m


# ── the reference's invariants (tests/test_ops.py::TestMeshOps) ──


@pytest.mark.parametrize("invert", [False, True])
def test_clip_halves_sphere(invert):
    m = tp.make_sphere_mesh(radius=30, device=CPU)
    part = m.clip(normal=(0, 0, 1), origin=(0, 0, 0), invert=invert)
    z = part.vertices[:, 2].numpy()
    assert part.n_points > 0
    assert (z.max() <= 1e-4) if invert else (z.min() >= -1e-4)
    assert np.abs(z).min() < 1e-4


def test_clip_plane_offset():
    m = tp.make_sphere_mesh(radius=30, center=(0, 0, 20), device=CPU)
    part = m.clip(normal=(0, 0, 1), origin=(0, 0, 20), invert=False)
    assert part.vertices[:, 2].min().item() >= 20 - 1e-4


def test_clip_empty_side():
    m = tp.make_sphere_mesh(radius=10, device=CPU)
    assert m.clip(normal=(0, 0, 1), origin=(0, 0, 100), invert=False).n_points == 0


def test_merge_and_center():
    a = tp.make_sphere_mesh(radius=10, center=(0, 0, 20), device=CPU)
    b = tp.make_sphere_mesh(radius=10, center=(0, 0, -20), device=CPU)
    m = a.merge(b)
    assert m.n_points == a.n_points + b.n_points
    np.testing.assert_allclose(m.center, [0, 0, 0], atol=1e-4)


def test_rotate_about_point():
    m = tp.make_sphere_mesh(radius=5, center=(10, 0, 0), device=CPU)
    np.testing.assert_allclose(m.rotate_z(90, point=(0, 0, 0)).center, [0, 10, 0], atol=1e-3)


def test_smooth_shrinks_slightly():
    m = tp.make_sphere_mesh(radius=10, res=12, device=CPU)
    s = m.smooth(n_iter=30)
    r0 = torch.linalg.norm(m.vertices, dim=1).mean().item()
    r1 = torch.linalg.norm(s.vertices, dim=1).mean().item()
    assert 0.8 * r0 < r1 <= r0 + 1e-6


@pytest.mark.parametrize("fn", [tmesh.decimate, tmesh.decimate_cluster], ids=["qem", "cluster"])
def test_decimate(fn):
    m = tp.make_sphere_mesh(radius=10, res=32, device=CPU)
    d = fn(m, 0.5)
    assert 0.2 * m.n_faces < d.n_faces < m.n_faces
    np.testing.assert_allclose(torch.linalg.norm(d.vertices, dim=1).mean().item(), 10.0, atol=1.0)


def test_clean_dedups():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 0]], dtype=np.float32)
    faces = np.array([[0, 1, 2], [3, 1, 2]], dtype=np.int32)
    m = tmesh.TriMesh(verts, faces, device=CPU).clean()
    assert m.n_points == 3 and m.n_faces == 1


# ── the device rule and the meshkit loader ─────────────────


def test_no_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.TriMesh(np.zeros((3, 3)), np.array([[0, 1, 2]]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.TriMesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.make_sphere_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.TriMesh(device=CPU).to(None)


def test_meshkit_builds_into_the_port_build_dir():
    p = tnative.library_path()
    assert p.parent == tnative.BUILD_DIR and p.parent.name == "_build"
    assert p.parent.parent.name == "omfs4d_torch" and p.name.startswith("libmeshkit_")
    assert tnative.SOURCE.name == "meshkit.cpp" and tnative.SOURCE.parent.name == "native"
    tnative.load_library()
    assert p.exists()


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    tnative.load_library.cache_clear()
    yield tmp_path
    tnative.load_library.cache_clear()


def test_meshkit_without_gxx_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        tnative.qem_decimate(np.zeros((3, 3), np.float32), np.array([[0, 1, 2]]), 1)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        tp.make_sphere_mesh(device=CPU).decimate(0.5)
    assert not (fresh_build / "build").exists()


def test_meshkit_compile_failure_raises_with_the_message(fresh_build, monkeypatch):
    broken = fresh_build / "meshkit.cpp"
    broken.write_text("extern \"C\" int qem_decimate( { this is not C++ }\n")
    monkeypatch.setattr(tnative, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        tnative.load_library()
    assert "error" in str(e.value)
    assert not list((fresh_build / "build").glob("*.so"))


def test_qem_refuses_bad_input():
    with pytest.raises(ValueError):
        tnative.qem_decimate(np.zeros((3, 2), np.float32), np.array([[0, 1, 2]]), 1)
    with pytest.raises(ValueError):
        tnative.qem_decimate(np.zeros((3, 3), np.float32), np.array([[0, 1, 3]]), 1)
