"""Marching tetrahedra of the port (`omfs4d_torch.ops.marching`) against the
JAX package's host NumPy version (`omfs4d.ops.marching`) on the CPU: the same
seeded volumes through both, faces equal array for array and vertices equal
(atol 1e-6).  Spheres and boxes, seeded random fields, integer volumes with
the level on voxel values (ties), chunks small enough to cross, spacing other
than 1, and the empty, full and thin volumes.  Then the reference's own
invariants (`tests/test_ops.py::TestMarching`) on the port's output."""

import numpy as np
import pytest
import torch

from omfs4d.ops import marching as jm
from omfs4d_torch.ops import marching as tm


def grid(n):
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    return z, y, x, (n - 1) / 2


def sphere(n, radius_field):
    z, y, x, c = grid(n)
    return radius_field - np.sqrt((z - c) ** 2 + (y - c) ** 2 + (x - c) ** 2)


def box(n, half):
    z, y, x, c = grid(n)
    return half - np.maximum.reduce([np.abs(z - c), np.abs(y - c), np.abs(x - c)])


def seeded(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def integer(shape, seed=1, top=4):
    return np.random.default_rng(seed).integers(0, top, size=shape).astype(np.float32)


CASES = {
    "sphere 32": (lambda: sphere(32, 15.0), 5.0, {}),
    "sphere 16 off-grid level": (lambda: sphere(16, 6.3), 1.17, {}),
    "box 20": (lambda: box(20, 8.0), 2.0, {}),
    "box 24 level on a face": (lambda: box(24, 8.0), 3.0, {}),
    "random 20x24x22": (lambda: seeded((20, 24, 22)), 0.1, {}),
    "random 17^3 level 0": (lambda: seeded((17, 17, 17), seed=5), 0.0, {}),
    "integer ties": (lambda: integer((16, 17, 18)), 2.0, {}),
    "integer ties level 0": (lambda: integer((12, 13, 14), seed=3, top=2), 0.0, {}),
    "HU ties at 300": (lambda: np.round(seeded((18, 18, 18), 7) * 600).astype(np.float32),
                       300.0, {}),
    "chunks of 97 cells": (lambda: integer((16, 17, 18)), 2.0, {"max_chunk_cells": 97}),
    "chunks of 1000 cells": (lambda: seeded((20, 24, 22)), 0.1, {"max_chunk_cells": 1000}),
    "spacing 0.3, 0.5, 2": (lambda: seeded((20, 24, 22)), 0.1, {"spacing": (0.3, 0.5, 2.0)}),
    "spacing of a CBCT": (lambda: sphere(24, 9.0), 0.0, {"spacing": (0.3, 0.3, 0.3)}),
    "float64 input": (lambda: sphere(16, 6.0).astype(np.float64), 1.0, {}),
    "int16 input": (lambda: (sphere(16, 6.0) * 100).astype(np.int16), 100.0, {}),
    "empty": (lambda: np.zeros((8, 8, 8), np.float32), 0.5, {}),
    "full": (lambda: np.ones((8, 8, 8), np.float32), 0.5, {}),
    "one slice": (lambda: seeded((1, 9, 9)), 0.0, {}),
    "side of 2": (lambda: seeded((2, 9, 7)), 0.0, {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_marching_matches_reference(name):
    make, level, kw = CASES[name]
    vol = make()
    rv, rf = jm.marching_cubes(vol, level, **kw)
    pv, pf = tm.marching_cubes(vol, level, device="cpu", **kw)
    assert pv.dtype == torch.float32 and pf.dtype == torch.int64
    assert pf.shape == rf.shape and pv.shape == rv.shape
    np.testing.assert_array_equal(pf.numpy(), rf)
    np.testing.assert_allclose(pv.numpy(), rv, rtol=0, atol=1e-6)


def test_marching_takes_a_tensor():
    vol = seeded((12, 13, 14))
    rv, rf = jm.marching_cubes(vol, 0.2)
    pv, pf = tm.marching_cubes(torch.from_numpy(vol), 0.2, device="cpu")
    np.testing.assert_array_equal(pf.numpy(), rf)
    np.testing.assert_array_equal(pv.numpy(), rv)


def test_duplicate_edge_positions_keep_the_last_write():
    """An edge reached from two tets in opposite orders interpolates from the
    other end: its positions differ in the last bit, and both packages keep
    the last one written.  The random field has such edges."""
    vol = seeded((20, 24, 22))
    lvl = float(np.float32(0.1))
    inside = tm._threshold(torch.from_numpy(vol), lvl)
    active = tm._active_cells(inside)
    cy, cx = 23, 21
    keys, pos, _ = tm._emit_chunk(torch.from_numpy(vol), lvl, active // (cy * cx),
                                  (active % (cy * cx)) // cx, active % cx)
    order = torch.argsort(keys, stable=True)
    k, p = keys[order], pos[order]
    same = k[1:] == k[:-1]
    differ = (p[1:] != p[:-1]).any(dim=1) & same
    assert int(differ.sum()) > 0
    rv, _ = jm.marching_cubes(vol, 0.1)
    pv, _ = tm.marching_cubes(vol, 0.1, device="cpu")
    np.testing.assert_array_equal(pv.numpy(), rv)


def test_tet_inverses_are_integer():
    d = tm._TET_D.astype(np.float64)
    assert np.allclose(np.abs(np.linalg.det(d)), 1.0)
    np.testing.assert_array_equal(np.einsum("tij,tjk->tik", tm._TET_DINV, tm._TET_D),
                                  np.broadcast_to(np.eye(3, dtype=np.int64), (6, 3, 3)))


# ── the reference's invariants (tests/test_ops.py::TestMarching) ──


def port(vol, level, **kw):
    v, f = tm.marching_cubes(vol, level, device="cpu", **kw)
    return v.numpy(), f.numpy()


@pytest.mark.parametrize("n, r_field, level", [(32, 15.0, 5.0), (28, 12.0, 2.0)])
def test_sphere_surface(n, r_field, level):
    c = (n - 1) / 2
    verts, faces = port(sphere(n, r_field), level)
    assert len(verts) > 100 and len(faces) > 100
    r = np.linalg.norm(verts - c, axis=1)
    np.testing.assert_allclose(r.mean(), r_field - level, atol=0.2)
    assert r.std() < 0.2


@pytest.mark.parametrize("vol, level", [(box(20, 8.0), 2.0), (sphere(18, 7.0), 1.5),
                                        (integer((14, 15, 16), seed=4), 2.0)],
                         ids=["box", "sphere", "integer ties"])
def test_watertight(vol, level):
    """Every edge shared by exactly 2 triangles: with the volume's border set
    to its minimum every surface closes, ties at the level included."""
    vol = vol.copy()
    vol[[0, -1], :, :] = vol[:, [0, -1], :] = vol[:, :, [0, -1]] = vol.min()
    _, faces = port(vol, level)
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]),
                    axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()


def test_orientation_outward():
    n = 24
    c = (n - 1) / 2
    verts, faces = port(sphere(n, 10.0), 2.0)
    tri = verts[faces]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    centroid = tri.mean(axis=1) - c
    assert ((nrm * centroid).sum(1) > 0).mean() > 0.99


def test_spacing():
    verts, _ = port(sphere(16, 6.0), 1.0, spacing=(2.0, 1.0, 1.0))
    assert verts[:, 0].max() - verts[:, 0].min() > 1.5 * (verts[:, 1].max() - verts[:, 1].min())
