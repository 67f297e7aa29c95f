"""Procedural mesh primitives (demo geometry + test fixtures).

Port of `omfs4d.ops.primitives`: the vertices and faces are built on the
host as the reference builds them, then held by a `TriMesh` on `device`
(the CUDA card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np

from omfs4d_torch.ops.mesh import TriMesh


def make_sphere_mesh(radius: float = 30.0, center=(0, 0, 0), res: int = 24,
                     device=None) -> TriMesh:
    """UV-sphere TriMesh (stands in for pv.Sphere; demo skull halves in the
    dashboard, ref: app.py:513-538)."""
    thetas = np.linspace(0, np.pi, res)
    phis = np.linspace(0, 2 * np.pi, 2 * res, endpoint=False)
    verts = [np.array([center[0], center[1], center[2] + radius])]
    for t in thetas[1:-1]:
        for p in phis:
            verts.append(np.array([
                center[0] + radius * np.sin(t) * np.cos(p),
                center[1] + radius * np.sin(t) * np.sin(p),
                center[2] + radius * np.cos(t),
            ]))
    verts.append(np.array([center[0], center[1], center[2] - radius]))
    verts = np.array(verts, dtype=np.float32)
    faces = []
    n_ring = len(phis)
    for j in range(n_ring):
        faces.append([0, 1 + j, 1 + (j + 1) % n_ring])
    for i in range(res - 3):
        a = 1 + i * n_ring
        b = 1 + (i + 1) * n_ring
        for j in range(n_ring):
            j2 = (j + 1) % n_ring
            faces.append([a + j, b + j, b + j2])
            faces.append([a + j, b + j2, a + j2])
    last = len(verts) - 1
    a = 1 + (res - 3) * n_ring
    for j in range(n_ring):
        faces.append([last, a + (j + 1) % n_ring, a + j])
    return TriMesh(verts, np.array(faces, dtype=np.int32), device=device)
