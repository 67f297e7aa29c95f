"""Distance / angle measurement tools.

Port of `omfs4d.clinical.measure` (ref: app.py:1024-1162): point-to-point
distance in mm and three-point angle in degrees on the host, plus
nearest-vertex snapping onto a mesh on the mesh's device.
"""

from __future__ import annotations

import numpy as np
import torch

from omfs4d_torch.ops.mesh import TriMesh


def snap_to_mesh(mesh: TriMesh, point) -> np.ndarray:
    """Nearest mesh vertex to a picked point (float64 on the host)."""
    p = torch.as_tensor(np.asarray(point, dtype=np.float64), device=mesh.device)
    d = mesh.vertices.double() - p[None, :]
    dist = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
    return mesh.vertices[int(torch.argmin(dist))].cpu().numpy().astype(np.float64)


def distance_mm(p1, p2) -> float:
    """Euclidean distance between two points (mesh units are mm)."""
    return float(np.linalg.norm(np.asarray(p1, float) - np.asarray(p2, float)))


def angle_deg(p1, vertex, p2) -> float:
    """Angle at `vertex` formed by rays to p1 and p2, in degrees."""
    v1 = np.asarray(p1, float) - np.asarray(vertex, float)
    v2 = np.asarray(p2, float) - np.asarray(vertex, float)
    n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
    if n1 < 1e-12 or n2 < 1e-12:
        raise ValueError("measurement points must be distinct from the vertex")
    cosang = np.clip(np.dot(v1, v2) / (n1 * n2), -1.0, 1.0)
    return float(np.degrees(np.arccos(cosang)))
