"""FLAME asset loading + deterministic synthetic stand-in asset.

The reference depends on the licensed `flame2023.pkl` +
`landmark_embedding_with_eyes.npy` files (ref: flame_fitter.py:37-39, 75-120)
which cannot be redistributed.  This module:

  * loads a real FLAME pickle when the user supplies one
    (`load_flame_asset(path)` — same fields as flame_fitter.py:84-120:
    v_template, shapedirs (300 shape + 100 expr), posedirs, J_regressor,
    weights, kintree_table, f; landmark barycentric embedding), and
  * generates a schema-identical *synthetic head asset*
    (`synthetic_flame_asset()`) — a deterministic procedural head mesh with
    5 joints (global, neck, jaw, eye_l, eye_r), smooth region-based LBS
    weights, low-frequency blendshape fields and a 68-point landmark
    embedding — so every test/bench runs without licensed data.

Joint order (FLAME convention): 0 global, 1 neck, 2 jaw, 3 eye_l, 4 eye_r.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

N_JOINTS = 5
N_SHAPE = 300
N_EXPR = 100
PARENTS = np.array([-1, 0, 1, 1, 1], dtype=np.int32)


def _as_dense(x):
    if hasattr(x, "todense"):
        return np.asarray(x.todense())
    return np.asarray(x)


def load_flame_asset(pkl_path: str | Path, lmk_path: str | Path | None = None) -> dict:
    """Load a real FLAME 20xx pickle (+ optional landmark embedding npy)."""
    with open(pkl_path, "rb") as f:
        model = pickle.load(f, encoding="latin1")

    shapedirs = np.asarray(model["shapedirs"], dtype=np.float32)
    asset = {
        "v_template": np.asarray(model["v_template"], dtype=np.float32),
        "shapedirs_shape": shapedirs[:, :, :N_SHAPE],
        "shapedirs_expr": shapedirs[:, :, N_SHAPE : N_SHAPE + N_EXPR],
        "posedirs": np.asarray(model.get("posedirs", np.zeros((shapedirs.shape[0], 3, 36))), dtype=np.float32),
        "J_regressor": _as_dense(model["J_regressor"]).astype(np.float32),
        "lbs_weights": np.asarray(model["weights"], dtype=np.float32),
        "parents": np.asarray(model["kintree_table"], dtype=np.int64)[0].copy(),
        "faces": np.asarray(model["f"], dtype=np.int32),
    }
    asset["parents"][0] = -1
    if lmk_path is not None:
        lmk = np.load(str(lmk_path), allow_pickle=True)[()]
        asset["lmk_faces_idx"] = np.asarray(lmk["full_lmk_faces_idx"], dtype=np.int32).reshape(-1)
        asset["lmk_bary_coords"] = np.asarray(lmk["full_lmk_bary_coords"], dtype=np.float32).reshape(-1, 3)
    else:
        asset["lmk_faces_idx"] = np.zeros((0,), np.int32)
        asset["lmk_bary_coords"] = np.zeros((0, 3), np.float32)
    return asset


# ── synthetic asset ─────────────────────────────────────────


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    theta = phi * i
    return np.stack([r * np.cos(theta), y, r * np.sin(theta)], axis=1)


def _smooth_field(verts: np.ndarray, rng: np.random.Generator, n_modes: int = 4) -> np.ndarray:
    """Low-frequency random scalar field over vertices (sum of plane waves)."""
    field = np.zeros(len(verts))
    for _ in range(n_modes):
        k = rng.normal(size=3) * 2.0
        phase = rng.uniform(0, 2 * np.pi)
        field += rng.normal() * np.sin(verts @ k + phase)
    return field


def synthetic_flame_asset(
    n_vertices: int = 5143,
    n_shape: int = N_SHAPE,
    n_expr: int = N_EXPR,
    seed: int = 0,
) -> dict:
    """Deterministic procedural head asset with the FLAME tensor schema.

    Head: ellipsoid scaled to human-ish proportions in FLAME's canonical
    frame (y up, z forward, meters; head radius ~0.09-0.11 m, centered near
    the origin).  Triangulation via convex hull of a Fibonacci sphere.
    """
    from scipy.spatial import ConvexHull

    rng = np.random.default_rng(seed)
    sphere = _fibonacci_sphere(n_vertices)
    hull = ConvexHull(sphere)
    faces = hull.simplices.astype(np.int32)

    # Fix hull winding so normals point outward.
    tri = sphere[faces]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = (nrm * tri.mean(axis=1)).sum(1) < 0
    faces[flip] = faces[flip][:, ::-1]

    # Deform into a head: ellipsoid + chin/jaw protrusion (z forward, y up).
    v = sphere * np.array([0.085, 0.115, 0.095])
    y, z = v[:, 1], v[:, 2]
    jaw_region = np.clip((-y - 0.02) / 0.06, 0.0, 1.0) * np.clip((z + 0.02) / 0.08, 0.0, 1.0)
    v[:, 2] += 0.015 * jaw_region          # chin forward
    v[:, 1] -= 0.010 * jaw_region          # chin down
    v_template = v.astype(np.float32)

    # Joints: global(center), neck(base), jaw(chin hinge), eyes(L/R front).
    joints = np.array([
        [0.0, 0.0, 0.0],
        [0.0, -0.09, -0.02],
        [0.0, -0.035, 0.035],
        [-0.032, 0.03, 0.07],
        [0.032, 0.03, 0.07],
    ], dtype=np.float64)

    # LBS weights: smooth region falloffs; global absorbs the remainder.
    d_jaw = np.linalg.norm(v - joints[2], axis=1)
    # saturating region weight: the chin core is fully jaw-weighted (==1),
    # edges fall off smoothly with distance from the jaw hinge
    w_jaw = np.clip(
        1.6 * jaw_region * np.exp(-(np.maximum(d_jaw - 0.07, 0.0) / 0.08) ** 2),
        0.0, 1.0,
    )
    d_el = np.linalg.norm(v - joints[3], axis=1)
    d_er = np.linalg.norm(v - joints[4], axis=1)
    w_el = np.exp(-(d_el / 0.015) ** 4)
    w_er = np.exp(-(d_er / 0.015) ** 4)
    w_neck = np.clip((-y - 0.06) / 0.05, 0.0, 1.0) * (1.0 - w_jaw)
    w_rest = np.clip(1.0 - w_jaw - w_el - w_er - w_neck, 0.0, None)
    W = np.stack([w_rest, w_neck, w_jaw, w_el, w_er], axis=1)
    W = W / W.sum(axis=1, keepdims=True)
    lbs_weights = W.astype(np.float32)

    # Joint regressor: inverse-distance weights over the 32 nearest verts.
    J_regressor = np.zeros((N_JOINTS, n_vertices), dtype=np.float32)
    for j in range(N_JOINTS):
        d = np.linalg.norm(v - joints[j], axis=1)
        idx = np.argsort(d)[:32]
        w = 1.0 / (d[idx] + 1e-3)
        J_regressor[j, idx] = (w / w.sum()).astype(np.float32)

    # Blendshapes: low-frequency smooth displacement fields, small scale.
    def dirs(k, scale):
        out = np.zeros((n_vertices, 3, k), dtype=np.float32)
        for i in range(k):
            for c in range(3):
                out[:, c, i] = _smooth_field(v * 12.0, rng) * scale
        return out

    # only the first few modes carry real energy (like PCA spectra)
    shapedirs_shape = dirs(min(n_shape, 16), 0.004)
    shapedirs_shape = np.concatenate(
        [shapedirs_shape, np.zeros((n_vertices, 3, n_shape - shapedirs_shape.shape[2]), np.float32)], axis=2
    )
    shapedirs_expr = dirs(min(n_expr, 16), 0.003)
    shapedirs_expr = np.concatenate(
        [shapedirs_expr, np.zeros((n_vertices, 3, n_expr - shapedirs_expr.shape[2]), np.float32)], axis=2
    )

    # Landmark embedding: 68 faces nearest to canonical face-feature points.
    face_centers = v[faces].mean(axis=1)
    front = face_centers[:, 2] > 0.05
    front_idx = np.flatnonzero(front)
    targets = _landmark_targets()
    lmk_faces = np.zeros(68, dtype=np.int32)
    for i, t in enumerate(targets):
        d = np.linalg.norm(face_centers[front_idx] - t, axis=1)
        lmk_faces[i] = front_idx[np.argmin(d)]
    bary = rng.dirichlet(np.ones(3) * 8.0, size=68).astype(np.float32)

    return {
        "v_template": v_template,
        "shapedirs_shape": shapedirs_shape,
        "shapedirs_expr": shapedirs_expr,
        "posedirs": np.zeros((n_vertices, 3, (N_JOINTS - 1) * 9), dtype=np.float32),
        "J_regressor": J_regressor,
        "lbs_weights": lbs_weights,
        "parents": PARENTS.astype(np.int64),
        "faces": faces,
        "lmk_faces_idx": lmk_faces,
        "lmk_bary_coords": bary,
    }


def _landmark_targets() -> np.ndarray:
    """Canonical 68-landmark target positions on the synthetic head (meters)."""
    pts = []
    # jaw contour (17)
    for i in range(17):
        t = i / 16.0
        ang = np.pi * (0.15 + 0.7 * t)
        pts.append([-0.08 * np.cos(ang), -0.05 - 0.03 * np.sin(ang - np.pi / 2) * 0, 0.05 + 0.02 * np.sin(ang)])
    # brows (10)
    for i in range(5):
        pts.append([-0.05 + 0.018 * i, 0.045, 0.085])
    for i in range(5):
        pts.append([0.05 - 0.018 * (4 - i) * 0, 0.045, 0.085])
    # nose (9)
    for i in range(4):
        pts.append([0.0, 0.03 - 0.015 * i, 0.095])
    for i in range(5):
        pts.append([-0.02 + 0.01 * i, -0.01, 0.09])
    # eyes (12)
    for i in range(6):
        pts.append([-0.032 + 0.005 * np.cos(i), 0.03 + 0.004 * np.sin(i), 0.08])
    for i in range(6):
        pts.append([0.032 + 0.005 * np.cos(i), 0.03 + 0.004 * np.sin(i), 0.08])
    # mouth (20)
    for i in range(12):
        ang = 2 * np.pi * i / 12
        pts.append([0.025 * np.cos(ang), -0.035 + 0.012 * np.sin(ang), 0.088])
    for i in range(8):
        ang = 2 * np.pi * i / 8
        pts.append([0.015 * np.cos(ang), -0.035 + 0.006 * np.sin(ang), 0.089])
    return np.asarray(pts[:68], dtype=np.float64)


def save_asset(path: str | Path, asset: dict) -> None:
    np.savez_compressed(path, **asset)


def load_asset_npz(path: str | Path) -> dict:
    return dict(np.load(path, allow_pickle=False))
