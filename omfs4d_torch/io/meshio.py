"""Triangle-mesh export/import: STL (binary or ASCII), OBJ, PLY.

Port of `omfs4d.io.meshio` (host NumPy; near verbatim): the bytes written
are the reference's, and each package loads the other's files.  Parity with
the reference's mesh download surface (STL/PLY/OBJ export, ref:
app.py:939-1022) without VTK.  The functions take NumPy arrays; a
`TriMesh` on any device hands them over with `TriMesh.numpy()`.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from omfs4d_torch.io.ply import load_ply, save_ply


def save_stl(path: str | Path, vertices: np.ndarray, faces: np.ndarray,
             binary: bool = True):
    """Write an STL, binary by default (the reference exposes both flavors
    in its export selectbox, app.py:949-954 / binary= flag at 999-1001)."""
    v = np.asarray(vertices, dtype=np.float32)
    f = np.asarray(faces, dtype=np.int64)
    tri = v[f]                                    # (M, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(norm > 1e-12, n / np.maximum(norm, 1e-12), 0.0).astype(np.float32)

    if not binary:
        with open(path, "w", encoding="ascii") as fh:
            fh.write("solid omfs4d\n")
            for nrm, t in zip(n, tri):
                fh.write(f"facet normal {nrm[0]:.6e} {nrm[1]:.6e} {nrm[2]:.6e}\n")
                fh.write("  outer loop\n")
                for p in t:
                    fh.write(f"    vertex {p[0]:.6e} {p[1]:.6e} {p[2]:.6e}\n")
                fh.write("  endloop\nendfacet\n")
            fh.write("endsolid omfs4d\n")
        return

    with open(path, "wb") as fh:
        fh.write(b"omfs4d binary stl".ljust(80, b"\x00"))
        fh.write(struct.pack("<I", len(f)))
        rec = np.zeros(len(f), dtype=np.dtype([
            ("normal", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2"),
        ], align=False))
        rec["normal"] = n
        rec["v"] = tri
        fh.write(rec.tobytes())


def load_stl(path: str | Path):
    """Read an STL (binary or ASCII, autodetected); returns (vertices, faces)
    with deduplicated verts."""
    raw = Path(path).read_bytes()
    if raw[:6].lower() == b"solid " and b"facet" in raw[:512]:
        pts = []
        for line in raw.decode("ascii", errors="ignore").splitlines():
            parts = line.split()
            if parts and parts[0] == "vertex":
                pts.append([float(x) for x in parts[1:4]])
        tri = np.asarray(pts, dtype=np.float32)
        verts, inverse = np.unique(tri.round(decimals=6), axis=0,
                                   return_inverse=True)
        return verts.astype(np.float32), inverse.reshape(-1, 3).astype(np.int32)
    n_tri = struct.unpack_from("<I", raw, 80)[0]
    rec = np.frombuffer(raw, dtype=np.dtype([
        ("normal", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2"),
    ], align=False), count=n_tri, offset=84)
    tri = rec["v"].reshape(-1, 3)
    verts, inverse = np.unique(tri.round(decimals=6), axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int32)
    return verts.astype(np.float32), faces


def save_obj(path: str | Path, vertices: np.ndarray, faces: np.ndarray):
    with open(path, "w", encoding="ascii") as fh:
        for v in np.asarray(vertices, dtype=np.float64):
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in np.asarray(faces, dtype=np.int64) + 1:
            fh.write(f"f {f[0]} {f[1]} {f[2]}\n")


def load_obj(path: str | Path):
    verts, faces = [], []
    for line in Path(path).read_text(encoding="ascii", errors="ignore").splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
            for k in range(1, len(idx) - 1):      # fan-triangulate
                faces.append([idx[0], idx[k], idx[k + 1]])
    return np.array(verts, dtype=np.float32), np.array(faces, dtype=np.int32)


def save_mesh(path: str | Path, vertices: np.ndarray, faces: np.ndarray):
    """Dispatch on extension: .stl / .obj / .ply."""
    suffix = Path(path).suffix.lower()
    if suffix == ".stl":
        save_stl(path, vertices, faces)
    elif suffix == ".obj":
        save_obj(path, vertices, faces)
    elif suffix == ".ply":
        save_ply(path, vertices, faces)
    else:
        raise ValueError(f"unsupported mesh format: {suffix}")


def load_mesh(path: str | Path):
    suffix = Path(path).suffix.lower()
    if suffix == ".stl":
        return load_stl(path)
    if suffix == ".obj":
        return load_obj(path)
    if suffix == ".ply":
        data = load_ply(path)
        v = data["vertex"]
        verts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
        faces = data.get("face", np.zeros((0, 3), dtype=np.int32))
        return verts, faces
    raise ValueError(f"unsupported mesh format: {suffix}")
