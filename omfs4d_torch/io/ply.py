"""First-party PLY reader/writer (plyfile is not a dependency).

Used for the `points3d.ply` dataset artifact (ref: render_surgery.py:189-192)
and for gaussian point-cloud checkpoints.  Supports ascii and
binary_little_endian, arbitrary vertex properties, and triangle faces.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_TYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int", "u4": "uint", "i2": "short", "u2": "ushort", "i1": "char"}


def load_ply(path: str | Path) -> dict:
    """Load a PLY file.

    Returns a dict with:
      "vertex": structured np.ndarray of vertex properties (always present)
      "face":   (M, 3) int32 triangle indices (present when faces exist)
    """
    raw = Path(path).read_bytes()
    header_end = raw.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header = raw[:header_end].decode("ascii", "ignore").splitlines()
    body = raw[header_end + len(b"end_header\n"):]

    fmt = "ascii"
    elements = []   # list of (name, count, [(prop_name, dtype) or ("__list__", name, count_t, item_t)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append({"name": parts[1], "count": int(parts[2]), "props": []})
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1]["props"].append(("list", parts[4], _PLY_TYPES[parts[2]], _PLY_TYPES[parts[3]]))
            else:
                elements[-1]["props"].append(("scalar", parts[2], _PLY_TYPES[parts[1]]))

    out = {}
    if fmt == "ascii":
        tokens = body.decode("ascii", "ignore").split()
        ti = 0
        for el in elements:
            scalar_props = [(p[1], p[2]) for p in el["props"] if p[0] == "scalar"]
            has_list = any(p[0] == "list" for p in el["props"])
            if not has_list:
                n_props = len(scalar_props)
                vals = np.array(tokens[ti : ti + el["count"] * n_props], dtype=np.float64)
                ti += el["count"] * n_props
                rec = np.zeros(el["count"], dtype=[(n, t) for n, t in scalar_props])
                vals = vals.reshape(el["count"], n_props)
                for j, (n, _) in enumerate(scalar_props):
                    rec[n] = vals[:, j]
                out[el["name"]] = rec
            else:
                faces = []
                for _ in range(el["count"]):
                    cnt = int(tokens[ti]); ti += 1
                    faces.append([int(tokens[ti + k]) for k in range(cnt)])
                    ti += cnt
                out[el["name"]] = np.array(faces, dtype=np.int32)
    elif fmt == "binary_little_endian":
        off = 0
        for el in elements:
            has_list = any(p[0] == "list" for p in el["props"])
            if not has_list:
                dt = np.dtype([(p[1], "<" + p[2]) for p in el["props"]])
                arr = np.frombuffer(body, dtype=dt, count=el["count"], offset=off)
                off += dt.itemsize * el["count"]
                out[el["name"]] = arr.copy()
            else:
                # assume single list property (face element)
                lp = next(p for p in el["props"] if p[0] == "list")
                count_dt = np.dtype("<" + lp[2])
                item_dt = np.dtype("<" + lp[3])
                faces = []
                for _ in range(el["count"]):
                    cnt = int(np.frombuffer(body, dtype=count_dt, count=1, offset=off)[0])
                    off += count_dt.itemsize
                    idx = np.frombuffer(body, dtype=item_dt, count=cnt, offset=off)
                    off += item_dt.itemsize * cnt
                    faces.append(idx.astype(np.int32))
                out[el["name"]] = np.array(faces, dtype=np.int32)
    else:
        raise ValueError(f"unsupported PLY format: {fmt}")
    return out


def save_ply(
    path: str | Path,
    vertices: np.ndarray | dict,
    faces: np.ndarray | None = None,
    binary: bool = True,
):
    """Write a PLY file.

    `vertices` may be an (N, 3) float array (properties x, y, z) or a dict of
    {property_name: (N,) array}.
    """
    if isinstance(vertices, dict):
        names = list(vertices.keys())
        cols = [np.asarray(vertices[n]) for n in names]
        n_verts = len(cols[0])
    else:
        v = np.asarray(vertices, dtype=np.float32)
        names = ["x", "y", "z"]
        cols = [v[:, 0], v[:, 1], v[:, 2]]
        n_verts = len(v)

    dtypes = [np.asarray(c).dtype for c in cols]
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0"]
    header.append(f"element vertex {n_verts}")
    for n, dt in zip(names, dtypes):
        code = dt.str.lstrip("<>|=")
        header.append(f"property {_INV_TYPES.get(code, 'float')} {n}")
    if faces is not None and len(faces):
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            rec = np.zeros(n_verts, dtype=[(n, "<" + _norm_code(dt)) for n, dt in zip(names, dtypes)])
            for n, c in zip(names, cols):
                rec[n] = c
            f.write(rec.tobytes())
            if faces is not None and len(faces):
                fa = np.asarray(faces, dtype="<i4")
                counts = np.full((len(fa), 1), fa.shape[1], dtype=np.uint8)
                rows = b"".join(
                    counts[i].tobytes() + fa[i].tobytes() for i in range(len(fa))
                )
                f.write(rows)
        else:
            for i in range(n_verts):
                f.write((" ".join(f"{np.asarray(c)[i]:g}" for c in cols) + "\n").encode())
            if faces is not None and len(faces):
                for face in np.asarray(faces, dtype=np.int64):
                    f.write((f"{len(face)} " + " ".join(str(int(x)) for x in face) + "\n").encode())


def _norm_code(dt: np.dtype) -> str:
    code = dt.str.lstrip("<>|=")
    return code if code in _INV_TYPES else "f4"
