"""Triangle-mesh container and geometry ops on tensors of one device.

Port of `omfs4d.ops.mesh`.  A `TriMesh` holds `vertices` (float32, (N, 3))
and `faces` (int64, (M, 3)) as tensors on one explicit device: the CUDA card
unless the caller asks for the CPU (`device="cpu"`), and it raises when there
is no card.  `numpy()` hands (float32, int32) arrays to export and the
viewer; `bounds` and `center` are host values in the reference's dtypes.

Every op keeps the reference's arithmetic where it decides a result, so the
card, the CPU and the reference give the same arrays:

  * ``clean``            -- row-unique (lexicographic, as `np.unique(axis=0)`)
                            with first occurrences taken by a scatter-min
  * ``plane_clip``       -- signed distances and edge parameters in float64,
                            each product and sum a separate op (no FMA)
  * ``vertex_adjacency`` -- the reference's padded (nbr, mask), vectorised
  * ``laplacian_smooth`` -- native/meshkit.cpp's arithmetic bit for bit:
                            float64 sums one padded column at a time, the
                            mean by `1.0 / cnt`, the update in float32
  * ``decimate``         -- QEM edge collapse in native/meshkit.cpp on the
                            host (`omfs4d_torch.native`), back to the device
  * ``decimate_cluster`` -- the reference's grid-clustering fallback

Conventions match the reference: `center` is the bounding-box center and
`clip(normal, origin, invert=False)` keeps the side with
(p - origin) . normal >= 0 (ref comment: surgical_sim.py:180-184).
"""

from __future__ import annotations

import numpy as np
import torch

from omfs4d_torch.core.device import resolve_device


def _f32(x: float) -> float:
    """`x` rounded to float32, as NumPy rounds a Python scalar that meets a
    float32 array (NEP 50): an exact float32 value then means the same on
    every device."""
    return float(np.float32(x))


def _first_of_groups(inverse: torch.Tensor, n_groups: int, reduce: str) -> torch.Tensor:
    """Per group of `inverse`, the smallest ("amin") or largest ("amax")
    position at which it occurs: a deterministic scatter on both devices."""
    n = inverse.numel()
    init = n if reduce == "amin" else -1
    pos = torch.arange(n, device=inverse.device)
    return torch.full((n_groups,), init, dtype=torch.int64, device=inverse.device).scatter_reduce_(
        0, inverse, pos, reduce)


def _drop_degenerate(f: torch.Tensor) -> torch.Tensor:
    ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    return f[ok]


def _dedup_faces(f: torch.Tensor) -> torch.Tensor:
    """Faces with the same unordered vertex set reduced to the first one,
    with its winding, in the original order."""
    if not len(f):
        return f
    uniq, inv = torch.unique(f.sort(dim=1).values, dim=0, return_inverse=True)
    first = _first_of_groups(inv, len(uniq), "amin")
    keep = torch.zeros(len(f), dtype=torch.bool, device=f.device)
    keep[first] = True
    return f[keep]


class TriMesh:
    """Indexed triangle mesh on one device."""

    def __init__(self, vertices=None, faces=None, device=None):
        self.device = resolve_device(device, "TriMesh")
        self.vertices = (
            torch.zeros((0, 3), dtype=torch.float32, device=self.device)
            if vertices is None
            else torch.as_tensor(vertices).to(self.device, torch.float32).reshape(-1, 3)
        )
        self.faces = (
            torch.zeros((0, 3), dtype=torch.int64, device=self.device)
            if faces is None
            else torch.as_tensor(faces).to(self.device, torch.int64).reshape(-1, 3)
        )

    # ── basic properties ─────────────────────────────────────
    @property
    def n_points(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_faces(self) -> int:
        return self.faces.shape[0]

    def numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """(vertices float32, faces int32) on the host, for export and the
        viewer."""
        return (self.vertices.cpu().numpy(),
                self.faces.cpu().numpy().astype(np.int32))

    def to(self, device) -> "TriMesh":
        """This mesh when it is on `device`, else a copy there."""
        dev = resolve_device(device, "TriMesh.to")
        return self if dev == self.device else TriMesh(self.vertices, self.faces, device=dev)

    @property
    def bounds(self):
        """(xmin, xmax, ymin, ymax, zmin, zmax) as float32 host values -- VTK
        layout."""
        if self.n_points == 0:
            return (0.0,) * 6
        mn = self.vertices.amin(dim=0).cpu().numpy()
        mx = self.vertices.amax(dim=0).cpu().numpy()
        return (mn[0], mx[0], mn[1], mx[1], mn[2], mx[2])

    @property
    def center(self):
        """Bounding-box center (PyVista convention), float32 arithmetic on the
        float32 bounds as the reference does."""
        b = self.bounds
        return np.array([(b[0] + b[1]) / 2, (b[2] + b[3]) / 2, (b[4] + b[5]) / 2])

    def copy(self) -> "TriMesh":
        return TriMesh(self.vertices.clone(), self.faces.clone(), device=self.device)

    # ── transforms ───────────────────────────────────────────
    def translate(self, vec, inplace: bool = False) -> "TriMesh":
        m = self if inplace else self.copy()
        shift = torch.as_tensor(np.asarray(vec, dtype=np.float32), device=m.device)
        m.vertices = m.vertices + shift[None, :]
        return m

    def _rotate(self, R: np.ndarray, point, inplace: bool) -> "TriMesh":
        """(v - p) R^T + p in float64, then float32.  Each output coordinate
        is summed left to right in separate ops, so the card and the CPU give
        the same bits; the reference's BLAS product may differ in the last
        float64 bit, which the float32 result almost never shows."""
        m = self if inplace else self.copy()
        p = np.zeros(3) if point is None else np.asarray(point, dtype=np.float64)
        d = m.vertices.double() - torch.as_tensor(p, device=m.device)
        cols = [(d[:, 0] * float(R[i, 0]) + d[:, 1] * float(R[i, 1])) + d[:, 2] * float(R[i, 2])
                for i in range(3)]
        m.vertices = (torch.stack(cols, dim=1) + torch.as_tensor(p, device=m.device)).float()
        return m

    def rotate_x(self, deg: float, point=None, inplace: bool = False) -> "TriMesh":
        a = np.radians(deg)
        R = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
        return self._rotate(R, point, inplace)

    def rotate_y(self, deg: float, point=None, inplace: bool = False) -> "TriMesh":
        a = np.radians(deg)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        return self._rotate(R, point, inplace)

    def rotate_z(self, deg: float, point=None, inplace: bool = False) -> "TriMesh":
        a = np.radians(deg)
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        return self._rotate(R, point, inplace)

    # ── topology ops ─────────────────────────────────────────
    def merge(self, other: "TriMesh") -> "TriMesh":
        if other is None or other.n_points == 0:
            return self.copy()
        other = other.to(self.device)
        if self.n_points == 0:
            return other.copy()
        verts = torch.cat([self.vertices, other.vertices])
        faces = torch.cat([self.faces, other.faces + self.n_points])
        return TriMesh(verts, faces, device=self.device)

    def clean(self, tol: float = 0.0) -> "TriMesh":
        """Merge coincident vertices, drop unused vertices + degenerate and
        duplicate faces (the first winding of a duplicate is kept)."""
        if self.n_points == 0:
            return self.copy()
        v = self.vertices
        key = v if tol <= 0 else torch.round(v / tol) * tol
        uniq, inv = torch.unique(key, dim=0, return_inverse=True)
        # representative positions: first occurrence
        new_v = v[_first_of_groups(inv, len(uniq), "amin")]
        new_f = _dedup_faces(_drop_degenerate(inv[self.faces]))
        # drop unused vertices
        used = torch.zeros(len(new_v), dtype=torch.bool, device=self.device)
        used[new_f.reshape(-1)] = True
        remap = torch.cumsum(used, dim=0) - 1
        return TriMesh(new_v[used], remap[new_f], device=self.device)

    def clip(self, normal, origin, invert: bool = False) -> "TriMesh":
        n = np.asarray(normal, dtype=np.float64)
        if invert:
            n = -n
        return plane_clip(self, n, np.asarray(origin, dtype=np.float64))

    def smooth(self, n_iter: int = 20, relaxation_factor: float = 0.01) -> "TriMesh":
        return laplacian_smooth(self, n_iter, relaxation_factor)

    def decimate(self, target_reduction: float) -> "TriMesh":
        return decimate(self, target_reduction)

    def connectivity_components(self):
        """Label connected components; returns (labels_per_vertex, count).
        A host union-find over `numpy()`, as the reference's."""
        n = self.n_points
        faces = self.numpy()[1]
        parent = np.arange(n)

        def find(a):
            root = a
            while parent[root] != root:
                root = parent[root]
            while parent[a] != root:
                parent[a], a = root, parent[a]
            return root

        for f in faces:
            ra, rb, rc = find(f[0]), find(f[1]), find(f[2])
            parent[rb] = ra
            parent[find(rc)] = find(ra)
        roots = np.array([find(i) for i in range(n)])
        uniq, labels = np.unique(roots, return_inverse=True)
        return labels, len(uniq)


# ── plane clip with triangle splitting ─────────────────────


def _signed_distance(vertices: torch.Tensor, normal: np.ndarray, origin) -> torch.Tensor:
    """(p - origin) . normal in float64, summed left to right in separate
    ops: no FMA on either device.  The reference's BLAS product may round a
    vertex within a few ulps of a tilted plane to the other side."""
    d = vertices.double() - torch.as_tensor(np.asarray(origin, dtype=np.float64),
                                           device=vertices.device)
    return (d[:, 0] * float(normal[0]) + d[:, 1] * float(normal[1])) + d[:, 2] * float(normal[2])


def plane_clip(mesh: TriMesh, normal, origin) -> TriMesh:
    """Keep the half-space (p - origin) . normal >= 0, splitting straddling
    triangles exactly at the plane (VTK-clip parity)."""
    if mesh.n_points == 0 or mesh.n_faces == 0:
        return TriMesh(device=mesh.device)
    n = np.asarray(normal, dtype=np.float64)
    n = n / max(np.linalg.norm(n), 1e-300)
    d = _signed_distance(mesh.vertices, n, origin)
    V, F, dev = mesh.vertices, mesh.faces, mesh.device

    keep_v = d[F] >= 0.0                        # (M, 3)
    n_keep = keep_v.sum(dim=1)

    out_verts = [V]
    out_faces = [F[n_keep == 3]]
    base = mesh.n_points

    def _intersect(pa, pb, da, db):
        t = da / (da - db)
        return V[pa] + t[:, None].float() * (V[pb] - V[pa])

    def _rotated(rows, start):
        """Each triangle of `rows` rotated so that slot `start` comes first."""
        f = F[rows]
        rot = (torch.arange(3, device=dev)[None, :] + start[:, None]) % 3
        return torch.take_along_dim(f, rot, dim=1)

    # Case: exactly 1 vertex kept -> 1 smaller triangle.
    one = torch.nonzero(n_keep == 1).reshape(-1)
    if one.numel():
        # rotate each triangle so the kept vertex is slot 0
        f = _rotated(one, keep_v[one].to(torch.uint8).argmax(dim=1))
        da, db, dc = d[f[:, 0]], d[f[:, 1]], d[f[:, 2]]
        pab = _intersect(f[:, 0], f[:, 1], da, db)
        pac = _intersect(f[:, 0], f[:, 2], da, dc)
        m = len(f)
        ia = base + torch.arange(m, device=dev)
        ic = base + m + torch.arange(m, device=dev)
        out_verts += [pab, pac]
        out_faces.append(torch.stack([f[:, 0], ia, ic], dim=1))
        base += 2 * m

    # Case: exactly 2 vertices kept -> quad -> 2 triangles.
    two = torch.nonzero(n_keep == 2).reshape(-1)
    if two.numel():
        # rotate so the DROPPED vertex is slot 0
        f = _rotated(two, keep_v[two].to(torch.uint8).argmin(dim=1))
        da, db, dc = d[f[:, 0]], d[f[:, 1]], d[f[:, 2]]
        pab = _intersect(f[:, 0], f[:, 1], da, db)   # on edge drop->kept1
        pac = _intersect(f[:, 0], f[:, 2], da, dc)   # on edge drop->kept2
        m = len(f)
        iab = base + torch.arange(m, device=dev)
        iac = base + m + torch.arange(m, device=dev)
        out_verts += [pab, pac]
        out_faces.append(torch.stack([iab, f[:, 1], f[:, 2]], dim=1))
        out_faces.append(torch.stack([iab, f[:, 2], iac], dim=1))
        base += 2 * m

    return TriMesh(torch.cat(out_verts), torch.cat(out_faces), device=dev).clean()


# ── Laplacian smoothing ────────────────────────────────────


def vertex_adjacency(faces: torch.Tensor, n_verts: int, max_degree: int = 0):
    """Fixed-width padded adjacency (neighbor ids, validity mask), equal to
    the reference's array for array: each vertex's distinct neighbours in
    ascending order, padded with 0 / False to the largest degree (at most
    `max_degree` when given)."""
    f = torch.as_tensor(faces).to(torch.int64)
    dev = f.device
    src = torch.cat([f[:, 0], f[:, 1], f[:, 1], f[:, 2], f[:, 2], f[:, 0]])
    dst = torch.cat([f[:, 1], f[:, 0], f[:, 2], f[:, 1], f[:, 0], f[:, 2]])
    key = torch.unique(src * max(n_verts, 1) + dst)          # sorted (src, dst) pairs
    src, dst = key // max(n_verts, 1), key % max(n_verts, 1)
    counts = torch.bincount(src, minlength=n_verts)
    deg = int(counts.max()) if len(counts) else 0
    if max_degree:
        deg = min(deg, max_degree)
    width = max(deg, 1)
    rank = torch.arange(len(key), device=dev) - (torch.cumsum(counts, 0) - counts)[src]
    sel = rank < deg
    nbr = torch.zeros((n_verts, width), dtype=torch.int64, device=dev)
    mask = torch.zeros((n_verts, width), dtype=torch.bool, device=dev)
    nbr[src[sel], rank[sel]] = dst[sel]
    mask[src[sel], rank[sel]] = True
    return nbr, mask


def smooth_vertices(vertices: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                    n_iter: int, relax: float) -> torch.Tensor:
    """`n_iter` Laplacian steps with native/meshkit.cpp's arithmetic
    (`laplacian_smooth`, meshkit.cpp:27-55), bit for bit, on the tensors'
    device: the neighbours of each vertex summed in float64 one padded column
    at a time, in column order; `mean = sum * (1.0 / cnt)`; the difference
    `(float)(mean - cur)`; then `cur + relax * diff` in float32, two ops.  A
    vertex with no neighbour stays put."""
    v = vertices.to(torch.float32)
    relax = _f32(relax)
    cnt = mask.sum(dim=1)
    has = (cnt > 0)[:, None]
    inv = (1.0 / cnt.clamp_min(1).double())[:, None]
    cols = [(nbr[:, k], mask[:, k, None]) for k in range(nbr.shape[1])
            if bool(mask[:, k].any())]
    zero = torch.zeros((), dtype=torch.float64, device=v.device)
    for _ in range(n_iter):
        v64 = v.double()
        acc = torch.zeros_like(v64)
        for idx, m in cols:
            acc = acc + torch.where(m, v64[idx], zero)
        diff = (acc * inv - v64).float()
        v = torch.where(has, v + diff * relax, v)
    return v


def laplacian_smooth(mesh: TriMesh, n_iter: int = 20, relaxation_factor: float = 0.01) -> TriMesh:
    """Classic Laplacian smoothing: v += lambda * (mean(neighbors) - v), on
    the mesh's device with meshkit's bits (`smooth_vertices`).

    Defaults mirror PyVista's `smooth` (relaxation_factor=0.01), which the
    reference calls with n_iter=30 (ref: dicom_loader.py:157-158).
    """
    if mesh.n_points == 0 or n_iter <= 0:
        return mesh.copy()
    nbr, mask = vertex_adjacency(mesh.faces, mesh.n_points)
    v = smooth_vertices(mesh.vertices, nbr, mask, n_iter, relaxation_factor)
    return TriMesh(v, mesh.faces.clone(), device=mesh.device)


# ── decimation ─────────────────────────────────────────────


def _target_faces(mesh: TriMesh, target_reduction: float) -> int | None:
    if mesh.n_faces == 0 or not (0.0 < target_reduction < 1.0):
        return None
    return max(int(mesh.n_faces * (1.0 - target_reduction)), 4)


def decimate(mesh: TriMesh, target_reduction: float) -> TriMesh:
    """QEM edge collapse to ~(1 - target_reduction) of the faces: the
    native/meshkit.cpp decimator on the host (a serial heap), the result
    cleaned on the mesh's device.  Raises when meshkit cannot be built; the
    reference falls back to grid clustering then (`decimate_cluster`)."""
    target = _target_faces(mesh, target_reduction)
    if target is None:
        return mesh.copy()
    from omfs4d_torch import native

    out_v, out_f = native.qem_decimate(*mesh.numpy(), target)
    return TriMesh(out_v, out_f, device=mesh.device).clean()


def decimate_cluster(mesh: TriMesh, target_reduction: float) -> TriMesh:
    """Vertex-clustering decimation to ~(1 - target_reduction) of the faces:
    the reference's fallback when meshkit is not built
    (`omfs4d.ops.mesh.decimate_cluster`), on the mesh's device."""
    target_faces = _target_faces(mesh, target_reduction)
    if target_faces is None:
        return mesh.copy()
    v = mesh.vertices
    lo = v.amin(dim=0)
    extent = torch.clamp_min(v.amax(dim=0) - lo, _f32(1e-9))

    # Binary-search the grid resolution that lands near the face target.
    lo_res, hi_res = 2, 512
    best = None
    for _ in range(12):
        res = (lo_res + hi_res) // 2
        m = _cluster_at(mesh, lo, extent, res)
        if best is None or abs(m.n_faces - target_faces) < abs(best.n_faces - target_faces):
            best = m
        if m.n_faces > target_faces:
            hi_res = max(res - 1, 2)
        else:
            lo_res = min(res + 1, 512)
        if lo_res >= hi_res:
            break
    return best


def _cluster_at(mesh: TriMesh, lo, extent, res: int) -> TriMesh:
    cell = torch.floor((mesh.vertices - lo) / extent * _f32(res - 1e-6)).to(torch.int64)
    key = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
    uniq, inv = torch.unique(key, return_inverse=True)
    n = len(uniq)
    # cluster representative = mean position
    sums = torch.zeros((n, 3), dtype=torch.float64, device=mesh.device).index_add_(
        0, inv, mesh.vertices.double())
    counts = torch.bincount(inv, minlength=n).double()
    new_v = (sums / counts[:, None]).float()
    new_f = _dedup_faces(_drop_degenerate(inv[mesh.faces]))
    return TriMesh(new_v, new_f, device=mesh.device).clean()
