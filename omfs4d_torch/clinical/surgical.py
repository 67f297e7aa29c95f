"""Virtual osteotomy planning: Le Fort I + bilateral BSSO plane cuts.

Port of `omfs4d.clinical.surgical`: the same behavioral contract as the
reference's SurgicalCutter (ref: 01_Clinical_Engine/surgical_sim.py:59-329),
built on the port's plane clip (`omfs4d_torch.ops.mesh`).  The meshes stay
on their device; the plane normals and origins are host float64 values, as
in the reference.

Coordinate convention (medical / NIfTI):
    X = Left-Right, Y = Anterior-Posterior, Z = Superior-Inferior (up)

3 planes -> 4 segments:
    Le Fort I (normal Z, maxilla only):   above -> upper_skull (fixed),
                                          below -> mobile_maxilla (mobile)
    BSSO L/R (normal X, mandible only):   between -> distal_mandible (mobile),
                                          outside -> proximal_rami (fixed)

`move_segments` rotates mobile segments about their centroid
(pitch X -> yaw Z -> roll Y order, ref: surgical_sim.py:297-318) then
translates along a normalized advancement direction.
"""

from __future__ import annotations

import numpy as np

from omfs4d_torch.ops.mesh import TriMesh


def _axis_rotation(axis: int, degrees: float) -> np.ndarray:
    """3x3 rotation about a coordinate axis (0=X, 1=Y, 2=Z) by Rodrigues."""
    k = np.zeros(3)
    k[axis] = 1.0
    theta = np.radians(degrees)
    kx = np.cross(np.eye(3), k)  # skew-symmetric cross-product matrix
    return np.eye(3) + np.sin(theta) * kx + (1.0 - np.cos(theta)) * (kx @ kx)


def _unit(vec, fallback=None) -> np.ndarray:
    """Normalize; degenerate input returns ``fallback`` or raises."""
    v = np.asarray(vec, dtype=np.float64)
    norm = float(np.linalg.norm(v))
    if norm < 1e-12:
        if fallback is not None:
            return np.asarray(fallback, dtype=np.float64)
        raise ValueError("advancement_direction must be a non-zero vector.")
    return v / norm


def _angle_to_normal(base_normal, pitch_deg: float, yaw_deg: float):
    """Tilt a cut-plane normal: pitch about X first, then yaw about Z."""
    tilted = _axis_rotation(2, yaw_deg) @ _axis_rotation(0, pitch_deg) @ np.asarray(
        base_normal, dtype=np.float64
    )
    return tuple(_unit(tilted, fallback=base_normal))


def _normalise_direction(direction) -> np.ndarray:
    return _unit(direction)


def _plane_quad(center, direction, size: float, device) -> TriMesh:
    """Visualization quad for a cut plane (stand-in for pv.Plane)."""
    n = np.asarray(direction, dtype=np.float64)
    n = n / max(np.linalg.norm(n), 1e-12)
    helper = np.array([0.0, 0.0, 1.0]) if abs(n[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    u = np.cross(n, helper)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    c = np.asarray(center, dtype=np.float64)
    h = size / 2.0
    verts = np.stack([c - u * h - v * h, c + u * h - v * h, c + u * h + v * h, c - u * h + v * h])
    faces = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
    return TriMesh(verts.astype(np.float32), faces, device=device)


class SurgicalCutter:
    """Cuts separate maxilla and mandible meshes with 3 planes.

    Falls back to best-effort single-mesh mode when only one mesh is given
    (parity: surgical_sim.py:59-87).
    """

    def __init__(self, maxilla_mesh: TriMesh, mandible_mesh: TriMesh | None = None):
        self.maxilla = maxilla_mesh
        self.mandible = mandible_mesh
        self.has_separate = mandible_mesh is not None and mandible_mesh.n_points > 0

        self.upper_skull: TriMesh | None = None
        self.mobile_maxilla: TriMesh | None = None
        self.distal_mandible: TriMesh | None = None
        self.proximal_rami: TriMesh | None = None

    def get_combined_mesh(self) -> TriMesh:
        if self.has_separate:
            return self.maxilla.merge(self.mandible)
        return self.maxilla

    # ── Preview ──────────────────────────────────────────────
    def preview_planes(
        self,
        lefort_z: float,
        bsso_l_x: float,
        bsso_r_x: float,
        lefort_pitch: float = 0.0,
        lefort_yaw: float = 0.0,
        bsso_l_pitch: float = 0.0,
        bsso_l_yaw: float = 0.0,
        bsso_r_pitch: float = 0.0,
        bsso_r_yaw: float = 0.0,
    ) -> dict:
        combined = self.get_combined_mesh()
        b = combined.bounds
        sizes = [b[1] - b[0], b[3] - b[2], b[5] - b[4]]
        plane_size = max(sizes) * 1.2
        center = combined.center

        lefort_n = _angle_to_normal((0, 0, 1), lefort_pitch, lefort_yaw)
        bsso_l_n = _angle_to_normal((1, 0, 0), bsso_l_pitch, bsso_l_yaw)
        bsso_r_n = _angle_to_normal((1, 0, 0), bsso_r_pitch, bsso_r_yaw)

        return {
            "maxilla": self.maxilla,
            "mandible": self.mandible,
            "combined": combined,
            "lefort": _plane_quad((center[0], center[1], lefort_z), lefort_n, plane_size,
                                  combined.device),
            "bsso_l": _plane_quad((bsso_l_x, center[1], center[2]), bsso_l_n, plane_size,
                                  combined.device),
            "bsso_r": _plane_quad((bsso_r_x, center[1], center[2]), bsso_r_n, plane_size,
                                  combined.device),
        }

    # ── Cut ──────────────────────────────────────────────────
    def perform_cut(
        self,
        lefort_z: float,
        bsso_l_x: float,
        bsso_r_x: float,
        lefort_pitch: float = 0.0,
        lefort_yaw: float = 0.0,
        bsso_l_pitch: float = 0.0,
        bsso_l_yaw: float = 0.0,
        bsso_r_pitch: float = 0.0,
        bsso_r_yaw: float = 0.0,
        lefort_flip: bool = False,
    ) -> dict:
        combined = self.get_combined_mesh()
        center = combined.center

        lefort_n = _angle_to_normal((0, 0, 1), lefort_pitch, lefort_yaw)
        bsso_l_n = _angle_to_normal((1, 0, 0), bsso_l_pitch, bsso_l_yaw)
        bsso_r_n = _angle_to_normal((1, 0, 0), bsso_r_pitch, bsso_r_yaw)

        lefort_origin = (center[0], center[1], lefort_z)
        bsso_l_origin = (bsso_l_x, center[1], center[2])
        bsso_r_origin = (bsso_r_x, center[1], center[2])

        if self.has_separate:
            source_max, source_mand = self.maxilla, self.mandible
        else:
            source_max = source_mand = self.maxilla

        def halves(mesh: TriMesh, normal, origin):
            """(above, below) the plane — above = along +normal."""
            return (
                mesh.clip(normal, origin, invert=False),
                mesh.clip(normal, origin, invert=True),
            )

        # Le Fort I on the maxilla: +Z side is the fixed skull.  In
        # single-mesh mode `lefort_flip` swaps which side is mobile.
        above, below = halves(source_max, lefort_n, lefort_origin)
        if lefort_flip and not self.has_separate:
            above, below = below, above
        upper_skull, mobile_maxilla = above, below

        # BSSO on the mandible: the slab between the two sagittal planes is
        # the mobile distal segment; the outer halves are the fixed rami.
        inner_l, left_ramus = halves(source_mand, bsso_l_n, bsso_l_origin)
        right_ramus, distal_mandible = halves(inner_l, bsso_r_n, bsso_r_origin)

        nonempty_rami = [m for m in (left_ramus, right_ramus) if m.n_points]
        if len(nonempty_rami) == 2:
            proximal_rami = nonempty_rami[0].merge(nonempty_rami[1])
        elif nonempty_rami:
            proximal_rami = nonempty_rami[0]
        else:
            proximal_rami = TriMesh(device=source_mand.device)

        self.upper_skull = upper_skull
        self.mobile_maxilla = mobile_maxilla
        self.distal_mandible = distal_mandible
        self.proximal_rami = proximal_rami

        return {
            "upper_skull": upper_skull,
            "mobile_maxilla": mobile_maxilla,
            "distal_mandible": distal_mandible,
            "proximal_rami": proximal_rami,
        }

    # ── Move ─────────────────────────────────────────────────
    def move_segments(
        self,
        maxilla_mm: float = 0.0,
        mandible_mm: float = 0.0,
        advancement_direction=(0.0, 1.0, 0.0),
        maxilla_rotation=(0.0, 0.0, 0.0),
        mandible_rotation=(0.0, 0.0, 0.0),
    ) -> dict:
        """Rotate (about centroid: pitch X, yaw Z, roll Y) then translate the
        mobile segments; fixed segments are returned untouched."""
        if self.mobile_maxilla is None or self.distal_mandible is None:
            raise RuntimeError("Call perform_cut() before move_segments().")

        adv_dir = _normalise_direction(advancement_direction)

        def _move(mesh: TriMesh, mm: float, rotation) -> TriMesh:
            moved = mesh.copy()
            pitch, yaw, roll = rotation
            if any(r != 0.0 for r in rotation):
                c = moved.center
                if pitch != 0.0:
                    moved.rotate_x(pitch, point=c, inplace=True)
                if yaw != 0.0:
                    moved.rotate_z(yaw, point=c, inplace=True)
                if roll != 0.0:
                    moved.rotate_y(roll, point=c, inplace=True)
            moved.translate(adv_dir * mm, inplace=True)
            return moved

        return {
            "upper_skull": self.upper_skull,
            "mobile_maxilla": _move(self.mobile_maxilla, maxilla_mm, maxilla_rotation),
            "distal_mandible": _move(self.distal_mandible, mandible_mm, mandible_rotation),
            "proximal_rami": self.proximal_rami,
        }
