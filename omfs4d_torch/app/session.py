"""Planning-session state machine — the dashboard's logic layer.

Port of `omfs4d.app.session`.  The session holds its meshes on its `device`
(the CUDA card unless the caller asks for the CPU; it raises when there is
no card); export, the viewer and measurements take them to the host.

Extracts the reference dashboard's session behavior (ref: app.py) into a
UI-free class so it is testable and reusable from any frontend:

  * mesh ingestion (DICOM / NIfTI labels / demo sphere, app.py:513-695)
  * cut-plane preview + perform/replay (app.py:729-798)
  * segment movement with a 50-deep undo/redo history (app.py:110-148)
  * the clinical->visual bridge: the two scalars maxilla_mm / mandible_mm
    consumed by the prediction renderer (app.py:1438-1458)
  * mesh export (app.py:939-1022) and measurements (app.py:1024-1162)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import torch

from omfs4d_torch.clinical.measure import angle_deg, distance_mm, snap_to_mesh
from omfs4d_torch.clinical.surgical import SurgicalCutter
from omfs4d_torch.core.device import resolve_device
from omfs4d_torch.io.meshio import save_mesh, save_stl
from omfs4d_torch.ops.mesh import TriMesh

HISTORY_DEPTH = 50


@dataclass
class MovementState:
    maxilla_mm: float = 0.0
    mandible_mm: float = 0.0
    advancement_direction: tuple = (0.0, 1.0, 0.0)
    maxilla_rotation: tuple = (0.0, 0.0, 0.0)
    mandible_rotation: tuple = (0.0, 0.0, 0.0)


@dataclass
class PlanningSession:
    maxilla: TriMesh | None = None
    mandible: TriMesh | None = None
    cutter: SurgicalCutter | None = None
    cut_args: dict | None = None
    movement: MovementState = field(default_factory=MovementState)
    measurements: list = field(default_factory=list)
    _undo: list = field(default_factory=list)
    _redo: list = field(default_factory=list)
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device, "PlanningSession")

    # ── mesh ingestion ───────────────────────────────────────
    def load_meshes(self, maxilla: TriMesh, mandible: TriMesh | None = None):
        """Hold the meshes on the session's device (moved there if they are
        not)."""
        self.maxilla = maxilla.to(self.device)
        self.mandible = None if mandible is None else mandible.to(self.device)
        self.cutter = None
        self.cut_args = None
        self._undo.clear()
        self._redo.clear()

    def load_demo_sphere(self):
        from omfs4d_torch.ops.primitives import make_sphere_mesh

        self.load_meshes(
            make_sphere_mesh(radius=30, center=(0, 0, 20), device=self.device),
            make_sphere_mesh(radius=30, center=(0, 0, -20), device=self.device),
        )

    # ── cutting ──────────────────────────────────────────────
    def preview(self, **cut_args) -> dict:
        """Plane preview only — does not touch a performed cut's state."""
        if self.maxilla is None:
            raise RuntimeError("load meshes first")
        return SurgicalCutter(self.maxilla,
                              self.mandible).preview_planes(**cut_args)

    def perform_cut(self, **cut_args) -> dict:
        if self.maxilla is None:
            raise RuntimeError("load meshes first")
        self.cutter = SurgicalCutter(self.maxilla, self.mandible)
        result = self.cutter.perform_cut(**cut_args)
        self.cut_args = dict(cut_args)
        empty = [k for k, v in result.items() if v is None or v.n_points == 0]
        if empty:
            # parity with the reference's post-cut warning (app.py:794-795)
            result["_warnings"] = [f"empty segment(s): {', '.join(empty)}"]
        return result

    # ── movement + history ───────────────────────────────────
    def set_movement(self, **kw) -> dict:
        """Update movement sliders; history records the previous state."""
        if self.cutter is None or self.cutter.mobile_maxilla is None:
            raise RuntimeError("perform a cut before moving segments")
        self._undo.append(MovementState(**vars(self.movement)))
        if len(self._undo) > HISTORY_DEPTH:
            self._undo.pop(0)
        self._redo.clear()
        for k, v in kw.items():
            if not hasattr(self.movement, k):
                raise KeyError(f"unknown movement field {k!r}")
            setattr(self.movement, k, v)
        return self.apply_movement()

    def apply_movement(self) -> dict:
        m = self.movement
        return self.cutter.move_segments(
            maxilla_mm=m.maxilla_mm,
            mandible_mm=m.mandible_mm,
            advancement_direction=m.advancement_direction,
            maxilla_rotation=m.maxilla_rotation,
            mandible_rotation=m.mandible_rotation,
        )

    def save_state(self):
        """Explicitly push the current movement onto the undo history
        (the reference's 💾 Save State button, app.py:900-903)."""
        self._undo.append(MovementState(**vars(self.movement)))
        if len(self._undo) > HISTORY_DEPTH:
            self._undo.pop(0)
        self._redo.clear()

    @property
    def history_info(self) -> tuple[int, int]:
        """(position, total) for the reference's history caption
        (app.py:906-907)."""
        return len(self._undo), len(self._undo) + len(self._redo)

    def undo(self) -> dict:
        if not self._undo:
            raise RuntimeError("nothing to undo")
        self._redo.append(MovementState(**vars(self.movement)))
        self.movement = self._undo.pop()
        return self.apply_movement()

    def redo(self) -> dict:
        if not self._redo:
            raise RuntimeError("nothing to redo")
        self._undo.append(MovementState(**vars(self.movement)))
        self.movement = self._redo.pop()
        return self.apply_movement()

    @property
    def can_undo(self) -> bool:
        return bool(self._undo)

    @property
    def can_redo(self) -> bool:
        return bool(self._redo)

    # ── bridge to the visual engine ──────────────────────────
    def surgical_plan(self) -> dict:
        """The two scalars consumed by render-surgery (app.py:1438-1458)."""
        return {
            "maxilla_mm": self.movement.maxilla_mm,
            "mandible_mm": self.movement.mandible_mm,
        }

    # ── export + measurements ────────────────────────────────
    ALL_SEGMENTS = ("upper_skull", "mobile_maxilla", "distal_mandible",
                    "proximal_rami")

    def export(self, path: str | Path, segments: dict | None = None,
               include: tuple[str, ...] | None = None,
               stl_ascii: bool = False):
        """Merge selected segments and write STL/PLY/OBJ (the reference's
        segment-multiselect export, app.py:946-1022)."""
        segs = segments or self.apply_movement()
        combined = None
        # None = "all segments"; an explicitly empty selection falls through
        # to the "nothing to export" error instead of silently exporting all
        selected = self.ALL_SEGMENTS if include is None else include
        for key in selected:
            seg = segs.get(key)
            if seg is not None and seg.n_points:
                combined = seg if combined is None else combined.merge(seg)
        if combined is None:
            raise RuntimeError("nothing to export")
        vertices, faces = combined.numpy()
        if Path(path).suffix.lower() == ".stl":
            save_stl(path, vertices, faces, binary=not stl_ascii)
        else:
            save_mesh(path, vertices, faces)
        return path

    def export_filename(self, fmt: str = "stl") -> str:
        """Reference's download filename contract (app.py:1014)."""
        return (f"surgical_plan_maxilla{self.movement.maxilla_mm:+.1f}mm"
                f"_mandible{self.movement.mandible_mm:+.1f}mm.{fmt}")

    # ── in-browser 3D previews (reference: stpyvista panes) ──
    def preview_scene(self, **cut_args) -> list:
        """Cut-plane preview scene (app.py:768-798) for the WebGL viewer."""
        from omfs4d_torch.app.viewer import scene_payload
        planes = self.preview(**cut_args)
        keys = (("maxilla", "mandible") if self.mandible is not None
                else ("combined",)) + ("lefort", "bsso_l", "bsso_r")
        return scene_payload({k: planes.get(k) for k in keys})

    def moved_scene(self) -> list:
        """Post-osteotomy segment scene (app.py:918-937)."""
        from omfs4d_torch.app.viewer import scene_payload
        return scene_payload(self.apply_movement())

    def write_preview_html(self, path: str | Path, moved: bool = False,
                           **cut_args) -> Path:
        from omfs4d_torch.app.viewer import scene_to_html
        scene = self.moved_scene() if moved else self.preview_scene(**cut_args)
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(scene_to_html(scene), encoding="utf-8")
        return p

    # ── measurements (reference: app.py:1024-1162) ───────────
    def measure_distance(self, p1, p2, snap_mesh: TriMesh | None = None) -> float:
        if snap_mesh is not None:
            p1 = snap_to_mesh(snap_mesh, p1)
            p2 = snap_to_mesh(snap_mesh, p2)
        return distance_mm(p1, p2)

    def measure_angle(self, p1, vertex, p2) -> float:
        return angle_deg(p1, vertex, p2)

    def add_measurement(self, kind: str, points: list) -> dict:
        """Compute + save a measurement record (app.py:1083-1092, 1140-1149)."""
        if kind == "distance":
            value = f"{self.measure_distance(points[0], points[1]):.2f} mm"
        elif kind == "angle":
            value = f"{self.measure_angle(points[0], points[1], points[2]):.1f}°"
        else:
            raise ValueError(f"unknown measurement kind {kind!r}")
        rec = {"type": kind, "points": [list(map(float, p)) for p in points],
               "value": value}
        self.measurements.append(rec)
        return rec

    def delete_measurement(self, index: int):
        self.measurements.pop(index)

    def clear_measurements(self):
        self.measurements.clear()
