"""The port's planning session, viewer and progress (`omfs4d_torch.app`) on
the CPU: the cases of `tests/test_session.py` on the port; the same edits
through the reference's session and the port's give the same history,
segments and exported files; the viewer's JSON and HTML equal the
reference's for the same meshes; the progress map is the reference's; the
dashboard's calls bind to the port's `Pipeline`."""

import ast
import inspect
import json
from pathlib import Path

import numpy as np
import pytest

from omfs4d.app import progress as jprogress
from omfs4d.app import viewer as jviewer
from omfs4d.app.session import PlanningSession as JSession
from omfs4d.ops.primitives import make_sphere_mesh as j_sphere
from omfs4d_torch.app import progress as tprogress
from omfs4d_torch.app import viewer as tviewer
from omfs4d_torch.app.session import HISTORY_DEPTH, PlanningSession
from omfs4d_torch.clinical.measure import angle_deg, distance_mm
from omfs4d_torch.io.meshio import load_mesh
from omfs4d_torch.ops.mesh import TriMesh
from omfs4d_torch.ops.primitives import make_sphere_mesh as t_sphere

CUT = dict(lefort_z=20, bsso_l_x=-15, bsso_r_x=15)


@pytest.fixture
def session():
    s = PlanningSession(device="cpu")
    s.load_demo_sphere()
    s.perform_cut(**CUT)
    return s


@pytest.fixture
def pair():
    """The reference's and the port's session after the same load and cut."""
    out = []
    for s in (JSession(), PlanningSession(device="cpu")):
        s.load_demo_sphere()
        s.perform_cut(**CUT)
        out.append(s)
    return out


def assert_same(ref, got):
    v, f = got.numpy()
    np.testing.assert_array_equal(f, ref.faces)
    np.testing.assert_allclose(v, ref.vertices, rtol=0, atol=1e-5)


# ── tests/test_session.py on the port ──────────────────────


def test_undo_redo_roundtrip(session):
    session.set_movement(maxilla_mm=5.0)
    session.set_movement(maxilla_mm=8.0)
    assert session.movement.maxilla_mm == 8.0
    session.undo()
    assert session.movement.maxilla_mm == 5.0
    session.undo()
    assert session.movement.maxilla_mm == 0.0
    session.redo()
    assert session.movement.maxilla_mm == 5.0


def test_history_depth_capped_and_redo_cleared(session):
    for i in range(HISTORY_DEPTH + 20):
        session.set_movement(maxilla_mm=float(i))
    assert len(session._undo) == HISTORY_DEPTH == 50
    session.undo()
    assert session.can_redo
    session.set_movement(mandible_mm=2.0)
    assert not session.can_redo


def test_session_errors(session):
    with pytest.raises(RuntimeError):
        session.undo()
    with pytest.raises(RuntimeError):
        session.redo()
    with pytest.raises(KeyError):
        session.set_movement(chin_mm=1.0)
    s = PlanningSession(device="cpu")
    with pytest.raises(RuntimeError):
        s.preview(**CUT)
    s.load_demo_sphere()
    with pytest.raises(RuntimeError):
        s.set_movement(maxilla_mm=1.0)


def test_surgical_plan_scalars(session):
    session.set_movement(maxilla_mm=4.0, mandible_mm=7.0)
    assert session.surgical_plan() == {"maxilla_mm": 4.0, "mandible_mm": 7.0}


def test_export_stl(session, tmp_path):
    session.set_movement(maxilla_mm=3.0)
    verts, faces = load_mesh(session.export(tmp_path / "plan.stl"))
    assert len(verts) > 100 and len(faces) > 100


def test_measure(session):
    assert distance_mm((0, 0, 0), (3, 4, 0)) == 5.0
    assert abs(angle_deg((1, 0, 0), (0, 0, 0), (0, 1, 0)) - 90.0) < 1e-9
    with pytest.raises(ValueError):
        angle_deg((0, 0, 0), (0, 0, 0), (1, 0, 0))
    d = session.measure_distance((0, 0, 52), (0, 0, -52),
                                 snap_mesh=session.maxilla.merge(session.mandible))
    assert abs(d - 100.0) < 2.0


def test_measurement_records(session):
    rec = session.add_measurement("distance", [(0, 0, 0), (3, 4, 0)])
    assert rec["value"] == "5.00 mm"
    rec2 = session.add_measurement("angle", [(-1, 0, 0), (0, 0, 0), (0, 1, 0)])
    assert rec2["value"] == "90.0°"
    session.delete_measurement(0)
    assert session.measurements[0]["type"] == "angle"
    session.clear_measurements()
    assert not session.measurements
    with pytest.raises(ValueError):
        session.add_measurement("area", [(0, 0, 0)])


def test_save_state_and_history_info(session):
    session.save_state()
    session.movement.maxilla_mm = 7.0
    assert session.history_info == (1, 1)
    session.undo()
    assert session.movement.maxilla_mm == 0.0 and session.history_info == (0, 1)


def test_selectable_export_and_ascii(session, tmp_path):
    va, _ = load_mesh(session.export(tmp_path / "all.stl"))
    vo, _ = load_mesh(session.export(tmp_path / "one.stl", include=("mobile_maxilla",)))
    assert len(vo) < len(va)
    with pytest.raises(RuntimeError):
        session.export(tmp_path / "none.stl", include=("nonexistent",))
    p_asc = session.export(tmp_path / "a.stl", include=("mobile_maxilla",), stl_ascii=True)
    assert p_asc.read_bytes()[:6] == b"solid "
    vb, fb = load_mesh(tmp_path / "one.stl")
    vas, fas = load_mesh(p_asc)
    assert fas.shape == fb.shape
    np.testing.assert_allclose(np.sort(vas, axis=0), np.sort(vb, axis=0), atol=1e-4)


def test_export_filename_contract(session):
    session.set_movement(maxilla_mm=5.0, mandible_mm=-3.0)
    assert session.export_filename("stl") == "surgical_plan_maxilla+5.0mm_mandible-3.0mm.stl"


def test_preview_and_moved_scenes(session, tmp_path):
    names = {m["name"] for m in session.preview_scene(**CUT)}
    assert {"lefort", "bsso_l", "bsso_r", "maxilla", "mandible"} <= names
    moved = session.moved_scene()
    assert {"mobile_maxilla", "distal_mandible"} <= {m["name"] for m in moved}
    for m in moved:
        assert len(m["positions"]) % 9 == 0 and len(m["normals"]) == len(m["positions"]) > 0
    html = session.write_preview_html(tmp_path / "prev.html", **CUT).read_text()
    assert "<canvas" in html and "webgl" in html and "lefort" in html
    assert "http" not in html.split("<script>")[1]


def test_session_holds_its_meshes_on_its_device():
    s = PlanningSession(device="cpu")
    m = t_sphere(10, res=8, device="cpu")
    s.load_meshes(m, None)
    assert s.maxilla is m and s.mandible is None and str(s.device) == "cpu"


# ── the port's session against the reference's ────────────

EDITS = [
    ("set", dict(maxilla_mm=5.0, mandible_mm=3.0)),
    ("set", dict(maxilla_rotation=(4.0, -2.0, 1.0), advancement_direction=(0.0, 1.0, 0.3))),
    ("undo", {}), ("undo", {}), ("redo", {}),
    ("set", dict(mandible_rotation=(0.0, 3.0, 0.0), mandible_mm=-2.0)),
    ("save", {}), ("undo", {}),
]


def test_history_and_segments_match_reference(pair, tmp_path):
    ref, got = pair
    for op, kw in EDITS:
        if op == "set":
            r, g = ref.set_movement(**kw), got.set_movement(**kw)
        elif op == "save":
            ref.save_state()
            got.save_state()
            continue
        else:
            r, g = getattr(ref, op)(), getattr(got, op)()
        assert vars(got.movement) == vars(ref.movement)
        assert got.history_info == ref.history_info
        for k in ref.ALL_SEGMENTS:
            assert_same(r[k], g[k])
    assert got.export_filename("ply") == ref.export_filename("ply")
    for name, kw in [("plan.stl", {}), ("plan_ascii.stl", {"stl_ascii": True}),
                     ("plan.ply", {}), ("plan.obj", {}),
                     ("max.stl", {"include": ("mobile_maxilla", "upper_skull")})]:
        pr, pg = ref.export(tmp_path / f"r_{name}", **kw), got.export(tmp_path / f"g_{name}", **kw)
        rv, rf = load_mesh(pr)
        gv, gf = load_mesh(pg)
        np.testing.assert_array_equal(gf, rf)
        np.testing.assert_allclose(gv, rv, rtol=0, atol=1e-5)


def test_cut_warnings_match_reference():
    ref, got = JSession(), PlanningSession(device="cpu")
    for s in (ref, got):
        s.load_demo_sphere()
    far = dict(lefort_z=200, bsso_l_x=-15, bsso_r_x=15)
    assert got.perform_cut(**far)["_warnings"] == ref.perform_cut(**far)["_warnings"]


# ── viewer and progress ────────────────────────────────────

SCENES = {
    "small": lambda s: s(10, (0, 0, 0), 8),
    "decimated past max_faces": lambda s: s(30, (1, 2, 3), 40),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_viewer_json_and_html_equal_reference(scene, tmp_path):
    rm = SCENES[scene](j_sphere)
    gm = TriMesh(rm.vertices, rm.faces, device="cpu")
    plane = j_sphere(5, (0, 0, 40), 6)
    meshes_r = {"mobile_maxilla": rm, "lefort": plane, "custom": rm, "empty": None}
    meshes_g = {"mobile_maxilla": gm, "lefort": TriMesh(plane.vertices, plane.faces, device="cpu"),
                "custom": gm, "empty": None}
    sr = jviewer.scene_payload(meshes_r, max_faces=2000)
    sg = tviewer.scene_payload(meshes_g, max_faces=2000)
    assert json.dumps(sg) == json.dumps(sr)
    assert tviewer.scene_to_html(sg, "t") == jviewer.scene_to_html(sr, "t")
    pr = jviewer.write_preview(tmp_path / "r.html", meshes_r, max_faces=2000)
    pg = tviewer.write_preview(tmp_path / "g" / "g.html", meshes_g, max_faces=2000)
    assert pg.read_bytes() == pr.read_bytes()


def test_progress_matches_reference(tmp_path):
    assert tprogress.STAGE_PROGRESS == jprogress.STAGE_PROGRESS
    events = [{"event": e, "stage": s} for e, s, _, _ in jprogress.STAGE_PROGRESS]
    for n in range(len(events) + 1):
        assert tprogress.progress_of_events(events[:n]) == jprogress.progress_of_events(events[:n])
    late = [{"event": "stage_start", "stage": "preprocess"},
            {"event": "track_stage", "stage": "global_optimization_0"},
            {"event": "track_stage", "stage": "lmk_init_all"}]
    assert tprogress.progress_of_events(late) == (80, "Global optimization...")
    assert tprogress.read_progress(tmp_path / "missing.jsonl") == (0, "Waiting...")
    p = tmp_path / "events.jsonl"
    p.write_text(json.dumps({"event": "stage_end", "stage": "render"}) + "\nnot json\n")
    assert tprogress.read_progress(p) == jprogress.read_progress(p) == (100, "Prediction complete")


# ── the dashboard's calls bind to the port ─────────────────


def test_dashboard_calls_bind_to_the_port():
    """The dashboard cannot run without streamlit; its calls into the port
    are held to the port's signatures here (`Pipeline(...)`,
    `render_surgery`, `train`, `track`, `capture_camera`)."""
    from omfs4d_torch.pipeline import cli
    from omfs4d_torch.pipeline.runner import Pipeline

    src = Path(__file__).resolve().parents[1] / "omfs4d_torch" / "app" / "dashboard.py"
    tree = ast.parse(src.read_text())
    targets = {"render_surgery": Pipeline.render_surgery, "train": Pipeline.train,
               "track": Pipeline.track, "preprocess": Pipeline.preprocess,
               "Pipeline": Pipeline, "capture_camera": cli.capture_camera}
    seen = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = getattr(node.func, "attr", None) or getattr(node.func, "id", None)
        if name not in targets:
            continue
        sig = inspect.signature(targets[name])
        params = list(sig.parameters)
        bound_self = params and params[0] == "self"
        args = ([None] if bound_self else []) + [None] * len(node.args)
        sig.bind(*args, **{k.arg: None for k in node.keywords})
        seen.add(name)
    assert {"render_surgery", "train", "track", "Pipeline", "capture_camera"} <= seen
