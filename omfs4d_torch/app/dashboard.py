"""Two-tab web dashboard (parity surface for the reference's app.py).

Port of `omfs4d.app.dashboard` on the port's session and `Pipeline`, which
take the CUDA card.  Runs wherever streamlit is installed:

    streamlit run omfs4d_torch/app/dashboard.py

Tab 1 (Clinical, ref app.py:513-1162): upload DICOM/NIfTI or demo spheres
-> cut-plane sliders + angle controls + live in-browser 3D preview ->
perform osteotomies -> move segments (direction, rotations, undo/redo,
save state) with post-osteotomy 3D preview -> segment-selectable
STL/PLY/OBJ export -> measurement tools.
Tab 2 (Visual, ref app.py:1168-1498): dataset prep with a live stage
progress bar driven by events.jsonl -> avatar training -> surgical
prediction from Tab 1's plan -> before/after video compare.

All logic lives in omfs4d_torch.app.{session,viewer,progress} / omfs4d_torch.pipeline
— this file is presentation only, so every headless environment keeps full
functionality through the CLI.  3D previews use the first-party WebGL
viewer (app/viewer.py) instead of the reference's stpyvista/VTK stack.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

try:
    import streamlit as st
    import streamlit.components.v1 as components
except ImportError as e:  # pragma: no cover - UI only runs with streamlit
    raise SystemExit(
        "The dashboard needs streamlit (`pip install streamlit`). "
        "All functionality is available headless via "
        "`python -m omfs4d_torch.pipeline.cli`."
    ) from e

from omfs4d_torch.app.progress import read_progress
from omfs4d_torch.app.session import PlanningSession
from omfs4d_torch.app.viewer import scene_to_html
from omfs4d_torch.core.config import Config

st.set_page_config(page_title="omfs4d", layout="wide")

if "session" not in st.session_state:
    st.session_state.session = PlanningSession()
    st.session_state.cut_done = False
session: PlanningSession = st.session_state.session

tab1, tab2 = st.tabs(["🦴 Clinical Planning", "🎭 4D Prediction"])

with tab1:
    st.header("Step 1 — Load anatomy")
    col1, col2 = st.columns(2)
    with col1:
        up = st.file_uploader("DICOM series (.dcm, multiple)",
                              accept_multiple_files=True)
        if up and st.button("Extract Bone from DICOM"):
            from omfs4d_torch.clinical.loader import dicom_to_bone_mesh
            with tempfile.TemporaryDirectory() as d:
                for f in up:
                    (Path(d) / f.name).write_bytes(f.getvalue())
                mesh = dicom_to_bone_mesh(d)
            session.load_meshes(mesh)
            st.success(f"mesh: {mesh.n_points} pts / {mesh.n_faces} tris")
    with col2:
        nifti = st.file_uploader("ToothFairy3 labels (.nii.gz)")
        # per-structure include checkboxes (ref app.py:625-657)
        st.caption("Structures to include:")
        cs1, cs2, cs3 = st.columns(3)
        inc_lower = cs1.checkbox("Mandible", value=True, key="inc_lower")
        inc_upper = cs2.checkbox("Maxilla", value=True, key="inc_upper")
        inc_teeth = cs3.checkbox("Teeth", value=True, key="inc_teeth")
        if nifti and st.button("Extract Jaws from NIfTI"):
            from omfs4d_torch.clinical.loader import (
                LOWER_TEETH_LABELS, UPPER_TEETH_LABELS,
                nifti_label_to_separate_meshes,
            )
            upper_ids = ([2] if inc_upper else []) + (
                UPPER_TEETH_LABELS if inc_teeth else [])
            lower_ids = ([1] if inc_lower else []) + (
                LOWER_TEETH_LABELS if inc_teeth else [])
            if not upper_ids and not lower_ids:
                st.error("Select at least one structure to include.")
            else:
                with tempfile.NamedTemporaryFile(suffix=".nii.gz",
                                                 delete=False) as f:
                    f.write(nifti.getvalue())
                    out = nifti_label_to_separate_meshes(
                        f.name, include_upper_labels=upper_ids,
                        include_lower_labels=lower_ids)
                session.load_meshes(out["maxilla_mesh"], out["mandible_mesh"])
                st.success("separate maxilla + mandible loaded")
        if st.button("Demo spheres"):
            session.load_demo_sphere()
            st.success("demo anatomy loaded")

    if session.maxilla is not None:
        st.header("Step 2 — Define cut planes & perform osteotomies")
        if session.mandible is not None:
            st.success("Maxilla and mandible are separate meshes, so each "
                       "cut stays on its own bone.")
        else:
            st.warning("Working on one combined mesh; ToothFairy3 labels "
                       "give cleaner per-jaw cuts.")
        b = session.maxilla.bounds
        st.info(f"📏 Mesh bounds — X: [{b[0]:.1f}, {b[1]:.1f}] · "
                f"Y: [{b[2]:.1f}, {b[3]:.1f}] · Z: [{b[4]:.1f}, {b[5]:.1f}]")
        x_mid, z_mid = (b[0] + b[1]) / 2, (b[4] + b[5]) / 2

        col_sliders, col_preview = st.columns([1, 2])
        with col_sliders:
            st.subheader("3 Cut Planes")
            st.markdown("**🔴 Le Fort I** — horizontal cut through maxilla")
            lefort_z = st.slider("Le Fort I height (Z)", float(b[4]), float(b[5]),
                                 float(z_mid + (b[5] - z_mid) * 0.3), 0.5)
            lefort_flip = st.checkbox("Flip Le Fort mobile side", False,
                                      help="Use this if the wrong maxillary "
                                           "side is being freed.")
            st.markdown("**🔵 BSSO** — sagittal cuts through mandibular rami")
            bsso_l = st.slider("BSSO Left (X)", float(b[0]), float(x_mid),
                               float(b[0] + (x_mid - b[0]) * 0.3), 0.5)
            bsso_r = st.slider("BSSO Right (X)", float(x_mid), float(b[1]),
                               float(x_mid + (b[1] - x_mid) * 0.7), 0.5)
            with st.expander("🔧 Plane Angle Controls"):
                st.caption("Tilt planes from their default orientation (deg).")
                lf_p = st.slider("Le Fort Pitch", -45.0, 45.0, 0.0, 1.0)
                lf_y = st.slider("Le Fort Yaw", -45.0, 45.0, 0.0, 1.0)
                bl_p = st.slider("BSSO-L Pitch", -45.0, 45.0, 0.0, 1.0)
                bl_y = st.slider("BSSO-L Yaw", -45.0, 45.0, 0.0, 1.0)
                br_p = st.slider("BSSO-R Pitch", -45.0, 45.0, 0.0, 1.0)
                br_y = st.slider("BSSO-R Yaw", -45.0, 45.0, 0.0, 1.0)
            do_cut = st.button("✂️ Cut bone segments", type="primary")

        cut_args = dict(lefort_z=lefort_z, bsso_l_x=bsso_l, bsso_r_x=bsso_r,
                        lefort_pitch=lf_p, lefort_yaw=lf_y,
                        bsso_l_pitch=bl_p, bsso_l_yaw=bl_y,
                        bsso_r_pitch=br_p, bsso_r_yaw=br_y)

        with col_preview:
            st.subheader("Cut Plane Preview")
            st.caption("🖱️ Left-drag to rotate · Right-drag to pan · Scroll to zoom")
            components.html(scene_to_html(session.preview_scene(**cut_args)),
                            height=500)

        if do_cut:
            result = session.perform_cut(**cut_args, lefort_flip=lefort_flip)
            st.session_state.cut_done = True
            for w in result.get("_warnings", []):
                st.warning(w)
            n_max = (result["mobile_maxilla"].n_points
                     if result["mobile_maxilla"] is not None else 0)
            n_dist = (result["distal_mandible"].n_points
                      if result["distal_mandible"] is not None else 0)
            st.success(f"Osteotomies complete! Maxilla: {n_max:,} · "
                       f"Mandible: {n_dist:,}")
        elif st.session_state.cut_done:
            # replay the cut with the current slider values (ref app.py:799)
            session.perform_cut(**cut_args, lefort_flip=lefort_flip)

    if st.session_state.cut_done:
        st.header("Step 3 — Move segments")
        col_move, col_vis = st.columns([1, 2])
        with col_move:
            st.subheader("Advancement (mm)")
            mx = st.slider("Maxilla Advancement (Le Fort I)", -15.0, 15.0,
                           session.movement.maxilla_mm, 0.5)
            md = st.slider("Distal Mandible Advancement (BSSO)", -15.0, 15.0,
                           session.movement.mandible_mm, 0.5)
            axis_vectors = {
                "+Y (anterior)": (0.0, 1.0, 0.0),
                "-Y (posterior)": (0.0, -1.0, 0.0),
                "+X (left)": (1.0, 0.0, 0.0),
                "-X (right)": (-1.0, 0.0, 0.0),
                "+Z (superior)": (0.0, 0.0, 1.0),
                "-Z (inferior)": (0.0, 0.0, -1.0),
            }
            move_axis = st.selectbox("Advancement direction",
                                     list(axis_vectors), index=0)
            with st.expander("🔄 Advanced: Rotation Controls"):
                st.caption("Rotate segments around their center (degrees)")
                st.markdown("**Maxilla Rotation**")
                c1, c2, c3 = st.columns(3)
                mr = (c1.slider("Pitch (X)", -15.0, 15.0,
                                session.movement.maxilla_rotation[0], 0.5,
                                key="max_pitch"),
                      c2.slider("Yaw (Z)", -15.0, 15.0,
                                session.movement.maxilla_rotation[1], 0.5,
                                key="max_yaw"),
                      c3.slider("Roll (Y)", -15.0, 15.0,
                                session.movement.maxilla_rotation[2], 0.5,
                                key="max_roll"))
                st.markdown("**Mandible Rotation**")
                c1, c2, c3 = st.columns(3)
                dr = (c1.slider("Pitch (X)", -15.0, 15.0,
                                session.movement.mandible_rotation[0], 0.5,
                                key="mand_pitch"),
                      c2.slider("Yaw (Z)", -15.0, 15.0,
                                session.movement.mandible_rotation[1], 0.5,
                                key="mand_yaw"),
                      c3.slider("Roll (Y)", -15.0, 15.0,
                                session.movement.mandible_rotation[2], 0.5,
                                key="mand_roll"))
                if st.button("Reset Rotations"):
                    session.set_movement(maxilla_rotation=(0.0, 0.0, 0.0),
                                         mandible_rotation=(0.0, 0.0, 0.0))
                    st.rerun()
            st.metric("Maxilla", f"{session.movement.maxilla_mm:+.1f} mm")
            st.metric("Distal Mandible",
                      f"{session.movement.mandible_mm:+.1f} mm")
            st.divider()
            cu, cr, cs = st.columns(3)
            if cu.button("↩️ Undo", disabled=not session.can_undo,
                         use_container_width=True):
                session.undo()
                st.rerun()
            if cr.button("↪️ Redo", disabled=not session.can_redo,
                         use_container_width=True):
                session.redo()
                st.rerun()
            if cs.button("💾 Save State", use_container_width=True):
                session.save_state()
                st.success("State saved!")
            pos, total = session.history_info
            if total:
                st.caption(f"History: {pos + 1} / {total + 1} states")

            new_state = dict(
                maxilla_mm=mx, mandible_mm=md,
                advancement_direction=axis_vectors[move_axis],
                maxilla_rotation=mr, mandible_rotation=dr,
            )
            cur = session.movement
            if any(getattr(cur, k) != v for k, v in new_state.items()):
                session.set_movement(**new_state)

        with col_vis:
            st.subheader("Post-Osteotomy Preview")
            st.caption("🖱️ Left-drag to rotate · Right-drag to pan · Scroll to zoom")
            components.html(scene_to_html(session.moved_scene()), height=500)

        # ── export (ref app.py:939-1022) ─────────────────────
        st.divider()
        st.subheader("Export Modified Mesh")
        ce1, ce2 = st.columns(2)
        fmt_label = ce1.selectbox(
            "Export format", ["STL (Binary)", "STL (ASCII)", "PLY", "OBJ"])
        seg_labels = {"Upper Skull": "upper_skull",
                      "Mobile Maxilla": "mobile_maxilla",
                      "Distal Mandible": "distal_mandible",
                      "Proximal Rami": "proximal_rami"}
        chosen = ce2.multiselect("Include segments", list(seg_labels),
                                 default=list(seg_labels))
        if st.button("📥 Generate Download", type="primary"):
            fmt, ascii_flag = {
                "STL (Binary)": ("stl", False), "STL (ASCII)": ("stl", True),
                "PLY": ("ply", None), "OBJ": ("obj", None),
            }[fmt_label]
            out = Path(tempfile.mkdtemp()) / f"plan.{fmt}"
            session.export(out, include=tuple(seg_labels[s] for s in chosen),
                           stl_ascii=bool(ascii_flag))
            st.download_button(f"⬇️ Download {fmt_label}", out.read_bytes(),
                               session.export_filename(fmt), type="primary")

        # ── measurement tools (ref app.py:1024-1162) ─────────
        st.divider()
        st.subheader("Measurement Tools")
        with st.expander("📏 Mesh bounds (for reference)"):
            cb1, cb2, cb3 = st.columns(3)
            cb1.metric("X range", f"{b[0]:.1f} to {b[1]:.1f}")
            cb2.metric("Y range", f"{b[2]:.1f} to {b[3]:.1f}")
            cb3.metric("Z range", f"{b[4]:.1f} to {b[5]:.1f}")
        mtype = st.radio("Measurement type",
                         ["Distance (2 points)", "Angle (3 points)"],
                         horizontal=True)
        n_pts = 2 if mtype.startswith("Distance") else 3
        labels = (["Point A", "Point B"] if n_pts == 2
                  else ["Point A (first arm)", "Point B (vertex)",
                        "Point C (second arm)"])
        pts = []
        for li, lab in enumerate(labels):
            st.markdown(f"**{lab}**")
            cc = st.columns(3)
            pts.append([cc[a].number_input(ax, value=0.0, format="%.2f",
                                           key=f"m_{li}_{ax}")
                        for a, ax in enumerate("XYZ")])
        kind = "distance" if n_pts == 2 else "angle"
        if kind == "distance":
            val = f"{session.measure_distance(pts[0], pts[1]):.2f} mm"
        else:
            val = f"{session.measure_angle(pts[0], pts[1], pts[2]):.1f}°"
        cm1, cm2 = st.columns([2, 1])
        cm1.metric(kind.capitalize(), val)
        if cm2.button("Save measurement"):
            session.add_measurement(kind, pts)
            st.success("Measurement saved!")
        if session.measurements:
            st.markdown("**Saved Measurements**")
            for i, m in enumerate(session.measurements):
                cl, cd = st.columns([3, 1])
                cl.text(f"{i + 1}. {m['type']}: {m['value']}")
                if cd.button("🗑️", key=f"del_m_{i}"):
                    session.delete_measurement(i)
                    st.rerun()
            if st.button("Clear all measurements"):
                session.clear_measurements()
                st.rerun()

with tab2:
    st.header("4D surgical prediction")
    plan = session.surgical_plan()
    st.info(f"plan from Tab 1: maxilla {plan['maxilla_mm']:.1f} mm, "
            f"mandible {plan['mandible_mm']:.1f} mm")
    workdir = Path(st.text_input("working directory", "omfs4d_work"))
    video_path = st.text_input("pre-op video", "input.mp4")
    data_dir = Path(st.session_state.get("data_dir", workdir / "data"))
    model_dir = Path(st.session_state.get("model_dir", workdir / "model"))
    out_video = workdir / "final_prediction.mp4"

    # live stage progress from the structured event stream (replaces the
    # reference's stdout-regex progress table, app.py:1279-1323)
    pct, status = read_progress(workdir / "events.jsonl")
    if pct:
        st.progress(pct, text=status)

    iters = st.select_slider("training iterations",
                             [5000, 30000, 100000, 600000], 30000)
    c1, c2, c3 = st.columns(3)
    if c1.button("Preprocess + Track"):
        from omfs4d_torch.pipeline.cli import capture_camera
        from omfs4d_torch.pipeline.runner import Pipeline
        pipe = Pipeline(Config(), workdir)
        with st.spinner("tracking…"):
            frames_dir = pipe.preprocess(video_path)
            st.session_state.data_dir = str(
                pipe.track(frames_dir, capture_camera(frames_dir),
                           landmark_method="auto"))
        st.success("dataset ready")
    if c2.button("Train avatar"):
        from omfs4d_torch.pipeline.runner import Pipeline
        pipe = Pipeline(Config(), workdir)
        with st.spinner("training…"):
            st.session_state.model_dir = str(
                pipe.train(data_dir, model_dir, iterations=iters))
        st.success("training complete")
    if c3.button("🎬 Render post-op prediction", type="primary"):
        if plan["maxilla_mm"] == 0.0 and plan["mandible_mm"] == 0.0:
            st.warning("Both advancement values are 0.0 mm. Set the "
                       "movement sliders in the Planning tab first.")
        else:
            from omfs4d_torch.pipeline.runner import Pipeline
            pipe = Pipeline(Config(), workdir)
            with st.spinner("rendering…"):
                pipe.render_surgery(model_dir, data_dir, out_video,
                                    lefort_mm=plan["maxilla_mm"],
                                    bsso_mm=plan["mandible_mm"])
            st.success("Prediction rendered successfully!")

    # ── before / after compare (ref app.py:1480-1498) ────────
    st.divider()
    st.subheader("Results — Before vs After")
    cp, cq = st.columns(2)
    with cp:
        st.markdown("**Pre-Op Video**")
        if Path(video_path).exists():
            st.video(str(video_path))
        else:
            st.info("No pre-op video uploaded yet.")
    with cq:
        st.markdown("**Post-Op Prediction**")
        if out_video.exists():
            st.video(str(out_video))
        else:
            st.info("No prediction generated yet.")
