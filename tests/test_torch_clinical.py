"""The port's clinical engine (`omfs4d_torch.clinical`) against the JAX
package's (`omfs4d.clinical`) on the CPU: the four loader entry points on the
fixtures of `tests/test_clinical_loader.py` and on a small two-jaw label
volume (faces equal, vertices atol 1e-5); `SurgicalCutter`'s four segments
in both modes, with `lefort_flip`, tilted planes and rotated moves; the
invariant suite of `tests/test_surgical.py` on the port; measure and
segmentation."""

import numpy as np
import pytest
import torch

from omfs4d.clinical import loader as jl
from omfs4d.clinical import measure as jmeasure
from omfs4d.clinical import segmentation as jseg
from omfs4d.clinical import surgical as js
from omfs4d.io.dicom import RLE_LOSSLESS, write_dicom_slice
from omfs4d.io.nifti import save_nifti
from omfs4d.ops.primitives import make_sphere_mesh as j_sphere
from omfs4d_torch.clinical import loader as tl
from omfs4d_torch.clinical import measure as tmeasure
from omfs4d_torch.clinical import segmentation as tseg
from omfs4d_torch.clinical import surgical as ts
from omfs4d_torch.ops.mesh import TriMesh
from omfs4d_torch.ops.primitives import make_sphere_mesh as t_sphere

CPU = "cpu"


def assert_same(ref, got, atol=1e-5):
    v, f = got.numpy()
    assert f.shape == ref.faces.shape and v.shape == ref.vertices.shape
    np.testing.assert_array_equal(f, ref.faces)
    np.testing.assert_allclose(v, ref.vertices, rtol=0, atol=atol)


def sphere_ct(tmp_path, n=24, radius=8.0, syntax=None):
    """tests/test_clinical_loader.py's synthetic CT: a bone-HU sphere in air,
    stored with intercept -1024."""
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2
    r = np.sqrt((z - c) ** 2 + (y - c) ** 2 + (x - c) ** 2)
    raw = (np.where(r < radius, 1200.0, -1000.0) + 1024.0).astype(np.int16)
    d = tmp_path / "series"
    d.mkdir()
    kw = {} if syntax is None else {"transfer_syntax": syntax}
    for i in range(n):
        write_dicom_slice(d / f"{i:03d}.dcm", raw[i], position=(0, 0, float(i)),
                          pixel_spacing=(1.0, 1.0), rescale_intercept=-1024.0, **kw)
    return d


def phantom_ct(tmp_path, n=28, seed=0):
    """A noisy two-part 'skull' at 0.5 mm: a shell and a jaw bar, HU with
    partial volume and integer noise (ties at the threshold occur)."""
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2
    r = np.sqrt((z - c - 3) ** 2 + (y - c) ** 2 + (x - c) ** 2)
    bone = ((r < 11) & (r > 7)) | ((np.abs(z - 5) < 2) & (np.abs(x - c) < 8) & (np.abs(y - c) < 3))
    hu = -1000 + 2200 * bone + np.random.default_rng(seed).normal(0, 40, bone.shape)
    raw = (np.round(hu) + 1024).astype(np.int16)
    d = tmp_path / "phantom"
    d.mkdir()
    for i in range(n):
        write_dicom_slice(d / f"{i:03d}.dcm", raw[i], position=(0, 0, 0.5 * i),
                          pixel_spacing=(0.5, 0.5), slice_thickness=0.5,
                          rescale_intercept=-1024.0, transfer_syntax=RLE_LOSSLESS)
    return d


@pytest.mark.parametrize("smooth, keep", [(5, 0.9), (30, 0.5), (0, 1.0)])
def test_dicom_to_bone_mesh_matches_reference(tmp_path, smooth, keep):
    d = sphere_ct(tmp_path)
    ref = jl.dicom_to_bone_mesh(d, 300.0, smooth, keep)
    got = tl.dicom_to_bone_mesh(str(d), 300.0, smooth, keep, device=CPU)
    assert_same(ref, got)
    np.testing.assert_array_equal(got.center, ref.center)


@pytest.mark.parametrize("hu", [300.0, 700.0])
def test_dicom_phantom_matches_reference(tmp_path, hu):
    d = phantom_ct(tmp_path)
    assert_same(jl.dicom_to_bone_mesh(d, hu), tl.dicom_to_bone_mesh(str(d), hu, device=CPU))


def label_volume(n=28):
    """tests/test_clinical_loader.py's two blobs (label 2 at high k, label 1 at
    low k), with teeth labels beside each jaw and a sinus (label 5) that no
    default set includes."""
    vol = np.zeros((n, n, n), dtype=np.int16)
    i, j, k = np.mgrid[0:n, 0:n, 0:n]
    vol[(np.sqrt((i - 14) ** 2 + (j - 14) ** 2 + (k - 20) ** 2) < 5)] = 2
    vol[(np.sqrt((i - 14) ** 2 + (j - 14) ** 2 + (k - 8) ** 2) < 5)] = 1
    vol[(np.abs(i - 14) < 2) & (np.abs(j - 20) < 2) & (np.abs(k - 15) < 2)] = 11
    vol[(np.abs(i - 14) < 2) & (np.abs(j - 20) < 2) & (np.abs(k - 12) < 1)] = 41
    vol[(np.abs(i - 6) < 2) & (np.abs(j - 6) < 2) & (np.abs(k - 14) < 2)] = 5
    return vol


AFFINES = {"identity": np.eye(4),
           "RAS 0.3 mm, shifted": np.array([[0.3, 0, 0, -40.0], [0, 0.3, 0, 12.5],
                                            [0, 0, 0.3, 7.0], [0, 0, 0, 1]]),
           "oblique": np.array([[0.4, 0.05, 0, 3.0], [-0.05, 0.4, 0.02, -1.0],
                                [0, -0.02, 0.5, 2.0], [0, 0, 0, 1]])}


@pytest.mark.parametrize("affine", list(AFFINES))
@pytest.mark.parametrize("labels", ["defaults", "jaws only", "upper only"])
def test_separate_meshes_match_reference(tmp_path, affine, labels):
    p = tmp_path / "labels.nii.gz"
    save_nifti(p, label_volume(), affine=AFFINES[affine])
    kw = {"defaults": {}, "jaws only": dict(include_upper_labels=[2], include_lower_labels=[1]),
          "upper only": dict(include_upper_labels=[2, 11], include_lower_labels=[])}[labels]
    ref = jl.nifti_label_to_separate_meshes(str(p), smooth_iterations=3, decimate_fraction=0.9, **kw)
    got = tl.nifti_label_to_separate_meshes(str(p), smooth_iterations=3, decimate_fraction=0.9,
                                            device=CPU, **kw)
    for key in ref:
        assert_same(ref[key], got[key])


def test_separate_meshes_refuse_no_labels(tmp_path):
    with pytest.raises(ValueError, match="At least one"):
        tl.nifti_label_to_separate_meshes("x.nii", [], [], device=CPU)


@pytest.mark.parametrize("labels", [None, [2, 11], [5]])
def test_label_bone_mesh_matches_reference(tmp_path, labels):
    p = tmp_path / "labels.nii"
    save_nifti(p, label_volume(), affine=AFFINES["RAS 0.3 mm, shifted"])
    assert_same(jl.nifti_label_to_bone_mesh(str(p), labels, 5, 0.7),
                tl.nifti_label_to_bone_mesh(str(p), labels, 5, 0.7, device=CPU))


def test_label_bone_mesh_with_no_voxels_raises(tmp_path):
    p = tmp_path / "labels.nii"
    save_nifti(p, label_volume())
    with pytest.raises(ValueError, match="No voxels found"):
        tl.nifti_label_to_bone_mesh(str(p), [42], device=CPU)


@pytest.mark.parametrize("hu", [300.0, 1500.0, 2000.0])
def test_image_bone_mesh_matches_reference(tmp_path, hu):
    n = 20
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2
    r = np.sqrt((z - c) ** 2 + (y - c) ** 2 + (x - c) ** 2)
    vol = np.where(r < 6, 1500.0, -500.0).astype(np.float32)        # ties at 1500
    p = tmp_path / "ct.nii"
    save_nifti(p, vol, affine=np.eye(4))
    ref = jl.nifti_image_to_bone_mesh(str(p), hu, 2, 0.9)
    got = tl.nifti_image_to_bone_mesh(str(p), hu, 2, 0.9, device=CPU)
    assert_same(ref, got)


def test_the_reference_loader_tests_on_the_port(tmp_path):
    """tests/test_clinical_loader.py's assertions on the port's meshes."""
    mesh = tl.dicom_to_bone_mesh(str(sphere_ct(tmp_path)), 300.0, 5, 0.9, device=CPU)
    assert mesh.n_points > 50
    np.testing.assert_allclose(mesh.center, [0, 0, 0], atol=1e-3)
    assert 6.0 < torch.linalg.norm(mesh.vertices, dim=1).mean().item() < 9.0
    p = tmp_path / "labels.nii.gz"
    save_nifti(p, label_volume(), affine=np.eye(4))
    out = tl.nifti_label_to_separate_meshes(str(p), smooth_iterations=3, decimate_fraction=0.9,
                                            device=CPU)
    assert out["maxilla_mesh"].n_points > 10 and out["mandible_mesh"].n_points > 10
    assert out["maxilla_mesh"].center[2] < out["mandible_mesh"].center[2]
    np.testing.assert_allclose(out["combined_mesh"].center, [0, 0, 0], atol=0.5)


def test_label_sets_are_the_reference_ones():
    assert tl.TOOTHFAIRY_LABELS == jl.TOOTHFAIRY_LABELS
    assert tl.UPPER_TEETH_LABELS == jl.UPPER_TEETH_LABELS
    assert tl.LOWER_TEETH_LABELS == jl.LOWER_TEETH_LABELS
    assert tl.ALL_TEETH_LABELS == jl.ALL_TEETH_LABELS


# ── SurgicalCutter against the reference ───────────────────

CUTS = {
    "default planes": dict(lefort_z=20, bsso_l_x=-15, bsso_r_x=15),
    "tilted planes": dict(lefort_z=18, bsso_l_x=-12, bsso_r_x=16, lefort_pitch=8, lefort_yaw=-5,
                          bsso_l_pitch=3, bsso_l_yaw=10, bsso_r_pitch=-6, bsso_r_yaw=4),
}
MOVES = {
    "translate": dict(maxilla_mm=5.0, mandible_mm=3.0),
    "rotate + custom direction": dict(maxilla_mm=4.0, mandible_mm=-2.5,
                                      advancement_direction=(1.0, 2.0, 0.5),
                                      maxilla_rotation=(5.0, -3.0, 2.0),
                                      mandible_rotation=(0.0, 4.0, 0.0)),
}


def jaws(pkg):
    if pkg == "ref":
        return j_sphere(30, (0, 0, 20), 20), j_sphere(30, (0, 0, -20), 20)
    return t_sphere(30, (0, 0, 20), 20, device=CPU), t_sphere(30, (0, 0, -20), 20, device=CPU)


@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("mode", ["separate", "single", "single flipped"])
def test_cutter_matches_reference(cut, mode):
    (jmax, jmand), (tmax, tmand) = jaws("ref"), jaws("port")
    if mode == "separate":
        jc, tc = js.SurgicalCutter(jmax, jmand), ts.SurgicalCutter(tmax, tmand)
    else:
        jc, tc = js.SurgicalCutter(jmax.merge(jmand)), ts.SurgicalCutter(tmax.merge(tmand))
    args = dict(CUTS[cut], lefort_flip=mode == "single flipped")
    ref, got = jc.perform_cut(**args), tc.perform_cut(**args)
    assert set(got) == set(ref)
    for k in ref:
        assert_same(ref[k], got[k], atol=0)
    for name, kw in MOVES.items():
        rm, gm = jc.move_segments(**kw), tc.move_segments(**kw)
        for k in rm:
            assert_same(rm[k], gm[k])


@pytest.mark.parametrize("cut", list(CUTS))
def test_preview_matches_reference(cut):
    (jmax, jmand), (tmax, tmand) = jaws("ref"), jaws("port")
    ref = js.SurgicalCutter(jmax, jmand).preview_planes(**{k: v for k, v in CUTS[cut].items()})
    got = ts.SurgicalCutter(tmax, tmand).preview_planes(**CUTS[cut])
    assert set(got) == set(ref)
    for k in ref:
        assert_same(ref[k], got[k], atol=0)


# ── tests/test_surgical.py's invariants on the port ────────

CUT = dict(lefort_z=20, bsso_l_x=-15, bsso_r_x=15)
SEGMENTS = ("upper_skull", "mobile_maxilla", "distal_mandible", "proximal_rami")


@pytest.fixture
def cutter():
    return ts.SurgicalCutter(t_sphere(30, (0, 0, 20), 20, device=CPU),
                             t_sphere(30, (0, 0, -20), 20, device=CPU))


def test_preview_contract(cutter):
    assert set(cutter.preview_planes(**CUT)) >= {"maxilla", "mandible", "combined",
                                                 "lefort", "bsso_l", "bsso_r"}


def test_cut_produces_four_nonempty_relevant_segments(cutter):
    out = cutter.perform_cut(**CUT)
    assert set(out) == set(SEGMENTS)
    assert out["distal_mandible"].n_points > 0 and out["proximal_rami"].n_points > 0
    assert out["upper_skull"].center[2] > out["mobile_maxilla"].center[2]


@pytest.mark.parametrize("mobile,other,kw", [
    ("mobile_maxilla", "distal_mandible", dict(maxilla_mm=10.0)),
    ("distal_mandible", "mobile_maxilla", dict(mandible_mm=10.0)),
])
def test_segment_independence(cutter, mobile, other, kw):
    cutter.perform_cut(**CUT)
    before = np.array(getattr(cutter, other).center)
    moved = cutter.move_segments(**kw)
    np.testing.assert_array_almost_equal(before, moved[other].center)
    assert np.linalg.norm(np.array(moved[mobile].center) - getattr(cutter, mobile).center) > 1.0


def test_translation_magnitudes(cutter):
    cutter.perform_cut(**CUT)
    max0, mand0 = cutter.mobile_maxilla.center, cutter.distal_mandible.center
    moved = cutter.move_segments(maxilla_mm=5.0, mandible_mm=8.0)
    assert abs((moved["mobile_maxilla"].center[1] - max0[1]) - 5.0) < 0.05
    assert abs((moved["distal_mandible"].center[1] - mand0[1]) - 8.0) < 0.05
    custom = cutter.move_segments(maxilla_mm=5.0, advancement_direction=(1.0, 0.0, 0.0))
    np.testing.assert_allclose(np.array(custom["mobile_maxilla"].center) - max0, [5.0, 0, 0],
                               atol=0.1)


def test_fixed_segments_never_move_and_rotation_pivots(cutter):
    cutter.perform_cut(**CUT)
    skull0, rami0 = cutter.upper_skull.center, cutter.proximal_rami.center
    moved = cutter.move_segments(maxilla_mm=10.0, mandible_mm=10.0, maxilla_rotation=(5, 5, 5))
    np.testing.assert_array_almost_equal(skull0, moved["upper_skull"].center)
    np.testing.assert_array_almost_equal(rami0, moved["proximal_rami"].center)
    before = np.array(cutter.distal_mandible.center)
    rotated = cutter.move_segments(mandible_rotation=(10.0, 5.0, -3.0))
    np.testing.assert_allclose(rotated["distal_mandible"].center, before, atol=0.5)


def test_errors(cutter):
    with pytest.raises(RuntimeError):
        cutter.move_segments(maxilla_mm=5.0)
    cutter.perform_cut(**CUT)
    with pytest.raises(ValueError):
        cutter.move_segments(maxilla_mm=1.0, advancement_direction=(0.0, 0.0, 0.0))


def test_single_mesh_and_lefort_flip():
    single = ts.SurgicalCutter(t_sphere(radius=50, res=30, device=CPU))
    cut = dict(lefort_z=0, bsso_l_x=-20, bsso_r_x=20)
    assert single.perform_cut(**cut)["upper_skull"].n_points > 0
    assert "combined" in single.preview_planes(**cut)
    up = single.perform_cut(**cut)["upper_skull"].center[2]
    flipped = single.perform_cut(**cut, lefort_flip=True)["upper_skull"].center[2]
    assert up > 0 > flipped


def test_segments_stay_on_their_device():
    c = ts.SurgicalCutter(t_sphere(30, (0, 0, 20), 12, device=CPU))
    out = c.perform_cut(lefort_z=200, bsso_l_x=-300, bsso_r_x=300)
    assert out["upper_skull"].n_points == 0 and out["proximal_rami"].device == torch.device("cpu")


# ── measure and segmentation ───────────────────────────────


def test_measure_matches_reference():
    assert tmeasure.distance_mm((0, 0, 0), (3, 4, 0)) == jmeasure.distance_mm((0, 0, 0), (3, 4, 0))
    for pts in [((1, 0, 0), (0, 0, 0), (0, 1, 0)), ((1, 2, 3), (-1, 0.5, 2), (4, -2, 0))]:
        assert tmeasure.angle_deg(*pts) == jmeasure.angle_deg(*pts)
    with pytest.raises(ValueError):
        tmeasure.angle_deg((0, 0, 0), (0, 0, 0), (1, 0, 0))
    m = j_sphere(30, (0, 0, 20), 20)
    tm_ = TriMesh(m.vertices, m.faces, device=CPU)
    for p in [(0, 0, 52), (3.3, -7.1, 1.0), (100, 0, 0)]:
        got = tmeasure.snap_to_mesh(tm_, p)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, jmeasure.snap_to_mesh(m, p))


def test_segmentation_matches_reference():
    vol = np.random.default_rng(0).normal(0, 500, (6, 7, 8)).astype(np.float32)
    vol[0, 0, :3] = 300.0                                               # ties
    for kw in ({}, {"hu_threshold": 700.0}):
        ref = jseg.segment_volume(vol, (1.0,) * 3, **kw)
        got = tseg.segment_volume(vol, (1.0,) * 3, device=CPU, **kw)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(KeyError, match="not registered"):
        tseg.segment_volume(vol, (1.0,) * 3, method="nnunet", device=CPU)

    @tseg.register_segmenter("test_half")
    def half(volume, spacing, **_):
        return (volume > 0).to(torch.uint8) * 2

    try:
        assert int(tseg.segment_volume(vol, (1.0,) * 3, method="test_half",
                                       device=CPU).max()) == 2
    finally:
        tseg._SEGMENTERS.pop("test_half")
