"""The clinical engine of the port on a CUDA card: marching tetrahedra and the
`TriMesh` ops on the card equal the port's CPU path array for array on
seeded inputs, and an entry point given no device takes the card.  Without a
card every test that needs one skips; the last test holds every clinical
entry point to raising when there is no card, and runs anywhere.

This file imports only the port (no jax), so it also runs on a machine
without JAX:  python -m pytest --noconftest tests/test_torch_clinical_card.py
"""

import numpy as np
import pytest
import torch

from omfs4d_torch.app.session import PlanningSession
from omfs4d_torch.clinical import loader
from omfs4d_torch.clinical.segmentation import segment_volume
from omfs4d_torch.clinical.surgical import SurgicalCutter
from omfs4d_torch.io.dicom import write_dicom_slice
from omfs4d_torch.io.nifti import save_nifti
from omfs4d_torch.ops import marching, mesh as tmesh
from omfs4d_torch.ops.primitives import make_sphere_mesh

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this file holds the card's path to the CPU's")
    return torch.device("cuda", 0)


def field(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.normal(size=(30, 33, 31)).astype(np.float32)
    if kind == "integer":
        return rng.integers(0, 4, size=(24, 25, 26)).astype(np.float32)
    n = 40
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2
    r = np.sqrt((z - c) ** 2 + (y - c) ** 2 + ((x - c) * 1.3) ** 2)
    hu = np.where((r < 17) & (r > 11), 1200.0, -1000.0) + rng.normal(0, 30, r.shape)
    return np.round(hu).astype(np.float32)


MARCH = {"random": (0.1, {}), "integer ties": (2.0, {}),
         "integer, chunks of 500": (2.0, {"max_chunk_cells": 500}),
         "HU shell at 0.3 mm": (300.0, {"spacing": (0.3, 0.3, 0.3)})}


@pytest.mark.parametrize("name", list(MARCH))
def test_marching_on_card_equals_cpu(cuda_device, name):
    vol = field(name.split()[0].rstrip(","))
    level, kw = MARCH[name]
    cv, cf = marching.marching_cubes(vol, level, device=cuda_device, **kw)
    pv, pf = marching.marching_cubes(vol, level, device=CPU, **kw)
    assert cv.device == cuda_device and len(cf) > 0
    assert torch.equal(cf.cpu(), pf) and torch.equal(cv.cpu(), pv)


def bone_mesh(device) -> tmesh.TriMesh:
    v, f = marching.marching_cubes(field("hu"), 300.0, spacing=(0.3, 0.3, 0.3), device=device)
    return tmesh.TriMesh(v.flip(1), f, device=device)


def same(a: tmesh.TriMesh, b: tmesh.TriMesh) -> bool:
    return torch.equal(a.vertices.cpu(), b.vertices.cpu()) and torch.equal(a.faces.cpu(), b.faces.cpu())


def test_mesh_ops_on_card_equal_cpu(cuda_device):
    card, cpu = bone_mesh(cuda_device), bone_mesh(CPU)
    assert card.vertices.device == cuda_device and same(card, cpu)
    assert card.bounds == cpu.bounds and np.array_equal(card.center, cpu.center)
    ops = {
        "clean": lambda m: m.clean(),
        "clip z": lambda m: m.clean().clip((0, 0, 1), (0, 0, 6.0)),
        "clip tilted": lambda m: m.clean().clip((0.3, -0.2, 0.9), (5.5, 6.0, 6.2), invert=True),
        "smooth": lambda m: m.clean().smooth(30),
        "qem": lambda m: m.clean().smooth(30).decimate(0.5),
        "cluster": lambda m: tmesh.decimate_cluster(m.clean(), 0.6),
        "rotate": lambda m: m.rotate_y(11.0, point=m.center),
        "translate + merge": lambda m: m.translate((1.0, -2.0, 0.5)).merge(m),
    }
    for name, op in ops.items():
        assert same(op(card), op(cpu)), name
    nbr_c, mask_c = tmesh.vertex_adjacency(card.clean().faces, card.clean().n_points)
    nbr_p, mask_p = tmesh.vertex_adjacency(cpu.clean().faces, cpu.clean().n_points)
    assert torch.equal(nbr_c.cpu(), nbr_p) and torch.equal(mask_c.cpu(), mask_p)


def test_cutter_on_card_equals_cpu(cuda_device):
    for flip in (False, True):
        segs = [SurgicalCutter(bone_mesh(d).clean()).perform_cut(
            6.0, 4.0, 8.0, lefort_pitch=5.0, bsso_r_yaw=-4.0, lefort_flip=flip)
            for d in (cuda_device, CPU)]
        for k in segs[0]:
            assert same(segs[0][k], segs[1][k]), k


def write_series(root, vol):
    root.mkdir()
    raw = (vol + 1024).astype(np.int16)
    for i, s in enumerate(raw):
        write_dicom_slice(root / f"{i:03d}.dcm", s, position=(0.0, 0.0, 0.3 * i),
                          pixel_spacing=(0.3, 0.3), rescale_intercept=-1024.0)
    return root


def test_no_device_takes_the_card(cuda_device, tmp_path):
    vol = field("hu")
    assert tmesh.TriMesh(np.zeros((3, 3)), np.array([[0, 1, 2]])).device == cuda_device
    assert make_sphere_mesh(res=8).device == cuda_device
    assert PlanningSession().device == cuda_device
    assert marching.marching_cubes(vol, 300.0)[0].device == cuda_device
    assert segment_volume(vol, (0.3,) * 3).device == cuda_device
    mesh = loader.dicom_to_bone_mesh(str(write_series(tmp_path / "s", vol)))
    assert mesh.device == cuda_device
    assert same(mesh, loader.dicom_to_bone_mesh(str(tmp_path / "s"), device="cpu"))
    labels = (vol > 0).astype(np.uint8) + (np.arange(40)[None, None, :] > 20)
    save_nifti(tmp_path / "l.nii.gz", labels.astype(np.uint8), affine=np.diag([0.3] * 3 + [1.0]))
    out = loader.nifti_label_to_separate_meshes(str(tmp_path / "l.nii.gz"))
    assert out["maxilla_mesh"].device == cuda_device
    cpu = loader.nifti_label_to_separate_meshes(str(tmp_path / "l.nii.gz"), device="cpu")
    assert all(same(out[k], cpu[k]) for k in out)


def test_every_entry_point_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = field("random")
    calls = {
        "TriMesh": lambda: tmesh.TriMesh(),
        "make_sphere_mesh": lambda: make_sphere_mesh(res=8),
        "marching_cubes": lambda: marching.marching_cubes(vol, 0.0),
        "segment_volume": lambda: segment_volume(vol, (1.0,) * 3),
        "PlanningSession": lambda: PlanningSession(),
        "hu_volume_to_bone_mesh": lambda: loader.hu_volume_to_bone_mesh(vol, (1.0,) * 3),
        "dicom_to_bone_mesh": lambda: loader.dicom_to_bone_mesh(str(tmp_path)),
        "nifti_label_to_separate_meshes": lambda: loader.nifti_label_to_separate_meshes("x.nii"),
        "nifti_label_to_bone_mesh": lambda: loader.nifti_label_to_bone_mesh("x.nii"),
        "nifti_image_to_bone_mesh": lambda: loader.nifti_image_to_bone_mesh("x.nii"),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
