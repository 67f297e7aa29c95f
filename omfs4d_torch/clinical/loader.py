"""CT/CBCT ingest: DICOM / NIfTI -> Hounsfield volume -> bone surface mesh.

Port of `omfs4d.clinical.loader` (ref: 01_Clinical_Engine/dicom_loader.py:
34-397).  The file is read on the host (`omfs4d_torch.io.dicom` /
`omfs4d_torch.io.nifti`); the volume then goes to the device, the CUDA card
unless the caller asks for the CPU, where the threshold or label masks,
marching tetrahedra, `clean`, the adjacency, the 30 smoothing iterations
and the centring run.  The QEM decimation runs on the host (meshkit) and
its result comes back to the device.

Coordinate conventions preserved:
  * marching output is (z, y, x)-scaled; vertices are reordered to (x, y, z)
    (ref: dicom_loader.py:148-151)
  * NIfTI masks go through the voxel->world RAS affine in float64
    (ref: dicom_loader.py:237-243)
  * separate-mesh extraction centers all meshes at the combined center and
    flips Z so Superior is +Z (ref: dicom_loader.py:296-305)
"""

from __future__ import annotations

import numpy as np
import torch

from omfs4d_torch.core.device import resolve_device
from omfs4d_torch.io.dicom import load_dicom_series
from omfs4d_torch.io.nifti import load_nifti
from omfs4d_torch.ops.marching import marching_cubes
from omfs4d_torch.ops.mesh import TriMesh

# ToothFairy3 label mapping (ref: dicom_loader.py:176-194)
TOOTHFAIRY_LABELS = {
    "Lower Jawbone": 1,
    "Upper Jawbone": 2,
    "Left Inferior Alveolar Canal": 3,
    "Right Inferior Alveolar Canal": 4,
    "Left Maxillary Sinus": 5,
    "Right Maxillary Sinus": 6,
}
UPPER_TEETH_LABELS = [
    11, 12, 13, 14, 15, 16, 17, 18,
    21, 22, 23, 24, 25, 26, 27, 28,
]
LOWER_TEETH_LABELS = [
    31, 32, 33, 34, 35, 36, 37, 38,
    41, 42, 43, 44, 45, 46, 47, 48,
]
ALL_TEETH_LABELS = UPPER_TEETH_LABELS + LOWER_TEETH_LABELS


def load_dicom_volume(dicom_path: str):
    """DICOM folder -> ((Z, Y, X) HU volume, (z, y, x) spacing), on the host."""
    return load_dicom_series(dicom_path)


def _to_device(volume: np.ndarray, device: torch.device) -> torch.Tensor:
    """The host volume as a contiguous float32 tensor on `device`."""
    return torch.as_tensor(volume).to(device, torch.float32).contiguous()


def _postprocess(mesh: TriMesh, smooth_iterations: int, decimate_fraction: float) -> TriMesh:
    mesh = mesh.clean()
    if smooth_iterations > 0:
        mesh = mesh.smooth(n_iter=smooth_iterations)
    if 0.0 < decimate_fraction < 1.0:
        mesh = mesh.decimate(1.0 - decimate_fraction)
    return mesh


def _centered(mesh: TriMesh) -> TriMesh:
    if mesh.n_points:
        mesh.translate(-mesh.center, inplace=True)
    return mesh


def hu_volume_to_bone_mesh(
    volume,
    spacing: tuple,
    hu_threshold: float = 300.0,
    smooth_iterations: int = 30,
    decimate_fraction: float = 0.5,
    device=None,
) -> TriMesh:
    """(Z, Y, X) HU volume -> centered bone surface mesh on `device`: the
    HU-threshold pipeline of `dicom_to_bone_mesh` after the read."""
    dev = resolve_device(device, "hu_volume_to_bone_mesh")
    verts, faces = marching_cubes(_to_device(volume, dev), level=hu_threshold,
                                  spacing=spacing, device=dev)
    # (z, y, x) -> (x, y, z)
    mesh = TriMesh(verts.flip(1), faces, device=dev)
    return _centered(_postprocess(mesh, smooth_iterations, decimate_fraction))


def dicom_to_bone_mesh(
    dicom_path: str,
    hu_threshold: float = 300.0,
    smooth_iterations: int = 30,
    decimate_fraction: float = 0.5,
    device=None,
) -> TriMesh:
    """DICOM series -> centered bone surface mesh (HU-threshold pipeline)."""
    dev = resolve_device(device, "dicom_to_bone_mesh")
    volume, spacing = load_dicom_volume(dicom_path)
    return hu_volume_to_bone_mesh(volume, spacing, hu_threshold, smooth_iterations,
                                  decimate_fraction, device=dev)


def nifti_to_volume(nifti_path: str):
    """NIfTI -> (volume (i, j, k), spacing, 4x4 voxel->RAS affine), on the
    host."""
    return load_nifti(nifti_path)


def _volume_mask_to_mesh(
    mask: torch.Tensor,
    spacing: tuple,
    affine: np.ndarray,
    smooth_iterations: int = 30,
    decimate_fraction: float = 0.5,
) -> TriMesh:
    """Binary float32 mask on a device -> world-space (RAS) surface mesh
    there."""
    dev = mask.device
    if not bool(mask.any()):
        return TriMesh(device=dev)
    verts, faces = marching_cubes(mask, level=0.5, spacing=(1.0, 1.0, 1.0), device=dev)
    # marching works on the (i, j, k) grid directly (unit spacing); verts are
    # voxel indices in (i, j, k) order here because we feed the volume as-is.
    # The affine in float64, each product and sum a separate op.
    v = verts.double()
    a = np.asarray(affine, dtype=np.float64)
    world = [((v[:, 0] * float(a[r, 0]) + v[:, 1] * float(a[r, 1])) + v[:, 2] * float(a[r, 2]))
             + float(a[r, 3]) for r in range(3)]
    mesh = TriMesh(torch.stack(world, dim=1).float(), faces, device=dev)
    return _postprocess(mesh, smooth_iterations, decimate_fraction)


def _label_mask(volume: torch.Tensor, labels) -> torch.Tensor:
    """float32 mask of the voxels whose integer label is in `labels`."""
    wanted = torch.as_tensor(list(labels), dtype=torch.int64, device=volume.device)
    return torch.isin(volume.to(torch.int64), wanted).float()


def nifti_label_to_separate_meshes(
    label_path: str,
    include_upper_labels=None,
    include_lower_labels=None,
    smooth_iterations: int = 30,
    decimate_fraction: float = 0.5,
    device=None,
) -> dict:
    """ToothFairy3 labels -> separate maxilla / mandible meshes, shared origin,
    Z flipped so Superior is up (parity: dicom_loader.py:254-311)."""
    if include_upper_labels is None:
        include_upper_labels = [2] + UPPER_TEETH_LABELS
    if include_lower_labels is None:
        include_lower_labels = [1] + LOWER_TEETH_LABELS
    if not include_upper_labels and not include_lower_labels:
        raise ValueError("At least one upper or lower label must be selected.")
    dev = resolve_device(device, "nifti_label_to_separate_meshes")

    volume, spacing, affine = nifti_to_volume(label_path)
    vol = _to_device(volume, dev)
    upper_mask = _label_mask(vol, include_upper_labels)
    lower_mask = _label_mask(vol, include_lower_labels)
    del vol

    maxilla = _volume_mask_to_mesh(upper_mask, spacing, affine, smooth_iterations, decimate_fraction)
    mandible = _volume_mask_to_mesh(lower_mask, spacing, affine, smooth_iterations, decimate_fraction)

    if maxilla.n_points and mandible.n_points:
        combined = maxilla.merge(mandible)
    elif maxilla.n_points:
        combined = maxilla.copy()
    else:
        combined = mandible.copy()

    origin = combined.center
    for m in (maxilla, mandible, combined):
        if m.n_points:
            m.translate(-origin, inplace=True)
            m.vertices[:, 2] *= -1.0          # Z-flip: Superior = +Z

    return {
        "maxilla_mesh": maxilla,
        "mandible_mesh": mandible,
        "combined_mesh": combined,
    }


def nifti_label_to_bone_mesh(
    label_path: str,
    include_labels=None,
    smooth_iterations: int = 30,
    decimate_fraction: float = 0.5,
    device=None,
) -> TriMesh:
    """Selected NIfTI labels -> single centered bone mesh."""
    if include_labels is None:
        include_labels = [1, 2]
    dev = resolve_device(device, "nifti_label_to_bone_mesh")
    volume, spacing, affine = nifti_to_volume(label_path)
    mask = _label_mask(_to_device(volume, dev), include_labels)
    if not bool(mask.any()):
        raise ValueError(f"No voxels found for labels {include_labels} in {label_path}.")
    return _centered(_volume_mask_to_mesh(mask, spacing, affine, smooth_iterations,
                                          decimate_fraction))


def nifti_image_to_bone_mesh(
    image_path: str,
    hu_threshold: float = 300.0,
    smooth_iterations: int = 30,
    decimate_fraction: float = 0.5,
    device=None,
) -> TriMesh:
    """Raw NIfTI CBCT image -> bone mesh via HU thresholding."""
    dev = resolve_device(device, "nifti_image_to_bone_mesh")
    volume, spacing, affine = nifti_to_volume(image_path)
    mask = (_to_device(volume, dev) >= float(np.float32(hu_threshold))).float()
    return _centered(_volume_mask_to_mesh(mask, spacing, affine, smooth_iterations,
                                          decimate_fraction))
