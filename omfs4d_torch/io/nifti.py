"""First-party NIfTI-1 reader/writer (nibabel is not a dependency).

Port of `omfs4d.io.nifti` (host NumPy; verbatim): the volume is read on the
host and handed to the card by the clinical loader.

Replaces the reference's `nib.load` usage (ref: dicom_loader.py:197-213):
returns (volume, spacing, affine) with the voxel->world (RAS) affine taken
from the sform when valid, else the qform quaternion, else a pixdim scale.
Supports .nii and .nii.gz, the common scalar dtypes, and scl_slope/inter
rescaling.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str | Path):
    p = Path(path)
    if p.suffix == ".gz":
        return gzip.open(p, "rb")
    return open(p, "rb")


def _quaternion_affine(hdr: dict) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    qfac = hdr["pixdim"][0] if hdr["pixdim"][0] != 0 else 1.0
    scale = np.array([hdr["pixdim"][1], hdr["pixdim"][2], qfac * hdr["pixdim"][3]])
    aff = np.eye(4)
    aff[:3, :3] = R * scale[None, :]
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def load_nifti(path: str | Path):
    """Load a NIfTI-1 file.

    Returns
    -------
    volume  : np.ndarray, fortran-ordered dims (i, j, k[, ...])
    spacing : tuple of the first three pixdims (mm)
    affine  : (4, 4) voxel->world RAS matrix
    """
    with _open(path) as f:
        raw = f.read()

    hdr_bytes = raw[:348]
    sizeof_hdr = struct.unpack("<i", hdr_bytes[0:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        sizeof_hdr_be = struct.unpack(">i", hdr_bytes[0:4])[0]
        if sizeof_hdr_be == 348:
            endian = ">"
        else:
            raise ValueError(f"not a NIfTI-1 file: {path}")

    def u(fmt, off, n=1):
        vals = struct.unpack_from(endian + fmt * n, hdr_bytes, off)
        return vals[0] if n == 1 else vals

    dim = u("h", 40, 8)
    ndim = dim[0]
    shape = tuple(int(x) for x in dim[1 : 1 + max(ndim, 3)])
    datatype = u("h", 70)
    pixdim = u("f", 76, 8)
    vox_offset = int(u("f", 108))
    scl_slope = u("f", 112)
    scl_inter = u("f", 116)
    hdr = {
        "pixdim": pixdim,
        "quatern_b": u("f", 256),
        "quatern_c": u("f", 260),
        "quatern_d": u("f", 264),
        "qoffset_x": u("f", 268),
        "qoffset_y": u("f", 272),
        "qoffset_z": u("f", 276),
    }
    qform_code = u("h", 252)
    sform_code = u("h", 254)

    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    volume = np.asarray(data).reshape(shape, order="F").astype(np.float32)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        volume = volume * slope + scl_inter

    if sform_code > 0:
        affine = np.eye(4)
        affine[0, :] = u("f", 280, 4)
        affine[1, :] = u("f", 296, 4)
        affine[2, :] = u("f", 312, 4)
    elif qform_code > 0:
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])

    spacing = tuple(float(abs(p)) for p in pixdim[1:4])
    return volume, spacing, affine


def save_nifti(path: str | Path, volume: np.ndarray, affine: np.ndarray | None = None,
               spacing: tuple = (1.0, 1.0, 1.0)):
    """Write a minimal NIfTI-1 (.nii / .nii.gz) file with an sform affine."""
    vol = np.asarray(volume)
    if vol.dtype not in _CODES:
        vol = vol.astype(np.float32)
    if affine is None:
        affine = np.diag([spacing[0], spacing[1], spacing[2], 1.0])

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [vol.ndim] + list(vol.shape) + [1] * (7 - vol.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES[np.dtype(vol.dtype)])
    struct.pack_into("<h", hdr, 72, vol.dtype.itemsize * 8)
    pix = [1.0, float(spacing[0]), float(spacing[1]), float(spacing[2]), 1, 1, 1, 1]
    struct.pack_into("<8f", hdr, 76, *pix)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<h", hdr, 254, 1)       # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0, :].tolist())
    struct.pack_into("<4f", hdr, 296, *affine[1, :].tolist())
    struct.pack_into("<4f", hdr, 312, *affine[2, :].tolist())
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + vol.tobytes(order="F")
    p = Path(path)
    if p.suffix == ".gz":
        with gzip.open(p, "wb") as f:
            f.write(payload)
    else:
        with open(p, "wb") as f:
            f.write(payload)
