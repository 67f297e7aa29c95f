"""The port's clinical IO (`omfs4d_torch.io.{meshio,nifti,dicom}`) against the
JAX package's (`omfs4d.io.*`) on the CPU: mesh files byte-equal to the
reference's, each package loading the other's; NIfTI both ways; DICOM series
raw, RLE and JPEG Baseline read equal to the reference's; an unsupported
transfer syntax raising the reference's error; and with PIL made
unimportable (the card's machine has none) a JPEG series still loads through
the port's own decoder, and a progressive one raises with the reason."""

import sys

import numpy as np
import pytest

from omfs4d.io import dicom as jdicom
from omfs4d.io import meshio as jmeshio
from omfs4d.io import nifti as jnifti
from omfs4d.ops.primitives import make_sphere_mesh
from omfs4d_torch.io import dicom as tdicom
from omfs4d_torch.io import meshio as tmeshio
from omfs4d_torch.io import nifti as tnifti


def mesh(kind: str):
    if kind == "sphere":
        m = make_sphere_mesh(radius=12.5, center=(1.0, -2.0, 3.0), res=12)
        return m.vertices, m.faces
    rng = np.random.default_rng(0)
    v = (rng.normal(size=(60, 3)) * 40).astype(np.float32)
    f = rng.integers(0, 60, size=(90, 3)).astype(np.int32)
    f[:3, 1] = f[:3, 0]                           # zero-area faces: zero normals
    return v, f


WRITERS = {
    "stl binary": lambda mod, p, v, f: mod.save_stl(p, v, f),
    "stl ascii": lambda mod, p, v, f: mod.save_stl(p, v, f, binary=False),
    "obj": lambda mod, p, v, f: mod.save_obj(p, v, f),
    "ply": lambda mod, p, v, f: mod.save_mesh(p, v, f),
    "save_mesh stl": lambda mod, p, v, f: mod.save_mesh(p, v, f),
    "save_mesh obj": lambda mod, p, v, f: mod.save_mesh(p, v, f),
}
SUFFIX = {"stl binary": ".stl", "stl ascii": ".stl", "obj": ".obj", "ply": ".ply",
          "save_mesh stl": ".stl", "save_mesh obj": ".obj"}


@pytest.mark.parametrize("kind", ["sphere", "random"])
@pytest.mark.parametrize("fmt", list(WRITERS))
def test_mesh_files_byte_equal_and_cross_loading(tmp_path, fmt, kind):
    v, f = mesh(kind)
    pj, pt = tmp_path / f"j{SUFFIX[fmt]}", tmp_path / f"t{SUFFIX[fmt]}"
    WRITERS[fmt](jmeshio, pj, v, f)
    WRITERS[fmt](tmeshio, pt, v, f)
    assert pt.read_bytes() == pj.read_bytes()
    for path in (pj, pt):
        rv, rf = jmeshio.load_mesh(path)
        tv, tf = tmeshio.load_mesh(path)
        assert tv.dtype == rv.dtype and tf.dtype == rf.dtype
        np.testing.assert_array_equal(tv, rv)
        np.testing.assert_array_equal(tf, rf)


def test_unsupported_mesh_format_raises(tmp_path):
    v, f = mesh("sphere")
    for fn, args in ((tmeshio.save_mesh, (tmp_path / "m.vtk", v, f)),
                     (tmeshio.load_mesh, (tmp_path / "m.vtk",))):
        with pytest.raises(ValueError, match="unsupported mesh format"):
            fn(*args)


# ── NIfTI ──────────────────────────────────────────────────

VOLUMES = {
    "float32 labels": (lambda: np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4), ".nii.gz"),
    "int16": (lambda: np.random.default_rng(0).integers(-1000, 2000, (5, 6, 7)).astype(np.int16),
              ".nii"),
    "uint8 labels": (lambda: np.random.default_rng(1).integers(0, 48, (6, 5, 4)).astype(np.uint8),
                     ".nii.gz"),
    "float64": (lambda: np.random.default_rng(2).normal(size=(3, 4, 5)), ".nii"),
}


@pytest.mark.parametrize("name", list(VOLUMES))
def test_nifti_both_ways(tmp_path, name):
    make, suffix = VOLUMES[name]
    vol = make()
    affine = np.diag([0.3, 0.4, 0.5, 1.0])
    affine[:3, 3] = [10, -20, 30]
    pj, pt = tmp_path / f"j{suffix}", tmp_path / f"t{suffix}"
    jnifti.save_nifti(pj, vol, affine=affine, spacing=(0.3, 0.4, 0.5))
    tnifti.save_nifti(pt, vol, affine=affine, spacing=(0.3, 0.4, 0.5))
    if suffix == ".nii":
        assert pt.read_bytes() == pj.read_bytes()
    for path in (pj, pt):
        rv, rs, ra = jnifti.load_nifti(path)
        tv, ts, ta = tnifti.load_nifti(path)
        assert tv.dtype == rv.dtype == np.float32 and ts == rs
        np.testing.assert_array_equal(tv, rv)
        np.testing.assert_array_equal(ta, ra)


def test_nifti_qform_and_scaling_match_reference(tmp_path):
    """A header with a qform and no sform, and scl_slope / scl_inter set."""
    import struct

    p = tmp_path / "q.nii"
    jnifti.save_nifti(p, np.arange(24, dtype=np.int16).reshape(2, 3, 4))
    hdr = bytearray(p.read_bytes())
    struct.pack_into("<h", hdr, 254, 0)                  # no sform
    struct.pack_into("<h", hdr, 252, 1)                  # qform
    struct.pack_into("<3f", hdr, 256, 0.1, -0.2, 0.3)    # quatern b, c, d
    struct.pack_into("<3f", hdr, 268, 5.0, 6.0, 7.0)     # qoffset
    struct.pack_into("<2f", hdr, 112, 2.0, -3.0)         # scl_slope, scl_inter
    p.write_bytes(bytes(hdr))
    for r, t in zip(jnifti.load_nifti(p), tnifti.load_nifti(p)):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(r))


# ── DICOM ──────────────────────────────────────────────────


def write_series(root, writer, raw, syntax=None, spacing=(0.5, 0.75)):
    root.mkdir()
    kw = {} if syntax is None else {"transfer_syntax": syntax}
    z_positions = [4.0, 0.0, 2.0, 3.0, 1.0, 5.0][: len(raw)]
    for i, z in enumerate(z_positions):
        writer(root / f"slice_{i}.dcm", raw[i], position=(0.0, 0.0, z), pixel_spacing=spacing,
               rescale_slope=1.0, rescale_intercept=-1024.0 if syntax is None else 0.0, **kw)
    return root


def hu_slices(seed=1, shape=(5, 8, 8)):
    return np.random.default_rng(seed).integers(0, 3000, size=shape).astype(np.int16)


@pytest.mark.parametrize("syntax", [None, jdicom.RLE_LOSSLESS], ids=["explicit LE", "RLE"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_dicom_series_equal_to_reference(tmp_path, syntax, writer):
    raw = hu_slices(shape=(5, 16, 16))
    raw[:, :8] = 24                                       # long runs for RLE
    w = (jdicom if writer == "reference" else tdicom).write_dicom_slice
    root = write_series(tmp_path / "s", w, raw, syntax)
    if writer == "port":
        ref_root = write_series(tmp_path / "r", jdicom.write_dicom_slice, raw, syntax)
        for a, b in zip(sorted(root.iterdir()), sorted(ref_root.iterdir())):
            assert a.read_bytes() == b.read_bytes()
    rv, rs = jdicom.load_dicom_series(root)
    tv, ts = tdicom.load_dicom_series(root)
    assert ts == rs == (1.0, 0.5, 0.75) and tv.dtype == rv.dtype
    np.testing.assert_array_equal(tv, rv)


def test_dicom_packbits_and_rle_frames_equal_reference():
    rng = np.random.default_rng(4)
    for data in (np.zeros(300, np.uint8), np.arange(200, dtype=np.uint8),
                 np.asarray([1, 1, 1, 2, 3, 3, 3, 3, 9], np.uint8), rng.integers(0, 3, 777).astype(np.uint8)):
        enc = tdicom._packbits_encode(data)
        assert enc == jdicom._packbits_encode(data)
        np.testing.assert_array_equal(tdicom._packbits_decode(enc, len(data)), data)
    frame = rng.integers(-1024, 3000, (12, 9)).astype(np.int16)
    enc = tdicom.encode_rle_frame(frame)
    assert enc == jdicom.encode_rle_frame(frame)
    np.testing.assert_array_equal(tdicom.decode_rle_frame(enc, 12, 9, 16, 1), frame)


def test_dicom_jpeg_baseline_equal_to_reference(tmp_path):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(3)
    smooth = np.clip(128 + 60 * np.sin(np.linspace(0, 3, 32))[None, :, None]
                     + rng.normal(0, 2, (3, 32, 32)), 0, 255).astype(np.uint8)
    root = write_series(tmp_path / "s", tdicom.write_dicom_slice, smooth, jdicom.JPEG_BASELINE)
    rv, _ = jdicom.load_dicom_series(root)
    tv, _ = tdicom.load_dicom_series(root)
    np.testing.assert_array_equal(tv, rv)
    assert np.abs(tv - smooth[[1, 2, 0]].astype(np.float32)).mean() < 4.0


def test_jpeg_series_without_pil_raises_with_the_reason(tmp_path, monkeypatch):
    """With PIL made unimportable (the card's machine has none) a JPEG
    Baseline series loads through the port's own decoder, equal to what the
    reference reads with PIL; a series of progressive JPEG frames, which the
    decoder does not read, raises with the reason."""
    PIL_Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    smooth = np.clip(100 + 50 * np.cos(np.linspace(0, 4, 24))[None, None, :]
                     + rng.normal(0, 3, (2, 24, 24)), 0, 255).astype(np.uint8)
    root = write_series(tmp_path / "s", tdicom.write_dicom_slice, smooth, jdicom.JPEG_BASELINE)
    rv, _ = jdicom.load_dicom_series(root)
    save = PIL_Image.Image.save
    monkeypatch.setattr(PIL_Image.Image, "save",
                        lambda self, fp, format=None, **kw: save(self, fp, format,
                                                                 progressive=True, **kw))
    prog = write_series(tmp_path / "p", tdicom.write_dicom_slice, smooth, jdicom.JPEG_BASELINE)
    monkeypatch.setitem(sys.modules, "PIL", None)          # import PIL now fails
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    tv, _ = tdicom.load_dicom_series(root)
    np.testing.assert_array_equal(tv, rv)
    with pytest.raises(tdicom.UnsupportedTransferSyntaxError, match="SOF2"):
        tdicom.load_dicom_series(prog)


def test_unsupported_syntax_raises_as_the_reference(tmp_path):
    tdicom.write_dicom_slice(tmp_path / "s0.dcm", np.zeros((4, 4), np.int16), position=(0, 0, 0))
    blob = (tmp_path / "s0.dcm").read_bytes().replace(b"1.2.840.10008.1.2.1 ",
                                                      b"1.2.840.10008.1.2.2 ")
    (tmp_path / "s0.dcm").write_bytes(blob)
    with pytest.raises(jdicom.UnsupportedTransferSyntaxError) as ref:
        jdicom.load_dicom_series(tmp_path)
    with pytest.raises(tdicom.UnsupportedTransferSyntaxError) as got:
        tdicom.load_dicom_series(tmp_path)
    assert str(got.value) == str(ref.value) and "1.2.840.10008.1.2.2" in str(got.value)


def test_empty_folder_raises_as_the_reference(tmp_path):
    with pytest.raises(FileNotFoundError, match="No valid DICOM files"):
        tdicom.load_dicom_series(tmp_path)
