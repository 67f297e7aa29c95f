"""The port's baseline JPEG decoder (`omfs4d_torch.io.jpeg`) against PIL and
cv2 on the CPU: JPEGs that PIL and cv2 write here (qualities 50 / 75 / 95,
4:4:4 / 4:2:2 / 4:2:0 and cv2's other sampling factors, gray, restart
intervals, Adobe RGB, optimized tables, sides 1 / 7 / 17 / 513 px) decode to
the pixels PIL and cv2 decode, exactly; progressive, arithmetic-coded and
12-bit frames raise naming their SOF marker; `read_image` tells PNG from JPEG
by its first bytes; a JPEG Baseline DICOM slice, gray or RGB, reads as the
reference reads it with PIL, with PIL's import blocked.

Whether PIL and cv2 are there is decided inside each test."""

import io
import sys

import numpy as np
import pytest

from omfs4d_torch.io import dicom as tdicom
from omfs4d_torch.io import jpeg as tjpeg
from omfs4d_torch.io import video as tvideo

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def picture(h, w, seed=0):
    """A seeded (h, w, 3) uint8 picture: smooth gradients under noise, so
    that every coefficient band and both chroma planes carry signal."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0), 128 + 90 * np.cos(y / 5.0),
                     (x * 3 + y * 2) % 256], axis=-1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def pil_jpeg(arr, **kw) -> bytes:
    Image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil_decode(data: bytes) -> np.ndarray:
    Image = pytest.importorskip("PIL.Image")
    return np.asarray(Image.open(io.BytesIO(data)))


def cv2_decode(data: bytes, gray: bool = False) -> np.ndarray:
    cv2 = pytest.importorskip("cv2")
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    return img if gray else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("side", [1, 7, 17, 513])
def test_decode_equals_pil_and_cv2(side, quality, subsampling):
    data = pil_jpeg(picture(side, side, seed=side), quality=quality,
                    subsampling=SUBSAMPLING[subsampling])
    got = tjpeg.decode_jpeg(data)
    assert got.shape == (side, side, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, pil_decode(data))
    np.testing.assert_array_equal(got, cv2_decode(data))


@pytest.mark.parametrize("h,w", [(7, 7), (17, 30), (513, 513)])
def test_gray_equals_pil_and_cv2(h, w):
    cv2 = pytest.importorskip("cv2")
    g = picture(h, w)[..., 0]
    data = pil_jpeg(g, quality=75)
    np.testing.assert_array_equal(tjpeg.decode_jpeg(data), pil_decode(data))
    data = cv2.imencode(".jpg", g, [cv2.IMWRITE_JPEG_QUALITY, 75])[1].tobytes()
    got = tjpeg.decode_jpeg(data)
    assert got.shape == (h, w)
    np.testing.assert_array_equal(got, cv2_decode(data, gray=True))


@pytest.mark.parametrize("kw", [dict(restart_marker_blocks=1),
                                dict(restart_marker_rows=1, subsampling=2),
                                dict(restart_marker_blocks=3, subsampling=1),
                                dict(optimize=True), dict(keep_rgb=True, subsampling=0)],
                         ids=["rst every block", "rst every row 4:2:0", "rst 3 blocks 4:2:2",
                              "optimized tables", "Adobe RGB"])
def test_pil_options_decode_equal(kw):
    try:
        data = pil_jpeg(picture(37, 61, seed=3), quality=80, **kw)
    except (TypeError, ValueError, OSError) as e:        # an older PIL without the option
        pytest.skip(f"PIL cannot write {kw}: {e}")
    if "restart_marker_blocks" in kw or "restart_marker_rows" in kw:
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    if "keep_rgb" in kw:
        assert b"Adobe" in data
    np.testing.assert_array_equal(tjpeg.decode_jpeg(data), pil_decode(data))


@pytest.mark.parametrize("factor", ["411", "420", "422", "440", "444"])
def test_cv2_sampling_factors_and_restarts_decode_equal(factor):
    cv2 = pytest.importorskip("cv2")
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}", None)
    if flag is None:
        pytest.skip(f"this cv2 cannot write {factor}")
    bgr = np.ascontiguousarray(picture(45, 70, seed=5)[..., ::-1])
    for params in ([cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag],
                   [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag, cv2.IMWRITE_JPEG_RST_INTERVAL, 2]):
        data = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 85] + params)[1].tobytes()
        np.testing.assert_array_equal(tjpeg.decode_jpeg(data), cv2_decode(data))


def test_unsupported_frames_raise_naming_the_marker():
    Image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    Image.fromarray(picture(20, 20)).save(buf, "JPEG", progressive=True)
    with pytest.raises(ValueError, match="SOF2"):
        tjpeg.decode_jpeg(buf.getvalue())
    base = pil_jpeg(picture(20, 20), quality=75)
    sof = base.index(b"\xff\xc0")
    arithmetic = base[:sof + 1] + b"\xc9" + base[sof + 2:]
    with pytest.raises(ValueError, match="SOF9"):
        tjpeg.decode_jpeg(arithmetic)
    lossless = base[:sof + 1] + b"\xc3" + base[sof + 2:]
    with pytest.raises(ValueError, match="SOF3"):
        tjpeg.decode_jpeg(lossless)
    twelve_bit = base[:sof + 1] + b"\xc1" + base[sof + 2:sof + 4] + b"\x0c" + base[sof + 5:]
    with pytest.raises(ValueError, match="12-bit SOF1"):
        tjpeg.decode_jpeg(twelve_bit)
    with pytest.raises(ValueError, match="not a JPEG"):
        tjpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")


def test_a_corrupt_scan_raises():
    base = pil_jpeg(picture(16, 16), quality=75)
    sos = base.index(b"\xff\xda")
    cut = base[:sos + 40]
    with pytest.raises(ValueError, match="JPEG"):
        tjpeg.decode_jpeg(cut + b"\xff" * 4)


def test_read_image_tells_png_from_jpeg_by_its_bytes(tmp_path):
    pic = picture(9, 11)
    data = pil_jpeg(pic, quality=90)
    (tmp_path / "a.png").write_bytes(data)            # a JPEG under a PNG name
    tvideo.write_image(tmp_path / "b.jpg", pic)       # a PNG under a JPEG name
    np.testing.assert_array_equal(tvideo.read_image(tmp_path / "a.png"), pil_decode(data))
    np.testing.assert_array_equal(tvideo.read_image(tmp_path / "b.jpg"), pic)
    gray = pil_jpeg(pic[..., 1], quality=90)
    (tmp_path / "g.jpg").write_bytes(gray)
    got = tvideo.read_image(tmp_path / "g.jpg")
    assert got.shape == (9, 11, 3)
    np.testing.assert_array_equal(got, np.repeat(pil_decode(gray)[..., None], 3, axis=2))
    (tmp_path / "c.jpg").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        tvideo.read_image(tmp_path / "c.jpg")


@pytest.mark.parametrize("mode", ["gray", "rgb"])
def test_dicom_jpeg_frame_reads_as_the_reference_without_pil(mode, monkeypatch):
    """The reference's rule (`omfs4d/io/dicom.py:179-191`): an RGB secondary
    capture becomes the mean of its channels; with PIL's import blocked the
    port reads the frame as the reference reads it with PIL."""
    from omfs4d.io import dicom as jdicom

    pic = picture(24, 40, seed=7)
    data = pil_jpeg(pic if mode == "rgb" else pic[..., 2], quality=92)
    for dtype in (np.uint8, np.int16):
        want = jdicom._decode_jpeg_baseline(data, 24, 40, dtype)
        monkeypatch.setitem(sys.modules, "PIL", None)
        monkeypatch.setitem(sys.modules, "PIL.Image", None)
        got = tdicom._decode_jpeg_baseline(data, 24, 40, dtype)
        monkeypatch.undo()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_dicom_jpeg_series_loads_without_pil(tmp_path, monkeypatch):
    """A JPEG Baseline series written by the port's writer (PIL) loads with
    PIL's import blocked, equal to the reference's load with PIL."""
    pytest.importorskip("PIL")
    from omfs4d.io import dicom as jdicom

    slices = picture(3 * 20, 20, seed=9)[..., 0].reshape(3, 20, 20)
    for i, z in enumerate((2.0, 0.0, 1.0)):
        tdicom.write_dicom_slice(tmp_path / f"s{i}.dcm", slices[i], position=(0.0, 0.0, z),
                                 transfer_syntax=tdicom.JPEG_BASELINE)
    want, _ = jdicom.load_dicom_series(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    got, _ = tdicom.load_dicom_series(tmp_path)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 20, 20)


def test_idct_of_a_dc_block_is_flat():
    """The islow IDCT of a DC-only block is flat at DC / 8 + 128, rounded
    as libjpeg rounds it, and range-limited."""
    coef = np.zeros((4, 8, 8), np.int64)
    coef[:, 0, 0] = [0, 80, -1100, 4000]
    out = tjpeg.idct_islow(coef)
    for block, dc in zip(out, (0, 80, -1100, 4000)):
        want = min(max((dc * 4 + 16) // 32 + 128, 0), 255)
        assert (block == want).all()
