"""The port's conversion of Y'CbCr to RGB (`omfs4d_torch.io.swscale`) held to
cv2's, which the JAX package reads every video through: swscale's unscaled
path (8-bit 4:2:0 and 4:2:2 at an even height) and its scaled path (9- and
10-bit samples, odd heights, odd sides, JPEG's other samplings), each within
its fixed bound (`PATH_BOUND`: 0, bit for bit).

- I_PCM H.264 streams of seeded random planes (the samples themselves), in
  every matrix swscale tells apart and BT.601, both ranges, 8 and 10 bits,
  read by cv2 and converted by `h264.ycbcr_to_rgb`; the matrices swscale
  refuses raise;
- HEVC Main 10 in each chroma siting the VUI can give;
- files cv2 writes (`mp4v`, `MJPG`), Motion JPEG of cv2's JPEG frames in
  every sampling, and MPEG-4 Part 2 at odd sizes, read by the port's readers;
- the committed clips through both packages' `extract_frames`;
- the committed sample `chip_smoke.py` holds the conversion to on the card's
  machine (`tests/make_swscale_samples.py`).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, h264, hevc, jpeg, mjpeg, mpeg4, swscale
from omfs4d_torch.io import video as tvideo
from tests import torch_h264_syntax as syn
from tests import torch_hevc_syntax as hsyn
from tests import torch_mpeg4_syntax as msyn
from tests.test_torch_h264_high import PATH_BOUND

DATA = Path(__file__).resolve().parent / "data"
# matrix_coefficients: BT.709, FCC, SMPTE 240M, BT.2020 (the four swscale
# tells apart), and BT.601 under four of its names (6, 5, unspecified, 0)
MATRICES = (1, 4, 7, 9, 6, 5, 2, 0)
PCM_SIZES = ((8, 8), (16, 16), (62, 100), (130, 98), (48, 66))


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)


def cv2_rgb(path) -> list[np.ndarray]:
    """Every frame cv2 reads from a file, RGB."""
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])
    cap.release()
    return frames


def path_of(planes, bit_depth: int) -> str:
    y, cb, _ = planes
    return "unscaled" if swscale.takes_unscaled(y.shape, cb.shape, bit_depth) else "scaled"


def assert_held(ours: np.ndarray, theirs: np.ndarray, path: str, what: str) -> None:
    assert ours.shape == theirs.shape, what
    worst = int(np.abs(ours.astype(int) - theirs.astype(int)).max())
    assert worst <= PATH_BOUND[path], f"{what}: {worst} off on the {path} path"


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("full", [False, True], ids=["limited", "full"])
@pytest.mark.parametrize("matrix", MATRICES, ids=[f"m{m}" for m in MATRICES])
def test_pcm_streams_convert_as_cv2_does(tmp_path, matrix, full, bit_depth):
    """Seeded random planes of every size in `PCM_SIZES` (widths that are not
    multiples of 8 or 16 among them; at 8 x 8 the scaled path's vertical
    chroma filter has two taps), in I_PCM streams whose VUI gives the
    range and the matrix: cv2's frame and `ycbcr_to_rgb` of the planes agree
    within the path's bound; 8 bits take the unscaled path, 10 the scaled."""
    rng = np.random.default_rng([matrix, full, bit_depth])
    dtype = np.uint8 if bit_depth == 8 else np.uint16
    for h, w in PCM_SIZES:
        planes = (rng.integers(0, 1 << bit_depth, (h, w)).astype(dtype),
                  *(rng.integers(0, 1 << bit_depth, (h // 2, w // 2)).astype(dtype)
                    for _ in range(2)))
        path = tmp_path / f"{h}x{w}.h264"
        path.write_bytes(syn.pcm_stream([planes], (int(full), 2, 2, matrix), bit_depth=bit_depth))
        (theirs,) = cv2_rgb(path)
        ours = h264.ycbcr_to_rgb(*planes, full_range=full, matrix=matrix, bit_depth=bit_depth)
        kind = path_of(planes, bit_depth)
        assert kind == ("unscaled" if bit_depth == 8 else "scaled")
        assert_held(ours, theirs, kind, f"{h}x{w}")


@pytest.mark.parametrize("matrix", sorted(swscale.REFUSED_MATRICES))
def test_matrices_swscale_refuses_raise(tmp_path, capfd, matrix):
    """YCgCo, BT.2020 constant luminance, ST 2085, the chromaticity-derived
    matrices, ICtCp and the rest swscale has no conversion for: cv2 logs
    "Unsupported input" and hands back a frame it never converted; the port
    raises, naming the matrix.  18 and above read as BT.601, in both."""
    y = np.full((16, 16), 128, np.uint8)
    cb = cr = np.full((8, 8), 128, np.uint8)
    path = tmp_path / "m.h264"
    path.write_bytes(syn.pcm_stream([(y, cb, cr)], (0, 1, 1, matrix)))
    cv2_rgb(path)
    assert "Unsupported input" in capfd.readouterr().err
    with pytest.raises(container.UnsupportedCodecError, match=f"matrix_coefficients {matrix}"):
        h264.ycbcr_to_rgb(y, cb, cr, matrix=matrix)
    rng = np.random.default_rng(matrix)
    planes = (rng.integers(0, 256, (16, 16)).astype(np.uint8),
              *(rng.integers(0, 256, (8, 8)).astype(np.uint8) for _ in range(2)))
    path.write_bytes(syn.pcm_stream([planes], (0, 1, 1, 18 + matrix)))
    (theirs,) = cv2_rgb(path)
    np.testing.assert_array_equal(h264.ycbcr_to_rgb(*planes, matrix=18 + matrix), theirs)


@pytest.mark.parametrize("loc", [None, 0, 1, 2, 3, 4, 5], ids=lambda v: f"loc{v}")
def test_main10_follows_the_vuis_chroma_siting(tmp_path, loc):
    """A Main 10 stream with chroma_loc_info of each type (or none, which
    FFmpeg reads as left): the reader's SPS gives FFmpeg's AVChromaLocation
    and the scaled path, which resamples chroma from there, equals cv2's
    frames; any other siting is far off."""
    aus = hsyn.write_stream(5, bit_depth=10, chroma_loc=loc, frames=2, width=64, height=48)
    data = hsyn.annexb(aus)
    (tmp_path / "s.hevc").write_bytes(data)
    theirs = cv2_rgb(tmp_path / "s.hevc")
    sps = hevc.parse_sps(next(u for u in aus[0] if hevc.nal_type(u) == hevc.NAL_SPS))
    assert sps["location"] == (1 if loc is None else loc + 1)
    pictures = hevc.decode_annexb(data)
    assert len(pictures) == len(theirs) == 2
    for planes, rgb in zip(pictures, theirs):
        assert_held(h264.ycbcr_to_rgb(*planes, bit_depth=10, matrix=2,
                                      location=sps["location"]), rgb, "scaled", f"loc {loc}")
        other = 1 + sps["location"] % 6
        wrong = swscale.to_rgb(*planes, depth=10, location=other)
        assert np.abs(wrong.astype(int) - rgb).max() > 30


@pytest.mark.parametrize("w, h", [(41, 25), (40, 25), (41, 24), (47, 33), (64, 31), (18, 9)])
def test_mpeg4_odd_sizes_read_as_cv2_does(tmp_path, w, h):
    """MPEG-4 Part 2 at odd heights (swscale's scaled path, chroma sited
    left), odd widths (the unscaled path at an even height) and both (chroma
    interpolated at every pixel), in AVI: the port's frames equal cv2's."""
    _, headers, vops = msyn.write_stream(3, width=w, height=h, frames=3)
    path = tmp_path / "s.avi"
    msyn.write_avi(path, [headers + vops[0]] + vops[1:], w, h, b"XVID")
    frames, theirs = mpeg4.frames(path), cv2_rgb(path)
    assert len(frames) == len(theirs) == 3
    for i, rgb in enumerate(theirs):
        planes = frames.ycbcr(i)
        assert path_of(planes, 8) == ("scaled" if h & 1 else "unscaled")
        assert_held(frames.rgb(i), rgb, path_of(planes, 8), f"frame {i}")


def moving_clip(n: int, h: int, w: int, seed: int) -> list[np.ndarray]:
    """n BGR frames of smooth noise panning, with grain."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 8, w // 8 + 8, 3)).astype(np.uint8)
    big = cv2.resize(base, (w + 32, h + 32), interpolation=cv2.INTER_CUBIC)
    big = cv2.add(big, rng.integers(0, 24, big.shape).astype(np.uint8))
    return [np.ascontiguousarray(big[i:i + h, 2 * i:2 * i + w]) for i in range(n)]


@pytest.mark.parametrize("fourcc, suffix", [("mp4v", "mp4"), ("MJPG", "avi")])
@pytest.mark.parametrize("w, h", [(130, 98), (136, 100), (132, 90), (100, 62)])
def test_cv2_files_extract_as_in_the_jax_package(tmp_path, fourcc, suffix, w, h):
    """cv2's mp4v MP4 and MJPG AVI files at widths that are not multiples of
    8: the port's extract_frames equals the JAX package's, frame for frame
    (the unscaled path; the MJPG frames through FFmpeg's IDCT)."""
    path = tmp_path / f"c.{suffix}"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25.0, (w, h))
    for frame in moving_clip(3, h, w, w + h):
        writer.write(frame)
    writer.release()
    ours = tvideo.extract_frames(path, tmp_path / "ours")
    theirs = jvideo.extract_frames(path, tmp_path / "theirs")
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert_held(tvideo.read_image(a), tvideo.read_image(b), "unscaled", str(a))


SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


@pytest.mark.parametrize("sampling", list(SAMPLINGS) + ["grey"])
@pytest.mark.parametrize("w, h", [(64, 48), (67, 49), (66, 47), (65, 48)])
def test_mjpeg_frames_read_as_cv2_does(tmp_path, sampling, w, h):
    """Motion JPEG in AVI of cv2's JPEG frames in each sampling (and grey),
    at even and odd sides: the port's frames (FFmpeg's simple IDCT, then
    swscale in full range, chroma sited at the centre) equal cv2's; the
    same bytes as a JPEG file still decode as libjpeg (cv2.imdecode)
    decodes them."""
    rng = np.random.default_rng([w, h, len(sampling)])
    jpegs = []
    for _ in range(2):
        img = rng.integers(0, 256, (h, w) if sampling == "grey" else (h, w, 3)).astype(np.uint8)
        params = [cv2.IMWRITE_JPEG_QUALITY, 90]
        if sampling != "grey":
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
        ok, data = cv2.imencode(".jpg", img, params)
        jpegs.append(data.tobytes())
    path = mjpeg.write(tmp_path / "m.avi", jpegs, 25, w, h)
    frames, theirs = mjpeg.frames(path), cv2_rgb(path)
    assert len(frames) == len(theirs) == 2
    for i, rgb in enumerate(theirs):
        planes = jpeg.decode_planes(frames[i], idct=jpeg.idct_simple)[0]
        kind = "unscaled" if len(planes) == 1 else path_of(planes, 8)
        assert_held(frames.rgb(i), rgb, kind, f"frame {i}")
        file_rgb = cv2.imdecode(np.frombuffer(jpegs[i], np.uint8), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(jpeg.decode_jpeg(jpegs[i]),
                                      file_rgb if file_rgb.ndim == 2 else file_rgb[..., ::-1])


def test_a_sampling_ffmpeg_has_no_format_for_is_refused():
    """A frame whose chroma is sampled finer than its luma has no pixel
    format in cv2's FFmpeg: the reader raises, naming the sampling."""
    data = bytearray(jpeg.encode_jpeg(np.zeros((16, 16, 3), np.uint8)))
    sof = data.index(b"\xff\xc0")
    data[sof + 11], data[sof + 14] = 0x11, 0x22          # Y 1 x 1, Cb 2 x 2
    with pytest.raises(container.UnsupportedCodecError, match="sampled"):
        mjpeg.frame_rgb(bytes(data))


CLIPS = ["hevc/clip_hevc.mp4", "hevc/portrait.mov", "hevc/clip_hevc10.mp4",
         "hevc/clip_hevc_tools.mp4", "h264/clip_b.mp4", "h264/clip.mov",
         "mpeg4/clip_mp4v.mp4", "mpeg4/clip_xvid.avi", "mpeg4/stitched.mp4"]


@pytest.mark.parametrize("clip", CLIPS)
def test_committed_clips_extract_as_in_the_jax_package(tmp_path, clip):
    """Each committed clip cv2 converts without colour management (8-bit
    4:2:0 on the unscaled path; clip_hevc10.mp4, Main 10, on the scaled
    path): its first two frames from the port's extract_frames equal the
    JAX package's."""
    path = DATA / clip
    ours = tvideo.extract_frames(path, tmp_path / "ours", max_frames=2)
    theirs = jvideo.extract_frames(path, tmp_path / "theirs", max_frames=2)
    assert len(ours) == len(theirs) == 2
    kind = "scaled" if clip.endswith("10.mp4") else "unscaled"
    for a, b in zip(ours, theirs):
        assert_held(tvideo.read_image(a), tvideo.read_image(b), kind, f"{clip} {a.name}")


def test_the_committed_sample_is_reproduced():
    """`tests/data/swscale/cv2_swscale.npz` has its manifest's SHA-256 and
    size, and every case (both paths, both ranges, odd sizes, JPEG's
    samplings) converts to cv2's frame with the case's keywords."""
    manifest = json.loads((DATA / "swscale" / "manifest.json").read_text())
    entry = manifest["samples"]["cv2_swscale.npz"]
    raw = (DATA / "swscale" / "cv2_swscale.npz").read_bytes()
    assert (hashlib.sha256(raw).hexdigest(), len(raw)) == (entry["sha256"], entry["bytes"])
    sample = np.load(DATA / "swscale" / "cv2_swscale.npz")
    kinds = set()
    for name, kw in entry["cases"].items():
        planes = tuple(sample[f"{name}_{k}"] for k in ("y", "cb", "cr"))
        kind = path_of(planes, kw["depth"])
        kinds.add((kind, kw["full"]))
        assert_held(swscale.to_rgb(*planes, **kw), sample[f"{name}_rgb"], kind, name)
    assert kinds == {(p, f) for p in PATH_BOUND for f in (False, True)}


def test_filters_are_swscales():
    """`init_filter`'s bicubic filters: each sums to its `one`; no scaling and
    no shift is one tap; 4:2:0 chroma sited left reaches the grid a quarter
    sample ahead across and a quarter back / ahead down, with swscale's
    coefficients at the top edge."""
    f, start = swscale.init_filter(1 << 16, 10, 10, 4, 1 << 14, 128, 128)
    dense = np.zeros((10, 10), int)
    for i, (row, s) in enumerate(zip(f, start)):        # the last taps shifted in, as swscale's
        dense[i, s:s + 4] += row
    np.testing.assert_array_equal(dense, np.eye(10, dtype=int) << 14)
    across, _ = swscale.init_filter(1 << 16, 24, 24, 4, 1 << 14, 64, 128)
    down, start = swscale.init_filter(1 << 15, 16, 32, 2, 1 << 12, 128, 128)
    assert (across.sum(1) == 1 << 14).all() and (down.sum(1) == 1 << 12).all()
    np.testing.assert_array_equal(down[:4], [[4432, -336, 0, 0], [3226, 985, -115, 0],
                                             [959, 3473, -336, 0], [-346, 3572, 985, -115]])
    np.testing.assert_array_equal(start[:6], [0, 0, 0, 0, 0, 1])
    # the interior: Keys' cubic with a = -0.6 at 1.75, 0.75, 0.25 and 1.25
    # samples (row 2k, at k - 1/4) and the mirror (row 2k + 1, at k + 1/4)
    np.testing.assert_array_equal(down[10], down[12])
    np.testing.assert_array_equal(down[11], down[10][::-1])
    assert abs(down[10] / 4096 - [-0.028125, 0.240625, 0.871875, -0.084375]).max() < 1e-3
