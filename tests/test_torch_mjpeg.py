"""The port's Motion JPEG rung on the CPU, with no ffmpeg: `encode_jpeg`
against `cv2.imencode` byte for byte; the port's AVI and MP4 files read by the
JAX package's `probe_video` / `extract_frames` (cv2, FFmpeg's decoder); the
MJPG files of the reference's cv2 ladder read by the port, and its mp4v rung
(MPEG-4 Part 2, also as Xvid in AVI); the codecs that need ffmpeg refused by
name; files cut short refused with the frame's index;
OpenDML continuation lists and frames without Huffman tables; the reference's
fixture clip through both packages' `Pipeline.preprocess`."""

import io
import struct
from fractions import Fraction

import cv2
import numpy as np
import pytest
from PIL import Image

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, mjpeg
from omfs4d_torch.io import video as tvideo
from omfs4d_torch.io.jpeg import decode_jpeg, encode_jpeg, standard_dht

# FFmpeg's MJPEG decoder and swscale (cv2) against the port's read of a
# video frame (`mjpeg.frame_rgb`: FFmpeg's simple IDCT, then swscale's own
# conversion), mean grey levels: bit for bit.  libjpeg's arithmetic, which
# the port used for video frames before (and still uses for JPEG files, as
# cv2.imread does), was 2.61-2.65 off on the reference's fixture clip (max
# 40), in AVI and MP4 alike (cv2 5.0.0 on x86).
JAX_READ_MEAN_TOL = 0.0


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)


def fixture_clip(frames_dir, n=12):
    """The reference's fixture (tests/test_video_pipeline.py): a blob moving
    over a noisy background, 128 x 96, as PNG frames."""
    frames_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    bg = rng.integers(80, 120, (96, 128, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:96, 0:128]
    images = []
    for t in range(n):
        img = bg.copy()
        img[(yy - 48) ** 2 + (xx - 64 - t) ** 2 < 300] = [220, 120, 60]
        tvideo.write_image(frames_dir / f"{t:05d}.png", img)
        images.append(img)
    return images


def smooth_image(h, w, channels, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [(np.sin(xx / 7 + k) + np.cos(yy / 5 - k)) * 60 + 128 for k in range(channels)]
    img = np.stack(planes, -1) + rng.normal(0, 12, (h, w, channels))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def cv2_mjpg(path, images, fps=25.0):
    """The reference ladder's last rung: cv2.VideoWriter with MJPG (FFmpeg
    muxes it into .mp4 under the 'mp4v' tag)."""
    h, w = images[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    assert writer.isOpened()
    for img in images:
        writer.write(img[..., ::-1])
    writer.release()
    return path


# ── encode_jpeg ──────────────────────────────────────────────

@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("h,w,channels", [(16, 16, 3), (72, 100, 3), (96, 128, 3), (64, 48, 1)],
                         ids=["16x16", "72x100", "96x128", "64x48_grey"])
def test_encode_jpeg_is_cv2s_bytes(h, w, channels, quality):
    """Byte for byte cv2.imencode's file (tolerance: none); its decode by the
    port equals cv2.imdecode's (none)."""
    img = smooth_image(h, w, channels)
    bgr = img if channels == 1 else img[..., ::-1]
    want = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
    got = encode_jpeg(img, quality)
    assert got == want
    ref = cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(decode_jpeg(got), ref if channels == 1 else ref[..., ::-1])


def test_quantization_is_libjpeg_turbos_reciprocal():
    """libjpeg-turbo quantizes by a 16-bit reciprocal multiply
    (`jcdctmgr.c`: compute_reciprocal, quantize); the port divides, IJG's
    (|x| + d/2) / d.  Equal (tolerance: none) for every table entry 1..255
    and every coefficient an 8-bit islow DCT can give (|x| < 2^14)."""
    from omfs4d_torch.io.jpeg import _ZIGZAG, _quantize

    x = np.arange(-16383, 16384, dtype=np.int64)
    blocks = np.concatenate([x, np.zeros(-x.size % 64, np.int64)]).reshape(-1, 8, 8)
    for q in range(1, 256):
        d = 8 * q
        b = d.bit_length() - 1
        r, c = 16 + b, d // 2
        fq, fr = divmod(1 << r, d)
        if fr == 0:
            fq, r = fq >> 1, r - 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        want = np.sign(x) * (((np.abs(x) + c) * fq) >> r)
        got = np.empty((blocks.shape[0], 64), np.int64)
        got[:, list(_ZIGZAG)] = _quantize(blocks, np.full(64, q))    # back to natural order
        np.testing.assert_array_equal(got.reshape(-1)[:x.size], want, err_msg=str(q))


# ── the port's files, read by the JAX package ────────────────

@pytest.mark.parametrize("suffix", ["avi", "mp4"])
def test_port_video_reads_in_the_jax_package(tmp_path, suffix):
    """The port's stitch of the fixture clip (Motion JPEG in the AVI, H.264
    in the MP4): the JAX package (cv2) probes the same size, fps and frame
    count and extracts as many frames of the same size, each within a mean of
    JAX_READ_MEAN_TOL grey levels of the port's own read."""
    fixture_clip(tmp_path / "src")
    out = tvideo.stitch_video(tmp_path / "src", tmp_path / f"clip.{suffix}", fps=10)
    info = container.index(out)[2]
    assert (info["container"], info["codec"]) == (suffix, {"avi": "mjpeg", "mp4": "h264"}[suffix])
    info = tvideo.probe_video(out)
    assert info == jvideo.probe_video(out) == {"width": 128, "height": 96, "fps": 10.0,
                                               "frame_count": 12}
    ours = tvideo.extract_frames(out, tmp_path / "ours")
    theirs = jvideo.extract_frames(out, tmp_path / "theirs")
    assert [p.name for p in ours] == [p.name for p in theirs] and len(ours) == 12
    for a, b in zip(ours, theirs):
        x, y = tvideo.read_image(a).astype(int), tvideo.read_image(b).astype(int)
        assert x.shape == y.shape == (96, 128, 3)
        assert np.abs(x - y).mean() <= JAX_READ_MEAN_TOL


@pytest.mark.parametrize("suffix", ["avi", "mp4"])
@pytest.mark.parametrize("fps", [25.0, 29.97, 30000 / 1001], ids=["25", "29.97", "30000_1001"])
def test_fps_is_the_jax_packages(tmp_path, suffix, fps):
    """A frame rate written by the port reads back as cv2 reads it
    (tolerance: none)."""
    img = smooth_image(32, 48, 3)
    out = mjpeg.write(tmp_path / f"clip.{suffix}", [encode_jpeg(img)] * 3, fps, 48, 32)
    assert tvideo.probe_video(out) == jvideo.probe_video(out)
    assert tvideo.probe_video(out)["fps"] == float(Fraction(fps).limit_denominator(1001))


# ── the reference's MJPG files, read by the port ─────────────

@pytest.mark.parametrize("suffix", ["avi", "mp4"])
def test_cv2_mjpg_reads_in_the_port(tmp_path, suffix):
    """cv2's MJPG file: the port's probe is the JAX package's, each frame is
    PIL's decode of its bytes exactly, and stride / max_frames / target_size
    give the JAX package's names and shapes."""
    images = fixture_clip(tmp_path / "src", n=9)
    path = cv2_mjpg(tmp_path / f"cv2.{suffix}", images)
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    frames = mjpeg.frames(path)
    assert len(frames) == 9
    for data in frames:
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_jpeg(data), pil)
    for kw in ({"stride": 2}, {"max_frames": 3}, {"stride": 3, "max_frames": 2},
               {"target_size": 48}):
        tag = "_".join(f"{k}{v}" for k, v in kw.items())
        ours = tvideo.extract_frames(path, tmp_path / f"t_{tag}", **kw)
        theirs = jvideo.extract_frames(path, tmp_path / f"j_{tag}", **kw)
        assert [p.name for p in ours] == [p.name for p in theirs], kw
        assert ([tvideo.read_image(p).shape for p in ours]
                == [tvideo.read_image(p).shape for p in theirs]), kw


def patched(data: bytes, old: bytes, new: bytes) -> bytes:
    assert data.count(old) == 1
    return data.replace(old, new)


@pytest.mark.parametrize("case", ["mp4v", "xvid_avi", "avc1", "avc1_no_avcc", "hvc1_no_hvcc",
                                  "no_container"])
def test_other_codecs_need_ffmpeg(tmp_path, capfd, case):
    """An avc1 sample entry with no avcC box, an hvc1 entry with no hvcC box
    and a file that is no container raise a RuntimeError naming the codec and
    ffmpeg, from probe_video and extract_frames both.  A High-profile CABAC track, which raised before the
    host H.264 decoder, and MPEG-4 Part 2 (cv2's mp4v rung, OTI 0x20, and
    Xvid in AVI), which raised before the host MPEG-4 decoder, now read as
    the JAX package reads them: the same probe, as many frames, each within
    the conversion tolerance the I_PCM stream of the port's pictures shows."""
    from tests.test_torch_h264 import cabac_clip
    from tests.test_torch_mpeg4 import cv2_write, moving_clip, same_as_jax

    img = smooth_image(32, 48, 3)
    if case in ("mp4v", "xvid_avi"):
        fourcc, suffix = {"mp4v": ("mp4v", "mp4"), "xvid_avi": ("XVID", "avi")}[case]
        path = tmp_path / f"clip.{suffix}"
        cv2_write(path, fourcc, moving_clip(3, 32, 48), fps=25.0)
        assert container.index(path)[2]["codec"] == "mpeg4"
        same_as_jax(path, tmp_path, capfd, 3)
        return
    if case == "no_container":
        path, name = tmp_path / "clip.mp4", "neither an AVI nor an MP4"
        path.write_bytes(b"\x00" * 64)
    elif case == "hvc1_no_hvcc":
        from tests import torch_hevc_syntax as hevc_syn

        path, name = tmp_path / "clip.mp4", "H.265 / HEVC with no hvcC box"
        hevc_syn.write_mov(path, hevc_syn.write_stream(0, frames=2), 64, 48, quicktime=False,
                           config=False)
    elif case == "avc1":
        path = tmp_path / "clip.mp4"
        cabac_clip(path, 100)
        assert tvideo.probe_video(path) == jvideo.probe_video(path)
        ours = tvideo.extract_frames(path, tmp_path / "ours")
        theirs = jvideo.extract_frames(path, tmp_path / "theirs")
        assert len(ours) == len(theirs) == 3
        assert ([tvideo.read_image(p).shape for p in ours]
                == [tvideo.read_image(p).shape for p in theirs] == [(32, 48, 3)] * 3)
        return
    else:                                # avc1_no_avcc: cv2's mp4v as an H.264 entry
        path = tmp_path / "clip.mp4"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (48, 32))
        assert writer.isOpened()
        for _ in range(2):
            writer.write(img)
        writer.release()
        name = "H.264"
        path.write_bytes(patched(path.read_bytes(), b"mp4v", b"avc1"))
    for fn in (tvideo.probe_video, lambda p: tvideo.extract_frames(p, tmp_path / "out")):
        with pytest.raises(RuntimeError, match="ffmpeg") as err:
            fn(path)
        assert name in str(err.value) and isinstance(err.value, container.UnsupportedCodecError)


# ── cut short, OpenDML, frames with no Huffman tables ────────

def three_frames(tmp_path, suffix):
    jpegs = [encode_jpeg(smooth_image(32, 48, 3, seed=s)) for s in range(3)]
    return mjpeg.write(tmp_path / f"clip.{suffix}", jpegs, 25.0, 48, 32), jpegs


@pytest.mark.parametrize("suffix", ["avi", "mp4"])
def test_a_file_cut_short_raises_with_the_frame(tmp_path, suffix):
    """A frame whose bytes run past the end of the file, a JPEG with no EOI
    and (AVI) fewer frames than the header declares raise ValueError; the
    frames before them read."""
    path, jpegs = three_frames(tmp_path, suffix)
    data = path.read_bytes()
    assert list(mjpeg.frames(path)) == jpegs
    # frame 1 with its EOI marker zeroed
    path.write_bytes(patched(data, jpegs[1], jpegs[1][:-2] + b"\x00\x00"))
    frames = mjpeg.frames(path)
    assert frames[0] == jpegs[0] and frames[2] == jpegs[2]
    with pytest.raises(ValueError, match="frame 1 is cut short"):
        frames[1]
    with pytest.raises(ValueError, match="frame 1 is cut short"):
        tvideo.extract_frames(path, tmp_path / "out")
    if suffix == "avi":
        end2 = data.index(jpegs[2])
        path.write_bytes(data[:end2 + 100])                 # into frame 2's data
        with pytest.raises(ValueError, match="frame 2 is cut short"):
            mjpeg.frames(path)
        path.write_bytes(data[:end2 - 8])                   # before frame 2's chunk
        with pytest.raises(ValueError, match="holds 2 frames .* declares 3"):
            tvideo.probe_video(path)
    else:
        # the last sample's size in stsz made to run past the end of the file
        stsz = struct.pack(">III", len(jpegs[0]), len(jpegs[1]), len(jpegs[2]))
        path.write_bytes(patched(data, stsz, stsz[:8] + struct.pack(">I", len(data))))
        with pytest.raises(ValueError, match="frame 2 is cut short"):
            tvideo.probe_video(path)
        path.write_bytes(data[:data.index(b"moov") - 4])    # the moov box lost
        with pytest.raises(ValueError, match="no moov"):
            mjpeg.frames(path)


def test_opendml_avix_lists_are_followed(tmp_path):
    """Past 1 GB FFmpeg's AVI muxer goes on in `RIFF AVIX` lists, each with a
    `movi` list holding `ix00` index chunks: the frames there are read, the
    `JUNK` and `ix00` chunks skipped."""
    path, jpegs = three_frames(tmp_path, "avi")
    more = [encode_jpeg(smooth_image(32, 48, 3, seed=s)) for s in (3, 4)]

    def chunk(fcc, body):
        return fcc + struct.pack("<I", len(body)) + body + b"\x00" * (len(body) & 1)

    movi = b"movi" + chunk(b"ix00", bytes(24)) + b"".join(chunk(b"00dc", j) for j in more) \
        + chunk(b"JUNK", bytes(5))
    avix = b"AVIX" + chunk(b"LIST", movi) + chunk(b"JUNK", bytes(16))
    data = path.read_bytes()
    strh = data.index(b"strh") + 8
    data = data[:strh + 32] + struct.pack("<I", 5) + data[strh + 36:]   # dwLength
    path.write_bytes(data + chunk(b"RIFF", avix))
    assert list(mjpeg.frames(path)) == jpegs + more
    assert tvideo.probe_video(path)["frame_count"] == 5
    got = tvideo.extract_frames(path, tmp_path / "out", stride=2)
    np.testing.assert_array_equal(tvideo.read_image(got[-1]), mjpeg.frame_rgb(more[1]))


@pytest.mark.parametrize("channels", [3, 1], ids=["colour", "grey"])
def test_frames_without_huffman_tables_get_the_standard_ones(tmp_path, channels):
    """A Motion JPEG camera's frames omit the DHT segments (the AVI1
    convention): the reader puts in the standard tables, which gives back
    the whole file libjpeg wrote."""
    jpeg = encode_jpeg(smooth_image(32, 48, channels))
    dht = standard_dht(chroma=channels == 3)
    bare = patched(jpeg, dht, b"")
    path = mjpeg.write(tmp_path / "cam.avi", [bare, bare], 30.0, 48, 32)
    assert mjpeg.frames(path)[1] == jpeg


# ── resizing, and the reference's fixture through both pipelines ──

def test_linear_resize_is_cv2s_and_stitch_resizes(tmp_path):
    """`linear_resize` is within 1 grey level of cv2.resize's INTER_LINEAR
    (cv2 works in 11-bit fixed point); a frame of another size is resized to
    the first frame's before it is encoded, as the reference's rung does."""
    img = smooth_image(60, 80, 3)
    for h, w in ((96, 128), (45, 50), (60, 81), (17, 200)):
        want = cv2.resize(img, (w, h)).astype(int)
        assert np.abs(tvideo.linear_resize(img, h, w).astype(int) - want).max() <= 1
    tvideo.write_image(tmp_path / "src" / "00000.png", smooth_image(45, 50, 3, seed=1))
    tvideo.write_image(tmp_path / "src" / "00001.png", img)
    out = tvideo.stitch_video(tmp_path / "src", tmp_path / "mixed.mp4")
    frames = mjpeg.frames(out)
    assert frames[1] == encode_jpeg(tvideo.linear_resize(img, 45, 50), tvideo.MJPEG_QUALITY)
    assert tvideo.probe_video(out)["width"] == 50


def test_fixture_clip_through_both_pipelines(tmp_path, monkeypatch):
    """The reference's test_video_pipeline case in the port with no ffmpeg:
    12 frames of 128 x 96 stitched, probed and extracted; then both
    packages' `Pipeline.preprocess` on that one file agree on n_frames and
    the frames' shapes."""
    from omfs4d.core.config import Config as JConfig
    from omfs4d.pipeline import runner as jrunner
    from omfs4d_torch.core.config import Config
    from omfs4d_torch.models import assets as tassets
    from omfs4d_torch.pipeline import runner as trunner

    fixture_clip(tmp_path / "src")
    video = tvideo.stitch_video(tmp_path / "src", tmp_path / "in.mp4", fps=10)
    assert tvideo.probe_video(video) == {"width": 128, "height": 96, "fps": 10.0,
                                         "frame_count": 12}
    assert len(tvideo.extract_frames(video, tmp_path / "frames")) == 12

    real = tassets.synthetic_flame_asset
    monkeypatch.setattr(trunner, "synthetic_flame_asset", lambda: real(n_vertices=700, seed=0))
    monkeypatch.setattr(jrunner, "_enable_persistent_compile_cache", lambda: None)
    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))
    out = {}
    for name, pipe in (("port", trunner.Pipeline(Config(), tmp_path / "port", device="cpu")),
                       ("jax", jrunner.Pipeline(JConfig(), tmp_path / "jax"))):
        pipe.cfg.pipeline.target_size = 64
        pipe.cfg.pipeline.max_frames = 6
        stage = pipe.preprocess(video)
        images = sorted((stage / "images").glob("*.png"))
        out[name] = ([p.name for p in images], [tvideo.read_image(p).shape for p in images])
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 6 and out["port"][1][0] == (64, 85, 3)
