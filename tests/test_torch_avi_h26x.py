"""H.264 and HEVC in AVI read by the port as cv2 reads them, on the CPU, with
no ffmpeg: every frame equal to `cv2.VideoCapture`'s bit for bit, and
`probe_video` equal to cv2's.

- The committed clips as FFmpeg's AVI muxer writes x264's and x265's output
  (an Annex B byte stream a sample, the parameter sets in band at each IDR
  / IRAP picture; `tests/torch_mkv_mux.py`): x264's B-pyramid in display
  order, x265's with a mid-clip CRA and its RASL pictures.
- Every H.264 and HEVC fourcc; the extradata empty, Annex B, or an avcC /
  hvcC (then the samples are length-prefixed, as FFmpeg tells them apart).
- Restarts: AVI has neither presentation times nor a sync table the reader
  trusts, so a decode restarts only at a sample holding an IDR / IRAP
  picture and its parameter sets, read from the NAL headers, and never at a
  CRA whose RASL pictures follow; frames read at random equal a sequential
  read.
- Matroska's VfW tracks (`V_MS/VFW/FOURCC`) read their fourcc as AVI's.
- Other fourccs stay refused by name.
"""

import struct

import cv2
import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, hevc
from omfs4d_torch.io import video as tvideo
from tests import torch_h264_syntax as syn
from tests import torch_hevc_syntax as hsyn
from tests import torch_mkv_mux as mux
from tests import torch_vp8_syntax as vp8_syntax
from tests.test_torch_matroska import avcc_of, read_as_cv2
from tests.test_torch_mpeg4 import cv2_write, moving_clip


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setattr(jvideo, "find_ffmpeg", lambda: None)


def annexb(units) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + u for u in units)


def h264_aus(frames: int = 13, **features):
    w = syn.Writer(0, frames=frames, width=48, height=32, bframes=3, pyramid=True, refs=3,
                   num_ref_idx=2, restriction=True, idr_every=6, **features)
    return w.stream()


def is_params(codec: str, u: bytes) -> bool:
    return (u[0] & 0x1F in (7, 8)) if codec == "h264" else hevc.nal_type(u) in (32, 33, 34)


def is_key(codec: str, au) -> bool:
    if codec == "h264":
        return any(u[0] & 0x1F == 5 for u in au)
    return any(16 <= hevc.nal_type(u) <= 21 for u in au)


def in_band(codec: str, aus) -> list[bytes]:
    """Annex B samples, the first access unit's parameter sets before every
    IDR / IRAP picture that has none, as x264 and x265 repeat them."""
    params = [u for u in aus[0] if is_params(codec, u)]
    return [annexb(([] if any(is_params(codec, u) for u in au) or not is_key(codec, au)
                    else params) + au) for au in aus]


def random_access_as_sequential(path) -> list[int]:
    """Frames read in a random order, then backwards, equal a sequential
    read; returns the reader's restarts."""
    sequential = [tvideo._own_reader(path).rgb(i) for i in range(len(tvideo._own_reader(path)))]
    frames = tvideo._own_reader(path)
    n = len(sequential)
    for i in list(np.random.default_rng(0).permutation(n)) + list(range(n - 1, -1, -1)):
        assert np.array_equal(frames.rgb(int(i)), sequential[int(i)]), i
    return frames.starts


# ── the committed clips ─────────────────────────────────────

AVI_REMUXES = [r for r in mux.REMUXES if r[2] == "avi"]


@pytest.mark.parametrize("name, clip, kind", AVI_REMUXES, ids=[r[0] for r in AVI_REMUXES])
def test_remuxes_read_as_cv2(tmp_path, capfd, name, clip, kind):
    """clip_b.mp4 (x264's B-pyramid, 1080p) and clip_hevc.mp4 (x265's, a
    mid-clip CRA with RASL pictures) as AVI of Annex B samples: bit for bit
    as cv2 reads them, in the decoder's own output order, also when read
    out of order; the CRA is no restart."""
    path = mux.remux(clip, kind, tmp_path / name)
    info = container.index(path)[2]
    assert info["container"] == "avi" and info["annexb"] == b""
    assert info["codec"] == ("h264" if clip == "clip_b" else "hevc")
    frames = read_as_cv2(path, capfd)
    reader = tvideo._own_reader(path)
    assert reader.starts == [0]
    for i in (5, 2, 8, 0):
        assert np.array_equal(reader.rgb(i), frames[i])


# ── fourccs and extradata ───────────────────────────────────

FOURCCS = [("h264", f) for f in (b"H264", b"h264", b"X264", b"x264", b"avc1", b"AVC1", b"DAVC")] \
    + [("hevc", f) for f in (b"HEVC", b"H265", b"hev1", b"hvc1")]


@pytest.mark.parametrize("codec, fourcc", FOURCCS, ids=[f.decode() for _, f in FOURCCS])
def test_every_fourcc_reads_as_cv2(tmp_path, capfd, codec, fourcc):
    """Each H.264 and HEVC fourcc of FFmpeg's AVI demuxer: the same stream
    reads as cv2 reads it."""
    if codec == "h264":
        aus, (w, h) = h264_aus(), (48, 32)
    else:
        aus, (w, h) = hsyn.Writer(3, gop="p", idr_every=4, frames=9, width=64,
                                  height=48).stream(), (64, 48)
    path = mux.write_avi(tmp_path / "a.avi", in_band(codec, aus), [is_key(codec, a) for a in aus],
                         w, h, fourcc, fps=25)
    assert container.index(path)[2]["codec"] == codec
    read_as_cv2(path, capfd)


EXTRADATA = ["annexb", "config"]


@pytest.mark.parametrize("codec", ["h264", "hevc"])
@pytest.mark.parametrize("extradata", EXTRADATA)
def test_extradata_forms_read_as_cv2(tmp_path, capfd, codec, extradata):
    """The parameter sets only in the extradata: as an Annex B stream (x264
    with global headers; the samples Annex B) or as an avcC / hvcC (a remux
    from MP4 without the Annex B filter; the samples length-prefixed): the
    frames are cv2's, and a decode restarts at each IDR / IRAP picture."""
    if codec == "h264":
        aus, (w, h), fourcc = h264_aus(), (48, 32), b"H264"
    else:
        aus, (w, h), fourcc = hsyn.Writer(3, gop="p", idr_every=4, frames=9, width=64,
                                          height=48).stream(), (64, 48), b"HEVC"
    params = [u for u in aus[0] if is_params(codec, u)]
    rest = [[u for u in au if not is_params(codec, u)] for au in aus]
    if extradata == "annexb":
        samples, extra = [annexb(au) for au in rest], annexb(params)
    else:
        samples = [b"".join(struct.pack(">I", len(u)) + u for u in au) for au in rest]
        extra = avcc_of(aus) if codec == "h264" else hsyn.hvcc(params, False)[8:]
    key = [is_key(codec, a) for a in aus]
    path = mux.write_avi(tmp_path / "x.avi", samples, key, w, h, fourcc, fps=25, extradata=extra)
    info = container.index(path)[2]
    assert ("annexb" in info) == (extradata == "annexb")
    read_as_cv2(path, capfd)
    assert random_access_as_sequential(path) == [i for i, k in enumerate(key) if k]


# ── restarts ────────────────────────────────────────────────

def test_h264_restarts_only_at_idr_with_parameter_sets(tmp_path, capfd):
    """x264's layout (the parameter sets before every IDR): each IDR is a
    restart; with the sets only before the first one and no extradata, only
    the first is (a decode starting later would have none), and every frame
    read at random is still the sequential one, cv2's."""
    aus = h264_aus(13)
    key = [is_key("h264", a) for a in aus]
    assert [i for i, k in enumerate(key) if k] == [0, 6, 12]
    path = mux.write_avi(tmp_path / "r.avi", in_band("h264", aus), key, 48, 32, b"H264")
    read_as_cv2(path, capfd)
    assert random_access_as_sequential(path) == [0, 6, 12]
    params = [u for u in aus[0] if is_params("h264", u)]
    once = [annexb((params if i == 0 else []) + [u for u in au if not is_params("h264", u)])
            for i, au in enumerate(aus)]
    path = mux.write_avi(tmp_path / "once.avi", once, key, 48, 32, b"H264")
    read_as_cv2(path, capfd)
    assert random_access_as_sequential(path) == [0]


HEVC_GOPS = {"cra-rasl": (dict(gop="pyramid", cra=True, frames=13), [0]),
             "bla": (dict(gop="pyramid", cra="bla", frames=13), [0, 5]),
             "cra-no-leading": (dict(gop="intra", frames=7), [0, 2, 5]),
             "idr": (dict(gop="p", idr_every=4, frames=9), [0, 4, 8])}


@pytest.mark.parametrize("gop", list(HEVC_GOPS))
def test_hevc_restarts_at_clean_irap_pictures(tmp_path, capfd, gop):
    """HEVC in AVI restarts at an IDR, a BLA (its RASL pictures are dropped
    in any decode) and a CRA with no RASL picture after it, but not at a
    mid-stream CRA whose RASL pictures a decode started there would drop:
    the frames are cv2's and read at random as in order."""
    features, starts = HEVC_GOPS[gop]
    aus = hsyn.Writer(4, width=48, height=32, **features).stream()
    key = [is_key("hevc", a) for a in aus]
    path = mux.write_avi(tmp_path / "h.avi", in_band("hevc", aus), key, 48, 32, b"HEVC")
    read_as_cv2(path, capfd)
    got = random_access_as_sequential(path)
    if gop == "cra-no-leading":
        starts = [i for i, k in enumerate(key) if k]
        assert len(starts) > 1
    assert got == starts


# ── Matroska's VfW tracks ───────────────────────────────────

def test_matroska_vfw_tracks_read_as_avi(tmp_path, capfd):
    """A `V_MS/VFW/FOURCC` track (mkvmerge's and FFmpeg's for a codec with no
    Matroska ID): its BITMAPINFOHEADER's fourcc is read as AVI's, an H.264
    `H264` track of Annex B samples and an `XVID` one read as cv2 reads
    them, and a `VP80` one (VP8) too."""
    aus = h264_aus(13)
    key = [is_key("h264", a) for a in aus]

    def bih(fourcc, w, h, extra=b""):
        return struct.pack("<IiiHH4sIiiII", 40 + len(extra), w, h, 1, 24, fourcc, 0, 0, 0, 0,
                           0) + extra

    path = mux.write_mkv(tmp_path / "vfw.mkv", in_band("h264", aus), key,
                         [40 * i for i in range(13)], codec_id="V_MS/VFW/FOURCC",
                         private=bih(b"H264", 48, 32), width=48, height=32,
                         default_duration=40_000_000, duration_ms=520.0)
    info = container.index(path)[2]
    assert info["codec"] == "h264" and "times" not in info
    read_as_cv2(path, capfd)
    assert random_access_as_sequential(path) == [0, 6, 12]
    src = tmp_path / "x.avi"
    cv2_write(src, "XVID", moving_clip(6, 32, 48))
    offsets, sizes, xinfo = container.index(src)
    raw = src.read_bytes()
    path = mux.write_mkv(tmp_path / "xvid.mkv", [raw[o:o + s] for o, s in zip(offsets, sizes)],
                         [True] + [False] * 5, [40 * i for i in range(6)],
                         codec_id="V_MS/VFW/FOURCC", private=bih(b"XVID", 48, 32, xinfo["dsi"]),
                         width=48, height=32, default_duration=40_000_000, duration_ms=240.0)
    assert container.index(path)[2]["codec"] == "mpeg4"
    read_as_cv2(path, capfd)
    _, frames = vp8_syntax.write_stream(0, frames=4, key_frames=(0,), width=48, height=32)
    path = mux.write_mkv(tmp_path / "vp8.mkv", frames, [vp8_syntax.is_key(f) for f in frames],
                         [40 * i for i in range(4)], codec_id="V_MS/VFW/FOURCC",
                         private=bih(b"VP80", 48, 32), width=48, height=32,
                         default_duration=40_000_000, duration_ms=160.0)
    assert container.index(path)[2]["codec"] == "vp8"
    read_as_cv2(path, capfd)


# ── what stays refused ──────────────────────────────────────

@pytest.mark.parametrize("fourcc, name", [(b"AV01", "AV1"), (b"MPG4", "MS MPEG-4 v1"),
                                          (b"WMV3", "WMV 9"), (b"ABCD", "'ABCD'")])
def test_other_fourccs_refused_by_name(tmp_path, fourcc, name):
    """A fourcc outside the port's codecs raises UnsupportedCodecError naming
    the codec (or the fourcc) and ffmpeg."""
    path = mux.write_avi(tmp_path / "o.avi", [b"\x00" * 16], [True], 48, 32, fourcc)
    with pytest.raises(container.UnsupportedCodecError, match="ffmpeg") as err:
        tvideo.probe_video(path)
    assert name in str(err.value)


def test_cut_sample_raises_with_its_index(tmp_path):
    """An AVI whose last H.264 sample is cut short raises ValueError naming
    the frame, as the AVI reader does for every codec."""
    aus = h264_aus(7)
    path = mux.write_avi(tmp_path / "c.avi", in_band("h264", aus),
                         [is_key("h264", a) for a in aus], 48, 32, b"H264")
    raw = path.read_bytes()
    movi_end = raw.index(b"idx1")
    path.write_bytes(raw[:movi_end - 4])
    with pytest.raises(ValueError, match="frame 6 is cut short"):
        container.index(path)
    assert cv2.VideoCapture(str(path)).isOpened()
