"""Matroska / WebM read by the port (`omfs4d_torch.io.matroska`) as cv2 reads
it, on the CPU, with no ffmpeg: every frame equal to `cv2.VideoCapture`'s bit
for bit, and `probe_video` equal to cv2's width, height, fps and frame count.

- cv2's own `.mkv` writers (`mp4v`, `XVID`, `FMP4`, `DIVX`, `MJPG`), odd
  sizes among them.
- The remuxes of the committed H.264, HEVC and MPEG-4 clips
  (`tests/torch_mkv_mux.py`), x264's B-pyramid clip in display order, its
  restarts reached by random access.
- Each variant of the muxer: the three lacings, Segment and Cluster sizes
  unknown, BlockGroups, no DefaultDuration (FFmpeg's estimate of the rate at
  several rates), no Duration (cv2's frame count then), a second track
  before or after the video one, header stripping, `Colour` tags against
  the VUI's, WebM's DocType.
- Files cut at several byte positions: the frames cv2 reads, its count, and
  a ValueError where cv2 cannot open the file.
- cv2's MPEG-2 and FFV1 in `.mkv` read as cv2 reads them; AV1 and the rest
  refused by name (VP8, VP9, MPEG-1 / 2 and FFV1 are read:
  `tests/test_torch_vp8.py`, `tests/test_torch_vp9.py`,
  `tests/test_torch_mpeg2.py`, `tests/test_torch_ffv1.py`).
- The JAX package's `stitch_video` into `.mkv` with no ffmpeg, read by both
  packages to the same probe and frames.
- The committed corpus (`tests/data/matroska/`) against its manifest.
"""

import hashlib
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, hevc, matroska
from omfs4d_torch.io import video as tvideo
from tests import torch_h264_syntax as syn
from tests import torch_hevc_syntax as hsyn
from tests import torch_mkv_mux as mux
from tests.test_torch_mpeg4 import cv2_write, moving_clip

CORPUS = Path(__file__).resolve().parent / "data" / "matroska"


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setattr(jvideo, "find_ffmpeg", lambda: None)


def cv2_read(path) -> tuple[dict, list[np.ndarray]]:
    """cv2's probe (as the JAX package's `probe_video` reports it) and its
    frames, RGB."""
    probe = jvideo.probe_video(path)
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(frame[..., ::-1]))
    cap.release()
    return probe, frames


def read_as_cv2(path, capfd=None) -> list[np.ndarray]:
    """The port's probe and frames equal cv2's, bit for bit; returns the
    frames."""
    probe, theirs = cv2_read(path)
    if capfd is not None:
        capfd.readouterr()
    reader = tvideo._own_reader(Path(path))
    ours = [reader.rgb(i) for i in range(len(reader))]
    assert tvideo.probe_video(path) == probe
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == b.shape and np.array_equal(a, b), f"{path}: frame {i}"
    return ours


def avcc_of(aus) -> bytes:
    sps = next(u for au in aus for u in au if u[0] & 0x1F == 7)
    pps = next(u for au in aus for u in au if u[0] & 0x1F == 8)
    return (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]) + struct.pack(">H", len(sps)) + sps
            + bytes([1]) + struct.pack(">H", len(pps)) + pps)


def h264_track(frames: int = 8, **features) -> dict:
    """A B-pyramid H.264 stream as a Matroska track: length-prefixed frames
    in decoding order, key flags, presentation times at 25 fps, avcC."""
    w = syn.Writer(0, frames=frames, width=48, height=32, bframes=3, pyramid=True, refs=3,
                   num_ref_idx=2, restriction=True, **features)
    aus = w.stream()
    return {"frames": [b"".join(struct.pack(">I", len(u)) + u for u in au
                                if u[0] & 0x1F not in (7, 8)) for au in aus],
            "key": [any(u[0] & 0x1F == 5 for u in au) for au in aus],
            "times_ms": [40 * d for d in w.display], "codec_id": "V_MPEG4/ISO/AVC",
            "private": avcc_of(aus), "width": 48, "height": 32}


def hevc_track(frames: int = 8, **features) -> dict:
    w = hsyn.Writer(3, frames=frames, width=64, height=48, **features)
    aus = w.stream()
    params = [u for u in aus[0] if hevc.nal_type(u) in (32, 33, 34)]
    return {"frames": [b"".join(struct.pack(">I", len(u)) + u for u in au
                                if hevc.nal_type(u) not in (32, 33, 34)) for au in aus],
            "key": [any(16 <= hevc.nal_type(u) <= 21 for u in au) for au in aus],
            "times_ms": [40 * d for d in getattr(w, "display", range(frames))],
            "codec_id": "V_MPEGH/ISO/HEVC", "private": hsyn.hvcc(params, False)[8:],
            "width": 64, "height": 48}


def cv2_track(tmp_path, fourcc: str, n: int = 10, w: int = 64, h: int = 48) -> dict:
    """cv2's own `.mkv` of `fourcc`, its frames taken back out as a track."""
    path = tmp_path / f"src_{fourcc}.mkv"
    cv2_write(path, fourcc, moving_clip(n, h, w))
    offsets, sizes, info = container.index(path)
    raw = path.read_bytes()
    return {"frames": [raw[o:o + s] for o, s in zip(offsets, sizes)],
            "key": [i in (info["sync"] or range(n)) for i in range(n)],
            "times_ms": [40 * i for i in range(n)],
            "codec_id": "V_MJPEG" if fourcc == "MJPG" else "V_MPEG4/ISO/ASP",
            "private": info.get("dsi", b""), "width": w, "height": h}


def write(path, track: dict, **options) -> Path:
    t = dict(track)
    options.setdefault("default_duration", 40_000_000)
    options.setdefault("duration_ms", 40.0 * len(t["frames"]))
    return mux.write_mkv(path, t.pop("frames"), t.pop("key"), t.pop("times_ms"), **t, **options)


# ── cv2's own writers ───────────────────────────────────────

CV2_FILES = [(fourcc, size) for fourcc in ("mp4v", "XVID", "FMP4", "DIVX", "MJPG")
             for size in ((64, 48), (50, 38), (33, 17))]


@pytest.mark.parametrize("fourcc, size", CV2_FILES,
                         ids=[f"{f}-{w}x{h}" for f, (w, h) in CV2_FILES])
def test_cv2_mkv_writers_read_as_cv2(tmp_path, capfd, fourcc, size):
    """cv2's Matroska writers (FFmpeg's matroska muxer: SimpleBlocks, a
    Cluster at each key frame, DefaultDuration, Duration, Cues, Tags):
    probe_video and every frame as cv2 gives them."""
    path = tmp_path / "clip.mkv"
    cv2_write(path, fourcc, moving_clip(14, size[1], size[0]))
    info = container.index(path)[2]
    assert info["container"] == "matroska"
    assert info["codec"] == ("mjpeg" if fourcc == "MJPG" else "mpeg4")
    assert len(read_as_cv2(path, capfd)) == 14


# ── the remuxes of the committed clips ──────────────────────

MKV_REMUXES = [r for r in mux.REMUXES if r[2] == "mkv"]


@pytest.mark.parametrize("name, clip, kind", MKV_REMUXES, ids=[r[0] for r in MKV_REMUXES])
def test_remuxes_read_as_cv2(tmp_path, capfd, name, clip, kind):
    """The committed clips remuxed into Matroska as FFmpeg's muxer writes
    them (x264's B-pyramid clip_b, the phone clip clip.mov, x265's
    clip_hevc with its mid-clip CRA and RASL pictures, Main 10, cv2's mp4v):
    bit for bit as cv2 reads them, in display order, clip_b's frames also
    when read out of order."""
    path = mux.remux(clip, kind, tmp_path / name)
    info = container.index(path)[2]
    assert info["container"] == "matroska" and info.get("times")
    frames = read_as_cv2(path, capfd)
    if clip == "clip_b":                    # reached at random, the display order holds
        assert info["times"] != sorted(info["times"])
        reader = tvideo._own_reader(path)
        for i in (5, 2, 8, 0):
            assert np.array_equal(reader.rgb(i), frames[i])


def test_b_pyramid_restarts_by_random_access(tmp_path):
    """A B-pyramid stream with an IDR every 6 frames, in BlockGroups, read in
    a random order, then backwards, gives the frames of a sequential read:
    the blocks' presentation times pick the restarts, as `ctts` does in
    MP4."""
    track = h264_track(13, idr_every=6)
    path = write(tmp_path / "b.mkv", track, block_group=True)
    frames = tvideo._own_reader(path)
    assert frames.info["times"] != sorted(frames.info["times"])
    assert frames.starts == [0, 6, 12]
    sequential = [frames.rgb(i) for i in range(13)]
    frames = tvideo._own_reader(path)
    order = list(np.random.default_rng(0).permutation(13)) + list(range(12, -1, -1))
    for i in order:
        assert np.array_equal(frames.rgb(int(i)), sequential[int(i)])


# ── the muxer's variants ────────────────────────────────────

VARIANTS = {
    "h264-simple": ("h264", {}),
    "h264-blockgroup": ("h264", {"block_group": True}),
    "h264-unknown-sizes": ("h264", {"unknown_segment": True, "unknown_cluster": True}),
    "h264-audio-before": ("h264", {"audio": "before"}),
    "h264-no-cues": ("h264", {"cues": False}),
    "hevc-audio-after": ("hevc", {"audio": "after"}),
    "mjpeg-xiph": ("MJPG", {"lacing": "xiph"}),
    "mjpeg-ebml": ("MJPG", {"lacing": "ebml", "lace_size": 4}),
    "mjpeg-fixed": ("MJPG", {"lacing": "fixed"}),
    "mjpeg-strip": ("MJPG", {"strip": b"\xff\xd8"}),
    "mjpeg-webm": ("MJPG", {"doc_type": "webm"}),
    "mpeg4-strip": ("mp4v", {"strip": b"\x00\x00\x01"}),
    "mpeg4-ebml-blockgroup": ("mp4v", {"lacing": "ebml", "block_group": True}),
    "mpeg4-unknown-cluster": ("mp4v", {"unknown_cluster": True, "audio": "after"}),
    # PixelCrop (top, bottom, left, right) and DisplayWidth / Height, which
    # cv2 leaves alone
    "h264-crop-display": ("h264", {"video_extra": b"".join(
        mux.uint(eid, v) for eid, v in ((0x54BB, 2), (0x54AA, 4), (0x54CC, 6), (0x54DD, 8),
                                       (0x54B0, 96), (0x54BA, 32)))}),
    "mjpeg-crop-display": ("MJPG", {"video_extra": b"".join(
        mux.uint(eid, v) for eid, v in ((0x54AA, 6), (0x54DD, 10), (0x54B0, 64),
                                       (0x54BA, 96)))}),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_muxer_variants_read_as_cv2(tmp_path, capfd, variant):
    """Each layout the reader must follow, against cv2: lacing (a lace's
    frames each their own range of the file, equal sizes padded past a
    JPEG's EOI for fixed lacing), sizes of all ones, BlockGroups with
    ReferenceBlocks, a sound track's blocks skipped by number, header
    stripping (`info["prefix"]` put back before every frame), WebM; and
    PixelCrop and DisplayWidth / Height, which cv2 does not apply."""
    source, options = VARIANTS[variant]
    if source == "h264":
        track = h264_track()
    elif source == "hevc":
        track = hevc_track(gop="pyramid")
    else:
        track = cv2_track(tmp_path, source)
    if options.get("lacing") == "fixed":
        longest = max(map(len, track["frames"]))
        track["frames"] = [f + bytes(longest - len(f)) for f in track["frames"]]
    if options.get("lacing"):
        track["key"] = [True] + [False] * (len(track["frames"]) - 1)
    path = write(tmp_path / "v.mkv", track, **options)
    offsets, sizes, info = container.index(path)
    if "strip" in options:
        assert info["prefix"] == options["strip"]
    if options.get("lacing"):
        assert len(offsets) == len(track["frames"])
    read_as_cv2(path, capfd)


RATES = [(25, 10), (30, 10), (30000 / 1001, 30), (24, 12), (60, 3), (120, 10), (7.5, 10),
         (100, 10), (30, 2)]


@pytest.mark.parametrize("rate, n", RATES, ids=[f"{r:.3f}-{n}" for r, n in RATES])
def test_no_default_duration_rate_as_cv2(tmp_path, rate, n):
    """With no DefaultDuration, cv2's fps is FFmpeg's estimate from the
    frames' millisecond times (snapped to a standard rate, else 1000) for
    Motion JPEG and for H.264 with no VUI timing, and comes from the VUI's
    timing or the VOL's rate for the others; the count follows from the
    Duration."""
    mj = cv2_track(tmp_path, "MJPG", 10)
    times = [round(i * 1000 / rate) for i in range(n)]
    duration = n * 1000 / rate
    cases = {"mjpeg": mux.write_mkv(tmp_path / "mj.mkv", (mj["frames"] * 3)[:n], [True] * n,
                                    times, codec_id="V_MJPEG", width=64, height=48,
                                    duration_ms=duration)}
    h = h264_track(n, fps=30)
    cases["h264-vui30"] = mux.write_mkv(tmp_path / "h.mkv", h["frames"], h["key"],
                                        [round(t / 40 * 1000 / rate) for t in h["times_ms"]],
                                        codec_id=h["codec_id"], private=h["private"], width=48,
                                        height=32, duration_ms=duration)
    for name, path in cases.items():
        assert container.index(path)[2]["fps"] > 0
        probe = jvideo.probe_video(path)
        assert tvideo.probe_video(path) == probe, name


def test_no_duration_counts_as_cv2(tmp_path):
    """With no Duration (a recording stopped by a crash), OpenCV's count
    comes from the stream's duration, which FFmpeg leaves unset: the same
    negative number as cv2's; the frames are still all read."""
    track = cv2_track(tmp_path, "MJPG")
    path = write(tmp_path / "nd.mkv", track, duration_ms=None, cues=False)
    probe = jvideo.probe_video(path)
    assert probe["frame_count"] < 0
    assert tvideo.probe_video(path) == probe
    assert len(read_as_cv2(path)) == 10


COLOURS = [("h264", None, {"matrix": 1, "range": 2, "primaries": 1, "transfer": 1}),
           ("h264", None, {"matrix": 6, "range": 1}), ("h264", None, {"range": 2}),
           ("h264", (0, 1), {"matrix": 6, "range": 2, "primaries": 5, "transfer": 6}),
           ("hevc", None, {"matrix": 1, "range": 2, "primaries": 1, "transfer": 1}),
           ("hevc", (0, 1), {"matrix": 6, "range": 2})]


@pytest.mark.parametrize("codec, vui, tags", COLOURS,
                         ids=[f"{c}-vui{v}-{'-'.join(map(str, t.values()))}"
                              for c, v, t in COLOURS])
def test_colour_tags_weighed_as_cv2(tmp_path, capfd, codec, vui, tags):
    """`Colour`'s matrix, range, primaries and transfer become
    `info["colr"]`: H.264 takes them where its VUI has none, HEVC never, as
    FFmpeg's decoders do with an MP4 `colr` box; the frames are cv2's."""
    track = h264_track(4, colour=vui) if codec == "h264" else hevc_track(4, colour=vui)
    path = write(tmp_path / "c.mkv", track, colour=tags)
    colr = container.index(path)[2]["colr"]
    assert colr == (tags.get("primaries", 2), tags.get("transfer", 2), tags.get("matrix", 2),
                    tags.get("range") == 2)
    read_as_cv2(path, capfd)


@pytest.mark.parametrize("clip", ["clip_mov", "clip_hevc10"])
def test_remux_colour_tags_that_disagree_with_the_vui(tmp_path, capfd, clip):
    """clip.mov (H.264) and clip_hevc10.mp4 (HEVC Main 10), both BT.709 in
    limited range in their VUI, remuxed with `Colour` tags of BT.601 in full
    range: the VUI wins for both, as in cv2, bit for bit."""
    tags = {"matrix": 6, "range": 2, "primaries": 5, "transfer": 6}
    path = mux.remux(clip, "mkv", tmp_path / f"{clip}.mkv", colour=tags)
    assert container.index(path)[2]["colr"] == (5, 6, 6, True)
    read_as_cv2(path, capfd)


def test_mastering_luminance_and_reserved_tags(tmp_path):
    """MasteringMetadata's luminance becomes `info["mdcv"]` (min, max) as an
    MP4 `mdcv` box does; reserved values are left unspecified (2), as
    `matroskadec` leaves them."""
    track = h264_track(2)
    path = write(tmp_path / "m.mkv", track, colour={"matrix": 3, "primaries": 0,
                                                   "transfer": 16, "mastering": (0.005, 1000.0)})
    info = container.index(path)[2]
    assert info["colr"] == (2, 16, 2, False) and info["mdcv"] == (0.005, 1000.0)


PROJECTIONS = [(source, roll, yaw) for source in ("h264", "MJPG", "mp4v")
               for roll, yaw in ((90.0, 0.0), (-90.0, 0.0), (180.0, 180.0), (45.0, 0.0))]


@pytest.mark.parametrize("source, roll, yaw", PROJECTIONS,
                         ids=[f"{s}-roll{r:g}-yaw{y:g}" for s, r, y in PROJECTIONS])
def test_projection_turns_frames_as_cv2(tmp_path, capfd, source, roll, yaw):
    """A rectangular `Projection`'s roll (a yaw of 180 flipping it) turns
    the frames as cv2 turns them, for every codec, and the probe's size
    with them; a turn that is no quarter turn leaves them as they are."""
    track = h264_track(4) if source == "h264" else cv2_track(tmp_path, source, 4)
    proj = mux.el(matroska.PROJECTION, mux.uint(matroska.PROJECTION_TYPE, 0)
                  + mux.flt(matroska.POSE_YAW, yaw) + mux.flt(matroska.POSE_ROLL, roll))
    path = write(tmp_path / "p.mkv", track, video_extra=proj)
    frames = read_as_cv2(path, capfd)
    turned = container.index(path)[2].get("rotation", 0)
    assert turned == {90.0: 270, -90.0: 90, 180.0: 0, 45.0: 0}[roll]
    assert frames[0].shape[:2] == ((track["width"], track["height"]) if turned in (90, 270)
                                   else (track["height"], track["width"]))


# ── files cut short ─────────────────────────────────────────

@pytest.mark.parametrize("source", ["mp4v", "MJPG", "h264"])
def test_cut_files_read_as_cv2(tmp_path, capfd, source):
    """A file cut at several byte positions (a recording stopped by a
    crash: the last Cluster open, no Cues): the port reads the frames cv2
    reads (a block cut inside its bytes dropped) with cv2's probe, and
    raises ValueError where cv2 cannot open the file (cut before its first
    Cluster)."""
    if source == "h264":
        whole = write(tmp_path / "whole.mkv", h264_track(10))
    else:
        whole = tmp_path / "whole.mkv"
        cv2_write(whole, source, moving_clip(10, 48, 64))
    raw = whole.read_bytes()
    opened = 0
    for frac in (0.02, 0.05, 0.2, 0.45, 0.7, 0.9, 0.99):
        path = tmp_path / f"cut_{frac}.mkv"
        path.write_bytes(raw[:int(len(raw) * frac)])
        probe, theirs = cv2_read(path)
        capfd.readouterr()
        if probe["width"] <= 0:
            with pytest.raises(ValueError):
                tvideo.probe_video(path)
            continue
        opened += 1
        read_as_cv2(path)
    assert opened >= 4


# ── what stays refused ──────────────────────────────────────

@pytest.mark.parametrize("fourcc, suffix, name", [("MPG2", "mkv", "MPEG-2 video"),
                                                   ("FFV1", "mkv", "FFV1")])
def test_cv2_mpeg2_ffv1_refused_by_name(tmp_path, capfd, fourcc, suffix, name):
    """cv2's MPEG-2 and FFV1 writers into Matroska, which cv2 reads back:
    MPEG-2 (V_MPEG2) and FFV1 (V_FFV1), once refused here, are read as cv2
    reads them (their frames and count; `tests/test_torch_mpeg2.py` and
    `tests/test_torch_ffv1.py` hold the rest; VP9, once refused here too, is
    read: `tests/test_torch_vp9.py`)."""
    path = tmp_path / f"clip.{suffix}"
    cv2_write(path, fourcc, moving_clip(4, 32, 48))
    capfd.readouterr()
    assert jvideo.probe_video(path)["width"] == 48
    assert container.index(path)[2]["codec"] == {"MPG2": "mpeg2", "FFV1": "ffv1"}[fourcc]
    assert len(read_as_cv2(path, capfd)) == 4


REFUSED = {"V_AV1": "AV1", "V_REAL/RV40": "RealVideo 4", "V_THEORA": "Theora",
           "V_PRORES": "ProRes", "V_SOMETHING": "an unknown codec"}


@pytest.mark.parametrize("codec_id", list(REFUSED))
def test_other_codec_ids_refused_by_name(tmp_path, codec_id):
    """Every other CodecID raises UnsupportedCodecError naming the codec
    and the CodecID."""
    track = dict(h264_track(2), codec_id=codec_id)
    path = write(tmp_path / "x.mkv", track)
    with pytest.raises(container.UnsupportedCodecError, match="ffmpeg") as err:
        tvideo.probe_video(path)
    assert REFUSED[codec_id] in str(err.value) and codec_id in str(err.value)


def test_compression_and_encryption_refused_by_name(tmp_path):
    """zlib, bzlib and LZO content compression and encryption raise naming
    what they are; so do two encodings combined."""
    def encoding(body: bytes) -> bytes:
        return mux.el(matroska.CONTENT_ENCODING, body)

    cases = {"zlib": encoding(mux.el(matroska.COMPRESSION, mux.uint(matroska.COMP_ALGO, 0))),
             "bzlib": encoding(mux.el(matroska.COMPRESSION, mux.uint(matroska.COMP_ALGO, 1))),
             "LZO": encoding(mux.el(matroska.COMPRESSION, mux.uint(matroska.COMP_ALGO, 2))),
             "encrypted": encoding(mux.uint(matroska.ENCODING_TYPE, 1)),
             "combined": encoding(b"") * 2}
    for name, body in cases.items():
        path = write(tmp_path / f"{name}.mkv", h264_track(2),
                     entry_extra=mux.el(matroska.CONTENT_ENCODINGS, body))
        with pytest.raises(container.UnsupportedCodecError, match=name):
            tvideo.probe_video(path)


# ── the JAX package's own output ────────────────────────────

def test_jax_stitch_video_mkv_reads_as_in_the_jax_package(tmp_path, capfd):
    """The JAX package's `stitch_video` to a `.mkv` with no ffmpeg (cv2's
    ladder falls to `mp4v`, muxed by FFmpeg into Matroska): the port's
    probe_video equals the JAX package's and its extract_frames PNGs decode
    to the JAX package's arrays."""
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(moving_clip(6, 64, 96, seed=3)):
        cv2.imwrite(str(frames_dir / f"{i:05d}.png"), f)
    path = jvideo.stitch_video(frames_dir, tmp_path / "pred.mkv", fps=30)
    capfd.readouterr()
    info = container.index(path)[2]
    assert info["container"] == "matroska" and info["codec"] == "mpeg4"
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    ours = tvideo.extract_frames(path, tmp_path / "ours")
    theirs = jvideo.extract_frames(path, tmp_path / "theirs")
    capfd.readouterr()
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert np.array_equal(tvideo.read_image(a), tvideo.read_image(b))


# ── the committed corpus ────────────────────────────────────

def test_corpus_reads_to_its_manifest(tmp_path):
    """`tests/data/matroska/` (under 1 MiB): cv2's files have their
    manifest's SHA-256 and read to its probe and frame hashes; every remux
    the muxer makes from the committed clips has its manifest's bytes (the
    muxer is deterministic), and the manifest's frames are cv2's."""
    manifest = json.loads((CORPUS / "manifest.json").read_text())
    assert sum(p.stat().st_size for p in CORPUS.iterdir()) <= 1024 * 1024
    for name, entry in manifest["files"].items():
        path = CORPUS / name
        assert hashlib.sha256(path.read_bytes()).hexdigest() == entry["file_sha256"], name
        reader = tvideo._own_reader(path)
        assert tvideo.probe_video(path) == entry["probe"]
        assert [hashlib.sha256(reader.rgb(i).tobytes()).hexdigest()
                for i in range(len(reader))] == entry["sha256"], name
    assert {r[0] for r in mux.REMUXES} == set(manifest["remuxes"])
    for name, clip, kind in mux.REMUXES:
        data = mux.remux(clip, kind, tmp_path / name).read_bytes()
        entry = manifest["remuxes"][name]
        assert len(data) == entry["bytes"] and \
            hashlib.sha256(data).hexdigest() == entry["file_sha256"], name
        if name == "clip_mp4v.mkv":              # cv2's frames of one remux, as committed
            probe, frames = cv2_read(tmp_path / name)
            assert probe == entry["probe"]
            assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] == entry["sha256"]
