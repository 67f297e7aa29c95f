"""VP8 read by the port as cv2 reads it, on the CPU, with no ffmpeg: every
frame equal to `cv2.VideoCapture`'s bit for bit (0 levels), and
`probe_video` equal to cv2's (width, height, fps, CAP_PROP_FRAME_COUNT).

- The committed corpus (`tests/data/vp8/`, `tests/make_vp8_corpus.py`):
  cv2's own `VP80` clips in WebM, Matroska (asked for at an odd size; cv2's
  writer rounds it to even) and AVI, and a 1080p one; the tests' writer's
  streams (`tests/torch_vp8_syntax.py`) re-made from their seeds, byte for
  byte, in WebM, Matroska and AVI, a browser's recording layout among them
  (no DefaultDuration, no Duration).  Each to its manifest and to cv2.
- Random streams from the writer against cv2: versions 0-3, the simple
  filter, segmentation, deltas, partitions, references, every update,
  SPLITMV, B_PRED, far vectors, extreme quantisers, hidden frames, odd
  sizes, in WebM, Matroska and AVI.
- What FFmpeg does, followed: a stream cut mid-GOP (cv2 reads nothing), a
  frame whose partitions run past its packet (cv2 stops there), an empty
  block, a 0-byte AVI chunk, the scale bits, BlockGroups with
  BlockAdditions (an alpha channel: cv2 shows the colour frame), hidden
  frames.  Refused by name: a key frame that changes the size, the
  clamping_type bit (cv2's colours then depend on its frame threads).
- The port's `extract_frames` against the JAX package's on a WebM: 0
  levels (no resize).
- The tables are libavcodec's and libvpx's bytes (where opencv-python
  bundles them).
- A fuzz in a child process: truncated and garbled frames decode or raise
  ValueError, and never crash.
- VP9 profile 2, AV1 and `vp08` in MP4 (which cv2 cannot write) stay
  refused.
"""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, vp8, vp8_tables
from omfs4d_torch.io import video as tvideo
from tests import torch_mkv_mux as mux
from tests import torch_vp8_syntax as syn
from tests.make_vp8_corpus import make_stream
from tests.test_torch_matroska import read_as_cv2
from tests.test_torch_mpeg4 import libavcodec

CORPUS = Path(__file__).resolve().parent / "data" / "vp8"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())
# FFmpeg's numbering of the sub-block modes (h264pred's) by the RFC's
FFMPEG_BMODES = (2, 9, 0, 1, 3, 4, 5, 7, 6, 8)


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setattr(jvideo, "find_ffmpeg", lambda: None)


def hashes(path) -> list[str]:
    frames = tvideo._own_reader(Path(path))
    return [hashlib.sha256(frames.rgb(i).tobytes()).hexdigest() for i in range(len(frames))]


def stream(seed: int, n: int = 6, keys=(0,), hidden=(), **features):
    w, frames = syn.write_stream(seed, frames=n, key_frames=keys, hidden=hidden, **features)
    return w, frames


# ── the corpus ──────────────────────────────────────────────

@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_corpus_files_read_as_cv2(capfd, name):
    """cv2's own VP80 clips: the file's SHA-256, cv2's probe and frames, to
    the manifest and to cv2 here."""
    entry, path = MANIFEST["files"][name], CORPUS / name
    assert hashlib.sha256(path.read_bytes()).hexdigest() == entry["file_sha256"]
    assert tvideo.probe_video(path) == entry["probe"]
    assert hashes(path) == entry["sha256"]
    read_as_cv2(path, capfd)


@pytest.mark.parametrize("name", sorted(MANIFEST["streams"]))
def test_writer_streams_read_as_cv2(tmp_path, capfd, name):
    """The writer's streams re-made from their seeds, byte for byte, read to
    the manifest's probe and frames and to cv2's here."""
    entry = MANIFEST["streams"][name]
    path = make_stream(name, tmp_path)
    assert hashlib.sha256(path.read_bytes()).hexdigest() == entry["file_sha256"]
    assert tvideo.probe_video(path) == entry["probe"]
    assert hashes(path) == entry["sha256"]
    read_as_cv2(path, capfd)


# ── random streams ──────────────────────────────────────────

RANDOM = [  # (seed, frames, key frames, hidden, features, container)
    (11, 6, (0,), (), {"width": 48, "height": 32, "version": 0}, "webm"),
    (12, 7, (0, 4), (2,), {"width": 35, "height": 21, "version": 1}, "mkv"),
    (13, 6, (0,), (3,), {"width": 57, "height": 43, "version": 2}, "avi"),
    (14, 6, (0, 3), (), {"width": 81, "height": 17, "version": 3}, "webm"),
    (15, 5, (0,), (), {"width": 64, "height": 48, "simple": True, "partitions": (3,)}, "webm"),
    (16, 5, (0,), (), {"width": 50, "height": 30, "q_range": (0, 0), "q_deltas": 15}, "mkv"),
    (17, 5, (0,), (), {"width": 50, "height": 30, "q_range": (127, 127)}, "webm"),
    (18, 8, (0, 6), (1, 5), {"width": 9, "height": 13, "far": True, "density": 0.8}, "avi"),
    (19, 6, (0,), (), {"width": 96, "height": 80, "segmentation": True, "updates": True,
                       "filter_range": (40, 63)}, "webm"),
    (20, 6, (0,), (), {"width": 40, "height": 40, "skip": False, "density": 0.2}, "mkv"),
]


@pytest.mark.parametrize("seed, n, keys, hidden, features, kind", RANDOM,
                         ids=[f"seed{r[0]}-{r[5]}" for r in RANDOM])
def test_random_streams_read_as_cv2(tmp_path, capfd, seed, n, keys, hidden, features, kind):
    """Random legal syntax (what libvpx at cv2's settings never writes), in
    WebM, Matroska or AVI: 0 levels off cv2, its probe."""
    w, frames = stream(seed, n, keys, hidden, **features)
    path = tmp_path / f"s.{kind}"
    if kind == "avi":
        syn.write_avi(path, frames, w.width, w.height)
    else:
        syn.write_webm(path, frames, w.width, w.height,
                       doc_type="webm" if kind == "webm" else "matroska")
    ours = read_as_cv2(path, capfd)
    assert len(ours) == n - len(hidden)


def test_writer_covers_the_syntax():
    """The random streams above draw every version, mode, sub-block mode,
    split, token category and the rest of what the writer offers."""
    stats = __import__("collections").Counter()
    for seed, n, keys, hidden, features, _ in RANDOM:
        stats.update(stream(seed, n, keys, hidden, **features)[0].stats)
    for key in ([f"mode_{m}" for m in range(10)] + [f"bmode_{b}" for b in range(10)]
                + [f"split_{s}" for s in range(4)] + [f"cat_{c}" for c in range(1, 7)]
                + [f"partitions_{p}" for p in (1, 2, 4, 8)]
                + ["segmented", "no_refresh_entropy", "coef_updates", "no_skip_flag",
                   "golden_refresh", "altref_refresh", "copies", "far_mv", "to_end", "hidden",
                   "colour_space", "skipped"]):
        assert stats[key] > 0, key


# ── what FFmpeg does ────────────────────────────────────────

def test_stream_cut_mid_gop_reads_as_cv2(tmp_path, capfd):
    """A WebM that starts with inter frames (a recording cut): FFmpeg fails
    on the first, and cv2 then reads nothing, as the port does; cut at a
    key frame, it reads on."""
    w, frames = stream(40, 8, (0, 4))
    assert not vp8.probe_frame(frames[4]).map_from_previous
    for k, shown in ((1, 0), (3, 0), (4, 4)):
        path = syn.write_webm(tmp_path / f"cut{k}.webm", frames[k:], w.width, w.height)
        assert len(read_as_cv2(path, capfd)) == shown
        assert tvideo._own_reader(path).failed == (None if shown else (0, 9))
    # a key frame that takes its segment map from the frame before, first in
    # the file: refused by name
    w, frames = stream(21, 8, (0, 4))
    assert vp8.probe_frame(frames[4]).map_from_previous
    path = syn.write_webm(tmp_path / "cut_map.webm", frames[4:], w.width, w.height)
    with pytest.raises(container.UnsupportedCodecError, match="segment map"):
        tvideo.probe_video(path)


@pytest.mark.parametrize("cut", ["half", "header"])
def test_broken_frame_ends_the_video_as_in_cv2(tmp_path, capfd, cut):
    """A frame whose partitions run past its packet (cut in half, or to its
    first bytes): FFmpeg drops it and cv2 reads no further, as the port."""
    w, frames = stream(22, 8, (0, 4))
    frames[2] = frames[2][:len(frames[2]) // 2] if cut == "half" else frames[2][:10]
    path = syn.write_webm(tmp_path / "b.webm", frames, w.width, w.height)
    assert len(read_as_cv2(path, capfd)) == 2
    assert vp8.probe_frame(frames[2]).drop in (2, 5, 6)


def test_empty_frames_are_skipped_as_in_cv2(tmp_path, capfd):
    """An empty Matroska block and a 0-byte AVI chunk: no frame, the rest
    read on, counted in CAP_PROP_FRAME_COUNT."""
    w, frames = stream(23, 8, (0, 4))
    frames[2] = b""
    for path in (syn.write_webm(tmp_path / "e.webm", frames, w.width, w.height),
                 mux.write_avi(tmp_path / "e.avi", frames, [syn.is_key(f) for f in frames],
                               w.width, w.height, b"VP80")):
        assert len(read_as_cv2(path, capfd)) == 7
        assert tvideo.probe_video(path)["frame_count"] == 8


def test_scale_bits_are_ignored_as_in_ffmpeg(tmp_path, capfd):
    """The key frames' horizontal and vertical scale bits: FFmpeg ignores
    them, as the port does."""
    w, frames = stream(24, 6, (0, 3))
    scaled = []
    for f in frames:
        f = bytearray(f)
        if syn.is_key(bytes(f)):
            f[7] |= 0x40
            f[9] |= 0xC0
        scaled.append(bytes(f))
    path = syn.write_webm(tmp_path / "s.webm", scaled, w.width, w.height)
    assert read_as_cv2(path, capfd)


def test_alpha_block_additions_read_as_cv2(tmp_path, capfd):
    """VP8 with an alpha channel (a BlockGroup's BlockAdditions, as
    Chrome's alpha WebM holds it): cv2 shows the colour frames, as the
    port does."""
    w, frames = stream(26, 5)
    _, alpha = stream(27, 5)
    extra = [mux.el(0x75A1, mux.el(0xA6, mux.uint(0xEE, 1) + mux.el(0xA5, a))) for a in alpha]
    path = syn.write_webm(tmp_path / "a.webm", frames, w.width, w.height, block_group=True,
                          additions=extra)
    assert b"\x75\xa1" in path.read_bytes()
    assert len(read_as_cv2(path, capfd)) == 5


def test_size_change_refused_by_name(tmp_path):
    """A key frame of another size: refused by name (cv2 goes on at the new
    size)."""
    w, frames = stream(28, 4)
    w2, more = stream(29, 3, width=64, height=48)
    path = syn.write_webm(tmp_path / "r.webm", frames + more, w.width, w.height)
    with pytest.raises(container.UnsupportedCodecError, match="change of the picture's size"):
        tvideo.probe_video(path)


def test_clamping_type_refused_by_name(tmp_path):
    """A key frame with clamping_type 1: FFmpeg reads it as full range, but
    only in the frame thread that decodes it, so cv2's colours depend on
    the host's cores; refused by name."""
    seed = next(s for s in range(100) if stream(s, 1, clamping=True)[0].colour[1])
    w, frames = stream(seed, 3, clamping=True)
    assert vp8.probe_frame(frames[0]).full_range
    path = syn.write_webm(tmp_path / "c.webm", frames, w.width, w.height)
    with pytest.raises(container.UnsupportedCodecError, match="clamping_type 1"):
        tvideo.extract_frames(path, tmp_path / "out")


def test_colour_space_with_a_container_matrix_refused_by_name(tmp_path, capfd):
    """color_space 1 leaves the matrix to the container: with none, cv2
    reads BT.601 as the port does; with a BT.709 Colour element, refused."""
    seed = next(s for s in range(100) if stream(s, 1)[0].colour[0])
    w, frames = stream(seed, 3)
    path = syn.write_webm(tmp_path / "p.webm", frames, w.width, w.height)
    read_as_cv2(path, capfd)
    path = syn.write_webm(tmp_path / "m.webm", frames, w.width, w.height,
                          colour={"matrix": 1, "range": 1, "transfer": 1, "primaries": 1})
    with pytest.raises(container.UnsupportedCodecError, match="color_space 1"):
        tvideo.probe_video(path)


def test_random_access_equals_sequential(tmp_path):
    """Frames read at random restart at key frames and equal a sequential
    read; a key frame whose segment map comes from the frame before is no
    restart."""
    w, frames = stream(30, 10, (0, 3, 7), (5,))
    path = syn.write_webm(tmp_path / "r.webm", frames, w.width, w.height)
    seq = [tvideo._own_reader(path).rgb(i) for i in range(9)]
    reader = tvideo._own_reader(path)
    for i in list(np.random.default_rng(0).permutation(9)) + list(range(8, -1, -1)):
        assert np.array_equal(reader.rgb(int(i)), seq[int(i)])
    starts = [i for i, f in enumerate(frames) if syn.is_key(f)
              and not (i and vp8.probe_frame(f).map_from_previous)]
    assert reader.starts == starts


def test_extract_frames_as_in_the_jax_package(tmp_path, capfd):
    """The port's probe_video and extract_frames on a WebM against the JAX
    package's (cv2): equal probe, as many frames, 0 levels apart (no
    resize)."""
    path = CORPUS / "clip_cv2.webm"
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    ours = tvideo.extract_frames(path, tmp_path / "ours")
    theirs = jvideo.extract_frames(path, tmp_path / "theirs")
    capfd.readouterr()
    assert len(ours) == len(theirs) == MANIFEST["files"]["clip_cv2.webm"]["probe"]["frame_count"]
    for a, b in zip(ours, theirs):
        assert np.array_equal(tvideo.read_image(a), tvideo.read_image(b))


# ── tables, probe, fuzz ─────────────────────────────────────

def test_tables_are_libavcodecs():
    """The token, update, MV and mode probabilities, the quantiser tables,
    the bands and the six-tap filters are byte strings of the libavcodec
    that cv2 bundles; the key frames' sub-block probabilities are its
    table in FFmpeg's order of the modes."""
    lib = libavcodec()
    t = vp8_tables
    for values, dtype in ((t.COEF_PROBS, "u1"), (t.COEF_UPDATE_PROBS, "u1"),
                          (t.MV_DEFAULT_PROBS, "u1"), (t.MV_UPDATE_PROBS, "u1"),
                          (t.DC_QLOOKUP, "u1"), (t.AC_QLOOKUP, "<u2"),
                          (t.MODE_CONTEXTS, "<i4"), (t.SUBMV_REF_PROBS, "u1"),
                          (t.COEF_BANDS, "u1"), (t.KF_YMODE_PROBS, "u1"),
                          (t.KF_UV_MODE_PROBS, "u1"), (t.BMODE_PROBS, "u1"),
                          (np.abs(t.SIXTAP_FILTERS[1:]), "u1"), (t.CAT_PROBS[5] + (0,), "u1")):
        assert np.asarray(values).astype(dtype).tobytes() in lib
    kf = np.asarray(t.KF_BMODE_PROBS, np.uint8)
    theirs = np.zeros_like(kf)
    for a in range(10):
        for b in range(10):
            theirs[FFMPEG_BMODES[a], FFMPEG_BMODES[b]] = kf[a, b]
    assert theirs.tobytes() in lib


def test_tables_are_libvpxs():
    """The tables FFmpeg keeps elsewhere (the inter frames' mode
    probabilities, the split probabilities) are libvpx's bytes, and so is
    the key frames' sub-block table in the RFC's order."""
    libs = Path(cv2.__file__).resolve().parent.parent / "opencv_python.libs"
    found = sorted(libs.glob("libvpx*.so*")) if libs.is_dir() else []
    if not found:
        pytest.skip("no libvpx bundled with cv2")
    lib = found[0].read_bytes()
    t = vp8_tables
    for values in (t.YMODE_PROBS, t.UV_MODE_PROBS, t.MBSPLIT_PROBS, t.KF_BMODE_PROBS):
        assert np.asarray(values, np.uint8).tobytes() in lib


@pytest.mark.parametrize("cut, reason", [(0, 1), (2, 1), (3, 2), (9, 2), (12, 2)])
def test_probe_reads_ffmpegs_drop_reasons(cut, reason):
    """A key frame cut short: what FFmpeg's header check says of it."""
    frame = stream(31, 1)[1][0]
    assert vp8.probe_frame(frame[:cut]).drop == reason
    assert vp8.probe_frame(frame).drop == 0
    assert vp8.DROP_REASONS[reason]


FUZZ = """
import numpy as np, sys
sys.path.insert(0, {root!r})
from tests import torch_vp8_syntax as syn
from omfs4d_torch.io import vp8
rng = np.random.default_rng(0)
_, frames = syn.write_stream(32, frames=6, key_frames=(0, 3), width=48, height=32)
kinds = {{"ok": 0, "dropped": 0, "error": 0}}
for trial in range(300):
    host = vp8.Host()
    for k, f in enumerate(frames):
        f = bytearray(f)
        if k >= 1 and rng.random() < 0.7:
            if rng.random() < 0.5:
                f = f[:int(rng.integers(0, len(f) + 1))]
            else:
                for _ in range(int(rng.integers(1, 12))):
                    f[int(rng.integers(0, len(f)))] = int(rng.integers(0, 256))
        try:
            kinds["dropped" if host.decode(bytes(f)) == vp8.DROPPED else "ok"] += 1
        except ValueError:
            kinds["error"] += 1
            break
print(kinds)
"""


def test_decoder_fuzz_never_crashes(tmp_path):
    """Truncated and garbled frames in a child process: each decodes, is
    dropped or raises ValueError; the process never crashes."""
    script = FUZZ.format(root=str(Path(__file__).resolve().parent.parent))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    kinds = eval(res.stdout.strip().splitlines()[-1])
    assert kinds["ok"] > 0 and kinds["dropped"] > 0


# ── what stays refused ──────────────────────────────────────

def test_no_jax_covers_the_vp8_modules():
    """The import check of the port (`test_torch_no_jax.py`) walks
    `io.vp8` and `io.vp8_tables`."""
    from tests.test_torch_no_jax import port_modules
    assert {"omfs4d_torch.io.vp8", "omfs4d_torch.io.vp8_tables"} <= set(port_modules())


@pytest.mark.parametrize("codec_id, name", [("V_VP9", "VP9 profile 2"),
                                             ("V_AV1", "its video is AV1")])
def test_vp9_profile_2_av1_refused_by_name(tmp_path, codec_id, name):
    """VP9 profile 2 (10-bit) and AV1 in Matroska stay refused naming what
    (VP9 profile 0 is read: `tests/test_torch_vp9.py`)."""
    if codec_id == "V_VP9":
        from tests import torch_vp9_syntax
        frames = torch_vp9_syntax.write_stream(33, "KP", width=48, height=32).frames
        frames[0] = bytes([frames[0][0] | 0x10]) + frames[0][1:]     # profile 2
    else:
        frames = stream(33, 2)[1]
    path = mux.write_mkv(tmp_path / "x.webm", frames, [True, False], [0, 40],
                         codec_id=codec_id, width=48, height=32)
    with pytest.raises(container.UnsupportedCodecError, match="ffmpeg") as err:
        tvideo.probe_video(path)
    assert name in str(err.value)


def test_vp8_in_mp4_stays_refused():
    """cv2 cannot write VP8 into MP4 (FFmpeg's muxer has no tag for it at
    cv2's settings), so the `vp08` sample entry stays refused by name."""
    assert container._MP4_NAMES[b"vp08"] == "VP8"
