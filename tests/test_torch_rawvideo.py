"""The port's reading of raw and PNG video (`omfs4d_torch/io/rawvideo.py`,
`video.PNGFrames`, the C++ PNG unfilter `pngfilter.cpp`), of Motion JPEG
under the AVI fourccs `JPGL` / `LJPG` and of VP8 / VP9 in IVF, on the CPU,
held to cv2 5.0.0 (libavcodec 62.28.101):

- The committed corpus (`tests/data/lossless/`: cv2's `I420`, `IYUV`,
  `YV12`, `Y800`, `RGBA` raw video in AVI, Matroska and QuickTime; PNG
  under `MPNG` / `PNG ` / `png ` in AVI, QuickTime, Matroska and MP4, and
  grey; `JPGL` / `LJPG`; `VP80` / `VP90` in IVF; cv2 rounds a size asked
  for odd down to even) and the writer's raw and PNG streams of the
  manifest (97 x 63 I420, padded Y800 rows, a 1080p one of each): every
  frame's SHA-256 and `probe_video` equal cv2's.
- The JAX package's `probe_video` / `extract_frames` (cv2) and the port's
  on corpus files: equal probes and PNGs.
- 100 random raw streams at random, odd sizes (BI_RGB AVIs at 24 / 32
  bits with padded rows; `I420`, `IYUV`, `YV12`, `Y800` packed or padded,
  `RGBA` in AVI or Matroska) and 100 random PNG streams (every colour type
  and row filter, split IDATs) of `tests/torch_lossless_syntax.py`, in a
  child process: 0 levels off cv2.
  A bottom-up BGR24 AVI corrupts cv2 5.0.0's heap (it copies FFmpeg's
  flipped picture as if its rows ran down): those are held to the writer's
  pictures.
- The C++ unfilter equals the Python plain version over random rows of all
  five filters; FFmpeg's 1080p Paeth frame decodes in <= 0.2 s to its
  pixels; a failed build raises.
- Motion JPEG under FFmpeg's other AVI tags (`JPGL`, `LJPG`, `IJPG`,
  `ACDV`, `QIVG`, `SLMJ`, `CJPG`, `MVJP`, `AVI1`, `mjpa`), as cv2 writes
  and reads it: 0 levels off.
- Refused by name: cv2's `YUY2` / `UYVY` AVIs and raw QuickTime entries
  (cv2 shows no frame from them), JPEG-LS, UtVideo, JPEG 2000, Snow.
"""

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import cv2
import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, rawvideo
from omfs4d_torch.io import video as tvideo
from tests import torch_lossless_syntax as syn
from tests.make_lossless_corpus import make_stream

ROOT = Path(__file__).resolve().parent.parent
CORPUS = ROOT / "tests" / "data" / "lossless"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())
# the corpus files and streams of this module's codecs
FILES = sorted(n for n, e in MANIFEST["files"].items()
               if e["fourcc"] in ("I420", "IYUV", "YV12", "Y800", "RGBA", "MPNG", "PNG ",
                                  "png ", "JPGL", "LJPG", "VP80", "VP90"))
STREAMS = sorted(n for n, e in MANIFEST["streams"].items()
                 if e["codec"] in ("raw", "png", "png1080"))


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setattr(jvideo, "find_ffmpeg", lambda: None)


def digests(path) -> tuple[dict, list[str]]:
    reader = tvideo._own_reader(Path(path))
    return tvideo.probe_video(path), [
        hashlib.sha256(np.ascontiguousarray(reader.rgb(i)).tobytes()).hexdigest()
        for i in range(len(reader))]


def cv2_frames(path) -> list[np.ndarray]:
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        out.append(np.ascontiguousarray(bgr[..., ::-1]))
    cap.release()
    return out


# ── the corpus ──────────────────────────────────────────────

@pytest.mark.parametrize("name", FILES)
def test_corpus_file_reads_as_cv2(name):
    """Each cv2 clip: its bytes as committed, every frame and the probe as
    cv2 read them."""
    path = CORPUS / name
    entry = MANIFEST["files"][name]
    assert hashlib.sha256(path.read_bytes()).hexdigest() == entry["file_sha256"]
    probe, hashes = digests(path)
    assert probe == entry["probe"]
    assert hashes == entry["sha256"]


@pytest.mark.parametrize("name", STREAMS)
def test_writer_stream_reads_as_cv2(tmp_path, name):
    """Each writer stream of the manifest, remade from its seed: the same
    bytes, every frame and the probe as cv2 read them."""
    entry = MANIFEST["streams"][name]
    path = make_stream(name, tmp_path)
    assert hashlib.sha256(path.read_bytes()).hexdigest() == entry["file_sha256"]
    probe, hashes = digests(path)
    assert probe == entry["probe"]
    assert hashes == entry["sha256"]


def test_corpus_covers_the_containers_and_stays_small():
    """Raw video in AVI, Matroska and QuickTime, PNG in all four containers,
    the IVF pair, odd sizes; the whole corpus under 1 MiB."""
    kinds = {(e["fourcc"].strip().lower(), Path(n).suffix) for n, e in MANIFEST["files"].items()}
    for want in [("i420", ".avi"), ("i420", ".mkv"), ("rgba", ".mov"), ("y800", ".mkv"),
                 ("mpng", ".mp4"), ("png", ".mov"), ("png", ".mkv"), ("vp80", ".ivf"),
                 ("vp90", ".ivf"), ("jpgl", ".avi"), ("ljpg", ".avi")]:
        assert want in kinds, want
    # cv2's writers round an odd size down (33 x 25 asked, 32 x 24 written):
    # odd sizes come from the writer's streams
    assert MANIFEST["files"]["i420_cv2_odd.avi"]["probe"]["width"] == 32
    assert any(MANIFEST["streams"][n]["options"]["width"] % 2 for n in STREAMS)
    assert sum(p.stat().st_size for p in CORPUS.iterdir()) < 1 << 20


@pytest.mark.parametrize("name,target", [("i420_cv2_odd.avi", 0), ("y800_cv2.mkv", 512),
                                         ("rgba_cv2.mov", 0), ("png_cv2.mkv", 512),
                                         ("jpgl_cv2.avi", 0), ("vp90_cv2.ivf", 0)])
def test_extract_frames_as_in_the_jax_package(tmp_path, capfd, name, target):
    """The port's probe_video and extract_frames against the JAX package's
    (cv2): equal probe, as many frames, PNGs of equal pixels."""
    path = CORPUS / name
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    ours = tvideo.extract_frames(path, tmp_path / "ours", target_size=target)
    theirs = jvideo.extract_frames(path, tmp_path / "theirs", target_size=target)
    capfd.readouterr()
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert np.array_equal(tvideo.read_image(a), tvideo.read_image(b))


@pytest.mark.parametrize("fourcc", ["JPGL", "LJPG", "IJPG", "ACDV", "QIVG", "SLMJ", "CJPG",
                                    "MVJP", "AVI1", "mjpa"])
def test_mjpeg_under_other_avi_fourccs_reads_as_cv2(tmp_path, capfd, fourcc):
    """cv2 writes Motion JPEG under FFmpeg's other AVI tags (the tag kept in
    the file) and reads it back as MJPG: the port reads it too, 0 levels off,
    with cv2's probe."""
    path = tmp_path / "m.avi"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30, (48, 32))
    for i in range(3):
        vw.write(np.full((32, 48, 3), (30 * i, 90, 200 - 40 * i), np.uint8))
    vw.release()
    theirs = cv2_frames(path)
    capfd.readouterr()
    offsets, sizes, info = container.index(path)
    assert info["codec"] == "mjpeg"
    reader = tvideo._own_reader(path)
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    assert len(reader) == len(theirs) == 3
    for i, b in enumerate(theirs):
        assert np.array_equal(reader.rgb(i), b)


# ── random streams ──────────────────────────────────────────

FUZZ = r"""
import sys, json
sys.path.insert(0, {root!r})
from pathlib import Path
from collections import Counter
import cv2, numpy as np
from omfs4d_torch.io import video as tvideo
from tests import torch_lossless_syntax as syn

tvideo.find_ffmpeg = lambda: None
bad, seen = [], Counter()
for seed in range({n}):
    o = syn.random_options({codec!r}, seed)
    seen.update(f"{{k}}={{v}}" for k, v in o.items()
                if k in ("bits", "bottom_up", "channels", "fourcc"))
    path = syn.make_file(Path({tmp!r}) / f"s{{seed}}.{{o['mux']}}", seed, {codec!r})
    cap = cv2.VideoCapture(str(path))
    theirs = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        theirs.append(bgr[..., ::-1])
    reader = tvideo._own_reader(path)
    ours = [reader.rgb(i) for i in range(len(reader))]
    if len(ours) != len(theirs) or len(ours) != o["frames"] or any(
            not np.array_equal(a, b) for a, b in zip(ours, theirs)):
        bad.append(seed)
print(json.dumps({{"bad": bad, "seen": seen}}))
"""


def fuzz(codec: str, n: int, tmp: Path) -> dict:
    script = FUZZ.format(root=str(ROOT), n=n, codec=codec, tmp=str(tmp))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_random_raw_streams_read_as_cv2(tmp_path):
    """100 random raw streams at random (odd) sizes: BI_RGB AVIs (24 / 32
    bits, padded rows, bottom-up at 32 bits) and `I420`, `IYUV`, `YV12`,
    `Y800` (rows packed or padded to 4 bytes) and `RGBA` in AVI or
    Matroska: 0 levels off cv2, in a child process."""
    out = fuzz("raw", 100, tmp_path)
    assert out["bad"] == []
    assert {"bits=24", "bits=32", "bottom_up=True", "bottom_up=False",
            *(f"fourcc={t}" for t in ("BI_RGB", "I420", "IYUV", "YV12", "Y800", "RGBA"))
            } <= set(out["seen"])


def test_random_png_streams_read_as_cv2(tmp_path):
    """100 random PNG streams (grey, grey + alpha, RGB, RGBA; each row's
    filter drawn; IDAT split): 0 levels off cv2, in a child process."""
    out = fuzz("png", 100, tmp_path)
    assert out["bad"] == []
    assert {f"channels={c}" for c in (1, 2, 3, 4)} <= set(out["seen"])


@pytest.mark.parametrize("width", [16, 17, 18, 19])
def test_bottom_up_bgr24_is_the_writers_picture(tmp_path, width):
    """A bottom-up BGR24 AVI (DirectShow's capture, rows padded to 4 bytes):
    the writer's pictures, flipped back (cv2 5.0.0 cannot be asked: its
    heap is corrupted)."""
    opts = {"fourcc": "BI_RGB", "bits": 24, "bottom_up": True, "width": width, "height": 9,
            "frames": 2, "mux": "avi"}
    s = syn.make_stream(5, "raw", opts)
    path = syn.make_file(tmp_path / "b.avi", 5, "raw", opts)
    reader = tvideo._own_reader(path)
    for i, sample in enumerate(s["samples"]):
        stride = -(-3 * width // 4) * 4
        rows = np.frombuffer(sample, np.uint8).reshape(9, stride)[::-1, :3 * width]
        assert np.array_equal(reader.rgb(i), rows.reshape(9, width, 3)[..., ::-1])


def test_raw_sample_too_short_raises(tmp_path):
    """A raw frame shorter than its size: ValueError (cv2 shows none)."""
    data = bytes(10)
    with pytest.raises(ValueError, match="fewer than"):
        rawvideo.decode_raw(data, "yuv420p", 8, 8)


# ── the PNG unfilter ────────────────────────────────────────

def test_unfilter_equals_the_plain_version():
    """The C++ unfilter against `_unfilter_row` (numpy and Python) over
    random rows of every filter at 1 to 4 bytes a pixel."""
    rng = np.random.default_rng(0)
    for bpp in (1, 2, 3, 4, 6, 8):
        for _ in range(6):
            w, h = int(rng.integers(1, 40)), int(rng.integers(1, 12))
            rows = rng.integers(0, 256, (h, w * bpp), dtype=np.uint8)
            filters = rng.integers(0, 5, h).astype(np.uint8)
            raw = np.concatenate([filters[:, None], rows], 1).tobytes()
            got = tvideo.unfilter(raw, h, w * bpp, bpp)
            prev = np.zeros(w * bpp, np.uint8)
            for y in range(h):
                prev = tvideo._unfilter_row(int(filters[y]), rows[y], prev, bpp)
                assert np.array_equal(got[y], prev), (bpp, y, int(filters[y]))


def test_unfilter_refuses_an_unknown_filter():
    raw = bytes([0]) + bytes(4) + bytes([5]) + bytes(4)
    with pytest.raises(ValueError, match="unknown row filter 5 in row 1"):
        tvideo.unfilter(raw, 2, 4, 1)


def test_ffmpeg_paeth_frame_at_1080p_is_quick():
    """FFmpeg's PNG encoder's 1080p frame (a Sub row, then Paeth): its
    pixels in <= 0.2 s (2.52 s through the Python rows)."""
    rng = np.random.default_rng(1)
    tile = np.stack([syn.picture(rng, 120, 120, 8, "mixed") for _ in range(3)], -1)
    img = np.tile(tile, (9, 16, 1)).astype(np.uint8)
    data = syn.ffmpeg_png(img)
    tvideo.decode_png(data)                               # the build, once
    best = min(_timed(tvideo.decode_png, data) for _ in range(3))
    assert np.array_equal(tvideo.decode_png(data), img)
    assert best <= 0.2, best


def _timed(fn, *args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def test_failed_unfilter_build_raises(monkeypatch, tmp_path):
    """No g++: decode_png raises with the reason, no Python fallback."""
    from omfs4d_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    tvideo._unfilter_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no g\\+\\+"):
            tvideo.decode_png(syn.ffmpeg_png(np.zeros((4, 4, 3), np.uint8)))
    finally:
        tvideo._unfilter_library.cache_clear()


# ── refusals ────────────────────────────────────────────────

@pytest.mark.parametrize("fourcc,suffix,words", [
    ("YUY2", ".avi", "raw YUY2"), ("UYVY", ".avi", "raw UYVY"),
    ("raw ", ".mov", "raw video \\('raw '"), ("MJLS", ".avi", "JPEG-LS"),
    ("ULY0", ".avi", "UtVideo"), ("MJ2C", ".avi", "JPEG 2000"), ("SNOW", ".avi", "Snow")])
def test_other_codecs_refused(tmp_path, capfd, fourcc, suffix, words):
    """cv2's files of codecs the port does not read: UnsupportedCodecError
    naming each."""
    path = tmp_path / f"c{suffix}"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30, (32, 16))
    assert vw.isOpened()
    for i in range(2):
        vw.write(np.full((16, 32, 3), 40 * i, np.uint8))
    vw.release()
    capfd.readouterr()
    with pytest.raises(container.UnsupportedCodecError, match=words):
        tvideo.probe_video(path)


def test_bi_rgb_of_other_depths_refused(tmp_path):
    """BI_RGB at 16 bits (RGB555): refused by name."""
    path = syn.write_avi(tmp_path / "r.avi", [bytes(8 * 4 * 2)], 8, 4, b"\0\0\0\0", 16)
    with pytest.raises(container.UnsupportedCodecError, match="BI_RGB at 16 bits"):
        tvideo.probe_video(path)


def test_no_jax_covers_the_lossless_modules():
    """The import check of the port (`test_torch_no_jax.py`) walks the new
    modules."""
    from tests.test_torch_no_jax import port_modules
    assert {"omfs4d_torch.io.rawvideo", "omfs4d_torch.io.huffyuv",
            "omfs4d_torch.io.huffyuv_tables", "omfs4d_torch.io.ffv1"} <= set(port_modules())
