"""The port's reading of HuffYUV (`omfs4d_torch/io/huffyuv.py`, the host
decoder `huffyuvdec.cpp`, its classic tables `huffyuv_tables.py`) on the
CPU, held to cv2 5.0.0 (libavcodec 62.28.101):

- The committed corpus (`tests/data/lossless/`: cv2's `HFYU` in AVI,
  Matroska and QuickTime, its `FFVH` (ffvhuff, 4:2:0) in AVI and Matroska)
  and the writer's HuffYUV streams of the manifest (version 0 YUY2 with the
  median predictor, version 1 RGB32 planar, version 2 with per-packet
  tables and interlaced prediction, ffvhuff median, a 1080p one): every
  frame's SHA-256 and `probe_video` equal cv2's.
- 120 random legal streams of `tests/torch_lossless_syntax.py` (versions
  0 / 1 / 2, YUV 4:2:2, 4:2:0, RGB24, RGB32, left / plane / median,
  decorrelated or not, interlaced, context) in a child process: 0 levels
  off cv2, every feature drawn.
- The JAX package's `probe_video` / `extract_frames` (cv2) and the port's:
  equal.
- The classic tables are libavcodec's bytes and complete prefix codes.
- Refused by name: ffvhuff version 3; garbled packets in a child process
  raise and never crash; random access equals a sequential read.
"""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, huffyuv, huffyuv_tables
from omfs4d_torch.io import video as tvideo
from tests import torch_lossless_syntax as syn
from tests.make_lossless_corpus import make_stream
from tests.test_torch_mpeg4 import libavcodec
from tests.test_torch_rawvideo import digests

ROOT = Path(__file__).resolve().parent.parent
CORPUS = ROOT / "tests" / "data" / "lossless"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())
FILES = sorted(n for n, e in MANIFEST["files"].items() if e["fourcc"] in ("HFYU", "FFVH"))
STREAMS = sorted(n for n, e in MANIFEST["streams"].items() if e["codec"] == "huffyuv")


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setattr(jvideo, "find_ffmpeg", lambda: None)


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


def test_corpus_covers_cv2s_writers():
    """cv2's HFYU in AVI, Matroska and QuickTime and FFVH in two; its
    HFYU is version 2, RGB24, left predicted, decorrelated (extradata
    `40 18 20 00`), its FFVH version 2, 4:2:0, left (`00 0c 20 00`)."""
    suffixes = {(MANIFEST["files"][n]["fourcc"], Path(n).suffix) for n in FILES}
    assert {("HFYU", ".avi"), ("HFYU", ".mkv"), ("HFYU", ".mov"), ("FFVH", ".avi"),
            ("FFVH", ".mkv")} <= suffixes
    for name, want in (("hfyu_cv2.avi", (huffyuv.RGB24, "left", 1, 0, 2)),
                       ("ffvh_cv2.avi", (huffyuv.YUV420, "left", 0, 0, 2))):
        h = tvideo._own_reader(CORPUS / name).host
        assert (h.format, h.predictor, h.decorrelate, h.context, h.version) == want


@pytest.mark.parametrize("name", ["hfyu_cv2.mov", "ffvh_cv2.mkv"])
def test_extract_frames_as_in_the_jax_package(tmp_path, capfd, name):
    """The port's probe_video and extract_frames against the JAX package's
    (cv2): equal probe, as many frames, PNGs of equal pixels."""
    path = CORPUS / name
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    ours = tvideo.extract_frames(path, tmp_path / "ours")
    theirs = jvideo.extract_frames(path, tmp_path / "theirs")
    capfd.readouterr()
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert np.array_equal(tvideo.read_image(a), tvideo.read_image(b))


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
    o = syn.random_options("huffyuv", seed)
    seen.update(f"{{k}}={{v}}" for k, v in o.items()
                if k in ("fmt", "version", "predictor", "decorrelate", "interlace", "context"))
    seen["tall"] += o["height"] > 288
    path = syn.make_file(Path({tmp!r}) / f"s{{seed}}.{{o['mux']}}", seed, "huffyuv")
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


def test_random_streams_read_as_cv2(tmp_path):
    """120 random HuffYUV streams in a child process: 0 levels off cv2, as
    many frames; every version, format, predictor and flag drawn."""
    script = FUZZ.format(root=str(ROOT), n=120, tmp=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    seen = set(k for k, v in out["seen"].items() if v)
    want = {f"fmt={f}" for f in ("yuv422", "yuv420", "rgb24", "rgb32")} | {
        f"version={v}" for v in (0, 1, 2)} | {
        f"predictor={p}" for p in ("left", "plane", "median")} | {
        "decorrelate=True", "decorrelate=False", "interlace=True", "interlace=False",
        "context=True", "tall"}
    assert want <= seen, want - seen


def test_random_access_equals_sequential(tmp_path):
    path = make_stream("syn_hfyu_v2_context_interlaced.mkv", tmp_path)
    frames = huffyuv.frames(path)
    seq = [frames[i] for i in range(len(frames))]
    for i in (2, 0, 1, 2):
        assert np.array_equal(frames[i], seq[i])


# ── the tables ──────────────────────────────────────────────

def test_tables_are_libavcodecs():
    """The classic tables are byte strings of the libavcodec cv2 bundles,
    in its order (add chroma, add luma, shift chroma, shift luma)."""
    lib = libavcodec()
    add = bytes(huffyuv_tables.CLASSIC_ADD_CHROMA) + bytes(huffyuv_tables.CLASSIC_ADD_LUMA)
    at = lib.find(add)
    assert at >= 0
    assert lib.find(bytes(huffyuv_tables.CLASSIC_SHIFT_CHROMA)) == at + 512
    assert lib.find(bytes(huffyuv_tables.CLASSIC_SHIFT_LUMA)) == at + 576


@pytest.mark.parametrize("shift,add", [("CLASSIC_SHIFT_LUMA", "CLASSIC_ADD_LUMA"),
                                       ("CLASSIC_SHIFT_CHROMA", "CLASSIC_ADD_CHROMA")])
def test_classic_tables_are_complete_prefix_codes(shift, add):
    lengths, _ = huffyuv_tables.read_len_table(getattr(huffyuv_tables, shift))
    codes = list(getattr(huffyuv_tables, add))
    assert len(lengths) == 256 and min(lengths) > 0
    assert sum(2.0 ** -n for n in lengths) == 1.0
    words = sorted(format(c, f"0{n}b") for c, n in zip(codes, lengths))
    assert all(len(format(c, "b")) <= n for c, n in zip(codes, lengths))
    assert not any(b.startswith(a) for a, b in zip(words, words[1:]))


def test_canonical_codes_are_ffmpegs():
    """`canonical_codes` (the writer's) gives the longest codes the smallest
    values, as `ff_huffyuv_generate_bits_table`, and refuses an incomplete
    code."""
    assert huffyuv_tables.canonical_codes([1, 2, 3, 3]) == [1, 1, 0, 1]
    with pytest.raises(ValueError):
        huffyuv_tables.canonical_codes([1, 2, 3])


# ── refusals and damage ─────────────────────────────────────

def test_ffvhuff_version_3_refused(tmp_path):
    """An ffvhuff extradata whose fourth byte is set (version 3: planar
    formats, deeper samples, alpha): refused by name."""
    path = syn.write_avi(tmp_path / "v3.avi", [bytes(64)], 16, 8, b"FFVH", 24,
                         bytes([0, 0x08, 0x20, 0x10]) + bytes(16))
    with pytest.raises(container.UnsupportedCodecError, match="ffvhuff version 3"):
        tvideo._own_reader(path)


def test_rgb_median_refused(tmp_path):
    path = syn.write_avi(tmp_path / "m.avi", [bytes(64)], 16, 8, b"HFYU", 24 | 4)
    with pytest.raises(container.UnsupportedCodecError, match="median"):
        tvideo._own_reader(path)


FUZZ_GARBLED = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
from collections import Counter
from omfs4d_torch.io import container, huffyuv
from tests import torch_lossless_syntax as syn

rng = np.random.default_rng(0)
kinds = Counter()
for seed in range(40):
    s = syn.make_stream(seed, "huffyuv")
    o = s["options"]
    host = huffyuv.Host(o["width"], o["height"], s["bits"], s["extradata"])
    for packet in s["samples"]:
        data = bytearray(packet)
        for _ in range(int(rng.integers(1, 8))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        if seed % 4 == 0:
            data = data[:int(rng.integers(1, len(data)))]
        try:
            host.decode(bytes(data))
            host.take()
            kinds["ok"] += 1
        except ValueError:
            kinds["error"] += 1
print(dict(kinds))
"""


def test_decoder_fuzz_never_crashes():
    """Garbled and truncated packets in a child process: each decodes or
    raises ValueError; the process never crashes."""
    script = FUZZ_GARBLED.format(root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    kinds = eval(res.stdout.strip().splitlines()[-1])
    assert sum(kinds.values()) > 60
