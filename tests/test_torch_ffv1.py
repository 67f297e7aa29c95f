"""The port's reading of FFV1 (`omfs4d_torch/io/ffv1.py`, the host decoder
`ffv1dec.cpp`) on the CPU, held to cv2 5.0.0 (libavcodec 62.28.101):

- The committed corpus (`tests/data/lossless/`: cv2's `FFV1` in AVI,
  Matroska, QuickTime and MP4, grey; version 3, Golomb-Rice, 4 slices with
  CRCs, RGB with alpha) and the writer's FFV1 streams of the manifest
  (version 0 Golomb-Rice, version 1 with a custom state table and RGBA,
  version 3 10-bit 4:2:2 with the record's initial states and slice CRCs,
  version 3 10-bit grey, a 1080p 10-bit 4:2:2 one of 144 slices): every
  frame's SHA-256 and `probe_video` equal cv2's.
- 200 random legal streams of `tests/torch_lossless_syntax.py` (versions
  0 / 1 / 3, both coders, custom states, initial states, 3- and 5-input
  contexts, several quant tables, slices, CRCs, key frames every k frames,
  YCbCr 4:2:0 / 4:2:2 / 4:4:4 / 4:4:0 / 4:1:1 / 4:1:0 and grey at 8-10 bits,
  RGB with and without alpha) in a child process: 0 levels off cv2, and
  every decoded plane the writer's picture (but the chroma column FFmpeg's
  slices leave uncoded where a slice edge falls on an odd x: 0).
- A slice whose CRC fails shows the frame before it until the next key
  frame, as cv2 shows it; random access equals a sequential read.
- The JAX package's `probe_video` / `extract_frames` (cv2) and the port's,
  and `cli preprocess --video`: equal frames.
- Refused by name: more than 10 bits, YCbCr with alpha, Bayer, versions 2
  and 4, a 9- / 10-bit sampling FFmpeg has no format for; garbled packets
  in a child process raise and never crash.
"""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, ffv1
from omfs4d_torch.io import video as tvideo
from tests import torch_lossless_syntax as syn
from tests.make_lossless_corpus import make_stream
from tests.test_torch_rawvideo import cv2_frames, digests

ROOT = Path(__file__).resolve().parent.parent
CORPUS = ROOT / "tests" / "data" / "lossless"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())
FILES = sorted(n for n, e in MANIFEST["files"].items() if e["fourcc"] == "FFV1")
STREAMS = sorted(n for n, e in MANIFEST["streams"].items() if e["codec"].startswith("ffv1"))


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


def test_cv2s_ffv1_is_version_3_golomb_rgba_in_slices():
    """What cv2's writer makes: version 3 (micro version 4), Golomb-Rice, 4
    slices with CRCs, RGB with alpha; its grey one is GRAY8; one key frame
    for its 6 frames."""
    frames = ffv1.frames(CORPUS / "ffv1_cv2.avi")
    frames[5]
    info = frames._host.info()
    assert (info["version"], info["micro_version"], info["coder"], info["colorspace"],
            info["slices"], info["ec"]) == (3, 4, 0, 1, 4, 1)
    assert frames.keys == [0]
    grey = ffv1.frames(CORPUS / "ffv1_cv2_grey.mkv")
    assert len(grey.ycbcr(0)) == 1


@pytest.mark.parametrize("name", ["ffv1_cv2.mp4", "ffv1_cv2_grey.mkv"])
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


def test_cli_preprocess_reads_ffv1(tmp_path, monkeypatch):
    """`cli preprocess --video` on cv2's FFV1 `.mkv`: its frames, each the
    port's read."""
    from omfs4d_torch.pipeline import cli

    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))
    path = CORPUS / "ffv1_cv2.mkv"
    assert cli.main(["preprocess", "--video", str(path), "--workdir", str(tmp_path / "wd"),
                     "--device", "cpu"]) == 0
    stage = next((tmp_path / "wd" / "stages").glob("preprocess-*"))
    pngs = sorted((stage / "images").glob("*.png"))
    frames = tvideo._own_reader(path)
    assert len(pngs) == len(frames) == 6
    for p, i in zip(pngs, range(len(frames))):
        assert np.array_equal(tvideo.read_image(p), frames.rgb(i))


# ── random streams ──────────────────────────────────────────

FUZZ = r"""
import sys, json
sys.path.insert(0, {root!r})
from pathlib import Path
from collections import Counter
import cv2, numpy as np
from omfs4d_torch.io import ffv1, video as tvideo
from tests import torch_lossless_syntax as syn

tvideo.find_ffmpeg = lambda: None
bad, planes_bad, seen = [], [], Counter()
for seed in range({n}):
    o = syn.random_options("ffv1", seed)
    seen.update(f"{{k}}={{v}}" for k, v in o.items()
                if k in ("version", "coder", "colorspace", "bits", "chroma", "alpha", "ec",
                         "initial"))
    seen[f"sub={{o['hs']}}{{o['vs']}}"] += bool(o["chroma"] and not o["colorspace"])
    seen["slices"] += o["slices"][0] * o["slices"][1] > 1
    seen["five"] += any(len(t[3]) > 1 for t in o["tables"])
    seen["tables"] += len(o["tables"]) > 1
    seen["non_key"] += o["gop"] > 1 and o["frames"] > 1
    path = syn.make_file(Path({tmp!r}) / f"s{{seed}}.{{o['mux']}}", seed, "ffv1")
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
    # the decoded planes are the writer's pictures
    rng = np.random.default_rng(seed + 1_000_003)
    w, h = o["width"], o["height"]
    if o["colorspace"]:
        shapes = [(h, w)] * (4 if o["alpha"] else 3)
    elif o["chroma"]:
        shapes = [(h, w)] + [(-(-h >> o["vs"]), -(-w >> o["hs"]))] * 2
    else:
        shapes = [(h, w)]
    pictures = syn._frames_of(rng, shapes, 8 if o["colorspace"] else o["bits"], o["frames"])
    # FFmpeg's slices of subsampled chroma start at x >> hs and are
    # ceil(width >> hs) wide: a slice edge at an odd x codes a chroma column
    # twice and leaves the last one uncoded, at 0
    coded = np.zeros(shapes[-1], bool)
    nh, nv = o["slices"]
    for sy in range(nv):
        for sx in range(nh):
            x0, x1 = sx * w // nh, (sx + 1) * w // nh
            y0, y1 = sy * h // nv, (sy + 1) * h // nv
            hs, vs = (o["hs"], o["vs"]) if len(shapes) == 3 and not o["colorspace"] else (0, 0)
            coded[y0 >> vs:(y0 >> vs) + (-(-(y1 - y0) >> vs)),
                  x0 >> hs:(x0 >> hs) + (-(-(x1 - x0) >> hs))] = True
    seen["chroma_gap"] += not coded.all()
    for i, pic in enumerate(pictures):
        got = reader.ycbcr(i)
        want = [pic[1], pic[2], pic[0]] if o["colorspace"] else pic
        if len(want) == 3 and not o["colorspace"]:
            want = [want[0]] + [np.where(coded, c, 0) for c in want[1:]]
        if any(not np.array_equal(a, b) for a, b in zip(got, want)):
            planes_bad.append(seed)
            break
print(json.dumps({{"bad": bad, "planes_bad": planes_bad, "seen": seen}}))
"""


def test_random_streams_read_as_cv2(tmp_path):
    """200 random FFV1 streams in a child process: 0 levels off cv2, as many
    frames, every plane the writer's picture; every feature drawn."""
    script = FUZZ.format(root=str(ROOT), n=200, tmp=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == [] and out["planes_bad"] == []
    seen = set(k for k, v in out["seen"].items() if v)
    want = {f"version={v}" for v in (0, 1, 3)} | {f"coder={c}" for c in (0, 1, 2)} | {
        f"bits={b}" for b in (8, 9, 10)} | {
        f"sub={s}" for s in ("11", "10", "00", "20", "01", "22")} | {
        "colorspace=1", "chroma=False", "alpha=True", "ec=True", "initial=True", "slices",
        "five", "tables", "non_key", "chroma_gap"}
    assert want <= seen, want - seen


def test_random_access_equals_sequential(tmp_path):
    path = make_stream("syn_ffv1_v3_10bit_422.mkv", tmp_path)
    frames = ffv1.frames(path)
    seq = [frames[i] for i in range(len(frames))]
    for i in (2, 1, 0, 2, 1):
        assert np.array_equal(frames[i], seq[i])


@pytest.mark.parametrize("at", [3, 6, 2])
def test_damaged_slice_shows_the_frame_before_as_cv2(tmp_path, capfd, at):
    """A byte flipped in one of the 4 slices of frame 3 of cv2's FFV1 (RGB,
    slice CRCs on): frames 3-5 (no key frame follows) as cv2 shows them,
    FFmpeg's concealment copy from the frame before misplaced by a quarter
    of the slice's x, the slice's other pixels black; the decoder marks the
    slice damaged."""
    src = CORPUS / "ffv1_cv2.avi"
    offsets, sizes, _ = container.index(src)
    data = bytearray(src.read_bytes())
    data[offsets[3] + sizes[3] * at // 7] ^= 0x5A
    path = tmp_path / "damaged.avi"
    path.write_bytes(bytes(data))
    theirs = cv2_frames(path)
    capfd.readouterr()
    good = ffv1.frames(src)
    frames = ffv1.frames(path)
    assert len(theirs) == len(frames) == 6
    for i, b in enumerate(theirs):
        assert np.array_equal(frames[i], b), i
        assert (frames._host.info()["damaged"] > 0) == (i >= 3)
    assert not np.array_equal(frames[4], good[4])


# ── refusals and damage ─────────────────────────────────────

def _v1_stream(tmp_path, **header) -> Path:
    fv = syn.FFV1(8, 8, version=1, coder=1)
    for k, v in header.items():
        setattr(fv, k, v)
    planes = [np.zeros((8, 8), np.int64)] + [np.zeros((4, 4), np.int64)] * 2
    return syn.write_avi(tmp_path / "r.avi", [fv.packet(planes)], 8, 8, b"FFV1", 24)


@pytest.mark.parametrize("header,words", [
    ({"bits": 12}, "YCbCr at 12 bits"), ({"alpha": True, "plane_count": 3}, "alpha"),
    ({"colorspace": 2}, "Bayer"), ({"bits": 10, "hs": 2, "vs": 0}, "no pixel format")])
def test_other_formats_refused(tmp_path, header, words):
    path = _v1_stream(tmp_path, **header)
    with pytest.raises(container.UnsupportedCodecError, match=words):
        tvideo._own_reader(path).rgb(0)


@pytest.mark.parametrize("version", [2, 4])
def test_other_versions_refused(tmp_path, version):
    """Version 2 (FFmpeg's experimental one, which cv2 does not write) and
    version 4: refused by name when the record is read."""
    fv = syn.FFV1(8, 8, version=3, coder=1)
    fv.version = version
    path = syn.write_mkv(tmp_path / "v.mkv", [bytes(8)], 8, 8, codec_id="V_FFV1",
                         private=fv._record())
    with pytest.raises(container.UnsupportedCodecError, match=f"FFV1 version {version}"):
        tvideo._own_reader(path)


FUZZ_GARBLED = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
from collections import Counter
from omfs4d_torch.io import container, ffv1
from tests import torch_lossless_syntax as syn

rng = np.random.default_rng(0)
kinds = Counter()
for seed in range(60):
    s = syn.make_stream(seed, "ffv1")
    o = s["options"]
    host = ffv1.Host(o["width"], o["height"], s["extradata"])
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
        except container.UnsupportedCodecError:
            kinds["refused"] += 1
            host = ffv1.Host(o["width"], o["height"], s["extradata"])
        except ValueError:
            kinds["error"] += 1
            host = ffv1.Host(o["width"], o["height"], s["extradata"])
print(dict(kinds))
"""


def test_decoder_fuzz_never_crashes():
    """Garbled and truncated packets in a child process: each decodes or
    raises; the process never crashes."""
    script = FUZZ_GARBLED.format(root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    kinds = eval(res.stdout.strip().splitlines()[-1])
    assert kinds.get("error", 0) > 0 and sum(kinds.values()) > 100
