"""The port's MPEG-1 / MPEG-2 video reading (`omfs4d_torch/io/mpeg2.py`, the
host decoder `mpeg2dec.cpp`) on the CPU, held to cv2 5.0.0 (libavcodec
62.28.101):

- The committed corpus (`tests/data/mpeg2/`: cv2's `MPG1`, `PIM1` and
  `MPG2` writers into MPEG-PS `.mpg` / `.mpeg` / `.vob`, MPEG-TS `.ts` /
  `.m2ts`, AVI, Matroska, MP4 and QuickTime, a clip asked for at 97x63, one
  at 1080p) and the writer's streams of the manifest (interlaced frame
  pictures in PS and TS, frames flagged interlaced, MPEG-1 with
  stuffing and full_pel vectors, low_delay): every frame's SHA-256 and
  `probe_video` (width, height, fps, frame_count) equal cv2's.
- 200 random legal-syntax streams (`tests/torch_mpeg2_syntax.py`, read by
  cv2 as raw streams): 0 levels off cv2, in count too; MPEG-1 and MPEG-2,
  progressive and interlaced (field and dual-prime prediction, field DCT),
  every tool the decoder reads drawn over the 200.
- What FFmpeg does at a stream's start (a P picture with no reference, an
  open GOP's leading B pictures, packets before the first sequence header),
  held to cv2 through program streams.
- The JAX package's `extract_frames` and the port's on a committed `.mpg`
  and the interlaced `.ts`, at target_size 0 and 512: equal PNGs.
- The tables are libavcodec's bytes and prefix codes.
- Each case the port refuses, by name: field pictures, a first frame
  flagged interlaced, 4:2:2, the scalable extensions, D-pictures, a change
  of size, a vector past the edge, raw `.m1v` / `.m2v`, TMPGEnc's stamp,
  AVI's VCR2 / SLIF; a slice missing raises ValueError; garbled streams in
  a child process raise and never crash.
"""

import hashlib
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import cv2
import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, mpeg2, mpeg2_tables, mpegps, swscale
from omfs4d_torch.io import video as tvideo
from omfs4d_torch.io.h264 import ycbcr_to_rgb
from tests import torch_mpeg2_syntax as syn
from tests.make_mpeg2_corpus import make_stream
from tests.test_torch_mpeg4 import libavcodec

CORPUS = Path(__file__).resolve().parent / "data" / "mpeg2"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setattr(jvideo, "find_ffmpeg", lambda: None)


def digests(path) -> tuple[dict, list[str]]:
    reader = tvideo._own_reader(Path(path))
    return tvideo.probe_video(path), [
        hashlib.sha256(np.ascontiguousarray(reader.rgb(i)).tobytes()).hexdigest()
        for i in range(len(reader))]


def cv2_frames(path, capfd=None) -> list[np.ndarray]:
    """cv2's RGB frames of a file."""
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        out.append(np.ascontiguousarray(bgr[..., ::-1]))
    cap.release()
    if capfd is not None:
        capfd.readouterr()
    return out


# ── the corpus ──────────────────────────────────────────────

@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_corpus_file_reads_as_cv2(name):
    """Each cv2 clip: its bytes as committed, every frame and the probe as
    cv2 read them."""
    path = CORPUS / name
    entry = MANIFEST["files"][name]
    assert hashlib.sha256(path.read_bytes()).hexdigest() == entry["file_sha256"]
    probe, hashes = digests(path)
    assert probe == entry["probe"]
    assert hashes == entry["sha256"]


@pytest.mark.parametrize("name", sorted(MANIFEST["streams"]))
def test_writer_stream_reads_as_cv2(tmp_path, name):
    """Each writer stream of the manifest, remade from its seed: the same
    bytes, every frame and the probe as cv2 read them."""
    entry = MANIFEST["streams"][name]
    path = make_stream(name, tmp_path)
    assert hashlib.sha256(path.read_bytes()).hexdigest() == entry["file_sha256"]
    probe, hashes = digests(path)
    assert probe == entry["probe"]
    assert hashes == entry["sha256"]


def test_corpus_has_each_container():
    """The corpus covers every container and writer of the table it was
    made for, and stays under 1 MiB."""
    files = MANIFEST["files"]
    suffixes = {Path(n).suffix for n in files}
    assert suffixes >= {".mpg", ".mpeg", ".vob", ".ts", ".m2ts", ".avi", ".mkv", ".mp4", ".mov"}
    assert {e["fourcc"] for e in files.values()} == {"MPG1", "PIM1", "MPG2"}
    odd = files["mpg2_cv2_odd.mpg"]["probe"]
    assert (odd["width"], odd["height"]) == (96, 62)
    assert sum(p.stat().st_size for p in CORPUS.iterdir()) < 1 << 20
    codecs = {n: container.index(CORPUS / n)[2]["container"] for n in files}
    assert codecs["mpg1_cv2.mpg"] == codecs["mpg2_cv2.vob"] == "mpegps"


# ── random streams ──────────────────────────────────────────

def random_case(seed: int) -> tuple[str, bool, dict]:
    """(plan, MPEG-2, options) of random stream `seed`: a quarter MPEG-1,
    a quarter progressive MPEG-2, half interlaced frame pictures (field and
    dual-prime prediction, field DCT), of them half flagged interlaced."""
    rng = np.random.default_rng(seed)
    kind = seed % 4
    plans = ["IPBBPBB", "IPPBPB", "IBPBBP", "IIPB", "IP|oIBBP", "IPBB|IPBB", "I|IPPP", "IPBBB"]
    o = dict(width=int(rng.choice([16, 32, 48, 64, 80, 33, 47, 65])),
             height=int(rng.choice([16, 32, 48, 64, 31, 45])),
             skip=float(rng.random() * 0.5), intra=float(rng.random() * 0.3),
             big=float(rng.random() * 0.3), escape=float(rng.random() * 0.3),
             matrices=float(rng.random()), f_code=tuple(int(f) for f in rng.choice(
                 np.arange(1, 8), 3, replace=False)),
             far=float(rng.random()), slices=float(rng.random() * 0.6),
             concealment=float(rng.random() * 0.5), quant=float(rng.random() * 0.5))
    if seed % 25 == 12:                        # skips past 33 macroblocks: the escape
        o.update(width=592, height=16, skip=0.95)
    if kind == 0:
        return str(rng.choice(plans)), False, dict(o, full_pel=float(rng.random() * 0.5),
                                                   stuffing=float(rng.random() * 0.3))
    o["low_delay"] = int(rng.random() < 0.15)
    if kind >= 2:
        o.update(progressive=False, frame_pred=float(rng.random()),
                 dual_prime=float(rng.random() * 0.5), flag_progressive=kind == 2,
                 pulldown=0.0)
    else:
        o["pulldown"] = float(rng.random() * 0.5)
    plan = str(rng.choice(plans))
    if o["low_delay"]:
        plan = plan.replace("B", "P")
    return plan, True, o


@pytest.mark.parametrize("seed", range(200))
def test_random_streams_read_as_cv2(tmp_path, capfd, seed):
    """Random legal syntax as a raw stream: cv2's frames, as many, 0 levels
    off (a frame flagged interlaced shows as cv2 shows it: the last frame it
    converted)."""
    plan, is2, options = random_case(seed)
    stream = syn.write_stream(seed, plan, mpeg2=is2, **options)
    path = tmp_path / "s.m2v"
    path.write_bytes(stream.data)
    theirs = cv2_frames(path, capfd)
    location = swscale.LEFT if is2 else swscale.CENTER
    ours = [ycbcr_to_rgb(*p, location=location) for p in mpeg2.decode_stream(stream.data)]
    assert len(ours) == len(theirs) == len(syn.coded_kinds(plan))
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert np.array_equal(a, b), f"seed {seed}: frame {i}"


def test_writer_covers_the_syntax():
    """The 200 random streams draw every tool the decoder reads."""
    stats: Counter = Counter()
    for seed in range(200):
        plan, is2, options = random_case(seed)
        stats.update(syn.write_stream(seed, plan, mpeg2=is2, **options).stats)
    wanted = (["load_intra", "load_inter", "quant_ext_intra", "quant_ext_inter",
               "quant_ext_chroma_intra", "quant_ext_chroma_inter", "closed_gop", "open_gop",
               "q_nonlinear", "b15", "alt_scan", "concealment_mv", "frame_pred_0", "dct_type",
               "mt_frame", "mt_field_in_frame", "mt_dual_prime", "P_no_mc", "P_intra",
               "B_intra", "P_coded", "P_not_coded", "B_coded", "B_not_coded", "skipped_P",
               "skipped_B", "mb_quant", "esc8", "esc16", "esc12", "first_1s", "full_pel",
               "stuffing", "slice_extra", "slice_mid_row", "rff", "incr_escape"]
              + [f"dc_prec{k}" for k in range(4)] + [f"dc_size{k}" for k in range(12)]
              + [f"fcode{k}" for k in range(1, 8)])
    assert not [k for k in wanted if not stats[k]], [k for k in wanted if not stats[k]]


# ── a stream's start, through program streams ───────────────

@pytest.mark.parametrize("case", ["p_first", "open_gop_leading_b", "no_sequence_header",
                                  "closed_gop_b"])
def test_stream_start_as_cv2(tmp_path, capfd, case):
    """A stream that starts at a P picture after its sequence header (FFmpeg
    predicts it from its grey picture and shows it with the next
    reference), an open GOP's leading B pictures (not decoded), packets
    before the first sequence header (a capture cut mid-GOP: dropped), a
    closed GOP's B pictures after the first I: cv2's frames and count."""
    plan = {"p_first": "PPBBPB", "open_gop_leading_b": "oIBBPBB|IPB",
            "no_sequence_header": "IPBBPBB|IPBB", "closed_gop_b": "IBBPBB"}[case]
    stream = syn.write_stream(7, plan, mpeg2=True, width=48, height=32)
    packets, kinds = stream.packets, syn.coded_kinds(plan)
    if case == "no_sequence_header":
        packets, kinds = packets[1:], kinds[1:]
    path = syn.write_ps(tmp_path / "s.mpg", packets, reorder=kinds, mpeg1=False)
    theirs = cv2_frames(path, capfd)
    reader = tvideo._own_reader(path)
    assert len(reader) == len(theirs) > 0
    for i, b in enumerate(theirs):
        assert np.array_equal(reader.rgb(i), b), f"{case}: frame {i}"
    shown = {"p_first": 6, "open_gop_leading_b": 7, "no_sequence_header": 4,
             "closed_gop_b": 6}[case]
    assert len(theirs) == shown


def test_random_access_equals_sequential():
    """Frames read at random restart at an I picture after a sequence header
    and equal a sequential read, across an open GOP's leading B pictures."""
    path = CORPUS / "mpg2_cv2.mpeg"
    n = len(tvideo._own_reader(path))
    seq = [tvideo._own_reader(path).rgb(i) for i in range(n)]
    reader = tvideo._own_reader(path)
    for i in list(np.random.default_rng(0).permutation(n)) + list(range(n - 1, -1, -1)):
        assert np.array_equal(reader.rgb(int(i)), seq[int(i)])
    assert len(reader.starts) >= 2


# ── the JAX package ─────────────────────────────────────────

@pytest.mark.parametrize("target", [0, 512])
@pytest.mark.parametrize("name", ["mpg2_cv2.mpg", "syn_interlaced.ts"])
def test_extract_frames_as_in_the_jax_package(tmp_path, capfd, name, target):
    """The port's probe_video and extract_frames against the JAX package's
    (cv2): equal probe, as many frames, PNGs of equal pixels."""
    path = CORPUS / name if name in MANIFEST["files"] else make_stream(name, tmp_path)
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    ours = tvideo.extract_frames(path, tmp_path / "ours", target_size=target)
    theirs = jvideo.extract_frames(path, tmp_path / "theirs", target_size=target)
    capfd.readouterr()
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert np.array_equal(tvideo.read_image(a), tvideo.read_image(b))


# ── the tables ──────────────────────────────────────────────

def test_tables_are_libavcodecs():
    """Tables B.14 / B.15 (uint16 pairs, escape and end of block last), the
    run and level of their codes (int8), the macroblock increment, pattern,
    motion and macroblock_type codes (uint8 pairs), the DC size codes
    (uint16) and lengths (uint8), the non-linear quantiser scale and the
    scans (uint8) and the default intra matrix (uint16) are byte strings of
    the libavcodec that cv2 bundles."""
    lib = libavcodec()
    t = mpeg2_tables
    for values, dtype in ((t.B14, "<u2"), (t.B15, "<u2"), (t.RUN, "i1"), (t.LEVEL, "i1"),
                          (t.MB_INCREMENT, "u1"), (t.CBP, "u1"), (t.MOTION, "u1"),
                          (t.MB_TYPE_P, "u1"), (t.MB_TYPE_B, "u1"), (t.DC_LUMA[:, 0], "<u2"),
                          (t.DC_LUMA[:, 1], "u1"), (t.DC_CHROMA[:, 0], "<u2"),
                          (t.DC_CHROMA[:, 1], "u1"), (t.NON_LINEAR_QSCALE, "u1"),
                          (t.ZIGZAG, "u1"), (t.ALTERNATE, "u1"),
                          (t.DEFAULT_INTRA_MATRIX, "<u2")):
        assert np.asarray(values).astype(dtype).tobytes() in lib


@pytest.mark.parametrize("name", ["B14", "B15", "MB_INCREMENT", "CBP", "MOTION", "DC_LUMA",
                                  "DC_CHROMA", "MB_TYPE_P", "MB_TYPE_B", "DMVECTOR"])
def test_tables_are_prefix_codes(name):
    """No code of a table is a prefix of another (the decoder reads each
    through one 16-bit lookup)."""
    codes = [format(int(c), f"0{int(n)}b") for c, n in getattr(mpeg2_tables, name)]
    assert max(len(c) for c in codes) <= 16
    for a in codes:
        assert not [b for b in codes if b != a and b.startswith(a)], a
    assert len(set(codes)) == len(codes)


# ── refused by name ─────────────────────────────────────────

def _ps(tmp_path, stream, plan, name="r.mpg") -> Path:
    return syn.write_ps(tmp_path / name, stream.packets, reorder=syn.coded_kinds(plan),
                        mpeg1=not stream.mpeg2)


def _patched(data: bytes, code: bytes, at: int, mask: int, value: int) -> bytes:
    """data with bits `mask` of byte `at` after the first start code `code`
    set to `value`."""
    k = data.index(code) + len(code) + at
    return data[:k] + bytes([data[k] & ~mask | value]) + data[k + 1:]


REFUSALS = {
    "field pictures": ("field pictures", lambda: syn.write_stream(
        1, "I[IP]P", progressive=False).data),
    "first frame flagged interlaced": ("first frame is flagged interlaced", lambda:
                                       syn.write_stream(1, "IPB", progressive=False,
                                                        flag_progressive=False,
                                                        interlaced_first=True).data),
    "4:2:2": ("4:2:2", lambda: _patched(syn.write_stream(1, "IP").data,
                                        b"\x00\x00\x01\xb5", 1, 0x06, 0x04)),
    "scalable extension": ("scalable extension", lambda: (lambda d: d.replace(
        b"\x00\x00\x01\xb8", b"\x00\x00\x01\xb5\x50\x00\x00\x00\x00\x00\x01\xb8", 1))(
        syn.write_stream(1, "IP").data)),
    "D-pictures": ("D-pictures", lambda: _patched(syn.write_stream(1, "I", mpeg2=False).data,
                                                  b"\x00\x00\x01\x00", 1, 0x38, 0x20)),
    "size change": ("changes the picture size", lambda: syn.write_stream(
        1, "IP").data + syn.write_stream(2, "IP", width=32).data),
    "pulldown in a program stream": ("repeat_first_field", lambda: syn.write_stream(
        4, "IPBBPBB", pulldown=1.0, frame_rate_code=4).data),
    "TMPGEXS": ("TMPGEXS", lambda: (lambda d: d.replace(
        b"\x00\x00\x01\xb8", b"\x00\x00\x01\xb2TMPGEXS\x00\x00\x00\x01\xb8", 1))(
        syn.write_stream(1, "IP").data)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refused_by_name(tmp_path, case):
    """Each case FFmpeg decodes in a way the port does not follow raises
    `UnsupportedCodecError` naming it, from a program stream's reader, before
    any decode, and from the decoder of the raw stream."""
    words, make = REFUSALS[case]
    data = make()
    packets = mpeg2.split_stream(data)
    path = syn.write_ps(tmp_path / "r.mpg", packets, mpeg1=False)
    with pytest.raises(container.UnsupportedCodecError, match=words):
        tvideo.probe_video(path)
        tvideo.extract_frames(path, tmp_path / "out")
    if case != "pulldown in a program stream":       # a raw stream's fps is not read
        with pytest.raises(container.UnsupportedCodecError, match=words):
            mpeg2.decode_stream(data)


def test_vector_past_the_edge_refused(tmp_path):
    """A vector that reaches past the picture (FFmpeg skips its prediction
    and shows the buffer's old bytes): the decoder raises naming it."""
    w = syn.Writer(3, width=32, height=32, skip=0, intra=0, far=1.0, f_code=(3,))
    w._inside = lambda *a: True                     # every vector allowed
    stream_bytes = []
    for plan in ("I", "P", "P"):
        bw = syn.BitWriter()
        if plan == "I":
            w.sequence(bw)
            w.gop(bw, True)
        w.picture(bw, plan, syn.FRAME, False, 1, plan != "I", False)
        stream_bytes.append(bw.bytes())
    with pytest.raises(container.UnsupportedCodecError, match="past the picture's edge"):
        mpeg2.decode_stream(b"".join(stream_bytes))


def test_raw_elementary_streams_refused(tmp_path, capfd):
    """cv2 reads a raw `.m1v` / `.m2v` with fps 25 and a frame count that do
    not follow from the stream (0.0, or -1.92e14 for MPEG-2): refused by
    name."""
    for suffix, is2 in ((".m1v", False), (".m2v", True)):
        path = tmp_path / f"s{suffix}"
        path.write_bytes(syn.write_stream(1, "IPBB", mpeg2=is2).data)
        assert len(cv2_frames(path, capfd)) == 4
        with pytest.raises(container.UnsupportedCodecError, match="elementary stream"):
            tvideo.probe_video(path)


@pytest.mark.parametrize("fourcc", [b"VCR2", b"slif"])
def test_avi_fourccs_refused(fourcc):
    """AVI's MPEG fourccs FFmpeg decodes its own way (VCR2's swapped chroma,
    SLIF's first slice) are refused by name; cv2's own are read."""
    with pytest.raises(container.UnsupportedCodecError, match=fourcc.decode()):
        container.avi_codec(fourcc, b"", "x")
    for ok in (b"mpg1", b"mpg2", b"MPG2", b"PIM1"):
        assert container.avi_codec(ok, b"", "x")["codec"] == "mpeg2"


def test_missing_slice_raises(tmp_path):
    """A picture with a slice missing, which FFmpeg conceals: ValueError
    naming the macroblock no slice covers."""
    data = syn.write_stream(1, "IP", width=32, height=48).data
    starts = [i for i in range(len(data) - 3) if data[i:i + 3] == b"\x00\x00\x01"
              and data[i + 3] == 2]
    cut = data[:starts[0]] + data[data.index(b"\x00\x00\x01\x03", starts[0]):]
    with pytest.raises(ValueError, match="in no slice"):
        mpeg2.decode_stream(cut)


FUZZ = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
from collections import Counter
from omfs4d_torch.io import container, mpeg2
from tests import torch_mpeg2_syntax as syn

rng = np.random.default_rng(0)
kinds = Counter()
for seed in range(40):
    s = syn.write_stream(seed, "IPBBPB", mpeg2=bool(seed % 2), width=48, height=32,
                         progressive=seed % 3 != 0)
    data = bytearray(s.data)
    for _ in range(int(rng.integers(1, 20))):
        data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
    if seed % 5 == 0:
        data = data[:int(rng.integers(10, len(data)))]
    try:
        mpeg2.decode_stream(bytes(data))
        kinds["ok"] += 1
    except ValueError:
        kinds["error"] += 1
    except container.UnsupportedCodecError:
        kinds["refused"] += 1
print(dict(kinds))
"""


def test_decoder_fuzz_never_crashes():
    """Garbled and truncated streams in a child process: each decodes or
    raises ValueError / UnsupportedCodecError; the process never crashes."""
    script = FUZZ.format(root=str(Path(__file__).resolve().parent.parent))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    kinds = eval(res.stdout.strip().splitlines()[-1])
    assert kinds.get("error", 0) > 0 and sum(kinds.values()) == 40


def test_parse_headers_and_rate():
    """The sequence header's size, rate (frame_rate_code with the
    extension), profile and colour description."""
    s = syn.write_stream(1, "IP", width=720, height=576, frame_rate_code=4,
                         colour=(1, 1, 1))
    p = mpeg2.parse_headers(s.data)
    assert (p["width"], p["height"], p["mpeg2"], p["matrix"]) == (720, 576, True, 1)
    assert p["rate"] == mpeg2.Fraction(30000, 1001) and p["colour_description"]
    m1 = mpeg2.parse_headers(syn.write_stream(1, "I", mpeg2=False).data)
    assert not m1["mpeg2"] and m1["rate"] == 25
    assert mpegps.probe(b"\x00\x00\x01\xb3" + bytes(4000)) is False


def test_no_jax_covers_the_mpeg2_modules():
    """The import check of the port (`test_torch_no_jax.py`) walks the new
    modules."""
    from tests.test_torch_no_jax import port_modules
    assert {"omfs4d_torch.io.mpeg2", "omfs4d_torch.io.mpeg2_tables",
            "omfs4d_torch.io.mpegps"} <= set(port_modules())
