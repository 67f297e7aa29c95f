"""The port's reading of Microsoft's MPEG-4 family (`omfs4d_torch/io/msmpeg4.py`,
the host decoder `msmpeg4dec.cpp`, its tables `msmpeg4_tables.py`) on the
CPU, held to cv2 5.0.0 (libavcodec 62.28.101):

- The committed corpus (`tests/data/msmpeg4/`: cv2's `WMV1`, `WMV2`, `MP42`
  and `MP43` / `DIV3` writers into ASF `.wmv`, AVI and Matroska, one clip
  asked for at 97x63, a 1080p `.wmv` of WMV2 and of MP43, and cv2's `MJPG`,
  `mp4v`, `VP80` and `MPG2` in `.wmv`) and the writer's streams of the
  manifest: every frame's SHA-256 and `probe_video` (width, height, fps,
  frame_count) equal cv2's.
- 200 random legal-syntax streams (`tests/torch_msmpeg4_syntax.py`) of the
  four versions in AVI and in ASF's three payload layouts: 0 levels off
  cv2, as many frames, equal probes; every tool the decoder reads drawn
  over the 200.
- A stream's start: a WMV2 stream from a P picture (FFmpeg's grey
  reference), a whole-skipped WMV2 picture (no frame), random access.
- The JAX package's `extract_frames` and the port's on a committed `.wmv`
  and an AVI, at target_size 0 and 512: equal PNGs.
- The tables are libavcodec's bytes and prefix codes.
- Refused by name: WMV2's IntraX8 pictures, MS MPEG-4 v1, WMV 9 / VC-1,
  WMV2 without its extradata, a v2 / v3 / WMV1 stream that starts at a P
  picture; garbled streams in a child process raise and never crash.
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
from omfs4d_torch.io import container, msmpeg4, msmpeg4_tables
from omfs4d_torch.io import video as tvideo
from tests import torch_msmpeg4_syntax as syn
from tests.make_msmpeg4_corpus import make_stream
from tests.test_torch_mpeg4 import libavcodec

CORPUS = Path(__file__).resolve().parent / "data" / "msmpeg4"
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


def cv2_read(path, capfd=None) -> tuple[list[np.ndarray], dict]:
    """cv2's RGB frames of a file and its probe."""
    cap = cv2.VideoCapture(str(path))
    probe = {"width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
             "fps": cap.get(cv2.CAP_PROP_FPS),
             "frame_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        out.append(np.ascontiguousarray(bgr[..., ::-1]))
    cap.release()
    if capfd is not None:
        capfd.readouterr()
    return out, probe


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
    """The corpus covers the four versions in the three containers, the
    other codecs cv2 writes into `.wmv`, the 1080p clips and cv2's count of
    21 for its 20 MPEG-2 frames in ASF, and stays under 1 MiB."""
    files = MANIFEST["files"]
    for tag in ("wmv1", "wmv2", "mp42", "mp43"):
        assert {f"{tag}_cv2.{ext}" for ext in ("wmv", "avi", "mkv")} <= set(files)
    assert {e["fourcc"] for e in files.values()} >= {"WMV1", "WMV2", "MP42", "MP43", "DIV3",
                                                     "MJPG", "mp4v", "VP80", "MPG2"}
    codecs = {n: container.index(CORPUS / n)[2] for n in files}
    assert {codecs[f"{t}_cv2.wmv"]["container"] for t in ("wmv1", "mjpg", "vp80")} == {"asf"}
    assert codecs["mpg2_cv2.wmv"]["codec"] == "mpeg2"
    assert len(files["mpg2_cv2.wmv"]["sha256"]) == 20
    assert files["mpg2_cv2.wmv"]["probe"]["frame_count"] == 21
    assert files["wmv2_1080p.wmv"]["probe"]["height"] == 1080
    assert {codecs[n]["version"] for n in files if codecs[n]["codec"] == "msmpeg4"} == {
        msmpeg4.V2, msmpeg4.V3, msmpeg4.WMV1, msmpeg4.WMV2}
    assert sum(p.stat().st_size for p in CORPUS.iterdir()) < 1 << 20


# ── random streams ──────────────────────────────────────────

LAYOUTS = ("single", "multiple", "compressed")


def random_case(seed: int) -> tuple[int, str, dict, dict]:
    """(version, plan, options, mux) of random stream `seed`: the four
    versions in turn, in AVI or ASF (each layout), sizes odd and even."""
    rng = np.random.default_rng(10_000 + seed)
    version = (syn.V2, syn.V3, syn.WMV1, syn.WMV2)[seed % 4]
    plan = str(rng.choice(["IPPP", "IPPPIPP", "IPIP", "IIPP"]))
    o = {"width": int(rng.choice([16, 33, 48, 64, 80])),
         "height": int(rng.choice([16, 17, 32, 47, 48])),
         "escape": float(rng.random() * 0.4), "ac_pred": float(rng.random() * 0.6),
         "intra": float(rng.random() * 0.3), "skip": float(rng.random() * 0.5),
         "spread": int(rng.choice([2, 6, 20])), "coefs": int(rng.integers(2, 9))}
    if version == syn.WMV1:
        o["bit_rate"] = int(rng.choice([20, 60, 200]))
    mux = {"container": "avi"} if seed % 2 else {
        "container": "asf", "layout": LAYOUTS[seed // 2 % 3],
        "packet_size": int(rng.choice([300, 512, 1024])),
        "padding_type": int(rng.choice([1, 2]))}
    return version, plan, o, mux


@pytest.mark.parametrize("seed", range(200))
def test_random_streams_read_as_cv2(tmp_path, capfd, seed):
    """Random legal syntax: cv2's frames, as many, 0 levels off, and cv2's
    probe."""
    version, plan, options, mux = random_case(seed)
    path = syn.make_file(tmp_path / ("s.avi" if mux["container"] == "avi" else "s.wmv"),
                         seed, version, plan, options, mux)
    theirs, probe = cv2_read(path, capfd)
    reader = tvideo._own_reader(path)
    assert tvideo.probe_video(path) == probe
    assert len(reader) == len(theirs) == len(plan)
    for i, b in enumerate(theirs):
        assert np.array_equal(reader.rgb(i), b), f"seed {seed}: frame {i}"


def test_writer_covers_the_syntax():
    """The 200 random streams draw every tool the decoder reads."""
    stats: Counter = Counter()
    for seed in range(200):
        version, plan, options, _ = random_case(seed)
        stats.update(syn.write_stream(seed, version, plan, **options).stats)
    wanted = (["direct", "esc1", "esc2", "esc3", "dc_escape", "mv_escape", "skipped",
               "intra_mb_P", "inter_mb", "ac_pred_1", "per_mb_rl", "flipflop_1", "q_lt8",
               "q_ge8", "inter_intra_1", "mspel_1", "hshift_1", "top_left_0", "top_left_1",
               "ext_loop_filter_1", "ext_j_type_bit_1"]
              + [f"dc_table_{k}" for k in range(2)] + [f"mv_table_{k}" for k in range(2)]
              + [f"slices_{k}" for k in range(1, 4)] + [f"wmv2_slices_{k}" for k in (1, 2, 3)]
              + [f"skip_type_{k}" for k in range(4)] + [f"cbp_index_{k}" for k in range(3)]
              + [f"aic_dir_{k}" for k in range(4)]
              + [f"abt_{t}_sub_{s}" for t in (1, 2) for s in (1, 2, 3)]
              + [f"abt_picture_{k}" for k in range(3)] + [f"abt_mb_{k}" for k in (1, 2)]
              + [f"abt_block_{k}" for k in range(3)]
              + [f"esc3_level_len_{k}" for k in range(2, 9)])
    assert not [k for k in wanted if not stats[k]], [k for k in wanted if not stats[k]]


# ── a stream's start ────────────────────────────────────────

@pytest.mark.parametrize("plan", ["PPIPP", "IPSPP", "PSIP"])
def test_wmv2_start_and_skipped_pictures_as_cv2(tmp_path, capfd, plan):
    """WMV2 from a P picture (FFmpeg predicts it from its grey picture) and
    pictures whose skip map skips every MB by rows (FFmpeg shows no frame,
    the container counts it): cv2's frames and count."""
    path = syn.make_file(tmp_path / "s.avi", 3, syn.WMV2, plan, {"width": 48, "height": 32},
                         {"container": "avi"})
    theirs, probe = cv2_read(path, capfd)
    reader = tvideo._own_reader(path)
    assert len(theirs) == len(reader) == len(plan.replace("S", ""))
    assert tvideo.probe_video(path) == probe and probe["frame_count"] == len(plan)
    for i, b in enumerate(theirs):
        assert np.array_equal(reader.rgb(i), b), f"{plan}: frame {i}"


@pytest.mark.parametrize("version", [syn.V2, syn.V3, syn.WMV1])
def test_p_picture_first_refused(tmp_path, version):
    """A v2 / v3 / WMV1 stream that starts at a P picture: FFmpeg has no
    slice height yet and conceals it; refused by name."""
    path = syn.make_file(tmp_path / "s.avi", 4, version, "PPIPP", {"width": 48, "height": 32},
                         {"container": "avi"})
    with pytest.raises(container.UnsupportedCodecError, match="first picture is a P picture"):
        tvideo.extract_frames(path, tmp_path / "out")


def test_random_access_equals_sequential(tmp_path):
    """Frames read at random restart at an I picture and equal a sequential
    read."""
    path = make_stream("syn_wmv2.wmv", tmp_path)
    n = len(tvideo._own_reader(path))
    seq = [tvideo._own_reader(path).rgb(i) for i in range(n)]
    reader = tvideo._own_reader(path)
    for i in list(np.random.default_rng(0).permutation(n)) + list(range(n - 1, -1, -1)):
        assert np.array_equal(reader.rgb(int(i)), seq[int(i)])
    assert len(reader.starts) >= 2


# ── the JAX package ─────────────────────────────────────────

@pytest.mark.parametrize("target", [0, 512])
@pytest.mark.parametrize("name", ["wmv2_cv2.wmv", "mp43_cv2.avi", "wmv1_cv2.mkv"])
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


# ── the tables ──────────────────────────────────────────────

def test_tables_are_libavcodecs():
    """Every table of msmpeg4_tables is a byte string of the libavcodec that
    cv2 bundles: the MB, DC, run-level (codes uint16 pairs, run and level
    int8) and MV tables (lengths uint8, symbols uint16), the scans, the DC
    scales, the loop filter's strengths, `ff_inverse`."""
    lib = libavcodec()
    t = msmpeg4_tables
    for values, dtype in ((t.MB_I, "<u2"), (t.V2_INTRA_CBPC, "u1"), (t.V2_MB_TYPE, "u1"),
                          (t.INTER_INTRA, "u1"), (t.WMV1_SCANS, "u1"), (t.WMV2_SCAN_A, "u1"),
                          (t.WMV2_SCAN_B, "u1"), (t.DC_SCALE_V3_LUMA, "u1"),
                          (t.DC_SCALE_WMV_LUMA, "u1"), (t.DC_SCALE_WMV_CHROMA, "u1"),
                          (t.LOOP_FILTER_STRENGTH, "u1"), (t.INVERSE, "<u4")):
        assert np.asarray(values).astype(dtype).tobytes() in lib
    for k in range(4):
        assert t.MB_NON_INTRA[k].astype("<u4").tobytes() in lib
    for table in t.DC.reshape(4, 120, 2):
        assert table.astype("<u4").tobytes() in lib
    for rl in t.RL:
        for values, dtype in ((rl["codes"], "<u2"), (rl["run"], "i1"), (rl["level"], "i1")):
            assert values.astype(dtype).tobytes() in lib
    for lens, syms in t.MV_TABLES:
        assert lens.astype("u1").tobytes() in lib and syms.astype("<u2").tobytes() in lib


def _codes(name: str) -> list[list[tuple[int, int]]]:
    t = msmpeg4_tables
    if name == "MV":
        return [list(zip(t.mv_codes(lens).tolist(), lens.tolist())) for lens, _ in t.MV_TABLES]
    if name == "RL":
        return [[tuple(c) for c in rl["codes"].tolist()] for rl in t.RL]
    table = np.asarray(getattr(t, name))
    return [[tuple(c) for c in sub] for sub in table.reshape(-1, table.shape[-2], 2).tolist()]


@pytest.mark.parametrize("name", ["MB_I", "MB_NON_INTRA", "V2_INTRA_CBPC", "V2_MB_TYPE",
                                  "INTER_INTRA", "DC", "V2_DC", "RL", "MV"])
def test_tables_are_prefix_codes(name):
    """No code of a table is a prefix of another, and each table but v2's DC
    and the run-level ones (one of which leaves 1/512 of its codes unused)
    is complete: its lengths' Kraft sum is 1."""
    from fractions import Fraction

    for codes in _codes(name):
        bits = sorted(format(c, f"0{n}b") for c, n in codes if n)
        assert all(not b.startswith(a) for a, b in zip(bits, bits[1:]))
        kraft = sum(Fraction(1, 1 << n) for c, n in codes if n)
        assert kraft == 1 or (name in ("V2_DC", "RL") and kraft < 1)


# ── refused by name ─────────────────────────────────────────

def test_intrax8_refused(tmp_path):
    """A WMV2 I picture with j_type 1 (IntraX8, FFmpeg's intrax8.c):
    `UnsupportedCodecError` naming it, when the file is opened."""
    s = syn.write_stream(1, syn.WMV2, "IP", width=48, height=32, j_type_bit=1)
    first = bytearray(s.packets[0])
    first[1] |= 0x04                         # type 1, code 7, qscale 5: j_type is bit 13
    s.packets[0] = bytes(first)
    path = syn.write_avi(tmp_path / "x8.avi", s)
    with pytest.raises(container.UnsupportedCodecError, match="IntraX8"):
        tvideo.probe_video(path)
        tvideo.extract_frames(path, tmp_path / "out")
    with pytest.raises(container.UnsupportedCodecError, match="IntraX8"):
        msmpeg4.Host(msmpeg4.WMV2, 48, 32, s.extradata).decode(s.packets[0])


@pytest.mark.parametrize("fourcc,words", [(b"MPG4", "MS MPEG-4 v1"), (b"DIV1", "MS MPEG-4 v1"),
                                          (b"WMV3", "VC-1"), (b"WVC1", "VC-1"),
                                          (b"HFYU", "HuffYUV"), (b"FFV1", "FFV1"),
                                          (b"I420", "I420"), (b"FLV1", "FLV")])
def test_other_fourccs_refused(fourcc, words):
    """Microsoft's other codecs, and the others still open, raise naming
    them; the family's own tags are read with their version.  HuffYUV, FFV1
    and raw I420, once refused here, are read now
    (`tests/test_torch_huffyuv.py`, `test_torch_ffv1.py`,
    `test_torch_rawvideo.py`)."""
    read_now = {b"HFYU": "huffyuv", b"FFV1": "ffv1", b"I420": "raw"}
    if fourcc in read_now:
        assert container.avi_codec(fourcc, b"", "x", bits=24)["codec"] == read_now[fourcc]
        return
    with pytest.raises(container.UnsupportedCodecError, match=words):
        container.avi_codec(fourcc, b"", "x")
    for tag, version in ((b"MP42", 2), (b"DIV2", 2), (b"MP43", 3), (b"DIV3", 3), (b"DIV4", 3),
                         (b"DIV5", 3), (b"DIV6", 3), (b"MPG3", 3), (b"AP41", 3), (b"COL1", 3),
                         (b"DVX3", 3), (b"WMV1", 4), (b"wmv2", 5)):
        assert container.avi_codec(tag, b"", "x")["version"] == version


def test_wmv2_without_extradata_refused(tmp_path):
    """WMV2 needs its 4-byte extended header: FFmpeg refuses the stream
    without it, and so does the port, by name."""
    s = syn.write_stream(1, syn.WMV2, "IP", width=48, height=32)
    s.extradata = b""
    path = syn.write_avi(tmp_path / "w.avi", s)
    with pytest.raises(container.UnsupportedCodecError, match="extended header"):
        tvideo.probe_video(path)


FUZZ = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
from collections import Counter
from omfs4d_torch.io import container, msmpeg4
from tests import torch_msmpeg4_syntax as syn

rng = np.random.default_rng(0)
kinds = Counter()
for seed in range(60):
    version = (2, 3, 4, 5)[seed % 4]
    s = syn.write_stream(seed, version, "IPPIP", width=48, height=32)
    host = msmpeg4.Host(version, 48, 32, s.extradata)
    for k, packet in enumerate(s.packets):
        data = bytearray(packet)
        for _ in range(int(rng.integers(1, 8))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        if seed % 5 == 0:
            data = data[:int(rng.integers(1, len(data)))]
        try:
            host.decode(bytes(data))
            kinds["ok"] += 1
        except container.UnsupportedCodecError:
            kinds["refused"] += 1
            host = msmpeg4.Host(version, 48, 32, s.extradata)
        except ValueError:
            kinds["error"] += 1
            host = msmpeg4.Host(version, 48, 32, s.extradata)
print(dict(kinds))
"""


def test_decoder_fuzz_never_crashes():
    """Garbled and truncated pictures in a child process: each decodes or
    raises ValueError / UnsupportedCodecError; the process never crashes."""
    script = FUZZ.format(root=str(Path(__file__).resolve().parent.parent))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    kinds = eval(res.stdout.strip().splitlines()[-1])
    assert kinds.get("error", 0) > 0 and sum(kinds.values()) == 300


def test_no_jax_covers_the_msmpeg4_modules():
    """The import check of the port (`test_torch_no_jax.py`) walks the new
    modules."""
    from tests.test_torch_no_jax import port_modules
    assert {"omfs4d_torch.io.msmpeg4", "omfs4d_torch.io.msmpeg4_tables",
            "omfs4d_torch.io.asf"} <= set(port_modules())
