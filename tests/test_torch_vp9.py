"""VP9 read by the port as cv2 reads it, on the CPU, with no ffmpeg: every
frame equal to `cv2.VideoCapture`'s bit for bit (0 levels), and
`probe_video` equal to cv2's (width, height, fps, CAP_PROP_FRAME_COUNT).

- The committed corpus (`tests/data/vp9/`, `tests/make_vp9_corpus.py`):
  cv2's own `VP90` clips in WebM, Matroska (asked for at an odd size; cv2's
  writer rounds it to even), AVI and MP4, and a 1080p one with four tile
  columns; the tests' writer's streams (`tests/torch_vp9_syntax.py`)
  re-made from their seeds, byte for byte: backward adaptation, hidden
  alt-refs in superframes shown again by show_existing_frame, intra-only
  frames, segmentation with tile rows and columns, lossless, a browser's
  recording layout (no DefaultDuration, no Duration) and a realtime and a
  two-pass layout at 1080p.  Each to its manifest and to cv2.
- 200 random streams from the writer against cv2, in WebM, Matroska and
  AVI, and what they cover (`test_writer_covers_the_syntax`).
- What FFmpeg does, followed: a stream cut mid-GOP or at an intra-only frame
  (cv2 reads nothing), show_existing_frame of a slot never filled, a frame
  whose compressed header or tiles run past its packet (cv2 stops there),
  an empty block, the colour bits with and without a container's Colour,
  the same frames with one frame thread and with many.  Refused by name: a
  key frame that changes the size, references of another size (scaled
  motion compensation), profiles 1-3, color_space 6, a superframe index
  whose sizes run past its packet (cv2's count then depends on its threads).
- The port's `extract_frames` against the JAX package's on a WebM.
- The tables are libvpx's and libavcodec's bytes (where opencv-python
  bundles them).
- A fuzz in a child process: truncated and garbled frames decode or raise
  ValueError, and never crash.
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
from omfs4d_torch.io import container, vp9, vp9_tables
from omfs4d_torch.io import video as tvideo
from tests import torch_mkv_mux as mux
from tests import torch_vp9_syntax as syn
from tests.make_vp9_corpus import make_stream
from tests.test_torch_matroska import read_as_cv2
from tests.test_torch_mpeg4 import libavcodec

CORPUS = Path(__file__).resolve().parent / "data" / "vp9"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setattr(jvideo, "find_ffmpeg", lambda: None)


def hashes(path) -> list[str]:
    frames = tvideo._own_reader(Path(path))
    return [hashlib.sha256(frames.rgb(i).tobytes()).hexdigest() for i in range(len(frames))]


def muxed(tmp_path, packets: list[bytes], width: int, height: int, name: str = "x.webm",
          **options) -> Path:
    """Packets in a WebM, the first a key frame."""
    options.setdefault("default_duration", 33333333)
    options.setdefault("duration_ms", len(packets) * 33)
    return mux.write_mkv(tmp_path / name, packets, [i == 0 for i in range(len(packets))],
                         [i * 33 for i in range(len(packets))], codec_id="V_VP9", width=width,
                         height=height, doc_type="webm", **options)


# ── the corpus ──────────────────────────────────────────────

@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_corpus_files_read_as_cv2(capfd, name):
    """cv2's own VP90 clips: the file's SHA-256, cv2's probe and frames, to
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


def test_corpus_stays_small():
    """The committed corpus is under 256 KiB, its 1080p clip under 100 KB."""
    assert sum(p.stat().st_size for p in CORPUS.iterdir()) < 256 * 1024
    assert (CORPUS / "clip_1080p.webm").stat().st_size <= 100_000


# ── random streams ──────────────────────────────────────────

PLANS = ("KPPPPP", "KPhPPiPePP", "KhPhPePEP", "KPPiPPhPPe", "KPPPKPPhP")


def random_case(seed: int) -> tuple[str, dict, str]:
    """The plan, options and container of random stream `seed`: sizes from
    8 to 139 by 8 to 99, one in 20 from 449 to 600 wide (two tile columns),
    about half with backward adaptation."""
    r = np.random.default_rng(seed)
    wide = seed % 20 == 7
    options = {"width": int(r.integers(449, 601) if wide else r.integers(8, 140)),
               "height": int(r.integers(8, 40) if wide else r.integers(8, 100)),
               "seg": int(r.integers(0, 2)), "big_tokens": int(r.random() < 0.3),
               "far_mv": int(r.choice([0, 100, 500])),
               "refresh_ctx": int(r.choice([700, 1000])), "parallel": int(r.choice([0, 400, 1000])),
               "error_res": int(r.choice([0, 100, 300])), "tile_rows": int(r.integers(0, 3)),
               "updates": int(r.choice([0, 30, 200]))}
    return PLANS[seed % len(PLANS)], options, ("webm", "mkv", "avi")[seed % 3]


def random_file(tmp_path, seed: int) -> Path:
    plan, options, kind = random_case(seed)
    stream = syn.write_stream(seed, plan, **options)
    if kind == "avi":
        return syn.write_avi(tmp_path / "s.avi", stream)
    return syn.write_webm(tmp_path / f"s.{kind}", stream,
                          doc_type="webm" if kind == "webm" else "matroska")


@pytest.mark.parametrize("seed", range(200))
def test_random_streams_read_as_cv2(tmp_path, capfd, seed):
    """Random legal syntax (what libvpx at cv2's settings never writes) in
    WebM, Matroska or AVI: 0 levels off cv2, its probe and count."""
    read_as_cv2(random_file(tmp_path, seed), capfd)


def test_writer_covers_the_syntax():
    """The 200 random streams draw backward adaptation, hidden frames,
    show_existing_frame, intra-only frames, compound prediction,
    segmentation with temporal update and its four features, tile columns and rows,
    lossless frames, every transform mode, filter, reset and context, the
    largest vector class and token category, sub-8x8 blocks, odd sizes."""
    stats: Counter = Counter()
    odd = 0
    for seed in range(200):
        plan, options, _ = random_case(seed)
        stats.update(syn.write_stream(seed, plan, **options).stats)
        odd += options["width"] % 2 and options["height"] % 2
    assert odd > 0
    for key in (["adapt", "parallel_save", "hidden", "show_existing", "intra_only", "lossless",
                 "error_res", "seg_temporal", "seg_q", "seg_lf", "seg_ref", "seg_skip",
                 "seg_no_map_update", "comp_select", "comp_only", "switchable", "hp", "lf_delta",
                 "sharpness", "tile_cols_log2", "tile_rows_log2", "mv_class10", "cat6",
                 "update"]
                + [f"tx_mode_{m}" for m in range(5)] + [f"filter_{f}" for f in range(4)]
                + [f"reset_{r}" for r in range(4)] + [f"ctx_idx_{c}" for c in range(4)]
                + [f"kind_{vp9_kind}" for vp9_kind in (KIND_SUB_MODE, KIND_KF_SUB_MODE,
                                                       KIND_SUB_INTER_MODE, KIND_COMP)]):
        assert stats[key] > 0, key


# kinds of vp9dec.cpp's enum Kind that the coverage test reads
_KINDS = ("K_MARKER K_PROFILE_LOW K_PROFILE_HIGH K_RESERVED K_SHOW_EXISTING K_EXISTING_IDX "
          "K_FRAME_TYPE K_SHOW_FRAME K_ERROR_RES K_SYNC K_COLOR_SPACE K_COLOR_RANGE "
          "K_WIDTH K_HEIGHT K_RENDER_DIFF K_RENDER_SIZE K_INTRA_ONLY K_RESET_CTX "
          "K_REFRESH_FLAGS K_REF_IDX K_SIGN_BIAS K_FOUND_REF K_HP K_FILTER_SWITCHABLE "
          "K_FILTER_LITERAL K_REFRESH_CTX K_PARALLEL K_CTX_IDX K_LF_LEVEL K_SHARPNESS "
          "K_LF_DELTA_ENABLED K_LF_DELTA_UPDATE K_LF_UPDATE K_LF_VALUE K_LF_SIGN K_BASE_Q "
          "K_DELTA_Q_CODED K_DELTA_Q K_DELTA_Q_SIGN K_SEG_ENABLED K_SEG_UPDATE_MAP "
          "K_SEG_PROB_CODED K_SEG_PROB K_SEG_TEMPORAL K_SEG_PRED_CODED K_SEG_PRED_PROB "
          "K_SEG_UPDATE_DATA K_SEG_ABS K_SEG_FEATURE K_SEG_VALUE K_SEG_SIGN K_TILE_COL_INC "
          "K_TILE_ROWS K_HEADER_SIZE K_TX_MODE K_TX_SELECT K_UPDATE K_COEF_UPDATE_ANY "
          "K_COMP_MODE K_COMP_SELECT K_PARTITION K_SPLIT_OR_HORZ K_SPLIT_OR_VERT K_SEG_ID "
          "K_SEG_PREDICTED K_SKIP K_TX_SIZE K_IS_INTER K_COMP K_COMP_REF K_SINGLE_REF1 "
          "K_SINGLE_REF2 K_KF_Y_MODE K_KF_SUB_MODE K_KF_UV_MODE K_Y_MODE K_SUB_MODE K_UV_MODE "
          "K_INTER_MODE K_SUB_INTER_MODE").split()
KIND_SUB_MODE, KIND_KF_SUB_MODE, KIND_SUB_INTER_MODE, KIND_COMP = (
    _KINDS.index(k) for k in ("K_SUB_MODE", "K_KF_SUB_MODE", "K_SUB_INTER_MODE", "K_COMP"))


def test_kind_numbers_are_the_decoders():
    """The kind numbers above are vp9dec.cpp's enum Kind."""
    source = Path(vp9.__file__).with_name("vp9dec.cpp").read_text()
    body = source[source.index("enum Kind {"):source.index("N_KINDS")]
    names = [w.strip(",") for w in body.split() if w.startswith("K_")]
    assert names[:len(_KINDS)] == _KINDS


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_frame_threads_do_not_change_cv2s_frames(tmp_path, capfd, seed):
    """cv2 with one frame thread and with its default: the same frames (the
    writer draws nothing whose colours or pictures depend on them)."""
    path = random_file(tmp_path, seed)
    one = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, [cv2.CAP_PROP_N_THREADS, 1])
    many = cv2.VideoCapture(str(path))
    while True:
        ok1, a = one.read()
        ok2, b = many.read()
        assert ok1 == ok2
        if not ok1:
            break
        assert np.array_equal(a, b)
    capfd.readouterr()


# ── what FFmpeg does ────────────────────────────────────────

def test_cut_streams_read_as_cv2(tmp_path, capfd):
    """A WebM that starts at an inter frame or at an intra-only frame (a
    recording cut): FFmpeg fails on its first inter frame and cv2 reads
    nothing, as the port; cut at a key frame, it reads on."""
    s = syn.write_stream(40, "KPPPKPPiPP")
    packets, keys = syn.packets(s)
    intra = next(i for i, p in enumerate(packets) if len(vp9.split_superframe(p)) > 1)
    for k, shown in ((2, 0), (4, len(packets) - 4), (intra, 0)):
        path = muxed(tmp_path, packets[k:], s.width, s.height, name=f"cut{k}.webm")
        assert len(read_as_cv2(path, capfd)) == shown
        assert (tvideo._own_reader(path).failed is None) == bool(shown)


def test_show_existing_of_an_empty_slot_reads_as_cv2(tmp_path, capfd):
    """A stream that starts at an intra-only frame: show_existing_frame of a
    slot it filled shows it, of one it did not FFmpeg fails on."""
    s = syn.write_stream(41, "KPiP")
    intra = next(f for f, k in zip(s.frames, s.kinds) if k == "i")
    mask = vp9.probe_frame(intra).refresh_flags
    filled = next(i for i in range(8) if mask >> i & 1)
    path = muxed(tmp_path, [syn.superframe([intra, bytes([0x88 | filled])])], s.width, s.height,
                 name="f.webm")
    assert len(read_as_cv2(path, capfd)) == 1
    if mask != 0xFF:
        empty = next(i for i in range(8) if not mask >> i & 1)
        path = muxed(tmp_path, [syn.superframe([intra, bytes([0x88 | empty])])], s.width,
                     s.height, name="e.webm")
        assert len(read_as_cv2(path, capfd)) == 0
        assert tvideo._own_reader(path).failed == (0, 7)


@pytest.mark.parametrize("cut", ["header", "byte", "tiles", "marker", "hidden_marker"])
def test_broken_frame_ends_the_video_as_in_cv2(tmp_path, capfd, cut):
    """A frame whose compressed header or tile sizes run past its packet (cut
    to its header, to one byte, into its tile sizes), or whose last byte
    looks like a superframe marker (its own, or a hidden frame's inside a
    superframe): FFmpeg fails on it and cv2 reads no further, as the port.
    Cut inside its last tile, FFmpeg decodes what it reads (zeros past the
    end) and cv2 shows it, as the port."""
    s = syn.write_stream(42, "KPPhPPP", width=520, height=48, tile_cols=1)
    packets, _ = syn.packets(s)
    f = packets[2]
    h = vp9.probe_frame(f, (s.width, s.height))
    assert h.tile_cols_log2 == 1
    edge = h.header_bytes + h.compressed_size
    sf = vp9.split_superframe(packets[3])
    packets[2], packets[3] = {
        "header": (f[:8], packets[3]), "byte": (f[:1], packets[3]),
        "tiles": (f[:edge + 2], packets[3]), "marker": (f + b"\xc1", packets[3]),
        "hidden_marker": (f, syn.superframe([sf[0] + b"\xd0", sf[1]]))}[cut]
    path = muxed(tmp_path, packets, s.width, s.height)
    where = 3 if cut == "hidden_marker" else 2
    assert len(read_as_cv2(path, capfd)) == where
    assert tvideo._own_reader(path).failed[0] == where
    packets[2] = f[:len(f) - 20]
    packets[3] = syn.superframe(sf)
    read_as_cv2(muxed(tmp_path, packets, s.width, s.height, name="last.webm"), capfd)


def test_empty_blocks_are_skipped_as_in_cv2(tmp_path, capfd):
    """An empty Matroska block: no frame, the rest read on."""
    s = syn.write_stream(43, "KPPPPP")
    packets, _ = syn.packets(s)
    packets[2] = b""
    path = muxed(tmp_path, packets, s.width, s.height)
    assert len(read_as_cv2(path, capfd)) == 5


@pytest.mark.parametrize("space, full", [(s, f) for s in range(6) for f in (0, 1)])
def test_colour_bits_read_as_cv2(tmp_path, capfd, space, full):
    """The key frame's color_space and color_range: FFmpeg tags the frames
    from them whatever the container's Colour says, as the port does."""
    s = syn.write_stream(44, "KPP", colour_space=space, full_range=full)
    read_as_cv2(syn.write_webm(tmp_path / "c.webm", s), capfd)
    read_as_cv2(syn.write_webm(tmp_path / "m.webm", s, colour={
        "matrix": 1, "range": 1, "transfer": 1, "primaries": 1}), capfd)


def test_reserved_colour_space_refused_by_name(tmp_path):
    """color_space 6 (reserved): FFmpeg's frame threads tag it differently,
    refused by name."""
    s = syn.write_stream(45, "KPP", colour_space=6)
    with pytest.raises(container.UnsupportedCodecError, match="color_space 6"):
        tvideo.probe_video(syn.write_webm(tmp_path / "r.webm", s))


def test_size_change_refused_by_name(tmp_path):
    """A key frame of another size: refused by name (cv2 goes on at the new
    size)."""
    a = syn.write_stream(46, "KPP")
    b = syn.write_stream(47, "KP", width=80, height=48)
    path = muxed(tmp_path, syn.packets(a)[0] + syn.packets(b)[0], a.width, a.height)
    with pytest.raises(container.UnsupportedCodecError, match="change of the picture's size"):
        tvideo.probe_video(path)


def test_scaled_references_refused_by_name(tmp_path):
    """An inter frame that codes a size other than its references' (which
    FFmpeg predicts from with scaled motion compensation): refused by name."""
    a = syn.write_stream(48, "KPP")
    b = syn.write_stream(49, "KPP", width=80, height=48, found_ref=0)
    path = muxed(tmp_path, syn.packets(a)[0] + syn.packets(b)[0][1:], a.width, a.height)
    with pytest.raises(container.UnsupportedCodecError, match="scaled motion compensation"):
        tvideo.probe_video(path)


@pytest.mark.parametrize("profile, bits", [(1, 0x20), (2, 0x10), (3, 0x30)])
def test_profiles_1_to_3_refused_by_name(tmp_path, profile, bits):
    """Profiles 1-3 (4:4:4, 4:2:2, 4:4:0, 10 and 12 bits): refused by name
    (profile 2 is queued)."""
    s = syn.write_stream(50, "KPP")
    packets, _ = syn.packets(s)
    packets[0] = bytes([packets[0][0] | bits]) + packets[0][1:]
    assert vp9.probe_frame(packets[0]).profile == profile
    path = muxed(tmp_path, packets, s.width, s.height)
    with pytest.raises(container.UnsupportedCodecError, match=f"VP9 profile {profile}"):
        tvideo.probe_video(path)


def test_superframe_index_past_its_packet_refused_by_name(tmp_path):
    """A superframe index whose sizes run past its packet: FFmpeg fails
    before its frame threads hand back their frames, so cv2's count depends
    on the host's cores; refused by name."""
    s = syn.write_stream(51, "KPhPP")
    packets, _ = syn.packets(s)
    k = next(i for i, p in enumerate(packets) if len(vp9.split_superframe(p)) > 1)
    bad = bytearray(packets[k])
    bad[-2] = 0xFF
    packets[k] = bytes(bad)
    assert vp9.split_superframe(packets[k]) is None
    path = muxed(tmp_path, packets, s.width, s.height)
    with pytest.raises(container.UnsupportedCodecError, match="superframe index"):
        tvideo.probe_video(path)


def test_random_access_equals_sequential(tmp_path):
    """Pictures read at random restart at key frames and equal a
    sequential read, show_existing_frame and hidden frames among them."""
    s = syn.write_stream(52, "KPhPPePKPPiPP")
    path = syn.write_webm(tmp_path / "r.webm", s)
    n = len(tvideo._own_reader(path))
    seq = [tvideo._own_reader(path).rgb(i) for i in range(n)]
    reader = tvideo._own_reader(path)
    for i in list(np.random.default_rng(0).permutation(n)) + list(range(n - 1, -1, -1)):
        assert np.array_equal(reader.rgb(int(i)), seq[int(i)])
    assert len(reader.starts) == 2


def test_extract_frames_as_in_the_jax_package(tmp_path, capfd):
    """The port's probe_video and extract_frames on a WebM against the JAX
    package's (cv2): equal probe, as many frames, 0 levels apart."""
    path = CORPUS / "clip_cv2.webm"
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    ours = tvideo.extract_frames(path, tmp_path / "ours")
    theirs = jvideo.extract_frames(path, tmp_path / "theirs")
    capfd.readouterr()
    assert len(ours) == len(theirs) == MANIFEST["files"]["clip_cv2.webm"]["probe"]["frame_count"]
    for a, b in zip(ours, theirs):
        assert np.array_equal(tvideo.read_image(a), tvideo.read_image(b))


# ── tables, probe, fuzz ─────────────────────────────────────

def _libvpx() -> bytes:
    libs = Path(cv2.__file__).resolve().parent.parent / "opencv_python.libs"
    found = sorted(libs.glob("libvpx*.so*")) if libs.is_dir() else []
    if not found:
        pytest.skip("no libvpx bundled with cv2")
    return found[0].read_bytes()


def test_tables_are_libvpxs():
    """The default coefficient, mode, partition and vector probabilities,
    the Pareto table, the scans with their neighbours, the bands, the
    quantisers and the filters are byte strings of the libvpx cv2 bundles."""
    lib = _libvpx()
    t = vp9_tables
    for values, dtype in ((t.COEF_PROBS[0], "u1"), (t.COEF_PROBS[1], "u1"),
                          (t.COEF_PROBS[2], "u1"), (t.COEF_PROBS[3], "u1"), (t.KF_YMODE_PROBS, "u1"),
                          (t.KF_UV_MODE_PROBS, "u1"), (t.YMODE_PROBS, "u1"),
                          (t.UV_MODE_PROBS, "u1"), (t.KF_PARTITION_PROBS, "u1"),
                          (t.PARTITION_PROBS, "u1"), (t.PARETO8, "u1"),
                          (t.INTERP_FILTER_PROBS, "u1"), (t.INTER_MODE_PROBS, "u1"),
                          (t.SINGLE_REF_PROBS, "u1"), (t.COMP_REF_PROBS, "u1"),
                          (t.DC_QLOOKUP, "<i2"), (t.AC_QLOOKUP, "<i2"),
                          (t.COEF_BANDS_8X8PLUS, "u1"), (t.COEF_BANDS_4X4, "u1"),
                          (t.INV_MAP_TABLE[:254], "u1")):
        assert np.asarray(values).astype(dtype).tobytes() in lib, values
    for kernel in t.SUBPEL_FILTERS:
        assert np.asarray(kernel).astype("<i2").tobytes() in lib
    for (n, kind), scan in t.SCANS.items():
        assert np.asarray(scan).astype("<i2").tobytes() in lib
        assert vp9_tables.neighbours(scan, n, kind).astype("<i2").tobytes() in lib


def test_tables_are_libavcodecs():
    """FFmpeg's copies: the coefficient probabilities in one block, the
    default probabilities of its ProbContext in its order (the intra modes
    reordered by FFmpeg's numbering, the partitions 64x64 first), the
    Pareto rows, the quantisers and the three 8-tap filters, and its scans,
    which are libvpx's transposed."""
    lib = libavcodec()
    t = vp9_tables
    assert np.asarray(t.COEF_PROBS, np.uint8).tobytes() in lib
    ffmpeg_modes = (t.V_PRED, t.H_PRED, t.DC_PRED, t.D45_PRED, t.D135_PRED, t.D117_PRED,
                    t.D153_PRED, t.D63_PRED, t.D207_PRED, t.TM_PRED)
    probs = [np.asarray(t.YMODE_PROBS, np.uint8).ravel(),
             np.asarray(t.UV_MODE_PROBS, np.uint8)[list(ffmpeg_modes)].ravel(),
             np.asarray(t.INTERP_FILTER_PROBS, np.uint8).ravel(),
             np.asarray(t.INTER_MODE_PROBS, np.uint8).ravel(), t.IS_INTER_PROBS,
             t.COMP_MODE_PROBS, np.asarray(t.SINGLE_REF_PROBS, np.uint8).ravel(),
             t.COMP_REF_PROBS, np.ravel(t.TX_PROBS_32X32), np.ravel(t.TX_PROBS_16X16),
             np.ravel(t.TX_PROBS_8X8), t.SKIP_PROBS, t.MV_JOINT_PROBS,
             np.ravel(t.MV_COMP_PROBS),
             np.asarray(t.PARTITION_PROBS, np.uint8).reshape(4, 4, 3)[::-1].ravel()]
    assert np.concatenate([np.asarray(p, np.uint8) for p in probs]).tobytes() in lib
    assert np.asarray(t.PARETO8, np.uint8).tobytes() in lib
    for table in (t.DC_QLOOKUP, t.AC_QLOOKUP):
        assert np.asarray(table).astype("<i2").tobytes() in lib
    for kernel in t.SUBPEL_FILTERS[:3]:
        assert np.asarray(kernel).astype("<i2").tobytes() in lib
    for (n, _), scan in t.SCANS.items():
        transposed = [(int(rc) % n) * n + int(rc) // n for rc in scan]
        assert np.asarray(transposed).astype("<i2").tobytes() in lib


def test_probe_reads_a_key_frame_and_its_layout():
    """probe_frame reads a key frame's header; `layout_error` finds its
    compressed header and tiles within the packet, and past a cut one."""
    s = syn.write_stream(53, "KP", width=72, height=40, colour_space=2)
    h = vp9.probe_frame(s.frames[0])
    assert (h.key, h.show, h.width, h.height, h.colour_space) == (True, True, 72, 40, 2)
    assert h.header_bytes > 0 and h.compressed_size > 0
    assert vp9.layout_error(s.frames[0], h) == 0
    cut = s.frames[0][:h.header_bytes + 1]
    assert vp9.layout_error(cut, vp9.probe_frame(cut)) == 9
    assert vp9.ERRORS[9]


def test_superframes_split_as_ffmpeg():
    """split_superframe gives a superframe's frames, a plain packet as it is,
    and None where the index runs past the packet."""
    frames = [b"\x82" * 300, b"\x86" * 5]
    packet = syn.superframe(frames)
    assert vp9.split_superframe(packet) == frames
    assert vp9.split_superframe(frames[0]) == [frames[0]]
    assert vp9.split_superframe(packet[:-5] + b"\xff" + packet[-4:]) is None


FUZZ = """
import numpy as np, sys
sys.path.insert(0, {root!r})
from tests import torch_vp9_syntax as syn
from omfs4d_torch.io import vp9
rng = np.random.default_rng(0)
s = syn.write_stream(32, "KPhPPiPP", width=48, height=32, seg=1)
kinds = {{"ok": 0, "error": 0}}
for trial in range(150):
    host = vp9.Host()
    for k, f in enumerate(s.frames):
        f = bytearray(f)
        if k >= 1 and rng.random() < 0.7:
            if rng.random() < 0.5:
                f = f[:int(rng.integers(0, len(f) + 1))]
            else:
                for _ in range(int(rng.integers(1, 12))):
                    f[int(rng.integers(0, len(f)))] = int(rng.integers(0, 256))
        try:
            host.decode(bytes(f))
            kinds["ok"] += 1
        except ValueError:
            kinds["error"] += 1
            break
print(kinds)
"""


def test_decoder_fuzz_never_crashes():
    """Truncated and garbled frames in a child process: each decodes or
    raises ValueError; the process never crashes."""
    script = FUZZ.format(root=str(Path(__file__).resolve().parent.parent))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    kinds = eval(res.stdout.strip().splitlines()[-1])
    assert kinds["ok"] > 0 and kinds["error"] > 0


def test_no_jax_covers_the_vp9_modules():
    """The import check of the port (`test_torch_no_jax.py`) walks
    `io.vp9` and `io.vp9_tables`."""
    from tests.test_torch_no_jax import port_modules
    assert {"omfs4d_torch.io.vp9", "omfs4d_torch.io.vp9_tables"} <= set(port_modules())


def test_vp9_read_in_every_container():
    """VP9 in Matroska, AVI and MP4 is read, not refused: the three names
    the port once refused it by."""
    assert "V_VP9" not in __import__("omfs4d_torch.io.matroska", fromlist=["_NAMES"])._NAMES
    assert b"VP90" not in container._AVI_NAMES and b"vp09" not in container._MP4_NAMES
    assert container.avi_codec(b"VP90", b"", "x") == {"codec": "vp9"}
