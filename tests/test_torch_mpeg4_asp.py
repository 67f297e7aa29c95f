"""The port's host MPEG-4 Part 2 decoder on Advanced Simple profile streams,
as Xvid and DivX write them by default, held to an independent decoder:
cv2's FFmpeg.

- Random legal-syntax streams (`tests/torch_mpeg4_syntax.py`) of every tool
  alone and together over two seeds: B-VOPs of every mb_type (direct from
  one and from four co-located vectors, skipped where the future reference
  skipped), dbquant, quarter-sample in P- and B-VOPs, MPEG quantisation with
  the default and loaded matrices, DivX's and Xvid's packed bitstream (an
  N-VOP or a byte as the placeholder), the encoder stamps whose workarounds
  FFmpeg applies (XviD builds 1, 12, 32 and 64, DivX 4 and 5, Lavc, a Lavc
  build in FF_BUG_IEDGE's range, none under an XVID fourcc), odd sizes, a VOL with low_delay 1 and one with no
  vol_control_parameters over B-VOPs.  In AVI, MP4 (`ctts`), Matroska and
  MPEG-TS, cv2's decode of each file equals its decode of an I_PCM H.264
  stream of the port's planes, frame for frame and in count, and
  probe_video equals the JAX package's; each set shows it exercised its
  features.
- An intra DC past 2047 once scaled: FFmpeg's predictor holds it at 2047,
  but under an Xvid stamp up to build 32 (FF_BUG_DC_CLIP) keeps it.
- A 300-frame GOP with B-VOPs under an Xvid stamp reads bit for bit.
- Frames read in any order equal those read in order (random access
  through the reordering and the packing).
- The JAX package's `extract_frames` and the port's give the same PNG
  frames for an Advanced Simple `.avi`.
- What FFmpeg's decoder reads from user data (`mpeg4.stamp`), and the new
  tables against libavcodec's bytes; a quarter-sample stream from an
  FFmpeg build whose filter FFmpeg emulates is refused by name before any
  decode."""

import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, mpeg4, mpeg4_tables
from omfs4d_torch.io import video as tvideo
from tests import torch_h264_syntax as hsyn
from tests import torch_mkv_mux as mkv
from tests import torch_mpeg4_syntax as syn
from tests import torch_ts_mux as tsm
from tests.test_torch_mpeg4 import libavcodec
from tests.test_torch_mpegts import times

MANIFEST = Path(__file__).resolve().parent / "data" / "mpeg4_asp" / "manifest.json"
ODD = dict(width=40, height=24, far=0.6)
# the feature sets, their packing (None: one VOP a sample), and what each
# must exercise
FEATURES = {
    "b_every_type": dict(frames=10, bframes=2, four_mv=0.3, not_coded=0.25, b_modb=0.15,
                         b_nocbp=0.4, b_dquant=0.5, qp=(1, 31), delta=8, coded=0.5),
    "b_direct4": dict(frames=10, bframes=2, four_mv=0.8, not_coded=0.1, b_types=(4, 1, 1, 1)),
    "b_vectors": dict(frames=12, bframes=3, fcode=(1, 2, 3), bcode=(1, 2, 3), far=0.5,
                      width=64, height=48),
    "b_packets": dict(frames=10, bframes=2, packets=0.25, hec=0.5, bcode=(1, 3),
                      not_coded=0.3, gov=True, gop=6),
    "qpel_p": dict(frames=8, qpel=True, four_mv=0.4, far=0.5, fcode=(1, 2)),
    "qpel_b": dict(frames=10, bframes=2, qpel=True, four_mv=0.4, far=0.3),
    "mpeg_quant": dict(frames=8, quant_type=1, qp=(1, 31), big=0.3, ac_pred=0.5,
                       intra_in_p=0.2, coded=0.8),
    "mpeg_matrices": dict(frames=8, quant_type=1, matrices="loaded", qp=(1, 31), big=0.3,
                          coded=0.8),
    "asp_all": dict(frames=12, bframes=2, qpel=True, quant_type=1, matrices="loaded",
                    four_mv=0.3, packets=0.1, b_dquant=0.3, not_coded=0.2),
    "odd_size": dict(frames=10, bframes=2, qpel=True, four_mv=0.4, **ODD),
    "xvid_edge": dict(frames=10, bframes=2, qpel=True, four_mv=0.4, stamp="XviD0012", **ODD),
    "xvid_qpel_chroma": dict(frames=10, bframes=1, qpel=True, four_mv=0.3, stamp="XviD0001",
                             **ODD),
    "xvid_dc_clip": dict(frames=10, bframes=2, quant_type=1, stamp="XviD0032", dc_over=0.3,
                         intra_in_p=0.3, **ODD),
    "dc_held": dict(frames=8, bframes=1, dc_over=0.3, intra_in_p=0.3),
    "xvid_64": dict(frames=10, bframes=2, qpel=True, quant_type=1, stamp="XviD0064"),
    "no_stamp": dict(frames=10, bframes=2, stamp=None, four_mv=0.4, **ODD),
    "divx_packed": dict(frames=10, bframes=2, qpel=True, four_mv=0.3, stamp="DivX503b1393p",
                        **ODD),
    "divx_packed_byte": dict(frames=10, bframes=1, qpel=True, stamp="DivX503b1393p"),
    "divx4_edge": dict(frames=10, bframes=1, four_mv=0.4, stamp="DivX402b123", **ODD),
    "divx5": dict(frames=10, bframes=1, qpel=True, four_mv=0.4, stamp="DivX501b413"),
    "xvid_packed": dict(frames=10, bframes=2, qpel=True, stamp="XviD0064",
                        stamps=("DivX503b1393p",)),
    "lavc_iedge": dict(frames=10, bframes=2, qpel=True, four_mv=0.3, stamp="Lavc56.1.100",
                       **ODD),
    "low_delay_b": dict(frames=13, bframes=2, low_delay=1, vop_not_coded=0.5),
    "no_vol_control": dict(frames=10, bframes=2, vol_control=False),
}
PACK = {"divx_packed": "nvop", "divx_packed_byte": "byte", "xvid_packed": "nvop"}
EXPECT = {
    "b_every_type": ["B_direct", "B_interpolate", "B_backward", "B_forward", "B_modb1",
                     "B_nocbp", "dbquant", "mvdb_nonzero", "B_colocated_skip", "direct4"],
    "b_direct4": ["direct4", "direct1", "direct_scaled"],
    "b_vectors": ["bcode2", "bcode3", "fcode3", "mv_fwd", "mv_bwd"],
    "b_packets": ["packet", "hec", "B_colocated_skip", "vop_B"],
    "qpel_p": ["qpel11", "qpel13", "qpel31", "qpel33", "qpel20", "qpel02", "qpel22"],
    "qpel_b": ["qpel12", "qpel21", "mv_fwd", "mv_bwd", "direct4"],
    "mpeg_quant": ["mismatch_even", "mismatch_odd", "P_intra", "ac_pred"],
    "mpeg_matrices": ["mismatch_even", "esc3"],
    "asp_all": ["vop_B", "packet", "qpel33", "mismatch_even"],
    "odd_size": ["mv_past_right", "mv_past_bottom", "direct4"],
    "xvid_edge": ["mv_past_right", "mv_past_bottom"],
    "xvid_qpel_chroma": ["qpel13", "vop_B"],
    "xvid_dc_clip": ["vop_B", "dc_over"],
    "dc_held": ["dc_over", "vop_B"],
    "xvid_64": ["vop_B", "mismatch_even"],
    "no_stamp": ["vop_B", "P_4v"],
    "divx_packed": ["vop_B", "qpel31"],
    "divx_packed_byte": ["vop_B"],
    "divx4_edge": ["mv_past_right", "vop_B"],
    "divx5": ["vop_B", "qpel22"],
    "xvid_packed": ["vop_B"],
    "lavc_iedge": ["vop_B", "mv_past_right", "mv_past_bottom"],
    "low_delay_b": ["vop_B", "vop_not_coded"],
    "no_vol_control": ["vop_B"],
}
CASES = [(name, seed) for name in FEATURES for seed in (0, 1)]
FORMS = ("avi", "mp4", "mkv", "ts")


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)


# what FFmpeg's MPEG-4 decoder says of a legal stream: a low_delay it clears
# (a VOL with no vol_control_parameters before B-VOPs), and, of a packed
# sample, the second VOP left after the first one's last MB
WARNINGS = ("low_delay flag set incorrectly", "slice end not reached but screenspace end")


def cv2_read(path, capfd, warned: bool = False) -> list[np.ndarray]:
    """Every frame cv2 decodes from a file (BGR); FFmpeg's MPEG-4 and H.264
    decoders print nothing (where `warned`, the MPEG-4 one may say what
    `WARNINGS` holds)."""
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    err = capfd.readouterr().err
    if warned:
        err = "\n".join(line for line in err.splitlines() if not any(w in line for w in WARNINGS))
    assert "[mpeg4 @" not in err and "[h264 @" not in err, err[-2000:]
    return frames


def write_forms(tmp_path, writer, headers: bytes, vops: list[bytes], features: dict,
                pack: str | None) -> dict[str, Path]:
    """The stream in AVI (`DX50` under a DivX stamp, else `XVID`), MP4 (with
    `ctts` where B-VOPs reorder it), Matroska (`V_MPEG4/ISO/ASP`, the headers
    as CodecPrivate) and MPEG-TS (stream type 0x10, headers in band), as
    `pack` lays the samples out."""
    w, h = features.get("width", 48), features.get("height", 32)
    samples = syn.packed(writer, vops, pack) if pack else vops
    display = list(range(len(samples))) if pack else writer.display
    stamp = features.get("stamp", syn.LAVC) or ""
    fourcc = b"DX50" if stamp.startswith("DivX") else b"XVID"
    key = [syn.is_key(s) for s in samples]
    paths = {f: tmp_path / f"s.{f}" for f in FORMS}
    syn.write_avi(paths["avi"], [headers + samples[0]] + samples[1:], w, h, fourcc)
    syn.write_mp4(paths["mp4"], headers, samples, w, h,
                  display=display if features.get("bframes") and not pack else None)
    mkv.write_mkv(paths["mkv"], samples, key, [round(d * 1000 / 30) for d in display],
                  codec_id="V_MPEG4/ISO/ASP", width=w, height=h, private=headers)
    pts, dts = times(display)
    tsm.write_ts(paths["ts"], [headers + samples[0]] + samples[1:], pts, dts, codec="mpeg4",
                 key=key)
    return paths


def held_to_cv2(path, capfd, tmp_path, warned: bool = False) -> list:
    """The port's planes of a file; cv2's decode of it equals its decode of
    an I_PCM stream of them, in count and frame for frame, and probe_video
    equals the JAX package's."""
    frames = mpeg4.frames(path)
    ours = [frames.ycbcr(i) for i in range(len(frames))]
    pcm = tmp_path / f"{path.name}.pcm.h264"
    pcm.write_bytes(hsyn.pcm_stream(ours))
    coded, ref = cv2_read(path, capfd, warned), cv2_read(pcm, capfd)
    assert len(coded) == len(ref) == len(ours), (path.name, len(coded), len(ours))
    for i, (a, b) in enumerate(zip(coded, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"{path.name} frame {i}")
    assert tvideo.probe_video(path) == jvideo.probe_video(path), path.name
    capfd.readouterr()
    return ours


@pytest.mark.parametrize("name, seed", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_asp_streams_decode_as_ffmpeg_does(tmp_path, capfd, name, seed):
    """Each feature set over two seeds, in AVI, MP4, Matroska and MPEG-TS:
    cv2 decodes the file to exactly the port's pictures, as many and in
    order, and probes it as the port does; the stream held what the set is
    about."""
    features = FEATURES[name]
    writer, headers, vops = syn.write_stream(seed, **features)
    paths = write_forms(tmp_path, writer, headers, vops, features, PACK.get(name))
    for form, path in paths.items():
        if form == "ts" and PACK.get(name) == "byte":
            # FFmpeg's parser cuts a transport stream at start codes, so the
            # placeholder byte ends the VOP before it, which FFmpeg then
            # conceals as damaged: the port refuses that frame
            frames = mpeg4.frames(path)
            with pytest.raises(ValueError, match="bytes after the VOP's end"):
                [frames.ycbcr(i) for i in range(len(frames))]
            continue
        held_to_cv2(path, capfd, tmp_path, warned=name == "no_vol_control" or name in PACK)
    missing = [k for k in EXPECT[name] if not writer.stats[k]]
    assert not missing, (missing, dict(writer.stats))


def test_every_b_mb_type_and_qpel_phase_occurs():
    """Over the feature sets every B-VOP mb_type, both direct forms, dbquant
    and each of the 16 quarter-sample phases occur, and loaded matrices both
    whole and cut short."""
    total = syn.Counter()
    for name, seed in CASES:
        writer, _, _ = syn.write_stream(seed, **FEATURES[name])
        total.update(writer.stats)
    wanted = ([f"B_{t}" for t in syn.B_TYPES] + ["B_modb1", "direct1", "direct4", "dbquant",
                                                  "B_colocated_skip", "matrix_loaded",
                                                  "matrix_cut", "mismatch_even"]
              + [f"qpel{x}{y}" for x in range(4) for y in range(4)])
    assert not [k for k in wanted if not total[k]], dict(total)


def test_a_long_gop_with_b_vops_reads_bit_for_bit(tmp_path, capfd):
    """An Xvid-stamped stream of one I-VOP, then P- and B-VOPs for 300
    frames (Xvid's max_key_interval), in AVI: every frame as cv2's."""
    writer, headers, vops = syn.write_stream(7, frames=300, gop=300, bframes=2, qpel=True,
                                             four_mv=0.3, stamp="XviD0064", qp=(2, 12))
    path = tmp_path / "gop.avi"
    syn.write_avi(path, [headers + vops[0]] + vops[1:], 48, 32, b"XVID")
    ours = held_to_cv2(path, capfd, tmp_path)
    assert len(ours) == 300 and writer.stats["vop_B"] == 199


@pytest.mark.parametrize("name", ["b_every_type", "divx_packed", "low_delay_b"])
def test_frames_read_in_any_order_equal_those_read_in_order(tmp_path, name):
    """Random access through the reordering, the packing and the pictures
    shown late: each frame read backwards, and at random, equals its read
    in order."""
    features = dict(FEATURES[name], frames=16, gop=8)
    writer, headers, vops = syn.write_stream(2, **features)
    paths = write_forms(tmp_path, writer, headers, vops, features, PACK.get(name))
    for path in (paths["avi"], paths["ts"]):
        frames = mpeg4.frames(path)
        ahead = [frames.ycbcr(i) for i in range(len(frames))]
        frames = mpeg4.frames(path)
        order = list(range(len(frames)))[::-1] + list(np.random.default_rng(0).permutation(
            len(frames)))
        for i in order:
            for a, b in zip(frames.ycbcr(i), ahead[i]):
                np.testing.assert_array_equal(a, b, err_msg=f"{path.name} frame {i}")


def test_extract_frames_as_in_the_jax_package(tmp_path, capfd):
    """An Advanced Simple `.avi` (B-VOPs, quarter-sample, MPEG quantisation,
    an Xvid stamp) through the JAX package's `extract_frames` (cv2) and the
    port's gives the same PNG frames."""
    features = dict(frames=12, bframes=2, qpel=True, quant_type=1, four_mv=0.3,
                    stamp="XviD0064", width=64, height=48)
    writer, headers, vops = syn.write_stream(3, **features)
    path = tmp_path / "asp.avi"
    syn.write_avi(path, [headers + vops[0]] + vops[1:], 64, 48, b"XVID")
    ours = tvideo.extract_frames(path, tmp_path / "ours")
    theirs = jvideo.extract_frames(path, tmp_path / "theirs")
    capfd.readouterr()
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(tvideo.read_image(a), tvideo.read_image(b))


# ── the encoder's stamp, the tables, refusals ───────────────

@pytest.mark.parametrize("text, want", [
    ("XviD0064", {"xvid_build": 64}),
    ("DivX503b1393p", {"divx_version": 503, "divx_build": 1393, "packed": True}),
    ("DivX501b413", {"divx_version": 501, "divx_build": 413, "packed": False}),
    ("DivX501Build413p", {"divx_version": 501, "divx_build": 413, "packed": True}),
    ("Lavc62.28.101", {"lavc_build": 62 << 16 | 28 << 8 | 101}),
    ("Lavc300.1.2", {"lavc_build": (300 & 0xFF) << 16 | 1 << 8 | 2}),
    ("FFmpeg0.4.9-pre1b4718", {"lavc_build": 4718}),
    ("ffmpeg", {"lavc_build": 4600}),
    ("Lavc62", {}), ("XviD", {}), ("", {}),
])
def test_stamps_are_read_as_ffmpeg_reads_them(text, want):
    """The user data FFmpeg's decode_user_data reads the encoder from: DivX's
    version, build and packed flag, the libavcodec build, Xvid's build."""
    assert mpeg4.stamp(text) == want


def test_new_tables_are_libavcodecs():
    """The default MPEG quantisation matrices (int16) are byte strings of the
    libavcodec that cv2 bundles; the B-VOP mb_type codes are a prefix code."""
    lib = libavcodec()
    for m in (mpeg4_tables.DEFAULT_INTRA_MATRIX, mpeg4_tables.DEFAULT_INTER_MATRIX):
        assert np.asarray(m).astype("<i2").tobytes() in lib
    codes = [format(int(c), f"0{int(n)}b") for c, n in mpeg4_tables.MB_TYPE_B]
    assert codes == ["1", "01", "001", "0001"]
    assert [format(int(c), f"0{int(n)}b") for c, n in mpeg4_tables.DBQUANT] == ["0", "10", "11"]


def test_qpel_of_an_old_ffmpeg_build_is_refused_by_name(tmp_path, monkeypatch):
    """A quarter-sample stream stamped by an FFmpeg build whose filter FFmpeg
    emulates (FF_BUG_STD_QPEL, build < 4653) raises `UnsupportedCodecError`
    before any decoder is made; its Simple twin reads."""
    _, headers, vops = syn.write_stream(0, frames=3, qpel=True, stamp="FFmpeg0.4.9-pre1b4600")
    path = tmp_path / "old.avi"
    syn.write_avi(path, [headers + vops[0]] + vops[1:], 48, 32)

    def no_decoder(*args):
        raise AssertionError("a decoder was made")

    monkeypatch.setattr(mpeg4, "Host", no_decoder)
    with pytest.raises(container.UnsupportedCodecError, match="quarter_sample from an FFmpeg"):
        tvideo.probe_video(path)
    monkeypatch.undo()
    _, headers, vops = syn.write_stream(0, frames=3, stamp="FFmpeg0.4.9-pre1b4600")
    syn.write_avi(path, [headers + vops[0]] + vops[1:], 48, 32)
    assert len(mpeg4.frames(path)) == 3


# ── the card's corpus ───────────────────────────────────────

def planes_sha(planes) -> str:
    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


def test_asp_manifest_is_what_the_writer_and_cv2_give(tmp_path, capfd):
    """`tests/data/mpeg4_asp/manifest.json` (`tests/make_mpeg4_asp_manifest.py`),
    which the card's smoke test re-makes its Advanced Simple streams against,
    holds the SHA-256 of each stream the writer makes from its seed and of
    each frame cv2 shows of it (held here to the port's, bit for bit); the
    1080p clip, a few seconds of the writer's Python, is left to its script
    and the card."""
    manifest = json.loads(MANIFEST.read_text())
    assert set(manifest["streams"]) >= {"asp_1080p", "b_every_type", "divx_packed"}
    for name, entry in manifest["streams"].items():
        features = {k: tuple(v) if isinstance(v, list) else v
                    for k, v in entry["features"].items()}
        w, h = features.get("width", 48), features.get("height", 32)
        if w * h > 640 * 480:
            continue
        writer, headers, vops = syn.write_stream(entry["seed"], **features)
        chunks = syn.avi_chunks(writer, headers, vops, entry["pack"])
        assert hashlib.sha256(b"".join(chunks)).hexdigest() == entry["stream_sha256"], name
        assert writer.kinds == entry["kinds"], name
        path = tmp_path / f"{name}.avi"
        syn.write_avi(path, chunks, w, h, entry["fourcc"].encode())
        ours = held_to_cv2(path, capfd, tmp_path, warned=bool(entry["pack"]))
        assert [planes_sha(p) for p in ours] == entry["sha256"], name
