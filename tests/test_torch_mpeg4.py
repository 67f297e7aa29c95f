"""The port's host MPEG-4 Part 2 decoder (`omfs4d_torch/io/mpeg4dec.cpp`)
on the CPU, its Simple profile held to an independent decoder: cv2's
FFmpeg (Advanced Simple: `test_torch_mpeg4_asp.py`).

- Random legal-syntax streams (`tests/torch_mpeg4_syntax.py`) in feature
  sets over two seeds: cv2's decode of the stream, as a raw `.m4v`, in AVI
  and in MP4, equals its decode of an I_PCM H.264 stream of the port's
  planes (the same colour conversion), frame for frame and in count, with
  no `[mpeg4 @` line; each set shows it exercised its features, and over
  the sets every MB kind, escape mode and prediction direction occurs.
- The tables are libavcodec's, by their bytes (where opencv-python bundles
  one), and each is a prefix code.
- An Xvid-stamped stream, which FFmpeg decodes with Xvid's IDCT (its x86
  build's, saturating), equals cv2 over 6 frames and over Xvid's 300-frame
  GOP, bit for bit.
- Each tool outside the decoder is refused by name before any decode, by
  the reader and by the decoder; corrupt streams, Simple and Advanced
  Simple, raise ValueError (in a child process, so that a crash would fail
  the test, not the worker).
- cv2's own `mp4v`, `XVID`, `DIVX` and `FMP4` files and the JAX package's
  `stitch_video` output read in the port as in the JAX package; dropped AVI
  frames and VOPs that are not coded count and show as there.
- With no g++ there is no decode at all; the committed corpus
  (`tests/data/mpeg4/`) decodes to its manifest."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch import native
from omfs4d_torch.io import container, h264, mpeg4, mpeg4_tables
from omfs4d_torch.io import video as tvideo
from tests import torch_h264_syntax as hsyn
from tests import torch_mpeg4_syntax as syn
from tests.test_torch_h264_high import PATH_BOUND

CORPUS = Path(__file__).resolve().parent / "data" / "mpeg4"
REPO = Path(__file__).resolve().parent.parent

# the feature sets of the random writer, and what each must exercise
FEATURES = {
    "intra_ac_pred": dict(gop=1, frames=8, ac_pred=0.5, dc_thr=(0, 1, 2, 3, 4, 5, 6, 7),
                          dquant=0.4, qp=(1, 31)),
    "intra_levels": dict(gop=1, frames=2, qp=(1, 31), big=0.4, long_run=0.3, dc_thr=(0, 7),
                         ac_pred=0.3),
    "p_mb_kinds": dict(frames=6, not_coded=0.2, four_mv=0.3, intra_in_p=0.15, dquant=0.3),
    "p_vectors": dict(frames=6, fcode=(1, 2, 3, 4), far=0.6, four_mv=0.4, not_coded=0.05),
    "p_intra": dict(frames=5, intra_in_p=0.4, dquant=0.4, ac_pred=0.7, dc_thr=(0, 2, 5, 7),
                    qp=(1, 31), big=0.2),
    "packets": dict(frames=5, packets=0.25, hec=0.5, stuffing=0.1, intra_in_p=0.2,
                    four_mv=0.3, fcode=(1, 3), gov=True, ac_pred=0.8),
    "odd_size": dict(width=40, height=24, frames=5, far=0.6, four_mv=0.4, fcode=(1, 2),
                     intra_in_p=0.1),
    "hd_rows": dict(width=1920, height=48, frames=3, fcode=(1, 2, 3), far=0.3, four_mv=0.3,
                    packets=0.01, coded=0.3),
    "not_coded_vops": dict(frames=10, vop_not_coded=0.4),
    "headers": dict(frames=4, verid=2, vbv=True, par=True, fixed_rate=True, colour=(1, 1),
                    stamp=None, gov=True, gop=2),
}
EXPECT = {
    "intra_ac_pred": ["IQ", "ac_pred", "no_ac_pred", "dc_top", "dc_left", "dc_in_ac", "dc_vlc",
                      "ac_rescaled"],
    "intra_levels": ["esc1", "esc2", "esc3"],
    "p_mb_kinds": ["P_skip", "P_inter", "P_interQ", "P_4v", "P_intra", "rounding0",
                   "rounding1"],
    "p_vectors": ["mv_past_left", "mv_past_right", "mv_past_top", "mv_past_bottom", "fcode3",
                  "mv_half", "chroma4_half"],
    "p_intra": ["P_intraQ", "ac_pred", "dc_in_ac", "esc3"],
    "packets": ["packet", "hec", "stuffing", "P_4v"],
    "odd_size": ["mv_past_right", "mv_past_bottom", "P_4v"],
    "hd_rows": ["vop_P", "packet"],
    "not_coded_vops": ["vop_not_coded"],
    "headers": ["vop_I", "vop_P"],
}
CASES = [(name, seed) for name in FEATURES for seed in (0, 1)]


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)


def cv2_read(path, capfd) -> list[np.ndarray]:
    """Every frame cv2 decodes from a file (BGR), with no line of FFmpeg's
    MPEG-4 or H.264 decoders on stderr."""
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    err = capfd.readouterr().err
    assert "[mpeg4 @" not in err and "[h264 @" not in err, err[-2000:]
    return frames


def held_to_ffmpeg(path, pictures, colour, tmp_path, capfd) -> None:
    """cv2's decode of the file equals cv2's decode of an I_PCM stream of the
    port's pictures, in count and frame for frame."""
    pcm = tmp_path / f"{Path(path).name}.pcm.h264"
    pcm.write_bytes(hsyn.pcm_stream(pictures, colour))
    coded, ref = cv2_read(path, capfd), cv2_read(pcm, capfd)
    assert len(coded) == len(ref) == len(pictures), (path, len(coded), len(pictures))
    for i, (a, b) in enumerate(zip(coded, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"{path} frame {i}")


def containers(tmp_path, headers, vops, features) -> list[Path]:
    """The stream as a raw `.m4v`, in AVI (`XVID`; `FMP4` for a stream with
    no encoder stamp, which FFmpeg would take for Xvid's under `XVID`) and in
    MP4 (`mp4v`, OTI 0x20)."""
    w, h = features.get("width", 48), features.get("height", 32)
    raw = tmp_path / "s.m4v"
    raw.write_bytes(syn.raw(headers, vops))
    avi, mp4 = tmp_path / "s.avi", tmp_path / "s.mp4"
    fourcc = b"XVID" if features.get("stamp", syn.LAVC) else b"FMP4"
    syn.write_avi(avi, [headers + vops[0]] + vops[1:], w, h, fourcc)
    syn.write_mp4(mp4, headers, vops, w, h)
    return [raw, avi, mp4]


@pytest.mark.parametrize("name, seed", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_random_streams_decode_as_ffmpeg_does(tmp_path, capfd, name, seed):
    """Each feature set over two seeds, raw, in AVI and in MP4: cv2 decodes
    the stream to exactly the port's pictures, as many and in order, with
    no FFmpeg warning, and the stream held what the set is about."""
    features = FEATURES[name]
    writer, headers, vops = syn.write_stream(seed, **features)
    ours = mpeg4.decode_stream(syn.raw(headers, vops))
    assert ours[0][0].shape == (features.get("height", 32), features.get("width", 48))
    colour = features.get("colour")
    for path in containers(tmp_path, headers, vops, features):
        if path.suffix != ".m4v":
            frames = mpeg4.frames(path)
            assert len(frames) == len(ours)
            for i, planes in enumerate(ours):
                for a, b in zip(frames.ycbcr(i), planes):
                    np.testing.assert_array_equal(a, b)
        held_to_ffmpeg(path, ours, colour, tmp_path, capfd)
    missing = [k for k in EXPECT[name] if not writer.stats[k]]
    assert not missing, (missing, dict(writer.stats))


def test_the_feature_sets_cover_the_subset():
    """Over the feature sets every MB kind, escape mode, DC size, DC and AC
    prediction direction, f_code 1-4, rounding type and intra_dc_vlc_thr
    occurs, and vectors run past every edge."""
    total = syn.Counter()
    for name, seed in CASES:
        writer, _, _ = syn.write_stream(seed, **FEATURES[name])
        total.update(writer.stats)
    wanted = (["I", "IQ", "P_inter", "P_interQ", "P_4v", "P_intra", "P_intraQ", "P_skip",
               "esc1", "esc2", "esc3", "tcoef_table", "dc_top", "dc_left", "ac_pred",
               "no_ac_pred", "ac_rescaled", "dc_vlc", "dc_in_ac", "packet", "hec", "stuffing",
               "vop_not_coded", "rounding0", "rounding1", "mv_half", "mv_full",
               "chroma4_half", "chroma4_full"]
              + [f"mv_past_{e}" for e in ("left", "right", "top", "bottom")]
              + [f"fcode{k}" for k in range(1, 5)] + [f"dc_thr{k}" for k in range(8)]
              + [f"dc_size{k}" for k in range(9)])
    assert not [k for k in wanted if not total[k]], dict(total)


# ── the tables ──────────────────────────────────────────────

def libavcodec() -> bytes:
    libs = Path(cv2.__file__).resolve().parent.parent / "opencv_python.libs"
    found = sorted(libs.glob("libavcodec*.so*")) if libs.is_dir() else []
    if not found:
        pytest.skip("no libavcodec bundled with cv2")
    return found[0].read_bytes()


def test_tables_are_libavcodecs():
    """The TCOEF codes (uint16 pairs), levels and runs (int8), the scans,
    mcbpc, cbpy, motion and DC size codes (uint8) and the DC scalers of QP
    1-31 are byte strings of the libavcodec that cv2 bundles."""
    lib = libavcodec()
    t = mpeg4_tables
    for values, dtype in ((t.INTRA_CODES, "<u2"), (t.INTER_CODES, "<u2"),
                          (t.INTRA_LEVEL, "i1"), (t.INTRA_RUN, "i1"), (t.INTER_LEVEL, "i1"),
                          (t.INTER_RUN, "i1"), (t.ZIGZAG, "u1"), (t.ALT_HORIZONTAL, "u1"),
                          (t.ALT_VERTICAL, "u1"), (t.MCBPC_I[:, 1], "u1"),
                          (t.MCBPC_P[:, 0], "u1"), (t.MCBPC_P[:, 1], "u1"), (t.CBPY, "u1"),
                          (t.MV, "u1"), (t.DC_LUM, "u1"), (t.DC_CHROM, "u1"),
                          (t.DC_SCALER[1:, 0], "u1"), (t.DC_SCALER[1:, 1], "u1")):
        assert np.asarray(values).astype(dtype).tobytes() in lib


@pytest.mark.parametrize("name", ["MCBPC_I", "MCBPC_P", "CBPY", "MV", "DC_LUM", "DC_CHROM",
                                  "INTRA_CODES", "INTER_CODES"])
def test_tables_are_prefix_codes(name):
    """No code of a table is a prefix of another (the decoder reads each
    through one 12-bit lookup)."""
    codes = [format(int(c), f"0{int(n)}b") for c, n in getattr(mpeg4_tables, name)]
    assert max(len(c) for c in codes) <= 12
    for a in codes:
        assert not [b for b in codes if b != a and b.startswith(a)], a
    assert len(set(codes)) == len(codes)


# ── the IDCT of Xvid's streams ─────────────────────────────

# FFmpeg decodes a stream stamped "XviD" with Xvid's own IDCT, its x86 SSE2
# form (16-bit arithmetic that saturates); the port picks the same one, so
# cv2's pictures and the port's differ by XVID_MAX = 0 grey levels, over 6
# frames and over Xvid's default GOP (max_key_interval 300: one I-VOP, then
# 299 P-VOPs), where the blocks whose columns leave 16 bits show the
# saturation (measured: cv2 5.0.0 with libavcodec 62.28.101).
XVID_MAX, XVID_GOP = 0, 300


def test_xvid_stamped_streams_stay_within_a_few_levels(tmp_path, capfd):
    writer, headers, vops = syn.write_stream(4, frames=6, stamp="XviD0064", four_mv=0.3)
    ours = mpeg4.decode_stream(syn.raw(headers, vops))
    path = tmp_path / "x.avi"
    syn.write_avi(path, [headers + vops[0]] + vops[1:], 48, 32, b"XVID")
    (tmp_path / "pcm.h264").write_bytes(hsyn.pcm_stream(ours))
    coded, ref = cv2_read(path, capfd), cv2_read(tmp_path / "pcm.h264", capfd)
    assert len(coded) == len(ref) == 6
    diff = np.abs(np.stack(coded).astype(int) - np.stack(ref))
    assert diff.max() == XVID_MAX, diff.max()
    # the stamp was seen: the simple IDCT gives other pictures
    frames = mpeg4.frames(path)
    assert frames.tag == b"XVID" and frames.params["xvid_build"] == 64
    simple = mpeg4.decode_stream(syn.raw(headers.replace(b"XviD0064", b"Lavc1.1.1"), vops))
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(simple, ours))


@pytest.mark.parametrize("seed, qp", [(4, (2, 12)), (5, (2, 5)), (8, (2, 12))])
def test_xvid_stamped_streams_do_not_drift_over_a_long_gop(tmp_path, capfd, seed, qp):
    _, headers, vops = syn.write_stream(seed, frames=XVID_GOP, gop=XVID_GOP, qp=qp,
                                        stamp="XviD0064", four_mv=0.3)
    ours = mpeg4.decode_stream(syn.raw(headers, vops))
    path = tmp_path / "x.avi"
    syn.write_avi(path, [headers + vops[0]] + vops[1:], 48, 32, b"XVID")
    (tmp_path / "pcm.h264").write_bytes(hsyn.pcm_stream(ours))
    coded, ref = cv2_read(path, capfd), cv2_read(tmp_path / "pcm.h264", capfd)
    assert len(coded) == len(ref) == XVID_GOP
    diff = np.abs(np.stack(coded).astype(int) - np.stack(ref))
    assert diff.max() == XVID_MAX, (diff.max(), (diff > 0).sum())


# ── refused tools, corrupt streams ──────────────────────────

REFUSED = {"sprite": "sprites", "interlaced": "interlaced",
           "data_partitioned": "data_partitioned", "shape": "video_object_layer_shape",
           "not_8_bit": "not_8_bit", "scalability": "scalability",
           "complexity": "complexity_estimation", "newpred": "newpred",
           "reduced_resolution": "reduced_resolution_vop", "obmc": "OBMC",
           "short_header": "H.263", "chroma_format": "chroma_format 2"}


@pytest.mark.parametrize("tool", sorted(REFUSED))
def test_tools_outside_the_decoder_are_refused_by_name(tmp_path, monkeypatch, tool):
    """A stream using a tool the decoder does not read raises
    `UnsupportedCodecError` naming the tool, from probe_video, before any
    decoder is made; pushed to the decoder itself, it is refused there too."""
    assert set(REFUSED) == set(syn.REFUSALS)
    writer, headers, vops = syn.write_stream(0, frames=3, refuse=tool)
    path = tmp_path / "clip.mp4"
    syn.write_mp4(path, headers, vops, 48, 32)

    def no_decoder():
        raise AssertionError("a decoder was made")

    monkeypatch.setattr(mpeg4, "Decoder", no_decoder)
    for fn in (tvideo.probe_video, lambda p: tvideo.extract_frames(p, tmp_path / "out")):
        with pytest.raises(container.UnsupportedCodecError, match="ffmpeg") as err:
            fn(path)
        assert REFUSED[tool] in str(err.value), str(err.value)
    monkeypatch.undo()
    dec = mpeg4.Decoder()
    with pytest.raises(container.UnsupportedCodecError) as err:
        for v in [headers + vops[0]] + vops[1:]:
            dec.push(v)
    assert REFUSED[tool] in str(err.value) or tool == "sprite", str(err.value)


FUZZ = r"""
import json, sys
import numpy as np
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]
import torch_mpeg4_syntax as syn
from omfs4d_torch.io import container, mpeg4
rng = np.random.default_rng(1)
out = {"truncated": [], "flipped": [], "spliced": []}
streams = [syn.write_stream(s, frames=4, four_mv=0.3, intra_in_p=0.2, packets=p, hec=0.5,
                            dquant=0.3, fcode=(1, 2))[1:] for s, p in ((0, 0.0), (1, 0.3))]
# Advanced Simple: B-VOPs of every kind, quarter-sample, MPEG quantisation
# with loaded matrices, packets, under an Xvid stamp
streams += [syn.write_stream(s, frames=5, bframes=2, four_mv=0.3, not_coded=0.2, qpel=True,
                            quant_type=1, matrices="loaded", packets=p, hec=0.5, b_dquant=0.3,
                            bcode=(1, 2), stamp="XviD0064")[1:] for s, p in ((2, 0.0), (3, 0.2))]
for trial in range(240):
    kind = ("truncated", "flipped", "spliced")[trial % 3]
    pick = trial % 4
    headers, vops = streams[pick]
    k = int(rng.integers(len(vops)))
    v = bytearray(vops[k])
    if kind == "truncated":                      # MB data lost, not only the stuffing
        v = v[:int(rng.integers(5, len(v) - 2))]
    elif kind == "flipped":
        for _ in range(int(rng.integers(1, 4))):
            bit = int(rng.integers(40, 8 * len(v)))
            v[bit // 8] ^= 1 << (7 - bit % 8)
    else:
        other = streams[pick ^ 1][1][int(rng.integers(len(streams[pick ^ 1][1])))]
        cut = int(rng.integers(5, min(len(v), len(other))))
        v = v[:cut] + other[cut:]
    units = [headers + vops[0]] + vops[1:]
    units[k] = (headers if k == 0 else b"") + bytes(v)
    dec = mpeg4.Decoder()
    try:
        for x in units:
            dec.push(x)
            dec.pictures()
        dec.flush()
        out[kind].append("decoded")
    except ValueError:
        out[kind].append("ValueError")
    except container.UnsupportedCodecError:
        out[kind].append("unsupported")
for junk in (b"", b"\x00\x00\x01", b"\x00\x00\x01\xb6", b"\x00\x00\x01\x20\xff",
             b"\x12\x34", bytes(64), b"\x00\x00\x01\xb6\x40"):
    try:
        mpeg4.Decoder().push(junk)
        out.setdefault("junk", []).append("decoded")
    except ValueError:
        out.setdefault("junk", []).append("ValueError")
# a VOL of another size after a VOP, in the VOP's unit or in one of its own:
# refused, and the picture already decoded keeps its own size
small = syn.write_stream(0, frames=2, gop=1)[1:]
big = syn.write_stream(1, width=320, height=240, frames=2, gop=1)[1:]
for (h1, v1), (h2, v2) in ((small, big), (big, small)):
    for units in ([h1 + v1[0] + h2, v2[0]], [h1 + v1[0], h2, v2[0]]):
        dec = mpeg4.Decoder()
        try:
            for x in units:
                dec.push(x)
            out.setdefault("resized", []).append("decoded")
        except container.UnsupportedCodecError:
            out.setdefault("resized", []).append([list(p[0].shape) for p in dec.pictures()])
print(json.dumps(out))
"""


def test_corrupt_streams_raise_and_never_crash():
    """Truncated VOPs raise ValueError; bit-flipped and spliced ones raise
    ValueError (or name an unsupported tool, or happen to decode): never a
    crash of the interpreter.  Run in a child process so that a crash fails
    this test."""
    res = subprocess.run([sys.executable, "-c", FUZZ, str(REPO)], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(out["truncated"]) == {"ValueError"}, out
    for kind in ("flipped", "spliced"):
        assert set(out[kind]) <= {"ValueError", "unsupported", "decoded"}, out
        assert out[kind].count("ValueError") >= 16, out
    # an empty unit and zero bytes decode to nothing; a start code with no
    # value, a VOP with no VOL before it, a VOL cut short and bytes before
    # the first start code raise
    assert out["junk"] == ["decoded", "ValueError", "ValueError", "ValueError", "ValueError",
                           "decoded", "ValueError"], out
    assert out["resized"] == [[[32, 48]]] * 2 + [[[240, 320]]] * 2, out


@pytest.mark.parametrize("form", ["raw", "mp4", "avi"])
def test_a_vol_that_changes_the_size_is_refused(tmp_path, monkeypatch, form):
    """A VOL of another size after the first VOP (cv2 would scale every
    picture to the first size) raises `UnsupportedCodecError` naming it,
    before any decoder is made: in a raw stream, in an MP4 sample after the
    sample's VOP, and leading an AVI chunk."""
    _, ha, va = syn.write_stream(0, frames=2, gop=1)
    _, hb, vb = syn.write_stream(1, width=320, height=240, frames=2, gop=1)
    path = tmp_path / f"resized.{form}"
    if form == "raw":
        read = lambda: mpeg4.decode_stream(ha + va[0] + hb + vb[0])     # noqa: E731
    else:
        if form == "mp4":
            syn.write_mp4(path, ha, [va[0] + hb, vb[0]], 48, 32)
        else:
            syn.write_avi(path, [ha + va[0], hb + vb[0]], 48, 32)
        read = lambda: mpeg4.frames(path)                               # noqa: E731

    def no_decoder():
        raise AssertionError("a decoder was made")

    monkeypatch.setattr(mpeg4, "Decoder", no_decoder)
    with pytest.raises(container.UnsupportedCodecError, match="48x32, then 320x240"):
        read()


def test_a_cut_vop_names_its_frame(tmp_path):
    """A VOP cut short raises ValueError naming its frame; the frames before
    it read."""
    writer, headers, vops = syn.write_stream(2, frames=4)
    path = tmp_path / "clip.mp4"
    syn.write_mp4(path, headers, vops[:2] + [vops[2][:len(vops[2]) // 2]] + vops[3:], 48, 32)
    frames = mpeg4.frames(path)
    frames.ycbcr(1)
    with pytest.raises(ValueError, match="frame 2"):
        frames.ycbcr(2)


# ── files cv2 and the JAX package write ─────────────────────

def rgb_tolerance(planes, colour, tmp_path, capfd) -> int:
    """The fixed bound of swscale's unscaled path (`PATH_BOUND`, 0: bit for
    bit), once the port's conversion of the planes is held within it of
    cv2's decode of an I_PCM stream of them."""
    (tmp_path / "tol.h264").write_bytes(hsyn.pcm_stream(planes, colour))
    theirs = cv2_read(tmp_path / "tol.h264", capfd)
    bound = PATH_BOUND["unscaled"]
    assert len(theirs) == len(planes)
    for p, bgr in zip(planes, theirs):
        ours = h264.ycbcr_to_rgb(*p, full_range=bool(colour and colour[0]),
                                 matrix=colour[1] if colour else 2)
        assert np.abs(ours.astype(int) - bgr[..., ::-1]).max() <= bound
    return bound


def moving_clip(n: int, h: int, w: int, seed: int = 0) -> list[np.ndarray]:
    """n BGR frames of smooth noise panning right and down, with grain."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 8, w // 8 + 8, 3)).astype(np.uint8)
    big = cv2.resize(base, (w + 64, h + 64), interpolation=cv2.INTER_CUBIC)
    big = cv2.add(big, rng.integers(0, 24, big.shape).astype(np.uint8))
    return [np.ascontiguousarray(big[2 * i:2 * i + h, 3 * i:3 * i + w]) for i in range(n)]


def cv2_write(path, fourcc: str, frames, fps: float = 25.0) -> None:
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert writer.isOpened(), fourcc
    for f in frames:
        writer.write(f)
    writer.release()


def same_as_jax(path, tmp_path, capfd, n: int) -> None:
    """The port's probe_video equals the JAX package's; its extract_frames
    gives as many frames, each within the conversion tolerance of the JAX
    package's (the port's planes first held to cv2's bit for bit)."""
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    ours = tvideo.extract_frames(path, tmp_path / "ours")
    theirs = jvideo.extract_frames(path, tmp_path / "theirs")
    capfd.readouterr()
    assert len(ours) == len(theirs) == n
    frames = mpeg4.frames(path)
    planes = [frames.ycbcr(i) for i in range(len(frames))]
    held_to_ffmpeg(path, planes, None, tmp_path, capfd)
    # the tolerance: how far the port's conversion of these planes lies from
    # cv2's (swscale's) conversion of the same planes
    tol = rgb_tolerance(planes, None, tmp_path, capfd)
    for a, b in zip(ours, theirs):
        diff = np.abs(tvideo.read_image(a).astype(int) - tvideo.read_image(b))
        assert diff.max() <= tol, (a, diff.max(), tol)


CV2_FILES = [(fourcc, suffix, size) for fourcc, suffix in
             (("mp4v", "mp4"), ("XVID", "avi"), ("DIVX", "avi"), ("FMP4", "avi"), ("mp4v", "avi"))
             for size in ((48, 32), (320, 240))]


@pytest.mark.parametrize("fourcc, suffix, size", CV2_FILES,
                         ids=[f"{f}-{s}-{w}x{h}" for f, s, (w, h) in CV2_FILES])
def test_cv2_files_read_as_in_the_jax_package(tmp_path, capfd, fourcc, suffix, size):
    """cv2's MPEG-4 Part 2 writers (FFmpeg's mpeg4 encoder: Simple profile,
    I and P-VOPs, a GOP of 12): probe_video and extract_frames as the JAX
    package's."""
    path = tmp_path / f"clip.{suffix}"
    cv2_write(path, fourcc, moving_clip(14, size[1], size[0]))
    info = container.index(path)[2]
    assert info["codec"] == "mpeg4"
    params = mpeg4.frames(path).params
    assert (params["profile"], params["object_type"], params["stamp"][:4]) == (1, 1, "Lavc")
    same_as_jax(path, tmp_path, capfd, 14)


def test_jax_stitch_video_output_reads_as_in_the_jax_package(tmp_path, capfd, monkeypatch):
    """The JAX package's `stitch_video` with no ffmpeg falls down cv2's
    ladder to `mp4v` here (cv2 has no H.264 encoder): the port reads that
    file as the JAX package does."""
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(moving_clip(5, 64, 96, seed=3)):
        cv2.imwrite(str(frames_dir / f"{i:05d}.png"), f)
    monkeypatch.setattr(jvideo, "find_ffmpeg", lambda: None)
    path = jvideo.stitch_video(frames_dir, tmp_path / "pred.mp4", fps=30)
    capfd.readouterr()
    info = container.index(path)[2]
    if info["codec"] != "mpeg4":
        pytest.skip(f"cv2 wrote {info['codec']}, not mp4v, on this machine")
    same_as_jax(path, tmp_path, capfd, 5)


def test_dropped_frames_and_not_coded_vops_count_as_in_cv2(tmp_path, capfd):
    """An AVI's zero-byte chunks (dropped frames) count in probe_video but
    show no frame; a VOP that is not coded shows none either, but a stream
    ending in one shows its last picture once more: as cv2 counts and
    shows them."""
    writer, headers, vops = syn.write_stream(3, frames=8, vop_not_coded=0.4)
    not_coded = [v for v in vops if len(v) <= 8]
    vops.append(not_coded[0])                                      # it ends not coded
    coded = [v for v in vops if len(v) > 8]
    chunks = [headers + vops[0], b"", *vops[1:3], b"", *vops[3:]]
    path = tmp_path / "drop.avi"
    syn.write_avi(path, chunks, 48, 32)
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    assert tvideo.probe_video(path)["frame_count"] == len(chunks)
    frames = mpeg4.frames(path)
    assert len(frames) == len(coded) + 1
    planes = [frames.ycbcr(i) for i in range(len(frames))]
    held_to_ffmpeg(path, planes, None, tmp_path, capfd)
    assert all(np.array_equal(a, b) for a, b in zip(planes[-1], planes[-2]))
    assert len(tvideo.extract_frames(path, tmp_path / "out")) == len(frames)


# ── the build ───────────────────────────────────────────────

def test_no_gxx_means_no_decode(tmp_path, monkeypatch):
    """With no g++ the library cannot be built and reading raises with the
    reason: there is no decoding in Python on the reading path."""
    writer, headers, vops = syn.write_stream(0, frames=2)
    path = tmp_path / "clip.mp4"
    syn.write_mp4(path, headers, vops, 48, 32)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    mpeg4._library.cache_clear()
    try:
        assert tvideo.probe_video(path)["frame_count"] == 2       # no decode
        for fn in (lambda: mpeg4.frames(path)[0], lambda: tvideo.extract_frames(path, tmp_path)):
            with pytest.raises(RuntimeError, match="no g\\+\\+") as err:
                fn()
            assert "mpeg4dec.cpp" in str(err.value)
    finally:
        mpeg4._library.cache_clear()
    assert not (tmp_path / "build").exists()


def test_importing_builds_nothing():
    """Importing the reader builds no library; the first decode builds it,
    under a name hashed from the source, the flags and the generated
    header."""
    code = "import omfs4d_torch.io.mpeg4 as m; print(m._library.cache_info().currsize)"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.stdout.strip() == "0", res.stderr[-2000:]
    path = Path(mpeg4._library()._name)
    assert path == native.built_path(mpeg4._SOURCE, "mpeg4dec", mpeg4._GXX_FLAGS,
                                     {"mpeg4_tables.h": mpeg4_tables.cpp_header()})


# ── the committed corpus ────────────────────────────────────

def planes_sha(planes) -> str:
    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


def test_corpus_decodes_to_its_manifest():
    """Every file of `tests/data/mpeg4/` has its manifest's SHA-256 and
    decodes to the SHA-256 of its planes there, frame by frame (written once
    cv2 agreed with them); the folder stays small."""
    manifest = json.loads((CORPUS / "manifest.json").read_text())
    assert sum(p.stat().st_size for p in CORPUS.iterdir()) <= 1536 * 1024
    assert {p.name for p in CORPUS.iterdir()} == set(manifest["files"]) | {"manifest.json"}
    for name, entry in manifest["files"].items():
        path = CORPUS / name
        assert hashlib.sha256(path.read_bytes()).hexdigest() == entry["file_sha256"], name
        if path.suffix == ".m4v":
            pics = mpeg4.decode_stream(path.read_bytes())
        else:
            frames = mpeg4.frames(path)
            pics = [frames.ycbcr(i) for i in range(len(frames))]
        assert [planes_sha(p) for p in pics] == entry["sha256"], name
