"""The port's host HEVC decoder (`omfs4d_torch/io/hevcdec.cpp`, Main and Main 10
profile I, P and B pictures) on the CPU, held to an independent decoder: cv2's
FFmpeg.

- Random legal-syntax streams (`tests/torch_hevc_syntax.py`) in eighteen
  feature sets over two seeds (five of them Main 10, one at 9 bits): cv2's decode of the
  coded stream equals its decode of an H.264 I_PCM stream of the port's
  planes (the same VUI, so the colour conversion is the same; High 10 with
  10-bit PCM samples for Main 10), frame for frame and in number, with no
  `[hevc @` line; at 10 bits cv2's raw luma (`cv2_raw_luma`) equals the
  port's too; each set shows that it exercised its features, and over the
  sets the subset is covered.
- A Dolby Vision stream's RPUs (NAL unit type 62) change no picture.
- The CABAC tables are libavcodec's, by their bytes (where opencv-python
  bundles one), and the generated header holds every table.
- What stays outside the decoder (the range extension profiles' depths and
  chroma formats, the extensions) is refused by name, each from probe_video;
  with no g++ there is no decode at all; importing builds nothing.  The tools
  of Main that other sets leave off (tiles, long-term references, scaling
  lists, PCM, transquant bypass) are `tests/test_torch_hevc_tools.py`'s.
- Truncated and bit-flipped NAL units raise ValueError (in a child process,
  so that a crash would fail the test, not the worker), at 8 and at 10 bits.

The files (MP4, QuickTime, the committed corpus) are
`tests/test_torch_hevc_files.py`'s."""

import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from omfs4d_torch import native
from omfs4d_torch.io import container, hevc, hevc_tables
from omfs4d_torch.io import video as tvideo
from tests import torch_h264_syntax as h264syn
from tests import torch_hevc_syntax as syn
from tests.test_torch_h264_high import libavcodec

REPO = Path(__file__).resolve().parent.parent

# the feature sets of the random writer, and what each must exercise
FEATURES = {
    "intra": dict(gop="intra", frames=3, ctb=64, width=128, height=72, depth_intra=3, sao=True),
    "intra_small_ctb": dict(gop="intra", frames=2, ctb=16, max_tb=16, width=48, height=32,
                            strong=False, constrained_intra=True),
    "p": dict(gop="p", frames=5, refs=3, num_ref_idx=3, non_ref=0.3, width=96, height=64,
              merge_level=(2, 4), idr_every=4),
    "b_pyramid": dict(gop="pyramid", frames=9, refs=2, num_ref_idx=3, width=96, height=64),
    "wpp": dict(gop="pyramid", frames=5, wpp=True, slices=3, mid_row=0.4, dependent=0.5,
                width=96, height=80, ctb=16),
    "slices": dict(gop="p", frames=4, slices=5, dependent=0.5, width=96, height=64, ctb=16,
                   extra_bits=2, header_ext=True, constrained_intra=True),
    "weighted": dict(gop="pyramid", frames=6, weighted=True, refs=3, num_ref_idx=3,
                     list_mod=True, min_cb=16, width=96, height=64),
    "sao_deblock": dict(gop="pyramid", frames=5, sao=True, slices=3, width=128, height=96,
                        ctb=32, slice_chroma=True, chroma_offsets=(-3, 4)),
    "cra": dict(gop="pyramid", frames=13, cra=True),
    "bla": dict(gop="pyramid", frames=13, cra="bla", width=64, height=48),
    "sublayers": dict(gop="pyramid", frames=9, sublayers=True, hrd=True),
    "window": dict(gop="p", frames=3, width=60, height=44, display_window=True, colour=(0, 1),
                   param_sets=2),
    "output": dict(gop="pyramid", frames=9, output_flag=True, no_output_prior=True),
    # Main 10: QPs down to -QpBdOffsetY (-12), SAO offsets up to 31
    "main10_intra": dict(gop="intra", frames=3, ctb=32, width=96, height=64, depth_intra=3,
                         sao=True, bit_depth=10, qp=(-12, 30)),
    "main10_pb": dict(gop="pyramid", frames=6, weighted=True, refs=3, num_ref_idx=3, width=96,
                      height=64, bit_depth=10, qp=(-12, 20), chroma_offsets=(-8, 6),
                      slice_chroma=True),
    "main10_wpp": dict(gop="pyramid", frames=5, wpp=True, slices=3, ctb=16, width=96, height=80,
                       deblock=("offsets",), bit_depth=10, qp=(-6, 40)),
    # Main 10 allows 9 bits too: QpBdOffsetY 6, SAO offsets up to 15
    "main9": dict(gop="pyramid", frames=4, width=64, height=48, bit_depth=9, qp=(-6, 10),
                  sao=True, ctb=32),
    # an iPhone HDR capture's tags: BT.2020 primaries, HLG, BT.2020 matrix
    "main10_hlg": dict(gop="p", frames=4, colour=(0, 9, 18, 9), sao=True, bit_depth=10,
                       qp=(-12, 40)),
}
EXPECT = {
    "intra": ["sao_band", "sao_edge", "sao_merge_left", "transform_skip", "sign_hidden"],
    "intra_small_ctb": ["cu_qp_delta", "scan1", "scan2", "intra_nxn"],
    "p": ["P", "skip", "merge_8x4", "part4", "part7", "ref_idx1", "nal0"],
    "b_pyramid": ["B", "inter_pred_idc2", "mvd_l1_zero", "merge_idx4", "sps_rps"],
    "wpp": ["wpp_row", "wpp_sync", "dependent", "mid_row_slice"],
    "slices": ["dependent", "mid_row_slice", "lf_across0", "lf_across1"],
    "weighted": ["weighted_l0", "weighted_l1", "list_mod", "part3"],
    "sao_deblock": ["sao_band", "sao_edge", "deblock_on"],
    "cra": ["nal21", "nal8", "nal9", "nal6"],
    "bla": ["nal16", "nal8", "nal9", "nal6"],
    "sublayers": ["hrd", "nal2", "nal4"],
    "window": ["conformance_window", "default_display_window"],
    "output": ["pic_output_flag0", "no_output_of_prior_pics"],
    "main10_intra": ["bd10", "qp_negative", "sao_band", "sao_edge", "sao_offset_gt7",
                     "transform_skip"],
    "main10_pb": ["bd10", "qp_negative", "weighted_l0", "weighted_l1", "B", "cu_qp_delta"],
    "main10_wpp": ["bd10", "wpp_row", "wpp_sync", "deblock_offsets", "transform_skip",
                   "cu_qp_delta_extreme"],
    "main9": ["bd9", "qp_negative", "sao_offset_gt7", "B"],
    "main10_hlg": ["bd10", "P", "sao_offset_gt7"],
}
CASES = [(name, seed) for name in FEATURES for seed in (0, 1)]


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)


def cv2_read(path, capfd) -> list[np.ndarray]:
    """Every frame cv2 decodes from a file (BGR), with no line of FFmpeg's
    HEVC or H.264 decoder on stderr."""
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    err = capfd.readouterr().err
    assert "[hevc @" not in err and "[h264 @" not in err, err[-2000:]
    return frames


def cv2_raw_luma(path, capfd) -> list[np.ndarray]:
    """cv2's raw Y' of each frame of a 10-bit stream, the left half of each
    row: with CAP_PROP_CONVERT_RGB 0 cv2 treats yuv420p10le as 8UC1 and
    hands back H x W bytes, row by row at the frame's stride, which are the
    first W / 2 samples of each row as little-endian uint16.  They are the
    decoded samples themselves only where the VUI has no colour description
    (with one FFmpeg converts them first: clamps a limited range, maps
    HLG)."""
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(frame).view("<u2"))
    cap.release()
    err = capfd.readouterr().err
    assert "[hevc @" not in err and "[h264 @" not in err, err[-2000:]
    return frames


def held_to_ffmpeg(tmp_path, capfd, aus, colour=None, bit_depth: int = 8) -> list:
    """The port's pictures of a stream, after checking that cv2's decode of
    it equals cv2's decode of an I_PCM stream of them (High 10, 10-bit PCM
    samples, above 8 bits), and, above 8 bits, that cv2's raw luma of it
    equals the port's (where the VUI describes no colour) or cv2's raw luma
    of the I_PCM stream (where it does)."""
    data = syn.annexb(aus)
    ours = hevc.decode_annexb(data)
    assert ours[0][0].dtype == (np.uint8 if bit_depth == 8 else np.uint16)
    (tmp_path / "coded.hevc").write_bytes(data)
    (tmp_path / "pcm.h264").write_bytes(h264syn.pcm_stream(ours, colour, bit_depth=bit_depth))
    coded = cv2_read(tmp_path / "coded.hevc", capfd)
    pcm = cv2_read(tmp_path / "pcm.h264", capfd)
    assert len(coded) == len(pcm) == len(ours)
    for i, (a, b) in enumerate(zip(coded, pcm)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    if bit_depth > 8:
        raw = cv2_raw_luma(tmp_path / "coded.hevc", capfd)
        want = ([p[0][:, :p[0].shape[1] // 2] for p in ours] if colour is None else
                cv2_raw_luma(tmp_path / "pcm.h264", capfd))
        assert len(raw) == len(want) == len(ours)
        for i, (a, b) in enumerate(zip(raw, want)):
            np.testing.assert_array_equal(a, b, err_msg=f"raw luma of frame {i}")
    return ours


@pytest.mark.parametrize("name, seed", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_random_streams_decode_as_ffmpeg_does(tmp_path, capfd, name, seed):
    """Each feature set over two seeds: cv2 decodes the stream to exactly
    the port's pictures, as many (pictures not output and those an IDR's
    no_output_of_prior_pics_flag drops included), with no FFmpeg warning,
    and the stream held what the set is about."""
    features = FEATURES[name]
    writer = syn.Writer(seed, **features)
    aus = writer.stream()
    ours = held_to_ffmpeg(tmp_path, capfd, aus, features.get("colour"),
                          features.get("bit_depth", 8))
    assert ours[0][0].shape == (features.get("height", 48), features.get("width", 64))
    if not features.get("no_output_prior"):          # a BLA's RASL pictures are not output
        assert len(ours) == sum(p.output for p in writer.pics)
    missing = [k for k in EXPECT[name] if not writer.stats[k]]
    assert not missing, (missing, dict(writer.stats))


def test_the_feature_sets_cover_the_subset():
    """Over the feature sets every part_mode, every luma intra mode and
    chroma mode, every merge_idx, inter_pred_idc and scan, the NAL unit types
    of the subset (IDR, CRA, BLA, RASL, RADL, TSA, STSA, trailing,
    non-reference),
    both collocated lists, cabac_init_flag, inter-predicted RPSs in the SPS
    and the slice header, SAO's band, edge and merges, the deblocking
    overrides, WPP, dependent and mid-row slices occur; at 10 bits, negative
    slice QPs, SAO offsets above 8-bit's 7 and cu_qp_delta at the ends of its
    widened range too."""
    total = syn.Counter()
    for name, seed in CASES:
        writer = syn.Writer(seed, **FEATURES[name])
        writer.stream()
        total.update(writer.stats)
    wanted = ([f"part{p}" for p in range(8)] + [f"intra_mode{m}" for m in range(35)]
              + [f"chroma_mode{m}" for m in range(5)] + [f"merge_idx{i}" for i in range(5)]
              + [f"inter_pred_idc{i}" for i in range(3)] + [f"scan{i}" for i in range(3)]
              + [f"nal{t}" for t in (0, 1, 2, 4, 5, 6, 8, 9, 16, 19, 20, 21)]
              + ["collocated_l0", "collocated_l1", "cabac_init_flag", "inter_rps", "sps_rps",
                 "sao_band", "sao_edge", "sao_merge_left", "sao_merge_up", "deblock_off",
                 "deblock_on", "deblock_offsets", "lf_across0", "lf_across1", "wpp_sync",
                 "dependent", "mid_row_slice", "transform_skip", "sign_hidden", "escape",
                 "cu_qp_delta", "intra_in_inter", "skip", "merge_8x4", "mvd_l1_zero",
                 "intra_nxn", "weighted_l1", "list_mod", "hrd", "pic_output_flag0",
                 "no_output_of_prior_pics", "conformance_window", "default_display_window",
                 "bd10", "qp_negative", "sao_offset_gt7", "cu_qp_delta_extreme"])
    assert not [k for k in wanted if not total[k]], dict(total)


def test_dolby_vision_units_change_no_picture(tmp_path, capfd):
    """A Main 10 stream with an RPU (NAL unit type 62, unspecified: what a
    Dolby Vision iPhone capture carries) after each picture's slices decodes
    to the pictures of the same stream without them, in the port (which
    skips the type, as it does 41-63); the stream without them is held to
    cv2."""
    features = dict(FEATURES["main10_pb"], frames=4)
    aus = syn.Writer(3, **features).stream()
    plain = held_to_ffmpeg(tmp_path, capfd, aus, None, 10)
    rng = np.random.default_rng(0)
    with_rpus = [au + [bytes([62 << 1, 1, 0x19]) + rng.integers(1, 256, 30, np.uint8).tobytes()
                       + b"\x80"] for au in aus]
    assert sum((u[0] >> 1) & 63 == 62 for au in with_rpus for u in au) == len(aus)
    ours = hevc.decode_annexb(syn.annexb(with_rpus))
    assert len(ours) == len(plain)
    for a, b in zip(ours, plain):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ── tables ──────────────────────────────────────────────────

def test_cabac_tables_are_libavcodecs():
    """The initValue of each context for the three init types are FFmpeg's
    init_values rows by their bytes (each row of 199, the contexts the port
    reads first), and the default scaling lists and the deblocking tables
    are libavcodec's too."""
    lib = libavcodec()
    rows = [hevc_tables.CABAC_INIT[t].tobytes() for t in range(3)]
    at = [lib.index(r) for r in rows]
    assert all(lib.count(r) == 1 for r in rows)
    assert [a - at[0] for a in at] == [0, 199, 398]
    assert hevc_tables.BETA.tobytes() in lib and hevc_tables.TC.tobytes() in lib
    for default in (hevc_tables.DEFAULT_INTRA_8X8, hevc_tables.DEFAULT_INTER_8X8):
        raster = np.zeros((8, 8), np.uint8)
        for k, (x, y) in enumerate(hevc_tables.SCAN_8[0]):
            raster[y, x] = default[k]
        assert raster.tobytes() in lib
    assert hevc_tables.CHROMA_FILTER[1:].astype(np.int8).tobytes() in lib


def test_generated_header_holds_every_table():
    """The C++ header is generated from the one copy of the tables; the DCT
    matrix's rows are orthogonal to within the standard's rounding."""
    text = hevc_tables.cpp_header()
    for name in ("CABAC_INIT[3][179]", "RANGE_TAB_LPS[64][4]", "TRANS_IDX_LPS[64]",
                 "CTX_IDX_MAP[15]", "INTRA_ANGLE[35]", "INV_ANGLE[35]", "DCT[32][32]",
                 "DST[4][4]", "LEVEL_SCALE[6]", "QPC[58]", "BETA[52]", "TC[54]",
                 "LUMA_FILTER[4][8]", "CHROMA_FILTER[8][4]", "SCAN_8[3][64][2]"):
        assert f" {name} = " in text
    assert text.count("static const") == 19
    assert f"C_GREATER1 = {hevc_tables.CTX['GREATER1']}" in text
    d = hevc_tables.DCT.astype(np.int64)
    gram = d @ d.T
    assert (np.abs(np.diag(gram) - 131072) < 200).all() and np.abs(gram - np.diag(np.diag(gram))).max() < 400


# ── what stays outside ──────────────────────────────────────

@pytest.mark.parametrize("tool", list(syn.REFUSE))
def test_what_stays_outside_is_refused_by_name(tmp_path, tool):
    """Bit depths above 10 (Main 12), luma and chroma depths that differ,
    4:0:0, 4:2:2 and 4:4:4, the SPS's range, multilayer and screen content
    coding extensions and the PPS's range and 3D extensions raise
    UnsupportedCodecError naming the tool and ffmpeg from probe_video, with
    no decode, and again from the host decoder."""
    params = syn.Writer(0, gop="intra", frames=1, refuse=tool).parameter_sets()
    good = syn.write_stream(0, gop="p", frames=2)
    aus = [params + good[0][3:]] + good[1:]
    path = tmp_path / "clip.mp4"
    syn.write_mov(path, aus, 64, 48, quicktime=False, audio=False)
    with pytest.raises(container.UnsupportedCodecError, match="ffmpeg") as err:
        tvideo.probe_video(path)
        tvideo.extract_frames(path, tmp_path / "out")
    assert syn.REFUSE[tool] in str(err.value)
    with pytest.raises(container.UnsupportedCodecError, match="ffmpeg") as err:
        hevc.decode_annexb(syn.annexb(aus))
    assert syn.REFUSE[tool] in str(err.value)


def test_hevc_in_avi_and_an_hvc1_with_no_hvcc_need_ffmpeg(tmp_path):
    """An `hvc1` entry without its hvcC box stays refused, naming it and
    ffmpeg.  HEVC in AVI, refused before the port read it, now reads as the
    JAX package reads it: an Annex B stream in an `HEVC` AVI gives cv2's
    probe and frames (`tests/test_torch_avi_h26x.py` holds the rest)."""
    from omfs4d.io import video as jvideo
    from tests import torch_mkv_mux as mux

    aus = syn.write_stream(0, frames=2)
    path = mux.write_avi(tmp_path / "clip.avi",
                         [b"".join(b"\x00\x00\x00\x01" + u for u in au) for au in aus],
                         [True, False], 64, 48, b"HEVC", fps=25)
    assert container.index(path)[2]["codec"] == "hevc"
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    ours = tvideo.extract_frames(path, tmp_path / "ours")
    theirs = jvideo.extract_frames(path, tmp_path / "theirs")
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert np.array_equal(tvideo.read_image(a), tvideo.read_image(b))
    path = tmp_path / "clip.mp4"
    syn.write_mov(path, syn.write_stream(0, frames=2), 64, 48, quicktime=False, config=False)
    with pytest.raises(container.UnsupportedCodecError, match="no hvcC box.*ffmpeg"):
        tvideo.probe_video(path)


# ── the build ───────────────────────────────────────────────

def test_no_gxx_means_no_decode(tmp_path, monkeypatch):
    """With no g++ the library cannot be built and reading raises with the
    reason: there is no decoding in Python on the reading path."""
    path = tmp_path / "clip.mp4"
    syn.write_mov(path, syn.write_stream(0, frames=2), 64, 48, quicktime=False, audio=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    hevc._library.cache_clear()
    try:
        assert tvideo.probe_video(path)["frame_count"] == 2       # no decode
        for fn in (lambda: hevc.frames(path)[0], lambda: tvideo.extract_frames(path, tmp_path)):
            with pytest.raises(RuntimeError, match="no g\\+\\+") as err:
                fn()
            assert "hevcdec.cpp" in str(err.value)
    finally:
        hevc._library.cache_clear()
    assert not (tmp_path / "build").exists()


def test_importing_builds_nothing():
    """Importing the reader builds no library; the first decode builds it,
    under a name hashed from the source, the flags and the generated
    header."""
    code = "import omfs4d_torch.io.hevc as h; print(h._library.cache_info().currsize)"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.stdout.strip() == "0", res.stderr[-2000:]
    path = Path(hevc._library()._name)
    assert path.parent == native.BUILD_DIR and path.name.startswith("libhevcdec_")
    assert path == native.built_path(hevc._SOURCE, "hevcdec", hevc._GXX_FLAGS,
                                     {"hevc_tables.h": hevc_tables.cpp_header()})


# ── corrupt input ───────────────────────────────────────────

FUZZ = r"""
import json, sys
import numpy as np
sys.path[:0] = [sys.argv[1]]
from tests import torch_hevc_syntax as syn
from omfs4d_torch.io import container, hevc
rng = np.random.default_rng(2)
out = {"truncated": [], "flipped": []}
for name, features in json.loads(sys.argv[2]):
    features = {k: tuple(v) if isinstance(v, list) else v for k, v in features.items()}
    units = [u for au in syn.write_stream(5, **features) for u in au]
    slices = [k for k, u in enumerate(units) if (u[0] >> 1) & 63 < 32]
    for trial in range(50):
        kind = "truncated" if trial % 2 else "flipped"
        k = slices[int(rng.integers(len(slices)))]
        u = bytearray(units[k])
        if kind == "truncated":
            u = u[:int(rng.integers(2, len(u)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                bit = int(rng.integers(16, 8 * len(u)))
                u[bit // 8] ^= 1 << (7 - bit % 8)
        dec = hevc.Decoder()
        try:
            for i, x in enumerate(units):
                dec.push(bytes(u) if i == k else x)
            dec.flush()
            out[kind].append("decoded")
        except ValueError:
            out[kind].append("ValueError")
        except container.UnsupportedCodecError:
            out[kind].append("unsupported")
print(json.dumps(out))
"""


FUZZ_8BIT = [("p", dict(gop="p", frames=4, width=64, height=48)),
             ("b", dict(gop="pyramid", frames=5, width=64, height=48, wpp=True, slices=2,
                        sao=True, ctb=16))]
FUZZ_10BIT = [("p10", dict(gop="p", frames=4, width=64, height=48, bit_depth=10, qp=(-12, 40),
                           weighted=True)),
              ("b10", dict(gop="pyramid", frames=5, width=64, height=48, wpp=True, slices=2,
                           sao=True, ctb=32, bit_depth=10, qp=(-12, 30)))]


def fuzz(streams) -> dict:
    """50 truncated and bit-flipped slice segments of each stream, decoded
    in a child process: what each gave."""
    res = subprocess.run([sys.executable, "-c", FUZZ, str(REPO), json.dumps(streams)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_corrupt_streams_raise_and_never_crash():
    """Truncated slice segments raise ValueError (or, where the cut falls
    in the trailing bits, decode); bit-flipped ones raise ValueError, name
    an unsupported feature or happen to decode: never a crash of the
    interpreter.  Run in a child process so that a crash fails this test."""
    out = fuzz(FUZZ_8BIT)
    assert set(out["truncated"]) <= {"ValueError", "decoded"}, out
    assert out["truncated"].count("ValueError") >= 40, out
    assert set(out["flipped"]) <= {"ValueError", "unsupported", "decoded"}
    assert out["flipped"].count("ValueError") >= 15, out


def test_corrupt_ten_bit_streams_raise_and_never_crash():
    """The same over Main 10 streams (16-bit samples, negative QPs,
    weighted prediction, SAO's wider offsets)."""
    out = fuzz(FUZZ_10BIT)
    assert set(out["truncated"]) <= {"ValueError", "decoded"}, out
    assert out["truncated"].count("ValueError") >= 40, out
    assert set(out["flipped"]) <= {"ValueError", "unsupported", "decoded"}
    assert out["flipped"].count("ValueError") >= 15, out
