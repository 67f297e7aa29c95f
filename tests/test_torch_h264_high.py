"""The port's host H.264 decoder (`omfs4d_torch/io/h264dec.cpp`, Main and
High profile I and P pictures) on the CPU, held to an independent decoder:
cv2's FFmpeg.

- Random legal-syntax streams (`tests/torch_h264_syntax.py`) in twelve
  feature sets over seeds: cv2's decode of the coded stream equals its decode
  of an I_PCM stream of the port's planes (the same VUI, so the colour
  conversion is the same), frame for frame, with no `[h264 @` line; each set
  shows that it exercised its features.
- On every stream the port's own encoder writes, the host decoder equals the
  plain Python `H264Decoder` bit for bit.
- The CABAC tables are libavcodec's, by their bytes (where opencv-python
  bundles one).
- Truncated and bit-flipped NAL units raise ValueError (in a child process,
  so that a crash would fail the test, not the worker).
- A phone-like QuickTime file (a silent sound track, a 90-degree display
  matrix, an edit list) reads in the port as in the JAX package; the VUI's
  range and matrix convert as cv2 converts them.
- What stays outside the decoder is refused by name, and with no g++ there
  is no decode at all.
- The committed corpus (`tests/data/h264/`) decodes to its manifest."""

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
from omfs4d_torch.io import container, h264, h264_tables, swscale
from omfs4d_torch.io import video as tvideo
from tests import torch_h264_syntax as syn
from tests.test_torch_h264 import annex_b, cv2_read, grey_clip, moving_patch

CORPUS = Path(__file__).resolve().parent / "data" / "h264"
REPO = Path(__file__).resolve().parent.parent

# the feature sets of the random writer, and what each must exercise
FEATURES = {
    "main_cavlc_intra": dict(profile=77, cabac=False, t8x8=False, frames=2, idr_every=1,
                             pcm=0.05, slices=3, width=64, height=48),
    "main_cavlc_p": dict(profile=77, cabac=False, t8x8=False, frames=6, refs=2, num_ref_idx=2,
                         intra_in_p=0.2, deblock=(0, 2)),
    "main_cabac_intra": dict(profile=77, cabac=True, t8x8=False, frames=2, idr_every=1, pcm=0.05,
                             width=64, height=48),
    "main_cabac_p": dict(profile=77, cabac=True, t8x8=False, frames=6, refs=2, num_ref_idx=2),
    "high_8x8_cavlc": dict(profile=100, cabac=False, t8x8=True, frames=4, width=64, height=48),
    "high_8x8_cabac": dict(profile=100, cabac=True, t8x8=True, frames=4, width=64, height=48),
    "scaling_lists": dict(profile=100, t8x8=True, scaling="sps+pps", frames=4),
    "references": dict(frames=12, refs=4, num_ref_idx=4, list_mod=True, mmco=True,
                       long_term=True, mmco5=True, idr_every=7),
    "weighted": dict(frames=6, refs=3, num_ref_idx=3, weighted=True),
    "slices_deblocking": dict(frames=5, slices=6, deblock=(0, 1, 2), constrained_intra=True,
                              i_slices_in_p=0.3, intra_in_p=0.3, width=64, height=48),
    "poc_and_params": dict(frames=8, non_ref=True, param_sets=3, width=56, height=40,
                           chroma_offsets=(-4, 6), restriction=True, refs=2, num_ref_idx=2),
    "levels_and_qp": dict(profile=100, cabac=False, big=0.8, qp=(0, 51), qp_delta=26, pcm=0.1,
                          frames=3, scaling="sps", scaling_range=(4, 7)),
}
EXPECT = {
    "main_cavlc_intra": ["I4x4", "I16", "IPCM", "i4_mode4", "chroma_mode3"],
    "main_cavlc_p": ["P8x8REF0", "sub3", "PSKIP", "fractional_mv", "outside_mv", "ref1"],
    "main_cabac_intra": ["I4x4", "I16", "IPCM", "i16_mode3", "i4_mode8"],
    "main_cabac_p": ["P16x8", "P8x16", "sub2", "PSKIP", "ref1"],
    "high_8x8_cavlc": ["I8x8", "inter_8x8"],
    "high_8x8_cabac": ["I8x8", "inter_8x8"],
    "scaling_lists": ["I8x8", "inter_8x8"],
    "references": ["list_mod", "long_term", "mmco4", "ref1"],
    "weighted": ["weighted", "ref2"],
    "slices_deblocking": ["deblock0", "deblock1", "deblock2"],
    "poc_and_params": ["non_ref"],
    "levels_and_qp": ["level_prefix15"],
}
CASES = [(name, seed, poc) for name in FEATURES for seed, poc in ((0, 0), (1, 1 + len(name) % 2))]


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)


def held_to_ffmpeg(tmp_path, capfd, aus, colour=None) -> list:
    """The port's pictures of a stream, after checking that cv2's decode of
    it equals cv2's decode of an I_PCM stream of them."""
    data = syn.annexb(aus)
    ours = h264.decode_annexb(data)
    (tmp_path / "coded.h264").write_bytes(data)
    (tmp_path / "pcm.h264").write_bytes(syn.pcm_stream(ours, colour))
    coded = cv2_read(tmp_path / "coded.h264", capfd)
    pcm = cv2_read(tmp_path / "pcm.h264", capfd)
    assert len(coded) == len(pcm) == len(ours)
    for i, (a, b) in enumerate(zip(coded, pcm)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    return ours


@pytest.mark.parametrize("name, seed, poc", CASES, ids=[f"{n}-{s}" for n, s, _ in CASES])
def test_random_streams_decode_as_ffmpeg_does(tmp_path, capfd, name, seed, poc):
    """Each feature set over two seeds (and POC types 0 to 2): cv2 decodes
    the stream to exactly the port's pictures, with no FFmpeg warning, and
    the stream held what the set is about."""
    features = dict(FEATURES[name])
    features.setdefault("poc_type", poc)
    writer = syn.Writer(seed, **features)
    aus = writer.stream()
    ours = held_to_ffmpeg(tmp_path, capfd, aus)
    assert len(ours) == features["frames"]
    assert ours[0][0].shape == (features.get("height", 32), features.get("width", 48))
    missing = [k for k in EXPECT[name] if not writer.stats[k]]
    assert not missing, (missing, dict(writer.stats))


def test_the_feature_sets_cover_the_subset():
    """Over the feature sets every macroblock kind, every intra mode of each
    block size, every sub-partition, every MMCO and both entropy coders
    occur."""
    total = syn.Counter()
    for name, seed, poc in CASES:
        writer = syn.Writer(seed, **dict(FEATURES[name], poc_type=poc))
        writer.stream()
        total.update(writer.stats)
    wanted = (["I4x4", "I8x8", "I16", "IPCM", "P16x16", "P16x8", "P8x16", "P8x8", "P8x8REF0",
               "PSKIP"] + [f"i4_mode{m}" for m in range(9)] + [f"i8_mode{m}" for m in range(9)]
              + [f"i16_mode{m}" for m in range(4)] + [f"chroma_mode{m}" for m in range(4)]
              + [f"sub{s}" for s in range(4)] + [f"mmco{k}" for k in range(1, 7)]
              + [f"cabac_init_idc{k}" for k in range(3)] + ["level_prefix16", "weighted",
                                                            "list_mod", "non_ref"])
    assert not [k for k in wanted if not total[k]], dict(total)


# ── the plain version ───────────────────────────────────────

PLAIN = [((16, 16), 10, "noise"), ((32, 48), 30, "flat"), ((62, 100), 18, "gradient"),
         ((48, 64), 40, "noise"), ((64, 80), 18, "colour"), ((512, 512), 18, "noise")]


@pytest.mark.parametrize("size, qp, kind", PLAIN,
                         ids=[f"{s[1]}x{s[0]}-qp{q}-{k}" for s, q, k in PLAIN])
def test_host_decoder_equals_the_plain_one(size, qp, kind):
    """On `encode_h264`'s streams (Intra_16x16 IDR pictures one slice a row,
    P_L0_16x16 / P_Skip with whole-sample vectors) the host decoder gives the
    plain `H264Decoder`'s pictures, which are the encoder's reconstruction."""
    h, w = size
    n = 3 if h >= 512 else 12
    frames = moving_patch(h, w, n) if kind == "colour" else grey_clip(h, w, kind, n=n)
    stream = h264.encode_h264(frames, 25.0, qp=qp)
    plain = h264.H264Decoder(stream.sps, stream.pps)
    ours = h264.decode_annexb(annex_b(stream))
    assert len(ours) == n
    for au, got, recon in zip(stream.access_units, ours, stream.recon):
        for a, b, r in zip(got, plain.decode(au), recon):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, r)


# ── the tables ──────────────────────────────────────────────

def libavcodec() -> bytes:
    libs = Path(cv2.__file__).resolve().parent.parent / "opencv_python.libs"
    found = sorted(libs.glob("libavcodec*.so*")) if libs.is_dir() else []
    if not found:
        pytest.skip("no libavcodec bundled with cv2")
    return found[0].read_bytes()


def test_cabac_tables_are_libavcodecs():
    """The (m, n) of ctxIdx 0-459 for I slices and each cabac_init_idc, as
    int8 pairs, and rangeTabLPS (each entry twice, a column of qCodIRangeIdx
    at a time, as FFmpeg lays it out) and transIdxLPS (in FFmpeg's combined
    state table) are byte strings of the libavcodec that cv2 bundles."""
    lib = libavcodec()
    at = []
    for table in h264_tables.CABAC_INIT:
        raw = table.astype(np.int8).tobytes()
        assert lib.count(raw) == 1
        at.append(lib.index(raw))
    # FFmpeg's cabac_context_init_PB[3][1024][2] then _I[1024][2]: 2048 bytes a table
    assert [a - at[1] for a in at] == [6144, 0, 2048, 4096]
    for q in range(4):
        assert np.repeat(h264_tables.RANGE_TAB_LPS[:, q], 2).astype(np.uint8).tobytes() in lib
    lps = h264_tables.TRANS_IDX_LPS
    states = [v for i in range(63, 0, -1) for v in (2 * lps[i] + 1, 2 * lps[i])] + [0, 1]
    assert bytes(states) in lib
    assert h264_tables.SIG8_CTX.astype(np.uint8).tobytes() in lib
    assert h264_tables.LAST8_CTX.astype(np.uint8).tobytes() in lib


def test_generated_header_holds_every_table():
    """The C++ header is generated from the one copy of the tables."""
    text = h264_tables.cpp_header()
    for name in ("CABAC_INIT[4][460][2]", "RANGE_TAB_LPS[64][4]", "TRANS_IDX_LPS[64]",
                 "ALPHA[52]", "BETA[52]", "TC0[52][3]", "DEFAULT_8X8[2][64]", "CT_LEN[5][17][4]",
                 "B_MB_TYPE[23][3]", "B_SUB_MB_TYPE[13][3]"):
        assert f" {name} = " in text
    assert text.count("static const") == 27


# ── corrupt input ───────────────────────────────────────────

FUZZ = r"""
import json, sys
import numpy as np
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]
import torch_h264_syntax as syn
from omfs4d_torch.io import container, h264
rng = np.random.default_rng(0)
out = {"truncated": [], "flipped": []}
for cabac in (False, True):
    aus = syn.write_stream(4, cabac=cabac, frames=3, refs=2, num_ref_idx=2, width=48, height=32)
    units = [u for au in aus for u in au]
    for trial in range(60):
        kind = "truncated" if trial % 2 else "flipped"
        k = int(rng.integers(2, len(units)))
        u = bytearray(units[k])
        if kind == "truncated":
            u = u[:int(rng.integers(1, len(u)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                bit = int(rng.integers(8, 8 * len(u)))
                u[bit // 8] ^= 1 << (7 - bit % 8)
        dec = h264.Decoder()
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


def test_corrupt_nal_units_raise_and_never_crash():
    """Truncated NAL units raise ValueError; bit-flipped ones raise ValueError
    (or name an unsupported feature, or happen to decode): never a crash of
    the interpreter.  Run in a child process so that a crash fails this test."""
    res = subprocess.run([sys.executable, "-c", FUZZ, str(REPO)], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(out["truncated"]) == {"ValueError"}, out
    assert set(out["flipped"]) <= {"ValueError", "unsupported", "decoded"}
    assert out["flipped"].count("ValueError") >= 20, out


def test_empty_and_junk_units_raise_value_error():
    dec = h264.Decoder()
    for unit in (b"", b"\x80", b"\x67", b"\x68\x00", b"\x65"):
        with pytest.raises(ValueError, match="H.264"):
            h264.Decoder().push(unit)
    with pytest.raises(ValueError, match="parameter set"):
        dec.push(bytes([0x41, 0x9A, 0x00, 0x80]))


# ── the phone's file ────────────────────────────────────────

# the fixed bound of the port's conversion against cv2's on each of
# swscale's paths (`omfs4d_torch.io.swscale`, measured on x86 cv2 5.0.0 /
# swscale 9.5.101): both bit for bit
PATH_BOUND = {"unscaled": 0, "scaled": 0}


def rgb_tolerance(ours_planes, colour, tmp_path, capfd, bit_depth: int = 8) -> int:
    """The fixed bound (`PATH_BOUND`) of the path swscale takes for these
    planes, once the port's conversion of them is held within it of cv2's
    decode of an I_PCM stream of them (`bit_depth` bits a sample, `colour`
    as `syn.vui_colour` reads it)."""
    (tmp_path / "tol.h264").write_bytes(syn.pcm_stream(ours_planes, colour, bit_depth=bit_depth))
    theirs = cv2_read(tmp_path / "tol.h264", capfd)
    full, _, _, matrix = syn.vui_colour(colour)
    y, cb, _ = ours_planes[0]
    bound = PATH_BOUND["unscaled" if swscale.takes_unscaled(y.shape, cb.shape, bit_depth)
                       else "scaled"]
    assert len(theirs) == len(ours_planes)
    for planes, bgr in zip(ours_planes, theirs):
        ours = h264.ycbcr_to_rgb(*planes, full_range=bool(full), matrix=matrix, bit_depth=bit_depth)
        assert np.abs(ours.astype(int) - bgr[..., ::-1]).max() <= bound
    return bound


@pytest.mark.parametrize("rotation, media_time, entry",
                         [(90, 0, b"avc1"), (270, 601, b"avc3"), (180, 600, b"avc1")])
def test_phone_quicktime_reads_as_in_the_jax_package(tmp_path, capfd, rotation, media_time,
                                                     entry):
    """A QuickTime file as a phone writes one (`qt  ` brand, `wide`, a silent
    `sowt` sound track, BT.709, a display matrix, an edit list; parameter
    sets in avcC or in band): the port's probe_video and extract_frames give
    the JAX package's size (turned), fps, count and frames (turned, those the
    edit list keeps), the pixels within the conversion tolerance the I_PCM
    stream shows."""
    colour = (0, 1)
    aus = syn.write_stream(2, width=64, height=48, frames=6, refs=2, num_ref_idx=2,
                           colour=colour, param_sets=2)
    path = tmp_path / "clip.mov"
    syn.write_mov(path, aus, 64, 48, fps=30, rotation=rotation, media_time=media_time,
                  sample_entry=entry)
    info = container.index(path)[2]
    assert (info["codec"], info["rotation"]) == ("h264", rotation)
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    ours = tvideo.extract_frames(path, tmp_path / "ours")
    theirs = jvideo.extract_frames(path, tmp_path / "theirs")
    capfd.readouterr()
    kept = 6 - (media_time + 599) // 600
    assert len(ours) == len(theirs) == kept
    planes = h264.decode_annexb(syn.annexb(aus))[6 - kept:]
    tol = rgb_tolerance(planes, colour, tmp_path, capfd)
    for a, b in zip(ours, theirs):
        x, y = tvideo.read_image(a).astype(int), tvideo.read_image(b).astype(int)
        assert x.shape == y.shape == ((64, 48, 3) if rotation in (90, 270) else (48, 64, 3))
        assert np.abs(x - y).max() <= tol


COLOURS = [(False, 6), (True, 6), (False, 1), (True, 1), (False, 4), (False, 7), (False, 2),
           (False, 9), (True, 9)]
# the matrix each is held apart from: another one in use
WRONG = {1: 6, 6: 1, 9: 6}


def flat_blocks(seed: int, bit_depth: int, n: int = 48):
    """One picture of n flat 16 x 16 blocks of random Y'CbCr, `bit_depth` bits
    a sample."""
    vals = np.random.default_rng(seed).integers(0, 1 << bit_depth, (n, 3))
    vals = vals.astype(np.uint8 if bit_depth == 8 else np.uint16)
    y = np.repeat(np.repeat(vals[None, :, 0], 16, 0), 16, 1)
    cb = np.repeat(np.repeat(vals[None, :, 1], 8, 0), 8, 1)
    cr = np.repeat(np.repeat(vals[None, :, 2], 8, 0), 8, 1)
    return y, cb, cr


def held_at_block_centres(tmp_path, capfd, planes, full, matrix, bit_depth):
    """cv2's conversion of an I_PCM stream of flat-block planes whose VUI
    says the range and matrix (BT.2020's with the primaries and transfer
    unspecified, which cv2 would colour-manage) against `ycbcr_to_rgb` with
    the SPS's: within 3 at every block's centre; the other range, and the
    matrix in `WRONG`, more than 10 off."""
    colour = (int(full), matrix) if matrix != 9 else (int(full), 2, 2, 9)
    (tmp_path / "c.h264").write_bytes(syn.pcm_stream([planes], colour, bit_depth=bit_depth))
    (bgr,) = cv2_read(tmp_path / "c.h264", capfd)
    sps = {"full_range": full, "matrix": matrix}
    if bit_depth == 8:                 # the port's H.264 reader parses no High 10 SPS
        sps = h264.parse_sps(h264.annexb_units((tmp_path / "c.h264").read_bytes())[0])
        assert (sps["full_range"], sps["matrix"]) == (full, matrix)
    centre = (slice(8, 9), slice(8, None, 16))

    def off(**kw) -> int:
        ours = h264.ycbcr_to_rgb(*planes, bit_depth=bit_depth, **kw)
        return int(np.abs(ours[centre].astype(int) - bgr[..., ::-1][centre]).max())

    assert off(full_range=sps["full_range"], matrix=sps["matrix"]) <= 3
    assert off(full_range=not full, matrix=matrix) > 10
    if matrix in WRONG:
        assert off(full_range=full, matrix=WRONG[matrix]) > 10


@pytest.mark.parametrize("full, matrix", COLOURS, ids=[f"{'full' if f else 'limited'}-m{m}"
                                                       for f, m in COLOURS])
def test_colour_follows_the_vui_as_cv2_does(tmp_path, capfd, full, matrix):
    """Flat 16 x 16 blocks of random Y'CbCr in an I_PCM stream whose VUI says
    the range (Android's yuvj420p is full) and matrix_coefficients (1,
    BT.709, usual at 1080p; 9, BT.2020, an HDR capture's): `ycbcr_to_rgb`
    with the SPS's `full_range` and `matrix` is within 3 of cv2 at every
    block's centre; the other matrix or range is far off."""
    held_at_block_centres(tmp_path, capfd, flat_blocks(matrix + 10 * full, 8), full, matrix, 8)


DEEP_COLOURS = [(full, matrix) for matrix in (1, 6, 9) for full in (False, True)]


@pytest.mark.parametrize("full, matrix", DEEP_COLOURS,
                         ids=[f"{'full' if f else 'limited'}-m{m}" for f, m in DEEP_COLOURS])
def test_ten_bit_colour_follows_the_vui_as_cv2_does(tmp_path, capfd, full, matrix):
    """The same at 10 bits (a High 10 I_PCM stream, the samples themselves):
    cv2 converts them on a path of their own (swscale's bicubic scaler), and
    `ycbcr_to_rgb(..., bit_depth=10)` is within 3 of it at every block's
    centre."""
    held_at_block_centres(tmp_path, capfd, flat_blocks(matrix + 10 * full + 100, 10), full,
                          matrix, 10)


def test_ten_bit_conversion_is_cv2s_on_smooth_pictures(tmp_path, capfd):
    """On smooth 10-bit pictures (chroma edges included) the port's
    conversion is within 4 levels of cv2's everywhere and equal at most
    pixels (measured: 4 at worst, about 70% equal): its chroma goes through
    swscale's bicubic kernel as cv2's does (rows doubled at the centred
    sites, columns a quarter of a sample ahead and each shown for two
    pixels), where the 8-bit path's bilinear upsampling is up to ~20 off on
    such pictures."""
    rng = np.random.default_rng(7)

    def smooth(h, w, lo, hi):
        z = rng.normal(size=(h // 8 + 2, w // 8 + 2))
        ys, xs = np.linspace(0, z.shape[0] - 1, h), np.linspace(0, z.shape[1] - 1, w)
        z = np.array([np.interp(xs, np.arange(z.shape[1]), row) for row in z])
        z = np.array([np.interp(ys, np.arange(z.shape[0]), col) for col in z.T]).T
        return np.rint(lo + (hi - lo) * (z - z.min()) / np.ptp(z)).astype(np.uint16)

    pictures = [(smooth(64, 96, 64, 940), smooth(32, 48, 160, 860), smooth(32, 48, 160, 860))
                for _ in range(3)]
    for colour in ((0, 2, 2, 6), (1, 2, 2, 1), (0, 2, 2, 9)):
        (tmp_path / "s.h264").write_bytes(syn.pcm_stream(pictures, colour, bit_depth=10))
        theirs = cv2_read(tmp_path / "s.h264", capfd)
        equal = 0.0
        for planes, bgr in zip(pictures, theirs):
            ours = h264.ycbcr_to_rgb(*planes, full_range=bool(colour[0]), matrix=colour[3],
                                     bit_depth=10).astype(int)
            diff = np.abs(ours - bgr[..., ::-1])
            assert diff.max() <= 4, (colour, diff.max())
            equal += (diff == 0).mean() / len(pictures)
        assert equal > 0.6, (colour, equal)


# tag sets cv2 colour-manages (full range, primaries, transfer, matrix), each
# at 8 and 10 bits and in both ranges; the port maps them (`colour`)
MANAGED = [(full, p, t, m, bd) for p, t, m in ((9, 18, 9), (9, 16, 9), (9, 1, 9), (1, 18, 1),
                                               (1, 16, 1), (12, 1, 1))
           for bd in (8, 10) for full in (0, 1)]


@pytest.mark.parametrize("full, primaries, transfer, matrix, bit_depth", MANAGED,
                         ids=[f"{p}-{t}-{m}-{bd}bit-{'full' if f else 'limited'}"
                              for f, p, t, m, bd in MANAGED])
def test_colour_managed_streams_are_held_to_cv2(tmp_path, capfd, full, primaries, transfer,
                                                matrix, bit_depth):
    """A stream tagged with BT.2020 primaries (9), Display P3 (12) or a PQ
    (16) / HLG (18) transfer: cv2 maps its gamut and tone (FFmpeg 8's
    swscale), and so does `ycbcr_to_rgb` given the tags: at the centres of
    `flat_blocks` (random codes over the whole range) within a mean of 0.5
    levels and 16 at worst (`test_torch_colour_bounds.py` holds 3072 colours
    a tag set); with the matrix and range alone it would be far off."""
    planes = flat_blocks(200 + bit_depth + full, bit_depth)
    colour = (full, primaries, transfer, matrix)
    (tmp_path / "m.h264").write_bytes(syn.pcm_stream([planes], colour, bit_depth=bit_depth))
    (bgr,) = cv2_read(tmp_path / "m.h264", capfd)
    centre = (slice(8, 9), slice(8, None, 16))

    def gap(**tags) -> np.ndarray:
        ours = h264.ycbcr_to_rgb(*planes, full_range=bool(full), matrix=matrix,
                                 bit_depth=bit_depth, **tags)
        return np.abs(ours[centre].astype(int) - bgr[..., ::-1][centre])

    held = gap(primaries=primaries, transfer=transfer)
    assert held.mean() <= 0.5 and held.max() <= 16, (held.mean(), held.max())
    assert gap().max() > 30


def test_bt2020_constant_luminance_is_refused_as_swscale_refuses_it():
    """matrix_coefficients 10 (BT.2020 constant luminance): swscale refuses
    it and cv2 hands back a buffer it never converted; the port raises,
    naming it."""
    y, cb, cr = flat_blocks(0, 8, 4)
    with pytest.raises(container.UnsupportedCodecError, match="constant luminance"):
        h264.ycbcr_to_rgb(y, cb, cr, matrix=10)


# ── what stays outside ──────────────────────────────────────

def sps_unit(profile: int, frame_mbs_only: int = 1, mbaff: int = 0) -> bytes:
    bw = syn.BitWriter()
    for v in (profile, 0, 40):
        bw.u(8, v)
    bw.ue(0)
    if profile in (100, 110, 122, 244):
        bw.ue(2 if profile == 122 else 1)
        bw.ue(2 if profile == 110 else 0)
        bw.ue(2 if profile == 110 else 0)
        bw.u(2, 0)
    for v in (0, 2, 1):
        bw.ue(v)
    bw.u(1, 0)
    bw.ue(2)
    bw.ue(1)
    bw.u(1, frame_mbs_only)
    if not frame_mbs_only:
        bw.u(1, mbaff)
    bw.u(3, 4)                                 # direct_8x8_inference, no cropping, no VUI
    bw.trailing()
    return syn.nal(3, 7, bw.data())


REFUSED = {"b_slices": None, "sp_slices": "H.264 SP/SI slices",
           "field": "H.264 interlaced (field) coding", "mbaff": "H.264 MBAFF",
           "high10": "H.264 High 10 profile", "high422": "H.264 High 4:2:2 profile",
           "high444": "H.264 High 4:4:4 Predictive profile",
           "hevc": None, "h264_in_avi": None}


@pytest.mark.parametrize("case", list(REFUSED))
def test_what_stays_outside_is_refused_by_name(tmp_path, capfd, case):
    """SP slices, field coding, MBAFF, High 10, High 4:2:2 and High 4:4:4
    raise UnsupportedCodecError naming the feature and ffmpeg, from
    probe_video or at the latest extract_frames.  B slices, HEVC and H.264
    in AVI, which raised before the port read them, now read as the JAX
    package reads them: a B-pyramid clip with `ctts` and FFmpeg's edit list,
    an `hvc1` B-pyramid from the HEVC writer with a CRA and its RASL
    pictures, and the stream as Annex B samples in an `H264` AVI (an `hvc1`
    entry with no hvcC box stays refused:
    `test_torch_mjpeg.py::test_other_codecs_need_ffmpeg`)."""
    path = tmp_path / "clip.mov"
    aus = syn.write_stream(0, frames=2, width=48, height=32)
    if case == "b_slices":
        writer = syn.Writer(0, frames=6, width=48, height=32, bframes=3, pyramid=True, refs=3,
                            num_ref_idx=2, restriction=True)
        aus = writer.stream()
        syn.write_mov(path, aus, 48, 32, media_time="ctts", display=writer.display)
        assert tvideo.probe_video(path) == jvideo.probe_video(path)
        ours = tvideo.extract_frames(path, tmp_path / "ours")
        theirs = jvideo.extract_frames(path, tmp_path / "theirs")
        capfd.readouterr()
        assert len(ours) == len(theirs) == 6
        planes = h264.decode_annexb(syn.annexb(aus))
        tol = rgb_tolerance(planes, (0, 2), tmp_path, capfd)
        for a, b in zip(ours, theirs):
            x, y = tvideo.read_image(a).astype(int), tvideo.read_image(b).astype(int)
            assert x.shape == y.shape == (32, 48, 3)
            assert np.abs(x - y).max() <= tol
        return
    if case == "hevc":
        from omfs4d_torch.io import hevc
        from tests import torch_hevc_syntax as hevc_syn

        writer = hevc_syn.Writer(0, gop="pyramid", frames=9, cra=True, width=48, height=32,
                                 colour=(0, 2))
        aus = writer.stream()
        hevc_syn.write_mov(path, aus, 48, 32, media_time="ctts", display=writer.display)
        assert container.index(path)[2]["codec"] == "hevc"
        assert tvideo.probe_video(path) == jvideo.probe_video(path)
        ours = tvideo.extract_frames(path, tmp_path / "ours")
        theirs = jvideo.extract_frames(path, tmp_path / "theirs")
        capfd.readouterr()
        assert len(ours) == len(theirs) == 9
        planes = hevc.decode_annexb(hevc_syn.annexb(aus))
        tol = rgb_tolerance(planes, (0, 2), tmp_path, capfd)
        for a, b in zip(ours, theirs):
            x, y = tvideo.read_image(a).astype(int), tvideo.read_image(b).astype(int)
            assert x.shape == y.shape == (32, 48, 3)
            assert np.abs(x - y).max() <= tol
        return
    if case == "h264_in_avi":
        from tests import torch_mkv_mux as mux

        path = mux.write_avi(tmp_path / "clip.avi",
                             [b"".join(b"\x00\x00\x00\x01" + u for u in au) for au in aus],
                             [any(u[0] & 0x1F == 5 for u in au) for au in aus], 48, 32, b"H264",
                             fps=25)
        assert container.index(path)[2]["codec"] == "h264"
        assert tvideo.probe_video(path) == jvideo.probe_video(path)
        ours = tvideo.extract_frames(path, tmp_path / "ours")
        theirs = jvideo.extract_frames(path, tmp_path / "theirs")
        capfd.readouterr()
        assert len(ours) == len(theirs) == 2
        for a, b in zip(ours, theirs):
            assert np.array_equal(tvideo.read_image(a), tvideo.read_image(b))
        return
    if case == "sp_slices":
        pps_id = h264.parse_pps([u for u in aus[0] if u[0] & 0x1F == 8][-1])["id"]
        bw = syn.BitWriter()
        for v in (0, 3, pps_id):
            bw.ue(v)
        bw.u(8, 1)
        bw.trailing()
        aus[1] = [syn.nal(2, 1, bw.data())]
    elif case in ("field", "mbaff", "high10", "high422", "high444"):
        sps = sps_unit({"field": 77, "mbaff": 77, "high10": 110, "high422": 122,
                        "high444": 244}[case], frame_mbs_only=0 if case in ("field", "mbaff")
                       else 1, mbaff=int(case == "mbaff"))
        aus[0] = [sps] + [u for u in aus[0] if u[0] & 0x1F != 7]
    syn.write_mov(path, aus, 48, 32)
    with pytest.raises(container.UnsupportedCodecError, match="ffmpeg") as err:
        tvideo.probe_video(path)
        tvideo.extract_frames(path, tmp_path / "out")
    assert REFUSED[case] in str(err.value)


# ── the build ───────────────────────────────────────────────

def test_no_gxx_means_no_decode(tmp_path, monkeypatch):
    """With no g++ the library cannot be built and reading raises with the
    reason: there is no decoding in Python on the reading path."""
    path = tmp_path / "clip.mp4"
    syn.write_mov(path, syn.write_stream(0, frames=2, width=48, height=32), 48, 32,
                  quicktime=False, audio=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    h264._library.cache_clear()
    try:
        assert tvideo.probe_video(path)["frame_count"] == 2       # no decode
        for fn in (lambda: h264.frames(path)[0], lambda: tvideo.extract_frames(path, tmp_path)):
            with pytest.raises(RuntimeError, match="no g\\+\\+") as err:
                fn()
            assert "h264dec.cpp" in str(err.value)
    finally:
        h264._library.cache_clear()
    assert not (tmp_path / "build").exists()


def test_importing_builds_nothing():
    """Importing the reader builds no library (the package walk needs no
    g++); the first decode builds it, under a name hashed from the source,
    the flags and the generated header."""
    code = ("import omfs4d_torch.io.h264 as h; print(h._library.cache_info().currsize)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.stdout.strip() == "0", res.stderr[-2000:]
    path = Path(h264._library()._name)
    assert path.parent == native.BUILD_DIR and path.name.startswith("libh264dec_")
    assert path == native.built_path(h264._SOURCE, "h264dec", h264._GXX_FLAGS,
                                     {"h264_tables.h": h264_tables.cpp_header()})


# ── the committed corpus ────────────────────────────────────

def planes_sha(planes) -> str:
    """SHA-256 of a picture's planes: their bytes, 8-bit samples as bytes,
    deeper ones as little-endian uint16."""
    h = hashlib.sha256()
    for p in planes:
        p = np.asarray(p)
        h.update(np.ascontiguousarray(p if p.dtype == np.uint8 else p.astype("<u2")).tobytes())
    return h.hexdigest()


def test_corpus_decodes_to_its_manifest():
    """Every stream of `tests/data/h264/` decodes to the SHA-256 of its
    planes in the manifest (written once cv2 agreed with them), and the
    phone clip reads as a 1080 x 1920 portrait."""
    manifest = json.loads((CORPUS / "manifest.json").read_text())
    assert sum(p.stat().st_size for p in CORPUS.iterdir()) <= 2 * 1024 * 1024
    for name, entry in manifest["streams"].items():
        path = CORPUS / name
        if path.suffix in (".mov", ".mp4"):
            frames = h264.frames(path)
            pics = [frames.ycbcr(i) for i in range(len(frames))]
        else:
            pics = h264.decode_annexb(path.read_bytes())
        assert [planes_sha(p) for p in pics] == entry["sha256"], name
    clip = CORPUS / "clip.mov"
    assert tvideo.probe_video(clip) == {"width": 1080, "height": 1920, "fps": 30.0,
                                        "frame_count": 6}


def test_committed_clip_reads_as_in_the_jax_package(tmp_path, capfd):
    """clip.mov, the corpus's phone capture (1080p High, CABAC, a 90-degree
    matrix, a sound track): the port's probe_video equals the JAX package's
    (size turned, fps, count), and extract_frames gives as many upright
    frames, each within the conversion tolerance the I_PCM stream of its
    pictures shows."""
    clip = CORPUS / "clip.mov"
    assert tvideo.probe_video(clip) == jvideo.probe_video(clip)
    ours = tvideo.extract_frames(clip, tmp_path / "ours")
    theirs = jvideo.extract_frames(clip, tmp_path / "theirs")
    capfd.readouterr()
    assert len(ours) == len(theirs) == 6
    frames = h264.frames(clip)
    planes = [frames.ycbcr(i) for i in range(6)]
    tol = rgb_tolerance(planes, (0, 1), tmp_path, capfd)
    for a, b in zip(ours, theirs):
        x, y = tvideo.read_image(a).astype(int), tvideo.read_image(b).astype(int)
        assert x.shape == y.shape == (1920, 1080, 3)
        assert np.abs(x - y).max() <= tol
