"""The port's H.264 rung on the CPU, with no ffmpeg, held to an independent
decoder: cv2's FFmpeg decodes what `omfs4d_torch.io.h264` writes, and H.264
decoding is normative, so a conforming decoder's output is the encoder's
reconstruction bit for bit.

- Luma: grey frames (R = G = B, so Cb = Cr = 128) of a moving pattern, an IDR
  then 29 P pictures at four sizes, four QPs and three kinds of content.
  cv2 gives grey levels; a lookup calibrated from an I_PCM stream holding
  every Y' in 16..235 (no coding error) maps them back to Y', and must be
  injective.  The mapped Y' equals the reconstruction exactly.
- Colour: cv2's decode of the coded stream equals its decode of an I_PCM
  stream holding the reconstruction, frame for frame over a 60-frame GOP
  (no drift); against the reconstruction converted to RGB by the port, cv2
  is within what it shows on that I_PCM stream.
- FFmpeg's stderr holds no `[h264 @` line for any stream the port writes.
- The JAX package's `probe_video` / `extract_frames` (cv2) read the port's
  `stitch_video` output; the port's reader (the host decoder) round-trips it
  exactly, and reads Main / High CABAC files and every macroblock feature the
  plain Python decoder refuses by name, as cv2 reads them (the random
  legal-syntax writer's streams; the whole of that decoder is held in
  `tests/test_torch_h264_high.py`)."""

from fractions import Fraction

import cv2
import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, h264
from omfs4d_torch.io import video as tvideo
from tests import torch_h264_syntax as syn

# FFmpeg's YUV -> BGR (cv2) against the port's `ycbcr_to_rgb`, mean grey
# levels: swscale's unscaled path, which the port runs bit for bit
# (`omfs4d_torch.io.swscale`)
JAX_READ_MEAN_TOL = 0.0
QPS = (10, 18, 30, 40)
CONTENTS = ("noise", "flat", "gradient")
SMALL = ((16, 16), (32, 48), (62, 100))
CASES = ([(size, qp, kind) for size in SMALL for qp in QPS for kind in CONTENTS]
         + [((512, 512), qp, kind) for qp, kind in zip(QPS, ("noise", "gradient", "flat",
                                                             "noise"))])


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)


def grey_clip(h, w, kind, n=30, seed=0):
    """n grey (H, W, 3) frames of a moving pattern: a noise texture, a flat
    square over a flat field, or a ramp, each moving a few samples a frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    texture = rng.integers(72, 184, (h + 64, w + 64))
    frames = []
    for t in range(n):
        if kind == "noise":
            g = texture[t % 7 + 2 * t // 3:, (3 * t) % 11:][:h, :w]
        elif kind == "flat":
            g = np.full((h, w), 90 + t)
            g[((yy - t) % h < h // 2) & ((xx - 2 * t) % w < w // 2)] = 160
        else:
            g = 60 + (2 * xx + yy + 3 * t) % 120
        frames.append(np.repeat(g[..., None].astype(np.uint8), 3, 2))
    return frames


def moving_field(h, w, n):
    """n frames of a smooth colour field moving a little each frame."""
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.stack([(np.sin(xx / 9 + t / 5 + k) * 0.5 + 0.5) * 200 + 20
                      + 10 * np.cos(yy / 7 + k) for k in range(3)], -1).astype(np.uint8)
            for t in range(n)]


def moving_patch(h, w, n):
    """n frames of a smooth colour field whose middle third moves a few
    samples a frame over a still border."""
    yy, xx = np.mgrid[0:h, 0:w]
    still = np.stack([(np.sin(xx / 9 + k) * 0.5 + 0.5) * 200 + 20 + 10 * np.cos(yy / 7 + k)
                      for k in range(3)], -1)
    frames = []
    for t in range(n):
        f = still.copy()
        mid = (slice(h // 3, 2 * h // 3), slice(w // 3, 2 * w // 3))
        f[mid] = np.roll(still, (t, 2 * t), (0, 1))[::-1][mid]
        frames.append(f.astype(np.uint8))
    return frames


def annex_b(stream: h264.H264Stream) -> bytes:
    """A stream as an Annex B byte stream (start code prefixes)."""
    units = [stream.sps, stream.pps] + [u for au in stream.access_units for u in au]
    return b"".join(b"\x00\x00\x00\x01" + u for u in units)


def pcm_stream(planes, fps=25.0) -> bytes:
    """An Annex B stream of (Y', Cb, Cr) pictures, each an IDR of one slice
    whose macroblocks are all I_PCM: the samples themselves, no coding."""
    h, w = planes[0][0].shape
    mbw, mbh = -(-w // 16), -(-h // 16)
    units = [h264.nal(3, 7, h264.sps_rbsp(w, h, Fraction(fps), h264.level_for(w, h, fps))),
             h264.nal(3, 8, h264.pps_rbsp(26))]
    for k, (y, cb, cr) in enumerate(planes):
        y = np.pad(y, ((0, 16 * mbh - h), (0, 16 * mbw - w)), mode="edge")
        cb, cr = (np.pad(c, ((0, 8 * mbh - h // 2), (0, 8 * mbw - w // 2)), mode="edge")
                  for c in (cb, cr))
        b = h264.slice_header(0, 7, True, 0, k % 2, 0)
        for m in range(mbw * mbh):
            r, c = divmod(m, mbw)
            b.ue(25)                                     # mb_type I_PCM
            b.u(-b.n % 8, 0)                             # pcm_alignment_zero_bits
            samples = np.concatenate([y[16 * r:16 * r + 16, 16 * c:16 * c + 16].ravel(),
                                      cb[8 * r:8 * r + 8, 8 * c:8 * c + 8].ravel(),
                                      cr[8 * r:8 * r + 8, 8 * c:8 * c + 8].ravel()])
            b.u(8 * samples.size, int.from_bytes(samples.astype(np.uint8).tobytes(), "big"))
        units.append(h264.nal(3, 5, b.rbsp()))
    return b"".join(b"\x00\x00\x00\x01" + u for u in units)


def cv2_read(path, capfd) -> list[np.ndarray]:
    """Every frame cv2 decodes from a file (BGR), with no line of FFmpeg's
    H.264 decoder on stderr."""
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    err = capfd.readouterr().err
    assert "[h264 @" not in err, err[-2000:]
    return frames


@pytest.fixture(scope="module")
def luma_lookup(tmp_path_factory):
    """cv2's grey level of every Y' (Cb = Cr = 128) read off an I_PCM stream,
    and its inverse over 16..235, where it must be injective: (grey of Y',
    Y' of grey with -1 elsewhere)."""
    ys = np.arange(256, dtype=np.uint8)
    c = np.full((8, 128), 128, np.uint8)
    path = tmp_path_factory.mktemp("pcm") / "luma.h264"
    path.write_bytes(pcm_stream([(np.tile(ys, (16, 1)), c, c)]))
    ok, frame = cv2.VideoCapture(str(path)).read()
    assert ok and (frame[..., 0] == frame[..., 1]).all() and (frame[..., 1] == frame[..., 2]).all()
    grey = frame[0, :, 0]
    assert len(set(grey[16:236].tolist())) == 220, "cv2's expansion of Y' is not injective"
    lookup = np.full(256, -1)
    lookup[grey[16:236]] = ys[16:236]
    return grey, lookup


# ── the standard's tables and rules ─────────────────────────

@pytest.mark.parametrize("name", ["coeff_token", "total_zeros", "run_before"])
def test_vlc_tables_are_prefix_codes(name):
    """Every variable-length table is a prefix code whose Kraft sum is at most
    1; Table 9-4's inter column is a permutation of the 48 patterns."""
    tables = {"coeff_token": h264._CT_VLC, "total_zeros": h264._TZ_VLC + h264._TZC_VLC,
              "run_before": h264._RB_VLC}[name]
    for table in tables:
        codes = sorted(table)
        assert all(not b.startswith(a) for a, b in zip(codes, codes[1:]))
        assert sum(2.0 ** -len(c) for c in codes) <= 1.0
    assert sorted(h264._INTER_CBP) == list(range(48))


def test_level_and_sizes():
    """Table A-1's lowest level by frame size and macroblock rate; odd sides
    and sizes beyond level 5.2 are refused."""
    assert h264.level_for(512, 512, 30) == 30
    assert h264.level_for(1920, 1080, 30) == 40
    assert h264.level_for(16, 16, 25) == 10
    assert h264.level_for(4096, 2304, 30) == 52
    assert h264.level_for(4096, 2304, 120) is None
    assert h264.level_for(4000, 16, 25) == 40          # a side beyond sqrt(8 MaxFS)
    assert h264.unsupported_size(100, 62, 25) is None
    assert "odd" in h264.unsupported_size(5, 4, 25)
    assert "5.2" in h264.unsupported_size(8192, 8192, 25)


def test_emulation_prevention():
    """00 00 0x (x <= 3) gets an 03 inserted, as often as needed, and the
    reader removes it again."""
    rbsp = b"\x00\x00\x00\x00\x00\x01\x00\x00\x02\x00\x00\x04\x00\x00\x03"
    unit = h264.nal(3, 1, rbsp)
    assert unit == (b"\x61\x00\x00\x03\x00\x00\x03\x00\x01\x00\x00\x03\x02\x00\x00\x04"
                    b"\x00\x00\x03\x03")
    assert h264._unescape(unit[1:]) == rbsp


def test_grey_gives_neutral_chroma():
    """R = G = B gives Cb = Cr = 128 exactly, for every grey level."""
    grey = np.repeat(np.repeat(np.arange(256, dtype=np.uint8)[None, :, None], 2, 0), 3, 2)
    y, cb, cr = h264.rgb_to_ycbcr(grey)
    assert (cb == 128).all() and (cr == 128).all()
    assert y[0, 0] == 16 and y[0, 255] == 235


# ── cv2 against the reconstruction ─────────────────────────

@pytest.mark.parametrize("size, qp, kind", CASES,
                         ids=[f"{s[1]}x{s[0]}-qp{q}-{k}" for s, q, k in CASES])
def test_luma_exact(tmp_path, capfd, luma_lookup, size, qp, kind):
    """An IDR then 29 P pictures of grey content: cv2's decode, mapped back to
    Y' through the I_PCM lookup, equals the reconstruction on every frame
    where it lies in 16..235 (frame_num wraps at 16 on the way); outside,
    where cv2 clips, its grey level is the one it gives that Y' in I_PCM."""
    h, w = size
    stream = h264.encode_h264(grey_clip(h, w, kind), 25.0, qp=qp)
    assert stream.idr == [True] + [False] * 29 and stream.qp == [qp] * 30
    path = tmp_path / "clip.h264"
    path.write_bytes(annex_b(stream))
    got = cv2_read(path, capfd)
    assert len(got) == 30
    grey_of, lookup = luma_lookup
    inside = 0
    for i, (frame, (y, cb, cr)) in enumerate(zip(got, stream.recon)):
        assert y.shape == (h, w) and (cb == 128).all() and (cr == 128).all()
        mapped = (y >= 16) & (y <= 235)
        np.testing.assert_array_equal(lookup[frame[..., 1]][mapped], y[mapped],
                                      err_msg=f"frame {i}")
        np.testing.assert_array_equal(frame[..., 1], grey_of[y], err_msg=f"frame {i}")
        inside += mapped.sum()
    assert inside >= 0.99 * 30 * h * w


def test_colour_exact_with_no_drift(tmp_path, capfd, monkeypatch):
    """A 60-frame GOP of colour: cv2's decode equals its decode of an I_PCM
    stream of the reconstruction on every frame, so its difference from the
    reconstruction is no larger on the last P picture than on the IDR;
    it equals `ycbcr_to_rgb` of the reconstruction, as cv2's decode of the
    I_PCM stream does.  The P pictures use vectors other than zero and
    skipped macroblocks."""
    frames = moving_patch(64, 80, 60)
    stream = h264.encode_h264(frames, 25.0)
    (tmp_path / "coded.h264").write_bytes(annex_b(stream))
    (tmp_path / "pcm.h264").write_bytes(pcm_stream(stream.recon))
    coded, pcm = cv2_read(tmp_path / "coded.h264", capfd), cv2_read(tmp_path / "pcm.h264", capfd)
    assert len(coded) == len(pcm) == 60
    drift = [np.abs(a.astype(int) - b).max() for a, b in zip(coded, pcm)]
    assert drift[-1] <= drift[0] and max(drift) == 0
    ours = [h264.ycbcr_to_rgb(*r)[..., ::-1].astype(int) for r in stream.recon]
    tol = max(np.abs(b - o).max() for b, o in zip(pcm, ours))
    assert max(np.abs(a - o).max() for a, o in zip(coded, ours)) <= tol == 0
    # the port's reader gives the reconstruction too; the P pictures hold
    # vectors other than zero and skipped macroblocks
    dec = h264.H264Decoder(stream.sps, stream.pps)
    pics = []
    real = h264._Picture.reconstruct

    def keep(pic, *args):
        pics.append(pic)
        return real(pic, *args)

    monkeypatch.setattr(h264._Picture, "reconstruct", keep)
    for au, r in zip(stream.access_units, stream.recon):
        for a, b in zip(dec.decode(au), r):
            np.testing.assert_array_equal(a, b)
    assert any(pic.mv.any() for pic in pics[1:]) and any(pic.skipped.any() for pic in pics[1:])


@pytest.mark.parametrize("keyint", [1, 250])
def test_level_escapes_and_idr_runs(tmp_path, capfd, monkeypatch, keyint):
    """QP 0 on flat white and full-range noise: the QP rises for a picture
    only where a level would need level_prefix > 15; with keyint 1 every
    picture is an IDR, idr_pic_id alternating.  cv2 decodes each exactly (its
    decode equals the I_PCM stream's) with no warning."""
    rng = np.random.default_rng(3)
    frames = [np.full((32, 48, 3), 255, np.uint8), rng.integers(0, 256, (32, 48, 3)),
              np.zeros((32, 48, 3)), rng.integers(0, 256, (32, 48, 3))]
    frames = [f.astype(np.uint8) for f in frames]
    monkeypatch.setattr(h264, "H264_KEYINT", keyint)
    stream = h264.encode_h264(frames, 25.0, qp=0)
    assert stream.idr == ([True] * 4 if keyint == 1 else [True, False, False, False])
    assert stream.qp[0] > 0 and min(stream.qp) == 0
    if keyint == 1:
        ids = []
        for au in stream.access_units:
            r = h264._Reader(h264._unescape(au[0][1:]))
            r.ue(), r.ue(), r.ue()       # first_mb_in_slice, slice_type, the PPS
            r.u(4)                       # frame_num
            ids.append(r.ue())           # idr_pic_id
        assert ids == [0, 1, 0, 1]
    (tmp_path / "coded.h264").write_bytes(annex_b(stream))
    (tmp_path / "pcm.h264").write_bytes(pcm_stream(stream.recon))
    coded, pcm = cv2_read(tmp_path / "coded.h264", capfd), cv2_read(tmp_path / "pcm.h264", capfd)
    assert len(coded) == 4
    for a, b in zip(coded, pcm):
        np.testing.assert_array_equal(a, b)
    dec = h264.H264Decoder(stream.sps, stream.pps)
    for au, r in zip(stream.access_units, stream.recon):
        for a, b in zip(dec.decode(au), r):
            np.testing.assert_array_equal(a, b)


# ── MP4, stitch_video and the JAX package ───────────────────

def test_stitch_video_is_h264_read_by_both_packages(tmp_path, capfd):
    """With no ffmpeg `stitch_video` writes an avc1 MP4 (cropped 100 x 62):
    the JAX package probes its count, size and fps through cv2 and extracts
    as many frames of that size, within a mean of JAX_READ_MEAN_TOL of the
    port's own read; the port reads back `encode_h264`'s reconstruction."""
    frames = moving_field(62, 100, 12)
    for i, f in enumerate(frames):
        tvideo.write_image(tmp_path / "src" / f"{i:05d}.png", f)
    out = tvideo.stitch_video(tmp_path / "src", tmp_path / "pred.mp4", fps=25)
    info = container.index(out)[2]
    assert (info["codec"], info["sync"]) == ("h264", [0])
    want = {"width": 100, "height": 62, "fps": 25.0, "frame_count": 12}
    assert tvideo.probe_video(out) == jvideo.probe_video(out) == want
    ours = tvideo.extract_frames(out, tmp_path / "ours")
    theirs = jvideo.extract_frames(out, tmp_path / "theirs")
    assert "[h264 @" not in capfd.readouterr().err
    assert [p.name for p in ours] == [p.name for p in theirs] and len(ours) == 12
    stream = h264.encode_h264(frames, 25.0)
    for a, b, r in zip(ours, theirs, stream.recon):
        x, y = tvideo.read_image(a).astype(int), tvideo.read_image(b).astype(int)
        assert x.shape == y.shape == (62, 100, 3)
        assert np.abs(x - y).mean() <= JAX_READ_MEAN_TOL
        np.testing.assert_array_equal(x, h264.ycbcr_to_rgb(*r))


def test_reader_round_trip_and_random_access(tmp_path, monkeypatch):
    """`h264.frames` of an MP4 with an IDR every 4 frames gives the
    reconstruction bit for bit, in any order of access; `probe` reads the
    boxes and the SPS; extract_frames keeps every stride-th frame."""
    frames = moving_patch(48, 64, 10)
    monkeypatch.setattr(h264, "H264_KEYINT", 4)
    path = h264.write(tmp_path / "clip.mp4", frames, 30000 / 1001, 64, 48)
    stream = h264.encode_h264(frames, 30000 / 1001)
    got = h264.frames(path)
    assert len(got) == 10 and got.sync == [0, 4, 8]
    for i in (7, 2, 2, 3, 9, 0, 5):
        for a, b in zip(got.ycbcr(i), stream.recon[i]):
            np.testing.assert_array_equal(a, b)
    assert got.probe() == {"width": 64, "height": 48, "fps": 30000 / 1001,
                           "frame_count": 10}
    paths = tvideo.extract_frames(path, tmp_path / "out", stride=3, max_frames=3)
    assert len(paths) == 3
    for p, i in zip(paths, (0, 3, 6)):
        np.testing.assert_array_equal(tvideo.read_image(p), h264.ycbcr_to_rgb(*stream.recon[i]))


def cabac_clip(path, profile: int) -> list[list[bytes]]:
    """An MP4 file (avc1) of a random CABAC stream, 48 x 32, 3 frames at 25
    fps: High profile, or a Baseline SPS whose PPS selects CABAC; returns its
    access units."""
    aus = syn.write_stream(0, profile=profile, cabac=True, t8x8=profile == 100, frames=3,
                           refs=2, num_ref_idx=2)
    syn.write_mov(path, aus, 48, 32, fps=25, quicktime=False, audio=False)
    return aus


def held_to_cv2(tmp_path, capfd, aus) -> list:
    """The host decoder's pictures of a stream, after checking that cv2's
    decode of it equals cv2's decode of an I_PCM stream of them."""
    data = syn.annexb(aus)
    ours = h264.decode_annexb(data)
    (tmp_path / "coded.h264").write_bytes(data)
    (tmp_path / "pcm.h264").write_bytes(syn.pcm_stream(ours))
    coded, pcm = cv2_read(tmp_path / "coded.h264", capfd), cv2_read(tmp_path / "pcm.h264", capfd)
    assert len(coded) == len(pcm) == len(ours)
    for a, b in zip(coded, pcm):
        np.testing.assert_array_equal(a, b)
    return ours


@pytest.mark.parametrize("case", ["high_cabac", "baseline_cabac"])
def test_reader_refuses_other_streams_by_name(tmp_path, capfd, case):
    """A High-profile stream with CABAC, and a Baseline SPS whose PPS selects
    CABAC, which the port refused before its host decoder, now read through
    probe_video, extract_frames and h264.frames: the probe is the JAX
    package's, the frames those cv2 decodes (its decode of the file equals its
    decode of an I_PCM stream of the port's pictures), converted by the port."""
    path = tmp_path / "clip.mp4"
    aus = cabac_clip(path, 100 if case == "high_cabac" else 66)
    pictures = held_to_cv2(tmp_path, capfd, aus)
    want = {"width": 48, "height": 32, "fps": 25.0, "frame_count": 3}
    assert tvideo.probe_video(path) == jvideo.probe_video(path) == want
    paths = tvideo.extract_frames(path, tmp_path / "out")
    got = h264.frames(path)
    assert len(paths) == len(got) == 3
    for p, i in zip(paths, (0, 1, 2)):
        np.testing.assert_array_equal(tvideo.read_image(p), h264.ycbcr_to_rgb(*pictures[i]))
        for a, b in zip(got.ycbcr(i), pictures[i]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(container.UnsupportedCodecError, match="ffmpeg") as err:
        h264.H264Decoder(*(u for u in aus[0] if u[0] & 0x1F in (7, 8)))
    assert ("H.264 High profile (CABAC)" if case == "high_cabac" else "H.264 CABAC") \
        in str(err.value)


# the plain decoder's own subset, which `encode_h264` writes: Constrained
# Baseline CAVLC, Intra_16x16 luma H / DC and chroma DC / H, P_L0_16x16 with
# whole-sample vectors and P_Skip, one reference, no deblocking
PLAIN_SUBSET = dict(profile=66, cabac=False, t8x8=False, kinds=("I16", "P16x16"),
                    i16_modes=(1, 2), chroma_modes=(0, 1), pcm=0.0, intra_in_p=0.0,
                    whole_mv=True, deblock=(1,), refs=1, num_ref_idx=1, frames=3, width=96,
                    height=64)
# each case: the one feature outside it, and what the writer must have used
OUTSIDE = {"deblocking": (dict(deblock=(0,)), "deblock0"),
           "inxn": (dict(kinds=("I16", "I4x4", "P16x16")), "I4x4"),
           "pcm": (dict(pcm=0.3), "IPCM"),
           "partition": (dict(kinds=("I16", "P16x16", "P16x8", "P8x16", "P8x8")), "P8x8"),
           "intra_in_p": (dict(intra_in_p=0.5), "I16"),
           "subsample": (dict(whole_mv=False), "fractional_mv"),
           "luma_v": (dict(i16_modes=(0, 1, 2)), "i16_mode0"),
           "luma_plane": (dict(i16_modes=(1, 2, 3)), "i16_mode3"),
           "chroma_v": (dict(chroma_modes=(0, 1, 2)), "chroma_mode2"),
           "chroma_plane": (dict(chroma_modes=(0, 1, 3)), "chroma_mode3")}


@pytest.mark.parametrize("kind, name", [
    ("deblocking", "the deblocking filter"), ("inxn", "I_NxN"), ("pcm", "I_PCM"),
    ("partition", "P macroblock partitions below 16x16"),
    ("intra_in_p", "intra macroblocks in P slices"),
    ("subsample", "fractional-sample motion vectors"),
    ("luma_v", "Intra_16x16 vertical prediction"),
    ("luma_plane", "Intra_16x16 plane prediction"),
    ("chroma_v", "intra chroma vertical prediction"),
    ("chroma_plane", "intra chroma plane prediction")])
def test_decoder_refuses_macroblocks_outside_the_subset(tmp_path, capfd, kind, name):
    """A stream inside the plain decoder's subset but for one feature, which
    the port's reader refused before its host decoder: the host decoder now
    decodes it as cv2 does (its decode of the stream equals its decode of an
    I_PCM stream of the port's pictures); the plain `H264Decoder` still
    raises UnsupportedCodecError naming the feature."""
    extra, used = OUTSIDE[kind]
    writer = syn.Writer(3, **dict(PLAIN_SUBSET, **extra))
    aus = writer.stream()
    assert writer.stats[used], dict(writer.stats)
    held_to_cv2(tmp_path, capfd, aus)
    units = [u for au in aus for u in au]
    dec = h264.H264Decoder(*(u for u in units if u[0] & 0x1F in (7, 8)))
    with pytest.raises(container.UnsupportedCodecError, match="ffmpeg") as err:
        for au in aus:
            dec.decode([u for u in au if u[0] & 0x1F not in (7, 8)])
    assert f"H.264 {name}" in str(err.value)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reader_decodes_intra_modes_with_every_neighbour(tmp_path, capfd, seed):
    """One-slice IDR pictures (the upper neighbour available too, unlike the
    encoder's one slice a row) of Intra_16x16 macroblocks with random levels
    and the modes the encoder writes, as their neighbours allow (luma H and
    DC, chroma DC and H), written by the encoder's slice writer: cv2's
    decode equals its decode of an I_PCM stream of the port's."""
    rng = np.random.default_rng(seed)
    rows, cols, qp = 3, 4, 28
    n = rows * cols
    enc = h264.H264Encoder(16 * cols, 16 * rows, 25.0, qp)
    y, x = np.divmod(np.arange(n), cols)
    luma, chroma = np.empty(n, np.int64), np.empty(n, np.int64)
    for m in range(n):                # each mode its neighbours allow, in turn
        left = int(x[m] > 0)
        allowed = [2] + [1] * left, [0] + [1] * left
        luma[m], chroma[m] = (a[(m + y[m] + seed) % len(a)] for a in allowed)

    def sparse(*shape):
        return rng.integers(-3, 4, shape) * (rng.random(shape) < 0.3)

    dc, ac, cdc, cac = sparse(n, 16), sparse(n, 16, 15), sparse(n, 2, 4), sparse(n, 2, 4, 15)
    ac[rng.random(n) < 0.3] = 0                           # some cbp luma 0
    cac[rng.random(n) < 0.3] = 0
    cdc[rng.random(n) < 0.2] = 0
    cbp_luma = np.where(np.any(ac != 0, (1, 2)), 15, 0)
    ac[cbp_luma == 0] = 0
    cbp_chroma = np.where(np.any(cac != 0, (1, 2, 3)), 2, np.where(np.any(cdc != 0, (1, 2)), 1, 0))
    mb_type = 1 + luma + 4 * cbp_chroma + np.where(cbp_luma == 15, 12, 0)
    every = np.ones(n, bool)
    fields = [(h264._ue_bits(mb_type), every), (h264._ue_bits(chroma), every),
              (h264._se_bits(np.zeros(n)), every)]
    units = enc._slices([h264.slice_header(0, 7, True, 0, 0, 0)], np.zeros(n, np.int64),
                        fields, dc, ac, cdc, cac, cbp_luma, cbp_chroma, top_in_slice=True,
                        nal_type=5)
    ours = h264.H264Decoder(enc.sps, enc.pps).decode(units)
    (tmp_path / "modes.h264").write_bytes(b"".join(
        b"\x00\x00\x00\x01" + u for u in [enc.sps, enc.pps] + units))
    (tmp_path / "pcm.h264").write_bytes(pcm_stream([ours]))
    (coded,), (pcm,) = cv2_read(tmp_path / "modes.h264", capfd), cv2_read(tmp_path / "pcm.h264",
                                                                          capfd)
    np.testing.assert_array_equal(coded, pcm)
    assert ours[0].std() > 0 and (set(luma), set(chroma)) == ({1, 2}, {0, 1})
