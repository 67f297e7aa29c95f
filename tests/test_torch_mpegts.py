"""MPEG transport streams (`.ts`, M2TS / AVCHD `.mts` / `.m2ts`) read by the
port (`omfs4d_torch.io.mpegts`) as cv2 reads them, on the CPU, with no
ffmpeg: `probe_video` equal to cv2's width, height, fps and frame count (the
JAX package's), every frame equal to `cv2.VideoCapture`'s bit for bit, and
both packages' `extract_frames` PNGs equal where a test says so.

- Small H.264 (B-pyramid), HEVC (B pictures, a CRA with RASL pictures) and
  MPEG-4 Part 2 (cv2's own `mp4v`, odd sizes among them) streams in each
  variant of the test muxer (`tests/torch_ts_mux.py`): 188-, 192- and
  204-byte packets, several access units to a PES, one split across PES,
  PES_packet_length set or 0, access unit delimiters, a PES with no PTS,
  an audio PID listed first, two programs in either order, a PTS wrap.
- Starts mid-GOP: what cv2 drops before the first IDR / IRAP picture, and
  MPEG-4's leading P-VOPs predicted from grey; an H.264 start cv2 shows
  from a non-IDR picture is refused by name.
- Damage: a lost packet, a file cut mid-packet, garbage before a resync:
  cv2's probe, cv2's frames up to the damaged one, which raises ValueError
  (cv2 shows FFmpeg's concealment); files cv2 cannot open raise ValueError.
- Refused by name: H.264 MVC, JPEG 2000, VC-1, VVC, AVS, Dirac, a private
  stream of video, scrambled packets, no video, interlaced H.264 (MPEG-1 /
  2, once refused here, are read: `tests/test_torch_mpeg2.py`).
- The committed corpus (`tests/data/mpegts/manifest.json`) against the
  muxer and the port; the HLG clip as the port reads its QuickTime source.
"""

import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, hevc, mpegts
from omfs4d_torch.io.frames import annexb_units
from omfs4d_torch.io import video as tvideo
from tests import torch_h264_syntax as syn
from tests import torch_hevc_syntax as hsyn
from tests import torch_ts_mux as mux
from tests.test_torch_mpeg4 import cv2_write, moving_clip

CORPUS = Path(__file__).resolve().parent / "data" / "mpegts"


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setattr(jvideo, "find_ffmpeg", lambda: None)


def cv2_read(path) -> tuple[dict, list[np.ndarray]]:
    """cv2's probe (as the JAX package's `probe_video` reports it) and its
    frames, RGB."""
    probe = jvideo.probe_video(path)
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(frame[..., ::-1]))
    cap.release()
    return probe, frames


def read_as_cv2(path, tmp_path, capfd=None, extract: bool = True) -> list[np.ndarray]:
    """The port's probe and frames equal cv2's, bit for bit, and so do the
    two packages' `extract_frames` PNGs where `extract`; returns the
    frames."""
    probe, theirs = cv2_read(path)
    if capfd is not None:
        capfd.readouterr()
    reader = tvideo._own_reader(Path(path))
    ours = [reader.rgb(i) for i in range(len(reader))]
    assert tvideo.probe_video(path) == probe
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == b.shape and np.array_equal(a, b), f"{path}: frame {i}"
    if extract:
        mine = tvideo.extract_frames(path, tmp_path / "port", stride=2)
        jax = jvideo.extract_frames(path, tmp_path / "jax", stride=2)
        assert len(mine) == len(jax) == len(theirs[::2])
        for a, b in zip(mine, jax):
            assert np.array_equal(tvideo.read_image(a), jvideo.read_image(b))
    return ours


def read_until_damaged(path, capfd=None) -> int:
    """The port's probe equals cv2's, its frames are cv2's up to a damaged
    one, which raises ValueError naming the damage; returns its index."""
    probe, theirs = cv2_read(path)
    if capfd is not None:
        capfd.readouterr()
    assert tvideo.probe_video(path) == probe
    reader = tvideo._own_reader(Path(path))
    assert len(reader) == len(theirs)
    for i in range(len(reader)):
        try:
            frame = reader.rgb(i)
        except ValueError as e:
            assert "damaged PES" in str(e)
            return i
        assert np.array_equal(frame, theirs[i]), f"{path}: frame {i}"
    raise AssertionError(f"{path}: no frame raised")


# ── small streams ───────────────────────────────────────────

def annexb(au: list[bytes]) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + u for u in au)


def times(display: list[int], step: int = 3600, base: int = mux.PTS_BASE) -> tuple[list, list]:
    """PTS and DTS of frames in decoding order whose places in output order
    are `display`, a frame every `step` ticks."""
    shift = max(k - s for k, s in enumerate(display))
    return ([base + (shift + s) * step for s in display],
            [base + k * step for k in range(len(display))])


def h264_stream(frames: int = 12, seed: int = 0, **features) -> dict:
    """A B-pyramid H.264 stream at 25 fps, an IDR every 6 frames, its
    parameter sets before each."""
    features = {"bframes": 3, "pyramid": True, "refs": 3, "num_ref_idx": 2,
                "restriction": True, "idr_every": 6, **features}
    w = syn.Writer(seed, frames=frames, width=48, height=32, **features)
    aus = w.stream()
    sets = [u for u in aus[0] if u[0] & 0x1F in (7, 8)]
    out = [annexb(au if k == 0 or not any(u[0] & 0x1F == 5 for u in au) else sets + au)
           for k, au in enumerate(aus)]
    pts, dts = times(w.display)
    return {"aus": out, "pts": pts, "dts": dts, "codec": "h264",
            "key": [any(u[0] & 0x1F == 5 for u in au) for au in aus]}


def hevc_stream(frames: int = 12, seed: int = 3, **features) -> dict:
    """An HEVC stream of B pictures with a CRA and its RASL pictures at
    25 fps, its parameter sets before each IRAP picture."""
    features = {"gop": "b", "cra": True, **features}
    w = hsyn.Writer(seed, frames=frames, width=64, height=48, **features)
    aus = w.stream()
    sets = [u for u in aus[0] if hevc.nal_type(u) in (32, 33, 34)]
    irap = [any(16 <= hevc.nal_type(u) <= 23 for u in au) for au in aus]
    out = [annexb(au if k == 0 or not irap[k] else sets + au) for k, au in enumerate(aus)]
    pts, dts = times(list(getattr(w, "display", range(frames))))
    return {"aus": out, "pts": pts, "dts": dts, "codec": "hevc", "key": irap}


def mpeg4_stream(tmp_path, frames: int = 12, size=(48, 32)) -> dict:
    """cv2's own `mp4v` (FFmpeg's encoder, an I-VOP every 12) taken out of
    its AVI: the VOS / VOL headers before the first VOP, as in band."""
    path = tmp_path / f"src_{size[0]}x{size[1]}.avi"
    cv2_write(path, "mp4v", moving_clip(frames, size[1], size[0]))
    offsets, sizes, info = container.index(path)
    raw = path.read_bytes()
    aus = [raw[o:o + s] for o, s in zip(offsets, sizes)]
    pts, dts = times(list(range(frames)))
    return {"aus": aus, "pts": pts, "dts": dts, "codec": "mpeg4",
            "key": [k % 12 == 0 for k in range(frames)]}


def stream(codec: str, tmp_path, **features) -> dict:
    if codec == "h264":
        return h264_stream(**features)
    if codec == "hevc":
        return hevc_stream(**features)
    return mpeg4_stream(tmp_path, **features)


def write(path, s: dict, start: int = 0, **options) -> Path:
    return mux.write_ts(path, s["aus"][start:], s["pts"][start:], s["dts"][start:],
                        codec=s["codec"], key=s["key"][start:], **options)


VARIANTS = {"188": {}, "192": {"packet": 192}, "204": {"packet": 204},
            "pes-length": {"pes_length": True}, "group2": {"group": 2},
            "group3-length": {"group": 3, "pes_length": True, "packet": 192},
            "split2": {"split": 2}, "split3-length": {"split": 3, "pes_length": True},
            "no-pts": {"no_pts": frozenset({3})}, "audio-first": {"audio": True},
            "audio-first-m2ts": {"audio": True, "packet": 192},
            "second-program": {"second": "h264"}, "second-program-first": {
                "second": "hevc", "second_first": True}}
CASES = [(codec, variant) for codec in ("h264", "hevc", "mpeg4") for variant in VARIANTS]


@pytest.mark.parametrize("codec, variant", CASES, ids=[f"{c}-{v}" for c, v in CASES])
def test_muxer_variants_read_as_cv2(tmp_path, capfd, codec, variant):
    """Each codec in each of the muxer's layouts: the probe and every frame
    as cv2 gives them, both packages' extract_frames alike; a second
    program's video (its PMT first in the file) is the one cv2 reads."""
    options = dict(VARIANTS[variant])
    if "second" in options:
        options["second"] = stream(options["second"], tmp_path, seed=5) \
            if options["second"] != codec else stream(codec, tmp_path, frames=6)
    s = stream(codec, tmp_path)
    path = write(tmp_path / f"{variant}.ts", s, **options)
    info = container.index(path)[2]
    assert info["container"] == "mpegts" and info["codec"] in (codec, options.get(
        "second", {}).get("codec"))
    assert info["packet_size"] == options.get("packet", 188)
    read_as_cv2(path, tmp_path, capfd, extract=variant in ("188", "group2", "audio-first"))


@pytest.mark.parametrize("codec", ["h264", "hevc", "mpeg4"])
@pytest.mark.parametrize("aud", [False, True], ids=["no-aud", "aud"])
def test_access_unit_delimiters_and_pts_wrap(tmp_path, capfd, codec, aud):
    """Access unit delimiters (the parser's frames then start at them) and
    time stamps that wrap at 2**33 within the file: FFmpeg unwraps them
    before the rate and the duration, so does the port."""
    s = stream(codec, tmp_path)
    if aud and codec != "mpeg4":
        s["aus"] = [mux.AUD[codec] + au for au in s["aus"]]
    shift = (1 << 33) - 5 * 3600 - s["dts"][0]
    s["pts"] = [t + shift for t in s["pts"]]
    s["dts"] = [t + shift for t in s["dts"]]
    path = write(tmp_path / "wrap.ts", s, audio=aud)
    read_as_cv2(path, tmp_path, capfd, extract=False)


RATES = [("h264", 25, 3600), ("h264", 25, 3000), ("h264", 0, 3003), ("hevc", 25, 3000),
         ("hevc", 0, 3003), ("hevc", 30, 3600)]


@pytest.mark.parametrize("codec, vui, step", RATES, ids=[f"{c}-vui{v}-{s}" for c, v, s in RATES])
def test_rate_and_count_as_cv2(tmp_path, codec, vui, step):
    """cv2's CAP_PROP_FPS of a transport stream: the average of the frames'
    durations from the VUI's rate where it has one (so 25 at a 30 fps PTS),
    else FFmpeg's estimate from the decoding times; the count from the
    times' span: 24 frames, past find_stream_info's 21."""
    s = (h264_stream(24, fps=vui, bframes=0, pyramid=False, refs=1, num_ref_idx=1,
                     restriction=False) if codec == "h264" else
         hevc_stream(24, fps=vui, gop="p", cra=False))
    s["pts"], s["dts"] = times(list(range(24)), step)
    path = write(tmp_path / "rate.ts", s)
    probe = jvideo.probe_video(path)
    assert tvideo.probe_video(path) == probe
    if codec == "h264":                       # the writer's H.264 VUI always has the rate
        assert probe["fps"] == vui or probe["fps"] == pytest.approx(30000 / 1001)


# ── starts mid-GOP ──────────────────────────────────────────

def test_h264_start_at_p_drops_to_the_idr(tmp_path, capfd):
    """A capture that starts at a P picture (parameter sets in every access
    unit): cv2 drops the pictures before the first IDR, and so does the
    port; the count is the PTS span's."""
    s = h264_stream(18, bframes=0, pyramid=False, refs=3, num_ref_idx=2, restriction=False)
    sets = [u for u in annexb_units(s["aus"][0]) if u[0] & 0x1F in (7, 8)]
    s["aus"] = [au if k % 6 == 0 else annexb(sets) + au for k, au in enumerate(s["aus"])]
    path = write(tmp_path / "p.ts", s, start=2)
    frames = read_as_cv2(path, tmp_path, capfd, extract=False)
    assert len(frames) == 12 and tvideo.probe_video(path)["frame_count"] == 16


def test_h264_start_at_a_shown_non_idr_picture_refused(tmp_path):
    """A start at a non-IDR I picture whose PPS has one default reference,
    which FFmpeg's heuristic shows (or one with a recovery point SEI): cv2
    shows it and the pictures after it; the port, which starts a decode
    only at an IDR picture, refuses it by name rather than drop them."""
    s = h264_stream(12, bframes=0, pyramid=False, refs=1, num_ref_idx=1, restriction=False,
                    idr_every=0, i_slices_in_p=1.0)
    sets = [u for u in annexb_units(s["aus"][0]) if u[0] & 0x1F in (7, 8)]
    s["aus"] = [au if k == 0 else annexb(sets) + au for k, au in enumerate(s["aus"])]
    path = write(tmp_path / "i.ts", s, start=3)
    assert len(cv2_read(path)[1]) == 9
    with pytest.raises(container.UnsupportedCodecError, match="non-IDR I picture"):
        tvideo._own_reader(path)


@pytest.mark.parametrize("start", [1, 2, 4], ids=lambda s: f"start{s}")
def test_hevc_start_before_a_cra(tmp_path, capfd, start):
    """A capture that starts at trailing pictures before a CRA: cv2 drops
    them and the CRA's RASL pictures (the stream's first IRAP), and so does
    the port."""
    s = hevc_stream(12)
    read_as_cv2(write(tmp_path / "cra.ts", s, start=start), tmp_path, capfd, extract=False)


@pytest.mark.parametrize("size", [(48, 32), (50, 38)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_mpeg4_start_at_p_vop_predicts_from_grey(tmp_path, capfd, size):
    """A capture that starts at a P-VOP (the VOL before it): cv2 shows it,
    predicted from FFmpeg's dummy picture (grey over the picture, 0 past it
    in the whole macroblocks), and so does the port, bit for bit."""
    s = mpeg4_stream(tmp_path, 20, size)
    head = s["aus"][0][:s["aus"][0].find(b"\x00\x00\x01\xb6")]
    s["aus"][3] = head + s["aus"][3]
    frames = read_as_cv2(write(tmp_path / "p.ts", s, start=3), tmp_path, capfd, extract=False)
    assert len(frames) == 17


# ── damage ──────────────────────────────────────────────────

@pytest.mark.parametrize("codec", ["h264", "hevc", "mpeg4"])
def test_lost_packet_and_cut_file(tmp_path, capfd, codec):
    """A packet lost in the last access unit, and a file cut inside its
    last packet: cv2's probe, cv2's frames before the damaged one, which
    raises ValueError (cv2 shows FFmpeg's concealment of it)."""
    s = stream(codec, tmp_path)
    data = write(tmp_path / "full.ts", s).read_bytes()
    video = [k for k in range(len(data) // 188) if data[188 * k + 1] & 0x1F == 1
             and data[188 * k + 2] == 0]
    lost = write(tmp_path / "lost.ts", s, drop=frozenset({len(video) - 2}))
    assert read_until_damaged(lost, capfd) > 0
    last = max(k for k in video if not data[188 * k + 1] & 0x40)
    cut = tmp_path / "cut.ts"
    cut.write_bytes(data[:188 * last + 100])
    assert read_until_damaged(cut, capfd) > 0


def test_cut_at_the_last_pes_start_and_before_any_frame(tmp_path, capfd):
    """A file cut inside the first packet of its last PES: FFmpeg drops the
    access unit, so does the port, every frame cv2's.  A file cut before
    2,040 bytes: FFmpeg does not take it for a transport stream and cv2
    cannot open it; the port raises ValueError."""
    s = h264_stream(12)
    full = write(tmp_path / "full.ts", s).read_bytes()
    last = max(k for k in range(len(full) // 188)
               if full[188 * k + 1] == 0x41 and full[188 * k + 2] == 0x00)
    path = tmp_path / "cut.ts"
    path.write_bytes(full[:188 * last + 100])
    assert len(read_as_cv2(path, tmp_path, capfd, extract=False)) == 11
    path.write_bytes(full[:1500])
    assert cv2_read(path)[0]["frame_count"] <= 0
    with pytest.raises(ValueError, match="2,040 bytes"):
        tvideo._own_reader(path)


@pytest.mark.parametrize("packet, at", [(188, 188 * 7 + 5), (192, 192 * 9)],
                         ids=["inside-188", "between-192"])
def test_garbage_then_resync(tmp_path, capfd, packet, at):
    """Bytes that are no packet, inside one or between two: FFmpeg resyncs
    on the next 0x47 as the port does; the PES the garbage reaches is
    damaged, the frames before it cv2's."""
    s = h264_stream(12)
    data = write(tmp_path / "full.ts", s, packet=packet).read_bytes()
    path = tmp_path / "garbage.ts"
    path.write_bytes(data[:at] + bytes(range(40, 140)) + data[at:])
    assert read_until_damaged(path, capfd) >= 0


# ── refused ─────────────────────────────────────────────────

REFUSED = {"H.264 MVC": {"stream_type": 0x20}, "JPEG 2000": {"stream_type": 0x21},
           "VC-1": {"stream_type": 0xEA}, "H.266 / VVC": {"stream_type": 0x33},
           "AVS": {"stream_type": 0x42}, "Dirac": {"stream_type": 0xD1},
           "VC-1 ": {"stream_type": 0x06, "descriptor": mux.registration(b"VC-1")},
           "private stream": {"stream_type": 0x06},
           "scrambled": {"scrambled": True}}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_by_name(tmp_path, name):
    """Video the port does not decode, whatever the bytes hold: the stream
    type FFmpeg goes by (H.264 MVC, JPEG 2000, VC-1, VVC, AVS, Dirac; 0x06 with a
    `VC-1` registration or none, whose content FFmpeg probes), and
    scrambled packets: `UnsupportedCodecError` naming it."""
    path = write(tmp_path / "r.ts", h264_stream(6), **REFUSED[name])
    with pytest.raises(container.UnsupportedCodecError, match=name.strip()):
        tvideo.probe_video(path)


def test_no_video_refused(tmp_path):
    """A transport stream of audio alone: `UnsupportedCodecError` saying it
    has no video."""
    ps = mux.Packets()
    ps.put(mux.PID_PAT, mux.pat([(1, mux.PID_PMT)]), psi=True)
    ps.put(mux.PID_PMT, mux.pmt(1, mux.PID_AUDIO, [(0x0F, mux.PID_AUDIO, b"")]), psi=True)
    for k in range(40):
        ps.put(mux.PID_AUDIO, mux.pes(0xC0, mux.ADTS_SILENCE, mux.PTS_BASE + 1920 * k, None, True))
    path = tmp_path / "audio.ts"
    path.write_bytes(b"".join(p for _, p in ps.out))
    with pytest.raises(container.UnsupportedCodecError, match="no video"):
        tvideo.probe_video(path)


def test_hevc_registration_in_private_stream_read(tmp_path, capfd):
    """Stream type 0x06 with a registration descriptor `HEVC`: FFmpeg takes
    it for HEVC video, and so does the port."""
    path = write(tmp_path / "reg.ts", hevc_stream(), stream_type=0x06,
                 descriptor=mux.registration(b"HEVC"))
    read_as_cv2(path, tmp_path, capfd, extract=False)


def interlaced_sps(mbaff: bool) -> bytes:
    """An H.264 High profile SPS of a 1080i picture (frame_mbs_only_flag 0),
    as an AVCHD camcorder's: MBAFF or field pictures (PAFF)."""
    bw = syn.BitWriter()
    bw.u(8, 100)
    bw.u(8, 0)
    bw.u(8, 40)
    for v in (0, 1, 0, 0):                    # sps id, 4:2:0, 8 bits, 8 bits
        bw.ue(v)
    bw.u(1, 0)
    bw.u(1, 0)
    for v in (0, 0, 0, 2):                    # frame_num, POC type 0, its bits, refs
        bw.ue(v)
    bw.u(1, 0)
    bw.ue(119)
    bw.ue(33)                                 # 68 field MB rows: 34 map units
    bw.u(1, 0)                                # frame_mbs_only_flag
    bw.u(1, int(mbaff))
    bw.u(1, 1)
    bw.u(1, 0)
    bw.u(1, 0)
    bw.trailing()
    return bytes([0x67]) + bw.data()


@pytest.mark.parametrize("mbaff", [True, False], ids=["mbaff", "paff"])
def test_interlaced_avchd_refused(tmp_path, mbaff):
    """Interlaced AVCHD (1080i, MBAFF or field pictures) in M2TS: the
    container opens it, the H.264 reader refuses it by name from its SPS,
    before any decode, not decoding it to garbage."""
    s = h264_stream(6)
    units = annexb_units(s["aus"][0])
    sps = interlaced_sps(mbaff)
    s["aus"][0] = annexb([sps if u[0] & 0x1F == 7 else u for u in units])
    path = write(tmp_path / "i.m2ts", s, packet=192)
    assert container.index(path)[2]["codec"] == "h264"
    with pytest.raises(container.UnsupportedCodecError,
                       match="MBAFF" if mbaff else "interlaced"):
        tvideo._own_reader(path)


# ── the corpus ──────────────────────────────────────────────

MANIFEST = json.loads((CORPUS / "manifest.json").read_text())
# the leading frames whose hashes each case holds on the CPU (all of them
# where the file is damaged); the card's machine holds every frame
LEADING = 3


@pytest.mark.parametrize("name, clip, options", mux.REMUXES, ids=[r[0] for r in mux.REMUXES])
def test_corpus_reads_to_its_manifest(tmp_path, name, clip, options):
    """Every remux and variant the manifest lists: the muxer writes it again
    byte for byte, the port's probe is cv2's (the manifest's and the JAX
    package's), and its leading frames hash as cv2's (all of them to the
    damaged one, which raises, where the manifest says)."""
    assert set(MANIFEST["remuxes"]) == {r[0] for r in mux.REMUXES}
    assert sum(p.stat().st_size for p in CORPUS.iterdir()) < 100_000
    entry = MANIFEST["remuxes"][name]
    assert entry["options"] == options
    path = mux.remux(clip, tmp_path / name, **options)
    data = path.read_bytes()
    assert len(data) == entry["bytes"] and hashlib.sha256(data).hexdigest() == entry[
        "file_sha256"]
    assert tvideo.probe_video(path) == entry["probe"] == jvideo.probe_video(path)
    reader = tvideo._own_reader(path)
    assert len(reader) == len(entry["sha256"])
    stop = entry["raises_at"] if entry["raises_at"] is not None else min(LEADING, len(reader))
    for i in range(stop):
        rgb = np.ascontiguousarray(reader.rgb(i))
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == entry["sha256"][i], i
    if entry["raises_at"] is not None:
        with pytest.raises(ValueError, match="damaged PES"):
            reader.rgb(stop)


def test_hlg_clip_reads_as_its_quicktime_source(tmp_path):
    """clip_hevc10.mov (HLG in its VUI and a `colr` box) remuxed: a
    transport stream has no `colr`, and FFmpeg's HEVC decoder takes the
    VUI's tags alone either way, so the port's frames of the remux are its
    frames of the QuickTime file (which test_torch_hevc_files.py holds to
    cv2's colour management)."""
    from tests.torch_mkv_mux import read_clip

    source = Path(__file__).resolve().parent / "data" / "hevc" / "clip_hevc10.mov"
    clip = read_clip(source)
    pts, dts = mux.clip_times(clip)
    path = mux.write_ts(tmp_path / "hlg.ts", mux.annexb_aus(clip), pts, dts, codec="hevc",
                        key=clip["key"])
    ts, mov = tvideo._own_reader(path), tvideo._own_reader(source)
    assert ts.colour == mov.colour and len(ts) == len(mov)
    assert np.array_equal(ts.rgb(0), mov.rgb(0))


def test_container_of_ts_paths_is_mp4():
    """The writer's container for a `.ts` / `.m2ts` output path is MP4 (the
    port writes no transport stream): cv2 reads such a file by its content."""
    assert container.container_of("a.ts") == container.container_of("b.m2ts") == "mp4"
    assert mpegts.packet_size(np.frombuffer(bytes(188 * 12), np.uint8)) is None


# ── an ASF file is no transport stream ──────────────────────

ASF = Path(__file__).resolve().parent / "data" / "asf"


def write_wmv1(path: Path) -> Path | None:
    """cv2's WMV1 writer in `.wmv` (ASF) on a 64 x 48 gradient of 40
    frames, whose first 2 KiB FFmpeg's packet-size count scores as 192-byte
    packets; None where this cv2 lacks the writer."""
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"WMV1"), 30, (64, 48))
    if not vw.isOpened():
        return None
    yy, xx = np.mgrid[0:48, 0:64]
    for i in range(40):
        vw.write(np.stack([(xx * 3 + i * 5) % 256, (yy * 2 + i * 7) % 256,
                           ((xx + yy) // 3 + i * 11) % 256], -1).astype(np.uint8))
    vw.release()
    return path


@pytest.mark.parametrize("source", ["cv2", "committed"])
def test_asf_file_is_no_transport_stream_and_reads_as_cv2(tmp_path, capfd, source):
    """A healthy ASF file (cv2's WMV1 `.wmv`, or the committed first 4,096
    bytes of one: past FFmpeg's 2,040-byte probe) whose head looks like
    transport stream packets to the packet-size count but not to FFmpeg's
    probe: not called a cut transport stream, but read as the ASF it is, as
    cv2 reads it: its probe, and every frame (cv2 shows 23 of the cut
    head's, the 23rd its concealment of a frame the cut ends inside, which
    the port refuses as cut short)."""
    if source == "cv2":
        path = write_wmv1(tmp_path / "w.wmv")
        if path is None:
            pytest.skip("this cv2 has no WMV1 writer")
        assert cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT) > 0
    else:
        entry = json.loads((ASF / "manifest.json").read_text())["files"]["wmv1_head.wmv"]
        path = ASF / "wmv1_head.wmv"
        assert hashlib.sha256(path.read_bytes()).hexdigest() == entry["sha256"]
    head = np.frombuffer(path.read_bytes()[:2048], np.uint8)
    assert mpegts.packet_size(head) and not mpegts.probe(head.tobytes())
    assert path.stat().st_size >= 4096
    assert container.index(path)[2]["container"] == "asf"
    cap = cv2.VideoCapture(str(path))
    probe = {"width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
             "fps": cap.get(cv2.CAP_PROP_FPS),
             "frame_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    theirs = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        theirs.append(bgr[..., ::-1])
    capfd.readouterr()
    assert tvideo.probe_video(path) == probe
    reader = tvideo._own_reader(path)
    assert len(reader) == len(theirs) == (40 if source == "cv2" else 23)
    whole = len(theirs) if source == "cv2" else 22
    for i in range(whole):
        assert np.array_equal(reader.rgb(i), theirs[i])
    if source == "committed":
        with pytest.raises(ValueError, match="cut short"):
            reader.rgb(22)
    else:
        assert len(tvideo.extract_frames(path, tmp_path / "out")) == 40
