"""MPEG program streams (`omfs4d_torch/io/mpegps.py`) on the CPU, held to
cv2 5.0.0 (libavformat 62's `mpeg` demuxer):

- The probe takes every committed program stream, of both pack flavours
  (MPEG-1's system stream, MPEG-2's program stream), whatever the suffix,
  and turns down a transport stream, an ASF file, a raw elementary stream,
  an MP4 and noise.
- The program stream map names the video's codec; padding, private stream
  1 (a DVD's AC-3) and 2 (a DVD's navigation packs) are passed over.
- A program stream of H.264 and of MPEG-4 Part 2 (a CCTV or DVR
  recorder's `.mpg`), its codec found by probing the payload, read as cv2
  reads it; CAVS and a stream of no video refused by name.
- cv2's fps and frame count for every committed program stream; a file cut
  inside a PES: cv2's frames up to the damaged one, which raises
  ValueError.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, mpegps
from omfs4d_torch.io import video as tvideo
from tests import torch_mpeg2_syntax as syn
from tests import torch_ts_mux as tsm
from tests.make_mpeg2_corpus import make_stream
from tests.test_torch_matroska import read_as_cv2

CORPUS = Path(__file__).resolve().parent / "data" / "mpeg2"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())
PS_FILES = sorted(n for n in MANIFEST["files"] if Path(n).suffix in (".mpg", ".mpeg", ".vob"))


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)
    monkeypatch.setattr(jvideo, "find_ffmpeg", lambda: None)


def cv2_frames(path, capfd) -> list[np.ndarray]:
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        out.append(np.ascontiguousarray(bgr[..., ::-1]))
    cap.release()
    capfd.readouterr()
    return out


@pytest.mark.parametrize("name", PS_FILES)
def test_probe_takes_program_streams(name):
    """Each committed `.mpg` / `.mpeg` / `.vob` is a program stream to the
    probe, and to the index; so under another suffix."""
    data = (CORPUS / name).read_bytes()
    assert mpegps.probe(data) and mpegps.score(data) > mpegps.SCORE_RETRY
    assert container.index(CORPUS / name)[2]["container"] == "mpegps"


def test_pack_flavours():
    """cv2's MPEG-1 writer makes an MPEG-1 system stream (pack header
    '0010'), its `.vob` an MPEG-2 program stream (pack header '01'): both
    read."""
    for name, flavour in (("mpg1_cv2.mpg", 0x20), ("mpg2_cv2.vob", 0x40)):
        data = (CORPUS / name).read_bytes()
        at = data.index(b"\x00\x00\x01\xba")
        assert data[at + 4] & (0xF0 if flavour == 0x20 else 0xC0) == flavour
        assert len(tvideo._own_reader(CORPUS / name)) == len(MANIFEST["files"][name]["sha256"])


def test_probe_turns_down_other_files(tmp_path):
    """An ASF header, a raw elementary stream, an MP4 and noise are no
    program streams to the probe; a transport stream, whose PES start codes
    it may count, goes to the transport stream's reader first (FFmpeg's
    `mpegts` probe scores it higher), whatever the suffix."""
    ts = (CORPUS / "mpg2_cv2.ts").read_bytes()
    raw = syn.write_stream(1, "IPBB").data
    asf = bytes.fromhex("3026b2758e66cf11a6d900aa0062ce6c") + bytes(4000)
    mp4 = (CORPUS / "mpg2_cv2.mp4").read_bytes()
    noise = np.random.default_rng(0).integers(0, 256, 8192, dtype=np.uint8).tobytes()
    for data in (raw, asf, mp4, noise):
        assert not mpegps.probe(data)
    path = tmp_path / "renamed.vob"
    path.write_bytes(ts)
    assert container.index(path)[2]["container"] == "mpegts"


def test_psm_and_skipped_packets(tmp_path):
    """The writer's DVD-like program stream: a PSM naming MPEG-2 video, a
    navigation pack (private stream 2) after each pack header, an AC-3
    packet (private stream 1) after each video PES: the walk gives the
    video's and the AC-3's PES, the PSM's type, and no navigation pack."""
    path = make_stream("syn_interlaced.mpg", tmp_path)
    state: dict = {}
    data = path.read_bytes()
    pes = mpegps.walk(data, 0, len(data), state)
    assert {p["id"] for p in pes} == {0x1E0, 0x80}
    assert state["psm"] == {0xE0: 0x02}
    assert b"\x00\x00\x01\xbf" in data
    info = container.index(path)[2]
    assert info["codec"] == "mpeg2" and info["container"] == "mpegps"


def test_padding_passed_over(tmp_path):
    """MPEG-1 padding packets between the video's: the walk never reads one
    as a PES."""
    path = make_stream("syn_mpeg1.mpg", tmp_path)
    data = path.read_bytes()
    assert b"\x00\x00\x01\xbe" in data
    assert {p["id"] for p in mpegps.walk(data, 0, len(data), {})} == {0x1E0}


@pytest.mark.parametrize("clip", ["clip_b", "clip_mp4v"])
@pytest.mark.parametrize("psm", [False, True])
def test_other_codecs_in_program_streams(tmp_path, capfd, clip, psm):
    """H.264 (`clip_b`, B pictures) and MPEG-4 Part 2 (`clip_mp4v`) access
    units in an MPEG-2 program stream, found by probing the payload or named
    by a PSM: read as cv2 reads them (frames, probe)."""
    s = tsm.clip_stream(clip)
    path = syn.write_ps(tmp_path / "c.mpg", s["aus"], mpeg1=False, times=(s["pts"], s["dts"]),
                        psm_type=({"h264": 0x1B, "mpeg4": 0x10}[s["codec"]] if psm else None))
    assert container.index(path)[2]["codec"] == s["codec"]
    frames = read_as_cv2(path, capfd)
    assert len(frames) > 0


def test_cavs_and_no_video_refused(tmp_path):
    """A video PES stream whose payload is CAVS (its 0xB0 sequence header
    with no MPEG-4 profile after it) and a program stream of audio alone:
    refused by name."""
    cavs = b"\x00\x00\x01\xb0\x20\x00\x01\x02\x03\x04" + bytes(200)
    path = syn.write_ps(tmp_path / "cavs.mpg", [cavs] * 4, mpeg1=False)
    with pytest.raises(container.UnsupportedCodecError, match="CAVS"):
        tvideo.probe_video(path)
    out = bytearray()
    for k in range(6):
        out += syn.pack_header(False, 1000 * k) + (syn.system_header(False, True) if k == 0
                                                  else b"")
        out += syn.pes(False, 0xC0, b"\xff\xfd\x90\x00" + bytes(400), 3000 * k, None)
    path = tmp_path / "audio.mpg"
    path.write_bytes(bytes(out))
    with pytest.raises(container.UnsupportedCodecError, match="no video"):
        tvideo.probe_video(path)


@pytest.mark.parametrize("name", PS_FILES)
def test_fps_and_count_as_cv2(name):
    """probe_video's fps and frame_count equal cv2's for each committed
    program stream (FFmpeg's rate, its duration from the last time stamps),
    with no decode."""
    probe = tvideo.probe_video(CORPUS / name)
    assert probe == MANIFEST["files"][name]["probe"]


def test_cut_file(tmp_path, capfd):
    """A program stream cut inside a video PES: cv2's frames before the cut
    one, equal; the cut one raises ValueError (cv2 shows FFmpeg's
    concealment)."""
    data = (CORPUS / "mpg2_cv2.mpeg").read_bytes()
    path = tmp_path / "cut.mpg"
    path.write_bytes(data[:len(data) * 2 // 3 + 500])
    theirs = cv2_frames(path, capfd)
    reader = tvideo._own_reader(path)
    damaged = reader.info["damaged"]
    assert damaged
    good = 0
    for i, b in enumerate(theirs):
        try:
            a = reader.rgb(i)
        except ValueError as e:
            assert "damaged" in str(e)
            break
        assert np.array_equal(a, b), i
        good += 1
    assert 0 < good < len(theirs)
