"""The port's ASF demuxer (`omfs4d_torch/io/asf.py`, FFmpeg's default `asf`
demuxer) on the CPU, held to cv2 5.0.0 (libavformat 62.12.101):

- The test muxer's three payload layouts (a payload a packet, several a
  packet, compressed payloads), objects split across packets, padding
  lengths of a byte and of a word, for each version of the Windows family:
  every frame 0 levels off cv2's, equal probes.
- The media objects are gathered whole: one sample an object, its
  fragments in order across packets.
- The rate FFmpeg estimates from the millisecond times, at 24, 25 and 30
  fps; the count from the play duration less the preroll, and with no
  duration (a broadcast, a file whose size is 1/20 off the one declared)
  the count cv2 reports then.
- A file cut inside a packet reads as far as cv2 reads it whole; the cut
  frame raises ValueError naming it.
- Refused by name: payload extension systems, a declared bit rate FFmpeg
  would estimate the duration from, a codec the port does not read (VC-1).
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from omfs4d_torch.io import asf, container
from omfs4d_torch.io import video as tvideo
from tests import torch_msmpeg4_syntax as syn
from tests.test_torch_msmpeg4 import cv2_read

CORPUS = Path(__file__).resolve().parent / "data" / "msmpeg4"


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)


def _asf(tmp_path, seed: int, version: int, plan: str = "IPPPIPPP", name: str = "s.wmv",
         width: int = 64, height: int = 48, **mux) -> tuple[Path, syn.Stream]:
    s = syn.write_stream(seed, version, plan, width=width, height=height)
    path = syn.write_asf(tmp_path / name, s.packets, syn.FOURCC[version], s.width, s.height,
                         s.extradata, seed=seed, **mux)
    return path, s


def _same_as_cv2(path, capfd) -> int:
    theirs, probe = cv2_read(path, capfd)
    reader = tvideo._own_reader(path)
    assert tvideo.probe_video(path) == probe
    assert len(reader) == len(theirs) > 0
    for i, b in enumerate(theirs):
        assert np.array_equal(reader.rgb(i), b), f"{path.name}: frame {i}"
    return len(theirs)


@pytest.mark.parametrize("layout", ["single", "multiple", "compressed"])
@pytest.mark.parametrize("version", [syn.V2, syn.V3, syn.WMV1, syn.WMV2])
def test_layouts_read_as_cv2(tmp_path, capfd, layout, version):
    """Each payload layout, packets of 300 bytes (objects split across
    several), padding of a byte or a word: cv2's frames and probe."""
    path, s = _asf(tmp_path, 20 + version, version, layout=layout, packet_size=300,
                   padding_type=1 + version % 2, width=32, height=16)
    assert _same_as_cv2(path, capfd) == len(s.packets)


def test_compressed_tail_dropped_as_by_ffmpeg(tmp_path, capfd):
    """Sub-payloads that end a packet within 6 bytes of its end (FFmpeg's
    FRAME_HEADER_SIZE): FFmpeg's demuxer drops them, and so does the port's."""
    s = syn.write_stream(10, syn.WMV1, "IPIP", width=16, height=16, bit_rate=60)
    path = syn.write_asf(tmp_path / "t.wmv", s.packets, b"WMV1", 16, 16, layout="compressed",
                         compress_min=1, seed=10)
    assert min(len(p) for p in s.packets) < 5
    assert _same_as_cv2(path, capfd) == 3


def test_objects_are_gathered_whole(tmp_path):
    """One sample an object, its bytes the stream's packet whatever the
    packets that carry it."""
    path, s = _asf(tmp_path, 3, syn.WMV2, layout="multiple", packet_size=256)
    offsets, sizes, info = container.index(path)
    assert info["container"] == "asf" and info["codec"] == "msmpeg4" and info["version"] == 5
    assert info["extradata"] == s.extradata and offsets == list(range(len(s.packets)))
    assert sizes == [len(p) for p in s.packets]
    with open(path, "rb") as f:
        assert [container.read_sample(f, o, n, info) for o, n in zip(offsets, sizes)] \
            == s.packets
    assert max(sizes) > 256                       # split across packets


@pytest.mark.parametrize("fps", [24, 25, 30])
def test_rate_and_count_as_cv2(tmp_path, capfd, fps):
    """The rate FFmpeg estimates from millisecond times (33 ms at 30 fps),
    the count from the play duration less the preroll."""
    s = syn.write_stream(7, syn.V3, "IPPPPPPPPPPP", width=32, height=32)
    path = syn.write_asf(tmp_path / "r.wmv", s.packets, b"MP43", 32, 32, fps=fps)
    _, probe = cv2_read(path, capfd)
    assert tvideo.probe_video(path) == probe
    assert probe["frame_count"] == 12


@pytest.mark.parametrize("case", ["broadcast", "size"])
def test_count_with_no_duration_as_cv2(tmp_path, capfd, case):
    """With the broadcast flag set, or a file 1/20 longer than declared,
    FFmpeg takes no duration: cv2's count is that of the unset one."""
    path, _ = _asf(tmp_path, 5, syn.WMV1, broadcast=case == "broadcast")
    if case == "size":
        path.write_bytes(path.read_bytes() + bytes(path.stat().st_size // 10))
    n = _same_as_cv2(path, capfd)
    assert n == 8 and tvideo.probe_video(path)["frame_count"] < -10**16


def test_cut_file_reads_as_cv2(tmp_path, capfd):
    """A `.wmv` cut inside a frame's fragment: the frames before it as cv2
    reads them, the count of a file with no duration, the cut frame refused
    (cv2 shows FFmpeg's concealment of it); cut inside a packet's header
    instead, the file ends with the frame before (FFmpeg's end of file)."""
    whole = CORPUS / "wmv2_cv2.wmv"
    _, _, info = container.index(whole)
    at, pos, n = info["es"].pieces[20][0]
    path = tmp_path / "cut.wmv"
    path.write_bytes(whole.read_bytes()[:pos + n // 2])
    theirs, probe = cv2_read(path, capfd)
    assert tvideo.probe_video(path) == probe and probe["frame_count"] < -10**16
    reader = tvideo._own_reader(path)
    assert len(reader) == len(theirs) == 21
    for i in range(20):
        assert np.array_equal(reader.rgb(i), theirs[i])
    with pytest.raises(ValueError, match="cut short"):
        reader.rgb(20)
    data = whole.read_bytes()
    start = asf._headers(memoryview(data), whole)["data"][0]
    path.write_bytes(data[:start + (pos - start) // 3200 * 3200 + 5])
    assert _same_as_cv2(path, capfd) < 21


def test_payload_extensions_refused(tmp_path):
    """A video stream whose payloads carry extension systems (their data may
    time the frames in FFmpeg): refused by name."""
    path, _ = _asf(tmp_path, 1, syn.V3, leak_rate=300_000, payload_extensions=1)
    with pytest.raises(container.UnsupportedCodecError, match="payload extension"):
        tvideo.probe_video(path)


def test_bit_rate_estimate_refused_and_declared_rate_read(tmp_path, capfd):
    """A declared bit rate with no duration (FFmpeg estimates one from it):
    refused by name; with the duration, the file reads as cv2 reads it."""
    path, _ = _asf(tmp_path, 2, syn.V3, leak_rate=300_000)
    _same_as_cv2(path, capfd)
    path, _ = _asf(tmp_path, 2, syn.V3, name="b.wmv", leak_rate=300_000, broadcast=True)
    with pytest.raises(container.UnsupportedCodecError, match="bit rate"):
        tvideo.probe_video(path)


def test_unread_codec_refused(tmp_path):
    """An ASF stream of a codec the port does not read: named."""
    s = syn.write_stream(1, syn.V3, "IP", width=32, height=32)
    path = syn.write_asf(tmp_path / "v.wmv", s.packets, b"WMV3", 32, 32)
    with pytest.raises(container.UnsupportedCodecError, match="VC-1"):
        tvideo.probe_video(path)


def test_probe():
    """The header object's GUID and nothing else makes a file ASF."""
    head = (CORPUS / "wmv1_cv2.wmv").read_bytes()[:64]
    assert asf.probe(head)
    assert not asf.probe(b"RIFF" + head[4:])


def test_manifest_holds_cv2s_other_codecs_in_asf():
    """The corpus's `.wmv` of each codec cv2 writes there besides the
    Windows family is read through its own reader (the corpus test holds
    its frames to cv2's)."""
    files = json.loads((CORPUS / "manifest.json").read_text())["files"]
    codecs = {container.index(CORPUS / n)[2]["codec"] for n in files if n.endswith(".wmv")}
    assert codecs == {"msmpeg4", "mjpeg", "mpeg4", "vp8", "mpeg2"}
    assert cv2.VideoCapture(str(CORPUS / "vp80_cv2.wmv")).isOpened()
