"""Motion JPEG in AVI and MP4 files, read and written on the host with the
standard library and NumPy (no OpenCV, no ffmpeg).

The last rung of the reference's video ladder (`omfs4d.io.video.stitch_video`:
avc1 -> mp4v -> MJPG through cv2) writes every frame as a baseline JPEG, in
the container the output's suffix names.  This module writes those two
containers as FFmpeg, which cv2 carries, lays them out, and reads a Motion
JPEG file's frames from the index `omfs4d_torch.io.container` makes of it
(the MP4 boxes are `omfs4d_torch.io.mp4`'s):

- AVI (RIFF): `hdrl` (`avih`, then a `strl` with `strh` of type `vids` and
  handler `MJPG` and a BITMAPINFOHEADER `strf`), `movi` with one `##dc`
  chunk a frame, then `idx1`.
- MP4 (ISO BMFF): `ftyp`, `mdat`, then `moov` with one video `trak` whose
  sample entry is `mp4v` with an `esds` of objectTypeIndication 0x6C (JPEG),
  as FFmpeg muxes MJPEG into `.mp4`.

A frame whose bytes end early raises ValueError with its index.  A frame
that omits its Huffman tables (the AVI1 convention of Motion-JPEG cameras)
is given the standard ones, as FFmpeg's MJPEG decoder, which the reference
reads through cv2, takes them.  Frames come out as that decoder and
swscale make them (`frame_rgb`), bit for bit: FFmpeg's simple IDCT, not
libjpeg's, and swscale's conversion, not libjpeg's upsampling and tables.
"""

from __future__ import annotations

import struct
from collections.abc import Iterable, Sequence
from fractions import Fraction
from pathlib import Path

import numpy as np

from omfs4d_torch.io import container, mp4, swscale
from omfs4d_torch.io.jpeg import decode_planes, idct_simple, standard_dht


class MJPEGFrames(Sequence):
    """The JPEG bytes of a Motion JPEG file's frames, in order, read from the
    file at each access (`frames[i]`, `len(frames)`, iteration)."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        self.path, self.offsets, self.sizes, self.info = path, offsets, sizes, info

    def __len__(self) -> int:
        return len(self.offsets)

    def __getitem__(self, i: int) -> bytes:
        n = len(self.offsets)
        if not -n <= i < n:
            raise IndexError(f"{self.path}: frame {i} of {n}")
        i %= n
        with open(self.path, "rb") as f:
            data = container.read_sample(f, self.offsets[i], self.sizes[i], self.info)
        prefix = len(self.info.get("prefix", b""))
        if len(data) < prefix + self.sizes[i]:
            raise ValueError(f"{self.path}: frame {i} is cut short: {len(data) - prefix} of "
                             f"its {self.sizes[i]} bytes are in the file")
        return _checked_jpeg(data, self.path, i)

    def rgb(self, i: int) -> np.ndarray:
        """Frame i as cv2 reads it (`frame_rgb`, turned by the container's
        display rotation): (H, W, 3) uint8 RGB."""
        rotation = self.info.get("rotation", 0)
        return np.ascontiguousarray(np.rot90(frame_rgb(self[i]), -rotation // 90))

    def probe(self) -> dict:
        """{"width", "height", "fps", "frame_count"}, the keys of the
        reference's `probe_video` (the size as displayed); fps is 30.0
        where the container gives 0, as there."""
        info = self.info
        w, h = info["width"], info["height"]
        if info.get("rotation", 0) in (90, 270):
            w, h = h, w
        return {"width": w, "height": h, "fps": info["fps"] or 30.0,
                "frame_count": info["frame_count"]}


def frame_rgb(data: bytes) -> np.ndarray:
    """A Motion JPEG frame -> (H, W, 3) uint8 RGB as cv2.VideoCapture gives
    it: decoded as FFmpeg's MJPEG decoder decodes it (`idct_simple`; a JPEG
    *file* is read as libjpeg reads it, `decode_jpeg`), then converted by
    swscale as the yuvj* formats, BT.601 in full range with chroma sited at
    the centre (`swscale.to_rgb`: its unscaled path for 4:2:0 and 4:2:2 at an
    even height, its scaled path for the rest).  Grey is repeated; an RGB
    JPEG's planes are taken as they are.  A sampling FFmpeg has no pixel
    format for (chroma wider than luma, Cb and Cr apart, a factor other than
    1, 2 or 4 across and 1 or 2 down) raises `container.UnsupportedCodecError`."""
    planes, factors, ycc, _ = decode_planes(data, idct=idct_simple)
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    hmax, vmax = factors[0]
    across, down = hmax // factors[1][0], vmax // factors[1][1]
    if (factors[1] != factors[2] or hmax % factors[1][0] or vmax % factors[1][1]
            or across not in (1, 2, 4) or down not in (1, 2)
            or (not ycc and factors[1] != factors[0])):
        raise container.UnsupportedCodecError(
            f"a JPEG frame sampled {factors} (h, v per component) has no pixel format in cv2's "
            "FFmpeg; decoding it needs an ffmpeg binary (on PATH or from imageio_ffmpeg)")
    if not ycc:
        return np.stack(planes, axis=-1)
    return swscale.to_rgb(*planes, depth=8, full=True, location=swscale.CENTER)


def _checked_jpeg(data: bytes, path, i: int) -> bytes:
    """A frame's bytes, with the standard Huffman tables put in when it has
    none; ValueError when it is no whole JPEG."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: frame {i} is not a JPEG (no SOI marker)")
    if not data.rstrip(b"\x00").endswith(b"\xff\xd9"):
        raise ValueError(f"{path}: frame {i} is cut short (its JPEG has no EOI marker)")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            break
        marker = data[pos + 1]
        if marker == 0xC4:
            return data
        if marker == 0xDA:
            ncomp = _sof_components(data[2:pos])
            return data[:pos] + standard_dht(chroma=ncomp != 1) + data[pos:]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        (length,) = struct.unpack_from(">H", data, pos + 2)
        pos += 2 + length
    return data


def _sof_components(header: bytes) -> int:
    """The number of components in a JPEG header's frame header (3 when it
    has none)."""
    pos = 0
    while pos + 4 <= len(header):
        marker = header[pos + 1]
        (length,) = struct.unpack_from(">H", header, pos + 2)
        if marker in (0xC0, 0xC1) and pos + 9 < len(header):
            return header[pos + 9]
        pos += 2 + length
    return 3


# ── AVI ─────────────────────────────────────────────────────────────────

def _avi_header(n: int, movi_size: int, biggest: int, rate: Fraction, width: int,
                height: int) -> bytes:
    """RIFF, hdrl and the movi list's header of an AVI of `n` frames whose
    movi data holds `movi_size` bytes (the idx1 chunk follows it)."""
    avih = struct.pack("<10I16x", round(1e6 / rate), 0, 0, 0x10 | 0x100, n, 0, 1,
                       biggest + 8, width, height)
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", b"MJPG", 0, 0, 0, 0,
                       rate.denominator, rate.numerator, 0, n, biggest + 8, -1, 0,
                       0, 0, min(width, 32767), min(height, 32767))
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG",
                       min(width * height * 3, 0xFFFFFFFF), 0, 0, 0, 0)
    strl = b"strl" + b"strh" + struct.pack("<I", len(strh)) + strh \
        + b"strf" + struct.pack("<I", len(strf)) + strf
    hdrl = b"hdrl" + b"avih" + struct.pack("<I", len(avih)) + avih \
        + b"LIST" + struct.pack("<I", len(strl)) + strl
    riff_size = 4 + 8 + len(hdrl) + 12 + movi_size + 8 + 16 * n
    return (b"RIFF" + struct.pack("<I", riff_size) + b"AVI "
            + b"LIST" + struct.pack("<I", len(hdrl)) + hdrl
            + b"LIST" + struct.pack("<I", 4 + movi_size) + b"movi")


def _write_avi(f, jpegs: Iterable[bytes], rate: Fraction, width: int, height: int) -> int:
    head = len(_avi_header(0, 0, 0, rate, width, height))
    f.write(bytes(head))
    index, movi, biggest = [], 0, 0
    for i, data in enumerate(jpegs):
        data = _frame_bytes(data, i)
        if head + movi + 8 + len(data) + 16 * (len(index) + 1) + 8 > 0xFFFFFFFF:
            raise ValueError("an AVI file of more than 4 GiB needs OpenDML, which this "
                             "writer does not write: write an .mp4")
        index.append(struct.pack("<4sIII", b"00dc", 0x10, 4 + movi, len(data)))
        f.write(b"00dc" + struct.pack("<I", len(data)) + data + b"\x00" * (len(data) & 1))
        movi += 8 + len(data) + (len(data) & 1)
        biggest = max(biggest, len(data))
    f.write(b"idx1" + struct.pack("<I", 16 * len(index)) + b"".join(index))
    f.seek(0)
    f.write(_avi_header(len(index), movi, biggest, rate, width, height))
    return len(index)


# ── MP4 ─────────────────────────────────────────────────────────────────

def _mjpeg_entry(sizes: list[int], width: int, height: int) -> bytes:
    """The `mp4v` sample entry of Motion JPEG: an ES_Descriptor (ES_ID 1) >
    DecoderConfigDescriptor (JPEG, a visual stream) and SLConfigDescriptor
    (predefined 2), lengths in 4 bytes, as FFmpeg muxes it."""
    esds = mp4.full(b"esds", 0, 0, b"\x03\x80\x80\x80\x1b", struct.pack(">HB", 1, 0),
                    b"\x04\x80\x80\x80\x0d", struct.pack(">BB", container.OTI_JPEG, 0x11),
                    min(max(sizes), 0xFFFFFF).to_bytes(3, "big"), struct.pack(">II", 0, 0),
                    b"\x06\x80\x80\x80\x01\x02")
    return mp4.visual_entry(b"mp4v", width, height, esds)


# ── the API ─────────────────────────────────────────────────────────────

def _frame_bytes(data, i: int) -> bytes:
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"frame {i} is not a JPEG (no SOI marker)")
    return data


def frames(path) -> MJPEGFrames:
    """The JPEG bytes of each frame of a Motion JPEG AVI or MP4 file, in
    order, with random access by index."""
    offsets, sizes, info = container.index(path)
    if info["codec"] != "mjpeg":
        raise ValueError(f"{path}: its video is H.264, not Motion JPEG: read it with "
                         "omfs4d_torch.io.h264")
    return MJPEGFrames(Path(path), offsets, sizes, info)


def write(path, jpegs: Iterable[bytes], fps: float, width: int, height: int) -> Path:
    """Write JPEG frames (each a whole baseline JPEG of width x height) as a
    Motion JPEG video: AVI for a `.avi` suffix, MP4 for any other.  Frames
    are streamed to the file; returns its path."""
    if container.container_of(path) == "avi":
        return container.write_file(path, fps, width, height,
                                    lambda f, rate: _write_avi(f, jpegs, rate, width, height))
    samples = ((_frame_bytes(data, i), True) for i, data in enumerate(jpegs))
    return container.write_file(path, fps, width, height, lambda f, rate: mp4.write_track(
        f, samples, rate, width, height, lambda sizes: _mjpeg_entry(sizes, width, height)))
