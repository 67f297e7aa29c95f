"""Motion JPEG in AVI and MP4 files, read and written on the host with the
standard library and NumPy (no OpenCV, no ffmpeg).

The last rung of the reference's video ladder (`omfs4d.io.video.stitch_video`:
avc1 -> mp4v -> MJPG through cv2) writes every frame as a baseline JPEG, in
the container the output's suffix names.  This module reads and writes those
two containers as FFmpeg, which cv2 carries, lays them out:

- AVI (RIFF): `hdrl` (`avih`, then a `strl` with `strh` of type `vids` and
  handler `MJPG` and a BITMAPINFOHEADER `strf`), `movi` with one `##dc`
  chunk a frame, then `idx1`.  Reading walks the `movi` lists chunk by chunk
  (it does not trust `idx1`), follows the `RIFF AVIX` lists of an OpenDML
  file past 1 GB, and skips `JUNK` and `ix##` chunks.
- MP4 (ISO BMFF): `ftyp`, `mdat`, then `moov` with one video `trak` whose
  sample entry is `mp4v` with an `esds` of objectTypeIndication 0x6C (JPEG),
  as FFmpeg muxes MJPEG into `.mp4`.  Reading also takes QuickTime's `jpeg`
  and `mjpa` sample entries, `co64` chunk offsets, any `stsc` layout and
  `moov` before or after `mdat`; fps comes from `mdhd`'s timescale and
  `stts`, the frame count from `stsz`.

Any other codec (H.264 `avc1`, HEVC, MPEG-4 Part 2 `mp4v` with OTI 0x20,
AVI's `H264` / `XVID` / `FMP4` / `DIVX`, ...) raises `UnsupportedCodecError`
naming it: decoding it needs an ffmpeg binary.  So does a file that is
neither container.  A frame whose bytes end early raises ValueError with
its index, and a file holding fewer frames than its header declares raises
too: a short list of frames never comes back silently.  A frame that omits
its Huffman tables (the AVI1 convention of Motion-JPEG cameras) is given the
standard ones, as FFmpeg's MJPEG decoder, which the reference reads through
cv2, takes them.
"""

from __future__ import annotations

import mmap
import struct
from collections.abc import Iterable, Sequence
from fractions import Fraction
from pathlib import Path

from omfs4d_torch.io.jpeg import standard_dht


class UnsupportedCodecError(RuntimeError):
    """The video file holds a codec that the port cannot decode without an
    ffmpeg binary, or it is no AVI or MP4 file at all."""


def _needs_ffmpeg(path, what: str) -> UnsupportedCodecError:
    return UnsupportedCodecError(
        f"{path}: {what}; the port reads only Motion JPEG (MJPG) in AVI or MP4 by "
        "itself, decoding this needs an ffmpeg binary (on PATH or from imageio_ffmpeg)")


# AVI fourccs of Motion JPEG, and names of those that need another decoder
_AVI_MJPEG = {b"MJPG", b"mjpg", b"AVRn", b"dmb1", b"jpeg", b"JPEG"}
_AVI_NAMES = {b"H264": "H.264", b"h264": "H.264", b"X264": "H.264", b"avc1": "H.264",
              b"XVID": "MPEG-4 Part 2 (Xvid)", b"FMP4": "MPEG-4 Part 2 (FFmpeg)",
              b"DIVX": "MPEG-4 Part 2 (DivX)", b"DX50": "MPEG-4 Part 2 (DivX 5)",
              b"MP4V": "MPEG-4 Part 2", b"HEVC": "H.265 / HEVC", b"H265": "H.265 / HEVC"}
# MP4 sample entries of Motion JPEG, and names of those that need another decoder
_MP4_MJPEG = {b"jpeg", b"mjpa"}
_MP4_NAMES = {b"avc1": "H.264", b"avc3": "H.264", b"hvc1": "H.265 / HEVC",
              b"hev1": "H.265 / HEVC", b"av01": "AV1", b"vp09": "VP9", b"vp08": "VP8",
              b"mjpb": "Motion JPEG format B", b"s263": "H.263", b"apcn": "ProRes"}
# objectTypeIndication of an `mp4v` entry's esds (ISO/IEC 14496-1, Table 5)
_OTI_JPEG = 0x6C
_OTI_NAMES = {0x20: "MPEG-4 Part 2", 0x21: "H.264", 0x60: "MPEG-2 video",
              0x61: "MPEG-2 video", 0x62: "MPEG-2 video", 0x63: "MPEG-2 video",
              0x64: "MPEG-2 video", 0x65: "MPEG-2 video", 0x6A: "MPEG-1 video",
              0x6E: "JPEG 2000"}


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
            f.seek(self.offsets[i])
            data = f.read(self.sizes[i])
        if len(data) < self.sizes[i]:
            raise ValueError(f"{self.path}: frame {i} is cut short: {len(data)} of its "
                             f"{self.sizes[i]} bytes are in the file")
        return _checked_jpeg(data, self.path, i)


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

def _avi_chunks(buf, start: int, end: int):
    """(fourcc, data start, data size, list type or None) of each chunk
    between start and end; a chunk's size may run past the end of the file."""
    pos = start
    while pos + 8 <= end:
        fcc = bytes(buf[pos:pos + 4])
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        if fcc in (b"RIFF", b"LIST"):
            yield fcc, pos + 12, size - 4, bytes(buf[pos + 8:pos + 12])
        else:
            yield fcc, pos + 8, size, None
        pos += 8 + size + (size & 1)


def _read_avi(buf, path: Path):
    file_end = len(buf)
    stream, video = 0, None
    declared = idx1_frames = 0
    offsets, sizes = [], []
    ids: tuple[bytes, bytes] = (b"00dc", b"00db")

    def walk_movi(start, end):
        for fcc, pos, size, kind in _avi_chunks(buf, start, end):
            if kind is not None:                     # LIST 'rec ' groups
                walk_movi(pos, min(pos + size, end))
            elif fcc in ids:
                if pos + size > file_end:
                    raise ValueError(f"{path}: frame {len(offsets)} is cut short: "
                                     f"{max(file_end - pos, 0)} of its {size} bytes are in "
                                     "the file")
                offsets.append(pos)
                sizes.append(size)

    for fcc, pos, size, kind in _avi_chunks(buf, 0, file_end):
        if fcc != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
            break
        for cfcc, cpos, csize, ckind in _avi_chunks(buf, pos, min(pos + size, file_end)):
            if ckind == b"hdrl":
                for n, (_, spos, ssize, _) in enumerate(
                        c for c in _avi_chunks(buf, cpos, cpos + csize) if c[3] == b"strl"):
                    strl = {f: (p, s) for f, p, s, _ in _avi_chunks(buf, spos, spos + ssize)}
                    if b"strh" not in strl or b"strf" not in strl:
                        continue
                    hp, _ = strl[b"strh"]
                    if bytes(buf[hp:hp + 4]) != b"vids" or video is not None:
                        continue
                    scale, rate = struct.unpack_from("<II", buf, hp + 20)
                    (declared,) = struct.unpack_from("<I", buf, hp + 32)
                    fp, _ = strl[b"strf"]
                    width, height = struct.unpack_from("<ii", buf, fp + 4)
                    compression = bytes(buf[fp + 16:fp + 20])
                    stream = n
                    video = (compression, width, abs(height), rate / scale if scale else 0.0)
                    ids = (b"%02ddc" % n, b"%02ddb" % n)
            elif ckind == b"movi":
                walk_movi(cpos, min(cpos + csize, file_end))
            elif cfcc == b"idx1":
                entries = min(csize, file_end - cpos) // 16
                idx1_frames = sum(bytes(buf[cpos + 16 * k:cpos + 16 * k + 4]) in ids
                                  for k in range(entries))
    if video is None:
        raise ValueError(f"{path}: an AVI file with no video stream")
    compression, width, height, fps = video
    if compression not in _AVI_MJPEG:
        name = _AVI_NAMES.get(compression, repr(compression.decode("latin-1")))
        raise _needs_ffmpeg(path, f"its video is {name} (AVI fourcc "
                                  f"{compression.decode('latin-1')!r})")
    found = len(offsets)
    if max(declared, idx1_frames) > found:
        raise ValueError(f"{path}: the file holds {found} frames of stream {stream}, its "
                         f"header declares {declared} and its index {idx1_frames}: it is "
                         "cut short")
    return offsets, sizes, {"width": width, "height": height, "fps": fps,
                            "frame_count": found, "container": "avi"}


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

def _boxes(buf, start: int, end: int):
    """(type, body start, box end) of each box between start and end; a
    box's end may run past the end of the file."""
    pos = start
    while pos + 8 <= end:
        size, typ = struct.unpack_from(">I4s", buf, pos)
        body = pos + 8
        if size == 1:
            (size,) = struct.unpack_from(">Q", buf, pos + 8)
            body = pos + 16
        elif size == 0:
            size = end - pos
        if size < body - pos:
            raise ValueError(f"MP4: a box '{typ.decode('latin-1')}' of {size} bytes")
        yield typ, body, pos + size
        pos += size


def _child(buf, start, end, typ):
    for t, body, box_end in _boxes(buf, start, end):
        if t == typ:
            return body, box_end
    return None


def _descriptor(buf, pos):
    """(tag, body start, body end) of the MPEG-4 descriptor at pos."""
    tag, size, pos = buf[pos], 0, pos + 1
    for _ in range(4):
        b = buf[pos]
        pos += 1
        size = size << 7 | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + size


def _esds_oti(buf, body, end) -> int | None:
    """objectTypeIndication of an esds box's DecoderConfigDescriptor."""
    tag, pos, _ = _descriptor(buf, body + 4)
    if tag != 0x03:
        return None
    flags = buf[pos + 2]
    pos += 3 + (2 if flags & 0x80 else 0) + (1 + buf[pos + 3] if flags & 0x40 else 0) \
        + (2 if flags & 0x20 else 0)
    tag, pos, _ = _descriptor(buf, pos)
    return buf[pos] if tag == 0x04 else None


def _full_box(buf, body, fmt):
    return struct.unpack_from(">" + fmt, buf, body + 4)


def _read_mp4(buf, path: Path):
    file_end = len(buf)
    moov = _child(buf, 0, file_end, b"moov")
    if moov is None:
        raise ValueError(f"{path}: an MP4 file with no moov box (cut short, or fragmented)")
    if moov[1] > file_end:
        raise ValueError(f"{path}: the moov box is cut short")
    for typ, tbody, tend in _boxes(buf, *moov):
        if typ != b"trak":
            continue
        mdia = _child(buf, tbody, tend, b"mdia")
        hdlr = mdia and _child(buf, *mdia, b"hdlr")
        if not hdlr or bytes(buf[hdlr[0] + 8:hdlr[0] + 12]) != b"vide":
            continue
        mdhd = _child(buf, *mdia, b"mdhd")
        version = buf[mdhd[0]]
        (timescale,) = (_full_box(buf, mdhd[0], "QQI") if version == 1
                        else _full_box(buf, mdhd[0], "III"))[2:]
        stbl = _child(buf, *_child(buf, *mdia, b"minf"), b"stbl")
        return _read_stbl(buf, stbl, timescale, path)
    raise ValueError(f"{path}: an MP4 file with no video track")


def _read_stbl(buf, stbl, timescale: int, path: Path):
    stsd = _child(buf, *stbl, b"stsd")
    entry = next(_boxes(buf, stsd[0] + 8, stsd[1]))
    kind, ebody, eend = entry
    width, height = struct.unpack_from(">HH", buf, ebody + 24)
    if kind == b"mp4v":
        esds = _child(buf, ebody + 78, eend, b"esds")
        oti = _esds_oti(buf, *esds) if esds else None
        if oti != _OTI_JPEG:
            name = _OTI_NAMES.get(oti, "an unknown codec")
            raise _needs_ffmpeg(path, f"its video is {name} (sample entry 'mp4v', "
                                      f"objectTypeIndication {oti if oti is None else hex(oti)})")
    elif kind not in _MP4_MJPEG:
        name = _MP4_NAMES.get(kind, "an unknown codec")
        raise _needs_ffmpeg(path, f"its video is {name} (sample entry "
                                  f"{kind.decode('latin-1')!r})")

    stsz = _child(buf, *stbl, b"stsz")
    if stsz is None:
        raise ValueError(f"{path}: no stsz box (compact stz2 sample sizes are not read)")
    size, n = _full_box(buf, stsz[0], "II")
    sizes = list(_full_box(buf, stsz[0], f"II{n}I")[2:]) if size == 0 else [size] * n
    stco = _child(buf, *stbl, b"stco")
    co64 = _child(buf, *stbl, b"co64")
    if stco is not None:
        (nc,) = _full_box(buf, stco[0], "I")
        chunks = _full_box(buf, stco[0], f"I{nc}I")[1:]
    else:
        (nc,) = _full_box(buf, co64[0], "I")
        chunks = _full_box(buf, co64[0], f"I{nc}Q")[1:]
    stsc = _child(buf, *stbl, b"stsc")
    (ns,) = _full_box(buf, stsc[0], "I")
    runs = _full_box(buf, stsc[0], f"I{3 * ns}I")[1:]
    offsets = []
    for k in range(ns):
        first, per_chunk = runs[3 * k] - 1, runs[3 * k + 1]
        last = runs[3 * k + 3] - 1 if k + 1 < ns else nc
        for c in range(first, last):
            pos = chunks[c]
            for _ in range(per_chunk):
                if len(offsets) == n:
                    break
                offsets.append(pos)
                pos += sizes[len(offsets) - 1]
    if len(offsets) < n:
        raise ValueError(f"{path}: the chunks hold {len(offsets)} of the {n} samples that "
                         "stsz declares")
    for i, (o, s) in enumerate(zip(offsets, sizes)):
        if o + s > len(buf):
            raise ValueError(f"{path}: frame {i} is cut short: {max(len(buf) - o, 0)} of "
                             f"its {s} bytes are in the file")
    stts = _child(buf, *stbl, b"stts")
    (nt,) = _full_box(buf, stts[0], "I")
    deltas = _full_box(buf, stts[0], f"I{2 * nt}I")[1:]
    duration = sum(deltas[2 * k] * deltas[2 * k + 1] for k in range(nt))
    fps = float(Fraction(n * timescale, duration)) if duration and n else 0.0
    return offsets, sizes, {"width": width, "height": height, "fps": fps,
                            "frame_count": n, "container": "mp4"}


def _box(typ: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + typ + body


def _full(typ: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(typ, struct.pack(">I", version << 24 | flags), *parts)


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _mp4_moov(sizes: list[int], first: int, timescale: int, delta: int, width: int,
              height: int) -> bytes:
    n = len(sizes)
    ms = round(n * delta * 1000 / timescale)
    # ES_Descriptor (ES_ID 1) > DecoderConfigDescriptor (JPEG, a visual
    # stream) and SLConfigDescriptor (predefined 2), lengths in 4 bytes
    esds = _full(b"esds", 0, 0, b"\x03\x80\x80\x80\x1b", struct.pack(">HB", 1, 0),
                 b"\x04\x80\x80\x80\x0d", struct.pack(">BB", _OTI_JPEG, 0x11),
                 min(max(sizes), 0xFFFFFF).to_bytes(3, "big"), struct.pack(">II", 0, 0),
                 b"\x06\x80\x80\x80\x01\x02")
    entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                 struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1), bytes(32),
                 struct.pack(">Hh", 0x18, -1), esds)
    offsets = _full(b"co64", 0, 0, struct.pack(">IQ", 1, first)) if first > 0xFFFFFFFF \
        else _full(b"stco", 0, 0, struct.pack(">II", 1, first))
    stbl = _box(b"stbl",
                _full(b"stsd", 0, 0, struct.pack(">I", 1), entry),
                _full(b"stts", 0, 0, struct.pack(">III", 1, n, delta)),
                _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)),
                _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes)),
                offsets)
    minf = _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)),
                _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                    _full(b"url ", 0, 1))), stbl)
    mdia = _box(b"mdia",
                _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, n * delta,
                                                 0x55C4, 0)),
                _full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"), b"VideoHandler\x00"),
                minf)
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII8xhhhH", 0, 0, 1, 0, ms, 0, 0, 0, 0),
                 _MATRIX, struct.pack(">II", width << 16, height << 16))
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIIIIH10x", 0, 0, 1000, ms, 0x10000, 0x100),
                 _MATRIX, bytes(24), struct.pack(">I", 2))
    return _box(b"moov", mvhd, _box(b"trak", tkhd, mdia))


def _write_mp4(f, jpegs: Iterable[bytes], rate: Fraction, width: int, height: int) -> int:
    # the track's timescale as FFmpeg's mov muxer picks it: the frame rate's
    # numerator doubled until it reaches 10,000
    timescale, delta = rate.numerator, rate.denominator
    while timescale < 10000:
        timescale, delta = 2 * timescale, 2 * delta
    f.write(_box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41"))
    mdat = f.tell()
    f.write(struct.pack(">I4sQ", 1, b"mdat", 16))          # size patched below
    sizes = []
    for i, data in enumerate(jpegs):
        data = _frame_bytes(data, i)
        f.write(data)
        sizes.append(len(data))
    if not sizes:
        return 0
    end = f.tell()
    f.write(_mp4_moov(sizes, mdat + 16, timescale, delta, width, height))
    f.seek(mdat + 8)
    f.write(struct.pack(">Q", end - mdat))
    return len(sizes)


# ── the API ─────────────────────────────────────────────────────────────

def _frame_bytes(data, i: int) -> bytes:
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"frame {i} is not a JPEG (no SOI marker)")
    return data


def _index(path) -> tuple[list[int], list[int], dict]:
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"no video file at {path}")
    with open(p, "rb") as f:
        head = f.read(12)
        if len(head) < 12:
            raise _needs_ffmpeg(p, "it is neither an AVI nor an MP4 file (too short)")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
            try:
                if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
                    return _read_avi(buf, p)
                if head[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip"):
                    return _read_mp4(buf, p)
            except (struct.error, IndexError, TypeError) as e:
                raise ValueError(f"{p}: a corrupt or cut-short container ({e})") from e
    raise _needs_ffmpeg(p, "it is neither an AVI nor an MP4 / QuickTime file")


def probe(path) -> dict:
    """{"width", "height", "fps", "frame_count"} of a Motion JPEG AVI or MP4
    file, the keys of the reference's `probe_video`; fps is 30.0 where the
    container gives 0, as there."""
    _, _, info = _index(path)
    return {"width": info["width"], "height": info["height"],
            "fps": info["fps"] or 30.0, "frame_count": info["frame_count"]}


def frames(path) -> MJPEGFrames:
    """The JPEG bytes of each frame of a Motion JPEG AVI or MP4 file, in
    order, with random access by index."""
    offsets, sizes, info = _index(path)
    return MJPEGFrames(Path(path), offsets, sizes, info)


def write(path, jpegs: Iterable[bytes], fps: float, width: int, height: int) -> Path:
    """Write JPEG frames (each a whole baseline JPEG of width x height) as a
    Motion JPEG video: AVI for a `.avi` suffix, MP4 for any other.  Frames
    are streamed to the file; returns its path."""
    p = Path(path)
    rate = Fraction(fps).limit_denominator(1001) if fps > 0 else 0
    if rate <= 0:
        raise ValueError(f"write: fps {fps}; expected > 0")
    if not (0 < width < 65536 and 0 < height < 65536):
        raise ValueError(f"write: a {width} x {height} frame; sides of 1 to 65,535")
    p.parent.mkdir(parents=True, exist_ok=True)
    writer = _write_avi if container_of(p) == "avi" else _write_mp4
    try:
        with open(p, "w+b") as f:
            n = writer(f, jpegs, rate, width, height)
        if n == 0:
            raise ValueError(f"write: no frames for {p}")
    except BaseException:
        p.unlink(missing_ok=True)
        raise
    return p


def container_of(path) -> str:
    """"avi" for a `.avi` suffix, else "mp4": the container `write` picks."""
    return "avi" if Path(path).suffix.lower() == ".avi" else "mp4"
