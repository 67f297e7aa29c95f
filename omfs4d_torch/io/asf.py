"""ASF (Advanced Systems Format: `.wmv`, `.asf`) read as FFmpeg's default
`asf` demuxer (libavformat/asfdec_f.c) reads it, with the standard library:
which codec the first video stream holds and where its frames lie.

- The header object (`probe`: its GUID), its file properties (packet size,
  play duration, preroll, the broadcast flag), the stream properties of the
  first video stream (its BITMAPINFOHEADER: size, fourcc and the extradata
  after it), the objects inside the header extension, and the data object.
- The data packets: error correction data, the length type and property
  flags, a packet's length, padding, send time and duration, single and
  multiple payloads; a payload's stream, media object
  number, offset into the object and replicated data (the object's size
  and presentation time), or a compressed payload (replicated data of 1
  byte: sub-payloads of a byte's size each, their times the payload's plus
  a delta each).  A media object is gathered from its fragments across
  packets as FFmpeg gathers it: a fragment that continues no object is
  dropped, a new object drops an unfinished one, and the object is a frame
  when its bytes are all in.  Its time is the presentation time less the
  preroll, in milliseconds.
- cv2's probe: the rate FFmpeg estimates from those times (as for Matroska,
  `matroska.cv2_fps`, the codec's own rate where it reads one), and the
  count floor(seconds x fps + 0.5) of the file properties' play duration
  less the preroll, as FFmpeg sets the stream's duration (unless the
  broadcast flag is set or the file's size is 1/20 off the one declared,
  which the port refuses by name: FFmpeg then estimates the duration from
  the bit rate).
- The codec by the BITMAPINFOHEADER's fourcc, read as AVI's
  (`container.avi_codec`): MS MPEG-4 v2 / v3 and WMV1 / WMV2 (the four the
  Windows family's `.wmv` files hold), and what cv2 writes into `.wmv`
  besides: Motion JPEG, MPEG-4 Part 2, VP8, VP9, MPEG-1 / MPEG-2, H.264 and
  HEVC.  Any other (WMV 9 / VC-1, WMV Screen, ...) raises
  `UnsupportedCodecError` naming it.

`index` gives (sample offsets, sample sizes, info) as `container.index`
does; a sample's offset is its index, and its bytes come through
`info["es"]` (`Objects.read`), which gathers its fragments.
"""

from __future__ import annotations

import struct
import uuid
from pathlib import Path

from omfs4d_torch.io import matroska


def _guid(text: str) -> bytes:
    return uuid.UUID(text).bytes_le


HEADER = _guid("75b22630-668e-11cf-a6d9-00aa0062ce6c")
FILE_PROPERTIES = _guid("8cabdca1-a947-11cf-8ee4-00c00c205365")
STREAM_PROPERTIES = _guid("b7dc0791-a9b7-11cf-8ee6-00c00c205365")
HEADER_EXTENSION = _guid("5fbf03b5-a92e-11cf-8ee3-00c00c205365")
EXTENDED_STREAM_PROPERTIES = _guid("14e6a5cb-c672-4332-8399-a96952065b5a")
DATA = _guid("75b22636-668e-11cf-a6d9-00aa0062ce6c")
VIDEO_MEDIA = _guid("bc19efc0-5b4d-11cf-a8fd-00805f5c442b")
FRAME_HEADER_SIZE = 6


class Cut(Exception):
    """The file ends inside an object FFmpeg needs whole."""


def probe(head: bytes) -> bool:
    """Whether the file starts with ASF's header object, as FFmpeg's probe
    takes it."""
    return head[:16] == HEADER


class Objects:
    """Where each media object (frame) of the video stream lies in the
    file: its fragments, (offset in the object, file position, length);
    `read` gathers sample `offset` (its index), zeros where FFmpeg leaves
    none."""

    def __init__(self):
        self.pieces: list[list[tuple[int, int, int]]] = []

    def bytes_of(self, buf, i: int, size: int) -> bytes:
        """Sample i's bytes from the mapped file (those the file holds)."""
        out = bytearray(size)
        for at, pos, n in self.pieces[i]:
            part = buf[pos:pos + n]
            out[at:at + len(part)] = part
        return bytes(out)

    def read(self, f, offset: int, size: int) -> bytes:
        out = bytearray(size)
        for at, pos, n in self.pieces[offset]:
            f.seek(pos)
            part = f.read(n)
            out[at:at + len(part)] = part
            if len(part) < n:
                return bytes(out[:at + len(part)])
        return bytes(out)


def _uint(buf, pos: int, n: int) -> int:
    if pos + n > len(buf):
        raise Cut(f"the file ends at byte {len(buf)}, inside a packet")
    return int.from_bytes(buf[pos:pos + n], "little")


def _sized(buf, pos: int, kind: int, default: int) -> tuple[int, int]:
    """FFmpeg's DO_2BITS: a field of 0, 1, 2 or 4 bytes by its length type."""
    n = (0, 1, 2, 4)[kind & 3]
    return (_uint(buf, pos, n) if n else default), pos + n


def _headers(buf, path: Path) -> dict:
    """The header objects FFmpeg reads: file and first video stream
    properties (objects inside the header extension read alike), and where
    the data object's packets start."""
    (size,) = struct.unpack_from("<Q", buf, 16)
    out = {"video": None, "data": None, "bit_rates": {}, "extensions": {}}
    pos, end = 30, min(len(buf), size)

    def objects(pos: int, end: int) -> None:
        while pos + 24 <= end:
            guid = bytes(buf[pos:pos + 16])
            (osize,) = struct.unpack_from("<Q", buf, pos + 16)
            if osize < 24:
                raise ValueError(f"{path}: an ASF header object of {osize} bytes")
            body = pos + 24
            if guid == FILE_PROPERTIES:
                (out["file_size"], _, out["packets"], out["play"], _, out["preroll"],
                 out["flags"], out["min_packet"], out["packet_size"]) = struct.unpack_from(
                    "<QQQQQQIII", buf, body + 16)
            elif guid == STREAM_PROPERTIES and out["video"] is None:
                if bytes(buf[body:body + 16]) == VIDEO_MEDIA:
                    (specific,) = struct.unpack_from("<I", buf, body + 40)
                    (flags,) = struct.unpack_from("<H", buf, body + 48)
                    t = body + 54
                    if specific >= 51:
                        (bih_size,) = struct.unpack_from("<I", buf, t + 11)
                        width, height = struct.unpack_from("<II", buf, t + 15)
                        fourcc = bytes(buf[t + 27:t + 31])
                        extra = bytes(buf[t + 51:t + 51 + max(bih_size - 40, 0)]) \
                            if bih_size > 40 else b""
                        out["video"] = {"stream": flags & 0x7F, "width": width,
                                        "height": height, "fourcc": fourcc, "extradata": extra}
            elif guid == EXTENDED_STREAM_PROPERTIES:
                # asf_read_ext_stream_properties: the leak rate FFmpeg takes
                # as the stream's bit rate, and its payload extension systems
                (rate,) = struct.unpack_from("<I", buf, body + 16)
                (number,) = struct.unpack_from("<H", buf, body + 48)
                (extensions,) = struct.unpack_from("<H", buf, body + 62)
                out["bit_rates"][number] = rate
                out["extensions"][number] = extensions
            elif guid == HEADER_EXTENSION:
                objects(body + 22, min(pos + osize, end))
            pos += osize

    objects(pos, end)
    if size + 50 <= len(buf) and bytes(buf[size:size + 16]) == DATA:
        # the packets end with the data object, unless the file is a
        # broadcast or the object's size under 100 bytes (then the file)
        (dsize,) = struct.unpack_from("<Q", buf, size + 16)
        out["data"] = (size + 50, size + dsize if not out.get("flags", 0) & 1 and dsize >= 100
                       else len(buf))
    if "packet_size" not in out:
        raise ValueError(f"{path}: an ASF file with no file properties object")
    if out["video"] is None:
        raise ValueError(f"{path}: an ASF file with no video stream")
    if out["data"] is None:
        raise ValueError(f"{path}: an ASF file with no data object after its header")
    return out


def _packet_start(buf, pos: int, stop: int) -> int:
    """Where asf_get_packet finds the next packet: at the first bytes 82 00
    00 (the error correction data it syncs on) within 32,768 bytes of pos;
    a file whose packets carry none is refused there."""
    k = bytes(buf[pos:min(pos + 32768 + 2, stop)]).find(b"\x82\x00\x00")
    if k < 0:
        raise ValueError(f"no ASF packet's start within 32,768 bytes of byte {pos}")
    return pos + k


def _objects(buf, h: dict, codec: str, path: Path) -> tuple[Objects, list[int], list[int]]:
    """The video stream's media objects, gathered from the data packets as
    asf_get_packet, asf_read_frame_header and asf_parse_packet gather them:
    (their fragments, sizes, times in ms)."""
    objs, sizes, times = Objects(), [], []
    video, preroll = h["video"]["stream"], h["preroll"]
    start, stop = h["data"]
    stop = min(stop, len(buf))
    got = size = obj_size = 0         # the object being gathered: bytes in, size
    pieces: list[tuple[int, int, int]] = []
    obj_time = 0
    pos = start
    try:
        while pos + 11 <= stop:
            # ── asf_get_packet ──
            first = _packet_start(buf, pos, stop)
            p = first + 3
            flags, prop = buf[p], buf[p + 1]
            p += 2
            length, p = _sized(buf, p, flags >> 5, h["packet_size"])
            _, p = _sized(buf, p, flags >> 1, 0)                      # sequence, ignored
            pad, p = _sized(buf, p, flags >> 3, 0)
            if not length or length >= 1 << 29 or pad >= length:
                raise ValueError(f"{path}: an ASF packet at byte {pos} of length {length}, "
                                 f"padding {pad}")
            send = _uint(buf, p, 4)
            p += 6
            segtype, segments = 0x80, 1
            if flags & 1:
                segtype = _uint(buf, p, 1)
                segments = segtype & 0x3F
                p += 1
            rsize = p - first
            if rsize > length - pad:
                raise ValueError(f"{path}: an ASF packet header at byte {pos} longer than its "
                                 "packet")
            left = length - pad - rsize
            if length < h["min_packet"]:
                pad += h["min_packet"] - length
            time_start = delta = multi = 0
            # ── asf_parse_packet, over the packet's payloads ──
            while True:
                if left < FRAME_HEADER_SIZE or (segments < 1 and time_start == 0):
                    p += left + pad
                    break
                if time_start == 0:
                    # asf_read_frame_header
                    num = _uint(buf, p, 1)
                    q = p + 1
                    segments -= 1
                    _, q = _sized(buf, q, prop >> 4, 0)
                    frag_offset, q = _sized(buf, q, prop >> 2, 0)
                    replic, q = _sized(buf, q, prop, 0)
                    if q - p + replic > left:
                        raise ValueError(f"{path}: an ASF payload at byte {p} with replicated "
                                         "data past its packet")
                    declared = None
                    if replic >= 8:
                        declared, frag_time = _uint(buf, q, 4), _uint(buf, q + 4, 4)
                        if declared >= 1 << 24:
                            raise ValueError(f"{path}: an ASF media object of {declared} bytes")
                        q += replic
                    elif replic == 1:
                        # a compressed payload: frag_offset is its first time
                        time_start, frag_offset, frag_time = frag_offset, 0, send
                        delta = _uint(buf, q, 1)
                        q += 1
                    elif replic:
                        raise ValueError(f"{path}: an ASF payload with {replic} bytes of "
                                         "replicated data")
                    if flags & 1:
                        frag_size, q = _sized(buf, q, segtype >> 6, 0)
                        if q - p > left:
                            raise ValueError(f"{path}: an ASF payload header past its packet")
                        if frag_size > left - (q - p):
                            diff = frag_size - (left - (q - p))
                            if diff > pad:
                                raise ValueError(f"{path}: an ASF payload at byte {p} runs past "
                                                 "its packet")
                            left += diff
                            pad -= diff
                    else:
                        frag_size = left - (q - p)
                    if replic == 1:
                        multi = frag_size
                    left -= q - p
                    p = q
                    if num & 0x7F != video:
                        time_start = 0
                        p += frag_size
                        left -= frag_size
                        continue
                    if declared is not None:        # the stream's object size
                        obj_size = declared
                if not got and frag_offset:
                    p += frag_size                  # continues no object: dropped
                    left -= frag_size
                    continue
                if replic == 1:
                    frag_time = time_start
                    time_start += delta
                    obj_size = frag_size = _uint(buf, p, 1)
                    p += 1
                    left -= 1
                    multi -= 1
                    if multi < obj_size:
                        time_start = 0
                        p += multi
                        left -= multi
                        continue
                    multi -= obj_size
                if size != obj_size or got + frag_size > size:
                    # a new object (an unfinished one dropped)
                    got, size, pieces = 0, obj_size, []
                    obj_time = frag_time - preroll
                left -= frag_size
                if left < 0 or frag_offset >= size or frag_size > size - frag_offset:
                    raise ValueError(f"{path}: an ASF fragment at byte {p} lies outside its "
                                     "packet or its media object")
                # the file's end inside a fragment: FFmpeg gives the object as
                # far as it goes (a sample shorter than its size, which the
                # readers refuse as cut short) and reads no further
                cut = p + frag_size > len(buf)
                if cut and p >= len(buf) and not frag_offset:
                    return objs, sizes, times       # not a byte of it: no object
                pieces.append((frag_offset, p, frag_size))
                got += frag_size
                p += frag_size
                if got == size or cut:
                    if cut or not (codec == "mpeg2" and size > 100 and not any(
                            any(buf[o:o + n]) for _, o, n in pieces)):
                        objs.pieces.append(pieces)  # (an all-zero MPEG-2 object: dropped)
                        sizes.append(size)
                        times.append(obj_time)
                    got = size = 0
                    pieces = []
                if cut:
                    return objs, sizes, times
            pos = p
    except Cut:
        pass                          # a packet cut by the file's end: FFmpeg's EOF
    return objs, sizes, times


def index(buf, path: Path) -> tuple[list[int], list[int], dict]:
    """(sample offsets, sample sizes, info) of an ASF file's first video
    stream, as `container.index` gives them: info holds width, height, fps,
    frame_count, container "asf", the codec's keys (`container.avi_codec`
    of its fourcc and extradata) and `es` (the `Objects` its samples are
    read through).  As from AVI, the readers take the frames in the file's
    order and find their own key frames."""
    from omfs4d_torch.io import container

    h = _headers(buf, path)
    v = h["video"]
    codec = container.avi_codec(v["fourcc"], v["extradata"], path, "ASF fourcc")
    stream = v["stream"]
    if h["extensions"].get(stream):
        raise container.UnsupportedCodecError(
            f"{path}: an ASF video stream with payload extension systems, whose data FFmpeg "
            "may take its frames' times from; decoding this as cv2 shows it needs an ffmpeg "
            "binary (on PATH or from imageio_ffmpeg)")
    # FFmpeg sets the stream's duration from the play duration unless the
    # file is a broadcast or its size is 1/20 off the one declared
    timed = not h["flags"] & 1 and (h["file_size"] <= 0 or abs(len(buf) - h["file_size"])
                                    < min(len(buf), h["file_size"]) // 20)
    if not timed and h["bit_rates"].get(stream):
        raise container.UnsupportedCodecError(
            f"{path}: an ASF file whose play duration FFmpeg does not take (a broadcast, or a "
            "file whose size is 1/20 off the one declared) with a declared bit rate, from "
            "which FFmpeg then estimates the duration; decoding this as cv2 shows it needs an "
            "ffmpeg binary (on PATH or from imageio_ffmpeg)")
    objs, sizes, times = _objects(buf, h, codec["codec"], path)

    offsets = list(range(len(sizes)))
    info = {"width": v["width"], "height": v["height"], "container": "asf", **codec,
            "es": objs}
    first = objs.bytes_of(buf, 0, sizes[0]) if sizes else b""
    rate = matroska._stream_rate(first, info, [0] if sizes else [], [len(first)], b"")
    fps = matroska.cv2_fps(times, rate, info["codec"])
    info["fps"] = fps
    # with no duration, OpenCV's count comes from the unset one (INT64_MIN
    # ticks of 1 / 1000 s), as for Matroska
    duration = h["play"] // 10000 - h["preroll"] if timed else None
    info["frame_count"] = matroska.frame_count(duration, 1_000_000, fps)
    return offsets, sizes, info
