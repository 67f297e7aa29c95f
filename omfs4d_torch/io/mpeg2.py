"""MPEG-1 video (ISO/IEC 11172-2) and MPEG-2 video (ISO/IEC 13818-2, Main
profile 4:2:0 frame pictures up to High level) read on the host: cv2's
`MPG1`, `PIM1` and `MPG2` writers' output (FFmpeg's mpeg1video /
mpeg2video encoders) in MPEG program streams (`.mpg`, `.mpeg`, `.vob`),
MPEG-TS, AVI, Matroska, MP4 and QuickTime, and the interlaced MPEG-2 of
DVDs, HDV camcorders and broadcast captures coded as frame pictures (field
and dual-prime prediction, field DCT), for a machine with no ffmpeg and no
cv2.

The decoder is the host C++ `mpeg2dec.cpp` (`Host`), built by g++ at first
use into `omfs4d_torch/_build/` (no Python fallback: without g++ reading
raises with the reason) and bound with ctypes; its tables come from
`mpeg2_tables.py`, its IDCT from `simple_idct.h`.  It decodes as FFmpeg's
`mpeg1video` / `mpeg2video` decoders do (`mpeg2dec.cpp` lists where that
departs from the standard); its samples are FFmpeg's bit for bit.

`parse_headers` reads the sequence header and its extensions (size, frame
rate, profile and level, progressive or not, chroma format, the colour
description) and refuses what the decoder does not read by name, as
`container.UnsupportedCodecError`: 4:2:2 and 4:4:4 (the 422P profile of
IMX / D-10 and XDCAM HD422) and the scalable extensions.  `Timeline` is
FFmpeg's handling of packets from their headers alone: which pictures it
decodes (a P picture before any sync point, or a B picture of an open GOP
with no past reference, is dropped; a P picture after a sequence header
with no reference predicts from FFmpeg's grey dummy picture), and what it
shows when: a B picture at once, an I or P picture when the next one
starts (at once where `low_delay`), the last at the end.  `MPEG2Frames`
shows a file's frames as cv2 does, through it (`as_cv2_shows`: a frame
FFmpeg flags interlaced is shown as the last one cv2's swscale converted),
converted with the sequence display extension's matrix (where it has no
colour description, a `colr` box's) through `h264.ycbcr_to_rgb` (swscale's
own conversion, bit for bit), each decoded from the last I picture after a
sequence header that its references go back to, or on from the last one
decoded.  Refused by name besides: field pictures, a first frame flagged
interlaced, pulldown in a program or transport stream (see `Timeline`,
`as_cv2_shows`, `MPEG2Frames`).
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Iterator, Sequence
from fractions import Fraction
from pathlib import Path
from typing import NamedTuple

import numpy as np

from omfs4d_torch.io import colour, container, mpeg2_tables, swscale
from omfs4d_torch.io.h264 import ycbcr_to_rgb

_SOURCE = Path(__file__).resolve().with_name("mpeg2dec.cpp")
_IDCT = Path(__file__).resolve().with_name("simple_idct.h")
_GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

SEQUENCE, GOP, PICTURE, EXTENSION, USER_DATA = 0xB3, 0xB8, 0x00, 0xB5, 0xB2
FRAME = 3                                     # picture_structure of a frame picture
DUMMY = -1                                    # FFmpeg's grey picture, as a reference


def _unsupported(what: str) -> container.UnsupportedCodecError:
    return container.UnsupportedCodecError(
        f"{what} needs ffmpeg: the port decodes MPEG-1 video and MPEG-2 video of Main "
        "profile 4:2:0 (frame pictures, progressive or interlaced, up to High level) by itself; "
        "decoding this "
        "needs an ffmpeg binary (on PATH or from imageio_ffmpeg)")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use, with g++, into `omfs4d_torch/_build/`) and load
    the host decoder; raises RuntimeError with g++'s message when it cannot:
    no frame is decoded in Python on the reading path."""
    from omfs4d_torch import native

    path = native.build(_SOURCE, "mpeg2dec", _GXX_FLAGS,
                        "omfs4d_torch/io/mpeg2dec.cpp (the MPEG-1 / MPEG-2 video decoder)",
                        headers={"mpeg2_tables.h": mpeg2_tables.cpp_header(),
                                 "simple_idct.h": _IDCT.read_text()})
    lib = ctypes.CDLL(str(path))
    lib.mp2d_new.restype = ctypes.c_void_p
    lib.mp2d_new.argtypes = []
    lib.mp2d_free.argtypes = [ctypes.c_void_p]
    lib.mp2d_free.restype = None
    lib.mp2d_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int]
    lib.mp2d_flush.argtypes = [ctypes.c_void_p]
    lib.mp2d_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                              ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
    lib.mp2d_take.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.mp2d_error.restype = ctypes.c_char_p
    lib.mp2d_error.argtypes = [ctypes.c_void_p]
    return lib


class Host:
    """The host C++ decoder (`mpeg2dec.cpp`) itself: a packet in (`push`,
    with the tag that names the frame a picture of it starts; the
    container's extradata with `extradata`), the pictures FFmpeg would
    show, in order (`take`: (tag, (Y', Cb, Cr)) uint8 planes, chroma of
    half the size rounded up), and `flush` at the stream's end.  A corrupt packet raises ValueError and one outside the
    decoder's subset `UnsupportedCodecError` naming the tool; after either
    the decoder is spent."""

    def __init__(self):
        self._lib = _library()
        self._h = self._lib.mp2d_new()
        if not self._h:
            raise MemoryError("MPEG-1/2 video: the decoder could not be created")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mp2d_free(self._h)
            self._h = None

    def _check(self, rc: int) -> None:
        if rc:
            msg = self._lib.mp2d_error(self._h).decode("utf-8", "replace")
            raise _unsupported(msg) if rc == 2 else ValueError(msg)

    def push(self, data: bytes, tag: int, extradata: bool = False) -> None:
        self._check(self._lib.mp2d_push(self._h, bytes(data), len(data), tag, int(extradata)))

    def flush(self) -> None:
        self._check(self._lib.mp2d_flush(self._h))

    def take(self) -> list[tuple[int, tuple[np.ndarray, np.ndarray, np.ndarray]]]:
        """Every picture to show that the decoder holds, in order."""
        out = []
        w, h, tag = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
        while not self._lib.mp2d_next(self._h, ctypes.byref(w), ctypes.byref(h),
                                      ctypes.byref(tag)):
            cw, ch = (w.value + 1) // 2, (h.value + 1) // 2
            planes = (np.empty((h.value, w.value), np.uint8), np.empty((ch, cw), np.uint8),
                      np.empty((ch, cw), np.uint8))
            self._lib.mp2d_take(self._h, *(p.ctypes.data for p in planes))
            out.append((tag.value, planes))
        return out


# ── headers ─────────────────────────────────────────────────────────────

def start_codes(data: bytes) -> list[tuple[int, int]]:
    """(position after the start code, its value) of each start code
    (00 00 01 xx) in data."""
    out = []
    at = data.find(b"\x00\x00\x01")
    while 0 <= at < len(data) - 3:
        out.append((at + 4, data[at + 3]))
        at = data.find(b"\x00\x00\x01", at + 3)
    return out


class _Reader:
    """Bits of a header, read MSB first (zeros past its end)."""

    def __init__(self, data: bytes):
        self.v, self.pos = int.from_bytes(data[:64].ljust(64, b"\0"), "big"), 0

    def u(self, n: int) -> int:
        self.pos += n
        return (self.v >> (512 - self.pos)) & ((1 << n) - 1) if self.pos <= 512 else 0


def sequence_header(body: bytes) -> dict:
    """The fields of a sequence header (after its start code)."""
    r = _Reader(body)
    return {"width": r.u(12), "height": r.u(12), "aspect": r.u(4), "frame_rate_code": r.u(4)}


def extension(body: bytes, out: dict) -> int:
    """The extension's id; a sequence extension's and a sequence display
    extension's fields go into `out`."""
    r = _Reader(body)
    ext = r.u(4)
    if ext == 1:
        r.u(1)
        out["profile"], out["level"] = r.u(3), r.u(4)
        out["progressive_sequence"], out["chroma_format"] = r.u(1), r.u(2) or 1
        out["width"] |= r.u(2) << 12
        out["height"] |= r.u(2) << 12
        r.u(12 + 1 + 8)
        out["low_delay"] = r.u(1)
        out["frame_rate_ext"] = (r.u(2), r.u(5))
        out["mpeg2"] = True
    elif ext == 2:
        r.u(3)
        if r.u(1):
            out["primaries"], out["transfer"], out["matrix"] = r.u(8), r.u(8), r.u(8)
            out["colour_description"] = True
    return ext


def check(params: dict, where: str) -> None:
    """Refuse, by name, a sequence the decoder does not read."""
    if params.get("chroma_format", 1) != 1:
        raise _unsupported(f"{where}: MPEG-2 video of chroma_format "
                           f"{('4:2:2', '4:4:4')[params['chroma_format'] - 2]} (the 422P profile: "
                           "IMX / D-10, XDCAM HD422; only 4:2:0)")
    if not params["width"] or not params["height"]:
        raise ValueError(f"{where}: an MPEG-1/2 sequence header of width or height 0")


def parse_headers(data: bytes) -> dict:
    """The first sequence header of `data` and the extensions after it:
    width, height, `mpeg2` (a sequence extension follows), profile and
    level, `progressive_sequence`, `chroma_format`, `low_delay`, the frame
    rate (`rate`, a Fraction: frame_rate_code's, times the extension's
    (n + 1) / (d + 1); None for a code FFmpeg has no rate for), and
    `primaries`, `transfer`, `matrix` (the sequence display extension's
    colour description; 2, unspecified, where there is none) with
    `colour_description` and `full_range` False (MPEG-2 has no range flag).
    Raises `UnsupportedCodecError` for what the decoder does not read,
    ValueError where there is no sequence header."""
    out: dict = {}
    codes = start_codes(data)
    for k, (at, code) in enumerate(codes):
        if code == SEQUENCE:
            out = dict(sequence_header(data[at:at + 8]), mpeg2=False, profile=None, level=None,
                       progressive_sequence=1, chroma_format=1, low_delay=0,
                       frame_rate_ext=(0, 0), primaries=2, transfer=2, matrix=2,
                       colour_description=False, full_range=False)
            for at2, code2 in codes[k + 1:]:
                if code2 == EXTENSION:
                    ext = extension(data[at2:at2 + 16], out)
                    if ext in (5, 9, 10):
                        raise _unsupported("MPEG-2 video scalable extension (spatial, SNR, "
                                           "temporal or data partitioning)")
                elif code2 != USER_DATA:
                    break
            break
    if not out:
        raise ValueError("MPEG-1/2 video: no sequence header")
    num, den = mpeg2_tables.FRAME_RATE[out["frame_rate_code"]]
    n, d = out["frame_rate_ext"]
    out["rate"] = Fraction(num * (n + 1), den * (d + 1)) if den else None
    check(out, "the stream")
    return out


# ── FFmpeg's handling of packets, from their headers ────────────────────

class Step(NamedTuple):
    """What FFmpeg's decoder does with one packet (`Timeline.packet`): the
    frames shown after it (their tags: the packet each was decoded from),
    the frame the packet decodes
    (`frame`, or None), its picture type (`kind`, "I" / "P" / "B") and
    `refs`, the frames it predicts from; `interlaced`: FFmpeg flags the
    frame interlaced (progressive_frame 0 in a sequence that is not
    progressive)."""
    shown: list
    frame: int | None
    kind: str
    refs: tuple
    interlaced: bool = False
    repeat_first_field: bool = False


class Timeline:
    """FFmpeg's MPEG-1 / MPEG-2 decoding (mpeg12dec.c's decode_chunks,
    mpeg_field_start, slice_end, the flush) at the level of packets and
    pictures, from the headers alone; `Host` does the same with the
    samples, and a reader runs this over a file's packets to number and
    place its frames.  Field pictures raise `UnsupportedCodecError`: cv2
    5.0.0's FFmpeg decodes a field pair into the frame's top half, its first
    field's lines one after another, and what it puts below matches no
    decode of the second field (measured), so the port cannot copy it."""

    def __init__(self):
        self.params: dict | None = None
        self.size: tuple[int, int, int] | None = None
        self.mpeg2 = False
        self.progressive = 1
        self.low_delay = 0
        self.sync = self.closed_gop = False
        self.last = self.next = None                 # tags of the references (DUMMY: grey)
        self.cur = None

    def packet(self, data: bytes, k: int, extradata: bool = False) -> Step:
        """What FFmpeg does with packet k (or the extradata)."""
        where = "the extradata" if extradata else f"packet {k}"
        last_code, skip, first_slice, seen, started = 0, False, False, False, False
        pict_type, kind, refs, progressive_frame, rff = 0, "", set(), 1, 0
        codes = start_codes(data)
        for at, code in codes:
            if code == SEQUENCE and last_code == 0:
                seq = sequence_header(data[at:at + 8])
                self.params = dict(seq, mpeg2=False, progressive_sequence=1, chroma_format=1,
                                   low_delay=self.low_delay)
                self.mpeg2, self.progressive = False, 1
                if not extradata:
                    self.sync = True
            elif code == PICTURE:
                if seen:
                    raise _unsupported(f"{where}: MPEG-1/2 video packet with a second picture "
                                       "after a frame picture (FFmpeg decodes its slices into "
                                       "the first)")
                seen = True
                if self.params is None:
                    return Step([], None, "", ())     # no size yet: FFmpeg drops it
                if last_code in (0, 1):
                    p = self.params
                    size = (p["width"], p["height"], self.progressive if self.mpeg2 else 1)
                    if self.size is None:
                        self.size = size
                    elif size != self.size:
                        raise _unsupported(
                            f"{where}: MPEG-1/2 video sequence header that changes the picture "
                            f"size or scan ({self.size[0]}x{self.size[1]}, then "
                            f"{size[0]}x{size[1]})")
                    r = _Reader(data[at:at + 4])
                    r.u(10)
                    pict_type = r.u(3)
                    if pict_type == 4:
                        raise _unsupported(f"{where}: MPEG-1 video D-pictures")
                    if pict_type > 3:
                        pict_type = 0
                    first_slice, last_code = True, 0x100
            elif code == EXTENSION:
                r = _Reader(data[at:at + 8])
                ext = r.u(4)
                if ext == 1 and last_code == 0:
                    extension(data[at:at + 16], self.params or {"width": 0, "height": 0})
                    body = _Reader(data[at:at + 16])
                    body.u(4 + 8)
                    self.progressive = body.u(1)
                    chroma = body.u(2)
                    body.u(2 + 2 + 12 + 1 + 8)
                    self.low_delay = body.u(1)
                    self.mpeg2 = True
                    if self.params is not None:
                        self.params["chroma_format"] = chroma or 1
                        check(self.params, where)
                elif ext == 8 and last_code == 0x100:
                    r.u(16 + 2)
                    structure = r.u(2)
                    r.u(6)
                    rff = r.u(1)
                    r.u(1)
                    progressive_frame = r.u(1)
                    if structure != FRAME:
                        raise _unsupported(
                            f"{where}: MPEG-2 video field pictures (cv2 5.0.0's FFmpeg decodes a "
                            "field pair into the frame's top half, its first field's lines one "
                            "after another)")
                elif ext in (5, 9, 10):
                    raise _unsupported(f"{where}: MPEG-2 video scalable extension (spatial, "
                                       "SNR, temporal or data partitioning)")
            elif code == GOP and last_code == 0:
                r = _Reader(data[at:at + 4])
                r.u(25)
                self.closed_gop = bool(r.u(1))
                self.sync = True
            elif 0x01 <= code <= 0xAF and last_code != 0:
                last_code = 1
                if self.last is None and pict_type == 3 and not self.closed_gop:
                    skip = True
                    continue
                if pict_type == 1:
                    self.sync = True
                if self.next is None and pict_type == 2 and not self.sync:
                    skip = True
                    continue
                if not pict_type:
                    skip = True
                    continue
                if first_slice:
                    skip = first_slice = False
                    p = self.params
                    mbw = (p["width"] + 15) // 16
                    mbh = ((p["height"] + 31) // 32 * 2 if self.mpeg2 and not self.progressive
                           else (p["height"] + 15) // 16)
                    if mbw * mbh * 11 // (33 * 2 * 8) > len(data):
                        raise _unsupported(f"{where}: MPEG-1/2 video picture in fewer bytes than "
                                           "FFmpeg decodes (it drops it)")
                    kind = " IPB"[pict_type]
                    self.cur = k
                    if pict_type != 3:
                        self.last, self.next = self.next, k
                    if self.last is None and pict_type != 1:
                        if pict_type == 3 and self.next is None:
                            raise _unsupported(f"{where}: MPEG-1/2 video B-picture with no "
                                               "reference at all before it")
                        self.last = DUMMY
                    started = True
                    if pict_type == 2:
                        refs.add(self.last)
                    elif pict_type == 3:
                        refs.update((self.last, self.next))
            elif code == USER_DATA and data[at:at + 7] == b"TMPGEXS":
                raise _unsupported(f"{where}: MPEG-2 video stamped TMPGEXS (FFmpeg rewrites its "
                                   "intra DC quantiser)")
        if skip or extradata or not started:
            return Step([], None, "", ())
        frame = self.cur
        refs.discard(frame)
        refs.discard(None)
        if pict_type == 3 or self.low_delay:
            shown = [frame]
        else:
            shown = [self.last] if self.last not in (None, DUMMY) else []
        interlaced = self.mpeg2 and not self.progressive and not progressive_frame
        return Step(shown, frame, kind, tuple(sorted(refs)), interlaced, bool(rff))

    def flush(self) -> list[int]:
        """The frame FFmpeg shows after the last packet."""
        out = [self.next] if not self.low_delay and self.next is not None else []
        self.next = None
        return out


def as_cv2_shows(shown: list[int], interlaced: set[int], where) -> list[int]:
    """The frames cv2 5.0.0 shows for the frames FFmpeg outputs (`shown`,
    their tags): its swscale refuses to convert a frame FFmpeg flags
    interlaced, and cv2 shows the last picture it converted in its place
    (the frame before it that is not so flagged); where no frame before one
    is, cv2 shows memory never written, and that raises
    `UnsupportedCodecError`."""
    out, good = [], None
    for p in shown:
        if p in interlaced:
            if good is None:
                raise _unsupported(
                    f"{where}: MPEG-2 video whose first frame is flagged interlaced "
                    "(progressive_frame 0): cv2 5.0.0's swscale refuses to convert such a frame "
                    "and shows the last one it converted, here none")
            out.append(good)
        else:
            out.append(p)
            good = p
    return out


# ── raw streams and the parser ──────────────────────────────────────────

def split_stream(data: bytes) -> list[bytes]:
    """An elementary stream cut into packets as FFmpeg's mpegvideo parser
    cuts it (`ff_mpeg1_find_frame_end`, `mpegts.Splitter`)."""
    from omfs4d_torch.io import mpegts

    splitter = mpegts.Splitter("mpeg2")
    splitter.feed(data)
    return [data[o:o + n] for o, n in splitter.end(len(data))]


def decode_stream(data: bytes) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Every picture of an elementary stream, through the host decoder, in
    the order and number cv2 shows them: cut into packets as FFmpeg's parser
    cuts it."""
    host, timeline = Host(), Timeline()
    decoded, shown, interlaced = {}, [], set()
    for k, packet in enumerate(split_stream(data)):
        step = timeline.packet(packet, k)
        if step.interlaced:
            interlaced.add(k)
        host.push(packet, k)
        got = host.take()
        if [t for t, _ in got] != step.shown:
            raise ValueError(f"MPEG-1/2 video: packet {k}: the decoder showed "
                             f"{[t for t, _ in got]}, the headers say {step.shown}")
        decoded.update(got)
        shown += step.shown
    shown += timeline.flush()
    host.flush()
    decoded.update(host.take())
    return [decoded[t] for t in as_cv2_shows(shown, interlaced, "the stream")]


# ── the reader ──────────────────────────────────────────────────────────

class MPEG2Frames(Sequence):
    """The frames of an MPEG-1 / MPEG-2 video file (MPEG-PS, MPEG-TS, AVI,
    Matroska, MP4 / QuickTime) as (H, W, 3) uint8 RGB, decoded by the host
    decoder on access (`frames[i]`, `len(frames)`, iteration), as cv2 shows
    them: in FFmpeg's order and number (`Timeline`), converted with the
    sequence display extension's colour description (where it has none, a
    `colr` box's; limited range), chroma sited as FFmpeg sites it (MPEG-1:
    centred; MPEG-2: left), through `h264.ycbcr_to_rgb`.  Every packet's
    headers are read when the file is opened, so that a tool outside the
    decoder is refused before any decode.  A frame is decoded from the
    last I picture after a sequence header that its references go back to,
    or on from the last one decoded; pictures shown later than decoded are
    kept until shown."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        self.path, self.offsets, self.sizes, self.info = path, offsets, sizes, info
        self.extradata = info.get("extradata") or b""
        timeline = Timeline()
        if self.extradata:
            timeline.packet(self.extradata, -1, extradata=True)
        self.params: dict | None = None
        shown: list[int] = []
        interlaced: set[int] = set()
        roots: dict[int, int] = {}
        starts: list[int] = []
        with open(path, "rb") as f:
            for k, (o, s) in enumerate(zip(offsets, sizes)):
                data = container.read_sample(f, o, s, info)
                if self.params is None and b"\x00\x00\x01\xb3" in data:
                    self.params = parse_headers(data)
                try:
                    step = timeline.packet(data, k)
                except ValueError as e:
                    raise ValueError(f"{path}: frame {k}: {e}") from None
                except container.UnsupportedCodecError as e:
                    raise type(e)(f"{path}: frame {k}: {e}") from None
                if step.interlaced:
                    interlaced.add(k)
                if step.repeat_first_field and info["container"] in ("mpegps", "mpegts"):
                    raise _unsupported(
                        f"{path}: frame {k}: MPEG-2 video with repeat_first_field (pulldown) in "
                        "an MPEG program or transport stream: cv2's fps and frame count then "
                        "follow FFmpeg's field-counted packet durations, which the port does "
                        "not follow")
                if step.frame == k:
                    refs = [r for r in step.refs if r != DUMMY]
                    roots[k] = min((roots[r] for r in refs), default=k)
                    if roots[k] == k and step.kind == "I" and \
                            SEQUENCE in {c for _, c in start_codes(data[:4096])}:
                        starts.append(k)
                shown += step.shown
        if self.params is None:
            if not self.extradata:
                raise ValueError(f"{path}: no MPEG-1/2 sequence header")
            self.params = parse_headers(self.extradata)
        shown += timeline.flush()
        self.pictures = as_cv2_shows(shown, interlaced, path)
        self.roots = roots
        self.starts = sorted(set(starts) | ({0} if offsets else set()))
        self.last_shown = {p: i for i, p in enumerate(shown)}
        tags = colour.from_container(self.params, info.get("colr"))
        self.colour = dict(colour.stream(tags),
                           location=swscale.LEFT if self.params["mpeg2"] else swscale.CENTER)
        self._decoder: Host | None = None
        self._since = self._next = 0
        self._emitted: set[int] = set()
        self._held: dict[int, tuple[np.ndarray, ...]] = {}

    def __len__(self) -> int:
        return len(self.pictures)

    def sample(self, i: int) -> bytes:
        with open(self.path, "rb") as f:
            data = container.read_sample(f, self.offsets[i], self.sizes[i], self.info)
        if len(data) != len(self.info.get("prefix", b"")) + self.sizes[i]:
            raise ValueError(f"{self.path}: frame {i} is cut short")
        return data

    def ycbcr(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Frame i as decoded: Y', Cb, Cr uint8 planes."""
        n = len(self)
        if not -n <= i < n:
            raise IndexError(f"{self.path}: frame {i} of {n}")
        i %= n
        p = self.pictures[i]
        if p in self._held:
            return self._held[p]
        root = self.roots[p]
        if self._decoder is None or p in self._emitted or root < self._since:
            start = max(s for s in self.starts if s <= root)
            self._decoder, self._since, self._next = Host(), start, start
            self._emitted, self._held = set(), {}
            if self.extradata:
                self._run(lambda d: d.push(self.extradata, -1, extradata=True), "the extradata")
        while p not in self._held:
            k = self._next
            if k > len(self.offsets):
                raise ValueError(f"{self.path}: the decoder never showed frame {i}")
            self._next += 1
            if k == len(self.offsets):
                self._run(lambda d: d.flush(), "the stream's end")
            else:
                container.check_whole(self.path, self.info, k)
                data = self.sample(k)
                self._run(lambda d: d.push(data, k), f"frame {k}")
            for tag, planes in self._decoder.take():
                self._emitted.add(tag)
                if self.last_shown.get(tag, -1) >= i:
                    self._held[tag] = planes
        self._held = {q: v for q, v in self._held.items() if self.last_shown[q] >= i}
        return self._held[p]

    def _run(self, f, where: str) -> None:
        try:
            f(self._decoder)
        except ValueError as e:
            self._decoder = None
            raise ValueError(f"{self.path}: {where}: {e}") from None
        except container.UnsupportedCodecError as e:
            self._decoder = None
            raise type(e)(f"{self.path}: {where}: {e}") from None

    def __getitem__(self, i: int) -> np.ndarray:
        return ycbcr_to_rgb(*self.ycbcr(i), **self.colour)

    rgb = __getitem__

    def probe(self) -> dict:
        """{"width", "height", "fps", "frame_count"} as cv2 reports them,
        with no decode: the sequence header's size, the container's rate
        (else the sequence's) and count."""
        p = self.params
        fps = self.info["fps"] or (float(p["rate"]) if p["rate"] else 25.0)
        return {"width": p["width"], "height": p["height"], "fps": fps,
                "frame_count": self.info["frame_count"]}

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]


def frames(path) -> MPEG2Frames:
    """The frames of an MPEG-1 / MPEG-2 video file, decoded on access by
    the host decoder; headers outside its subset raise."""
    offsets, sizes, info = container.index(path)
    if info["codec"] != "mpeg2":
        raise ValueError(f"{path}: its video is not MPEG-1 / MPEG-2")
    return MPEG2Frames(Path(path), offsets, sizes, info)
