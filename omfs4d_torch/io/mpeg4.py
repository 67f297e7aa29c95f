"""MPEG-4 Part 2 (ISO/IEC 14496-2) Simple and Advanced Simple profile read
on the host: the video cv2's `mp4v`, `XVID`, `DIVX` and `FMP4` writers
(FFmpeg's mpeg4 encoder) put in MP4 and AVI files, and so the JAX package's
own fallback output (`omfs4d.io.video.stitch_video` where cv2 has no H.264
encoder), and what Xvid and DivX write by default, B-VOPs, DivX's packed
bitstream, quarter-sample and MPEG quantisation, in AVI, MP4, Matroska and
MPEG-TS, for a machine with no ffmpeg and no cv2.

The decoder is the host C++ `mpeg4dec.cpp` (`Host`), built by g++ at first
use into `omfs4d_torch/_build/` (no Python fallback: without g++ reading
raises with the reason) and bound with ctypes; its tables come from
`mpeg4_tables.py`.  It decodes 8-bit 4:2:0 rectangular progressive I-, P-
and B-VOPs of any size: not-coded MBs, 1MV and 4MV, intra MBs in P-VOPs,
B-VOPs' direct (one or four co-located vectors), interpolated, backward and
forward MBs with dbquant, f_code and b_code 1-7, unrestricted half- or
quarter-sample vectors with both rounding types, DC / AC prediction, the
three TCOEF escapes, dquant, H.263 or MPEG quantisation (default or loaded
matrices), video packets with HEC, and the IDCT FFmpeg picks: Xvid's for a
stream stamped XviD (or an XVID AVI with no stamp), the simple one for every
other, with the workarounds FFmpeg applies to old Xvid and DivX builds; its
samples are FFmpeg's bit for bit.

`parse_headers` reads the VOS / VO / VOL headers in Python and refuses what
the decoder does not read by name, as `container.UnsupportedCodecError`,
before any decode: S-VOPs (sprites, GMC), interlaced, data partitioning and
reversible VLCs, a shape other than rectangular, more than 8 bits,
scalability, complexity estimation, NEWPRED, reduced-resolution VOPs, OBMC,
short-header H.263 and quarter-sample from an FFmpeg build whose filter
FFmpeg emulates; `later_vols` refuses the same in a VOL after the first VOP,
and a change of the picture size there.

`Timeline` is FFmpeg's handling of packets from their headers alone: DivX's
packed samples, the B-VOPs' times and the order and number of the pictures
shown.  `MPEG4Frames` shows a file's frames as cv2 does, through it:
converted with the VO's range, matrix, primaries and transfer (where the VO
has no colour description, a `colr` box's, as FFmpeg takes them) through
`h264.ycbcr_to_rgb` (swscale's own conversion, bit for bit: its unscaled
path at an even height, its scaled path, chroma sited left, at an odd one),
a frame decoded from the last I-VOP its picture goes back to, or on from the
last one decoded.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
import re
from collections.abc import Iterator, Sequence
from pathlib import Path
from typing import NamedTuple

import numpy as np

from omfs4d_torch.io import colour, container, mpeg4_tables
from omfs4d_torch.io.h264 import ycbcr_to_rgb

_SOURCE = Path(__file__).resolve().with_name("mpeg4dec.cpp")
_GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

VOP = b"\x00\x00\x01\xb6"
_VOP_KINDS = ("I", "P", "B", "S")


def _unsupported(what: str) -> container.UnsupportedCodecError:
    return container.UnsupportedCodecError(
        f"{what} needs ffmpeg: the port decodes MPEG-4 Part 2 Simple and Advanced Simple "
        "profile (8-bit 4:2:0 rectangular progressive I-, P- and B-VOPs, H.263 or MPEG "
        "quantisation, half- or quarter-sample vectors, DivX's packed bitstream) by itself; "
        "decoding this needs an ffmpeg binary (on PATH or from imageio_ffmpeg)")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use, with g++, into `omfs4d_torch/_build/`) and load
    the host decoder; raises RuntimeError with g++'s message when it cannot:
    no frame is decoded in Python on the reading path."""
    from omfs4d_torch import native

    path = native.build(_SOURCE, "mpeg4dec", _GXX_FLAGS,
                        "omfs4d_torch/io/mpeg4dec.cpp (the MPEG-4 Part 2 decoder)",
                        headers={"mpeg4_tables.h": mpeg4_tables.cpp_header()})
    lib = ctypes.CDLL(str(path))
    lib.m4vd_new.restype = ctypes.c_void_p
    lib.m4vd_new.argtypes = []
    lib.m4vd_free.argtypes = [ctypes.c_void_p]
    lib.m4vd_free.restype = None
    lib.m4vd_set_tag.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.m4vd_set_tag.restype = None
    lib.m4vd_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.m4vd_status.argtypes = [ctypes.c_void_p]
    lib.m4vd_frame_size.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.m4vd_take.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.m4vd_error.restype = ctypes.c_char_p
    lib.m4vd_error.argtypes = [ctypes.c_void_p]
    return lib


# what a push did (the decoder's m4vd_status), and the pictures it keeps
NONE, REF, BIDIR, NOT_CODED, B_SKIPPED = range(5)
_PICTURE = {"cur": 0, "fwd": 1, "bwd": 2}


class Host:
    """The host C++ decoder (`mpeg4dec.cpp`) itself: a unit in (`push`: the
    headers, a sample; its first VOP is decoded), what it did (`status`),
    a picture out (`take`: the last decoded, "cur", the past reference,
    "fwd", or the future one, "bwd") as (Y', Cb, Cr) uint8 planes (chroma of
    half the size, rounded up).  A corrupt unit raises ValueError and one
    outside the decoder's subset `UnsupportedCodecError` naming the tool;
    after either the decoder is spent."""

    def __init__(self, tag: bytes = b""):
        self._lib = _library()
        self._h = self._lib.m4vd_new()
        if not self._h:
            raise MemoryError("MPEG-4 Part 2: the decoder could not be created")
        if len(tag) == 4:
            self._lib.m4vd_set_tag(self._h, int.from_bytes(tag, "little"))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.m4vd_free(self._h)
            self._h = None

    def push(self, unit: bytes) -> int:
        rc = self._lib.m4vd_push(self._h, bytes(unit), len(unit))
        if rc:
            msg = self._lib.m4vd_error(self._h).decode("utf-8", "replace")
            raise _unsupported(msg) if rc == 2 else ValueError(msg)
        return self.status()

    def status(self) -> int:
        return self._lib.m4vd_status(self._h)

    def take(self, which: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        k = _PICTURE[which]
        w, h = ctypes.c_int32(), ctypes.c_int32()
        if self._lib.m4vd_frame_size(self._h, k, ctypes.byref(w), ctypes.byref(h)):
            raise ValueError(f"MPEG-4 Part 2: no picture to show ({which})")
        cw, ch = (w.value + 1) // 2, (h.value + 1) // 2
        planes = (np.empty((h.value, w.value), np.uint8), np.empty((ch, cw), np.uint8),
                  np.empty((ch, cw), np.uint8))
        self._lib.m4vd_take(self._h, k, *(p.ctypes.data for p in planes))
        return planes


class Decoder:
    """The host decoder behind FFmpeg's handling of packets (`Timeline`):
    packets in (`push`: the headers, or a sample as the container holds it),
    pictures out as (Y', Cb, Cr) uint8 planes in the order and number cv2
    shows them (`pictures`, then `flush` at the stream's end).  A corrupt
    unit raises ValueError and one outside the decoder's subset
    `UnsupportedCodecError` naming the tool; after either the decoder is
    spent."""

    def __init__(self, tag: bytes = b""):
        self.host = Host(tag)
        self.timeline = Timeline()
        self._out: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def push(self, unit: bytes) -> None:
        step = self.timeline.packet(bytes(unit))
        try:
            status = self.host.push(step.data)
        except (ValueError, container.UnsupportedCodecError):
            # a unit that fails after its VOP (a VOL of another size behind
            # it) still shows the picture decoded
            if self.host.status() == step.status != NONE:
                self._out += [self.host.take(w) for w, _ in step.shown]
            raise
        if status != step.status:
            raise ValueError(f"MPEG-4 Part 2: the decoder did {status}, the packet's headers "
                             f"say {step.status}")
        self._out += [self.host.take(w) for w, _ in step.shown]

    def flush(self) -> None:
        """The pictures FFmpeg shows after the last packet."""
        self._out += [self.host.take(w) for w, _ in self.timeline.flush()]

    def pictures(self) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The pictures shown so far and not yet taken, in order."""
        out, self._out = self._out, []
        return out


def start_codes(data: bytes) -> list[tuple[int, bytes]]:
    """(start code value, the bytes up to the next start code) of each start
    code (00 00 01 xx) in data."""
    starts = []
    at = data.find(b"\x00\x00\x01")
    while 0 <= at < len(data) - 3:
        starts.append(at)
        at = data.find(b"\x00\x00\x01", at + 3)
    ends = starts[1:] + [len(data)]
    return [(data[s + 3], data[s + 4:max(e, s + 4)]) for s, e in zip(starts, ends)]


def split_stream(data: bytes) -> list[bytes]:
    """A raw stream (`.m4v`: the headers, then VOPs) cut into packets as
    FFmpeg's mpeg4video parser cuts it (`ff_mpeg4_find_frame_end`): a packet
    ends at the first start code after its VOP (but user data's 0xB7 and
    0xB8), so headers, GOV and user data go with the VOP after them."""
    cuts, found = [0], False
    at = data.find(b"\x00\x00\x01")
    while 0 <= at < len(data) - 3:
        code = data[at + 3]
        if not found:
            found = code == 0xB6
        elif code not in (0xB7, 0xB8):
            cuts.append(at)
            found = code == 0xB6
        at = data.find(b"\x00\x00\x01", at + 3)
    cuts.append(len(data))
    return [data[a:b] for a, b in zip(cuts, cuts[1:]) if b > a]


def decode_stream(data: bytes) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Every picture of a raw MPEG-4 Part 2 stream (`.m4v`: the headers, then
    VOPs), through the host decoder, as cv2 shows them: cut into packets as
    FFmpeg's parser cuts it (`split_stream`), in display order."""
    first = data.find(VOP)
    later_vols(data[first:], parse_headers(data), "the stream")
    dec = Decoder()
    pictures = []
    for unit in split_stream(data):
        dec.push(unit)
        pictures += dec.pictures()
    dec.flush()
    return pictures + dec.pictures()


class _Reader:
    """Bits of a header, read MSB first."""

    def __init__(self, data: bytes, what: str):
        self.v, self.n, self.pos, self.what = int.from_bytes(data, "big"), 8 * len(data), 0, what

    def u(self, n: int) -> int:
        if self.pos + n > self.n:
            raise ValueError(f"MPEG-4 Part 2: the {self.what} is cut short")
        self.pos += n
        return (self.v >> (self.n - self.pos)) & ((1 << n) - 1)

    def marker(self) -> None:
        if not self.u(1):
            raise ValueError(f"MPEG-4 Part 2: a marker bit of the {self.what} is 0")


def _vol(r: _Reader, out: dict) -> None:
    """The fields of a VOL header (6.2.3) that the readers need; what the
    decoder does not read raises `UnsupportedCodecError`."""
    r.u(1)
    out["object_type"] = r.u(8)
    verid = 1
    if r.u(1):
        verid = r.u(4)
        r.u(3)
    if r.u(4) == 15:
        r.u(16)
    out["low_delay"] = 0
    out["vol_control"] = r.u(1)
    if out["vol_control"]:
        chroma = r.u(2)
        if chroma != 1:
            raise _unsupported(f"MPEG-4 Part 2 chroma_format {chroma} (only 4:2:0)")
        out["low_delay"] = r.u(1)
        if r.u(1):
            for n in (15, 15, 15):
                r.u(n)
                r.marker()
            r.u(3)
            r.u(11)
            r.marker()
            r.u(15)
            r.marker()
    shape = r.u(2)
    if shape:
        raise _unsupported("MPEG-4 Part 2 video_object_layer_shape "
                           f"{('binary', 'binary only', 'grayscale')[shape - 1]} "
                           "(only rectangular)")
    r.marker()
    res = r.u(16)
    if res == 0:
        raise ValueError("MPEG-4 Part 2: vop_time_increment_resolution 0")
    r.marker()
    bits = max(1, (res - 1).bit_length())
    out["time_resolution"], out["time_bits"] = res, bits
    out["fixed_increment"] = r.u(bits) if r.u(1) else 0
    r.marker()
    out["width"] = r.u(13)
    r.marker()
    out["height"] = r.u(13)
    r.marker()
    if not out["width"] or not out["height"]:
        raise ValueError("MPEG-4 Part 2: a VOL of width or height 0")
    for name, refused in (("interlaced", r.u(1)), ("OBMC (obmc_disable 0)", not r.u(1)),
                          ("sprites and S(GMC)-VOPs (sprite_enable)", r.u(1 if verid == 1 else 2)),
                          ("not_8_bit (only 8-bit samples)", r.u(1))):
        if refused:
            raise _unsupported(f"MPEG-4 Part 2 {name}")
    out["quant_type"] = r.u(1)
    if out["quant_type"]:
        for _ in range(2):                       # load_intra / load_nonintra_quant_mat
            if r.u(1):
                for k in range(64):
                    if not r.u(8):
                        if k == 0:
                            raise ValueError("MPEG-4 Part 2: a loaded quantiser matrix that "
                                             "starts with 0")
                        break
    out["quarter_sample"] = verid != 1 and r.u(1)
    if not r.u(1):
        raise _unsupported("MPEG-4 Part 2 complexity_estimation")
    out["resync_markers"] = not r.u(1)
    if r.u(1):
        raise _unsupported("MPEG-4 Part 2 data_partitioned (and reversible_vlc)")
    if verid != 1:
        if r.u(1):
            raise _unsupported("MPEG-4 Part 2 newpred")
        if r.u(1):
            raise _unsupported("MPEG-4 Part 2 reduced_resolution_vop")
    if r.u(1):
        raise _unsupported("MPEG-4 Part 2 scalability")


def stamp(text: str) -> dict:
    """What FFmpeg's decode_user_data reads from a user data string: the
    DivX version, build and packed flag ("DivX503b1393p"), the libavcodec
    build ("Lavc62.28.101": its three numbers a byte each; "FFmpeg..."),
    the Xvid build ("XviD0064"); only the keys the string gives."""
    text = text.split("\0")[0][:255]
    out: dict = {}
    m = (re.match(r"DivX\s*([+-]?\d+)Build\s*([+-]?\d+)(.)?", text, re.S)
         or re.match(r"DivX\s*([+-]?\d+)b\s*([+-]?\d+)(.)?", text, re.S))
    if m:
        out["divx_version"], out["divx_build"] = int(m[1]), int(m[2])
        out["packed"] = m[3] == "p"
    m = (re.match(r"FFmpe[^b]+b\s*([+-]?\d+)", text)
         or re.match(r"FFmpeg v\s*[+-]?\d+\.\s*[+-]?\d+\.\s*[+-]?\d+ / libavcodec build:"
                     r"\s*([+-]?\d+)", text))
    if m:
        out["lavc_build"] = int(m[1])
    else:
        m = re.match(r"Lavc\s*([+-]?\d+)\.\s*([+-]?\d+)\.\s*([+-]?\d+)", text)
        if m:
            a, b, c = (int(x) & 0xFF for x in m.groups())
            out["lavc_build"] = a << 16 | b << 8 | c
        elif text == "ffmpeg":
            out["lavc_build"] = 4600
    m = re.match(r"XviD\s*([+-]?\d+)", text)
    if m:
        out["xvid_build"] = int(m[1])
    return out


def parse_headers(data: bytes) -> dict:
    """The VOS / VO / VOL headers before the first VOP of `data` (an esds's
    DecoderSpecificInfo, AVI extradata or the stream's start): profile, VOL
    size, time resolution and bits, `low_delay`, `vol_control`,
    `quant_type`, `quarter_sample`, `full_range`, `primaries`, `transfer` and
    `matrix` (the VO's video_signal_type; limited range and 2, unspecified,
    by default; `signal_type` and `colour_description` say which it has),
    the encoder's stamp (the first user data) and what the user data tells
    FFmpeg (`stamp`'s keys: `packed` for DivX's packed bitstream).  Raises
    `UnsupportedCodecError` for a tool outside the decoder, ValueError for a
    stream with no VOL header."""
    if len(data) >= 3 and data[:2] == b"\x00\x00" and data[2] & 0xFC == 0x80:
        raise _unsupported("H.263 short-header video (a short_video_start_marker stream)")
    out = {"profile": None, "full_range": False, "primaries": 2, "transfer": 2, "matrix": 2,
           "signal_type": False, "colour_description": False, "stamp": "", "packed": False}
    for code, body in start_codes(data):
        if code == 0xB0 and body:
            out["profile"] = body[0]
        elif code == 0xB5:
            r = _Reader(body, "visual object header")
            if r.u(1):
                r.u(7)
            if r.u(4) in (1, 2) and r.u(1):          # video_signal_type
                r.u(3)
                out["full_range"], out["signal_type"] = bool(r.u(1)), True
                if r.u(1):
                    out["primaries"], out["transfer"], out["matrix"] = r.u(8), r.u(8), r.u(8)
                    out["colour_description"] = True
        elif 0x20 <= code <= 0x2F and "width" not in out:
            _vol(_Reader(body, "VOL header"), out)
        elif code == 0xB2:
            text = body.decode("latin-1")
            out["stamp"] = out["stamp"] or text
            out.update(stamp(text))
        elif code == 0xB6:
            break
    if "width" not in out:
        raise ValueError("MPEG-4 Part 2: no VOL header before the first VOP")
    if out["quarter_sample"] and 0 <= out.get("lavc_build", -1) < 4653:
        # FFmpeg emulates these encoders' old quarter-sample filter
        # (FF_BUG_STD_QPEL); the decoder does not
        raise _unsupported("MPEG-4 Part 2 quarter_sample from an FFmpeg build whose "
                           "quarter-sample filter FFmpeg emulates as a bug (lavc build "
                           f"{out['lavc_build']})")
    return out


def later_vols(data: bytes, params: dict, where: str) -> None:
    """Each VOL header in `data`, which comes after the VOL `params` was read
    from (that one again passes): what the decoder does not read raises
    `UnsupportedCodecError` as in the first VOL, and so does another picture
    size (cv2 would scale every picture to the first size)."""
    for code, body in start_codes(data):
        if 0x20 <= code <= 0x2F:
            vol: dict = {}
            _vol(_Reader(body, f"VOL header ({where})"), vol)
            old, new = (params["width"], params["height"]), (vol["width"], vol["height"])
            if new != old:
                raise _unsupported("MPEG-4 Part 2 VOL that changes the picture size "
                                   f"({where}: %dx%d, then %dx%d)" % (old + new))


def vop_header(body: bytes, time_bits: int, where: str) -> tuple[str, bool, int, int]:
    """(coding type, vop_coded, modulo_time_base, vop_time_increment) of the
    VOP whose bytes after the start code are `body`; an S-VOP raises."""
    r = _Reader(body[:16], f"VOP header ({where})")
    kind = _VOP_KINDS[r.u(2)]
    if kind == "S":
        raise _unsupported(f"MPEG-4 Part 2 S-VOPs ({where}; sprites / global motion "
                           "compensation)")
    seconds = 0
    for _ in range(61):
        if not r.u(1):
            break
        seconds += 1
    r.marker()
    increment = r.u(time_bits)
    r.marker()
    return kind, bool(r.u(1)), seconds, increment


class Step(NamedTuple):
    """What FFmpeg's decoder does with one packet (`Timeline.packet`): the
    bytes it decodes (`data`; `source`: the packet they come from and their
    offset in it), what the decoder does with them (`status`), the pictures
    shown after it (("cur" | "fwd" | "bwd", the packet the picture was
    decoded at), in order), `kind` of the VOP decoded and `refs`, the packets
    of the references it predicts from."""
    data: bytes
    source: tuple[int, int]
    status: int
    shown: list
    kind: str
    refs: tuple


class Timeline:
    """FFmpeg's MPEG-4 Part 2 decoding (h263dec.c, mpeg4videodec.c) at the
    level of packets and pictures, from the headers alone: which bytes each
    packet decodes (DivX's packed bitstream keeps a sample's second VOP, a
    B- or I-VOP, and decodes it in place of the next packet, the placeholder
    whose bytes are then not read; a VOS start code drops it), the VOP
    times (modulo_time_base and vop_time_increment against the last time
    base, GOV time codes; a B-VOP whose TRB is not within (0, TRD) is
    skipped), `low_delay` (the VOL's flag, or 1 for a Simple or Advanced
    Simple VOL without vol_control_parameters, then cleared by a B-VOP) and
    what is shown: a B-VOP at once (one with no past reference is skipped);
    an I- or P-VOP at once where low_delay is 1, else the reference before
    it (a P-VOP with none shows FFmpeg's grey dummy picture); a VOP not
    coded shows nothing; at the end (`flush`) the last reference, where
    low_delay is 0 or the stream ended in a VOP not coded.  `Decoder` feeds
    it the packets it decodes; a reader runs it over a file's headers to
    number and place the frames."""

    def __init__(self):
        self.params: dict = {}
        self.low_delay, self.packed, self.pictures = 0, False, 0
        self.time_base = self.last_time_base = self.last_non_b = 0
        self.pp = self.pb = 0
        self.last = self.next = None                  # the packet each reference came from
        self.skipped_last = False
        self.buffer: tuple[bytes, tuple[int, int]] | None = None
        self.count = 0                                # packets so far

    def headers(self, data: bytes) -> int:
        """Read the headers before the first VOP of `data` (a packet, or the
        container's extradata, which FFmpeg reads first); the VOP's offset,
        or -1."""
        at = data.find(VOP)
        head = data if at < 0 else data[:at]
        for code, body in start_codes(head):
            if 0x20 <= code <= 0x2F:
                vol: dict = {}
                _vol(_Reader(body, "VOL header"), vol)
                self.params.update(vol)
                if vol["vol_control"]:
                    self.low_delay = vol["low_delay"]
                elif self.pictures == 0:
                    self.low_delay = int(vol["object_type"] in (1, 17))
            elif code == 0xB2:
                info = stamp(body.decode("latin-1"))
                if "divx_version" in info:
                    self.packed = info["packed"]
                self.params.update({k: v for k, v in info.items() if k != "packed"})
            elif code == 0xB3 and len(body) >= 3:
                r = _Reader(body, "GOV header")
                hours, minutes = r.u(5), r.u(6)
                r.u(1)
                self.time_base = r.u(6) + 60 * (minutes + 60 * hours)
        return at

    def packet(self, pkt: bytes) -> Step:
        """What FFmpeg's decoder does with the next packet."""
        k, self.count = self.count, self.count + 1
        if self.packed and self.buffer is not None:
            first = pkt.find(b"\x00\x00\x01")
            if 0 <= first < len(pkt) - 3 and pkt[first + 3] == 0xB0:
                self.buffer = None
        if self.buffer is not None:
            (data, source), from_buffer = self.buffer, True
        else:
            data, source, from_buffer = pkt, (k, 0), False
        self.buffer = None
        at = self.headers(data)
        if at < 0 or "time_bits" not in self.params:
            return Step(data, source, NONE, [], "", ())
        kind, coded, seconds, increment = vop_header(data[at + 4:], self.params["time_bits"],
                                                     f"packet {k}")
        if kind == "B" and self.low_delay and not self.params.get("vol_control"):
            self.low_delay = 0
        self.skipped_last = False
        res = self.params["time_resolution"]
        if kind != "B":
            self.last_time_base = self.time_base
            self.time_base += seconds
            t = self.time_base * res + increment
            self.pp, self.last_non_b = (t - self.last_non_b) & 0xFFFF, t
        else:
            t = (self.last_time_base + seconds) * res + increment
            self.pb = (self.pp - (self.last_non_b - t)) & 0xFFFF
            if self.pp <= self.pb or self.pp <= self.pp - self.pb or self.pp <= 0:
                return Step(data, source, B_SKIPPED, [], kind, ())
        if not coded:
            self.skipped_last = True
            return Step(data, source, NOT_CODED, [], kind, ())
        if (self.params.get("object_type") == 0 and not self.params.get("vol_control")
                and "divx_version" not in self.params and self.pictures == 0):
            self.low_delay = 1
        self.pictures += 1
        if kind == "B":
            if self.last is None:
                return Step(data, source, B_SKIPPED, [], kind, ())
            refs, shown = (self.last, self.next), [("cur", k)]
            status = BIDIR
        else:
            refs = () if kind == "I" else (self.next if self.next is not None else -1,)
            self.last, self.next = self.next, k
            if self.last is None and kind == "P":
                self.last = -1                         # FFmpeg's grey dummy picture
            shown = [("cur", k)] if self.low_delay else (
                [("fwd", self.last)] if self.last is not None else [])
            status = REF
        if self.packed:
            pos = 0
            if not from_buffer:
                end = pkt.find(b"\x00\x00\x01", at + 4)
                end = len(pkt) if end < 0 else end
                while end > at + 4 and pkt[end - 1] == 0:
                    end -= 1
                pos = end - 1
            if len(pkt) - pos > 7:
                i = pkt.find(VOP, pos)
                if 0 <= i < len(pkt) - 4 and not pkt[i + 4] & 0x40:
                    self.buffer = (pkt[i:], (k, i))
        return Step(data, source, status, shown, kind, refs)

    def flush(self) -> list[tuple[str, int]]:
        """The pictures shown after the last packet: the future reference,
        where low_delay is 0 (it is not shown yet) or the stream ended in a
        VOP not coded (it is shown again)."""
        out = []
        if (not self.low_delay or self.skipped_last) and self.next is not None:
            out.append(("bwd", self.next))
            self.next = None
        return out


class MPEG4Frames(Sequence):
    """The frames of an MPEG-4 Part 2 file (MP4, AVI, Matroska, MPEG-TS) as
    (H, W, 3) uint8 RGB, decoded by the host decoder on access (`frames[i]`,
    `len(frames)`, iteration), as cv2 shows them: in FFmpeg's order and
    number (`Timeline`: B-VOPs reordered, DivX's packed samples unpacked, a
    VOP not coded showing nothing, the last picture again where the stream
    ends in one), only those an MP4 edit list keeps, converted with the VO's
    range and matrix (where the VO has no colour description, a `colr`
    box's, as FFmpeg takes them) through `h264.ycbcr_to_rgb` (swscale's own
    conversion, bit for bit).  Every sample's headers are read when the file
    is opened, so that an S-VOP or a tool outside the decoder is refused
    before any decode.  A frame is decoded from the last I-VOP its picture
    and its references go back to (or from the first VOP: a stream that
    starts at a P-VOP, a capture cut mid-GOP, predicts it from FFmpeg's grey
    dummy picture), or on from the last one decoded; pictures shown later
    than decoded are kept until shown."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        self.path, self.offsets, self.sizes, self.info = path, offsets, sizes, info
        self.headers = info.get("dsi") or b""
        self.tag = info.get("fourcc", b"")
        timeline = Timeline()
        timeline.headers(self.headers)
        self.sources, kinds, roots, gov = [], {}, {}, []
        shown: list[int] = []
        with open(path, "rb") as f:
            for i, (o, s) in enumerate(zip(offsets, sizes)):
                data = container.read_sample(f, o, s, info)
                at = data.find(VOP)
                if i == 0:
                    # AVI keeps the headers before the first VOP: every
                    # decode, wherever it starts, is given them first
                    self.headers += data[:max(at, 0)]
                    self.params = parse_headers(self.headers)
                if at >= 0:
                    later_vols(data, self.params, f"{path}: frame {i}")
                try:
                    step = timeline.packet(data)
                except ValueError as e:
                    raise ValueError(f"{path}: frame {i}: {e}") from None
                if step.source == (i, 0) and at < 0:
                    raise ValueError(f"{path}: frame {i} holds no VOP")
                self.sources.append(step.source)
                gov.append(step.source == (i, 0) and 0 <= data.find(b"\x00\x00\x01\xb3") < at)
                if step.status in (REF, BIDIR):
                    kinds[i] = step.kind
                    roots[i] = i if step.kind == "I" else (
                        0 if step.refs[0] == -1 else roots[step.refs[0]])
                shown += [p for _, p in step.shown]
        if not offsets:
            if not self.headers:
                raise ValueError(f"{path}: no frames")
            # no frame, but the container's headers (a Matroska file cut
            # before its first frame): cv2 opens it and reads nothing
            self.params = parse_headers(self.headers)
        shown += [p for _, p in timeline.flush()]
        keep = info.get("shown")
        self.pictures = [shown[k] for k in keep if k < len(shown)] if keep else shown
        self.colour = colour.stream(colour.from_container(self.params, info.get("colr")))
        # a decode may start at packet 0, or at a coded I-VOP decoded from its
        # own packet whose time base no later GOV moves (one of its own, or
        # none after it)
        later_gov = [False] * (len(offsets) + 1)
        for i in range(len(offsets) - 1, -1, -1):
            later_gov[i] = later_gov[i + 1] or gov[i]
        self.starts = sorted({i for i, k in kinds.items() if k == "I" and
                              self.sources[i] == (i, 0) and (gov[i] or not later_gov[i + 1])}
                             | ({0} if offsets else set()))
        self.roots = roots
        self.last_shown = {p: k for k, p in enumerate(self.pictures)}
        self._decoder: Host | None = None
        self._since = self._next = 0                  # the decode's start, the next packet
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
        if p == -1:                                   # the dummy a stream cut mid-GOP shows
            return self._dummy()
        root = self.roots[p]
        if self._decoder is None or p < self._next or root < self._since:
            start = self.starts[bisect.bisect_right(self.starts, root) - 1]
            self._decoder, self._since, self._next = Host(self.tag), start, start
            self._held = {}
            if self.headers:
                self._push(self.headers, "the headers")
        while self._next <= p:
            k = self._next
            container.check_whole(self.path, self.info, k)
            j, off = self.sources[k]
            self._next += 1
            if (self._push(self.sample(j)[off:], f"frame {k}") in (REF, BIDIR)
                    and self.last_shown.get(k, -1) >= i):
                self._held[k] = self._decoder.take("cur")
        self._held = {q: v for q, v in self._held.items() if self.last_shown[q] >= i}
        return self._held[p]

    def _push(self, data: bytes, where: str) -> int:
        try:
            return self._decoder.push(data)
        except ValueError as e:
            self._decoder = None
            raise ValueError(f"{self.path}: {where}: {e}") from None
        except container.UnsupportedCodecError as e:
            self._decoder = None
            raise type(e)(f"{self.path}: {where}: {e}") from None

    def _dummy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        w, h = self.params["width"], self.params["height"]
        cw, ch = (w + 1) // 2, (h + 1) // 2
        return (np.full((h, w), 128, np.uint8), np.full((ch, cw), 128, np.uint8),
                np.full((ch, cw), 128, np.uint8))

    def __getitem__(self, i: int) -> np.ndarray:
        rgb = ycbcr_to_rgb(*self.ycbcr(i), **self.colour)
        return np.ascontiguousarray(np.rot90(rgb, -self.info.get("rotation", 0) // 90))

    rgb = __getitem__

    def probe(self) -> dict:
        """{"width", "height", "fps", "frame_count"} as cv2 reports them, with
        no decode: the VOL's size (turned by the container's display
        rotation), the container's rate (else the VOL's fixed rate, else
        30.0) and the container's count of samples (an AVI's dropped and
        placeholder chunks among them)."""
        p = self.params
        fps = self.info["fps"] or (p["time_resolution"] / p["fixed_increment"]
                                   if p["fixed_increment"] else 30.0)
        w, h = p["width"], p["height"]
        if self.info.get("rotation", 0) in (90, 270):
            w, h = h, w
        return {"width": w, "height": h, "fps": fps, "frame_count": self.info["frame_count"]}

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]


def frames(path) -> MPEG4Frames:
    """The frames of an MPEG-4 Part 2 file, decoded on access by the host
    decoder; headers outside its subset raise."""
    offsets, sizes, info = container.index(path)
    if info["codec"] != "mpeg4":
        raise ValueError(f"{path}: its video is not MPEG-4 Part 2")
    return MPEG4Frames(Path(path), offsets, sizes, info)
