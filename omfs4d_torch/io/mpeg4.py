"""MPEG-4 Part 2 (ISO/IEC 14496-2) Simple profile read on the host: the video
cv2's `mp4v`, `XVID`, `DIVX` and `FMP4` writers (FFmpeg's mpeg4 encoder)
put in MP4 and AVI files, and so the JAX package's own fallback output
(`omfs4d.io.video.stitch_video` where cv2 has no H.264 encoder), for a
machine with no ffmpeg and no cv2.

The decoder is the host C++ `mpeg4dec.cpp` (`Decoder`), built by g++ at
first use into `omfs4d_torch/_build/` (no Python fallback: without g++
reading raises with the reason) and bound with ctypes; its tables come from
`mpeg4_tables.py`.  It decodes 8-bit 4:2:0 rectangular I- and P-VOPs of any
size: not-coded MBs, 1MV and 4MV, intra MBs in P-VOPs, f_code 1-7,
unrestricted half-sample vectors with both rounding types, DC / AC
prediction, the three TCOEF escapes, dquant, video packets with HEC, and
the simple integer IDCT that FFmpeg picks for every stream but Xvid's (its
samples are FFmpeg's bit for bit; an Xvid-stamped stream differs from
cv2's by the two IDCTs' rounding, which motion carries from frame to
frame: mostly a few grey levels, a rare sample by tens).

`parse_headers` reads the VOS / VO / VOL headers in Python and refuses what
the decoder does not read by name, as `container.UnsupportedCodecError`,
before any decode: B-VOPs and S-VOPs (sprites, GMC), MPEG quantisation
(`quant_type` 1), quarter-sample, interlaced, data partitioning and
reversible VLCs, a shape other than rectangular, more than 8 bits,
scalability, complexity estimation, NEWPRED, reduced-resolution VOPs, OBMC,
short-header H.263 and DivX packed bitstreams (two VOPs in a sample);
`later_vols` refuses the same in a VOL after the first VOP, and a change of
the picture size there.

`MPEG4Frames` shows a file's frames as cv2 does: one a sample, in order
(`low_delay`: no reordering), converted with the VO's range, matrix,
primaries and transfer (where the VO has no colour description, a `colr`
box's, as FFmpeg takes them) through `h264.ycbcr_to_rgb` (swscale's own
conversion, bit for bit: its unscaled path at an even height, its scaled
path, chroma sited left, at an odd one), a frame decoded from the last I-VOP
at or before it or on from the last one decoded.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
import re
from collections.abc import Iterator, Sequence
from pathlib import Path

import numpy as np

from omfs4d_torch.io import colour, container, mpeg4_tables
from omfs4d_torch.io.h264 import ycbcr_to_rgb

_SOURCE = Path(__file__).resolve().with_name("mpeg4dec.cpp")
_GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

VOP = b"\x00\x00\x01\xb6"
_VOP_KINDS = ("I", "P", "B", "S")


def _unsupported(what: str) -> container.UnsupportedCodecError:
    return container.UnsupportedCodecError(
        f"{what} needs ffmpeg: the port decodes MPEG-4 Part 2 Simple profile (8-bit 4:2:0 "
        "rectangular I- and P-VOPs, H.263 quantisation, half-sample vectors) by itself; "
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
    lib.m4vd_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.m4vd_ready.argtypes = [ctypes.c_void_p]
    lib.m4vd_frame_size.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.m4vd_pop.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.m4vd_error.restype = ctypes.c_char_p
    lib.m4vd_error.argtypes = [ctypes.c_void_p]
    return lib


class Decoder:
    """The host C++ decoder (`mpeg4dec.cpp`): units in (`push`: the headers,
    or a sample holding at most one VOP), pictures out as (Y', Cb, Cr) uint8
    planes in order (`pictures`; chroma of half the size, rounded up).  A
    corrupt unit raises ValueError and one outside the decoder's subset
    `UnsupportedCodecError` naming the tool; after either the decoder is
    spent."""

    def __init__(self):
        self._lib = _library()
        self._h = self._lib.m4vd_new()
        if not self._h:
            raise MemoryError("MPEG-4 Part 2: the decoder could not be created")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.m4vd_free(self._h)
            self._h = None

    def push(self, unit: bytes) -> None:
        """Start codes and their data: VOS / VO / VOL headers, GOV and user
        data (skipped), at most one VOP."""
        rc = self._lib.m4vd_push(self._h, bytes(unit), len(unit))
        if rc:
            msg = self._lib.m4vd_error(self._h).decode("utf-8", "replace")
            raise _unsupported(msg) if rc == 2 else ValueError(msg)

    def pictures(self) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The pictures decoded so far and not yet taken, in order."""
        out = []
        w, h = ctypes.c_int32(), ctypes.c_int32()
        while self._lib.m4vd_ready(self._h):
            self._lib.m4vd_frame_size(self._h, ctypes.byref(w), ctypes.byref(h))
            cw, ch = (w.value + 1) // 2, (h.value + 1) // 2
            planes = (np.empty((h.value, w.value), np.uint8), np.empty((ch, cw), np.uint8),
                      np.empty((ch, cw), np.uint8))
            self._lib.m4vd_pop(self._h, *(p.ctypes.data for p in planes))
            out.append(planes)
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


def shown(coded: list[bool]) -> list[int]:
    """The VOP each frame cv2 shows comes from, given whether each VOP is
    coded: a VOP that is not coded shows nothing, but a stream that ends in
    one shows its last picture once more, as FFmpeg does."""
    out = [i for i, c in enumerate(coded) if c]
    return out + out[-1:] if out and not coded[-1] else out


def decode_stream(data: bytes) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Every picture of a raw MPEG-4 Part 2 stream (`.m4v`: the headers, then
    VOPs), through the host decoder, as cv2 shows them (`shown`); each VOP is
    pushed with the headers before it."""
    cuts = [m.start() for m in re.finditer(re.escape(VOP), data)] + [len(data)]
    later_vols(data[cuts[0]:], parse_headers(data), "the stream")
    dec = Decoder()
    pictures = []
    for k in range(len(cuts) - 1):
        dec.push(data[cuts[k] if k else 0:cuts[k + 1]])
        pictures.append((dec.pictures() or [None])[-1])
    return [pictures[k] for k in shown([p is not None for p in pictures])]


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
    if r.u(1):
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
                          ("not_8_bit (only 8-bit samples)", r.u(1)),
                          ("quant_type 1 (MPEG quantisation matrices)", r.u(1)),
                          ("quarter_sample", verid != 1 and r.u(1)),
                          ("complexity_estimation", not r.u(1))):
        if refused:
            raise _unsupported(f"MPEG-4 Part 2 {name}")
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


def parse_headers(data: bytes) -> dict:
    """The VOS / VO / VOL headers before the first VOP of `data` (an esds's
    DecoderSpecificInfo, AVI extradata or the stream's start): profile, VOL
    size, time resolution and bits, `full_range`, `primaries`, `transfer` and
    `matrix` (the VO's video_signal_type; limited range and 2, unspecified,
    by default; `signal_type` and `colour_description` say which it has) and
    the encoder's stamp (user data).  Raises
    `UnsupportedCodecError` for a tool outside the decoder, ValueError for a
    stream with no VOL header."""
    if len(data) >= 3 and data[:2] == b"\x00\x00" and data[2] & 0xFC == 0x80:
        raise _unsupported("H.263 short-header video (a short_video_start_marker stream)")
    out = {"profile": None, "full_range": False, "primaries": 2, "transfer": 2, "matrix": 2,
           "signal_type": False, "colour_description": False, "stamp": ""}
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
            stamp = body.decode("latin-1")
            out["stamp"] = out["stamp"] or stamp
            if re.match(r"DivX\d+b\d+p", stamp):
                raise _unsupported("MPEG-4 Part 2 packed bitstream (DivX's B-VOPs packed two "
                                   f"VOPs to a sample, user data {stamp!r})")
        elif code == 0xB6:
            break
    if "width" not in out:
        raise ValueError("MPEG-4 Part 2: no VOL header before the first VOP")
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


def vop_header(body: bytes, time_bits: int, where: str) -> tuple[str, bool]:
    """(coding type, vop_coded) of the VOP whose bytes after the start code
    are `body`; B- and S-VOPs raise."""
    r = _Reader(body[:16], f"VOP header ({where})")
    kind = _VOP_KINDS[r.u(2)]
    if kind == "B":
        raise _unsupported(f"MPEG-4 Part 2 B-VOPs ({where}; bidirectional prediction, beyond "
                           "Simple profile)")
    if kind == "S":
        raise _unsupported(f"MPEG-4 Part 2 S-VOPs ({where}; sprites / global motion "
                           "compensation)")
    for _ in range(61):
        if not r.u(1):
            break
    r.marker()
    r.u(time_bits)
    r.marker()
    return kind, bool(r.u(1))


class MPEG4Frames(Sequence):
    """The frames of an MPEG-4 Part 2 MP4 or AVI file as (H, W, 3) uint8 RGB,
    decoded by the host decoder on access (`frames[i]`, `len(frames)`,
    iteration), as cv2 shows them: in order, converted with the VO's range
    and matrix, one a coded VOP; a VOP that is not coded (`vop_coded` 0)
    shows nothing, but a stream that ends in one shows its last picture once
    more, as FFmpeg does.  Every sample's VOP header is read when the file is
    opened, so that a B- or S-VOP or a packed sample is refused before any
    decode; a frame is decoded from the last I-VOP at or before it (or from
    the first VOP: a stream that starts at a P-VOP, a capture cut mid-GOP,
    predicts it from FFmpeg's grey dummy picture), or on from the last one
    decoded."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        self.path, self.offsets, self.sizes, self.info = path, offsets, sizes, info
        self.headers = info.get("dsi") or b""
        kinds, coded = [], []
        with open(path, "rb") as f:
            for i, (o, s) in enumerate(zip(offsets, sizes)):
                data = container.read_sample(f, o, s, info)
                at = data.find(VOP)
                if i == 0:
                    # AVI keeps the headers before the first VOP: every
                    # decode, wherever it starts, is given them first
                    self.headers += data[:max(at, 0)]
                    self.params = parse_headers(self.headers)
                if at < 0:
                    raise ValueError(f"{path}: frame {i} holds no VOP")
                later_vols(data, self.params, f"{path}: frame {i}")
                if data.find(VOP, at + 4) >= 0:
                    raise _unsupported(f"MPEG-4 Part 2 packed bitstream ({path}: frame {i} holds "
                                       "two VOPs, as DivX packs B-VOPs)")
                kind, is_coded = vop_header(data[at + 4:], self.params["time_bits"],
                                            f"{path}: frame {i}")
                kinds.append(kind)
                coded.append(is_coded)
        if not offsets:
            if not self.headers:
                raise ValueError(f"{path}: no frames")
            # no frame, but the container's headers (a Matroska file cut
            # before its first frame): cv2 opens it and reads nothing
            self.params = parse_headers(self.headers)
        self.colour = colour.stream(colour.from_container(self.params, info.get("colr")))
        self.shown = shown(coded)                # the sample each frame comes from
        # a decode may start at a coded I-VOP, or at the first VOP: a P-VOP
        # first predicts from grey, as FFmpeg's dummy picture
        self.starts = sorted({i for i, (k, c) in enumerate(zip(kinds, coded)) if k == "I" and c}
                             | ({0} if offsets else set()))
        self._decoder: Decoder | None = None
        self._next = 0                           # the next sample to push
        self._last: tuple[int, tuple[np.ndarray, ...]] | None = None

    def __len__(self) -> int:
        return len(self.shown)

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
        s = self.shown[i % n]
        if self._last is not None and self._last[0] == s:
            return self._last[1]
        k = bisect.bisect_right(self.starts, s) - 1
        if k < 0:
            raise ValueError(f"{self.path}: frame {i} follows no I-VOP")
        if self._decoder is None or s < self._next or self.starts[k] >= self._next:
            self._decoder = Decoder()
            if self.headers:
                self._decode(self.headers, "the headers")
            self._next = self.starts[k]
        while self._next <= s:
            container.check_whole(self.path, self.info, self._next)
            planes = self._decode(self.sample(self._next), f"frame {self._next}")
            if planes:
                self._last = (self._next, planes[-1])
            self._next += 1
        return self._last[1]

    def _decode(self, data: bytes, where: str) -> list:
        try:
            self._decoder.push(data)
        except ValueError as e:
            self._decoder = None
            raise ValueError(f"{self.path}: {where}: {e}") from None
        except container.UnsupportedCodecError as e:
            self._decoder = None
            raise type(e)(f"{self.path}: {where}: {e}") from None
        return self._decoder.pictures()

    def __getitem__(self, i: int) -> np.ndarray:
        rgb = ycbcr_to_rgb(*self.ycbcr(i), **self.colour)
        return np.ascontiguousarray(np.rot90(rgb, -self.info.get("rotation", 0) // 90))

    rgb = __getitem__

    def probe(self) -> dict:
        """{"width", "height", "fps", "frame_count"} as cv2 reports them, with
        no decode: the VOL's size (turned by the container's display
        rotation), the container's rate (else the VOL's fixed rate, else
        30.0) and the count of samples."""
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
    """The frames of an MPEG-4 Part 2 MP4 or AVI file, decoded on access by
    the host decoder; headers outside its subset raise."""
    offsets, sizes, info = container.index(path)
    if info["codec"] != "mpeg4":
        raise ValueError(f"{path}: its video is not MPEG-4 Part 2")
    return MPEG4Frames(Path(path), offsets, sizes, info)
