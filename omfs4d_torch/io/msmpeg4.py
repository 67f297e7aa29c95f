"""Microsoft's MPEG-4 family read on the host: MS MPEG-4 v2 (`MP42`), v3
(`MP43`, DivX 3 and its relabellings `DIV3`, `DIV4`, ...) and Windows Media
Video 7 and 8 (`WMV1`, `WMV2`), as cv2's writers put them in ASF (`.wmv`,
`.asf`), AVI and Matroska and as a decade of Windows capture carts, Windows
Movie Maker and DivX 3 archives wrote them, for a machine with no ffmpeg
and no cv2.

The decoder is the host C++ `msmpeg4dec.cpp` (`Host`), built by g++ at
first use into `omfs4d_torch/_build/` (no Python fallback: without g++
reading raises with the reason) and bound with ctypes; its tables come from
`msmpeg4_tables.py`.  It decodes the four versions as FFmpeg's msmpeg4v2,
msmpeg4v3, wmv1 and wmv2 decoders do (`msmpeg4dec.cpp` lists the tools);
its samples are FFmpeg's bit for bit.

`picture_type` reads a packet's first bits without a decoder: I or P, and
for WMV2 whether FFmpeg skips the packet whole (a P picture whose skip map
skips every MB: no frame) and whether an I picture is IntraX8 (refused by
name).  `MSMPEG4Frames` shows a file's frames as cv2 does: one a packet, in
the file's order (there are no B pictures), but none for a packet FFmpeg
skips or for an empty one, converted as FFmpeg tags them (no colour
description: BT.601, limited range, chroma centred) through
`h264.ycbcr_to_rgb`.  Each is
decoded on from the last I picture before it; a WMV2 file's pictures
before its first I picture (a capture cut after one) are decoded, as FFmpeg
decodes them, from its grey picture on.
Refused by name (`UnsupportedCodecError`): WMV2's IntraX8 pictures, WMV2
with no 4-byte extended header in its extradata, and a v2 / v3 / WMV1
stream whose first picture is a P picture (FFmpeg has no slice height
before an I picture and shows its error concealment; WMV2's comes from its
extradata, and its P pictures before the first I one are followed).
"""

from __future__ import annotations

import bisect
import ctypes
import functools
from collections.abc import Iterator, Sequence
from pathlib import Path

import numpy as np

from omfs4d_torch.io import container, msmpeg4_tables, swscale
from omfs4d_torch.io.h264 import ycbcr_to_rgb

_SOURCE = Path(__file__).resolve().with_name("msmpeg4dec.cpp")
_GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

# the decoder's versions (msd_init) and their names
V2, V3, WMV1, WMV2 = 2, 3, 4, 5
NAMES = {V2: "MS MPEG-4 v2", V3: "MS MPEG-4 v3", WMV1: "WMV1 (WMV 7)", WMV2: "WMV2 (WMV 8)"}
# what a packet is (picture_type)
I, P, SKIPPED = "I", "P", "skipped"


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use, with g++, into `omfs4d_torch/_build/`) and load
    the host decoder; raises RuntimeError with g++'s message when it cannot:
    no frame is decoded in Python on the reading path."""
    from omfs4d_torch import native

    here = Path(__file__).resolve().parent
    path = native.build(_SOURCE, "msmpeg4dec", _GXX_FLAGS,
                        "omfs4d_torch/io/msmpeg4dec.cpp (the MS MPEG-4 / WMV decoder)",
                        headers={"msmpeg4_tables.h": msmpeg4_tables.cpp_header(),
                                 **{h: (here / h).read_text()
                                    for h in ("simple_idct.h", "hpel_mc.h")}})
    lib = ctypes.CDLL(str(path))
    lib.msd_new.restype = ctypes.c_void_p
    lib.msd_new.argtypes = []
    lib.msd_free.restype = None
    lib.msd_free.argtypes = [ctypes.c_void_p]
    lib.msd_init.restype = ctypes.c_int
    lib.msd_init.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_char_p, ctypes.c_int]
    lib.msd_decode.restype = ctypes.c_int
    lib.msd_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.msd_take.restype = ctypes.c_int
    lib.msd_take.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.msd_error.restype = ctypes.c_char_p
    lib.msd_error.argtypes = [ctypes.c_void_p]
    return lib


def _unsupported(what: str) -> container.UnsupportedCodecError:
    return container.UnsupportedCodecError(
        f"{what}; decoding this as cv2 shows it needs an ffmpeg binary (on PATH or from "
        "imageio_ffmpeg)")


class Host:
    """The host C++ decoder (`msmpeg4dec.cpp`) itself, for one stream of a
    version and size: a packet in (`decode`: True where it made a picture,
    False where FFmpeg skips it), the last picture out (`take`) as (Y', Cb,
    Cr) uint8 planes (chroma of half the size, rounded up).  A packet the
    decoder cannot finish raises ValueError (a tool it does not decode:
    UnsupportedCodecError), after which the decoder is spent."""

    def __init__(self, version: int, width: int, height: int, extradata: bytes = b""):
        self._lib = _library()
        self._h = self._lib.msd_new()
        if not self._h:
            raise MemoryError("MS MPEG-4: the decoder could not be created")
        self.width, self.height = width, height
        self._check(self._lib.msd_init(self._h, version, width, height, bytes(extradata),
                                       len(extradata)))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.msd_free(self._h)
            self._h = None

    def _check(self, rc: int) -> int:
        if rc < 0:
            msg = self._lib.msd_error(self._h).decode("utf-8", "replace")
            if rc == -2:
                raise _unsupported(msg)
            raise ValueError(msg)
        return rc

    def decode(self, packet: bytes) -> bool:
        return self._check(self._lib.msd_decode(self._h, packet, len(packet))) == 0

    def take(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        w, h = self.width, self.height
        cw, ch = (w + 1) // 2, (h + 1) // 2
        y = np.empty((h, w), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        if self._lib.msd_take(self._h, y.ctypes.data, u.ctypes.data, v.ctypes.data):
            raise ValueError("MS MPEG-4: no picture decoded yet")
        return y, u, v


class _BitReader:
    def __init__(self, data: bytes):
        self.v, self.left = int.from_bytes(data, "big"), 8 * len(data)

    def u(self, n: int) -> int:
        if n > self.left:
            raise ValueError("a header runs past its packet")
        self.left -= n
        return self.v >> self.left & ((1 << n) - 1)


def wmv2_extradata(extradata: bytes) -> dict:
    """WMV2's extended header (its 4 bytes of extradata), as FFmpeg's
    decode_ext_header reads it."""
    if len(extradata) < 4:
        raise _unsupported(f"WMV2 with {len(extradata)} bytes of extradata, not the 4 of its "
                           "extended header (FFmpeg refuses to decode it)")
    r = _BitReader(extradata[:4])
    out = {name: r.u(n) for name, n in (
        ("fps", 5), ("bit_rate", 11), ("mspel_bit", 1), ("loop_filter", 1), ("abt_flag", 1),
        ("j_type_bit", 1), ("top_left_mv_flag", 1), ("per_mb_rl_bit", 1), ("slice_code", 3))}
    out["bit_rate"] *= 1024
    return out


def picture_type(packet: bytes, version: int, ext: dict | None = None) -> str:
    """What FFmpeg makes of a packet, from its first bits: I, P, or SKIPPED
    (WMV2: a P picture whose skip map, of the row or column skip type,
    skips every MB, which FFmpeg shows no frame for).  A WMV2 IntraX8
    picture raises `UnsupportedCodecError` (`ext`: `wmv2_extradata` with the
    picture's `mb_size`); a packet too short for its header, ValueError."""
    r = _BitReader(packet)
    if version != WMV2:
        kind = r.u(2)
        if kind > 1:
            raise ValueError(f"picture type {kind + 1}: neither I nor P")
        return I if kind == 0 else P
    if r.u(1) == 0:
        r.u(7 + 5)
        if ext["j_type_bit"] and r.u(1):
            raise _unsupported("a WMV2 IntraX8 picture (j_type 1; FFmpeg's intrax8.c), "
                               "which the port does not decode")
        return I
    r.u(5)
    if not r.u(1):
        return P
    mbw, mbh = ext["mb_size"]
    run = mbw if r.u(1) else mbh                     # skip type 3 (columns) or 2 (rows)
    while run > 0:
        n = min(run, 25)
        if r.left < n or r.u(n) != (1 << n) - 1:
            return P
        run -= n
    return SKIPPED


class MSMPEG4Frames(Sequence):
    """The frames of an MS MPEG-4 v2 / v3 or WMV1 / WMV2 file (ASF, AVI,
    Matroska) as (H, W, 3) uint8 RGB, decoded by the host decoder on access
    (`frames[i]`, `len(frames)`, iteration), as cv2 shows them: one a
    packet in the file's order, none for a packet FFmpeg skips whole or an
    empty one.  Every packet's picture type is read when the file is opened,
    so an IntraX8 picture is refused before any decode.  A frame is decoded
    from the last I picture before it, or on from the last one decoded."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        self.path, self.offsets, self.sizes, self.info = path, offsets, sizes, info
        self.version = info["version"]
        self.width, self.height = info["width"], info["height"]
        if not (0 < self.width <= 8192 and 0 < self.height <= 8192):
            raise ValueError(f"{path}: a {NAMES[self.version]} stream of {self.width} x "
                             f"{self.height}")
        self.extradata = info.get("extradata", b"")
        ext = self.ext = None
        if self.version == WMV2:
            ext = self.ext = dict(wmv2_extradata(self.extradata),
                                  mb_size=((self.width + 15) // 16, (self.height + 15) // 16))
            if not ext["slice_code"]:
                raise ValueError(f"{path}: WMV2's extended header gives a slice code of 0")
        self.pictures: list[int] = []
        self.starts: list[int] = [0]
        with open(path, "rb") as f:
            for i, (o, s) in enumerate(zip(offsets, sizes)):
                if not s:
                    continue
                head = container.read_sample(f, o, min(s, 4096), info)
                try:
                    kind = picture_type(head, self.version, ext)
                except container.UnsupportedCodecError as e:
                    raise _unsupported(f"{path}: packet {i}: {e}") from None
                except ValueError as e:
                    raise ValueError(f"{path}: packet {i}: {e}") from None
                if kind == I and i:
                    self.starts.append(i)
                if kind == P and not self.pictures and self.version != WMV2:
                    raise _unsupported(
                        f"{path}: packet {i}: an {NAMES[self.version]} stream whose first "
                        "picture is a P picture: FFmpeg has no slice height before an I "
                        "picture and shows its error concealment for it")
                if kind != SKIPPED:
                    self.pictures.append(i)
        # FFmpeg's H.263 family tags its frames' chroma as centred (measured:
        # a picture of odd height converts as cv2's only so)
        self.colour = {"full_range": False, "primaries": 2, "transfer": 2, "matrix": 2,
                       "location": swscale.CENTER}
        self._decoder: Host | None = None
        self._next = 0                                # the next packet the decoder takes

    def __len__(self) -> int:
        return len(self.pictures)

    def sample(self, i: int) -> bytes:
        with open(self.path, "rb") as f:
            data = container.read_sample(f, self.offsets[i], self.sizes[i], self.info)
        if len(data) != len(self.info.get("prefix", b"")) + self.sizes[i]:
            raise ValueError(f"{self.path}: packet {i} is cut short")
        return data

    def ycbcr(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Frame i as decoded: Y', Cb, Cr uint8 planes."""
        n = len(self)
        if not -n <= i < n:
            raise IndexError(f"{self.path}: frame {i} of {n}")
        p = self.pictures[i % n]
        start = self.starts[bisect.bisect_right(self.starts, p) - 1]
        if self._decoder is None or p < self._next or self._next < start:
            self._decoder = Host(self.version, self.width, self.height, self.extradata)
            self._next = start
        while self._next <= p:
            k = self._next
            self._next += 1
            if not self.sizes[k]:
                continue
            packet = self.sample(k)
            try:
                self._decoder.decode(packet)
            except ValueError as e:
                self._decoder = None
                raise ValueError(f"{self.path}: packet {k}: {e}") from None
        return self._decoder.take()

    def __getitem__(self, i: int) -> np.ndarray:
        return np.ascontiguousarray(ycbcr_to_rgb(*self.ycbcr(i), **self.colour))

    rgb = __getitem__

    def probe(self) -> dict:
        """{"width", "height", "fps", "frame_count"} as cv2 reports them, with
        no decode: the container's size, rate and count of frames."""
        return {"width": self.width, "height": self.height, "fps": self.info["fps"] or 30.0,
                "frame_count": self.info["frame_count"]}

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]


def frames(path) -> MSMPEG4Frames:
    """The frames of an MS MPEG-4 / WMV file, decoded on access by the host
    decoder."""
    offsets, sizes, info = container.index(path)
    if info["codec"] != "msmpeg4":
        raise ValueError(f"{path}: its video is not MS MPEG-4 / WMV")
    return MSMPEG4Frames(Path(path), offsets, sizes, info)
