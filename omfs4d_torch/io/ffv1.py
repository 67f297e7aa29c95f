"""FFV1 read on the host: FFmpeg's `ffv1` (IETF RFC 9043), versions 0, 1
and 3, as cv2's writer puts it in AVI, Matroska, MP4 and QuickTime and as
archives keep it (FFV1 in Matroska is the preservation format of digitising
projects: 10-bit 4:2:2 its default), for a machine with no ffmpeg and no
cv2.

The decoder is the host C++ `ffv1dec.cpp` (`Host`), built by g++ at first
use into `omfs4d_torch/_build/` (no Python fallback: without g++ reading
raises with the reason) and bound with ctypes.  It decodes both coders
(Golomb-Rice with run mode; the range coder with the default or a custom
state table and the record's initial states), the quantised contexts,
version 3's slices with their headers and CRCs, and YCbCr / grey at 8 to 10
bits and RGB at 8 (the reversible colour transform; alpha, which cv2's
writer stores, dropped), as FFmpeg's ffv1dec.c does; YCbCr with alpha, more
bits, Bayer and versions 2 (FFmpeg's experimental one) and 4 are refused by
name.

`FFV1Frames` shows one frame a packet.  A non-key frame continues the
contexts of the frames before it, so a frame is decoded on from the last
key frame before it.  YCbCr goes through swscale as cv2 converts it (BT.601,
limited range; 10-bit on its scaled path), grey as B = G = R (8-bit: the
stored byte; 9- and 10-bit: rounded to 8), RGB as stored.  A slice whose
CRC fails shows the frame before it in its place, as FFmpeg conceals it, and
is not decoded again until the next key frame; in packed RGB FFmpeg's copy
lands a quarter of the slice's x off, and the rest of the slice stays black
(both measured in cv2).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from omfs4d_torch.io import container, swscale
from omfs4d_torch.io.rawvideo import IntraFrames

_SOURCE = Path(__file__).resolve().with_name("ffv1dec.cpp")
_GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use, with g++, into `omfs4d_torch/_build/`) and load
    the host decoder; raises RuntimeError with g++'s message when it cannot."""
    from omfs4d_torch import native

    path = native.build(_SOURCE, "ffv1dec", _GXX_FLAGS,
                        "omfs4d_torch/io/ffv1dec.cpp (the FFV1 decoder)")
    lib = ctypes.CDLL(str(path))
    lib.fvd_new.restype = ctypes.c_void_p
    lib.fvd_new.argtypes = []
    lib.fvd_free.restype = None
    lib.fvd_free.argtypes = [ctypes.c_void_p]
    lib.fvd_error.restype = ctypes.c_char_p
    lib.fvd_error.argtypes = [ctypes.c_void_p]
    lib.fvd_init.restype = ctypes.c_int
    lib.fvd_init.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                             ctypes.c_int]
    lib.fvd_decode.restype = ctypes.c_int
    lib.fvd_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.fvd_info.restype = None
    lib.fvd_info.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.fvd_take.restype = ctypes.c_int
    lib.fvd_take.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    return lib


def _unsupported(what: str) -> container.UnsupportedCodecError:
    return container.UnsupportedCodecError(
        f"{what}; decoding this as cv2 shows it needs an ffmpeg binary (on PATH or from "
        "imageio_ffmpeg)")


def is_key(packet: bytes) -> bool:
    """Whether a packet is a key frame: its range coder's first bit (state
    128), read from its first two bytes."""
    return len(packet) >= 2 and (packet[0] << 8 | packet[1]) >= 0x7F80


class Host:
    """The host C++ decoder for one stream (its size and configuration
    record): packets in order (`decode`: True for a key frame), the last
    picture's planes out (`take`: Y', Cb, Cr or grey alone, or R, G, B;
    uint8 at 8 bits, uint16 samples above).  A corrupt packet raises
    ValueError, a stream outside the decoder `UnsupportedCodecError`; after
    either the decoder is spent."""

    def __init__(self, width: int, height: int, extradata: bytes = b""):
        self._lib = _library()
        self._h = self._lib.fvd_new()
        if not self._h:
            raise MemoryError("FFV1: the decoder could not be created")
        self.width, self.height = width, height
        self._check(self._lib.fvd_init(self._h, width, height, bytes(extradata),
                                       len(extradata)))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fvd_free(self._h)
            self._h = None

    def _check(self, rc: int) -> int:
        if rc < 0:
            msg = self._lib.fvd_error(self._h).decode("utf-8", "replace")
            if rc == -2:
                raise _unsupported(msg)
            raise ValueError(msg)
        return rc

    def decode(self, packet: bytes) -> bool:
        return self._check(self._lib.fvd_decode(self._h, packet, len(packet))) == 1

    def info(self) -> dict:
        """The stream's parameters as the last key frame (or the record) set
        them, and the slices the last frame found damaged."""
        out = np.zeros(11, np.int32)
        self._lib.fvd_info(self._h, out.ctypes.data)
        keys = ("version", "micro_version", "coder", "colorspace", "bits", "chroma_planes",
                "h_shift", "v_shift", "slices", "ec", "damaged")
        return dict(zip(keys, (int(v) for v in out)))

    def take(self) -> tuple[np.ndarray, ...]:
        info = self.info()
        w, h = self.width, self.height
        if info["colorspace"]:
            shapes = [(h, w)] * 3
        elif info["chroma_planes"]:
            shapes = [(h, w)] + [(-(-h >> info["v_shift"]), -(-w >> info["h_shift"]))] * 2
        else:
            shapes = [(h, w)]
        planes = [np.empty(s, np.uint16) for s in shapes]
        ptrs = [p.ctypes.data for p in planes] + [None] * (3 - len(planes))
        if self._lib.fvd_take(self._h, *ptrs):
            raise ValueError("FFV1: no picture decoded yet")
        if info["bits"] <= 8:
            planes = [p.astype(np.uint8) for p in planes]
        return tuple(planes)


def to_rgb(planes: tuple[np.ndarray, ...], info: dict) -> np.ndarray:
    """A decoded FFV1 picture -> (H, W, 3) uint8 RGB as cv2 converts it."""
    if info["colorspace"]:
        g, b, r = planes
        return np.stack([r, g, b], -1)
    if len(planes) == 1:
        if info["bits"] <= 8:
            return np.repeat(planes[0][..., None], 3, axis=2)
        # swscale's GRAY9 / GRAY10 to BGR24 as cv2 shows it (measured over
        # every 10-bit level): rounded half up to 8 bits, clipped
        shift = info["bits"] - 8
        y = np.minimum((planes[0].astype(np.int32) + (1 << (shift - 1))) >> shift, 255)
        return np.repeat(y.astype(np.uint8)[..., None], 3, axis=2)
    return swscale.to_rgb(*planes, info["bits"], 2, False, swscale.CENTER)


class FFV1Frames(IntraFrames):
    """The frames of an FFV1 track (AVI, Matroska, MP4 / QuickTime), as cv2
    shows them: one a packet, each decoded on from the last key frame
    before it (or from the last frame decoded).  The key frames are found
    when the file is opened, and the configuration record read then."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        super().__init__(path, offsets, sizes, info)
        self.extradata = info.get("extradata", b"")
        self._host: Host | None = None
        self._next = 0
        self._new_host()
        self.keys = []
        with open(self.path, "rb") as f:
            for i, k in enumerate(self.samples):
                head = container.read_sample(f, self.offsets[k], min(self.sizes[k], 2), info)
                if is_key(head):
                    self.keys.append(i)
        if not self.keys or self.keys[0] != 0:
            raise ValueError(f"{path}: an FFV1 stream that starts with no key frame")

    def _new_host(self) -> None:
        try:
            self._host = Host(self.width, self.height, self.extradata)
        except container.UnsupportedCodecError as e:
            raise container.UnsupportedCodecError(f"{self.path}: {e}") from None
        except ValueError as e:
            raise ValueError(f"{self.path}: {e}") from None

    def ycbcr(self, i: int) -> tuple[np.ndarray, ...]:
        """Frame i's planes as decoded (see `Host.take`)."""
        n = len(self)
        if not -n <= i < n:
            raise IndexError(f"{self.path}: frame {i} of {n}")
        i %= n
        start = max(k for k in self.keys if k <= i)
        if self._host is None or i < self._next or self._next < start:
            self._new_host()
            self._next = start
        while self._next <= i:
            data = self.sample(self._next)
            try:
                self._host.decode(data)
            except container.UnsupportedCodecError as e:
                self._host = None
                raise container.UnsupportedCodecError(
                    f"{self.path}: frame {self._next}: {e}") from None
            except ValueError as e:
                self._host = None
                raise ValueError(f"{self.path}: frame {self._next}: {e}") from None
            self._next += 1
        return self._host.take()

    def __getitem__(self, i: int) -> np.ndarray:
        planes = self.ycbcr(i)
        return to_rgb(planes, self._host.info())

    rgb = __getitem__


def frames(path) -> FFV1Frames:
    """The frames of an FFV1 file, decoded on access by the host decoder."""
    offsets, sizes, info = container.index(path)
    if info["codec"] != "ffv1":
        raise ValueError(f"{path}: its video is not FFV1")
    return FFV1Frames(Path(path), offsets, sizes, info)
