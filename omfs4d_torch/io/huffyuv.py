"""HuffYUV read on the host: FFmpeg's `huffyuv` (`HFYU`) and `ffvhuff`
(`FFVH`) at 8 bits, as cv2's writers put them in AVI, Matroska and
QuickTime and as VirtualDub, AmaRecTV and DirectShow capture write them,
for a machine with no ffmpeg and no cv2.

The decoder is the host C++ `huffyuvdec.cpp` (`Host`), built by g++ at
first use into `omfs4d_torch/_build/` (no Python fallback: without g++
reading raises with the reason) and bound with ctypes; the classic tables
of a version 0 / 1 stream come from `huffyuv_tables.py`.  It decodes
versions 0, 1 and 2: YUV 4:2:2, ffvhuff's 4:2:0, RGB24 and RGB32, with the
left, plane and median predictors, decorrelated RGB, interlaced prediction
and per-packet tables (`context`), as FFmpeg's huffyuvdec.c does.
ffvhuff's version 3 (planar formats, more than 8 bits, alpha) is refused
by name.

`HuffYUVFrames` shows one frame a packet: YUV through swscale as cv2
converts it (BT.601, limited range; 4:2:2 on its unscaled path), RGB as
stored (alpha dropped).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from omfs4d_torch.io import container, huffyuv_tables, swscale
from omfs4d_torch.io.rawvideo import IntraFrames

_SOURCE = Path(__file__).resolve().with_name("huffyuvdec.cpp")
_GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
# the decoder's formats (hyd_info)
YUV420, YUV422, RGB24, RGB32 = 0, 1, 2, 3
PREDICTORS = ("left", "plane", "median")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use, with g++, into `omfs4d_torch/_build/`) and load
    the host decoder; raises RuntimeError with g++'s message when it cannot."""
    from omfs4d_torch import native

    path = native.build(_SOURCE, "huffyuvdec", _GXX_FLAGS,
                        "omfs4d_torch/io/huffyuvdec.cpp (the HuffYUV decoder)",
                        headers={"huffyuv_tables.h": huffyuv_tables.cpp_header()})
    lib = ctypes.CDLL(str(path))
    lib.hyd_new.restype = ctypes.c_void_p
    lib.hyd_new.argtypes = []
    lib.hyd_free.restype = None
    lib.hyd_free.argtypes = [ctypes.c_void_p]
    lib.hyd_error.restype = ctypes.c_char_p
    lib.hyd_error.argtypes = [ctypes.c_void_p]
    lib.hyd_init.restype = ctypes.c_int
    lib.hyd_init.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_char_p, ctypes.c_int]
    lib.hyd_info.restype = None
    lib.hyd_info.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.hyd_decode.restype = ctypes.c_int
    lib.hyd_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.hyd_take.restype = ctypes.c_int
    lib.hyd_take.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    return lib


def _unsupported(what: str) -> container.UnsupportedCodecError:
    return container.UnsupportedCodecError(
        f"{what}; decoding this as cv2 shows it needs an ffmpeg binary (on PATH or from "
        "imageio_ffmpeg)")


class Host:
    """The host C++ decoder for one stream (its size, biBitCount and
    extradata): a packet in (`decode`), its planes out (`take`: Y', Cb, Cr
    uint8, chroma half as wide, half as high for 4:2:0, or R, G, B).  A
    corrupt packet raises ValueError, a stream outside the decoder
    `UnsupportedCodecError`."""

    def __init__(self, width: int, height: int, bits: int, extradata: bytes = b""):
        self._lib = _library()
        self._h = self._lib.hyd_new()
        if not self._h:
            raise MemoryError("HuffYUV: the decoder could not be created")
        self.width, self.height = width, height
        self._check(self._lib.hyd_init(self._h, width, height, bits, bytes(extradata),
                                       len(extradata)))
        out = np.zeros(6, np.int32)
        self._lib.hyd_info(self._h, out.ctypes.data)
        self.format, predictor, self.decorrelate, self.interlaced, self.context, \
            self.version = (int(v) for v in out)
        self.predictor = PREDICTORS[predictor]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hyd_free(self._h)
            self._h = None

    def _check(self, rc: int) -> None:
        if rc < 0:
            msg = self._lib.hyd_error(self._h).decode("utf-8", "replace")
            if rc == -2:
                raise _unsupported(msg)
            raise ValueError(msg)

    def decode(self, packet: bytes) -> None:
        self._check(self._lib.hyd_decode(self._h, packet, len(packet)))

    def take(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        w, h = self.width, self.height
        if self.format >= RGB24:
            shapes = [(h, w)] * 3
        else:
            shapes = [(h, w)] + [((h + 1) // 2 if self.format == YUV420 else h, w // 2)] * 2
        planes = tuple(np.empty(s, np.uint8) for s in shapes)
        if self._lib.hyd_take(self._h, *(p.ctypes.data for p in planes)):
            raise ValueError("HuffYUV: no picture decoded yet")
        return planes


class HuffYUVFrames(IntraFrames):
    """The frames of a HuffYUV track (AVI, Matroska, QuickTime), as cv2
    shows them; the decoder is set up (and a version 3 stream refused) when
    the file is opened."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        super().__init__(path, offsets, sizes, info)
        try:
            self.host = Host(self.width, self.height, info.get("bits", 0),
                             info.get("extradata", b""))
        except container.UnsupportedCodecError as e:
            raise container.UnsupportedCodecError(f"{path}: {e}") from None
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None

    def decode(self, data: bytes) -> np.ndarray:
        self.host.decode(data)
        a, b, c = self.host.take()
        if self.host.format >= RGB24:
            return np.stack([a, b, c], -1)
        return swscale.to_rgb(a, b, c, 8, 2, False, swscale.CENTER)


def frames(path) -> HuffYUVFrames:
    """The frames of a HuffYUV file, decoded on access by the host decoder."""
    offsets, sizes, info = container.index(path)
    if info["codec"] != "huffyuv":
        raise ValueError(f"{path}: its video is not HuffYUV")
    return HuffYUVFrames(Path(path), offsets, sizes, info)
