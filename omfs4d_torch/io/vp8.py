"""VP8 (RFC 6386) read on the host: the video a browser records into WebM
(`MediaRecorder` with `video/webm` in Chrome and Firefox) and cv2's `VP80`
writer puts in WebM, Matroska and AVI, for a machine with no ffmpeg and no
cv2.

The decoder is the host C++ `vp8dec.cpp` (`Host`), built by g++ at first
use into `omfs4d_torch/_build/` (no Python fallback: without g++ reading
raises with the reason) and bound with ctypes; its tables come from
`vp8_tables.py`.  It decodes every version (0: six-tap filters; 1 and 2:
bilinear; 3: bilinear luma, whole-pixel chroma), the normal and the simple
loop filter with sharpness and the reference and mode deltas, segmentation
(its map and its features kept from frame to frame, absolute or delta),
1 to 8 token partitions, every probability update, with or without
`refresh_entropy_probs`, golden and altref refreshes, copies and sign bias,
intra 16x16, chroma and the ten sub-block modes, and inter macroblocks
from `find_near_mvs` and SPLITMV in all four partitionings, as FFmpeg's
`vp8` decoder decodes them (`vp8dec.cpp` lists where it follows FFmpeg
rather than the RFC's reference decoder); its samples are FFmpeg's bit
for bit.

`probe_frame` reads a frame's header without a decoder: whether FFmpeg
decodes it at all (a frame whose header or partitions run past its packet
is dropped, `DROP_REASONS`), key frame or not, version, show_frame, a key
frame's size and colour bits.  `VP8Frames` shows a file's frames as cv2
does, through it: the frames FFmpeg decodes and shows, in order, up to the
first frame FFmpeg fails on (cv2 reads no further: a WebM cut mid-GOP,
which starts at an inter frame, reads as no frame at all; an empty block
is skipped), a frame with show_frame 0 (an altref) decoded and not shown,
converted as FFmpeg tags them (BT.601, limited range; the primaries and
transfer of a Matroska `Colour`) through `h264.ycbcr_to_rgb` (swscale's
own conversion, bit for bit), each decoded from the last key frame before
it or on from the last frame decoded.  Refused by name
(`UnsupportedCodecError`), where cv2's frames are not one stream's: a key
frame that changes the picture's size; the clamping_type bit set (FFmpeg
reads it as full range in the frame thread that decodes the key frame
only, so cv2's colours depend on the host's core count); color_space 1
under a Colour matrix swscale reads otherwise than BT.601 (the same); a
stream whose first key frame takes its segment map from a frame the file
does not hold.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
from collections.abc import Iterator, Sequence
from pathlib import Path
from typing import NamedTuple

import numpy as np

from omfs4d_torch.io import colour, container, swscale, vp8_tables
from omfs4d_torch.io.h264 import ycbcr_to_rgb

_SOURCE = Path(__file__).resolve().with_name("vp8dec.cpp")
_GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

# what a decode did (vp8d_decode)
SHOWN, HIDDEN, DROPPED, FAILED = 0, 1, 2, -1
# why FFmpeg drops a frame (vp8d_probe)
DROP_REASONS = {
    1: "it is shorter than its 3-byte frame tag",
    2: "its first partition runs past the packet",
    3: "its key frame start code is not 9d 01 2a",
    4: "its first partition is empty",
    5: "its partition sizes run past the packet",
    6: "a token partition runs past the packet",
    7: "a token partition is empty",
    8: "its key frame has a side of 0",
    9: "it is an inter frame before the first key frame",
}


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use, with g++, into `omfs4d_torch/_build/`) and load
    the host decoder; raises RuntimeError with g++'s message when it cannot:
    no frame is decoded in Python on the reading path."""
    from omfs4d_torch import native

    path = native.build(_SOURCE, "vp8dec", _GXX_FLAGS,
                        "omfs4d_torch/io/vp8dec.cpp (the VP8 decoder)",
                        headers={"vp8_tables.h": vp8_tables.cpp_header()})
    lib = ctypes.CDLL(str(path))
    lib.vp8d_new.restype = ctypes.c_void_p
    lib.vp8d_new.argtypes = []
    lib.vp8d_free.restype = None
    lib.vp8d_free.argtypes = [ctypes.c_void_p]
    lib.vp8d_decode.restype = ctypes.c_int
    lib.vp8d_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.vp8d_error.restype = ctypes.c_char_p
    lib.vp8d_error.argtypes = [ctypes.c_void_p]
    lib.vp8d_size.restype = None
    lib.vp8d_size.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.vp8d_take.restype = ctypes.c_int
    lib.vp8d_take.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.vp8d_probe.restype = None
    lib.vp8d_probe.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
    return lib


class FrameHeader(NamedTuple):
    """A frame's header as `probe_frame` reads it."""
    drop: int                 # 0 where FFmpeg decodes the frame, else a DROP_REASONS key
    key: bool
    version: int
    show: bool
    width: int                # a key frame's; 0 for an inter frame
    height: int
    colour_space: int         # a key frame's color_space bit
    full_range: bool          # a key frame's clamping_type bit, as FFmpeg reads it
    map_from_previous: bool   # a key frame whose segment map is the frame before's


def _unsupported(what: str) -> container.UnsupportedCodecError:
    return container.UnsupportedCodecError(
        f"{what}; decoding this as cv2 shows it needs an ffmpeg binary (on PATH or from "
        "imageio_ffmpeg)")


def probe_frame(data: bytes) -> FrameHeader:
    """The header of a VP8 frame, read without a decoder's state."""
    out = (ctypes.c_int32 * 9)()
    _library().vp8d_probe(data, len(data), out)
    return FrameHeader(out[0], bool(out[1]), out[2], bool(out[3]), out[4], out[5], out[6],
                       bool(out[7]), bool(out[8]))


class Host:
    """The host C++ decoder (`vp8dec.cpp`) itself: a frame in (`decode`:
    SHOWN, HIDDEN or DROPPED), the last frame decoded out (`take`) as (Y',
    Cb, Cr) uint8 planes (chroma of half the size, rounded up).  A frame the
    decoder cannot finish raises ValueError, after which the decoder is
    spent."""

    def __init__(self):
        self._lib = _library()
        self._h = self._lib.vp8d_new()
        if not self._h:
            raise MemoryError("VP8: the decoder could not be created")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vp8d_free(self._h)
            self._h = None

    def decode(self, frame: bytes) -> int:
        status = self._lib.vp8d_decode(self._h, frame, len(frame))
        if status == FAILED:
            raise ValueError(self._lib.vp8d_error(self._h).decode())
        return status

    def take(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        out = (ctypes.c_int32 * 2)()
        self._lib.vp8d_size(self._h, out)
        w, h = out
        if not w or not h:
            raise ValueError("VP8: no frame decoded yet")
        cw, ch = (w + 1) // 2, (h + 1) // 2
        y = np.empty((h, w), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        if self._lib.vp8d_take(self._h, y.ctypes.data, u.ctypes.data, v.ctypes.data):
            raise ValueError("VP8: no frame decoded yet")
        return y, u, v


class VP8Frames(Sequence):
    """The frames of a VP8 file (WebM / Matroska, AVI) as (H, W, 3) uint8
    RGB, decoded by the host decoder on access (`frames[i]`, `len(frames)`,
    iteration), as cv2 shows them: the frames FFmpeg decodes and shows, in
    the file's order.  Every frame's header is read when the file is opened
    (`probe_frame`), so that what FFmpeg drops, hides or cannot restart
    from is known before any decode, and a change of size is refused then.
    A frame is decoded from the last key frame before it (one that takes no
    segment map from the frame before), or on from the last one decoded."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        self.path, self.offsets, self.sizes, self.info = path, offsets, sizes, info
        self.pictures: list[int] = []
        self.starts: list[int] = []
        self.failed: tuple[int, int] | None = None    # (frame, DROP_REASONS key)
        self.size: tuple[int, int] | None = None
        colr = info.get("colr")
        decodable = False
        with open(path, "rb") as f:
            for i, (o, s) in enumerate(zip(offsets, sizes)):
                data = container.read_sample(f, o, s, info)
                if not data:
                    continue                          # an empty block: FFmpeg never sees it
                h = probe_frame(data)
                if h.drop or not (h.key or decodable):
                    # cv2 stops reading at the first frame FFmpeg fails on:
                    # nothing after it is shown
                    self.failed = (i, h.drop or 9)
                    break
                if h.key:
                    self._key_frame(i, h, colr)
                    if h.map_from_previous and not decodable:
                        raise _unsupported(
                            f"{path}: frame {i}: the stream's first VP8 key frame takes its "
                            "segment map from the frame before it, which the file does not "
                            "hold (a stream cut there): FFmpeg's map is then not the zeros the "
                            "RFC gives")
                    if not h.map_from_previous:
                        self.starts.append(i)
                    decodable = True
                if h.show:
                    self.pictures.append(i)
        # FFmpeg's VP8 decoder tags BT.470BG (with color_space 1, nothing:
        # the container's matrix stays, which `_key_frame` allows only where
        # swscale reads it as BT.601 too) and limited range; the primaries
        # and transfer stay the container's
        tags = {"full_range": False, "primaries": 2, "transfer": 2, "matrix": 5}
        if colr is not None:
            tags["primaries"], tags["transfer"] = colr[0], colr[1]
        self.colour = dict(colour.stream(tags), location=swscale.CENTER)
        self._decoder: Host | None = None
        self._next = 0                                # the next frame the decoder takes

    def _key_frame(self, i: int, h: FrameHeader, colr) -> None:
        """Hold a decodable key frame to what the port follows of FFmpeg."""
        where = f"{self.path}: frame {i}: a VP8 key frame"
        if self.size is None:
            self.size = (h.width, h.height)
        elif (h.width, h.height) != self.size:
            raise _unsupported(f"{where} of {h.width} x {h.height} in a stream of "
                               f"{self.size[0]} x {self.size[1]} (a change of the picture's "
                               "size)")
        if h.full_range:
            raise _unsupported(
                f"{where} with clamping_type 1: FFmpeg reads it as full range, and cv2's "
                "frame threads give that range only to the frames each thread decodes "
                "after such a key frame, so cv2's colours depend on the host's core count")
        if h.colour_space and colr is not None and colr[2] in swscale.SWS_COEFFS:
            raise _unsupported(
                f"{where} with color_space 1 in a track whose Colour matrix is {colr[2]}: "
                "FFmpeg then leaves each frame thread's matrix as it was, so cv2's "
                "colours depend on the host's core count")

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
        p = self.pictures[i % n]
        start = self.starts[bisect.bisect_right(self.starts, p) - 1]
        if self._decoder is None or p < self._next or self._next < start:
            self._decoder, self._next = Host(), start
        while self._next <= p:
            k = self._next
            container.check_whole(self.path, self.info, k)
            self._next += 1
            try:
                self._decoder.decode(self.sample(k))
            except ValueError as e:
                self._decoder = None
                raise ValueError(f"{self.path}: frame {k}: {e}") from None
        return self._decoder.take()

    def __getitem__(self, i: int) -> np.ndarray:
        rgb = ycbcr_to_rgb(*self.ycbcr(i), **self.colour)
        return np.ascontiguousarray(np.rot90(rgb, -self.info.get("rotation", 0) // 90))

    rgb = __getitem__

    def probe(self) -> dict:
        """{"width", "height", "fps", "frame_count"} as cv2 reports them, with
        no decode: the first key frame's size (the container's where no frame
        is decodable; turned by the container's display rotation), the
        container's rate and its count of frames."""
        w, h = self.size or (self.info["width"], self.info["height"])
        if self.info.get("rotation", 0) in (90, 270):
            w, h = h, w
        return {"width": w, "height": h, "fps": self.info["fps"] or 30.0,
                "frame_count": self.info["frame_count"]}

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]


def frames(path) -> VP8Frames:
    """The frames of a VP8 file, decoded on access by the host decoder."""
    offsets, sizes, info = container.index(path)
    if info["codec"] != "vp8":
        raise ValueError(f"{path}: its video is not VP8")
    return VP8Frames(Path(path), offsets, sizes, info)
