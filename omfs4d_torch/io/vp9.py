"""VP9 profile 0 read on the host: the video cv2's `VP90` writer puts in
WebM, Matroska, AVI and MP4, a browser records into WebM (`MediaRecorder`
with `video/webm;codecs=vp9`) and YouTube serves, for a machine with no
ffmpeg and no cv2.

The decoder is the host C++ `vp9dec.cpp` (`Host`), built by g++ at first
use into `omfs4d_torch/_build/` (no Python fallback: without g++ reading
raises with the reason) and bound with ctypes; its tables come from
`vp9_tables.py`.  It decodes key, inter and intra-only frames at 8 bits
4:2:0, every block size and partition, the ten intra modes, single and
compound prediction from LAST, GOLDEN and ALTREF with the four filters,
every transform size and type and the lossless WHT, segmentation with its
map and its four features, the loop filter with its deltas, tile columns
and rows, the four saved probability contexts with their deltas and
backward adaptation, as FFmpeg's `vp9` decoder decodes them
(`vp9dec.cpp` lists where it follows FFmpeg rather than the
specification); its samples are FFmpeg's bit for bit.

`split_superframe` cuts a packet into its frames as FFmpeg's
`vp9_superframe_split` does; `probe_frame` reads a frame's uncompressed
header without a decoder.  `VP9Frames` shows a file's frames as cv2 does:
the frames FFmpeg decodes and shows (`show_frame`, or `show_existing_frame`
of a slot), in order, up to the first frame FFmpeg fails on (cv2 reads no
further: a WebM cut mid-GOP, which starts at an inter frame, reads as no
frame at all), each decoded from the last key frame before it or on from
the last frame decoded (FFmpeg also fails on a frame whose last byte looks
like a superframe marker), converted with the matrix and range of the key
frame's colour bits (FFmpeg sets them from the stream whatever the
container says) through `h264.ycbcr_to_rgb` (swscale's own conversion, bit
for bit).  Refused by name (`UnsupportedCodecError`), where cv2 would need
what the port does not follow: profiles 1-3 (4:4:4, 4:2:2, 4:4:0, 10 and 12
bits), a key frame or an intra-only frame that changes the picture's size,
and an inter frame whose references differ from it in size (scaled motion
compensation).
"""

from __future__ import annotations

import bisect
import ctypes
import functools
from collections.abc import Iterator, Sequence
from pathlib import Path
from typing import NamedTuple

import numpy as np

from omfs4d_torch.io import colour, container, swscale, vp9_tables
from omfs4d_torch.io.h264 import ycbcr_to_rgb

_SOURCE = Path(__file__).resolve().with_name("vp9dec.cpp")
_GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

# what a decode did (vp9d_decode)
SHOWN, HIDDEN, FAILED = 0, 1, -1
# why FFmpeg fails on a frame (vp9dec.cpp's Probe.error)
ERRORS = {
    1: "its frame marker is not 2",
    2: "its profile is 4 or more",
    3: "its profile is not 0",
    4: "its key frame or intra-only frame has no sync code",
    5: "it names a reference that was never decoded",
    6: "it is an RGB stream in profile 0",
    7: "it shows an existing frame from a slot never filled",
    8: "a reference differs from it in size",
    9: "its compressed header runs past the packet",
    10: "a tile's data ends early",
    11: "its compressed header is empty",
    12: "a boolean-coded partition starts with its marker bit set",
    13: "a tile runs past the packet",
    14: "its last byte looks like a superframe index's marker (0xc0 to 0xdf)",
    15: "it is empty",
}
# FFmpeg's AVColorSpace (H.273 matrix_coefficients) of the header's color_space
MATRIX = {0: 2, 1: 5, 2: 1, 3: 6, 4: 7, 5: 9, 6: 3}


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use, with g++, into `omfs4d_torch/_build/`) and load
    the host decoder; raises RuntimeError with g++'s message when it cannot:
    no frame is decoded in Python on the reading path."""
    from omfs4d_torch import native

    path = native.build(_SOURCE, "vp9dec", _GXX_FLAGS,
                        "omfs4d_torch/io/vp9dec.cpp (the VP9 decoder)",
                        headers={"vp9_tables.h": vp9_tables.cpp_header()})
    lib = ctypes.CDLL(str(path))
    lib.vp9d_new.restype = ctypes.c_void_p
    lib.vp9d_new.argtypes = []
    lib.vp9d_free.restype = None
    lib.vp9d_free.argtypes = [ctypes.c_void_p]
    lib.vp9d_decode.restype = ctypes.c_int
    lib.vp9d_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.vp9d_error.restype = ctypes.c_char_p
    lib.vp9d_error.argtypes = [ctypes.c_void_p]
    lib.vp9d_size.restype = None
    lib.vp9d_size.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.vp9d_take.restype = ctypes.c_int
    lib.vp9d_take.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.vp9d_probe.restype = None
    lib.vp9d_probe.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                               ctypes.POINTER(ctypes.c_int32)]
    lib.vp9d_probe_of.restype = None
    lib.vp9d_probe_of.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    return lib


class FrameHeader(NamedTuple):
    """A frame's uncompressed header as `probe_frame` reads it."""
    error: int                # 0, or an ERRORS key found in the header
    profile: int
    show_existing: bool
    existing_idx: int
    key: bool
    intra_only: bool
    show: bool
    width: int                # a key or intra-only frame's, or a coded size; 0 when taken
    height: int               # from a reference
    colour_space: int         # a key frame's color_space
    full_range: bool          # a key frame's color_range
    refresh_flags: int
    ref_idx: tuple[int, int, int]
    error_res: bool
    found_ref: int            # an inter frame's size_in_refs index, -1 for a coded size
    header_bytes: int = 0     # the uncompressed header's length
    compressed_size: int = 0  # the compressed header's
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0


def _unsupported(what: str) -> container.UnsupportedCodecError:
    return container.UnsupportedCodecError(
        f"{what}; the port decodes VP9 profile 0 (8-bit 4:2:0) by itself, and decoding this "
        "as cv2 shows it needs an ffmpeg binary (on PATH or from imageio_ffmpeg)")


def probe_frame(data: bytes, size: tuple[int, int] = (0, 0)) -> FrameHeader:
    """The uncompressed header of a VP9 frame, read without a decoder (an
    inter frame's references taken to be of `size`, which sets its tiles)."""
    out = (ctypes.c_int32 * 24)()
    _library().vp9d_probe(data, len(data), size[0], size[1], out)
    return FrameHeader(out[0], out[1], bool(out[2]), out[3], bool(out[4]), bool(out[5]),
                       bool(out[6]), out[7], out[8], out[9], bool(out[10]), out[11],
                       (out[12], out[13], out[14]), bool(out[15]), out[16], out[17], out[18],
                       out[19], out[20])


def layout_error(data: bytes, h: FrameHeader) -> int:
    """0 where a frame's compressed header and tiles lie within its packet
    as FFmpeg checks them, else the ERRORS key: an empty compressed header
    (11) or one past the packet (9), a tile size past the packet or an
    empty tile (13)."""
    if h.show_existing:
        return 0
    if not h.compressed_size:
        return 11
    pos = h.header_bytes + h.compressed_size
    if pos > len(data):
        return 9
    tiles = 1 << (h.tile_cols_log2 + h.tile_rows_log2)
    for t in range(tiles):
        if t == tiles - 1:
            size = len(data) - pos
        else:
            if len(data) - pos < 4:
                return 13
            size = int.from_bytes(data[pos:pos + 4], "big")
            pos += 4
            if size > len(data) - pos:
                return 13
        if not size:
            return 13
        pos += size
    return 0


def split_superframe(data: bytes) -> list[bytes] | None:
    """A packet's frames as FFmpeg's `vp9_superframe_split` gives them: the
    frames its superframe index lists, or the packet itself; None where the
    index's sizes run past the packet (FFmpeg then drops the packet with an
    error)."""
    if not data:
        return [data]
    marker = data[-1]
    if marker & 0xE0 != 0xC0:
        return [data]
    length_size = 1 + ((marker >> 3) & 3)
    n = 1 + (marker & 7)
    idx_size = 2 + n * length_size
    if len(data) < idx_size or data[-idx_size] != marker:
        return [data]
    sizes, total, p = [], 0, len(data) - idx_size + 1
    for _ in range(n):
        size = int.from_bytes(data[p:p + length_size], "little")
        p += length_size
        total += size
        if total > len(data) - idx_size:
            return None
        sizes.append(size)
    out, offset = [], 0
    for size in sizes:
        out.append(data[offset:offset + size])
        offset += size
    return out


class Host:
    """The host C++ decoder (`vp9dec.cpp`) itself: a frame in (`decode`:
    SHOWN or HIDDEN), the last picture to show out (`take`) as (Y', Cb, Cr)
    uint8 planes (chroma of half the size, rounded up).  A frame the decoder
    cannot decode raises ValueError (`error` holds the ERRORS key where
    there is one), after which the decoder is spent."""

    def __init__(self):
        self._lib = _library()
        self._h = self._lib.vp9d_new()
        if not self._h:
            raise MemoryError("VP9: the decoder could not be created")
        self.error = 0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vp9d_free(self._h)
            self._h = None

    def decode(self, frame: bytes) -> int:
        status = self._lib.vp9d_decode(self._h, frame, len(frame))
        if status == FAILED:
            out = (ctypes.c_int32 * 20)()
            self._lib.vp9d_probe_of(self._h, out)
            self.error = out[0]
            raise ValueError(self._lib.vp9d_error(self._h).decode())
        return status

    def size(self) -> tuple[int, int, int, bool]:
        """(width, height, color_space, full range) of the picture to show."""
        out = (ctypes.c_int32 * 4)()
        self._lib.vp9d_size(self._h, out)
        return out[0], out[1], out[2], bool(out[3])

    def take(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        w, h, _, _ = self.size()
        if not w or not h:
            raise ValueError("VP9: no frame decoded yet")
        cw, ch = (w + 1) // 2, (h + 1) // 2
        y = np.empty((h, w), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        if self._lib.vp9d_take(self._h, y.ctypes.data, u.ctypes.data, v.ctypes.data):
            raise ValueError("VP9: no frame decoded yet")
        return y, u, v


class VP9Frames(Sequence):
    """The frames of a VP9 file (WebM / Matroska, AVI, MP4) as (H, W, 3)
    uint8 RGB, decoded by the host decoder on access (`frames[i]`,
    `len(frames)`, iteration), as cv2 shows them: the frames FFmpeg decodes
    and shows, in the file's order.  Every frame's header is read when the
    file is opened (`probe_frame`, after `split_superframe`), so that what
    FFmpeg fails on, hides or cannot start from is known before any decode,
    and what the port refuses is refused then.  A picture is decoded from
    the last key frame before it, or on from the last frame decoded."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        self.path, self.offsets, self.sizes, self.info = path, offsets, sizes, info
        self.frames: list[tuple[int, int]] = []       # (sample, frame in its superframe)
        self.pictures: list[int] = []                 # index into frames of each shown one
        self.starts: list[int] = []                   # index into frames of each key frame
        self.failed: tuple[int, int] | None = None    # (sample, ERRORS key)
        self.size: tuple[int, int] | None = None
        self.key_colour: tuple[int, bool] | None = None
        filled = [False] * 8                          # the reference slots, as far as known
        sized = [None] * 8
        with open(path, "rb") as f:
            for i, (o, s) in enumerate(zip(offsets, sizes)):
                data = container.read_sample(f, o, s, info)
                if not data:
                    continue                          # an empty block: FFmpeg never sees it
                parts = split_superframe(data)
                if parts is None:
                    raise _unsupported(
                        f"{path}: frame {i}: a VP9 superframe index whose sizes run past its "
                        "packet: FFmpeg fails before its frame threads hand back the frames "
                        "they hold, so cv2's count depends on the host's core count")
                stop = False
                for k, part in enumerate(parts):
                    h = probe_frame(part, self.size or (0, 0))
                    if not part:
                        error = 15
                    elif part[-1] & 0xE0 == 0xC0:
                        error = 14                    # FFmpeg takes it for a broken index
                    elif h.header_bytes > len(part) or (not h.header_bytes and not h.error):
                        error = 9                     # its header runs past the packet
                    else:
                        error = self._check(i, h, filled, sized) or layout_error(part, h)
                    if error:
                        self.failed = (i, error)
                        stop = True
                        break
                    if h.key or not self.frames:              # a stream may start intra-only
                        self.starts.append(len(self.frames))
                    if not h.show_existing:
                        for slot in range(8):
                            if h.refresh_flags >> slot & 1:
                                filled[slot] = True
                                sized[slot] = self.size
                    self.frames.append((i, k))
                    if h.show or h.show_existing:
                        self.pictures.append(len(self.frames) - 1)
                if stop:
                    break
        colr = info.get("colr")
        space, full = self.key_colour or (0, False)
        tags = {"full_range": full, "primaries": 2, "transfer": 2, "matrix": MATRIX[space]}
        if colr is not None:
            tags["primaries"], tags["transfer"] = colr[0], colr[1]
        self.colour = dict(colour.stream(tags), location=swscale.CENTER)
        self._decoder: Host | None = None
        self._next = 0                                # the next frame the decoder takes
        self._shown = -1                              # the frame whose picture it holds

    def _check(self, i: int, h: FrameHeader, filled: list, sized: list) -> int:
        """0 where FFmpeg decodes the frame, else why it fails; raises
        UnsupportedCodecError for what the port refuses by name."""
        where = f"{self.path}: frame {i}"
        if h.error in (3, 2) or h.profile:
            raise _unsupported(f"{where}: VP9 profile {h.profile} (4:4:4, 4:2:2, 4:4:0 or "
                               "more than 8 bits), which the port does not decode")
        if h.error:
            return h.error
        if h.show_existing:
            return 0 if filled[h.existing_idx] else 7
        if not (h.key or h.intra_only):
            refs = [sized[j] for j in h.ref_idx]
            if any(r is None for r in refs):
                return 5
            size = refs[h.found_ref] if h.found_ref >= 0 else (h.width, h.height)
            if any(r != size for r in refs):
                raise _unsupported(f"{where}: a VP9 inter frame of {size[0]} x {size[1]} whose "
                                   "references differ from it in size (scaled motion "
                                   "compensation)")
            h = h._replace(width=size[0], height=size[1])
        if self.size is None:
            self.size = (h.width, h.height)
        elif (h.width, h.height) != self.size:
            raise _unsupported(f"{where}: a VP9 frame of {h.width} x {h.height} in a stream of "
                               f"{self.size[0]} x {self.size[1]} (a change of the picture's size)")
        if h.key and h.colour_space == 6:
            raise _unsupported(f"{where}: a VP9 key frame of the reserved color_space 6: "
                               "FFmpeg's frame threads then differ in the matrix they tag")
        if h.key and self.key_colour is None:
            self.key_colour = (h.colour_space, h.full_range)
        elif h.key and (h.colour_space, h.full_range) != self.key_colour:
            raise _unsupported(f"{where}: a VP9 key frame whose colour bits differ from the "
                               "first key frame's")
        return 0

    def __len__(self) -> int:
        return len(self.pictures)

    def sample(self, i: int) -> bytes:
        with open(self.path, "rb") as f:
            data = container.read_sample(f, self.offsets[i], self.sizes[i], self.info)
        if len(data) != len(self.info.get("prefix", b"")) + self.sizes[i]:
            raise ValueError(f"{self.path}: frame {i} is cut short")
        return data

    def _frame(self, j: int) -> bytes:
        i, k = self.frames[j]
        return split_superframe(self.sample(i))[k]

    def ycbcr(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Picture i as decoded: Y', Cb, Cr uint8 planes."""
        n = len(self)
        if not -n <= i < n:
            raise IndexError(f"{self.path}: frame {i} of {n}")
        p = self.pictures[i % n]
        if self._decoder is not None and self._shown == p:
            return self._decoder.take()
        start = self.starts[bisect.bisect_right(self.starts, p) - 1]
        if self._decoder is None or p < self._next or self._next < start:
            self._decoder, self._next = Host(), start
        while self._next <= p:
            j = self._next
            container.check_whole(self.path, self.info, self.frames[j][0])
            self._next += 1
            try:
                self._decoder.decode(self._frame(j))
            except ValueError as e:
                self._decoder = None
                raise ValueError(f"{self.path}: frame {self.frames[j][0]}: {e}") from None
        self._shown = p
        return self._decoder.take()

    def __getitem__(self, i: int) -> np.ndarray:
        rgb = ycbcr_to_rgb(*self.ycbcr(i), **self.colour)
        return np.ascontiguousarray(np.rot90(rgb, -self.info.get("rotation", 0) // 90))

    rgb = __getitem__

    def probe(self) -> dict:
        """{"width", "height", "fps", "frame_count"} as cv2 reports them, with
        no decode: the first decodable frame's size (the container's where
        none is; turned by the container's display rotation), the
        container's rate and its count of frames."""
        w, h = self.size or (self.info["width"], self.info["height"])
        if self.info.get("rotation", 0) in (90, 270):
            w, h = h, w
        return {"width": w, "height": h, "fps": self.info["fps"] or 30.0,
                "frame_count": self.info["frame_count"]}

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]


def frames(path) -> VP9Frames:
    """The frames of a VP9 file, decoded on access by the host decoder."""
    offsets, sizes, info = container.index(path)
    if info["codec"] != "vp9":
        raise ValueError(f"{path}: its video is not VP9")
    return VP9Frames(Path(path), offsets, sizes, info)
