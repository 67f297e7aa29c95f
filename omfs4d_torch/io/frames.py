"""What the port's video codecs with reordered output share (`h264`,
`hevc`): the ctypes wrapper of their host C++ decoders (`HostDecoder`, one C
API shape), the Annex B splitter (`annexb_units`), and the sample reader
(`SampleFrames`: the NAL units of each sample, length-prefixed as MP4 and
Matroska hold them or an Annex B byte stream as AVI and MPEG-TS do, output
order by presentation time, the edit list, the display rotation, restarts at
the sync samples that start their output order cleanly, and a cache of the
pictures decoded past the one asked for).

A `SampleFrames` subclass sets `length` (the NAL length size; 0 for Annex
B) and `params` (the parameter set's `width`, `height`, `fps`, `full_range`
and `matrix`), and gives `header_units` (what a restart pushes first),
`new_decoder` (its `HostDecoder`) and `rgb_of` (a picture's colour
conversion).
"""

from __future__ import annotations

import bisect
import ctypes
import re
from collections.abc import Callable, Iterator, Sequence
from pathlib import Path

import numpy as np

from omfs4d_torch.io import container, mp4

# the C API every host decoder exports, after its prefix: (name, argtypes,
# restype); `nal`, `end_picture` and `flush` return 0, 1 (corrupt) or 2
# (outside the decoder's subset), and `error` the message of the last
_API = (("new", [], ctypes.c_void_p), ("free", [ctypes.c_void_p], None),
        ("nal", [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64], ctypes.c_int),
        ("end_picture", [ctypes.c_void_p], ctypes.c_int),
        ("flush", [ctypes.c_void_p], ctypes.c_int), ("ready", [ctypes.c_void_p], ctypes.c_int),
        ("frame_size", [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_int32)], ctypes.c_int),
        ("pop", [ctypes.c_void_p] + [ctypes.c_void_p] * 3, ctypes.c_int),
        ("error", [ctypes.c_void_p], ctypes.c_char_p))
# what a decoder of samples deeper than 8 bits exports besides: the bit depth
# of the next picture out, and a pop into uint16 planes
_API_DEEP = (("bit_depth", [ctypes.c_void_p], ctypes.c_int),
             ("pop16", [ctypes.c_void_p] + [ctypes.c_void_p] * 3, ctypes.c_int))


def bind_decoder(lib: ctypes.CDLL, prefix: str) -> ctypes.CDLL:
    """Declare the types of a host decoder library's C API (`<prefix>_new`,
    ...); returns the library."""
    for name, argtypes, restype in _API:
        fn = getattr(lib, f"{prefix}_{name}")
        fn.argtypes, fn.restype = argtypes, restype
    for name, argtypes, restype in _API_DEEP:
        fn = getattr(lib, f"{prefix}_{name}", None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def annexb_units(data: bytes) -> list[bytes]:
    """The NAL units of an Annex B byte stream (start code prefixes 00 00 01
    and 00 00 00 01; trailing zero bytes dropped), H.264's or HEVC's."""
    starts = [m.end() for m in re.finditer(rb"\x00\x00\x01", data)]
    units = []
    for k, s in enumerate(starts):
        end = starts[k + 1] - 3 if k + 1 < len(starts) else len(data)
        unit = data[s:end].rstrip(b"\x00")
        if unit:
            units.append(unit)
    return units


class HostDecoder:
    """A host C++ decoder: NAL units in (`push`, with the emulation
    prevention bytes still in), pictures out as cropped (Y', Cb, Cr) planes
    in output order (`pictures`): uint8 at 8 bits, uint16 holding the
    samples themselves at 9 or 10 (where the library exports
    `<prefix>_bit_depth`).  A corrupt unit raises ValueError and one outside
    the decoder's subset `UnsupportedCodecError` naming the feature; after
    either the decoder is spent.  A subclass gives `prefix`,
    `library` (the bound library, built at first use) and `unsupported` (the
    exception for a message of code 2)."""

    prefix: str
    codec: str

    def library(self) -> ctypes.CDLL:
        raise NotImplementedError

    def unsupported(self, msg: str) -> Exception:
        raise NotImplementedError

    def __init__(self):
        self._lib = self.library()
        self._deep = hasattr(self._lib, f"{self.prefix}_bit_depth")
        self._h = self._fn("new")()
        if not self._h:
            raise MemoryError(f"{self.codec}: the decoder could not be created")

    def _fn(self, name: str):
        return getattr(self._lib, f"{self.prefix}_{name}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._fn("free")(self._h)
            self._h = None

    def _check(self, rc: int) -> None:
        if rc == 0:
            return
        msg = self._fn("error")(self._h).decode("utf-8", "replace")
        if rc == 2:
            raise self.unsupported(msg)
        raise ValueError(msg)

    def push(self, unit: bytes) -> None:
        """One NAL unit (no start code)."""
        self._check(self._fn("nal")(self._h, bytes(unit), len(unit)))

    def end_picture(self) -> None:
        """The units pushed so far end an access unit (an MP4 sample)."""
        self._check(self._fn("end_picture")(self._h))

    def flush(self) -> None:
        """The end of the stream: every picture still held goes out."""
        self._check(self._fn("flush")(self._h))

    def pictures(self) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The pictures ready for output, in order."""
        out = []
        w, h = ctypes.c_int32(), ctypes.c_int32()
        while self._fn("ready")(self._h):
            self._fn("frame_size")(self._h, ctypes.byref(w), ctypes.byref(h))
            deep = self._deep and self._fn("bit_depth")(self._h) > 8
            dtype = np.uint16 if deep else np.uint8
            planes = (np.empty((h.value, w.value), dtype),
                      np.empty((h.value // 2, w.value // 2), dtype),
                      np.empty((h.value // 2, w.value // 2), dtype))
            if self._fn("pop16" if deep else "pop")(self._h, *(p.ctypes.data for p in planes)):
                raise ValueError(f"{self.codec}: a picture could not be copied out")
            out.append(planes)
        return out


class SampleFrames(Sequence):
    """The frames of a video track (MP4 / QuickTime, Matroska, AVI,
    MPEG-TS) as (H, W, 3) uint8 RGB, decoded by a host decoder on access
    (`frames[i]`, `len(frames)`, iteration), as cv2 shows them: in output order
    (presentation order, which `ctts` or Matroska's block times give where B
    pictures reorder them; the decoder's own in AVI and MPEG-TS), only
    those the edit list keeps, each turned by the track's display rotation.
    A frame is decoded from the last sync sample that starts its output
    order cleanly (every sample before it shown before it, every one from it
    on after it: no leading picture needs a reference decoded before it),
    or on from the last one decoded."""

    length: int
    params: dict

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        self.path, self.offsets, self.sizes, self.info = path, offsets, sizes, info
        n = len(offsets)
        self.sync = info["sync"] if info.get("sync") is not None else list(range(n))
        # a sample's output position is the rank of its presentation time; a
        # restart at sample s outputs positions s, s + 1, ... where the
        # samples before s are exactly the first s positions
        position = [0] * n
        for k, s in enumerate(mp4.output_order(info.get("times") or list(range(n)))):
            position[s] = k
        sync, prefix_max = set(self.sync), -1
        self.starts = []                       # the sync samples a decode may start at
        for s in range(n):
            if s in sync and prefix_max < s and position[s] == s:
                self.starts.append(s)
            prefix_max = max(prefix_max, position[s])
        self.shown = info.get("shown") or list(range(n))
        self.start_outputs = self.starts       # the output position each start's decode opens at
        self.rotation = info.get("rotation", 0)
        self._decoder = None
        self._pushed = self._next = -1      # the last sample pushed, the next frame out
        self._held: dict[int, tuple[np.ndarray, ...]] = {}

    # ── what a codec gives ──
    def header_units(self) -> list[bytes]:
        raise NotImplementedError

    def new_decoder(self) -> HostDecoder:
        raise NotImplementedError

    def rgb_of(self, planes: tuple[np.ndarray, ...]) -> np.ndarray:
        raise NotImplementedError

    # ── the reader ──
    def __len__(self) -> int:
        return len(self.shown)

    def in_band_starts(self, kind: Callable[[bytes], int],
                       starts_at: Callable[[list[list[int]], int], bool],
                       silent: Callable[[list[list[int]]], set[int]] = lambda kinds: set()
                       ) -> None:
        """Set the samples a decode may restart at in a track with no sync
        table (AVI, MPEG-TS): those `starts_at(kinds, s)` accepts, `kinds`
        being the NAL unit types (`kind`) of every sample, read from the
        file; the samples `silent(kinds)` names output no picture (RASL
        pictures FFmpeg drops, samples of no picture), nor do those before
        the first restart (pictures FFmpeg's decoder drops until it meets
        one), so that the frames and the output positions of the restarts
        leave them out."""
        kinds = [[kind(u) for u in self.units(s)] for s in range(len(self.offsets))]
        self.sync = self.starts = [s for s in range(len(kinds)) if starts_at(kinds, s)]
        first = self.starts[0] if self.starts else len(kinds)
        quiet = silent(kinds) | set(range(first))
        self.shown = list(range(len(kinds) - len(quiet)))
        self.start_outputs = [s - sum(q < s for q in quiet) for s in self.starts]

    def units(self, i: int) -> list[bytes]:
        """The NAL units of sample i."""
        with open(self.path, "rb") as f:
            data = container.read_sample(f, self.offsets[i], self.sizes[i], self.info)
        if self.length == 0:                       # an Annex B byte stream
            if len(data) < self.sizes[i] + len(self.info.get("prefix", b"")):
                raise ValueError(f"{self.path}: frame {i} is cut short")
            return annexb_units(data)
        out, pos = [], 0
        while pos < len(data):
            size = int.from_bytes(data[pos:pos + self.length], "big")
            pos += self.length
            if size == 0 or pos + size > len(data):
                raise ValueError(f"{self.path}: frame {i} is cut short")
            out.append(data[pos:pos + size])
            pos += size
        return out

    def ycbcr(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Frame i as decoded (before the rotation): Y', Cb, Cr planes (uint8,
        or uint16 above 8 bits)."""
        if not -len(self) <= i < len(self):
            raise IndexError(f"{self.path}: frame {i} of {len(self)}")
        return self._picture(self.shown[i % len(self)])

    def _picture(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The i-th picture the decoder outputs: the sample with the i-th
        smallest presentation time."""
        n = len(self.offsets)
        if i in self._held:
            return self._held[i]
        k = bisect.bisect_right(self.start_outputs, i) - 1
        if k < 0:
            raise ValueError(f"{self.path}: frame {i} follows no sync sample")
        start = self.starts[k]
        if self._decoder is None or i < self._next or start > self._pushed:
            self._decoder = self.new_decoder()
            for unit in self.header_units():
                self._decoder.push(unit)
            self._pushed, self._next = start - 1, self.start_outputs[k]
        self._held = {j: p for j, p in self._held.items() if j >= i}
        while i not in self._held:
            if self._pushed + 1 < n:
                self._pushed += 1
                container.check_whole(self.path, self.info, self._pushed)
                for unit in self.units(self._pushed):
                    self._decoder.push(unit)
                self._decoder.end_picture()
            elif self._pushed + 1 == n:
                self._pushed += 1
                self._decoder.flush()
            else:
                raise ValueError(f"{self.path}: the stream holds {self._next} pictures, not "
                                 f"{n}")
            for planes in self._decoder.pictures():
                if self._next >= i:
                    self._held[self._next] = planes
                self._next += 1
        return self._held[i]

    def __getitem__(self, i: int) -> np.ndarray:
        rgb = self.rgb_of(self.ycbcr(i))
        return np.ascontiguousarray(np.rot90(rgb, -self.rotation // 90))

    rgb = __getitem__

    def probe(self) -> dict:
        """{"width", "height", "fps", "frame_count"} as cv2 reports them, with
        no decode: the size after cropping and the rotation, fps from the
        track, else the VUI, else 30.0, and the count of samples (the edit
        list aside)."""
        w, h = self.params["width"], self.params["height"]
        if self.rotation in (90, 270):
            w, h = h, w
        return {"width": w, "height": h, "fps": self.info["fps"] or self.params["fps"] or 30.0,
                "frame_count": self.info["frame_count"]}

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]
