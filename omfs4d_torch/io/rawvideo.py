"""Raw video read on the host as FFmpeg's `rawvideo` decoder gives it to cv2,
and what the port's intra-only readers share (`IntraFrames`: one frame a
sample, each decoded alone).

`RawFrames` reads the pixel formats cv2 writes and shows, by their AVI /
Matroska fourcc (`container.RAW_TAGS`):

- `I420` / `IYUV`: 8-bit 4:2:0, the Y', Cb and Cr planes one after another,
  each row as wide as its plane (chroma half the size, rounded up), as
  `av_image_fill_arrays` lays them out; `YV12` the same with Cr before Cb.
  Converted by swscale (`swscale.to_rgb`: BT.601, limited range).
- `Y800` / `GREY` / `Y8  `: 8-bit grey, shown as B = G = R = the stored
  byte (swscale's palette path: no range expansion).  cv2's own `Y800`
  writer stores a whole I420 frame, whose Y' plane is read.  A row is
  padded to 4 bytes where the sample holds that much, as FFmpeg pads the
  rows of GRAY8 (and of BGR24) in a large enough packet.
- `RGBA`: R, G, B, A bytes, top-down (cv2's writer; QuickTime's `RGBA`
  entry too); alpha is dropped.
- compression 0 (BI_RGB): B, G, R at 24 bits (rows padded to 4 bytes) or
  B, G, R, A at 32, bottom-up where the AVI's biHeight > 0 (FFmpeg's AVI
  demuxer flags it `BottomUp`), as DirectShow capture and VirtualDub
  write it.

A sample shorter than its frame shows no frame in cv2 and raises here.
"""

from __future__ import annotations

from collections.abc import Iterator, Sequence
from pathlib import Path

import numpy as np

from omfs4d_torch.io import container, swscale

# FFmpeg's raw formats of the fourccs the port reads: (layout, bytes a pixel)
_FORMATS = {b"I420": "yuv420p", b"IYUV": "yuv420p", b"YV12": "yvu420p", b"Y800": "gray8",
            b"GREY": "gray8", b"Y8  ": "gray8", b"RGBA": "rgba"}


class IntraFrames(Sequence):
    """The frames of a track whose every sample is a picture of its own
    (raw video, PNG, HuffYUV), as (H, W, 3) uint8 RGB decoded on access
    (`frames[i]`, `len(frames)`, iteration), one a sample in the file's
    order; an empty sample (a frame an AVI writer dropped) shows none but
    counts in the probe, as cv2 counts it.  A subclass gives `decode(data)`,
    a sample's bytes to its RGB frame."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        self.path, self.offsets, self.sizes, self.info = Path(path), offsets, sizes, info
        self.width, self.height = info["width"], info["height"]
        if not (0 < self.width <= 16384 and 0 < self.height <= 16384):
            raise ValueError(f"{path}: a frame of {self.width} x {self.height}")
        self.samples = [k for k, s in enumerate(sizes) if s]

    def decode(self, data: bytes) -> np.ndarray:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.samples)

    def sample(self, i: int) -> bytes:
        """The bytes of frame i's sample."""
        n = len(self)
        if not -n <= i < n:
            raise IndexError(f"{self.path}: frame {i} of {n}")
        k = self.samples[i % n]
        with open(self.path, "rb") as f:
            data = container.read_sample(f, self.offsets[k], self.sizes[k], self.info)
        if len(data) != len(self.info.get("prefix", b"")) + self.sizes[k]:
            raise ValueError(f"{self.path}: frame {i} is cut short")
        return data

    def __getitem__(self, i: int) -> np.ndarray:
        data = self.sample(i)
        try:
            return self.decode(data)
        except ValueError as e:
            raise ValueError(f"{self.path}: frame {i}: {e}") from None

    rgb = __getitem__

    def probe(self) -> dict:
        """{"width", "height", "fps", "frame_count"} as cv2 reports them, with
        no decode: the container's size, rate and count."""
        return {"width": self.width, "height": self.height, "fps": self.info["fps"] or 30.0,
                "frame_count": self.info["frame_count"]}

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]


def frame_size(fmt: str, width: int, height: int) -> int:
    """The bytes of one frame of a raw format, rows unpadded."""
    if fmt in ("yuv420p", "yvu420p"):
        return width * height + 2 * ((width + 1) // 2) * ((height + 1) // 2)
    return width * height * {"gray8": 1, "rgba": 4, "bgr24": 3, "bgra": 4}[fmt]


def decode_raw(data: bytes, fmt: str, width: int, height: int,
               bottom_up: bool = False) -> np.ndarray:
    """One raw frame of FFmpeg's pixel format `fmt` ("yuv420p", "yvu420p",
    "gray8", "rgba", "bgr24", "bgra") -> (H, W, 3) uint8 RGB as cv2 shows
    it; ValueError for a sample shorter than the frame."""
    need = frame_size(fmt, width, height)
    if len(data) < need:
        raise ValueError(f"a raw {fmt} sample of {len(data)} bytes, fewer than the frame's "
                         f"{need}")
    buf = np.frombuffer(data, np.uint8)
    if fmt in ("yuv420p", "yvu420p"):
        cw, ch = (width + 1) // 2, (height + 1) // 2
        y = buf[:width * height].reshape(height, width)
        a = buf[width * height:width * height + cw * ch].reshape(ch, cw)
        b = buf[width * height + cw * ch:need].reshape(ch, cw)
        cb, cr = (b, a) if fmt == "yvu420p" else (a, b)
        return swscale.to_rgb(y, cb, cr, 8, 2, False, swscale.CENTER)
    bpp = {"gray8": 1, "rgba": 4, "bgr24": 3, "bgra": 4}[fmt]
    stride = width * bpp
    if fmt in ("gray8", "bgr24") and -(-stride // 4) * 4 * height <= len(data):
        stride = -(-stride // 4) * 4          # FFmpeg's 4-byte row alignment
    rows = buf[:stride * height].reshape(height, stride)[:, :width * bpp]
    if bottom_up:
        rows = rows[::-1]
    px = rows.reshape(height, width, bpp)
    if fmt == "gray8":
        return np.repeat(px, 3, axis=2)
    if fmt == "rgba":
        return np.ascontiguousarray(px[..., :3])
    return np.ascontiguousarray(px[..., 2::-1])                    # B, G, R (, A)


class RawFrames(IntraFrames):
    """The frames of a raw video track (AVI, Matroska `V_UNCOMPRESSED`,
    QuickTime `RGBA`), as cv2 shows them."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        super().__init__(path, offsets, sizes, info)
        tag, bits = info["fourcc"], info.get("bits", 0)
        if tag == b"\0\0\0\0":
            if bits not in (24, 32):
                raise container.UnsupportedCodecError(
                    f"{path}: its video is raw BI_RGB at {bits} bits a pixel; the port reads "
                    "24 and 32; decoding this needs an ffmpeg binary (on PATH or from "
                    "imageio_ffmpeg)")
            self.fmt = "bgr24" if bits == 24 else "bgra"
        else:
            self.fmt = _FORMATS[tag]
        self.bottom_up = bool(info.get("bottom_up"))

    def decode(self, data: bytes) -> np.ndarray:
        return decode_raw(data, self.fmt, self.width, self.height, self.bottom_up)

