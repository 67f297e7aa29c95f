"""Image read/write, frame extraction and video stitching, without OpenCV.

Port of `omfs4d.io.video` (`probe_video`, `extract_frames`, `read_image`,
`write_image`, `find_ffmpeg`, `ffmpeg_stitch_cmd`, `stitch_video`).  PNG is encoded and decoded here with
the standard library's `zlib` and `struct` plus numpy: 8-bit grayscale,
grayscale+alpha, RGB and RGBA, non-interlaced, all five row filters on read
(undone by the host C++ `pngfilter.cpp`, built by g++ at first use; a
failed build raises).
That reads what the JAX package wrote with cv2, and cv2 reads what this
module writes.

`read_image` also reads baseline JPEG, through the port's own decoder
(`omfs4d_torch.io.jpeg`), as the reference reads it through cv2.
`probe_video` and `extract_frames` take a directory of PNG or JPEG frames as
the capture (`capture_frames`), or a video file.

Video files follow the reference's ladder as far as the port can climb it.
With an ffmpeg binary (`find_ffmpeg`) a file is decoded by ffmpeg and
`stitch_video` encodes H.264 (libx264 yuv420p CRF 18, the reference's encode
contract).  With none, the port's own codecs:
- `stitch_video` writes the ladder's first rung, H.264 (`avc1`) in MP4, from
  `omfs4d_torch.io.h264` (Constrained Baseline, QP `h264.H264_QP` = 18, the
  contract's CRF), for any suffix but `.avi`; an `.avi` gets the last rung,
  Motion JPEG (every frame a baseline JPEG of quality 95 from `encode_jpeg`),
  so that the port's own AVI captures stay readable where there is no
  ffmpeg; so do frames H.264 cannot hold (an odd side, beyond level 5.2).
- `probe_video` / `extract_frames` index the file once
  (`omfs4d_torch.io.container`: AVI, MP4 / QuickTime, Matroska / WebM,
  MPEG-TS and M2TS, MPEG-PS, ASF, each found by its content whatever the
  suffix) and read
  it with its codec's module, in any of the containers: Motion
  JPEG (`mjpeg.MJPEGFrames`: each frame as FFmpeg's MJPEG decoder and
  swscale give it to cv2, `mjpeg.frame_rgb`, where a JPEG file is read as
  libjpeg reads it, `decode_jpeg`); H.264 Main / High profile I, P and B
  pictures, as phones record them in MP4 or QuickTime, x264 writes them
  into Matroska and, as Annex B, into AVI (`h264.H264Frames`, the host C++
  decoder built by g++ at first use), turned by the track's display matrix
  (Matroska's projection) and cut by its edit list as cv2 reads them, and
  from an AVCHD camcorder's, a broadcast capture's or an HLS segment's
  transport stream (`omfs4d_torch.io.mpegts`, split into frames as FFmpeg's
  parsers split it); HEVC
  Main and Main 10 profiles, as iPhones record by default (Main 10 with
  "HDR Video") and x265 writes, read alike (`hevc.HEVCFrames`, the host C++
  decoder `hevcdec.cpp`); MPEG-4 Part 2 Simple and Advanced Simple profile,
  as cv2's `mp4v`, `XVID`, `DIVX` and `FMP4` writers (and so the JAX
  package's `stitch_video` without an H.264 encoder, into `.mp4`, `.avi` or
  `.mkv`) and Xvid and DivX (B-VOPs, packed bitstreams, quarter-sample, MPEG
  quantisation) write it (`mpeg4.MPEG4Frames`, the host C++ decoder
  `mpeg4dec.cpp`); VP8, as a browser's `MediaRecorder` writes it into WebM
  and cv2's `VP80` writer into WebM, Matroska and AVI (`vp8.VP8Frames`, the
  host C++ decoder `vp8dec.cpp`); VP9 profile 0, as a browser's
  `MediaRecorder` or YouTube writes it into WebM and cv2's `VP90` writer into
  WebM, Matroska, AVI and MP4 (`vp9.VP9Frames`, the host C++ decoder
  `vp9dec.cpp`); MPEG-1 and MPEG-2 4:2:0 frame pictures, progressive or
  interlaced, as cv2's `MPG1` / `PIM1` / `MPG2` writers put them into MPEG-PS
  (`.mpg`, `.mpeg`, `.vob`; `omfs4d_torch.io.mpegps`), MPEG-TS, AVI,
  Matroska, MP4 and QuickTime, and as DVDs and broadcast captures hold them
  (`mpeg2.MPEG2Frames`, the host C++ decoder `mpeg2dec.cpp`); MS MPEG-4 v2
  and v3 (DivX 3) and WMV1 / WMV2 (WMV 7 / 8), as cv2's `MP42`, `MP43` /
  `DIV3`, `WMV1` and `WMV2` writers put them into ASF (`.wmv`, `.asf`;
  `omfs4d_torch.io.asf`), AVI and Matroska and as Windows capture tools and
  DivX 3 wrote them (`msmpeg4.MSMPEG4Frames`, the host C++ decoder
  `msmpeg4dec.cpp`); raw video, PNG, HuffYUV and FFV1, as cv2's writers
  put them into AVI, Matroska, QuickTime and MP4 and as capture cards,
  editors and archives write them (`rawvideo.RawFrames`, `PNGFrames`,
  `huffyuv.HuffYUVFrames`, `ffv1.FFV1Frames`; the host C++ decoders
  `huffyuvdec.cpp` and `ffv1dec.cpp`), and VP8 / VP9 in IVF.  Every reader
  converts to 8-bit RGB as cv2 does:
  swscale's own conversion bit for bit (`swscale`; 8-bit 4:2:0 on its
  unscaled path, 10-bit pictures, odd heights and JPEG's other samplings on
  its scaled one), and cv2's gamut and tone mapping of BT.2020 / PQ / HLG
  tagged streams (`colour`).  HEVC beyond Main 10 (more than 10 bits, tiles
  with WPP, ...), H.264 with fields or more than 8 bits, MPEG-4 Part 2
  sprites / GMC, interlacing or data partitioning, VP9 beyond profile 0 or
  with references of another size, MPEG-2 field pictures and 4:2:2, WMV2's
  IntraX8 pictures, MS MPEG-4 v1, WMV 9 / VC-1, FFV1 above 10 bits and
  other codecs (AV1, UtVideo, JPEG-LS, ...)
  raise `container.UnsupportedCodecError` naming the
  codec or feature.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

from omfs4d_torch.core.logging import get_logger
from omfs4d_torch.io import (container, ffv1, h264, hevc, huffyuv, mjpeg, mpeg2, mpeg4, msmpeg4,
                             rawvideo, vp8, vp9)
from omfs4d_torch.io.jpeg import decode_jpeg, encode_jpeg

log = get_logger("video")

# the JPEG quality of the MJPG rung's frames
MJPEG_QUALITY = 95

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_UNFILTER_SOURCE = Path(__file__).resolve().with_name("pngfilter.cpp")

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}          # PNG colour type -> channels
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


class NoFFmpegError(RuntimeError):
    """No ffmpeg binary was found and neither of the port's rungs can hold the
    frames (a side over JPEG's 65,535 pixels and beyond H.264's levels):
    nothing can be written."""


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8, C in {1, 2, 3, 4} -> PNG bytes.  Every row
    uses the Sub filter (byte minus the same channel of the pixel to its
    left), which is vectorized and compresses smooth renders well."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    H, W, C = arr.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f"encode_png: {C} channels; expected 1, 2, 3 or 4")
    rows = arr.reshape(H, W * C)
    sub = rows.copy()
    sub[:, C:] -= rows[:, :-C]                 # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.ones((H, 1), np.uint8), sub], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


@functools.cache
def _unfilter_library() -> ctypes.CDLL:
    """Build (at first use, with g++, into `omfs4d_torch/_build/`) and load
    the host PNG unfilter (`pngfilter.cpp`); raises RuntimeError with g++'s
    message when it cannot: no PNG is unfiltered in Python on the reading
    path."""
    from omfs4d_torch import native

    path = native.build(_UNFILTER_SOURCE, "pngfilter", ("-std=c++17", "-O2", "-shared", "-fPIC"),
                        "omfs4d_torch/io/pngfilter.cpp (the PNG row unfilter)")
    lib = ctypes.CDLL(str(path))
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_void_p]
    return lib


def unfilter(raw: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """A PNG image's inflated data (each row its filter byte, then
    `rowbytes` bytes) -> the (height, rowbytes) uint8 samples, every row's
    filter undone by the host C++ (`pngfilter.cpp`); ValueError for data of
    the wrong size or an unknown filter type."""
    if len(raw) < height * (rowbytes + 1):
        raise ValueError(f"PNG: {len(raw)} bytes of image data, fewer than the "
                         f"{height * (rowbytes + 1)} of {height} rows")
    out = np.empty((height, rowbytes), np.uint8)
    rc = _unfilter_library().png_unfilter(raw, height, rowbytes, bpp, out.ctypes.data)
    if rc:
        raise ValueError(f"PNG: unknown row filter {raw[(rc - 1) * (rowbytes + 1)]} in row "
                         f"{rc - 1}")
    return out


def _unfilter_row(ft: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One row's filter undone in numpy and Python: the plain version of
    `unfilter`, which the tests hold the C++ to."""
    if ft == 0:
        return line
    if ft == 1:   # Sub: running sum along the row, per channel
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if ft == 2:   # Up
        return line + prev
    if ft not in (3, 4):
        raise ValueError(f"PNG: unknown row filter {ft}")
    # Average and Paeth depend on the decoded byte to the left: walk the row
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ft == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C = 1 (gray), 2 (gray+alpha), 3 (RGB)
    or 4 (RGBA)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    W, H, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG: bit depth {depth}, colour type {color_type}, "
                         f"interlace {interlace} not supported (8-bit gray, "
                         "gray+alpha, RGB, RGBA; not interlaced)")
    C = _CHANNELS[color_type]
    return unfilter(zlib.decompress(b"".join(idat)), H, W * C, C).reshape(H, W, C)


def decode_image(data: bytes) -> np.ndarray:
    """PNG or JPEG bytes, told apart by their first bytes, -> (H, W, C)
    uint8: C as `decode_png` gives it, 1 or 3 for a JPEG."""
    if data[:8] == _PNG_SIGNATURE:
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        img = decode_jpeg(data)
        return img[..., None] if img.ndim == 2 else img
    raise ValueError("neither a PNG nor a JPEG file")


def read_image(path: str | Path) -> np.ndarray:
    """Read a PNG or JPEG image as (H, W, 3) uint8 RGB (gray is repeated,
    alpha dropped)."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"cannot read image: {path}")
    return _rgb(decode_image(p.read_bytes()))


def _rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 as (H, W, 3) RGB: grey repeated, alpha dropped."""
    if img.shape[2] <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def write_image(path: str | Path, rgb: np.ndarray) -> None:
    """Write (H, W) gray or (H, W, 3) RGB as PNG.  Floats with max <= 1.5
    are scaled by 255; values are clipped and truncated to uint8."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.5 else arr, 0, 255).astype(np.uint8)
    if not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"write_image: shape {arr.shape}; expected (H, W) or (H, W, 3)")
    Path(path).write_bytes(encode_png(arr))


def area_resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Shrink (H, W, C) uint8 by area averaging (each output pixel is the mean
    of the input area it covers, fractional overlaps weighted: OpenCV's
    INTER_AREA), rounded to uint8."""
    def weights(n_in: int, n_out: int) -> np.ndarray:
        edges = np.linspace(0.0, n_in, n_out + 1)
        lo, hi = edges[:-1, None], edges[1:, None]
        cells = np.arange(n_in)[None, :]
        overlap = np.clip(np.minimum(hi, cells + 1) - np.maximum(lo, cells), 0.0, None)
        return overlap / overlap.sum(axis=1, keepdims=True)

    x = np.asarray(img, np.float64)
    h, w = x.shape[:2]
    x = (weights(h, height) @ x.reshape(h, -1)).reshape((height, w) + x.shape[2:])
    x = np.swapaxes(x, 0, 1)                       # (W, height, C): the same product by column
    x = (weights(w, width) @ x.reshape(w, -1)).reshape((width, height) + x.shape[2:])
    return np.clip(np.rint(np.swapaxes(x, 0, 1)), 0, 255).astype(np.uint8)


def linear_resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize (H, W, C) uint8 by bilinear interpolation between pixel centres,
    the edge pixel repeated outside (OpenCV's INTER_LINEAR, `cv2.resize`'s
    default), rounded to uint8."""
    def taps(n_in: int, n_out: int):
        x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        lo = np.floor(x).astype(np.int64)
        frac = np.where(lo < 0, 0.0, x - lo)
        lo = np.clip(lo, 0, n_in - 1)
        frac = np.where(lo >= n_in - 1, 0.0, frac)
        return lo, np.minimum(lo + 1, n_in - 1), frac

    y0, y1, fy = taps(img.shape[0], height)
    x0, x1, fx = taps(img.shape[1], width)
    a = np.asarray(img, np.float64)
    rows = a[y0] * (1 - fy)[:, None, None] + a[y1] * fy[:, None, None]
    out = rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def capture_frames(path: str | Path) -> list[Path]:
    """The frames of a directory capture (its `images/` when it has one):
    its PNG frames sorted by name, then its JPEG frames (`*.jpg`, then
    `*.jpeg`) sorted by name, as the reference's landmark sources list them."""
    path = Path(path)
    images = path / "images" if (path / "images").is_dir() else path
    frames = [f for ext in ("png", "jpg", "jpeg") for f in sorted(images.glob(f"*.{ext}"))]
    if not frames:
        raise FileNotFoundError(f"no PNG or JPEG frames under {images}")
    return frames


def _decode_with_ffmpeg(video_path: Path, out_dir: Path, ffmpeg_bin: str) -> list[Path]:
    """Every frame of a video file as a PNG under `out_dir`, through ffmpeg."""
    out_dir.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([ffmpeg_bin, "-y", "-i", str(video_path), "-vsync", "0",
                          str(out_dir / "%05d.png")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"ffmpeg failed:\n{res.stderr[-2000:]}")
    return sorted(out_dir.glob("*.png"))


def probe_video(path: str | Path) -> dict:
    """Width, height, fps and frame count of a capture: a directory of PNG or
    JPEG frames (fps is then the 30.0 the reference assumes), or a video file,
    read through ffmpeg when there is a binary and, when there is none, as
    Motion JPEG, H.264 (Main / High, I, P and B pictures), HEVC (Main and
    Main 10), MPEG-4 Part 2 (Simple, Advanced Simple), VP8, VP9, MPEG-1 /
    MPEG-2, the Windows family, raw video, PNG, HuffYUV or FFV1 in AVI, MP4
    / QuickTime, Matroska / WebM, IVF, MPEG-TS, MPEG-PS or ASF,
    with no decode: the size as displayed (turned by the track's
    matrix), the fps and the frame count as cv2 reports them
    (`container.UnsupportedCodecError` for another codec)."""
    import re

    p = Path(path)
    if p.is_dir():
        frames = capture_frames(p)
        h, w = decode_image(frames[0].read_bytes()).shape[:2]
        return {"width": w, "height": h, "fps": 30.0, "frame_count": len(frames)}
    if not p.is_file():
        raise FileNotFoundError(f"no capture at {path}")
    ffmpeg_bin = find_ffmpeg()
    if ffmpeg_bin is None:
        return _own_reader(p).probe()
    # ffmpeg with no output file prints the stream description and exits non-zero
    text = subprocess.run([ffmpeg_bin, "-hide_banner", "-i", str(p)], capture_output=True,
                          text=True).stderr
    size = re.search(r"Video:.*?\b(\d{2,5})x(\d{2,5})\b", text)
    if size is None:
        raise RuntimeError(f"{path}: ffmpeg found no video stream:\n{text[-2000:]}")
    rate = re.search(r"([\d.]+) fps", text)
    dur = re.search(r"Duration: (\d+):(\d+):([\d.]+)", text)
    fps = float(rate.group(1)) if rate else 30.0
    seconds = (int(dur.group(1)) * 3600 + int(dur.group(2)) * 60 + float(dur.group(3))
               if dur else 0.0)
    return {"width": int(size.group(1)), "height": int(size.group(2)), "fps": fps or 30.0,
            "frame_count": int(round(seconds * fps))}


def extract_frames(
    video_path: str | Path,
    output_dir: str | Path,
    target_size: int = 0,
    max_frames: int = 0,
    stride: int = 1,
) -> list[Path]:
    """Turn a capture (a directory of PNG or JPEG frames, or a video file:
    through ffmpeg when there is a binary, else Motion JPEG, H.264 Main /
    High I, P and B pictures, HEVC Main / Main 10, MPEG-4 Part 2 (Simple,
    Advanced Simple), VP8, VP9, MPEG-1 / MPEG-2, the Windows family, raw
    video, PNG, HuffYUV or FFV1 in AVI, MP4 / QuickTime, Matroska / WebM,
    IVF, MPEG-TS, MPEG-PS or ASF, upright and edited as cv2 shows
    them) into numbered PNG frames (RGB), every `stride`-th one, at most
    `max_frames`, shrunk by area averaging so that min(H, W) ~ target_size.
    A Motion JPEG file's frames are decoded only where they are kept; any
    other codec's in order up to the last one kept."""
    import tempfile

    src = Path(video_path)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="decode_") as tmp:
        if src.is_dir():
            frames = capture_frames(src)
        elif not src.is_file():
            raise FileNotFoundError(f"no capture at {video_path}")
        elif (ffmpeg_bin := find_ffmpeg()) is not None:
            frames = _decode_with_ffmpeg(src, Path(tmp), ffmpeg_bin)
        else:
            frames = _own_reader(src)
        files = isinstance(frames, list)                # of PNG / JPEG paths
        paths = []
        for i in range(0, len(frames), max(stride, 1)):
            frame = read_image(frames[i]) if files else frames.rgb(i)
            if target_size > 0:
                h, w = frame.shape[:2]
                scale = target_size / min(h, w)
                if scale < 1.0:
                    frame = area_resize(frame, int(round(h * scale)), int(round(w * scale)))
            p = out / f"{len(paths):05d}.png"
            write_image(p, frame)
            paths.append(p)
            if max_frames and len(paths) >= max_frames:
                break
    return paths


class PNGFrames(rawvideo.IntraFrames):
    """The frames of a PNG video track (AVI `MPNG`, QuickTime `png `, MP4
    `mp4v` of objectTypeIndication 0x6D, Matroska), one PNG a sample,
    through `decode_png`: grey repeated, alpha dropped, as cv2 shows them."""

    def decode(self, data: bytes) -> np.ndarray:
        return _rgb(decode_png(data))


_READERS = {"h264": h264.H264Frames, "hevc": hevc.HEVCFrames, "mpeg4": mpeg4.MPEG4Frames,
            "vp8": vp8.VP8Frames, "vp9": vp9.VP9Frames, "mpeg2": mpeg2.MPEG2Frames,
            "msmpeg4": msmpeg4.MSMPEG4Frames, "raw": rawvideo.RawFrames, "png": PNGFrames,
            "huffyuv": huffyuv.HuffYUVFrames, "ffv1": ffv1.FFV1Frames, "mjpeg": mjpeg.MJPEGFrames}


def _own_reader(path: Path) -> (h264.H264Frames | hevc.HEVCFrames | mpeg4.MPEG4Frames
                                | vp8.VP8Frames | vp9.VP9Frames | mpeg2.MPEG2Frames
                                | msmpeg4.MSMPEG4Frames | rawvideo.IntraFrames
                                | mjpeg.MJPEGFrames):
    """A video file's frames through the port's own readers, with no ffmpeg:
    the file is indexed once and read by its codec's module."""
    offsets, sizes, info = container.index(path)
    return _READERS[info["codec"]](path, offsets, sizes, info)


def find_ffmpeg() -> str | None:
    """Locate an ffmpeg binary: PATH first, then the imageio_ffmpeg wheel."""
    exe = shutil.which("ffmpeg")
    if exe:
        return exe
    try:
        import imageio_ffmpeg
    except ImportError:
        return None
    return imageio_ffmpeg.get_ffmpeg_exe()


def ffmpeg_stitch_cmd(ffmpeg_bin: str, pattern: str, output_path: str,
                      fps: int, crf: int = 18) -> list[str]:
    """The reference's H.264 encode invocation: libx264, yuv420p, preset
    medium, CRF 18."""
    return [
        ffmpeg_bin, "-y",
        "-framerate", str(fps),
        "-i", pattern,
        "-c:v", "libx264",
        "-pix_fmt", "yuv420p",
        "-preset", "medium",
        "-crf", str(crf),
        str(output_path),
    ]


def stitch_video(frames_dir: str | Path, output_path: str | Path, fps: int = 30) -> Path:
    """Stitch sorted PNG frames into a video, down the reference's ladder.
    With an ffmpeg binary: H.264 (libx264 yuv420p CRF 18); RuntimeError when
    ffmpeg fails.  With none: H.264 (`avc1`) in MP4 from the port's own
    encoder, the ladder's first rung, for any suffix but `.avi`; MJPG (each
    frame a baseline JPEG of quality `MJPEG_QUALITY`), the last rung, in an
    AVI file for a `.avi` suffix, and in an MP4 file where H.264 cannot hold
    the frames.  A frame of another size is first resized to the first
    frame's.  Raises `NoFFmpegError` (a RuntimeError) only where nothing can
    be written: no ffmpeg and frames too large for either rung."""
    import tempfile

    frames = sorted(Path(frames_dir).glob("*.png"))
    if not frames:
        raise FileNotFoundError(f"No PNG frames in {frames_dir}")
    out_path = Path(output_path)
    ffmpeg_bin = find_ffmpeg()
    if ffmpeg_bin is None:
        return _stitch_own(frames, out_path, fps)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="stitch_") as tmp:
        for i, src in enumerate(frames):
            shutil.copy2(src, Path(tmp) / f"frame_{i:05d}.png")
        cmd = ffmpeg_stitch_cmd(
            ffmpeg_bin, str(Path(tmp) / "frame_%05d.png"), str(out_path), fps)
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"ffmpeg failed:\n{res.stderr[-2000:]}")
    return out_path


def _stitch_own(frames: list[Path], out_path: Path, fps: float) -> Path:
    """The frames through the port's own encoders, with no ffmpeg: H.264 in
    MP4, or MJPG for an `.avi` and where H.264 cannot hold the frames."""
    h, w = read_image(frames[0]).shape[:2]

    def images():
        for p in frames:
            img = read_image(p)
            yield img if img.shape[:2] == (h, w) else linear_resize(img, h, w)

    if container.container_of(out_path) == "avi":
        why = "the .avi container keeps MJPG, the port's own AVI rung"
    else:
        why = h264.unsupported_size(w, h, fps)
        if why is None:
            log.info(f"stitch_video: no ffmpeg binary: writing H.264 (avc1, the ladder's first "
                     f"rung; the port's Constrained Baseline encoder, QP {h264.H264_QP}) into "
                     f"MP4 {out_path}")
            return h264.write(out_path, images(), fps, w, h)
        why = f"H.264 cannot hold the frames: {why}"
    if max(h, w) > 65535:
        raise NoFFmpegError(
            f"stitch_video: no ffmpeg binary on PATH or from imageio_ffmpeg; {why}, and the "
            f"MJPG rung cannot hold {w} x {h} frames (JPEG's sides end at 65,535); the "
            f"frames are in {frames[0].parent}")
    log.info(f"stitch_video: no ffmpeg binary, and {why}: writing MJPG (the ladder's last "
             f"rung, JPEG quality {MJPEG_QUALITY}) into "
             f"{container.container_of(out_path).upper()} {out_path}")
    return mjpeg.write(out_path, (encode_jpeg(img, MJPEG_QUALITY) for img in images()),
                       fps, w, h)
