"""Image read/write, frame extraction and video stitching, without OpenCV.

Port of `omfs4d.io.video` (`probe_video`, `extract_frames`, `read_image`,
`write_image`, `find_ffmpeg`, `ffmpeg_stitch_cmd`, `stitch_video`).  PNG is encoded and decoded here with
the standard library's `zlib` and `struct` plus numpy: 8-bit grayscale,
grayscale+alpha, RGB and RGBA, non-interlaced, all five row filters on read.
That reads what the JAX package wrote with cv2, and cv2 reads what this
module writes.  Stitching needs an ffmpeg binary (libx264 yuv420p CRF 18,
the reference's encode contract); there is no cv2 codec ladder.

`read_image` also reads baseline JPEG, through the port's own decoder
(`omfs4d_torch.io.jpeg`), as the reference reads it through cv2.
`probe_video` and `extract_frames` take a directory of PNG or JPEG frames as
the capture (`capture_frames`).  A video file needs a decoder: it goes
through an ffmpeg binary when `find_ffmpeg` finds one, else the call raises
and says why.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

from omfs4d_torch.io.jpeg import decode_jpeg

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}          # PNG colour type -> channels
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


class NoFFmpegError(RuntimeError):
    """No ffmpeg binary was found: the frames cannot be stitched into a video."""


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


def _unfilter_row(ft: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
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
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(H, 1 + W * C)
    out = np.empty((H, W * C), np.uint8)
    prev = np.zeros(W * C, np.uint8)
    for y in range(H):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, C)
    return out.reshape(H, W, C)


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
    img = decode_image(p.read_bytes())
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
    x = np.einsum("oh,hwc->owc", weights(x.shape[0], height), x)
    x = np.einsum("ow,hwc->hoc", weights(x.shape[1], width), x)
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


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


def _decode_with_ffmpeg(video_path: Path, out_dir: Path) -> list[Path]:
    """Every frame of a video file as a PNG under `out_dir`, through ffmpeg."""
    ffmpeg_bin = find_ffmpeg()
    if ffmpeg_bin is None:
        raise RuntimeError(
            f"{video_path}: decoding a video file needs an ffmpeg binary (none on PATH or "
            "from imageio_ffmpeg); pass a directory of PNG or JPEG frames instead")
    out_dir.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([ffmpeg_bin, "-y", "-i", str(video_path), "-vsync", "0",
                          str(out_dir / "%05d.png")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"ffmpeg failed:\n{res.stderr[-2000:]}")
    return sorted(out_dir.glob("*.png"))


def probe_video(path: str | Path) -> dict:
    """Width, height, fps and frame count of a capture: a directory of PNG or
    JPEG frames (fps is then the 30.0 the reference assumes), or a video file
    read through ffmpeg."""
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
        raise RuntimeError(
            f"{path}: probing a video file needs an ffmpeg binary (none on PATH or from "
            "imageio_ffmpeg); pass a directory of PNG or JPEG frames instead")
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
    """Turn a capture (a directory of PNG or JPEG frames, or a video file
    when there is an ffmpeg binary) into numbered PNG frames (RGB), every `stride`-th
    one, at most `max_frames`, shrunk by area averaging so that
    min(H, W) ~ target_size."""
    import tempfile

    src = Path(video_path)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="decode_") as tmp:
        if src.is_dir():
            frames = capture_frames(src)
        elif src.is_file():
            frames = _decode_with_ffmpeg(src, Path(tmp))
        else:
            raise FileNotFoundError(f"no capture at {video_path}")
        paths = []
        for frame_path in frames[::max(stride, 1)]:
            frame = read_image(frame_path)
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
    """Stitch sorted PNG frames into an MP4 with ffmpeg.  Raises
    `NoFFmpegError` (a RuntimeError) when no ffmpeg binary is found, and
    RuntimeError when ffmpeg fails."""
    import tempfile

    frames = sorted(Path(frames_dir).glob("*.png"))
    if not frames:
        raise FileNotFoundError(f"No PNG frames in {frames_dir}")
    ffmpeg_bin = find_ffmpeg()
    if ffmpeg_bin is None:
        raise NoFFmpegError("stitch_video: no ffmpeg binary on PATH or from "
                            "imageio_ffmpeg; the frames are in " + str(frames_dir))
    out_path = Path(output_path)
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
