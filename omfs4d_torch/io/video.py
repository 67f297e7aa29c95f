"""Image read/write and video stitching, without OpenCV.

Port of `omfs4d.io.video` (`read_image`, `write_image`, `find_ffmpeg`,
`ffmpeg_stitch_cmd`, `stitch_video`).  PNG is encoded and decoded here with
the standard library's `zlib` and `struct` plus numpy: 8-bit grayscale,
grayscale+alpha, RGB and RGBA, non-interlaced, all five row filters on read.
That reads what the JAX package wrote with cv2, and cv2 reads what this
module writes.  Stitching needs an ffmpeg binary (libx264 yuv420p CRF 18,
the reference's encode contract); there is no cv2 codec ladder.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}          # PNG colour type -> channels
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


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


def read_image(path: str | Path) -> np.ndarray:
    """Read an image as (H, W, 3) uint8 RGB (gray is repeated, alpha dropped)."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"cannot read image: {path}")
    img = decode_png(p.read_bytes())
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
    RuntimeError when no ffmpeg binary is found."""
    import tempfile

    frames = sorted(Path(frames_dir).glob("*.png"))
    if not frames:
        raise FileNotFoundError(f"No PNG frames in {frames_dir}")
    ffmpeg_bin = find_ffmpeg()
    if ffmpeg_bin is None:
        raise RuntimeError("stitch_video: no ffmpeg binary on PATH or from "
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
