"""Write `tests/data/swscale/cv2_swscale.npz`, a sample of cv2's conversion
of Y'CbCr to RGB for `chip_smoke.py` to hold the port's
(`omfs4d_torch.io.swscale`) to on the card's machine, where there is no cv2:
for each case (`CASES`) the planes as the port decodes them and cv2's frame
of the same stream (BGR turned to RGB), on both of swscale's paths and in
both ranges:

- I_PCM H.264 streams of seeded random planes (the samples themselves), 8-bit
  (the unscaled path) and 10-bit (the scaled path), limited and full range;
- MPEG-4 Part 2 in AVI from `tests/torch_mpeg4_syntax.py` at an odd height
  and at odd sides (the scaled path, chroma interpolated at every pixel for
  the second);
- Motion JPEG in AVI of `cv2.imencode` frames sampled 4:4:4, 4:1:1 and
  4:4:0 (the scaled path, full range, chroma sited at the centre).

The planes, cv2's frames and each case's keywords for `swscale.to_rgb` go
to the file; its SHA-256, size, cases and the cv2 it came from to
`manifest.json`.

    python tests/make_swscale_samples.py
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from omfs4d_torch.io import jpeg, mjpeg, mpeg4  # noqa: E402
from tests import torch_h264_syntax as syn  # noqa: E402
from tests import torch_mpeg4_syntax as msyn  # noqa: E402

OUT = Path(__file__).resolve().parent / "data" / "swscale"
NAME = "cv2_swscale.npz"
# name -> (source, height, width, bit depth, full range, matrix, AVChromaLocation)
CASES = {
    "pcm8_limited_bt709": ("pcm", 32, 48, 8, False, 1, 1),
    "pcm8_full_bt601": ("pcm", 32, 48, 8, True, 6, 1),
    "pcm10_limited_bt709": ("pcm", 32, 48, 10, False, 1, 1),
    "pcm10_full_bt601": ("pcm", 32, 48, 10, True, 6, 1),
    "mpeg4_odd_height": ("mpeg4", 25, 40, 8, False, 2, 1),
    "mpeg4_odd_sides": ("mpeg4", 25, 41, 8, False, 2, 1),
    "mjpeg_444": ("mjpeg", 24, 32, 8, True, 2, 2),
    "mjpeg_411": ("mjpeg", 24, 32, 8, True, 2, 2),
    "mjpeg_440": ("mjpeg", 24, 32, 8, True, 2, 2),
}
SAMPLING = {"mjpeg_444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "mjpeg_411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "mjpeg_440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def cv2_rgb(path: Path) -> np.ndarray:
    """The first frame cv2 reads from a file, RGB."""
    cap = cv2.VideoCapture(str(path))
    ok, frame = cap.read()
    cap.release()
    assert ok, path
    return frame[..., ::-1]


def case(name: str, tmp: Path, seed: int) -> tuple[tuple[np.ndarray, ...], np.ndarray]:
    """A case's planes and cv2's frame of its stream."""
    source, h, w, depth, full, matrix, _ = CASES[name]
    rng = np.random.default_rng(seed)
    path = tmp / f"{name}.bin"
    if source == "pcm":
        dtype = np.uint8 if depth == 8 else np.uint16
        planes = (rng.integers(0, 1 << depth, (h, w)).astype(dtype),
                  *(rng.integers(0, 1 << depth, (h // 2, w // 2)).astype(dtype)
                    for _ in range(2)))
        path.write_bytes(syn.pcm_stream([planes], (int(full), matrix), bit_depth=depth))
    elif source == "mpeg4":
        _, headers, vops = msyn.write_stream(seed, width=w, height=h, frames=1)
        planes = mpeg4.decode_stream(msyn.raw(headers, vops))[0]
        msyn.write_avi(path, [headers + vops[0]], w, h, b"XVID")
    else:
        ok, data = cv2.imencode(".jpg", rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                                [cv2.IMWRITE_JPEG_QUALITY, 90,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[name]])
        planes = tuple(jpeg.decode_planes(data.tobytes(), idct=jpeg.idct_simple)[0])
        mjpeg.write(path, [data.tobytes()], 25, w, h)
    return planes, cv2_rgb(path)


def samples() -> dict[str, np.ndarray]:
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for seed, name in enumerate(CASES):
            planes, rgb = case(name, Path(tmp), seed)
            for key, plane in zip(("y", "cb", "cr"), planes):
                out[f"{name}_{key}"] = plane
            out[f"{name}_rgb"] = rgb
    return out


def main() -> int:
    buf = io.BytesIO()
    np.savez_compressed(buf, **samples())
    data = buf.getvalue()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / NAME).write_bytes(data)
    cases = {name: {"depth": depth, "full": full, "matrix": matrix, "location": location}
             for name, (_, _, _, depth, full, matrix, location) in CASES.items()}
    manifest = {"tool": "tests/make_swscale_samples.py",
                "samples": {NAME: {"cv2": cv2.__version__, "bytes": len(data),
                                   "sha256": hashlib.sha256(data).hexdigest(),
                                   "cases": cases}}}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    print(f"wrote {NAME}, {len(data)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
