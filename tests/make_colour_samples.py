"""Write `tests/data/hevc/cv2_colour.npz`, a sample of cv2's colour-managed
output for `chip_smoke.py` to hold the port to on the card's machine, where
there is no cv2: clip_hevc10.mov's five frames as cv2 reads them (BGR
turned to RGB, every 16th row and column from the first), and cv2's R'G'B'
at the block centres of the relays of `tests/colour_relays.py` (8-bit
H.264 I_PCM, BT.2020 with HLG and with PQ).  Its SHA-256, size and the cv2
it came from go to `manifest.json`'s "samples".

    python tests/make_colour_samples.py
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

from tests import colour_relays  # noqa: E402
from tests import torch_h264_syntax as syn  # noqa: E402

OUT = Path(__file__).resolve().parent / "data" / "hevc"
NAME = "cv2_colour.npz"
STEP = 16


def cv2_rgb(path: Path) -> list[np.ndarray]:
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])
    cap.release()
    return frames


def samples() -> dict[str, np.ndarray]:
    out = {"clip": np.stack([f[::STEP, ::STEP] for f in cv2_rgb(OUT / "clip_hevc10.mov")])}
    with tempfile.TemporaryDirectory() as tmp:
        for name in colour_relays.RELAYS:
            tags, codes, planes = colour_relays.relay(name)
            path = Path(tmp) / f"{name}.h264"
            path.write_bytes(syn.pcm_stream([planes], tags))
            (rgb,) = cv2_rgb(path)
            out[f"relay_{name}"] = colour_relays.centres(rgb, len(codes)).astype(np.uint8)
    return out


def main() -> int:
    buf = io.BytesIO()
    np.savez_compressed(buf, **samples())
    data = buf.getvalue()
    (OUT / NAME).write_bytes(data)
    manifest_path = OUT / "manifest.json"
    manifest = json.loads(manifest_path.read_text())
    manifest["samples"] = {NAME: {"tool": "tests/make_colour_samples.py", "step": STEP,
                                  "cv2": cv2.__version__, "bytes": len(data),
                                  "sha256": hashlib.sha256(data).hexdigest()}}
    manifest_path.write_text(json.dumps(manifest, indent=1) + "\n")
    print(f"wrote {NAME}, {len(data)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
