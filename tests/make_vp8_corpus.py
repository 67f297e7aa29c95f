"""Write `tests/data/vp8/`: cv2's own `VP80` clips (its FFmpeg's libvpx
writer, in WebM, Matroska and AVI, one asked for at an odd size, one at
1080p) and the manifest that holds them and the tests' writer's streams to
cv2's reading.

The manifest (`manifest.json`) gives, for each committed file, its SHA-256,
what cv2 probes (width, height, fps, CAP_PROP_FRAME_COUNT) and the SHA-256
of each RGB frame cv2 reads from it; for each writer stream
(`tests/torch_vp8_syntax.py`), its seed and features, how it is muxed, the
SHA-256 of the file the writer and the muxer make from them, and the same
probe and frame hashes.  The card's machine has no cv2 and no libvpx:
`chip_smoke.py` holds the port to these hashes there.

Run once, where cv2 (with libvpx) is installed:

    python tests/make_vp8_corpus.py
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests import torch_vp8_syntax as syn  # noqa: E402

OUT = REPO / "tests" / "data" / "vp8"

# cv2's clips: (name, requested width, height, frames, content)
CLIPS = (("clip_cv2.webm", 64, 48, 24, "noise"), ("clip_cv2_odd.mkv", 75, 45, 14, "noise"),
         ("clip_cv2.avi", 96, 64, 13, "noise"), ("clip_1080p.webm", 1920, 1080, 3, "smooth"))
# the writer's streams: name -> (seed, frames, key frames, hidden frames,
# features, mux options); the suffix names the container
STREAMS = {
    "syn_v0.webm": (1, 8, (0, 5), (3,), {"width": 64, "height": 48, "version": 0}, {}),
    "syn_v1_odd.mkv": (2, 6, (0,), (), {"width": 57, "height": 31, "version": 1}, {}),
    "syn_v2.avi": (3, 6, (0, 3), (2,), {"width": 33, "height": 17, "version": 2}, {}),
    "syn_v3.webm": (4, 7, (0, 4), (), {"width": 81, "height": 56, "version": 3}, {}),
    # a browser's MediaRecorder layout: no DefaultDuration, no Duration,
    # no Cues, times in whole milliseconds of a camera's uneven clock
    "syn_recorder.webm": (5, 8, (0,), (), {"width": 48, "height": 32, "version": 0},
                          {"times_ms": [0, 33, 67, 101, 133, 168, 200, 234],
                           "default_duration": None, "duration_ms": None, "cues": False}),
    "syn_1080p.webm": (25, 3, (0,), (), {"width": 1920, "height": 1080, "version": 0,
                                         "density": 0.05}, {}),
}


def frame_hashes(path: Path) -> tuple[dict, list[str]]:
    """cv2's probe of a file and the SHA-256 of each RGB frame it reads."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    probe = {"width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
             "fps": cap.get(cv2.CAP_PROP_FPS),
             "frame_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        out.append(hashlib.sha256(np.ascontiguousarray(bgr[..., ::-1]).tobytes()).hexdigest())
    cap.release()
    return probe, out


def write_clip(path: Path, width: int, height: int, n: int, content: str) -> None:
    """cv2's VP80 writer on moving test frames."""
    import cv2

    rng = np.random.default_rng(0)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"VP80"), 30, (width, height))
    if not vw.isOpened():
        raise RuntimeError(f"cv2 cannot write VP80 into {path.suffix}")
    yy, xx = np.mgrid[0:height, 0:width]
    for i in range(n):
        img = np.stack([(xx * 3 + i * 5) % 256, (yy * 2 + i * 7) % 256,
                        ((xx + yy) // 3 + i * 11) % 256], -1).astype(np.uint8)
        if content == "smooth":
            img = np.stack([xx * 255 // width, yy * 255 // height,
                            np.full_like(xx, 40 * i)], -1).astype(np.uint8)
        r = max(3, min(width, height) // 6)
        cv2.circle(img, (int(width / 2 + width / 4 * np.cos(i / 5)),
                         int(height / 2 + height / 4 * np.sin(i / 4))), r, (200, 40, 90), -1)
        if content == "noise":
            img = cv2.add(img, rng.integers(0, 30, img.shape, dtype=np.uint8))
        vw.write(img)
    vw.release()


def make_stream(name: str, out: Path) -> Path:
    """A writer stream of the manifest, muxed into `out` / name."""
    return syn.make_file(out / name, *STREAMS[name])


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    manifest: dict = {"files": {}, "streams": {}}
    for name, w, h, n, content in CLIPS:
        path = OUT / name
        write_clip(path, w, h, n, content)
        probe, hashes = frame_hashes(path)
        manifest["files"][name] = {
            "file_sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
            "requested": [w, h], "probe": probe, "sha256": hashes}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (seed, n, keys, hidden, features, mux) in STREAMS.items():
            path = make_stream(name, Path(tmp))
            probe, hashes = frame_hashes(path)
            manifest["streams"][name] = {
                "seed": seed, "frames": n, "key_frames": list(keys), "hidden": list(hidden),
                "features": features, "mux": mux,
                "file_sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
                "probe": probe, "sha256": hashes}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{OUT}: {len(manifest['files'])} files, {len(manifest['streams'])} streams, "
          f"{total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
