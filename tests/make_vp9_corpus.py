"""Write `tests/data/vp9/`: cv2's own `VP90` clips (its FFmpeg's libvpx
writer, in WebM, Matroska, AVI and MP4, one asked for at an odd size, one at
1080p) and the manifest that holds them and the tests' writer's streams to
cv2's reading.

The manifest (`manifest.json`) gives, for each committed file, its SHA-256,
what cv2 probes (width, height, fps, CAP_PROP_FRAME_COUNT) and the SHA-256
of each RGB frame cv2 reads from it; for each writer stream
(`tests/torch_vp9_syntax.py`, not committed: it is remade from its seed),
its seed, plan, options and muxing, the SHA-256 of the file the writer and
the muxer make from them, and the same probe and frame hashes.  The card's
machine has no cv2 and no libvpx: `chip_smoke.py` holds the port to these
hashes there.

Run once, where cv2 (with libvpx) is installed:

    python tests/make_vp9_corpus.py
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tests import torch_vp9_syntax as syn  # noqa: E402
from tests.make_vp8_corpus import frame_hashes  # noqa: E402

OUT = REPO / "tests" / "data" / "vp9"

# cv2's clips: (name, requested width, height, frames, content)
CLIPS = (("clip_cv2.webm", 64, 48, 12, "noise"), ("clip_cv2_odd.mkv", 75, 45, 8, "noise"),
         ("clip_cv2.avi", 96, 64, 8, "noise"), ("clip_cv2.mp4", 96, 64, 8, "noise"),
         ("clip_1080p.webm", 1920, 1080, 3, "smooth"))
# a browser's realtime encode: one reference, no hidden frames, a context
# saved as coded (no backward adaptation), a few large blocks
REALTIME = {"error_res": 0, "refresh_ctx": 1000, "parallel": 1000, "compound": 0,
            "lossless": 0, "seg": 0, "split": 850, "skip": 600, "density": 300, "q_min": 40,
            "q_max": 120, "intra": 50, "updates": 20, "reset_ctx": 0, "ctx_idx": 0}
# libvpx's two-pass "good" encode: alt-refs hidden in superframes, shown
# again by show_existing_frame, backward adaptation, compound prediction
TWO_PASS = dict(REALTIME, parallel=0, compound=1, switchable=800)
# a browser's MediaRecorder WebM: no DefaultDuration, no Duration, no Cues,
# times in whole milliseconds of a camera's uneven clock
RECORDER = {"times_ms": [0, 33, 67, 101, 133, 168, 200, 234], "default_duration": None,
            "duration_ms": None, "cues": False}
# the writer's streams: name -> (seed, plan, options, mux options); the
# suffix names the container
STREAMS = {
    "syn_adapt.webm": (1, "KPPPPPPP", {"refresh_ctx": 1000, "parallel": 0, "error_res": 0}, {}),
    "syn_hidden_odd.mkv": (2, "KPhPPePPE", {"width": 57, "height": 31}, {}),
    "syn_intra_only.avi": (3, "KPPiPPP", {"width": 40, "height": 40}, {}),
    "syn_seg_tiles.webm": (4, "KPPhPP", {"width": 520, "height": 72, "seg": 1,
                                          "tile_cols": 1, "tile_rows": 2}, {}),
    "syn_lossless.webm": (5, "KPPP", {"lossless": 1000, "width": 33, "height": 17}, {}),
    "syn_recorder.webm": (6, "KPPPPPPP", REALTIME, RECORDER),
    "syn_1080p_rt.webm": (7, "KPP", dict(REALTIME, width=1920, height=1080, tile_cols=2),
                          {"times_ms": [0, 33, 67], "default_duration": None,
                           "duration_ms": None, "cues": False}),
    "syn_1080p_2pass.webm": (8, "KhPPeP", dict(TWO_PASS, width=1920, height=1080,
                                                tile_cols=2), {}),
}


def write_clip(path: Path, width: int, height: int, n: int, content: str) -> None:
    """cv2's VP90 writer on moving test frames."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(0)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"VP90"), 30, (width, height))
    if not vw.isOpened():
        raise RuntimeError(f"cv2 cannot write VP90 into {path.suffix}")
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
    seed, plan, options, mux = STREAMS[name]
    return syn.make_file(out / name, seed, plan, options, mux)


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
        for name, (seed, plan, options, mux) in STREAMS.items():
            path = make_stream(name, Path(tmp))
            probe, hashes = frame_hashes(path)
            manifest["streams"][name] = {
                "seed": seed, "plan": plan, "options": options, "mux": mux,
                "file_sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
                "probe": probe, "sha256": hashes}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{OUT}: {len(manifest['files'])} files, {len(manifest['streams'])} streams, "
          f"{total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
