"""Write `tests/data/mpeg2/`: cv2's own MPEG-1 / MPEG-2 clips (its FFmpeg's
mpeg1video / mpeg2video writers, `MPG1`, `PIM1` and `MPG2`, in MPEG-PS
`.mpg` / `.mpeg` / `.vob`, MPEG-TS `.ts` / `.m2ts`, AVI, Matroska, MP4 and
QuickTime; one asked for at an odd size, one at 1080p) and the manifest that
holds them and the tests' writer's streams to cv2's reading.

The manifest (`manifest.json`) gives, for each committed file, its SHA-256,
what cv2 probes (width, height, fps, CAP_PROP_FRAME_COUNT) and the SHA-256
of each RGB frame cv2 reads from it; for each writer stream
(`tests/torch_mpeg2_syntax.py`, not committed: it is remade from its seed),
its seed, plan, options and muxing, the SHA-256 of the file the writer and
the muxer make from them, and the same probe and frame hashes.  The card's
machine has no cv2: `chip_smoke.py` holds the port to these hashes there.

Run once, where cv2 is installed:

    python tests/make_mpeg2_corpus.py
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

from tests import torch_mpeg2_syntax as syn  # noqa: E402
from tests.make_vp8_corpus import frame_hashes  # noqa: E402

OUT = REPO / "tests" / "data" / "mpeg2"

# cv2's clips: (name, fourcc, requested width, height, frames, content)
CLIPS = (("mpg1_cv2.mpg", "MPG1", 64, 48, 12, "noise"),
         ("mpg1_cv2_60.mpg", "MPG1", 48, 32, 60, "noise"),
         ("pim1_cv2.mpg", "PIM1", 64, 48, 12, "noise"),
         ("mpg2_cv2.mpg", "MPG2", 64, 48, 12, "noise"),
         ("mpg2_cv2.mpeg", "MPG2", 64, 48, 20, "noise"),
         ("mpg2_cv2.vob", "MPG2", 64, 48, 12, "noise"),
         ("mpg2_cv2.ts", "MPG2", 64, 48, 12, "noise"),
         ("mpg2_cv2.m2ts", "MPG2", 64, 48, 20, "noise"),
         ("mpg2_cv2.avi", "MPG2", 64, 48, 12, "noise"),
         ("mpg1_cv2.avi", "MPG1", 64, 48, 12, "noise"),
         ("mpg2_cv2.mkv", "MPG2", 64, 48, 12, "noise"),
         ("mpg2_cv2.mp4", "MPG2", 64, 48, 12, "noise"),
         ("mpg2_cv2.mov", "MPG2", 64, 48, 20, "noise"),
         ("mpg2_cv2_odd.mpg", "MPG2", 97, 63, 5, "noise"),
         ("mpg2_1080p.mpg", "MPG2", 1920, 1080, 3, "smooth"))
# the writer's interlaced MPEG-2: frame pictures of an interlaced sequence
# with field and dual-prime prediction and field DCT (and, `flag_progressive`
# off, frames FFmpeg flags interlaced, which cv2 shows as the last picture it
# converted)
INTERLACED = {"progressive": False, "frame_pred": 0.2, "dual_prime": 0.4, "width": 96,
              "height": 64, "f_code": (1, 2, 3), "concealment": 0.3}
# the writer's streams: name -> (seed, plan, MPEG-2, options, mux); the
# suffix names the container
STREAMS = {
    "syn_interlaced.mpg": (1, "IPBBPBB|oIBBP", True, INTERLACED,
                           {"mpeg1": False, "psm_type": 0x02, "nav": True, "private": True}),
    "syn_interlaced.ts": (2, "IPBBPBB|oIBBP", True, INTERLACED, {}),
    "syn_interlaced_flags.mpg": (3, "IPBPBB", True, dict(INTERLACED, flag_progressive=False),
                                 {"mpeg1": False}),
    "syn_mpeg1.mpg": (5, "IPBBPBB|IPBB", False, {"full_pel": 0.3, "stuffing": 0.2,
                                                 "slices": 0.5, "escape": 0.3, "big": 0.2,
                                                 "width": 72, "height": 40},
                      {"mpeg1": True, "padding": True}),
    "syn_low_delay.mpg": (6, "IPPPPP", True, {"low_delay": 1, "q_scale_type": 1.0,
                                              "dc_precision": (3,), "vlc_format": 1.0,
                                              "alternate": 1.0, "matrices": 1.0},
                          {"mpeg1": False, "split": 200}),
}


def write_clip(path: Path, fourcc: str, width: int, height: int, n: int, content: str) -> None:
    """cv2's writer of `fourcc` on moving test frames, at 25 fps."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(0)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25, (width, height))
    if not vw.isOpened():
        raise RuntimeError(f"cv2 cannot write {fourcc} into {path.suffix}")
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
    seed, plan, mpeg2, options, mux = STREAMS[name]
    return syn.make_file(Path(out) / name, seed, plan, mpeg2, options, mux)


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    manifest: dict = {"files": {}, "streams": {}}
    for name, fourcc, w, h, n, content in CLIPS:
        path = OUT / name
        write_clip(path, fourcc, w, h, n, content)
        probe, hashes = frame_hashes(path)
        manifest["files"][name] = {
            "file_sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
            "fourcc": fourcc, "requested": [w, h, n], "probe": probe, "sha256": hashes}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (seed, plan, mpeg2, options, mux) in STREAMS.items():
            path = make_stream(name, Path(tmp))
            probe, hashes = frame_hashes(path)
            manifest["streams"][name] = {
                "seed": seed, "plan": plan, "mpeg2": mpeg2, "options": options, "mux": mux,
                "file_sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
                "probe": probe, "sha256": hashes}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{OUT}: {len(manifest['files'])} files, {len(manifest['streams'])} streams, "
          f"{total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
