"""Regenerate the committed Matroska / AVI corpus, `tests/data/matroska/`,
which holds the port's container readers to cv2's FFmpeg where cv2 is
missing (`chip_smoke.py` phase M on the card's machine,
`tests/test_torch_matroska.py` on the CPU).  Needs cv2:

    python tests/make_matroska_corpus.py        # rewrite tests/data/matroska/

It writes a few small `.mkv` files from cv2's own writers (`mp4v`, `XVID`,
`FMP4`, `MJPG`, odd sizes among them) and `manifest.json`, which holds:

- for each of those files: its SHA-256, cv2's probe (width, height, fps,
  frame count) and the SHA-256 of each frame cv2 reads (RGB, uint8);
- for each remux of `tests/torch_mkv_mux.py::REMUXES` (the committed H.264,
  HEVC and MPEG-4 clips in Matroska and, as Annex B, in AVI): the remux's
  size and SHA-256, which the muxer gives again byte for byte, cv2's probe
  and the SHA-256 of each frame cv2 reads; the remuxes themselves are not
  committed, the card's machine re-makes them from the clips.

Each entry is written only after the port read the file to the same probe
and frames; the script raises otherwise and writes nothing.
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import cv2  # noqa: E402

from omfs4d_torch.io import video as tvideo  # noqa: E402
from tests import torch_mkv_mux as mux  # noqa: E402
from tests.make_mpeg4_corpus import scene  # noqa: E402

OUT = ROOT / "tests" / "data" / "matroska"
# cv2's writers: (file, fourcc, width, height, frames) at 25 fps
CV2_FILES = [("mp4v_64x48.mkv", "mp4v", 64, 48, 14), ("xvid_50x38.mkv", "XVID", 50, 38, 14),
             ("fmp4_176x144.mkv", "FMP4", 176, 144, 14), ("mjpg_33x17.mkv", "MJPG", 33, 17, 10)]


def rgb_sha(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes()).hexdigest()


def cv2_read(path: Path) -> tuple[dict, list[np.ndarray]]:
    """cv2's probe of a file (the keys of `probe_video`) and its frames as
    RGB."""
    cap = cv2.VideoCapture(str(path))
    probe = {"width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
             "fps": float(cap.get(cv2.CAP_PROP_FPS)) or 30.0,
             "frame_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(frame[..., ::-1]))
    cap.release()
    return probe, frames


def held_to_cv2(path: Path) -> dict:
    """The manifest entry of a file: cv2's probe and frame hashes, once the
    port read it to the same (RuntimeError otherwise)."""
    probe, frames = cv2_read(path)
    tvideo_find = tvideo.find_ffmpeg
    tvideo.find_ffmpeg = lambda: None
    try:
        reader = tvideo._own_reader(path)
        ours = [reader.rgb(i) for i in range(len(reader))]
        ours_probe = tvideo.probe_video(path)
    finally:
        tvideo.find_ffmpeg = tvideo_find
    if ours_probe != probe or len(ours) != len(frames) or not all(
            np.array_equal(a, b) for a, b in zip(ours, frames)):
        raise RuntimeError(f"{path.name}: the port's read is not cv2's ({ours_probe} against "
                           f"{probe}, {len(ours)} frames against {len(frames)})")
    return {"probe": probe, "sha256": [rgb_sha(f) for f in frames]}


def main() -> int:
    files, entries, remuxes = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        for name, fourcc, w, h, n in CV2_FILES:
            path = work / name
            writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25.0, (w, h))
            if not writer.isOpened():
                raise RuntimeError(f"cv2 cannot write {fourcc} into Matroska")
            for f in scene(n, w, h):
                writer.write(f)
            writer.release()
            data = path.read_bytes()
            files[name] = data
            entries[name] = {"writer": f"cv2.VideoWriter {fourcc} 25 fps {cv2.__version__}",
                             "bytes": len(data), "file_sha256": hashlib.sha256(data).hexdigest(),
                             **held_to_cv2(path)}
        for name, clip, kind in mux.REMUXES:
            path = mux.remux(clip, kind, work / name)
            data = path.read_bytes()
            remuxes[name] = {"clip": str(mux.CLIPS[clip].relative_to(ROOT)), "kind": kind,
                             "bytes": len(data),
                             "file_sha256": hashlib.sha256(data).hexdigest(),
                             **held_to_cv2(path)}
    OUT.mkdir(parents=True, exist_ok=True)
    for old in OUT.iterdir():
        old.unlink()
    for name, data in files.items():
        (OUT / name).write_bytes(data)
    manifest = {"tool": "tests/make_matroska_corpus.py", "files": entries, "remuxes": remuxes}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(files)} files and {len(remuxes)} remux entries, {total} bytes, to {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
