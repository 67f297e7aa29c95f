"""Regenerate the committed MPEG-4 Part 2 corpus, `tests/data/mpeg4/`, which
holds the port's host decoder to cv2's FFmpeg where cv2 is missing: the
decoder must give its manifest's pictures (`chip_smoke.py` phase M on the
card's machine, `tests/test_torch_mpeg4.py` on the CPU).  Needs cv2:

    python tests/make_mpeg4_corpus.py           # rewrite tests/data/mpeg4/

It writes:

- one raw stream (`<name>.m4v`) for each feature set of
  `tests/test_torch_mpeg4.py::FEATURES`, from seed 0 of the random
  legal-syntax writer (`tests/torch_mpeg4_syntax.py`);
- `clip_mp4v.mp4`, 30 frames of 1920 x 1080 from cv2's `mp4v` writer
  (FFmpeg's mpeg4 encoder: Simple profile, a GOP of 12, flip-flop rounding)
  of a smooth scene panning under a moving disc, and `clip_xvid.avi`, the
  same frames from cv2's `XVID` writer;
- `stitched.mp4`, 8 frames of 512 x 512 written by the JAX package's own
  `omfs4d.io.video.stitch_video` with no ffmpeg (cv2's ladder falls to
  `mp4v` where it has no H.264 encoder);

then decodes each with the port and writes `manifest.json`: each file's
SHA-256 and the SHA-256 of every frame's Y', Cb and Cr planes, only after
cv2's FFmpeg decoded the file to the same pictures (its decode equals its
decode of an I_PCM H.264 stream of the port's pictures, with no FFmpeg
message) -- it raises otherwise and writes nothing.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from omfs4d_torch.io import container, mpeg4  # noqa: E402
from tests import torch_h264_syntax as hsyn  # noqa: E402
from tests import torch_mpeg4_syntax as syn  # noqa: E402
from tests.test_torch_mpeg4 import FEATURES  # noqa: E402

OUT = ROOT / "tests" / "data" / "mpeg4"
CLIP_FRAMES, CLIP_SIZE = 30, (1920, 1080)
STITCH_FRAMES, STITCH_SIZE = 8, 512


def planes_sha(planes) -> str:
    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


def scene(n: int, width: int, height: int, seed: int = 0) -> list[np.ndarray]:
    """n BGR frames: smooth colour fields panning, a lit disc crossing them."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, (3, 2))
    frames = []
    for t in range(n):
        img = np.empty((height, width, 3), np.float32)
        for c in range(3):
            img[..., c] = 128 + 60 * np.sin((x + 6 * t) / (97 + 31 * c) + phases[c, 0]) \
                * np.cos((y - 3 * t) / (71 + 17 * c) + phases[c, 1])
        cx, cy = width * (0.3 + 0.4 * t / max(n - 1, 1)), height * (0.5 + 0.1 * np.sin(t / 4))
        r2 = ((x - cx) ** 2 + (y - cy) ** 2) / (0.18 * min(width, height)) ** 2
        disc = np.clip(1.2 - r2, 0, 1)[..., None]
        img = img * (1 - 0.7 * disc) + 0.7 * disc * np.array([90, 150, 230], np.float32)
        frames.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return frames


def cv2_frames(path) -> tuple[list[np.ndarray], str]:
    """cv2's frames of a file and what FFmpeg wrote to stderr meanwhile."""
    import cv2

    with tempfile.TemporaryFile() as err:
        saved = os.dup(2)
        os.dup2(err.fileno(), 2)
        try:
            cap = cv2.VideoCapture(str(path))
            frames = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(frame)
            cap.release()
        finally:
            os.dup2(saved, 2)
            os.close(saved)
        err.seek(0)
        return frames, err.read().decode("utf-8", "replace")


def held_to_cv2(path: Path, pictures, colour, work: Path) -> None:
    (work / "pcm.h264").write_bytes(hsyn.pcm_stream(pictures, colour))
    coded, err1 = cv2_frames(path)
    pcm, err2 = cv2_frames(work / "pcm.h264")
    if "[mpeg4 @" in err1 + err2 or "[h264 @" in err1 + err2:
        raise RuntimeError(f"FFmpeg complained:\n{(err1 + err2)[-2000:]}")
    if len(coded) != len(pictures) or len(pcm) != len(pictures):
        raise RuntimeError(f"{path.name}: cv2 gave {len(coded)} / {len(pcm)} frames, the port "
                           f"{len(pictures)}")
    for i, (a, b) in enumerate(zip(coded, pcm)):
        if not np.array_equal(a, b):
            raise RuntimeError(f"{path.name} frame {i}: cv2's decode differs from the port's")


def file_pictures(path: Path) -> tuple[list, list[str]]:
    """The port's pictures of a container file and each sample's VOP type."""
    frames = mpeg4.frames(path)
    kinds = []
    for i in range(len(frames.offsets)):
        data = frames.sample(i)
        kinds.append(mpeg4.vop_header(data[data.find(mpeg4.VOP) + 4:],
                                      frames.params["time_bits"], path.name)[0])
    return [frames.ycbcr(i) for i in range(len(frames))], kinds


def main() -> int:
    import cv2

    from omfs4d.io import video as jvideo

    entries, files = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        for name, features in FEATURES.items():
            writer, headers, vops = syn.write_stream(0, **features)
            data = syn.raw(headers, vops)
            path = work / f"{name}.m4v"
            path.write_bytes(data)
            pictures = mpeg4.decode_stream(data)
            held_to_cv2(path, pictures, features.get("colour"), work)
            entries[path.name] = {"features": {k: list(v) if isinstance(v, tuple) else v
                                               for k, v in features.items()}, "seed": 0,
                                  "sha256": [planes_sha(p) for p in pictures]}
            files[path.name] = data
        frames = scene(CLIP_FRAMES, *CLIP_SIZE)
        for name, fourcc in (("clip_mp4v.mp4", "mp4v"), ("clip_xvid.avi", "XVID")):
            path = work / name
            writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30.0, CLIP_SIZE)
            if not writer.isOpened():
                raise RuntimeError(f"cv2 cannot write {fourcc}")
            for f in frames:
                writer.write(f)
            writer.release()
            pictures, kinds = file_pictures(path)
            held_to_cv2(path, pictures, None, work)
            files[name] = path.read_bytes()
            entries[name] = {"writer": f"cv2.VideoWriter {fourcc} 30 fps {cv2.__version__}",
                             "kinds": "".join(kinds),
                             "sha256": [planes_sha(p) for p in pictures]}
        src = work / "frames"
        src.mkdir()
        for i, f in enumerate(scene(STITCH_FRAMES, STITCH_SIZE, STITCH_SIZE, seed=1)):
            cv2.imwrite(str(src / f"{i:05d}.png"), f)
        jvideo.find_ffmpeg = lambda: None
        path = jvideo.stitch_video(src, work / "stitched.mp4", fps=30)
        if container.index(path)[2]["codec"] != "mpeg4":
            raise RuntimeError("the JAX package's stitch_video wrote no mp4v here")
        pictures, kinds = file_pictures(path)
        held_to_cv2(path, pictures, None, work)
        files["stitched.mp4"] = path.read_bytes()
        entries["stitched.mp4"] = {"writer": "omfs4d.io.video.stitch_video, no ffmpeg, 30 fps",
                                   "kinds": "".join(kinds),
                                   "sha256": [planes_sha(p) for p in pictures]}
    OUT.mkdir(parents=True, exist_ok=True)
    for old in OUT.iterdir():
        old.unlink()
    for name, data in files.items():
        (OUT / name).write_bytes(data)
        entries[name] = {"bytes": len(data), "file_sha256": hashlib.sha256(data).hexdigest(),
                         **entries[name]}
    manifest = {"tool": "tests/make_mpeg4_corpus.py", "files": entries}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(files)} files, {total} bytes, to {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
