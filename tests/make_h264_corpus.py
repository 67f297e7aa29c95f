"""Regenerate the committed H.264 corpus, `tests/data/h264/`, which holds the
port's host decoder to cv2's FFmpeg where cv2 is missing: the decoder must
give its manifest's pictures (`chip_smoke.py` phase M on the card's machine,
`tests/test_torch_h264_high.py` on the CPU).  Needs cv2:

    python tests/make_h264_corpus.py            # rewrite tests/data/h264/

It writes, from fixed seeds of the random legal-syntax writer
(`tests/torch_h264_syntax.py`):

- one Annex B stream (`<name>.h264`) for each feature set of
  `tests/test_torch_h264_high.py::FEATURES`, and one (`b_<name>.h264`) for
  each of `B_SETS` of `tests/test_torch_h264_bslices.py::FEATURES`;
- `clip.mov`, a phone's capture: 1920 x 1080 coded as 1088 and cropped, High
  profile, CABAC, the 8x8 transform, the deblocking filter on, 3 reference
  frames, an IDR and 5 P pictures of 60-80 KB each, BT.709 limited range,
  QuickTime with a 90-degree display matrix and a silent sound track;
- `clip_b.mp4`, laid out as x264 and FFmpeg's mov muxer write one: the same
  picture format, an IDR then two runs of a P and three B pictures in a
  B-pyramid (the middle B a reference), spatial direct, implicit weights, 3
  reference frames, the VUI's max_num_reorder_frames, 55-80 KB a picture,
  MP4 with `ctts` and an edit list starting at the first composition offset;

then decodes each with the port and writes `manifest.json`: the SHA-256 of
every picture's Y', Cb and Cr planes (in output order, before any rotation),
only after cv2's FFmpeg decoded the stream to the same pictures (its decode
equals its decode of an I_PCM stream of the port's pictures, with no FFmpeg
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

from omfs4d_torch.io import h264  # noqa: E402
from tests import torch_h264_syntax as syn  # noqa: E402
from tests.test_torch_h264_bslices import FEATURES as B_FEATURES  # noqa: E402
from tests.test_torch_h264_high import FEATURES  # noqa: E402

OUT = ROOT / "tests" / "data" / "h264"
# the phone clip: the writer's features and seed
CLIP = dict(width=1920, height=1080, frames=6, profile=100, cabac=True, t8x8=True, deblock=(0,),
            slices=1, refs=3, num_ref_idx=3, density=0.014, skip=0.45, intra_in_p=0.05,
            qp=(24, 32), qp_delta=2, pcm=0.0, restriction=True, colour=(0, 1))
CLIP_SEED = 7
# the B feature sets in the corpus, and the x264-like clip: its writer's
# features and seed (the seed whose plan is I, P B B B, P B B B)
B_SETS = ("cabac_pyramid_temporal", "direct_4x4_cavlc", "implicit", "explicit", "references_poc1")
CLIP_B = dict(width=1920, height=1080, frames=9, profile=100, cabac=True, t8x8=True, deblock=(0,),
              slices=1, refs=3, num_ref_idx=3, density=0.014, skip=0.45, intra_in_p=0.05,
              qp=(24, 32), qp_delta=2, pcm=0.0, restriction=True, colour=(0, 1), level=40,
              bframes=3, pyramid=True, direct=("spatial",), bipred=2, b_subs=(0, 1, 2, 3))
CLIP_B_SEED = 26


def planes_sha(planes) -> str:
    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


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


def held_to_cv2(data: bytes, pictures, colour, work: Path) -> None:
    (work / "coded.h264").write_bytes(data)
    (work / "pcm.h264").write_bytes(syn.pcm_stream(pictures, colour))
    coded, err1 = cv2_frames(work / "coded.h264")
    pcm, err2 = cv2_frames(work / "pcm.h264")
    if "[h264 @" in err1 + err2:
        raise RuntimeError(f"FFmpeg complained:\n{(err1 + err2)[-2000:]}")
    if len(coded) != len(pictures) or len(pcm) != len(pictures):
        raise RuntimeError(f"cv2 gave {len(coded)} / {len(pcm)} frames, the port {len(pictures)}")
    for i, (a, b) in enumerate(zip(coded, pcm)):
        if not np.array_equal(a, b):
            raise RuntimeError(f"frame {i}: cv2's decode differs from the port's")


def main() -> int:
    streams = {}
    files = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        sets = list(FEATURES.items()) + [(f"b_{n}", B_FEATURES[n]) for n in B_SETS]
        for name, features in sets:
            aus = syn.write_stream(0, **features)
            data = syn.annexb(aus)
            pictures = h264.decode_annexb(data)
            held_to_cv2(data, pictures, None, work)
            files[f"{name}.h264"] = data
            streams[f"{name}.h264"] = {"features": {k: list(v) if isinstance(v, tuple) else v
                                                    for k, v in features.items()},
                                       "seed": 0, "bytes": len(data),
                                       "sha256": [planes_sha(p) for p in pictures]}
        aus = syn.write_stream(CLIP_SEED, **CLIP)
        data = syn.annexb(aus)
        pictures = h264.decode_annexb(data)
        held_to_cv2(data, pictures, CLIP["colour"], work)
        syn.write_mov(work / "clip.mov", aus, 1920, 1080, fps=30, rotation=90)
        turned, err = cv2_frames(work / "clip.mov")
        pcm, _ = cv2_frames(work / "pcm.h264")
        if "[h264 @" in err or len(turned) != len(pcm) or any(
                not np.array_equal(a, np.rot90(b, -1)) for a, b in zip(turned, pcm)):
            raise RuntimeError("cv2 reads clip.mov otherwise than its stream")
        files["clip.mov"] = (work / "clip.mov").read_bytes()
        streams["clip.mov"] = {"features": {k: list(v) if isinstance(v, tuple) else v
                                            for k, v in CLIP.items()},
                               "seed": CLIP_SEED, "bytes": len(files["clip.mov"]),
                               "frame_bytes": [sum(len(u) for u in au) for au in aus],
                               "rotation": 90, "sha256": [planes_sha(p) for p in pictures]}
        writer = syn.Writer(CLIP_B_SEED, **CLIP_B)
        aus = writer.stream()
        data = syn.annexb(aus)
        pictures = h264.decode_annexb(data)
        held_to_cv2(data, pictures, CLIP_B["colour"], work)
        syn.write_mov(work / "clip_b.mp4", aus, 1920, 1080, fps=30, quicktime=False, audio=False,
                      media_time="ctts", display=writer.display)
        shown, err = cv2_frames(work / "clip_b.mp4")
        pcm, _ = cv2_frames(work / "pcm.h264")
        if "[h264 @" in err or len(shown) != len(pcm) or any(
                not np.array_equal(a, b) for a, b in zip(shown, pcm)):
            raise RuntimeError("cv2 reads clip_b.mp4 otherwise than its stream")
        files["clip_b.mp4"] = (work / "clip_b.mp4").read_bytes()
        streams["clip_b.mp4"] = {"features": {k: list(v) if isinstance(v, tuple) else v
                                              for k, v in CLIP_B.items()},
                                 "seed": CLIP_B_SEED, "bytes": len(files["clip_b.mp4"]),
                                 "frame_bytes": [sum(len(u) for u in au) for au in aus],
                                 "display": writer.display,
                                 "sha256": [planes_sha(p) for p in pictures]}
    OUT.mkdir(parents=True, exist_ok=True)
    for old in OUT.iterdir():
        old.unlink()
    for name, data in files.items():
        (OUT / name).write_bytes(data)
    manifest = {"tool": "tests/make_h264_corpus.py", "streams": streams}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(files)} files, {total} bytes, to {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
