"""Print how far the port's frames lie from cv2.VideoCapture's (which the JAX
package reads every video through), input by input: the largest and mean
difference in levels over each input's frames, read through the port's own
readers (`h264`, `hevc`, `mpeg4`, `mjpeg`).  The inputs: the committed
clips (first three frames), cv2's mp4v MP4 and MJPG AVI files at widths that
are not multiples of 8, MPEG-4 Part 2 at odd sizes
(`tests/torch_mpeg4_syntax.py`) and Motion JPEG of cv2's JPEG frames sampled
4:4:4, 4:1:1 and 4:4:0.  `--port` reads with another checkout's
`omfs4d_torch` (a parent commit unpacked by `git archive`), to set it beside
this one.  cv2 needed.

    python tests/measure_swscale_gaps.py [--port /path/to/other/checkout]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
CLIPS = ["hevc/clip_hevc.mp4", "hevc/clip_hevc10.mp4", "h264/clip_b.mp4", "h264/clip.mov",
         "mpeg4/clip_mp4v.mp4"]
CV2_SIZES = [(128, 96), (136, 100), (130, 98), (132, 90)]
ODD = [(41, 25), (40, 25), (47, 33)]
SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def cv2_rgb(path: Path, n: int) -> list[np.ndarray]:
    cap = cv2.VideoCapture(str(path))
    out = []
    while len(out) < n:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame[..., ::-1])
    cap.release()
    return out


def gap(path: Path, n: int = 3) -> dict:
    """The port's frames of a file against cv2's: max and mean levels."""
    from omfs4d_torch.io import container, h264, hevc, mjpeg, mpeg4

    codec = container.index(path)[2]["codec"]
    frames = {"h264": h264.frames, "hevc": hevc.frames, "mpeg4": mpeg4.frames,
              "mjpeg": mjpeg.frames}[codec](path)
    theirs = cv2_rgb(path, n)
    d = [np.abs(frames.rgb(i).astype(int) - t) for i, t in enumerate(theirs)]
    return {"frames": len(d), "max": int(max(x.max() for x in d)),
            "mean": round(float(np.mean([x.mean() for x in d])), 4)}


def smooth(h: int, w: int, rng) -> np.ndarray:
    base = rng.integers(0, 256, (h // 8 + 8, w // 8 + 8, 3)).astype(np.uint8)
    return cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=Path, default=HERE.parent,
                    help="the checkout whose omfs4d_torch reads (default: this one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.port.resolve()))
    sys.path.insert(1, str(HERE.parent))
    from omfs4d_torch.io import mjpeg
    from tests import torch_mpeg4_syntax as msyn

    rows = {}
    for clip in CLIPS:
        rows[clip] = gap(HERE / "data" / clip)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for fourcc, suffix in (("mp4v", "mp4"), ("MJPG", "avi")):
            for w, h in CV2_SIZES:
                for kind in ("smooth", "noise"):
                    path = tmp / f"{fourcc}_{w}x{h}_{kind}.{suffix}"
                    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25.0,
                                             (w, h))
                    for _ in range(3):
                        writer.write(smooth(h, w, rng) if kind == "smooth"
                                     else rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
                    writer.release()
                    rows[path.name] = gap(path)
        for w, h in ODD:
            _, headers, vops = msyn.write_stream(3, width=w, height=h, frames=3)
            path = tmp / f"mpeg4_{w}x{h}.avi"
            msyn.write_avi(path, [headers + vops[0]] + vops[1:], w, h, b"XVID")
            rows[path.name] = gap(path)
        for name, flag in SAMPLINGS.items():
            jpegs = [cv2.imencode(".jpg", rng.integers(0, 256, (49, 67, 3)).astype(np.uint8),
                                  [cv2.IMWRITE_JPEG_QUALITY, 90,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])[1].tobytes()
                     for _ in range(3)]
            path = mjpeg.write(tmp / f"mjpeg_{name}_67x49.avi", jpegs, 25, 67, 49)
            rows[path.name] = gap(path)
    for name, row in rows.items():
        print(json.dumps({"input": name, **row}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
