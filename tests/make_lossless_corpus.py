"""Write `tests/data/lossless/`: cv2's own clips of raw and lossless video
(its FFmpeg's rawvideo under `I420`, `IYUV`, `YV12`, `Y800` and `RGBA`, in
AVI, Matroska and QuickTime; `HFYU` and `FFVH`; `FFV1`; PNG under `MPNG`,
`PNG ` and `png `, colour and grey; two asked for at an odd size), its
Motion JPEG under the AVI fourccs `JPGL` and `LJPG`, its `VP80` / `VP90` in
IVF, and the manifest that holds them and the tests' writer's streams
(`tests/torch_lossless_syntax.py`) to cv2's reading.

The manifest (`manifest.json`) gives, for each committed file, its SHA-256,
what cv2 probes (width, height, fps, CAP_PROP_FRAME_COUNT) and the SHA-256
of each RGB frame cv2 reads from it; for each writer stream (not committed:
remade from its seed), its seed, codec and options, the SHA-256 of the file
the writer makes from them, and the same probe and frame hashes.  The
streams include a 1080p one of each codec.  The card's machine has no cv2:
`chip_smoke.py` holds the port to these hashes there.

Run once, where cv2 is installed:

    python tests/make_lossless_corpus.py
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

from tests import torch_lossless_syntax as syn  # noqa: E402
from tests.make_vp8_corpus import frame_hashes  # noqa: E402

OUT = REPO / "tests" / "data" / "lossless"

# cv2's clips: (name, fourcc, width, height, frames, colour)
CLIPS = (
    ("i420_cv2.avi", "I420", 64, 48, 6, True),
    ("iyuv_cv2.avi", "IYUV", 64, 48, 6, True),
    ("yv12_cv2.avi", "YV12", 64, 48, 6, True),
    ("y800_cv2.avi", "Y800", 64, 48, 6, True),
    ("rgba_cv2.avi", "RGBA", 48, 32, 4, True),
    ("i420_cv2.mkv", "I420", 64, 48, 6, True),
    ("y800_cv2.mkv", "Y800", 64, 48, 6, True),
    ("rgba_cv2.mkv", "RGBA", 48, 32, 4, True),
    ("rgba_cv2.mov", "RGBA", 48, 32, 4, True),
    ("i420_cv2_odd.avi", "I420", 33, 25, 4, True),
    ("y800_cv2_odd.mkv", "Y800", 33, 25, 4, True),
    ("hfyu_cv2.avi", "HFYU", 64, 48, 6, True),
    ("hfyu_cv2.mkv", "HFYU", 64, 48, 6, True),
    ("hfyu_cv2.mov", "HFYU", 64, 48, 6, True),
    ("ffvh_cv2.avi", "FFVH", 64, 48, 6, True),
    ("ffvh_cv2.mkv", "FFVH", 64, 48, 6, True),
    ("ffv1_cv2.avi", "FFV1", 64, 48, 6, True),
    ("ffv1_cv2.mkv", "FFV1", 64, 48, 6, True),
    ("ffv1_cv2.mov", "FFV1", 64, 48, 6, True),
    ("ffv1_cv2.mp4", "FFV1", 64, 48, 6, True),
    ("ffv1_cv2_odd.mkv", "FFV1", 33, 25, 4, True),
    ("ffv1_cv2_grey.mkv", "FFV1", 64, 48, 6, False),
    ("mpng_cv2.avi", "MPNG", 64, 48, 6, True),
    ("png_cv2.avi", "PNG ", 64, 48, 6, True),
    ("png_cv2.mov", "png ", 64, 48, 6, True),
    ("png_cv2.mkv", "png ", 64, 48, 6, True),
    ("mpng_cv2.mp4", "MPNG", 64, 48, 6, True),
    ("png_cv2_grey.avi", "MPNG", 64, 48, 6, False),
    ("png_cv2_odd.mov", "png ", 33, 25, 4, True),
    ("jpgl_cv2.avi", "JPGL", 64, 48, 6, True),
    ("ljpg_cv2.avi", "LJPG", 64, 48, 6, True),
    ("vp80_cv2.ivf", "VP80", 64, 48, 6, True),
    ("vp90_cv2.ivf", "VP90", 64, 48, 6, True),
)

# the writer's streams: name -> (seed, codec, options); the suffix names the
# container
_T3 = [[[1, 2, 3, 122], [1, 4, 123], [1, 127], [128], [128]],
       [[1, 1, 2, 4, 120], [2, 126], [3, 125], [1, 127], [2, 126]]]
STREAMS = {
    "syn_raw_bgr24.avi": (1, "raw", {"fourcc": "BI_RGB", "bits": 24, "bottom_up": False,
                                     "width": 37, "height": 21, "frames": 3, "mux": "avi"}),
    "syn_raw_bgra_bottom_up.avi": (2, "raw", {"fourcc": "BI_RGB", "bits": 32,
                                              "bottom_up": True, "width": 30, "height": 17,
                                              "frames": 3, "mux": "avi"}),
    "syn_raw_i420_odd.avi": (13, "raw", {"fourcc": "I420", "bits": 0, "bottom_up": False,
                                         "pad": False, "width": 97, "height": 63,
                                         "frames": 2, "mux": "avi"}),
    "syn_raw_y800_odd_padded.mkv": (14, "raw", {"fourcc": "Y800", "bits": 0,
                                                "bottom_up": False, "pad": True, "width": 33,
                                                "height": 25, "frames": 2, "mux": "mkv"}),
    "syn_png_filters.mkv": (3, "png", {"channels": 3, "idat": 3, "width": 35, "height": 22,
                                       "frames": 3, "level": 6, "mux": "mkv"}),
    "syn_png_grey_alpha.avi": (4, "png", {"channels": 2, "idat": 1, "width": 20,
                                          "height": 13, "frames": 2, "level": 9,
                                          "mux": "avi"}),
    "syn_hfyu_v0_yuy2_median.avi": (5, "huffyuv", {
        "fmt": "yuv422", "version": 0, "predictor": "median", "decorrelate": False,
        "interlace": None, "context": False, "width": 32, "height": 20, "frames": 3,
        "mux": "avi"}),
    "syn_hfyu_v1_rgb32_plane.avi": (6, "huffyuv", {
        "fmt": "rgb32", "version": 1, "predictor": "plane", "decorrelate": True,
        "interlace": None, "context": False, "width": 24, "height": 18, "frames": 3,
        "mux": "avi"}),
    "syn_hfyu_v2_context_interlaced.mkv": (7, "huffyuv", {
        "fmt": "yuv422", "version": 2, "predictor": "plane", "decorrelate": False,
        "interlace": True, "context": True, "width": 40, "height": 24, "frames": 3,
        "mux": "mkv"}),
    "syn_ffvh_median.avi": (8, "huffyuv", {
        "fmt": "yuv420", "version": 2, "predictor": "median", "decorrelate": False,
        "interlace": False, "context": False, "width": 32, "height": 24, "frames": 3,
        "mux": "avi"}),
    "syn_ffv1_v0_golomb.avi": (9, "ffv1", {
        "version": 0, "coder": 0, "colorspace": 0, "bits": 8, "chroma": True, "hs": 1,
        "vs": 1, "alpha": False, "slices": [1, 1], "ec": False, "tables": _T3[:1],
        "initial": False, "gop": 2, "width": 30, "height": 20, "frames": 3, "mux": "avi"}),
    "syn_ffv1_v1_custom_rgb.mkv": (10, "ffv1", {
        "version": 1, "coder": 2, "colorspace": 1, "bits": 8, "chroma": True, "hs": 0,
        "vs": 0, "alpha": True, "slices": [1, 1], "ec": False, "tables": _T3[1:],
        "initial": False, "gop": 3, "width": 26, "height": 18, "frames": 3, "mux": "mkv"}),
    "syn_ffv1_v3_10bit_422.mkv": (11, "ffv1", {
        "version": 3, "coder": 1, "colorspace": 0, "bits": 10, "chroma": True, "hs": 1,
        "vs": 0, "alpha": False, "slices": [2, 2], "ec": True, "tables": _T3,
        "initial": True, "gop": 2, "width": 36, "height": 20, "frames": 3, "mux": "mkv"}),
    "syn_ffv1_v3_golomb_grey10.avi": (12, "ffv1", {
        "version": 3, "coder": 0, "colorspace": 0, "bits": 10, "chroma": False, "hs": 0,
        "vs": 0, "alpha": False, "slices": [2, 1], "ec": True, "tables": _T3,
        "initial": False, "gop": 3, "width": 28, "height": 16, "frames": 3, "mux": "avi"}),
    # a 1080p stream of each codec, remade from its seed and not committed
    "syn_raw_1080p.avi": (20, "raw", {"fourcc": "BI_RGB", "bits": 32, "bottom_up": True,
                                      "width": 1920,
                                      "height": 1080, "frames": 1, "mux": "avi"}),
    "syn_png_1080p.mkv": (21, "png1080", {"width": 1920, "height": 1080, "frames": 2,
                                          "mux": "mkv"}),
    "syn_hfyu_1080p.avi": (22, "huffyuv", {
        "fmt": "yuv422", "version": 2, "predictor": "median", "decorrelate": False,
        "interlace": None, "context": False, "width": 1920, "height": 1080, "frames": 2,
        "mux": "avi"}),
    "syn_ffv1_1080p.mkv": (23, "ffv1tile", {"width": 1920, "height": 1080, "frames": 3,
                                            "mux": "mkv"}),
}


def write_clip(path: Path, fourcc: str, width: int, height: int, n: int,
               colour: bool = True, fps: int = 30) -> None:
    """cv2's writer of `fourcc` on moving smooth test frames (gradients that
    drift, a disc that circles)."""
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (width, height),
                         colour)
    if not vw.isOpened():
        raise RuntimeError(f"cv2 cannot write {fourcc} into {path.suffix}")
    yy, xx = np.mgrid[0:height, 0:width]
    for i in range(n):
        img = np.stack([(xx * 3 + i * 4) % 256, (yy * 5 + i * 2) % 256,
                        ((xx + yy) * 2 + i * 7) % 256], -1).astype(np.uint8)
        cv2.circle(img, (int(width / 2 + width / 4 * np.sin(i / 2)),
                         int(height / 2 + height / 4 * np.cos(i / 3))),
                   max(3, height // 6), (255, 200, 30), -1)
        vw.write(img if colour else cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    vw.release()


def make_stream(name: str, out: Path) -> Path:
    """A writer stream of the manifest, muxed into `out` / name."""
    seed, codec, options = STREAMS[name]
    return syn.make_file(Path(out) / name, seed, codec, options)


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    manifest: dict = {"files": {}, "streams": {}}
    for name, fourcc, w, h, n, colour in CLIPS:
        path = OUT / name
        write_clip(path, fourcc, w, h, n, colour)
        probe, hashes = frame_hashes(path)
        manifest["files"][name] = {
            "file_sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
            "fourcc": fourcc, "requested": [w, h, n, colour], "probe": probe,
            "sha256": hashes}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (seed, codec, options) in STREAMS.items():
            path = make_stream(name, Path(tmp))
            probe, hashes = frame_hashes(path)
            manifest["streams"][name] = {
                "seed": seed, "codec": codec, "options": options,
                "file_sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
                "probe": probe, "sha256": hashes}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{OUT}: {len(manifest['files'])} files, {len(manifest['streams'])} streams, "
          f"{total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
