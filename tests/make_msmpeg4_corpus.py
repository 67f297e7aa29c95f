"""Write `tests/data/msmpeg4/`: cv2's own clips of the Windows family (its
FFmpeg's msmpeg4v2 / msmpeg4v3 / wmv1 / wmv2 writers, `MP42`, `MP43` /
`DIV3`, `WMV1` and `WMV2`, each in ASF `.wmv`, AVI and Matroska; one asked
for at an odd size; a 1080p `.wmv` of WMV2 and of MP43), cv2's other codecs
in `.wmv` (`MJPG`, `mp4v`, `VP80` and `MPG2`, which cv2 writes under the tag
`mpg2` and counts one frame more than it reads), and the manifest that holds
them and the tests' writer's streams to cv2's reading.

The manifest (`manifest.json`) gives, for each committed file, its SHA-256,
what cv2 probes (width, height, fps, CAP_PROP_FRAME_COUNT) and the SHA-256
of each RGB frame cv2 reads from it; for each writer stream
(`tests/torch_msmpeg4_syntax.py`, not committed: it is remade from its
seed), its seed, version, plan, options and muxing, the SHA-256 of the file
the writer and the muxer make from them, and the same probe and frame
hashes.  The card's machine has no cv2: `chip_smoke.py` holds the port to
these hashes there.

Run once, where cv2 is installed:

    python tests/make_msmpeg4_corpus.py
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

from tests import torch_msmpeg4_syntax as syn  # noqa: E402
from tests.make_vp8_corpus import frame_hashes  # noqa: E402

OUT = REPO / "tests" / "data" / "msmpeg4"

# cv2's clips: (name, fourcc, width, height, frames, fps)
CLIPS = tuple((f"{tag.lower()}_cv2.{ext}", tag, 96, 64, 40, 30)
              for tag in ("WMV1", "WMV2", "MP42", "MP43") for ext in ("wmv", "avi", "mkv")) + (
    ("div3_cv2.avi", "DIV3", 96, 64, 40, 30),
    ("wmv2_cv2_odd.wmv", "WMV2", 97, 63, 12, 30),
    ("wmv2_1080p.wmv", "WMV2", 1920, 1080, 3, 30),
    ("mp43_1080p.wmv", "MP43", 1920, 1080, 3, 30),
    ("mjpg_cv2.wmv", "MJPG", 96, 64, 20, 25),
    ("mp4v_cv2.wmv", "mp4v", 96, 64, 20, 25),
    ("vp80_cv2.wmv", "VP80", 96, 64, 20, 25),
    ("mpg2_cv2.wmv", "MPG2", 96, 64, 20, 25))
# the writer's streams: name -> (seed, version, plan, options, mux); the
# suffix names the container
STREAMS = {
    "syn_v2.avi": (1, syn.V2, "IPPPIPP", {"width": 48, "height": 32}, {"container": "avi"}),
    "syn_v3.wmv": (2, syn.V3, "IPPPIPP", {"width": 64, "height": 48, "escape": 0.3},
                   {"container": "asf", "layout": "single"}),
    "syn_wmv1.wmv": (3, syn.WMV1, "IPPPIPP", {"width": 48, "height": 32, "bit_rate": 60},
                     {"container": "asf", "layout": "compressed", "packet_size": 700}),
    "syn_wmv2.wmv": (4, syn.WMV2, "IPPPIPP", {"width": 80, "height": 48, "mspel_bit": 1,
                                              "abt_flag": 1, "loop_filter": 1,
                                              "top_left_mv_flag": 1, "per_mb_rl_bit": 1,
                                              "spread": 12},
                     {"container": "asf", "layout": "multiple", "padding_type": 2}),
    "syn_wmv2_skipped.avi": (5, syn.WMV2, "IPSPP", {"width": 48, "height": 32},
                             {"container": "avi"}),
}


def write_clip(path: Path, fourcc: str, width: int, height: int, n: int, fps: int) -> None:
    """cv2's writer of `fourcc` on moving test frames: gradients that drift,
    a disc that circles, a frame number at 1080p."""
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (width, height))
    if not vw.isOpened():
        raise RuntimeError(f"cv2 cannot write {fourcc} into {path.suffix}")
    yy, xx = np.mgrid[0:height, 0:width]
    step = max(1, width // 96)
    for i in range(n):
        img = np.stack([(xx // step * 3 + i * 4) % 256, (yy // step * 5 + i * 2) % 256,
                        ((xx + yy) // step * 2 + i * 7) % 256], -1).astype(np.uint8)
        cv2.circle(img, (int(width / 2 + width / 4 * np.sin(i / 5)),
                         int(height / 2 + height / 4 * np.cos(i / 7))),
                   max(4, height // 6), (255, 200, 30), -1)
        if width >= 1920:
            cv2.putText(img, f"omfs4d {i}", (200, 300), cv2.FONT_HERSHEY_SIMPLEX, 6,
                        (20, 20, 240), 12)
        vw.write(img)
    vw.release()


def make_stream(name: str, out: Path) -> Path:
    """A writer stream of the manifest, muxed into `out` / name."""
    seed, version, plan, options, mux = STREAMS[name]
    return syn.make_file(Path(out) / name, seed, version, plan, options, mux)


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    manifest: dict = {"files": {}, "streams": {}}
    for name, fourcc, w, h, n, fps in CLIPS:
        path = OUT / name
        write_clip(path, fourcc, w, h, n, fps)
        probe, hashes = frame_hashes(path)
        manifest["files"][name] = {
            "file_sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
            "fourcc": fourcc, "requested": [w, h, n, fps], "probe": probe, "sha256": hashes}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (seed, version, plan, options, mux) in STREAMS.items():
            path = make_stream(name, Path(tmp))
            probe, hashes = frame_hashes(path)
            manifest["streams"][name] = {
                "seed": seed, "version": version, "plan": plan, "options": options, "mux": mux,
                "file_sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
                "probe": probe, "sha256": hashes}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{OUT}: {len(manifest['files'])} files, {len(manifest['streams'])} streams, "
          f"{total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
