"""Write `tests/data/mpeg4_asp/manifest.json`: the Advanced Simple streams
the card's smoke test (`chip_smoke.py`, phase M) re-makes from the random
writer's seeds (`tests/torch_mpeg4_syntax.py`), with no cv2 there.

For each stream (`STREAMS`: a seed, the writer's features, the AVI fourcc
and the packing) it writes the AVI, holds cv2's decode of it to the port's
(cv2's frames equal to its decode of an I_PCM H.264 stream of the port's
planes, bit for bit, in count) and records the SHA-256 of the AVI's chunks
and of each frame's planes, with the VOPs' coding types and sizes.  The
streams are not committed: hashes only.

    python tests/make_mpeg4_asp_manifest.py [out.json]
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

from omfs4d_torch.io import mpeg4  # noqa: E402
from tests import torch_h264_syntax as hsyn  # noqa: E402
from tests import torch_mpeg4_syntax as syn  # noqa: E402

MANIFEST = REPO / "tests" / "data" / "mpeg4_asp" / "manifest.json"
# name -> (seed, features, fourcc, packing); asp_1080p is the card's timing
# clip: an MPEG-quantised I-VOP, a quarter-sample P-VOP and a B-VOP at
# 1920x1080 under an Xvid stamp
STREAMS = {
    "asp_1080p": (0, dict(width=1920, height=1080, frames=3, bframes=1, qpel=True,
                          quant_type=1, stamp="XviD0064", coded=0.3, four_mv=0.3), "XVID", None),
    "b_every_type": (0, dict(frames=10, bframes=2, four_mv=0.3, not_coded=0.25, b_modb=0.15,
                             b_nocbp=0.4, b_dquant=0.5, qp=(1, 31), delta=8, coded=0.5),
                     "XVID", None),
    "asp_all": (1, dict(frames=12, bframes=2, qpel=True, quant_type=1, matrices="loaded",
                        four_mv=0.3, packets=0.1, b_dquant=0.3, not_coded=0.2), "XVID", None),
    "xvid_edge": (0, dict(frames=10, bframes=2, qpel=True, four_mv=0.4, stamp="XviD0012",
                          width=40, height=24, far=0.6), "XVID", None),
    "divx_packed": (1, dict(frames=10, bframes=2, qpel=True, four_mv=0.3,
                            stamp="DivX503b1393p", width=40, height=24, far=0.6), "DX50",
                    "nvop"),
    "no_stamp": (0, dict(frames=10, bframes=2, stamp=None, four_mv=0.4, width=40, height=24,
                         far=0.6), "XVID", None),
}


def planes_sha(planes) -> str:
    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


def cv2_frames(path: Path) -> list[np.ndarray]:
    import cv2

    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_path = Path(argv[0]) if argv else MANIFEST
    entries = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        for name, (seed, features, fourcc, pack) in STREAMS.items():
            writer, headers, vops = syn.write_stream(seed, **features)
            chunks = syn.avi_chunks(writer, headers, vops, pack)
            w, h = features.get("width", 48), features.get("height", 32)
            path = work / f"{name}.avi"
            syn.write_avi(path, chunks, w, h, fourcc.encode())
            frames = mpeg4.frames(path)
            ours = [frames.ycbcr(i) for i in range(len(frames))]
            (work / "pcm.h264").write_bytes(hsyn.pcm_stream(ours))
            coded, pcm = cv2_frames(path), cv2_frames(work / "pcm.h264")
            if not len(coded) == len(pcm) == len(ours) or any(
                    not np.array_equal(a, b) for a, b in zip(coded, pcm)):
                raise RuntimeError(f"{name}: cv2's decode differs from the port's")
            entries[name] = {
                "seed": seed, "features": features, "fourcc": fourcc, "pack": pack,
                "stream_sha256": hashlib.sha256(b"".join(chunks)).hexdigest(),
                "kinds": writer.kinds, "vop_bytes": [len(v) for v in vops],
                "sha256": [planes_sha(p) for p in ours]}
            print(name, len(ours), "frames", entries[name]["stream_sha256"][:16])
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps({"streams": entries}, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
