"""Print the port's colour management against cv2, case by case, as
`tests/test_torch_colour_bounds.py` and `tests/test_torch_colour.py` hold it:
for each managed tag set, bit depth and range, the mean and largest
difference at the flat-block centres of a relay (2048 colours in the R'G'B'
cube, 1024 over the whole code range), then the same for the whites other
than D65 (`test_torch_colour.py::WHITES`, 10-bit, limited).  cv2 needed.

    python tests/measure_colour_gaps.py
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from omfs4d_torch.io import h264  # noqa: E402
from tests import colour_relays as cr  # noqa: E402
from tests import torch_h264_syntax as syn  # noqa: E402
from tests.test_torch_colour import WHITES  # noqa: E402
from tests.test_torch_colour_bounds import CASES  # noqa: E402


def cv2_rgb(path: Path) -> np.ndarray:
    cap = cv2.VideoCapture(str(path))
    ok, frame = cap.read()
    cap.release()
    return frame[..., ::-1]


def main() -> int:
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for full, p, t, m, bd, seed in ([c + (list(c[1:4]) + [c[4], c[0]],) for c in CASES]
                                        + [(0, p, t, m, 10, [p, t, m]) for p, t, m in WHITES]):
            codes = cr.relay_codes(seed, bd, m, bool(full))
            planes = cr.flat_picture(codes, bd)
            path = Path(tmp) / "relay.h264"
            path.write_bytes(syn.pcm_stream([planes], (full, p, t, m), bit_depth=bd))
            ours = h264.ycbcr_to_rgb(*planes, full_range=bool(full), matrix=m, bit_depth=bd,
                                     primaries=p, transfer=t)
            g = cr.gaps(cr.centres(ours, len(codes)), cr.centres(cv2_rgb(path), len(codes)))
            rows.append(g)
            print(f"{p}/{t}/{m} {bd}-bit {'full' if full else 'limited'}: cube mean "
                  f"{g['cube_mean']:.4f} max {g['cube_max']}; whole mean {g['whole_mean']:.4f} "
                  f"max {g['whole_max']}")
    print("over the cases: cube mean {:.4f}-{:.4f}, max {}-{}; whole mean {:.4f}-{:.4f}, "
          "max {}-{}".format(min(r["cube_mean"] for r in rows), max(r["cube_mean"] for r in rows),
                             min(r["cube_max"] for r in rows), max(r["cube_max"] for r in rows),
                             min(r["whole_mean"] for r in rows),
                             max(r["whole_mean"] for r in rows),
                             min(r["whole_max"] for r in rows), max(r["whole_max"] for r in rows)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
