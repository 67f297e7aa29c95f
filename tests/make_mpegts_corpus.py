"""Regenerate the committed MPEG-TS corpus manifest,
`tests/data/mpegts/manifest.json`, which holds the port's transport stream
reader to cv2's FFmpeg where cv2 is missing (`chip_smoke.py` phase M on the
card's machine, `tests/test_torch_mpegts.py` on the CPU).  Needs cv2:

    python tests/make_mpegts_corpus.py        # rewrite tests/data/mpegts/

For each remux and variant of `tests/torch_ts_mux.py::REMUXES` (the
committed H.264, HEVC and MPEG-4 clips as `.ts`, M2TS `.m2ts` / `.mts` and
204-byte packets, with several access units to a PES, one split across
PES, a PES with no PTS, audio, two programs, a PTS wrap, starts mid-GOP, a
lost packet and a cut) it records the file's size and SHA-256, which the
muxer gives again byte for byte, cv2's probe (width, height, fps, frame
count) and the SHA-256 of each frame cv2 reads (RGB, uint8).  The files
themselves are not committed: the card's machine re-makes them from the
clips.  Where the port reads a damaged frame (a lost packet, the file's
end) as a ValueError rather than FFmpeg's concealment, `raises_at` is the
first frame it does not give; the frames before it are cv2's.

Each entry is written only after the port read the file to the same probe
and frames (up to `raises_at`); the script raises otherwise and writes
nothing.
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from omfs4d_torch.io import video as tvideo  # noqa: E402
from tests import torch_ts_mux as mux  # noqa: E402
from tests.make_matroska_corpus import cv2_read, rgb_sha  # noqa: E402
from tests.torch_mkv_mux import CLIPS  # noqa: E402

OUT = ROOT / "tests" / "data" / "mpegts"


def held_to_cv2(path: Path) -> dict:
    """The manifest entry of a file: cv2's probe and frame hashes, and where
    the port stops at a damaged frame, once the port read it to the same
    (RuntimeError otherwise)."""
    probe, frames = cv2_read(path)
    find = tvideo.find_ffmpeg
    tvideo.find_ffmpeg = lambda: None
    try:
        reader = tvideo._own_reader(path)
        ours, raises_at = [], None
        for i in range(len(reader)):
            try:
                ours.append(reader.rgb(i))
            except ValueError:
                raises_at = i
                break
        ours_probe = tvideo.probe_video(path)
    finally:
        tvideo.find_ffmpeg = find
    count = len(frames) if raises_at is None else raises_at
    if ours_probe != probe or len(reader) != len(frames) or len(ours) != count or any(
            rgb_sha(a) != rgb_sha(b) for a, b in zip(ours, frames)):
        raise RuntimeError(f"{path.name}: the port's read is not cv2's ({ours_probe} against "
                           f"{probe}, {len(ours)} frames of {len(reader)} against "
                           f"{len(frames)})")
    return {"probe": probe, "sha256": [rgb_sha(f) for f in frames], "raises_at": raises_at}


def main() -> int:
    import cv2

    remuxes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, clip, options in mux.REMUXES:
            path = mux.remux(clip, Path(tmp) / name, **options)
            data = path.read_bytes()
            remuxes[name] = {"clip": str(CLIPS[clip].relative_to(ROOT)), "options": options,
                             "bytes": len(data), "file_sha256": hashlib.sha256(data).hexdigest(),
                             **held_to_cv2(path)}
            print(name, remuxes[name]["probe"], len(remuxes[name]["sha256"]), "frames",
                  remuxes[name]["raises_at"])
    OUT.mkdir(parents=True, exist_ok=True)
    for old in OUT.iterdir():
        old.unlink()
    manifest = {"tool": "tests/make_mpegts_corpus.py", "cv2": cv2.__version__,
                "remuxes": remuxes}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(remuxes)} remux entries, {total} bytes, to {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
