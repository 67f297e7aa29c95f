"""Regenerate the committed HEVC corpus, `tests/data/hevc/`, which holds the
port's host decoder to cv2's FFmpeg where cv2 is missing: the decoder must
give its manifest's pictures (`chip_smoke.py` phase M on the card's machine,
`tests/test_torch_hevc.py` on the CPU).  Needs cv2:

    python tests/make_hevc_corpus.py            # rewrite tests/data/hevc/

It writes, from fixed seeds of the random legal-syntax writer
(`tests/torch_hevc_syntax.py`):

- one Annex B stream (`<name>.hevc`) for each feature set of
  `tests/test_torch_hevc.py::FEATURES` and `tests/test_torch_hevc_tools.py::FEATURES`
  (but the pair the decoder refuses, tiles with WPP);
- `clip_hevc.mp4`, laid out as x265 and FFmpeg's mov muxer write one: 1920 x
  1080 coded as 1088 and cropped, CTB 64, WPP, SAO, TMVP, AMP, sign data
  hiding, strong intra smoothing, an IDR, a B-pyramid of a P and three B
  pictures (the middle B a reference), then a CRA with its RASL pictures
  (two, and a RADL one), BT.709 limited range, 40-70 KB a picture, MP4 (`hvc1`) with
  `ctts` and an edit list starting at the first composition offset;
- `portrait.mov`, a phone's portrait capture: 320 x 176 coded, a 90-degree
  display matrix, `hev1` with the parameter sets in band, QuickTime with a
  silent sound track, IDR and P pictures;
- `clip_hevc10.mp4`, Main 10 in `clip_hevc.mp4`'s layout (BT.709 tags), an
  IDR, a P and three B pictures;
- `clip_hevc10.mov`, laid out as an iPhone's HDR capture: QuickTime, `hvc1`
  with an hvcC box of profile 2 (Main 10), 1920 x 1080 coded as 1088, HLG
  tags (BT.2020 primaries, ARIB STD-B67 transfer, BT.2020 matrix) in the VUI
  and in a `colr` nclx box, a silent sound track, an IDR, a P and three B
  pictures (no Dolby Vision RPUs: the stream is what such a capture's base
  layer is);
- `clip_hevc_tools.mp4`, `clip_hevc.mp4`'s layout (IDR, B-pyramid, CRA with
  RASL pictures, 1088 coded, cropped to 1080) with the five tools at once: a
  3 x 3 uniform tile grid (WPP off: the decoder refuses the pair), scaling
  lists in the SPS and the PPS, the IDR a long-term reference from the next
  picture to the end, PCM CUs (6-bit luma, 5-bit chroma, the loop filter off
  over them) and bypass CUs; sparser than `clip_hevc.mp4` (about 70 KB), to
  keep the corpus within its 1 MiB;

then decodes each with the port and writes `manifest.json`: each file's
SHA-256 and the SHA-256 of every picture's Y', Cb and Cr planes (in output
order, before any rotation; 10-bit planes as little-endian uint16), only
after cv2's FFmpeg decoded the stream to the same pictures (its decode
equals its decode of an I_PCM stream of the port's pictures, High 10 for
Main 10, with no FFmpeg message; at 10 bits its raw luma equals the port's,
or the I_PCM stream's where the VUI describes the colour) and read each file
as its stream -- it raises otherwise and writes nothing.
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
sys.path[:0] = [str(ROOT)]

from omfs4d_torch.io import hevc  # noqa: E402
from tests import torch_h264_syntax as h264syn  # noqa: E402
from tests import torch_hevc_syntax as syn  # noqa: E402
from tests.test_torch_h264_high import planes_sha  # noqa: E402
from tests.test_torch_hevc import FEATURES  # noqa: E402
from tests.test_torch_hevc_tools import FEATURES as TOOLS, REFUSED  # noqa: E402

OUT = ROOT / "tests" / "data" / "hevc"
# x265's layout at 1080p: the writer's features and seed
CLIP = dict(gop="pyramid", frames=9, cra=True, width=1920, height=1080, ctb=64, wpp=True,
            sao=True, tmvp=True, amp=True, strong=True, sign_hiding=True, refs=2, num_ref_idx=2,
            colour=(0, 1), density=0.035, cbf=0.5, skip=0.5, split=0.45, merge=0.5,
            intra_in_inter=0.05, qp=(26, 34), deblock=("on",), sps_rps=1.0, big=0.02, fps=30)
CLIP_SEED = 1                  # its anchor after the IDR is a P picture
PORTRAIT = dict(gop="p", frames=6, refs=2, num_ref_idx=2, width=320, height=176, ctb=32,
                colour=(0, 1), sao=True, density=0.05, fps=30)
PORTRAIT_SEED = 1
# Main 10 at 1080p: clip_hevc.mp4's layout, five pictures; and the iPhone
# HDR capture's tags
CLIP10 = dict(CLIP, frames=5, cra=False, bit_depth=10)
CLIP10_SEED = 1
HDR = dict(CLIP10, colour=(0, 9, 18, 9))
HDR_SEED = 3                   # its anchor after the IDR is a P picture
# the five tools in clip_hevc.mp4's layout, its CUs larger and its residuals
# sparser
CLIP_TOOLS = dict(CLIP, wpp=False, tiles=(3, 3), scaling="both", long_term=1, lt_early=True,
                  pcm=0.012, pcm_depths=(6, 5), pcm_lf=(1,), bypass=0.025, split=0.22, skip=0.8,
                  density=0.012, cbf=0.3, merge=0.75, intra_in_inter=0.03)
CLIP_TOOLS_SEED = 1


def cv2_frames(path, raw: bool = False) -> tuple[list[np.ndarray], str]:
    """cv2's frames of a file and what FFmpeg wrote to stderr meanwhile;
    `raw`: with CAP_PROP_CONVERT_RGB 0, each 10-bit frame's luma as
    `tests/test_torch_hevc.py::cv2_raw_luma` reads it."""
    import cv2

    with tempfile.TemporaryFile() as err:
        saved = os.dup(2)
        os.dup2(err.fileno(), 2)
        try:
            cap = cv2.VideoCapture(str(path))
            if raw:
                cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
            frames = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(np.ascontiguousarray(frame).view("<u2") if raw else frame)
            cap.release()
        finally:
            os.dup2(saved, 2)
            os.close(saved)
        err.seek(0)
        return frames, err.read().decode("utf-8", "replace")


def held_to_cv2(data: bytes, pictures, colour, work: Path, bit_depth: int = 8
                ) -> list[np.ndarray]:
    """cv2's frames of the I_PCM stream of the pictures, once cv2's decode of
    the coded stream equals them (and, above 8 bits, its raw luma too)."""
    (work / "coded.hevc").write_bytes(data)
    (work / "pcm.h264").write_bytes(h264syn.pcm_stream(pictures, colour, bit_depth=bit_depth))
    coded, err1 = cv2_frames(work / "coded.hevc")
    pcm, err2 = cv2_frames(work / "pcm.h264")
    if "[hevc @" in err1 + err2 or "[h264 @" in err1 + err2:
        raise RuntimeError(f"FFmpeg complained:\n{(err1 + err2)[-2000:]}")
    if len(coded) != len(pictures) or len(pcm) != len(pictures):
        raise RuntimeError(f"cv2 gave {len(coded)} / {len(pcm)} frames, the port {len(pictures)}")
    for i, (a, b) in enumerate(zip(coded, pcm)):
        if not np.array_equal(a, b):
            raise RuntimeError(f"frame {i}: cv2's decode differs from the port's")
    if bit_depth > 8:
        raw = cv2_frames(work / "coded.hevc", raw=True)[0]
        want = ([p[0][:, :p[0].shape[1] // 2] for p in pictures] if colour is None else
                cv2_frames(work / "pcm.h264", raw=True)[0])
        if len(raw) != len(pictures) or any(not np.array_equal(a, b) for a, b in zip(raw, want)):
            raise RuntimeError("cv2's raw luma differs from the port's")
    return pcm


def features_json(features: dict) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in features.items()}


def main() -> int:
    streams, files = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        sets = {**FEATURES, **{k: v for k, v in TOOLS.items() if k not in REFUSED}}
        for name, features in sets.items():
            data = syn.annexb(syn.write_stream(0, **features))
            pictures = hevc.decode_annexb(data)
            held_to_cv2(data, pictures, features.get("colour"), work,
                        features.get("bit_depth", 8))
            files[f"{name}.hevc"] = data
            streams[f"{name}.hevc"] = {"features": features_json(features), "seed": 0,
                                       "sha256": [planes_sha(p) for p in pictures]}
        for name, features, seed, kind in (("clip_hevc.mp4", CLIP, CLIP_SEED, "mp4"),
                                           ("portrait.mov", PORTRAIT, PORTRAIT_SEED, "mov"),
                                           ("clip_hevc10.mp4", CLIP10, CLIP10_SEED, "mp4"),
                                           ("clip_hevc10.mov", HDR, HDR_SEED, "hdr"),
                                           ("clip_hevc_tools.mp4", CLIP_TOOLS, CLIP_TOOLS_SEED,
                                            "mp4")):
            writer = syn.Writer(seed, **features)
            aus = writer.stream()
            data = syn.annexb(aus)
            pictures = hevc.decode_annexb(data)
            depth = features.get("bit_depth", 8)
            pcm = held_to_cv2(data, pictures, features["colour"], work, depth)
            path = work / name
            rotation = 90 if kind == "mov" else 0
            syn.write_mov(path, aus, features["width"], features["height"], fps=30,
                          rotation=rotation, quicktime=kind != "mp4", audio=kind != "mp4",
                          media_time="ctts", sample_entry=b"hev1" if kind == "mov" else b"hvc1",
                          display=writer.display, bit_depth=depth,
                          colour=features["colour"] if kind == "hdr" else None)
            shown, err = cv2_frames(path)
            if "[hevc @" in err or len(shown) != len(pcm) or any(
                    not np.array_equal(a, np.rot90(b, -rotation // 90)) for a, b in zip(shown, pcm)):
                raise RuntimeError(f"cv2 reads {name} otherwise than its stream")
            files[name] = path.read_bytes()
            streams[name] = {"features": features_json(features), "seed": seed,
                             "frame_bytes": [sum(len(u) for u in au) for au in aus],
                             "display": writer.display, "rotation": rotation,
                             "kinds": [p.kind for p in writer.pics],
                             "sha256": [planes_sha(p) for p in pictures]}
    for name, data in files.items():
        streams[name]["bytes"] = len(data)
        streams[name]["file_sha256"] = hashlib.sha256(data).hexdigest()
    OUT.mkdir(parents=True, exist_ok=True)
    old_manifest = OUT / "manifest.json"
    samples = json.loads(old_manifest.read_text()).get("samples") if old_manifest.exists() \
        else None
    for old in OUT.iterdir():
        if old.name not in (samples or {}):      # tests/make_colour_samples.py's
            old.unlink()
    for name, data in files.items():
        (OUT / name).write_bytes(data)
    manifest = {"tool": "tests/make_hevc_corpus.py", "streams": streams}
    if samples:
        manifest["samples"] = samples
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(files)} files, {total} bytes, to {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
