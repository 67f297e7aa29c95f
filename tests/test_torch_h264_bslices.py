"""B slices in the port's host H.264 decoder (`omfs4d_torch/io/h264dec.cpp`) on
the CPU, held to an independent decoder: cv2's FFmpeg.

- Random legal-syntax streams with B pictures (`tests/torch_h264_syntax.py`)
  in ten feature sets over two seeds: cv2's decode of the coded stream
  equals its decode of an I_PCM stream of the port's pictures, in display
  order and count, with no `[h264 @` line; each set shows that it exercised
  its features, and over the sets every B mb_type and sub_mb_type, both
  direct modes at both granularities, both weight modes (and implicit
  weights' single-list and fall-back cases), reference B pictures and list
  1's swap occur.
- MP4 and QuickTime files with `ctts`, with and without an edit list, read
  in the port as in the JAX package (`omfs4d.io.video`); `H264Frames` read in
  random order equals a sequential read.
- Truncated and bit-flipped B slices raise ValueError (in a child process,
  so that a crash would fail the test, not the worker)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, h264
from omfs4d_torch.io import video as tvideo
from tests import torch_h264_syntax as syn
from tests.test_torch_h264_high import held_to_ffmpeg, rgb_tolerance

REPO = Path(__file__).resolve().parent.parent

# the writer's B feature sets (each with the VUI's max_num_reorder_frames, as
# x264 writes it), and what each must exercise
B = dict(restriction=True, refs=3, num_ref_idx=3, frames=8)
FEATURES = {
    "cavlc_spatial": dict(B, profile=77, cabac=False, t8x8=False, bframes=2,
                          direct=("spatial",)),
    "cabac_pyramid_temporal": dict(B, bframes=3, pyramid=True, direct=("temporal",), frames=9,
                                   refs=4, b_ref=0.4),
    "direct_4x4": dict(B, bframes=2, direct8x8=0, width=64, height=48),
    "direct_4x4_cavlc": dict(B, cabac=False, bframes=3, pyramid=True, direct8x8=0),
    "implicit": dict(B, bframes=3, pyramid=True, bipred=2, frames=10, refs=4, num_ref_idx=4,
                     long_term=True, mmco=True, b_ref=0.3),
    "explicit": dict(B, bframes=2, bipred=1, weighted=True, cabac=False, b_ref=0.5),
    "past_refs_poc2": dict(B, past_b=0.8, poc_type=2, non_ref=True, bipred=2, frames=10),
    "references_poc1": dict(B, bframes=3, b_ref=0.5, poc_type=1, list_mod=True, mmco=True,
                            long_term=True, frames=12, refs=4, num_ref_idx=4, idr_every=7),
    "slices_intra": dict(B, bframes=2, slices=4, intra_in_p=0.3, i_slices_in_p=0.2, pcm=0.05,
                         constrained_intra=True, deblock=(0, 1, 2), refs=2, num_ref_idx=2,
                         width=64, height=48),
    # no bitstream_restriction: the decoders bump by the DPB size (FFmpeg:
    # its estimate from the level) and give the same order
    "no_restriction": dict(B, restriction=False, bframes=3, pyramid=True, frames=10),
}
EXPECT = {
    "cavlc_spatial": ["direct_spatial1", "BSKIP", "reordered", "b_mb22"],
    "cabac_pyramid_temporal": ["direct_temporal1", "ref_b", "BSKIP"],
    "direct_4x4": ["direct_spatial0", "direct_temporal0"],
    "direct_4x4_cavlc": ["direct_spatial0", "reordered"],
    "implicit": ["implicit_single", "implicit_fallback", "weighted_bipred2"],
    "explicit": ["explicit_bi", "explicit_l0", "explicit_l1", "weighted"],
    "past_refs_poc2": ["list_swap", "b_pic", "implicit_bi"],
    "references_poc1": ["list_mod", "list1_mod", "ref_b"],
    "slices_intra": ["intra_in_b", "deblock0", "deblock1", "deblock2"],
    "no_restriction": ["reordered", "ref_b"],
}
CASES = [(name, seed) for name in FEATURES for seed in (0, 1)]


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)


@pytest.mark.parametrize("name, seed", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_b_streams_decode_as_ffmpeg_does(tmp_path, capfd, name, seed):
    """Each B feature set over two seeds: cv2 decodes the stream to exactly
    the port's pictures, as many, in display order, with no FFmpeg warning,
    and the stream held what the set is about."""
    writer = syn.Writer(seed, **FEATURES[name])
    aus = writer.stream()
    ours = held_to_ffmpeg(tmp_path, capfd, aus)
    assert len(ours) == FEATURES[name]["frames"]
    missing = [k for k in EXPECT[name] if not writer.stats[k]]
    assert not missing, (missing, dict(writer.stats))


def test_the_b_sets_cover_b_slices():
    """Over the feature sets every B mb_type and sub_mb_type, B_Skip, intra
    macroblocks in B slices, spatial and temporal direct with
    direct_8x8_inference_flag 0 and 1, explicit and implicit weights (a pair
    of implicit weights, a single-list partition and the fall-back to 32 /
    32), reference B pictures, list 1's swap and modification, long-term
    pictures in list 1 and every cabac_init_idc occur."""
    total = syn.Counter()
    for name, seed in CASES:
        writer = syn.Writer(seed, **FEATURES[name])
        writer.stream()
        total.update(writer.stats)
    wanted = ([f"b_mb{t}" for t in range(23)] + [f"b_sub{t}" for t in range(13)]
              + [f"direct_{m}{i}" for m in ("spatial", "temporal") for i in (0, 1)]
              + ["BSKIP", "intra_in_b", "explicit_bi", "explicit_l1", "implicit_bi",
                 "implicit_single", "implicit_fallback", "ref_b", "list_swap", "list1_mod",
                 "long_term_l1", "col_zero", "reordered"]
              + [f"cabac_init_idc{k}" for k in range(3)])
    assert not [k for k in wanted if not total[k]], dict(total)


# ── files with B pictures ───────────────────────────────────

MOVS = [("mov", "ctts"), ("mp4", "ctts"), ("mov", None), ("mp4", None), ("mov", 0),
        ("mp4", 1800)]


@pytest.mark.parametrize("kind, media_time", MOVS,
                         ids=[f"{k}-{'none' if m is None else m}" for k, m in MOVS])
def test_files_with_ctts_read_as_in_the_jax_package(tmp_path, capfd, kind, media_time):
    """A B-pyramid stream in QuickTime or MP4 with `ctts` as FFmpeg's mov
    muxer writes it, with its edit list starting at the first composition
    offset ("ctts"), with none, or starting earlier (0: the last pictures
    fall outside) or later (1800: the first ones do): the port's
    probe_video and extract_frames give the JAX package's size, fps, count
    and frames, the pixels within the conversion tolerance the I_PCM stream
    shows."""
    colour = (0, 1)
    writer = syn.Writer(3, width=64, height=48, frames=10, bframes=3, pyramid=True, refs=4,
                        num_ref_idx=3, restriction=True, colour=colour, idr_every=6)
    aus = writer.stream()
    assert writer.display != sorted(writer.display)
    path = tmp_path / f"clip.{kind}"
    syn.write_mov(path, aus, 64, 48, fps=30, quicktime=kind == "mov", audio=kind == "mov",
                  media_time=media_time, display=writer.display)
    info = container.index(path)[2]
    assert info["codec"] == "h264" and info["times"] != sorted(info["times"])
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    ours = tvideo.extract_frames(path, tmp_path / "ours")
    theirs = jvideo.extract_frames(path, tmp_path / "theirs")
    capfd.readouterr()
    # presentation times: (display place + the reorder delay) frames of 600 ticks
    delay = max(k - d for k, d in enumerate(writer.display))
    start = {"ctts": 600 * delay, None: 0, 0: 0, 1800: 1800}[media_time]
    end = start + 6000 if media_time is not None else 10 ** 9
    kept = [d for d in range(10) if start <= 600 * (d + delay) < end]
    assert len(kept) < 10 if media_time in (0, 1800) else len(kept) == 10
    assert len(ours) == len(theirs) == len(kept)
    frames = h264.frames(path)
    planes = [frames.ycbcr(i) for i in range(len(frames))]
    tol = rgb_tolerance(planes, colour, tmp_path, capfd)
    for a, b in zip(ours, theirs):
        x, y = tvideo.read_image(a).astype(int), tvideo.read_image(b).astype(int)
        assert x.shape == y.shape == (48, 64, 3)
        assert np.abs(x - y).max() <= tol


def test_random_order_reads_equal_a_sequential_one(tmp_path):
    """`H264Frames` read in a random order, then backwards, gives the
    pictures of a sequential read: each read decodes from the IDR that
    starts its output order cleanly (two here) or on from the last one."""
    writer = syn.Writer(4, width=48, height=32, frames=14, bframes=3, pyramid=True, refs=3,
                        num_ref_idx=3, restriction=True, idr_every=7)
    aus = writer.stream()
    path = tmp_path / "clip.mp4"
    syn.write_mov(path, aus, 48, 32, quicktime=False, audio=False, media_time="ctts",
                  display=writer.display)
    sequential = [h264.frames(path).ycbcr(i) for i in range(14)]
    assert [p[0].tobytes() for p in sequential] == [
        p[0].tobytes() for p in h264.decode_annexb(syn.annexb(aus))]
    frames = h264.frames(path)
    assert frames.starts == [0, 7]
    order = list(np.random.default_rng(0).permutation(14)) + list(range(13, -1, -1))
    for i in order:
        for a, b in zip(frames.ycbcr(int(i)), sequential[int(i)]):
            np.testing.assert_array_equal(a, b)


def test_committed_b_clip_reads_as_in_the_jax_package(tmp_path, capfd):
    """clip_b.mp4, the corpus's x264-like file (1080p High, CABAC, a B-pyramid
    of 3, spatial direct, implicit weights, `ctts` and FFmpeg's edit list):
    the port's probe_video equals the JAX package's, and extract_frames gives
    as many frames in display order, each within the conversion tolerance
    the I_PCM stream of its pictures shows."""
    clip = REPO / "tests" / "data" / "h264" / "clip_b.mp4"
    assert tvideo.probe_video(clip) == jvideo.probe_video(clip) == {
        "width": 1920, "height": 1080, "fps": 30.0, "frame_count": 9}
    ours = tvideo.extract_frames(clip, tmp_path / "ours")
    theirs = jvideo.extract_frames(clip, tmp_path / "theirs")
    capfd.readouterr()
    assert len(ours) == len(theirs) == 9
    frames = h264.frames(clip)
    tol = rgb_tolerance([frames.ycbcr(i) for i in range(9)], (0, 1), tmp_path, capfd)
    for a, b in zip(ours, theirs):
        x, y = tvideo.read_image(a).astype(int), tvideo.read_image(b).astype(int)
        assert x.shape == y.shape == (1080, 1920, 3)
        assert np.abs(x - y).max() <= tol


# ── corrupt B slices ────────────────────────────────────────

FUZZ = r"""
import json, sys
import numpy as np
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]
import torch_h264_syntax as syn
from omfs4d_torch.io import container, h264
rng = np.random.default_rng(1)
out = {"truncated": [], "flipped": []}
for cabac in (False, True):
    w = syn.Writer(5, cabac=cabac, frames=5, bframes=2, refs=2, num_ref_idx=2, width=48,
                   height=32, restriction=True, bipred=1 + cabac)
    aus = w.stream()
    units = [u for au in aus for u in au]
    b_units = [k for k, u in enumerate(units) if u[0] & 0x1F == 1 and k > 2]
    for trial in range(60):
        kind = "truncated" if trial % 2 else "flipped"
        k = b_units[int(rng.integers(len(b_units)))]
        u = bytearray(units[k])
        if kind == "truncated":
            u = u[:int(rng.integers(1, len(u)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                bit = int(rng.integers(8, 8 * len(u)))
                u[bit // 8] ^= 1 << (7 - bit % 8)
        dec = h264.Decoder()
        try:
            for i, x in enumerate(units):
                dec.push(bytes(u) if i == k else x)
            dec.flush()
            out[kind].append("decoded")
        except ValueError:
            out[kind].append("ValueError")
        except container.UnsupportedCodecError:
            out[kind].append("unsupported")
print(json.dumps(out))
"""


def test_corrupt_b_slices_raise_and_never_crash():
    """Truncated B slices raise ValueError; bit-flipped ones raise
    ValueError (or name an unsupported feature, or happen to decode): never
    a crash of the interpreter.  Run in a child process so that a crash
    fails this test."""
    res = subprocess.run([sys.executable, "-c", FUZZ, str(REPO)], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(out["truncated"]) == {"ValueError"}, out
    assert set(out["flipped"]) <= {"ValueError", "unsupported", "decoded"}
    assert out["flipped"].count("ValueError") >= 20, out
