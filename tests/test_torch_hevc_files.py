"""HEVC files read by the port as the JAX package reads them through cv2, on
the CPU, with no ffmpeg: MP4 and QuickTime (`hvc1` / `hev1`, `ctts`, edit
lists, display matrices), `HEVCFrames`' restarts, and the committed corpus
(`tests/data/hevc/`, written by `tests/make_hevc_corpus.py`), which decodes
to its manifest and whose clips read as in the JAX package; the Main 10
clips too, the HLG one colour-managed as cv2 maps it."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from omfs4d.io import video as jvideo
from omfs4d_torch.io import container, hevc
from omfs4d_torch.io import video as tvideo
from tests import torch_hevc_syntax as syn
from tests.test_torch_h264_high import PATH_BOUND, planes_sha, rgb_tolerance

CORPUS = Path(__file__).resolve().parent / "data" / "hevc"


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)


# ── files ───────────────────────────────────────────────────

FILES = [("mp4", "ctts", b"hvc1", 0), ("mov", "ctts", b"hev1", 90), ("mov", None, b"hvc1", 180),
         ("mp4", 0, b"hev1", 270), ("mov", 2400, b"hvc1", 0)]


@pytest.mark.parametrize("kind, media_time, entry, rotation", FILES,
                         ids=[f"{k}-{e.decode()}-{m}-{r}" for k, m, e, r in FILES])
def test_files_read_as_in_the_jax_package(tmp_path, capfd, kind, media_time, entry, rotation):
    """A B-pyramid stream with a mid-stream CRA and its RASL and RADL
    pictures in QuickTime or MP4, parameter sets in hvcC (`hvc1`) or in band
    (`hev1`), `ctts` as FFmpeg's mov muxer writes it, an edit list starting
    at the first composition offset, at none, earlier or later, and a display
    rotation: the port's probe_video and extract_frames give the JAX
    package's size, fps, count and frames, the pixels within the conversion
    tolerance the I_PCM stream shows."""
    colour = (0, 1)
    writer = syn.Writer(3, gop="pyramid", frames=9, cra=True, width=64, height=48, colour=colour)
    aus = writer.stream()
    assert writer.display != sorted(writer.display)
    path = tmp_path / f"clip.{kind}"
    syn.write_mov(path, aus, 64, 48, fps=30, rotation=rotation, quicktime=kind == "mov",
                  audio=kind == "mov", media_time=media_time, sample_entry=entry,
                  display=writer.display)
    info = container.index(path)[2]
    assert info["codec"] == "hevc" and info["times"] != sorted(info["times"])
    assert tvideo.probe_video(path) == jvideo.probe_video(path)
    ours = tvideo.extract_frames(path, tmp_path / "ours")
    theirs = jvideo.extract_frames(path, tmp_path / "theirs")
    capfd.readouterr()
    assert len(ours) == len(theirs) == (9 if media_time in ("ctts", None) else
                                        len(hevc.frames(path)))
    frames = hevc.frames(path)
    planes = [frames.ycbcr(i) for i in range(len(frames))]
    tol = rgb_tolerance(planes, colour, tmp_path, capfd)
    shape = (64, 48, 3) if rotation in (90, 270) else (48, 64, 3)
    for a, b in zip(ours, theirs):
        x, y = tvideo.read_image(a).astype(int), tvideo.read_image(b).astype(int)
        assert x.shape == y.shape == shape
        assert np.abs(x - y).max() <= tol


def test_random_order_reads_equal_a_sequential_one(tmp_path):
    """`HEVCFrames` read in a random order, then backwards, gives the
    pictures of a sequential read: each read decodes from the IDR that
    starts its output order cleanly (the CRA, whose RASL pictures precede it
    in output order, is no start) or on from the last one decoded."""
    writer = syn.Writer(4, gop="pyramid", frames=13, cra=True, width=48, height=32)
    aus = writer.stream()
    path = tmp_path / "clip.mp4"
    syn.write_mov(path, aus, 48, 32, quicktime=False, audio=False, media_time="ctts",
                  display=writer.display)
    sequential = [hevc.frames(path).ycbcr(i) for i in range(13)]
    assert [p[0].tobytes() for p in sequential] == [
        p[0].tobytes() for p in hevc.decode_annexb(syn.annexb(aus))]
    frames = hevc.frames(path)
    assert frames.sync == [0, 5] and frames.starts == [0]
    order = list(np.random.default_rng(0).permutation(13)) + list(range(12, -1, -1))
    for i in order:
        for a, b in zip(frames.ycbcr(int(i)), sequential[int(i)]):
            np.testing.assert_array_equal(a, b)


# ── the committed corpus ────────────────────────────────────

def test_corpus_decodes_to_its_manifest():
    """Every file of `tests/data/hevc/` has its manifest's SHA-256 and
    decodes to the SHA-256s of its pictures there (written once cv2 agreed
    with them); the portrait QuickTime stream reads as a portrait."""
    manifest = json.loads((CORPUS / "manifest.json").read_text())
    assert sum(p.stat().st_size for p in CORPUS.iterdir()) <= 1024 * 1024
    for name, entry in manifest["streams"].items():
        path = CORPUS / name
        assert hashlib.sha256(path.read_bytes()).hexdigest() == entry["file_sha256"], name
        if path.suffix in (".mov", ".mp4"):
            frames = hevc.frames(path)
            pics = [frames.ycbcr(i) for i in range(len(frames))]
        else:
            pics = hevc.decode_annexb(path.read_bytes())
        assert [planes_sha(p) for p in pics] == entry["sha256"], name
    probe = tvideo.probe_video(CORPUS / "portrait.mov")
    assert probe["height"] > probe["width"]


# clip_hevc10.mp4's largest and mean difference from the JAX package's frames
# (cv2's conversion of yuv420p10le): swscale's scaled path, which the port
# runs bit for bit (`omfs4d_torch.io.swscale`); its float model before was
# 41 and 0.209 off
MAIN10_TOLERANCE, MAIN10_MEAN = PATH_BOUND["scaled"], 0.0


@pytest.mark.parametrize("name", ["clip_hevc.mp4", "portrait.mov", "clip_hevc10.mp4"])
def test_committed_clips_read_as_in_the_jax_package(tmp_path, capfd, name):
    """clip_hevc.mp4 (x265's layout at 1080p: WPP, SAO, TMVP, a B-pyramid, a
    mid-clip CRA with RASL pictures, `ctts` and FFmpeg's edit list), the
    portrait `hev1` QuickTime stream and clip_hevc10.mp4 (Main 10 in
    clip_hevc.mp4's layout, BT.709): the port's probe_video equals the JAX
    package's, and extract_frames gives as many frames, each within the
    conversion's fixed bound once the I_PCM stream of its pictures holds it
    (the 8-bit clips) or `MAIN10_TOLERANCE` (the Main 10 one, its mean
    difference within `MAIN10_MEAN`): 0, bit for bit, on both."""
    clip = CORPUS / name
    probe = tvideo.probe_video(clip)
    assert probe == jvideo.probe_video(clip)
    ours = tvideo.extract_frames(clip, tmp_path / "ours")
    theirs = jvideo.extract_frames(clip, tmp_path / "theirs")
    capfd.readouterr()
    frames = hevc.frames(clip)
    assert len(ours) == len(theirs) == len(frames) == probe["frame_count"]
    if frames.params["bit_depth"] == 10:
        means = []
        for a, b in zip(ours, theirs):
            x, y = tvideo.read_image(a).astype(int), tvideo.read_image(b).astype(int)
            assert x.shape == y.shape == (probe["height"], probe["width"], 3)
            assert np.abs(x - y).max() <= MAIN10_TOLERANCE
            means.append(np.abs(x - y).mean())
        assert np.mean(means) <= MAIN10_MEAN
        return
    tol = rgb_tolerance([frames.ycbcr(i) for i in range(len(frames))], (0, 1), tmp_path, capfd)
    for a, b in zip(ours, theirs):
        x, y = tvideo.read_image(a).astype(int), tvideo.read_image(b).astype(int)
        assert x.shape == y.shape == (probe["height"], probe["width"], 3)
        assert np.abs(x - y).max() <= tol


# clip_hevc10.mov against the JAX package's frames: cv2 colour-manages a
# stream tagged BT.2020 / HLG (its swscale maps the gamut and the tone), and
# so does the port (`omfs4d_torch.io.colour`): the bounds, and the largest
# difference measured (before the mapping: 206 at worst, 21.54 on average)
HLG_MEAN, HLG_P999, HLG_GAP_MAX = 1.0, 10, 5


def test_hdr_clip_reads_exactly_and_as_cv2_maps_its_colour(tmp_path, capfd):
    """clip_hevc10.mov, laid out as an iPhone HDR capture (QuickTime, `hvc1`
    Main 10, 1920 x 1080 coded as 1088, HLG tags in the VUI and a `colr`
    box, a sound track): its probe, frame count and shape equal the JAX
    package's, and its five frames are within a mean of `HLG_MEAN` levels
    and a 99.9th percentile of `HLG_P999` of the JAX package's, the largest
    difference the number measured (`HLG_GAP_MAX`); no line says that
    colour management is not applied."""
    clip = CORPUS / "clip_hevc10.mov"
    frames = hevc.frames(clip)
    assert (frames.params["bit_depth"], frames.params["primaries"], frames.params["transfer"],
            frames.params["matrix"]) == (10, 9, 18, 9)
    assert frames.info["codec"] == "hevc" and container.index(clip)[2]["container"] == "mp4"
    probe = tvideo.probe_video(clip)
    assert probe == jvideo.probe_video(clip) == {"width": 1920, "height": 1080, "fps": 30.0,
                                                  "frame_count": 5}
    capfd.readouterr()
    ours = tvideo.extract_frames(clip, tmp_path / "ours")
    assert "colour management" not in capfd.readouterr().out
    theirs = jvideo.extract_frames(clip, tmp_path / "theirs")
    capfd.readouterr()
    assert len(ours) == len(theirs) == 5
    gaps = []
    for a, b in zip(ours, theirs):
        x, y = tvideo.read_image(a).astype(int), tvideo.read_image(b).astype(int)
        assert x.shape == y.shape == (1080, 1920, 3)
        gaps.append(np.abs(x - y).ravel())
    gaps = np.concatenate(gaps)
    assert gaps.mean() <= HLG_MEAN and np.percentile(gaps, 99.9) <= HLG_P999
    assert int(gaps.max()) == HLG_GAP_MAX


def test_hevc_times_script_times_each_tree(capsys):
    """`omfs4d_torch.scripts.hevc_times` (the tree-against-tree timing on the
    card) runs here: one JSON line a tree and run, every picture of the clip
    timed by slice type, and a table of medians."""
    from omfs4d_torch.scripts import hevc_times

    repo = Path(__file__).resolve().parent.parent
    assert hevc_times.main(["--trees", str(repo), "--clips", "portrait.mov", "--reps", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    lines = [json.loads(line) for line in out if line.startswith("{")]
    assert len(lines) == 2
    kinds = json.loads((CORPUS / "manifest.json").read_text())["streams"]["portrait.mov"]["kinds"]
    for line in lines:
        timed = line["clips"]["portrait.mov"]
        assert sorted(k for k, v in timed.items() for _ in v) == sorted(kinds)
        assert all(t > 0 for v in timed.values() for t in v)
    assert any(line.startswith("median host s a picture") for line in out)
