"""The port's colour management (`omfs4d_torch.io.colour`) against cv2, on the
CPU: which tags cv2 maps, in the H.264, HEVC and MPEG-4 readers alike; grey
ramps under HLG, PQ and BT.2020 with BT.709's transfer; each pixel mapped
alone; super-whites, sub-blacks and colours outside the R'G'B' cube; a
`colr` box against the VUI; the mastering display's luminance (SEI 137,
`mdcv`) and what changes nothing (content light levels, the ambient viewing
environment); the transfers swscale refuses; untagged and unmanaged streams
converted as before; and whites other than D65.  Streams are written by the tests' writers
(`torch_h264_syntax.pcm_stream`, `torch_hevc_syntax.Writer`,
`torch_mpeg4_syntax.Writer`); the bounds at flat 16 x 16 blocks' centres
are `test_torch_colour_bounds.py`'s."""

import struct

import numpy as np
import pytest

from omfs4d_torch.io import colour, container, h264, hevc, mpeg4
from tests import torch_h264_syntax as syn
from tests import torch_hevc_syntax as hsyn
from tests import torch_mpeg4_syntax as msyn
from tests.colour_relays import centres, flat_picture, gaps, relay_codes
from tests.test_torch_h264 import cv2_read

# the grid the rule is held on: colour_primaries x transfer_characteristics
GRID_PRIMARIES = (1, 2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 22)
GRID_TRANSFERS = (1, 2, 4, 5, 6, 7, 8, 11, 13, 14, 15, 16, 17, 18)


def noise_planes(seed: int, h: int = 32, w: int = 32):
    rng = np.random.default_rng(seed)
    return (rng.integers(16, 236, (h, w)).astype(np.uint8),
            rng.integers(16, 241, (h // 2, w // 2)).astype(np.uint8),
            rng.integers(16, 241, (h // 2, w // 2)).astype(np.uint8))


def h264_file(path, planes, colour_tags, boxes: bytes = b"", sei=(), bit_depth: int = 8):
    """An `avc1` QuickTime file of I_PCM pictures (8 bits: the port's H.264
    reader reads no High 10)."""
    units = h264.annexb_units(syn.pcm_stream(planes, colour_tags, bit_depth=bit_depth, sei=sei))
    heads = [u for u in units if u[0] & 0x1F in (6, 7, 8)]
    slices = [u for u in units if u[0] & 0x1F == 5]
    syn.write_mov(path, [heads + slices[:1]] + [[s] for s in slices[1:]],
                  planes[0][0].shape[1], planes[0][0].shape[0], boxes=boxes)
    return h264.frames(path)


def hevc_file(path, colour_tags, boxes: bytes = b"", colr=None, sei=(), bit_depth: int = 8):
    aus = hsyn.Writer(5, gop="intra", frames=1, width=64, height=48, colour=colour_tags,
                      sei=sei, bit_depth=bit_depth).stream()
    hsyn.write_mov(path, aus, 64, 48, colour=colr, boxes=boxes, bit_depth=bit_depth)
    return hevc.frames(path)


def mpeg4_file(path, colour_tags, boxes: bytes = b""):
    _, headers, vops = msyn.write_stream(5, frames=1, width=64, height=48, colour=colour_tags)
    msyn.write_mp4(path, headers, vops, 64, 48, boxes=boxes)
    return mpeg4.frames(path)


def first(reader) -> np.ndarray:
    return reader[0] if isinstance(reader, mpeg4.MPEG4Frames) else reader.rgb(0)


# ── which tags cv2 maps ─────────────────────────────────────

def grid_stream(codec: str, pairs) -> tuple[bytes, list[dict]]:
    """One elementary stream of a picture a (primaries, transfer) pair (the
    first untagged), each with its own parameter sets, and the tags the
    port's parser reads from each."""
    data, tags = b"", []
    for p, t in pairs:
        if codec == "h264":
            one = syn.pcm_stream([noise_planes(1)], (0, p, t, 1))
            sps = h264.parse_sps(h264.annexb_units(one)[0])
        elif codec == "hevc":
            aus = hsyn.Writer(5, gop="intra", frames=1, width=64, height=48,
                              colour=(0, p, t, 1)).stream()
            one = b"".join(b"\x00\x00\x00\x01" + u for u in aus[0])
            sps = hevc.parse_sps(next(u for u in aus[0] if hevc.nal_type(u) == hevc.NAL_SPS))
        else:
            _, headers, vops = msyn.write_stream(5, frames=1, width=64, height=48,
                                                 colour=(0, p, t, 1))
            one = headers + b"".join(vops)
            sps = mpeg4.parse_headers(headers)
        data += one
        tags.append(sps)
    return data, tags


def rule_held_to_cv2(tmp_path, capfd, codec: str, pairs) -> None:
    """cv2 changes a picture's colours from the untagged conversion exactly
    where `colour.managed` says, and the port's parser reads the tags."""
    pairs = [(2, 2)] + list(pairs)
    data, tags = grid_stream(codec, pairs)
    path = tmp_path / f"grid.{ {'h264': 'h264', 'hevc': 'hevc', 'mpeg4': 'm4v'}[codec] }"
    path.write_bytes(data)
    frames = cv2_read(path, capfd)
    assert len(frames) == len(pairs)
    wrong = []
    for (p, t), parsed, frame in zip(pairs, tags, frames):
        assert (parsed["primaries"], parsed["transfer"], parsed["matrix"]) == (p, t, 1)
        maps = not np.array_equal(frame, frames[0])
        if maps != colour.managed(parsed["primaries"], parsed["transfer"]):
            wrong.append((p, t, maps))
    assert not wrong


@pytest.mark.parametrize("codec", ["hevc", "mpeg4"])
def test_the_managed_rule_is_cv2s_in_hevc_and_mpeg4(tmp_path, capfd, codec):
    """The grid's rows and columns (every primaries with BT.709's transfer
    and with HLG, every transfer with BT.709's and BT.2020's primaries), one
    picture each with its own parameter sets: cv2 maps exactly the pairs
    `colour.managed` names, and the port's HEVC and MPEG-4 parsers read the
    tags (`test_torch_colour_rule.py` holds the whole grid through H.264;
    swscale rebuilds its table at each managed pair, most of a second)."""
    pairs = sorted({(p, t) for p in GRID_PRIMARIES for t in (1, 18)}
                   | {(p, t) for p in (1, 9) for t in GRID_TRANSFERS})
    rule_held_to_cv2(tmp_path, capfd, codec, pairs)


@pytest.mark.parametrize("transfer", [9, 10])
def test_refused_transfers_raise(tmp_path, transfer):
    """The logarithmic transfers have no EOTF: swscale refuses them ("Unsupported
    input") and cv2 hands back a buffer it never converted; the port's
    readers raise UnsupportedCodecError naming the transfer, with BT.709
    primaries and with BT.2020's."""
    for p in (1, 9):
        with pytest.raises(container.UnsupportedCodecError, match="logarithmic"):
            h264_file(tmp_path / f"{p}.mov", [noise_planes(2)], (0, p, transfer, 1))


# ── grey ramps, each pixel alone, the extremes ──────────────

RAMPS = {"hlg": ((0, 9, 18, 9), 721), "pq": ((0, 9, 16, 9), 579),
         "bt2020-sdr": ((0, 9, 1, 9), 940)}


@pytest.mark.parametrize("ramp", list(RAMPS))
def test_grey_ramps_are_cv2s(tmp_path, capfd, ramp):
    """10-bit greys, Y' from 64 to 1019 in steps of 1: the port's R'G'B'
    equals cv2's within a level; under HLG the output rises almost linearly
    and reaches 255 at 75% signal (Y' 721: 203 cd/m^2 is white), under PQ near
    203 cd/m^2 (Y' 579), above that everything is 255; with BT.709's
    transfer greys are the range expansion (Y' - 64) * 255 / 876."""
    tags, white_at = RAMPS[ramp]
    levels = np.arange(64, 1020)
    codes = np.stack([levels, np.full_like(levels, 512), np.full_like(levels, 512)], 1)
    planes = flat_picture(codes, 10)
    (tmp_path / "ramp.h264").write_bytes(syn.pcm_stream([planes], tags, bit_depth=10))
    (bgr,) = cv2_read(tmp_path / "ramp.h264", capfd)
    theirs = centres(bgr[..., ::-1], len(codes))
    ours = centres(h264.ycbcr_to_rgb(*planes, matrix=9, bit_depth=10, primaries=tags[1],
                                     transfer=tags[2]), len(codes))
    assert np.abs(ours - theirs).max() <= 1
    grey = theirs[:, 1]
    assert (np.diff(grey) >= 0).all()
    if ramp == "bt2020-sdr":
        expected = np.clip(np.rint((levels - 64) * 255 / 876), 0, 255)
        assert np.abs(grey - expected).max() <= 1
    else:
        assert abs(int(levels[np.argmax(grey >= 255)]) - white_at) <= 4
        assert (grey[levels >= white_at + 4] == 255).all()


def test_each_pixel_is_mapped_alone(tmp_path, capfd):
    """Three colours beside random, all-white and all-black neighbours in
    three 10-bit HLG pictures: cv2 gives the same output for them in every
    picture (no frame statistics), and so does the port."""
    rng = np.random.default_rng(3)
    probe = np.array([[400, 300, 700], [700, 600, 400], [500, 512, 512]])
    pictures = []
    for neighbours in (rng.integers(64, 960, (61, 3)), np.tile([940, 512, 512], (61, 1)),
                       np.tile([64, 512, 512], (61, 1))):
        pictures.append(flat_picture(np.concatenate([probe, neighbours]), 10, per_row=16))
    (tmp_path / "alone.h264").write_bytes(syn.pcm_stream(pictures, (0, 9, 18, 9), bit_depth=10))
    outs = cv2_read(tmp_path / "alone.h264", capfd)
    theirs = [centres(o[..., ::-1], 3) for o in outs]
    ours = [centres(h264.ycbcr_to_rgb(*p, matrix=9, bit_depth=10, primaries=9, transfer=18), 3)
            for p in pictures]
    assert all(np.array_equal(theirs[0], t) for t in theirs[1:])
    assert all(np.array_equal(ours[0], o) for o in ours[1:])
    assert np.abs(ours[0] - theirs[0]).max() <= 1


@pytest.mark.parametrize("tags", [(0, 9, 18, 9), (0, 9, 16, 9), (1, 9, 18, 9)],
                         ids=["hlg", "pq", "hlg-full"])
def test_super_whites_sub_blacks_and_colours_outside_the_cube(tmp_path, capfd, tags):
    """Every combination of the extreme codes (Y' 0, 4, 64, 940, 1019, 1023;
    Cb, Cr 0, 64, 512, 960, 1023) at 10 bits, R'G'B' far outside [0, 1]:
    within a mean of 0.5 levels of cv2 and 16 at worst."""
    ys, cs = (0, 4, 64, 940, 1019, 1023), (0, 64, 512, 960, 1023)
    codes = np.array([(y, u, v) for y in ys for u in cs for v in cs])
    planes = flat_picture(codes, 10, per_row=50)
    (tmp_path / "ext.h264").write_bytes(syn.pcm_stream([planes], tags, bit_depth=10))
    (bgr,) = cv2_read(tmp_path / "ext.h264", capfd)
    ours = h264.ycbcr_to_rgb(*planes, full_range=bool(tags[0]), matrix=9, bit_depth=10,
                             primaries=9, transfer=tags[2])
    gap = np.abs(centres(ours, len(codes)) - centres(bgr[..., ::-1], len(codes)))
    assert gap.mean() <= 0.5 and gap.max() <= 16, (gap.mean(), gap.max())


# ── the container's colr box ────────────────────────────────

COLR = {"h264-no-vui": ("h264", None, (9, 18, 9)), "h264-vui": ("h264", (0, 1, 1, 1), (1, 1, 1)),
        "h264-vui-unspecified": ("h264", (0, 2, 2, 1), (2, 2, 1)),
        "hevc-no-vui": ("hevc", None, (2, 2, 2)), "hevc-vui": ("hevc", (0, 1), (1, 1, 1)),
        "mpeg4-no-vo-colour": ("mpeg4", None, (9, 18, 9)),
        "mpeg4-vo-colour": ("mpeg4", (0, 1, 1, 1), (1, 1, 1))}


@pytest.mark.parametrize("case", list(COLR))
def test_a_colr_box_against_the_vui(tmp_path, capfd, case):
    """An iPhone's file carries its tags twice, in the VUI and in a `colr`
    (nclx) box, here BT.2020 / HLG.  FFmpeg's H.264 and MPEG-4 decoders take
    the box's where the stream has no colour description, and the VUI's
    where it has one (even unspecified primaries and transfer); its HEVC
    decoder takes the VUI's alone.  cv2's frame equals its frame of the same
    stream carrying those tags in its VUI and no box; each reader takes the
    same tags, and its frame of a mapped stream is within a level of cv2's
    on average."""
    codec, vui, expected = COLR[case]
    colr = hsyn.colr((0, 9, 18, 9))
    same = (0,) + expected

    def write(name, tags, boxes):
        path = tmp_path / name
        if codec == "h264":
            return h264_file(path, [noise_planes(4)], tags, boxes=boxes), path
        if codec == "hevc":
            return hevc_file(path, tags, colr=(0, 9, 18, 9) if boxes else None), path
        return mpeg4_file(path, tags, boxes=boxes), path

    reader, path = write("colr.mov", vui, colr)
    tags = reader.colour
    assert (tags["primaries"], tags["transfer"], tags["matrix"]) == expected
    # (the HEVC writer draws another picture for another VUI)
    _, plain = write("plain.mov", vui if codec == "hevc" else same, b"")
    (bgr,) = cv2_read(path, capfd)[:1]
    assert np.array_equal(bgr, cv2_read(plain, capfd)[0])
    if colour.managed(*expected[:2]):
        assert np.abs(first(reader).astype(int) - bgr[..., ::-1]).mean() <= 1.0


# ── HDR metadata ────────────────────────────────────────────

MASTERING = syn.mastering_payload(1000, 0.005)
SDR_MASTERING = syn.mastering_payload(600, 0.05)
METADATA = {
    "h264-sei-hlg": ("h264", (0, 9, 18, 9), "sei", MASTERING, "yes"),
    "h264-sei-bt2020-sdr": ("h264", (0, 9, 1, 9), "sei", SDR_MASTERING, "yes"),
    "hevc-sei-hlg": ("hevc", (0, 9, 18, 9), "sei", MASTERING, "yes"),
    "hevc-mdcv-hlg": ("hevc", (0, 9, 18, 9), "box", MASTERING, "yes"),
    "h264-mdcv-bt2020-sdr": ("h264", (0, 9, 1, 9), "box", SDR_MASTERING, "yes"),
    "hevc-sei-pq": ("hevc", (0, 9, 16, 9), "sei", MASTERING, "rounding"),
    "hevc-clli-hlg": ("hevc", (0, 9, 18, 9), "clli", syn.light_level_payload(1000, 400), "no"),
    "hevc-ambient-hlg": ("hevc", (0, 9, 18, 9), "ambient", struct.pack(">IHH", 314000, 15635,
                                                                        16450), "no"),
}


@pytest.mark.parametrize("case", list(METADATA))
def test_hdr_metadata_as_cv2_reads_it(tmp_path, capfd, case):
    """A mastering display's luminance (SEI 137 in the stream, else the
    `mdcv` box) changes cv2's HLG and SDR-transfer output (the source's white
    and black; swscale's black point compensation), and the port's with it;
    PQ's by a level or two at most (its black stays 0 and its EOTF is
    absolute), which the port does not follow; content light levels (SEI
    144) and the ambient viewing environment (SEI 148) change nothing.  The
    port's frame is within a mean of 0.5 levels of cv2's."""
    codec, tags, where, payload, changes = METADATA[case]
    kind = {"clli": 144, "ambient": 148}.get(where, 137)
    sei = [(kind, payload)] if where != "box" else []
    boxes = hsyn._box(b"mdcv", payload) if where == "box" else b""
    planes = [noise_planes(6, 48, 64)]

    def read(name, with_metadata):
        path = tmp_path / name
        if codec == "h264":
            reader = h264_file(path, planes, tags, boxes=boxes if with_metadata else b"",
                               sei=sei if with_metadata else ())
        else:
            reader = hevc_file(path, tags, boxes=boxes if with_metadata else b"",
                               sei=sei if with_metadata else (), bit_depth=10)
        return first(reader).astype(int), cv2_read(path, capfd)[0][..., ::-1].astype(int)

    ours, theirs = read("meta.mov", True)
    plain_ours, plain_theirs = read("plain.mov", False)
    assert np.abs(ours - theirs).mean() <= 0.5
    moved = np.abs(theirs - plain_theirs).max()
    assert moved > 8 if changes == "yes" else moved <= (2 if changes == "rounding" else 0)
    assert (not np.array_equal(ours, plain_ours)) == (changes == "yes")


# ── what is not managed converts as before ──────────────────

UNMANAGED = [(2, 2), (1, 1), (1, 2), (2, 1), (5, 5), (6, 6), (4, 4), (7, 7), (1, 17), (6, 13),
             (1, 8), (4, 14)]


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_untagged_and_unmanaged_streams_convert_as_before(bit_depth):
    """Tags cv2 does not map (BT.709, BT.470, SMPTE 170M / 240M primaries,
    or unspecified ones, with an SDR transfer) leave `ycbcr_to_rgb` bit for
    bit what it was with the matrix and range alone, at 8 and 10 bits, in
    both ranges and for every matrix."""
    rng = np.random.default_rng(bit_depth)
    dtype = np.uint8 if bit_depth == 8 else np.uint16
    y = rng.integers(0, 1 << bit_depth, (32, 48)).astype(dtype)
    cb, cr = (rng.integers(0, 1 << bit_depth, (16, 24)).astype(dtype) for _ in range(2))
    for full in (False, True):
        for matrix in (1, 2, 5, 6, 9):
            before = h264.ycbcr_to_rgb(y, cb, cr, full_range=full, matrix=matrix,
                                       bit_depth=bit_depth)
            for p, t in UNMANAGED:
                assert not colour.managed(p, t)
                assert np.array_equal(before, h264.ycbcr_to_rgb(
                    y, cb, cr, full_range=full, matrix=matrix, bit_depth=bit_depth,
                    primaries=p, transfer=t))


# ── white points other than D65 ─────────────────────────────

WHITES = [(11, 17, 1), (11, 1, 1), (8, 1, 1), (10, 1, 1), (4, 16, 1), (4, 18, 1)]


@pytest.mark.parametrize("tags", WHITES, ids=[f"{p}-{t}-{m}" for p, t, m in WHITES])
def test_other_white_points_are_held_to_cv2(tmp_path, capfd, tags):
    """DCI-P3 with the DCI white (11, here also with SMPTE 428's transfer),
    film and BT.470 M with illuminant C (8, 4), XYZ with E (10): swscale
    takes those whites to D65 by CAT16 before its LMS, and so does the
    table.  10-bit relays of 2048 colours in the R'G'B' cube and 1024 over
    the whole code range, within the bounds of `test_torch_colour_bounds.py`."""
    p, t, m = tags
    codes = relay_codes([p, t, m], 10, m, False)
    planes = flat_picture(codes, 10)
    (tmp_path / "w.h264").write_bytes(syn.pcm_stream([planes], (0, p, t, m), bit_depth=10))
    (bgr,) = cv2_read(tmp_path / "w.h264", capfd)
    ours = h264.ycbcr_to_rgb(*planes, matrix=m, bit_depth=10, primaries=p, transfer=t)
    g = gaps(centres(ours, len(codes)), centres(bgr[..., ::-1], len(codes)))
    assert g["cube_mean"] <= 0.3 and g["cube_max"] <= 8, g
    assert g["whole_mean"] <= 0.5 and g["whole_max"] <= 16, g


def test_a_cut_or_foreign_sei_gives_no_mastering_display():
    """SEI RBSPs cut short, or of other payloads, read as no mastering
    display and never raise; a whole SEI 137 reads its luminance."""
    whole = syn.sei_rbsp([(137, syn.mastering_payload(1000, 0.005))])
    assert colour.mastering_from_sei(whole) == colour.Mastering(0.005, 1000)
    for cut in range(len(whole) - 1):
        assert colour.mastering_from_sei(whole[:cut]) in (None, colour.Mastering(0.005, 1000))
    assert colour.mastering_from_sei(syn.sei_rbsp([(144, syn.light_level_payload(9, 9))])) is None
    assert colour.mastering_from_sei(b"\xff" * 40) is None
