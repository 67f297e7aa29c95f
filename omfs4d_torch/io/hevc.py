"""HEVC (ITU-T H.265 | ISO/IEC 23008-2) in MP4 and QuickTime, read on the host
with no ffmpeg: the video that phones record by default (an iPhone's "High
Efficiency" format and its "HDR Video", which is Main 10; many Android camera
apps) and that `ffmpeg -c:v libx265` writes.

The reader (`frames`, `HEVCFrames`, `decode_annexb`) is the host C++ decoder
`hevcdec.cpp` (`Decoder`), built by g++ at first use into
`omfs4d_torch/_build/` (no Python fallback: without g++ reading raises with
the reason) and bound with ctypes.  It decodes the Main, Main 10 and Main
Still Picture profiles whole, 4:2:0 at 8, 9 or 10 bits (deeper pictures come
out as uint16 planes of the samples themselves): I, P and B slices, CABAC with
wavefront parallel processing, tiles, SAO and deblocking, several and
dependent slice segments, TMVP, weighted prediction, long-term reference
pictures, scaling lists, PCM, transquant bypass, temporal sub-layers, CRA with
RASL and RADL pictures, output in POC order cropped by the conformance window
(not by the VUI's default display window, which FFmpeg does not apply
either).
`HEVCFrames` shows a file's frames as cv2 does (`frames.SampleFrames`): in
presentation order (`ctts`), those its edit list keeps, turned by the
track's display matrix, converted with the VUI's range, matrix, primaries,
transfer and chroma siting as cv2 converts them (`h264.ycbcr_to_rgb`:
swscale's unscaled path for 8-bit pictures, its scaled path for 9- and
10-bit ones, each bit for bit).  A stream whose tags cv2 colour-manages (an
iPhone's HDR capture, BT.2020 / HLG; HDR10, BT.2020 / PQ) is mapped as cv2
maps it (`colour`), with the mastering display's luminance of an SEI 137 in
the hvcC box or the first sample, else of the `mdcv` box; FFmpeg takes the
tags from the VUI alone, and so does the reader (a `colr` box changes
nothing).  An `hvc1` track's parameter sets are its hvcC box's; an `hev1`
track may carry them in band.

Refused by name, with no decode, where the parameter sets show it (here, in
`parse_sps` / `parse_pps`, and again in the decoder): bit depths above 10 and
luma and chroma depths that differ (the range extension profiles), chroma
formats other than 4:2:0, the SPS / PPS range, multilayer, 3D and screen
content extensions, and tiles with wavefront parallel processing together
(which later editions allow in Main, and cv2's FFmpeg decodes otherwise than
the standard): each raises `container.UnsupportedCodecError` naming it and
ffmpeg.  NAL units of a layer above the base (`nuh_layer_id` > 0) are
skipped, as FFmpeg skips them, and so are those of the unspecified types
48-63 (a Dolby Vision stream's RPUs).  A corrupt unit raises ValueError.  The
tables are `hevc_tables`'.
"""

from __future__ import annotations

import ctypes
import functools
from fractions import Fraction
from pathlib import Path

import numpy as np

from omfs4d_torch.io import colour, container, h264, hevc_tables, swscale
from omfs4d_torch.io import frames as frames_base

NAL_SPS, NAL_PPS, NAL_SEI_PREFIX = 33, 34, 39
NAL_VPS, NAL_CRA = 32, 21
# the VCL types of trailing pictures (TRAIL, TSA, STSA), RASL pictures,
# IRAP pictures (BLA, IDR, CRA and the reserved IRAP types) and BLA pictures
_TRAILING, _RASL, _IRAP, _BLA = range(0, 6), (8, 9), range(16, 24), (16, 17, 18)


def nal_type(unit: bytes) -> int:
    return (unit[0] >> 1) & 63


def nuh_layer_id(unit: bytes) -> int:
    return (unit[0] & 1) << 5 | unit[1] >> 3


def _unsupported(what: str) -> container.UnsupportedCodecError:
    return container.UnsupportedCodecError(
        f"HEVC {what} is outside the port's HEVC decoder (the Main and Main 10 profiles, "
        "4:2:0 at 8 to 10 bits, with no range, multilayer, 3D or screen content coding "
        "extension); decoding it needs an ffmpeg binary (on PATH or from imageio_ffmpeg)")


# ── parameter sets, with no decode ──────────────────────────────────────

class _Reader:
    """Bits of an rbsp (emulation prevention removed)."""

    def __init__(self, rbsp: bytes):
        self.data, self.pos = rbsp, 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.pos >= 8 * len(self.data):
                raise ValueError("HEVC: a parameter set is cut short")
            v = v << 1 | (self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
            self.pos += 1
        return v

    def ue(self) -> int:
        z = 0
        while not self.u(1):
            z += 1
            if z > 31:
                raise ValueError("HEVC: an Exp-Golomb code longer than 63 bits")
        return (1 << z) - 1 + self.u(z)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def _rbsp(unit: bytes) -> bytes:
    """The rbsp of a NAL unit: its 2-byte header dropped, 00 00 03 -> 00 00."""
    return h264._unescape(unit[2:])


def _profile_tier_level(r: _Reader, max_sub_layers_minus1: int) -> int:
    r.u(2 + 1)
    profile = r.u(5)
    r.u(32 + 4 + 43 + 1 + 8)
    flags = [(r.u(1), r.u(1)) for _ in range(max_sub_layers_minus1)]
    if max_sub_layers_minus1:
        r.u(2 * (8 - max_sub_layers_minus1))
    for prof, lev in flags:
        r.u(88 * prof + 8 * lev)
    return profile


def _st_ref_pic_set(r: _Reader, idx: int, num: int, sets: list[list[int]]) -> list[int]:
    """The delta POCs of short-term RPS idx (7.3.7, 7.4.8)."""
    if idx and r.u(1):
        delta_idx = r.ue() + 1 if idx == num else 1
        if not 0 <= idx - delta_idx < len(sets):
            raise ValueError("HEVC: an RPS predicted from no RPS")
        ref = sets[idx - delta_idx]
        delta = (1 - 2 * r.u(1)) * (r.ue() + 1)
        out = []
        for d in ref + [0]:
            used = r.u(1)
            if used or r.u(1):
                if d + delta != 0:
                    out.append(d + delta)
        return out
    neg, pos = r.ue(), r.ue()
    if neg > 16 or pos > 16 - neg:
        raise ValueError("HEVC: an RPS of more than 16 pictures")
    out, poc = [], 0
    for _ in range(neg):
        poc -= r.ue() + 1
        r.u(1)
        out.append(poc)
    poc = 0
    for _ in range(pos):
        poc += r.ue() + 1
        r.u(1)
        out.append(poc)
    return out


def _extensions(r: _Reader, what: str) -> None:
    if r.u(1):
        names = (("range extension", "range"), ("multilayer extension", "multilayer"),
                 ("3D extension", "3d"), ("screen content coding extension", "scc"))
        for name, flag in names:
            if r.u(1):
                raise _unsupported(f"{what} {name} ({what.lower()}_{flag}_extension_flag)")
        if r.u(4):
            raise _unsupported(f"{what} extension ({what.lower()}_extension_4bits)")


def _scaling_list_data(r: _Reader) -> None:
    """Skip scaling_list_data() (7.3.4)."""
    for size_id in range(4):
        for matrix_id in range(0, 6, 3 if size_id == 3 else 1):
            if not r.u(1):
                if r.ue() > matrix_id // (3 if size_id == 3 else 1):
                    raise ValueError("HEVC: scaling_list_pred_matrix_id_delta out of range")
                continue
            if size_id > 1:
                r.se()
            for _ in range(16 if size_id == 0 else 64):
                r.se()


def parse_sps(unit: bytes) -> dict:
    """What `probe`, the colour conversion and the refusal need of an SPS NAL
    unit: id, the cropped width and height, bit_depth (luma = chroma), fps
    from the VUI's timing (0.0 where it has none), full_range, and primaries,
    transfer and matrix (colour_primaries, transfer_characteristics,
    matrix_coeffs; 2, unspecified, where the VUI has none), and the chroma
    siting as FFmpeg's decoder gives it (`location`, an AVChromaLocation:
    the VUI's chroma_sample_loc_type_top_field + 1, else left).  Raises
    `container.UnsupportedCodecError` for what the decoder refuses."""
    r = _Reader(_rbsp(unit))
    r.u(4)
    msl = r.u(3)
    r.u(1)
    profile = _profile_tier_level(r, msl)
    sps = {"id": r.ue(), "profile": profile, "fps": 0.0, "full_range": False, "primaries": 2,
           "transfer": 2, "matrix": 2, "location": swscale.LEFT}
    chroma = r.ue()
    if chroma != 1:
        names = {0: "4:0:0 (monochrome)", 2: "4:2:2", 3: "4:4:4"}
        raise _unsupported(f"chroma format {names.get(chroma, chroma)} (a range extension "
                           "profile)")
    width, height = r.ue(), r.ue()
    crop = [0, 0, 0, 0]
    if r.u(1):
        crop = [2 * r.ue() for _ in range(4)]
    sps["width"], sps["height"] = width - crop[0] - crop[1], height - crop[2] - crop[3]
    depth, depth_c = r.ue() + 8, r.ue() + 8
    depths = f"{depth}-bit luma, {depth_c}-bit chroma: a range extension profile"
    if depth > 10 or depth_c > 10:
        raise _unsupported(f"bit depth above 10 ({depths})")
    if depth != depth_c:
        raise _unsupported(f"luma and chroma bit depths that differ ({depths})")
    sps["bit_depth"] = depth
    log2_max_poc_lsb = r.ue() + 4
    ordering = r.u(1)
    for _ in range(msl + 1 if ordering else 1):
        r.ue(), r.ue(), r.ue()
    for _ in range(6):
        r.ue()
    if r.u(1) and r.u(1):                              # scaling lists, coded in the SPS
        _scaling_list_data(r)
    r.u(2)                                             # amp, sample_adaptive_offset
    if r.u(1):                                         # PCM: depths, sizes, loop filter
        r.u(8)
        r.ue(), r.ue()
        r.u(1)
    num = r.ue()
    if num > 64:
        raise ValueError("HEVC: num_short_term_ref_pic_sets above 64")
    sets: list[list[int]] = []
    for i in range(num):
        sets.append(_st_ref_pic_set(r, i, num, sets))
    if r.u(1):                                         # long-term reference pictures
        for _ in range(r.ue()):
            r.u(log2_max_poc_lsb + 1)
    r.u(2)                                             # temporal MVP, strong intra smoothing
    if r.u(1):                                         # vui_parameters
        if r.u(1) and r.u(8) == 255:
            r.u(32)
        if r.u(1):
            r.u(1)
        if r.u(1):
            r.u(3)
            sps["full_range"] = bool(r.u(1))
            if r.u(1):
                sps["primaries"], sps["transfer"], sps["matrix"] = r.u(8), r.u(8), r.u(8)
        if r.u(1):                                     # chroma_loc_info: the top field's
            top = r.ue()
            r.ue()
            sps["location"] = top + 1 if top <= 5 else 0
        r.u(3)
        if r.u(1):                                     # the default display window: not applied
            for _ in range(4):
                r.ue()
        if r.u(1):
            tick, scale = r.u(32), r.u(32)
            if tick:
                sps["fps"] = scale / tick
            if tick and scale:                         # FFmpeg's frame rate
                sps["rate"] = Fraction(scale, tick)
            if r.u(1):
                r.ue()
            if r.u(1):
                _hrd(r, msl)
        if r.u(1):
            r.u(3)
            for _ in range(5):
                r.ue()
    _extensions(r, "SPS")
    return sps


def _hrd(r: _Reader, max_sub_layers_minus1: int) -> None:
    """Skip hrd_parameters(1, max_sub_layers_minus1) (E.2.2)."""
    nal, vcl, sub_pic = r.u(1), r.u(1), 0
    if nal or vcl:
        sub_pic = r.u(1)
        r.u(19 * sub_pic + 8 + 4 * sub_pic + 15)
    for _ in range(max_sub_layers_minus1 + 1):
        within = 1 if r.u(1) else r.u(1)
        low_delay = 0
        if within:
            r.ue()
        else:
            low_delay = r.u(1)
        cpb = 1 if low_delay else r.ue() + 1
        for _ in range((nal + vcl) * cpb):
            for _ in range(4 if sub_pic else 2):
                r.ue()
            r.u(1)


def vps_rate(unit: bytes) -> Fraction | None:
    """The frame rate of a VPS's timing information (vps_time_scale /
    vps_num_units_in_tick), None where it has none: FFmpeg takes it before
    the SPS's VUI timing."""
    r = _Reader(_rbsp(unit))
    r.u(4 + 1 + 1 + 6)
    msl = r.u(3)
    r.u(1 + 16)
    _profile_tier_level(r, msl)
    for _ in range(msl + 1 if r.u(1) else 1):
        r.ue()
        r.ue()
        r.ue()
    max_layer_id = r.u(6)
    r.u(r.ue() * (max_layer_id + 1))
    if not r.u(1):
        return None
    tick, scale = r.u(32), r.u(32)
    return Fraction(scale, tick) if tick and scale else None


def parse_pps(unit: bytes) -> dict:
    """A PPS NAL unit's id and SPS id; raises `container.UnsupportedCodecError`
    for what the decoder refuses."""
    r = _Reader(_rbsp(unit))
    pps = {"id": r.ue(), "sps_id": r.ue()}
    r.u(1 + 1 + 3 + 1 + 1)
    r.ue(), r.ue(), r.se()
    r.u(2)
    if r.u(1):
        r.ue()
    r.se(), r.se()
    r.u(4)                                             # ..., transquant bypass
    tiles, wpp = r.u(1), r.u(1)
    if tiles:
        cols, rows = r.ue() + 1, r.ue() + 1
        if not r.u(1):                                 # explicit widths and heights
            for _ in range(cols + rows - 2):
                r.ue()
        r.u(1)
        if wpp:
            raise _unsupported("tiles with wavefront parallel processing (tiles_enabled_flag and "
                               "entropy_coding_sync_enabled_flag both 1)")
    r.u(1)
    if r.u(1):
        r.u(1)
        if not r.u(1):
            r.se(), r.se()
    if r.u(1):
        _scaling_list_data(r)
    r.u(1)
    r.ue()
    r.u(1)
    _extensions(r, "PPS")
    return pps


def hvcc_units(hvcc: bytes, path) -> tuple[list[bytes], int]:
    """(the parameter set NAL units, NAL length size) of an hvcC box's body;
    an `hev1` track may hold none, its parameter sets being in band."""
    if len(hvcc) < 23 or hvcc[0] != 1:
        raise ValueError(f"{path}: an hvcC box of version {hvcc[:1].hex() or 'none'}")
    length = (hvcc[21] & 3) + 1
    pos, units = 23, []
    for _ in range(hvcc[22]):
        if pos + 3 > len(hvcc):
            raise ValueError(f"{path}: the hvcC box is cut short")
        count = int.from_bytes(hvcc[pos + 1:pos + 3], "big")
        pos += 3
        for _ in range(count):
            size = int.from_bytes(hvcc[pos:pos + 2], "big")
            unit = hvcc[pos + 2:pos + 2 + size]
            if pos + 2 > len(hvcc) or len(unit) != size or size < 2:
                raise ValueError(f"{path}: a parameter set of the hvcC box is cut short")
            units.append(unit)
            pos += 2 + size
    return units, length


# ── the host decoder ────────────────────────────────────────────────────

_SOURCE = Path(__file__).resolve().with_name("hevcdec.cpp")
_GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use, with g++, into `omfs4d_torch/_build/`) and load
    the host decoder; raises RuntimeError with g++'s message when it cannot:
    no frame is decoded in Python on the reading path."""
    from omfs4d_torch import native

    path = native.build(_SOURCE, "hevcdec", _GXX_FLAGS,
                        "omfs4d_torch/io/hevcdec.cpp (the HEVC decoder)",
                        headers={"hevc_tables.h": hevc_tables.cpp_header()})
    return frames_base.bind_decoder(ctypes.CDLL(str(path)), "hevcd")


class Decoder(frames_base.HostDecoder):
    """The host C++ decoder (`hevcdec.cpp`), as `frames.HostDecoder` sets
    out."""

    prefix, codec = "hevcd", "HEVC"

    def library(self) -> ctypes.CDLL:
        return _library()

    def unsupported(self, msg: str) -> container.UnsupportedCodecError:
        return _unsupported(msg.removeprefix("HEVC "))


# an Annex B stream's NAL units: the same start codes as H.264's
annexb_units = h264.annexb_units


def decode_annexb(data: bytes) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Every picture of an Annex B HEVC stream, through the host decoder, in
    output order."""
    dec = Decoder()
    out = []
    for unit in annexb_units(data):
        dec.push(unit)
        out += dec.pictures()
    dec.flush()
    return out + dec.pictures()


def _first_irap(kinds: list[list[int]]) -> int:
    """The first sample holding an IRAP picture (len(kinds) where none
    does)."""
    return next((s for s, k in enumerate(kinds) if any(t in _IRAP for t in k)), len(kinds))


def _clean_start(kinds: list[list[int]], s: int, extradata_sets: bool) -> bool:
    """Whether an Annex B stream's decode may restart at sample s (the NAL
    types of every sample's base layer): it holds an IRAP picture and the
    parameter sets (its own or the extradata's), and no RASL picture of a
    mid-stream CRA follows it, which a decode started there would drop (the
    stream's first IRAP's RASL pictures FFmpeg drops either way)."""
    k = kinds[s]
    if not any(t in _IRAP for t in k):
        return False
    if not (extradata_sets or {NAL_VPS, NAL_SPS, NAL_PPS} <= set(k)):
        return False
    if s > _first_irap(kinds) and NAL_CRA in k:
        for later in kinds[s + 1:]:
            if any(t in _RASL for t in later):
                return False
            if any(t in _TRAILING or t in _IRAP for t in later):
                break
    return True


def _dropped_rasl(kinds: list[list[int]]) -> set[int]:
    """The samples of an Annex B stream (the NAL types of every sample's
    base layer) that output no picture: those of RASL pictures alone whose
    IRAP picture is a BLA or the stream's first, which FFmpeg drops, and
    those of no picture at all."""
    out, irap, first = set(), None, _first_irap(kinds)
    for s, k in enumerate(kinds):
        vcl = [t for t in k if t < 32]
        if not vcl:
            out.add(s)
        elif any(t in _IRAP for t in vcl):
            irap = (s, next(t for t in vcl if t in _IRAP))
        elif all(t in _RASL for t in vcl) and irap is not None and (
                irap[0] == first or irap[1] in _BLA):
            out.add(s)
    return out


class HEVCFrames(frames_base.SampleFrames):
    """The frames of an HEVC file (MP4 / QuickTime, Matroska, AVI) as (H, W,
    3) uint8 RGB, decoded by the host decoder on access, as cv2 shows them
    (see `frames.SampleFrames`), converted with the VUI's range and matrix.
    The parameter sets are the hvcC box's and, for `hev1`, the first
    sample's; an Annex B track's (AVI, MPEG-TS) are its extradata's and its
    first restart's.  An AVI or MPEG-TS track, which has no sync table,
    restarts only where `_clean_start` allows; the samples before the first
    restart show nothing, as FFmpeg drops the pictures before an IRAP one."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        super().__init__(path, offsets, sizes, info)
        if "hvcC" in info:
            self.headers, self.length = hvcc_units(info["hvcC"], path)
        else:                                  # Annex B samples
            self.headers, self.length = annexb_units(info["annexb"]), 0
        first = 0
        if "sync" not in info:                 # AVI, MPEG-TS: no sync table
            sets = {nal_type(u) for u in self.headers if nuh_layer_id(u) == 0}
            extradata_sets = {NAL_VPS, NAL_SPS, NAL_PPS} <= sets
            self.in_band_starts(
                lambda u: nal_type(u) if nuh_layer_id(u) == 0 else -1,
                lambda kinds, s: _clean_start(kinds, s, extradata_sets), _dropped_rasl)
            first = self.starts[0] if self.starts else 0
        # refuse a stream outside the decoder's subset now, with no decode
        base = [u for u in self.headers + (self.units(first) if offsets else [])
                if nuh_layer_id(u) == 0]
        sps = [parse_sps(u) for u in base if nal_type(u) == NAL_SPS]
        for unit in base:
            if nal_type(unit) == NAL_PPS:
                parse_pps(unit)
        if not sps:
            raise ValueError(f"{path}: no sequence parameter set in the hvcC box or the first "
                             "sample")
        self.params = sps[0]
        mastering = colour.mastering_of(
            (_rbsp(u) for u in base if nal_type(u) == NAL_SEI_PREFIX), info)
        # FFmpeg's HEVC decoder takes the VUI's tags alone: a `colr` box changes nothing
        self.colour = dict(colour.stream(colour.from_container(self.params, None),
                                         self.params["bit_depth"], mastering),
                           location=self.params["location"])

    def header_units(self) -> list[bytes]:
        return self.headers

    def new_decoder(self) -> Decoder:
        return Decoder()

    def rgb_of(self, planes) -> np.ndarray:
        return h264.ycbcr_to_rgb(*planes, **self.colour)


def frames(path) -> HEVCFrames:
    """The frames of an HEVC (`hvc1` / `hev1`) MP4 or QuickTime file, decoded
    on access by the host decoder; parameter sets outside its subset
    raise."""
    offsets, sizes, info = container.index(path)
    if info["codec"] != "hevc":
        raise ValueError(f"{path}: its video is not HEVC")
    return HEVCFrames(Path(path), offsets, sizes, info)
