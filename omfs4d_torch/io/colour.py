"""Colour management of tagged video as cv2 does it: the 8-bit RGB that FFmpeg
8's swscale (the conversion under `cv2.VideoCapture`, which the JAX package
reads video through) makes of a stream whose colour tags it manages: HLG
and PQ, BT.2020, DCI-P3, Display P3, film, XYZ and EBU 3213 primaries, as an
iPhone's "HDR Video" (BT.2020 / HLG) or an HDR10 file (BT.2020 / PQ) carries
them.

Which streams (`managed`): swscale converts a picture to the output's
colour space, and cv2 asks for BGR with no colour tags, which swscale fills
from the input's: primaries 1 (BT.709), 4-7 (BT.470 M and B/G, SMPTE 170M
and 240M) and an SDR transfer are kept, so nothing is mapped; any other
primaries (8 film, 9 BT.2020, 10 XYZ, 11 DCI-P3, 12 Display P3, 22 EBU 3213)
become BT.709's, and PQ (16) or HLG (18) becomes BT.709's transfer with
203 cd/m^2 as white.  Reserved values are unspecified ones, as FFmpeg's
decoders make them.  The logarithmic transfers (9, 10) have no EOTF, and
swscale refuses them: so does `check`.

How (`to_rgb`), in swscale's three passes:

1. Y'CbCr to 16-bit R'G'B' (its legacy scaler, in float here within a 16-bit
   step): the matrix's `swscale.coefficients` and the range, the 8-bit scale
   times 256.  Chroma reaches the luma grid as the pass's stale chroma siting
   brings it: each chroma column shown for two pixels, rows 2k at chroma row
   k and 2k + 1 halfway to k + 1 (swscale's bicubic, B = 0, C = 0.6).
2. A 65^3 table on the source R'G'B' (`table`, built by the host C++ of
   `colourlut.cpp` as swscale builds it: relative colorimetric, the
   source's EOTF, IPT (a white other than D65 taken there by CAT16), a clip
   into BT.709's gamut along swscale's curve, the output's inverse EOTF),
   read by tetrahedral interpolation.
3. R'G'B' back to 8 bits through swscale's integer path from 16-bit RGB:
   Y'CbCr with BT.601's table (limited range), chroma taken half a row up
   (bicubic), then R'G'B' with the stream's matrix in limited range, each
   step in swscale's fixed point.

A mastering display's luminance (SEI 137, or the MP4 `mdcv` box) sets the
source's white and black (`Mastering`, `luminance`), as swscale reads it:
with an SDR transfer the output's too, and the table then moves the
source's black to the output's in PQ, keeping its white (swscale's black
point compensation).  Its primaries, content light levels (SEI 144,
`clli`) and the ambient viewing environment (SEI 148) change nothing
there.

The table is built once a process for each set of tags, on every core; the
passes run in numpy (times: PERF.md).  Untagged and unmanaged streams never
come here: `h264.ycbcr_to_rgb` sends them to `swscale.to_rgb`, swscale's own
conversion bit for bit, whose fixed-point coefficients pass 3 shares.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from omfs4d_torch.io import container, swscale

# libavutil's primaries (av_csp_primaries_desc): rx ry gx gy bx by wx wy
_D65, _C, _DCI, _E = (0.3127, 0.3290), (0.3100, 0.3160), (0.3140, 0.3510), (1 / 3, 1 / 3)
PRIMARIES = {
    1: (0.640, 0.330, 0.300, 0.600, 0.150, 0.060) + _D65,
    4: (0.670, 0.330, 0.210, 0.710, 0.140, 0.080) + _C,
    5: (0.640, 0.330, 0.290, 0.600, 0.150, 0.060) + _D65,
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070) + _D65,
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070) + _D65,
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049) + _C,
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046) + _D65,
    10: (0.735, 0.265, 0.274, 0.718, 0.167, 0.009) + _E,
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060) + _DCI,
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060) + _D65,
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077) + _D65,
}
# primaries whose gamut the output keeps (swscale's "safe" set)
KEPT_PRIMARIES = {1, 4, 5, 6, 7}
HDR_TRANSFERS = {16: "PQ", 18: "HLG"}
TRANSFERS = {1, 4, 5, 6, 7, 8, 11, 12, 13, 14, 15, 16, 17, 18}
REFUSED_TRANSFERS = {9: "logarithmic (100:1)", 10: "logarithmic (316:1)"}
UNSPECIFIED = 2
# the table's nodes a side (swscale's INPUT_LUT_SIZE)
SIZE = 65


@dataclass(frozen=True)
class Mastering:
    """A mastering display's luminance range, cd/m^2 (SEI 137, `mdcv`)."""

    min_luminance: float
    max_luminance: float


def normalise(primaries: int, transfer: int) -> tuple[int, int]:
    """Reserved tags read as unspecified, as FFmpeg's decoders read them."""
    p = primaries if primaries in PRIMARIES else UNSPECIFIED
    t = transfer if transfer in TRANSFERS or transfer in REFUSED_TRANSFERS else UNSPECIFIED
    return p, t


def destination(primaries: int, transfer: int) -> tuple[int, int]:
    """The primaries and transfer swscale gives cv2's untagged BGR output
    for a stream's (normalised) tags."""
    p = primaries if primaries in KEPT_PRIMARIES else 1
    t = 1 if transfer in HDR_TRANSFERS or transfer == UNSPECIFIED else transfer
    return p, t


def managed(primaries: int, transfer: int) -> bool:
    """Whether cv2 maps a stream with these tags (the rule above)."""
    p, t = normalise(primaries, transfer)
    if p == UNSPECIFIED:
        p = 1
    if t == UNSPECIFIED:
        t = 1
    return (p, t) != destination(p, t)


def check(transfer: int) -> None:
    """Raise `container.UnsupportedCodecError` for a transfer swscale
    refuses (cv2 then hands back a buffer it never converted)."""
    if transfer in REFUSED_TRANSFERS:
        raise container.UnsupportedCodecError(
            f"the {REFUSED_TRANSFERS[transfer]} transfer (transfer_characteristics {transfer}) "
            "has no conversion to RGB here, nor in cv2's swscale; converting it needs an "
            "ffmpeg binary (on PATH or from imageio_ffmpeg)")


def from_container(params: dict, colr: tuple | None) -> dict:
    """The range and tags FFmpeg's H.264 and MPEG-4 decoders give a frame:
    the VUI's colour description where it has one, else the container's
    `colr` box's (primaries, transfer, matrix, full range), and the
    VUI's range where it has a video_signal_type, else the box's.  (FFmpeg's
    HEVC decoder takes the VUI's alone.)"""
    tags = {k: params[k] for k in ("full_range", "primaries", "transfer", "matrix")}
    if colr is not None:
        if not params.get("colour_description"):
            tags["primaries"], tags["transfer"], tags["matrix"] = colr[:3]
        if not params.get("signal_type"):
            tags["full_range"] = colr[3]
    return tags


def mastering_from_sei(rbsp: bytes) -> Mastering | None:
    """The mastering display colour volume (payloadType 137) of an SEI RBSP
    (emulation prevention removed, after the NAL header), H.264's or
    HEVC's; None if it has none."""
    pos, n = 0, len(rbsp)
    while pos + 2 <= n and rbsp[pos] != 0x80:
        kind = size = 0
        while pos < n and rbsp[pos] == 0xFF:
            kind, pos = kind + 255, pos + 1
        if pos >= n:
            return None
        kind, pos = kind + rbsp[pos], pos + 1
        while pos < n and rbsp[pos] == 0xFF:
            size, pos = size + 255, pos + 1
        if pos >= n:
            return None
        size, pos = size + rbsp[pos], pos + 1
        if kind == 137 and size >= 24 and pos + 24 <= n:
            most, least = int.from_bytes(rbsp[pos + 16:pos + 20], "big"), \
                int.from_bytes(rbsp[pos + 20:pos + 24], "big")
            return Mastering(least / 10000, most / 10000)
        pos += size
    return None


def mastering_of(sei_rbsps, info: dict) -> Mastering | None:
    """A file's mastering display: the first SEI 137 of these SEI RBSPs (the
    stream's own, which FFmpeg prefers), else the `mdcv` box of the
    container's `info`."""
    found = next((m for m in map(mastering_from_sei, sei_rbsps) if m), None)
    if found is None and "mdcv" in info:
        found = Mastering(*info["mdcv"])
    return found


def stream(tags: dict, bit_depth: int = 8, mastering: Mastering | None = None) -> dict:
    """`h264.ycbcr_to_rgb`'s keywords for a stream of these tags (range,
    primaries, transfer, matrix), called when a file is opened: a transfer
    swscale refuses raises then, before any decode."""
    check(normalise(tags["primaries"], tags["transfer"])[1])
    return dict(tags, bit_depth=bit_depth, mastering=mastering)


def luminance(transfer: int, mastering: Mastering | None) -> tuple[float, ...]:
    """(source white, source black, output white, output black) in cd/m^2:
    PQ's 10000, HLG's 1000 or SDR's 203 over 0 unless a mastering display
    says (PQ's black stays 0); an SDR transfer's output keeps the source's,
    HDR's gets 203 over 0."""
    white = {16: 10000.0, 18: 1000.0}.get(transfer, 203.0)
    black = 0.0
    if mastering is not None and mastering.max_luminance > 0:
        white, black = mastering.max_luminance, mastering.min_luminance
    if transfer == 16:
        black = 0.0
    if transfer in HDR_TRANSFERS:
        return white, black, 203.0, 0.0
    return white, black, white, black


_SOURCE = Path(__file__).resolve().with_name("colourlut.cpp")
_GXX_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-pthread")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use, with g++, into `omfs4d_torch/_build/`) and load
    `colourlut.cpp`; raises RuntimeError with g++'s message when it
    cannot."""
    from omfs4d_torch import native

    lib = ctypes.CDLL(str(native.build(_SOURCE, "colourlut", _GXX_FLAGS,
                                       "omfs4d_torch/io/colourlut.cpp (the colour table)")))
    lib.colour_lut.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.colour_lut.restype = ctypes.c_int
    return lib


@functools.cache
def table(primaries: int, transfer: int, mastering: Mastering | None = None) -> np.ndarray:
    """swscale's (SIZE, SIZE, SIZE, 3) uint16 table for normalised managed
    tags (and a mastering display's luminance), indexed [B][G][R] on the
    source R'G'B'."""
    white, black, out_white, out_black = luminance(transfer, mastering)
    dp, dt = destination(primaries, transfer)
    src = np.array(PRIMARIES[primaries], np.float64)
    dst = np.array(PRIMARIES[dp], np.float64)
    out = np.empty((SIZE, SIZE, SIZE, 3), np.uint16)
    rc = _library().colour_lut(SIZE, transfer, white, black, src.ctypes.data, dt, out_white,
                               out_black, dst.ctypes.data, os.cpu_count() or 1, out.ctypes.data)
    if rc != 0:
        raise container.UnsupportedCodecError(
            f"transfer_characteristics {transfer} has no EOTF in the colour table")
    out.setflags(write=False)
    return out


# ── pass 1: Y'CbCr to 16-bit R'G'B' ────────────────────────────────────

_BICUBIC_HALF = np.array([-0.075, 0.575, 0.575, -0.075])


def _chroma(c: np.ndarray, shape) -> np.ndarray:
    """A 4:2:0 chroma plane on the luma grid as the first pass puts it."""
    c = np.asarray(c, np.float64)
    n = c.shape[0]
    idx = np.clip(np.arange(n)[:, None] + np.arange(-1, 3)[None, :], 0, n - 1)
    half = np.tensordot(c[idx], _BICUBIC_HALF, axes=([1], [0]))
    rows = np.stack([c, half], 1).reshape((2 * n,) + c.shape[1:])
    return np.repeat(rows, 2, 1)[:shape[0], :shape[1]]


def _to_rgb16(y, cb, cr, bit_depth: int, full_range: bool, matrix: int) -> np.ndarray:
    scale = float(1 << (bit_depth - 8))
    yy = np.asarray(y, np.float64) / scale
    u = _chroma(cb, yy.shape) / scale - 128
    v = _chroma(cr, yy.shape) / scale - 128
    crv, cbu, cgu, cgv = (x / 65536 for x in swscale.coefficients(matrix))
    if full_range:
        crv, cbu, cgu, cgv = (x * 224 / 255 for x in (crv, cbu, cgu, cgv))
    else:
        yy = (yy - 16) * ((65536 * 255 // 219) / 65536)
    rgb = np.stack([yy + crv * v, yy - cgu * u - cgv * v, yy + cbu * u], -1)
    return np.clip(np.rint(rgb * 256), 0, 65535).astype(np.uint16)


# ── pass 2: the table, tetrahedral ─────────────────────────────────────

def lookup(lut: np.ndarray, rgb16: np.ndarray) -> np.ndarray:
    """(..., 3) uint16 R'G'B' through a [B][G][R] table, tetrahedral
    interpolation; uint16."""
    n = lut.shape[0]
    flat = lut.reshape(-1, 3).astype(np.float32)
    x = rgb16.reshape(-1, 3).astype(np.float32) * np.float32((n - 1) / 65535.0)
    i = np.minimum(x.astype(np.int32), n - 2)
    f = x - i
    base = (i[:, 2] * n + i[:, 1]) * n + i[:, 0]
    fr, fg, fb = f[:, 0], f[:, 1], f[:, 2]
    # the axes by falling fraction: first (s1) and last (s3) of red, green, blue
    s1 = np.where((fr >= fg) & (fr >= fb), 1, np.where(fg >= fb, n, n * n))
    s3 = np.where((fr < fg) & (fr < fb), 1, np.where((fg < fb) & ~((fr >= fg) & (fr < fb)), n,
                                                      n * n))
    s3 = np.where(s3 == s1, np.where(s1 == n * n, np.where(fr < fg, 1, n), n * n), s3)
    fs = np.sort(f, axis=1)
    c0 = flat[base]
    c1 = flat[base + s1]
    c2 = flat[base + (1 + n + n * n) - s3]
    c3 = flat[base + (1 + n + n * n)]
    out = c0 + fs[:, 2:] * (c1 - c0) + fs[:, 1:2] * (c2 - c1) + fs[:, :1] * (c3 - c2)
    return np.clip(np.rint(out), 0, 65535).astype(np.uint16).reshape(rgb16.shape)


# ── pass 3: 16-bit R'G'B' to 8 bits, swscale's fixed point ─────────────

@functools.cache
def _rgb2yuv(coeffs=swscale.BT601) -> tuple[int, ...]:
    """swscale's fill_rgb2yuv_table (always limited range), RGB2YUV_SHIFT 15:
    ry gy by ru gu bu rv gv bv."""
    vr, ub, ug, vg = coeffs[0], coeffs[1], -coeffs[2], -coeffs[3]
    one, d = 65536, swscale.rounded_div
    cy = one * 255 // 219
    w = d(one * one * ug, ub)
    v = d(one * one * vg, vr)
    z = one * one - w - v
    ky, ku, kv = d(cy * z, one), d(ub * z, one), d(vr * z, one)
    s = 1 << 15
    return (-d(s * v, ky), d(s * one * one, ky), -d(s * w, ky),
            d(s * v, ku), -d(s * one * one, ku), d(s * (z + w), ku),
            d(s * (v + z), kv), -d(s * one * one, kv), d(s * w, kv))


def _to_rgb8(rgb16: np.ndarray, matrix: int) -> np.ndarray:
    ry, gy, by, ru, gu, bu, rv, gv, bv = _rgb2yuv()
    r, g, b = (rgb16[..., k].astype(np.int64) for k in range(3))
    y = (ry * r + gy * g + by * b + (0x2001 << 14)) >> 15
    u = (ru * r + gu * g + bu * b + (0x10001 << 14)) >> 15
    v = (rv * r + gv * g + bv * b + (0x10001 << 14)) >> 15
    y, u, v = (np.minimum((p * 16384) >> 15, 32767) for p in (y, u, v))
    n = u.shape[0]                              # chroma half a row up: rows j-2 .. j+1
    idx = np.clip(np.arange(n)[:, None] + np.arange(-2, 2)[None, :], 0, n - 1)
    taps = np.array([-307, 2355, 2355, -307], np.int64)
    u = (np.tensordot(u[idx], taps, axes=([1], [0])) + 512 - (128 << 19)) >> 10
    v = (np.tensordot(v[idx], taps, axes=([1], [0])) + 512 - (128 << 19)) >> 10
    return swscale.write_full(y * 4, u, v, matrix, False)


def to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, *, bit_depth: int = 8,
           full_range: bool = False, matrix: int = 2, primaries: int = 2, transfer: int = 2,
           mastering: Mastering | None = None) -> np.ndarray:
    """Y' (H, W) and 4:2:0 Cb, Cr of a managed stream (`managed`) -> (H, W,
    3) uint8 R'G'B', as cv2 converts them."""
    p, t = normalise(primaries, transfer)
    p = 1 if p == UNSPECIFIED else p
    t = 1 if t == UNSPECIFIED else t
    rgb16 = lookup(table(p, t, mastering), _to_rgb16(y, cb, cr, bit_depth, full_range, matrix))
    return _to_rgb8(rgb16, matrix)
