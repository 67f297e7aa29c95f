"""Y'CbCr to 8-bit R'G'B' as `cv2.VideoCapture` converts it: FFmpeg's swscale
asked for BGR24 with `SWS_BICUBIC` (no `SWS_ACCURATE_RND`, no
`SWS_FULL_CHR_H_INT`), in swscale's own integer arithmetic as an x86 build
(cv2's wheels) runs it, bit for bit.  The JAX package reads every video
through cv2 (`omfs4d.io.video`), so these are the frames it tracks and
trains on.

swscale takes one of two paths (`to_rgb` picks as it does):

- A, its unscaled converter (`ff_yuv2rgb_get_func_ptr`; `unscaled`): 8-bit
  4:2:0 and 4:2:2 (yuvj* as the same in full range) at an even height.  Each
  chroma sample is used whole for its 2 x 2 (2 x 1) block, and the x86 SIMD
  kernel's fixed point (`yuv_2_rgb.asm`, `pmulhw`) gives
  R = Y + (V * vr >> 16), G = Y + (U * ug >> 16) + (V * vg >> 16),
  B = Y + (U * ub >> 16), with Y = ((Y' << 3) - yO) * yC >> 16,
  U = (Cb << 3) - 1024, V = (Cr << 3) - 1024 (`simd_coefficients`).
- B, its scaled path (`scaled`) for the rest: 9- and 10-bit samples, an odd
  height, and JPEG's other samplings (4:4:4, 4:4:0, 4:1:1).  Chroma is
  resampled to the output's grid by bicubic filters (B = 0, C = 0.6) that
  `init_filter` builds as `initFilter` does (the int64 kernel, trimmed,
  edges folded in, normalised with error diffusion), from the stream's
  chroma siting to swscale's: a horizontal scaler into 15-bit
  intermediates, then a vertical one.  The packed writer then works on
  chroma at half the width (`_packed`): the MMX code for every row but the
  last two (`pmulhw` sums with a rounder of 4, then path A's arithmetic),
  `output.c`'s C tables (`c_tables`) for those two.  An odd width, or
  chroma at full resolution (4:4:4), makes swscale interpolate chroma at
  every pixel (`_full_chroma`, `output.c`'s 30-bit writer).

The coefficients are `ff_yuv2rgb_coeffs` by matrix_coefficients as FFmpeg's
colour-space handling reads them (`coefficients`), turned into each path's
fixed point as `ff_yuv2rgb_c_init_tables` does.  The colour-managed
conversion (`colour`) shares them.  An ARM host's cv2 runs other kernels
(NEON) and was not measured.
"""

from __future__ import annotations

import functools

import numpy as np

from omfs4d_torch.io import container

# ff_yuv2rgb_coeffs by matrix_coefficients (crv, cbu, cgu, cgv, x 65536, for
# limited range): BT.709, FCC, SMPTE 240M, BT.2020; BT.601 for the rest
SWS_COEFFS = {1: (117489, 138438, 13975, 34925), 4: (104448, 132798, 24759, 53109),
              7: (117579, 136230, 16907, 35559), 9: (110013, 140363, 12277, 42626),
              10: (110013, 140363, 12277, 42626)}
BT601 = (104597, 132201, 25675, 53279)
# matrix_coefficients swscale refuses ("Unsupported input"; cv2 then hands
# back a buffer it never converted); 18 and above read as unspecified
REFUSED_MATRICES = {8: "YCgCo", 10: "BT.2020 constant luminance", 11: "SMPTE ST 2085",
                    12: "chromaticity-derived non-constant luminance",
                    13: "chromaticity-derived constant luminance", 14: "ICtCp", 15: "IPT-C2",
                    16: "YCgCo-Re", 17: "YCgCo-Ro"}
# AVChromaLocation: 0 unspecified (read as 2, centre), 1 left, 2 centre,
# 3 top left, 4 top, 5 bottom left, 6 bottom
LEFT, CENTER = 1, 2


def check(matrix: int) -> None:
    """Raise `container.UnsupportedCodecError` for a matrix swscale refuses."""
    if matrix in REFUSED_MATRICES:
        raise container.UnsupportedCodecError(
            f"{REFUSED_MATRICES[matrix]} (matrix_coefficients {matrix}) has no conversion to "
            "RGB here, nor in cv2's swscale; converting it needs an ffmpeg binary (on PATH or "
            "from imageio_ffmpeg)")


def coefficients(matrix: int) -> tuple[int, int, int, int]:
    """(crv, cbu, cgu, cgv) for a matrix_coefficients value."""
    return SWS_COEFFS.get(matrix, BT601)


def round16(f: int) -> int:
    """swscale's roundToInt16: f / 65536 rounded, clipped to int16."""
    r = (f + (1 << 15)) >> 16
    return max(-0x8000, min(0x7FFF, r))


def _cdiv(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def rounded_div(a: int, b: int) -> int:
    """libavutil's ROUNDED_DIV for b > 0: a / b rounded, halves away from 0."""
    return (a + (b >> 1)) // b if a >= 0 else -((-a + (b >> 1)) // b)


@functools.cache
def _scaled(matrix: int, full: bool) -> tuple[int, ...]:
    """ff_yuv2rgb_c_init_tables' cy, oy, crv, cbu, cgu, cgv after the range
    (contrast and saturation 1, brightness 0); cgu and cgv negated."""
    crv, cbu, cgu, cgv = coefficients(matrix)
    cgu, cgv = -cgu, -cgv
    if full:
        cy, oy = 1 << 16, 0
        crv, cbu, cgu, cgv = (_cdiv(x * 224, 255) for x in (crv, cbu, cgu, cgv))
    else:
        cy, oy = (1 << 16) * 255 // 219, 16 << 16
    return cy, oy, crv, cbu, cgu, cgv


@functools.cache
def simd_coefficients(matrix: int, full: bool) -> tuple[int, ...]:
    """The x86 kernels' int16 yCoeff, yOffset, vrCoeff, ubCoeff, vgCoeff,
    ugCoeff (`pmulhw` operands on samples scaled by 8)."""
    cy, oy, crv, cbu, cgu, cgv = _scaled(matrix, full)
    return (round16(cy << 13), round16(oy << 3), round16(crv << 13), round16(cbu << 13),
            round16(cgv << 13), round16(cgu << 13))


@functools.cache
def full_coefficients(matrix: int, full: bool) -> tuple[int, ...]:
    """`output.c`'s yuv2rgb_y_coeff, y_offset, v2r, v2g, u2g, u2b (the
    30-bit writer of full chroma interpolation)."""
    cy, oy, crv, cbu, cgu, cgv = _scaled(matrix, full)
    return (round16(cy << 13), round16(oy << 9), round16(crv << 13), round16(cgv << 13),
            round16(cgu << 13), round16(cbu << 13))


_HEADROOM = 512                    # YUVRGB_TABLE_HEADROOM and _LUMA_HEADROOM


@functools.cache
def c_tables(matrix: int, full: bool) -> tuple[np.ndarray, ...]:
    """`yuv2rgb.c`'s 24-bit tables: the luma table, and for each chroma
    value 0-255 its index offset into it for red (V), green (U, V) and blue
    (U)."""
    cy, oy, crv, cbu, cgu, cgv = _scaled(matrix, full)
    crv, cbu, cgu, cgv = (_cdiv(x * (1 << 16) + 0x8000, cy) for x in (crv, cbu, cgu, cgv))
    yoffs = (384 if full else 326) + _HEADROOM
    yb = -(384 << 16) - _HEADROOM * cy - oy
    ytab = np.clip((yb + np.arange(1024 + 2 * _HEADROOM, dtype=np.int64) * cy + 0x8000) >> 16,
                   0, 255).astype(np.uint8)
    i = np.arange(256, dtype=np.int64)
    tables = [ytab] + [(yoffs - (inc >> 9) + ((i * inc) >> 16)).astype(np.int32)
                       for inc in (crv, cgu, cbu)] + [(-(cgv >> 9) + ((i * cgv) >> 16))
                                                      .astype(np.int32)]
    for t in tables:
        t.setflags(write=False)
    return tuple(tables)


def _pmulhw(a, b):
    return (a * b) >> 16


def _wrap16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _simd_rgb(y8: np.ndarray, u8: np.ndarray, v8: np.ndarray, matrix: int, full: bool,
              width: int) -> np.ndarray:
    """The x86 kernels' last stage: Y', Cb, Cr scaled by 8 (int32; chroma at
    half the width) -> (..., width, 3) uint8."""
    yc, yo, vr, ub, vg, ug = simd_coefficients(matrix, full)
    u, v = u8 - 1024, v8 - 1024
    yy = _pmulhw(y8 - yo, yc)
    chroma = np.stack([_pmulhw(v, vr), _wrap16(_pmulhw(u, ug) + _pmulhw(v, vg)),
                       _pmulhw(u, ub)], -1)
    chroma = np.repeat(chroma, 2, axis=-2)[..., :width, :]
    return np.clip(yy[..., None] + chroma, 0, 255).astype(np.uint8)


def unscaled(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, matrix: int = 2,
             full: bool = False) -> np.ndarray:
    """Path A: 8-bit Y' (H, W), 4:2:0 or 4:2:2 Cb, Cr -> (H, W, 3) uint8 R'G'B'."""
    h, w = y.shape
    rows = -(-h // cb.shape[0])
    y8 = np.asarray(y, np.int32) << 3
    u8, v8 = (np.repeat(np.asarray(c, np.int32) << 3, rows, 0)[:h] for c in (cb, cr))
    return _simd_rgb(y8, u8, v8, matrix, full, w)


# ── path B: the scaled path ─────────────────────────────────────────────

def _local_pos(sub: int, pos: int) -> int:
    """get_local_pos: a chroma position (1/256 of a luma sample, -513 for
    swscale's default) relative to the plane's ideal left edge."""
    if pos == -1 or pos <= -513:
        pos = (128 << sub) - 128
    return (pos + 128) >> sub


def chroma_pos(location: int, sub_x: int, sub_y: int) -> tuple[int, int]:
    """(h_chr_pos, v_chr_pos) of a stream's AVChromaLocation as swscale's
    graph sets them (unspecified read as centre; -513 where not
    subsampled)."""
    loc = (location if 0 < location <= 6 else CENTER) - 1
    x, y = (loc & 1) * 128, ((loc >> 1) ^ (loc < 4)) * 128
    return (x * ((1 << sub_x) - 1) if sub_x else -513,
            y * ((1 << sub_y) - 1) if sub_y else -513)


@functools.lru_cache(maxsize=64)
def init_filter(inc: int, src_w: int, dst_w: int, align: int, one: int, src_pos: int,
                dst_pos: int) -> tuple[np.ndarray, np.ndarray]:
    """swscale's initFilter for SWS_BICUBIC (B = 0, C = 0.6): (dst_w, size)
    int32 coefficients summing to `one` and (dst_w,) first source index."""
    fone = 1 << (54 - min(max((src_w // dst_w).bit_length() - 1, 0), 8))
    if abs(inc - 0x10000) < 10 and src_pos == dst_pos:
        size, rows, pos = 1, [[fone] for _ in range(dst_w)], list(range(dst_w))
    else:
        size = 5 if inc <= 1 << 16 else 1 + (4 * src_w + dst_w - 1) // dst_w
        size = max(min(size, src_w - 2), 1)
        big_c = int(0.6 * (1 << 24))
        x = ((dst_pos * inc) >> 7) - ((src_pos * 0x10000) >> 7)
        rows, pos = [], []
        for _ in range(dst_w):
            xx = _cdiv(x - (size - 2) * (1 << 16), 1 << 17)
            pos.append(xx)
            row = []
            for j in range(size):
                d = abs((xx + j) * (1 << 17) - x) << 13
                if inc > 1 << 16:
                    d = d * dst_w // src_w
                coeff = 0
                if d < 1 << 31:
                    dd = (d * d) >> 30
                    ddd = (dd * d) >> 30
                    if d < 1 << 30:
                        coeff = ((12 * (1 << 24) - 6 * big_c) * ddd
                                 + (-18 * (1 << 24) + 6 * big_c) * dd + 6 * (1 << 24) * (1 << 30))
                    else:
                        coeff = (-6 * big_c * ddd + 30 * big_c * dd - 48 * big_c * d
                                 + 24 * big_c * (1 << 30))
                row.append(_cdiv(coeff, (1 << 54) // fone))
            rows.append(row)
            x += 2 * inc
    # drop near-zero taps: shift each filter left over its leading ones, then
    # keep the widest count that leaves no weight on the right
    cut, widest = 0.002 * fone, 0
    for i in range(dst_w - 1, -1, -1):
        row, total = rows[i], 0
        for _ in range(size):
            total += abs(row[0])
            if total > cut or (i < dst_w - 1 and pos[i] >= pos[i + 1]):
                break
            row[:] = row[1:] + [0]
            pos[i] += 1
        keep, total = size, 0
        for j in range(size - 1, 0, -1):
            total += abs(row[j])
            if total > cut:
                break
            keep -= 1
        widest = max(widest, keep)
    if widest == 1 and align == 2:
        align = 1
    width = (widest + align - 1) & ~(align - 1)
    rows = [[row[j] if j < size else 0 for j in range(width)] for row in rows]
    for i, row in enumerate(rows):                      # fold taps outside the plane in
        if pos[i] < 0:
            for j in range(1, width):
                left = max(j + pos[i], 0)
                row[left] += row[j]
                row[j] = 0
            pos[i] = 0
        if pos[i] + width > src_w:
            shift = pos[i] + min(width - src_w, 0)
            acc = sum(row[j] for j in range(width) if pos[i] + j >= src_w)
            row[:] = [0 if j < shift or pos[i] + j - shift >= src_w else row[j - shift]
                      for j in range(width)]
            pos[i] -= shift
            row[src_w - 1 - pos[i]] += acc
    out = np.zeros((dst_w, width), np.int32)
    for i, row in enumerate(rows):
        total = (sum(row) + one // 2) // one or 1
        error = 0
        for j, c in enumerate(row):
            v = c + error
            q = rounded_div(v, total)
            out[i, j], error = q, v - q * total
    starts = np.array(pos, np.int32)
    out.setflags(write=False)
    starts.setflags(write=False)
    return out, starts


def _taps(filt: np.ndarray, start: np.ndarray, n: int) -> np.ndarray:
    """The source index of each tap, (dst, size), clamped into the plane
    (a tap past the edge has a zero coefficient)."""
    return np.minimum(start[:, None] + np.arange(filt.shape[1])[None, :], n - 1)


def _is_identity(filt: np.ndarray, start: np.ndarray, one: int) -> bool:
    """Whether a filter takes each output from its own input sample alone."""
    rows, taps = np.nonzero(filt)
    return (len(rows) == len(start) and bool((filt[rows, taps] == one).all())
            and np.array_equal(start[rows] + taps, rows))


def _hscale(plane: np.ndarray, filt: np.ndarray, start: np.ndarray, depth: int) -> np.ndarray:
    """hScale8To15 / hScale16To15: rows resampled into 15-bit intermediates."""
    src = np.asarray(plane, np.int32)
    if _is_identity(filt, start, 1 << 14):
        val = src[:, :len(start)] << 14
    else:
        idx = _taps(filt, start, src.shape[1])
        val = sum(src[:, idx[:, j]] * filt[:, j] for j in range(filt.shape[1]))
    return np.minimum(val >> (7 if depth == 8 else depth - 1), (1 << 15) - 1)


def _packed(y15, u15, v15, vf, vstart, matrix: int, full: bool) -> np.ndarray:
    """The packed BGR24 writer on chroma at half the width: x86's MMX code
    for every row but the last two, `output.c`'s tables for those.  There, a
    row whose chroma filter is one tap, or two summing to 4096, is written
    by yuv2packed1 (the first row alone, or the two averaged from a weight
    of 2048), any other by yuv2packedX."""
    h, w = y15.shape
    idx = _taps(vf, vstart, u15.shape[0])
    taps = vf.shape[1]
    if taps == 1:
        mode = np.zeros(h, np.int8)                      # 0: first row, 1: mean, 2: X
    elif taps == 2:
        one = (vf.sum(1) == 4096) & (vf[:, 1] >= 0) & (vf[:, 1] <= 4096)
        mode = np.where(one, (vf[:, 1] >= 2048).astype(np.int8), 2).astype(np.int8)
    else:
        mode = np.full(h, 2, np.int8)
    out = np.empty((h, w, 3), np.uint8)
    mmx = max(h - 2, 0)
    if mmx:
        m = mode[:mmx, None]
        first = [c[idx[:mmx, 0]] for c in (u15, v15)]
        second = [c[idx[:mmx, min(1, taps - 1)]] for c in (u15, v15)]
        filtered = [_wrap16(4 + sum(_pmulhw(c[idx[:mmx, j]], vf[:mmx, j, None])
                                    for j in range(taps))) for c in (u15, v15)]
        uacc, vacc = (np.where(m == 0, a >> 4, np.where(m == 1, ((a + b) & 0xFFFF) >> 5, x))
                      for a, b, x in zip(first, second, filtered))
        yacc = np.where(m == 2, _wrap16(4 + _pmulhw(y15[:mmx], 4096)), y15[:mmx] >> 4)
        out[:mmx] = _simd_rgb(yacc, uacc, vacc, matrix, full, w)
    ytab, rv, gu, bu, gv = c_tables(matrix, full)
    for row in range(mmx, h):            # C: every filter as it is, rounded at 2^19
        yy = (y15[row] * 4096 + (1 << 18)) >> 19
        u, v = (((1 << 18) + sum(c[idx[row, j]] * vf[row, j] for j in range(taps))) >> 19
                for c in (u15, v15))
        u, v = (np.repeat(np.clip(c, 0, 255), 2)[:w] for c in (u, v))
        out[row] = np.stack([ytab[yy + rv[v]], ytab[yy + gu[u] + gv[v]], ytab[yy + bu[u]]], -1)
    return out


def write_full(y: np.ndarray, u: np.ndarray, v: np.ndarray, matrix: int,
               full: bool) -> np.ndarray:
    """`output.c`'s yuv2rgb_write_full: Y' and Cb, Cr - 128 at the vertical
    filter's scale (the 8-bit value times 512) -> (..., 3) uint8 R'G'B',
    30-bit sums, kept in a 32-bit int as swscale keeps them (a sum past 2^31,
    a saturated Y' and chroma in full range, wraps negative and clips to 0)."""
    yc, yo, v2r, v2g, u2g, u2b = (np.int64(c) for c in full_coefficients(matrix, full))
    y = (np.asarray(y, np.int64) - yo) * yc + (1 << 21)
    u, v = np.asarray(u, np.int64), np.asarray(v, np.int64)
    rgb = np.stack([y + v * v2r, y + v * v2g + u * u2g, y + u * u2b], -1)
    rgb = ((rgb + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return (np.clip(rgb, 0, (1 << 30) - 1) >> 22).astype(np.uint8)


def _full_chroma(y15, u15, v15, vf, vstart, matrix: int, full: bool) -> np.ndarray:
    """`output.c`'s yuv2rgb_full_X, chroma at every pixel: its sums rounded
    at 2^9; but a row whose chroma filter is two taps summing to 4096 (the
    second in 0..4096) goes to yuv2rgb_full_1 (`packed_vscale`), whose
    blend of the two rows is not rounded."""
    idx = _taps(vf, vstart, u15.shape[0])
    yy = ((1 << 9) + y15.astype(np.int64) * 4096) >> 10
    rounder = np.full((vf.shape[0], 1), 1 << 9, np.int64)
    if vf.shape[1] == 2:
        one = (vf.sum(1) == 4096) & (vf[:, 1] >= 0) & (vf[:, 1] <= 4096)
        rounder[one] = 0
    u, v = (((rounder - (128 << 19) + sum(c[idx[:, j]].astype(np.int64) * vf[:, j, None]
                                          for j in range(vf.shape[1]))) >> 10)
            for c in (u15, v15))
    return write_full(yy, u, v, matrix, full)


def scaled(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, depth: int = 8, matrix: int = 2,
           full: bool = False, location: int = LEFT) -> np.ndarray:
    """Path B: Y' (H, W) and Cb, Cr at any of JPEG's or video's samplings,
    8 to 10 bits -> (H, W, 3) uint8 R'G'B', chroma sited at `location`
    (AVChromaLocation)."""
    h, w = y.shape
    ch, cw = cb.shape
    sub_x, sub_y = (-(-w // cw)).bit_length() - 1, (-(-h // ch)).bit_length() - 1
    # odd widths and unsubsampled chroma: chroma interpolated at every pixel
    full_chroma = bool(w & 1) or (sub_x == 0 and sub_y == 0)
    dst_sub_x = 0 if full_chroma else 1
    dw = -(-w // (1 << dst_sub_x))
    src_h_pos, src_v_pos = chroma_pos(location, sub_x, sub_y)
    lum, lum_start = init_filter(1 << 16, w, w, 4, 1 << 14, 128, 128)
    y15 = _hscale(y, lum, lum_start, depth)
    hf, hs = init_filter(((cw << 16) + (dw >> 1)) // dw, cw, dw, 4, 1 << 14,
                         _local_pos(sub_x, src_h_pos), _local_pos(dst_sub_x, -513))
    u15, v15 = (_hscale(c, hf, hs, depth) for c in (cb, cr))
    vf, vs = init_filter(((ch << 16) + (h >> 1)) // h, ch, h, 2, 1 << 12,
                         _local_pos(sub_y, src_v_pos), _local_pos(0, -513))
    write = _full_chroma if full_chroma else _packed
    return write(y15, u15, v15, vf, vs, matrix, full)


def takes_unscaled(shape, chroma_shape, depth: int) -> bool:
    """Whether swscale converts these planes on path A."""
    h, w = shape
    ch, cw = chroma_shape
    return (depth == 8 and not h & 1 and cw == -(-w // 2)
            and ch in (h, -(-h // 2)))


def to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, depth: int = 8, matrix: int = 2,
           full: bool = False, location: int = LEFT) -> np.ndarray:
    """Y' (H, W) and Cb, Cr (any sampling; uint8, or the samples of a 9- or
    10-bit stream) -> (H, W, 3) uint8 R'G'B' as cv2 converts them, on the
    path swscale takes for them; a matrix it refuses raises."""
    check(matrix)
    if takes_unscaled(y.shape, cb.shape, depth):
        return unscaled(y, cb, cr, matrix, full)
    return scaled(y, cb, cr, depth, matrix, full, location)
