"""H.264 (ITU-T H.264 | ISO/IEC 14496-10) in MP4, written and read on the host
with the standard library and NumPy: the first rung of the reference's video
ladder (`omfs4d.io.video.stitch_video`: libx264 through ffmpeg, else cv2's
`avc1`), for a machine with neither.

The encoder (`encode_h264`, `H264Encoder`) writes a Constrained Baseline
stream (profile_idc 66, constraint_set0 and constraint_set1 set) at the
lowest level of Table A-1 that holds the frame size and macroblock rate:

- 4:2:0, 8-bit, frames only, `pic_order_cnt_type` 2 (output order is decode
  order), one reference frame; a size that is not a multiple of 16 is
  padded by repeating its last row and column and cropped in the SPS; the
  VUI says BT.601 limited range (`video_full_range_flag` 0, colour
  primaries, transfer and matrix 6), chroma sited at the centre of its
  2 x 2 luma samples (`chroma_sample_loc_type` 1, as the mean places it)
  and gives the frame rate.
- Colour: R'G'B' to Y'CbCr by BT.601 in limited range (the matrix swscale
  applies for `-pix_fmt yuv420p`), in 16-bit fixed point whose chroma rows
  sum to 0, so grey gives Cb = Cr = 128 exactly; chroma is the rounded mean
  of each 2 x 2.
- An IDR every `H264_KEYINT` frames from frame 0 (x264's default keyint),
  P pictures between, each predicting from the one before.
- IDR pictures: every macroblock `Intra_16x16`, one slice per macroblock
  row, so that a macroblock's only neighbour is the one to its left (its
  upper neighbour lies in another slice): the rows are coded together, one
  step per macroblock column.  Luma is predicted Horizontal or DC, chroma DC
  or Horizontal, whichever leaves the smaller sum of absolute differences.
- P pictures: one slice, all macroblocks at once: a whole-sample motion
  vector for each (a search over +-18 samples: a full one at a quarter of
  the size, refined at full size), the predictor of 8.4.1.3, then
  `P_Skip` where the residual quantizes to nothing and the vector is the
  skip prediction of 8.4.1.1, else `P_L0_16x16`.
- The residual: the 4 x 4 core transform, the luma DC of `Intra_16x16`
  through the 4 x 4 Hadamard and chroma DC through the 2 x 2, quantized at
  one QP a picture (`mb_qp_delta` 0), CAVLC.  The QP is `qp` (`H264_QP`, the
  reference's CRF 18, by default) and is raised for a picture only where a
  level would need a `level_prefix` over 15, which Baseline forbids.
- The reconstruction, which P pictures predict from, is the standard's
  decoding process (8.5.6-8.5.12: LevelScale4x4 from flat weights, the DC
  transforms with their rounding below QP 36, `(x + 32) >> 6`, QPc from
  Table 8-15), not an inverse of the encoder's quantizer.  Every slice sets
  `disable_deblocking_filter_idc` 1, so a picture is prediction + residual:
  the in-loop filter of 8.7 is not applied.
- Bits: each syntax element a (code, length) pair keyed by its place in the
  stream, one sort, bit offsets by a cumulative sum, bytes by `bincount`
  (the packing of `encode_jpeg`); Annex B emulation prevention; `frame_num`
  modulo MaxFrameNum (16); `idr_pic_id` alternating.

The reader (`frames`, `H264Frames`, `decode_annexb`) is the host C++ decoder
`h264dec.cpp` (`Decoder`), built by g++ at first use into `omfs4d_torch/_build/`
(no Python fallback: without g++ reading raises with the reason) and bound with
ctypes.  It decodes Baseline, Main and High profile I, P and B pictures at 8-bit
4:2:0, frames only, as phone cameras and x264 write them: CAVLC and CABAC,
I_NxN (4x4 and 8x8), Intra_16x16, I_PCM, every P and B partition, P_Skip,
B_Skip and the direct modes (spatial and temporal), quarter-sample motion,
bi-prediction, explicit and implicit weighted prediction, up to 16 reference
frames with adaptive marking, long-term references and list modification,
reference B pictures (B-pyramid), scaling matrices, several slices, the
deblocking filter, output in POC order.  `H264Frames` shows a file's frames as
cv2 does: in presentation order (`ctts`), those its edit list keeps, turned by
the track's display matrix, converted with the VUI's range, matrix,
primaries and transfer, or a `colr` box's where the VUI has no colour
description, as FFmpeg takes them (`ycbcr_to_rgb`: swscale's unscaled
conversion, bit for bit, `swscale`; tags cv2 colour-manages go to `colour`,
with the mastering display's luminance of an SEI 137 in the first sample,
else of the `mdcv` box).  Anything else (fields, MBAFF, High 10 / 4:2:2 / 4:4:4,
FMO, SP/SI slices, ...) raises `container.UnsupportedCodecError` naming it and
ffmpeg; a corrupt unit raises ValueError.  The Python `H264Decoder` reads the encoder's own subset only
(Intra_16x16 H / DC, P_L0_16x16 / P_Skip with whole-sample vectors, one
reference, no deblocking) and refuses the rest by name: it is the plain version
the tests hold the host decoder to.  The tables are `h264_tables`'.
"""

from __future__ import annotations

import ctypes
import functools
import re
import struct
from collections.abc import Iterable, Sequence
from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path

import numpy as np

from omfs4d_torch.io import colour, container, h264_tables, mp4, swscale
from omfs4d_torch.io import frames as frames_base

# the QP of every picture, the reference's CRF; raised for a picture only
# where Baseline's CAVLC cannot code a level (see `_MAX_LEVEL`)
H264_QP = 18
# an IDR picture every this many frames: x264's default keyint
H264_KEYINT = 250

_LOG2_MAX_FRAME_NUM = 4
# the largest |level| CAVLC codes with level_prefix <= 15 at every suffixLength
_MAX_LEVEL = 2063

# Table A-1: level_idc, MaxMBPS (macroblocks a second), MaxFS (macroblocks a frame)
_LEVELS = ((10, 1485, 99), (11, 3000, 396), (12, 6000, 396), (13, 11880, 396),
           (20, 11880, 396), (21, 19800, 792), (22, 20250, 1620), (30, 40500, 1620),
           (31, 108000, 3600), (32, 216000, 5120), (40, 245760, 8192), (41, 245760, 8192),
           (42, 522240, 8704), (50, 589824, 22080), (51, 983040, 36864),
           (52, 2073600, 36864))


def level_for(width: int, height: int, fps: float) -> int | None:
    """level_idc of the lowest level of Table A-1 whose frame size, frame
    sides (sqrt(8 MaxFS) macroblocks) and macroblock rate hold the video;
    None beyond level 5.2."""
    w, h = -(-width // 16), -(-height // 16)
    for level, max_mbps, max_fs in _LEVELS:
        side = (8 * max_fs) ** 0.5
        if w * h <= max_fs and w <= side and h <= side and w * h * fps <= max_mbps:
            return level
    return None


def unsupported_size(width: int, height: int, fps: float) -> str | None:
    """Why this encoder cannot hold width x height frames at fps (an odd side,
    which 4:2:0 cropping cannot express; beyond level 5.2), or None."""
    if width % 2 or height % 2:
        return f"a side of {width} x {height} is odd (4:2:0 crops in steps of 2)"
    if level_for(width, height, fps) is None:
        return f"{width} x {height} at {fps:g} fps is beyond level 5.2"
    return None


# ── tables of the standard ──────────────────────────────────────────────

# 4 x 4 zig-zag scan (8.5.6), as raster indices y * 4 + x
_ZIGZAG = h264_tables.ZIGZAG4
# luma4x4BlkIdx -> raster index of the 4 x 4 block in its macroblock (6.4.3)
_BLK = np.array([0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15])
# quantizer multipliers and normAdjust4x4 by QP % 6, for positions (even,
# even), (odd, odd) and the rest (8.5.9)
_MF = np.array([[13107, 5243, 8066], [11916, 4660, 7490], [10082, 4194, 6554],
                [9362, 3647, 5825], [8192, 3355, 5243], [7282, 2893, 4559]], np.int64)
_NORM = h264_tables.NORM4
_POS = np.array([[0, 2, 0, 2], [2, 1, 2, 1], [0, 2, 0, 2], [2, 1, 2, 1]])
_QPC, _INTER_CBP = h264_tables.QPC, h264_tables.INTER_CBP
_INTER_CODE = np.argsort(_INTER_CBP)
# CAVLC's tables (9.2): coeff_token by [table][TotalCoeff][TrailingOnes] (tables
# 0-3 for 0 <= nC < 2, 2 <= nC < 4, 4 <= nC < 8, 8 <= nC; 4 for nC = -1),
# total_zeros of 4 x 4 and chroma DC blocks, run_before
_CT_LEN, _CT_CODE = h264_tables.CT_LEN, h264_tables.CT_CODE
_TZ_LEN, _TZ_CODE = h264_tables.TZ_LEN, h264_tables.TZ_CODE
_TZC_LEN, _TZC_CODE = h264_tables.TZC_LEN, h264_tables.TZC_CODE
_RB_LEN, _RB_CODE = h264_tables.RB_LEN, h264_tables.RB_CODE


# ── colour ──────────────────────────────────────────────────────────────

# BT.601 in limited range, x 65536 (each chroma row sums to 0)
_RGB_TO_YCC = np.array([[16829, 33039, 6416], [-9714, -19070, 28784],
                        [28784, -24103, -4681]], np.int64)


def rgb_to_ycbcr(rgb: np.ndarray):
    """(H, W, 3) uint8 R'G'B' (H, W even) -> Y' (H, W), Cb and Cr (H/2, W/2),
    uint8, BT.601 limited range; chroma is the rounded mean of each 2 x 2."""
    x = np.asarray(rgb, np.int64)
    ycc = np.einsum("hwc,kc->khw", x, _RGB_TO_YCC)
    y = (ycc[0] + (16 << 16) + (1 << 15)) >> 16
    planes = [y.astype(np.uint8)]
    for c in ycc[1:]:
        full = (c + (128 << 16) + (1 << 15)) >> 16
        s = full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2] + full[1::2, 1::2]
        planes.append(((s + 2) >> 2).astype(np.uint8))
    return tuple(planes)


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, full_range: bool = False,
                 matrix: int = 6, bit_depth: int = 8, primaries: int = 2, transfer: int = 2,
                 mastering: colour.Mastering | None = None,
                 location: int = swscale.LEFT) -> np.ndarray:
    """Y' (H, W) and Cb, Cr (4:2:0, or any of JPEG's samplings) -> (H, W, 3)
    uint8 R'G'B' as cv2 converts them, for the stream's range (limited:
    16-235, 16-240 at 8 bits, unless `full_range`), matrix_coefficients,
    colour_primaries, transfer_characteristics and chroma siting
    (`location`, an AVChromaLocation: left, as FFmpeg's H.264, HEVC and
    MPEG-4 decoders give it unless the VUI says otherwise).  A matrix or a
    transfer swscale refuses raises `container.UnsupportedCodecError`.  Tags
    that cv2 colour-manages (`colour.managed`: BT.2020, P3 and other wide
    primaries, PQ, HLG) go to `colour.to_rgb`, with the mastering display's
    luminance; the rest go through swscale's own conversion
    (`swscale.to_rgb`: its unscaled path for 8-bit 4:2:0 and 4:2:2 at an
    even height, its scaled path for 9- and 10-bit samples, an odd height
    and JPEG's other samplings), bit for bit."""
    swscale.check(matrix)
    colour.check(colour.normalise(primaries, transfer)[1])
    if colour.managed(primaries, transfer):
        return colour.to_rgb(y, cb, cr, bit_depth=bit_depth, full_range=full_range, matrix=matrix,
                             primaries=primaries, transfer=transfer, mastering=mastering)
    return swscale.to_rgb(y, cb, cr, depth=bit_depth, matrix=matrix, full=full_range,
                          location=location)


# ── transforms and the standard's scaling (8.5) ─────────────────────────

def _butterfly_fwd(x, axis):
    a, b, c, d = (x.take(i, axis) for i in range(4))
    s0, s1, d0, d1 = a + d, b + c, a - d, b - c
    return np.stack([s0 + s1, 2 * d0 + d1, s0 - s1, d0 - 2 * d1], axis)


def _core(x: np.ndarray) -> np.ndarray:
    """The forward 4 x 4 core transform of (..., 4, 4) blocks."""
    return _butterfly_fwd(_butterfly_fwd(x, -1), -2)


def _butterfly_inv(d, axis):
    a, b, c, e = (d.take(i, axis) for i in range(4))
    e0, e1, e2, e3 = a + c, a - c, (b >> 1) - e, b + (e >> 1)
    return np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis)


def _idct(d: np.ndarray) -> np.ndarray:
    """8.5.12.2: the inverse transform of (..., 4, 4) scaled coefficients,
    each row, then each column, then (x + 32) >> 6."""
    return (_butterfly_inv(_butterfly_inv(d, -1), -2) + 32) >> 6


def _hadamard4(c):
    h = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)
    return h @ c @ h


def _hadamard2(c):
    h = np.array([[1, 1], [1, -1]], np.int64)
    return h @ c @ h


def _qp(qp, ndim: int) -> np.ndarray:
    """A QP, scalar or one a leading index, broadcast over `ndim` more axes."""
    q = np.asarray(qp, np.int64)
    return q.reshape(q.shape + (1,) * ndim)


def _scale_ac(levels: np.ndarray, qp) -> np.ndarray:
    """8.5.12.1: (..., 4, 4) coefficient levels -> scaled coefficients, flat
    weights (LevelScale4x4 = 16 normAdjust4x4); qp one a leading index."""
    q = _qp(qp, levels.ndim - np.ndim(qp))
    ls = 16 * _NORM[q % 6, _POS]
    up = (levels * ls) << np.maximum(q // 6 - 4, 0)
    down = (levels * ls + (1 << np.maximum(3 - q // 6, 0))) >> np.maximum(4 - q // 6, 0)
    return np.where(q >= 24, up, down)


def _luma_dc(c: np.ndarray, qp) -> np.ndarray:
    """8.5.10: (..., 4, 4) Intra_16x16 DC levels -> the blocks' DC values."""
    q = _qp(qp, c.ndim - np.ndim(qp))
    f = _hadamard4(c)
    ls = 16 * _NORM[q % 6, 0]
    up = (f * ls) << np.maximum(q // 6 - 6, 0)
    down = (f * ls + (1 << np.maximum(5 - q // 6, 0))) >> np.maximum(6 - q // 6, 0)
    return np.where(q >= 36, up, down)


def _chroma_dc(c: np.ndarray, qpc) -> np.ndarray:
    """8.5.11.2 for 4:2:0: (..., 2, 2) chroma DC levels -> the DC values."""
    q = _qp(qpc, c.ndim - np.ndim(qpc))
    return ((_hadamard2(c) * (16 * _NORM[q % 6, 0])) << (q // 6)) >> 5


def _quant(w, qp, intra: bool, dc: bool = False):
    """Forward quantization (the encoder's choice: rounding offset 1/3 of a
    step for intra, 1/6 for inter; the DC transforms' one more bit)."""
    qbits = 15 + qp // 6 + dc
    f = (1 << qbits) // (3 if intra else 6)
    mf = _MF[qp % 6, 0] if dc else _MF[qp % 6, _POS]
    return np.sign(w) * ((np.abs(w) * mf + f) >> qbits)


def _blocks(x: np.ndarray, n: int) -> np.ndarray:
    """(..., 4n, 4n) -> (..., n, n, 4, 4) blocks (block row, block column)."""
    s = x.shape[:-2]
    return x.reshape(s + (n, 4, n, 4)).swapaxes(-3, -2)


def _unblocks(b: np.ndarray) -> np.ndarray:
    s, n = b.shape[:-4], b.shape[-4]
    return b.swapaxes(-3, -2).reshape(s + (4 * n, 4 * n))


def _scan(b: np.ndarray) -> np.ndarray:
    """(..., 4, 4) -> (..., 16) in zig-zag order."""
    return b.reshape(b.shape[:-2] + (16,))[..., _ZIGZAG]


def _unscan(z: np.ndarray) -> np.ndarray:
    out = np.zeros(z.shape[:-1] + (16,), np.int64)
    out[..., _ZIGZAG[16 - z.shape[-1]:]] = z
    return out.reshape(z.shape[:-1] + (4, 4))


def _luma_residual(dc, ac, qp, intra16: bool):
    """Residual (..., 16, 16) from luma levels: Intra_16x16's DC (..., 16) in
    zig-zag and AC (..., 16 luma4x4BlkIdx, 15), or inter (..., 16, 16)."""
    coef = _unscan(ac)[..., _BLK, :, :]                     # raster block order
    coef = coef.reshape(coef.shape[:-3] + (4, 4, 4, 4))
    d = _scale_ac(coef, qp)
    if intra16:
        d[..., 0, 0] = _luma_dc(_unscan(dc), qp)
    return _unblocks(_idct(d))


def _chroma_residual(dc, ac, qpc):
    """Residual (..., 2, 8, 8) from chroma levels: DC (..., 2, 4) and AC
    (..., 2, 4, 15), chroma4x4BlkIdx in raster order."""
    coef = _unscan(ac).reshape(ac.shape[:-2] + (2, 2, 4, 4))
    d = _scale_ac(coef, qpc[..., None] if np.ndim(qpc) else qpc)
    d[..., 0, 0] = _chroma_dc(dc.reshape(dc.shape[:-1] + (2, 2)),
                              qpc[..., None] if np.ndim(qpc) else qpc)
    return _unblocks(_idct(d))


def _code_luma(res, qp: int, intra16: bool):
    """Quantize a luma residual (N, 16, 16): returns DC (N, 16) and AC (N,
    16, 15) levels (Intra_16x16) or (None, (N, 16, 16)) (inter), in coding
    order, and the reconstructed residual."""
    w = _core(_blocks(res, 4))                               # (N, 4, 4, 4, 4)
    n = res.shape[0]
    if intra16:
        dc_w = _hadamard4(w[..., 0, 0])
        dc_w = np.sign(dc_w) * (np.abs(dc_w) >> 1)
        dc = _scan(_quant(dc_w, qp, True, dc=True))
        ac = _scan(_quant(w, qp, True)).reshape(n, 16, 16)[:, _BLK, 1:]
    else:
        dc, ac = None, _scan(_quant(w, qp, False)).reshape(n, 16, 16)[:, _BLK]
    return dc, ac, _luma_residual(dc, ac, qp, intra16)


def _code_chroma(res, qpc: int, intra: bool):
    """Quantize a chroma residual (N, 2, 8, 8): DC (N, 2, 4) and AC (N, 2, 4,
    15) levels and the reconstructed residual."""
    w = _core(_blocks(res, 2))                               # (N, 2, 2, 2, 4, 4)
    dc = _quant(_hadamard2(w[..., 0, 0]), qpc, intra, dc=True).reshape(res.shape[:2] + (4,))
    ac = _scan(_quant(w, qpc, intra)).reshape(res.shape[:2] + (4, 16))[..., 1:]
    return dc, ac, _chroma_residual(dc, ac, qpc)


# ── bits ────────────────────────────────────────────────────────────────

class _Bits:
    """A bit string for headers: u(n), ue(v), se(v), then the RBSP."""

    def __init__(self):
        self.value, self.n = 0, 0

    def u(self, n: int, x: int) -> _Bits:
        self.value, self.n = self.value << n | x, self.n + n
        return self

    def ue(self, x: int) -> _Bits:
        return self.u(2 * (x + 1).bit_length() - 1, x + 1)

    def se(self, x: int) -> _Bits:
        return self.ue(2 * x - 1 if x > 0 else -2 * x)

    def rbsp(self) -> bytes:
        """The bits with rbsp_trailing_bits, as bytes."""
        pad = -(self.n + 1) % 8
        return ((self.value << 1 | 1) << pad).to_bytes((self.n + 1 + pad) // 8, "big")

    def chunks(self) -> list[tuple[int, int]]:
        """(value, length) pieces of at most 32 bits, first bits first."""
        out, n = [], self.n
        while n > 0:
            k = min(32, n)
            out.append(((self.value >> (n - k)) & ((1 << k) - 1), k))
            n -= k
        return out


_EMULATION = re.compile(rb"\x00\x00(?=[\x00-\x03])")


def nal(ref_idc: int, kind: int, rbsp: bytes) -> bytes:
    """A NAL unit (no start code): its header byte, then the RBSP with Annex B
    emulation prevention (00 00 0x -> 00 00 03 0x for x <= 3)."""
    return bytes([ref_idc << 5 | kind]) + _EMULATION.sub(b"\x00\x00\x03", rbsp)


def _ue_bits(x: np.ndarray):
    """(code, length) of ue(v) for each value."""
    v = np.asarray(x, np.int64) + 1
    n = np.frexp(v.astype(np.float64))[1].astype(np.int64)
    return v, 2 * n - 1


def _se_bits(x: np.ndarray):
    x = np.asarray(x, np.int64)
    return _ue_bits(np.where(x > 0, 2 * x - 1, -2 * x))


def _nc_table(nc: np.ndarray) -> np.ndarray:
    """Which coeff_token table an nC selects (Table 9-5)."""
    return np.where(nc < 0, 4, np.searchsorted([2, 4, 8], nc, side="right"))


def _cavlc(coef: np.ndarray, nc: np.ndarray):
    """CAVLC of (N, M) blocks of levels in scan order (M = maxNumCoeff: 16,
    15 or 4) with their nC: (block, element, code, length) of every syntax
    element, the element numbering its place in the block."""
    n, m = coef.shape
    idx = np.arange(m)
    nz = coef != 0
    total = nz.sum(1)
    # the non-zero levels highest frequency first, and their positions
    order = np.argsort(np.where(nz, -idx, 1), axis=1, kind="stable")
    lev = np.take_along_axis(coef, order, 1)
    pos = np.where(idx < total[:, None], order, -1)
    t1 = np.cumprod(np.abs(lev[:, :3]) == 1, axis=1).sum(1)      # TrailingOnes
    blocks, elems, codes, lens = [], [], [], []

    def put(mask, elem, code, length):
        blocks.append(np.nonzero(mask)[0])
        elems.append(np.broadcast_to(elem, mask.shape)[mask])
        codes.append(np.broadcast_to(code, mask.shape)[mask])
        lens.append(np.broadcast_to(length, mask.shape)[mask])

    table = _nc_table(nc)
    every = np.ones(n, bool)
    put(every, 0, _CT_CODE[table, total, t1], _CT_LEN[table, total, t1])
    signs = np.zeros(n, np.int64)
    for k in range(3):
        signs = np.where(k < t1, signs << 1 | (lev[:, k] < 0), signs)
    put(t1 > 0, 1, signs, t1)

    suffix_len = np.where((total > 10) & (t1 < 3), 1, 0)
    for k in range(m):
        live = (k >= t1) & (k < total)
        if not live.any():
            continue
        level = lev[:, k]
        code = np.where(level > 0, 2 * level - 2, -2 * level - 1)
        code = np.where((k == t1) & (t1 < 3), code - 2, code)
        sl = suffix_len
        big = code >= np.where(sl == 0, 30, 15 << sl)
        mid = (sl == 0) & (code >= 14) & ~big
        prefix = np.where(big, 15, np.where(mid, 14, np.where(sl == 0, code, code >> sl)))
        size = np.where(big, 12, np.where(mid, 4, sl))
        suffix = np.where(big, code - np.where(sl == 0, 30, 15 << sl),
                          np.where(mid, code - 14, code & ((1 << sl) - 1)))
        if (live & (suffix >= 4096)).any():
            raise OverflowError("a level beyond level_prefix 15")
        put(live, 2 + k, (1 << size) | suffix, prefix + 1 + size)
        sl = np.where(sl == 0, 1, sl)
        sl = np.where((np.abs(level) > (3 << (sl - 1))) & (sl < 6), sl + 1, sl)
        suffix_len = np.where(live, sl, suffix_len)

    last = pos[:, 0]
    zeros = np.where(total > 0, last + 1 - total, 0)
    coded = (total > 0) & (total < m)
    if m == 4:
        tz_len, tz_code = _TZC_LEN, _TZC_CODE
    else:
        tz_len, tz_code = _TZ_LEN, _TZ_CODE
    row = np.clip(total - 1, 0, tz_len.shape[0] - 1)
    z = np.minimum(zeros, tz_len.shape[1] - 1)
    put(coded, 2 + m, tz_code[row, z], tz_len[row, z])

    run = np.where(idx[:-1] < total[:, None] - 1, pos[:, :-1] - pos[:, 1:] - 1, 0)
    left = zeros[:, None] - np.concatenate([np.zeros((n, 1), np.int64),
                                            np.cumsum(run, 1)[:, :-1]], 1)
    live = (idx[:-1] < total[:, None] - 1) & (left > 0)
    r = np.minimum(np.maximum(left, 1), 7) - 1
    put(live, 3 + m + idx[:-1], _RB_CODE[r, run], _RB_LEN[r, run])
    return (np.concatenate(blocks), np.concatenate(elems), np.concatenate(codes),
            np.concatenate(lens))


def _pack(keys, codes, lens) -> bytes:
    """Concatenate (code, length) pairs in the order of their keys, as
    bytes (the bits are a multiple of 8 long)."""
    order = np.argsort(keys, kind="stable")
    val = codes[order].astype(np.uint64)
    ln = lens[order].astype(np.int64)
    end = np.cumsum(ln)
    start = end - ln
    total = int(end[-1])
    # every code (<= 33 bits) lands in the 5 bytes from its first one on
    x = val << (40 - (start & 7) - ln).astype(np.uint64)
    first = start >> 3
    n_bytes = total // 8
    out = np.zeros(n_bytes + 5)
    for j in range(5):
        out += np.bincount(first + j, weights=((x >> np.uint64(32 - 8 * j))
                                               & np.uint64(0xFF)).astype(np.float64),
                           minlength=n_bytes + 5)
    return out[:n_bytes].astype(np.uint8).tobytes()


# ── the encoder ─────────────────────────────────────────────────────────

_SLICE_P, _SLICE_I = 5, 7            # slice_type: every slice of the picture P / I
_NAL_SLICE, _NAL_IDR, _NAL_SEI, _NAL_SPS, _NAL_PPS = 1, 5, 6, 7, 8


def sps_rbsp(width: int, height: int, rate: Fraction, level: int) -> bytes:
    """The sequence parameter set: Constrained Baseline (profile_idc 66,
    constraint_set0 and 1), cropped to width x height, VUI with BT.601
    limited range, centred chroma and the frame rate."""
    mbw, mbh = -(-width // 16), -(-height // 16)
    b = _Bits().u(8, 66).u(8, 0xC0).u(8, level).ue(0)
    b.ue(_LOG2_MAX_FRAME_NUM - 4).ue(2).ue(1).u(1, 0)     # frame_num, POC type 2, 1 ref
    b.ue(mbw - 1).ue(mbh - 1).u(1, 1).u(1, 1)             # frames only, direct_8x8
    crop_r, crop_b = (16 * mbw - width) // 2, (16 * mbh - height) // 2
    b.u(1, int(crop_r > 0 or crop_b > 0))
    if crop_r or crop_b:
        b.ue(0).ue(crop_r).ue(0).ue(crop_b)
    b.u(1, 1)                                             # VUI
    b.u(1, 0).u(1, 0)                                     # no aspect ratio, overscan
    b.u(1, 1).u(3, 5).u(1, 0).u(1, 1).u(8, 6).u(8, 6).u(8, 6)   # limited range, BT.601
    b.u(1, 1).ue(1).ue(1)                                 # chroma at the centre of its 2 x 2
    b.u(1, 1).u(32, rate.denominator).u(32, 2 * rate.numerator).u(1, 1)
    b.u(1, 0).u(1, 0).u(1, 0)                             # no HRD, no pic_struct
    b.u(1, 1).u(1, 1).ue(0).ue(0).ue(15).ue(15).ue(0).ue(1)  # no reordering, 1 frame
    return b.rbsp()


def pps_rbsp(qp: int) -> bytes:
    """The picture parameter set: CAVLC, one slice group, one reference,
    pic_init_qp `qp`, deblocking control present."""
    b = _Bits().ue(0).ue(0).u(1, 0).u(1, 0).ue(0).ue(0).ue(0).u(1, 0).u(2, 0)
    b.se(qp - 26).se(0).se(0).u(1, 1).u(1, 0).u(1, 0)
    return b.rbsp()


def slice_header(first_mb: int, slice_type: int, idr: bool, frame_num: int,
                 idr_pic_id: int, qp_delta: int) -> _Bits:
    """A slice header of this encoder's streams (PPS 0, no deblocking)."""
    b = _Bits().ue(first_mb).ue(slice_type).ue(0).u(_LOG2_MAX_FRAME_NUM, frame_num)
    if idr:
        b.ue(idr_pic_id)
    if slice_type % 5 == 0:
        b.u(1, 0).u(1, 0)            # num_ref_idx_active_override, ref_pic_list_modification
    b.u(1, 0)                        # no_output_of_prior_pics / adaptive marking
    if idr:
        b.u(1, 0)                    # long_term_reference_flag
    return b.se(qp_delta).ue(1)      # slice_qp_delta, disable_deblocking_filter_idc 1


@dataclass
class H264Stream:
    """What `encode_h264` returns: the SPS and PPS NAL units, each frame's
    access unit (its NAL units, no start codes), IDR flag, reconstruction
    (Y', Cb, Cr uint8 planes at the frame's size, chroma halved), which any
    conforming decoder outputs, and QP, and the stream's level_idc."""
    sps: bytes
    pps: bytes
    access_units: list[list[bytes]]
    idr: list[bool]
    recon: list[tuple[np.ndarray, np.ndarray, np.ndarray]]
    qp: list[int]
    level: int


class H264Encoder:
    """Encode frames of one size one at a time (`encode`), an IDR every
    `H264_KEYINT` frames; `sps` and `pps` are the parameter sets of the
    stream."""

    def __init__(self, width: int, height: int, fps: float, qp: int = H264_QP):
        why = unsupported_size(width, height, fps)
        if why:
            raise ValueError(f"H.264 cannot hold the frames: {why}")
        if not 0 <= qp <= 51:
            raise ValueError(f"qp {qp}; expected 0 to 51")
        self.width, self.height, self.qp, self.keyint = width, height, qp, H264_KEYINT
        self.rate = Fraction(fps).limit_denominator(1001)
        self.level = level_for(width, height, fps)
        self.mbw, self.mbh = -(-width // 16), -(-height // 16)
        self.sps = nal(3, _NAL_SPS, sps_rbsp(width, height, self.rate, self.level))
        self.pps = nal(3, _NAL_PPS, pps_rbsp(qp))
        self.frame = 0
        self.idr_count = 0
        self.ref: tuple[np.ndarray, ...] | None = None

    def _planes(self, rgb) -> tuple[np.ndarray, ...]:
        img = np.asarray(rgb)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, 2)
        if img.shape != (self.height, self.width, 3) or img.dtype != np.uint8:
            raise ValueError(f"encode: {img.dtype} {img.shape}; expected uint8 "
                             f"({self.height}, {self.width}, 3)")
        padded = np.pad(img, ((0, 16 * self.mbh - self.height), (0, 16 * self.mbw - self.width),
                              (0, 0)), mode="edge")
        return tuple(p.astype(np.int64) for p in rgb_to_ycbcr(padded))

    def encode(self, rgb: np.ndarray) -> tuple[list[bytes], bool, tuple[np.ndarray, ...], int]:
        """One (H, W, 3) uint8 RGB frame -> (its NAL units, whether it is an
        IDR picture, its reconstruction (Y', Cb, Cr), its QP)."""
        cur = self._planes(rgb)
        idr = self.frame % self.keyint == 0
        qp = self.qp
        while True:
            try:
                units, recon = (self._idr(cur, qp) if idr else self._p(cur, qp))
                break
            except OverflowError:
                qp += 1
        if idr:
            self.idr_count += 1
        self.frame += 1
        self.ref = recon
        h, w = self.height, self.width
        out = (recon[0][:h, :w], recon[1][:h // 2, :w // 2], recon[2][:h // 2, :w // 2])
        return units, idr, tuple(p.astype(np.uint8) for p in out), qp

    # ── IDR pictures: Intra_16x16, one slice a macroblock row ──
    def _idr(self, cur, qp):
        y, cb, cr = cur
        rows, cols = self.mbh, self.mbw
        qpc = int(_QPC[qp])
        ry, rcb, rcr = (np.empty_like(p) for p in cur)
        luma_mode = np.empty((rows, cols), np.int64)
        chroma_mode = np.empty((rows, cols), np.int64)
        dc = np.empty((rows, cols, 16), np.int64)
        ac = np.empty((rows, cols, 16, 15), np.int64)
        cdc = np.empty((rows, cols, 2, 4), np.int64)
        cac = np.empty((rows, cols, 2, 4, 15), np.int64)
        for c in range(cols):
            xs, cs = slice(16 * c, 16 * c + 16), slice(8 * c, 8 * c + 8)
            luma = y[:, xs].reshape(rows, 16, 16)
            chroma = np.stack([cb[:, cs].reshape(rows, 8, 8), cr[:, cs].reshape(rows, 8, 8)], 1)
            if c == 0:                  # no neighbour: DC of 128
                pred = np.full_like(luma, 128)
                cpred = np.full_like(chroma, 128)
                luma_mode[:, 0], chroma_mode[:, 0] = 2, 0
            else:
                left = ry[:, 16 * c - 1].reshape(rows, 16)
                ph = np.broadcast_to(left[:, :, None], luma.shape)
                pdc = np.broadcast_to(((left.sum(1) + 8) >> 4)[:, None, None], luma.shape)
                use_h = np.abs(luma - ph).sum((1, 2)) < np.abs(luma - pdc).sum((1, 2))
                pred = np.where(use_h[:, None, None], ph, pdc)
                luma_mode[:, c] = np.where(use_h, 1, 2)
                cleft = np.stack([rcb[:, 8 * c - 1].reshape(rows, 8),
                                  rcr[:, 8 * c - 1].reshape(rows, 8)], 1)
                ch = np.broadcast_to(cleft[..., None], chroma.shape)
                halves = (cleft.reshape(rows, 2, 2, 4).sum(-1) + 2) >> 2
                cdc_pred = np.broadcast_to(np.repeat(halves, 4, -1)[..., None], chroma.shape)
                use_ch = (np.abs(chroma - ch).sum((1, 2, 3))
                          < np.abs(chroma - cdc_pred).sum((1, 2, 3)))
                cpred = np.where(use_ch[:, None, None, None], ch, cdc_pred)
                chroma_mode[:, c] = np.where(use_ch, 1, 0)
            dc[:, c], ac[:, c], res = _code_luma(luma - pred, qp, True)
            cdc[:, c], cac[:, c], cres = _code_chroma(chroma - cpred, qpc, True)
            ry[:, xs] = np.clip(pred + res, 0, 255).reshape(rows * 16, 16)
            rec = np.clip(cpred + cres, 0, 255)
            rcb[:, cs], rcr[:, cs] = (rec[:, k].reshape(rows * 8, 8) for k in (0, 1))
        levels = np.concatenate([dc.reshape(-1), ac.reshape(-1), cdc.reshape(-1)])
        if np.abs(levels).max(initial=0) > _MAX_LEVEL:
            raise OverflowError
        n = rows * cols
        cbp_luma = np.where(np.any(ac != 0, (2, 3)), 15, 0).reshape(n)
        cbp_chroma = np.where(np.any(cac != 0, (2, 3, 4)), 2,
                              np.where(np.any(cdc != 0, (2, 3)), 1, 0)).reshape(n)
        mb_type = 1 + luma_mode.reshape(n) + 4 * cbp_chroma + np.where(cbp_luma == 15, 12, 0)
        header = [(_ue_bits(mb_type), np.ones(n, bool)),
                  (_ue_bits(chroma_mode.reshape(n)), np.ones(n, bool)),
                  (_se_bits(np.zeros(n)), np.ones(n, bool))]
        slices = [slice_header(r * cols, _SLICE_I, True, 0, self.idr_count % 2, qp - self.qp)
                  for r in range(rows)]
        units = self._slices(slices, np.repeat(np.arange(rows), cols), header,
                             dc.reshape(n, 16), ac.reshape(n, 16, 15), cdc.reshape(n, 2, 4),
                             cac.reshape(n, 2, 4, 15), cbp_luma, cbp_chroma,
                             top_in_slice=False, nal_type=_NAL_IDR)
        return units, (ry, rcb, rcr)

    # ── P pictures: P_L0_16x16 with a whole-sample vector, or P_Skip; one slice ──
    def _p(self, cur, qp):
        rows, cols = self.mbh, self.mbw
        n = rows * cols
        qpc = int(_QPC[qp])
        my, mx = np.divmod(np.arange(n), cols)

        def mbs(p, s):
            return p.reshape(rows, s, cols, s).swapaxes(1, 2).reshape(n, s, s)

        def unmbs(m, s):
            return m.reshape(rows, cols, s, s).swapaxes(1, 2).reshape(rows * s, cols * s)

        mv = 4 * _search(cur[0], self.ref[0], rows, cols)        # quarter samples
        pred = _shifted(self.ref[0], 16 * my, 16 * mx, mv[:, 1] // 4, mv[:, 0] // 4, 16)
        cpred = np.stack([_chroma_mc(p, 8 * my, 8 * mx, mv) for p in self.ref[1:]], 1)
        _, ac, res = _code_luma(mbs(cur[0], 16) - pred, qp, False)
        now_c = np.stack([mbs(p, 8) for p in cur[1:]], 1)
        cdc, cac, cres = _code_chroma(now_c - cpred, qpc, False)
        if max(np.abs(ac).max(initial=0), np.abs(cdc).max(initial=0),
               np.abs(cac).max(initial=0)) > _MAX_LEVEL:
            raise OverflowError
        quad = np.any(ac.reshape(n, 4, 64) != 0, 2)             # 8x8 quadrants, in order
        cbp_luma = (quad * (1 << np.arange(4))).sum(1)
        cbp_chroma = np.where(np.any(cac != 0, (1, 2, 3)), 2,
                              np.where(np.any(cdc != 0, (1, 2)), 1, 0))
        cbp = cbp_luma + 16 * cbp_chroma
        mvp, skip_mv = _predictors(mv.reshape(rows, cols, 2))
        mvp, skip_mv = mvp.reshape(n, 2), skip_mv.reshape(n, 2)
        coded = (cbp > 0) | np.any(mv != skip_mv, 1)
        recon = (unmbs(np.clip(pred + res, 0, 255), 16),
                 *(unmbs(np.clip(cpred + cres, 0, 255)[:, k], 8) for k in (0, 1)))
        # mb_skip_run before each coded macroblock
        at = np.flatnonzero(coded)
        run = np.zeros(n, np.int64)
        run[at] = at - np.concatenate([[-1], at[:-1]]) - 1
        mvd = mv - mvp
        header = [(_ue_bits(run), coded), (_ue_bits(np.zeros(n)), coded),  # mb_type P_L0_16x16
                  (_se_bits(mvd[:, 0]), coded), (_se_bits(mvd[:, 1]), coded),
                  (_ue_bits(_INTER_CODE[cbp]), coded), (_se_bits(np.zeros(n)), cbp > 0)]
        frame_num = self.frame % self.keyint % (1 << _LOG2_MAX_FRAME_NUM)
        tail = n - 1 - (at[-1] if at.size else -1)
        units = self._slices([slice_header(0, _SLICE_P, False, frame_num, 0, qp - self.qp)],
                             np.zeros(n, np.int64), header, None, ac, cdc, cac,
                             cbp_luma, cbp_chroma, top_in_slice=True, nal_type=_NAL_SLICE,
                             tail_skip=tail)
        return units, recon

    def _slices(self, headers, slice_of, mb_fields, dc, luma, cdc, cac, cbp_luma, cbp_chroma,
                top_in_slice: bool, nal_type: int, tail_skip: int = 0) -> list[bytes]:
        """The slices' NAL units from each macroblock's header fields ((code,
        length), present) and levels; one slice header a slice."""
        rows, cols = self.mbh, self.mbw
        n = rows * cols
        slots = 40                     # syntax slots a macroblock, 64 elements each
        keys, codes, lens = [], [], []

        def put(key, code, length):
            keys.append(np.asarray(key, np.int64).reshape(-1))
            codes.append(np.asarray(code, np.int64).reshape(-1))
            lens.append(np.asarray(length, np.int64).reshape(-1))

        firsts = np.flatnonzero(np.diff(slice_of, prepend=-1))
        for s, first in enumerate(firsts):
            pieces = headers[s].chunks()
            put(first * slots * 64 + np.arange(len(pieces)), [p[0] for p in pieces],
                [p[1] for p in pieces])
        for k, ((code, length), present) in enumerate(mb_fields):
            at = np.flatnonzero(present)
            put((at * slots + 1 + k) * 64, code[at], length[at])

        # coded blocks: (macroblock, slot, levels, nC)
        intra16 = dc is not None
        lum_tc = np.count_nonzero(luma, -1)                       # (n, 16) blkIdx order
        grid = lum_tc[:, _BLK].reshape(rows, cols, 4, 4).swapaxes(1, 2).reshape(4 * rows,
                                                                               4 * cols)
        lum_nc = _neighbour_nc(grid, 4, top_in_slice)
        lum_nc = lum_nc.reshape(rows, 4, cols, 4).swapaxes(1, 2).reshape(n, 16)[:, _BLK]
        blocks = []                    # (mb, slot, levels (k, M), nC (k,))
        every = np.arange(n)
        if intra16:
            blocks.append((every, np.full(n, 8), dc, lum_nc[:, 0]))
        if intra16:
            luma_coded = np.repeat((cbp_luma == 15)[:, None], 16, 1)
        else:                          # a bit of coded_block_pattern an 8x8
            luma_coded = (cbp_luma[:, None] >> (np.arange(16) // 4)) & 1
        mb, blk = np.nonzero(luma_coded)
        blocks.append((mb, 9 + blk, luma[mb, blk], lum_nc[mb, blk]))
        for comp in (0, 1):
            mb = np.flatnonzero(cbp_chroma > 0)
            blocks.append((mb, np.full(mb.size, 25 + comp), cdc[mb, comp],
                           np.full(mb.size, -1)))
        for comp in (0, 1):
            tc = np.count_nonzero(cac[:, comp], -1)               # (n, 4) raster
            g = tc.reshape(rows, cols, 2, 2).swapaxes(1, 2).reshape(2 * rows, 2 * cols)
            cnc = _neighbour_nc(g, 2, top_in_slice)
            cnc = cnc.reshape(rows, 2, cols, 2).swapaxes(1, 2).reshape(n, 4)
            mb, blk = np.nonzero(np.repeat((cbp_chroma == 2)[:, None], 4, 1))
            blocks.append((mb, 27 + 4 * comp + blk, cac[mb, comp, blk], cnc[mb, blk]))
        for m in (16, 15, 4):
            group = [b for b in blocks if b[2].shape[-1] == m and b[0].size]
            if not group:
                continue
            mb = np.concatenate([g[0] for g in group])
            slot = np.concatenate([g[1] for g in group])
            bi, el, code, length = _cavlc(np.concatenate([g[2] for g in group]),
                                          np.concatenate([g[3] for g in group]))
            put((mb[bi] * slots + slot[bi]) * 64 + el, code, length)

        lasts = np.append(firsts[1:], n) - 1
        if tail_skip:
            put((lasts[-1] * slots + slots - 2) * 64, *_ue_bits(tail_skip))
        keys, codes, lens = (np.concatenate(a) for a in (keys, codes, lens))
        # rbsp_trailing_bits: a one, then zeros to the byte
        per = np.bincount(slice_of[keys // (slots * 64)], weights=lens,
                          minlength=len(firsts)).astype(np.int64)
        pad = -(per + 1) % 8
        keys = np.concatenate([keys, (lasts * slots + slots - 1) * 64])
        codes = np.concatenate([codes, 1 << pad])
        lens = np.concatenate([lens, 1 + pad])
        data = _pack(keys, codes, lens)
        bounds = np.concatenate([[0], np.cumsum((per + 1 + pad) // 8)])
        return [nal(3, nal_type, data[bounds[s]:bounds[s + 1]]) for s in range(len(firsts))]


def _neighbour_nc(tc: np.ndarray, per_mb: int, top_in_slice: bool) -> np.ndarray:
    """nC (9.2.1) of every block of a grid of TotalCoeff counts, per_mb blocks
    a macroblock side: the left neighbour is in the slice when the picture
    has one (its row's slice otherwise), the upper one only where
    `top_in_slice` or within the macroblock."""
    gy, gx = np.indices(tc.shape)
    a_ok = gx > 0
    b_ok = (gy > 0) & ((gy % per_mb != 0) | top_in_slice)
    na = np.pad(tc, ((0, 0), (1, 0)))[:, :-1]
    nb = np.pad(tc, ((1, 0), (0, 0)))[:-1]
    return np.where(a_ok & b_ok, (na + nb + 1) >> 1, np.where(a_ok, na, np.where(b_ok, nb, 0)))


# the motion search: a full search of +-_COARSE samples on planes shrunk 4 x 4,
# then +-_FINE whole samples around its best at full size
_COARSE, _FINE = 4, 2


def _search(cur: np.ndarray, ref: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """A whole-sample motion vector (dx, dy) for each 16 x 16 macroblock of
    `cur` into `ref` (luma planes), least SAD with a small cost a sample of
    length, so that flat areas keep the zero vector."""
    n = rows * cols
    my, mx = np.divmod(np.arange(n), cols)

    def quarter(p):
        return p.reshape(rows * 4, 4, cols * 4, 4).sum((1, 3))

    c4 = quarter(cur).reshape(rows, 4, cols, 4)
    r4 = np.pad(quarter(ref), _COARSE, mode="edge")
    best, coarse = np.full(n, np.iinfo(np.int64).max), np.zeros((n, 2), np.int64)
    for dy in range(-_COARSE, _COARSE + 1):
        for dx in range(-_COARSE, _COARSE + 1):
            win = r4[_COARSE + dy:_COARSE + dy + 4 * rows, _COARSE + dx:_COARSE + dx + 4 * cols]
            cost = np.abs(win.reshape(rows, 4, cols, 4) - c4).sum((1, 3)).reshape(n) \
                + 64 * (abs(dx) + abs(dy))
            better = cost < best
            best[better], coarse[better] = cost[better], (dx, dy)
    blocks = cur.reshape(rows, 16, cols, 16).swapaxes(1, 2).reshape(n, 16, 16).astype(np.int16)
    ref16 = ref.astype(np.int16)
    starts = [np.zeros((n, 2), np.int64)] + [4 * coarse + (dx, dy)
                                             for dy in range(-_FINE, _FINE + 1)
                                             for dx in range(-_FINE, _FINE + 1)]
    best, mv = np.full(n, np.iinfo(np.int64).max), np.zeros((n, 2), np.int64)
    for cand in starts:
        got = _shifted(ref16, 16 * my, 16 * mx, cand[:, 1], cand[:, 0], 16)
        cost = np.abs(got - blocks).sum((1, 2), dtype=np.int64) + 4 * np.abs(cand).sum(1)
        better = cost < best
        best[better], mv[better] = cost[better], cand[better]
    return mv


def _predictors(mv: np.ndarray):
    """The motion vector predictor of 8.4.1.3 and the P_Skip vector of 8.4.1.1
    of every macroblock of a one-slice P picture whose macroblocks are all
    inter with reference index 0, from their vectors (rows, cols, 2)."""
    rows, cols = mv.shape[:2]
    y, x = np.indices((rows, cols))
    pad = np.pad(mv, ((1, 0), (1, 1), (0, 0)))
    a, b = pad[1:, :-2], pad[:-1, 1:-1]
    c, d = pad[:-1, 2:], pad[:-1, :-2]
    a_ok, b_ok = x > 0, y > 0
    c_ok, d_ok = (y > 0) & (x < cols - 1), (x > 0) & (y > 0)
    c = np.where(c_ok[..., None], c, d)                   # C unavailable: D instead
    c_ok = c_ok | d_ok
    only_a = a_ok & ~b_ok & ~c_ok
    one = (a_ok.astype(int) + b_ok + c_ok) == 1
    single = np.where(a_ok[..., None], a, np.where(b_ok[..., None], b, c))
    median = np.sort(np.stack([a, b, c]), 0)[1]           # unavailable ones are 0
    mvp = np.where((only_a | one)[..., None], single, median)
    zero = ~a_ok | ~b_ok | ~a.any(-1) | ~b.any(-1)
    return mvp, np.where(zero[..., None], 0, mvp)


def encode_h264(frames: Iterable[np.ndarray], fps: float, qp: int = H264_QP) -> H264Stream:
    """Encode (H, W, 3) uint8 RGB frames of one size (H, W even) as a
    Constrained Baseline H.264 stream at `qp`; see the module's docstring."""
    enc = None
    units, idr, recon, qps = [], [], [], []
    for rgb in frames:
        if enc is None:
            h, w = np.shape(rgb)[:2]
            enc = H264Encoder(w, h, fps, qp)
        u, i, r, q = enc.encode(rgb)
        units.append(u)
        idr.append(i)
        recon.append(r)
        qps.append(q)
    if enc is None:
        raise ValueError("encode_h264: no frames")
    return H264Stream(enc.sps, enc.pps, units, idr, recon, qps, enc.level)


# ── MP4 ─────────────────────────────────────────────────────────────────

def _avcc(sps: bytes, pps: bytes) -> bytes:
    """The AVCDecoderConfigurationRecord: version 1, profile, compatibility
    and level from the SPS, 4-byte NAL lengths, one SPS and one PPS."""
    return (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]) + struct.pack(">H", len(sps)) + sps
            + b"\x01" + struct.pack(">H", len(pps)) + pps)


def write(path, frames: Iterable[np.ndarray], fps: float, width: int, height: int) -> Path:
    """Encode (height, width, 3) uint8 RGB frames at `H264_QP` into an H.264
    (`avc1`) MP4 file at `path`, streamed, the IDR pictures its sync
    samples; returns the path."""
    enc = H264Encoder(width, height, fps)

    def samples():
        for rgb in frames:
            units, idr, _, _ = enc.encode(rgb)
            yield b"".join(struct.pack(">I", len(u)) + u for u in units), idr

    def entry(sizes):
        return mp4.visual_entry(b"avc1", width, height, mp4.box(b"avcC", _avcc(enc.sps, enc.pps)))

    return container.write_file(path, fps, width, height, lambda f, rate: mp4.write_track(
        f, samples(), rate, width, height, entry))


# ── the reader ──────────────────────────────────────────────────────────

def _unsupported(what: str) -> container.UnsupportedCodecError:
    return container.UnsupportedCodecError(
        f"{what} needs ffmpeg: the port decodes H.264 Main and High profile I, P and B pictures "
        "(8-bit 4:2:0, frames, CAVLC or CABAC) by itself; decoding this needs an ffmpeg binary "
        "(on PATH or from imageio_ffmpeg)")


class _Reader:
    """Bits of an RBSP (emulation prevention removed), read MSB first."""

    def __init__(self, rbsp: bytes):
        n = len(rbsp) * 8
        self.s = bin(int.from_bytes(b"\x01" + rbsp, "big"))[3:] if rbsp else ""
        self.pos = 0
        self.end = self.s.rfind("1")        # the rbsp_stop_one_bit
        if self.end < 0:
            self.end = n

    def u(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.s[self.pos:self.pos + n]
        if len(v) < n:
            raise ValueError("H.264: a NAL unit ends inside a syntax element")
        self.pos += n
        return int(v, 2)

    def ue(self) -> int:
        one = self.s.find("1", self.pos)
        if one < 0:
            raise ValueError("H.264: a NAL unit ends inside a syntax element")
        z = one - self.pos
        self.pos = one + 1
        return (1 << z) - 1 + self.u(z)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)

    def vlc(self, table: dict, longest: int):
        for n in range(1, longest + 1):
            hit = table.get(self.s[self.pos:self.pos + n])
            if hit is not None:
                self.pos += n
                return hit
        raise ValueError("H.264: an invalid variable-length code")

    def more(self) -> bool:
        return self.pos < self.end


def _vlc_table(lens, codes, symbols) -> dict:
    return {format(int(c), f"0{int(n)}b"): s
            for n, c, s in zip(lens, codes, symbols) if n > 0}


_CT_VLC = [_vlc_table(_CT_LEN[t].reshape(-1), _CT_CODE[t].reshape(-1),
                      [(tc, t1) for tc in range(17) for t1 in range(4)]) for t in range(5)]
_TZ_VLC = [_vlc_table(_TZ_LEN[i], _TZ_CODE[i], range(16)) for i in range(15)]
_TZC_VLC = [_vlc_table(_TZC_LEN[i], _TZC_CODE[i], range(4)) for i in range(3)]
_RB_VLC = [_vlc_table(_RB_LEN[i], _RB_CODE[i], range(15)) for i in range(7)]


def _residual_block(r: _Reader, nc: int, m: int) -> list[int]:
    """9.2: one CAVLC block of maxNumCoeff m -> its m levels in scan order."""
    table = 4 if nc < 0 else int(np.searchsorted([2, 4, 8], nc, side="right"))
    total, t1 = r.vlc(_CT_VLC[table], 16)
    out = [0] * m
    if total == 0:
        return out
    if total > m:
        raise ValueError("H.264: TotalCoeff beyond the block")
    levels = []
    sl = 1 if total > 10 and t1 < 3 else 0
    for i in range(total):
        if i < t1:
            levels.append(-1 if r.u(1) else 1)
            continue
        prefix = r.s.find("1", r.pos) - r.pos
        if prefix < 0:
            raise ValueError("H.264: a NAL unit ends inside a level")
        r.pos += prefix + 1
        if prefix > 15:
            raise _unsupported("H.264 level_prefix beyond 15 (High profiles)")
        size = 4 if prefix == 14 and sl == 0 else (12 if prefix == 15 else sl)
        code = (min(15, prefix) << sl) + r.u(size)
        if prefix == 15 and sl == 0:
            code += 15
        if i == t1 and t1 < 3:
            code += 2
        level = (code + 2) >> 1 if code % 2 == 0 else (-code - 1) >> 1
        levels.append(level)
        if sl == 0:
            sl = 1
        if abs(level) > (3 << (sl - 1)) and sl < 6:
            sl += 1
    zeros = 0
    if total < m:
        zeros = r.vlc(_TZC_VLC[total - 1] if m == 4 else _TZ_VLC[total - 1], 9)
    if zeros + total > m:
        raise ValueError("H.264: total_zeros beyond the block")
    runs = []
    for i in range(total - 1):
        run = r.vlc(_RB_VLC[min(zeros, 7) - 1], 11) if zeros > 0 else 0
        runs.append(run)
        zeros -= run
        if zeros < 0:
            raise ValueError("H.264: run_before beyond total_zeros")
    runs.append(zeros)
    k = -1
    for i in range(total - 1, -1, -1):
        k += runs[i] + 1
        out[k] = levels[i]
    return out


def _unescape(data: bytes) -> bytes:
    return re.sub(rb"\x00\x00\x03", b"\x00\x00", data)


_PROFILES = {66: "Baseline", 77: "Main", 88: "Extended", 100: "High", 110: "High 10",
             122: "High 4:2:2", 244: "High 4:4:4 Predictive", 44: "CAVLC 4:4:4 Intra",
             118: "Multiview High", 128: "Stereo High", 83: "Scalable Baseline",
             86: "Scalable High"}
# profile_idc whose SPS carries chroma_format_idc, bit depths and scaling lists
_HIGH_SPS = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135}


def _skip_scaling_list(r: _Reader, size: int) -> None:
    last = nxt = 8
    for _ in range(size):
        if nxt:
            nxt = (last + r.se() + 256) % 256
        last = nxt or last


def parse_sps(unit: bytes) -> dict:
    """The fields of an SPS NAL unit that the readers need: profile, level,
    the picture's size in macroblocks and after cropping, POC fields, and from
    the VUI the frame rate (0.0: none), `full_range`, `primaries`, `transfer`
    and `matrix` (colour_primaries, transfer_characteristics,
    matrix_coefficients, 2 where unspecified), and whether it has a
    video_signal_type (`signal_type`) and a colour description
    (`colour_description`).  What the decoder does not
    read raises `UnsupportedCodecError` naming it: another profile than
    Baseline, Main or High, 4:0:0 / 4:2:2 / 4:4:4, more than 8 bits, fields,
    MBAFF."""
    r = _Reader(_unescape(unit[1:]))
    profile = r.u(8)
    r.u(8)                                       # constraint flags
    sps = {"profile": profile, "level": r.u(8), "id": r.ue()}
    if profile not in (66, 77, 100):
        name = _PROFILES.get(profile, f"profile_idc {profile}")
        raise _unsupported(f"H.264 {name} profile")
    if profile in _HIGH_SPS:
        chroma = r.ue()
        if chroma != 1:
            raise _unsupported("H.264 monochrome (4:0:0) coding" if chroma == 0 else
                               f"H.264 {'High 4:2:2' if chroma == 2 else 'High 4:4:4'} profile")
        if r.ue() or r.ue():
            raise _unsupported("H.264 High 10 profile")
        if r.u(1):
            raise _unsupported("H.264 High 4:4:4 Predictive profile (transform bypass)")
        if r.u(1):
            for i in range(8):
                if r.u(1):
                    _skip_scaling_list(r, 16 if i < 6 else 64)
    sps["log2_max_frame_num"] = r.ue() + 4
    poc = sps["poc_type"] = r.ue()
    if poc == 0:
        sps["log2_max_poc_lsb"] = r.ue() + 4
    elif poc == 1:
        sps["poc_delta_zero"] = r.u(1)
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    sps["refs"] = r.ue()                         # max_num_ref_frames
    r.u(1)
    mbw, mbh = r.ue() + 1, r.ue() + 1
    if not r.u(1):
        raise _unsupported("H.264 MBAFF (macroblock-adaptive frame / field coding)" if r.u(1)
                           else "H.264 interlaced (field) coding")
    r.u(1)
    crop = (0, 0, 0, 0)
    if r.u(1):
        crop = (r.ue(), r.ue(), r.ue(), r.ue())
    sps["mbw"], sps["mbh"] = mbw, mbh
    sps["width"] = 16 * mbw - 2 * (crop[0] + crop[1])
    sps["height"] = 16 * mbh - 2 * (crop[2] + crop[3])
    if sps["width"] <= 0 or sps["height"] <= 0:
        raise ValueError("H.264: the cropping leaves no picture")
    sps["crop"] = (2 * crop[2], 2 * crop[0])
    sps.update(fps=0.0, full_range=False, primaries=2, transfer=2, matrix=2, signal_type=False,
               colour_description=False)
    if r.u(1):                                   # VUI: as far as the frame rate
        if r.u(1):
            if r.u(8) == 255:
                r.u(32)
        if r.u(1):
            r.u(1)
        if r.u(1):
            r.u(3)
            sps["full_range"], sps["signal_type"] = bool(r.u(1)), True
            if r.u(1):
                sps["primaries"], sps["transfer"], sps["matrix"] = r.u(8), r.u(8), r.u(8)
                sps["colour_description"] = True
        if r.u(1):
            r.ue()
            r.ue()
        if r.u(1):
            tick, scale = r.u(32), r.u(32)
            if tick:
                sps["fps"] = scale / (2 * tick)
            if tick and scale:                   # FFmpeg's parser's frame rate
                sps["rate"] = Fraction(scale, 2 * tick)
    return sps


def parse_pps(unit: bytes) -> dict:
    """The fields of a PPS NAL unit that the readers need; slice groups and
    redundant pictures raise `UnsupportedCodecError`."""
    r = _Reader(_unescape(unit[1:]))
    pps = {"id": r.ue(), "sps_id": r.ue(), "cabac": bool(r.u(1)), "bottom_poc": r.u(1)}
    if r.ue():
        raise _unsupported("H.264 slice groups (FMO)")
    pps["refs"] = r.ue() + 1
    r.ue()
    weighted_pred, weighted_bipred = r.u(1), r.u(2)
    pps["weighted"] = bool(weighted_pred or weighted_bipred)
    pps["qp"] = 26 + r.se()
    r.se()
    pps["chroma_qp_offset"] = r.se()
    pps["deblocking_control"] = r.u(1)
    r.u(1)                                       # constrained_intra_pred_flag
    if r.u(1):
        raise _unsupported("H.264 redundant pictures")
    pps["high"] = r.more()                       # 8x8 transform, scaling matrices
    return pps


def _plain_subset(sps: dict, pps: dict) -> None:
    """Refuse, naming it, a stream that `H264Decoder` (the encoder's own
    subset) does not read."""
    if sps["profile"] != 66:
        raise _unsupported(f"H.264 {_PROFILES[sps['profile']]} profile"
                           + (" (CABAC)" if pps["cabac"] else ""))
    if pps["cabac"]:
        raise _unsupported("H.264 CABAC entropy coding")
    if pps["weighted"]:
        raise _unsupported("H.264 weighted prediction")
    if pps["high"]:
        raise _unsupported("H.264 High-profile picture parameters (8x8 transform, scaling "
                           "matrices)")


# the intra modes the encoder never writes, by Intra16x16PredMode and
# intra_chroma_pred_mode (Horizontal is 1 in both, DC luma 2 and chroma 0)
_LUMA_REFUSED = {0: "Intra_16x16 vertical", 3: "Intra_16x16 plane"}
_CHROMA_REFUSED = {2: "intra chroma vertical", 3: "intra chroma plane"}


class H264Decoder:
    """Decodes access units of the subset the encoder writes, one at a time,
    keeping the one reference frame: the plain version of the host decoder
    (`Decoder`), which the reading path uses; the tests hold one to the
    other."""

    def __init__(self, sps: bytes, pps: bytes):
        self.sps, self.pps = parse_sps(sps), parse_pps(pps)
        _plain_subset(self.sps, self.pps)
        self.ref: tuple[np.ndarray, ...] | None = None

    def decode(self, units: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One access unit's NAL units -> the picture (Y', Cb, Cr) cropped."""
        pic, ref_idc = None, 0
        for unit in units:
            kind = unit[0] & 0x1F
            if kind == _NAL_SPS:
                self.sps = parse_sps(unit)
                _plain_subset(self.sps, self.pps)
            elif kind == _NAL_PPS:
                self.pps = parse_pps(unit)
                _plain_subset(self.sps, self.pps)
            elif kind in (_NAL_SLICE, _NAL_IDR):
                pic = pic or _Picture(self.sps["mbw"] * self.sps["mbh"])
                ref_idc = unit[0] >> 5
                self._slice(_Reader(_unescape(unit[1:])), kind == _NAL_IDR, ref_idc, pic)
            elif kind in (2, 3, 4):
                raise _unsupported("H.264 data partitioning")
        if pic is None:
            raise ValueError("H.264: an access unit with no slice")
        sps = self.sps
        mbw, mbh = sps["mbw"], sps["mbh"]
        n = mbw * mbh
        if not pic.done.all():
            raise ValueError(f"H.264: the slices cover {int(pic.done.sum())} of {n} "
                             "macroblocks")
        planes = pic.reconstruct(mbw, mbh, self.ref, self.pps["chroma_qp_offset"])
        if ref_idc:
            self.ref = planes
        (top, left), h, w = sps["crop"], sps["height"], sps["width"]
        return (planes[0][top:top + h, left:left + w],
                planes[1][top // 2:(top + h) // 2, left // 2:(left + w) // 2],
                planes[2][top // 2:(top + h) // 2, left // 2:(left + w) // 2])

    def _slice(self, r: _Reader, idr: bool, ref_idc: int, pic: _Picture):
        sps, pps = self.sps, self.pps
        mbw, n = sps["mbw"], sps["mbw"] * sps["mbh"]
        first = r.ue()
        kind = r.ue() % 5
        if kind not in (0, 2):
            raise _unsupported(f"H.264 {'B' if kind == 1 else 'SP/SI'} slices")
        r.ue()
        r.u(sps["log2_max_frame_num"])
        if idr:
            r.ue()
        if sps["poc_type"] == 0:
            r.u(sps["log2_max_poc_lsb"])
            if pps["bottom_poc"]:
                r.se()
        elif sps["poc_type"] == 1 and not sps["poc_delta_zero"]:
            r.se()
            if pps["bottom_poc"]:
                r.se()
        refs = pps["refs"]
        if kind == 0:
            if r.u(1):
                refs = r.ue() + 1
            if refs > 1:
                raise _unsupported("H.264 more than one reference frame")
            if r.u(1):
                raise _unsupported("H.264 reference list modification")
            if self.ref is None:
                raise ValueError("H.264: a P slice with no reference picture")
        if ref_idc:
            if idr:
                r.u(2)
            elif r.u(1):
                raise _unsupported("H.264 adaptive reference picture marking")
        qp = pps["qp"] + r.se()
        if not pps["deblocking_control"] or r.ue() != 1:
            raise _unsupported("H.264 the deblocking filter")
        if first >= n:
            raise ValueError("H.264: first_mb_in_slice beyond the picture")
        sid = pic.new_slice()
        mb = first
        while True:
            if kind == 0:
                run = r.ue()
                for _ in range(run):
                    if mb >= n:
                        raise ValueError("H.264: mb_skip_run beyond the picture")
                    pic.skip(mb, sid, qp, mbw)
                    mb += 1
                if run and not r.more():
                    break
            if mb >= n:
                raise ValueError("H.264: macroblocks beyond the picture")
            qp = self._macroblock(r, kind, mb, sid, qp, pic)
            mb += 1
            if not r.more():
                break

    def _macroblock(self, r: _Reader, kind: int, mb: int, sid: int, qp: int,
                    pic: _Picture) -> int:
        mbw = self.sps["mbw"]
        t = r.ue()
        if kind == 0:
            if t >= 5:
                raise _unsupported("H.264 intra macroblocks in P slices")
            if t != 0:
                raise _unsupported("H.264 P macroblock partitions below 16x16")
            mvd = (r.se(), r.se())
            code = r.ue()
            if code > 47:
                raise ValueError("H.264: coded_block_pattern out of range")
            cbp = int(_INTER_CBP[code])
            intra, cbp_luma, cbp_chroma = False, cbp & 15, cbp >> 4
        else:
            if t == 0:
                raise _unsupported("H.264 I_NxN macroblocks")
            if t == 25:
                raise _unsupported("H.264 I_PCM macroblocks")
            if t > 25:
                raise ValueError("H.264: mb_type out of range")
            intra, mode = True, (t - 1) % 4
            cbp_chroma, cbp_luma = ((t - 1) // 4) % 3, 15 if t >= 13 else 0
            cmode = r.ue()
            if cmode > 3:
                raise ValueError("H.264: intra_chroma_pred_mode out of range")
            for refused, m in ((_LUMA_REFUSED, mode), (_CHROMA_REFUSED, cmode)):
                if m in refused:
                    raise _unsupported(f"H.264 {refused[m]} prediction")
        if intra or cbp_luma or cbp_chroma:
            qp = (qp + r.se() + 52) % 52
        pic.start(mb, sid, qp, intra)
        if intra:
            pic.modes[mb] = (mode, cmode)
            pic.dc[mb] = _residual_block(r, pic.luma_nc(mb, 0, mbw), 16)
        else:
            pic.set_mv(mb, mvd, mbw)
        for blk in range(16):
            if cbp_luma >> (blk // 4) & 1:
                m = 15 if intra else 16
                levels = _residual_block(r, pic.luma_nc(mb, blk, mbw), m)
                pic.luma[mb, blk, 16 - m:] = levels
                pic.luma_tc[mb, blk] = sum(v != 0 for v in levels)
        if cbp_chroma:
            for comp in (0, 1):
                pic.cdc[mb, comp] = _residual_block(r, -1, 4)
        if cbp_chroma == 2:
            for comp in (0, 1):
                for blk in range(4):
                    levels = _residual_block(r, pic.chroma_nc(mb, comp, blk, mbw), 15)
                    pic.cac[mb, comp, blk] = levels
                    pic.chroma_tc[mb, comp, blk] = sum(v != 0 for v in levels)
        return qp


class _Picture:
    """What the slices of one picture carry, macroblock by macroblock, until
    `reconstruct` turns it into samples."""

    def __init__(self, n: int):
        self.slice = np.full(n, -1, np.int64)
        self.done = np.zeros(n, bool)
        self.intra = np.zeros(n, bool)
        self.skipped = np.zeros(n, bool)
        self.qp = np.zeros(n, np.int64)
        self.modes = np.zeros((n, 2), np.int64)
        self.mv = np.zeros((n, 2), np.int64)
        self.dc = np.zeros((n, 16), np.int64)
        self.luma = np.zeros((n, 16, 16), np.int64)
        self.cdc = np.zeros((n, 2, 4), np.int64)
        self.cac = np.zeros((n, 2, 4, 15), np.int64)
        self.luma_tc = np.zeros((n, 16), np.int64)
        self.chroma_tc = np.zeros((n, 2, 4), np.int64)
        self.slices = 0

    def new_slice(self) -> int:
        self.slices += 1
        return self.slices - 1

    def start(self, mb: int, sid: int, qp: int, intra: bool):
        if self.done[mb]:
            raise ValueError(f"H.264: macroblock {mb} is coded twice")
        self.slice[mb], self.done[mb], self.qp[mb], self.intra[mb] = sid, True, qp, intra

    def available(self, mb: int, other: int) -> bool:
        return 0 <= other and self.slice[other] == self.slice[mb] and self.done[other]

    def _neighbours(self, mb: int, mbw: int):
        """(left, top, top-right, top-left) macroblock addresses, None where
        not available (6.4.9)."""
        x = mb % mbw
        a = mb - 1 if x > 0 and self.available(mb, mb - 1) else None
        b = mb - mbw if self.available(mb, mb - mbw) else None
        c = mb - mbw + 1 if x < mbw - 1 and self.available(mb, mb - mbw + 1) else None
        d = mb - mbw - 1 if x > 0 and self.available(mb, mb - mbw - 1) else None
        return a, b, c, d

    def _nc(self, mb, mbw, bx, by, per, counts):
        """nC from the left and upper 4 x 4 blocks (9.2.1)."""
        left, top, _, _ = self._neighbours(mb, mbw)
        na = counts(mb, bx - 1, by) if bx > 0 else (
            counts(left, per - 1, by) if left is not None else None)
        nb = counts(mb, bx, by - 1) if by > 0 else (
            counts(top, bx, per - 1) if top is not None else None)
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        return na if na is not None else (nb if nb is not None else 0)

    def luma_nc(self, mb: int, blk: int, mbw: int) -> int:
        raster = _BLK[blk]
        return self._nc(mb, mbw, raster % 4, raster // 4, 4,
                        lambda m, x, y: int(self.luma_tc[m, _BLK[y * 4 + x]]))

    def chroma_nc(self, mb: int, comp: int, blk: int, mbw: int) -> int:
        return self._nc(mb, mbw, blk % 2, blk // 2, 2,
                        lambda m, x, y: int(self.chroma_tc[m, comp, y * 2 + x]))

    def _mvp(self, mb: int, mbw: int):
        """8.4.1.3 for a 16x16 partition with reference index 0."""
        a, b, c, d = self._neighbours(mb, mbw)
        if c is None:
            c = d

        def of(m):
            if m is None or self.intra[m]:
                return -1, (0, 0)
            return 0, tuple(int(v) for v in self.mv[m])

        (ra, mva), (rb, mvb), (rc, mvc) = of(a), of(b), of(c)
        if b is None and c is None and a is not None:
            return mva
        hits = [mv for ref, mv in ((ra, mva), (rb, mvb), (rc, mvc)) if ref == 0]
        if len(hits) == 1:
            return hits[0]
        return tuple(sorted(v)[1] for v in zip(mva, mvb, mvc))

    def set_mv(self, mb: int, mvd, mbw: int):
        p = self._mvp(mb, mbw)
        self.mv[mb] = (p[0] + mvd[0], p[1] + mvd[1])
        if self.mv[mb, 0] % 4 or self.mv[mb, 1] % 4:
            raise _unsupported("H.264 fractional-sample motion vectors")

    def skip(self, mb: int, sid: int, qp: int, mbw: int):
        """A P_Skip macroblock: its vector by 8.4.1.1, no residual."""
        self.start(mb, sid, qp, False)
        self.skipped[mb] = True
        a, b, _, _ = self._neighbours(mb, mbw)
        if not (a is None or b is None
                or any(not self.intra[m] and not self.mv[m].any() for m in (a, b))):
            self.set_mv(mb, (0, 0), mbw)

    def reconstruct(self, mbw: int, mbh: int, ref, chroma_qp_offset: int):
        n = mbw * mbh
        qpc = _QPC[np.clip(self.qp + chroma_qp_offset, 0, 51)]
        luma_res = np.zeros((n, 16, 16), np.int64)
        intra = self.intra
        inter = ~intra
        if intra.any():
            lvl = self.luma[intra][:, :, 1:]
            luma_res[intra] = _luma_residual(self.dc[intra], lvl, self.qp[intra], True)
        if inter.any():
            luma_res[inter] = _luma_residual(None, self.luma[inter], self.qp[inter], False)
        chroma_res = _chroma_residual(self.cdc, self.cac, qpc)
        y = np.zeros((16 * mbh, 16 * mbw), np.int64)
        c = np.zeros((2, 8 * mbh, 8 * mbw), np.int64)
        if inter.any():
            at = np.flatnonzero(inter)
            my, mx = at // mbw, at % mbw
            py = _shifted(ref[0], 16 * my, 16 * mx, self.mv[at, 1] // 4, self.mv[at, 0] // 4, 16)
            pcs = [_chroma_mc(plane, 8 * my, 8 * mx, self.mv[at]) for plane in ref[1:]]
            y.reshape(mbh, 16, mbw, 16).swapaxes(1, 2)[my, mx] = np.clip(
                py + luma_res[at], 0, 255)
            c.reshape(2, mbh, 8, mbw, 8).transpose(1, 3, 0, 2, 4)[my, mx] = np.clip(
                np.stack(pcs, 1) + chroma_res[at], 0, 255)
        for mb in np.flatnonzero(intra):
            yy, xx = divmod(int(mb), mbw)
            left, top, _, _ = self._neighbours(int(mb), mbw)
            mode, cmode = self.modes[mb]
            ys, xs = slice(16 * yy, 16 * yy + 16), slice(16 * xx, 16 * xx + 16)
            pred = _intra_pred(y, 16 * yy, 16 * xx, 16, mode, left, top, luma=True)
            y[ys, xs] = np.clip(pred + luma_res[mb], 0, 255)
            for k in (0, 1):
                pred = _intra_pred(c[k], 8 * yy, 8 * xx, 8, cmode, left, top, luma=False)
                c[k, 8 * yy:8 * yy + 8, 8 * xx:8 * xx + 8] = np.clip(
                    pred + chroma_res[mb, k], 0, 255)
        return y.astype(np.uint8), c[0].astype(np.uint8), c[1].astype(np.uint8)


def _shifted(plane, y0, x0, dy, dx, size):
    """(k, size, size) blocks of a reference plane at (y0 + dy, x0 + dx),
    coordinates clamped to the plane (8.4.2.2), of the plane's dtype."""
    h, w = plane.shape
    r = np.arange(size)
    ys = np.clip((y0 + dy)[:, None] + r, 0, h - 1)
    xs = np.clip((x0 + dx)[:, None] + r, 0, w - 1)
    return plane[ys[:, :, None], xs[:, None, :]]


def _chroma_mc(plane, y0, x0, mv):
    """8.4.2.2.2 for 4:2:0: the chroma block of each vector (1/8 sample)."""
    fy, fx = mv[:, 1] & 7, mv[:, 0] & 7
    iy, ix = mv[:, 1] >> 3, mv[:, 0] >> 3
    a = _shifted(plane, y0, x0, iy, ix, 9).astype(np.int64)
    fy, fx = fy[:, None, None], fx[:, None, None]
    return ((8 - fx) * (8 - fy) * a[:, :8, :8] + fx * (8 - fy) * a[:, :8, 1:]
            + (8 - fx) * fy * a[:, 1:, :8] + fx * fy * a[:, 1:, 1:] + 32) >> 6


def _intra_pred(plane, y0, x0, size, mode, left, top, luma: bool):
    """8.3.3 (luma, size 16) and 8.3.4 (chroma, size 8) prediction of the
    macroblock at (y0, x0) from the samples already reconstructed: mode 1
    Horizontal, any other DC (the reader refuses Vertical and Plane)."""
    has_l, has_t = left is not None, top is not None
    col = plane[y0:y0 + size, x0 - 1] if has_l else None
    row = plane[y0 - 1, x0:x0 + size] if has_t else None
    if mode == 1:
        if not has_l:
            raise ValueError("H.264: Horizontal prediction with no left neighbour")
        return np.broadcast_to(col[:, None], (size, size))
    if luma:
        if has_l and has_t:
            v = (col.sum() + row.sum() + 16) >> 5
        elif has_l or has_t:
            v = ((col if has_l else row).sum() + 8) >> 4
        else:
            v = 128
        return np.full((size, size), v, np.int64)
    out = np.empty((8, 8), np.int64)
    for by in (0, 1):
        for bx in (0, 1):
            lc = col[4 * by:4 * by + 4] if has_l else None
            tr = row[4 * bx:4 * bx + 4] if has_t else None
            if bx == by and lc is not None and tr is not None:
                v = (lc.sum() + tr.sum() + 4) >> 3
            else:
                # the upper neighbour first for the top-right block, else the left
                first, second = (tr, lc) if (bx, by) == (1, 0) else (lc, tr)
                pick = first if first is not None else second
                v = (pick.sum() + 2) >> 2 if pick is not None else 128
            out[4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = v
    return out


def _avcc_units(avcc: bytes, path) -> tuple[list[bytes], list[bytes], int]:
    """(SPS units, PPS units, NAL length size) of an avcC box's body; an
    `avc3` track may hold none, its parameter sets being in band."""
    if len(avcc) < 7 or avcc[0] != 1:
        raise ValueError(f"{path}: an avcC box of version {avcc[:1].hex() or 'none'}")
    pos, sets = 5, []
    for mask in (0x1F, 0xFF):
        if pos >= len(avcc):
            raise ValueError(f"{path}: the avcC box is cut short")
        count, pos = avcc[pos] & mask, pos + 1
        units = []
        for _ in range(count):
            size = int.from_bytes(avcc[pos:pos + 2], "big")
            units.append(avcc[pos + 2:pos + 2 + size])
            if pos + 2 > len(avcc) or len(units[-1]) != size or size == 0:
                raise ValueError(f"{path}: a parameter set of the avcC box is cut short")
            pos += 2 + size
        sets.append(units)
    return sets[0], sets[1], (avcc[4] & 3) + 1


# ── the host decoder ────────────────────────────────────────────────────

_SOURCE = Path(__file__).resolve().with_name("h264dec.cpp")
_GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use, with g++, into `omfs4d_torch/_build/`) and load
    the host decoder; raises RuntimeError with g++'s message when it cannot:
    no frame is decoded in Python on the reading path."""
    from omfs4d_torch import native

    path = native.build(_SOURCE, "h264dec", _GXX_FLAGS,
                        "omfs4d_torch/io/h264dec.cpp (the H.264 decoder)",
                        headers={"h264_tables.h": h264_tables.cpp_header()})
    return frames_base.bind_decoder(ctypes.CDLL(str(path)), "h264d")


class Decoder(frames_base.HostDecoder):
    """The host C++ decoder (`h264dec.cpp`), as `frames.HostDecoder` sets
    out."""

    prefix, codec = "h264d", "H.264"

    def library(self) -> ctypes.CDLL:
        return _library()

    def unsupported(self, msg: str) -> container.UnsupportedCodecError:
        return _unsupported(msg)


# an Annex B stream's NAL units
annexb_units = frames_base.annexb_units


def decode_annexb(data: bytes) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Every picture of an Annex B H.264 stream, through the host decoder,
    in output order."""
    dec = Decoder()
    out = []
    for unit in annexb_units(data):
        dec.push(unit)
        out += dec.pictures()
    dec.flush()
    return out + dec.pictures()


def _refuse_recovered(path, leading: list[list[bytes]], pps: list[bytes]) -> None:
    """Raise `UnsupportedCodecError` where a stream's samples before its
    first IDR picture (`leading`, their NAL units) hold one that cv2's
    FFmpeg shows rather than drops: a recovery point SEI, or an I picture
    whose PPS has at most one default reference (FFmpeg's heuristic).  The
    port starts a decode only at an IDR picture; the samples before it that
    hold none of these FFmpeg drops too."""
    sets = {parse_pps(u)["id"]: parse_pps(u) for u in pps}
    for k, units in enumerate(leading):
        for u in units:
            t = u[0] & 0x1F
            if t == _NAL_PPS:
                p = parse_pps(u)
                sets[p["id"]] = p
            elif t == _NAL_SEI and 6 in _sei_types(_unescape(u[1:])):
                raise _unsupported(f"H.264 that starts at a recovery point SEI ({path}: frame "
                                   f"{k}, before the first IDR picture, which cv2 shows)")
            elif t in (1, 5):
                r = _Reader(_unescape(u[1:]))
                r.ue()
                slice_type, pps_id = r.ue() % 5, r.ue()
                if slice_type in (2, 4) and pps_id in sets and sets[pps_id]["refs"] <= 1:
                    raise _unsupported(f"H.264 that starts at a non-IDR I picture ({path}: "
                                       f"frame {k}, before the first IDR picture, which cv2 "
                                       "shows)")
                break


def _sei_types(rbsp: bytes) -> list[int]:
    """The payloadType of each message of an SEI RBSP."""
    out, pos = [], 0
    while pos < len(rbsp) and rbsp[pos] != 0x80:
        values = []
        for _ in range(2):
            v = 0
            while pos < len(rbsp) and rbsp[pos] == 0xFF:
                v += 255
                pos += 1
            if pos >= len(rbsp):
                return out
            values.append(v + rbsp[pos])
            pos += 1
        out.append(values[0])
        pos += values[1]
    return out


class H264Frames(frames_base.SampleFrames):
    """The frames of an H.264 file (MP4 / QuickTime, Matroska, AVI) as (H, W,
    3) uint8 RGB, decoded by the host decoder on access, as cv2 shows them
    (see `frames.SampleFrames`), converted with the VUI's range and matrix.
    The parameter sets are the avcC box's, or for `avc3` the first sample's;
    an Annex B track's (AVI, MPEG-TS) are its extradata's or its first
    restart's.  An AVI or MPEG-TS track, which has no sync table, restarts
    only at a sample holding an IDR picture and parameter sets (its own, or
    the extradata's); the samples before the first show nothing, as FFmpeg
    drops them (`_refuse_recovered` refuses those it would show)."""

    def __init__(self, path: Path, offsets: list[int], sizes: list[int], info: dict):
        super().__init__(path, offsets, sizes, info)
        if "avcC" in info:
            self.sps, self.pps, self.length = _avcc_units(info["avcC"], path)
        else:                                  # Annex B samples
            head = annexb_units(info["annexb"])
            self.sps = [u for u in head if u[0] & 0x1F == _NAL_SPS][:1]
            self.pps = [u for u in head if u[0] & 0x1F == _NAL_PPS]
            self.length = 0
        first = 0
        if "sync" not in info:                 # AVI, MPEG-TS: no sync table
            extradata_sets = bool(self.sps and self.pps)
            self.in_band_starts(lambda u: u[0] & 0x1F, lambda kinds, s: (
                _NAL_IDR in kinds[s]
                and (extradata_sets or {_NAL_SPS, _NAL_PPS} <= set(kinds[s]))),
                lambda kinds: {s for s, k in enumerate(kinds) if not any(1 <= t <= 5 for t in k)})
            first = self.starts[0] if self.starts else len(offsets)
            _refuse_recovered(path, [self.units(s) for s in range(first)], self.pps)
        if not self.sps:                       # avc3 / Annex B: the parameter sets in band
            units = self.units(first if first < len(offsets) else 0) if offsets else []
            self.sps = [u for u in units if u[0] & 0x1F == _NAL_SPS][:1]
            self.pps = [u for u in units if u[0] & 0x1F == _NAL_PPS]
            if not self.sps:
                raise ValueError(f"{path}: no sequence parameter set in the avcC box or the "
                                 "first sample")
        # refuse a stream outside the decoder's subset now, with no decode
        self.params = parse_sps(self.sps[0])
        for unit in self.pps:
            parse_pps(unit)
        mastering = colour.mastering_of((_unescape(u[1:]) for u in (
            self.units(0) if offsets else []) if u[0] & 0x1F == _NAL_SEI), info)
        self.colour = colour.stream(colour.from_container(self.params, info.get("colr")),
                                    mastering=mastering)

    def header_units(self) -> list[bytes]:
        return self.sps + self.pps

    def new_decoder(self) -> Decoder:
        return Decoder()

    def rgb_of(self, planes) -> np.ndarray:
        return ycbcr_to_rgb(*planes, **self.colour)


def frames(path) -> H264Frames:
    """The frames of an H.264 (`avc1` / `avc3`) MP4 or QuickTime file,
    decoded on access by the host decoder; parameter sets outside its subset
    raise."""
    offsets, sizes, info = container.index(path)
    if info["codec"] != "h264":
        raise ValueError(f"{path}: its video is not H.264")
    return H264Frames(Path(path), offsets, sizes, info)
