"""The tables of MPEG-1 video (ISO/IEC 11172-2) and MPEG-2 video (ISO/IEC
13818-2) that the port's host decoder (`omfs4d_torch/io/mpeg2dec.cpp`) and
the test writer read, in one place, as libavcodec holds them (mpeg12data.c,
mpeg12vlc.h, mpeg12dec.c; the tests hold them to its bytes).

The C++ decoder gets them as a generated header (`cpp_header`), written
beside the library when it is built, so no table is typed twice.  Codes are
given as (code, length) pairs, the code's bits the low `length` bits of
`code`, most significant first.

- Macroblock headers: macroblock_address_increment (Table B.1: increments
  1-33, then the escape, MPEG-1's stuffing and the 8 zero bits that end a
  slice), macroblock_type of P and B pictures (Tables B.3 and B.4, with
  their `MB_*` flags; an I picture's is read bit by bit: 1 intra, 01 intra
  with quant), coded_block_pattern of 4:2:0 (Table B.9, indexed by the
  pattern).
- Motion: motion_code (Table B.10) by |code|, the sign bit following a
  non-zero code; dmvector (Table B.11) for 0, +1 and -1.
- Intra DC: dct_dc_size of luminance (Table B.12) and chrominance (Table
  B.13).
- DCT coefficients: Table B.14 (`B14`) and Table B.15 (`B15`, an intra
  block's where intra_vlc_format is 1), each the 111 run / level codes in
  the order of `RUN` and `LEVEL` (the sign bit follows), then the escape
  and the end of block.  B.14's run 0 level 1 is "11s" but as a block's
  first coefficient of a non-intra block, where it is "1s".
- Scans: zigzag and alternate (Figure 7-2 / 7-3), as raster positions.
- Quantisation: the default intra matrix (6.3.11, raster order; the
  non-intra default is 16 throughout), and the non-linear quantiser_scale
  (Table 7-6) by quantiser_scale_code.
- frame_rate_code (Table 6-4), with FFmpeg's own codes 9-13 (Xing's 15 fps
  and libmpeg3's economy rates), as (numerator, denominator).
"""

from __future__ import annotations

import numpy as np

# ── macroblock headers ──────────────────────────────────────────────────
# Table B.1: increments 1-33 (index - 1), escape (33), stuffing (34), and
# the 8 zero bits a slice's end starts with (35)
MB_INCREMENT = np.array([
    [0x1, 1], [0x3, 3], [0x2, 3], [0x3, 4], [0x2, 4], [0x3, 5], [0x2, 5], [0x7, 7],
    [0x6, 7], [0xb, 8], [0xa, 8], [0x9, 8], [0x8, 8], [0x7, 8], [0x6, 8], [0x17, 10],
    [0x16, 10], [0x15, 10], [0x14, 10], [0x13, 10], [0x12, 10], [0x23, 11], [0x22, 11], [0x21, 11],
    [0x20, 11], [0x1f, 11], [0x1e, 11], [0x1d, 11], [0x1c, 11], [0x1b, 11], [0x1a, 11], [0x19, 11],
    [0x18, 11], [0x8, 11], [0xf, 11], [0x0, 8],
])
INCREMENT_ESCAPE, INCREMENT_STUFFING, INCREMENT_END = 33, 34, 35

# macroblock_type flags, as libavcodec's tables name them
MB_INTRA, MB_PATTERN, MB_BACKWARD, MB_FORWARD, MB_QUANT = 1, 2, 4, 8, 16
# Table B.3 (P): (code, length) and the flags of each type
MB_TYPE_P = np.array([[3, 5], [1, 2], [1, 3], [1, 1], [1, 6], [1, 5], [2, 5]])
MB_FLAGS_P = np.array([0x01, 0x02, 0x08, 0x0A, 0x11, 0x12, 0x1A])
# Table B.4 (B)
MB_TYPE_B = np.array([[3, 5], [2, 3], [3, 3], [2, 4], [3, 4], [2, 2], [3, 2], [1, 6], [2, 6],
                      [3, 6], [2, 5]])
MB_FLAGS_B = np.array([0x01, 0x04, 0x06, 0x08, 0x0A, 0x0C, 0x0E, 0x11, 0x16, 0x1A, 0x1E])

# Table B.9: coded_block_pattern (4:2:0) by its value; 0 only in 4:2:2 / 4:4:4
CBP = np.array([
    [0x1, 9], [0xb, 5], [0x9, 5], [0xd, 6], [0xd, 4], [0x17, 7], [0x13, 7], [0x1f, 8],
    [0xc, 4], [0x16, 7], [0x12, 7], [0x1e, 8], [0x13, 5], [0x1b, 8], [0x17, 8], [0x13, 8],
    [0xb, 4], [0x15, 7], [0x11, 7], [0x1d, 8], [0x11, 5], [0x19, 8], [0x15, 8], [0x11, 8],
    [0xf, 6], [0xf, 8], [0xd, 8], [0x3, 9], [0xf, 5], [0xb, 8], [0x7, 8], [0x7, 9],
    [0xa, 4], [0x14, 7], [0x10, 7], [0x1c, 8], [0xe, 6], [0xe, 8], [0xc, 8], [0x2, 9],
    [0x10, 5], [0x18, 8], [0x14, 8], [0x10, 8], [0xe, 5], [0xa, 8], [0x6, 8], [0x6, 9],
    [0x12, 5], [0x1a, 8], [0x16, 8], [0x12, 8], [0xd, 5], [0x9, 8], [0x5, 8], [0x5, 9],
    [0xc, 5], [0x8, 8], [0x4, 8], [0x4, 9], [0x7, 3], [0xa, 5], [0x8, 5], [0xc, 6],
])

# ── motion ──────────────────────────────────────────────────────────────
# Table B.10: motion_code by |code| 0-16
MOTION = np.array([
    [0x1, 1], [0x1, 2], [0x1, 3], [0x1, 4], [0x3, 6], [0x5, 7], [0x4, 7], [0x3, 7],
    [0xb, 9], [0xa, 9], [0x9, 9], [0x11, 10], [0x10, 10], [0xf, 10], [0xe, 10], [0xd, 10],
    [0xc, 10],
])
# Table B.11: dmvector 0, +1, -1
DMVECTOR = np.array([[0, 1], [2, 2], [3, 2]])

# ── intra DC ────────────────────────────────────────────────────────────
# Tables B.12 / B.13: dct_dc_size 0-11
DC_LUMA = np.array([[4, 3], [0, 2], [1, 2], [5, 3], [6, 3], [14, 4], [30, 5], [62, 6],
                    [126, 7], [254, 8], [510, 9], [511, 9]])
DC_CHROMA = np.array([[0, 2], [1, 2], [2, 2], [6, 3], [14, 4], [30, 5], [62, 6], [126, 7],
                      [254, 8], [510, 9], [1022, 10], [1023, 10]])

# ── DCT coefficients ────────────────────────────────────────────────────
# Tables B.14 / B.15: the 111 run / level codes, then escape (111) and end of
# block (112)
B14 = np.array([
    [0x3, 2], [0x4, 4], [0x5, 5], [0x6, 7], [0x26, 8], [0x21, 8], [0xa, 10], [0x1d, 12],
    [0x18, 12], [0x13, 12], [0x10, 12], [0x1a, 13], [0x19, 13], [0x18, 13], [0x17, 13], [0x1f, 14],
    [0x1e, 14], [0x1d, 14], [0x1c, 14], [0x1b, 14], [0x1a, 14], [0x19, 14], [0x18, 14], [0x17, 14],
    [0x16, 14], [0x15, 14], [0x14, 14], [0x13, 14], [0x12, 14], [0x11, 14], [0x10, 14], [0x18, 15],
    [0x17, 15], [0x16, 15], [0x15, 15], [0x14, 15], [0x13, 15], [0x12, 15], [0x11, 15], [0x10, 15],
    [0x3, 3], [0x6, 6], [0x25, 8], [0xc, 10], [0x1b, 12], [0x16, 13], [0x15, 13], [0x1f, 15],
    [0x1e, 15], [0x1d, 15], [0x1c, 15], [0x1b, 15], [0x1a, 15], [0x19, 15], [0x13, 16], [0x12, 16],
    [0x11, 16], [0x10, 16], [0x5, 4], [0x4, 7], [0xb, 10], [0x14, 12], [0x14, 13], [0x7, 5],
    [0x24, 8], [0x1c, 12], [0x13, 13], [0x6, 5], [0xf, 10], [0x12, 12], [0x7, 6], [0x9, 10],
    [0x12, 13], [0x5, 6], [0x1e, 12], [0x14, 16], [0x4, 6], [0x15, 12], [0x7, 7], [0x11, 12],
    [0x5, 7], [0x11, 13], [0x27, 8], [0x10, 13], [0x23, 8], [0x1a, 16], [0x22, 8], [0x19, 16],
    [0x20, 8], [0x18, 16], [0xe, 10], [0x17, 16], [0xd, 10], [0x16, 16], [0x8, 10], [0x15, 16],
    [0x1f, 12], [0x1a, 12], [0x19, 12], [0x17, 12], [0x16, 12], [0x1f, 13], [0x1e, 13], [0x1d, 13],
    [0x1c, 13], [0x1b, 13], [0x1f, 16], [0x1e, 16], [0x1d, 16], [0x1c, 16], [0x1b, 16], [0x1, 6],
    [0x2, 2],
])
B15 = np.array([
    [0x2, 2], [0x6, 3], [0x7, 4], [0x1c, 5], [0x1d, 5], [0x5, 6], [0x4, 6], [0x7b, 7],
    [0x7c, 7], [0x23, 8], [0x22, 8], [0xfa, 8], [0xfb, 8], [0xfe, 8], [0xff, 8], [0x1f, 14],
    [0x1e, 14], [0x1d, 14], [0x1c, 14], [0x1b, 14], [0x1a, 14], [0x19, 14], [0x18, 14], [0x17, 14],
    [0x16, 14], [0x15, 14], [0x14, 14], [0x13, 14], [0x12, 14], [0x11, 14], [0x10, 14], [0x18, 15],
    [0x17, 15], [0x16, 15], [0x15, 15], [0x14, 15], [0x13, 15], [0x12, 15], [0x11, 15], [0x10, 15],
    [0x2, 3], [0x6, 5], [0x79, 7], [0x27, 8], [0x20, 8], [0x16, 13], [0x15, 13], [0x1f, 15],
    [0x1e, 15], [0x1d, 15], [0x1c, 15], [0x1b, 15], [0x1a, 15], [0x19, 15], [0x13, 16], [0x12, 16],
    [0x11, 16], [0x10, 16], [0x5, 5], [0x7, 7], [0xfc, 8], [0xc, 10], [0x14, 13], [0x7, 5],
    [0x26, 8], [0x1c, 12], [0x13, 13], [0x6, 6], [0xfd, 8], [0x12, 12], [0x7, 6], [0x4, 9],
    [0x12, 13], [0x6, 7], [0x1e, 12], [0x14, 16], [0x4, 7], [0x15, 12], [0x5, 7], [0x11, 12],
    [0x78, 7], [0x11, 13], [0x7a, 7], [0x10, 13], [0x21, 8], [0x1a, 16], [0x25, 8], [0x19, 16],
    [0x24, 8], [0x18, 16], [0x5, 9], [0x17, 16], [0x7, 9], [0x16, 16], [0xd, 10], [0x15, 16],
    [0x1f, 12], [0x1a, 12], [0x19, 12], [0x17, 12], [0x16, 12], [0x1f, 13], [0x1e, 13], [0x1d, 13],
    [0x1c, 13], [0x1b, 13], [0x1f, 16], [0x1e, 16], [0x1d, 16], [0x1c, 16], [0x1b, 16], [0x1, 6],
    [0x6, 4],
])
RUN = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3,
    3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 8, 8,
    9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
])
LEVEL = np.array([
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 1, 2, 3, 4, 5, 6, 7, 8,
    9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 1, 2, 3, 4, 5, 1,
    2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
])
COEF_ESCAPE, COEF_EOB = 111, 112

# ── scans and quantisation ──────────────────────────────────────────────
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
ALTERNATE = np.array([
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63])
DEFAULT_INTRA_MATRIX = np.array([
    8, 16, 19, 22, 26, 27, 29, 34, 16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38, 22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48, 26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69, 27, 29, 35, 38, 46, 56, 69, 83])
NON_LINEAR_QSCALE = np.array([
    0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 18, 20, 22,
    24, 28, 32, 36, 40, 44, 48, 52, 56, 64, 72, 80, 88, 96, 104, 112])

# Table 6-4, and FFmpeg's codes 9-13; (0, 0) where FFmpeg has no rate
FRAME_RATE = ((0, 0), (24000, 1001), (24, 1), (25, 1), (30000, 1001), (30, 1), (50, 1),
              (60000, 1001), (60, 1), (15, 1), (5, 1), (10, 1), (12, 1), (15, 1), (0, 0),
              (0, 0))


def _c_array(ctype: str, name: str, values) -> str:
    flat = np.asarray(values).ravel()
    body = ", ".join(str(int(v)) for v in flat)
    return f"static const {ctype} {name}[{flat.size}] = {{{body}}};\n"


def cpp_header() -> str:
    """The tables the decoder reads as C++ arrays (flat initialisers,
    row-major), the header it includes as `mpeg2_tables.h`."""
    parts = ["// Generated from omfs4d_torch/io/mpeg2_tables.py by cpp_header(); not edited.\n",
             "#pragma once\n#include <cstdint>\n"]
    for ctype, name, values in (
            ("uint16_t", "MB_INCREMENT", MB_INCREMENT), ("uint16_t", "MB_TYPE_P", MB_TYPE_P),
            ("uint8_t", "MB_FLAGS_P", MB_FLAGS_P), ("uint16_t", "MB_TYPE_B", MB_TYPE_B),
            ("uint8_t", "MB_FLAGS_B", MB_FLAGS_B), ("uint16_t", "CBP", CBP),
            ("uint16_t", "MOTION", MOTION), ("uint16_t", "DC_LUMA", DC_LUMA),
            ("uint16_t", "DC_CHROMA", DC_CHROMA), ("uint16_t", "B14", B14),
            ("uint16_t", "B15", B15), ("uint8_t", "RUN", RUN), ("uint8_t", "LEVEL", LEVEL),
            ("uint8_t", "ZIGZAG", ZIGZAG), ("uint8_t", "ALTERNATE", ALTERNATE),
            ("uint8_t", "DEFAULT_INTRA_MATRIX", DEFAULT_INTRA_MATRIX),
            ("uint8_t", "NON_LINEAR_QSCALE", NON_LINEAR_QSCALE)):
        parts.append(_c_array(ctype, name, values))
    return "\n".join(parts)
