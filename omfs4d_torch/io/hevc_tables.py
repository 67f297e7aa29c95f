"""The tables of HEVC (ITU-T H.265 | ISO/IEC 23008-2) that the port's host
decoder (`omfs4d_torch/io/hevcdec.cpp`) reads, in one place.

The C++ gets them as a generated header (`cpp_header`), written beside the
library when it is built, so no table is typed twice; the tests' random
stream writer indexes the same arrays.

- CABAC (9.3): the initValue of every context for initType 0, 1 and 2
  (Tables 9-5 to 9-37), in FFmpeg's order of syntax elements (`CTX_*` give
  each element's first context); rangeTabLps and transIdxLps are H.264's
  (Tables 9-46, 9-47), taken from `h264_tables`.
- Intra prediction (8.4.4.2.6): intraPredAngle and invAngle by mode.
- Transforms (8.6.4.2): the 32 x 32 DCT matrix (the smaller ones are its
  rows 0, 32 / N, ...) and the 4 x 4 DST; levelScale (8.6.3).
- QP: QpC by qPi for ChromaArrayType 1 (Table 8-10).
- Deblocking (8.7.2.5): beta' and tC' by Q (Table 8-12).
- Inter prediction (8.5.3.3.3): the luma 8-tap and chroma 4-tap filters.
- Scaling lists (7.4.5): the default 8 x 8 intra and inter lists in
  up-right diagonal order, kept for the scaling-list decoding still to come.
- Scans (6.5.3-6.5.5): up-right diagonal, horizontal and vertical scans of
  2 x 2, 4 x 4 and 8 x 8 blocks as (x, y).
"""

from __future__ import annotations

import numpy as np

from omfs4d_torch.io import h264_tables

# ── CABAC ───────────────────────────────────────────────────────────────
# (name, contexts) in FFmpeg's order; the range extension's elements
# (explicit_rdpcm, log2_res_scale_abs, ...) keep their places, unread here
CTX_ELEMENTS = (
    ("SAO_MERGE", 1), ("SAO_TYPE", 1), ("SPLIT_CU", 3), ("TRANSQUANT_BYPASS", 1),
    ("SKIP", 3), ("CU_QP_DELTA", 3), ("PRED_MODE", 1), ("PART_MODE", 4),
    ("PREV_INTRA_LUMA", 1), ("CHROMA_PRED", 2), ("MERGE_FLAG", 1), ("MERGE_IDX", 1),
    ("INTER_PRED_IDC", 5), ("REF_IDX_L0", 2), ("REF_IDX_L1", 2), ("MVD_GREATER0", 2),
    ("MVD_GREATER1", 2), ("MVP_FLAG", 1), ("RQT_ROOT_CBF", 1), ("SPLIT_TRANSFORM", 3),
    ("CBF_LUMA", 2), ("CBF_CHROMA", 5), ("TRANSFORM_SKIP", 2), ("EXPLICIT_RDPCM", 2),
    ("EXPLICIT_RDPCM_DIR", 2), ("LAST_X_PREFIX", 18), ("LAST_Y_PREFIX", 18),
    ("CODED_SUB_BLOCK", 4), ("SIG_COEFF", 44), ("GREATER1", 24), ("GREATER2", 6),
    ("LOG2_RES_SCALE_ABS", 8), ("RES_SCALE_SIGN", 2), ("CU_CHROMA_QP_OFFSET_FLAG", 1),
    ("CU_CHROMA_QP_OFFSET_IDX", 1),
)
CTX = {}
_n = 0
for _name, _count in CTX_ELEMENTS:
    CTX[_name] = _n
    _n += _count
N_CTX = _n                                     # 179

# initValue by initType (0: I; 1: P, or B with cabac_init_flag; 2: B, or P
# with cabac_init_flag), FFmpeg's ordering of the contexts
CABAC_INIT = np.array([
    [153, 200, 139, 141, 157, 154, 154, 154, 154, 154, 154, 154, 154, 184, 154, 154, 154, 184,
     63, 139, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154,
     154, 153, 138, 138, 111, 141, 94, 138, 182, 154, 154, 139, 139, 139, 139, 139, 139, 110,
     110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63, 110,
     110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63, 91,
     171, 134, 141, 111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125,
     107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140, 139, 182, 182, 152, 136,
     152, 136, 153, 136, 139, 111, 136, 139, 111, 141, 111, 140, 92, 137, 138, 140, 152, 138,
     139, 153, 74, 149, 92, 139, 107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197, 138,
     153, 136, 167, 152, 152, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154],
    [153, 185, 107, 139, 126, 154, 197, 185, 201, 154, 154, 154, 149, 154, 139, 154, 154, 154,
     152, 139, 110, 122, 95, 79, 63, 31, 31, 153, 153, 153, 153, 140, 198, 140, 198, 168, 79,
     124, 138, 94, 153, 111, 149, 107, 167, 154, 154, 139, 139, 139, 139, 139, 139, 125, 110,
     94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108, 125, 110, 94,
     110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108, 121, 140, 61, 154,
     155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154, 166, 183, 140,
     136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 123, 123, 107, 121, 107, 121, 167,
     151, 183, 140, 151, 183, 140, 140, 140, 154, 196, 196, 167, 154, 152, 167, 182, 182, 134,
     149, 136, 153, 121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182, 107, 167, 91, 122,
     107, 167, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154],
    [153, 160, 107, 139, 126, 154, 197, 185, 201, 154, 154, 154, 134, 154, 139, 154, 154, 183,
     152, 139, 154, 137, 95, 79, 63, 31, 31, 153, 153, 153, 153, 169, 198, 169, 198, 168, 79,
     224, 167, 122, 153, 111, 149, 92, 167, 154, 154, 139, 139, 139, 139, 139, 139, 125, 110,
     124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93, 125, 110, 124,
     110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93, 121, 140, 61, 154,
     170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154, 166, 183, 140,
     136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 138, 138, 122, 121, 122, 121, 167,
     151, 183, 140, 151, 183, 140, 140, 140, 154, 196, 167, 167, 154, 152, 167, 182, 182, 134,
     149, 136, 153, 121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182, 107, 167, 91, 107,
     107, 167, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154],
], np.uint8)
assert CABAC_INIT.shape == (3, N_CTX)

RANGE_TAB_LPS = h264_tables.RANGE_TAB_LPS
TRANS_IDX_LPS = h264_tables.TRANS_IDX_LPS

# sig_coeff_flag of a 4 x 4 block by position (yC << 2) + xC (9.3.4.2.5)
CTX_IDX_MAP = np.array([0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8], np.uint8)

# ── intra prediction ────────────────────────────────────────────────────
# intraPredAngle for modes 0..34 (0 where the mode is not angular)
INTRA_ANGLE = np.array([0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
                        -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32],
                       np.int16)
# invAngle = round(8192 / intraPredAngle) for the negative angles, modes 11..25
INV_ANGLE = np.array([0] * 11 + [-4096, -1638, -910, -630, -482, -390, -315, -256, -315, -390,
                                 -482, -630, -910, -1638, -4096] + [0] * 9, np.int16)

# ── transforms ──────────────────────────────────────────────────────────
# the coefficient of cos(m pi / 64) for m = 0..31 (m = 0: the DC row's 64)
_COS = [64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67, 64, 61, 57, 54, 50, 46,
        43, 38, 36, 31, 25, 22, 18, 13, 9, 4]


def _dct32() -> np.ndarray:
    m = np.zeros((32, 32), np.int16)
    for k in range(32):
        for n in range(32):
            if k == 0:
                m[k, n] = 64
                continue
            phase = (2 * n + 1) * k % 128
            if phase < 32:
                m[k, n] = _COS[phase]
            elif phase < 64:
                m[k, n] = -_COS[64 - phase]
            elif phase < 96:
                m[k, n] = -_COS[phase - 64]
            else:
                m[k, n] = _COS[128 - phase]
    return m


DCT = _dct32()
DST = np.array([[29, 55, 74, 84], [74, 74, 0, -74], [84, -29, -74, 55], [55, -84, 74, -29]],
               np.int16)
LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], np.uint8)

# ── QP, deblocking ──────────────────────────────────────────────────────
# QpC by qPi 0..57 for ChromaArrayType 1 (Table 8-10)
QPC = np.array(list(range(30)) + [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]
               + [q - 6 for q in range(44, 58)], np.uint8)
BETA = np.array([0] * 16 + list(range(6, 19)) + list(range(20, 65, 2)), np.uint8)
TC = np.array([0] * 18 + [1] * 9 + [2] * 4 + [3] * 4 + [4] * 3 + [5, 5, 6, 6, 7, 8, 9, 10, 11,
                                                                  13, 14, 16, 18, 20, 22, 24],
              np.uint8)

# ── inter prediction ────────────────────────────────────────────────────
LUMA_FILTER = np.array([[0, 0, 0, 64, 0, 0, 0, 0], [-1, 4, -10, 58, 17, -5, 1, 0],
                        [-1, 4, -11, 40, 40, -11, 4, -1], [0, 1, -5, 17, 58, -10, 4, -1]],
                       np.int8)
CHROMA_FILTER = np.array([[0, 64, 0, 0], [-2, 58, 10, -2], [-4, 54, 16, -2], [-6, 46, 28, -4],
                          [-4, 36, 36, -4], [-4, 28, 46, -6], [-2, 16, 54, -4],
                          [-2, 10, 58, -2]], np.int8)

# ── scaling lists (Table 7-6, up-right diagonal order) ──────────────────
DEFAULT_INTRA_8X8 = np.array([
    16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 16, 17, 16, 17, 18, 17, 18, 18, 17, 18, 21, 19,
    20, 21, 20, 19, 21, 24, 22, 22, 24, 24, 22, 22, 24, 25, 25, 27, 30, 27, 25, 25, 29, 31, 35,
    35, 31, 29, 36, 41, 44, 41, 36, 47, 54, 54, 47, 65, 70, 65, 88, 88, 115], np.uint8)
DEFAULT_INTER_8X8 = np.array([
    16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 17, 17, 17, 17, 18, 18, 18, 18, 18, 18, 20, 20,
    20, 20, 20, 20, 20, 24, 24, 24, 24, 24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 28, 28, 28,
    28, 28, 28, 33, 33, 33, 33, 33, 41, 41, 41, 41, 54, 54, 54, 71, 71, 91], np.uint8)


# ── scans ───────────────────────────────────────────────────────────────

def _diagonal(n: int) -> list[tuple[int, int]]:
    out, x, y = [], 0, 0
    while len(out) < n * n:
        while y >= 0:
            if x < n and y < n:
                out.append((x, y))
            y -= 1
            x += 1
        y, x = x, 0
    return out


def _scans(n: int) -> np.ndarray:
    diag = _diagonal(n)
    hor = [(x, y) for y in range(n) for x in range(n)]
    ver = [(x, y) for x in range(n) for y in range(n)]
    return np.array([diag, hor, ver], np.uint8)


# SCAN_<n>[scanIdx][sPos] = (x, y): scanIdx 0 up-right diagonal, 1 horizontal,
# 2 vertical
SCAN_2 = _scans(2)
SCAN_4 = _scans(4)
SCAN_8 = _scans(8)


def _c_array(ctype: str, name: str, values: np.ndarray) -> str:
    a = np.asarray(values)
    dims = "".join(f"[{d}]" for d in a.shape)
    flat = a.reshape(-1).tolist()
    rows = [", ".join(str(v) for v in flat[i:i + 24]) for i in range(0, len(flat), 24)]
    return f"static const {ctype} {name}{dims} = {{\n  " + ",\n  ".join(rows) + "};\n"


def cpp_header() -> str:
    """Every table above as C++ arrays (flat initialisers, row-major) and
    each syntax element's first context as an enum, the header the host
    decoder includes as `hevc_tables.h`."""
    parts = ["// Generated from omfs4d_torch/io/hevc_tables.py by cpp_header(); not edited.\n",
             "#pragma once\n#include <cstdint>\n",
             "enum Ctx {\n" + "".join(f"  C_{k} = {v},\n" for k, v in CTX.items())
             + f"  N_CTX = {N_CTX}\n}};\n"]
    for ctype, name, values in (
            ("uint8_t", "CABAC_INIT", CABAC_INIT), ("uint8_t", "RANGE_TAB_LPS", RANGE_TAB_LPS),
            ("uint8_t", "TRANS_IDX_LPS", TRANS_IDX_LPS), ("uint8_t", "CTX_IDX_MAP", CTX_IDX_MAP),
            ("int16_t", "INTRA_ANGLE", INTRA_ANGLE), ("int16_t", "INV_ANGLE", INV_ANGLE),
            ("int16_t", "DCT", DCT), ("int16_t", "DST", DST),
            ("uint8_t", "LEVEL_SCALE", LEVEL_SCALE), ("uint8_t", "QPC", QPC),
            ("uint8_t", "BETA", BETA), ("uint8_t", "TC", TC),
            ("int8_t", "LUMA_FILTER", LUMA_FILTER), ("int8_t", "CHROMA_FILTER", CHROMA_FILTER),
            ("uint8_t", "DEFAULT_INTRA_8X8", DEFAULT_INTRA_8X8),
            ("uint8_t", "DEFAULT_INTER_8X8", DEFAULT_INTER_8X8),
            ("uint8_t", "SCAN_2", SCAN_2), ("uint8_t", "SCAN_4", SCAN_4),
            ("uint8_t", "SCAN_8", SCAN_8)):
        parts.append(_c_array(ctype, name, values))
    return "\n".join(parts)
