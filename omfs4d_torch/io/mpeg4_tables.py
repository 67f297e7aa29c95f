"""The tables of MPEG-4 Part 2 (ISO/IEC 14496-2) Simple and Advanced Simple
profile that the port's host decoder (`omfs4d_torch/io/mpeg4dec.cpp`) and the test writer
read, in one place.

The C++ decoder gets them as a generated header (`cpp_header`), written
beside the library when it is built, so no table is typed twice.  Codes are
given as (code, length) pairs, the code's bits the low `length` bits of
`code`, most significant first.

- Macroblock headers: mcbpc of I-VOPs (Table B-6) and of P-VOPs (Table
  B-7), cbpy (Table B-8, the intra pattern; an inter MB's is its
  complement), dquant (Table 6-30).
- Motion: motion_code (Table B-12) by |code|, the sign bit following a
  non-zero code.
- Intra DC: dct_dc_size of luminance (Table B-13) and chrominance (Table
  B-14); the DC scaler by QP (Table 7-1); intra_dc_vlc_thr's QP
  thresholds (Table 6-21).
- TCOEF: the intra (Table B-16) and inter (Table B-17) run / level codes,
  each with its (last, run, level) and the escape code at the end; the
  LMAX / RMAX of escape modes 1 and 2 (Tables B-19 to B-22) are derived from
  them (`max_level`, `max_run`).
- Scans (Figure 7-3): zigzag, alternate horizontal, alternate vertical.
- 4MV chroma rounding (Table 7-9): sixteenths of the summed vector.
- Advanced Simple: the B-VOP mb_type (Table B-4; direct, interpolate,
  backward, forward) and dbquant (Table 6-33) codes, and the default
  intra and non-intra matrices of MPEG quantisation (6.3.3), raster order.
"""

from __future__ import annotations

import numpy as np

# ── macroblock headers ──────────────────────────────────────────────────
# Table B-6, I-VOP mcbpc: index = 4 * (mb_type == intra+Q) + cbpc; 8 = stuffing
MCBPC_I = np.array([[1, 1], [1, 3], [2, 3], [3, 3], [1, 4], [1, 6], [2, 6], [3, 6],
                    [1, 9]])
# Table B-7, P-VOP mcbpc: index = 4 * kind + cbpc, kind 0 inter, 1 intra,
# 2 inter+Q, 3 intra+Q, 4 inter4V; 20 = stuffing
MCBPC_P = np.array([[1, 1], [3, 4], [2, 4], [5, 6], [3, 5], [4, 8], [3, 8], [3, 7],
                    [3, 3], [7, 7], [6, 7], [5, 9], [4, 6], [4, 9], [3, 9], [2, 9],
                    [2, 3], [5, 7], [4, 7], [5, 8], [1, 9]])
# Table B-8, cbpy by the intra pattern (bit 3 = block 0)
CBPY = np.array([[3, 4], [5, 5], [4, 5], [9, 4], [3, 5], [7, 4], [2, 6], [11, 4],
                 [2, 5], [3, 6], [5, 4], [10, 4], [4, 4], [8, 4], [6, 4], [3, 2]])
# Table 6-30, dquant: the change of QP by its 2-bit code
DQUANT = np.array([-1, -2, 1, 2])

# ── motion vectors ──────────────────────────────────────────────────────
# Table B-12, motion_code by |motion_code| 0..32
MV = np.array([[1, 1], [1, 2], [1, 3], [1, 4], [3, 6], [5, 7], [4, 7], [3, 7],
               [11, 9], [10, 9], [9, 9], [17, 10], [16, 10], [15, 10], [14, 10], [13, 10],
               [12, 10], [11, 10], [10, 10], [9, 10], [8, 10], [7, 10], [6, 10], [5, 10],
               [4, 10], [7, 11], [6, 11], [5, 11], [4, 11], [3, 11], [2, 11], [3, 12],
               [2, 12]])

# ── intra DC ────────────────────────────────────────────────────────────
# Tables B-13, B-14: dct_dc_size 0..12 of luminance and of chrominance
DC_LUM = np.array([[3, 3], [3, 2], [2, 2], [2, 3], [1, 3], [1, 4], [1, 5], [1, 6],
                   [1, 7], [1, 8], [1, 9], [1, 10], [1, 11]])
DC_CHROM = np.array([[3, 2], [2, 2], [1, 2], [1, 3], [1, 4], [1, 5], [1, 6], [1, 7],
                     [1, 8], [1, 9], [1, 10], [1, 11], [1, 12]])
# Table 6-21: the DC is coded with the AC's codes when QP >= this
# (intra_dc_vlc_thr 0 never, 7 always)
DC_THRESHOLD = np.array([99, 13, 15, 17, 19, 21, 23, 0])


def dc_scaler(qp: int, chroma: bool) -> int:
    """Table 7-1: the DC scaler of a luminance or chrominance block at QP."""
    if qp <= 4:
        return 8
    if chroma:
        return (qp + 13) // 2 if qp <= 24 else qp - 6
    return 2 * qp if qp <= 8 else (qp + 8 if qp <= 24 else 2 * qp - 16)


DC_SCALER = np.array([[dc_scaler(q, c) for c in (False, True)] for q in range(32)])

# ── TCOEF ───────────────────────────────────────────────────────────────
# Table B-16 (intra) and B-17 (inter): (code, length) of each run / level
# entry with last = 0 first, the escape code last
INTRA_CODES = np.array([
    [0x2, 2], [0x6, 3], [0xf, 4], [0xd, 5], [0xc, 5], [0x15, 6], [0x13, 6], [0x12, 6],
    [0x17, 7], [0x1f, 8], [0x1e, 8], [0x1d, 8], [0x25, 9], [0x24, 9], [0x23, 9], [0x21, 9],
    [0x21, 10], [0x20, 10], [0xf, 10], [0xe, 10], [0x7, 11], [0x6, 11], [0x20, 11],
    [0x21, 11], [0x50, 12], [0x51, 12], [0x52, 12], [0xe, 4], [0x14, 6], [0x16, 7],
    [0x1c, 8], [0x20, 9], [0x1f, 9], [0xd, 10], [0x22, 11], [0x53, 12], [0x55, 12],
    [0xb, 5], [0x15, 7], [0x1e, 9], [0xc, 10], [0x56, 12], [0x11, 6], [0x1b, 8], [0x1d, 9],
    [0xb, 10], [0x10, 6], [0x22, 9], [0xa, 10], [0xd, 6], [0x1c, 9], [0x8, 10], [0x12, 7],
    [0x1b, 9], [0x54, 12], [0x14, 7], [0x1a, 9], [0x57, 12], [0x19, 8], [0x9, 10],
    [0x18, 8], [0x23, 11], [0x17, 8], [0x19, 9], [0x18, 9], [0x7, 10], [0x58, 12],
    [0x7, 4], [0xc, 6], [0x16, 8], [0x17, 9], [0x6, 10], [0x5, 11], [0x4, 11], [0x59, 12],
    [0xf, 6], [0x16, 9], [0x5, 10], [0xe, 6], [0x4, 10], [0x11, 7], [0x24, 11], [0x10, 7],
    [0x25, 11], [0x13, 7], [0x5a, 12], [0x15, 8], [0x5b, 12], [0x14, 8], [0x13, 8],
    [0x1a, 8], [0x15, 9], [0x14, 9], [0x13, 9], [0x12, 9], [0x11, 9], [0x26, 11],
    [0x27, 11], [0x5c, 12], [0x5d, 12], [0x5e, 12], [0x5f, 12], [0x3, 7]])
INTRA_LEVEL = np.array(
    list(range(1, 28)) + list(range(1, 11)) + list(range(1, 6)) + [1, 2, 3, 4]
    + [1, 2, 3] * 4 + [1, 2] * 2 + [1] * 5
    + list(range(1, 9)) + [1, 2, 3] + [1, 2] * 5 + [1] * 14)
INTRA_RUN = np.array(
    [0] * 27 + [1] * 10 + [2] * 5 + [3] * 4 + [4] * 3 + [5] * 3 + [6] * 3 + [7] * 3
    + [8] * 2 + [9] * 2 + [10, 11, 12, 13, 14]
    + [0] * 8 + [1] * 3 + [2, 2, 3, 3, 4, 4, 5, 5, 6, 6] + list(range(7, 21)))
INTRA_LAST0 = 67            # entries with last = 0

INTER_CODES = np.array([
    [0x2, 2], [0xf, 4], [0x15, 6], [0x17, 7], [0x1f, 8], [0x25, 9], [0x24, 9], [0x21, 10],
    [0x20, 10], [0x7, 11], [0x6, 11], [0x20, 11], [0x6, 3], [0x14, 6], [0x1e, 8],
    [0xf, 10], [0x21, 11], [0x50, 12], [0xe, 4], [0x1d, 8], [0xe, 10], [0x51, 12],
    [0xd, 5], [0x23, 9], [0xd, 10], [0xc, 5], [0x22, 9], [0x52, 12], [0xb, 5], [0xc, 10],
    [0x53, 12], [0x13, 6], [0xb, 10], [0x54, 12], [0x12, 6], [0xa, 10], [0x11, 6],
    [0x9, 10], [0x10, 6], [0x8, 10], [0x16, 7], [0x55, 12], [0x15, 7], [0x14, 7],
    [0x1c, 8], [0x1b, 8], [0x21, 9], [0x20, 9], [0x1f, 9], [0x1e, 9], [0x1d, 9], [0x1c, 9],
    [0x1b, 9], [0x1a, 9], [0x22, 11], [0x23, 11], [0x56, 12], [0x57, 12], [0x7, 4],
    [0x19, 9], [0x5, 11], [0xf, 6], [0x4, 11], [0xe, 6], [0xd, 6], [0xc, 6], [0x13, 7],
    [0x12, 7], [0x11, 7], [0x10, 7], [0x1a, 8], [0x19, 8], [0x18, 8], [0x17, 8], [0x16, 8],
    [0x15, 8], [0x14, 8], [0x13, 8], [0x18, 9], [0x17, 9], [0x16, 9], [0x15, 9], [0x14, 9],
    [0x13, 9], [0x12, 9], [0x11, 9], [0x7, 10], [0x6, 10], [0x5, 10], [0x4, 10],
    [0x24, 11], [0x25, 11], [0x26, 11], [0x27, 11], [0x58, 12], [0x59, 12], [0x5a, 12],
    [0x5b, 12], [0x5c, 12], [0x5d, 12], [0x5e, 12], [0x5f, 12], [0x3, 7]])
INTER_LEVEL = np.array(
    list(range(1, 13)) + list(range(1, 7)) + [1, 2, 3, 4] + [1, 2, 3] * 4 + [1, 2] * 4
    + [1] * 16 + [1, 2, 3, 1, 2] + [1] * 39)
INTER_RUN = np.array(
    [0] * 12 + [1] * 6 + [2] * 4 + [3] * 3 + [4] * 3 + [5] * 3 + [6] * 3 + [7] * 2 + [8] * 2
    + [9] * 2 + [10] * 2 + list(range(11, 27)) + [0, 0, 0, 1, 1] + list(range(2, 41)))
INTER_LAST0 = 58
ESCAPE = 102                # the index of the escape code in both tables


def max_level(levels: np.ndarray, runs: np.ndarray, last0: int) -> np.ndarray:
    """LMAX (Tables B-19, B-20): [last][run] -> the largest level the table
    codes for that run (0 where it codes none)."""
    out = np.zeros((2, 64), np.int64)
    for k in range(len(levels)):
        last = int(k >= last0)
        out[last, runs[k]] = max(out[last, runs[k]], levels[k])
    return out


def max_run(levels: np.ndarray, runs: np.ndarray, last0: int) -> np.ndarray:
    """RMAX (Tables B-21, B-22): [last][level] -> the largest run the table
    codes for that level (-1 where it codes none)."""
    out = np.full((2, 64), -1, np.int64)
    for k in range(len(levels)):
        last = int(k >= last0)
        out[last, levels[k]] = max(out[last, levels[k]], runs[k])
    return out


INTRA_MAX_LEVEL = max_level(INTRA_LEVEL, INTRA_RUN, INTRA_LAST0)
INTRA_MAX_RUN = max_run(INTRA_LEVEL, INTRA_RUN, INTRA_LAST0)
INTER_MAX_LEVEL = max_level(INTER_LEVEL, INTER_RUN, INTER_LAST0)
INTER_MAX_RUN = max_run(INTER_LEVEL, INTER_RUN, INTER_LAST0)

# ── scans (Figure 7-3) ──────────────────────────────────────────────────
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
ALT_HORIZONTAL = np.array([
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63])
ALT_VERTICAL = np.array([
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63])

# Table 7-9: the chroma vector's half-samples added for each sixteenth of
# the four luminance vectors' sum
CHROMA_ROUND = np.array([0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2])


# ── Advanced Simple ─────────────────────────────────────────────────────
# Table B-4, B-VOP mb_type: direct, interpolate, backward, forward
MB_TYPE_B = np.array([[1, 1], [1, 2], [1, 3], [1, 4]])
# Table 6-33, dbquant: 0 -> 0, 10 -> -2, 11 -> +2
DBQUANT = np.array([[0, 1], [2, 2], [3, 2]])
# 6.3.3: the default matrices of quant_type 1, raster order
DEFAULT_INTRA_MATRIX = np.array([
    8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45])
DEFAULT_INTER_MATRIX = np.array([
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33])


def _c_array(ctype: str, name: str, values) -> str:
    flat = np.asarray(values).ravel()
    body = ", ".join(str(int(v)) for v in flat)
    return f"static const {ctype} {name}[{flat.size}] = {{{body}}};\n"


def cpp_header() -> str:
    """Every table above as C++ arrays (flat initialisers, row-major), the
    header the host decoder includes as `mpeg4_tables.h`."""
    parts = ["// Generated from omfs4d_torch/io/mpeg4_tables.py by cpp_header(); not edited.\n",
             "#pragma once\n#include <cstdint>\n"]
    for ctype, name, values in (
            ("uint16_t", "MCBPC_I", MCBPC_I), ("uint16_t", "MCBPC_P", MCBPC_P),
            ("uint16_t", "CBPY", CBPY), ("int8_t", "DQUANT", DQUANT), ("uint16_t", "MV", MV),
            ("uint16_t", "DC_LUM", DC_LUM), ("uint16_t", "DC_CHROM", DC_CHROM),
            ("uint8_t", "DC_THRESHOLD", DC_THRESHOLD), ("uint8_t", "DC_SCALER", DC_SCALER),
            ("uint16_t", "INTRA_CODES", INTRA_CODES), ("uint8_t", "INTRA_LEVEL", INTRA_LEVEL),
            ("uint8_t", "INTRA_RUN", INTRA_RUN), ("uint16_t", "INTER_CODES", INTER_CODES),
            ("uint8_t", "INTER_LEVEL", INTER_LEVEL), ("uint8_t", "INTER_RUN", INTER_RUN),
            ("int8_t", "INTRA_MAX_LEVEL", INTRA_MAX_LEVEL),
            ("int8_t", "INTRA_MAX_RUN", INTRA_MAX_RUN),
            ("int8_t", "INTER_MAX_LEVEL", INTER_MAX_LEVEL),
            ("int8_t", "INTER_MAX_RUN", INTER_MAX_RUN),
            ("uint8_t", "ZIGZAG", ZIGZAG), ("uint8_t", "ALT_HORIZONTAL", ALT_HORIZONTAL),
            ("uint8_t", "ALT_VERTICAL", ALT_VERTICAL), ("uint8_t", "CHROMA_ROUND", CHROMA_ROUND),
            ("uint16_t", "MB_TYPE_B", MB_TYPE_B), ("uint16_t", "DBQUANT", DBQUANT),
            ("uint8_t", "DEFAULT_INTRA_MATRIX", DEFAULT_INTRA_MATRIX),
            ("uint8_t", "DEFAULT_INTER_MATRIX", DEFAULT_INTER_MATRIX)):
        parts.append(_c_array(ctype, name, values))
    parts.append(f"static const int INTRA_LAST0 = {INTRA_LAST0};\n"
                 f"static const int INTER_LAST0 = {INTER_LAST0};\n"
                 f"static const int ESCAPE = {ESCAPE};\n")
    return "\n".join(parts)
