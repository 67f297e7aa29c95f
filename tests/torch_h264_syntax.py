"""A random legal-syntax H.264 writer, for holding the port's host decoder to
an independent one (cv2's FFmpeg) with no H.264 encoder at hand.

`write_stream(seed, **features)` draws every syntax element of Main and High
profile I, P and B pictures at random, within what the standard allows and
what the neighbours make available, and returns the NAL units of each
access unit.  It needs no reconstruction and no rate control:

- macroblocks: I_NxN (4x4 and 8x8, every mode its neighbours allow, coded
  through the predicted mode), Intra_16x16 and chroma in every allowed mode,
  I_PCM, P_L0_16x16 / 16x8 / 8x16, P_8x8 and P_8x8ref0 with every
  sub-partition, P_Skip, every B mb_type (B_Direct_16x16, the 16x16, 16x8
  and 8x16 ones over L0, L1 and Bi, B_8x8 with every sub_mb_type), B_Skip,
  intra macroblocks in P and B slices;
- motion: reference indices over each list, vectors drawn as targets (whole,
  half and quarter samples, some pointing outside the picture) and written
  as differences from the predictor of 8.4.1.3 (P_Skip's of 8.4.1.1); the
  direct modes derived as the decoder derives them (8.4.1.2: spatial, and
  temporal from the co-located picture's motion, at 8x8 or 4x4 granularity),
  temporal direct only where the co-located block's reference is in list 0
  and the scaled vectors stay inside MV_LIMIT;
- residual: sparse levels in every block kind (CAVLC's escapes and
  level_prefix > 15 in High profile), kept where 8.5.12.1's scaled values and
  the inverse transforms stay inside 16 bits, as a conforming stream does; a
  coded 8x8 block is never empty (where FFmpeg departs from 8.7.2.1), and a
  luma DC scaling weight is a multiple of 8 (where its SIMD departs from
  8.5.10);
- entropy coding: CAVLC, or CABAC through its own arithmetic encoder
  (9.3.4) with the context selection of 9.3.3.1;
- slices: random splits, slice QP and mb_qp_delta, deblocking idc 0 / 1 / 2
  with offsets, constrained intra prediction, I slices in P and B pictures;
- parameter sets: several SPS / PPS ids, POC types 0-2, cropping, chroma QP
  offsets, transform_8x8_mode_flag, SPS and PPS scaling lists with the
  fall-back rules and the defaults, direct_8x8_inference_flag,
  weighted_bipred_idc, the VUI's max_num_reorder_frames;
- references: up to `refs` frames, list modification of both lists, explicit
  weighted prediction (P and B) and implicit (B), sliding-window and adaptive
  marking (MMCO 1-6), long-term references, non-reference P pictures;
- B pictures: GOPs of up to `bframes` B pictures shown before the anchor
  that follows them (B-pyramid: the middle one a reference), B pictures of
  past references only (output order = decoding order, for POC type 2),
  POC type 1 through delta_pic_order_cnt; every P and B slice of a picture
  has the same lists, and none starts with an I slice.  `Writer.display` is each picture's place in output order
  (`write_mov`'s `display` for `ctts`).

The tables come from `omfs4d_torch.io.h264_tables`, the port's only copy;
cv2's decoder is the check that they and the context rules are right.
"""

from __future__ import annotations

import struct

import numpy as np

from collections import Counter

from omfs4d_torch.io import h264_tables as T

# largest sum of |scaled coefficient| a block may have: with the transforms'
# gain of at most 1.5 a pass, every intermediate stays inside 16 bits
SCALED_SUM_LIMIT = 12000
BLK_RASTER = [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15]
INTRA_CODE = {int(c): k for k, c in enumerate(T.INTRA_CBP)}
INTER_CODE = {int(c): k for k, c in enumerate(T.INTER_CBP)}
INTRA_KINDS = ("I4x4", "I8x8", "I16", "IPCM")
SKIP_KINDS = ("PSKIP", "BSKIP")
# how far outside the picture a vector may point, in samples
MV_OUTSIDE = 24


# ── bits ────────────────────────────────────────────────────────────────

class BitWriter:
    def __init__(self):
        self.buf, self.acc, self.nacc = bytearray(), 0, 0

    def u(self, n: int, v: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nacc += n
        while self.nacc >= 8:
            self.nacc -= 8
            self.buf.append((self.acc >> self.nacc) & 0xFF)
            self.acc &= (1 << self.nacc) - 1

    def ue(self, v: int) -> None:
        n = (v + 1).bit_length()
        self.u(2 * n - 1, v + 1)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align_zero(self) -> None:
        self.u(-self.nacc % 8, 0)

    def trailing(self) -> None:
        self.u(1, 1)
        self.align_zero()

    def data(self) -> bytes:
        assert self.nacc == 0
        return bytes(self.buf)


def nal(ref_idc: int, kind: int, rbsp: bytes) -> bytes:
    out, zeros = bytearray([ref_idc << 5 | kind]), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class Cabac:
    """9.3.4: the arithmetic encoder, with the slice's context states."""

    def __init__(self, bw: BitWriter, slice_i: bool, init_idc: int, qp: int):
        self.bw = bw
        table = T.CABAC_INIT[0 if slice_i else 1 + init_idc]
        pre = np.clip(((table[:, 0] * min(max(qp, 0), 51)) >> 4) + table[:, 1], 1, 126)
        self.state = [int(63 - p) if p <= 63 else int(p - 64) for p in pre]
        self.mps = [0 if p <= 63 else 1 for p in pre]
        self.start()

    def start(self):
        self.low, self.range, self.outstanding, self.first = 0, 510, 0, True

    def put(self, b):
        if self.first:
            self.first = False
        else:
            self.bw.u(1, b)
        while self.outstanding:
            self.bw.u(1, 1 - b)
            self.outstanding -= 1

    def renorm(self):
        while self.range < 256:
            if self.low < 256:
                self.put(0)
            elif self.low >= 512:
                self.low -= 512
                self.put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def bin(self, ctx: int, b: int) -> None:
        s, m = self.state[ctx], self.mps[ctx]
        lps = int(T.RANGE_TAB_LPS[s, (self.range >> 6) & 3])
        self.range -= lps
        if b != m:
            self.low += self.range
            self.range = lps
            if s == 0:
                self.mps[ctx] = 1 - m
            self.state[ctx] = int(T.TRANS_IDX_LPS[s])
        else:
            self.state[ctx] = min(s + 1, 62)
        self.renorm()

    def bypass(self, b: int) -> None:
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self.put(1)
            self.low -= 1024
        elif self.low < 512:
            self.put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, b: int) -> None:
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self.renorm()
            self.put((self.low >> 9) & 1)
            self.bw.u(2, ((self.low >> 7) & 3) | 1)
        else:
            self.renorm()


# ── macroblock state (what the context rules read) ─────────────────────

class MB:
    """ref, refpic (the picture's uid, None for none), direct by list and 8x8;
    mv, mvd by list and raster 4x4 (a list a partition does not use: ref -1,
    vector 0)."""
    __slots__ = ("slice", "kind", "intra", "t8x8", "qp", "qp_delta", "cbp", "chroma_mode",
                 "ipred", "ref", "mv", "mvd", "nz", "nzc", "cbf_dc", "direct", "refpic")

    def __init__(self, slice_id: int, kind: str):
        self.slice, self.kind = slice_id, kind
        self.intra = kind in INTRA_KINDS
        self.t8x8 = False
        self.qp = self.qp_delta = self.cbp = self.chroma_mode = 0
        self.ipred = [2] * 16
        self.ref = [[-1 if self.intra else 0] * 4, [-1] * 4]
        self.mv = [[(0, 0)] * 16, [(0, 0)] * 16]
        self.mvd = [[(0, 0)] * 16, [(0, 0)] * 16]
        self.direct = [False] * 4
        self.refpic = [[None] * 4, [None] * 4]
        self.nz = [16 if kind == "IPCM" else 0] * 16
        self.nzc = [[16 if kind == "IPCM" else 0] * 4 for _ in range(2)]
        self.cbf_dc = [kind == "IPCM"] * 3


def median(a, b, c):
    return max(min(a, b), min(max(a, b), c))


def scaling_tables(sl4, sl8):
    """LevelScale4x4 [list][qp % 6][raster] and LevelScale8x8 from scaling
    lists in zig-zag order."""
    pos4 = np.array([[0 if (x % 2 == 0 and y % 2 == 0) else 1 if (x % 2 and y % 2) else 2
                      for x in range(4)] for y in range(4)]).reshape(16)
    ls4 = np.zeros((6, 6, 16), np.int64)
    for k in range(6):
        w = np.zeros(16, np.int64)
        w[T.ZIGZAG4] = sl4[k]
        ls4[k] = w * T.NORM4[:, pos4]
    cls = np.zeros(64, np.int64)
    for y in range(8):
        for x in range(8):
            if x % 4 == 0 and y % 4 == 0:
                c = 0
            elif x % 2 and y % 2:
                c = 1
            elif x % 4 == 2 and y % 4 == 2:
                c = 2
            elif (x % 4 == 0 and y % 2) or (x % 2 and y % 4 == 0):
                c = 3
            elif (x % 4 == 0 and y % 4 == 2) or (x % 4 == 2 and y % 4 == 0):
                c = 4
            else:
                c = 5
            cls[y * 8 + x] = c
    ls8 = np.zeros((2, 6, 64), np.int64)
    for k in range(2):
        w = np.zeros(64, np.int64)
        w[T.ZIGZAG8] = sl8[k]
        ls8[k] = w * T.NORM8[:, cls]
    return ls4, ls8


def scale(levels, ls, qp: int, eight: bool) -> np.ndarray:
    c = np.asarray(levels, np.int64) * ls
    if eight:
        return c << (qp // 6 - 6) if qp >= 36 else (c + (1 << (5 - qp // 6))) >> (6 - qp // 6)
    return c << (qp // 6 - 4) if qp >= 24 else (c + (1 << (3 - qp // 6))) >> (4 - qp // 6)


H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)


def scaled_sum(levels, positions, ls, qp: int, eight: bool, dc: int = 0) -> int:
    """The sum of |scaled coefficient| of a block whose levels sit at the
    scan's `positions`, its separately scaled DC value `dc` added."""
    c = np.zeros(len(ls), np.int64)
    c[positions] = levels
    return int(np.abs(scale(c, ls, qp, eight)).sum()) + abs(int(dc))


def luma_dc_scaled(levels, ls_dc: int, qp: int) -> np.ndarray:
    """8.5.10: Intra_16x16 DC levels (zig-zag order) -> the 16 blocks' DC
    values, raster order."""
    c = np.zeros(16, np.int64)
    c[T.ZIGZAG4] = levels
    f = (H4 @ c.reshape(4, 4) @ H4).reshape(16) * ls_dc
    return f << (qp // 6 - 6) if qp >= 36 else (f + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def chroma_dc_scaled(levels, ls_dc: int, qpc: int) -> np.ndarray:
    """8.5.11.2 for 4:2:0: chroma DC levels -> the 4 blocks' DC values."""
    d = np.asarray(levels, np.int64)
    f = np.array([d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3],
                  d[0] + d[1] - d[2] - d[3], d[0] - d[1] - d[2] + d[3]])
    return ((f * ls_dc) << (qpc // 6)) >> 5


# ── the writer ──────────────────────────────────────────────────────────

DEFAULTS = dict(
    width=48, height=32, frames=4, idr_every=0, profile=100, cabac=True, t8x8=True,
    scaling=None, slices=2, deblock=(0, 1, 2), constrained_intra=False, refs=1,
    num_ref_idx=1, list_mod=False, mmco=False, long_term=False, weighted=False, poc_type=0,
    pcm=0.03, intra_in_p=0.15, skip=0.25, qp=(20, 36), qp_delta=4, density=0.25, big=0.0,
    non_ref=False, param_sets=1, chroma_offsets=(0, 0), i_slices_in_p=0.0, fps=25,
    mmco5=False, colour=None, restriction=False,
    kinds=("I4x4", "I8x8", "I16", "P16x16", "P16x8", "P8x16", "P8x8", "P8x8REF0"),
    i16_modes=(0, 1, 2, 3), chroma_modes=(0, 1, 2, 3), scaling_range=(6, 40), whole_mv=False,
    # B pictures: up to `bframes` between two anchors (their middle one a
    # reference under `pyramid`, any other one with probability `b_ref`), an
    # anchor a B picture of past references only with probability `past_b`;
    # each B slice picks its direct mode from `direct`; the SPS's
    # direct_8x8_inference_flag, the PPS's weighted_bipred_idc
    bframes=0, pyramid=False, b_ref=0.0, past_b=0.0, direct=("spatial", "temporal"),
    direct8x8=1, bipred=0, b_subs=tuple(range(13)), level=None)
# mb_type values of each B macroblock kind (Table 7-14)
B_TYPES = {"BDIRECT": [0], "B16x16": [1, 2, 3], "B16x8": list(range(4, 22, 2)),
           "B8x16": list(range(5, 22, 2)), "B8x8": [22]}
# the largest |vector| component a direct prediction may give, in quarter
# samples: +-2048 samples across, +-256 down (levels 2.1 to 3)
MV_LIMIT = (8191, 1023)


class Writer:
    def __init__(self, seed: int, **features):
        self.rng = np.random.default_rng(seed)
        self.f = dict(DEFAULTS, **features)
        unknown = set(features) - set(DEFAULTS)
        assert not unknown, unknown
        f = self.f
        self.w, self.h = f["width"], f["height"]
        self.mbw, self.mbh = -(-self.w // 16), -(-self.h // 16)
        self.n = self.mbw * self.mbh
        if f["profile"] != 100:
            assert not f["t8x8"] and not f["scaling"]
        if f["profile"] == 66:
            assert not f["weighted"]
        self.log2_fn = 4 + int(self.rng.integers(0, 3))
        self.log2_poc = 4 + int(self.rng.integers(1, 4))
        self.poc_cycle = [int(v) for v in self.rng.integers(2, 5, int(self.rng.integers(1, 4)))]
        self.stats = Counter()          # what the stream exercised, by name
        self.b_mode = bool(f["bframes"] or f["past_b"])
        self.level = f["level"] or (22 if self.b_mode else 40)
        self.uid = 0                    # the pictures' identities

    # ── parameter sets ──
    def _lists(self, present_p: float):
        """Random scaling lists (None where absent) and their use_default."""
        lists = []
        for i in range(8):
            if self.rng.random() >= present_p:
                lists.append(None)
            elif self.rng.random() < 0.15:
                lists.append("default")
            else:
                size = 16 if i < 6 else 64
                lo, hi = self.f["scaling_range"]
                values = [int(v) for v in self.rng.integers(lo, hi, size)]
                if i in (0, 3):
                    # the luma DC weight a multiple of 8: FFmpeg's SIMD
                    # Intra_16x16 DC scaling drops low bits of a multiplier
                    # of 2^15 or more (8.5.10 keeps them)
                    values[0] = max(8, values[0] & ~7)
                lists.append(values)
        return lists

    def _write_lists(self, bw: BitWriter, lists, count: int):
        for i in range(count):
            lst = lists[i]
            bw.u(1, lst is not None)
            if lst is None:
                continue
            size = 16 if i < 6 else 64
            values = [0] if lst == "default" else lst
            last = 8
            for j, v in enumerate(values):
                nxt = 0 if lst == "default" else v
                delta = (nxt - last + 128) % 256 - 128
                bw.se(delta)
                if lst == "default":
                    break
                last = v
                if j == size - 1:
                    break

    def parameter_sets(self):
        f, rng = self.f, self.rng
        self.sps_ids = [int(v) for v in rng.choice(32, f["param_sets"], replace=False)]
        self.pps_ids = [int(v) for v in rng.choice(256, f["param_sets"], replace=False)]
        self.sps_id, self.pps_id = self.sps_ids[-1], self.pps_ids[-1]
        scaling = f["scaling"] or ""
        self.sps_lists = self._lists(0.6) if "sps" in scaling else None
        self.pps_lists = self._lists(0.6) if "pps" in scaling else None
        units = []
        for sid in self.sps_ids:
            bw = BitWriter()
            constraint = 0x40 if f["profile"] == 77 else (0xC0 if f["profile"] == 66 else 0)
            bw.u(8, f["profile"])
            bw.u(8, constraint)
            bw.u(8, self.level)
            bw.ue(sid)
            if f["profile"] == 100:
                bw.ue(1)
                bw.ue(0)
                bw.ue(0)
                bw.u(1, 0)
                bw.u(1, self.sps_lists is not None)
                if self.sps_lists is not None:
                    self._write_lists(bw, self.sps_lists, 8)
            bw.ue(self.log2_fn - 4)
            bw.ue(f["poc_type"])
            if f["poc_type"] == 0:
                bw.ue(self.log2_poc - 4)
            elif f["poc_type"] == 1:
                bw.u(1, 0 if self.b_mode else 1)           # delta_pic_order_always_zero
                bw.se(1)                                   # offset_for_non_ref_pic
                bw.se(0)
                bw.ue(len(self.poc_cycle))
                for v in self.poc_cycle:
                    bw.se(v)
            bw.ue(f["refs"])
            bw.u(1, 0)
            bw.ue(self.mbw - 1)
            bw.ue(self.mbh - 1)
            bw.u(1, 1)
            bw.u(1, f["direct8x8"])
            crop_r, crop_b = (16 * self.mbw - self.w) // 2, (16 * self.mbh - self.h) // 2
            bw.u(1, crop_r > 0 or crop_b > 0)
            if crop_r or crop_b:
                bw.ue(0)
                bw.ue(crop_r)
                bw.ue(0)
                bw.ue(crop_b)
            bw.u(1, 1)                                     # VUI
            bw.u(2, 0)                                     # no aspect ratio, overscan
            bw.u(1, f["colour"] is not None)
            if f["colour"] is not None:                    # see vui_colour
                colour = vui_colour(f["colour"])
                bw.u(3, 5)
                bw.u(1, colour[0])
                bw.u(1, 1)
                for v in colour[1:]:
                    bw.u(8, v)
            bw.u(1, 0)                                     # chroma location
            bw.u(1, 1)
            bw.u(32, 1)
            bw.u(32, 2 * f["fps"])
            bw.u(1, 1)
            bw.u(3, 0)                                     # no HRD, no pic_struct
            bw.u(1, f["restriction"])
            if f["restriction"]:
                bw.u(1, 1)
                # max_num_reorder_frames: the B pictures between two anchors
                # bound it; max_dec_frame_buffering as x264 writes it
                for v in (0, 0, 15, 15, f["bframes"], max(f["refs"], 1, f["bframes"])):
                    bw.ue(v)
            bw.trailing()
            units.append(nal(3, 7, bw.data()))
        for k, pid in enumerate(self.pps_ids):
            bw = BitWriter()
            bw.ue(pid)
            bw.ue(self.sps_ids[k])
            bw.u(1, f["cabac"])
            bw.u(1, 0)
            bw.ue(0)
            bw.ue(max(f["num_ref_idx"], 1) - 1)
            bw.ue(0)
            bw.u(1, f["weighted"])
            bw.u(2, f["bipred"])
            self.pic_init_qp = int(rng.integers(f["qp"][0], f["qp"][1] + 1))
            bw.se(self.pic_init_qp - 26)
            bw.se(0)
            bw.se(f["chroma_offsets"][0])
            bw.u(1, 1)
            bw.u(1, f["constrained_intra"])
            bw.u(1, 0)
            if f["profile"] == 100:
                bw.u(1, f["t8x8"])
                bw.u(1, self.pps_lists is not None)
                if self.pps_lists is not None:
                    self._write_lists(bw, self.pps_lists, 6 + 2 * f["t8x8"])
                bw.se(f["chroma_offsets"][1])
            bw.trailing()
            units.append(nal(3, 8, bw.data()))
        self._resolve_lists()
        return units

    def _resolve_lists(self):
        def value(lst, i):
            if lst == "default":
                if i < 6:
                    return list(T.DEFAULT_4X4[0 if i < 3 else 1])
                return list(T.DEFAULT_8X8[i - 6])
            return lst

        flat4, flat8 = [[16] * 16] * 6, [[16] * 64] * 2
        sps4, sps8 = list(flat4), list(flat8)
        if self.sps_lists is not None:
            for i in range(8):
                lst = self.sps_lists[i]
                if lst is not None:
                    v = value(lst, i)
                elif i in (0, 3) or i >= 6:
                    v = value("default", i)
                else:
                    v = sps4[i - 1]
                if i < 6:
                    sps4[i] = v
                else:
                    sps8[i - 6] = v
        l4, l8 = list(sps4), list(sps8)
        if self.pps_lists is not None:
            for i in range(6 + 2 * self.f["t8x8"]):
                lst = self.pps_lists[i]
                if lst is not None:
                    v = value(lst, i)
                elif i in (0, 3) or i >= 6:
                    if self.sps_lists is not None:
                        v = sps4[i] if i < 6 else sps8[i - 6]
                    else:
                        v = value("default", i)
                else:
                    v = l4[i - 1]
                if i < 6:
                    l4[i] = v
                else:
                    l8[i - 6] = v
        self.ls4, self.ls8 = scaling_tables(np.array(l4), np.array(l8))

    # ── the stream ──
    def stream(self) -> list[list[bytes]]:
        f, rng = self.f, self.rng
        aus = [self.parameter_sets()]
        self.dpb = []                 # dicts: frame_num, long (idx or None)
        self.max_long = -1
        self.prev_ref_fn = 0
        self.poc = 0
        self.idr_id = 0
        self.prev_nonref = False
        self.prev_fn = self.prev_fno = 0
        plan = self.plan() if self.b_mode else [(None, None, None)] * f["frames"]
        self.display = []               # each picture's place in output order
        for k, (shown, kind, ref) in enumerate(plan):
            idr = k == 0 or (f["idr_every"] and k % f["idr_every"] == 0) if shown is None \
                else kind == "IDR"
            units = self.picture(idr, shown, kind, ref)
            self.display.append(k if shown is None else shown)
            aus[-1] += units if k == 0 else []
            if k:
                aus.append(units)
        return aus

    def plan(self) -> list[tuple[int, str, bool]]:
        """B pictures: (place in output order, "IDR" / "P" / "B", reference)
        of each picture in decoding order.  Between two anchors up to
        `bframes` B pictures shown before the later one and decoded after it,
        the middle one first as a reference under `pyramid`."""
        f, rng = self.f, self.rng
        n, every = f["frames"], f["idr_every"]
        out, k = [], 0

        def between(lo, hi):
            if hi <= lo:
                return []
            if f["pyramid"] and hi - lo >= 2:
                mid = (lo + hi - 1) // 2
                return [(mid, "B", True)] + between(lo, mid) + between(mid + 1, hi)
            return [(d, "B", bool(rng.random() < f["b_ref"])) for d in range(lo, hi)]

        prev_nonref = False
        while k < n:
            if k == 0 or (every and k % every == 0):
                out.append((k, "IDR", True))
                k += 1
                continue
            end = min(n, (k // every + 1) * every) if every else n
            nb = int(rng.integers(0, min(f["bframes"], end - k - 1) + 1))
            kind = "B" if rng.random() < f["past_b"] else "P"
            # a non-reference anchor only where no picture comes between
            ref = not (nb == 0 and f["non_ref"] and not prev_nonref and rng.random() < 0.3)
            prev_nonref = not ref
            out.append((k + nb, kind, ref))
            out += between(k, k + nb)
            k += nb + 1
        return out

    def picture(self, idr: bool, shown=None, kind=None, plan_ref=None) -> list[bytes]:
        f, rng = self.f, self.rng
        max_fn = 1 << self.log2_fn
        ref = True
        if shown is not None:
            ref = plan_ref
        elif not idr and f["non_ref"] and not self.prev_nonref and rng.random() < 0.3:
            ref = False
        self.prev_nonref = not ref
        self.kind = kind
        if idr:
            self.dpb, self.max_long, frame_num, self.poc = [], -1, 0, 0
            self.idr_id ^= 1
            self.idr_shown = shown
        else:
            frame_num = (self.prev_ref_fn + 1) % max_fn
            self.poc += 2
        self.frame_num = frame_num
        if self.b_mode:
            self.poc, self.delta_poc = self.picture_order(idr, ref, frame_num,
                                                          2 * (shown - self.idr_shown))
            self.stats["b_pic"] += kind == "B"
            self.stats["ref_b"] += kind == "B" and ref
            self.stats["reordered"] += shown != len(self.display)
        # picNum of each short-term reference (FrameNumWrap)
        for p in self.dpb:
            p["wrap"] = p["fn"] - max_fn if p["fn"] > frame_num else p["fn"]
        marking = self.marking(idr, ref)
        self.pic = [None] * self.n
        self.pic_lists = (None, None)           # the lists of its P or B slices
        n_slices = int(rng.integers(1, f["slices"] + 1))
        cuts = sorted(rng.choice(np.arange(1, self.n), min(n_slices - 1, self.n - 1),
                                 replace=False).tolist()) if self.n > 1 else []
        bounds = [0] + cuts + [self.n]
        units = []
        for s in range(len(bounds) - 1):
            units.append(self.slice(s, bounds[s], bounds[s + 1], idr, ref, marking))
        self.apply_marking(idr, ref, marking)
        for op in marking[2]:
            self.stats[f"mmco{op[0]}"] += 1
        self.stats["long_term"] += sum(p["long"] is not None for p in self.dpb)
        self.stats["non_ref"] += not ref
        if ref:
            self.prev_ref_fn = 0 if any(op[0] == 5 for op in marking[2]) else frame_num
        if any(op[0] == 5 for op in marking[2]):
            self.poc = 0
        return units

    def picture_order(self, idr: bool, ref: bool, frame_num: int, want: int):
        """(the POC the decoder derives, delta_pic_order_cnt[0]) of a picture
        meant to have POC `want` (8.2.1): POC type 0 writes it, type 1 gives
        the difference from the expected count, type 2 has no say (display
        order is decoding order)."""
        f = self.f
        max_fn = 1 << self.log2_fn
        fno = 0 if idr else self.prev_fno + (max_fn if self.prev_fn > frame_num else 0)
        self.prev_fno, self.prev_fn = fno, frame_num
        if f["poc_type"] == 0:
            return want, 0
        if f["poc_type"] == 2:
            return (0 if idr else 2 * (fno + frame_num) - (0 if ref else 1)), 0
        n = len(self.poc_cycle)
        count = fno + frame_num if n else 0
        if not ref and count > 0:
            count -= 1
        expected = 0
        if count > 0:
            cycles, within = divmod(count - 1, n)
            expected = cycles * sum(self.poc_cycle) + sum(self.poc_cycle[:within + 1])
        if not ref:
            expected += 1                                  # offset_for_non_ref_pic
        return want, want - expected

    def marking(self, idr: bool, ref: bool):
        """(no_output_of_prior_pics, long_term_reference) for an IDR, else
        (adaptive, None, operations); the operations keep the DPB legal."""
        f, rng = self.f, self.rng
        if not ref:
            return (False, None, [])
        if idr:
            return (False, bool(f["long_term"] and rng.random() < 0.5), [])
        ops = []
        full = len(self.dpb) >= max(f["refs"], 1)
        sliding_ok = not full or any(p["long"] is None for p in self.dpb)
        if (not f["mmco"] or rng.random() < 0.3) and sliding_ok:
            return (False, None, ops)
        dpb = [dict(p) for p in self.dpb]
        max_long = self.max_long
        cur_long = False
        lt = f["long_term"]
        for _ in range(int(rng.integers(1, 4))):
            shorts = [p for p in dpb if p["long"] is None]
            longs = [p for p in dpb if p["long"] is not None]
            options = (["1"] * bool(shorts) + ["2"] * bool(longs)
                       + ["3", "3"] * bool(shorts and max_long >= 0 and lt) + ["4"] * lt
                       + ["6", "6"] * (max_long >= 0 and lt and not cur_long)
                       + ["5"] * (f["mmco5"] and not ops and rng.random() < 0.3))
            if lt and max_long < 0:
                options = ["4"]
            if not options:
                break
            choice = options[int(rng.integers(len(options)))]
            if choice == "1":
                p = shorts[rng.integers(len(shorts))]
                ops.append((1, self.frame_num - p["wrap"] - 1, 0))
                dpb.remove(p)
            elif choice == "2":
                p = longs[rng.integers(len(longs))]
                ops.append((2, p["long"], 0))
                dpb.remove(p)
            elif choice == "3":
                p = shorts[rng.integers(len(shorts))]
                idx = int(rng.integers(0, max_long + 1))
                for q in longs:
                    if q["long"] == idx:
                        dpb.remove(q)
                ops.append((3, self.frame_num - p["wrap"] - 1, idx))
                p["long"] = idx
            elif choice == "4":
                m = int(rng.integers(0, 4)) if max_long >= 0 else int(rng.integers(1, 4))
                ops.append((4, m, 0))
                max_long = m - 1
                for q in longs:
                    if q["long"] > max_long:
                        dpb.remove(q)
            elif choice == "6":
                idx = int(rng.integers(0, max_long + 1))
                for q in longs:
                    if q["long"] == idx:
                        dpb.remove(q)
                ops.append((6, idx, 0))
                cur_long = True
                break                             # nothing after it may touch its index
            else:
                ops.append((5, 0, 0))
                dpb, max_long = [], -1
                break
        # the current picture must fit
        while len(dpb) >= max(f["refs"], 1):
            shorts = [p for p in dpb if p["long"] is None]
            p = (shorts or dpb)[0]
            if p["long"] is None:
                ops.append((1, self.frame_num - p["wrap"] - 1, 0))
            else:
                ops.append((2, p["long"], 0))
            dpb.remove(p)
        return (True, None, ops)

    def apply_marking(self, idr: bool, ref: bool, marking):
        f = self.f
        if not ref:
            return
        self.uid += 1
        cur = {"fn": self.frame_num, "long": None, "poc": self.poc, "mbs": self.pic,
               "uid": self.uid}
        if idr:
            if marking[1]:
                cur["long"], self.max_long = 0, 0
            else:
                self.max_long = -1
            self.dpb = [cur]
            return
        adaptive, _, ops = marking
        if not adaptive:
            if len(self.dpb) >= max(f["refs"], 1):
                shorts = [p for p in self.dpb if p["long"] is None]
                self.dpb.remove(min(shorts, key=lambda p: p["wrap"]))
        for op, a, b in ops:
            if op == 1:
                self.dpb = [p for p in self.dpb if not (p["long"] is None
                                                        and p["wrap"] == self.frame_num - a - 1)]
            elif op == 2:
                self.dpb = [p for p in self.dpb if p["long"] != a]
            elif op == 3:
                self.dpb = [p for p in self.dpb if p["long"] != b]
                for p in self.dpb:
                    if p["long"] is None and p["wrap"] == self.frame_num - a - 1:
                        p["long"] = b
            elif op == 4:
                self.max_long = a - 1
                self.dpb = [p for p in self.dpb if p["long"] is None or p["long"] <= self.max_long]
            elif op == 5:
                self.dpb, self.max_long = [], -1
                cur["fn"] = 0
            elif op == 6:
                self.dpb = [p for p in self.dpb if p["long"] != a]
                cur["long"] = a
        self.dpb.append(cur)
        assert len(self.dpb) <= max(f["refs"], 1)

    def ref_list(self):
        shorts = sorted((p for p in self.dpb if p["long"] is None), key=lambda p: -p["wrap"])
        longs = sorted((p for p in self.dpb if p["long"] is not None), key=lambda p: p["long"])
        return shorts + longs

    # ── a slice ──
    def slice(self, sid: int, first: int, end: int, idr: bool, ref: bool, marking) -> bytes:
        f, rng = self.f, self.rng
        # with B pictures a picture's first slice is never an I slice: FFmpeg's
        # frame threads may start the next picture after that slice alone,
        # before any slice has given the lists its temporal direct reads
        inter = not idr and bool(self.dpb) and (rng.random() >= f["i_slices_in_p"]
                                                or (self.b_mode and sid == 0))
        b_slice = inter and self.kind == "B"
        p_slice = inter and not b_slice
        bw = BitWriter()
        bw.ue(first)
        bw.ue((1 if b_slice else 0 if p_slice else 2) + 5 * (rng.random() < 0.3 and not inter
                                                             and idr))
        bw.ue(self.pps_id)
        bw.u(self.log2_fn, self.frame_num)
        if idr:
            bw.ue(self.idr_id)
        if f["poc_type"] == 0:
            bw.u(self.log2_poc, self.poc % (1 << self.log2_poc))
        elif f["poc_type"] == 1 and self.b_mode:
            bw.se(self.delta_poc)
        self.list0 = []
        self.lists = [[], []]
        if p_slice:
            if (self.b_mode and sid) and self.pic_lists[0] == "P":    # the picture's lists again
                n_ref, mods, self.list0 = self.pic_lists[1][0]
            else:
                full = self.ref_list()
                n_ref = int(rng.integers(1, min(len(full), max(f["num_ref_idx"], 1)) + 1))
                mods, self.list0 = self.modifications(full, n_ref)
                self.pic_lists = ("P", [(n_ref, mods, self.list0)])
            bw.u(1, 1)
            bw.ue(n_ref - 1)
            self.write_modifications(bw, mods, "list_mod")
            self.lists = [self.list0, []]
            if f["weighted"]:
                self.weight_table(bw, n_ref)
                self.stats["weighted"] += 1
        elif b_slice:
            self.b_header(bw)
        if ref:
            if idr:
                bw.u(1, marking[0])
                bw.u(1, marking[1])
            else:
                bw.u(1, marking[0])
                if marking[0]:
                    for op, a, b in marking[2]:
                        bw.ue(op)
                        if op in (1, 3):
                            bw.ue(a)
                        if op == 2:
                            bw.ue(a)
                        if op in (3, 6):
                            bw.ue(b if op == 3 else a)
                        if op == 4:
                            bw.ue(a)
                    bw.ue(0)
        cabac_idc = int(rng.integers(0, 3))
        if f["cabac"] and inter:
            bw.ue(cabac_idc)
            self.stats[f"cabac_init_idc{cabac_idc}"] += 1
        qp = int(rng.integers(f["qp"][0], f["qp"][1] + 1))
        bw.se(qp - self.pic_init_qp)
        idc = int(rng.choice(f["deblock"]))
        self.stats[f"deblock{idc}"] += 1
        self.stats["slices"] += 1
        bw.ue(idc)
        if idc != 1:
            bw.se(int(rng.integers(-6, 7)))
            bw.se(int(rng.integers(-6, 7)))
        self.p_slice, self.sid, self.qp, self.prev_mb = p_slice, sid, qp, None
        self.b_slice = b_slice
        if f["cabac"]:
            while bw.nacc:
                bw.u(1, 1)
            self.cabac = Cabac(bw, not inter, cabac_idc, qp)
        else:
            self.cabac = None
        self.bw = bw
        skip_run = 0
        for addr in range(first, end):
            self.addr, self.mbx, self.mby = addr, addr % self.mbw, addr // self.mbw
            if b_slice:
                # the direct prediction of the macroblock (None: temporal direct
                # cannot serve here), which B_Skip and B_Direct_16x16 take
                self.dblocks = self.direct_blocks(range(4))
                skip = self.dblocks is not None and rng.random() < f["skip"]
            else:
                skip = p_slice and rng.random() < f["skip"]
            if self.cabac:
                if inter:
                    a, b = self.nb_a(), self.nb_b()
                    inc = sum(n is not None and n.kind not in SKIP_KINDS for n in (a, b))
                    self.cabac.bin((11 if p_slice else 24) + inc, int(skip))
                if skip:
                    self.skip_mb()
                else:
                    self.macroblock()
                self.cabac.terminate(int(addr == end - 1))
            else:
                if skip:
                    skip_run += 1
                    self.skip_mb()
                    continue
                if inter:
                    bw.ue(skip_run)
                    skip_run = 0
                self.macroblock()
        if self.cabac is None:
            if skip_run:
                bw.ue(skip_run)
            bw.trailing()
        else:
            bw.align_zero()
        return nal(3 if ref else 0, 5 if idr else 1, bw.data())

    def modifications(self, full: list, n_ref: int):
        """ref_pic_list_modification of one list: random pictures of the
        initial list `full` moved to the front; (operations, final list)."""
        f, rng = self.f, self.rng
        lst = list(full)
        mods = []
        if f["list_mod"] and rng.random() < 0.6:
            pred = self.frame_num
            max_fn = 1 << self.log2_fn
            for idx in range(int(rng.integers(1, n_ref + 1))):
                pic = full[int(rng.integers(len(full)))]
                if pic["long"] is not None:
                    mods.append((2, pic["long"]))
                else:
                    diff = pic["wrap"] - pred
                    if diff < 0:
                        mods.append((0, -diff - 1))
                    elif diff > 0:
                        mods.append((1, diff - 1))
                    else:                             # the same picNum again
                        mods.append((0, max_fn - 1))
                    pred = pic["wrap"]
                lst = lst[:idx] + [pic] + [q for q in lst[idx:] if q is not pic]
        return mods, lst[:n_ref]

    def write_modifications(self, bw: BitWriter, mods, stat: str) -> None:
        bw.u(1, bool(mods))
        self.stats[stat] += len(mods)
        for idc, v in mods:
            bw.ue(idc)
            bw.ue(v)
        if mods:
            bw.ue(3)

    def b_lists(self):
        """8.2.4.2.3: the initial lists of a B slice, list 1's first two
        entries swapped where it equals list 0 and has more than one."""
        shorts = [p for p in self.dpb if p["long"] is None]
        longs = sorted((p for p in self.dpb if p["long"] is not None), key=lambda p: p["long"])
        before = sorted((p for p in shorts if p["poc"] < self.poc), key=lambda p: -p["poc"])
        after = sorted((p for p in shorts if p["poc"] > self.poc), key=lambda p: p["poc"])
        l0, l1 = before + after + longs, after + before + longs
        swap = len(l1) > 1 and all(a is b for a, b in zip(l0, l1))
        if swap:
            l1[0], l1[1] = l1[1], l1[0]
        return l0, l1, swap

    def b_header(self, bw: BitWriter) -> None:
        """A B slice's header from direct_spatial_mv_pred_flag to
        pred_weight_table: both lists, their lengths and modifications."""
        f, rng = self.f, self.rng
        self.spatial = f["direct"][int(rng.integers(len(f["direct"])))] == "spatial"
        bw.u(1, self.spatial)
        # every slice of a picture has the same lists, as encoders write
        # them: FFmpeg's frame threads may read the lists of a co-located
        # picture's first slice where the block lies in a later one
        if self.pic_lists[0] != "B":
            full0, full1, swap = self.b_lists()
            self.stats["list_swap"] += swap
            cap = max(f["num_ref_idx"], 1)
            self.pic_lists = ("B", [(n, *self.modifications(full, n)) for full in (full0, full1)
                                    for n in [int(rng.integers(1, min(len(full), cap) + 1))]])
        (n0, mods0, l0), (n1, mods1, l1) = self.pic_lists[1]
        bw.u(1, 1)
        bw.ue(n0 - 1)
        bw.ue(n1 - 1)
        self.write_modifications(bw, mods0, "list_mod")
        self.write_modifications(bw, mods1, "list1_mod")
        self.lists = [l0, l1]
        self.list0 = l0
        self.stats["long_term_l1"] += any(p["long"] is not None for p in self.lists[1])
        self.stats["b_slices"] += 1
        self.stats[f"weighted_bipred{f['bipred']}"] += 1
        if f["bipred"] == 1:
            self.weight_table(bw, n0, n1)

    def weight_table(self, bw: BitWriter, n_ref: int, n_ref1: int | None = None) -> None:
        """pred_weight_table: weights about 2^denom, offsets within +-20; in a
        B slice (`n_ref1` entries of list 1 too) each weight within -64..63,
        so that the two of a bi-predicted partition sum to -128..127."""
        rng = self.rng

        def weight(denom: int) -> int:
            one = 1 << denom
            w = int(np.clip(one + rng.integers(-one // 2 - 2, one // 2 + 3), -128, 127))
            return w if n_ref1 is None else min(max(w, -64), 63)

        # a B slice's denominators stay below 7: FFmpeg's SSSE3 bi-prediction
        # sums in saturating 16 bits, which at logWD 7 (a shift by 8) can
        # leave 8.4.2.3's result
        top = 8 if n_ref1 is None else 7
        ld, cd = int(rng.integers(0, top)), int(rng.integers(0, top))
        bw.ue(ld)
        bw.ue(cd)
        for _ in range(n_ref + (n_ref1 or 0)):
            lflag = rng.random() < 0.7
            bw.u(1, lflag)
            if lflag:
                bw.se(weight(ld))
                bw.se(int(rng.integers(-20, 21)))
            cflag = rng.random() < 0.5
            bw.u(1, cflag)
            if cflag:
                for _ in range(2):
                    bw.se(weight(cd))
                    bw.se(int(rng.integers(-20, 21)))

    # ── neighbours ──
    def _mb(self, addr):
        if addr is None or addr < 0:
            return None
        m = self.pic[addr]
        return m if m is not None and m.slice == self.sid else None

    def nb_a(self):
        return self._mb(self.addr - 1) if self.mbx > 0 else None

    def nb_b(self):
        return self._mb(self.addr - self.mbw)

    def locate(self, x, y):
        """(macroblock, xW, yW) holding luma (x, y) relative to the current
        macroblock; None where there is none or it is not available."""
        if y > 15:
            return None
        if x < 0 and y < 0:
            m = self._mb(self.addr - self.mbw - 1) if self.mbx > 0 else None
        elif x < 0:
            m = self.nb_a()
        elif x <= 15 and y < 0:
            m = self.nb_b()
        elif x <= 15:
            m = self.cur
        elif y < 0:
            m = self._mb(self.addr - self.mbw + 1) if self.mbx < self.mbw - 1 else None
        else:
            return None
        return None if m is None else (m, x & 15, y & 15)

    def intra_avail(self, x, y):
        loc = self.locate(x, y)
        if loc is None:
            return False
        m, xw, yw = loc
        if m is self.cur:
            return self.done[(yw >> 2) * 4 + (xw >> 2)]
        return m.intra or not self.f["constrained_intra"]

    def motion(self, x, y, lx=0):
        """(available, ref, mv) of list lx of the 4x4 block holding (x, y)."""
        loc = self.locate(x, y)
        if loc is None:
            return False, -1, (0, 0)
        m, xw, yw = loc
        r = (yw >> 2) * 4 + (xw >> 2)
        if m is self.cur and not self.done[r]:
            return False, -1, (0, 0)
        if m.intra:
            return True, -1, (0, 0)
        ref = m.ref[lx][(yw >> 3) * 2 + (xw >> 3)]
        return True, ref, m.mv[lx][r] if ref >= 0 else (0, 0)

    def mvp(self, x, y, w, h, ref, shape, lx=0):
        aa, ra, ma = self.motion(x - 1, y, lx)
        ab, rb, mb = self.motion(x, y - 1, lx)
        ac, rc, mc = self.motion(x + w, y - 1, lx)
        if not ac:
            ac, rc, mc = self.motion(x - 1, y - 1, lx)
        if shape == 1:
            if y == 0 and rb == ref:
                return mb
            if y != 0 and ra == ref:
                return ma
        elif shape == 2:
            if x == 0 and ra == ref:
                return ma
            if x != 0 and rc == ref:
                return mc
        if not ab and not ac and aa:
            rb = rc = ra
            mb = mc = ma
        hits = [m for r, m in ((ra, ma), (rb, mb), (rc, mc)) if r == ref]
        if len(hits) == 1:
            return hits[0]
        return (median(ma[0], mb[0], mc[0]), median(ma[1], mb[1], mc[1]))

    # ── macroblocks ──
    def start_mb(self, kind):
        m = MB(self.sid, kind)
        self.pic[self.addr] = m
        self.cur = m
        self.done = [False] * 16
        return m

    def skip_mb(self):
        if self.b_slice:                          # B_Skip: the direct prediction
            m = self.start_mb("BSKIP")
            self.stats["BSKIP"] += 1
            m.qp = self.qp
            self.apply_direct(m, self.dblocks)
            self.prev_mb = m
            return
        m = self.start_mb("PSKIP")
        self.stats["PSKIP"] += 1
        m.qp = self.qp
        a, b = self.locate(-1, 0), self.locate(0, -1)
        mv = (0, 0)
        if a is not None and b is not None:
            _, ra, ma = self.motion(-1, 0)
            _, rb, mb = self.motion(0, -1)
            if not ((ra == 0 and ma == (0, 0)) or (rb == 0 and mb == (0, 0))):
                mv = self.mvp(0, 0, 16, 16, 0, 0)
        m.mv[0] = [mv] * 16
        m.refpic[0] = [self.list0[0]["uid"]] * 4
        self.prev_mb = m

    def macroblock(self):
        f, rng = self.f, self.rng
        if self.p_slice and rng.random() >= f["intra_in_p"]:
            kinds = [k for k in ("P16x16", "P16x8", "P8x16", "P8x8", "P8x8REF0")
                     if k in f["kinds"] and not (k == "P8x8REF0" and f["cabac"])]
            kind = kinds[int(rng.integers(len(kinds)))]
        elif self.b_slice and rng.random() >= f["intra_in_p"]:
            kinds = [k for k in B_TYPES if k != "BDIRECT" or self.dblocks is not None]
            kind = kinds[int(rng.integers(len(kinds)))]
            types = B_TYPES[kind]
            m = self.start_mb(kind)
            self.b_inter_mb(m, types[int(rng.integers(len(types)))])
            self.prev_mb = m
            return
        else:
            r = rng.random()
            if r < f["pcm"]:
                kind = "IPCM"
            else:
                kinds = [k for k in ("I4x4", "I16", "I8x8")
                         if k in f["kinds"] and (k != "I8x8" or f["t8x8"])]
                kind = kinds[int(rng.integers(len(kinds)))]
        m = self.start_mb(kind)
        self.stats[kind] += 1
        self.stats["intra_in_b"] += self.b_slice
        if kind == "IPCM":
            self.mb_type(30)
            self.bw.align_zero()
            self.bw.buf += bytes(rng.integers(0, 256, 384, dtype=np.uint8))
            if self.cabac:
                self.cabac.start()
            m.qp = self.qp
            m.cbp = 0x2F
            self.prev_mb = m
            return
        if m.intra:
            self.intra_mb(m)
        else:
            self.inter_mb(m)
        self.prev_mb = m

    def mb_type(self, t: int):
        """t: 0-4 P types, 5 I_NxN, 6-29 Intra_16x16, 30 I_PCM (in a B slice
        the intra ones)."""
        if not self.cabac:
            self.bw.ue(t if self.p_slice else t + 18 if self.b_slice else t - 5)
            return
        c = self.cabac
        if self.p_slice:
            if t < 5:
                c.bin(14, 0)
                b1, b2 = {0: (0, 0), 1: (1, 1), 2: (1, 0), 3: (0, 1)}[t]
                c.bin(15, b1)
                c.bin(17 if b1 else 16, b2)
                return
            c.bin(14, 1)
            base, inc0 = 17, 0
        elif self.b_slice:
            self.b_mb_type(None)                  # the intra prefix 111101
            base, inc0 = 32, 0
        else:
            base = 3
            a, b = self.nb_a(), self.nb_b()
            inc0 = sum(n is not None and n.kind not in ("I4x4", "I8x8") for n in (a, b))
        if t == 5:
            c.bin(base + inc0, 0)
            return
        c.bin(base + inc0, 1)
        if t == 30:
            c.terminate(1)
            return
        c.terminate(0)
        k = t - 6
        luma, chroma, mode = k >= 12, (k // 4) % 3, k % 4
        if base == 3:
            c.bin(6, luma)
            c.bin(7, chroma != 0)
            if chroma:
                c.bin(8, chroma == 2)
            c.bin(9, mode >> 1)
            c.bin(10, mode & 1)
        else:
            c.bin(base + 1, luma)
            c.bin(base + 2, chroma != 0)
            if chroma:
                c.bin(base + 2, chroma == 2)
            c.bin(base + 3, mode >> 1)
            c.bin(base + 3, mode & 1)

    def b_mb_type(self, bt):
        """A B slice's mb_type 0-22 (bt), or with bt None the prefix of an
        intra one: Table 9-37 (b), the contexts as FFmpeg reads them."""
        if not self.cabac:
            self.bw.ue(bt)
            return
        c = self.cabac
        inc = sum(n is not None and n.kind not in ("BSKIP", "BDIRECT")
                  for n in (self.nb_a(), self.nb_b()))
        c.bin(27 + inc, int(bt != 0))
        if bt == 0:
            return
        c.bin(30, int(bt not in (1, 2)))
        if bt in (1, 2):
            c.bin(32, bt - 1)
            return
        if bt is None or bt in (11, 22):          # four bins: 1101, 1110, 1111
            bits, last = {None: 13, 11: 14, 22: 15}[bt], None
        elif bt <= 10:
            bits, last = bt - 3, None
        else:                                     # five bins
            bits, last = (bt + 4) >> 1, (bt + 4) & 1
        c.bin(31, bits >> 3)
        for k in (2, 1, 0):
            c.bin(32, (bits >> k) & 1)
        if last is not None:
            c.bin(32, last)

    def b_sub_type(self, t: int) -> None:
        """A B sub_mb_type 0-12 (Table 9-38, ctxIdx 36-39)."""
        if not self.cabac:
            self.bw.ue(t)
            return
        c = self.cabac
        c.bin(36, int(t != 0))
        if t == 0:
            return
        c.bin(37, int(t > 2))
        if t <= 2:
            c.bin(39, t - 1)
            return
        c.bin(38, int(t >= 7))
        if t >= 11:
            c.bin(39, 1)
            c.bin(39, t - 11)
            return
        k = t - 7 if t >= 7 else t - 3
        if t >= 7:
            c.bin(39, 0)
        c.bin(39, k >> 1)
        c.bin(39, k & 1)

    def intra_mb(self, m):
        f, rng = self.f, self.rng
        if m.kind == "I16":
            top, left, corner = (self.intra_avail(x, y) for x, y in ((0, -1), (-1, 0), (-1, -1)))
            modes = [2] + [0] * top + [1] * left + [3] * (top and left and corner)
            wanted = [m_ for m_ in modes if m_ in f["i16_modes"]]
            modes = wanted or [2]
            mode = modes[int(rng.integers(len(modes)))]
            self.stats[f"i16_mode{mode}"] += 1
            cbp = (15 if rng.random() < 0.5 else 0) | (int(rng.integers(0, 3)) << 4)
            self.mb_type(6 + mode + 4 * (cbp >> 4) + 12 * ((cbp & 15) != 0))
            m.cbp = cbp
        else:
            self.mb_type(5)
            t8 = m.kind == "I8x8"
            if f["t8x8"]:
                if self.cabac:
                    a, b = self.nb_a(), self.nb_b()
                    self.cabac.bin(399 + sum(n is not None and n.t8x8 for n in (a, b)), int(t8))
                else:
                    self.bw.u(1, int(t8))
            m.t8x8 = t8
            self.pred_modes(m, t8)
        top, left, corner = (self.intra_avail(x, y) for x, y in ((0, -1), (-1, 0), (-1, -1)))
        cmodes = [0] + [1] * left + [2] * top + [3] * (top and left and corner)
        cmodes = [c for c in cmodes if c in f["chroma_modes"]] or [0]
        m.chroma_mode = cmodes[int(rng.integers(len(cmodes)))]
        self.stats[f"chroma_mode{m.chroma_mode}"] += 1
        if self.cabac:
            inc = sum(n is not None and n.intra and n.kind != "IPCM" and n.chroma_mode != 0
                      for n in (self.nb_a(), self.nb_b()))
            c = self.cabac
            c.bin(64 + inc, int(m.chroma_mode > 0))
            if m.chroma_mode:
                c.bin(67, int(m.chroma_mode > 1))
                if m.chroma_mode > 1:
                    c.bin(67, int(m.chroma_mode == 3))
        else:
            self.bw.ue(m.chroma_mode)
        if m.kind != "I16":
            m.cbp = int(rng.integers(0, 16)) | (int(rng.integers(0, 3)) << 4)
            self.write_cbp(m)
        self.qp_and_residual(m)

    def pred_modes(self, m, t8):
        rng = self.rng
        count = 4 if t8 else 16
        size = 8 if t8 else 4
        for i in range(count):
            if t8:
                x, y = (i & 1) * 8, (i >> 1) * 8
            else:
                r = BLK_RASTER[i]
                x, y = (r & 3) * 4, (r >> 2) * 4
            has_t, has_l = self.intra_avail(x, y - 1), self.intra_avail(x - 1, y)
            has_d = self.intra_avail(x - 1, y - 1)
            allowed = ([2] + [0, 3, 7] * has_t + [1, 8] * has_l
                       + [4, 5, 6] * (has_t and has_l and has_d))
            mode = allowed[int(rng.integers(len(allowed)))]
            self.stats[f"i{size}_mode{mode}"] += 1
            # the predicted mode (8.3.1.1 / 8.3.2.1)
            dc = False
            got = []
            for xn, yn in ((x - 1, y), (x, y - 1)):
                loc = self.locate(xn, yn)
                if loc is None or (not loc[0].intra and self.f["constrained_intra"]):
                    dc = True
                    got.append(2)
                    continue
                n, xw, yw = loc
                got.append(n.ipred[(yw >> 2) * 4 + (xw >> 2)] if n.kind in ("I4x4", "I8x8") else 2)
            pred = 2 if dc else min(got)
            if self.cabac:
                self.cabac.bin(68, int(mode == pred))
                if mode != pred:
                    rem = mode if mode < pred else mode - 1
                    for k in range(3):
                        self.cabac.bin(69, (rem >> k) & 1)
            else:
                self.bw.u(1, int(mode == pred))
                if mode != pred:
                    self.bw.u(3, mode if mode < pred else mode - 1)
            for yy in range(y, y + size, 4):
                for xx in range(x, x + size, 4):
                    m.ipred[(yy >> 2) * 4 + (xx >> 2)] = mode
                    self.done[(yy >> 2) * 4 + (xx >> 2)] = True

    def write_cbp(self, m):
        cbp = m.cbp
        if not self.cabac:
            self.bw.ue((INTRA_CODE if m.intra else INTER_CODE)[cbp])
            return
        c = self.cabac
        a, b = self.nb_a(), self.nb_b()
        for b8 in range(4):
            if b8 & 1:
                bit_a = (cbp >> (b8 - 1)) & 1
            elif a is None or a.kind == "IPCM":
                bit_a = 1
            elif a.kind in SKIP_KINDS:
                bit_a = 0
            else:
                bit_a = (a.cbp >> (b8 + 1)) & 1
            if b8 & 2:
                bit_b = (cbp >> (b8 - 2)) & 1
            elif b is None or b.kind == "IPCM":
                bit_b = 1
            elif b.kind in SKIP_KINDS:
                bit_b = 0
            else:
                bit_b = (b.cbp >> (b8 + 2)) & 1
            c.bin(73 + (1 - bit_a) + 2 * (1 - bit_b), (cbp >> b8) & 1)
        cond = []
        for n in (a, b):
            if n is None:
                cond.append((0, 0))
            elif n.kind == "IPCM":
                cond.append((1, 1))
            elif n.kind in SKIP_KINDS:
                cond.append((0, 0))
            else:
                cond.append((int((n.cbp >> 4) != 0), int((n.cbp >> 4) == 2)))
        chroma = cbp >> 4
        c.bin(77 + cond[0][0] + 2 * cond[1][0], int(chroma != 0))
        if chroma:
            c.bin(77 + cond[0][1] + 2 * cond[1][1] + 4, int(chroma == 2))

    def inter_mb(self, m):
        f, rng = self.f, self.rng
        kind = m.kind
        t = {"P16x16": 0, "P16x8": 1, "P8x16": 2, "P8x8": 3, "P8x8REF0": 4}[kind]
        self.mb_type(t)
        n_ref = len(self.list0)
        parts = []                                   # (x, y, w, h, ref index)
        if t >= 3:
            subs = [int(rng.integers(0, 4)) for _ in range(4)]
            for s in subs:
                self.stats[f"sub{s}"] += 1
                if self.cabac:
                    c = self.cabac
                    c.bin(21, int(s == 0))
                    if s:
                        c.bin(22, int(s >= 2))
                        if s >= 2:
                            c.bin(23, int(s == 2))
                else:
                    self.bw.ue(s)
            refs8 = []
            for i in range(4):
                r = 0 if t == 4 else int(rng.integers(n_ref))
                refs8.append(r)
                self.write_ref(m, (i & 1) * 8, (i >> 1) * 8, r, 8, 8, t == 4)
            for i, s in enumerate(subs):
                sw = 8 if s in (0, 1) else 4
                sh = 8 if s in (0, 2) else 4
                for y in range((i >> 1) * 8, (i >> 1) * 8 + 8, sh):
                    for x in range((i & 1) * 8, (i & 1) * 8 + 8, sw):
                        parts.append((x, y, sw, sh, refs8[i], 0))
        else:
            shapes = {0: [(0, 0, 16, 16)], 1: [(0, 0, 16, 8), (0, 8, 16, 8)],
                      2: [(0, 0, 8, 16), (8, 0, 8, 16)]}[t]
            for x, y, w, h in shapes:
                r = int(rng.integers(n_ref))
                self.write_ref(m, x, y, r, w, h, False)
                parts.append((x, y, w, h, r, t))
        for x, y, w, h, r, shape in parts:
            px, py = self.mvp(x, y, w, h, r, shape)
            tx, ty = self.target_mv(x, y, w, h, (px, py))
            self.stats["fractional_mv"] += bool(tx & 3 or ty & 3)
            self.stats["outside_mv"] += not (0 <= 16 * self.mbx + x + (tx >> 2) <= self.w - w
                                             and 0 <= 16 * self.mby + y + (ty >> 2) <= self.h - h)
            self.stats[f"ref{r}"] += 1
            dx, dy = tx - px, ty - py
            for comp, d in ((0, dx), (1, dy)):
                if self.cabac:
                    self.write_mvd(x, y, comp, d)
                else:
                    self.bw.se(d)
            for yy in range(y, y + h, 4):
                for xx in range(x, x + w, 4):
                    k = (yy >> 2) * 4 + (xx >> 2)
                    m.mv[0][k] = (tx, ty)
                    m.mvd[0][k] = (min(abs(dx), 255), min(abs(dy), 255))
                    self.done[k] = True
        m.refpic[0] = [self.list0[r]["uid"] for r in m.ref[0]]
        m.cbp = int(rng.integers(0, 16)) | (int(rng.integers(0, 3)) << 4)
        self.write_cbp(m)
        small = any(p[2] < 8 or p[3] < 8 for p in parts)
        if (m.cbp & 15) and f["t8x8"] and not small:
            m.t8x8 = bool(rng.random() < 0.5)
            self.stats["inter_8x8"] += m.t8x8
            if self.cabac:
                a, b = self.nb_a(), self.nb_b()
                self.cabac.bin(399 + sum(n is not None and n.t8x8 for n in (a, b)), int(m.t8x8))
            else:
                self.bw.u(1, int(m.t8x8))
        self.qp_and_residual(m)

    # ── B macroblocks ──
    def b_inter_mb(self, m, bt: int) -> None:
        """An inter macroblock of a B slice of mb_type bt (0-22): its
        partitions' lists, reference indices (list 0, then list 1) and
        vectors (list 0, then list 1), a direct 8x8 taking its prediction
        when list 0 reaches it, then cbp, transform size and residual."""
        f, rng = self.f, self.rng
        self.stats[f"b_mb{bt}"] += 1
        self.b_mb_type(bt)
        m.ref = [[-1] * 4, [-1] * 4]
        shape, f0, f1 = (int(v) for v in T.B_MB_TYPE[bt])
        small = False
        if shape == 0:
            self.apply_direct(m, self.dblocks)
            small = not f["direct8x8"]
        else:
            ps = []                                   # [x, y, w, h, flags, refs]
            if shape == 4:
                subs = []
                for i in range(4):
                    allowed = [t for t in f["b_subs"] if t or self.direct_blocks([i]) is not None]
                    subs.append(allowed[int(rng.integers(len(allowed)))])
                for t in subs:
                    self.stats[f"b_sub{t}"] += 1
                    self.b_sub_type(t)
                for i, t in enumerate(subs):
                    w, h, fl = (int(v) for v in T.B_SUB_MB_TYPE[t])
                    x8, y8 = (i & 1) * 8, (i >> 1) * 8
                    if fl == 0:
                        m.direct[i] = True
                        ps.append([x8, y8, 8, 8, 0, [-1, -1]])
                        small = small or not f["direct8x8"]
                        continue
                    small = small or w < 8 or h < 8
                    for y in range(y8, y8 + 8, h):
                        for x in range(x8, x8 + 8, w):
                            ps.append([x, y, w, h, fl, [-1, -1]])
            else:
                w, h = (16, 16) if shape == 1 else (16, 8) if shape == 2 else (8, 16)
                ps = [[0, 0, w, h, f0, [-1, -1]]]
                if shape != 1:
                    ps.append([0 if shape == 3 else 0, 8 if shape == 2 else 0, w, h, f1, [-1, -1]])
                    if shape == 3:
                        ps[1][0] = 8
            for lx in range(2):
                for p in ps:
                    x, y, w, h, fl, refs = p
                    if not fl >> lx & 1:
                        continue
                    if shape == 4 and (x & 7 or y & 7):   # the 8x8's index, read once
                        refs[lx] = m.ref[lx][(y >> 3) * 2 + (x >> 3)]
                        continue
                    refs[lx] = int(rng.integers(len(self.lists[lx])))
                    self.stats[f"l{lx}ref{refs[lx]}"] += 1
                    self.write_ref(m, x, y, refs[lx], w, h, False, lx)
            pshape = {2: 1, 3: 2}.get(shape, 0)
            for lx in range(2):
                self.done = [False] * 16
                for x, y, w, h, fl, refs in ps:
                    if fl == 0 and lx == 0:
                        self.apply_direct(m, self.direct_blocks([(y >> 3) * 2 + (x >> 3)]))
                    elif fl >> lx & 1:
                        px, py = self.mvp(x, y, w, h, refs[lx], pshape, lx)
                        tx, ty = self.target_mv(x, y, w, h, (px, py))
                        dx, dy = tx - px, ty - py
                        for comp, d in ((0, dx), (1, dy)):
                            if self.cabac:
                                self.write_mvd(x, y, comp, d, lx)
                            else:
                                self.bw.se(d)
                        for yy in range(y, y + h, 4):
                            for xx in range(x, x + w, 4):
                                k = (yy >> 2) * 4 + (xx >> 2)
                                m.mv[lx][k] = (tx, ty)
                                m.mvd[lx][k] = (min(abs(dx), 255), min(abs(dy), 255))
                    for yy in range(y, y + h, 4):
                        for xx in range(x, x + w, 4):
                            self.done[(yy >> 2) * 4 + (xx >> 2)] = True
            for x, y, w, h, fl, refs in ps:
                if fl:
                    self.weight_stats(fl, refs)
                    for lx in range(2):
                        if fl >> lx & 1:
                            m.refpic[lx][(y >> 3) * 2 + (x >> 3)] = self.lists[lx][refs[lx]]["uid"]
        m.cbp = int(rng.integers(0, 16)) | (int(rng.integers(0, 3)) << 4)
        self.write_cbp(m)
        if (m.cbp & 15) and f["t8x8"] and not small:
            m.t8x8 = bool(rng.random() < 0.5)
            self.stats["inter_8x8"] += m.t8x8
            if self.cabac:
                a, b = self.nb_a(), self.nb_b()
                self.cabac.bin(399 + sum(n is not None and n.t8x8 for n in (a, b)), int(m.t8x8))
            else:
                self.bw.u(1, int(m.t8x8))
        self.qp_and_residual(m)

    def spatial_refs(self):
        """8.4.1.2.2: each list's reference index (MinPositive over the
        macroblock's neighbours A, B and C, D standing in for C) and
        predictor; both lists at index 0 with zero vectors where neither is
        used."""
        refs = []
        for lx in range(2):
            got = [self.motion(-1, 0, lx)[1], self.motion(0, -1, lx)[1]]
            ac, rc, _ = self.motion(16, -1, lx)
            got.append(rc if ac else self.motion(-1, -1, lx)[1])
            pos = [r for r in got if r >= 0]
            refs.append(min(pos) if pos else -1)
        if refs == [-1, -1]:
            return [0, 0], [(0, 0), (0, 0)]
        return refs, [self.mvp(0, 0, 16, 16, r, 0, lx) if r >= 0 else (0, 0)
                      for lx, r in enumerate(refs)]

    def direct_blocks(self, b8s):
        """The direct prediction (8.4.1.2) of the 8x8 blocks b8s as (x, y,
        size, flags, refs, vectors) blocks: 8x8 ones reading the co-located
        corner 4x4 block under direct_8x8_inference_flag, else 4x4 ones;
        None where temporal direct cannot serve (the co-located block's
        reference is not in list 0, or a scaled vector leaves MV_LIMIT)."""
        inference = bool(self.f["direct8x8"])
        step = 8 if inference else 4
        col = self.lists[1][0]
        cm = col["mbs"][self.addr]
        if self.spatial:
            sref, smv = self.spatial_refs()
        out = []
        for i in b8s:
            x8, y8 = (i & 1) * 8, (i >> 1) * 8
            for y in range(y8, y8 + 8, step):
                for x in range(x8, x8 + 8, step):
                    cx, cy = ((12 if x8 else 0), (12 if y8 else 0)) if inference else (x, y)
                    ref_col, mv_col, pic_col = -1, (0, 0), None
                    if not cm.intra:
                        c8, c4 = (cy >> 3) * 2 + (cx >> 3), (cy >> 2) * 4 + (cx >> 2)
                        cl = 0 if cm.ref[0][c8] >= 0 else 1
                        ref_col, mv_col, pic_col = cm.ref[cl][c8], cm.mv[cl][c4], cm.refpic[cl][c8]
                    if self.spatial:
                        zero = (col["long"] is None and ref_col == 0 and abs(mv_col[0]) <= 1
                                and abs(mv_col[1]) <= 1)
                        flags = sum(1 << lx for lx in range(2) if sref[lx] >= 0)
                        mvs = [(0, 0) if sref[lx] < 0 or (sref[lx] == 0 and zero) else smv[lx]
                               for lx in range(2)]
                        self.stats["col_zero"] += zero
                        out.append((x, y, step, flags, list(sref), mvs))
                        continue
                    r0 = 0
                    if ref_col >= 0:
                        hits = [k for k, p in enumerate(self.list0) if p["uid"] == pic_col]
                        if not hits:
                            return None
                        r0 = hits[0]
                        # FFmpeg finds the co-located block's reference in
                        # list 0 by frame_num: keep that one to a picture
                        if any(p["fn"] == self.list0[r0]["fn"] for p in self.list0[:r0]):
                            return None
                    p0 = self.list0[r0]
                    td = min(max(col["poc"] - p0["poc"], -128), 127)
                    v0 = mv_col
                    if p0["long"] is None and td != 0:
                        tb = min(max(self.poc - p0["poc"], -128), 127)
                        tx = int((16384 + abs(int(td / 2))) / td)
                        dsf = min(max((tb * tx + 32) >> 6, -1024), 1023)
                        v0 = tuple((dsf * c + 128) >> 8 for c in mv_col)
                    v1 = (v0[0] - mv_col[0], v0[1] - mv_col[1])
                    if any(abs(v[0]) > MV_LIMIT[0] or abs(v[1]) > MV_LIMIT[1] for v in (v0, v1)):
                        return None
                    out.append((x, y, step, 3, [r0, 0], [v0, v1]))
        return out

    def apply_direct(self, m, blocks) -> None:
        mode = "spatial" if self.spatial else "temporal"
        for x, y, size, flags, refs, mvs in blocks:
            b8 = (y >> 3) * 2 + (x >> 3)
            m.direct[b8] = True
            self.stats[f"direct_{mode}{self.f['direct8x8']}"] += 1
            self.weight_stats(flags, refs)
            for lx in range(2):
                m.ref[lx][b8] = refs[lx]
                m.refpic[lx][b8] = self.lists[lx][refs[lx]]["uid"] if refs[lx] >= 0 else None
                for yy in range(y, y + size, 4):
                    for xx in range(x, x + size, 4):
                        m.mv[lx][(yy >> 2) * 4 + (xx >> 2)] = mvs[lx]

    def weight_stats(self, flags: int, refs) -> None:
        """Count what the weighted prediction of a partition exercises: in
        implicit mode (8.4.2.3.1) a single list (default prediction), a pair
        of weights, or the fall-back to 32 / 32."""
        bipred = self.f["bipred"]
        if bipred == 1:
            self.stats["explicit_bi" if flags == 3 else f"explicit_l{flags - 1}"] += 1
        if bipred != 2:
            return
        if flags != 3:
            self.stats["implicit_single"] += 1
            return
        p0, p1 = self.lists[0][refs[0]], self.lists[1][refs[1]]
        td = min(max(p1["poc"] - p0["poc"], -128), 127)
        fallback = p0["long"] is not None or p1["long"] is not None or td == 0
        if not fallback:
            tb = min(max(self.poc - p0["poc"], -128), 127)
            dsf = min(max((tb * int((16384 + abs(int(td / 2))) / td) + 32) >> 6, -1024), 1023)
            fallback = not -64 <= dsf >> 2 <= 128
        self.stats["implicit_fallback" if fallback else "implicit_bi"] += 1

    def target_mv(self, x, y, w, h, pred):
        """A vector for the partition: the predictor nudged, or a fresh one
        anywhere up to MV_OUTSIDE samples outside the picture, in quarter
        samples."""
        rng, r = self.rng, MV_OUTSIDE
        lo_x, hi_x = -4 * (r + 16 * self.mbx + x), 4 * (r + self.w - 16 * self.mbx - x - w)
        lo_y, hi_y = -4 * (r + 16 * self.mby + y), 4 * (r + self.h - 16 * self.mby - y - h)
        if rng.random() < 0.4:
            tx, ty = pred[0] + int(rng.integers(-6, 7)), pred[1] + int(rng.integers(-6, 7))
        else:
            tx, ty = int(rng.integers(lo_x, hi_x + 1)), int(rng.integers(lo_y, hi_y + 1))
        if self.f["whole_mv"]:
            tx, ty = tx & ~3, ty & ~3
        return min(max(tx, lo_x), hi_x), min(max(ty, lo_y), hi_y)

    def write_ref(self, m, x, y, r, w, h, ref0, lx=0):
        """ref_idx_lX of a partition; the CABAC context counts a neighbour
        that is skipped, intra, direct or not using the list as 0."""
        n_ref = len(self.lists[lx]) if lx else len(self.list0)
        if not (ref0 or n_ref == 1):
            if self.cabac:
                cond = []
                for xn, yn in ((x - 1, y), (x, y - 1)):
                    loc = self.locate(xn, yn)
                    if loc is None:
                        cond.append(0)
                        continue
                    n, xw, yw = loc
                    b8 = (yw >> 3) * 2 + (xw >> 3)
                    if (n is not self.cur and (n.kind in SKIP_KINDS or n.intra)) or n.direct[b8]:
                        cond.append(0)
                        continue
                    cond.append(int(n.ref[lx][b8] > 0))
                c = self.cabac
                ctx = 54 + cond[0] + 2 * cond[1]
                for k in range(r):
                    c.bin(ctx, 1)
                    ctx = 54 + (4 if k == 0 else 5)
                c.bin(ctx, 0)
            elif n_ref == 2:
                self.bw.u(1, 1 - r)
            else:
                self.bw.ue(r)
        for yy in range(y, y + max(h, 8), 8):
            for xx in range(x, x + max(w, 8), 8):
                m.ref[lx][(yy >> 3) * 2 + (xx >> 3)] = r

    def write_mvd(self, x, y, comp, d, lx=0):
        s = 0
        for xn, yn in ((x - 1, y), (x, y - 1)):
            loc = self.locate(xn, yn)
            if loc is None:
                continue
            n, xw, yw = loc
            if n is not self.cur and (n.kind in SKIP_KINDS or n.intra):
                continue
            s += n.mvd[lx][(yw >> 2) * 4 + (xw >> 2)][comp]
        base = 40 if comp == 0 else 47
        c = self.cabac
        inc = 0 if s < 3 else (2 if s > 32 else 1)
        a = abs(d)
        c.bin(base + inc, int(a > 0))
        if a == 0:
            return
        v = 1
        while v < 9:
            c.bin(base + (6 if v >= 4 else v + 2), int(a > v))
            if a == v:
                break
            v += 1
        if a >= 9:
            rest, k = a - 9, 3
            while rest >= (1 << k):
                c.bypass(1)
                rest -= 1 << k
                k += 1
            c.bypass(0)
            for j in range(k - 1, -1, -1):
                c.bypass((rest >> j) & 1)
        c.bypass(int(d < 0))

    # ── QP and residual ──
    def qp_and_residual(self, m):
        f, rng = self.f, self.rng
        m.qp_delta = 0
        if (m.cbp & 0x3F) or m.kind == "I16":
            lo, hi = f["qp"]
            want = int(np.clip(self.qp + rng.integers(-f["qp_delta"], f["qp_delta"] + 1), lo, hi))
            if rng.random() < 0.5:
                want = self.qp
            delta = want - self.qp
            if delta > 25:                            # mb_qp_delta is -26..25
                want, delta = want - 1, 25
            if self.cabac:
                p = self.prev_mb
                inc = 0
                if p is not None:
                    inc = int(not (p.kind in ("PSKIP", "BSKIP", "IPCM") or p.qp_delta == 0
                                   or (p.kind != "I16" and (p.cbp & 0x3F) == 0)))
                k = 2 * delta - 1 if delta > 0 else -2 * delta
                c = self.cabac
                c.bin(60 + inc, int(k > 0))
                if k > 0:
                    ctx = 62
                    for _ in range(k - 1):
                        c.bin(ctx, 1)
                        ctx = 63
                    c.bin(ctx, 0)
            else:
                self.bw.se(delta)
            m.qp_delta = delta
            self.qp = want
        m.qp = self.qp
        if (m.cbp & 0x3F) or m.kind == "I16":
            self.residual(m)

    def levels(self, n: int, qp_scale_ok) -> list[int]:
        """n random sparse levels in scan order, shrunk until `qp_scale_ok`
        accepts them."""
        rng, f = self.rng, self.f
        dens = f["density"] * rng.random() * 2
        mask = rng.random(n) < dens
        mag = np.where(rng.random(n) < 0.7, 1, rng.integers(1, 6, n))
        if f["big"] and rng.random() < f["big"]:      # one large level: CAVLC's escapes
            k = int(rng.integers(n))
            mask[k], mag[k] = True, int(rng.integers(500, 3300))
        lv = (mag * np.where(rng.random(n) < 0.5, -1, 1) * mask).astype(np.int64)
        while not qp_scale_ok(lv):
            lv = np.where(np.abs(lv) > 1, lv // 2, np.where(rng.random(n) < 0.5, 0, lv))
        return [int(v) for v in lv]

    def residual(self, m):
        qp, intra, i16 = m.qp, m.intra, m.kind == "I16"
        ls = self.ls4[0 if intra else 3, qp % 6]
        scaled_dc = np.zeros(16, np.int64)
        if i16:
            ls_dc = int(self.ls4[0, qp % 6, 0])
            dc = self.levels(16, lambda lv: np.abs(luma_dc_scaled(lv, ls_dc, qp)).max()
                             <= SCALED_SUM_LIMIT // 4)
            scaled_dc = luma_dc_scaled(dc, ls_dc, qp)
            m.cbf_dc[0] = self.block(0, dc, 16, self.cbf_luma(0, True), lambda: self.luma_nc(0)) > 0
        for b8 in range(4):
            if not (m.cbp >> b8) & 1:
                continue
            if m.t8x8:
                ls8 = self.ls8[0 if intra else 1, qp % 6]
                lv = self.levels(64, lambda lv: scaled_sum(lv, T.ZIGZAG8, ls8, qp, True)
                                 <= SCALED_SUM_LIMIT)
                if not any(lv):
                    # CABAC codes no empty 8x8 block; with CAVLC FFmpeg takes a
                    # coded but empty one as having coefficients in the
                    # deblocking filter's bS (8.7.2.1 says it has none), so the
                    # writer codes none, as no encoder does
                    lv[int(self.rng.integers(64))] = 1
                if self.cabac:
                    n = self.block(5, lv, 64, None, None)
                    for i4 in range(4):
                        m.nz[BLK_RASTER[b8 * 4 + i4]] = n
                else:                                 # four interleaved 4x4 blocks
                    for i4 in range(4):
                        r = BLK_RASTER[b8 * 4 + i4]
                        m.nz[r] = self.block(2, lv[i4::4], 16, None, lambda: self.luma_nc(r))
                continue
            for i4 in range(4):
                r = BLK_RASTER[b8 * 4 + i4]
                if i16:                               # AC: scan positions 1-15
                    lv = self.levels(15, lambda lv: scaled_sum(
                        lv, T.ZIGZAG4[1:], ls, qp, False, scaled_dc[r]) <= SCALED_SUM_LIMIT)
                else:
                    lv = self.levels(16, lambda lv: scaled_sum(lv, T.ZIGZAG4, ls, qp, False)
                                     <= SCALED_SUM_LIMIT)
                m.nz[r] = self.block(1 if i16 else 2, lv, len(lv), self.cbf_luma(r, False),
                                     lambda: self.luma_nc(r))
        chroma = m.cbp >> 4
        if not chroma:
            return
        dcs = []
        for c in range(2):
            qpc = int(T.QPC[min(max(qp + self.f["chroma_offsets"][c], 0), 51)])
            lsc = self.ls4[(1 if intra else 4) + c, qpc % 6]
            dc = self.levels(4, lambda lv: np.abs(chroma_dc_scaled(lv, int(lsc[0]), qpc)).max()
                             <= SCALED_SUM_LIMIT // 4)
            dcs.append((chroma_dc_scaled(dc, int(lsc[0]), qpc), lsc, qpc))
            m.cbf_dc[1 + c] = self.block(3, dc, 4, self.cbf_chroma(c, 0, True), lambda: -1) > 0
        if chroma < 2:
            return
        for c, (sdc, lsc, qpc) in enumerate(dcs):
            for b in range(4):
                lv = self.levels(15, lambda lv: scaled_sum(
                    lv, T.ZIGZAG4[1:], lsc, qpc, False, sdc[b]) <= SCALED_SUM_LIMIT)
                m.nzc[c][b] = self.block(4, lv, 15, self.cbf_chroma(c, b, False),
                                         lambda: self.chroma_nc(c, b))

    def luma_nc(self, raster):
        x, y = (raster & 3) * 4, (raster >> 2) * 4
        got = []
        for xn, yn in ((x - 1, y), (x, y - 1)):
            loc = self.locate(xn, yn)
            if loc is not None:
                n, xw, yw = loc
                got.append(n.nz[(yw >> 2) * 4 + (xw >> 2)])
        return (got[0] + got[1] + 1) >> 1 if len(got) == 2 else (got[0] if got else 0)

    def chroma_nc(self, c, blk):
        bx, by = blk & 1, blk >> 1
        got = []
        if bx:
            got.append(self.cur.nzc[c][by * 2])
        elif self.nb_a() is not None:
            got.append(self.nb_a().nzc[c][by * 2 + 1])
        if by:
            got.append(self.cur.nzc[c][bx])
        elif self.nb_b() is not None:
            got.append(self.nb_b().nzc[c][2 + bx])
        return (got[0] + got[1] + 1) >> 1 if len(got) == 2 else (got[0] if got else 0)

    def cbf_luma(self, raster, dc):
        if not self.cabac:
            return None
        x, y = (raster & 3) * 4, (raster >> 2) * 4
        cond = []
        for xn, yn in ((x - 1, y), (x, y - 1)):
            loc = self.locate(xn, yn)
            if loc is None:
                cond.append(int(self.cur.intra))
                continue
            n, xw, yw = loc
            if n.kind == "IPCM":
                cond.append(1)
            elif dc:
                cond.append(int(n.cbf_dc[0]) if n.kind == "I16" else 0)
            elif n.kind in SKIP_KINDS:
                cond.append(0)
            elif not (n.cbp >> ((yw >> 3) * 2 + (xw >> 3))) & 1:
                cond.append(0)
            else:
                cond.append(int(n.nz[(yw >> 2) * 4 + (xw >> 2)] != 0))
        return cond[0] + 2 * cond[1]

    def cbf_chroma(self, c, blk, dc):
        if not self.cabac:
            return None
        bx, by = blk & 1, blk >> 1
        cond = []
        for k in range(2):
            if dc:
                n, nb = (self.nb_a() if k == 0 else self.nb_b()), 0
            elif k == 0:
                n, nb = (self.cur if bx else self.nb_a()), by * 2 + (0 if bx else 1)
            else:
                n, nb = (self.cur if by else self.nb_b()), (0 if by else 2) + bx
            if n is None:
                cond.append(int(self.cur.intra))
            elif n.kind == "IPCM":
                cond.append(1)
            elif n.kind in SKIP_KINDS:
                cond.append(0)
            elif dc:
                cond.append(int(n.cbf_dc[1 + c]) if (n.cbp >> 4) else 0)
            else:
                cond.append(int(n.nzc[c][nb] != 0) if (n.cbp >> 4) == 2 else 0)
        return cond[0] + 2 * cond[1]

    def block(self, cat, levels, maxnum, cbf_inc, nc) -> int:
        """One residual block; returns the count of non-zero levels."""
        count = sum(1 for v in levels if v)
        if self.cabac:
            self.cabac_block(cat, levels, maxnum, cbf_inc)
        else:
            self.cavlc_block(levels, maxnum, nc())
        return count

    def cabac_block(self, cat, levels, maxnum, cbf_inc):
        c = self.cabac
        cbf_off, sig_off, abs_off = (0, 4, 8, 12, 16), (0, 15, 29, 44, 47), (0, 10, 20, 30, 39)
        nz = [i for i, v in enumerate(levels) if v]
        if cbf_inc is not None:
            c.bin(85 + cbf_off[cat] + cbf_inc, int(bool(nz)))
        if not nz:
            return
        last = nz[-1]
        for i in range(min(last + 1, maxnum - 1)):
            sctx = 402 + int(T.SIG8_CTX[i]) if cat == 5 else 105 + sig_off[cat] + i
            c.bin(sctx, int(levels[i] != 0))
            if levels[i]:
                lctx = 417 + int(T.LAST8_CTX[i]) if cat == 5 else 166 + sig_off[cat] + i
                c.bin(lctx, int(i == last))
        base = 426 if cat == 5 else 227 + abs_off[cat]
        gt1 = eq1 = 0
        for i in reversed(nz):
            a = abs(levels[i]) - 1
            inc0 = 0 if gt1 else min(4, 1 + eq1)
            c.bin(base + inc0, int(a > 0))
            if a > 0:
                ctx = base + 5 + min(4 - (cat == 3), gt1)
                v = 1
                while v < 14:
                    c.bin(ctx, int(a > v))
                    if a == v:
                        break
                    v += 1
                if a >= 14:
                    rest, k = a - 14, 0
                    while rest >= (1 << k):
                        c.bypass(1)
                        rest -= 1 << k
                        k += 1
                    c.bypass(0)
                    for j in range(k - 1, -1, -1):
                        c.bypass((rest >> j) & 1)
            if a > 0:
                gt1 += 1
            else:
                eq1 += 1
            c.bypass(int(levels[i] < 0))

    def cavlc_block(self, levels, maxnum, nc):
        bw = self.bw
        table = 4 if nc < 0 else (0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3)
        nz = [i for i, v in enumerate(levels) if v]
        total = len(nz)
        rev = [levels[i] for i in reversed(nz)]
        t1 = 0
        for v in rev[:3]:
            if abs(v) != 1:
                break
            t1 += 1
        bw.u(int(T.CT_LEN[table, total, t1]), int(T.CT_CODE[table, total, t1]))
        if total == 0:
            return
        for v in rev[:t1]:
            bw.u(1, int(v < 0))
        sl = 1 if total > 10 and t1 < 3 else 0
        high = self.f["profile"] == 100
        for i in range(t1, total):
            v = rev[i]
            code = 2 * v - 2 if v > 0 else -2 * v - 1
            if i == t1 and t1 < 3:
                code -= 2
            if sl == 0 and code < 14:
                bw.u(code + 1, 1)
            elif sl == 0 and code < 30:
                bw.u(15, 1)
                bw.u(4, code - 14)
            elif sl > 0 and code < (15 << sl):
                bw.u((code >> sl) + 1, 1)
                bw.u(sl, code & ((1 << sl) - 1))
            else:
                rem = code - (15 << sl) - (15 if sl == 0 else 0)
                prefix = 15
                while rem >= (1 << (prefix - 2)) - 4096:
                    prefix += 1
                assert prefix == 15 or high, "level_prefix > 15 outside High profile"
                self.stats[f"level_prefix{prefix}"] += 1
                bw.u(prefix + 1, 1)
                bw.u(prefix - 3, rem - ((1 << (prefix - 3)) - 4096))
            if sl == 0:
                sl = 1
            if abs(v) > (3 << (sl - 1)) and sl < 6:
                sl += 1
        last = nz[-1]
        zeros = last + 1 - total
        if total < maxnum:
            if maxnum == 4:
                bw.u(int(T.TZC_LEN[total - 1, zeros]), int(T.TZC_CODE[total - 1, zeros]))
            else:
                bw.u(int(T.TZ_LEN[total - 1, zeros]), int(T.TZ_CODE[total - 1, zeros]))
        left = zeros
        pos = list(reversed(nz))
        for i in range(total - 1):
            if left <= 0:
                break
            run = pos[i] - pos[i + 1] - 1
            r = min(left, 7) - 1
            bw.u(int(T.RB_LEN[r, run]), int(T.RB_CODE[r, run]))
            left -= run


def write_stream(seed: int, **features) -> list[list[bytes]]:
    """The NAL units of each access unit of a random stream (the first one
    opens with the parameter sets); see the module's docstring."""
    return Writer(seed, **features).stream()


def annexb(aus: list[list[bytes]]) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + u for au in aus for u in au)


# ── QuickTime / MP4 files of the streams ────────────────────────────────

def _box(typ: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + typ + body


def _full(typ: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(typ, struct.pack(">I", version << 24 | flags), *parts)


def display_matrix(rotation: int, width: int, height: int) -> bytes:
    """tkhd's matrix for a clockwise display rotation of 0, 90, 180 or 270
    degrees, as phones write it (a b u / c d v / tx ty w)."""
    one, w = 0x10000, 0x40000000
    a, b, c, d, tx, ty = {0: (one, 0, 0, one, 0, 0), 90: (0, one, -one, 0, height, 0),
                          180: (-one, 0, 0, -one, width, height),
                          270: (0, -one, one, 0, 0, width)}[rotation]
    return struct.pack(">9i", a, b, 0, c, d, 0, tx << 16, ty << 16, w)


def write_mov(path, aus: list[list[bytes]], width: int, height: int, fps: int = 30,
              rotation: int = 0, audio: bool = True, quicktime: bool = True,
              media_time: int | None = 0, sample_entry: bytes = b"avc1",
              display: list[int] | None = None, boxes: bytes = b"") -> None:
    """A phone-like file of the access units: QuickTime (`qt  ` brand, a
    `wide` atom) or MP4, the video track with an edit list starting at
    `media_time` (track ticks; None: no edit list) and tkhd's display matrix
    for `rotation`, and a silent 16-bit stereo `sowt` sound track beside it.
    Parameter sets go to the avcC box (`avc1`) or stay in band (`avc3`).
    `display`, each access unit's place in output order, adds `ctts` as
    FFmpeg's mov muxer lays out a stream with B pictures: decoding times a
    frame apart from 0, composition offsets (version 0) that shift the
    earliest picture shown by the reorder delay; its edit list then starts at
    that delay (`media_time` "ctts": the first sample's offset).  `boxes`
    follow the avcC box in the sample entry (`colr`, `mdcv`, `clli`)."""
    sps = [u for au in aus for u in au if u[0] & 0x1F == 7]
    pps = [u for au in aus for u in au if u[0] & 0x1F == 8]
    in_band = sample_entry == b"avc3"
    samples, sync = [], []
    for i, au in enumerate(aus):
        units = [u for u in au if in_band or u[0] & 0x1F not in (7, 8)]
        samples.append(b"".join(struct.pack(">I", len(u)) + u for u in units))
        if any(u[0] & 0x1F == 5 for u in au):
            sync.append(i + 1)
    avcc = bytes([1, sps[0][1], sps[0][2], sps[0][3], 0xFF, 0xE0 | (0 if in_band else len(sps))])
    if not in_band:
        avcc += b"".join(struct.pack(">H", len(u)) + u for u in sps)
    avcc += bytes([0 if in_band else len(pps)])
    if not in_band:
        avcc += b"".join(struct.pack(">H", len(u)) + u for u in pps)
    write_track_file(path, samples, sync, sample_entry, _box(b"avcC", avcc) + boxes, width,
                     height, fps, rotation, audio, quicktime, media_time, display)


def write_track_file(path, samples: list[bytes], sync: list[int], sample_entry: bytes,
                     config: bytes, width: int, height: int, fps: int = 30, rotation: int = 0,
                     audio: bool = True, quicktime: bool = True, media_time: int | None = 0,
                     display: list[int] | None = None) -> None:
    """The file `write_mov` describes, of length-prefixed samples (`sync`:
    the 1-based numbers of the sync samples), the sample entry's codec
    configuration box `config` (avcC, hvcC) given whole."""
    timescale, delta = 600 * fps, 600
    offsets_ct = None
    if display is not None:
        delay = max(k - d for k, d in enumerate(display))
        offsets_ct = [(d + delay - k) * delta for k, d in enumerate(display)]
    if media_time == "ctts":
        media_time = offsets_ct[0]
    n = len(samples)
    rate, channels = 48000, 2
    audio_bytes = bytes(rate * channels * 2 * n // fps) if audio else b""
    head = _box(b"ftyp", b"qt  ", struct.pack(">I", 0x20050300), b"qt  ") if quicktime \
        else _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2avc1mp41")
    wide = _box(b"wide") if quicktime else b""
    mdat_start = len(head) + len(wide)
    video_at = mdat_start + 8
    audio_at = video_at + sum(len(s) for s in samples)
    mdat = _box(b"mdat", *samples, audio_bytes)
    entry = _box(sample_entry, bytes(6), struct.pack(">H", 1), bytes(16),
                 struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1), bytes(32),
                 struct.pack(">Hh", 0x18, -1), config)
    offsets, pos = [], video_at
    for s in samples:
        offsets.append(pos)
        pos += len(s)
    ctts = b"" if offsets_ct is None else _full(
        b"ctts", 0, 0, struct.pack(f">I{2 * n}I", n, *[v for o in offsets_ct for v in (1, o)]))
    vstbl = _box(b"stbl", _full(b"stsd", 0, 0, struct.pack(">I", 1), entry),
                 _full(b"stts", 0, 0, struct.pack(">III", 1, n, delta)), ctts,
                 _full(b"stss", 0, 0, struct.pack(f">I{len(sync)}I", len(sync), *sync)),
                 _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1)),
                 _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *[len(s) for s in samples])),
                 _full(b"stco", 0, 0, struct.pack(f">I{n}I", n, *offsets)))
    dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)))
    duration_ms = n * 1000 // fps
    movie_scale = 1000
    elst = b"" if media_time is None else _box(b"edts", _full(
        b"elst", 0, 0, struct.pack(">IIiI", 1, duration_ms, media_time, 0x10000)))
    vtrak = _box(b"trak",
                 _full(b"tkhd", 0, 3, struct.pack(">IIIII8xhhhH", 0, 0, 1, 0, duration_ms, 0, 0,
                                                   0, 0), display_matrix(rotation, width, height),
                       struct.pack(">II", width << 16, height << 16)),
                 elst,
                 _box(b"mdia",
                      _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, n * delta,
                                                       0x55C4, 0)),
                      _full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"), b"\x00"),
                      _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)), dinf, vstbl)))
    traks = [vtrak]
    if audio:
        frames = len(audio_bytes) // (2 * channels)
        sentry = _box(b"sowt", bytes(6), struct.pack(">H", 1), bytes(8),
                      struct.pack(">HHHHI", channels, 16, 0, 0, rate << 16))
        astbl = _box(b"stbl", _full(b"stsd", 0, 0, struct.pack(">I", 1), sentry),
                     _full(b"stts", 0, 0, struct.pack(">III", 1, frames, 1)),
                     _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, frames, 1)),
                     _full(b"stsz", 0, 0, struct.pack(">II", 2 * channels, frames)),
                     _full(b"stco", 0, 0, struct.pack(">II", 1, audio_at)))
        traks.append(_box(b"trak",
                          _full(b"tkhd", 0, 3, struct.pack(">IIIII8xhhhH", 0, 0, 2, 0, duration_ms,
                                                           0, 0, 0x100, 0),
                                display_matrix(0, 0, 0), struct.pack(">II", 0, 0)),
                          _box(b"mdia",
                               _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, rate, frames,
                                                                0x55C4, 0)),
                               _full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"soun"), b"\x00"),
                               _box(b"minf", _full(b"smhd", 0, 0, bytes(4)), dinf, astbl))))
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIIIIH10x", 0, 0, movie_scale, duration_ms, 0x10000,
                                            0x100), display_matrix(0, 0, 0), bytes(24),
                 struct.pack(">I", 3))
    with open(path, "wb") as f:
        f.write(head + wide + mdat + _box(b"moov", mvhd, *traks))


def vui_colour(colour) -> tuple[int, int, int, int] | None:
    """`colour` as (full range, colour_primaries, transfer_characteristics,
    matrix_coefficients); (full range, m) is shorthand for (full range, m, m,
    m)."""
    if colour is None:
        return None
    return tuple(colour) if len(colour) == 4 else (colour[0], colour[1], colour[1], colour[1])


def sei_rbsp(messages) -> bytes:
    """An SEI RBSP (H.264's and HEVC's alike) of (payloadType, payload
    bytes) messages."""
    out = bytearray()
    for kind, payload in messages:
        for value in (kind, len(payload)):
            out += b"\xff" * (value // 255) + bytes([value % 255])
        out += payload
    return bytes(out) + b"\x80"


def mastering_payload(max_nits: float, min_nits: float,
                      primaries=((0.170, 0.797), (0.131, 0.046), (0.708, 0.292)),
                      white=(0.3127, 0.3290)) -> bytes:
    """A mastering display colour volume (SEI payloadType 137 and the
    body of an `mdcv` box): G, B, R primaries and white in units of
    0.00002, luminance in units of 0.0001 cd/m^2."""
    xy = [round(v / 0.00002) for pair in (*primaries, white) for v in pair]
    return struct.pack(">8H2I", *xy, round(max_nits * 10000), round(min_nits * 10000))


def light_level_payload(max_cll: int, max_fall: int) -> bytes:
    """Content light level information (SEI payloadType 144, a `clli` box's
    body), cd/m^2."""
    return struct.pack(">HH", max_cll, max_fall)


def pcm_stream(planes, colour=None, fps: int = 25, bit_depth: int = 8, sei=()) -> bytes:
    """An Annex B stream of (Y', Cb, Cr) pictures, each an IDR of one slice of
    I_PCM macroblocks (the samples themselves), cropped to their size, its
    VUI giving `colour` (`vui_colour`) as a coded stream's does: cv2 then
    converts both alike, and its decodes compare bit for bit.  At
    `bit_depth` 9 or 10 the stream is High 10 (profile_idc 110) and its PCM
    samples have that many bits.  `sei`, (payloadType, payload) messages,
    go in an SEI unit before the first picture."""
    h, w = planes[0][0].shape
    mbw, mbh = -(-w // 16), -(-h // 16)
    colour = vui_colour(colour)
    bw = BitWriter()
    for v in ((66, 0xC0, 40) if bit_depth == 8 else (110, 0, 40)):
        bw.u(8, v)
    bw.ue(0)                                   # sps id
    if bit_depth != 8:
        for v in (1, bit_depth - 8, bit_depth - 8):     # 4:2:0, the depths
            bw.ue(v)
        bw.u(2, 0)                             # no transform bypass, no scaling matrix
    for v in (0, 2, 1):                        # frame_num, POC type 2, 1 ref
        bw.ue(v)
    bw.u(1, 0)
    bw.ue(mbw - 1)
    bw.ue(mbh - 1)
    bw.u(2, 3)
    crop_r, crop_b = (16 * mbw - w) // 2, (16 * mbh - h) // 2
    bw.u(1, crop_r > 0 or crop_b > 0)
    if crop_r or crop_b:
        for v in (0, crop_r, 0, crop_b):
            bw.ue(v)
    bw.u(1, 1)
    bw.u(2, 0)
    bw.u(1, colour is not None)
    if colour is not None:
        bw.u(3, 5)
        bw.u(1, colour[0])
        bw.u(1, 1)
        for v in colour[1:]:
            bw.u(8, v)
    bw.u(1, 0)
    bw.u(1, 1)
    bw.u(32, 1)
    bw.u(32, 2 * fps)
    bw.u(1, 1)
    bw.u(4, 0)
    bw.trailing()
    units = [nal(3, 7, bw.data())]
    bw = BitWriter()
    for v in (0, 0):
        bw.ue(v)
    bw.u(2, 0)
    for v in (0, 0, 0):
        bw.ue(v)
    bw.u(3, 0)
    for v in (0, 0, 0):
        bw.se(v)
    bw.u(3, 0)
    bw.trailing()
    units.append(nal(3, 8, bw.data()))
    if sei:
        units.append(nal(0, 6, sei_rbsp(sei)))
    for k, (y, cb, cr) in enumerate(planes):
        y = np.pad(y, ((0, 16 * mbh - h), (0, 16 * mbw - w)), mode="edge")
        cb, cr = (np.pad(c, ((0, 8 * mbh - h // 2), (0, 8 * mbw - w // 2)), mode="edge")
                  for c in (cb, cr))
        bw = BitWriter()
        bw.ue(0)
        bw.ue(7)
        bw.ue(0)
        bw.u(4, 0)
        bw.ue(k % 2)                             # idr_pic_id
        bw.u(2, 0)                               # marking
        bw.se(0)                                 # slice_qp_delta
        for m in range(mbw * mbh):
            r, c = divmod(m, mbw)
            bw.ue(25)
            bw.align_zero()
            samples = np.concatenate([y[16 * r:16 * r + 16, 16 * c:16 * c + 16].ravel(),
                                      cb[8 * r:8 * r + 8, 8 * c:8 * c + 8].ravel(),
                                      cr[8 * r:8 * r + 8, 8 * c:8 * c + 8].ravel()])
            if bit_depth == 8:
                bw.buf += samples.astype(np.uint8).tobytes()
            else:                                # 384 samples of bit_depth bits: whole bytes
                bits = (samples.astype(np.int64)[:, None] >> np.arange(bit_depth - 1, -1, -1)) & 1
                bw.buf += np.packbits(bits.astype(np.uint8).ravel()).tobytes()
        bw.trailing()
        units.append(nal(3, 5, bw.data()))
    return b"".join(b"\x00\x00\x00\x01" + u for u in units)
