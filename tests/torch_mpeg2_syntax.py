"""A random legal-syntax writer of MPEG-1 video (ISO/IEC 11172-2) and MPEG-2
video (ISO/IEC 13818-2, Main profile 4:2:0) for the port's decoder tests,
and test muxers of MPEG program streams around it.

`write_stream(seed, plan, **options)` writes an elementary stream whose
syntax elements are drawn at random within what the standard allows and
FFmpeg decodes as the standard says: every macroblock type of I, P and B
pictures, skipped macroblocks (never after an intra one in a B picture),
quantiser changes (linear or non-linear `q_scale_type`), DC of every
`intra_dc_precision`, Tables B.14 / B.15 (`intra_vlc_format`) with their
escapes (MPEG-1's 8 / 16-bit, MPEG-2's 12-bit), zigzag and alternate scans,
loaded matrices (sequence header and quant matrix extension, chroma too),
concealment vectors, frame and field pictures of an interlaced sequence
with frame, field, 16x8 and dual-prime prediction and field DCT, MPEG-1
slices spanning rows, macroblock stuffing, `full_pel` vectors, closed and
open GOPs and pulldown flags.  Every motion vector is drawn so that the
block it fetches lies inside the reference's macroblocks (FFmpeg skips the
prediction of one that does not); levels stay where the dequantised
coefficients fit the IDCT's 16 bits.  The writer decides syntax only: the
pictures are whatever the decoder makes of it, held to cv2's decode.

`plan` lists the pictures in coded order: "I", "P", "B" a frame picture,
"C" a P frame picture that copies its reference (every macroblock forward
predicted by the zero vector, no residual: cv2 then shows the reference
frame as decoded, which it does not for a field pair itself);
two letters in brackets a field pair ("[IP]": an I field then a P field, of
an interlaced sequence); "|" starts a new GOP (sequence header, GOP header)
before the next picture; "o" marks that GOP open (`closed_gop` 0).
`Stream.packets` are the pictures as FFmpeg's parser cuts them (headers
with the picture after them).

`write_ps(path, packets, ...)` lays the packets into an MPEG-1 system
stream or an MPEG-2 program stream: a pack header before each PES, a
system header after the first, optionally a program stream map, padding
and private stream 1 / 2 packets (a DVD's audio and navigation packs) and
PES headers with or without the MPEG-1 STD buffer field.
"""

from __future__ import annotations

import random
import struct
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _path in (HERE.parent, HERE):       # the repo, and this directory for its siblings by name
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

from omfs4d_torch.io import mpeg2_tables as T  # noqa: E402

FRAME, TOP, BOTTOM = 3, 1, 2


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def u(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.bits.append(v >> k & 1)

    def code(self, table, index: int) -> None:
        c, n = (int(x) for x in table[index])
        self.u(c, n)

    def align(self) -> None:
        while len(self.bits) % 8:
            self.bits.append(0)

    def start(self, code: int) -> None:
        self.align()
        self.u(0x000001, 24)
        self.u(code, 8)

    def bytes(self) -> bytes:
        self.align()
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            v = 0
            for b in self.bits[i:i + 8]:
                v = v << 1 | b
            out.append(v)
        return bytes(out)


# the most the dequantised magnitudes of a block may sum to
BUDGET = 2900
# (run, |level|) -> index in B.14 / B.15
RL = {(int(r), int(lv)): k for k, (r, lv) in enumerate(zip(T.RUN, T.LEVEL))}


class Stream:
    """A written stream: its bytes, its packets (as FFmpeg's parser cuts
    them), its size and standard, and the tools its writer used."""

    def __init__(self, data: bytes, packets: list, width: int, height: int, mpeg2: bool,
                 stats: dict):
        self.data, self.packets, self.width, self.height = data, packets, width, height
        self.mpeg2, self.stats = mpeg2, stats


class Writer:
    """One stream's writer; `stats` counts the tools it used."""

    def __init__(self, seed: int, mpeg2: bool = True, width: int = 64, height: int = 48,
                 progressive: bool = True, skip: float = 0.2,
                 intra: float = 0.15, quant: float = 0.2, coded: float = 0.7,
                 big: float = 0.05, escape: float = 0.05, matrices: float = 0.3,
                 q_scale_type: float = 0.5, dc_precision=(0, 1, 2, 3), vlc_format: float = 0.5,
                 alternate: float = 0.5, frame_pred: float = 0.5, concealment: float = 0.3,
                 dual_prime: float = 0.2, f_code=(1, 2, 3, 4), far: float = 0.3,
                 full_pel: float = 0.0, slices: float = 0.3, stuffing: float = 0.1,
                 low_delay: int = 0, pulldown: float = 0.0, colour=None, frame_rate_code=3,
                 flag_progressive: bool = True, interlaced_first: bool = False):
        self.rng = random.Random(seed)
        self.mpeg2, self.w, self.h = mpeg2, width, height
        self.progressive = 1 if not mpeg2 else int(progressive)
        self.o = dict(skip=skip, intra=intra, quant=quant, coded=coded,
                      big=big, escape=escape, matrices=matrices, q_scale_type=q_scale_type,
                      dc_precision=dc_precision, vlc_format=vlc_format, alternate=alternate,
                      frame_pred=frame_pred, concealment=concealment, dual_prime=dual_prime,
                      f_code=f_code, far=far, full_pel=full_pel, slices=slices,
                      stuffing=stuffing, pulldown=pulldown)
        self.low_delay, self.colour, self.frame_rate_code = low_delay, colour, frame_rate_code
        # progressive_frame 1 on every picture, fields too (FFmpeg decodes
        # the same; cv2 5.0.0's swscale refuses to convert a frame FFmpeg
        # flags interlaced, so only so do its RGB frames show the decode)
        self.flag_progressive = flag_progressive
        # the first two pictures are flagged progressive all the same
        # (unless `interlaced_first`), so that the first shown is: cv2 shows
        # it in place of those flagged interlaced after it
        self.first = 0 if interlaced_first else 2
        self.mbw = (width + 15) // 16
        self.mbh = ((height + 31) // 32 * 2 if mpeg2 and not self.progressive
                    else (height + 15) // 16)
        self.stats: dict = {}
        self.intra_matrix = list(T.DEFAULT_INTRA_MATRIX)
        self.inter_matrix = [16] * 64
        self.chroma_intra = list(self.intra_matrix)
        self.chroma_inter = list(self.inter_matrix)

    def count(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n

    def chance(self, p: float) -> bool:
        return self.rng.random() < p

    # ── headers ──

    def _matrix(self, bw: BitWriter, intra: bool) -> list[int]:
        m = [self.rng.randint(1, 255) if self.chance(0.8) else self.rng.randint(8, 40)
             for _ in range(64)]
        if intra and self.chance(0.5):
            m[0] = 8
        for k in range(64):
            bw.u(m[k], 8)                           # zigzag order
        natural = [0] * 64
        for k in range(64):
            natural[int(T.ZIGZAG[k])] = m[k]
        if intra:
            natural[0] = 8                          # FFmpeg takes the intra DC as 8
        return natural

    def sequence(self, bw: BitWriter) -> None:
        bw.start(0xB3)
        bw.u(self.w & 0xFFF, 12)
        bw.u(self.h & 0xFFF, 12)
        bw.u(1, 4)
        bw.u(self.frame_rate_code, 4)
        bw.u(0x3FFFF, 18)
        bw.u(1, 1)
        bw.u(112, 10)
        bw.u(0, 1)
        if self.chance(self.o["matrices"]):
            bw.u(1, 1)
            self.intra_matrix = self._matrix(bw, True)
            self.count("load_intra")
        else:
            bw.u(0, 1)
            self.intra_matrix = list(T.DEFAULT_INTRA_MATRIX)
        self.chroma_intra = list(self.intra_matrix)
        if self.chance(self.o["matrices"]):
            bw.u(1, 1)
            self.inter_matrix = self._matrix(bw, False)
            self.count("load_inter")
        else:
            bw.u(0, 1)
            self.inter_matrix = [16] * 64
        self.chroma_inter = list(self.inter_matrix)
        if not self.mpeg2:
            return
        bw.start(0xB5)
        bw.u(1, 4)
        bw.u(0x48 if self.w <= 720 else 0x44, 8)
        bw.u(self.progressive, 1)
        bw.u(1, 2)
        bw.u(self.w >> 12, 2)
        bw.u(self.h >> 12, 2)
        bw.u(0, 12)
        bw.u(1, 1)
        bw.u(0, 8)
        bw.u(self.low_delay, 1)
        bw.u(0, 2)
        bw.u(0, 5)
        if self.colour is not None:
            bw.start(0xB5)
            bw.u(2, 4)
            bw.u(5, 3)
            bw.u(1, 1)
            for v in self.colour:
                bw.u(v, 8)
            bw.u(self.w, 14)
            bw.u(1, 1)
            bw.u(self.h, 14)
            self.count("display_ext")

    def quant_extension(self, bw: BitWriter) -> None:
        bw.start(0xB5)
        bw.u(3, 4)
        for which in ("intra", "inter", "chroma_intra", "chroma_inter"):
            if self.chance(0.5):
                bw.u(1, 1)
                m = self._matrix(bw, "intra" in which)
                if which == "intra":
                    self.intra_matrix = self.chroma_intra = m
                elif which == "inter":
                    self.inter_matrix = self.chroma_inter = m
                elif which == "chroma_intra":
                    self.chroma_intra = m
                else:
                    self.chroma_inter = m
                self.count(f"quant_ext_{which}")
            else:
                bw.u(0, 1)

    def gop(self, bw: BitWriter, closed: bool) -> None:
        bw.start(0xB8)
        bw.u(0, 1)
        bw.u(0, 5)
        bw.u(0, 6)
        bw.u(1, 1)
        bw.u(0, 6)
        bw.u(0, 6)
        bw.u(int(closed), 1)
        bw.u(0, 1)
        self.count("closed_gop" if closed else "open_gop")

    # ── pictures ──

    def picture(self, bw: BitWriter, kind: str, structure: int, first_field: bool,
                tff: int, last: bool, cur_first: bool) -> None:
        """One picture (a frame, or one field); `last`: a past reference
        exists (not FFmpeg's dummy); `cur_first`: the first field of this
        frame exists (the second field may predict from it)."""
        o, rng = self.o, self.rng
        self.copy = kind == "C"
        kind = "P" if self.copy else kind
        self.kind, self.structure, self.first_field = kind, structure, first_field
        ptype = "IPB".index(kind) + 1
        self.has_last, self.has_cur = last, cur_first
        bw.start(0x00)
        bw.u(rng.randint(0, 1023), 10)
        bw.u(ptype, 3)
        bw.u(0xFFFF, 16)
        self.f = [[1, 1], [1, 1]]
        self.full_pel = [0, 0]
        if not self.mpeg2:
            for d in range(ptype - 1):
                fp = int(self.chance(o["full_pel"]))
                fc = rng.choice(o["f_code"])
                bw.u(fp, 1)
                bw.u(fc, 3)
                self.f[d] = [fc, fc]
                self.full_pel[d] = fp
                if fp:
                    self.count("full_pel")
        else:
            for d in range(ptype - 1):
                bw.u(0, 1)
                bw.u(7, 3)
        bw.u(0, 1)
        self.dc_prec = 0
        self.q_scale_type = self.vlc_format = self.alternate = self.concealment = 0
        self.frame_pred = 1
        if self.mpeg2:
            for d in range(2):
                for k in range(2):
                    self.f[d][k] = rng.choice(o["f_code"]) if d < ptype - 1 else 15
            self.dc_prec = rng.choice(o["dc_precision"])
            self.frame_pred = 1 if self.progressive or self.copy else int(
                structure != FRAME or self.chance(o["frame_pred"]))
            self.concealment = int(self.chance(o["concealment"]))
            self.q_scale_type = int(self.chance(o["q_scale_type"]))
            self.vlc_format = int(self.chance(o["vlc_format"]))
            self.alternate = int(self.chance(o["alternate"]))
            progressive_frame = int(self.progressive or self.flag_progressive or self.first > 0
                                    or (structure == FRAME and self.chance(0.3)))
            self.first -= 1
            rff = int(structure == FRAME and progressive_frame and self.chance(o["pulldown"]))
            bw.start(0xB5)
            bw.u(8, 4)
            for d in range(2):
                for k in range(2):
                    bw.u(self.f[d][k], 4)
            bw.u(self.dc_prec, 2)
            bw.u(structure, 2)
            bw.u(tff if structure == FRAME and not self.progressive else
                 (rng.randint(0, 1) if rff and self.progressive else 0), 1)
            bw.u(self.frame_pred, 1)
            bw.u(self.concealment, 1)
            bw.u(self.q_scale_type, 1)
            bw.u(self.vlc_format, 1)
            bw.u(self.alternate, 1)
            bw.u(rff, 1)
            bw.u(progressive_frame, 1)
            bw.u(progressive_frame, 1)
            bw.u(0, 1)
            self.tff = tff
            for key, on in (("dc_prec%d" % self.dc_prec, 1), ("q_nonlinear", self.q_scale_type),
                            ("b15", self.vlc_format), ("alt_scan", self.alternate),
                            ("concealment", self.concealment), ("rff", rff),
                            ("field_pic", structure != FRAME),
                            ("frame_pred_0", not self.frame_pred)):
                if on:
                    self.count(key)
            if self.chance(0.15):
                self.quant_extension(bw)
        self.scan = T.ALTERNATE if self.alternate else T.ZIGZAG
        self.slices(bw)

    # ── motion: what FFmpeg fetches, and whether it lies inside ──

    def _inside(self, mx, my, field_based, is_16x8, h, y_mb, x_mb) -> bool:
        field_pic = self.structure != FRAME
        v_edge = (8 * self.mbh if field_pic else 16 * self.mbh) >> field_based
        h_edge = 16 * self.mbw
        half = field_based | is_16x8
        sx = x_mb * 16 + (mx >> 1)
        sy = (y_mb << (4 - half)) + (my >> 1)
        return 0 <= sx < max(h_edge - (mx & 1) - 15, 0) and 0 <= sy < max(
            v_edge - (my & 1) - h + 1, 0)

    def _pick(self, lo: int, hi: int) -> int:
        """A vector component in [lo, hi] (its f_code's range): near 0 mostly."""
        if self.chance(self.o["far"]):
            return self.rng.randint(lo, hi)
        return max(lo, min(hi, self.rng.randint(-12, 12)))

    def _range(self, fc: int) -> tuple[int, int]:
        return -(16 << (fc - 1)), (16 << (fc - 1)) - 1

    def _motion_code(self, bw: BitWriter, fc: int, pred: int, value: int) -> None:
        shift = fc - 1
        lo, hi = self._range(fc)
        delta = value - pred
        span = 32 << shift
        delta = (delta - lo) % span + lo                     # the wrap the decoder undoes
        if delta == 0:
            bw.code(T.MOTION, 0)
            self.count("mv_zero_code")
            return
        sign = int(delta < 0)
        a = abs(delta)
        if shift:
            code = ((a - 1) >> shift) + 1
            residual = (a - 1) & ((1 << shift) - 1)
        else:
            code, residual = a, 0
        bw.code(T.MOTION, code)
        bw.u(sign, 1)
        if shift:
            bw.u(residual, shift)
        self.count(f"fcode{fc}")

    # ── macroblocks ──

    def slices(self, bw: BitWriter) -> None:
        field_pic = self.structure != FRAME
        rows = self.mbh // 2 if field_pic else self.mbh
        total = rows * self.mbw
        # slice starts: each row's first MB, and some inside rows; MPEG-1
        # slices may also run on over rows
        starts = set()
        for r in range(rows):
            if self.mpeg2 or r == 0 or not self.chance(self.o["slices"]):
                starts.add(r * self.mbw)
            for x in range(1, self.mbw):
                if self.chance(self.o["slices"] / max(self.mbw, 1)):
                    starts.add(r * self.mbw + x)
        starts = sorted(starts)
        if not self.mpeg2 and any(s % self.mbw for s in starts) or len(starts) < rows:
            self.count("slice_mid_row")
        bounds = starts + [total]
        for a, b in zip(bounds, bounds[1:]):
            self.slice(bw, a, b)

    def slice(self, bw: BitWriter, first: int, end: int) -> None:
        field_pic = self.structure != FRAME
        row = first // self.mbw
        vpos = row
        if self.mpeg2 and self.mbh > 175:
            bw.start(1 + (vpos & 127))
            bw.u(vpos >> 7, 3)
        else:
            bw.start(1 + vpos)
        self.qcode = self.rng.randint(1, 31)
        bw.u(self.qcode, 5)
        if self.chance(0.1):
            bw.u(1, 1)
            bw.u(self.rng.randint(0, 255), 8)
            self.count("slice_extra")
        bw.u(0, 1)
        self.last_dc = [128 << self.dc_prec] * 3
        self.last_mv = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]
        self.prev_intra = True                      # no skip before the slice's first MB
        self.prev = None                            # what a skipped B MB would reuse
        n = end - first
        # which MBs are skipped: never the first or the last
        skipped = [False] * n
        if self.kind == "B" or (self.kind == "P" and self.has_last):
            for k in range(1, n - 1):
                skipped[k] = self.copy or self.chance(self.o["skip"])
        if self.chance(self.o["stuffing"]) and not self.mpeg2:
            bw.code(T.MB_INCREMENT, T.INCREMENT_STUFFING)
            self.count("stuffing")
        self._increment(bw, first % self.mbw + 1)
        k = 0
        while k < n:
            pos = first + k
            x, r = pos % self.mbw, pos // self.mbw
            self.macroblock(bw, x, (2 * r + (self.structure == BOTTOM)) if field_pic else r)
            k += 1
            if k == n:
                break
            # the run of skipped MBs before the next coded one
            run = 0
            while k + run < n - 1 and skipped[k + run] and self._skip_ok_at(first + k + run):
                run += 1
            if run:
                self.last_dc = [128 << self.dc_prec] * 3
                if self.kind == "P":
                    self.last_mv[0] = [[0, 0], [0, 0]]
                self.count("skipped_" + self.kind, run)
            if self.chance(self.o["stuffing"]) and not self.mpeg2:
                bw.code(T.MB_INCREMENT, T.INCREMENT_STUFFING)
                self.count("stuffing")
            self._increment(bw, run + 1)
            k += run
        bw.align()

    def _increment(self, bw: BitWriter, inc: int) -> None:
        while inc > 33:
            bw.code(T.MB_INCREMENT, T.INCREMENT_ESCAPE)
            inc -= 33
            self.count("incr_escape")
        bw.code(T.MB_INCREMENT, inc - 1)

    def _skip_vectors(self):
        """(direction, vector) of a skipped B MB: the previous MB's."""
        dirs, lm = self.prev_dir, self.last_mv
        return [(d, lm[d][0][0], lm[d][0][1]) for d in (0, 1) if dirs >> d & 1]

    def _skip_ok_at(self, pos: int) -> bool:
        field_pic = self.structure != FRAME
        x, r = pos % self.mbw, pos // self.mbw
        return self._skip_ok(x, (2 * r + (self.structure == BOTTOM)) if field_pic else r)

    def _skip_ok(self, x: int, y_mb: int) -> bool:
        if self.kind == "P":
            return True
        if self.prev_intra:
            return False
        field_pic = self.structure != FRAME
        for d, mx, my in self._skip_vectors():
            if field_pic:
                if not self._inside(mx, my, 0, 0, 16, y_mb >> 1, x):
                    return False
            elif not self._inside(mx, my, 0, 0, 16, y_mb, x):
                return False
        return True

    def _dc(self, bw: BitWriter, comp: int) -> None:
        prec = self.dc_prec
        top = (1 << (8 + prec)) - 1 if self.mpeg2 else 255
        pred = self.last_dc[comp]
        lo, hi = max(0, pred - (1 << (8 + prec))), min(top, pred + (1 << (8 + prec)))
        dc = self.rng.randint(lo, hi) if self.chance(0.5) else max(0, min(top, pred +
                                                                         self.rng.randint(-3, 3)))
        diff = dc - pred
        size = abs(diff).bit_length()
        bw.code(T.DC_LUMA if comp == 0 else T.DC_CHROMA, size)
        if size:
            bw.u(diff if diff > 0 else diff + (1 << size) - 1, size)
        self.last_dc[comp] = dc
        self.count(f"dc_size{size}")
        return dc << (3 - prec) if self.mpeg2 else dc * 8

    def _levels(self, first: int, intra: bool, matrix, qscale: int, budget: int) -> list:
        """(position, level) pairs in scan order, positions from `first`,
        their dequantised magnitudes summing to at most `budget` (so that
        no sum inside the IDCT leaves 16 bits: FFmpeg's x86 IDCT saturates
        there where its C one wraps)."""
        rng = self.rng
        count = rng.choice([1, 1, 2, 3, 4, 6, 10]) if not self.chance(0.05) else rng.randint(
            10, 40)
        positions = sorted(rng.sample(range(first, 64), min(count, 64 - first)))
        out = []
        for p in positions:
            w = matrix[int(self.scan[p])]
            top = 2047 if self.mpeg2 else 255
            lv = rng.randint(1, top) if self.chance(self.o["big"]) else rng.randint(1, 3)
            while lv > 1 and self._dequant(lv, intra, w, qscale) > budget:
                lv = max(1, lv // 2)
            cost = self._dequant(lv, intra, w, qscale)
            if cost > budget:
                break
            budget -= cost
            out.append((p, lv if self.chance(0.5) else -lv))
        return out

    def _dequant(self, lv: int, intra: bool, w: int, q: int) -> int:
        v = (lv * q * w) >> 4 if intra else ((2 * lv + 1) * q * w) >> 5
        return ((v - 1) | 1) if not self.mpeg2 else v

    def _coefs(self, bw: BitWriter, pairs: list, first_pos: int, table, intra: bool) -> None:
        prev = first_pos - 1
        for n, (p, lv) in enumerate(pairs):
            run = p - prev - 1
            prev = p
            a = abs(lv)
            if not intra and n == 0 and run == 0 and a == 1 and not self.chance(0.0):
                bw.u(1, 1)                           # the first coefficient's "1s"
                bw.u(int(lv < 0), 1)
                self.count("first_1s")
                continue
            k = RL.get((run, a))
            if k is not None and not self.chance(self.o["escape"]):
                bw.code(table, k)
                bw.u(int(lv < 0), 1)
                self.count("vlc")
                continue
            bw.code(table, T.COEF_ESCAPE)
            bw.u(run, 6)
            if self.mpeg2:
                bw.u(lv & 0xFFF, 12)
                self.count("esc12")
            elif -127 <= lv <= 127:
                bw.u(lv & 0xFF, 8)
                self.count("esc8")
            elif lv > 0:
                bw.u(0, 8)
                bw.u(lv, 8)
                self.count("esc16")
            else:
                bw.u(0x80, 8)
                bw.u(lv + 256, 8)
                self.count("esc16")
        bw.code(table, T.COEF_EOB)

    def _qscale(self) -> int:
        return int(T.NON_LINEAR_QSCALE[self.qcode]) if self.q_scale_type else self.qcode * 2

    def _block_intra(self, bw: BitWriter, n: int) -> None:
        comp = 0 if n < 4 else n - 3
        dc = self._dc(bw, comp)
        matrix = (self.intra_matrix if n < 4 or not self.mpeg2 else self.chroma_intra)
        table = T.B15 if self.vlc_format else T.B14
        budget = BUDGET - dc
        pairs = self._levels(1, True, matrix, self._qscale(), budget) if self.chance(0.8) else []
        self._coefs(bw, pairs, 1, table, True)

    def _block_inter(self, bw: BitWriter, n: int) -> None:
        matrix = self.inter_matrix if n < 4 or not self.mpeg2 else self.chroma_inter
        pairs = self._levels(0, False, matrix, self._qscale(), BUDGET)
        if not pairs:                                # a coded block has a coefficient
            pairs = [(0, 1 if self.chance(0.5) else -1)]
        self._coefs(bw, pairs, 0, T.B14, False)

    def macroblock(self, bw: BitWriter, x: int, y_mb: int) -> None:
        o, rng = self.o, self.rng
        frame = self.structure == FRAME
        kind = self.kind
        if self.copy:                                   # forward, not coded, vector 0
            bw.code(T.MB_TYPE_P, 2)
            for k in range(2):
                self._motion_code(bw, self.f[0][k], self.last_mv[0][0][k], 0)
            self.last_mv[0] = [[0, 0], [0, 0]]
            self.prev_intra, self.prev_dir = False, 1
            self.last_dc = [128 << self.dc_prec] * 3
            self.count("copy_mb")
            return
        quant = self.chance(o["quant"])
        intra = kind == "I" or self.chance(o["intra"])
        if intra:
            if kind == "I":
                bw.u(1, 1) if not quant else bw.u(1, 2)
            elif kind == "P":
                bw.code(T.MB_TYPE_P, 4 if quant else 0)
            else:
                bw.code(T.MB_TYPE_B, 7 if quant else 0)
            if frame and not self.frame_pred:
                bw.u(rng.randint(0, 1), 1)
                self.count("dct_type")
            if quant:
                self.qcode = rng.randint(1, 31)
                bw.u(self.qcode, 5)
                self.count("mb_quant")
            if self.concealment:
                if not frame:
                    bw.u(rng.randint(0, 1), 1)
                for k in range(2):
                    lo, hi = self._range(self.f[0][k])
                    v = self._pick(lo, hi)
                    self._motion_code(bw, self.f[0][k], self.last_mv[0][0][k], v)
                    self.last_mv[0][0][k] = self.last_mv[0][1][k] = v
                bw.u(1, 1)
                self.count("concealment_mv")
            else:
                self.last_mv = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]
            for n in range(6):
                self._block_intra(bw, n)
            self.prev_intra = True
            self.count(f"{kind}_intra")
            return
        self.prev_intra = False
        self.last_dc = [128 << self.dc_prec] * 3
        coded = self.chance(o["coded"])
        if kind == "P":
            no_mc = coded and self.has_last and self.chance(0.2)
            dirs = 0 if no_mc else 1
        else:
            dirs = rng.choice([1, 2, 3])
            if not self.has_last and dirs & 1:
                dirs = 2
            no_mc = False
        if kind == "P":
            idx = (5 if quant else 1) if no_mc else ((6 if quant else 3) if coded else 2)
            if not coded:
                quant = False
            bw.code(T.MB_TYPE_P, idx)
            flags = int(T.MB_FLAGS_P[idx])
        else:
            base = {1: 3, 2: 1, 3: 5}[dirs]              # not coded
            if coded:
                idx = {1: 9, 2: 8, 3: 10}[dirs] if quant else base + 1
            else:
                idx, quant = base, False
            bw.code(T.MB_TYPE_B, idx)
            flags = int(T.MB_FLAGS_B[idx])
        if no_mc:
            if frame and not self.frame_pred:
                bw.u(rng.randint(0, 1), 1)
                self.count("dct_type")
            if quant:
                self.qcode = rng.randint(1, 31)
                bw.u(self.qcode, 5)
            self.last_mv[0] = [[0, 0], [0, 0]]
            self.prev_dir = 1
            self.count("P_no_mc")
        else:
            self._motion(bw, x, y_mb, dirs, flags, quant)
            self.prev_dir = dirs
        if flags & T.MB_PATTERN:
            cbp = rng.randint(1, 63)
            bw.code(T.CBP, cbp)
            for n in range(6):
                if cbp >> (5 - n) & 1:
                    self._block_inter(bw, n)
            self.count(f"{kind}_coded")
        else:
            self.count(f"{kind}_not_coded")

    def _motion(self, bw: BitWriter, x: int, y_mb: int, dirs: int, flags: int,
                quant: bool) -> None:
        rng, o = self.rng, self.o
        frame = self.structure == FRAME
        if frame and self.frame_pred:
            mtype = 2
        else:
            choices = [2, 1]
            if self.kind == "P" and not self.progressive and self.chance(o["dual_prime"]) \
                    and (frame or self.has_last):
                choices = [3]
            mtype = rng.choice(choices)
            if mtype == 3:
                dmv = self._find_dmv(x, y_mb)
                if dmv is None:
                    mtype = 1
            bw.u(mtype, 2)
            if frame and flags & T.MB_PATTERN:
                bw.u(rng.randint(0, 1), 1)
                self.count("dct_type")
        if quant:
            self.qcode = rng.randint(1, 31)
            bw.u(self.qcode, 5)
            self.count("mb_quant")
        for d in (0, 1):
            if not dirs >> d & 1:
                continue
            f = self.f[d]
            lm = self.last_mv[d]
            if mtype == 2 and frame:
                self.count("mt_frame")
                for _ in range(50):
                    v = [self._pick(*self._range(f[k])) for k in range(2)]
                    s = 2 if self.full_pel[d] else 1
                    if self._inside(v[0] * s, v[1] * s, 0, 0, 16, y_mb, x):
                        break
                else:
                    v = [0, 0]
                for k in range(2):
                    self._motion_code(bw, f[k], lm[0][k], v[k])
                    lm[0][k] = lm[1][k] = v[k]
            elif mtype == 2:                                      # 16x8 in a field picture
                self.count("mt_16x8")
                for j in range(2):
                    sel = self._field_select(d)
                    for _ in range(50):
                        v = [self._pick(*self._range(f[k])) for k in range(2)]
                        if self._inside(v[0], v[1], 0, 1, 8, (y_mb & ~1) + j, x):
                            break
                    else:
                        v = [0, 0]
                    bw.u(sel, 1)
                    for k in range(2):
                        self._motion_code(bw, f[k], lm[j][k], v[k])
                        lm[j][k] = v[k]
            elif mtype == 1 and frame:                            # field prediction
                self.count("mt_field_in_frame")
                for j in range(2):
                    sel = rng.randint(0, 1)
                    for _ in range(50):
                        v = [self._pick(*self._range(f[k])) for k in range(2)]
                        if self._inside(v[0], v[1], 1, 0, 8, y_mb, x):
                            break
                    else:
                        v = [0, 0]
                    bw.u(sel, 1)
                    self._motion_code(bw, f[0], lm[j][0], v[0])
                    lm[j][0] = v[0]
                    self._motion_code(bw, f[1], lm[j][1] >> 1, v[1])
                    lm[j][1] = 2 * v[1]
            elif mtype == 1:                                      # field picture, field
                self.count("mt_field")
                sel = self._field_select(d)
                for _ in range(50):
                    v = [self._pick(*self._range(f[k])) for k in range(2)]
                    if self._inside(v[0], v[1], 0, 0, 16, y_mb >> 1, x):
                        break
                else:
                    v = [0, 0]
                bw.u(sel, 1)
                for k in range(2):
                    self._motion_code(bw, f[k], lm[0][k], v[k])
                    lm[0][k] = lm[1][k] = v[k]
            else:                                                 # dual prime
                self.count("mt_dual_prime")
                shift = 1 if frame else 0
                mx, my, dmx, dmy = dmv
                self._motion_code(bw, f[0], lm[0][0], mx)
                self._dmv(bw, dmx)
                self._motion_code(bw, f[1], lm[0][1] >> shift, my)
                self._dmv(bw, dmy)
                lm[0][0] = lm[1][0] = mx
                lm[0][1] = lm[1][1] = my << shift

    def _find_dmv(self, x: int, y_mb: int):
        """(mx, my, dmx, dmy) of a dual-prime prediction whose every block
        lies inside the reference, or None."""
        f = self.f[0]
        for _ in range(100):
            mx, my = (max(-8, min(8, self._pick(*self._range(f[k])))) for k in range(2))
            dmx, dmy = self.rng.choice([-1, 0, 1]), self.rng.choice([-1, 0, 1])
            if self._dmv_inside(mx, my, dmx, dmy, x, y_mb):
                return mx, my, dmx, dmy
        return None

    def _dmv(self, bw: BitWriter, v: int) -> None:
        bw.code(T.DMVECTOR, {0: 0, 1: 1, -1: 2}[v])

    def _dmv_inside(self, mx, my, dmx, dmy, x, y_mb) -> bool:
        if self.structure == FRAME:
            m = 1 if self.tff else 3
            vs = [(mx, my),
                  (((mx * m + (mx > 0)) >> 1) + dmx, ((my * m + (my > 0)) >> 1) + dmy - 1)]
            m = 4 - m
            vs.append((((mx * m + (mx > 0)) >> 1) + dmx, ((my * m + (my > 0)) >> 1) + dmy + 1))
            return all(self._inside(a, b, 1, 0, 8, y_mb, x) for a, b in vs)
        v2 = (((mx + (mx > 0)) >> 1) + dmx, ((my + (my > 0)) >> 1) + dmy +
              (-1 if self.structure == TOP else 1))
        if not self.first_field and not self.has_cur:
            return False
        return all(self._inside(a, b, 0, 0, 16, y_mb >> 1, x) for a, b in ((mx, my), v2))

    def _field_select(self, d: int) -> int:
        """A reference field: either parity, but where the reference would be
        missing (no past reference: the same parity of a P second field
        reads the previous frame)."""
        if self.kind == "P" and not self.has_last:
            # only the first field of this frame (the opposite parity)
            self.count("second_field_from_first")
            return 1 if self.structure == TOP else 0
        sel = self.rng.randint(0, 1)
        if self.kind == "P" and not self.first_field and sel != (self.structure == BOTTOM):
            self.count("second_field_from_first")
        return sel


def write_stream(seed: int, plan: str = "IPBBPBB", mpeg2: bool = True, **options) -> Stream:
    """A random stream of `plan`'s pictures (see the module's docstring)."""
    w = Writer(seed, mpeg2=mpeg2, **options)
    packets = []
    need_headers, open_gop = True, False
    refs = 0                                       # anchors decoded so far
    for t in tokens(plan):
        if t == "|":
            need_headers = True
            continue
        if t == "o":
            open_gop = True
            continue
        bw = BitWriter()
        if need_headers:
            w.sequence(bw)
            w.gop(bw, not open_gop)
            need_headers, open_gop = False, False
        if len(t) == 1:
            has_last = refs >= (2 if t == "B" else 1)
            w.picture(bw, t, FRAME, False, w.rng.randint(0, 1), has_last, False)
            w.count(f"frame_{t}")
        else:
            if w.progressive or not w.mpeg2:
                raise ValueError(f"a field pair {t!r} in a progressive sequence")
            first = w.rng.choice([TOP, BOTTOM])
            second = BOTTOM if first == TOP else TOP
            has_last = refs >= (2 if t[0] == "B" else 1)
            w.picture(bw, t[0], first, True, int(first == TOP), has_last, False)
            w.picture(bw, t[1], second, False, int(first == TOP), has_last, True)
            w.count(f"fields_{t}")
        if t[0] != "B":
            refs += 1
        packets.append(bw.bytes())
    tail = BitWriter()
    tail.start(0xB7)
    packets[-1] += tail.bytes()
    return Stream(b"".join(packets), packets, w.w, w.h, w.mpeg2, w.stats)


# ── program streams ─────────────────────────────────────────────────────

def _ts(marker: int, t: int) -> bytes:
    t %= 1 << 33
    return bytes([marker << 4 | (t >> 29 & 0x0E) | 1, t >> 22 & 0xFF, (t >> 14 & 0xFE) | 1,
                  t >> 7 & 0xFF, (t << 1 & 0xFE) | 1])


def pack_header(mpeg1: bool, scr: int) -> bytes:
    if mpeg1:
        return b"\x00\x00\x01\xba" + bytes([0x21 | (scr >> 29 & 0x0E)]) + _ts(0, scr)[1:] + \
            b"\x80\x1b\x83"
    b = (0x44 | (scr >> 27 & 0x38) | (scr >> 28 & 0x03)).to_bytes(1, "big")
    v = (scr >> 20 & 0xFF, (scr >> 12 & 0xF8) | 0x04 | (scr >> 13 & 0x03), scr >> 5 & 0xFF,
         (scr << 3 & 0xF8) | 0x04, 0x01, 0x89, 0xC3, 0xF8)
    return b"\x00\x00\x01\xba" + b + bytes(v)


def system_header(video: bool = True, audio: bool = False) -> bytes:
    body = bytes([0x80, 0x1B, 0x83, 0x04 | 0x01, 0xE1, 0xFF])
    if video:
        body += bytes([0xE0, 0xE0, 0xE8])
    if audio:
        body += bytes([0xC0, 0xC0, 0x20])
    return b"\x00\x00\x01\xbb" + struct.pack(">H", len(body)) + body


def pes(mpeg1: bool, sid: int, payload: bytes, pts: int | None, dts: int | None,
        std: bool = True) -> bytes:
    if mpeg1:
        head = b"\x40\xe0" if std else b""          # STD buffer
        if pts is None:
            head += b"\x0f"
        elif dts is None or dts == pts:
            head += _ts(2, pts)
        else:
            head += _ts(3, pts) + _ts(1, dts)
    else:
        if pts is None:
            flags, stamps = 0x00, b""
        elif dts is None or dts == pts:
            flags, stamps = 0x80, _ts(2, pts)
        else:
            flags, stamps = 0xC0, _ts(3, pts) + _ts(1, dts)
        head = bytes([0x81, flags, len(stamps)]) + stamps
    return b"\x00\x00\x01" + bytes([sid]) + struct.pack(">H", len(head) + len(payload)) + head + \
        payload


def psm(types: dict) -> bytes:
    es = b"".join(bytes([t, sid, 0, 0]) for sid, t in types.items())
    body = bytes([0x80, 0x01, 0, 0]) + struct.pack(">H", len(es)) + es + b"\0\0\0\0"
    return b"\x00\x00\x01\xbc" + struct.pack(">H", len(body)) + body


def write_ps(path, packets: list, fps: float = 25.0, mpeg1: bool = True, *,
             reorder: str | None = None, psm_type: int | None = None, padding: bool = False,
             private: bool = False, nav: bool = False, std: bool = True, start: int = 90000,
             split: int = 0, cut: int | None = None, times: tuple | None = None) -> Path:
    """An MPEG-1 system stream (`mpeg1`) or MPEG-2 program stream of the
    packets (pictures in coded order; `reorder` their types in coded order,
    "IPBB..", for their PTS / DTS: B pictures shown at once, references one
    picture later), one PES each (or pieces of `split` bytes, the later
    without time stamps), a pack header before each; `psm_type` writes a
    program stream map naming the video's stream type, `padding` a padding
    packet, `private` a private stream 1 AC-3 packet, `nav` a DVD's
    navigation pack (private stream 2) after each pack header; `cut` ends
    the file after that many bytes; `times` (PTS, DTS) gives each packet's
    time stamps instead (another codec's access units)."""
    tick = round(90000 / fps)
    kinds = reorder or "I" * len(packets)
    # display order: a reference shows when the next reference comes
    shown = []
    pending = None
    order = [0] * len(packets)
    for k, c in enumerate(kinds[:len(packets)]):
        if c == "B":
            shown.append(k)
        else:
            if pending is not None:
                shown.append(pending)
            pending = k
    if pending is not None:
        shown.append(pending)
    for pos, k in enumerate(shown):
        order[k] = pos
    out = bytearray()
    for k, data in enumerate(packets):
        scr = start - 9000 + k * tick
        out += pack_header(mpeg1, scr)
        if k == 0:
            out += system_header(audio=private)
            if psm_type is not None and not mpeg1:
                out += psm({0xE0: psm_type})
        if nav and not mpeg1:
            body = bytes(980)
            out += b"\x00\x00\x01\xbf" + struct.pack(">H", len(body)) + body
        pts = start + order[k] * tick + tick
        dts = start + k * tick
        if times is not None:
            pts, dts = times[0][k], times[1][k]
        step = min(split or 60000, 60000)                   # PES_packet_length's 16 bits
        pieces = [data[i:i + step] for i in range(0, len(data), step)] or [b""]
        for j, piece in enumerate(pieces):
            out += pes(mpeg1, 0xE0, piece, pts if j == 0 else None, dts if j == 0 else None,
                       std)
        if private:
            frame = b"\x0b\x77" + bytes(30)
            out += pes(mpeg1, 0xBD, b"\x80\x01\x00\x01" + frame, dts, None, std)
        if padding:
            out += b"\x00\x00\x01\xbe\x00\x10" + b"\xff" * 16
    out += b"\x00\x00\x01\xb9"
    path = Path(path)
    path.write_bytes(bytes(out[:cut]) if cut is not None else bytes(out))
    return path


def tokens(plan: str) -> list[str]:
    """The plan's pictures ("I", "[IP]" as "IP") and marks ("|", "o")."""
    out, i = [], 0
    while i < len(plan):
        if plan[i] == "[":
            out.append(plan[i + 1:plan.index("]", i)])
            i = plan.index("]", i) + 1
        else:
            out.append(plan[i])
            i += 1
    return out


def coded_kinds(plan: str) -> str:
    """The type of each packet of a plan (a field pair: its first field's)."""
    return "".join(t[0] for t in tokens(plan) if t not in "|o")


def make_file(path, seed: int, plan: str, mpeg2: bool, options: dict, mux: dict) -> Path:
    """A writer stream muxed by the path's suffix: `.mpg` (`write_ps`, `mux`
    its options), `.ts` (`torch_ts_mux.write_ts`, stream type 0x02 / 0x01)
    or `.m2v` (the elementary stream itself)."""
    options = {k: tuple(v) if isinstance(v, list) else v for k, v in options.items()}
    stream = write_stream(seed, plan, mpeg2=mpeg2, **options)
    path = Path(path)
    kinds = coded_kinds(plan)
    if path.suffix == ".mpg":
        return write_ps(path, stream.packets, reorder=kinds, **mux)
    if path.suffix == ".ts":
        import torch_ts_mux as tsm

        tick = round(90000 / mux.get("fps", 25.0))
        shown, pending = [], None
        for k, c in enumerate(kinds):
            if c == "B":
                shown.append(k)
            else:
                if pending is not None:
                    shown.append(pending)
                pending = k
        shown.append(pending)
        order = {k: pos for pos, k in enumerate(shown)}
        dts = [tsm.PTS_BASE + k * tick for k in range(len(kinds))]
        pts = [tsm.PTS_BASE + (order[k] + 1) * tick for k in range(len(kinds))]
        return tsm.write_ts(path, stream.packets, pts, dts, codec="mpeg4",
                            stream_type=0x02 if mpeg2 else 0x01,
                            key=[c == "I" for c in kinds])
    path.write_bytes(stream.data)
    return path
