"""A random legal-syntax MPEG-4 Part 2 Simple profile writer, for holding the
port's decoder (`omfs4d_torch/io/mpeg4dec.cpp`) to cv2's FFmpeg.

`Writer(seed, **features).stream()` gives (headers, VOPs): the VOS / VO /
VOL headers and user data, then one VOP a frame (a GOV header before an
I-VOP where `gov`).  It writes syntax, not pictures: every syntax element is
drawn at random within what the standard allows, and the writer keeps the
decoder's state (DC and AC predictors by block, QP and vectors by MB, the
video packet) only so that what it draws decodes to legal values:

- the inverse-quantised coefficients stay within [-2048, 2047] (where the
  standard saturates FFmpeg does not) and a block's absolute sum under
  2,900, so the IDCT's 16-bit rows never overflow;
- an intra DC, predictor included, stays within [0, 2047] after scaling;
- vectors stay within f_code's range, differences coded modulo it;
- TCOEF events are coded the shortest legal way, in the standard's order:
  the table, escape 1 (level - LMAX), escape 2 (run - RMAX - 1), escape 3.

`stats` counts what was written (MB kinds, escape modes, prediction
directions, vectors past each edge, ...).  `raw`, `write_avi` and
`write_mp4` put a stream in the three forms cv2 reads: an elementary
`.m4v`, AVI (the headers before the first VOP in its first chunk, as cv2
writes it) and MP4 (`mp4v`, OTI 0x20, the headers in the esds's
DecoderSpecificInfo).

The tables are the decoder's, `omfs4d_torch.io.mpeg4_tables`.
"""

from __future__ import annotations

import struct
from collections import Counter
from fractions import Fraction

import numpy as np

from omfs4d_torch.io import mp4
from omfs4d_torch.io import mpeg4_tables as T

LAVC = "Lavc62.28.101"


class BitWriter:
    def __init__(self):
        self.acc, self.n = 0, 0

    def u(self, n: int, v: int) -> None:
        if n:
            assert 0 <= v < 1 << n, (n, v)
            self.acc, self.n = self.acc << n | v, self.n + n

    def code(self, pair) -> None:
        self.u(int(pair[1]), int(pair[0]))

    def stuffing(self) -> None:
        """next_start_code() / the stuffing before a resync marker: a 0,
        then 1s to the byte."""
        self.u(1, 0)
        while self.n % 8:
            self.u(1, 1)

    def data(self) -> bytes:
        assert self.n % 8 == 0
        return self.acc.to_bytes(self.n // 8, "big") if self.n else b""


def start(code: int) -> bytes:
    return b"\x00\x00\x01" + bytes([code])


def _rounded_div(a: int, b: int) -> int:
    return (a + (b >> 1)) // b if a >= 0 else -((-a + (b >> 1)) // b)


def chroma_vector(s: int) -> int:
    """7.6.5: the chroma vector of four luminance vectors summing to s."""
    v = 2 * (abs(s) >> 4) + int(T.CHROMA_ROUND[abs(s) & 15])
    return -v if s < 0 else v


# the MB offset and block of the motion vector candidates A, B, C of each block
MV_CANDIDATES = (((-1, 0, 1), (0, -1, 2), (1, -1, 2)),
                 ((0, 0, 0), (0, -1, 3), (1, -1, 2)),
                 ((-1, 0, 3), (0, 0, 0), (0, 0, 1)),
                 ((0, 0, 2), (0, 0, 0), (0, 0, 1)))

# what each refusal flag writes, by name of the tool refused
REFUSALS = ("b_vop", "sprite", "quant_type", "quarter_sample", "interlaced",
            "data_partitioned", "shape", "not_8_bit", "scalability", "complexity", "newpred",
            "reduced_resolution", "obmc", "short_header", "packed", "chroma_format")


class Writer:
    """Random Simple-profile syntax.  Features (keyword arguments):

    width, height, frames; gop (an I-VOP every gop frames); qp (lo, hi) of
    vop_quant; dquant (the chance of dquant in an MB); ac_pred (chance per
    intra MB); dc_thr (the intra_dc_vlc_thr of each VOP in turn); coded (the
    chance a block is coded); big (the chance of a large level); long_run
    (the chance of a long run); not_coded, intra_in_p, four_mv (chances in a
    P-VOP); fcode (the f_code of each P-VOP in turn); far (the chance a vector is
    drawn over its whole range); packets (the chance a video packet starts
    at an MB); hec (the chance a packet has a header extension); stuffing
    (the chance of MCBPC stuffing before an MB); gov; stamp (user data, None
    for none); colour ((full range, matrix), or (full range, primaries,
    transfer, matrix), in the VO header, or None);
    verid (1 or 2); vbv; par; fixed_rate; vop_not_coded (the chance a P-VOP
    is not coded); refuse (one of REFUSALS: the stream then uses that tool).
    """

    def __init__(self, seed: int, width: int = 48, height: int = 32, frames: int = 4,
                 gop: int = 12, qp=(2, 12), dquant: float = 0.0, ac_pred: float = 0.5,
                 dc_thr=(0,), coded: float = 0.6, big: float = 0.05, long_run: float = 0.05,
                 not_coded: float = 0.15, intra_in_p: float = 0.05, four_mv: float = 0.2,
                 fcode=(1,), far: float = 0.2, packets: float = 0.0, hec: float = 0.0,
                 stuffing: float = 0.0, gov: bool = False, stamp: str | None = LAVC,
                 colour=None, verid: int = 1, vbv: bool = False, par: bool = False,
                 fixed_rate: bool = False, vop_not_coded: float = 0.0, time_res: int = 30,
                 refuse: str | None = None):
        self.rng = np.random.default_rng(seed)
        self.w, self.h, self.frames, self.gop = width, height, frames, gop
        self.qp_range, self.p_dquant, self.p_ac_pred, self.dc_thrs = qp, dquant, ac_pred, dc_thr
        self.p_coded, self.p_big, self.p_long = coded, big, long_run
        self.p_skip, self.p_intra, self.p_four = not_coded, intra_in_p, four_mv
        self.fcodes, self.p_far, self.p_packet, self.p_hec = fcode, far, packets, hec
        self.p_stuffing, self.gov, self.stamp, self.colour = stuffing, gov, stamp, colour
        self.verid, self.vbv, self.par, self.fixed_rate = verid, vbv, par, fixed_rate
        self.p_not_coded, self.time_res, self.refuse = vop_not_coded, time_res, refuse
        assert refuse is None or refuse in REFUSALS, refuse
        self.mbw, self.mbh = -(-width // 16), -(-height // 16)
        n = self.mbw * self.mbh
        self.mb_bits = max(1, (n - 1).bit_length())
        self.time_bits = max(1, (time_res - 1).bit_length())
        self.stats: Counter = Counter()
        self.mb_qp = [0] * n
        self.mb_intra = [False] * n
        self.mvs = [[(0, 0)] * 4 for _ in range(n)]
        self.dc = [[1024] * 6 for _ in range(n)]
        self.ac = [[[0] * 16 for _ in range(6)] for _ in range(n)]
        self.packet_start = 0

    # ── draws ───────────────────────────────────────────────────────────
    def chance(self, p: float) -> bool:
        return bool(p > 0 and self.rng.random() < p)

    def draw(self, lo: int, hi: int) -> int:
        return int(self.rng.integers(lo, hi + 1))

    # ── headers ─────────────────────────────────────────────────────────
    def headers(self) -> bytes:
        if self.refuse == "short_header":
            bw = BitWriter()
            bw.u(22, 0x20)                          # short_video_start_marker
            bw.u(8, 0)
            bw.u(10, 0x2A0)                         # the rest of an H.263 picture header
            bw.stuffing()
            return bw.data()
        out = start(0xB0) + bytes([0x01 if self.refuse is None else 0xF5])
        bw = BitWriter()
        bw.u(1, 1)
        bw.u(4, 1)
        bw.u(3, 1)
        bw.u(4, 1)                                  # video
        bw.u(1, self.colour is not None)
        if self.colour is not None:
            bw.u(3, 5)
            bw.u(1, int(self.colour[0]))
            bw.u(1, 1)
            for v in (self.colour[1:] if len(self.colour) == 4 else (1, 1, self.colour[1])):
                bw.u(8, v)
        bw.stuffing()
        out += start(0xB5) + bw.data() + start(0x00)
        out += start(0x20) + self.vol()
        if self.stamp:
            out += start(0xB2) + self.stamp.encode("latin-1")
        if self.refuse == "packed":
            out += start(0xB2) + b"DivX503b1393p"
        return out

    def vol(self) -> bytes:
        r = self.refuse
        bw = BitWriter()
        bw.u(1, 0)
        bw.u(8, 17 if r in ("b_vop", "quarter_sample") else 1)
        verid = 2 if r in ("quarter_sample", "newpred", "reduced_resolution") else self.verid
        bw.u(1, 1)
        bw.u(4, verid)
        bw.u(3, 1)
        bw.u(4, 15 if self.par else 1)
        if self.par:
            bw.u(8, 12)
            bw.u(8, 11)
        bw.u(1, 1)                                  # vol_control_parameters
        bw.u(2, 2 if r == "chroma_format" else 1)
        bw.u(1, 0 if r == "b_vop" else 1)           # low_delay
        bw.u(1, self.vbv)
        if self.vbv:                                # bit rate, buffer size, occupancy
            for v in (0, 4000, 0):
                bw.u(15, v)
                bw.u(1, 1)
            bw.u(3, 4)
            bw.u(11, 0)
            bw.u(1, 1)
            bw.u(15, 3000)
            bw.u(1, 1)
        bw.u(2, 2 if r == "shape" else 0)
        bw.u(1, 1)
        bw.u(16, self.time_res)
        bw.u(1, 1)
        bw.u(1, self.fixed_rate)
        if self.fixed_rate:
            bw.u(self.time_bits, 1)
        bw.u(1, 1)
        bw.u(13, self.w)
        bw.u(1, 1)
        bw.u(13, self.h)
        bw.u(1, 1)
        bw.u(1, r == "interlaced")
        bw.u(1, r != "obmc")                        # obmc_disable
        bw.u(1 if verid == 1 else 2, r == "sprite")  # sprite_enable (refused here)
        bw.u(1, r == "not_8_bit")
        bw.u(1, r == "quant_type")
        if r == "quant_type":
            bw.u(2, 0)                              # no matrices loaded
        if verid != 1:
            bw.u(1, r == "quarter_sample")
        bw.u(1, r != "complexity")                  # complexity_estimation_disable
        bw.u(1, self.p_packet == 0)                 # resync_marker_disable
        bw.u(1, r == "data_partitioned")
        if r == "data_partitioned":
            bw.u(1, 0)
        if verid != 1:
            bw.u(1, r == "newpred")
            bw.u(1, r == "reduced_resolution")
        bw.u(1, r == "scalability")
        bw.stuffing()
        return bw.data()

    def gov_header(self, frame: int) -> bytes:
        seconds = frame // self.time_res
        bw = BitWriter()
        bw.u(5, seconds // 3600)
        bw.u(6, seconds // 60 % 60)
        bw.u(1, 1)
        bw.u(6, seconds % 60)
        bw.u(1, 1)                                  # closed_gov
        bw.u(1, 0)
        bw.stuffing()
        return start(0xB3) + bw.data()

    # ── the stream ──────────────────────────────────────────────────────
    def stream(self) -> tuple[bytes, list[bytes]]:
        headers = self.headers()
        vops = []
        for f in range(self.frames):
            kind = "I" if f % self.gop == 0 else "P"
            if self.refuse == "b_vop" and f == 2:
                kind = "B"
            data = self.gov_header(f) if self.gov and kind == "I" else b""
            data += self.vop(f, kind)
            if self.refuse == "packed" and f == 1:
                data += self.vop(f, "P")
            vops.append(data)
        return headers, vops

    def vop(self, frame: int, kind: str) -> bytes:
        bw = BitWriter()
        bw.u(2, "IPB".index(kind))
        if frame and frame % self.time_res == 0:
            bw.u(1, 1)                              # modulo_time_base: a second has passed
        bw.u(1, 0)
        bw.u(1, 1)
        bw.u(self.time_bits, frame % self.time_res)
        bw.u(1, 1)
        if kind == "B":                             # refused before its data is read
            bw.u(1, 1)
            bw.u(1, 0)
            bw.u(3, 0)
            bw.u(5, 8)
            bw.u(3, 1)
            bw.stuffing()
            return start(0xB6) + bw.data()
        if kind == "P" and self.chance(self.p_not_coded):
            bw.u(1, 0)                              # vop_coded
            bw.stuffing()
            self.stats["vop_not_coded"] += 1
            return start(0xB6) + bw.data()
        bw.u(1, 1)
        self.kind = kind
        # vop_rounding_type flips from one P-VOP to the next, as FFmpeg's
        # encoder flips it
        self.rounding = (1 - self.rounding if hasattr(self, "rounding") else self.draw(0, 1)) \
            if kind == "P" else getattr(self, "rounding", 0)
        self.dc_thr = int(self.dc_thrs[frame % len(self.dc_thrs)])
        qp = self.draw(*self.qp_range)
        self.fcode = int(self.fcodes[frame % len(self.fcodes)]) if kind == "P" else 1
        if kind == "P":
            bw.u(1, self.rounding)
            self.stats[f"rounding{self.rounding}"] += 1
        bw.u(3, self.dc_thr)
        bw.u(5, qp)
        if kind == "P":
            bw.u(3, self.fcode)
            self.stats[f"fcode{self.fcode}"] += 1
        self.stats[f"dc_thr{self.dc_thr}"] += 1
        self.stats[f"vop_{kind}"] += 1
        self.packet_start = 0
        n = self.mbw * self.mbh
        self.mb_intra = [False] * n
        for mbn in range(n):
            if mbn and self.chance(self.p_packet):
                qp = self.packet_header(bw, mbn, frame, qp)
            qp = self.macroblock(bw, mbn, qp)
        bw.stuffing()
        return start(0xB6) + bw.data()

    def packet_header(self, bw: BitWriter, mbn: int, frame: int, qp: int) -> int:
        bw.stuffing()
        zeros = 16 if self.kind == "I" else 15 + self.fcode
        bw.u(zeros + 1, 1)
        bw.u(self.mb_bits, mbn)
        qp = self.draw(*self.qp_range)
        bw.u(5, qp)
        hec = self.chance(self.p_hec)
        bw.u(1, hec)
        if hec:
            bw.u(1, 0)
            bw.u(1, 1)
            bw.u(self.time_bits, frame % self.time_res)
            bw.u(1, 1)
            bw.u(2, "IP".index(self.kind))
            bw.u(3, self.dc_thr)
            if self.kind == "P":
                bw.u(3, self.fcode)
            self.stats["hec"] += 1
        self.packet_start = mbn
        self.stats["packet"] += 1
        return qp

    # ── neighbours, as the decoder finds them ───────────────────────────
    def neighbour(self, mbn: int, dx: int, dy: int) -> int:
        mx, my = mbn % self.mbw + dx, mbn // self.mbw + dy
        if mx < 0 or my < 0 or mx >= self.mbw:
            return -1
        m = my * self.mbw + mx
        return m if m >= self.packet_start else -1

    def dc_neighbours(self, mbn: int, n: int):
        """(MB, block) of A (left), B (above left), C (above) of block n, MB
        -1 where it is outside, in another packet or not intra."""
        mx, my = mbn % self.mbw, mbn // self.mbw
        out = []
        for ox, oy in ((-1, 0), (-1, -1), (0, -1)):
            if n < 4:
                x, y = 2 * mx + (n & 1) + ox, 2 * my + (n >> 1) + oy
                if x < 0 or y < 0:
                    out.append((-1, 0))
                    continue
                dx, dy = (x >> 1) - mx, (y >> 1) - my
                m = mbn if dx == dy == 0 else self.neighbour(mbn, dx, dy)
                k = (y & 1) << 1 | (x & 1)
            else:
                m, k = self.neighbour(mbn, ox, oy), n
            out.append((m if m >= 0 and self.mb_intra[m] else -1, k))
        return out

    def pred_mv(self, mbn: int, k: int) -> tuple[int, int]:
        vs, valid = [], []
        for dx, dy, blk in MV_CANDIDATES[k]:
            m = mbn if dx == dy == 0 else self.neighbour(mbn, dx, dy)
            valid.append(m >= 0)
            vs.append(self.mvs[m][blk] if m >= 0 else (0, 0))
        if sum(valid) == 1:
            return vs[valid.index(True)]
        return tuple(sorted(v[c] for v in vs)[1] for c in (0, 1))

    # ── macroblocks ─────────────────────────────────────────────────────
    def macroblock(self, bw: BitWriter, mbn: int, qp: int) -> int:
        if self.chance(self.p_stuffing):
            if self.kind == "P":
                bw.u(1, 0)
            bw.code((T.MCBPC_I if self.kind == "I" else T.MCBPC_P)[-1])
            self.stats["stuffing"] += 1
        if self.kind == "P" and self.chance(self.p_skip):
            bw.u(1, 1)
            self.mb_qp[mbn], self.mb_intra[mbn] = qp, False
            self.mvs[mbn] = [(0, 0)] * 4
            self.clear_intra(mbn)
            self.stats["P_skip"] += 1
            return qp
        intra = self.kind == "I" or self.chance(self.p_intra)
        four = not intra and self.chance(self.p_four)
        delta = 0
        if not four and self.chance(self.p_dquant):
            delta = int(self.rng.choice([d for d in T.DQUANT if 1 <= qp + d <= 31]))
        dc_vlc = qp < T.DC_THRESHOLD[self.dc_thr]
        new_qp = qp + delta
        self.mb_qp[mbn] = new_qp
        if intra:
            ac_pred = self.chance(self.p_ac_pred)
            self.mb_intra[mbn] = True
            self.mvs[mbn] = [(0, 0)] * 4
            blocks = [self.intra_block(mbn, n, ac_pred, dc_vlc, new_qp) for n in range(6)]
        else:
            self.mb_intra[mbn] = False
            self.clear_intra(mbn)
            vectors = self.motion(mbn, four)
            blocks = [self.inter_block(new_qp) for _ in range(6)]
        cbp = [bool(b) for b, _ in blocks]
        cbpy = cbp[0] << 3 | cbp[1] << 2 | cbp[2] << 1 | cbp[3]
        cbpc = cbp[4] << 1 | cbp[5]
        if self.kind == "I":
            bw.code(T.MCBPC_I[4 * bool(delta) + cbpc])
            kind = "IQ" if delta else "I"
        else:
            bw.u(1, 0)
            kind_index = 4 if four else (1 if intra else 0) + (2 if delta else 0)
            bw.code(T.MCBPC_P[4 * kind_index + cbpc])
            kind = ("P_inter", "P_intra", "P_interQ", "P_intraQ", "P_4v")[kind_index]
        self.stats[kind] += 1
        if intra:
            bw.u(1, ac_pred)
            self.stats["ac_pred" if ac_pred else "no_ac_pred"] += 1
            self.stats["dc_vlc" if dc_vlc else "dc_in_ac"] += 1
            bw.code(T.CBPY[cbpy])
        else:
            bw.code(T.CBPY[cbpy ^ 15])
        if delta:
            bw.u(2, list(T.DQUANT).index(delta))
        if not intra:
            for diff in vectors:
                for d in diff:
                    self.write_mv(bw, d)
        for n, (events, dc) in enumerate(blocks):
            if intra and dc_vlc:
                self.write_dc(bw, dc, n >= 4)
            if events:
                self.write_tcoef(bw, events, intra)
        return new_qp

    def clear_intra(self, mbn: int) -> None:
        self.dc[mbn] = [1024] * 6
        self.ac[mbn] = [[0] * 16 for _ in range(6)]

    def level_bound(self, qp: int) -> int:
        """The largest |level| whose inverse quantisation stays within 2047."""
        return (2047 - qp) // (2 * qp)

    def random_levels(self, positions: range, qp: int, budget: int = 2900) -> dict[int, int]:
        """Scan position -> level of a random block's non-zero coefficients,
        their inverse-quantised magnitudes summing to at most `budget`."""
        bound = self.level_bound(qp)
        out = {}
        pos = positions.start
        while pos < positions.stop:
            pos += int(self.rng.geometric(0.5)) - 1
            if self.chance(self.p_long):
                pos += self.draw(10, 45)
            if pos >= positions.stop:
                break
            if self.chance(self.p_big):
                level = self.draw(1, bound)
            else:
                level = min(bound, int(self.rng.choice([1, 1, 1, 1, 2, 2, 3, 4, 6, 9, 13])))
            cost = (2 * level + 1) * qp
            if cost > budget:
                break
            budget -= cost
            out[pos] = level if self.rng.random() < 0.5 else -level
            pos += 1
            if self.rng.random() < 0.25:
                break
        return out

    def intra_block(self, mbn: int, n: int, ac_pred: bool, dc_vlc: bool, qp: int):
        """(TCOEF events, DC differential) of a random intra block; its
        predictors and stored values as the decoder keeps them."""
        (ma, ka), (mb, kb), (mc, kc) = self.dc_neighbours(mbn, n)
        fa = self.dc[ma][ka] if ma >= 0 else 1024
        fb = self.dc[mb][kb] if mb >= 0 else 1024
        fc = self.dc[mc][kc] if mc >= 0 else 1024
        from_top = abs(fa - fb) < abs(fb - fc)
        self.stats["dc_top" if from_top else "dc_left"] += 1
        scale = int(T.DC_SCALER[qp, int(n >= 4)])
        pred_f = fc if from_top else fa
        dc_pred = (pred_f + (scale >> 1)) // scale
        scan = T.ZIGZAG if not ac_pred else (T.ALT_HORIZONTAL if from_top else T.ALT_VERTICAL)
        # the final quantised block, raster order
        qf = np.zeros(64, np.int64)
        hi = 2047 // scale
        if self.chance(0.7):
            dc = min(hi, max(0, dc_pred + self.draw(-3, 3)))
        else:
            dc = self.draw(0, min(hi, (1500 + self.draw(0, 540)) // scale))
        qf[0] = dc
        if self.chance(self.p_coded):
            for pos, level in self.random_levels(range(1, 64), qp, 2900 - dc * scale).items():
                qf[scan[pos]] = level
        # the AC predictor
        pred = np.zeros(64, np.int64)
        if ac_pred:
            m, k = (mc, kc) if from_top else (ma, ka)
            if m >= 0:
                q = self.mb_qp[m]
                for i in range(1, 8):
                    a = self.ac[m][k][8 + i] if from_top else self.ac[m][k][i]
                    pred[i if from_top else 8 * i] = a if q == qp else _rounded_div(a * q, qp)
                    self.stats["ac_rescaled" if q != qp and a else "ac_same_qp"] += 1
        coded = qf - pred
        coded[0] = dc - dc_pred
        self.dc[mbn][n] = int(dc * scale)
        self.ac[mbn][n] = [0] + [int(qf[8 * i]) for i in range(1, 8)] + [0] + \
            [int(qf[i]) for i in range(1, 8)]
        first = 1 if dc_vlc else 0
        events = self.events(coded, scan, first)
        return events, int(coded[0])

    def inter_block(self, qp: int):
        if not self.chance(self.p_coded):
            return [], 0
        qf = np.zeros(64, np.int64)
        for pos, level in self.random_levels(range(0, 64), qp).items():
            qf[T.ZIGZAG[pos]] = level
        return self.events(qf, T.ZIGZAG, 0), 0

    def events(self, coded: np.ndarray, scan, first: int) -> list[tuple[int, int, int]]:
        """(last, run, level) of the non-zero coefficients in scan order from
        `first`."""
        vals = [int(coded[scan[p]]) for p in range(first, 64)]
        nz = [p for p, v in enumerate(vals) if v]
        out, prev = [], -1
        for j, p in enumerate(nz):
            out.append((int(j == len(nz) - 1), p - prev - 1, vals[p]))
            prev = p
        return out

    # ── motion ──────────────────────────────────────────────────────────
    def motion(self, mbn: int, four: bool) -> list[tuple[int, int]]:
        """The coded differences of the MB's vectors; the vectors are kept."""
        scale = 1 << (self.fcode - 1)
        lo, hi = -32 * scale, 32 * scale - 1
        mx, my = mbn % self.mbw, mbn // self.mbw
        diffs = []
        for k in range(4 if four else 1):
            pred = self.pred_mv(mbn, k)
            if self.chance(self.p_far):
                v = (self.draw(lo, hi), self.draw(lo, hi))
            else:
                v = tuple(min(hi, max(lo, p + self.draw(-6, 6))) for p in pred)
            diff = []
            for c in (0, 1):
                d = (v[c] - pred[c] + 32 * scale) % (64 * scale) - 32 * scale
                diff.append(d)
            diffs.append(tuple(diff))
            for j in (range(k, k + 1) if four else range(4)):
                self.mvs[mbn][j] = v
            size = 8 if four else 16
            x = 16 * mx + (8 * (k & 1) if four else 0) + (v[0] >> 1)
            y = 16 * my + (8 * (k >> 1) if four else 0) + (v[1] >> 1)
            edges = {"left": x < 0, "top": y < 0, "right": x + size + (v[0] & 1) > self.w,
                     "bottom": y + size + (v[1] & 1) > self.h}
            for name, past in edges.items():
                self.stats[f"mv_past_{name}"] += past
            self.stats["mv_half" if (v[0] | v[1]) & 1 else "mv_full"] += 1
        if four:
            cx = chroma_vector(sum(v[0] for v in self.mvs[mbn]))
            self.stats[f"chroma4_{abs(sum(v[0] for v in self.mvs[mbn])) & 15}"] += 1
            self.stats["chroma4_half" if cx & 1 else "chroma4_full"] += 1
        return diffs

    def write_mv(self, bw: BitWriter, d: int) -> None:
        r = self.fcode - 1
        if d == 0:
            bw.code(T.MV[0])
            return
        a = abs(d) - 1
        code, residual = (a >> r) + 1, a & ((1 << r) - 1)
        bw.code(T.MV[code])
        bw.u(1, d < 0)
        bw.u(r, residual)

    # ── coefficients ────────────────────────────────────────────────────
    def write_dc(self, bw: BitWriter, diff: int, chroma: bool) -> None:
        size = abs(diff).bit_length()
        bw.code((T.DC_CHROM if chroma else T.DC_LUM)[size])
        if size:
            bw.u(size, diff if diff > 0 else diff + (1 << size) - 1)
            if size > 8:
                bw.u(1, 1)
        self.stats[f"dc_size{size}"] += 1

    def write_tcoef(self, bw: BitWriter, events, intra: bool) -> None:
        if intra:
            levels, runs, last0 = T.INTRA_LEVEL, T.INTRA_RUN, T.INTRA_LAST0
            codes, lmax, rmax = T.INTRA_CODES, T.INTRA_MAX_LEVEL, T.INTRA_MAX_RUN
        else:
            levels, runs, last0 = T.INTER_LEVEL, T.INTER_RUN, T.INTER_LAST0
            codes, lmax, rmax = T.INTER_CODES, T.INTER_MAX_LEVEL, T.INTER_MAX_RUN

        def index(last, run, level):
            if run > 63 or level > 63 or level > lmax[last, run]:
                return None
            lo, hi = (0, last0) if not last else (last0, len(levels))
            for k in range(lo, hi):
                if runs[k] == run and levels[k] == level:
                    return k
            return None

        for last, run, level in events:
            a = abs(level)
            k = index(last, run, a)
            if k is not None:
                bw.code(codes[k])
                bw.u(1, level < 0)
                self.stats["tcoef_table"] += 1
                continue
            esc = codes[T.ESCAPE]
            k = index(last, run, a - lmax[last, run]) if lmax[last, run] else None
            if k is not None:
                bw.code(esc)
                bw.u(1, 0)
                bw.code(codes[k])
                bw.u(1, level < 0)
                self.stats["esc1"] += 1
                continue
            r2 = run - rmax[last, a] - 1 if a < 64 and rmax[last, a] >= 0 else -1
            k = index(last, r2, a) if r2 >= 0 else None
            if k is not None:
                bw.code(esc)
                bw.u(2, 2)
                bw.code(codes[k])
                bw.u(1, level < 0)
                self.stats["esc2"] += 1
                continue
            bw.code(esc)
            bw.u(2, 3)
            bw.u(1, last)
            bw.u(6, run)
            bw.u(1, 1)
            bw.u(12, level & 0xFFF)
            bw.u(1, 1)
            self.stats["esc3"] += 1


def write_stream(seed: int, **features) -> tuple[Writer, bytes, list[bytes]]:
    writer = Writer(seed, **features)
    headers, vops = writer.stream()
    return writer, headers, vops


def raw(headers: bytes, vops: list[bytes]) -> bytes:
    """The elementary stream (`.m4v`)."""
    return headers + b"".join(vops)


def write_avi(path, chunks: list[bytes], width: int, height: int, fourcc: bytes = b"XVID",
              fps: int = 30, extradata: bytes = b"") -> None:
    """An AVI of one video stream: `chunks` as its `00dc` chunks (a b"" is a
    dropped frame), `extradata` after the BITMAPINFOHEADER, an idx1 index."""
    n = len(chunks)
    movi, index, pos = b"", b"", 4
    for c in chunks:
        at = c.find(b"\x00\x00\x01\xb6")
        key = at >= 0 and at + 4 < len(c) and c[at + 4] >> 6 == 0
        index += struct.pack("<4sIII", b"00dc", 0x10 if key else 0, pos, len(c))
        movi += b"00dc" + struct.pack("<I", len(c)) + c + b"\x00" * (len(c) & 1)
        pos += 8 + len(c) + (len(c) & 1)
    biggest = max(len(c) for c in chunks)
    avih = struct.pack("<10I16x", 1000000 // fps, 0, 0, 0x10, n, 0, 1, biggest + 8, width,
                       height)
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", fourcc, 0, 0, 0, 0, 1, fps, 0, n,
                       biggest + 8, -1, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), width, height, 1, 24, fourcc,
                       width * height * 3, 0, 0, 0, 0) + extradata
    strl = b"strl" + b"strh" + struct.pack("<I", len(strh)) + strh + b"strf" + \
        struct.pack("<I", len(strf)) + strf + b"\x00" * (len(strf) & 1)
    hdrl = b"hdrl" + b"avih" + struct.pack("<I", len(avih)) + avih + b"LIST" + \
        struct.pack("<I", len(strl)) + strl
    body = b"AVI " + b"LIST" + struct.pack("<I", len(hdrl)) + hdrl + b"LIST" + \
        struct.pack("<I", 4 + len(movi)) + b"movi" + movi + b"idx1" + \
        struct.pack("<I", len(index)) + index
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def write_mp4(path, headers: bytes, vops: list[bytes], width: int, height: int,
              fps: int = 30, boxes: bytes = b"") -> None:
    """An MP4 of `mp4v` (objectTypeIndication 0x20, visual stream), the
    headers as the esds's DecoderSpecificInfo, one VOP a sample, I-VOPs the
    sync samples, as FFmpeg's mov muxer writes cv2's `mp4v`; `boxes` follow
    the esds in the sample entry (a `colr` box)."""
    def descriptor(tag, body):
        return bytes([tag, 0x80, 0x80, 0x80, len(body)]) + body

    def entry(sizes):
        config = descriptor(4, struct.pack(">BB", 0x20, 0x11) + max(sizes).to_bytes(3, "big")
                            + struct.pack(">II", 0, 0) + descriptor(5, headers))
        esds = mp4.full(b"esds", 0, 0, descriptor(3, struct.pack(">HB", 1, 0) + config
                                                  + descriptor(6, b"\x02")))
        return mp4.visual_entry(b"mp4v", width, height, esds, boxes)

    samples = [(v, v.find(b"\x00\x00\x01\xb6") >= 0 and
                v[v.find(b"\x00\x00\x01\xb6") + 4] >> 6 == 0) for v in vops]
    with open(path, "w+b") as f:
        mp4.write_track(f, samples, Fraction(fps), width, height, entry)
