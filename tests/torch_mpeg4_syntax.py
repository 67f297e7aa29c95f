"""A random legal-syntax MPEG-4 Part 2 Simple and Advanced Simple profile
writer, for holding the port's decoder (`omfs4d_torch/io/mpeg4dec.cpp`) to
cv2's FFmpeg.

`Writer(seed, **features).stream()` gives (headers, VOPs): the VOS / VO /
VOL headers and user data, then one VOP a frame in decoding order (a GOV
header before an I-VOP where `gov`); `display` holds each VOP's place in
display order and `kinds` its coding type.  It writes syntax, not pictures:
every syntax element is drawn at random within what the standard allows,
and the writer keeps the decoder's state (DC and AC predictors by block, QP
and vectors by MB, the video packet, the future reference's MB kinds and
vectors for B-VOPs, the time base) only so that what it draws decodes to
legal values:

- the inverse-quantised coefficients (H.263's, or MPEG's through the
  default or loaded matrices) stay within [-2048, 2047] (where the
  standard saturates FFmpeg does not) and a block's absolute sum under
  2,900, so the IDCT's 16-bit rows never overflow;
- an intra DC, predictor included, stays within [0, 2047] after scaling;
- vectors stay within f_code's range, differences coded modulo it;
- TCOEF events are coded the shortest legal way, in the standard's order:
  the table, escape 1 (level - LMAX), escape 2 (run - RMAX - 1), escape 3;
- B-VOP times lie strictly between their references' (FFmpeg skips a B-VOP
  whose TRB is not within (0, TRD)), each VOP's modulo_time_base counted
  from the time base FFmpeg keeps.

`stats` counts what was written (MB kinds, escape modes, prediction
directions, vectors past each edge, ...).  `raw`, `write_avi` and
`write_mp4` put a stream in the three forms cv2 reads: an elementary
`.m4v`, AVI (the headers before the first VOP in its first chunk, as cv2
writes it) and MP4 (`mp4v`, OTI 0x20, the headers in the esds's
DecoderSpecificInfo; `ctts` where B-VOPs reorder the frames); `packed`
lays B-VOPs out as DivX's and Xvid's packed bitstream does.

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
    """Bits MSB first: whole bytes kept as they fill (so a 1080p VOP costs
    no more a bit than a small one), the rest in `acc`."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def u(self, n: int, v: int) -> None:
        if n:
            assert 0 <= v < 1 << n, (n, v)
            self.acc, self.n = self.acc << n | v, self.n + n
            spare = self.n % 8
            if self.n - len(self.out) * 8 - spare >= 64:
                whole = (self.n - spare) // 8 - len(self.out)
                self.out += (self.acc >> spare).to_bytes(whole, "big")
                self.acc &= (1 << spare) - 1

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
        return bytes(self.out) + self.acc.to_bytes(self.n // 8 - len(self.out), "big")


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
REFUSALS = ("sprite", "interlaced", "data_partitioned", "shape", "not_8_bit", "scalability",
            "complexity", "newpred", "reduced_resolution", "obmc", "short_header",
            "chroma_format")
# B-VOP mb_type by index of its code (Table B-4)
B_TYPES = ("direct", "interpolate", "backward", "forward")


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

    Advanced Simple: bframes (B-VOPs between references; the last frame is
    a reference), b_modb (the chance of modb 1: direct with nothing coded),
    b_types (weights of direct, interpolate, backward, forward), b_nocbp (the
    chance of no cbpb), b_dquant (the chance of dbquant), bcode (the
    b_code of each B-VOP in turn), delta (the largest direct-mode mvdb);
    qpel (quarter_sample); quant_type (1: MPEG quantisation), matrices
    (None: the defaults; "loaded": random ones loaded in the VOL, cut short
    at random); stamps (more user data after `stamp`); low_delay (the
    VOL's; default 0 with B-VOPs, else 1); vol_control (False: no
    vol_control_parameters, so no low_delay); dc_over (the chance an intra
    DC passes 2047 once scaled, which FFmpeg's predictor holds at 2047 but
    under an Xvid stamp up to build 32).
    """

    def __init__(self, seed: int, width: int = 48, height: int = 32, frames: int = 4,
                 gop: int = 12, qp=(2, 12), dquant: float = 0.0, ac_pred: float = 0.5,
                 dc_thr=(0,), coded: float = 0.6, big: float = 0.05, long_run: float = 0.05,
                 not_coded: float = 0.15, intra_in_p: float = 0.05, four_mv: float = 0.2,
                 fcode=(1,), far: float = 0.2, packets: float = 0.0, hec: float = 0.0,
                 stuffing: float = 0.0, gov: bool = False, stamp: str | None = LAVC,
                 colour=None, verid: int = 1, vbv: bool = False, par: bool = False,
                 fixed_rate: bool = False, vop_not_coded: float = 0.0, time_res: int = 30,
                 refuse: str | None = None, bframes: int = 0, b_modb: float = 0.1,
                 b_types=(1, 1, 1, 1), b_nocbp: float = 0.2, b_dquant: float = 0.0,
                 bcode=(1,), delta: int = 3, qpel: bool = False, quant_type: int = 0,
                 matrices: str | None = None, stamps=(), low_delay: int | None = None,
                 vol_control: bool = True, dc_over: float = 0.0):
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
        self.bframes, self.p_modb, self.b_weights = bframes, b_modb, np.asarray(b_types, float)
        self.p_nocbp, self.p_bdquant, self.bcodes, self.delta = b_nocbp, b_dquant, bcode, delta
        self.qpel, self.quant_type, self.matrices, self.stamps = qpel, quant_type, matrices, stamps
        self.low_delay = (0 if bframes else 1) if low_delay is None else low_delay
        self.vol_control = vol_control
        self.p_dc_over = dc_over
        xvid = [int(t[4:]) for t in (stamp or "",) + tuple(stamps)
                if t.startswith("XviD") and t[4:].isdigit()]
        self.dc_clip = bool(xvid) and xvid[0] <= 32
        self.asp = bool(bframes or qpel or quant_type)
        if qpel:
            self.verid = 2
        self.intra_w = np.asarray(T.DEFAULT_INTRA_MATRIX)
        self.inter_w = np.asarray(T.DEFAULT_INTER_MATRIX)
        self.loaded: list[list[int]] = [[], []]
        if quant_type and matrices == "loaded":
            for k, default in enumerate((self.intra_w, self.inter_w)):
                n = 64 if self.chance(0.4) else self.draw(1, 63)
                values = [self.draw(6, 80) for _ in range(n)]
                self.loaded[k] = values
                w = np.zeros(64, np.int64)
                for i in range(64):
                    w[T.ZIGZAG[i]] = values[min(i, n - 1)]
                if k == 0:
                    self.intra_w = w
                else:
                    self.inter_w = w
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
        # the future reference, as a B-VOP's direct mode and skips read it
        self.ref_skip, self.ref_four = [False] * n, [False] * n
        self.ref_mvs = [[(0, 0)] * 4 for _ in range(n)]
        self.time_base = self.last_time_base = 0
        self.display: list[int] = []
        self.kinds: list[str] = []

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
        for text in self.stamps:
            out += start(0xB2) + text.encode("latin-1")
        return out

    def vol(self) -> bytes:
        r = self.refuse
        bw = BitWriter()
        bw.u(1, 0)
        bw.u(8, 17 if self.asp else 1)
        verid = 2 if r in ("newpred", "reduced_resolution") else self.verid
        bw.u(1, 1)
        bw.u(4, verid)
        bw.u(3, 1)
        bw.u(4, 15 if self.par else 1)
        if self.par:
            bw.u(8, 12)
            bw.u(8, 11)
        bw.u(1, self.vol_control)                   # vol_control_parameters
        if self.vol_control:
            self.vol_control_parameters(bw, r)
        else:
            assert r != "chroma_format" and not self.vbv
        self.vol_tail(bw, r, verid)
        bw.stuffing()
        return bw.data()

    def vol_control_parameters(self, bw: BitWriter, r) -> None:
        bw.u(2, 2 if r == "chroma_format" else 1)
        bw.u(1, self.low_delay)
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

    def vol_tail(self, bw: BitWriter, r, verid: int) -> None:
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
        bw.u(1, self.quant_type)
        if self.quant_type:
            for values in self.loaded:              # load_intra / load_nonintra_quant_mat
                bw.u(1, bool(values))
                for v in values:
                    bw.u(8, v)
                if values and len(values) < 64:
                    bw.u(8, 0)
                if values:
                    self.stats["matrix_loaded" if len(values) == 64 else "matrix_cut"] += 1
        if verid != 1:
            bw.u(1, self.qpel)
        bw.u(1, r != "complexity")                  # complexity_estimation_disable
        bw.u(1, self.p_packet == 0)                 # resync_marker_disable
        bw.u(1, r == "data_partitioned")
        if r == "data_partitioned":
            bw.u(1, 0)
        if verid != 1:
            bw.u(1, r == "newpred")
            bw.u(1, r == "reduced_resolution")
        bw.u(1, r == "scalability")

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
    def order(self) -> list[tuple[int, str]]:
        """(display index, coding type) of each VOP in decoding order: a
        reference every bframes + 1 frames and at the last one (an I-VOP at
        each multiple of gop), then the B-VOPs shown before it."""
        refs = sorted(set(range(0, self.frames, self.bframes + 1)) | {self.frames - 1})
        out, prev = [], None
        for r in refs:
            out.append((r, "I" if r % self.gop == 0 else "P"))
            if prev is not None:
                out += [(f, "B") for f in range(prev + 1, r)]
            prev = r
        return out

    def stream(self) -> tuple[bytes, list[bytes]]:
        headers = self.headers()
        vops = []
        order = self.order()
        for k, (f, kind) in enumerate(order):
            data = self.gov_header(self.gov_frame(order, k)) if self.gov and kind == "I" else b""
            data += self.vop(f, kind)
            vops.append(data)
            self.display.append(f)
            self.kinds.append(kind)
        return headers, vops

    def gov_frame(self, order, k: int) -> int:
        """The frame a GOV before the k-th VOP (an I-VOP) dates itself by:
        its own, or with B-VOPs the reference before it, whose time base the
        B-VOPs shown before the I-VOP count from."""
        f = order[k][0]
        if not self.bframes:
            return f
        prev = [d for d, kind in order[:k] if kind != "B"]
        return prev[-1] if prev else f

    def time_code(self, bw: BitWriter, frame: int, kind: str) -> None:
        """modulo_time_base and vop_time_increment of a VOP shown at `frame`:
        with no B-VOPs a second marked at each whole second, as FFmpeg's
        encoder marks it; with them the seconds since the time base FFmpeg
        keeps (the last reference's, a B-VOP's the one before)."""
        seconds = 0
        if not self.bframes:
            seconds = int(bool(frame and frame % self.time_res == 0))
        elif kind == "B":
            seconds = frame // self.time_res - self.last_time_base
        else:
            seconds = frame // self.time_res - self.time_base
            self.last_time_base, self.time_base = self.time_base, frame // self.time_res
        assert seconds >= 0, (frame, kind)
        for _ in range(seconds):
            bw.u(1, 1)                              # modulo_time_base: a second has passed
        bw.u(1, 0)
        bw.u(1, 1)
        bw.u(self.time_bits, frame % self.time_res)
        bw.u(1, 1)

    def vop(self, frame: int, kind: str) -> bytes:
        bw = BitWriter()
        bw.u(2, "IPB".index(kind))
        self.time_code(bw, frame, kind)
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
        self.fcode = int(self.fcodes[frame % len(self.fcodes)]) if kind != "I" else 1
        self.bcode = int(self.bcodes[frame % len(self.bcodes)]) if kind == "B" else 1
        if kind == "P":
            bw.u(1, self.rounding)
            self.stats[f"rounding{self.rounding}"] += 1
        bw.u(3, self.dc_thr)
        bw.u(5, qp)
        if kind != "I":
            bw.u(3, self.fcode)
            self.stats[f"fcode{self.fcode}"] += 1
        if kind == "B":
            bw.u(3, self.bcode)
            self.stats[f"bcode{self.bcode}"] += 1
        self.stats[f"dc_thr{self.dc_thr}"] += 1
        self.stats[f"vop_{kind}"] += 1
        self.packet_start = 0
        n = self.mbw * self.mbh
        if kind == "B":
            self.b_vop(bw, frame, qp)
            bw.stuffing()
            return start(0xB6) + bw.data()
        self.mb_intra = [False] * n
        for mbn in range(n):
            if mbn and self.chance(self.p_packet):
                qp = self.packet_header(bw, mbn, frame, qp)
            qp = self.macroblock(bw, mbn, qp)
        # what the B-VOPs before the next reference read of this one
        for mbn in range(n):
            if kind == "I":
                self.ref_skip[mbn], self.ref_four[mbn] = False, False
            self.ref_mvs[mbn] = list(self.mvs[mbn])
        bw.stuffing()
        return start(0xB6) + bw.data()

    # ── B-VOPs ──────────────────────────────────────────────────────────
    def b_vop(self, bw: BitWriter, frame: int, qp: int) -> None:
        """The MBs of a B-VOP shown at `frame` between the two references."""
        before = [d for d, k in zip(self.display, self.kinds) if k != "B"]
        trd, trb = before[-1] - before[-2], frame - before[-2]
        last = [[0, 0], [0, 0]]
        coded_yet = False
        for mbn in range(self.mbw * self.mbh):
            if mbn % self.mbw == 0:
                last = [[0, 0], [0, 0]]
            if self.ref_skip[mbn]:                  # skipped as in the future reference
                self.stats["B_colocated_skip"] += 1
                continue
            if coded_yet and self.chance(self.p_packet):
                qp = self.packet_header(bw, mbn, frame, qp)
                last = [[0, 0], [0, 0]]
            coded_yet = True
            qp = self.b_macroblock(bw, mbn, qp, last, trb, trd)

    def b_macroblock(self, bw: BitWriter, mbn: int, qp: int, last, trb: int, trd: int) -> int:
        if self.chance(self.p_modb):
            bw.u(1, 1)                              # modb 1: direct, nothing coded
            self.stats["B_modb1"] += 1
            self.stats["direct4" if self.ref_four[mbn] else "direct1"] += 1
            return qp
        bw.u(1, 0)
        kind = int(self.rng.choice(4, p=self.b_weights / self.b_weights.sum()))
        name = B_TYPES[kind]
        delta = 0
        if name != "direct" and self.chance(self.p_bdquant):
            delta = int(self.rng.choice([d for d in (-2, 2) if 1 <= qp + d <= 31]))
        nocbp = self.chance(self.p_nocbp)
        blocks = [([], 0)] * 6 if nocbp else [self.inter_block(qp + delta) for _ in range(6)]
        cbp = [bool(b) for b, _ in blocks]
        if not any(cbp):
            delta = 0
        bw.u(1, nocbp)
        bw.code(T.MB_TYPE_B[kind])
        if not nocbp:
            for c in cbp:
                bw.u(1, c)
        if name != "direct" and any(cbp):
            bw.code(T.DBQUANT[(0, -2, 2).index(delta)])
            self.stats["dbquant" if delta else "dbquant0"] += 1
        self.stats[f"B_{name}"] += 1
        self.stats["B_nocbp" if nocbp else "B_cbp"] += 1
        qp += delta
        if name in ("interpolate", "forward"):
            last[0] = self.b_vector(bw, last[0], self.fcode, "fwd")
        if name in ("interpolate", "backward"):
            last[1] = self.b_vector(bw, last[1], self.bcode, "bwd")
        if name == "direct":
            for _ in range(2):
                d = self.draw(-self.delta, self.delta) if self.chance(0.6) else 0
                self.write_mv_f(bw, d, 1)
                self.stats["mvdb_nonzero" if d else "mvdb_zero"] += 1
            self.stats["direct4" if self.ref_four[mbn] else "direct1"] += 1
            if self.ref_four[mbn] or any(self.ref_mvs[mbn]):
                self.stats["direct_scaled"] += 1
        for events, _ in blocks:
            if events:
                self.write_tcoef(bw, events, False)
        return qp

    def b_vector(self, bw: BitWriter, pred, fcode: int, name: str) -> list[int]:
        scale = 1 << (fcode - 1)
        lo, hi = -32 * scale, 32 * scale - 1
        if self.chance(self.p_far):
            v = [self.draw(lo, hi), self.draw(lo, hi)]
        else:
            v = [min(hi, max(lo, p + self.draw(-6, 6))) for p in pred]
        for c in (0, 1):
            self.write_mv_f(bw, (v[c] - pred[c] + 32 * scale) % (64 * scale) - 32 * scale, fcode)
        self.stats[f"mv_{name}"] += 1
        self.frac_stats(v)
        return v

    def frac_stats(self, v) -> None:
        if self.qpel:
            self.stats[f"qpel{v[0] & 3}{v[1] & 3}"] += 1
        else:
            self.stats["mv_half" if (v[0] | v[1]) & 1 else "mv_full"] += 1

    def packet_header(self, bw: BitWriter, mbn: int, frame: int, qp: int) -> int:
        bw.stuffing()
        zeros = 16 if self.kind == "I" else 15 + self.fcode if self.kind == "P" else \
            15 + max(self.fcode, self.bcode, 2)
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
            bw.u(2, "IPB".index(self.kind))
            bw.u(3, self.dc_thr)
            if self.kind != "I":
                bw.u(3, self.fcode)
            if self.kind == "B":
                bw.u(3, self.bcode)
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
            self.ref_skip[mbn], self.ref_four[mbn] = True, False
            return qp
        intra = self.kind == "I" or self.chance(self.p_intra)
        four = not intra and self.chance(self.p_four)
        self.ref_skip[mbn], self.ref_four[mbn] = False, four
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

    def mpeg_level(self, level: int, qp: int, weight: int, intra: bool) -> int:
        """The inverse-quantised magnitude of a level under MPEG
        quantisation (7.4.4.2, as FFmpeg truncates it)."""
        return ((level * 2 * qp * weight) >> 4 if intra
                else ((2 * level + 1) * 2 * qp * weight) >> 5)

    def random_levels(self, positions: range, qp: int, budget: int = 2900, scan=None,
                      intra: bool = False) -> dict[int, int]:
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
            if self.quant_type:
                weight = int((self.intra_w if intra else self.inter_w)[scan[pos]])
                # the largest level whose inverse quantisation stays within 2047
                bound = (32767 // (2 * qp * weight) if intra
                         else (65535 // (2 * qp * weight) - 1) // 2)
            if self.chance(self.p_big):
                level = self.draw(1, bound)
            else:
                level = min(bound, int(self.rng.choice([1, 1, 1, 1, 2, 2, 3, 4, 6, 9, 13])))
            cost = (self.mpeg_level(level, qp, weight, intra) if self.quant_type
                    else (2 * level + 1) * qp)
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
        if self.chance(self.p_dc_over) and (hi + 1) * scale > 2047:
            dc = hi + 1                             # past 2047 once scaled
            self.stats["dc_over"] += 1
        qf[0] = dc
        if self.chance(self.p_coded):
            for pos, level in self.random_levels(range(1, 64), qp, 2900 - dc * scale, scan,
                                                 True).items():
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
        # the predictor as FFmpeg keeps it: held at 2047, or not under the
        # DC_CLIP workaround of Xvid builds up to 32
        self.dc[mbn][n] = int(dc * scale) if self.dc_clip else min(2047, int(dc * scale))
        self.ac[mbn][n] = [0] + [int(qf[8 * i]) for i in range(1, 8)] + [0] + \
            [int(qf[i]) for i in range(1, 8)]
        first = 1 if dc_vlc else 0
        events = self.events(coded, scan, first)
        return events, int(coded[0])

    def inter_block(self, qp: int):
        if not self.chance(self.p_coded):
            return [], 0
        qf = np.zeros(64, np.int64)
        for pos, level in self.random_levels(range(0, 64), qp, scan=T.ZIGZAG).items():
            qf[T.ZIGZAG[pos]] = level
        if self.quant_type and qf.any():
            total = sum(self.mpeg_level(abs(int(v)), qp, int(self.inter_w[k]), False)
                        for k, v in enumerate(qf) if v)
            self.stats["mismatch_even" if total % 2 == 0 else "mismatch_odd"] += 1
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
            size, sh = 8 if four else 16, 2 if self.qpel else 1
            x = 16 * mx + (8 * (k & 1) if four else 0) + (v[0] >> sh)
            y = 16 * my + (8 * (k >> 1) if four else 0) + (v[1] >> sh)
            frac = (1 << sh) - 1
            edges = {"left": x < 0, "top": y < 0,
                     "right": x + size + bool(v[0] & frac) > self.w,
                     "bottom": y + size + bool(v[1] & frac) > self.h}
            for name, past in edges.items():
                self.stats[f"mv_past_{name}"] += past
            self.frac_stats(v)
        if four:
            cx = chroma_vector(sum(v[0] for v in self.mvs[mbn]))
            self.stats[f"chroma4_{abs(sum(v[0] for v in self.mvs[mbn])) & 15}"] += 1
            self.stats["chroma4_half" if cx & 1 else "chroma4_full"] += 1
        return diffs

    def write_mv(self, bw: BitWriter, d: int) -> None:
        self.write_mv_f(bw, d, self.fcode)

    def write_mv_f(self, bw: BitWriter, d: int, fcode: int) -> None:
        r = fcode - 1
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


def avi_chunks(writer: Writer, headers: bytes, vops: list[bytes],
               pack: str | None = None) -> list[bytes]:
    """An AVI's chunks of a stream: the headers before the first VOP, as cv2
    writes them; `pack` lays B-VOPs out as `packed` does."""
    samples = packed(writer, vops, pack) if pack else vops
    return [headers + samples[0]] + samples[1:]


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


def esds(headers: bytes, biggest: int) -> bytes:
    """The esds box of an `mp4v` sample entry: objectTypeIndication 0x20
    (visual stream), the headers as its DecoderSpecificInfo."""
    def descriptor(tag, body):
        n = len(body)
        return bytes([tag, n >> 21 & 0x7F | 0x80, n >> 14 & 0x7F | 0x80, n >> 7 & 0x7F | 0x80,
                      n & 0x7F]) + body

    config = descriptor(4, struct.pack(">BB", 0x20, 0x11) + biggest.to_bytes(3, "big")
                        + struct.pack(">II", 0, 0) + descriptor(5, headers))
    return mp4.full(b"esds", 0, 0, descriptor(3, struct.pack(">HB", 1, 0) + config
                                              + descriptor(6, b"\x02")))


def is_key(sample: bytes) -> bool:
    """A sample whose first VOP is an I-VOP."""
    at = sample.find(b"\x00\x00\x01\xb6")
    return at >= 0 and at + 4 < len(sample) and sample[at + 4] >> 6 == 0


def write_mp4(path, headers: bytes, vops: list[bytes], width: int, height: int,
              fps: int = 30, boxes: bytes = b"", display: list[int] | None = None,
              media_time=None) -> None:
    """An MP4 of `mp4v` (objectTypeIndication 0x20, visual stream), the
    headers as the esds's DecoderSpecificInfo, one VOP a sample, I-VOPs the
    sync samples, as FFmpeg's mov muxer writes cv2's `mp4v`; `boxes` follow
    the esds in the sample entry (a `colr` box).  With `display` (each VOP's
    place in display order: B-VOPs) the file has `ctts` as FFmpeg's mov
    muxer lays out reordered frames, and an edit list from `media_time`
    ("ctts": the first sample's offset; None: none)."""
    if display is not None:
        from tests import torch_h264_syntax as hsyn

        sync = [i + 1 for i, v in enumerate(vops) if is_key(v)]
        hsyn.write_track_file(path, vops, sync, b"mp4v",
                              esds(headers, max(len(v) for v in vops)) + boxes, width, height,
                              fps, audio=False, quicktime=False, media_time=media_time,
                              display=display)
        return

    def entry(sizes):
        return mp4.visual_entry(b"mp4v", width, height, esds(headers, max(sizes)), boxes)

    with open(path, "w+b") as f:
        mp4.write_track(f, [(v, is_key(v)) for v in vops], Fraction(fps), width, height, entry)


def n_vop(time_bits: int, frame: int, time_res: int) -> bytes:
    """A VOP that is not coded (P, vop_coded 0): the placeholder of DivX's
    and Xvid's packed bitstream."""
    bw = BitWriter()
    bw.u(2, 1)
    bw.u(1, 0)
    bw.u(1, 1)
    bw.u(time_bits, frame % time_res)
    bw.u(1, 1)
    bw.u(1, 0)
    bw.stuffing()
    return start(0xB6) + bw.data()


def packed(writer: Writer, vops: list[bytes], placeholder: str = "nvop") -> list[bytes]:
    """The VOPs laid out as DivX's (and Xvid's, packed) bitstream lays out
    B-VOPs: a reference's sample holds the first B-VOP after it too, each
    further B-VOP moves one sample on, and the group ends in a placeholder,
    an N-VOP ("nvop") or a chunk of one byte ("byte"); as many samples as
    VOPs."""
    out, k = [], 0
    kinds = writer.kinds
    while k < len(vops):
        if kinds[k] != "B" and k + 1 < len(vops) and kinds[k + 1] == "B":
            j = k + 1
            while j < len(vops) and kinds[j] == "B":
                j += 1
            out.append(vops[k] + vops[k + 1])
            out += vops[k + 2:j]
            out.append(n_vop(writer.time_bits, writer.display[k], writer.time_res)
                       if placeholder == "nvop" else b"\x7f")
            k = j
        else:
            out.append(vops[k])
            k += 1
    assert len(out) == len(vops)
    return out
