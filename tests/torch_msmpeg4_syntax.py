"""A random legal-syntax writer of Microsoft's MPEG-4 family, MS MPEG-4 v2 and
v3 and WMV1 / WMV2, for the port's decoder tests, and a test muxer of ASF
around it.

`write_stream(seed, version, plan, **options)` writes the pictures of
`plan` ("I" and "P", one packet each) with their syntax drawn at random
within what FFmpeg decodes: every slice code, both DC, MV and run-level
table choices and per-MB run-level tables, the three escapes of the
run-level codes (WMV's escape 3 with its lengths fixed at a picture's
first), AC prediction, skipped MBs (v2 / v3 / WMV1's skip bit, WMV2's four
skip map types), intra MBs of P pictures, WMV1's inter-intra directions,
flip-flop rounding, and WMV2's CBP tables, mspel and hshift,
top_left_mv_flag's choice, ABT's 8x4 and 4x8 blocks (per picture, MB or
block) and the loop filter.  It mirrors the decoder's state only where the
syntax depends on it (the I picture's coded block prediction, the vector
predictors that decide WMV2's predictor bit and hshift, the positions of a
block's coefficients); the pictures are whatever the decoder makes of it,
held to cv2's decode.  The tables come from the port's own
`msmpeg4_tables`, its header fields are read back through the port's own
parser (`msmpeg4.picture_type`, `msmpeg4.wmv2_extradata`).

`write_asf(path, packets, ...)` lays packets into an ASF file: header
objects (file and stream properties with the BITMAPINFOHEADER and its
extradata, an empty header extension), then data packets of one fixed
size with error correction data, in one of three layouts: a payload a
packet, several payloads a packet, or compressed payloads (sub-payloads of
whole objects); objects split across packets, explicit padding.
`write_avi` is `torch_mkv_mux.write_avi`'s.
"""

from __future__ import annotations

import importlib.util
import struct
import sys
import uuid
from collections import Counter
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from omfs4d_torch.io import mpeg4_tables as M4  # noqa: E402
from omfs4d_torch.io import msmpeg4_tables as T  # noqa: E402

V2, V3, WMV1, WMV2 = 2, 3, 4, 5
FOURCC = {V2: b"MP42", V3: b"MP43", WMV1: b"WMV1", WMV2: b"WMV2"}


def _mkv_mux():
    """tests/torch_mkv_mux.py, loaded by its path."""
    spec = importlib.util.spec_from_file_location("torch_mkv_mux", HERE / "torch_mkv_mux.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def u(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.bits.append(v >> k & 1)

    def code(self, cl) -> None:
        self.u(int(cl[0]), int(cl[1]))

    def u012(self, v: int) -> None:
        self.u(0, 1) if v == 0 else self.u(2 + (v - 1), 2)

    def bytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[k:k + 8])), 2) for k in range(0, len(bits), 8))


def _mid(a: int, b: int, c: int) -> int:
    return max(min(a, b), min(max(a, b), c))


class _Rl:
    """One run-level table as the writer codes it: (last, run, level) ->
    code, and LMAX / RMAX."""

    def __init__(self, k: int):
        rl = T.RL[k]
        self.codes, self.n, self.last = rl["codes"], rl["n"], rl["last"]
        self.entries = [(int(i >= rl["last"]), int(rl["run"][i]), int(rl["level"][i]))
                        for i in range(rl["n"])]
        self.index = {e: i for i, e in enumerate(self.entries)}
        self.max_level, self.max_run = rl["max_level"], np.maximum(rl["max_run"], 0)

    def code(self, last: int, run: int, level: int):
        return self.codes[self.index[(last, run, level)]]


RLS = [_Rl(k) for k in range(6)]
MV_CODES = [dict(zip(syms.tolist(), zip(T.mv_codes(lens).tolist(), lens.tolist())))
            for lens, syms in T.MV_TABLES]


class Writer:
    """The state of one stream: its version, size, WMV2's extended header,
    and what the syntax of the next picture depends on."""

    def __init__(self, seed: int, version: int, width: int = 48, height: int = 32, **o):
        self.rng = np.random.default_rng(seed)
        self.v, self.w, self.h = version, width, height
        self.mbw, self.mbh = (width + 15) // 16, (height + 15) // 16
        self.o = o
        self.stats: Counter = Counter()
        r = self.rng
        self.bit_rate = int(o.get("bit_rate", r.choice([20, 60, 200, 900])))   # kbit/s / 1.024
        self.slice_height = 1
        if version == WMV2:
            self.ext = {"mspel_bit": int(o.get("mspel_bit", r.random() < 0.7)),
                        "loop_filter": int(o.get("loop_filter", r.random() < 0.5)),
                        "abt_flag": int(o.get("abt_flag", r.random() < 0.7)),
                        "j_type_bit": int(o.get("j_type_bit", r.random() < 0.5)),
                        "top_left_mv_flag": int(o.get("top_left_mv_flag", r.random() < 0.6)),
                        "per_mb_rl_bit": int(o.get("per_mb_rl_bit", r.random() < 0.5)),
                        "slice_code": int(o.get("slice_code", r.integers(1, min(self.mbh, 7) + 1)))}
            self.slice_height = self.mbh // self.ext["slice_code"]
            for k, v in self.ext.items():
                self.stats[f"ext_{k}_{v}" if k != "slice_code" else f"wmv2_slices_{v}"] += 1

    # ── extradata ──
    def extradata(self) -> bytes:
        if self.v != WMV2:
            return b""
        bw = BitWriter()
        bw.u(30, 5)
        bw.u(self.bit_rate & 0x7FF, 11)
        for k in ("mspel_bit", "loop_filter", "abt_flag", "j_type_bit", "top_left_mv_flag",
                  "per_mb_rl_bit"):
            bw.u(self.ext[k], 1)
        bw.u(self.ext["slice_code"], 3)
        return bw.bytes()

    # ── coefficients ──
    def _block(self, bw: BitWriter, rl: _Rl, n_max: int, start: int, run_diff: int) -> None:
        """A coded block's coefficients (at least one, the last flagged),
        their dequantised magnitudes summing to at most `budget` (FFmpeg's
        x86 IDCT saturates where the port's, like FFmpeg's C one, wraps)."""
        r, o = self.rng, self.o
        q = self.q
        cost = lambda m: m * 2 * q + ((q - 1) | 1)  # noqa: E731
        left = o.get("budget", 1400)
        i = start
        count = int(r.integers(1, 1 + o.get("coefs", 6)))
        for k in range(count):
            room = n_max - 1 - i                  # the farthest this coefficient may go
            last = int(k == count - 1 or room <= 1 or left < 3 * cost(1))
            if not last:
                room -= 1                         # leave a position for the next one
            sign = int(r.random() < 0.5)
            kinds = ["direct", "esc1", "esc2", "esc3"]
            p = _norm([1.0, o.get("escape", 0.1), o.get("escape", 0.1), o.get("escape", 0.1)])
            level = None
            for _ in range(8):
                kind = str(r.choice(kinds, p=p))
                cands = [e for e in rl.entries if e[0] == last and e[1] + 1 <= room]
                if kind == "esc2":
                    cands = [e for e in cands
                             if e[1] + 1 + int(rl.max_run[last, e[2]]) + run_diff <= room]
                if kind == "esc1":
                    cands = [e for e in cands if cost(e[2] + int(rl.max_level[last, e[1]]))
                             <= left]
                else:
                    cands = [e for e in cands if cost(e[2]) <= left]
                if kind == "esc3" or cands:
                    break
            else:
                kind = "esc3"
            self.stats[kind] += 1
            if kind != "esc3":
                small = [e for e in cands if e[2] <= o.get("level", 3)] or cands
                e = small[int(r.integers(len(small)))]
                bw.code(rl.codes[rl.n] if kind != "direct" else rl.code(*e))
                if kind == "esc1":
                    bw.u(1, 1)
                elif kind == "esc2":
                    bw.u(1, 2)
                if kind != "direct":
                    bw.code(rl.code(*e))
                bw.u(sign, 1)
                adv = e[1] + 1 + (int(rl.max_run[last, e[2]]) + run_diff if kind == "esc2" else 0)
                level = e[2] + (int(rl.max_level[last, e[1]]) if kind == "esc1" else 0)
            else:
                run = int(r.integers(0, max(min(room, 8), 1)))
                bw.code(rl.codes[rl.n])
                bw.u(0, 2)
                top = max(1, min(120, (left - ((q - 1) | 1)) // (2 * q)))
                run, level = self._escape3(bw, last, run, sign, top)
                adv = run + 1
            left -= cost(level)
            i += adv
            if last:
                return

    def _escape3(self, bw: BitWriter, last: int, run: int, sign: int, top: int
                 ) -> tuple[int, int]:
        """Escape 3 of a coefficient at most `top`: (its run, its level)."""
        r = self.rng
        if self.v <= V3:
            level = int(r.integers(1, min(top, 127) + 1))
            bw.u(last, 1)
            bw.u(run, 6)
            bw.u((-level if sign else level) & 0xFF, 8)
            return run, level
        bw.u(last, 1)
        if self.esc3 is None:
            if self.q < 8:
                ll = int(r.choice([1, 2, 3, 4, 5, 6, 7, 8, 9]))
                if ll >= 8:
                    bw.u(0, 3)
                    bw.u(ll - 8, 1)
                else:
                    bw.u(ll, 3)
            else:
                ll = int(r.integers(2, 9))
                bw.u(0, ll - 2)
                if ll < 8:
                    bw.u(1, 1)
            rlen = int(r.integers(3, 7))
            bw.u(rlen - 3, 2)
            self.esc3 = (ll, rlen)
            self.stats[f"esc3_level_len_{ll}"] += 1
        ll, rlen = self.esc3
        run = min(run, (1 << rlen) - 1)
        level = int(r.integers(1, max(2, min(1 << ll, top + 1))))
        bw.u(run, rlen)
        bw.u(sign, 1)
        bw.u(level, ll)
        return run, level

    # ── vectors ──
    def _pred(self, mx: int, my: int, first: bool) -> tuple[int, int]:
        a = self.mv.get((mx - 1, my), (0, 0))
        if first:
            return (0, 0) if mx == 0 else a
        b = self.mv.get((mx, my - 1), (0, 0))
        c = self.mv.get((mx + 1, my - 1), (0, 0))
        return _mid(a[0], b[0], c[0]), _mid(a[1], b[1], c[1])

    def _mv(self, bw: BitWriter, px: int, py: int) -> tuple[int, int]:
        r = self.rng
        if r.random() < 0.1:
            self.stats["mv_escape"] += 1
            x, y = int(r.integers(0, 64)), int(r.integers(0, 64))
            bw.code(MV_CODES[self.mv_index][0])
            bw.u(x, 6)
            bw.u(y, 6)
        else:
            spread = self.o.get("spread", 4)
            x = int(np.clip(32 + r.integers(-spread, spread + 1), 0, 63))
            y = int(np.clip(32 + r.integers(-spread, spread + 1), 0, 63))
            key = x << 8 | y
            if key not in MV_CODES[self.mv_index]:
                key = 32 << 8 | 32
                x = y = 32
            bw.code(MV_CODES[self.mv_index][key])
        vx, vy = x + px - 32, y + py - 32
        vx = vx + 64 if vx <= -64 else vx - 64 if vx >= 64 else vx
        vy = vy + 64 if vy <= -64 else vy - 64 if vy >= 64 else vy
        return vx, vy

    def _v2_component(self, bw: BitWriter, pred: int) -> int:
        code = int(self.rng.integers(0, 6))
        bw.code(M4.MV[code])
        val = pred
        if code:
            sign = int(self.rng.random() < 0.5)
            bw.u(sign, 1)
            val = pred + (-code if sign else code)
            val = val + 64 if val <= -64 else val - 64 if val >= 64 else val
        return val

    # ── pictures ──
    def picture(self, kind: str) -> bytes:
        r, o, v = self.rng, self.o, self.v
        bw = BitWriter()
        self.q = int(o.get("q", r.integers(1, 32)))
        self.esc3 = None
        self.mv = {}
        self.coded = {}
        self.stats[f"pict_{kind}"] += 1
        self.stats["q_lt8" if self.q < 8 else "q_ge8"] += 1
        intra_pic = kind == "I"
        self.per_mb_rl = 0
        self.inter_intra = 0
        self.mspel = self.per_mb_abt = self.abt_type = 0
        skip_map = None
        if v != WMV2:
            bw.u(0 if intra_pic else 1, 2)
            bw.u(self.q, 5)
            if intra_pic:
                n = int(o.get("slices", r.integers(1, min(self.mbh, 9) + 1)))
                bw.u(0x16 + n, 5)
                self.slice_height = self.mbh // n
                self.stats[f"slices_{n}"] += 1
                if v == V3:
                    self.rl_chroma, self.rl = int(r.integers(3)), int(r.integers(3))
                    bw.u012(self.rl_chroma)
                    bw.u012(self.rl)
                    self.dc_index = int(r.integers(2))
                    bw.u(self.dc_index, 1)
                elif v == WMV1:
                    bw.u(30, 5)
                    bw.u(self.bit_rate, 11)
                    self.flipflop = int(r.random() < 0.5)
                    bw.u(self.flipflop, 1)
                    if self.bit_rate * 1024 > 50 * 1024:
                        self.per_mb_rl = int(r.random() < 0.5)
                        bw.u(self.per_mb_rl, 1)
                    if not self.per_mb_rl:
                        self.rl_chroma, self.rl = int(r.integers(3)), int(r.integers(3))
                        bw.u012(self.rl_chroma)
                        bw.u012(self.rl)
                    else:
                        self.rl_chroma = self.rl = 0
                    self.dc_index = int(r.integers(2))
                    bw.u(self.dc_index, 1)
                else:
                    self.rl_chroma = self.rl = 2
                    self.dc_index = 0
            else:
                self.use_skip = int(r.random() < 0.8)
                bw.u(self.use_skip, 1)
                if v == V2:
                    self.rl_chroma = self.rl = 2
                    self.dc_index = self.mv_index = 0
                elif v == V3:
                    self.rl = self.rl_chroma = int(r.integers(3))
                    bw.u012(self.rl)
                    self.dc_index, self.mv_index = int(r.integers(2)), int(r.integers(2))
                    bw.u(self.dc_index, 1)
                    bw.u(self.mv_index, 1)
                else:
                    if self.bit_rate * 1024 > 50 * 1024:
                        self.per_mb_rl = int(r.random() < 0.5)
                        bw.u(self.per_mb_rl, 1)
                    self.rl = self.rl_chroma = 0
                    if not self.per_mb_rl:
                        self.rl = self.rl_chroma = int(r.integers(3))
                        bw.u012(self.rl)
                    self.dc_index, self.mv_index = int(r.integers(2)), int(r.integers(2))
                    bw.u(self.dc_index, 1)
                    bw.u(self.mv_index, 1)
                    self.inter_intra = int(self.w * self.h < 320 * 240
                                           and self.bit_rate * 1024 <= 128 * 1024)
                    self.stats[f"inter_intra_{self.inter_intra}"] += 1
        else:
            e = self.ext
            bw.u(0 if intra_pic else 1, 1)
            if intra_pic:
                bw.u(int(r.integers(128)), 7)
            bw.u(self.q, 5)
            if intra_pic:
                if e["j_type_bit"]:
                    bw.u(0, 1)
                if e["per_mb_rl_bit"]:
                    self.per_mb_rl = int(r.random() < 0.5)
                    bw.u(self.per_mb_rl, 1)
                self.rl = self.rl_chroma = 0
                if not self.per_mb_rl:
                    self.rl_chroma, self.rl = int(r.integers(3)), int(r.integers(3))
                    bw.u012(self.rl_chroma)
                    bw.u012(self.rl)
                self.dc_index = int(r.integers(2))
                bw.u(self.dc_index, 1)
            else:
                skip_map = self._skip_map(bw)
                cbp012 = int(r.integers(3))
                bw.u012(cbp012)
                self.cbp_index = [[0, 2, 1], [1, 0, 2], [2, 1, 0]][(self.q > 10)
                                                                   + (self.q > 20)][cbp012]
                self.stats[f"cbp_index_{self.cbp_index}"] += 1
                if e["mspel_bit"]:
                    self.mspel = int(r.random() < 0.6)
                    bw.u(self.mspel, 1)
                    self.stats[f"mspel_{self.mspel}"] += 1
                if e["abt_flag"]:
                    self.per_mb_abt = int(r.random() < 0.5)
                    bw.u(self.per_mb_abt ^ 1, 1)
                    if not self.per_mb_abt:
                        self.abt_type = int(r.integers(3))
                        bw.u012(self.abt_type)
                        self.stats[f"abt_picture_{self.abt_type}"] += 1
                if e["per_mb_rl_bit"]:
                    self.per_mb_rl = int(r.random() < 0.5)
                    bw.u(self.per_mb_rl, 1)
                self.rl = self.rl_chroma = 0
                if not self.per_mb_rl:
                    self.rl = self.rl_chroma = int(r.integers(3))
                    bw.u012(self.rl)
                self.dc_index, self.mv_index = int(r.integers(2)), int(r.integers(2))
                bw.u(self.dc_index, 1)
                bw.u(self.mv_index, 1)
        if self.per_mb_rl:
            self.stats["per_mb_rl"] += 1
        self.stats[f"dc_table_{self.dc_index}"] += 1
        if not intra_pic:
            self.stats[f"mv_table_{self.mv_index}"] += 1
        for my in range(self.mbh):
            first = my % self.slice_height == 0
            for mx in range(self.mbw):
                self._mb(bw, mx, my, first, intra_pic, skip_map)
        if intra_pic and v <= V3:
            # the extended header at the end of an I picture
            bw.u(30, 5)
            bw.u(self.bit_rate, 11)
            if v == V3:
                self.flipflop = int(r.random() < 0.6)
                bw.u(self.flipflop, 1)
                self.stats[f"flipflop_{self.flipflop}"] += 1
        return bw.bytes()

    def _skipped_picture(self) -> bytes:
        """A WMV2 P picture whose row skip map skips every MB (FFmpeg shows
        no frame for it)."""
        bw = BitWriter()
        bw.u(1, 1)
        bw.u(int(self.rng.integers(1, 32)), 5)
        bw.u(2, 2)
        for _ in range(self.mbh):
            bw.u(1, 1)
        self.stats["whole_picture_skipped"] += 1
        return bw.bytes()

    def _skip_map(self, bw: BitWriter):
        """WMV2's skip map: its type and bits (a map that skips every MB by
        rows or columns is left to `_skipped_picture`)."""
        r = self.rng
        kind = int(r.choice(4, p=[0.4, 0.2, 0.2, 0.2]))
        bw.u(kind, 2)
        self.stats[f"skip_type_{kind}"] += 1
        m = np.zeros((self.mbh, self.mbw), bool)
        p = self.o.get("skip", 0.3)
        if kind == 1:
            m = r.random((self.mbh, self.mbw)) < p
            for v in m.ravel():
                bw.u(int(v), 1)
        elif kind in (2, 3):
            lines = self.mbh if kind == 2 else self.mbw
            for k in range(lines):
                # not every line whole: that is `_skipped_picture`'s
                whole = bool(r.random() < p) and not (k == lines - 1 and m.all(
                    axis=1 if kind == 2 else 0)[:k].all())
                bw.u(int(whole), 1)
                sl = (k, slice(None)) if kind == 2 else (slice(None), k)
                if whole:
                    m[sl] = True
                else:
                    bits = r.random(self.mbw if kind == 2 else self.mbh) < p
                    m[sl] = bits
                    for b in bits:
                        bw.u(int(b), 1)
        return m

    def _mb(self, bw: BitWriter, mx: int, my: int, first: bool, intra_pic: bool, skip_map):
        r, o, v = self.rng, self.o, self.v
        if not intra_pic:
            if v == WMV2:
                if skip_map[my, mx]:
                    self.mv[(mx, my)] = (0, 0)
                    self.stats["skipped"] += 1
                    return
            elif self.use_skip:
                skip = bool(r.random() < o.get("skip", 0.3))
                bw.u(int(skip), 1)
                if skip:
                    self.mv[(mx, my)] = (0, 0)
                    self.stats["skipped"] += 1
                    return
        intra = intra_pic or bool(r.random() < o.get("intra", 0.15))
        cbp = int(r.integers(64)) if r.random() < o.get("coded", 0.7) else 0
        ac_pred = 0
        per_block_abt = 0
        if v == V2:
            if not intra_pic:
                bw.code(T.V2_MB_TYPE[(int(intra) << 2) | (cbp & 3)])
            else:
                bw.code(T.V2_INTRA_CBPC[cbp & 3])
            luma = cbp >> 2
            if not intra:
                bw.code(M4.CBPY[luma ^ 0xF if (cbp & 3) != 3 else luma])
                px, py = self._pred(mx, my, first)
                self.mv[(mx, my)] = (self._v2_component(bw, px), self._v2_component(bw, py))
            else:
                ac_pred = int(r.random() < o.get("ac_pred", 0.4))
                bw.u(ac_pred, 1)
                bw.code(M4.CBPY[luma])
        else:
            if not intra_pic:
                table = self.cbp_index if v == WMV2 else 3
                bw.code(T.MB_NON_INTRA[table][(0 if intra else 0x40) | cbp])
            else:
                code = int(r.integers(64))
                bw.code(T.MB_I[code])
                cbp = 0
                for n in range(6):
                    val = code >> (5 - n) & 1
                    if n < 4:
                        x, y = 2 * mx + (n & 1), 2 * my + (n >> 1)
                        a = self.coded.get((x - 1, y), 0)
                        b = self.coded.get((x - 1, y - 1), 0)
                        c = self.coded.get((x, y - 1), 0)
                        val ^= a if b == c else c
                        self.coded[(x, y)] = val
                    cbp |= val << (5 - n)
            if not intra:
                if v == WMV2:
                    a = self.mv.get((mx - 1, my), (0, 0))
                    b = self.mv.get((mx, my - 1), (0, 0))
                    diff = max(abs(a[0] - b[0]), abs(a[1] - b[1])) if (
                        mx and not first and not self.mspel
                        and self.ext["top_left_mv_flag"]) else 0
                    if diff >= 8:
                        t = int(r.integers(2))
                        bw.u(t, 1)
                        px, py = a if t == 0 else b
                        self.stats[f"top_left_{t}"] += 1
                    else:
                        px, py = a if first else self._pred(mx, my, False)
                    if cbp:
                        if self.per_mb_rl:
                            self.rl = self.rl_chroma = int(r.integers(3))
                            bw.u012(self.rl)
                        if self.ext["abt_flag"] and self.per_mb_abt:
                            per_block_abt = int(r.random() < 0.5)
                            bw.u(per_block_abt, 1)
                            if not per_block_abt:
                                self.abt_type = int(r.integers(3))
                                bw.u012(self.abt_type)
                                self.stats[f"abt_mb_{self.abt_type}"] += 1
                    vx, vy = self._mv(bw, px, py)
                    if ((vx | vy) & 1) and self.mspel:
                        hs = int(r.integers(2))
                        bw.u(hs, 1)
                        self.stats[f"hshift_{hs}"] += 1
                else:
                    if self.per_mb_rl and cbp:
                        self.rl = self.rl_chroma = int(r.integers(3))
                        bw.u012(self.rl)
                    px, py = self._pred(mx, my, first)
                    vx, vy = self._mv(bw, px, py)
                self.mv[(mx, my)] = (vx, vy)
            else:
                ac_pred = int(r.random() < o.get("ac_pred", 0.4))
                bw.u(ac_pred, 1)
                if self.inter_intra:
                    d = int(r.integers(4))
                    bw.code(T.INTER_INTRA[d])
                    self.stats[f"aic_dir_{d}"] += 1
                if self.per_mb_rl and cbp:
                    self.rl = self.rl_chroma = int(r.integers(3))
                    bw.u012(self.rl)
        if intra:
            self.mv[(mx, my)] = (0, 0)
            self.stats["intra_mb_P" if not intra_pic else "intra_mb_I"] += 1
            self.stats[f"ac_pred_{ac_pred}"] += 1
            for n in range(6):
                self._dc(bw, n)
                if cbp >> (5 - n) & 1:
                    rl = RLS[self.rl if n < 4 else 3 + self.rl_chroma]
                    self._block(bw, rl, 64, 0, int(v >= WMV1))
            return
        self.stats["inter_mb"] += 1
        for n in range(6):
            if not cbp >> (5 - n) & 1:
                continue
            rl = RLS[3 + self.rl]
            run_diff = int(v != V2)
            if v == WMV2 and self.ext["abt_flag"]:
                if per_block_abt:
                    self.abt_type = int(r.integers(3))
                    bw.u012(self.abt_type)
                    self.stats[f"abt_block_{self.abt_type}"] += 1
                if self.abt_type:
                    sub = int(r.integers(3))
                    bw.u012(sub)
                    sc = (2, 3, 1)[sub]
                    self.stats[f"abt_{self.abt_type}_sub_{sc}"] += 1
                    for half in (1, 2):
                        if sc & half:
                            self._block(bw, rl, 32, -1, run_diff)
                    continue
            self._block(bw, rl, 64, -1, run_diff)

    def _dc(self, bw: BitWriter, n: int) -> None:
        r = self.rng
        d = int(r.integers(-3, 4)) if r.random() < 0.9 else int(r.integers(-20, 21))
        if self.v == V2:
            bw.code(T.V2_DC[int(n >= 4)][d + 256])
            return
        table = T.DC[self.dc_index][int(n >= 4)]
        if r.random() < 0.05:
            bw.code(table[T.DC_ESCAPE])
            bw.u(abs(d), 8)
            bw.u(int(d < 0), 1)
            self.stats["dc_escape"] += 1
            return
        bw.code(table[abs(d)])
        if d:
            bw.u(int(d < 0), 1)


def _norm(p):
    p = np.asarray(p, float)
    return p / p.sum()


class Stream:
    def __init__(self, packets, extradata, stats, version, width, height):
        self.packets, self.extradata, self.stats = packets, extradata, stats
        self.version, self.width, self.height = version, width, height


def write_stream(seed: int, version: int, plan: str = "IPPP", width: int = 48,
                 height: int = 32, **options) -> Stream:
    """The packets of a random stream of the pictures in `plan`: "I" and "P",
    "S" a WMV2 P picture whose skip map skips every MB by rows (FFmpeg shows
    no frame for it)."""
    from omfs4d_torch.io import msmpeg4

    w = Writer(seed, version, width, height, **options)
    ext = None
    if version == WMV2:
        ext = dict(msmpeg4.wmv2_extradata(w.extradata()), mb_size=(w.mbw, w.mbh))
    packets = []
    for k in plan:
        packets.append(w._skipped_picture() if k == "S" else w.picture(k))
        # the port's own header parser reads the picture back as written
        assert msmpeg4.picture_type(packets[-1], version, ext) == {
            "I": msmpeg4.I, "P": msmpeg4.P, "S": msmpeg4.SKIPPED}[k], (seed, k)
    return Stream(packets, w.extradata(), w.stats, version, width, height)




def write_avi(path, stream: Stream, fps: int = 25) -> Path:
    return _mkv_mux().write_avi(path, stream.packets, [p[0] >> 7 == 0 if stream.version == WMV2
                                                       else p[0] >> 6 == 0
                                                       for p in stream.packets],
                                stream.width, stream.height, FOURCC[stream.version], fps,
                                stream.extradata)


# ── ASF ─────────────────────────────────────────────────────────────────

def _guid(text: str) -> bytes:
    return uuid.UUID(text).bytes_le


def _object(guid: str, body: bytes) -> bytes:
    return _guid(guid) + struct.pack("<Q", 24 + len(body)) + body


def write_asf(path, packets: list[bytes], fourcc: bytes, width: int, height: int,
              extradata: bytes = b"", fps: int = 25, *, layout: str = "single",
              packet_size: int = 512, preroll: int = 3100, keys: list[bool] | None = None,
              padding_type: int = 1, seed: int = 0, broadcast: bool = False,
              leak_rate: int | None = None, payload_extensions: int = 0,
              compress_min: int = 8) -> Path:
    """An ASF file of one video stream (number 1): `layout` "single" (one
    payload a packet, objects split across packets, the rest padded),
    "multiple" (payloads of a word's length each, several a packet) or
    "compressed" (objects of `compress_min` to 255 bytes as sub-payloads of
    compressed payloads, several a packet, the rest as "multiple"; FFmpeg
    drops sub-payloads that end a packet within 6 bytes of its end, as a
    `compress_min` below 5 can make them); every packet
    `packet_size` bytes with error correction data 82 00 00 and its padding
    length as a byte (`padding_type` 1) or a word (2)."""
    rng = np.random.default_rng(seed)
    n = len(packets)
    keys = keys if keys is not None else [True] * n
    frame_ms = 1000 // fps
    times = [preroll + k * frame_ms for k in range(n)]
    prop = 0x5D                      # replicated: byte; offset: dword; object: byte; stream: byte
    out = []

    def packet(payloads: bytes, count: int, multiple: bool, send: int) -> bytes:
        pad_field = 1 if padding_type == 1 else 2
        pad = packet_size - (5 + pad_field + 6 + (1 if multiple else 0) + len(payloads))
        if pad > 255 and pad_field == 1:          # a byte cannot hold it: a word
            pad_field, pad = 2, pad - 1
        assert pad >= 0
        flags = (1 if multiple else 0) | pad_field << 3
        head = b"\x82\x00\x00" + bytes([flags, prop])
        body = head + pad.to_bytes(pad_field, "little") + struct.pack("<IH", send, 0)
        if multiple:
            body += bytes([0x80 | count])
        return body + payloads + bytes(pad)

    def payload(obj: int, offset: int, data: bytes, k: int, multiple: bool) -> bytes:
        head = bytes([0x81 if keys[k] else 0x01, obj & 0xFF]) + struct.pack("<I", offset) \
            + bytes([8 + 2 * payload_extensions]) \
            + struct.pack("<II", len(packets[k]), times[k]) + bytes(2 * payload_extensions)
        return head + (struct.pack("<H", len(data)) if multiple else b"") + data

    fixed = 3 + 2 + 6              # ecc, flags, send time and duration
    if layout == "single":
        room = packet_size - fixed - (1 if padding_type == 1 else 2) - 15 - 2 * payload_extensions
        for k, data in enumerate(packets):
            for off in range(0, len(data), room):
                out.append(packet(payload(k, off, data[off:off + room], k, False), 1, False,
                                  times[k]))
    else:
        room_total = packet_size - fixed - (1 if padding_type == 1 else 2) - 1
        cur, count, send = b"", 0, times[0]
        k = 0
        pending = [(k, 0) for k in range(n)]
        queue = list(range(n))
        while queue:
            k = queue[0]
            data = packets[k]
            if layout == "compressed" and compress_min <= len(data) <= 255:
                # as many whole small objects as fit, as sub-payloads
                group = [k]
                for j in queue[1:1 + int(rng.integers(0, 4))]:
                    if compress_min <= len(packets[j]) <= 255 and j == group[-1] + 1:
                        group.append(j)
                    else:
                        break
                sub = b"".join(bytes([len(packets[j])]) + packets[j] for j in group)
                item = bytes([0x81 if keys[k] else 0x01, k & 0xFF]) \
                    + struct.pack("<I", times[k]) + bytes([1, frame_ms]) \
                    + struct.pack("<H", len(sub)) + sub
                if len(item) + len(cur) > room_total or count == 63:
                    if cur:
                        out.append(packet(cur, count, True, send))
                        cur, count = b"", 0
                    if len(item) > room_total:
                        group = [k]
                        sub = bytes([len(data)]) + data
                        item = bytes([0x81 if keys[k] else 0x01, k & 0xFF]) \
                            + struct.pack("<I", times[k]) + bytes([1, frame_ms]) \
                            + struct.pack("<H", len(sub)) + sub
                if not cur:
                    send = times[k]
                cur += item
                count += 1
                del queue[:len(group)]
                continue
            off = pending[k][1]
            left = room_total - len(cur) - 17 - 2 * payload_extensions
            if left < 8 or count == 63:
                out.append(packet(cur, count, True, send))
                cur, count = b"", 0
                continue
            if not cur:
                send = times[k]
            piece = data[off:off + left]
            cur += payload(k, off, piece, k, True)
            count += 1
            if off + len(piece) >= len(data):
                queue.pop(0)
            else:
                pending[k] = (k, off + len(piece))
        if cur:
            out.append(packet(cur, count, True, send))
    data_obj = _guid("75b22636-668e-11cf-a6d9-00aa0062ce6c") + struct.pack(
        "<Q", 50 + packet_size * len(out)) + bytes(16) + struct.pack("<QH", len(out), 0x0101) \
        + b"".join(out)
    bih = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), width, height, 1, 24, fourcc,
                      width * height * 3, 0, 0, 0, 0) + extradata
    specific = struct.pack("<IIBH", width, height, 2, len(bih)) + bih
    stream = _object("b7dc0791-a9b7-11cf-8ee6-00c00c205365",
                     _guid("bc19efc0-5b4d-11cf-a8fd-00805f5c442b")
                     + _guid("20fb5700-5b55-11cf-a8fd-00805f5c442b")
                     + struct.pack("<QIIHI", 0, len(specific), 0, 1, 0) + specific)
    inner = b""
    if leak_rate is not None:
        systems = b"".join(_guid("399595ec-8667-4e2d-8fdb-98814ce76c1e") + struct.pack(
            "<HI", 2, 0) for _ in range(payload_extensions))
        inner = _object("14e6a5cb-c672-4332-8399-a96952065b5a", struct.pack(
            "<QQIIIIIIIIHHQHH", 0, 0, leak_rate, 0, 0, 0, 0, 0, 0, 0, 1, 0, frame_ms * 10000, 0,
            payload_extensions) + systems)
    extension = _object("5fbf03b5-a92e-11cf-8ee3-00c00c205365",
                        _guid("abd3d211-a9ba-11cf-8ee6-00c00c205365")
                        + struct.pack("<HI", 6, len(inner)) + inner)

    def header(file_size: int) -> bytes:
        play = (n * frame_ms + preroll) * 10000
        props = _object("8cabdca1-a947-11cf-8ee4-00c00c205365",
                        bytes(16) + struct.pack("<QQQQQQIIII", file_size, 0, len(out), play,
                                                n * frame_ms * 10000, preroll,
                                                3 if broadcast else 2, packet_size,
                                                packet_size, 1 << 20))
        body = props + extension + stream
        return _guid("75b22630-668e-11cf-a6d9-00aa0062ce6c") + struct.pack(
            "<QIBB", 30 + len(body), 3, 1, 2) + body

    size = len(header(0)) + len(data_obj)
    Path(path).write_bytes(header(size) + data_obj)
    return Path(path)


def make_file(path, seed: int, version: int, plan: str, options: dict, mux: dict) -> Path:
    """A writer stream muxed by `mux`: {"container": "avi"} or {"container":
    "asf", ...write_asf's keywords}; `options` as write_stream takes them
    (width and height among them)."""
    s = write_stream(seed, version, plan, **options)
    mux = dict(mux)
    if mux.pop("container") == "avi":
        return write_avi(path, s, **mux)
    return write_asf(path, s.packets, FOURCC[version], s.width, s.height, s.extradata,
                     seed=seed, **mux)
