"""A random legal-syntax VP8 (RFC 6386) writer with its own boolean encoder,
for holding the port's decoder (`omfs4d_torch/io/vp8dec.cpp`) to cv2's
FFmpeg on what cv2's libvpx does not write.

`write_stream(seed, **features)` gives a `Writer` and its frames in decoding
order.  It writes syntax, not pictures: every syntax element is drawn at
random within what the RFC allows, and the writer keeps the decoder's state
(the probabilities with their updates, saves and restores, the key frames'
sub-block mode contexts, the token contexts, the macroblocks' vectors and
modes for `find_near_mvs` and the split contexts, the segment map) so that
it codes each element with the probability the decoder reads it with.  It
draws what libvpx at cv2's settings never writes:

- versions 1-3 (bilinear filters, whole-pixel chroma) and the simple loop
  filter, every filter level and sharpness;
- segmentation, its map kept from frame to frame, absolute or delta
  features, and loop filter deltas by reference and mode;
- 2, 4 and 8 token partitions;
- golden and altref refreshes, copies from last / golden / altref and sign
  bias (never golden and altref copied into each other in one frame,
  where decoders differ);
- `refresh_entropy_probs` 0, and updates of every probability: tokens,
  skip, intra, last, golden, the 16x16 and chroma modes, the vectors;
- `mb_no_coeff_skip` 0, skipped macroblocks, blocks that end at position 16
  on a zero;
- SPLITMV in every partitioning, sub-block vectors from the left, above,
  zero or new, vectors far past the picture's edges;
- every B_PRED mode in key and inter frames;
- quantiser indices 0 and 127 with extreme deltas (the dequantised
  coefficients kept within what the 16-bit transforms carry, a block's
  absolute sum at most `BLOCK_BUDGET`);
- frames with show_frame 0, the key frame's color_space bit (and its
  clamping_type bit where `clamping`: the port refuses it), odd sizes.

`write_webm` / `write_avi` mux a stream as cv2's and a browser's files hold
it (`tests/torch_mkv_mux.py`); `make_file` writes a stream and muxes it by
its suffix, from the arguments `tests/data/vp8/manifest.json` keeps.  The tables are the decoder's,
`omfs4d_torch.io.vp8_tables`.
"""

from __future__ import annotations

import functools
import importlib.util
import struct
from collections import Counter
from pathlib import Path

import numpy as np

from omfs4d_torch.io import vp8_tables as T

# a block's dequantised coefficients add up to at most this, so that the
# inverse WHT and DCT never leave 16 bits (FFmpeg's SIMD would saturate
# where its C wraps)
BLOCK_BUDGET = 3000
INTRA, LAST, GOLDEN, ALTREF = range(4)


class BoolEncoder:
    """RFC 6386's boolean encoder (7.3), ended as libvpx ends a partition:
    32 bits of padding at probability 1/2, then the flush."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                k = len(self.out) - 1
                while self.out[k] == 255:
                    self.out[k] = 0
                    k -= 1
                self.out[k] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def bit(self, b: int) -> None:
        self.put(int(b), 128)

    def literal(self, n: int, v: int) -> None:
        for k in range(n - 1, -1, -1):
            self.bit(v >> k & 1)

    def signed(self, n: int, v: int) -> None:
        """A flag, the magnitude, the sign (FFmpeg's vp8_rac_get_sint)."""
        self.bit(v != 0)
        if v:
            self.literal(n, abs(v))
            self.bit(v < 0)

    def tree(self, tree: tuple, probs, leaf: int) -> None:
        for node, bit in _paths(tree)[leaf]:
            self.put(bit, probs[node >> 1])

    def finish(self) -> bytes:
        for _ in range(32):
            self.put(0, 128)
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            k = len(self.out) - 1
            while self.out[k] == 255:
                self.out[k] = 0
                k -= 1
            self.out[k] += 1
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


_PATHS: dict[tuple, dict[int, list[tuple[int, int]]]] = {}


def _paths(tree: tuple) -> dict[int, list[tuple[int, int]]]:
    """Each leaf's (node, bit) path through an RFC tree."""
    if tree not in _PATHS:
        out: dict[int, list[tuple[int, int]]] = {}

        def walk(node, path):
            for bit in (0, 1):
                nxt = tree[node + bit]
                if nxt > 0:
                    walk(nxt, path + [(node, bit)])
                else:
                    out[-nxt] = path + [(node, bit)]

        walk(0, [])
        _PATHS[tree] = out
    return _PATHS[tree]


class MB:
    __slots__ = ("ymode", "ref", "part", "mv", "bmv")

    def __init__(self):
        self.ymode, self.ref, self.part = T.DC_PRED, INTRA, None
        self.mv = (0, 0)                             # (y, x), quarter pixels
        self.bmv = [(0, 0)] * 16                     # by partition


def _clamp(v: int, lo: int, hi: int) -> int:
    return min(max(v, lo), hi)


def _wrap(v: int) -> int:
    """A vector component as the decoder keeps it, in 16 bits."""
    return (v + 32768) % 65536 - 32768


class Writer:
    """The state a decoder keeps, and the draws of one stream."""

    def __init__(self, seed: int, width: int = 48, height: int = 32, version: int = 0,
                 segmentation: bool = True, lf_deltas: bool = True, partitions=(0, 1, 2, 3),
                 references: bool = True, refresh_probs: bool = True, updates: bool = True,
                 skip: bool = True, split: bool = True, bpred: bool = True, far: bool = True,
                 q_range=(0, 127), q_deltas: int = 15, simple=None, filter_range=(0, 63),
                 colour_space: bool = True, clamping: bool = False, density: float = 0.5):
        self.rng = np.random.default_rng(seed)
        self.width, self.height, self.version = width, height, version
        self.mbw, self.mbh = (width + 15) // 16, (height + 15) // 16
        self.opt = dict(segmentation=segmentation, lf_deltas=lf_deltas, partitions=partitions,
                        references=references, refresh_probs=refresh_probs, updates=updates,
                        skip=skip, split=split, bpred=bpred, far=far, q_range=q_range,
                        q_deltas=q_deltas, simple=simple, filter_range=filter_range,
                        colour_space=colour_space, clamping=clamping, density=density)
        self.stats: Counter = Counter()
        self.sign_bias = [0, 0, 0, 0]
        self.seg_abs, self.seg_quant, self.seg_lf = 0, [0] * 4, [0] * 4
        self.seg_probs = [255, 255, 255]
        self.prev_map: list[int] | None = None
        self.started = False

    # ── helpers ──
    def chance(self, p: float) -> bool:
        return bool(self.rng.random() < p)

    def pick(self, options):
        return options[int(self.rng.integers(len(options)))]

    def _reset_probs(self) -> None:
        self.coef = [[[list(c) for c in band] for band in t] for t in T.COEF_PROBS]
        self.ymode_p, self.uv_p = list(T.YMODE_PROBS), list(T.UV_MODE_PROBS)
        self.mv_p = [list(p) for p in T.MV_DEFAULT_PROBS]

    def _probs(self):
        return ([[[list(c) for c in band] for band in t] for t in self.coef],
                list(self.ymode_p), list(self.uv_p), [list(p) for p in self.mv_p])

    # ── a frame ──
    def frame(self, key: bool, show: bool = True) -> bytes:
        o, rng = self.opt, self.rng
        if not self.started and not key:
            raise ValueError("the writer starts at a key frame")
        self.started = True
        self.key = key
        h = BoolEncoder()
        if key:
            self._reset_probs()
            self.seg_abs, self.seg_quant, self.seg_lf = 0, [0] * 4, [0] * 4
            self.lf_ref, self.lf_mode = [0] * 4, [0] * 4
            self.colour = (int(o["colour_space"] and self.chance(0.2)),
                           int(o["clamping"] and self.chance(0.5)))
            h.bit(self.colour[0])
            h.bit(self.colour[1])
            self.stats["colour_space"] += self.colour[0]
            self.stats["clamping_type"] += self.colour[1]
        # segmentation
        seg = o["segmentation"] and self.chance(0.6)
        self.seg_enabled, self.update_map = seg, False
        h.bit(seg)
        if seg:
            self.update_map = self.prev_map is None or self.chance(0.6)
            update_data = self.chance(0.7)
            h.bit(self.update_map)
            h.bit(update_data)
            if update_data:
                self.seg_abs = int(self.chance(0.4))
                h.bit(self.seg_abs)
                for i in range(4):
                    lo = 0 if self.seg_abs else -127
                    self.seg_quant[i] = int(rng.integers(lo, 128)) if self.chance(0.8) else 0
                    h.signed(7, self.seg_quant[i])
                for i in range(4):
                    lo = 0 if self.seg_abs else -63
                    self.seg_lf[i] = int(rng.integers(lo, 64)) if self.chance(0.8) else 0
                    h.signed(6, self.seg_lf[i])
            if self.update_map:
                for i in range(3):
                    upd = self.chance(0.7)
                    h.bit(upd)
                    self.seg_probs[i] = int(rng.integers(0, 256)) if upd else 255
                    if upd:
                        h.literal(8, self.seg_probs[i])
            self.stats["segmented"] += 1
        # the loop filter
        simple = self.chance(0.5) if o["simple"] is None else o["simple"]
        self.simple = simple
        self.level = int(rng.integers(o["filter_range"][0], o["filter_range"][1] + 1))
        self.sharpness = int(rng.integers(0, 8))
        h.bit(simple)
        h.literal(6, self.level)
        h.literal(3, self.sharpness)
        deltas = o["lf_deltas"] and self.chance(0.6)
        h.bit(deltas)
        if deltas:
            update = self.chance(0.7)
            h.bit(update)
            if update:
                for arr in (self.lf_ref, self.lf_mode):
                    for i in range(4):
                        upd = self.chance(0.6)
                        h.bit(upd)
                        if upd:
                            arr[i] = int(rng.integers(-63, 64))
                            h.literal(6, abs(arr[i]))
                            h.bit(arr[i] < 0)
        self.log2_parts = int(self.pick(o["partitions"]))
        h.literal(2, self.log2_parts)
        self.stats[f"partitions_{1 << self.log2_parts}"] += 1
        # quantisers
        lo, hi = o["q_range"]
        self.qindex = int(rng.integers(lo, hi + 1))
        h.literal(7, self.qindex)
        self.q_delta = [int(rng.integers(-o["q_deltas"], o["q_deltas"] + 1))
                        if self.chance(0.4) else 0 for _ in range(5)]
        for d in self.q_delta:
            h.signed(4, d)
        if not key:
            rg, ra = (self.chance(0.3), self.chance(0.3)) if o["references"] else (False, False)
            h.bit(rg)
            h.bit(ra)
            cg = ca = 0
            if not rg:
                cg = int(rng.integers(0, 3)) if o["references"] else 0
                h.literal(2, cg)
            if not ra:
                ca = int(rng.integers(0, 3)) if o["references"] else 0
                if cg == 2 and ca == 2:                      # no swap in one frame
                    ca = 1
                h.literal(2, ca)
            self.stats["golden_refresh"] += rg
            self.stats["altref_refresh"] += ra
            self.stats["copies"] += (cg > 0) + (ca > 0)
            for r in (GOLDEN, ALTREF):
                self.sign_bias[r] = int(self.chance(0.3)) if o["references"] else 0
                h.bit(self.sign_bias[r])
        refresh = not (o["refresh_probs"] and self.chance(0.3))
        h.bit(refresh)
        saved = None if refresh else self._probs()
        self.stats["no_refresh_entropy"] += not refresh
        if not key:
            h.bit(self.chance(0.85) if o["references"] else 1)       # refresh_last
        # token probabilities
        rate = 0.02 if o["updates"] else 0.0
        for i in range(4):
            for j in range(8):
                for k in range(3):
                    for n in range(11):
                        upd = self.chance(rate)
                        h.put(upd, T.COEF_UPDATE_PROBS[i][j][k][n])
                        if upd:
                            self.coef[i][j][k][n] = int(rng.integers(1, 256))
                            h.literal(8, self.coef[i][j][k][n])
                            self.stats["coef_updates"] += 1
        self.skip_enabled = not (o["skip"] and self.chance(0.25))
        h.bit(self.skip_enabled)
        if self.skip_enabled:
            self.prob_skip = int(rng.integers(0, 256))
            h.literal(8, self.prob_skip)
        else:
            self.stats["no_skip_flag"] += 1
        if not key:
            self.prob_intra = int(rng.integers(0, 256))
            self.prob_last = int(rng.integers(0, 256))
            self.prob_golden = int(rng.integers(0, 256))
            for p in (self.prob_intra, self.prob_last, self.prob_golden):
                h.literal(8, p)
            for arr, n in ((self.ymode_p, 4), (self.uv_p, 3)):
                upd = o["updates"] and self.chance(0.3)
                h.bit(upd)
                if upd:
                    for i in range(n):
                        arr[i] = int(rng.integers(0, 256))
                        h.literal(8, arr[i])
            for i in range(2):
                for j in range(19):
                    upd = o["updates"] and self.chance(0.1)
                    h.put(upd, T.MV_UPDATE_PROBS[i][j])
                    if upd:
                        v = int(rng.integers(0, 128))
                        h.literal(7, v)
                        self.mv_p[i][j] = (v << 1) or 1
        parts = [BoolEncoder() for _ in range(1 << self.log2_parts)]
        self._macroblocks(h, parts)
        first = h.finish()
        if saved is not None:
            self.coef, self.ymode_p, self.uv_p, self.mv_p = saved
        tag = (0 if key else 1) | self.version << 1 | int(show) << 4 | len(first) << 5
        out = bytearray(struct.pack("<I", tag)[:3])
        if key:
            out += b"\x9d\x01\x2a" + struct.pack("<HH", self.width, self.height)
        out += first
        blobs = [p.finish() for p in parts]
        for b in blobs[:-1]:
            out += struct.pack("<I", len(b))[:3]
        for b in blobs:
            out += b
        self.stats["frames"] += 1
        self.stats["hidden"] += not show
        return bytes(out)

    # ── macroblocks ──
    def _qmul(self, segment: int) -> tuple:
        base = self.qindex
        if self.seg_enabled:
            base = self.seg_quant[segment] if self.seg_abs else self.seg_quant[segment] + base
        d = self.q_delta

        def at(q):
            return _clamp(q, 0, 127)
        y = (T.DC_QLOOKUP[at(base + d[0])], T.AC_QLOOKUP[at(base)])
        y2 = (T.DC_QLOOKUP[at(base + d[1])] * 2,
              max(T.AC_QLOOKUP[at(base + d[2])] * 101581 >> 16, 8))
        uv = (min(T.DC_QLOOKUP[at(base + d[3])], 132), T.AC_QLOOKUP[at(base + d[4])])
        return y, y2, uv

    def _macroblocks(self, h: BoolEncoder, parts: list[BoolEncoder]) -> None:
        rng, o = self.rng, self.opt
        mbw, mbh = self.mbw, self.mbh
        grid = [[MB() for _ in range(mbw + 1)] for _ in range(mbh + 1)]  # a border row, column
        seg_map = [0] * (mbw * mbh)
        top_nnz = [[0] * 9 for _ in range(mbw)]
        top_b = [[T.B_DC_PRED] * 4 for _ in range(mbw)]
        qs = [self._qmul(s) for s in range(4)]
        for y in range(mbh):
            left_nnz = [0] * 9
            left_b = [T.B_DC_PRED] * 4
            tok = parts[y & ((1 << self.log2_parts) - 1)]
            for x in range(mbw):
                m = grid[y + 1][x + 1]
                at = y * mbw + x
                if self.update_map:
                    seg_map[at] = int(rng.integers(0, 4))
                    b = seg_map[at] >> 1
                    h.put(b, self.seg_probs[0])
                    h.put(seg_map[at] & 1, self.seg_probs[1 + b])
                elif self.seg_enabled and self.prev_map is not None:
                    seg_map[at] = self.prev_map[at]
                skip = 0
                if self.skip_enabled:
                    skip = int(self.chance(0.3))
                    h.put(skip, self.prob_skip)
                if self.key:
                    self._key_modes(h, m, top_b[x], left_b)
                else:
                    self._inter_frame_modes(h, m, grid, x, y)
                self.stats[f"mode_{m.ymode}"] += 1
                t, left = top_nnz[x], left_nnz
                if not skip:
                    self._tokens(tok, m, t, left, qs[seg_map[at]])
                else:
                    for i in range(8):
                        t[i] = left[i] = 0
                    if m.ymode not in (T.B_PRED, T.SPLITMV):
                        t[8] = left[8] = 0
                    self.stats["skipped"] += 1
        self.prev_map = seg_map

    def _key_modes(self, h, m: MB, top: list, left: list) -> None:
        ymodes = [T.DC_PRED, T.V_PRED, T.H_PRED, T.TM_PRED] + [T.B_PRED] * 2 * self.opt["bpred"]
        m.ymode = self.pick(ymodes)
        h.tree(T.KF_YMODE_TREE, T.KF_YMODE_PROBS, m.ymode)
        if m.ymode == T.B_PRED:
            for by in range(4):
                for bx in range(4):
                    b = int(self.rng.integers(0, 10))
                    h.tree(T.BMODE_TREE, T.KF_BMODE_PROBS[top[bx]][left[by]], b)
                    top[bx] = left[by] = b
                    self.stats[f"bmode_{b}"] += 1
        else:
            top[:] = left[:] = [T.B_MODE_OF[m.ymode]] * 4
        h.tree(T.UV_MODE_TREE, T.KF_UV_MODE_PROBS, int(self.rng.integers(0, 4)))
        m.ref, m.part, m.mv, m.bmv = INTRA, None, (0, 0), [(0, 0)] * 16

    def _mv_component(self, h, v: int, p) -> None:
        a = abs(v)
        if a < 8:
            h.put(0, p[T.MVP_IS_SHORT])
            h.tree(T.SMALL_MV_TREE, p[T.MVP_SHORT:T.MVP_SHORT + 7], a)
        else:
            h.put(1, p[T.MVP_IS_SHORT])
            for i in range(3):
                h.put(a >> i & 1, p[T.MVP_BITS + i])
            for i in range(T.MV_LONG_BITS - 1, 3, -1):
                h.put(a >> i & 1, p[T.MVP_BITS + i])
            if a & 0xFFF0:
                h.put(a >> 3 & 1, p[T.MVP_BITS + 3])
        if a:
            h.put(int(v < 0), p[T.MVP_SIGN])

    def _delta(self, best, y: int) -> tuple[int, int]:
        """A new vector's difference from `best` (row, column): short, long,
        or (`far`) up to the long form's reach; never more than 16 pixels
        above the picture (FFmpeg's frame threads wait for no row of the
        reference there, and race)."""
        out = []
        for _ in range(2):
            r = self.rng.random()
            if r < 0.5:
                v = int(self.rng.integers(-7, 8))
            elif r < 0.85 or not self.opt["far"]:
                v = int(self.rng.integers(-64, 65))
            else:
                v = int(self.rng.integers(-1023, 1024))
            out.append(v)
        return max(out[0], -(16 * y + 16) * 4 - best[0]), out[1]

    def _write_delta(self, h, d: tuple[int, int]) -> None:
        self._mv_component(h, d[0], self.mv_p[0])
        self._mv_component(h, d[1], self.mv_p[1])
        self.stats["new_mv"] += 1
        self.stats["far_mv"] += max(abs(d[0]), abs(d[1])) > 256

    def _inter_frame_modes(self, h, m: MB, grid, x: int, y: int) -> None:
        rng = self.rng
        inter = self.chance(0.7)
        h.put(int(inter), self.prob_intra)
        if not inter:
            m.ymode = self.pick([T.DC_PRED, T.V_PRED, T.H_PRED, T.TM_PRED]
                                + [T.B_PRED] * self.opt["bpred"])
            h.tree(T.YMODE_TREE, self.ymode_p, m.ymode)
            if m.ymode == T.B_PRED:
                for _ in range(16):
                    b = int(rng.integers(0, 10))
                    h.tree(T.BMODE_TREE, T.BMODE_PROBS, b)
                    self.stats[f"bmode_{b}"] += 1
            h.tree(T.UV_MODE_TREE, self.uv_p, int(rng.integers(0, 4)))
            m.ref, m.part, m.bmv = INTRA, None, [(0, 0)] * 16
            return
        m.ref = self.pick([LAST, LAST, GOLDEN, ALTREF])
        h.put(int(m.ref != LAST), self.prob_last)
        if m.ref != LAST:
            h.put(int(m.ref == ALTREF), self.prob_golden)
        self.stats[f"ref_{m.ref}"] += 1
        # find_near_mvs
        edges = (grid[y][x + 1], grid[y + 1][x], grid[y][x])          # above, left, above-left
        near = [(0, 0)] * 4
        cnt = [0, 0, 0, 0]
        idx = 0
        for n, e in enumerate(edges):
            if e.ref == INTRA:
                continue
            mv = e.mv
            if mv != (0, 0):
                if self.sign_bias[m.ref] != self.sign_bias[e.ref]:
                    mv = (-mv[0], -mv[1])
                if not n or mv != near[idx]:
                    idx += 1
                    near[idx] = mv
                cnt[idx] += 1 + (n != 2)
            else:
                cnt[0] += 1 + (n != 2)
        lo_x, hi_x = -(x * 64) - 64, (self.mbw - 1 - x) * 64 + 64
        lo_y, hi_y = -(y * 64) - 64, (self.mbh - 1 - y) * 64 + 64

        def clamp(v):
            return (_clamp(v[0], lo_y, hi_y), _clamp(v[1], lo_x, hi_x))

        zero_cnt = cnt[0]
        if cnt[3] and near[1] == near[3]:
            cnt[1] += 1
        if cnt[2] > cnt[1]:
            cnt[1], cnt[2] = cnt[2], cnt[1]
            near[1], near[2] = near[2], near[1]
        best = clamp(near[1] if cnt[1] >= cnt[0] else near[0])
        modes = [T.ZEROMV, T.NEARESTMV, T.NEARMV, T.NEWMV] + [T.SPLITMV] * self.opt["split"]
        mode = self.pick(modes)
        plan, delta = None, None
        if mode == T.SPLITMV:
            plan = self._plan_split(grid, x, y, best)
            mode = mode if plan else T.ZEROMV
        elif mode == T.NEWMV:
            delta = self._delta(best, y)
        m.ymode, m.part = mode, None
        h.put(int(mode != T.ZEROMV), T.MODE_CONTEXTS[zero_cnt][0])
        if mode == T.ZEROMV:
            m.mv = (0, 0)
            m.bmv = [(0, 0)] * 16
            return
        h.put(int(mode != T.NEARESTMV), T.MODE_CONTEXTS[cnt[1]][1])
        if mode == T.NEARESTMV:
            m.mv = clamp(near[1])
        else:
            h.put(int(mode != T.NEARMV), T.MODE_CONTEXTS[cnt[2]][2])
            if mode == T.NEARMV:
                m.mv = clamp(near[2])
            else:
                splits = ((edges[1].ymode == T.SPLITMV) + (edges[0].ymode == T.SPLITMV)) * 2 \
                    + (edges[2].ymode == T.SPLITMV)
                h.put(int(mode == T.SPLITMV), T.MODE_CONTEXTS[splits][3])
                if mode == T.SPLITMV:
                    part, refs, bmv = plan
                    h.tree(T.MBSPLIT_TREE, T.MBSPLIT_PROBS, part)
                    self.stats[f"split_{part}"] += 1
                    for ref, context, d in refs:
                        h.tree(T.SUBMV_REF_TREE, T.SUBMV_REF_PROBS[context], ref)
                        if d is not None:
                            self._write_delta(h, d)
                    m.part, m.bmv = part, bmv
                    m.mv = bmv[T.MBSPLIT_COUNT[part] - 1]
                    return
                self._write_delta(h, delta)
                m.mv = _wrap(best[0] + delta[0]), _wrap(best[1] + delta[1])
        m.bmv = [m.mv] * 16

    def _plan_split(self, grid, x: int, y: int, best):
        """A split's partitioning, each partition's (reference, context,
        delta or None) and the vectors by partition; None where a block would
        lie wholly above the picture (where FFmpeg's frame threads race)."""
        rng = self.rng
        left, top = grid[y + 1][x], grid[y][x + 1]
        part = int(rng.integers(0, 4))
        splits = T.MBSPLITS[part]
        bmv, refs = [(0, 0)] * 16, []

        def sub(mb: MB, k: int):
            return mb.bmv[0 if mb.part is None else T.MBSPLITS[mb.part][k]]

        for n in range(T.MBSPLIT_COUNT[part]):
            k = splits.index(n)
            lv = sub(left, k + 3) if not k & 3 else bmv[splits[k - 1]]
            av = sub(top, k + 12) if k <= 3 else bmv[splits[k - 4]]
            if lv == av:
                context = 4 if lv == (0, 0) else 3
            elif av == (0, 0):
                context = 2
            else:
                context = 1 if lv == (0, 0) else 0
            ref, d = int(rng.integers(0, 4)), None
            if ref == T.LEFT4X4:
                v = lv
            elif ref == T.ABOVE4X4:
                v = av
            elif ref == T.ZERO4X4:
                v = (0, 0)
            else:
                d = self._delta(best, y)
                v = (_wrap(best[0] + d[0]), _wrap(best[1] + d[1]))
            bmv[n] = v
            refs.append((ref, context, d))
        # every luma and chroma block reaches the picture's rows
        per_block = [bmv[splits[k]] for k in range(16)]
        for k, v in enumerate(per_block):
            if 16 * y + 4 * (k >> 2) + (v[0] >> 2) + 4 < 0:
                return None
        for cy in range(2):
            for cx in range(2):
                s = sum(per_block[8 * cy + 2 * cx + j][0] for j in (0, 1, 4, 5))
                if 8 * y + 4 * cy + (((s + 2 - (s < 0)) >> 2) >> 3) + 4 < 0:
                    return None
        return part, refs, bmv

    # ── tokens ──
    def _tokens(self, tok: BoolEncoder, m: MB, t: list, left: list, q) -> None:
        qy, qy2, quv = q
        first, ytype = 0, T.BLOCK_Y
        if m.ymode not in (T.B_PRED, T.SPLITMV):
            n = self._block(tok, T.BLOCK_Y2, 0, t[8] + left[8], qy2)
            t[8] = left[8] = int(n > 0)
            first, ytype = 1, T.BLOCK_Y_AFTER_Y2
        for by in range(4):
            for bx in range(4):
                n = self._block(tok, ytype, first, left[by] + t[bx], qy)
                t[bx] = left[by] = int(n > 0)
        for plane in range(2):
            for by in range(2):
                for bx in range(2):
                    ti, li = 4 + 2 * plane + bx, 4 + 2 * plane + by
                    n = self._block(tok, T.BLOCK_UV, 0, left[li] + t[ti], quv)
                    t[ti] = left[li] = int(n > 0)

    def _block(self, e: BoolEncoder, kind: int, first: int, ctx: int, q) -> int:
        """One block's tokens, drawn and written: the decoder's count (the
        position after the last token)."""
        rng, probs = self.rng, self.coef[kind]
        p = probs[T.COEF_BANDS[first]][ctx]
        if not self.chance(self.opt["density"]):
            e.put(0, p[0])                                 # EOB at once
            return 0
        # the values: the last one not zero, unless the block runs to its end
        to_end = self.chance(0.05)
        end = 16 if to_end else int(rng.integers(first, 16)) + 1
        values, budget = [], BLOCK_BUDGET
        for i in range(first, end):
            step = q[1 if i else 0]
            most = min(budget // step, 2114)
            last = i == end - 1 and not to_end
            v = 0
            if (last or self.chance(0.5)) and most >= 1:
                r = rng.random()
                v = int(rng.integers(1, min(most, 4 if r < 0.6 else 66 if r < 0.9 else most)
                                     + 1))
            v = v or int(last)                             # past the budget: a 1
            budget -= v * step
            values.append(-v if v and self.chance(0.5) else v)
        e.put(1, p[0])
        i = first
        while True:
            v = values[i - first]
            if not v:
                e.put(0, p[1])                             # DCT_0
                i += 1
                if i == 16:
                    self.stats["to_end"] += 1
                    return 16
                p = probs[T.COEF_BANDS[i]][0]
                continue
            e.put(1, p[1])
            self._magnitude(e, p, abs(v))
            e.bit(v < 0)
            i += 1
            if i == 16:
                return 16
            p = probs[T.COEF_BANDS[i]][1 if abs(v) == 1 else 2]
            if i == end:
                e.put(0, p[0])                             # EOB
                return i
            e.put(1, p[0])

    def _magnitude(self, e: BoolEncoder, p, v: int) -> None:
        if v == 1:
            e.put(0, p[2])
            return
        e.put(1, p[2])
        if v <= 4:
            e.put(0, p[3])
            if v == 2:
                e.put(0, p[4])
            else:
                e.put(1, p[4])
                e.put(v - 3, p[5])
            return
        e.put(1, p[3])
        cat = max(c for c in range(6) if T.CAT_BASE[c] <= v)
        extra = v - T.CAT_BASE[cat]
        if cat < 2:
            e.put(0, p[6])
            e.put(cat, p[7])
        else:
            e.put(1, p[6])
            a, b = (cat - 2) >> 1, (cat - 2) & 1
            e.put(a, p[8])
            e.put(b, p[9 + a])
        bits = T.CAT_PROBS[cat]
        for k, prob in enumerate(bits):
            e.put(extra >> (len(bits) - 1 - k) & 1, prob)
        self.stats[f"cat_{cat + 1}"] += 1


def write_stream(seed: int, frames: int = 6, key_frames=(0,), hidden=(),
                 **features) -> tuple[Writer, list[bytes]]:
    """A stream of `frames` frames in decoding order: key frames at
    `key_frames`, show_frame 0 at `hidden`."""
    w = Writer(seed, **features)
    return w, [w.frame(i in key_frames, i not in hidden) for i in range(frames)]


@functools.cache
def _mkv_mux():
    """tests/torch_mkv_mux.py, loaded by its path: a package named `tests`
    installed elsewhere would win an import by name."""
    spec = importlib.util.spec_from_file_location(
        "torch_mkv_mux", Path(__file__).resolve().with_name("torch_mkv_mux.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def is_key(frame: bytes) -> bool:
    return bool(frame) and not frame[0] & 1


def write_webm(path, frames: list[bytes], width: int, height: int, fps: float = 30.0,
               doc_type: str = "webm", times_ms: list[int] | None = None, **options):
    """A WebM (or, with doc_type "matroska", an MKV) of one VP8 track, as
    FFmpeg's muxer writes it by default (`DefaultDuration` and `Duration`
    from fps; `times_ms` and options as `torch_mkv_mux.write_mkv` takes
    them)."""
    n = len(frames)
    times = times_ms if times_ms is not None else [round(i * 1000 / fps) for i in range(n)]
    options.setdefault("default_duration", round(1e9 / fps))
    options.setdefault("duration_ms", n * 1000 / fps)
    return _mkv_mux().write_mkv(path, frames, [is_key(f) for f in frames], times,
                                codec_id="V_VP8", width=width, height=height,
                                doc_type=doc_type, **options)


def write_avi(path, frames: list[bytes], width: int, height: int, fps: int = 30):
    """An AVI of one `VP80` stream, as FFmpeg's AVI muxer lays it out."""
    return _mkv_mux().write_avi(path, frames, [is_key(f) for f in frames], width, height,
                                b"VP80", fps)


def make_file(path, seed: int, frames: int, key_frames, hidden, features: dict,
              mux: dict) -> Path:
    """`write_stream(seed, ...)` muxed by the suffix of `path`: AVI, Matroska
    (.mkv) or WebM (`mux`, `write_webm`'s options)."""
    writer, stream = write_stream(seed, frames=frames, key_frames=tuple(key_frames),
                                  hidden=tuple(hidden), **features)
    path = Path(path)
    if path.suffix == ".avi":
        return write_avi(path, stream, writer.width, writer.height)
    return write_webm(path, stream, writer.width, writer.height,
                      doc_type="matroska" if path.suffix == ".mkv" else "webm", **mux)
