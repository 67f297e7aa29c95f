"""A random legal-syntax HEVC writer, for holding the port's host decoder
(`omfs4d_torch/io/hevcdec.cpp`) to an independent one (cv2's FFmpeg) with no
HEVC encoder at hand.

`Writer(seed, **features).stream()` draws every syntax element of Main
(or, with `bit_depth` 9 or 10, Main 10) profile I, P and B pictures at random, within what the standard allows and
what the neighbours make available, and returns the NAL units of each access
unit in decoding order.  It needs no reconstruction: it keeps only what the
syntax itself depends on, as the decoder derives it (the depth, skip flag,
prediction mode and luma intra mode of each 4 x 4 unit, which the context
selection of split_cu_flag and cu_skip_flag, the most probable modes of
8.4.2 and the scan order of 4 x 4 and 8 x 8 intra blocks read), and codes it
through its own CABAC encoder (9.3.4, the context selection of 9.3.4.2):

- pictures: IDR, trailing P and B pictures (B-pyramids of 4 with the middle
  B a reference), a CRA with RASL and RADL pictures, temporal sub-layers
  (TSA and STSA pictures), non-reference pictures, pic_output_flag 0, an
  IDR with no_output_of_prior_pics_flag; the RPS of each picture is what it
  and the pictures after it reference, coded in the SPS or the slice header,
  explicitly or predicted from another RPS; sps_max_num_reorder_pics from
  the plan;
- slices: several a picture, dependent slice segments, slices starting
  inside a CTB row, wavefront parallel processing (the context store after a
  row's second CTB and the sync at a row's start, end_of_subset_one_bit and
  the entry points, counted with the emulation prevention bytes), extra
  slice header bits and the header extension;
- coding quadtree: CTB 16 to 64, every split, cu_skip_flag, intra CUs in
  P and B slices, every part_mode (AMP included), merge (with
  log2_parallel_merge_level), AMVP with mvd_l1_zero_flag, inter_pred_idc
  with the 8x4 / 4x8 rule, reference indices over both lists;
- intra: the 35 luma modes coded through the most probable modes, the five
  chroma modes, constrained intra prediction;
- transform tree: every split the SPS allows, the cbf chains, cu_qp_delta,
  transform_skip_flag, residual_coding with sparse levels (escapes, Rice
  adaptation, sign data hiding);
- loop filters: SAO (band and edge, merge left and up), the deblocking
  filter's PPS and slice overrides, slice_loop_filter_across_slices;
- parameter sets: VPS, several SPS / PPS ids, sub-layer ordering info, a
  conformance window, the VUI's colour (`torch_h264_syntax.vui_colour`),
  chroma sample location (`chroma_loc`, one type for both fields), timing, default display window and HRD, explicit weighted prediction,
  list modification, TMVP's collocated picture;
- Main 10 (`bit_depth`): the depths in the SPS, SAO offsets up to 31, slice
  QPs, init_qp and cu_qp_delta over the range QpBdOffsetY widens (down to
  -12);
- tiles (`tiles=(columns, rows)`): uniform or explicit spacing, loop filtering
  across tiles or not, the tile scan, slices of several whole tiles and tiles
  of several slices, dependent segments at and inside a tile, the contexts
  initialised and the substream realigned at each tile, the entry points;
  with `wpp`, the WPP rows of each tile (a pair the decoder refuses);
- long-term reference pictures (`long_term`): the SPS's candidates and the
  slice header's entries, with and without delta_poc_msb_cycle_lt (its
  running sum in each group), used and not, in the lists (modification
  included) and as TMVP's collocated picture, held to the CVS's end;
- scaling lists (`scaling`): in the SPS, in the PPS over the SPS's, or the
  defaults with no data; each list coded (with its DC at 16 x 16 and
  32 x 32), copied from an earlier one or the default;
- PCM (`pcm`): CUs of the SPS's PCM sizes at its PCM depths, the loop filter
  over them on or off;
- transquant bypass (`bypass`): cu_transquant_bypass_flag, the residual with
  no transform skip flag and no hidden sign.
`corrupt` writes one value of these out of its range (`CORRUPT`).

`annexb` writes the access units as a byte stream, `write_mov` as MP4 /
QuickTime (`hvc1` / `hev1`, with `ctts`, an edit list and a display
matrix).  The tables are `omfs4d_torch.io.hevc_tables`, the port's only
copy; cv2's decoder is the check that they and the context rules are right.
"""

from __future__ import annotations

import random
import struct
from collections import Counter

from omfs4d_torch.io import hevc_tables as T
from tests.torch_h264_syntax import BitWriter, _box, sei_rbsp, vui_colour, write_track_file

C = T.CTX
# NAL unit types
TRAIL_N, TRAIL_R, TSA_N, TSA_R, STSA_N, STSA_R = 0, 1, 2, 3, 4, 5
RADL_N, RADL_R, RASL_N, RASL_R = 6, 7, 8, 9
BLA_W_LP, IDR_W_RADL, IDR_N_LP, CRA = 16, 19, 20, 21
VPS, SPS, PPS, SEI_PREFIX = 32, 33, 34, 39
PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN = 0, 1, 2, 3
PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N = 4, 5, 6, 7


def escape(body: bytes, zeros: int = 0) -> tuple[bytes, int]:
    """Emulation prevention of `body` after `zeros` zero bytes: (the escaped
    bytes, the zero bytes it ends with)."""
    out = bytearray()
    for b in body:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out), zeros


def nal(kind: int, rbsp: bytes, tid: int = 0) -> bytes:
    return bytes([kind << 1, tid + 1]) + escape(rbsp)[0]


class Cabac:
    """9.3.4: the arithmetic encoder, with the slice's context states."""

    def __init__(self, bw: BitWriter):
        self.bw = bw
        self.state = [0] * T.N_CTX
        self.mps = [0] * T.N_CTX
        self.start()

    def init(self, init_type: int, qp: int) -> None:
        for i, v in enumerate(T.CABAC_INIT[init_type]):
            m, n = (int(v) >> 4) * 5 - 45, ((int(v) & 15) << 3) - 16
            pre = min(max(((m * min(max(qp, 0), 51)) >> 4) + n, 1), 126)
            self.mps[i] = 0 if pre <= 63 else 1
            self.state[i] = 63 - pre if pre <= 63 else pre - 64

    def save(self):
        return list(self.state), list(self.mps)

    def load(self, saved) -> None:
        self.state, self.mps = list(saved[0]), list(saved[1])

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

    def bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bypass((v >> i) & 1)

    def terminate(self, b: int) -> None:
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self.renorm()
            self.put((self.low >> 9) & 1)
            self.bw.u(2, ((self.low >> 7) & 3) | 1)     # the last 1: the stop / alignment bit
            self.bw.align_zero()
        else:
            self.renorm()


def eg(cab: Cabac, v: int, k: int) -> None:
    """k-th order Exp-Golomb in bypass bins (9.3.3.3)."""
    while v >= 1 << k:
        cab.bypass(1)
        v -= 1 << k
        k += 1
    cab.bypass(0)
    cab.bits(v, k)


DEFAULTS = dict(
    width=64, height=48, frames=3, ctb=32, min_cb=8, min_tb=4, max_tb=32, depth_inter=2,
    depth_intra=2, amp=True, sao=False, tmvp=True, strong=True, wpp=False, slices=1,
    dependent=0.0, mid_row=0.0, gop="p", refs=2, num_ref_idx=2, intra_in_inter=0.15, skip=0.3,
    merge=0.4, split=0.55, tsplit=0.4, cbf=0.6, density=0.12, qp=(22, 37), cu_qp_delta=True,
    qp_depth=1, qp_delta=4, sign_hiding=True, transform_skip=True, constrained_intra=False,
    weighted=False, deblock=("on", "off", "offsets"), deblock_override=True, lf_across=(0, 1),
    list_mod=False, merge_level=(2, 3), cabac_init=True, chroma_offsets=(0, 0),
    slice_chroma=False, output_flag=False, no_output_prior=False, sublayers=False, cra=False,
    colour=None, chroma_loc=None, display_window=False, extra_bits=0, header_ext=False, sps_rps=0.6,
    inter_rps=0.5, non_ref=0.0, mvd_l1_zero=0.5, fps=25, hrd=False, level=93, big=0.05,
    param_sets=1, max_merge=(1, 5), idr_every=0, root_cbf=0.7, mvd_max=24, refuse=None,
    bit_depth=8, sei=(),
    # the tools of 7.3.2.2 / 7.3.2.3 that the sets above leave off
    tiles=None, tile_uniform=True, lf_tiles=(0, 1), multi_tile=0.3, split_tile=0.3,
    long_term=0, lt_early=False, poc_lsb_bits=None, scaling=None, pcm=0.0, pcm_sizes=None,
    pcm_depths=None, pcm_lf=(0, 1), bypass=0.0, corrupt=None)

# what `corrupt` breaks in a stream that uses the tools: each a value out of
# its range that the decoder must refuse (`lt_missing`, a long-term reference
# that is not in the DPB, it shows grey, as FFmpeg does a missing one)
CORRUPT = ("tile_sizes", "entry_points", "lt_idx_sps", "lt_missing", "scaling_delta",
           "pcm_sizes", "pcm_depth")

# a tool outside the decoder's subset that `refuse` sets in the parameter
# sets (the set ends there: the decoder stops at the flag), and the name
# its refusal gives
REFUSE = {"main12": "bit depth above 10",
          "unequal_depths": "luma and chroma bit depths that differ",
          "chroma_400": "chroma format 4:0:0", "chroma_422": "chroma format 4:2:2",
          "chroma_444": "chroma format 4:4:4", "range_extension": "range extension",
          "multilayer": "multilayer extension", "scc": "screen content coding extension",
          "pps_range_extension": "pps_range_extension_flag", "pps_3d": "pps_3d_extension_flag"}


class Pic:
    __slots__ = ("poc", "kind", "nal", "tid", "ref", "l0", "l1", "output", "rps", "idr",
                 "no_output_prior", "cvs", "lt")

    def __init__(self, poc, kind, nal_type, tid=0, ref=True, l0=(), l1=(), cvs=0):
        self.poc, self.kind, self.nal, self.tid, self.ref = poc, kind, nal_type, tid, ref
        self.l0, self.l1, self.output, self.rps, self.cvs = list(l0), list(l1), True, [], cvs
        self.lt: list[tuple[int, bool]] = []        # long-term entries: (POC, used)
        self.idr = nal_type in (IDR_W_RADL, IDR_N_LP)
        self.no_output_prior = False


class Writer:
    def __init__(self, seed: int, **features):
        unknown = set(features) - set(DEFAULTS)
        if unknown:
            raise TypeError(f"unknown features {sorted(unknown)}")
        self.f = dict(DEFAULTS, **features)
        self.rng = random.Random(seed)
        self.stats: Counter = Counter()
        f = self.f
        self.w, self.h = f["width"], f["height"]
        self.log2_ctb = {16: 4, 32: 5, 64: 6}[f["ctb"]]
        self.log2_min_cb = f["min_cb"].bit_length() - 1
        self.log2_min_tb = f["min_tb"].bit_length() - 1
        self.log2_max_tb = min(f["max_tb"].bit_length() - 1, self.log2_ctb)
        cb = f["min_cb"]
        self.W, self.H = -(-self.w // cb) * cb, -(-self.h // cb) * cb
        self.ctb_w = -(-self.W // f["ctb"])
        self.ctb_h = -(-self.H // f["ctb"])
        self.w4, self.h4 = self.W // 4, self.H // 4
        self.display: list[int] = []
        self.bd = f["bit_depth"]
        self.qpbd = 6 * (self.bd - 8)
        if self.bd > 8:
            self.stats[f"bd{self.bd}"] += 1

    # ── the plan of pictures ──
    def plan(self) -> list[Pic]:
        f, rng = self.f, self.rng
        n = f["frames"]
        pics: list[Pic] = []
        gop = f["gop"]
        if gop in ("intra", "p"):
            cvs, base = 0, 0
            for k in range(n):
                if k == 0 or (f["idr_every"] and k % f["idr_every"] == 0):
                    cvs += k > 0
                    base = k
                    p = Pic(0, "I", rng.choice((IDR_W_RADL, IDR_N_LP)), cvs=cvs)
                    p.no_output_prior = f["no_output_prior"] and k > 0
                    pics.append(p)
                    continue
                poc = k - base
                if gop == "intra":
                    pics.append(Pic(poc, "I", rng.choice((TRAIL_R, CRA)) if k % 3 == 2
                                    else TRAIL_R, cvs=cvs))
                    continue
                refs = [q.poc for q in pics if q.cvs == cvs and q.ref][-f["refs"]:]
                ref = rng.random() >= f["non_ref"]
                pics.append(Pic(poc, "P", TRAIL_R if ref else TRAIL_N, ref=ref,
                                l0=refs[::-1], cvs=cvs))
        else:                                              # B-pyramids of 4
            pics.append(Pic(0, "I", IDR_W_RADL))
            anchors = [0]
            poc = 0
            cvs = 0
            sub = f["sublayers"]
            while len(pics) < n:
                nxt = poc + 4
                if f["cra"] and nxt == 8:
                    # a CRA, its RASL pictures (referencing the P before it)
                    # and a RADL picture (referencing the CRA alone); a BLA
                    # in its place drops the RASL pictures (no output)
                    bla = f["cra"] == "bla"
                    pics.append(Pic(8, "I", BLA_W_LP if bla else CRA))
                    prev = anchors[-1]
                    pics.append(Pic(6, "B", RASL_R, tid=1 if sub else 0, l0=[prev], l1=[8]))
                    pics.append(Pic(5, "B", RASL_N, tid=2 if sub else 0, ref=False,
                                    l0=[prev], l1=[6, 8]))
                    if bla:
                        pics[-1].output = pics[-2].output = False
                    pics.append(Pic(7, "B", RADL_N, tid=2 if sub else 0, ref=False, l0=[8],
                                    l1=[8]))
                    anchors = [8]
                    poc = 8
                    continue
                if f["no_output_prior"] and nxt == 8:
                    cvs += 1
                    p = Pic(0, "I", IDR_W_RADL, cvs=cvs)
                    p.no_output_prior = True
                    pics.append(p)
                    anchors, poc = [0], 0
                    continue
                back = anchors[-f["refs"]:][::-1]
                pics.append(Pic(nxt, "P" if rng.random() < 0.5 else "B", TRAIL_R, l0=back,
                                l1=back[:1], cvs=cvs))
                mid_type = rng.choice((TSA_R, STSA_R)) if sub else TRAIL_R
                pics.append(Pic(poc + 2, "B", mid_type, tid=1 if sub else 0,
                                l0=[poc] + back[1:2], l1=[nxt], cvs=cvs))
                for leaf, l0, l1 in ((poc + 1, [poc], [poc + 2, nxt]),
                                     (poc + 3, [poc + 2, poc], [nxt])):
                    leaf_type = rng.choice((TSA_N, STSA_N, TRAIL_N)) if sub else TRAIL_N
                    pics.append(Pic(leaf, "B", leaf_type, tid=2 if sub else 0, ref=False, l0=l0,
                                    l1=l1, cvs=cvs))
                anchors.append(nxt)
                poc = nxt
            pics = pics[:n]
        if f["output_flag"]:
            for p in pics[1:]:
                p.output = p.output and rng.random() < 0.7
        # long-term pictures: POC -> (its index, the index from which it is
        # long-term); held to the end of the first CVS
        long_term = self.plan_long_term(pics) if f["long_term"] else {}
        # RPS: the reference pictures held are those the picture or a later
        # one of its CVS references (8.3.2)
        held: list[Pic] = []
        for k, p in enumerate(pics):
            if p.idr:
                held = []
                p.rps = []
            else:
                later = set()
                for q in pics[k:]:
                    if q.cvs != p.cvs or q.idr and q is not p:
                        break
                    later.update(q.l0 + q.l1)
                later.update(poc for poc, (kx, _) in long_term.items() if kx < k)
                used = set(p.l0 + p.l1)
                held = [q for q in held if q.poc in later]
                lt = {q.poc for q in held if q.poc in long_term and k >= long_term[q.poc][1]}
                p.rps = sorted(((q.poc - p.poc, q.poc in used) for q in held if q.poc not in lt),
                               key=lambda e: (e[0] > 0, -e[0] if e[0] < 0 else e[0]))
                p.lt = [(poc, poc in used) for poc in sorted(lt)]
            if p.ref:
                held.append(p)
        self.pics = pics
        # each picture's place in output order, and the reorder it needs
        order = sorted(range(len(pics)), key=lambda i: (pics[i].cvs, pics[i].poc))
        place = [0] * len(pics)
        for k, i in enumerate(order):
            place[i] = k
        self.display = place
        reorder = 0
        for k, p in enumerate(pics):
            if p.output:
                reorder = max(reorder, sum(1 for q in pics[:k] if q.cvs == p.cvs and q.output
                                           and q.poc > p.poc))
        self.reorder = reorder
        self.max_rps = max(len(p.rps) + len(p.lt) for p in pics)
        self.long_term = long_term
        return pics

    def plan_long_term(self, pics: list[Pic]) -> dict:
        """Choose `long_term` reference pictures of the first CVS to become
        long-term (from a picture on which every later one of the CVS has a
        greater POC, so that DeltaPocMsbCycleLt is never negative), held to
        the CVS's end, and add them to the lists of some later pictures that
        may reference them (not an IRAP's, a RADL's or a trailing picture's
        past an IRAP)."""
        f, rng = self.f, self.rng
        cvs0 = [k for k, p in enumerate(pics) if p.cvs == 0 and not (p.idr and k)]
        cands = [k for k in cvs0 if pics[k].ref]
        if not f["lt_early"]:                          # else the first, long-term at once
            rng.shuffle(cands)
        chosen = {}
        for kx in cands:
            x = pics[kx]
            starts = [k for k in cvs0
                      if k > kx and all(pics[j].poc > x.poc for j in cvs0 if j >= k)]
            if starts:
                chosen[x.poc] = (kx, starts[0] if f["lt_early"] else rng.choice(starts[:4]))
            if len(chosen) == f["long_term"]:
                break
        for poc, (kx, k0) in chosen.items():
            for k in cvs0:
                p = pics[k]
                irap = [j for j in range(kx + 1, k + 1) if 16 <= pics[j].nal <= 23]
                may = p.kind != "I" and p.nal not in (RADL_N, RADL_R) and (
                    not irap or p.nal in (RASL_N, RASL_R) and irap == [max(irap)])
                if k >= k0 and may and poc not in p.l0 + p.l1 and rng.random() < 0.6:
                    p.l0.append(poc)
        return chosen

    # ── parameter sets ──
    def ptl(self, bw: BitWriter, sub_layers_minus1: int) -> None:
        profile, compat = (1, 0x60000000) if self.bd == 8 else (2, 0x20000000)   # Main, Main 10
        bw.u(2, 0)
        bw.u(1, 0)
        bw.u(5, profile)
        bw.u(32, compat)
        bw.u(4, 0b1001)                     # progressive, frame only
        bw.u(43, 0)
        bw.u(1, 0)
        bw.u(8, self.f["level"])
        present = [(self.rng.random() < 0.5, self.rng.random() < 0.5)
                   for _ in range(sub_layers_minus1)]
        for p, lv in present:
            bw.u(1, p)
            bw.u(1, lv)
        if sub_layers_minus1:
            for _ in range(sub_layers_minus1, 8):
                bw.u(2, 0)
        for p, lv in present:
            if p:
                bw.u(2, 0)
                bw.u(1, 0)
                bw.u(5, profile)
                bw.u(32, compat)
                bw.u(4, 0b1001)
                bw.u(43, 0)
                bw.u(1, 0)
            if lv:
                bw.u(8, self.f["level"])

    def vps(self) -> bytes:
        bw = BitWriter()
        msl = self.msl
        bw.u(4, 0)
        bw.u(1, 1)
        bw.u(1, 1)
        bw.u(6, 0)
        bw.u(3, msl)
        bw.u(1, 0 if msl else 1)
        bw.u(16, 0xFFFF)
        self.ptl(bw, msl)
        bw.u(1, 1)
        for _ in range(msl + 1):
            bw.ue(self.max_dec - 1)
            bw.ue(self.reorder)
            bw.ue(0)
        bw.u(6, 0)
        bw.ue(0)
        bw.u(1, 0)
        bw.u(1, 0)
        bw.trailing()
        return nal(VPS, bw.data())

    def rps_code(self, bw: BitWriter, idx: int, num: int, rps, sets) -> None:
        """st_ref_pic_set(idx): predicted from an earlier set where that can
        express it (and the dice say so), else explicit."""
        if idx:
            cands = list(range(idx)) if idx == num else [idx - 1]
            self.rng.shuffle(cands)
            for ref_idx in cands:
                coded = self.inter_rps(sets[ref_idx], rps)
                if coded is not None and self.rng.random() < self.f["inter_rps"]:
                    bw.u(1, 1)
                    if idx == num:
                        bw.ue(idx - ref_idx - 1)
                    delta, flags = coded
                    bw.u(1, delta < 0)
                    bw.ue(abs(delta) - 1)
                    for used, use_delta in flags:
                        bw.u(1, used)
                        if not used:
                            bw.u(1, use_delta)
                    self.stats["inter_rps"] += 1
                    return
            bw.u(1, 0)
        neg = [e for e in rps if e[0] < 0]
        pos = [e for e in rps if e[0] > 0]
        bw.ue(len(neg))
        bw.ue(len(pos))
        prev = 0
        for d, used in neg:
            bw.ue(prev - d - 1)
            bw.u(1, used)
            prev = d
        prev = 0
        for d, used in pos:
            bw.ue(d - prev - 1)
            bw.u(1, used)
            prev = d

    def inter_rps(self, ref, target):
        want = dict(target)
        for delta in sorted({t - r for t in want for r in [e[0] for e in ref] + [0]}):
            if delta == 0 or abs(delta) > 32768:
                continue
            got = {r + delta for r, _ in ref} | {delta}
            if not set(want) <= got:
                continue
            flags = []
            for d in [r + delta for r, _ in ref] + [delta]:
                if d in want and d != 0:
                    flags.append((int(want[d]), 1))
                else:
                    flags.append((0, 0))
            return delta, flags
        return None

    def sps(self, sps_id: int) -> bytes:
        f, rng = self.f, self.rng
        bw = BitWriter()
        bw.u(4, 0)
        bw.u(3, self.msl)
        bw.u(1, 0 if self.msl else 1)
        self.ptl(bw, self.msl)
        bw.ue(sps_id)
        refuse = f["refuse"]
        if refuse in ("chroma_400", "chroma_422", "chroma_444"):
            bw.ue({"chroma_400": 0, "chroma_422": 2, "chroma_444": 3}[refuse])
            bw.trailing()
            return nal(SPS, bw.data())
        bw.ue(1)                               # 4:2:0
        bw.ue(self.W)
        bw.ue(self.H)
        crop = (self.W - self.w, self.H - self.h)
        bw.u(1, any(crop))
        if any(crop):
            for v in (0, crop[0] // 2, 0, crop[1] // 2):
                bw.ue(v)
            self.stats["conformance_window"] += 1
        depth = 12 if refuse == "main12" else self.bd
        bw.ue(depth - 8)
        bw.ue(depth - 8 + 2 * (refuse == "unequal_depths"))
        bw.ue(self.log2_max_poc_lsb - 4)
        ordering = self.msl > 0 and rng.random() < 0.5
        bw.u(1, ordering)
        for _ in range(self.msl + 1 if ordering else 1):
            bw.ue(self.max_dec - 1)
            bw.ue(self.reorder)
            bw.ue(rng.choice((0, 0, 3)))
        bw.ue(self.log2_min_cb - 3)
        bw.ue(self.log2_ctb - self.log2_min_cb)
        bw.ue(self.log2_min_tb - 2)
        bw.ue(self.log2_max_tb - self.log2_min_tb)
        bw.ue(f["depth_inter"])
        bw.ue(f["depth_intra"])
        bw.u(1, self.scaling_where is not None)         # scaling lists
        if self.scaling_where is not None:
            coded = self.scaling_where in ("sps", "both")
            bw.u(1, coded)
            if coded:
                self.scaling_list_data(bw)
                self.stats["scaling_sps"] += 1
        bw.u(1, f["amp"])
        bw.u(1, f["sao"])
        bw.u(1, bool(f["pcm"]))                # PCM
        if f["pcm"]:
            bw.u(4, self.pcm_depths[0] - 1 + (f["corrupt"] == "pcm_depth"))
            bw.u(4, self.pcm_depths[1] - 1)
            bw.ue(self.pcm_sizes[0] - 3 + 3 * (f["corrupt"] == "pcm_sizes"))
            bw.ue(self.pcm_sizes[1] - self.pcm_sizes[0])
            bw.u(1, self.pcm_lf_disabled)
        bw.ue(len(self.sps_sets))
        for i, rps in enumerate(self.sps_sets):
            self.rps_code(bw, i, len(self.sps_sets), rps, self.sps_sets)
        bw.u(1, bool(f["long_term"]))          # long-term reference pictures
        if f["long_term"]:
            bw.ue(len(self.lt_sps))
            for lsb, used in self.lt_sps:
                bw.u(self.log2_max_poc_lsb, lsb)
                bw.u(1, used)
        bw.u(1, f["tmvp"])
        bw.u(1, f["strong"])
        vui = (f["colour"] is not None or f["chroma_loc"] is not None or f["display_window"]
               or f["hrd"] or rng.random() < 0.5)
        bw.u(1, vui)
        if vui:
            aspect = rng.random() < 0.3
            bw.u(1, aspect)
            if aspect:
                bw.u(8, 255)
                bw.u(16, 1)
                bw.u(16, 1)
            bw.u(1, 0)
            bw.u(1, f["colour"] is not None)
            if f["colour"] is not None:
                colour = vui_colour(f["colour"])
                bw.u(3, 5)
                bw.u(1, colour[0])
                bw.u(1, 1)
                for v in colour[1:]:
                    bw.u(8, v)
            bw.u(1, f["chroma_loc"] is not None)
            if f["chroma_loc"] is not None:        # top and bottom field alike
                bw.ue(f["chroma_loc"])
                bw.ue(f["chroma_loc"])
            bw.u(3, 0)
            bw.u(1, f["display_window"])
            if f["display_window"]:
                for v in (2, 2, 1, 3):
                    bw.ue(v)
                self.stats["default_display_window"] += 1
            bw.u(1, 1)
            bw.u(32, 1)
            bw.u(32, f["fps"])
            bw.u(1, 0)
            bw.u(1, f["hrd"])
            if f["hrd"]:
                bw.u(1, 1)                     # nal hrd
                bw.u(1, 0)
                bw.u(1, 0)                     # sub_pic
                bw.u(4, 0)
                bw.u(4, 0)
                bw.u(5, 23)
                bw.u(5, 23)
                bw.u(5, 23)
                for _ in range(self.msl + 1):
                    bw.u(1, 0)
                    bw.u(1, 0)
                    bw.u(1, 0)                 # low_delay
                    bw.ue(0)                   # cpb_cnt_minus1
                    bw.ue(1000)
                    bw.ue(1000)
                    bw.u(1, 0)
                self.stats["hrd"] += 1
            restriction = rng.random() < 0.5
            bw.u(1, restriction)
            if restriction:
                bw.u(3, 0b010)
                for v in (0, 2, 1, 15, 15):
                    bw.ue(v)
        ext = refuse in ("range_extension", "multilayer", "scc")
        bw.u(1, ext)                           # sps_extension_present_flag
        if ext:
            bw.u(1, refuse == "range_extension")
            bw.u(1, refuse == "multilayer")
            bw.u(1, 0)
            bw.u(1, refuse == "scc")
            bw.u(4, 0)
        bw.trailing()
        return nal(SPS, bw.data())

    def pps(self, pps_id: int, sps_id: int) -> bytes:
        f, rng = self.f, self.rng
        p = {"id": pps_id, "sps": sps_id}
        bw = BitWriter()
        bw.ue(pps_id)
        bw.ue(sps_id)
        p["dependent"] = f["dependent"] > 0 or rng.random() < 0.3
        bw.u(1, p["dependent"])
        p["output_flag"] = f["output_flag"]
        bw.u(1, p["output_flag"])
        p["extra_bits"] = f["extra_bits"]
        bw.u(3, p["extra_bits"])
        p["sign_hiding"] = f["sign_hiding"] == "always" or (f["sign_hiding"] and rng.random() < 0.8)
        bw.u(1, p["sign_hiding"])
        p["cabac_init_present"] = f["cabac_init"] and rng.random() < 0.7
        bw.u(1, p["cabac_init_present"])
        p["num_ref_idx"] = [rng.randint(1, f["num_ref_idx"]), rng.randint(1, f["num_ref_idx"])]
        bw.ue(p["num_ref_idx"][0] - 1)
        bw.ue(p["num_ref_idx"][1] - 1)
        p["init_qp"] = rng.randint(*f["qp"])
        bw.se(p["init_qp"] - 26)
        p["constrained_intra"] = f["constrained_intra"]
        bw.u(1, p["constrained_intra"])
        p["transform_skip"] = f["transform_skip"] and rng.random() < 0.8
        bw.u(1, p["transform_skip"])
        p["cu_qp_delta"] = f["cu_qp_delta"] and rng.random() < 0.8
        bw.u(1, p["cu_qp_delta"])
        p["qp_depth"] = 0
        if p["cu_qp_delta"]:
            p["qp_depth"] = rng.randint(0, min(f["qp_depth"], self.log2_ctb - self.log2_min_cb))
            bw.ue(p["qp_depth"])
        p["cb_qp"], p["cr_qp"] = f["chroma_offsets"]
        bw.se(p["cb_qp"])
        bw.se(p["cr_qp"])
        p["slice_chroma"] = f["slice_chroma"]
        bw.u(1, p["slice_chroma"])
        p["weighted_pred"] = f["weighted"] and rng.random() < 0.8
        p["weighted_bipred"] = f["weighted"] and rng.random() < 0.8
        bw.u(1, p["weighted_pred"])
        bw.u(1, p["weighted_bipred"])
        p["bypass"] = bool(f["bypass"])
        bw.u(1, p["bypass"])                   # transquant bypass
        p["tiles"] = bool(f["tiles"])
        bw.u(1, p["tiles"])
        p["wpp"] = f["wpp"]
        bw.u(1, p["wpp"])
        p["lf_tiles"] = True
        if p["tiles"]:
            bw.ue(len(self.col_w) - 1)
            bw.ue(len(self.row_h) - 1)
            bw.u(1, f["tile_uniform"])
            if not f["tile_uniform"]:
                for k, v in enumerate(self.col_w[:-1] + self.row_h[:-1]):
                    bw.ue(v - 1 + self.ctb_w * (f["corrupt"] == "tile_sizes" and k == 0))
            p["lf_tiles"] = bool(rng.choice(f["lf_tiles"]))
            bw.u(1, p["lf_tiles"])
        p["lf_across"] = rng.choice(f["lf_across"]) if isinstance(f["lf_across"], tuple) \
            else f["lf_across"]
        bw.u(1, p["lf_across"])
        control = f["deblock_override"] or "off" in f["deblock"] or rng.random() < 0.5
        bw.u(1, control)
        p["override"], p["deblock_disabled"], p["beta"], p["tc"] = False, False, 0, 0
        if control:
            p["override"] = f["deblock_override"]
            bw.u(1, p["override"])
            p["deblock_disabled"] = "off" in f["deblock"] and rng.random() < 0.3
            bw.u(1, p["deblock_disabled"])
            if not p["deblock_disabled"]:
                p["beta"], p["tc"] = rng.randint(-6, 6), rng.randint(-6, 6)
                bw.se(p["beta"])
                bw.se(p["tc"])
        # "both": the first PPS (of two) replaces the SPS's lists, the second not
        p["scaling"] = pps_lists = self.scaling_where == "pps" or (
            self.scaling_where == "both" and len(self.pps_list) % 2 == 0)
        bw.u(1, pps_lists)                     # scaling list data
        if pps_lists:
            self.scaling_list_data(bw)
            self.stats["scaling_pps"] += 1
        p["list_mod"] = f["list_mod"]
        bw.u(1, p["list_mod"])
        ml = f["merge_level"]
        p["merge_level"] = rng.randint(*ml) if isinstance(ml, tuple) else ml
        bw.ue(p["merge_level"] - 2)
        p["header_ext"] = f["header_ext"]
        bw.u(1, p["header_ext"])
        ext = f["refuse"] in ("pps_range_extension", "pps_3d")
        bw.u(1, ext)                           # pps_extension_present_flag
        if ext:
            bw.u(1, f["refuse"] == "pps_range_extension")
            bw.u(1, 0)
            bw.u(1, f["refuse"] == "pps_3d")
            bw.u(5, 0)
        bw.trailing()
        self.pps_list.append(p)
        return nal(PPS, bw.data())

    # ── the stream ──
    def stream(self) -> list[list[bytes]]:
        first = self.parameter_sets()
        aus = []
        for k, p in enumerate(self.pics):
            self.stats[f"nal{p.nal}"] += 1
            self.stats[p.kind] += 1
            units = self.picture(p)
            if k == 0 and self.f["sei"]:
                units = [nal(SEI_PREFIX, sei_rbsp(self.f["sei"]))] + units
            aus.append(first + units if k == 0 else units)
        return aus

    def parameter_sets(self) -> list[bytes]:
        """The plan, then the VPS, SPS and PPS units that open the stream."""
        f, rng = self.f, self.rng
        self.plan()
        self.msl = 2 if f["sublayers"] else 0
        self.max_dec = min(16, self.max_rps + self.reorder + 2)
        self.log2_max_poc_lsb = f["poc_lsb_bits"] or rng.randint(5, 8)
        self.tool_parameters()
        # the RPSs the SPS holds
        distinct = []
        for p in self.pics:
            if not p.idr and p.rps not in distinct:
                distinct.append(p.rps)
        self.sps_sets = [r for r in distinct if rng.random() < f["sps_rps"]]
        self.pps_list = []
        first = [self.vps()]
        n_sets = f["param_sets"]
        sps_ids = rng.sample(range(16), n_sets)
        for k in range(n_sets):
            first.append(self.sps(sps_ids[k]))
        pps_ids = rng.sample(range(64), n_sets)
        for k in range(n_sets):
            first.append(self.pps(pps_ids[k], sps_ids[k]))
        return first

    def tool_parameters(self) -> None:
        """The tools' choices that every SPS / PPS of the stream shares: the
        tile grid, where the scaling lists are coded, the PCM sizes and
        depths, the SPS's long-term candidates."""
        f, rng = self.f, self.rng
        self.col_w = self.row_h = None
        if f["tiles"]:
            cols, rows = f["tiles"]
            if f["tile_uniform"]:
                self.col_w = [(i + 1) * self.ctb_w // cols - i * self.ctb_w // cols
                              for i in range(cols)]
                self.row_h = [(i + 1) * self.ctb_h // rows - i * self.ctb_h // rows
                              for i in range(rows)]
            else:
                def split(total, n):
                    cuts = sorted(rng.sample(range(1, total), n - 1))
                    return [b - a for a, b in zip([0] + cuts, cuts + [total])]
                self.col_w, self.row_h = split(self.ctb_w, cols), split(self.ctb_h, rows)
                self.stats["tiles_explicit"] += 1
        self.scaling_where = rng.choice(f["scaling"]) if isinstance(f["scaling"], tuple) \
            else f["scaling"]
        if f["pcm"]:
            top = min(self.log2_ctb, 5)
            sizes = range(min(self.log2_min_cb, 5), top + 1)
            lo, hi = f["pcm_sizes"] or sorted((rng.choice(sizes), rng.choice(sizes)))
            self.pcm_sizes = (lo, hi)
            self.pcm_depths = f["pcm_depths"] or (rng.randint(5, self.bd), rng.randint(5, self.bd))
            self.pcm_lf_disabled = rng.choice(f["pcm_lf"])
            if min(self.pcm_depths) < self.bd:
                self.stats["pcm_depth_below"] += 1
            self.stats[f"pcm_lf_disabled{int(self.pcm_lf_disabled)}"] += 1
        self.lt_sps: list[tuple[int, bool]] = []
        if f["long_term"]:
            mask = (1 << self.log2_max_poc_lsb) - 1
            for poc in self.long_term:
                self.lt_sps += [(poc & mask, used) for used in (False, True)
                                if rng.random() < 0.6] or [(poc & mask, True)]
            self.lt_sps.append((rng.randrange(mask + 1), rng.random() < 0.5))   # one unused
            while f["corrupt"] == "lt_idx_sps" and len(self.lt_sps) != 3:
                self.lt_sps = self.lt_sps[:3] if len(self.lt_sps) > 3 else \
                    self.lt_sps + [(0, False)]
            rng.shuffle(self.lt_sps)

    def scaling_list_data(self, bw: BitWriter) -> None:
        """scaling_list_data() (7.3.4): each list at random the default, a
        copy of an earlier one of its size, or coded (with its DC at 16 x 16
        and 32 x 32)."""
        rng = self.rng
        for size_id in range(4):
            step = 3 if size_id == 3 else 1
            for matrix_id in range(0, 6, step):
                how = rng.choice(("coded", "coded", "copy", "default"))
                if how == "copy" and matrix_id == 0:
                    how = "default"
                if how != "coded":
                    bw.u(1, 0)
                    bw.ue(rng.randint(1, matrix_id // step) if how == "copy" else
                          matrix_id // step + 1 if self.f["corrupt"] == "scaling_delta" else 0)
                    self.stats[f"scaling_pred_{how}"] += 1
                    continue
                bw.u(1, 1)
                last = 8
                if size_id > 1:
                    dc = rng.choice((rng.randint(1, 255), rng.randint(8, 40)))
                    bw.se(dc - 8)
                    last = dc
                    self.stats["scaling_dc"] += 1
                for _ in range(16 if size_id == 0 else 64):
                    v = rng.randint(4, 64) if rng.random() < 0.9 else rng.randint(1, 255)
                    bw.se((v - last + 128) % 256 - 128)
                    last = v
                self.stats["scaling_coded"] += 1

    # ── a picture ──
    def picture(self, pic: Pic) -> list[bytes]:
        f, rng = self.f, self.rng
        # one PPS (and so one SPS) a CVS
        if pic.idr:
            self.cur_pps = rng.choice(self.pps_list)
        pps = self.cur_pps
        self.pic = pic
        n4 = self.w4 * self.h4
        self.depth = [0] * n4
        self.skipm = [0] * n4
        self.intram = [0] * n4
        self.ipm = [1] * n4
        self.ctb_slice = [-1] * (self.ctb_w * self.ctb_h)
        self.layout_tiles(pps)
        if pps["tiles"]:
            self.stats[f"lf_tiles{int(pps['lf_tiles'])}"] += 1
        if self.scaling_where:
            self.stats["scaling_in_pps" if pps["scaling"] else "scaling_in_sps"
                        if self.scaling_where in ("sps", "both") else "scaling_defaults"] += 1
        # per picture: the lists and TMVP's collocated picture
        n_ctb = self.ctb_w * self.ctb_h
        total = sum(u for _, u in pic.rps) + sum(u for _, u in pic.lt)
        self.pic_params = {"num_ref_idx": [0, 0], "mods": [None, None], "col_l0": True,
                           "col_idx": 0, "tmvp": f["tmvp"]}
        pp = self.pic_params
        if pic.lt:
            self.lt_coding(pic)
        if pic.kind != "I":
            for l in range(2 if pic.kind == "B" else 1):
                pp["num_ref_idx"][l] = rng.randint(1, f["num_ref_idx"])
                if pps["list_mod"] and total > 1 and rng.random() < 0.5:
                    pp["mods"][l] = [rng.randrange(total) for _ in range(pp["num_ref_idx"][l])]
                    self.stats["list_mod"] += 1
            if pic.kind == "B":
                pp["col_l0"] = rng.random() < 0.5
            pp["col_idx"] = rng.randrange(pp["num_ref_idx"][0 if pp["col_l0"] else 1])
            pp["cabac_init"] = pps["cabac_init_present"] and rng.random() < 0.5
            if pic.lt:
                self.collocated_long_term(pic)
            self.stats[f"collocated_l{0 if pp['col_l0'] else 1}"] += 1
            if pp["cabac_init"]:
                self.stats["cabac_init_flag"] += 1
        units = []
        self.slice_addr = 0
        self.ds_state = None
        self.wpp_state = None
        if pps["tiles"]:
            for s, end, dep in self.tile_segments(pps):
                units.append(self.segment(s, end, dep, s == 0))
            return units
        # the slice segments: (first CTB, independent?)
        starts = [0]
        if f["slices"] > 1:
            cands = list(range(1, n_ctb))
            if pps["wpp"]:
                rows = [r * self.ctb_w for r in range(1, self.ctb_h)]
                mids = [a for a in cands if a % self.ctb_w and rng.random() < f["mid_row"]]
                cands = rows + mids
            starts += sorted(rng.sample(cands, min(len(cands), f["slices"] - 1)))
            if pps["wpp"]:
                # a segment starting inside a row ends in that row
                fixed = []
                for s in starts:
                    fixed.append(s)
                    if s % self.ctb_w and (s // self.ctb_w + 1) * self.ctb_w < n_ctb:
                        fixed.append((s // self.ctb_w + 1) * self.ctb_w)
                starts = sorted(set(fixed))
        segs = []
        mid_row_slice = False
        for k, s in enumerate(starts):
            end = starts[k + 1] if k + 1 < len(starts) else n_ctb
            dep = k > 0 and pps["dependent"] and rng.random() < max(f["dependent"], 0.3)
            if pps["wpp"] and s % self.ctb_w == 0 and mid_row_slice:
                dep = False                  # a slice begun inside a row ends in it
            if not dep:
                mid_row_slice = s % self.ctb_w != 0
            segs.append((s, end, dep))
        for s, end, dep in segs:
            units.append(self.segment(s, end, dep, s == 0))
        return units

    def layout_tiles(self, pps: dict) -> None:
        """CtbAddrRsToTs, CtbAddrTsToRs, TileId (by raster address), each CTB
        column's tile's first column and each tile's tile-scan span (6.5.1)."""
        cols = self.col_w if pps["tiles"] else [self.ctb_w]
        rows = self.row_h if pps["tiles"] else [self.ctb_h]
        n = self.ctb_w * self.ctb_h
        self.ts2rs, self.rs2ts, self.tile_id = [0] * n, [0] * n, [0] * n
        self.tile_x0, self.tile_spans = [0] * self.ctb_w, []
        ts = y0 = 0
        for h in rows:
            x0 = 0
            for w in cols:
                self.tile_spans.append((ts, ts + w * h))
                for x in range(x0, x0 + w):
                    self.tile_x0[x] = x0
                for y in range(y0, y0 + h):
                    for x in range(x0, x0 + w):
                        rs = y * self.ctb_w + x
                        self.ts2rs[ts], self.rs2ts[rs] = rs, ts
                        self.tile_id[rs] = len(self.tile_spans) - 1
                        ts += 1
                x0 += w
            y0 += h

    def tile_segments(self, pps: dict) -> list[tuple[int, int, bool]]:
        """(first CTB, end, dependent?) in tile scan of each slice segment of a
        picture with tiles, as 6.3.1 allows: slices of several whole tiles
        (split into dependent segments at tile starts), and tiles of several
        slices and dependent segments starting inside the tile (with WPP, at
        a CTB row of the tile alone)."""
        f, rng = self.f, self.rng
        spans, segs, t = self.tile_spans, [], 0
        while t < len(spans):
            if rng.random() < f["multi_tile"] and t + 1 < len(spans):
                k = rng.randint(2, len(spans) - t)
                for j in range(t, t + k):
                    if j == t or pps["dependent"] and rng.random() < 0.5:
                        segs.append((spans[j][0], spans[j][1], j > t))
                    else:
                        segs[-1] = (segs[-1][0], spans[j][1], segs[-1][2])
                self.stats["multi_tile_slice"] += 1
                t += k
                continue
            a, b = spans[t]
            cuts: list[int] = []
            if b - a > 1 and rng.random() < f["split_tile"]:
                places = range(a + 1, b)
                if pps["wpp"]:
                    places = [c for c in places if self.ts2rs[c] % self.ctb_w
                              == self.tile_x0[self.ts2rs[c] % self.ctb_w]]
                cuts = sorted(rng.sample(list(places), min(len(places), rng.randint(1, 3))))
            for i, s0 in enumerate([a] + cuts):
                e0 = cuts[i] if i < len(cuts) else b
                dep = i > 0 and pps["dependent"] and rng.random() < 0.5
                segs.append((s0, e0, dep))
                if i:
                    self.stats["mid_tile_segment"] += 1
            t += 1
        return segs

    def ref_lists(self, pic: Pic) -> list[list[tuple[int, bool]]]:
        """RefPicList0 / 1 (8.3.4) as (POC, long-term?) pairs."""
        pp = self.pic_params
        before = [pic.poc + d for d, u in pic.rps if d < 0 and u]
        after = [pic.poc + d for d, u in pic.rps if d > 0 and u]
        lt = [poc for poc, u in pp.get("lt_order", ()) if u]
        out = []
        for l in range(2 if pic.kind == "B" else 1):
            seq = [(q, False) for q in (before + after if l == 0 else after + before)]
            seq += [(q, True) for q in lt]
            n = max(pp["num_ref_idx"][l], len(seq))
            temp = [seq[i % len(seq)] for i in range(n)]
            mods = pp["mods"][l]
            out.append([temp[mods[i] if mods else i] for i in range(pp["num_ref_idx"][l])])
        return out

    def lt_coding(self, pic: Pic) -> None:
        """How the picture's long-term entries are coded: from the SPS's
        candidates or in the slice header, with delta_poc_msb_present_flag
        where the LSBs alone would name more than one picture (or at
        random); the SPS group, then the slice's, each in increasing
        DeltaPocMsbCycleLt, so that its running sum never goes down; the
        first of a group has the MSBs where a later one has (FFmpeg carries
        the sum over from the SPS group otherwise)."""
        rng, pp = self.rng, self.pic_params
        mask = (1 << self.log2_max_poc_lsb) - 1
        k = self.pics.index(pic)
        entries = []
        for poc, used in pic.lt:
            sps = (poc & mask, used) in self.lt_sps and rng.random() < 0.7
            others = {q.poc & mask for q in self.pics[:k] if q.cvs == pic.cvs and q.poc != poc}
            msb = (poc & mask) in others or (pic.poc & mask) == (poc & mask) or rng.random() < 0.5
            cycle = ((pic.poc - (pic.poc & mask)) - (poc - (poc & mask))) >> self.log2_max_poc_lsb
            entries.append((not sps, cycle, poc, used, msb))
        entries.sort()
        for slice_coded in (False, True):
            g = [i for i, e in enumerate(entries) if e[0] == slice_coded]
            if any(entries[i][4] for i in g[1:]):
                e = entries[g[0]]
                entries[g[0]] = e[:4] + (True,)
        pp["lt_entries"] = entries
        pp["lt_order"] = [(e[2], e[3]) for e in entries]

    def collocated_long_term(self, pic: Pic) -> None:
        """With TMVP, now and then the collocated picture a long-term one."""
        rng, pp = self.rng, self.pic_params
        if not pp["tmvp"]:
            return
        lists = self.ref_lists(pic)
        at = [(l, i) for l, refs in enumerate(lists) for i, (_, lt) in enumerate(refs) if lt]
        if at and rng.random() < 0.6:
            l, i = rng.choice(at)
            pp["col_l0"], pp["col_idx"] = l == 0, i
            self.stats["lt_collocated"] += 1

    def segment(self, first: int, end: int, dependent: bool, first_in_pic: bool) -> bytes:
        """A slice segment over CTBs first to end - 1 in tile scan."""
        f, rng, pic, pps = self.f, self.rng, self.pic, self.cur_pps
        pp = self.pic_params
        if not dependent:
            self.slice_addr = self.ts2rs[first]
            sh = {"type": pic.kind}
            sh["qp"] = rng.randint(*f["qp"])
            assert -self.qpbd <= sh["qp"] <= 51, "SliceQpY out of range"
            if sh["qp"] < 0:
                self.stats["qp_negative"] += 1
            sh["sao_luma"] = f["sao"] and rng.random() < 0.8
            sh["sao_chroma"] = f["sao"] and rng.random() < 0.7
            # the deblocking override: one a picture, as encoders write it
            # (FFmpeg's CTB-wise filter applies slices' differing parameters
            # otherwise than 8.7.2 at their boundaries)
            if first_in_pic:
                mode = rng.choice(f["deblock"])
                self.pic_deblock = (pps["override"] and rng.random() < 0.6, mode,
                                    rng.randint(-6, 6), rng.randint(-6, 6))
            override, mode, beta, tc = self.pic_deblock
            sh["override"] = override
            sh["deblock_disabled"] = pps["deblock_disabled"]
            sh["beta"], sh["tc"] = pps["beta"], pps["tc"]
            if sh["override"]:
                sh["deblock_disabled"] = mode == "off"
                if mode == "offsets":
                    sh["beta"], sh["tc"] = beta, tc
                self.stats[f"deblock_{mode}"] += 1
            sh["lf_across"] = pps["lf_across"]
            if pps["lf_across"] and (sh["sao_luma"] or sh["sao_chroma"]
                                     or not sh["deblock_disabled"]):
                # one value a picture where SAO is on: FFmpeg's SAO reads the
                # current slice's flag on every side, the standard the later one's
                choices = f["lf_across"] if isinstance(f["lf_across"], tuple) else (f["lf_across"],)
                if not f["sao"] or not hasattr(self, "pic_lf") or self.pic_lf[0] is not pic:
                    self.pic_lf = (pic, bool(rng.choice(choices)))
                sh["lf_across"] = self.pic_lf[1] if f["sao"] else bool(rng.choice(choices))
                self.stats[f"lf_across{int(sh['lf_across'])}"] += 1
            sh["max_merge"] = rng.randint(*f["max_merge"])
            sh["cb_qp"] = rng.randint(-4, 4) if pps["slice_chroma"] else 0
            sh["cr_qp"] = rng.randint(-4, 4) if pps["slice_chroma"] else 0
            sh["mvd_l1_zero"] = pic.kind == "B" and rng.random() < f["mvd_l1_zero"]
            self.sh = sh
        sh = self.sh
        self.ctx_first = first
        self.end = end
        # the slice data, substream by substream
        bw = BitWriter()
        cab = Cabac(bw)
        self.cab = cab
        init_type = 0 if pic.kind == "I" else (1 if pic.kind == "P" else 2)
        if pic.kind != "I" and pp.get("cabac_init"):
            init_type = 3 - init_type
        self.init_type = init_type
        def tile_start(ts):
            return ts == 0 or self.tile_id[self.ts2rs[ts]] != self.tile_id[self.ts2rs[ts - 1]]

        def row_start(rs):
            return rs % self.ctb_w == self.tile_x0[rs % self.ctb_w]

        if not dependent or tile_start(first):
            cab.init(init_type, sh["qp"])
        elif pps["wpp"] and row_start(self.ts2rs[first]):
            self.wpp_sync(self.ts2rs[first])
        else:
            cab.load(self.ds_state)
        substreams = []
        ts = first
        while ts < end:
            ctb = self.ts2rs[ts]
            rx, ry = ctb % self.ctb_w, ctb // self.ctb_w
            self.ctb_slice[ctb] = self.slice_addr
            self.ctb_addr = ctb
            if sh["sao_luma"] or sh["sao_chroma"]:
                self.sao(rx, ry)
            self.quadtree(rx << self.log2_ctb, ry << self.log2_ctb, self.log2_ctb, 0)
            last = ts + 1 == end
            if pps["wpp"] and rx == self.tile_x0[rx] + 1:
                self.wpp_state = cab.save()
            cab.terminate(int(last))
            ts += 1
            if last:
                break
            new_tile = tile_start(ts)
            if new_tile or pps["wpp"] and row_start(self.ts2rs[ts]):
                cab.terminate(1)
                substreams.append(bw.data())
                bw = BitWriter()
                cab.bw = bw
                cab.start()
                if new_tile:
                    cab.init(init_type, sh["qp"])
                    self.stats["tile_boundary_sync"] += 1
                    if pps["wpp"]:
                        self.stats["tile_wpp"] += 1
                else:
                    self.wpp_sync(self.ts2rs[ts])
                    self.stats["wpp_row"] += 1
        substreams.append(bw.data())
        if pps["dependent"]:
            self.ds_state = cab.save()
        if dependent:
            self.stats["dependent"] += 1
            if pps["tiles"] and tile_start(first):
                self.stats["dependent_at_tile"] += 1
        rs = self.ts2rs[first]
        if not row_start(rs) and not first_in_pic:
            self.stats["mid_row_slice"] += 1
        # the header, its entry points counted over the escaped bytes
        sizes = [len(s) for s in substreams]
        for _ in range(8):
            head = self.header(first, dependent, first_in_pic, sizes[:-1])
            kind_tid = bytes([pic.nal << 1, pic.tid + 1])
            out, zeros = escape(head)
            escaped = []
            for s in substreams:
                e, zeros = escape(s, zeros)
                escaped.append(len(e))
            if escaped[:-1] == sizes[:-1]:
                break
            sizes = escaped
        else:
            raise RuntimeError("entry points did not settle")
        body = head + b"".join(substreams)
        return kind_tid + escape(body)[0]

    def wpp_sync(self, ctb: int) -> None:
        up_right = ctb - self.ctb_w + 1
        if ctb % self.ctb_w + 1 < self.ctb_w and ctb >= self.ctb_w \
                and self.tile_id[up_right] == self.tile_id[ctb] \
                and self.ctb_slice[up_right] == self.slice_addr and self.wpp_state is not None:
            self.cab.load(self.wpp_state)
            self.stats["wpp_sync"] += 1
        else:
            self.cab.init(self.init_type, self.sh["qp"])

    def header(self, first: int, dependent: bool, first_in_pic: bool, entries) -> bytes:
        f, rng, pic, pps, sh, pp = self.f, self.rng, self.pic, self.cur_pps, self.sh, \
            self.pic_params
        r = random.Random(hash((pic.poc, first)) & 0xFFFF)   # the same choices each pass
        bw = BitWriter()
        bw.u(1, first_in_pic)
        irap = 16 <= pic.nal <= 23
        if irap:
            bw.u(1, pic.no_output_prior)
            if pic.no_output_prior:
                self.stats["no_output_of_prior_pics"] += 1
        bw.ue(pps["id"])
        if not first_in_pic:
            if pps["dependent"]:
                bw.u(1, dependent)
            n = self.ctb_w * self.ctb_h
            bw.u((n - 1).bit_length(), self.ts2rs[first])
        if not dependent:
            for _ in range(pps["extra_bits"]):
                bw.u(1, r.random() < 0.5)
            bw.ue({"B": 0, "P": 1, "I": 2}[pic.kind])
            if pps["output_flag"]:
                bw.u(1, pic.output)
                if not pic.output:
                    self.stats["pic_output_flag0"] += 1
            if not pic.idr:
                bw.u(self.log2_max_poc_lsb, pic.poc % (1 << self.log2_max_poc_lsb))
                if pic.rps in self.sps_sets and r.random() < 0.7:
                    bw.u(1, 1)
                    if len(self.sps_sets) > 1:
                        bw.u((len(self.sps_sets) - 1).bit_length(), self.sps_sets.index(pic.rps))
                    self.stats["sps_rps"] += 1
                else:
                    bw.u(1, 0)
                    saved = self.rng
                    self.rng = r
                    self.rps_code(bw, len(self.sps_sets), len(self.sps_sets), pic.rps,
                                  self.sps_sets)
                    self.rng = saved
                if f["long_term"]:
                    self.lt_header(bw)
                if f["tmvp"]:
                    bw.u(1, pp["tmvp"])
            if f["sao"]:
                bw.u(1, sh["sao_luma"])
                bw.u(1, sh["sao_chroma"])
            if pic.kind != "I":
                override = pp["num_ref_idx"][0] != pps["num_ref_idx"][0] or (
                    pic.kind == "B" and pp["num_ref_idx"][1] != pps["num_ref_idx"][1])
                bw.u(1, override)
                if override:
                    bw.ue(pp["num_ref_idx"][0] - 1)
                    if pic.kind == "B":
                        bw.ue(pp["num_ref_idx"][1] - 1)
                total = sum(u for _, u in pic.rps) + sum(u for _, u in pic.lt)
                if pps["list_mod"] and total > 1:
                    for l in range(2 if pic.kind == "B" else 1):
                        bw.u(1, pp["mods"][l] is not None)
                        if pp["mods"][l] is not None:
                            for e in pp["mods"][l]:
                                bw.u((total - 1).bit_length(), e)
                if pic.kind == "B":
                    bw.u(1, sh["mvd_l1_zero"])
                if pps["cabac_init_present"]:
                    bw.u(1, pp["cabac_init"])
                if pp["tmvp"]:
                    if pic.kind == "B":
                        bw.u(1, pp["col_l0"])
                    if pp["num_ref_idx"][0 if pp["col_l0"] else 1] > 1:
                        bw.ue(pp["col_idx"])
                if (pps["weighted_pred"] and pic.kind == "P") or (
                        pps["weighted_bipred"] and pic.kind == "B"):
                    self.weights(bw, r)
                bw.ue(5 - sh["max_merge"])
            bw.se(sh["qp"] - pps["init_qp"])
            if pps["slice_chroma"]:
                bw.se(sh["cb_qp"])
                bw.se(sh["cr_qp"])
            if pps["override"]:
                bw.u(1, sh["override"])
                if sh["override"]:
                    bw.u(1, sh["deblock_disabled"])
                    if not sh["deblock_disabled"]:
                        bw.se(sh["beta"])
                        bw.se(sh["tc"])
            if pps["lf_across"] and (sh["sao_luma"] or sh["sao_chroma"]
                                     or not sh["deblock_disabled"]):
                bw.u(1, sh["lf_across"])
        if pps["wpp"] or pps["tiles"]:
            bw.ue(len(entries))
            if entries:
                past = 1 << 16 if f["corrupt"] == "entry_points" else 0
                bits = max(max(e - 1 + past for e in entries).bit_length(), 1)
                bw.ue(bits - 1)
                for e in entries:
                    bw.u(bits, e - 1 + past)
        if pps["header_ext"]:
            n = r.randint(0, 3)
            bw.ue(n)
            for _ in range(n):
                bw.u(8, r.randint(0, 255))
        bw.u(1, 1)
        bw.align_zero()
        return bw.data()

    def lt_header(self, bw: BitWriter) -> None:
        """The slice header's long-term entries (7.3.6.1), as `lt_coding`
        chose them."""
        entries = self.pic_params.get("lt_entries", [])
        mask = (1 << self.log2_max_poc_lsb) - 1
        n_sps = sum(1 for e in entries if not e[0])
        if self.lt_sps:
            bw.ue(n_sps)
        bw.ue(len(entries) - n_sps)
        running = 0
        for i, (slice_coded, cycle, poc, used, msb) in enumerate(entries):
            if i in (0, n_sps):
                running = 0
            corrupt = self.f["corrupt"]
            if not slice_coded:
                idx = self.lt_sps.index((poc & mask, used))
                if len(self.lt_sps) > 1:
                    bw.u((len(self.lt_sps) - 1).bit_length(),
                         len(self.lt_sps) if corrupt == "lt_idx_sps" else idx)
                self.stats["lt_sps"] += 1
            else:
                bw.u(self.log2_max_poc_lsb, poc & mask)
                bw.u(1, used)
                self.stats["lt_slice"] += 1
            bw.u(1, msb)
            if msb:
                bw.ue(cycle - running + 4 * (corrupt == "lt_missing"))
                running = cycle
            self.stats["lt_msb_present" if msb else "lt_msb_absent"] += 1
            self.stats["lt_used" if used else "lt_unused"] += 1
            if msb and cycle:
                self.stats["lt_msb_cycle"] += 1

    def weights(self, bw: BitWriter, r: random.Random) -> None:
        pic, pp = self.pic, self.pic_params
        denom = r.randint(0, 6)
        bw.ue(denom)
        cdenom = r.randint(0, 6)
        bw.se(cdenom - denom)
        for l in range(2 if pic.kind == "B" else 1):
            n = pp["num_ref_idx"][l]
            lf = [r.random() < 0.6 for _ in range(n)]
            cf = [r.random() < 0.5 for _ in range(n)]
            for v in lf:
                bw.u(1, v)
            for v in cf:
                bw.u(1, v)
            for i in range(n):
                if lf[i]:
                    bw.se(r.randint(-12, 12))
                    bw.se(r.randint(-20, 20))
                if cf[i]:
                    for _ in range(2):
                        bw.se(r.randint(-12, 12))
                        bw.se(r.randint(-60, 60))
            self.stats[f"weighted_l{l}"] += 1

    # ── CTU syntax ──
    def avail(self, xn: int, yn: int) -> bool:
        """The left / above neighbour (xn, yn) is in the picture, the slice and
        the tile."""
        if xn < 0 or yn < 0 or xn >= self.W or yn >= self.H:
            return False
        ctb = (yn >> self.log2_ctb) * self.ctb_w + (xn >> self.log2_ctb)
        return self.ctb_slice[ctb] == self.slice_addr and \
            self.tile_id[ctb] == self.tile_id[self.ctb_addr]

    def u4(self, x: int, y: int) -> int:
        return (y >> 2) * self.w4 + (x >> 2)

    def fill(self, m: list, x0: int, y0: int, w: int, h: int, v: int) -> None:
        for j in range(y0 >> 2, (y0 + h) >> 2):
            base = j * self.w4
            for i in range(x0 >> 2, (x0 + w) >> 2):
                m[base + i] = v

    def sao(self, rx: int, ry: int) -> None:
        cab, rng, sh = self.cab, self.rng, self.sh
        addr, tile = self.ctb_addr, self.tile_id
        if rx > 0 and addr - 1 >= self.slice_addr and tile[addr - 1] == tile[addr]:
            merge = rng.random() < 0.3
            cab.bin(C["SAO_MERGE"], merge)
            if merge:
                self.stats["sao_merge_left"] += 1
                return
        up = addr - self.ctb_w
        if ry > 0 and up >= self.slice_addr and tile[up] == tile[addr]:
            merge = rng.random() < 0.3
            cab.bin(C["SAO_MERGE"], merge)
            if merge:
                self.stats["sao_merge_up"] += 1
                return
        kind = 0
        for c in range(3):
            if (c == 0 and not sh["sao_luma"]) or (c > 0 and not sh["sao_chroma"]):
                continue
            if c < 2:
                kind = rng.choice((0, 1, 2))
                cab.bin(C["SAO_TYPE"], kind > 0)
                if kind:
                    cab.bypass(kind == 2)
            if not kind:
                continue
            cmax = (1 << (min(self.bd, 10) - 5)) - 1
            choices = (0, 1, 2, 3, 7) if cmax == 7 else tuple(
                v for v in (0, 1, 3, 7, 8, 15, 31) if v <= cmax)
            offsets = [rng.choice(choices) if rng.random() < 0.7 else 0 for _ in range(4)]
            if max(offsets) > 7:
                self.stats["sao_offset_gt7"] += 1
            for v in offsets:
                for _ in range(v):
                    cab.bypass(1)
                if v < cmax:
                    cab.bypass(0)
            if kind == 1:
                for v in offsets:
                    if v:
                        cab.bypass(rng.random() < 0.5)
                cab.bits(rng.randrange(32), 5)
                self.stats["sao_band"] += 1
            else:
                if c < 2:
                    cab.bits(rng.randrange(4), 2)
                self.stats["sao_edge"] += 1

    def quadtree(self, x0: int, y0: int, log2: int, depth: int) -> None:
        f, cab, rng = self.f, self.cab, self.rng
        size = 1 << log2
        if x0 + size <= self.W and y0 + size <= self.H and log2 > self.log2_min_cb:
            split = rng.random() < f["split"] * (1.2 if log2 >= 5 else 0.8)
            inc = (self.avail(x0 - 1, y0) and self.depth[self.u4(x0 - 1, y0)] > depth) + \
                (self.avail(x0, y0 - 1) and self.depth[self.u4(x0, y0 - 1)] > depth)
            cab.bin(C["SPLIT_CU"] + inc, split)
        else:
            split = log2 > self.log2_min_cb
        pps = self.cur_pps
        if pps["cu_qp_delta"] and log2 >= self.log2_ctb - pps["qp_depth"]:
            self.qp_coded = False
        if split:
            h = size >> 1
            for dx, dy in ((0, 0), (h, 0), (0, h), (h, h)):
                if x0 + dx < self.W and y0 + dy < self.H:
                    self.quadtree(x0 + dx, y0 + dy, log2 - 1, depth + 1)
        else:
            self.fill(self.depth, x0, y0, size, size, depth)
            self.coding_unit(x0, y0, log2)

    def coding_unit(self, x0: int, y0: int, log2: int) -> None:
        f, cab, rng, pic = self.f, self.cab, self.rng, self.pic
        size = 1 << log2
        self.cu = (x0, y0, log2)
        self.cu_bypass = False
        if self.cur_pps["bypass"]:
            self.cu_bypass = rng.random() < f["bypass"]
            cab.bin(C["TRANSQUANT_BYPASS"], self.cu_bypass)
            if self.cu_bypass:
                self.stats["bypass_cu"] += 1
        skip = False
        if pic.kind != "I":
            skip = rng.random() < f["skip"]
            inc = (self.avail(x0 - 1, y0) and self.skipm[self.u4(x0 - 1, y0)]) + \
                (self.avail(x0, y0 - 1) and self.skipm[self.u4(x0, y0 - 1)])
            cab.bin(C["SKIP"] + inc, skip)
        self.fill(self.skipm, x0, y0, size, size, int(skip))
        self.cu_skip = skip
        if skip:
            self.cu_intra = False
            self.fill(self.intram, x0, y0, size, size, 0)
            self.stats["skip"] += 1
            self.prediction_unit(x0, y0, size, size, 0, PART_2Nx2N)
            return
        intra = pic.kind == "I" or rng.random() < f["intra_in_inter"]
        if pic.kind != "I":
            cab.bin(C["PRED_MODE"], intra)
            if intra:
                self.stats["intra_in_inter"] += 1
        self.cu_intra = intra
        self.fill(self.intram, x0, y0, size, size, int(intra))
        part = PART_2Nx2N
        min_cb = log2 == self.log2_min_cb
        if intra:
            if min_cb:
                part = PART_NxN if rng.random() < 0.4 else PART_2Nx2N
                cab.bin(C["PART_MODE"], part == PART_2Nx2N)
                if part == PART_NxN:
                    self.stats["intra_nxn"] += 1
        else:
            choices = [PART_2Nx2N, PART_2NxN, PART_Nx2N]
            if min_cb and log2 > 3:
                choices.append(PART_NxN)
            if not min_cb and f["amp"]:
                choices += [PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N]
            part = rng.choice(choices)
            cab.bin(C["PART_MODE"], part == PART_2Nx2N)
            if part != PART_2Nx2N:
                if min_cb:
                    cab.bin(C["PART_MODE"] + 1, part == PART_2NxN)
                    if part != PART_2NxN and log2 > 3:
                        cab.bin(C["PART_MODE"] + 2, part == PART_Nx2N)
                elif not f["amp"]:
                    cab.bin(C["PART_MODE"] + 1, part == PART_2NxN)
                else:
                    hor = part in (PART_2NxN, PART_2NxnU, PART_2NxnD)
                    cab.bin(C["PART_MODE"] + 1, hor)
                    sym = part in (PART_2NxN, PART_Nx2N)
                    cab.bin(C["PART_MODE"] + 3, sym)
                    if not sym:
                        cab.bypass(part in (PART_2NxnD, PART_nRx2N))
            self.stats[f"part{part}"] += 1
        self.part = part
        if intra and part == PART_2Nx2N and f["pcm"] and \
                self.pcm_sizes[0] <= log2 <= self.pcm_sizes[1]:
            pcm = rng.random() < f["pcm"]
            cab.terminate(int(pcm))                  # pcm_flag
            if pcm:
                self.pcm_sample(x0, y0, log2)
                return
        if intra:
            self.intra_modes(x0, y0, size, part)
        else:
            h, q = size // 2, size // 4
            pus = {PART_2Nx2N: [(0, 0, size, size)],
                   PART_2NxN: [(0, 0, size, h), (0, h, size, h)],
                   PART_Nx2N: [(0, 0, h, size), (h, 0, h, size)],
                   PART_NxN: [(0, 0, h, h), (h, 0, h, h), (0, h, h, h), (h, h, h, h)],
                   PART_2NxnU: [(0, 0, size, q), (0, q, size, size - q)],
                   PART_2NxnD: [(0, 0, size, size - q), (0, size - q, size, q)],
                   PART_nLx2N: [(0, 0, q, size), (q, 0, size - q, size)],
                   PART_nRx2N: [(0, 0, size - q, size), (size - q, 0, q, size)]}[part]
            self.merge0 = False
            for k, (dx, dy, w, hh) in enumerate(pus):
                self.prediction_unit(x0 + dx, y0 + dy, w, hh, k, part)
        root = True
        if not intra and not (part == PART_2Nx2N and self.merge0):
            root = rng.random() < f["root_cbf"]
            cab.bin(C["RQT_ROOT_CBF"], root)
        if root:
            split = intra and part == PART_NxN
            max_depth = f["depth_intra"] + split if intra else f["depth_inter"]
            self.transform_tree(x0, y0, x0, y0, log2, 0, 0, False, False, max_depth, split)

    def pcm_sample(self, x0: int, y0: int, log2: int) -> None:
        """pcm_sample() (7.3.8.7) of a CU: after pcm_flag's flush and the
        pcm_alignment_zero_bits, random samples of the PCM depths, then the
        arithmetic coder starts again (9.3.2.5)."""
        cab, rng = self.cab, self.rng
        n = 1 << log2
        for c, count in ((0, n * n), (1, n * n // 2)):
            depth = self.pcm_depths[c]
            for _ in range(count):
                cab.bw.u(depth, rng.getrandbits(depth))
        cab.start()
        self.fill(self.ipm, x0, y0, n, n, 1)             # INTRA_DC to the neighbours' MPMs
        self.stats[f"pcm{n}"] += 1
        if self.pcm_lf_disabled:
            self.stats["pcm_lf_disabled"] += 1
        if self.cu_bypass:
            self.stats["pcm_bypass"] += 1

    def intra_modes(self, x0: int, y0: int, size: int, part: int) -> None:
        cab, rng = self.cab, self.rng
        n = 4 if part == PART_NxN else 1
        pb = size // 2 if n == 4 else size
        coded = []
        for i in range(n):
            xp, yp = x0 + (i & 1) * pb, y0 + (i >> 1) * pb
            ca = cb = 1
            if self.avail(xp - 1, yp) and self.intram[self.u4(xp - 1, yp)]:
                ca = self.ipm[self.u4(xp - 1, yp)]
            if self.avail(xp, yp - 1) and self.intram[self.u4(xp, yp - 1)] and \
                    yp - 1 >= (yp >> self.log2_ctb) << self.log2_ctb:
                cb = self.ipm[self.u4(xp, yp - 1)]
            if ca == cb:
                cand = [0, 1, 26] if ca < 2 else [ca, 2 + (ca + 29) % 32, 2 + (ca - 2 + 1) % 32]
            else:
                third = 0 if ca and cb else (1 if ca != 1 and cb != 1 else 26)
                cand = [ca, cb, third]
            mode = rng.choice(cand) if rng.random() < 0.4 else rng.randrange(35)
            self.fill(self.ipm, xp, yp, pb, pb, mode)
            coded.append((mode, cand))
            self.stats[f"intra_mode{mode}"] += 1
        for mode, cand in coded:
            cab.bin(C["PREV_INTRA_LUMA"], mode in cand)
        for mode, cand in coded:
            if mode in cand:
                idx = cand.index(mode)
                cab.bypass(idx > 0)
                if idx > 0:
                    cab.bypass(idx > 1)
            else:
                rem = mode - sum(1 for c in cand if c < mode)
                cab.bits(rem, 5)
        cm = rng.randrange(5)
        cab.bin(C["CHROMA_PRED"], cm != 4)
        if cm != 4:
            cab.bits(cm, 2)
        luma = coded[0][0]
        self.chroma_mode = luma if cm == 4 else ([0, 26, 10, 1][cm] if [0, 26, 10, 1][cm] != luma
                                                 else 34)
        self.stats[f"chroma_mode{cm}"] += 1

    def prediction_unit(self, x0: int, y0: int, w: int, h: int, k: int, part: int) -> None:
        f, cab, rng, pic, sh, pp = self.f, self.cab, self.rng, self.pic, self.sh, self.pic_params
        merge = self.cu_skip
        if not self.cu_skip:
            merge = rng.random() < f["merge"]
            cab.bin(C["MERGE_FLAG"], merge)
        if k == 0:
            self.merge0 = merge
        if merge:
            if sh["max_merge"] > 1:
                idx = rng.randrange(sh["max_merge"])
                cab.bin(C["MERGE_IDX"], idx > 0)
                for j in range(1, idx + 1):
                    if j < sh["max_merge"] - 1:
                        cab.bypass(j < idx)
                    if j == idx:
                        break
                self.stats[f"merge_idx{idx}"] += 1
            if w + h == 12:
                self.stats["merge_8x4"] += 1
            return
        idc = 0
        if pic.kind == "B":
            idc = rng.choice((0, 1, 2)) if w + h != 12 else rng.choice((0, 1))
            if w + h != 12:
                depth = self.depth[self.u4(x0, y0)]
                cab.bin(C["INTER_PRED_IDC"] + depth, idc == 2)
            if idc != 2:
                cab.bin(C["INTER_PRED_IDC"] + 4, idc)
            self.stats[f"inter_pred_idc{idc}"] += 1
        for l in range(2):
            if (l == 0 and idc == 1) or (l == 1 and idc == 0):
                continue
            n = pp["num_ref_idx"][l]
            if n > 1:
                r = rng.randrange(n)
                base = C["REF_IDX_L0"]          # both lists share the contexts
                for j in range(min(r + 1, n - 1)):
                    b = int(j < r)
                    if j < 2:
                        cab.bin(base + j, b)
                    else:
                        cab.bypass(b)
                self.stats[f"ref_idx{r}"] += 1
            if l == 1 and sh["mvd_l1_zero"] and idc == 2:
                self.stats["mvd_l1_zero"] += 1
            else:
                self.mvd()
            cab.bin(C["MVP_FLAG"], rng.random() < 0.5)

    def mvd(self) -> None:
        cab, rng = self.cab, self.rng
        v = []
        for _ in range(2):
            m = self.f["mvd_max"]
            a = 0 if rng.random() < 0.3 or not m else (
                rng.randint(1, m) if rng.random() < 0.9 else rng.randint(m, 16 * m))
            v.append(a * rng.choice((-1, 1)))
        cab.bin(C["MVD_GREATER0"], v[0] != 0)
        cab.bin(C["MVD_GREATER0"], v[1] != 0)
        if v[0]:
            cab.bin(C["MVD_GREATER1"] + 1, abs(v[0]) > 1)
        if v[1]:
            cab.bin(C["MVD_GREATER1"] + 1, abs(v[1]) > 1)
        for a in v:
            if a:
                if abs(a) > 1:
                    eg(cab, abs(a) - 2, 1)
                cab.bypass(a < 0)

    def transform_tree(self, x0, y0, xb, yb, log2, depth, blk, parent_cb, parent_cr, max_depth,
                       intra_split) -> None:
        f, cab, rng = self.f, self.cab, self.rng
        if log2 <= self.log2_max_tb and log2 > self.log2_min_tb and depth < max_depth and \
                not (intra_split and depth == 0):
            split = rng.random() < f["tsplit"]
            cab.bin(C["SPLIT_TRANSFORM"] + 5 - log2, split)
        else:
            inter_split = f["depth_inter"] == 0 and not self.cu_intra and \
                self.part != PART_2Nx2N and depth == 0
            split = log2 > self.log2_max_tb or (intra_split and depth == 0) or inter_split
        cbf_cb = cbf_cr = False
        if log2 > 2:
            if depth == 0 or parent_cb:
                cbf_cb = rng.random() < f["cbf"] * 0.7
                cab.bin(C["CBF_CHROMA"] + depth, cbf_cb)
            if depth == 0 or parent_cr:
                cbf_cr = rng.random() < f["cbf"] * 0.7
                cab.bin(C["CBF_CHROMA"] + depth, cbf_cr)
        else:
            cbf_cb, cbf_cr = parent_cb, parent_cr
        if split:
            h = 1 << (log2 - 1)
            for k, (dx, dy) in enumerate(((0, 0), (h, 0), (0, h), (h, h))):
                self.transform_tree(x0 + dx, y0 + dy, x0, y0, log2 - 1, depth + 1, k, cbf_cb,
                                    cbf_cr, max_depth, intra_split)
            return
        cbf_l = True
        if self.cu_intra or depth != 0 or cbf_cb or cbf_cr:
            cbf_l = rng.random() < f["cbf"]
            cab.bin(C["CBF_LUMA"] + (1 if depth == 0 else 0), cbf_l)
        pps = self.cur_pps
        if (cbf_l or cbf_cb or cbf_cr) and pps["cu_qp_delta"] and not self.qp_coded:
            d = 0 if rng.random() < 0.3 else rng.randint(-f["qp_delta"], f["qp_delta"])
            if rng.random() < 0.03:
                d = rng.choice((-26 - self.qpbd // 2, 25 + self.qpbd // 2))
                self.stats["cu_qp_delta_extreme"] += 1
            a = abs(d)
            cab.bin(C["CU_QP_DELTA"], a > 0)
            for j in range(1, min(a, 5) + 1):
                if j < 5:
                    cab.bin(C["CU_QP_DELTA"] + 1, j < a)
            if a >= 5:
                eg(cab, a - 5, 0)
            if a:
                cab.bypass(d < 0)
            self.qp_coded = True
            self.stats["cu_qp_delta"] += 1
        if cbf_l:
            self.residual(x0, y0, log2, 0)
        if log2 > 2:
            if cbf_cb:
                self.residual(x0 >> 1, y0 >> 1, log2 - 1, 1)
            if cbf_cr:
                self.residual(x0 >> 1, y0 >> 1, log2 - 1, 2)
        elif blk == 3:
            if cbf_cb:
                self.residual(xb >> 1, yb >> 1, 2, 1)
            if cbf_cr:
                self.residual(xb >> 1, yb >> 1, 2, 2)

    def residual(self, x0: int, y0: int, log2: int, c: int) -> None:
        f, cab, rng = self.f, self.cab, self.rng
        n = 1 << log2
        pps = self.cur_pps
        if self.cu_bypass:
            self.stats["bypass_residual"] += 1
        if pps["transform_skip"] and log2 == 2 and not self.cu_bypass:
            ts = rng.random() < 0.3
            cab.bin(C["TRANSFORM_SKIP"] + (1 if c else 0), ts)
            if ts:
                self.stats["transform_skip"] += 1
        scan_idx = 0
        if self.cu_intra and (log2 == 2 or (log2 == 3 and c == 0)):
            mode = self.ipm[self.u4(x0, y0)] if c == 0 else self.chroma_mode
            scan_idx = 2 if 6 <= mode <= 14 else 1 if 22 <= mode <= 30 else 0
        self.stats[f"scan{scan_idx}"] += 1
        sbw = n >> 2
        sb_scan = {1: [(0, 0)], 2: T.SCAN_2[scan_idx], 4: T.SCAN_4[scan_idx],
                   8: T.SCAN_8[scan_idx]}[sbw]
        sc4 = T.SCAN_4[scan_idx]
        # the levels, in scan order: sparse, small, some large
        total = n * n
        levels = [0] * total
        density = f["density"] * (2.5 if n == 4 else 1.0)
        reach = max(1, int(total * rng.choice((0.1, 0.3, 1.0))))
        for k in range(reach):
            if rng.random() < density:
                a = rng.randint(1, 3) if rng.random() > f["big"] else rng.randint(4, 300)
                levels[k] = a * rng.choice((-1, 1))
        if not any(levels):
            levels[rng.randrange(reach)] = rng.choice((-1, 1)) * rng.randint(1, 4)
        last = max(k for k in range(total) if levels[k])
        last_sb, last_pos = last >> 4, last & 15
        xs, ys = int(sb_scan[last_sb][0]), int(sb_scan[last_sb][1])
        lx, ly = (xs << 2) + int(sc4[last_pos][0]), (ys << 2) + int(sc4[last_pos][1])
        if scan_idx == 2:
            lx, ly = ly, lx
        if c == 0:
            off, shift = 3 * (log2 - 2) + ((log2 - 1) >> 2), (log2 + 1) >> 2
        else:
            off, shift = 15, log2 - 2
        cmax = (log2 << 1) - 1
        prefixes = []
        for v, base in ((lx, C["LAST_X_PREFIX"]), (ly, C["LAST_Y_PREFIX"])):
            if v < 4:
                prefix, suffix, nb = v, 0, 0
            else:
                nb = v.bit_length() - 2
                prefix = 2 * (nb + 1) + ((v >> nb) & 1)
                suffix = v - ((1 << nb) * (2 + (prefix & 1)))
            for j in range(prefix):
                cab.bin(base + off + (j >> shift), 1)
            if prefix < cmax:
                cab.bin(base + off + (prefix >> shift), 0)
            prefixes.append((prefix, suffix, nb))
        for prefix, suffix, nb in prefixes:
            if prefix > 3:
                cab.bits(suffix, nb)
        csbf = {}
        greater1_ctx, first_sb = 1, True
        for i in range(last_sb, -1, -1):
            xs, ys = int(sb_scan[i][0]), int(sb_scan[i][1])
            sub = levels[16 * i:16 * i + 16]
            infer_dc = False
            if 0 < i < last_sb:
                cs = csbf.get((xs + 1, ys), 0) | csbf.get((xs, ys + 1), 0)
                flag = int(any(sub))
                cab.bin(C["CODED_SUB_BLOCK"] + min(cs, 1) + (2 if c else 0), flag)
                csbf[(xs, ys)] = flag
                infer_dc = True
            else:
                csbf[(xs, ys)] = 1
            if not csbf[(xs, ys)]:
                continue
            prev = csbf.get((xs + 1, ys), 0) | (csbf.get((xs, ys + 1), 0) << 1)
            # sign data hiding: the first coefficient's sign follows the parity
            sig_pos = [k for k in range(15, -1, -1) if sub[k]]
            hidden = pps["sign_hiding"] and not self.cu_bypass and bool(sig_pos) and \
                sig_pos[0] - sig_pos[-1] > 3
            if hidden:
                first = sig_pos[-1]
                odd = sum(abs(v) for v in sub) & 1
                sub[first] = -abs(sub[first]) if odd else abs(sub[first])
                self.stats["sign_hidden"] += 1
            start = last_pos - 1 if i == last_sb else 15
            for k in range(start, -1, -1):
                if k == 0 and infer_dc:
                    break                       # sig_coeff_flag inferred 1
                xp, yp = int(sc4[k][0]), int(sc4[k][1])
                xc, yc = (xs << 2) + xp, (ys << 2) + yp
                if log2 == 2:
                    sctx = int(T.CTX_IDX_MAP[(yc << 2) + xc])
                elif xc + yc == 0:
                    sctx = 0
                else:
                    if prev == 0:
                        sctx = 2 if xp + yp == 0 else 1 if xp + yp < 3 else 0
                    elif prev == 1:
                        sctx = 2 if yp == 0 else 1 if yp == 1 else 0
                    elif prev == 2:
                        sctx = 2 if xp == 0 else 1 if xp == 1 else 0
                    else:
                        sctx = 2
                    if c == 0 and (xs or ys):
                        sctx += 3
                    if log2 == 3:
                        sctx += 9 if scan_idx == 0 else 15
                    else:
                        sctx += 21 if c == 0 else 12
                sig = int(sub[k] != 0)
                cab.bin(C["SIG_COEFF"] + (sctx if c == 0 else 27 + sctx), sig)
                if sig:
                    infer_dc = False
            if not sig_pos:
                continue
            # levels
            ctx_set = 0 if (i == 0 or c > 0) else 2
            if not first_sb and greater1_ctx == 0:
                ctx_set += 1
            first_sb = False
            greater1_ctx = 1
            first_g1 = -1
            g1 = [0] * len(sig_pos)
            for m, k in enumerate(sig_pos[:8]):
                b = int(abs(sub[k]) > 1)
                cab.bin(C["GREATER1"] + ctx_set * 4 + min(3, greater1_ctx) + (16 if c else 0), b)
                g1[m] = b
                if b:
                    greater1_ctx = 0
                    if first_g1 < 0:
                        first_g1 = m
                elif greater1_ctx > 0:
                    greater1_ctx += 1
            g2 = 0
            if first_g1 >= 0:
                g2 = int(abs(sub[sig_pos[first_g1]]) > 2)
                cab.bin(C["GREATER2"] + ctx_set + (4 if c else 0), g2)
            for m, k in enumerate(sig_pos):
                if not (hidden and m == len(sig_pos) - 1):
                    cab.bypass(sub[k] < 0)
            rice = 0
            for m, k in enumerate(sig_pos):
                base = 1 + (g1[m] if m < 8 else 0) + (g2 if m == first_g1 else 0)
                thresh = (3 if m == first_g1 else 2) if m < 8 else 1
                a = abs(sub[k])
                if base == thresh:
                    rem = a - base
                    if rem < (4 << rice):
                        q = rem >> rice
                        for _ in range(q):
                            cab.bypass(1)
                        cab.bypass(0)
                        cab.bits(rem & ((1 << rice) - 1), rice)
                    else:
                        for _ in range(4):
                            cab.bypass(1)
                        eg(cab, rem - (4 << rice), rice + 1)
                    if a > 3 * (1 << rice):
                        rice = min(rice + 1, 4)
                    if rem > 30:
                        self.stats["escape"] += 1


def write_stream(seed: int, **features) -> list[list[bytes]]:
    """The NAL units of each access unit of a random stream (the first one
    opens with the parameter sets); see the module's docstring."""
    return Writer(seed, **features).stream()


def annexb(aus: list[list[bytes]]) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + u for au in aus for u in au)


# ── MP4 / QuickTime files of the streams ────────────────────────────────

def hvcc(units: list[bytes], in_band: bool, bit_depth: int = 8) -> bytes:
    """An hvcC box of the parameter sets (none for an in-band `hev1`), its
    profile Main, or Main 10 above 8 bits."""
    profile, compat = (0x01, 0x60) if bit_depth == 8 else (0x02, 0x20)
    depth = 0xF8 | (bit_depth - 8)
    body = bytes([1, profile, compat, 0, 0, 0, 0x90, 0, 0, 0, 0, 0, 93, 0xF0, 0x00, 0xFC, 0xFD,
                  depth, depth, 0, 0, 0x0F])
    arrays = [] if in_band else [
        [u for u in units if (u[0] >> 1) & 63 == t] for t in (VPS, SPS, PPS)]
    arrays = [a for a in arrays if a]
    body += bytes([len(arrays)])
    for a in arrays:
        body += bytes([0x80 | ((a[0][0] >> 1) & 63)]) + struct.pack(">H", len(a))
        body += b"".join(struct.pack(">H", len(u)) + u for u in a)
    return _box(b"hvcC", body)


def colr(colour) -> bytes:
    """A `colr` box of type nclx: `colour` as `torch_h264_syntax.vui_colour`
    reads it."""
    full, primaries, transfer, matrix = vui_colour(colour)
    return _box(b"colr", b"nclx" + struct.pack(">HHHB", primaries, transfer, matrix, full << 7))


def write_mov(path, aus: list[list[bytes]], width: int, height: int, fps: int = 30,
              rotation: int = 0, audio: bool = True, quicktime: bool = True,
              media_time: int | None = 0, sample_entry: bytes = b"hvc1",
              display: list[int] | None = None, config: bool = True, bit_depth: int = 8,
              colour=None, boxes: bytes = b"") -> None:
    """A phone-like file of the access units, laid out as
    `torch_h264_syntax.write_mov` lays out H.264's: parameter sets in the
    hvcC box (`hvc1`) or in band (`hev1`); `config` False leaves the hvcC
    box out; `bit_depth` above 8 makes its profile Main 10, and `colour` adds
    a `colr` box after it, as an iPhone's HDR capture has; `boxes` follow
    (`mdcv`, `clli`, as an Android HDR10 file has)."""
    params = [u for au in aus for u in au if (u[0] >> 1) & 63 in (VPS, SPS, PPS)]
    in_band = sample_entry == b"hev1"
    samples, sync = [], []
    for i, au in enumerate(aus):
        units = [u for u in au if in_band or (u[0] >> 1) & 63 not in (VPS, SPS, PPS)]
        samples.append(b"".join(struct.pack(">I", len(u)) + u for u in units))
        if any(16 <= (u[0] >> 1) & 63 <= 23 for u in au):
            sync.append(i + 1)
    boxes = (hvcc(params, in_band, bit_depth) if config else b"") + (
        colr(colour) if colour is not None else b"") + boxes
    write_track_file(path, samples, sync, sample_entry, boxes, width, height, fps, rotation,
                     audio, quicktime, media_time, display)
