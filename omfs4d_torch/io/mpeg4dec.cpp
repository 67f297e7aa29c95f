// MPEG-4 Part 2 (ISO/IEC 14496-2) Simple and Advanced Simple profile
// decoding on the host: the streams cv2's mp4v / XVID / DIVX / FMP4 writers
// (FFmpeg's mpeg4 encoder) produce, and Xvid's and DivX's with B-VOPs,
// quarter-sample and MPEG quantisation, for a machine with no ffmpeg.  Built
// by g++ at first use (omfs4d_torch/native.py) and bound with ctypes by
// omfs4d_torch/io/mpeg4.py; the tables come from mpeg4_tables.py as the
// generated header mpeg4_tables.h.
//
// Covered, for 8-bit 4:2:0 rectangular progressive VOLs of any size:
//   VOS / VO / VOL headers, user data (the encoder's stamp), GOV (its time
//   code), I-, P- and B-VOPs, vop_coded 0; intra MBs with dquant, DC by
//   dct_dc_size or by the AC codes per intra_dc_vlc_thr, DC / AC prediction
//   with the QP rescale and the three scans; P MBs not coded, inter,
//   inter+Q, inter4V, intra, intra+Q; B MBs skipped (where the co-located MB
//   of the future reference was not coded), direct (one or four co-located
//   vectors scaled by TRB / TRD, plus mvdb), interpolated, backward and
//   forward, cbpb and dbquant; vectors with f_code / b_code 1-7, median
//   prediction (B: the last vector of the MB row), the range wrap;
//   half-sample bilinear prediction with vop_rounding_type, quarter-sample
//   prediction (the 8-tap half-sample filter mirrored at the block's edge,
//   the quarter samples averaged from it), unrestricted vectors, the 4MV
//   and quarter-sample chroma vectors; B averaging (rounding up); the three
//   TCOEF escape modes; H.263 inverse quantisation and MPEG quantisation
//   (quant_type 1: default or loaded matrices, mismatch control on inter
//   blocks); video packets (resync_marker, macroblock_number, quant_scale,
//   HEC) cutting every prediction at their edges.
// The IDCT and the encoder workarounds are chosen as FFmpeg chooses them
// (ff_mpeg4_workaround_bugs): the user data stamps (XviD, DivX, Lavc) and the
// container's codec tag (m4vd_set_tag) pick Xvid's integer IDCT (a stream
// stamped XviD, or XVID / XVIX / RMP4 / ZMP4 / SIPP with no stamp) or the
// simple one, and set the edge, DC clip and quarter-sample chroma bugs of
// old Xvid and DivX builds (FFmpeg's direct-mode block size bug reads the
// caller's flags, not the detected ones, and a DivX stamp leaves the
// half-sample chroma rounding as it is: cv2 applies neither).  Both IDCTs
// are theirs by their arithmetic: the samples are FFmpeg's bit for bit.
// What a VOP does to the pictures is kept as FFmpeg keeps it: a B-VOP
// predicts from the last two references and is none itself, a B-VOP with no
// past reference (or whose times are out of order) is skipped, a P-VOP with
// none predicts from FFmpeg's grey dummy picture.  Which picture is shown
// when (reordering, DivX's packed bitstream) is the reader's: m4vd_take
// copies out the last picture decoded, the past or the future reference.
// Interlacing, sprites / GMC, OBMC, data partitioning, shapes, scalability,
// NEWPRED, reduced resolution, more than 8 bits and short headers throw
// Unsupported naming the tool, and so does a VOL that changes the picture
// size after the first VOP; a read past a VOP's end or a value out of range
// throws Corrupt.  Neither crosses the C API: each entry point returns 0, 1
// (corrupt) or 2 (unsupported) and keeps the message for m4vd_error.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "mpeg4_tables.h"

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& s) : std::runtime_error(s) {}
};
struct Unsupported : std::runtime_error {
  explicit Unsupported(const std::string& s) : std::runtime_error(s) {}
};

[[noreturn]] void corrupt(const std::string& what) { throw Corrupt("MPEG-4 Part 2: " + what); }
[[noreturn]] void unsupported(const std::string& what) {
  throw Unsupported("MPEG-4 Part 2 " + what);
}

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// ── bits ─────────────────────────────────────────────────────────────────

struct Bits {
  const uint8_t* d = nullptr;
  size_t nbytes = 0, nbits = 0, pos = 0;

  Bits(const uint8_t* data, size_t n) : d(data), nbytes(n), nbits(n * 8) {}
  // the 32 bits from pos, zeros past the end
  uint32_t peek32() const {
    size_t byte = pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5; ++i) v = v << 8 | (byte + i < nbytes ? d[byte + i] : 0);
    return (uint32_t)(v >> (8 - (pos & 7)));
  }
  void skip(int n) {
    pos += n;
    if (pos > nbits) corrupt("the data ends inside a syntax element (cut short)");
  }
  uint32_t u(int n) {
    if (n == 0) return 0;
    uint32_t v = peek32() >> (32 - n);
    skip(n);
    return v;
  }
  void marker(const char* where) {
    if (u(1) != 1) corrupt(std::string("a marker bit is 0 ") + where);
  }
};

// a prefix code read through a table of 2^12 entries: (symbol, length)
struct Vlc {
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  Vlc(const uint16_t* codes, int n) : sym(4096, -1), len(4096, 0) {
    for (int s = 0; s < n; ++s) {
      int c = codes[2 * s], l = codes[2 * s + 1];
      if (l == 0) continue;
      for (int j = 0; j < 1 << (12 - l); ++j) {
        sym[(c << (12 - l)) | j] = (int16_t)s;
        len[(c << (12 - l)) | j] = (uint8_t)l;
      }
    }
  }
  int read(Bits& b, const char* what) const {
    uint32_t p = b.peek32() >> 20;
    int s = sym[p];
    if (s < 0) corrupt(std::string("no ") + what + " code matches the bits");
    b.skip(len[p]);
    return s;
  }
};

struct Tables {
  Vlc mcbpc_i, mcbpc_p, cbpy, mv, dc_lum, dc_chrom, intra, inter, mb_type_b;
  Tables()
      : mcbpc_i(MCBPC_I, 9), mcbpc_p(MCBPC_P, 21), cbpy(CBPY, 16), mv(MV, 33),
        dc_lum(DC_LUM, 13), dc_chrom(DC_CHROM, 13), intra(INTRA_CODES, 103),
        inter(INTER_CODES, 103), mb_type_b(MB_TYPE_B, 4) {}
};

const Tables& vlc() {
  static const Tables t;
  return t;
}

#include "simple_idct.h"

// ── Xvid's IDCT ──────────────────────────────────────────────────────────
// Walken's integer IDCT as Xvid computes it and FFmpeg's x86 build (cv2's)
// runs it (xvididct.asm, SSE2): rows by the four scaled cosine tables with
// their rounding terms, >> 11, packed into 16 bits with saturation; then
// columns by the tangent butterflies in 16-bit arithmetic that saturates at
// every add (FFmpeg's C version, xvididct.c, wraps instead: the two differ
// where a block's rows or columns leave 16 bits), >> 6.
const int TAB04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
const int TAB17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
const int TAB26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
const int TAB35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};

inline int sat16(int64_t v) { return v < -32768 ? -32768 : (v > 32767 ? 32767 : (int)v); }

void xvid_row(int16_t* in, const int* tab, int rnd) {
  const uint32_t c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3], c5 = tab[4], c6 = tab[5],
                 c7 = tab[6];
  const uint32_t x[8] = {(uint32_t)in[0], (uint32_t)in[1], (uint32_t)in[2], (uint32_t)in[3],
                         (uint32_t)in[4], (uint32_t)in[5], (uint32_t)in[6], (uint32_t)in[7]};
  // 32-bit sums that wrap, as pmaddwd / paddd keep them
  const uint32_t k = c4 * x[0] + (uint32_t)rnd;
  const uint32_t a0 = k + c2 * x[2] + c4 * x[4] + c6 * x[6];
  const uint32_t a1 = k + c6 * x[2] - c4 * x[4] - c2 * x[6];
  const uint32_t a2 = k - c6 * x[2] - c4 * x[4] + c2 * x[6];
  const uint32_t a3 = k - c2 * x[2] + c4 * x[4] - c6 * x[6];
  const uint32_t b0 = c1 * x[1] + c3 * x[3] + c5 * x[5] + c7 * x[7];
  const uint32_t b1 = c3 * x[1] - c7 * x[3] - c1 * x[5] - c5 * x[7];
  const uint32_t b2 = c5 * x[1] - c1 * x[3] + c7 * x[5] + c3 * x[7];
  const uint32_t b3 = c7 * x[1] - c5 * x[3] + c3 * x[5] - c1 * x[7];
  in[0] = (int16_t)sat16((int32_t)(a0 + b0) >> 11);
  in[7] = (int16_t)sat16((int32_t)(a0 - b0) >> 11);
  in[1] = (int16_t)sat16((int32_t)(a1 + b1) >> 11);
  in[6] = (int16_t)sat16((int32_t)(a1 - b1) >> 11);
  in[2] = (int16_t)sat16((int32_t)(a2 + b2) >> 11);
  in[5] = (int16_t)sat16((int32_t)(a2 - b2) >> 11);
  in[3] = (int16_t)sat16((int32_t)(a3 + b3) >> 11);
  in[4] = (int16_t)sat16((int32_t)(a3 - b3) >> 11);
}

// tan(pi/16), tan(pi/8), tan(3pi/16) - 1, 1/(2 sqrt 2), in 16-bit fractions
constexpr int TAN1 = 0x32EC, TAN2 = 0x6A0A, TAN3M1 = 0xAB0E - 0x10000, SQRT2 = 0x5A82;
inline int mulhi(int x, int c) { return (x * c) >> 16; }  // pmulhw

void xvid_col(int16_t* in) {
  const int x0 = in[0], x1 = in[8], x2 = in[16], x3 = in[24], x4 = in[32], x5 = in[40],
            x6 = in[48], x7 = in[56];
  const int tp17 = sat16(mulhi(x7, TAN1) + x1), tm17 = sat16(mulhi(x1, TAN1) - x7);
  const int tp35 = sat16(sat16(mulhi(x5, TAN3M1) + x5) + x3);
  const int tm35 = sat16(sat16(mulhi(x3, TAN3M1) + x3) - x5);
  const int b0 = sat16(tp17 + tp35), b3 = sat16(tm17 - tm35);
  const int t1 = sat16(tp17 - tp35), t2 = sat16(tm17 + tm35);
  const int b1 = sat16(2 * mulhi(sat16(t1 + t2), SQRT2));
  const int b2 = sat16(2 * mulhi(sat16(t1 - t2), SQRT2));
  const int tp26 = sat16(mulhi(x6, TAN2) + x2), tm26 = sat16(mulhi(x2, TAN2) - x6);
  const int tp04 = sat16(x0 + x4), tm04 = sat16(x0 - x4);
  const int a0 = sat16(tp04 + tp26), a3 = sat16(tp04 - tp26);
  const int a1 = sat16(tm04 + tm26), a2 = sat16(tm04 - tm26);
  in[0] = (int16_t)(sat16(a0 + b0) >> 6);
  in[56] = (int16_t)(sat16(a0 - b0) >> 6);
  in[24] = (int16_t)(sat16(a3 + b3) >> 6);
  in[32] = (int16_t)(sat16(a3 - b3) >> 6);
  in[8] = (int16_t)(sat16(a1 + b1) >> 6);
  in[48] = (int16_t)(sat16(a1 - b1) >> 6);
  in[16] = (int16_t)(sat16(a2 + b2) >> 6);
  in[40] = (int16_t)(sat16(a2 - b2) >> 6);
}

void xvid_idct(int16_t* blk, int* out) {
  static const int* const tabs[8] = {TAB04, TAB17, TAB26, TAB35, TAB04, TAB35, TAB26, TAB17};
  static const int rnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
  for (int r = 0; r < 8; ++r) xvid_row(blk + 8 * r, tabs[r], rnd[r]);
  for (int c = 0; c < 8; ++c) xvid_col(blk + c);
  for (int k = 0; k < 64; ++k) out[k] = blk[k];
}

// the block's samples written (put) or added to the prediction in dst
void idct(bool xvid, int16_t* blk, uint8_t* dst, int stride, bool add) {
  int out[64];
  if (xvid)
    xvid_idct(blk, out);
  else
    simple_idct(blk, out);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) {
      uint8_t& p = dst[(size_t)r * stride + c];
      p = clip1(add ? p + out[8 * r + c] : out[8 * r + c]);
    }
}

// ── pictures and motion compensation ─────────────────────────────────────

struct Plane {
  int w = 0, h = 0;  // the buffer's size: whole MBs
  std::vector<uint8_t> px;
  void alloc(int ww, int hh) {
    w = ww;
    h = hh;
    px.assign((size_t)ww * hh, 128);
  }
  uint8_t* at(int x, int y) { return px.data() + (size_t)y * w + x; }
};

struct Frame {
  std::array<Plane, 3> p;
  int width = 0, height = 0;  // the picture's own size, inside the planes
};

// the (n x n) samples of a plane from (x, y), those outside [0, ew) x [0, eh)
// the nearest edge sample's: what FFmpeg's emulated_edge_mc gives, or the
// buffer itself where (ew, eh) is its size
void fetch(const Plane& r, int x, int y, int n, int ew, int eh, uint8_t* out) {
  ew = std::min(ew, r.w);
  eh = std::min(eh, r.h);
  for (int j = 0; j < n; ++j) {
    const uint8_t* row = r.px.data() + (size_t)clip3(0, eh - 1, y + j) * r.w;
    for (int i = 0; i < n; ++i) out[j * n + i] = row[clip3(0, ew - 1, x + i)];
  }
}

// store a block's prediction into dst: written, or averaged with what is
// there rounding up (a B-VOP's second direction)
inline void store(uint8_t* dst, int ds, const uint8_t* v, int size, bool avg) {
  for (int j = 0; j < size; ++j)
    for (int i = 0; i < size; ++i) {
      uint8_t& d = dst[(size_t)j * ds + i];
      d = avg ? (uint8_t)((d + v[j * size + i] + 1) >> 1) : v[j * size + i];
    }
}

#include "hpel_mc.h"

// FFmpeg's MPEG-4 quarter-sample interpolation (qpeldsp.c): the half-sample
// filter (-1, 3, -6, 20, 20, -6, 3, -1) / 32 over the size + 1 samples of a
// row or column, mirrored past them, rounded +16 (put) or +15 (no_rnd)
void qpel_h(const uint8_t* src, int ss, uint8_t* dst, int ds, int rows, int size, int no_rnd) {
  const int last = size;                         // the window's last sample
  for (int r = 0; r < rows; ++r) {
    const uint8_t* s = src + r * ss;
    auto at = [&](int k) { return (int)s[k < 0 ? -1 - k : (k > last ? 2 * last + 1 - k : k)]; };
    for (int x = 0; x < size; ++x) {
      int v = (at(x) + at(x + 1)) * 20 - (at(x - 1) + at(x + 2)) * 6 +
              (at(x - 2) + at(x + 3)) * 3 - (at(x - 3) + at(x + 4));
      dst[r * ds + x] = clip1((v + 16 - no_rnd) >> 5);
    }
  }
}

void qpel_v(const uint8_t* src, int ss, uint8_t* dst, int ds, int size, int no_rnd) {
  const int last = size;
  for (int c = 0; c < size; ++c) {
    auto at = [&](int k) {
      return (int)src[(k < 0 ? -1 - k : (k > last ? 2 * last + 1 - k : k)) * ss + c];
    };
    for (int y = 0; y < size; ++y) {
      int v = (at(y) + at(y + 1)) * 20 - (at(y - 1) + at(y + 2)) * 6 +
              (at(y - 2) + at(y + 3)) * 3 - (at(y - 3) + at(y + 4));
      dst[y * ds + c] = clip1((v + 16 - no_rnd) >> 5);
    }
  }
}

// the average of two blocks, rounding up (put) or down (no_rnd)
void l2(const uint8_t* a, int as, const uint8_t* b, int bs, uint8_t* dst, int ds, int w, int h,
        int no_rnd) {
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      dst[y * ds + x] = (uint8_t)((a[y * as + x] + b[y * bs + x] + 1 - no_rnd) >> 1);
}

// a size x size block at quarter-sample phase (qx, qy) from the window full
// ((size + 1)^2), as FFmpeg's put / put_no_rnd qpel<size>_mc<qx><qy>
void qpel_mc(const uint8_t* full, int qx, int qy, int size, int no_rnd, uint8_t* out) {
  const int n = size + 1;
  std::vector<uint8_t> half((size_t)n * n), hv((size_t)size * size);
  uint8_t* h = half.data();
  if (qy == 0) {
    if (qx == 0) {
      for (int y = 0; y < size; ++y) std::memcpy(out + y * size, full + y * n, size);
    } else if (qx == 2) {
      qpel_h(full, n, out, size, size, size, no_rnd);
    } else {
      qpel_h(full, n, h, size, size, size, no_rnd);
      l2(full + (qx == 3), n, h, size, out, size, size, size, no_rnd);
    }
    return;
  }
  if (qx == 0) {
    if (qy == 2) {
      qpel_v(full, n, out, size, size, no_rnd);
    } else {
      qpel_v(full, n, h, size, size, no_rnd);
      l2(full + (qy == 3) * n, n, h, size, out, size, size, size, no_rnd);
    }
    return;
  }
  // halfH over size + 1 rows; at a quarter column averaged with the
  // samples to its left (1) or right (3)
  qpel_h(full, n, h, size, n, size, no_rnd);
  if (qx != 2) l2(h, size, full + (qx == 3), n, h, size, size, n, no_rnd);
  if (qy == 2) {
    qpel_v(h, size, out, size, size, no_rnd);
    return;
  }
  qpel_v(h, size, hv.data(), size, size, no_rnd);
  l2(h + (qy == 3) * size, size, hv.data(), size, out, size, size, size, no_rnd);
}

// ── the decoder ──────────────────────────────────────────────────────────

enum { I_VOP = 0, P_VOP = 1, B_VOP = 2 };
// what the last push did (m4vd_status)
enum { NONE = 0, REF = 1, BIDIR = 2, NOT_CODED = 3, B_SKIPPED = 4 };
// FFmpeg's workarounds (FF_BUG_*) of the encoders' builds that change samples
enum : unsigned {
  QPEL_CHROMA = 1, QPEL_CHROMA2 = 2, EDGE = 8, DC_CLIP = 16, STD_QPEL = 64
};

inline uint32_t fourcc(const char* s) {
  return (uint32_t)(uint8_t)s[0] | (uint32_t)(uint8_t)s[1] << 8 | (uint32_t)(uint8_t)s[2] << 16 |
         (uint32_t)(uint8_t)s[3] << 24;
}

struct Decoder {
  // the VOL
  bool have_vol = false, resync = true, qpel = false, mpeg_quant = false;
  int width = 0, height = 0, mbw = 0, mbh = 0, time_bits = 1, mb_num_bits = 1, time_res = 1;
  int vo_type = 0, vol_control = 0;
  uint8_t intra_matrix[64], inter_matrix[64];  // raster order
  // the encoder, as FFmpeg finds it
  uint32_t tag = 0;
  int xvid_build = -1, divx_version = -1, divx_build = -1, lavc_build = -1;
  unsigned bugs = 0;
  bool xvid_idct = false;
  int h_edge = 0, v_edge = 0;
  // times (FFmpeg's s->time_base, last_time_base, last_non_b_time, pp/pb)
  int64_t time_base = 0, last_time_base = 0, last_non_b_time = 0;
  uint16_t pp_time = 0, pb_time = 0;
  // pictures: three slots, the last decoded (cur), the past (fwd) and the
  // future (bwd) reference
  std::array<Frame, 3> slot;
  int cur = -1, fwd = -1, bwd = -1;
  int status = NONE, vops = 0;
  std::string error;
  // per MB of the current P- or I-VOP
  std::vector<int> mb_qp;
  std::vector<uint8_t> mb_intra;
  std::vector<int> mvs;  // 4 blocks x (x, y) a MB
  // per MB of the future reference: not coded, four vectors, the vectors
  std::vector<uint8_t> ref_skip, ref_four;
  std::vector<int> ref_mvs;
  // per block (6 a MB): the DC (F[0][0]) and the first column (0-7) and row (8-15)
  std::vector<int> blk_dc;
  std::vector<std::array<int16_t, 16>> blk_ac;
  // the VOP being decoded
  int coding = I_VOP, rounding = 0, dc_thr = 0, fcode = 1, bcode = 1, packet_start = 0;
  int packet_floor = -1;  // a B-VOP's last MB that read bits
  int last_mv[2][2] = {{0, 0}, {0, 0}};  // a B-VOP's predictors, forward and backward
  Frame* out = nullptr;

  void vol(Bits& b);
  void user_data(const uint8_t* d, size_t n);
  void workarounds();
  void vop(Bits& b);
  void unit(const uint8_t* data, size_t n);
  void packet_header(Bits& b, int mbn, int& qp);
  void macroblock(Bits& b, int mbn, int& qp);
  void b_macroblock(Bits& b, int mbn, int& qp);
  void intra_mb(Bits& b, int mbn, int cbp, bool ac_pred, bool dc_vlc, int qp);
  void intra_block(Bits& b, int mbn, int n, bool coded, bool ac_pred, bool dc_vlc, int qp);
  void residual(Bits& b, int mbn, int cbp, int qp);
  void read_tcoef(Bits& b, bool intra, const uint8_t* scan, int i, int* qf);
  int read_mv(Bits& b, int pred, int f);
  void pred_mv(int mbn, int k, int& px, int& py) const;
  bool resync_here(Bits& b) const;
  void motion(int mbn, const Frame& ref, const int* mv, bool four, bool avg);
  void grey(Frame& f) const;
};

// a neighbour MB of mbn at (dx, dy) is inside the VOP and in mbn's packet
inline int neighbour(const Decoder& d, int mbn, int dx, int dy) {
  int mx = mbn % d.mbw + dx, my = mbn / d.mbw + dy;
  if (mx < 0 || my < 0 || mx >= d.mbw) return -1;
  int m = my * d.mbw + mx;
  return m >= d.packet_start ? m : -1;
}

void Decoder::vol(Bits& b) {
  b.u(1);                                        // random_accessible_vol
  int type = b.u(8);                             // video_object_type_indication
  int verid = 1;
  if (b.u(1)) {                                  // is_object_layer_identifier
    verid = b.u(4);
    b.u(3);
  }
  if (b.u(4) == 15) b.u(16);                     // aspect_ratio_info, par
  int control = b.u(1);                          // vol_control_parameters
  if (control) {
    int chroma = b.u(2);
    if (chroma != 1) unsupported("chroma_format " + std::to_string(chroma) + " (only 4:2:0)");
    b.u(1);                                      // low_delay: the reader's
    if (b.u(1)) {                                // vbv_parameters
      b.u(15); b.marker("in vbv_parameters");
      b.u(15); b.marker("in vbv_parameters");
      b.u(15); b.marker("in vbv_parameters");
      b.u(3); b.u(11); b.marker("in vbv_parameters");
      b.u(15); b.marker("in vbv_parameters");
    }
  }
  int shape = b.u(2);
  if (shape != 0)
    unsupported(std::string("video_object_layer_shape ") +
                (shape == 1 ? "binary" : shape == 2 ? "binary only" : "grayscale") +
                " (only rectangular)");
  b.marker("before vop_time_increment_resolution");
  int res = b.u(16);
  if (res == 0) corrupt("vop_time_increment_resolution 0");
  b.marker("after vop_time_increment_resolution");
  int bits = 1;
  while ((1 << bits) < res) ++bits;
  if (b.u(1)) b.u(bits);                         // fixed_vop_rate
  b.marker("before video_object_layer_width");
  int w = b.u(13);
  b.marker("before video_object_layer_height");
  int h = b.u(13);
  b.marker("after video_object_layer_height");
  if (w == 0 || h == 0) corrupt("a VOL of width or height 0");
  if (b.u(1)) unsupported("interlaced (only progressive)");
  if (!b.u(1)) unsupported("OBMC (obmc_disable 0)");
  if (verid == 1 ? b.u(1) : b.u(2)) unsupported("sprites and S(GMC)-VOPs (sprite_enable)");
  if (b.u(1)) unsupported("not_8_bit (only 8-bit samples)");
  bool mq = b.u(1);
  uint8_t im[64], nm[64];
  std::memcpy(im, DEFAULT_INTRA_MATRIX, 64);
  std::memcpy(nm, DEFAULT_INTER_MATRIX, 64);
  if (mq) {
    // load_*_quant_mat: values in zigzag order up to a 0, the last repeated
    for (uint8_t* m : {im, nm}) {
      if (!b.u(1)) continue;
      int last = 0, i = 0;
      for (; i < 64; ++i) {
        int v = b.u(8);
        if (v == 0) break;
        last = v;
        m[ZIGZAG[i]] = (uint8_t)v;
      }
      if (last == 0) corrupt("a loaded quantiser matrix that starts with 0");
      for (; i < 64; ++i) m[ZIGZAG[i]] = (uint8_t)last;
    }
  }
  bool qs = verid != 1 && b.u(1);                // quarter_sample
  if (!b.u(1)) unsupported("complexity_estimation");
  bool rs = !b.u(1);
  if (b.u(1)) unsupported("data_partitioned (and reversible_vlc)");
  if (verid != 1) {
    if (b.u(1)) unsupported("newpred");
    if (b.u(1)) unsupported("reduced_resolution_vop");
  }
  if (b.u(1)) unsupported("scalability");
  if (vops && (w != width || h != height))
    unsupported("a VOL that changes the picture size after the first VOP (" +
                std::to_string(width) + "x" + std::to_string(height) + ", then " +
                std::to_string(w) + "x" + std::to_string(h) + ")");
  if (!have_vol || w != width || h != height) {
    width = w;
    height = h;
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    int n = mbw * mbh;
    for (Frame& f : slot) {
      f.width = w;
      f.height = h;
      f.p[0].alloc(16 * mbw, 16 * mbh);
      f.p[1].alloc(8 * mbw, 8 * mbh);
      f.p[2].alloc(8 * mbw, 8 * mbh);
    }
    cur = fwd = bwd = -1;
    mb_qp.assign(n, 0);
    mb_intra.assign(n, 0);
    mvs.assign((size_t)n * 8, 0);
    ref_skip.assign(n, 0);
    ref_four.assign(n, 0);
    ref_mvs.assign((size_t)n * 8, 0);
    blk_dc.assign((size_t)n * 6, 1024);
    blk_ac.assign((size_t)n * 6, {});
    mb_num_bits = 1;
    while ((1 << mb_num_bits) < n) ++mb_num_bits;
    h_edge = 16 * mbw;                           // FFmpeg's default edge
    v_edge = 16 * mbh;
  }
  time_bits = bits;
  time_res = res;
  resync = rs;
  qpel = qs;
  mpeg_quant = mq;
  std::memcpy(intra_matrix, im, 64);
  std::memcpy(inter_matrix, nm, 64);
  vo_type = type;
  vol_control = control;
  have_vol = true;
}

// the encoder's stamp, read as FFmpeg's decode_user_data reads it
void Decoder::user_data(const uint8_t* d, size_t n) {
  char buf[256];
  size_t i = 0;
  for (; i < 255 && i < n && d[i]; ++i) buf[i] = (char)d[i];
  buf[i] = 0;
  int ver = 0, build = 0, ver2 = 0, ver3 = 0;
  char last = 0;
  int e = std::sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last);
  if (e < 2) e = std::sscanf(buf, "DivX%db%d%c", &ver, &build, &last);
  if (e >= 2) {
    divx_version = ver;
    divx_build = build;
  }
  e = std::sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
  if (e != 4)
    e = std::sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3, &build);
  if (e != 4) {
    e = std::sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
    if (e > 1) build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
  }
  if (e != 4 && std::strcmp(buf, "ffmpeg") == 0) lavc_build = 4600;
  if (e == 4) lavc_build = build;
  if (std::sscanf(buf, "XviD%d", &build) == 1) xvid_build = build;
}

// ff_mpeg4_workaround_bugs: the IDCT and the workarounds, from the stamps and
// the container's codec tag; the bugs only ever add up.  Of those that
// change samples, the direct-mode block size (FF_BUG_DIRECT_BLOCKSIZE, read
// from the caller's flags in ff_mpeg4_set_direct_mv) and a DivX stream's
// half-sample chroma (FF_BUG_HPEL_CHROMA) take no effect in cv2's FFmpeg:
// measured against cv2 5.0.0, libavcodec 62.28.101, neither is applied.
// FF_BUG_IEDGE moves where FFmpeg emulates a Cr block's edge in its scratch
// buffer, still clear of the Cb block's 9 rows: no sample of a progressive
// picture changes (measured there too, on a Lavc56.1.100 stamp).
void Decoder::workarounds() {
  if (xvid_build == -1 && divx_version == -1 && lavc_build == -1) {
    if (tag == fourcc("XVID") || tag == fourcc("XVIX") || tag == fourcc("RMP4") ||
        tag == fourcc("ZMP4") || tag == fourcc("SIPP"))
      xvid_build = 0;
  }
  if (xvid_build == -1 && divx_version == -1 && lavc_build == -1)
    if (tag == fourcc("DIVX") && vo_type == 0 && vol_control == 0) divx_version = 400;
  if (xvid_build >= 0 && divx_version >= 0) divx_version = divx_build = -1;
  if (divx_version >= 500 && divx_build < 1814) bugs |= QPEL_CHROMA;
  if (divx_version > 502 && divx_build < 1814) bugs |= QPEL_CHROMA2;
  if ((unsigned)xvid_build <= 1U) bugs |= QPEL_CHROMA;
  if ((unsigned)xvid_build <= 12U) bugs |= EDGE;
  if ((unsigned)xvid_build <= 32U) bugs |= DC_CLIP;
  if ((unsigned)lavc_build < 4653U) bugs |= STD_QPEL;
  if ((unsigned)lavc_build < 4670U) bugs |= EDGE;
  if ((unsigned)lavc_build <= 4712U) bugs |= DC_CLIP;
  if ((unsigned)divx_version < 500U) bugs |= EDGE;
  if (xvid_build >= 0) xvid_idct = true;         // FFmpeg switches once, for good
}

// at the bits a video packet header starts with: stuffing to the byte, then
// the resync_marker (16 zeros for I, 15 + f_code for P, 15 + max(f_code,
// b_code, 2) for B, then a one)
bool Decoder::resync_here(Bits& b) const {
  size_t p = b.pos;
  auto bit = [&](size_t at) { return (b.d[at >> 3] >> (7 - (at & 7))) & 1; };
  if (p >= b.nbits || bit(p)) return false;
  ++p;
  for (; p & 7; ++p)
    if (p >= b.nbits || !bit(p)) return false;
  int zeros = coding == I_VOP ? 16 : coding == P_VOP ? 15 + fcode
                                                      : 15 + std::max({fcode, bcode, 2});
  for (int k = 0; k < zeros; ++k, ++p)
    if (p >= b.nbits || bit(p)) return false;
  return p < b.nbits && bit(p);
}

// FFmpeg's dummy picture: grey over the picture's own size, 0 (its zeroed
// buffer) past it
void Decoder::grey(Frame& f) const {
  for (int c = 0; c < 3; ++c) {
    Plane& pl = f.p[c];
    int w = c ? (width + 1) / 2 : width, h = c ? (height + 1) / 2 : height;
    for (int y = 0; y < pl.h; ++y)
      for (int x = 0; x < pl.w; ++x) *pl.at(x, y) = x < w && y < h ? 128 : 0;
  }
}

void Decoder::packet_header(Bits& b, int mbn, int& qp) {
  int zeros = coding == I_VOP ? 16 : coding == P_VOP ? 15 + fcode
                                                      : 15 + std::max({fcode, bcode, 2});
  b.skip((int)(((b.pos + 8) & ~(size_t)7) - b.pos) + zeros + 1);
  int num = b.u(mb_num_bits);
  bool ok = num == mbn;
  if (coding == B_VOP && num < mbn && num > std::max(packet_floor, 0)) {
    // a B-VOP's packet may start at MBs its future reference did not code,
    // which read no bits
    ok = true;
    for (int m = num; m < mbn; ++m) ok = ok && ref_skip[m];
  }
  if (!ok)
    corrupt("a video packet starts at macroblock " + std::to_string(num) + ", not at " +
            std::to_string(mbn));
  int q = b.u(5);
  if (q == 0) corrupt("quant_scale 0");
  qp = q;
  if (b.u(1)) {                                  // header_extension_code
    for (int k = 0; b.u(1); ++k)
      if (k > 60) corrupt("a modulo_time_base of more than 60 seconds");
    b.marker("before the HEC's vop_time_increment");
    b.u(time_bits);
    b.marker("after the HEC's vop_time_increment");
    if ((int)b.u(2) != coding) corrupt("the HEC's vop_coding_type differs from the VOP's");
    b.u(3);                                      // intra_dc_vlc_thr
    if (coding != I_VOP && b.u(3) == 0) corrupt("the HEC's vop_fcode_forward is 0");
    if (coding == B_VOP && b.u(3) == 0) corrupt("the HEC's vop_fcode_backward is 0");
  }
  packet_start = num;
  last_mv[0][0] = last_mv[0][1] = last_mv[1][0] = last_mv[1][1] = 0;
}

void Decoder::vop(Bits& b) {
  if (!have_vol) corrupt("a VOP before any VOL header");
  int type = b.u(2);
  if (type == 3) unsupported("S-VOPs (sprites / global motion compensation)");
  int incr = 0;
  for (; b.u(1); ++incr)
    if (incr > 60) corrupt("a modulo_time_base of more than 60 seconds");
  b.marker("before vop_time_increment");
  int increment = b.u(time_bits);
  b.marker("after vop_time_increment");
  // the times as FFmpeg keeps them (decode_vop_header), a VOP not coded too
  bool b_ok = true;
  if (type != B_VOP) {
    last_time_base = time_base;
    time_base += incr;
    int64_t t = time_base * time_res + increment;
    pp_time = (uint16_t)(t - last_non_b_time);
    last_non_b_time = t;
  } else {
    int64_t t = (last_time_base + incr) * time_res + increment;
    pb_time = (uint16_t)(pp_time - (last_non_b_time - t));
    b_ok = !(pp_time <= pb_time || pp_time <= pp_time - pb_time || pp_time <= 0);
  }
  ++vops;
  if (type == B_VOP && !b_ok) {                  // out of order: FFmpeg skips it
    status = B_SKIPPED;
    return;
  }
  if (!b.u(1)) {                                 // vop_coded 0: nothing is decoded
    status = NOT_CODED;
    return;
  }
  coding = type;
  rounding = type == P_VOP ? (int)b.u(1) : 0;
  dc_thr = b.u(3);
  int qp = b.u(5);
  if (qp == 0) corrupt("vop_quant 0");
  fcode = bcode = 1;
  if (type != I_VOP) {
    fcode = b.u(3);
    if (fcode == 0) corrupt("vop_fcode_forward 0");
  }
  if (type == B_VOP) {
    bcode = b.u(3);
    if (bcode == 0) corrupt("vop_fcode_backward 0");
  }
  if (bugs & EDGE) {                             // as the last VOP's workarounds left it
    h_edge = width;
    v_edge = height;
  }
  workarounds();
  if (type == B_VOP && fwd < 0) {                // no past reference: skipped
    status = B_SKIPPED;
    return;
  }
  if (qpel && (bugs & STD_QPEL))
    unsupported("quarter_sample from an FFmpeg build whose quarter-sample filter FFmpeg "
                "emulates as a bug (lavc build " + std::to_string(lavc_build) + ")");
  if (type == P_VOP && bwd < 0) {                // a stream that starts at a P-VOP
    bwd = 0;
    grey(slot[0]);
    std::fill(ref_skip.begin(), ref_skip.end(), 0);
    std::fill(ref_four.begin(), ref_four.end(), 0);
    std::fill(ref_mvs.begin(), ref_mvs.end(), 0);
  }
  int into = 0;
  while (into == fwd || into == bwd) ++into;
  out = &slot[into];
  int total = mbw * mbh;
  packet_start = 0;
  std::fill(mb_intra.begin(), mb_intra.end(), 0);
  packet_floor = -1;
  for (int mbn = 0; mbn < total; ++mbn) {
    if (type == B_VOP) {
      if (mbn % mbw == 0) last_mv[0][0] = last_mv[0][1] = last_mv[1][0] = last_mv[1][1] = 0;
      if (!ref_skip[mbn]) {
        if (mbn > 0 && resync && resync_here(b)) packet_header(b, mbn, qp);
        packet_floor = mbn;
      }
      b_macroblock(b, mbn, qp);
      continue;
    }
    if (mbn > 0 && resync && resync_here(b)) packet_header(b, mbn, qp);
    macroblock(b, mbn, qp);
  }
  // next_start_code(): a 0, then 1s to the byte; a VOP cut inside its MBs
  // may still decode them from zeros, but not end in this
  size_t p = b.pos;
  bool stuffed = p < b.nbits && !((b.d[p >> 3] >> (7 - (p & 7))) & 1);
  for (++p; stuffed && (p & 7); ++p) stuffed = (b.d[p >> 3] >> (7 - (p & 7))) & 1;
  if (!stuffed) corrupt("the VOP does not end in its stuffing (cut short or corrupt)");
  // bytes after the stuffing, before the next start code: FFmpeg then finds
  // no end to the VOP and conceals it as damaged, which is not copied here
  // (zero bytes end it as a start code would)
  for (size_t k = p >> 3; k < b.nbytes; ++k)
    if (b.d[k]) corrupt("bytes after the VOP's end in its sample (cv2 shows FFmpeg's "
                        "concealment of them)");
  cur = into;
  if (type == B_VOP) {
    status = BIDIR;
    return;
  }
  fwd = bwd;
  bwd = into;
  status = REF;
  // what a later B-VOP's direct mode and skips read of this reference (the
  // MB kinds were kept as the P-VOP was read)
  if (type == I_VOP) {
    std::fill(ref_skip.begin(), ref_skip.end(), 0);
    std::fill(ref_four.begin(), ref_four.end(), 0);
  }
  std::copy(mvs.begin(), mvs.end(), ref_mvs.begin());
}

void Decoder::macroblock(Bits& b, int mbn, int& qp) {
  const Tables& t = vlc();
  int* mv = &mvs[(size_t)mbn * 8];
  if (coding == I_VOP) {
    int m;
    do m = t.mcbpc_i.read(b, "mcbpc"); while (m == 8);
    bool ac_pred = b.u(1);
    int cbpy = t.cbpy.read(b, "cbpy");
    bool dc_vlc = qp < DC_THRESHOLD[dc_thr];
    if (m & 4) qp = clip3(1, 31, qp + DQUANT[b.u(2)]);
    mb_qp[mbn] = qp;
    std::fill(mv, mv + 8, 0);
    intra_mb(b, mbn, cbpy << 2 | (m & 3), ac_pred, dc_vlc, qp);
    return;
  }
  int m = -1;
  for (;;) {
    if (b.u(1)) break;                           // not_coded
    m = t.mcbpc_p.read(b, "mcbpc");
    if (m != 20) break;
    m = -1;                                      // stuffing
  }
  mb_qp[mbn] = qp;
  ref_skip[mbn] = m < 0;
  ref_four[mbn] = 0;
  if (m < 0) {                                   // not coded: the reference's samples
    std::fill(mv, mv + 8, 0);
    mb_intra[mbn] = 0;
    for (int n = 0; n < 6; ++n) {
      blk_dc[(size_t)mbn * 6 + n] = 1024;
      blk_ac[(size_t)mbn * 6 + n].fill(0);
    }
    motion(mbn, slot[bwd], mv, false, false);
    return;
  }
  int kind = m >> 2;
  bool intra = kind == 1 || kind == 3;
  bool ac_pred = intra ? (bool)b.u(1) : false;
  int cbpy = t.cbpy.read(b, "cbpy");
  if (!intra) cbpy ^= 15;
  bool dc_vlc = qp < DC_THRESHOLD[dc_thr];
  if (kind == 2 || kind == 3) qp = clip3(1, 31, qp + DQUANT[b.u(2)]);
  mb_qp[mbn] = qp;
  int cbp = cbpy << 2 | (m & 3);
  if (intra) {
    std::fill(mv, mv + 8, 0);
    intra_mb(b, mbn, cbp, ac_pred, dc_vlc, qp);
    return;
  }
  bool four = kind == 4;
  ref_four[mbn] = four;
  for (int k = 0; k < (four ? 4 : 1); ++k) {
    int px, py;
    pred_mv(mbn, k, px, py);
    int x = read_mv(b, px, fcode);
    int y = read_mv(b, py, fcode);
    for (int j = four ? k : 0; j < (four ? k + 1 : 4); ++j) {
      mv[2 * j] = x;
      mv[2 * j + 1] = y;
    }
  }
  mb_intra[mbn] = 0;
  for (int n = 0; n < 6; ++n) {                  // an inter MB is no intra neighbour
    blk_dc[(size_t)mbn * 6 + n] = 1024;
    blk_ac[(size_t)mbn * 6 + n].fill(0);
  }
  motion(mbn, slot[bwd], mv, four, false);
  residual(b, mbn, cbp, qp);
}

// 7.6.9 (FFmpeg's ff_mpeg4_set_one_direct_mv): a co-located vector p scaled
// by TRB / TRD, plus the delta; the backward one from it
inline void direct_mv(int p, int delta, int trb, int trd, int& f, int& bk) {
  f = p * trb / trd + delta;
  bk = delta ? f - p : p * (trb - trd) / trd;
}

void Decoder::b_macroblock(Bits& b, int mbn, int& qp) {
  const Tables& t = vlc();
  int mv[2][8] = {};
  if (ref_skip[mbn]) {                           // skipped as in the future reference:
    motion(mbn, slot[fwd], mv[0], false, false);  // the past one's samples
    return;
  }
  bool direct, fwd_mv = false, bwd_mv = false;
  int cbp = 0, delta[2] = {0, 0};
  if (b.u(1)) {                                  // modb 1: direct, nothing coded
    direct = true;
  } else {
    bool no_cbp = b.u(1);
    int type = t.mb_type_b.read(b, "mb_type");
    direct = type == 0;
    fwd_mv = type == 1 || type == 3;
    bwd_mv = type == 1 || type == 2;
    if (!no_cbp) cbp = b.u(6);
    if (!direct && cbp && b.u(1)) qp = clip3(1, 31, qp + (b.u(1) ? 2 : -2));  // dbquant
    if (fwd_mv) {
      int x = read_mv(b, last_mv[0][0], fcode), y = read_mv(b, last_mv[0][1], fcode);
      last_mv[0][0] = x;
      last_mv[0][1] = y;
      for (int k = 0; k < 4; ++k) {
        mv[0][2 * k] = x;
        mv[0][2 * k + 1] = y;
      }
    }
    if (bwd_mv) {
      int x = read_mv(b, last_mv[1][0], bcode), y = read_mv(b, last_mv[1][1], bcode);
      last_mv[1][0] = x;
      last_mv[1][1] = y;
      for (int k = 0; k < 4; ++k) {
        mv[1][2 * k] = x;
        mv[1][2 * k + 1] = y;
      }
    }
    if (direct) {
      delta[0] = read_mv(b, 0, 1);
      delta[1] = read_mv(b, 0, 1);
    }
  }
  bool four = false;
  if (direct) {
    const int* p = &ref_mvs[(size_t)mbn * 8];
    int trb = pb_time, trd = pp_time;
    int blocks = ref_four[mbn] ? 4 : 1;
    for (int k = 0; k < blocks; ++k)
      for (int c = 0; c < 2; ++c) direct_mv(p[2 * k + c], delta[c], trb, trd, mv[0][2 * k + c],
                                            mv[1][2 * k + c]);
    for (int k = blocks; k < 4; ++k)
      for (int c = 0; c < 2; ++c) {
        mv[0][2 * k + c] = mv[0][c];
        mv[1][2 * k + c] = mv[1][c];
      }
    four = ref_four[mbn] || qpel;
    fwd_mv = bwd_mv = true;
  }
  if (fwd_mv) motion(mbn, slot[fwd], mv[0], four, false);
  if (bwd_mv) motion(mbn, slot[bwd], mv[1], four, fwd_mv);
  residual(b, mbn, cbp, qp);
}

// 7.6.2: the median of the left, above and above-right candidates, those
// outside the VOP or the packet dropped (one: 0; two: the third; three: 0)
void Decoder::pred_mv(int mbn, int k, int& px, int& py) const {
  // (MB dx, dy, block) of candidates A (left), B (above), C (above right)
  static const int cand[4][3][3] = {
      {{-1, 0, 1}, {0, -1, 2}, {1, -1, 2}},
      {{0, 0, 0}, {0, -1, 3}, {1, -1, 2}},
      {{-1, 0, 3}, {0, 0, 0}, {0, 0, 1}},
      {{0, 0, 2}, {0, 0, 0}, {0, 0, 1}}};
  int vx[3], vy[3], valid = 0, ok[3];
  for (int c = 0; c < 3; ++c) {
    const int* q = cand[k][c];
    int m = (q[0] == 0 && q[1] == 0) ? mbn : neighbour(*this, mbn, q[0], q[1]);
    ok[c] = m >= 0;
    vx[c] = ok[c] ? mvs[(size_t)m * 8 + 2 * q[2]] : 0;
    vy[c] = ok[c] ? mvs[(size_t)m * 8 + 2 * q[2] + 1] : 0;
    valid += ok[c];
  }
  if (valid == 1) {
    int c = ok[0] ? 0 : ok[1] ? 1 : 2;
    px = vx[c];
    py = vy[c];
    return;
  }
  px = median3(vx[0], vx[1], vx[2]);
  py = median3(vy[0], vy[1], vy[2]);
}

int Decoder::read_mv(Bits& b, int pred, int f) {
  int code = vlc().mv.read(b, "motion_code");
  int r = f - 1, diff = 0;
  if (code != 0) {
    bool neg = b.u(1);
    diff = r ? ((code - 1) << r) + (int)b.u(r) + 1 : code;
    if (neg) diff = -diff;
  }
  int range = 64 << r, v = pred + diff;
  if (v < -(32 << r)) v += range;
  if (v >= (32 << r)) v -= range;
  return v;
}

// the prediction of an MB into out from ref, as FFmpeg's ff_mpv_motion
// predicts it: 16x16 (one vector) or four 8x8 blocks, half- or
// quarter-sample, chroma from the vector (or the four vectors' sum), put
// or averaged into what is there (avg).  The luma reference reads as
// FFmpeg's emulated edge gives it: its edge at (h_edge, v_edge), the MB
// grid's or, under the EDGE workaround, the picture's; the chroma one at
// half that where the luma block was emulated, else the buffer's own
// (what FFmpeg reads there).  8x8 blocks first hold their position within
// [-16, width] (chroma [-8, width / 2]), a fraction dropped at width.
void Decoder::motion(int mbn, const Frame& ref, const int* mv, bool four, bool avg) {
  int mx = mbn % mbw, my = mbn / mbw;
  const int no_rnd = coding == P_VOP ? rounding : 0;
  uint8_t win[17 * 17], blk[16 * 16];
  Plane& y = out->p[0];
  int cx, cy;
  bool chroma_emu = false, chroma_clip = false;
  if (four) {
    int sx = 0, sy = 0;
    for (int k = 0; k < 4; ++k) {
      int vx = mv[2 * k], vy = mv[2 * k + 1];
      int x = 16 * mx + 8 * (k & 1), yy = 16 * my + 8 * (k >> 1);
      int sh = qpel ? 2 : 1, fm = (1 << sh) - 1;
      int ix = clip3(-16, width, x + (vx >> sh)), iy = clip3(-16, height, yy + (vy >> sh));
      int fx = ix == width ? 0 : vx & fm, fy = iy == height ? 0 : vy & fm;
      fetch(ref.p[0], ix, iy, 9, h_edge, v_edge, win);
      if (qpel)
        qpel_mc(win, fx, fy, 8, no_rnd, blk);
      else
        hpel_mc(win, fx, fy, 8, no_rnd, blk);
      store(y.at(x, yy), y.w, blk, 8, avg);
      sx += qpel ? vx / 2 : vx;
      sy += qpel ? vy / 2 : vy;
    }
    auto chroma = [](int s) {                    // 7.6.5: the sum's sixteenths, Table 7-9
      int a = std::abs(s), v = 2 * (a >> 4) + CHROMA_ROUND[a & 15];
      return s < 0 ? -v : v;
    };
    cx = chroma(sx);
    cy = chroma(sy);
    chroma_clip = true;
  } else {
    int vx = mv[0], vy = mv[1];
    int x = 16 * mx, yy = 16 * my;
    if (qpel) {
      int ix = x + (vx >> 2), iy = yy + (vy >> 2);
      fetch(ref.p[0], ix, iy, 17, h_edge, v_edge, win);
      qpel_mc(win, vx & 3, vy & 3, 16, no_rnd, blk);
      chroma_emu = (unsigned)ix >= (unsigned)std::max(h_edge - (vx & 3) - 15, 0) ||
                   (unsigned)iy >= (unsigned)std::max(v_edge - (vy & 3) - 15, 0);
      int hx, hy;
      if (bugs & QPEL_CHROMA2) {
        static const int rtab[8] = {0, 0, 1, 1, 0, 0, 0, 1};
        hx = (vx >> 1) + rtab[vx & 7];
        hy = (vy >> 1) + rtab[vy & 7];
      } else if (bugs & QPEL_CHROMA) {
        hx = (vx >> 1) | (vx & 1);
        hy = (vy >> 1) | (vy & 1);
      } else {
        hx = vx / 2;
        hy = vy / 2;
      }
      cx = (hx >> 1) | (hx & 1);
      cy = (hy >> 1) | (hy & 1);
    } else {
      int ix = x + (vx >> 1), iy = yy + (vy >> 1);
      fetch(ref.p[0], ix, iy, 17, h_edge, v_edge, win);
      hpel_mc(win, vx & 1, vy & 1, 16, no_rnd, blk);
      chroma_emu = (unsigned)ix >= (unsigned)std::max(h_edge - (vx & 1) - 15, 0) ||
                   (unsigned)iy >= (unsigned)std::max(v_edge - (vy & 1) - 15, 0);
      cx = (vx >> 1) | (vx & 1);
      cy = (vy >> 1) | (vy & 1);
    }
    store(y.at(x, yy), y.w, blk, 16, avg);
  }
  int ix = 8 * mx + (cx >> 1), iy = 8 * my + (cy >> 1), fx = cx & 1, fy = cy & 1;
  int ew = ref.p[1].w, eh = ref.p[1].h;
  if (chroma_clip) {
    ix = clip3(-8, width >> 1, ix);
    iy = clip3(-8, height >> 1, iy);
    if (ix == width >> 1) fx = 0;
    if (iy == height >> 1) fy = 0;
  }
  if (chroma_clip || chroma_emu) {
    ew = h_edge >> 1;
    eh = v_edge >> 1;
  }
  for (int c = 1; c < 3; ++c) {
    fetch(ref.p[c], ix, iy, 9, ew, eh, win);
    hpel_mc(win, fx, fy, 8, no_rnd, blk);
    store(out->p[c].at(8 * mx, 8 * my), out->p[c].w, blk, 8, avg);
  }
}

// an inter MB's coded blocks added to its prediction: H.263 inverse
// quantisation, or MPEG's with the non-intra matrix and mismatch control
void Decoder::residual(Bits& b, int mbn, int cbp, int qp) {
  int mx = mbn % mbw, my = mbn / mbw;
  int qadd = (qp & 1) ? qp : qp - 1;
  for (int n = 0; n < 6; ++n) {
    if (!(cbp >> (5 - n) & 1)) continue;
    int qf[64] = {0};
    read_tcoef(b, false, ZIGZAG, 0, qf);
    int16_t blk[64];
    int sum = -1;
    for (int k = 0; k < 64; ++k) {
      int v = qf[k];
      if (v && mpeg_quant) {
        int a = ((2 * std::abs(v) + 1) * 2 * qp * inter_matrix[k]) >> 5;
        v = v < 0 ? -a : a;
        sum += v;
      } else if (v) {
        v = clip3(-2048, 2047, v > 0 ? 2 * qp * v + qadd : 2 * qp * v - qadd);
      }
      blk[k] = (int16_t)v;
    }
    if (mpeg_quant && (sum & 1)) blk[63] ^= 1;
    if (n < 4)
      idct(xvid_idct, blk, out->p[0].at(16 * mx + 8 * (n & 1), 16 * my + 8 * (n >> 1)),
           out->p[0].w, true);
    else
      idct(xvid_idct, blk, out->p[n - 3].at(8 * mx, 8 * my), out->p[n - 3].w, true);
  }
}

void Decoder::read_tcoef(Bits& b, bool intra, const uint8_t* scan, int i, int* qf) {
  const Tables& t = vlc();
  const Vlc& v = intra ? t.intra : t.inter;
  const uint8_t* levels = intra ? INTRA_LEVEL : INTER_LEVEL;
  const uint8_t* runs = intra ? INTRA_RUN : INTER_RUN;
  int last0 = intra ? INTRA_LAST0 : INTER_LAST0;
  const int8_t* lmax = intra ? INTRA_MAX_LEVEL : INTER_MAX_LEVEL;
  const int8_t* rmax = intra ? INTRA_MAX_RUN : INTER_MAX_RUN;
  for (;;) {
    int s = v.read(b, "TCOEF");
    int last, run, level;
    if (s != ESCAPE) {
      last = s >= last0;
      run = runs[s];
      level = b.u(1) ? -(int)levels[s] : levels[s];
    } else if (!b.u(1)) {                        // escape 1: level + LMAX
      s = v.read(b, "TCOEF");
      if (s == ESCAPE) corrupt("an escape code after escape mode 1");
      last = s >= last0;
      run = runs[s];
      level = levels[s] + lmax[last * 64 + run];
      if (b.u(1)) level = -level;
    } else if (!b.u(1)) {                        // escape 2: run + RMAX + 1
      s = v.read(b, "TCOEF");
      if (s == ESCAPE) corrupt("an escape code after escape mode 2");
      last = s >= last0;
      level = levels[s];
      run = runs[s] + rmax[last * 64 + level] + 1;
      if (b.u(1)) level = -level;
    } else {                                     // escape 3: fixed length
      last = b.u(1);
      run = b.u(6);
      b.marker("in a TCOEF escape");
      level = (int)b.u(12);
      if (level >= 2048) level -= 4096;
      b.marker("in a TCOEF escape");
      if (level == 0) corrupt("a TCOEF escape of level 0");
    }
    i += run;
    if (i > 63) corrupt("a block of more than 64 coefficients");
    qf[scan[i]] = level;
    ++i;
    if (last) return;
  }
}

void Decoder::intra_mb(Bits& b, int mbn, int cbp, bool ac_pred, bool dc_vlc, int qp) {
  mb_intra[mbn] = 1;
  for (int n = 0; n < 6; ++n) intra_block(b, mbn, n, cbp >> (5 - n) & 1, ac_pred, dc_vlc, qp);
}

// 7.4.3: DC and AC prediction from the left (A), above-left (B) and above
// (C) blocks; one outside the VOP or the packet, or of an inter MB, has DC
// 1024 and AC 0
void Decoder::intra_block(Bits& b, int mbn, int n, bool coded, bool ac_pred, bool dc_vlc,
                          int qp) {
  int mx = mbn % mbw, my = mbn / mbw;
  // (MB, block) of A, B, C; MB -1: none
  int nb[3][2];
  if (n < 4) {
    int bx = 2 * mx + (n & 1), by = 2 * my + (n >> 1);
    const int off[3][2] = {{-1, 0}, {-1, -1}, {0, -1}};
    for (int c = 0; c < 3; ++c) {
      int x = bx + off[c][0], y = by + off[c][1];
      if (x < 0 || y < 0) {
        nb[c][0] = -1;
        continue;
      }
      int m = (x >> 1) - mx, k = (y >> 1) - my;
      nb[c][0] = (m == 0 && k == 0) ? mbn : neighbour(*this, mbn, m, k);
      nb[c][1] = (y & 1) << 1 | (x & 1);
    }
  } else {
    const int off[3][2] = {{-1, 0}, {-1, -1}, {0, -1}};
    for (int c = 0; c < 3; ++c) {
      nb[c][0] = neighbour(*this, mbn, off[c][0], off[c][1]);
      nb[c][1] = n;
    }
  }
  int F[3];
  for (int c = 0; c < 3; ++c) {
    int m = nb[c][0];
    bool ok = m >= 0 && mb_intra[m];
    if (!ok) nb[c][0] = -1;
    F[c] = ok ? blk_dc[(size_t)m * 6 + nb[c][1]] : 1024;
  }
  bool from_top = std::abs(F[0] - F[1]) < std::abs(F[1] - F[2]);
  int scale = DC_SCALER[qp * 2 + (n >= 4)];
  int pred = from_top ? F[2] : F[0];
  int dc_pred = (pred + (scale >> 1)) / scale;

  int qf[64] = {0};
  int start = 0;
  if (dc_vlc) {
    int size = (n < 4 ? vlc().dc_lum : vlc().dc_chrom).read(b, "dct_dc_size");
    if (size) {
      int v = b.u(size);
      qf[0] = (v >> (size - 1)) ? v : v - (1 << size) + 1;
      if (size > 8) b.marker("after dct_dc_differential");
    }
    start = 1;
  }
  const uint8_t* scan = !ac_pred ? ZIGZAG : from_top ? ALT_HORIZONTAL : ALT_VERTICAL;
  if (coded) read_tcoef(b, true, scan, start, qf);
  qf[0] += dc_pred;
  if (ac_pred) {
    int c = from_top ? 2 : 0, m = nb[c][0];
    if (m >= 0) {
      const std::array<int16_t, 16>& ac = blk_ac[(size_t)m * 6 + nb[c][1]];
      int q = mb_qp[m];
      for (int i = 1; i < 8; ++i) {
        int a = from_top ? ac[8 + i] : ac[i];
        if (q != qp) {
          int p = a * q;
          a = (p >= 0 ? p + (qp >> 1) : p - (qp >> 1)) / qp;
        }
        qf[from_top ? i : 8 * i] += a;
      }
    }
  }
  std::array<int16_t, 16>& mine = blk_ac[(size_t)mbn * 6 + n];
  mine[0] = mine[8] = 0;
  for (int i = 1; i < 8; ++i) {
    mine[i] = (int16_t)clip3(-32768, 32767, qf[8 * i]);
    mine[8 + i] = (int16_t)clip3(-32768, 32767, qf[i]);
  }
  // the DC predictor kept as FFmpeg keeps it: held within [0, 2047] (past
  // 2047 left as it is under the DC_CLIP workaround); the block's own DC
  // is not held
  int dc = qf[0] * scale;
  int kept = dc;
  if (kept & ~2047) kept = kept < 0 ? 0 : (bugs & DC_CLIP) ? kept : 2047;
  blk_dc[(size_t)mbn * 6 + n] = kept;
  int16_t blk[64];
  blk[0] = (int16_t)dc;
  int qadd = (qp & 1) ? qp : qp - 1;
  for (int k = 1; k < 64; ++k) {
    int v = qf[k];
    if (v && mpeg_quant) {
      int a = (std::abs(v) * 2 * qp * intra_matrix[k]) >> 4;
      v = v < 0 ? -a : a;
    } else if (v) {
      v = v > 0 ? 2 * qp * v + qadd : 2 * qp * v - qadd;
    }
    blk[k] = (int16_t)v;
  }
  if (n < 4)
    idct(xvid_idct, blk, out->p[0].at(16 * mx + 8 * (n & 1), 16 * my + 8 * (n >> 1)),
         out->p[0].w, false);
  else
    idct(xvid_idct, blk, out->p[n - 3].at(8 * mx, 8 * my), out->p[n - 3].w, false);
}

// one unit: a sample of MP4, a chunk of AVI, the headers of an esds or the
// extradata: start codes with what follows each; the first VOP is decoded
// and any after it left, as FFmpeg leaves them (the reader hands a packed
// sample's second VOP in on its own)
void Decoder::unit(const uint8_t* data, size_t n) {
  status = NONE;
  std::vector<size_t> at;                        // the positions of the start codes' 4th byte
  for (size_t i = 0; i + 3 < n; ++i)
    if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
      at.push_back(i + 3);
      i += 2;
    }
  if (n >= 3 && data[0] == 0 && data[1] == 0 && (data[2] & 0xFC) == 0x80)
    unsupported("short-header H.263 (a short_video_start_marker stream)");
  size_t first = at.empty() ? n : at[0] - 3;
  for (size_t i = 0; i < first; ++i)
    if (data[i] != 0) corrupt("bytes before the first start code");
  bool seen_vop = false;
  for (size_t k = 0; k < at.size(); ++k) {
    size_t s = at[k] + 1, e = std::max(s, k + 1 < at.size() ? at[k + 1] - 3 : n);
    int code = data[at[k]];
    Bits b(data + s, e - s);
    if (code >= 0x20 && code <= 0x2F) {
      vol(b);
    } else if (code == 0xB6) {
      if (!seen_vop) vop(b);
      seen_vop = true;
    } else if (code == 0xB2 && !seen_vop) {
      user_data(data + s, e - s);
    } else if (code == 0xB3 && !seen_vop && e - s >= 3) {
      // GOV: its time code is the time base of the VOPs after it
      int hours = b.u(5), minutes = b.u(6);
      b.u(1);
      int seconds = b.u(6);
      time_base = seconds + 60 * (minutes + 60 * hours);
    }
    // VOS (B0), its end (B1), VO (B5), VO ids (00-1F) and the rest carry
    // nothing the samples need
  }
}

template <class F>
int guard(Decoder* d, F f) {
  try {
    f();
    return 0;
  } catch (const Unsupported& e) {
    d->error = "VOP " + std::to_string(d->vops) + ": " + e.what();
    return 2;
  } catch (const Corrupt& e) {
    d->error = "VOP " + std::to_string(d->vops) + ": " + e.what();
    return 1;
  } catch (const std::bad_alloc&) {
    d->error = "MPEG-4 Part 2: out of memory";
    return 1;
  } catch (const std::exception& e) {
    d->error = std::string("MPEG-4 Part 2: ") + e.what();
    return 1;
  }
}

}  // namespace

extern "C" {

void* m4vd_new() {
  try {
    vlc();
    return new Decoder();
  } catch (...) {
    return nullptr;
  }
}

void m4vd_free(void* h) { delete static_cast<Decoder*>(h); }

// the container's codec tag (an AVI fourcc, little-endian), which FFmpeg
// reads the encoder from where the stream carries no stamp
void m4vd_set_tag(void* h, uint32_t tag) { static_cast<Decoder*>(h)->tag = tag; }

// one unit: start codes and their data; its first VOP is decoded
int m4vd_push(void* h, const uint8_t* data, int64_t size) {
  Decoder* d = static_cast<Decoder*>(h);
  return guard(d, [&] { d->unit(data, (size_t)size); });
}

// what the last push did: 0 no VOP, 1 an I- or P-VOP decoded, 2 a B-VOP
// decoded, 3 a VOP not coded, 4 a B-VOP skipped
int m4vd_status(void* h) { return static_cast<Decoder*>(h)->status; }

// which picture: 0 the last decoded, 1 the past reference, 2 the future one
static const Frame* picture(Decoder* d, int which) {
  int k = which == 0 ? d->cur : which == 1 ? d->fwd : d->bwd;
  return k < 0 ? nullptr : &d->slot[k];
}

// the size of a picture; 1 where there is none
int m4vd_frame_size(void* h, int which, int32_t* w, int32_t* hh) {
  const Frame* f = picture(static_cast<Decoder*>(h), which);
  if (!f) return 1;
  *w = f->width;
  *hh = f->height;
  return 0;
}

// copy a picture out (Y' width x height, Cb and Cr rounded up)
int m4vd_take(void* h, int which, uint8_t* y, uint8_t* cb, uint8_t* cr) {
  const Frame* f = picture(static_cast<Decoder*>(h), which);
  if (!f) return 1;
  int w = f->width, hh = f->height, cw = (w + 1) / 2, ch = (hh + 1) / 2;
  for (int r = 0; r < hh; ++r)
    memcpy(y + (size_t)r * w, f->p[0].px.data() + (size_t)r * f->p[0].w, w);
  for (int r = 0; r < ch; ++r) {
    memcpy(cb + (size_t)r * cw, f->p[1].px.data() + (size_t)r * f->p[1].w, cw);
    memcpy(cr + (size_t)r * cw, f->p[2].px.data() + (size_t)r * f->p[2].w, cw);
  }
  return 0;
}

const char* m4vd_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

}  // extern "C"
