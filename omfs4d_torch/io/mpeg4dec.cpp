// MPEG-4 Part 2 (ISO/IEC 14496-2) Simple profile decoding on the host: the
// streams cv2's mp4v / XVID / DIVX / FMP4 writers (FFmpeg's mpeg4 encoder)
// produce, for a machine with no ffmpeg.  Built by g++ at first use
// (omfs4d_torch/native.py) and bound with ctypes by omfs4d_torch/io/mpeg4.py;
// the tables come from mpeg4_tables.py as the generated header mpeg4_tables.h.
//
// Covered, for 8-bit 4:2:0 rectangular VOLs of any size:
//   VOS / VO / VOL headers (GOV and user data skipped), I- and P-VOPs,
//   vop_coded 0; intra MBs with dquant, DC by dct_dc_size or by the AC codes
//   per intra_dc_vlc_thr, DC / AC prediction with the QP rescale and the three
//   scans; P MBs not coded, inter, inter+Q, inter4V, intra, intra+Q; vectors
//   with f_code 1-7, median prediction and the range wrap, half-sample
//   bilinear prediction with vop_rounding_type, unrestricted vectors (the
//   reference's edge samples repeated), the 4MV chroma vector; the three
//   TCOEF escape modes; H.263 inverse quantisation with saturation; video
//   packets (resync_marker, macroblock_number, quant_scale, HEC) cutting
//   every prediction at their edges.
// The IDCT is the integer "simple" IDCT by its arithmetic (13-bit cosines,
// rows >> 11 held in 16 bits, columns >> 20), the one FFmpeg picks for every
// stream but Xvid's: its samples are bit for bit FFmpeg's.
// Anything else throws Unsupported naming the tool, and so does a VOL that
// changes the picture size after the first VOP (each Frame still keeps its
// own size, which is what m4vd_pop copies); a read past a VOP's end
// or a value out of range throws Corrupt.  Neither crosses the C API: each
// entry point returns 0, 1 (corrupt) or 2 (unsupported) and keeps the
// message for m4vd_error.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
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
  Vlc mcbpc_i, mcbpc_p, cbpy, mv, dc_lum, dc_chrom, intra, inter;
  Tables()
      : mcbpc_i(MCBPC_I, 9), mcbpc_p(MCBPC_P, 21), cbpy(CBPY, 16), mv(MV, 33),
        dc_lum(DC_LUM, 13), dc_chrom(DC_CHROM, 13), intra(INTRA_CODES, 103),
        inter(INTER_CODES, 103) {}
};

const Tables& vlc() {
  static const Tables t;
  return t;
}

// ── the IDCT ─────────────────────────────────────────────────────────────
// cos(k pi / 16) sqrt(2) 2^14, rounded (W4 one below)
constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
              W7 = 4520;

void idct_row(int16_t* r) {
  if (!(r[1] | r[2] | r[3] | r[4] | r[5] | r[6] | r[7])) {
    int16_t v = (int16_t)(uint16_t)((uint32_t)(r[0] * 8) & 0xffff);
    for (int k = 0; k < 8; ++k) r[k] = v;
    return;
  }
  int a0 = W4 * r[0] + (1 << 10), a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * r[2];
  a1 += W6 * r[2];
  a2 -= W6 * r[2];
  a3 -= W2 * r[2];
  int b0 = W1 * r[1] + W3 * r[3], b1 = W3 * r[1] - W7 * r[3];
  int b2 = W5 * r[1] - W1 * r[3], b3 = W7 * r[1] - W5 * r[3];
  a0 += W4 * r[4] + W6 * r[6];
  a1 += -W4 * r[4] - W2 * r[6];
  a2 += -W4 * r[4] + W2 * r[6];
  a3 += W4 * r[4] - W6 * r[6];
  b0 += W5 * r[5] + W7 * r[7];
  b1 += -W1 * r[5] - W5 * r[7];
  b2 += W7 * r[5] + W3 * r[7];
  b3 += W3 * r[5] - W1 * r[7];
  r[0] = (int16_t)((a0 + b0) >> 11);
  r[7] = (int16_t)((a0 - b0) >> 11);
  r[1] = (int16_t)((a1 + b1) >> 11);
  r[6] = (int16_t)((a1 - b1) >> 11);
  r[2] = (int16_t)((a2 + b2) >> 11);
  r[5] = (int16_t)((a2 - b2) >> 11);
  r[3] = (int16_t)((a3 + b3) >> 11);
  r[4] = (int16_t)((a3 - b3) >> 11);
}

// one column (stride 8) into out[0..7] (stride 8), before the clip
void idct_col(const int16_t* c, int* out) {
  // 64 bits: 16-bit rows from corrupt data may overflow 32 (the values are
  // the same wherever 32 bits hold them)
  int64_t a0 = W4 * (c[0] + ((1 << 19) / W4)), a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * c[16];
  a1 += W6 * c[16];
  a2 += -W6 * c[16];
  a3 += -W2 * c[16];
  int64_t b0 = W1 * c[8] + W3 * c[24], b1 = W3 * c[8] - W7 * c[24];
  int64_t b2 = W5 * c[8] - W1 * c[24], b3 = W7 * c[8] - W5 * c[24];
  a0 += W4 * c[32] + W6 * c[48];
  a1 += -W4 * c[32] - W2 * c[48];
  a2 += -W4 * c[32] + W2 * c[48];
  a3 += W4 * c[32] - W6 * c[48];
  b0 += W5 * c[40] + W7 * c[56];
  b1 += -W1 * c[40] - W5 * c[56];
  b2 += W7 * c[40] + W3 * c[56];
  b3 += W3 * c[40] - W1 * c[56];
  out[0] = (int)((a0 + b0) >> 20);
  out[8] = (int)((a1 + b1) >> 20);
  out[16] = (int)((a2 + b2) >> 20);
  out[24] = (int)((a3 + b3) >> 20);
  out[32] = (int)((a3 - b3) >> 20);
  out[40] = (int)((a2 - b2) >> 20);
  out[48] = (int)((a1 - b1) >> 20);
  out[56] = (int)((a0 - b0) >> 20);
}

// the block's samples written (put) or added to the prediction in dst
void idct(int16_t* blk, uint8_t* dst, int stride, bool add) {
  for (int r = 0; r < 8; ++r) idct_row(blk + 8 * r);
  int out[64];
  for (int c = 0; c < 8; ++c) idct_col(blk + c, out + c);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) {
      uint8_t& p = dst[(size_t)r * stride + c];
      p = clip1(add ? p + out[8 * r + c] : out[8 * r + c]);
    }
}

// ── the decoder ──────────────────────────────────────────────────────────

enum { I_VOP = 0, P_VOP = 1 };

struct Plane {
  int w = 0, h = 0, ew = 0, eh = 0;  // the buffer's size (whole MBs), the edge's
  std::vector<uint8_t> px;
  void alloc(int ww, int hh, int edge_w, int edge_h) {
    w = ww;
    h = hh;
    ew = edge_w;
    eh = edge_h;
    px.assign((size_t)ww * hh, 128);
  }
  uint8_t* at(int x, int y) { return px.data() + (size_t)y * w + x; }
  // the sample at (x, y), the edge repeated outside
  uint8_t edge(int x, int y) const {
    return px[(size_t)clip3(0, eh - 1, y) * w + clip3(0, ew - 1, x)];
  }
};

struct Frame {
  std::array<Plane, 3> p;
  int width = 0, height = 0;  // the picture's own size, inside the planes
};

struct Decoder {
  // the VOL
  bool have_vol = false;
  int width = 0, height = 0, mbw = 0, mbh = 0, time_bits = 1, mb_num_bits = 1;
  bool resync = true;
  // pictures
  Frame cur, ref;
  bool have_ref = false;
  std::deque<Frame> ready;
  int vops = 0;  // VOPs decoded or skipped so far
  std::string error;
  // per MB of the current VOP
  std::vector<int> mb_qp;
  std::vector<uint8_t> mb_intra;
  std::vector<int> mvs;  // 4 blocks x (x, y) a MB, half samples
  // per block (6 a MB): the DC (F[0][0]) and the first column (0-7) and row (8-15)
  std::vector<int> blk_dc;
  std::vector<std::array<int16_t, 16>> blk_ac;
  // the VOP being decoded
  int coding = I_VOP, rounding = 0, dc_thr = 0, fcode = 1, packet_start = 0;

  void vol(Bits& b);
  void vop(Bits& b);
  void unit(const uint8_t* data, size_t n);
  void macroblock(Bits& b, int mbn, int& qp);
  void intra_mb(Bits& b, int mbn, int cbp, bool ac_pred, bool dc_vlc, int qp);
  void intra_block(Bits& b, int mbn, int n, bool coded, bool ac_pred, bool dc_vlc, int qp);
  void inter_mb(Bits& b, int mbn, int cbp, bool four, int qp);
  void read_tcoef(Bits& b, bool intra, const uint8_t* scan, int i, int* qf);
  int read_mv(Bits& b, int pred);
  void pred_mv(int mbn, int k, int& px, int& py) const;
  bool resync_here(Bits& b) const;
  void predict(int mvx, int mvy, int size, int plane, int x, int y, bool clipped);
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
  b.u(8);                                        // video_object_type_indication
  int verid = 1;
  if (b.u(1)) {                                  // is_object_layer_identifier
    verid = b.u(4);
    b.u(3);
  }
  if (b.u(4) == 15) b.u(16);                     // aspect_ratio_info, par
  if (b.u(1)) {                                  // vol_control_parameters
    int chroma = b.u(2);
    if (chroma != 1) unsupported("chroma_format " + std::to_string(chroma) + " (only 4:2:0)");
    b.u(1);                                      // low_delay
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
  if (b.u(1)) unsupported("quant_type 1 (MPEG quantisation matrices)");
  if (verid != 1 && b.u(1)) unsupported("quarter_sample");
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
    for (Frame* f : {&cur, &ref}) {
      f->width = w;
      f->height = h;
      f->p[0].alloc(16 * mbw, 16 * mbh, 16 * mbw, 16 * mbh);
      f->p[1].alloc(8 * mbw, 8 * mbh, 8 * mbw, 8 * mbh);
      f->p[2].alloc(8 * mbw, 8 * mbh, 8 * mbw, 8 * mbh);
    }
    have_ref = false;
    mb_qp.assign(n, 0);
    mb_intra.assign(n, 0);
    mvs.assign((size_t)n * 8, 0);
    blk_dc.assign((size_t)n * 6, 1024);
    blk_ac.assign((size_t)n * 6, {});
    mb_num_bits = 1;
    while ((1 << mb_num_bits) < n) ++mb_num_bits;
  }
  time_bits = bits;
  resync = rs;
  have_vol = true;
}

// at the bits a video packet header starts with: stuffing to the byte, then
// the resync_marker (16 zeros for I, 15 + f_code for P, then a one)
bool Decoder::resync_here(Bits& b) const {
  size_t p = b.pos;
  auto bit = [&](size_t at) { return (b.d[at >> 3] >> (7 - (at & 7))) & 1; };
  if (p >= b.nbits || bit(p)) return false;
  ++p;
  for (; p & 7; ++p)
    if (p >= b.nbits || !bit(p)) return false;
  int zeros = coding == I_VOP ? 16 : 15 + fcode;
  for (int k = 0; k < zeros; ++k, ++p)
    if (p >= b.nbits || bit(p)) return false;
  return p < b.nbits && bit(p);
}

void Decoder::vop(Bits& b) {
  if (!have_vol) corrupt("a VOP before any VOL header");
  int type = b.u(2);
  if (type == 2) unsupported("B-VOPs (bidirectional prediction, beyond Simple profile)");
  if (type == 3) unsupported("S-VOPs (sprites / global motion compensation)");
  for (int k = 0; b.u(1); ++k)
    if (k > 60) corrupt("a modulo_time_base of more than 60 seconds");
  b.marker("before vop_time_increment");
  b.u(time_bits);
  b.marker("after vop_time_increment");
  if (!b.u(1)) {                                 // vop_coded 0: nothing is shown
    ++vops;
    return;
  }
  coding = type;
  rounding = type == P_VOP ? (int)b.u(1) : 0;
  dc_thr = b.u(3);
  int qp = b.u(5);
  if (qp == 0) corrupt("vop_quant 0");
  fcode = 1;
  if (type == P_VOP) {
    fcode = b.u(3);
    if (fcode == 0) corrupt("vop_fcode_forward 0");
    if (!have_ref) {  // a stream that starts at a P-VOP: FFmpeg's dummy picture,
      // grey over the picture's own size, 0 (its zeroed buffer) past it
      for (int c = 0; c < 3; ++c) {
        Plane& pl = ref.p[c];
        int w = c ? (width + 1) / 2 : width, h = c ? (height + 1) / 2 : height;
        for (int y = 0; y < pl.h; ++y)
          for (int x = 0; x < pl.w; ++x) *pl.at(x, y) = x < w && y < h ? 128 : 0;
      }
      have_ref = true;
    }
  }
  int total = mbw * mbh;
  packet_start = 0;
  std::fill(mb_intra.begin(), mb_intra.end(), 0);
  for (int mbn = 0; mbn < total; ++mbn) {
    if (mbn > 0 && resync && resync_here(b)) {
      b.skip((int)(((b.pos + 8) & ~(size_t)7) - b.pos) + (coding == I_VOP ? 17 : 16 + fcode));
      int num = b.u(mb_num_bits);
      if (num != mbn)
        corrupt("a video packet starts at macroblock " + std::to_string(num) + ", not at " +
                std::to_string(mbn));
      int q = b.u(5);
      if (q == 0) corrupt("quant_scale 0");
      qp = q;
      if (b.u(1)) {                              // header_extension_code
        for (int k = 0; b.u(1); ++k)
          if (k > 60) corrupt("a modulo_time_base of more than 60 seconds");
        b.marker("before the HEC's vop_time_increment");
        b.u(time_bits);
        b.marker("after the HEC's vop_time_increment");
        if ((int)b.u(2) != type) corrupt("the HEC's vop_coding_type differs from the VOP's");
        b.u(3);                                  // intra_dc_vlc_thr
        if (type == P_VOP && b.u(3) == 0) corrupt("the HEC's vop_fcode_forward is 0");
      }
      packet_start = mbn;
    }
    macroblock(b, mbn, qp);
  }
  // next_start_code(): a 0, then 1s to the byte; a VOP cut inside its MBs
  // may still decode them from zeros, but not end in this
  size_t p = b.pos;
  bool stuffed = p < b.nbits && !((b.d[p >> 3] >> (7 - (p & 7))) & 1);
  for (++p; stuffed && (p & 7); ++p) stuffed = (b.d[p >> 3] >> (7 - (p & 7))) & 1;
  if (!stuffed) corrupt("the VOP does not end in its stuffing (cut short or corrupt)");
  ready.push_back(cur);
  std::swap(cur, ref);
  have_ref = true;
  ++vops;
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
  if (m < 0) {                                   // not coded: the reference's samples
    std::fill(mv, mv + 8, 0);
    inter_mb(b, mbn, 0, false, qp);
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
  for (int k = 0; k < (four ? 4 : 1); ++k) {
    int px, py;
    pred_mv(mbn, k, px, py);
    int x = read_mv(b, px);
    int y = read_mv(b, py);
    for (int j = four ? k : 0; j < (four ? k + 1 : 4); ++j) {
      mv[2 * j] = x;
      mv[2 * j + 1] = y;
    }
  }
  inter_mb(b, mbn, cbp, four, qp);
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

int Decoder::read_mv(Bits& b, int pred) {
  int code = vlc().mv.read(b, "motion_code");
  int r = fcode - 1, diff = 0;
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

// the prediction of one block (size 16 or 8) of a plane into cur at (x, y):
// half-sample bilinear with vop_rounding_type, the reference's edge repeated.
// An 8-wide block's horizontal or vertical half sample at rounding type 1 is
// averaged as FFmpeg's x86 build (cv2's) averages it: one of the two samples
// (the left one; of two rows, the one at an odd row of the block's source)
// is lowered by 1, saturating at 0, and the pair averaged rounding up, so
// the result is the standard's (a + b) >> 1 except where that sample is 0
// and the other odd, where it is one more.  The reference is read as FFmpeg
// reads it: its edge is that of the whole MBs decoded, and where `clipped`
// (a 4MV MB's luma blocks and its chroma) the block's position is first held
// within [-16, width] (chroma [-8, width / 2]) by column and by row, a half
// sample dropped where it lands on width (height).
void Decoder::predict(int mvx, int mvy, int size, int plane, int x, int y, bool clipped) {
  const Plane& r = ref.p[plane];
  Plane& c = cur.p[plane];
  int ix = x + (mvx >> 1), iy = y + (mvy >> 1), hx = mvx & 1, hy = mvy & 1;
  if (clipped) {
    int w = plane ? width >> 1 : width, h = plane ? height >> 1 : height, lo = plane ? -8 : -16;
    ix = clip3(lo, w, ix);
    iy = clip3(lo, h, iy);
    if (ix == w) hx = 0;
    if (iy == h) hy = 0;
  }
  bool lowered = size == 8 && rounding == 1;
  for (int row = 0; row < size; ++row) {
    uint8_t* out = c.at(x, y + row);
    for (int col = 0; col < size; ++col) {
      int sx = ix + col, sy = iy + row;
      int a = r.edge(sx, sy);
      if (!hx && !hy) {
        out[col] = (uint8_t)a;
      } else if (hx && !hy) {
        int b = r.edge(sx + 1, sy);
        out[col] = lowered ? (uint8_t)((std::max(a - 1, 0) + b + 1) >> 1)
                           : (uint8_t)((a + b + 1 - rounding) >> 1);
      } else if (!hx && hy) {
        int b = r.edge(sx, sy + 1);
        if (lowered) {
          if (row & 1) a = std::max(a - 1, 0);
          else b = std::max(b - 1, 0);
          out[col] = (uint8_t)((a + b + 1) >> 1);
        } else {
          out[col] = (uint8_t)((a + b + 1 - rounding) >> 1);
        }
      } else {
        out[col] = (uint8_t)((a + r.edge(sx + 1, sy) + r.edge(sx, sy + 1) +
                              r.edge(sx + 1, sy + 1) + 2 - rounding) >> 2);
      }
    }
  }
}

void Decoder::inter_mb(Bits& b, int mbn, int cbp, bool four, int qp) {
  int mx = mbn % mbw, my = mbn / mbw;
  const int* mv = &mvs[(size_t)mbn * 8];
  mb_intra[mbn] = 0;
  for (int n = 0; n < 6; ++n) {                  // an inter MB is no intra neighbour
    blk_dc[(size_t)mbn * 6 + n] = 1024;
    blk_ac[(size_t)mbn * 6 + n].fill(0);
  }
  if (four) {
    for (int k = 0; k < 4; ++k)
      predict(mv[2 * k], mv[2 * k + 1], 8, 0, 16 * mx + 8 * (k & 1), 16 * my + 8 * (k >> 1), true);
  } else {
    predict(mv[0], mv[1], 16, 0, 16 * mx, 16 * my, false);
  }
  int cx, cy;
  if (four) {                                    // 7.6.5: the sum's sixteenths, Table 7-9
    int sx = mv[0] + mv[2] + mv[4] + mv[6], sy = mv[1] + mv[3] + mv[5] + mv[7];
    auto chroma = [](int s) {
      int a = std::abs(s), v = 2 * (a >> 4) + CHROMA_ROUND[a & 15];
      return s < 0 ? -v : v;
    };
    cx = chroma(sx);
    cy = chroma(sy);
  } else {
    cx = (mv[0] >> 1) | (mv[0] & 1);
    cy = (mv[1] >> 1) | (mv[1] & 1);
  }
  predict(cx, cy, 8, 1, 8 * mx, 8 * my, four);
  predict(cx, cy, 8, 2, 8 * mx, 8 * my, four);
  int qadd = (qp & 1) ? qp : qp - 1;
  for (int n = 0; n < 6; ++n) {
    if (!(cbp >> (5 - n) & 1)) continue;
    int qf[64] = {0};
    read_tcoef(b, false, ZIGZAG, 0, qf);
    int16_t blk[64];
    for (int k = 0; k < 64; ++k) {
      int v = qf[k];
      if (v) v = v > 0 ? 2 * qp * v + qadd : 2 * qp * v - qadd;
      blk[k] = (int16_t)clip3(-2048, 2047, v);
    }
    if (n < 4)
      idct(blk, cur.p[0].at(16 * mx + 8 * (n & 1), 16 * my + 8 * (n >> 1)), cur.p[0].w, true);
    else
      idct(blk, cur.p[n - 3].at(8 * mx, 8 * my), cur.p[n - 3].w, true);
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
  int16_t blk[64];
  int dc = clip3(-2048, 2047, qf[0] * scale);
  blk_dc[(size_t)mbn * 6 + n] = dc;
  blk[0] = (int16_t)dc;
  int qadd = (qp & 1) ? qp : qp - 1;
  for (int k = 1; k < 64; ++k) {
    int v = qf[k];
    if (v) v = v > 0 ? 2 * qp * v + qadd : 2 * qp * v - qadd;
    blk[k] = (int16_t)clip3(-2048, 2047, v);
  }
  if (n < 4)
    idct(blk, cur.p[0].at(16 * mx + 8 * (n & 1), 16 * my + 8 * (n >> 1)), cur.p[0].w, false);
  else
    idct(blk, cur.p[n - 3].at(8 * mx, 8 * my), cur.p[n - 3].w, false);
}

// one unit: a sample of MP4, a chunk of AVI, the headers of an esds or the
// extradata: start codes with what follows each, at most one VOP
void Decoder::unit(const uint8_t* data, size_t n) {
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
  int vop_count = 0;
  for (size_t k = 0; k < at.size(); ++k) {
    size_t s = at[k] + 1, e = std::max(s, k + 1 < at.size() ? at[k + 1] - 3 : n);
    int code = data[at[k]];
    Bits b(data + s, e - s);
    if (code >= 0x20 && code <= 0x2F) {
      vol(b);
    } else if (code == 0xB6) {
      if (++vop_count > 1)
        unsupported("packed bitstream (two VOPs in one sample, as DivX writes B-VOPs)");
      vop(b);
    }
    // VOS (B0), its end (B1), user data (B2), GOV (B3), VO (B5), VO ids
    // (00-1F) and the rest carry nothing the samples need
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

// one unit: start codes and their data, at most one VOP
int m4vd_push(void* h, const uint8_t* data, int64_t size) {
  Decoder* d = static_cast<Decoder*>(h);
  return guard(d, [&] { d->unit(data, (size_t)size); });
}

int m4vd_ready(void* h) { return (int)static_cast<Decoder*>(h)->ready.size(); }

// the size of the next picture out
int m4vd_frame_size(void* h, int32_t* w, int32_t* hh) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->ready.empty()) return 1;
  *w = d->ready.front().width;
  *hh = d->ready.front().height;
  return 0;
}

// copy the next picture out (Y' width x height, Cb and Cr rounded up) and drop it
int m4vd_pop(void* h, uint8_t* y, uint8_t* cb, uint8_t* cr) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->ready.empty()) return 1;
  const Frame& f = d->ready.front();
  int w = f.width, hh = f.height, cw = (w + 1) / 2, ch = (hh + 1) / 2;
  for (int r = 0; r < hh; ++r) memcpy(y + (size_t)r * w, f.p[0].px.data() + (size_t)r * f.p[0].w, w);
  for (int r = 0; r < ch; ++r) {
    memcpy(cb + (size_t)r * cw, f.p[1].px.data() + (size_t)r * f.p[1].w, cw);
    memcpy(cr + (size_t)r * cw, f.p[2].px.data() + (size_t)r * f.p[2].w, cw);
  }
  d->ready.pop_front();
  return 0;
}

const char* m4vd_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

}  // extern "C"
