// Microsoft's MPEG-4 family decoded on the host: MS MPEG-4 v2 (MP42), v3
// (MP43, DivX 3) and Windows Media Video 7 and 8 (WMV1, WMV2), as FFmpeg's
// msmpeg4v2 / msmpeg4v3 / wmv1 / wmv2 decoders decode them inside cv2, for a
// machine with no ffmpeg.  Built by g++ at first use (omfs4d_torch/native.py)
// and bound with ctypes by omfs4d_torch/io/msmpeg4.py; the tables come from
// msmpeg4_tables.py as the generated header msmpeg4_tables.h.
//
// All four are I and P pictures of 8-bit 4:2:0 of the container's size, one
// packet a picture, H.263's macroblocks with MPEG-4's DC / AC prediction:
//   the picture header (ff_msmpeg4_decode_picture_header, WMV2's own and its
//   secondary header): picture type, qscale, the slice code (slices of whole
//   MB rows, the predictors cut at each as FFmpeg cuts them), the run-level,
//   DC and MV table indices, use_skip_mb_code, per_mb_rl_table, flip-flop
//   rounding; the extended header (v2 / v3: at the end of an I picture; WMV1:
//   inside its header; WMV2: the container's 4 bytes of extradata) with the
//   bit rate that decides WMV1's per-MB run-level tables and inter-intra
//   prediction;
//   macroblocks: v2's H.263 MCBPC / CBPY and vectors, v3's and WMV's coded
//   block prediction in I pictures, the MB codes of P pictures, skipped MBs,
//   DC prediction (FFmpeg's msmpeg4_pred_dc, the divisions as its x86 build
//   makes them, WMV1's inter-intra prediction from the picture's samples), AC
//   prediction, the three escapes of the run-level codes (v3: 1 + 6 + 8 bits;
//   WMV: level and run lengths fixed at a picture's first escape 3), vectors
//   from the two MV tables (v2: H.263's) with FFmpeg's wrap into (-64, 64);
//   WMV2 on top: skip maps (none, per MB, per row, per column), the CBP table
//   by qscale, top_left_mv_flag's predictor choice, quarter-sample "mspel"
//   motion (the (-1, 9, 9, -1) / 16 filters and hshift), ABT (8x8, 8x4, 4x8
//   blocks, per picture, MB or block, FFmpeg's simple_idct84 / 48), WMV2's
//   own IDCT, and the H.263 loop filter.
// The other versions' IDCT is FFmpeg's simple one (simple_idct.h), as cv2's
// x86-64 build runs it; the samples are FFmpeg's bit for bit.  Motion
// reaches past the picture as FFmpeg's edge emulation and padded buffers
// give it: each plane's edge sample, at the edge of its whole MBs.  A P
// picture with no I picture before it predicts from FFmpeg's grey picture.
// WMV2's IntraX8 pictures (j_type 1) throw Unsupported naming them; a read
// past a picture's end or a value out of range throws Corrupt.  Neither
// crosses the C API: msd_decode returns -1 (corrupt) or -2 (unsupported) and
// keeps the message for msd_error.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "msmpeg4_tables.h"

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& s) : std::runtime_error(s) {}
};
struct Unsupported : std::runtime_error {
  explicit Unsupported(const std::string& s) : std::runtime_error(s) {}
};

[[noreturn]] void corrupt(const std::string& what) { throw Corrupt(what); }

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int mid_pred(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

#include "simple_idct.h"

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
    if (pos > nbits) corrupt("the picture's data ends inside a syntax element (cut short)");
  }
  uint32_t u(int n) {
    if (n == 0) return 0;
    uint32_t v = peek32() >> (32 - n);
    skip(n);
    return v;
  }
  int s(int n) {  // n bits as two's complement
    int v = (int)u(n);
    return v >= 1 << (n - 1) ? v - (1 << n) : v;
  }
  int left() const { return (int)nbits - (int)pos; }
  // FFmpeg's decode012: 0, 10 or 11
  int u012() { return u(1) ? 1 + (int)u(1) : 0; }
};

// a prefix code of up to 32 bits: a trie, its first 10 levels looked up at
// once
struct Vlc {
  static constexpr int K = 10;
  std::vector<std::array<int32_t, 2>> node{{-1, -1}};  // children; -1 none, -2 - symbol a leaf
  std::vector<int32_t> lut;                            // node or leaf reached by K bits
  std::vector<uint8_t> lut_len;                        // bits a leaf in the lut took

  Vlc() = default;
  Vlc(const uint32_t* codes, const uint8_t* lens, int n, const uint16_t* syms = nullptr) {
    for (int i = 0; i < n; ++i) {
      int l = lens[i];
      if (!l) continue;
      int at = 0;
      for (int k = l - 1; k >= 0; --k) {
        int bit = codes[i] >> k & 1;
        if (k == 0) {
          node[at][bit] = -2 - (int32_t)(syms ? syms[i] : i);
        } else {
          if (node[at][bit] == -1) {
            node[at][bit] = (int32_t)node.size();
            node.push_back({-1, -1});
          }
          at = node[at][bit];
        }
      }
    }
    lut.assign(1 << K, 0);
    lut_len.assign(1 << K, 0);
    for (int p = 0; p < 1 << K; ++p) {
      int32_t at = 0;
      int k = 0;
      for (; k < K && at >= 0; ++k) {
        at = node[at][p >> (K - 1 - k) & 1];
        if (at == -1) break;
      }
      lut[p] = at;
      lut_len[p] = (uint8_t)k;
    }
  }
  int read(Bits& b, const char* what) const {
    uint32_t p = b.peek32();
    int32_t at = lut[p >> (32 - K)];
    int k = lut_len[p >> (32 - K)];
    while (at >= 0 && k < 32) at = node[at][p >> (31 - k++) & 1];
    if (at >= -1) corrupt(std::string("no ") + what + " code matches the bits");
    b.skip(k);
    return -2 - at;
  }
};

struct RlTable {
  Vlc vlc;
  const int8_t *run, *level, *max_level, *max_run;
  int n, last;
};

struct Tables {
  Vlc mb_i, mb_non_intra[4], v2_intra_cbpc, v2_mb_type, inter_intra, dc[2][2], v2_dc[2], cbpy,
      h263_mv, mv[2];
  RlTable rl[6];
  Tables() {
    mb_i = Vlc(MB_I_CODE, MB_I_LEN, 64);
    for (int k = 0; k < 4; ++k)
      mb_non_intra[k] = Vlc(MB_NON_INTRA_CODE + 128 * k, MB_NON_INTRA_LEN + 128 * k, 128);
    v2_intra_cbpc = Vlc(V2_INTRA_CBPC_CODE, V2_INTRA_CBPC_LEN, 4);
    v2_mb_type = Vlc(V2_MB_TYPE_CODE, V2_MB_TYPE_LEN, 8);
    inter_intra = Vlc(INTER_INTRA_CODE, INTER_INTRA_LEN, 4);
    for (int t = 0; t < 2; ++t)
      for (int c = 0; c < 2; ++c) dc[t][c] = Vlc(DC_CODE + 240 * t + 120 * c, DC_LEN + 240 * t + 120 * c, 120);
    for (int c = 0; c < 2; ++c) v2_dc[c] = Vlc(V2_DC_CODE + 512 * c, V2_DC_LEN + 512 * c, 512);
    cbpy = Vlc(CBPY_CODE, CBPY_LEN, 16);
    h263_mv = Vlc(H263_MV_CODE, H263_MV_LEN, 33);
    mv[0] = Vlc(MV0_CODE, MV0_LEN, 1100, MV0_SYM);
    mv[1] = Vlc(MV1_CODE, MV1_LEN, 1100, MV1_SYM);
    const uint32_t* codes[6] = {RL0_CODE, RL1_CODE, RL2_CODE, RL3_CODE, RL4_CODE, RL5_CODE};
    const uint8_t* lens[6] = {RL0_LEN, RL1_LEN, RL2_LEN, RL3_LEN, RL4_LEN, RL5_LEN};
    const int8_t* runs[6] = {RL0_RUN, RL1_RUN, RL2_RUN, RL3_RUN, RL4_RUN, RL5_RUN};
    const int8_t* levels[6] = {RL0_LEVEL, RL1_LEVEL, RL2_LEVEL, RL3_LEVEL, RL4_LEVEL, RL5_LEVEL};
    const int8_t* maxl[6] = {RL0_MAX_LEVEL, RL1_MAX_LEVEL, RL2_MAX_LEVEL,
                             RL3_MAX_LEVEL, RL4_MAX_LEVEL, RL5_MAX_LEVEL};
    const int8_t* maxr[6] = {RL0_MAX_RUN, RL1_MAX_RUN, RL2_MAX_RUN,
                             RL3_MAX_RUN, RL4_MAX_RUN, RL5_MAX_RUN};
    for (int k = 0; k < 6; ++k)
      rl[k] = {Vlc(codes[k], lens[k], RL_N[k] + 1), runs[k], levels[k], maxl[k], maxr[k],
               RL_N[k], RL_LAST[k]};
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ── IDCTs ────────────────────────────────────────────────────────────────

// FFmpeg's simple IDCT of a block into dst, written (put) or added
void simple_idct_out(int16_t* blk, uint8_t* dst, int stride, bool add) {
  int out[64];
  simple_idct(blk, out);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) {
      uint8_t& d = dst[(size_t)r * stride + c];
      d = clip1((add ? d : 0) + out[r * 8 + c]);
    }
}

// WMV2's own 8x8 IDCT (wmv2dsp.c): rows >> 8, columns with 3 more bits >> 14,
// in 16-bit rows as FFmpeg keeps them
constexpr int K0 = 2048, K1 = 2841, K2 = 2676, K3 = 2408, K5 = 1609, K6 = 1108, K7 = 565;

void wmv2_row(int16_t* b) {
  int a1 = K1 * b[1] + K7 * b[7], a7 = K7 * b[1] - K1 * b[7];
  int a5 = K5 * b[5] + K3 * b[3], a3 = K3 * b[5] - K5 * b[3];
  int a2 = K2 * b[2] + K6 * b[6], a6 = K6 * b[2] - K2 * b[6];
  int a0 = K0 * b[0] + K0 * b[4], a4 = K0 * b[0] - K0 * b[4];
  int s1 = (int)(181u * (unsigned)(a1 - a5 + a7 - a3) + 128) >> 8;
  int s2 = (int)(181u * (unsigned)(a1 - a5 - a7 + a3) + 128) >> 8;
  b[0] = (int16_t)((a0 + a2 + a1 + a5 + (1 << 7)) >> 8);
  b[1] = (int16_t)((a4 + a6 + s1 + (1 << 7)) >> 8);
  b[2] = (int16_t)((a4 - a6 + s2 + (1 << 7)) >> 8);
  b[3] = (int16_t)((a0 - a2 + a7 + a3 + (1 << 7)) >> 8);
  b[4] = (int16_t)((a0 - a2 - a7 - a3 + (1 << 7)) >> 8);
  b[5] = (int16_t)((a4 - a6 - s2 + (1 << 7)) >> 8);
  b[6] = (int16_t)((a4 + a6 - s1 + (1 << 7)) >> 8);
  b[7] = (int16_t)((a0 + a2 - a1 - a5 + (1 << 7)) >> 8);
}

void wmv2_col(int16_t* b) {
  int a1 = (K1 * b[8] + K7 * b[56] + 4) >> 3, a7 = (K7 * b[8] - K1 * b[56] + 4) >> 3;
  int a5 = (K5 * b[40] + K3 * b[24] + 4) >> 3, a3 = (K3 * b[40] - K5 * b[24] + 4) >> 3;
  int a2 = (K2 * b[16] + K6 * b[48] + 4) >> 3, a6 = (K6 * b[16] - K2 * b[48] + 4) >> 3;
  int a0 = (K0 * b[0] + K0 * b[32]) >> 3, a4 = (K0 * b[0] - K0 * b[32]) >> 3;
  int s1 = (int)(181u * (unsigned)(a1 - a5 + a7 - a3) + 128) >> 8;
  int s2 = (int)(181u * (unsigned)(a1 - a5 - a7 + a3) + 128) >> 8;
  b[0] = (int16_t)((a0 + a2 + a1 + a5 + (1 << 13)) >> 14);
  b[8] = (int16_t)((a4 + a6 + s1 + (1 << 13)) >> 14);
  b[16] = (int16_t)((a4 - a6 + s2 + (1 << 13)) >> 14);
  b[24] = (int16_t)((a0 - a2 + a7 + a3 + (1 << 13)) >> 14);
  b[32] = (int16_t)((a0 - a2 - a7 - a3 + (1 << 13)) >> 14);
  b[40] = (int16_t)((a4 - a6 - s2 + (1 << 13)) >> 14);
  b[48] = (int16_t)((a4 + a6 - s1 + (1 << 13)) >> 14);
  b[56] = (int16_t)((a0 + a2 - a1 - a5 + (1 << 13)) >> 14);
}

void wmv2_idct_out(int16_t* blk, uint8_t* dst, int stride, bool add) {
  for (int r = 0; r < 8; ++r) wmv2_row(blk + 8 * r);
  for (int c = 0; c < 8; ++c) wmv2_col(blk + c);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) {
      uint8_t& d = dst[(size_t)r * stride + c];
      d = clip1((add ? d : 0) + blk[r * 8 + c]);
    }
}

// FFmpeg's 4-point IDCTs of simple_idct.c (ABT's 8x4 and 4x8 blocks)
constexpr int C_SHIFT = 4 + 1 + 12, R_SHIFT = 11;
const int C1 = (int)(0.6532814824 * 1.414213562 * (1 << 12) + 0.5);
const int C2 = (int)(0.2705980501 * 1.414213562 * (1 << 12) + 0.5);
const int C3 = (int)(0.5 * 1.414213562 * (1 << 12) + 0.5);
const int R1 = (int)(0.6532814824 * 1.414213562 * (1 << 15) + 0.5);
const int R2 = (int)(0.2705980501 * 1.414213562 * (1 << 15) + 0.5);
const int R3 = (int)(0.5 * 1.414213562 * (1 << 15) + 0.5);

void idct4col_add(uint8_t* dst, int stride, const int16_t* col) {
  int a0 = col[0], a1 = col[8], a2 = col[16], a3 = col[24];
  int c0 = (a0 + a2) * C3 + (1 << (C_SHIFT - 1)), c2 = (a0 - a2) * C3 + (1 << (C_SHIFT - 1));
  int c1 = a1 * C1 + a3 * C2, c3 = a1 * C2 - a3 * C1;
  dst[0] = clip1(dst[0] + ((c0 + c1) >> C_SHIFT));
  dst[stride] = clip1(dst[stride] + ((c2 + c3) >> C_SHIFT));
  dst[2 * stride] = clip1(dst[2 * stride] + ((c2 - c3) >> C_SHIFT));
  dst[3 * stride] = clip1(dst[3 * stride] + ((c0 - c1) >> C_SHIFT));
}

void idct4row(int16_t* row) {
  int a0 = row[0], a1 = row[1], a2 = row[2], a3 = row[3];
  int c0 = (a0 + a2) * R3 + (1 << (R_SHIFT - 1)), c2 = (a0 - a2) * R3 + (1 << (R_SHIFT - 1));
  int c1 = a1 * R1 + a3 * R2, c3 = a1 * R2 - a3 * R1;
  row[0] = (int16_t)((c0 + c1) >> R_SHIFT);
  row[1] = (int16_t)((c2 + c3) >> R_SHIFT);
  row[2] = (int16_t)((c2 - c3) >> R_SHIFT);
  row[3] = (int16_t)((c0 - c1) >> R_SHIFT);
}

// ff_simple_idct84_add: 8 wide, 4 high
void idct84_add(uint8_t* dst, int stride, int16_t* blk) {
  for (int r = 0; r < 4; ++r) simple_row(blk + 8 * r);
  for (int c = 0; c < 8; ++c) idct4col_add(dst + c, stride, blk + c);
}

// ff_simple_idct48_add: 4 wide, 8 high
void idct48_add(uint8_t* dst, int stride, int16_t* blk) {
  for (int r = 0; r < 8; ++r) idct4row(blk + 8 * r);
  int out[64];
  for (int c = 0; c < 4; ++c) simple_col(blk + c, out + c);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 4; ++c) {
      uint8_t& d = dst[(size_t)r * stride + c];
      d = clip1(d + out[r * 8 + c]);
    }
}

// ── pictures and motion compensation ─────────────────────────────────────

struct Plane {
  int w = 0, h = 0;  // the buffer's size: whole MBs
  std::vector<uint8_t> px;
  void alloc(int ww, int hh, uint8_t v) {
    w = ww;
    h = hh;
    px.assign((size_t)ww * hh, v);
  }
  uint8_t* at(int x, int y) { return px.data() + (size_t)y * w + x; }
};

struct Frame {
  std::array<Plane, 3> p;
};

// the (n x n) samples of a plane from (x, y), those outside it the nearest
// edge sample's (FFmpeg's emulated edge and its padded buffers alike, at the
// edge of the whole MBs)
void fetch(const Plane& r, int x, int y, int n, uint8_t* out) {
  for (int j = 0; j < n; ++j) {
    const uint8_t* row = r.px.data() + (size_t)clip3(0, r.h - 1, y + j) * r.w;
    for (int i = 0; i < n; ++i) out[j * n + i] = row[clip3(0, r.w - 1, x + i)];
  }
}

#include "hpel_mc.h"

// WMV2's mspel half-sample filters (wmv2dsp.c): (-1, 9, 9, -1) / 16 across
// rows (h) or columns (v) of an 8-wide block, clipped
void mspel_h(const uint8_t* src, int ss, uint8_t* dst, int ds, int rows) {
  for (int r = 0; r < rows; ++r, src += ss, dst += ds)
    for (int i = 0; i < 8; ++i)
      dst[i] = clip1((9 * (src[i] + src[i + 1]) - (src[i - 1] + src[i + 2]) + 8) >> 4);
}

void mspel_v(const uint8_t* src, int ss, uint8_t* dst, int ds) {
  for (int i = 0; i < 8; ++i)
    for (int r = 0; r < 8; ++r) {
      const uint8_t* s = src + i + r * ss;
      dst[r * ds + i] = clip1((9 * (s[0] + s[ss]) - (s[-ss] + s[2 * ss]) + 8) >> 4);
    }
}

inline void avg_into(uint8_t* dst, int ds, const uint8_t* a, int as, const uint8_t* b, int bs) {
  for (int r = 0; r < 8; ++r)
    for (int i = 0; i < 8; ++i) dst[r * ds + i] = (uint8_t)((a[r * as + i] + b[r * bs + i] + 1) >> 1);
}

// put_mspel_pixels_tab[dxy] of an 8x8 block at src (inside a window with a
// sample of margin above and left, two below and right): dxy bit 0 hshift,
// bit 1 the horizontal half, bit 2 the vertical one
void mspel8(int dxy, const uint8_t* src, int ss, uint8_t* dst, int ds) {
  uint8_t half[64], hh[88], hv[64], hhv[64];
  switch (dxy) {
    case 0:
      for (int r = 0; r < 8; ++r) memcpy(dst + r * ds, src + r * ss, 8);
      break;
    case 1:  // mc10
      mspel_h(src, ss, half, 8, 8);
      avg_into(dst, ds, src, ss, half, 8);
      break;
    case 2:  // mc20
      mspel_h(src, ss, dst, ds, 8);
      break;
    case 3:  // mc30
      mspel_h(src, ss, half, 8, 8);
      avg_into(dst, ds, src + 1, ss, half, 8);
      break;
    case 4:  // mc02
      mspel_v(src, ss, dst, ds);
      break;
    case 5:  // mc12
      mspel_h(src - ss, ss, hh, 8, 11);
      mspel_v(src, ss, hv, 8);
      mspel_v(hh + 8, 8, hhv, 8);
      avg_into(dst, ds, hv, 8, hhv, 8);
      break;
    case 6:  // mc22
      mspel_h(src - ss, ss, hh, 8, 11);
      mspel_v(hh + 8, 8, dst, ds);
      break;
    default:  // mc32
      mspel_h(src - ss, ss, hh, 8, 11);
      mspel_v(src + 1, ss, hv, 8);
      mspel_v(hh + 8, 8, hhv, 8);
      avg_into(dst, ds, hv, 8, hhv, 8);
      break;
  }
}

// ── the decoder ──────────────────────────────────────────────────────────

enum { V2 = 2, V3 = 3, WMV1 = 4, WMV2 = 5 };
enum { PICT_I = 1, PICT_P = 2 };
enum { SHOWN = 0, SKIPPED = 1 };
enum { MB_INTER, MB_INTRA, MB_SKIPPED };
constexpr int DC_MAX = 119, MBAC_BITRATE = 50 * 1024, II_BITRATE = 128 * 1024;

struct Decoder {
  int version = V3, width = 0, height = 0, mbw = 0, mbh = 0;
  std::string error;
  int pictures = 0;
  // WMV2's extradata
  int mspel_bit = 0, loop_filter = 0, abt_flag = 0, j_type_bit = 0, top_left_mv_flag = 0,
      per_mb_rl_bit = 0, wmv2_slices = 0;
  // the extended header
  int bit_rate = 0, flipflop = 0;
  // the picture
  int pict = PICT_I, qscale = 1, slice_height = 0, rl_index = 0, rl_chroma_index = 0,
      dc_index = 0, mv_index = 0, use_skip = 0, per_mb_rl = 0, no_rounding = 0,
      inter_intra = 0, esc3_level = 0, esc3_run = 0;
  int cbp_index = 0, mspel = 0, per_mb_abt = 0, abt_type = 0;
  std::vector<uint8_t> skipped;  // WMV2's skip map
  // the MB being decoded
  int mx = 0, my = 0, first_line = 0, ac_pred = 0, aic_dir = 0, hshift = 0, per_block_abt = 0;
  // the predictors, padded by one block / MB on each side
  int bw = 0, bh = 0, cw = 0;
  std::vector<int16_t> dc[3];             // luma by block, chroma by MB
  std::vector<std::array<int16_t, 16>> ac[3];
  std::vector<uint8_t> coded;             // luma by block
  std::vector<std::array<int, 2>> mv;     // by MB
  Frame frames[2];
  int cur = 0;
  bool have_ref = false;

  int bi(int x, int y) const { return (y + 1) * bw + x + 1; }  // luma block index
  int ci(int x, int y) const { return (y + 1) * cw + x + 1; }  // chroma / MB index

  void init(int v, int w, int h, const uint8_t* extra, int n);
  void grey(Frame& f) const;
  int picture(const uint8_t* data, size_t n);
  void header(Bits& b);
  void wmv2_header(Bits& b);
  void ext_header(Bits& b, int bits_left);
  int macroblock(Bits& b, int16_t blocks[6][64], int16_t abt2[6][64], int* last, int* abt);
  void intra_dc(Bits& b, int n, int16_t* blk, int* dir);
  int pred_dc(int n, int scale, int* dir) const;
  void block(Bits& b, int16_t* blk, int n, bool coded_bit, bool intra, const uint8_t* scan,
             int* last, int positions = 64);
  void pred_ac(int16_t* blk, int n, int dir);
  void read_mv(Bits& b, int& px, int& py);
  int v2_mv(Bits& b, int pred);
  void pred_mv(int& px, int& py) const;
  void wmv2_pred_mv(Bits& b, int& px, int& py);
  void motion(const Frame& ref, Frame& out, int vx, int vy);
  void reconstruct(Frame& out, int16_t blocks[6][64], int16_t abt2[6][64], const int* last,
                   const int* abt, bool intra);
  void loop_filter_mb(Frame& out);
  int scale(int n) const;
};

void Decoder::init(int v, int w, int h, const uint8_t* extra, int n) {
  if (v < V2 || v > WMV2) corrupt("an unknown MS MPEG-4 / WMV version");
  if (w <= 0 || h <= 0 || w > 8192 || h > 8192) corrupt("a picture size out of range");
  version = v;
  width = w;
  height = h;
  mbw = (w + 15) / 16;
  mbh = (h + 15) / 16;
  bw = 2 * mbw + 2;
  bh = 2 * mbh + 2;
  cw = mbw + 2;
  for (int c = 0; c < 3; ++c) {
    size_t k = c ? (size_t)cw * (mbh + 2) : (size_t)bw * bh;
    dc[c].assign(k, 1024);
    ac[c].assign(k, {});
  }
  coded.assign((size_t)bw * bh, 0);
  mv.assign((size_t)cw * (mbh + 2), {0, 0});
  skipped.assign((size_t)mbw * mbh, 0);
  for (Frame& f : frames) {
    f.p[0].alloc(16 * mbw, 16 * mbh, 0);
    f.p[1].alloc(8 * mbw, 8 * mbh, 0);
    f.p[2].alloc(8 * mbw, 8 * mbh, 0);
  }
  if (v == WMV2) {
    // WMV2's extended header: the container's extradata (decode_ext_header)
    if (n < 4) corrupt("WMV2 needs 4 bytes of extradata (its extended header), the file has " +
                       std::to_string(n));
    Bits b(extra, 4);
    b.u(5);  // frame rate
    bit_rate = (int)b.u(11) * 1024;
    mspel_bit = b.u(1);
    loop_filter = b.u(1);
    abt_flag = b.u(1);
    j_type_bit = b.u(1);
    top_left_mv_flag = b.u(1);
    per_mb_rl_bit = b.u(1);
    wmv2_slices = b.u(3);
    if (!wmv2_slices) corrupt("WMV2's extradata gives a slice code of 0");
  }
}

// FFmpeg's grey picture, what a P picture with no reference predicts from:
// 0x80 over the picture's own size, 0 (its zeroed buffer) past it
void Decoder::grey(Frame& f) const {
  for (int c = 0; c < 3; ++c) {
    Plane& p = f.p[c];
    std::fill(p.px.begin(), p.px.end(), 0);
    int w = c ? (width + 1) / 2 : width, h = c ? (height + 1) / 2 : height;
    for (int y = 0; y < h; ++y) memset(p.at(0, y), 0x80, w);
  }
}

int Decoder::scale(int n) const {
  bool chroma = n >= 4;
  if (version == V2) return 8;
  if (version == V3) return chroma ? DC_SCALE_WMV_CHROMA[qscale] : DC_SCALE_V3_LUMA[qscale];
  return chroma ? DC_SCALE_WMV_CHROMA[qscale] : DC_SCALE_WMV_LUMA[qscale];
}

// ff_msmpeg4_decode_ext_header: the frame rate, bit rate and flip-flop
// rounding, read where bits_left of the picture are 17 (v2: 16) to 24
void Decoder::ext_header(Bits& b, int bits_left) {
  int length = version >= V3 ? 17 : 16;
  if (bits_left >= length && bits_left < length + 8) {
    b.u(5);
    bit_rate = (int)b.u(11) * 1024;
    flipflop = version >= V3 ? (int)b.u(1) : 0;
  } else if (bits_left < length + 8) {
    flipflop = 0;
  }
  // longer: "I-frame too long, ignoring ext header", the last values stay
}

void Decoder::header(Bits& b) {
  if (b.left() < 0 || (int64_t)b.left() * 8 < (int64_t)mbw * mbh)
    corrupt("a picture shorter than one bit per eight macroblocks (FFmpeg drops it)");
  pict = (int)b.u(2) + 1;
  if (pict != PICT_I && pict != PICT_P) corrupt("a picture type other than I or P");
  qscale = (int)b.u(5);
  if (!qscale) corrupt("qscale 0");
  if (pict == PICT_I) {
    int code = (int)b.u(5);
    if (code < 0x17) corrupt("a slice code below 0x17");
    slice_height = mbh / (code - 0x16);
    if (version == V2) {
      rl_index = rl_chroma_index = 2;
      dc_index = 0;
    } else if (version == V3) {
      rl_chroma_index = b.u012();
      rl_index = b.u012();
      dc_index = (int)b.u(1);
    } else {  // WMV1: the extended header is inside the picture header
      ext_header(b, 32 - (int)b.pos);
      per_mb_rl = bit_rate > MBAC_BITRATE ? (int)b.u(1) : 0;
      if (!per_mb_rl) {
        rl_chroma_index = b.u012();
        rl_index = b.u012();
      }
      dc_index = (int)b.u(1);
      inter_intra = 0;
    }
    no_rounding = 1;
  } else {
    if (version == V2) {
      use_skip = (int)b.u(1);
      rl_index = rl_chroma_index = 2;
      dc_index = mv_index = 0;
    } else if (version == V3) {
      use_skip = (int)b.u(1);
      rl_index = rl_chroma_index = b.u012();
      dc_index = (int)b.u(1);
      mv_index = (int)b.u(1);
    } else {
      use_skip = (int)b.u(1);
      per_mb_rl = bit_rate > MBAC_BITRATE ? (int)b.u(1) : 0;
      if (!per_mb_rl) rl_index = rl_chroma_index = b.u012();
      dc_index = (int)b.u(1);
      mv_index = (int)b.u(1);
      inter_intra = width * height < 320 * 240 && bit_rate <= II_BITRATE;
    }
    no_rounding = flipflop ? no_rounding ^ 1 : 0;
  }
  esc3_level = esc3_run = 0;
}

// ff_wmv2_decode_picture_header and the secondary header; SKIPPED where a
// P picture's skip map skips every MB (FFmpeg shows no frame for it)
void Decoder::wmv2_header(Bits& b) {
  slice_height = mbh / wmv2_slices;
  if (pict == PICT_I) {
    if (j_type_bit && b.u(1))
      throw Unsupported("WMV2 IntraX8 picture (j_type 1, FFmpeg's intrax8.c)");
    per_mb_rl = per_mb_rl_bit ? (int)b.u(1) : 0;
    if (!per_mb_rl) {
      rl_chroma_index = b.u012();
      rl_index = b.u012();
    }
    dc_index = (int)b.u(1);
    if ((int64_t)b.left() * 8 < (int64_t)mbw * mbh)
      corrupt("a picture shorter than one bit per eight macroblocks (FFmpeg drops it)");
    std::fill(skipped.begin(), skipped.end(), 0);
    inter_intra = 0;
    no_rounding = 1;
  } else {
    int type = (int)b.u(2);
    std::fill(skipped.begin(), skipped.end(), 0);
    auto need = [&](int64_t n) {
      if (b.left() < n) corrupt("WMV2's skip map runs past the picture");
    };
    if (type == 1) {
      need((int64_t)mbw * mbh);
      for (int k = 0; k < mbw * mbh; ++k) skipped[k] = (uint8_t)b.u(1);
    } else if (type == 2) {
      for (int y = 0; y < mbh; ++y) {
        need(1);
        if (b.u(1)) {
          for (int x = 0; x < mbw; ++x) skipped[y * mbw + x] = 1;
        } else {
          for (int x = 0; x < mbw; ++x) skipped[y * mbw + x] = (uint8_t)b.u(1);
        }
      }
    } else if (type == 3) {
      for (int x = 0; x < mbw; ++x) {
        need(1);
        if (b.u(1)) {
          for (int y = 0; y < mbh; ++y) skipped[y * mbw + x] = 1;
        } else {
          for (int y = 0; y < mbh; ++y) skipped[y * mbw + x] = (uint8_t)b.u(1);
        }
      }
    }
    int coded_mbs = 0;
    for (uint8_t s : skipped) coded_mbs += !s;
    if (coded_mbs > b.left()) corrupt("WMV2's skip map leaves fewer bits than coded MBs");
    static const int cbp_map[3][3] = {{0, 2, 1}, {1, 0, 2}, {2, 1, 0}};
    cbp_index = cbp_map[(qscale > 10) + (qscale > 20)][b.u012()];
    mspel = mspel_bit ? (int)b.u(1) : 0;
    if (abt_flag) {
      per_mb_abt = (int)b.u(1) ^ 1;
      if (!per_mb_abt) abt_type = b.u012();
    }
    per_mb_rl = per_mb_rl_bit ? (int)b.u(1) : 0;
    if (!per_mb_rl) rl_index = rl_chroma_index = b.u012();
    if (b.left() < 2) corrupt("a WMV2 picture header runs past the picture");
    dc_index = (int)b.u(1);
    mv_index = (int)b.u(1);
    inter_intra = 0;
    no_rounding ^= 1;
  }
  esc3_level = esc3_run = 0;
}

// msmpeg4_pred_dc: the DC predictor of block n in its quantiser's units and
// its direction (0 left, 1 top)
int Decoder::pred_dc(int n, int sc, int* dir) const {
  int c = n < 4 ? 0 : n - 3;
  int x = n < 4 ? 2 * mx + (n & 1) : mx, y = n < 4 ? 2 * my + (n >> 1) : my;
  const std::vector<int16_t>& v = dc[c];
  auto at = [&](int xx, int yy) { return (int)v[n < 4 ? bi(xx, yy) : ci(xx, yy)]; };
  int a = at(x - 1, y), b = at(x - 1, y - 1), cc = at(x, y - 1);
  if (first_line && !(n & 2) && version < WMV1) b = cc = 1024;
  // the x86 build's division: the high half of a signed 32 x 32 product
  auto div = [&](int64_t val) {
    return (int)(((val + (sc >> 1)) * (int64_t)INVERSE[sc]) >> 32);
  };
  a = div(a);
  b = div(b);
  cc = div(cc);
  if (version > V3) {
    if (inter_intra) {
      if (n == 1) {
        *dir = 0;
        return a;
      }
      if (n == 2) {
        *dir = 1;
        return cc;
      }
      if (n == 3) {
        if (std::abs(a - b) < std::abs(b - cc)) {
          *dir = 1;
          return cc;
        }
        *dir = 0;
        return a;
      }
      // from the samples of the blocks left and above in this picture
      const Frame& f = frames[cur];
      const Plane& p = f.p[n < 4 ? 0 : n - 3];
      int bx = n < 4 ? 16 * mx : 8 * mx, by = n < 4 ? 16 * my : 8 * my;
      auto get_dc = [&](int x0, int y0) {
        int sum = 0;
        for (int j = 0; j < 8; ++j)
          for (int i = 0; i < 8; ++i) sum += p.px[(size_t)(y0 + j) * p.w + x0 + i];
        uint32_t d = (uint32_t)(sc * 8);
        return (int)(((uint64_t)(uint32_t)(sum + (d >> 1)) * INVERSE[d]) >> 32);
      };
      a = mx == 0 ? (1024 + (sc >> 1)) / sc : get_dc(bx - 8, by);
      cc = my == 0 ? (1024 + (sc >> 1)) / sc : get_dc(bx, by - 8);
      if (aic_dir == 0) {
        *dir = 0;
        return a;
      }
      if (aic_dir == 1) {
        *dir = n == 0 ? 1 : 0;
        return n == 0 ? cc : a;
      }
      if (aic_dir == 2) {
        *dir = n == 0 ? 0 : 1;
        return n == 0 ? a : cc;
      }
      *dir = 1;
      return cc;
    }
    if (std::abs(a - b) < std::abs(b - cc)) {
      *dir = 1;
      return cc;
    }
    *dir = 0;
    return a;
  }
  if (std::abs(a - b) <= std::abs(b - cc)) {
    *dir = 1;
    return cc;
  }
  *dir = 0;
  return a;
}

// ff_msmpeg4_decode_dc, the level into blk[0], the predictor updated
void Decoder::intra_dc(Bits& b, int n, int16_t* blk, int* dir) {
  const Tables& t = tables();
  int level;
  if (version == V2) {
    level = t.v2_dc[n >= 4].read(b, "DC") - 256;
  } else {
    level = t.dc[dc_index][n >= 4].read(b, "DC");
    if (level == DC_MAX) {
      level = (int)b.u(8);
      if (b.u(1)) level = -level;
    } else if (level && b.u(1)) {
      level = -level;
    }
  }
  int sc = scale(n);
  level += pred_dc(n, sc, dir);
  int16_t& kept = n < 4 ? dc[0][bi(2 * mx + (n & 1), 2 * my + (n >> 1))] : dc[n - 3][ci(mx, my)];
  kept = (int16_t)(level * sc);
  if (level < 0) {
    if (inter_intra) level = 0;
  } else if (level > 256 * sc && !inter_intra) {
    corrupt("a DC level past 256 times its scale");
  }
  blk[0] = (int16_t)level;
}

// ff_mpeg4_pred_ac: the first row or column added from the block left (dir
// 0) or above (dir 1), and this block's kept; one qscale a picture, so no
// rescale
void Decoder::pred_ac(int16_t* blk, int n, int dir) {
  int c = n < 4 ? 0 : n - 3;
  int x = n < 4 ? 2 * mx + (n & 1) : mx, y = n < 4 ? 2 * my + (n >> 1) : my;
  auto idx = [&](int xx, int yy) { return n < 4 ? bi(xx, yy) : ci(xx, yy); };
  if (ac_pred) {
    if (dir == 0) {
      const std::array<int16_t, 16>& l = ac[c][idx(x - 1, y)];
      for (int i = 1; i < 8; ++i) blk[8 * i] = (int16_t)(blk[8 * i] + l[i]);
    } else {
      const std::array<int16_t, 16>& t = ac[c][idx(x, y - 1)];
      for (int i = 1; i < 8; ++i) blk[i] = (int16_t)(blk[i] + t[8 + i]);
    }
  }
  std::array<int16_t, 16>& mine = ac[c][idx(x, y)];
  for (int i = 1; i < 8; ++i) {
    mine[i] = blk[8 * i];
    mine[8 + i] = blk[i];
  }
}

// ff_msmpeg4_decode_block: an intra block's DC and coefficients (not yet
// dequantised) or an inter block's (dequantised by qscale), along scan (of
// `positions` entries: ABT's halves have 32)
void Decoder::block(Bits& b, int16_t* blk, int n, bool coded_bit, bool intra,
                    const uint8_t* scan, int* last, int positions) {
  const Tables& t = tables();
  int qmul, qadd, i, run_diff, dir = -1;
  const RlTable* rl;
  if (intra) {
    qmul = 1;
    qadd = 0;
    intra_dc(b, n, blk, &dir);
    rl = &t.rl[n < 4 ? rl_index : 3 + rl_chroma_index];
    run_diff = version >= WMV1;
    i = 0;
    if (!coded_bit) {
      pred_ac(blk, n, dir);
      *last = ac_pred ? 63 : 0;
      return;
    }
    scan = ac_pred ? (dir == 0 ? WMV1_SCANS + 192 : WMV1_SCANS + 128)
                   : (version >= WMV1 ? WMV1_SCANS + 64 : ZIGZAG);
    if (ac_pred && version < WMV1) scan = dir == 0 ? ALT_V : ALT_H;
  } else {
    qmul = qscale << 1;
    qadd = (qscale - 1) | 1;
    i = -1;
    rl = &t.rl[3 + rl_index];
    run_diff = version != V2;
    if (!coded_bit) {
      *last = -1;
      return;
    }
  }
  for (;;) {
    int sym = rl->vlc.read(b, "run-level");
    int level, run, lst;
    if (sym != rl->n) {
      run = rl->run[sym] + 1;
      level = rl->level[sym] * qmul + qadd;
      lst = sym >= rl->last;
      i += run;
      if (b.u(1)) level = -level;
    } else {
      uint32_t cache = b.peek32();
      if (!(cache & 0x80000000u)) {
        if (!(cache & 0x40000000u)) {
          // escape 3
          b.skip(2);
          if (version <= V3) {
            lst = (int)b.u(1);
            run = (int)b.u(6);
            level = b.s(8);
          } else {
            lst = (int)b.u(1);
            if (!esc3_level) {
              int ll;
              if (qscale < 8) {
                ll = (int)b.u(3);
                if (ll == 0) ll = 8 + (int)b.u(1);
              } else {
                ll = 2;
                while (ll < 8 && b.u(1) == 0) ++ll;
              }
              esc3_level = ll;
              esc3_run = (int)b.u(2) + 3;
            }
            run = (int)b.u(esc3_run);
            int sign = (int)b.u(1);
            level = (int)b.u(esc3_level);
            if (sign) level = -level;
          }
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
          i += run + 1;
        } else {
          // escape 2: the run beyond RMAX
          b.skip(2);
          int s2 = rl->vlc.read(b, "run-level");
          if (s2 == rl->n) corrupt("an escape inside escape 2");
          run = rl->run[s2] + 1;
          int l = rl->level[s2];
          level = l * qmul + qadd;
          lst = s2 >= rl->last;
          i += run + rl->max_run[lst * 64 + l] + run_diff;
          if (b.u(1)) level = -level;
        }
      } else {
        // escape 1: the level beyond LMAX
        b.skip(1);
        int s1 = rl->vlc.read(b, "run-level");
        if (s1 == rl->n) corrupt("an escape inside escape 1");
        run = rl->run[s1] + 1;
        lst = s1 >= rl->last;
        level = rl->level[s1] * qmul + qadd + rl->max_level[lst * 64 + run - 1] * qmul;
        i += run;
        if (b.u(1)) level = -level;
      }
    }
    if (lst) {
      if (i >= positions) corrupt("a block's coefficients run past its scan");
      blk[scan[i]] = (int16_t)level;
      break;
    }
    if (i >= positions - 1) corrupt("a block's coefficients run past its scan with no last one");
    blk[scan[i]] = (int16_t)level;
  }
  if (intra) {
    pred_ac(blk, n, dir);
    if (ac_pred) i = 63;
  }
  if (version >= WMV1 && i > 0) i = 63;
  *last = i;
}

// ff_h263_pred_motion: the median of the left, above and above-right
// vectors; on a slice's first row the left one (0 at its first MB)
void Decoder::pred_mv(int& px, int& py) const {
  const std::array<int, 2>& a = mv[ci(mx - 1, my)];
  if (first_line) {
    px = mx == 0 ? 0 : a[0];
    py = mx == 0 ? 0 : a[1];
    return;
  }
  const std::array<int, 2>& bb = mv[ci(mx, my - 1)];
  const std::array<int, 2>& c = mv[ci(mx + 1, my - 1)];
  px = mid_pred(a[0], bb[0], c[0]);
  py = mid_pred(a[1], bb[1], c[1]);
}

// wmv2_pred_motion: left or above by a bit where top_left_mv_flag allows
// and they differ by 8 or more, else H.263's median (its first row: left)
void Decoder::wmv2_pred_mv(Bits& b, int& px, int& py) {
  const std::array<int, 2>& a = mv[ci(mx - 1, my)];
  const std::array<int, 2>& bb = mv[ci(mx, my - 1)];
  const std::array<int, 2>& c = mv[ci(mx + 1, my - 1)];
  int diff = 0;
  if (mx && !first_line && !mspel && top_left_mv_flag)
    diff = std::max(std::abs(a[0] - bb[0]), std::abs(a[1] - bb[1]));
  int type = diff >= 8 ? (int)b.u(1) : 2;
  if (type == 0) {
    px = a[0];
    py = a[1];
  } else if (type == 1) {
    px = bb[0];
    py = bb[1];
  } else if (first_line) {
    px = a[0];
    py = a[1];
  } else {
    px = mid_pred(a[0], bb[0], c[0]);
    py = mid_pred(a[1], bb[1], c[1]);
  }
}

// msmpeg4v34_decode_motion: a vector from the MV table (or 6 + 6 bits),
// offset by 32 from the predictor, wrapped into (-64, 64)
void Decoder::read_mv(Bits& b, int& px, int& py) {
  int sym = tables().mv[mv_index].read(b, "motion vector");
  int x, y;
  if (sym) {
    x = sym >> 8;
    y = sym & 0xFF;
  } else {
    x = (int)b.u(6);
    y = (int)b.u(6);
  }
  x += px - 32;
  y += py - 32;
  if (x <= -64) x += 64;
  else if (x >= 64) x -= 64;
  if (y <= -64) y += 64;
  else if (y >= 64) y -= 64;
  px = x;
  py = y;
}

// msmpeg4v2_decode_motion: H.263's motion code at f_code 1, wrapped
int Decoder::v2_mv(Bits& b, int pred) {
  int code = tables().h263_mv.read(b, "motion code");
  if (code == 0) return pred;
  int val = b.u(1) ? -code : code;
  val += pred;
  if (val <= -64) val += 64;
  else if (val >= 64) val -= 64;
  return val;
}

// the MB's prediction from ref: H.263's half-sample 16x16 (and its chroma
// vector), or WMV2's mspel (ff_mspel_motion: its position held within
// [-16, width] x [-16, height], the fraction dropped at the ends)
void Decoder::motion(const Frame& ref, Frame& out, int vx, int vy) {
  uint8_t win[19 * 19], blk[16 * 16];
  Plane& y = out.p[0];
  if (mspel) {
    int dxy = 2 * ((vy & 1) << 1 | (vx & 1)) + hshift;
    int sx = clip3(-16, width, 16 * mx + (vx >> 1)), sy = clip3(-16, height, 16 * my + (vy >> 1));
    if (sx <= -16 || sx >= width) dxy &= ~3;
    if (sy <= -16 || sy >= height) dxy &= ~4;
    fetch(ref.p[0], sx - 1, sy - 1, 19, win);
    for (int k = 0; k < 4; ++k)
      mspel8(dxy, win + 20 + 8 * (k & 1) + 19 * 8 * (k >> 1), 19,
             y.at(16 * mx + 8 * (k & 1), 16 * my + 8 * (k >> 1)), y.w);
    int fx = (vx & 3) != 0, fy = (vy & 3) != 0;
    int cx = clip3(-8, width >> 1, 8 * mx + (vx >> 2)), cy = clip3(-8, height >> 1, 8 * my + (vy >> 2));
    if (cx == width >> 1) fx = 0;
    if (cy == height >> 1) fy = 0;
    for (int c = 1; c < 3; ++c) {
      fetch(ref.p[c], cx, cy, 9, win);
      hpel_mc(win, fx, fy, 8, no_rounding, blk);
      for (int r = 0; r < 8; ++r) memcpy(out.p[c].at(8 * mx, 8 * my + r), blk + 8 * r, 8);
    }
    return;
  }
  fetch(ref.p[0], 16 * mx + (vx >> 1), 16 * my + (vy >> 1), 17, win);
  hpel_mc(win, vx & 1, vy & 1, 16, no_rounding, blk);
  for (int r = 0; r < 16; ++r) memcpy(y.at(16 * mx, 16 * my + r), blk + 16 * r, 16);
  int cx = (vx >> 1) | (vx & 1), cy = (vy >> 1) | (vy & 1);
  for (int c = 1; c < 3; ++c) {
    fetch(ref.p[c], 8 * mx + (cx >> 1), 8 * my + (cy >> 1), 9, win);
    hpel_mc(win, cx & 1, cy & 1, 8, no_rounding, blk);
    for (int r = 0; r < 8; ++r) memcpy(out.p[c].at(8 * mx, 8 * my + r), blk + 8 * r, 8);
  }
}

// an MB's blocks into the picture: intra ones dequantised (DC by its scale,
// AC by H.263's rule) and written, inter ones added (WMV2: its IDCT or
// ABT's halves)
void Decoder::reconstruct(Frame& out, int16_t blocks[6][64], int16_t abt2[6][64],
                          const int* last, const int* abt, bool intra) {
  int qmul = qscale << 1, qadd = (qscale - 1) | 1;
  for (int n = 0; n < 6; ++n) {
    Plane& p = out.p[n < 4 ? 0 : n - 3];
    uint8_t* dst = n < 4 ? p.at(16 * mx + 8 * (n & 1), 16 * my + 8 * (n >> 1)) : p.at(8 * mx, 8 * my);
    int16_t* blk = blocks[n];
    if (intra) {
      blk[0] = (int16_t)(blk[0] * scale(n));
      for (int k = 1; k < 64; ++k)
        if (blk[k]) blk[k] = (int16_t)(blk[k] < 0 ? blk[k] * qmul - qadd : blk[k] * qmul + qadd);
      if (version == WMV2) wmv2_idct_out(blk, dst, p.w, false);
      else simple_idct_out(blk, dst, p.w, false);
    } else if (last[n] >= 0) {
      if (version != WMV2) {
        simple_idct_out(blk, dst, p.w, true);
      } else if (abt[n] == 0) {
        wmv2_idct_out(blk, dst, p.w, true);
      } else if (abt[n] == 1) {
        idct84_add(dst, p.w, blk);
        idct84_add(dst + 4 * p.w, p.w, abt2[n]);
      } else {
        idct48_add(dst, p.w, blk);
        idct48_add(dst + 4, p.w, abt2[n]);
      }
    }
  }
}

// FFmpeg's H.263 loop filter across one 8-sample edge (h263dsp.c): the
// vertical filter smooths across a horizontal edge at src (rows -2 ... 1)
void edge_filter(uint8_t* src, int step, int along, int q) {
  const int strength = LOOP_FILTER_STRENGTH[q];
  for (int k = 0; k < 8; ++k) {
    uint8_t* s = src + k * along;
    int p0 = s[-2 * step], p1 = s[-step], p2 = s[0], p3 = s[step];
    int d = (p0 - p3 + 4 * (p2 - p1)) / 8;
    int d1;
    if (d < -2 * strength) d1 = 0;
    else if (d < -strength) d1 = -2 * strength - d;
    else if (d < strength) d1 = d;
    else if (d < 2 * strength) d1 = 2 * strength - d;
    else d1 = 0;
    p1 += d1;
    p2 -= d1;
    if (p1 & 256) p1 = ~(p1 >> 31);
    if (p2 & 256) p2 = ~(p2 >> 31);
    s[-step] = (uint8_t)p1;
    s[0] = (uint8_t)p2;
    int ad1 = std::abs(d1) >> 1;
    int d2 = clip3(-ad1, ad1, (p0 - p3) / 4);
    s[-2 * step] = (uint8_t)(p0 - d2);
    s[step] = (uint8_t)(p3 + d2);
  }
}

// ff_h263_loop_filter of the MB just reconstructed: its inner edges, those
// with the MB above and left (and the picture's last row), skipped MBs
// taking no qscale
void Decoder::loop_filter_mb(Frame& out) {
  Plane &Y = out.p[0], &U = out.p[1], &V = out.p[2];
  const int ls = Y.w, us = U.w;
  uint8_t* dy = Y.at(16 * mx, 16 * my);
  uint8_t* du = U.at(8 * mx, 8 * my);
  uint8_t* dv = V.at(8 * mx, 8 * my);
  auto skip = [&](int x, int y) { return skipped[(size_t)y * mbw + x] != 0; };
  auto vf = [&](uint8_t* s, int stride, int q) { edge_filter(s, stride, 1, q); };
  auto hf = [&](uint8_t* s, int stride, int q) { edge_filter(s, 1, stride, q); };
  int qp_c = 0;
  if (!skip(mx, my)) {
    qp_c = qscale;
    vf(dy + 8 * ls, ls, qp_c);
    vf(dy + 8 * ls + 8, ls, qp_c);
  }
  if (my) {
    int qp_tt = skip(mx, my - 1) ? 0 : qscale;
    int qp_tc = qp_c ? qp_c : qp_tt;
    if (qp_tc) {
      vf(dy, ls, qp_tc);
      vf(dy + 8, ls, qp_tc);
      vf(du, us, qp_tc);
      vf(dv, us, qp_tc);
    }
    if (qp_tt) hf(dy - 8 * ls + 8, ls, qp_tt);
    if (mx) {
      int qp_dt = (qp_tt || skip(mx - 1, my - 1)) ? qp_tt : qscale;
      if (qp_dt) {
        hf(dy - 8 * ls, ls, qp_dt);
        hf(du - 8 * us, us, qp_dt);
        hf(dv - 8 * us, us, qp_dt);
      }
    }
  }
  if (qp_c) {
    hf(dy + 8, ls, qp_c);
    if (my + 1 == mbh) hf(dy + 8 * ls + 8, ls, qp_c);
  }
  if (mx) {
    int qp_lc = (qp_c || skip(mx - 1, my)) ? qp_c : qscale;
    if (qp_lc) {
      hf(dy, ls, qp_lc);
      if (my + 1 == mbh) {
        hf(dy + 8 * ls, ls, qp_lc);
        hf(du, us, qp_lc);
        hf(dv, us, qp_lc);
      }
    }
  }
}

// one MB: msmpeg4v12_decode_mb, msmpeg4v34_decode_mb or wmv2_decode_mb, its
// prediction made in the current picture, its blocks read; MB_INTER,
// MB_INTRA or MB_SKIPPED
int Decoder::macroblock(Bits& b, int16_t blocks[6][64], int16_t abt2[6][64], int* last,
                         int* abt) {
  const Tables& t = tables();
  Frame& out = frames[cur];
  const Frame& ref = frames[cur ^ 1];
  int cbp = 0;
  bool intra;
  std::array<int, 2>& mine = mv[ci(mx, my)];
  for (int n = 0; n < 6; ++n) {
    memset(blocks[n], 0, sizeof(blocks[n]));
    memset(abt2[n], 0, sizeof(abt2[n]));
    abt[n] = 0;
  }
  hshift = 0;
  // a skipped MB: the reference's MB
  bool skip = false;
  if (pict == PICT_P) {
    if (version == WMV2) skip = skipped[(size_t)my * mbw + mx] != 0;
    else if (use_skip) skip = b.u(1) != 0;
  }
  if (skip) {
    mine = {0, 0};
    motion(ref, out, 0, 0);
    return MB_SKIPPED;
  }
  if (version == V2) {
    if (pict == PICT_P) {
      int code = t.v2_mb_type.read(b, "v2 MB type");
      intra = code >> 2;
      cbp = code & 3;
    } else {
      intra = true;
      cbp = t.v2_intra_cbpc.read(b, "v2 intra cbpc");
    }
    if (!intra) {
      cbp |= t.cbpy.read(b, "cbpy") << 2;
      if ((cbp & 3) != 3) cbp ^= 0x3C;
      int px, py;
      pred_mv(px, py);
      int vx = v2_mv(b, px), vy = v2_mv(b, py);
      mine = {vx, vy};
      motion(ref, out, vx, vy);
    } else {
      ac_pred = (int)b.u(1);
      cbp |= t.cbpy.read(b, "cbpy") << 2;
    }
  } else {
    if (pict == PICT_P) {
      int code = t.mb_non_intra[version == WMV2 ? cbp_index : 3].read(b, "MB code");
      intra = !(code & 0x40);
      cbp = code & 0x3F;
    } else {
      intra = true;
      int code = t.mb_i.read(b, "I MB code");
      for (int n = 0; n < 6; ++n) {
        int val = code >> (5 - n) & 1;
        if (n < 4) {
          int x = 2 * mx + (n & 1), y = 2 * my + (n >> 1);
          int a = coded[bi(x - 1, y)], bb = coded[bi(x - 1, y - 1)], c = coded[bi(x, y - 1)];
          val ^= bb == c ? a : c;
          coded[bi(x, y)] = (uint8_t)val;
        }
        cbp |= val << (5 - n);
      }
    }
    if (!intra) {
      int px, py;
      if (version == WMV2) {
        wmv2_pred_mv(b, px, py);
        if (cbp) {
          if (per_mb_rl) rl_index = rl_chroma_index = b.u012();
          if (abt_flag && per_mb_abt) {
            per_block_abt = (int)b.u(1);
            if (!per_block_abt) abt_type = b.u012();
          } else {
            per_block_abt = 0;
          }
        }
        read_mv(b, px, py);
        hshift = ((px | py) & 1) && mspel ? (int)b.u(1) : 0;
      } else {
        if (per_mb_rl && cbp) rl_index = rl_chroma_index = b.u012();
        pred_mv(px, py);
        read_mv(b, px, py);
      }
      mine = {px, py};
      motion(ref, out, px, py);
    } else {
      ac_pred = (int)b.u(1);
      if (inter_intra) aic_dir = t.inter_intra.read(b, "inter-intra direction");
      if (per_mb_rl && cbp) rl_index = rl_chroma_index = b.u012();
    }
  }
  if (intra) {
    mine = {0, 0};
    for (int n = 0; n < 6; ++n) block(b, blocks[n], n, cbp >> (5 - n) & 1, true, nullptr, &last[n]);
    return MB_INTRA;
  }
  for (int n = 0; n < 6; ++n) {
    bool c = cbp >> (5 - n) & 1;
    if (version == WMV2 && c) {
      // wmv2_decode_inter_block: ABT's 8x4 / 4x8 halves, each coded or not
      if (per_block_abt) abt_type = b.u012();
      abt[n] = abt_type;
      if (abt_type) {
        static const int sub_cbp[3] = {2, 3, 1};
        int sc = sub_cbp[b.u012()];
        const uint8_t* scan = abt_type == 1 ? WMV2_SCAN_A : WMV2_SCAN_B;
        int l;
        if (sc & 1) block(b, blocks[n], n, true, false, scan, &l, 32);
        if (sc & 2) block(b, abt2[n], n, true, false, scan, &l, 32);
        last[n] = 63;
        continue;
      }
    }
    block(b, blocks[n], n, c, false, version >= WMV1 ? WMV1_SCANS : ZIGZAG, &last[n]);
  }
  return MB_INTER;
}

int Decoder::picture(const uint8_t* data, size_t n) {
  Bits b(data, n);
  if (version == WMV2) {
    pict = (int)b.u(1) + 1;
    if (pict == PICT_I) b.u(7);
    qscale = (int)b.u(5);
    if (!qscale) corrupt("qscale 0");
    if (pict == PICT_P && (b.peek32() >> 31)) {
      // a skip map of every MB skipped: FFmpeg shows no frame
      Bits p = b;
      int type = (int)p.u(2), run = type == 3 ? mbw : mbh;
      while (run > 0) {
        int k = std::min(run, 25);
        if (p.left() < k || (int)p.u(k) + 1 != 1 << k) break;
        run -= k;
      }
      if (!run) return SKIPPED;
    }
    wmv2_header(b);
  } else {
    header(b);
  }
  if (!slice_height) corrupt("more slices than MB rows");
  ++pictures;
  if (pict == PICT_P && !have_ref) grey(frames[cur ^ 1]);
  // the predictors as FFmpeg has them at a picture's start: every non-intra
  // MB's are reset as it is decoded, so only this picture's intra MBs differ
  for (int c = 0; c < 3; ++c) {
    std::fill(dc[c].begin(), dc[c].end(), (int16_t)1024);
    std::fill(ac[c].begin(), ac[c].end(), std::array<int16_t, 16>{});
  }
  std::fill(coded.begin(), coded.end(), 0);
  std::fill(mv.begin(), mv.end(), std::array<int, 2>{0, 0});
  Frame& out = frames[cur];
  int16_t blocks[6][64], abt2[6][64];
  int last[6], abt[6];
  for (my = 0; my < mbh; ++my) {
    first_line = my % slice_height == 0;
    if (first_line && my && version < WMV1) {
      // ff_mpeg4_clean_buffers: the AC predictors of the row above
      for (int x = -1; x <= 2 * mbw; ++x) ac[0][bi(x, 2 * my - 1)] = {};
      for (int x = -1; x <= mbw; ++x) ac[1][ci(x, my - 1)] = ac[2][ci(x, my - 1)] = {};
    }
    for (mx = 0; mx < mbw; ++mx) {
      int kind = macroblock(b, blocks, abt2, last, abt);
      if (kind != MB_SKIPPED) reconstruct(out, blocks, abt2, last, abt, kind == MB_INTRA);
      if (version == WMV2 && loop_filter) loop_filter_mb(out);
    }
  }
  if (version <= V3 && pict == PICT_I) ext_header(b, b.left());
  cur ^= 1;
  have_ref = true;
  return SHOWN;
}

template <class F>
int guard(Decoder* d, F f) {
  try {
    return f();
  } catch (const Unsupported& e) {
    d->error = "picture " + std::to_string(d->pictures) + ": " + e.what();
    return -2;
  } catch (const Corrupt& e) {
    d->error = "picture " + std::to_string(d->pictures) + ": " + e.what();
    return -1;
  } catch (const std::bad_alloc&) {
    d->error = "out of memory";
    return -1;
  } catch (const std::exception& e) {
    d->error = e.what();
    return -1;
  }
}

}  // namespace

extern "C" {

void* msd_new() {
  try {
    tables();
    return new Decoder();
  } catch (...) {
    return nullptr;
  }
}

void msd_free(void* h) { delete static_cast<Decoder*>(h); }

// the version (2: MS MPEG-4 v2, 3: v3, 4: WMV1, 5: WMV2), the container's
// picture size and extradata (WMV2's extended header); 0, or -1 / -2 as
// msd_decode
int msd_init(void* h, int version, int width, int height, const uint8_t* extra, int n) {
  Decoder* d = static_cast<Decoder*>(h);
  return guard(d, [&] {
    d->init(version, width, height, extra, n);
    return 0;
  });
}

// one packet, one picture: 0 decoded, 1 skipped whole (WMV2; no frame), -1
// corrupt, -2 a tool the port does not decode (msd_error says which)
int msd_decode(void* h, const uint8_t* data, int64_t size) {
  Decoder* d = static_cast<Decoder*>(h);
  return guard(d, [&] { return d->picture(data, (size_t)size); });
}

// copy the last picture decoded out (Y' width x height, Cb and Cr rounded up)
int msd_take(void* h, uint8_t* y, uint8_t* cb, uint8_t* cr) {
  Decoder* d = static_cast<Decoder*>(h);
  if (!d->have_ref) return 1;
  const Frame& f = d->frames[d->cur ^ 1];
  int w = d->width, hh = d->height, cw = (w + 1) / 2, ch = (hh + 1) / 2;
  for (int r = 0; r < hh; ++r) memcpy(y + (size_t)r * w, f.p[0].px.data() + (size_t)r * f.p[0].w, w);
  for (int r = 0; r < ch; ++r) {
    memcpy(cb + (size_t)r * cw, f.p[1].px.data() + (size_t)r * f.p[1].w, cw);
    memcpy(cr + (size_t)r * cw, f.p[2].px.data() + (size_t)r * f.p[2].w, cw);
  }
  return 0;
}

const char* msd_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

}  // extern "C"
