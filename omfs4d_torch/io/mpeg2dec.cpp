// MPEG-1 video (ISO/IEC 11172-2) and MPEG-2 video (ISO/IEC 13818-2, Main
// profile 4:2:0 frame pictures, up to High level) decoding on the host, as FFmpeg's
// mpeg1video / mpeg2video decoders (mpeg12dec.c, mpegvideo_motion.c) decode
// them inside cv2, for a machine with no ffmpeg.  Built by g++ at first use
// (omfs4d_torch/native.py) and bound with ctypes by omfs4d_torch/io/mpeg2.py;
// the tables come from mpeg2_tables.py as the generated header
// mpeg2_tables.h, the IDCT from simple_idct.h (FFmpeg's simple IDCT, as for
// MPEG-4 Part 2: the same idctdsp).
//
// Covered: sequence headers (loaded matrices, MPEG-1's constrained flag),
// the sequence extension (profile and level, progressive_sequence, the size
// and bit-rate extensions, low_delay), the quant matrix extension (chroma
// matrices too), GOP headers, picture headers (MPEG-1's full_pel vectors
// and f_codes), the picture coding extension (four f_codes,
// intra_dc_precision 8-11, frame_pred_frame_dct, concealment vectors,
// q_scale_type, intra_vlc_format, alternate_scan); slices
// (slice_vertical_position_extension, quantiser_scale_code linear and
// non-linear, extra information, MPEG-1 slices spanning rows); the
// macroblock address increment with escape and stuffing, skipped
// macroblocks (P: zero vector, predictors reset; B: the previous vectors
// and directions), macroblock_type of I, P and B, frame motion types and
// dct_type; motion vectors with f_code residuals, frame, field (the frame /
// field vector scaling, either parity) and dual-prime prediction of frame
// pictures of progressive and interlaced sequences, field DCT; DC by
// dct_dc_size, Tables B.14 / B.15, MPEG-1's 8 / 16-bit and MPEG-2's 12-bit
// escapes, both scans.
//
// Where FFmpeg departs from the standard this follows FFmpeg:
// - dequantisation is mpeg12dec.c's inline one: MPEG-1's oddification
//   ((level - 1) | 1) with no clamp, MPEG-2's with no saturation (a level
//   out of range is stored into 16 bits as it wraps), mismatch control on
//   coefficient 63 from the unsaturated levels;
// - a loaded intra matrix's first value is taken as 8 whatever it is;
// - a skipped B macroblock reuses the previous vectors as frame vectors
//   (a field vector's vertical part doubled), and an MPEG-1 full_pel
//   picture's skipped B macroblock its vectors unscaled;
// - a P picture with no reference before it (after a sequence header)
//   predicts from FFmpeg's grey dummy picture, and is not shown until the
//   next reference; a B picture of an open GOP with no past reference is
//   not decoded; a P picture before any sequence or GOP header or I
//   picture is not decoded;
// - pictures are shown as FFmpeg outputs them: a B picture at once, an I
//   or P picture when the next I or P starts (at once where low_delay),
//   the last at the flush.
// What FFmpeg decodes in a way that cannot be followed throws Unsupported
// naming it: field pictures (cv2 5.0.0's FFmpeg decodes a field pair into
// the frame's top half), 4:2:2 / 4:4:4, a motion vector that reaches past
// the picture's edge (FFmpeg skips the prediction and leaves the buffer's
// old bytes), a prediction from a picture the stream does not hold, a
// change of the picture size, MPEG-1 D-pictures, the scalable extensions.
// A slice missing from the picture, which FFmpeg conceals, throws Corrupt,
// as does a read past the data or a value out of range.  Neither crosses
// the C API: each entry point returns 0, 1 (corrupt) or 2 (unsupported) and
// keeps the message for mp2d_error.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "mpeg2_tables.h"

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& s) : std::runtime_error(s) {}
};
struct Unsupported : std::runtime_error {
  explicit Unsupported(const std::string& s) : std::runtime_error(s) {}
};

[[noreturn]] void corrupt(const std::string& what) { throw Corrupt("MPEG-1/2 video: " + what); }
[[noreturn]] void unsupported(const std::string& what) { throw Unsupported("MPEG-1/2 " + what); }

inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

#include "simple_idct.h"

// ── bits ─────────────────────────────────────────────────────────────────

struct Bits {
  const uint8_t* d = nullptr;
  size_t nbytes = 0;
  int64_t nbits = 0, pos = 0;

  Bits(const uint8_t* data, size_t n) : d(data), nbytes(n), nbits((int64_t)n * 8) {}
  // the 32 bits from pos, zeros past the end (FFmpeg's padding)
  uint32_t peek32() const {
    size_t byte = (size_t)(pos >> 3);
    uint64_t v = 0;
    for (int i = 0; i < 5; ++i) v = v << 8 | (byte + i < nbytes ? d[byte + i] : 0);
    return (uint32_t)(v >> (8 - (pos & 7)));
  }
  void skip(int n) { pos += n; }
  uint32_t u(int n) {
    if (n == 0) return 0;
    uint32_t v = peek32() >> (32 - n);
    pos += n;
    return v;
  }
  int s(int n) {  // n bits, two's complement
    int v = (int)u(n);
    return v >= 1 << (n - 1) ? v - (1 << n) : v;
  }
  int64_t left() const { return nbits - pos; }
};

// a prefix code of at most 16 bits read through a table of 2^16 entries
struct Vlc {
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  Vlc(const uint16_t* codes, int n) : sym(65536, -1), len(65536, 0) {
    for (int s = 0; s < n; ++s) {
      int c = codes[2 * s], l = codes[2 * s + 1];
      if (l == 0) continue;
      for (int j = 0; j < 1 << (16 - l); ++j) {
        sym[(c << (16 - l)) | j] = (int16_t)s;
        len[(c << (16 - l)) | j] = (uint8_t)l;
      }
    }
  }
  int read(Bits& b) const {
    uint32_t p = b.peek32() >> 16;
    int s = sym[p];
    if (s >= 0) b.skip(len[p]);
    return s;
  }
};

struct Tables {
  Vlc incr, ptype, btype, cbp, motion, dc_luma, dc_chroma, b14, b15;
  Tables()
      : incr(MB_INCREMENT, 36), ptype(MB_TYPE_P, 7), btype(MB_TYPE_B, 11), cbp(CBP, 64),
        motion(MOTION, 17), dc_luma(DC_LUMA, 12), dc_chroma(DC_CHROMA, 12), b14(B14, 113),
        b15(B15, 113) {}
};

const Tables& vlc() {
  static const Tables t;
  return t;
}

constexpr int ESC = 111, EOB = 112;
constexpr int F_INTRA = 1, F_PATTERN = 2, F_BACKWARD = 4, F_FORWARD = 8, F_QUANT = 16;
constexpr int PICT_FRAME = 3;
constexpr int MV_16X16 = 0, MV_FIELD = 1, MV_DMV = 3;

// ── pictures ─────────────────────────────────────────────────────────────

struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  void alloc(int ww, int hh, uint8_t fill) {
    w = ww;
    h = hh;
    px.assign((size_t)ww * hh, fill);
  }
  uint8_t* row(int y) { return px.data() + (size_t)y * w; }
  const uint8_t* row(int y) const { return px.data() + (size_t)y * w; }
};

struct Pic {
  Plane p[3];  // whole macroblocks
  bool dummy = false;
  int64_t tag = -1;
  std::vector<uint8_t> done;      // each MB decoded, per field parity bit
  std::vector<int> mb_intra;      // the MB's type was intra (for B skips)
};

using PicPtr = std::shared_ptr<Pic>;

// FFmpeg's hpeldsp with rounding (put_pixels / avg_pixels): a w x h block
// from src (half flags hx, hy) into dst, written or averaged rounding up;
// both with stride `stride` (lines of the plane)
void hpel(uint8_t* dst, const uint8_t* src, ptrdiff_t stride, int w, int h, int hx, int hy,
          bool avg) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + y * stride;
    uint8_t* d = dst + y * stride;
    for (int x = 0; x < w; ++x) {
      int v;
      if (!hx && !hy)
        v = s[x];
      else if (hx && !hy)
        v = (s[x] + s[x + 1] + 1) >> 1;
      else if (!hx && hy)
        v = (s[x] + s[x + stride] + 1) >> 1;
      else
        v = (s[x] + s[x + 1] + s[x + stride] + s[x + stride + 1] + 2) >> 2;
      d[x] = avg ? (uint8_t)((d[x] + v + 1) >> 1) : (uint8_t)v;
    }
  }
}

void idct_put(int16_t* blk, uint8_t* dst, ptrdiff_t stride) {
  int out[64];
  simple_idct(blk, out);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) dst[r * stride + c] = clip1(out[8 * r + c]);
}

void idct_add(int16_t* blk, uint8_t* dst, ptrdiff_t stride) {
  int out[64];
  simple_idct(blk, out);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) dst[r * stride + c] = clip1(dst[r * stride + c] + out[8 * r + c]);
}

// ── the decoder ──────────────────────────────────────────────────────────


struct Decoder {
  // sequence
  bool have_seq = false, initialized = false, mpeg2 = false;
  int width = 0, height = 0, mb_width = 0, mb_height = 0;
  int init_width = 0, init_height = 0, init_prog = -1;
  int progressive_sequence = 1, chroma_format = 1, low_delay = 0;
  uint16_t intra_matrix[64], inter_matrix[64], chroma_intra_matrix[64], chroma_inter_matrix[64];
  // GOP / sync
  bool sync = false, closed_gop = false;
  // picture
  int pict_type = 0, full_pel[2] = {0, 0}, f_code[2][2] = {{1, 1}, {1, 1}};
  int intra_dc_precision = 0, picture_structure = PICT_FRAME, top_field_first = 0;
  int frame_pred_frame_dct = 1, concealment_mv = 0, q_scale_type = 0, intra_vlc_format = 0;
  int alternate_scan = 0;
  const uint8_t* scan = ZIGZAG;
  // references and the frame being decoded
  PicPtr last, next, cur;
  std::deque<PicPtr> out;
  std::string error;
  // macroblock state
  int mb_x = 0, mb_y = 0, qscale = 0, mb_skip_run = 0, interlaced_dct = 0;
  int last_dc[3] = {0, 0, 0};
  int mv_dir = 0, mv_type = 0, mb_intra = 0;
  int mv[2][4][2], last_mv[2][2][2], field_select[2][2];
  int16_t blocks[6][64];
  int block_last[6];

  Decoder() {
    default_matrices(true, true);
    std::memset(mv, 0, sizeof mv);
    std::memset(last_mv, 0, sizeof last_mv);
    std::memset(field_select, 0, sizeof field_select);
  }

  void default_matrices(bool intra, bool inter) {
    for (int i = 0; i < 64; ++i) {
      if (intra) intra_matrix[i] = chroma_intra_matrix[i] = DEFAULT_INTRA_MATRIX[i];
      if (inter) inter_matrix[i] = chroma_inter_matrix[i] = 16;
    }
  }

  void load_matrix(Bits& b, uint16_t* m0, uint16_t* m1, bool intra) {
    for (int i = 0; i < 64; ++i) {
      int j = ZIGZAG[i];
      int v = (int)b.u(8);
      if (v == 0) corrupt("a quantiser matrix holds 0 (matrix damaged)");
      if (intra && i == 0 && v != 8) v = 8;
      m0[j] = (uint16_t)v;
      if (m1) m1[j] = (uint16_t)v;
    }
  }

  // ── headers ──

  void sequence_header(Bits& b) {
    int w = (int)b.u(12), h = (int)b.u(12);
    b.u(4);  // aspect_ratio_information
    b.u(4);  // frame_rate_code
    b.u(18);
    if (!b.u(1)) corrupt("the sequence header's marker bit is 0");
    b.u(10);
    b.u(1);  // constrained_parameters_flag
    if (b.u(1))
      load_matrix(b, chroma_intra_matrix, intra_matrix, true);
    else
      default_matrices(true, false);
    if (b.u(1))
      load_matrix(b, chroma_inter_matrix, inter_matrix, false);
    else
      default_matrices(false, true);
    if (b.peek32() >> 9) corrupt("the sequence header is damaged (bits after it)");
    width = w;
    height = h;
    progressive_sequence = 1;
    picture_structure = PICT_FRAME;
    frame_pred_frame_dct = 1;
    chroma_format = 1;
    mpeg2 = false;
    have_seq = true;
  }

  void sequence_extension(Bits& b) {
    b.u(1);
    b.u(3);  // profile
    b.u(4);  // level
    progressive_sequence = (int)b.u(1);
    chroma_format = (int)b.u(2);
    if (!chroma_format) chroma_format = 1;
    width |= (int)b.u(2) << 12;
    height |= (int)b.u(2) << 12;
    b.u(12);
    b.u(1);
    b.u(8);
    low_delay = (int)b.u(1);
    b.u(2);
    b.u(5);
    mpeg2 = true;
    if (chroma_format != 1)
      unsupported(std::string("video of chroma_format ") +
                  (chroma_format == 2 ? "4:2:2" : "4:4:4") + " (only 4:2:0)");
  }

  void quant_matrix_extension(Bits& b) {
    if (b.u(1)) load_matrix(b, chroma_intra_matrix, intra_matrix, true);
    if (b.u(1)) load_matrix(b, chroma_inter_matrix, inter_matrix, false);
    if (b.u(1)) load_matrix(b, chroma_intra_matrix, nullptr, true);
    if (b.u(1)) load_matrix(b, chroma_inter_matrix, nullptr, false);
  }

  bool picture_header(Bits& b) {
    b.u(10);
    pict_type = (int)b.u(3);
    if (pict_type == 4) unsupported("video D-pictures (MPEG-1 DC-only pictures)");
    if (pict_type == 0 || pict_type > 3) return false;
    b.u(16);
    if (pict_type == 2 || pict_type == 3) {
      full_pel[0] = (int)b.u(1);
      int f = (int)b.u(3);
      f += !f;
      f_code[0][0] = f_code[0][1] = f;
    }
    if (pict_type == 3) {
      full_pel[1] = (int)b.u(1);
      int f = (int)b.u(3);
      f += !f;
      f_code[1][0] = f_code[1][1] = f;
    }
    return true;
  }

  void picture_coding_extension(Bits& b) {
    full_pel[0] = full_pel[1] = 0;
    for (int i = 0; i < 2; ++i)
      for (int k = 0; k < 2; ++k) {
        f_code[i][k] = (int)b.u(4);
        f_code[i][k] += !f_code[i][k];
      }
    intra_dc_precision = (int)b.u(2);
    picture_structure = (int)b.u(2);
    top_field_first = (int)b.u(1);
    frame_pred_frame_dct = (int)b.u(1);
    concealment_mv = (int)b.u(1);
    q_scale_type = (int)b.u(1);
    intra_vlc_format = (int)b.u(1);
    alternate_scan = (int)b.u(1);
    b.u(1);  // repeat_first_field
    b.u(1);  // chroma_420_type
    b.u(1);  // progressive_frame
    scan = alternate_scan ? ALTERNATE : ZIGZAG;
    if (picture_structure != PICT_FRAME)
      unsupported("video field pictures (cv2 5.0.0's FFmpeg decodes a field pair into the "
                  "frame's top half, its first field's lines one after another)");
  }

  // mpeg_decode_postinit: the picture buffers' size is fixed at the first
  // picture
  void postinit() {
    if (width <= 0 || height <= 0) corrupt("a picture of width or height 0");
    if (initialized) {
      if (width != init_width || height != init_height || progressive_sequence != init_prog)
        unsupported("video sequence header that changes the picture size or scan (" +
                    std::to_string(init_width) + "x" + std::to_string(init_height) + ", then " +
                    std::to_string(width) + "x" + std::to_string(height) + ")");
      return;
    }
    initialized = true;
    init_width = width;
    init_height = height;
    init_prog = progressive_sequence;
    mb_width = (width + 15) / 16;
    mb_height = (mpeg2 && !progressive_sequence) ? (height + 31) / 32 * 2 : (height + 15) / 16;
  }

  PicPtr new_pic(uint8_t fill) {
    auto p = std::make_shared<Pic>();
    p->p[0].alloc(mb_width * 16, mb_height * 16, fill);
    p->p[1].alloc(mb_width * 8, mb_height * 8, fill);
    p->p[2].alloc(mb_width * 8, mb_height * 8, fill);
    p->done.assign((size_t)mb_width * mb_height, 0);
    p->mb_intra.assign((size_t)mb_width * mb_height, 0);
    return p;
  }

  // mpeg_field_start / ff_mpv_frame_start
  void frame_start(int64_t tag) {
    cur = new_pic(0);
    cur->tag = tag;
    if (pict_type != 3) {
      last = next;
      next = cur;
    }
    if (!last && pict_type != 1) {
      if (pict_type == 3 && !next)
        unsupported("video B-picture with no reference at all before it");
      last = new_pic(128);  // FFmpeg's grey dummy picture
      last->dummy = true;
    }
  }

  // ── slices and macroblocks ──

  int get_qscale(Bits& b) {
    int q = (int)b.u(5);
    return q_scale_type ? NON_LINEAR_QSCALE[q] : q << 1;
  }

  int decode_motion(Bits& b, int fcode, int pred) {
    int code = vlc().motion.read(b);
    if (code < 0) corrupt("no motion_code matches the bits");
    if (code == 0) return pred;
    int sign = (int)b.u(1), shift = fcode - 1, val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= (int)b.u(shift);
      val++;
    }
    if (sign) val = -val;
    val += pred;
    const int bits = 5 + shift;
    val &= (1 << bits) - 1;  // sign_extend(val, 5 + shift)
    return val >= 1 << (bits - 1) ? val - (1 << bits) : val;
  }

  int get_dmv(Bits& b) {
    if (b.u(1)) return 1 - ((int)b.u(1) << 1);
    return 0;
  }

  int decode_dc(Bits& b, int component) {
    int code = (component == 0 ? vlc().dc_luma : vlc().dc_chroma).read(b);
    if (code < 0) corrupt("no dct_dc_size code matches the bits");
    if (code == 0) return 0;
    int v = (int)b.u(code);
    return v >> (code - 1) ? v : v - (1 << code) + 1;
  }

  [[noreturn]] void damaged() {
    corrupt("ac-tex damaged at macroblock " + std::to_string(mb_x) + ", " + std::to_string(mb_y));
  }

  // ff_mpeg1_decode_block_intra
  void mpeg1_intra(Bits& b, int16_t* blk, int n) {
    int component = n <= 3 ? 0 : n - 4 + 1;
    int dc = last_dc[component] + decode_dc(b, component);
    last_dc[component] = dc;
    blk[0] = (int16_t)(dc * intra_matrix[0]);
    int i = 0;
    const Vlc& t = vlc().b14;
    for (;;) {
      int sym = t.read(b);
      if (sym < 0) damaged();
      if (sym == EOB) break;
      int level, run;
      if (sym != ESC) {
        run = RUN[sym] + 1;
        level = LEVEL[sym];
        i += run;
        if (i > 63) damaged();
        int j = scan[i];
        level = (level * qscale * intra_matrix[j]) >> 4;
        level = (level - 1) | 1;
        if (b.u(1)) level = -level;
        blk[j] = (int16_t)level;
      } else {
        run = (int)b.u(6) + 1;
        level = b.s(8);
        if (level == -128)
          level = (int)b.u(8) - 256;
        else if (level == 0)
          level = (int)b.u(8);
        i += run;
        if (i > 63) damaged();
        int j = scan[i];
        if (level < 0) {
          level = -level;
          level = (level * qscale * intra_matrix[j]) >> 4;
          level = (level - 1) | 1;
          level = -level;
        } else {
          level = (level * qscale * intra_matrix[j]) >> 4;
          level = (level - 1) | 1;
        }
        blk[j] = (int16_t)level;
      }
    }
    block_last[n] = i;
  }

  // mpeg1_decode_block_inter
  void mpeg1_inter(Bits& b, int16_t* blk, int n) {
    const uint16_t* qm = inter_matrix;
    int i = -1;
    const Vlc& t = vlc().b14;
    if (b.peek32() >> 31) {  // the first coefficient's "1s"
      int level = (3 * qscale * qm[0]) >> 5;
      level = (level - 1) | 1;
      b.skip(1);
      if (b.u(1)) level = -level;
      blk[0] = (int16_t)level;
      i = 0;
      if ((b.peek32() >> 30) == 2) {
        b.skip(2);
        block_last[n] = i;
        return;
      }
    }
    for (;;) {
      int sym = t.read(b);
      if (sym < 0) damaged();
      if (sym == EOB) break;
      int level, j;
      if (sym != ESC) {
        i += RUN[sym] + 1;
        if (i > 63) damaged();
        j = scan[i];
        level = ((LEVEL[sym] * 2 + 1) * qscale * qm[j]) >> 5;
        level = (level - 1) | 1;
        if (b.u(1)) level = -level;
      } else {
        int run = (int)b.u(6) + 1;
        level = b.s(8);
        if (level == -128)
          level = (int)b.u(8) - 256;
        else if (level == 0)
          level = (int)b.u(8);
        i += run;
        if (i > 63) damaged();
        j = scan[i];
        if (level < 0) {
          level = -level;
          level = ((level * 2 + 1) * qscale * qm[j]) >> 5;
          level = (level - 1) | 1;
          level = -level;
        } else {
          level = ((level * 2 + 1) * qscale * qm[j]) >> 5;
          level = (level - 1) | 1;
        }
      }
      blk[j] = (int16_t)level;
    }
    if (i < 0) damaged();
    block_last[n] = i;
  }

  // mpeg2_decode_block_intra
  void mpeg2_intra(Bits& b, int16_t* blk, int n) {
    const uint16_t* qm = n < 4 ? intra_matrix : chroma_intra_matrix;
    int component = n < 4 ? 0 : (n & 1) + 1;
    int dc = last_dc[component] + decode_dc(b, component);
    last_dc[component] = dc;
    blk[0] = (int16_t)(dc * (1 << (3 - intra_dc_precision)));
    int mismatch = blk[0] ^ 1;
    int i = 0;
    const Vlc& t = intra_vlc_format ? vlc().b15 : vlc().b14;
    for (;;) {
      int sym = t.read(b);
      if (sym < 0) damaged();
      if (sym == EOB) break;
      int level, j;
      if (sym != ESC) {
        i += RUN[sym] + 1;
        if (i > 63) damaged();
        j = scan[i];
        level = (LEVEL[sym] * qscale * qm[j]) >> 4;
        if (b.u(1)) level = -level;
      } else {
        int run = (int)b.u(6) + 1;
        level = b.s(12);
        i += run;
        if (i > 63) damaged();
        j = scan[i];
        if (level < 0)
          level = -((-level * qscale * qm[j]) >> 4);
        else
          level = (level * qscale * qm[j]) >> 4;
      }
      mismatch ^= level;
      blk[j] = (int16_t)level;
    }
    blk[63] ^= (int16_t)(mismatch & 1);
    block_last[n] = i;
  }

  // mpeg2_decode_block_non_intra
  void mpeg2_inter(Bits& b, int16_t* blk, int n) {
    const uint16_t* qm = n < 4 ? inter_matrix : chroma_inter_matrix;
    int mismatch = 1;
    int i = -1;
    const Vlc& t = vlc().b14;
    bool done = false;
    if (b.peek32() >> 31) {
      int level = (3 * qscale * qm[0]) >> 5;
      b.skip(1);
      if (b.u(1)) level = -level;
      blk[0] = (int16_t)level;
      mismatch ^= level;
      i = 0;
      if ((b.peek32() >> 30) == 2) {
        b.skip(2);
        done = true;
      }
    }
    while (!done) {
      int sym = t.read(b);
      if (sym < 0) damaged();
      if (sym == EOB) break;
      int level, j;
      if (sym != ESC) {
        i += RUN[sym] + 1;
        if (i > 63) damaged();
        j = scan[i];
        level = ((LEVEL[sym] * 2 + 1) * qscale * qm[j]) >> 5;
        if (b.u(1)) level = -level;
      } else {
        int run = (int)b.u(6) + 1;
        level = b.s(12);
        i += run;
        if (i > 63) damaged();
        j = scan[i];
        if (level < 0)
          level = -(((-level * 2 + 1) * qscale * qm[j]) >> 5);
        else
          level = ((level * 2 + 1) * qscale * qm[j]) >> 5;
      }
      mismatch ^= level;
      blk[j] = (int16_t)level;
    }
    if (i < 0) damaged();
    blk[63] ^= (int16_t)(mismatch & 1);
    block_last[n] = i;
  }

  int& mb_intra_at(int x, int y) { return cur->mb_intra[(size_t)y * mb_width + x]; }

  void decode_mb(Bits& b) {
    const Tables& T = vlc();
    if (mb_skip_run-- != 0) {
      if (pict_type == 2) {
        mb_intra_at(mb_x, mb_y) = 0;
      } else {
        int prev_intra;
        if (mb_x)
          prev_intra = mb_intra_at(mb_x - 1, mb_y);
        else if (mb_y > 0)
          prev_intra = mb_intra_at(mb_width - 1, mb_y - 1);
        else
          prev_intra = 0;
        if (prev_intra) corrupt("a skipped macroblock after an intra one in a B-picture");
        mb_intra_at(mb_x, mb_y) = 0;
      }
      return;
    }
    int flags;
    switch (pict_type) {
      case 1:
        if (!b.u(1)) {
          if (!b.u(1)) corrupt("an invalid macroblock_type in an I-picture");
          flags = F_QUANT | F_INTRA;
        } else {
          flags = F_INTRA;
        }
        break;
      case 2: {
        int k = T.ptype.read(b);
        if (k < 0) corrupt("an invalid macroblock_type in a P-picture");
        flags = MB_FLAGS_P[k];
        break;
      }
      default: {
        int k = T.btype.read(b);
        if (k < 0) corrupt("an invalid macroblock_type in a B-picture");
        flags = MB_FLAGS_B[k];
        break;
      }
    }
    if (flags & F_INTRA) {
      std::memset(blocks, 0, sizeof blocks);
      if (!frame_pred_frame_dct) interlaced_dct = (int)b.u(1);
      if (flags & F_QUANT) qscale = get_qscale(b);
      if (concealment_mv) {
        mv[0][0][0] = last_mv[0][0][0] = last_mv[0][1][0] =
            decode_motion(b, f_code[0][0], last_mv[0][0][0]);
        mv[0][0][1] = last_mv[0][0][1] = last_mv[0][1][1] =
            decode_motion(b, f_code[0][1], last_mv[0][0][1]);
        b.u(1);  // marker (FFmpeg only logs a 0)
      } else {
        std::memset(last_mv, 0, sizeof last_mv);
      }
      mb_intra = 1;
      for (int i = 0; i < 6; ++i) {
        if (mpeg2)
          mpeg2_intra(b, blocks[i], i);
        else
          mpeg1_intra(b, blocks[i], i);
      }
    } else {
      bool zero_mv = pict_type == 2 && !(flags & F_FORWARD);
      if (zero_mv) {
        mv_dir = 1;
        if (!frame_pred_frame_dct) interlaced_dct = (int)b.u(1);
        mv_type = MV_16X16;
        if (flags & F_QUANT) qscale = get_qscale(b);
        std::memset(last_mv[0], 0, sizeof last_mv[0]);
        mv[0][0][0] = mv[0][0][1] = 0;
      } else {
        int motion_type;
        if (frame_pred_frame_dct) {
          motion_type = 2;  // MT_FRAME
        } else {
          motion_type = (int)b.u(2);
          if (flags & F_PATTERN) interlaced_dct = (int)b.u(1);
        }
        if (flags & F_QUANT) qscale = get_qscale(b);
        mv_dir = ((flags & F_FORWARD) ? 1 : 0) | ((flags & F_BACKWARD) ? 2 : 0);
        switch (motion_type) {
          case 2:  // MT_FRAME
            mv_type = MV_16X16;
            for (int i = 0; i < 2; ++i)
              if (mv_dir >> i & 1) {
                mv[i][0][0] = last_mv[i][0][0] = last_mv[i][1][0] =
                    decode_motion(b, f_code[i][0], last_mv[i][0][0]);
                mv[i][0][1] = last_mv[i][0][1] = last_mv[i][1][1] =
                    decode_motion(b, f_code[i][1], last_mv[i][0][1]);
                if (full_pel[i]) {
                  mv[i][0][0] *= 2;
                  mv[i][0][1] *= 2;
                }
              }
            break;
          case 1:  // MT_FIELD: each field of the frame from a field of the reference
            mv_type = MV_FIELD;
            for (int i = 0; i < 2; ++i)
              if (mv_dir >> i & 1)
                for (int j = 0; j < 2; ++j) {
                  field_select[i][j] = (int)b.u(1);
                  int v = decode_motion(b, f_code[i][0], last_mv[i][j][0]);
                  last_mv[i][j][0] = v;
                  mv[i][j][0] = v;
                  v = decode_motion(b, f_code[i][1], last_mv[i][j][1] >> 1);
                  last_mv[i][j][1] = 2 * v;
                  mv[i][j][1] = v;
                }
            break;
          case 3:  // MT_DMV
            if (progressive_sequence) corrupt("dual prime in a progressive sequence");
            mv_type = MV_DMV;
            for (int i = 0; i < 2; ++i)
              if (mv_dir >> i & 1) {
                int mx = decode_motion(b, f_code[i][0], last_mv[i][0][0]);
                last_mv[i][0][0] = last_mv[i][1][0] = mx;
                int dmx = get_dmv(b);
                int my = decode_motion(b, f_code[i][1], last_mv[i][0][1] >> 1);
                int dmy = get_dmv(b);
                last_mv[i][0][1] = last_mv[i][1][1] = my * 2;
                mv[i][0][0] = mv[i][1][0] = mx;
                mv[i][0][1] = mv[i][1][1] = my;
                int m = top_field_first ? 1 : 3;
                mv[i][2][0] = ((mx * m + (mx > 0)) >> 1) + dmx;
                mv[i][2][1] = ((my * m + (my > 0)) >> 1) + dmy - 1;
                m = 4 - m;
                mv[i][3][0] = ((mx * m + (mx > 0)) >> 1) + dmx;
                mv[i][3][1] = ((my * m + (my > 0)) >> 1) + dmy + 1;
              }
            break;
          default:
            corrupt("frame_motion_type / field_motion_type 0 at macroblock " +
                    std::to_string(mb_x) + ", " + std::to_string(mb_y));
        }
      }
      mb_intra = 0;
      last_dc[0] = last_dc[1] = last_dc[2] = 128 << intra_dc_precision;
      for (int i = 0; i < 6; ++i) block_last[i] = -1;
      if (flags & F_PATTERN) {
        std::memset(blocks, 0, sizeof blocks);
        int cbp = T.cbp.read(b);
        if (cbp <= 0) corrupt("coded_block_pattern 0 or invalid in 4:2:0");
        for (int i = 0; i < 6; ++i) {
          if (cbp & 32) {
            if (mpeg2)
              mpeg2_inter(b, blocks[i], i);
            else
              mpeg1_inter(b, blocks[i], i);
          }
          cbp += cbp;
        }
      }
    }
    mb_intra_at(mb_x, mb_y) = mb_intra;
  }

  // ── motion compensation (mpegvideo_motion.c, its MPEG-1 / 2 path) ──

  // mpeg_motion_internal: a 16 x h luma block and its chroma from `ref`;
  // `field_based`: one field of the frame (8 lines), the destination field
  // `bottom_field` from the reference's field `field_select`
  void motion(const Pic* refp, int field_based, int bottom_field, int field_select, int mx,
              int my, int h, bool avg) {
    if (!refp) unsupported("video prediction from a picture before the stream's first");
    const Pic& ref = *refp;
    const int v_edge = 16 * mb_height >> field_based;
    const int h_edge = 16 * mb_width;
    const int step = field_based ? 2 : 1;  // frame lines per line
    const int dxy_x = mx & 1, dxy_y = my & 1;
    const int src_x = mb_x * 16 + (mx >> 1);
    const int src_y = (mb_y << (4 - field_based)) + (my >> 1);
    const int cmx = mx / 2, cmy = my / 2;
    const int uv_x = mb_x * 8 + (cmx >> 1);
    const int uv_y = (mb_y << (3 - field_based)) + (cmy >> 1);
    if ((unsigned)src_x >= (unsigned)std::max(h_edge - dxy_x - 15, 0) ||
        (unsigned)src_y >= (unsigned)std::max(v_edge - dxy_y - h + 1, 0))
      unsupported("video motion vector that reaches past the picture's edge (macroblock " +
                  std::to_string(mb_x) + ", " + std::to_string(mb_y) +
                  "; FFmpeg skips its prediction and shows the buffer's old bytes)");
    Plane& dy = cur->p[0];
    const ptrdiff_t L = dy.w, S = L * step;
    uint8_t* d = dy.row(mb_y * 16 + bottom_field) + mb_x * 16;
    const uint8_t* s = ref.p[0].row(0) + src_y * S + src_x + (field_select ? L : 0);
    hpel(d, s, S, 16, h, dxy_x, dxy_y, avg);
    for (int c = 1; c < 3; ++c) {
      Plane& dc = cur->p[c];
      const ptrdiff_t CL = dc.w, CS = CL * step;
      uint8_t* cd = dc.row(mb_y * 8 + bottom_field) + mb_x * 8;
      const uint8_t* cs = ref.p[c].row(0) + uv_y * CS + uv_x + (field_select ? CL : 0);
      hpel(cd, cs, CS, 8, h >> 1, cmx & 1, cmy & 1, avg);
    }
  }

  // ff_mpv_motion for one direction: a frame picture's 16x16, field or
  // dual-prime prediction
  void mpv_motion(int dir, bool avg) {
    const Pic* ref = (dir ? next : last).get();
    switch (mv_type) {
      case MV_16X16:
        motion(ref, 0, 0, 0, mv[dir][0][0], mv[dir][0][1], 16, avg);
        break;
      case MV_FIELD:
        for (int j = 0; j < 2; ++j)
          motion(ref, 1, j, field_select[dir][j], mv[dir][j][0], mv[dir][j][1], 8, avg);
        break;
      case MV_DMV:
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j)
            motion(ref, 1, j, j ^ i, mv[dir][2 * i + j][0], mv[dir][2 * i + j][1], 8,
                   avg || i == 1);
        break;
    }
  }

  void reconstruct() {
    Plane& Y = cur->p[0];
    const ptrdiff_t L = Y.w, CL = cur->p[1].w;
    uint8_t* dy = Y.row(mb_y * 16) + mb_x * 16;
    uint8_t* dcb = cur->p[1].row(mb_y * 8) + mb_x * 8;
    uint8_t* dcr = cur->p[2].row(mb_y * 8) + mb_x * 8;
    const ptrdiff_t dct_ls = L << interlaced_dct;
    const ptrdiff_t dct_off = interlaced_dct ? L : L * 8;
    uint8_t* dst[6] = {dy, dy + 8, dy + dct_off, dy + dct_off + 8, dcb, dcr};
    const ptrdiff_t stride[6] = {dct_ls, dct_ls, dct_ls, dct_ls, CL, CL};
    if (mb_intra) {
      for (int i = 0; i < 6; ++i) idct_put(blocks[i], dst[i], stride[i]);
    } else {
      bool avg = false;
      if (mv_dir & 1) {
        mpv_motion(0, false);
        avg = true;
      }
      if (mv_dir & 2) mpv_motion(1, avg);
      for (int i = 0; i < 6; ++i)
        if (block_last[i] >= 0) idct_add(blocks[i], dst[i], stride[i]);
    }
    cur->done[(size_t)mb_y * mb_width + mb_x] = 1;
  }

  void clean_buffers() {
    last_dc[0] = last_dc[1] = last_dc[2] = 128 << intra_dc_precision;
    std::memset(last_mv, 0, sizeof last_mv);
  }

  int read_increment(Bits& b) {
    int code = vlc().incr.read(b);
    if (code < 0) corrupt("no macroblock_address_increment code matches the bits");
    return code;
  }

  // mpeg_decode_slice: from the bytes after the slice start code; returns
  // the bits read
  int64_t slice(const uint8_t* buf, size_t size, int row) {
    Bits b(buf, size);
    clean_buffers();
    interlaced_dct = 0;
    if (mpeg2 && mb_height > 2800 / 16) b.u(3);
    qscale = get_qscale(b);
    if (qscale == 0) corrupt("quantiser_scale_code 0 in a slice header");
    while (b.u(1)) b.u(8);  // extra_bit_slice / intra_slice
    mb_x = 0;
    while (b.left() > 0) {
      int code = read_increment(b);
      if (code >= 33) {
        if (code == 33) mb_x += 33;  // otherwise stuffing: nothing
      } else {
        mb_x += code;
        break;
      }
    }
    if (mb_x >= mb_width) corrupt("a slice whose first macroblock lies past the row's end");
    mb_y = row;
    mb_skip_run = 0;
    for (;;) {
      decode_mb(b);
      reconstruct();
      if (++mb_x >= mb_width) {
        mb_x = 0;
        mb_y += 1;
        if (mb_y >= mb_height) {
          int64_t left = b.left();
          uint32_t rest = left > 0 ? b.peek32() >> (32 - std::min<int64_t>(left, 23)) : 0;
          if (left < 0 || (left && rest)) corrupt("bits after the picture's last macroblock");
          break;
        }
        int64_t left = b.left();
        if (mb_y >= (height + 15) >> 4 && !progressive_sequence && left <= 25 && left >= 0 &&
            mb_skip_run == -1 && (!left || (b.peek32() >> (32 - left)) == 0))
          break;
      }
      if (mb_skip_run == -1) {
        mb_skip_run = 0;
        bool end = false;
        for (;;) {
          int code = read_increment(b);
          if (code >= 33) {
            if (code == 33) {
              mb_skip_run += 33;
            } else if (code == 35) {
              if (mb_skip_run != 0 || (b.peek32() >> 17) != 0)
                corrupt("a slice whose end does not match its macroblocks (slice mismatch)");
              end = true;
              break;
            }
          } else {
            mb_skip_run += code;
            break;
          }
        }
        if (end) break;
        if (mb_skip_run) {
          if (pict_type == 1) corrupt("a skipped macroblock in an I-picture");
          mb_intra = 0;
          for (int i = 0; i < 6; ++i) block_last[i] = -1;
          last_dc[0] = last_dc[1] = last_dc[2] = 128 << intra_dc_precision;
          mv_type = MV_16X16;
          if (pict_type == 2) {
            mv_dir = 1;
            mv[0][0][0] = mv[0][0][1] = 0;
            std::memset(last_mv[0], 0, sizeof last_mv[0]);
          } else {
            mv[0][0][0] = last_mv[0][0][0];
            mv[0][0][1] = last_mv[0][0][1];
            mv[1][0][0] = last_mv[1][0][0];
            mv[1][0][1] = last_mv[1][0][1];
          }
        }
      }
    }
    if (b.left() < 0) corrupt("a slice read past the packet's end");
    return b.pos;
  }

  // every macroblock of the picture decoded
  void check_done() {
    for (int y = 0; y < mb_height; ++y) {
      for (int x = 0; x < mb_width; ++x)
        if (!(cur->done[(size_t)y * mb_width + x]))
          corrupt("macroblock " + std::to_string(x) + ", " + std::to_string(y) +
                  " is in no slice (FFmpeg conceals it; the port does not copy its "
                  "concealment)");
    }
  }

  // decode_chunks over one packet; `tag` names the picture it starts
  void push(const uint8_t* buf, size_t size, int64_t tag, bool extradata) {
    int last_code = 0;  // 0, 0x100 (picture) or 0x101 (slice)
    bool skip_frame = false, first_slice = false, seen_picture = false, started = false;
    size_t p = 0;
    for (;;) {
      // avpriv_find_start_code
      size_t at = p;
      while (at + 3 < size && !(buf[at] == 0 && buf[at + 1] == 0 && buf[at + 2] == 1)) ++at;
      if (at + 3 >= size) break;
      const int code = buf[at + 3];
      p = at + 4;
      const uint8_t* body = buf + p;
      const size_t n = size - p;
      if (code == 0xB3) {  // sequence header
        if (last_code == 0) {
          Bits b(body, n);
          sequence_header(b);
          if (!extradata) sync = true;
        }
      } else if (code == 0x00) {  // picture
        if (seen_picture)
          unsupported("video packet with a second picture after a frame picture (FFmpeg "
                      "decodes its slices into the first)");
        seen_picture = true;
        if (!have_seq) return;  // no picture size yet: FFmpeg drops the packet
        if (last_code == 0 || last_code == 0x101) {
          postinit();
          Bits b(body, n);
          if (!picture_header(b)) pict_type = 0;
          first_slice = true;
          last_code = 0x100;
        }
      } else if (code == 0xB5) {  // extension
        Bits b(body, n);
        switch (b.u(4)) {
          case 1:
            if (last_code == 0) sequence_extension(b);
            break;
          case 3:
            quant_matrix_extension(b);
            break;
          case 8:
            if (last_code == 0x100) picture_coding_extension(b);
            break;
          default:
            break;
        }
        // the scalable extensions (4: sequence scalable, 9: picture spatial
        // scalable, 10: picture temporal scalable)
        {
          Bits e(body, n);
          int id = (int)e.u(4);
          if (id == 5 || id == 9 || id == 10)
            unsupported("video scalable extension (spatial, SNR, temporal or data "
                        "partitioning)");
        }
      } else if (code == 0xB8) {  // GOP
        if (last_code == 0) {
          Bits b(body, n);
          b.u(25);
          closed_gop = b.u(1);
          b.u(1);  // broken_link
          sync = true;
        }
      } else if (code >= 0x01 && code <= 0xAF && last_code != 0) {  // slice
        int row = code - 1;
        last_code = 0x101;
        if (mpeg2 && mb_height > 2800 / 16) row += (n ? (body[0] & 0xE0) : 0) << 2;
        if (n < 2) corrupt("a slice of fewer than 2 bytes");
        if (row >= mb_height) corrupt("a slice below the picture");
        if (!last) {
          if (pict_type == 3 && !closed_gop) {
            skip_frame = true;
            continue;
          }
        }
        if (pict_type == 1) sync = true;
        if (!next && pict_type == 2 && !sync) {
          skip_frame = true;
          continue;
        }
        if (!pict_type) {
          skip_frame = true;
          continue;
        }
        if (first_slice) {
          skip_frame = false;
          first_slice = false;
          if ((int64_t)mb_width * mb_height * 11 / (33 * 2 * 8) > (int64_t)size)
            unsupported("video picture in fewer bytes than FFmpeg decodes (it drops it)");
          frame_start(tag);
          started = true;
        }
        int64_t bits = slice(body, n, row);
        p += (size_t)((bits - 1) / 8);
      } else if (code == 0xB2) {
        if (n >= 7 && std::memcmp(body, "TMPGEXS", 7) == 0)
          unsupported("video stamped TMPGEXS (FFmpeg rewrites its intra DC quantiser)");
      }
      // other start codes (sequence end, user data, system codes) are skipped
    }
    // slice_end
    if (skip_frame || !cur || extradata || !started) return;
    check_done();
    if (pict_type == 3 || low_delay) {
      out.push_back(cur);
    } else if (last && !last->dummy) {
      out.push_back(last);
    }
    if (pict_type == 3) cur.reset();
  }

  void flush() {
    if (!low_delay && next) out.push_back(next);
    next.reset();
  }
};

void copy_out(const Decoder& d, const Pic& p, uint8_t* y, uint8_t* cb, uint8_t* cr) {
  const int w = d.width, h = d.height, cw = (w + 1) / 2, ch = (h + 1) / 2;
  for (int r = 0; r < h; ++r) std::memcpy(y + (size_t)r * w, p.p[0].row(r), w);
  for (int r = 0; r < ch; ++r) {
    std::memcpy(cb + (size_t)r * cw, p.p[1].row(r), cw);
    std::memcpy(cr + (size_t)r * cw, p.p[2].row(r), cw);
  }
}

template <class F>
int guarded(void* h, F f) {
  auto* d = static_cast<Decoder*>(h);
  try {
    f(*d);
    return 0;
  } catch (const Unsupported& e) {
    d->error = e.what();
    return 2;
  } catch (const std::exception& e) {
    d->error = e.what();
    return 1;
  }
}

}  // namespace

extern "C" {

void* mp2d_new() {
  try {
    return new Decoder();
  } catch (...) {
    return nullptr;
  }
}

void mp2d_free(void* h) { delete static_cast<Decoder*>(h); }

// decode one packet (or the container's extradata); `tag` names the frame a
// picture of it starts
int mp2d_push(void* h, const uint8_t* data, int64_t size, int64_t tag, int extradata) {
  return guarded(h, [&](Decoder& d) { d.push(data, (size_t)size, tag, extradata != 0); });
}

int mp2d_flush(void* h) {
  return guarded(h, [&](Decoder& d) { d.flush(); });
}

// the picture size, and the tag of the next picture to show; 1 where none
int mp2d_next(void* h, int32_t* w, int32_t* hh, int64_t* tag) {
  auto* d = static_cast<Decoder*>(h);
  if (d->out.empty()) return 1;
  *w = d->width;
  *hh = d->height;
  *tag = d->out.front()->tag;
  return 0;
}

// copy the next picture to show out (Y' w x h, Cb / Cr of half the size,
// rounded up) and drop it from the queue
int mp2d_take(void* h, uint8_t* y, uint8_t* cb, uint8_t* cr) {
  auto* d = static_cast<Decoder*>(h);
  if (d->out.empty()) return 1;
  copy_out(*d, *d->out.front(), y, cb, cr);
  d->out.pop_front();
  return 0;
}

const char* mp2d_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

}  // extern "C"
