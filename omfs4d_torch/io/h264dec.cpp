// H.264 (ITU-T H.264 | ISO/IEC 14496-10) decoding on the host: the Main and
// High profile I, P and B pictures that phone cameras and x264 write, for a
// machine with no ffmpeg.  Built by g++ at first use (omfs4d_torch/native.py)
// and bound with ctypes by omfs4d_torch/io/h264.py; the tables come from
// h264_tables.py as the generated header h264_tables.h.
//
// Covered, for profile_idc 66, 77 and 100 at 8-bit 4:2:0, frames only:
//   SPS / PPS (several ids, POC types 0-2, cropping, scaling matrices with the
//   fall-back rules A and B, transform_8x8_mode_flag, both chroma QP offsets);
//   CAVLC and CABAC; every I, P and B mb_type (I_NxN 4x4 / 8x8, Intra_16x16,
//   I_PCM, P and B partitions down to 4x4, P_Skip, B_Skip, B_Direct_16x16
//   and B_8x8 with direct sub-macroblocks); direct prediction, spatial and
//   temporal, with direct_8x8_inference_flag 0 or 1; quarter-sample luma and
//   eighth-sample chroma motion compensation with bi-prediction and explicit
//   and implicit weighted prediction; up to 16 reference frames with
//   sliding-window and adaptive marking, long-term references and list
//   modification of both lists, reference B pictures; several slices a
//   picture; the deblocking filter (8.7); output in POC order, bumped by the
//   VUI's max_num_reorder_frames or else the DPB size.
// Anything else throws Unsupported naming the feature; a read past a NAL's end
// or a syntax value out of range throws Corrupt.  Neither crosses the C API:
// each entry point returns 0, 1 (corrupt) or 2 (unsupported) and keeps the
// message for h264d_error.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "h264_tables.h"

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& s) : std::runtime_error(s) {}
};
struct Unsupported : std::runtime_error {
  explicit Unsupported(const std::string& s) : std::runtime_error(s) {}
};

[[noreturn]] void corrupt(const std::string& what) { throw Corrupt("H.264: " + what); }
[[noreturn]] void unsupported(const std::string& what) { throw Unsupported("H.264 " + what); }

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int median3(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

// ── bits ─────────────────────────────────────────────────────────────────

struct Bits {
  const uint8_t* d = nullptr;
  size_t pos = 0, stop = 0, end = 0, lim = 0;   // bits: read position, stop bit, NAL end, limit

  void init(const std::vector<uint8_t>& rbsp) {
    d = rbsp.data();
    end = rbsp.size() * 8;
    size_t n = rbsp.size();
    while (n > 0 && rbsp[n - 1] == 0) --n;      // cabac_zero_words
    if (n == 0) corrupt("a NAL unit with no rbsp_stop_one_bit");
    int tz = __builtin_ctz(rbsp[n - 1]);
    stop = (n - 1) * 8 + (7 - tz);
    pos = 0;
    lim = stop;
  }
  inline uint32_t bit() {
    if (pos >= lim) corrupt("a NAL unit ends inside a syntax element");
    uint32_t b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return b;
  }
  uint32_t u(int n) {
    if (n == 0) return 0;
    if (pos + n > lim) corrupt("a NAL unit ends inside a syntax element");
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++pos) v = v << 1 | ((d[pos >> 3] >> (7 - (pos & 7))) & 1);
    return v;
  }
  uint32_t ue() {
    int z = 0;
    while (!bit())
      if (++z > 31) corrupt("an Exp-Golomb code longer than 63 bits");
    uint64_t v = ((uint64_t)1 << z) - 1 + u(z);
    if (v > 0x7FFFFFFF) corrupt("an Exp-Golomb value out of range");
    return (uint32_t)v;
  }
  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? (int32_t)((k + 1) / 2) : -(int32_t)(k / 2);
  }
  uint32_t ue_max(uint32_t hi, const char* what) {
    uint32_t v = ue();
    if (v > hi) corrupt(std::string(what) + " out of range");
    return v;
  }
  int32_t se_range(int lo, int hi, const char* what) {
    int32_t v = se();
    if (v < lo || v > hi) corrupt(std::string(what) + " out of range");
    return v;
  }
  uint32_t peek(int n) const {        // zeros past the limit
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      size_t p = pos + i;
      v = v << 1 | (p < lim ? (d[p >> 3] >> (7 - (p & 7))) & 1 : 0);
    }
    return v;
  }
  void skip(int n) {
    if (pos + n > lim) corrupt("a NAL unit ends inside a syntax element");
    pos += n;
  }
  bool more_rbsp_data() const { return pos < stop; }
};

// a prefix code read through a lookup of its longest code's length
struct Vlc {
  int maxlen = 0;
  std::vector<uint16_t> lut;          // (length << 8 | symbol) + 1, 0 for no code
  void build(int maxbits, const std::vector<std::array<int, 3>>& codes) {
    maxlen = maxbits;
    lut.assign((size_t)1 << maxbits, 0);
    for (auto& c : codes) {
      int len = c[0], code = c[1], sym = c[2];
      if (len == 0) continue;
      int shift = maxbits - len;
      for (int k = 0; k < (1 << shift); ++k) lut[(code << shift) | k] = (uint16_t)((len << 8 | sym) + 1);
    }
  }
  int read(Bits& b) const {
    uint16_t e = lut[b.peek(maxlen)];
    if (!e) corrupt("an invalid variable-length code");
    --e;
    b.skip(e >> 8);
    return e & 0xFF;
  }
};

struct VlcTables {
  Vlc coeff_token[5], total_zeros[15], total_zeros_dc[3], run_before[7];
  VlcTables() {
    for (int t = 0; t < 5; ++t) {
      std::vector<std::array<int, 3>> c;
      for (int tc = 0; tc < 17; ++tc)
        for (int t1 = 0; t1 < 4; ++t1) c.push_back({CT_LEN[t][tc][t1], CT_CODE[t][tc][t1], tc * 4 + t1});
      coeff_token[t].build(16, c);
    }
    for (int i = 0; i < 15; ++i) {
      std::vector<std::array<int, 3>> c;
      for (int z = 0; z < 16; ++z) c.push_back({TZ_LEN[i][z], TZ_CODE[i][z], z});
      total_zeros[i].build(9, c);
    }
    for (int i = 0; i < 3; ++i) {
      std::vector<std::array<int, 3>> c;
      for (int z = 0; z < 4; ++z) c.push_back({TZC_LEN[i][z], TZC_CODE[i][z], z});
      total_zeros_dc[i].build(3, c);
    }
    for (int i = 0; i < 7; ++i) {
      std::vector<std::array<int, 3>> c;
      for (int r = 0; r < 15; ++r) c.push_back({RB_LEN[i][r], RB_CODE[i][r], r});
      run_before[i].build(11, c);
    }
  }
};

const VlcTables& vlc() {
  static const VlcTables t;
  return t;
}

std::vector<uint8_t> unescape(const uint8_t* p, size_t n) {
  std::vector<uint8_t> out;
  out.reserve(n);
  int zeros = 0;
  for (size_t i = 0; i < n; ++i) {
    if (zeros >= 2 && p[i] == 3) {
      zeros = 0;
      continue;
    }
    zeros = p[i] == 0 ? zeros + 1 : 0;
    out.push_back(p[i]);
  }
  return out;
}

// ── parameter sets ──────────────────────────────────────────────────────

struct SPS {
  bool valid = false;
  int profile = 0, level = 0;
  bool scaling_present = false;
  uint8_t sl4[6][16], sl8[2][64];       // after fall-back rule A, zig-zag order
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4;
  bool delta_pic_order_always_zero = false;
  int offset_for_non_ref_pic = 0, offset_for_top_to_bottom = 0, n_cycle = 0;
  int offset_for_ref_frame[256];
  int max_num_ref_frames = 0;
  bool gaps_allowed = false;
  int mbw = 0, mbh = 0;
  bool direct_8x8_inference = true;
  int crop[4] = {0, 0, 0, 0};          // left, right, top, bottom in chroma units of 2
  int num_reorder = -1;                // max_num_reorder_frames of the VUI, -1 absent
};

struct PPS {
  bool valid = false;
  int sps_id = 0;
  bool cabac = false, bottom_poc = false;
  int num_ref_idx_default[2] = {1, 1};
  bool weighted_pred = false;
  int weighted_bipred_idc = 0;
  int init_qp = 26;
  int cqp_offset[2] = {0, 0};
  bool deblock_control = false, constrained_intra = false;
  bool t8x8 = false, scaling_present = false;
  bool list_present[8] = {};
  bool use_default[8] = {};
  uint8_t sl4[6][16], sl8[2][64];
};

void scaling_list(Bits& b, uint8_t* list, int size, bool* use_default) {
  int last = 8, next = 8;
  *use_default = false;
  for (int j = 0; j < size; ++j) {
    if (next != 0) {
      int delta = b.se_range(-128, 127, "delta_scale");
      next = (last + delta + 256) % 256;
      if (j == 0 && next == 0) {
        *use_default = true;
        break;
      }
    }
    list[j] = (uint8_t)(next == 0 ? last : next);
    last = list[j];
  }
}

void default_list(int i, uint8_t* list) {
  if (i < 6) memcpy(list, DEFAULT_4X4[i < 3 ? 0 : 1], 16);
  else memcpy(list, DEFAULT_8X8[i - 6], 64);
}

void flat_lists(uint8_t sl4[6][16], uint8_t sl8[2][64]) {
  memset(sl4, 16, 6 * 16);
  memset(sl8, 16, 2 * 64);
}

void skip_hrd(Bits& b) {
  int cnt = b.ue_max(31, "cpb_cnt_minus1") + 1;
  b.u(8);
  for (int i = 0; i < cnt; ++i) {
    b.ue();
    b.ue();
    b.u(1);
  }
  b.u(20);
}

const char* profile_name(int p) {
  switch (p) {
    case 88: return "Extended profile";
    case 110: return "High 10 profile";
    case 122: return "High 4:2:2 profile";
    case 244: return "High 4:4:4 Predictive profile";
    case 44: return "CAVLC 4:4:4 Intra profile";
    case 118: return "Multiview High profile";
    case 128: return "Stereo High profile";
    case 83: return "Scalable Baseline profile";
    case 86: return "Scalable High profile";
    default: return nullptr;
  }
}

SPS parse_sps(Bits& b, int* id_out) {
  SPS s;
  s.profile = b.u(8);
  b.u(8);
  s.level = b.u(8);
  int id = b.ue_max(31, "seq_parameter_set_id");
  *id_out = id;
  if (s.profile != 66 && s.profile != 77 && s.profile != 100) {
    const char* name = profile_name(s.profile);
    unsupported(name ? name : "profile_idc " + std::to_string(s.profile));
  }
  flat_lists(s.sl4, s.sl8);
  if (s.profile == 100) {
    int cf = b.ue_max(3, "chroma_format_idc");
    if (cf != 1) unsupported(cf == 0 ? "monochrome (4:0:0) coding" : cf == 2 ? "High 4:2:2 profile" : "High 4:4:4 Predictive profile");
    int bdl = b.ue(), bdc = b.ue();
    if (bdl || bdc) unsupported("High 10 profile");
    if (b.u(1)) unsupported("High 4:4:4 Predictive profile (transform bypass)");
    s.scaling_present = b.u(1);
    if (s.scaling_present) {
      for (int i = 0; i < 8; ++i) {
        uint8_t* list = i < 6 ? s.sl4[i] : s.sl8[i - 6];
        bool use_def = false;
        if (b.u(1)) {
          scaling_list(b, list, i < 6 ? 16 : 64, &use_def);
          if (use_def) default_list(i, list);
        } else if (i == 0 || i == 3 || i >= 6) {          // fall-back rule A
          default_list(i, list);
        } else {
          memcpy(list, s.sl4[i - 1], 16);
        }
      }
    }
  }
  s.log2_max_frame_num = b.ue_max(12, "log2_max_frame_num_minus4") + 4;
  s.poc_type = b.ue_max(2, "pic_order_cnt_type");
  if (s.poc_type == 0) {
    s.log2_max_poc_lsb = b.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
  } else if (s.poc_type == 1) {
    s.delta_pic_order_always_zero = b.u(1);
    s.offset_for_non_ref_pic = b.se();
    s.offset_for_top_to_bottom = b.se();
    s.n_cycle = b.ue_max(255, "num_ref_frames_in_pic_order_cnt_cycle");
    for (int i = 0; i < s.n_cycle; ++i) s.offset_for_ref_frame[i] = b.se();
  }
  s.max_num_ref_frames = b.ue_max(16, "max_num_ref_frames");
  s.gaps_allowed = b.u(1);
  s.mbw = b.ue_max(1023, "pic_width_in_mbs_minus1") + 1;
  s.mbh = b.ue_max(1023, "pic_height_in_map_units_minus1") + 1;
  if (!b.u(1))
    unsupported(b.u(1) ? "MBAFF (macroblock-adaptive frame / field coding)" : "interlaced (field) coding");
  s.direct_8x8_inference = b.u(1);
  if (b.u(1)) {
    for (int k = 0; k < 4; ++k) s.crop[k] = b.ue_max(8 * 1024, "frame_crop_offset");
    if (2 * (s.crop[0] + s.crop[1]) >= 16 * s.mbw || 2 * (s.crop[2] + s.crop[3]) >= 16 * s.mbh)
      corrupt("the cropping leaves no picture");
  }
  if (b.u(1)) {                                             // VUI, as far as the reordering
    if (b.u(1) && b.u(8) == 255) b.u(32);
    if (b.u(1)) b.u(1);
    if (b.u(1)) {
      b.u(4);
      if (b.u(1)) b.u(24);
    }
    if (b.u(1)) {
      b.ue();
      b.ue();
    }
    if (b.u(1)) {
      b.u(32);
      b.u(32);
      b.u(1);
    }
    bool nal_hrd = b.u(1);
    if (nal_hrd) skip_hrd(b);
    bool vcl_hrd = b.u(1);
    if (vcl_hrd) skip_hrd(b);
    if (nal_hrd || vcl_hrd) b.u(1);
    b.u(1);
    if (b.u(1)) {
      b.u(1);
      b.ue();
      b.ue();
      b.ue();
      b.ue();
      s.num_reorder = b.ue_max(16, "max_num_reorder_frames");
      b.ue();
    }
  }
  s.valid = true;
  return s;
}

PPS parse_pps(Bits& b, int* id_out) {
  PPS p;
  int id = b.ue_max(255, "pic_parameter_set_id");
  *id_out = id;
  p.sps_id = b.ue_max(31, "seq_parameter_set_id");
  p.cabac = b.u(1);
  p.bottom_poc = b.u(1);
  if (b.ue_max(7, "num_slice_groups_minus1")) unsupported("slice groups (FMO)");
  p.num_ref_idx_default[0] = b.ue_max(31, "num_ref_idx_l0_default_active_minus1") + 1;
  p.num_ref_idx_default[1] = b.ue_max(31, "num_ref_idx_l1_default_active_minus1") + 1;
  p.weighted_pred = b.u(1);
  p.weighted_bipred_idc = b.u(2);
  if (p.weighted_bipred_idc == 3) corrupt("weighted_bipred_idc 3");
  p.init_qp = 26 + b.se_range(-26, 25, "pic_init_qp_minus26");
  b.se_range(-26, 25, "pic_init_qs_minus26");
  p.cqp_offset[0] = p.cqp_offset[1] = b.se_range(-12, 12, "chroma_qp_index_offset");
  p.deblock_control = b.u(1);
  p.constrained_intra = b.u(1);
  if (b.u(1)) unsupported("redundant pictures");
  if (b.more_rbsp_data()) {
    p.t8x8 = b.u(1);
    p.scaling_present = b.u(1);
    if (p.scaling_present) {
      for (int i = 0; i < 6 + 2 * p.t8x8; ++i) {
        if ((p.list_present[i] = b.u(1))) {
          uint8_t* list = i < 6 ? p.sl4[i] : p.sl8[i - 6];
          scaling_list(b, list, i < 6 ? 16 : 64, &p.use_default[i]);
        }
      }
    }
    p.cqp_offset[1] = b.se_range(-12, 12, "second_chroma_qp_index_offset");
  }
  p.valid = true;
  return p;
}

// ── pictures ────────────────────────────────────────────────────────────

// P16x16 / P16x8 / P8x16 also stand for the B partitions of those shapes;
// SKIP is P_Skip or B_Skip, BDIRECT B_Direct_16x16
enum MbKind : uint8_t { P16x16, P16x8, P8x16, P8x8, P8x8REF0, I4x4, I8x8, I16, IPCM, SKIP, BDIRECT, B8x8 };

struct MB {
  int slice = -1;
  uint8_t kind = SKIP;
  bool intra = false, t8x8 = false;
  int qp = 0, qp_delta = 0;
  int cbp = 0;                  // luma bits 0-3, chroma << 4
  int chroma_mode = 0, i16mode = 0;
  int8_t ipred[16];             // Intra4x4PredMode by raster 4x4 (8x8 modes repeated)
  int8_t ref[2][4];             // refIdxL0 / L1 by 8x8, -1 where the list is not used
  int16_t mv[2][16][2];         // by list and raster 4x4 (0 where the list is not used)
  uint8_t mvd[2][16][2];        // |mvd| by list and raster 4x4, capped (CABAC contexts)
  bool direct[4];               // the 8x8 is predicted in direct mode (CABAC contexts)
  uint8_t nz[16];               // luma coefficients by raster 4x4 (CAVLC nC, CABAC cbf)
  uint8_t nzc[2][4];            // chroma AC coefficients
  bool nzd[16];                 // non-zero coefficients of the 4x4 / 8x8 holding the block
  bool cbf_dc[3];               // coded_block_flag of the luma DC, Cb DC, Cr DC
  uint64_t refpic[2][4];        // the picture ref[list][8x8] names, 0 for none
};

struct Pic {
  std::vector<uint8_t> y, cb, cr;
  int poc = 0, frame_num = 0, frame_num_wrap = 0, long_idx = -1;
  bool short_ref = false, long_ref = false;
  uint64_t id = 0;
  int mbw = 0, mbh = 0, crop[4] = {0, 0, 0, 0};
  std::vector<MB> mbs;          // its motion, for the direct modes of later pictures
};
using PicP = std::shared_ptr<Pic>;

struct SliceHdr {
  int first_mb = 0, type = 0;                // 0 P, 1 B, 2 I
  int pps_id = 0, frame_num = 0, idr_pic_id = 0;
  int poc_lsb = 0, delta_poc_bottom = 0, delta_poc[2] = {0, 0};
  bool direct_spatial = false;
  int num_ref_idx[2] = {1, 1};
  int cabac_init_idc = 0, qp = 26;
  int deblock_idc = 0, alpha_off = 0, beta_off = 0;
  bool idr = false;
  int nal_ref_idc = 0;
  bool no_output_of_prior_pics = false, long_term_reference = false, adaptive = false;
  std::vector<std::array<int, 3>> mmco;      // (op, a, b)
  // explicit weighted prediction, by list and reference index
  int luma_log2 = 0, chroma_log2 = 0;
  int lw[2][32] = {}, lo[2][32] = {}, cw[2][32][2] = {}, co[2][32][2] = {};
};

struct SliceParams {                         // what the deblocking reads of a slice
  int deblock_idc = 0, alpha_off = 0, beta_off = 0;
  int cqp_offset[2] = {0, 0};
};

// MaxDpbMbs of Table A-1 by level_idc
int max_dpb_mbs(int level) {
  switch (level) {
    case 9: case 10: return 396;
    case 11: return 900;
    case 12: case 13: case 20: return 2376;
    case 21: return 4752;
    case 22: case 30: return 8100;
    case 31: return 18000;
    case 32: return 20480;
    case 40: case 41: return 32768;
    case 42: return 34816;
    case 50: return 110400;
    default: return 184320;
  }
}

// luma4x4BlkIdx -> raster index of its 4x4 block (6.4.3)
const int BLK_RASTER[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};

// ── the decoder ─────────────────────────────────────────────────────────

struct Partition {
  int x, y, w, h;   // luma samples in the macroblock
  int flags;        // 1 list 0, 2 list 1, 3 both
  int ref[2];
  int mv[2][2];
};

class Decoder {
 public:
  std::string error;
  std::vector<PicP> ready;   // output, in order

  void nal(const uint8_t* data, size_t size);
  void end_picture();
  void flush();

 private:
  SPS sps_[32];
  PPS pps_[256];
  const SPS* sps = nullptr;
  const PPS* pps = nullptr;
  int active_sps = -1;
  uint64_t next_id = 1;

  // the picture being decoded
  PicP cur;
  bool in_picture = false;
  SliceHdr first_hdr;
  std::vector<MB> mbs;
  std::vector<SliceParams> slices;
  int n_slices = 0, last_mb = -1;
  int mbw = 0, mbh = 0;
  bool cur_mmco5 = false;
  int cur_top = 0, cur_bottom = 0, cur_poc_msb = 0, cur_frame_num_offset = 0;

  // reference and output state
  std::vector<PicP> dpb;      // reference frames
  std::vector<PicP> pending;  // decoded, not yet output
  int max_long_idx = -1;      // MaxLongTermFrameIdx, -1 none
  int prev_poc_msb = 0, prev_poc_lsb = 0, prev_frame_num_offset = 0, prev_frame_num = 0;
  int prev_ref_frame_num = 0;
  bool have_prev = false;

  // the slice being decoded
  SliceHdr sh;
  Bits bs;
  std::vector<PicP> list[2];  // RefPicList0 / 1
  int implicit_w[32][32];     // w0 of implicit bi-prediction by (refIdxL0, refIdxL1)
  int slice_num = 0;
  int qp = 26;
  int ls4[6][6][16];
  int ls8[2][6][64];
  // CABAC
  uint32_t range = 0, offset = 0;
  uint8_t ctx[460];

  // the macroblock being decoded
  int mb_addr = 0, mbx = 0, mby = 0;
  int lc[16][16];             // luma levels by raster 4x4, raster position
  int lc8[4][64];
  int ldc[16];
  int cdc[2][4];
  int cac[2][4][16];
  uint8_t pcm[384];
  bool done4[16];             // reconstructed 4x4 blocks of the current macroblock
  int prev_mb_in_slice = -1;

  void activate(const SliceHdr& h, bool new_picture);
  void setup_scaling();
  void start_picture(const SliceHdr& h);
  void parse_slice_header(int nal_type, int ref_idc);
  void ref_lists(const std::vector<std::array<int, 2>> mods[2]);
  void implicit_weights();
  void slice_data();
  void finish_picture();
  void mark_references();
  void output_ready(bool all);

  // neighbours
  bool avail(int addr) const { return addr >= 0 && addr < (int)mbs.size() && mbs[addr].slice == slice_num; }
  int addr_a() const { return mbx > 0 ? mb_addr - 1 : -1; }
  int addr_b() const { return mb_addr - mbw; }
  int addr_c() const { return mbx < mbw - 1 ? mb_addr - mbw + 1 : -1; }
  int addr_d() const { return mbx > 0 ? mb_addr - mbw - 1 : -1; }
  // 6.4.12: the macroblock holding luma (xN, yN) relative to the current one
  // (-1: none or not available) and the location inside it
  int locate(int xN, int yN, int* xW, int* yW) const;

  // macroblock layer
  void macroblock(bool skip);
  void skip_mb();
  int read_mb_type();
  int read_b_sub_type();
  void intra_pred_modes(MB& m, bool t8);
  void inter_pred(MB& m, int kind, std::vector<Partition>& parts);
  void b_pred(MB& m, int btype, std::vector<Partition>& parts);
  int read_ref(MB& m, int list, int x, int y);
  int read_mvd(int list, int x, int y, int comp);
  void residual(MB& m);
  void mvp(int list, int x, int y, int w, int ref, int shape, int* px, int* py);
  void neighbour_motion(int list, int xN, int yN, int* ref, int* mx, int* my, bool* available);
  // direct prediction (8.4.1.2) of the 8x8 blocks b8 (-1: all four)
  void spatial_refs(int ref[2], int mv[2][2]);
  void direct(MB& m, int b8, std::vector<Partition>& parts);
  void set_refpics(MB& m);

  // CAVLC
  int cavlc_block(int nc, int maxnum, int* levels);
  int luma_nc(int raster) const;
  int chroma_nc(int c, int blk) const;

  // CABAC
  void cabac_init_engine();
  void cabac_init_contexts();
  int dec(int ctxIdx);
  int bypass();
  int terminate();
  int cabac_block(int cat, int cbf_inc, int maxnum, int* levels);
  int cbf_luma_inc(int raster, bool dc);
  int cbf_chroma_inc(int c, int blk, bool dc);
  int cabac_mvd(int base, int sum);

  // reconstruction
  void recon_pcm();
  void recon_intra(MB& m);
  void recon_inter(MB& m, const std::vector<Partition>& parts);
  void recon_chroma(MB& m, bool intra, int pred[2][64]);
  void luma_residual_4x4(MB& m, int raster, int list, int* out16);
  bool intra_avail(int xN, int yN) const;
  void deblock();
};

int Decoder::locate(int xN, int yN, int* xW, int* yW) const {
  int addr;
  if (yN > 15) return -1;
  if (xN < 0 && yN < 0) addr = addr_d();
  else if (xN < 0) addr = addr_a();
  else if (xN <= 15 && yN < 0) addr = addr_b();
  else if (xN <= 15) addr = mb_addr;
  else if (yN < 0) addr = addr_c();
  else return -1;
  if (addr != mb_addr && !avail(addr)) return -1;
  *xW = (xN + 16) & 15;
  *yW = (yN + 16) & 15;
  return addr;
}

// ── NAL units ───────────────────────────────────────────────────────────

void Decoder::nal(const uint8_t* data, size_t size) {
  if (size < 1) corrupt("an empty NAL unit");
  if (data[0] & 0x80) corrupt("forbidden_zero_bit set");
  int ref_idc = data[0] >> 5, type = data[0] & 0x1F;
  if (type == 1 || type == 5) {
    std::vector<uint8_t> rbsp = unescape(data + 1, size - 1);
    bs.init(rbsp);
    parse_slice_header(type, ref_idc);
    slice_data();
    return;
  }
  if (type >= 6 && type <= 11) end_picture();                // a new access unit
  if (type == 2 || type == 3 || type == 4) unsupported("data partitioning");
  if (type == 7 || type == 8) {
    std::vector<uint8_t> rbsp = unescape(data + 1, size - 1);
    Bits b;
    b.init(rbsp);
    int id;
    if (type == 7) {
      SPS s = parse_sps(b, &id);
      sps_[id] = s;
    } else {
      PPS p = parse_pps(b, &id);
      pps_[id] = p;
    }
  }
  // SEI, AUD, end of sequence / stream, filler and extensions carry nothing
  // the pictures need
}

void Decoder::setup_scaling() {
  uint8_t sl4[6][16], sl8[2][64];
  memcpy(sl4, sps->sl4, sizeof sl4);
  memcpy(sl8, sps->sl8, sizeof sl8);
  if (pps->scaling_present) {
    bool rule_b = sps->scaling_present;
    for (int i = 0; i < 8; ++i) {
      uint8_t* list = i < 6 ? sl4[i] : sl8[i - 6];
      int n = i < 6 ? 16 : 64;
      if (i >= 6 && !pps->t8x8) break;
      if (pps->list_present[i]) {
        if (pps->use_default[i]) default_list(i, list);
        else memcpy(list, i < 6 ? pps->sl4[i] : pps->sl8[i - 6], n);
      } else if (i == 0 || i == 3 || i >= 6) {
        if (rule_b) memcpy(list, i < 6 ? sps->sl4[i] : sps->sl8[i - 6], n);
        else default_list(i, list);
      } else {
        memcpy(list, sl4[i - 1], 16);
      }
    }
  }
  for (int l = 0; l < 6; ++l)
    for (int m = 0; m < 6; ++m)
      for (int k = 0; k < 16; ++k) {
        int pos = ZIGZAG4[k], y = pos >> 2, x = pos & 3;
        int cls = (x % 2 == 0 && y % 2 == 0) ? 0 : (x % 2 == 1 && y % 2 == 1) ? 1 : 2;
        ls4[l][m][pos] = sl4[l][k] * NORM4[m][cls];
      }
  for (int l = 0; l < 2; ++l)
    for (int m = 0; m < 6; ++m)
      for (int k = 0; k < 64; ++k) {
        int pos = ZIGZAG8[k], y = pos >> 3, x = pos & 7;
        int cls;
        if (x % 4 == 0 && y % 4 == 0) cls = 0;
        else if (x % 2 == 1 && y % 2 == 1) cls = 1;
        else if (x % 4 == 2 && y % 4 == 2) cls = 2;
        else if ((x % 4 == 0 && y % 2 == 1) || (x % 2 == 1 && y % 4 == 0)) cls = 3;
        else if ((x % 4 == 0 && y % 4 == 2) || (x % 4 == 2 && y % 4 == 0)) cls = 4;
        else cls = 5;
        ls8[l][m][pos] = sl8[l][k] * NORM8[m][cls];
      }
}

void Decoder::parse_slice_header(int nal_type, int ref_idc) {
  SliceHdr h;
  h.idr = nal_type == 5;
  h.nal_ref_idc = ref_idc;
  h.first_mb = bs.ue();
  int st = bs.ue_max(9, "slice_type");
  st %= 5;
  if (st == 3 || st == 4) unsupported("SP/SI slices");
  h.type = st;
  if (h.idr && st != 2) corrupt("an IDR picture with a P or B slice");
  h.pps_id = bs.ue_max(255, "pic_parameter_set_id");
  if (!pps_[h.pps_id].valid) corrupt("a slice refers to a picture parameter set it was not given");
  const PPS& p = pps_[h.pps_id];
  if (!sps_[p.sps_id].valid) corrupt("a picture parameter set refers to a missing sequence parameter set");
  const SPS& s = sps_[p.sps_id];
  h.frame_num = bs.u(s.log2_max_frame_num);
  if (h.idr) h.idr_pic_id = bs.ue_max(65535, "idr_pic_id");
  if (s.poc_type == 0) {
    h.poc_lsb = bs.u(s.log2_max_poc_lsb);
    if (p.bottom_poc) h.delta_poc_bottom = bs.se();
  } else if (s.poc_type == 1 && !s.delta_pic_order_always_zero) {
    h.delta_poc[0] = bs.se();
    if (p.bottom_poc) h.delta_poc[1] = bs.se();
  }
  std::vector<std::array<int, 2>> mods[2];
  int n_lists = st == 1 ? 2 : st == 0 ? 1 : 0;
  if (st == 1) h.direct_spatial = bs.u(1);
  for (int x = 0; x < 2; ++x) h.num_ref_idx[x] = p.num_ref_idx_default[x];
  if (n_lists && bs.u(1)) {
    for (int x = 0; x < n_lists; ++x)
      h.num_ref_idx[x] = bs.ue_max(15, "num_ref_idx_active_minus1") + 1;
  }
  for (int x = 0; x < n_lists; ++x) {
    if (h.num_ref_idx[x] > 16) corrupt("num_ref_idx_active beyond 16 for frames");
    if (!bs.u(1)) continue;
    for (int k = 0;; ++k) {
      if (k > h.num_ref_idx[x]) corrupt("too many ref_pic_list_modification operations");
      int idc = bs.ue_max(3, "modification_of_pic_nums_idc");
      if (idc == 3) break;
      int v = bs.ue_max(idc == 2 ? 31 : 131071, "abs_diff_pic_num_minus1 / long_term_pic_num");
      mods[x].push_back({idc, v});
    }
  }
  if ((p.weighted_pred && st == 0) || (p.weighted_bipred_idc == 1 && st == 1)) {
    h.luma_log2 = bs.ue_max(7, "luma_log2_weight_denom");
    h.chroma_log2 = bs.ue_max(7, "chroma_log2_weight_denom");
    for (int x = 0; x < n_lists; ++x)
      for (int i = 0; i < h.num_ref_idx[x]; ++i) {
        h.lw[x][i] = 1 << h.luma_log2;
        h.lo[x][i] = 0;
        if (bs.u(1)) {
          h.lw[x][i] = bs.se_range(-128, 127, "luma_weight");
          h.lo[x][i] = bs.se_range(-128, 127, "luma_offset");
        }
        bool cflag = bs.u(1);
        for (int j = 0; j < 2; ++j) {
          h.cw[x][i][j] = 1 << h.chroma_log2;
          h.co[x][i][j] = 0;
          if (cflag) {
            h.cw[x][i][j] = bs.se_range(-128, 127, "chroma_weight");
            h.co[x][i][j] = bs.se_range(-128, 127, "chroma_offset");
          }
        }
      }
  }
  if (ref_idc) {
    if (h.idr) {
      h.no_output_of_prior_pics = bs.u(1);
      h.long_term_reference = bs.u(1);
    } else if ((h.adaptive = bs.u(1))) {
      for (int k = 0;; ++k) {
        if (k > 66) corrupt("too many memory_management_control_operations");
        int op = bs.ue_max(6, "memory_management_control_operation");
        if (op == 0) break;
        int a = 0, c = 0;
        if (op == 1 || op == 3) a = bs.ue_max(131071, "difference_of_pic_nums_minus1");
        if (op == 2) a = bs.ue_max(31, "long_term_pic_num");
        if (op == 3 || op == 6) c = bs.ue_max(15, "long_term_frame_idx");
        if (op == 4) a = bs.ue_max(16, "max_long_term_frame_idx_plus1");
        h.mmco.push_back({op, a, c});
      }
    }
  }
  if (p.cabac && st != 2) h.cabac_init_idc = bs.ue_max(2, "cabac_init_idc");
  h.qp = p.init_qp + bs.se();
  if (h.qp < 0 || h.qp > 51) corrupt("slice QP out of range");
  if (p.deblock_control) {
    h.deblock_idc = bs.ue_max(2, "disable_deblocking_filter_idc");
    if (h.deblock_idc != 1) {
      h.alpha_off = 2 * bs.se_range(-6, 6, "slice_alpha_c0_offset_div2");
      h.beta_off = 2 * bs.se_range(-6, 6, "slice_beta_offset_div2");
    }
  }

  // a new picture: the first slice, or frame_num / PPS / IDR changing
  bool new_picture = !in_picture || h.first_mb == 0 || h.frame_num != first_hdr.frame_num ||
                     h.idr != first_hdr.idr || h.pps_id != first_hdr.pps_id ||
                     (h.idr && h.idr_pic_id != first_hdr.idr_pic_id) ||
                     h.poc_lsb != first_hdr.poc_lsb || (h.nal_ref_idc == 0) != (first_hdr.nal_ref_idc == 0);
  if (new_picture) {
    end_picture();
    if (h.first_mb != 0) corrupt("a picture whose first slice is missing (or arbitrary slice order)");
  } else if (h.first_mb <= last_mb) {
    unsupported("arbitrary slice order (ASO)");
  }
  sh = h;
  activate(h, new_picture);
  if (h.first_mb >= mbw * mbh) corrupt("first_mb_in_slice beyond the picture");
  if (new_picture) start_picture(h);
  list[0].clear();
  list[1].clear();
  if (st != 2) ref_lists(mods);
  if (st == 1 && pps->weighted_bipred_idc == 2) implicit_weights();
}

void Decoder::activate(const SliceHdr& h, bool new_picture) {
  const PPS& p = pps_[h.pps_id];
  const SPS& s = sps_[p.sps_id];
  if (new_picture) {
    bool size_change = !sps || s.mbw != mbw || s.mbh != mbh;
    if (size_change && !h.idr) corrupt("the picture size changes at a picture that is not IDR");
    if (size_change && h.idr) {
      output_ready(true);
      dpb.clear();
    }
    active_sps = p.sps_id;
    mbw = s.mbw;
    mbh = s.mbh;
  } else if (p.sps_id != active_sps) {
    corrupt("the slices of a picture refer to different sequence parameter sets");
  }
  sps = &s;
  pps = &p;
  setup_scaling();
}

void Decoder::start_picture(const SliceHdr& h) {
  const SPS& s = *sps;
  int max_frame_num = 1 << s.log2_max_frame_num;
  if (h.idr) {
    // every frame before it goes out (unless told not to), references go
    if (h.no_output_of_prior_pics) pending.clear();
    output_ready(true);
    for (auto& p : dpb) p->short_ref = p->long_ref = false;
    dpb.clear();
  } else {
    if (!have_prev) corrupt("the stream starts with a picture that is not IDR");
    if (h.frame_num != prev_ref_frame_num && h.frame_num != (prev_ref_frame_num + 1) % max_frame_num)
      unsupported("gaps_in_frame_num (frame_num jumps)");
  }
  cur = std::make_shared<Pic>();
  cur->y.assign((size_t)mbw * mbh * 256, 0);
  cur->cb.assign((size_t)mbw * mbh * 64, 128);
  cur->cr.assign((size_t)mbw * mbh * 64, 128);
  cur->frame_num = h.frame_num;
  cur->id = next_id++;
  cur->mbw = mbw;
  cur->mbh = mbh;
  memcpy(cur->crop, s.crop, sizeof cur->crop);
  mbs.assign((size_t)mbw * mbh, MB());
  slices.clear();
  n_slices = 0;
  last_mb = -1;
  in_picture = true;
  first_hdr = h;
  cur_mmco5 = false;
  for (auto& op : h.mmco)
    if (op[0] == 5) cur_mmco5 = true;

  // 8.2.1: picture order count
  if (s.poc_type == 0) {
    int pmsb = h.idr ? 0 : prev_poc_msb, plsb = h.idr ? 0 : prev_poc_lsb;
    int max_lsb = 1 << s.log2_max_poc_lsb, msb;
    if (h.poc_lsb < plsb && plsb - h.poc_lsb >= max_lsb / 2) msb = pmsb + max_lsb;
    else if (h.poc_lsb > plsb && h.poc_lsb - plsb > max_lsb / 2) msb = pmsb - max_lsb;
    else msb = pmsb;
    cur_top = msb + h.poc_lsb;
    cur_bottom = cur_top + h.delta_poc_bottom;
    cur_poc_msb = msb;
    cur_frame_num_offset = 0;
  } else {
    int fno;
    if (h.idr) fno = 0;
    else if (prev_frame_num > h.frame_num) fno = prev_frame_num_offset + max_frame_num;
    else fno = prev_frame_num_offset;
    cur_frame_num_offset = fno;
    if (s.poc_type == 1) {
      int64_t abs_fn = s.n_cycle ? (int64_t)fno + h.frame_num : 0;
      if (h.nal_ref_idc == 0 && abs_fn > 0) --abs_fn;
      int64_t expected = 0;
      if (abs_fn > 0) {
        int64_t delta_cycle = 0;
        for (int i = 0; i < s.n_cycle; ++i) delta_cycle += s.offset_for_ref_frame[i];
        int64_t cycles = (abs_fn - 1) / s.n_cycle, in_cycle = (abs_fn - 1) % s.n_cycle;
        expected = cycles * delta_cycle;
        for (int i = 0; i <= in_cycle; ++i) expected += s.offset_for_ref_frame[i];
      }
      if (h.nal_ref_idc == 0) expected += s.offset_for_non_ref_pic;
      cur_top = (int)(expected + h.delta_poc[0]);
      cur_bottom = cur_top + s.offset_for_top_to_bottom + h.delta_poc[1];
    } else {
      int t = h.idr ? 0 : (h.nal_ref_idc == 0 ? 2 * (fno + h.frame_num) - 1 : 2 * (fno + h.frame_num));
      cur_top = cur_bottom = t;
    }
  }
  cur->poc = std::min(cur_top, cur_bottom);
}

// 8.2.4: the initial lists (P: short-term by descending PicNum; B: list 0
// short-term before the current POC descending, then after it ascending,
// list 1 the other way round; then long-term by LongTermPicNum), list 1's
// first two entries swapped where it equals list 0 and has more than one,
// then each list cut to num_ref_idx_active and modified
void Decoder::ref_lists(const std::vector<std::array<int, 2>> mods[2]) {
  const SPS& s = *sps;
  int max_frame_num = 1 << s.log2_max_frame_num;
  std::vector<PicP> shorts, longs;
  for (auto& p : dpb) {
    if (p->short_ref) {
      p->frame_num_wrap = p->frame_num > sh.frame_num ? p->frame_num - max_frame_num : p->frame_num;
      shorts.push_back(p);
    } else if (p->long_ref) {
      longs.push_back(p);
    }
  }
  std::sort(longs.begin(), longs.end(), [](const PicP& a, const PicP& b) { return a->long_idx < b->long_idx; });
  std::vector<PicP> init[2];
  if (sh.type == 0) {
    std::sort(shorts.begin(), shorts.end(),
              [](const PicP& a, const PicP& b) { return a->frame_num_wrap > b->frame_num_wrap; });
    init[0] = shorts;
  } else {
    int poc = cur->poc;
    std::vector<PicP> before, after;
    for (auto& p : shorts) (p->poc < poc ? before : after).push_back(p);
    std::sort(before.begin(), before.end(), [](const PicP& a, const PicP& b) { return a->poc > b->poc; });
    std::sort(after.begin(), after.end(), [](const PicP& a, const PicP& b) { return a->poc < b->poc; });
    init[0] = before;
    init[0].insert(init[0].end(), after.begin(), after.end());
    init[1] = after;
    init[1].insert(init[1].end(), before.begin(), before.end());
    init[1].insert(init[1].end(), longs.begin(), longs.end());
    if (init[1].size() == 0) corrupt("a B slice with no reference picture");
  }
  init[0].insert(init[0].end(), longs.begin(), longs.end());
  if (sh.type == 1 && init[1].size() > 1 && init[1] == init[0]) std::swap(init[1][0], init[1][1]);
  for (int x = 0; x < (sh.type == 1 ? 2 : 1); ++x) {
    std::vector<PicP>& l = list[x];
    int n = sh.num_ref_idx[x];
    l = init[x];
    l.resize(n + 1);                            // nullptr: no reference picture
    int pred = sh.frame_num, ref_idx = 0;
    for (auto& m : mods[x]) {
      PicP pic;
      bool is_long = m[0] == 2;
      int pic_num = m[1];
      if (!is_long) {
        int diff = m[1] + 1;
        int no_wrap;
        if (m[0] == 0) {
          no_wrap = pred - diff;
          if (no_wrap < 0) no_wrap += max_frame_num;
        } else {
          no_wrap = pred + diff;
          if (no_wrap >= max_frame_num) no_wrap -= max_frame_num;
        }
        if (no_wrap < 0 || no_wrap >= max_frame_num) corrupt("abs_diff_pic_num_minus1 out of range");
        pred = no_wrap;
        pic_num = no_wrap > sh.frame_num ? no_wrap - max_frame_num : no_wrap;
        for (auto& p : shorts)
          if (p->frame_num_wrap == pic_num) pic = p;
        if (!pic) corrupt("a list modification names no short-term reference");
      } else {
        for (auto& p : longs)
          if (p->long_idx == pic_num) pic = p;
        if (!pic) corrupt("a list modification names no long-term reference");
      }
      for (int c = n; c > ref_idx; --c) l[c] = l[c - 1];
      l[ref_idx++] = pic;
      int k = ref_idx;
      for (int c = ref_idx; c <= n; ++c) {
        bool same = l[c] && (is_long ? l[c]->long_ref && l[c]->long_idx == pic_num
                                     : l[c]->short_ref && l[c]->frame_num_wrap == pic_num);
        if (!same) l[k++] = l[c];
      }
      if (ref_idx > n) corrupt("too many list modifications");
    }
    l.resize(n);
  }
}

// 8.4.2.3.1: the implicit weights w0 of each (refIdxL0, refIdxL1); w1 = 64 - w0
void Decoder::implicit_weights() {
  for (int i = 0; i < sh.num_ref_idx[0]; ++i)
    for (int j = 0; j < sh.num_ref_idx[1]; ++j) {
      const Pic* p0 = list[0][i].get();
      const Pic* p1 = list[1][j].get();
      int w = 32;
      if (p0 && p1 && !p0->long_ref && !p1->long_ref) {
        int td = clip3(-128, 127, p1->poc - p0->poc);
        if (td) {
          int tb = clip3(-128, 127, cur->poc - p0->poc);
          int tx = (16384 + std::abs(td / 2)) / td;
          int dsf = clip3(-1024, 1023, (tb * tx + 32) >> 6);
          if ((dsf >> 2) >= -64 && (dsf >> 2) <= 128) w = 64 - (dsf >> 2);
        }
      }
      implicit_w[i][j] = w;
    }
}

// ── slice data ──────────────────────────────────────────────────────────

void Decoder::cabac_init_engine() {
  range = 510;
  offset = bs.u(9);
  if (offset >= 510) corrupt("a CABAC offset of 510 or 511");
}

void Decoder::cabac_init_contexts() {
  int table = sh.type == 2 ? 0 : 1 + sh.cabac_init_idc;
  for (int i = 0; i < 460; ++i) {
    int m = CABAC_INIT[table][i][0], n = CABAC_INIT[table][i][1];
    int pre = clip3(1, 126, ((m * clip3(0, 51, sh.qp)) >> 4) + n);
    ctx[i] = pre <= 63 ? (uint8_t)((63 - pre) << 1) : (uint8_t)(((pre - 64) << 1) | 1);
  }
}

inline int Decoder::dec(int i) {
  uint8_t s = ctx[i];
  int state = s >> 1, mps = s & 1;
  uint32_t lps = RANGE_TAB_LPS[state][(range >> 6) & 3];
  range -= lps;
  int bin;
  if (offset >= range) {
    bin = !mps;
    offset -= range;
    range = lps;
    if (state == 0) mps = 1 - mps;
    state = TRANS_IDX_LPS[state];
  } else {
    bin = mps;
    if (state < 62) ++state;
  }
  ctx[i] = (uint8_t)(state << 1 | mps);
  while (range < 256) {
    range <<= 1;
    offset = (offset << 1) | bs.bit();
  }
  return bin;
}

inline int Decoder::bypass() {
  offset = (offset << 1) | bs.bit();
  if (offset >= range) {
    offset -= range;
    return 1;
  }
  return 0;
}

inline int Decoder::terminate() {
  range -= 2;
  if (offset >= range) return 1;
  while (range < 256) {
    range <<= 1;
    offset = (offset << 1) | bs.bit();
  }
  return 0;
}

void Decoder::slice_data() {
  slice_num = n_slices++;
  SliceParams sp;
  sp.deblock_idc = sh.deblock_idc;
  sp.alpha_off = sh.alpha_off;
  sp.beta_off = sh.beta_off;
  sp.cqp_offset[0] = pps->cqp_offset[0];
  sp.cqp_offset[1] = pps->cqp_offset[1];
  slices.push_back(sp);
  qp = sh.qp;
  prev_mb_in_slice = -1;
  mb_addr = sh.first_mb;
  int n = (int)mbs.size();
  if (pps->cabac) {
    while (bs.pos & 7)
      if (!bs.bit()) corrupt("cabac_alignment_one_bit is 0");
    bs.lim = bs.end;
    cabac_init_contexts();
    cabac_init_engine();
    for (;;) {
      if (mb_addr >= n) corrupt("macroblocks beyond the picture");
      mbx = mb_addr % mbw;
      mby = mb_addr / mbw;
      bool skip = false;
      if (sh.type != 2) {
        int a = addr_a(), b = addr_b();
        int inc = (avail(a) && mbs[a].kind != SKIP) + (avail(b) && mbs[b].kind != SKIP);
        skip = dec((sh.type == 0 ? 11 : 24) + inc);
      }
      macroblock(skip);
      last_mb = mb_addr;
      if (terminate()) break;
      ++mb_addr;
    }
  } else {
    for (;;) {
      bool more = true;
      if (sh.type != 2) {
        uint32_t run = bs.ue();
        if (run > (uint32_t)(n - mb_addr)) corrupt("mb_skip_run beyond the picture");
        for (uint32_t i = 0; i < run; ++i) {
          mbx = mb_addr % mbw;
          mby = mb_addr / mbw;
          macroblock(true);
          last_mb = mb_addr;
          ++mb_addr;
        }
        if (run > 0) more = bs.more_rbsp_data();
      }
      if (more) {
        if (mb_addr >= n) corrupt("macroblocks beyond the picture");
        mbx = mb_addr % mbw;
        mby = mb_addr / mbw;
        macroblock(false);
        last_mb = mb_addr;
        ++mb_addr;
        more = bs.more_rbsp_data();
      }
      if (!more) break;
    }
  }
}

// ── macroblock layer ────────────────────────────────────────────────────

int Decoder::read_mb_type() {
  // 0-4 P types (4 P_8x8ref0), 5 I_NxN, 6-29 Intra_16x16, 30 I_PCM, 31-53 B
  // types 0-22
  bool p = sh.type == 0, b = sh.type == 1;
  if (!pps->cabac) {
    int t = bs.ue_max(p ? 30 : b ? 48 : 25, "mb_type");
    if (b) return t < 23 ? 31 + t : t - 18;
    return p ? t : t + 5;
  }
  int base, inc0 = 0;
  if (p) {
    if (!dec(14)) {
      if (!dec(15)) return dec(16) ? 3 : 0;
      return dec(17) ? 1 : 2;
    }
    base = 17;
  } else if (b) {
    // Table 9-37 (b) with the bins' contexts of 9.3.3.1.2, as FFmpeg reads them
    int a = addr_a(), bb = addr_b();
    int inc = (avail(a) && mbs[a].kind != SKIP && mbs[a].kind != BDIRECT) +
              (avail(bb) && mbs[bb].kind != SKIP && mbs[bb].kind != BDIRECT);
    if (!dec(27 + inc)) return 31;
    if (!dec(27 + 3)) return 31 + 1 + dec(27 + 5);
    int bits = dec(27 + 4) << 3;
    bits |= dec(27 + 5) << 2;
    bits |= dec(27 + 5) << 1;
    bits |= dec(27 + 5);
    if (bits < 8) return 31 + bits + 3;
    if (bits == 14) return 31 + 11;
    if (bits == 15) return 31 + 22;
    if (bits != 13) return 31 + ((bits << 1) | dec(27 + 5)) - 4;
    base = 32;                                       // an intra prefix: the I suffix
  } else {
    base = 3;
    int a = addr_a(), bb = addr_b();
    inc0 = (avail(a) && mbs[a].kind != I4x4 && mbs[a].kind != I8x8) +
           (avail(bb) && mbs[bb].kind != I4x4 && mbs[bb].kind != I8x8);
  }
  if (!dec(base + inc0)) return 5;
  if (terminate()) return 30;
  int luma, cnz, c2 = 0, hi, lo;
  if (base == 3) {
    luma = dec(3 + 3);
    cnz = dec(3 + 4);
    if (cnz) c2 = dec(3 + 5);
    hi = dec(3 + 6);
    lo = dec(3 + 7);
  } else {
    luma = dec(base + 1);
    cnz = dec(base + 2);
    if (cnz) c2 = dec(base + 2);
    hi = dec(base + 3);
    lo = dec(base + 3);
  }
  return 5 + 1 + (hi * 2 + lo) + 4 * (cnz ? (c2 ? 2 : 1) : 0) + 12 * luma;
}

int Decoder::read_b_sub_type() {
  if (!pps->cabac) return bs.ue_max(12, "sub_mb_type");
  if (!dec(36)) return 0;
  if (!dec(37)) return 1 + dec(39);
  int t = 3;
  if (dec(38)) {
    if (dec(39)) return 11 + dec(39);
    t += 4;
  }
  t += 2 * dec(39);
  t += dec(39);
  return t;
}

// a fresh inter macroblock: no list used, no motion
void clear_motion(MB& m) {
  memset(m.ref, -1, sizeof m.ref);
  memset(m.mv, 0, sizeof m.mv);
  memset(m.mvd, 0, sizeof m.mvd);
  memset(m.refpic, 0, sizeof m.refpic);
  memset(m.direct, 0, sizeof m.direct);
}

void Decoder::set_refpics(MB& m) {
  for (int x = 0; x < 2; ++x)
    for (int i = 0; i < 4; ++i) {
      int r = m.ref[x][i];
      if (r < 0) continue;
      if (r >= (int)list[x].size() || !list[x][r]) corrupt("a reference index names no reference picture");
      m.refpic[x][i] = list[x][r]->id;
    }
}

void Decoder::skip_mb() {
  MB& m = mbs[mb_addr];
  m = MB();
  m.slice = slice_num;
  m.kind = SKIP;
  m.qp = qp;
  memset(m.nz, 0, sizeof m.nz);
  memset(m.nzc, 0, sizeof m.nzc);
  memset(m.nzd, 0, sizeof m.nzd);
  memset(m.cbf_dc, 0, sizeof m.cbf_dc);
  memset(m.ipred, 2, sizeof m.ipred);
  clear_motion(m);
  std::vector<Partition> parts;
  if (sh.type == 1) {                               // B_Skip: direct prediction
    direct(m, -1, parts);
    set_refpics(m);
    recon_inter(m, parts);
    return;
  }
  if (!list[0].size() || !list[0][0]) corrupt("a P_Skip macroblock with no reference picture");
  // 8.4.1.1
  int mx = 0, my = 0;
  int xw, yw;
  int a = locate(-1, 0, &xw, &yw), b = locate(0, -1, &xw, &yw);
  bool zero = a < 0 || b < 0;
  if (!zero) {
    int ra, ax, ay, rb, bx, by;
    bool av;
    neighbour_motion(0, -1, 0, &ra, &ax, &ay, &av);
    neighbour_motion(0, 0, -1, &rb, &bx, &by, &av);
    zero = (ra == 0 && ax == 0 && ay == 0) || (rb == 0 && bx == 0 && by == 0);
  }
  if (!zero) mvp(0, 0, 0, 16, 0, 0, &mx, &my);
  for (int i = 0; i < 4; ++i) m.ref[0][i] = 0;
  for (int i = 0; i < 16; ++i) {
    m.mv[0][i][0] = (int16_t)mx;
    m.mv[0][i][1] = (int16_t)my;
  }
  set_refpics(m);
  parts.push_back({0, 0, 16, 16, 1, {0, -1}, {{mx, my}, {0, 0}}});
  recon_inter(m, parts);
}

void Decoder::neighbour_motion(int list_x, int xN, int yN, int* ref, int* mx, int* my, bool* available) {
  int xw, yw;
  int addr = locate(xN, yN, &xw, &yw);
  *ref = -1;
  *mx = *my = 0;
  *available = false;
  if (addr < 0) return;
  int r4 = (yw >> 2) * 4 + (xw >> 2);
  if (addr == mb_addr && !done4[r4]) return;          // not yet decoded
  *available = true;
  const MB& n = mbs[addr];
  if (n.intra) return;
  *ref = n.ref[list_x][(yw >> 3) * 2 + (xw >> 3)];
  if (*ref < 0) return;
  *mx = n.mv[list_x][r4][0];
  *my = n.mv[list_x][r4][1];
}

// 8.4.1.3: the predictor of list list_x for the partition at (x, y), w wide,
// with reference index ref; shape 1: 16x8, 2: 8x16 (the directional rules),
// else 0
void Decoder::mvp(int list_x, int x, int y, int w, int ref, int shape, int* px, int* py) {
  int ra, ax, ay, rb, bx, by, rc, cx, cy;
  bool aa, ab, ac;
  neighbour_motion(list_x, x - 1, y, &ra, &ax, &ay, &aa);
  neighbour_motion(list_x, x, y - 1, &rb, &bx, &by, &ab);
  neighbour_motion(list_x, x + w, y - 1, &rc, &cx, &cy, &ac);
  if (!ac) neighbour_motion(list_x, x - 1, y - 1, &rc, &cx, &cy, &ac);
  if (shape == 1) {
    if (y == 0 && rb == ref) { *px = bx; *py = by; return; }
    if (y != 0 && ra == ref) { *px = ax; *py = ay; return; }
  } else if (shape == 2) {
    if (x == 0 && ra == ref) { *px = ax; *py = ay; return; }
    if (x != 0 && rc == ref) { *px = cx; *py = cy; return; }
  }
  if (!ab && !ac && aa) {
    rb = rc = ra;
    bx = cx = ax;
    by = cy = ay;
  }
  int hits = (ra == ref) + (rb == ref) + (rc == ref);
  if (hits == 1) {
    if (ra == ref) { *px = ax; *py = ay; }
    else if (rb == ref) { *px = bx; *py = by; }
    else { *px = cx; *py = cy; }
    return;
  }
  *px = median3(ax, bx, cx);
  *py = median3(ay, by, cy);
}

// 8.4.1.2.2: the reference indices of spatial direct prediction and the
// predictor of each list used (refIdx -1: the list is not used)
void Decoder::spatial_refs(int ref[2], int mv[2][2]) {
  for (int x = 0; x < 2; ++x) {
    int r[3], vx, vy;
    bool av;
    neighbour_motion(x, -1, 0, &r[0], &vx, &vy, &av);
    neighbour_motion(x, 0, -1, &r[1], &vx, &vy, &av);
    neighbour_motion(x, 16, -1, &r[2], &vx, &vy, &av);
    if (!av) neighbour_motion(x, -1, -1, &r[2], &vx, &vy, &av);
    auto min_positive = [](int a, int b) { return a >= 0 && b >= 0 ? std::min(a, b) : std::max(a, b); };
    ref[x] = min_positive(r[0], min_positive(r[1], r[2]));
  }
  if (ref[0] < 0 && ref[1] < 0) {                   // directZeroPrediction
    ref[0] = ref[1] = 0;
    memset(mv, 0, 4 * sizeof(int));
    return;
  }
  for (int x = 0; x < 2; ++x) {
    mv[x][0] = mv[x][1] = 0;
    if (ref[x] >= 0) mvp(x, 0, 0, 16, ref[x], 0, &mv[x][0], &mv[x][1]);
  }
}

// 8.4.1.2: direct prediction of the 8x8 block b8 (-1: the whole macroblock),
// in 8x8 parts where direct_8x8_inference_flag is 1 (each reading the
// co-located picture's corner 4x4 block), else in 4x4 parts
void Decoder::direct(MB& m, int b8, std::vector<Partition>& parts) {
  if (list[1].empty() || !list[1][0]) corrupt("direct prediction with no RefPicList1[0]");
  const Pic& col = *list[1][0];
  if (col.mbs.size() != mbs.size()) corrupt("direct prediction from a picture of another size");
  const MB& cm = col.mbs[mb_addr];
  bool inference = sps->direct_8x8_inference;
  int sref[2], smv[2][2];
  if (sh.direct_spatial) spatial_refs(sref, smv);
  for (int i = b8 < 0 ? 0 : b8; i < (b8 < 0 ? 4 : b8 + 1); ++i) {
    m.direct[i] = true;
    int x8 = (i & 1) * 8, y8 = (i >> 1) * 8;
    int step = inference ? 8 : 4;
    for (int y = y8; y < y8 + 8; y += step)
      for (int x = x8; x < x8 + 8; x += step) {
        // the co-located 4x4 block: the corner of the 8x8 under inference
        int cx = inference ? (x8 ? 12 : 0) : x, cy = inference ? (y8 ? 12 : 0) : y;
        int c4 = (cy >> 2) * 4 + (cx >> 2), c8 = (cy >> 3) * 2 + (cx >> 3);
        int ref_col = -1, mv_col[2] = {0, 0};
        uint64_t pic_col = 0;
        if (!cm.intra) {
          int cl = cm.ref[0][c8] >= 0 ? 0 : 1;
          ref_col = cm.ref[cl][c8];
          mv_col[0] = cm.mv[cl][c4][0];
          mv_col[1] = cm.mv[cl][c4][1];
          pic_col = cm.refpic[cl][c8];
        }
        Partition q{x, y, step, step, 0, {-1, -1}, {{0, 0}, {0, 0}}};
        if (sh.direct_spatial) {
          bool col_zero =
              col.short_ref && ref_col == 0 && std::abs(mv_col[0]) <= 1 && std::abs(mv_col[1]) <= 1;
          for (int l = 0; l < 2; ++l) {
            q.ref[l] = sref[l];
            if (sref[l] < 0) continue;
            q.flags |= 1 << l;
            if (!(sref[l] == 0 && col_zero)) {
              q.mv[l][0] = smv[l][0];
              q.mv[l][1] = smv[l][1];
            }
          }
        } else {
          int r0 = 0;
          if (ref_col >= 0) {
            r0 = -1;
            for (int k = 0; k < (int)list[0].size() && r0 < 0; ++k)
              if (list[0][k] && list[0][k]->id == pic_col) r0 = k;
            if (r0 < 0) corrupt("temporal direct: the co-located block's reference is not in list 0");
          }
          if (r0 >= (int)list[0].size() || !list[0][r0]) corrupt("temporal direct with no RefPicList0[0]");
          const Pic& p0 = *list[0][r0];
          int td = clip3(-128, 127, col.poc - p0.poc);
          q.flags = 3;
          q.ref[0] = r0;
          q.ref[1] = 0;
          for (int c = 0; c < 2; ++c) {
            int v0 = mv_col[c];
            if (!p0.long_ref && td != 0) {
              int tb = clip3(-128, 127, cur->poc - p0.poc);
              int tx = (16384 + std::abs(td / 2)) / td;
              int dsf = clip3(-1024, 1023, (tb * tx + 32) >> 6);
              v0 = (dsf * mv_col[c] + 128) >> 8;
            }
            q.mv[0][c] = v0;
            q.mv[1][c] = v0 - mv_col[c];
          }
        }
        for (int l = 0; l < 2; ++l)
          for (int c = 0; c < 2; ++c)
            if (q.mv[l][c] < -32768 || q.mv[l][c] > 32767) corrupt("a direct motion vector out of range");
        for (int l = 0; l < 2; ++l) {
          m.ref[l][i] = (int8_t)q.ref[l];
          for (int yy = y; yy < y + step; yy += 4)
            for (int xx = x; xx < x + step; xx += 4) {
              int r = (yy >> 2) * 4 + (xx >> 2);
              m.mv[l][r][0] = (int16_t)q.mv[l][0];
              m.mv[l][r][1] = (int16_t)q.mv[l][1];
            }
        }
        parts.push_back(q);
      }
  }
}

int Decoder::cabac_mvd(int base, int sum) {
  int inc = sum < 3 ? 0 : (sum > 32 ? 2 : 1);
  if (!dec(base + inc)) return 0;
  int v = 1;
  while (v < 9 && dec(base + (v >= 4 ? 6 : v + 2))) ++v;
  if (v >= 9) {
    int k = 3;
    while (bypass()) {
      v += 1 << k;
      if (++k > 24) corrupt("an mvd beyond its range");
    }
    while (k--) v += bypass() << k;
  }
  return bypass() ? -v : v;
}

// ref_idx_lX of the partition at (x, y); the CABAC context counts a
// neighbour that is skipped, intra, direct or not using the list as 0
int Decoder::read_ref(MB& m, int lx, int x, int y) {
  int nref = sh.num_ref_idx[lx];
  if (nref == 1) return 0;
  if (!pps->cabac) {
    if (nref == 2) return !bs.u(1);
    return (int)bs.ue_max(nref - 1, "ref_idx");
  }
  int cond[2];
  for (int k = 0; k < 2; ++k) {
    int xw, yw;
    int addr = locate(k == 0 ? x - 1 : x, k == 0 ? y : y - 1, &xw, &yw);
    cond[k] = 0;
    if (addr < 0) continue;
    const MB& n = addr == mb_addr ? m : mbs[addr];
    int b8 = (yw >> 3) * 2 + (xw >> 3);
    if (n.kind == SKIP || n.intra || n.direct[b8]) continue;
    cond[k] = n.ref[lx][b8] > 0;
  }
  int v = 0, c = 54 + cond[0] + 2 * cond[1];
  while (dec(c)) {
    if (++v >= nref) corrupt("ref_idx beyond the list");
    c = 54 + (v == 1 ? 4 : 5);
  }
  return v;
}

int Decoder::read_mvd(int lx, int x, int y, int comp) {
  if (!pps->cabac) return bs.se_range(-32768, 32767, "mvd");
  int sum = 0;
  for (int k = 0; k < 2; ++k) {
    int xw, yw;
    int addr = locate(k == 0 ? x - 1 : x, k == 0 ? y : y - 1, &xw, &yw);
    if (addr < 0) continue;
    const MB& n = mbs[addr];
    if (addr != mb_addr && (n.kind == SKIP || n.intra)) continue;
    sum += n.mvd[lx][(yw >> 2) * 4 + (xw >> 2)][comp];
  }
  int v = cabac_mvd(comp == 0 ? 40 : 47, sum);
  if (v < -32768 || v > 32767) corrupt("mvd out of range");
  return v;
}

// the motion vectors of list lx of the partitions in order: each one using
// the list reads its mvd and adds the predictor; done4 marks the partitions
// decoded so far for this list (a direct one counts when its turn comes)
static void set_done(bool* done4, const Partition& p) {
  for (int y = p.y; y < p.y + p.h; y += 4)
    for (int x = p.x; x < p.x + p.w; x += 4) done4[(y >> 2) * 4 + (x >> 2)] = true;
}

void Decoder::inter_pred(MB& m, int kind, std::vector<Partition>& parts) {
  // P macroblocks: list 0 only
  if (kind == P8x8 || kind == P8x8REF0) {
    int sub[4];
    for (int i = 0; i < 4; ++i) {
      if (pps->cabac) {
        if (dec(21)) sub[i] = 0;
        else if (!dec(22)) sub[i] = 1;
        else sub[i] = dec(23) ? 2 : 3;
      } else {
        sub[i] = bs.ue_max(3, "sub_mb_type");
      }
    }
    for (int i = 0; i < 4; ++i) {
      int r = kind == P8x8REF0 ? 0 : read_ref(m, 0, (i & 1) * 8, (i >> 1) * 8);
      m.ref[0][i] = (int8_t)r;
    }
    for (int i = 0; i < 4; ++i) {
      int x0 = (i & 1) * 8, y0 = (i >> 1) * 8;
      int sw = sub[i] == 0 || sub[i] == 1 ? 8 : 4, shh = sub[i] == 0 || sub[i] == 2 ? 8 : 4;
      for (int y = y0; y < y0 + 8; y += shh)
        for (int x = x0; x < x0 + 8; x += sw)
          parts.push_back({x, y, sw, shh, 1, {m.ref[0][i], -1}, {{0, 0}, {0, 0}}});
    }
  } else {
    if (kind == P16x16) parts = {{0, 0, 16, 16, 1, {0, -1}, {}}};
    else if (kind == P16x8) parts = {{0, 0, 16, 8, 1, {0, -1}, {}}, {0, 8, 16, 8, 1, {0, -1}, {}}};
    else parts = {{0, 0, 8, 16, 1, {0, -1}, {}}, {8, 0, 8, 16, 1, {0, -1}, {}}};
    for (auto& p : parts) {
      p.ref[0] = read_ref(m, 0, p.x, p.y);
      for (int y = p.y; y < p.y + p.h; y += 8)
        for (int x = p.x; x < p.x + p.w; x += 8) m.ref[0][(y >> 3) * 2 + (x >> 3)] = (int8_t)p.ref[0];
    }
  }
  int shape = kind == P16x8 ? 1 : kind == P8x16 ? 2 : 0;
  for (auto& p : parts) {
    int dx = read_mvd(0, p.x, p.y, 0), dy = read_mvd(0, p.x, p.y, 1);
    int px, py;
    mvp(0, p.x, p.y, p.w, p.ref[0], shape, &px, &py);
    int mx = px + dx, my = py + dy;
    if (mx < -32768 || mx > 32767 || my < -32768 || my > 32767) corrupt("a motion vector out of range");
    p.mv[0][0] = mx;
    p.mv[0][1] = my;
    for (int y = p.y; y < p.y + p.h; y += 4)
      for (int x = p.x; x < p.x + p.w; x += 4) {
        int r = (y >> 2) * 4 + (x >> 2);
        m.mv[0][r][0] = (int16_t)mx;
        m.mv[0][r][1] = (int16_t)my;
        m.mvd[0][r][0] = (uint8_t)std::min(std::abs(dx), 255);
        m.mvd[0][r][1] = (uint8_t)std::min(std::abs(dy), 255);
      }
    set_done(done4, p);
  }
}

// mb_pred / sub_mb_pred of a B macroblock (btype 1-22; 0 is B_Direct_16x16)
void Decoder::b_pred(MB& m, int btype, std::vector<Partition>& parts) {
  int shape = B_MB_TYPE[btype][0];
  // the partitions in decoding order; flags 0: a direct 8x8 (filled below)
  std::vector<Partition> ps;
  int sub[4] = {0, 0, 0, 0};
  if (shape == 4) {
    for (int i = 0; i < 4; ++i) sub[i] = read_b_sub_type();
    for (int i = 0; i < 4; ++i) {
      int w = B_SUB_MB_TYPE[sub[i]][0], h = B_SUB_MB_TYPE[sub[i]][1], f = B_SUB_MB_TYPE[sub[i]][2];
      if (f == 0) {
        m.direct[i] = true;
        ps.push_back({(i & 1) * 8, (i >> 1) * 8, 8, 8, 0, {-1, -1}, {}});
        continue;
      }
      for (int y = (i >> 1) * 8; y < (i >> 1) * 8 + 8; y += h)
        for (int x = (i & 1) * 8; x < (i & 1) * 8 + 8; x += w) ps.push_back({x, y, w, h, f, {-1, -1}, {}});
    }
  } else {                                          // 16x16, 16x8 or 8x16
    int w = shape == 3 ? 8 : 16, h = shape == 2 ? 8 : 16;
    for (int i = 0; i < (shape == 1 ? 1 : 2); ++i)
      ps.push_back({shape == 3 ? 8 * i : 0, shape == 2 ? 8 * i : 0, w, h, B_MB_TYPE[btype][1 + i], {-1, -1}, {}});
  }
  // ref_idx_l0 of each partition (8x8 for B_8x8), then ref_idx_l1
  for (int lx = 0; lx < 2; ++lx) {
    for (auto& p : ps) {
      if (!(p.flags >> lx & 1)) continue;
      int b8 = (p.y >> 3) * 2 + (p.x >> 3);
      if (shape == 4 && (p.x & 7 || p.y & 7)) {       // the sub-partitions share their 8x8's
        p.ref[lx] = m.ref[lx][b8];
        continue;
      }
      p.ref[lx] = read_ref(m, lx, p.x, p.y);
      for (int y = p.y; y < p.y + std::max(p.h, 8); y += 8)
        for (int x = p.x; x < p.x + std::max(p.w, 8); x += 8)
          m.ref[lx][(y >> 3) * 2 + (x >> 3)] = (int8_t)p.ref[lx];
    }
  }
  // mvd_l0 of each partition, then mvd_l1; a direct 8x8 is predicted when
  // list 0 reaches it
  int pshape = shape == 2 ? 1 : shape == 3 ? 2 : 0;
  for (int lx = 0; lx < 2; ++lx) {
    memset(done4, 0, sizeof done4);
    for (auto& p : ps) {
      if (p.flags == 0) {
        int b8 = (p.y >> 3) * 2 + (p.x >> 3);
        if (lx == 0) direct(m, b8, parts);
        set_done(done4, p);
        continue;
      }
      if (p.flags >> lx & 1) {
        int dx = read_mvd(lx, p.x, p.y, 0), dy = read_mvd(lx, p.x, p.y, 1);
        int px, py;
        mvp(lx, p.x, p.y, p.w, p.ref[lx], pshape, &px, &py);
        int mx = px + dx, my = py + dy;
        if (mx < -32768 || mx > 32767 || my < -32768 || my > 32767) corrupt("a motion vector out of range");
        p.mv[lx][0] = mx;
        p.mv[lx][1] = my;
        for (int y = p.y; y < p.y + p.h; y += 4)
          for (int x = p.x; x < p.x + p.w; x += 4) {
            int r = (y >> 2) * 4 + (x >> 2);
            m.mv[lx][r][0] = (int16_t)mx;
            m.mv[lx][r][1] = (int16_t)my;
            m.mvd[lx][r][0] = (uint8_t)std::min(std::abs(dx), 255);
            m.mvd[lx][r][1] = (uint8_t)std::min(std::abs(dy), 255);
          }
      }
      set_done(done4, p);
    }
  }
  for (auto& p : ps)
    if (p.flags) parts.push_back(p);
}

void Decoder::intra_pred_modes(MB& m, bool t8) {
  // 8.3.1.1 / 8.3.2.1: predIntraMxMPredMode from the left and upper blocks
  auto neighbour_mode = [&](int xN, int yN, bool* dc) -> int {
    int xw, yw;
    int addr = locate(xN, yN, &xw, &yw);
    if (addr < 0) {
      *dc = true;
      return 2;
    }
    const MB& n = mbs[addr];
    if (!n.intra && pps->constrained_intra) {
      *dc = true;
      return 2;
    }
    if (n.kind != I4x4 && n.kind != I8x8) return 2;
    return n.ipred[(yw >> 2) * 4 + (xw >> 2)];
  };
  bool cabac = pps->cabac;
  int count = t8 ? 4 : 16;
  for (int i = 0; i < count; ++i) {
    int x, y;
    if (t8) {
      x = (i & 1) * 8;
      y = (i >> 1) * 8;
    } else {
      int r = BLK_RASTER[i];
      x = (r & 3) * 4;
      y = (r >> 2) * 4;
    }
    int prev, rem = 0;
    if (cabac) {
      prev = dec(68);
      if (!prev) rem = dec(69) | dec(69) << 1 | dec(69) << 2;
    } else {
      prev = bs.u(1);
      if (!prev) rem = bs.u(3);
    }
    bool dc = false;
    int ma, mb_;
    if (t8) {
      // an I4x4 neighbour's mode is that of its 4x4 block n = 1 (left) or 2
      // (above) of the 8x8 block; ipred holds the 4x4 modes by raster, so the
      // blocks at (x - 1, y) and (x, y - 1) are those blocks
      ma = neighbour_mode(x - 1, y, &dc);
      mb_ = neighbour_mode(x, y - 1, &dc);
      int xw, yw, addr = locate(x - 1, y, &xw, &yw);
      if (!dc && addr >= 0 && mbs[addr].kind == I4x4 && addr != mb_addr)
        ma = mbs[addr].ipred[((yw >> 3) * 2) * 4 + ((xw >> 3) * 2) + 1];
      addr = locate(x, y - 1, &xw, &yw);
      if (!dc && addr >= 0 && mbs[addr].kind == I4x4 && addr != mb_addr)
        mb_ = mbs[addr].ipred[((yw >> 3) * 2 + 1) * 4 + ((xw >> 3) * 2)];
    } else {
      ma = neighbour_mode(x - 1, y, &dc);
      mb_ = neighbour_mode(x, y - 1, &dc);
    }
    int pred = dc ? 2 : std::min(ma, mb_);
    int mode = prev ? pred : (rem < pred ? rem : rem + 1);
    if (t8) {
      for (int yy = y; yy < y + 8; yy += 4)
        for (int xx = x; xx < x + 8; xx += 4) m.ipred[(yy >> 2) * 4 + (xx >> 2)] = (int8_t)mode;
    } else {
      m.ipred[(y >> 2) * 4 + (x >> 2)] = (int8_t)mode;
    }
  }
}

void Decoder::macroblock(bool skip) {
  MB& m = mbs[mb_addr];
  if (m.slice >= 0) corrupt("a macroblock is coded twice");
  memset(done4, 0, sizeof done4);
  if (skip) {
    skip_mb();
    prev_mb_in_slice = mb_addr;
    return;
  }
  int t = read_mb_type();
  m = MB();
  m.slice = slice_num;
  memset(m.nz, 0, sizeof m.nz);
  memset(m.nzc, 0, sizeof m.nzc);
  memset(m.nzd, 0, sizeof m.nzd);
  memset(m.cbf_dc, 0, sizeof m.cbf_dc);
  memset(m.ipred, 2, sizeof m.ipred);
  clear_motion(m);
  bool cabac = pps->cabac;
  if (t == 30) {                                    // I_PCM
    m.kind = IPCM;
    m.intra = true;
    m.qp = qp;
    m.cbp = 0x2F;
    while (bs.pos & 7)
      if (bs.bit()) corrupt("pcm_alignment_zero_bit is 1");
    for (int i = 0; i < 384; ++i) pcm[i] = (uint8_t)bs.u(8);
    memset(m.nz, 16, sizeof m.nz);
    memset(m.nzc, 16, sizeof m.nzc);
    for (int i = 0; i < 16; ++i) m.nzd[i] = true;
    for (int i = 0; i < 3; ++i) m.cbf_dc[i] = true;
    if (cabac) cabac_init_engine();
    recon_pcm();
    m.qp_delta = 0;
    prev_mb_in_slice = mb_addr;
    return;
  }
  std::vector<Partition> parts;
  int cbp = 0;
  if (t >= 5 && t <= 30) {
    m.intra = true;
    bool t8 = false;
    if (t == 5) {
      if (pps->t8x8) t8 = cabac ? dec(399 + [&] {
        int a = addr_a(), b = addr_b();
        return (avail(a) && mbs[a].t8x8) + (avail(b) && mbs[b].t8x8);
      }()) : bs.u(1);
      m.kind = t8 ? I8x8 : I4x4;
      m.t8x8 = t8;
      intra_pred_modes(m, t8);
    } else {
      m.kind = I16;
      int k = t - 6;
      m.i16mode = k % 4;
      m.cbp = (k >= 12 ? 15 : 0) | (((k / 4) % 3) << 4);
    }
    // intra_chroma_pred_mode
    if (cabac) {
      int inc = 0;
      for (int a : {addr_a(), addr_b()})
        if (avail(a) && mbs[a].intra && mbs[a].kind != IPCM && mbs[a].chroma_mode != 0) ++inc;
      if (!dec(64 + inc)) m.chroma_mode = 0;
      else if (!dec(67)) m.chroma_mode = 1;
      else m.chroma_mode = dec(67) ? 3 : 2;
    } else {
      m.chroma_mode = bs.ue_max(3, "intra_chroma_pred_mode");
    }
  } else if (t < 5) {
    m.kind = (uint8_t)t;
    if (!list[0].size()) corrupt("an inter macroblock in a slice with no reference list");
    inter_pred(m, t, parts);
    set_refpics(m);
  } else {
    int bt = t - 31;
    int shape = B_MB_TYPE[bt][0];
    m.kind = shape == 0 ? BDIRECT : shape == 1 ? P16x16 : shape == 2 ? P16x8 : shape == 3 ? P8x16 : B8x8;
    if (bt == 0) direct(m, -1, parts);
    else b_pred(m, bt, parts);
    set_refpics(m);
  }
  if (m.kind != I16) {
    if (cabac) {
      int a = addr_a(), b = addr_b();
      for (int b8 = 0; b8 < 4; ++b8) {
        int bitA, bitB;
        if (b8 & 1) bitA = (cbp >> (b8 - 1)) & 1;
        else if (!avail(a) || mbs[a].kind == IPCM) bitA = 1;
        else if (mbs[a].kind == SKIP) bitA = 0;
        else bitA = (mbs[a].cbp >> (b8 + 1)) & 1;
        if (b8 & 2) bitB = (cbp >> (b8 - 2)) & 1;
        else if (!avail(b) || mbs[b].kind == IPCM) bitB = 1;
        else if (mbs[b].kind == SKIP) bitB = 0;
        else bitB = (mbs[b].cbp >> (b8 + 2)) & 1;
        cbp |= dec(73 + (!bitA) + 2 * (!bitB)) << b8;
      }
      int ca[2] = {0, 0}, cb[2] = {0, 0};
      for (int k = 0; k < 2; ++k) {
        int n = k == 0 ? a : b;
        int* c = k == 0 ? ca : cb;
        if (!avail(n)) continue;
        const MB& nm = mbs[n];
        if (nm.kind == IPCM) {
          c[0] = c[1] = 1;
        } else if (nm.kind != SKIP) {
          c[0] = (nm.cbp >> 4) != 0;
          c[1] = (nm.cbp >> 4) == 2;
        }
      }
      if (dec(77 + ca[0] + 2 * cb[0])) cbp |= (dec(77 + ca[1] + 2 * cb[1] + 4) ? 2 : 1) << 4;
    } else {
      int code = bs.ue_max(47, "coded_block_pattern");
      cbp = m.intra ? INTRA_CBP[code] : INTER_CBP[code];
    }
    m.cbp = cbp;
    if (!m.intra && (cbp & 15) && pps->t8x8) {
      // no partition under 8x8: a direct one is 8x8 only under
      // direct_8x8_inference_flag
      bool small = false;
      for (auto& p : parts)
        if (p.w < 8 || p.h < 8) small = true;
      if (!small) {
        if (cabac) {
          int a = addr_a(), b = addr_b();
          m.t8x8 = dec(399 + (avail(a) && mbs[a].t8x8) + (avail(b) && mbs[b].t8x8));
        } else {
          m.t8x8 = bs.u(1);
        }
      }
    }
  }
  m.qp_delta = 0;
  if ((m.cbp & 0x3F) || m.kind == I16) {
    int delta;
    if (cabac) {
      int inc = 0;
      if (prev_mb_in_slice >= 0) {
        const MB& p = mbs[prev_mb_in_slice];
        inc = !(p.kind == SKIP || p.kind == IPCM || (p.kind != I16 && (p.cbp & 0x3F) == 0) || p.qp_delta == 0);
      }
      if (!dec(60 + inc)) {
        delta = 0;
      } else {
        int k = 1, c = 62;
        while (dec(c)) {
          if (++k > 52) corrupt("mb_qp_delta out of range");
          c = 63;
        }
        delta = (k & 1) ? (k + 1) / 2 : -(k / 2);
      }
    } else {
      delta = bs.se();
    }
    if (delta < -26 || delta > 25) corrupt("mb_qp_delta out of range");
    m.qp_delta = delta;
    qp = (qp + delta + 52) % 52;
  }
  m.qp = qp;
  memset(lc, 0, sizeof lc);
  memset(lc8, 0, sizeof lc8);
  memset(ldc, 0, sizeof ldc);
  memset(cdc, 0, sizeof cdc);
  memset(cac, 0, sizeof cac);
  if ((m.cbp & 0x3F) || m.kind == I16) residual(m);
  if (m.intra) {
    recon_intra(m);
  } else {
    recon_inter(m, parts);
  }
  prev_mb_in_slice = mb_addr;
}

// ── residual ────────────────────────────────────────────────────────────

int Decoder::luma_nc(int raster) const {
  int x = (raster & 3) * 4, y = (raster >> 2) * 4;
  int na = 0, nb = 0;
  bool aa = false, ab = false;
  int xw, yw;
  int a = locate(x - 1, y, &xw, &yw);
  if (a >= 0) {
    aa = true;
    na = mbs[a].nz[(yw >> 2) * 4 + (xw >> 2)];
  }
  int b = locate(x, y - 1, &xw, &yw);
  if (b >= 0) {
    ab = true;
    nb = mbs[b].nz[(yw >> 2) * 4 + (xw >> 2)];
  }
  if (aa && ab) return (na + nb + 1) >> 1;
  return aa ? na : (ab ? nb : 0);
}

int Decoder::chroma_nc(int c, int blk) const {
  int bx = blk & 1, by = blk >> 1;
  int na = 0, nb = 0;
  bool aa = false, ab = false;
  if (bx) {
    aa = true;
    na = mbs[mb_addr].nzc[c][by * 2];
  } else if (avail(addr_a())) {
    aa = true;
    na = mbs[addr_a()].nzc[c][by * 2 + 1];
  }
  if (by) {
    ab = true;
    nb = mbs[mb_addr].nzc[c][bx];
  } else if (avail(addr_b())) {
    ab = true;
    nb = mbs[addr_b()].nzc[c][2 + bx];
  }
  if (aa && ab) return (na + nb + 1) >> 1;
  return aa ? na : (ab ? nb : 0);
}

int Decoder::cavlc_block(int nc, int maxnum, int* out) {
  for (int i = 0; i < maxnum; ++i) out[i] = 0;
  const VlcTables& v = vlc();
  int table = nc < 0 ? 4 : nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
  int sym = v.coeff_token[table].read(bs);
  int total = sym >> 2, t1 = sym & 3;
  if (total == 0) return 0;
  if (total > maxnum) corrupt("TotalCoeff beyond the block");
  int levels[16];
  int sl = (total > 10 && t1 < 3) ? 1 : 0;
  for (int i = 0; i < total; ++i) {
    if (i < t1) {
      levels[i] = bs.u(1) ? -1 : 1;
      continue;
    }
    int prefix = 0;
    while (!bs.bit())
      if (++prefix > 31) corrupt("a level_prefix beyond 31");
    int size = (prefix == 14 && sl == 0) ? 4 : (prefix >= 15 ? prefix - 3 : sl);
    int64_t code = ((int64_t)std::min(15, prefix) << sl) + (size ? bs.u(size) : 0);
    if (prefix >= 15 && sl == 0) code += 15;
    if (prefix >= 16) code += ((int64_t)1 << (prefix - 3)) - 4096;
    if (i == t1 && t1 < 3) code += 2;
    int64_t level = (code % 2 == 0) ? (code + 2) >> 1 : (-code - 1) >> 1;
    if (level > (1 << 22) || level < -(1 << 22)) corrupt("a level out of range");
    levels[i] = (int)level;
    if (sl == 0) sl = 1;
    if (std::abs(levels[i]) > (3 << (sl - 1)) && sl < 6) ++sl;
  }
  int zeros = 0;
  if (total < maxnum) zeros = maxnum == 4 ? v.total_zeros_dc[total - 1].read(bs) : v.total_zeros[total - 1].read(bs);
  if (zeros + total > maxnum) corrupt("total_zeros beyond the block");
  int runs[16];
  for (int i = 0; i < total - 1; ++i) {
    int run = zeros > 0 ? v.run_before[std::min(zeros, 7) - 1].read(bs) : 0;
    if (run > zeros) corrupt("run_before beyond total_zeros");
    runs[i] = run;
    zeros -= run;
  }
  runs[total - 1] = zeros;
  int k = -1;
  for (int i = total - 1; i >= 0; --i) {
    k += runs[i] + 1;
    out[k] = levels[i];
  }
  return total;
}

int Decoder::cbf_luma_inc(int raster, bool dc) {
  const MB& cm = mbs[mb_addr];
  int x = (raster & 3) * 4, y = (raster >> 2) * 4;
  int cond[2];
  for (int k = 0; k < 2; ++k) {
    int xw, yw;
    int addr = locate(k == 0 ? x - 1 : x, k == 0 ? y : y - 1, &xw, &yw);
    if (addr < 0) {
      cond[k] = cm.intra ? 1 : 0;
      continue;
    }
    const MB& n = mbs[addr];
    if (n.kind == IPCM) cond[k] = 1;
    else if (dc) cond[k] = n.kind == I16 ? n.cbf_dc[0] : 0;
    else if (n.kind == SKIP) cond[k] = 0;
    else if (!((n.cbp >> ((yw >> 3) * 2 + (xw >> 3))) & 1)) cond[k] = 0;
    else cond[k] = n.nz[(yw >> 2) * 4 + (xw >> 2)] != 0;
  }
  return cond[0] + 2 * cond[1];
}

int Decoder::cbf_chroma_inc(int c, int blk, bool dc) {
  const MB& cm = mbs[mb_addr];
  int bx = blk & 1, by = blk >> 1;
  int cond[2];
  for (int k = 0; k < 2; ++k) {
    int addr;
    int nb;
    if (k == 0) {
      addr = bx ? mb_addr : addr_a();
      nb = by * 2 + (bx ? 0 : 1);
    } else {
      addr = by ? mb_addr : addr_b();
      nb = (by ? 0 : 2) + bx;
    }
    if (dc) addr = k == 0 ? addr_a() : addr_b();
    if (addr != mb_addr && !avail(addr)) {
      cond[k] = cm.intra ? 1 : 0;
      continue;
    }
    const MB& n = mbs[addr];
    if (n.kind == IPCM) cond[k] = 1;
    else if (n.kind == SKIP) cond[k] = 0;
    else if (dc) cond[k] = (n.cbp >> 4) != 0 ? n.cbf_dc[1 + c] : 0;
    else cond[k] = (n.cbp >> 4) == 2 ? n.nzc[c][nb] != 0 : 0;
  }
  return cond[0] + 2 * cond[1];
}

// residual_block_cabac: returns the count of non-zero levels; cbf_inc < 0
// for a block with no coded_block_flag (8x8 luma in 4:2:0)
int Decoder::cabac_block(int cat, int cbf_inc, int maxnum, int* out) {
  static const int CBF_OFF[5] = {0, 4, 8, 12, 16};
  static const int SIG_OFF[5] = {0, 15, 29, 44, 47};
  static const int ABS_OFF[5] = {0, 10, 20, 30, 39};
  for (int i = 0; i < maxnum; ++i) out[i] = 0;
  if (cbf_inc >= 0 && !dec(85 + CBF_OFF[cat] + cbf_inc)) return 0;
  bool sig[64];
  int num = maxnum;
  for (int i = 0; i < maxnum; ++i) sig[i] = false;
  int i = 0;
  for (; i < num - 1; ++i) {
    int sctx = cat == 5 ? 402 + SIG8_CTX[i] : 105 + SIG_OFF[cat] + i;
    if (dec(sctx)) {
      sig[i] = true;
      int lctx = cat == 5 ? 417 + LAST8_CTX[i] : 166 + SIG_OFF[cat] + i;
      if (dec(lctx)) {
        num = i + 1;
        break;
      }
    }
  }
  if (i == maxnum - 1) sig[maxnum - 1] = true;
  int base = cat == 5 ? 426 : 227 + ABS_OFF[cat];
  int gt1 = 0, eq1 = 0, count = 0;
  for (int k = num - 1; k >= 0; --k) {
    if (!sig[k]) continue;
    int inc0 = gt1 != 0 ? 0 : std::min(4, 1 + eq1);
    int v = 0;
    if (dec(base + inc0)) {
      int c = base + 5 + std::min(4 - (cat == 3 ? 1 : 0), gt1);
      v = 1;
      while (v < 14 && dec(c)) ++v;
      if (v >= 14) {
        int e = 0;
        while (bypass()) {
          v += 1 << e;
          if (++e > 24) corrupt("coeff_abs_level_minus1 beyond its range");
        }
        while (e--) v += bypass() << e;
      }
    }
    int level = v + 1;
    if (level > 1) ++gt1;
    else ++eq1;
    out[k] = bypass() ? -level : level;
    ++count;
  }
  return count;
}

void Decoder::residual(MB& m) {
  bool cabac = pps->cabac;
  int levels[64];
  bool i16 = m.kind == I16;
  if (i16) {
    int n = cabac ? cabac_block(0, cbf_luma_inc(0, true), 16, levels) : cavlc_block(luma_nc(0), 16, levels);
    m.cbf_dc[0] = n > 0;
    for (int k = 0; k < 16; ++k) ldc[ZIGZAG4[k]] = levels[k];
  }
  for (int b8 = 0; b8 < 4; ++b8) {
    bool coded = (m.cbp >> b8) & 1;
    if (m.t8x8 && cabac) {
      if (!coded) continue;
      int n = cabac_block(5, -1, 64, levels);
      for (int k = 0; k < 64; ++k) lc8[b8][ZIGZAG8[k]] = levels[k];
      for (int i4 = 0; i4 < 4; ++i4) {
        int r = BLK_RASTER[b8 * 4 + i4];
        m.nz[r] = (uint8_t)n;
        m.nzd[r] = n > 0;
      }
      continue;
    }
    bool any8 = false;
    for (int i4 = 0; i4 < 4; ++i4) {
      int r = BLK_RASTER[b8 * 4 + i4];
      if (!coded) continue;
      int n;
      if (i16) {
        n = cabac ? cabac_block(1, cbf_luma_inc(r, false), 15, levels) : cavlc_block(luma_nc(r), 15, levels);
        for (int k = 0; k < 15; ++k) lc[r][ZIGZAG4[k + 1]] = levels[k];
      } else {
        n = cabac ? cabac_block(2, cbf_luma_inc(r, false), 16, levels) : cavlc_block(luma_nc(r), 16, levels);
        if (m.t8x8) {
          for (int k = 0; k < 16; ++k) lc8[b8][ZIGZAG8[4 * k + i4]] = levels[k];
        } else {
          for (int k = 0; k < 16; ++k) lc[r][ZIGZAG4[k]] = levels[k];
        }
      }
      m.nz[r] = (uint8_t)n;
      m.nzd[r] = n > 0;
      any8 = any8 || n > 0;
    }
    if (m.t8x8)
      for (int i4 = 0; i4 < 4; ++i4) m.nzd[BLK_RASTER[b8 * 4 + i4]] = any8;
  }
  int cc = m.cbp >> 4;
  if (cc & 3) {
    for (int c = 0; c < 2; ++c) {
      int n = cabac ? cabac_block(3, cbf_chroma_inc(c, 0, true), 4, levels) : cavlc_block(-1, 4, levels);
      m.cbf_dc[1 + c] = n > 0;
      for (int k = 0; k < 4; ++k) cdc[c][k] = levels[k];
    }
  }
  if (cc & 2) {
    for (int c = 0; c < 2; ++c)
      for (int b = 0; b < 4; ++b) {
        int n = cabac ? cabac_block(4, cbf_chroma_inc(c, b, false), 15, levels) : cavlc_block(chroma_nc(c, b), 15, levels);
        m.nzc[c][b] = (uint8_t)n;
        for (int k = 0; k < 15; ++k) cac[c][b][ZIGZAG4[k + 1]] = levels[k];
      }
  }
}

// ── transforms ──────────────────────────────────────────────────────────

inline int scale4(int64_t c, int ls, int q) {
  int64_t v = q >= 24 ? c * ls * (1 << (q / 6 - 4)) : (c * ls + (1 << (3 - q / 6))) >> (4 - q / 6);
  return (int)std::max<int64_t>(-(1 << 24), std::min<int64_t>(1 << 24, v));
}

void idct4(int* d, int* r) {          // 8.5.12.2, d and r raster 4x4
  int t[16];
  for (int i = 0; i < 4; ++i) {
    const int* s = d + 4 * i;
    int e0 = s[0] + s[2], e1 = s[0] - s[2], e2 = (s[1] >> 1) - s[3], e3 = s[1] + (s[3] >> 1);
    t[4 * i] = e0 + e3;
    t[4 * i + 1] = e1 + e2;
    t[4 * i + 2] = e1 - e2;
    t[4 * i + 3] = e0 - e3;
  }
  for (int j = 0; j < 4; ++j) {
    int e0 = t[j] + t[8 + j], e1 = t[j] - t[8 + j], e2 = (t[4 + j] >> 1) - t[12 + j], e3 = t[4 + j] + (t[12 + j] >> 1);
    r[j] = (e0 + e3 + 32) >> 6;
    r[4 + j] = (e1 + e2 + 32) >> 6;
    r[8 + j] = (e1 - e2 + 32) >> 6;
    r[12 + j] = (e0 - e3 + 32) >> 6;
  }
}

void idct8_1d(const int* s, int stride, int* o, int ostride) {
  int d0 = s[0], d1 = s[stride], d2 = s[2 * stride], d3 = s[3 * stride];
  int d4 = s[4 * stride], d5 = s[5 * stride], d6 = s[6 * stride], d7 = s[7 * stride];
  int a0 = d0 + d4, a4 = d0 - d4, a2 = (d2 >> 1) - d6, a6 = d2 + (d6 >> 1);
  int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
  int a1 = -d3 + d5 - d7 - (d7 >> 1);
  int a3 = d1 + d7 - d3 - (d3 >> 1);
  int a5 = -d1 + d7 + d5 + (d5 >> 1);
  int a7 = d3 + d5 + d1 + (d1 >> 1);
  int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2), b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
  o[0] = b0 + b7;
  o[ostride] = b2 + b5;
  o[2 * ostride] = b4 + b3;
  o[3 * ostride] = b6 + b1;
  o[4 * ostride] = b6 - b1;
  o[5 * ostride] = b4 - b3;
  o[6 * ostride] = b2 - b5;
  o[7 * ostride] = b0 - b7;
}

void idct8(int* d, int* r) {
  int t[64];
  for (int i = 0; i < 8; ++i) idct8_1d(d + 8 * i, 1, t + 8 * i, 1);
  for (int j = 0; j < 8; ++j) idct8_1d(t + j, 8, r + j, 8);
  for (int k = 0; k < 64; ++k) r[k] = (r[k] + 32) >> 6;
}

// the residual of the luma 4x4 block at raster r (levels lc[r]) with list
void Decoder::luma_residual_4x4(MB& m, int raster, int list, int* out) {
  int d[16];
  const int* c = lc[raster];
  int q = m.qp;
  for (int k = 0; k < 16; ++k) d[k] = c[k] ? scale4(c[k], ls4[list][q % 6][k], q) : 0;
  if (m.kind == I16) {
    d[0] = ldc[raster];              // the DC, already scaled
  }
  idct4(d, out);
}

// ── reconstruction ──────────────────────────────────────────────────────

void Decoder::recon_pcm() {
  int ys = mbw * 16, cs = mbw * 8;
  for (int y = 0; y < 16; ++y)
    for (int x = 0; x < 16; ++x) cur->y[(size_t)(mby * 16 + y) * ys + mbx * 16 + x] = pcm[y * 16 + x];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) {
      cur->cb[(size_t)(mby * 8 + y) * cs + mbx * 8 + x] = pcm[256 + y * 8 + x];
      cur->cr[(size_t)(mby * 8 + y) * cs + mbx * 8 + x] = pcm[320 + y * 8 + x];
    }
}

bool Decoder::intra_avail(int xN, int yN) const {
  int xw, yw;
  int addr = locate(xN, yN, &xw, &yw);
  if (addr < 0) return false;
  if (addr == mb_addr) return done4[(yw >> 2) * 4 + (xw >> 2)];
  if (pps->constrained_intra && !mbs[addr].intra) return false;
  return true;
}

// 8.3.1.2 / 8.3.2.2: an N x N block (N 4 or 8) from its reference samples:
// top[0] = p[-1, -1], top[1 + x] = p[x, -1] (x < 2N); left[1 + y] = p[-1, y]
void pred_nxn(int n, int mode, const int* top, const int* left, bool has_t, bool has_l, bool has_d, int* out) {
  auto T = [&](int x) { return top[x + 1]; };
  auto L = [&](int y) { return y < 0 ? top[0] : left[y + 1]; };
  int lg = n == 4 ? 2 : 3;
  auto need = [&](bool ok) {
    if (!ok) corrupt("an intra prediction mode whose neighbours are not available");
  };
  for (int y = 0; y < n; ++y)
    for (int x = 0; x < n; ++x) {
      int v;
      switch (mode) {
        case 0: need(has_t); v = T(x); break;
        case 1: need(has_l); v = L(y); break;
        case 2: {
          int s = 0;
          if (has_t && has_l) {
            for (int k = 0; k < n; ++k) s += T(k) + L(k);
            v = (s + n) >> (lg + 1);
          } else if (has_t || has_l) {
            for (int k = 0; k < n; ++k) s += has_t ? T(k) : L(k);
            v = (s + n / 2) >> lg;
          } else {
            v = 128;
          }
          break;
        }
        case 3:
          need(has_t);
          if (x == n - 1 && y == n - 1) v = (T(2 * n - 2) + 3 * T(2 * n - 1) + 2) >> 2;
          else v = (T(x + y) + 2 * T(x + y + 1) + T(x + y + 2) + 2) >> 2;
          break;
        case 4:
          need(has_t && has_l && has_d);
          if (x > y) v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
          else if (x < y) v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
          else v = (T(0) + 2 * T(-1) + L(0) + 2) >> 2;
          break;
        case 5: {
          need(has_t && has_l && has_d);
          int z = 2 * x - y;
          if (z >= 0 && !(z & 1)) v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1;
          else if (z >= 0) v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2) >> 2;
          else if (z == -1) v = (L(0) + 2 * L(-1) + T(0) + 2) >> 2;
          else v = (L(y - 2 * x - 1) + 2 * L(y - 2 * x - 2) + L(y - 2 * x - 3) + 2) >> 2;
          break;
        }
        case 6: {
          need(has_t && has_l && has_d);
          int z = 2 * y - x;
          if (z >= 0 && !(z & 1)) v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1;
          else if (z >= 0) v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2) >> 2;
          else if (z == -1) v = (L(0) + 2 * L(-1) + T(0) + 2) >> 2;
          else v = (T(x - 2 * y - 1) + 2 * T(x - 2 * y - 2) + T(x - 2 * y - 3) + 2) >> 2;
          break;
        }
        case 7:
          need(has_t);
          if (!(y & 1)) v = (T(x + (y >> 1)) + T(x + (y >> 1) + 1) + 1) >> 1;
          else v = (T(x + (y >> 1)) + 2 * T(x + (y >> 1) + 1) + T(x + (y >> 1) + 2) + 2) >> 2;
          break;
        case 8: {
          need(has_l);
          int z = x + 2 * y, zmax = 2 * n - 3;
          if (z > zmax) v = L(n - 1);
          else if (z == zmax) v = (L(n - 2) + 3 * L(n - 1) + 2) >> 2;
          else if (!(z & 1)) v = (L(y + (x >> 1)) + L(y + (x >> 1) + 1) + 1) >> 1;
          else v = (L(y + (x >> 1)) + 2 * L(y + (x >> 1) + 1) + L(y + (x >> 1) + 2) + 2) >> 2;
          break;
        }
        default: corrupt("an intra prediction mode out of range");
      }
      out[y * n + x] = v;
    }
}

inline int scale8(int64_t c, int ls, int q) {
  int64_t v = q >= 36 ? c * ls * (1 << (q / 6 - 6)) : (c * ls + (1 << (5 - q / 6))) >> (6 - q / 6);
  return (int)std::max<int64_t>(-(1 << 24), std::min<int64_t>(1 << 24, v));
}

void Decoder::recon_intra(MB& m) {
  int ys = mbw * 16;
  uint8_t* Y = cur->y.data() + (size_t)mby * 16 * ys + mbx * 16;
  auto S = [&](int x, int y) -> int { return Y[(ptrdiff_t)y * ys + x]; };
  int q = m.qp;
  int res[64];
  if (m.kind == I16) {
    int t[16];
    const int* c = ldc;
    for (int i = 0; i < 4; ++i) {
      const int* r = c + 4 * i;
      t[4 * i] = r[0] + r[1] + r[2] + r[3];
      t[4 * i + 1] = r[0] + r[1] - r[2] - r[3];
      t[4 * i + 2] = r[0] - r[1] - r[2] + r[3];
      t[4 * i + 3] = r[0] - r[1] + r[2] - r[3];
    }
    int f[16];
    for (int j = 0; j < 4; ++j) {
      f[j] = t[j] + t[4 + j] + t[8 + j] + t[12 + j];
      f[4 + j] = t[j] + t[4 + j] - t[8 + j] - t[12 + j];
      f[8 + j] = t[j] - t[4 + j] - t[8 + j] + t[12 + j];
      f[12 + j] = t[j] - t[4 + j] + t[8 + j] - t[12 + j];
    }
    int ls = ls4[0][q % 6][0];
    for (int k = 0; k < 16; ++k) {
      int64_t v = q >= 36 ? (int64_t)f[k] * ls * (1 << (q / 6 - 6))
                          : ((int64_t)f[k] * ls + (1 << (5 - q / 6))) >> (6 - q / 6);
      ldc[k] = (int)std::max<int64_t>(-(1 << 24), std::min<int64_t>(1 << 24, v));
    }
    bool top = intra_avail(0, -1), left = intra_avail(-1, 0), corner = intra_avail(-1, -1);
    int pred[256];
    int mode = m.i16mode;
    if (mode == 0) {
      if (!top) corrupt("Intra_16x16 vertical prediction with no upper neighbour");
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) pred[y * 16 + x] = S(x, -1);
    } else if (mode == 1) {
      if (!left) corrupt("Intra_16x16 horizontal prediction with no left neighbour");
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) pred[y * 16 + x] = S(-1, y);
    } else if (mode == 2) {
      int s = 0, v;
      if (top && left) {
        for (int k = 0; k < 16; ++k) s += S(k, -1) + S(-1, k);
        v = (s + 16) >> 5;
      } else if (top || left) {
        for (int k = 0; k < 16; ++k) s += top ? S(k, -1) : S(-1, k);
        v = (s + 8) >> 4;
      } else {
        v = 128;
      }
      for (int k = 0; k < 256; ++k) pred[k] = v;
    } else {
      if (!(top && left && corner)) corrupt("Intra_16x16 plane prediction with a neighbour missing");
      int H = 0, V = 0;
      for (int k = 0; k < 8; ++k) {
        H += (k + 1) * (S(8 + k, -1) - S(6 - k, -1));
        V += (k + 1) * (S(-1, 8 + k) - S(-1, 6 - k));
      }
      int a = 16 * (S(-1, 15) + S(15, -1)), b = (5 * H + 32) >> 6, cc = (5 * V + 32) >> 6;
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) pred[y * 16 + x] = clip1((a + b * (x - 7) + cc * (y - 7) + 16) >> 5);
    }
    for (int r = 0; r < 16; ++r) {
      luma_residual_4x4(m, r, 0, res);
      int bx = (r & 3) * 4, by = (r >> 2) * 4;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x)
          Y[(ptrdiff_t)(by + y) * ys + bx + x] = clip1(pred[(by + y) * 16 + bx + x] + res[y * 4 + x]);
    }
  } else if (m.kind == I4x4) {
    for (int i = 0; i < 16; ++i) {
      int r = BLK_RASTER[i], bx = (r & 3) * 4, by = (r >> 2) * 4;
      bool has_t = intra_avail(bx, by - 1), has_tr = intra_avail(bx + 4, by - 1);
      bool has_l = intra_avail(bx - 1, by), has_d = intra_avail(bx - 1, by - 1);
      int top[9], left[5], pred[16];
      top[0] = left[0] = has_d ? S(bx - 1, by - 1) : 0;
      for (int k = 0; k < 8; ++k)
        top[1 + k] = k < 4 ? (has_t ? S(bx + k, by - 1) : 0) : (has_tr ? S(bx + k, by - 1) : (has_t ? S(bx + 3, by - 1) : 0));
      for (int k = 0; k < 4; ++k) left[1 + k] = has_l ? S(bx - 1, by + k) : 0;
      pred_nxn(4, m.ipred[r], top, left, has_t, has_l, has_d, pred);
      if (m.nz[r]) luma_residual_4x4(m, r, 0, res);
      else std::fill(res, res + 16, 0);
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) Y[(ptrdiff_t)(by + y) * ys + bx + x] = clip1(pred[y * 4 + x] + res[y * 4 + x]);
      done4[r] = true;
    }
  } else {                                               // I8x8
    for (int b8 = 0; b8 < 4; ++b8) {
      int bx = (b8 & 1) * 8, by = (b8 >> 1) * 8;
      bool has_t = intra_avail(bx, by - 1), has_tr = intra_avail(bx + 8, by - 1);
      bool has_l = intra_avail(bx - 1, by), has_d = intra_avail(bx - 1, by - 1);
      int p[17], pl[8], corner = has_d ? S(bx - 1, by - 1) : 0;
      for (int k = 0; k < 16; ++k)
        p[k] = k < 8 ? (has_t ? S(bx + k, by - 1) : 0) : (has_tr ? S(bx + k, by - 1) : (has_t ? S(bx + 7, by - 1) : 0));
      for (int k = 0; k < 8; ++k) pl[k] = has_l ? S(bx - 1, by + k) : 0;
      // 8.3.2.2.1: the reference filter
      int top[17], left[9];
      if (has_t) {
        top[1] = has_d ? (corner + 2 * p[0] + p[1] + 2) >> 2 : (3 * p[0] + p[1] + 2) >> 2;
        for (int k = 1; k < 15; ++k) top[1 + k] = (p[k - 1] + 2 * p[k] + p[k + 1] + 2) >> 2;
        top[16] = (p[14] + 3 * p[15] + 2) >> 2;
      } else {
        for (int k = 0; k < 16; ++k) top[1 + k] = 0;
      }
      if (has_d) {
        if (has_t && has_l) top[0] = (p[0] + 2 * corner + pl[0] + 2) >> 2;
        else if (has_t) top[0] = (3 * corner + p[0] + 2) >> 2;
        else if (has_l) top[0] = (3 * corner + pl[0] + 2) >> 2;
        else top[0] = corner;
      } else {
        top[0] = 0;
      }
      left[0] = top[0];
      if (has_l) {
        left[1] = has_d ? (corner + 2 * pl[0] + pl[1] + 2) >> 2 : (3 * pl[0] + pl[1] + 2) >> 2;
        for (int k = 1; k < 7; ++k) left[1 + k] = (pl[k - 1] + 2 * pl[k] + pl[k + 1] + 2) >> 2;
        left[8] = (pl[6] + 3 * pl[7] + 2) >> 2;
      } else {
        for (int k = 0; k < 8; ++k) left[1 + k] = 0;
      }
      int pred[64];
      pred_nxn(8, m.ipred[(by >> 2) * 4 + (bx >> 2)], top, left, has_t, has_l, has_d, pred);
      if (m.nzd[(by >> 2) * 4 + (bx >> 2)]) {
        int d[64];
        for (int k = 0; k < 64; ++k) d[k] = lc8[b8][k] ? scale8(lc8[b8][k], ls8[0][q % 6][k], q) : 0;
        idct8(d, res);
      } else {
        std::fill(res, res + 64, 0);
      }
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x) Y[(ptrdiff_t)(by + y) * ys + bx + x] = clip1(pred[y * 8 + x] + res[y * 8 + x]);
      for (int k = 0; k < 4; ++k) done4[((by >> 2) + (k >> 1)) * 4 + (bx >> 2) + (k & 1)] = true;
    }
  }
  recon_chroma(m, true, nullptr);
}

void Decoder::recon_chroma(MB& m, bool intra, int pred_in[2][64]) {
  int cs = mbw * 8;
  bool top = false, left = false, corner = false;
  if (intra) {
    top = intra_avail(0, -1);
    left = intra_avail(-1, 0);
    corner = intra_avail(-1, -1);
  }
  for (int c = 0; c < 2; ++c) {
    uint8_t* C = (c == 0 ? cur->cb : cur->cr).data() + (size_t)mby * 8 * cs + mbx * 8;
    auto S = [&](int x, int y) -> int { return C[(ptrdiff_t)y * cs + x]; };
    int pred[64];
    if (intra) {
      int mode = m.chroma_mode;
      if (mode == 0) {
        for (int b = 0; b < 4; ++b) {
          int xo = (b & 1) * 4, yo = (b >> 1) * 4, st = 0, sl = 0, v;
          for (int k = 0; k < 4; ++k) {
            if (top) st += S(xo + k, -1);
            if (left) sl += S(-1, yo + k);
          }
          if ((xo == 0 && yo == 0) || (xo > 0 && yo > 0)) {
            if (top && left) v = (st + sl + 4) >> 3;
            else if (left) v = (sl + 2) >> 2;
            else if (top) v = (st + 2) >> 2;
            else v = 128;
          } else if (xo > 0) {
            if (top) v = (st + 2) >> 2;
            else if (left) v = (sl + 2) >> 2;
            else v = 128;
          } else {
            if (left) v = (sl + 2) >> 2;
            else if (top) v = (st + 2) >> 2;
            else v = 128;
          }
          for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x) pred[(yo + y) * 8 + xo + x] = v;
        }
      } else if (mode == 1) {
        if (!left) corrupt("intra chroma horizontal prediction with no left neighbour");
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) pred[y * 8 + x] = S(-1, y);
      } else if (mode == 2) {
        if (!top) corrupt("intra chroma vertical prediction with no upper neighbour");
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) pred[y * 8 + x] = S(x, -1);
      } else {
        if (!(top && left && corner)) corrupt("intra chroma plane prediction with a neighbour missing");
        int H = 0, V = 0;
        for (int k = 0; k < 4; ++k) {
          H += (k + 1) * (S(4 + k, -1) - S(2 - k, -1));
          V += (k + 1) * (S(-1, 4 + k) - S(-1, 2 - k));
        }
        int a = 16 * (S(-1, 7) + S(7, -1)), b = (34 * H + 32) >> 6, cc = (34 * V + 32) >> 6;
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) pred[y * 8 + x] = clip1((a + b * (x - 3) + cc * (y - 3) + 16) >> 5);
      }
    } else {
      memcpy(pred, pred_in[c], sizeof pred);
    }
    int qpc = QPC[clip3(0, 51, m.qp + pps->cqp_offset[c])];
    int list = (intra ? 1 : 4) + c;
    int res[64] = {0};
    if (m.cbp >> 4) {
      const int* d = cdc[c];
      int f[4] = {d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3], d[0] + d[1] - d[2] - d[3],
                  d[0] - d[1] - d[2] + d[3]};
      int ls = ls4[list][qpc % 6][0];
      for (int b = 0; b < 4; ++b) {
        int dd[16], r[16];
        for (int k = 1; k < 16; ++k) dd[k] = cac[c][b][k] ? scale4(cac[c][b][k], ls4[list][qpc % 6][k], qpc) : 0;
        int64_t dc = ((int64_t)f[b] * ls * (1 << (qpc / 6))) >> 5;
        dd[0] = (int)std::max<int64_t>(-(1 << 24), std::min<int64_t>(1 << 24, dc));
        idct4(dd, r);
        int xo = (b & 1) * 4, yo = (b >> 1) * 4;
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) res[(yo + y) * 8 + xo + x] = r[y * 4 + x];
      }
    }
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) C[(ptrdiff_t)y * cs + x] = clip1(pred[y * 8 + x] + res[y * 8 + x]);
  }
}

// 8.4.2.2.1: a w x h luma block at integer (xi, yi) and fraction (fx, fy)
void mc_luma(const Pic& ref, int xi, int yi, int fx, int fy, int w, int h, int* out) {
  int W = ref.mbw * 16, H = ref.mbh * 16;
  int win[21][21];
  for (int y = 0; y < h + 5; ++y) {
    const uint8_t* row = ref.y.data() + (size_t)clip3(0, H - 1, yi - 2 + y) * W;
    for (int x = 0; x < w + 5; ++x) win[y][x] = row[clip3(0, W - 1, xi - 2 + x)];
  }
  auto G = [&](int x, int y) { return win[y + 2][x + 2]; };
  auto tap = [](int a, int b, int c, int d, int e, int f) { return a - 5 * b + 20 * c + 20 * d - 5 * e + f; };
  auto b1 = [&](int x, int y) { return tap(G(x - 2, y), G(x - 1, y), G(x, y), G(x + 1, y), G(x + 2, y), G(x + 3, y)); };
  auto h1 = [&](int x, int y) { return tap(G(x, y - 2), G(x, y - 1), G(x, y), G(x, y + 1), G(x, y + 2), G(x, y + 3)); };
  auto hb = [&](int x, int y) { return (int)clip1((b1(x, y) + 16) >> 5); };
  auto hv = [&](int x, int y) { return (int)clip1((h1(x, y) + 16) >> 5); };
  auto hj = [&](int x, int y) {
    int j1 = tap(b1(x, y - 2), b1(x, y - 1), b1(x, y), b1(x, y + 1), b1(x, y + 2), b1(x, y + 3));
    return (int)clip1((j1 + 512) >> 10);
  };
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int v;
      switch (fy * 4 + fx) {
        case 0: v = G(x, y); break;
        case 1: v = (G(x, y) + hb(x, y) + 1) >> 1; break;                  // a
        case 2: v = hb(x, y); break;                                       // b
        case 3: v = (G(x + 1, y) + hb(x, y) + 1) >> 1; break;              // c
        case 4: v = (G(x, y) + hv(x, y) + 1) >> 1; break;                  // d
        case 5: v = (hb(x, y) + hv(x, y) + 1) >> 1; break;                 // e
        case 6: v = (hb(x, y) + hj(x, y) + 1) >> 1; break;                 // f
        case 7: v = (hb(x, y) + hv(x + 1, y) + 1) >> 1; break;             // g
        case 8: v = hv(x, y); break;                                       // h
        case 9: v = (hv(x, y) + hj(x, y) + 1) >> 1; break;                 // i
        case 10: v = hj(x, y); break;                                      // j
        case 11: v = (hj(x, y) + hv(x + 1, y) + 1) >> 1; break;            // k
        case 12: v = (G(x, y + 1) + hv(x, y) + 1) >> 1; break;             // n
        case 13: v = (hv(x, y) + hb(x, y + 1) + 1) >> 1; break;            // p
        case 14: v = (hj(x, y) + hb(x, y + 1) + 1) >> 1; break;            // q
        default: v = (hv(x + 1, y) + hb(x, y + 1) + 1) >> 1; break;        // r
      }
      out[y * 16 + x] = v;
    }
}

// 8.4.2.2.2 for 4:2:0: a w x h chroma block at integer (xi, yi), eighths (fx, fy)
void mc_chroma(const std::vector<uint8_t>& plane, int W, int H, int xi, int yi, int fx, int fy, int w, int h, int* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* r0 = plane.data() + (size_t)clip3(0, H - 1, yi + y) * W;
    const uint8_t* r1 = plane.data() + (size_t)clip3(0, H - 1, yi + y + 1) * W;
    for (int x = 0; x < w; ++x) {
      int x0 = clip3(0, W - 1, xi + x), x1 = clip3(0, W - 1, xi + x + 1);
      out[y * 8 + x] = ((8 - fx) * (8 - fy) * r0[x0] + fx * (8 - fy) * r0[x1] + (8 - fx) * fy * r1[x0] +
                        fx * fy * r1[x1] + 32) >> 6;
    }
  }
}

inline int weighted(int v, int w, int o, int lg) {
  return clip1(lg >= 1 ? ((v * w + (1 << (lg - 1))) >> lg) + o : v * w + o);
}

// 8.4.2.3: the prediction of one sample from its list 0 and list 1 values
// (flags: the lists used) in mode 0 default, 1 explicit, 2 implicit
inline int combine(int mode, int flags, int a, int b, const int* w, const int* o, int lg) {
  if (flags != 3) {
    int v = flags == 1 ? a : b, x = flags == 1 ? 0 : 1;
    return mode == 1 ? weighted(v, w[x], o[x], lg) : v;
  }
  if (mode == 0) return (a + b + 1) >> 1;
  return clip1(((a * w[0] + b * w[1] + (1 << lg)) >> (lg + 1)) + ((o[0] + o[1] + 1) >> 1));
}

void Decoder::recon_inter(MB& m, const std::vector<Partition>& parts) {
  int predY[256], predC[2][64];
  int blk[2][256];
  int mode = sh.type == 0 ? (pps->weighted_pred ? 1 : 0) : pps->weighted_bipred_idc;
  for (const Partition& p : parts) {
    for (int x = 0; x < 2; ++x) {
      if (!(p.flags >> x & 1)) continue;
      if (p.ref[x] < 0 || p.ref[x] >= (int)list[x].size() || !list[x][p.ref[x]])
        corrupt("a reference index names no reference picture");
    }
    // the weights and offsets of each list (implicit: logWD 5, offsets 0)
    int lw[2] = {1, 1}, lo[2] = {0, 0}, cw[2][2] = {{1, 1}, {1, 1}}, co[2][2] = {{0, 0}, {0, 0}};
    int llg = sh.luma_log2, clg = sh.chroma_log2;
    if (mode == 1) {
      for (int x = 0; x < 2; ++x) {
        if (!(p.flags >> x & 1)) continue;
        lw[x] = sh.lw[x][p.ref[x]];
        lo[x] = sh.lo[x][p.ref[x]];
        for (int c = 0; c < 2; ++c) {
          cw[c][x] = sh.cw[x][p.ref[x]][c];
          co[c][x] = sh.co[x][p.ref[x]][c];
        }
      }
    } else if (mode == 2 && p.flags == 3) {
      int w0 = implicit_w[p.ref[0]][p.ref[1]];
      lw[0] = cw[0][0] = cw[1][0] = w0;
      lw[1] = cw[0][1] = cw[1][1] = 64 - w0;
      llg = clg = 5;
    }
    for (int x = 0; x < 2; ++x) {
      if (!(p.flags >> x & 1)) continue;
      const Pic& ref = *list[x][p.ref[x]];
      int mx = p.mv[x][0], my = p.mv[x][1];
      mc_luma(ref, mbx * 16 + p.x + (mx >> 2), mby * 16 + p.y + (my >> 2), mx & 3, my & 3, p.w, p.h, blk[x]);
    }
    for (int y = 0; y < p.h; ++y)
      for (int x = 0; x < p.w; ++x)
        predY[(p.y + y) * 16 + p.x + x] = combine(mode, p.flags, blk[0][y * 16 + x], blk[1][y * 16 + x], lw, lo, llg);
    for (int c = 0; c < 2; ++c) {
      for (int x = 0; x < 2; ++x) {
        if (!(p.flags >> x & 1)) continue;
        const Pic& ref = *list[x][p.ref[x]];
        int mx = p.mv[x][0], my = p.mv[x][1];
        mc_chroma(c == 0 ? ref.cb : ref.cr, ref.mbw * 8, ref.mbh * 8, mbx * 8 + p.x / 2 + (mx >> 3),
                  mby * 8 + p.y / 2 + (my >> 3), mx & 7, my & 7, p.w / 2, p.h / 2, blk[x]);
      }
      for (int y = 0; y < p.h / 2; ++y)
        for (int x = 0; x < p.w / 2; ++x)
          predC[c][(p.y / 2 + y) * 8 + p.x / 2 + x] =
              combine(mode, p.flags, blk[0][y * 8 + x], blk[1][y * 8 + x], cw[c], co[c], clg);
    }
  }
  int ys = mbw * 16;
  uint8_t* Y = cur->y.data() + (size_t)mby * 16 * ys + mbx * 16;
  int q = m.qp;
  int res[64];
  if (m.t8x8) {
    for (int b8 = 0; b8 < 4; ++b8) {
      int bx = (b8 & 1) * 8, by = (b8 >> 1) * 8;
      bool any = m.nzd[(by >> 2) * 4 + (bx >> 2)];
      if (any) {
        int d[64];
        for (int k = 0; k < 64; ++k) d[k] = lc8[b8][k] ? scale8(lc8[b8][k], ls8[1][q % 6][k], q) : 0;
        idct8(d, res);
      }
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x)
          Y[(ptrdiff_t)(by + y) * ys + bx + x] = clip1(predY[(by + y) * 16 + bx + x] + (any ? res[y * 8 + x] : 0));
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      int bx = (r & 3) * 4, by = (r >> 2) * 4;
      bool any = m.nz[r] != 0;
      if (any) luma_residual_4x4(m, r, 3, res);
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x)
          Y[(ptrdiff_t)(by + y) * ys + bx + x] = clip1(predY[(by + y) * 16 + bx + x] + (any ? res[y * 4 + x] : 0));
    }
  }
  recon_chroma(m, false, predC);
}

// ── end of a picture: deblocking, marking, output ───────────────────────

// 8.7.2.1 for frames: bS of the edge between the 4x4 blocks rp of p and rq of
// q.  The motion differs where the two use different reference pictures (by
// picture, whichever list names it) or a different number of vectors, or
// where a vector of one differs by 4 or more in a component from the
// vector of the other for the same picture (both pairings where both
// vectors of each name one picture)
int boundary_strength(const MB& p, int rp, const MB& q, int rq, bool mb_edge) {
  if (p.intra || q.intra) return mb_edge ? 4 : 3;
  if (p.nzd[rp] || q.nzd[rq]) return 2;
  int p8 = ((rp >> 2) >> 1) * 2 + ((rp & 3) >> 1), q8 = ((rq >> 2) >> 1) * 2 + ((rq & 3) >> 1);
  auto far = [&](int lp, int lq) {
    return std::abs(p.mv[lp][rp][0] - q.mv[lq][rq][0]) >= 4 || std::abs(p.mv[lp][rp][1] - q.mv[lq][rq][1]) >= 4;
  };
  uint64_t a0 = p.refpic[0][p8], a1 = p.refpic[1][p8], b0 = q.refpic[0][q8], b1 = q.refpic[1][q8];
  bool v = a0 != b0 || a1 != b1 || (a0 && far(0, 0)) || (a1 && far(1, 1));
  if (!v) return 0;
  if (a0 != b1 || a1 != b0) return 1;
  return (a0 && far(0, 1)) || (a1 && far(1, 0));
}

// filter n lines across an edge: pix points at q0 of the first line, `step`
// crosses the edge, `along` goes to the next line; bs by line
void filter_edge(uint8_t* pix, ptrdiff_t step, ptrdiff_t along, int n, const int* bs, int shift, int qp_av,
                 int alpha_off, int beta_off, bool chroma) {
  int ia = clip3(0, 51, qp_av + alpha_off), ib = clip3(0, 51, qp_av + beta_off);
  int alpha = ALPHA[ia], beta = BETA[ib];
  for (int i = 0; i < n; ++i, pix += along) {
    int b = bs[i >> shift];
    if (!b) continue;
    int p0 = pix[-step], p1 = pix[-2 * step], q0 = pix[0], q1 = pix[step];
    if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta)) continue;
    if (b < 4) {
      int tc0 = TC0[ia][b - 1];
      if (chroma) {
        int tc = tc0 + 1;
        int d = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
        pix[-step] = clip1(p0 + d);
        pix[0] = clip1(q0 - d);
      } else {
        int p2 = pix[-3 * step], q2 = pix[2 * step];
        int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
        int tc = tc0 + (ap < beta) + (aq < beta);
        int d = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
        pix[-step] = clip1(p0 + d);
        pix[0] = clip1(q0 - d);
        if (ap < beta) pix[-2 * step] = (uint8_t)(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1));
        if (aq < beta) pix[step] = (uint8_t)(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1));
      }
    } else if (chroma) {
      pix[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
      pix[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    } else {
      int p2 = pix[-3 * step], q2 = pix[2 * step], p3 = pix[-4 * step], q3 = pix[3 * step];
      int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
      bool strong = std::abs(p0 - q0) < ((alpha >> 2) + 2);
      if (ap < beta && strong) {
        pix[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
        pix[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
        pix[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
      } else {
        pix[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
      }
      if (aq < beta && strong) {
        pix[0] = (uint8_t)((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
        pix[step] = (uint8_t)((p0 + q0 + q1 + q2 + 2) >> 2);
        pix[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
      } else {
        pix[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
      }
    }
  }
}

void Decoder::deblock() {
  int ys = mbw * 16, cs = mbw * 8, n = (int)mbs.size();
  for (int addr = 0; addr < n; ++addr) {
    const MB& q = mbs[addr];
    const SliceParams& sp = slices[q.slice];
    if (sp.deblock_idc == 1) continue;
    int x = addr % mbw, y = addr / mbw;
    bool left = x > 0 && (sp.deblock_idc == 0 || mbs[addr - 1].slice == q.slice);
    bool top = y > 0 && (sp.deblock_idc == 0 || mbs[addr - mbw].slice == q.slice);
    auto qpl = [](const MB& m) { return m.kind == IPCM ? 0 : m.qp; };
    auto qpc = [&](const MB& m, int c) { return (int)QPC[clip3(0, 51, qpl(m) + sp.cqp_offset[c])]; };
    for (int dir = 0; dir < 2; ++dir) {               // 0: vertical edges, 1: horizontal
      int bsv[4][4];
      bool on[4];
      for (int e = 0; e < 4; ++e) {
        on[e] = !(e == 0 && !(dir == 0 ? left : top)) && !(q.t8x8 && (e & 1));
        if (!on[e]) continue;
        const MB& p = e == 0 ? mbs[dir == 0 ? addr - 1 : addr - mbw] : q;
        for (int k = 0; k < 4; ++k) {
          int rq = dir == 0 ? k * 4 + e : e * 4 + k;
          int rp = dir == 0 ? (e == 0 ? k * 4 + 3 : k * 4 + e - 1) : (e == 0 ? 12 + k : (e - 1) * 4 + k);
          bsv[e][k] = boundary_strength(p, rp, q, rq, e == 0);
        }
      }
      for (int e = 0; e < 4; ++e) {
        if (!on[e]) continue;
        const MB& p = e == 0 ? mbs[dir == 0 ? addr - 1 : addr - mbw] : q;
        uint8_t* Y = cur->y.data() + (size_t)(y * 16) * ys + x * 16;
        uint8_t* pix = dir == 0 ? Y + 4 * e : Y + (ptrdiff_t)4 * e * ys;
        filter_edge(pix, dir == 0 ? 1 : ys, dir == 0 ? ys : 1, 16, bsv[e], 2, (qpl(p) + qpl(q) + 1) >> 1,
                    sp.alpha_off, sp.beta_off, false);
        if (e & 1) continue;
        for (int c = 0; c < 2; ++c) {
          uint8_t* C = (c == 0 ? cur->cb : cur->cr).data() + (size_t)(y * 8) * cs + x * 8;
          uint8_t* cp = dir == 0 ? C + 2 * e : C + (ptrdiff_t)2 * e * cs;
          filter_edge(cp, dir == 0 ? 1 : cs, dir == 0 ? cs : 1, 8, bsv[e], 1, (qpc(p, c) + qpc(q, c) + 1) >> 1,
                      sp.alpha_off, sp.beta_off, true);
        }
      }
    }
  }
}

void Decoder::mark_references() {
  const SPS& s = *sps;
  int max_frame_num = 1 << s.log2_max_frame_num;
  int cur_fn = first_hdr.frame_num;
  if (first_hdr.idr) {
    if (first_hdr.long_term_reference) {
      cur->long_ref = true;
      cur->long_idx = 0;
      max_long_idx = 0;
    } else {
      cur->short_ref = true;
      max_long_idx = -1;
    }
    dpb.push_back(cur);
    return;
  }
  for (auto& p : dpb)
    if (p->short_ref) p->frame_num_wrap = p->frame_num > cur_fn ? p->frame_num - max_frame_num : p->frame_num;
  auto short_by_num = [&](int pic_num) -> PicP {
    for (auto& p : dpb)
      if (p->short_ref && p->frame_num_wrap == pic_num) return p;
    corrupt("a memory_management_control_operation names no short-term reference");
  };
  auto drop_long_idx = [&](int idx, const Pic* keep) {
    for (auto& p : dpb)
      if (p->long_ref && p->long_idx == idx && p.get() != keep) p->long_ref = false;
  };
  bool cur_long = false;
  if (first_hdr.adaptive) {
    for (auto& op : first_hdr.mmco) {
      switch (op[0]) {
        case 1: short_by_num(cur_fn - (op[1] + 1))->short_ref = false; break;
        case 2: {
          bool hit = false;
          for (auto& p : dpb)
            if (p->long_ref && p->long_idx == op[1]) {
              p->long_ref = false;
              hit = true;
            }
          if (!hit) corrupt("a memory_management_control_operation names no long-term reference");
          break;
        }
        case 3: {
          PicP p = short_by_num(cur_fn - (op[1] + 1));
          if (op[2] > max_long_idx) corrupt("long_term_frame_idx beyond MaxLongTermFrameIdx");
          drop_long_idx(op[2], p.get());
          p->short_ref = false;
          p->long_ref = true;
          p->long_idx = op[2];
          break;
        }
        case 4:
          max_long_idx = op[1] - 1;
          for (auto& p : dpb)
            if (p->long_ref && p->long_idx > max_long_idx) p->long_ref = false;
          break;
        case 5:
          for (auto& p : dpb) p->short_ref = p->long_ref = false;
          max_long_idx = -1;
          break;
        case 6:
          if (op[2] > max_long_idx) corrupt("long_term_frame_idx beyond MaxLongTermFrameIdx");
          drop_long_idx(op[2], cur.get());
          cur->long_ref = true;
          cur->long_idx = op[2];
          cur_long = true;
          break;
      }
    }
  } else {
    int n_short = 0, n_long = 0;
    for (auto& p : dpb) {
      n_short += p->short_ref;
      n_long += p->long_ref;
    }
    if (n_short + n_long >= std::max(s.max_num_ref_frames, 1)) {
      if (n_short == 0) corrupt("the sliding window has no short-term reference to drop");
      PicP oldest;
      for (auto& p : dpb)
        if (p->short_ref && (!oldest || p->frame_num_wrap < oldest->frame_num_wrap)) oldest = p;
      oldest->short_ref = false;
    }
  }
  if (!cur_long) cur->short_ref = true;
  dpb.erase(std::remove_if(dpb.begin(), dpb.end(), [](const PicP& p) { return !p->short_ref && !p->long_ref; }),
            dpb.end());
  dpb.push_back(cur);
  if ((int)dpb.size() > std::max(s.max_num_ref_frames, 1)) corrupt("more reference frames than max_num_ref_frames");
}

void Decoder::output_ready(bool all) {
  size_t depth = 0;
  if (!all && sps) {
    if (sps->num_reorder >= 0) depth = sps->num_reorder;
    else if (sps->poc_type != 2) depth = std::min(16, max_dpb_mbs(sps->level) / (mbw * mbh));
  }
  while (pending.size() > depth) {
    auto it = std::min_element(pending.begin(), pending.end(), [](const PicP& a, const PicP& b) { return a->poc < b->poc; });
    ready.push_back(*it);
    pending.erase(it);
  }
}

void Decoder::end_picture() {
  if (!in_picture) return;
  in_picture = false;
  int n = (int)mbs.size(), covered = 0;
  for (auto& m : mbs) covered += m.slice >= 0;
  if (covered != n) corrupt("the slices cover " + std::to_string(covered) + " of " + std::to_string(n) + " macroblocks");
  deblock();
  bool ref = first_hdr.nal_ref_idc != 0;
  if (ref) cur->mbs = std::move(mbs);               // a later picture's co-located motion
  if (ref) mark_references();
  if (cur_mmco5) {
    int temp = std::min(cur_top, cur_bottom);
    cur_top -= temp;
    cur_bottom -= temp;
    cur->poc = 0;
    cur->frame_num = 0;
  }
  if (ref) {
    prev_poc_msb = cur_mmco5 ? 0 : cur_poc_msb;
    prev_poc_lsb = cur_mmco5 ? cur_top : first_hdr.poc_lsb;
    prev_ref_frame_num = cur_mmco5 ? 0 : first_hdr.frame_num;
  }
  prev_frame_num_offset = cur_mmco5 ? 0 : cur_frame_num_offset;
  prev_frame_num = cur_mmco5 ? 0 : first_hdr.frame_num;
  have_prev = true;
  if (cur_mmco5) output_ready(true);
  pending.push_back(cur);
  output_ready(false);
  cur.reset();
}

void Decoder::flush() {
  end_picture();
  output_ready(true);
}

template <class F>
int guard(Decoder* d, F f) {
  try {
    f();
    return 0;
  } catch (const Unsupported& e) {
    d->error = e.what();
    return 2;
  } catch (const Corrupt& e) {
    d->error = e.what();
    return 1;
  } catch (const std::bad_alloc&) {
    d->error = "H.264: out of memory";
    return 1;
  } catch (const std::exception& e) {
    d->error = std::string("H.264: ") + e.what();
    return 1;
  }
}

}  // namespace

extern "C" {

void* h264d_new() {
  try {
    vlc();
    return new Decoder();
  } catch (...) {
    return nullptr;
  }
}

void h264d_free(void* h) { delete static_cast<Decoder*>(h); }

// one NAL unit (no start code, emulation prevention still in)
int h264d_nal(void* h, const uint8_t* data, int64_t size) {
  Decoder* d = static_cast<Decoder*>(h);
  return guard(d, [&] { d->nal(data, (size_t)size); });
}

// the access unit given so far is a whole picture
int h264d_end_picture(void* h) {
  Decoder* d = static_cast<Decoder*>(h);
  return guard(d, [&] { d->end_picture(); });
}

// the end of the stream: every picture goes to the output
int h264d_flush(void* h) {
  Decoder* d = static_cast<Decoder*>(h);
  return guard(d, [&] { d->flush(); });
}

int h264d_ready(void* h) { return (int)static_cast<Decoder*>(h)->ready.size(); }

// the cropped size of the next picture out
int h264d_frame_size(void* h, int32_t* w, int32_t* hh) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->ready.empty()) return 1;
  const Pic& p = *d->ready.front();
  *w = p.mbw * 16 - 2 * (p.crop[0] + p.crop[1]);
  *hh = p.mbh * 16 - 2 * (p.crop[2] + p.crop[3]);
  return 0;
}

// copy the next picture out (cropped Y', Cb, Cr) and drop it
int h264d_pop(void* h, uint8_t* y, uint8_t* cb, uint8_t* cr) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->ready.empty()) return 1;
  PicP p = d->ready.front();
  d->ready.erase(d->ready.begin());
  int W = p->mbw * 16, w = W - 2 * (p->crop[0] + p->crop[1]), hh = p->mbh * 16 - 2 * (p->crop[2] + p->crop[3]);
  int x0 = 2 * p->crop[0], y0 = 2 * p->crop[2];
  for (int r = 0; r < hh; ++r) memcpy(y + (size_t)r * w, p->y.data() + (size_t)(y0 + r) * W + x0, w);
  int cw = w / 2, ch = hh / 2, CW = W / 2;
  for (int r = 0; r < ch; ++r) {
    memcpy(cb + (size_t)r * cw, p->cb.data() + (size_t)(y0 / 2 + r) * CW + x0 / 2, cw);
    memcpy(cr + (size_t)r * cw, p->cr.data() + (size_t)(y0 / 2 + r) * CW + x0 / 2, cw);
  }
  return 0;
}

const char* h264d_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

}  // extern "C"
