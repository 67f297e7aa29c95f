// HEVC (ITU-T H.265 | ISO/IEC 23008-2) decoding on the host: the Main, Main 10
// and Main Still Picture profile streams that phone cameras and x265 write (an
// iPhone's "HDR Video" is Main 10), for a machine with no ffmpeg.  Built by g++
// at first use (omfs4d_torch/native.py) and bound with ctypes by
// omfs4d_torch/io/hevc.py; the tables come from hevc_tables.py as the generated
// header hevc_tables.h.
//
// Covered, at 4:2:0 with 8-, 9- or 10-bit samples (luma and chroma alike): 8-bit
// pictures are stored in uint8_t, deeper ones in uint16_t, and every function
// that reads or writes samples is a template on that type (the bit depth is a
// variable of the arithmetic: shifts, clips, SAO's offsets and band shift,
// deblocking's beta and tC, weighted prediction's offsets, QpBdOffset):
//   VPS / SPS / PPS (several ids, profile_tier_level with sub-layers, short-term
//   RPS with inter-RPS prediction, the conformance window, VUI with HRD);
//   slice segment headers (several slices a picture, dependent slice segments,
//   extra header bits, pic_output_flag, long-term reference pictures, list
//   modification, TMVP's collocated picture, the pred weight table, entry
//   points, the header extension); tiles (uniform and explicit spacing, the
//   tile scan, loop filtering across tiles or not); scaling lists (SPS, PPS,
//   the defaults); PCM; transquant bypass;
//   IDR, CRA, BLA, RASL, RADL, TSA, STSA and trailing pictures with temporal
//   sub-layers; CABAC with wavefront parallel processing
//   (entropy_coding_sync_enabled_flag); CTBs of 16 to 64, every part_mode (AMP
//   included), skip, merge (parallel merge level included), AMVP, TMVP, the
//   8x4 / 4x8 bi-to-uni rule; cu_qp_delta and the chroma QP offsets;
//   residual_coding in full (sign data hiding, transform skip); the 35 intra
//   modes with constrained intra prediction and strong intra smoothing; the
//   DST and the DCT 4 to 32; luma 8-tap and chroma 4-tap motion compensation
//   with default and explicit weighted prediction; the deblocking filter and
//   SAO; POC, RPS marking, missing references (grey, as FFmpeg makes them) and
//   output in POC order, bumped as FFmpeg bumps (sps_max_num_reorder_pics and
//   sps_max_dec_pic_buffering of the highest sub-layer), RASL pictures of a
//   CRA that starts the decode dropped, the conformance window cropped (the
//   default display window is not: FFmpeg does not apply it by default).
// Refused by name: bit depths above 10, luma and chroma bit depths that
// differ, chroma formats other than 4:2:0, the SPS / PPS extensions, and tiles
// with WPP together (cv2's FFmpeg decodes that pair otherwise than the
// standard).  Where FFmpeg departs from the standard in streams that real
// encoders write, the decoder follows FFmpeg and says so where it does.  NAL
// units of nuh_layer_id > 0 are skipped, and so are the unspecified types
// 48-63 (a Dolby Vision stream's RPUs are type 62) and the reserved 41-47.
// A read past a NAL's end or a syntax value out of range throws Corrupt;
// neither crosses the C API: each entry point returns 0, 1 (corrupt) or 2
// (unsupported) and keeps the message for hevcd_error.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "hevc_tables.h"

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& s) : std::runtime_error(s) {}
};
struct Unsupported : std::runtime_error {
  explicit Unsupported(const std::string& s) : std::runtime_error(s) {}
};

[[noreturn]] void corrupt(const std::string& what) { throw Corrupt("HEVC: " + what); }
[[noreturn]] void unsupported(const std::string& what) { throw Unsupported("HEVC " + what); }

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline int sign(int v) { return (v > 0) - (v < 0); }

// ── bits ─────────────────────────────────────────────────────────────────

struct Bits {
  const uint8_t* d = nullptr;
  size_t pos = 0, stop = 0, end = 0;   // bits: read position, rbsp stop bit, end of data

  void init(const std::vector<uint8_t>& rbsp) {
    d = rbsp.data();
    end = rbsp.size() * 8;
    size_t n = rbsp.size();
    while (n > 0 && rbsp[n - 1] == 0) --n;      // cabac_zero_words
    if (n == 0) corrupt("a NAL unit with no rbsp_stop_one_bit");
    int tz = __builtin_ctz(rbsp[n - 1]);
    stop = (n - 1) * 8 + (7 - tz);
    pos = 0;
  }
  inline uint32_t bit() {
    if (pos >= end) corrupt("a NAL unit ends inside a syntax element");
    uint32_t b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return b;
  }
  uint32_t u(int n) {
    if (n == 0) return 0;
    if (pos + n > stop) corrupt("a NAL unit ends inside a syntax element");
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++pos) v = v << 1 | ((d[pos >> 3] >> (7 - (pos & 7))) & 1);
    return v;
  }
  bool flag() { return u(1) != 0; }
  uint32_t ue() {
    int z = 0;
    while (!u(1))
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
  void skip(size_t n) {
    if (pos + n > end) corrupt("a NAL unit ends inside a syntax element");
    pos += n;
  }
};

std::vector<uint8_t> unescape(const uint8_t* p, size_t n) {
  std::vector<uint8_t> out;
  out.reserve(n);
  int zeros = 0;
  for (size_t i = 0; i < n; ++i) {
    if (zeros >= 2 && p[i] == 3) {
      zeros = 0;
      continue;
    }
    out.push_back(p[i]);
    zeros = p[i] == 0 ? zeros + 1 : 0;
  }
  return out;
}

// ── parameter sets ───────────────────────────────────────────────────────

struct RPS {
  int n_neg = 0, n_pos = 0;
  int dpoc[32];       // S0 (decreasing, negative) then S1 (increasing, positive)
  bool used[32];
  int total() const { return n_neg + n_pos; }
};

void profile_tier_level(Bits& b, int max_sub_layers_minus1) {
  b.skip(2 + 1 + 5 + 32 + 4 + 43 + 1);
  b.skip(8);                               // general_level_idc
  bool prof[8] = {}, lev[8] = {};
  for (int i = 0; i < max_sub_layers_minus1; ++i) {
    prof[i] = b.flag();
    lev[i] = b.flag();
  }
  if (max_sub_layers_minus1 > 0)
    for (int i = max_sub_layers_minus1; i < 8; ++i) b.skip(2);
  for (int i = 0; i < max_sub_layers_minus1; ++i) {
    if (prof[i]) b.skip(88);
    if (lev[i]) b.skip(8);
  }
}

void st_ref_pic_set(Bits& b, int idx, int num_sets, const std::vector<RPS>& sets, RPS& out) {
  bool inter = idx != 0 && b.flag();
  if (inter) {
    int delta_idx = 1;
    if (idx == num_sets) delta_idx = (int)b.ue_max(idx - 1, "delta_idx_minus1") + 1;
    int ref_idx = idx - delta_idx;
    if (ref_idx < 0 || ref_idx >= (int)sets.size()) corrupt("an RPS predicted from no RPS");
    const RPS& r = sets[ref_idx];
    int s = b.flag();
    int abs_delta = (int)b.ue_max(32767, "abs_delta_rps_minus1") + 1;
    int delta_rps = (1 - 2 * s) * abs_delta;
    int n = r.total();
    bool used_f[33], use_delta[33];
    for (int j = 0; j <= n; ++j) {
      used_f[j] = b.flag();
      use_delta[j] = used_f[j] ? true : b.flag();
    }
    int i = 0;
    RPS o;
    for (int j = r.n_pos - 1; j >= 0; --j) {
      int d = r.dpoc[r.n_neg + j] + delta_rps;
      if (d < 0 && use_delta[r.n_neg + j]) {
        if (i >= 16) corrupt("an RPS of more than 16 pictures");
        o.dpoc[i] = d;
        o.used[i++] = used_f[r.n_neg + j];
      }
    }
    if (delta_rps < 0 && use_delta[n]) {
      if (i >= 16) corrupt("an RPS of more than 16 pictures");
      o.dpoc[i] = delta_rps;
      o.used[i++] = used_f[n];
    }
    for (int j = 0; j < r.n_neg; ++j) {
      int d = r.dpoc[j] + delta_rps;
      if (d < 0 && use_delta[j]) {
        if (i >= 16) corrupt("an RPS of more than 16 pictures");
        o.dpoc[i] = d;
        o.used[i++] = used_f[j];
      }
    }
    o.n_neg = i;
    for (int j = r.n_neg - 1; j >= 0; --j) {
      int d = r.dpoc[j] + delta_rps;
      if (d > 0 && use_delta[j]) {
        if (i >= 32) corrupt("an RPS of more than 16 pictures");
        o.dpoc[i] = d;
        o.used[i++] = used_f[j];
      }
    }
    if (delta_rps > 0 && use_delta[n]) {
      if (i >= 32) corrupt("an RPS of more than 16 pictures");
      o.dpoc[i] = delta_rps;
      o.used[i++] = used_f[n];
    }
    for (int j = 0; j < r.n_pos; ++j) {
      int d = r.dpoc[r.n_neg + j] + delta_rps;
      if (d > 0 && use_delta[r.n_neg + j]) {
        if (i >= 32) corrupt("an RPS of more than 16 pictures");
        o.dpoc[i] = d;
        o.used[i++] = used_f[r.n_neg + j];
      }
    }
    o.n_pos = i - o.n_neg;
    if (o.total() > 16) corrupt("an RPS of more than 16 pictures");
    out = o;
  } else {
    RPS o;
    o.n_neg = (int)b.ue_max(16, "num_negative_pics");
    o.n_pos = (int)b.ue_max(16 - o.n_neg, "num_positive_pics");
    int poc = 0;
    for (int i = 0; i < o.n_neg; ++i) {
      poc -= (int)b.ue_max(32767, "delta_poc_s0_minus1") + 1;
      o.dpoc[i] = poc;
      o.used[i] = b.flag();
    }
    poc = 0;
    for (int i = 0; i < o.n_pos; ++i) {
      poc += (int)b.ue_max(32767, "delta_poc_s1_minus1") + 1;
      o.dpoc[o.n_neg + i] = poc;
      o.used[o.n_neg + i] = b.flag();
    }
    out = o;
  }
}

// ScalingFactor (7.4.5) by sizeId (4x4 to 32x32) and matrixId (intra Y, Cb,
// Cr, inter Y, Cb, Cr), each n x n in raster order
struct ScalingFactors {
  std::vector<uint8_t> m[4][6];
};

// scaling_list_data() (7.3.4), or the default lists (Table 7-6) where
// `b` is null, as ScalingFactor
std::shared_ptr<const ScalingFactors> scaling_list_data(Bits* b) {
  uint8_t list[4][6][64], dc[4][6];
  for (int size_id = 0; size_id < 4; ++size_id)
    for (int matrix_id = 0; matrix_id < 6; matrix_id += size_id == 3 ? 3 : 1) {
      int n = size_id == 0 ? 16 : 64;
      uint8_t* out = list[size_id][matrix_id];
      if (!b || !b->flag()) {
        // scaling_list_pred_matrix_id_delta: 0, the default; else a copy
        int step = size_id == 3 ? 3 : 1;
        int delta = b ? (int)b->ue_max(matrix_id / step, "scaling_list_pred_matrix_id_delta") : 0;
        if (delta == 0) {
          for (int i = 0; i < n; ++i)
            out[i] = size_id == 0 ? 16 : matrix_id < 3 ? DEFAULT_INTRA_8X8[i] : DEFAULT_INTER_8X8[i];
          dc[size_id][matrix_id] = 16;
        } else {
          int ref = matrix_id - delta * step;
          memcpy(out, list[size_id][ref], n);
          dc[size_id][matrix_id] = dc[size_id][ref];
        }
        continue;
      }
      int next = 8;
      if (size_id > 1) {
        next = b->se_range(-7, 247, "scaling_list_dc_coef_minus8") + 8;
        dc[size_id][matrix_id] = (uint8_t)next;
      }
      for (int i = 0; i < n; ++i) {
        next = (next + b->se_range(-128, 127, "scaling_list_delta_coef") + 256) % 256;
        if (next == 0) corrupt("a scaling list value of 0");
        out[i] = (uint8_t)next;
      }
    }
  auto f = std::make_shared<ScalingFactors>();
  for (int size_id = 0; size_id < 4; ++size_id)
    for (int matrix_id = 0; matrix_id < 6; ++matrix_id) {
      // 32x32 chroma (4:4:4 alone) is not coded: the 16x16's stands in
      int from = size_id == 3 && matrix_id % 3 ? matrix_id - matrix_id % 3 : matrix_id;
      int n = 4 << size_id, up = size_id < 2 ? 1 : 1 << (size_id - 1);
      std::vector<uint8_t>& m = f->m[size_id][matrix_id];
      m.assign((size_t)n * n, 0);
      for (int i = 0; i < (size_id == 0 ? 16 : 64); ++i) {
        int x = size_id == 0 ? SCAN_4[0][i][0] : SCAN_8[0][i][0];
        int y = size_id == 0 ? SCAN_4[0][i][1] : SCAN_8[0][i][1];
        for (int j = 0; j < up; ++j)
          for (int k = 0; k < up; ++k) m[(size_t)(y * up + j) * n + x * up + k] = list[size_id][from][i];
      }
      if (size_id > 1) m[0] = dc[size_id][from];
    }
  return f;
}

struct SPS {
  int id = 0, max_sub_layers = 1;
  int width = 0, height = 0, crop[4] = {0, 0, 0, 0};   // luma: left, right, top, bottom
  int bit_depth = 8, bit_depth_c = 8;
  int log2_max_poc_lsb = 4;
  int max_dec_pic_buffering = 1, max_num_reorder = 0, max_latency_increase = 0;
  int log2_min_cb = 3, log2_ctb = 4, log2_min_tb = 2, log2_max_tb = 4;
  int max_th_depth_inter = 0, max_th_depth_intra = 0;
  bool amp = false, sao = false, temporal_mvp = false, strong_intra = false;
  std::vector<RPS> rps;
  int ctb_w = 0, ctb_h = 0, ctb_size = 16;
  // scaling lists: the SPS's, or the defaults where it codes none
  std::shared_ptr<const ScalingFactors> scaling;
  // PCM (pcm_enabled_flag: pcm_bd > 0)
  int pcm_bd = 0, pcm_bd_c = 0, log2_min_pcm = 0, log2_max_pcm = 0;
  bool pcm_lf_disabled = false;
  // long-term reference pictures (long_term_ref_pics_present_flag)
  bool long_term = false;
  int num_lt_sps = 0, lt_lsb_sps[32];
  bool lt_used_sps[32];
};

void vui_hrd(Bits& b, bool common, int max_sub_layers_minus1) {
  bool nal = false, vcl = false, sub_pic = false;
  if (common) {
    nal = b.flag();
    vcl = b.flag();
    if (nal || vcl) {
      sub_pic = b.flag();
      if (sub_pic) b.skip(8 + 5 + 1 + 5);
      b.skip(8);
      if (sub_pic) b.skip(4);
      b.skip(15);
    }
  }
  for (int i = 0; i <= max_sub_layers_minus1; ++i) {
    bool general = b.flag();
    bool within = general ? true : b.flag();
    bool low_delay = false;
    if (within) b.ue();
    else low_delay = b.flag();
    int cpb_cnt = 1;
    if (!low_delay) cpb_cnt = (int)b.ue_max(31, "cpb_cnt_minus1") + 1;
    for (int k = 0; k < (int)nal + (int)vcl; ++k)
      for (int j = 0; j < cpb_cnt; ++j) {
        b.ue();
        b.ue();
        if (sub_pic) {
          b.ue();
          b.ue();
        }
        b.skip(1);
      }
  }
}

std::shared_ptr<SPS> parse_sps(Bits& b) {
  auto s = std::make_shared<SPS>();
  b.skip(4);                                             // sps_video_parameter_set_id
  int msl = (int)b.u(3);
  if (msl > 6) corrupt("sps_max_sub_layers_minus1 above 6");
  s->max_sub_layers = msl + 1;
  b.skip(1);
  profile_tier_level(b, msl);
  s->id = (int)b.ue_max(15, "sps_seq_parameter_set_id");
  int chroma = (int)b.ue_max(3, "chroma_format_idc");
  if (chroma != 1)
    unsupported(std::string("chroma format ") + (chroma == 0 ? "4:0:0 (monochrome)" :
                chroma == 2 ? "4:2:2" : "4:4:4") + " (a range extension profile)");
  s->width = (int)b.ue();
  s->height = (int)b.ue();
  if (s->width < 8 || s->height < 8 || s->width > 16888 || s->height > 16888 ||
      (int64_t)s->width * s->height > 35651584)
    corrupt("a picture size out of range");
  if (b.flag()) {
    for (int i = 0; i < 4; ++i) s->crop[i] = 2 * (int)b.ue_max(8192, "conf_win_offset");
    if (s->crop[0] + s->crop[1] >= s->width || s->crop[2] + s->crop[3] >= s->height)
      corrupt("a conformance window with nothing inside");
  }
  s->bit_depth = (int)b.ue_max(8, "bit_depth_luma_minus8") + 8;
  s->bit_depth_c = (int)b.ue_max(8, "bit_depth_chroma_minus8") + 8;
  std::string depths = std::to_string(s->bit_depth) + "-bit luma, " +
                       std::to_string(s->bit_depth_c) + "-bit chroma: a range extension profile)";
  if (s->bit_depth > 10 || s->bit_depth_c > 10) unsupported("bit depth above 10 (" + depths);
  if (s->bit_depth != s->bit_depth_c)
    unsupported("luma and chroma bit depths that differ (" + depths);
  s->log2_max_poc_lsb = (int)b.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
  bool ordering = b.flag();
  for (int i = ordering ? 0 : msl; i <= msl; ++i) {
    s->max_dec_pic_buffering = (int)b.ue_max(15, "sps_max_dec_pic_buffering_minus1") + 1;
    s->max_num_reorder = (int)b.ue_max(15, "sps_max_num_reorder_pics");
    s->max_latency_increase = (int)b.ue();
  }
  s->log2_min_cb = (int)b.ue_max(3, "log2_min_luma_coding_block_size_minus3") + 3;
  s->log2_ctb = s->log2_min_cb + (int)b.ue_max(3, "log2_diff_max_min_luma_coding_block_size");
  s->log2_min_tb = (int)b.ue_max(3, "log2_min_luma_transform_block_size_minus2") + 2;
  s->log2_max_tb = s->log2_min_tb + (int)b.ue_max(3, "log2_diff_max_min_luma_transform_block_size");
  if (s->log2_ctb < 4 || s->log2_ctb > 6) corrupt("a CTB size other than 16, 32 or 64");
  if (s->log2_max_tb > 5 || s->log2_max_tb > s->log2_ctb || s->log2_min_tb >= s->log2_min_cb)
    corrupt("transform block sizes out of range");
  s->max_th_depth_inter = (int)b.ue_max(s->log2_ctb - s->log2_min_tb, "max_transform_hierarchy_depth_inter");
  s->max_th_depth_intra = (int)b.ue_max(s->log2_ctb - s->log2_min_tb, "max_transform_hierarchy_depth_intra");
  if (b.flag()) s->scaling = scaling_list_data(b.flag() ? &b : nullptr);
  s->amp = b.flag();
  s->sao = b.flag();
  if (b.flag()) {                                       // pcm_enabled_flag
    s->pcm_bd = (int)b.u(4) + 1;
    s->pcm_bd_c = (int)b.u(4) + 1;
    s->log2_min_pcm = (int)b.ue_max(2, "log2_min_pcm_luma_coding_block_size_minus3") + 3;
    s->log2_max_pcm = s->log2_min_pcm + (int)b.ue_max(2, "log2_diff_max_min_pcm_luma_coding_block_size");
    if (s->pcm_bd > s->bit_depth || s->pcm_bd_c > s->bit_depth_c) corrupt("a PCM bit depth above the picture's");
    if (s->log2_min_pcm < std::min(s->log2_min_cb, 5) || s->log2_max_pcm > std::min(s->log2_ctb, 5))
      corrupt("PCM coding block sizes out of range");
    s->pcm_lf_disabled = b.flag();
  }
  int nsets = (int)b.ue_max(64, "num_short_term_ref_pic_sets");
  s->rps.resize(nsets);
  for (int i = 0; i < nsets; ++i) st_ref_pic_set(b, i, nsets, s->rps, s->rps[i]);
  s->long_term = b.flag();
  if (s->long_term) {
    s->num_lt_sps = (int)b.ue_max(32, "num_long_term_ref_pics_sps");
    for (int i = 0; i < s->num_lt_sps; ++i) {
      s->lt_lsb_sps[i] = (int)b.u(s->log2_max_poc_lsb);
      s->lt_used_sps[i] = b.flag();
    }
  }
  s->temporal_mvp = b.flag();
  s->strong_intra = b.flag();
  if (b.flag()) {                                       // vui_parameters
    if (b.flag() && b.u(8) == 255) b.skip(32);
    if (b.flag()) b.skip(1);
    if (b.flag()) {
      b.skip(4);
      if (b.flag()) b.skip(24);
    }
    if (b.flag()) {
      b.ue();
      b.ue();
    }
    b.skip(3);
    if (b.flag())                                       // default display window: not applied
      for (int i = 0; i < 4; ++i) b.ue();
    if (b.flag()) {
      b.skip(64);
      if (b.flag()) b.ue();
      if (b.flag()) vui_hrd(b, true, msl);
    }
    if (b.flag()) {
      b.skip(3);
      for (int i = 0; i < 5; ++i) b.ue();
    }
  }
  if (b.flag()) {
    bool range = b.flag(), multilayer = b.flag(), ext3d = b.flag(), scc = b.flag();
    int ext4 = (int)b.u(4);
    if (range) unsupported("range extension (sps_range_extension_flag)");
    if (multilayer) unsupported("multilayer extension (sps_multilayer_extension_flag): a multi-layer stream");
    if (ext3d) unsupported("3D extension (sps_3d_extension_flag)");
    if (scc) unsupported("screen content coding extension (sps_scc_extension_flag)");
    if (ext4) unsupported("SPS extension (sps_extension_4bits)");
  }
  s->ctb_size = 1 << s->log2_ctb;
  s->ctb_w = (s->width + s->ctb_size - 1) >> s->log2_ctb;
  s->ctb_h = (s->height + s->ctb_size - 1) >> s->log2_ctb;
  int min_cb = 1 << s->log2_min_cb;
  if (s->width % min_cb || s->height % min_cb)
    corrupt("a picture size that is not a multiple of the minimum coding block");
  return s;
}

struct PPS {
  int id = 0, sps_id = 0;
  bool dependent_slices = false, output_flag_present = false, sign_hiding = false;
  bool cabac_init_present = false, constrained_intra = false, transform_skip = false;
  bool cu_qp_delta = false, slice_chroma_qp_offsets = false, weighted_pred = false;
  bool weighted_bipred = false, entropy_sync = false, lf_across_slices = false;
  bool deblock_override = false, deblock_disabled = false, lists_modification = false;
  bool header_extension = false, transquant_bypass = false;
  int num_extra_bits = 0, num_ref_idx[2] = {1, 1}, init_qp = 26, diff_cu_qp_delta_depth = 0;
  int cb_qp_offset = 0, cr_qp_offset = 0, beta_offset = 0, tc_offset = 0;
  int log2_parallel_merge = 2;
  // tiles: 1 x 1 where tiles_enabled_flag is 0; the widths and heights in
  // CTBs where they are explicit (empty: uniform spacing), the last one
  // derived at activation from the SPS
  bool tiles = false, lf_across_tiles = true;
  int tile_cols = 1, tile_rows = 1;
  std::vector<int> col_w, row_h;
  // pps_scaling_list_data_present_flag: these replace the SPS's
  std::shared_ptr<const ScalingFactors> scaling;
};

std::shared_ptr<PPS> parse_pps(Bits& b) {
  auto p = std::make_shared<PPS>();
  p->id = (int)b.ue_max(63, "pps_pic_parameter_set_id");
  p->sps_id = (int)b.ue_max(15, "pps_seq_parameter_set_id");
  p->dependent_slices = b.flag();
  p->output_flag_present = b.flag();
  p->num_extra_bits = (int)b.u(3);
  p->sign_hiding = b.flag();
  p->cabac_init_present = b.flag();
  p->num_ref_idx[0] = (int)b.ue_max(14, "num_ref_idx_l0_default_active_minus1") + 1;
  p->num_ref_idx[1] = (int)b.ue_max(14, "num_ref_idx_l1_default_active_minus1") + 1;
  // -(26 + QpBdOffsetY) at the deepest samples read; SliceQpY is held to its
  // SPS's range
  p->init_qp = 26 + b.se_range(-26 - 12, 25, "init_qp_minus26");
  p->constrained_intra = b.flag();
  p->transform_skip = b.flag();
  p->cu_qp_delta = b.flag();
  if (p->cu_qp_delta) p->diff_cu_qp_delta_depth = (int)b.ue_max(3, "diff_cu_qp_delta_depth");
  p->cb_qp_offset = b.se_range(-12, 12, "pps_cb_qp_offset");
  p->cr_qp_offset = b.se_range(-12, 12, "pps_cr_qp_offset");
  p->slice_chroma_qp_offsets = b.flag();
  p->weighted_pred = b.flag();
  p->weighted_bipred = b.flag();
  p->transquant_bypass = b.flag();
  p->tiles = b.flag();
  p->entropy_sync = b.flag();
  if (p->tiles) {
    // the bounds that need the SPS are checked at activation
    p->tile_cols = (int)b.ue_max(1023, "num_tile_columns_minus1") + 1;
    p->tile_rows = (int)b.ue_max(1023, "num_tile_rows_minus1") + 1;
    if (!b.flag()) {                                    // uniform_spacing_flag
      for (int i = 0; i + 1 < p->tile_cols; ++i) p->col_w.push_back((int)b.ue_max(1023, "column_width_minus1") + 1);
      for (int i = 0; i + 1 < p->tile_rows; ++i) p->row_h.push_back((int)b.ue_max(1023, "row_height_minus1") + 1);
    }
    p->lf_across_tiles = b.flag();
    // cv2's FFmpeg decodes this pair otherwise than the standard (it loads
    // WPP's stored contexts at a tile's first CTB, and takes a tile's CTB
    // rows for the picture's)
    if (p->entropy_sync)
      unsupported("tiles with wavefront parallel processing (tiles_enabled_flag and "
                  "entropy_coding_sync_enabled_flag both 1)");
  }
  p->lf_across_slices = b.flag();
  if (b.flag()) {
    p->deblock_override = b.flag();
    p->deblock_disabled = b.flag();
    if (!p->deblock_disabled) {
      p->beta_offset = 2 * b.se_range(-6, 6, "pps_beta_offset_div2");
      p->tc_offset = 2 * b.se_range(-6, 6, "pps_tc_offset_div2");
    }
  }
  if (b.flag()) p->scaling = scaling_list_data(&b);
  p->lists_modification = b.flag();
  p->log2_parallel_merge = (int)b.ue_max(4, "log2_parallel_merge_level_minus2") + 2;
  p->header_extension = b.flag();
  if (b.flag()) {
    bool range = b.flag(), multilayer = b.flag(), ext3d = b.flag(), scc = b.flag();
    int ext4 = (int)b.u(4);
    if (range) unsupported("range extension (pps_range_extension_flag)");
    if (multilayer) unsupported("multilayer extension (pps_multilayer_extension_flag): a multi-layer stream");
    if (ext3d) unsupported("3D extension (pps_3d_extension_flag)");
    if (scc) unsupported("screen content coding extension (pps_scc_extension_flag)");
    if (ext4) unsupported("PPS extension (pps_extension_4bits)");
  }
  return p;
}

// ── pictures ─────────────────────────────────────────────────────────────

struct MvField {
  int16_t mv[2][2];
  int8_t ref_idx[2];
  uint8_t pred;        // bit 0: list 0, bit 1: list 1; 0: intra (or none)
  uint8_t lt;          // bit l: list l's reference was long-term when this was decoded
  int32_t ref_poc[2];
};

struct Pic {
  int w = 0, h = 0, crop[4] = {0, 0, 0, 0};
  int bd = 8;                          // the samples are p8's at 8 bits, else p16's
  std::vector<uint8_t> p8[3];          // Y', Cb, Cr
  std::vector<uint16_t> p16[3];
  std::vector<MvField> mvf;           // by 4x4, for TMVP
  int poc = 0;
  bool ref = false, output = false;
  bool lt = false;                     // marked "used for long-term reference"
  int w4 = 0, h4 = 0;

  // a picture of grey samples (1 << (depth - 1)): what a missing reference
  // shows; decoding overwrites every sample of the others
  void alloc(int W, int H, int depth) {
    w = W;
    h = H;
    w4 = W >> 2;
    h4 = H >> 2;
    bd = depth;
    for (int c = 0; c < 3; ++c) {
      size_t n = c ? (size_t)W * H / 4 : (size_t)W * H;
      if (bd > 8) p16[c].assign(n, (uint16_t)(1 << (bd - 1)));
      else p8[c].assign(n, (uint8_t)(1 << (bd - 1)));
    }
    mvf.assign((size_t)w4 * h4, MvField{});
  }
  template <class T> T* plane(int c);
};
template <> uint8_t* Pic::plane<uint8_t>(int c) { return p8[c].data(); }
template <> uint16_t* Pic::plane<uint16_t>(int c) { return p16[c].data(); }
using PicP = std::shared_ptr<Pic>;

// what deblocking and SAO read of each slice segment
struct SliceInfo {
  int addr = 0;                        // SliceAddrRs
  bool deblock_disabled = false, lf_across = false;
  int beta_offset = 0, tc_offset = 0;
  bool sao_luma = false, sao_chroma = false;
};

struct SaoParams {
  uint8_t type[3];                     // 0 none, 1 band, 2 edge
  uint8_t band_pos[3], eo_class[3];
  int8_t offset[3][5];
};

struct SliceHeader {
  bool first = false, no_output_of_prior_pics = false, dependent = false;
  int pps_id = 0, address = 0, type = 2;      // 0 B, 1 P, 2 I
  bool pic_output = true;
  int poc_lsb = 0;
  RPS rps;
  // the long-term entries (7.3.6.1): PocLsbLt, used_by_curr_pic_lt_flag, and
  // DeltaPocMsbCycleLt where delta_poc_msb_present_flag is 1 (else -1)
  int n_lt = 0, lt_lsb[32];
  bool lt_used[32];
  int64_t lt_msb_cycle[32];
  bool tmvp = false, sao_luma = false, sao_chroma = false;
  int num_ref_idx[2] = {0, 0};
  bool list_mod[2] = {false, false};
  int list_entry[2][16];
  bool mvd_l1_zero = false, cabac_init = false, col_from_l0 = true;
  int col_ref_idx = 0;
  int max_merge = 5;
  int qp_delta = 0, cb_qp_offset = 0, cr_qp_offset = 0;
  bool deblock_disabled = false;
  int beta_offset = 0, tc_offset = 0;
  bool lf_across = false;
  // explicit weights
  int luma_log2_wd = 0, chroma_log2_wd = 0;
  int lw[2][16], lo[2][16], cw[2][16][2], co[2][16][2];
  int slice_addr = 0, qp = 26;
};

// ── the decoder ──────────────────────────────────────────────────────────

enum { PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN, PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N };

struct Decoder {
  std::array<std::shared_ptr<const SPS>, 16> spss;
  std::array<std::shared_ptr<const PPS>, 64> ppss;
  // the active parameter sets, held while their picture is decoded; the
  // next picture's, from its first slice segment header
  std::shared_ptr<const SPS> sps_ref, next_sps;
  std::shared_ptr<const PPS> pps_ref, next_pps;
  const SPS* sps = nullptr;
  const PPS* pps = nullptr;

  std::vector<PicP> dpb;
  std::vector<PicP> ready;
  PicP cur;
  std::string error;

  // sequence state
  bool first_pic = true, after_eos = false, assoc_no_rasl = false;
  int prev_tid0_poc = 0;
  bool skipping = false;               // the current picture is a dropped RASL picture
  int nal_type = 0, temporal_id = 0;

  // the picture's reference sets
  std::vector<PicP> st_before, st_after, lt_curr;
  PicP ref_list[2][16];
  int ref_poc[2][16];
  bool ref_lt[2][16];

  // the bit depth (luma = chroma), as the arithmetic reads it; wide: the
  // samples are uint16_t (bd above 8)
  int bd = 8, maxv = 255, qpbd = 0;
  bool wide = false;
  // per picture, by 4x4 unit
  int W = 0, H = 0, w4 = 0, h4 = 0;
  std::vector<uint8_t> ct_depth, skip_flag, intra, ipm, cbf_map, edge_v, edge_h;
  std::vector<int8_t> qp_map;            // QpY: -QpBdOffsetY to 51
  std::vector<int32_t> zs;               // MinTbAddrZs of each 4x4 unit (over the tile scan)
  std::vector<int16_t> ctb_slice;        // slice segment index of each CTB (-1: not decoded)
  // the tiles (6.5.1): CtbAddrRsToTs, CtbAddrTsToRs and TileId by raster
  // address; `layout` is what they were derived from
  std::vector<int32_t> rs2ts, ts2rs, tile_id, layout;
  std::vector<uint8_t> no_filter;        // PCM (loop filter disabled) and bypass CUs' 4x4 units
  const ScalingFactors* scaling = nullptr;   // the active lists (null: flat, 16)
  std::vector<SliceInfo> slices;
  std::vector<SaoParams> sao;            // by CTB

  // slice state
  SliceHeader sh;
  Bits bs;
  std::vector<uint8_t> rbsp;
  size_t nal_size = 0;                   // the slice segment's NAL unit, escaped
  int ctb_addr = 0, slice_idx = 0;
  uint8_t ctx[N_CTX], wpp_ctx[N_CTX], ds_ctx[N_CTX];
  bool wpp_saved = false;
  uint32_t range = 510, offset = 0;
  // quantization
  int qp_y = 26, qp_y_pred = 26, last_qp_y = 26;
  bool cu_qp_delta_coded = false;
  int cu_qp_delta_val = 0;
  bool first_qg_in_slice = true;
  // coding unit
  int cu_x = 0, cu_y = 0, cu_log2 = 3;
  bool cu_intra = false, cu_skip = false, cu_bypass = false;
  int part_mode = 0;
  int chroma_mode = 0;
  bool merge_flag_cu = false;
  int16_t coeffs[32 * 32];
  int32_t tmp32[32 * 32];

  // ── entry ──
  void nal(const uint8_t* data, size_t size);
  void end_picture();
  void flush();

  // ── pictures ──
  void start_picture();
  void bump(bool all, bool discard);
  PicP missing_ref(int poc);
  void output_ready(bool all);

  // ── slice ──
  void slice_header(Bits& b, int type);
  void slice_data();
  void init_contexts();
  void init_engine();
  int dec(int i);
  int bypass();
  int bypass_bits(int n) {
    int v = 0;
    for (int i = 0; i < n; ++i) v = v << 1 | bypass();
    return v;
  }
  int terminate();

  // ── syntax ──
  void sao_syntax(int rx, int ry);
  void coding_quadtree(int x0, int y0, int log2, int depth);
  void coding_unit(int x0, int y0, int log2);
  void prediction_unit(int x0, int y0, int w, int h, int part_idx);
  void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk, bool parent_cb,
                      bool parent_cr, int max_depth, bool intra_split);
  void transform_unit(int x0, int y0, int xb, int yb, int log2, int blk, bool cbf_l,
                      bool cbf_cb, bool cbf_cr);
  void residual(int x0, int y0, int log2, int c);
  void set_qp_group(int x0, int y0);
  template <class T> void pcm_sample_t(int x0, int y0, int log2);
  void layout_tiles();
  bool first_in_tile(int ts) const { return ts == 0 || tile_id[ts2rs[ts]] != tile_id[ts2rs[ts - 1]]; }
  int luma_qp() const {
    return ((qp_y_pred + cu_qp_delta_val + 52 + 2 * qpbd) % (52 + qpbd)) - qpbd;
  }

  // ── availability ──
  inline bool in_pic(int x, int y) const { return x >= 0 && y >= 0 && x < W && y < H; }
  inline int u4(int x, int y) const { return (y >> 2) * w4 + (x >> 2); }
  inline int ctb_of(int x, int y) const { return (y >> sps->log2_ctb) * sps->ctb_w + (x >> sps->log2_ctb); }
  bool avail_z(int xc, int yc, int xn, int yn) const;

  // ── prediction ──
  // the functions that touch samples: a template on their type, called
  // through the untemplated name, which picks the type of the picture
  void intra_pred(int c, int x0, int y0, int log2, int mode) {
    wide ? intra_pred_t<uint16_t>(c, x0, y0, log2, mode) : intra_pred_t<uint8_t>(c, x0, y0, log2, mode);
  }
  template <class T> void intra_pred_t(int c, int x0, int y0, int log2, int mode);
  void derive_merge(int xc, int yc, int ncb, int xp, int yp, int w, int h, int part_idx, int idx,
                    MvField& out);
  void derive_amvp(int xc, int yc, int ncb, int xp, int yp, int w, int h, int part_idx, int lx,
                   int ref_idx, int16_t mvp[2], int flag);
  bool temporal_mv(int xp, int yp, int w, int h, int lx, int ref_idx, int16_t mv[2]);
  bool col_mv(int x, int y, int lx, int ref_idx, int16_t mv[2]);
  bool pb_avail(int xc, int yc, int ncb, int xp, int yp, int w, int h, int part_idx, int xn, int yn) const;
  void motion_compensate(int xp, int yp, int w, int h, const MvField& m) {
    wide ? motion_compensate_t<uint16_t>(xp, yp, w, h, m) : motion_compensate_t<uint8_t>(xp, yp, w, h, m);
  }
  template <class T> void motion_compensate_t(int xp, int yp, int w, int h, const MvField& m);
  template <class T> void add_residual(int c, int x0, int y0, int n, const int32_t* r);
  void store_pu(int xp, int yp, int w, int h, const MvField& m);

  // ── loop filters ──
  void deblock() { wide ? deblock_t<uint16_t>() : deblock_t<uint8_t>(); }
  template <class T> void deblock_t();
  template <class T>
  void deblock_edge_luma(bool vertical, int x, int y, int strength, int qp, const SliceInfo& si);
  template <class T>
  void deblock_edge_chroma(bool vertical, int c, int x, int y, int qp, const SliceInfo& si);
  int bs_of(int xp, int yp, int xq, int yq, bool tu_edge) const;
  void apply_sao() { wide ? apply_sao_t<uint16_t>() : apply_sao_t<uint8_t>(); }
  template <class T> void apply_sao_t();
};

// ── NAL units ────────────────────────────────────────────────────────────

void Decoder::nal(const uint8_t* data, size_t size) {
  if (size < 2) corrupt("a NAL unit of fewer than 2 bytes");
  if (data[0] & 0x80) corrupt("forbidden_zero_bit is 1");
  int type = (data[0] >> 1) & 63;
  int layer = ((data[0] & 1) << 5) | (data[1] >> 3);
  int tid = (data[1] & 7) - 1;
  if (tid < 0) corrupt("nuh_temporal_id_plus1 is 0");
  if (layer > 0) return;                // a layer above the base: skipped, as FFmpeg does
  if (type > 21 && type != 33 && type != 34 && type != 36 && type != 37) return;
  if ((type >= 10 && type <= 15)) return;      // reserved VCL types
  rbsp = unescape(data + 2, size - 2);
  nal_size = size;
  Bits b;
  if (type == 33) {
    b.init(rbsp);
    auto s = parse_sps(b);
    int id = s->id;
    spss[id] = std::move(s);
    return;
  }
  if (type == 34) {
    b.init(rbsp);
    auto p = parse_pps(b);
    int id = p->id;
    ppss[id] = std::move(p);
    return;
  }
  if (type == 36 || type == 37) {
    end_picture();
    after_eos = true;
    return;
  }
  // a slice segment
  bs.init(rbsp);
  nal_type = type;
  temporal_id = tid;
  slice_header(bs, type);
  if (sh.first) {
    end_picture();
    sps_ref = next_sps;
    pps_ref = next_pps;
    sps = sps_ref.get();
    pps = pps_ref.get();
    start_picture();
  } else if (!cur && !skipping) {
    corrupt("a slice segment of a picture whose first slice segment is missing");
  }
  if (skipping) return;
  slice_data();
}

// ── slice header (7.3.6.1) ───────────────────────────────────────────────

void Decoder::slice_header(Bits& b, int type) {
  SliceHeader h;
  bool irap = type >= 16 && type <= 23;
  h.first = b.flag();
  if (irap) h.no_output_of_prior_pics = b.flag();
  h.pps_id = (int)b.ue_max(63, "slice_pic_parameter_set_id");
  const PPS* p = ppss[h.pps_id].get();
  if (!p) corrupt("a slice refers to a missing PPS");
  const SPS* s = spss[p->sps_id].get();
  if (!s) corrupt("a PPS refers to a missing SPS");
  if (!h.first) {
    if (!cur && !skipping) corrupt("a slice segment of a picture whose first slice segment is missing");
    if (p != pps || s != sps) corrupt("slice segments of one picture with different parameter sets");
    if (p->dependent_slices) h.dependent = b.flag();
    int n = s->ctb_w * s->ctb_h, bits = 0;
    while ((1 << bits) < n) ++bits;
    h.address = (int)b.u(bits);
    if (h.address >= n || h.address == 0) corrupt("slice_segment_address out of range");
  } else {
    next_pps = ppss[h.pps_id];
    next_sps = spss[p->sps_id];
  }
  if (h.dependent) {
    if (slices.empty()) corrupt("a dependent slice segment with no slice before it");
    SliceHeader prev = sh;
    prev.first = false;
    prev.dependent = true;
    prev.address = h.address;
    prev.no_output_of_prior_pics = h.no_output_of_prior_pics;
    h = prev;
  } else {
    h.slice_addr = h.address;
    b.skip(p->num_extra_bits);
    h.type = (int)b.ue_max(2, "slice_type");
    if (irap && h.type != 2) corrupt("a P or B slice in an IRAP picture");
    if (p->output_flag_present) h.pic_output = b.flag();
    if (type != 19 && type != 20) {
      h.poc_lsb = (int)b.u(s->log2_max_poc_lsb);
      bool from_sps = b.flag();
      if (!from_sps) {
        st_ref_pic_set(b, (int)s->rps.size(), (int)s->rps.size(), s->rps, h.rps);
      } else {
        if (s->rps.empty()) corrupt("short_term_ref_pic_set_sps_flag with no RPS in the SPS");
        int bits = 0;
        while ((1 << bits) < (int)s->rps.size()) ++bits;
        int idx = (int)b.u(bits);
        if (idx >= (int)s->rps.size()) corrupt("short_term_ref_pic_set_idx out of range");
        h.rps = s->rps[idx];
      }
      if (s->long_term) {
        int n_sps = s->num_lt_sps > 0 ? (int)b.ue_max(s->num_lt_sps, "num_long_term_sps") : 0;
        int n_pics = (int)b.ue_max(32, "num_long_term_pics");
        h.n_lt = n_sps + n_pics;
        if (h.n_lt > 32 || h.n_lt + h.rps.total() > 32) corrupt("more than 32 reference pictures in the RPS");
        int bits = 0;
        while ((1 << bits) < s->num_lt_sps) ++bits;
        int64_t prev = 0;
        for (int i = 0; i < h.n_lt; ++i) {
          if (i < n_sps) {
            int idx = (int)b.u(bits);
            if (idx >= s->num_lt_sps) corrupt("lt_idx_sps out of range");
            h.lt_lsb[i] = s->lt_lsb_sps[idx];
            h.lt_used[i] = s->lt_used_sps[idx];
          } else {
            h.lt_lsb[i] = (int)b.u(s->log2_max_poc_lsb);
            h.lt_used[i] = b.flag();
          }
          h.lt_msb_cycle[i] = -1;
          if (b.flag()) {                               // delta_poc_msb_present_flag
            // DeltaPocMsbCycleLt: a running sum within each of the two groups
            int64_t d = b.ue();
            if (i != 0 && i != n_sps) d += prev;
            h.lt_msb_cycle[i] = prev = d;
          }
        }
      }
      if (s->temporal_mvp) h.tmvp = b.flag();
    }
    if (s->sao) {
      h.sao_luma = b.flag();
      h.sao_chroma = b.flag();
    }
    int total_curr = 0;                             // NumPicTotalCurr
    for (int i = 0; i < h.rps.total(); ++i) total_curr += h.rps.used[i];
    for (int i = 0; i < h.n_lt; ++i) total_curr += h.lt_used[i];
    if (h.type != 2) {
      h.num_ref_idx[0] = p->num_ref_idx[0];
      h.num_ref_idx[1] = h.type == 0 ? p->num_ref_idx[1] : 0;
      if (b.flag()) {
        h.num_ref_idx[0] = (int)b.ue_max(14, "num_ref_idx_l0_active_minus1") + 1;
        if (h.type == 0) h.num_ref_idx[1] = (int)b.ue_max(14, "num_ref_idx_l1_active_minus1") + 1;
      }
      if (total_curr == 0) corrupt("a P or B slice with no reference picture");
      if (p->lists_modification && total_curr > 1) {
        int bits = 0;
        while ((1 << bits) < total_curr) ++bits;
        for (int l = 0; l < (h.type == 0 ? 2 : 1); ++l) {
          h.list_mod[l] = b.flag();
          if (h.list_mod[l])
            for (int i = 0; i < h.num_ref_idx[l]; ++i) {
              h.list_entry[l][i] = (int)b.u(bits);
              if (h.list_entry[l][i] >= total_curr) corrupt("list_entry out of range");
            }
        }
      }
      if (h.type == 0) h.mvd_l1_zero = b.flag();
      if (p->cabac_init_present) h.cabac_init = b.flag();
      if (h.tmvp) {
        if (h.type == 0) h.col_from_l0 = b.flag();
        int n = h.num_ref_idx[h.col_from_l0 ? 0 : 1];
        if (n > 1) h.col_ref_idx = (int)b.ue_max(n - 1, "collocated_ref_idx");
      }
      if ((p->weighted_pred && h.type == 1) || (p->weighted_bipred && h.type == 0)) {
        h.luma_log2_wd = (int)b.ue_max(7, "luma_log2_weight_denom");
        h.chroma_log2_wd = h.luma_log2_wd + b.se();
        if (h.chroma_log2_wd < 0 || h.chroma_log2_wd > 7) corrupt("ChromaLog2WeightDenom out of range");
        for (int l = 0; l < (h.type == 0 ? 2 : 1); ++l) {
          bool lf[16], cf[16];
          for (int i = 0; i < h.num_ref_idx[l]; ++i) lf[i] = b.flag();
          for (int i = 0; i < h.num_ref_idx[l]; ++i) cf[i] = b.flag();
          for (int i = 0; i < h.num_ref_idx[l]; ++i) {
            h.lw[l][i] = 1 << h.luma_log2_wd;
            h.lo[l][i] = 0;
            if (lf[i]) {
              h.lw[l][i] += b.se_range(-128, 127, "delta_luma_weight");
              h.lo[l][i] = b.se_range(-128, 127, "luma_offset");
            }
            for (int j = 0; j < 2; ++j) {
              h.cw[l][i][j] = 1 << h.chroma_log2_wd;
              h.co[l][i][j] = 0;
              if (cf[i]) {
                int dw = b.se_range(-128, 127, "delta_chroma_weight");
                int dof = b.se_range(-512, 511, "delta_chroma_offset");
                h.cw[l][i][j] += dw;
                h.co[l][i][j] = clip3(-128, 127, (128 - ((128 * h.cw[l][i][j]) >> h.chroma_log2_wd)) + dof);
              }
            }
          }
        }
      } else {
        for (int l = 0; l < 2; ++l)
          for (int i = 0; i < 16; ++i) {
            h.lw[l][i] = 1;
            h.lo[l][i] = 0;
            h.cw[l][i][0] = h.cw[l][i][1] = 1;
            h.co[l][i][0] = h.co[l][i][1] = 0;
          }
      }
      h.max_merge = 5 - (int)b.ue_max(4, "five_minus_max_num_merge_cand");
    }
    h.qp_delta = b.se();
    h.qp = p->init_qp + h.qp_delta;
    if (h.qp < -6 * (s->bit_depth - 8) || h.qp > 51) corrupt("SliceQpY out of range");
    if (p->slice_chroma_qp_offsets) {
      h.cb_qp_offset = b.se_range(-12, 12, "slice_cb_qp_offset");
      h.cr_qp_offset = b.se_range(-12, 12, "slice_cr_qp_offset");
    }
    bool override = p->deblock_override && b.flag();
    h.deblock_disabled = p->deblock_disabled;
    h.beta_offset = p->beta_offset;
    h.tc_offset = p->tc_offset;
    if (override) {
      h.deblock_disabled = b.flag();
      if (!h.deblock_disabled) {
        h.beta_offset = 2 * b.se_range(-6, 6, "slice_beta_offset_div2");
        h.tc_offset = 2 * b.se_range(-6, 6, "slice_tc_offset_div2");
      }
    }
    h.lf_across = p->lf_across_slices;
    if (p->lf_across_slices && (h.sao_luma || h.sao_chroma || !h.deblock_disabled))
      h.lf_across = b.flag();
  }
  if (p->tiles || p->entropy_sync) {
    int most = p->tiles ? p->tile_cols * p->tile_rows - 1 : s->ctb_h - 1;
    int n = (int)b.ue_max(most, "num_entry_point_offsets");
    if (n > 0) {
      // the substreams are found by the realignment that ends each one; the
      // offsets are only held to the NAL unit's size
      int len = (int)b.ue_max(31, "offset_len_minus1") + 1;
      uint64_t total = 0;
      for (int i = 0; i < n; ++i) total += (uint64_t)b.u(len) + 1;
      if (total >= nal_size) corrupt("entry points past the slice segment's data");
    }
  }
  if (p->header_extension) {
    int n = (int)b.ue_max(256, "slice_segment_header_extension_length");
    b.skip(8 * (size_t)n);
  }
  // byte_alignment()
  if (!b.flag()) corrupt("alignment_bit_equal_to_one is 0");
  while (b.pos & 7)
    if (b.flag()) corrupt("alignment_bit_equal_to_zero is 1");
  sh = h;
}

// ── pictures: POC, RPS, DPB (8.3, C.5.2) ─────────────────────────────────

PicP Decoder::missing_ref(int poc) {
  auto p = std::make_shared<Pic>();
  p->alloc(W, H, bd);                    // grey: 1 << (bd - 1)
  p->poc = poc;
  p->ref = true;
  p->output = false;
  dpb.push_back(p);
  return p;
}

void Decoder::bump(bool all, bool discard) {
  // output (or drop) the pictures waiting for output, smallest POC first,
  // while the conditions hold; all: every one
  for (;;) {
    int n_out = 0, n_dpb = 0;
    int best = -1;
    for (size_t i = 0; i < dpb.size(); ++i) {
      const Pic& p = *dpb[i];
      if (p.output) {
        ++n_out;
        if (best < 0 || p.poc < dpb[best]->poc) best = (int)i;
      }
      if (p.output || p.ref) ++n_dpb;
    }
    bool go = all ? n_out > 0
                  : (n_out > sps->max_num_reorder || (n_out && n_dpb > sps->max_dec_pic_buffering));
    if (!go) break;
    PicP p = dpb[best];
    p->output = false;
    if (!discard) ready.push_back(p);
    if (!p->ref) dpb.erase(dpb.begin() + best);
  }
  dpb.erase(std::remove_if(dpb.begin(), dpb.end(), [](const PicP& p) { return !p->ref && !p->output; }),
            dpb.end());
}

void Decoder::start_picture() {
  const SPS* s = sps;
  bool irap = nal_type >= 16 && nal_type <= 23;
  bool idr = nal_type == 19 || nal_type == 20;
  bool rasl = nal_type == 8 || nal_type == 9;
  skipping = false;
  bool no_rasl = false;
  if (irap) {
    no_rasl = idr || (nal_type >= 16 && nal_type <= 18) || first_pic || after_eos;
    assoc_no_rasl = no_rasl;
  }
  if (rasl && assoc_no_rasl) {
    skipping = true;
    return;
  }
  bd = s->bit_depth;
  maxv = (1 << bd) - 1;
  qpbd = 6 * (bd - 8);
  wide = bd > 8;
  W = s->width;
  H = s->height;
  w4 = W >> 2;
  h4 = H >> 2;
  layout_tiles();
  scaling = !s->scaling ? nullptr : pps->scaling ? pps->scaling.get() : s->scaling.get();
  size_t n4 = (size_t)w4 * h4;
  for (auto* v : {&ct_depth, &skip_flag, &intra, &ipm, &cbf_map, &edge_v, &edge_h, &no_filter})
    v->assign(n4, 0);
  qp_map.assign(n4, 0);
  ctb_slice.assign((size_t)s->ctb_w * s->ctb_h, -1);
  sao.assign((size_t)s->ctb_w * s->ctb_h, SaoParams{});
  slices.clear();
  // POC (8.3.1)
  int max_lsb = 1 << s->log2_max_poc_lsb;
  int lsb = idr ? 0 : sh.poc_lsb, msb;
  if (irap && no_rasl) {
    msb = 0;
  } else {
    int prev_lsb = prev_tid0_poc & (max_lsb - 1), prev_msb = prev_tid0_poc - prev_lsb;
    if (lsb < prev_lsb && prev_lsb - lsb >= max_lsb / 2) msb = prev_msb + max_lsb;
    else if (lsb > prev_lsb && lsb - prev_lsb > max_lsb / 2) msb = prev_msb - max_lsb;
    else msb = prev_msb;
  }
  int poc = msb + lsb;
  bool slnr = nal_type <= 14 && nal_type % 2 == 0;
  if (temporal_id == 0 && !(nal_type >= 6 && nal_type <= 9) && !slnr) prev_tid0_poc = poc;
  // C.5.2.2: an IRAP picture with NoRaslOutputFlag empties the DPB
  if (irap && no_rasl && !first_pic) {
    bool discard = nal_type == 21 ? true : sh.no_output_of_prior_pics;
    for (auto& p : dpb) p->ref = false;
    bump(true, discard);
    dpb.clear();
  }
  // RPS marking (8.3.2): the long-term entries first, by their POC's LSBs
  // or, with delta_poc_msb_present_flag, by the whole POC
  st_before.clear();
  st_after.clear();
  lt_curr.clear();
  if (idr) {
    for (auto& p : dpb) p->ref = false;
  } else {
    std::vector<PicP> keep;
    for (int i = 0; i < sh.n_lt; ++i) {
      bool msb = sh.lt_msb_cycle[i] >= 0;
      int64_t want = msb ? poc - sh.lt_msb_cycle[i] * max_lsb - (lsb - sh.lt_lsb[i]) : sh.lt_lsb[i];
      if (want < INT32_MIN || want > INT32_MAX) corrupt("a long-term reference's POC out of range");
      PicP found;
      for (auto& p : dpb)
        if (p->ref && (msb ? p->poc == want : (p->poc & (max_lsb - 1)) == want)) found = p;
      // a missing one: grey, with the POC (or the LSBs) named, as FFmpeg makes it
      if (!found && sh.lt_used[i]) found = missing_ref((int)want);
      if (found) {
        found->lt = true;
        keep.push_back(found);
        if (sh.lt_used[i]) lt_curr.push_back(found);
      }
    }
    const RPS& r = sh.rps;
    for (int i = 0; i < r.total(); ++i) {
      int want = poc + r.dpoc[i];
      PicP found;
      for (auto& p : dpb)
        if (p->ref && !p->lt && p->poc == want) found = p;
      if (!found && r.used[i]) found = missing_ref(want);
      if (found) {
        keep.push_back(found);
        if (r.used[i]) (i < r.n_neg ? st_before : st_after).push_back(found);
      }
    }
    for (auto& p : dpb) {
      bool k = false;
      for (auto& q : keep) k |= q == p;
      p->ref = k;
    }
  }
  dpb.erase(std::remove_if(dpb.begin(), dpb.end(), [](const PicP& p) { return !p->ref && !p->output; }),
            dpb.end());
  cur = std::make_shared<Pic>();
  cur->alloc(W, H, bd);
  for (int i = 0; i < 4; ++i) cur->crop[i] = s->crop[i];
  cur->poc = poc;
  cur->output = sh.pic_output;
  first_pic = false;
  after_eos = false;
}

void Decoder::layout_tiles() {
  // the column widths and row heights (6.5.1), then the scans and
  // MinTbAddrZs (6.5.2), rederived only where they change
  const SPS* s = sps;
  std::vector<int> cols, rows;
  auto spacing = [](int n, int total, const std::vector<int>& given, std::vector<int>& out, const char* what) {
    if (n > total) corrupt(std::string("more tile ") + what + " than CTB " + what);
    if (given.empty()) {
      for (int i = 0; i < n; ++i) out.push_back((i + 1) * total / n - i * total / n);
      return;
    }
    int sum = 0;
    for (int v : given) {
      sum += v;
      out.push_back(v);
    }
    if (sum >= total) corrupt(std::string("tile ") + what + " past the picture");
    out.push_back(total - sum);
  };
  spacing(pps->tile_cols, s->ctb_w, pps->col_w, cols, "columns");
  spacing(pps->tile_rows, s->ctb_h, pps->row_h, rows, "rows");
  std::vector<int32_t> key = {W, H, s->log2_ctb};
  key.insert(key.end(), cols.begin(), cols.end());
  key.push_back(-1);
  key.insert(key.end(), rows.begin(), rows.end());
  if (key == layout) return;
  layout = key;
  int n = s->ctb_w * s->ctb_h;
  rs2ts.assign(n, 0);
  ts2rs.assign(n, 0);
  tile_id.assign(n, 0);
  int ts = 0, tile = 0;
  for (int j = 0, y0 = 0; j < (int)rows.size(); y0 += rows[j++])
    for (int i = 0, x0 = 0; i < (int)cols.size(); x0 += cols[i++], ++tile) {
      for (int y = y0; y < y0 + rows[j]; ++y)
        for (int x = x0; x < x0 + cols[i]; ++x) {
          int rs = y * s->ctb_w + x;
          rs2ts[rs] = ts;
          ts2rs[ts++] = rs;
          tile_id[rs] = tile;
        }
    }
  // MinTbAddrZs of the 4x4 units: the CTB's tile-scan address, then the
  // interleaved bits of the position inside it
  zs.assign((size_t)w4 * h4, 0);
  int lc = s->log2_ctb - 2;
  for (int y = 0; y < h4; ++y)
    for (int x = 0; x < w4; ++x) {
      int ctb = rs2ts[(y >> lc) * s->ctb_w + (x >> lc)];
      int xi = x & ((1 << lc) - 1), yi = y & ((1 << lc) - 1), z = 0;
      for (int k = 0; k < lc; ++k) z |= ((xi >> k) & 1) << (2 * k) | ((yi >> k) & 1) << (2 * k + 1);
      zs[(size_t)y * w4 + x] = (ctb << (2 * lc)) + z;
    }
}

void Decoder::end_picture() {
  if (!cur) {
    skipping = false;
    return;
  }
  for (size_t i = 0; i < ctb_slice.size(); ++i)
    if (ctb_slice[i] < 0) corrupt("a picture with CTBs in no slice");
  deblock();
  if (sps->sao) apply_sao();
  cur->ref = true;
  dpb.push_back(cur);
  cur.reset();
  bump(false, false);
}

void Decoder::flush() {
  end_picture();
  if (sps) bump(true, false);
  dpb.clear();
}

// ── CABAC (9.3) ──────────────────────────────────────────────────────────

void Decoder::init_contexts() {
  int init_type = sh.type == 2 ? 0 : sh.type == 1 ? (sh.cabac_init ? 2 : 1) : (sh.cabac_init ? 1 : 2);
  int qp = clip3(0, 51, sh.qp);
  for (int i = 0; i < N_CTX; ++i) {
    int v = CABAC_INIT[init_type][i];
    int m = (v >> 4) * 5 - 45, n = ((v & 15) << 3) - 16;
    int pre = clip3(1, 126, ((m * qp) >> 4) + n);
    ctx[i] = pre <= 63 ? (uint8_t)((63 - pre) << 1) : (uint8_t)(((pre - 64) << 1) | 1);
  }
}

void Decoder::init_engine() {
  range = 510;
  offset = 0;
  for (int i = 0; i < 9; ++i) offset = offset << 1 | bs.bit();
  if (offset >= 510) corrupt("a CABAC offset of 510 or 511");
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

// ── slice data (7.3.8.1) ─────────────────────────────────────────────────

void Decoder::slice_data() {
  const SPS* s = sps;
  int n_ctb = s->ctb_w * s->ctb_h;
  if (ctb_slice[sh.address] >= 0) corrupt("a slice segment over CTBs already decoded");
  if (!sh.dependent) sh.slice_addr = sh.address;
  SliceInfo si;
  si.addr = sh.slice_addr;
  si.deblock_disabled = sh.deblock_disabled;
  si.lf_across = sh.lf_across;
  si.beta_offset = sh.beta_offset;
  si.tc_offset = sh.tc_offset;
  si.sao_luma = sh.sao_luma;
  si.sao_chroma = sh.sao_chroma;
  slices.push_back(si);
  slice_idx = (int)slices.size() - 1;
  if (slices.size() > 32000) corrupt("too many slice segments");
  int ts = rs2ts[sh.address];
  if (sh.dependent) {
    // it continues the slice of the CTB before it in tile scan
    int prev = ts2rs[ts - 1];
    if (ctb_slice[prev] < 0 || slices[ctb_slice[prev]].addr != sh.slice_addr)
      corrupt("a dependent slice segment that does not continue its slice");
  }
  // the reference picture lists (8.3.4): short-term before, after, then
  // long-term, repeated to the longer of num_ref_idx and NumPicTotalCurr
  if (sh.type != 2) {
    int total = (int)(st_before.size() + st_after.size() + lt_curr.size());
    if (total == 0) corrupt("a P or B slice with no reference picture");
    for (int l = 0; l < (sh.type == 0 ? 2 : 1); ++l) {
      std::vector<PicP> temp;
      std::vector<bool> temp_lt;
      int n = std::max(sh.num_ref_idx[l], total);
      while ((int)temp.size() < n) {
        const auto& a = l == 0 ? st_before : st_after;
        const auto& c = l == 0 ? st_after : st_before;
        const std::vector<PicP>* sets[3] = {&a, &c, &lt_curr};
        for (const auto* set : sets)
          for (auto& p : *set)
            if ((int)temp.size() < n) {
              temp.push_back(p);
              temp_lt.push_back(set == &lt_curr);
            }
      }
      for (int i = 0; i < sh.num_ref_idx[l]; ++i) {
        int k = sh.list_mod[l] ? sh.list_entry[l][i] : i;
        ref_list[l][i] = temp[k];
        ref_lt[l][i] = temp_lt[k];
        ref_poc[l][i] = ref_list[l][i]->poc;
        if (ref_list[l][i]->w != W || ref_list[l][i]->h != H || ref_list[l][i]->bd != bd)
          corrupt("a reference picture of another size or bit depth");
      }
    }
  }
  init_engine();
  int W_ctb = s->ctb_w;
  ctb_addr = sh.address;
  // context initialisation (9.3.1): at a tile's first CTB, else at a CTB
  // row's first with WPP (never with tiles) from the CTB above and to the
  // right, if it is in the slice
  auto wpp_sync = [&](int addr) {
    int up_right = addr - W_ctb + 1;
    if (W_ctb > 1 && addr >= W_ctb && ctb_slice[up_right] >= 0 &&
        slices[ctb_slice[up_right]].addr == sh.slice_addr && wpp_saved)
      memcpy(ctx, wpp_ctx, N_CTX);
    else
      init_contexts();
  };
  if (!sh.dependent || first_in_tile(ts)) {
    init_contexts();
  } else if (pps->entropy_sync && ctb_addr % W_ctb == 0) {
    wpp_sync(ctb_addr);
  } else {
    memcpy(ctx, ds_ctx, N_CTX);
  }
  if (!sh.dependent) {
    first_qg_in_slice = true;
    last_qp_y = sh.qp;
  }
  qp_y = sh.qp;
  for (;;) {
    if (ts >= n_ctb) corrupt("CTBs beyond the picture");
    ctb_addr = ts2rs[ts];
    int rx = ctb_addr % W_ctb, ry = ctb_addr / W_ctb;
    if (ctb_slice[ctb_addr] >= 0) corrupt("a CTB decoded twice");
    ctb_slice[ctb_addr] = (int16_t)slice_idx;
    if (first_in_tile(ts) || (pps->entropy_sync && rx == 0)) {
      last_qp_y = sh.qp;               // the first QG of a tile or a CTB row takes SliceQpY
      first_qg_in_slice = true;
    }
    if (sh.sao_luma || sh.sao_chroma) sao_syntax(rx, ry);
    coding_quadtree(rx << s->log2_ctb, ry << s->log2_ctb, s->log2_ctb, 0);
    bool end = terminate();
    if (pps->entropy_sync && rx == 1) {
      memcpy(wpp_ctx, ctx, N_CTX);
      wpp_saved = true;
    }
    ++ts;
    if (end) break;
    if (ts >= n_ctb) corrupt("CTBs beyond the picture");
    int next = ts2rs[ts];
    bool tile_start = first_in_tile(ts);
    if (tile_start || (pps->entropy_sync && next % W_ctb == 0)) {
      if (!terminate()) corrupt("end_of_subset_one_bit is 0");
      bs.pos = (bs.pos + 7) & ~(size_t)7;
      init_engine();
      if (tile_start) init_contexts();
      else wpp_sync(next);
    }
  }
  if (pps->dependent_slices) memcpy(ds_ctx, ctx, N_CTX);
}

// ── SAO syntax (7.3.8.3) ─────────────────────────────────────────────────

void Decoder::sao_syntax(int rx, int ry) {
  int W_ctb = sps->ctb_w;
  SaoParams& p = sao[ctb_addr];
  // the candidate in the slice segment's slice (by raster address, as
  // 7.3.8.3 writes it) and in the tile
  if (rx > 0 && ctb_addr - 1 >= sh.slice_addr && tile_id[ctb_addr - 1] == tile_id[ctb_addr] &&
      dec(C_SAO_MERGE)) {
    p = sao[ctb_addr - 1];
    return;
  }
  if (ry > 0 && ctb_addr - W_ctb >= sh.slice_addr && tile_id[ctb_addr - W_ctb] == tile_id[ctb_addr] &&
      dec(C_SAO_MERGE)) {
    p = sao[ctb_addr - W_ctb];
    return;
  }
  for (int c = 0; c < 3; ++c) {
    if ((c == 0 && !sh.sao_luma) || (c > 0 && !sh.sao_chroma)) {
      p.type[c] = 0;
      continue;
    }
    if (c == 2) {
      p.type[2] = p.type[1];
      p.eo_class[2] = p.eo_class[1];
    } else {
      int t = 0;
      if (dec(C_SAO_TYPE)) t = bypass() ? 2 : 1;
      p.type[c] = (uint8_t)t;
    }
    if (p.type[c] == 0) continue;
    int abs_[4], cmax = (1 << (std::min(bd, 10) - 5)) - 1;
    for (int i = 0; i < 4; ++i) {
      int v = 0;
      while (v < cmax && bypass()) ++v;
      abs_[i] = v;
    }
    p.offset[c][0] = 0;
    if (p.type[c] == 1) {
      for (int i = 0; i < 4; ++i) {
        int sgn = abs_[i] && bypass();
        p.offset[c][i + 1] = (int8_t)(sgn ? -abs_[i] : abs_[i]);
      }
      p.band_pos[c] = (uint8_t)bypass_bits(5);
    } else {
      p.offset[c][1] = (int8_t)abs_[0];
      p.offset[c][2] = (int8_t)abs_[1];
      p.offset[c][3] = (int8_t)-abs_[2];
      p.offset[c][4] = (int8_t)-abs_[3];
      if (c == 0) p.eo_class[0] = (uint8_t)bypass_bits(2);
      if (c == 1) p.eo_class[1] = (uint8_t)bypass_bits(2);
    }
  }
}

// ── availability (6.4) ───────────────────────────────────────────────────

bool Decoder::avail_z(int xc, int yc, int xn, int yn) const {
  if (!in_pic(xn, yn)) return false;
  if (zs[u4(xn, yn)] > zs[u4(xc, yc)]) return false;
  int an = ctb_of(xn, yn), ac = ctb_of(xc, yc);
  int cn = ctb_slice[an], cc = ctb_slice[ac];
  if (cn < 0) return false;
  return slices[cn].addr == slices[cc].addr && tile_id[an] == tile_id[ac];
}

// ── coding quadtree and unit (7.3.8.4, 7.3.8.5) ──────────────────────────

void Decoder::set_qp_group(int x0, int y0) {
  // the prediction of QpY for the quantization group at (x0, y0) (8.6.1)
  int prev = first_qg_in_slice ? sh.qp : last_qp_y;
  first_qg_in_slice = false;
  int ctb = ctb_of(x0, y0);
  int qa = prev, qb = prev;
  if (avail_z(x0, y0, x0 - 1, y0) && ctb_of(x0 - 1, y0) == ctb) qa = qp_map[u4(x0 - 1, y0)];
  if (avail_z(x0, y0, x0, y0 - 1) && ctb_of(x0, y0 - 1) == ctb) qb = qp_map[u4(x0, y0 - 1)];
  qp_y_pred = (qa + qb + 1) >> 1;
  cu_qp_delta_coded = false;
  cu_qp_delta_val = 0;
}

void Decoder::coding_quadtree(int x0, int y0, int log2, int depth) {
  const SPS* s = sps;
  int size = 1 << log2;
  bool split;
  if (x0 + size <= W && y0 + size <= H && log2 > s->log2_min_cb) {
    int inc = 0;
    if (avail_z(x0, y0, x0 - 1, y0) && ct_depth[u4(x0 - 1, y0)] > depth) ++inc;
    if (avail_z(x0, y0, x0, y0 - 1) && ct_depth[u4(x0, y0 - 1)] > depth) ++inc;
    split = dec(C_SPLIT_CU + inc);
  } else {
    split = log2 > s->log2_min_cb;
  }
  int log2_qg = s->log2_ctb - pps->diff_cu_qp_delta_depth;
  if (pps->cu_qp_delta && log2 >= log2_qg) set_qp_group(x0, y0);
  if (split) {
    int h = size >> 1;
    coding_quadtree(x0, y0, log2 - 1, depth + 1);
    if (x0 + h < W) coding_quadtree(x0 + h, y0, log2 - 1, depth + 1);
    if (y0 + h < H) coding_quadtree(x0, y0 + h, log2 - 1, depth + 1);
    if (x0 + h < W && y0 + h < H) coding_quadtree(x0 + h, y0 + h, log2 - 1, depth + 1);
  } else {
    // the CU's depth first: its own context reads (inter_pred_idc) use it
    int n = size >> 2;
    for (int j = 0; j < n; ++j)
      memset(&ct_depth[u4(x0, y0 + 4 * j)], depth, n);
    coding_unit(x0, y0, log2);
  }
}

template <class E, class V>
static inline void fill4(std::vector<E>& m, int w4, int x0, int y0, int w, int h, V v) {
  static_assert(sizeof(E) == 1, "a map of bytes");
  for (int j = 0; j < (h >> 2); ++j) memset(&m[(size_t)((y0 >> 2) + j) * w4 + (x0 >> 2)], (E)v, w >> 2);
}

void Decoder::coding_unit(int x0, int y0, int log2) {
  const SPS* s = sps;
  int size = 1 << log2;
  cu_x = x0;
  cu_y = y0;
  cu_log2 = log2;
  cu_skip = false;
  cu_intra = sh.type == 2;
  part_mode = PART_2Nx2N;
  merge_flag_cu = false;
  qp_y = pps->cu_qp_delta ? luma_qp() : sh.qp;
  cu_bypass = pps->transquant_bypass && dec(C_TRANSQUANT_BYPASS);
  // deblocking and SAO leave a bypass CU's samples as they are
  if (cu_bypass) fill4(no_filter, w4, x0, y0, size, size, 1);
  if (sh.type != 2) {
    int inc = 0;
    if (avail_z(x0, y0, x0 - 1, y0) && skip_flag[u4(x0 - 1, y0)]) ++inc;
    if (avail_z(x0, y0, x0, y0 - 1) && skip_flag[u4(x0, y0 - 1)]) ++inc;
    cu_skip = dec(C_SKIP + inc);
  }
  fill4(skip_flag, w4, x0, y0, size, size, cu_skip);
  // the CU's edges are transform block edges (8.7.2.3)
  for (int j = 0; j < (size >> 2); ++j) {
    edge_v[u4(x0, y0 + 4 * j)] |= 1;
    edge_h[u4(x0 + 4 * j, y0)] |= 1;
  }
  fill4(cbf_map, w4, x0, y0, size, size, 0);
  if (cu_skip) {
    fill4(intra, w4, x0, y0, size, size, 0);
    prediction_unit(x0, y0, size, size, 0);
  } else {
    if (sh.type != 2) cu_intra = dec(C_PRED_MODE);
    fill4(intra, w4, x0, y0, size, size, cu_intra);
    if (!cu_intra || log2 == s->log2_min_cb) {
      // part_mode (9.3.3.7)
      if (dec(C_PART_MODE)) {
        part_mode = PART_2Nx2N;
      } else if (cu_intra) {
        part_mode = PART_NxN;
      } else if (log2 == s->log2_min_cb) {
        if (dec(C_PART_MODE + 1)) part_mode = PART_2NxN;
        else if (log2 == 3) part_mode = PART_Nx2N;
        else part_mode = dec(C_PART_MODE + 2) ? PART_Nx2N : PART_NxN;
      } else if (!s->amp) {
        part_mode = dec(C_PART_MODE + 1) ? PART_2NxN : PART_Nx2N;
      } else if (dec(C_PART_MODE + 1)) {
        part_mode = dec(C_PART_MODE + 3) ? PART_2NxN : (bypass() ? PART_2NxnD : PART_2NxnU);
      } else {
        part_mode = dec(C_PART_MODE + 3) ? PART_Nx2N : (bypass() ? PART_nRx2N : PART_nLx2N);
      }
    }
    bool pcm = false;
    if (cu_intra && part_mode == PART_2Nx2N && s->pcm_bd && log2 >= s->log2_min_pcm && log2 <= s->log2_max_pcm)
      pcm = terminate();                                  // pcm_flag
    if (pcm) {
      // the samples themselves (7.3.8.7), after the arithmetic code's flush
      // and pcm_alignment_zero_bits; then the engine starts again (9.3.2.5)
      bs.pos = (bs.pos + 7) & ~(size_t)7;
      wide ? pcm_sample_t<uint16_t>(x0, y0, log2) : pcm_sample_t<uint8_t>(x0, y0, log2);
      init_engine();
      fill4(ipm, w4, x0, y0, size, size, 1);               // INTRA_DC to its neighbours' MPMs
      if (s->pcm_lf_disabled) fill4(no_filter, w4, x0, y0, size, size, 1);
    } else if (cu_intra) {
      int nparts = part_mode == PART_NxN ? 4 : 1, pb = part_mode == PART_NxN ? size / 2 : size;
      int prev_flag[4], mode[4];
      for (int i = 0; i < nparts; ++i) prev_flag[i] = dec(C_PREV_INTRA_LUMA);
      for (int i = 0; i < nparts; ++i) {
        int xp = x0 + (i & 1) * pb, yp = y0 + (i >> 1) * pb;
        // candidates (8.4.2)
        int ca = 1, cb = 1;
        if (avail_z(xp, yp, xp - 1, yp) && intra[u4(xp - 1, yp)]) ca = ipm[u4(xp - 1, yp)];
        if (avail_z(xp, yp, xp, yp - 1) && intra[u4(xp, yp - 1)] &&
            yp - 1 >= ((yp >> s->log2_ctb) << s->log2_ctb))
          cb = ipm[u4(xp, yp - 1)];
        int cand[3];
        if (ca == cb) {
          if (ca < 2) {
            cand[0] = 0;
            cand[1] = 1;
            cand[2] = 26;
          } else {
            cand[0] = ca;
            cand[1] = 2 + ((ca + 29) % 32);
            cand[2] = 2 + ((ca - 2 + 1) % 32);
          }
        } else {
          cand[0] = ca;
          cand[1] = cb;
          cand[2] = (ca != 0 && cb != 0) ? 0 : (ca != 1 && cb != 1) ? 1 : 26;
        }
        int m;
        if (prev_flag[i]) {
          int idx = 0;
          if (bypass()) idx = bypass() ? 2 : 1;
          m = cand[idx];
        } else {
          m = bypass_bits(5);
          if (cand[0] > cand[1]) std::swap(cand[0], cand[1]);
          if (cand[0] > cand[2]) std::swap(cand[0], cand[2]);
          if (cand[1] > cand[2]) std::swap(cand[1], cand[2]);
          for (int k = 0; k < 3; ++k)
            if (m >= cand[k]) ++m;
        }
        mode[i] = m;
        fill4(ipm, w4, xp, yp, pb, pb, (uint8_t)m);
      }
      // intra_chroma_pred_mode (4:2:0: one for the CU)
      int cm = 4;
      if (dec(C_CHROMA_PRED)) cm = bypass_bits(2);
      int luma = mode[0];
      if (cm == 4) {
        chroma_mode = luma;
      } else {
        static const int modes[4] = {0, 26, 10, 1};
        chroma_mode = modes[cm] == luma ? 34 : modes[cm];
      }
    } else {
      int h = size / 2, q = size / 4;
      switch (part_mode) {
        case PART_2Nx2N: prediction_unit(x0, y0, size, size, 0); break;
        case PART_2NxN:
          prediction_unit(x0, y0, size, h, 0);
          prediction_unit(x0, y0 + h, size, h, 1);
          break;
        case PART_Nx2N:
          prediction_unit(x0, y0, h, size, 0);
          prediction_unit(x0 + h, y0, h, size, 1);
          break;
        case PART_2NxnU:
          prediction_unit(x0, y0, size, q, 0);
          prediction_unit(x0, y0 + q, size, size - q, 1);
          break;
        case PART_2NxnD:
          prediction_unit(x0, y0, size, size - q, 0);
          prediction_unit(x0, y0 + size - q, size, q, 1);
          break;
        case PART_nLx2N:
          prediction_unit(x0, y0, q, size, 0);
          prediction_unit(x0 + q, y0, size - q, size, 1);
          break;
        case PART_nRx2N:
          prediction_unit(x0, y0, size - q, size, 0);
          prediction_unit(x0 + size - q, y0, q, size, 1);
          break;
        default:
          prediction_unit(x0, y0, h, h, 0);
          prediction_unit(x0 + h, y0, h, h, 1);
          prediction_unit(x0, y0 + h, h, h, 2);
          prediction_unit(x0 + h, y0 + h, h, h, 3);
      }
    }
    bool root_cbf = !pcm;
    if (!cu_intra && !(part_mode == PART_2Nx2N && merge_flag_cu)) root_cbf = dec(C_RQT_ROOT_CBF);
    if (root_cbf) {
      bool intra_split = cu_intra && part_mode == PART_NxN;
      int max_depth = cu_intra ? s->max_th_depth_intra + intra_split : s->max_th_depth_inter;
      transform_tree(x0, y0, x0, y0, log2, 0, 0, false, false, max_depth, intra_split);
    } else if (cu_intra && !pcm) {
      corrupt("an intra CU with no transform tree");
    }
  }
  if (cu_intra) {
    MvField none{};
    store_pu(x0, y0, size, size, none);
  }
  fill4(qp_map, w4, x0, y0, size, size, (int8_t)qp_y);
  last_qp_y = qp_y;
}

template <class T>
void Decoder::pcm_sample_t(int x0, int y0, int log2) {
  const SPS* s = sps;
  for (int c = 0; c < 3; ++c) {
    int n = c ? 1 << (log2 - 1) : 1 << log2, pw = c ? W >> 1 : W;
    int depth = c ? s->pcm_bd_c : s->pcm_bd, up = (c ? s->bit_depth_c : s->bit_depth) - depth;
    T* dst = cur->plane<T>(c) + (size_t)(c ? y0 >> 1 : y0) * pw + (c ? x0 >> 1 : x0);
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x) dst[(size_t)y * pw + x] = (T)(bs.u(depth) << up);
  }
}

// ── inter prediction units (7.3.8.6, 8.5.3) ──────────────────────────────

void Decoder::prediction_unit(int x0, int y0, int w, int h, int part_idx) {
  MvField m{};
  m.ref_idx[0] = m.ref_idx[1] = -1;
  int size = 1 << cu_log2;
  bool merge = cu_skip;
  if (!cu_skip) merge = dec(C_MERGE_FLAG);
  if (part_idx == 0) merge_flag_cu = merge;
  // the PU's edges (8.7.2.3: prediction block edges)
  for (int j = 0; j < (h >> 2); ++j) edge_v[u4(x0, y0 + 4 * j)] |= 2;
  for (int i = 0; i < (w >> 2); ++i) edge_h[u4(x0 + 4 * i, y0)] |= 2;
  if (merge) {
    int idx = 0;
    if (sh.max_merge > 1 && dec(C_MERGE_IDX)) {
      idx = 1;
      while (idx < sh.max_merge - 1 && bypass()) ++idx;
    }
    derive_merge(cu_x, cu_y, size, x0, y0, w, h, part_idx, idx, m);
  } else {
    int idc = 0;                        // 0 L0, 1 L1, 2 BI
    if (sh.type == 0) {
      if (w + h != 12) {
        int depth = ct_depth[u4(x0, y0)];
        if (dec(C_INTER_PRED_IDC + depth)) idc = 2;
        else idc = dec(C_INTER_PRED_IDC + 4);
      } else {
        idc = dec(C_INTER_PRED_IDC + 4);
      }
    }
    int16_t mvd[2][2] = {{0, 0}, {0, 0}};
    int ref[2] = {-1, -1}, mvp_flag[2] = {0, 0};
    for (int l = 0; l < 2; ++l) {
      if ((l == 0 && idc == 1) || (l == 1 && idc == 0)) continue;
      int r = 0, n = sh.num_ref_idx[l];
      if (n > 1) {
        while (r < n - 1) {          // both lists share ref_idx's contexts
          int bin = r < 2 ? dec(C_REF_IDX_L0 + r) : bypass();
          if (!bin) break;
          ++r;
        }
      }
      ref[l] = r;
      if (l == 1 && sh.mvd_l1_zero && idc == 2) {
        mvd[1][0] = mvd[1][1] = 0;
      } else {
        // mvd_coding (7.3.8.9)
        int g0x = dec(C_MVD_GREATER0), g0y = dec(C_MVD_GREATER0);
        // abs_mvd_greater1_flag: the second of the mvd contexts (FFmpeg's offset + 1)
        int g1x = g0x ? dec(C_MVD_GREATER1 + 1) : 0, g1y = g0y ? dec(C_MVD_GREATER1 + 1) : 0;
        int v[2] = {0, 0};
        int g0[2] = {g0x, g0y}, g1[2] = {g1x, g1y};
        for (int c = 0; c < 2; ++c) {
          if (!g0[c]) continue;
          int a = 1;
          if (g1[c]) {
            // abs_mvd_minus2: EG1
            int k = 1, val = 0;
            while (bypass()) {
              val += 1 << k;
              if (++k > 30) corrupt("abs_mvd_minus2 too long");
            }
            val += bypass_bits(k);
            a = val + 2;
            if (a > 32768) corrupt("an mvd out of range");
          }
          v[c] = bypass() ? -a : a;
        }
        mvd[l][0] = (int16_t)clip3(-32768, 32767, v[0]);
        mvd[l][1] = (int16_t)clip3(-32768, 32767, v[1]);
      }
      mvp_flag[l] = dec(C_MVP_FLAG);
    }
    for (int l = 0; l < 2; ++l) {
      if (ref[l] < 0) continue;
      int16_t mvp[2];
      derive_amvp(cu_x, cu_y, size, x0, y0, w, h, part_idx, l, ref[l], mvp, mvp_flag[l]);
      m.pred |= 1 << l;
      m.lt |= ref_lt[l][ref[l]] << l;
      m.ref_idx[l] = (int8_t)ref[l];
      m.mv[l][0] = (int16_t)(uint16_t)(mvp[0] + mvd[l][0]);
      m.mv[l][1] = (int16_t)(uint16_t)(mvp[1] + mvd[l][1]);
      m.ref_poc[l] = ref_poc[l][ref[l]];
    }
  }
  store_pu(x0, y0, w, h, m);
  motion_compensate(x0, y0, w, h, m);
}

void Decoder::store_pu(int xp, int yp, int w, int h, const MvField& m) {
  for (int j = 0; j < (h >> 2); ++j)
    for (int i = 0; i < (w >> 2); ++i) cur->mvf[u4(xp + 4 * i, yp + 4 * j)] = m;
}

bool Decoder::pb_avail(int xc, int yc, int ncb, int xp, int yp, int w, int h, int part_idx, int xn,
                       int yn) const {
  // 6.4.2
  bool same_cb = xc <= xn && yc <= yn && xc + ncb > xn && yc + ncb > yn;
  bool a;
  if (!same_cb) {
    a = avail_z(xp, yp, xn, yn);
  } else {
    a = !((w << 1) == ncb && (h << 1) == ncb && part_idx == 1 && yc + h <= yn && xc + w > xn);
  }
  if (a && intra[u4(xn, yn)]) a = false;
  return a;
}

static inline bool same_motion(const MvField& a, const MvField& b) {
  if (a.pred != b.pred) return false;
  for (int l = 0; l < 2; ++l)
    if (a.pred & (1 << l))
      if (a.ref_idx[l] != b.ref_idx[l] || a.mv[l][0] != b.mv[l][0] || a.mv[l][1] != b.mv[l][1])
        return false;
  return true;
}

static inline int16_t scale_mv(int mv, int td, int tb) {
  td = clip3(-128, 127, td);
  tb = clip3(-128, 127, tb);
  int tx = (16384 + (std::abs(td) >> 1)) / td;
  int dsf = clip3(-4096, 4095, (tb * tx + 32) >> 6);
  int p = dsf * mv;
  return (int16_t)clip3(-32768, 32767, sign(p) * ((std::abs(p) + 127) >> 8));
}

bool Decoder::col_mv(int x, int y, int lx, int ref_idx, int16_t mv[2]) {
  // 8.5.3.2.9 at the collocated picture's 16x16-compressed motion
  const PicP& col = ref_list[sh.type == 0 && !sh.col_from_l0 ? 1 : 0][sh.col_ref_idx];
  x = (x >> 4) << 4;
  y = (y >> 4) << 4;
  const MvField& c = col->mvf[(size_t)(y >> 2) * col->w4 + (x >> 2)];
  if (!c.pred) return false;
  int list_col;
  if (!(c.pred & 1)) {
    list_col = 1;
  } else if (!(c.pred & 2)) {
    list_col = 0;
  } else {
    // NoBackwardPredFlag: no reference picture of the slice follows the current one
    bool no_backward = true;
    for (int l = 0; l < (sh.type == 0 ? 2 : 1); ++l)
      for (int i = 0; i < sh.num_ref_idx[l]; ++i)
        if (ref_poc[l][i] > cur->poc) no_backward = false;
    list_col = no_backward ? lx : (sh.col_from_l0 ? 1 : 0);
  }
  // a long-term reference on one side alone: no candidate; on both: no scaling
  bool cur_lt = ref_lt[lx][ref_idx];
  if (cur_lt != (bool)((c.lt >> list_col) & 1)) return false;
  int col_poc_diff = col->poc - c.ref_poc[list_col];
  int cur_poc_diff = cur->poc - ref_poc[lx][ref_idx];
  int mx = c.mv[list_col][0], my = c.mv[list_col][1];
  if (cur_lt || col_poc_diff == cur_poc_diff || col_poc_diff == 0) {
    mv[0] = (int16_t)mx;
    mv[1] = (int16_t)my;
  } else {
    mv[0] = scale_mv(mx, col_poc_diff, cur_poc_diff);
    mv[1] = scale_mv(my, col_poc_diff, cur_poc_diff);
  }
  return true;
}

bool Decoder::temporal_mv(int xp, int yp, int w, int h, int lx, int ref_idx, int16_t mv[2]) {
  if (!sh.tmvp) return false;
  int xb = xp + w, yb = yp + h;
  if ((yp >> sps->log2_ctb) == (yb >> sps->log2_ctb) && yb < H && xb < W)
    if (col_mv(xb, yb, lx, ref_idx, mv)) return true;
  return col_mv(xp + (w >> 1), yp + (h >> 1), lx, ref_idx, mv);
}

void Decoder::derive_merge(int xc, int yc, int ncb, int xp, int yp, int w, int h, int part_idx,
                           int idx, MvField& out) {
  int ow = w, oh = h;
  int pml = pps->log2_parallel_merge;
  if (pml > 2 && ncb == 8) {
    xp = xc;
    yp = yc;
    w = h = ncb;
    part_idx = 0;
  }
  MvField cand[5];
  int n = 0;
  auto fetch = [&](int xn, int yn, MvField& m) -> bool {
    if ((xp >> pml) == (xn >> pml) && (yp >> pml) == (yn >> pml)) return false;
    if (!pb_avail(xc, yc, ncb, xp, yp, w, h, part_idx, xn, yn)) return false;
    m = cur->mvf[u4(xn, yn)];
    return true;
  };
  // the neighbours' availability (after the partition rules) decides the
  // pruning comparisons; a pruned candidate stays available for them
  MvField a1, b1, b0, a0, b2;
  bool ha1 = fetch(xp - 1, yp + h - 1, a1);
  if (ha1 && (part_mode == PART_Nx2N || part_mode == PART_nLx2N || part_mode == PART_nRx2N) &&
      part_idx == 1)
    ha1 = false;
  if (ha1) cand[n++] = a1;
  bool hb1 = fetch(xp + w - 1, yp - 1, b1);
  if (hb1 && (part_mode == PART_2NxN || part_mode == PART_2NxnU || part_mode == PART_2NxnD) &&
      part_idx == 1)
    hb1 = false;
  if (hb1 && !(ha1 && same_motion(a1, b1))) cand[n++] = b1;
  bool hb0 = fetch(xp + w, yp - 1, b0);
  if (hb0 && !(hb1 && same_motion(b1, b0))) cand[n++] = b0;
  bool ha0 = fetch(xp - 1, yp + h, a0);
  if (ha0 && !(ha1 && same_motion(a1, a0))) cand[n++] = a0;
  if (n < 4) {
    bool hb2 = fetch(xp - 1, yp - 1, b2);
    if (hb2 && !(ha1 && same_motion(a1, b2)) && !(hb1 && same_motion(b1, b2))) cand[n++] = b2;
  }
  MvField list[5];
  int count = 0;
  for (int i = 0; i < n && count < sh.max_merge; ++i) list[count++] = cand[i];
  if (count == idx + 1) {
    out = list[idx];
  } else {
    // temporal
    if (count < sh.max_merge && sh.tmvp) {
      MvField t{};
      t.ref_idx[0] = t.ref_idx[1] = -1;
      int16_t mv[2];
      if (temporal_mv(xp, yp, w, h, 0, 0, mv)) {
        t.pred |= 1;
        t.lt |= ref_lt[0][0];
        t.ref_idx[0] = 0;
        t.mv[0][0] = mv[0];
        t.mv[0][1] = mv[1];
        t.ref_poc[0] = ref_poc[0][0];
      }
      if (sh.type == 0 && temporal_mv(xp, yp, w, h, 1, 0, mv)) {
        t.pred |= 2;
        t.lt |= ref_lt[1][0] << 1;
        t.ref_idx[1] = 0;
        t.mv[1][0] = mv[0];
        t.mv[1][1] = mv[1];
        t.ref_poc[1] = ref_poc[1][0];
      }
      if (t.pred) list[count++] = t;
    }
    // combined bi-predictive (B slices)
    int n_orig = count;
    if (sh.type == 0 && n_orig > 1 && n_orig < sh.max_merge) {
      static const int l0i[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
      static const int l1i[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
      for (int k = 0; k < n_orig * (n_orig - 1) && count < sh.max_merge; ++k) {
        const MvField& c0 = list[l0i[k]];
        const MvField& c1 = list[l1i[k]];
        if ((c0.pred & 1) && (c1.pred & 2) &&
            (c0.ref_poc[0] != c1.ref_poc[1] || c0.mv[0][0] != c1.mv[1][0] || c0.mv[0][1] != c1.mv[1][1])) {
          MvField c{};
          c.pred = 3;
          c.lt = (c0.lt & 1) | (c1.lt & 2);
          c.ref_idx[0] = c0.ref_idx[0];
          c.ref_idx[1] = c1.ref_idx[1];
          c.mv[0][0] = c0.mv[0][0];
          c.mv[0][1] = c0.mv[0][1];
          c.mv[1][0] = c1.mv[1][0];
          c.mv[1][1] = c1.mv[1][1];
          c.ref_poc[0] = c0.ref_poc[0];
          c.ref_poc[1] = c1.ref_poc[1];
          list[count++] = c;
        }
      }
    }
    // zero candidates
    int num_ref = sh.type == 1 ? sh.num_ref_idx[0] : std::min(sh.num_ref_idx[0], sh.num_ref_idx[1]);
    int zero = 0;
    while (count < sh.max_merge) {
      MvField z{};
      int r = zero < num_ref ? zero : 0;
      z.pred = sh.type == 1 ? 1 : 3;
      z.lt = ref_lt[0][r] | (sh.type == 1 ? 0 : ref_lt[1][r] << 1);
      z.ref_idx[0] = (int8_t)r;
      z.ref_poc[0] = ref_poc[0][r];
      z.ref_idx[1] = sh.type == 1 ? -1 : (int8_t)r;
      if (sh.type == 0) z.ref_poc[1] = ref_poc[1][r];
      list[count++] = z;
      ++zero;
    }
    out = list[idx];
  }
  if (out.pred == 3 && ow + oh == 12) {
    out.pred = 1;
    out.lt &= 1;
    out.ref_idx[1] = -1;
    out.mv[1][0] = out.mv[1][1] = 0;
  }
  out.lt &= out.pred;
  if (!(out.pred & 1)) {
    out.ref_idx[0] = -1;
    out.mv[0][0] = out.mv[0][1] = 0;
  }
  if (!(out.pred & 2)) {
    out.ref_idx[1] = -1;
    out.mv[1][0] = out.mv[1][1] = 0;
  }
}

void Decoder::derive_amvp(int xc, int yc, int ncb, int xp, int yp, int w, int h, int part_idx,
                          int lx, int ref_idx, int16_t mvp[2], int flag) {
  int ly = 1 - lx;
  int target = ref_poc[lx][ref_idx];
  int target_lt = ref_lt[lx][ref_idx];
  // the scaled passes take a neighbour's vector whose reference is long-term
  // as the target is, scaled only between short-term ones (8.5.3.2.7)
  auto scaled_list = [&](const MvField& m) {
    return (m.pred & (1 << lx)) && ((m.lt >> lx) & 1) == target_lt ? lx
           : (m.pred & (1 << ly)) && ((m.lt >> ly) & 1) == target_lt ? ly : -1;
  };
  int cur_poc = cur->poc;
  int16_t mva[2] = {0, 0}, mvb[2] = {0, 0};
  bool fa = false, fb = false;
  int xa[2] = {xp - 1, xp - 1}, ya[2] = {yp + h, yp + h - 1};
  bool av_a[2];
  for (int k = 0; k < 2; ++k) av_a[k] = pb_avail(xc, yc, ncb, xp, yp, w, h, part_idx, xa[k], ya[k]);
  bool is_scaled = av_a[0] || av_a[1];
  // A without scaling
  for (int k = 0; k < 2 && !fa; ++k) {
    if (!av_a[k]) continue;
    const MvField& m = cur->mvf[u4(xa[k], ya[k])];
    if ((m.pred & (1 << lx)) && m.ref_poc[lx] == target) {
      fa = true;
      mva[0] = m.mv[lx][0];
      mva[1] = m.mv[lx][1];
    } else if ((m.pred & (1 << ly)) && m.ref_poc[ly] == target) {
      fa = true;
      mva[0] = m.mv[ly][0];
      mva[1] = m.mv[ly][1];
    }
  }
  // A with scaling
  for (int k = 0; k < 2 && !fa; ++k) {
    if (!av_a[k]) continue;
    const MvField& m = cur->mvf[u4(xa[k], ya[k])];
    int l = scaled_list(m);
    if (l < 0) continue;
    fa = true;
    int rp = m.ref_poc[l];
    mva[0] = m.mv[l][0];
    mva[1] = m.mv[l][1];
    if (!target_lt && rp != target) {
      mva[0] = scale_mv(mva[0], cur_poc - rp, cur_poc - target);
      mva[1] = scale_mv(mva[1], cur_poc - rp, cur_poc - target);
    }
  }
  // B
  int xbn[3] = {xp + w, xp + w - 1, xp - 1}, ybn[3] = {yp - 1, yp - 1, yp - 1};
  bool av_b[3];
  for (int k = 0; k < 3; ++k) av_b[k] = pb_avail(xc, yc, ncb, xp, yp, w, h, part_idx, xbn[k], ybn[k]);
  for (int k = 0; k < 3 && !fb; ++k) {
    if (!av_b[k]) continue;
    const MvField& m = cur->mvf[u4(xbn[k], ybn[k])];
    if ((m.pred & (1 << lx)) && m.ref_poc[lx] == target) {
      fb = true;
      mvb[0] = m.mv[lx][0];
      mvb[1] = m.mv[lx][1];
    } else if ((m.pred & (1 << ly)) && m.ref_poc[ly] == target) {
      fb = true;
      mvb[0] = m.mv[ly][0];
      mvb[1] = m.mv[ly][1];
    }
  }
  if (!is_scaled && fb) {
    fa = true;
    mva[0] = mvb[0];
    mva[1] = mvb[1];
  }
  if (!is_scaled) {
    fb = false;
    for (int k = 0; k < 3 && !fb; ++k) {
      if (!av_b[k]) continue;
      const MvField& m = cur->mvf[u4(xbn[k], ybn[k])];
      int l = scaled_list(m);
      if (l < 0) continue;
      fb = true;
      int rp = m.ref_poc[l];
      mvb[0] = m.mv[l][0];
      mvb[1] = m.mv[l][1];
      if (!target_lt && rp != target) {
        mvb[0] = scale_mv(mvb[0], cur_poc - rp, cur_poc - target);
        mvb[1] = scale_mv(mvb[1], cur_poc - rp, cur_poc - target);
      }
    }
  }
  int16_t list[3][2];
  int n = 0;
  if (fa) {
    list[n][0] = mva[0];
    list[n++][1] = mva[1];
  }
  if (fb && !(fa && mva[0] == mvb[0] && mva[1] == mvb[1])) {
    list[n][0] = mvb[0];
    list[n++][1] = mvb[1];
  }
  if (n < 2) {
    int16_t mv[2];
    if (temporal_mv(xp, yp, w, h, lx, ref_idx, mv)) {
      list[n][0] = mv[0];
      list[n++][1] = mv[1];
    }
  }
  while (n < 2) {
    list[n][0] = list[n][1] = 0;
    ++n;
  }
  mvp[0] = list[flag][0];
  mvp[1] = list[flag][1];
}

// ── motion compensation (8.5.3.3) ────────────────────────────────────────

template <class T>
static void mc_block(const T* plane, int pw, int ph, int x0, int y0, int w, int h, int fx,
                     int fy, bool luma, int bd, int16_t* dst) {
  // 14-bit prediction samples of a w x h block whose integer position is
  // (x0, y0) and fraction (fx, fy), reference samples clamped to the plane
  const int taps = luma ? 8 : 4, half = luma ? 3 : 1;
  const int8_t* fh = luma ? LUMA_FILTER[fx] : CHROMA_FILTER[fx];
  const int8_t* fv = luma ? LUMA_FILTER[fy] : CHROMA_FILTER[fy];
  const int sw = w + taps - 1, shh = h + taps - 1;
  static thread_local std::vector<T> src_buf;
  static thread_local std::vector<int16_t> tmp_buf;
  src_buf.resize((size_t)sw * shh);
  tmp_buf.resize((size_t)w * shh);
  // plain pointers in the loops: a thread_local of a template is reached
  // through its TLS wrapper, which the compiler does not hoist
  T* const src = src_buf.data();
  int16_t* const tmp = tmp_buf.data();
  int xs = x0 - half, ys = y0 - half;
  bool inside = xs >= 0 && ys >= 0 && xs + sw <= pw && ys + shh <= ph;
  for (int j = 0; j < shh; ++j) {
    if (inside) {
      memcpy(&src[(size_t)j * sw], plane + (size_t)(ys + j) * pw + xs, sizeof(T) * sw);
    } else {
      const T* row = plane + (size_t)clip3(0, ph - 1, ys + j) * pw;
      for (int i = 0; i < sw; ++i) src[(size_t)j * sw + i] = row[clip3(0, pw - 1, xs + i)];
    }
  }
  const int shift1 = bd - 8, shift3 = 14 - bd;
  if (fx == 0 && fy == 0) {
    for (int j = 0; j < h; ++j)
      for (int i = 0; i < w; ++i) dst[j * w + i] = (int16_t)(src[(size_t)(j + half) * sw + i + half] << shift3);
    return;
  }
  if (fy == 0) {
    for (int j = 0; j < h; ++j) {
      const T* s = &src[(size_t)(j + half) * sw];
      for (int i = 0; i < w; ++i) {
        int v = 0;
        for (int k = 0; k < taps; ++k) v += fh[k] * s[i + k];
        dst[j * w + i] = (int16_t)(v >> shift1);
      }
    }
    return;
  }
  if (fx == 0) {
    for (int j = 0; j < h; ++j)
      for (int i = 0; i < w; ++i) {
        int v = 0;
        for (int k = 0; k < taps; ++k) v += fv[k] * src[(size_t)(j + k) * sw + i + half];
        dst[j * w + i] = (int16_t)(v >> shift1);
      }
    return;
  }
  for (int j = 0; j < shh; ++j) {
    const T* s = &src[(size_t)j * sw];
    for (int i = 0; i < w; ++i) {
      int v = 0;
      for (int k = 0; k < taps; ++k) v += fh[k] * s[i + k];
      tmp[(size_t)j * w + i] = (int16_t)(v >> shift1);
    }
  }
  for (int j = 0; j < h; ++j)
    for (int i = 0; i < w; ++i) {
      int v = 0;
      for (int k = 0; k < taps; ++k) v += fv[k] * tmp[(size_t)(j + k) * w + i];
      dst[j * w + i] = (int16_t)(v >> 6);
    }
}

template <class T>
void Decoder::motion_compensate_t(int xp, int yp, int w, int h, const MvField& m) {
  static thread_local std::vector<int16_t> pa_buf, pb_buf;
  bool weighted = (sh.type == 1 && pps->weighted_pred) || (sh.type == 0 && pps->weighted_bipred);
  for (int c = 0; c < 3; ++c) {
    int cw = c ? w >> 1 : w, chh = c ? h >> 1 : h;
    int cx = c ? xp >> 1 : xp, cy = c ? yp >> 1 : yp;
    int pw = c ? W >> 1 : W, ph = c ? H >> 1 : H;
    pa_buf.resize((size_t)cw * chh);
    pb_buf.resize((size_t)cw * chh);
    int16_t* const pa = pa_buf.data();
    int16_t* const pb = pb_buf.data();
    int16_t* preds[2] = {pa, pb};
    int lists[2], nl = 0;
    for (int l = 0; l < 2; ++l) {
      if (!(m.pred & (1 << l))) continue;
      Pic& ref = *ref_list[l][m.ref_idx[l]];
      int mx = m.mv[l][0], my = m.mv[l][1];
      if (c == 0)
        mc_block(ref.plane<T>(0), pw, ph, cx + (mx >> 2), cy + (my >> 2), cw, chh, mx & 3, my & 3, true, bd,
                 preds[nl]);
      else
        mc_block(ref.plane<T>(c), pw, ph, cx + (mx >> 3), cy + (my >> 3), cw, chh, mx & 7, my & 7, false,
                 bd, preds[nl]);
      lists[nl++] = l;
    }
    if (nl == 0) return;
    T* dst = cur->plane<T>(c) + (size_t)cy * pw + cx;
    const int shift1 = 14 - bd, shift2 = 15 - bd;
    if (!weighted) {
      if (nl == 1) {
        for (int j = 0; j < chh; ++j)
          for (int i = 0; i < cw; ++i)
            dst[(size_t)j * pw + i] = (T)clip3(0, maxv, (pa[j * cw + i] + (1 << (shift1 - 1))) >> shift1);
      } else {
        for (int j = 0; j < chh; ++j)
          for (int i = 0; i < cw; ++i)
            dst[(size_t)j * pw + i] =
                (T)clip3(0, maxv, (pa[j * cw + i] + pb[j * cw + i] + (1 << (shift2 - 1))) >> shift2);
      }
    } else {
      int log2wd = (c == 0 ? sh.luma_log2_wd : sh.chroma_log2_wd) + shift1;
      int wt[2], of[2];
      for (int k = 0; k < nl; ++k) {
        int l = lists[k], r = m.ref_idx[l];
        wt[k] = c == 0 ? sh.lw[l][r] : sh.cw[l][r][c - 1];
        of[k] = (c == 0 ? sh.lo[l][r] : sh.co[l][r][c - 1]) * (1 << (bd - 8));
      }
      if (nl == 1) {
        for (int j = 0; j < chh; ++j)
          for (int i = 0; i < cw; ++i) {
            int v = log2wd >= 1 ? ((pa[j * cw + i] * wt[0] + (1 << (log2wd - 1))) >> log2wd) + of[0]
                                : pa[j * cw + i] * wt[0] + of[0];
            dst[(size_t)j * pw + i] = (T)clip3(0, maxv, v);
          }
      } else {
        for (int j = 0; j < chh; ++j)
          for (int i = 0; i < cw; ++i) {
            int v = (pa[j * cw + i] * wt[0] + pb[j * cw + i] * wt[1] + (of[0] + of[1] + 1) * (1 << log2wd)) >>
                    (log2wd + 1);
            dst[(size_t)j * pw + i] = (T)clip3(0, maxv, v);
          }
      }
    }
  }
}

// ── transform tree (7.3.8.8, 7.3.8.10) ───────────────────────────────────

void Decoder::transform_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk,
                             bool parent_cb, bool parent_cr, int max_depth, bool intra_split) {
  const SPS* s = sps;
  bool split;
  if (log2 <= s->log2_max_tb && log2 > s->log2_min_tb && depth < max_depth && !(intra_split && depth == 0)) {
    split = dec(C_SPLIT_TRANSFORM + 5 - log2);
  } else {
    bool inter_split = s->max_th_depth_inter == 0 && !cu_intra && part_mode != PART_2Nx2N && depth == 0;
    split = log2 > s->log2_max_tb || (intra_split && depth == 0) || inter_split;
  }
  bool cbf_cb = false, cbf_cr = false;
  if (log2 > 2) {
    if (depth == 0 || parent_cb) cbf_cb = dec(C_CBF_CHROMA + depth);
    if (depth == 0 || parent_cr) cbf_cr = dec(C_CBF_CHROMA + depth);
  } else {
    cbf_cb = parent_cb;
    cbf_cr = parent_cr;
  }
  if (split) {
    int h = 1 << (log2 - 1);
    transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0, cbf_cb, cbf_cr, max_depth, intra_split);
    transform_tree(x0 + h, y0, x0, y0, log2 - 1, depth + 1, 1, cbf_cb, cbf_cr, max_depth, intra_split);
    transform_tree(x0, y0 + h, x0, y0, log2 - 1, depth + 1, 2, cbf_cb, cbf_cr, max_depth, intra_split);
    transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1, depth + 1, 3, cbf_cb, cbf_cr, max_depth, intra_split);
  } else {
    bool cbf_l = true;
    if (cu_intra || depth != 0 || cbf_cb || cbf_cr) cbf_l = dec(C_CBF_LUMA + (depth == 0 ? 1 : 0));
    transform_unit(x0, y0, xb, yb, log2, blk, cbf_l, cbf_cb, cbf_cr);
  }
}

static void inverse_1d(const int16_t* m, int stride_k, int n, const int32_t* in, int in_stride,
                       int32_t* out, int out_stride) {
  for (int i = 0; i < n; ++i) {
    int64_t v = 0;
    for (int j = 0; j < n; ++j) v += (int64_t)m[j * stride_k + i] * in[j * in_stride];
    out[i * out_stride] = (int32_t)v;
  }
}

void Decoder::transform_unit(int x0, int y0, int xb, int yb, int log2, int blk, bool cbf_l,
                             bool cbf_cb, bool cbf_cr) {
  int size = 1 << log2;
  // transform block edges on the 8x8 grid (8.7.2.3)
  for (int j = 0; j < (size >> 2); ++j) {
    edge_v[u4(x0, y0 + 4 * j)] |= 1;
    edge_h[u4(x0 + 4 * j, y0)] |= 1;
  }
  fill4(cbf_map, w4, x0, y0, size, size, cbf_l);
  if ((cbf_l || cbf_cb || cbf_cr) && pps->cu_qp_delta && !cu_qp_delta_coded) {
    int v = 0;
    if (dec(C_CU_QP_DELTA)) {
      v = 1;
      while (v < 5 && dec(C_CU_QP_DELTA + 1)) ++v;
      if (v == 5) {
        int k = 0, e = 0;
        while (bypass()) {
          e += 1 << k;
          if (++k > 30) corrupt("cu_qp_delta_abs too long");
        }
        e += bypass_bits(k);
        v += e;
      }
      if (v > 26 + qpbd / 2) corrupt("cu_qp_delta_abs out of range");
      if (bypass()) v = -v;
    }
    if (v == 26 + qpbd / 2) corrupt("CuQpDeltaVal out of range");
    cu_qp_delta_coded = true;
    cu_qp_delta_val = v;
    qp_y = luma_qp();
  }
  if (cu_intra) intra_pred(0, x0, y0, log2, ipm[u4(x0, y0)]);
  if (cbf_l) residual(x0, y0, log2, 0);
  if (log2 > 2) {
    if (cu_intra) intra_pred(1, x0 >> 1, y0 >> 1, log2 - 1, chroma_mode);
    if (cbf_cb) residual(x0 >> 1, y0 >> 1, log2 - 1, 1);
    if (cu_intra) intra_pred(2, x0 >> 1, y0 >> 1, log2 - 1, chroma_mode);
    if (cbf_cr) residual(x0 >> 1, y0 >> 1, log2 - 1, 2);
  } else if (blk == 3) {
    if (cu_intra) intra_pred(1, xb >> 1, yb >> 1, 2, chroma_mode);
    if (cbf_cb) residual(xb >> 1, yb >> 1, 2, 1);
    if (cu_intra) intra_pred(2, xb >> 1, yb >> 1, 2, chroma_mode);
    if (cbf_cr) residual(xb >> 1, yb >> 1, 2, 2);
  }
}

// ── residual coding (7.3.8.11) and reconstruction (8.6) ──────────────────

void Decoder::residual(int x0, int y0, int log2, int c) {
  const int n = 1 << log2;
  int16_t* coef = coeffs;
  memset(coef, 0, sizeof(int16_t) * n * n);
  bool ts = false;
  if (pps->transform_skip && log2 == 2 && !cu_bypass) ts = dec(C_TRANSFORM_SKIP + (c ? 1 : 0));
  // last significant position
  int cmax = (log2 << 1) - 1;
  int off, shift;
  if (c == 0) {
    off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
    shift = (log2 + 1) >> 2;
  } else {
    off = 15;
    shift = log2 - 2;
  }
  int px = 0, py = 0;
  while (px < cmax && dec(C_LAST_X_PREFIX + off + (px >> shift))) ++px;
  while (py < cmax && dec(C_LAST_Y_PREFIX + off + (py >> shift))) ++py;
  int lx = px, ly = py;
  if (px > 3) {
    int nb = (px >> 1) - 1;
    lx = (1 << nb) * (2 + (px & 1)) + bypass_bits(nb);
  }
  if (py > 3) {
    int nb = (py >> 1) - 1;
    ly = (1 << nb) * (2 + (py & 1)) + bypass_bits(nb);
  }
  // scan order
  int scan_idx = 0;
  if (cu_intra && (log2 == 2 || (log2 == 3 && c == 0))) {
    int mode = c == 0 ? ipm[u4(x0, y0)] : chroma_mode;
    if (mode >= 6 && mode <= 14) scan_idx = 2;
    else if (mode >= 22 && mode <= 30) scan_idx = 1;
  }
  if (scan_idx == 2) std::swap(lx, ly);
  if (lx >= n || ly >= n) corrupt("a last significant coefficient outside the block");
  const int sb_log2 = log2 - 2, sbw = 1 << sb_log2;
  const uint8_t(*sb_scan)[2] = sb_log2 == 0 ? nullptr : sb_log2 == 1 ? SCAN_2[scan_idx] : sb_log2 == 2 ? SCAN_4[scan_idx] : SCAN_8[scan_idx];
  const uint8_t(*sc4)[2] = SCAN_4[scan_idx];
  int last_sb = sbw * sbw - 1, last_pos = 16;
  for (;;) {
    if (last_pos == 0) {
      last_pos = 16;
      --last_sb;
      if (last_sb < 0) corrupt("no last significant coefficient");
    }
    --last_pos;
    int xs = sb_scan ? sb_scan[last_sb][0] : 0, ys = sb_scan ? sb_scan[last_sb][1] : 0;
    int xc = (xs << 2) + sc4[last_pos][0], yc = (ys << 2) + sc4[last_pos][1];
    if (xc == lx && yc == ly) break;
  }
  uint8_t csbf[8][8];
  memset(csbf, 0, sizeof csbf);
  int greater1_ctx = 1;
  bool first_sb = true;
  for (int i = last_sb; i >= 0; --i) {
    int xs = sb_scan ? sb_scan[i][0] : 0, ys = sb_scan ? sb_scan[i][1] : 0;
    bool infer_dc = false;
    if (i < last_sb && i > 0) {
      int cs = 0;
      if (xs < sbw - 1) cs |= csbf[xs + 1][ys];
      if (ys < sbw - 1) cs |= csbf[xs][ys + 1];
      csbf[xs][ys] = (uint8_t)dec(C_CODED_SUB_BLOCK + std::min(cs, 1) + (c ? 2 : 0));
      infer_dc = true;
    } else {
      csbf[xs][ys] = 1;
    }
    int prev_csbf = 0;
    if (xs < sbw - 1) prev_csbf |= csbf[xs + 1][ys];
    if (ys < sbw - 1) prev_csbf |= csbf[xs][ys + 1] << 1;
    bool sig[16] = {};
    int start = i == last_sb ? last_pos - 1 : 15;
    if (i == last_sb) sig[last_pos] = true;
    if (csbf[xs][ys]) {
      for (int k = start; k >= 0; --k) {
        int xp = sc4[k][0], yp = sc4[k][1];
        int xc = (xs << 2) + xp, yc = (ys << 2) + yp;
        if (k == 0 && infer_dc) {
          sig[0] = true;
          break;
        }
        int sctx;
        if (log2 == 2) {
          sctx = CTX_IDX_MAP[(yc << 2) + xc];
        } else if (xc + yc == 0) {
          sctx = 0;
        } else {
          if (prev_csbf == 0) sctx = (xp + yp == 0) ? 2 : (xp + yp < 3) ? 1 : 0;
          else if (prev_csbf == 1) sctx = yp == 0 ? 2 : yp == 1 ? 1 : 0;
          else if (prev_csbf == 2) sctx = xp == 0 ? 2 : xp == 1 ? 1 : 0;
          else sctx = 2;
          if (c == 0 && (xs > 0 || ys > 0)) sctx += 3;
          if (log2 == 3) sctx += scan_idx == 0 ? 9 : 15;
          else sctx += c == 0 ? 21 : 12;
        }
        sig[k] = dec(C_SIG_COEFF + (c == 0 ? sctx : 27 + sctx));
        if (sig[k]) infer_dc = false;
      }
    }
    int pos[16], np = 0;
    for (int k = 15; k >= 0; --k)
      if (sig[k]) pos[np++] = k;
    if (np == 0) continue;
    // greater1 / greater2 (9.3.4.2.6, 9.3.4.2.7)
    int ctx_set = (i == 0 || c > 0) ? 0 : 2;
    if (!first_sb && greater1_ctx == 0) ++ctx_set;
    first_sb = false;
    greater1_ctx = 1;
    int g1[16] = {}, g2[16] = {};
    int first_g1 = -1;
    for (int m = 0; m < np && m < 8; ++m) {
      int inc = ctx_set * 4 + std::min(3, greater1_ctx) + (c ? 16 : 0);
      g1[m] = dec(C_GREATER1 + inc);
      if (g1[m]) {
        greater1_ctx = 0;
        if (first_g1 < 0) first_g1 = m;
      } else if (greater1_ctx > 0) {
        ++greater1_ctx;
      }
    }
    if (first_g1 >= 0) g2[first_g1] = dec(C_GREATER2 + ctx_set + (c ? 4 : 0));
    bool hidden = pps->sign_hiding && !cu_bypass && (pos[0] - pos[np - 1] > 3);
    int signs[16];
    for (int m = 0; m < np; ++m)
      signs[m] = (hidden && m == np - 1) ? 0 : bypass();
    int rice = 0, sum = 0;
    for (int m = 0; m < np; ++m) {
      int base = 1 + g1[m] + g2[m];
      int level = base;
      int thresh = m < 8 ? (m == first_g1 ? 3 : 2) : 1;
      if (base == thresh) {
        int prefix = 0;
        while (prefix < 32 && bypass()) ++prefix;
        if (prefix == 32) corrupt("coeff_abs_level_remaining too long");
        int rem;
        if (prefix <= 3) {
          rem = (prefix << rice) + bypass_bits(rice);
        } else {
          int e = prefix - 3;
          if (e + rice > 24) corrupt("coeff_abs_level_remaining out of range");
          rem = (((1 << e) + 2) << rice) + bypass_bits(e + rice);
        }
        level = base + rem;
        if (level > 3 * (1 << rice)) rice = std::min(rice + 1, 4);
      }
      if (level > 32768) corrupt("a coefficient level out of range");
      sum += level;
      int v = signs[m] ? -level : level;
      if (hidden && m == np - 1 && (sum & 1)) v = -v;
      int k = pos[m];
      int xc = (xs << 2) + sc4[k][0], yc = (ys << 2) + sc4[k][1];
      coef[yc * n + xc] = (int16_t)clip3(-32768, 32767, v);
    }
  }
  int32_t r[32 * 32];
  if (cu_bypass) {
    // the levels are the residual (8.6.2): no scaling, no transform
    for (int k = 0; k < n * n; ++k) r[k] = coef[k];
    wide ? add_residual<uint16_t>(c, x0, y0, n, r) : add_residual<uint8_t>(c, x0, y0, n, r);
    return;
  }
  // scaling (8.6.2 - 8.6.4.2): m from the scaling lists where they are on
  // (a 4x4 transform-skip block included), else 16
  int qp;                                // qP': QpBdOffset added
  if (c == 0) {
    qp = qp_y + qpbd;
  } else {
    int qpi = clip3(-qpbd, 57, qp_y + (c == 1 ? pps->cb_qp_offset + sh.cb_qp_offset : pps->cr_qp_offset + sh.cr_qp_offset));
    qp = (qpi < 30 ? qpi : QPC[qpi]) + qpbd;
  }
  int bd_shift = bd + log2 - 5;
  int64_t scale = (int64_t)LEVEL_SCALE[qp % 6] << (qp / 6);
  const uint8_t* m = scaling ? scaling->m[log2 - 2][(cu_intra ? 0 : 3) + c].data() : nullptr;
  int32_t* d = tmp32;
  for (int k = 0; k < n * n; ++k) {
    int64_t v = ((int64_t)coef[k] * scale * (m ? m[k] : 16) + (1LL << (bd_shift - 1))) >> bd_shift;
    d[k] = (int32_t)std::max<int64_t>(-32768, std::min<int64_t>(32767, v));
  }
  if (ts) {
    for (int k = 0; k < n * n; ++k) r[k] = d[k] * 128;      // tsShift 5 + Log2(nTbS) at 4x4
    for (int k = 0; k < n * n; ++k) r[k] = (r[k] + (1 << (19 - bd))) >> (20 - bd);
  } else {
    // vertical pass into e (columns), then clip, then horizontal
    int32_t e[32 * 32];
    bool dst = cu_intra && n == 4 && c == 0;
    const int16_t* m = dst ? &DST[0][0] : &DCT[0][0];
    int stride_k = dst ? 4 : 32 * (32 >> log2);
    for (int x = 0; x < n; ++x) inverse_1d(m, stride_k, n, d + x, n, e + x, n);
    for (int k = 0; k < n * n; ++k) e[k] = clip3(-32768, 32767, (e[k] + 64) >> 7);
    for (int y = 0; y < n; ++y) inverse_1d(m, stride_k, n, e + y * n, 1, r + y * n, 1);
    for (int k = 0; k < n * n; ++k) r[k] = (r[k] + (1 << (19 - bd))) >> (20 - bd);
  }
  wide ? add_residual<uint16_t>(c, x0, y0, n, r) : add_residual<uint8_t>(c, x0, y0, n, r);
}

template <class T>
void Decoder::add_residual(int c, int x0, int y0, int n, const int32_t* r) {
  int pw = c ? W >> 1 : W;
  T* dst = cur->plane<T>(c) + (size_t)y0 * pw + x0;
  for (int y = 0; y < n; ++y)
    for (int x = 0; x < n; ++x) dst[(size_t)y * pw + x] = (T)clip3(0, maxv, dst[(size_t)y * pw + x] + r[y * n + x]);
}

// ── intra prediction (8.4.4.2) ───────────────────────────────────────────

template <class T>
void Decoder::intra_pred_t(int c, int x0, int y0, int log2, int mode) {
  const int n = 1 << log2;
  const int sh_ = c ? 1 : 0;              // component to luma coordinates
  const int pw = c ? W >> 1 : W, ph = c ? H >> 1 : H;
  T* plane = cur->plane<T>(c);
  const int xl = x0 << sh_, yl = y0 << sh_;
  const int unit = c ? 2 : 4;             // component samples a 4x4 luma unit covers
  // p: left[0] = p[-1][-1], left[1 + y] = p[-1][y]; top[1 + x] = p[x][-1]
  int left[129], top[129];
  bool la[129], ta[129];
  auto avail = [&](int xc, int yc) -> bool {     // component sample position
    int xn = xc * (1 << sh_), yn = yc * (1 << sh_);
    if (!avail_z(xl, yl, xn, yn)) return false;
    if (pps->constrained_intra && !intra[u4(xn, yn)]) return false;
    return true;
  };
  int count = 0;
  {
    bool a = avail(x0 - 1, y0 - 1);
    la[0] = ta[0] = a;
    if (a) left[0] = top[0] = plane[(size_t)(y0 - 1) * pw + x0 - 1];
    count += a;
  }
  for (int k = 0; k < 2 * n; k += unit) {
    bool a = y0 + k < ph && avail(x0 - 1, y0 + k);
    for (int u = 0; u < unit; ++u) {
      la[1 + k + u] = a;
      if (a) left[1 + k + u] = plane[(size_t)(y0 + k + u) * pw + x0 - 1];
    }
    count += a;
    bool b = x0 + k < pw && avail(x0 + k, y0 - 1);
    for (int u = 0; u < unit; ++u) {
      ta[1 + k + u] = b;
      if (b) top[1 + k + u] = plane[(size_t)(y0 - 1) * pw + x0 + k + u];
    }
    count += b;
  }
  // substitution (8.4.4.2.2): search from p[-1][2n-1] up, then along the top
  if (count == 0) {
    for (int k = 0; k <= 2 * n; ++k) left[k] = top[k] = 1 << (bd - 1);
  } else {
    // order: left[2n] .. left[1], left[0] (corner), top[1] .. top[2n]
    auto at = [&](int i) -> int& { return i < 2 * n ? left[2 * n - i] : i == 2 * n ? left[0] : top[i - 2 * n]; };
    auto ok = [&](int i) -> bool { return i < 2 * n ? la[2 * n - i] : i == 2 * n ? la[0] : ta[i - 2 * n]; };
    int total = 4 * n + 1;
    if (!ok(0)) {
      int i = 1;
      while (!ok(i)) ++i;
      at(0) = at(i);
    }
    for (int i = 1; i < total; ++i)
      if (!ok(i)) at(i) = at(i - 1);
    top[0] = left[0];
  }
  // filtering (8.4.4.2.3), luma only in 4:2:0
  if (c == 0 && mode != 1 && n != 4) {
    int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
    int thres = n == 8 ? 7 : n == 16 ? 1 : 0;
    if (dist > thres) {
      int fl[129], ft[129];
      bool strong = sps->strong_intra && n == 32 &&
                    std::abs(left[0] + top[2 * n] - 2 * top[n]) < (1 << (bd - 5)) &&
                    std::abs(left[0] + left[2 * n] - 2 * left[n]) < (1 << (bd - 5));
      if (strong) {
        fl[0] = ft[0] = left[0];
        for (int i = 0; i < 63; ++i) {
          fl[1 + i] = ((63 - i) * left[0] + (i + 1) * left[64] + 32) >> 6;
          ft[1 + i] = ((63 - i) * top[0] + (i + 1) * top[64] + 32) >> 6;
        }
        fl[64] = left[64];
        ft[64] = top[64];
      } else {
        fl[0] = ft[0] = (left[1] + 2 * left[0] + top[1] + 2) >> 2;
        for (int i = 1; i < 2 * n; ++i) {
          fl[i] = (left[i + 1] + 2 * left[i] + left[i - 1] + 2) >> 2;
          ft[i] = (top[i + 1] + 2 * top[i] + top[i - 1] + 2) >> 2;
        }
        fl[2 * n] = left[2 * n];
        ft[2 * n] = top[2 * n];
      }
      memcpy(left, fl, sizeof(int) * (2 * n + 1));
      memcpy(top, ft, sizeof(int) * (2 * n + 1));
    }
  }
  T* dst = plane + (size_t)y0 * pw + x0;
  if (mode == 0) {                       // planar
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x)
        dst[(size_t)y * pw + x] = (T)(((n - 1 - x) * left[1 + y] + (x + 1) * top[1 + n] +
                                             (n - 1 - y) * top[1 + x] + (y + 1) * left[1 + n] + n) >> (log2 + 1));
  } else if (mode == 1) {                // DC
    int sum = n;
    for (int k = 0; k < n; ++k) sum += top[1 + k] + left[1 + k];
    int dc = sum >> (log2 + 1);
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x) dst[(size_t)y * pw + x] = (T)dc;
    if (c == 0 && n < 32) {
      dst[0] = (T)((left[1] + 2 * dc + top[1] + 2) >> 2);
      for (int x = 1; x < n; ++x) dst[x] = (T)((top[1 + x] + 3 * dc + 2) >> 2);
      for (int y = 1; y < n; ++y) dst[(size_t)y * pw] = (T)((left[1 + y] + 3 * dc + 2) >> 2);
    }
  } else {                               // angular
    int angle = INTRA_ANGLE[mode];
    int ref_buf[3 * 64 + 1];
    int* ref = ref_buf + 64;
    bool vertical = mode >= 18;
    const int* main_ = vertical ? top : left;      // main_[0] = corner, main_[1 + k]
    const int* side = vertical ? left : top;
    for (int x = 0; x <= n; ++x) ref[x] = main_[x];
    if (angle < 0) {
      int inv = INV_ANGLE[mode];
      if (((n * angle) >> 5) < -1)
        for (int x = (n * angle) >> 5; x <= -1; ++x) ref[x] = side[((x * inv + 128) >> 8)];
    } else {
      for (int x = n + 1; x <= 2 * n; ++x) ref[x] = main_[x];
    }
    for (int y = 0; y < n; ++y) {
      int idx = ((y + 1) * angle) >> 5, fact = ((y + 1) * angle) & 31;
      for (int x = 0; x < n; ++x) {
        int v = fact ? ((32 - fact) * ref[x + idx + 1] + fact * ref[x + idx + 2] + 16) >> 5 : ref[x + idx + 1];
        if (vertical) dst[(size_t)y * pw + x] = (T)v;
        else dst[(size_t)x * pw + y] = (T)v;
      }
    }
    if (c == 0 && n < 32) {
      if (mode == 26)
        for (int y = 0; y < n; ++y) dst[(size_t)y * pw] = (T)clip3(0, maxv, top[1] + ((left[1 + y] - left[0]) >> 1));
      if (mode == 10)
        for (int x = 0; x < n; ++x) dst[x] = (T)clip3(0, maxv, left[1] + ((top[1 + x] - top[0]) >> 1));
    }
  }
}

// ── deblocking (8.7.2) ───────────────────────────────────────────────────

int Decoder::bs_of(int xp, int yp, int xq, int yq, bool tu_edge) const {
  int up = u4(xp, yp), uq = u4(xq, yq);
  if (intra[up] || intra[uq]) return 2;
  if (tu_edge && (cbf_map[up] || cbf_map[uq])) return 1;
  const MvField& p = cur->mvf[up];
  const MvField& q = cur->mvf[uq];
  int np = (p.pred & 1) + ((p.pred >> 1) & 1), nq = (q.pred & 1) + ((q.pred >> 1) & 1);
  if (np != nq) return 1;
  auto far = [](const int16_t* a, const int16_t* b) { return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4; };
  if (np == 1) {
    int lp = p.pred & 1 ? 0 : 1, lq = q.pred & 1 ? 0 : 1;
    if (p.ref_poc[lp] != q.ref_poc[lq]) return 1;
    return far(p.mv[lp], q.mv[lq]);
  }
  int p0 = p.ref_poc[0], p1 = p.ref_poc[1], q0 = q.ref_poc[0], q1 = q.ref_poc[1];
  if (!((p0 == q0 && p1 == q1) || (p0 == q1 && p1 == q0))) return 1;
  if (p0 != p1) {
    if (p0 == q0) return far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1]);
    return far(p.mv[0], q.mv[1]) || far(p.mv[1], q.mv[0]);
  }
  return (far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1])) && (far(p.mv[0], q.mv[1]) || far(p.mv[1], q.mv[0]));
}

template <class T>
void Decoder::deblock_edge_luma(bool vertical, int x, int y, int strength, int qp, const SliceInfo& si) {
  T* pl = cur->plane<T>(0);
  int step = vertical ? 1 : W, along = vertical ? W : 1;
  T* base = pl + (size_t)y * W + x;
  int qb = clip3(0, 51, qp + si.beta_offset);
  int beta = BETA[qb] * (1 << (bd - 8));
  int qt = clip3(0, 53, qp + 2 * (strength - 1) + si.tc_offset);
  int tc = TC[qt] * (1 << (bd - 8));
  auto P = [&](int line, int i) -> T& { return base[line * along - (i + 1) * step]; };
  auto Q = [&](int line, int i) -> T& { return base[line * along + i * step]; };
  // nDp / nDq 0 (8.7.2.5.7): a PCM or bypass side keeps its samples
  bool keep_p = no_filter[vertical ? u4(x - 1, y) : u4(x, y - 1)], keep_q = no_filter[u4(x, y)];
  int dp0 = std::abs(P(0, 2) - 2 * P(0, 1) + P(0, 0)), dp3 = std::abs(P(3, 2) - 2 * P(3, 1) + P(3, 0));
  int dq0 = std::abs(Q(0, 2) - 2 * Q(0, 1) + Q(0, 0)), dq3 = std::abs(Q(3, 2) - 2 * Q(3, 1) + Q(3, 0));
  int dpq0 = dp0 + dq0, dpq3 = dp3 + dq3, dp = dp0 + dp3, dq = dq0 + dq3, d = dpq0 + dpq3;
  if (d >= beta) return;
  auto dsam = [&](int line, int dpq) {
    return 2 * dpq < (beta >> 2) && std::abs(P(line, 3) - P(line, 0)) + std::abs(Q(line, 0) - Q(line, 3)) < (beta >> 3) &&
           std::abs(P(line, 0) - Q(line, 0)) < ((5 * tc + 1) >> 1);
  };
  bool strong = dsam(0, dpq0) && dsam(3, dpq3);
  bool dep = dp < ((beta + (beta >> 1)) >> 3), deq = dq < ((beta + (beta >> 1)) >> 3);
  for (int k = 0; k < 4; ++k) {
    int p0 = P(k, 0), p1 = P(k, 1), p2 = P(k, 2), p3 = P(k, 3);
    int q0 = Q(k, 0), q1 = Q(k, 1), q2 = Q(k, 2), q3 = Q(k, 3);
    if (strong) {
      if (!keep_p) {
        P(k, 0) = (T)clip3(p0 - 2 * tc, p0 + 2 * tc, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
        P(k, 1) = (T)clip3(p1 - 2 * tc, p1 + 2 * tc, (p2 + p1 + p0 + q0 + 2) >> 2);
        P(k, 2) = (T)clip3(p2 - 2 * tc, p2 + 2 * tc, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
      }
      if (!keep_q) {
        Q(k, 0) = (T)clip3(q0 - 2 * tc, q0 + 2 * tc, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
        Q(k, 1) = (T)clip3(q1 - 2 * tc, q1 + 2 * tc, (p0 + q0 + q1 + q2 + 2) >> 2);
        Q(k, 2) = (T)clip3(q2 - 2 * tc, q2 + 2 * tc, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3);
      }
    } else {
      int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (std::abs(delta) >= tc * 10) continue;
      delta = clip3(-tc, tc, delta);
      if (!keep_p) P(k, 0) = (T)clip3(0, maxv, p0 + delta);
      if (!keep_q) Q(k, 0) = (T)clip3(0, maxv, q0 - delta);
      if (dep && !keep_p) {
        int dpv = clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1);
        P(k, 1) = (T)clip3(0, maxv, p1 + dpv);
      }
      if (deq && !keep_q) {
        int dqv = clip3(-(tc >> 1), tc >> 1, (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1);
        Q(k, 1) = (T)clip3(0, maxv, q1 + dqv);
      }
    }
  }
}

template <class T>
void Decoder::deblock_edge_chroma(bool vertical, int c, int x, int y, int qp, const SliceInfo& si) {
  // chroma edges are filtered at bS 2 alone
  int cw = W >> 1;
  T* pl = cur->plane<T>(c);
  int step = vertical ? 1 : cw, along = vertical ? cw : 1;
  T* base = pl + (size_t)y * cw + x;
  int qpi = qp + (c == 1 ? pps->cb_qp_offset : pps->cr_qp_offset);
  int qpc = qpi < 0 ? qpi : QPC[std::min(qpi, 57)];
  int tc = TC[clip3(0, 53, qpc + 2 + si.tc_offset)] * (1 << (bd - 8));
  int xl = x << 1, yl = y << 1;                       // luma
  bool keep_p = no_filter[vertical ? u4(xl - 1, yl) : u4(xl, yl - 1)], keep_q = no_filter[u4(xl, yl)];
  for (int k = 0; k < 2; ++k) {
    T* s = base + k * along;
    int p0 = s[-step], p1 = s[-2 * step], q0 = s[0], q1 = s[step];
    int delta = clip3(-tc, tc, ((((q0 - p0) * 4) + p1 - q1 + 4) >> 3));
    if (!keep_p) s[-step] = (T)clip3(0, maxv, p0 + delta);
    if (!keep_q) s[0] = (T)clip3(0, maxv, q0 - delta);
  }
}

template <class T>
void Decoder::deblock_t() {
  for (int dir = 0; dir < 2; ++dir) {
    bool vertical = dir == 0;
    std::vector<uint8_t> bsv((size_t)w4 * h4, 0);
    for (int y = 0; y < H; y += 4)
      for (int x = 0; x < W; x += 4) {
        int e = vertical ? edge_v[u4(x, y)] : edge_h[u4(x, y)];
        if (!e) continue;
        if (vertical ? (x & 7) || x == 0 : (y & 7) || y == 0) continue;
        int xp = vertical ? x - 1 : x, yp = vertical ? y : y - 1;
        const SliceInfo& sq = slices[ctb_slice[ctb_of(x, y)]];
        if (sq.deblock_disabled) continue;
        int cp = ctb_of(xp, yp);
        const SliceInfo& sp = slices[ctb_slice[cp]];
        if (sp.addr != sq.addr && !sq.lf_across) continue;
        if (!pps->lf_across_tiles && tile_id[cp] != tile_id[ctb_of(x, y)]) continue;
        bsv[u4(x, y)] = (uint8_t)bs_of(xp, yp, x, y, e & 1);
      }
    for (int y = 0; y < H; y += 4)
      for (int x = 0; x < W; x += 4) {
        int strength = bsv[u4(x, y)];
        if (!strength) continue;
        int xp = vertical ? x - 1 : x, yp = vertical ? y : y - 1;
        int qp = (qp_map[u4(x, y)] + qp_map[u4(xp, yp)] + 1) >> 1;
        const SliceInfo& sq = slices[ctb_slice[ctb_of(x, y)]];
        deblock_edge_luma<T>(vertical, x, y, strength, qp, sq);
        if (strength == 2 && !(vertical ? (x & 15) : (y & 15)))
          for (int c = 1; c < 3; ++c) deblock_edge_chroma<T>(vertical, c, x >> 1, y >> 1, qp, sq);
      }
  }
}

// ── SAO (8.7.3) ──────────────────────────────────────────────────────────

template <class T>
void Decoder::apply_sao_t() {
  const SPS* s = sps;
  static const int hpos[4][2] = {{-1, 1}, {0, 0}, {-1, 1}, {1, -1}};
  static const int vpos[4][2] = {{0, 0}, {-1, 1}, {-1, 1}, {-1, 1}};
  const int scale = 1 << (bd - std::min(bd, 10));      // SaoOffsetVal's log2OffsetScale
  for (int c = 0; c < 3; ++c) {
    int pw = c ? W >> 1 : W, ph = c ? H >> 1 : H;
    std::vector<T> src(cur->plane<T>(c), cur->plane<T>(c) + (size_t)pw * ph);
    T* dst = cur->plane<T>(c);
    int ctb = c ? s->ctb_size >> 1 : s->ctb_size;
    int sh_ = c ? 1 : 0;
    for (int ry = 0; ry < s->ctb_h; ++ry)
      for (int rx = 0; rx < s->ctb_w; ++rx) {
        int addr = ry * s->ctb_w + rx;
        const SaoParams& p = sao[addr];
        const SliceInfo& si = slices[ctb_slice[addr]];
        if ((c == 0 && !si.sao_luma) || (c > 0 && !si.sao_chroma)) continue;
        if (p.type[c] == 0) continue;
        int x0 = rx * ctb, y0 = ry * ctb, x1 = std::min(x0 + ctb, pw), y1 = std::min(y0 + ctb, ph);
        // PCM (loop filter disabled) and bypass samples are kept (8.7.3); in
        // chroma, as FFmpeg keeps them, only those of the units whose luma
        // lies within the CTB's chroma extent from its corner (its
        // restore_tqb_pixels takes the chroma width and height for luma's)
        int lim_x = (rx * s->ctb_size + (x1 - x0)) >> (s->log2_min_cb - 1);
        int lim_y = (ry * s->ctb_size + (y1 - y0)) >> (s->log2_min_cb - 1);
        auto keep = [&](int x, int y) {
          int xl = x << sh_, yl = y << sh_;
          return no_filter[u4(xl, yl)] &&
                 (!c || ((xl >> (s->log2_min_cb - 1)) < lim_x && (yl >> (s->log2_min_cb - 1)) < lim_y));
        };
        if (p.type[c] == 1) {
          int table[32] = {};
          for (int k = 0; k < 4; ++k) table[(k + p.band_pos[c]) & 31] = k + 1;
          for (int y = y0; y < y1; ++y)
            for (int x = x0; x < x1; ++x) {
              int v = src[(size_t)y * pw + x];
              int b = table[v >> (bd - 5)];
              if (b && !keep(x, y)) dst[(size_t)y * pw + x] = (T)clip3(0, maxv, v + p.offset[c][b] * scale);
            }
          continue;
        }
        int cls = p.eo_class[c];
        for (int y = y0; y < y1; ++y)
          for (int x = x0; x < x1; ++x) {
            int v = src[(size_t)y * pw + x];
            int sum = 0;
            bool skip = keep(x, y);
            for (int k = 0; k < 2 && !skip; ++k) {
              int xn = x + hpos[cls][k], yn = y + vpos[cls][k];
              if (xn < 0 || yn < 0 || xn >= pw || yn >= ph) {
                skip = true;
                break;
              }
              int an = ctb_of(xn << sh_, yn << sh_);
              if (an != addr) {
                if (!pps->lf_across_tiles && tile_id[an] != tile_id[addr]) {
                  skip = true;
                  break;
                }
                const SliceInfo& sn = slices[ctb_slice[an]];
                if (sn.addr != si.addr) {
                  // the earlier slice's boundary (in tile scan) obeys the later one's flag
                  bool later = rs2ts[an] > rs2ts[addr];
                  if ((later && !sn.lf_across) || (!later && !si.lf_across)) {
                    skip = true;
                    break;
                  }
                }
              }
              sum += sign(v - src[(size_t)yn * pw + xn]);
            }
            if (skip) continue;
            int e = 2 + sum;
            if (e <= 2) e = e == 2 ? 0 : e + 1;
            if (e) dst[(size_t)y * pw + x] = (T)clip3(0, maxv, v + p.offset[c][e] * scale);
          }
      }
  }
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
    d->error = "HEVC: out of memory";
    return 1;
  } catch (const std::exception& e) {
    d->error = std::string("HEVC: ") + e.what();
    return 1;
  }
}

template <class T>
void pop_planes(Decoder* d, T* y, T* cb, T* cr) {
  PicP p = d->ready.front();
  d->ready.erase(d->ready.begin());
  int w = p->w - p->crop[0] - p->crop[1], hh = p->h - p->crop[2] - p->crop[3];
  int x0 = p->crop[0], y0 = p->crop[2];
  for (int r = 0; r < hh; ++r)
    memcpy(y + (size_t)r * w, p->plane<T>(0) + (size_t)(y0 + r) * p->w + x0, sizeof(T) * w);
  int cw = w / 2, ch = hh / 2, CW = p->w / 2;
  for (int r = 0; r < ch; ++r) {
    memcpy(cb + (size_t)r * cw, p->plane<T>(1) + (size_t)(y0 / 2 + r) * CW + x0 / 2, sizeof(T) * cw);
    memcpy(cr + (size_t)r * cw, p->plane<T>(2) + (size_t)(y0 / 2 + r) * CW + x0 / 2, sizeof(T) * cw);
  }
}

}  // namespace

extern "C" {

void* hevcd_new() {
  try {
    return new Decoder();
  } catch (...) {
    return nullptr;
  }
}

void hevcd_free(void* h) { delete static_cast<Decoder*>(h); }

// one NAL unit (no start code, emulation prevention still in)
int hevcd_nal(void* h, const uint8_t* data, int64_t size) {
  Decoder* d = static_cast<Decoder*>(h);
  return guard(d, [&] { d->nal(data, (size_t)size); });
}

// the access unit given so far is a whole picture
int hevcd_end_picture(void* h) {
  Decoder* d = static_cast<Decoder*>(h);
  return guard(d, [&] { d->end_picture(); });
}

// the end of the stream: every picture goes to the output
int hevcd_flush(void* h) {
  Decoder* d = static_cast<Decoder*>(h);
  return guard(d, [&] { d->flush(); });
}

int hevcd_ready(void* h) { return (int)static_cast<Decoder*>(h)->ready.size(); }

// the cropped size of the next picture out
int hevcd_frame_size(void* h, int32_t* w, int32_t* hh) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->ready.empty()) return 1;
  const Pic& p = *d->ready.front();
  *w = p.w - p.crop[0] - p.crop[1];
  *hh = p.h - p.crop[2] - p.crop[3];
  return 0;
}

// the bit depth of the next picture out (0: none ready)
int hevcd_bit_depth(void* h) {
  Decoder* d = static_cast<Decoder*>(h);
  return d->ready.empty() ? 0 : d->ready.front()->bd;
}

// copy the next picture out (cropped Y', Cb, Cr) and drop it: uint8_t
// planes at 8 bits (hevcd_pop), uint16_t above (hevcd_pop16); 1 where none
// is ready or the planes' type is not the picture's
int hevcd_pop(void* h, uint8_t* y, uint8_t* cb, uint8_t* cr) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->ready.empty() || d->ready.front()->bd > 8) return 1;
  pop_planes(d, y, cb, cr);
  return 0;
}

int hevcd_pop16(void* h, uint16_t* y, uint16_t* cb, uint16_t* cr) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->ready.empty() || d->ready.front()->bd <= 8) return 1;
  pop_planes(d, y, cb, cr);
  return 0;
}

const char* hevcd_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

}  // extern "C"
