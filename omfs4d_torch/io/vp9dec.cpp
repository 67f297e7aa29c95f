// VP9 profile 0 (the VP9 bitstream specification, v0.6) decoded on the
// host, as FFmpeg's `vp9` decoder decodes it inside cv2: frame by frame,
// each to three 8-bit 4:2:0 planes.
//
// Built by g++ at first use (`omfs4d_torch.io.vp9`) with the generated
// `vp9_tables.h` (`omfs4d_torch/io/vp9_tables.py`), and bound with ctypes
// through a plain-C interface (the `vp9d_*` functions at the end).
//
// The parser is a template over its source of syntax (`Decoder<Src>`): the
// port instantiates it with `Reader`, which reads a packet's bits and its
// boolean-coded partitions; every read names the element it reads (`K_*`).
//
// Where FFmpeg reads the stream otherwise than the specification, this
// decoder follows FFmpeg:
// - the three sign biases read as 0 in an error-resilient frame (libvpx's
//   `setup_past_independence` clears them after reading them);
// - a key frame or an intra-only frame saves its probabilities into context
//   0 whatever `frame_context_idx` says; an intra-only frame starts from the
//   context it names;
// - backward adaptation counts a motion vector's high-precision bit as 1
//   where the bit is not coded (libvpx counts it so);
// - the loop filter's edges are chosen per 8x8 block from the block's
//   transform size, skip flag and size as FFmpeg's `mask_edges` chooses them
//   (chroma from the top-left luma block of each 16x16), and filtered per
//   64x64 superblock, its vertical edges first;
// - an inter block of 8x8 or more with no coefficient is taken as skipped
//   for the loop filter and for the skip and transform size contexts of the
//   blocks after it;
// - the previous frame's segment map is the map of the last frame decoded
//   whose segmentation updated its map (kept, by the header of the frame
//   before, while segmentation is off or keeps its map); a key frame or an
//   intra-only frame with segmentation on writes its map; an error-resilient
//   frame predicts segment 0;
// - a reference block outside the reference picture reads its visible edge
//   repeated; an intra edge reads the picture to its 8-aligned decoded size.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <string>
#include <vector>

#include "vp9_tables.h"

namespace vp9 {

enum { SHOWN = 0, HIDDEN = 1, FAILED = -1 };

// what a read reads: the elements a source of syntax may tell apart
enum Kind {
    // the uncompressed header
    K_MARKER, K_PROFILE_LOW, K_PROFILE_HIGH, K_RESERVED, K_SHOW_EXISTING, K_EXISTING_IDX,
    K_FRAME_TYPE, K_SHOW_FRAME, K_ERROR_RES, K_SYNC, K_COLOR_SPACE, K_COLOR_RANGE, K_WIDTH, K_HEIGHT, K_RENDER_DIFF, K_RENDER_SIZE, K_INTRA_ONLY, K_RESET_CTX,
    K_REFRESH_FLAGS, K_REF_IDX, K_SIGN_BIAS, K_FOUND_REF, K_HP, K_FILTER_SWITCHABLE,
    K_FILTER_LITERAL, K_REFRESH_CTX, K_PARALLEL, K_CTX_IDX, K_LF_LEVEL, K_SHARPNESS,
    K_LF_DELTA_ENABLED, K_LF_DELTA_UPDATE, K_LF_UPDATE, K_LF_VALUE, K_LF_SIGN, K_BASE_Q,
    K_DELTA_Q_CODED, K_DELTA_Q, K_DELTA_Q_SIGN, K_SEG_ENABLED, K_SEG_UPDATE_MAP,
    K_SEG_PROB_CODED, K_SEG_PROB, K_SEG_TEMPORAL, K_SEG_PRED_CODED, K_SEG_PRED_PROB,
    K_SEG_UPDATE_DATA, K_SEG_ABS, K_SEG_FEATURE, K_SEG_VALUE, K_SEG_SIGN, K_TILE_COL_INC,
    K_TILE_ROWS, K_HEADER_SIZE,
    // the compressed header
    K_TX_MODE, K_TX_SELECT, K_UPDATE, K_COEF_UPDATE_ANY, K_COMP_MODE, K_COMP_SELECT,
    // blocks
    K_PARTITION, K_SPLIT_OR_HORZ, K_SPLIT_OR_VERT, K_SEG_ID, K_SEG_PREDICTED, K_SKIP, K_TX_SIZE,
    K_IS_INTER, K_COMP, K_COMP_REF, K_SINGLE_REF1, K_SINGLE_REF2, K_KF_Y_MODE, K_KF_SUB_MODE,
    K_KF_UV_MODE, K_Y_MODE, K_SUB_MODE, K_UV_MODE, K_INTER_MODE, K_SUB_INTER_MODE,
    K_INTERP_FILTER, K_MV_JOINT, K_MORE_COEFS, K_SIGN,
    N_KINDS
};

enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16,
       BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64 };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32 };
enum { ONLY_4X4, ALLOW_8X8, ALLOW_16X16, ALLOW_32X32, TX_MODE_SELECT };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST };
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED, D207_PRED,
       D63_PRED, TM_PRED, NEARESTMV, NEARMV, ZEROMV, NEWMV };
enum { INTRA_FRAME = 0, LAST_FRAME = 1, GOLDEN_FRAME = 2, ALTREF_FRAME = 3, NONE = -1 };
enum { SINGLE_REF, COMPOUND_REF, REFERENCE_SELECT };
enum { SWITCHABLE = 4 };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT };

// by block size
static const uint8_t B_W8[13] = {1, 1, 1, 1, 1, 2, 2, 2, 4, 4, 4, 8, 8};   // width, 8x8 units
static const uint8_t B_H8[13] = {1, 1, 1, 1, 2, 1, 2, 4, 2, 4, 8, 4, 8};
static const uint8_t B_W4[13] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16};  // width, 4x4 units
static const uint8_t B_H4[13] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16};
static const uint8_t MAX_TX[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3};
static const uint8_t SIZE_GROUP[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3};
static const uint8_t TX_MODE_MAX[5] = {0, 1, 2, 3, 3};
// the block size of each partition of a square size (64x64 .. 8x8 as 0..3)
static const uint8_t SUBSIZE[4][4] = {
    {BLOCK_64X64, BLOCK_64X32, BLOCK_32X64, BLOCK_32X32},
    {BLOCK_32X32, BLOCK_32X16, BLOCK_16X32, BLOCK_16X16},
    {BLOCK_16X16, BLOCK_16X8, BLOCK_8X16, BLOCK_8X8},
    {BLOCK_8X8, BLOCK_8X4, BLOCK_4X8, BLOCK_4X4}};
// partition contexts a block leaves (above, left), libvpx's
static const uint8_t PART_CTX_ABOVE[13] = {15, 15, 14, 14, 14, 12, 12, 12, 8, 8, 8, 0, 0};
static const uint8_t PART_CTX_LEFT[13] = {15, 14, 15, 14, 12, 14, 12, 8, 12, 8, 0, 8, 0};
// the eight candidate positions (row, column) of find_mv_refs, by size
static const int8_t MV_REF_BLOCKS[13][8][2] = {
    {{-1, 0}, {0, -1}, {-1, -1}, {-2, 0}, {0, -2}, {-2, -1}, {-1, -2}, {-2, -2}},
    {{-1, 0}, {0, -1}, {-1, -1}, {-2, 0}, {0, -2}, {-2, -1}, {-1, -2}, {-2, -2}},
    {{-1, 0}, {0, -1}, {-1, -1}, {-2, 0}, {0, -2}, {-2, -1}, {-1, -2}, {-2, -2}},
    {{-1, 0}, {0, -1}, {-1, -1}, {-2, 0}, {0, -2}, {-2, -1}, {-1, -2}, {-2, -2}},
    {{0, -1}, {-1, 0}, {1, -1}, {-1, -1}, {0, -2}, {-2, 0}, {-2, -1}, {-1, -2}},
    {{-1, 0}, {0, -1}, {-1, 1}, {-1, -1}, {-2, 0}, {0, -2}, {-1, -2}, {-2, -1}},
    {{-1, 0}, {0, -1}, {-1, 1}, {1, -1}, {-1, -1}, {-3, 0}, {0, -3}, {-3, -3}},
    {{0, -1}, {-1, 0}, {2, -1}, {-1, -1}, {-1, 1}, {0, -3}, {-3, 0}, {-3, -3}},
    {{-1, 0}, {0, -1}, {-1, 2}, {-1, -1}, {1, -1}, {-3, 0}, {0, -3}, {-3, -3}},
    {{-1, 1}, {1, -1}, {-1, 2}, {2, -1}, {-1, -1}, {-3, 0}, {0, -3}, {-3, -3}},
    {{0, -1}, {-1, 0}, {4, -1}, {-1, 2}, {-1, -1}, {0, -3}, {-3, 0}, {2, -1}},
    {{-1, 0}, {0, -1}, {-1, 4}, {2, -1}, {-1, -1}, {-3, 0}, {0, -3}, {-1, 2}},
    {{-1, 3}, {3, -1}, {-1, 4}, {4, -1}, {-1, -1}, {-1, 0}, {0, -1}, {-1, 6}}};
static const uint8_t MODE_2_COUNTER[14] = {9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 0, 0, 3, 1};
static const uint8_t COUNTER_TO_CONTEXT[19] = {2, 3, 4, 1, 3, 9, 0, 9, 9, 5, 5, 9, 5,
                                               9, 9, 9, 9, 9, 6};
static const uint8_t IDX_N_COLUMN_TO_SUBBLOCK[4][2] = {{1, 2}, {1, 3}, {3, 2}, {3, 3}};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }
template <class T> inline T clamp(T v, T lo, T hi) { return v < lo ? lo : v > hi ? hi : v; }

struct DecodeError : std::exception {
    std::string what_;
    explicit DecodeError(std::string w) : what_(std::move(w)) {}
    const char* what() const noexcept override { return what_.c_str(); }
};

// ── the bit reader (the uncompressed header) ───────────────────────────

struct BitReader {
    const uint8_t* data = nullptr;
    size_t size = 0, pos = 0;            // pos in bits
    void init(const uint8_t* d, size_t n) { data = d, size = n, pos = 0; }
    int bit() {
        int b = pos < 8 * size ? (data[pos >> 3] >> (7 - (pos & 7))) & 1 : 0;
        ++pos;
        return b;
    }
    int read(int n) {
        int v = 0;
        while (n--) v = (v << 1) | bit();
        return v;
    }
    size_t bytes() const { return (pos + 7) >> 3; }
};

// ── the boolean decoder, FFmpeg's vpx range coder ───────────────────────

struct BoolDecoder {
    const uint8_t* buf = nullptr;
    const uint8_t* end = nullptr;
    int high = 255, bits = -16;
    unsigned code_word = 0;
    int end_reached = 0;

    void init(const uint8_t* b, size_t n) {
        buf = b;
        end = b + n;
        high = 255;
        bits = -16;
        end_reached = 0;
        code_word = 0;
        for (int i = 0; i < 3; ++i) code_word = (code_word << 8) | (buf < end ? *buf++ : 0);
    }
    void renorm() {
        int shift = __builtin_clz((unsigned)high) - 24;
        int b = bits;
        unsigned cw = code_word;
        high <<= shift;
        cw <<= shift;
        b += shift;
        if (b >= 0 && buf < end) {
            unsigned two = (unsigned)buf[0] << 8 | (buf + 1 < end ? buf[1] : 0);
            buf += 2;
            cw |= two << b;
            b -= 16;
        }
        bits = b;
        code_word = cw;
    }
    int get(int prob) {
        renorm();
        unsigned split = 1 + (((unsigned)(high - 1) * (unsigned)prob) >> 8);
        unsigned low = split << 16;
        int bit = code_word >= low;
        if (bit) {
            high -= split;
            code_word -= low;
        } else {
            high = split;
        }
        return bit;
    }
    bool at_end() {
        if (end <= buf && bits >= 0) ++end_reached;
        return end_reached > 10;
    }
};

// ── inverse transforms (FFmpeg's vp9dsp C, libvpx's butterflies) ────────

enum { C1 = 16364, C2 = 16305, C3 = 16207, C4 = 16069, C5 = 15893, C6 = 15679, C7 = 15426,
       C8 = 15137, C9 = 14811, C10 = 14449, C11 = 14053, C12 = 13623, C13 = 13160,
       C14 = 12665, C15 = 12140, C16 = 11585, C17 = 11003, C18 = 10394, C19 = 9760,
       C20 = 9102, C21 = 8423, C22 = 7723, C23 = 7005, C24 = 6270, C25 = 5520, C26 = 4756,
       C27 = 3981, C28 = 3196, C29 = 2404, C30 = 1606, C31 = 804 };
enum { S1 = 5283, S2 = 9929, S3 = 13377, S4 = 15212 };
typedef int64_t L;
inline int R(L x) { return (int)((x + (1 << 13)) >> 14); }

static void idct4(const int* in, int* out) {
    int s0 = R((L)(in[0] + in[2]) * C16), s1 = R((L)(in[0] - in[2]) * C16);
    int s2 = R((L)in[1] * C24 - (L)in[3] * C8), s3 = R((L)in[1] * C8 + (L)in[3] * C24);
    out[0] = s0 + s3;
    out[1] = s1 + s2;
    out[2] = s1 - s2;
    out[3] = s0 - s3;
}

static void iadst4(const int* in, int* out) {
    L x0 = in[0], x1 = in[1], x2 = in[2], x3 = in[3];
    L s0 = S1 * x0 + S4 * x2 + S2 * x3;
    L s1 = S2 * x0 - S1 * x2 - S4 * x3;
    L s2 = S3 * (x0 - x2 + x3);
    L s3 = S3 * x1;
    out[0] = R(s0 + s3);
    out[1] = R(s1 + s3);
    out[2] = R(s2);
    out[3] = R(s0 + s1 - s3);
}

static void idct8(const int* in, int* out) {
    int e[4] = {in[0], in[2], in[4], in[6]}, t[4];
    idct4(e, t);
    int s4 = R((L)in[1] * C28 - (L)in[7] * C4), s7 = R((L)in[1] * C4 + (L)in[7] * C28);
    int s5 = R((L)in[5] * C12 - (L)in[3] * C20), s6 = R((L)in[5] * C20 + (L)in[3] * C12);
    int u4 = s4 + s5, u5 = s4 - s5, u6 = -s6 + s7, u7 = s6 + s7;
    int v5 = R((L)(u6 - u5) * C16), v6 = R((L)(u5 + u6) * C16);
    out[0] = t[0] + u7;
    out[1] = t[1] + v6;
    out[2] = t[2] + v5;
    out[3] = t[3] + u4;
    out[4] = t[3] - u4;
    out[5] = t[2] - v5;
    out[6] = t[1] - v6;
    out[7] = t[0] - u7;
}

static void iadst8(const int* in, int* out) {
    L x0 = in[7], x1 = in[0], x2 = in[5], x3 = in[2], x4 = in[3], x5 = in[4], x6 = in[1],
      x7 = in[6];
    L s0 = C2 * x0 + C30 * x1, s1 = C30 * x0 - C2 * x1;
    L s2 = C10 * x2 + C22 * x3, s3 = C22 * x2 - C10 * x3;
    L s4 = C18 * x4 + C14 * x5, s5 = C14 * x4 - C18 * x5;
    L s6 = C26 * x6 + C6 * x7, s7 = C6 * x6 - C26 * x7;
    x0 = R(s0 + s4), x1 = R(s1 + s5), x2 = R(s2 + s6), x3 = R(s3 + s7);
    x4 = R(s0 - s4), x5 = R(s1 - s5), x6 = R(s2 - s6), x7 = R(s3 - s7);
    s0 = x0, s1 = x1, s2 = x2, s3 = x3;
    s4 = C8 * x4 + C24 * x5;
    s5 = C24 * x4 - C8 * x5;
    s6 = -C24 * x6 + C8 * x7;
    s7 = C8 * x6 + C24 * x7;
    x0 = s0 + s2, x1 = s1 + s3, x2 = s0 - s2, x3 = s1 - s3;
    x4 = R(s4 + s6), x5 = R(s5 + s7), x6 = R(s4 - s6), x7 = R(s5 - s7);
    s2 = C16 * (x2 + x3), s3 = C16 * (x2 - x3), s6 = C16 * (x6 + x7), s7 = C16 * (x6 - x7);
    x2 = R(s2), x3 = R(s3), x6 = R(s6), x7 = R(s7);
    out[0] = (int)x0;
    out[1] = (int)-x4;
    out[2] = (int)x6;
    out[3] = (int)-x2;
    out[4] = (int)x3;
    out[5] = (int)-x7;
    out[6] = (int)x5;
    out[7] = (int)-x1;
}

static void idct16(const int* in, int* out) {
    int a[16], b[16];
    static const int ORDER[16] = {0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15};
    for (int i = 0; i < 16; ++i) a[i] = in[ORDER[i]];
    // stage 2
    for (int i = 0; i < 8; ++i) b[i] = a[i];
    b[8] = R((L)a[8] * C30 - (L)a[15] * C2);
    b[15] = R((L)a[8] * C2 + (L)a[15] * C30);
    b[9] = R((L)a[9] * C14 - (L)a[14] * C18);
    b[14] = R((L)a[9] * C18 + (L)a[14] * C14);
    b[10] = R((L)a[10] * C22 - (L)a[13] * C10);
    b[13] = R((L)a[10] * C10 + (L)a[13] * C22);
    b[11] = R((L)a[11] * C6 - (L)a[12] * C26);
    b[12] = R((L)a[11] * C26 + (L)a[12] * C6);
    // stage 3
    for (int i = 0; i < 4; ++i) a[i] = b[i];
    a[4] = R((L)b[4] * C28 - (L)b[7] * C4);
    a[7] = R((L)b[4] * C4 + (L)b[7] * C28);
    a[5] = R((L)b[5] * C12 - (L)b[6] * C20);
    a[6] = R((L)b[5] * C20 + (L)b[6] * C12);
    a[8] = b[8] + b[9];
    a[9] = b[8] - b[9];
    a[10] = -b[10] + b[11];
    a[11] = b[10] + b[11];
    a[12] = b[12] + b[13];
    a[13] = b[12] - b[13];
    a[14] = -b[14] + b[15];
    a[15] = b[14] + b[15];
    // stage 4
    b[0] = R((L)(a[0] + a[1]) * C16);
    b[1] = R((L)(a[0] - a[1]) * C16);
    b[2] = R((L)a[2] * C24 - (L)a[3] * C8);
    b[3] = R((L)a[2] * C8 + (L)a[3] * C24);
    b[4] = a[4] + a[5];
    b[5] = a[4] - a[5];
    b[6] = -a[6] + a[7];
    b[7] = a[6] + a[7];
    b[8] = a[8];
    b[15] = a[15];
    b[9] = R(-(L)a[9] * C8 + (L)a[14] * C24);
    b[14] = R((L)a[9] * C24 + (L)a[14] * C8);
    b[10] = R(-(L)a[10] * C24 - (L)a[13] * C8);
    b[13] = R(-(L)a[10] * C8 + (L)a[13] * C24);
    b[11] = a[11];
    b[12] = a[12];
    // stage 5
    a[0] = b[0] + b[3];
    a[1] = b[1] + b[2];
    a[2] = b[1] - b[2];
    a[3] = b[0] - b[3];
    a[4] = b[4];
    a[5] = R((L)(b[6] - b[5]) * C16);
    a[6] = R((L)(b[5] + b[6]) * C16);
    a[7] = b[7];
    a[8] = b[8] + b[11];
    a[9] = b[9] + b[10];
    a[10] = b[9] - b[10];
    a[11] = b[8] - b[11];
    a[12] = -b[12] + b[15];
    a[13] = -b[13] + b[14];
    a[14] = b[13] + b[14];
    a[15] = b[12] + b[15];
    // stage 6
    for (int i = 0; i < 4; ++i) {
        b[i] = a[i] + a[7 - i];
        b[7 - i] = a[i] - a[7 - i];
    }
    b[8] = a[8];
    b[9] = a[9];
    b[10] = R((L)(-a[10] + a[13]) * C16);
    b[13] = R((L)(a[10] + a[13]) * C16);
    b[11] = R((L)(-a[11] + a[12]) * C16);
    b[12] = R((L)(a[11] + a[12]) * C16);
    b[14] = a[14];
    b[15] = a[15];
    for (int i = 0; i < 8; ++i) {
        out[i] = b[i] + b[15 - i];
        out[15 - i] = b[i] - b[15 - i];
    }
}

static void iadst16(const int* in, int* out) {
    L x0 = in[15], x1 = in[0], x2 = in[13], x3 = in[2], x4 = in[11], x5 = in[4], x6 = in[9],
      x7 = in[6], x8 = in[7], x9 = in[8], x10 = in[5], x11 = in[10], x12 = in[3], x13 = in[12],
      x14 = in[1], x15 = in[14];
    L s0 = x0 * C1 + x1 * C31, s1 = x0 * C31 - x1 * C1;
    L s2 = x2 * C5 + x3 * C27, s3 = x2 * C27 - x3 * C5;
    L s4 = x4 * C9 + x5 * C23, s5 = x4 * C23 - x5 * C9;
    L s6 = x6 * C13 + x7 * C19, s7 = x6 * C19 - x7 * C13;
    L s8 = x8 * C17 + x9 * C15, s9 = x8 * C15 - x9 * C17;
    L s10 = x10 * C21 + x11 * C11, s11 = x10 * C11 - x11 * C21;
    L s12 = x12 * C25 + x13 * C7, s13 = x12 * C7 - x13 * C25;
    L s14 = x14 * C29 + x15 * C3, s15 = x14 * C3 - x15 * C29;
    x0 = R(s0 + s8), x1 = R(s1 + s9), x2 = R(s2 + s10), x3 = R(s3 + s11);
    x4 = R(s4 + s12), x5 = R(s5 + s13), x6 = R(s6 + s14), x7 = R(s7 + s15);
    x8 = R(s0 - s8), x9 = R(s1 - s9), x10 = R(s2 - s10), x11 = R(s3 - s11);
    x12 = R(s4 - s12), x13 = R(s5 - s13), x14 = R(s6 - s14), x15 = R(s7 - s15);
    // stage 2
    s0 = x0, s1 = x1, s2 = x2, s3 = x3, s4 = x4, s5 = x5, s6 = x6, s7 = x7;
    s8 = x8 * C4 + x9 * C28;
    s9 = x8 * C28 - x9 * C4;
    s10 = x10 * C20 + x11 * C12;
    s11 = x10 * C12 - x11 * C20;
    s12 = -x12 * C28 + x13 * C4;
    s13 = x12 * C4 + x13 * C28;
    s14 = -x14 * C12 + x15 * C20;
    s15 = x14 * C20 + x15 * C12;
    x0 = s0 + s4, x1 = s1 + s5, x2 = s2 + s6, x3 = s3 + s7;
    x4 = s0 - s4, x5 = s1 - s5, x6 = s2 - s6, x7 = s3 - s7;
    x8 = R(s8 + s12), x9 = R(s9 + s13), x10 = R(s10 + s14), x11 = R(s11 + s15);
    x12 = R(s8 - s12), x13 = R(s9 - s13), x14 = R(s10 - s14), x15 = R(s11 - s15);
    // stage 3
    s0 = x0, s1 = x1, s2 = x2, s3 = x3;
    s4 = x4 * C8 + x5 * C24;
    s5 = x4 * C24 - x5 * C8;
    s6 = -x6 * C24 + x7 * C8;
    s7 = x6 * C8 + x7 * C24;
    s8 = x8, s9 = x9, s10 = x10, s11 = x11;
    s12 = x12 * C8 + x13 * C24;
    s13 = x12 * C24 - x13 * C8;
    s14 = -x14 * C24 + x15 * C8;
    s15 = x14 * C8 + x15 * C24;
    x0 = s0 + s2, x1 = s1 + s3, x2 = s0 - s2, x3 = s1 - s3;
    x4 = R(s4 + s6), x5 = R(s5 + s7), x6 = R(s4 - s6), x7 = R(s5 - s7);
    x8 = s8 + s10, x9 = s9 + s11, x10 = s8 - s10, x11 = s9 - s11;
    x12 = R(s12 + s14), x13 = R(s13 + s15), x14 = R(s12 - s14), x15 = R(s13 - s15);
    // stage 4
    s2 = -C16 * (x2 + x3);
    s3 = C16 * (x2 - x3);
    s6 = C16 * (x6 + x7);
    s7 = C16 * (-x6 + x7);
    s10 = C16 * (x10 + x11);
    s11 = C16 * (-x10 + x11);
    s14 = -C16 * (x14 + x15);
    s15 = C16 * (x14 - x15);
    x2 = R(s2), x3 = R(s3), x6 = R(s6), x7 = R(s7);
    x10 = R(s10), x11 = R(s11), x14 = R(s14), x15 = R(s15);
    out[0] = (int)x0;
    out[1] = (int)-x8;
    out[2] = (int)x12;
    out[3] = (int)-x4;
    out[4] = (int)x6;
    out[5] = (int)x14;
    out[6] = (int)x10;
    out[7] = (int)x2;
    out[8] = (int)x3;
    out[9] = (int)x11;
    out[10] = (int)x15;
    out[11] = (int)x7;
    out[12] = (int)x5;
    out[13] = (int)-x13;
    out[14] = (int)x9;
    out[15] = (int)-x1;
}

static void idct32(const int* in, int* out) {
    int a[32], b[32];
    static const int EVEN[16] = {0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30};
    for (int i = 0; i < 16; ++i) a[i] = in[EVEN[i]];
    a[16] = R((L)in[1] * C31 - (L)in[31] * C1);
    a[31] = R((L)in[1] * C1 + (L)in[31] * C31);
    a[17] = R((L)in[17] * C15 - (L)in[15] * C17);
    a[30] = R((L)in[17] * C17 + (L)in[15] * C15);
    a[18] = R((L)in[9] * C23 - (L)in[23] * C9);
    a[29] = R((L)in[9] * C9 + (L)in[23] * C23);
    a[19] = R((L)in[25] * C7 - (L)in[7] * C25);
    a[28] = R((L)in[25] * C25 + (L)in[7] * C7);
    a[20] = R((L)in[5] * C27 - (L)in[27] * C5);
    a[27] = R((L)in[5] * C5 + (L)in[27] * C27);
    a[21] = R((L)in[21] * C11 - (L)in[11] * C21);
    a[26] = R((L)in[21] * C21 + (L)in[11] * C11);
    a[22] = R((L)in[13] * C19 - (L)in[19] * C13);
    a[25] = R((L)in[13] * C13 + (L)in[19] * C19);
    a[23] = R((L)in[29] * C3 - (L)in[3] * C29);
    a[24] = R((L)in[29] * C29 + (L)in[3] * C3);
    // stage 2
    for (int i = 0; i < 8; ++i) b[i] = a[i];
    b[8] = R((L)a[8] * C30 - (L)a[15] * C2);
    b[15] = R((L)a[8] * C2 + (L)a[15] * C30);
    b[9] = R((L)a[9] * C14 - (L)a[14] * C18);
    b[14] = R((L)a[9] * C18 + (L)a[14] * C14);
    b[10] = R((L)a[10] * C22 - (L)a[13] * C10);
    b[13] = R((L)a[10] * C10 + (L)a[13] * C22);
    b[11] = R((L)a[11] * C6 - (L)a[12] * C26);
    b[12] = R((L)a[11] * C26 + (L)a[12] * C6);
    for (int i = 16; i < 32; i += 4) {
        b[i] = a[i] + a[i + 1];
        b[i + 1] = a[i] - a[i + 1];
        b[i + 2] = -a[i + 2] + a[i + 3];
        b[i + 3] = a[i + 2] + a[i + 3];
    }
    // stage 3
    for (int i = 0; i < 4; ++i) a[i] = b[i];
    a[4] = R((L)b[4] * C28 - (L)b[7] * C4);
    a[7] = R((L)b[4] * C4 + (L)b[7] * C28);
    a[5] = R((L)b[5] * C12 - (L)b[6] * C20);
    a[6] = R((L)b[5] * C20 + (L)b[6] * C12);
    a[8] = b[8] + b[9];
    a[9] = b[8] - b[9];
    a[10] = -b[10] + b[11];
    a[11] = b[10] + b[11];
    a[12] = b[12] + b[13];
    a[13] = b[12] - b[13];
    a[14] = -b[14] + b[15];
    a[15] = b[14] + b[15];
    a[16] = b[16];
    a[31] = b[31];
    a[17] = R(-(L)b[17] * C4 + (L)b[30] * C28);
    a[30] = R((L)b[17] * C28 + (L)b[30] * C4);
    a[18] = R(-(L)b[18] * C28 - (L)b[29] * C4);
    a[29] = R(-(L)b[18] * C4 + (L)b[29] * C28);
    a[19] = b[19];
    a[20] = b[20];
    a[21] = R(-(L)b[21] * C20 + (L)b[26] * C12);
    a[26] = R((L)b[21] * C12 + (L)b[26] * C20);
    a[22] = R(-(L)b[22] * C12 - (L)b[25] * C20);
    a[25] = R(-(L)b[22] * C20 + (L)b[25] * C12);
    a[23] = b[23];
    a[24] = b[24];
    a[27] = b[27];
    a[28] = b[28];
    // stage 4
    b[0] = R((L)(a[0] + a[1]) * C16);
    b[1] = R((L)(a[0] - a[1]) * C16);
    b[2] = R((L)a[2] * C24 - (L)a[3] * C8);
    b[3] = R((L)a[2] * C8 + (L)a[3] * C24);
    b[4] = a[4] + a[5];
    b[5] = a[4] - a[5];
    b[6] = -a[6] + a[7];
    b[7] = a[6] + a[7];
    b[8] = a[8];
    b[15] = a[15];
    b[9] = R(-(L)a[9] * C8 + (L)a[14] * C24);
    b[14] = R((L)a[9] * C24 + (L)a[14] * C8);
    b[10] = R(-(L)a[10] * C24 - (L)a[13] * C8);
    b[13] = R(-(L)a[10] * C8 + (L)a[13] * C24);
    b[11] = a[11];
    b[12] = a[12];
    b[16] = a[16] + a[19];
    b[17] = a[17] + a[18];
    b[18] = a[17] - a[18];
    b[19] = a[16] - a[19];
    b[20] = -a[20] + a[23];
    b[21] = -a[21] + a[22];
    b[22] = a[21] + a[22];
    b[23] = a[20] + a[23];
    b[24] = a[24] + a[27];
    b[25] = a[25] + a[26];
    b[26] = a[25] - a[26];
    b[27] = a[24] - a[27];
    b[28] = -a[28] + a[31];
    b[29] = -a[29] + a[30];
    b[30] = a[29] + a[30];
    b[31] = a[28] + a[31];
    // stage 5
    a[0] = b[0] + b[3];
    a[1] = b[1] + b[2];
    a[2] = b[1] - b[2];
    a[3] = b[0] - b[3];
    a[4] = b[4];
    a[5] = R((L)(b[6] - b[5]) * C16);
    a[6] = R((L)(b[5] + b[6]) * C16);
    a[7] = b[7];
    a[8] = b[8] + b[11];
    a[9] = b[9] + b[10];
    a[10] = b[9] - b[10];
    a[11] = b[8] - b[11];
    a[12] = -b[12] + b[15];
    a[13] = -b[13] + b[14];
    a[14] = b[13] + b[14];
    a[15] = b[12] + b[15];
    a[16] = b[16];
    a[17] = b[17];
    a[18] = R(-(L)b[18] * C8 + (L)b[29] * C24);
    a[29] = R((L)b[18] * C24 + (L)b[29] * C8);
    a[19] = R(-(L)b[19] * C8 + (L)b[28] * C24);
    a[28] = R((L)b[19] * C24 + (L)b[28] * C8);
    a[20] = R(-(L)b[20] * C24 - (L)b[27] * C8);
    a[27] = R(-(L)b[20] * C8 + (L)b[27] * C24);
    a[21] = R(-(L)b[21] * C24 - (L)b[26] * C8);
    a[26] = R(-(L)b[21] * C8 + (L)b[26] * C24);
    a[22] = b[22];
    a[23] = b[23];
    a[24] = b[24];
    a[25] = b[25];
    a[30] = b[30];
    a[31] = b[31];
    // stage 6
    for (int i = 0; i < 4; ++i) {
        b[i] = a[i] + a[7 - i];
        b[7 - i] = a[i] - a[7 - i];
    }
    b[8] = a[8];
    b[9] = a[9];
    b[10] = R((L)(-a[10] + a[13]) * C16);
    b[13] = R((L)(a[10] + a[13]) * C16);
    b[11] = R((L)(-a[11] + a[12]) * C16);
    b[12] = R((L)(a[11] + a[12]) * C16);
    b[14] = a[14];
    b[15] = a[15];
    for (int i = 0; i < 4; ++i) {
        b[16 + i] = a[16 + i] + a[23 - i];
        b[23 - i] = a[16 + i] - a[23 - i];
        b[24 + i] = -a[24 + i] + a[31 - i];
        b[31 - i] = a[24 + i] + a[31 - i];
    }
    // stage 7
    for (int i = 0; i < 8; ++i) {
        a[i] = b[i] + b[15 - i];
        a[15 - i] = b[i] - b[15 - i];
    }
    for (int i = 16; i < 20; ++i) a[i] = b[i];
    for (int i = 0; i < 4; ++i) {
        a[20 + i] = R((L)(-b[20 + i] + b[27 - i]) * C16);
        a[27 - i] = R((L)(b[20 + i] + b[27 - i]) * C16);
    }
    for (int i = 28; i < 32; ++i) a[i] = b[i];
    for (int i = 0; i < 16; ++i) {
        out[i] = a[i] + a[31 - i];
        out[31 - i] = a[i] - a[31 - i];
    }
}

static void iwht4(const int* in, int* out, int shift) {
    int t0 = in[0] >> shift, t1 = in[3] >> shift, t2 = in[1] >> shift, t3 = in[2] >> shift;
    t0 += t2;
    t3 -= t1;
    int t4 = (t0 - t3) >> 1;
    t1 = t4 - t1;
    t2 = t4 - t2;
    t0 -= t1;
    t3 += t2;
    out[0] = t0;
    out[1] = t1;
    out[2] = t2;
    out[3] = t3;
}

typedef void (*Tx1d)(const int*, int*);

// coef: raster (row-major) dequantised coefficients of an n x n block; adds
// the inverse transform to dst. type: DCT_DCT .. ADST_ADST (vertical,
// horizontal), or 4 for the lossless WHT
static void inverse_transform_add(int* coef, int tx, int type, uint8_t* dst, int stride,
                                  int eob) {
    int n = 4 << tx;
    if (type == 4) {
        int tmp[16], in[4], out[4];
        for (int i = 0; i < 4; ++i) iwht4(coef + 4 * i, tmp + 4 * i, 2);
        for (int j = 0; j < 4; ++j) {
            for (int i = 0; i < 4; ++i) in[i] = tmp[4 * i + j];
            iwht4(in, out, 0);
            for (int i = 0; i < 4; ++i) dst[i * stride + j] = clip8(dst[i * stride + j] + out[i]);
        }
        return;
    }
    int shift = tx == 0 ? 4 : tx == 1 ? 5 : 6;
    if (type == DCT_DCT && eob == 1) {
        int t = R((L)R((L)coef[0] * C16) * C16);
        int v = (t + (1 << (shift - 1))) >> shift;
        for (int i = 0; i < n; ++i)
            for (int j = 0; j < n; ++j) dst[i * stride + j] = clip8(dst[i * stride + j] + v);
        return;
    }
    static const Tx1d DCTS[4] = {idct4, idct8, idct16, idct32};
    static const Tx1d ADSTS[3] = {iadst4, iadst8, iadst16};
    Tx1d rows = (type == DCT_ADST || type == ADST_ADST) ? ADSTS[tx] : DCTS[tx];
    Tx1d cols = (type == ADST_DCT || type == ADST_ADST) ? ADSTS[tx] : DCTS[tx];
    int tmp[1024], in[32], out[32];
    for (int i = 0; i < n; ++i) rows(coef + n * i, tmp + n * i);
    for (int j = 0; j < n; ++j) {
        for (int i = 0; i < n; ++i) in[i] = tmp[n * i + j];
        cols(in, out);
        for (int i = 0; i < n; ++i)
            dst[i * stride + j] = clip8(dst[i * stride + j] + ((out[i] + (1 << (shift - 1))) >> shift));
    }
}

// ── intra prediction (the specification's edges, libvpx's predictors) ───

// above[-1 .. 2n-1], left[0 .. n-1]
static void intra_predict(int mode, int n, const uint8_t* above, const uint8_t* left,
                          bool have_above, bool have_left, uint8_t* dst, int stride) {
    switch (mode) {
    case DC_PRED: {
        int sum = 0, cnt = 0;
        if (have_above) { for (int i = 0; i < n; ++i) sum += above[i]; cnt += n; }
        if (have_left) { for (int i = 0; i < n; ++i) sum += left[i]; cnt += n; }
        int v = cnt ? (sum + cnt / 2) / cnt : 128;
        for (int r = 0; r < n; ++r) memset(dst + r * stride, v, n);
        break;
    }
    case V_PRED:
        for (int r = 0; r < n; ++r) memcpy(dst + r * stride, above, n);
        break;
    case H_PRED:
        for (int r = 0; r < n; ++r) memset(dst + r * stride, left[r], n);
        break;
    case TM_PRED:
        for (int r = 0; r < n; ++r)
            for (int c = 0; c < n; ++c) dst[r * stride + c] = clip8(left[r] + above[c] - above[-1]);
        break;
    case D45_PRED:
        for (int r = 0; r < n; ++r)
            for (int c = 0; c < n; ++c)
                dst[r * stride + c] = (r + c + 2 < 2 * n)
                    ? (uint8_t)((above[r + c] + 2 * above[r + c + 1] + above[r + c + 2] + 2) >> 2)
                    : above[2 * n - 1];
        break;
    case D135_PRED: {
        // edge[0..2n]: left reversed, corner, above
        uint8_t e[65];
        for (int i = 0; i < n; ++i) e[i] = left[n - 1 - i];
        e[n] = above[-1];
        for (int i = 0; i < n; ++i) e[n + 1 + i] = above[i];
        uint8_t f[65];
        for (int i = 1; i < 2 * n; ++i) f[i] = (uint8_t)((e[i - 1] + 2 * e[i] + e[i + 1] + 2) >> 2);
        for (int r = 0; r < n; ++r)
            for (int c = 0; c < n; ++c) dst[r * stride + c] = f[n - r + c];
        break;
    }
    case D117_PRED:
        {
            // libvpx d117: row 0 averages of two, row 1 averages of three,
            // the left column from the left edge, then each row two rows up
            // shifted right by one
            for (int c = 0; c < n; ++c) dst[c] = (uint8_t)((above[c - 1] + above[c] + 1) >> 1);
            dst[stride] = (uint8_t)((left[0] + 2 * above[-1] + above[0] + 2) >> 2);
            for (int c = 1; c < n; ++c)
                dst[stride + c] = (uint8_t)((above[c - 2] + 2 * above[c - 1] + above[c] + 2) >> 2);
            dst[2 * stride] = (uint8_t)((above[-1] + 2 * left[0] + left[1] + 2) >> 2);
            for (int r = 3; r < n; ++r)
                dst[r * stride] = (uint8_t)((left[r - 3] + 2 * left[r - 2] + left[r - 1] + 2) >> 2);
            for (int r = 2; r < n; ++r)
                for (int c = 1; c < n; ++c) dst[r * stride + c] = dst[(r - 2) * stride + c - 1];
        }
        break;
    case D153_PRED: {
        dst[0] = (uint8_t)((left[0] + above[-1] + 1) >> 1);
        for (int r = 1; r < n; ++r) dst[r * stride] = (uint8_t)((left[r - 1] + left[r] + 1) >> 1);
        dst[1] = (uint8_t)((left[0] + 2 * above[-1] + above[0] + 2) >> 2);
        dst[stride + 1] = (uint8_t)((above[-1] + 2 * left[0] + left[1] + 2) >> 2);
        for (int r = 2; r < n; ++r)
            dst[r * stride + 1] = (uint8_t)((left[r - 2] + 2 * left[r - 1] + left[r] + 2) >> 2);
        for (int c = 0; c < n - 2; ++c)
            dst[2 + c] = (uint8_t)((above[c - 1] + 2 * above[c] + above[c + 1] + 2) >> 2);
        for (int r = 1; r < n; ++r)
            for (int c = 2; c < n; ++c) dst[r * stride + c] = dst[(r - 1) * stride + c - 2];
        break;
    }
    case D207_PRED: {
        // column 0: averages of two down the left edge, column 1 of three
        for (int r = 0; r < n - 1; ++r) dst[r * stride] = (uint8_t)((left[r] + left[r + 1] + 1) >> 1);
        dst[(n - 1) * stride] = left[n - 1];
        for (int r = 0; r < n - 2; ++r)
            dst[r * stride + 1] = (uint8_t)((left[r] + 2 * left[r + 1] + left[r + 2] + 2) >> 2);
        dst[(n - 2) * stride + 1] = (uint8_t)((left[n - 2] + 3 * left[n - 1] + 2) >> 2);
        dst[(n - 1) * stride + 1] = left[n - 1];
        for (int c = 0; c < n - 2; ++c) dst[(n - 1) * stride + 2 + c] = left[n - 1];
        for (int r = n - 2; r >= 0; --r)
            for (int c = 0; c < n - 2; ++c) dst[r * stride + 2 + c] = dst[(r + 1) * stride + c];
        break;
    }
    case D63_PRED:
        for (int r = 0; r < n; ++r)
            for (int c = 0; c < n; ++c) {
                int i = (r >> 1) + c;
                dst[r * stride + c] = (r & 1)
                    ? (uint8_t)((above[i] + 2 * above[i + 1] + above[i + 2] + 2) >> 2)
                    : (uint8_t)((above[i] + above[i + 1] + 1) >> 1);
            }
        break;
    }
}

// ── motion compensation ─────────────────────────────────────────────────

// a w x h block at (x, y) (whole pixels) plus frac (sixteenths) of a plane
// of visible size pw x ph, filtered with kernel; reads outside the plane
// take its nearest visible pixel
static void predict_block(const uint8_t* ref, int stride, int pw, int ph, int x, int y, int fx,
                          int fy, int w, int h, const int16_t* kernel, uint8_t* dst,
                          int dst_stride) {
    uint8_t win[(64 + 7) * (64 + 7)];
    int ww = w + 7, wh = h + 7;
    for (int r = 0; r < wh; ++r) {
        int yy = clamp(y - 3 + r, 0, ph - 1);
        const uint8_t* row = ref + (size_t)yy * stride;
        uint8_t* o = win + r * ww;
        int x0 = x - 3;
        if (x0 >= 0 && x0 + ww <= pw) {
            memcpy(o, row + x0, ww);
        } else {
            for (int c = 0; c < ww; ++c) o[c] = row[clamp(x0 + c, 0, pw - 1)];
        }
    }
    const int16_t* kx = kernel + 8 * fx;
    const int16_t* ky = kernel + 8 * fy;
    if (!fx && !fy) {
        for (int r = 0; r < h; ++r) memcpy(dst + r * dst_stride, win + (r + 3) * ww + 3, w);
        return;
    }
    if (fx && !fy) {
        for (int r = 0; r < h; ++r) {
            const uint8_t* s = win + (r + 3) * ww;
            for (int c = 0; c < w; ++c) {
                int sum = 0;
                for (int k = 0; k < 8; ++k) sum += kx[k] * s[c + k];
                dst[r * dst_stride + c] = clip8((sum + 64) >> 7);
            }
        }
        return;
    }
    if (!fx) {
        for (int r = 0; r < h; ++r)
            for (int c = 0; c < w; ++c) {
                int sum = 0;
                for (int k = 0; k < 8; ++k) sum += ky[k] * win[(r + k) * ww + c + 3];
                dst[r * dst_stride + c] = clip8((sum + 64) >> 7);
            }
        return;
    }
    uint8_t tmp[(64 + 7) * 64];
    for (int r = 0; r < wh; ++r) {
        const uint8_t* s = win + r * ww;
        for (int c = 0; c < w; ++c) {
            int sum = 0;
            for (int k = 0; k < 8; ++k) sum += kx[k] * s[c + k];
            tmp[r * w + c] = clip8((sum + 64) >> 7);
        }
    }
    for (int r = 0; r < h; ++r)
        for (int c = 0; c < w; ++c) {
            int sum = 0;
            for (int k = 0; k < 8; ++k) sum += ky[k] * tmp[(r + k) * w + c];
            dst[r * dst_stride + c] = clip8((sum + 64) >> 7);
        }
}

// ── the loop filter's arithmetic (FFmpeg's loop_filter, 8 pixels) ───────

// filter 8 pixels of an edge: dst the first q0, step along the edge
// `along`, across it `across`; wd 4, 8 or 16
static void loop_filter(uint8_t* dst, int E, int I, int H, ptrdiff_t along, ptrdiff_t across,
                        int wd) {
    for (int i = 0; i < 8; ++i, dst += along) {
        int p3 = dst[across * -4], p2 = dst[across * -3], p1 = dst[across * -2],
            p0 = dst[across * -1];
        int q0 = dst[0], q1 = dst[across], q2 = dst[across * 2], q3 = dst[across * 3];
        int fm = abs(p3 - p2) <= I && abs(p2 - p1) <= I && abs(p1 - p0) <= I &&
                 abs(q1 - q0) <= I && abs(q2 - q1) <= I && abs(q3 - q2) <= I &&
                 abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= E;
        if (!fm) continue;
        int p7 = 0, p6 = 0, p5 = 0, p4 = 0, q4 = 0, q5 = 0, q6 = 0, q7 = 0;
        int flat8out = 0, flat8in = 0;
        if (wd >= 16) {
            p7 = dst[across * -8], p6 = dst[across * -7], p5 = dst[across * -6];
            p4 = dst[across * -5], q4 = dst[across * 4], q5 = dst[across * 5];
            q6 = dst[across * 6], q7 = dst[across * 7];
            flat8out = abs(p7 - p0) <= 1 && abs(p6 - p0) <= 1 && abs(p5 - p0) <= 1 &&
                       abs(p4 - p0) <= 1 && abs(q4 - q0) <= 1 && abs(q5 - q0) <= 1 &&
                       abs(q6 - q0) <= 1 && abs(q7 - q0) <= 1;
        }
        if (wd >= 8)
            flat8in = abs(p3 - p0) <= 1 && abs(p2 - p0) <= 1 && abs(p1 - p0) <= 1 &&
                      abs(q1 - q0) <= 1 && abs(q2 - q0) <= 1 && abs(q3 - q0) <= 1;
        if (wd >= 16 && flat8out && flat8in) {
            dst[across * -7] = (p7 * 7 + p6 * 2 + p5 + p4 + p3 + p2 + p1 + p0 + q0 + 8) >> 4;
            dst[across * -6] = (p7 * 6 + p6 + p5 * 2 + p4 + p3 + p2 + p1 + p0 + q0 + q1 + 8) >> 4;
            dst[across * -5] = (p7 * 5 + p6 + p5 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + q1 + q2 + 8) >> 4;
            dst[across * -4] = (p7 * 4 + p6 + p5 + p4 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + q2 + q3 + 8) >> 4;
            dst[across * -3] = (p7 * 3 + p6 + p5 + p4 + p3 + p2 * 2 + p1 + p0 + q0 + q1 + q2 + q3 + q4 + 8) >> 4;
            dst[across * -2] = (p7 * 2 + p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 + q0 + q1 + q2 + q3 + q4 + q5 + 8) >> 4;
            dst[across * -1] = (p7 + p6 + p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2 + q3 + q4 + q5 + q6 + 8) >> 4;
            dst[0] = (p6 + p5 + p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3 + q4 + q5 + q6 + q7 + 8) >> 4;
            dst[across] = (p5 + p4 + p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 + q3 + q4 + q5 + q6 + q7 * 2 + 8) >> 4;
            dst[across * 2] = (p4 + p3 + p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 + q4 + q5 + q6 + q7 * 3 + 8) >> 4;
            dst[across * 3] = (p3 + p2 + p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 + q5 + q6 + q7 * 4 + 8) >> 4;
            dst[across * 4] = (p2 + p1 + p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 + q6 + q7 * 5 + 8) >> 4;
            dst[across * 5] = (p1 + p0 + q0 + q1 + q2 + q3 + q4 + q5 * 2 + q6 + q7 * 6 + 8) >> 4;
            dst[across * 6] = (p0 + q0 + q1 + q2 + q3 + q4 + q5 + q6 * 2 + q7 * 7 + 8) >> 4;
        } else if (wd >= 8 && flat8in) {
            dst[across * -3] = (p3 * 3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3;
            dst[across * -2] = (p3 * 2 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3;
            dst[across * -1] = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3;
            dst[0] = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3;
            dst[across] = (p1 + p0 + q0 + 2 * q1 + q2 + q3 * 2 + 4) >> 3;
            dst[across * 2] = (p0 + q0 + q1 + 2 * q2 + q3 * 3 + 4) >> 3;
        } else {
            int hev = abs(p1 - p0) > H || abs(q1 - q0) > H;
            if (hev) {
                int f = clamp(p1 - q1, -128, 127);
                f = clamp(3 * (q0 - p0) + f, -128, 127);
                int f1 = std::min(f + 4, 127) >> 3, f2 = std::min(f + 3, 127) >> 3;
                dst[across * -1] = clip8(p0 + f2);
                dst[0] = clip8(q0 - f1);
            } else {
                int f = clamp(3 * (q0 - p0), -128, 127);
                int f1 = std::min(f + 4, 127) >> 3, f2 = std::min(f + 3, 127) >> 3;
                dst[across * -1] = clip8(p0 + f2);
                dst[0] = clip8(q0 - f1);
                f = (f1 + 1) >> 1;
                dst[across * -2] = clip8(p1 + f);
                dst[across] = clip8(q1 - f);
            }
        }
    }
}


// ── probabilities and counts ────────────────────────────────────────────

// a motion vector component's probabilities, as MV_COMP_PROBS lays them out
enum { MV_SIGN = 0, MV_CLASSES = 1, MV_CLASS0 = 11, MV_BITS = 12, MV_CLASS0_FP = 22, MV_FP = 28,
       MV_CLASS0_HP = 31, MV_HP = 32, MV_PROBS = 33 };

struct ProbCtx {
    uint8_t coef[4][2][2][6][6][3];
    uint8_t y_mode[4][9], uv_mode[10][9], filter[4][2], inter_mode[7][3], is_inter[4];
    uint8_t comp_mode[5], single_ref[5][2], comp_ref[5];
    uint8_t tx8[2][1], tx16[2][2], tx32[2][3], skip[3], partition[16][3];
    uint8_t mv_joint[3], mv[2][MV_PROBS];
};

struct MvCounts {
    unsigned sign[2], classes[11], class0[2], bits[10][2], class0_fp[2][4], fp[4], class0_hp[2],
        hp[2];
};

struct Counts {
    unsigned coef[4][2][2][6][6][3];
    unsigned eob[4][2][2][6][6][2];
    unsigned y_mode[4][10], uv_mode[10][10], filter[4][3], inter_mode[7][4], is_inter[4][2];
    unsigned comp_mode[5][2], single_ref[5][2][2], comp_ref[5][2];
    unsigned tx8[2][2], tx16[2][3], tx32[2][4], skip[3][2], partition[16][4];
    unsigned mv_joint[4];
    MvCounts mv[2];
};

static void default_probs(ProbCtx& p) {
    memcpy(p.coef, COEF_PROBS, sizeof(p.coef));
    memcpy(p.y_mode, YMODE_PROBS, sizeof(p.y_mode));
    memcpy(p.uv_mode, UV_MODE_PROBS, sizeof(p.uv_mode));
    memcpy(p.filter, INTERP_FILTER_PROBS, sizeof(p.filter));
    memcpy(p.inter_mode, INTER_MODE_PROBS, sizeof(p.inter_mode));
    memcpy(p.is_inter, IS_INTER_PROBS, sizeof(p.is_inter));
    memcpy(p.comp_mode, COMP_MODE_PROBS, sizeof(p.comp_mode));
    memcpy(p.single_ref, SINGLE_REF_PROBS, sizeof(p.single_ref));
    memcpy(p.comp_ref, COMP_REF_PROBS, sizeof(p.comp_ref));
    memcpy(p.tx8, TX_PROBS_8X8, sizeof(p.tx8));
    memcpy(p.tx16, TX_PROBS_16X16, sizeof(p.tx16));
    memcpy(p.tx32, TX_PROBS_32X32, sizeof(p.tx32));
    memcpy(p.skip, SKIP_PROBS, sizeof(p.skip));
    memcpy(p.partition, PARTITION_PROBS, sizeof(p.partition));
    memcpy(p.mv_joint, MV_JOINT_PROBS, sizeof(p.mv_joint));
    memcpy(p.mv, MV_COMP_PROBS, sizeof(p.mv));
}

// libvpx's merge_probs: pre moved toward the counts' binary probability
static uint8_t merge_prob(uint8_t pre, unsigned ct0, unsigned ct1, unsigned sat, unsigned factor) {
    unsigned den = ct0 + ct1;
    if (!den) return pre;
    unsigned count = std::min(den, sat);
    unsigned f = factor * count / sat;
    int p = (int)(((uint64_t)ct0 * 256 + (den >> 1)) / den);
    p = clamp(p, 1, 255);
    return (uint8_t)((pre * (256 - f) + p * f + 128) >> 8);
}

// libvpx's tree_merge_probs over a tree, at the mode and vector rates
static unsigned tree_merge(const int8_t* tree, int i, const uint8_t* pre, const unsigned* counts,
                           uint8_t* out) {
    int l = tree[i], r = tree[i + 1];
    unsigned lc = l <= 0 ? counts[-l] : tree_merge(tree, l, pre, counts, out);
    unsigned rc = r <= 0 ? counts[-r] : tree_merge(tree, r, pre, counts, out);
    out[i >> 1] = merge_prob(pre[i >> 1], lc, rc, 20, 128);
    return lc + rc;
}

// ── frames ──────────────────────────────────────────────────────────────

struct MvPair {
    int8_t ref[2];           // LAST .. ALTREF, INTRA_FRAME or NONE
    int16_t mv[2][2];        // (row, col), eighths of a pixel
};

struct Frame {
    int w = 0, h = 0, mi_cols = 0, mi_rows = 0, sb_cols = 0, sb_rows = 0;
    int stride[3] = {0, 0, 0}, pw[3] = {0, 0, 0}, ph[3] = {0, 0, 0};
    std::vector<uint8_t> plane[3];
    std::vector<MvPair> mvs;             // by 8x8 block, for the next frame's candidates
    std::vector<uint8_t> segmap;         // by 8x8 block
    int colour_space = 0, full_range = 0;

    void alloc(int width, int height) {
        w = width, h = height;
        mi_cols = (w + 7) >> 3, mi_rows = (h + 7) >> 3;
        sb_cols = (mi_cols + 7) >> 3, sb_rows = (mi_rows + 7) >> 3;
        for (int p = 0; p < 3; ++p) {
            int sh = p ? 1 : 0;
            stride[p] = (sb_cols * 64) >> sh;
            int rows = (sb_rows * 64) >> sh;
            plane[p].assign((size_t)stride[p] * rows, 0);
            pw[p] = (w + sh) >> sh;
            ph[p] = (h + sh) >> sh;
        }
        mvs.assign((size_t)mi_cols * mi_rows, MvPair{{0, -1}, {{0, 0}, {0, 0}}});
        segmap.assign((size_t)mi_cols * mi_rows, 0);
    }
};
typedef std::shared_ptr<Frame> FramePtr;

// one 8x8 block's mode info, kept for its neighbours
struct MI {
    uint8_t sb_type, skip, tx_size, seg_id, seg_pred, interp_filter, uv_mode;
    int8_t ref[2];
    uint8_t mode;             // y mode or inter mode (the last sub-block's below 8x8)
    uint8_t sub_modes[4];     // intra sub-block modes below 8x8, else the mode
    int16_t mv[2][2];         // the block's (the last sub-block's)
    int16_t bmv[4][2][2];     // sub-block vectors below 8x8
    bool is_inter() const { return ref[0] > INTRA_FRAME; }
    bool is_comp() const { return ref[1] > INTRA_FRAME; }
};

struct SegFeature {
    int q_enabled, q_val, lf_enabled, lf_val, ref_enabled, ref_val, skip_enabled;
};

struct Header {
    int profile = 0, show_existing = 0, existing_idx = 0, keyframe = 0, show_frame = 0;
    int error_res = 0, intra_only = 0, reset_ctx = 0, refresh_flags = 0;
    int ref_idx[3] = {0, 0, 0}, sign_bias[4] = {0, 0, 0, 0};
    int allow_hp = 0, interp_filter = 0, refresh_ctx = 0, parallel = 0, ctx_idx = 0, ctx_read = 0;
    int lf_level = 0, sharpness = 0, lf_delta_enabled = 0;
    int base_q = 0, dq_y_dc = 0, dq_uv_dc = 0, dq_uv_ac = 0, lossless = 0;
    int seg_enabled = 0, seg_update_map = 0, seg_temporal = 0, seg_update_data = 0;
    int tile_cols_log2 = 0, tile_rows_log2 = 0, compressed_size = 0;
    int tx_mode = 0, comp_mode = SINGLE_REF, comp_fixed_ref = 0, comp_var_ref[2] = {0, 0};
    int colour_space = 0, full_range = 0, width = 0, height = 0;
};

// what a decode of one frame gives, for probing
struct Probe {
    int error = 0;                   // 0, or why FFmpeg fails on it (see vp9.py)
    int profile = 0, show_existing = 0, existing_idx = 0, keyframe = 0, intra_only = 0;
    int show_frame = 0, width = 0, height = 0, colour_space = 0, full_range = 0;
    int refresh_flags = 0, ref_idx[3] = {0, 0, 0}, error_res = 0;
    int found_ref = -1;
    int header_bytes = 0, compressed_size = 0, tile_cols_log2 = 0, tile_rows_log2 = 0;
};

// ── the decoder ─────────────────────────────────────────────────────────

struct LfSb {
    uint8_t level[64];
    uint8_t mask[2][2][8][4];   // luma / chroma, vertical / horizontal edges, row, kind
};

template <class Src>
struct Decoder {
    Src& src;
    Header hd;
    ProbCtx ctx[4], fc;
    Counts counts;
    FramePtr refs[8], cur, last, segmap_ref, shown;
    int last_keyframe = 0, invisible = 0, use_prev_mvs = 0;
    int lf_ref_deltas[4] = {1, 0, -1, -1}, lf_mode_deltas[2] = {0, 0};
    SegFeature feat[8] = {};
    int seg_abs = 0;
    uint8_t seg_tree_probs[7] = {255, 255, 255, 255, 255, 255, 255}, seg_pred_probs[3] = {255, 255, 255};
    Probe probe;

    // the frame being decoded
    int mi_cols = 0, mi_rows = 0, sb_cols = 0, sb_rows = 0;
    std::vector<MI> mi;
    std::vector<uint8_t> above_part, above_segpred, above_nnz[3];
    uint8_t left_part[8], left_segpred[8], left_nnz[3][16];
    int tile_col_start = 0, tile_col_end = 0;
    std::vector<LfSb> lf;
    int qmul[8][2][2];               // segment, plane type, dc / ac
    uint8_t lflvl[8][4][2];          // segment, reference (intra first), mode != ZEROMV
    uint8_t lim_lut[64], mblim_lut[64];
    int coef_buf[32 * 32];
    int eob_total = 0;

    explicit Decoder(Src& s) : src(s) {
        for (auto& c : ctx) default_probs(c);
        default_probs(fc);
        memset(&counts, 0, sizeof(counts));
    }

    [[noreturn]] void fail(const std::string& why) { throw DecodeError(why); }

    int f(int n, int k) { return src.f(n, k); }
    int sbits(int n, int k, int ks) {
        int v = f(n, k);
        return f(1, ks) ? -v : v;
    }

    // ── the uncompressed header ─────────────────────────────────────────
    // returns 1 where the frame shows an existing one, else 0
    int read_uncompressed_header() {
        Header& h = hd;
        if (f(2, K_MARKER) != 2) { probe.error = 1; fail("VP9: invalid frame marker"); }
        h.profile = f(1, K_PROFILE_LOW);
        h.profile |= f(1, K_PROFILE_HIGH) << 1;
        if (h.profile == 3) h.profile += f(1, K_RESERVED);
        probe.profile = h.profile;
        if (h.profile > 3) { probe.error = 2; fail("VP9: profile 4 or more"); }
        if (h.profile != 0) { probe.error = 3; fail("VP9: profile " + std::to_string(h.profile)); }
        h.show_existing = f(1, K_SHOW_EXISTING);
        probe.show_existing = h.show_existing;
        if (h.show_existing) {
            h.existing_idx = f(3, K_EXISTING_IDX);
            probe.existing_idx = h.existing_idx;
            return 1;
        }
        last_keyframe = h.keyframe;
        h.keyframe = !f(1, K_FRAME_TYPE);
        int last_invisible = invisible;
        h.show_frame = f(1, K_SHOW_FRAME);
        invisible = !h.show_frame;
        h.error_res = f(1, K_ERROR_RES);
        probe.keyframe = h.keyframe, probe.show_frame = h.show_frame, probe.error_res = h.error_res;
        use_prev_mvs = !h.error_res && !last_invisible;
        h.intra_only = 0;
        int w = 0, hh = 0;
        if (h.keyframe) {
            if (f(24, K_SYNC) != 0x498342) { probe.error = 4; fail("VP9: invalid sync code"); }
            read_colour();
            h.refresh_flags = 0xff;
            w = f(16, K_WIDTH) + 1;
            hh = f(16, K_HEIGHT) + 1;
            if (f(1, K_RENDER_DIFF)) f(32, K_RENDER_SIZE);
        } else {
            h.intra_only = invisible ? f(1, K_INTRA_ONLY) : 0;
            h.reset_ctx = h.error_res ? 0 : f(2, K_RESET_CTX);
            probe.intra_only = h.intra_only;
            if (h.intra_only) {
                if (f(24, K_SYNC) != 0x498342) { probe.error = 4; fail("VP9: invalid sync code"); }
                // profile 0: BT.601, limited range, 4:2:0 at 8 bits
                h.colour_space = 1;
                h.full_range = 0;
                h.refresh_flags = f(8, K_REFRESH_FLAGS);
                w = f(16, K_WIDTH) + 1;
                hh = f(16, K_HEIGHT) + 1;
                if (f(1, K_RENDER_DIFF)) f(32, K_RENDER_SIZE);
            } else {
                h.refresh_flags = f(8, K_REFRESH_FLAGS);
                for (int i = 0; i < 3; ++i) {
                    h.ref_idx[i] = f(3, K_REF_IDX);
                    h.sign_bias[LAST_FRAME + i] = f(1, K_SIGN_BIAS) && !h.error_res;
                    probe.ref_idx[i] = h.ref_idx[i];
                }
                for (int i = 0; i < 3; ++i)
                    if (!refs[h.ref_idx[i]]) {
                        probe.error = 5;
                        fail("VP9: a reference it names was never decoded");
                    }
                int found = -1;
                for (int i = 0; i < 3; ++i)
                    if (f(1, K_FOUND_REF)) { found = i; break; }
                probe.found_ref = found;
                if (found >= 0) {
                    w = refs[h.ref_idx[found]]->w;
                    hh = refs[h.ref_idx[found]]->h;
                } else {
                    w = f(16, K_WIDTH) + 1;
                    hh = f(16, K_HEIGHT) + 1;
                }
                if (!(last && last->w == w && last->h == hh)) use_prev_mvs = 0;
                if (f(1, K_RENDER_DIFF)) f(32, K_RENDER_SIZE);
                h.allow_hp = f(1, K_HP);
                h.interp_filter = f(1, K_FILTER_SWITCHABLE) ? SWITCHABLE
                                                            : LITERAL_TO_FILTER[f(2, K_FILTER_LITERAL)];
                int sb = h.sign_bias[LAST_FRAME];
                bool comp = sb != h.sign_bias[GOLDEN_FRAME] || sb != h.sign_bias[ALTREF_FRAME];
                h.comp_fixed_ref = 0;
                if (comp) {
                    if (sb == h.sign_bias[GOLDEN_FRAME]) {
                        h.comp_fixed_ref = ALTREF_FRAME;
                        h.comp_var_ref[0] = LAST_FRAME, h.comp_var_ref[1] = GOLDEN_FRAME;
                    } else if (sb == h.sign_bias[ALTREF_FRAME]) {
                        h.comp_fixed_ref = GOLDEN_FRAME;
                        h.comp_var_ref[0] = LAST_FRAME, h.comp_var_ref[1] = ALTREF_FRAME;
                    } else {
                        h.comp_fixed_ref = LAST_FRAME;
                        h.comp_var_ref[0] = GOLDEN_FRAME, h.comp_var_ref[1] = ALTREF_FRAME;
                    }
                }
            }
        }
        h.width = w, h.height = hh;
        probe.width = w, probe.height = hh;
        probe.refresh_flags = h.refresh_flags;
        if (h.keyframe || h.intra_only) {
            for (int i = 1; i < 4; ++i) h.sign_bias[i] = 0;
        }
        h.refresh_ctx = h.error_res ? 0 : f(1, K_REFRESH_CTX);
        h.parallel = h.error_res ? 1 : f(1, K_PARALLEL);
        h.ctx_read = f(2, K_CTX_IDX);
        h.ctx_idx = (h.keyframe || h.intra_only) ? 0 : h.ctx_read;
        if (h.keyframe || h.error_res || h.intra_only) {
            lf_ref_deltas[0] = 1, lf_ref_deltas[1] = 0, lf_ref_deltas[2] = -1, lf_ref_deltas[3] = -1;
            lf_mode_deltas[0] = lf_mode_deltas[1] = 0;
            memset(feat, 0, sizeof(feat));
        }
        // the loop filter
        h.lf_level = f(6, K_LF_LEVEL);
        h.sharpness = f(3, K_SHARPNESS);
        h.lf_delta_enabled = f(1, K_LF_DELTA_ENABLED);
        if (h.lf_delta_enabled && f(1, K_LF_DELTA_UPDATE)) {
            for (int i = 0; i < 4; ++i)
                if (f(1, K_LF_UPDATE)) lf_ref_deltas[i] = sbits(6, K_LF_VALUE, K_LF_SIGN);
            for (int i = 0; i < 2; ++i)
                if (f(1, K_LF_UPDATE)) lf_mode_deltas[i] = sbits(6, K_LF_VALUE, K_LF_SIGN);
        }
        // the quantiser
        h.base_q = f(8, K_BASE_Q);
        h.dq_y_dc = f(1, K_DELTA_Q_CODED) ? sbits(4, K_DELTA_Q, K_DELTA_Q_SIGN) : 0;
        h.dq_uv_dc = f(1, K_DELTA_Q_CODED) ? sbits(4, K_DELTA_Q, K_DELTA_Q_SIGN) : 0;
        h.dq_uv_ac = f(1, K_DELTA_Q_CODED) ? sbits(4, K_DELTA_Q, K_DELTA_Q_SIGN) : 0;
        h.lossless = !h.base_q && !h.dq_y_dc && !h.dq_uv_dc && !h.dq_uv_ac;
        // segmentation
        h.seg_enabled = f(1, K_SEG_ENABLED);
        h.seg_update_map = h.seg_temporal = h.seg_update_data = 0;
        if (h.seg_enabled) {
            h.seg_update_map = f(1, K_SEG_UPDATE_MAP);
            if (h.seg_update_map) {
                for (int i = 0; i < 7; ++i)
                    seg_tree_probs[i] = f(1, K_SEG_PROB_CODED) ? f(8, K_SEG_PROB) : 255;
                h.seg_temporal = f(1, K_SEG_TEMPORAL);
                if (h.seg_temporal)
                    for (int i = 0; i < 3; ++i)
                        seg_pred_probs[i] = f(1, K_SEG_PRED_CODED) ? f(8, K_SEG_PRED_PROB) : 255;
            }
            h.seg_update_data = f(1, K_SEG_UPDATE_DATA);
            if (h.seg_update_data) {
                seg_abs = f(1, K_SEG_ABS);
                for (int i = 0; i < 8; ++i) {
                    SegFeature& s = feat[i];
                    if ((s.q_enabled = f(1, K_SEG_FEATURE))) s.q_val = sbits(8, K_SEG_VALUE, K_SEG_SIGN);
                    if ((s.lf_enabled = f(1, K_SEG_FEATURE))) s.lf_val = sbits(6, K_SEG_VALUE, K_SEG_SIGN);
                    if ((s.ref_enabled = f(1, K_SEG_FEATURE))) s.ref_val = f(2, K_SEG_VALUE);
                    s.skip_enabled = f(1, K_SEG_FEATURE);
                }
            }
        }
        setup_frame_size(w, hh);
        // tiles
        int min_log2 = 0;
        while ((64 << min_log2) < sb_cols) ++min_log2;
        int max_log2 = 1;
        while ((sb_cols >> max_log2) >= 4) ++max_log2;
        --max_log2;
        h.tile_cols_log2 = min_log2;
        while (h.tile_cols_log2 < max_log2 && f(1, K_TILE_COL_INC)) ++h.tile_cols_log2;
        h.tile_rows_log2 = f(1, K_TILE_ROWS);
        if (h.tile_rows_log2) h.tile_rows_log2 += f(1, K_TILE_ROWS);
        h.compressed_size = f(16, K_HEADER_SIZE);
        probe.compressed_size = h.compressed_size;
        probe.tile_cols_log2 = h.tile_cols_log2, probe.tile_rows_log2 = h.tile_rows_log2;
        return 0;
    }

    void read_colour() {
        // profile 0: 8 bits, 4:2:0
        hd.colour_space = f(3, K_COLOR_SPACE);
        if (hd.colour_space == 7) { probe.error = 6; fail("VP9: an RGB stream in profile 0"); }
        hd.full_range = f(1, K_COLOR_RANGE);
        probe.colour_space = hd.colour_space, probe.full_range = hd.full_range;
    }

    void setup_frame_size(int w, int h) {
        mi_cols = (w + 7) >> 3, mi_rows = (h + 7) >> 3;
        sb_cols = (mi_cols + 7) >> 3, sb_rows = (mi_rows + 7) >> 3;
    }

    // ── the compressed header ───────────────────────────────────────────
    int b(int p, int k) { return src.b(p, k); }
    int lit(int n, int k) {
        int v = 0;
        while (n--) v = (v << 1) | src.b(128, k);
        return v;
    }
    uint8_t diff_update(uint8_t p) { return b(252, K_UPDATE) ? (uint8_t)src.update_prob(p) : p; }
    uint8_t mv_update(uint8_t p) { return b(252, K_UPDATE) ? (uint8_t)src.mv_prob() : p; }

    void read_compressed_header() {
        Header& h = hd;
        if (h.lossless) {
            h.tx_mode = ONLY_4X4;
        } else {
            h.tx_mode = lit(2, K_TX_MODE);
            if (h.tx_mode == ALLOW_32X32) h.tx_mode += b(128, K_TX_SELECT);
            if (h.tx_mode == TX_MODE_SELECT) {
                for (int i = 0; i < 2; ++i) fc.tx8[i][0] = diff_update(fc.tx8[i][0]);
                for (int i = 0; i < 2; ++i)
                    for (int j = 0; j < 2; ++j) fc.tx16[i][j] = diff_update(fc.tx16[i][j]);
                for (int i = 0; i < 2; ++i)
                    for (int j = 0; j < 3; ++j) fc.tx32[i][j] = diff_update(fc.tx32[i][j]);
            }
        }
        int max_tx = TX_MODE_MAX[h.tx_mode];
        for (int t = 0; t <= max_tx; ++t) {
            if (b(128, K_COEF_UPDATE_ANY)) {
                for (int i = 0; i < 2; ++i)
                    for (int j = 0; j < 2; ++j)
                        for (int k = 0; k < 6; ++k)
                            for (int l = 0; l < (k ? 6 : 3); ++l)
                                for (int m = 0; m < 3; ++m)
                                    fc.coef[t][i][j][k][l][m] = diff_update(fc.coef[t][i][j][k][l][m]);
            }
        }
        for (int i = 0; i < 3; ++i) fc.skip[i] = diff_update(fc.skip[i]);
        if (h.keyframe || h.intra_only) {
            h.comp_mode = SINGLE_REF;
            return;
        }
        for (int i = 0; i < 7; ++i)
            for (int j = 0; j < 3; ++j) fc.inter_mode[i][j] = diff_update(fc.inter_mode[i][j]);
        if (h.interp_filter == SWITCHABLE)
            for (int i = 0; i < 4; ++i)
                for (int j = 0; j < 2; ++j) fc.filter[i][j] = diff_update(fc.filter[i][j]);
        for (int i = 0; i < 4; ++i) fc.is_inter[i] = diff_update(fc.is_inter[i]);
        if (h.comp_fixed_ref) {
            h.comp_mode = b(128, K_COMP_MODE);
            if (h.comp_mode) h.comp_mode += b(128, K_COMP_SELECT);
            if (h.comp_mode == REFERENCE_SELECT)
                for (int i = 0; i < 5; ++i) fc.comp_mode[i] = diff_update(fc.comp_mode[i]);
        } else {
            h.comp_mode = SINGLE_REF;
        }
        if (h.comp_mode != COMPOUND_REF)
            for (int i = 0; i < 5; ++i) {
                fc.single_ref[i][0] = diff_update(fc.single_ref[i][0]);
                fc.single_ref[i][1] = diff_update(fc.single_ref[i][1]);
            }
        if (h.comp_mode != SINGLE_REF)
            for (int i = 0; i < 5; ++i) fc.comp_ref[i] = diff_update(fc.comp_ref[i]);
        for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 9; ++j) fc.y_mode[i][j] = diff_update(fc.y_mode[i][j]);
        for (int i = 0; i < 16; ++i)
            for (int j = 0; j < 3; ++j) fc.partition[i][j] = diff_update(fc.partition[i][j]);
        for (int i = 0; i < 3; ++i) fc.mv_joint[i] = mv_update(fc.mv_joint[i]);
        for (int i = 0; i < 2; ++i) {
            fc.mv[i][MV_SIGN] = mv_update(fc.mv[i][MV_SIGN]);
            for (int j = 0; j < 10; ++j) fc.mv[i][MV_CLASSES + j] = mv_update(fc.mv[i][MV_CLASSES + j]);
            fc.mv[i][MV_CLASS0] = mv_update(fc.mv[i][MV_CLASS0]);
            for (int j = 0; j < 10; ++j) fc.mv[i][MV_BITS + j] = mv_update(fc.mv[i][MV_BITS + j]);
        }
        for (int i = 0; i < 2; ++i) {
            for (int j = 0; j < 6; ++j) fc.mv[i][MV_CLASS0_FP + j] = mv_update(fc.mv[i][MV_CLASS0_FP + j]);
            for (int j = 0; j < 3; ++j) fc.mv[i][MV_FP + j] = mv_update(fc.mv[i][MV_FP + j]);
        }
        if (h.allow_hp)
            for (int i = 0; i < 2; ++i) {
                fc.mv[i][MV_CLASS0_HP] = mv_update(fc.mv[i][MV_CLASS0_HP]);
                fc.mv[i][MV_HP] = mv_update(fc.mv[i][MV_HP]);
            }
    }

    // the segment and filter tables of a frame (FFmpeg's qmul and lflvl)
    void setup_segment_tables() {
        Header& h = hd;
        for (int i = 0; i < (h.seg_enabled ? 8 : 1); ++i) {
            int qyac = h.base_q;
            if (h.seg_enabled && feat[i].q_enabled)
                qyac = seg_abs ? feat[i].q_val : h.base_q + feat[i].q_val;
            qyac = clamp(qyac, 0, 255);
            int qydc = clamp(qyac + h.dq_y_dc, 0, 255);
            int quvdc = clamp(qyac + h.dq_uv_dc, 0, 255);
            int quvac = clamp(qyac + h.dq_uv_ac, 0, 255);
            qmul[i][0][0] = DC_QLOOKUP[qydc];
            qmul[i][0][1] = AC_QLOOKUP[qyac];
            qmul[i][1][0] = DC_QLOOKUP[quvdc];
            qmul[i][1][1] = AC_QLOOKUP[quvac];
            int sh = h.lf_level >= 32;
            int lvl = h.lf_level;
            if (h.seg_enabled && feat[i].lf_enabled)
                lvl = clamp(seg_abs ? feat[i].lf_val : h.lf_level + feat[i].lf_val, 0, 63);
            if (h.lf_delta_enabled) {
                lflvl[i][0][0] = lflvl[i][0][1] = (uint8_t)clamp(lvl + lf_ref_deltas[0] * (1 << sh), 0, 63);
                for (int j = 1; j < 4; ++j)
                    for (int m = 0; m < 2; ++m)
                        lflvl[i][j][m] = (uint8_t)clamp(
                            lvl + (lf_ref_deltas[j] + lf_mode_deltas[m]) * (1 << sh), 0, 63);
            } else {
                memset(lflvl[i], lvl, sizeof(lflvl[i]));
            }
        }
        for (int i = 1; i <= 63; ++i) {
            int limit = i;
            if (h.sharpness > 0) {
                limit >>= (h.sharpness + 3) >> 2;
                limit = std::min(limit, 9 - h.sharpness);
            }
            limit = std::max(limit, 1);
            lim_lut[i] = (uint8_t)limit;
            mblim_lut[i] = (uint8_t)(2 * (i + 2) + limit);
        }
    }

    // ── blocks ──────────────────────────────────────────────────────────
    MI* mi_at(int r, int c) { return &mi[(size_t)r * mi_cols + c]; }
    int tree(const int8_t* t, const uint8_t* p, int k) { return src.tree(t, p, k); }

    void decode_partition(int r, int c, int bsl) {   // bsl: 0 = 64x64 .. 3 = 8x8
        if (r >= mi_rows || c >= mi_cols) return;
        int n8 = 8 >> bsl, hbs = n8 >> 1;
        int lvl = 3 - bsl;                           // 0 = 8x8 .. 3 = 64x64
        int above = (above_part[c] >> lvl) & 1, left = (left_part[r & 7] >> lvl) & 1;
        int pctx = lvl * 4 + left * 2 + above;
        cur_bsl = bsl;
        const uint8_t* probs = (hd.keyframe || hd.intra_only) ? KF_PARTITION_PROBS + 3 * pctx
                                                              : fc.partition[pctx];
        bool has_rows = (r + hbs) < mi_rows, has_cols = (c + hbs) < mi_cols;
        int p;
        if (bsl == 3 || (has_rows && has_cols))
            p = tree(PARTITION_TREE, probs, K_PARTITION);
        else if (has_cols)
            p = b(probs[1], K_SPLIT_OR_HORZ) ? PARTITION_SPLIT : PARTITION_HORZ;
        else if (has_rows)
            p = b(probs[2], K_SPLIT_OR_VERT) ? PARTITION_SPLIT : PARTITION_VERT;
        else
            p = PARTITION_SPLIT;
        ++counts.partition[pctx][p];
        int sub = SUBSIZE[bsl][p];
        if (bsl == 3) {
            decode_block(r, c, sub);
        } else if (p == PARTITION_NONE) {
            decode_block(r, c, sub);
        } else if (p == PARTITION_HORZ) {
            decode_block(r, c, sub);
            if (has_rows) decode_block(r + hbs, c, sub);
        } else if (p == PARTITION_VERT) {
            decode_block(r, c, sub);
            if (has_cols) decode_block(r, c + hbs, sub);
        } else {
            decode_partition(r, c, bsl + 1);
            decode_partition(r, c + hbs, bsl + 1);
            decode_partition(r + hbs, c, bsl + 1);
            decode_partition(r + hbs, c + hbs, bsl + 1);
        }
        if (bsl == 3 || p != PARTITION_SPLIT) {
            memset(&above_part[c], PART_CTX_ABOVE[sub], n8);
            memset(&left_part[r & 7], PART_CTX_LEFT[sub], n8);
        }
    }

    // the block being decoded
    MI cb;
    int cr = 0, cc = 0, cw8 = 0, ch8 = 0;        // position, size in 8x8 (clipped)
    const MI* above_mi = nullptr;
    const MI* left_mi = nullptr;

    bool seg_skip() const { return hd.seg_enabled && feat[cb.seg_id].skip_enabled; }

    void read_segment_id_intra() {
        cb.seg_id = 0;
        if (!hd.seg_enabled) return;
        cb.seg_id = hd.seg_update_map ? (uint8_t)tree(SEGMENT_TREE, seg_tree_probs, K_SEG_ID) : 0;
    }

    int predicted_segment() {
        if (hd.error_res || !segmap_ref) return 0;
        int pred = 8;
        for (int y = 0; y < ch8; ++y)
            for (int x = 0; x < cw8; ++x)
                pred = std::min<int>(pred, segmap_ref->segmap[(size_t)(cr + y) * mi_cols + cc + x]);
        return pred;
    }

    void read_segment_id_inter(int w8, int h8) {
        cb.seg_id = 0;
        cb.seg_pred = 0;
        if (!hd.seg_enabled) return;
        bool predicted = !hd.seg_update_map;
        if (hd.seg_update_map && hd.seg_temporal) {
            int ctx = above_segpred[cc] + left_segpred[cr & 7];
            predicted = b(seg_pred_probs[ctx], K_SEG_PREDICTED);
        }
        if (predicted) {
            cb.seg_id = (uint8_t)predicted_segment();
            memset(&above_segpred[cc], 1, w8);
            memset(&left_segpred[cr & 7], 1, h8);
        } else {
            cb.seg_id = (uint8_t)tree(SEGMENT_TREE, seg_tree_probs, K_SEG_ID);
            memset(&above_segpred[cc], 0, w8);
            memset(&left_segpred[cr & 7], 0, h8);
        }
    }

    void read_skip() {
        if (seg_skip()) {
            cb.skip = 1;
            return;
        }
        int ctx = (above_mi ? above_mi->skip : 0) + (left_mi ? left_mi->skip : 0);
        cb.skip = (uint8_t)b(fc.skip[ctx], K_SKIP);
        ++counts.skip[ctx][cb.skip];
    }

    void read_tx_size(bool allow_select) {
        int max_tx = MAX_TX[cb.sb_type];
        if (allow_select && hd.tx_mode == TX_MODE_SELECT && cb.sb_type >= BLOCK_8X8) {
            int a = above_mi && !above_mi->skip ? above_mi->tx_size : max_tx;
            int l = left_mi && !left_mi->skip ? left_mi->tx_size : max_tx;
            if (!left_mi) l = a;
            if (!above_mi) a = l;
            int ctx = (a + l) > max_tx;
            const uint8_t* p = max_tx == TX_32X32 ? fc.tx32[ctx] : max_tx == TX_16X16 ? fc.tx16[ctx]
                                                                                     : fc.tx8[ctx];
            int tx = b(p[0], K_TX_SIZE);
            if (tx && max_tx >= TX_16X16) {
                tx += b(p[1], K_TX_SIZE);
                if (tx == 2 && max_tx >= TX_32X32) tx += b(p[2], K_TX_SIZE);
            }
            if (max_tx == TX_32X32) ++counts.tx32[ctx][tx];
            else if (max_tx == TX_16X16) ++counts.tx16[ctx][tx];
            else ++counts.tx8[ctx][tx];
            cb.tx_size = (uint8_t)tx;
        } else {
            cb.tx_size = (uint8_t)std::min(max_tx, (int)TX_MODE_MAX[hd.tx_mode]);
        }
    }

    // the y mode of sub-block b of a neighbour, DC_PRED where it is missing
    // or inter (libvpx's vp9_above_block_mode / vp9_left_block_mode)
    int above_block_mode(int blk) {
        if (blk == 2 || blk == 3) return cb.sub_modes[blk - 2];
        if (!above_mi || above_mi->is_inter()) return DC_PRED;
        return above_mi->sb_type < BLOCK_8X8 ? above_mi->sub_modes[blk + 2] : above_mi->mode;
    }
    int left_block_mode(int blk) {
        if (blk == 1 || blk == 3) return cb.sub_modes[blk - 1];
        if (!left_mi || left_mi->is_inter()) return DC_PRED;
        return left_mi->sb_type < BLOCK_8X8 ? left_mi->sub_modes[blk + 1] : left_mi->mode;
    }

    void read_intra_modes_kf() {
        auto kf = [&](int blk) {
            int a = above_block_mode(std::max(blk, 0)), l = left_block_mode(std::max(blk, 0));
            return tree(INTRA_MODE_TREE, KF_YMODE_PROBS + 9 * (a * 10 + l),
                        blk < 0 ? K_KF_Y_MODE : K_KF_SUB_MODE);
        };
        read_sub_modes(kf);
        cb.uv_mode = (uint8_t)tree(INTRA_MODE_TREE, KF_UV_MODE_PROBS + 9 * cb.mode, K_KF_UV_MODE);
    }

    template <class F>
    void read_sub_modes(F read) {
        switch (cb.sb_type) {
        case BLOCK_4X4:
            for (int i = 0; i < 4; ++i) cb.sub_modes[i] = (uint8_t)read(i);
            break;
        case BLOCK_4X8:
            cb.sub_modes[0] = cb.sub_modes[2] = (uint8_t)read(0);
            cb.sub_modes[1] = cb.sub_modes[3] = (uint8_t)read(1);
            break;
        case BLOCK_8X4:
            cb.sub_modes[0] = cb.sub_modes[1] = (uint8_t)read(0);
            cb.sub_modes[2] = cb.sub_modes[3] = (uint8_t)read(2);
            break;
        default:
            cb.sub_modes[0] = cb.sub_modes[1] = cb.sub_modes[2] = cb.sub_modes[3] = (uint8_t)read(-1);
        }
        cb.mode = cb.sub_modes[3];
    }

    void read_intra_modes_inter() {
        auto y = [&](int blk) {
            int g = blk < 0 ? SIZE_GROUP[cb.sb_type] : 0;
            int m = tree(INTRA_MODE_TREE, fc.y_mode[g], blk < 0 ? K_Y_MODE : K_SUB_MODE);
            ++counts.y_mode[g][m];
            return m;
        };
        read_sub_modes(y);
        cb.uv_mode = (uint8_t)tree(INTRA_MODE_TREE, fc.uv_mode[cb.mode], K_UV_MODE);
        ++counts.uv_mode[cb.mode][cb.uv_mode];
        cb.interp_filter = 3;
    }

    // ── reference frames ────────────────────────────────────────────────
    int comp_mode_ctx() {
        const MI *a = above_mi, *l = left_mi;
        int fix = hd.comp_fixed_ref;
        if (a && l) {
            if (!a->is_comp() && !l->is_comp())
                return (a->ref[0] == fix) ^ (l->ref[0] == fix);
            if (!a->is_comp()) return 2 + (a->ref[0] == fix || !a->is_inter());
            if (!l->is_comp()) return 2 + (l->ref[0] == fix || !l->is_inter());
            return 4;
        }
        if (a || l) {
            const MI* e = a ? a : l;
            return e->is_comp() ? 3 : e->ref[0] == fix;
        }
        return 1;
    }

    int comp_ref_ctx() {
        const MI *a = above_mi, *l = left_mi;
        int fix_idx = hd.sign_bias[hd.comp_fixed_ref], var_idx = !fix_idx;
        int var1 = hd.comp_var_ref[1], var0 = hd.comp_var_ref[0], fix = hd.comp_fixed_ref;
        if (a && l) {
            bool ai = !a->is_inter(), li = !l->is_inter();
            if (ai && li) return 2;
            if (ai || li) {
                const MI* e = ai ? l : a;
                if (!e->is_comp()) return 1 + 2 * (e->ref[0] != var1);
                return 1 + 2 * (e->ref[var_idx] != var1);
            }
            bool l_sg = !l->is_comp(), a_sg = !a->is_comp();
            int vrfa = a_sg ? a->ref[0] : a->ref[var_idx];
            int vrfl = l_sg ? l->ref[0] : l->ref[var_idx];
            if (vrfa == vrfl && var1 == vrfa) return 0;
            if (l_sg && a_sg) {
                if ((vrfa == fix && vrfl == var0) || (vrfl == fix && vrfa == var0)) return 4;
                if (vrfa == vrfl) return 3;
                return 1;
            }
            if (l_sg || a_sg) {
                int vrfc = l_sg ? vrfa : vrfl;
                int rfs = a_sg ? vrfa : vrfl;
                if (vrfc == var1 && rfs != var1) return 1;
                if (rfs == var1 && vrfc != var1) return 2;
                return 4;
            }
            return vrfa == vrfl ? 4 : 2;
        }
        if (a || l) {
            const MI* e = a ? a : l;
            if (!e->is_inter()) return 2;
            if (e->is_comp()) return 4 * (e->ref[var_idx] != var1);
            return 3 * (e->ref[0] != var1);
        }
        return 2;
    }

    int single_ref_p1_ctx() {
        const MI *a = above_mi, *l = left_mi;
        if (a && l) {
            bool ai = !a->is_inter(), li = !l->is_inter();
            if (ai && li) return 2;
            if (ai || li) {
                const MI* e = ai ? l : a;
                if (!e->is_comp()) return 4 * (e->ref[0] == LAST_FRAME);
                return 1 + (e->ref[0] == LAST_FRAME || e->ref[1] == LAST_FRAME);
            }
            bool ac = a->is_comp(), lc = l->is_comp();
            int a0 = a->ref[0], a1 = a->ref[1], l0 = l->ref[0], l1 = l->ref[1];
            if (ac && lc)
                return 1 + (a0 == LAST_FRAME || a1 == LAST_FRAME || l0 == LAST_FRAME || l1 == LAST_FRAME);
            if (ac || lc) {
                int rfs = !ac ? a0 : l0;
                int crf1 = ac ? a0 : l0, crf2 = ac ? a1 : l1;
                if (rfs == LAST_FRAME) return 3 + (crf1 == LAST_FRAME || crf2 == LAST_FRAME);
                return crf1 == LAST_FRAME || crf2 == LAST_FRAME;
            }
            return 2 * (a0 == LAST_FRAME) + 2 * (l0 == LAST_FRAME);
        }
        if (a || l) {
            const MI* e = a ? a : l;
            if (!e->is_inter()) return 2;
            if (!e->is_comp()) return 4 * (e->ref[0] == LAST_FRAME);
            return 1 + (e->ref[0] == LAST_FRAME || e->ref[1] == LAST_FRAME);
        }
        return 2;
    }

    int single_ref_p2_ctx() {
        const MI *a = above_mi, *l = left_mi;
        if (a && l) {
            bool ai = !a->is_inter(), li = !l->is_inter();
            if (ai && li) return 2;
            if (ai || li) {
                const MI* e = ai ? l : a;
                if (!e->is_comp()) {
                    if (e->ref[0] == LAST_FRAME) return 3;
                    return 4 * (e->ref[0] == GOLDEN_FRAME);
                }
                return 1 + 2 * (e->ref[0] == GOLDEN_FRAME || e->ref[1] == GOLDEN_FRAME);
            }
            bool ac = a->is_comp(), lc = l->is_comp();
            int a0 = a->ref[0], a1 = a->ref[1], l0 = l->ref[0], l1 = l->ref[1];
            if (ac && lc) {
                if (a0 == l0 && a1 == l1)
                    return 3 * (a0 == GOLDEN_FRAME || a1 == GOLDEN_FRAME || l0 == GOLDEN_FRAME ||
                                l1 == GOLDEN_FRAME);
                return 2;
            }
            if (ac || lc) {
                int rfs = !ac ? a0 : l0;
                int crf1 = ac ? a0 : l0, crf2 = ac ? a1 : l1;
                if (rfs == GOLDEN_FRAME) return 3 + (crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME);
                if (rfs == ALTREF_FRAME) return crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME;
                return 1 + 2 * (crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME);
            }
            if (a0 == LAST_FRAME && l0 == LAST_FRAME) return 3;
            if (a0 == LAST_FRAME || l0 == LAST_FRAME) {
                int edge0 = a0 == LAST_FRAME ? l0 : a0;
                return 4 * (edge0 == GOLDEN_FRAME);
            }
            return 2 * (a0 == GOLDEN_FRAME) + 2 * (l0 == GOLDEN_FRAME);
        }
        if (a || l) {
            const MI* e = a ? a : l;
            if (!e->is_inter() || (e->ref[0] == LAST_FRAME && !e->is_comp())) return 2;
            if (!e->is_comp()) return 4 * (e->ref[0] == GOLDEN_FRAME);
            return 3 * (e->ref[0] == GOLDEN_FRAME || e->ref[1] == GOLDEN_FRAME);
        }
        return 2;
    }

    void read_ref_frames() {
        if (hd.seg_enabled && feat[cb.seg_id].ref_enabled) {
            cb.ref[0] = (int8_t)feat[cb.seg_id].ref_val;
            cb.ref[1] = NONE;
            return;
        }
        int mode = hd.comp_mode;
        if (mode == REFERENCE_SELECT) {
            int ctx = comp_mode_ctx();
            mode = b(fc.comp_mode[ctx], K_COMP) ? COMPOUND_REF : SINGLE_REF;
            ++counts.comp_mode[ctx][mode == COMPOUND_REF];
        }
        if (mode == COMPOUND_REF) {
            int idx = hd.sign_bias[hd.comp_fixed_ref];
            int ctx = comp_ref_ctx();
            int bit = b(fc.comp_ref[ctx], K_COMP_REF);
            ++counts.comp_ref[ctx][bit];
            cb.ref[idx] = (int8_t)hd.comp_fixed_ref;
            cb.ref[!idx] = (int8_t)hd.comp_var_ref[bit];
        } else {
            int ctx = single_ref_p1_ctx();
            int bit = b(fc.single_ref[ctx][0], K_SINGLE_REF1);
            ++counts.single_ref[ctx][0][bit];
            if (bit) {
                int ctx2 = single_ref_p2_ctx();
                int bit2 = b(fc.single_ref[ctx2][1], K_SINGLE_REF2);
                ++counts.single_ref[ctx2][1][bit2];
                cb.ref[0] = bit2 ? ALTREF_FRAME : GOLDEN_FRAME;
            } else {
                cb.ref[0] = LAST_FRAME;
            }
            cb.ref[1] = NONE;
        }
    }

    // ── motion vectors ──────────────────────────────────────────────────
    struct Mv {
        int r, c;
        bool operator==(const Mv& o) const { return r == o.r && c == o.c; }
        bool operator!=(const Mv& o) const { return !(*this == o); }
    };
    static Mv mv_of(const int16_t* m) { return Mv{m[0], m[1]}; }

    bool is_inside(int r, int c) const {
        return r >= 0 && r < mi_rows && c >= tile_col_start && c < tile_col_end;
    }

    Mv scale_mv(Mv m, int cand_ref, int ref) const {
        if (hd.sign_bias[cand_ref] != hd.sign_bias[ref]) return Mv{-m.r, -m.c};
        return m;
    }

    void clamp_mv_ref(Mv& m, int border) const {
        int bw8 = B_W8[cb.sb_type], bh8 = B_H8[cb.sb_type];
        int left = -(cc * 64) - border, right = (mi_cols - bw8 - cc) * 64 + border;
        int top = -(cr * 64) - border, bottom = (mi_rows - bh8 - cr) * 64 + border;
        m.c = clamp(m.c, left, right);
        m.r = clamp(m.r, top, bottom);
    }

    // the specification's find_mv_refs: two candidates for ref, clamped
    void find_mv_refs(int ref, int block, Mv out[2]) {
        Mv list[2] = {{0, 0}, {0, 0}};
        int n = 0;
        bool done = false;
        auto add = [&](Mv m) {
            if (n) {
                if (m != list[0]) {
                    list[1] = m;
                    n = 2;
                    done = true;
                }
            } else {
                list[n++] = m;
            }
        };
        const int8_t(*pos)[2] = MV_REF_BLOCKS[cb.sb_type];
        bool different_found = false;
        for (int i = 0; i < 2 && !done; ++i) {
            int r = cr + pos[i][0], c = cc + pos[i][1];
            if (!is_inside(r, c)) continue;
            const MI* m = mi_at(r, c);
            different_found = true;
            for (int w = 0; w < 2; ++w) {
                if (m->ref[w] != ref) continue;
                if (block >= 0 && m->sb_type < BLOCK_8X8)
                    add(mv_of(m->bmv[IDX_N_COLUMN_TO_SUBBLOCK[block][pos[i][1] == 0]][w]));
                else
                    add(mv_of(m->mv[w]));
                break;
            }
        }
        for (int i = 2; i < 8 && !done; ++i) {
            int r = cr + pos[i][0], c = cc + pos[i][1];
            if (!is_inside(r, c)) continue;
            const MI* m = mi_at(r, c);
            different_found = true;
            if (m->ref[0] == ref) add(mv_of(m->mv[0]));
            else if (m->ref[1] == ref) add(mv_of(m->mv[1]));
        }
        const MvPair* prev = use_prev_mvs ? &last->mvs[(size_t)cr * mi_cols + cc] : nullptr;
        if (prev && !done) {
            if (prev->ref[0] == ref) add(mv_of(prev->mv[0]));
            else if (prev->ref[1] == ref) add(mv_of(prev->mv[1]));
        }
        if (different_found) {
            for (int i = 0; i < 8 && !done; ++i) {
                int r = cr + pos[i][0], c = cc + pos[i][1];
                if (!is_inside(r, c)) continue;
                const MI* m = mi_at(r, c);
                if (!m->is_inter()) continue;
                if (m->ref[0] != ref) add(scale_mv(mv_of(m->mv[0]), m->ref[0], ref));
                if (!done && m->is_comp() && m->ref[1] != ref && mv_of(m->mv[1]) != mv_of(m->mv[0]))
                    add(scale_mv(mv_of(m->mv[1]), m->ref[1], ref));
            }
        }
        if (prev && !done) {
            if (prev->ref[0] != ref && prev->ref[0] > INTRA_FRAME)
                add(scale_mv(mv_of(prev->mv[0]), prev->ref[0], ref));
            if (!done && prev->ref[1] > INTRA_FRAME && prev->ref[1] != ref &&
                mv_of(prev->mv[1]) != mv_of(prev->mv[0]))
                add(scale_mv(mv_of(prev->mv[1]), prev->ref[1], ref));
        }
        for (int i = 0; i < 2; ++i) {
            clamp_mv_ref(list[i], 128);
            out[i] = list[i];
        }
    }

    int mode_context() {
        const int8_t(*pos)[2] = MV_REF_BLOCKS[cb.sb_type];
        int counter = 0;
        for (int i = 0; i < 2; ++i) {
            int r = cr + pos[i][0], c = cc + pos[i][1];
            if (is_inside(r, c)) counter += MODE_2_COUNTER[mi_at(r, c)->mode];
        }
        return COUNTER_TO_CONTEXT[counter];
    }

    static void lower_precision(Mv& m, bool allow_hp) {
        if (allow_hp && abs(m.r) < 64 && abs(m.c) < 64) return;
        if (m.r & 1) m.r += m.r > 0 ? -1 : 1;
        if (m.c & 1) m.c += m.c > 0 ? -1 : 1;
    }

    void count_mv_comp(int comp, int v) {
        MvCounts& m = counts.mv[comp];
        int s = v < 0, z = abs(v) - 1;
        m.sign[s]++;
        int c = z >= 2 * 4096 ? 10 : 31 - __builtin_clz((unsigned)(z >> 3) | 1);
        if ((z >> 3) == 0) c = 0;
        int o = z - (c ? 2 << (c + 2) : 0);
        m.classes[c]++;
        int d = o >> 3, fr = (o >> 1) & 3, e = o & 1;
        if (!c) {
            m.class0[d]++;
            m.class0_fp[d][fr]++;
            m.class0_hp[e]++;
        } else {
            for (int i = 0; i < c; ++i) m.bits[i][(d >> i) & 1]++;
            m.fp[fr]++;
            m.hp[e]++;
        }
    }

    Mv read_mv(Mv best) {
        bool use_hp = hd.allow_hp && abs(best.r) < 64 && abs(best.c) < 64;
        int j = tree(MV_JOINT_TREE, fc.mv_joint, K_MV_JOINT);
        ++counts.mv_joint[j];
        Mv d{0, 0};
        if (j >= 2) {
            d.r = src.mv_comp(fc.mv[0], use_hp, best.r);
            count_mv_comp(0, d.r);
        }
        if (j & 1) {
            d.c = src.mv_comp(fc.mv[1], use_hp, best.c);
            count_mv_comp(1, d.c);
        }
        return Mv{best.r + d.r, best.c + d.c};
    }

    void read_inter_block() {
        read_ref_frames();
        bool comp = cb.ref[1] > INTRA_FRAME;
        int mctx = mode_context();
        int nrefs = 1 + comp;
        if (seg_skip()) {
            cb.mode = ZEROMV;
            if (cb.sb_type < BLOCK_8X8) fail("VP9: the skip segment feature on a block below 8x8");
        } else if (cb.sb_type >= BLOCK_8X8) {
            int m = tree(INTER_MODE_TREE, fc.inter_mode[mctx], K_INTER_MODE);
            ++counts.inter_mode[mctx][m];
            cb.mode = (uint8_t)(NEARESTMV + m);
        }
        if (hd.interp_filter == SWITCHABLE) {
            int lt = left_mi && left_mi->is_inter() ? left_mi->interp_filter : 3;
            int at = above_mi && above_mi->is_inter() ? above_mi->interp_filter : 3;
            int ctx = lt == at ? lt : lt == 3 ? at : at == 3 ? lt : 3;
            int fl = tree(INTERP_FILTER_TREE, fc.filter[ctx], K_INTERP_FILTER);
            ++counts.filter[ctx][fl];
            cb.interp_filter = (uint8_t)fl;
        } else {
            cb.interp_filter = (uint8_t)hd.interp_filter;
        }
        Mv best[2] = {{0, 0}, {0, 0}}, nearest[2] = {{0, 0}, {0, 0}}, near_[2] = {{0, 0}, {0, 0}};
        if (cb.sb_type >= BLOCK_8X8) {
            if (cb.mode != ZEROMV) {
                for (int i = 0; i < nrefs; ++i) {
                    Mv l[2];
                    find_mv_refs(cb.ref[i], -1, l);
                    lower_precision(l[0], hd.allow_hp);
                    lower_precision(l[1], hd.allow_hp);
                    nearest[i] = l[0], near_[i] = l[1], best[i] = l[0];
                }
            }
            for (int i = 0; i < nrefs; ++i) {
                Mv m{0, 0};
                if (cb.mode == NEARESTMV) m = nearest[i];
                else if (cb.mode == NEARMV) m = near_[i];
                else if (cb.mode == NEWMV) m = read_mv(best[i]);
                cb.mv[i][0] = (int16_t)m.r, cb.mv[i][1] = (int16_t)m.c;
            }
            for (int k = 0; k < 4; ++k) memcpy(cb.bmv[k], cb.mv, sizeof(cb.mv));
            return;
        }
        bool have_best = false;
        int nw = cb.sb_type == BLOCK_4X8 || cb.sb_type == BLOCK_4X4 ? 1 : 2;   // 4x4 columns a mode covers
        int nh = cb.sb_type == BLOCK_8X4 || cb.sb_type == BLOCK_4X4 ? 1 : 2;
        int bm = 0;
        for (int y = 0; y < 2; y += nh)
            for (int x = 0; x < 2; x += nw) {
                int blk = y * 2 + x;
                int m = tree(INTER_MODE_TREE, fc.inter_mode[mctx], K_SUB_INTER_MODE);
                ++counts.inter_mode[mctx][m];
                bm = NEARESTMV + m;
                for (int i = 0; i < nrefs; ++i) {
                    Mv v{0, 0};
                    if (bm == NEWMV) {
                        if (!have_best) {
                            for (int j = 0; j < nrefs; ++j) {
                                Mv l[2];
                                find_mv_refs(cb.ref[j], -1, l);
                                lower_precision(l[0], hd.allow_hp);
                                best[j] = l[0];
                            }
                            have_best = true;
                        }
                        v = read_mv(best[i]);
                    } else if (bm == NEARESTMV || bm == NEARMV) {
                        Mv l[2], sub[2];
                        find_mv_refs(cb.ref[i], blk, l);
                        int dst = 0;
                        if (blk == 0) {
                            sub[0] = l[0], sub[1] = l[1], dst = 2;
                        } else if (blk <= 2) {
                            sub[dst++] = mv_of(cb.bmv[0][i]);
                        } else {
                            sub[dst++] = mv_of(cb.bmv[2][i]);
                            for (int idx = 1; idx >= 0; --idx)
                                if (dst < 2 && mv_of(cb.bmv[idx][i]) != sub[0])
                                    sub[dst++] = mv_of(cb.bmv[idx][i]);
                        }
                        for (int k = 0; k < 2 && dst < 2; ++k)
                            if (l[k] != sub[0]) sub[dst++] = l[k];
                        if (dst < 2) sub[dst++] = Mv{0, 0};
                        v = bm == NEARESTMV ? sub[0] : sub[1];
                    }
                    cb.bmv[blk][i][0] = (int16_t)v.r, cb.bmv[blk][i][1] = (int16_t)v.c;
                }
                if (nh == 2) memcpy(cb.bmv[blk + 2], cb.bmv[blk], sizeof(cb.bmv[0]));
                if (nw == 2) memcpy(cb.bmv[blk + 1], cb.bmv[blk], sizeof(cb.bmv[0]));
            }
        cb.mode = (uint8_t)bm;
        memcpy(cb.mv, cb.bmv[3], sizeof(cb.mv));
    }

    // ── coefficients ────────────────────────────────────────────────────
    // the last position decoded + 1 (eob); coef (raster, zeroed) gets the
    // dequantised values
    int decode_coefs(int plane, int tx, int type, int ctx, int* coef, const int* q) {
        int n = 4 << tx, n_coefs = n * n;
        int si = tx == TX_32X32 ? 9 : tx * 3 + (type == ADST_ADST ? 0 : type);
        const int16_t* scan = SCAN_DATA + SCAN_START[si];
        const int16_t* nb = NEIGHBOUR_DATA + 2 * SCAN_START[si];
        const uint8_t* bands = tx == TX_4X4 ? COEF_BANDS_4X4 : COEF_BANDS_8X8PLUS;
        int ptype = plane > 0, ref = cb.is_inter();
        uint8_t (*probs)[6][3] = fc.coef[tx][ptype][ref];
        unsigned (*cnt)[6][3] = counts.coef[tx][ptype][ref];
        unsigned (*eobc)[6][2] = counts.eob[tx][ptype][ref];
        uint8_t cache[1024];
        int i = 0;
        bool check_eob = true;
        while (i < n_coefs) {
            int band = bands[i];
            const uint8_t* p = probs[band][ctx];
            coef_pos = i, coef_n = n_coefs, coef_q = tx == TX_32X32 ? (q[i > 0] + 1) / 2 : q[i > 0];
            if (check_eob) {
                int more = b(p[0], K_MORE_COEFS);
                ++eobc[band][ctx][more];
                if (!more) break;
            }
            uint8_t tp[11];
            tp[0] = p[0], tp[1] = p[1], tp[2] = p[2];
            memcpy(tp + 3, PARETO8 + 8 * (p[2] - 1), 8);
            int rc = scan[i];
            int val = 0;
            int tok = src.token(tp, &val);
            if (tok == 0) {
                ++cnt[band][ctx][0];
                cache[rc] = 0;
                check_eob = false;
            } else {
                ++cnt[band][ctx][tok == 1 ? 1 : 2];
                cache[rc] = tok <= 2 ? tok : tok <= 4 ? 3 : tok <= 6 ? 4 : 5;
                int v = b(128, K_SIGN) ? -val : val;
                int dq = v * q[i > 0];
                if (tx == TX_32X32) dq /= 2;
                coef[rc] = (int16_t)dq;
                check_eob = true;
            }
            ++i;
            if (i < n_coefs) ctx = (1 + cache[nb[2 * i]] + cache[nb[2 * i + 1]]) >> 1;
        }
        return i;
    }
    int coef_pos = 0, coef_n = 0, coef_q = 0;   // the position read, for a source that writes
    int cur_bsl = 0;

    // decode (and add) the transform block at plane position (x4, y4), in
    // 4x4 units of the plane
    int residual(int plane, int x4, int y4, int tx, int type, int seg) {
        int n4 = 1 << tx;
        int sh = plane ? 1 : 0;
        int limit_x = (mi_cols * 2) >> sh, limit_y = (mi_rows * 2) >> sh;
        uint8_t* a = &above_nnz[plane][x4];
        uint8_t* l = &left_nnz[plane][y4 & (sh ? 7 : 15)];
        int actx = 0, lctx = 0;
        for (int k = 0; k < n4; ++k) actx |= a[k], lctx |= l[k];
        int n = 4 << tx;
        memset(coef_buf, 0, sizeof(int) * n * n);
        int eob = decode_coefs(plane, tx, type, actx + lctx, coef_buf, qmul[seg][plane > 0]);
        uint8_t has = eob > 0;
        for (int k = 0; k < n4; ++k) {
            a[k] = x4 + k < limit_x ? has : 0;
            l[k] = y4 + k < limit_y ? has : 0;
        }
        if (eob) {
            Frame& fr = *cur;
            uint8_t* dst = fr.plane[plane].data() + (size_t)(y4 * 4) * fr.stride[plane] + x4 * 4;
            inverse_transform_add(coef_buf, tx, hd.lossless ? 4 : type, dst, fr.stride[plane], eob);
        }
        return eob;
    }

    // the intra edges of a transform block and its prediction
    void predict_intra(int plane, int x4, int y4, int tx, int mode, int bw4) {
        Frame& fr = *cur;
        int sh = plane ? 1 : 0;
        int n = 4 << tx, px = x4 * 4, py = y4 * 4;
        int stride = fr.stride[plane];
        uint8_t* base = fr.plane[plane].data();
        int max_x = ((mi_cols * 8) >> sh) - 1, max_y = ((mi_rows * 8) >> sh) - 1;
        int tile_x = (tile_col_start * 8) >> sh;
        bool have_above = py > 0, have_left = px > tile_x;
        int bx4 = x4 - ((cc * 2) >> sh);             // position in the block, 4x4 units
        bool have_right = bx4 + 1 < bw4;
        uint8_t above_buf[80], left[32];
        uint8_t* above = above_buf + 16;
        if (have_above) {
            const uint8_t* row = base + (size_t)(py - 1) * stride;
            for (int i = 0; i < n; ++i) above[i] = row[std::min(max_x, px + i)];
            if (tx == TX_4X4 && have_right && px + 7 <= max_x) {
                for (int i = 4; i < 8; ++i) above[i] = row[px + i];
            } else {
                for (int i = n; i < 2 * n; ++i) above[i] = above[n - 1];
            }
            above[-1] = have_left ? row[px - 1] : 129;
        } else {
            memset(above - 1, 127, 2 * n + 1);
        }
        if (have_left) {
            for (int i = 0; i < n; ++i) left[i] = base[(size_t)std::min(max_y, py + i) * stride + px - 1];
        } else {
            memset(left, 129, n);
        }
        intra_predict(mode, n, above, left, have_above, have_left, base + (size_t)py * stride + px,
                      stride);
    }

    void predict_inter() {
        Frame& fr = *cur;
        bool comp = cb.ref[1] > INTRA_FRAME;
        const int16_t* kernel = SUBPEL_FILTERS + 128 * cb.interp_filter;
        uint8_t tmp[64 * 64];
        for (int i = 0; i < 1 + comp; ++i) {
            const Frame& rf = *refs[hd.ref_idx[cb.ref[i] - 1]];
            for (int plane = 0; plane < 3; ++plane) {
                int sh = plane ? 1 : 0;
                int stride = fr.stride[plane];
                uint8_t* dst0 = fr.plane[plane].data();
                auto one = [&](int x, int y, int w, int h, int mr, int mc) {
                    // x, y, w, h in pixels of the plane; mr, mc in eighths of luma
                    int fx, fy, ix, iy;
                    if (sh) {
                        ix = x + (mc >> 4), fx = mc & 15;
                        iy = y + (mr >> 4), fy = mr & 15;
                    } else {
                        ix = x + (mc >> 3), fx = (mc & 7) << 1;
                        iy = y + (mr >> 3), fy = (mr & 7) << 1;
                    }
                    uint8_t* dst = dst0 + (size_t)y * stride + x;
                    if (i == 0) {
                        predict_block(rf.plane[plane].data(), rf.stride[plane], rf.pw[plane],
                                      rf.ph[plane], ix, iy, fx, fy, w, h, kernel, dst, stride);
                    } else {
                        predict_block(rf.plane[plane].data(), rf.stride[plane], rf.pw[plane],
                                      rf.ph[plane], ix, iy, fx, fy, w, h, kernel, tmp, w);
                        for (int r = 0; r < h; ++r)
                            for (int c = 0; c < w; ++c)
                                dst[r * stride + c] = (uint8_t)((dst[r * stride + c] + tmp[r * w + c] + 1) >> 1);
                    }
                };
                int x0 = (cc * 8) >> sh, y0 = (cr * 8) >> sh;
                if (cb.sb_type >= BLOCK_8X8) {
                    one(x0, y0, (B_W4[cb.sb_type] * 4) >> sh, (B_H4[cb.sb_type] * 4) >> sh,
                        cb.mv[i][0], cb.mv[i][1]);
                } else if (!sh) {
                    for (int k = 0; k < 4; ++k)
                        one(x0 + (k & 1) * 4, y0 + (k >> 1) * 4, 4, 4, cb.bmv[k][i][0], cb.bmv[k][i][1]);
                } else {
                    auto avg = [&](int comp_) {
                        int s = cb.bmv[0][i][comp_] + cb.bmv[1][i][comp_] + cb.bmv[2][i][comp_] +
                                cb.bmv[3][i][comp_];
                        return (s < 0 ? s - 2 : s + 2) / 4;
                    };
                    one(x0, y0, 4, 4, avg(0), avg(1));
                }
            }
        }
    }

    void decode_block(int r, int c, int bsize) {
        cr = r, cc = c;
        memset(&cb, 0, sizeof(cb));
        cb.sb_type = (uint8_t)bsize;
        cb.ref[0] = INTRA_FRAME, cb.ref[1] = NONE;
        int bw8 = B_W8[bsize], bh8 = B_H8[bsize];
        cw8 = std::min(bw8, mi_cols - c), ch8 = std::min(bh8, mi_rows - r);
        above_mi = r > 0 ? mi_at(r - 1, c) : nullptr;
        left_mi = c > tile_col_start ? mi_at(r, c - 1) : nullptr;
        bool intra_frame = hd.keyframe || hd.intra_only;
        if (intra_frame) {
            read_segment_id_intra();
            read_skip();
            read_tx_size(true);
            read_intra_modes_kf();
            cb.interp_filter = 3;
        } else {
            read_segment_id_inter(bw8, bh8);
            read_skip();
            int is_inter;
            if (hd.seg_enabled && feat[cb.seg_id].ref_enabled) {
                is_inter = feat[cb.seg_id].ref_val != INTRA_FRAME;
            } else {
                const MI *a = above_mi, *l = left_mi;
                int ctx;
                if (a && l) {
                    bool ai = !a->is_inter(), li = !l->is_inter();
                    ctx = ai && li ? 3 : (ai || li);
                } else if (a || l) {
                    ctx = 2 * !(a ? a : l)->is_inter();
                } else {
                    ctx = 0;
                }
                is_inter = b(fc.is_inter[ctx], K_IS_INTER);
                ++counts.is_inter[ctx][is_inter];
            }
            read_tx_size(!cb.skip || !is_inter);
            if (is_inter) read_inter_block();
            else read_intra_modes_inter();
        }
        if (hd.seg_enabled && (hd.seg_update_map || intra_frame))
            for (int y = 0; y < ch8; ++y)
                memset(&cur->segmap[(size_t)(r + y) * mi_cols + c], cb.seg_id, cw8);
        // reconstruction
        int seg = cb.seg_id;
        int uvtx = cb.tx_size;
        {
            int cw = std::max(4, (B_W4[bsize] * 4) >> 1), ch = std::max(4, (B_H4[bsize] * 4) >> 1);
            int m = std::min(cw, ch);
            int mt = m >= 32 ? 3 : m >= 16 ? 2 : m >= 8 ? 1 : 0;
            uvtx = std::min(uvtx, mt);
        }
        if (cb.skip) {
            // the contexts of the whole block go to 0
            memset(&above_nnz[0][c * 2], 0, std::max(2, (int)B_W4[bsize]));
            memset(&left_nnz[0][(r & 7) * 2], 0, std::max(2, (int)B_H4[bsize]));
            for (int p = 1; p < 3; ++p) {
                memset(&above_nnz[p][c], 0, bw8);
                memset(&left_nnz[p][r & 7], 0, bh8);
            }
        }
        int bw4 = std::max(2, (int)B_W4[bsize]), bh4 = std::max(2, (int)B_H4[bsize]);
        eob_total = 0;
        if (!cb.is_inter()) {
            for (int plane = 0; plane < 3; ++plane) {
                int sh = plane ? 1 : 0;
                int tx = plane ? uvtx : cb.tx_size, step = 1 << tx;
                int pw4 = bw4 >> sh, ph4 = bh4 >> sh;
                int x0 = (c * 2) >> sh, y0 = (r * 2) >> sh;
                int max_w = std::min(pw4, ((mi_cols - c) * 2) >> sh);
                int max_h = std::min(ph4, ((mi_rows - r) * 2) >> sh);
                for (int y = 0; y < max_h; y += step)
                    for (int x = 0; x < max_w; x += step) {
                        int mode = plane ? cb.uv_mode
                                         : (bsize < BLOCK_8X8 ? cb.sub_modes[y * 2 + x] : cb.mode);
                        predict_intra(plane, x0 + x, y0 + y, tx, mode, pw4);
                        if (!cb.skip) {
                            int type = (plane || tx == TX_32X32 || hd.lossless) ? DCT_DCT
                                                                                : MODE_TO_TX_TYPE[mode];
                            eob_total += residual(plane, x0 + x, y0 + y, tx, type, seg);
                        }
                    }
            }
        } else {
            predict_inter();
            if (!cb.skip) {
                for (int plane = 0; plane < 3; ++plane) {
                    int sh = plane ? 1 : 0;
                    int tx = plane ? uvtx : cb.tx_size, step = 1 << tx;
                    int pw4 = bw4 >> sh, ph4 = bh4 >> sh;
                    int x0 = (c * 2) >> sh, y0 = (r * 2) >> sh;
                    int max_w = std::min(pw4, ((mi_cols - c) * 2) >> sh);
                    int max_h = std::min(ph4, ((mi_rows - r) * 2) >> sh);
                    for (int y = 0; y < max_h; y += step)
                        for (int x = 0; x < max_w; x += step)
                            eob_total += residual(plane, x0 + x, y0 + y, tx, DCT_DCT, seg);
                }
                if (bsize >= BLOCK_8X8 && eob_total == 0) cb.skip = 1;
            }
        }
        // keep the block for its neighbours and the next frame
        for (int y = 0; y < ch8; ++y)
            for (int x = 0; x < cw8; ++x) *mi_at(r + y, c + x) = cb;
        for (int y = 0; y < ch8; ++y)
            for (int x = 0; x < cw8; ++x) {
                MvPair& m = cur->mvs[(size_t)(r + y) * mi_cols + c + x];
                m.ref[0] = cb.ref[0], m.ref[1] = cb.ref[1];
                memcpy(m.mv, cb.mv, sizeof(m.mv));
            }
        mask_block(r, c, bw8, bh8, uvtx);
    }

    // ── the loop filter (FFmpeg's mask_edges and filter_plane_*) ────────
    static void mask_edges(uint8_t (*mask)[8][4], int ss_h, int ss_v, int row_and_7, int col_and_7,
                           int w, int h, int col_end, int row_end, int tx, int skip_inter) {
        static const unsigned wide_filter_col_mask[2] = {0x11, 0x01};
        static const unsigned wide_filter_row_mask[2] = {0x03, 0x07};
        if (tx == TX_4X4 && (ss_v | ss_h)) {
            if (h == ss_v) {
                if (row_and_7 & 1) return;
                if (!row_end) h += 1;
            }
            if (w == ss_h) {
                if (col_and_7 & 1) return;
                if (!col_end) w += 1;
            }
        }
        if (tx == TX_4X4 && !skip_inter) {
            int t = 1 << col_and_7, m_col = (t << w) - t;
            int m_row_8 = m_col & wide_filter_col_mask[ss_h], m_row_4 = m_col - m_row_8;
            for (int y = row_and_7; y < h + row_and_7; ++y) {
                int col_mask_id = 2 - !(y & wide_filter_row_mask[ss_v]);
                mask[0][y][1] |= m_row_8;
                mask[0][y][2] |= m_row_4;
                if ((ss_h & ss_v) && (col_end & 1) && (y & 1))
                    mask[1][y][col_mask_id] |= (t << (w - 1)) - t;
                else
                    mask[1][y][col_mask_id] |= m_col;
                if (!ss_h) mask[0][y][3] |= m_col;
                if (!ss_v) {
                    if (ss_h && (col_end & 1)) mask[1][y][3] |= (t << (w - 1)) - t;
                    else mask[1][y][3] |= m_col;
                }
            }
        } else {
            int t = 1 << col_and_7, m_col = (t << w) - t;
            if (!skip_inter) {
                int mask_id = tx == TX_8X8;
                int l2 = tx + ss_h - 1;
                static const unsigned masks[4] = {0xff, 0x55, 0x11, 0x01};
                int m_row = m_col & masks[l2];
                if (ss_h && tx > TX_8X8 && (w ^ (w - 1)) == 1) {
                    int m_row_16 = ((t << (w - 1)) - t) & masks[l2];
                    int m_row_8 = m_row - m_row_16;
                    for (int y = row_and_7; y < h + row_and_7; ++y) {
                        mask[0][y][0] |= m_row_16;
                        mask[0][y][1] |= m_row_8;
                    }
                } else {
                    for (int y = row_and_7; y < h + row_and_7; ++y) mask[0][y][mask_id] |= m_row;
                }
                l2 = tx + ss_v - 1;
                int step1d = 1 << l2;
                if (ss_v && tx > TX_8X8 && (h ^ (h - 1)) == 1) {
                    int y;
                    for (y = row_and_7; y < h + row_and_7 - 1; y += step1d) mask[1][y][0] |= m_col;
                    if (y - row_and_7 == h - 1) mask[1][y][1] |= m_col;
                } else {
                    for (int y = row_and_7; y < h + row_and_7; y += step1d) mask[1][y][mask_id] |= m_col;
                }
            } else if (tx != TX_4X4) {
                int mask_id = (tx == TX_8X8) || (h == ss_v);
                mask[1][row_and_7][mask_id] |= m_col;
                mask_id = (tx == TX_8X8) || (w == ss_h);
                for (int y = row_and_7; y < h + row_and_7; ++y) mask[0][y][mask_id] |= t;
            } else {
                int t8 = t & wide_filter_col_mask[ss_h], t4 = t - t8;
                for (int y = row_and_7; y < h + row_and_7; ++y) {
                    mask[0][y][2] |= t4;
                    mask[0][y][1] |= t8;
                }
                mask[1][row_and_7][2 - !(row_and_7 & wide_filter_row_mask[ss_v])] |= m_col;
            }
        }
    }

    void mask_block(int r, int c, int bw8, int bh8, int uvtx) {
        if (!hd.lf_level) return;
        int lvl = lflvl[cb.seg_id][cb.is_inter() ? cb.ref[0] : 0][cb.mode != ZEROMV];
        if (lvl <= 0) return;
        LfSb& L = lf[(size_t)(r >> 3) * sb_cols + (c >> 3)];
        int row7 = r & 7, col7 = c & 7;
        for (int y = 0; y < bh8 && row7 + y < 8; ++y)
            for (int x = 0; x < bw8 && col7 + x < 8; ++x) L.level[(row7 + y) * 8 + col7 + x] = (uint8_t)lvl;
        int x_end = std::min(mi_cols - c, bw8), y_end = std::min(mi_rows - r, bh8);
        int skip_inter = cb.is_inter() && cb.skip;
        mask_edges(L.mask[0], 0, 0, row7, col7, x_end, y_end, 0, 0, cb.tx_size, skip_inter);
        mask_edges(L.mask[1], 1, 1, row7, col7, x_end, y_end,
                   (mi_cols & 1) && c + bw8 >= mi_cols ? mi_cols & 7 : 0,
                   (mi_rows & 1) && r + bh8 >= mi_rows ? mi_rows & 7 : 0, uvtx, skip_inter);
    }

    void lf_call(uint8_t* dst, ptrdiff_t along, ptrdiff_t across, int L, int wd) {
        loop_filter(dst, mblim_lut[L], lim_lut[L], L >> 4, along, across, wd);
    }

    void filter_plane_cols(int col, int ss_h, int ss_v, const uint8_t* lvl, uint8_t (*mask)[4],
                           uint8_t* dst, ptrdiff_t ls) {
        for (int y = 0; y < 8; y += 2 << ss_v, dst += 16 * ls, lvl += 16 << ss_v) {
            uint8_t* ptr = dst;
            const uint8_t* l = lvl;
            uint8_t *hmask1 = mask[y], *hmask2 = mask[y + 1 + ss_v];
            unsigned hm1 = hmask1[0] | hmask1[1] | hmask1[2], hm13 = hmask1[3];
            unsigned hm2 = hmask2[1] | hmask2[2], hm23 = hmask2[3];
            unsigned hm = hm1 | hm2 | hm13 | hm23;
            for (unsigned x = 1; hm & ~(x - 1); x <<= 1, ptr += 8 >> ss_h) {
                if (col || x > 1) {
                    if (hm1 & x) {
                        int L = *l;
                        if (hmask1[0] & x) {
                            if (hmask2[0] & x) {
                                lf_call(ptr, ls, 1, L, 16);
                                lf_call(ptr + 8 * ls, ls, 1, L, 16);
                            } else {
                                lf_call(ptr, ls, 1, L, 16);
                            }
                        } else if (hm2 & x) {
                            int L2 = l[8 << ss_v];
                            lf_call(ptr, ls, 1, L, (hmask1[1] & x) ? 8 : 4);
                            lf_call(ptr + 8 * ls, ls, 1, L2, (hmask2[1] & x) ? 8 : 4);
                        } else {
                            lf_call(ptr, ls, 1, L, (hmask1[1] & x) ? 8 : 4);
                        }
                    } else if (hm2 & x) {
                        int L = l[8 << ss_v];
                        lf_call(ptr + 8 * ls, ls, 1, L, (hmask2[1] & x) ? 8 : 4);
                    }
                }
                if (ss_h) {
                    if (x & 0xAA) l += 2;
                } else {
                    if (hm13 & x) {
                        int L = *l;
                        if (hm23 & x) {
                            int L2 = l[8 << ss_v];
                            lf_call(ptr + 4, ls, 1, L, 4);
                            lf_call(ptr + 8 * ls + 4, ls, 1, L2, 4);
                        } else {
                            lf_call(ptr + 4, ls, 1, L, 4);
                        }
                    } else if (hm23 & x) {
                        int L = l[8 << ss_v];
                        lf_call(ptr + 8 * ls + 4, ls, 1, L, 4);
                    }
                    l++;
                }
            }
        }
    }

    void filter_plane_rows(int row, int ss_h, int ss_v, const uint8_t* lvl, uint8_t (*mask)[4],
                           uint8_t* dst, ptrdiff_t ls) {
        for (int y = 0; y < 8; y++, dst += 8 * ls >> ss_v) {
            uint8_t* ptr = dst;
            const uint8_t* l = lvl;
            uint8_t* vmask = mask[y];
            unsigned vm = vmask[0] | vmask[1] | vmask[2], vm3 = vmask[3];
            for (unsigned x = 1; vm & ~(x - 1); x <<= (2 << ss_h), ptr += 16, l += 2 << ss_h) {
                unsigned x2 = x << (1 + ss_h);
                if (row || y) {
                    if (vm & x) {
                        int L = *l;
                        if (vmask[0] & x) {
                            if (vmask[0] & x2) {
                                lf_call(ptr, 1, ls, L, 16);
                                lf_call(ptr + 8, 1, ls, L, 16);
                            } else {
                                lf_call(ptr, 1, ls, L, 16);
                            }
                        } else if (vm & x2) {
                            int L2 = l[1 + ss_h];
                            lf_call(ptr, 1, ls, L, (vmask[1] & x) ? 8 : 4);
                            lf_call(ptr + 8, 1, ls, L2, (vmask[1] & x2) ? 8 : 4);
                        } else {
                            lf_call(ptr, 1, ls, L, (vmask[1] & x) ? 8 : 4);
                        }
                    } else if (vm & x2) {
                        int L = l[1 + ss_h];
                        lf_call(ptr + 8, 1, ls, L, (vmask[1] & x2) ? 8 : 4);
                    }
                }
                if (!ss_v) {
                    if (vm3 & x) {
                        int L = *l;
                        if (vm3 & x2) {
                            int L2 = l[1 + ss_h];
                            lf_call(ptr + ls * 4, 1, ls, L, 4);
                            lf_call(ptr + ls * 4 + 8, 1, ls, L2, 4);
                        } else {
                            lf_call(ptr + ls * 4, 1, ls, L, 4);
                        }
                    } else if (vm3 & x2) {
                        int L = l[1 + ss_h];
                        lf_call(ptr + ls * 4 + 8, 1, ls, L, 4);
                    }
                }
            }
            if (ss_v) {
                if (y & 1) lvl += 16;
            } else {
                lvl += 8;
            }
        }
    }

    void loop_filter_frame() {
        if (!hd.lf_level) return;
        Frame& fr = *cur;
        for (int sr = 0; sr < sb_rows; ++sr)
            for (int sc = 0; sc < sb_cols; ++sc) {
                LfSb& L = lf[(size_t)sr * sb_cols + sc];
                int row = sr * 8, col = sc * 8;
                uint8_t* y = fr.plane[0].data() + (size_t)(row * 8) * fr.stride[0] + col * 8;
                filter_plane_cols(col, 0, 0, L.level, L.mask[0][0], y, fr.stride[0]);
                filter_plane_rows(row, 0, 0, L.level, L.mask[0][1], y, fr.stride[0]);
                for (int p = 1; p < 3; ++p) {
                    uint8_t* d = fr.plane[p].data() + (size_t)(row * 4) * fr.stride[p] + col * 4;
                    filter_plane_cols(col, 1, 1, L.level, L.mask[1][0], d, fr.stride[p]);
                    filter_plane_rows(row, 1, 1, L.level, L.mask[1][1], d, fr.stride[p]);
                }
            }
    }

    // ── a frame ─────────────────────────────────────────────────────────
    void decode_tiles() {
        int tile_cols = 1 << hd.tile_cols_log2, tile_rows = 1 << hd.tile_rows_log2;
        above_part.assign(mi_cols + 16, 0);
        above_segpred.assign(mi_cols + 16, 0);
        for (int p = 0; p < 3; ++p) above_nnz[p].assign(mi_cols * 2 + 32, 0);
        for (int tr = 0; tr < tile_rows; ++tr) {
            int row_start = std::min((tr * sb_rows) >> hd.tile_rows_log2, sb_rows) * 8;
            int row_end = std::min(((tr + 1) * sb_rows) >> hd.tile_rows_log2, sb_rows) * 8;
            for (int tc = 0; tc < tile_cols; ++tc) {
                bool last_tile = tr == tile_rows - 1 && tc == tile_cols - 1;
                tile_col_start = std::min((tc * sb_cols) >> hd.tile_cols_log2, sb_cols) * 8;
                tile_col_end = std::min(((tc + 1) * sb_cols) >> hd.tile_cols_log2, sb_cols) * 8;
                tile_col_end = std::min(tile_col_end, mi_cols);
                int err = src.open_tile(last_tile);
                if (err) { probe.error = err; fail("VP9: a tile runs past the packet"); }
                for (int r = row_start; r < row_end; r += 8) {
                    memset(left_part, 0, sizeof(left_part));
                    memset(left_segpred, 0, sizeof(left_segpred));
                    memset(left_nnz, 0, sizeof(left_nnz));
                    for (int c = tile_col_start; c < tile_col_end; c += 8) {
                        if (src.exhausted()) { probe.error = 10; fail("VP9: a tile's data ends early"); }
                        decode_partition(r, c, 0);
                    }
                }
                src.close_tile(last_tile);
            }
        }
    }

    void adapt() {
        Header& h = hd;
        ProbCtx& p = ctx[h.ctx_idx];
        unsigned uf = (h.keyframe || h.intra_only || !last_keyframe) ? 112 : 128;
        for (int t = 0; t < 4; ++t)
            for (int i = 0; i < 2; ++i)
                for (int j = 0; j < 2; ++j)
                    for (int k = 0; k < 6; ++k)
                        for (int l = 0; l < (k ? 6 : 3); ++l) {
                            uint8_t* pp = p.coef[t][i][j][k][l];
                            unsigned* e = counts.eob[t][i][j][k][l];
                            unsigned* c = counts.coef[t][i][j][k][l];
                            pp[0] = merge_prob(pp[0], e[0], e[1], 24, uf);
                            pp[1] = merge_prob(pp[1], c[0], c[1] + c[2], 24, uf);
                            pp[2] = merge_prob(pp[2], c[1], c[2], 24, uf);
                        }
        if (h.keyframe || h.intra_only) {
            memcpy(p.skip, fc.skip, sizeof(p.skip));
            memcpy(p.tx8, fc.tx8, sizeof(p.tx8));
            memcpy(p.tx16, fc.tx16, sizeof(p.tx16));
            memcpy(p.tx32, fc.tx32, sizeof(p.tx32));
            return;
        }
        for (int i = 0; i < 3; ++i) p.skip[i] = merge_prob(p.skip[i], counts.skip[i][0], counts.skip[i][1], 20, 128);
        for (int i = 0; i < 4; ++i)
            p.is_inter[i] = merge_prob(p.is_inter[i], counts.is_inter[i][0], counts.is_inter[i][1], 20, 128);
        if (h.comp_mode == REFERENCE_SELECT)
            for (int i = 0; i < 5; ++i)
                p.comp_mode[i] = merge_prob(p.comp_mode[i], counts.comp_mode[i][0], counts.comp_mode[i][1], 20, 128);
        if (h.comp_mode != SINGLE_REF)
            for (int i = 0; i < 5; ++i)
                p.comp_ref[i] = merge_prob(p.comp_ref[i], counts.comp_ref[i][0], counts.comp_ref[i][1], 20, 128);
        if (h.comp_mode != COMPOUND_REF)
            for (int i = 0; i < 5; ++i)
                for (int j = 0; j < 2; ++j)
                    p.single_ref[i][j] = merge_prob(p.single_ref[i][j], counts.single_ref[i][j][0],
                                                    counts.single_ref[i][j][1], 20, 128);
        for (int i = 0; i < 16; ++i) tree_merge(PARTITION_TREE, 0, p.partition[i], counts.partition[i], p.partition[i]);
        if (h.tx_mode == TX_MODE_SELECT)
            for (int i = 0; i < 2; ++i) {
                unsigned *c8 = counts.tx8[i], *c16 = counts.tx16[i], *c32 = counts.tx32[i];
                p.tx8[i][0] = merge_prob(p.tx8[i][0], c8[0], c8[1], 20, 128);
                p.tx16[i][0] = merge_prob(p.tx16[i][0], c16[0], c16[1] + c16[2], 20, 128);
                p.tx16[i][1] = merge_prob(p.tx16[i][1], c16[1], c16[2], 20, 128);
                p.tx32[i][0] = merge_prob(p.tx32[i][0], c32[0], c32[1] + c32[2] + c32[3], 20, 128);
                p.tx32[i][1] = merge_prob(p.tx32[i][1], c32[1], c32[2] + c32[3], 20, 128);
                p.tx32[i][2] = merge_prob(p.tx32[i][2], c32[2], c32[3], 20, 128);
            }
        if (h.interp_filter == SWITCHABLE)
            for (int i = 0; i < 4; ++i) tree_merge(INTERP_FILTER_TREE, 0, p.filter[i], counts.filter[i], p.filter[i]);
        for (int i = 0; i < 7; ++i)
            tree_merge(INTER_MODE_TREE, 0, p.inter_mode[i], counts.inter_mode[i], p.inter_mode[i]);
        tree_merge(MV_JOINT_TREE, 0, p.mv_joint, counts.mv_joint, p.mv_joint);
        for (int i = 0; i < 2; ++i) {
            uint8_t* m = p.mv[i];
            MvCounts& c = counts.mv[i];
            m[MV_SIGN] = merge_prob(m[MV_SIGN], c.sign[0], c.sign[1], 20, 128);
            tree_merge(MV_CLASS_TREE, 0, m + MV_CLASSES, c.classes, m + MV_CLASSES);
            m[MV_CLASS0] = merge_prob(m[MV_CLASS0], c.class0[0], c.class0[1], 20, 128);
            for (int j = 0; j < 10; ++j) m[MV_BITS + j] = merge_prob(m[MV_BITS + j], c.bits[j][0], c.bits[j][1], 20, 128);
            for (int j = 0; j < 2; ++j)
                tree_merge(MV_FP_TREE, 0, m + MV_CLASS0_FP + 3 * j, c.class0_fp[j], m + MV_CLASS0_FP + 3 * j);
            tree_merge(MV_FP_TREE, 0, m + MV_FP, c.fp, m + MV_FP);
            if (h.allow_hp) {
                m[MV_CLASS0_HP] = merge_prob(m[MV_CLASS0_HP], c.class0_hp[0], c.class0_hp[1], 20, 128);
                m[MV_HP] = merge_prob(m[MV_HP], c.hp[0], c.hp[1], 20, 128);
            }
        }
        for (int i = 0; i < 4; ++i) tree_merge(INTRA_MODE_TREE, 0, p.y_mode[i], counts.y_mode[i], p.y_mode[i]);
        for (int i = 0; i < 10; ++i) tree_merge(INTRA_MODE_TREE, 0, p.uv_mode[i], counts.uv_mode[i], p.uv_mode[i]);
    }

    // decode the frame the source holds: SHOWN or HIDDEN (`shown` is the
    // picture to show); throws DecodeError
    int decode_frame() {
        probe = Probe{};
        src.frame_begin();
        // FFmpeg keeps the segment map's frame by the frame before's header;
        // an error-resilient frame before takes its place (a map it did not
        // write: FFmpeg's frame pool gives zeros while its buffers are new)
        bool retain = segmap_ref && (!hd.seg_enabled || !hd.seg_update_map) && !hd.error_res;
        if (read_uncompressed_header()) {
            const FramePtr& r = refs[hd.existing_idx];
            if (!r) { probe.error = 7; fail("VP9: show_existing_frame of a slot never filled"); }
            shown = r;
            return SHOWN;
        }
        Header& h = hd;
        if (!h.keyframe && !h.intra_only)
            for (int i = 0; i < 3; ++i) {
                const Frame& r = *refs[h.ref_idx[i]];
                if (r.w != h.width || r.h != h.height) {
                    probe.error = 8;
                    fail("VP9: a reference of another size (scaled motion compensation)");
                }
            }
        if (h.keyframe || h.error_res || (h.intra_only && h.reset_ctx == 3)) {
            for (auto& c : ctx) default_probs(c);
        } else if (h.intra_only && h.reset_ctx == 2) {
            default_probs(ctx[h.ctx_read]);
        }
        int err = src.open_compressed(h.compressed_size);
        if (err) { probe.error = err; fail("VP9: the compressed header runs past the packet"); }
        fc = ctx[h.ctx_read];
        memset(&counts, 0, sizeof(counts));
        read_compressed_header();
        src.close_compressed();
        setup_segment_tables();
        if (!retain || h.keyframe || h.intra_only) {
            segmap_ref.reset();
            if (!h.keyframe && !h.intra_only && !h.error_res && last) segmap_ref = last;
        }
        cur = std::make_shared<Frame>();
        cur->alloc(h.width, h.height);
        if (h.keyframe) {
            cur->colour_space = h.colour_space, cur->full_range = h.full_range;
        } else if (h.intra_only) {
            cur->colour_space = 1, cur->full_range = 0;
        } else if (last) {
            cur->colour_space = last->colour_space, cur->full_range = last->full_range;
        }
        if (h.seg_enabled && !h.seg_update_map && !h.intra_only && !h.keyframe && !h.error_res &&
            segmap_ref && segmap_ref->segmap.size() == cur->segmap.size())
            cur->segmap = segmap_ref->segmap;
        mi.assign((size_t)mi_cols * mi_rows, MI{});
        lf.assign((size_t)sb_cols * sb_rows, LfSb{});
        if (h.refresh_ctx && h.parallel) {
            ProbCtx& t = ctx[h.ctx_idx];
            ProbCtx keep = t;
            t = fc;
            for (int tx = TX_MODE_MAX[h.tx_mode] + 1; tx < 4; ++tx)
                memcpy(t.coef[tx], keep.coef[tx], sizeof(t.coef[tx]));
        }
        decode_tiles();
        loop_filter_frame();
        if (h.refresh_ctx && !h.parallel) adapt();
        for (int i = 0; i < 8; ++i)
            if ((h.refresh_flags >> i) & 1) refs[i] = cur;
        last = cur;
        if (h.show_frame) shown = cur;
        return h.show_frame ? SHOWN : HIDDEN;
    }
};

// ── the port's source of syntax: a packet ───────────────────────────────

struct Reader {
    const uint8_t* data = nullptr;
    size_t size = 0, pos = 0;       // pos: the next byte after what was opened
    BitReader br;
    BoolDecoder bd;

    void set(const uint8_t* d, size_t n) { data = d, size = n; }
    void frame_begin() { br.init(data, size); }
    int f(int n, int) { return br.read(n); }
    int b(int p, int) { return bd.get(p); }
    int tree(const int8_t* t, const uint8_t* p, int) {
        int i = 0;
        do {
            i = t[i + bd.get(p[i >> 1])];
        } while (i > 0);
        return -i;
    }
    int lit(int n) {
        int v = 0;
        while (n--) v = (v << 1) | bd.get(128);
        return v;
    }
    int update_prob(int p) {
        int d;
        if (!bd.get(128)) d = lit(4);
        else if (!bd.get(128)) d = lit(4) + 16;
        else if (!bd.get(128)) d = lit(5) + 32;
        else {
            d = lit(7);
            if (d >= 65) d = (d << 1) - 65 + bd.get(128);
            d += 64;
        }
        auto inv_recenter = [](int v, int m) {
            if (v > 2 * m) return v;
            return (v & 1) ? m - ((v + 1) >> 1) : m + (v >> 1);
        };
        int v = INV_MAP_TABLE[d];
        return p <= 128 ? 1 + inv_recenter(v, p - 1) : 255 - inv_recenter(v, 255 - p);
    }
    int mv_prob() { return (lit(7) << 1) | 1; }
    int token(const uint8_t* tp, int* val) {
        if (!bd.get(tp[1])) return 0;
        if (!bd.get(tp[2])) { *val = 1; return 1; }
        if (!bd.get(tp[3])) {
            if (!bd.get(tp[4])) { *val = 2; return 2; }
            if (!bd.get(tp[5])) { *val = 3; return 3; }
            *val = 4;
            return 4;
        }
        int cat;
        if (!bd.get(tp[6])) cat = bd.get(tp[7]) ? 1 : 0;
        else if (!bd.get(tp[8])) cat = bd.get(tp[9]) ? 3 : 2;
        else cat = bd.get(tp[10]) ? 5 : 4;
        int v = 0;
        for (const uint8_t* p = CAT_PROBS + CAT_START[cat]; *p; ++p) v = (v << 1) | bd.get(*p);
        *val = CAT_BASE[cat] + v;
        return 5 + cat;
    }
    int mv_comp(const uint8_t* m, bool hp, int) {
        int sign = bd.get(m[MV_SIGN]);
        int c = tree(MV_CLASS_TREE, m + MV_CLASSES, 0);
        int mag;
        if (!c) {
            int d = bd.get(m[MV_CLASS0]);
            int fr = tree(MV_FP_TREE, m + MV_CLASS0_FP + 3 * d, 0);
            int e = hp ? bd.get(m[MV_CLASS0_HP]) : 1;
            mag = ((d << 3) | (fr << 1) | e) + 1;
        } else {
            int d = 0;
            for (int i = 0; i < c; ++i) d |= bd.get(m[MV_BITS + i]) << i;
            int fr = tree(MV_FP_TREE, m + MV_FP, 0);
            int e = hp ? bd.get(m[MV_HP]) : 1;
            mag = (2 << (c + 2)) + ((d << 3) | (fr << 1) | e) + 1;
        }
        return sign ? -mag : mag;
    }
    // 0, or a Probe error: the compressed header past the packet
    int open_compressed(int n) {
        pos = br.bytes();
        if (!n) return 11;
        if ((size_t)n > size - std::min(size, pos)) return 9;
        bd.init(data + pos, n);
        pos += n;
        if (bd.get(128)) return 12;
        return 0;
    }
    void close_compressed() {}
    int open_tile(bool last) {
        size_t n;
        if (last) {
            n = size - pos;
        } else {
            if (size - pos < 4) return 13;
            n = (size_t)data[pos] << 24 | data[pos + 1] << 16 | data[pos + 2] << 8 | data[pos + 3];
            pos += 4;
            if (n > size - pos) return 13;
        }
        if (!n) return 13;
        bd.init(data + pos, n);
        pos += n;
        if (bd.get(128)) return 12;
        return 0;
    }
    void close_tile(bool) {}
    bool exhausted() { return bd.at_end(); }
};

}  // namespace vp9

// ── the plain-C interface ───────────────────────────────────────────────

#ifndef VP9_NO_C_API
namespace {

struct Handle {
    vp9::Reader reader;
    vp9::Decoder<vp9::Reader> dec{reader};
    std::string error;
    bool spent = false;
};

}  // namespace

extern "C" {

void* vp9d_new() {
    try {
        return new Handle();
    } catch (...) {
        return nullptr;
    }
}

void vp9d_free(void* h) { delete static_cast<Handle*>(h); }

// one frame (a superframe split already): SHOWN, HIDDEN, or FAILED (the
// decoder is then spent: `vp9d_error` says why)
int vp9d_decode(void* hp, const uint8_t* data, int64_t size) {
    Handle& h = *static_cast<Handle*>(hp);
    if (h.spent) {
        h.error = "VP9: the decoder failed on an earlier frame";
        return vp9::FAILED;
    }
    try {
        h.reader.set(data, (size_t)size);
        return h.dec.decode_frame();
    } catch (const std::exception& e) {
        h.error = e.what();
        h.spent = true;
        return vp9::FAILED;
    }
}

const char* vp9d_error(void* h) { return static_cast<Handle*>(h)->error.c_str(); }

// the last error's probe code, and the last header read
void vp9d_probe_of(void* hp, int32_t* out) {
    const vp9::Probe& p = static_cast<Handle*>(hp)->dec.probe;
    const int32_t v[20] = {p.error, p.profile, p.show_existing, p.existing_idx, p.keyframe,
                           p.intra_only, p.show_frame, p.width, p.height, p.colour_space,
                           p.full_range, p.refresh_flags, p.ref_idx[0], p.ref_idx[1], p.ref_idx[2],
                           p.error_res, p.found_ref, 0, 0, 0};
    memcpy(out, v, sizeof(v));
}

// the picture to show: width, height, colour_space, full_range
void vp9d_size(void* hp, int32_t* out) {
    const vp9::FramePtr& f = static_cast<Handle*>(hp)->dec.shown;
    out[0] = f ? f->w : 0;
    out[1] = f ? f->h : 0;
    out[2] = f ? f->colour_space : 0;
    out[3] = f ? f->full_range : 0;
}

// copy the picture to show into Y (w x h), Cb and Cr ((w+1)/2 x (h+1)/2)
int vp9d_take(void* hp, uint8_t* y, uint8_t* u, uint8_t* v) {
    const vp9::FramePtr& f = static_cast<Handle*>(hp)->dec.shown;
    if (!f) return 1;
    uint8_t* out[3] = {y, u, v};
    for (int p = 0; p < 3; ++p)
        for (int r = 0; r < f->ph[p]; ++r)
            memcpy(out[p] + (size_t)r * f->pw[p], f->plane[p].data() + (size_t)r * f->stride[p], f->pw[p]);
    return 0;
}

// the uncompressed header of a frame, read with no decoder state (an inter
// frame's references taken as w x h): the fields vp9d_probe_of gives, then
// the header's length in bytes, the compressed header's size and the tile
// columns' and rows' log2
void vp9d_probe(const uint8_t* data, int64_t size, int32_t w, int32_t h, int32_t* out) {
    vp9::Reader r;
    vp9::Decoder<vp9::Reader> d(r);
    r.set(data, (size_t)size);
    for (auto& f : d.refs) {
        f = std::make_shared<vp9::Frame>();
        f->w = w, f->h = h;
    }
    try {
        r.frame_begin();
        d.read_uncompressed_header();
        d.probe.header_bytes = (int)r.br.bytes();
    } catch (...) {
    }
    const vp9::Probe& p = d.probe;
    const int32_t v[24] = {p.error, p.profile, p.show_existing, p.existing_idx, p.keyframe,
                           p.intra_only, p.show_frame, p.width, p.height, p.colour_space,
                           p.full_range, p.refresh_flags, p.ref_idx[0], p.ref_idx[1], p.ref_idx[2],
                           p.error_res, p.found_ref, p.header_bytes, p.compressed_size,
                           p.tile_cols_log2, p.tile_rows_log2, 0, 0, 0};
    memcpy(out, v, sizeof(v));
}

}  // extern "C"
#endif
