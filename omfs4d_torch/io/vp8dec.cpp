// VP8 (RFC 6386) decoded on the host, as FFmpeg's `vp8` decoder decodes it
// inside cv2: frame by frame, each to three 8-bit 4:2:0 planes.
//
// Built by g++ at first use (`omfs4d_torch.io.vp8`) with the generated
// `vp8_tables.h` (`omfs4d_torch/io/vp8_tables.py`), and bound with ctypes
// through a plain-C interface (the `vp8d_*` functions at the end).
//
// Where FFmpeg reads the stream otherwise than the RFC's reference decoder,
// this decoder follows FFmpeg:
// - the key frame's `clamping_type` bit is taken as the full-range flag (it
//   sets the frame's colour range) and every pixel is clamped whatever it says;
// - the horizontal and vertical scale bits are ignored;
// - a segment's quantiser and filter level are not clamped before the
//   frame's deltas are added, only the sums are;
// - a reference copy (golden to altref, altref to golden) takes the
//   reference as it was before the frame;
// - version 3 truncates the chroma vectors to whole pixels and filters luma
//   bilinearly, as versions 1 and 2 do;
// - the above-right pixels of the last macroblock of a row repeat the last
//   pixel above it;
// - a range decoder reads its partition two bytes at a time after its first
//   three, so it may read one byte past its partition (the packet's next
//   byte, or a zero past the packet), and zeros after that;
// - a frame whose header is cut short, whose key frame start code is wrong
//   or whose partitions run past the packet is dropped: no picture, no
//   reference changed (`DROPPED`, with its reason); so is an inter frame
//   before the first key frame;
// - a token partition that runs dry (FFmpeg's `vpx_rac_is_end` for the
//   eleventh macroblock) is an error: FFmpeg leaves the frame's remaining
//   rows undecoded.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <string>
#include <vector>

#include "vp8_tables.h"

namespace {

enum { SHOWN = 0, HIDDEN = 1, DROPPED = 2, FAILED = -1 };

// drop reasons, as `omfs4d_torch.io.vp8.DROP_REASONS` names them
enum { OK = 0, SHORT_TAG, FIRST_PAST_PACKET, NO_START_CODE, EMPTY_FIRST, TABLE_PAST_PACKET,
       PART_PAST_PACKET, EMPTY_PART, ZERO_SIZE, NO_KEY_FRAME };

enum { DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED, NEARESTMV, NEARMV, ZEROMV, NEWMV, SPLITMV };
enum { B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU };
enum { INTRA = 0, LAST = 1, GOLDEN = 2, ALTREF = 3, NO_REF = -1 };
enum { SPLIT_NONE = 4 };

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }
inline int clip_s8(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }

// ── the boolean decoder ─────────────────────────────────────────────────

struct BoolDecoder {
    const uint8_t* data = nullptr;   // the packet
    size_t size = 0;                 // its length
    size_t pos = 0, lim = 0;         // the next byte, the end of what FFmpeg reads
    uint64_t value = 0;
    int count = -8;
    uint32_t range = 255;
    uint64_t shifted = 0, end_bits = 0;
    int end_reached = 0;

    void init(const uint8_t* pkt, size_t pkt_size, size_t start, size_t n) {
        data = pkt;
        size = pkt_size;
        pos = start;
        size_t k = n < 3 ? 3 : 3 + 2 * ((n - 2) / 2);   // 3, then whole pairs
        lim = start + k;
        value = 0;
        count = -8;
        range = 255;
        shifted = 0;
        end_bits = 8 * (uint64_t)k - 8;
        end_reached = 0;
        fill();
    }
    void fill() {
        int shift = 64 - 8 - (count + 8);
        while (shift >= 0) {
            if (pos >= lim) {
                count += 0x4000;                 // zeros from here on
                break;
            }
            count += 8;
            value |= (uint64_t)(pos < size ? data[pos] : 0) << shift;
            ++pos;
            shift -= 8;
        }
    }
    int get(int prob) {
        uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
        if (count < 0) fill();
        uint64_t big = (uint64_t)split << 56;
        int bit = 0;
        if (value >= big) {
            range -= split;
            value -= big;
            bit = 1;
        } else {
            range = split;
        }
        int shift = __builtin_clz(range) - 24;
        range <<= shift;
        value <<= shift;
        count -= shift;
        shifted += shift;
        return bit;
    }
    int bit() { return get(128); }
    int literal(int n) {
        int v = 0;
        while (n--) v = (v << 1) | get(128);
        return v;
    }
    int signed_literal(int n) {          // FFmpeg's vp8_rac_get_sint: a flag first
        if (!bit()) return 0;
        int v = literal(n);
        return bit() ? -v : v;
    }
    int tree(const int8_t* t, const uint8_t* probs) {
        int i = 0;
        while ((i = t[i + get(probs[i >> 1])]) > 0) {}
        return -i;
    }
    // FFmpeg's vpx_rac_is_end, asked once a macroblock
    bool at_end() {
        if (shifted >= end_bits) ++end_reached;
        return end_reached > 10;
    }
};

// ── frames ──────────────────────────────────────────────────────────────

struct Frame {
    int W, H, CW, CH;                    // macroblock-aligned sizes
    std::vector<uint8_t> y, u, v, seg;   // seg: a segment per macroblock
    Frame(int w, int h, int mbs)
        : W(w), H(h), CW(w / 2), CH(h / 2), y((size_t)w * h), u((size_t)w * h / 4),
          v((size_t)w * h / 4), seg(mbs, 0) {}
};

struct Probs {
    uint8_t coef[4][8][3][11];
    uint8_t ymode[4], uvmode[3];
    uint8_t mv[2][19];
    uint8_t segment[3];
    uint8_t skip, intra, last, golden;
};

struct MB {
    uint8_t ymode, uvmode, ref, part, segment, skip;
    int16_t mv[2];                       // y, x in quarter pixels
    int16_t bmv[16][2];                  // by partition
    uint8_t bmodes[16];
};

struct Mvs {
    int16_t v[2];
    bool operator==(const Mvs& o) const { return v[0] == o.v[0] && v[1] == o.v[1]; }
    bool zero() const { return !v[0] && !v[1]; }
};

struct Filter {
    uint8_t level, inner_limit, inner;
};

class Decoder {
public:
    std::string error;
    int reason = OK;                     // why the last frame was dropped
    int width = 0, height = 0;           // the picture's size
    int full_range = 0, colour_space = 0;
    std::shared_ptr<Frame> last;         // the last picture decoded

    // the frame header; `probe` stops it after the partitions
    int header(const uint8_t* d, size_t n, bool probe);
    int decode(const uint8_t* d, size_t n);

    // what a probe reports
    int key = 0, version = 0, show = 0, key_width = 0, key_height = 0;
    int seg_from_previous = 0;

private:
    int mbw = 0, mbh = 0;
    std::shared_ptr<Frame> ref[4];       // [LAST], [GOLDEN], [ALTREF]; [0] the last decoded
    std::vector<std::shared_ptr<Frame>> pool;
    Probs prob{}, saved{};
    bool started = false;
    // segmentation, loop filter deltas, filter, quantisers
    int seg_enabled = 0, seg_update_map = 0, seg_update_data = 0, seg_abs = 0;
    int seg_quant[4] = {0}, seg_lf[4] = {0};
    int lf_delta_enabled = 0, lf_delta_update = 0;
    int ref_delta[4] = {0}, mode_delta[4] = {0};
    int filter_simple = 0, filter_level = 0, sharpness = 0;
    int qindex = 0, q_delta[5] = {0};
    int16_t qmul[4][3][2];               // segment, (Y, Y2, chroma), (DC, AC)
    int sign_bias[4] = {0};
    int update_golden = 0, update_altref = 0, update_last = 0, update_probs = 0;
    int skip_enabled = 0;
    int num_parts = 1;
    BoolDecoder hdr, parts[8];
    // the frame being decoded
    std::vector<MB> mbs;                 // (mbh + 1) x (mbw + 1), a border row and column
    std::vector<Filter> filters;
    std::vector<uint8_t> top_nnz;        // 9 a column
    uint8_t left_nnz[9];
    std::vector<uint8_t> top_bmodes;     // 4 a column, key frames
    uint8_t left_bmodes[4];
    int16_t coeffs[25][16];
    uint8_t nnz[25];

    int drop(int why) {
        reason = why;
        return DROPPED;
    }
    int fail(const std::string& what) {
        error = what;
        return FAILED;
    }
    MB& mb_at(int x, int y) { return mbs[(size_t)(y + 1) * (mbw + 1) + (x + 1)]; }
    void reset_for_key_frame();
    void segment_info();
    void lf_deltas();
    void quantisers();
    void probability_updates();
    std::shared_ptr<Frame> new_frame();
    void mb_modes(BoolDecoder& c, MB& m, int x, int y, bool key_frame, Frame& cur,
                  const Frame* prev);
    void inter_modes(BoolDecoder& c, MB& m, int x, int y);
    int split_mvs(BoolDecoder& c, MB& m, int x, int y);
    int read_mv_component(BoolDecoder& c, const uint8_t* p);
    bool mb_tokens(BoolDecoder& c, MB& m, int x);
    int block_tokens(BoolDecoder& c, int16_t* block, int type, int first, int ctx,
                     const int16_t* q);
    void intra_mb(Frame& f, MB& m, int x, int y);
    void inter_mb(Frame& f, MB& m, int x, int y);
    void residual(Frame& f, MB& m, int x, int y);
    void filter_frame(Frame& f, bool key_frame);
};

// ── the header ──────────────────────────────────────────────────────────

void Decoder::reset_for_key_frame() {
    std::memcpy(prob.coef, COEF_PROBS, sizeof prob.coef);
    std::memcpy(prob.ymode, YMODE_PROBS, sizeof prob.ymode);
    std::memcpy(prob.uvmode, UV_MODE_PROBS, sizeof prob.uvmode);
    std::memcpy(prob.mv, MV_DEFAULT_PROBS, sizeof prob.mv);
    seg_enabled = seg_update_map = seg_update_data = seg_abs = 0;
    std::memset(seg_quant, 0, sizeof seg_quant);
    std::memset(seg_lf, 0, sizeof seg_lf);
    lf_delta_enabled = lf_delta_update = 0;
    std::memset(ref_delta, 0, sizeof ref_delta);
    std::memset(mode_delta, 0, sizeof mode_delta);
    update_golden = update_altref = INTRA;   // both from the current frame
}

void Decoder::segment_info() {
    BoolDecoder& c = hdr;
    seg_update_map = c.bit();
    seg_update_data = c.bit();
    if (seg_update_data) {
        seg_abs = c.bit();
        for (int i = 0; i < 4; ++i) seg_quant[i] = c.signed_literal(7);
        for (int i = 0; i < 4; ++i) seg_lf[i] = c.signed_literal(6);
    }
    if (seg_update_map)
        for (int i = 0; i < 3; ++i) prob.segment[i] = c.bit() ? c.literal(8) : 255;
}

void Decoder::lf_deltas() {
    BoolDecoder& c = hdr;
    for (int i = 0; i < 4; ++i)
        if (c.bit()) {
            ref_delta[i] = c.literal(6);
            if (c.bit()) ref_delta[i] = -ref_delta[i];
        }
    for (int i = 0; i < 4; ++i)
        if (c.bit()) {
            mode_delta[i] = c.literal(6);
            if (c.bit()) mode_delta[i] = -mode_delta[i];
        }
}

void Decoder::quantisers() {
    BoolDecoder& c = hdr;
    qindex = c.literal(7);
    for (int i = 0; i < 5; ++i) q_delta[i] = c.signed_literal(4);
    auto at = [](int q) { return q < 0 ? 0 : q > 127 ? 127 : q; };
    for (int s = 0; s < 4; ++s) {
        int base = qindex;
        if (seg_enabled) base = seg_abs ? seg_quant[s] : seg_quant[s] + qindex;
        // deltas: Y DC, Y2 DC, Y2 AC, chroma DC, chroma AC
        qmul[s][0][0] = DC_QLOOKUP[at(base + q_delta[0])];
        qmul[s][0][1] = AC_QLOOKUP[at(base)];
        qmul[s][1][0] = DC_QLOOKUP[at(base + q_delta[1])] * 2;
        qmul[s][1][1] = std::max(AC_QLOOKUP[at(base + q_delta[2])] * 101581 >> 16, 8);
        qmul[s][2][0] = std::min((int)DC_QLOOKUP[at(base + q_delta[3])], 132);
        qmul[s][2][1] = AC_QLOOKUP[at(base + q_delta[4])];
    }
}

void Decoder::probability_updates() {
    BoolDecoder& c = hdr;
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 8; ++j)
            for (int k = 0; k < 3; ++k)
                for (int l = 0; l < 11; ++l)
                    if (c.get(COEF_UPDATE_PROBS[((i * 8 + j) * 3 + k) * 11 + l]))
                        prob.coef[i][j][k][l] = c.literal(8);
}

int Decoder::header(const uint8_t* d, size_t n, bool probe) {
    reason = OK;
    if (n < 3) return drop(SHORT_TAG);
    key = !(d[0] & 1);
    version = (d[0] >> 1) & 7;
    show = (d[0] >> 4) & 1;
    int64_t first = (d[0] | d[1] << 8 | d[2] << 16) >> 5;
    int64_t left = (int64_t)n - 3;
    size_t pos = 3;
    if (first > left - 7 * key) return drop(FIRST_PAST_PACKET);
    if (key) {
        if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return drop(NO_START_CODE);
        key_width = (d[6] | d[7] << 8) & 0x3fff;
        key_height = (d[8] | d[9] << 8) & 0x3fff;
        pos += 7;
        left -= 7;
        reset_for_key_frame();
    }
    if (first < 1) return drop(EMPTY_FIRST);
    hdr.init(d, n, pos, (size_t)first);
    pos += first;
    left -= first;
    if (key) {
        colour_space = hdr.bit();
        full_range = hdr.bit();
    }
    seg_enabled = hdr.bit();
    if (seg_enabled)
        segment_info();
    else
        seg_update_map = 0;
    seg_from_previous = seg_enabled && !seg_update_map;
    filter_simple = hdr.bit();
    filter_level = hdr.literal(6);
    sharpness = hdr.literal(3);
    lf_delta_enabled = hdr.bit();
    if (lf_delta_enabled) {
        lf_delta_update = hdr.bit();
        if (lf_delta_update) lf_deltas();
    }
    num_parts = 1 << hdr.literal(2);
    size_t table = pos;
    pos += 3 * (num_parts - 1);
    left -= 3 * (num_parts - 1);
    if (left < 0) return drop(TABLE_PAST_PACKET);
    for (int i = 0; i < num_parts; ++i) {
        int64_t size = left;
        if (i < num_parts - 1) {
            const uint8_t* s = d + table + 3 * i;
            size = s[0] | s[1] << 8 | s[2] << 16;
            if (left - size < 0) return drop(PART_PAST_PACKET);
        }
        if (size < 1) return drop(EMPTY_PART);
        parts[i].init(d, n, pos, (size_t)size);
        pos += size;
        left -= size;
    }
    if (key && (!key_width || !key_height)) return drop(ZERO_SIZE);
    if (probe) return OK;
    if (key) {
        if (key_width != width || key_height != height || !started) {
            width = key_width;
            height = key_height;
            mbw = (width + 15) / 16;
            mbh = (height + 15) / 16;
            pool.clear();
            for (auto& r : ref) r.reset();
        }
    }
    quantisers();
    if (!key) {
        int golden = hdr.bit(), altref = hdr.bit();
        auto copy = [&](int update, int which) {
            if (update) return (int)INTRA;
            switch (hdr.literal(2)) {
                case 1: return (int)LAST;
                case 2: return which == GOLDEN ? (int)ALTREF : (int)GOLDEN;
            }
            return (int)NO_REF;
        };
        update_golden = copy(golden, GOLDEN);
        update_altref = copy(altref, ALTREF);
        sign_bias[GOLDEN] = hdr.bit();
        sign_bias[ALTREF] = hdr.bit();
    }
    update_probs = hdr.bit();
    if (!update_probs) saved = prob;
    update_last = key || hdr.bit();
    probability_updates();
    skip_enabled = hdr.bit();
    if (skip_enabled) prob.skip = hdr.literal(8);
    if (!key) {
        prob.intra = hdr.literal(8);
        prob.last = hdr.literal(8);
        prob.golden = hdr.literal(8);
        if (hdr.bit())
            for (int i = 0; i < 4; ++i) prob.ymode[i] = hdr.literal(8);
        if (hdr.bit())
            for (int i = 0; i < 3; ++i) prob.uvmode[i] = hdr.literal(8);
        for (int i = 0; i < 2; ++i)
            for (int j = 0; j < 19; ++j)
                if (hdr.get(MV_UPDATE_PROBS[i * 19 + j])) {
                    int v = hdr.literal(7) << 1;
                    prob.mv[i][j] = v ? v : 1;
                }
    }
    return OK;
}

// ── modes and motion vectors ────────────────────────────────────────────

void Decoder::mb_modes(BoolDecoder& c, MB& m, int x, int y, bool key_frame, Frame& cur,
                       const Frame* prev) {
    size_t at = (size_t)y * mbw + x;
    if (seg_update_map) {
        int b = c.get(prob.segment[0]);
        cur.seg[at] = c.get(prob.segment[1 + b]) + 2 * b;
    } else if (seg_enabled && prev) {
        cur.seg[at] = prev->seg[at];
    }
    m.segment = cur.seg[at];
    m.skip = skip_enabled ? c.get(prob.skip) : 0;
    if (key_frame) {
        m.ymode = c.tree(KF_YMODE_TREE, KF_YMODE_PROBS);
        uint8_t* top = &top_bmodes[4 * x];
        if (m.ymode == B_PRED) {
            for (int by = 0; by < 4; ++by)
                for (int bx = 0; bx < 4; ++bx) {
                    const uint8_t* p = &KF_BMODE_PROBS[(top[bx] * 10 + left_bmodes[by]) * 9];
                    int b = c.tree(BMODE_TREE, p);
                    m.bmodes[by * 4 + bx] = b;
                    top[bx] = left_bmodes[by] = b;
                }
        } else {
            int b = B_MODE_OF[m.ymode];
            for (int i = 0; i < 4; ++i) top[i] = left_bmodes[i] = b;
        }
        m.uvmode = c.tree(UV_MODE_TREE, KF_UV_MODE_PROBS);
        m.ref = INTRA;
        m.part = SPLIT_NONE;
    } else if (c.get(prob.intra)) {
        if (c.get(prob.last))
            m.ref = c.get(prob.golden) ? ALTREF : GOLDEN;
        else
            m.ref = LAST;
        inter_modes(c, m, x, y);
    } else {
        m.ymode = c.tree(YMODE_TREE, prob.ymode);
        if (m.ymode == B_PRED)
            for (int i = 0; i < 16; ++i) m.bmodes[i] = c.tree(BMODE_TREE, BMODE_PROBS);
        m.uvmode = c.tree(UV_MODE_TREE, prob.uvmode);
        m.ref = INTRA;
        m.part = SPLIT_NONE;
        m.bmv[0][0] = m.bmv[0][1] = 0;
    }
}

int Decoder::read_mv_component(BoolDecoder& c, const uint8_t* p) {
    int x = 0;
    if (c.get(p[0])) {                                   // long
        for (int i = 0; i < 3; ++i) x += c.get(p[9 + i]) << i;
        for (int i = 9; i > 3; --i) x += c.get(p[9 + i]) << i;
        if (!(x & 0xFFF0) || c.get(p[12])) x += 8;
    } else {
        x = c.tree(SMALL_MV_TREE, p + 2);                // the short tree: p[2..8]
    }
    return (x && c.get(p[1])) ? -x : x;
}

void Decoder::inter_modes(BoolDecoder& c, MB& m, int x, int y) {
    // the neighbours above, left and above-left (find_near_mvs)
    const MB* edge[3] = {&mb_at(x, y - 1), &mb_at(x - 1, y), &mb_at(x - 1, y - 1)};
    Mvs near[4] = {};
    int cnt[4] = {0, 0, 0, 0};
    int idx = 0;
    int bias = sign_bias[m.ref];
    for (int n = 0; n < 3; ++n) {
        const MB* e = edge[n];
        if (e->ref == INTRA) continue;
        Mvs mv{{e->mv[0], e->mv[1]}};
        if (!mv.zero()) {
            if (bias != sign_bias[e->ref]) {
                mv.v[0] = (int16_t)-mv.v[0];
                mv.v[1] = (int16_t)-mv.v[1];
            }
            if (!n || !(mv == near[idx])) near[++idx] = mv;
            cnt[idx] += 1 + (n != 2);
        } else {
            cnt[0] += 1 + (n != 2);
        }
    }
    // the bounds a predicted vector is clamped to: 16 pixels past the edges
    int lo_x = -(x * 64) - 64, hi_x = (mbw - 1 - x) * 64 + 64;
    int lo_y = -(y * 64) - 64, hi_y = (mbh - 1 - y) * 64 + 64;
    auto clamp = [&](const Mvs& v) {
        m.mv[0] = (int16_t)std::min(std::max((int)v.v[0], lo_y), hi_y);
        m.mv[1] = (int16_t)std::min(std::max((int)v.v[1], lo_x), hi_x);
    };
    m.part = SPLIT_NONE;
    if (c.get(MODE_CONTEXTS[cnt[0] * 4 + 0])) {
        if (cnt[3] && near[1] == near[3]) cnt[1] += 1;
        if (cnt[2] > cnt[1]) {
            std::swap(cnt[1], cnt[2]);
            std::swap(near[1], near[2]);
        }
        if (c.get(MODE_CONTEXTS[cnt[1] * 4 + 1])) {
            if (c.get(MODE_CONTEXTS[cnt[2] * 4 + 2])) {
                clamp(near[cnt[1] >= cnt[0] ? 1 : 0]);          // the best vector
                int splits = ((edge[1]->ymode == SPLITMV) + (edge[0]->ymode == SPLITMV)) * 2 +
                             (edge[2]->ymode == SPLITMV);
                if (c.get(MODE_CONTEXTS[splits * 4 + 3])) {
                    m.ymode = SPLITMV;
                    int num = split_mvs(c, m, x, y);
                    m.mv[0] = m.bmv[num - 1][0];
                    m.mv[1] = m.bmv[num - 1][1];
                } else {
                    m.ymode = NEWMV;
                    m.mv[0] = (int16_t)(m.mv[0] + read_mv_component(c, prob.mv[0]));
                    m.mv[1] = (int16_t)(m.mv[1] + read_mv_component(c, prob.mv[1]));
                    m.bmv[0][0] = m.mv[0];
                    m.bmv[0][1] = m.mv[1];
                }
            } else {
                m.ymode = NEARMV;
                clamp(near[2]);
                m.bmv[0][0] = m.mv[0];
                m.bmv[0][1] = m.mv[1];
            }
        } else {
            m.ymode = NEARESTMV;
            clamp(near[1]);
            m.bmv[0][0] = m.mv[0];
            m.bmv[0][1] = m.mv[1];
        }
    } else {
        m.ymode = ZEROMV;
        m.mv[0] = m.mv[1] = 0;
        m.bmv[0][0] = m.bmv[0][1] = 0;
    }
}

int Decoder::split_mvs(BoolDecoder& c, MB& m, int x, int y) {
    const MB& left = mb_at(x - 1, y);
    const MB& top = mb_at(x, y - 1);
    static const uint8_t none[16] = {0};
    const uint8_t* splits_left = left.part == SPLIT_NONE ? none : &MBSPLITS[left.part * 16];
    const uint8_t* splits_top = top.part == SPLIT_NONE ? none : &MBSPLITS[top.part * 16];
    int part = c.tree(MBSPLIT_TREE, MBSPLIT_PROBS);
    const uint8_t* splits = &MBSPLITS[part * 16];
    int num = MBSPLIT_COUNT[part];
    m.part = part;
    for (int n = 0; n < num; ++n) {
        int k = 0;                       // the partition's first sub-block
        while (splits[k] != n) ++k;
        Mvs l, a;
        if (!(k & 3)) {
            l.v[0] = left.bmv[splits_left[k + 3]][0];
            l.v[1] = left.bmv[splits_left[k + 3]][1];
        } else {
            l.v[0] = m.bmv[splits[k - 1]][0];
            l.v[1] = m.bmv[splits[k - 1]][1];
        }
        if (k <= 3) {
            a.v[0] = top.bmv[splits_top[k + 12]][0];
            a.v[1] = top.bmv[splits_top[k + 12]][1];
        } else {
            a.v[0] = m.bmv[splits[k - 4]][0];
            a.v[1] = m.bmv[splits[k - 4]][1];
        }
        int context;
        if (l == a)
            context = l.zero() ? 4 : 3;
        else if (a.zero())
            context = 2;
        else
            context = l.zero() ? 1 : 0;
        const uint8_t* p = &SUBMV_REF_PROBS[context * 3];
        int16_t* out = m.bmv[n];
        if (!c.get(p[0])) {
            out[0] = l.v[0];
            out[1] = l.v[1];
        } else if (!c.get(p[1])) {
            out[0] = a.v[0];
            out[1] = a.v[1];
        } else if (!c.get(p[2])) {
            out[0] = out[1] = 0;
        } else {
            out[0] = (int16_t)(m.mv[0] + read_mv_component(c, prob.mv[0]));
            out[1] = (int16_t)(m.mv[1] + read_mv_component(c, prob.mv[1]));
        }
    }
    return num;
}

// ── tokens ──────────────────────────────────────────────────────────────

int Decoder::block_tokens(BoolDecoder& c, int16_t* block, int type, int first, int ctx,
                          const int16_t* q) {
    const uint8_t(*P)[3][11] = prob.coef[type];
    int i = first;
    const uint8_t* p = P[COEF_BANDS[i]][ctx];
    if (!c.get(p[0])) return 0;                          // EOB
    for (;;) {
        if (!c.get(p[1])) {                              // DCT_0
            if (++i == 16) return 16;
            p = P[COEF_BANDS[i]][0];
            continue;
        }
        int v, next;
        if (!c.get(p[2])) {
            v = 1;
            next = 1;
        } else {
            if (!c.get(p[3])) {
                v = c.get(p[4]) ? 3 + c.get(p[5]) : 2;
            } else if (!c.get(p[6])) {
                if (!c.get(p[7])) {
                    v = 5 + c.get(CAT_PROBS[CAT_START[0]]);
                } else {
                    v = 7 + (c.get(CAT_PROBS[CAT_START[1]]) << 1);
                    v += c.get(CAT_PROBS[CAT_START[1] + 1]);
                }
            } else {
                int a = c.get(p[8]);
                int b = c.get(p[9 + a]);
                int cat = 2 + 2 * a + b;
                int extra = 0;
                for (const uint8_t* e = &CAT_PROBS[CAT_START[cat]]; *e; ++e)
                    extra = (extra << 1) + c.get(*e);
                v = CAT_BASE[cat] + extra;
            }
            next = 2;
        }
        int value = c.bit() ? -v : v;
        block[ZIGZAG[i]] = (int16_t)(value * q[i ? 1 : 0]);
        if (++i == 16) return 16;
        p = P[COEF_BANDS[i]][next];
        if (!c.get(p[0])) return i;                      // EOB
    }
}

// luma_dc_wht: the Y2 block's inverse Walsh-Hadamard transform into the
// luma blocks' DC, its first pass kept in 16 bits as FFmpeg keeps it
static void inverse_wht(int16_t* dc, int16_t (*blocks)[16]) {
    for (int i = 0; i < 4; ++i) {
        int t0 = dc[i] + dc[12 + i], t1 = dc[4 + i] + dc[8 + i];
        int t2 = dc[4 + i] - dc[8 + i], t3 = dc[i] - dc[12 + i];
        dc[i] = (int16_t)(t0 + t1);
        dc[4 + i] = (int16_t)(t3 + t2);
        dc[8 + i] = (int16_t)(t0 - t1);
        dc[12 + i] = (int16_t)(t3 - t2);
    }
    for (int i = 0; i < 4; ++i) {
        int t0 = dc[4 * i] + dc[4 * i + 3] + 3, t1 = dc[4 * i + 1] + dc[4 * i + 2];
        int t2 = dc[4 * i + 1] - dc[4 * i + 2], t3 = dc[4 * i] - dc[4 * i + 3] + 3;
        blocks[4 * i + 0][0] = (int16_t)((t0 + t1) >> 3);
        blocks[4 * i + 1][0] = (int16_t)((t3 + t2) >> 3);
        blocks[4 * i + 2][0] = (int16_t)((t0 - t1) >> 3);
        blocks[4 * i + 3][0] = (int16_t)((t3 - t2) >> 3);
    }
}

static inline int mul_20091(int a) { return ((a * 20091) >> 16) + a; }
static inline int mul_35468(int a) { return (a * 35468) >> 16; }

// the inverse DCT of a 4x4 block added to dst (columns first, in 16 bits)
static void idct_add(uint8_t* dst, int stride, const int16_t* b) {
    int16_t tmp[16];
    for (int i = 0; i < 4; ++i) {
        int t0 = b[i] + b[8 + i], t1 = b[i] - b[8 + i];
        int t2 = mul_35468(b[4 + i]) - mul_20091(b[12 + i]);
        int t3 = mul_20091(b[4 + i]) + mul_35468(b[12 + i]);
        tmp[i * 4 + 0] = (int16_t)(t0 + t3);
        tmp[i * 4 + 1] = (int16_t)(t1 + t2);
        tmp[i * 4 + 2] = (int16_t)(t1 - t2);
        tmp[i * 4 + 3] = (int16_t)(t0 - t3);
    }
    for (int i = 0; i < 4; ++i) {
        int t0 = tmp[i] + tmp[8 + i], t1 = tmp[i] - tmp[8 + i];
        int t2 = mul_35468(tmp[4 + i]) - mul_20091(tmp[12 + i]);
        int t3 = mul_20091(tmp[4 + i]) + mul_35468(tmp[12 + i]);
        dst[0] = clip8(dst[0] + ((t0 + t3 + 4) >> 3));
        dst[1] = clip8(dst[1] + ((t1 + t2 + 4) >> 3));
        dst[2] = clip8(dst[2] + ((t1 - t2 + 4) >> 3));
        dst[3] = clip8(dst[3] + ((t0 - t3 + 4) >> 3));
        dst += stride;
    }
}

// a macroblock's tokens into `coeffs` (16 Y, 4 U, 4 V, Y2) and `nnz`; false
// when it has none (the macroblock then counts as skipped)
bool Decoder::mb_tokens(BoolDecoder& c, MB& m, int x) {
    uint8_t* t = &top_nnz[9 * x];
    uint8_t* l = left_nnz;
    std::memset(coeffs, 0, sizeof coeffs);
    std::memset(nnz, 0, sizeof nnz);
    const int16_t(*q)[2] = qmul[m.segment];
    int total = 0, first = 0, type = 3, dc = 0;
    if (m.ymode != B_PRED && m.ymode != SPLITMV) {
        int n = block_tokens(c, coeffs[24], 1, 0, t[8] + l[8], q[1]);
        t[8] = l[8] = n > 0;
        if (n) {
            total += n;
            dc = 1;
            inverse_wht(coeffs[24], coeffs);
        }
        first = 1;
        type = 0;
    }
    for (int by = 0; by < 4; ++by)
        for (int bx = 0; bx < 4; ++bx) {
            int n = block_tokens(c, coeffs[by * 4 + bx], type, first, l[by] + t[bx], q[0]);
            nnz[by * 4 + bx] = n + dc;
            t[bx] = l[by] = n > 0;
            total += n;
        }
    for (int plane = 0; plane < 2; ++plane)
        for (int by = 0; by < 2; ++by)
            for (int bx = 0; bx < 2; ++bx) {
                int ti = 4 + 2 * plane + bx, li = 4 + 2 * plane + by;
                int b = 16 + plane * 4 + by * 2 + bx;
                int n = block_tokens(c, coeffs[b], 2, 0, l[li] + t[ti], q[2]);
                nnz[b] = n;
                t[ti] = l[li] = n > 0;
                total += n;
            }
    return total > 0;
}

// ── prediction ──────────────────────────────────────────────────────────

static inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }
static inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }

// a sub-block's prediction from its above row A[-1..7] (A[-1] above-left)
// and left column L[0..3], into B (stride s)
static void predict_4x4(int mode, uint8_t* B, int s, const uint8_t* A, const uint8_t* L) {
    const int P = A[-1];
    uint8_t pp[9] = {L[3], L[2], L[1], L[0], (uint8_t)P, A[0], A[1], A[2], A[3]};
    auto at = [&](int r, int c) -> uint8_t& { return B[r * s + c]; };
    switch (mode) {
        case B_DC: {
            int v = 4;
            for (int i = 0; i < 4; ++i) v += A[i] + L[i];
            v >>= 3;
            for (int r = 0; r < 4; ++r)
                for (int c = 0; c < 4; ++c) at(r, c) = v;
            break;
        }
        case B_TM:
            for (int r = 0; r < 4; ++r)
                for (int c = 0; c < 4; ++c) at(r, c) = clip8(L[r] + A[c] - P);
            break;
        case B_VE:
            for (int c = 0; c < 4; ++c) {
                uint8_t v = avg3(A[c - 1], A[c], A[c + 1]);
                for (int r = 0; r < 4; ++r) at(r, c) = v;
            }
            break;
        case B_HE: {
            uint8_t rows[4] = {avg3(P, L[0], L[1]), avg3(L[0], L[1], L[2]),
                               avg3(L[1], L[2], L[3]), avg3(L[2], L[3], L[3])};
            for (int r = 0; r < 4; ++r)
                for (int c = 0; c < 4; ++c) at(r, c) = rows[r];
            break;
        }
        case B_LD:
            for (int r = 0; r < 4; ++r)
                for (int c = 0; c < 4; ++c) {
                    int i = r + c;
                    at(r, c) = i < 6 ? avg3(A[i], A[i + 1], A[i + 2]) : avg3(A[6], A[7], A[7]);
                }
            break;
        case B_RD:
            for (int r = 0; r < 4; ++r)
                for (int c = 0; c < 4; ++c)
                    at(r, c) = avg3(pp[3 - r + c], pp[4 - r + c], pp[5 - r + c]);
            break;
        case B_VR:
            at(3, 0) = avg3(pp[1], pp[2], pp[3]);
            at(2, 0) = avg3(pp[2], pp[3], pp[4]);
            at(3, 1) = at(1, 0) = avg3(pp[3], pp[4], pp[5]);
            at(2, 1) = at(0, 0) = avg2(pp[4], pp[5]);
            at(3, 2) = at(1, 1) = avg3(pp[4], pp[5], pp[6]);
            at(2, 2) = at(0, 1) = avg2(pp[5], pp[6]);
            at(3, 3) = at(1, 2) = avg3(pp[5], pp[6], pp[7]);
            at(2, 3) = at(0, 2) = avg2(pp[6], pp[7]);
            at(1, 3) = avg3(pp[6], pp[7], pp[8]);
            at(0, 3) = avg2(pp[7], pp[8]);
            break;
        case B_VL:
            at(0, 0) = avg2(A[0], A[1]);
            at(1, 0) = avg3(A[0], A[1], A[2]);
            at(2, 0) = at(0, 1) = avg2(A[1], A[2]);
            at(1, 1) = at(3, 0) = avg3(A[1], A[2], A[3]);
            at(2, 1) = at(0, 2) = avg2(A[2], A[3]);
            at(3, 1) = at(1, 2) = avg3(A[2], A[3], A[4]);
            at(2, 2) = at(0, 3) = avg2(A[3], A[4]);
            at(3, 2) = at(1, 3) = avg3(A[3], A[4], A[5]);
            at(2, 3) = avg3(A[4], A[5], A[6]);
            at(3, 3) = avg3(A[5], A[6], A[7]);
            break;
        case B_HD:
            at(3, 0) = avg2(pp[0], pp[1]);
            at(3, 1) = avg3(pp[0], pp[1], pp[2]);
            at(2, 0) = at(3, 2) = avg2(pp[1], pp[2]);
            at(2, 1) = at(3, 3) = avg3(pp[1], pp[2], pp[3]);
            at(2, 2) = at(1, 0) = avg2(pp[2], pp[3]);
            at(2, 3) = at(1, 1) = avg3(pp[2], pp[3], pp[4]);
            at(1, 2) = at(0, 0) = avg2(pp[3], pp[4]);
            at(1, 3) = at(0, 1) = avg3(pp[3], pp[4], pp[5]);
            at(0, 2) = avg3(pp[4], pp[5], pp[6]);
            at(0, 3) = avg3(pp[5], pp[6], pp[7]);
            break;
        case B_HU:
            at(0, 0) = avg2(L[0], L[1]);
            at(0, 1) = avg3(L[0], L[1], L[2]);
            at(0, 2) = at(1, 0) = avg2(L[1], L[2]);
            at(0, 3) = at(1, 1) = avg3(L[1], L[2], L[3]);
            at(1, 2) = at(2, 0) = avg2(L[2], L[3]);
            at(1, 3) = at(2, 1) = avg3(L[2], L[3], L[3]);
            at(2, 2) = at(2, 3) = at(3, 0) = at(3, 1) = at(3, 2) = at(3, 3) = L[3];
            break;
    }
}

// a 16x16 or 8x8 block's prediction (DC, V, H or TM) from its above row
// A[-1..n-1] and left column L, at the frame's edges as FFmpeg predicts it
static void predict_block(int mode, uint8_t* dst, int s, int n, const uint8_t* A,
                          const uint8_t* L, bool has_above, bool has_left) {
    int shift = n == 16 ? 4 : 3;
    switch (mode) {
        case DC_PRED: {
            int v = 128;
            int sa = 0, sl = 0;
            for (int i = 0; i < n; ++i) {
                sa += A[i];
                sl += L[i];
            }
            if (has_above && has_left)
                v = (sa + sl + n) >> (shift + 1);
            else if (has_above)
                v = (sa + n / 2) >> shift;
            else if (has_left)
                v = (sl + n / 2) >> shift;
            for (int r = 0; r < n; ++r) std::memset(dst + r * s, v, n);
            break;
        }
        case V_PRED:
            for (int r = 0; r < n; ++r) std::memcpy(dst + r * s, A, n);
            break;
        case H_PRED:
            for (int r = 0; r < n; ++r) std::memset(dst + r * s, L[r], n);
            break;
        case TM_PRED:
            for (int r = 0; r < n; ++r)
                for (int c = 0; c < n; ++c) dst[r * s + c] = clip8(L[r] + A[c] - A[-1]);
            break;
    }
}

void Decoder::intra_mb(Frame& f, MB& m, int x, int y) {
    int W = f.W;
    uint8_t* py = &f.y[(size_t)16 * y * W + 16 * x];
    // the above row (above-left first, four above-right after) and the
    // left column: 127 above the picture, 129 left of it
    uint8_t above[21], left[16];
    uint8_t* A = above + 1;
    if (y == 0) {
        std::memset(above, 127, sizeof above);
    } else {
        const uint8_t* row = py - W;
        above[0] = x ? row[-1] : 129;
        std::memcpy(A, row, 16);
        if (x == mbw - 1)
            std::memset(A + 16, row[15], 4);
        else
            std::memcpy(A + 16, row + 16, 4);
    }
    for (int r = 0; r < 16; ++r) left[r] = x ? py[r * W - 1] : 129;
    if (m.ymode != B_PRED) {
        predict_block(m.ymode, py, W, 16, A, left, y > 0, x > 0);
    } else {
        // each sub-block from the pixels already built: a working copy of
        // the macroblock with its above row and left column
        uint8_t work[17][21];
        std::memcpy(work[0], above, 21);
        for (int r = 0; r < 16; ++r) work[r + 1][0] = left[r];
        for (int by = 0; by < 4; ++by)
            for (int bx = 0; bx < 4; ++bx) {
                uint8_t a[9], l[4];
                std::memcpy(a, &work[4 * by][4 * bx], 5);        // above-left, above
                if (bx == 3)
                    std::memcpy(a + 5, A + 16, 4);                // the macroblock's above-right
                else
                    std::memcpy(a + 5, &work[4 * by][4 * bx + 5], 4);
                for (int r = 0; r < 4; ++r) l[r] = work[4 * by + 1 + r][4 * bx];
                uint8_t* B = &work[4 * by + 1][4 * bx + 1];
                int b = by * 4 + bx;
                predict_4x4(m.bmodes[b], B, 21, a + 1, l);
                if (!m.skip && nnz[b]) {
                    uint8_t blk[16];
                    for (int r = 0; r < 4; ++r) std::memcpy(blk + 4 * r, B + 21 * r, 4);
                    idct_add(blk, 4, coeffs[b]);
                    for (int r = 0; r < 4; ++r) std::memcpy(B + 21 * r, blk + 4 * r, 4);
                }
            }
        for (int r = 0; r < 16; ++r) std::memcpy(py + r * W, &work[r + 1][1], 16);
    }
    int CW = f.CW;
    for (int plane = 0; plane < 2; ++plane) {
        uint8_t* pc = &(plane ? f.v : f.u)[(size_t)8 * y * CW + 8 * x];
        uint8_t cabove[9], cleft[8];
        if (y == 0) {
            std::memset(cabove, 127, sizeof cabove);
        } else {
            cabove[0] = x ? pc[-CW - 1] : 129;
            std::memcpy(cabove + 1, pc - CW, 8);
        }
        for (int r = 0; r < 8; ++r) cleft[r] = x ? pc[r * CW - 1] : 129;
        predict_block(m.uvmode, pc, CW, 8, cabove + 1, cleft, y > 0, x > 0);
    }
}

// one block of motion compensation: the prediction at (x, y) + the
// fraction (mx, my) in eighths, the reference's pixels past its
// (macroblock-aligned) edges repeating its edge
static void predict_inter(uint8_t* dst, int ds, const uint8_t* src, int W, int H, int x, int y,
                          int bw, int bh, int mx, int my, bool sixtap) {
    uint8_t fetch[(16 + 5) * (16 + 5)];
    const int fs = 21;
    // the source window: 2 pixels before, 3 after
    bool inside = x - 2 >= 0 && y - 2 >= 0 && x + bw + 3 <= W && y + bh + 3 <= H;
    const uint8_t* s;
    int ss;
    if (inside) {
        s = src + (size_t)y * W + x;
        ss = W;
    } else {
        for (int r = 0; r < bh + 5; ++r) {
            int yy = std::min(std::max(y - 2 + r, 0), H - 1);
            for (int c = 0; c < bw + 5; ++c) {
                int xx = std::min(std::max(x - 2 + c, 0), W - 1);
                fetch[r * fs + c] = src[(size_t)yy * W + xx];
            }
        }
        s = fetch + 2 * fs + 2;
        ss = fs;
    }
    if (!mx && !my) {
        for (int r = 0; r < bh; ++r) std::memcpy(dst + r * ds, s + r * ss, bw);
        return;
    }
    if (sixtap) {
        const int16_t* fh = &SIXTAP_FILTERS[mx * 6];
        const int16_t* fv = &SIXTAP_FILTERS[my * 6];
        auto h6 = [&](const uint8_t* p) {
            return clip8((fh[0] * p[-2] + fh[1] * p[-1] + fh[2] * p[0] + fh[3] * p[1] +
                          fh[4] * p[2] + fh[5] * p[3] + 64) >> 7);
        };
        if (mx && my) {
            uint8_t tmp[(16 + 5) * 16];
            for (int r = 0; r < bh + 5; ++r)
                for (int c = 0; c < bw; ++c) tmp[r * 16 + c] = h6(s + (r - 2) * ss + c);
            for (int r = 0; r < bh; ++r)
                for (int c = 0; c < bw; ++c) {
                    const uint8_t* p = tmp + (r + 2) * 16 + c;
                    dst[r * ds + c] = clip8((fv[0] * p[-32] + fv[1] * p[-16] + fv[2] * p[0] +
                                             fv[3] * p[16] + fv[4] * p[32] + fv[5] * p[48] +
                                             64) >> 7);
                }
        } else if (mx) {
            for (int r = 0; r < bh; ++r)
                for (int c = 0; c < bw; ++c) dst[r * ds + c] = h6(s + r * ss + c);
        } else {
            for (int r = 0; r < bh; ++r)
                for (int c = 0; c < bw; ++c) {
                    const uint8_t* p = s + r * ss + c;
                    dst[r * ds + c] = clip8((fv[0] * p[-2 * ss] + fv[1] * p[-ss] + fv[2] * p[0] +
                                             fv[3] * p[ss] + fv[4] * p[2 * ss] +
                                             fv[5] * p[3 * ss] + 64) >> 7);
                }
        }
        return;
    }
    const int16_t* fh = &BILINEAR_FILTERS[mx * 2];
    const int16_t* fv = &BILINEAR_FILTERS[my * 2];
    if (mx && my) {
        uint8_t tmp[17 * 16];
        for (int r = 0; r < bh + 1; ++r)
            for (int c = 0; c < bw; ++c) {
                const uint8_t* p = s + r * ss + c;
                tmp[r * 16 + c] = (uint8_t)((fh[0] * p[0] + fh[1] * p[1] + 64) >> 7);
            }
        for (int r = 0; r < bh; ++r)
            for (int c = 0; c < bw; ++c) {
                const uint8_t* p = tmp + r * 16 + c;
                dst[r * ds + c] = (uint8_t)((fv[0] * p[0] + fv[1] * p[16] + 64) >> 7);
            }
    } else if (mx) {
        for (int r = 0; r < bh; ++r)
            for (int c = 0; c < bw; ++c) {
                const uint8_t* p = s + r * ss + c;
                dst[r * ds + c] = (uint8_t)((fh[0] * p[0] + fh[1] * p[1] + 64) >> 7);
            }
    } else {
        for (int r = 0; r < bh; ++r)
            for (int c = 0; c < bw; ++c) {
                const uint8_t* p = s + r * ss + c;
                dst[r * ds + c] = (uint8_t)((fv[0] * p[0] + fv[1] * p[ss] + 64) >> 7);
            }
    }
}

void Decoder::inter_mb(Frame& f, MB& m, int x, int y) {
    const Frame& r = *ref[m.ref];
    bool sixtap = version == 0;
    int W = f.W, H = f.H, CW = f.CW, CH = f.CH;
    uint8_t* py = &f.y[(size_t)16 * y * W + 16 * x];
    uint8_t* pu = &f.u[(size_t)8 * y * CW + 8 * x];
    uint8_t* pv = &f.v[(size_t)8 * y * CW + 8 * x];
    auto luma = [&](int bx, int by, int bw, int bh, const int16_t* mv) {
        predict_inter(py + by * W + bx, W, r.y.data(), W, H, 16 * x + bx + (mv[1] >> 2),
                      16 * y + by + (mv[0] >> 2), bw, bh, (mv[1] * 2) & 7, (mv[0] * 2) & 7,
                      sixtap);
    };
    auto chroma = [&](int bx, int by, int bw, int bh, int mvy, int mvx) {
        if (version == 3) {
            mvx &= ~7;
            mvy &= ~7;
        }
        int cx = 8 * x + bx + (mvx >> 3), cy = 8 * y + by + (mvy >> 3);
        predict_inter(pu + by * CW + bx, CW, r.u.data(), CW, CH, cx, cy, bw, bh, mvx & 7,
                      mvy & 7, sixtap);
        predict_inter(pv + by * CW + bx, CW, r.v.data(), CW, CH, cx, cy, bw, bh, mvx & 7,
                      mvy & 7, sixtap);
    };
    switch (m.part) {
        case SPLIT_NONE:
            luma(0, 0, 16, 16, m.mv);
            chroma(0, 0, 8, 8, m.mv[0], m.mv[1]);
            break;
        case 0:                                          // 16x8
            luma(0, 0, 16, 8, m.bmv[0]);
            chroma(0, 0, 8, 4, m.bmv[0][0], m.bmv[0][1]);
            luma(0, 8, 16, 8, m.bmv[1]);
            chroma(0, 4, 8, 4, m.bmv[1][0], m.bmv[1][1]);
            break;
        case 1:                                          // 8x16
            luma(0, 0, 8, 16, m.bmv[0]);
            chroma(0, 0, 4, 8, m.bmv[0][0], m.bmv[0][1]);
            luma(8, 0, 8, 16, m.bmv[1]);
            chroma(4, 0, 4, 8, m.bmv[1][0], m.bmv[1][1]);
            break;
        case 2:                                          // 8x8
            for (int k = 0; k < 4; ++k) {
                int bx = (k & 1) * 8, by = (k >> 1) * 8;
                luma(bx, by, 8, 8, m.bmv[k]);
                chroma(bx / 2, by / 2, 4, 4, m.bmv[k][0], m.bmv[k][1]);
            }
            break;
        default:                                         // 4x4
            for (int k = 0; k < 16; ++k) luma((k & 3) * 4, (k >> 2) * 4, 4, 4, m.bmv[k]);
            for (int cy = 0; cy < 2; ++cy)
                for (int cx = 0; cx < 2; ++cx) {
                    int s[2];
                    for (int i = 0; i < 2; ++i) {
                        int k = 8 * cy + 2 * cx;
                        int sum = m.bmv[k][i] + m.bmv[k + 1][i] + m.bmv[k + 4][i] +
                                  m.bmv[k + 5][i];
                        s[i] = (sum + 2 + (sum >> 31)) >> 2;
                    }
                    chroma(4 * cx, 4 * cy, 4, 4, s[0], s[1]);
                }
            break;
    }
}

void Decoder::residual(Frame& f, MB& m, int x, int y) {
    if (m.skip) return;
    int W = f.W, CW = f.CW;
    uint8_t* py = &f.y[(size_t)16 * y * W + 16 * x];
    if (m.ymode != B_PRED)                               // B_PRED adds its own luma
        for (int b = 0; b < 16; ++b)
            if (nnz[b]) idct_add(py + (b >> 2) * 4 * W + (b & 3) * 4, W, coeffs[b]);
    for (int plane = 0; plane < 2; ++plane) {
        uint8_t* pc = &(plane ? f.v : f.u)[(size_t)8 * y * CW + 8 * x];
        for (int b = 0; b < 4; ++b)
            if (nnz[16 + plane * 4 + b])
                idct_add(pc + (b >> 1) * 4 * CW + (b & 1) * 4, CW, coeffs[16 + plane * 4 + b]);
    }
}

// ── the loop filter ─────────────────────────────────────────────────────

static inline bool simple_limit(const uint8_t* p, int s, int e) {
    int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
    return 2 * std::abs(p0 - q0) + (std::abs(p1 - q1) >> 1) <= e;
}

static inline bool normal_limit(const uint8_t* p, int s, int e, int i) {
    int p3 = p[-4 * s], p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
    int q0 = p[0], q1 = p[s], q2 = p[2 * s], q3 = p[3 * s];
    return simple_limit(p, s, e) && std::abs(p3 - p2) <= i && std::abs(p2 - p1) <= i &&
           std::abs(p1 - p0) <= i && std::abs(q3 - q2) <= i && std::abs(q2 - q1) <= i &&
           std::abs(q1 - q0) <= i;
}

static inline bool high_variance(const uint8_t* p, int s, int t) {
    return std::abs(p[-2 * s] - p[-s]) > t || std::abs(p[s] - p[0]) > t;
}

static inline void filter_common(uint8_t* p, int s, bool outer_taps) {
    int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
    int a = 3 * (q0 - p0);
    if (outer_taps) a += clip_s8(p1 - q1);
    a = clip_s8(a);
    int f1 = std::min(a + 4, 127) >> 3;
    int f2 = std::min(a + 3, 127) >> 3;
    p[-s] = clip8(p0 + f2);
    p[0] = clip8(q0 - f1);
    if (!outer_taps) {
        a = (f1 + 1) >> 1;
        p[-2 * s] = clip8(p1 + a);
        p[s] = clip8(q1 - a);
    }
}

static inline void filter_mbedge(uint8_t* p, int s) {
    int p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s], q2 = p[2 * s];
    int w = clip_s8(p1 - q1);
    w = clip_s8(w + 3 * (q0 - p0));
    int a0 = (27 * w + 63) >> 7, a1 = (18 * w + 63) >> 7, a2 = (9 * w + 63) >> 7;
    p[-3 * s] = clip8(p2 + a2);
    p[-2 * s] = clip8(p1 + a1);
    p[-s] = clip8(p0 + a0);
    p[0] = clip8(q0 - a0);
    p[s] = clip8(q1 - a1);
    p[2 * s] = clip8(q2 - a2);
}

// an edge of n pixels at p, its pixels `along` apart, across it `s`
static void edge_mb(uint8_t* p, int along, int s, int n, int e, int i, int t) {
    for (int k = 0; k < n; ++k, p += along)
        if (normal_limit(p, s, e, i)) {
            if (high_variance(p, s, t))
                filter_common(p, s, true);
            else
                filter_mbedge(p, s);
        }
}

static void edge_inner(uint8_t* p, int along, int s, int n, int e, int i, int t) {
    for (int k = 0; k < n; ++k, p += along)
        if (normal_limit(p, s, e, i)) filter_common(p, s, high_variance(p, s, t));
}

static void edge_simple(uint8_t* p, int along, int s, int e) {
    for (int k = 0; k < 16; ++k, p += along)
        if (simple_limit(p, s, e)) filter_common(p, s, true);
}

void Decoder::filter_frame(Frame& f, bool key_frame) {
    int W = f.W, CW = f.CW;
    for (int y = 0; y < mbh; ++y)
        for (int x = 0; x < mbw; ++x) {
            const Filter& fl = filters[(size_t)y * mbw + x];
            int level = fl.level;
            if (!level) continue;
            int inner = fl.inner_limit;
            int be = 2 * level + inner, me = be + 4;
            int t = key_frame ? (level >= 40 ? 2 : level >= 15 ? 1 : 0)
                              : (level >= 40 ? 3 : level >= 20 ? 2 : level >= 15 ? 1 : 0);
            uint8_t* py = &f.y[(size_t)16 * y * W + 16 * x];
            if (filter_simple) {
                if (x) edge_simple(py, W, 1, me);
                if (fl.inner)
                    for (int k = 4; k < 16; k += 4) edge_simple(py + k, W, 1, be);
                if (y) edge_simple(py, 1, W, me);
                if (fl.inner)
                    for (int k = 4; k < 16; k += 4) edge_simple(py + k * W, 1, W, be);
                continue;
            }
            uint8_t* pu = &f.u[(size_t)8 * y * CW + 8 * x];
            uint8_t* pv = &f.v[(size_t)8 * y * CW + 8 * x];
            if (x) {
                edge_mb(py, W, 1, 16, me, inner, t);
                edge_mb(pu, CW, 1, 8, me, inner, t);
                edge_mb(pv, CW, 1, 8, me, inner, t);
            }
            if (fl.inner) {
                for (int k = 4; k < 16; k += 4) edge_inner(py + k, W, 1, 16, be, inner, t);
                edge_inner(pu + 4, CW, 1, 8, be, inner, t);
                edge_inner(pv + 4, CW, 1, 8, be, inner, t);
            }
            if (y) {
                edge_mb(py, 1, W, 16, me, inner, t);
                edge_mb(pu, 1, CW, 8, me, inner, t);
                edge_mb(pv, 1, CW, 8, me, inner, t);
            }
            if (fl.inner) {
                for (int k = 4; k < 16; k += 4) edge_inner(py + k * W, 1, W, 16, be, inner, t);
                edge_inner(pu + 4 * CW, 1, CW, 8, be, inner, t);
                edge_inner(pv + 4 * CW, 1, CW, 8, be, inner, t);
            }
        }
}

// ── a frame ─────────────────────────────────────────────────────────────

std::shared_ptr<Frame> Decoder::new_frame() {
    for (auto& f : pool)
        if (f.use_count() == 1) {
            std::fill(f->seg.begin(), f->seg.end(), 0);
            return f;
        }
    pool.push_back(std::make_shared<Frame>(16 * mbw, 16 * mbh, mbw * mbh));
    return pool.back();
}

int Decoder::decode(const uint8_t* d, size_t n) {
    error.clear();
    int status = header(d, n, false);
    if (status != OK) return status;
    if (!key && (!ref[LAST] || !ref[GOLDEN] || !ref[ALTREF])) return drop(NO_KEY_FRAME);
    started = true;
    std::shared_ptr<Frame> prev = ref[INTRA];            // the last frame decoded
    std::shared_ptr<Frame> cur = new_frame();
    Frame& f = *cur;
    mbs.assign((size_t)(mbh + 1) * (mbw + 1), MB{});
    for (auto& m : mbs) m.part = SPLIT_NONE;
    filters.assign((size_t)mbw * mbh, Filter{});
    top_nnz.assign((size_t)9 * mbw, 0);
    top_bmodes.assign((size_t)4 * mbw, B_DC);
    for (int y = 0; y < mbh; ++y) {
        BoolDecoder& c = parts[y & (num_parts - 1)];
        std::memset(left_nnz, 0, sizeof left_nnz);
        std::memset(left_bmodes, B_DC, sizeof left_bmodes);
        for (int x = 0; x < mbw; ++x) {
            if (c.at_end())
                return fail("token partition " + std::to_string(y & (num_parts - 1)) +
                                   " runs out of data at macroblock (" + std::to_string(x) +
                                   ", " + std::to_string(y) + ")");
            MB& m = mb_at(x, y);
            mb_modes(hdr, m, x, y, key, f, prev.get());
            if (!m.skip) {
                if (!mb_tokens(c, m, x)) m.skip = 1;
            } else {
                uint8_t* t = &top_nnz[9 * x];
                std::memset(t, 0, 8);
                std::memset(left_nnz, 0, 8);
                if (m.ymode != B_PRED && m.ymode != SPLITMV) t[8] = left_nnz[8] = 0;
            }
            if (m.ref == INTRA)
                intra_mb(f, m, x, y);
            else
                inter_mb(f, m, x, y);
            residual(f, m, x, y);
            if (filter_level) {
                int level = filter_level;
                if (seg_enabled) level = seg_abs ? seg_lf[m.segment] : seg_lf[m.segment] + level;
                if (lf_delta_enabled) {
                    level += ref_delta[m.ref];
                    if (m.ymode == B_PRED)
                        level += mode_delta[0];
                    else if (m.ymode == ZEROMV)
                        level += mode_delta[1];
                    else if (m.ymode == SPLITMV)
                        level += mode_delta[3];
                    else if (m.ymode >= NEARESTMV)
                        level += mode_delta[2];
                }
                level = std::min(std::max(level, 0), 63);
                int inner = level;
                if (sharpness) {
                    inner >>= (sharpness + 3) >> 2;
                    inner = std::min(inner, 9 - sharpness);
                }
                Filter& fl = filters[(size_t)y * mbw + x];
                fl.level = level;
                fl.inner_limit = std::max(inner, 1);
                fl.inner = !m.skip || m.ymode == B_PRED || m.ymode == SPLITMV;
            }
        }
    }
    if (filter_level) filter_frame(f, key);
    // the references after the frame: a copy takes the one before it
    std::shared_ptr<Frame> before[4] = {ref[0], ref[1], ref[2], ref[3]};
    auto pick = [&](int which) { return which == INTRA ? cur : before[which]; };
    if (update_altref != NO_REF) ref[ALTREF] = pick(update_altref);
    if (update_golden != NO_REF) ref[GOLDEN] = pick(update_golden);
    if (update_last) ref[LAST] = cur;
    ref[INTRA] = cur;
    if (!update_probs) prob = saved;
    last = cur;
    return show ? SHOWN : HIDDEN;
}

}  // namespace

// ── the C interface ─────────────────────────────────────────────────────

extern "C" {

void* vp8d_new() { return new (std::nothrow) Decoder(); }

void vp8d_free(void* h) { delete static_cast<Decoder*>(h); }

// decode one frame: SHOWN (0), HIDDEN (1), DROPPED (2) or FAILED (-1,
// vp8d_error says why)
int vp8d_decode(void* h, const uint8_t* data, int64_t size) {
    Decoder* d = static_cast<Decoder*>(h);
    try {
        return d->decode(data, (size_t)size);
    } catch (const std::exception& e) {           // a picture too large to hold
        d->error = std::string("the frame cannot be decoded: ") + e.what();
        return FAILED;
    }
}

const char* vp8d_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

// the picture's width and height (0 before the first key frame)
void vp8d_size(void* h, int32_t* out) {
    Decoder* d = static_cast<Decoder*>(h);
    out[0] = d->width;
    out[1] = d->height;
}

// the last frame decoded, cropped to the picture: Y (width x height), Cb
// and Cr (half of each, rounded up); 0, or -1 when there is none
int vp8d_take(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
    Decoder* d = static_cast<Decoder*>(h);
    if (!d->last) return -1;
    const Frame& f = *d->last;
    int w = d->width, ht = d->height, cw = (w + 1) / 2, ch = (ht + 1) / 2;
    for (int r = 0; r < ht; ++r) std::memcpy(y + (size_t)r * w, &f.y[(size_t)r * f.W], w);
    for (int r = 0; r < ch; ++r) {
        std::memcpy(u + (size_t)r * cw, &f.u[(size_t)r * f.CW], cw);
        std::memcpy(v + (size_t)r * cw, &f.v[(size_t)r * f.CW], cw);
    }
    return 0;
}

// a frame's header read with no decoder state: out = [drop reason (0 when
// FFmpeg decodes it), key frame, version, show_frame, key frame width,
// height, colour space, full range, a key frame whose segment map comes
// from the frame before]
void vp8d_probe(const uint8_t* data, int64_t size, int32_t* out) {
    Decoder d;
    int status = d.header(data, (size_t)size, true);
    out[0] = status == OK ? OK : d.reason;
    out[1] = d.key;
    out[2] = d.version;
    out[3] = d.show;
    out[4] = d.key_width;
    out[5] = d.key_height;
    out[6] = d.colour_space;
    out[7] = d.full_range;
    out[8] = d.key && d.seg_from_previous;
}

}  // extern "C"
