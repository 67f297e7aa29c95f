// A random legal-syntax VP9 profile 0 writer, for holding the port's decoder
// (`omfs4d_torch/io/vp9dec.cpp`) to cv2's FFmpeg on what cv2's libvpx does
// not write.  Built by `tests/torch_vp9_syntax.py` with g++.
//
// It drives the decoder's parser (`vp9::Decoder`) with a source of syntax
// that, at each read, draws a legal value for the element the parser names
// and writes it: the uncompressed header's bits with a bit writer, the
// compressed header and the tiles with its own boolean encoder (libvpx's
// `vpx_writer`, ended as libvpx ends a partition).  So each element is coded
// with the probability the parser reads it with, through every delta update,
// saved context and backward adaptation, and the parser's own reconstruction
// keeps the state that later elements depend on (vectors, contexts, maps).
// cv2 is the judge: a parse the port and FFmpeg disagree on shows as frames
// that differ.
//
// What it keeps legal: references only to filled slots; no skip segment
// feature on an inter block below 8x8; vectors within libvpx's range;
// a transform block's dequantised coefficients at most `budget` in absolute
// sum (so the 16-bit transforms of FFmpeg's SIMD never saturate).

#define VP9_NO_C_API
#include "vp9dec.cpp"

#include <array>

namespace {

using namespace vp9;

// the options, as `torch_vp9_syntax.OPTIONS` lists them
enum {
    O_WIDTH, O_HEIGHT, O_SEED, O_ERROR_RES, O_REFRESH_CTX, O_PARALLEL, O_CTX_IDX, O_RESET_CTX,
    O_Q_MIN, O_Q_MAX, O_DELTA_Q, O_LOSSLESS, O_LF_MIN, O_LF_MAX, O_LF_DELTA, O_SHARPNESS,
    O_SEG, O_SEG_TEMPORAL, O_SEG_DATA, O_SEG_SKIP_REF, O_TILE_COLS, O_TILE_ROWS, O_SWITCHABLE,
    O_HP, O_COMPOUND, O_UPDATES, O_SUB8X8, O_SPLIT, O_SKIP, O_DENSITY, O_FAR_MV, O_TX_MODES,
    O_COLOUR_SPACE, O_FULL_RANGE, O_INTRA, O_BUDGET, O_BIG_TOKENS, O_FOUND_REF, N_OPTIONS
};

// the writer's own counts in `stats`, after the kinds
enum { S_UPDATE = 200, S_ZERO, S_CAT, S_MV_CLASS0 = S_CAT + 6, S_MV_CLASS, S_MV_CLASS10,
       S_LOSSLESS, S_ADAPT, S_PARALLEL_SAVE, S_ERROR_RES, S_INTRA_ONLY, S_HIDDEN, S_EXISTING,
       S_TILE_COLS, S_TILE_ROWS, S_SEG_TEMPORAL, S_SEG_Q, S_SEG_LF, S_SEG_REF, S_SEG_SKIP,
       S_COMP_SELECT, S_COMP_ONLY, S_SWITCHABLE, S_TX_MODE, S_CTX_IDX = S_TX_MODE + 5,
       S_RESET = S_CTX_IDX + 4, S_FILTER = S_RESET + 4, S_HP = S_FILTER + 4, S_LF_DELTA,
       S_SHARP, S_SEG_NOMAP, S_END };

struct Rng {
    uint64_t s;
    uint64_t next() {
        uint64_t z = (s += 0x9E3779B97F4A7C15ull);
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
        return z ^ (z >> 31);
    }
    int below(int n) { return n <= 1 ? 0 : (int)(next() % (uint64_t)n); }
    bool permille(int p) { return below(1000) < p; }
    int range(int lo, int hi) { return lo + below(hi - lo + 1); }
};

struct BitWriter {
    std::vector<uint8_t> buf;
    size_t bits = 0;
    void put(uint32_t v, int n) {
        for (int i = n - 1; i >= 0; --i) {
            if ((bits >> 3) >= buf.size()) buf.push_back(0);
            if ((v >> i) & 1) buf[bits >> 3] |= (uint8_t)(0x80 >> (bits & 7));
            ++bits;
        }
    }
};

// libvpx's vpx_writer
struct BoolEncoder {
    std::vector<uint8_t> out;
    uint32_t low = 0, range = 255;
    int count = -24;
    void write(int bit, int prob) {
        uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
        uint32_t r = split;
        if (bit) {
            low += split;
            r = range - split;
        }
        int shift = __builtin_clz(r) - 24;
        r <<= shift;
        count += shift;
        if (count >= 0) {
            int offset = shift - count;
            if ((low << (offset - 1)) & 0x80000000u) {
                int x = (int)out.size() - 1;
                while (x >= 0 && out[x] == 0xff) out[x--] = 0;
                out[x] += 1;
            }
            out.push_back((uint8_t)((low >> (24 - offset)) & 0xff));
            low <<= offset;
            shift = count;
            low &= 0xffffff;
            count -= 8;
        }
        low <<= shift;
        range = r;
    }
    std::vector<uint8_t> finish() {
        for (int i = 0; i < 32; ++i) write(0, 128);
        if (!out.empty() && (out.back() & 0xe0) == 0xc0) out.push_back(0);
        return out;
    }
};

struct Plan {
    int kind = 0;          // 0 key, 1 inter, 2 intra-only, 3 show an existing frame
    int show = 1, slot = -1, refresh = -1, error_res = -1;
};

struct Writer {
    std::array<int, N_OPTIONS> o{};
    Rng rng{0};
    Decoder<Writer>* dec = nullptr;
    Plan plan;
    BitWriter bw;
    BoolEncoder be;
    size_t header_size_at = 0;
    std::vector<uint8_t> compressed;
    std::vector<std::vector<uint8_t>> tiles;
    // the frame's draws
    int lossless = 0, tx_mode = 0, tx_bits = 0, comp_mode = 0, seg_field = 0, last_hidden_slot = -1;
    int tile_row_bits = 0;
    bool has_map = false;
    long budget_left = 0;
    int64_t stats[256] = {};

    bool intra_frame() const { return dec->hd.keyframe || dec->hd.intra_only; }

    void frame_begin() {
        bw = BitWriter();
        compressed.clear();
        tiles.clear();
        tx_bits = 0;
        seg_field = 0;
        tile_row_bits = 0;
        lossless = plan.kind != 3 && rng.permille(o[O_LOSSLESS]);
    }

    // ── the uncompressed header ──
    int pick_f(int n, int k) {
        const Header& h = dec->hd;
        switch (k) {
        case K_MARKER: return 2;
        case K_PROFILE_LOW: case K_PROFILE_HIGH: case K_RESERVED: return 0;
        case K_SHOW_EXISTING: return plan.kind == 3;
        case K_EXISTING_IDX: {
            if (plan.slot >= 0) return plan.slot;
            if (last_hidden_slot >= 0) return last_hidden_slot;
            return rng.below(8);
        }
        case K_FRAME_TYPE: return plan.kind != 0;
        case K_SHOW_FRAME: return plan.kind == 2 ? 0 : plan.show;
        case K_ERROR_RES:
            return plan.error_res >= 0 ? plan.error_res : rng.permille(o[O_ERROR_RES]);
        case K_SYNC: return 0x498342;
        case K_COLOR_SPACE: return o[O_COLOUR_SPACE] >= 0 ? o[O_COLOUR_SPACE] : rng.below(7);
        case K_COLOR_RANGE: return o[O_FULL_RANGE];
        case K_WIDTH: return o[O_WIDTH] - 1;
        case K_HEIGHT: return o[O_HEIGHT] - 1;
        case K_RENDER_DIFF: return rng.permille(200);
        case K_RENDER_SIZE: return (int)(rng.next() & 0xffffffffu);
        case K_INTRA_ONLY: return plan.kind == 2;
        case K_RESET_CTX: return o[O_RESET_CTX] ? rng.below(4) : 0;
        case K_REFRESH_FLAGS: {
            int m = plan.refresh >= 0 ? plan.refresh : rng.range(1, 255);
            if (!h.show_frame) {
                for (int s = 0; s < 8; ++s)
                    if (m >> s & 1) { last_hidden_slot = s; break; }
            }
            return m;
        }
        case K_REF_IDX: return rng.below(8);
        case K_SIGN_BIAS: return o[O_COMPOUND] ? rng.below(2) : 0;
        case K_FOUND_REF: return rng.permille(o[O_FOUND_REF]);
        case K_HP: return rng.permille(o[O_HP]);
        case K_FILTER_SWITCHABLE: return rng.permille(o[O_SWITCHABLE]);
        case K_FILTER_LITERAL: return rng.below(4);
        case K_REFRESH_CTX: return rng.permille(o[O_REFRESH_CTX]);
        case K_PARALLEL: return rng.permille(o[O_PARALLEL]);
        case K_CTX_IDX: return o[O_CTX_IDX] ? rng.below(4) : 0;
        case K_LF_LEVEL: return rng.range(o[O_LF_MIN], o[O_LF_MAX]);
        case K_SHARPNESS: return rng.range(0, o[O_SHARPNESS]);
        case K_LF_DELTA_ENABLED: return rng.permille(o[O_LF_DELTA]);
        case K_LF_DELTA_UPDATE: case K_LF_UPDATE: return rng.below(2);
        case K_LF_VALUE: return rng.below(64);
        case K_LF_SIGN: case K_DELTA_Q_SIGN: case K_SEG_SIGN: return rng.below(2);
        case K_BASE_Q: return lossless ? 0 : rng.range(std::max(1, o[O_Q_MIN]), o[O_Q_MAX]);
        case K_DELTA_Q_CODED: return !lossless && rng.permille(o[O_DELTA_Q]);
        case K_DELTA_Q: return rng.range(1, 15);
        case K_SEG_ENABLED: return o[O_SEG];
        case K_SEG_UPDATE_MAP: {
            // an error-resilient frame writes its map: one it keeps is a
            // buffer FFmpeg never wrote for the next frame to predict from
            int u = intra_frame() || h.error_res || !has_map || rng.below(2);
            has_map = true;
            return u;
        }
        case K_SEG_PROB_CODED: case K_SEG_PRED_CODED: return rng.below(2);
        case K_SEG_PROB: case K_SEG_PRED_PROB: return rng.range(1, 255);
        case K_SEG_TEMPORAL:
            return !intra_frame() && !h.error_res && rng.permille(o[O_SEG_TEMPORAL]);
        case K_SEG_UPDATE_DATA: return rng.permille(o[O_SEG_DATA]);
        case K_SEG_ABS: seg_field = 0; return rng.below(2);
        case K_SEG_FEATURE: {
            int field = seg_field++ & 3, seg = (seg_field - 1) >> 2;
            if (field >= 2 && (!o[O_SEG_SKIP_REF] || seg == 0)) return 0;
            return rng.permille(field >= 2 ? 250 : 500);
        }
        case K_SEG_VALUE: return (int)(rng.next() & ((1u << n) - 1));
        case K_TILE_COL_INC: return o[O_TILE_COLS] < 0 ? rng.below(2) : 1;
        case K_TILE_ROWS: return rng.below(2) && o[O_TILE_ROWS] > 0;
        case K_HEADER_SIZE: header_size_at = bw.bits; return 0;
        default: return 0;
        }
    }
    int f(int n, int k) {
        int v = pick_f(n, k);
        if (k == K_TILE_COL_INC && o[O_TILE_COLS] >= 0)
            v = dec->hd.tile_cols_log2 < o[O_TILE_COLS];
        if (k == K_TILE_ROWS) {
            // the first bit says 1 or more, the second 2
            v = tile_row_bits++ == 0 ? o[O_TILE_ROWS] >= 1 && rng.below(o[O_TILE_ROWS] + 1) > 0
                                     : o[O_TILE_ROWS] >= 2 && rng.below(2);
        }
        if (k == K_REF_IDX || k == K_EXISTING_IDX) {
            // only slots holding a frame
            while (!dec->refs[v]) v = rng.below(8);
        }
        bw.put((uint32_t)v, n);
        return v;
    }

    // ── boolean-coded elements ──
    int pick_b(int p, int k) {
        const Decoder<Writer>& d = *dec;
        switch (k) {
        case K_TX_MODE: {
            if (tx_bits == 0) {
                int allowed[5], n = 0;
                for (int m = 0; m < 5; ++m)
                    if (o[O_TX_MODES] >> m & 1) allowed[n++] = m;
                tx_mode = n ? allowed[rng.below(n)] : 4;
            }
            int bit = tx_bits == 0 ? (std::min(tx_mode, 3) >> 1) & 1 : std::min(tx_mode, 3) & 1;
            ++tx_bits;
            return bit;
        }
        case K_TX_SELECT: return tx_mode == 4;
        case K_UPDATE: return rng.permille(o[O_UPDATES]);
        case K_COEF_UPDATE_ANY: return rng.permille(o[O_UPDATES] ? 500 : 0);
        case K_COMP_MODE:
            comp_mode = o[O_COMPOUND] ? rng.below(3) : 0;
            return comp_mode != 0;
        case K_COMP_SELECT: return comp_mode == 2;
        case K_SPLIT_OR_HORZ: case K_SPLIT_OR_VERT: return rng.below(2);
        case K_SEG_PREDICTED: {
            int s = const_cast<Decoder<Writer>&>(d).predicted_segment();
            if (!seg_ok(s)) return 0;
            return rng.below(2);
        }
        case K_SKIP: return rng.permille(o[O_SKIP]);
        case K_TX_SIZE: return rng.below(2);
        case K_IS_INTER: return !rng.permille(o[O_INTRA]);
        case K_COMP: return rng.below(2);
        case K_COMP_REF: case K_SINGLE_REF1: case K_SINGLE_REF2: return rng.below(2);
        case K_MORE_COEFS: {
            if (d.coef_pos == 0) budget_left = o[O_BUDGET];
            if (budget_left < std::max(1, d.coef_q)) return 0;
            int keep = o[O_DENSITY] - d.coef_pos * 1000 / std::max(1, d.coef_n) / 2;
            return rng.permille(std::max(keep, 100));
        }
        case K_SIGN: return rng.below(2);
        default: return rng.below(2);
        }
        (void)p;
    }
    bool seg_ok(int s) const {
        const Decoder<Writer>& d = *dec;
        return !(d.hd.seg_enabled && d.feat[s].skip_enabled && !intra_frame() &&
                 d.cb.sb_type < BLOCK_8X8);
    }
    int b(int p, int k) {
        int v = pick_b(p, k);
        ++stats[k];
        be.write(v, p);
        return v;
    }

    // the leaf a tree read gives; then its path is written
    int pick_leaf(const int8_t* t, int k) {
        const Decoder<Writer>& d = *dec;
        if (k == K_PARTITION) {
            bool any_skip = false;
            for (int s = 0; s < 8; ++s) any_skip |= d.hd.seg_enabled && d.feat[s].skip_enabled;
            if (d.cur_bsl == 3 && (!o[O_SUB8X8] || (any_skip && !intra_frame())))
                return PARTITION_NONE;
            if (rng.permille(o[O_SPLIT] - d.cur_bsl * 100)) return PARTITION_SPLIT;
            return rng.below(3);
        }
        if (k == K_SEG_ID) {
            int s;
            do s = rng.below(8);
            while (!seg_ok(s));
            return s;
        }
        if (k == K_MV_JOINT) return rng.range(1, 3);
        // every leaf of the tree, uniformly
        int size = t == INTRA_MODE_TREE ? 18 : t == SEGMENT_TREE ? 14 : t == MV_CLASS_TREE ? 20
                 : t == INTERP_FILTER_TREE ? 4 : 6;
        int leaves[16], n = 0;
        for (int i = 0; i < size; ++i)
            if (t[i] <= 0) leaves[n++] = -t[i];
        return leaves[rng.below(n)];
    }
    bool path(const int8_t* t, int node, int leaf, std::vector<std::pair<int, int>>& out) {
        for (int bit = 0; bit < 2; ++bit) {
            int nx = t[node + bit];
            out.push_back({node, bit});
            if (nx > 0) {
                if (path(t, nx, leaf, out)) return true;
            } else if (-nx == leaf) {
                return true;
            }
            out.pop_back();
        }
        return false;
    }
    void write_leaf(const int8_t* t, const uint8_t* p, int leaf) {
        std::vector<std::pair<int, int>> steps;
        path(t, 0, leaf, steps);
        for (auto& s : steps) be.write(s.second, p[s.first >> 1]);
    }
    int tree(const int8_t* t, const uint8_t* p, int k) {
        int leaf = pick_leaf(t, k);
        ++stats[k];
        write_leaf(t, p, leaf);
        return leaf;
    }

    void lit(int v, int n) {
        for (int i = n - 1; i >= 0; --i) be.write((v >> i) & 1, 128);
    }
    int update_prob(int p) {
        int target = rng.range(1, 255);
        auto inv_recenter = [](int v, int m) {
            if (v > 2 * m) return v;
            return (v & 1) ? m - ((v + 1) >> 1) : m + (v >> 1);
        };
        for (int tries = 0;; ++tries) {
            for (int d = 0; d < 255; ++d) {
                int v = INV_MAP_TABLE[d];
                int got = p <= 128 ? 1 + inv_recenter(v, p - 1) : 255 - inv_recenter(v, 255 - p);
                if (got != target) continue;
                if (d < 16) {
                    be.write(0, 128);
                    lit(d, 4);
                } else if (d < 32) {
                    be.write(1, 128);
                    be.write(0, 128);
                    lit(d - 16, 4);
                } else if (d < 64) {
                    be.write(1, 128);
                    be.write(1, 128);
                    be.write(0, 128);
                    lit(d - 32, 5);
                } else {
                    be.write(1, 128);
                    be.write(1, 128);
                    be.write(1, 128);
                    int dd = d - 64;
                    if (dd < 65) {
                        lit(dd, 7);
                    } else {
                        lit((dd + 65) >> 1, 7);
                        be.write((dd + 65) & 1, 128);
                    }
                }
                ++stats[S_UPDATE];
                return target;
            }
            target = rng.range(1, 255);
        }
    }
    int mv_prob() {
        int v = rng.below(128);
        lit(v, 7);
        return (v << 1) | 1;
    }

    int token(const uint8_t* tp, int* val) {
        const Decoder<Writer>& d = *dec;
        int q = std::max(1, d.coef_q);
        long room = budget_left / q;
        int tok = 0;
        if (room >= 1) {
            int r = rng.below(1000);
            int want = r < 350 ? 0 : r < 700 ? 1 : r < 850 ? rng.range(2, 4) : r < 950 ? rng.range(5, 10)
                     : o[O_BIG_TOKENS] ? rng.range(11, 2000) : rng.range(11, 40);
            tok = (int)std::min<long>(want, room);
        }
        // the value's token and extra bits
        int v = tok, t;
        if (v == 0) {
            be.write(0, tp[1]);
            ++stats[S_ZERO];
            return 0;
        }
        be.write(1, tp[1]);
        budget_left -= (long)v * q;
        *val = v;
        if (v == 1) {
            be.write(0, tp[2]);
            return 1;
        }
        be.write(1, tp[2]);
        if (v <= 4) {
            be.write(0, tp[3]);
            if (v == 2) {
                be.write(0, tp[4]);
                return 2;
            }
            be.write(1, tp[4]);
            be.write(v == 4, tp[5]);
            return v;
        }
        be.write(1, tp[3]);
        int cat = v >= 67 ? 5 : v >= 35 ? 4 : v >= 19 ? 3 : v >= 11 ? 2 : v >= 7 ? 1 : 0;
        if (cat <= 1) {
            be.write(0, tp[6]);
            be.write(cat, tp[7]);
        } else if (cat <= 3) {
            be.write(1, tp[6]);
            be.write(0, tp[8]);
            be.write(cat == 3, tp[9]);
        } else {
            be.write(1, tp[6]);
            be.write(1, tp[8]);
            be.write(cat == 5, tp[10]);
        }
        int extra = v - CAT_BASE[cat], nbits = 0;
        for (const uint8_t* p = CAT_PROBS + CAT_START[cat]; *p; ++p) ++nbits;
        int k = 0;
        for (const uint8_t* p = CAT_PROBS + CAT_START[cat]; *p; ++p, ++k)
            be.write((extra >> (nbits - 1 - k)) & 1, *p);
        t = 5 + cat;
        ++stats[S_CAT + cat];
        return t;
    }

    int mv_comp(const uint8_t* m, bool hp, int best) {
        int c = rng.permille(o[O_FAR_MV]) ? rng.range(6, 10) : rng.below(4);
        int mag, sign, d, fr, e;
        for (;;) {
            sign = rng.below(2);
            if (!c) {
                d = rng.below(2);
            } else {
                d = rng.below(1 << c);
            }
            fr = rng.below(4);
            e = hp ? rng.below(2) : 1;
            mag = (c ? 2 << (c + 2) : 0) + ((d << 3) | (fr << 1) | e) + 1;
            int v = sign ? -mag : mag;
            if (std::abs(best + v) < (1 << 14)) break;
            if (std::abs(best - v) < (1 << 14)) {
                sign = !sign;
                break;
            }
            if (c) --c;
        }
        ++stats[c ? S_MV_CLASS : S_MV_CLASS0];
        if (c == 10) ++stats[S_MV_CLASS10];
        be.write(sign, m[MV_SIGN]);
        write_leaf(MV_CLASS_TREE, m + MV_CLASSES, c);
        if (!c) {
            be.write(d, m[MV_CLASS0]);
            write_leaf(MV_FP_TREE, m + MV_CLASS0_FP + 3 * d, fr);
            if (hp) be.write(e, m[MV_CLASS0_HP]);
        } else {
            for (int i = 0; i < c; ++i) be.write((d >> i) & 1, m[MV_BITS + i]);
            write_leaf(MV_FP_TREE, m + MV_FP, fr);
            if (hp) be.write(e, m[MV_HP]);
        }
        return sign ? -mag : mag;
    }

    // ── partitions ──
    int open_compressed(int) {
        be = BoolEncoder();
        be.write(0, 128);
        return 0;
    }
    void close_compressed() { compressed = be.finish(); }
    int open_tile(bool) {
        be = BoolEncoder();
        be.write(0, 128);
        return 0;
    }
    void close_tile(bool) { tiles.push_back(be.finish()); }
    bool exhausted() { return false; }

    std::vector<uint8_t> assemble() {
        std::vector<uint8_t> out = bw.buf;
        if (plan.kind == 3) return out;
        // the compressed header's size, in the 16 bits left for it
        size_t n = compressed.size();
        for (int i = 0; i < 16; ++i) {
            size_t bit = header_size_at + i;
            if ((n >> (15 - i)) & 1) out[bit >> 3] |= (uint8_t)(0x80 >> (bit & 7));
        }
        out.insert(out.end(), compressed.begin(), compressed.end());
        for (size_t t = 0; t < tiles.size(); ++t) {
            if (t + 1 < tiles.size()) {
                uint32_t s = (uint32_t)tiles[t].size();
                uint8_t be4[4] = {(uint8_t)(s >> 24), (uint8_t)(s >> 16), (uint8_t)(s >> 8), (uint8_t)s};
                out.insert(out.end(), be4, be4 + 4);
            }
            out.insert(out.end(), tiles[t].begin(), tiles[t].end());
        }
        return out;
    }
};

struct Handle {
    Writer w;
    Decoder<Writer> dec{w};
    std::string error;
    std::vector<uint8_t> last;
};

}  // namespace

extern "C" {

void* vp9w_new(const int32_t* opts, int n) {
    Handle* h = new Handle();
    for (int i = 0; i < n && i < N_OPTIONS; ++i) h->w.o[i] = opts[i];
    h->w.rng.s = (uint64_t)(uint32_t)h->w.o[O_SEED] * 0x100000001B3ull + 12345;
    h->w.dec = &h->dec;
    return h;
}

void vp9w_free(void* h) { delete static_cast<Handle*>(h); }

// write one frame of the plan; its size (then `vp9w_take`), or -1
int64_t vp9w_frame(void* hp, int kind, int show, int slot, int refresh, int error_res) {
    Handle& h = *static_cast<Handle*>(hp);
    h.w.plan = Plan{kind, show, slot, refresh, error_res};
    try {
        h.dec.decode_frame();
        h.last = h.w.assemble();
        const Header& d = h.dec.hd;
        int64_t* st = h.w.stats;
        if (kind == 3) {
            ++st[S_EXISTING];
        } else {
            st[S_LOSSLESS] += d.lossless;
            st[S_ADAPT] += d.refresh_ctx && !d.parallel;
            st[S_PARALLEL_SAVE] += d.refresh_ctx && d.parallel;
            st[S_ERROR_RES] += d.error_res;
            st[S_INTRA_ONLY] += d.intra_only;
            st[S_HIDDEN] += !d.show_frame;
            st[S_TILE_COLS] = std::max<int64_t>(st[S_TILE_COLS], d.tile_cols_log2);
            st[S_TILE_ROWS] = std::max<int64_t>(st[S_TILE_ROWS], d.tile_rows_log2);
            st[S_SEG_TEMPORAL] += d.seg_enabled && d.seg_temporal;
            st[S_SEG_NOMAP] += d.seg_enabled && !d.seg_update_map;
            for (int s = 0; s < 8 && d.seg_enabled; ++s) {
                st[S_SEG_Q] += h.dec.feat[s].q_enabled;
                st[S_SEG_LF] += h.dec.feat[s].lf_enabled;
                st[S_SEG_REF] += h.dec.feat[s].ref_enabled;
                st[S_SEG_SKIP] += h.dec.feat[s].skip_enabled;
            }
            st[S_COMP_SELECT] += d.comp_mode == REFERENCE_SELECT;
            st[S_COMP_ONLY] += d.comp_mode == COMPOUND_REF;
            st[S_SWITCHABLE] += !(d.keyframe || d.intra_only) && d.interp_filter == SWITCHABLE;
            if (!(d.keyframe || d.intra_only) && d.interp_filter != SWITCHABLE) ++st[S_FILTER + d.interp_filter];
            st[S_HP] += !(d.keyframe || d.intra_only) && d.allow_hp;
            ++st[S_TX_MODE + d.tx_mode];
            ++st[S_CTX_IDX + d.ctx_read];
            if (d.intra_only) ++st[S_RESET + d.reset_ctx];
            st[S_LF_DELTA] += d.lf_delta_enabled;
            st[S_SHARP] += d.sharpness > 0;
        }
    } catch (const std::exception& e) {
        h.error = e.what();
        return -1;
    }
    return (int64_t)h.last.size();
}

void vp9w_take(void* hp, uint8_t* out) {
    Handle& h = *static_cast<Handle*>(hp);
    memcpy(out, h.last.data(), h.last.size());
}

const char* vp9w_error(void* hp) { return static_cast<Handle*>(hp)->error.c_str(); }

// how often each element was drawn (by Kind, then from 200 the writer's own)
void vp9w_stats(void* hp, int64_t* out) {
    for (int i = 0; i < 256; ++i) out[i] = static_cast<Handle*>(hp)->w.stats[i];
}

}  // extern "C"
