// FFV1 (IETF RFC 9043) decoded on the host as FFmpeg's ffv1dec.c decodes it,
// bit for bit: the frames cv2 shows.
//
// - Versions 0 and 1 (the parameters in every key frame's header, one
//   slice) and 3 (the parameters in the extradata's configuration record;
//   slices, their sizes read back from the frame's end, each with its own
//   header and, with error correction, its CRC).  Version 2, FFmpeg's
//   experimental one, which cv2 does not write, is refused.
// - Coders: Golomb-Rice (run mode, the adaptive bias / drift / error sum a
//   context) and the range coder (the default state transition table, or
//   one given in the header or record; initial states from the record).
// - Prediction: the median of left, top and left + top - topleft, the
//   context from the quantised neighbour differences (5 inputs where the
//   tables use them).
// - Formats: YCbCr 4:4:4 / 4:4:0 / 4:2:2 / 4:2:0 / 4:1:1 / 4:1:0 and grey at
//   8 to 10 bits, RGB at 8 bits through the reversible colour transform,
//   with or without alpha (cv2's FFV1 writer stores BGRA; alpha is decoded
//   and dropped).  YCbCr with alpha, more bits, Bayer and version 4 are
//   refused.
// - Non-key frames keep every context's state from the frame before, so
//   frames decode in order.  A slice whose CRC fails (or whose header is
//   corrupt, or whose range coder ends off its size) is damaged: FFmpeg
//   shows the picture before it in its place (packed RGB: misplaced, see
//   `conceal_rgb`), and a damaged slice of a non-key frame is not decoded
//   until the next key frame.
//
// C API (`fvd_*`): new / free, init (size, extradata), decode (a packet: 1
// key frame, 0 not), info (format), take (planes as uint16), error.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Fail {
    int code;
    std::string msg;
};

[[noreturn]] void corrupt(const std::string &m) { throw Fail{-1, m}; }
[[noreturn]] void unsupported(const std::string &m) { throw Fail{-2, m}; }

const int CONTEXT_SIZE = 32;
const int MAX_SLICES = 1024;
const int MAX_QUANT_TABLES = 8;
const int MAX_OVERREAD = 2;

// ── the range coder (rangecoder.c) ──
struct Range {
    const uint8_t *start = nullptr, *p = nullptr, *end = nullptr;
    int low = 0, range = 0, overread = 0;
    uint8_t zero[256], one[256];

    // buf holds at least 2 bytes past size (the callers pad it), as FFmpeg's
    // padded packets do
    void init(const uint8_t *buf, size_t size) {
        start = p = buf;
        end = buf + size;
        low = buf[0] << 8 | buf[1];
        p += 2;
        range = 0xFF00;
        overread = 0;
        if (low >= 0xFF00) {
            low = 0xFF00;
            end = p;
        }
    }
    void build_states() {
        const int64_t one64 = int64_t(1) << 32;
        const int64_t factor = int64_t(0.05 * (int64_t(1) << 32));
        const int max_p = 256 - 8;
        memset(zero, 0, sizeof zero);
        memset(one, 0, sizeof one);
        int last_p8 = 0;
        int64_t pr = one64 / 2;
        for (int i = 0; i < 128; i++) {
            int p8 = int((256 * pr + one64 / 2) >> 32);
            if (p8 <= last_p8) p8 = last_p8 + 1;
            if (last_p8 && last_p8 < 256 && p8 <= max_p) one[last_p8] = uint8_t(p8);
            pr += ((one64 - pr) * factor + one64 / 2) >> 32;
            last_p8 = p8;
        }
        for (int i = 256 - max_p; i <= max_p; i++) {
            if (one[i]) continue;
            pr = (i * one64 + 128) >> 8;
            pr += ((one64 - pr) * factor + one64 / 2) >> 32;
            int p8 = int((256 * pr + one64 / 2) >> 32);
            if (p8 <= i) p8 = i + 1;
            if (p8 > max_p) p8 = max_p;
            one[i] = uint8_t(p8);
        }
        for (int i = 1; i < 255; i++) zero[i] = uint8_t(256 - one[256 - i]);
    }
    void refill() {
        if (range < 0x100) {
            range <<= 8;
            low <<= 8;
            if (p < end) {
                low += *p;
                p++;
            } else {
                overread++;
            }
        }
    }
    int get(uint8_t *state) {
        int range1 = (range * (*state)) >> 8;
        range -= range1;
        if (low < range) {
            *state = zero[*state];
            refill();
            return 0;
        }
        low -= range;
        *state = one[*state];
        range = range1;
        refill();
        return 1;
    }
    int symbol(uint8_t *state, int is_signed) {
        if (get(state + 0)) return 0;
        int e = 0;
        while (get(state + 1 + std::min(e, 9))) {
            e++;
            if (e > 31) corrupt("FFV1: a symbol of more than 31 bits");
        }
        unsigned a = 1;
        for (int i = e - 1; i >= 0; i--) a += a + get(state + 22 + std::min(i, 9));
        int s = -(is_signed && get(state + 11 + std::min(e, 10)));
        return int((a ^ unsigned(s)) - unsigned(s));
    }
};

// ── Golomb-Rice bits, most significant first ──
struct Bits {
    const uint8_t *p = nullptr;
    size_t n = 0, pos = 0;
    void init(const uint8_t *d, size_t bytes) { p = d, n = bytes * 8, pos = 0; }
    uint32_t peek32() const {
        size_t byte = pos >> 3, nb = n / 8;
        uint64_t v = 0;
        for (int k = 0; k < 5; k++) v = v << 8 | (byte + k < nb ? p[byte + k] : 0);
        return uint32_t(v >> (8 - (pos & 7)));
    }
    uint32_t get(int k) {
        uint32_t v = k ? peek32() >> (32 - k) : 0;
        pos += k;
        return v;
    }
    long left() const { return long(n) - long(pos); }
};

int av_log2(uint32_t v) { return 31 - __builtin_clz(v | 1); }

// get_ur_golomb(gb, k, 12, esc_len) then the sign folded from bit 0
int get_sr_golomb(Bits &b, int k, int limit, int esc_len) {
    uint32_t buf = b.peek32();
    unsigned v;
    int log = av_log2(buf);
    if (buf && log > 31 - limit) {
        buf >>= log - k;
        buf += (30U - log) << k;
        b.pos += 32 + k - log;
        v = buf;
    } else {
        b.pos += limit;
        v = b.get(esc_len) + limit - 1;
    }
    return int(v >> 1) ^ -int(v & 1);
}

struct VlcState {
    int16_t drift = 0, bias = 0;
    uint16_t error_sum = 4;
    uint8_t count = 1;
};

inline int fold(int diff, int bits) {
    if (bits == 8) return int8_t(diff);
    int shift = 32 - bits;
    return int(unsigned(diff) << shift) >> shift;
}

void update_vlc_state(VlcState &s, int v) {
    int drift = s.drift, count = s.count;
    s.error_sum += uint16_t(std::abs(v));
    drift += v;
    if (count == 128) {
        count >>= 1;
        drift >>= 1;
        s.error_sum >>= 1;
    }
    count++;
    if (drift <= -count) {
        s.bias = int16_t(std::max(s.bias - 1, -128));
        drift = std::max(drift + count, -count + 1);
    } else if (drift > 0) {
        s.bias = int16_t(std::min(s.bias + 1, 127));
        drift = std::min(drift - count, 0);
    }
    s.drift = int16_t(drift);
    s.count = uint8_t(count);
}

int get_vlc_symbol(Bits &b, VlcState &s, int bits) {
    int i = s.count, k = 0;
    while (i < s.error_sum) {
        k++;
        i += i;
    }
    int v = get_sr_golomb(b, k, 12, bits);
    v ^= ((2 * s.drift + s.count) >> 31);
    int ret = fold(v + s.bias, bits);
    update_vlc_state(s, v);
    return ret;
}

inline int mid_pred(int a, int b, int c) {
    if (a > b) std::swap(a, b);
    if (b > c) b = c > a ? c : a;
    return b;
}

const uint8_t LOG2_RUN[41] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 5, 5, 6,
                              6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
                              22, 23, 24};

typedef int16_t QuantTable[5][256];

struct Plane {
    int quant_table_index = 0, context_count = 0;
    std::vector<uint8_t> state;      // context_count x CONTEXT_SIZE
    std::vector<VlcState> vlc;
};

struct Slice {
    Range c;
    Bits gb;
    int x = 0, y = 0, w = 0, h = 0;
    Plane plane[4];
    int run_index = 0, damaged = 0;
};

struct Decoder {
    int width = 0, height = 0;
    // bits as coded (0: unknown, which FFmpeg reads as 8), depth as decoded
    int version = -1, micro_version = 0, ac = 0, colorspace = 0, bits = 0, depth = 8;
    int chroma_planes = 0, hshift = 0, vshift = 0, transparency = 0, plane_count = 0;
    int num_h = 1, num_v = 1, quant_table_count = 0, ec = 0, intra = 0;
    bool have_record = false, key_ok = false, have_pic = false, have_last = false;
    int key = 0;
    uint8_t state_transition[256];
    QuantTable quant_tables[MAX_QUANT_TABLES];
    int context_count[MAX_QUANT_TABLES] = {0};
    std::vector<uint8_t> initial_states[MAX_QUANT_TABLES];
    QuantTable quant_table;          // versions 0 / 1
    int v01_context_count = 0;
    std::vector<Slice> slices;
    int slice_count = 0;
    std::vector<uint16_t> pic[3], last[3];   // Y' / G, Cb / B, Cr / R
    std::vector<int32_t> sample_buf;
    std::string error;

    int cw() const { return colorspace == 0 ? -(-width >> hshift) : width; }
    int ch() const { return colorspace == 0 ? -(-height >> vshift) : height; }

    static int read_quant_table(Range &c, int16_t *table, int scale) {
        uint8_t state[CONTEXT_SIZE];
        memset(state, 128, sizeof state);
        int v = 0;
        for (int i = 0; i < 128; v++) {
            unsigned len = unsigned(c.symbol(state, 0)) + 1U;
            if (len > unsigned(128 - i) || !len) corrupt("FFV1: a corrupt quantisation table");
            while (len--) table[i++] = int16_t(scale * v);
        }
        for (int i = 1; i < 128; i++) table[256 - i] = int16_t(-table[i]);
        table[128] = int16_t(-table[127]);
        return 2 * v - 1;
    }

    static int read_quant_tables(Range &c, QuantTable &t) {
        int count = 1;
        for (int i = 0; i < 5; i++) {
            count *= read_quant_table(c, t[i], count);
            if (count > 32768 || count <= 0) corrupt("FFV1: too many contexts");
        }
        return (count + 1) / 2;
    }

    void set_format() {
        depth = bits ? bits : 8;
        if (colorspace == 0) {
            if (transparency) unsupported("FFV1 YCbCr with a transparency plane (alpha)");
            if (depth > 10)
                unsupported("FFV1 YCbCr at " + std::to_string(depth) + " bits (the port reads 8 to 10)");
            // FFmpeg's pixel formats: 4:4:4, 4:4:0, 4:2:2, 4:2:0, 4:1:1, 4:1:0 at 8
            // bits; 4:4:4, 4:2:2, 4:2:0 at 9 and those and 4:4:0 at 10
            const int sub = 16 * hshift + vshift;
            const bool known = depth <= 8 ? (sub == 0x00 || sub == 0x01 || sub == 0x10 ||
                                             sub == 0x11 || sub == 0x20 || sub == 0x22)
                                          : (sub == 0x00 || sub == 0x10 || sub == 0x11 ||
                                             (depth == 10 && sub == 0x01));
            if (chroma_planes && !known)
                unsupported("FFV1 YCbCr at " + std::to_string(depth) + " bits with chroma shifts " +
                            std::to_string(hshift) + ", " + std::to_string(vshift) +
                            " (no pixel format of FFmpeg's: cv2 shows no frame)");
        } else if (colorspace == 1) {
            if (hshift || vshift) corrupt("FFV1: chroma subsampling in the RGB colourspace");
            if (depth > 8)
                unsupported("FFV1 RGB at " + std::to_string(depth) + " bits (the port reads 8)");
        } else {
            unsupported("FFV1 colourspace " + std::to_string(colorspace) + " (Bayer or unknown)");
        }
    }

    void read_extra_header(const uint8_t *extra, size_t size) {
        Range c;
        std::vector<uint8_t> buf(extra, extra + size);
        buf.resize(size + 8, 0);
        c.init(buf.data(), size);
        c.build_states();
        uint8_t state[CONTEXT_SIZE];
        memset(state, 128, sizeof state);
        version = c.symbol(state, 0);
        if (version < 2) corrupt("FFV1: version " + std::to_string(version) + " in a configuration record");
        if (version != 3)
            unsupported("FFV1 version " + std::to_string(version) +
                        (version == 2 ? " (FFmpeg's experimental one, which cv2 does not write)" : ""));
        if (size < 4) corrupt("FFV1: a configuration record of fewer than 4 bytes");
        c.end -= 4;
        micro_version = c.symbol(state, 0);
        if (micro_version < 0) corrupt("FFV1: a negative micro version");
        ac = c.symbol(state, 0);
        if (ac == 2)
            for (int i = 1; i < 256; i++) {
                int st = c.symbol(state, 1) + c.one[i];
                if (st < 1 || st > 255) corrupt("FFV1: a state transition out of range");
                state_transition[i] = uint8_t(st);
            }
        colorspace = c.symbol(state, 0);
        bits = c.symbol(state, 0);
        chroma_planes = c.get(state);
        hshift = c.symbol(state, 0);
        vshift = c.symbol(state, 0);
        transparency = c.get(state);
        plane_count = 1 + (chroma_planes || version < 4) + transparency;
        num_h = 1 + c.symbol(state, 0);
        num_v = 1 + c.symbol(state, 0);
        if (hshift > 4 || vshift > 4 || hshift < 0 || vshift < 0) corrupt("FFV1: chroma shift out of range");
        if (num_h > width || num_h <= 0 || num_v > height || num_v <= 0) corrupt("FFV1: slice count invalid");
        if (num_h > MAX_SLICES / num_v) corrupt("FFV1: too many slices");
        quant_table_count = c.symbol(state, 0);
        if (quant_table_count > MAX_QUANT_TABLES || quant_table_count <= 0)
            corrupt("FFV1: quant table count invalid");
        for (int i = 0; i < quant_table_count; i++) {
            context_count[i] = read_quant_tables(c, quant_tables[i]);
            initial_states[i].assign(size_t(context_count[i]) * CONTEXT_SIZE, 128);
        }
        uint8_t state2[32][CONTEXT_SIZE];
        memset(state2, 128, sizeof state2);
        for (int i = 0; i < quant_table_count; i++)
            if (c.get(state))
                for (int j = 0; j < context_count[i]; j++)
                    for (int k = 0; k < CONTEXT_SIZE; k++) {
                        int pred = j ? initial_states[i][(j - 1) * CONTEXT_SIZE + k] : 128;
                        initial_states[i][j * CONTEXT_SIZE + k] = uint8_t((pred + c.symbol(state2[k], 1)) & 0xFF);
                    }
        ec = c.symbol(state, 0);
        if (micro_version > 2) intra = c.symbol(state, 0);
        if (crc(extra, size) != 0) corrupt("FFV1: the configuration record's CRC fails");
        set_format();
        have_record = true;
    }

    static uint32_t crc(const uint8_t *p, size_t n) {
        // CRC-32 of polynomial 0x04C11DB7, most significant bit first, no
        // inversion (FFmpeg's AV_CRC_32_IEEE as av_crc runs it, from 0)
        static uint32_t table[256];
        static bool made = false;
        if (!made) {
            for (uint32_t i = 0; i < 256; i++) {
                uint32_t c = i << 24;
                for (int j = 0; j < 8; j++) c = (c << 1) ^ (0x04C11DB7u & (0u - (c >> 31)));
                table[i] = c;
            }
            made = true;
        }
        uint32_t c = 0;
        for (size_t i = 0; i < n; i++) c = (c << 8) ^ table[(c >> 24) ^ p[i]];
        return c;
    }

    void init(int w, int h, const uint8_t *extra, int size) {
        if (w <= 0 || h <= 0 || w > 16384 || h > 16384) corrupt("FFV1: a frame size out of range");
        width = w, height = h;
        memset(state_transition, 0, sizeof state_transition);
        if (size > 0) read_extra_header(extra, size_t(size));
    }

    // ── the frame header (read_header) ──
    void read_header(Range &c) {
        uint8_t state[CONTEXT_SIZE];
        memset(state, 128, sizeof state);
        if (version < 2) {
            int v = c.symbol(state, 0);
            if (v >= 2) corrupt("FFV1: invalid version " + std::to_string(v) + " in a version 0 / 1 header");
            version = v;
            ac = c.symbol(state, 0);
            if (ac == 2)
                for (int i = 1; i < 256; i++) {
                    int st = c.symbol(state, 1) + c.one[i];
                    if (st < 1 || st > 255) corrupt("FFV1: a state transition out of range");
                    state_transition[i] = uint8_t(st);
                }
            int cs = c.symbol(state, 0);
            int b = version > 0 ? c.symbol(state, 0) : bits;
            int cp = c.get(state);
            int hs = c.symbol(state, 0), vs = c.symbol(state, 0);
            int tr = c.get(state);
            if (plane_count && (cs != colorspace || b != bits || cp != chroma_planes || hs != hshift ||
                                vs != vshift || tr != transparency))
                corrupt("FFV1: invalid change of global parameters");
            if (hs > 4 || vs > 4 || hs < 0 || vs < 0) corrupt("FFV1: chroma shift out of range");
            colorspace = cs, bits = b, chroma_planes = cp, hshift = hs, vshift = vs, transparency = tr;
            plane_count = 2 + transparency;
            set_format();
        }
        if (version < 2) {
            v01_context_count = read_quant_tables(c, quant_table);
            slice_count = 1;
        } else {
            const uint8_t *p = c.end;
            int trailer = 3 + 5 * !!ec;
            for (slice_count = 0; slice_count < MAX_SLICES && trailer < p - c.start; slice_count++) {
                int size = p[-trailer] << 16 | p[-trailer + 1] << 8 | p[-trailer + 2];
                if (size + trailer > p - c.start) break;
                p -= size + trailer;
            }
        }
        if (slice_count <= 0 || slice_count > num_h * num_v) corrupt("FFV1: slice count " + std::to_string(slice_count) + " invalid");
        slices.resize(size_t(slice_count));
        for (int j = 0; j < slice_count; j++) {
            Slice &s = slices[j];
            s.damaged = 0;
            if (version < 2) {             // version 3's slices read their own header
                s.x = 0, s.y = 0, s.w = width, s.h = height;
                for (int i = 0; i < plane_count; i++) s.plane[i].context_count = v01_context_count;
            }
        }
    }

    void set_slice_rect(Slice &s, int sx, int sy, int sw, int sh) {
        if (sx < 0 || sy < 0 || sw <= 0 || sh <= 0 || sx > num_h - sw || sy > num_v - sh)
            corrupt("FFV1: a slice position out of range");
        s.x = int(int64_t(sx) * width / num_h);
        s.y = int(int64_t(sy) * height / num_v);
        s.w = int(int64_t(sx + sw) * width / num_h) - s.x;
        s.h = int(int64_t(sy + sh) * height / num_v) - s.y;
    }

    void init_slice_state(Slice &s) {
        for (int j = 0; j < plane_count; j++) {
            Plane &p = s.plane[j];
            if (ac) {
                if (p.state.size() < size_t(p.context_count) * CONTEXT_SIZE)
                    p.state.resize(size_t(p.context_count) * CONTEXT_SIZE, 128);
            } else if (p.vlc.size() < size_t(p.context_count)) {
                p.vlc.resize(size_t(p.context_count));
            }
        }
        if (ac == 2)
            for (int j = 1; j < 256; j++) {
                s.c.one[j] = state_transition[j];
                s.c.zero[256 - j] = uint8_t(256 - s.c.one[j]);
            }
    }

    void clear_slice_state(Slice &s) {
        for (int i = 0; i < plane_count; i++) {
            Plane &p = s.plane[i];
            if (ac) {
                if (version >= 2 && p.quant_table_index < quant_table_count &&
                    !initial_states[p.quant_table_index].empty())
                    memcpy(p.state.data(), initial_states[p.quant_table_index].data(),
                           size_t(CONTEXT_SIZE) * p.context_count);
                else
                    memset(p.state.data(), 128, size_t(CONTEXT_SIZE) * p.context_count);
            } else {
                for (int j = 0; j < p.context_count; j++) p.vlc[j] = VlcState();
            }
        }
    }

    void decode_slice_header(Slice &s) {
        Range &c = s.c;
        uint8_t state[CONTEXT_SIZE];
        memset(state, 128, sizeof state);
        int sx = c.symbol(state, 0), sy = c.symbol(state, 0);
        int sw = c.symbol(state, 0) + 1, sh = c.symbol(state, 0) + 1;
        set_slice_rect(s, sx, sy, sw, sh);
        for (int i = 0; i < plane_count; i++) {
            Plane &p = s.plane[i];
            int idx = c.symbol(state, 0);
            if (idx < 0 || idx >= quant_table_count) corrupt("FFV1: quant table index out of range");
            p.quant_table_index = idx;
            p.context_count = context_count[idx];
        }
        c.symbol(state, 0);  // picture structure
        c.symbol(state, 0);  // sample aspect ratio
        c.symbol(state, 0);
    }

    const int16_t (*qt(const Slice &s, int plane))[256] {
        return version < 2 ? quant_table : quant_tables[s.plane[plane].quant_table_index];
    }

    // one line of samples (decode_line): sample[1] is the line, sample[0] the
    // one above; sample[1] holds the line two above on entry (its TT)
    void decode_line(Slice &s, int w, int32_t *sample[2], int plane_index, int nbits) {
        Plane &p = s.plane[plane_index];
        const int16_t(*q)[256] = qt(s, plane_index);
        const bool five = q[3][127] || q[4][127];
        Range &c = s.c;
        Bits &gb = s.gb;
        int run_count = 0, run_mode = 0, run_index = s.run_index;
        const unsigned mask = (1u << nbits) - 1;
        auto input_end = [&]() {
            if (ac ? c.overread > MAX_OVERREAD : gb.left() < 1) corrupt("FFV1: a slice's data ends early");
        };
        input_end();
        int32_t *cur = sample[1], *top = sample[0];
        for (int x = 0; x < w; x++) {
            if (!(x & 1023)) input_end();
            const int LT = top[x - 1], T = top[x], RT = top[x + 1], L = cur[x - 1];
            int context = q[0][(L - LT) & 0xFF] + q[1][(LT - T) & 0xFF] + q[2][(T - RT) & 0xFF];
            if (five) context += q[3][(cur[x - 2] - L) & 0xFF] + q[4][(cur[x] - T) & 0xFF];
            int sign = 0;
            if (context < 0) context = -context, sign = 1;
            if (context >= p.context_count) corrupt("FFV1: a context out of range");
            int diff;
            if (ac) {
                diff = c.symbol(&p.state[size_t(context) * CONTEXT_SIZE], 1);
            } else {
                if (context == 0 && run_mode == 0) run_mode = 1;
                if (run_mode) {
                    if (run_count == 0 && run_mode == 1) {
                        if (gb.get(1)) {
                            run_count = 1 << LOG2_RUN[run_index];
                            if (x + run_count <= w) run_index++;
                        } else {
                            run_count = LOG2_RUN[run_index] ? int(gb.get(LOG2_RUN[run_index])) : 0;
                            if (run_index) run_index--;
                            run_mode = 2;
                        }
                    }
                    run_count--;
                    if (run_count < 0) {
                        run_mode = 0;
                        run_count = 0;
                        diff = get_vlc_symbol(gb, p.vlc[context], nbits);
                        if (diff >= 0) diff++;
                    } else {
                        diff = 0;
                    }
                } else {
                    diff = get_vlc_symbol(gb, p.vlc[context], nbits);
                }
            }
            if (sign) diff = -diff;
            const int L2 = cur[x - 1], T2 = top[x], LT2 = top[x - 1];
            cur[x] = int32_t((unsigned(mid_pred(L2, L2 + T2 - LT2, T2)) + unsigned(diff)) & mask);
        }
        s.run_index = run_index;
    }

    void decode_plane(Slice &s, uint16_t *dst, int w, int h, int stride, int plane_index) {
        sample_buf.assign(size_t(2) * (w + 6), 0);
        int32_t *sample[2] = {sample_buf.data() + 3, sample_buf.data() + w + 6 + 3};
        s.run_index = 0;
        for (int y = 0; y < h; y++) {
            std::swap(sample[0], sample[1]);
            sample[1][-1] = sample[0][0];
            sample[0][w] = sample[0][w - 1];
            decode_line(s, w, sample, plane_index, depth <= 8 ? 8 : depth);
            uint16_t *row = dst + size_t(stride) * y;
            for (int x = 0; x < w; x++) row[x] = uint16_t(sample[1][x]);
        }
    }

    void decode_rgb(Slice &s, int w, int h) {
        sample_buf.assign(size_t(8) * (w + 6), 0);
        int32_t *sample[4][2];
        for (int k = 0; k < 4; k++) {
            sample[k][0] = sample_buf.data() + k * 2 * (w + 6) + 3;
            sample[k][1] = sample_buf.data() + (k * 2 + 1) * (w + 6) + 3;
        }
        s.run_index = 0;
        const int offset = 1 << depth;
        for (int y = 0; y < h; y++) {
            for (int p = 0; p < 3 + transparency; p++) {
                std::swap(sample[p][0], sample[p][1]);
                sample[p][1][-1] = sample[p][0][0];
                sample[p][0][w] = sample[p][0][w - 1];
                decode_line(s, w, sample[p], (p + 1) / 2, depth + 1);
            }
            size_t row = size_t(s.y + y) * width + s.x;
            for (int x = 0; x < w; x++) {
                int g = sample[0][1][x], b = sample[1][1][x], r = sample[2][1][x];
                b -= offset;
                r -= offset;
                g -= (b + r) >> 2;
                b += g;
                r += g;
                pic[0][row + x] = uint16_t(g & 0xFF);
                pic[1][row + x] = uint16_t(b & 0xFF);
                pic[2][row + x] = uint16_t(r & 0xFF);
            }
        }
    }

    void decode_slice(Slice &s) {
        if (version > 2) {
            init_slice_state(s);
            try {
                decode_slice_header(s);
            } catch (const Fail &f) {
                if (f.code != -1) throw;
                s.x = s.y = s.w = s.h = 0;
                s.damaged = 1;
                return;
            }
        }
        init_slice_state(s);
        if (key)
            clear_slice_state(s);
        else if (s.damaged)
            return;
        if (!ac) {
            if ((version == 3 && micro_version > 1) || version > 3) {
                uint8_t st = 129;
                s.c.get(&st);
            }
            size_t ac_bytes = (version > 2 || (!s.x && !s.y)) ? size_t(s.c.p - s.c.start - 1) : 0;
            s.gb.init(s.c.start + ac_bytes, size_t(s.c.end - s.c.start) - ac_bytes);
        }
        if (colorspace == 0) {
            const int cwid = -(-s.w >> hshift), chei = -(-s.h >> vshift);
            const int cx = s.x >> hshift, cy = s.y >> vshift;
            decode_plane(s, pic[0].data() + size_t(s.y) * width + s.x, s.w, s.h, width, 0);
            if (chroma_planes) {
                decode_plane(s, pic[1].data() + size_t(cy) * cw() + cx, cwid, chei, cw(), 1);
                decode_plane(s, pic[2].data() + size_t(cy) * cw() + cx, cwid, chei, cw(), 1);
            }
        } else {
            decode_rgb(s, s.w, s.h);
        }
        if (ac && version > 2) {
            uint8_t st = 129;
            s.c.get(&st);
            long v = long(s.c.end - s.c.p) - 2 - 5 * ec;
            if (v) s.damaged = 1;   // FFmpeg: "bytestream end mismatching"
        }
    }

    // returns 1 for a key frame
    int decode(const uint8_t *data, size_t size) {
        have_pic = false;
        std::vector<uint8_t> buf(data, data + size);
        buf.resize(size + 16, 0);
        Range c;
        c.init(buf.data(), size);
        c.build_states();
        uint8_t keystate = 128;
        key = c.get(&keystate);
        if (key) {
            key_ok = false;
            if (version < 0) version = 0;  // no record: a version 0 / 1 header follows
            read_header(c);
            key_ok = true;
        } else if (!key_ok) {
            corrupt("FFV1: a non-key frame with no key frame before it");
        }
        if (size < 1) corrupt("FFV1: an empty packet");
        const size_t n = size_t(width) * height, nc = size_t(cw()) * ch();
        pic[0].assign(n, 0);
        pic[1].assign(colorspace == 0 && !chroma_planes ? 0 : (colorspace ? n : nc), 0);
        pic[2].assign(pic[1].size(), 0);
        const uint8_t *buf_p = buf.data() + size;
        const int trailer = 3 + 5 * !!ec;
        for (int i = slice_count - 1; i >= 0; i--) {
            Slice &s = slices[i];
            long v;
            if (i || version > 2) {
                if (trailer > buf_p - buf.data())
                    v = 0x7FFFFFFF;
                else
                    v = (buf_p[-trailer] << 16 | buf_p[-trailer + 1] << 8 | buf_p[-trailer + 2]) + trailer;
            } else {
                v = long(buf_p - c.start);
            }
            if (buf_p - c.start < v) corrupt("FFV1: the slice pointer chain is broken");
            buf_p -= v;
            if (ec && crc(buf_p, size_t(v)) != 0) s.damaged = 1;
            if (i) {
                s.c.init(buf_p, size_t(v));
                s.c.build_states();
            } else {
                s.c = c;
                s.c.end = buf_p + v;
            }
        }
        for (int i = 0; i < slice_count; i++) decode_slice(slices[i]);
        for (int i = slice_count - 1; i >= 0; i--) {
            Slice &s = slices[i];
            if (!s.damaged || !have_last) continue;
            if (colorspace) {
                conceal_rgb(s.x, s.y, s.w, s.h);
                continue;
            }
            copy_rect(s.x, s.y, s.w, s.h, 0, 0);
            if (chroma_planes)
                for (int k = 1; k < 3; k++) copy_rect(s.x, s.y, s.w, s.h, 1, k);
        }
        for (int k = 0; k < 3; k++) last[k] = pic[k];
        have_last = have_pic = true;
        return key;
    }

    // FFmpeg's concealment of a packed RGB32 slice offsets it by slice_x
    // bytes, not pixels (its pixel shift is of the sample depth): the bytes
    // [x, x + 4 w) of each of the slice's rows, B, G, R, X a pixel, come from
    // the frame before; the rest of a slice not decoded keeps the fresh
    // frame's 0 (cv2's frames, measured)
    void conceal_rgb(int x, int y, int w, int h) {
        static const int plane_of[4] = {1, 0, 2, -1};
        for (int r = y; r < y + h; r++)
            for (int b = x; b < x + 4 * w; b++) {
                const int k = plane_of[b & 3];
                if (k < 0) continue;
                const size_t at = size_t(r) * width + (b >> 2);
                pic[k][at] = last[k][at];
            }
    }

    void copy_rect(int x, int y, int w, int h, int chroma, int k) {
        int sh = chroma ? hshift : 0, sv = chroma ? vshift : 0;
        int stride = chroma ? cw() : width;
        int x0 = x >> sh, y0 = y >> sv, ww = -(-w >> sh), hh = -(-h >> sv);
        for (int r = 0; r < hh; r++)
            memcpy(&pic[k][size_t(y0 + r) * stride + x0], &last[k][size_t(y0 + r) * stride + x0],
                   size_t(ww) * 2);
    }
};

template <class F>
int guarded(Decoder *d, F f) {
    try {
        return f();
    } catch (const Fail &e) {
        d->error = e.msg;
        return e.code;
    } catch (const std::exception &e) {
        d->error = std::string("FFV1: ") + e.what();
        return -1;
    }
}

}  // namespace

extern "C" {

void *fvd_new() { return new (std::nothrow) Decoder(); }

void fvd_free(void *h) { delete static_cast<Decoder *>(h); }

const char *fvd_error(void *h) { return static_cast<Decoder *>(h)->error.c_str(); }

int fvd_init(void *h, int width, int height, const uint8_t *extra, int size) {
    Decoder *d = static_cast<Decoder *>(h);
    return guarded(d, [&] {
        d->init(width, height, extra, size);
        return 0;
    });
}

// 1 for a key frame, 0 for another, < 0 an error
int fvd_decode(void *h, const uint8_t *data, int64_t size) {
    Decoder *d = static_cast<Decoder *>(h);
    return guarded(d, [&] { return d->decode(data, size_t(size)); });
}

// version, micro version, coder, colourspace, bits, chroma planes, h shift,
// v shift, slices, error correction, and the damaged slices of the last frame
void fvd_info(void *h, int32_t *out) {
    Decoder *d = static_cast<Decoder *>(h);
    int damaged = 0;
    for (auto &s : d->slices) damaged += s.damaged;
    int32_t v[11] = {d->version, d->micro_version, d->ac, d->colorspace, d->depth,
                     d->chroma_planes, d->hshift, d->vshift, d->slice_count, d->ec, damaged};
    memcpy(out, v, sizeof v);
}

// Y', Cb, Cr (chroma of the subsampled size) or G, B, R, as uint16 samples
int fvd_take(void *h, uint16_t *p0, uint16_t *p1, uint16_t *p2) {
    Decoder *d = static_cast<Decoder *>(h);
    if (!d->have_pic) return -1;
    memcpy(p0, d->pic[0].data(), d->pic[0].size() * 2);
    if (!d->pic[1].empty()) {
        memcpy(p1, d->pic[1].data(), d->pic[1].size() * 2);
        memcpy(p2, d->pic[2].data(), d->pic[2].size() * 2);
    }
    return 0;
}

}  // extern "C"
