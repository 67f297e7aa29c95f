// HuffYUV at 8 bits, decoded on the host as FFmpeg's huffyuvdec.c decodes it
// (its `huffyuv` and `ffvhuff` decoders), bit for bit: the frames cv2 shows.
//
// - Versions: 0 / 1 (no Huffman tables in the extradata: the predictor and
//   the decorrelation from biBitCount's low 3 bits, the classic tables of
//   huffyuv_tables.h) and 2 (the extradata's method byte, bit depth,
//   interlace and context flags, then its run-length coded code lengths);
//   with `context` every packet starts with its own tables.
// - Formats: YUV 4:2:2 (16 bits), 4:2:0 (12 bits, ffvhuff's), RGB24 and
//   RGB32 (stored bottom-up, G, B - G, R - G where decorrelated, as ARGB).
// - Predictors: left, plane (left, then the row above, or two above where
//   interlaced, added) and median (YUV only: the first row left predicted,
//   the second's first 4 pixels too, then the median of left, top and
//   left + top - topleft), FFmpeg's row order and special rows kept.
// - The packet is read as 32-bit little-endian words whose bits run from
//   the most significant (FFmpeg byte-swaps them, `bswap_buf`).
//
// C API (`hyd_*`): new / free, init (size, biBitCount, extradata; 0, or -1
// corrupt / -2 outside the decoder with `hyd_error`), format (0 YUV 4:2:0,
// 1 YUV 4:2:2, 2 RGB24, 3 RGB32), decode (a packet), take (Y', Cb, Cr planes,
// or R, G, B planes, uint8).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "huffyuv_tables.h"

namespace {

enum { LEFT = 0, PLANE = 1, MEDIAN = 2 };
enum { YUV420 = 0, YUV422 = 1, RGB24 = 2, RGB32 = 3 };

struct Fail {
    int code;
    std::string msg;
};

[[noreturn]] void corrupt(const std::string &m) { throw Fail{-1, m}; }
[[noreturn]] void unsupported(const std::string &m) { throw Fail{-2, m}; }

// most significant bit first over a byte buffer
struct Bits {
    const uint8_t *p = nullptr;
    size_t n = 0, pos = 0;  // in bits
    void init(const uint8_t *d, size_t bytes) { p = d, n = bytes * 8, pos = 0; }
    uint32_t peek32() const {
        size_t byte = pos >> 3;
        uint64_t v = 0;
        for (int k = 0; k < 5; k++)
            v = v << 8 | (byte + k < n / 8 ? p[byte + k] : 0);
        return uint32_t(v >> (8 - (pos & 7)));
    }
    uint32_t get(int k) {
        uint32_t v = k ? peek32() >> (32 - k) : 0;
        pos += k;
        return v;
    }
    long left() const { return long(n) - long(pos); }
};

// a prefix code: a 12-bit lookup, and the codes of each longer length as
// runs of consecutive values
struct Vlc {
    static const int FAST = 12;
    std::vector<uint16_t> fast;  // sym << 5 | len, 0: longer or no code
    uint32_t first[33];
    int count[33];
    std::vector<int> syms[33];
    void build(const uint8_t *len, const uint32_t *code, int n) {
        fast.assign(1 << FAST, 0);
        for (int l = 0; l <= 32; l++) first[l] = 0, count[l] = 0, syms[l].clear();
        std::vector<std::vector<std::pair<uint32_t, int>>> by(33);
        for (int s = 0; s < n; s++) {
            int l = len[s];
            if (!l) continue;
            if (l > 32) corrupt("HuffYUV: a code longer than 32 bits");
            if (l <= FAST) {
                uint32_t base = code[s] << (FAST - l);
                for (uint32_t k = 0; k < (1u << (FAST - l)); k++) {
                    if (fast[base + k]) corrupt("HuffYUV: the codes are not a prefix code");
                    fast[base + k] = uint16_t(s << 5 | l);
                }
            } else {
                by[l].push_back({code[s], s});
            }
        }
        for (int l = FAST + 1; l <= 32; l++) {
            auto &v = by[l];
            if (v.empty()) continue;
            std::sort(v.begin(), v.end());
            first[l] = v[0].first;
            // codes of one length that are not consecutive: keep them sparse
            for (size_t k = 0; k < v.size(); k++) {
                uint32_t gap = v[k].first - first[l];
                if (gap >= syms[l].size()) syms[l].resize(gap + 1, -1);
                syms[l][gap] = v[k].second;
            }
            count[l] = int(syms[l].size());
        }
    }
    int read(Bits &b) const {
        uint32_t w = b.peek32();
        uint16_t e = fast[w >> (32 - FAST)];
        if (e) {
            b.pos += e & 31;
            return e >> 5;
        }
        for (int l = FAST + 1; l <= 32; l++) {
            if (!count[l]) continue;
            uint32_t c = w >> (32 - l);
            if (c >= first[l] && c - first[l] < uint32_t(count[l]) && syms[l][c - first[l]] >= 0) {
                b.pos += l;
                return syms[l][c - first[l]];
            }
        }
        corrupt("HuffYUV: a code of no symbol");
    }
};

void read_len_table(uint8_t *dst, Bits &b, int n) {
    for (int i = 0; i < n;) {
        int repeat = int(b.get(3)), val = int(b.get(5));
        if (repeat == 0) repeat = int(b.get(8));
        if (i + repeat > n || b.left() < 0) corrupt("HuffYUV: the code length table is corrupt");
        while (repeat--) dst[i++] = uint8_t(val);
    }
}

void generate_bits_table(uint32_t *dst, const uint8_t *len, int n) {
    int lens[33] = {0};
    uint32_t codes[33];
    for (int i = 0; i < n; i++) lens[len[i]]++;
    codes[32] = 0;
    for (int i = 32; i > 0; i--) {
        if ((lens[i] + codes[i]) & 1) corrupt("HuffYUV: error generating the Huffman table");
        codes[i - 1] = (lens[i] + codes[i]) >> 1;
    }
    for (int i = 0; i < n; i++)
        if (len[i]) dst[i] = codes[len[i]]++;
}

inline uint8_t mid_pred(int a, int b, int c) {
    if (a > b) std::swap(a, b);
    if (b > c) b = c > a ? c : a;
    return uint8_t(b);
}

struct Decoder {
    int width = 0, height = 0, version = 0, predictor = 0, decorrelate = 0, bpp = 0;
    int interlaced = 0, context = 0, format = 0;
    uint8_t len[3][256];
    uint32_t bits[3][256];
    Vlc vlc[3];
    std::vector<uint8_t> buf;            // the packet, byte-swapped
    std::vector<uint8_t> plane[3];       // Y', Cb, Cr, or B, G, R, A interleaved in plane[0]
    std::vector<uint8_t> temp[3];
    bool have = false;
    std::string error;

    void build_vlcs() {
        for (int i = 0; i < 3; i++) vlc[i].build(len[i], bits[i], 256);
    }

    int read_huffman_tables(const uint8_t *src, size_t length) {
        Bits b;
        b.init(src, length);
        for (int i = 0; i < 3; i++) {
            read_len_table(len[i], b, 256);
            generate_bits_table(bits[i], len[i], 256);
        }
        build_vlcs();
        return int((b.pos + 7) / 8);
    }

    void read_old_huffman_tables() {
        Bits b;
        b.init(CLASSIC_SHIFT_LUMA, sizeof CLASSIC_SHIFT_LUMA);
        read_len_table(len[0], b, 256);
        b.init(CLASSIC_SHIFT_CHROMA, sizeof CLASSIC_SHIFT_CHROMA);
        read_len_table(len[1], b, 256);
        for (int i = 0; i < 256; i++) bits[0][i] = CLASSIC_ADD_LUMA[i];
        for (int i = 0; i < 256; i++) bits[1][i] = CLASSIC_ADD_CHROMA[i];
        if (bpp >= 24) {
            memcpy(bits[1], bits[0], sizeof bits[0]);
            memcpy(len[1], len[0], sizeof len[0]);
        }
        memcpy(bits[2], bits[1], sizeof bits[1]);
        memcpy(len[2], len[1], sizeof len[1]);
        build_vlcs();
    }

    void init(int w, int h, int bpc, const uint8_t *extra, int extra_size) {
        width = w, height = h;
        if (w <= 0 || h <= 0 || w > 16384 || h > 16384) corrupt("HuffYUV: a frame size out of range");
        interlaced = height > 288;
        if (extra_size) {
            if ((bpc & 7) && bpc != 12)
                version = 1;
            else if (extra_size > 3 && extra[3] == 0)
                version = 2;
            else
                version = 3;
        } else {
            version = 0;
        }
        if (version == 3)
            unsupported("ffvhuff version 3 (its planar formats, more than 8 bits, alpha)");
        if (version >= 2) {
            if (extra_size < 4) corrupt("HuffYUV: extradata of fewer than 4 bytes");
            int method = extra[0];
            decorrelate = method & 64 ? 1 : 0;
            predictor = method & 63;
            bpp = extra[1];
            if (bpp == 0) bpp = bpc & ~7;
            int interlace = (extra[2] & 0x30) >> 4;
            interlaced = interlace == 1 ? 1 : interlace == 2 ? 0 : interlaced;
            context = extra[2] & 0x40 ? 1 : 0;
            read_huffman_tables(extra + 4, size_t(extra_size - 4));
        } else {
            switch (bpc & 7) {
            case 1: predictor = LEFT, decorrelate = 0; break;
            case 2: predictor = LEFT, decorrelate = 1; break;
            case 3: predictor = PLANE, decorrelate = bpc >= 24; break;
            case 4: predictor = MEDIAN, decorrelate = 0; break;
            default: predictor = LEFT, decorrelate = 0; break;
            }
            bpp = bpc & ~7;
            context = 0;
            read_old_huffman_tables();
        }
        if (predictor > MEDIAN) corrupt("HuffYUV: predictor " + std::to_string(predictor));
        switch (bpp) {
        case 12: format = YUV420; break;
        case 16: format = YUV422; break;
        case 24: format = RGB24; break;
        case 32: format = RGB32; break;
        default: unsupported("HuffYUV at " + std::to_string(bpp) + " bits a pixel");
        }
        if (format <= YUV422 && (width & 1))
            corrupt("HuffYUV: width must be even for this colorspace");
        if (predictor == MEDIAN && format == YUV422 && (width & 3))
            corrupt("HuffYUV: width must be a multiple of 4 for 4:2:2 and the median predictor");
        if (format >= RGB24 && predictor == MEDIAN)
            unsupported("HuffYUV RGB with the median predictor (FFmpeg: prediction type not supported)");
        // 4 rows of margin under each plane, as FFmpeg's frames have: the
        // median predictor's second line and a short picture's interlaced
        // rows may land past the picture, never past the margin
        if (format <= YUV422) {
            int ch = format == YUV420 ? (height + 1) / 2 : height;
            plane[0].assign(size_t(width + 4) * (height + 4), 0);
            plane[1].assign(size_t(width / 2 + 4) * (ch + 4), 0);
            plane[2].assign(size_t(width / 2 + 4) * (ch + 4), 0);
        } else {
            plane[0].assign(size_t(width) * (height + 4) * 4, 0);
        }
        for (auto &t : temp) t.assign(size_t(width) * 4 + 16, 0);
    }

    // ── the bitstreams ──
    void decode_422_bitstream(Bits &b, int count) {
        count /= 2;
        for (int i = 0; i < count; i++) {
            temp[0][2 * i] = uint8_t(vlc[0].read(b));
            temp[1][i] = uint8_t(vlc[1].read(b));
            temp[0][2 * i + 1] = uint8_t(vlc[0].read(b));
            temp[2][i] = uint8_t(vlc[2].read(b));
        }
    }

    void decode_gray_bitstream(Bits &b, int count) {
        count /= 2;
        for (int i = 0; i < count; i++) {
            temp[0][2 * i] = uint8_t(vlc[0].read(b));
            temp[0][2 * i + 1] = uint8_t(vlc[0].read(b));
        }
    }

    void decode_bgr_bitstream(Bits &b, int count) {
        enum { B = 0, G = 1, R = 2, A = 3 };
        uint8_t *t = temp[0].data();
        for (int i = 0; i < count && b.left() > 0; i++) {
            if (decorrelate) {
                t[4 * i + G] = uint8_t(vlc[1].read(b));
                t[4 * i + B] = uint8_t(vlc[0].read(b) + t[4 * i + G]);
                t[4 * i + R] = uint8_t(vlc[2].read(b) + t[4 * i + G]);
            } else {
                t[4 * i + B] = uint8_t(vlc[0].read(b));
                t[4 * i + G] = uint8_t(vlc[1].read(b));
                t[4 * i + R] = uint8_t(vlc[2].read(b));
            }
            if (bpp == 32) t[4 * i + A] = uint8_t(vlc[2].read(b));
        }
    }

    // ── the predictors (lossless_videodsp) ──
    static int add_left_pred(uint8_t *dst, const uint8_t *src, int w, int acc) {
        for (int i = 0; i < w; i++) {
            acc += src[i];
            dst[i] = uint8_t(acc);
        }
        return acc & 0xFF;
    }

    static void add_bytes(uint8_t *dst, const uint8_t *src, int w) {
        for (int i = 0; i < w; i++) dst[i] = uint8_t(dst[i] + src[i]);
    }

    static void add_median_pred(uint8_t *dst, const uint8_t *top, const uint8_t *diff, int w,
                                int *left, int *left_top) {
        int l = *left & 0xFF, lt = *left_top & 0xFF;
        for (int i = 0; i < w; i++) {
            l = uint8_t(mid_pred(l, top[i], (l + top[i] - lt) & 0xFF) + diff[i]);
            lt = top[i];
            dst[i] = uint8_t(l);
        }
        *left = l, *left_top = lt;
    }

    void decode_yuv(Bits &b) {
        const int w = width, h = height, w2 = width >> 1;
        uint8_t *Y = plane[0].data(), *U = plane[1].data(), *V = plane[2].data();
        const int ys = w, cs = w2;
        const int fys = interlaced ? 2 * ys : ys, fcs = interlaced ? 2 * cs : cs;
        int lefty, leftu, leftv, lefttopy, lefttopu, lefttopv;
        leftv = V[0] = uint8_t(b.get(8));
        lefty = Y[1] = uint8_t(b.get(8));
        leftu = U[0] = uint8_t(b.get(8));
        Y[0] = uint8_t(b.get(8));
        const bool is420 = format == YUV420;
        if (predictor == LEFT || predictor == PLANE) {
            decode_422_bitstream(b, w - 2);
            lefty = add_left_pred(Y + 2, temp[0].data(), w - 2, lefty);
            leftu = add_left_pred(U + 1, temp[1].data(), w2 - 1, leftu);
            leftv = add_left_pred(V + 1, temp[2].data(), w2 - 1, leftv);
            for (int cy = 1, y = 1; y < h; y++, cy++) {
                if (is420) {
                    decode_gray_bitstream(b, w);
                    uint8_t *yd = Y + size_t(ys) * y;
                    lefty = add_left_pred(yd, temp[0].data(), w, lefty);
                    if (predictor == PLANE && y > interlaced) add_bytes(yd, yd - fys, w);
                    y++;
                    if (y >= h) break;
                }
                uint8_t *yd = Y + size_t(ys) * y, *ud = U + size_t(cs) * cy, *vd = V + size_t(cs) * cy;
                decode_422_bitstream(b, w);
                lefty = add_left_pred(yd, temp[0].data(), w, lefty);
                leftu = add_left_pred(ud, temp[1].data(), w2, leftu);
                leftv = add_left_pred(vd, temp[2].data(), w2, leftv);
                if (predictor == PLANE && cy > interlaced) {
                    add_bytes(yd, yd - fys, w);
                    add_bytes(ud, ud - fcs, w2);
                    add_bytes(vd, vd - fcs, w2);
                }
            }
            return;
        }
        // MEDIAN: the first line but its first 2 pixels left predicted
        decode_422_bitstream(b, w - 2);
        lefty = add_left_pred(Y + 2, temp[0].data(), w - 2, lefty);
        leftu = add_left_pred(U + 1, temp[1].data(), w2 - 1, leftu);
        leftv = add_left_pred(V + 1, temp[2].data(), w2 - 1, leftv);
        int y = 1, cy = 1;
        if (y >= h) return;
        if (interlaced) {  // the second line left predicted too
            decode_422_bitstream(b, w);
            lefty = add_left_pred(Y + ys, temp[0].data(), w, lefty);
            leftu = add_left_pred(U + cs, temp[1].data(), w2, leftu);
            leftv = add_left_pred(V + cs, temp[2].data(), w2, leftv);
            y++, cy++;
            if (y >= h) return;
        }
        // the next 4 pixels left predicted
        decode_422_bitstream(b, 4);
        lefty = add_left_pred(Y + fys, temp[0].data(), 4, lefty);
        leftu = add_left_pred(U + fcs, temp[1].data(), 2, leftu);
        leftv = add_left_pred(V + fcs, temp[2].data(), 2, leftv);
        // the rest of that line median predicted
        lefttopy = Y[3];
        decode_422_bitstream(b, w - 4);
        add_median_pred(Y + fys + 4, Y + 4, temp[0].data(), w - 4, &lefty, &lefttopy);
        lefttopu = U[1];
        lefttopv = V[1];
        add_median_pred(U + fcs + 2, U + 2, temp[1].data(), w2 - 2, &leftu, &lefttopu);
        add_median_pred(V + fcs + 2, V + 2, temp[2].data(), w2 - 2, &leftv, &lefttopv);
        y++, cy++;
        for (; y < h; y++, cy++) {
            if (is420) {
                while (2 * cy > y) {
                    decode_gray_bitstream(b, w);
                    uint8_t *yd = Y + size_t(ys) * y;
                    add_median_pred(yd, yd - fys, temp[0].data(), w, &lefty, &lefttopy);
                    y++;
                }
                if (y >= h) break;
            }
            decode_422_bitstream(b, w);
            uint8_t *yd = Y + size_t(ys) * y, *ud = U + size_t(cs) * cy, *vd = V + size_t(cs) * cy;
            add_median_pred(yd, yd - fys, temp[0].data(), w, &lefty, &lefttopy);
            add_median_pred(ud, ud - fcs, temp[1].data(), w2, &leftu, &lefttopu);
            add_median_pred(vd, vd - fcs, temp[2].data(), w2, &leftv, &lefttopv);
        }
    }

    void decode_rgb(Bits &b) {
        enum { B = 0, G = 1, R = 2, A = 3 };
        const int w = width, h = height, stride = 4 * w;
        const int fstride = interlaced ? 2 * stride : stride;
        uint8_t *d = plane[0].data();
        const size_t last = size_t(h - 1) * stride;
        uint8_t left[4];
        if (bpp == 32) {
            left[A] = d[last + A] = uint8_t(b.get(8));
            left[R] = d[last + R] = uint8_t(b.get(8));
            left[G] = d[last + G] = uint8_t(b.get(8));
            left[B] = d[last + B] = uint8_t(b.get(8));
        } else {
            left[R] = d[last + R] = uint8_t(b.get(8));
            left[G] = d[last + G] = uint8_t(b.get(8));
            left[B] = d[last + B] = uint8_t(b.get(8));
            left[A] = d[last + A] = 255;
            b.get(8);
        }
        auto add_left_bgr32 = [&](uint8_t *dst, const uint8_t *src, int n) {
            for (int i = 0; i < n; i++)
                for (int c = 0; c < 4; c++) dst[4 * i + c] = left[c] = uint8_t(left[c] + src[4 * i + c]);
        };
        decode_bgr_bitstream(b, w - 1);
        add_left_bgr32(d + last + 4, temp[0].data(), w - 1);
        for (int y = h - 2; y >= 0; y--) {  // stored upside down
            decode_bgr_bitstream(b, w);
            uint8_t *row = d + size_t(y) * stride;
            add_left_bgr32(row, temp[0].data(), w);
            if (predictor == PLANE) {
                if (bpp != 32) left[A] = 0;
                if (y < h - 1 - interlaced) add_bytes(row, row + fstride, 4 * w);
            }
        }
    }

    void decode(const uint8_t *data, size_t size) {
        have = false;
        buf.assign(size + 8, 0);
        size_t words = size / 4;
        for (size_t k = 0; k < words; k++) {
            buf[4 * k] = data[4 * k + 3];
            buf[4 * k + 1] = data[4 * k + 2];
            buf[4 * k + 2] = data[4 * k + 1];
            buf[4 * k + 3] = data[4 * k];
        }
        size_t table = 0;
        if (context) table = size_t(read_huffman_tables(buf.data(), size));
        if (table > size) corrupt("HuffYUV: the packet's tables run past it");
        Bits b;
        b.init(buf.data() + table, size - table);
        if (format <= YUV422)
            decode_yuv(b);
        else
            decode_rgb(b);
        have = true;
    }
};

template <class F>
int guarded(Decoder *d, F f) {
    try {
        f();
        return 0;
    } catch (const Fail &e) {
        d->error = e.msg;
        return e.code;
    } catch (const std::exception &e) {
        d->error = std::string("HuffYUV: ") + e.what();
        return -1;
    }
}

}  // namespace

extern "C" {

void *hyd_new() { return new (std::nothrow) Decoder(); }

void hyd_free(void *h) { delete static_cast<Decoder *>(h); }

const char *hyd_error(void *h) { return static_cast<Decoder *>(h)->error.c_str(); }

int hyd_init(void *h, int width, int height, int bits, const uint8_t *extra, int size) {
    Decoder *d = static_cast<Decoder *>(h);
    return guarded(d, [&] { d->init(width, height, bits, extra, size); });
}

// format, predictor, decorrelate, interlaced, context, version
void hyd_info(void *h, int32_t *out) {
    Decoder *d = static_cast<Decoder *>(h);
    out[0] = d->format, out[1] = d->predictor, out[2] = d->decorrelate;
    out[3] = d->interlaced, out[4] = d->context, out[5] = d->version;
}

int hyd_decode(void *h, const uint8_t *data, int64_t size) {
    Decoder *d = static_cast<Decoder *>(h);
    return guarded(d, [&] { d->decode(data, size_t(size)); });
}

// Y', Cb, Cr (chroma width / 2, height / 2 rounded up for 4:2:0), or R, G, B
int hyd_take(void *h, uint8_t *p0, uint8_t *p1, uint8_t *p2) {
    Decoder *d = static_cast<Decoder *>(h);
    if (!d->have) return -1;
    if (d->format <= YUV422) {
        const int w = d->width, w2 = w / 2;
        const int ch = d->format == YUV420 ? (d->height + 1) / 2 : d->height;
        memcpy(p0, d->plane[0].data(), size_t(w) * d->height);
        memcpy(p1, d->plane[1].data(), size_t(w2) * ch);
        memcpy(p2, d->plane[2].data(), size_t(w2) * ch);
        return 0;
    }
    const uint8_t *s = d->plane[0].data();
    size_t n = size_t(d->width) * d->height;
    for (size_t i = 0; i < n; i++) p0[i] = s[4 * i + 2], p1[i] = s[4 * i + 1], p2[i] = s[4 * i];
    return 0;
}

}  // extern "C"
