// The 3D table by which FFmpeg 8's swscale (the conversion under cv2) maps a
// colour-managed stream's R'G'B' to the output's R'G'B', built as swscale
// builds its static table for the relative colorimetric intent (its default):
// each of size^3 nodes on the source's R'G'B' in [0, 1] is linearised by the
// source's EOTF (cd/m^2), taken to IPT (LMS by the Hunt-Pointer-Estevez
// matrix with 4% crosstalk, after CAT16 takes a white other than D65 to D65;
// PQ-encoded), its black moved to the destination's, clipped into the
// destination's gamut along an exponential curve towards the hue's most
// saturated colour, taken back to the destination's R'G'B' by its inverse
// EOTF and rounded to 16 bits.
//
// The arithmetic is single precision as swscale's, and the PQ EOTF is read
// from a 1025-entry table with linear interpolation as swscale's is: the nodes
// on the gamut's edge depend on those roundings, so they are followed step by
// step.  The EOTFs themselves are libavutil's (double precision).
//
// C API (ctypes, omfs4d_torch/io/colour.py):
//   int colour_lut(int size, int src_trc, double src_Lw, double src_Lb,
//                  const double *src_xy, int dst_trc, double dst_Lw,
//                  double dst_Lb, const double *dst_xy, int threads,
//                  uint16_t *out)
// xy: the primaries and white point (rx ry gx gy bx by wx wy).  out holds
// size^3 x 3 values, blue slowest, red fastest.  Returns 0, or -1 for a
// transfer that has no EOTF.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct M3 { float m[3][3]; };
struct IPT { float I, P, T; };
struct ICh { float I, C, h; };
struct RGB { float R, G, B; };

constexpr float PQ_M1 = 0.1593017578125f, PQ_M2 = 78.84375f, PQ_C1 = 0.8359375f,
                PQ_C2 = 18.8515625f, PQ_C3 = 18.6875f;
constexpr int PQ_LUT_SIZE = 1024;
float pq_table[PQ_LUT_SIZE + 1];

void pq_table_init() {
    for (int i = 0; i <= PQ_LUT_SIZE; i++) {
        double x = std::pow(i / double(PQ_LUT_SIZE - 1), 1.0 / PQ_M2);
        x = std::fmax(x - PQ_C1, 0.0) / (PQ_C2 - PQ_C3 * x);
        pq_table[i] = float(std::pow(x, 1.0 / PQ_M1) * 10000.0);
    }
}

inline float pq_eotf(float x) {
    const float idxf = std::fmin(std::fmax(x, 0.0f), 1.0f) * (PQ_LUT_SIZE - 1);
    const int ipart = int(std::floor(idxf));
    const float fpart = idxf - ipart;
    return pq_table[ipart] + (pq_table[ipart + 1] - pq_table[ipart]) * fpart;
}

inline float pq_oetf(float x) {
    x = std::pow(std::fmax(x * 1e-4f, 0.0f), PQ_M1);
    x = (PQ_C1 + PQ_C2 * x) / (1.0f + PQ_C3 * x);
    return std::pow(x, PQ_M2);
}

M3 mul(const M3 &a, const M3 &b) {
    M3 r;
    for (int i = 0; i < 3; i++)
        for (int j = 0; j < 3; j++)
            r.m[i][j] = a.m[i][0] * b.m[0][j] + a.m[i][1] * b.m[1][j] + a.m[i][2] * b.m[2][j];
    return r;
}

M3 invert(const M3 &mat) {
    const double m00 = mat.m[0][0], m01 = mat.m[0][1], m02 = mat.m[0][2],
                 m10 = mat.m[1][0], m11 = mat.m[1][1], m12 = mat.m[1][2],
                 m20 = mat.m[2][0], m21 = mat.m[2][1], m22 = mat.m[2][2];
    const double a00 = (m11 * m22 - m21 * m12), a01 = -(m01 * m22 - m21 * m02),
                 a02 = (m01 * m12 - m11 * m02), a10 = -(m10 * m22 - m20 * m12),
                 a11 = (m00 * m22 - m20 * m02), a12 = -(m00 * m12 - m10 * m02),
                 a20 = (m10 * m21 - m20 * m11), a21 = -(m00 * m21 - m20 * m01),
                 a22 = (m00 * m11 - m10 * m01);
    const double det = 1.0 / (m00 * a00 + m10 * a01 + m20 * a02);
    return M3{{{float(det * a00), float(det * a01), float(det * a02)},
               {float(det * a10), float(det * a11), float(det * a12)},
               {float(det * a20), float(det * a21), float(det * a22)}}};
}

M3 rgb2xyz(const double *xy) {
    float X[4], Z[4], S[3];
    for (int i = 0; i < 4; i++) {
        X[i] = float(xy[2 * i] / xy[2 * i + 1]);
        Z[i] = float((1 - xy[2 * i] - xy[2 * i + 1]) / xy[2 * i + 1]);
    }
    M3 p;
    for (int i = 0; i < 3; i++) {
        p.m[0][i] = X[i];
        p.m[1][i] = 1;
        p.m[2][i] = Z[i];
    }
    const M3 inv = invert(p);
    for (int i = 0; i < 3; i++)
        S[i] = inv.m[i][0] * X[3] + inv.m[i][1] * 1 + inv.m[i][2] * Z[3];
    M3 out;
    for (int i = 0; i < 3; i++) {
        out.m[0][i] = S[i] * X[i];
        out.m[1][i] = S[i];
        out.m[2][i] = S[i] * Z[i];
    }
    return out;
}

// CAT16 adaptation from the white point (wx, wy) to D65, applied in XYZ
M3 adaptation_to_d65(double wx, double wy) {
    const double d65x = 0.3127, d65y = 0.3290;
    const M3 cat16{{{0.401288f, 0.650173f, -0.051461f},
                    {-0.250268f, 1.204414f, 0.045854f},
                    {-0.002079f, 0.048952f, 0.953127f}}};
    const float src[3] = {float(wx / wy), 1.0f, float((1 - wx - wy) / wy)};
    const float dst[3] = {float(d65x / d65y), 1.0f, float((1 - d65x - d65y) / d65y)};
    M3 ratio{{{0, 0, 0}, {0, 0, 0}, {0, 0, 0}}};
    for (int i = 0; i < 3; i++) {
        const float cs = cat16.m[i][0] * src[0] + cat16.m[i][1] * src[1] + cat16.m[i][2] * src[2];
        const float cd = cat16.m[i][0] * dst[0] + cat16.m[i][1] * dst[1] + cat16.m[i][2] * dst[2];
        ratio.m[i][i] = cd / cs;
    }
    return mul(invert(cat16), mul(ratio, cat16));
}

M3 rgb2lms(const double *xy) {
    const float c = 0.04f;
    const M3 crosstalk{{{1 - 2 * c, c, c}, {c, 1 - 2 * c, c}, {c, c, 1 - 2 * c}}};
    const M3 hpe{{{0.40024f, 0.70760f, -0.08081f},
                  {-0.22630f, 1.16532f, 0.04570f},
                  {0.00000f, 0.00000f, 0.91822f}}};
    const M3 lms = mul(crosstalk, hpe);
    if (std::fabs(xy[6] - 0.3127) < 1e-6 && std::fabs(xy[7] - 0.3290) < 1e-6)
        return mul(lms, rgb2xyz(xy));
    return mul(mul(lms, adaptation_to_d65(xy[6], xy[7])), rgb2xyz(xy));
}

struct Gamut {
    M3 enc2lms, lms2enc;
    float Imin, Imax, Lb, Lw;
    ICh peak;
};

inline RGB apply(const M3 &m, float a, float b, float c) {
    return RGB{m.m[0][0] * a + m.m[0][1] * b + m.m[0][2] * c,
               m.m[1][0] * a + m.m[1][1] * b + m.m[1][2] * c,
               m.m[2][0] * a + m.m[2][1] * b + m.m[2][2] * c};
}

IPT rgb2ipt(RGB c, const M3 &m) {
    const RGB lms = apply(m, c.R, c.G, c.B);
    const float Lp = pq_oetf(lms.R), Mp = pq_oetf(lms.G), Sp = pq_oetf(lms.B);
    return IPT{0.4000f * Lp + 0.4000f * Mp + 0.2000f * Sp,
               4.4550f * Lp - 4.8510f * Mp + 0.3960f * Sp,
               0.8056f * Lp + 0.3572f * Mp - 1.1628f * Sp};
}

RGB ipt2rgb(IPT c, const M3 &m) {
    const float Lp = c.I + 0.0975689f * c.P + 0.205226f * c.T;
    const float Mp = c.I - 0.1138760f * c.P + 0.133217f * c.T;
    const float Sp = c.I + 0.0326151f * c.P - 0.676887f * c.T;
    return apply(m, pq_eotf(Lp), pq_eotf(Mp), pq_eotf(Sp));
}

inline ICh ipt2ich(IPT c) { return ICh{c.I, std::sqrt(c.P * c.P + c.T * c.T), std::atan2(c.T, c.P)}; }
inline IPT ich2ipt(ICh c) { return IPT{c.I, c.C * std::cos(c.h), c.C * std::sin(c.h)}; }

bool ingamut(IPT c, const Gamut &g) {
    const float min_rgb = g.Lb - 1e-4f, max_rgb = g.Lw + 1e-2f;
    const float Lp = c.I + 0.0975689f * c.P + 0.205226f * c.T;
    const float Mp = c.I - 0.1138760f * c.P + 0.133217f * c.T;
    const float Sp = c.I + 0.0326151f * c.P - 0.676887f * c.T;
    if (Lp < g.Imin || Lp > g.Imax || Mp < g.Imin || Mp > g.Imax || Sp < g.Imin || Sp > g.Imax)
        return false;
    const RGB rgb = apply(g.lms2enc, pq_eotf(Lp), pq_eotf(Mp), pq_eotf(Sp));
    return rgb.R >= min_rgb && rgb.R <= max_rgb && rgb.G >= min_rgb && rgb.G <= max_rgb &&
           rgb.B >= min_rgb && rgb.B <= max_rgb;
}

constexpr float maxDelta = 5e-5f;

ICh desat_bounded(float I, float h, float Cmin, float Cmax, const Gamut &g) {
    if (I <= g.Imin) return ICh{g.Imin, 0, h};
    if (I >= g.Imax) return ICh{g.Imax, 0, h};
    const float maxDI = I * maxDelta;
    ICh res{I, (Cmin + Cmax) / 2, h};
    do {
        if (ingamut(ich2ipt(res), g)) Cmin = res.C; else Cmax = res.C;
        res.C = (Cmin + Cmax) / 2;
    } while (Cmax - Cmin > maxDI);
    return res;
}

// the most saturated colour of a hue inside the gamut (golden-section search
// over I of the largest C there)
ICh saturate(float hue, const Gamut &g) {
    const float invphi = 0.6180339887498948f, invphi2 = 0.38196601125010515f;
    ICh lo{g.Imin, 0, hue}, hi{g.Imax, 0, hue};
    float de = hi.I - lo.I;
    ICh a = desat_bounded(lo.I + invphi2 * de, hue, 0.0f, 0.5f, g);
    ICh b = desat_bounded(lo.I + invphi * de, hue, 0.0f, 0.5f, g);
    while (de > maxDelta) {
        de *= invphi;
        if (a.C > b.C) {
            hi = b;
            b = a;
            a = desat_bounded(lo.I + invphi2 * de, hue, lo.C - maxDelta, 0.5f, g);
        } else {
            lo = a;
            a = b;
            b = desat_bounded(lo.I + invphi * de, hue, hi.C - maxDelta, 0.5f, g);
        }
    }
    return a.C > b.C ? a : b;
}

inline ICh mix_exp(ICh c, float x, float gamma, float base) {
    return ICh{base + (c.I - base) * std::pow(x, gamma), c.C * x, c.h};
}

// clip along the curve that mix_exp follows towards the hue's peak
IPT clip_gamma(IPT ipt, float gamma, Gamut &g) {
    float lo = 0.0f, hi = 1.0f, x = 0.5f;
    const float maxDI = std::fmax(ipt.I * maxDelta, 1e-7f);
    if (ipt.I <= g.Imin) return IPT{g.Imin, 0, 0};
    if (ingamut(ipt, g)) return ipt;
    const ICh ich = ipt2ich(ipt);
    g.peak = saturate(ich.h, g);
    const float Irel = std::fmax((ich.I - g.Imin) / (g.peak.I - g.Imin), 0.0f);
    gamma = gamma * std::pow(Irel, 3.0f) * std::fmin(ich.C / g.peak.C, 1.0f);
    do {
        const ICh test = mix_exp(ich, x, gamma, g.peak.I);
        if (ingamut(ich2ipt(test), g)) lo = x; else hi = x;
        x = (lo + hi) / 2.0f;
    } while (hi - lo > maxDI);
    return ich2ipt(mix_exp(ich, x, gamma, g.peak.I));
}

inline float hull(float I) { return ((I - 6.0f) * I + 9.0f) * I; }

// I moved linearly; chroma kept from rising with it, and lowered where the
// gamut's volume shrinks
IPT tone_map(IPT ipt, float I_scale, float I_offset) {
    const float I = I_scale * ipt.I + I_offset;
    const float desat = std::fmin(ipt.I / I, hull(I) / hull(ipt.I));
    return IPT{I, ipt.P * desat, ipt.T * desat};
}

// ── libavutil's EOTFs (av_csp_itu_eotf), cd/m^2 ──

double srgb_inv(double E) { return E <= 0.04045 ? E / 12.92 : std::pow((E + 0.055) / 1.055, 2.4); }
double srgb(double L) { return L <= 0.0031308 ? 12.92 * L : 1.055 * std::pow(L, 1.0 / 2.4) - 0.055; }

double b67_inv(double E) {
    const double a = 0.17883277, b = 0.28466892, c = 0.55991073;
    return E <= 0.5 ? E * E / 3.0 : (std::exp((E - c) / a) + b) / 12.0;
}

// SMPTE ST 428-1 (DCDM X'Y'Z'): each channel scaled by the white's X/Y, 1, Z/Y
const double ST428_WHITE[3] = {0.314 / 0.351, 1.0, (1 - 0.314 - 0.351) / 0.351};

bool eotf(int trc, double Lw, double Lb, double E[3]) {
    switch (trc) {
    case 1: case 6: case 7: case 11: case 12: case 14: case 15: {          // BT.1886
        const double Lw_inv = std::pow(Lw, 1.0 / 2.4), Lb_inv = std::pow(Lb, 1.0 / 2.4);
        const double a = std::pow(Lw_inv - Lb_inv, 2.4), b = Lb_inv / (Lw_inv - Lb_inv);
        for (int i = 0; i < 3; i++) E[i] = (-b > E[i]) ? 0.0 : a * std::pow(E[i] + b, 2.4);
        return true;
    }
    case 4: case 5: case 8: case 13:
        for (int i = 0; i < 3; i++) {
            const double v = trc == 4 ? (E[i] < 0 ? 0.0 : std::pow(E[i], 2.2))
                           : trc == 5 ? (E[i] < 0 ? 0.0 : std::pow(E[i], 2.8))
                           : trc == 8 ? E[i] : srgb_inv(E[i]);
            E[i] = (Lw - Lb) * v + Lb;
        }
        return true;
    case 16:
        for (int i = 0; i < 3; i++) {
            double x = std::pow(std::fmax(E[i], 0.0), 1.0 / PQ_M2);
            x = std::fmax(x - PQ_C1, 0.0) / (PQ_C2 - PQ_C3 * x);
            E[i] = std::pow(x, 1.0 / PQ_M1) * 10000.0;
        }
        return true;
    case 17:
        for (int i = 0; i < 3; i++)
            E[i] = ST428_WHITE[i] * ((Lw - Lb) * (E[i] < 0 ? 0.0 : std::pow(E[i], 2.6)) * 52.37 / 48.0 + Lb);
        return true;
    case 18: {
        const double gamma = std::fmax(1.2 + 0.42 * std::log10(Lw / 1000.0), 1.0);
        const double beta = std::sqrt(3 * std::pow(Lb / Lw, 1 / gamma));
        for (int i = 0; i < 3; i++) E[i] = b67_inv((1 - beta) * E[i] + beta);
        const double luma = 0.2627 * E[0] + 0.6780 * E[1] + 0.0593 * E[2];
        const double gain = Lw * std::pow(luma, gamma - 1);
        for (int i = 0; i < 3; i++) E[i] *= gain;
        return true;
    }
    default:
        return false;
    }
}

bool eotf_inv(int trc, double Lw, double Lb, double L[3]) {
    switch (trc) {
    case 1: case 6: case 7: case 11: case 12: case 14: case 15: {
        const double Lw_inv = std::pow(Lw, 1.0 / 2.4), Lb_inv = std::pow(Lb, 1.0 / 2.4);
        const double a = std::pow(Lw_inv - Lb_inv, 2.4), b = Lb_inv / (Lw_inv - Lb_inv);
        for (int i = 0; i < 3; i++) L[i] = (L[i] > 0) ? std::pow(L[i] / a, 1.0 / 2.4) - b : -b;
        return true;
    }
    case 4: case 5: case 8: case 13:
        for (int i = 0; i < 3; i++) {
            const double v = (L[i] - Lb) / (Lw - Lb);
            L[i] = trc == 4 ? (v < 0 ? 0.0 : std::pow(v, 1 / 2.2))
                 : trc == 5 ? (v < 0 ? 0.0 : std::pow(v, 1 / 2.8))
                 : trc == 8 ? v : (v < 0 ? 0.0 : srgb(v));
        }
        return true;
    case 17:
        for (int i = 0; i < 3; i++) {
            const double v = (L[i] / ST428_WHITE[i] - Lb) / (Lw - Lb) * 48.0 / 52.37;
            L[i] = v < 0 ? 0.0 : std::pow(v, 1 / 2.6);
        }
        return true;
    default:
        return false;
    }
}

inline uint16_t round16(double x) {
    x = x * 65535.0 + 0.5;
    return x < 0 ? 0 : x > 65535 ? 65535 : uint16_t(x);
}

}  // namespace

extern "C" int colour_lut(int size, int src_trc, double src_Lw, double src_Lb,
                          const double *src_xy, int dst_trc, double dst_Lw, double dst_Lb,
                          const double *dst_xy, int threads, uint16_t *out) {
    double probe[3] = {0.5, 0.5, 0.5};
    if (!eotf(src_trc, src_Lw, src_Lb, probe) || !eotf_inv(dst_trc, dst_Lw, dst_Lb, probe))
        return -1;
    static const bool table_ready = (pq_table_init(), true);
    (void)table_ready;
    const M3 src_enc2lms = rgb2lms(src_xy);
    Gamut dst;
    dst.enc2lms = rgb2lms(dst_xy);
    dst.lms2enc = invert(dst.enc2lms);
    dst.Lw = float(dst_Lw);
    dst.Lb = float(dst_Lb);
    dst.Imin = pq_oetf(dst.Lb);
    dst.Imax = pq_oetf(dst.Lw);
    const float sLw = float(src_Lw), sLb = float(src_Lb);
    // black point compensation of the relative intent: the source's black to
    // the destination's, the source's white kept
    const float src_min = pq_oetf(sLb), src_max = pq_oetf(sLw);
    const float I_scale = (src_max - dst.Imin) / (src_max - src_min);
    const float I_offset = dst.Imin - src_min * I_scale;
    const float invlut = 1.0f / (size - 1);
    auto slice = [&](int b0, int b1) {
        Gamut g = dst;
        for (int Bx = b0; Bx < b1; Bx++) {
            const float B = Bx * invlut;
            uint16_t *o = out + size_t(Bx) * size * size * 3;
            for (int Gx = 0; Gx < size; Gx++) {
                const float G = Gx * invlut;
                for (int Rx = 0; Rx < size; Rx++) {
                    double c[3] = {Rx * invlut, G, B};
                    eotf(src_trc, sLw, sLb, c);
                    IPT ipt = rgb2ipt(RGB{float(c[0]), float(c[1]), float(c[2])}, src_enc2lms);
                    ipt = tone_map(ipt, I_scale, I_offset);
                    ipt = clip_gamma(ipt, 1.80f, g);
                    const RGB rgb = ipt2rgb(ipt, g.lms2enc);
                    c[0] = rgb.R;
                    c[1] = rgb.G;
                    c[2] = rgb.B;
                    eotf_inv(dst_trc, g.Lw, g.Lb, c);
                    *o++ = round16(c[0]);
                    *o++ = round16(c[1]);
                    *o++ = round16(c[2]);
                }
            }
        }
    };
    threads = std::max(1, std::min(threads, size));
    std::vector<std::thread> pool;
    const int step = (size + threads - 1) / threads;
    for (int b = 0; b < size; b += step)
        pool.emplace_back(slice, b, std::min(size, b + step));
    for (auto &t : pool) t.join();
    return 0;
}
