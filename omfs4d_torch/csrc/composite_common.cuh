// What the composite kernels K1 (composite_fwd.cu), K2 (composite_bwd.cu) and
// V (composite_variants.cu) evaluate alike: one (pixel, list entry) alpha and
// the running front-to-back step; the box outside which an entry's alpha is
// 0, by which each warp lists the entries it walks; and, for K2 and V, the
// multi-value exchanges that sum a warp's per-pixel terms.
//
// Every operation is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn /
// __fmaf_rn), in one fixed order, so nvcc cannot contract them into other
// FMAs.  Then K1 and K2 compute the same bits: the colour C_tot and the final
// transmittance T_tot that K1 saves are exactly what K2's running step
// reaches at a pixel's last entry, so K2's suffix dcol . (C_tot - C_<=k) ends
// at exactly 0 there.  The alpha evaluation also takes the reference's order
// of roundings, -0.5 ((A dx) dx + (C dy) dy) - (B dx) dy, which is the order
// the plain PyTorch version rounds in on the card: V's bf16 modes rely on
// that to round the plain version's bits.

#pragma once

#include <cuda_runtime.h>

namespace omfs4d {

constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kAlphaCap = 0.99f;
constexpr int kRows = 9;  // ux, uy, conic a/b/c, r, g, b, opacity
constexpr unsigned kFull = 0xffffffffu;

struct Alpha {
  float dx, dy;   // pixel centre minus the entry's mean
  float e;        // exp(power)
  float a_full;   // o * e
  float a;        // a_full capped at 0.99, 0 below 1/255
  bool capped, cut;
};

// power = min(-0.5 ((A dx) dx + (C dy) dy) - (B dx) dy, 0), then
// a_full = o exp(power), a = min(a_full, 0.99) and 0 below 1/255.  fminf
// returns 0 for a NaN power; with kNanPower the NaN stays, as in
// torch.clamp_max (V takes that: its plain version keeps the NaN).  For any
// other power the two give the same bits.
template <bool kNanPower = false>
__device__ __forceinline__ Alpha alpha_of(float x, float y, float ux, float uy, float ca,
                                          float cb, float cc, float o) {
  Alpha r;
  r.dx = __fsub_rn(x, ux);
  r.dy = __fsub_rn(y, uy);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, r.dx), r.dx),
                               __fmul_rn(__fmul_rn(cc, r.dy), r.dy));
  const float raw = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, r.dx), r.dy));
  const float power = kNanPower ? (raw > 0.0f ? 0.0f : raw) : fminf(raw, 0.0f);
  r.e = expf(power);
  r.a_full = __fmul_rn(o, r.e);
  r.capped = r.a_full > kAlphaCap;
  const float a = r.capped ? kAlphaCap : r.a_full;
  r.cut = a < kAlphaCutoff;
  r.a = r.cut ? 0.0f : a;
  return r;
}

// A box that holds every pixel centre where the entry can reach a >= 1/255:
// (x0, x1, y0, y1).  a >= 1/255 needs q = (dx, dy) M (dx, dy)^T <= L with
// M = [[A, B], [B, C]] and L = 2 ln(255 o); that ellipse spans
// |dx| <= sqrt(L C / det M), |dy| <= sqrt(L A / det M).  The box takes L 2%
// larger and one pixel more on each side, far beyond f32 rounding of the
// alpha, so a pixel outside it computes a = 0 in alpha_of.  An entry with
// o below 1/255 reaches no pixel (an empty box).  An entry reaches any pixel
// when its M is not well inside the positive definite (det M <= 1e-3 A C:
// power clamps to 0 along a direction, or the bound would rest on a
// cancelling det), and when any of its inputs is not finite: K1's step then
// turns a = 0 into NaN (0 * Inf) at every pixel, as the plain version does.
__device__ __forceinline__ float4 reach_of(float ux, float uy, float ca, float cb, float cc,
                                           float o, float r, float g, float b) {
  const float inf = __int_as_float(0x7f800000);
  const float4 all = make_float4(-inf, inf, -inf, inf);
  // a sum overflows to Inf only where the box would not matter
  if (!isfinite(ux + uy + ca + cb + cc + o + r + g + b)) return all;
  if (o < kAlphaCutoff) return make_float4(inf, -inf, inf, -inf);
  const float det = ca * cc - cb * cb;
  if (!(ca > 0.0f && cc > 0.0f && det > 1e-3f * ca * cc)) return all;
  const float level = 2.04f * logf(255.0f * o) + 1e-3f;
  const float rx = sqrtf(level * cc / det) + 1.0f;
  const float ry = sqrtf(level * ca / det) + 1.0f;
  return make_float4(ux - rx, ux + rx, uy - ry, uy + ry);
}

// Whether the reach box r (reach_of) meets the box w of a warp's pixel
// centres; true when either holds a NaN.
__device__ __forceinline__ bool meets(const float4& r, const float4& w) {
  return !(r.y < w.x || r.x > w.y || r.w < w.z || r.z > w.w);
}

// The box (x0, x1, y0, y1) of the pixel centres of a warp's lanes.
__device__ __forceinline__ float4 warp_box(float x_lo, float x_hi, float y_lo, float y_hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x_lo = fminf(x_lo, __shfl_xor_sync(kFull, x_lo, off));
    x_hi = fmaxf(x_hi, __shfl_xor_sync(kFull, x_hi, off));
    y_lo = fminf(y_lo, __shfl_xor_sync(kFull, y_lo, off));
    y_hi = fmaxf(y_hi, __shfl_xor_sync(kFull, y_hi, off));
  }
  return make_float4(x_lo, x_hi, y_lo, y_hi);
}

// Writes to `list` the indices j < n, in order, of the staged entries whose
// reach box meets the box `w` of the warp's pixel centres, and returns how
// many (the same on every lane).  The lanes test 32 entries at a time.
__device__ __forceinline__ int reaching(const float4* __restrict__ reach, int n,
                                        const float4& w, int lane,
                                        unsigned short* __restrict__ list) {
  int m = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const bool hit = j < n && meets(reach[j], w);
    const unsigned mask = __ballot_sync(kFull, hit);
    if (hit) list[m + __popc(mask & ((1u << lane) - 1u))] = static_cast<unsigned short>(j);
    m += __popc(mask);
  }
  __syncwarp();
  return m;
}

// Sums v[0..7] over the warp's 32 lanes.  At each of the first three
// __shfl_xor_sync steps (16, 8, 4) a lane sends the half of its remaining
// values that its partner keeps and adds the half it receives: 8 values
// take 4 + 2 + 1 shuffles to 1 per lane, then 2 more (xor 2, 1) finish the
// sum.  Lane l ends with the sum of value (l >> 2) & 7.  Every sum is the
// tree ((x_l + x_{l^16}) + (x_{l^8} + ...)) of the butterfly, the same on
// every lane.
__device__ __forceinline__ float warp_sum8(const float* v, int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
  float s4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = hi16 ? v[i] : v[i + 4];
    const float keep = hi16 ? v[i + 4] : v[i];
    s4[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  float s2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = hi8 ? s4[i] : s4[i + 2];
    const float keep = hi8 ? s4[i + 2] : s4[i];
    s2[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  float s = (hi4 ? s2[1] : s2[0]) + __shfl_xor_sync(kFull, hi4 ? s2[0] : s2[1], 4);
  s += __shfl_xor_sync(kFull, s, 2);
  s += __shfl_xor_sync(kFull, s, 1);
  return s;
}

// The same for 4 values: 2 + 1 shuffles (xor 16, 8) to 1 per lane, then xor
// 4, 2, 1.  Lane l ends with the sum of value (l >> 3) & 3.
__device__ __forceinline__ float warp_sum4(const float* v, int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8;
  float s2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = hi16 ? v[i] : v[i + 2];
    const float keep = hi16 ? v[i + 2] : v[i];
    s2[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  float s = (hi8 ? s2[1] : s2[0]) + __shfl_xor_sync(kFull, hi8 ? s2[0] : s2[1], 8);
  s += __shfl_xor_sync(kFull, s, 4);
  s += __shfl_xor_sync(kFull, s, 2);
  s += __shfl_xor_sync(kFull, s, 1);
  return s;
}

// Sums v[0..8]: the first 8 by warp_sum8 (`mine`, on lane l the sum of
// value (l >> 2) & 7); value 8 takes a plain xor butterfly of 5 shuffles and
// ends on every lane (`last`).  14 shuffles where 9 shuffle trees take 45.
__device__ __forceinline__ void warp_sum9(const float (&v)[kRows], int lane, float& mine,
                                          float& last) {
  mine = warp_sum8(v, lane);
  float u = v[8];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) u += __shfl_xor_sync(kFull, u, off);
  last = u;
}

// A pixel's running transmittance and colour, front to back.
struct Running {
  float t = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
};

// One step over an entry of alpha a and colour (cr, cg, cb):
// w = a T;  C += w rgb;  T *= 1 - a.  Returns w.  An entry with a = 0
// leaves the state's bits as they were.
__device__ __forceinline__ float step(Running& s, float a, float cr, float cg, float cb) {
  const float w = __fmul_rn(a, s.t);
  s.r = __fmaf_rn(w, cr, s.r);
  s.g = __fmaf_rn(w, cg, s.g);
  s.b = __fmaf_rn(w, cb, s.b);
  s.t = __fmul_rn(s.t, __fsub_rn(1.0f, a));
  return w;
}

}  // namespace omfs4d
