// What the composite kernels K1 (composite_fwd.cu), K2 (composite_bwd.cu) and
// V (composite_variants.cu) evaluate alike: one (pixel, list entry) alpha and
// the running front-to-back step; and, for K1 and K2, the box outside which
// an entry's alpha is 0, by which each warp lists the entries it walks.
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
// a_full = o exp(power), a = min(a_full, 0.99) and 0 below 1/255.
__device__ __forceinline__ Alpha alpha_of(float x, float y, float ux, float uy, float ca,
                                          float cb, float cc, float o) {
  Alpha r;
  r.dx = __fsub_rn(x, ux);
  r.dy = __fsub_rn(y, uy);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, r.dx), r.dx),
                               __fmul_rn(__fmul_rn(cc, r.dy), r.dy));
  const float power =
      fminf(__fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, r.dx), r.dy)), 0.0f);
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
