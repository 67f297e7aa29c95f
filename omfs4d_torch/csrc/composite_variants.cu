// The five K2 ablation variants (kernel V) for Hopper, sm_90a.
//
// Replaces the TPU kernel scripts/profile_composite_variants.py::
// make_variant_kernel(mode) (its `body`, with
// omfs4d/render/pallas_kernels.py::_alpha_matrix).  The reference built it
// to take its composite backward apart: each mode keeps one part of the
// backward's work.  Inputs are the packed per-tile table (T, 9, K) (rows ux,
// uy, conic a/b/c, r, g, b, opacity; opacity 0 on padding), the colour
// cotangent dcol (T, 3, P) and the alpha cotangent dA (T, 1, P); the output
// is (T, 9, K).  Tile t covers pixels with centres
// x = (t % grid_w) * tile + p % tile + 0.5, y = (t / grid_w) * tile + p / tile + 0.5;
// there is no tile base and no count: every tile walks all K entries.  Per
// pixel p and entry k, as K2 (composite_bwd.cu) computes them:
//
//   a_full = o exp(min(-(A dx^2 + C dy^2)/2 - B dx dy, 0)),  a = min(a_full, 0.99),
//   set to 0 below 1/255;  ok = neither capped nor cut;  lg = log(max(1 - a, 1e-6))
//
//   copy          out = 2 packed.
//   elementwise   K2's gradient chain with stand-ins for the scans:
//                 t_excl = max(1 - a, 1e-6), suffix = a/2, dw = a + 0.1,
//                 t_total = exp(sum_k lg); da = dw t_excl - suffix/(1-a)
//                 + dA t_total/(1-a), 0 where !ok; rows 0-4 = d(ux, uy, A, B, C)
//                 as K2 sums them, rows 5-7 = 0, row 8 = sum_p da a_full/max(o, 1e-12).
//   matmuls       t_excl = exp(sum_{j<k} lg_j), w = a t_excl, dw = dcol . rgb,
//                 m = dw w; row 0 = sum_p sum_{j>k} m_j, rows 1-5 = 0,
//                 rows 6-8 = sum_p dcol w.
//   bf16_matmuls  matmuls with lg, dcol, rgb, m and w rounded to bf16 (round
//                 to nearest even, as XLA converts) where the reference casts
//                 them; products and sums in f32.  V rounds the same f32
//                 values as the plain version: alpha_of takes the
//                 reference's order of roundings, and the prefix of rounded
//                 lg is exact in f32 in any order (bf16 values of at least
//                 2^-8 in magnitude, as a >= 1/255, summed below 512; exp
//                 underflows to 0 past ~104 anyway).
//   full_bf16     the whole backward with those five roundings, laid out as
//                 K2's rows (t_total from the unrounded lg, as the reference
//                 takes it), and no scatter into (N, 9).
//
// Routes.  One block per tile, one thread per pixel (tile*tile rounded up to
// whole warps; the extra threads are not pixels and add nothing), the
// (9, K) slab staged through shared memory in batches, as in K2.  The TPU's
// (P, K) triangular matmuls become running sums in registers.
//   copy          a strided copy of the block's slab, in float4 where the
//                 slab is 16-byte aligned; no pixel work.
//   elementwise   two passes: the first sums lg per pixel (t_total), the
//                 second takes the chain and 6 sums per entry.
//   matmuls, bf16_matmuls  one pass.  The exclusive prefix of lg is a
//                 register carried front to back; 4 sums per entry (m and
//                 dcol w).  Row 0 is sum_{j>k} M_j with M_j = sum_p m[p, j]:
//                 the same sums the reference takes, reordered, and exact as
//                 an exclusive suffix scan over k of the per-entry sums
//                 (warp 0, by chunks, after the last batch), with no
//                 subtraction.
//   full_bf16     two passes, as K2: the first keeps the per-pixel totals
//                 sum_k lg and sum_k m, the second takes the per-pixel
//                 suffix_k = sum_{j>k} m_j as that total minus a running
//                 inclusive prefix, which is exactly 0 at the last entry
//                 (the same terms are added in the same order).  Both
//                 sums are kept in f64: in f32 the difference would carry
//                 ~2K * 2^-24 * sum_j |m_j| of cancellation error, which
//                 on a real frame, where a tile's late entries have small
//                 m behind large early ones, reaches past the f32 bound
//                 per row.  In f64 it is ~2K * 2^-53 * sum_j |m_j|, and the
//                 suffix is the f32 rounding of the exact one, as close as
//                 the plain version's reverse cumsum.
// A sum over the tile's pixels is a warp-shuffle sum per entry (skipped when
// no lane of the warp has a term: a = 0 everywhere, or !ok in elementwise),
// parked by lane 0 in shared memory; after each batch the block adds the
// warps' sums and writes them.  Each block owns its tile's (9, K) output, so
// there are no atomics and the output is the same on every run.
//
// What bounds it.  At the reference's T = 1024, K = 512, P = 256 a mode
// evaluates ~134 M (pixel, entry) alphas per pass (~15 flops and one expf
// each: ~2-4 GFLOP, tens of us of the card's f32 rate) and reads and writes
// 2 x 18.9 MB (~11 us of its memory bandwidth: the copy mode's floor).  The
// per-entry sums (5 shuffles a row for each warp an entry reaches, then a
// barrier per batch) and the chain behind the first expf are the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using omfs4d::kFull;
using omfs4d::kRows;
constexpr int kUx = 0, kUy = 1, kCa = 2, kCb = 3, kCc = 4, kR = 5, kG = 6, kB = 7, kO = 8;

// modes, in the order of the Python wrapper's MODES
constexpr int kCopy = 0, kElementwise = 1, kMatmuls = 2, kBf16Matmuls = 3, kFullBf16 = 4;

// sums each entry takes over the tile's pixels
__host__ __device__ constexpr int reduced_rows(int mode) {
  return mode == kElementwise ? 6 : mode == kFullBf16 ? kRows : 4;
}
__host__ __device__ constexpr bool rounds_bf16(int mode) {
  return mode == kBf16Matmuls || mode == kFullBf16;
}
__host__ __device__ constexpr bool scans_row0(int mode) {
  return mode == kMatmuls || mode == kBf16Matmuls;
}

// the reference's .astype(bfloat16) on a value it then uses in f32
template <bool BF>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

struct Alpha {
  float dx, dy, a_full, a;
  bool ok;  // neither capped at 0.99 nor cut below 1/255 (the reference's grad_ok)
};

// composite_common.cuh's alpha, which rounds each operation on its own in
// the reference's order (no FMA contraction), so that a_full, and with it
// the cap, the cut and the bf16 roundings of lg, w and m, are the bits the
// plain version computes on the card: the two then differ only by the
// order of their f32 sums.  Threads that are not pixels see a = 0.
__device__ __forceinline__ Alpha alpha_of(float x, float y, const float* s, int batch,
                                          int j, bool pixel) {
  const omfs4d::Alpha c =
      omfs4d::alpha_of(x, y, s[kUx * batch + j], s[kUy * batch + j], s[kCa * batch + j],
                       s[kCb * batch + j], s[kCc * batch + j], s[kO * batch + j]);
  Alpha e;
  e.dx = c.dx;
  e.dy = c.dy;
  e.a_full = pixel ? c.a_full : 0.0f;
  e.a = pixel ? c.a : 0.0f;
  e.ok = pixel && !(c.capped || c.cut);
  return e;
}

struct Weights {
  float t_excl, w, dw, m;
};

// w = a exp(s_excl), dw = dcol . rgb, m = dw w (rounded where the mode
// rounds).  Explicitly rounded operations, so that both passes of full_bf16
// get the same bits and its suffix ends at exactly 0.  In the bf16 modes
// the products of rounded operands are exact in f32, so the fused adds give
// the plain version's (r + g) + b bits.
template <bool BF>
__device__ __forceinline__ Weights weights_of(float a, float s_excl, float dr, float dg,
                                              float db, const float* s, int batch, int j) {
  Weights q;
  q.t_excl = expf(s_excl);
  q.w = __fmul_rn(a, q.t_excl);
  q.dw = __fmaf_rn(db, rnd<BF>(s[kB * batch + j]),
                   __fmaf_rn(dg, rnd<BF>(s[kG * batch + j]),
                             __fmul_rn(dr, rnd<BF>(s[kR * batch + j]))));
  q.m = rnd<BF>(__fmul_rn(q.dw, q.w));
  return q;
}

template <int MODE>
__global__ void composite_variant_kernel(
    const float* __restrict__ packed,   // (T, 9, K)
    const float* __restrict__ dcol,     // (T, 3, P)
    const float* __restrict__ dalpha,   // (T, 1, P)
    int K, int tile, int grid_w, int batch,
    float* __restrict__ out) {          // (T, 9, K)
  const int t = blockIdx.x;
  const float* in = packed + static_cast<long long>(t) * kRows * K;
  float* dst = out + static_cast<long long>(t) * kRows * K;

  if constexpr (MODE == kCopy) {
    const int n = kRows * K;
    const bool aligned =
        ((reinterpret_cast<unsigned long long>(in) | reinterpret_cast<unsigned long long>(dst)) &
         15) == 0;
    if (aligned && (n & 3) == 0) {  // 16-byte loads and stores
      const float4* in4 = reinterpret_cast<const float4*>(in);
      float4* dst4 = reinterpret_cast<float4*>(dst);
      for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
        const float4 v = in4[i];
        dst4[i] = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
      }
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = in[i] * 2.0f;
    }
  } else {
    constexpr int R = reduced_rows(MODE);
    constexpr bool BF = rounds_bf16(MODE);
    extern __shared__ float smem[];
    const int n_warps = blockDim.x >> 5;
    float* s_slab = smem;                       // row r of the batch at s_slab[r * batch + j]
    float* part = smem + kRows * batch;         // part[(warp * R + r) * batch + j]
    float* s_sum = part + n_warps * R * batch;  // (K,) sum_p m[p, k], scan modes only

    const int p = threadIdx.x;
    const int P = tile * tile;
    const bool pixel = p < P;
    const int warp = p >> 5;
    const int lane = p & 31;
    const float x = static_cast<float>((t % grid_w) * tile + p % tile) + 0.5f;
    const float y = static_cast<float>((t / grid_w) * tile + p / tile) + 0.5f;
    float dr = 0.0f, dg = 0.0f, db = 0.0f, dA = 0.0f;
    if (pixel) {
      const long long c = static_cast<long long>(t) * 3 * P + p;
      dr = rnd<BF>(dcol[c]);
      dg = rnd<BF>(dcol[c + P]);
      db = rnd<BF>(dcol[c + 2 * P]);
      dA = dalpha[static_cast<long long>(t) * P + p];
    }

    // the rows this mode leaves at 0
    if constexpr (MODE == kElementwise) {
      for (int i = p; i < 3 * K; i += blockDim.x) dst[kR * K + i] = 0.0f;
    } else if constexpr (scans_row0(MODE)) {
      for (int i = p; i < 5 * K; i += blockDim.x) dst[K + i] = 0.0f;
    }

    auto stage = [&](int start, int n) {
      for (int q = p; q < kRows * n; q += blockDim.x) {
        const int r = q / n;
        const int j = q - r * n;
        s_slab[r * batch + j] = in[r * K + start + j];
      }
    };

    // pass 1 (elementwise, full_bf16): per-pixel totals over all K entries.
    // An entry with a = 0 adds lg = 0 and m = 0, so it is skipped.
    float s_total = 0.0f;  // sum_k lg, unrounded
    double m_tot = 0.0;    // full_bf16: sum_k m, in f64 (see the header)
    if constexpr (MODE == kElementwise || MODE == kFullBf16) {
      float s_excl = 0.0f;
      for (int start = 0; start < K; start += batch) {
        const int n = min(batch, K - start);
        stage(start, n);
        __syncthreads();
        for (int j = 0; j < n; ++j) {
          const Alpha e = alpha_of(x, y, s_slab, batch, j, pixel);
          if (e.a > 0.0f) {
            const float lg = logf(fmaxf(1.0f - e.a, 1e-6f));
            s_total += lg;
            if constexpr (MODE == kFullBf16) {
              m_tot += weights_of<BF>(e.a, s_excl, dr, dg, db, s_slab, batch, j).m;
              s_excl += rnd<BF>(lg);
            }
          }
        }
        __syncthreads();
      }
    }
    const float t_total = expf(s_total);

    // the per-entry pass
    float s_excl = 0.0f;  // sum_{j<k} lg_j (rounded in the bf16 modes)
    double m_le = 0.0;    // full_bf16: sum_{j<=k} m_j, in f64
    for (int start = 0; start < K; start += batch) {
      const int n = min(batch, K - start);
      stage(start, n);
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const Alpha e = alpha_of(x, y, s_slab, batch, j, pixel);
        float* pj = part + warp * R * batch + j;
        const bool has_terms = MODE == kElementwise ? e.ok : e.a > 0.0f;
        if (!__any_sync(kFull, has_terms)) {
          // no pixel of this warp has a term, and s_excl and m_le move by 0
          if (lane == 0) {
#pragma unroll
            for (int r = 0; r < R; ++r) pj[r * batch] = 0.0f;
          }
          continue;
        }
        const float one_minus = fmaxf(1.0f - e.a, 1e-6f);
        float v[R];
        if constexpr (MODE == kElementwise || MODE == kFullBf16) {
          float t_excl, suffix, dw;
          if constexpr (MODE == kElementwise) {
            t_excl = one_minus;
            suffix = e.a * 0.5f;
            dw = e.a + 0.1f;
          } else {
            const Weights q = weights_of<BF>(e.a, s_excl, dr, dg, db, s_slab, batch, j);
            m_le += q.m;
            t_excl = q.t_excl;
            suffix = static_cast<float>(m_tot - m_le);
            dw = q.dw;
            const float wb = rnd<BF>(q.w);
            v[5] = dr * wb;
            v[6] = dg * wb;
            v[7] = db * wb;
            s_excl += rnd<BF>(logf(one_minus));
          }
          float da = dw * t_excl - suffix / one_minus + dA * t_total / one_minus;
          if (!e.ok) da = 0.0f;
          const float o = s_slab[kO * batch + j];
          const float ca = s_slab[kCa * batch + j];
          const float cb = s_slab[kCb * batch + j];
          const float cc = s_slab[kCc * batch + j];
          const float dq = da * e.a_full;
          v[0] = dq * (ca * e.dx + cb * e.dy);
          v[1] = dq * (cc * e.dy + cb * e.dx);
          v[2] = dq * (-0.5f * e.dx * e.dx);
          v[3] = dq * (-e.dx * e.dy);
          v[4] = dq * (-0.5f * e.dy * e.dy);
          v[R - 1] = da * (e.a_full / fmaxf(o, 1e-12f));
        } else {
          const Weights q = weights_of<BF>(e.a, s_excl, dr, dg, db, s_slab, batch, j);
          const float wb = rnd<BF>(q.w);
          v[0] = q.m;
          v[1] = dr * wb;
          v[2] = dg * wb;
          v[3] = db * wb;
          s_excl += rnd<BF>(logf(one_minus));
        }
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = warp_sum(v[r]);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) pj[r * batch] = v[r];
        }
      }
      __syncthreads();
      // add the warps' sums: entry start + j, sum r
      for (int q = p; q < R * n; q += blockDim.x) {
        const int r = q / n;
        const int j = q - r * n;
        float acc = 0.0f;
        for (int wi = 0; wi < n_warps; ++wi) acc += part[(wi * R + r) * batch + j];
        const int k = start + j;
        if constexpr (scans_row0(MODE)) {
          if (r == 0) {
            s_sum[k] = acc;
          } else {
            dst[(kR + r) * K + k] = acc;  // rows 6-8
          }
        } else if constexpr (MODE == kElementwise) {
          dst[(r < 5 ? r : kO) * K + k] = acc;
        } else {
          dst[r * K + k] = acc;
        }
      }
      __syncthreads();
    }

    if constexpr (scans_row0(MODE)) {
      // row 0 = sum_{j>k} s_sum[j]: warp 0 takes K in 32 chunks, scans the
      // chunk sums from the right across lanes, then walks its chunk down
      if (warp == 0) {
        const int chunk = (K + 31) / 32;
        const int lo = min(lane * chunk, K);
        const int hi = min(lo + chunk, K);
        float local = 0.0f;
        for (int k = lo; k < hi; ++k) local += s_sum[k];
        float incl = local;  // sum of the chunks of lanes >= lane
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float other = __shfl_down_sync(kFull, incl, off);
          if (lane + off < 32) incl += other;
        }
        float acc = __shfl_down_sync(kFull, incl, 1);
        if (lane == 31) acc = 0.0f;
        for (int k = hi - 1; k >= lo; --k) {
          dst[k] = acc;
          acc += s_sum[k];
        }
      }
    }
  }
}

template <int MODE>
int launch(const void* packed, const void* dcol, const void* dalpha, int n_tiles, int K,
           int tile, int grid_w, void* out, cudaStream_t stream) {
  const int threads = MODE == kCopy ? 256 : (tile * tile + 31) / 32 * 32;
  const int n_warps = threads / 32;
  const int batch = n_warps > 16 ? 32 : 64;
  const size_t smem =
      MODE == kCopy ? 0
                    : (static_cast<size_t>(kRows) * batch +
                       static_cast<size_t>(n_warps) * reduced_rows(MODE) * batch +
                       (scans_row0(MODE) ? static_cast<size_t>(K) : 0)) *
                          sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_variant_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  composite_variant_kernel<MODE><<<n_tiles, threads, smem, stream>>>(
      static_cast<const float*>(packed), static_cast<const float*>(dcol),
      static_cast<const float*>(dalpha), K, tile, grid_w, batch, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches mode `mode` (0 copy, 1 elementwise, 2 matmuls, 3 bf16_matmuls,
// 4 full_bf16) with one block per tile on `stream`.  `out` needs no zeroing:
// every element is written.  Returns cudaGetLastError() as an int, so a
// refused launch reaches the caller.
extern "C" int omfs4d_composite_variant(int mode, const void* packed, const void* dcol,
                                        const void* dalpha, int n_tiles, int K, int tile,
                                        int grid_w, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCopy:
      return launch<kCopy>(packed, dcol, dalpha, n_tiles, K, tile, grid_w, out, s);
    case kElementwise:
      return launch<kElementwise>(packed, dcol, dalpha, n_tiles, K, tile, grid_w, out, s);
    case kMatmuls:
      return launch<kMatmuls>(packed, dcol, dalpha, n_tiles, K, tile, grid_w, out, s);
    case kBf16Matmuls:
      return launch<kBf16Matmuls>(packed, dcol, dalpha, n_tiles, K, tile, grid_w, out, s);
    case kFullBf16:
      return launch<kFullBf16>(packed, dcol, dalpha, n_tiles, K, tile, grid_w, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
