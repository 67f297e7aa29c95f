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
// there is no tile base and no count: a tile's table holds K slots.  Per
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
// What bounds it.  The TPU body evaluates every (pixel, slot) pair: its
// (P, K) x (K, K) triangular products are a scan written for a matrix unit.
// The function needs far less.  An entry's alpha is 0 outside its reach box
// (composite_common.cuh, reach_of), and at a = 0 every running sum moves by
// exactly 0 and every term is 0.  On the reference's own table (T = 1024,
// K = 512, P = 256, uniform random means) 1.8% of the 134 M pairs lie in
// reach and 0.42% are live; 11 of a tile's 512 slots reach it at all.  So
// the bound there is the bytes: read and write the 18.9 MB table and read
// 4 MB of cotangents, ~12.5 us; the needed FP32 work is ~2 us.  On a binned
// training frame (K = 256) nearly every listed entry reaches its tile, and
// the bound is K2's: FP32 instructions at the pairs in reach and the live ones.
// The first port walked all K slots at every pixel, twice in two modes, and
// sat 30-50x over the bound.
//
// Design.  One block per tile, one thread per pixel (tile*tile rounded up to
// whole warps; the extra threads are not pixels and add nothing), so a warp
// covers two rows of a 16-px tile.
//   Staging.  The tile's whole (9, K) slab is copied once into shared
//     memory, for both passes: one thread starts a 1-D bulk copy
//     (cp.async.bulk, completing on an mbarrier) when the slab is 16-byte
//     aligned (K % 4 == 0), while all threads load their cotangents; a
//     plain loop otherwise.
//   The block list.  Each slot's reach box is taken once (a warp owns a
//     contiguous run of slots), and the slots whose box meets the tile are
//     compacted in order into the block list (ballots, a prefix over the
//     warps' counts), each with a copy of its parameters as 16-byte records
//     (ux, uy, A, B), (C, o, r, g), (b) by list position: the walk then reads
//     an entry in 2 LDS.128 and 1 LDS.32 with no index load, where the slab's
//     rows cost 9 LDS.32 behind one.  The slab columns of all other slots
//     are zeroed: that is their output.
//   The walk.  The block list is walked in chunks of 64 entries (32 where
//     three blocks would not fit an SM's shared memory otherwise: full_bf16
//     at K = 512).  A warp tests the chunk's boxes against the box of its own
//     pixels (ballots into a 64-bit mask) and walks the set bits front to
//     back, in both passes alike; the alpha comes first, and an entry on
//     which no pixel of the warp has a term is skipped there (__any_sync).
//     Skipped entries have a = 0 at every pixel of the warp, so a visited
//     entry's arithmetic, the bf16 roundings and each pixel's prefix keep
//     the bits of the first port; only the order of the f32 sums over pixels
//     differs.  (dA t_total - suffix) / (1 - a) takes one reciprocal, as in
//     K2.
//   Sums.  A warp sums an entry's terms over its pixels in one multi-value
//     exchange (warp_sum9, warp_sum8, warp_sum4: 14, 9 and 6 shuffles for 9,
//     6 and 4 sums, where shuffle trees take 45, 30 and 20) and parks them in
//     its slot of the chunk's buffer, with a bit in its mask of live entries.
//     After one barrier the block adds the warps' parked sums in warp order
//     (no atomics: the same bits on every run) and writes them over the
//     entry's own slab column, which no walk reads again.  The buffers
//     alternate, so a warp goes on to the next chunk without a second
//     barrier.
//   Row 0 of the matmul modes, sum_{j>k} M_j with M_j = sum_p m[p, j], is
//     piecewise constant between listed entries: warp 0 takes the inclusive
//     suffix over the block list (in 32 runs, no subtraction), and a slot
//     reads the value of the first listed entry behind it.
//   full_bf16's per-pixel suffix_k = sum_{j>k} m_j is the first pass's total
//     minus a running inclusive prefix, both in f64 (in f32 the difference
//     carries ~2K 2^-24 sum|m| of cancellation error, past the bound per row
//     on a real frame); it is exactly 0 at a pixel's last entry.  Non-finite
//     m are counted apart, so the suffix is NaN or Inf where a reverse sum
//     is.
//   Output.  One sweep writes the slab, results and zeros alike, with
//     16-byte stores, each element once.
//   A tile that holds a non-finite entry walks every slot with every warp
//     and skips nothing: the plain version's NaN spreads through 0 * NaN to
//     entries that reach no pixel.  Clamps keep a NaN, as torch.clamp does.
//   copy is a float4 product by 2 with no pixel work, four loads in flight a
//     thread.
// Measured on an H100 at 700 W and dropped: two pixels a thread, as K1
// has them (half the exchanges, but half the warps and longer lists per warp:
// 12-26% slower at a training frame); chunks of 32 everywhere (elementwise
// 15% slower there); blocks taken in a spread order (no change: the heavy
// tiles already spread over the SMs); a second instantiation bounded at 256
// threads, free of the 64-register cap of 1024-thread blocks (no change:
// full_bf16 takes 64 registers either way, without spills).  Kept: the bulk
// copy (against a float4 loop by all threads 8-15% faster on the reference
// table, level at a training frame); 16-byte records (8-22% at a training
// frame, 4-13% slower on the reference table before the chunks of 32); the
// slot loops unrolled by two, the copy started before the first barrier and
// the sweep by rows (together 11-13% on the reference table, 7-10% at a
// training frame, full_bf16 unchanged).
// Tensor cores are not used: in registers the scan costs P K steps where the
// triangular products cost P K B multiply-adds, and with 2% of the slots
// reaching a tile there is no dense operand left to multiply; neither the
// bytes nor the FP32 instructions at live pairs are something wgmma moves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using omfs4d::kFull;
using omfs4d::kRows;
constexpr int kUx = 0, kUy = 1, kCa = 2, kCb = 3, kCc = 4, kR = 5, kG = 6, kB = 7, kO = 8;

// modes, in the order of the Python wrapper's MODES
constexpr int kCopy = 0, kElementwise = 1, kMatmuls = 2, kBf16Matmuls = 3, kFullBf16 = 4;

constexpr int kMaxChunk = 64;  // block-list entries walked between two barriers: a 64-bit mask

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
// the output row of an entry's sum r
__host__ __device__ constexpr int row_of_sum(int mode, int r) {
  return mode == kElementwise ? (r < 5 ? r : kO) : scans_row0(mode) ? (r == 0 ? 0 : kR + r) : r;
}
// the rows a mode leaves at 0
__host__ __device__ constexpr bool zero_row(int mode, int row) {
  return mode == kElementwise ? (row >= kR && row <= kB)
                              : scans_row0(mode) ? (row >= 1 && row <= 5) : false;
}

// Byte offsets of a block's arrays in its dynamic shared memory.
struct Layout {
  int slab;    // float (9, K): the tile's table, then its output
  int reach;   // float4 (K,): reach boxes
  int live;    // unsigned long long (2, n_warps): per buffer and warp, the entries parked
  int mbar;    // unsigned long long: the bulk copy's barrier
  int part;    // float (2, n_warps, chunk, R): parked sums
  int count;   // int (n_warps,): listed slots of each warp's run
  int blist;   // unsigned short (K,): the block list
  int rank;    // unsigned short (K,): listed slots up to and including this one
  int geo;     // float4 (K,): ux, uy, A, B of each listed entry, by list position
  int mat;     // float4 (K,): C, o, r, g
  int blue;    // float (K,): b
  int total;
};
__host__ __device__ inline Layout layout_of(int K, int n_warps, int R, int chunk) {
  Layout l;
  l.slab = 0;
  l.reach = (kRows * K + 3) / 4 * 16;
  l.live = l.reach + 16 * K;
  l.mbar = l.live + 16 * n_warps;
  l.part = l.mbar + 16;
  l.count = l.part + 2 * n_warps * chunk * R * 4;
  l.blist = l.count + 4 * n_warps;
  l.rank = l.blist + 2 * K;
  l.geo = (l.rank + 2 * K + 15) / 16 * 16;
  l.mat = l.geo + 16 * K;
  l.blue = l.mat + 16 * K;
  l.total = l.blue + 4 * K;
  return l;
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

// max(1 - a, 1e-6) that keeps a NaN, as torch.clamp_min does
__device__ __forceinline__ float one_minus_of(float a) {
  const float u = 1.0f - a;
  return u < 1e-6f ? 1e-6f : u;
}

struct Alpha {
  float dx, dy, a_full, a;
  bool ok;  // neither capped at 0.99 nor cut below 1/255 (the reference's grad_ok)
};

// composite_common.cuh's alpha, which rounds each operation on its own in
// the reference's order (no FMA contraction), so that a_full, and with it
// the cap, the cut and the bf16 roundings of lg, w and m, are the bits the
// plain version computes on the card: the two then differ only by the
// order of their f32 sums.  geo and mat are a listed entry's records.
__device__ __forceinline__ Alpha alpha_of(float x, float y, const float4& geo,
                                          const float4& mat) {
  const omfs4d::Alpha c = omfs4d::alpha_of<true>(x, y, geo.x, geo.y, geo.z, geo.w, mat.x, mat.y);
  Alpha e;
  e.dx = c.dx;
  e.dy = c.dy;
  e.a_full = c.a_full;
  e.a = c.a;
  e.ok = !(c.capped || c.cut);
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
                                              float db, float cr, float cg, float cb) {
  Weights q;
  q.t_excl = expf(s_excl);
  q.w = __fmul_rn(a, q.t_excl);
  q.dw = __fmaf_rn(db, rnd<BF>(cb), __fmaf_rn(dg, rnd<BF>(cg), __fmul_rn(dr, rnd<BF>(cr))));
  q.m = rnd<BF>(__fmul_rn(q.dw, q.w));
  return q;
}

// full_bf16's sums of m over a pixel's entries: the finite ones in f64, the
// others counted (NaN, +Inf, -Inf in 21 bits each; K < 65,536, the block
// list's index type).
struct MSum {
  double sum = 0.0;
  unsigned long long others = 0;
  __device__ __forceinline__ void add(float m) {
    if (isfinite(m)) {
      sum += m;
    } else {
      others += isnan(m) ? 1ull << 42 : m > 0.0f ? 1ull << 21 : 1ull;
    }
  }
};

// sum_{j>k} m_j from the total and the inclusive prefix
__device__ __forceinline__ float suffix_of(const MSum& total, const MSum& upto) {
  const unsigned long long rest = total.others - upto.others;
  if (rest == 0) return static_cast<float>(total.sum - upto.sum);
  const bool pos = (rest >> 21) & 0x1fffffull, neg = rest & 0x1fffffull;
  if ((rest >> 42) || (pos && neg)) return __int_as_float(0x7fc00000);
  return __int_as_float(pos ? 0x7f800000 : 0xff800000);
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__global__ void composite_variant_copy_kernel(const float* __restrict__ packed, int K,
                                              float* __restrict__ out) {
  const float* in = packed + static_cast<long long>(blockIdx.x) * kRows * K;
  float* dst = out + static_cast<long long>(blockIdx.x) * kRows * K;
  const int n = kRows * K;
  const bool aligned =
      ((reinterpret_cast<unsigned long long>(in) | reinterpret_cast<unsigned long long>(dst)) &
       15) == 0;
  if (aligned && (n & 3) == 0) {  // 16-byte loads and stores, four loads in flight a thread
    const float4* in4 = reinterpret_cast<const float4*>(in);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const int n4 = n / 4, step = blockDim.x;
    for (int i = threadIdx.x; i < n4; i += 4 * step) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i + u * step < n4) v[u] = in4[i + u * step];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i + u * step < n4) {
          dst4[i + u * step] =
              make_float4(v[u].x * 2.0f, v[u].y * 2.0f, v[u].z * 2.0f, v[u].w * 2.0f);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = in[i] * 2.0f;
  }
}

template <int MODE>
__global__ void __launch_bounds__(1024) composite_variant_kernel(
    const float* __restrict__ packed,   // (T, 9, K)
    const float* __restrict__ dcol,     // (T, 3, P)
    const float* __restrict__ dalpha,   // (T, 1, P)
    int K, int tile, int grid_w, int chunk,
    float* __restrict__ out) {          // (T, 9, K)
  constexpr int R = reduced_rows(MODE);
  constexpr int RP = R == 6 ? 8 : R;  // elementwise pads its 6 sums to warp_sum8's 8
  constexpr bool BF = rounds_bf16(MODE);
  constexpr bool TWO_PASS = MODE == kElementwise || MODE == kFullBf16;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int n_warps = blockDim.x >> 5;
  const Layout lay = layout_of(K, n_warps, R, chunk);
  float* s_slab = reinterpret_cast<float*>(smem + lay.slab);
  float4* s_reach = reinterpret_cast<float4*>(smem + lay.reach);
  unsigned long long* s_live = reinterpret_cast<unsigned long long*>(smem + lay.live);
  unsigned long long* s_mbar = reinterpret_cast<unsigned long long*>(smem + lay.mbar);
  float* s_part = reinterpret_cast<float*>(smem + lay.part);
  int* s_count = reinterpret_cast<int*>(smem + lay.count);
  unsigned short* s_blist = reinterpret_cast<unsigned short*>(smem + lay.blist);
  unsigned short* s_rank = reinterpret_cast<unsigned short*>(smem + lay.rank);
  float4* s_geo = reinterpret_cast<float4*>(smem + lay.geo);
  float4* s_mat = reinterpret_cast<float4*>(smem + lay.mat);
  float* s_blue = reinterpret_cast<float*>(smem + lay.blue);

  const int t = blockIdx.x;
  const float* in = packed + static_cast<long long>(t) * kRows * K;
  float* dst = out + static_cast<long long>(t) * kRows * K;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int P = tile * tile;

  // stage the slab: one bulk copy when it is 16-byte aligned
  const bool bulk = (reinterpret_cast<unsigned long long>(in) & 15) == 0 && (K & 3) == 0;
  if (bulk) {
    const unsigned mbar = shared_address(s_mbar);
    if (p == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mbar), "r"(1) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const unsigned bytes = static_cast<unsigned>(kRows * K * sizeof(float));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(shared_address(s_slab)),
          "l"(in), "r"(bytes), "r"(mbar)
          : "memory");
    }
  } else {
    for (int i = p; i < kRows * K; i += blockDim.x) s_slab[i] = in[i];
  }

  // this thread's pixel; threads past the tile have none
  const bool pixel = p < P;
  const float tx = static_cast<float>((t % grid_w) * tile);
  const float ty = static_cast<float>((t / grid_w) * tile);
  const float x = tx + static_cast<float>(p % tile) + 0.5f;
  const float y = ty + static_cast<float>(p / tile) + 0.5f;
  float dr = 0.0f, dg = 0.0f, db = 0.0f, dA = 0.0f;
  if (pixel) {
    const long long c = static_cast<long long>(t) * 3 * P + p;
    dr = rnd<BF>(dcol[c]);
    dg = rnd<BF>(dcol[c + P]);
    db = rnd<BF>(dcol[c + 2 * P]);
    dA = dalpha[static_cast<long long>(t) * P + p];
  }
  const float4 box = omfs4d::warp_box(x, x, y, y);
  const float4 tile_box = make_float4(tx + 0.5f, tx + static_cast<float>(tile) - 0.5f, ty + 0.5f,
                                      ty + static_cast<float>(tile) - 0.5f);

  if (bulk) {
    __syncthreads();  // thread 0 has initialised the barrier
    // wait for the copy: a trap beats a hang should it never land
    const unsigned mbar = shared_address(s_mbar);
    unsigned done = 0;
    for (int tries = 0; !done; ++tries) {
      asm volatile(
          "{\n.reg .pred ready;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], %2;\n"
          "selp.u32 %0, 1, 0, ready;\n}\n"
          : "=r"(done)
          : "r"(mbar), "r"(0)
          : "memory");
      if (tries > (1 << 24)) __trap();
    }
  } else {
    __syncthreads();
  }

  // reach boxes: warp `warp` owns slots lo .. hi - 1
  const int per = ((K + n_warps - 1) / n_warps + 31) / 32 * 32;
  const int lo = min(warp * per, K), hi = min(lo + per, K);
  int count = 0;
  bool bad = false;
#pragma unroll 2
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    bool hit = false;
    if (j < hi) {
      float v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = s_slab[r * K + j];
      const float4 reach = omfs4d::reach_of(v[kUx], v[kUy], v[kCa], v[kCb], v[kCc], v[kO], v[kR],
                                            v[kG], v[kB]);
      s_reach[j] = reach;
      hit = omfs4d::meets(reach, tile_box);
      // reach_of's own test of a non-finite entry
      bad = bad || !isfinite(v[kUx] + v[kUy] + v[kCa] + v[kCb] + v[kCc] + v[kO] + v[kR] +
                             v[kG] + v[kB]);
    }
    count += __popc(__ballot_sync(kFull, hit));
  }
  if (lane == 0) s_count[warp] = count;
  // a tile with a non-finite entry lists every slot, for every warp
  const bool every = __syncthreads_or(bad);

  // the block list, in slot order; the columns of unlisted slots become zeros
  int offset = 0, n_list = 0;
  if (every) {
    offset = lo;
    n_list = K;
  } else {
    for (int w = 0; w < n_warps; ++w) {
      const int c = s_count[w];
      if (w < warp) offset += c;
      n_list += c;
    }
  }
#pragma unroll 2
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    const bool hit = j < hi && (every || omfs4d::meets(s_reach[j], tile_box));
    const unsigned mask = __ballot_sync(kFull, hit);
    const int pos = offset + __popc(mask & ((1u << lane) - 1u));
    if (j < hi) {
      if (hit) {
        s_blist[pos] = static_cast<unsigned short>(j);
        s_geo[pos] = make_float4(s_slab[kUx * K + j], s_slab[kUy * K + j], s_slab[kCa * K + j],
                                 s_slab[kCb * K + j]);
        s_mat[pos] = make_float4(s_slab[kCc * K + j], s_slab[kO * K + j], s_slab[kR * K + j],
                                 s_slab[kG * K + j]);
        s_blue[pos] = s_slab[kB * K + j];
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) s_slab[r * K + j] = 0.0f;
      }
      if constexpr (scans_row0(MODE)) s_rank[j] = static_cast<unsigned short>(pos + hit);
    }
    offset += __popc(mask);
  }
  __syncthreads();

  // the entries of chunk c0 .. c0 + n - 1 of the block list that reach this warp
  auto reaching = [&](int c0, int n) -> unsigned long long {
    if (every) return n == 64 ? ~0ull : (1ull << n) - 1ull;
    unsigned long long mask = 0;
    for (int h = 0; h < n; h += 32) {
      const int i = h + lane;
      const bool hit = i < n && omfs4d::meets(s_reach[s_blist[c0 + i]], box);
      mask |= static_cast<unsigned long long>(__ballot_sync(kFull, hit)) << h;
    }
    return mask;
  };

  // pass 1 (elementwise, full_bf16): per-pixel totals over the warp's entries.
  // An entry with a = 0 adds lg = 0 and m = 0.
  float s_total = 0.0f;  // sum_k lg, unrounded
  MSum m_tot;            // full_bf16: sum_k m
  if constexpr (TWO_PASS) {
    float s_excl = 0.0f;
    for (int c0 = 0; c0 < n_list; c0 += chunk) {
      unsigned long long mask = reaching(c0, min(chunk, n_list - c0));
      while (mask) {
        const int at = c0 + __ffsll(static_cast<long long>(mask)) - 1;
        mask &= mask - 1;
        const float4 geo = s_geo[at], mat = s_mat[at];
        const Alpha e = alpha_of(x, y, geo, mat);
        if (pixel && (every || e.a > 0.0f)) {
          const float lg = logf(one_minus_of(e.a));
          s_total += lg;
          if constexpr (MODE == kFullBf16) {
            m_tot.add(weights_of<BF>(e.a, s_excl, dr, dg, db, mat.z, mat.w, s_blue[at]).m);
            s_excl += rnd<BF>(lg);
          }
        }
      }
    }
  }
  const float t_total = expf(s_total);

  // the per-entry pass
  float s_excl = 0.0f;  // sum_{j<k} lg_j (rounded in the bf16 modes)
  MSum m_le;            // full_bf16: sum_{j<=k} m_j
  int buf = 0;
  for (int c0 = 0; c0 < n_list; c0 += chunk, buf ^= 1) {
    const int n = min(chunk, n_list - c0);
    unsigned long long mask = reaching(c0, n);
    unsigned long long live = 0;
    float* parked = s_part + static_cast<size_t>(buf * n_warps + warp) * chunk * R;
    while (mask) {
      const int i = __ffsll(static_cast<long long>(mask)) - 1;
      mask &= mask - 1;
      const float4 geo = s_geo[c0 + i], mat = s_mat[c0 + i];
      // the alpha first: an entry on which no pixel of this warp has a term is
      // skipped (s_excl and m_le would move by 0, every sum by 0)
      const Alpha e = alpha_of(x, y, geo, mat);
      const bool has_terms = pixel && (MODE == kElementwise ? e.ok : e.a > 0.0f);
      if (!every && !__any_sync(kFull, has_terms)) continue;
      float v[RP];
#pragma unroll
      for (int r = 0; r < RP; ++r) v[r] = 0.0f;
      if (pixel) {
        const float one_minus = one_minus_of(e.a);
        if constexpr (TWO_PASS) {
          float t_excl, suffix, dw;
          if constexpr (MODE == kElementwise) {
            t_excl = one_minus;
            suffix = e.a * 0.5f;
            dw = e.a + 0.1f;
          } else {
            const Weights g = weights_of<BF>(e.a, s_excl, dr, dg, db, mat.z, mat.w, s_blue[c0 + i]);
            m_le.add(g.m);
            t_excl = g.t_excl;
            suffix = suffix_of(m_tot, m_le);
            dw = g.dw;
            const float wb = rnd<BF>(g.w);
            v[5] = dr * wb;
            v[6] = dg * wb;
            v[7] = db * wb;
            s_excl += rnd<BF>(logf(one_minus));
          }
          // one reciprocal, not two divisions: (dA t_total - suffix) / (1 - a)
          const float inv = __frcp_rn(one_minus);
          float da = __fmaf_rn(dA * t_total - suffix, inv, dw * t_excl);
          if (!e.ok) da = 0.0f;
          const float o = mat.y, ca = geo.z, cb = geo.w, cc = mat.x;
          const float dq = da * e.a_full;
          v[0] = dq * (ca * e.dx + cb * e.dy);
          v[1] = dq * (cc * e.dy + cb * e.dx);
          v[2] = dq * (-0.5f * e.dx * e.dx);
          v[3] = dq * (-e.dx * e.dy);
          v[4] = dq * (-0.5f * e.dy * e.dy);
          v[R - 1] = da * (e.a_full * __frcp_rn(fmaxf(o, 1e-12f)));
        } else {
          const Weights g = weights_of<BF>(e.a, s_excl, dr, dg, db, mat.z, mat.w, s_blue[c0 + i]);
          const float wb = rnd<BF>(g.w);
          v[0] = g.m;
          v[1] = dr * wb;
          v[2] = dg * wb;
          v[3] = db * wb;
          s_excl += rnd<BF>(logf(one_minus));
        }
      }
      float* sums = parked + i * R;
      if constexpr (R == kRows) {
        float mine, last;
        omfs4d::warp_sum9(v, lane, mine, last);
        if ((lane & 3) == 0) sums[lane >> 2] = mine;
        if (lane == 1) sums[8] = last;
      } else if constexpr (R == 6) {
        const float mine = omfs4d::warp_sum8(v, lane);
        if ((lane & 3) == 0 && lane < 4 * R) sums[lane >> 2] = mine;
      } else {
        const float mine = omfs4d::warp_sum4(v, lane);
        if ((lane & 7) == 0) sums[lane >> 3] = mine;
      }
      live |= 1ull << i;
    }
    if (lane == 0) s_live[buf * n_warps + warp] = live;
    __syncthreads();
    // add the warps' parked sums, in warp order, into the entries' slab columns
    for (int q = p; q < n * R; q += blockDim.x) {
      const int i = q / R;
      const int r = q - i * R;
      float acc = 0.0f;
      for (int w = 0; w < n_warps; ++w) {
        if ((s_live[buf * n_warps + w] >> i) & 1ull) {
          acc += s_part[(static_cast<size_t>(buf * n_warps + w) * chunk + i) * R + r];
        }
      }
      s_slab[row_of_sum(MODE, r) * K + s_blist[c0 + i]] = acc;
    }
  }
  __syncthreads();

  if constexpr (scans_row0(MODE)) {
    // row 0: each listed slot's M becomes sum_{j >= it} M_j over the block
    // list.  Warp 0 takes the list in 32 runs, scans the runs' sums from the
    // right across lanes, then walks its run down.
    if (warp == 0) {
      const int run = (n_list + 31) / 32;
      const int first = min(lane * run, n_list);
      const int end = min(first + run, n_list);
      float local = 0.0f;
      for (int i = first; i < end; ++i) local += s_slab[s_blist[i]];
      float incl = local;  // sum of the runs of lanes >= lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float other = __shfl_down_sync(kFull, incl, off);
        if (lane + off < 32) incl += other;
      }
      float acc = __shfl_down_sync(kFull, incl, 1);
      if (lane == 31) acc = 0.0f;
      for (int i = end - 1; i >= first; --i) {
        acc += s_slab[s_blist[i]];
        s_slab[s_blist[i]] = acc;
      }
    }
    __syncthreads();
  }

  // the output: the slab as it stands, zeros in the rows the mode leaves at
  // 0, and in row 0 of the matmul modes the sum behind each slot
  auto element = [&](int r, int j) -> float {
    if constexpr (scans_row0(MODE)) {
      if (r == 0) {
        const int behind = s_rank[j];  // the first listed entry behind slot j
        return behind < n_list ? s_slab[s_blist[behind]] : 0.0f;
      }
    }
    return s_slab[r * K + j];
  };
  if ((reinterpret_cast<unsigned long long>(dst) & 15) == 0 && (K & 3) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      for (int j = 4 * p; j < K; j += 4 * blockDim.x) {
        dst4[(r * K + j) >> 2] =
            zero_row(MODE, r) ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                              : make_float4(element(r, j), element(r, j + 1), element(r, j + 2),
                                            element(r, j + 3));
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      for (int j = p; j < K; j += blockDim.x) {
        dst[r * K + j] = zero_row(MODE, r) ? 0.0f : element(r, j);
      }
    }
  }
}

template <int MODE>
int launch(const void* packed, const void* dcol, const void* dalpha, int n_tiles, int K,
           int tile, int grid_w, void* out, cudaStream_t stream) {
  // whole warps: the reach test takes the box of a warp's pixels
  const int threads = (tile * tile + 31) / 32 * 32;
  // chunks of 64 entries where three blocks still fit an SM's shared memory
  // (the training frame's K = 256), else of 32 (the reference table's K = 512)
  const int roomy = layout_of(K, threads / 32, reduced_rows(MODE), kMaxChunk).total;
  const int chunk = roomy <= 72 * 1024 ? kMaxChunk : kMaxChunk / 2;
  const int smem = layout_of(K, threads / 32, reduced_rows(MODE), chunk).total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_variant_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // taken here, not by the next launch's check
      return static_cast<int>(err);
    }
  }
  composite_variant_kernel<MODE><<<n_tiles, threads, smem, stream>>>(
      static_cast<const float*>(packed), static_cast<const float*>(dcol),
      static_cast<const float*>(dalpha), K, tile, grid_w, chunk, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches mode `mode` (0 copy, 1 elementwise, 2 matmuls, 3 bf16_matmuls,
// 4 full_bf16) with one block per tile on `stream`.  `out` needs no zeroing:
// every element is written.  Returns cudaGetLastError() as an int, so a
// refused launch (a K whose slab does not fit shared memory) reaches the
// caller.
extern "C" int omfs4d_composite_variant(int mode, const void* packed, const void* dcol,
                                        const void* dalpha, int n_tiles, int K, int tile,
                                        int grid_w, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCopy:
      composite_variant_copy_kernel<<<n_tiles, 256, 0, s>>>(
          static_cast<const float*>(packed), K, static_cast<float*>(out));
      return static_cast<int>(cudaGetLastError());
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
