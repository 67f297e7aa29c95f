// Forward front-to-back composite of 3DGS tiles (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel omfs4d/render/pallas_kernels.py::_fwd_kernel
// (with _fwd_body, _alpha_matrix, _pixel_grid and _excl_prefix).  It computes
// what that kernel computes, per pixel p of a tile and list entry k:
//
//   a_k   = min(o_k * exp(min(-(A dx^2 + C dy^2)/2 - B dx dy, 0)), 0.99),
//           set to 0 below 1/255
//   rgb   = sum_k a_k * prod_{j<k}(1 - a_j) * c_k
//   alpha = 1 - prod_k (1 - a_k)
//
// with pixel centres at +0.5 and tile id = list row + tile_base.  The TPU
// kernel recasts the prefix products as log-space triangular matmuls for its
// matrix unit; here each pixel walks its list front to back and keeps the
// running transmittance in a register, in f32, with the alpha evaluation and
// the step of composite_common.cuh (the bits K2 recomputes).  There is no
// early exit on transmittance (CUDA 3DGS stops at T < 1e-4; the reference
// does not).  On request it also writes each pixel's final transmittance
// T_tot, the residual that lets K2 walk the list once.
//
// Layout.  One block per tile, half as many threads as the tile has
// pixels: each thread has two pixels of one column, in rows 2r and 2r + 1
// (they share dx and its products), so a warp covers a 16 x 4 block of the
// tile.  The block walks to the tile's count (never K: padded entries point
// at gaussian 0), staging up to 256 entries at a time in shared memory as
// 16-byte records (ux, uy, A, B), (C, o, r, g), (b) and the entry's reach
// box (composite_common.cuh, reach_of), gathered straight from the (N, .)
// tensors by list index (the JAX package gathers the (T, 9, K) table
// `_pack_lists` before its kernel).  Each warp then lists, 32 entries at a
// time with one ballot, the entries whose reach meets the box of its 64
// pixels (~60% of them at a training frame): for the others its step would
// be the identity (a = 0), so it walks only its list, in order, bit for
// bit the same result, with no branch in the walk.  An entry costs 2
// LDS.128 and 1 LDS.32 broadcasts for two pixels, where the first port
// paid 9 scalar loads for one.  The kernel writes the (H, W, 3)
// colour and (H, W) alpha directly (replacing `assemble_tiles` and the
// crop), masking pixels past the image edge.
//
// Tiles.  Their counts range from 0 to K within one frame: at a 512^2
// training frame ~60% of the tiles are empty and ~400 hold 200 or more
// entries, 3 or 4 for each of the 132 SMs, and the SMs that draw more set
// the kernel's time.  So a counting sort on the card
// (`heavy_first_kernel`, one block, launched just before) lists the tiles
// heaviest first into `order`, and block b takes tile order[b]: the block
// scheduler places the heavy ones first.  The order is left in `order` for
// K2.
//
// What bounds it.  At a 512^2 training frame (T = 1024, K = 256) the lists
// hold ~98k entries, ~25 M (pixel, entry) pairs.  The function needs the
// alpha (~16 FP32 instructions) only at the ~7.8 M pairs whose pixel lies
// in the entry's reach box, and the step (~6) only at the ~4.8 M live ones
// (a > 0): ~4.6 us of the card's FP32 issue, against ~3 us for its ~9 MB of
// traffic.  So instructions per pair (two pixels a thread, the reach lists)
// and the balance of the SMs (heaviest first) are what the design works on.
// It allocates nothing, does not synchronise and launches on the stream it
// is given.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using omfs4d::Alpha;
using omfs4d::Running;

constexpr int kMaxBatch = 256;  // entries staged at a time

__global__ void heavy_first_kernel(const int* __restrict__ counts, int n, int K,
                                   int* __restrict__ order) {
  // start[b] of bin b = K - count (heaviest first), as hist[b] after the scan
  extern __shared__ int hist[];  // K + 2
  for (int b = threadIdx.x; b < K + 2; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    atomicAdd(&hist[K - max(0, min(counts[i], K)) + 1], 1);
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // inclusive scan of hist[0 .. K+1] by one warp, in chunks
    const int lane = threadIdx.x;
    const int chunk = (K + 2 + 31) / 32;
    const int lo = min(lane * chunk, K + 2), hi = min(lo + chunk, K + 2);
    int sum = 0;
    for (int b = lo; b < hi; ++b) sum += hist[b];
    int before = sum;  // inclusive scan of the chunk sums across lanes
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, before, off);
      if (lane >= off) before += v;
    }
    int run = before - sum;
    for (int b = lo; b < hi; ++b) {
      run += hist[b];
      hist[b] = run;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    order[atomicAdd(&hist[K - max(0, min(counts[i], K))], 1)] = i;
  }
}

__global__ void composite_fwd_kernel(
    const float* __restrict__ uv,          // (N, 2)
    const float* __restrict__ conic,       // (N, 3)
    const float* __restrict__ rgb,         // (N, 3)
    const float* __restrict__ opacity,     // (N,)
    const int* __restrict__ tile_lists,    // (T, K)
    const int* __restrict__ tile_counts,   // (T,)
    const int* __restrict__ order,         // (T,) list rows in launch order
    int n_gauss, int K, int tile_base, int tile, int grid_w,
    int width, int height, int batch,
    float* __restrict__ out_rgb,           // (H, W, 3)
    float* __restrict__ out_alpha,         // (H, W)
    float* __restrict__ out_trans) {       // (H, W) or null
  extern __shared__ float4 smem4[];
  float4* s_geo = smem4;                                  // ux, uy, A, B
  float4* s_mat = smem4 + batch;                          // C, o, r, g
  float4* s_reach = smem4 + 2 * batch;                    // x0, x1, y0, y1
  float* s_b = reinterpret_cast<float*>(smem4 + 3 * batch);
  unsigned short* s_list =                                // per warp: entries that reach it
      reinterpret_cast<unsigned short*>(s_b + batch) + (threadIdx.x >> 5) * batch;

  const int t = order[blockIdx.x];
  const int tid = t + tile_base;
  const int col = threadIdx.x % tile;
  const int row = 2 * (threadIdx.x / tile);               // rows row, row + 1
  const bool has0 = row < tile, has1 = row + 1 < tile;    // threads past the tile: none
  const int px = (tid % grid_w) * tile + col;
  const int py0 = (tid / grid_w) * tile + row, py1 = py0 + 1;
  const float x = static_cast<float>(px) + 0.5f;
  const float y0 = static_cast<float>(py0) + 0.5f, y1 = static_cast<float>(py1) + 0.5f;
  const float4 box = omfs4d::warp_box(x, x, y0, has1 ? y1 : y0);

  const int count = max(0, min(tile_counts[t], K));
  const int* list = tile_lists + static_cast<long long>(t) * K;

  Running s0, s1;
  for (int start = 0; start < count; start += batch) {
    const int n = min(batch, count - start);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int g = list[start + j];
      // lists come from bin_gaussians; an index outside [0, N) is a bug
      // upstream, and a loud fault beats a silent wrong read
      if (static_cast<unsigned>(g) >= static_cast<unsigned>(n_gauss)) __trap();
      const float4 geo = make_float4(uv[2 * g], uv[2 * g + 1], conic[3 * g], conic[3 * g + 1]);
      const float cc = conic[3 * g + 2], o = opacity[g];
      const float4 mat = make_float4(cc, o, rgb[3 * g], rgb[3 * g + 1]);
      const float b = rgb[3 * g + 2];
      s_geo[j] = geo;
      s_mat[j] = mat;
      s_reach[j] = omfs4d::reach_of(geo.x, geo.y, geo.z, geo.w, cc, o, mat.z, mat.w, b);
      s_b[j] = b;
    }
    __syncthreads();
    const int m = omfs4d::reaching(s_reach, n, box, threadIdx.x & 31, s_list);
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const int j = s_list[i];
      const float4 geo = s_geo[j];
      const float4 mat = s_mat[j];
      const float b = s_b[j];
      const Alpha a0 = omfs4d::alpha_of(x, y0, geo.x, geo.y, geo.z, geo.w, mat.x, mat.y);
      const Alpha a1 = omfs4d::alpha_of(x, y1, geo.x, geo.y, geo.z, geo.w, mat.x, mat.y);
      omfs4d::step(s0, a0.a, mat.z, mat.w, b);
      omfs4d::step(s1, a1.a, mat.z, mat.w, b);
    }
    __syncthreads();
  }

  // pixels past the image edge write nothing
  if (has0 && px < width && py0 < height) {
    const long long q = static_cast<long long>(py0) * width + px;
    out_rgb[3 * q] = s0.r;
    out_rgb[3 * q + 1] = s0.g;
    out_rgb[3 * q + 2] = s0.b;
    out_alpha[q] = 1.0f - s0.t;
    if (out_trans != nullptr) out_trans[q] = s0.t;
  }
  if (has1 && px < width && py1 < height) {
    const long long q = static_cast<long long>(py1) * width + px;
    out_rgb[3 * q] = s1.r;
    out_rgb[3 * q + 1] = s1.g;
    out_rgb[3 * q + 2] = s1.b;
    out_alpha[q] = 1.0f - s1.t;
    if (out_trans != nullptr) out_trans[q] = s1.t;
  }
}

}  // namespace

// Launches K1 on `stream`, one block per list row: heavy_first_kernel first
// writes the heaviest-first order of the rows into `order` (T,) int32
// scratch, and K1 takes the rows in that order.  `out_trans` may be null.
// Returns cudaGetLastError() as an int, so a refused launch (bad block
// size, too much shared memory) reaches the caller.
extern "C" int omfs4d_composite_fwd(
    const void* uv, const void* conic, const void* rgb, const void* opacity,
    const void* tile_lists, const void* tile_counts,
    int n_gauss, int n_lists, int K, int tile_base, int tile, int grid_w,
    int width, int height,
    void* out_rgb, void* out_alpha, void* out_trans, void* order, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  heavy_first_kernel<<<1, 1024, static_cast<size_t>(K + 2) * sizeof(int), s>>>(
      static_cast<const int*>(tile_counts), n_lists, K, static_cast<int*>(order));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // whole warps: the reach test takes the box of a warp's pixels
  const int threads = (tile * ((tile + 1) / 2) + 31) / 32 * 32;
  const int batch = K < kMaxBatch ? K : kMaxBatch;
  const size_t smem = static_cast<size_t>(batch) * (3 * sizeof(float4) + sizeof(float) +
                                                    threads / 32 * sizeof(unsigned short));
  composite_fwd_kernel<<<n_lists, threads, smem, s>>>(
      static_cast<const float*>(uv), static_cast<const float*>(conic),
      static_cast<const float*>(rgb), static_cast<const float*>(opacity),
      static_cast<const int*>(tile_lists), static_cast<const int*>(tile_counts),
      static_cast<const int*>(order), n_gauss, K, tile_base, tile, grid_w, width, height,
      batch, static_cast<float*>(out_rgb), static_cast<float*>(out_alpha),
      static_cast<float*>(out_trans));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* omfs4d_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
