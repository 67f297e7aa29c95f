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
// with pixel centres at +0.5 and tile id = block index + tile_base.  The TPU
// kernel recasts the prefix products as log-space triangular matmuls for its
// matrix unit; here each pixel thread walks its list front to back and keeps
// the running transmittance in a register, in f32.  There is no early exit
// on transmittance (CUDA 3DGS stops at T < 1e-4; the reference does not).
//
// Layout.  One block per tile, tile*tile threads (256 at tile = 16), one
// thread per pixel.  The block reads its own count (never K: padded list
// entries point at gaussian 0).  In batches of blockDim entries each thread
// gathers one list entry's uv, conic, rgb and opacity straight from the
// (N, .) tensors into shared memory; this replaces the (T, 9, K) gather
// `_pack_lists` that the JAX package does before the TPU kernel.  Then every
// pixel thread reads the batch from shared memory.  The kernel writes the
// (H, W, 3) colour and (H, W) alpha directly (replacing `assemble_tiles` and
// the crop), masking pixels past the image edge.  It allocates nothing, does
// not synchronise and launches on the stream it is given.
//
// What bounds it.  At 512^2 with K = 256 a frame is at most
// 1024 tiles x 256 entries x 256 pixels ~ 67 M alpha evaluations (~20 flops
// each, ~1.3 GFLOP: ~20 us of the card's f32 rate) and ~9 MB of list-entry
// reads (9 floats + 1 index per entry: ~3 us of its memory bandwidth).
// Neither rate is the limit: the time goes to latency, i.e. the dependent
// index -> parameter gathers and the serial per-pixel chain through expf and
// the transmittance product.  The shared-memory staging gathers each entry
// once per tile instead of once per pixel (256x fewer dependent global
// loads) and serves it to all 256 threads as a same-address broadcast, so
// the inner loop runs from shared memory and registers alone.

#include <cuda_runtime.h>

namespace {

constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kAlphaCap = 0.99f;
constexpr int kRows = 9;  // ux, uy, conic a/b/c, r, g, b, opacity

__global__ void composite_fwd_kernel(
    const float* __restrict__ uv,          // (N, 2)
    const float* __restrict__ conic,       // (N, 3)
    const float* __restrict__ rgb,         // (N, 3)
    const float* __restrict__ opacity,     // (N,)
    const int* __restrict__ tile_lists,    // (T, K)
    const int* __restrict__ tile_counts,   // (T,)
    int n_gauss, int K, int tile_base, int tile, int grid_w,
    int width, int height,
    float* __restrict__ out_rgb,           // (H, W, 3)
    float* __restrict__ out_alpha) {       // (H, W)
  extern __shared__ float smem[];
  const int P = blockDim.x;
  float* s_ux = smem;
  float* s_uy = smem + P;
  float* s_ca = smem + 2 * P;
  float* s_cb = smem + 3 * P;
  float* s_cc = smem + 4 * P;
  float* s_r = smem + 5 * P;
  float* s_g = smem + 6 * P;
  float* s_b = smem + 7 * P;
  float* s_o = smem + 8 * P;

  const int t = blockIdx.x;
  const int tid = t + tile_base;
  const int p = threadIdx.x;
  const int px = (tid % grid_w) * tile + p % tile;
  const int py = (tid / grid_w) * tile + p / tile;
  const float x = static_cast<float>(px) + 0.5f;
  const float y = static_cast<float>(py) + 0.5f;

  const int count = max(0, min(tile_counts[t], K));
  const int* list = tile_lists + static_cast<long long>(t) * K;

  float trans = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  for (int start = 0; start < count; start += P) {
    const int n = min(P, count - start);
    if (p < n) {
      const int g = list[start + p];
      // lists come from bin_gaussians; an index outside [0, N) is a bug
      // upstream, and a loud fault beats a silent wrong read
      if (static_cast<unsigned>(g) >= static_cast<unsigned>(n_gauss)) __trap();
      s_ux[p] = uv[2 * g];
      s_uy[p] = uv[2 * g + 1];
      s_ca[p] = conic[3 * g];
      s_cb[p] = conic[3 * g + 1];
      s_cc[p] = conic[3 * g + 2];
      s_r[p] = rgb[3 * g];
      s_g[p] = rgb[3 * g + 1];
      s_b[p] = rgb[3 * g + 2];
      s_o[p] = opacity[g];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = x - s_ux[j];
      const float dy = y - s_uy[j];
      const float power = fminf(
          -0.5f * (s_ca[j] * dx * dx + s_cc[j] * dy * dy) - s_cb[j] * dx * dy,
          0.0f);
      float a = fminf(s_o[j] * expf(power), kAlphaCap);
      if (a < kAlphaCutoff) a = 0.0f;
      const float w = a * trans;
      cr += w * s_r[j];
      cg += w * s_g[j];
      cb += w * s_b[j];
      trans *= 1.0f - a;
    }
    __syncthreads();
  }

  if (px < width && py < height) {
    const long long i = static_cast<long long>(py) * width + px;
    out_rgb[3 * i] = cr;
    out_rgb[3 * i + 1] = cg;
    out_rgb[3 * i + 2] = cb;
    out_alpha[i] = 1.0f - trans;
  }
}

}  // namespace

// Launches one block per list row on `stream`.  Returns cudaGetLastError()
// as an int, so a refused launch (bad block size, too much shared memory)
// reaches the caller.
extern "C" int omfs4d_composite_fwd(
    const void* uv, const void* conic, const void* rgb, const void* opacity,
    const void* tile_lists, const void* tile_counts,
    int n_gauss, int n_lists, int K, int tile_base, int tile, int grid_w,
    int width, int height, void* out_rgb, void* out_alpha, void* stream) {
  const int P = tile * tile;
  const size_t smem = static_cast<size_t>(kRows) * P * sizeof(float);
  composite_fwd_kernel<<<n_lists, P, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uv), static_cast<const float*>(conic),
      static_cast<const float*>(rgb), static_cast<const float*>(opacity),
      static_cast<const int*>(tile_lists), static_cast<const int*>(tile_counts),
      n_gauss, K, tile_base, tile, grid_w, width, height,
      static_cast<float*>(out_rgb), static_cast<float*>(out_alpha));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* omfs4d_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
