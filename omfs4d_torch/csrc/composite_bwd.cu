// Backward front-to-back composite of 3DGS tiles (kernel K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel omfs4d/render/pallas_kernels.py::_bwd_kernel
// (with _bwd_body, _alpha_matrix and _suffix_sum).  It computes what that
// kernel computes: from the pixel cotangents dcol (H, W, 3) of the colour
// and dA (H, W) of the alpha that K1 (composite_fwd.cu) returned, for each
// tile, pixel p and list entry k of the tile's depth-sorted list,
//
//   a_full = o * exp(power),  power = min(-(A dx^2 + C dy^2)/2 - B dx dy, 0)
//   a      = min(a_full, 0.99), set to 0 below 1/255
//   T_k    = prod_{j<k} (1 - a_j),  w_k = a_k T_k,  T_tot = prod_j (1 - a_j)
//   dw     = dcol . rgb_k
//   da     = dw T_k - suffix_k / (1 - a_k) + dA T_tot / (1 - a_k),
//            suffix_k = sum_{j>k} dw_j w_j,  1 - a clamped at >= 1e-6,
//            zeroed where a was capped at 0.99 or cut below 1/255
//   d rgb_k += dcol w_k
//   d o_k   += da exp(power)
//   dq = da a_full;  d ux += dq (A dx + B dy),  d uy += dq (C dy + B dx),
//   d A += -dq dx^2/2,  d B += -dq dx dy,  d C += -dq dy^2/2
//
// summed over the tile's pixels, then over every tile whose list holds the
// gaussian.  As in the reference, the uv/conic chain leaves out the
// derivative of the min(power, 0) clamp, and there is no early exit on
// transmittance.
//
// Order of the walk.  CUDA 3DGS walks back to front from the final
// transmittance, recovering T_k = T_{k+1} / (1 - a_k).  With no early exit
// (K = 256, alphas capped at 0.99) T underflows to 0 in f32 after ~20
// saturated entries, and that division then returns 0 for every earlier
// entry.  So this kernel walks FRONT to back twice, as K1 does: a first
// pass recomputes the pixel's T_tot and C_tot = sum_j w_j rgb_j (the
// reference's own choice: recompute, keep no (K, P) residuals), and the
// second keeps a running T_k and C_<=k and uses
// suffix_k = dcol . (C_tot - C_<=k), which is exactly 0 at the last entry
// because both passes add the same terms in the same order.
//
// Layout.  One block per tile, one thread per pixel (tile*tile, rounded up
// to whole warps; the extra threads are pixels with zero cotangent).  The
// block loops to its own count, never to K: padded list entries point at
// gaussian 0, whose gradient must not collect them.  An index outside
// [0, N) traps, as in K1.  Entries are staged through shared memory in
// batches of `batch`.  Per entry each warp sums its 9 per-pixel terms with
// shuffles (skipped when no pixel of the warp has a > 0, which is most of
// them: a gaussian covers a small part of a tile), lane 0 parks the 9 sums
// in shared memory, and after the batch the block adds the warps' sums and
// issues one float atomicAdd per nonzero (entry, row) into the (N, 2),
// (N, 3), (N, 3) and (N,) gradients.  That scatter replaces the reference's
// transpose of the (T, 9, K) gather (one row scatter-add into (N, 9)).
// Atomics add in an order that changes from run to run, so the sums agree
// with the plain version to rounding (tests hold them to the reference's
// own atol 2e-4 * max|grad|, rtol 2e-3).  Pixels past the image edge read
// no cotangent and add nothing.  Gaussians in no list get exactly 0.
//
// What bounds it.  At 512^2 with K = 256 a step is at most
// 1024 tiles x 256 entries x 256 pixels ~ 67 M (pixel, entry) pairs, each
// evaluated twice (~25 + ~60 flops: ~6 GFLOP, ~0.1 ms of the card's f32
// rate), ~9 MB of list-entry reads per pass and up to 1024 x 256 x 9
// atomics (~2.4 M).  The per-entry reductions are the cost: 45 shuffles a
// warp per entry that reaches it, plus a block barrier per batch.  The
// any-lane skip cuts the shuffles to the warps a gaussian actually covers.

#include <cuda_runtime.h>

namespace {

constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kAlphaCap = 0.99f;
constexpr int kRows = 9;  // ux, uy, conic a/b/c, r, g, b, opacity
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

__global__ void composite_bwd_kernel(
    const float* __restrict__ uv,          // (N, 2)
    const float* __restrict__ conic,       // (N, 3)
    const float* __restrict__ rgb,         // (N, 3)
    const float* __restrict__ opacity,     // (N,)
    const int* __restrict__ tile_lists,    // (T, K)
    const int* __restrict__ tile_counts,   // (T,)
    const float* __restrict__ dimg,        // (H, W, 3)
    const float* __restrict__ dalpha,      // (H, W)
    int n_gauss, int K, int tile_base, int tile, int grid_w,
    int width, int height, int batch,
    float* __restrict__ d_uv,              // (N, 2), zeroed by the caller
    float* __restrict__ d_conic,           // (N, 3)
    float* __restrict__ d_rgb,             // (N, 3)
    float* __restrict__ d_opacity) {       // (N,)
  extern __shared__ float smem[];
  const int n_warps = blockDim.x >> 5;
  // staged entries: 9 rows of `batch`, then the per-warp partial sums
  // part[(warp * batch + j) * 9 + row]
  float* s_ux = smem;
  float* s_uy = smem + batch;
  float* s_ca = smem + 2 * batch;
  float* s_cb = smem + 3 * batch;
  float* s_cc = smem + 4 * batch;
  float* s_r = smem + 5 * batch;
  float* s_g = smem + 6 * batch;
  float* s_b = smem + 7 * batch;
  float* s_o = smem + 8 * batch;
  int* s_idx = reinterpret_cast<int*>(smem + kRows * batch);
  float* part = smem + (kRows + 1) * batch;

  const int t = blockIdx.x;
  const int tid = t + tile_base;
  const int p = threadIdx.x;
  const int P = tile * tile;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int px = (tid % grid_w) * tile + p % tile;
  const int py = (tid / grid_w) * tile + p / tile;
  const float x = static_cast<float>(px) + 0.5f;
  const float y = static_cast<float>(py) + 0.5f;

  // this pixel's cotangents: 0 for threads past the tile and pixels past
  // the image edge (K1 never wrote them)
  float dr = 0.0f, dg = 0.0f, db = 0.0f, dA = 0.0f;
  if (p < P && px < width && py < height) {
    const long long i = static_cast<long long>(py) * width + px;
    dr = dimg[3 * i];
    dg = dimg[3 * i + 1];
    db = dimg[3 * i + 2];
    dA = dalpha[i];
  }

  const int count = max(0, min(tile_counts[t], K));
  const int* list = tile_lists + static_cast<long long>(t) * K;

  auto stage = [&](int start, int n) {
    for (int j = p; j < n; j += blockDim.x) {
      const int g = list[start + j];
      if (static_cast<unsigned>(g) >= static_cast<unsigned>(n_gauss)) __trap();
      s_idx[j] = g;
      s_ux[j] = uv[2 * g];
      s_uy[j] = uv[2 * g + 1];
      s_ca[j] = conic[3 * g];
      s_cb[j] = conic[3 * g + 1];
      s_cc[j] = conic[3 * g + 2];
      s_r[j] = rgb[3 * g];
      s_g[j] = rgb[3 * g + 1];
      s_b[j] = rgb[3 * g + 2];
      s_o[j] = opacity[g];
    }
  };

  // pass 1: the pixel's final transmittance and colour, as K1 computes them
  float t_tot = 1.0f, cr_tot = 0.0f, cg_tot = 0.0f, cb_tot = 0.0f;
  for (int start = 0; start < count; start += batch) {
    const int n = min(batch, count - start);
    stage(start, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = x - s_ux[j];
      const float dy = y - s_uy[j];
      const float power = fminf(
          -0.5f * (s_ca[j] * dx * dx + s_cc[j] * dy * dy) - s_cb[j] * dx * dy,
          0.0f);
      float a = fminf(s_o[j] * expf(power), kAlphaCap);
      if (a < kAlphaCutoff) a = 0.0f;
      const float w = a * t_tot;
      cr_tot += w * s_r[j];
      cg_tot += w * s_g[j];
      cb_tot += w * s_b[j];
      t_tot *= 1.0f - a;
    }
    __syncthreads();
  }

  // pass 2: per-entry gradients, summed over the tile's pixels
  float trans = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  for (int start = 0; start < count; start += batch) {
    const int n = min(batch, count - start);
    stage(start, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = x - s_ux[j];
      const float dy = y - s_uy[j];
      const float ca = s_ca[j], cbq = s_cb[j], cc = s_cc[j];
      const float power =
          fminf(-0.5f * (ca * dx * dx + cc * dy * dy) - cbq * dx * dy, 0.0f);
      const float e = expf(power);
      const float a_full = s_o[j] * e;
      const bool capped = a_full > kAlphaCap;
      float a = capped ? kAlphaCap : a_full;
      const bool cut = a < kAlphaCutoff;
      if (cut) a = 0.0f;
      float* out = part + (warp * batch + j) * kRows;
      if (!__any_sync(kFull, a > 0.0f)) {
        // no pixel of this warp sees the entry: every term is 0
        if (lane == 0) {
          for (int r = 0; r < kRows; ++r) out[r] = 0.0f;
        }
        continue;
      }
      const float w = a * trans;
      cr += w * s_r[j];
      cg += w * s_g[j];
      cb += w * s_b[j];
      const float one_minus = fmaxf(1.0f - a, 1e-6f);
      const float dw = dr * s_r[j] + dg * s_g[j] + db * s_b[j];
      const float suffix =
          dr * (cr_tot - cr) + dg * (cg_tot - cg) + db * (cb_tot - cb);
      float da = dw * trans - suffix / one_minus + dA * t_tot / one_minus;
      if (capped || cut) da = 0.0f;
      const float dq = da * a_full;
      float v[kRows];
      v[0] = dq * (ca * dx + cbq * dy);
      v[1] = dq * (cc * dy + cbq * dx);
      v[2] = dq * (-0.5f * dx * dx);
      v[3] = dq * (-dx * dy);
      v[4] = dq * (-0.5f * dy * dy);
      v[5] = dr * w;
      v[6] = dg * w;
      v[7] = db * w;
      v[8] = da * e;
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = warp_sum(v[r]);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) out[r] = v[r];
      }
      trans *= 1.0f - a;
    }
    __syncthreads();
    // add the warps' sums and scatter them into the (N, .) gradients
    for (int q = p; q < n * kRows; q += blockDim.x) {
      const int j = q / kRows;
      const int r = q - j * kRows;
      float s = 0.0f;
      for (int wi = 0; wi < n_warps; ++wi) s += part[(wi * batch + j) * kRows + r];
      if (s != 0.0f) {
        const int g = s_idx[j];
        float* dst = r < 2 ? d_uv + 2 * g + r
                   : r < 5 ? d_conic + 3 * g + (r - 2)
                   : r < 8 ? d_rgb + 3 * g + (r - 5)
                           : d_opacity + g;
        atomicAdd(dst, s);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches one block per list row on `stream`; the four gradient buffers
// must be zeroed first.  Returns cudaGetLastError() as an int, so a
// refused launch reaches the caller.
extern "C" int omfs4d_composite_bwd(
    const void* uv, const void* conic, const void* rgb, const void* opacity,
    const void* tile_lists, const void* tile_counts,
    const void* dimg, const void* dalpha,
    int n_gauss, int n_lists, int K, int tile_base, int tile, int grid_w,
    int width, int height,
    void* d_uv, void* d_conic, void* d_rgb, void* d_opacity, void* stream) {
  const int threads = (tile * tile + 31) / 32 * 32;
  const int n_warps = threads / 32;
  const int batch = n_warps > 16 ? 32 : 64;
  const size_t smem =
      static_cast<size_t>((kRows + 1) * batch + n_warps * batch * kRows) *
      sizeof(float);
  composite_bwd_kernel<<<n_lists, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uv), static_cast<const float*>(conic),
      static_cast<const float*>(rgb), static_cast<const float*>(opacity),
      static_cast<const int*>(tile_lists), static_cast<const int*>(tile_counts),
      static_cast<const float*>(dimg), static_cast<const float*>(dalpha),
      n_gauss, K, tile_base, tile, grid_w, width, height, batch,
      static_cast<float*>(d_uv), static_cast<float*>(d_conic),
      static_cast<float*>(d_rgb), static_cast<float*>(d_opacity));
  return static_cast<int>(cudaGetLastError());
}
