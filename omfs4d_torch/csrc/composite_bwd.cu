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
// One pass.  CUDA 3DGS walks back to front from T_tot, recovering
// T_k = T_{k+1} / (1 - a_k); with no early exit (K = 256, alphas capped at
// 0.99) T underflows to 0 in f32 after ~20 saturated entries and that
// division returns 0 for every earlier entry.  So K2 walks front to back,
// once: it reads each pixel's C_tot (the forward's image before any
// background) and T_tot (the residual K1 writes), keeps a running T_k and
// C_<=k with the alpha and step of composite_common.cuh, and takes
// suffix_k = dcol . (C_tot - C_<=k).  K1 added the same terms in the same
// order, so the suffix is exactly 0 at each pixel's last entry.
//
// Layout.  One block per tile, one thread per pixel (tile*tile, rounded up
// to whole warps; the extra threads are pixels with zero cotangent), in the
// heaviest-first order K1 wrote (composite_fwd.cu, "Tiles").  The block
// loops to its own count, never to K: padded list entries point at
// gaussian 0, whose gradient must not collect them.  An index outside
// [0, N) traps, as in K1.  Up to 256 entries (the whole list at K = 256)
// are staged at a time as 16-byte records (ux, uy, A, B), (C, o, r, g),
// (b, index) and the entry's reach box (composite_common.cuh, reach_of), so
// a tile syncs twice per batch and not twice per 32 entries.  Each warp
// walks only the entries whose reach box meets the box of its 32 pixels,
// listed as in K1 (~56% of them at a training frame), and skips an entry on
// which no pixel of it inside the image has a > 0 (`__any_sync`): a
// gaussian covers a small part of a tile.  (With that skip alone K2 took
// 5-10% longer at a 512^2 frame, and with a box test per entry in the walk
// 22-26% longer: the lists take the box tests out of the walk.)  Otherwise
// the warp sums its 9 per-pixel terms in one multi-value exchange
// (`warp_sum9`, 14 shuffles where 9 shuffle trees take 45), which leaves
// the 9 sums on 9 distinct lanes, and those lanes add them into the batch's
// (entry, 9) accumulator in shared memory with float atomics
// (red.shared.add.f32).  After the batch, one global float atomicAdd per
// nonzero (entry, row) scatters into the (N, 9) gradient, which replaces
// the reference's transpose of the (T, 9, K) gather.  Atomics add in an
// order that changes from run to run, so the sums agree with the plain
// version to rounding (tests hold them to the reference's own atol
// 2e-4 * max|grad|, rtol 2e-3).  Pixels past the image edge read no
// cotangent and add nothing.  Gaussians in no list get exactly 0.
//
// What bounds it.  At a 512^2 training frame (T = 1024, K = 256) the lists
// hold ~25 M (pixel, entry) pairs.  The function needs the alpha (~16 FP32
// instructions) at the ~7.8 M of them whose pixel lies in the entry's reach
// box, and the step, the chain and the sums (~50) at the ~4.8 M live ones
// (a > 0): ~11 us of FP32 issue, against ~3 us of memory.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using omfs4d::Alpha;
using omfs4d::Running;
using omfs4d::kFull;
using omfs4d::kRows;

constexpr int kMaxBatch = 256;  // entries staged at a time

__global__ void composite_bwd_kernel(
    const float* __restrict__ uv,          // (N, 2)
    const float* __restrict__ conic,       // (N, 3)
    const float* __restrict__ rgb,         // (N, 3)
    const float* __restrict__ opacity,     // (N,)
    const int* __restrict__ tile_lists,    // (T, K)
    const int* __restrict__ tile_counts,   // (T,)
    const float* __restrict__ dimg,        // (H, W, 3)
    const float* __restrict__ dalpha,      // (H, W)
    const float* __restrict__ img,         // (H, W, 3) the forward's C_tot
    const float* __restrict__ trans,       // (H, W) the forward's T_tot
    const int* __restrict__ order,         // (T,) list rows in launch order (K1's)
    int n_gauss, int K, int tile_base, int tile, int grid_w,
    int width, int height, int batch,
    float* __restrict__ grad) {            // (N, 9), zeroed by the caller
  extern __shared__ float4 smem4[];
  float4* s_geo = smem4;                                        // ux, uy, A, B
  float4* s_mat = smem4 + batch;                                // C, o, r, g
  float4* s_reach = smem4 + 2 * batch;                          // x0, x1, y0, y1
  float2* s_tail = reinterpret_cast<float2*>(smem4 + 3 * batch);  // b, index bits
  float* s_acc = reinterpret_cast<float*>(s_tail + batch);      // (batch, 9)
  unsigned short* s_list =                                      // per warp: entries that reach it
      reinterpret_cast<unsigned short*>(s_acc + batch * kRows) + (threadIdx.x >> 5) * batch;

  const int t = order[blockIdx.x];
  const int tid = t + tile_base;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int px = (tid % grid_w) * tile + p % tile;
  const int py = (tid / grid_w) * tile + p / tile;
  const float x = static_cast<float>(px) + 0.5f;
  const float y = static_cast<float>(py) + 0.5f;
  const float4 box = omfs4d::warp_box(x, x, y, y);

  // this pixel's cotangents and residuals: none for threads past the tile
  // and pixels past the image edge (K1 never wrote them)
  const bool inside = p < tile * tile && px < width && py < height;
  float dr = 0.0f, dg = 0.0f, db = 0.0f, dA = 0.0f;
  float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f, t_tot = 1.0f;  // C_tot, T_tot
  if (inside) {
    const long long i = static_cast<long long>(py) * width + px;
    dr = dimg[3 * i];
    dg = dimg[3 * i + 1];
    db = dimg[3 * i + 2];
    dA = dalpha[i];
    tot_r = img[3 * i];
    tot_g = img[3 * i + 1];
    tot_b = img[3 * i + 2];
    t_tot = trans[i];
  }
  const float dA_t = dA * t_tot;

  const int count = max(0, min(tile_counts[t], K));
  const int* list = tile_lists + static_cast<long long>(t) * K;

  Running s;
  for (int start = 0; start < count; start += batch) {
    const int n = min(batch, count - start);
    for (int j = p; j < n; j += blockDim.x) {
      const int g = list[start + j];
      if (static_cast<unsigned>(g) >= static_cast<unsigned>(n_gauss)) __trap();
      const float4 geo = make_float4(uv[2 * g], uv[2 * g + 1], conic[3 * g], conic[3 * g + 1]);
      const float cc = conic[3 * g + 2], o = opacity[g];
      const float4 mat = make_float4(cc, o, rgb[3 * g], rgb[3 * g + 1]);
      const float b = rgb[3 * g + 2];
      s_geo[j] = geo;
      s_mat[j] = mat;
      s_reach[j] = omfs4d::reach_of(geo.x, geo.y, geo.z, geo.w, cc, o, mat.z, mat.w, b);
      s_tail[j] = make_float2(b, __int_as_float(g));
#pragma unroll
      for (int r = 0; r < kRows; ++r) s_acc[j * kRows + r] = 0.0f;
    }
    __syncthreads();
    const int m = omfs4d::reaching(s_reach, n, box, lane, s_list);
    for (int i = 0; i < m; ++i) {
      const int j = s_list[i];
      const float4 geo = s_geo[j];
      const float4 mat = s_mat[j];
      const Alpha al = omfs4d::alpha_of(x, y, geo.x, geo.y, geo.z, geo.w, mat.x, mat.y);
      // a = 0 leaves the running state as it was, and every term 0
      if (!__any_sync(kFull, inside && al.a > 0.0f)) continue;
      const float cr = mat.z, cg = mat.w, cb = s_tail[j].x;
      const float t_k = s.t;
      const float w = omfs4d::step(s, al.a, cr, cg, cb);
      // one reciprocal, not two IEEE divisions: (dA T_tot - suffix) / (1 - a)
      const float inv = __frcp_rn(fmaxf(1.0f - al.a, 1e-6f));
      const float dw = dr * cr + dg * cg + db * cb;
      const float suffix = dr * (tot_r - s.r) + dg * (tot_g - s.g) + db * (tot_b - s.b);
      float da = __fmaf_rn(dA_t - suffix, inv, dw * t_k);
      if (al.capped || al.cut) da = 0.0f;
      const float dq = da * al.a_full;
      const float ca = geo.z, cbq = geo.w, cc = mat.x;
      float v[kRows];
      v[0] = dq * (ca * al.dx + cbq * al.dy);
      v[1] = dq * (cc * al.dy + cbq * al.dx);
      v[2] = dq * (-0.5f * al.dx * al.dx);
      v[3] = dq * (-al.dx * al.dy);
      v[4] = dq * (-0.5f * al.dy * al.dy);
      v[5] = dr * w;
      v[6] = dg * w;
      v[7] = db * w;
      v[8] = da * al.e;
      float mine, last;
      omfs4d::warp_sum9(v, lane, mine, last);
      float* acc = s_acc + j * kRows;
      if ((lane & 3) == 0) atomicAdd(acc + (lane >> 2), mine);
      if (lane == 1) atomicAdd(acc + 8, last);
    }
    __syncthreads();
    // scatter the batch's sums into the (N, 9) gradient
    for (int q = p; q < n * kRows; q += blockDim.x) {
      const float v = s_acc[q];
      if (v != 0.0f) {
        const int j = q / kRows;
        const int g = __float_as_int(s_tail[j].y);
        atomicAdd(grad + static_cast<long long>(g) * kRows + (q - j * kRows), v);
      }
    }
    if (start + batch < count) __syncthreads();  // before the next batch is staged
  }
}

}  // namespace

// Launches one block per list row on `stream`, in `order` (the
// heaviest-first order K1 wrote); `grad` (N, 9) must be zeroed first.
// `img` and `trans` are the colour and final transmittance K1 wrote for
// these lists.  Returns cudaGetLastError() as an int, so a refused launch
// reaches the caller.
extern "C" int omfs4d_composite_bwd(
    const void* uv, const void* conic, const void* rgb, const void* opacity,
    const void* tile_lists, const void* tile_counts,
    const void* dimg, const void* dalpha, const void* img, const void* trans,
    const void* order, int n_gauss, int n_lists, int K, int tile_base, int tile, int grid_w,
    int width, int height, void* grad, void* stream) {
  const int threads = (tile * tile + 31) / 32 * 32;
  const int batch = K < kMaxBatch ? K : kMaxBatch;
  const size_t smem = static_cast<size_t>(batch) *
                      (3 * sizeof(float4) + sizeof(float2) + kRows * sizeof(float) +
                       threads / 32 * sizeof(unsigned short));
  composite_bwd_kernel<<<n_lists, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uv), static_cast<const float*>(conic),
      static_cast<const float*>(rgb), static_cast<const float*>(opacity),
      static_cast<const int*>(tile_lists), static_cast<const int*>(tile_counts),
      static_cast<const float*>(dimg), static_cast<const float*>(dalpha),
      static_cast<const float*>(img), static_cast<const float*>(trans),
      static_cast<const int*>(order), n_gauss, K, tile_base, tile, grid_w, width, height,
      batch, static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}
