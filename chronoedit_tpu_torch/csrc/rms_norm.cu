// K4: RMSNorm across all heads, fp32 statistics, bf16 in and out.
//
// Replaces the Pallas kernel chronoedit_tpu/ops/fused_norms.py
// `_rms_kernel` (launched by `_rms_fwd_impl`).
//
//   out[r, :] = bf16( bf16(x * rsqrt(mean(x^2) + eps)) * w )
//   normalise, cast to bf16, then multiply by the bf16 weight, in that order.
//
// Bound on the H100: bytes. One read and one write of each bf16 row (20 KB
// a row at D = 5120), a few operations an element. Design (row_ring.cuh):
// one persistent block on each SM over a contiguous range of rows, so there
// is no tail wave; the weight row is brought into shared memory once per
// block, not re-read from L2 for every row; a ring of up to 16 row stages
// filled by 1-D bulk copies keeps many rows in flight on each SM (16 at D =
// 5120: 160 KB), and eight consumer warps take one row each, two stages a
// warp: the sum of squares from shared memory (16-byte loads, each lane's
// partial in a fixed order, then a butterfly), then a second pass that
// normalises, rounds, multiplies by the weight and stores 16 bytes a lane.
// No block-wide barrier after set-up.
#include "row_ring.cuh"

namespace {

__global__ void __launch_bounds__(rows::kThreads, 1)
rms_norm_ring_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ out, int n_rows, int D, rows::Shape shape,
                     float eps) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[rows::kMaxStages], empty[rows::kMaxStages], w_bar;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  const rows::Ring ring{full, empty, w_s + D, shape.stages, D};
  const rows::Range range = rows::block_rows(n_rows);
  const int n = range.end - range.begin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    ring.init();
    sm90::mbar_init(&w_bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == rows::kConsumerWarps) {
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&w_bar, D * 2);
      sm90::bulk_load_1d(w_s, w, D * 2, &w_bar);
      for (int j = 0; j < n; ++j)
        ring.load(j, x + static_cast<size_t>(range.begin + j) * D);
    }
    return;
  }
  if (warp >= shape.warps) return;

  const int nvec = D >> 3;
  sm90::mbar_wait(&w_bar, 0);
  for (int j = warp; j < n; j += shape.warps) {
    const __nv_bfloat16* xs = ring.wait(j);
    float sq = 0.f;
#pragma unroll 4
    for (int v = lane; v < nvec; v += 32) {
      float f[8];
      ce::load8(xs + v * 8, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) sq = fmaf(f[e], f[e], sq);
    }
    const float r = rsqrtf(ce::warp_sum(sq) / static_cast<float>(D) + eps);
    __nv_bfloat16* orow = out + static_cast<size_t>(range.begin + j) * D;
#pragma unroll 4
    for (int v = lane; v < nvec; v += 32) {
      float f[8], wv[8];
      ce::load8(xs + v * 8, f);
      ce::load8(w_s + v * 8, wv);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(__float2bfloat16(f[e] * r)) * wv[e];
      ce::store8(orow + v * 8, f);
    }
    ring.release(j);
  }
}

}  // namespace

extern "C" int rms_norm_bf16(const void* x, const void* w, void* out, int rows, int D,
                             float eps, void* stream) {
  const rows::Shape shape = rows::ring_shape(D * 2, D * 2);  // the weight beside the ring
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rms_norm_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, rows::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  int grid = 0;
  const int err = rows::grid_for(rows, &grid);
  if (err != 0) return err;
  const int smem = (1 + shape.stages) * D * 2;
  rms_norm_ring_kernel<<<grid, rows::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), rows, D, shape, eps);
  return static_cast<int>(cudaGetLastError());
}
