// K4: RMSNorm across all heads, fp32 statistics, bf16 in and out; and its
// tensor-parallel form in two passes.
//
// Replaces the Pallas kernel chronoedit_tpu/ops/fused_norms.py
// `_rms_kernel` (launched by `_rms_fwd_impl`), and, under a tensor axis,
// the same file's shard_map branch of `rms_norm_fused`, which completes the
// statistics across the ranks' columns with one psum.
//
//   out[r, :] = bf16( bf16(x * rsqrt(sum(x^2) / D + eps)) * w )
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
//
// Tensor parallelism: a rank holds D / tp of each row's columns. Pass (a),
// `rms_sumsq_bf16`, writes each row's fp32 sum of squares over the local
// columns (the same lane order and butterfly as K4's first pass); the
// caller sums them over the tensor ranks; pass (b), `rms_norm_bf16` given
// those sums (`ss`) and the whole row's width (`d_stat`), skips its own
// first pass and normalises the local columns by them.
#include "row_ring.cuh"

namespace {

// One row's sum of squares from its stage: lane `lane` takes the 16-byte
// vectors lane, lane + 32, ..., in order, then the warp's butterfly. Every
// lane gets the sum.
__device__ __forceinline__ float row_sumsq(const __nv_bfloat16* xs, int nvec, int lane) {
  float sq = 0.f;
#pragma unroll 4
  for (int v = lane; v < nvec; v += 32) {
    float f[8];
    ce::load8(xs + v * 8, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sq = fmaf(f[e], f[e], sq);
  }
  return ce::warp_sum(sq);
}

// `ss`: null for K4 (the statistics from the row itself), else the rows'
// sums of squares over the whole width `d_stat`.
__global__ void __launch_bounds__(rows::kThreads, 1)
rms_norm_ring_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ ss, __nv_bfloat16* __restrict__ out, int n_rows,
                     int D, int d_stat, rows::Shape shape, float eps) {
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
    const float sum = ss == nullptr ? row_sumsq(xs, nvec, lane) : ss[range.begin + j];
    const float r = rsqrtf(sum / static_cast<float>(d_stat) + eps);
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

// Pass (a): each row's fp32 sum of squares into ss[row].
__global__ void __launch_bounds__(rows::kThreads, 1)
rms_sumsq_ring_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ ss, int n_rows,
                      int D, rows::Shape shape) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[rows::kMaxStages], empty[rows::kMaxStages];
  const rows::Ring ring{full, empty, reinterpret_cast<__nv_bfloat16*>(smem), shape.stages, D};
  const rows::Range range = rows::block_rows(n_rows);
  const int n = range.end - range.begin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    ring.init();
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == rows::kConsumerWarps) {
    if (lane == 0)
      for (int j = 0; j < n; ++j)
        ring.load(j, x + static_cast<size_t>(range.begin + j) * D);
    return;
  }
  if (warp >= shape.warps) return;

  const int nvec = D >> 3;
  for (int j = warp; j < n; j += shape.warps) {
    const float sum = row_sumsq(ring.wait(j), nvec, lane);
    ring.release(j);
    if (lane == 0) ss[range.begin + j] = sum;
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, bool* done) {
  if (*done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, rows::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *done = true;
  return 0;
}

}  // namespace

// K4, or pass (b) of its tensor-parallel form when `ss` is given: the rows'
// sums of squares over the whole width `d_stat` (K4 passes d_stat = D).
extern "C" int rms_norm_bf16(const void* x, const void* w, const void* ss, void* out, int rows,
                             int D, int d_stat, float eps, void* stream) {
  const rows::Shape shape = rows::ring_shape(D * 2, D * 2);  // the weight beside the ring
  static bool attr_set = false;
  int err = allow_smem(rms_norm_ring_kernel, &attr_set);
  if (err != 0) return err;
  int grid = 0;
  err = rows::grid_for(rows, &grid);
  if (err != 0) return err;
  const int smem = (1 + shape.stages) * D * 2;
  rms_norm_ring_kernel<<<grid, rows::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(ss), static_cast<__nv_bfloat16*>(out), rows, D, d_stat, shape,
      eps);
  return static_cast<int>(cudaGetLastError());
}

// Pass (a) of K4's tensor-parallel form: ss[row] = sum over the row's D
// local columns of x^2, in fp32.
extern "C" int rms_sumsq_bf16(const void* x, void* ss, int rows, int D, void* stream) {
  const rows::Shape shape = rows::ring_shape(D * 2, 0);
  static bool attr_set = false;
  int err = allow_smem(rms_sumsq_ring_kernel, &attr_set);
  if (err != 0) return err;
  int grid = 0;
  err = rows::grid_for(rows, &grid);
  if (err != 0) return err;
  const int smem = shape.stages * D * 2;
  rms_sumsq_ring_kernel<<<grid, rows::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(ss), rows, D, shape);
  return static_cast<int>(cudaGetLastError());
}
