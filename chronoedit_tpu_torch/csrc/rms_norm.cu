// K4: RMSNorm across all heads, fp32 statistics, bf16 in and out.
//
// Replaces the Pallas kernel chronoedit_tpu/ops/fused_norms.py
// `_rms_kernel` (launched by `_rms_fwd_impl`).
//
//   out[r, :] = bf16( bf16(x * rsqrt(mean(x^2) + eps)) * w )
//   normalise, cast to bf16, then multiply by the bf16 weight, in that order.
//
// Bound on the H100: bytes. One read and one write of a D = 5120 bf16 row;
// the weight row stays in L1/L2. Design: one 128-thread block per row, the
// row held in registers (16-byte vector loads), one block reduction for the
// sum of squares.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxVec = 8;  // D <= 8192

__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ out, int D, float eps) {
  const int nvec = D / 8;
  const __nv_bfloat16* xr = x + static_cast<size_t>(blockIdx.x) * D;
  float v[kMaxVec][8];
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      ce::load8(xr + i * 8, v[k]);
#pragma unroll
      for (int j = 0; j < 8; ++j) sq += v[k][j] * v[k][j];
    }
  }
  const float r = rsqrtf(ce::block_sum<kThreads>(sq) / D + eps);
  __nv_bfloat16* orow = out + static_cast<size_t>(blockIdx.x) * D;
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      float wv[8], o[8];
      ce::load8(w + i * 8, wv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float y = __bfloat162float(__float2bfloat16(v[k][j] * r));
        o[j] = y * wv[j];
      }
      ce::store8(orow + i * 8, o);
    }
  }
}

}  // namespace

extern "C" int rms_norm_bf16(const void* x, const void* w, void* out, int rows,
                             int D, float eps, void* stream) {
  rms_norm_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out), D,
      eps);
  return static_cast<int>(cudaGetLastError());
}
