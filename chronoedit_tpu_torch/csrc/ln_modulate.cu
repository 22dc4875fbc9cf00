// K2: LayerNorm (no affine) + per-frame AdaLN modulate, bf16 in and out.
//
// Replaces the Pallas kernel chronoedit_tpu/ops/fused_norms.py
// `_lnmod_kernel` (launched by `_lnmod_fwd_impl`).
//
//   out[b, s, :] = bf16( (x - mean) * rsqrt(var + eps) * (1 + scale[b, t]) + shift[b, t] )
//   with t = s / hw, statistics over the row in fp32.
//
// Bound on the H100: bytes. Per row of D = 5120 it reads 10 KB of x and
// writes 10 KB, a few dozen FLOPs per element; the (B, T, D) fp32 scale
// and shift rows are shared by the hw = 3,600 rows of a frame and stay in
// L2. Design: one 128-thread block per row; each thread keeps its slice of
// the row in registers (16-byte vector loads, 8 bf16 each), so x is read
// from device memory once. Two block reductions give the mean and then the
// centred variance, the same two-pass formula as the plain version.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxVec = 8;  // vectors of 8 per thread: D <= 8192

__global__ void __launch_bounds__(kThreads)
ln_modulate_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   __nv_bfloat16* __restrict__ out, int T, int hw, int D,
                   float eps) {
  const int row = blockIdx.x;
  const int s_len = T * hw;
  const int b = row / s_len;
  const int t = (row % s_len) / hw;
  const int nvec = D / 8;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * D;

  float v[kMaxVec][8];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      ce::load8(xr + i * 8, v[k]);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[k][j];
    }
  }
  const float mean = ce::block_sum<kThreads>(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[k][j] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(ce::block_sum<kThreads>(sq) / D + eps);

  const size_t mod = (static_cast<size_t>(b) * T + t) * D;
  __nv_bfloat16* orow = out + static_cast<size_t>(row) * D;
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
      float sc[8], sh[8], o[8];
      ce::load8f(scale + mod + i * 8, sc);
      ce::load8f(shift + mod + i * 8, sh);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = (v[k][j] - mean) * rstd * (1.f + sc[j]) + sh[j];
      ce::store8(orow + i * 8, o);
    }
  }
}

}  // namespace

extern "C" int ln_modulate_bf16(const void* x, const void* scale,
                                const void* shift, void* out, int rows, int T,
                                int hw, int D, float eps, void* stream) {
  ln_modulate_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(out), T,
      hw, D, eps);
  return static_cast<int>(cudaGetLastError());
}
