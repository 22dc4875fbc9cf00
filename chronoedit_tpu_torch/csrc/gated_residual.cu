// K3: gated residual x + delta * gate[b, t], fp32 arithmetic, bf16 out.
//
// Replaces the Pallas kernel chronoedit_tpu/ops/fused_norms.py
// `_gate_kernel` (launched by `_gate_fwd_impl`).
//
// Bound on the H100: bytes. Two bf16 reads and one bf16 write per element
// and two FLOPs; the (B, T, D) fp32 gate is shared by the hw rows of a
// frame and stays in L2. Design: a grid-stride loop over 16-byte vectors
// (8 elements) of the flattened (B*S, D) stream, so every warp reads and
// writes whole 512-byte runs. The multiply and the add round separately
// (no fused multiply-add), as the plain version's two fp32 ops do.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gated_residual_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ delta,
                      const float* __restrict__ gate,
                      __nv_bfloat16* __restrict__ out, size_t total_vec, int T,
                      int hw, int D) {
  const int nvec = D / 8;
  const size_t s_len = static_cast<size_t>(T) * hw;
  for (size_t idx = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       idx < total_vec; idx += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t row = idx / nvec;
    const int c = static_cast<int>(idx % nvec) * 8;
    const size_t b = row / s_len;
    const size_t t = (row % s_len) / hw;
    float xv[8], dv[8], g[8], o[8];
    ce::load8(x + row * D + c, xv);
    ce::load8(delta + row * D + c, dv);
    ce::load8f(gate + (b * T + t) * D + c, g);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __fadd_rn(xv[j], __fmul_rn(dv[j], g[j]));
    ce::store8(out + row * D + c, o);
  }
}

}  // namespace

extern "C" int gated_residual_bf16(const void* x, const void* delta,
                                   const void* gate, void* out, int rows, int T,
                                   int hw, int D, void* stream) {
  const size_t total_vec = static_cast<size_t>(rows) * (D / 8);
  const size_t want = (total_vec + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  gated_residual_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(delta), static_cast<const float*>(gate),
      static_cast<__nv_bfloat16*>(out), total_vec, T, hw, D);
  return static_cast<int>(cudaGetLastError());
}
