// K9: non-causal flash-attention forward with int8 scores, bf16 P.V, bf16 out.
//
// Replaces the Pallas kernel chronoedit_tpu/ops/flash_attention.py
// `_fwd_kernel_streamed_qk8` (launched by `_forward_qk8` for
// `flash_attention_qk_int8`). The wrapper (ops/flash_attention.py) makes
// the inputs as JAX does outside its kernel: q quantized per token, k
// mean-centred over the sequence (exact: softmax ignores a per-row shift)
// and quantized per token, both with fp32 scales.
//
//   O[b, s, h, :] = softmax(S) v,  S[i, j] = float(q8_i . k8_j) * (qs_i * scale) * ks_j
//   q8 (B, Sq, H, 128) int8, k8 (B, Skv, H, 128) int8, v (B, Skv, H, 128) bf16,
//   qs (B, Sq, H) fp32, ks (B, Skv, H) fp32, all contiguous; O like q in bf16.
//
// Bound on the H100: tensor-core operations. At the reasoning shape (28,800
// tokens, 40 heads) the s8 score products are 8.5e12 operations at the
// int8 rate (1,979 TOPS) and P.V as many at the bf16 rate (989 TFLOP/s):
// 12.9 ms, against ~0.3 ms for reading q8, k8, v and writing O.
//
// Design (K1's structure, csrc/flash_fwd.cu; simple and correct first, int8
// wgmma and TMA are later work):
// - one 256-thread block (8 warps) per (b*h, 128-row q tile); each warp
//   keeps its 16 q rows as int8 A fragments in registers for the whole run;
// - a loop over 64-row KV tiles: k8 and v rows and the tile's 64 k scales
//   staged in shared memory by 16-byte loads (rows past Skv are zeros);
// - scores with mma.sync m16n8k32 s8 x s8 -> s32 (k8's rows are
//   D-contiguous: the "col" operand), dequantized in JAX's order
//   (float(acc) * (qs * scale)) * ks; columns past Skv are -inf;
// - online softmax in fp32 in the log2 domain, as K1; P rounded to bf16
//   for P.V (mma.sync m16n8k16, fp32 accumulation), as the TPU kernel does;
// - rows past Sq are computed on zeros and never written. No LSE: JAX's
//   int8-score forward returns only O.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kBQ = 128;
constexpr int kBKV = 64;
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLd8 = kD + 16;  // int8 row pitch in bytes (36 words): conflict-free fragment reads
constexpr int kLdV = kD + 8;   // bf16 row pitch for V, as K1's
constexpr float kLog2e = 1.4426950408889634f;

using ce::mma_16816;
using ce::pack_bf16;

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A B with A 16x32 (row), B 32x8 (col), s8 in, s32 accumulate.
__device__ __forceinline__ void mma_16832_s8(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kRows rows of 128 int8 from a row-strided tensor into a tile of pitch
// kLd8, zero-filling rows at or past `limit`.
template <int kRows>
__device__ __forceinline__ void load_i8(int8_t* tile, const int8_t* base, size_t row_stride,
                                        int row0, int limit) {
  constexpr int kVecPerRow = kD / 16;
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(base + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(tile + r * kLd8 + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_qk8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ qs,
                     const float* __restrict__ ks, __nv_bfloat16* __restrict__ o,
                     int Sq, int Skv, int H, float scale) {
  __shared__ __align__(16) int8_t q_tile[kBQ * kLd8];
  __shared__ __align__(16) int8_t k_tile[kBKV * kLd8];
  __shared__ __align__(16) __nv_bfloat16 v_tile[kBKV * kLdV];
  __shared__ float ks_tile[kBKV];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const int8_t* qb = q8 + (static_cast<size_t>(b) * Sq * H + h) * kD;
  const int8_t* kb = k8 + (static_cast<size_t>(b) * Skv * H + h) * kD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Skv * H + h) * kD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column group

  load_i8<kBQ>(q_tile, qb, row_stride, q0, Sq);
  __syncthreads();

  // this warp's 16 q rows as s8 A fragments, one per 32-wide slice of D
  uint32_t qa[kD / 32][4];
  {
    const int8_t* r0 = q_tile + (warp * 16 + g) * kLd8 + t4 * 4;
    const int8_t* r1 = r0 + 8 * kLd8;
#pragma unroll
    for (int kk = 0; kk < kD / 32; ++kk) {
      qa[kk][0] = lds32(r0 + kk * 32);
      qa[kk][1] = lds32(r1 + kk * 32);
      qa[kk][2] = lds32(r0 + kk * 32 + 16);
      qa[kk][3] = lds32(r1 + kk * 32 + 16);
    }
  }
  // the per-row dequantization factor qs * scale of rows g and g + 8
  float row_mult[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    row_mult[r] = row < Sq ? qs[(static_cast<size_t>(b) * Sq + row) * H + h] * scale : 0.f;
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (log2 domain) and this thread's partial row sums, rows g and g+8
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int kv0 = 0; kv0 < Skv; kv0 += kBKV) {
    __syncthreads();  // every warp is done with the previous tile
    load_i8<kBKV>(k_tile, kb, row_stride, kv0, Skv);
    ce::load_rows<kBKV, kD, kLdV, kThreads>(v_tile, vb, row_stride, kv0, Skv);
    if (threadIdx.x < kBKV) {
      const int col = kv0 + threadIdx.x;
      ks_tile[threadIdx.x] = col < Skv ? ks[(static_cast<size_t>(b) * Skv + col) * H + h] : 0.f;
    }
    __syncthreads();

    float s[kBKV / 8][4];
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n) {
      int si[4] = {0, 0, 0, 0};
      const int8_t* kr = k_tile + (n * 8 + g) * kLd8 + t4 * 4;
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk)
        mma_16832_s8(si, qa[kk], lds32(kr + kk * 32), lds32(kr + kk * 32 + 16));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + t4 * 2 + (e & 1);
        s[n][e] = kv0 + c < Skv
                      ? static_cast<float>(si[e]) * row_mult[e >> 1] * ks_tile[c] * kLog2e
                      : -INFINITY;
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m_run[r] - base[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - base[e >> 1]);
        l_run[e >> 1] += s[n][e];
      }
    }

    // O += P V: two 8-column score tiles form one k=16 A fragment
#pragma unroll
    for (int kc = 0; kc < kBKV / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* v0 = v_tile + (kc * 16 + t4 * 2) * kLdV + g;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const __nv_bfloat16* vp = v0 + n * 8;
        const uint32_t b0 = pack_bf16(vp[0], vp[kLdV]);
        const uint32_t b1 = pack_bf16(vp[8 * kLdV], vp[9 * kLdV]);
        mma_16816(acc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    const float inv = 1.f / l_run[r];
    __nv_bfloat16* orow = o + (static_cast<size_t>(b) * Sq + row) * row_stride +
                          static_cast<size_t>(h) * kD + t4 * 2;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

}  // namespace

extern "C" int flash_fwd_qk8_bf16(const void* q8, const void* k8, const void* v,
                                  const void* qs, const void* ks, void* o, int B, int Sq,
                                  int Skv, int H, int D, float scale, void* stream) {
  if (D != kD || B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_qk8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(qs),
      static_cast<const float*>(ks), static_cast<__nv_bfloat16*>(o), Sq, Skv, H, scale);
  return static_cast<int>(cudaGetLastError());
}
