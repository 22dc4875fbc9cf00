// K6 and K7: non-causal flash-attention backward, bf16 in, bf16 out.
//
// Replace the Pallas kernels chronoedit_tpu/ops/flash_attention.py
// `_dq_kernel` (K6) and `_dkv_kernel` (K7), both launched by `_backward`.
// Given the forward's q, k, v, its bf16 output O, the cotangent dO, the
// forward's natural-log LSE and dsum = rowsum(dO * O) (fp32, computed by the
// wrapper with one torch reduction, as JAX computes it outside its kernels):
//
//   P  = exp(scale * q k^T - lse)       (recomputed, never stored)
//   dP = dO v^T
//   dS = P * (dP - dsum) * scale
//   K6: dQ = dS k          K7: dK = dS^T q,  dV = P^T dO
//
// All tensors are read in place, BSHD through strides: q, dO, O (B, Sq, H,
// 128), k, v (B, Skv, H, 128); lse and dsum are (B, H, Sq) fp32. Arithmetic
// as JAX does it: fp32 scores with the scale applied to them (not to a bf16
// q), P and dS rounded to bf16 before the products that consume them, fp32
// accumulation. Inside, exponentials are exp2 with log2(e) folded into both
// the scale and the LSE.
//
// Bound on the H100: tensor-core FLOPs. At the 720p self-attention shape
// (7,200 x 7,200, 40 heads x 128) K6 does 3 products of 2*7200^2*128 FLOPs a
// head (S, dP, dS k: 1.59 TFLOP) and K7 4 (S^T, dP^T, P^T dO, dS^T q: 2.12
// TFLOP) against ~8 MB of operands a head; the cross-attention calls (KV 512
// and 257) are small and K6's is bound by reading q, dO and writing dQ.
//
// No atomics: each output row is owned by one block, so the backward is
// deterministic and a remat recompute gives the same gradients every run.
//
// Design (the simple, correct first version; wgmma/TMA is later work):
// - K6: one 256-thread block (8 warps) per (b*h, 128-row q tile); q and dO
//   of the tile stay in shared memory; a loop over 64-row KV tiles staged in
//   shared memory by plain 16-byte loads (rows past Skv zero-filled, and
//   their P set to 0: KV 257 is ragged); each warp owns 16 q rows and keeps
//   their dQ in fp32 registers, written once at the end. Rows past Sq (7,200
//   is not a multiple of 128) are computed on zeros and never written.
// - K7: one 256-thread block per (b*h, 128-row KV tile); k and v of the
//   tile stay in shared memory; a loop over 32-row q tiles (q, dO, and their
//   lse and dsum staged in shared memory; q rows past Sq carry lse = +inf,
//   so their P and dS are 0); each warp owns 16 KV rows and keeps their dK
//   and dV in fp32 registers (128 a thread), written once.
// - products are mma.sync m16n8k16 bf16 -> fp32; fragments are read from
//   shared memory (32-bit loads, or pairs of 16-bit loads where the operand
//   is transposed).
// - resources (ptxas -v, CUDA 12.8, sm_90a): K6 238 registers a thread, K7
//   242, no spills; dynamic shared memory 104,448 B (K6) and 87,296 B (K7).
//   The registers allow one 256-thread block per SM, so a block's loads are
//   not hidden behind another block's products: the first lever for speed.
//
// X2: the grouped backward, the same function as K6/K7. Replaces the Pallas
// kernels tools/exp_flash_bwd_grouped.py `_dq_kernel_grouped` and
// `_dkv_kernel_grouped` (launched by `grouped_backward`).
// - `flash_bwd_dq_grouped_kernel<N>`: K6 with N 64-row KV tiles a step
//   behind one barrier pair; all N x 8 S and dP tiles are issued before the
//   exp chain, then each tile's dS and dQ += dS k in K6's order.
// - `flash_bwd_dkv_grouped_kernel<N>`: K7 with N 32-row q tiles a step (and
//   their lse and dsum; q rows past Sq carry lse = +inf); all N x 4 S^T and
//   dP^T tiles first, then each tile's P^T, dS^T and the dV, dK products.
// N = 2 or 4; one tile a step is K6/K7 itself, which the wrapper launches
// for a side whose group is 1. Every output element accumulates the same
// products in the same order as K6/K7. The hoisted S and dP tiles hold
// 64 N (dQ) or 32 N (dK, dV) fp32 a thread: ptxas -v (sm_90a) gives dQ
// 252 / 255 registers for N = 2 / 4, with 2,252 B of spill stores at N = 4,
// and dK/dV 254 / 255, with 212 B at N = 4; no spills at N = 2.
// Dynamic shared memory: dQ (2 * 128 + 2 N 64) * 136 * 2 B (139,264 /
// 208,896 B), dK/dV (2 * 128 + 2 N 32) * 136 * 2 + 2 N 32 * 4 B (104,960 /
// 140,288 B).
#include <math.h>

#include "common.cuh"

namespace {

using ce::lds32;
using ce::mma_16816;
using ce::pack_bf16;

constexpr int kD = 128;
constexpr int kLd = kD + 8;  // padded smem row (bf16): conflict-free fragment reads
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

// K6 tiles: 128 q rows (16 per warp) x 64 KV rows per step
constexpr int kBQ6 = kWarps * 16;
constexpr int kBKV6 = 64;
constexpr int kSmem6 = (2 * kBQ6 + 2 * kBKV6) * kLd * 2;
// K7 tiles: 128 KV rows (16 per warp) x 32 q rows per step
constexpr int kBKV7 = kWarps * 16;
constexpr int kBQ7 = 32;
constexpr int kSmem7 = (2 * kBKV7 + 2 * kBQ7) * kLd * 2 + 2 * kBQ7 * 4;

template <int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          size_t row_stride, int row0,
                                          int limit) {
  ce::load_rows<kRows, kD, kLd, kThreads>(tile, base, row_stride, row0, limit);
}

// A fragment (16 x 16, rows r0 / r0 + 8, columns kk*16..) of a smem tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* r0,
                                       int kk) {
  const __nv_bfloat16* r1 = r0 + 8 * kLd;
  a[0] = lds32(r0 + kk * 16);
  a[1] = lds32(r1 + kk * 16);
  a[2] = lds32(r0 + kk * 16 + 8);
  a[3] = lds32(r1 + kk * 16 + 8);
}

// B fragment (16 x 8) of a row-major [k][n] smem tile, read transposed:
// `p` points at row k0 + 2*t4, column n0 + g
__device__ __forceinline__ void load_bt(uint32_t& b0, uint32_t& b1,
                                        const __nv_bfloat16* p) {
  b0 = pack_bf16(p[0], p[kLd]);
  b1 = pack_bf16(p[8 * kLd], p[9 * kLd]);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dq,
                    int Sq, int Skv, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kBQ6 * kLd;
  __nv_bfloat16* ks = dos + kBQ6 * kLd;
  __nv_bfloat16* vs = ks + kBKV6 * kLd;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ6;
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * kD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Skv * H + h) * kD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Skv * H + h) * kD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;

  load_tile<kBQ6>(qs, q + q_off, row_stride, q0, Sq);
  load_tile<kBQ6>(dos, dout + q_off, row_stride, q0, Sq);

  // this thread's rows g and g + 8 of the warp's 16
  float lse2[2], ds_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    const bool live = row < Sq;
    lse2[r] = live ? lse[static_cast<size_t>(bh) * Sq + row] * kLog2e : INFINITY;
    ds_row[r] = live ? dsum[static_cast<size_t>(bh) * Sq + row] : 0.f;
  }
  const __nv_bfloat16* q_r0 = qs + (warp * 16 + g) * kLd + t4 * 2;
  const __nv_bfloat16* do_r0 = dos + (warp * 16 + g) * kLd + t4 * 2;

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += kBKV6) {
    __syncthreads();  // every warp is done with the previous tile (and q/dO landed)
    load_tile<kBKV6>(ks, kb, row_stride, kv0, Skv);
    load_tile<kBKV6>(vs, vb, row_stride, kv0, Skv);
    __syncthreads();

    // S = q k^T and dP = dO v^T for this warp's 16 rows x 64 KV columns
    float s[kBKV6 / 8][4], dp[kBKV6 / 8][4];
#pragma unroll
    for (int n = 0; n < kBKV6 / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, q_r0, kk);
      load_a(da, do_r0, kk);
#pragma unroll
      for (int n = 0; n < kBKV6 / 8; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * kLd + t4 * 2 + kk * 16;
        const __nv_bfloat16* vr = vs + (n * 8 + g) * kLd + t4 * 2 + kk * 16;
        mma_16816(s[n], qa, lds32(kr), lds32(kr + 8));
        mma_16816(dp[n], da, lds32(vr), lds32(vr + 8));
      }
    }

    // dS = P (dP - dsum) scale, P = 0 on KV columns past Skv
#pragma unroll
    for (int n = 0; n < kBKV6 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + n * 8 + t4 * 2 + (e & 1);
        const float p = col < Skv ? exp2f(s[n][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - ds_row[e >> 1]) * scale;
      }
    }

    // dQ += dS k: two 8-column dS tiles form one k=16 A fragment (bf16)
#pragma unroll
    for (int kc = 0; kc < kBKV6 / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* k0 = ks + (kc * 16 + t4 * 2) * kLd + g;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        uint32_t b0, b1;
        load_bt(b0, b1, k0 + n * 8);
        mma_16816(acc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* out = dq + q_off + static_cast<size_t>(row) * row_stride + t4 * 2;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     int Sq, int Skv, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBKV7 * kLd;
  __nv_bfloat16* qs = vs + kBKV7 * kLd;
  __nv_bfloat16* dos = qs + kBQ7 * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kBQ7 * kLd);
  float* dsum_s = lse_s + kBQ7;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kv0 = blockIdx.x * kBKV7;
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const size_t kv_off = (static_cast<size_t>(b) * Skv * H + h) * kD;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * kD;
  const __nv_bfloat16* dob = dout + (static_cast<size_t>(b) * Sq * H + h) * kD;
  const float* lse_b = lse + static_cast<size_t>(bh) * Sq;
  const float* dsum_b = dsum + static_cast<size_t>(bh) * Sq;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;

  load_tile<kBKV7>(ks, k + kv_off, row_stride, kv0, Skv);
  load_tile<kBKV7>(vs, v + kv_off, row_stride, kv0, Skv);
  const __nv_bfloat16* k_r0 = ks + (warp * 16 + g) * kLd + t4 * 2;
  const __nv_bfloat16* v_r0 = vs + (warp * 16 + g) * kLd + t4 * 2;

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kBQ7) {
    __syncthreads();  // every warp is done with the previous q tile
    load_tile<kBQ7>(qs, qb, row_stride, q0, Sq);
    load_tile<kBQ7>(dos, dob, row_stride, q0, Sq);
    if (threadIdx.x < kBQ7) {
      const int row = q0 + threadIdx.x;
      const bool live = row < Sq;
      lse_s[threadIdx.x] = live ? lse_b[row] * kLog2e : INFINITY;
      dsum_s[threadIdx.x] = live ? dsum_b[row] : 0.f;
    }
    __syncthreads();

    // S^T = k q^T and dP^T = v dO^T: this warp's 16 KV rows x 32 q columns
    float st[kBQ7 / 8][4], dpt[kBQ7 / 8][4];
#pragma unroll
    for (int n = 0; n < kBQ7 / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, k_r0, kk);
      load_a(va, v_r0, kk);
#pragma unroll
      for (int n = 0; n < kBQ7 / 8; ++n) {
        const __nv_bfloat16* qr = qs + (n * 8 + g) * kLd + t4 * 2 + kk * 16;
        const __nv_bfloat16* dr = dos + (n * 8 + g) * kLd + t4 * 2 + kk * 16;
        mma_16816(st[n], ka, lds32(qr), lds32(qr + 8));
        mma_16816(dpt[n], va, lds32(dr), lds32(dr + 8));
      }
    }

    // P^T, and dS^T = P^T (dP^T - dsum) scale; padded q columns give 0
#pragma unroll
    for (int n = 0; n < kBQ7 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t4 * 2 + (e & 1);
        const float p = exp2f(st[n][e] * scale_log2 - lse_s[col]);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dsum_s[col]) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T q: k = 16 q rows per fragment (bf16)
#pragma unroll
    for (int kc = 0; kc < kBQ7 / 16; ++kc) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(st[2 * kc][0], st[2 * kc][1]);
      pa[1] = pack_bf16(st[2 * kc][2], st[2 * kc][3]);
      pa[2] = pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]);
      pa[3] = pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3]);
      sa[0] = pack_bf16(dpt[2 * kc][0], dpt[2 * kc][1]);
      sa[1] = pack_bf16(dpt[2 * kc][2], dpt[2 * kc][3]);
      sa[2] = pack_bf16(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]);
      sa[3] = pack_bf16(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3]);
      const __nv_bfloat16* d0 = dos + (kc * 16 + t4 * 2) * kLd + g;
      const __nv_bfloat16* q0p = qs + (kc * 16 + t4 * 2) * kLd + g;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        uint32_t b0, b1;
        load_bt(b0, b1, d0 + n * 8);
        mma_16816(dv_acc[n], pa, b0, b1);
        load_bt(b0, b1, q0p + n * 8);
        mma_16816(dk_acc[n], sa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv0 + warp * 16 + g + r * 8;
    if (row >= Skv) continue;
    const size_t off = kv_off + static_cast<size_t>(row) * row_stride + t4 * 2;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

}  // namespace

// dQ (B, Sq, H, 128) bf16. lse, dsum (B, H, Sq) fp32.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dsum, void* dq, int B, int Sq,
                                 int Skv, int H, int D, float scale,
                                 void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel, kSmem6, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ6 - 1) / kBQ6, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, kSmem6, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// dK, dV (B, Skv, H, 128) bf16. lse, dsum (B, H, Sq) fp32.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* dsum, void* dk, void* dv, int B,
                                  int Sq, int Skv, int H, int D, float scale,
                                  void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  const cudaError_t err = allow_smem(flash_bwd_dkv_kernel, kSmem7, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Skv + kBKV7 - 1) / kBKV7, B * H);
  flash_bwd_dkv_kernel<<<grid, kThreads, kSmem7, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Skv, H,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- X2

namespace {

template <int N>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_grouped_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dsum,
                            __nv_bfloat16* __restrict__ dq,
                            int Sq, int Skv, int H, float scale) {
  constexpr int kStep = N * kBKV6;  // KV rows a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kBQ6 * kLd;
  __nv_bfloat16* ks = dos + kBQ6 * kLd;
  __nv_bfloat16* vs = ks + kStep * kLd;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ6;
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * kD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Skv * H + h) * kD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Skv * H + h) * kD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;

  load_tile<kBQ6>(qs, q + q_off, row_stride, q0, Sq);
  load_tile<kBQ6>(dos, dout + q_off, row_stride, q0, Sq);

  float lse2[2], ds_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    const bool live = row < Sq;
    lse2[r] = live ? lse[static_cast<size_t>(bh) * Sq + row] * kLog2e : INFINITY;
    ds_row[r] = live ? dsum[static_cast<size_t>(bh) * Sq + row] : 0.f;
  }
  const __nv_bfloat16* q_r0 = qs + (warp * 16 + g) * kLd + t4 * 2;
  const __nv_bfloat16* do_r0 = dos + (warp * 16 + g) * kLd + t4 * 2;

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += kStep) {
    __syncthreads();  // every warp is done with the previous group (and q/dO landed)
    ce::load_rows<kStep, kD, kLd, kThreads>(ks, kb, row_stride, kv0, Skv);
    ce::load_rows<kStep, kD, kLd, kThreads>(vs, vb, row_stride, kv0, Skv);
    __syncthreads();

    // every S = q k_i^T and dP = dO v_i^T tile of the group first
    float s[N][kBKV6 / 8][4], dp[N][kBKV6 / 8][4];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int n = 0; n < kBKV6 / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][n][e] = dp[i][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, q_r0, kk);
      load_a(da, do_r0, kk);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int n = 0; n < kBKV6 / 8; ++n) {
          const int r = i * kBKV6 + n * 8 + g;
          const __nv_bfloat16* kr = ks + r * kLd + t4 * 2 + kk * 16;
          const __nv_bfloat16* vr = vs + r * kLd + t4 * 2 + kk * 16;
          mma_16816(s[i][n], qa, lds32(kr), lds32(kr + 8));
          mma_16816(dp[i][n], da, lds32(vr), lds32(vr + 8));
        }
    }

    // then, tile by tile: dS = P (dP - dsum) scale (P = 0 past Skv), dQ += dS k_i
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int n = 0; n < kBKV6 / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + i * kBKV6 + n * 8 + t4 * 2 + (e & 1);
          const float p = col < Skv ? exp2f(s[i][n][e] * scale_log2 - lse2[e >> 1]) : 0.f;
          s[i][n][e] = p * (dp[i][n][e] - ds_row[e >> 1]) * scale;
        }
#pragma unroll
      for (int kc = 0; kc < kBKV6 / 16; ++kc) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[i][2 * kc][0], s[i][2 * kc][1]);
        pa[1] = pack_bf16(s[i][2 * kc][2], s[i][2 * kc][3]);
        pa[2] = pack_bf16(s[i][2 * kc + 1][0], s[i][2 * kc + 1][1]);
        pa[3] = pack_bf16(s[i][2 * kc + 1][2], s[i][2 * kc + 1][3]);
        const __nv_bfloat16* k0 = ks + (i * kBKV6 + kc * 16 + t4 * 2) * kLd + g;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          uint32_t b0, b1;
          load_bt(b0, b1, k0 + n * 8);
          mma_16816(acc[n], pa, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* out = dq + q_off + static_cast<size_t>(row) * row_stride + t4 * 2;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_grouped_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dsum,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv,
                             int Sq, int Skv, int H, float scale) {
  constexpr int kStep = N * kBQ7;  // q rows a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBKV7 * kLd;
  __nv_bfloat16* qs = vs + kBKV7 * kLd;
  __nv_bfloat16* dos = qs + kStep * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kStep * kLd);
  float* dsum_s = lse_s + kStep;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kv0 = blockIdx.x * kBKV7;
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const size_t kv_off = (static_cast<size_t>(b) * Skv * H + h) * kD;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * kD;
  const __nv_bfloat16* dob = dout + (static_cast<size_t>(b) * Sq * H + h) * kD;
  const float* lse_b = lse + static_cast<size_t>(bh) * Sq;
  const float* dsum_b = dsum + static_cast<size_t>(bh) * Sq;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;

  load_tile<kBKV7>(ks, k + kv_off, row_stride, kv0, Skv);
  load_tile<kBKV7>(vs, v + kv_off, row_stride, kv0, Skv);
  const __nv_bfloat16* k_r0 = ks + (warp * 16 + g) * kLd + t4 * 2;
  const __nv_bfloat16* v_r0 = vs + (warp * 16 + g) * kLd + t4 * 2;

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kStep) {
    __syncthreads();  // every warp is done with the previous group
    ce::load_rows<kStep, kD, kLd, kThreads>(qs, qb, row_stride, q0, Sq);
    ce::load_rows<kStep, kD, kLd, kThreads>(dos, dob, row_stride, q0, Sq);
    if (threadIdx.x < kStep) {
      const int row = q0 + threadIdx.x;
      const bool live = row < Sq;
      lse_s[threadIdx.x] = live ? lse_b[row] * kLog2e : INFINITY;
      dsum_s[threadIdx.x] = live ? dsum_b[row] : 0.f;
    }
    __syncthreads();

    // every S^T = k q_i^T and dP^T = v dO_i^T tile of the group first
    float st[N][kBQ7 / 8][4], dpt[N][kBQ7 / 8][4];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int n = 0; n < kBQ7 / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][n][e] = dpt[i][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, k_r0, kk);
      load_a(va, v_r0, kk);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int n = 0; n < kBQ7 / 8; ++n) {
          const int r = i * kBQ7 + n * 8 + g;
          const __nv_bfloat16* qr = qs + r * kLd + t4 * 2 + kk * 16;
          const __nv_bfloat16* dr = dos + r * kLd + t4 * 2 + kk * 16;
          mma_16816(st[i][n], ka, lds32(qr), lds32(qr + 8));
          mma_16816(dpt[i][n], va, lds32(dr), lds32(dr + 8));
        }
    }

    // then, tile by tile: P^T, dS^T, dV += P^T dO_i, dK += dS^T q_i
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int n = 0; n < kBQ7 / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = i * kBQ7 + n * 8 + t4 * 2 + (e & 1);
          const float p = exp2f(st[i][n][e] * scale_log2 - lse_s[col]);
          st[i][n][e] = p;
          dpt[i][n][e] = p * (dpt[i][n][e] - dsum_s[col]) * scale;
        }
#pragma unroll
      for (int kc = 0; kc < kBQ7 / 16; ++kc) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16(st[i][2 * kc][0], st[i][2 * kc][1]);
        pa[1] = pack_bf16(st[i][2 * kc][2], st[i][2 * kc][3]);
        pa[2] = pack_bf16(st[i][2 * kc + 1][0], st[i][2 * kc + 1][1]);
        pa[3] = pack_bf16(st[i][2 * kc + 1][2], st[i][2 * kc + 1][3]);
        sa[0] = pack_bf16(dpt[i][2 * kc][0], dpt[i][2 * kc][1]);
        sa[1] = pack_bf16(dpt[i][2 * kc][2], dpt[i][2 * kc][3]);
        sa[2] = pack_bf16(dpt[i][2 * kc + 1][0], dpt[i][2 * kc + 1][1]);
        sa[3] = pack_bf16(dpt[i][2 * kc + 1][2], dpt[i][2 * kc + 1][3]);
        const int r = i * kBQ7 + kc * 16 + t4 * 2;
        const __nv_bfloat16* d0 = dos + r * kLd + g;
        const __nv_bfloat16* q0p = qs + r * kLd + g;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          uint32_t b0, b1;
          load_bt(b0, b1, d0 + n * 8);
          mma_16816(dv_acc[n], pa, b0, b1);
          load_bt(b0, b1, q0p + n * 8);
          mma_16816(dk_acc[n], sa, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv0 + warp * 16 + g + r * 8;
    if (row >= Skv) continue;
    const size_t off = kv_off + static_cast<size_t>(row) * row_stride + t4 * 2;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <int N>
int launch_dq_grouped(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dsum, void* dq, int B, int Sq,
                      int Skv, int H, float scale, void* stream) {
  constexpr int kSmem = (2 * kBQ6 + 2 * N * kBKV6) * kLd * 2;
  static bool attr_set = false;  // one flag per instantiation
  const cudaError_t err = allow_smem(flash_bwd_dq_grouped_kernel<N>, kSmem, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ6 - 1) / kBQ6, B * H);
  flash_bwd_dq_grouped_kernel<N><<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_dkv_grouped(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dsum, void* dk, void* dv, int B,
                       int Sq, int Skv, int H, float scale, void* stream) {
  constexpr int kSmem = (2 * kBKV7 + 2 * N * kBQ7) * kLd * 2 + 2 * N * kBQ7 * 4;
  static bool attr_set = false;  // one flag per instantiation
  const cudaError_t err = allow_smem(flash_bwd_dkv_grouped_kernel<N>, kSmem, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Skv + kBKV7 - 1) / kBKV7, B * H);
  flash_bwd_dkv_grouped_kernel<N><<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Skv, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X2 dQ: as flash_bwd_dq_bf16, `group` 64-row KV tiles a step (2 or 4).
extern "C" int flash_bwd_dq_grouped_bf16(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse,
                                         const void* dsum, void* dq, int B, int Sq,
                                         int Skv, int H, int D, float scale, int group,
                                         void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  switch (group) {
    case 2: return launch_dq_grouped<2>(q, k, v, dout, lse, dsum, dq, B, Sq, Skv, H, scale, stream);
    case 4: return launch_dq_grouped<4>(q, k, v, dout, lse, dsum, dq, B, Sq, Skv, H, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// X2 dK, dV: as flash_bwd_dkv_bf16, `group` 32-row q tiles a step (2 or 4).
extern "C" int flash_bwd_dkv_grouped_bf16(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* dsum, void* dk, void* dv, int B,
                                          int Sq, int Skv, int H, int D, float scale,
                                          int group, void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  switch (group) {
    case 2:
      return launch_dkv_grouped<2>(q, k, v, dout, lse, dsum, dk, dv, B, Sq, Skv, H, scale, stream);
    case 4:
      return launch_dkv_grouped<4>(q, k, v, dout, lse, dsum, dk, dv, B, Sq, Skv, H, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
