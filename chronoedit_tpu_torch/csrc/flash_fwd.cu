// K1 and K5: non-causal flash-attention forward, bf16 in, bf16 out + fp32 LSE.
//
// Replaces the Pallas kernels chronoedit_tpu/ops/flash_attention.py
// `_fwd_kernel_resident` (K1: KV resident in VMEM, the edit's 7,200 tokens
// and the cross-attention) and `_fwd_kernel_streamed` (K5: KV streamed
// through the grid, reasoning self-attention at 28,800 tokens), both
// launched by `_forward`. The TPU split follows VMEM's size; this kernel
// streams KV tiles through shared memory at every length, so one kernel
// covers both. At 28,800 tokens the grid is (225, B*H) and every offset is
// computed in size_t.
//
//   O[b, s, h, :] = softmax(scale * q k^T) v,  LSE[b, h, s] = logsumexp(scale * q k^T)
//   q (B, Sq, H, 128), k/v (B, Skv, H, 128), all contiguous BSHD.
//
// Bound on the H100: tensor-core FLOPs. Self-attention at 720p is
// 4 * 7200^2 * 128 FLOPs per head against ~5.5 MB of q/k/v per head, far
// above the card's ~295 FLOP/byte ridge; the cross-attention calls
// (KV 512 and 257) are small and bound by reading q and writing O.
//
// Design (the simple, correct first version; wgmma/TMA is later work):
// - one 256-thread block (8 warps) per (b*h, 128-row q tile); each warp owns
//   16 q rows, held in registers as mma.sync A fragments for the whole run;
// - a loop over 64-row KV tiles staged in shared memory by plain 16-byte
//   loads (rows past Skv are zero-filled, so padded V never meets a NaN);
// - S = q k^T with mma.sync m16n8k16 bf16 -> fp32; the softmax scale (times
//   log2 e) is applied to the fp32 scores; columns past Skv are set to
//   -inf (the 257-token CLIP context is ragged);
// - online softmax in fp32 (running row max and row sum), P rounded to bf16
//   for the P v product, as the TPU kernel does, with fp32 accumulation;
// - rows past Sq (7,200 is not a multiple of 128) are computed on zeros and
//   never written.
// The KV tile is loaded once per block and read by all 8 warps, so device
// memory traffic is (Sq / 128) passes over K and V per head.
//
// X1: the grouped forward, `flash_fwd_grouped_kernel<N>` behind
// `flash_fwd_grouped_bf16(..., group)`, N = 2, 3 or 4. Replaces the Pallas
// kernel tools/exp_flash_paired.py `_grouped_kernel` (launched by
// `paired_flash`), whose design became the TPU's production streamed
// forward (`_fwd_kernel_streamed` with `group`). Same function as K1/K5,
// same bound. Each step stages N 64-row KV tiles behind one barrier pair,
// issues all N x 8 score tiles before any softmax work, takes one combined
// row max and one alpha, rescales the accumulator once (a 1/N share of
// K1's rescale multiplies) and then runs the N P.V products. The q
// fragments are read from shared memory at every step instead of held in
// registers: the N score tiles (32 N fp32 a thread) need the room. K1's
// numerics are kept (fp32 scores scaled by scale * log2 e, masking in the
// kernel, P rounded to bf16, fp32 LSE); only the running max a tile's P is
// taken against differs, so outputs agree with K1's to bf16 rounding.
// Dynamic shared memory (128 + 2 N 64) * 136 * 2 B: 104,448 (N = 2),
// 139,264 (3), 174,080 (4); ptxas -v (sm_90a): 179, 250 and 255 registers
// a thread, no spills (K1: 173); one block of 8 warps per SM.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kBQ = 128;
constexpr int kBKV = 64;
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;  // padded smem row (bf16): conflict-free fragment reads
constexpr int kSmemBytes = (kBQ + 2 * kBKV) * kLd * 2;

using ce::lds32;
using ce::mma_16816;
using ce::pack_bf16;

template <int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          size_t row_stride, int row0,
                                          int limit) {
  ce::load_rows<kRows, kD, kLd, kThreads>(tile, base, row_stride, row0, limit);
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int H, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * kLd;
  __nv_bfloat16* vs = ks + kBKV * kLd;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * kD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Skv * H + h) * kD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Skv * H + h) * kD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair

  load_tile<kBQ>(qs, qb, row_stride, q0, Sq);
  __syncthreads();

  // this warp's 16 q rows as A fragments, one per 16-wide slice of D
  uint32_t qa[kD / 16][4];
  {
    const __nv_bfloat16* r0 = qs + (warp * 16 + g) * kLd + t4 * 2;
    const __nv_bfloat16* r1 = r0 + 8 * kLd;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      qa[kk][0] = lds32(r0 + kk * 16);
      qa[kk][1] = lds32(r1 + kk * 16);
      qa[kk][2] = lds32(r0 + kk * 16 + 8);
      qa[kk][3] = lds32(r1 + kk * 16 + 8);
    }
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (log2 domain) and this thread's partial row sums, rows g and g+8
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int kv0 = 0; kv0 < Skv; kv0 += kBKV) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<kBKV>(ks, kb, row_stride, kv0, Skv);
    load_tile<kBKV>(vs, vb, row_stride, kv0, Skv);
    __syncthreads();

    float s[kBKV / 8][4];
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * kLd + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        mma_16816(s[n], qa[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + n * 8 + t4 * 2 + (e & 1);
        s[n][e] = col < Skv ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
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
      const __nv_bfloat16* v0 = vs + (kc * 16 + t4 * 2) * kLd + g;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const __nv_bfloat16* vp = v0 + n * 8;
        const uint32_t b0 = pack_bf16(vp[0], vp[kLd]);
        const uint32_t b1 = pack_bf16(vp[8 * kLd], vp[9 * kLd]);
        mma_16816(acc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float ln2 = 0.6931471805599453f;
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
    if (t4 == 0)
      lse[static_cast<size_t>(bh) * Sq + row] = (m_run[r] + log2f(l_run[r])) * ln2;
  }
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Skv, int H,
                              int D, float scale, void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Skv, H, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- X1

namespace {

template <int N>
__global__ void __launch_bounds__(kThreads)
flash_fwd_grouped_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                         int Sq, int Skv, int H, float scale_log2) {
  constexpr int kStep = N * kBKV;  // KV rows a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * kLd;
  __nv_bfloat16* vs = ks + kStep * kLd;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * kD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Skv * H + h) * kD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Skv * H + h) * kD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  load_tile<kBQ>(qs, qb, row_stride, q0, Sq);
  const __nv_bfloat16* q_r0 = qs + (warp * 16 + g) * kLd + t4 * 2;
  const __nv_bfloat16* q_r1 = q_r0 + 8 * kLd;

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int kv0 = 0; kv0 < Skv; kv0 += kStep) {
    __syncthreads();  // every warp is done with the previous group (and q landed)
    ce::load_rows<kStep, kD, kLd, kThreads>(ks, kb, row_stride, kv0, Skv);
    ce::load_rows<kStep, kD, kLd, kThreads>(vs, vb, row_stride, kv0, Skv);
    __syncthreads();

    // all N x 8 score tiles first; each accumulates over D in K1's order
    float s[N][kBKV / 8][4];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n) s[i][n][0] = s[i][n][1] = s[i][n][2] = s[i][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qa[4];
      qa[0] = lds32(q_r0 + kk * 16);
      qa[1] = lds32(q_r1 + kk * 16);
      qa[2] = lds32(q_r0 + kk * 16 + 8);
      qa[3] = lds32(q_r1 + kk * 16 + 8);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int n = 0; n < kBKV / 8; ++n) {
          const __nv_bfloat16* kr = ks + (i * kBKV + n * 8 + g) * kLd + t4 * 2 + kk * 16;
          mma_16816(s[i][n], qa, lds32(kr), lds32(kr + 8));
        }
    }

    // one combined row max over the N tiles, one alpha, one rescale
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + i * kBKV + n * 8 + t4 * 2 + (e & 1);
          s[i][n][e] = col < Skv ? s[i][n][e] * scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[i][n][e]);
        }
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
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][n][e] = exp2f(s[i][n][e] - base[e >> 1]);
          l_run[e >> 1] += s[i][n][e];
        }

    // O += P_i V_i for the N tiles
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int kc = 0; kc < kBKV / 16; ++kc) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[i][2 * kc][0], s[i][2 * kc][1]);
        pa[1] = pack_bf16(s[i][2 * kc][2], s[i][2 * kc][3]);
        pa[2] = pack_bf16(s[i][2 * kc + 1][0], s[i][2 * kc + 1][1]);
        pa[3] = pack_bf16(s[i][2 * kc + 1][2], s[i][2 * kc + 1][3]);
        const __nv_bfloat16* v0 = vs + (i * kBKV + kc * 16 + t4 * 2) * kLd + g;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          const __nv_bfloat16* vp = v0 + n * 8;
          const uint32_t b0 = pack_bf16(vp[0], vp[kLd]);
          const uint32_t b1 = pack_bf16(vp[8 * kLd], vp[9 * kLd]);
          mma_16816(acc[n], pa, b0, b1);
        }
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float ln2 = 0.6931471805599453f;
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
    if (t4 == 0)
      lse[static_cast<size_t>(bh) * Sq + row] = (m_run[r] + log2f(l_run[r])) * ln2;
  }
}

template <int N>
int launch_grouped(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int Sq, int Skv, int H, float scale, void* stream) {
  constexpr int kSmem = (kBQ + 2 * N * kBKV) * kLd * 2;
  static bool attr_set = false;  // one flag per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_grouped_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_grouped_kernel<N><<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Skv, H, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X1: q (B, Sq, H, 128), k/v (B, Skv, H, 128) bf16 -> o like q, lse (B, H, Sq)
// fp32; `group` KV tiles of 64 rows a step, 2, 3 or 4.
extern "C" int flash_fwd_grouped_bf16(const void* q, const void* k, const void* v,
                                      void* o, void* lse, int B, int Sq, int Skv,
                                      int H, int D, float scale, int group,
                                      void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  switch (group) {
    case 2: return launch_grouped<2>(q, k, v, o, lse, B, Sq, Skv, H, scale, stream);
    case 3: return launch_grouped<3>(q, k, v, o, lse, B, Sq, Skv, H, scale, stream);
    case 4: return launch_grouped<4>(q, k, v, o, lse, B, Sq, Skv, H, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
