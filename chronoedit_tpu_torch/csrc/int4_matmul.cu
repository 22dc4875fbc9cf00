// K8: y = x @ dequant(W) for the w4a16 linear, bf16 x, int4 W, fp32 sums.
//
// Replaces the Pallas kernel chronoedit_tpu/ops/int4_matmul.py `_kernel`
// (launched by `int4_matmul`). The JAX package runs it only on one TPU, for
// the uniform grid and behind CHRONOEDIT_INT4_KERNEL=1; here it serves every
// int4 linear on the card, on both grids: the dequantized weight is
// table[q + 7] * scale, and the uniform grid's table holds -7..7.
//
//   x (M, K) bf16 row-major; packed (N, K/2) int8: byte (n, j) holds W[j, n]
//   in its low nibble and W[j + K/2, n] in its high nibble; scales (K/128, N)
//   fp32, the first half's groups first; table (15,) fp32; y (M, N) bf16.
//
// Bound on the H100: tensor-core FLOPs. At the DiT's shapes (M = 7,200,
// K and N 5,120 or 13,824) 2*M*K*N FLOPs against ~80 MB of x, y and packed
// weights is far above the card's ~295 FLOP/byte ridge; at M = 512 and 257
// (the context projections) it is still above it.
//
// Design (simple and correct first; wgmma/TMA and a pipelined ring are later
// work):
// - one 256-thread block (8 warps as 2 x 4) per 128 x 128 output tile; each
//   warp owns 64 x 32 of it in fp32 registers;
// - a loop over the packed K in steps of 32 bytes: the step's 32 low-nibble
//   rows and 32 high-nibble rows of W pair with columns [j0, j0+32) and
//   [K/2 + j0, K/2 + j0 + 32) of x, so the packed bytes are read once;
// - each thread unpacks 16 bytes of one output column, looks the nibbles up
//   in the table (shared memory), multiplies by the group's fp32 scale and
//   rounds once to bf16: the weight is bitwise the twin's dequantization;
// - mma.sync m16n8k16 bf16 -> fp32 on both halves; rows past M (7,200 is
//   not a multiple of 128, nor are 257 and the small references' rows) load
//   as zeros and are never written.
#include "common.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;         // packed bytes per step along K/2
constexpr int kThreads = 256;
constexpr int kLd = kBK + 8;    // smem row pitch (bf16), 80 bytes: conflict-free fragment reads
constexpr int kGroup = 128;

using ce::lds32;
using ce::mma_16816;
using ce::pack_bf16;

__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ packed,
                   const float* __restrict__ scales,
                   const float* __restrict__ table,
                   __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][kBM * kLd];  // x columns of the lo, hi halves
  __shared__ __align__(16) __nv_bfloat16 ws[2][kBN * kLd];  // W^T rows (n-major) of each half
  __shared__ float lut[16];  // lut[q + 8]; q = -8 never comes from the quantizer

  const int half = K / 2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;

  if (threadIdx.x < 16) lut[threadIdx.x] = threadIdx.x == 0 ? 0.f : table[threadIdx.x - 1];

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // this thread's 16 packed bytes of one output column, per step
  const int wr = threadIdx.x >> 1, wc = (threadIdx.x & 1) * 16;
  const int n_w = n0 + wr;

  for (int j0 = 0; j0 < half; j0 += kBK) {
    __syncthreads();  // every warp is done with the previous tiles
    for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      if (m0 + r < M) {
        const __nv_bfloat16* row = x + static_cast<size_t>(m0 + r) * K + j0 + c;
        lo = *reinterpret_cast<const uint4*>(row);
        hi = *reinterpret_cast<const uint4*>(row + half);
      }
      *reinterpret_cast<uint4*>(&xs[0][r * kLd + c]) = lo;
      *reinterpret_cast<uint4*>(&xs[1][r * kLd + c]) = hi;
    }
    {
      uint4 p = make_uint4(0u, 0u, 0u, 0u);
      float s_lo = 0.f, s_hi = 0.f;
      if (n_w < N) {
        p = *reinterpret_cast<const uint4*>(packed + static_cast<size_t>(n_w) * half + j0 + wc);
        const int grp = (j0 + wc) / kGroup;  // 16 bytes never straddle a group
        s_lo = scales[static_cast<size_t>(grp) * N + n_w];
        s_hi = scales[static_cast<size_t>(grp + half / kGroup) * N + n_w];
      }
      const int8_t* b = reinterpret_cast<const int8_t*>(&p);
      uint32_t lo_w[8], hi_w[8];
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        const int v0 = b[e], v1 = b[e + 1];
        const int l0 = ((v0 & 15) ^ 8) - 8, l1 = ((v1 & 15) ^ 8) - 8;
        lo_w[e / 2] = pack_bf16(lut[l0 + 8] * s_lo, lut[l1 + 8] * s_lo);
        hi_w[e / 2] = pack_bf16(lut[(v0 >> 4) + 8] * s_hi, lut[(v1 >> 4) + 8] * s_hi);
      }
      uint4* dlo = reinterpret_cast<uint4*>(&ws[0][wr * kLd + wc]);
      uint4* dhi = reinterpret_cast<uint4*>(&ws[1][wr * kLd + wc]);
      dlo[0] = make_uint4(lo_w[0], lo_w[1], lo_w[2], lo_w[3]);
      dlo[1] = make_uint4(lo_w[4], lo_w[5], lo_w[6], lo_w[7]);
      dhi[0] = make_uint4(hi_w[0], hi_w[1], hi_w[2], hi_w[3]);
      dhi[1] = make_uint4(hi_w[4], hi_w[5], hi_w[6], hi_w[7]);
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const __nv_bfloat16* r0 = &xs[h][(wm + mt * 16 + g) * kLd + kk * 16 + t4 * 2];
          a[mt][0] = lds32(r0);
          a[mt][1] = lds32(r0 + 8 * kLd);
          a[mt][2] = lds32(r0 + 8);
          a[mt][3] = lds32(r0 + 8 * kLd + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const __nv_bfloat16* br = &ws[h][(wn + nt * 8 + g) * kLd + kk * 16 + t4 * 2];
          const uint32_t b0 = lds32(br), b1 = lds32(br + 8);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma_16816(acc[mt][nt], a[mt], b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm + mt * 16 + g + r * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn + nt * 8 + t4 * 2;
        if (col < N)
          *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(row) * N + col) =
              pack_bf16(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
      }
    }
  }
}

}  // namespace

extern "C" int int4_matmul_bf16(const void* x, const void* packed, const void* scales,
                                const void* table, void* y, int M, int N, int K,
                                void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || K % (2 * kGroup))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int4_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(table),
      static_cast<__nv_bfloat16*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
