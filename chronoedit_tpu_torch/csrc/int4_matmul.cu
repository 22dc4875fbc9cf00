// K8: y = x @ dequant(W) for the w4a16 linear, bf16 x, int4 W, fp32 sums.
//
// Replaces the Pallas kernel chronoedit_tpu/ops/int4_matmul.py:89 `_kernel`
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
// K and N 5,120 or 13,824) 2 M K N FLOPs (0.38 ms at 5,120^2) against ~90
// MB of x, y and packed weights is far above the card's ~295 FLOP/byte
// ridge; at M = 512 and 257 (the context projections) it is still above it.
//
// Design, `int4_matmul_wgmma_kernel`: the operands swapped, as Hopper's
// mixed-input GEMMs do, so that the weight never passes through shared
// memory as bf16. A block computes a 128 x 256 tile of y^T = dequant(W)^T
// x^T (128 output columns n, 256 rows m of x):
// - 384 threads. Warpgroup 0 is the producer (`setmaxnreg` to 24
//   registers): one thread keeps a three-stage ring full by TMA. A stage is
//   64 packed bytes of K/2 (64 K values of each half, half a scale group):
//   the lo-half x columns [j0, j0 + 64) and the hi-half columns [K/2 + j0,
//   K/2 + j0 + 64) as two 256-row boxes (128 B a row, 128-byte swizzle), the
//   block's 128 packed rows (64 B a row, 64-byte swizzle) and the two scale
//   rows of the step's groups (lo and hi, 128 fp32 each): 73 KB a stage.
//   TMA zero-fills rows past M and N, so ragged tiles need no checks.
// - Warpgroups 1 and 2 consume at 240 registers, 64 n rows each. The packed
//   rows are W^T, K-contiguous: each thread reads the bytes of its A
//   fragment (rows g and g + 8, K offsets 2 t4, 2 t4 + 1, 8 + 2 t4, 9 + 2 t4
//   of a 16-wide k-step) as two 32-bit shared loads a row and one byte
//   permute, and decodes them straight into the register-A fragments of the
//   bf16 wgmma m64n256k16, whose B is the x box read K-major. The low
//   nibbles feed the lo-half product and the high nibbles of the same bytes
//   the hi-half one: one read for both, as JAX's kernel does.
// - The decode is the twin's, bit for bit: table[q + 7] * scale in fp32
//   (the table in shared memory, indexed by the nibble ^ 8; the scales read
//   once a stage from the staged rows, no global scalar loads), rounded
//   once to bf16.
// - A fragments are double-buffered: step t + 1 is decoded while step t's
//   two products run (wait_group 1 between them); a stage is released once
//   its last products have retired.
// - fp32 sums: per 16-wide k-step the lo product then the hi one, the
//   stages in order. The epilogue stages y^T through shared memory (over the
//   drained ring) as y rows and stores them with 16-byte stores; rows >= M
//   and columns >= N are never written.
// What this answers in the mma.sync design it replaces: (1) its
// synchronous 16-byte loads between two __syncthreads, which nothing
// overlapped, are TMA loads three stages ahead; (2) steps of 32 packed bytes
// with two block barriers each are 64-byte stages with no block barrier;
// (3) the dequantization of a whole tile between the barriers, with two
// global scalar scale loads a thread a step, runs under the previous step's
// products from staged scales, and the bf16 weight tile no longer goes
// through shared memory; (4) mma.sync m16n8k16 is wgmma.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kGroup = 128;                     // weight rows per scale
constexpr int kBN = 128;                        // output columns n a block (two consumers)
constexpr int kBM = 256;                        // rows m of x a block: the wgmma's N
constexpr int kBK = 64;                         // packed bytes of K/2 a stage
constexpr int kStages = 3;
constexpr int kThreads = 3 * 128;
constexpr int kConsumerWarps = 8;
constexpr int kXBox = kBM * 128;                // one 64-column x box: 32 KB
constexpr int kPkBytes = kBN * kBK;             // the packed tile: 8 KB
constexpr int kScBytes = 2 * kBN * 4;           // the lo and hi scale rows
// byte offsets inside a stage, and from the 1,024-aligned base of dynamic
// shared memory: the ring, then the mbarriers (full and empty for each
// stage), then the 16-entry table
constexpr int kStXLo = 0;
constexpr int kStXHi = kXBox;
constexpr int kStPk = 2 * kXBox;
constexpr int kStSc = kStPk + kPkBytes;
constexpr int kStageBytes = kStSc + kScBytes;   // 74,752: a multiple of 1,024
constexpr int kSmemBar = kStages * kStageBytes;
constexpr int kSmemLut = kSmemBar + 8 * 2 * kStages;
constexpr int kSmemBytes = kSmemLut + 16 * 4 + 1024;  // + alignment slack
constexpr int kYsLd = kBN + 8;                  // bf16 pitch of the epilogue's y rows
static_assert(kStageBytes % 1024 == 0, "stages keep the 128-byte swizzle's alignment");
static_assert(kBM * kYsLd * 2 <= kSmemBar, "the epilogue fits in the drained ring");

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Four decoded weights as two bf16 pairs: lut[nibble ^ 8] * scale in fp32,
// rounded once. `v` holds the nibbles already xor-ed with 8; `shift` picks
// the lo (0) or hi (4) nibble of each byte.
__device__ __forceinline__ void decode4(uint32_t (&out)[2], uint32_t v, int shift,
                                        const float* lut, float scale) {
  const float w0 = lut[(v >> shift) & 15] * scale;
  const float w1 = lut[(v >> (shift + 8)) & 15] * scale;
  const float w2 = lut[(v >> (shift + 16)) & 15] * scale;
  const float w3 = lut[(v >> (shift + 24)) & 15] * scale;
  out[0] = ce::pack_bf16(w0, w1);
  out[1] = ce::pack_bf16(w2, w3);
}

__global__ void __launch_bounds__(kThreads, 1)
int4_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tp,
                         const __grid_constant__ CUtensorMap ts,
                         const float* __restrict__ table, __nv_bfloat16* __restrict__ y,
                         int M, int N, int K) {
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ring_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSmemBar);
  uint64_t* empty = full + kStages;
  float* lut = reinterpret_cast<float*>(smem + kSmemLut);  // lut[q + 8]; q = -8 never occurs

  const int half = K / 2;
  const int n_stages = half / kBK;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  if (threadIdx.x < 16) lut[threadIdx.x] = threadIdx.x == 0 ? 0.f : table[threadIdx.x - 1];
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      const int hi_groups = half / kGroup;
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_stages; ++i) {
        unsigned char* st = smem + stage * kStageBytes;
        const int j0 = i * kBK, grp = j0 / kGroup;
        sm90::mbar_wait(&empty[stage], phase ^ 1);  // the first round passes
        sm90::mbar_arrive_expect_tx(&full[stage], kStageBytes);
        sm90::tma_load_2d(st + kStXLo, &tx, &full[stage], j0, m0);
        sm90::tma_load_2d(st + kStXHi, &tx, &full[stage], half + j0, m0);
        sm90::tma_load_2d(st + kStPk, &tp, &full[stage], j0, n0);
        sm90::tma_load_2d(st + kStSc, &ts, &full[stage], n0, grp);
        sm90::tma_load_2d(st + kStSc + kBN * 4, &ts, &full[stage], n0, hi_groups + grp);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 n rows each; warp w owns rows 16w..16w+15 of them.
    // acc[4j + e]: n row g + 8 (e >> 1) of the warp's 16, x row 8j + 2 t4 +
    // (e & 1) of the block's 256.
    sm90::reg_alloc<240>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = c * 64 + warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the tile
    // the packed tile's 64-byte swizzle moves 16-byte chunk k to k ^ ((row >>
    // 1) & 3); rows r0 and r0 + 8 share it
    const int swz = (r0 >> 1) & 3;
    const uint32_t sel = (t4 & 1) ? 0x7632u : 0x5410u;  // bytes 2 t4, +1 of word A, then of B
    const uint32_t word = 4 * (t4 >> 1);
    const uint32_t ring = sm90::smem_u32(smem);

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t a[2][2][4];  // [buffer][lo, hi][fragment]

    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n_stages; ++i) {
      const uint32_t st = ring + stage * kStageBytes;
      sm90::mbar_wait(&full[stage], phase);
      const float* sc = reinterpret_cast<const float*>(smem + stage * kStageBytes + kStSc);
      const float s_lo[2] = {sc[r0], sc[r0 + 8]};
      const float s_hi[2] = {sc[kBN + r0], sc[kBN + r0 + 8]};
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int buf = kk & 1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t row = st + kStPk + (r0 + 8 * r) * kBK + 16 * (kk ^ swz) + word;
          const uint32_t v = __byte_perm(lds_u32(row), lds_u32(row + 8), sel) ^ 0x88888888u;
          // fragment registers r (K 2 t4, +1) and 2 + r (K 8 + 2 t4, +1)
          uint32_t lo[2], hi[2];
          decode4(lo, v, 0, lut, s_lo[r]);
          decode4(hi, v, 4, lut, s_hi[r]);
          a[buf][0][r] = lo[0];
          a[buf][0][2 + r] = lo[1];
          a[buf][1][r] = hi[0];
          a[buf][1][2 + r] = hi[1];
        }
        sm90::wgmma_fence();
        sm90::wgmma_m64n256k16_rs(acc, a[buf][0],
                                  sm90::smem_desc(st + kStXLo + kk * 32, 16, 1024), 1);
        sm90::wgmma_m64n256k16_rs(acc, a[buf][1],
                                  sm90::smem_desc(st + kStXHi + kk * 32, 16, 1024), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous step's products have retired
        sm90::fence_regs(a[buf ^ 1]);
        if (kk == 0 && i > 0 && lane == 0) sm90::mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);

    // ---- epilogue: y^T fragments -> y rows in shared memory -> 16-byte stores
    sm90::named_sync(1);  // both consumers' products have retired: the ring is free
    __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ys[(8 * j + 2 * t4 + (e & 1)) * kYsLd + r0 + 8 * (e >> 1)] =
            __float2bfloat16_rn(acc[4 * j + e]);
    sm90::named_sync(1);
    const int ct = threadIdx.x - 128;
#pragma unroll 4
    for (int id = ct; id < kBM * kBN / 8; id += 256) {
      const int row = id / (kBN / 8), col = (id % (kBN / 8)) * 8;
      if (m0 + row < M && n0 + col < N)
        *reinterpret_cast<uint4*>(y + static_cast<size_t>(m0 + row) * N + n0 + col) =
            *reinterpret_cast<const uint4*>(ys + row * kYsLd + col);
    }
  }
}

}  // namespace

extern "C" int int4_matmul_bf16(const void* x, const void* packed, const void* scales,
                                const void* table, void* y, int M, int N, int K,
                                void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || K % (2 * kGroup))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  CUtensorMap tx, tp, ts;
  int err = sm90::matrix_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, kBM, 64,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = sm90::matrix_map(&tp, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K / 2, kBN, kBK,
                           CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0)
    err = sm90::matrix_map(&ts, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / kGroup, N, 1,
                           kBN, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int4_matmul_wgmma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tx, tp, ts, static_cast<const float*>(table), static_cast<__nv_bfloat16*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
