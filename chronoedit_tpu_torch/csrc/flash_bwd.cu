// K6 and K7: non-causal flash-attention backward, bf16 in, bf16 out.
//
// Replace the Pallas kernels chronoedit_tpu/ops/flash_attention.py:588
// `_dq_kernel` (K6) and :618 `_dkv_kernel` (K7), both launched by
// `_backward`. Given the forward's q, k, v, its bf16 output O, the cotangent
// dO, the natural-log LSE (the forward's own, or a global one, as the ring
// backward passes) and dsum = rowsum(dO * O) (fp32, computed by the wrapper
// with one torch reduction, as JAX computes it outside its kernels):
//
//   P  = exp(scale * q k^T - lse)       (recomputed, never stored)
//   dP = dO v^T
//   dS = P * (dP - dsum) * scale
//   K6: dQ = dS k          K7: dK = dS^T q,  dV = P^T dO
//
// q, dO (B, Sq, H, 128) and k, v (B, Skv, H, 128) are read in place through
// TMA; lse and dsum are (B, H, Sq) fp32. Arithmetic as JAX does it: fp32
// scores with scale * log2 e applied to them (not to a bf16 q), exp2 against
// lse * log2 e, P and dS rounded to bf16 before the products that consume
// them, fp32 accumulation, one bf16 rounding of each output.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): tensor-core FLOPs at the
// 720p self-attention (7,200 x 7,200, 40 heads x 128): K6 does 3 products
// of 2 * 7200^2 * 128 FLOPs a head (S, dP, dS k: 1.593 TFLOP, 1.610 ms), K7
// 4 (S^T, dP^T, P^T dO, dS^T q: 2.123 TFLOP, 2.147 ms). Against KV 512 both
// are still FLOP-bound; against KV 257 K6 is bound by its bytes (reading q,
// dO and writing dQ: 0.068 ms), K7 by FLOPs.
//
// No atomics: each output row is owned by one block (K6 its q rows, K7 its
// KV rows) and summed in one fixed order, so the backward is deterministic
// and a remat recompute gives bitwise the same gradients every run. FA3's
// one-pass backward (5 products, dQ summed across blocks with fp32 atomics)
// would do 2 products fewer but is neither deterministic nor what the TPU
// kernels compute.
//
// Design: Hopper's warp-specialised shape, as the forward's
// `flash_fwd_wgmma_kernel` (flash_fwd.cu), with its helpers (sm90.cuh).
// 384 threads, three warpgroups: warpgroup 0 is the producer (`setmaxnreg`
// to 24 registers), warpgroups 1 and 2 consume (240), each owning 64 rows of
// the block's outputs. Every tile arrives by TMA from a 4-D tensor map over
// (128, H, S, B) with 128-byte swizzle, a tile being two 64-column boxes;
// rows past a sequence's end are zero-filled and never read from the next
// batch. Every product is `wgmma`: the score-shaped ones (S, dP) from shared
// memory with both operands K-major, the accumulating ones from P or dS
// converted in registers to bf16 A fragments, against the MN-major tile
// read with the transpose bit (whose leading byte offset is its own box
// size: 8 KB for a 64-row tile, 16 KB for a 128-row one). A stage of the
// two-stage ring has a full and an empty mbarrier; each consumer warp
// arrives on empty once the stage's last product has retired.
// - K7, `flash_bwd_dkv_wgmma_kernel<64>`: one block per (b * h, 128 KV
//   rows); K and V stay resident (64 KB). The producer streams 64-row q and
//   dO tiles (32 KB a stage); one warp of it also stages the tile's lse *
//   log2 e and dsum (+inf and 0 on q rows at or past Sq, as JAX pads them,
//   so that their P^T and dS^T are 0 whatever the lse) and arrives with its
//   32 lanes.
//   A consumer computes S^T = K Q^T and dP^T = V dO^T (m64n64k16, the
//   columns are q rows), then P^T and dS^T in registers with lse and dsum
//   per column, then dV += P^T dO and dK += dS^T Q (m64n128k16, register
//   A). dK and dV: 2 x 64 fp32 a thread, stored from registers; KV rows at
//   or past Skv are never stored.
// - K6, `flash_bwd_dq_wgmma_kernel<128>`: one block per (b * h, 128 q rows);
//   q and dO stay resident (64 KB), lse and dsum of a thread's two rows in
//   registers (+inf and 0 past Sq). The producer streams 128-row K and V
//   tiles (64 KB a stage, 192 KB in all). A consumer computes S = Q K^T and
//   dP = dO V^T (m64n128k16) in two commit groups, so that P's exp2 runs
//   while dP is in the tensor cores (measured faster, bitwise the same),
//   P with columns at or past Skv set to 0, dS, then dQ += dS K. Zero-filled
//   K would give those columns P = exp(-lse), which their zero K rows cancel
//   only while it is finite: past lse < -88 it is inf, and inf * 0 is NaN.
//   Rows at or past Sq are never stored.
// What this answers in the mma.sync design it replaced: (1) its synchronous
// 16-byte loads between two __syncthreads, which nothing overlapped with one
// 8-warp block an SM, are TMA loads into the ring, in flight while the
// consumers compute; (2) mma.sync m16n8k16 with fragments read by 32-bit
// shared loads is wgmma reading the swizzled tiles; (3) the transposed
// operands packed from pairs of 2-byte loads are read with the transpose bit.
// Resources (sm_90a, CUDA 12.8): ptxas -v reports the 384-thread launch
// bound's 168 registers and no spills for both; after `setmaxnreg` the
// consumers' SASS reaches R216 (K6) and R235 (K7) of their 240, with no
// local memory. Dynamic shared memory 197,672 B (K6) and 133,160 B (K7):
// one block an SM.
//
// X2: the grouped backward, behind `flash_bwd_dq_grouped_bf16` and
// `flash_bwd_dkv_grouped_bf16(..., group)`, N = 2 or 4 (the wrapper
// launches K6 or K7 for a side whose group is 1). Replaces the Pallas
// kernels tools/exp_flash_bwd_grouped.py `_dq_kernel_grouped` and
// `_dkv_kernel_grouped` (launched by `grouped_backward`): N KV tiles (dQ)
// or q tiles (dK, dV) a step behind one barrier pair, every S and dP
// product of the step issued before the exp chain. On K6/K7's machinery the
// step is a ring stage, so X2 is K6/K7 with the stage's rows as the
// template argument:
// - dK, dV: N 32-row q tiles a step, `flash_bwd_dkv_wgmma_kernel<32 N>`.
//   At N = 2 the step's S^T and dP^T are m64n64 over its 64 q rows: that is
//   K7's own step, the same instantiation. At N = 4 the stage holds 128 q
//   rows and dO rows (64 KB, 192 KB in all); the whole step's S^T and dP^T
//   (2 x 64 fp32) beside dK and dV (128) would be 256 registers, so the
//   consumer issues the step in two 64-row parts, each K7's products, and
//   frees the stage once both have retired.
// - dQ: N 64-row KV tiles a step, `flash_bwd_dq_wgmma_kernel<64 N>`. At N =
//   2 the two tiles' S and dP (m64n64 each) are K6's m64n128 over 128 KV
//   rows, its own step. At N = 4 a stage is 256 K and V rows (128 KB); two
//   would need 320 KB, so the ring has one (192 KB), and its S and dP (2 x
//   128 fp32) beside dQ (64) would be 320 registers, so the consumer issues
//   the step in two 128-row parts, each K6's products, under the one
//   barrier pair.
// Both parts chain the same 16-deep chunks of each sum in the same order as
// K6/K7, and P and dS round elementwise, so X2's outputs are K6/K7's bit for
// bit, and deterministic (chip_smoke.py holds both). The N = 4
// instantiations' consumers reach R236 (dQ) and R237 (dK, dV) of 240 in
// their SASS, with no local memory once K7's two parts are not unrolled;
// dynamic shared memory 197,656 B (dQ, one stage) and 199,720 B (dK, dV).
#include <math.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using ce::pack_bf16;

constexpr int kD = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

// ---------------------------------------------------------------- K6 / K7

constexpr int kWsThreads = 3 * 128;  // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;    // arrivals that empty a stage
constexpr int kStages = 2;
using sm90::box_bytes;

// K7 (and X2's dK/dV): 128 resident KV rows a block, kQRows q rows a ring
// stage (64 for K7, 32 N for X2's N 32-row tiles). Byte offsets from the
// 1,024-aligned base of dynamic shared memory: K, V, the ring's q and dO
// tiles, each stage's lse and dsum (fp32), the mbarriers (kv_full, then
// full and empty for each stage).
constexpr int kKv7 = 128;
template <int kQRows>
struct Dkv {
  static constexpr int kSmemK = 0;
  static constexpr int kSmemV = 2 * box_bytes(kKv7);
  static constexpr int kSmemRing = kSmemV + 2 * box_bytes(kKv7);
  static constexpr int kStage = 4 * box_bytes(kQRows);
  static constexpr int kSmemRows = kSmemRing + kStages * kStage;
  static constexpr int kSmemBar = kSmemRows + kStages * 2 * kQRows * 4;
  static constexpr int kSmemBytes = kSmemBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};
// K6 (and X2's dQ): 128 resident q rows a block, kKvRows KV rows a ring
// stage (128 for K6, 64 N for X2's N 64-row tiles): q, dO, the ring's K and
// V tiles, the mbarriers (qdo_full, then full and empty). Two stages of 128
// rows (192 KB in all); one stage of 256 (192 KB: two would need 320).
constexpr int kQ6 = 128;
template <int kKvRows>
struct Dq {
  static constexpr int kStages = kKvRows == 128 ? 2 : 1;
  static constexpr int kSmemQ = 0;
  static constexpr int kSmemDo = 2 * box_bytes(kQ6);
  static constexpr int kSmemRing = kSmemDo + 2 * box_bytes(kQ6);
  static constexpr int kStage = 4 * box_bytes(kKvRows);
  static constexpr int kSmemBar = kSmemRing + kStages * kStage;
  static constexpr int kSmemBytes = kSmemBar + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// A 128-column tile of `rows` rows from row0: its two 64-column boxes
template <int kRows>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int row0, int b) {
  sm90::tma_load_4d(dst, map, bar, 0, h, row0, b);
  sm90::tma_load_4d(dst + box_bytes(kRows), map, bar, 64, h, row0, b);
}

// One thread's two rows of a 64 x 128 fp32 fragment to bf16 (B, S, H, 128)
// rows row0 + warp * 16 + g (+ 8), those at or past `limit` skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[64], int b,
                                           int h, int S, int H, int row0, int limit) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + r * 8;
    if (row >= limit) continue;
    __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * S + row) * H + h) * kD + t4 * 2;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int kQRows>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ dsum,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int Sq, int Skv, int H, float scale) {
  using L = Dkv<kQRows>;
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  unsigned char* smem = aligned_smem(ring_smem);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kSmemBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  float* row_vals = reinterpret_cast<float*>(smem + L::kSmemRows);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kv0 = blockIdx.x * kKv7;
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);  // the TMA thread's expect_tx + the warp's rows
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one warp; lane 0 issues TMA, all 32 stage lse and dsum
    sm90::reg_dealloc<24>();
    if (threadIdx.x < 32) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(kv_full, 4 * box_bytes(kKv7));
        tma_tile<kKv7>(smem + L::kSmemK, &tk, kv_full, h, kv0, b);
        tma_tile<kKv7>(smem + L::kSmemV, &tv, kv_full, h, kv0, b);
      }
      const float* lse_b = lse + static_cast<size_t>(bh) * Sq;
      const float* dsum_b = dsum + static_cast<size_t>(bh) * Sq;
      int stage = 0;
      uint32_t phase = 0;
      for (int q0 = 0; q0 < Sq; q0 += kQRows) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);  // the first round passes
        unsigned char* tile = smem + L::kSmemRing + stage * L::kStage;
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[stage], L::kStage);
          tma_tile<kQRows>(tile, &tq, &full[stage], h, q0, b);
          tma_tile<kQRows>(tile + 2 * box_bytes(kQRows), &tdo, &full[stage], h, q0, b);
        }
        float* rows = row_vals + stage * 2 * kQRows;
#pragma unroll
        for (int i = lane; i < kQRows; i += 32) {
          const bool live = q0 + i < Sq;
          rows[i] = live ? lse_b[q0 + i] * kLog2e : INFINITY;
          rows[kQRows + i] = live ? dsum_b[q0 + i] : 0.f;
        }
        sm90::mbar_arrive(&full[stage]);
        sm90::next_stage(stage, phase, kStages);
      }
    }
  } else {
    // ---- consumers: 64 KV rows each; warp w owns rows 16w..16w+15 of them.
    // st / dpt[4j + e]: KV row g + 8 (e >> 1), q column 8j + 2 t4 + (e & 1)
    // of the 64-row part of the stage in hand.
    sm90::reg_alloc<240>();
    const int c = wg - 1;
    const int t4 = lane & 3;
    const float scale_log2 = scale * kLog2e;
    // this warpgroup's 64 KV rows: 8 KB into each 64-column box
    const uint32_t k_addr = sm90::smem_u32(smem + L::kSmemK) + c * box_bytes(64);
    const uint32_t v_addr = sm90::smem_u32(smem + L::kSmemV) + c * box_bytes(64);
    const uint32_t ring = sm90::smem_u32(smem + L::kSmemRing);

    float dk_acc[64], dv_acc[64], st[32], dpt[32];
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;

    sm90::mbar_wait(kv_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int q0 = 0; q0 < Sq; q0 += kQRows) {
      sm90::mbar_wait(&full[stage], phase);
      // a stage of 128 q rows (X2, N = 4) goes in two 64-row parts, each
      // K7's step: the 256 registers of the whole step's S^T and dP^T beside
      // dK and dV would not fit
#pragma unroll 1
      for (int part = 0; part < kQRows / 64; ++part) {
        const uint32_t q_addr = ring + stage * L::kStage + part * box_bytes(64);
        const uint32_t do_addr = q_addr + 2 * box_bytes(kQRows);
        const float* rows = row_vals + stage * 2 * kQRows + part * 64;
        sm90::wgmma_fence();
        sm90::issue_abt<kKv7, kQRows>(st, k_addr, q_addr);
        sm90::issue_abt<kKv7, kQRows>(dpt, v_addr, do_addr);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);
        // P^T and dS^T = P^T (dP^T - dsum) scale, lse and dsum per column
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t4);
          const float2 ds = *reinterpret_cast<const float2*>(rows + kQRows + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(st[4 * j + e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
            st[4 * j + e] = p;
            dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? ds.y : ds.x)) * scale;
          }
        }
        sm90::to_a_frags(pa, st);
        sm90::to_a_frags(sa, dpt);
        // dV += P^T dO, dK += dS^T Q
        sm90::wgmma_fence();
        sm90::issue_ab<64, kQRows>(dv_acc, pa, do_addr);
        sm90::issue_ab<64, kQRows>(dk_acc, sa, q_addr);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(dk_acc);
        sm90::fence_regs(pa);
        sm90::fence_regs(sa);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      sm90::next_stage(stage, phase, kStages);
    }
    store_rows(dk, dk_acc, b, h, Skv, H, kv0 + c * 64, Skv);
    store_rows(dv, dv_acc, b, h, Skv, H, kv0 + c * 64, Skv);
  }
}

template <int kKvRows>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, float scale) {
  using L = Dq<kKvRows>;
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  unsigned char* smem = aligned_smem(ring_smem);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::kSmemBar);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + L::kStages;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kQ6;
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qdo_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(qdo_full, 4 * box_bytes(kQ6));
      tma_tile<kQ6>(smem + L::kSmemQ, &tq, qdo_full, h, q0, b);
      tma_tile<kQ6>(smem + L::kSmemDo, &tdo, qdo_full, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kv0 = 0; kv0 < Skv; kv0 += kKvRows) {
        unsigned char* tile = smem + L::kSmemRing + stage * L::kStage;
        sm90::mbar_wait(&empty[stage], phase ^ 1);  // the first round passes
        sm90::mbar_arrive_expect_tx(&full[stage], L::kStage);
        tma_tile<kKvRows>(tile, &tk, &full[stage], h, kv0, b);
        tma_tile<kKvRows>(tile + 2 * box_bytes(kKvRows), &tv, &full[stage], h, kv0, b);
        sm90::next_stage(stage, phase, L::kStages);
      }
    }
  } else {
    // ---- consumers: 64 q rows each; warp w owns rows 16w..16w+15 of them.
    // s / dp[4j + e]: q row g + 8 (e >> 1), KV column 8j + 2 t4 + (e & 1) of
    // the 128-row part of the stage in hand.
    sm90::reg_alloc<240>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const float scale_log2 = scale * kLog2e;
    const uint32_t q_addr = sm90::smem_u32(smem + L::kSmemQ) + c * box_bytes(64);
    const uint32_t do_addr = sm90::smem_u32(smem + L::kSmemDo) + c * box_bytes(64);
    const uint32_t ring = sm90::smem_u32(smem + L::kSmemRing);

    // lse * log2 e and dsum of this thread's rows g and g + 8; rows past Sq
    // get P = 0
    float lse2[2], ds_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + c * 64 + warp * 16 + g + r * 8;
      const bool live = row < Sq;
      lse2[r] = live ? lse[static_cast<size_t>(bh) * Sq + row] * kLog2e : INFINITY;
      ds_row[r] = live ? dsum[static_cast<size_t>(bh) * Sq + row] : 0.f;
    }

    float acc[64], s[64], dp[64];
    uint32_t da[8][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = s[i] = dp[i] = 0.f;

    sm90::mbar_wait(qdo_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kv0 = 0; kv0 < Skv; kv0 += kKvRows) {
      sm90::mbar_wait(&full[stage], phase);
      // a stage of 256 KV rows (X2, N = 4) goes in two 128-row parts, each
      // K6's step: the whole step's S and dP (256 fp32) beside dQ would not
      // fit
#pragma unroll
      for (int part = 0; part < kKvRows / 128; ++part) {
        const int col0 = kv0 + part * 128;
        const uint32_t k_addr = ring + stage * L::kStage + part * box_bytes(128);
        const uint32_t v_addr = k_addr + 2 * box_bytes(kKvRows);
        // S and dP in two commit groups: P's exponentials run while dP is
        // still in the tensor cores
        sm90::wgmma_fence();
        sm90::issue_abt<kQ6, kKvRows>(s, q_addr, k_addr);
        sm90::wgmma_commit();
        sm90::issue_abt<kQ6, kKvRows>(dp, do_addr, v_addr);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        // P, 0 on KV columns past Skv; then dS = P (dP - dsum) scale
        const bool tail = col0 + 128 > Skv;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float p = exp2f(s[i] * scale_log2 - lse2[(i >> 1) & 1]);
          s[i] = tail && col0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= Skv ? 0.f : p;
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] = s[i] * (dp[i] - ds_row[(i >> 1) & 1]) * scale;
        sm90::to_a_frags(da, s);
        // dQ += dS K
        sm90::wgmma_fence();
        sm90::issue_ab<128, kKvRows>(acc, da, k_addr);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        sm90::fence_regs(da);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      sm90::next_stage(stage, phase, L::kStages);
    }
    store_rows(dq, acc, b, h, Sq, H, q0 + c * 64, Sq);
  }
}

// The four tensor maps of a backward call: q and dO with q_rows-row boxes,
// k and v with kv_rows-row boxes.
int bwd_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
             const void* dout, int B, int Sq, int Skv, int H, int q_rows, int kv_rows) {
  int err = sm90::bshd_map(&maps[0], q, B, Sq, H, q_rows);
  if (err == 0) err = sm90::bshd_map(&maps[1], k, B, Skv, H, kv_rows);
  if (err == 0) err = sm90::bshd_map(&maps[2], v, B, Skv, H, kv_rows);
  if (err == 0) err = sm90::bshd_map(&maps[3], dout, B, Sq, H, q_rows);
  return err;
}

template <int kKvRows>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* dsum, void* dq, int B, int Sq, int Skv, int H, float scale,
              void* stream) {
  constexpr int kSmem = Dq<kKvRows>::kSmemBytes;
  static bool attr_set = false;  // one flag per instantiation
  const cudaError_t err = allow_smem(flash_bwd_dq_wgmma_kernel<kKvRows>, kSmem, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];
  const int map_err = bwd_maps(maps, q, k, v, dout, B, Sq, Skv, H, kQ6, kKvRows);
  if (map_err != 0) return map_err;
  const dim3 grid((Sq + kQ6 - 1) / kQ6, B * H);
  flash_bwd_dq_wgmma_kernel<kKvRows><<<grid, kWsThreads, kSmem,
                                       static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kQRows>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* dsum, void* dk, void* dv, int B, int Sq, int Skv, int H,
               float scale, void* stream) {
  constexpr int kSmem = Dkv<kQRows>::kSmemBytes;
  static bool attr_set = false;  // one flag per instantiation
  const cudaError_t err = allow_smem(flash_bwd_dkv_wgmma_kernel<kQRows>, kSmem, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];
  const int map_err = bwd_maps(maps, q, k, v, dout, B, Sq, Skv, H, kQRows, kKv7);
  if (map_err != 0) return map_err;
  const dim3 grid((Skv + kKv7 - 1) / kKv7, B * H);
  flash_bwd_dkv_wgmma_kernel<kQRows><<<grid, kWsThreads, kSmem,
                                       static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Skv, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6: dQ (B, Sq, H, 128) bf16. lse, dsum (B, H, Sq) fp32.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dsum, void* dq, int B, int Sq,
                                 int Skv, int H, int D, float scale,
                                 void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dq<128>(q, k, v, dout, lse, dsum, dq, B, Sq, Skv, H, scale, stream);
}

// K7: dK, dV (B, Skv, H, 128) bf16. lse, dsum (B, H, Sq) fp32.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* dsum, void* dk, void* dv, int B,
                                  int Sq, int Skv, int H, int D, float scale,
                                  void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dkv<64>(q, k, v, dout, lse, dsum, dk, dv, B, Sq, Skv, H, scale, stream);
}

// X2 dQ: as flash_bwd_dq_bf16, `group` 64-row KV tiles a step (2 or 4).
extern "C" int flash_bwd_dq_grouped_bf16(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse,
                                         const void* dsum, void* dq, int B, int Sq,
                                         int Skv, int H, int D, float scale, int group,
                                         void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  switch (group) {
    case 2: return launch_dq<128>(q, k, v, dout, lse, dsum, dq, B, Sq, Skv, H, scale, stream);
    case 4: return launch_dq<256>(q, k, v, dout, lse, dsum, dq, B, Sq, Skv, H, scale, stream);
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
      return launch_dkv<64>(q, k, v, dout, lse, dsum, dk, dv, B, Sq, Skv, H, scale, stream);
    case 4:
      return launch_dkv<128>(q, k, v, dout, lse, dsum, dk, dv, B, Sq, Skv, H, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
