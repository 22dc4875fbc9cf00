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
// - K7, `flash_bwd_dkv_wgmma_kernel`: one block per (b * h, 128 KV rows); K
//   and V stay resident (64 KB). The producer streams 64-row q and dO tiles
//   (32 KB a stage); one warp of it also stages the tile's lse * log2 e and
//   dsum (+inf and 0 on q rows at or past Sq, as JAX pads them, so that
//   their P^T and dS^T are 0 whatever the lse) and arrives with its 32
//   lanes.
//   A consumer computes S^T = K Q^T and dP^T = V dO^T (m64n64k16, the
//   columns are q rows), then P^T and dS^T in registers with lse and dsum
//   per column, then dV += P^T dO and dK += dS^T Q (m64n128k16, register
//   A). dK and dV: 2 x 64 fp32 a thread, stored from registers; KV rows at
//   or past Skv are never stored.
// - K6, `flash_bwd_dq_wgmma_kernel`: one block per (b * h, 128 q rows); q
//   and dO stay resident (64 KB), lse and dsum of a thread's two rows in
//   registers (+inf and 0 past Sq). The producer streams 128-row K and V
//   tiles (64 KB a stage, 192 KB in all). A consumer computes S = Q K^T and
//   dP = dO V^T (m64n128k16) in two commit groups, so that P's exp2 runs
//   while dP is in the tensor cores (measured faster, bitwise the same),
//   P with columns at or past Skv set to 0, dS, then dQ += dS K. Zero-filled
//   K would give those columns P = exp(-lse), which their zero K rows cancel
//   only while it is finite: past lse < -88 it is inf, and inf * 0 is NaN.
//   Rows at or past Sq are never stored.
// What this answers in the mma.sync design it replaces: (1) its synchronous
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
// X2: the grouped backward, the same function as K6/K7 in the earlier
// mma.sync design. Replaces the Pallas kernels
// tools/exp_flash_bwd_grouped.py `_dq_kernel_grouped` and
// `_dkv_kernel_grouped` (launched by `grouped_backward`).
// - `flash_bwd_dq_grouped_kernel<N>`: N 64-row KV tiles a step behind one
//   barrier pair; all N x 8 S and dP tiles are issued before the exp chain,
//   then each tile's dS and dQ += dS k.
// - `flash_bwd_dkv_grouped_kernel<N>`: N 32-row q tiles a step (and their
//   lse and dsum; q rows past Sq carry lse = +inf); all N x 4 S^T and dP^T
//   tiles first, then each tile's P^T, dS^T and the dV, dK products.
// N = 2 or 4; the wrapper launches K6 or K7 for a side whose group is 1.
// X2's tiles differ from K6/K7's (64-row KV tiles for dQ, 32-row q tiles for
// dK and dV), but P and dS round elementwise and both designs chain the same
// 16-deep chunks of each sum in the same order, mma.sync's k16 steps as
// wgmma's: on the card their outputs have come out bitwise equal. The tool
// holds them to the K67 bounds (tools/__init__.py), not to that. The
// hoisted S and dP tiles hold 64 N (dQ) or 32 N (dK, dV) fp32 a thread:
// ptxas -v (sm_90a) gives dQ 252 / 255 registers for N = 2 / 4, with 2,252
// B of spill stores at N = 4, and dK/dV 254 / 255, with 212 B at N = 4; no
// spills at N = 2.
// Dynamic shared memory: dQ (2 * 128 + 2 N 64) * 136 * 2 B (139,264 /
// 208,896 B), dK/dV (2 * 128 + 2 N 32) * 136 * 2 + 2 N 32 * 4 B (104,960 /
// 140,288 B).
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

// K7: 128 resident KV rows a block, 64 q rows a ring stage. Byte offsets
// from the 1,024-aligned base of dynamic shared memory: K, V, the ring's q
// and dO tiles, each stage's lse and dsum (fp32), the mbarriers (kv_full,
// then full and empty for each stage).
constexpr int kKv7 = 128;
constexpr int kQ7 = 64;
constexpr int kSmem7K = 0;
constexpr int kSmem7V = 2 * box_bytes(kKv7);
constexpr int kSmem7Ring = kSmem7V + 2 * box_bytes(kKv7);
constexpr int kStage7 = 4 * box_bytes(kQ7);
constexpr int kSmem7Rows = kSmem7Ring + kStages * kStage7;
constexpr int kSmem7Bar = kSmem7Rows + kStages * 2 * kQ7 * 4;
constexpr int kSmem7Bytes = kSmem7Bar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
// K6: 128 resident q rows a block, 128 KV rows a ring stage: q, dO, the
// ring's K and V tiles, the mbarriers (qdo_full, then full and empty).
constexpr int kQ6 = 128;
constexpr int kKv6 = 128;
constexpr int kSmem6Q = 0;
constexpr int kSmem6Do = 2 * box_bytes(kQ6);
constexpr int kSmem6Ring = kSmem6Do + 2 * box_bytes(kQ6);
constexpr int kStage6 = 4 * box_bytes(kKv6);
constexpr int kSmem6Bar = kSmem6Ring + kStages * kStage6;
constexpr int kSmem6Bytes = kSmem6Bar + 8 * (1 + 2 * kStages) + 1024;

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

__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ dsum,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int Sq, int Skv, int H, float scale) {
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  unsigned char* smem = aligned_smem(ring_smem);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + kSmem7Bar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  float* row_vals = reinterpret_cast<float*>(smem + kSmem7Rows);

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
        tma_tile<kKv7>(smem + kSmem7K, &tk, kv_full, h, kv0, b);
        tma_tile<kKv7>(smem + kSmem7V, &tv, kv_full, h, kv0, b);
      }
      const float* lse_b = lse + static_cast<size_t>(bh) * Sq;
      const float* dsum_b = dsum + static_cast<size_t>(bh) * Sq;
      int stage = 0;
      uint32_t phase = 0;
      for (int q0 = 0; q0 < Sq; q0 += kQ7) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);  // the first round passes
        unsigned char* tile = smem + kSmem7Ring + stage * kStage7;
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[stage], kStage7);
          tma_tile<kQ7>(tile, &tq, &full[stage], h, q0, b);
          tma_tile<kQ7>(tile + 2 * box_bytes(kQ7), &tdo, &full[stage], h, q0, b);
        }
        float* rows = row_vals + stage * 2 * kQ7;
#pragma unroll
        for (int i = lane; i < kQ7; i += 32) {
          const bool live = q0 + i < Sq;
          rows[i] = live ? lse_b[q0 + i] * kLog2e : INFINITY;
          rows[kQ7 + i] = live ? dsum_b[q0 + i] : 0.f;
        }
        sm90::mbar_arrive(&full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 KV rows each; warp w owns rows 16w..16w+15 of them.
    // st / dpt[4j + e]: KV row g + 8 (e >> 1), q column 8j + 2 t4 + (e & 1).
    sm90::reg_alloc<240>();
    const int c = wg - 1;
    const int t4 = lane & 3;
    const float scale_log2 = scale * kLog2e;
    // this warpgroup's 64 KV rows: 8 KB into each 64-column box
    const uint32_t k_addr = sm90::smem_u32(smem + kSmem7K) + c * box_bytes(64);
    const uint32_t v_addr = sm90::smem_u32(smem + kSmem7V) + c * box_bytes(64);
    const uint32_t ring = sm90::smem_u32(smem + kSmem7Ring);

    float dk_acc[64], dv_acc[64], st[32], dpt[32];
    uint32_t pa[kQ7 / 16][4], sa[kQ7 / 16][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;

    sm90::mbar_wait(kv_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int q0 = 0; q0 < Sq; q0 += kQ7) {
      sm90::mbar_wait(&full[stage], phase);
      const uint32_t q_addr = ring + stage * kStage7;
      const uint32_t do_addr = q_addr + 2 * box_bytes(kQ7);
      const float* rows = row_vals + stage * 2 * kQ7;
      sm90::wgmma_fence();
      sm90::issue_abt<kKv7, kQ7>(st, k_addr, q_addr);
      sm90::issue_abt<kKv7, kQ7>(dpt, v_addr, do_addr);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      // P^T and dS^T = P^T (dP^T - dsum) scale, lse and dsum per column
#pragma unroll
      for (int j = 0; j < kQ7 / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t4);
        const float2 ds = *reinterpret_cast<const float2*>(rows + kQ7 + 8 * j + 2 * t4);
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
      sm90::issue_ab<kQ7>(dv_acc, pa, do_addr);
      sm90::issue_ab<kQ7>(dk_acc, sa, q_addr);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      sm90::fence_regs(pa);
      sm90::fence_regs(sa);
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    store_rows(dk, dk_acc, b, h, Skv, H, kv0 + c * 64, Skv);
    store_rows(dv, dv_acc, b, h, Skv, H, kv0 + c * 64, Skv);
  }
}

__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, float scale) {
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  unsigned char* smem = aligned_smem(ring_smem);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + kSmem6Bar);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kQ6;
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
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
      tma_tile<kQ6>(smem + kSmem6Q, &tq, qdo_full, h, q0, b);
      tma_tile<kQ6>(smem + kSmem6Do, &tdo, qdo_full, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kv0 = 0; kv0 < Skv; kv0 += kKv6) {
        unsigned char* tile = smem + kSmem6Ring + stage * kStage6;
        sm90::mbar_wait(&empty[stage], phase ^ 1);  // the first round passes
        sm90::mbar_arrive_expect_tx(&full[stage], kStage6);
        tma_tile<kKv6>(tile, &tk, &full[stage], h, kv0, b);
        tma_tile<kKv6>(tile + 2 * box_bytes(kKv6), &tv, &full[stage], h, kv0, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each; warp w owns rows 16w..16w+15 of them.
    // s / dp[4j + e]: q row g + 8 (e >> 1), KV column 8j + 2 t4 + (e & 1).
    sm90::reg_alloc<240>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const float scale_log2 = scale * kLog2e;
    const uint32_t q_addr = sm90::smem_u32(smem + kSmem6Q) + c * box_bytes(64);
    const uint32_t do_addr = sm90::smem_u32(smem + kSmem6Do) + c * box_bytes(64);
    const uint32_t ring = sm90::smem_u32(smem + kSmem6Ring);

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
    uint32_t da[kKv6 / 16][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = s[i] = dp[i] = 0.f;

    sm90::mbar_wait(qdo_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kv0 = 0; kv0 < Skv; kv0 += kKv6) {
      sm90::mbar_wait(&full[stage], phase);
      const uint32_t k_addr = ring + stage * kStage6;
      const uint32_t v_addr = k_addr + 2 * box_bytes(kKv6);
      // S and dP in two commit groups: P's exponentials run while dP is
      // still in the tensor cores
      sm90::wgmma_fence();
      sm90::issue_abt<kQ6, kKv6>(s, q_addr, k_addr);
      sm90::wgmma_commit();
      sm90::issue_abt<kQ6, kKv6>(dp, do_addr, v_addr);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      // P, 0 on KV columns past Skv; then dS = P (dP - dsum) scale
      const bool tail = kv0 + kKv6 > Skv;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float p = exp2f(s[i] * scale_log2 - lse2[(i >> 1) & 1]);
        s[i] = tail && kv0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= Skv ? 0.f : p;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = s[i] * (dp[i] - ds_row[(i >> 1) & 1]) * scale;
      sm90::to_a_frags(da, s);
      // dQ += dS K
      sm90::wgmma_fence();
      sm90::issue_ab<kKv6>(acc, da, k_addr);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(da);
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
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

}  // namespace

// dQ (B, Sq, H, 128) bf16. lse, dsum (B, H, Sq) fp32.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dsum, void* dq, int B, int Sq,
                                 int Skv, int H, int D, float scale,
                                 void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  const cudaError_t err = allow_smem(flash_bwd_dq_wgmma_kernel, kSmem6Bytes, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];
  const int map_err = bwd_maps(maps, q, k, v, dout, B, Sq, Skv, H, kQ6, kKv6);
  if (map_err != 0) return map_err;
  const dim3 grid((Sq + kQ6 - 1) / kQ6, B * H);
  flash_bwd_dq_wgmma_kernel<<<grid, kWsThreads, kSmem6Bytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, scale);
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
  const cudaError_t err = allow_smem(flash_bwd_dkv_wgmma_kernel, kSmem7Bytes, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];
  const int map_err = bwd_maps(maps, q, k, v, dout, B, Sq, Skv, H, kQ7, kKv7);
  if (map_err != 0) return map_err;
  const dim3 grid((Skv + kKv7 - 1) / kKv7, B * H);
  flash_bwd_dkv_wgmma_kernel<<<grid, kWsThreads, kSmem7Bytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Skv, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- X2

namespace {

// X2's tiles and fragment loads (the mma.sync design): 256 threads, rows
// padded to kLd bf16 in shared memory for conflict-free fragment reads.
using ce::lds32;
using ce::mma_16816;

constexpr int kLd = kD + 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ6 = kWarps * 16;   // dQ: 128 q rows a block
constexpr int kBKV6 = 64;           // x 64-row KV tiles
constexpr int kBKV7 = kWarps * 16;  // dK, dV: 128 KV rows a block
constexpr int kBQ7 = 32;            // x 32-row q tiles

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
