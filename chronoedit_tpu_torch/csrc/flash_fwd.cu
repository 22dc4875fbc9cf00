// K1 and K5: non-causal flash-attention forward, bf16 in, bf16 out + fp32 LSE.
//
// Replaces the Pallas kernels chronoedit_tpu/ops/flash_attention.py:188
// `_fwd_kernel_resident` (K1: KV resident in VMEM, the edit's 7,200 tokens
// and the cross-attention) and :227 `_fwd_kernel_streamed` (K5: KV streamed
// through the grid, reasoning self-attention at 28,800 tokens), both
// launched by `_forward`. The TPU split follows VMEM's size; this kernel
// streams KV tiles through a shared-memory ring at every length, so one
// kernel covers both.
//
//   O[b, s, h, :] = softmax(scale * q k^T) v,  LSE[b, h, s] = logsumexp(scale * q k^T)
//   q (B, Sq, H, 128), k/v (B, Skv, H, 128), all contiguous BSHD.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): tensor-core FLOPs,
// 4 Sq Skv 128 a head: 1.073 ms for (1, 7,200, 40, 128) self-attention and
// 17.18 ms at 28,800 tokens. The cross-attention calls (q 7,200 against KV
// 512 and 257) are small: reading q and writing O (74 MB each) bound them
// at 0.048 ms, under the 0.076 ms of FLOPs at KV 512 and over the 0.038 ms
// at 257.
//
// Design, `flash_fwd_wgmma_kernel`: Hopper's warp-specialised shape.
// - Grid (ceil(Sq / 128), B * H); 384 threads, three warpgroups. Warpgroup 0
//   is the producer: one thread issues TMA, and `setmaxnreg` drops the group
//   to 24 registers. Warpgroups 1 and 2 are consumers, 64 q rows each, at
//   240 registers (128 x (24 + 2 x 240) = 64,512 of the SM's 65,536).
// - TMA straight from BSHD: one 4-D tensor map per operand over (128, H, S,
//   B), box (64, 1, 128, 1) with 128-byte swizzle, so a 128 x 128 tile is
//   two 64-column boxes. Rows past S are zero-filled by the hardware and
//   never read from the next batch: no row checks for the ragged q tail
//   (7,200 = 56 x 128 + 32) or the KV tails.
// - Shared memory: q (32 KB, loaded once) and a ring of two stages of K and
//   V tiles of 128 rows (32 KB each; 160 KB in all), each with a full and an
//   empty mbarrier. The producer waits on empty and arms full with the byte
//   count; a consumer waits on full, and each of its warps arrives on K's
//   empty once its S product has retired and on V's once its P.V has.
//   Three stages (224 KB) measured no faster.
// - S = q k^T: wgmma m64n128k16, both operands from shared memory
//   (K-major), 8 k-steps over D. O += P V: the register-A form, P converted
//   to bf16 in registers from S's accumulator fragment, V from shared memory
//   with the transpose bit (V is MN-major here).
// - FA3's two overlaps, each kept because it measured faster: a consumer
//   issues tile i's QK^T and tile i-1's P.V together and runs tile i's
//   softmax while the P.V runs (tile i-1's P stays in registers meanwhile:
//   64 + 64 fp32 and 32 bf16 pairs a thread, no spill); and the two
//   consumers take turns to issue their products (ping-pong on named
//   barriers), so one's softmax runs under the other's products.
// - K1's numerics: fp32 scores times scale * log2 e; columns >= Skv in the
//   last tile set to -inf (zero-filled K would score 0); fp32 running max
//   and sum with the base = 0 guard for all-masked rows; exp2f; P rounded to
//   bf16 before P.V with fp32 accumulation; O divided by l once and rounded
//   once; LSE = (m + log2 l) ln 2 to (B, H, Sq) fp32. Rows >= Sq are never
//   written. Only the 128-column tile (against 64) moves where the running
//   max changes.
// What this answers in the mma.sync design it replaces (flash_fwd_kernel):
// (1) its synchronous 16-byte loads between two __syncthreads,
// which nothing overlapped with one 8-warp block an SM, are TMA loads into
// the ring, in flight while the consumers compute; (2) mma.sync m16n8k16
// is wgmma; (3) the V fragments packed from four 2-byte shared loads each
// are read by wgmma from the swizzled tile with the transpose bit; (4) the
// 64-float accumulator is rescaled once every 128 KV columns, not 64.
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
#include "sm90.cuh"

namespace {

constexpr int kD = 128;
constexpr int kBQ = 128;
constexpr int kBKV = 64;
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;  // padded smem row (bf16): conflict-free fragment reads

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

// ---------------------------------------------------------------- K1 / K5

constexpr int kTile = 128;                  // q rows a block; KV rows a ring stage
constexpr int kBoxBytes = sm90::box_bytes(kTile);  // one 64-column TMA box: 128 rows x 128 B
constexpr int kTileBytes = 2 * kBoxBytes;   // a 128 x 128 bf16 tile
constexpr int kWsThreads = 3 * 128;         // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;           // arrivals that empty a stage
constexpr int kStages = 2;                  // K and V tiles in the ring
// byte offsets from the 1,024-aligned base of dynamic shared memory: q, the
// K ring, the V ring, then the mbarriers (q_full, and k_full, k_empty,
// v_full, v_empty for each stage)
constexpr int kSmemQ = 0;
constexpr int kSmemK = kTileBytes;
constexpr int kSmemV = kSmemK + kStages * kTileBytes;
constexpr int kSmemBar = kSmemV + kStages * kTileBytes;
constexpr int kSmemBytes = kSmemBar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack

// ---- the consumer's steps, on one warpgroup's 64 q rows. Fragments: s[4j +
// e] and acc[4j + e] hold row g + 8 (e >> 1), column 8j + 2 t4 + (e & 1) of
// the warp's 16 rows (g = lane / 4, t4 = lane % 4).

// The online-softmax update of one tile of scores, in place: s becomes the
// fp32 P (scaled to log2, masked past Skv, exp2 against the new running
// max); m_run and l_run move on; returns each row's rescale factor in alpha.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2], int kv0, int Skv, int t4,
                                             float scale_log2) {
  const bool tail = kv0 + kTile > Skv;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (tail && kv0 + 8 * j + 2 * t4 + (e & 1) >= Skv) x = -INFINITY;
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float base[2];
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
  for (int i = 0; i < 64; ++i) {
    s[i] = exp2f(s[i] - base[(i >> 1) & 1]);
    l_run[(i >> 1) & 1] += s[i];
  }
}

__device__ __forceinline__ void rescale(float (&acc)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int Sq, int Skv, int H, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ring_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kSmemBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kTile;
  const int n_tiles = (Skv + kTile - 1) / kTile;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], kConsumerWarps);
      sm90::mbar_init(&v_empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(q_full, kTileBytes);
      sm90::tma_load_4d(smem + kSmemQ, &tq, q_full, 0, h, q0, b);
      sm90::tma_load_4d(smem + kSmemQ + kBoxBytes, &tq, q_full, 64, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kv0 = 0; kv0 < Skv; kv0 += kTile) {
        unsigned char* ks = smem + kSmemK + stage * kTileBytes;
        unsigned char* vs = smem + kSmemV + stage * kTileBytes;
        sm90::mbar_wait(&k_empty[stage], phase ^ 1);  // the first round passes
        sm90::mbar_arrive_expect_tx(&k_full[stage], kTileBytes);
        sm90::tma_load_4d(ks, &tk, &k_full[stage], 0, h, kv0, b);
        sm90::tma_load_4d(ks + kBoxBytes, &tk, &k_full[stage], 64, h, kv0, b);
        sm90::mbar_wait(&v_empty[stage], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&v_full[stage], kTileBytes);
        sm90::tma_load_4d(vs, &tv, &v_full[stage], 0, h, kv0, b);
        sm90::tma_load_4d(vs + kBoxBytes, &tv, &v_full[stage], 64, h, kv0, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each; warp w owns rows 16w..16w+15 of them
    sm90::reg_alloc<240>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    // this warpgroup's 64 q rows: 8 KB into each 64-column box
    const uint32_t q_addr = sm90::smem_u32(smem + kSmemQ) + c * 64 * 128;
    const uint32_t k_base = sm90::smem_u32(smem + kSmemK);
    const uint32_t v_base = sm90::smem_u32(smem + kSmemV);

    float acc[64], s[64], alpha[2];
    uint32_t p[kTile / 16][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = s[i] = 0.f;
    // running max (log2 domain) and this thread's partial row sums, rows g and g+8
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    sm90::mbar_wait(q_full, 0);
    // Tile 0's scores and softmax; then each step issues tile it's QK^T
    // and tile it-1's P.V, runs tile it's softmax under the P.V, and
    // rescales O once the P.V has retired. The two warpgroups take turns
    // to issue (ping-pong on named barriers 1 and 2), so that one's
    // softmax runs under the other's products. Each warpgroup's syncs
    // meet as many arrivals: the second skips its last.
    if (c == 1) sm90::named_arrive(1);  // the first warpgroup issues first
    sm90::mbar_wait(&k_full[0], 0);
    sm90::named_sync(1 + c);
    sm90::wgmma_fence();
    sm90::issue_abt<kTile, kTile>(s, q_addr, k_base);  // S = q k^T
    sm90::wgmma_commit();
    if (!(c == 1 && n_tiles == 1)) sm90::named_arrive(2 - c);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    if (lane == 0) sm90::mbar_arrive(&k_empty[0]);
    softmax_tile(s, m_run, l_run, alpha, 0, Skv, t4, scale_log2);
    sm90::to_a_frags(p, s);
    int prev = 0, stage = 0;
    uint32_t prev_phase = 0, phase = 0;
    for (int it = 1; it < n_tiles; ++it) {
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      sm90::mbar_wait(&k_full[stage], phase);
      sm90::mbar_wait(&v_full[prev], prev_phase);
      sm90::named_sync(1 + c);
      sm90::wgmma_fence();
      sm90::issue_abt<kTile, kTile>(s, q_addr, k_base + stage * kTileBytes);
      sm90::wgmma_commit();
      sm90::issue_ab<kTile>(acc, p, v_base + prev * kTileBytes);  // O += P V
      sm90::wgmma_commit();
      if (!(c == 1 && it == n_tiles - 1)) sm90::named_arrive(2 - c);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      if (lane == 0) sm90::mbar_arrive(&k_empty[stage]);
      softmax_tile(s, m_run, l_run, alpha, it * kTile, Skv, t4, scale_log2);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(p);
      if (lane == 0) sm90::mbar_arrive(&v_empty[prev]);
      rescale(acc, alpha);
      sm90::to_a_frags(p, s);
      prev = stage;
      prev_phase = phase;
    }
    sm90::mbar_wait(&v_full[prev], prev_phase);
    sm90::wgmma_fence();
    sm90::issue_ab<kTile>(acc, p, v_base + prev * kTileBytes);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (lane == 0) sm90::mbar_arrive(&v_empty[prev]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const float ln2 = 0.6931471805599453f;
    const size_t row_stride = static_cast<size_t>(H) * kD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + c * 64 + warp * 16 + g + r * 8;
      if (row >= Sq) continue;
      const float inv = 1.f / l_run[r];
      __nv_bfloat16* orow = o + (static_cast<size_t>(b) * Sq + row) * row_stride +
                            static_cast<size_t>(h) * kD + t4 * 2;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            ce::pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      if (t4 == 0)
        lse[static_cast<size_t>(bh) * Sq + row] = (m_run[r] + log2f(l_run[r])) * ln2;
    }
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
        flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  int err = sm90::bshd_map(&tq, q, B, Sq, H, kTile);
  if (err == 0) err = sm90::bshd_map(&tk, k, B, Skv, H, kTile);
  if (err == 0) err = sm90::bshd_map(&tv, v, B, Skv, H, kTile);
  if (err != 0) return err;
  const dim3 grid((Sq + kTile - 1) / kTile, B * H);
  flash_fwd_wgmma_kernel<<<grid, kWsThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Sq, Skv, H,
      scale * 1.4426950408889634f);
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
