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
// What this answers in the mma.sync design it replaced: (1) its synchronous
// 16-byte loads between two __syncthreads, which nothing overlapped with one
// 8-warp block an SM, are TMA loads into the ring, in flight while the
// consumers compute; (2) mma.sync m16n8k16 is wgmma; (3) the V fragments
// packed from four 2-byte shared loads each are read by wgmma from the
// swizzled tile with the transpose bit; (4) the 64-float accumulator is
// rescaled once every 128 KV columns, not 64.
//
// X1: the grouped forward, `flash_fwd_grouped_wgmma_kernel<N>` behind
// `flash_fwd_grouped_bf16(..., group)`, N = 2, 3 or 4. Replaces the Pallas
// kernel tools/exp_flash_paired.py `_grouped_kernel` (launched by
// `paired_flash`), whose design became the TPU's production streamed
// forward (`_fwd_kernel_streamed` with `group`). Same function as K1/K5,
// same bound, the same machinery: 384 threads, the producer at 24
// registers, two consumers of 64 q rows at 240, q resident from TMA, the
// ping-pong of the score products. What it asks is the TPU experiment's
// question: a step is N 64-row KV tiles behind one full/empty barrier pair
// for K and one for V (one TMA box of 64 N rows a 64-column half); a
// consumer issues all N x 8 score k-steps (m64n64k16) in one commit group
// before any softmax work, takes one combined row max, one alpha and one
// rescale of O a step, then for each tile converts P to bf16 A fragments
// and issues its P.V (m64n128k16, register A, V with the transpose bit) at
// once, so that the next tile's exponentials run under it. K1's
// intra-warpgroup overlap (tile i's scores under tile i-1's P.V) is not
// kept: it would hold a step's P (16 N) beside its scores (32 N) and O
// (64), 256 registers at N = 4. Here a step's first score k-step writes
// its accumulator without reading it, so S_i's registers are free until
// the step starts and again once P_i is built: at most 32 N + 64 + 16 live
// fp32 values. K1's numerics are kept (fp32 scores times scale * log2 e,
// columns >= Skv set to -inf, the base = 0 guard, exp2, P rounded to bf16,
// one divide, LSE through log2); only the running max a tile's P is taken
// against differs, so outputs agree with K1's to bf16 rounding.
// Dynamic shared memory: q 32 KB and two stages of K and of V of N x 16 KB
// each at N = 2 and 3 (160 and 224 KB); at N = 4 two V stages would make
// 288 KB, so V has one (224 KB): the next step's K lands while this step's
// P.V reads V, and its V once that P.V has retired. The ping-pong won every
// same-call pair against a build without it (N = 2-4, 7,200 and 28,800
// tokens), so it stays. Registers: the consumers' SASS reaches R171, R222
// and R237 of 240 (N = 2, 3, 4) with no local memory; N = 4 fits only with
// the barriers kept as 32-bit shared addresses and q's descriptors rebuilt
// each step (both in the kernel).
#include <math.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kD = 128;

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

// O = acc / l in bf16 and LSE = (m + log2 l) ln 2 for a thread's rows
// row0 and row0 + 8 (its partial sums of l reduced over the quad first);
// rows at or past Sq are never written.
__device__ __forceinline__ void store_out(const float (&acc)[64], const float (&m_run)[2],
                                          float (&l_run)[2], __nv_bfloat16* o, float* lse,
                                          int b, int h, int Sq, int H, int row0, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float ln2 = 0.6931471805599453f;
  const size_t row_stride = static_cast<size_t>(H) * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= Sq) continue;
    const float inv = 1.f / l_run[r];
    __nv_bfloat16* orow = o + (static_cast<size_t>(b) * Sq + row) * row_stride +
                          static_cast<size_t>(h) * kD + t4 * 2;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          ce::pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if (t4 == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = (m_run[r] + log2f(l_run[r])) * ln2;
  }
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

    store_out(acc, m_run, l_run, o, lse, b, h, Sq, H, q0 + c * 64 + warp * 16 + g, t4);
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

// X1's shared memory for N 64-row KV tiles a step: q, then the K ring and
// the V ring (a stage is one step's N tiles of K, or of V: two 64-column
// boxes of 64 N rows), then the mbarriers (q_full; k_full, k_empty for each
// K stage; v_full, v_empty for each V stage). Two stages of each at N = 2
// and 3 (160 and 224 KB); at N = 4 two of 64 KB would need 288 KB, so V
// gets one (224 KB) and K keeps two, which lets the next step's K land
// while this step's P.V still reads V.
template <int N>
struct Grouped {
  static constexpr int kStep = 64 * N;                     // KV rows a step
  static constexpr int kHalf = sm90::box_bytes(kStep);     // one 64-column box of a step
  static constexpr int kStepBytes = 2 * kHalf;             // K (or V) of one step
  static constexpr int kKStages = 2;
  static constexpr int kVStages = N == 4 ? 1 : 2;
  static constexpr int kSmemK = kTileBytes;
  static constexpr int kSmemV = kSmemK + kKStages * kStepBytes;
  static constexpr int kSmemBar = kSmemV + kVStages * kStepBytes;
  static constexpr int kSmemBytes = kSmemBar + 8 * (1 + 2 * (kKStages + kVStages)) + 1024;
  static_assert(kSmemBytes <= 232448, "one block's shared memory");
};

template <int N>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_grouped_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                               int Sq, int Skv, int H, float scale_log2) {
  using G = Grouped<N>;
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ring_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + G::kSmemBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + G::kKStages;
  uint64_t* v_full = k_empty + G::kKStages;
  uint64_t* v_empty = v_full + G::kVStages;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kTile;
  const int n_steps = (Skv + G::kStep - 1) / G::kStep;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < G::kKStages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&k_empty[s], kConsumerWarps);
    }
    for (int s = 0; s < G::kVStages; ++s) {
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&v_empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps both rings full, a step's N tiles of
    // K (then of V) behind one barrier pair
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(q_full, kTileBytes);
      sm90::tma_load_4d(smem + kSmemQ, &tq, q_full, 0, h, q0, b);
      sm90::tma_load_4d(smem + kSmemQ + kBoxBytes, &tq, q_full, 64, h, q0, b);
      int ks = 0, vs = 0;
      uint32_t kph = 0, vph = 0;
      for (int kv0 = 0; kv0 < Skv; kv0 += G::kStep) {
        unsigned char* kd = smem + G::kSmemK + ks * G::kStepBytes;
        unsigned char* vd = smem + G::kSmemV + vs * G::kStepBytes;
        sm90::mbar_wait(&k_empty[ks], kph ^ 1);  // the first round passes
        sm90::mbar_arrive_expect_tx(&k_full[ks], G::kStepBytes);
        sm90::tma_load_4d(kd, &tk, &k_full[ks], 0, h, kv0, b);
        sm90::tma_load_4d(kd + G::kHalf, &tk, &k_full[ks], 64, h, kv0, b);
        sm90::mbar_wait(&v_empty[vs], vph ^ 1);
        sm90::mbar_arrive_expect_tx(&v_full[vs], G::kStepBytes);
        sm90::tma_load_4d(vd, &tv, &v_full[vs], 0, h, kv0, b);
        sm90::tma_load_4d(vd + G::kHalf, &tv, &v_full[vs], 64, h, kv0, b);
        sm90::next_stage(ks, kph, G::kKStages);
        sm90::next_stage(vs, vph, G::kVStages);
      }
    }
  } else {
    // ---- consumers: 64 q rows each; warp w owns rows 16w..16w+15 of them.
    // s[i][4j + e]: row g + 8 (e >> 1), column 64 i + 8j + 2 t4 + (e & 1) of
    // the step's 64 N KV columns.
    sm90::reg_alloc<240>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t q_addr = sm90::smem_u32(smem + kSmemQ) + c * 64 * 128;
    const uint32_t k_base = sm90::smem_u32(smem + G::kSmemK);
    const uint32_t v_base = sm90::smem_u32(smem + G::kSmemV);
    // the barriers by 32-bit shared address (8 B each, in the order above):
    // four generic pointers would hold eight of the registers N = 4 lacks
    const uint32_t bars = sm90::smem_u32(q_full);
    const uint32_t k_full_a = bars + 8, k_empty_a = k_full_a + 8 * G::kKStages;
    const uint32_t v_full_a = k_empty_a + 8 * G::kKStages;
    const uint32_t v_empty_a = v_full_a + 8 * G::kVStages;

    float acc[64], s[N][32];
    uint32_t p[N][4][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    sm90::mbar_wait(bars, 0);
    // Each step: the N score products (m64n64, 8 k-steps each) in one
    // commit group; once they retire, one combined row max, one alpha and
    // one rescale of O; then tile by tile the exponentials, P to bf16 A
    // fragments and that tile's P.V, issued at once, so that the next
    // tile's exponentials run under it. The two warpgroups take turns to
    // issue their score products (named barriers 1 and 2), so that one's
    // softmax runs under the other's products; each warpgroup's syncs meet
    // as many arrivals: the second skips its last.
    if (c == 1) sm90::named_arrive(1);  // the first warpgroup issues first
    int ks = 0, vs = 0;
    uint32_t kph = 0, vph = 0;
    for (int it = 0; it < n_steps; ++it) {
      const int kv0 = it * G::kStep;
      const uint32_t k_addr = k_base + ks * G::kStepBytes;
      const uint32_t v_addr = v_base + vs * G::kStepBytes;
      // q's address made opaque each step: its 8 descriptors are rebuilt
      // here instead of held in registers through the softmax
      uint32_t qa = q_addr;
      asm volatile("" : "+r"(qa));
      sm90::mbar_wait(k_full_a + 8 * ks, kph);
      sm90::named_sync(1 + c);
      sm90::wgmma_fence();
#pragma unroll
      for (int i = 0; i < N; ++i)  // S_i = q k_i^T; tile i starts 64 i rows (8 KB) in
        sm90::issue_abt<kTile, G::kStep, true>(s[i], qa, k_addr + i * sm90::box_bytes(64));
      sm90::wgmma_commit();
      if (!(c == 1 && it == n_steps - 1)) sm90::named_arrive(2 - c);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      if (lane == 0) sm90::mbar_arrive(k_empty_a + 8 * ks);

      // one combined row max over the N tiles (scaled to log2, masked past Skv)
      const bool tail = kv0 + G::kStep > Skv;
      const int live = Skv - kv0 - 2 * t4;  // a column is masked at 64 i + 8 j + (e & 1) >= live
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[i][4 * j + e] * scale_log2;
            if (tail && 64 * i + 8 * j + (e & 1) >= live) x = -INFINITY;
            s[i][4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      float base[2], alpha[2];
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
      rescale(acc, alpha);

      sm90::mbar_wait(v_full_a + 8 * vs, vph);
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          s[i][k] = exp2f(s[i][k] - base[(k >> 1) & 1]);
          l_run[(k >> 1) & 1] += s[i][k];
        }
        sm90::to_a_frags(p[i], s[i]);
        sm90::wgmma_fence();
        sm90::issue_ab<64, G::kStep>(acc, p[i], v_addr + i * sm90::box_bytes(64));  // O += P_i V_i
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < N; ++i) sm90::fence_regs(p[i]);
      if (lane == 0) sm90::mbar_arrive(v_empty_a + 8 * vs);
      sm90::next_stage(ks, kph, G::kKStages);
      sm90::next_stage(vs, vph, G::kVStages);
    }
    store_out(acc, m_run, l_run, o, lse, b, h, Sq, H, q0 + c * 64 + warp * 16 + g, t4);
  }
}

template <int N>
int launch_grouped(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int Sq, int Skv, int H, float scale, void* stream) {
  using G = Grouped<N>;
  static bool attr_set = false;  // one flag per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_grouped_wgmma_kernel<N>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 G::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  int err = sm90::bshd_map(&tq, q, B, Sq, H, kTile);
  if (err == 0) err = sm90::bshd_map(&tk, k, B, Skv, H, G::kStep);
  if (err == 0) err = sm90::bshd_map(&tv, v, B, Skv, H, G::kStep);
  if (err != 0) return err;
  const dim3 grid((Sq + kTile - 1) / kTile, B * H);
  flash_fwd_grouped_wgmma_kernel<N>
      <<<grid, kWsThreads, G::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Sq, Skv, H,
          scale * 1.4426950408889634f);
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
