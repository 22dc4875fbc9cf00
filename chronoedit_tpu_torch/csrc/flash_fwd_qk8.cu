// K9: non-causal flash-attention forward with int8 scores, bf16 P.V, bf16 out.
//
// Replaces the Pallas kernel chronoedit_tpu/ops/flash_attention.py:326
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
// Design, `flash_fwd_qk8_wgmma_kernel`: K1's warp-specialised shape
// (flash_fwd.cu, `flash_fwd_wgmma_kernel`) with int8 scores.
// - Grid (ceil(Sq / 128), B * H); 384 threads. Warpgroup 0 is the producer
//   (`setmaxnreg` to 32 registers): one thread issues TMA, and its warp
//   stages each KV tile's 128 k scales with ordinary loads (ks is strided by
//   H, so TMA cannot box it; 0 past Skv), loaded a tile ahead and stored
//   permuted so that a consumer thread reads its 32 with eight 16-byte
//   loads, and arrives with its 32 lanes beside the TMA thread's expect_tx
//   (33 arrivals). Warpgroups 1 and 2 consume, 64 q rows each, at 232
//   registers (128 x (32 + 2 x 232) = 63,488 of the 64,512 the launch
//   holds: asking for all 65,536, with 240, never returned).
// - TMA from BSHD: q8 and k8 through 4-D int8 maps (box: 128 rows of one
//   128-byte head row, 128-byte swizzle), V through K1's bf16 map (two
//   64-column boxes). Rows past S are zero-filled, never read from the next
//   batch. Shared memory: q8 (16 KB, loaded once) and a two-stage ring of
//   k8 (16 KB), ks (576 B) and V (32 KB) tiles of 128 rows, each K and V
//   stage with a full and an empty mbarrier.
// - S = q8 k8^T with wgmma m64n128k32 s8 x s8 -> s32, both operands K-major
//   from shared memory: 4 k-steps of 32 bytes, +32 B inside the one swizzled
//   box (SBO 1,024 B). The s32 accumulator is dequantized in JAX's order,
//   float(acc) * (qs * scale) * ks_j (exact: |q8 . k8| <= 127^2 * 128 <
//   2^24); columns >= Skv are -inf.
// - Softmax and P.V are K1's: fp32 running max and sum in the log2 domain
//   with the base = 0 guard, exp2f (of y log2 e - base in one FFMA, as FA3
//   computes it), P rounded to bf16 and multiplied by the MN-major V tile
//   through the register-A wgmma, O divided by l once and rounded once. No
//   LSE: JAX's int8-score forward returns only O. Rows >= Sq are never
//   written.
// - K1's two overlaps: tile i's score product and tile i-1's P.V are issued
//   together and tile i's softmax runs under the P.V; the two consumers take
//   turns to issue (ping-pong on named barriers 1 and 2). The register
//   budget is K1's (64 scores, s32 and then fp32 in the same registers, 64
//   O, 32 P).
// - What bounds it on the card is the score epilogue's issue slots, not the
//   tensor cores: the s8 scores take half the time of K1's bf16 ones, but
//   every score costs two more instructions (the conversion and the two
//   dequantization multiplies against K1's one scaling), and on an H100
//   (80GB HBM3, 700 W) variants with the multiplies or the exponentials left
//   out ran clearly faster in same-round pairs, while a third ring stage or
//   no ping-pong did not.
// What this answers in the mma.sync design it replaces: (1) its
// synchronous 16-byte loads of k8, V and ks between two __syncthreads,
// which nothing overlapped, are TMA loads into the ring (ks by the
// producer warp), in flight while the consumers compute; (2) mma.sync
// m16n8k32 / m16n8k16 fed by 32-bit shared loads is wgmma reading the
// swizzled tiles; (3) the V fragments packed from four 2-byte shared loads
// each are read with the transpose bit; (4) the accumulator is rescaled
// once every 128 KV columns, not 64.
#include <math.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kD = 128;
constexpr int kTile = 128;                         // q rows a block; KV rows a ring stage
constexpr int kI8TileBytes = kTile * kD;           // a 128 x 128 int8 tile: one box
constexpr int kBoxBytes = sm90::box_bytes(kTile);  // one 64-column bf16 box
constexpr int kVTileBytes = 2 * kBoxBytes;         // a 128 x 128 bf16 tile
constexpr int kThreads = 3 * 128;                  // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;                  // arrivals that empty a stage
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
// byte offsets from the 1,024-aligned base of dynamic shared memory: q8, the
// k8 ring, the V ring, the ks ring, then the mbarriers (q_full, and k_full,
// k_empty, v_full, v_empty for each stage)
constexpr int kSmemQ = 0;
constexpr int kSmemK = kI8TileBytes;
constexpr int kSmemV = kSmemK + kStages * kI8TileBytes;
constexpr int kSmemKs = kSmemV + kStages * kVTileBytes;
// a stage's 128 k scales, permuted so that thread t4's 32 columns (8j + 2 t4,
// +1 for j < 16) are contiguous: row t4 of kKsLd floats (padded by 4, so the
// four rows' 16-byte reads fall in distinct banks)
constexpr int kKsLd = kTile / 4 + 4;
constexpr int kKsStage = 4 * kKsLd;
constexpr int kSmemBar = kSmemKs + kStages * kKsStage * 4;
constexpr int kSmemBytes = kSmemBar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack

// S = q8 k8^T over D = 128 (4 k-steps of 32 bytes), issued, not committed:
// 64 q rows of the q8 tile at `a` against the 128 k8 rows at `b`.
__device__ __forceinline__ void issue_scores(int32_t (&d)[64], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kD / 32; ++kk)
    sm90::wgmma_m64n128k32_s8(d, sm90::smem_desc(a + kk * 32, 16, 1024),
                              sm90::smem_desc(b + kk * 32, 16, 1024), kk > 0);
}

// One tile of s32 scores to the fp32 P of the online softmax, in place: s
// holds the wgmma's s32 scores and leaves with P's fp32 bits (one register
// array for both, so the budget stays K1's). The score is dequantized in
// JAX's order, y = float(acc) * (qs * scale) * ks, and masked past Skv; the
// row max moves to the log2 domain once a row (rounding is monotone, so
// round(max y * log2 e) is the max of the rounded scaled scores), and each
// P is exp2(y * log2 e - base) with the scaling and the subtraction in one
// FFMA, as FA3 does; m_run and l_run move on; returns each row's rescale
// factor in alpha. Fragments: s[4j + e] holds row g + 8 (e >> 1), column 8j +
// 2 t4 + (e & 1) of the warp's 16 rows; ks_row is the thread's permuted k
// scales.
__device__ __forceinline__ void softmax_tile(int32_t (&s)[64], const float (&row_mult)[2],
                                             const float* ks_row, float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int kv0,
                                             int Skv, int t4) {
  const bool tail = kv0 + kTile > Skv;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j2 = 0; j2 < kTile / 16; ++j2) {
    const float4 kscale = *reinterpret_cast<const float4*>(ks_row + 4 * j2);
    const float kc[4] = {kscale.x, kscale.y, kscale.z, kscale.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // columns 8 (2 j2 + (i >> 2)) + 2 t4 + (i & 1)
      const int j = 2 * j2 + (i >> 2), e = i & 3;
      float y = static_cast<float>(s[4 * j + e]) * row_mult[e >> 1] * kc[2 * (i >> 2) + (e & 1)];
      if (tail && kv0 + 8 * j + 2 * t4 + (e & 1) >= Skv) y = -INFINITY;
      s[4 * j + e] = __float_as_int(y);
      mx[e >> 1] = fmaxf(mx[e >> 1], y);
    }
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * kLog2e);
    base[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = exp2f(m_run[r] - base[r]);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float pi = exp2f(fmaf(__int_as_float(s[i]), kLog2e, -base[(i >> 1) & 1]));
    s[i] = __float_as_int(pi);
    l_run[(i >> 1) & 1] += pi;
  }
}

// P (fp32 bits in s) in bf16 as the A fragments of the 8 k-steps of P.V, as
// sm90::to_a_frags
__device__ __forceinline__ void p_frags(uint32_t (&a)[kTile / 16][4], const int32_t (&s)[64]) {
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kc][r] = ce::pack_bf16(__int_as_float(s[8 * kc + 2 * r]),
                               __int_as_float(s[8 * kc + 2 * r + 1]));
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_qk8_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const float* __restrict__ qs, const float* __restrict__ ks,
                           __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H, float scale) {
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ring_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kSmemBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;
  float* ks_ring = reinterpret_cast<float*>(smem + kSmemKs);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kTile;
  const int n_tiles = (Skv + kTile - 1) / kTile;
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], 1 + 32);  // the TMA thread's expect_tx + the warp's ks
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], kConsumerWarps);
      sm90::mbar_init(&v_empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one warp; lane 0 issues TMA, all 32 stage ks
    sm90::reg_dealloc<32>();
    if (threadIdx.x < 32) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(q_full, kI8TileBytes);
        sm90::tma_load_4d(smem + kSmemQ, &tq, q_full, 0, h, q0, b);
      }
      const float* ks_b = ks + static_cast<size_t>(b) * Skv * H + h;
      // this lane's 4 k scales of a tile (columns lane + 32 r), loaded one
      // tile ahead so that their latency hides behind the ring's waits
      float kv[4];
      auto load_ks = [&](int kv0) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = kv0 + lane + 32 * r;
          kv[r] = col < Skv ? ks_b[static_cast<size_t>(col) * H] : 0.f;
        }
      };
      load_ks(0);
      int stage = 0;
      uint32_t phase = 0;
      for (int kv0 = 0; kv0 < Skv; kv0 += kTile) {
        sm90::mbar_wait(&k_empty[stage], phase ^ 1);  // the first round passes
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&k_full[stage], kI8TileBytes);
          sm90::tma_load_4d(smem + kSmemK + stage * kI8TileBytes, &tk, &k_full[stage], 0, h,
                            kv0, b);
        }
        float* kst = ks_ring + stage * kKsStage;
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // column i = 8j + 2 t4 + e to row t4, slot 2j + e
          const int i = lane + 32 * r;
          kst[((i >> 1) & 3) * kKsLd + 2 * (i >> 3) + (i & 1)] = kv[r];
        }
        sm90::mbar_arrive(&k_full[stage]);
        if (kv0 + kTile < Skv) load_ks(kv0 + kTile);
        sm90::mbar_wait(&v_empty[stage], phase ^ 1);
        if (lane == 0) {
          unsigned char* vs = smem + kSmemV + stage * kVTileBytes;
          sm90::mbar_arrive_expect_tx(&v_full[stage], kVTileBytes);
          sm90::tma_load_4d(vs, &tv, &v_full[stage], 0, h, kv0, b);
          sm90::tma_load_4d(vs + kBoxBytes, &tv, &v_full[stage], 64, h, kv0, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each; warp w owns rows 16w..16w+15 of them
    sm90::reg_alloc<232>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    // this warpgroup's 64 q8 rows: 8 KB into the one box
    const uint32_t q_addr = sm90::smem_u32(smem + kSmemQ) + c * 64 * 128;
    const uint32_t k_base = sm90::smem_u32(smem + kSmemK);
    const uint32_t v_base = sm90::smem_u32(smem + kSmemV);
    // the per-row dequantization factor qs * scale of rows g and g + 8
    float row_mult[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + c * 64 + warp * 16 + g + r * 8;
      row_mult[r] = row < Sq ? qs[(static_cast<size_t>(b) * Sq + row) * H + h] * scale : 0.f;
    }

    float acc[64], alpha[2];
    int32_t s[64];
    uint32_t p[kTile / 16][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      s[i] = 0;
    }
    // running max (log2 domain) and this thread's partial row sums, rows g and g+8
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    sm90::mbar_wait(q_full, 0);
    // K1's schedule: tile 0's scores and softmax; then each step issues
    // tile it's scores and tile it-1's P.V, runs tile it's softmax under
    // the P.V, and rescales O once the P.V has retired. The warpgroups take
    // turns to issue (ping-pong on named barriers 1 and 2); each one's syncs
    // meet as many arrivals: the second skips its last.
    if (c == 1) sm90::named_arrive(1);  // the first warpgroup issues first
    sm90::mbar_wait(&k_full[0], 0);
    sm90::named_sync(1 + c);
    sm90::wgmma_fence();
    issue_scores(s, q_addr, k_base);
    sm90::wgmma_commit();
    if (!(c == 1 && n_tiles == 1)) sm90::named_arrive(2 - c);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    const float* ks_row = ks_ring + t4 * kKsLd;
    softmax_tile(s, row_mult, ks_row, m_run, l_run, alpha, 0, Skv, t4);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&k_empty[0]);  // k8 and ks read
    p_frags(p, s);
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
      issue_scores(s, q_addr, k_base + stage * kI8TileBytes);
      sm90::wgmma_commit();
      sm90::issue_ab<kTile>(acc, p, v_base + prev * kVTileBytes);  // O += P V
      sm90::wgmma_commit();
      if (!(c == 1 && it == n_tiles - 1)) sm90::named_arrive(2 - c);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      softmax_tile(s, row_mult, ks_row + stage * kKsStage, m_run, l_run, alpha, it * kTile,
                   Skv, t4);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&k_empty[stage]);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(p);
      if (lane == 0) sm90::mbar_arrive(&v_empty[prev]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
      p_frags(p, s);
      prev = stage;
      prev_phase = phase;
    }
    sm90::mbar_wait(&v_full[prev], prev_phase);
    sm90::wgmma_fence();
    sm90::issue_ab<kTile>(acc, p, v_base + prev * kVTileBytes);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (lane == 0) sm90::mbar_arrive(&v_empty[prev]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
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
    }
  }
}

}  // namespace

extern "C" int flash_fwd_qk8_bf16(const void* q8, const void* k8, const void* v,
                                  const void* qs, const void* ks, void* o, int B, int Sq,
                                  int Skv, int H, int D, float scale, void* stream) {
  if (D != kD || B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_qk8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  int err = sm90::bshd_map(&tq, q8, B, Sq, H, kTile, 1);
  if (err == 0) err = sm90::bshd_map(&tk, k8, B, Skv, H, kTile, 1);
  if (err == 0) err = sm90::bshd_map(&tv, v, B, Skv, H, kTile);
  if (err != 0) return err;
  const dim3 grid((Sq + kTile - 1) / kTile, B * H);
  flash_fwd_qk8_wgmma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<const float*>(qs), static_cast<const float*>(ks),
      static_cast<__nv_bfloat16*>(o), Sq, Skv, H, scale);
  return static_cast<int>(cudaGetLastError());
}
