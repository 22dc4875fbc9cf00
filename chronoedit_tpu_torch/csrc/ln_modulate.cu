// K2: LayerNorm (no affine) + per-frame AdaLN modulate, bf16 in and out.
//
// Replaces the Pallas kernel chronoedit_tpu/ops/fused_norms.py
// `_lnmod_kernel` (launched by `_lnmod_fwd_impl`).
//
//   out[b, s, :] = bf16( (x - mean) * rsqrt(var + eps) * (1 + scale[b, t]) + shift[b, t] )
//   with t = s / hw, statistics over the row in fp32: the mean, then the
//   centred variance (two passes, as the plain version).
//
// Bound on the H100: bytes. One read and one write of each bf16 row (20 KB
// a row at D = 5120); the fp32 scale and shift rows (40 KB a frame) are
// shared by the hw = 3,600 rows of a frame. Design (row_ring.cuh, K4's
// shell): one persistent block on each SM over a contiguous range of rows,
// fed by a ring of row stages (1-D bulk copies); the block stages its
// frame's scale and shift in shared memory once, in one of two slots (frame
// k of the range in slot k % 2), so a row reads them from shared memory and
// not from L2 (which the 40 KB a row made 295 MB of reads at 7,200 rows).
// The producer loads frame k when it reaches the frame's first row; it
// reuses a slot once every row of frame k - 2 in the range has been read:
// its empty barrier expects kModArrivals arrivals, the producer gives
// kModArrivals - n_k of them with the load and each of the frame's n_k rows
// one, so a range may cross any number of frame and batch boundaries. Up
// to eight consumer warps (8 and 8 stages at D = 5120, 4 and 4 at D = 8192)
// take one row each: sum, mean, centred sum of squares (16-
// byte loads from shared memory, each lane's partial in a fixed order, then
// a butterfly), then the modulated output, 4 columns a lane (8-byte loads of
// x and 16-byte loads of scale and shift: no bank conflicts), 8-byte stores.
#include "row_ring.cuh"

namespace {

// A frame's rows in one block must be fewer (the entry point checks hw).
constexpr uint32_t kModArrivals = (1u << 20) - 1;

__global__ void __launch_bounds__(rows::kThreads, 1)
ln_modulate_ring_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ shift, __nv_bfloat16* __restrict__ out,
                        int n_rows, int hw, int D, rows::Shape shape, float eps) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[rows::kMaxStages], empty[rows::kMaxStages];
  __shared__ __align__(8) uint64_t mod_full[2], mod_empty[2];
  float* mod_s = reinterpret_cast<float*>(smem);  // [slot][scale, shift][D]
  const rows::Ring ring{full, empty, reinterpret_cast<__nv_bfloat16*>(mod_s + 4 * D),
                        shape.stages, D};
  const rows::Range range = rows::block_rows(n_rows);
  const int n = range.end - range.begin;
  const int f0 = range.begin / hw;  // the range's first frame (b * T + t)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    ring.init();
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&mod_full[s], 1);
      sm90::mbar_init(&mod_empty[s], kModArrivals);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == rows::kConsumerWarps) {
    if (lane == 0) {
      for (int j = 0, k = -1; j < n; ++j) {
        const int row = range.begin + j;
        if (row / hw != f0 + k) {  // the first row of the range's next frame
          const int f = f0 + ++k, slot = k & 1;
          if (k >= 2) sm90::mbar_wait(&mod_empty[slot], ((k >> 1) - 1) & 1);
          const long long lo = static_cast<long long>(f) * hw, hi = lo + hw;
          const int n_k = static_cast<int>((hi < range.end ? hi : range.end) -
                                           (lo > range.begin ? lo : range.begin));
          sm90::mbar_arrive_count(&mod_empty[slot], kModArrivals - n_k);
          float* dst = mod_s + slot * 2 * D;
          sm90::mbar_arrive_expect_tx(&mod_full[slot], 2 * D * 4);
          sm90::bulk_load_1d(dst, scale + static_cast<size_t>(f) * D, D * 4, &mod_full[slot]);
          sm90::bulk_load_1d(dst + D, shift + static_cast<size_t>(f) * D, D * 4,
                             &mod_full[slot]);
        }
        ring.load(j, x + static_cast<size_t>(row) * D);
      }
    }
    return;
  }
  if (warp >= shape.warps) return;

  const int nvec = D >> 3;
  const float d = static_cast<float>(D);
  for (int j = warp; j < n; j += shape.warps) {
    const int row = range.begin + j;
    const int k = row / hw - f0, slot = k & 1;
    const __nv_bfloat16* xs = ring.wait(j);
    float sum = 0.f;
#pragma unroll 4
    for (int v = lane; v < nvec; v += 32) {
      float f[8];
      ce::load8(xs + v * 8, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += f[e];
    }
    const float mean = ce::warp_sum(sum) / d;
    float sq = 0.f;
#pragma unroll 4
    for (int v = lane; v < nvec; v += 32) {
      float f[8];
      ce::load8(xs + v * 8, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float c = f[e] - mean;
        sq = fmaf(c, c, sq);
      }
    }
    const float rstd = rsqrtf(ce::warp_sum(sq) / d + eps);

    sm90::mbar_wait(&mod_full[slot], (k >> 1) & 1);
    const float* sc_s = mod_s + slot * 2 * D;
    const float* sh_s = sc_s + D;
    __nv_bfloat16* orow = out + static_cast<size_t>(row) * D;
#pragma unroll 4
    for (int q = lane; q < (D >> 2); q += 32) {
      float f[4];
      ce::load4(xs + q * 4, f);
      const float4 sc = *reinterpret_cast<const float4*>(sc_s + q * 4);
      const float4 sh = *reinterpret_cast<const float4*>(sh_s + q * 4);
      f[0] = (f[0] - mean) * rstd * (1.f + sc.x) + sh.x;
      f[1] = (f[1] - mean) * rstd * (1.f + sc.y) + sh.y;
      f[2] = (f[2] - mean) * rstd * (1.f + sc.z) + sh.z;
      f[3] = (f[3] - mean) * rstd * (1.f + sc.w) + sh.w;
      ce::store4(orow + q * 4, f);
    }
    ring.release(j);
    if (lane == 0) sm90::mbar_arrive(&mod_empty[slot]);
  }
}

}  // namespace

// The frame of a row is row / hw over the flattened (B, T) frames: T is not needed.
extern "C" int ln_modulate_bf16(const void* x, const void* scale, const void* shift, void* out,
                                int rows, int /*T*/, int hw, int D, float eps, void* stream) {
  const int mod_bytes = 4 * D * 4;  // two slots of scale and shift
  const rows::Shape shape = rows::ring_shape(D * 2, mod_bytes);
  if (hw <= 0 || static_cast<uint32_t>(hw) >= kModArrivals)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_modulate_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, rows::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  int grid = 0;
  const int err = rows::grid_for(rows, &grid);
  if (err != 0) return err;
  const int smem = mod_bytes + shape.stages * D * 2;
  ln_modulate_ring_kernel<<<grid, rows::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(out), rows, hw, D, shape,
      eps);
  return static_cast<int>(cudaGetLastError());
}
