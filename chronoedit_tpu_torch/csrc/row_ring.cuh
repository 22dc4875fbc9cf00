// The shell that K4 (rms_norm.cu) and K2 (ln_modulate.cu) share: a
// persistent grid over contiguous row ranges, each block fed by a ring of
// whole-row stages in shared memory that one producer thread fills with
// 1-D bulk copies (no tensor map: a row is contiguous, 16-byte aligned and
// a multiple of 16 bytes, which the wrappers check).
//
// Block b of G takes the rows [rows * b / G, rows * (b + 1) / G). W <= 8
// consumer warps (warps 0 to W - 1) take one row each: local row j goes to
// warp j % W, so no block-wide barrier runs after set-up. Lane 0 of warp 8
// produces. Row j goes to stage j % S, and S is a multiple of W, so warp
// j % W always reads the same stages: it waits on a stage only after it
// has read the stage's previous row, row j - S. A parity wait is then never
// two phases ahead, which it cannot tell from the phase just gone. Each
// stage has a full barrier (one arrival that expects the row's bytes) and
// an empty barrier (one arrival: the owning warp's lane 0, once the whole
// warp has read the stage for the last time).
#pragma once

#include "sm90.cuh"

namespace rows {

constexpr int kConsumerWarps = 8;  // at most; warp 8 produces
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kMaxStages = 16;  // a multiple of kConsumerWarps
// Dynamic shared memory a block takes at most: one block on each SM.
constexpr int kSmemBytes = 200 * 1024;

struct Range {
  int begin, end;
};

__device__ __forceinline__ Range block_rows(int rows) {
  const long long b = blockIdx.x, g = gridDim.x;
  return {static_cast<int>(rows * b / g), static_cast<int>(rows * (b + 1) / g)};
}

struct Ring {
  uint64_t* full;
  uint64_t* empty;
  __nv_bfloat16* data;  // stages x D bf16
  int stages, D;

  __device__ __forceinline__ __nv_bfloat16* stage(int j) const {
    return data + static_cast<size_t>(j % stages) * D;
  }

  // One thread, before the block-wide barrier that ends set-up.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
  }

  // Producer: local row j (at `src`) into its stage, once the stage's
  // previous row, j - stages, has been released. Row j is the stage's
  // (j / stages)-th.
  __device__ __forceinline__ void load(int j, const __nv_bfloat16* src) const {
    const int s = j % stages;
    if (j >= stages) sm90::mbar_wait(&empty[s], ((j / stages) - 1) & 1);
    sm90::mbar_arrive_expect_tx(&full[s], D * 2);
    sm90::bulk_load_1d(data + static_cast<size_t>(s) * D, src, D * 2, &full[s]);
  }

  // Consumer warp: waits until local row j has landed; returns its stage.
  __device__ __forceinline__ const __nv_bfloat16* wait(int j) const {
    sm90::mbar_wait(&full[j % stages], (j / stages) & 1);
    return stage(j);
  }

  // Consumer warp, after its last read of row j's stage.
  __device__ __forceinline__ void release(int j) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(&empty[j % stages]);
  }
};

// ---- host

// The ring beside `fixed_bytes` of other shared data: the stages that fit
// (at most kMaxStages), W = min(kConsumerWarps, stages) consumer warps, and
// the stages cut to a multiple of W.
struct Shape {
  int warps, stages;
};

inline Shape ring_shape(int row_bytes, int fixed_bytes) {
  int s = (kSmemBytes - fixed_bytes) / row_bytes;
  s = s < kMaxStages ? s : kMaxStages;
  const int w = s < kConsumerWarps ? s : kConsumerWarps;
  return {w, s / w * w};
}

// G = min(rows, SMs): one persistent block on each SM. Returns a CUDA error.
inline int grid_for(int rows, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = rows < sms ? rows : sms;
  return static_cast<int>(err);
}

}  // namespace rows
