// Hopper (sm_90a) building blocks written out in inline PTX: mbarriers,
// TMA tile loads and 1-D bulk copies, warpgroup matrix multiply (wgmma) and
// the tile products built from it, register rebalancing, and on the host
// the tensor maps that feed the TMA loads (4-D over BSHD, 2-D over a
// row-major matrix). Used by the flash-attention forward (flash_fwd.cu,
// flash_fwd_qk8.cu) and backward (flash_bwd.cu), the int4 matmul
// (int4_matmul.cu) and, through the row ring of row_ring.cuh (mbarriers and
// 1-D bulk copies only), the norms (rms_norm.cu, ln_modulate.cu). No
// CUTLASS or CuTe: the build stays one short nvcc call per source.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no driver link)
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (64-bit, in shared memory)

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// async proxy (TMA); a block-wide barrier follows it.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// The arrive and wait below also take the barrier's 32-bit shared-memory
// address, which a kernel short of registers keeps instead of pointers.
__device__ __forceinline__ void mbar_arrive(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(addr) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) { mbar_arrive(smem_u32(bar)); }

// `count` arrivals at once (1 <= count < 2^20), as if that many threads arrived.
__device__ __forceinline__ void mbar_arrive_count(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Spins until the barrier's current phase differs from `parity`: the phase
// with that parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_u32(bar), parity);
}

// A ring's stage index and the parity of its barriers' current phase,
// moved to the next stage (the parity flips as the ring wraps).
__device__ __forceinline__ void next_stage(int& stage, uint32_t& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// ---- TMA

// One box of a 4-D tensor map into shared memory; completion (the box's
// bytes, out-of-bounds elements zero-filled and counted) goes to `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map (c0 the contiguous coordinate), as above.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Contiguous bytes from global into shared memory without a tensor map:
// `bytes` a multiple of 16, both addresses 16-byte aligned; completion (the
// bytes) goes to `bar`, whose phase must expect them (mbar_arrive_expect_tx).
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- named barriers over the 256 threads of the two consumer warpgroups
// (barrier 0 is __syncthreads): sync waits for all 256, arrive only counts

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// ---- register rebalancing between warpgroups (all four warps execute it)

template <uint32_t kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <uint32_t kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- wgmma

// Shared-memory matrix descriptor for a 128-byte-swizzled tile (the layout
// TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start address, leading and
// stride byte offsets, each in 16-byte units; layout type 1 (B128) in bits
// 62-63. The tile's 1,024-byte swizzle atoms must be 1,024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) fence_regs(r[i]);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define SM90_D64(d)                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),           \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),           \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
      "+f"(d[62]), "+f"(d[63])

#define SM90_D64_LIST                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define SM90_D128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
  "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
  "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
  "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), \
  "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), \
  "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
  "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), \
  "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
  "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), \
  "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

#define SM90_D128_LIST \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, " \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, " \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, " \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// D (64 x 128 fp32, the accumulator fragment) = A B (+ D if scale_d): A a
// 64 x 16 bf16 tile and B a 16 x 128 bf16 tile, both in shared memory and
// both K-major (K contiguous).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64_LIST
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_D64(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D += A B with A 64 x 16 bf16 in registers (the m16n8k16 A fragment of
// each warp's 16 rows) and B 16 x 128 bf16 in shared memory, MN-major
// (N contiguous: the transpose bit).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64_LIST
      ", {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : SM90_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

#define SM90_I64(d)                                                                           \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),        \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), \
      "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),           \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),           \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),           \
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),           \
      "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),           \
      "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),           \
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),           \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),           \
      "+r"(d[62]), "+r"(d[63])

// D (64 x 128 s32) = A B (+ D if scale_d): A a 64 x 32 s8 tile and B a 32 x
// 128 s8 tile, both in shared memory and both K-major (the only layout
// 8-bit operands take; the integer forms have no scale or transpose
// immediates). The fragment is the bf16 form's: d[4j + e] holds row g + 8
// (e >> 1) of the warp's 16, column 8j + 2 t4 + (e & 1).
__device__ __forceinline__ void wgmma_m64n128k32_s8(int32_t (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " SM90_D64_LIST
      ", %64, %65, p;\n}\n"
      : SM90_I64(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#undef SM90_I64

#define SM90_D32(d)                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define SM90_D32_OUT(d)                                                                       \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),        \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), \
      "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),           \
      "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),           \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])

#define SM90_D32_LIST                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D (64 x 64 fp32) = A B (+ D if scale_d): A a 64 x 16 bf16 tile and B a
// 16 x 64 bf16 tile, both in shared memory and both K-major. The fragment
// is the m64n128k16 one cut to 8 column groups: d[4j + e] holds row g + 8
// (e >> 1) of the warp's 16, column 8j + 2 t4 + (e & 1) (g = lane / 4, t4 =
// lane % 4), so it converts to the A fragments of a following register-A
// wgmma as the 128-column one does (k-step kc takes d[8kc .. 8kc + 7]).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D = A B as above, D written only: the first k-step of a product whose
// accumulator holds nothing live, so that its registers are free until then.
__device__ __forceinline__ void wgmma_m64n64k16_ss_fresh(float (&d)[32], uint64_t desc_a,
                                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_D32_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// D (64 x 256 fp32) = A B (+ D if scale_d): A 64 x 16 bf16 in registers (the
// m16n8k16 A fragment of each warp's 16 rows), B 16 x 256 bf16 in shared
// memory, K-major (imm-trans-b 0). The fragment extends the 128-wide one:
// d[4j + e] holds row g + 8 (e >> 1), column 8j + 2 t4 + (e & 1), j < 32.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      SM90_D128_LIST
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : SM90_D128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

#undef SM90_D64
#undef SM90_D64_LIST
#undef SM90_D128
#undef SM90_D128_LIST
#undef SM90_D32
#undef SM90_D32_OUT
#undef SM90_D32_LIST

// ---- products over tiles of 128 bf16 columns as TMA lands them: two
// 64-column boxes of `rows` rows (128 B a row, 128-byte swizzle), the second
// box_bytes(rows) after the first

__host__ __device__ constexpr int box_bytes(int rows) { return rows * 128; }

// D = A B^T over the 128 columns (8 k-steps of 16), issued, not committed:
// 64 rows of A (in a tile of kARows rows) against the 128 or 64 rows of B
// (a tile of kBRows rows; D's width), both K-major; k-step kk reads 32 B
// into box kk / 4 of each. A and B may start at any multiple of 8 rows into
// their tiles (whole 1,024-byte swizzle atoms). With kFresh (64-column D only)
// the first k-step writes D without reading it.
template <int kARows, int kBRows, bool kFresh = false, int N>
__device__ __forceinline__ void issue_abt(float (&d)[N], uint32_t a, uint32_t b) {
  static_assert(N == 64 || N == 32, "64 x 128 or 64 x 64 fp32 fragment");
  static_assert(!kFresh || N == 32, "the write-only first step is the 64-column form's");
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t da = smem_desc(a + (kk >> 2) * box_bytes(kARows) + (kk & 3) * 32, 16, 1024);
    const uint64_t db = smem_desc(b + (kk >> 2) * box_bytes(kBRows) + (kk & 3) * 32, 16, 1024);
    if constexpr (N == 64)
      wgmma_m64n128k16_ss(d, da, db, kk > 0);
    else if (kFresh && kk == 0)
      wgmma_m64n64k16_ss_fresh(d, da, db);
    else
      wgmma_m64n64k16_ss(d, da, db, kk > 0);
  }
}

// D (64 x 128) += A B, issued, not committed: A in registers (the A
// fragments of kRows / 16 k-steps), B kRows rows (from any 16-row offset)
// of a tile of kBoxRows rows x 128, read MN-major; k-step kc reads rows 16
// kc.. (2 KB on), and the tile's two boxes, box_bytes(kBoxRows) apart, are
// the leading step.
template <int kRows, int kBoxRows = kRows>
__device__ __forceinline__ void issue_ab(float (&d)[64], const uint32_t (&a)[kRows / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kc = 0; kc < kRows / 16; ++kc)
    wgmma_m64n128k16_rs_tb(d, a[kc], smem_desc(b + kc * 2048, box_bytes(kBoxRows), 1024));
}

// An accumulator fragment in bf16 as the A fragments of the k-steps of a
// following register-A product (k-step kc: d[8 kc .. 8 kc + 7])
template <int kSteps>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[kSteps][4],
                                           const float (&d)[kSteps * 8]) {
#pragma unroll
  for (int kc = 0; kc < kSteps; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kc][r] = ce::pack_bf16(d[8 * kc + 2 * r], d[8 * kc + 2 * r + 1]);
}

// ---- host: tensor maps

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query
// so that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline int encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A (B, S, H, 128) tensor of 2-byte (bf16, the default) or 1-byte (int8)
// elements as a 4-D map (128, H, S, B), box (128 / elem_bytes, 1, box_rows,
// 1): one box is box_rows rows of 128 bytes (64 bf16 or 128 int8 columns),
// 128-byte swizzle, rows past S zero-filled (never read from the next
// batch). Returns the encode's error code (a CUresult), 0 on success.
inline int bshd_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int box_rows,
                    int elem_bytes = 2) {
  EncodeTiled encode;
  const int err = encode_tiled(&encode);
  if (err != 0) return err;
  const cuuint64_t row = 128 * elem_bytes;  // bytes of one head's row
  const cuuint64_t dims[4] = {128, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / elem_bytes), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return static_cast<int>(r);
}

// A row-major (rows, cols) matrix as a 2-D map, box (box_cols, box_rows):
// elements past either edge zero-filled. The row pitch (cols times the
// element size) must be a multiple of 16 bytes. Returns as bshd_map.
inline int matrix_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                      int elem_bytes, int rows, int cols, int box_rows, int box_cols,
                      CUtensorMapSwizzle swizzle) {
  EncodeTiled encode;
  const int err = encode_tiled(&encode);
  if (err != 0) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return static_cast<int>(r);
}

}  // namespace sm90
