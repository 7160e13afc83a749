// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tile loads,
// the shared-memory matrix descriptors of wgmma, and the m64n256k16 wgmma
// with f32 accumulators.  Used by K3/K4's wgmma path (gemm.cu) and, for
// the mbarriers, by K9/K10 (coalesce.cu); written to be reused by K6's
// redesign.
//
// The layout every piece here agrees on.  A TMA box whose inner dimension
// is 64 16-bit values (128 bytes), loaded with CU_TENSOR_MAP_SWIZZLE_128B,
// lands in shared memory as rows of 128 bytes: row r at byte 128 r, and its
// 16-byte chunk c at chunk c ^ (r % 8).  The pattern repeats every 8 rows
// (1024 bytes), so each box starts on a 1024-byte boundary.  wgmma reads
// such a box through a descriptor of layout type SWIZZLE_128B, whose two
// strides (in bytes) say how the 8-row, 128-byte swizzle atoms tile the
// operand:
//  - K-major (A here, (M, K) row-major: a row of the box is 64 values of
//    K for one m): the stride byte offset (SBO) 1024 steps from one group
//    of 8 rows of M to the next; the leading byte offset is unused for
//    this layout.  The k16 slice j of a 64-wide box starts 32 j bytes into
//    the row: the hardware swizzles the address it forms, so only the
//    start address moves.
//  - MN-major (B here, (K, N) row-major, used as stored: a row of the box
//    is 64 values of N for one k): SBO 1024 steps from one group of 8 rows
//    of K to the next, and the leading byte offset (LBO) steps from one
//    64-wide chunk of N to the next, i.e. to the next TMA box.  The k16
//    slice j starts 16 j rows = 2048 j bytes into each box.  The wgmma's
//    transpose-B immediate (1, allowed for 16-bit types) says B is
//    MN-major.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// one arrival that also adds `bytes` to the phase's expected transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// phase that never completes (a wrong byte count or arrival count) traps
// after 10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 10000000000ull) {
      __trap();
    }
  }
}

// -------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Copy the box at coordinates (c0 inner, c1 outer) of `map` into shared
// memory at `dst`; its bytes count off `bar`.  Elements outside the tensor
// arrive as zeros and still count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ------------------------------------------------------ wgmma descriptors

// bits 0-13 start address >> 4, 16-29 LBO >> 4, 32-45 SBO >> 4, 62-63
// layout type (1: 128-byte swizzle)
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p,
                                                    uint32_t lbo_bytes,
                                                    uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 |
         1ull << 62;
}

// A K-major operand: rows of 64 K values (one 128-byte swizzled box row),
// 8-row groups 1024 bytes apart; `p` is the first row's address plus
// 32 bytes per k16 slice.
__device__ __forceinline__ uint64_t desc_k_major_sw128(const void* p) {
  return smem_desc_sw128(p, 16, 1024);
}

// An MN-major operand: boxes of 64 MN values x the K rows, box_bytes
// apart; `p` is the first box's address plus 2048 bytes per k16 slice.
__device__ __forceinline__ uint64_t desc_mn_major_sw128(const void* p,
                                                        uint32_t box_bytes) {
  return smem_desc_sw128(p, box_bytes, 1024);
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads of the accumulators above a
// wgmma_wait: each register is "rewritten" here, after the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// bar.sync on a named barrier (1-15) for `threads` threads
template <int ID, int THREADS>
__device__ __forceinline__ void named_barrier() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(ID), "n"(THREADS) : "memory");
}

#define HOPPER_ACC8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 256, f32, 128 registers a thread) += A (64 x 16) @ B (16 x 256)
// for one warpgroup; A K-major and B MN-major, both through descriptors.
// Thread t of the warpgroup holds, in d[4 j + e], row 16 (t / 32) +
// (t % 32) / 4 + 8 (e / 2) and column 8 j + 2 (t % 4) + e % 2.
#define HOPPER_WGMMA_M64N256K16(TYPE)                                     \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %130, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TYPE "." TYPE " {"   \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "      \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "      \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "      \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "      \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "      \
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "      \
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "      \
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "      \
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "        \
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "      \
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "     \
      "%128, %129, p, 1, 1, 0, 1;\n"                                      \
      "}\n"                                                               \
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), \
        HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48),                \
        HOPPER_ACC8(56), HOPPER_ACC8(64), HOPPER_ACC8(72),                \
        HOPPER_ACC8(80), HOPPER_ACC8(88), HOPPER_ACC8(96),                \
        HOPPER_ACC8(104), HOPPER_ACC8(112), HOPPER_ACC8(120)              \
      : "l"(desc_a), "l"(desc_b), "r"(1))

template <typename T>
struct Wgmma;

template <>
struct Wgmma<__nv_bfloat16> {
  __device__ __forceinline__ static void m64n256k16(float (&d)[128],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b) {
    HOPPER_WGMMA_M64N256K16("bf16");
  }
};

template <>
struct Wgmma<__half> {
  __device__ __forceinline__ static void m64n256k16(float (&d)[128],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b) {
    HOPPER_WGMMA_M64N256K16("f16");
  }
};

#undef HOPPER_WGMMA_M64N256K16
#undef HOPPER_ACC8

}  // namespace hopper
