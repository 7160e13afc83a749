// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tile loads
// (2-D, and 4-D for (B, H, S, D) views) and 1-D bulk copies, the
// shared-memory matrix descriptors of wgmma, and wgmma with f32
// accumulators: m64n256k16 with both operands in shared memory, m64n64k16
// and m64n128k16 with A in shared memory or in registers, m64n{16,32}k16
// (bf16) with A in registers.  Host side: the
// driver's tensor-map encoder and a once-per-kernel shared-memory opt-in.
// Used by K3/K4's wgmma path (gemm.cu), K5's wgmma path (int4_gemm.cu),
// K6/K7's wgmma paths (flash_fwd.cu, flash_bwd.cu) and, for the mbarriers,
// by K9/K10 (coalesce.cu).
//
// The layout every piece here agrees on.  A TMA box whose inner dimension
// is 64 16-bit values (128 bytes), loaded with CU_TENSOR_MAP_SWIZZLE_128B,
// lands in shared memory as rows of 128 bytes: row r at byte 128 r, and its
// 16-byte chunk c at chunk c ^ (r % 8).  The pattern repeats every 8 rows
// (1024 bytes), so each box starts on a 1024-byte boundary; boxes of 64
// rows stacked one after the other make one taller box of the same layout.
// wgmma reads such a box through a descriptor of layout type SWIZZLE_128B,
// whose two strides (in bytes) say how the 8-row, 128-byte swizzle atoms
// tile the operand:
//  - K-major (A here, (M, K) row-major: a row of the box is 64 values of
//    K for one m): the stride byte offset (SBO) 1024 steps from one group
//    of 8 rows of M to the next; the leading byte offset is unused for
//    this layout.  The k16 slice j of a 64-wide box starts 32 j bytes into
//    the row: the hardware swizzles the address it forms, so only the
//    start address moves.
//  - K-major B (the transpose-B immediate 0): the same layout with N in
//    place of M.  Attention's S = Q K^T reads K, stored (S_k, D), so: a row
//    of the box is 64 values of D (the K dimension) for one key.
//  - MN-major (B here, (K, N) row-major, used as stored: a row of the box
//    is 64 values of N for one k): SBO 1024 steps from one group of 8 rows
//    of K to the next, and the leading byte offset (LBO) steps from one
//    64-wide chunk of N to the next, i.e. to the next TMA box.  The k16
//    slice j starts 16 j rows = 2048 j bytes into each box.  The wgmma's
//    transpose-B immediate (1, allowed for 16-bit types) says B is
//    MN-major.  Attention's P V reads V, stored (S_k, D), so: K = keys, N
//    = D.
//  - A in registers (the register-A form, for P V, dS K, P^T dO and
//    dS^T Q): each warp w of the warpgroup holds rows 16 w .. 16 w + 15 of
//    the 64 x 16 slice in four 32-bit registers of two 16-bit values, laid
//    out as mma.sync m16n8k16's A: a0 (row g, columns 2t, 2t+1), a1 (row
//    g + 8, same columns), a2 (row g, columns 2t + 8, 2t + 9), a3 (row g +
//    8, those), with g = lane / 4 and t = lane % 4.  That is the layout of
//    a wgmma accumulator's n8 tiles 2j and 2j + 1 for a row pair, so an
//    accumulator (S, dP) rounded to 16 bits is the A operand of the k16
//    step j of the next product with no data movement.
// Accumulators: for m64nNk16, thread t of the warpgroup holds, in
// d[4 j + e], row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and column 8 j +
// 2 (t % 4) + e % 2, j < N / 8.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

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

// Whether the barrier's phase of parity `parity` has completed; the
// thread may be suspended for a while (a hardware time limit) before a
// false answer.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// phase that never completes (a wrong byte count or arrival count) traps
// after 10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint64_t t0 = 0;
  while (true) {
    if (mbar_try_wait(bar, parity)) return;
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

// The 4-D box at coordinates (c0 inner, c1, c2, c3 outer): a (B, H, S, D)
// view is mapped as (D, S, H, B), so c0 is the column, c1 the row, c2 the
// head and c3 the batch.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory to shared memory; the bytes count off `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
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

// Make this thread's generic-proxy writes to shared memory (st.shared)
// visible to the async proxy (wgmma operands, TMA stores) that reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// bar.sync on named barrier `id` (1-15) for the 128 threads of one
// warpgroup
__device__ __forceinline__ void warpgroup_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// Named barrier `id` shared by two warpgroups: one waits on it (sync) for
// the other's arrival (arrive), which does not wait.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
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

// m64n64k16 and m64n128k16: D (64 x N, f32, N / 2 registers a thread)
// = (scale_d ? D : 0) + A (64 x 16) @ B (16 x N) for one warpgroup.  SS: A
// K-major through a descriptor; RS: A in registers (the layout above).  B
// through a descriptor, K-major (TRANS_B 0) or MN-major (TRANS_B 1).
#define HOPPER_WGMMA_SS_N64(TYPE)                                           \
  asm volatile(                                                             \
      "{\n"                                                                 \
      ".reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %34, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE           \
      " {"                                                                  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "             \
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "             \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, %32, %33, p, 1, 1, 0, %35;\n"                                     \
      "}\n"                                                                 \
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16),                    \
        HOPPER_ACC8(24)                                                     \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B))

#define HOPPER_WGMMA_SS_N128(TYPE)                                          \
  asm volatile(                                                             \
      "{\n"                                                                 \
      ".reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %66, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE          \
      " {"                                                                  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "             \
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "             \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "             \
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "             \
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "             \
      "%57, %58, %59, %60, %61, %62, %63"                                   \
      "}, %64, %65, p, 1, 1, 0, %67;\n"                                     \
      "}\n"                                                                 \
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16),                    \
        HOPPER_ACC8(24), HOPPER_ACC8(32), HOPPER_ACC8(40),                  \
        HOPPER_ACC8(48), HOPPER_ACC8(56)                                    \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B))

#define HOPPER_WGMMA_RS_N64(TYPE)                                           \
  asm volatile(                                                             \
      "{\n"                                                                 \
      ".reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %37, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE           \
      " {"                                                                  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "             \
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "             \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"                       \
      "}\n"                                                                 \
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16),                    \
        HOPPER_ACC8(24)                                                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),            \
        "r"(scale_d), "n"(TRANS_B))

#define HOPPER_WGMMA_RS_N128(TYPE)                                          \
  asm volatile(                                                             \
      "{\n"                                                                 \
      ".reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %69, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE          \
      " {"                                                                  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "             \
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "             \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "             \
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "             \
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "             \
      "%57, %58, %59, %60, %61, %62, %63"                                   \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"                       \
      "}\n"                                                                 \
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16),                    \
        HOPPER_ACC8(24), HOPPER_ACC8(32), HOPPER_ACC8(40),                  \
        HOPPER_ACC8(48), HOPPER_ACC8(56)                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),            \
        "r"(scale_d), "n"(TRANS_B))


// m64n16k16 and m64n32k16 with A in registers (RS only): small
// N for products whose N side is a handful of rows (x^T in a swapped
// GEMM); D is N / 2 registers a thread.
#define HOPPER_WGMMA_RS_N16(TYPE)                                           \
  asm volatile(                                                             \
      "{\n"                                                                 \
      ".reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %13, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TYPE "." TYPE           \
      " {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "  \
      "1, %14;\n"                                                           \
      "}\n"                                                                 \
      : HOPPER_ACC8(0)                                                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),            \
        "r"(scale_d), "n"(TRANS_B))

#define HOPPER_WGMMA_RS_N32(TYPE)                                           \
  asm volatile(                                                             \
      "{\n"                                                                 \
      ".reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %21, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPE "." TYPE           \
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"                    \
      "}\n"                                                                 \
      : HOPPER_ACC8(0), HOPPER_ACC8(8)                                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),            \
        "r"(scale_d), "n"(TRANS_B))

#define HOPPER_WGMMA_SMALL(T, NAME, N, MACRO)                             \
  template <>                                                             \
  struct WgmmaN<T, N> {                                                   \
    template <int TRANS_B>                                                \
    __device__ __forceinline__ static void rs(float (&d)[N / 2],          \
                                              const uint32_t (&a)[4],     \
                                              uint64_t desc_b,            \
                                              int scale_d) {              \
      MACRO(NAME);                                                        \
    }                                                                     \
  };

#define HOPPER_WGMMA_TYPE(T, NAME)                                        \
  template <>                                                             \
  struct WgmmaN<T, 64> {                                                  \
    template <int TRANS_B>                                                \
    __device__ __forceinline__ static void ss(float (&d)[32],             \
                                              uint64_t desc_a,            \
                                              uint64_t desc_b,            \
                                              int scale_d) {              \
      HOPPER_WGMMA_SS_N64(NAME);                                          \
    }                                                                     \
    template <int TRANS_B>                                                \
    __device__ __forceinline__ static void rs(float (&d)[32],             \
                                              const uint32_t (&a)[4],     \
                                              uint64_t desc_b,            \
                                              int scale_d) {              \
      HOPPER_WGMMA_RS_N64(NAME);                                          \
    }                                                                     \
  };                                                                      \
  template <>                                                             \
  struct WgmmaN<T, 128> {                                                 \
    template <int TRANS_B>                                                \
    __device__ __forceinline__ static void ss(float (&d)[64],             \
                                              uint64_t desc_a,            \
                                              uint64_t desc_b,            \
                                              int scale_d) {              \
      HOPPER_WGMMA_SS_N128(NAME);                                         \
    }                                                                     \
    template <int TRANS_B>                                                \
    __device__ __forceinline__ static void rs(float (&d)[64],             \
                                              const uint32_t (&a)[4],     \
                                              uint64_t desc_b,            \
                                              int scale_d) {              \
      HOPPER_WGMMA_RS_N128(NAME);                                         \
    }                                                                     \
  };

template <typename T, int N>
struct WgmmaN;
HOPPER_WGMMA_TYPE(__nv_bfloat16, "bf16")
HOPPER_WGMMA_TYPE(__half, "f16")
HOPPER_WGMMA_SMALL(__nv_bfloat16, "bf16", 16, HOPPER_WGMMA_RS_N16)
HOPPER_WGMMA_SMALL(__nv_bfloat16, "bf16", 32, HOPPER_WGMMA_RS_N32)

#undef HOPPER_WGMMA_TYPE
#undef HOPPER_WGMMA_SMALL
#undef HOPPER_WGMMA_RS_N16
#undef HOPPER_WGMMA_RS_N32
#undef HOPPER_WGMMA_SS_N64
#undef HOPPER_WGMMA_SS_N128
#undef HOPPER_WGMMA_RS_N64
#undef HOPPER_WGMMA_RS_N128
#undef HOPPER_ACC8

// 2^x with the special-function unit's approximation (relative error about
// 2^-22; results below 2^-126 flush to 0, and 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to one 32-bit register of two 16-bit values (the
// lower address first), as the register-A form and 4-byte stores take them.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x N accumulator rounded to T as the register-A operand of a wgmma
// whose K is those N columns: the k16 step j takes n8 tiles 2j and 2j + 1
// (the layout notes at the top).
template <typename T, int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    a[j / 2][(j % 2) * 2] = pack2<T>(acc[4 * j], acc[4 * j + 1]);
    a[j / 2][(j % 2) * 2 + 1] = pack2<T>(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ------------------------------------------------- attention tiles (K6, K7)
// A tile of ROWS rows x D columns (D = 64 or 128) of one (batch, head) of a
// (B, H, S, D) view lies in shared memory as D / 64 column boxes of ROWS
// rows x 128 bytes, each the layout above (so a tile is at once a K-major
// operand with rows as M or N, and an MN-major one with rows as K and a
// column box as LBO).

// Byte offset of element (r, c) in such a tile.
template <int ROWS>
__device__ __forceinline__ int tile_offset(int r, int c) {
  return (c / 64) * ROWS * 128 + r * 128 + ((((c % 64) / 8) ^ (r % 8)) << 4) +
         (c % 8) * 2;
}

// TMA-load rows [r0, r0 + ROWS) of one (batch, head) of a (B, H, S, D)
// map with 64 x 64 boxes into such a tile (ROWS a multiple of 64); rows
// past S arrive as zeros, and all ROWS * D * 2 bytes count off `bar`.
template <int D, int ROWS>
__device__ __forceinline__ void tma_load_tile(unsigned char* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int r0,
                                              int head, int batch) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int rb = 0; rb < ROWS / 64; ++rb)
      tma_load_4d(dst + c * ROWS * 128 + rb * 64 * 128, map, bar, c * 64,
                  r0 + rb * 64, head, batch);
}

// A warpgroup's 64 x D f32 accumulator, row pair e / 2 times mul[e / 2],
// rounded to T and written to rows [row0, row0 + 64) of a ROWS-row tile in
// shared memory (bank-conflict free: the swizzle spreads a warp's 8 rows
// over all 32 banks), then copied in 16-byte chunks to the first n_rows of
// `dst` (rows D elements apart).  Only this warpgroup may use those tile
// rows; `barrier_id` is a named barrier of its own.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2],
                                           float mul_lo, float mul_hi,
                                           unsigned char* tile, int row0,
                                           T* dst, int n_rows,
                                           int barrier_id) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = row0 + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(tile + tile_offset<ROWS>(r, col)) =
        pack2<T>(acc[4 * j] * mul_lo, acc[4 * j + 1] * mul_lo);
    *reinterpret_cast<uint32_t*>(tile + tile_offset<ROWS>(r + 8, col)) =
        pack2<T>(acc[4 * j + 2] * mul_hi, acc[4 * j + 3] * mul_hi);
  }
  warpgroup_barrier(barrier_id);
  constexpr int CHUNKS = D / 8;
#pragma unroll 4
  for (int id = t; id < 64 * CHUNKS; id += 128) {
    const int rr = id / CHUNKS, cc = (id % CHUNKS) * 8;
    if (rr < n_rows)
      *reinterpret_cast<uint4*>(dst + (long long)rr * D + cc) =
          *reinterpret_cast<const uint4*>(tile +
                                          tile_offset<ROWS>(row0 + rr, cc));
  }
}

// ------------------------------------------------------------------- host

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// error codes beside cudaError_t's: the driver has no
// cuTensorMapEncodeTiled, or it refused a tensor map
constexpr int kNoEncoder = -1, kEncodeFailed = -2;

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A (B, H, S, D) view of 16-bit values with element strides sb, sh, ss
// (the last dimension contiguous; every stride a multiple of 8 elements
// and the base 16-byte aligned) as boxes of 64 rows x 64 columns of one
// (batch, head), 128-byte swizzle, zeros outside: kNoEncoder, kEncodeFailed
// or 0.
inline int encode_bhsd(CUtensorMap* map, CUtensorMapDataType type,
                       const void* base, int B, int H, int S, int D,
                       long long sb, long long sh, long long ss) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : kEncodeFailed;
}

// Allow `kernel` `bytes` of dynamic shared memory (needed above 48 KB) on
// the current card, calling the driver once per kernel and card: the
// attribute stays set for later launches.
inline cudaError_t allow_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> done;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(kernel, dev);
  const auto it = done.find(key);
  if (it != done.end() && it->second >= bytes) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            bytes);
  if (rc == cudaSuccess) done[key] = bytes;
  return rc;
}

}  // namespace hopper
