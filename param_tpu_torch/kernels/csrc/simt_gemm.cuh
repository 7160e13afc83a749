// Full-f32 FMA GEMM core shared by K3's f32 path (gemm.cu) and K5's
// odd-group path (int4_gemm.cu).
//
// C (M, N) = A (M, K) @ B (K, N) with f32 products and f32 accumulation on
// the CUDA cores (no tensor cores, no TF32).  A block of 256 threads owns a
// 128 x 128 output tile: 8 warps as 4 x 2, a warp 32 x 64 of the tile, a
// thread 8 x 8 (rows wm + lane/8 + 4 i, columns wn + 4 (lane%8) + {0..3}
// and the same + 32).  The block walks its K range in steps of 16 through a
// ring of 3 shared-memory stages, with one barrier a step: the Loader
// issues the step two ahead (cp.async, or global loads into registers that
// are stored after this step's FMAs) while this step is computed.  One
// block an SM: with registers to spare (160-190 a thread) nothing spills,
// which on the H100 beat two blocks an SM held to 128 registers (37.8
// against 34.2 TF/s at (1024, 4096, 4096)).
//
// A stage holds A as [m][k], rows of 16 floats, with the 16-byte chunk q of
// row m at chunk q ^ ((m >> 1) & 3), so the 4 rows one load of a warp
// touches fall in distinct banks; and B as [k][n].  Per 2 k a thread reads
// 8 float2s of A (2 k of each of its rows) and 4 float4s of B: 12 loads for
// 128 FMAs.
//
// Split K: block z of grid.z takes the K range [z k_split, (z+1) k_split)
// (k_split a multiple of BK) and writes its f32 partial to c + z M N; the
// caller adds the splits in a fixed order.  Edges are masked: the loaders
// zero-fill outside (M, K) and (K, N), the epilogue skips stores outside
// (M, N).
//
// A Loader supplies the stages:
//   struct Regs;                                  // one step's registers
//   // issue the global reads of the step at k0: into r, or as cp.async
//   // straight into the stage (as, bs)
//   void load(Regs& r, int bm, int bn, int k0, int tid, float* as,
//             float* bs) const;
//   // r -> the stage (nothing to do for a cp.async loader)
//   void store(const Regs& r, float* as, float* bs, int tid) const;
// The stage receives A[bm+m, k0+k] at as[a_index(m, k)] and B[k0+k, bn+n]
// at bs[k * BN + n], zeros outside the matrices.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"

namespace simt {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256, STAGES = 3;
constexpr int A_STAGE = BM * BK, B_STAGE = BK * BN;  // floats

// A's stage: element (m, k) of the tile, 16-byte chunks swizzled by row
__device__ __forceinline__ int a_index(int m, int k) {
  return m * BK + ((((k >> 2) ^ (m >> 1)) & 3) << 2) + (k & 3);
}

template <typename T>
__device__ __forceinline__ void store_out(T* p, float v);
template <>
__device__ __forceinline__ void store_out<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store_out<__nv_bfloat16>(__nv_bfloat16* p,
                                                         float v) {
  *p = __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ void store_out<__half>(__half* p, float v) {
  *p = __float2half_rn(v);
}

// Four consecutive outputs of one row, `n` of them inside the matrix; one
// 16-byte store when all four are in and `vec` (f32 output, 16-byte
// aligned row) allows it.
template <typename OutT>
__device__ __forceinline__ void store_out4(OutT* p, const float (&v)[4],
                                           int n, bool vec) {
  if (sizeof(OutT) == 4 && vec && n >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) store_out(p + e, v[e]);
}

// rows_fastest = 1 walks all row tiles of one column tile before the next
// column tile (consecutive blocks share B's column slice in L2).
template <class Loader, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(Loader ld, OutT* __restrict__ c, int M, int N, int K,
            int k_split, int rows_fastest) {
  __shared__ __align__(16) float smem[STAGES][A_STAGE + B_STAGE];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile_m = rows_fastest ? blockIdx.x : blockIdx.y;
  const int tile_n = rows_fastest ? blockIdx.y : blockIdx.x;
  const int bm = tile_m * BM, bn = tile_n * BN;
  const int wm = (warp / 2) * 32 + lane / 8;        // first of the 8 rows
  const int wn = (warp % 2) * 64 + (lane % 8) * 4;  // first of 2 x 4 columns
  const int k_begin = blockIdx.z * k_split;
  const int nk = max(0, (min(K, k_begin + k_split) - k_begin + BK - 1) / BK);
  c += (size_t)blockIdx.z * M * N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  typename Loader::Regs r;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      ld.load(r, bm, bn, k_begin + s * BK, tid, smem[s], smem[s] + A_STAGE);
      ld.store(r, smem[s], smem[s] + A_STAGE, tid);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait1();  // step kt has landed (for this thread) ...
    __syncthreads();   // ... for all; and step kt-1's stage is free
    const int pre = kt + STAGES - 1, ps = pre % STAGES;
    if (pre < nk)
      ld.load(r, bm, bn, k_begin + pre * BK, tid, smem[ps],
              smem[ps] + A_STAGE);
    cp_async_commit();

    const float* as = smem[kt % STAGES];
    const float* bs = as + A_STAGE;
#pragma unroll
    for (int p = 0; p < BK / 2; ++p) {
      float2 a2[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a2[i] = *reinterpret_cast<const float2*>(&as[a_index(wm + 4 * i,
                                                             2 * p)]);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&bs[(2 * p + kk) * BN + wn]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bs[(2 * p + kk) * BN + wn + 32]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = kk == 0 ? a2[i].x : a2[i].y;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
    if (pre < nk) ld.store(r, smem[ps], smem[ps] + A_STAGE, tid);
  }

  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = bm + wm + 4 * i;
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = bn + wn + 32 * h;
      if (col >= N) continue;
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]};
      store_out4(&c[(size_t)row * N + col], v, N - col, vec);
    }
  }
}

// A's tile for a register loader: thread t loads row t/2, columns
// k0 + (t%2)*8 + {0..7}, as f32.
template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void load_a(float (&dst)[8], const T* __restrict__ a,
                                       int M, int K, int bm, int k0, int tid) {
  const int row = bm + tid / 2, kc = k0 + (tid % 2) * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = (row < M && kc + e < K) ? to_f32(a[(size_t)row * K + kc + e])
                                     : 0.f;
}

__device__ __forceinline__ void store_a(const float (&src)[8], float* as,
                                        int tid) {
  const int row = tid / 2, kc = (tid % 2) * 8;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<float4*>(&as[a_index(row, kc + 4 * h)]) = make_float4(
        src[4 * h], src[4 * h + 1], src[4 * h + 2], src[4 * h + 3]);
}

// out = sum over z of ws[z] (in order z = 0, 1, ...), cast once; one
// element a thread, so the many splits of a small output (K5 at M = 1)
// are read by as many threads as there are elements
template <typename OutT>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     OutT* __restrict__ out, long long mn,
                                     int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += ws[(size_t)z * mn + i];
  store_out(&out[i], v);
}

template <typename OutT>
int launch_reduce(const void* ws, void* out, int M, int N, int splits,
                  cudaStream_t s) {
  const long long mn = (long long)M * N;
  const unsigned blocks = (unsigned)((mn + 255) / 256);
  splitk_reduce_kernel<OutT><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<OutT*>(out), mn, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt
