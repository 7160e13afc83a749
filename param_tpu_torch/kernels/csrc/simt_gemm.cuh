// Full-f32 FMA GEMM core shared by K3's f32 path (gemm.cu) and K5's
// large-M path (int4_gemm.cu).
//
// C (M, N) = A (M, K) @ B (K, N) with f32 products and f32 accumulation on
// the CUDA cores (no tensor cores, no TF32).  A block of 256 threads owns a
// 128 x 128 output tile and walks K in steps of 8: each step's A and B tiles
// are staged in shared memory as f32 (A transposed, so both are read along
// the tile's width), double-buffered with a register prefetch of the next
// step, and each thread accumulates an 8 x 8 micro-tile (rows ty*4+{0..3}
// and 64+ty*4+{0..3}, columns likewise from tx) from float4 shared loads.
// Edges are masked: the loaders zero-fill outside (M, K) and (K, N), the
// epilogue skips stores outside (M, N).
//
// A Loader supplies the tiles:
//   struct Regs;                                    // one step's registers
//   void load(Regs&, int bm, int bn, int k0, int tid) const;   // global
//   void store(const Regs&, float (*as)[BM], float (*bs)[BN], int tid) const;
// as[k][m] and bs[k][n] receive the f32 values of A[bm+m, k0+k] and
// B[k0+k, bn+n].
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stddef.h>
#include <stdint.h>

namespace simt {

constexpr int BM = 128, BN = 128, BK = 8, THREADS = 256;

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

// rows_fastest = 1 walks all row tiles of one column tile before the next
// column tile (consecutive blocks share B's column slice in L2).
template <class Loader, typename OutT>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(Loader ld, OutT* __restrict__ c, int M, int N, int K,
            int rows_fastest) {
  __shared__ __align__(16) float as[2][BK][BM];
  __shared__ __align__(16) float bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tile_m = rows_fastest ? blockIdx.x : blockIdx.y;
  const int tile_n = rows_fastest ? blockIdx.y : blockIdx.x;
  const int bm = tile_m * BM, bn = tile_n * BN;
  const int ty = tid / 16, tx = tid % 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  typename Loader::Regs r;
  const int nk = (K + BK - 1) / BK;
  if (nk > 0) {
    ld.load(r, bm, bn, 0, tid);
    ld.store(r, as[0], bs[0], tid);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) ld.load(r, bm, bn, (kt + 1) * BK, tid);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[cur][kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < nk) ld.store(r, as[cur ^ 1], bs[cur ^ 1], tid);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = bm + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = bn + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < N) store_out(&c[(size_t)row * N + col], acc[i][j]);
    }
  }
}

// A's tile: thread t loads row t/2, columns k0 + (t%2)*4 + {0..3}.
template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void load_a(float (&dst)[4], const T* __restrict__ a,
                                       int M, int K, int bm, int k0, int tid) {
  const int row = bm + tid / 2, kc = k0 + (tid % 2) * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    dst[e] = (row < M && kc + e < K) ? to_f32(a[(size_t)row * K + kc + e])
                                     : 0.f;
}

__device__ __forceinline__ void store_a(const float (&src)[4],
                                        float (*as)[BM], int tid) {
  const int row = tid / 2, kc = (tid % 2) * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) as[kc + e][row] = src[e];
}

}  // namespace simt
