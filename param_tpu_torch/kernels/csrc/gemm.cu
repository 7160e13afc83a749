// K3: tiled GEMM, C (M, N) = A (M, K) @ B (K, N), f32 accumulation, C in
// the output dtype (f32, bf16 or f16).  K4: the same product over a stack
// of S small-M GEMMs that share one B, A given as (S*M, K).
//
// Replaces the TPU kernels param_tpu/ops/matmul.py::_mm_kernel (via
// matmul_pallas: a (bm, bn, bk) grid with an f32 VMEM accumulator written
// on the last K step) and ::_mm_wres_kernel (via matmul_weight_resident:
// B's column tile held in VMEM across the S steps).
//
// What bounds it on an H100: operations at the large shapes (2MNK over
// 989 TF/s in bf16/f16, over 67 TF/s in f32 on the CUDA cores, since the
// port keeps TF32 off), bytes at small K ((MK + KN + MN) * size over
// 3.35 TB/s, e.g. (4096, 4096, 128)).
//
// Design, bf16/f16: a 128 x 128 block tile walked in K steps of 32,
// double-buffered in shared memory with cp.async (16-byte copies,
// zero-filled past the edges), 8 warps each owning a 64 x 32 sub-tile
// computed with mma.sync m16n8k16 (f32 accumulators) from ldmatrix
// fragments; rows of the shared tiles are padded by 8 elements so that
// ldmatrix reads are free of bank conflicts; C is written through shared
// memory in 16-byte chunks.  When a row of A or B is not a whole number of
// 16-byte chunks (K or N not a multiple of 8, or an unaligned base) the
// tiles are loaded element by element instead.
// f32: the FMA core of simt_gemm.cuh.  Edges are masked in both, so any
// (M, N, K) works; the TPU kernel's block-divisibility rule stays in the
// Python wrapper only.
//
// K4 is this kernel with the block order changed: rows_fastest walks every
// (S*M)-row tile of one column tile before the next column tile, so the
// blocks that read one column slice of B run together and B comes from
// device memory once, then from the 50 MB L2 (a (4096, 4096) bf16 B is
// 33.5 MB), which is Hopper's counterpart of the TPU's VMEM-resident tile.
//
// Not used: wgmma, TMA, warp specialisation (later work).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "simt_gemm.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32, PAD = 8;
constexpr int A_STRIDE = BK + PAD;  // elements per shared row of A
constexpr int B_STRIDE = BN + PAD;  // elements per shared row of B
constexpr int THREADS = 256;

// Stage the K step at k0 into one buffer of the shared tiles.
template <typename T, bool ALIGNED>
__device__ __forceinline__ void load_tiles(T* as, T* bs,
                                           const T* __restrict__ a,
                                           const T* __restrict__ b, int M,
                                           int N, int K, int bm, int bn,
                                           int k0, int tid) {
  if (ALIGNED) {
    // A: 128 rows x 4 chunks of 8; B: 32 rows x 16 chunks of 8.  K and N
    // are multiples of 8, so a chunk is wholly inside or wholly outside.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int id = tid + c * THREADS;
      const int row = id / 4, kc = (id % 4) * 8;
      const bool ok = bm + row < M && k0 + kc < K;
      const T* src = ok ? a + (size_t)(bm + row) * K + k0 + kc : a;
      cp_async16(as + row * A_STRIDE + kc, src, ok);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int id = tid + c * THREADS;
      const int row = id / 16, nc = (id % 16) * 8;
      const bool ok = k0 + row < K && bn + nc < N;
      const T* src = ok ? b + (size_t)(k0 + row) * N + bn + nc : b;
      cp_async16(bs + row * B_STRIDE + nc, src, ok);
    }
  } else {
    const T zero = T(0.f);
#pragma unroll 4
    for (int e = 0; e < BM * BK / THREADS; ++e) {
      const int id = tid + e * THREADS;
      const int row = id / BK, kc = id % BK;
      const bool ok = bm + row < M && k0 + kc < K;
      as[row * A_STRIDE + kc] = ok ? a[(size_t)(bm + row) * K + k0 + kc] : zero;
    }
#pragma unroll 4
    for (int e = 0; e < BK * BN / THREADS; ++e) {
      const int id = tid + e * THREADS;
      const int row = id / BN, nc = id % BN;
      const bool ok = k0 + row < K && bn + nc < N;
      bs[row * B_STRIDE + nc] = ok ? b[(size_t)(k0 + row) * N + bn + nc] : zero;
    }
  }
}

// Write the block's f32 accumulators to C through shared memory, 64 rows
// at a time (the warps of one row half stage their sub-tiles, then all
// threads store whole 16-byte chunks of C rows), so a warp's stores cover
// contiguous runs of C instead of 2- or 4-byte pieces of 8 rows.
template <typename OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[4][4][4],
                                           unsigned char* smem,
                                           OutT* __restrict__ c, int M, int N,
                                           int bm, int bn, int wm, int wn,
                                           int tid) {
  constexpr int VEC = 16 / sizeof(OutT);  // elements per 16-byte chunk
  constexpr int STRIDE = BN + VEC;        // padded row, 16-byte aligned
  constexpr int CHUNKS = BN / VEC;        // chunks per row
  OutT* tile = reinterpret_cast<OutT*>(smem);
  const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const bool vec_ok =
      N % VEC == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  for (int half = 0; half < 2; ++half) {
    if (wm == half * 64) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            simt::store_out(&tile[(mi * 16 + g + (e / 2) * 8) * STRIDE + wn +
                                  ni * 8 + t4 * 2 + e % 2],
                            acc[mi][ni][e]);
    }
    __syncthreads();
    for (int id = tid; id < 64 * CHUNKS; id += THREADS) {
      const int r = id / CHUNKS, cc = (id % CHUNKS) * VEC;
      const int row = bm + half * 64 + r, col = bn + cc;
      if (row >= M || col >= N) continue;
      const OutT* src = tile + r * STRIDE + cc;
      OutT* dst = c + (size_t)row * N + col;
      if (vec_ok && col + VEC <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < VEC && col + e < N; ++e) dst[e] = src[e];
      }
    }
    __syncthreads();
  }
}

template <typename T, typename OutT, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
gemm_tc_kernel(const T* __restrict__ a, const T* __restrict__ b,
               OutT* __restrict__ c, int M, int N, int K, int rows_fastest) {
  // two buffers each of A (BM x A_STRIDE) and B (BK x B_STRIDE); reused by
  // the epilogue for a 64-row slice of C
  constexpr int A_TILE = BM * A_STRIDE, B_TILE = BK * B_STRIDE;
  constexpr int SMEM = 2 * (A_TILE + B_TILE) * sizeof(T);
  static_assert(64 * (BN + 16 / sizeof(OutT)) * sizeof(OutT) <= SMEM,
                "the epilogue's slice of C must fit the operand buffers");
  __shared__ __align__(16) unsigned char smem[SMEM];
  T* const as[2] = {reinterpret_cast<T*>(smem),
                    reinterpret_cast<T*>(smem) + A_TILE};
  T* const bs[2] = {reinterpret_cast<T*>(smem) + 2 * A_TILE,
                    reinterpret_cast<T*>(smem) + 2 * A_TILE + B_TILE};
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile_m = rows_fastest ? blockIdx.x : blockIdx.y;
  const int tile_n = rows_fastest ? blockIdx.y : blockIdx.x;
  const int bm = tile_m * BM, bn = tile_n * BN;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
  if (nk > 0)
    load_tiles<T, ALIGNED>(as[0], bs[0], a, b, M, N, K, bm, bn, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    // the other buffer was last read before the previous barrier
    if (kt + 1 < nk)
      load_tiles<T, ALIGNED>(as[cur ^ 1], bs[cur ^ 1], a, b, M, N, K, bm, bn,
                             (kt + 1) * BK, tid);
    cp_async_commit();
    cp_async_wait1();  // the step kt group has landed
    __syncthreads();
    const T* at = as[cur];
    const T* bt = bs[cur];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], at + (wm + mi * 16 + lane % 16) * A_STRIDE + ks +
                                (lane / 16) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bt + (ks + lane % 8 + ((lane / 8) % 2) * 8) *
                                      B_STRIDE +
                                  wn + nj * 16 + (lane / 16) * 8);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) Mma<T>::run(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  store_tile(acc, smem, c, M, N, bm, bn, wm, wn, tid);
}

struct F32Loader {
  const float* a;
  const float* b;
  int M, N, K;
  struct Regs {
    float a[4], b[4];
  };
  // B's tile: thread t loads row k0 + t/32, columns bn + (t%32)*4 + {0..3}.
  __device__ __forceinline__ void load(Regs& r, int bm, int bn, int k0,
                                       int tid) const {
    simt::load_a(r.a, a, M, K, bm, k0, tid);
    const int kr = k0 + tid / 32, nc = bn + (tid % 32) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r.b[e] = (kr < K && nc + e < N) ? b[(size_t)kr * N + nc + e] : 0.f;
  }
  __device__ __forceinline__ void store(const Regs& r, float (*as)[simt::BM],
                                        float (*bs)[simt::BN], int tid) const {
    simt::store_a(r.a, as, tid);
    *reinterpret_cast<float4*>(&bs[tid / 32][(tid % 32) * 4]) =
        make_float4(r.b[0], r.b[1], r.b[2], r.b[3]);
  }
};

inline dim3 grid_for(int M, int N, int bm, int bn, int rows_fastest) {
  const unsigned tm = (M + bm - 1) / bm, tn = (N + bn - 1) / bn;
  return rows_fastest ? dim3(tm, tn) : dim3(tn, tm);
}

template <typename T, typename OutT>
int launch_tc(const void* a, const void* b, void* c, int M, int N, int K,
              int aligned, int rows_fastest, cudaStream_t s) {
  const dim3 grid = grid_for(M, N, BM, BN, rows_fastest);
  const auto* at = static_cast<const T*>(a);
  const auto* bt = static_cast<const T*>(b);
  auto* ct = static_cast<OutT*>(c);
  if (aligned)
    gemm_tc_kernel<T, OutT, true>
        <<<grid, THREADS, 0, s>>>(at, bt, ct, M, N, K, rows_fastest);
  else
    gemm_tc_kernel<T, OutT, false>
        <<<grid, THREADS, 0, s>>>(at, bt, ct, M, N, K, rows_fastest);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_f32(const void* a, const void* b, void* c, int M, int N, int K,
               int rows_fastest, cudaStream_t s) {
  const dim3 grid = grid_for(M, N, simt::BM, simt::BN, rows_fastest);
  F32Loader ld{static_cast<const float*>(a), static_cast<const float*>(b), M,
               N, K};
  simt::gemm_kernel<F32Loader, OutT><<<grid, simt::THREADS, 0, s>>>(
      ld, static_cast<OutT*>(c), M, N, K, rows_fastest);
  return static_cast<int>(cudaGetLastError());
}

// Dtype codes shared with kernels/gemm.py: 0 f32, 1 bf16, 2 f16.
template <typename T>
int launch_tc_out(int out_dtype, const void* a, const void* b, void* c, int M,
                  int N, int K, int aligned, int rows_fastest,
                  cudaStream_t s) {
  switch (out_dtype) {
    case 0:
      return launch_tc<T, float>(a, b, c, M, N, K, aligned, rows_fastest, s);
    case 1:
      return launch_tc<T, __nv_bfloat16>(a, b, c, M, N, K, aligned,
                                         rows_fastest, s);
    case 2:
      return launch_tc<T, __half>(a, b, c, M, N, K, aligned, rows_fastest, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// in_dtype 0 (f32, FMA core) or 1 / 2 (bf16 / f16, tensor cores); out_dtype
// 0 / 1 / 2.  aligned: K and N multiples of 8 and 16-byte aligned A and B
// (tensor-core path only).  rows_fastest: the K4 block order.
int gemm_launch(int in_dtype, int out_dtype, const void* a, const void* b,
                void* c, int M, int N, int K, int aligned, int rows_fastest,
                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) {
    switch (out_dtype) {
      case 0: return launch_f32<float>(a, b, c, M, N, K, rows_fastest, s);
      case 1:
        return launch_f32<__nv_bfloat16>(a, b, c, M, N, K, rows_fastest, s);
      case 2: return launch_f32<__half>(a, b, c, M, N, K, rows_fastest, s);
    }
  } else if (in_dtype == 1) {
    return launch_tc_out<__nv_bfloat16>(out_dtype, a, b, c, M, N, K, aligned,
                                        rows_fastest, s);
  } else if (in_dtype == 2) {
    return launch_tc_out<__half>(out_dtype, a, b, c, M, N, K, aligned,
                                 rows_fastest, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
