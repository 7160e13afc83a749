// K3: tiled GEMM, C (M, N) = A (M, K) @ B (K, N), f32 products and
// accumulation, C cast once to the output dtype (f32, bf16 or f16).  K4:
// the same product over a stack of S small-M GEMMs that share one B, A
// given as (S*M, K).
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
// Three hand-written paths, chosen by the wrapper from the shape before the
// launch (kernels/gemm.py::gemm_schedule):
//
// wgmma (bf16/f16, K and N multiples of 8, 16-byte aligned A and B: what
// TMA takes).  A block of 384 threads computes a 128 x 256 tile of C in K
// steps of 64.  Warpgroup 0 is the producer: one thread issues TMA loads
// (cp.async.bulk.tensor.2d, 128-byte swizzle) of the step's A box (128 x
// 64, 16 KiB) and B boxes (64 x 64 each, 32 KiB) into a ring of 4 stages
// (192 KiB), each with a full and an empty mbarrier.  Warpgroups 1 and 2
// are consumers: each runs wgmma m64n256k16 with f32 accumulators on its 64
// rows, A K-major and B as stored (N-contiguous, the transpose-B
// immediate), both read through shared-memory descriptors (hopper.cuh).  A
// consumer releases a stage (one arrival per warp on its empty barrier)
// once the wgmma group that read it has completed, keeping one group in
// flight.  TMA zero-fills what lies past M, N or K, so ragged shapes need
// no element path; B boxes wholly past N are not loaded.  The epilogue
// stages the tile through the ring and writes C in 16-byte stores masked
// at the M / N edge.  Registers: producer 40, consumers 232
// (setmaxnreg).  The tensor maps are encoded on the host each call
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint) and passed as
// __grid_constant__ parameters.
//
// mma.sync (bf16/f16 shapes TMA cannot take): a 128 x 128 block tile
// walked in K steps of 32, double-buffered in shared memory with cp.async
// (16-byte copies, zero-filled past the edges; element by element when a
// row is not a whole number of 16-byte chunks), 8 warps each owning a 64 x
// 32 sub-tile computed with mma.sync m16n8k16 (f32 accumulators) from
// ldmatrix fragments; shared rows padded by 8 elements so ldmatrix reads
// are free of bank conflicts; C written through shared memory in 16-byte
// chunks.
//
// f32: the FMA core of simt_gemm.cuh (128 x 128 tiles, K steps of 16, a
// 3-stage cp.async ring; element loads where K or N is not a multiple of
// 4), one block an SM.
//
// Split K (wgmma and f32): when the output tiles do not fill the SMs,
// grid.z splits K; each split writes an f32 partial tile into a workspace
// the wrapper allocates, and simt::splitk_reduce_kernel (shared with K5)
// adds the splits in a fixed order and casts, so results are the same from
// run to run.
//
// K4 is this GEMM with the block order changed: rows_fastest walks every
// (S*M)-row tile of one column tile before the next column tile, so the
// blocks that read one column slice of B run together and B comes from
// device memory once, then from the 50 MB L2 (a (4096, 4096) bf16 B is
// 33.5 MB), which is Hopper's counterpart of the TPU's VMEM-resident tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma.cuh"
#include "simt_gemm.cuh"

namespace {

// ---------------------------------------------------------------- mma.sync
namespace ms {


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

}  // namespace ms

// ------------------------------------------------------------------- wgmma
namespace wg {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int THREADS = 384;                // producer + 2 consumer groups
constexpr int BOX_N = 64;                   // N of one B box (128 bytes)
constexpr int A_BYTES = BM * BK * 2;        // one A box, 16 KiB
constexpr int B_BOX_BYTES = BK * BOX_N * 2;  // 8 KiB
constexpr int STAGE_BYTES = A_BYTES + (BN / BOX_N) * B_BOX_BYTES;  // 48 KiB
// the ring, 1024 bytes of slack to align it, and the 2 x STAGES barriers
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

template <typename OutT>
__device__ __forceinline__ void store2(OutT* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
template <>
__device__ __forceinline__ void store2<__half>(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

// C (or split z's f32 partial, at c + z M N) for one 128 x 256 tile.  K
// tiles [z k_tiles_split, (z+1) k_tiles_split) of the k_tiles in all.  N is
// a multiple of 8, so a 16-byte chunk of a C row is wholly in or out.
template <typename T, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b,
                  OutT* __restrict__ c, int M, int N, int k_tiles,
                  int k_tiles_split, int rows_fastest) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tile_m = rows_fastest ? blockIdx.x : blockIdx.y;
  const int tile_n = rows_fastest ? blockIdx.y : blockIdx.x;
  const int kt0 = blockIdx.z * k_tiles_split;
  const int nk = max(0, min(k_tiles, kt0 + k_tiles_split) - kt0);
  c += (size_t)blockIdx.z * M * N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tma_a);
      hopper::tma_prefetch(&tma_b);
      const int n_boxes =
          min(BN / BOX_N, (N - tile_n * BN + BOX_N - 1) / BOX_N);
      const uint32_t bytes = A_BYTES + n_boxes * B_BOX_BYTES;
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        // wait until the consumers released this stage's previous use
        if (i >= STAGES) hopper::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        unsigned char* st = ring + s * STAGE_BYTES;
        const int k0 = (kt0 + i) * BK;
        hopper::mbar_arrive_expect_tx(&full[s], bytes);
        hopper::tma_load_2d(st, &tma_a, &full[s], k0, tile_m * BM);
        for (int j = 0; j < n_boxes; ++j)
          hopper::tma_load_2d(st + A_BYTES + j * B_BOX_BYTES, &tma_b,
                              &full[s], tile_n * BN + j * BOX_N, k0);
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  hopper::setmaxnreg_inc<232>();
  const int cw = threadIdx.x / 128 - 1;  // rows 64 cw .. 64 cw + 63
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    const unsigned char* a_t = ring + s * STAGE_BYTES + cw * (64 * 128);
    const unsigned char* b_t = ring + s * STAGE_BYTES + A_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::Wgmma<T>::m64n256k16(
          acc, hopper::desc_k_major_sw128(a_t + kk * 32),
          hopper::desc_mn_major_sw128(b_t + kk * 16 * 128, B_BOX_BYTES));
    hopper::wgmma_commit();
    // the previous step's group has finished reading its stage
    hopper::wgmma_wait<1>();
    if (i > 0 && lane == 0) hopper::mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // epilogue: both consumer groups are done with the ring; stage the tile
  // there (rows padded by 16 bytes), then write whole 16-byte chunks
  hopper::named_barrier<1, 256>();
  constexpr int VEC = 16 / sizeof(OutT);
  constexpr int STRIDE = BN + VEC;
  constexpr int CHUNKS = BN / VEC;
  static_assert(BM * STRIDE * sizeof(OutT) <= STAGES * STAGE_BYTES,
                "the staged tile must fit the ring");
  OutT* tile = reinterpret_cast<OutT*>(ring);
  const int r0 = cw * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    store2(&tile[r0 * STRIDE + col], acc[4 * j], acc[4 * j + 1]);
    store2(&tile[(r0 + 8) * STRIDE + col], acc[4 * j + 2], acc[4 * j + 3]);
  }
  hopper::named_barrier<1, 256>();
  const int bm = tile_m * BM, bn = tile_n * BN;
  for (int id = threadIdx.x - 128; id < BM * CHUNKS; id += 256) {
    const int r = id / CHUNKS, cc = (id % CHUNKS) * VEC;
    const int row = bm + r, col = bn + cc;
    if (row < M && col < N)
      *reinterpret_cast<uint4*>(c + (size_t)row * N + col) =
          *reinterpret_cast<const uint4*>(tile + r * STRIDE + cc);
  }
}

// A row-major (rows, cols) matrix of 16-bit values as boxes of (box_rows,
// 64) elements with the 128-byte swizzle, zeros outside.
bool encode(CUtensorMap* map, hopper::EncodeTiled fn,
            CUtensorMapDataType type,
            const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, typename OutT>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           int splits, int k_split, int rows_fastest, cudaStream_t s) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return hopper::kNoEncoder;
  const CUtensorMapDataType type = hopper::tma_type<T>();
  CUtensorMap ma, mb;
  if (!encode(&ma, fn, type, a, M, K, BM) || !encode(&mb, fn, type, b, K, N, BK))
    return hopper::kEncodeFailed;
  // above 48 KB of dynamic shared memory: once per instantiation and card
  const cudaError_t rc = hopper::allow_smem(
      reinterpret_cast<const void*>(gemm_wgmma_kernel<T, OutT>), SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned tm = (M + BM - 1) / BM, tn = (N + BN - 1) / BN;
  const dim3 grid = rows_fastest ? dim3(tm, tn, splits) : dim3(tn, tm, splits);
  gemm_wgmma_kernel<T, OutT><<<grid, THREADS, SMEM, s>>>(
      ma, mb, static_cast<OutT*>(c), M, N, (K + BK - 1) / BK, k_split / BK,
      rows_fastest);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ------------------------------------------------------------------- f32
template <bool ALIGNED>
struct F32Loader {
  const float* a;
  const float* b;
  int M, N, K;
  struct Regs {};
  // Aligned (K and N multiples of 4, 16-byte aligned bases): cp.async of
  // 16-byte chunks, zero-filled past the edges; A's 128 rows x 4 chunks and
  // B's 16 rows x 32 chunks, two of each a thread.  Otherwise element by
  // element, straight into the stage.
  __device__ __forceinline__ void load(Regs&, int bm, int bn, int k0, int tid,
                                       float* as, float* bs) const {
    if (ALIGNED) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int id = tid + h * simt::THREADS;
        const int row = id / 4, kc = (id % 4) * 4;
        const bool ok = bm + row < M && k0 + kc < K;
        cp_async16(as + simt::a_index(row, kc),
                   ok ? a + (size_t)(bm + row) * K + k0 + kc : a, ok);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int id = tid + h * simt::THREADS;
        const int row = id / 32, nc = (id % 32) * 4;
        const bool ok = k0 + row < K && bn + nc < N;
        cp_async16(bs + row * simt::BN + nc,
                   ok ? b + (size_t)(k0 + row) * N + bn + nc : b, ok);
      }
    } else {
#pragma unroll 4
      for (int e = 0; e < simt::A_STAGE / simt::THREADS; ++e) {
        const int id = tid + e * simt::THREADS;
        const int row = id / simt::BK, kc = id % simt::BK;
        const bool ok = bm + row < M && k0 + kc < K;
        as[simt::a_index(row, kc)] =
            ok ? a[(size_t)(bm + row) * K + k0 + kc] : 0.f;
      }
#pragma unroll 4
      for (int e = 0; e < simt::B_STAGE / simt::THREADS; ++e) {
        const int id = tid + e * simt::THREADS;
        const int row = id / simt::BN, nc = id % simt::BN;
        const bool ok = k0 + row < K && bn + nc < N;
        bs[row * simt::BN + nc] = ok ? b[(size_t)(k0 + row) * N + bn + nc] : 0.f;
      }
    }
  }
  __device__ __forceinline__ void store(const Regs&, float*, float*,
                                        int) const {}
};

inline dim3 grid_for(int M, int N, int bm, int bn, int splits,
                     int rows_fastest) {
  const unsigned tm = (M + bm - 1) / bm, tn = (N + bn - 1) / bn;
  return rows_fastest ? dim3(tm, tn, splits) : dim3(tn, tm, splits);
}

template <typename OutT>
int launch_f32(const void* a, const void* b, void* c, int M, int N, int K,
               int aligned, int splits, int k_split, int rows_fastest,
               cudaStream_t s) {
  const dim3 grid = grid_for(M, N, simt::BM, simt::BN, splits, rows_fastest);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  auto* cp = static_cast<OutT*>(c);
  if (aligned)
    simt::gemm_kernel<F32Loader<true>, OutT><<<grid, simt::THREADS, 0, s>>>(
        F32Loader<true>{ap, bp, M, N, K}, cp, M, N, K, k_split, rows_fastest);
  else
    simt::gemm_kernel<F32Loader<false>, OutT><<<grid, simt::THREADS, 0, s>>>(
        F32Loader<false>{ap, bp, M, N, K}, cp, M, N, K, k_split, rows_fastest);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OutT>
int launch_mma_sync(const void* a, const void* b, void* c, int M, int N, int K,
                    int aligned, int rows_fastest, cudaStream_t s) {
  const dim3 grid = grid_for(M, N, ms::BM, ms::BN, 1, rows_fastest);
  const auto* at = static_cast<const T*>(a);
  const auto* bt = static_cast<const T*>(b);
  auto* ct = static_cast<OutT*>(c);
  if (aligned)
    ms::gemm_tc_kernel<T, OutT, true>
        <<<grid, ms::THREADS, 0, s>>>(at, bt, ct, M, N, K, rows_fastest);
  else
    ms::gemm_tc_kernel<T, OutT, false>
        <<<grid, ms::THREADS, 0, s>>>(at, bt, ct, M, N, K, rows_fastest);
  return static_cast<int>(cudaGetLastError());
}

// Path codes shared with kernels/gemm.py: 0 f32 (FMA core), 1 mma.sync, 2
// wgmma.  With splits > 1 the GEMM kernel writes f32 partials to ws (splits,
// M, N) and the reduce kernel writes c.
template <typename T, typename OutT>
int launch_path(int path, const void* a, const void* b, void* c, void* ws,
                int M, int N, int K, int aligned, int splits, int k_split,
                int rows_fastest, cudaStream_t s) {
  int rc;
  if constexpr (std::is_same<T, float>::value) {
    if (splits == 1)
      return launch_f32<OutT>(a, b, c, M, N, K, aligned, 1, k_split,
                              rows_fastest, s);
    rc = launch_f32<float>(a, b, ws, M, N, K, aligned, splits, k_split,
                           rows_fastest, s);
  } else {
    if (path == 1)
      return splits == 1 ? launch_mma_sync<T, OutT>(a, b, c, M, N, K, aligned,
                                                    rows_fastest, s)
                         : static_cast<int>(cudaErrorInvalidValue);
    if (splits == 1)
      return wg::launch<T, OutT>(a, b, c, M, N, K, 1, k_split, rows_fastest,
                                 s);
    rc = wg::launch<T, float>(a, b, ws, M, N, K, splits, k_split,
                              rows_fastest, s);
  }
  if (rc != 0) return rc;
  return simt::launch_reduce<OutT>(ws, c, M, N, splits, s);
}

// Dtype codes shared with kernels/gemm.py: 0 f32, 1 bf16, 2 f16.
template <typename T>
int launch_out(int out_dtype, int path, const void* a, const void* b, void* c,
               void* ws, int M, int N, int K, int aligned, int splits,
               int k_split, int rows_fastest, cudaStream_t s) {
  switch (out_dtype) {
    case 0:
      return launch_path<T, float>(path, a, b, c, ws, M, N, K, aligned,
                                   splits, k_split, rows_fastest, s);
    case 1:
      return launch_path<T, __nv_bfloat16>(path, a, b, c, ws, M, N, K,
                                           aligned, splits, k_split,
                                           rows_fastest, s);
    case 2:
      return launch_path<T, __half>(path, a, b, c, ws, M, N, K, aligned,
                                    splits, k_split, rows_fastest, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// in_dtype 0 (f32) or 1 / 2 (bf16 / f16); out_dtype 0 / 1 / 2.  path 0
// (f32 only), 1 (mma.sync) or 2 (wgmma: K and N multiples of 8, A and B
// 16-byte aligned).  aligned: K and N multiples of 16 bytes' worth of
// elements and 16-byte aligned A and B.  splits K splits of k_split
// elements (a multiple of the path's K step), ws an f32 (splits, M, N)
// workspace when splits > 1.  rows_fastest: the K4 block order.  Returns a
// cudaError_t, or -1 / -2 when a TMA descriptor cannot be encoded.
int gemm_launch(int in_dtype, int out_dtype, int path, const void* a,
                const void* b, void* c, void* ws, int M, int N, int K,
                int aligned, int splits, int k_split, int rows_fastest,
                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool ok = in_dtype == 0 ? path == 0 : (path == 1 || path == 2);
  if (!ok || splits < 1 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (in_dtype) {
    case 0:
      return launch_out<float>(out_dtype, path, a, b, c, ws, M, N, K, aligned,
                               splits, k_split, rows_fastest, s);
    case 1:
      return launch_out<__nv_bfloat16>(out_dtype, path, a, b, c, ws, M, N, K,
                                       aligned, splits, k_split, rows_fastest,
                                       s);
    case 2:
      return launch_out<__half>(out_dtype, path, a, b, c, ws, M, N, K,
                                aligned, splits, k_split, rows_fastest, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
