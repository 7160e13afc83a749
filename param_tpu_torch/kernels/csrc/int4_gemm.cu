// K5: x (M, K) @ W (K, N) for group-wise int4 W, out (M, N) in f32 / bf16 /
// f16.  W is given as `packed` (K/2, N) int8, two nibbles per byte along K
// (row 2i in the low nibble, stored +8-biased: (b & 15) - 8; row 2i+1 in
// the high nibble: b >> 4, arithmetic), and `scale` (K/g, N) f32; packed
// row i uses scale row i / gh, gh = g/2.  x is bf16.
//
// Replaces the TPU kernel param_tpu/ops/matmul.py::_mm_int4_kernel (via
// matmul_int4), which unpacks each weight tile in-register and issues one
// MXU dot per nibble plane.
//
// Numerics: every weight is dequantized in f32 (q * scale) and multiplied
// by x (bf16 -> f32) with f32 accumulation.  That is the arithmetic of the
// reference's CPU run (mxu_dtype f32); on the TPU the reference rounds the
// dequantized tile to bf16 before its dot, so TPU results differ from both
// by that rounding.
//
// What bounds it on an H100: at serving M (<= 32) the packed weight stream,
// K*N/2 bytes (+ scales, x, out) over 3.35 TB/s; at large M, operations.
//
// Design (int4_mma_kernel): tensor cores on exact integers.  A weight
// nibble q in [-8, 7] is exact in bf16, and so is x * q in f32, so each
// scale group's partial sum P[m, n] = sum_k x[m, k] q[k, n] is taken with
// mma.sync m16n8k16 (bf16 operands, f32 accumulation) and then scaled in
// f32: acc[m, n] += P[m, n] * scale[group, n].  This is the function above
// to f32 rounding, not the TPU's bf16-rounded weights.
//   A warp owns 16 rows of x and 128 columns; a lane reads 16 bytes (16
// columns) of two packed rows per k16 step, and those bytes are already the
// lane's B fragments: the mma's n index is taken as "column 16 * (lane / 4)
// + j of the slab" for the j-th n8 tile, so no shuffles are needed.  A byte
// becomes its (low, high) bf16 pair with one byte permute, one logic op and
// one bf16x2 subtract (128 + u - 136, u = nibble + 8).  The running sums
// are kept per lane in shared memory between scale groups.
//   Grid: row tiles of 16 fastest (blocks that share a weight slice run
// together, so it is read from device memory once), then 512-column tiles
// (4 warps), then K splits.  Each K split writes an f32 partial and a
// second kernel (simt::splitk_reduce_kernel) adds them in a fixed order:
// no atomics, so results are the same from run to run.
//   Groups of g not a multiple of 16 take the FMA core of simt_gemm.cuh
// (one K split) with a register loader that dequantizes each 16 x 128
// tile of B into shared memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "simt_gemm.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int SLAB = 128;                 // columns of one warp
constexpr int COLS_PER_BLOCK = WARPS * SLAB;
constexpr int ACC_STRIDE = 17;            // floats per lane row of acc_s

// One byte of each of two packed rows -> the bf16 pairs (low nibble, high
// nibble) of two B fragment registers.  lo / hi hold the nibbles of 4
// columns as u = value + 8; byte c of each is column c.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t lo, uint32_t hi,
                                                int c) {
  // bytes (lo_c, lo_c, hi_c, hi_c) -> (lo_c, 0x43, hi_c, 0x43): the bf16
  // bits of 128 + u in each half; then subtract 136 from both halves
  const uint32_t sel = c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12);
  const uint32_t bits = (__byte_perm(lo, hi, sel) & 0x00FF00FFu) | 0x43004300u;
  const uint32_t bias_bits = 0x43084308u;  // (136, 136) in bf16
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits),
              *reinterpret_cast<const __nv_bfloat162*>(&bias_bits));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void load16(uint32_t (&w)[4],
                                       const int8_t* __restrict__ p, int col,
                                       int N, bool vec) {
  if (vec && col + 16 <= N) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = col + 4 * q + c;
      const uint32_t b = n < N ? static_cast<uint8_t>(__ldg(p + 4 * q + c)) : 0;
      w[q] |= b << (8 * c);
    }
  }
}

// grid: x = row tiles of 16, y = column tiles of COLS_PER_BLOCK, z = K
// splits of `rows_per_split` packed rows (a multiple of 8).  gh % 8 == 0.
// partial: (gridDim.z, M, N) f32.
template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ packed,
                const float* __restrict__ scale, float* __restrict__ partial,
                int M, int N, int KH, int gh, int rows_per_split) {
  __shared__ float acc_s[WARPS][4][32 * ACC_STRIDE];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int K = 2 * KH;
  const int m0 = blockIdx.x * 16;
  const int slab = blockIdx.y * COLS_PER_BLOCK + warp * SLAB;
  const int wcol = slab + 16 * g;       // the lane's 16 weight columns
  const int scol = slab + 32 * t4;      // its 32 output columns
  const int i_begin = blockIdx.z * rows_per_split;
  const int i_end = min(KH, i_begin + rows_per_split);
  float* acc = acc_s[warp][0] + lane * ACC_STRIDE;  // [e][lane][j]
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[e * 32 * ACC_STRIDE + j] = 0.f;

  const bool row_lo = m0 + g < M, row_hi = m0 + g + 8 < M;
  const __nv_bfloat16* x_lo = x + (size_t)(m0 + g) * K;
  const __nv_bfloat16* x_hi = x_lo + (size_t)8 * K;

  float part[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;

  // the two packed rows of the next k16 step are loaded before this step's
  // math, so two steps' loads are in flight
  uint32_t w0[4] = {0, 0, 0, 0}, w1[4] = {0, 0, 0, 0};
  if (i_begin < i_end) {
    load16(w0, packed + (size_t)(i_begin + t4) * N + wcol, wcol, N, VEC);
    load16(w1, packed + (size_t)(i_begin + 4 + t4) * N + wcol, wcol, N, VEC);
  }
  for (int i0 = i_begin; i0 < i_end; i0 += 8) {
    uint32_t n0[4], n1[4];
    const bool more = i0 + 8 < i_end;
    if (more) {
      load16(n0, packed + (size_t)(i0 + 8 + t4) * N + wcol, wcol, N, VEC);
      load16(n1, packed + (size_t)(i0 + 12 + t4) * N + wcol, wcol, N, VEC);
    }
    const int k = 2 * i0 + 2 * t4;
    uint32_t a[4];
    a[0] = row_lo ? *reinterpret_cast<const uint32_t*>(x_lo + k) : 0u;
    a[1] = row_hi ? *reinterpret_cast<const uint32_t*>(x_hi + k) : 0u;
    a[2] = row_lo ? *reinterpret_cast<const uint32_t*>(x_lo + k + 8) : 0u;
    a[3] = row_hi ? *reinterpret_cast<const uint32_t*>(x_hi + k + 8) : 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo0 = w0[q] & 0x0F0F0F0Fu;
      const uint32_t hi0 = ((w0[q] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
      const uint32_t lo1 = w1[q] & 0x0F0F0F0Fu;
      const uint32_t hi1 = ((w1[q] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t b[2] = {nibble_pair(lo0, hi0, c),
                               nibble_pair(lo1, hi1, c)};
        Mma<__nv_bfloat16>::run(part[4 * q + c], a, b);
      }
    }
    // end of a scale group or of the split: acc += part * scale
    if ((i0 + 8) % gh == 0 || i0 + 8 >= i_end) {
      const float* srow = scale + (size_t)(i0 / gh) * N + scol;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float s0 = scol + j < N ? __ldg(srow + j) : 0.f;
        const float s1 = scol + 16 + j < N ? __ldg(srow + 16 + j) : 0.f;
        acc[0 * 32 * ACC_STRIDE + j] += part[j][0] * s0;
        acc[1 * 32 * ACC_STRIDE + j] += part[j][1] * s1;
        acc[2 * 32 * ACC_STRIDE + j] += part[j][2] * s0;
        acc[3 * 32 * ACC_STRIDE + j] += part[j][3] * s1;
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
      }
    }
    if (more) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w0[q] = n0[q];
        w1[q] = n1[q];
      }
    }
  }
  __syncwarp();

  // lane (g, t4)'s value e of tile j is row g + 8 * (e / 2), column
  // scol + 16 * (e % 2) + j; write the warp's 16 x 128 slab row by row,
  // 32 consecutive columns per store
  for (int r = 0; r < 16 && m0 + r < M; ++r) {
    float* out = partial + ((size_t)blockIdx.z * M + m0 + r) * N + slab;
#pragma unroll
    for (int cc = 0; cc < SLAB; cc += 32) {
      const int c = cc + lane;
      const int src_lane = (r % 8) * 4 + c / 32;
      const int e = (r / 8) * 2 + (c % 32) / 16;
      if (slab + c < N)
        out[c] = acc_s[warp][e][src_lane * ACC_STRIDE + c % 16];
    }
  }
}

struct Int4Loader {
  const __nv_bfloat16* x;
  const int8_t* packed;
  const float* scale;
  int M, N, K, gh;  // K = 2 * packed rows
  struct Regs {
    float a[8];
    int q[4];
    float s[4];
  };
  // B's tile is 8 packed rows x 128 columns: thread t loads packed row
  // k0/2 + t/32, columns bn + (t%32)*4 + {0..3}, and their scales.
  __device__ __forceinline__ void load(Regs& r, int bm, int bn, int k0,
                                       int tid, float*, float*) const {
    simt::load_a(r.a, x, M, K, bm, k0, tid);
    const int i = k0 / 2 + tid / 32, n = bn + (tid % 32) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = 2 * i < K && n + e < N;
      r.q[e] = ok ? packed[(size_t)i * N + n + e] : 0;
      r.s[e] = ok ? scale[(size_t)(i / gh) * N + n + e] : 0.f;
    }
  }
  __device__ __forceinline__ void store(const Regs& r, float* as, float* bs,
                                        int tid) const {
    simt::store_a(r.a, as, tid);
    const int kr = 2 * (tid / 32), nc = (tid % 32) * 4;
    float lo[4], hi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo[e] = static_cast<float>((r.q[e] & 15) - 8) * r.s[e];
      hi[e] = static_cast<float>(r.q[e] >> 4) * r.s[e];
    }
    *reinterpret_cast<float4*>(&bs[kr * simt::BN + nc]) =
        make_float4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<float4*>(&bs[(kr + 1) * simt::BN + nc]) =
        make_float4(hi[0], hi[1], hi[2], hi[3]);
  }
};

int launch_mma(const void* x, const void* packed, const void* scale,
               void* partial, int M, int N, int KH, int gh,
               int rows_per_split, int nsplit, int vec, cudaStream_t s) {
  const dim3 grid((M + 15) / 16, (N + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK,
                  nsplit);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* pp = static_cast<const int8_t*>(packed);
  const auto* sp = static_cast<const float*>(scale);
  auto* part = static_cast<float*>(partial);
  if (vec)
    int4_mma_kernel<true><<<grid, WARPS * 32, 0, s>>>(
        xp, pp, sp, part, M, N, KH, gh, rows_per_split);
  else
    int4_mma_kernel<false><<<grid, WARPS * 32, 0, s>>>(
        xp, pp, sp, part, M, N, KH, gh, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_tiled(const void* x, const void* packed, const void* scale,
                 void* out, int M, int N, int KH, int gh, cudaStream_t s) {
  const dim3 grid((N + simt::BN - 1) / simt::BN, (M + simt::BM - 1) / simt::BM);
  Int4Loader ld{static_cast<const __nv_bfloat16*>(x),
                static_cast<const int8_t*>(packed),
                static_cast<const float*>(scale), M, N, 2 * KH, gh};
  simt::gemm_kernel<Int4Loader, OutT><<<grid, simt::THREADS, 0, s>>>(
      ld, static_cast<OutT*>(out), M, N, 2 * KH, 2 * KH, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dtype codes shared with kernels/int4_gemm.py: 0 f32, 1 bf16, 2 f16.
// The tensor-core path: partial is (nsplit, M, N) f32 scratch;
// rows_per_split is a multiple of 8 with nsplit * rows_per_split >= KH;
// gh % 8 == 0; vec: N % 16 == 0 and `packed` 16-byte aligned; x 4-byte
// aligned.
int int4_gemm_mma(const void* x, const void* packed, const void* scale,
                  void* partial, void* out, int out_dtype, int M, int N,
                  int KH, int gh, int rows_per_split, int nsplit, int vec,
                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = launch_mma(x, packed, scale, partial, M, N, KH, gh,
                            rows_per_split, nsplit, vec, s);
  if (rc != 0) return rc;
  switch (out_dtype) {
    case 0: return simt::launch_reduce<float>(partial, out, M, N, nsplit, s);
    case 1:
      return simt::launch_reduce<__nv_bfloat16>(partial, out, M, N, nsplit, s);
    case 2: return simt::launch_reduce<__half>(partial, out, M, N, nsplit, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The FMA path, for any gh.
int int4_gemm_tiled(const void* x, const void* packed, const void* scale,
                    void* out, int out_dtype, int M, int N, int KH, int gh,
                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return launch_tiled<float>(x, packed, scale, out, M, N, KH, gh, s);
    case 1:
      return launch_tiled<__nv_bfloat16>(x, packed, scale, out, M, N, KH, gh, s);
    case 2: return launch_tiled<__half>(x, packed, scale, out, M, N, KH, gh, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
