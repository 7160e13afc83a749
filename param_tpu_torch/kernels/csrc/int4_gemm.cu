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
// Numerics, on every path: a nibble q in [-8, 7] is exact in bf16 and so is
// x * q in f32, so each scale group's partial sum P[m, n] = sum_k x[m, k]
// q[k, n] is taken on the tensor cores (bf16 operands, f32 accumulation)
// and then scaled in f32: acc[m, n] += P[m, n] * scale[group, n].  That is
// the reference's "group-dots" order to f32 rounding; q * scale is never
// rounded to bf16 (the TPU's own schedule does that; the port does not).
// No float atomics: K splits are added in a fixed order, so two runs give
// the same bits.
//
// What bounds it on an H100: at serving M (<= 32) the packed weight
// stream, K*N/2 bytes (+ scales, x, out) over 3.35 TB/s; at large M,
// operations (2MNK over 989 TF/s).  On the stream the cost is the
// unpacking, not the copies: every packed byte becomes two bf16 values in
// registers, three instructions a pair at best in this layout.
//
// Four paths, chosen by the wrapper from the shape before the launch
// (kernels/int4_gemm.py::int4_schedule):
//
// stream (M <= 32; N % 16 == 0, K % 8 == 0, 16-byte aligned bases, gh % 8
// == 0).  Swap AB: the weight is the A operand of the tensor-core product
// (out^T = W^T x^T), so a handful of x rows is the N side and needs no
// 16-row padding.  Lane (g, t) reads bytes of packed rows t and t + 4 of
// each k16 step from shared memory, and they are its A fragments as they
// stand: byte c of row t holds k 2t, 2t + 1 of one column.  A byte becomes
// its (low, high) bf16 pair with one byte permute, one logic op and one
// bf16x2 subtract (nibbles_of_byte).  K is split to fill the card, within
// a budget on the f32 partial sums' bytes.  Two kernels:
//  - M <= 8 (st::int4_stream_kernel): mma.sync m16n8k16, one n8 tile of
//    x rows.  A block of 4 warps owns 128 columns and one K split; each
//    warp streams its quarter of the split through its own 4-stage
//    cp.async ring (2 KiB stages of 128-byte rows, 16-byte copies, a chunk
//    swizzle so the lanes' 16-byte reads are free of bank conflicts), with
//    no block barrier in the loop; x's rows and the scale rows of the
//    split sit in shared memory from the start.  A lane's 16 bytes of a
//    row are 8 m16 tiles; it scales its partial sums once per group.
//  - M 9-32 (rs::int4_stream_wgmma_kernel): wgmma m64nNk16 with A in
//    registers, N = 16 or 32 x rows.  A warpgroup owns 128 columns; its
//    4-stage cp.async ring holds, per stage of 64 packed rows, x's rows as
//    two 64-k K-major boxes with the 128-byte swizzle (B), the weights and
//    the scale rows.  A lane reads 4 bytes of two rows: the fragments of
//    two m64 tiles.  Four steps' A registers rotate, so three steps'
//    products stay in flight.
//
// wgmma (M > 32; the stream path's alignment, and gh % 32 == 0): 128 x 128
// output tiles in K steps of 64 (32 packed rows), four warpgroups with
// their own jobs.  Warpgroup 0's first thread TMA-loads x's 128 x 64 box
// (128-byte swizzle, K-major A, as K3's A) and the packed 32 x 128 byte
// tile, and bulk-copies the step's scale row, into a 6-stage ring of full
// / empty mbarriers.  Warpgroup 1 (the transform) dequantizes each packed
// tile, once per output tile, into the exact bf16 integers q laid out as
// K3's MN-major B (two 64-column boxes with the 128-byte swizzle) in one
// of four buffers (ready / free mbarriers), up to three steps ahead.
// Warpgroups 2 and 3 run wgmma m64n128k16 on their 64 rows, one step's
// products in flight within a group.  The group's partial P (64
// registers) starts afresh at each group (scale_d = 0) and is added into
// the accumulator (64 more) as acc += P * scale[n] in f32 at the group's
// end.  Registers: 40 / 96 / 184 (setmaxnreg).

// Split K on stream and wgmma: each split writes an f32 partial tile; a
// per-tile arrival counter lets the last block of a tile add the partials
// in split order (reading them from L2), write the output and reset the
// counter, all in the same launch.  The counters are a zeroed int32 buffer
// the wrapper keeps for each CUDA stream (launches on one stream do not
// overlap); each launch leaves it zeroed again.
//
// mma_sync (what TMA or 16-byte copies cannot describe: N % 16 != 0 or
// unaligned bases; also gh % 32 != 0 above M 32; the parent design, kept):
// int4_mma_kernel below.  A warp owns 16 rows of x and 128 columns; a lane
// reads 16 bytes (16 columns) of two packed rows per k16 step, and those
// bytes are already the lane's B fragments: the mma's n index is taken as
// "column 16 * (lane / 4) + j of the slab" for the j-th n8 tile, so no
// shuffles are needed.  The running sums are kept per lane in shared
// memory between scale groups.  Grid: row tiles of 16 fastest, then
// 512-column tiles (4 warps), then K splits.  Each K split writes an f32
// partial and a second kernel (simt::splitk_reduce_kernel) adds them in a
// fixed order.
//
// simt (groups of g not a multiple of 16): the FMA core of simt_gemm.cuh
// (one K split) with a register loader that dequantizes each 16 x 128 tile
// of B into shared memory, in f32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
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

// ------------------------------------------------------------ both new paths

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (a & b) ^ c and (a & b) | c in one instruction: the constants go in as
// registers, since a LOP3 takes one immediate and the compiler would
// otherwise split the expression in two
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// bytes (a, b) of `src` -> the bf16 pair (128 + a - 136, 128 + b - 136):
// `sel` (a prmt selector over the 8 bytes of lo, hi) puts the two bytes,
// each holding u = nibble + 8 in [0, 15], at bytes 0 and 2
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi,
                                              uint32_t sel) {
  const uint32_t bits = and_or(__byte_perm(lo, hi, sel), 0x00FF00FFu,
                               0x43004300u);
  const uint32_t bias_bits = 0x43084308u;  // (136, 136) in bf16
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits),
              *reinterpret_cast<const __nv_bfloat162*>(&bias_bits));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the u = nibble + 8 bytes of a word's low and high nibbles
__device__ __forceinline__ uint32_t low_u(uint32_t w) { return w & 0x0F0F0F0Fu; }
__device__ __forceinline__ uint32_t high_u(uint32_t w) {
  return ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* p, float a, float b) {
  simt::store_out(p, a);
  simt::store_out(p + 1, b);
}
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p,
                                                          float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__half>(__half* p, float a,
                                                   float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// After a K split has written its f32 partial tile (rows m0.., cols n0..)
// to ws[blockIdx.z]: count the split in, and if it is the tile's last, add
// all splits' partials in split order, write `out` and reset the counter.
// Every thread of the block's team (`tid` < `team`) calls it; `sync` is a
// barrier over that team.
template <typename OutT, typename Sync>
__device__ __forceinline__ void finish_splits(const float* ws, OutT* out,
                                              int* counter, int* flag, int M,
                                              int N, int m0, int rows, int n0,
                                              int cols, int splits, int tid,
                                              int team, Sync sync) {
  __threadfence();  // this split's partial, before its arrival
  sync();
  if (tid == 0) {
    const int last = atomicAdd(counter, 1) == splits - 1;
    if (last) *counter = 0;  // every split has arrived
    *flag = last;
  }
  sync();
  if (!*flag) return;
  __threadfence();
  const size_t mn = (size_t)M * N;
  for (int idx = tid; idx < rows * cols; idx += team) {
    const int m = m0 + idx / cols, n = n0 + idx % cols;
    if (m >= M || n >= N) continue;
    const size_t o = (size_t)m * N + n;
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += __ldcg(ws + z * mn + o);
    simt::store_out(out + o, v);
  }
}

// --------------------------------------------------------------- stream
namespace st {

constexpr int THREADS = 128;     // four warps
constexpr int BN = 128;          // columns of a block: 16 bytes a lane
constexpr int MR = 8;            // rows of x: one n8 tile
constexpr int ROWS = 16;         // packed rows of a warp's stage (2 KiB)
constexpr int WSTAGE = ROWS * BN, WSTAGES = 4;  // a warp's ring
constexpr int SPLIT_ROWS = 64;   // K splits are whole multiples of this
constexpr int RED_STRIDE = BN + 4;  // floats of a row of the warps' sums
static_assert(4 * MR * RED_STRIDE * 4 <= 4 * WSTAGES * WSTAGE,
              "the warps' sums must fit the rings");

// Shared memory: x's rows for the split, (MR, 2 rows_per_split) bf16 at
// x_stride bytes a row (a row is 4 banks off the one above it); the scale
// rows of the split's groups (sr rows of BN f32); each warp's ring.
__host__ __device__ constexpr int x_stride(int rows_per_split) {
  return 4 * rows_per_split + 16;
}
__host__ __device__ constexpr int smem_bytes(int rows_per_split, int sr) {
  return MR * x_stride(rows_per_split) + sr * BN * 4 + 4 * WSTAGES * WSTAGE;
}

// Byte c of word w as the A register (low nibble, high nibble) in bf16:
// w4 = w >> 4 holds the high nibble of byte c at bits 8c .. 8c + 3, so one
// byte permute puts the low nibble at bits 0-3 and the high one at bits
// 16-19; one logic op keeps them, writes the exponent bytes of 128 + u and
// flips the high nibble's sign bit (u = nibble + 8); one bf16x2 subtract
// of 136 leaves the nibbles.
__device__ __forceinline__ uint32_t nibbles_of_byte(uint32_t w, uint32_t w4,
                                                    int c) {
  const uint32_t sel = c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12);
  const uint32_t bits = and_xor(__byte_perm(w, w4, sel), 0x000F000Fu,
                                0x43084300u);
  const uint32_t bias_bits = 0x43084308u;  // (136, 136) in bf16
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits),
              *reinterpret_cast<const __nv_bfloat162*>(&bias_bits));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid: x = row tiles of MR, y = column tiles of BN, z = K splits of
// rows_per_split packed rows (a multiple of SPLIT_ROWS).  sr: scale rows
// the block holds (the most groups a split can touch).  The four warps
// take the split's rows in four contiguous parts, all 128 columns, each
// through its own ring (no block barrier until the end).
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
int4_stream_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ packed,
                   const float* __restrict__ scale, OutT* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ counters, int M,
                   int N, int KH, int gh, int rows_per_split, int sr) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_flag;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int K = 2 * KH;
  const int m0 = blockIdx.x * MR, n0 = blockIdx.y * BN;
  const int i_begin = blockIdx.z * rows_per_split;
  const int i_end = min(KH, i_begin + rows_per_split);
  const int xs = x_stride(rows_per_split);
  unsigned char* x_s = smem;
  float* s_s = reinterpret_cast<float*>(smem + MR * xs);
  unsigned char* ring = smem + MR * xs + sr * BN * 4 + warp * WSTAGES * WSTAGE;

  // the block's x rows and scale rows, once
  for (int c = tid; c < MR * (rows_per_split / 4); c += THREADS) {
    const int r = c / (rows_per_split / 4), ch = c % (rows_per_split / 4);
    const int k = 2 * i_begin + 8 * ch;
    const bool ok = m0 + r < M && k < 2 * i_end;
    cp_async16(x_s + r * xs + 16 * ch, ok ? x + (size_t)(m0 + r) * K + k : x,
               ok);
  }
  const int g0 = i_begin / gh, ng = (i_end - 1) / gh - g0 + 1;
  for (int c = tid; c < ng * (BN / 4); c += THREADS) {
    const int r = c / (BN / 4), ch = c % (BN / 4);
    const bool ok = n0 + 4 * ch < N;
    cp_async16(s_s + r * BN + 4 * ch,
               ok ? scale + (size_t)(g0 + r) * N + n0 + 4 * ch : scale, ok);
  }
  cp_async_commit();

  // this warp's packed rows [w_begin, w_end).  A stage is ROWS rows of 128
  // bytes, 8 16-byte chunks each: lane chunk e is row lane / 8 + 4 e,
  // chunk lane % 8, stored at chunk (lane % 8) ^ 2 (row % 4), so a lane's
  // 16-byte reads of rows t and t + 4 (8 lanes a phase) hit distinct banks
  const int w_rows = rows_per_split / 4;
  const int w_begin = i_begin + warp * w_rows;
  const int w_end = min(i_end, w_begin + w_rows);
  const int nst = max(0, (w_end - w_begin + ROWS - 1) / ROWS);
  const int r0 = lane / 8, ch0 = lane % 8;
  const bool col_ok = n0 + 16 * ch0 < N;
  const int8_t* ld_src = packed + (size_t)(w_begin + r0) * N + n0 + 16 * ch0;
  const size_t ld_step = (size_t)ROWS * N, ld_estep = (size_t)4 * N;
  const int ld_off = r0 * BN + ((ch0 ^ (2 * r0)) << 4);
  int ld_left = w_end - w_begin - r0;
  int ld_slot = 0;
  auto load_next = [&]() {
    unsigned char* dst = ring + ld_slot * WSTAGE + ld_off;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = col_ok && 4 * e < ld_left;
      cp_async16(dst + 4 * e * BN, ok ? ld_src + e * ld_estep : packed, ok);
    }
    ld_src += ld_step;
    ld_left -= ROWS;
    ld_slot = ld_slot == WSTAGES - 1 ? 0 : ld_slot + 1;
  };
#pragma unroll
  for (int si = 0; si < WSTAGES - 1; ++si) {
    if (si < nst) load_next();
    cp_async_commit();
  }
  cp_async_wait<WSTAGES - 1>();  // x and the scales
  __syncthreads();

  float part[8][4], acc[8][4];  // a lane's 8 m16 tiles
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = acc[j][e] = 0.f;
  // the lane's x row and column of the staged rows, its scales, and the
  // rows left in the current scale group (no division in the loop)
  const unsigned char* xb = x_s + g * xs + 4 * (w_begin - i_begin) + 4 * t;
  const int row_off = t * BN + ((g ^ (2 * t)) << 4);  // 16 bytes: columns 16g ..
  const float* srow = s_s + (w_begin / gh - g0) * BN + 16 * g;
  int group_left = gh - w_begin % gh;
  int i = w_begin;

  for (int si = 0; si < nst; ++si) {
    cp_async_wait<WSTAGES - 2>();  // stage si has landed
    __syncwarp();                  // for every lane, and si - 1 is read
    if (si + WSTAGES - 1 < nst) load_next();
    cp_async_commit();
    const unsigned char* w_s = ring + (si % WSTAGES) * WSTAGE + row_off;
#pragma unroll
    for (int s = 0; s < ROWS / 8; ++s) {  // packed rows i .. i + 7
      if (i >= w_end) break;
      const uint4 v0 = *reinterpret_cast<const uint4*>(w_s + 8 * s * BN);
      const uint4 v1 = *reinterpret_cast<const uint4*>(w_s + (8 * s + 4) * BN);
      const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w};
      const uint32_t w1[4] = {v1.x, v1.y, v1.z, v1.w};
      const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(xb),
                             *reinterpret_cast<const uint32_t*>(xb + 16)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t h0 = w0[q] >> 4, h1 = w1[q] >> 4;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          // byte 2 jj of the word: the tile's row g; byte 2 jj + 1: row g + 8
          const uint32_t a[4] = {nibbles_of_byte(w0[q], h0, 2 * jj),
                                 nibbles_of_byte(w0[q], h0, 2 * jj + 1),
                                 nibbles_of_byte(w1[q], h1, 2 * jj),
                                 nibbles_of_byte(w1[q], h1, 2 * jj + 1)};
          Mma<__nv_bfloat16>::run(part[2 * q + jj], a, b);
        }
      }
      i += 8;
      xb += 32;
      group_left -= 8;
      // a group's end (or the warp's): acc += part * scale, part = 0
      if (group_left == 0 || i >= w_end) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 sc = *reinterpret_cast<const float2*>(srow + 2 * j);
          acc[j][0] += part[j][0] * sc.x;
          acc[j][1] += part[j][1] * sc.x;
          acc[j][2] += part[j][2] * sc.y;
          acc[j][3] += part[j][3] * sc.y;
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
        }
        srow += BN;
        group_left = gh;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: the warps' sums go there

  // tile j: value e is x row 2 t + e % 2, column 16 g + 2 j + e / 2; a
  // lane's 16 columns of a row are contiguous
  float* red = reinterpret_cast<float*>(smem + MR * xs + sr * BN * 4);
#pragma unroll
  for (int par = 0; par < 2; ++par)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(
          &red[(warp * MR + 2 * t + par) * RED_STRIDE + 16 * g + 4 * q]) =
          make_float4(acc[2 * q][par], acc[2 * q][2 + par],
                      acc[2 * q + 1][par], acc[2 * q + 1][2 + par]);
  __syncthreads();
  const int splits = gridDim.z;
  float* part_out = ws + (size_t)blockIdx.z * M * N;
  for (int idx = tid; idx < MR * BN; idx += THREADS) {
    const int m = idx / BN, c = idx % BN;
    if (m0 + m >= M || n0 + c >= N) continue;
    float v = red[m * RED_STRIDE + c];
#pragma unroll
    for (int w = 1; w < 4; ++w) v += red[(w * MR + m) * RED_STRIDE + c];
    const size_t o = (size_t)(m0 + m) * N + n0 + c;
    if (splits == 1)
      simt::store_out(out + o, v);
    else
      part_out[o] = v;
  }
  if (splits > 1)
    finish_splits(ws, out, counters + blockIdx.y * gridDim.x + blockIdx.x,
                  &last_flag, M, N, m0, MR, n0, BN, splits, tid, THREADS,
                  []() { __syncthreads(); });
}

template <typename OutT>
int launch(const void* x, const void* packed, const void* scale, void* out,
           void* ws, int* counters, int M, int N, int KH, int gh,
           int rows_per_split, int splits, cudaStream_t s) {
  if (rows_per_split % SPLIT_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  // the groups a split of rows_per_split rows from a multiple of it touches
  const int sr = rows_per_split % gh == 0 ? rows_per_split / gh
                                          : rows_per_split / gh + 2;
  const int smem = smem_bytes(rows_per_split, sr);
  const auto kernel = int4_stream_kernel<OutT>;
  const cudaError_t rc =
      hopper::allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((M + MR - 1) / MR, (N + BN - 1) / BN, splits);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<OutT*>(out),
      static_cast<float*>(ws), counters, M, N, KH, gh, rows_per_split, sr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace st

// ------------------------------------------------- stream, M 9-32: wgmma
namespace rs {

constexpr int THREADS = 128;  // one warpgroup
constexpr int BN = 128;       // columns of a block
constexpr int CW = 32;        // columns of a warp             // columns of a warp
constexpr int ROWS = 64;           // packed rows a stage: 8 k16 steps
constexpr int STAGES = 4;
constexpr int W_BYTES = ROWS * BN;  // the weights of a stage
constexpr int RED_STRIDE = BN + 4;

// A stage: x's rows for its 128 k as two K-major boxes of 64 k with the
// 128-byte swizzle (MR rows x 128 bytes each: the wgmma B operand, as K3's
// A); the 64 packed rows of the block's 128 columns; the scale rows
// of the groups the stage touches (sr rows of BN f32).  Stages start on
// 1024-byte boundaries.
template <int MR>
__host__ __device__ constexpr int stage_bytes(int sr) {
  return (2 * MR * 128 + W_BYTES + sr * BN * 4 + 1023) / 1024 * 1024;
}

// grid: x = row tiles of MR, y = column tiles of BN, z = K splits of
// rows_per_split packed rows (a multiple of ROWS).  Warp w takes columns
// 32 w .. + 31.  The
// weight is wgmma's A operand from registers (out^T = W^T x^T): lane (g,
// t) reads 4 bytes (columns 4g .. 4g + 3) of packed rows t and t + 4 of
// each k16 step, which give the A fragments of two m64 tiles: tile T's row
// 16 w + g is column 4g + 2T, its row 16 w + g + 8 column 4g + 2T + 1.  B
// is x^T from the stage's boxes, N = MR.
template <int MR, typename OutT>
__global__ void __launch_bounds__(THREADS, 3)
int4_stream_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                         const int8_t* __restrict__ packed,
                         const float* __restrict__ scale,
                         OutT* __restrict__ out, float* __restrict__ ws,
                         int* __restrict__ counters, int M, int N, int KH,
                         int gh, int rows_per_split, int sr) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last_flag;
  unsigned char* ring =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int sb = stage_bytes<MR>(sr);
  constexpr int XB = 2 * MR * 128;  // x bytes of a stage
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int K = 2 * KH;
  const int m0 = blockIdx.x * MR, n0 = blockIdx.y * BN;
  const int i_begin = blockIdx.z * rows_per_split;
  const int i_end = min(KH, i_begin + rows_per_split);
  const int nst = (i_end - i_begin + ROWS - 1) / ROWS;

  // stage si into ring slot si % STAGES: x chunk c (8 k) of row r at box
  // c / 8, chunk (c % 8) ^ (r % 8); packed chunk c of row r at chunk c ^ 2
  // (r % 4) of its 128-byte row (a lane's 4-byte reads of rows t, t + 4
  // then hit 32 different banks)
  auto load_stage = [&](int si) {
    unsigned char* st_x = ring + (si % STAGES) * sb;
    unsigned char* st_w = st_x + XB;
    float* st_s = reinterpret_cast<float*>(st_w + W_BYTES);
    const int i0 = i_begin + si * ROWS;
    for (int c = tid; c < MR * 16; c += THREADS) {
      const int r = c / 16, ch = c % 16, k = 2 * i0 + 8 * ch;
      const bool ok = m0 + r < M && k < 2 * i_end;
      cp_async16(st_x + (ch / 8) * (MR * 128) + r * 128 +
                     (((ch % 8) ^ (r % 8)) << 4),
                 ok ? x + (size_t)(m0 + r) * K + k : x, ok);
    }
#pragma unroll
    for (int e = 0; e < W_BYTES / 16 / THREADS; ++e) {
      const int c = tid + THREADS * e;
      const int r = c / 8, ch = c % 8;
      const int col = n0 + 16 * ch;
      const bool ok = i0 + r < i_end && col < N;
      cp_async16(st_w + r * BN + ((ch ^ (2 * (r % 4))) << 4),
                 ok ? packed + (size_t)(i0 + r) * N + col : packed, ok);
    }
    const int g0 = i0 / gh, ng = (min(i0 + ROWS, i_end) - 1) / gh - g0 + 1;
    for (int c = tid; c < ng * (BN / 4); c += THREADS) {
      const int r = c / (BN / 4), ch = c % (BN / 4);
      const bool ok = n0 + 4 * ch < N;
      cp_async16(st_s + r * BN + 4 * ch,
                 ok ? scale + (size_t)(g0 + r) * N + n0 + 4 * ch : scale, ok);
    }
  };
#pragma unroll
  for (int si = 0; si < STAGES - 1; ++si) {
    if (si < nst) load_stage(si);
    cp_async_commit();
  }

  constexpr int NR = MR / 2;  // accumulator registers of one m64 tile
  float P[2][NR], acc[2][NR];
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int e = 0; e < NR; ++e) P[T][e] = acc[T][e] = 0.f;
  // the A registers of the last ABUF steps: up to ABUF - 1 steps' products
  // stay in flight while the next step's weights are unpacked
  constexpr int ABUF = 4;
  uint32_t a[ABUF][2][4];
  const int col = warp * CW + 4 * g;  // the lane's first column
  const int lane_w = t * BN + (((col / 16) ^ (2 * t)) << 4) +
                     col % 16;
  const int lane_s = col;
  int group_left = gh - i_begin % gh;
  int scale_d = 0;  // 0 on a group's first step: P starts afresh
  int i = i_begin;

  for (int si = 0; si < nst; ++si) {
    cp_async_wait<STAGES - 2>();  // stage si has landed (this thread's part)
    hopper::fence_proxy_async();  // its x is read by wgmma
    hopper::wgmma_wait<0>();      // stage si - 1 is no longer read
    __syncthreads();
    if (si + STAGES - 1 < nst) load_stage(si + STAGES - 1);
    cp_async_commit();
    const unsigned char* st_x = ring + (si % STAGES) * sb;
    const unsigned char* w_s = st_x + XB + lane_w;
    const float* s_s = reinterpret_cast<const float*>(st_x + XB + W_BYTES);
    const int gs = (i_begin + si * ROWS) / gh;  // the stage's first group
#pragma unroll
    for (int s = 0; s < ROWS / 8; ++s) {  // packed rows i .. i + 7
      if (i >= i_end) break;
      const uint32_t w0 =
          *reinterpret_cast<const uint32_t*>(w_s + 8 * s * BN);
      const uint32_t w1 =
          *reinterpret_cast<const uint32_t*>(w_s + (8 * s + 4) * BN);
      const uint32_t h0 = w0 >> 4, h1 = w1 >> 4;
      uint32_t(&ab)[2][4] = a[s % ABUF];
#pragma unroll
      for (int T = 0; T < 2; ++T) {
        ab[T][0] = st::nibbles_of_byte(w0, h0, 2 * T);
        ab[T][1] = st::nibbles_of_byte(w0, h0, 2 * T + 1);
        ab[T][2] = st::nibbles_of_byte(w1, h1, 2 * T);
        ab[T][3] = st::nibbles_of_byte(w1, h1, 2 * T + 1);
      }
      const uint64_t desc = hopper::desc_k_major_sw128(
          st_x + (s / 4) * (MR * 128) + (s % 4) * 32);
      hopper::wgmma_fence();
      hopper::WgmmaN<__nv_bfloat16, MR>::template rs<0>(P[0], ab[0], desc,
                                                       scale_d);
      hopper::WgmmaN<__nv_bfloat16, MR>::template rs<0>(P[1], ab[1], desc,
                                                       scale_d);
      hopper::wgmma_commit();
      scale_d = 1;
      group_left -= 8;
      if (group_left == 0 || i + 8 >= i_end) {  // a group's end: acc += P s
        hopper::wgmma_wait<0>();
        hopper::fence_regs(P[0]);
        hopper::fence_regs(P[1]);
        const float4 sc = *reinterpret_cast<const float4*>(
            s_s + (i / gh - gs) * BN + lane_s);
        const float s_of[2][2] = {{sc.x, sc.y}, {sc.z, sc.w}};
#pragma unroll
        for (int T = 0; T < 2; ++T)
#pragma unroll
          for (int e = 0; e < NR; ++e)
            acc[T][e] += P[T][e] * s_of[T][(e % 4) / 2];
        group_left = gh;
        scale_d = 0;
      } else {  // step s - 3's products are done: its A is free
        hopper::wgmma_wait<ABUF - 1>();
      }
      i += 8;
    }
  }
  hopper::wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the sums go there

  // acc[T][4 j + e]: x row 8 j + 2 t + e % 2, column 32 warp + 4 g + 2 T +
  // (e % 4) / 2 of the block
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      const int j = e / 4, q = e % 4;
      red[(8 * j + 2 * t + q % 2) * RED_STRIDE + lane_s + 2 * T + q / 2] =
          acc[T][e];
    }
  __syncthreads();
  const int splits = gridDim.z;
  float* part_out = ws + (size_t)blockIdx.z * M * N;
  for (int idx = tid; idx < MR * BN; idx += THREADS) {
    const int m = idx / BN, c = idx % BN;
    if (m0 + m >= M || n0 + c >= N) continue;
    const float v = red[m * RED_STRIDE + c];
    const size_t o = (size_t)(m0 + m) * N + n0 + c;
    if (splits == 1)
      simt::store_out(out + o, v);
    else
      part_out[o] = v;
  }
  if (splits > 1)
    finish_splits(ws, out, counters + blockIdx.y * gridDim.x + blockIdx.x,
                  &last_flag, M, N, m0, MR, n0, BN, splits, tid, THREADS,
                  []() { __syncthreads(); });
}

template <int MR, typename OutT>
int launch(const void* x, const void* packed, const void* scale, void* out,
           void* ws, int* counters, int M, int N, int KH, int gh,
           int rows_per_split, int splits, cudaStream_t s) {
  if (rows_per_split % ROWS) return static_cast<int>(cudaErrorInvalidValue);
  // the most groups a stage (ROWS rows from a multiple of ROWS) touches
  const int sr = ROWS % gh == 0 ? ROWS / gh : gh % ROWS == 0 ? 1
                                                              : ROWS / gh + 2;
  const int smem = STAGES * stage_bytes<MR>(sr) + 1024;
  static_assert(MR * RED_STRIDE * 4 <= STAGES * W_BYTES,
                "the sums must fit the ring");
  const auto kernel = int4_stream_wgmma_kernel<MR, OutT>;
  const cudaError_t rc =
      hopper::allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((M + MR - 1) / MR, (N + BN - 1) / BN, splits);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<OutT*>(out),
      static_cast<float*>(ws), counters, M, N, KH, gh, rows_per_split, sr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rs

// ---------------------------------------------------------------- wgmma
namespace wq {

constexpr int BM = 128, BN = 128;
constexpr int BKP = 32;                    // packed rows a step (K 64)
constexpr int STAGES = 6, BBUFS = 4;
constexpr int THREADS = 512;  // producer, transform and 2 consumer groups
constexpr int X_BYTES = BM * 2 * BKP * 2;  // x box 128 x 64 bf16: 16 KiB
constexpr int P_BYTES = BKP * BN;          // packed tile: 4 KiB
constexpr int S_OFF = X_BYTES + P_BYTES;   // the step's scale row (BN f32)
constexpr int STAGE_BYTES = 21504;         // the above, to 1024 bytes
constexpr int B_BOX_BYTES = 2 * BKP * 64 * 2;  // 64 k x 64 n bf16: 8 KiB
constexpr int B_BYTES = 2 * B_BOX_BYTES;   // 64 k x 128 n
static_assert(S_OFF + BN * 4 <= STAGE_BYTES && STAGE_BYTES % 1024 == 0, "");
// the ring, the B buffers, 1024 bytes to align them, and the barriers:
// full / empty a stage, ready / free a B buffer
constexpr int SMEM = STAGES * STAGE_BYTES + BBUFS * B_BYTES + 1024 +
                     (2 * STAGES + 2 * BBUFS) * 8 + 16;

// The ring's waits: try_wait until the phase completes, as CUTLASS's
// barrier waits do, with no hang trap.  With hopper::mbar_wait's timed
// trap in its loops this kernel ran slower at M = 512 (PERF.md, K5
// findings); its barriers' counts do not depend on the data.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  while (!hopper::mbar_try_wait(bar, parity)) {
  }
}

// grid: x = column tiles, y = row tiles, z = K splits of steps_split
// steps.  KH % BKP == 0 and gh % BKP == 0: one scale group a step at most.
template <typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap tma_x,
                  const __grid_constant__ CUtensorMap tma_p,
                  const float* __restrict__ scale, OutT* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int M,
                  int N, int KH, int gh, int steps_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bbuf = ring + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(bbuf + BBUFS * B_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* ready = empty + STAGES;
  uint64_t* bfree = ready + BBUFS;
  int* last_flag = reinterpret_cast<int*>(bfree + BBUFS);

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int steps = KH / BKP;
  const int st0 = blockIdx.z * steps_split;
  const int nk = max(0, min(steps, st0 + steps_split) - st0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      // the transform's 4 warps read the packed tile, the consumers' 8
      // warps x
      hopper::mbar_init(&empty[s], 12);
    }
    for (int b = 0; b < BBUFS; ++b) {
      hopper::mbar_init(&ready[b], 4);  // the transform's warps
      hopper::mbar_init(&bfree[b], 8);  // the consumers' warps
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tma_x);
      hopper::tma_prefetch(&tma_p);
      const uint32_t s_bytes = min(BN, N - n0) * 4;
      const int r0 = st0 * BKP;  // first packed row of the split
      const float* srow = scale + (size_t)(r0 / gh) * N + n0;
      int group_left = gh - r0 % gh;
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) wait(&empty[s], (i / STAGES - 1) & 1);
        unsigned char* stg = ring + s * STAGE_BYTES;
        const int r = r0 + i * BKP;  // first packed row of the step
        hopper::mbar_arrive_expect_tx(&full[s], X_BYTES + P_BYTES + s_bytes);
        hopper::tma_load_2d(stg, &tma_x, &full[s], 2 * r, m0);
        hopper::tma_load_2d(stg + X_BYTES, &tma_p, &full[s], n0, r);
        hopper::bulk_load(stg + S_OFF, srow, s_bytes, &full[s]);
        group_left -= BKP;
        if (group_left == 0) {
          group_left = gh;
          srow += N;
        }
      }
    }
    return;
  }

  if (threadIdx.x < 256) {
    // ----------------------------------------------------- transform
    // The packed tile of step i -> the bf16 q of B buffer i % BBUFS,
    // MN-major with the 128-byte swizzle.  Thread tt takes 16 bytes
    // (columns c .. c + 15) of packed rows r and r + 16, i.e. 16 values
    // each of k rows 2r, 2r + 32 (low nibbles) and 2r + 1, 2r + 33 (high
    // nibbles).  Threads of the second 64-column box store their two
    // chunks in the other order, so the 8 stores of a phase hit 8
    // different bank groups.
    hopper::setmaxnreg_dec<96>();
    const int tt = threadIdx.x - 128;
    const int dq_r = tt / 8, dq_c = (tt % 8) * 16, dq_box = dq_c / 64;
    int dq_dst[2][2];  // [k row 2r + p][h]: where columns dq_c + 8 hh go
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        dq_dst[p][h] =
            hopper::tile_offset<64>(2 * dq_r + p, dq_c + 8 * (h ^ dq_box));
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES, bi = i % BBUFS;
      wait(&full[s], (i / STAGES) & 1);
      if (i >= BBUFS) wait(&bfree[bi], (i / BBUFS - 1) & 1);
      const unsigned char* pk = ring + s * STAGE_BYTES + X_BYTES;
      unsigned char* bb = bbuf + bi * B_BYTES;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // packed rows r, r + 16
        const uint4 w = *reinterpret_cast<const uint4*>(
            pk + (dq_r + 16 * half) * BN + dq_c);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int p = 0; p < 2; ++p) {  // k row 2r + p (+ 32)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int hh = h ^ dq_box;  // columns dq_c + 8 hh .. + 7
            uint32_t v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t wd = words[2 * hh + e / 2];
              const uint32_t u = p == 0 ? low_u(wd) : high_u(wd);
              const uint32_t c = 2 * (e % 2);
              v[e] = bf16_pair(u, u,
                               c | (c << 4) | ((c + 1) << 8) | ((c + 1) << 12));
            }
            // k rows 2r + 32 are 32 rows (4 swizzle atoms) further on
            *reinterpret_cast<uint4*>(bb + dq_dst[p][h] + half * 32 * 128) =
                make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
      }
      hopper::fence_proxy_async();  // the consumers' wgmma reads B
      __syncwarp();
      if (lane == 0) {
        hopper::mbar_arrive(&ready[bi]);
        hopper::mbar_arrive(&empty[s]);  // the packed tile is read
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  hopper::setmaxnreg_inc<184>();
  const int ct = threadIdx.x - 256;  // 0 .. 255
  const int cw = ct / 128;           // rows 64 cw .. 64 cw + 63
  const int warp = (ct / 32) % 4;

  float P[64], acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) P[e] = acc[e] = 0.f;

  int released = 0;  // steps whose stage and B buffer went back
  int group_left = gh - (st0 * BKP) % gh;  // packed rows left in the group
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES, bi = i % BBUFS;
    const int fresh = i == 0 || group_left == gh;  // a group's first step
    wait(&full[s], (i / STAGES) & 1);  // x
    wait(&ready[bi], (i / BBUFS) & 1);  // B
    const unsigned char* xa = ring + s * STAGE_BYTES + cw * (64 * 128);
    const unsigned char* bb = bbuf + bi * B_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaN<__nv_bfloat16, 128>::ss<1>(
          P, hopper::desc_k_major_sw128(xa + kk * 32),
          hopper::desc_mn_major_sw128(bb + kk * 16 * 128, B_BOX_BYTES),
          fresh && kk == 0 ? 0 : 1);
    hopper::wgmma_commit();
    int done;  // steps whose products have completed
    group_left -= BKP;
    if (group_left == 0 || i == nk - 1) {  // the group's end
      group_left = group_left == 0 ? gh : group_left;
      hopper::wgmma_wait<0>();
      hopper::fence_regs(P);
      const float* sc = reinterpret_cast<const float*>(
          ring + s * STAGE_BYTES + S_OFF);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 v =
            *reinterpret_cast<const float2*>(sc + 8 * j + 2 * (lane % 4));
        acc[4 * j] += P[4 * j] * v.x;
        acc[4 * j + 1] += P[4 * j + 1] * v.y;
        acc[4 * j + 2] += P[4 * j + 2] * v.x;
        acc[4 * j + 3] += P[4 * j + 3] * v.y;
      }
      done = i + 1;
    } else {  // keep step i's products in flight
      hopper::wgmma_wait<1>();
      done = i;
    }
    __syncwarp();
    for (; released < done; ++released)
      if (lane == 0) {
        hopper::mbar_arrive(&empty[released % STAGES]);
        hopper::mbar_arrive(&bfree[released % BBUFS]);
      }
  }

  // thread: rows row, row + 8; columns n0 + 8 j + 2 (lane % 4) + {0, 1}
  const int row = m0 + cw * 64 + warp * 16 + lane / 4;
  const int splits = gridDim.z;
  float* part_out = ws + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = n0 + 8 * j + 2 * (lane % 4);
    if (c >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h;
      if (m >= M) continue;
      const size_t o = (size_t)m * N + c;
      if (splits == 1)
        store_pair(out + o, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      else
        store_pair(part_out + o, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  if (splits > 1)
    finish_splits(ws, out, counters + blockIdx.y * gridDim.x + blockIdx.x,
                  last_flag, M, N, m0, BM, n0, BN, splits, ct, 256,
                  []() { hopper::named_barrier<1, 256>(); });
}

template <typename OutT>
int launch(const void* x, const void* packed, const void* scale, void* out,
           void* ws, int* counters, int M, int N, int KH, int gh,
           int rows_per_split, int splits, cudaStream_t s) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return hopper::kNoEncoder;
  CUtensorMap mx, mp;
  {  // x (M, K) bf16 as 128 x 64 boxes, 128-byte swizzle (K3's A)
    const cuuint64_t dims[2] = {(cuuint64_t)2 * KH, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)4 * KH};
    const cuuint32_t box[2] = {64, BM};
    const cuuint32_t elem[2] = {1, 1};
    if (fn(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
           dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
           CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return hopper::kEncodeFailed;
  }
  {  // packed (KH, N) bytes as 32 x 128 boxes, unswizzled
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)KH};
    const cuuint64_t strides[1] = {(cuuint64_t)N};
    const cuuint32_t box[2] = {BN, BKP};
    const cuuint32_t elem[2] = {1, 1};
    if (fn(&mp, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(packed),
           dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
           CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return hopper::kEncodeFailed;
  }
  const auto kernel = int4_wgmma_kernel<OutT>;
  const cudaError_t rc =
      hopper::allow_smem(reinterpret_cast<const void*>(kernel), SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, SMEM, s>>>(mx, mp, static_cast<const float*>(scale),
                                     static_cast<OutT*>(out),
                                     static_cast<float*>(ws), counters, M, N,
                                     KH, gh, rows_per_split / BKP);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wq

// Path codes shared with kernels/int4_gemm.py: 0 stream, 1 wgmma.
template <typename OutT>
int launch_hopper(int path, const void* x, const void* packed,
                  const void* scale, void* out, void* ws, int* counters,
                  int M, int N, int KH, int gh, int rows_per_split,
                  int splits, cudaStream_t s) {
  if (path == 1)
    return wq::launch<OutT>(x, packed, scale, out, ws, counters, M, N, KH, gh,
                            rows_per_split, splits, s);
  if (M <= 8)
    return st::launch<OutT>(x, packed, scale, out, ws, counters, M, N, KH, gh,
                            rows_per_split, splits, s);
  if (M <= 16)
    return rs::launch<16, OutT>(x, packed, scale, out, ws, counters, M, N, KH,
                                gh, rows_per_split, splits, s);
  return rs::launch<32, OutT>(x, packed, scale, out, ws, counters, M, N, KH,
                              gh, rows_per_split, splits, s);
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

// The stream (path 0) and wgmma (path 1) paths.  Both: N % 16 == 0, K %
// 8 == 0, x, packed and scale 16-byte aligned.  Stream: gh % 8 == 0,
// rows_per_split a multiple of 64.  wgmma: gh % 32 == 0, rows_per_split a
// multiple of 32.  With splits > 1, ws is (splits, M, N) f32 scratch and
// counters a zeroed int32 array with one entry per output tile (stream:
// ceil(M / 8 or 32) x ceil(N / 128); wgmma: ceil(M / 128) x ceil(N /
// 128)), left zeroed.  Returns a cudaError_t, or -1 / -2 when a TMA
// descriptor cannot be encoded.
int int4_gemm_hopper(int path, const void* x, const void* packed,
                     const void* scale, void* out, void* ws, void* counters,
                     int out_dtype, int M, int N, int KH, int gh,
                     int rows_per_split, int splits, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* cnt = static_cast<int*>(counters);
  const bool ok =
      N % 16 == 0 && KH % 4 == 0 && KH % gh == 0 && rows_per_split > 0 &&
      splits >= 1 &&
      (splits == 1 || (ws != nullptr && cnt != nullptr)) &&
      (path == 0 ? gh % 8 == 0
       : path == 1 ? gh % wq::BKP == 0 && rows_per_split % wq::BKP == 0
                   : false);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  switch (out_dtype) {
    case 0:
      return launch_hopper<float>(path, x, packed, scale, out, ws, cnt, M, N,
                                  KH, gh, rows_per_split, splits, s);
    case 1:
      return launch_hopper<__nv_bfloat16>(path, x, packed, scale, out, ws, cnt,
                                          M, N, KH, gh, rows_per_split, splits,
                                          s);
    case 2:
      return launch_hopper<__half>(path, x, packed, scale, out, ws, cnt, M, N,
                                   KH, gh, rows_per_split, splits, s);
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
