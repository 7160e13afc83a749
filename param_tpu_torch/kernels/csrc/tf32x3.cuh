// f32-accurate matrix products on the tensor cores, for the f32 paths of
// K6 and K7 (flash_fwd.cu, flash_bwd.cu): the split-TF32 ("3xTF32")
// arithmetic of CUTLASS's OpMultiplyAddFastF32.
//
// Each f32 operand x is split in registers into hi = tf32(x) and
// lo = tf32(x - hi) (round to nearest, ties away from zero), and
// a product A B is taken as A_lo B_hi + A_hi B_lo + A_hi B_hi, three
// mma.sync m16n8k8 .tf32 products accumulated in f32.  Only A_lo B_lo, about
// 2^-22 of |A| |B|, is dropped, so the result is as accurate as an f32
// product; a single TF32 product keeps about 3 decimal digits.
//
// mma.sync m16n8k8 .tf32 fragments (g = lane / 4, t = lane % 4):
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Every B fragment is two 32-bit shared-memory loads, whether the operand
// is stored with K contiguous (K in S = Q K^T) or with N contiguous (V in
// P V), so no operand is ever transposed; wgmma .tf32, by contrast, takes
// K-major operands only.
//
// The accumulator's columns 2t, 2t + 1 are not the A fragment's t, t + 4.
// So a product whose result feeds the next one as A (S -> P for P V, dS
// for dS K) reads its B rows in the order pi(g) = g / 2 + 4 (g % 2): then
// c0 / c1 hold columns t / t + 4 of the n8 tile and {c0, c2, c1, c3} is the
// A fragment of the next product with no data movement.
//
// Shared-memory tiles hold f32 rows of D values (D a multiple of 32) with
// their 16-byte chunks XOR-swizzled: chunk j of row r is stored at chunk
// j ^ key(r), key(r) = 2 (r % 4) + (r / 4) % 2, a permutation of 0..7 over
// any 8 consecutive rows.  A lane's reads of 8 rows x 4 columns (row
// fragments: A, and B stored with K contiguous) and of 4 rows x 8 columns
// (column fragments: B stored with N contiguous) then fall in 32 distinct
// banks, and 16-byte copies into the tile stay whole.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace tf32x3 {

// x rounded to TF32 to nearest, ties away from zero: what cvt.rna.tf32.f32
// returns, bit for bit, for every finite x (half a TF32 ulp added to the
// magnitude bits, the 13 bits below the TF32 mantissa cleared), in two
// integer operations; with cvt, which goes through the conversion unit, K6
// and K7 ran 1.12-1.41x slower on the H100 (PERF.md)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (an error of about 2^-22 |x|), both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B with A already split and B an f32 fragment: the two small cross
// terms, then hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const float (&b)[2]) {
  uint32_t bh[2], bl[2];
  split(b, bh, bl);
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// The A fragment {c0, c2, c1, c3} of an accumulator tile whose B rows were
// read in the order pi (see above)
__device__ __forceinline__ void acc_to_a(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  split(a, hi, lo);
}

__device__ __forceinline__ int swz_key(int r) {
  return ((r & 3) << 1) | ((r >> 2) & 1);
}

// pi(g): the B row a lane reads for a product whose result is the next
// product's A
__device__ __forceinline__ int pi(int g) { return (g >> 1) | ((g & 1) << 2); }

// Offset within a row of column c + (the lane's part x): c a multiple of
// 4 known at compile time, x = (the chunk bits to XOR) << 2 | (the column
// within the chunk), x < 32.
__device__ __forceinline__ int col(int c, int x) {
  return (c & ~31) + ((c & 31) ^ x);
}

// A lane's x for row fragments (rows congruent to r mod 8, columns t and
// t + 4 of an 8-column step) and for column fragments (row congruent to
// r mod 8, columns g of an 8-column step).
__device__ __forceinline__ int row_x(int r, int t) {
  return (swz_key(r) << 2) | t;
}
__device__ __forceinline__ int col_x(int r, int g) {
  return (((g >> 2) ^ swz_key(r)) << 2) | (g & 3);
}

// Offset of element (r, c) in a tile of D-float rows
template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * D + ((((c >> 2) ^ swz_key(r)) << 2) | (c & 3));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// Copy rows [r0, r0 + rows) of a (n_rows, D) f32 slice with row stride ss
// into a swizzled tile, zero-filling rows at or past n_rows: 16-byte
// cp.async copies when `vec16` (base and strides 16-byte aligned), else
// 4-byte ones.  All `nthreads` threads of the block take part.
template <int D>
__device__ __forceinline__ void load_f32_tile(float* dst, const float* src,
                                          long long ss, int r0, int rows,
                                          int n_rows, bool vec16, int tid,
                                          int nthreads) {
  constexpr int CH = D / 4;
  for (int i = tid; i < rows * CH; i += nthreads) {
    const int r = i / CH, ch = i % CH;
    const bool ok = r0 + r < n_rows;
    const float* s = ok ? src + (long long)(r0 + r) * ss + 4 * ch : src;
    float* d = dst + r * D + ((ch ^ swz_key(r)) << 2);
    if (vec16) {
      cp_async16(d, s, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(d + e, s + e, ok);
    }
  }
}

// Copy src[i] for i < valid, zeros for valid <= i < n, into dst (4-byte
// copies by all `nthreads` threads of the block)
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n,
                                         int valid, int tid, int nthreads) {
  for (int i = tid; i < n; i += nthreads)
    cp_async4(dst + i, i < valid ? src + i : src, i < valid);
}

// The 4 warps of a block: R row groups of 16 rows (warp w in row group
// w % R) times S = 4 / R splits of the walk (warp w in split w / R).  The R
// warps of a split share its tiles; with S > 1 the splits' partial results
// are added at the end in a fixed order (no atomics).
constexpr int kWarps = 4;

// bar.sync for the 32 R threads of split s (named barrier 1 + s; all of
// the block's threads: barrier 0)
__device__ __forceinline__ void split_sync(int s, int R) {
  if (R == kWarps)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + s), "r"(32 * R) : "memory");
}

// R for a walk over `rows` rows of `pairs` (batch, head) pairs: 4 (64-row
// blocks, one walk) when that still gives every SM a block, else the
// largest R that does, or 1 (16-row blocks, the walk split 4 ways)
inline int row_groups(int rows, long long pairs) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int r = kWarps;
  while (r > 1 && (long long)((rows + 16 * r - 1) / (16 * r)) * pairs < sms)
    r /= 2;
  return r;
}

// Whether 16-byte copies can read a (B, H, S, D) f32 view: its base and its
// batch, head and sequence strides all 16-byte aligned
__host__ __forceinline__ bool aligned16(const void* p, long long sb,
                                        long long sh, long long ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 &&
         sh % 4 == 0 && ss % 4 == 0;
}

}  // namespace tf32x3
