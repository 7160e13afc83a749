// The DLRM dot interaction, forward and backward, one kernel each.
//
// A sample's features are the m = T + 1 rows of z = [bot_out; pooled]
// (bot_out (B, D), pooled (B, T, D)).  The forward writes
//
//   out[b] = [bot_out[b], z_i . z_j for the P = m (m - 1) / 2 pairs i > j]
//
// with the pairs in row-major order of the strict lower triangle (pair p =
// i (i - 1) / 2 + j), as jnp.tril_indices(m, k=-1) orders them.  The
// backward takes the output's gradient g (B, D + P) and, with G the
// symmetric (m, m) matrix of the pairs' gradients (G[i][j] = G[j][i] = g's
// pair (i, j), zero diagonal), writes
//
//   g_bot[b] = g[b, :D] + (G z)[0],   g_pooled[b, t] = (G z)[t + 1]
//
// contiguous, (B, D) and (B, T, D).  Sums in f32, rounded to the inputs'
// type (f32, bf16 or f16) once, as the reference's einsum with
// preferred_element_type=f32 then astype.
//
// Replaces no TPU kernel: the reference (param_tpu/models/dlrm.py:105-116)
// leaves the interaction to XLA (an einsum, a gather of the triangle, a
// concatenation).  Built from PyTorch's ops on the card it materialised z
// and the (B, m, m) products, and its backward sorted every index of the
// triangle's gather to scatter into pairs that are all distinct: 5.2 ms a
// step at B 32768, m 27, D 128, against a byte bound of 0.44 ms.
//
// What bounds it on an H100: bytes.  The forward reads z once and writes
// the output once; the backward reads g and z once and writes z's gradient
// once.  Its 3 (forward) and 6 (backward) FLOP a byte of f32 are below the
// card's f32 ridge, so the products have to hide under the loads.
//
// The order of every sum is the one a batched f32 GEMM of the same
// products takes (z z^T forward; G_low z and G_low^T z backward, then
// added): one FMA chain over the contracted index in ascending order.  So
// where cuBLAS sums that way (its kernels for the terabyte widths, m 27, D
// 128; not the one it takes for m 9, D 64) the kernels give the bits the
// PyTorch composition (torch.bmm) gives, which a plain f32 reference of the
// model computes too.  That matters beyond taste: a hot row's table
// gradient sums thousands of samples' rows, and rounding differences that
// are harmless in each sample come out there at up to 4e-4 of the
// gradient's norm (an f32 reference reads that far from its f64 self).
//
// Forward.  One warp a sample: z goes to shared memory (16-byte copies,
// cp.async where rows are aligned f32), rows padded to whole groups of
// eight 16-byte chunks and each chunk XOR-swizzled by its row block, so
// lanes reading rows of different blocks at the same columns hit other
// banks.  Lane t takes 4 x 4 blocks (ib, jb), jb <= ib, of the Gram
// matrix: 16 accumulators, each a chain over k = 0 .. D - 1, fed by 16-byte
// reads of its 4 + 4 rows (ib, jb < 8: the lanes' reads at one chunk are
// broadcasts or other banks).  The lower triangle's dots go to a staging
// row in shared memory, then the warp writes the output row in order.
// Rows wider than 128 go through shared memory 128 columns at a time, each
// chain carried from one chunk to the next in the staging row; the block
// opts into as much shared memory as its two samples need (up to 227 KiB:
// m up to ~145 at D >= 128).
//
// Backward.  A group of `lanes` lanes (a power of two, 8 to 32) takes a
// sample and 128 of its columns (a block a 128 columns); lane g of the
// group holds 4 columns of all m rows of z in registers (M, the rows they
// hold, a template parameter: 8, 16 or 32, at least m, so every row index
// is a compile-time constant).  The group puts the sample's P pair
// gradients into shared memory as the full symmetric matrix G (the
// diagonal and padding columns zero); each lane forms (G z)[r] over its
// columns as two chains, over j < r and over j > r, reading row r of G as
// broadcast 16-byte words, and adds them; one 16-byte store a lane a row.
// No atomics, no sort: every call gives the same bits.
//
// Past those limits (the backward past 32 rows, the forward past its
// shared memory) the tiled pair holds any m and D: a block of 256 threads a
// work item, z staged through shared memory in tiles of 32 rows, every
// element read one at a time (any alignment).  The tiled forward takes one
// 32 x 32 tile (ti, tj), tj <= ti, of a sample's Gram matrix, 32 columns
// staged at a time (once where ti = tj), a thread 2 x 2 dots; the tiled
// backward takes 32 rows r and 64 columns of a sample's G z, the rows j of
// z and the columns of G staged 32 at a time, a thread 2 rows x 4 columns.
// Each sum is the same chain as the other pair's (the forward's over k
// ascending, the backward's two over j < r and j > r ascending, then
// added), so at shapes both take the two pairs give the same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kFwdWarps = 2;    // samples a block of the forward
constexpr int kBwdGroups = 4;   // samples a block of the backward
constexpr int kBwdCols = 128;   // columns a block of the backward
constexpr int kFwdCols = 128;   // columns of z a forward chunk at most
constexpr int kMaxSmem = 232448;  // shared memory a block may opt into

__host__ __device__ constexpr int pairs_of(int m) { return m * (m - 1) / 2; }

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ __forceinline__ static float get(const float* p) { return *p; }
  __device__ __forceinline__ static void put(float* p, float v) { *p = v; }
  // four elements at a 16-byte aligned address
  __device__ __forceinline__ static void get4(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static void put4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  // four elements at an 8-byte aligned address
  __device__ __forceinline__ static void get4(const __nv_bfloat16* p,
                                              float* v) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(x.x << 16);
    v[1] = __uint_as_float(x.x & 0xffff0000u);
    v[2] = __uint_as_float(x.y << 16);
    v[3] = __uint_as_float(x.y & 0xffff0000u);
  }
  __device__ __forceinline__ static void put4(__nv_bfloat16* p,
                                              const float* v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 x;
    x.x = *reinterpret_cast<const uint32_t*>(&lo);
    x.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = x;
  }
};

template <>
struct Elem<__half> {
  __device__ __forceinline__ static float get(const __half* p) {
    return __half2float(*p);
  }
  __device__ __forceinline__ static void put(__half* p, float v) {
    *p = __float2half_rn(v);
  }
  // four elements at an 8-byte aligned address
  __device__ __forceinline__ static void get4(const __half* p, float* v) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&x.x));
    const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&x.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
  __device__ __forceinline__ static void put4(__half* p, const float* v) {
    const __half2 lo = __floats2half2_rn(v[0], v[1]);
    const __half2 hi = __floats2half2_rn(v[2], v[3]);
    uint2 x;
    x.x = *reinterpret_cast<const uint32_t*>(&lo);
    x.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = x;
  }
};

// The four elements from p on (`left` of them in the row), zero past the
// row's end; one vector access where `vec`.
template <typename T>
__device__ __forceinline__ void load4(const T* p, int left, int vec,
                                      float* v) {
  if (vec) {
    Elem<T>::get4(p, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < left ? Elem<T>::get(p + e) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, int left, int vec,
                                       const float* v) {
  if (vec) {
    Elem<T>::put4(p, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < left) Elem<T>::put(p + e, v[e]);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// ----------------------------------------------------------------- forward

// Where 16-byte chunk c of row r of z lies in a warp's shared copy (rows
// `stride` floats apart, stride a multiple of 32).
__device__ __forceinline__ int chunk_at(int r, int c, int stride) {
  return r * stride + 4 * (c ^ ((r >> 2) & 7));
}

// Columns [c0, c0 + w) of z of sample b into zs: rows [0, m) from bot and
// pooled, rows [m, rows) zero; the `used` chunks a row that hold columns.
template <typename T>
__device__ __forceinline__ void stage_z(float* zs, const T* bot,
                                        const T* pooled, int b, int m,
                                        int rows, int dim, int c0, int w,
                                        int stride, int lane, int vec) {
  const int used = (w + 3) >> 2;
  const T* row0 = bot + static_cast<int64_t>(b) * dim + c0;
  const T* rest = pooled + static_cast<int64_t>(b) * (m - 1) * dim + c0;
  if (std::is_same<T, float>::value && vec) {
    for (int r = 0; r < m; ++r) {
      const T* src = r == 0 ? row0 : rest + static_cast<int64_t>(r - 1) * dim;
      for (int c = lane; c < used; c += 32) {
        cp_async16(zs + chunk_at(r, c, stride),
                   reinterpret_cast<const float*>(src) + 4 * c);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
#pragma unroll 4
    for (int r = 0; r < m; ++r) {
      const T* src = r == 0 ? row0 : rest + static_cast<int64_t>(r - 1) * dim;
      for (int c = lane; c < used; c += 32) {
        float v[4];
        load4<T>(src + 4 * c, w - 4 * c, vec, v);
        Elem<float>::put4(zs + chunk_at(r, c, stride), v);
      }
    }
  }
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = m; r < rows; ++r) {
    for (int c = lane; c < used; c += 32) {
      Elem<float>::put4(zs + chunk_at(r, c, stride), zero);
    }
  }
  __syncwarp();
}

// Block (ib, jb) of the Gram matrix: dot[a][q] of rows 4 ib + a and 4 jb +
// q, each one FMA chain over the staged columns ascending, continued from
// the value it holds.
__device__ __forceinline__ void gram_block(float (&dot)[4][4], const float* zs,
                                           int ib, int jb, int used,
                                           int stride) {
  for (int c = 0; c < used; ++c) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x[a] = *reinterpret_cast<const float4*>(
          zs + chunk_at(4 * ib + a, c, stride));
      y[a] = *reinterpret_cast<const float4*>(
          zs + chunk_at(4 * jb + a, c, stride));
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float d = dot[a][q];
        d = fmaf(x[a].x, y[q].x, d);
        d = fmaf(x[a].y, y[q].y, d);
        d = fmaf(x[a].z, y[q].z, d);
        dot[a][q] = fmaf(x[a].w, y[q].w, d);
      }
    }
  }
}

// One sample a warp, kFwdWarps a block.  Shared memory a warp: z, `stride`
// columns of it at a time (rows x stride floats), then the dots (P rounded
// up to 4), which carry each chain from one chunk of columns to the next.
template <typename T>
__global__ void __launch_bounds__(kFwdWarps * 32)
dot_interaction_fwd_kernel(const T* __restrict__ bot,
                           const T* __restrict__ pooled, T* __restrict__ out,
                           int batch, int m, int dim, int stride, int vec) {
  extern __shared__ __align__(16) float fsh[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kFwdWarps + warp;
  if (b >= batch) return;  // the whole warp
  const int nb = (m + 3) >> 2;  // blocks of 4 rows
  const int rows = 4 * nb;
  const int pairs = pairs_of(m);
  float* zs = fsh + warp * (rows * stride + ((pairs + 3) & ~3));
  float* dots = zs + rows * stride;
  T* row = out + static_cast<int64_t>(b) * (dim + pairs);

  for (int c0 = 0; c0 < dim; c0 += stride) {
    const int w = min(stride, dim - c0);
    __syncwarp();  // the last chunk's reads of zs are done
    stage_z<T>(zs, bot, pooled, b, m, rows, dim, c0, w, stride, lane, vec);
    for (int t = lane; t < nb * (nb + 1) / 2; t += 32) {
      int ib = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      ib -= ib * (ib + 1) / 2 > t;  // the root in f32, made exact
      ib += (ib + 1) * (ib + 2) / 2 <= t;
      const int jb = t - ib * (ib + 1) / 2;
      float dot[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * ib + a, j = 4 * jb + q;
          dot[a][q] = c0 && j < i && i < m ? dots[pairs_of(i) + j] : 0.f;
        }
      }
      gram_block(dot, zs, ib, jb, (w + 3) >> 2, stride);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * ib + a, j = 4 * jb + q;
          if (j < i && i < m) dots[pairs_of(i) + j] = dot[a][q];
        }
      }
    }
    for (int e = lane; e < w; e += 32) {  // row 0's chunks are unswizzled
      Elem<T>::put(row + c0 + e, zs[e]);
    }
  }
  __syncwarp();
  for (int p = lane; p < pairs; p += 32) Elem<T>::put(row + dim + p, dots[p]);
}

// ---------------------------------------------------------------- backward

// Columns [col, col + 4) of sample b's rows of z; rows from m on, and a
// lane past the row's end or the batch (`cols` false), hold zeros.
template <typename T, int M>
__device__ __forceinline__ void load_rows(float (&z)[M][4], const T* bot,
                                          const T* pooled, int b, int m,
                                          int dim, int col, bool cols,
                                          int vec) {
  const T* row0 = bot + static_cast<int64_t>(b) * dim + col;
  const T* rows = pooled + static_cast<int64_t>(b) * (m - 1) * dim + col;
  // one branch on vec outside the loop, so each way is a straight run of
  // predicated loads, all in flight before the first use
  if (vec) {
#pragma unroll
    for (int r = 0; r < M; ++r) {
      z[r][0] = z[r][1] = z[r][2] = z[r][3] = 0.f;
      if (cols && r < m) {
        Elem<T>::get4(r == 0 ? row0 : rows + (r - 1) * dim, z[r]);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < M; ++r) {
      z[r][0] = z[r][1] = z[r][2] = z[r][3] = 0.f;
      if (cols && r < m) {
        load4<T>(r == 0 ? row0 : rows + (r - 1) * dim, dim - col, 0, z[r]);
      }
    }
  }
}

// One sample a group of 2^lanes_log2 lanes, kBwdGroups groups a block.
template <typename T, int M>
__global__ void __launch_bounds__(kBwdGroups * 32)
dot_interaction_bwd_kernel(const T* __restrict__ grad,
                           const T* __restrict__ bot,
                           const T* __restrict__ pooled,
                           T* __restrict__ gbot, T* __restrict__ gpooled,
                           int batch, int m, int dim, int lanes_log2,
                           int vec) {
  // G's rows M + 4 words apart (16-byte aligned; the transposed writes
  // 4-way, not 32-way, bank conflicts), groups M (M + 4) + 4 words apart
  // (so the groups of one warp read other banks)
  constexpr int kRow = M + 4;
  constexpr int kGroup = M * kRow + 4;
  __shared__ __align__(16) float gsh[kBwdGroups * kGroup];
  const int lanes = 1 << lanes_log2;
  const int group = threadIdx.x >> lanes_log2;
  const int lg = threadIdx.x & (lanes - 1);
  const int b = blockIdx.x * kBwdGroups + group;
  const bool live = b < batch;  // no early return: __syncwarp below
  float* G = gsh + group * kGroup;
  const int pairs = pairs_of(m);
  const T* grow = grad + static_cast<int64_t>(live ? b : 0) * (dim + pairs);

  const int m4 = (m + 3) & ~3;  // columns of G read, whole 16-byte words
  for (int r = lg; r < m; r += lanes) {
    G[r * kRow + r] = 0.f;
    for (int j = m; j < m4; ++j) G[r * kRow + j] = 0.f;
  }
  for (int q = lg; q < pairs; q += lanes) {
    const float g = live ? Elem<T>::get(grow + dim + q) : 0.f;
    int i = static_cast<int>((1.f + sqrtf(8.f * q + 1.f)) * 0.5f);
    i -= pairs_of(i) > q;  // the root in f32, made exact
    i += pairs_of(i + 1) <= q;
    const int j = q - pairs_of(i);
    G[i * kRow + j] = g;
    G[j * kRow + i] = g;
  }
  const int col = blockIdx.y * kBwdCols + lg * 4;  // blockIdx.y: D > 128
  const bool cols = live && col < dim;
  float z[M][4];
  load_rows<T, M>(z, bot, pooled, b, m, dim, col, cols, vec);
  __syncwarp();

  const int64_t tables = m - 1;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r < m) {
      // the products with the rows before r and after r, each a chain in
      // ascending j, as the GEMMs G_low z and G_low^T z sum them
      float lo[4] = {0.f, 0.f, 0.f, 0.f};
      float hi[4] = {0.f, 0.f, 0.f, 0.f};
      const float* gr = G + r * kRow;
#pragma unroll
      for (int q = 0; q < M / 4; ++q) {
        if (4 * q < m) {
          const float4 g4 = *reinterpret_cast<const float4*>(gr + 4 * q);
          const float gq[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * q + k;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (j < r) lo[e] = fmaf(gq[k], z[j][e], lo[e]);
              if (j > r) hi[e] = fmaf(gq[k], z[j][e], hi[e]);
            }
          }
        }
      }
      float acc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = lo[e] + hi[e];
      if (cols) {
        if (r == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[e] += col + e < dim ? Elem<T>::get(grow + col + e) : 0.f;
          }
          store4<T>(gbot + static_cast<int64_t>(b) * dim + col, dim - col,
                    vec, acc);
        } else {
          store4<T>(gpooled + (b * tables + (r - 1)) * dim + col, dim - col,
                    vec, acc);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- tiled

constexpr int kTile = 32;         // rows of z a tile, columns a forward chunk
constexpr int kTiledCols = 64;    // columns of G z a backward work item
constexpr int kTiledThreads = 256;

__device__ __forceinline__ int64_t pairs_of64(int64_t m) {
  return m * (m - 1) / 2;
}

// Row r of sample b's z.
template <typename T>
__device__ __forceinline__ const T* z_row(const T* bot, const T* pooled,
                                          int64_t b, int r, int m, int dim) {
  return r == 0 ? bot + b * dim : pooled + (b * (m - 1) + (r - 1)) * dim;
}

// Work item w: sample w / tri, tile t (ti, tj), tj <= ti, in row-major
// order of the tiles' lower triangle.
template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
dot_interaction_fwd_tiled_kernel(const T* __restrict__ bot,
                                 const T* __restrict__ pooled,
                                 T* __restrict__ out, int64_t batch, int m,
                                 int dim) {
  __shared__ float xs[kTile][kTile + 1];
  __shared__ float ys[kTile][kTile + 1];
  const int tiles = (m + kTile - 1) / kTile;
  const int tri = tiles * (tiles + 1) / 2;
  const int64_t width = dim + pairs_of64(m);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int64_t w = blockIdx.x; w < batch * tri; w += gridDim.x) {
    const int64_t b = w / tri;
    const int t = static_cast<int>(w - b * tri);
    int ti = static_cast<int>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
    ti -= ti * (ti + 1) / 2 > t;
    ti += (ti + 1) * (ti + 2) / 2 <= t;
    const int i0 = ti * kTile, j0 = (t - ti * (ti + 1) / 2) * kTile;
    const bool diag = i0 == j0;  // y's rows are x's: staged once
    const float(*yt)[kTile + 1] = diag ? xs : ys;
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int c0 = 0; c0 < dim; c0 += kTile) {
      __syncthreads();  // the last chunk's reads are done
      for (int e = threadIdx.x; e < kTile * kTile; e += kTiledThreads) {
        const int r = e / kTile, c = c0 + e % kTile;
        xs[r][e % kTile] =
            c < dim && i0 + r < m
                ? Elem<T>::get(z_row(bot, pooled, b, i0 + r, m, dim) + c)
                : 0.f;
        if (!diag) {
          ys[r][e % kTile] =
              c < dim && j0 + r < m
                  ? Elem<T>::get(z_row(bot, pooled, b, j0 + r, m, dim) + c)
                  : 0.f;
        }
      }
      __syncthreads();
      const int cn = min(kTile, dim - c0);
      for (int c = 0; c < cn; ++c) {
        const float x0 = xs[2 * ty][c], x1 = xs[2 * ty + 1][c];
        const float y0 = yt[2 * tx][c], y1 = yt[2 * tx + 1][c];
        acc[0][0] = fmaf(x0, y0, acc[0][0]);
        acc[0][1] = fmaf(x0, y1, acc[0][1]);
        acc[1][0] = fmaf(x1, y0, acc[1][0]);
        acc[1][1] = fmaf(x1, y1, acc[1][1]);
      }
    }
    T* row = out + b * width;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = i0 + 2 * ty + a, j = j0 + 2 * tx + q;
        if (j < i && i < m) Elem<T>::put(row + dim + pairs_of64(i) + j,
                                         acc[a][q]);
      }
    }
    if (t == 0) {
      for (int e = threadIdx.x; e < dim; e += kTiledThreads) {
        row[e] = bot[b * dim + e];
      }
    }
  }
}

// Work item w: sample w / (rtiles ctiles), rows [r0, r0 + 32) and columns
// [c0, c0 + 64) of its G z.
template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
dot_interaction_bwd_tiled_kernel(const T* __restrict__ grad,
                                 const T* __restrict__ bot,
                                 const T* __restrict__ pooled,
                                 T* __restrict__ gbot,
                                 T* __restrict__ gpooled, int64_t batch,
                                 int m, int dim) {
  __shared__ __align__(16) float zs[kTile][kTiledCols];
  __shared__ float gs[kTile][kTile + 1];
  const int rtiles = (m + kTile - 1) / kTile;
  const int ctiles = (dim + kTiledCols - 1) / kTiledCols;
  const int64_t width = dim + pairs_of64(m);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int64_t w = blockIdx.x; w < batch * rtiles * ctiles;
       w += gridDim.x) {
    const int64_t b = w / (rtiles * ctiles);
    const int item = static_cast<int>(w - b * rtiles * ctiles);
    const int r0 = item / ctiles * kTile, c0 = item % ctiles * kTiledCols;
    const T* grow = grad + b * width;
    float lo[2][4] = {}, hi[2][4] = {};
    for (int j0 = 0; j0 < m; j0 += kTile) {
      __syncthreads();  // the last tile's reads are done
      for (int e = threadIdx.x; e < kTile * kTiledCols; e += kTiledThreads) {
        const int r = e / kTiledCols, c = c0 + e % kTiledCols;
        zs[r][e % kTiledCols] =
            j0 + r < m && c < dim
                ? Elem<T>::get(z_row(bot, pooled, b, j0 + r, m, dim) + c)
                : 0.f;
      }
      for (int e = threadIdx.x; e < kTile * kTile; e += kTiledThreads) {
        const int r = r0 + e / kTile, j = j0 + e % kTile;
        gs[e / kTile][e % kTile] =
            r < m && j < m && r != j
                ? Elem<T>::get(grow + dim + pairs_of64(max(r, j)) + min(r, j))
                : 0.f;
      }
      __syncthreads();
      const int jn = min(kTile, m - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const int j = j0 + jj;
        const float4 z4 = *reinterpret_cast<const float4*>(&zs[jj][4 * tx]);
        const float zj[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int r = r0 + 2 * ty + a;
          const float g = gs[2 * ty + a][jj];
          if (j < r) {
#pragma unroll
            for (int e = 0; e < 4; ++e) lo[a][e] = fmaf(g, zj[e], lo[a][e]);
          } else if (j > r) {
#pragma unroll
            for (int e = 0; e < 4; ++e) hi[a][e] = fmaf(g, zj[e], hi[a][e]);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = r0 + 2 * ty + a;
      if (r >= m) continue;
      T* dst = r == 0 ? gbot + b * dim : gpooled + (b * (m - 1) + (r - 1)) * dim;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 4 * tx + e;
        if (col < dim) {
          float v = lo[a][e] + hi[a][e];
          if (r == 0) v += Elem<T>::get(grow + col);
          Elem<T>::put(dst + col, v);
        }
      }
    }
  }
}

// Blocks of a tiled launch: one a work item, up to 2^20 (then each loops).
int tiled_grid(int64_t items) {
  return static_cast<int>(items < (1 << 20) ? items : (1 << 20));
}

// Floats a row of the forward's shared copy of z, the columns of a chunk:
// whole groups of eight 16-byte chunks, so the swizzle stays inside the
// row, at most 128.
int fwd_stride(int dim) {
  const int s = (dim + 31) & ~31;
  return s < kFwdCols ? s : kFwdCols;
}

int64_t fwd_smem_bytes(int m, int dim) {
  const int64_t rows = 4 * ((m + 3) / 4);
  const int64_t staged = (static_cast<int64_t>(m) * (m - 1) / 2 + 3) & ~3;
  return kFwdWarps * (rows * fwd_stride(dim) + staged) * 4;
}

template <typename T>
int launch_fwd(const void* bot, const void* pooled, void* out, int batch,
               int m, int dim, int vec, int tiled, cudaStream_t stream) {
  if (tiled) {
    const int tiles = (m + kTile - 1) / kTile;
    dot_interaction_fwd_tiled_kernel<T>
        <<<tiled_grid(static_cast<int64_t>(batch) * tiles * (tiles + 1) / 2),
           kTiledThreads, 0, stream>>>(
            static_cast<const T*>(bot), static_cast<const T*>(pooled),
            static_cast<T*>(out), batch, m, dim);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = static_cast<int>(fwd_smem_bytes(m, dim));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dot_interaction_fwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (batch + kFwdWarps - 1) / kFwdWarps;
  dot_interaction_fwd_kernel<T><<<grid, kFwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(bot), static_cast<const T*>(pooled),
      static_cast<T*>(out), batch, m, dim, fwd_stride(dim), vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int M>
int launch_bwd(const void* grad, const void* bot, const void* pooled,
               void* gbot, void* gpooled, int batch, int m, int dim,
               int lanes_log2, int vec, cudaStream_t stream) {
  const dim3 grid((batch + kBwdGroups - 1) / kBwdGroups,
                  (dim + kBwdCols - 1) / kBwdCols);
  const int threads = kBwdGroups << lanes_log2;
  dot_interaction_bwd_kernel<T, M><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(bot),
      static_cast<const T*>(pooled), static_cast<T*>(gbot),
      static_cast<T*>(gpooled), batch, m, dim, lanes_log2, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_any(const void* grad, const void* bot, const void* pooled,
                   void* gbot, void* gpooled, int batch, int m, int dim,
                   int lanes_log2, int vec, int tiled, cudaStream_t stream) {
  if (tiled) {
    const int64_t items = static_cast<int64_t>(batch) *
                          ((m + kTile - 1) / kTile) *
                          ((dim + kTiledCols - 1) / kTiledCols);
    dot_interaction_bwd_tiled_kernel<T>
        <<<tiled_grid(items), kTiledThreads, 0, stream>>>(
            static_cast<const T*>(grad), static_cast<const T*>(bot),
            static_cast<const T*>(pooled), static_cast<T*>(gbot),
            static_cast<T*>(gpooled), batch, m, dim);
    return static_cast<int>(cudaGetLastError());
  }
  auto f = m <= 8 ? &launch_bwd<T, 8>
           : m <= 16 ? &launch_bwd<T, 16> : &launch_bwd<T, 32>;
  return f(grad, bot, pooled, gbot, gpooled, batch, m, dim, lanes_log2, vec,
           stream);
}

// What the wrapper checks, checked again: the tiled kernels take any
// 1 <= m and 1 <= dim; the other forward any whose two copies of z (a
// chunk of columns) and dots fit a block's shared memory, the other
// backward m <= 32.
bool takes_fwd(int batch, int m, int dim, int tiled) {
  return batch > 0 && m >= 1 && dim >= 1 &&
         (tiled || fwd_smem_bytes(m, dim) <= kMaxSmem);
}

bool takes_bwd(int batch, int m, int dim, int tiled) {
  return batch > 0 && m >= 1 && dim >= 1 && (tiled || m <= 32);
}

}  // namespace

extern "C" {

// dtype 0 f32, 1 bf16, 2 f16 (bindings.DTYPE_CODES); bot (batch, dim),
// pooled (batch, m - 1, dim), out (batch, dim + m (m - 1) / 2), all
// contiguous; vec: dim % 4 == 0 and bot, pooled aligned to four elements;
// tiled: the tiled kernel (which ignores vec).
int dot_interaction_fwd(int dtype, const void* bot, const void* pooled,
                        void* out, int batch, int m, int dim, int vec,
                        int tiled, void* stream) {
  if (!takes_fwd(batch, m, dim, tiled) || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto f = dtype == 0   ? &launch_fwd<float>
           : dtype == 1 ? &launch_fwd<__nv_bfloat16> : &launch_fwd<__half>;
  return f(bot, pooled, out, batch, m, dim, vec, tiled, s);
}

// grad (batch, dim + m (m - 1) / 2); gbot (batch, dim), gpooled (batch,
// m - 1, dim); untiled, lanes_log2 3 to 5 with min(dim, 128) <= 4 <<
// lanes_log2 (a block a 128 columns); vec
// and tiled as the forward's, vec for gbot and gpooled too.
int dot_interaction_bwd(int dtype, const void* grad, const void* bot,
                        const void* pooled, void* gbot, void* gpooled,
                        int batch, int m, int dim, int lanes_log2, int vec,
                        int tiled, void* stream) {
  if (!takes_bwd(batch, m, dim, tiled) || dtype < 0 || dtype > 2 ||
      (!tiled && (lanes_log2 < 3 || lanes_log2 > 5 ||
                  (dim < kBwdCols ? dim : kBwdCols) > (4 << lanes_log2)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto f = dtype == 0   ? &launch_bwd_any<float>
           : dtype == 1 ? &launch_bwd_any<__nv_bfloat16>
                        : &launch_bwd_any<__half>;
  return f(grad, bot, pooled, gbot, gpooled, batch, m, dim, lanes_log2, vec,
           tiled, s);
}

}  // extern "C"
