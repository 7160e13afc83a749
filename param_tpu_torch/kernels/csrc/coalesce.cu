// K9 desc_fetch and K10 coalesced_bag: the coalesced-fetch experiment's two
// kernels, both built on one bulk copy (cp.async.bulk, global -> shared,
// completing on an mbarrier) per fetch of several consecutive table rows.
//
// K9 replaces the TPU kernel scripts/coalesce_experiment.py::_desc_kernel
// (via desc_fetch).  For tile t it reads n_desc = rows_per_tile / k row
// starts, fetches k consecutive rows per start with ONE copy, and returns
// the f32 sum over every fetched row and column of the tile, (n_tiles, D).
// The experiment's variable is the number of copies per row (1 / k), so each
// start stays one cp.async.bulk of k * D * 4 bytes.  The TPU stages a whole
// 4096-row tile (2 MiB) in VMEM; that does not fit in 227 KB of shared
// memory, so a block streams its starts through kStages buffers of up to 32
// starts each (16 KiB at k <= 32, D = 128).  64 tiles do not fill 132 SMs,
// so each tile is split over `splits` blocks (grid.y) that write partial
// sums, and a second kernel adds the parts in order.
//
// K10 replaces scripts/coalesce_experiment.py::_arena_kernel (via
// coalesced_bag).  It computes K1's function, the sum-pooled bag, from a
// plan the wrapper builds in PyTorch: per tile of tile_bags bags, the
// distinct aligned r_blk-row blocks its ids touch, and for each id in sorted
// order its flat offset in that block list and its position in the tile.
// The kernel fetches each distinct block once, one copy of r_blk * D * 4
// bytes, into a shared-memory arena, then re-gathers the rows from the
// arena and adds them into per-bag f32 accumulators in shared memory.  The
// TPU's arena holds the whole tile (rpt * r_blk rows, 2 MiB); here the
// tile's blocks are walked in rounds of `arena_blocks` blocks, double
// buffered, and each round's rows are added in sorted order (shared-memory
// atomics), not in bag order.  An id outside [0, R) (the plan has wrapped
// ids in [-R, 0)) makes its bag NaN, as in K1.
//
// What bounds both on an H100: bytes.  K9 reads K_ROWS * D * 4 bytes of table
// rows whatever k is; K10 reads every distinct block in full, so with
// uniform ids over 1M rows it reads about r_blk times the rows K1 reads.
// The arithmetic is one add per element read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;      // K9: chunks of starts in flight per block
constexpr int kBarBytes = 128;  // mbarriers (and a flag) at the head of smem
constexpr int kMaxSmem = 232448;

// mbarrier helpers of hopper.cuh; mbar_wait traps after 10 s instead of
// hanging the card when a copy never lands (a fault in the byte count)
using hopper::bulk_load;  // global -> shared, counted off a barrier
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

// order this thread block's earlier shared-memory reads (generic proxy)
// before the bulk copies that overwrite the buffer (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------- K9
// grid (n_tiles, splits); block (t, p) takes starts [a, b) of tile t, in
// chunks of `spc` starts, and writes its partial (D,) sum to partial[t, p].
__global__ void __launch_bounds__(kThreads)
desc_fetch_kernel(const float* __restrict__ table,
                  const int32_t* __restrict__ starts,
                  float* __restrict__ partial, long long num_rows, int dim,
                  int k, int n_desc, int spc) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* bad = reinterpret_cast<int*>(smem + kStages * sizeof(uint64_t));
  float* red = reinterpret_cast<float*>(smem + kBarBytes);  // kThreads x 4
  float* buf = red + kThreads * 4;
  const int tile = blockIdx.x, part = blockIdx.y, splits = gridDim.y;
  const int a = static_cast<int>(static_cast<long long>(n_desc) * part / splits);
  const int b =
      static_cast<int>(static_cast<long long>(n_desc) * (part + 1) / splits);
  const int n_chunks = (b - a + spc - 1) / spc;
  const int chunk_floats = spc * k * dim;
  const uint32_t copy_bytes = static_cast<uint32_t>(k) * dim * 4;
  const int32_t* tile_starts = starts + static_cast<long long>(tile) * n_desc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    *bad = 0;
    mbar_fence_init();
  }
  __syncthreads();

  // warp 0: lane i issues the copy of the chunk's i-th start; a start
  // outside [0, R - k] is not fetched and makes the tile NaN
  auto issue = [&](int c) {
    const int s = c % kStages;
    const int first = a + c * spc;
    const int cnt = min(spc, b - first);
    long long st = 0;
    bool ok = false;
    if (lane < cnt) {
      st = tile_starts[first + lane];
      ok = st >= 0 && st + k <= num_rows;
      if (!ok) *bad = 1;
    }
    const unsigned valid = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) mbar_arrive_expect_tx(&full[s], __popc(valid) * copy_bytes);
    __syncwarp();
    if (ok)
      bulk_load(buf + s * chunk_floats + lane * k * dim, table + st * dim,
               copy_bytes, &full[s]);
  };

  if (warp == 0) {
    for (int c = 0; c < min(kStages, n_chunks); ++c) issue(c);
  }
  const int lpr = dim / 4;  // threads per row, a float4 each
  const int groups = kThreads / lpr;
  const int g = threadIdx.x / lpr;
  const int col = (threadIdx.x % lpr) * 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages;
    mbar_wait(&full[s], (c / kStages) & 1);
    const int rows = min(spc, b - (a + c * spc)) * k;
    const float* p = buf + s * chunk_floats;
    for (int r = g; r < rows; r += groups) {
      const float4 v = *reinterpret_cast<const float4*>(p + r * dim + col);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    __syncthreads();  // every thread is done with buffer s
    if (warp == 0 && c + kStages < n_chunks) {
      fence_proxy_async();
      issue(c + kStages);
    }
  }
  *reinterpret_cast<float4*>(red + threadIdx.x * 4) = acc;
  __syncthreads();
  if (threadIdx.x < lpr) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int gg = 0; gg < groups; ++gg) {
      const float4 v =
          *reinterpret_cast<const float4*>(red + (gg * lpr + threadIdx.x) * 4);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (*bad) {
      const float nan = __int_as_float(0x7fc00000);
      sum = make_float4(nan, nan, nan, nan);
    }
    *reinterpret_cast<float4*>(
        partial + (static_cast<long long>(tile) * splits + part) * dim +
        threadIdx.x * 4) = sum;
  }
}

// out[t, c] = sum over p of partial[t, p, c], parts in order
__global__ void sum_parts_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int n_tiles,
                                 int splits, int dim) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_tiles) * dim) return;
  const long long t = i / dim, c = i % dim;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(t * splits + p) * dim + c];
  out[i] = s;
}

// ------------------------------------------------------------------ K10
__host__ __device__ inline size_t round_up(size_t x, size_t m) {
  return (x + m - 1) / m * m;
}

// shared memory: barriers | per-bag accumulators | the tile's plan | two
// arena buffers of arena_blocks blocks each
__host__ __device__ inline size_t bag_arena_offset(int dim, int rpt,
                                                   int tile_bags) {
  return round_up(kBarBytes + (static_cast<size_t>(tile_bags) * dim +
                               3 * static_cast<size_t>(rpt)) * 4, 128);
}

// first i in [lo, hi) with v[i] >= key (v ascending there), else hi
__device__ __forceinline__ int lower_bound(const int* v, int lo, int hi,
                                           int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// one block per tile of tile_bags bags
__global__ void __launch_bounds__(kThreads)
coalesced_bag_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ blocks,
                     const int32_t* __restrict__ n_blocks_of,
                     const int32_t* __restrict__ flat,
                     const int32_t* __restrict__ order,
                     float* __restrict__ out, long long num_rows, int dim,
                     int nnz, int tile_bags, int r_blk, int arena_blocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rpt = tile_bags * nnz;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* acc = reinterpret_cast<float*>(smem + kBarBytes);
  int* s_blocks = reinterpret_cast<int*>(acc + tile_bags * dim);
  int* s_flat = s_blocks + rpt;
  int* s_order = s_flat + rpt;
  float* arena = reinterpret_cast<float*>(
      smem + bag_arena_offset(dim, rpt, tile_bags));
  const int buf_floats = arena_blocks * r_blk * dim;
  const int round_rows = arena_blocks * r_blk;
  const long long tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < rpt; i += kThreads) {
    s_blocks[i] = blocks[tile * rpt + i];
    s_flat[i] = flat[tile * rpt + i];
    s_order[i] = order[tile * rpt + i];
  }
  for (int i = threadIdx.x; i < tile_bags * dim; i += kThreads) acc[i] = 0.f;
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
  }
  const int nb = n_blocks_of[tile];
  const int n_rounds = (nb + arena_blocks - 1) / arena_blocks;
  __syncthreads();

  // warp 0: lane i copies the round's i-th block (the table's last block
  // may be short) into buffer r % 2
  auto issue = [&](int r) {
    const int sb = r & 1;
    const int first = r * arena_blocks;
    const int cnt = min(arena_blocks, nb - first);
    uint32_t bytes = 0;
    long long start = 0;
    if (lane < cnt) {
      start = s_blocks[first + lane];
      const long long rows = min(static_cast<long long>(r_blk),
                                 num_rows - start);
      bytes = static_cast<uint32_t>(rows) * dim * 4;
    }
    uint32_t total = bytes;
    for (int o = 16; o; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
    if (lane == 0) mbar_arrive_expect_tx(&full[sb], total);
    __syncwarp();
    if (bytes)
      bulk_load(arena + sb * buf_floats + lane * r_blk * dim,
               table + start * dim, bytes, &full[sb]);
  };

  if (warp == 0) {
    for (int r = 0; r < min(2, n_rounds); ++r) issue(r);
  }
  // the valid ids (flat >= 0) come first in the sorted order
  int n_valid = 0;
  {
    int lo = 0, hi = rpt;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_flat[mid] >= 0) lo = mid + 1; else hi = mid;
    }
    n_valid = lo;
  }
  int lo = 0;
  for (int r = 0; r < n_rounds; ++r) {
    const int sb = r & 1;
    mbar_wait(&full[sb], (r >> 1) & 1);
    const int base = r * round_rows;
    const int hi = lower_bound(s_flat, lo, n_valid, base + round_rows);
    const float* buf = arena + sb * buf_floats;
    for (int i = lo + warp; i < hi; i += kWarps) {
      const float* src = buf + (s_flat[i] - base) * dim;
      float* dst = acc + (s_order[i] / nnz) * dim;
      for (int c = lane * 4; c < dim; c += 128) {
        const float4 v = *reinterpret_cast<const float4*>(src + c);
        atomicAdd(dst + c, v.x);
        atomicAdd(dst + c + 1, v.y);
        atomicAdd(dst + c + 2, v.z);
        atomicAdd(dst + c + 3, v.w);
      }
    }
    lo = hi;
    __syncthreads();  // every thread is done with buffer sb
    if (warp == 0 && r + 2 < n_rounds) {
      fence_proxy_async();
      issue(r + 2);
    }
  }
  const float nan = __int_as_float(0x7fc00000);
  for (int i = n_valid + warp; i < rpt; i += kWarps) {
    float* dst = acc + (s_order[i] / nnz) * dim;
    for (int c = lane; c < dim; c += 32) dst[c] = nan;
  }
  __syncthreads();
  float* o = out + tile * tile_bags * dim;
  for (int i = threadIdx.x * 4; i < tile_bags * dim; i += kThreads * 4)
    *reinterpret_cast<float4*>(o + i) = *reinterpret_cast<const float4*>(acc + i);
}

template <typename Kernel>
void allow_max_smem(Kernel kernel, bool& done) {
  if (!done) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    done = true;
  }
}

}  // namespace

extern "C" {

// Shared memory a K9 block takes, or 0 when the shape does not fit.
int desc_fetch_smem(int dim, int k, int spc) {
  const size_t s = kBarBytes + kThreads * 16 +
                   static_cast<size_t>(kStages) * spc * k * dim * 4;
  return s <= static_cast<size_t>(kMaxSmem) ? static_cast<int>(s) : 0;
}

// table (num_rows, dim) f32; starts (n_tiles * n_desc,) int32; partial
// (n_tiles, splits, dim) f32 scratch; out (n_tiles, dim) f32.  dim % 4 == 0
// with dim / 4 dividing 256; spc starts per chunk, spc <= 32.
int desc_fetch_f32(const void* table, const void* starts, void* partial,
                   void* out, long long num_rows, int dim, int k, int n_tiles,
                   int n_desc, int spc, int splits, void* stream) {
  static bool configured = false;
  auto s = static_cast<cudaStream_t>(stream);
  const int smem = desc_fetch_smem(dim, k, spc);
  if (smem == 0 || spc > 32 || dim % 4 || kThreads % (dim / 4))
    return static_cast<int>(cudaErrorInvalidValue);
  allow_max_smem(desc_fetch_kernel, configured);
  if (n_tiles > 0) {
    desc_fetch_kernel<<<dim3(n_tiles, splits), kThreads, smem, s>>>(
        static_cast<const float*>(table), static_cast<const int32_t*>(starts),
        static_cast<float*>(partial), num_rows, dim, k, n_desc, spc);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    const long long n = static_cast<long long>(n_tiles) * dim;
    sum_parts_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), n_tiles,
        splits, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared memory a K10 block takes, or 0 when the shape does not fit.
int coalesced_bag_smem(int dim, int nnz, int tile_bags, int r_blk,
                       int arena_blocks) {
  const size_t s = bag_arena_offset(dim, tile_bags * nnz, tile_bags) +
                   2 * static_cast<size_t>(arena_blocks) * r_blk * dim * 4;
  return s <= static_cast<size_t>(kMaxSmem) ? static_cast<int>(s) : 0;
}

// table (num_rows, dim) f32; the plan: blocks, flat, order (n_tiles, rpt)
// int32 and n_blocks (n_tiles,) int32, rpt = tile_bags * nnz; out
// (n_tiles * tile_bags, dim) f32.  dim % 4 == 0; arena_blocks <= 32.
int coalesced_bag_f32(const void* table, const void* blocks,
                      const void* n_blocks, const void* flat,
                      const void* order, void* out, long long num_rows,
                      int dim, int n_tiles, int nnz, int tile_bags, int r_blk,
                      int arena_blocks, void* stream) {
  static bool configured = false;
  auto s = static_cast<cudaStream_t>(stream);
  const int smem =
      coalesced_bag_smem(dim, nnz, tile_bags, r_blk, arena_blocks);
  if (smem == 0 || arena_blocks < 1 || arena_blocks > 32 || dim % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  allow_max_smem(coalesced_bag_kernel, configured);
  if (n_tiles > 0) {
    coalesced_bag_kernel<<<n_tiles, kThreads, smem, s>>>(
        static_cast<const float*>(table), static_cast<const int32_t*>(blocks),
        static_cast<const int32_t*>(n_blocks),
        static_cast<const int32_t*>(flat), static_cast<const int32_t*>(order),
        static_cast<float*>(out), num_rows, dim, nnz, tile_bags, r_blk,
        arena_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
