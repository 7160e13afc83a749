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
// coalesced_bag) and the XLA pre-pass before it (:237-252).  It computes
// K1's function, the sum-pooled bag, by the experiment's scheme: per tile of
// tile_bags bags, sort the tile's ids, dedup them into aligned r_blk-row
// blocks, fetch each distinct block once with one copy of r_blk * D * 4
// bytes, and sum each bag's rows out of shared memory.  The whole scheme is
// one launch: a block plans its own tile in shared memory (a bitonic sort of
// (row, position) keys, block heads numbered by a block-wide scan), so no
// plan goes through device memory.  An id in [-R, 0) counts from the end
// and any other id outside [0, R) makes its bag NaN, as in K1.
//
// What bounds K10 on an H100: bytes, the scheme's own.  It reads every
// distinct block in full, so with uniform ids over 1M rows it reads about
// r_blk times the rows K1 reads (a block shared by tiles may come from L2).
// The TPU's grid walked tiles in order with the whole tile's blocks in VMEM
// (2 MiB); here tiles run in parallel, and what keeps the bytes flowing is
// copies in flight on every SM.  Persistent blocks, four an SM at the
// experiment's shape (49,408 bytes each, so its 512 tiles are all resident
// at once): a producer warp fills a ring of stages of bulk copies and
// refills a stage as soon as the eight consumer warps release it on its
// "empty" mbarrier, with no block-wide barrier while a tile streams.
// Measured on the card, a call's time went with its number of stages and
// not with the ring's depth (1 block a stage: the same time at 4 and at 11
// stages), so the ring has two stages, each as large as four blocks an SM
// allow (5 blocks of 4 KiB here).  A consumer warp owns bags
// and keeps their sums in registers, adding each bag's rows in arena
// order, so a bag's sum is taken in one fixed order (two calls agree bit
// for bit, whatever the ring) with no shared-memory atomics; the price is
// a sum order other than the bag's own (rtol 1e-5 against K1).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;      // K9: chunks of starts in flight per block
constexpr int kBarBytes = 128;  // mbarriers (and a flag) at the head of smem
constexpr int kMaxSmem = 232448;

// mbarrier helpers of hopper.cuh; mbar_wait traps after 10 s instead of
// hanging the card when a copy never lands (a fault in the byte count)
using hopper::bulk_load;  // global -> shared, counted off a barrier
using hopper::mbar_arrive;
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
constexpr int kBagWarps = 8;                      // consumer warps
constexpr int kBagThreads = (kBagWarps + 1) * 32;  // + one producer warp
constexpr int kRingStages = 2;
constexpr int kMaxStageBlocks = 32;  // copies a stage: one a producer lane
// shared memory a K10 block aims to stay within, so that four fit on an SM
// (228 KiB an SM, 1 KiB of it reserved a block)
constexpr int kBagSmemTarget = 228 * 1024 / 4 - 1024;
constexpr int kMaxSums = 4;      // float4 sums a lane keeps: bags x D / 128
constexpr int kMaxTileIds = 4096;
constexpr int kBagHead = 256;    // full / empty mbarriers, the scan's sums
constexpr unsigned kNoRow = 0xffffffffu;  // an id outside [-R, R)

__host__ __device__ inline size_t round_up(size_t x, size_t m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// shared memory of a K10 block: head | keys (the padded sort buffer, 8
// bytes an id) | blocks (the tile's block starts, by slot) | lists (each
// bag's nnz arena rows in slot order) | the ring of kRingStages stages of
// `stage_blocks` blocks
struct BagLayout {
  size_t keys, blocks, lists, ring, total;
};

__host__ __device__ inline BagLayout bag_layout(int dim, int nnz,
                                                int tile_bags, int r_blk,
                                                int stage_blocks) {
  const size_t rpt = static_cast<size_t>(tile_bags) * nnz;
  BagLayout l;
  l.keys = kBagHead;
  l.blocks =
      l.keys + 8 * static_cast<size_t>(pow2_at_least(static_cast<int>(rpt)));
  l.lists = l.blocks + 4 * rpt;
  l.ring = round_up(l.lists + 4 * rpt, 128);
  l.total = l.ring + static_cast<size_t>(kRingStages) * stage_blocks *
                         r_blk * dim * 4;
  return l;
}

// blocks a ring stage: as many as keep a thread block within
// kBagSmemTarget, else one (fewer thread blocks an SM then)
inline int bag_stage_blocks(int dim, int nnz, int tile_bags, int r_blk) {
  for (int sb = kMaxStageBlocks; sb > 1; --sb)
    if (bag_layout(dim, nnz, tile_bags, r_blk, sb).total <=
        static_cast<size_t>(kBagSmemTarget))
      return sb;
  return 1;
}

// ascending bitonic sort of v[0, n), n a power of two, by the whole block;
// ends on a barrier
__device__ void bitonic_sort(unsigned long long* v, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const unsigned long long a = v[lo], b = v[lo + j];
        if ((a > b) == ((lo & k) == 0)) {
          v[lo] = b;
          v[lo + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Persistent blocks; block b plans and sums tiles b, b + gridDim.x, ...
// Per tile, all warps: load the tile's ids, sort (row, position) keys,
// mark block heads and number them (a block-wide scan) into slots, and
// rewrite each key as (arena row, position).  Then warp 8 (the producer)
// copies the tile's blocks in order, stage_blocks to a stage, into a ring
// of kRingStages stages, and warps 0-7 each sum bags w, w + 8, ...: a lane
// keeps a float4 of each bag's sum (per 128 columns) in registers and adds
// the bag's rows in arena order as their stages land, then releases the
// stage.  The stage counter runs on across tiles, so the producer fills a
// stage as soon as all eight consumers release it.
__global__ void __launch_bounds__(kBagThreads, 4)
coalesced_bag_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ idx, float* __restrict__ out,
                     int32_t* __restrict__ fetched, long long num_rows,
                     int dim, int n_tiles, int nnz, int tile_bags, int r_blk,
                     int stage_blocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rpt = tile_bags * nnz;
  const int npad = pow2_at_least(rpt);
  const BagLayout lay =
      bag_layout(dim, nnz, tile_bags, r_blk, stage_blocks);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kRingStages;
  int* warp_heads = reinterpret_cast<int*>(empty + kRingStages);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(smem + lay.keys);
  int* blocks = reinterpret_cast<int*>(smem + lay.blocks);
  int* lists = reinterpret_cast<int*>(smem + lay.lists);
  float* ring = reinterpret_cast<float*>(smem + lay.ring);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk_floats = r_blk * dim;
  const int stage_rows = stage_blocks * r_blk;
  const int cols = (dim + 127) / 128;                 // float4 chunks a lane
  const int sums = (tile_bags + kBagWarps - 1) / kBagWarps * cols;
  const int per = (rpt + kBagThreads - 1) / kBagThreads;  // ids a thread

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kBagWarps);
    }
    mbar_fence_init();
  }
  int stage0 = 0;  // stages this block walked in earlier tiles
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the last tile's plan is read no more
    // keys: (row << 32 | position); K1's id rules, an invalid id sorting
    // after every valid one and the padding after it
    const int32_t* ids = idx + static_cast<long long>(tile) * rpt;
    for (int i = threadIdx.x; i < npad; i += kBagThreads) {
      unsigned long long key = ~0ull;
      if (i < rpt) {
        long long v = ids[i];
        if (v < 0) v += num_rows;
        const unsigned row =
            v >= 0 && v < num_rows ? static_cast<unsigned>(v) : kNoRow;
        key = static_cast<unsigned long long>(row) << 32 | i;
      }
      keys[i] = key;
    }
    __syncthreads();
    bitonic_sort(keys, npad);

    // block heads among this thread's sorted ids [a, b), then their slots
    const int a = min(rpt, static_cast<int>(threadIdx.x) * per);
    const int b = min(rpt, a + per);
    unsigned head_bits = 0;
    int prev = a > 0 ? static_cast<int>(keys[a - 1] >> 32) : -1;
    for (int i = a; i < b; ++i) {
      const unsigned row = static_cast<unsigned>(keys[i] >> 32);
      const int blk = row == kNoRow ? -1 : static_cast<int>(row / r_blk);
      const int prev_blk = prev < 0 ? -1 : prev / r_blk;
      if (blk >= 0 && (i == 0 || blk != prev_blk)) head_bits |= 1u << (i - a);
      prev = row == kNoRow ? -1 : static_cast<int>(row);
    }
    const int heads = __popc(head_bits);
    int incl = heads;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_heads[warp] = incl;
    __syncthreads();
    int n_blocks = 0, slot = incl - heads - 1;
    for (int w = 0; w <= kBagWarps; ++w) {
      n_blocks += warp_heads[w];
      if (w < warp) slot += warp_heads[w];
    }
    for (int i = a; i < b; ++i) {
      const unsigned row = static_cast<unsigned>(keys[i] >> 32);
      if (row == kNoRow) continue;
      if (head_bits >> (i - a) & 1) blocks[++slot] = row / r_blk * r_blk;
      const unsigned arena_row = slot * r_blk + row % r_blk;
      keys[i] = static_cast<unsigned long long>(arena_row) << 32 |
                (keys[i] & 0xffffffffull);
    }
    __syncthreads();  // the plan is whole
    const int n_stages = (n_blocks + stage_blocks - 1) / stage_blocks;

    if (warp == kBagWarps) {
      // the producer: lane i copies the stage's i-th block (the table's
      // last block may be short)
      int copies = 0;
      for (int s = 0; s < n_stages; ++s) {
        const int g = stage0 + s, buf = g % kRingStages;
        mbar_wait(&empty[buf], ((g / kRingStages) & 1) ^ 1);
        const int first = s * stage_blocks;
        const int cnt = min(stage_blocks, n_blocks - first);
        uint32_t bytes = 0;
        long long start = 0;
        if (lane < cnt) {
          start = blocks[first + lane];
          bytes = static_cast<uint32_t>(
                      min(static_cast<long long>(r_blk), num_rows - start)) *
                  dim * 4;
        }
        uint32_t total = bytes;
        for (int o = 16; o; o >>= 1)
          total += __shfl_xor_sync(0xffffffffu, total, o);
        copies += __popc(__ballot_sync(0xffffffffu, bytes != 0));
        if (lane == 0) mbar_arrive_expect_tx(&full[buf], total);
        __syncwarp();
        if (bytes)
          bulk_load(ring + (static_cast<size_t>(buf) * stage_blocks + lane) *
                               blk_floats,
                    table + start * dim, bytes, &full[buf]);
      }
      if (lane == 0 && fetched != nullptr) fetched[tile] = copies;
    } else {
      // each of this warp's bags: its nnz arena rows in sorted order (an
      // invalid id's -1 last), kept in the order of the sort
      int filled[kMaxSums];
#pragma unroll
      for (int k = 0; k < kMaxSums; ++k) filled[k] = 0;
      for (int base = 0; base < rpt; base += 32) {
        const int i = base + lane;
        const unsigned long long key = i < rpt ? keys[i] : ~0ull;
        const int bag =
            i < rpt ? static_cast<int>(key & 0xffffffffull) / nnz : -1;
#pragma unroll
        for (int k = 0; k < kMaxSums; ++k) {
          const int mine = warp + k * kBagWarps;
          const unsigned m = __ballot_sync(0xffffffffu, bag == mine);
          if (bag == mine)
            lists[mine * nnz + filled[k] + __popc(m & ((1u << lane) - 1))] =
                static_cast<int>(key >> 32);
          filled[k] += __popc(m);
        }
      }
      __syncwarp();

      // sum j of a lane: bag warp + (j / cols) * 8, columns 128 (j % cols)
      // + 4 lane .. + 3
      float4 acc[kMaxSums];
      int next[kMaxSums];
#pragma unroll
      for (int j = 0; j < kMaxSums; ++j) {
        acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        next[j] = 0;
      }
      for (int s = 0; s < n_stages; ++s) {
        const int g = stage0 + s, buf = g % kRingStages;
        mbar_wait(&full[buf], (g / kRingStages) & 1);
        const float* stage = ring + static_cast<size_t>(buf) * stage_blocks *
                                        blk_floats;
        const int lo = s * stage_rows, hi = lo + stage_rows;
#pragma unroll
        for (int j = 0; j < kMaxSums; ++j) {
          const int bag = warp + j / cols * kBagWarps;
          const int col = j % cols * 128 + lane * 4;
          if (j >= sums || bag >= tile_bags) continue;
          const int* list = lists + bag * nnz;
          for (; next[j] < nnz; ++next[j]) {
            const int r = list[next[j]];
            if (r < 0 || r >= hi) break;
            if (col < dim) {
              const float4 v = *reinterpret_cast<const float4*>(
                  stage + (r - lo) * dim + col);
              acc[j].x += v.x;
              acc[j].y += v.y;
              acc[j].z += v.z;
              acc[j].w += v.w;
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[buf]);
      }
      const float nan = __int_as_float(0x7fc00000);
#pragma unroll
      for (int j = 0; j < kMaxSums; ++j) {
        const int bag = warp + j / cols * kBagWarps;
        const int col = j % cols * 128 + lane * 4;
        if (j >= sums || bag >= tile_bags || col >= dim) continue;
        float4 v = acc[j];
        if (lists[bag * nnz + nnz - 1] < 0) v = make_float4(nan, nan, nan, nan);
        *reinterpret_cast<float4*>(
            out + (static_cast<long long>(tile) * tile_bags + bag) * dim +
            col) = v;
      }
    }
    stage0 += n_stages;
  }
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

// Shared memory a K10 block takes (its ring sized by bag_stage_blocks), or
// 0 when the shape does not fit.
int coalesced_bag_smem(int dim, int nnz, int tile_bags, int r_blk) {
  const long long rpt = static_cast<long long>(tile_bags) * nnz;
  const int sums =
      (tile_bags + kBagWarps - 1) / kBagWarps * ((dim + 127) / 128);
  if (dim < 4 || dim % 4 || nnz < 1 || tile_bags < 1 || r_blk < 1 ||
      rpt > kMaxTileIds || sums > kMaxSums)
    return 0;
  const size_t s = bag_layout(dim, nnz, tile_bags, r_blk,
                              bag_stage_blocks(dim, nnz, tile_bags, r_blk))
                       .total;
  return s <= static_cast<size_t>(kMaxSmem) ? static_cast<int>(s) : 0;
}

// table (num_rows, dim) f32; idx (n_tiles * tile_bags, nnz) int32; out
// (n_tiles * tile_bags, dim) f32; fetched (n_tiles,) int32, the copies
// each tile's blocks took, or null.  num_rows < 2^31 - 1; `sms` the card's
// SMs.
int coalesced_bag_f32(const void* table, const void* idx, void* out,
                      void* fetched, long long num_rows, int dim, int n_tiles,
                      int nnz, int tile_bags, int r_blk, int sms,
                      void* stream) {
  static bool configured = false;
  // thread blocks an SM at the last shared-memory size launched
  static int occupancy_smem = -1, per_sm = 0;
  const int smem = coalesced_bag_smem(dim, nnz, tile_bags, r_blk);
  if (smem == 0 || num_rows < 1 || num_rows >= 0x7fffffff || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!configured)
    cudaFuncSetAttribute(coalesced_bag_kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
  allow_max_smem(coalesced_bag_kernel, configured);
  if (smem != occupancy_smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, coalesced_bag_kernel, kBagThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    occupancy_smem = smem;
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (n_tiles > 0) {
    const int grid = std::min(n_tiles, per_sm * sms);
    coalesced_bag_kernel<<<grid, kBagThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int32_t*>(idx),
        static_cast<float*>(out), static_cast<int32_t*>(fetched), num_rows,
        dim, n_tiles, nnz, tile_bags, r_blk,
        bag_stage_blocks(dim, nnz, tile_bags, r_blk));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
