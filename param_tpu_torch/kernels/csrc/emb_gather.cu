// K1: sum-pooled embedding bag, out[b] = sum_j w[b,j] * table[idx[b,j]].
//
// Replaces the TPU kernel param_tpu/ops/embedding.py::_emb_gather_kernel
// (via embedding_bag_pallas), which copies the next tile's ids into SMEM
// ahead, issues one DMA a row for all of that tile's rows at once and waits
// once for the whole slot, then sum-pools on the vector unit.
//
// What bounds it on an H100: bytes, and the bytes kept in flight.  Each bag
// reads nnz random rows of D*esize bytes (256 B at the DLRM shape, 512 B at
// the 1M x 128 headline) and writes one row; the arithmetic is one add per
// element read.  Random rows read as whole 32 B sectors waste nothing, but
// streaming 3.35 TB/s at a loaded latency near a microsecond needs some 3
// MB of reads in flight across the card, ~25 KB an SM.  A warp that walks
// its bag one id, then one row, at a time keeps 512 B in flight, and 2048
// bags (15.5 warps an SM) then keep ~8 KB an SM: under half the rate.
//
// Design (what it does about that), in the order the walk takes:
//  - The ids come off the row chain: a warp loads up to 32 of its ids in
//    one coalesced load (lane j holds id j; rounds of 32 beyond that),
//    wraps and checks them there into row offsets, and hands those to the
//    lane groups with __shfl_sync.  No row load waits on an id load of
//    its own.  (Bags of at most one id a lane group, in one chunk, go to
//    emb_gather_small_kernel instead: each group loads its own id and row.)
//  - A row is read with 16-byte vector loads by `lanes_per_row` lanes
//    (D / VEC of them, e.g. 16 for D=64 f32), so a warp is 32 /
//    lanes_per_row lane groups.  Each group issues U independent row loads
//    (`rows_in_flight`, a template argument) before any add, then adds
//    them in a fixed order: up to U * 32 / lanes_per_row rows in flight a
//    warp.  The groups are summed with warp shuffles at the end.  When D
//    does not fit that shape the warp strides over the row in chunks of
//    32 * VEC columns.
//  - When the bags are too few to fill the card (2048 bags), each bag's
//    ids are split in k contiguous slices over k warps of one block
//    (`warps_per_bag`); warps 1..k-1 leave their partial sums in shared
//    memory and warp 0 adds them in slice order.  No atomics: a bag's sum
//    order depends on the launch's shape only, so a launch repeats bit
//    for bit.
//  - Bags of per-feature sizes (multi-hot features of fixed, unequal
//    sizes; RG = true): the ids come as rows of nnz, one a sample, and bag
//    b * nfeat + f is ids [off[f], off[f + 1]) of sample b's row
//    (`bag_offsets`, nfeat + 1 of them, off[nfeat] = nnz).  A warp reads
//    its bag's bounds from that table once, before its walk, and every id
//    it reads is a real one: no pad slots.  Such launches never take the
//    short path.  The fixed-nnz kernels (RG = false) are built apart, so
//    their code is what it was.
// kernels/emb_gather.py::emb_gather_schedule picks k, U and the lanes a
// row from the shapes.  Indices are int32; as in the reference's jnp.take,
// an id in [-rows, 0) counts from the end and any other id outside [0,
// rows) makes its bag NaN (its row is never read; the NaN reaches warp 0
// through the partial sums).  Weights (optional) are f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 256;  // bags a block x warps a bag x 32
constexpr unsigned kFull = 0xffffffffu;

// A row's VEC elements as loaded (Raw: what stays in registers while the
// load is in flight), unpacked to f32 only when they are added.
template <typename T, int VEC>
struct RowIO;

template <>
struct RowIO<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static Raw nan() {
    const float n = __int_as_float(0x7fc00000);
    return make_float4(n, n, n, n);
  }
  __device__ __forceinline__ static void unpack(const Raw& x, float* v) {
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct RowIO<float, 1> {
  using Raw = float;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(p);
  }
  __device__ __forceinline__ static Raw nan() {
    return __int_as_float(0x7fc00000);
  }
  __device__ __forceinline__ static void unpack(const Raw& x, float* v) {
    v[0] = x;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *p = v[0];
  }
};

template <>
struct RowIO<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static Raw nan() {
    return make_uint4(0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u);
  }
  __device__ __forceinline__ static void unpack(const Raw& x, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    }
    *reinterpret_cast<uint4*>(p) = x;
  }
};

template <>
struct RowIO<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return p[0];
  }
  __device__ __forceinline__ static Raw nan() {
    return __ushort_as_bfloat16(0x7fc0);
  }
  __device__ __forceinline__ static void unpack(const Raw& x, float* v) {
    v[0] = __bfloat162float(x);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// blocks an SM each depth is built to keep resident (registers a thread:
// 32, 40, 64, 64): the row loads in flight live in registers
template <int U>
constexpr int kMinBlocks = U == 1 ? 8 : U == 2 ? 6 : 4;

template <typename T, int VEC, int U, bool W, bool RG>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocks<U>)
emb_gather_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                  const float* __restrict__ weights, T* __restrict__ out,
                  int64_t num_rows, int batch, int nnz, int dim,
                  int log2_lanes, int log2_warps,
                  const int32_t* __restrict__ bag_offsets, int nfeat) {
  using IO = RowIO<T, VEC>;
  extern __shared__ float partials[];  // [bag slot][warp 1..k-1][chunk]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps_per_bag = 1 << log2_warps;
  const int slot = warp >> log2_warps;  // the block's bag this warp sums
  const int part = warp & (warps_per_bag - 1);  // its slice of that bag
  const int bag = (blockIdx.x << (3 - log2_warps)) + slot;  // 8 warps a block
  const bool live = bag < batch;  // warp-uniform; dead warps still sync
  const int lanes_per_row = 1 << log2_lanes;
  const int groups = 32 >> log2_lanes;
  const int group = lane >> log2_lanes;
  const int sub = lane & (lanes_per_row - 1);
  const int chunk = lanes_per_row * VEC;
  // this bag's ids are idx[first, first + bag_nnz) (RG: its feature's
  // slice of its sample's row)
  int64_t first = static_cast<int64_t>(bag) * nnz;
  int bag_nnz = nnz;
  if constexpr (RG) {
    const int b = bag / nfeat;
    const int f = bag - b * nfeat;
    first = static_cast<int64_t>(b) * nnz + (live ? bag_offsets[f] : 0);
    bag_nnz = live ? bag_offsets[f + 1] - bag_offsets[f] : 0;
  }
  const int j0 = static_cast<int>((static_cast<int64_t>(part) * bag_nnz) >>
                                  log2_warps);
  const int j1 = static_cast<int>(
      (static_cast<int64_t>(part + 1) * bag_nnz) >> log2_warps);
  float* mine = partials + (slot * (warps_per_bag - 1) + max(part - 1, 0)) *
                               chunk + sub * VEC;
  const float* theirs =
      partials + slot * (warps_per_bag - 1) * chunk + sub * VEC;

  for (int c0 = 0; c0 < dim; c0 += chunk) {
    const int col = c0 + sub * VEC;
    const bool valid = live && col < dim;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    for (int r0 = j0; live && r0 < j1; r0 += 32) {
      const int n = min(32, j1 - r0);
      // one coalesced load of this round's ids and weights; each id is
      // wrapped, checked and turned into its row's element offset here,
      // once (-1: outside the table), so a row load waits on one shuffle.
      // A round of no more ids than lane groups (a slice's last, say) has
      // each group's lanes load their one id themselves: no shuffle.
      const bool direct = n <= groups;  // warp-uniform
      const int mine_j = direct ? group : lane;
      long long my_off = -1;
      float my_w = 1.f;
      if (mine_j < n) {
        const int id = idx[first + r0 + mine_j];
        const long long row = id < 0 ? id + num_rows : id;
        if (row >= 0 && row < num_rows) my_off = row * dim;
        if (W) my_w = weights[first + r0 + mine_j];
      }
      for (int b0 = 0; b0 < n; b0 += groups * U) {
        // group g takes ids b0 + g, b0 + g + groups, ...: U loads issued
        // before any add
        typename IO::Raw v[U];
        float w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = b0 + u * groups + group;
          const long long off =
              direct ? my_off : __shfl_sync(kFull, my_off, j & 31);
          w[u] = !W ? 1.f : direct ? my_w : __shfl_sync(kFull, my_w, j & 31);
          v[u] = IO::nan();
          if (valid && j < n && off >= 0) v[u] = IO::load(table + off + col);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (b0 + u * groups + group < n) {
            float x[VEC];
            IO::unpack(v[u], x);
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] = W ? acc[k] + x[k] * w[u]
                                                     : acc[k] + x[k];
          }
        }
      }
    }
    // sum the lane groups: lanes sub, sub + lanes_per_row, ... hold the
    // partial sums of the same columns
    for (int off = lanes_per_row; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        acc[k] += __shfl_xor_sync(kFull, acc[k], off);
    }
    if (warps_per_bag > 1) {  // block-uniform
      if (part > 0 && group == 0 && valid) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) mine[k] = acc[k];
      }
      __syncthreads();
      if (part == 0 && group == 0 && valid) {
        for (int p = 1; p < warps_per_bag; ++p) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += theirs[(p - 1) * chunk + k];
        }
      }
      __syncthreads();  // the next chunk reuses the slots
    }
    if (part == 0 && group == 0 && valid) {
      IO::store(out + static_cast<int64_t>(bag) * dim + col, acc);
    }
  }
}

// Bags of at most one id a lane group, one chunk a row, one warp a bag
// (small bags of narrow rows, as configs/basic_ops.json's table): each
// group loads its id and its row itself.  emb_gather_kernel's walk spends
// more instructions than such a bag has bytes to hide them behind.
template <typename T, int VEC, bool W>
__global__ void __launch_bounds__(kBlockThreads)
emb_gather_small_kernel(const T* __restrict__ table,
                        const int32_t* __restrict__ idx,
                        const float* __restrict__ weights,
                        T* __restrict__ out, int64_t num_rows, int batch,
                        int nnz, int dim, int log2_lanes) {
  using IO = RowIO<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * (kBlockThreads / 32) + (threadIdx.x >> 5);
  if (bag >= batch) return;  // whole warp leaves together
  const int group = lane >> log2_lanes;
  const int col = (lane & ((1 << log2_lanes) - 1)) * VEC;
  const int64_t first = static_cast<int64_t>(bag) * nnz;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  if (group < nnz) {
    const int id = idx[first + group];
    const long long row = id < 0 ? id + num_rows : id;
    typename IO::Raw v = IO::nan();
    if (row >= 0 && row < num_rows && col < dim) {
      v = IO::load(table + row * dim + col);
    }
    const float w = W ? weights[first + group] : 1.f;
    IO::unpack(v, acc);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = W ? acc[k] * w : acc[k];
  }
  for (int off = 1 << log2_lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      acc[k] += __shfl_xor_sync(kFull, acc[k], off);
  }
  if (group == 0 && col < dim) {
    IO::store(out + static_cast<int64_t>(bag) * dim + col, acc);
  }
}

template <typename T, int VEC, int U, bool RG>
void launch_w(const T* table, const int32_t* idx, const float* weights,
              T* out, int64_t num_rows, int batch, int nnz, int dim,
              int log2_lanes, int log2_warps, const int32_t* bag_offsets,
              int nfeat, dim3 grid, size_t smem, cudaStream_t s) {
  if (weights) {
    emb_gather_kernel<T, VEC, U, true, RG><<<grid, kBlockThreads, smem, s>>>(
        table, idx, weights, out, num_rows, batch, nnz, dim, log2_lanes,
        log2_warps, bag_offsets, nfeat);
  } else {
    emb_gather_kernel<T, VEC, U, false, RG><<<grid, kBlockThreads, smem, s>>>(
        table, idx, weights, out, num_rows, batch, nnz, dim, log2_lanes,
        log2_warps, bag_offsets, nfeat);
  }
}

template <typename T, int VEC, int U>
void launch_u(const T* table, const int32_t* idx, const float* weights,
              T* out, int64_t num_rows, int batch, int nnz, int dim,
              int log2_lanes, int log2_warps, const int32_t* bag_offsets,
              int nfeat, dim3 grid, size_t smem, cudaStream_t s) {
  if (bag_offsets) {
    launch_w<T, VEC, U, true>(table, idx, weights, out, num_rows, batch, nnz,
                              dim, log2_lanes, log2_warps, bag_offsets, nfeat,
                              grid, smem, s);
  } else {
    launch_w<T, VEC, U, false>(table, idx, weights, out, num_rows, batch, nnz,
                               dim, log2_lanes, log2_warps, nullptr, 1, grid,
                               smem, s);
  }
}

int log2_of(int x) {  // log2 of a power of two in [1, 32], else -1
  for (int k = 0; k <= 5; ++k)
    if (x == (1 << k)) return k;
  return -1;
}

template <typename T, int VEC>
int launch(const T* table, const int32_t* idx, const float* weights, T* out,
           int64_t num_rows, int batch, int nnz, int dim, int lanes,
           int warps_per_bag, int rows_in_flight,
           const int32_t* bag_offsets, int nfeat, cudaStream_t stream) {
  const int log2_lanes = log2_of(lanes);
  const int log2_warps = log2_of(warps_per_bag);
  if (log2_lanes < 0 || log2_warps < 0 || warps_per_bag > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bag_offsets && (nfeat <= 0 || batch % nfeat != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const int bags_per_block = kBlockThreads / 32 / warps_per_bag;
  const dim3 grid((batch + bags_per_block - 1) / bags_per_block);
  if (!bag_offsets && warps_per_bag == 1 && nnz <= 32 / lanes &&
      dim <= lanes * VEC) {
    if (weights) {
      emb_gather_small_kernel<T, VEC, true><<<grid, kBlockThreads, 0,
                                              stream>>>(
          table, idx, weights, out, num_rows, batch, nnz, dim, log2_lanes);
    } else {
      emb_gather_small_kernel<T, VEC, false><<<grid, kBlockThreads, 0,
                                               stream>>>(
          table, idx, weights, out, num_rows, batch, nnz, dim, log2_lanes);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * bags_per_block * (warps_per_bag - 1) *
                      lanes * VEC;
#define K1_LAUNCH(U)                                                        \
  launch_u<T, VEC, U>(table, idx, weights, out, num_rows, batch, nnz, dim,  \
                      log2_lanes, log2_warps, bag_offsets, nfeat, grid, smem, \
                      stream)
  switch (rows_in_flight) {
    case 1: K1_LAUNCH(1); break;
    case 2: K1_LAUNCH(2); break;
    case 4: K1_LAUNCH(4); break;
    case 8: K1_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K1_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vec: 1 (any D, any alignment) or 16-byte vectors (4 f32 / 8 bf16; needs
// D % that == 0 and 16-byte aligned table and out).  lanes, warps_per_bag
// and rows_in_flight: emb_gather_schedule's launch shape (lanes a row, a
// power of two up to 32; warps a bag 1, 2, 4 or 8; row loads in flight a
// lane group 1, 2, 4 or 8).  bag_offsets: null for `batch` bags of nnz ids
// each; else nfeat + 1 int32 offsets on the device, `batch` a multiple of
// nfeat, and the ids batch / nfeat rows of nnz per-feature bags (the notes
// at the top).
int emb_gather_f32(const void* table, const void* idx, const void* weights,
                   void* out, long long num_rows, int batch, int nnz, int dim,
                   int vec, int lanes, int warps_per_bag, int rows_in_flight,
                   const void* bag_offsets, int nfeat, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  const auto* off = static_cast<const int32_t*>(bag_offsets);
  if (vec == 4)
    return launch<float, 4>(t, i, w, o, num_rows, batch, nnz, dim, lanes,
                            warps_per_bag, rows_in_flight, off, nfeat, s);
  return launch<float, 1>(t, i, w, o, num_rows, batch, nnz, dim, lanes,
                          warps_per_bag, rows_in_flight, off, nfeat, s);
}

int emb_gather_bf16(const void* table, const void* idx, const void* weights,
                    void* out, long long num_rows, int batch, int nnz,
                    int dim, int vec, int lanes, int warps_per_bag,
                    int rows_in_flight, const void* bag_offsets, int nfeat,
                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const __nv_bfloat16*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const auto* off = static_cast<const int32_t*>(bag_offsets);
  if (vec == 8)
    return launch<__nv_bfloat16, 8>(t, i, w, o, num_rows, batch, nnz, dim,
                                    lanes, warps_per_bag, rows_in_flight, off,
                                    nfeat, s);
  return launch<__nv_bfloat16, 1>(t, i, w, o, num_rows, batch, nnz, dim,
                                  lanes, warps_per_bag, rows_in_flight, off,
                                  nfeat, s);
}

}  // extern "C"
