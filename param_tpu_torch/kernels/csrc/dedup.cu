// The dedup's segment sum: one summed gradient row per distinct table row
// of a DLRM sparse step, read straight from the pooled gradient.
//
// A step's N = M * nnz lookups (M bags of nnz row ids, in the flat (T*E, D)
// view of the tables) all carry their bag's row of the pooled gradient
// g (M, D).  After a stable sort of the ids (order: the lookup at each
// sorted position; sidx: its id; run_no: the run it belongs to, counted
// from 1, the cumulative count of run starts), this computes for each run u
// (one distinct id)
//
//   totals[u] = sum over its lookups j, in sorted order, of
//               scale * g[order[j] / nnz]
//   rows[u]   = its id
//
// and fills rows[U:N] with drop_marker and totals[U:N] with zeros, where
// U = run_no[N - 1] is the number of runs.
//
// Bags of per-feature sizes (multi-hot features of fixed, unequal sizes;
// RG = true): the lookups come as rows of nnz ids, one a sample, each
// feature's bag a slice of its sample's row, and g holds nfeat bags a
// sample.  Lookup i = b * nnz + j then carries bag b * nfeat + feat[j]
// (`col_feat`, nnz entries) in place of i / nnz.  The fixed-nnz kernels
// (RG = false) are built apart, so their code is what it was.
//
// Replaces no TPU kernel: the JAX package's dedup (param_tpu/ops/
// sparse_update.py::dedup_row_updates) is XLA's sort and segment sum over
// one gradient row a lookup.  Built from PyTorch's ops, that chain expanded
// g to (N, D), gathered it in sorted order, zeroed an (N, D) buffer and
// added into it with atomics: about 17 GB of HBM traffic at 13.1M lookups
// of 64 floats.  Here the per-lookup rows are never built.
//
// What bounds it on an H100: bytes.  Every output row is written once (the
// sums and the zero tail), and each lookup reads its bag's row of g.  With
// nnz > 1 a bag's row is read nnz times; g then fits in the 50 MB L2 at the
// benchmark's widths, so the output is written with streaming stores
// (evict first) to leave L2 to g.
//
// Design.  The sorted positions are cut into chunks of `chunk` positions
// (dedup.py's CHUNK, a multiple of kUnroll).  A group of `lanes` lanes
// (vec-wide accesses across D) walks one chunk in order with kUnroll row
// loads in flight a lane, adds the rows in f32 registers, and writes each
// run that ends inside the chunk once.  A run that crosses the end of chunk
// c leaves the chunk's part in carry[c], with the run's output row in
// key[c] (-1 where no run crosses); its last chunk writes its own part to
// totals.  Chunk c also writes its share of the tail, output rows
// [max(U, c * chunk), (c + 1) * chunk).
//
// The carries are then added up a tree of fixed shape: each level cuts its
// entries into groups of `group` (dedup.py's GROUP), one lane group a
// group walks its entries in order, adds to totals the runs whose entries
// end in it, and leaves the part of the run that goes on past its end as
// one entry of the next level, until a level has one group.  So a lane
// group adds at most `group` rows a level, the levels are
// ceil(log_group(N / chunk)) whatever the runs' lengths (a hot row of a
// zipf table is as fast as a short one), and the launches depend on N
// alone (static, as a CUDA graph needs).  No atomics touch the sums: the
// order of every addition is fixed, so the result is the same bits from
// call to call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 4;   // row loads in flight a lane
constexpr int kThreads = 256;

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float* v) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

template <int VEC, bool RG>
__global__ void __launch_bounds__(kThreads)
dedup_sum_chunks(const float* __restrict__ g, const int64_t* __restrict__ order,
                 const int32_t* __restrict__ sidx,
                 const int32_t* __restrict__ run_no, int n, int nnz, int dim,
                 int chunk, int lanes, float scale, int32_t drop_marker,
                 int32_t* __restrict__ rows, float* __restrict__ totals,
                 float* __restrict__ carry, int32_t* __restrict__ key,
                 const int32_t* __restrict__ col_feat, int nfeat) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int c = t / lanes;
  const int lane = t % lanes;
  const int p0 = c * chunk;
  if (p0 >= n) return;
  const int p1 = min(n, p0 + chunk);

  const float zero[VEC] = {};
  for (int q = max(run_no[n - 1], p0); q < p1; ++q) {  // the tail
    if (lane == 0) __stcs(rows + q, drop_marker);
    for (int col = lane * VEC; col < dim; col += lanes * VEC) {
      store_row<VEC>(totals + static_cast<int64_t>(q) * dim + col, zero);
    }
  }

  const bool carried_out = p1 < n && sidx[p1] == sidx[p1 - 1];
  if (lane == 0) key[c] = carried_out ? run_no[p1 - 1] - 1 : -1;
  for (int col = lane * VEC; col < dim; col += lanes * VEC) {
    float acc[VEC] = {};
    for (int p = p0; p < p1; p += kUnroll) {
      float v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u < p1) {
          const int at = static_cast<int>(order[p + u]);
          int bag = at / nnz;
          if constexpr (RG) bag = bag * nfeat + col_feat[at - bag * nnz];
          load_row<VEC>(g + static_cast<int64_t>(bag) * dim + col, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = p + u;
        if (q >= p1) break;
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += __fmul_rn(scale, v[u][k]);
        const int32_t id = sidx[q];
        if (q + 1 == n || sidx[q + 1] != id) {  // the run ends here
          const int64_t out = run_no[q] - 1;
          store_row<VEC>(totals + out * dim + col, acc);
          if (col == 0) __stcs(rows + out, id);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
        }
      }
    }
    if (carried_out) {
      float* dst = carry + static_cast<int64_t>(c) * dim + col;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2],
                                                      acc[3]);
      } else {
        *dst = acc[0];
      }
    }
  }
}

// One level of the carries' tree: a lane group for each group of `group`
// entries of (vals, keys), k entries in all.  A run's entries are
// consecutive.  The lane group adds its entries in order, run by run; a run
// whose entries end in the group adds its sum to totals[key], and the run
// of the group's last entry, if its entries go on into the next group,
// leaves its sum as the next level's entry (next_vals, next_keys)[g].
// `carried`, when given (the first level), counts the runs that start.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
dedup_sum_carries(const float* __restrict__ vals,
                  const int32_t* __restrict__ keys, int k, int dim,
                  int group, int lanes, float* __restrict__ next_vals,
                  int32_t* __restrict__ next_keys,
                  float* __restrict__ totals, int32_t* __restrict__ carried) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int g = t / lanes;
  const int lane = t % lanes;
  const int i0 = g * group;
  if (i0 >= k) return;
  const int i1 = min(k, i0 + group);
  const int32_t last = keys[i1 - 1];
  const bool goes_on = last >= 0 && i1 < k && keys[i1] == last;
  if (lane == 0) {
    next_keys[g] = goes_on ? last : -1;
    if (carried != nullptr) {
      int starts = 0;
      for (int i = i0; i < i1; ++i) {
        starts += keys[i] >= 0 && (i == 0 || keys[i - 1] != keys[i]);
      }
      if (starts != 0) atomicAdd(carried, starts);
    }
  }
  for (int col = lane * VEC; col < dim; col += lanes * VEC) {
    float acc[VEC] = {};
    for (int i = i0; i < i1; i += kUnroll) {
      float v[kUnroll][VEC];
      int32_t key[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        key[u] = i + u < i1 ? keys[i + u] : -1;
        if (key[u] >= 0) {
          load_row<VEC>(vals + static_cast<int64_t>(i + u) * dim + col, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (key[u] < 0) continue;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += v[u][j];
        const int q = i + u;
        if (q + 1 < i1 ? keys[q + 1] != key[u] : !goes_on) {  // run ends
          float* dst = totals + static_cast<int64_t>(key[u]) * dim + col;
          float w[VEC];
          load_row<VEC>(dst, w);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            w[j] += acc[j];
            acc[j] = 0.f;
          }
          store_row<VEC>(dst, w);
        }
      }
    }
    if (goes_on) {
      float* dst = next_vals + static_cast<int64_t>(g) * dim + col;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2],
                                                      acc[3]);
      } else {
        *dst = acc[0];
      }
    }
  }
}

template <int VEC>
int launch(const float* g, const int64_t* order, const int32_t* sidx,
           const int32_t* run_no, int n, int nnz, int dim, int chunk,
           int group, int lanes, float scale, int32_t drop_marker,
           int32_t* rows, float* totals, float* carry, int32_t* key,
           int32_t* carried, const int32_t* col_feat, int nfeat,
           cudaStream_t stream) {
  const int chunks = (n + chunk - 1) / chunk;
  const int64_t threads = static_cast<int64_t>(chunks) * lanes;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (col_feat) {
    dedup_sum_chunks<VEC, true><<<blocks, kThreads, 0, stream>>>(
        g, order, sidx, run_no, n, nnz, dim, chunk, lanes, scale, drop_marker,
        rows, totals, carry, key, col_feat, nfeat);
  } else {
    dedup_sum_chunks<VEC, false><<<blocks, kThreads, 0, stream>>>(
        g, order, sidx, run_no, n, nnz, dim, chunk, lanes, scale, drop_marker,
        rows, totals, carry, key, nullptr, 1);
  }
  // levels alternate between carry[0, chunks) and carry[chunks, ...)
  float* vals = carry;
  int32_t* keys = key;
  float* next_vals = carry + static_cast<int64_t>(chunks) * dim;
  int32_t* next_keys = key + chunks;
  for (int k = chunks; k > 1; k = (k + group - 1) / group) {
    const int64_t t = static_cast<int64_t>((k + group - 1) / group) * lanes;
    dedup_sum_carries<VEC><<<(t + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(vals, keys, k, dim, group, lanes,
                                       next_vals, next_keys, totals, carried);
    carried = nullptr;
    float* v = vals;
    vals = next_vals;
    next_vals = v;
    int32_t* kk = keys;
    keys = next_keys;
    next_keys = kk;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// g (M, dim) f32; order (n,) int64, sidx and run_no (n,) int32, n >= 1;
// rows (n,) int32, totals (n, dim) f32; carry (C + ceil(C / group), dim)
// f32 and key (C + ceil(C / group),) int32 with C = ceil(n / chunk);
// carried: an int32 the carried runs are added to, or null; col_feat: null
// for bags of nnz ids (lookup i's bag i / nnz), or nnz int32 features on
// the device for rows of nnz per-feature ids (bag (i / nnz) * nfeat +
// col_feat[i % nnz]; the notes at the top).  chunk a
// multiple of kUnroll, group >= 2; vec 4 needs dim % 4 == 0 and 16-byte
// aligned g, totals and carry; lanes a power of two from 1 to 32.
int dedup_sum_f32(const void* g, const void* order, const void* sidx,
                  const void* run_no, int n, int nnz, int dim, int chunk,
                  int group, int vec, int lanes, float scale,
                  int drop_marker, void* rows, void* totals, void* carry,
                  void* key, void* carried, const void* col_feat, int nfeat,
                  void* stream) {
  auto f = vec == 4 ? &launch<4> : &launch<1>;
  return f(static_cast<const float*>(g), static_cast<const int64_t*>(order),
           static_cast<const int32_t*>(sidx),
           static_cast<const int32_t*>(run_no), n, nnz, dim, chunk, group,
           lanes, scale, drop_marker, static_cast<int32_t*>(rows),
           static_cast<float*>(totals), static_cast<float*>(carry),
           static_cast<int32_t*>(key), static_cast<int32_t*>(carried),
           static_cast<const int32_t*>(col_feat), nfeat,
           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
