// K1: sum-pooled embedding bag, out[b] = sum_j w[b,j] * table[idx[b,j]].
//
// Replaces the TPU kernel param_tpu/ops/embedding.py::_emb_gather_kernel
// (via embedding_bag_pallas), which double-buffers one DMA per table row
// from HBM into VMEM and sum-pools on the vector unit.
//
// What bounds it on an H100: bytes.  Each bag reads nnz random rows of
// D*esize bytes (256 B at the DLRM shape, 512 B at the 1M x 128 headline)
// and writes one row; the arithmetic is one add per element read.  Random
// row reads waste nothing as long as each row is read as whole 32 B
// sectors with many reads in flight.
//
// Design: one warp per bag.  A row is read with 16-byte vector loads by
// `lanes_per_row` lanes (D / VEC of them, e.g. 16 for D=64 f32), so a warp
// holds 32 / lanes_per_row rows in flight at once; each lane group walks a
// strided subset of the bag's nnz rows with an f32 accumulator, and the
// groups are summed with warp shuffles at the end.  When D does not fit
// that shape the warp strides over the row in chunks of 32 * VEC columns.
// No shared memory, no atomics: bags are independent.  Indices are int32;
// as in the reference's jnp.take, an id in [-rows, 0) counts from the end
// and any other id outside [0, rows) makes its bag NaN (and is never read).
// Weights (optional) are f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T, int VEC>
struct RowIO;

template <>
struct RowIO<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct RowIO<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *p = v[0];
  }
};

template <>
struct RowIO<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
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
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(p[0]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
emb_gather_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                  const float* __restrict__ weights, T* __restrict__ out,
                  int64_t num_rows, int batch, int nnz, int dim,
                  int lanes_per_row) {
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= batch) return;  // whole warp leaves together
  const int groups = 32 / lanes_per_row;
  const int group = lane / lanes_per_row;
  const int sub = lane % lanes_per_row;
  const int32_t* bag_idx = idx + static_cast<int64_t>(bag) * nnz;
  const float* bag_w =
      weights ? weights + static_cast<int64_t>(bag) * nnz : nullptr;
  const int chunk = lanes_per_row * VEC;

  for (int c0 = 0; c0 < dim; c0 += chunk) {
    const int col = c0 + sub * VEC;
    const bool valid = col < dim;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    if (valid) {
      for (int j = group; j < nnz; j += groups) {
        int64_t row = bag_idx[j];
        if (row < 0) row += num_rows;
        float v[VEC];
        if (row >= 0 && row < num_rows) {
          RowIO<T, VEC>::load(table + row * dim + col, v);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[k] = __int_as_float(0x7fc00000);
        }
        const float w = bag_w ? bag_w[j] : 1.f;
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = bag_w ? acc[k] + v[k] * w
                                                    : acc[k] + v[k];
      }
    }
    // sum the lane groups: lanes sub, sub + lanes_per_row, ... hold the
    // partial sums of the same columns
    for (int off = lanes_per_row; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
    if (valid && group == 0) {
      RowIO<T, VEC>::store(out + static_cast<int64_t>(bag) * dim + col, acc);
    }
  }
}

template <typename T, int VEC>
int launch(const T* table, const int32_t* idx, const float* weights, T* out,
           int64_t num_rows, int batch, int nnz, int dim, cudaStream_t stream) {
  // lanes per row: D/VEC when that divides the warp, else the whole warp
  int lanes = 32;
  const int vecs = dim / VEC;
  if (dim % VEC == 0 && vecs <= 32 && (32 % vecs) == 0) lanes = vecs;
  if (batch > 0) {
    const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
    emb_gather_kernel<T, VEC><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        table, idx, weights, out, num_rows, batch, nnz, dim, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vec: 1 (any D, any alignment) or 16-byte vectors (4 f32 / 8 bf16;
// needs D % that == 0 and 16-byte aligned table and out).
int emb_gather_f32(const void* table, const void* idx, const void* weights,
                   void* out, long long num_rows, int batch, int nnz, int dim,
                   int vec, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  if (vec == 4) return launch<float, 4>(t, i, w, o, num_rows, batch, nnz, dim, s);
  return launch<float, 1>(t, i, w, o, num_rows, batch, nnz, dim, s);
}

int emb_gather_bf16(const void* table, const void* idx, const void* weights,
                    void* out, long long num_rows, int batch, int nnz,
                    int dim, int vec, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const __nv_bfloat16*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (vec == 8)
    return launch<__nv_bfloat16, 8>(t, i, w, o, num_rows, batch, nnz, dim, s);
  return launch<__nv_bfloat16, 1>(t, i, w, o, num_rows, batch, nnz, dim, s);
}

}  // extern "C"
