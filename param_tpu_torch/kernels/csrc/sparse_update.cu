// K2: in-place sparse row update of a flat (R, D) f32 table.
//
//   SGD:      T[i] += u
//   Adagrad:  a = A[i] + u*u;  A[i] = a;
//             T[i] += (-lr * u) * (a > 0 ? rsqrt(a + eps) : 0)
//
// (the optax scale_by_rss form: eps inside the square root, gated on a > 0)
//
// Replaces the TPU kernel param_tpu/ops/sparse_update.py::_update_kernel
// (via sparse_row_update), which double-buffers per-row DMA reads and
// writes between HBM and VMEM and diverts dropped slots to a trash buffer.
//
// What bounds it on an H100: bytes.  Each valid update reads its row of
// u, T (and A) and writes T (and A): 3 (5) row transfers of D*4 bytes, one
// to four flops per element.  Rows are random, so the kernel needs many
// independent 16-byte loads in flight.
//
// Design: one warp per update row, lanes across D with float4 accesses
// where D % 4 == 0 (else one float per lane), looping over D in chunks of
// 32 * VEC.  idx must be duplicate-free (the caller segment-sums duplicates
// first), so every table row has one writer and no atomics are needed.
// Ids outside [0, R) are dropped: the warp returns before touching memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int VEC>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (VEC == 4) {
    float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <bool ADAGRAD, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sparse_update_kernel(float* __restrict__ table, float* __restrict__ acc,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ upd, int64_t num_rows, int n,
                     int dim, float lr, float eps) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const int64_t row = idx[i];
  if (row < 0 || row >= num_rows) return;  // dropped slot
  float* t_row = table + row * dim;
  float* a_row = ADAGRAD ? acc + row * dim : nullptr;
  const float* u_row = upd + static_cast<int64_t>(i) * dim;

  for (int col = lane * VEC; col < dim; col += 32 * VEC) {
    float u[VEC], t[VEC];
    load<VEC>(u_row + col, u);
    load<VEC>(t_row + col, t);
    if constexpr (ADAGRAD) {
      float a[VEC];
      load<VEC>(a_row + col, a);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float a_new = a[k] + u[k] * u[k];
        const float factor = a_new > 0.f ? rsqrtf(a_new + eps) : 0.f;
        a[k] = a_new;
        t[k] = t[k] + (-lr * u[k]) * factor;
      }
      store<VEC>(a_row + col, a);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) t[k] = t[k] + u[k];
    }
    store<VEC>(t_row + col, t);
  }
}

template <bool ADAGRAD>
int launch(float* table, float* acc, const int32_t* idx, const float* upd,
           int64_t num_rows, int n, int dim, int vec, float lr, float eps,
           cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const int threads = kWarpsPerBlock * 32;
    if (vec == 4) {
      sparse_update_kernel<ADAGRAD, 4><<<blocks, threads, 0, stream>>>(
          table, acc, idx, upd, num_rows, n, dim, lr, eps);
    } else {
      sparse_update_kernel<ADAGRAD, 1><<<blocks, threads, 0, stream>>>(
          table, acc, idx, upd, num_rows, n, dim, lr, eps);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vec: 1 (any D) or 4 (D % 4 == 0 and 16-byte aligned table, acc, upd).
int sparse_update_sgd_f32(void* table, const void* idx, const void* upd,
                          long long num_rows, int n, int dim, int vec,
                          void* stream) {
  return launch<false>(static_cast<float*>(table), nullptr,
                       static_cast<const int32_t*>(idx),
                       static_cast<const float*>(upd), num_rows, n, dim, vec,
                       0.f, 0.f, static_cast<cudaStream_t>(stream));
}

int sparse_update_adagrad_f32(void* table, void* acc, const void* idx,
                              const void* upd, long long num_rows, int n,
                              int dim, int vec, float lr, float eps,
                              void* stream) {
  return launch<true>(static_cast<float*>(table), static_cast<float*>(acc),
                      static_cast<const int32_t*>(idx),
                      static_cast<const float*>(upd), num_rows, n, dim, vec,
                      lr, eps, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
