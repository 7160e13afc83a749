// K6: flash-attention forward, O = softmax(scale * Q K^T + mask) V with an
// online-softmax recurrence, f32 accumulation, and optionally the per-row
// logsumexp lse = m + log(l) in f32, shape (B, H, S_q).
//
// Replaces the TPU kernels param_tpu/ops/attention.py::_flash_kernel (a
// rectangular (B*H, q blocks, kv blocks) grid, (m, l, acc) carried in VMEM
// across the sequential kv axis) and ::_flash_kernel_causal (the same tile
// body over a compacted list of lower-triangle tiles fed by scalar
// prefetch), with their tile bodies _online_softmax_tile and _fwd_finalize.
// Both are two schedules of one function.  Here a block owns one q tile of
// one (batch, head) and loops over exactly the kv tiles its rows attend:
// [0, S_k) without causal; with causal the diagonal is aligned bottom-right
// (diag_off = S_k - S_q, row r keeps columns c <= r + diag_off) and, with a
// sliding window W, also c > r + diag_off - W, so a row's first tile is not
// tile 0.  Only tiles that straddle the band's edges, or the ragged end of
// S_k, are masked; rows past S_q are computed on zeros and not stored.
// GQA: query head h reads kv head h / (H / H_kv); K and V are never
// repeated.  Masked scores are -inf, and a row with no unmasked column yet
// gets p = 0 (the TPU kernel's -1e30 and explicit p = 0).  P is cast to
// V's dtype before the PV product, unnormalised, as in the TPU kernel; the
// row sum l is taken in f32 before the cast.
//
// What bounds it on an H100: operations for the shapes of the main path
// (4 S_q S_k D per head, less the masked area, over 989 TF/s in bf16 and
// f16, or 67 TF/s in f32 outside the tensor cores); bytes (Q, K, V read
// once and O written once, over 3.35 TB/s) only for short sequences.
//
// Design, bf16/f16: 4 warps per block, 64 q rows (16 per warp) and kv tiles
// of 64 rows.  Q, K and V tiles are staged in shared memory with 16-byte
// cp.async copies (zero-filled past S_q / S_k; rows padded by 8 elements so
// that ldmatrix is free of bank conflicts); V_j is copied while S = Q K_j^T
// is computed, and K_{j+1} while P V_j is.  Q stays in registers as mma.sync
// A fragments for the whole walk.  S and O are mma.sync m16n8k16 with f32
// accumulators; the S accumulators of a warp are already the A fragments of
// P for the PV product once packed to bf16/f16.  Row max and sum are
// reduced over the 4 lanes that share a row.  Exponentials are exp2 of
// scores pre-scaled by scale * log2(e).  q tiles are issued last first, so
// the longest causal rows start first.  O is written through shared memory
// in 16-byte chunks.
// f32: a plain CUDA-core kernel in full f32 (no TF32): 32 q rows and kv
// tiles of 32 rows per block of 128 threads; 4 threads share a q row, each
// computes 8 of its scores and owns D/4 of its output columns.
//
// Not used: wgmma, TMA, warp specialisation, keeping P in registers across
// a producer/consumer split (later work).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;       // (B, H, S_q, D), contiguous
  float* lse;    // (B, H, S_q) or null
  int B, H, Hkv, Sq, Sk;
  // element strides of batch, head and sequence; the last dim is contiguous
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale_log2;  // scale * log2(e)
  int causal;
  int window;  // 0: none
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// kv tiles [j0, j1) of width bn that rows [q0, q0 + bm) attend.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int bm,
                                         int bn, int& j0, int& j1) {
  int lo = 0, hi = p.Sk;
  if (p.causal) {
    const int diag = p.Sk - p.Sq;
    const int last_row = min(q0 + bm, p.Sq) - 1;
    hi = min(hi, last_row + diag + 1);
    if (p.window > 0) lo = max(0, q0 + diag - p.window + 1);
  }
  j0 = lo / bn;
  j1 = (hi + bn - 1) / bn;
}

// Whether the (bm x bn) tile at (q0, c0) has any masked element.
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int c0, int bm, int bn) {
  if (c0 + bn > p.Sk) return true;
  if (!p.causal) return false;
  const int diag = p.Sk - p.Sq;
  if (c0 + bn - 1 > q0 + diag) return true;  // above the smallest row's edge
  return p.window > 0 && c0 <= q0 + bm - 1 + diag - p.window;
}

__device__ __forceinline__ bool keep(const Params& p, int r, int c) {
  if (c >= p.Sk) return false;
  if (!p.causal) return true;
  const int diag = p.Sk - p.Sq;
  return c <= r + diag && (p.window <= 0 || c > r + diag - p.window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------ tensor-core path
constexpr int BM = 64, BN = 64, THREADS = 128, PAD = 8;

// Copy rows [r0, r0 + 64) of a (rows, D) slice into a padded shared tile,
// 16 bytes per copy, zero-filling rows at or past n_rows.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long row_stride, int r0,
                                          int n_rows, int tid) {
  constexpr int STRIDE = D + PAD, CHUNKS = D / 8;
#pragma unroll
  for (int c = tid; c < 64 * CHUNKS; c += THREADS) {
    const int row = c / CHUNKS, col = (c % CHUNKS) * 8;
    const bool ok = r0 + row < n_rows;
    const T* s = ok ? src + (long long)(r0 + row) * row_stride + col : src;
    cp_async16(dst + row * STRIDE + col, s, ok);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_tc(const Params p) {
  constexpr int STRIDE = D + PAD;
  constexpr int DK = D / 16;   // k16 steps of Q K^T
  constexpr int NS = BN / 8;   // n8 tiles of S
  constexpr int NO = D / 8;    // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  T* const qs = reinterpret_cast<T*>(smem);
  T* const ks = qs + BM * STRIDE;
  T* const vs = ks + BN * STRIDE;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<T, D>(qs, qg, p.q_ss, q0, p.Sq, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * 16 + lane % 16) * STRIDE + kk * 16 +
                            (lane / 16) * 8);

  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8

  int j0, j1;
  kv_range(p, q0, BM, BN, j0, j1);
  if (j0 < j1) load_tile<T, D>(ks, kg, p.k_ss, j0 * BN, p.Sk, tid);
  cp_async_commit();
  for (int j = j0; j < j1; ++j) {
    const int c0 = j * BN;
    // V_j lands while S is computed; the V buffer was released by the
    // barrier that ended the previous step
    load_tile<T, D>(vs, vg, p.v_ss, c0, p.Sk, tid);
    cp_async_commit();
    cp_async_wait1();  // K_j has landed
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (np * 16 + lane % 8 + (lane / 16) * 8) * STRIDE +
                           kk * 16 + ((lane / 8) % 2) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        Mma<T>::run(s[2 * np], qf[kk], b0);
        Mma<T>::run(s[2 * np + 1], qf[kk], b1);
      }
    }
    __syncthreads();  // every warp is done with K_j
    if (j + 1 < j1) load_tile<T, D>(ks, kg, p.k_ss, c0 + BN, p.Sk, tid);
    cp_async_commit();  // possibly empty: keeps the group count uniform

    const bool masked = tile_needs_mask(p, q0, c0, BM, BN);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * p.scale_log2;
        if (masked && !keep(p, row0 + (e / 2) * 8, c0 + i * 8 + 2 * t4 + e % 2))
          x = -INFINITY;
        s[i][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float m_use[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      // a row with nothing unmasked yet keeps m = -inf: p = 0, alpha = 0
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
    }
    uint32_t pf[BN / 16][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p0 = exp2f(s[i][0] - m_use[0]);
      const float p1 = exp2f(s[i][1] - m_use[0]);
      const float p2 = exp2f(s[i][2] - m_use[1]);
      const float p3 = exp2f(s[i][3] - m_use[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      // n8 tile i is the k index range [8 (i % 2), +8) of P's k16 step i / 2
      pf[i / 2][(i % 2) * 2] = pack2<T>(p0, p1);
      pf[i / 2][(i % 2) * 2 + 1] = pack2<T>(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    cp_async_wait1();  // V_j has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < D / 16; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                      STRIDE +
                                  nj * 16 + (lane / 16) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        Mma<T>::run(o[2 * nj], pf[kk], b0);
        Mma<T>::run(o[2 * nj + 1], pf[kk], b1);
      }
    }
    __syncthreads();  // every warp is done with V_j
  }
  cp_async_wait_all();

  // epilogue: O / l through this warp's 16 rows of the (free) Q tile
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  T* tile = qs + warp * 16 * STRIDE;
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(&tile[(g + r * 8) * STRIDE + i * 8 +
                                         2 * t4]) =
          pack2<T>(o[i][2 * r] * inv[r], o[i][2 * r + 1] * inv[r]);
  __syncwarp();
  T* og = static_cast<T*>(p.o) + (long long)bh * p.Sq * D;
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int c = lane; c < 16 * CHUNKS; c += 32) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < p.Sq)
      *reinterpret_cast<uint4*>(og + (long long)row * D + col) =
          *reinterpret_cast<const uint4*>(tile + r * STRIDE + col);
  }
  if (p.lse != nullptr && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row < p.Sq)
        p.lse[(long long)bh * p.Sq + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// ---------------------------------------------------------------- f32 path
constexpr int FBM = 32, FBN = 32, FTHREADS = 128;

template <int D>
__global__ void __launch_bounds__(FTHREADS) flash_fwd_f32(const Params p) {
  constexpr int QS = D + 1, PS = FBN + 1, DO = D / 4;
  extern __shared__ __align__(16) float fsm[];
  float* const qs = fsm;           // FBM x QS
  float* const ks = qs + FBM * QS;  // FBN x QS
  float* const vs = ks + FBN * QS;  // FBN x D
  float* const ps = vs + FBN * D;   // FBM x PS

  const int tid = threadIdx.x, row = tid / 4, sub = tid % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FBM;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < FBM * D; i += FTHREADS) {
    const int r = i / D, c = i % D;
    qs[r * QS + c] = q0 + r < p.Sq ? qg[(long long)(q0 + r) * p.q_ss + c] : 0.f;
  }
  float o[DO];
#pragma unroll
  for (int i = 0; i < DO; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int qrow = q0 + row;

  int j0, j1;
  kv_range(p, q0, FBM, FBN, j0, j1);
  for (int j = j0; j < j1; ++j) {
    const int c0 = j * FBN;
    __syncthreads();  // the previous step is done with ks, vs and ps
    for (int i = tid; i < FBN * D; i += FTHREADS) {
      const int r = i / D, c = i % D;
      const bool ok = c0 + r < p.Sk;
      ks[r * QS + c] = ok ? kg[(long long)(c0 + r) * p.k_ss + c] : 0.f;
      vs[r * D + c] = ok ? vg[(long long)(c0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    const bool masked = tile_needs_mask(p, q0, c0, FBM, FBN);
    float s[FBN / 4], mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < FBN / 4; ++i) {
      const int c = sub + 4 * i;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d)
        acc = fmaf(qs[row * QS + d], ks[c * QS + d], acc);
      float x = acc * p.scale_log2;
      if (masked && !keep(p, qrow, c0 + c)) x = -INFINITY;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, quad_max(mx));
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m - m_use);
    m = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < FBN / 4; ++i) {
      const float pv = exp2f(s[i] - m_use);
      sum += pv;
      ps[row * PS + sub + 4 * i] = pv;
    }
    l = l * alpha + quad_sum(sum);
    __syncwarp();  // the 4 threads of a row share one warp
#pragma unroll
    for (int i = 0; i < DO; ++i) o[i] *= alpha;
    for (int c = 0; c < FBN; ++c) {
      const float pc = ps[row * PS + c];
#pragma unroll
      for (int i = 0; i < DO; ++i)
        o[i] = fmaf(pc, vs[c * D + sub + 4 * i], o[i]);
    }
  }

  if (qrow < p.Sq) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* og = static_cast<float*>(p.o) + ((long long)bh * p.Sq + qrow) * D;
#pragma unroll
    for (int i = 0; i < DO; ++i) og[sub + 4 * i] = o[i] * inv;
    if (p.lse != nullptr && sub == 0)
      p.lse[(long long)bh * p.Sq + qrow] = (m + log2f(l)) * kLn2;
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int smem, const Params& p,
           cudaStream_t s) {
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_tc(const Params& p, cudaStream_t s) {
  const dim3 grid((p.Sq + BM - 1) / BM, p.B * p.H);
  const int smem = (BM + 2 * BN) * (D + PAD) * sizeof(T);
  return launch(flash_fwd_tc<T, D>, grid, THREADS, smem, p, s);
}

template <int D>
int launch_f32(const Params& p, cudaStream_t s) {
  const dim3 grid((p.Sq + FBM - 1) / FBM, p.B * p.H);
  const int smem =
      ((FBM + FBN) * (D + 1) + FBN * D + FBM * (FBN + 1)) * sizeof(float);
  return launch(flash_fwd_f32<D>, grid, FTHREADS, smem, p, s);
}

template <typename T>
int launch_tc_d(int D, const Params& p, cudaStream_t s) {
  switch (D) {
    case 32: return launch_tc<T, 32>(p, s);
    case 64: return launch_tc<T, 64>(p, s);
    case 128: return launch_tc<T, 128>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype 0 f32 (CUDA cores), 1 bf16, 2 f16 (tensor cores); D 32, 64 or 128.
// q (B, H, S_q, D), k and v (B, H_kv, S_k, D) with the given element
// strides (last dim contiguous; for bf16/f16 every stride a multiple of 8
// and the bases 16-byte aligned); o (B, H, S_q, D) contiguous in q's dtype;
// lse (B, H, S_q) f32 or null.  window 0 means none.
int flash_fwd_launch(int dtype, int D, const void* q, const void* k,
                     const void* v, void* o, float* lse, int B, int H,
                     int Hkv, int Sq, int Sk, long long q_sb, long long q_sh,
                     long long q_ss, long long k_sb, long long k_sh,
                     long long k_ss, long long v_sb, long long v_sh,
                     long long v_ss, float scale, int causal, int window,
                     void* stream) {
  Params p{q,    k,    v,    o,    lse,  B,    H,    Hkv,
           Sq,   Sk,   q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
           v_sb, v_sh, v_ss, scale * kLog2e, causal, window};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      switch (D) {
        case 32: return launch_f32<32>(p, s);
        case 64: return launch_f32<64>(p, s);
        case 128: return launch_f32<128>(p, s);
      }
      break;
    case 1: return launch_tc_d<__nv_bfloat16>(D, p, s);
    case 2: return launch_tc_d<__half>(D, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
