// K7: flash-attention backward.  From (Q, K, V, O, lse, dO) it computes
//   P   = exp(scale * Q K^T + mask - lse)      (recomputed, never stored)
//   D_i = rowsum(dO_i * O_i)                   (f32)
//   dS  = P * (dO V^T - D) * scale
//   dQ  = dS K,  dK = dS^T Q,  dV = P^T dO
// with f32 accumulation, lse the forward's natural-log logsumexp (K6,
// (B, H, S_q) f32).
//
// Replaces the TPU kernels param_tpu/ops/attention.py::_bwd_dq_kernel_rect
// / _bwd_dq_kernel_walk (dq: a (B*H, q blocks, kv blocks) grid or a
// compacted lower-triangle walk, dq carried in VMEM across the kv axis) and
// ::_bwd_dkv_kernel_rect / _bwd_dkv_kernel_walk (dk, dv: the kv-major grid,
// dk/dv carried across the q axis), tile bodies _bwd_p_ds, _bwd_dq_step and
// _bwd_dkv_step, called from flash_attention_bwd.  Two kernels, launched
// back to back on one stream by one entry point:
// - dq kernel: a block owns a q tile of one (batch, head).  It first
//   computes D for its rows (written to a (B, H, S_q) f32 buffer for the
//   second kernel), then walks exactly the kv tiles its rows attend (the
//   same range as K6: [0, S_k), with causal up to row + diag_off), and
//   writes dQ once.
// - dkv kernel: a block owns a kv tile of one (batch, kv head).  It loops
//   over every query head of its GQA group and over the q tiles whose rows
//   reach the tile (with causal, from the first row r with
//   r + diag_off >= the tile's first column), and writes dK and dV once.
//   No atomics, no repeated K/V, no per-q-head dk/dv buffer: the result is
//   deterministic.
// Causal aligns the diagonal bottom-right (diag_off = S_k - S_q, row r
// keeps columns c <= r + diag_off; needs S_q <= S_k), as in K6; there is
// no window (the reference refuses a window with the lse).  Rows past S_q
// (zero-filled) are masked to P = 0 in the dkv kernel, so that their
// garbage lse adds nothing to dK / dV; columns past S_k are masked too.
// K6 works in exp2 of pre-scaled scores, so P = exp2(S scale log2(e) -
// lse log2(e)).  P and dS are rounded to the input dtype before their
// products, as the reference does.
//
// What bounds it on an H100: operations for the shapes of the main path
// (five products, 10 D per kept (row, column) pair per head, over 989 TF/s
// in bf16 and f16 or 67 TF/s in f32); bytes (Q, K, V, O, dO and lse read
// once, dQ, dK, dV written once, over 3.35 TB/s) only for short sequences.
//
// Design, bf16/f16: 4 warps per block, mma.sync m16n8k16 with f32
// accumulators, operands staged in shared memory by 16-byte cp.async
// copies (rows padded by 8 elements so that ldmatrix is free of bank
// conflicts).
// - dq: 64 q rows (16 per warp), kv tiles of 64; the next K and V tiles
//   are copied into a second buffer while the current ones are used.  Q
//   and dO fragments are read from shared memory at each tile (keeping
//   them in registers would spill at D = 128).  The S and dP accumulators
//   give dS, which packed to bf16/f16 is already the A fragment of dS K.
// - dkv: 64 kv rows (16 per warp), q tiles of 64 rows (32 at D = 128, to
//   keep the dK and dV accumulators, 128 registers a thread, clear of
//   spills), the next q tile's Q, dO, lse and D copied under the current
//   one.  S^T = K Q^T and dP^T = V dO^T are computed directly, so their
//   accumulators are the A fragments of P^T dO and dS^T Q; Q and dO are
//   the B operands through ldmatrix .trans.
// f32: plain CUDA-core kernels in full f32 (no TF32), 4 threads per row,
// 32-row tiles, each thread owning D/4 output columns.
//
// Not used: wgmma, TMA, warp specialisation (later work).

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
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S_q)
  float* delta;      // (B, H, S_q): D, written by the dq kernel
  void* dq;          // (B, H, S_q, D), contiguous
  void* dk;          // (B, H_kv, S_k, D), contiguous
  void* dv;
  int B, H, Hkv, Sq, Sk;
  // element strides of batch, head and sequence; the last dim is contiguous
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  float scale;
  float scale_log2;  // scale * log2(e)
  int causal;
};

constexpr float kLog2e = 1.4426950408889634f;

// End of the kv tiles [0, end) of width bn that q rows [q0, q0 + bm)
// attend.
__device__ __forceinline__ int kv_end(const Params& p, int q0, int bm,
                                      int bn) {
  int hi = p.Sk;
  if (p.causal) hi = min(hi, min(q0 + bm, p.Sq) + (p.Sk - p.Sq));
  return (hi + bn - 1) / bn;
}

// First q tile (of bm rows) with a row that reaches kv column c0.
__device__ __forceinline__ int first_q_tile(const Params& p, int c0, int bm) {
  return p.causal ? max(0, c0 - (p.Sk - p.Sq)) / bm : 0;
}

// Whether the (q rows [q0, +bm)) x (kv columns [c0, +bn)) tile has an
// element that is masked or out of range.
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int c0, int bm, int bn) {
  if (q0 + bm > p.Sq || c0 + bn > p.Sk) return true;
  return p.causal && c0 + bn - 1 > q0 + (p.Sk - p.Sq);
}

__device__ __forceinline__ bool keep(const Params& p, int r, int c) {
  return r < p.Sq && c < p.Sk && (!p.causal || c <= r + (p.Sk - p.Sq));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
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

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// ------------------------------------------------------ tensor-core path
constexpr int BM = 64, BN = 64, THREADS = 128, PAD = 8;

// Copy rows [r0, r0 + ROWS) of a (rows, D) slice into a padded shared
// tile, 16 bytes per copy, zero-filling rows at or past n_rows.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          long long row_stride, int r0,
                                          int n_rows, int tid) {
  constexpr int STRIDE = D + PAD, CHUNKS = D / 8;
#pragma unroll
  for (int c = tid; c < ROWS * CHUNKS; c += THREADS) {
    const int row = c / CHUNKS, col = (c % CHUNKS) * 8;
    const bool ok = r0 + row < n_rows;
    const T* s = ok ? src + (long long)(r0 + row) * row_stride + col : src;
    cp_async16(dst + row * STRIDE + col, s, ok);
  }
}

// acc[2 np], acc[2 np + 1] += A (this warp's 16 rows, k16 step kk) times
// the B operand read non-transposed from rows [np * 16, +16) of `b`
// (C = A B^T with B row-major (n, k)).
template <typename T, int STRIDE>
__device__ __forceinline__ void mma_abt(float (&c0)[4], float (&c1)[4],
                                        const uint32_t (&a)[4], const T* b,
                                        int np, int kk, int lane) {
  uint32_t r[4];
  ldmatrix_x4(r, b + (np * 16 + lane % 8 + (lane / 16) * 8) * STRIDE +
                     kk * 16 + ((lane / 8) % 2) * 8);
  const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
  Mma<T>::run(c0, a, b0);
  Mma<T>::run(c1, a, b1);
}

// acc[2 nj], acc[2 nj + 1] += A (k16 step kk) times B rows [kk * 16, +16),
// columns [nj * 16, +16) of the row-major (k, n) tile `b` (ldmatrix .trans).
template <typename T, int STRIDE>
__device__ __forceinline__ void mma_ab(float (&c0)[4], float (&c1)[4],
                                       const uint32_t (&a)[4], const T* b,
                                       int kk, int nj, int lane) {
  uint32_t r[4];
  ldmatrix_x4_trans(r, b + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                               STRIDE +
                           nj * 16 + (lane / 16) * 8);
  const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
  Mma<T>::run(c0, a, b0);
  Mma<T>::run(c1, a, b1);
}

// Write a warp's 16 x D f32 accumulators as T through its 16 rows of the
// shared tile `stage`, then to rows [r0, r0 + 16) of `dst` (row stride D)
// that are below n_rows.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           T* stage, T* dst, int r0,
                                           int n_rows, int lane) {
  constexpr int STRIDE = D + PAD, CHUNKS = D / 8;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(&stage[(g + r * 8) * STRIDE + i * 8 +
                                          2 * t4]) =
          pack2<T>(acc[i][2 * r], acc[i][2 * r + 1]);
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * CHUNKS; c += 32) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    if (r0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * D + col) =
          *reinterpret_cast<const uint4*>(stage + r * STRIDE + col);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_tc(const Params p) {
  constexpr int STRIDE = D + PAD;
  constexpr int DK = D / 16;  // k16 steps over the head dim
  constexpr int NS = BN / 8;  // n8 tiles of S and dP
  constexpr int NO = D / 8;   // n8 tiles of dQ
  extern __shared__ __align__(16) unsigned char smem[];
  T* const qs = reinterpret_cast<T*>(smem);
  T* const dos = qs + BM * STRIDE;
  T* const kbuf = dos + BM * STRIDE;          // 2 x BN rows
  T* const vbuf = kbuf + 2 * BN * STRIDE;     // 2 x BN rows
  float* const dl_s = reinterpret_cast<float*>(vbuf + 2 * BN * STRIDE);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const T* og = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;

  load_rows<T, D, BM>(qs, qg, p.q_ss, q0, p.Sq, tid);
  load_rows<T, D, BM>(dos, dog, p.do_ss, q0, p.Sq, tid);
  cp_async_commit();
  const int j1 = kv_end(p, q0, BM, BN);
  load_rows<T, D, BN>(kbuf, kg, p.k_ss, 0, p.Sk, tid);
  load_rows<T, D, BN>(vbuf, vg, p.v_ss, 0, p.Sk, tid);
  cp_async_commit();
  cp_async_wait1();  // Q and dO have landed
  __syncthreads();

  // D = rowsum(dO * O) for this warp's 16 rows: two lanes per row, O read
  // once from device memory in 16-byte loads
  {
    const int r = warp * 16 + lane / 2, row = q0 + r;
    float acc = 0.f;
    if (row < p.Sq) {
      const T* orow = og + (long long)row * p.o_ss;
#pragma unroll
      for (int c = (lane % 2) * (D / 2); c < (lane % 2 + 1) * (D / 2);
           c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const T* oe = reinterpret_cast<const T*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc += to_f32(oe[e]) * to_f32(dos[r * STRIDE + c + e]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (lane % 2 == 0) {
      dl_s[r] = acc;
      if (row < p.Sq) p.delta[(long long)bh * p.Sq + row] = acc;
    }
  }
  __syncwarp();
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  float dl[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    dl[r] = dl_s[warp * 16 + g + r * 8];
    lse2[r] = row < p.Sq ? p.lse[(long long)bh * p.Sq + row] * kLog2e : 0.f;
  }

  float dq[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
  const T* qw = qs + (warp * 16 + lane % 16) * STRIDE + (lane / 16) * 8;
  const T* dow = dos + (warp * 16 + lane % 16) * STRIDE + (lane / 16) * 8;

  for (int j = 0; j < j1; ++j) {
    const int c0 = j * BN, buf = j & 1;
    const T* ks = kbuf + buf * BN * STRIDE;
    const T* vs = vbuf + buf * BN * STRIDE;
    // the other buffer was released by the barrier that ended the last step
    if (j + 1 < j1) {
      load_rows<T, D, BN>(kbuf + (buf ^ 1) * BN * STRIDE, kg, p.k_ss,
                          c0 + BN, p.Sk, tid);
      load_rows<T, D, BN>(vbuf + (buf ^ 1) * BN * STRIDE, vg, p.v_ss,
                          c0 + BN, p.Sk, tid);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait1();   // K_j and V_j have landed
    __syncthreads();

    // S = Q K_j^T and dP = dO V_j^T
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, qw + kk * 16);
      ldmatrix_x4(da, dow + kk * 16);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        mma_abt<T, STRIDE>(s[2 * np], s[2 * np + 1], qa, ks, np, kk, lane);
        mma_abt<T, STRIDE>(dp[2 * np], dp[2 * np + 1], da, vs, np, kk, lane);
      }
    }

    // dS = P (dP - D) scale, packed: n8 tile i is the k index range
    // [8 (i % 2), +8) of dS's k16 step i / 2
    const bool masked = tile_needs_mask(p, q0, c0, BM, BN);
    uint32_t dsf[BN / 16][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float pv = exp2f(s[i][e] * p.scale_log2 - lse2[r]);
        if (masked && !keep(p, row0 + r * 8, c0 + i * 8 + 2 * t4 + e % 2))
          pv = 0.f;
        ds[e] = pv * (dp[i][e] - dl[r]) * p.scale;
      }
      dsf[i / 2][(i % 2) * 2] = pack2<T>(ds[0], ds[1]);
      dsf[i / 2][(i % 2) * 2 + 1] = pack2<T>(ds[2], ds[3]);
    }
    // dQ += dS K_j
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int nj = 0; nj < D / 16; ++nj)
        mma_ab<T, STRIDE>(dq[2 * nj], dq[2 * nj + 1], dsf[kk], ks, kk, nj,
                          lane);
    __syncthreads();  // every warp is done with this step's buffers
  }
  cp_async_wait_all();

  // this warp's Q rows are read by this warp alone: stage dQ through them
  store_rows<T, D>(dq, qs + warp * 16 * STRIDE,
                   static_cast<T*>(p.dq) + (long long)bh * p.Sq * D,
                   q0 + warp * 16, p.Sq, lane);
}

template <typename T, int D, int QB>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_tc(const Params p) {
  constexpr int STRIDE = D + PAD;
  constexpr int DK = D / 16;  // k16 steps over the head dim
  constexpr int NS = QB / 8;  // n8 tiles of S^T and dP^T
  constexpr int NO = D / 8;   // n8 tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ks = reinterpret_cast<T*>(smem);
  T* const vs = ks + BN * STRIDE;
  T* const qbuf = vs + BN * STRIDE;          // 2 x QB rows
  T* const dobuf = qbuf + 2 * QB * STRIDE;   // 2 x QB rows
  float* const lse_buf = reinterpret_cast<float*>(dobuf + 2 * QB * STRIDE);
  float* const dl_buf = lse_buf + 2 * QB;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int c0 = blockIdx.x * BN;  // the longest causal columns first
  const int bk = blockIdx.y, b = bk / p.Hkv, hk = bk % p.Hkv;
  const int group = p.H / p.Hkv;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_rows<T, D, BN>(ks, kg, p.k_ss, c0, p.Sk, tid);
  load_rows<T, D, BN>(vs, vg, p.v_ss, c0, p.Sk, tid);
  cp_async_commit();

  const int i0 = first_q_tile(p, c0, QB);
  const int per_head = (p.Sq + QB - 1) / QB - i0;
  const int steps = group * per_head;
  // step t: query head hk * group + t / per_head, q tile i0 + t % per_head
  auto issue = [&](int t, int stage) {
    const int h = hk * group + t / per_head, q0 = (i0 + t % per_head) * QB;
    const long long bh = (long long)b * p.H + h;
    load_rows<T, D, QB>(qbuf + stage * QB * STRIDE,
                        static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
                        p.q_ss, q0, p.Sq, tid);
    load_rows<T, D, QB>(dobuf + stage * QB * STRIDE,
                        static_cast<const T*>(p.dout) + b * p.do_sb +
                            h * p.do_sh,
                        p.do_ss, q0, p.Sq, tid);
    if (tid < QB) {
      const bool ok = q0 + tid < p.Sq;
      const long long at = ok ? bh * p.Sq + q0 + tid : 0;
      cp_async4(lse_buf + stage * QB + tid, p.lse + at, ok);
      cp_async4(dl_buf + stage * QB + tid, p.delta + at, ok);
    }
  };
  if (steps > 0) issue(0, 0);
  cp_async_commit();

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const T* kw = ks + (warp * 16 + lane % 16) * STRIDE + (lane / 16) * 8;
  const T* vw = vs + (warp * 16 + lane % 16) * STRIDE + (lane / 16) * 8;
  const int col0 = c0 + warp * 16 + g;  // this lane's kv rows: col0, +8

  for (int t = 0; t < steps; ++t) {
    const int stage = t & 1;
    const int q0 = (i0 + t % per_head) * QB;
    // the other stage was released by the barrier that ended the last step
    if (t + 1 < steps) issue(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait1();  // this step's Q, dO, lse and D (and K, V) have landed
    __syncthreads();
    const T* qs = qbuf + stage * QB * STRIDE;
    const T* dos = dobuf + stage * QB * STRIDE;
    const float* lse_s = lse_buf + stage * QB;
    const float* dl_s = dl_buf + stage * QB;

    // S^T = K Q^T and dP^T = V dO^T: rows are kv rows, columns q rows
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, kw + kk * 16);
      ldmatrix_x4(va, vw + kk * 16);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        mma_abt<T, STRIDE>(st[2 * np], st[2 * np + 1], ka, qs, np, kk, lane);
        mma_abt<T, STRIDE>(dpt[2 * np], dpt[2 * np + 1], va, dos, np, kk,
                           lane);
      }
    }

    const bool masked = tile_needs_mask(p, q0, c0, QB, BN);
    uint32_t pf[QB / 16][4], dsf[QB / 16][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float pv[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = i * 8 + 2 * t4 + e % 2;  // q row within the tile
        float x = exp2f(st[i][e] * p.scale_log2 - lse_s[qc] * kLog2e);
        if (masked && !keep(p, q0 + qc, col0 + (e / 2) * 8)) x = 0.f;
        pv[e] = x;
        ds[e] = x * (dpt[i][e] - dl_s[qc]) * p.scale;
      }
      pf[i / 2][(i % 2) * 2] = pack2<T>(pv[0], pv[1]);
      pf[i / 2][(i % 2) * 2 + 1] = pack2<T>(pv[2], pv[3]);
      dsf[i / 2][(i % 2) * 2] = pack2<T>(ds[0], ds[1]);
      dsf[i / 2][(i % 2) * 2 + 1] = pack2<T>(ds[2], ds[3]);
    }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk)
#pragma unroll
      for (int nj = 0; nj < D / 16; ++nj) {
        mma_ab<T, STRIDE>(dv[2 * nj], dv[2 * nj + 1], pf[kk], dos, kk, nj,
                          lane);
        mma_ab<T, STRIDE>(dk[2 * nj], dk[2 * nj + 1], dsf[kk], qs, kk, nj,
                          lane);
      }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait_all();

  // this warp's K and V rows are read by this warp alone: stage through them
  const long long out = (long long)bk * p.Sk * D;
  store_rows<T, D>(dk, ks + warp * 16 * STRIDE,
                   static_cast<T*>(p.dk) + out, c0 + warp * 16, p.Sk, lane);
  store_rows<T, D>(dv, vs + warp * 16 * STRIDE,
                   static_cast<T*>(p.dv) + out, c0 + warp * 16, p.Sk, lane);
}

// ---------------------------------------------------------------- f32 path
constexpr int FB = 32, FTHREADS = 128;  // 32-row tiles, 4 threads per row

// rows [r0, r0 + FB) of a (rows, D) f32 slice into a (FB, D + 1) tile
template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long row_stride, int r0,
                                         int n_rows, int tid) {
  for (int i = tid; i < FB * D; i += FTHREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        r0 + r < n_rows ? src[(long long)(r0 + r) * row_stride + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(FTHREADS) flash_bwd_dq_f32(const Params p) {
  constexpr int RS = D + 1, PS = FB + 1, DO = D / 4;
  extern __shared__ __align__(16) float fsm[];
  float* const qs = fsm;            // FB x RS
  float* const dos = qs + FB * RS;  // FB x RS
  float* const ks = dos + FB * RS;  // FB x RS
  float* const vs = ks + FB * RS;   // FB x RS
  float* const dss = vs + FB * RS;  // FB x PS

  const int tid = threadIdx.x, row = tid / 4, sub = tid % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FB;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* og = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* dog =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;

  load_f32<D>(qs, qg, p.q_ss, q0, p.Sq, tid);
  load_f32<D>(dos, dog, p.do_ss, q0, p.Sq, tid);
  __syncthreads();
  const int qrow = q0 + row;
  float dl = 0.f;
  if (qrow < p.Sq)
    for (int d = sub; d < D; d += 4)
      dl += dos[row * RS + d] * og[(long long)qrow * p.o_ss + d];
  dl = quad_sum(dl);
  if (qrow < p.Sq && sub == 0) p.delta[(long long)bh * p.Sq + qrow] = dl;
  const float lse2 =
      qrow < p.Sq ? p.lse[(long long)bh * p.Sq + qrow] * kLog2e : 0.f;

  float dq[DO];
#pragma unroll
  for (int i = 0; i < DO; ++i) dq[i] = 0.f;
  const int j1 = kv_end(p, q0, FB, FB);
  for (int j = 0; j < j1; ++j) {
    const int c0 = j * FB;
    __syncthreads();  // the previous step is done with ks, vs and dss
    load_f32<D>(ks, kg, p.k_ss, c0, p.Sk, tid);
    load_f32<D>(vs, vg, p.v_ss, c0, p.Sk, tid);
    __syncthreads();
    const bool masked = tile_needs_mask(p, q0, c0, FB, FB);
#pragma unroll
    for (int i = 0; i < FB / 4; ++i) {
      const int c = sub + 4 * i;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[row * RS + d], ks[c * RS + d], s);
        dp = fmaf(dos[row * RS + d], vs[c * RS + d], dp);
      }
      float pv = exp2f(s * p.scale_log2 - lse2);
      if (masked && !keep(p, qrow, c0 + c)) pv = 0.f;
      dss[row * PS + c] = pv * (dp - dl) * p.scale;
    }
    __syncwarp();  // the 4 threads of a row share one warp
    for (int c = 0; c < FB; ++c) {
      const float dsc = dss[row * PS + c];
#pragma unroll
      for (int i = 0; i < DO; ++i)
        dq[i] = fmaf(dsc, ks[c * RS + sub + 4 * i], dq[i]);
    }
  }
  if (qrow < p.Sq) {
    float* dqg = static_cast<float*>(p.dq) + ((long long)bh * p.Sq + qrow) * D;
#pragma unroll
    for (int i = 0; i < DO; ++i) dqg[sub + 4 * i] = dq[i];
  }
}

template <int D>
__global__ void __launch_bounds__(FTHREADS)
    flash_bwd_dkv_f32(const Params p) {
  constexpr int RS = D + 1, PS = FB + 1, DO = D / 4;
  extern __shared__ __align__(16) float fsm[];
  float* const ks = fsm;            // FB x RS
  float* const vs = ks + FB * RS;   // FB x RS
  float* const qs = vs + FB * RS;   // FB x RS
  float* const dos = qs + FB * RS;  // FB x RS
  float* const ps = dos + FB * RS;  // FB x PS: P^T
  float* const dss = ps + FB * PS;  // FB x PS: dS^T
  float* const lse_s = dss + FB * PS;  // FB
  float* const dl_s = lse_s + FB;      // FB

  const int tid = threadIdx.x, kr = tid / 4, sub = tid % 4;
  const int c0 = blockIdx.x * FB, col = c0 + kr;
  const int bk = blockIdx.y, b = bk / p.Hkv, hk = bk % p.Hkv;
  const int group = p.H / p.Hkv;
  load_f32<D>(ks, static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh,
              p.k_ss, c0, p.Sk, tid);
  load_f32<D>(vs, static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh,
              p.v_ss, c0, p.Sk, tid);

  float dk[DO], dv[DO];
#pragma unroll
  for (int i = 0; i < DO; ++i) dk[i] = dv[i] = 0.f;
  const int n_qt = (p.Sq + FB - 1) / FB;
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const long long bh = (long long)b * p.H + h;
    for (int qt = first_q_tile(p, c0, FB); qt < n_qt; ++qt) {
      const int q0 = qt * FB;
      __syncthreads();  // the previous step is done with qs, dos, ps, dss
      load_f32<D>(qs, static_cast<const float*>(p.q) + b * p.q_sb +
                          h * p.q_sh, p.q_ss, q0, p.Sq, tid);
      load_f32<D>(dos, static_cast<const float*>(p.dout) + b * p.do_sb +
                           h * p.do_sh, p.do_ss, q0, p.Sq, tid);
      if (tid < FB) {
        const bool ok = q0 + tid < p.Sq;
        lse_s[tid] = ok ? p.lse[bh * p.Sq + q0 + tid] * kLog2e : 0.f;
        dl_s[tid] = ok ? p.delta[bh * p.Sq + q0 + tid] : 0.f;
      }
      __syncthreads();
      const bool masked = tile_needs_mask(p, q0, c0, FB, FB);
#pragma unroll
      for (int i = 0; i < FB / 4; ++i) {
        const int r = sub + 4 * i;
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(ks[kr * RS + d], qs[r * RS + d], s);
          dp = fmaf(vs[kr * RS + d], dos[r * RS + d], dp);
        }
        float pv = exp2f(s * p.scale_log2 - lse_s[r]);
        if (masked && !keep(p, q0 + r, col)) pv = 0.f;
        ps[kr * PS + r] = pv;
        dss[kr * PS + r] = pv * (dp - dl_s[r]) * p.scale;
      }
      __syncwarp();  // the 4 threads of a kv row share one warp
      for (int r = 0; r < FB; ++r) {
        const float pr = ps[kr * PS + r], dr = dss[kr * PS + r];
#pragma unroll
        for (int i = 0; i < DO; ++i) {
          dv[i] = fmaf(pr, dos[r * RS + sub + 4 * i], dv[i]);
          dk[i] = fmaf(dr, qs[r * RS + sub + 4 * i], dk[i]);
        }
      }
    }
  }
  if (col < p.Sk) {
    const long long at = ((long long)bk * p.Sk + col) * D;
    float* dkg = static_cast<float*>(p.dk) + at;
    float* dvg = static_cast<float*>(p.dv) + at;
#pragma unroll
    for (int i = 0; i < DO; ++i) {
      dkg[sub + 4 * i] = dk[i];
      dvg[sub + 4 * i] = dv[i];
    }
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
  constexpr int QB = D == 128 ? 32 : 64;
  const int smem_dq =
      (2 * BM + 4 * BN) * (D + PAD) * sizeof(T) + BM * sizeof(float);
  int rc = launch(flash_bwd_dq_tc<T, D>, dim3((p.Sq + BM - 1) / BM, p.B * p.H),
                  THREADS, smem_dq, p, s);
  if (rc != 0) return rc;
  const int smem_dkv =
      (2 * BN + 4 * QB) * (D + PAD) * sizeof(T) + 4 * QB * sizeof(float);
  return launch(flash_bwd_dkv_tc<T, D, QB>,
                dim3((p.Sk + BN - 1) / BN, p.B * p.Hkv), THREADS, smem_dkv, p,
                s);
}

template <int D>
int launch_f32(const Params& p, cudaStream_t s) {
  const int smem_dq = (4 * FB * (D + 1) + FB * (FB + 1)) * sizeof(float);
  int rc = launch(flash_bwd_dq_f32<D>, dim3((p.Sq + FB - 1) / FB, p.B * p.H),
                  FTHREADS, smem_dq, p, s);
  if (rc != 0) return rc;
  const int smem_dkv =
      (4 * FB * (D + 1) + 2 * FB * (FB + 1) + 2 * FB) * sizeof(float);
  return launch(flash_bwd_dkv_f32<D>,
                dim3((p.Sk + FB - 1) / FB, p.B * p.Hkv), FTHREADS, smem_dkv,
                p, s);
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
// q, o and dout (B, H, S_q, D), k and v (B, H_kv, S_k, D), with their
// batch, head and sequence element strides in `strides` (15 values: q, k,
// v, o, dout; last dim contiguous; for bf16/f16 every stride a multiple of
// 8 and the bases 16-byte aligned); lse (B, H, S_q) f32; delta (B, H, S_q)
// f32 scratch; dq (B, H, S_q, D), dk and dv (B, H_kv, S_k, D) contiguous in
// the inputs' dtype.  Launches the dq kernel, then the dkv kernel, on
// `stream`; returns the first CUDA error.
int flash_bwd_launch(int dtype, int D, const void* q, const void* k,
                     const void* v, const void* o, const void* dout,
                     const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int B, int H, int Hkv, int Sq, int Sk,
                     const long long* strides, float scale, int causal,
                     void* stream) {
  const long long* st = strides;
  Params p{q,      k,      v,      o,      dout,   lse,    delta,  dq,
           dk,     dv,     B,      H,      Hkv,    Sq,     Sk,     st[0],
           st[1],  st[2],  st[3],  st[4],  st[5],  st[6],  st[7],  st[8],
           st[9],  st[10], st[11], st[12], st[13], st[14], scale,
           scale * kLog2e, causal};
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
