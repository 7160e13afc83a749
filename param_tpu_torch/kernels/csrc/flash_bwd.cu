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
// in bf16 and f16 or, in f32, 165 TF/s: TF32's 495 over the three
// products of each f32-accurate one); bytes (Q, K, V, O, dO and lse read
// once, dQ, dK, dV written once, over 3.35 TB/s) only for short sequences.
//
// Three paths, chosen by the wrapper before the launch
// (kernels/flash_fwd.py::flash_schedule), each two kernels:
//
// wgmma (bf16/f16, D 64 or 128, views TMA can read).  Blocks of 384
// threads: warpgroup 0 the producer (one thread issues TMA loads of 64 x 64
// boxes, 128-byte swizzle, through 4-D tensor maps of the (B, H, S, D)
// views, into a ring of mbarrier stages), warpgroups 1 and 2 consumers of
// 64 rows each; registers 40 / 232 (setmaxnreg).  Blocks come from a 1-D
// grid, longest causal walks first across all heads.
// - dq: a block owns a 128-row q tile.  Each consumer first computes D for
//   its rows from O and dO in device memory (16-byte loads) and writes D
//   and lse log2(e) to padded (B H, S_q rounded up to 128) f32 buffers for
//   the dkv kernel.  Q and dO are loaded once; 64-row K and V tiles stream
//   through a 3-stage ring.  S = Q K^T and dP = dO V^T are SS wgmma
//   m64n64k16 (K and V as stored are K-major B); dS = P (dP - D) scale is
//   formed in the accumulator registers and, rounded to bf16/f16, is the A
//   operand of the register-A wgmma m64n{D}k16 for dQ += dS K (K as stored
//   is MN-major B).
// - dkv: a block owns a 128-row kv tile of one (batch, kv head), each
//   consumer 64 kv rows with its own dK and dV accumulators (2 x D / 2
//   registers a thread).  K and V are loaded once; the 64-row Q and dO
//   tiles of every query head of the GQA group, with their lse log2(e) and
//   D (two 256-byte bulk copies), stream through the ring.  S^T = K Q^T and
//   dP^T = V dO^T are SS wgmma m64n64k16, so P^T and dS^T come out in the
//   accumulator layout, which is the A-register layout of dV += P^T dO and
//   dK += dS^T Q (register-A wgmma m64n{D}k16, dO and Q as stored are
//   MN-major B).  The q tiles stay 64 rows at D = 128 with nothing
//   spilled.
// A consumer waits for each group of products before it uses their
// results (the two consumers run out of step, so one's exponentials run
// under the other's products); issuing tile i's first products under tile
// i - 1's last ones spilled the dkv kernel at D = 128 and made ptxas
// serialize its wgmmas.  A consumer releases a stage (one arrival per
// warp) once the products that read it completed, and skips a tile wholly
// masked for its rows.  Masks are selects against each row's or column's
// band under one warp-uniform branch, on edge tiles only.  dQ, dK and dV
// are staged through the consumer's own rows of its Q or K / V tile and
// written in 16-byte stores.
//
// mma_sync (other bf16/f16 shapes, e.g. D = 32): 4 warps per block,
// mma.sync m16n8k16 with f32 accumulators, operands staged in shared memory
// by 16-byte cp.async copies (rows padded by 8 elements so that ldmatrix is
// free of bank conflicts).
// - dq: 64 q rows (16 per warp), kv tiles of 64; the next K and V tiles
//   are copied into a second buffer while the current ones are used.  Q
//   and dO fragments are read from shared memory at each tile.  The S and
//   dP accumulators give dS, which packed to bf16/f16 is already the A
//   fragment of dS K.
// - dkv: 64 kv rows (16 per warp), q tiles of 64 rows (32 at D = 128), the
//   next q tile's Q, dO, lse and D copied under the current one.  S^T =
//   K Q^T and dP^T = V dO^T are computed directly, so their accumulators
//   are the A fragments of P^T dO and dS^T Q; Q and dO are the B operands
//   through ldmatrix .trans.
//
// tf32x3 (f32): the five products on the tensor cores as split-TF32 products
// (tf32x3.cuh: each operand split in registers into two TF32 halves, three
// mma.sync m16n8k8 .tf32 a product, f32 accuracy); P, dS and D in f32 on the
// CUDA cores (exp2f).  Blocks of 4 warps, 16 rows a warp: 64 rows a block where
// that gives every SM a block; for smaller grids 32 or 16 rows, the walk split
// 2 or 4 ways across the warps and their partial sums added in a fixed order at
// the end.  Tiles are staged in shared memory as swizzled f32 rows by cp.async
// copies (16 bytes when every view's base and strides are 16-byte aligned, else
// 4 bytes).
// - dq: Q and dO loaded once; K and V tiles (64 rows, 32 at D = 128) in one
//   buffer each (a split), V_{j+1} copied while S = Q K_j^T and dQ += dS K_j
//   are computed and K_{j+1} while dP = dO V_{j+1}^T is.  S and dP read K and V
//   rows in the permuted order of tf32x3.cuh, so each n8 tile of dS is the A
//   fragment of dS K where it lies; K is read as stored (column fragments) for
//   dS K.
// - dkv: K and V loaded once; the Q and dO tiles (64 rows, 32 at D = 128) of
//   every query head of the GQA group, with their lse and D, stream through one
//   buffer each (a split), Q_{u+1} copied while dV += P^T dO_u is computed and
//   dO_{u+1} while S^T = K Q_{u+1}^T is.  S^T and dP^T give P^T and dS^T as the
//   A fragments of dV += P^T dO and dK += dS^T Q, dO and Q read as stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"
#include "tf32x3.cuh"

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
  // wgmma path: lse log2(e) and D, (B H, sq_pad) each, written by its dq
  // kernel (delta above is then the second of the two)
  float* lse2;
  int sq_pad;
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

using hopper::pack2;

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
      tf32x3::cp_async4(lse_buf + stage * QB + tid, p.lse + at, ok);
      tf32x3::cp_async4(dl_buf + stage * QB + tid, p.delta + at, ok);
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

// ------------------------------------------------------------ wgmma path
namespace wg {

constexpr int THREADS = 384;
constexpr int QM = 128;  // q rows of a dq block (two consumers x 64)
constexpr int QN = 64;   // kv rows of a dq step
constexpr int KM = 128;  // kv rows of a dkv block (two consumers x 64)
constexpr int KQ = 64;   // q rows of a dkv step

template <int D>
struct DqSmem {
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = QM * D * 2;   // the Q tile; dO's the same
  static constexpr int KV_BYTES = QN * D * 2;  // one K or V tile
  static constexpr int TILES = 2 * Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int DELTA = TILES;  // QM floats: D of the block's rows
  // q_full, then full and empty for each stage
  static constexpr int BARS = DELTA + QM * 4;
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
struct DkvSmem {
  static constexpr int STAGES = 3;
  static constexpr int K_BYTES = KM * D * 2;  // the K tile; V's the same
  static constexpr int Q_BYTES = KQ * D * 2;  // one Q or dO tile
  // a stage: Q, dO, then KQ floats each of lse log2(e) and D (padded to
  // keep the next stage's tiles on the swizzle's 1024 bytes)
  static constexpr int STAGE = 2 * Q_BYTES + 1024;
  static constexpr int TILES = 2 * K_BYTES + STAGES * STAGE;
  // kv_full, then full and empty for each stage
  static constexpr int BYTES = TILES + (1 + 2 * STAGES) * 8 + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, const Params p) {
  using L = DqSmem<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const qs = align1024(smem_raw);
  unsigned char* const dos = qs + L::Q_BYTES;
  unsigned char* const ring = dos + L::Q_BYTES;  // stage s: K, then V
  float* const dl_s = reinterpret_cast<float*>(qs + L::DELTA);
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(qs + L::BARS);
  uint64_t* const full = q_full + 1;
  uint64_t* const empty = full + STAGES;

  // a 1-D grid, q tiles last first across all (batch, head) pairs: the
  // longest causal rows start first
  const int bh = blockIdx.x % (p.B * p.H), b = bh / p.H, h = bh % p.H;
  const int q0 = ((p.Sq + QM - 1) / QM - 1 - blockIdx.x / (p.B * p.H)) * QM;
  const int hk = h / (p.H / p.Hkv);
  const int n = kv_end(p, q0, QM, QN);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tq);
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      hopper::tma_prefetch(&tdo);
      hopper::mbar_arrive_expect_tx(q_full, 2 * L::Q_BYTES);
      hopper::tma_load_tile<D, QM>(qs, &tq, q_full, q0, h, b);
      hopper::tma_load_tile<D, QM>(dos, &tdo, q_full, q0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) hopper::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        unsigned char* const kt = ring + s * 2 * L::KV_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * L::KV_BYTES);
        hopper::tma_load_tile<D, QN>(kt, &tk, &full[s], i * QN, hk, b);
        hopper::tma_load_tile<D, QN>(kt + L::KV_BYTES, &tv, &full[s], i * QN,
                                     hk, b);
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  hopper::setmaxnreg_inc<232>();
  using MS = hopper::WgmmaN<T, QN>;  // S, dP: 64 x QN
  using MO = hopper::WgmmaN<T, D>;   // dQ: 64 x D
  const int cw = threadIdx.x / 128 - 1;  // rows q0 + 64 cw .. + 63
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int q0w = q0 + 64 * cw;
  const int row0 = q0w + 16 * warp + lane / 4;  // rows row0, row0 + 8
  const int diag = p.Sk - p.Sq;

  // D = rowsum(dO * O) for this consumer's 64 rows, two threads a row; D
  // and lse log2(e) (0 past S_q) go to the dkv kernel's padded buffers
  {
    const int t = threadIdx.x % 128, r = t / 2, row = q0w + r;
    const int c_lo = (t % 2) * (D / 2);
    float acc = 0.f;
    if (row < p.Sq) {
      const T* orow = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh +
                      (long long)row * p.o_ss;
      const T* drow = static_cast<const T*>(p.dout) + b * p.do_sb +
                      h * p.do_sh + (long long)row * p.do_ss;
#pragma unroll
      for (int c = c_lo; c < c_lo + D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const T* oe = reinterpret_cast<const T*>(&ov);
        const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += to_f32(oe[e]) * to_f32(de[e]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (t % 2 == 0) {
      dl_s[64 * cw + r] = acc;
      const long long at = (long long)bh * p.sq_pad + row;
      p.delta[at] = acc;
      p.lse2[at] =
          row < p.Sq ? p.lse[(long long)bh * p.Sq + row] * kLog2e : 0.f;
    }
  }
  hopper::warpgroup_barrier(1 + cw);
  // per row of this thread: D, lse log2(e), and the last kv column kept
  // (-1 past S_q)
  float dl[2], lse2[2];
  int hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    dl[r] = dl_s[row - q0];
    lse2[r] = row < p.Sq ? p.lse[(long long)bh * p.Sq + row] * kLog2e : 0.f;
    hi[r] = row >= p.Sq ? -1 : p.causal ? min(p.Sk - 1, row + diag) : p.Sk - 1;
  }
  const float sl2 = p.scale_log2;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const unsigned char* const qw = qs + cw * 64 * 128;
  const unsigned char* const dow = dos + cw * 64 * 128;

  hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES, c0 = i * QN;
    const unsigned char* const kt = ring + s * 2 * L::KV_BYTES;
    const unsigned char* const vt = kt + L::KV_BYTES;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    // a tile wholly masked for this consumer's rows adds nothing
    const bool skip = q0w >= p.Sq || (p.causal && c0 > q0w + 63 + diag);
    if (!skip) {
      float sc[QN / 2], dp[QN / 2];
#pragma unroll
      for (int e = 0; e < QN / 2; ++e) sc[e] = dp[e] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_off = (kk / 4) * QM * 128 + (kk % 4) * 32;
        const int b_off = (kk / 4) * QN * 128 + (kk % 4) * 32;
        MS::template ss<0>(sc, hopper::desc_k_major_sw128(qw + a_off),
                           hopper::desc_k_major_sw128(kt + b_off), kk > 0);
        MS::template ss<0>(dp, hopper::desc_k_major_sw128(dow + a_off),
                           hopper::desc_k_major_sw128(vt + b_off), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // masked scores to -inf (P = 0) by selects, under one uniform branch
      if (tile_needs_mask(p, q0w, c0, 64, QN)) {
#pragma unroll
        for (int j = 0; j < QN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = c0 + 8 * j + 2 * t4 + e % 2 <= hi[e / 2]
                                ? sc[4 * j + e]
                                : -INFINITY;
      }
      // dS = P (dP - D) scale, rounded as the A operand of dQ += dS K
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const float pv =
              hopper::exp2_approx(fmaf(sc[4 * j + e], sl2, -lse2[r]));
          sc[4 * j + e] = pv * (dp[4 * j + e] - dl[r]) * p.scale;
        }
      uint32_t dsf[QN / 16][4];
      hopper::acc_to_a<T, QN>(sc, dsf);
      hopper::wgmma_fence();  // dS was written
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)
        MO::template rs<1>(
            dq, dsf[kk], hopper::desc_mn_major_sw128(kt + kk * 2048, QN * 128),
            1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // this consumer's Q rows are read by it alone: stage dQ through them
  hopper::store_tile<T, D, QM>(
      dq, 1.f, 1.f, qs, 64 * cw,
      static_cast<T*>(p.dq) + ((long long)bh * p.Sq + q0w) * D, p.Sq - q0w,
      1 + cw);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const Params p) {
  using L = DkvSmem<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const ks = align1024(smem_raw);
  unsigned char* const vs = ks + L::K_BYTES;
  unsigned char* const ring = vs + L::K_BYTES;  // stage s: Q, dO, lse2, D
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(ks + L::TILES);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + STAGES;

  // a 1-D grid, kv tiles in order across all (batch, kv head) pairs:
  // the longest causal columns start first
  const int bk = blockIdx.x % (p.B * p.Hkv), b = bk / p.Hkv, hk = bk % p.Hkv;
  const int c0 = blockIdx.x / (p.B * p.Hkv) * KM;
  const int group = p.H / p.Hkv;
  const int i0 = first_q_tile(p, c0, KQ);
  const int per_head = (p.Sq + KQ - 1) / KQ - i0;
  const int steps = group * per_head;
  // step t: query head hk * group + t / per_head, q tile i0 + t % per_head

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tq);
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      hopper::tma_prefetch(&tdo);
      hopper::mbar_arrive_expect_tx(kv_full, 2 * L::K_BYTES);
      hopper::tma_load_tile<D, KM>(ks, &tk, kv_full, c0, hk, b);
      hopper::tma_load_tile<D, KM>(vs, &tv, kv_full, c0, hk, b);
      for (int t = 0; t < steps; ++t) {
        const int s = t % STAGES;
        const int h = hk * group + t / per_head;
        const int q0 = (i0 + t % per_head) * KQ;
        if (t >= STAGES) hopper::mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        unsigned char* const st = ring + s * L::STAGE;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * L::Q_BYTES + 2 * KQ * 4);
        hopper::tma_load_tile<D, KQ>(st, &tq, &full[s], q0, h, b);
        hopper::tma_load_tile<D, KQ>(st + L::Q_BYTES, &tdo, &full[s], q0, h,
                                     b);
        const long long at = (long long)(b * p.H + h) * p.sq_pad + q0;
        hopper::bulk_load(st + 2 * L::Q_BYTES, p.lse2 + at, KQ * 4, &full[s]);
        hopper::bulk_load(st + 2 * L::Q_BYTES + KQ * 4, p.delta + at, KQ * 4,
                          &full[s]);
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  hopper::setmaxnreg_inc<232>();
  using MS = hopper::WgmmaN<T, KQ>;  // S^T, dP^T: 64 x KQ
  using MO = hopper::WgmmaN<T, D>;   // dK, dV: 64 x D
  const int cw = threadIdx.x / 128 - 1;  // kv rows c0 + 64 cw .. + 63
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int c0w = c0 + 64 * cw;
  const int col0 = c0w + 16 * warp + lane / 4;  // kv rows col0, col0 + 8
  const int diag = p.Sk - p.Sq;
  const unsigned char* const kw = ks + cw * 64 * 128;
  const unsigned char* const vw = vs + cw * 64 * 128;
  const float sl2 = p.scale_log2;
  // per kv row of this thread: the q rows [qlo, qhi] that reach it (qhi
  // -1 past S_k)
  int qlo[2], qhi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = col0 + 8 * r;
    qlo[r] = p.causal ? c - diag : 0;
    qhi[r] = c < p.Sk ? p.Sq - 1 : -1;
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  for (int t = 0; t < steps; ++t) {
    const int s = t % STAGES;
    const int q0 = (i0 + t % per_head) * KQ;
    const unsigned char* const st = ring + s * L::STAGE;
    hopper::mbar_wait(&full[s], (t / STAGES) & 1);
    // a tile wholly masked for this consumer's kv rows adds nothing
    const bool skip = c0w >= p.Sk || (p.causal && q0 + KQ - 1 + diag < c0w);
    if (!skip) {
      const unsigned char* const qt = st;
      const unsigned char* const dot = st + L::Q_BYTES;
      const float* const lse_s =
          reinterpret_cast<const float*>(st + 2 * L::Q_BYTES);
      const float* const dl_s = lse_s + KQ;
      float sc[KQ / 2], dp[KQ / 2];
#pragma unroll
      for (int e = 0; e < KQ / 2; ++e) sc[e] = dp[e] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_off = (kk / 4) * KM * 128 + (kk % 4) * 32;
        const int b_off = (kk / 4) * KQ * 128 + (kk % 4) * 32;
        MS::template ss<0>(sc, hopper::desc_k_major_sw128(kw + a_off),
                           hopper::desc_k_major_sw128(qt + b_off), kk > 0);
        MS::template ss<0>(dp, hopper::desc_k_major_sw128(vw + a_off),
                           hopper::desc_k_major_sw128(dot + b_off), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // rows are kv rows, columns q rows: masked scores to -inf (P = 0) by
      // selects under one uniform branch, then P^T and dS^T, rounded as the
      // A operands of dV += P^T dO and dK += dS^T Q
      if (tile_needs_mask(p, q0, c0w, KQ, 64)) {
#pragma unroll
        for (int j = 0; j < KQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q0 + 8 * j + 2 * t4 + e % 2, r = e / 2;
            sc[4 * j + e] =
                q >= qlo[r] && q <= qhi[r] ? sc[4 * j + e] : -INFINITY;
          }
      }
#pragma unroll
      for (int j = 0; j < KQ / 8; ++j) {
        const int qc = 8 * j + 2 * t4;  // q row within the tile
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + qc);
        const float2 dd = *reinterpret_cast<const float2*>(dl_s + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l2 = e % 2 ? ls.y : ls.x, dlt = e % 2 ? dd.y : dd.x;
          const float pv =
              hopper::exp2_approx(fmaf(sc[4 * j + e], sl2, -l2));
          dp[4 * j + e] = pv * (dp[4 * j + e] - dlt) * p.scale;
          sc[4 * j + e] = pv;
        }
      }
      uint32_t pf[KQ / 16][4], dsf[KQ / 16][4];
      hopper::acc_to_a<T, KQ>(sc, pf);
      hopper::acc_to_a<T, KQ>(dp, dsf);
      hopper::wgmma_fence();  // P^T and dS^T were written
#pragma unroll
      for (int kk = 0; kk < KQ / 16; ++kk) {
        MO::template rs<1>(
            dv, pf[kk],
            hopper::desc_mn_major_sw128(dot + kk * 2048, KQ * 128), 1);
        MO::template rs<1>(
            dk, dsf[kk],
            hopper::desc_mn_major_sw128(qt + kk * 2048, KQ * 128), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // this consumer's K and V rows are read by it alone: stage through them
  const long long out = ((long long)bk * p.Sk + c0w) * D;
  hopper::store_tile<T, D, KM>(dk, 1.f, 1.f, ks, 64 * cw,
                               static_cast<T*>(p.dk) + out, p.Sk - c0w,
                               1 + cw);
  hopper::store_tile<T, D, KM>(dv, 1.f, 1.f, vs, 64 * cw,
                               static_cast<T*>(p.dv) + out, p.Sk - c0w,
                               1 + cw);
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t s) {
  const CUtensorMapDataType type = hopper::tma_type<T>();
  CUtensorMap tq, tk, tv, tdo;
  int rc = hopper::encode_bhsd(&tq, type, p.q, p.B, p.H, p.Sq, D, p.q_sb,
                               p.q_sh, p.q_ss);
  if (rc == 0)
    rc = hopper::encode_bhsd(&tk, type, p.k, p.B, p.Hkv, p.Sk, D, p.k_sb,
                             p.k_sh, p.k_ss);
  if (rc == 0)
    rc = hopper::encode_bhsd(&tv, type, p.v, p.B, p.Hkv, p.Sk, D, p.v_sb,
                             p.v_sh, p.v_ss);
  if (rc == 0)
    rc = hopper::encode_bhsd(&tdo, type, p.dout, p.B, p.H, p.Sq, D, p.do_sb,
                             p.do_sh, p.do_ss);
  if (rc != 0) return rc;
  cudaError_t e = hopper::allow_smem(
      reinterpret_cast<const void*>(flash_bwd_dq_wgmma<T, D>),
      DqSmem<D>::BYTES);
  if (e == cudaSuccess)
    e = hopper::allow_smem(
        reinterpret_cast<const void*>(flash_bwd_dkv_wgmma<T, D>),
        DkvSmem<D>::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_wgmma<T, D>
      <<<(unsigned)((p.Sq + QM - 1) / QM) * p.B * p.H, THREADS,
         DqSmem<D>::BYTES, s>>>(tq, tk, tv, tdo, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv_wgmma<T, D>
      <<<(unsigned)((p.Sk + KM - 1) / KM) * p.B * p.Hkv, THREADS,
         DkvSmem<D>::BYTES, s>>>(tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ------------------------------------------------------------- f32 path
namespace x3 {

using namespace tf32x3;

// dq kernel: a block of 4 warps owns 16 R q rows of one (batch, head) and
// walks their BN-row K and V tiles, split S = 4 / R ways (tf32x3.cuh):
// split s takes tiles s, s + S, ...  Shared memory holds the Q and dO
// tiles, one K and one V tile a split (swizzled f32 rows) and D of the
// rows; after the walk, the splits' partial dQ go through it to be added.
template <int D, int BN>
__global__ void __launch_bounds__(128) flash_bwd_dq_tf32x3(const Params p,
                                                           int vec16, int R) {
  extern __shared__ __align__(16) float xsm[];
  const int S = kWarps / R, bm = 16 * R;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int sp = warp / R, rg = warp % R;  // this warp's split, row group
  const int gtid = tid % (32 * R), gthreads = 32 * R;  // within the split
  float* const qs = xsm;                             // bm x D
  float* const dos = qs + bm * D;                    // bm x D
  float* const ks = dos + bm * D + sp * 2 * BN * D;  // BN x D
  float* const vs = ks + BN * D;                     // BN x D
  float* const dl_s = dos + bm * D + S * 2 * BN * D;  // bm

  // a 1-D grid, q tiles last first across all (batch, head) pairs: the
  // longest causal rows start first
  const int nbh = p.B * p.H;
  const int bh = blockIdx.x % nbh, b = bh / p.H, h = bh % p.H;
  const int q0 = ((p.Sq + bm - 1) / bm - 1 - blockIdx.x / nbh) * bm;
  const int hk = h / (p.H / p.Hkv);
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* og = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int n = kv_end(p, q0, bm, BN);

  load_f32_tile<D>(
      qs, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
      q0, bm, p.Sq, vec16, tid, blockDim.x);
  load_f32_tile<D>(
      dos, static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh,
      p.do_ss, q0, bm, p.Sq, vec16, tid, blockDim.x);
  cp_async_commit();
  if (sp < n)
    load_f32_tile<D>(vs, vg, p.v_ss, sp * BN, BN, p.Sk, vec16, gtid, gthreads);
  cp_async_commit();
  if (sp < n)
    load_f32_tile<D>(ks, kg, p.k_ss, sp * BN, BN, p.Sk, vec16, gtid, gthreads);
  cp_async_commit();
  cp_async_wait2();  // Q and dO have landed
  __syncthreads();

  // D = rowsum(dO * O), a row a warp at a time, O read once from device
  // memory
  for (int r = warp; r < bm; r += kWarps) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < p.Sq) {
      const float* orow = og + (long long)row * p.o_ss;
#pragma unroll
      for (int c = lane; c < D; c += 32)
        acc = fmaf(orow[c], dos[at<D>(r, c)], acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      dl_s[r] = acc;
      if (row < p.Sq) p.delta[(long long)bh * p.Sq + row] = acc;
    }
  }
  __syncthreads();
  const int row0 = q0 + rg * 16 + g;  // this lane's rows: row0, row0 + 8
  float dl[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    dl[r] = dl_s[rg * 16 + g + 8 * r];
    lse2[r] = row < p.Sq ? p.lse[(long long)bh * p.Sq + row] * kLog2e : 0.f;
  }

  // this lane's fragment offsets: Q and dO rows (A), K and V rows in the
  // order pi (B of S and dP), K columns (B of dS K)
  const float* qa = qs + (rg * 16 + g) * D;
  const float* da = dos + (rg * 16 + g) * D;
  const int xa = row_x(g, t);
  const float* kb = ks + pi(g) * D;
  const float* vb = vs + pi(g) * D;
  const int xp = row_x(pi(g), t);
  const float* kc0 = ks + t * D;
  const float* kc1 = ks + (t + 4) * D;
  const int xc0 = col_x(t, g), xc1 = col_x(t + 4, g);

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int j = sp; j < n; j += S) {
    const int c0 = j * BN;
    cp_async_wait1();  // V_j has landed (K_j may still be in flight)
    split_sync(sp, R);
    // dP = dO V_j^T and then S = Q K_j^T; element e of n8 tile i: row
    // row0 + 8 (e / 2), column c0 + 8 i + t + 4 (e % 2)
    float dp[BN / 8][4], s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[i][e] = s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float a[4] = {da[col(8 * kk, xa)], da[8 * D + col(8 * kk, xa)],
                          da[col(8 * kk + 4, xa)],
                          da[8 * D + col(8 * kk + 4, xa)]};
      uint32_t ah[4], al[4];
      split(a, ah, al);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const float bf[2] = {vb[8 * i * D + col(8 * kk, xp)],
                             vb[8 * i * D + col(8 * kk + 4, xp)]};
        mma3(dp[i], ah, al, bf);
      }
    }
    split_sync(sp, R);  // the split's warps are done with V_j
    if (j + S < n)
      load_f32_tile<D>(vs, vg, p.v_ss, c0 + S * BN, BN, p.Sk, vec16, gtid,
                       gthreads);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait1();   // K_j has landed
    split_sync(sp, R);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float a[4] = {qa[col(8 * kk, xa)], qa[8 * D + col(8 * kk, xa)],
                          qa[col(8 * kk + 4, xa)],
                          qa[8 * D + col(8 * kk + 4, xa)]};
      uint32_t ah[4], al[4];
      split(a, ah, al);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const float bf[2] = {kb[8 * i * D + col(8 * kk, xp)],
                             kb[8 * i * D + col(8 * kk + 4, xp)]};
        mma3(s[i], ah, al, bf);
      }
    }

    // dS = P (dP - D) scale, in place of S
    const bool masked = tile_needs_mask(p, q0, c0, bm, BN);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float pv = exp2f(s[i][e] * p.scale_log2 - lse2[r]);
        if (masked && !keep(p, row0 + 8 * r, c0 + 8 * i + t + 4 * (e % 2)))
          pv = 0.f;
        s[i][e] = pv * (dp[i][e] - dl[r]) * p.scale;
      }
    // dQ += dS K_j: dS's n8 tile i is the A fragment of k8 step i
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      uint32_t ah[4], al[4];
      acc_to_a(s[i], ah, al);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const float bf[2] = {kc0[8 * i * D + col(8 * nd, xc0)],
                             kc1[8 * i * D + col(8 * nd, xc1)]};
        mma3(dq[nd], ah, al, bf);
      }
    }
    split_sync(sp, R);  // the split's warps are done with K_j
    if (j + S < n)
      load_f32_tile<D>(ks, kg, p.k_ss, c0 + S * BN, BN, p.Sk, vec16, gtid,
                       gthreads);
    cp_async_commit();
  }
  cp_async_wait_all();

  float* dqg = static_cast<float*>(p.dq) + (long long)bh * p.Sq * D;
  if (S == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<float2*>(dqg + (long long)row * D + 8 * nd +
                                   2 * t) =
            make_float2(dq[nd][2 * r], dq[nd][2 * r + 1]);
    }
    return;
  }
  // S splits: each split's dQ through the (now free) K / V tiles, added in
  // split order
  __syncthreads();
  float* const part = dos + bm * D;  // S x bm x D
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(part + (sp * bm + rg * 16 + g + 8 * r) * D +
                                 8 * nd + 2 * t) =
          make_float2(dq[nd][2 * r], dq[nd][2 * r + 1]);
  __syncthreads();
  for (int i = tid; i < bm * D; i += blockDim.x) {
    if (q0 + i / D >= p.Sq) continue;
    float acc = part[i];
    for (int k = 1; k < S; ++k) acc += part[k * bm * D + i];
    dqg[(long long)q0 * D + i] = acc;
  }
}

// dkv kernel: a block of 4 warps owns 16 R kv rows of one (batch, kv head)
// and walks the BQ-row Q and dO tiles (with their lse and D) of every
// query head of its GQA group, split S = 4 / R ways: split s takes steps
// s, s + S, ...  Shared memory holds the K and V tiles, one Q and one dO
// tile a split and their lse and D; after the walk, the splits' partial
// dK and dV go through it to be added.
template <int D, int BQ>
__global__ void __launch_bounds__(128) flash_bwd_dkv_tf32x3(const Params p,
                                                            int vec16, int R) {
  extern __shared__ __align__(16) float xsm[];
  const int S = kWarps / R, bk = 16 * R;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int sp = warp / R, rg = warp % R;  // this warp's split, row group
  const int gtid = tid % (32 * R), gthreads = 32 * R;  // within the split
  constexpr int STAGE = 2 * BQ * D + 2 * BQ;  // a split's Q, dO, lse, D
  float* const ks = xsm;                               // bk x D
  float* const vs = ks + bk * D;                       // bk x D
  float* const qs = vs + bk * D + sp * STAGE;          // BQ x D
  float* const dos = qs + BQ * D;                      // BQ x D
  float* const lse_s = dos + BQ * D;                   // BQ
  float* const dl_s = lse_s + BQ;                      // BQ

  // a 1-D grid, kv tiles in order across all (batch, kv head) pairs: the
  // longest causal columns start first
  const int nbk = p.B * p.Hkv;
  const int bkv = blockIdx.x % nbk, b = bkv / p.Hkv, hk = bkv % p.Hkv;
  const int c0 = blockIdx.x / nbk * bk;
  const int group = p.H / p.Hkv;
  const int i0 = first_q_tile(p, c0, BQ);
  const int per_head = (p.Sq + BQ - 1) / BQ - i0;
  const int steps = group * per_head;
  // step u: query head hk * group + u / per_head, q tile i0 + u % per_head
  auto head_of = [&](int u) { return hk * group + u / per_head; };
  auto q0_of = [&](int u) { return (i0 + u % per_head) * BQ; };
  auto issue_q = [&](int u) {
    const int h = head_of(u), q0 = q0_of(u);
    load_f32_tile<D>(
        qs, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
        q0, BQ, p.Sq, vec16, gtid, gthreads);
    load_vec(lse_s, p.lse + ((long long)b * p.H + h) * p.Sq + q0, BQ,
             p.Sq - q0, gtid, gthreads);
  };
  auto issue_do = [&](int u) {
    const int h = head_of(u), q0 = q0_of(u);
    load_f32_tile<D>(
        dos, static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh,
        p.do_ss, q0, BQ, p.Sq, vec16, gtid, gthreads);
    load_vec(dl_s, p.delta + ((long long)b * p.H + h) * p.Sq + q0, BQ,
             p.Sq - q0, gtid, gthreads);
  };

  load_f32_tile<D>(
      ks, static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss,
      c0, bk, p.Sk, vec16, tid, blockDim.x);
  load_f32_tile<D>(
      vs, static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss,
      c0, bk, p.Sk, vec16, tid, blockDim.x);
  cp_async_commit();
  if (sp < steps) issue_q(sp);
  cp_async_commit();
  if (sp < steps) issue_do(sp);
  cp_async_commit();
  cp_async_wait2();  // K and V have landed
  __syncthreads();

  // this lane's fragment offsets: K and V rows (A), Q and dO rows in the
  // order pi (B of S^T and dP^T), Q and dO columns (B of dS^T Q, P^T dO)
  const float* ka = ks + (rg * 16 + g) * D;
  const float* va = vs + (rg * 16 + g) * D;
  const int xa = row_x(g, t);
  const float* qb = qs + pi(g) * D;
  const float* db = dos + pi(g) * D;
  const int xp = row_x(pi(g), t);
  const int xc0 = col_x(t, g), xc1 = col_x(t + 4, g);
  const int col0 = c0 + rg * 16 + g;  // this lane's kv rows: col0, col0 + 8

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int u = sp; u < steps; u += S) {
    const int q0 = q0_of(u);
    cp_async_wait1();  // this step's Q and lse have landed
    split_sync(sp, R);
    // S^T = K Q^T and then dP^T = V dO^T: rows are kv rows, columns q rows;
    // element e of n8 tile i: kv row col0 + 8 (e / 2), q row q0 + 8 i + t +
    // 4 (e % 2)
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float a[4] = {ka[col(8 * kk, xa)], ka[8 * D + col(8 * kk, xa)],
                          ka[col(8 * kk + 4, xa)],
                          ka[8 * D + col(8 * kk + 4, xa)]};
      uint32_t ah[4], al[4];
      split(a, ah, al);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float bf[2] = {qb[8 * i * D + col(8 * kk, xp)],
                             qb[8 * i * D + col(8 * kk + 4, xp)]};
        mma3(st[i], ah, al, bf);
      }
    }
    cp_async_wait_all();  // this step's dO and D have landed
    split_sync(sp, R);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float a[4] = {va[col(8 * kk, xa)], va[8 * D + col(8 * kk, xa)],
                          va[col(8 * kk + 4, xa)],
                          va[8 * D + col(8 * kk + 4, xa)]};
      uint32_t ah[4], al[4];
      split(a, ah, al);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float bf[2] = {db[8 * i * D + col(8 * kk, xp)],
                             db[8 * i * D + col(8 * kk + 4, xp)]};
        mma3(dpt[i], ah, al, bf);
      }
    }

    // P^T in place of S^T, dS^T in place of dP^T
    const bool masked = tile_needs_mask(p, q0, c0, BQ, bk);
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * i + t + 4 * (e % 2);  // q row within the tile
        float pv = exp2f(st[i][e] * p.scale_log2 - lse_s[qc] * kLog2e);
        if (masked && !keep(p, q0 + qc, col0 + 8 * (e / 2))) pv = 0.f;
        st[i][e] = pv;
        dpt[i][e] = pv * (dpt[i][e] - dl_s[qc]) * p.scale;
      }
    // dK += dS^T Q: dS^T's n8 tile i is the A fragment of k8 step i
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      uint32_t ah[4], al[4];
      acc_to_a(dpt[i], ah, al);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const float bf[2] = {qs[(8 * i + t) * D + col(8 * nd, xc0)],
                             qs[(8 * i + t + 4) * D + col(8 * nd, xc1)]};
        mma3(dk[nd], ah, al, bf);
      }
    }
    split_sync(sp, R);  // the split's warps are done with Q and lse
    if (u + S < steps) issue_q(u + S);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    // dV += P^T dO
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      uint32_t ah[4], al[4];
      acc_to_a(st[i], ah, al);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const float bf[2] = {dos[(8 * i + t) * D + col(8 * nd, xc0)],
                             dos[(8 * i + t + 4) * D + col(8 * nd, xc1)]};
        mma3(dv[nd], ah, al, bf);
      }
    }
    split_sync(sp, R);  // the split's warps are done with dO and D
    if (u + S < steps) issue_do(u + S);
    cp_async_commit();
  }
  cp_async_wait_all();

  const long long out = (long long)bkv * p.Sk * D;
  float* dkg = static_cast<float*>(p.dk) + out;
  float* dvg = static_cast<float*>(p.dv) + out;
  if (S == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = col0 + 8 * r;
      if (row >= p.Sk) continue;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const long long e = (long long)row * D + 8 * nd + 2 * t;
        *reinterpret_cast<float2*>(dkg + e) =
            make_float2(dk[nd][2 * r], dk[nd][2 * r + 1]);
        *reinterpret_cast<float2*>(dvg + e) =
            make_float2(dv[nd][2 * r], dv[nd][2 * r + 1]);
      }
    }
    return;
  }
  // S splits: each split's dK and dV through the (now free) q-side tiles,
  // added in split order
  __syncthreads();
  float* const part = vs + bk * D;  // S x (dK, dV) x bk x D
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int e = (rg * 16 + g + 8 * r) * D + 8 * nd + 2 * t;
      *reinterpret_cast<float2*>(part + 2 * sp * bk * D + e) =
          make_float2(dk[nd][2 * r], dk[nd][2 * r + 1]);
      *reinterpret_cast<float2*>(part + (2 * sp + 1) * bk * D + e) =
          make_float2(dv[nd][2 * r], dv[nd][2 * r + 1]);
    }
  __syncthreads();
  for (int i = tid; i < bk * D; i += blockDim.x) {
    if (c0 + i / D >= p.Sk) continue;
    float ak = part[i], av = part[bk * D + i];
    for (int k = 1; k < S; ++k) {
      ak += part[2 * k * bk * D + i];
      av += part[(2 * k + 1) * bk * D + i];
    }
    dkg[(long long)c0 * D + i] = ak;
    dvg[(long long)c0 * D + i] = av;
  }
}

template <int D>
int launch(const Params& p, cudaStream_t s) {
  constexpr int BN = D == 128 ? 32 : 64;  // kv rows a dq step
  constexpr int BQ = D == 128 ? 32 : 64;  // q rows a dkv step
  const int vec16 = aligned16(p.q, p.q_sb, p.q_sh, p.q_ss) &&
                    aligned16(p.k, p.k_sb, p.k_sh, p.k_ss) &&
                    aligned16(p.v, p.v_sb, p.v_sh, p.v_ss) &&
                    aligned16(p.o, p.o_sb, p.o_sh, p.o_ss) &&
                    aligned16(p.dout, p.do_sb, p.do_sh, p.do_ss);
  const auto dq_kernel = flash_bwd_dq_tf32x3<D, BN>;
  const auto dkv_kernel = flash_bwd_dkv_tf32x3<D, BQ>;
  // shared memory: the tiles (the splits' partial results fit in theirs)
  int R = row_groups(p.Sq, (long long)p.B * p.H), S = kWarps / R;
  int smem = ((2 * 16 * R + S * 2 * BN) * D + 16 * R) * (int)sizeof(float);
  cudaError_t e = hopper::allow_smem(reinterpret_cast<const void*>(dq_kernel),
                                     smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<<<(unsigned)((p.Sq + 16 * R - 1) / (16 * R)) * p.B * p.H,
              32 * kWarps, smem, s>>>(p, vec16, R);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  R = row_groups(p.Sk, (long long)p.B * p.Hkv), S = kWarps / R;
  smem = (2 * 16 * R * D + S * (2 * BQ * D + 2 * BQ)) * (int)sizeof(float);
  e = hopper::allow_smem(reinterpret_cast<const void*>(dkv_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kernel<<<(unsigned)((p.Sk + 16 * R - 1) / (16 * R)) * p.B * p.Hkv,
               32 * kWarps, smem, s>>>(p, vec16, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace x3

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int smem, const Params& p,
           cudaStream_t s) {
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  const cudaError_t e =
      hopper::allow_smem(reinterpret_cast<const void*>(kernel), smem);
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

// path 1 (mma_sync) at D 32, 64, 128; path 2 (wgmma) at D 64, 128
template <typename T>
int launch_16(int path, int D, const Params& p, cudaStream_t s) {
  if (path == 2) {
    switch (D) {
      case 64: return wg::launch<T, 64>(p, s);
      case 128: return wg::launch<T, 128>(p, s);
    }
  } else if (path == 1) {
    switch (D) {
      case 32: return launch_tc<T, 32>(p, s);
      case 64: return launch_tc<T, 64>(p, s);
      case 128: return launch_tc<T, 128>(p, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Path codes shared with kernels/flash_fwd.py: 0 tf32x3 (f32), 1 mma_sync
// and 2 wgmma (bf16/f16); dtype 0 f32, 1 bf16, 2 f16; D 32, 64 or 128 (wgmma:
// 64, 128).  q, o and dout (B, H, S_q, D), k and v (B, H_kv, S_k, D), with
// their batch, head and sequence element strides in `strides` (15 values:
// q, k, v, o, dout; last dim contiguous; for bf16/f16 every stride a
// multiple of 8 and the bases 16-byte aligned); lse (B, H, S_q) f32; dq
// (B, H, S_q, D), dk and dv (B, H_kv, S_k, D) contiguous in the inputs'
// dtype.  Scratch: tf32x3 and mma_sync take delta (B, H, S_q) f32; wgmma
// takes delta of 2 (B H) sq_pad f32 (lse log2(e), then D), sq_pad = S_q
// rounded up to 128.  Launches the dq kernel, then the dkv kernel, on
// `stream`; returns the first CUDA error, or -1 / -2 when a TMA descriptor
// cannot be encoded.
int flash_bwd_launch(int path, int dtype, int D, const void* q,
                     const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta,
                     void* dq, void* dk, void* dv, int B, int H, int Hkv,
                     int Sq, int Sk, const long long* strides, float scale,
                     int causal, void* stream) {
  const long long* st = strides;
  const int sq_pad = (Sq + 127) / 128 * 128;
  float* const lse2 = path == 2 ? delta : nullptr;
  if (path == 2) delta += (long long)B * H * sq_pad;
  Params p{q,      k,      v,      o,      dout,   lse,    delta,  dq,
           dk,     dv,     B,      H,      Hkv,    Sq,     Sk,     st[0],
           st[1],  st[2],  st[3],  st[4],  st[5],  st[6],  st[7],  st[8],
           st[9],  st[10], st[11], st[12], st[13], st[14], scale,
           scale * kLog2e, causal, lse2,   sq_pad};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && path == 0) {
    switch (D) {
      case 32: return x3::launch<32>(p, s);
      case 64: return x3::launch<64>(p, s);
      case 128: return x3::launch<128>(p, s);
    }
  } else if (dtype == 1) {
    return launch_16<__nv_bfloat16>(path, D, p, s);
  } else if (dtype == 2) {
    return launch_16<__half>(path, D, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
