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
// f16, or in f32 over 165 TF/s, the 495 TF/s TF32 rate over the three
// products of each f32-accurate one); bytes (Q, K, V read once and O
// written once, over 3.35 TB/s) only for short sequences.
//
// Three paths, chosen by the wrapper before the launch
// (kernels/flash_fwd.py::flash_schedule):
//
// wgmma (bf16/f16, D 64 or 128, q/k/v views TMA can read: 16-byte aligned
// bases, strides multiples of 16 bytes).  A block of 384 threads owns a
// 128-row q tile of one (batch, head).  Warpgroup 0 is the producer: one
// thread TMA-loads (4-D tensor maps over the (B, H, S, D) views, 64 x 64
// boxes, 128-byte swizzle; hopper.cuh) the Q tile once, then each K and V
// tile of 128 rows into a ring of 3 (D = 128) or 4 (D = 64) mbarrier
// stages (a full barrier each for K and V, an empty barrier per stage).
// Warpgroups 1 and 2 are consumers, 64 q rows each.  S = Q K^T is an SS
// wgmma m64n128k16 (Q K-major, K as stored is K-major B); the online
// softmax stays in f32 in the accumulator registers (row max and sum over
// the 4 lanes of a row, ex2.approx of the scores times scale log2(e) less
// the row max, one FMA and one MUFU op an element); P is rounded to
// bf16/f16 in registers and is the A operand of the register-A wgmma
// m64n{D}k16 for O += P V (V as stored is MN-major B).  Each step issues S
// of tile j, rescales O while it runs, issues P V of tile j - 1, and
// computes the softmax of tile j in f32 while that P V runs (P is rounded
// into the A registers only after the product completed: ptxas serializes
// the wgmmas when a register they read is written under them), so a
// consumer keeps the tensor cores busy through most of its softmax.  The
// two consumers take turns issuing their products (a pair of named
// barriers), so one's softmax also runs under the other's products.  A
// consumer releases a stage (one arrival per warp) once its P V group on
// it completed.  Only tiles on the band's edges, or past S_k,
// are masked, by selects against each row's column band under one
// warp-uniform branch (a per-element branch cost more than the softmax).
// TMA zero-fills rows past S_q / S_k.  O / l is staged through the
// consumer's own rows of the Q tile (swizzled, conflict-free) and written
// in 16-byte stores.  Registers: producer 24, consumers 240 (setmaxnreg).
// Tensor maps are encoded on the host per call and passed as
// __grid_constant__ parameters, so CUDA-graph replays keep them.
//
// mma_sync (bf16/f16 shapes the wgmma path does not take, e.g. D = 32): 4
// warps per block, 64 q rows (16 per warp) and kv tiles of 64 rows.  Q, K
// and V tiles are staged in shared memory with 16-byte cp.async copies
// (zero-filled past S_q / S_k; rows padded by 8 elements so that ldmatrix
// is free of bank conflicts); V_j is copied while S = Q K_j^T is computed,
// and K_{j+1} while P V_j is.  Q stays in registers as mma.sync A fragments
// for the whole walk.  S and O are mma.sync m16n8k16 with f32 accumulators;
// the S accumulators of a warp are already the A fragments of P for the PV
// product once packed to bf16/f16.  O is written through shared memory in
// 16-byte chunks.
//
// tf32x3 (f32): S = Q K^T and O += P V on the tensor cores as split-TF32
// products (tf32x3.cuh: each operand split in registers into two TF32 halves,
// three mma.sync m16n8k8 .tf32 a product, f32 accuracy), the softmax, the
// rescaling and the lse in f32 on the CUDA cores as on the other paths (exp2f).
// A block of 4 warps owns 64 q rows, 16 a warp, where that gives every SM a
// block; for smaller grids 32 or 16 rows, the kv walk split 2 or 4 ways across
// the warps and the splits' (m, l, O) merged in a fixed order at the end.  kv
// tiles of 64 rows (32 at D = 128).  Q, K and V tiles are staged in shared
// memory as swizzled f32 rows by cp.async copies (16 bytes when every view's
// base and strides are 16-byte aligned, else 4 bytes), V_j copied while S = Q
// K_j^T is computed and K_{j+1} while P V_j is.  S reads K's rows in the
// permuted order of tf32x3.cuh, so each n8 tile of P is the A fragment of P V
// where it lies; V is read as stored (column fragments, no transpose).  O is
// written from the registers.
//
// Every path issues q tiles last first, so the longest causal rows start
// first (wgmma and tf32x3: across all heads, from a 1-D grid).

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

using hopper::pack2;

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

// ------------------------------------------------------------ wgmma path
namespace wg {

constexpr int BM = 128, BN = 128, THREADS = 384;

template <int D>
struct Smem {
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int Q_BYTES = BM * D * 2;   // the Q tile
  static constexpr int KV_BYTES = BN * D * 2;  // one K or V tile
  static constexpr int TILES = Q_BYTES + STAGES * 2 * KV_BYTES;
  // q_full, then full_k, full_v and empty for each stage
  static constexpr int BARRIERS = 1 + 3 * STAGES;
  // 1024 bytes of slack to align the tiles to the swizzle's 1024 bytes
  static constexpr int BYTES = TILES + 1024 + BARRIERS * 8;
};

// Columns [lo, hi] that row r keeps: the causal / window band, cut at S_k
// (rows at or past S_q get one too; they are computed and not stored).
__device__ __forceinline__ void row_band(const Params& p, int r, int& lo,
                                         int& hi) {
  hi = p.Sk - 1;
  lo = 0;
  if (p.causal) {
    const int diag = p.Sk - p.Sq;
    hi = min(hi, r + diag);
    if (p.window > 0) lo = r + diag - p.window + 1;
  }
}

// One consumer's state: its 64 rows' O accumulator, running max m (of the
// scores times scale log2(e)) and sum l, and P of the last tile.
template <int D>
struct Rows {
  float o[D / 2];
  float m[2], l[2];
  uint32_t pf[BN / 16][4];
};

// S = Q K^T for this consumer's rows (issued, not waited for)
template <typename T, int D>
__device__ __forceinline__ void issue_s(float (&sc)[BN / 2],
                                        const unsigned char* qw,
                                        const unsigned char* kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::WgmmaN<T, BN>::template ss<0>(
        sc,
        hopper::desc_k_major_sw128(qw + (kk / 4) * BM * 128 + (kk % 4) * 32),
        hopper::desc_k_major_sw128(kt + (kk / 4) * BN * 128 + (kk % 4) * 32),
        kk > 0);
  hopper::wgmma_commit();
}

// O += P V with P of the last tile in registers (issued, not waited for)
template <typename T, int D>
__device__ __forceinline__ void issue_pv(Rows<D>& st, const unsigned char* vt) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    hopper::WgmmaN<T, D>::template rs<1>(
        st.o, st.pf[kk], hopper::desc_mn_major_sw128(vt + kk * 2048, BN * 128),
        1);
  hopper::wgmma_commit();
}

// The online softmax of one S tile (columns c0 ..), in place: masks it
// where it must, updates m and l, leaves P (f32) in sc and the factor that
// rescales O in alpha.
template <int D>
__device__ __forceinline__ void softmax(const Params& p, float (&sc)[BN / 2],
                                        Rows<D>& st, int c0, int q0w, int t4,
                                        const int (&lo)[2], const int (&hi)[2],
                                        float (&alpha)[2]) {
  if (tile_needs_mask(p, q0w, c0, 64, BN)) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 8 * j + 2 * t4 + e % 2, r = e / 2;
        sc[4 * j + e] = c >= lo[r] && c <= hi[r] ? sc[4 * j + e] : -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
  const float sl2 = p.scale_log2;
  float m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(st.m[r], quad_max(mx[r]) * sl2);
    // a row with nothing unmasked yet keeps m = -inf: p = 0, alpha = 0
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = hopper::exp2_approx(st.m[r] - m_use[r]);
    st.m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] =
          hopper::exp2_approx(fmaf(sc[4 * j + e], sl2, -m_use[e / 2]));
      sum[e / 2] += sc[4 * j + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + quad_sum(sum[r]);
}

template <int D>
__device__ __forceinline__ void rescale(Rows<D>& st, const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.o[4 * j] *= alpha[0];
    st.o[4 * j + 1] *= alpha[0];
    st.o[4 * j + 2] *= alpha[1];
    st.o[4 * j + 3] *= alpha[1];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Smem<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const qs =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* const ring = qs + L::Q_BYTES;  // stage s: K, then V
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(qs + L::TILES);
  uint64_t* const full_k = q_full + 1;
  uint64_t* const full_v = full_k + STAGES;
  uint64_t* const empty = full_v + STAGES;

  // a 1-D grid, q tiles last first across all (batch, head) pairs: with
  // causal the blocks start longest first and the card ends on short ones
  const int bh = blockIdx.x % (p.B * p.H), b = bh / p.H, h = bh % p.H;
  const int q0 = ((p.Sq + BM - 1) / BM - 1 - blockIdx.x / (p.B * p.H)) * BM;
  const int hk = h / (p.H / p.Hkv);
  int j0, j1;
  kv_range(p, q0, BM, BN, j0, j1);
  const int n = max(0, j1 - j0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tq);
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      hopper::mbar_arrive_expect_tx(q_full, L::Q_BYTES);
      hopper::tma_load_tile<D, BM>(qs, &tq, q_full, q0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES, r0 = (j0 + i) * BN;
        // wait until both consumers released this stage's previous use
        if (i >= STAGES) hopper::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        unsigned char* const kt = ring + s * 2 * L::KV_BYTES;
        hopper::mbar_arrive_expect_tx(&full_k[s], L::KV_BYTES);
        hopper::tma_load_tile<D, BN>(kt, &tk, &full_k[s], r0, hk, b);
        hopper::mbar_arrive_expect_tx(&full_v[s], L::KV_BYTES);
        hopper::tma_load_tile<D, BN>(kt + L::KV_BYTES, &tv, &full_v[s], r0,
                                     hk, b);
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  hopper::setmaxnreg_inc<240>();
  const int cw = threadIdx.x / 128 - 1;  // rows q0 + 64 cw .. + 63
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int q0w = q0 + 64 * cw;
  const int row0 = q0w + 16 * warp + lane / 4;  // rows row0, row0 + 8
  const unsigned char* const qw = qs + cw * 64 * 128;
  int lo[2], hi[2];
  row_band(p, row0, lo[0], hi[0]);
  row_band(p, row0 + 8, lo[1], hi[1]);
  auto k_tile = [&](int i) { return ring + (i % STAGES) * 2 * L::KV_BYTES; };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[i % STAGES]);
  };

  Rows<D> st;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) st.o[i] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
  float sc[BN / 2], alpha[2];

  hopper::mbar_wait(q_full, 0);
  if (n > 0) {
    // tile 0: S and its softmax alone
    hopper::mbar_wait(&full_k[0], 0);
    hopper::wgmma_fence();
    issue_s<T, D>(sc, qw, k_tile(0));
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    softmax<D>(p, sc, st, j0 * BN, q0w, t4, lo, hi, alpha);
    hopper::acc_to_a<T, BN>(sc, st.pf);
  }
  // Step i issues S of tile i, rescales O while it runs, issues P V of tile
  // i - 1, and runs the softmax of tile i while that P V is on the tensor
  // cores.  The consumers take turns issuing (named barriers 3 + cw: each
  // waits on its own for the other's arrival, consumer 0 first), so one's
  // softmax runs under the other's products.
  if (cw == 1 && n > 1) hopper::pair_arrive(3);
  for (int i = 1; i < n; ++i) {
    hopper::mbar_wait(&full_k[i % STAGES], (i / STAGES) & 1);
    hopper::pair_sync(3 + cw);
    hopper::wgmma_fence();  // P was written
    issue_s<T, D>(sc, qw, k_tile(i));
    rescale<D>(st, alpha);
    hopper::mbar_wait(&full_v[(i - 1) % STAGES], ((i - 1) / STAGES) & 1);
    hopper::wgmma_fence();  // O was rescaled
    issue_pv<T, D>(st, k_tile(i - 1) + L::KV_BYTES);
    if (cw == 0 || i < n - 1) hopper::pair_arrive(4 - cw);
    hopper::wgmma_wait<1>();  // S done; P V may still run
    hopper::fence_regs(sc);
    softmax<D>(p, sc, st, (j0 + i) * BN, q0w, t4, lo, hi, alpha);
    hopper::wgmma_wait<0>();  // P V of tile i - 1 done: release its stage
    hopper::fence_regs(st.o);
    release(i - 1);
    hopper::acc_to_a<T, BN>(sc, st.pf);
  }
  if (n > 0) {
    // P V of the last tile
    rescale<D>(st, alpha);
    hopper::mbar_wait(&full_v[(n - 1) % STAGES], ((n - 1) / STAGES) & 1);
    hopper::wgmma_fence();
    issue_pv<T, D>(st, k_tile(n - 1) + L::KV_BYTES);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st.o);
    release(n - 1);
  }

  // epilogue: O / l through this consumer's own rows of the Q tile
  const float inv0 = st.l[0] > 0.f ? 1.f / st.l[0] : 0.f;
  const float inv1 = st.l[1] > 0.f ? 1.f / st.l[1] : 0.f;
  hopper::store_tile<T, D, BM>(
      st.o, inv0, inv1, qs, 64 * cw,
      static_cast<T*>(p.o) + ((long long)bh * p.Sq + q0w) * D, p.Sq - q0w,
      1 + cw);
  if (p.lse != nullptr && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row < p.Sq)
        p.lse[(long long)bh * p.Sq + row] =
            (st.m[r] + log2f(st.l[r])) * kLn2;
    }
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t s) {
  const CUtensorMapDataType type = hopper::tma_type<T>();
  CUtensorMap tq, tk, tv;
  int rc = hopper::encode_bhsd(&tq, type, p.q, p.B, p.H, p.Sq, D, p.q_sb,
                               p.q_sh, p.q_ss);
  if (rc == 0)
    rc = hopper::encode_bhsd(&tk, type, p.k, p.B, p.Hkv, p.Sk, D, p.k_sb,
                             p.k_sh, p.k_ss);
  if (rc == 0)
    rc = hopper::encode_bhsd(&tv, type, p.v, p.B, p.Hkv, p.Sk, D, p.v_sb,
                             p.v_sh, p.v_ss);
  if (rc != 0) return rc;
  const int smem = Smem<D>::BYTES;
  const cudaError_t e = hopper::allow_smem(
      reinterpret_cast<const void*>(flash_fwd_wgmma<T, D>), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = (unsigned)((p.Sq + BM - 1) / BM) * p.B * p.H;
  flash_fwd_wgmma<T, D><<<grid, THREADS, smem, s>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ------------------------------------------------------------- f32 path
namespace x3 {

using tf32x3::kWarps;

// A block of 4 warps owns 16 R q rows of one (batch, head) and walks their
// kv tiles of BN rows, split S = 4 / R ways (tf32x3.cuh): split s takes
// tiles j0 + s, j0 + s + S, ...  Shared memory holds the Q tile and one K
// and one V tile a split (swizzled f32 rows); after the walk, the splits'
// partial (m, l, O) go through it to be merged.
template <int D, int BN>
__global__ void __launch_bounds__(128) flash_fwd_tf32x3(const Params p,
                                                        int vec16, int R) {
  using namespace tf32x3;
  extern __shared__ __align__(16) float xsm[];
  const int S = kWarps / R, bm = 16 * R;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int sp = warp / R, rg = warp % R;  // this warp's split, row group
  const int gtid = tid % (32 * R), gthreads = 32 * R;  // within the split
  float* const qs = xsm;                           // bm x D
  float* const ks = qs + bm * D + sp * 2 * BN * D;  // BN x D
  float* const vs = ks + BN * D;                    // BN x D

  // a 1-D grid, q tiles last first across all (batch, head) pairs: with
  // causal the blocks start longest first and the card ends on short ones
  const int nbh = p.B * p.H;
  const int bh = blockIdx.x % nbh, b = bh / p.H, h = bh % p.H;
  const int q0 = ((p.Sq + bm - 1) / bm - 1 - blockIdx.x / nbh) * bm;
  const int hk = h / (p.H / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int j0, j1;
  kv_range(p, q0, bm, BN, j0, j1);
  load_f32_tile<D>(qs, qg, p.q_ss, q0, bm, p.Sq, vec16, tid, blockDim.x);
  cp_async_commit();
  if (j0 + sp < j1)
    load_f32_tile<D>(ks, kg, p.k_ss, (j0 + sp) * BN, BN, p.Sk, vec16, gtid,
                     gthreads);
  cp_async_commit();
  cp_async_wait1();  // Q has landed
  __syncthreads();

  // this lane's fragment offsets: Q rows (A), K rows in the order pi (B of
  // S), V columns (B of P V)
  const float* qa = qs + (rg * 16 + g) * D;
  const int xa = row_x(g, t);
  const float* kb = ks + pi(g) * D;
  const int xk = row_x(pi(g), t);
  const float* vb0 = vs + t * D;
  const float* vb1 = vs + (t + 4) * D;
  const int xv0 = col_x(t, g), xv1 = col_x(t + 4, g);

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + rg * 16 + g;  // this lane's rows: row0, row0 + 8

  for (int j = j0 + sp; j < j1; j += S) {
    const int c0 = j * BN;
    // V_j lands while S is computed; the V tile was released by the barrier
    // that ended the previous step
    load_f32_tile<D>(vs, vg, p.v_ss, c0, BN, p.Sk, vec16, gtid, gthreads);
    cp_async_commit();
    cp_async_wait1();  // K_j has landed
    split_sync(sp, R);

    // S = Q K_j^T; element e of n8 tile i: row row0 + 8 (e / 2), column
    // c0 + 8 i + t + 4 (e % 2)
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float a[4] = {qa[col(8 * kk, xa)], qa[8 * D + col(8 * kk, xa)],
                          qa[col(8 * kk + 4, xa)],
                          qa[8 * D + col(8 * kk + 4, xa)]};
      uint32_t ah[4], al[4];
      split(a, ah, al);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const float bf[2] = {kb[8 * i * D + col(8 * kk, xk)],
                             kb[8 * i * D + col(8 * kk + 4, xk)]};
        mma3(s[i], ah, al, bf);
      }
    }
    split_sync(sp, R);  // the split's warps are done with K_j
    if (j + S < j1)
      load_f32_tile<D>(ks, kg, p.k_ss, c0 + S * BN, BN, p.Sk, vec16, gtid,
                       gthreads);
    cp_async_commit();  // possibly empty: keeps the group count uniform

    const bool masked = tile_needs_mask(p, q0, c0, bm, BN);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * p.scale_log2;
        if (masked &&
            !keep(p, row0 + (e / 2) * 8, c0 + 8 * i + t + 4 * (e % 2)))
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
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = exp2f(s[i][e] - m_use[e / 2]);
        sum[e / 2] += s[i][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    cp_async_wait1();  // V_j has landed
    split_sync(sp, R);
    // O += P V_j: P's n8 tile i is the A fragment of k8 step i
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      uint32_t ah[4], al[4];
      acc_to_a(s[i], ah, al);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const float bf[2] = {vb0[8 * i * D + col(8 * nd, xv0)],
                             vb1[8 * i * D + col(8 * nd, xv1)]};
        mma3(o[nd], ah, al, bf);
      }
    }
    split_sync(sp, R);  // the split's warps are done with V_j
  }
  cp_async_wait_all();

  float* og = static_cast<float*>(p.o) + (long long)bh * p.Sq * D;
  float* lse = p.lse == nullptr ? nullptr : p.lse + (long long)bh * p.Sq;
  if (S == 1) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<float2*>(og + (long long)row * D + 8 * nd + 2 * t) =
            make_float2(o[nd][2 * r] * inv[r], o[nd][2 * r + 1] * inv[r]);
      if (lse != nullptr && t == 0) lse[row] = (m[r] + log2f(l[r])) * kLn2;
    }
    return;
  }
  // S splits: each split's (m, l, unnormalised O) through the (now free)
  // K / V tiles, then O = sum_s 2^(m_s - M) O_s / L in split order
  __syncthreads();
  float* const po = qs + bm * D;         // S x bm x D
  float* const pm = po + S * bm * D;     // S x bm
  float* const pl = pm + S * bm;         // S x bm
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = rg * 16 + g + 8 * r;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(po + (sp * bm + rr) * D + 8 * nd + 2 * t) =
          make_float2(o[nd][2 * r], o[nd][2 * r + 1]);
    if (t == 0) {
      pm[sp * bm + rr] = m[r];
      pl[sp * bm + rr] = l[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < bm * D; i += blockDim.x) {
    const int rr = i / D, row = q0 + rr;
    if (row >= p.Sq) continue;
    float mm = -INFINITY;
    for (int k = 0; k < S; ++k) mm = fmaxf(mm, pm[k * bm + rr]);
    const float m_use = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f, acc = 0.f;
    for (int k = 0; k < S; ++k) {
      const float w = exp2f(pm[k * bm + rr] - m_use);
      ll += w * pl[k * bm + rr];
      acc += w * po[k * bm * D + i];
    }
    og[(long long)row * D + i % D] = ll > 0.f ? acc / ll : 0.f;
    if (lse != nullptr && i % D == 0) lse[row] = (mm + log2f(ll)) * kLn2;
  }
}

template <int D, int BN>
int launch_bn(const Params& p, int R, cudaStream_t s) {
  const int S = kWarps / R, bm = 16 * R;
  // the tiles, and after the walk (S > 1) the splits' partial results
  const int floats = bm * D + S * 2 * BN * D;
  const int merge = bm * D + S * bm * (D + 2);
  const int smem = (floats > merge ? floats : merge) * (int)sizeof(float);
  const cudaError_t e = hopper::allow_smem(
      reinterpret_cast<const void*>(flash_fwd_tf32x3<D, BN>), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec16 = tf32x3::aligned16(p.q, p.q_sb, p.q_sh, p.q_ss) &&
                    tf32x3::aligned16(p.k, p.k_sb, p.k_sh, p.k_ss) &&
                    tf32x3::aligned16(p.v, p.v_sb, p.v_sh, p.v_ss);
  const unsigned grid = (unsigned)((p.Sq + bm - 1) / bm) * p.B * p.H;
  flash_fwd_tf32x3<D, BN><<<grid, 32 * kWarps, smem, s>>>(p, vec16, R);
  return static_cast<int>(cudaGetLastError());
}

// kv tiles of 64 rows, 32 at D = 128 (at llama2 width on the H100 they ran
// 17% faster than 64-row tiles; PERF.md)
template <int D>
int launch(const Params& p, cudaStream_t s) {
  return launch_bn<D, D == 128 ? 32 : 64>(
      p, tf32x3::row_groups(p.Sq, (long long)p.B * p.H), s);
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
  const dim3 grid((p.Sq + BM - 1) / BM, p.B * p.H);
  const int smem = (BM + 2 * BN) * (D + PAD) * sizeof(T);
  return launch(flash_fwd_tc<T, D>, grid, THREADS, smem, p, s);
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
// and 2 wgmma (bf16/f16); dtype 0 f32, 1 bf16, 2 f16; D 32, 64 or 128
// (wgmma: 64, 128).  q (B, H, S_q, D), k and v (B,
// H_kv, S_k, D) with the given element strides (last dim contiguous; for
// bf16/f16 every stride a multiple of 8 and the bases 16-byte aligned);
// o (B, H, S_q, D) contiguous in q's dtype; lse (B, H, S_q) f32 or null.
// window 0 means none.  Returns a cudaError_t, or -1 / -2 when a TMA
// descriptor cannot be encoded.
int flash_fwd_launch(int path, int dtype, int D, const void* q,
                     const void* k, const void* v, void* o, float* lse,
                     int B, int H, int Hkv, int Sq, int Sk, long long q_sb,
                     long long q_sh, long long q_ss, long long k_sb,
                     long long k_sh, long long k_ss, long long v_sb,
                     long long v_sh, long long v_ss, float scale, int causal,
                     int window, void* stream) {
  Params p{q,    k,    v,    o,    lse,  B,    H,    Hkv,
           Sq,   Sk,   q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
           v_sb, v_sh, v_ss, scale * kLog2e, causal, window};
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
