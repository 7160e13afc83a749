// K8a-d: ring collectives over per-rank buffers, written for Hopper.
//
//   K8a ring all-gather:      out_r[(src + shift) % n] = x_src, n-1 hops
//   K8b ring reduce-scatter:  out_r = sum over the ring of chunk (r+1) % n,
//                             added in the input dtype in the ring's order
//   K8c both-direction ring all-gather: ceil((n-1)/2) hops clockwise and
//                             floor((n-1)/2) counter-clockwise at once
//   K8d loopback:             a copy to self behind the neighbour barrier
//
// Replaces the TPU kernels of param_tpu/ops/ring_collectives.py:
// _ring_all_gather_kernel (ring_all_gather), _ring_reduce_scatter_kernel
// (ring_all_reduce, which follows it with the all-gather and a roll by
// one: here the all-gather's ``shift`` of 1), _bidir_all_gather_kernel
// (ring_all_gather_bidir) and _loopback_kernel (loopback_remote_copy).
// On the TPU each device runs one kernel and moves a whole chunk per hop
// with make_async_remote_copy into a double-buffered VMEM slot of its
// neighbour, behind a barrier semaphore.
//
// Here a rank is a (rank, block) column of one launch: on one card all n
// ranks run in one launch (grid.y = n); across cards one launch per card
// (grid.y = 1, rank0 = that card's rank), peers reached through peer
// pointers.  The kernel body reads only a table of per-rank pointers, so
// it does not know whether a peer is on its card.
//
// What bounds it on an H100: bytes.  A gather hop reads a chunk from the
// rank's own output (its input at hop 0) and writes it into the same place
// of the neighbour's output; a K8b hop reads the partial sum that arrived
// and the rank's own share, and writes their sum into the neighbour's slot.
// There is no arithmetic but K8b's one add per element and hop.  On one
// card all of it is HBM traffic.
//
// Design:
// - Each rank's chunk is cut into ``blocks`` byte ranges of ``per_block``
//   bytes (16-byte multiples); block b of rank r talks only to block b of
//   its neighbours, so no block waits on another block of its own rank.
//   Copies are 16-byte vectors through L2 (ld.cg / st.cg) where every
//   pointer and the length allow it, else 4-, 2- or 1-byte words.
// - Push, per (rank, direction, hop, block): the sender writes the
//   payload, then sets the receiver's ``ready`` flag of that hop with
//   st.release.sys after a system fence; the receiver polls it with
//   ld.acquire.sys.  Each hop has its own flag, so a hop whose flag never
//   came is not passed on a later hop's.  The gathers
//   (K8a, K8c) write straight into the receiver's output, where each chunk
//   has its own place, so nothing is written twice in a call and no slot
//   is needed (the TPU stages each hop in a VMEM slot; here the output is
//   as near as a slot would be).  K8b's partial sums go to the receiver's
//   two slots in turn; a slot is written again two hops later, so before
//   that the sender waits for the receiver's ``freed`` ack, which the
//   receiver sets once it has added from the slot.  Hop 0 sends straight
//   from the input, so a rank's slots are only ever written by its
//   neighbour.
// - Flags are tags ``epoch << 8 | hop + 1``; each (rank, block) keeps its
//   own call counter (``epoch``) in device memory and bumps it once per
//   call, so a later call, or a CUDA-graph replay of the same launch, never
//   takes a flag of an earlier one for its own.  Calls on one workspace are
//   ordered: stream order on one card, events across cards.
// - Every wait is bounded by the global timer (``timeout_ns``).  When it
//   runs out the block writes an error word and returns; a block that sees
//   the error word set while waiting returns too, so a fault ends the
//   launch instead of hanging it.  The wrapper reads the word and raises.
// - Co-residency: a block spins on a flag that another block sets, so all
//   blocks of a launch must be resident at once.  ring_capacity() gives
//   the number that fit; the wrapper keeps the grid within it.
// - K8b adds in the input dtype (f32, or bf16 / f16 through f32 rounded to
//   nearest even, as PyTorch's add does), in the ring's order, so it
//   matches its plain version bit for bit.
// - ``fault`` 1 plants a fault for the checks: in K8a-c rank 0 sends its
//   first clockwise hop to right + 1 instead of right.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRanks = 16;
constexpr int kMaxBlocks = 256;  // per rank; sizes the flag arrays

// flag words of one rank (u64 each), kMaxBlocks of each:
//   epoch, loopback count, barrier, freed[slot] (K8b), ready[dir][hop]
constexpr int kEpoch = 0, kLoops = 1, kBarrier = 2, kFreed = 3, kReady = 5;
constexpr int kFlagArrays = kReady + 2 * kMaxRanks;

enum { kAllGather = 0, kReduceScatter = 1, kBidir = 2, kLoopback = 3 };
enum { kWaitReady = 1, kWaitFreed = 2, kWaitBarrier = 3 };

struct Table {
  const char* x[kMaxRanks];
  char* out[kMaxRanks];
  char* slots[kMaxRanks];
  unsigned long long* flags[kMaxRanks];
};

struct Args {
  int n, shift, fault;
  long long chunk, per_block, slot_bytes, timeout_ns;
  unsigned int* err;
};

__device__ __forceinline__ unsigned long long* flag(const Table& t, int rank,
                                                    int array, int b) {
  return t.flags[rank] + (long long)array * kMaxBlocks + b;
}

// One ready word per hop: a hop whose flag never came cannot be passed by
// a later hop's flag.
__device__ __forceinline__ int ready_array(int dir, int hop) {
  return kReady + dir * kMaxRanks + hop;
}

__device__ __forceinline__ char* slot_ptr(const Table& t, const Args& a,
                                          int rank, int slot) {
  return t.slots[rank] + (long long)slot * a.slot_bytes;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned int ld_volatile(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.volatile.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long tag(unsigned long long epoch,
                                                  int hop) {
  return (epoch << 8) | (unsigned long long)(hop + 1);
}

__device__ __forceinline__ unsigned int err_code(int kind, int rank, int hop,
                                                 int what) {
  return 0x80000000u | ((unsigned)kind << 24) | ((unsigned)rank << 16) |
         ((unsigned)(hop & 0xfff) << 4) | (unsigned)what;
}

// Thread 0 waits until *p >= want; the whole block learns whether it got
// there.  Returns false (after writing the error word if it was this
// block's limit that ran out) when the launch is to stop.
__device__ bool block_wait(const unsigned long long* p,
                           unsigned long long want, const Args& a,
                           unsigned int code) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    ok = 1;
    const unsigned long long t0 = global_ns();
    while (ld_acquire(p) < want) {
      if (ld_volatile(a.err) != 0) { ok = 0; break; }
      if (global_ns() - t0 > (unsigned long long)a.timeout_ns) {
        atomicCAS_system(a.err, 0u, code);
        ok = 0;
        break;
      }
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
  const bool got = ok != 0;
  __syncthreads();  // every thread has read ``ok`` before the next wait
  return got;
}

// After the block's writes: make them visible system-wide, then set *p.
__device__ __forceinline__ void block_signal(unsigned long long* p,
                                             unsigned long long v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release(p, v);
  }
}

// dst[0:n) = src[0:n) by the whole block, in the widest words the
// alignment allows; through L2 (slots are written by other SMs or cards).
__device__ void copy_bytes(char* dst, const char* src, long long n) {
  const uintptr_t al = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)n;
  const long long tid = threadIdx.x, bd = blockDim.x;
  if ((al & 15) == 0) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    const long long nv = n >> 4;
    long long i = tid;
    for (; i + 3 * bd < nv; i += 4 * bd) {
      const int4 v0 = __ldcg(s + i), v1 = __ldcg(s + i + bd);
      const int4 v2 = __ldcg(s + i + 2 * bd), v3 = __ldcg(s + i + 3 * bd);
      __stcg(d + i, v0);
      __stcg(d + i + bd, v1);
      __stcg(d + i + 2 * bd, v2);
      __stcg(d + i + 3 * bd, v3);
    }
    for (; i < nv; i += bd) __stcg(d + i, __ldcg(s + i));
  } else if ((al & 3) == 0) {
    const unsigned* s = reinterpret_cast<const unsigned*>(src);
    unsigned* d = reinterpret_cast<unsigned*>(dst);
    for (long long i = tid; i < (n >> 2); i += bd) __stcg(d + i, __ldcg(s + i));
  } else if ((al & 1) == 0) {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
    for (long long i = tid; i < (n >> 1); i += bd) __stcg(d + i, __ldcg(s + i));
  } else {
    for (long long i = tid; i < n; i += bd) __stcg(dst + i, __ldcg(src + i));
  }
}

template <typename T>
struct AddOp;

template <>
struct AddOp<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ int4 add4(int4 a, int4 b) {
    float4 x = *reinterpret_cast<float4*>(&a);
    const float4 y = *reinterpret_cast<float4*>(&b);
    x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
    return *reinterpret_cast<int4*>(&x);
  }
};

template <>
struct AddOp<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  static __device__ __forceinline__ int4 add4(int4 a, int4 b) {
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fx = __bfloat1622float2(x[j]), fy = __bfloat1622float2(y[j]);
      x[j] = __floats2bfloat162_rn(fx.x + fy.x, fx.y + fy.y);
    }
    return a;
  }
};

template <>
struct AddOp<__half> {
  static __device__ __forceinline__ __half add(__half a, __half b) {
    return __float2half_rn(__half2float(a) + __half2float(b));
  }
  static __device__ __forceinline__ int4 add4(int4 a, int4 b) {
    __half2* x = reinterpret_cast<__half2*>(&a);
    const __half2* y = reinterpret_cast<const __half2*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fx = __half22float2(x[j]), fy = __half22float2(y[j]);
      x[j] = __floats2half2_rn(fx.x + fy.x, fx.y + fy.y);
    }
    return a;
  }
};

// One element through L2, as its raw bits.
template <typename T>
__device__ __forceinline__ T ldcg_elem(const T* p) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 2, "f32, bf16 or f16");
  T v;
  if constexpr (sizeof(T) == 4) {
    const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(p));
    memcpy(&v, &u, 4);
  } else {
    const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&v, &u, 2);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void stcg_elem(T* p, T v) {
  if constexpr (sizeof(T) == 4) {
    unsigned u;
    memcpy(&u, &v, 4);
    __stcg(reinterpret_cast<unsigned*>(p), u);
  } else {
    unsigned short u;
    memcpy(&u, &v, 2);
    __stcg(reinterpret_cast<unsigned short*>(p), u);
  }
}

// dst = a + b elementwise in T over n bytes (a: a received partial sum read
// through L2, b: the rank's own input).
template <typename T>
__device__ void add_bytes(char* dst, const char* a, const char* b,
                          long long n) {
  const uintptr_t al = (uintptr_t)dst | (uintptr_t)a | (uintptr_t)b |
                       (uintptr_t)n;
  const long long tid = threadIdx.x, bd = blockDim.x;
  if ((al & 15) == 0) {
    const int4* pa = reinterpret_cast<const int4*>(a);
    const int4* pb = reinterpret_cast<const int4*>(b);
    int4* d = reinterpret_cast<int4*>(dst);
    for (long long i = tid; i < (n >> 4); i += bd)
      __stcg(d + i, AddOp<T>::add4(__ldcg(pa + i), __ldcg(pb + i)));
  } else {
    const T* pa = reinterpret_cast<const T*>(a);
    const T* pb = reinterpret_cast<const T*>(b);
    T* d = reinterpret_cast<T*>(dst);
    for (long long i = tid; i < n / (long long)sizeof(T); i += bd) {
      T v = AddOp<T>::add(ldcg_elem(pa + i), ldcg_elem(pb + i));
      stcg_elem(d + i, v);
    }
  }
}

struct Block {
  int rank, b;
  long long lo, nb;
  unsigned long long epoch;
};

// This block's byte range and call number; false if its range is empty
// (then no rank's block b has anything to move).
__device__ bool block_setup(const Table& t, const Args& a, int rank0,
                            Block* blk) {
  __shared__ unsigned long long epoch;
  blk->rank = rank0 + blockIdx.y;
  blk->b = blockIdx.x;
  blk->lo = (long long)blockIdx.x * a.per_block;
  if (blk->lo >= a.chunk) return false;
  blk->nb = min(a.per_block, a.chunk - blk->lo);
  if (threadIdx.x == 0)
    epoch = ld_acquire(flag(t, blk->rank, kEpoch, blk->b)) + 1;
  __syncthreads();
  blk->epoch = epoch;
  return true;
}

__device__ void block_finish(const Table& t, const Block& blk) {
  __syncthreads();
  if (threadIdx.x == 0) *flag(t, blk.rank, kEpoch, blk.b) = blk.epoch;
}

// One hop of a ring gather in direction ``dir``: the chunk of rank ``c``
// (this rank's input at hop 0, else what arrived at hop - 1) goes to the
// same place in ``to``'s output; then ``to`` is told.
__device__ void gather_send(const Table& t, const Args& a, const Block& blk,
                            int dir, int to, int hop, int c) {
  const long long off = (long long)((c + a.shift) % a.n) * a.chunk + blk.lo;
  const char* src = hop == 0 ? t.x[blk.rank] + blk.lo : t.out[blk.rank] + off;
  copy_bytes(t.out[to] + off, src, blk.nb);
  block_signal(flag(t, to, ready_array(dir, hop), blk.b),
               tag(blk.epoch, hop));
}

// Waits until the chunk of hop ``hop`` in direction ``dir`` has arrived.
__device__ __forceinline__ bool gather_wait(const Table& t, const Args& a,
                                            const Block& blk, int kind,
                                            int dir, int hop) {
  return block_wait(flag(t, blk.rank, ready_array(dir, hop), blk.b),
                    tag(blk.epoch, hop), a,
                    err_code(kind, blk.rank, hop, kWaitReady));
}

__global__ void __launch_bounds__(kThreads)
ring_all_gather_kernel(Table t, Args a, int rank0) {
  Block blk;
  if (!block_setup(t, a, rank0, &blk)) return;
  const int n = a.n, r = blk.rank, right = (r + 1) % n;
  copy_bytes(t.out[r] + ((r + a.shift) % n) * a.chunk + blk.lo,
             t.x[r] + blk.lo, blk.nb);
  for (int i = 0; i < n - 1; ++i) {
    const int to = (a.fault == 1 && r == 0 && i == 0) ? (right + 1) % n
                                                      : right;
    // send the chunk of rank r - i; then rank r - i - 1's arrives
    gather_send(t, a, blk, 0, to, i, (r - i + n) % n);
    if (!gather_wait(t, a, blk, kAllGather, 0, i)) return;
  }
  block_finish(t, blk);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_reduce_scatter_kernel(Table t, Args a, int rank0) {
  Block blk;
  if (!block_setup(t, a, rank0, &blk)) return;
  const int n = a.n, r = blk.rank;
  const int left = (r + n - 1) % n, right = (r + 1) % n;
  const char* x = t.x[r];
  for (int i = 0; i < n - 1; ++i) {
    const int slot = (i + 1) & 1;
    const int to = (a.fault == 1 && r == 0 && i == 0) ? (right + 1) % n
                                                      : right;
    if (i >= 2 &&
        !block_wait(flag(t, r, kFreed + slot, blk.b), tag(blk.epoch, i - 2),
                    a, err_code(kReduceScatter, r, i, kWaitFreed)))
      return;
    char* dst = slot_ptr(t, a, to, slot) + blk.lo;
    if (i == 0) {
      copy_bytes(dst, x + r * a.chunk + blk.lo, blk.nb);
    } else {
      // arrived at hop i - 1: the partial sum of chunk r - i; add my share
      add_bytes<T>(dst, slot_ptr(t, a, r, i & 1) + blk.lo,
                   x + ((r - i + n) % n) * a.chunk + blk.lo, blk.nb);
    }
    block_signal(flag(t, to, ready_array(0, i), blk.b), tag(blk.epoch, i));
    // the slot that arrived at hop i - 1 is free again: tell the left
    if (i >= 1 && threadIdx.x == 0)
      st_release(flag(t, left, kFreed + (i & 1), blk.b),
                 tag(blk.epoch, i - 1));
    if (!block_wait(flag(t, r, ready_array(0, i), blk.b),
                    tag(blk.epoch, i), a,
                    err_code(kReduceScatter, r, i, kWaitReady)))
      return;
  }
  char* out = t.out[r] + blk.lo;
  if (n == 1) {
    copy_bytes(out, x + blk.lo, blk.nb);
  } else {
    // the full sum of chunk r + 1: the last partial plus my share
    add_bytes<T>(out, slot_ptr(t, a, r, (n - 1) & 1) + blk.lo,
                 x + ((r + 1) % n) * a.chunk + blk.lo, blk.nb);
  }
  block_finish(t, blk);
}

__global__ void __launch_bounds__(kThreads)
ring_bidir_all_gather_kernel(Table t, Args a, int rank0) {
  Block blk;
  if (!block_setup(t, a, rank0, &blk)) return;
  const int n = a.n, r = blk.rank;
  const int left = (r + n - 1) % n, right = (r + 1) % n;
  copy_bytes(t.out[r] + ((r + a.shift) % n) * a.chunk + blk.lo,
             t.x[r] + blk.lo, blk.nb);
  const int cw_hops = n / 2;         // chunks r-1 .. r-cw_hops, from the left
  const int ccw_hops = (n - 1) / 2;  // chunks r+1 .. r+ccw_hops, from the right
  const int hops = cw_hops > ccw_hops ? cw_hops : ccw_hops;
  for (int i = 0; i < hops; ++i) {
    const int to = (a.fault == 1 && r == 0 && i == 0) ? (right + 1) % n
                                                      : right;
    if (i < cw_hops) gather_send(t, a, blk, 0, to, i, (r - i + n) % n);
    if (i < ccw_hops) gather_send(t, a, blk, 1, left, i, (r + i) % n);
    if (i < cw_hops && !gather_wait(t, a, blk, kBidir, 0, i)) return;
    if (i < ccw_hops && !gather_wait(t, a, blk, kBidir, 1, i)) return;
  }
  block_finish(t, blk);
}

__global__ void __launch_bounds__(kThreads)
ring_loopback_kernel(Table t, Args a, int rank0) {
  Block blk;
  if (!block_setup(t, a, rank0, &blk)) return;
  const int n = a.n, r = blk.rank;
  const int left = (r + n - 1) % n, right = (r + 1) % n;
  // the neighbour barrier: signal both neighbours, wait for both
  __shared__ unsigned long long loops;
  if (threadIdx.x == 0) {
    loops = ld_acquire(flag(t, r, kLoops, blk.b)) + 1;
    atomicAdd_system(flag(t, left, kBarrier, blk.b), 1ull);
    atomicAdd_system(flag(t, right, kBarrier, blk.b), 1ull);
  }
  __syncthreads();
  if (!block_wait(flag(t, r, kBarrier, blk.b), 2 * loops, a,
                  err_code(kLoopback, r, 0, kWaitBarrier)))
    return;
  // the "remote" copy: to this rank's output through the peer table
  copy_bytes(t.out[r] + blk.lo, t.x[r] + blk.lo, blk.nb);
  block_signal(flag(t, r, ready_array(0, 0), blk.b), tag(blk.epoch, 0));
  if (!block_wait(flag(t, r, ready_array(0, 0), blk.b), tag(blk.epoch, 0), a,
                  err_code(kLoopback, r, 0, kWaitReady)))
    return;
  if (threadIdx.x == 0) *flag(t, r, kLoops, blk.b) = loops;
  block_finish(t, blk);
}

typedef void (*RingKernel)(Table, Args, int);

RingKernel pick(int kind, int dtype) {
  switch (kind) {
    case kAllGather: return ring_all_gather_kernel;
    case kBidir: return ring_bidir_all_gather_kernel;
    case kLoopback: return ring_loopback_kernel;
    case kReduceScatter:
      if (dtype == 0) return ring_reduce_scatter_kernel<float>;
      if (dtype == 1) return ring_reduce_scatter_kernel<__nv_bfloat16>;
      if (dtype == 2) return ring_reduce_scatter_kernel<__half>;
      return nullptr;
    default: return nullptr;
  }
}

// Makes ``device`` current for its lifetime and restores the caller's
// device after (the caller's runtime reads the same thread state).
struct OnDevice {
  int prev = -1;
  cudaError_t status;
  explicit OnDevice(int device) {
    status = cudaGetDevice(&prev);
    if (status == cudaSuccess && prev != device) status = cudaSetDevice(device);
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

extern "C" {

// Blocks of the ``kind`` kernel that can be resident on ``device`` at once
// (a negative cudaError_t on failure).
int ring_capacity(int kind, int dtype, int device) {
  RingKernel k = pick(kind, dtype);
  if (k == nullptr) return -(int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.status != cudaSuccess) return -(int)on.status;
  int per_sm = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(k), kThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms;
}

// Lets kernels on ``device`` read and write ``peer``'s memory.
int ring_enable_peer(int device, int peer) {
  OnDevice on(device);
  if (on.status != cudaSuccess) return (int)on.status;
  cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: already enabled is what we want
    return 0;
  }
  return (int)e;
}

// One launch of ranks rank0 .. rank0 + ranks_here - 1 on ``device``.
// xs / outs / slots / flags hold the n ranks' pointers (peer pointers for
// ranks on other cards).  Returns cudaGetLastError().
int ring_launch(int kind, int dtype, int n, int rank0, int ranks_here,
                int device, const long long* xs, const long long* outs,
                const long long* slots, const long long* flags,
                long long chunk, long long per_block, int blocks,
                long long slot_bytes, int shift, int fault,
                long long timeout_ns, void* err, void* stream) {
  RingKernel k = pick(kind, dtype);
  if (k == nullptr || n < 1 || n > kMaxRanks || blocks < 1 ||
      blocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.status != cudaSuccess) return (int)on.status;
  Table t;
  for (int r = 0; r < n; ++r) {
    t.x[r] = reinterpret_cast<const char*>(xs[r]);
    t.out[r] = reinterpret_cast<char*>(outs[r]);
    t.slots[r] = reinterpret_cast<char*>(slots[r]);
    t.flags[r] = reinterpret_cast<unsigned long long*>(flags[r]);
  }
  Args a;
  a.n = n;
  a.shift = shift;
  a.fault = fault;
  a.chunk = chunk;
  a.per_block = per_block;
  a.slot_bytes = slot_bytes;
  a.timeout_ns = timeout_ns;
  a.err = reinterpret_cast<unsigned int*>(err);
  k<<<dim3(blocks, ranks_here), kThreads, 0,
      reinterpret_cast<cudaStream_t>(stream)>>>(t, a, rank0);
  return (int)cudaGetLastError();
}

// Words of one rank's flag block, and the largest block count per rank.
int ring_flag_words() { return kFlagArrays * kMaxBlocks; }
int ring_max_blocks() { return kMaxBlocks; }

}  // extern "C"
