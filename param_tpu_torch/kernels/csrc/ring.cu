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
// pointers.  The kernel body reads only a table of per-rank pointers.
//
// What bounds it on an H100: bytes.  K8a and K8c must read each input
// once and write n outputs of n chunks each (n + n^2 chunks of HBM
// traffic); K8b must read each input once and write its chunk of the sum;
// K8d must read each input once and write it once.  There is no arithmetic
// but K8b's one add per element and hop.  What a ring adds on top is the
// forwarded bytes: a rank reads back every chunk it passes on (K8a, K8c)
// or every partial sum it adds to (K8b).  A whole-range hop (a whole chunk
// a hop) reads them back from HBM on one card, because the n ranks write n
// whole chunks between a chunk's arrival and its forward, far more than
// the 50 MB L2; and it pays a signal, a fence and a poll per hop.
//
// K8a, K8b and K8c: slice-pipelined hops (as NCCL's slice pipeline).
// - Each rank's chunk is cut into ``blocks`` byte ranges of ``per_block``
//   bytes; block b of rank r talks only to block b of its neighbours.  Each
//   range is cut into slices of S = 2^slice_log2 bytes (the last one
//   ragged).  A block walks steps t = 0, 1, ...; at step t it runs hop i of
//   slice t - lag * i for every hop i at once, so a slice goes round the
//   ring ``lag`` steps a hop behind itself and a forwarded slice is read a
//   step or two after it was written, while it is still in L2.  The
//   working set, ranks x blocks x hops x S x (lag + 1), is kept under the
//   L2 by ``kernels/ring.ring_plan``, which picks blocks, S, lag and slots.
// - A step waits once for all its hops and signals once for all of them,
//   so a signal's cost is paid once a step, not once a hop: lane j of warp
//   0 plans a hop, waits for what it reads, and after the whole block has
//   copied, releases what it wrote.  Waits poll without sleeping and read
//   the error word and the clock only now and then.
// - K8c runs both directions in the same steps: n / 2 clockwise hops (to
//   the right) and (n - 1) / 2 counter-clockwise (to the left), n - 1 hops
//   a step as K8a, but a slice's longest chain is n / 2 hops, so the
//   pipeline fills in half the steps.  Hop 0 of both directions reads the
//   same input slice: one job writes it to the right neighbour, the left
//   one and the rank's own row, so the input is read once.  Each direction
//   has its own ready counters (ready[dir][hop]).
// - Memory route (K8a, K8c; K8b across cards, or over more than 8 ranks):
//   each (rank, block, direction, hop) has an arrival counter ``ready``,
//   bumped by the sender with a release store to ``epoch << 32 | slices
//   sent``.  K8a and K8c write straight into the receiver's output (each
//   chunk has its own place there); hop 0 reads the rank's input and also
//   writes its own copy.  K8b's partial sums go into a ring of D =
//   ``slots`` slices per (rank, block, hop) of the receiver's global
//   workspace; the receiver adds its own share and sends the sum on (the
//   last hop writes the output), then bumps the sender's ``freed``
//   counter; a sender writes slot s % D only once freed covers slice s -
//   D.  The workspace is blocks x (n - 1) x D x S bytes a rank, whatever
//   the chunk.
// - Cluster route (K8b with 2 to 8 ranks on one card): block b of every
//   rank is one thread-block cluster, so the slots are in the receiver's
//   shared memory: a partial goes from the sender's registers straight
//   into them (distributed shared memory) and never through L2, and the
//   ready / freed counters are mbarriers there, arrived on remotely.  No
//   block of a cluster waits on another cluster, so the grid need not be
//   resident at once.  On the memory route the partials' round trip
//   through L2 (twice the input's bytes at n = 8) bounded K8b.
// - D > lag, so no step waits on a step of its own time.
// - Adds stay in the input dtype, one correctly rounded add a hop in the
//   ring's order (f32, or bf16 / f16 through f32 rounded to nearest even,
//   as PyTorch's add does), so K8b matches its plain version bit for bit.
// - Copies: 16-byte vectors, four a thread in flight (K8b: four pairs),
//   over all the step's hops at once, when every base and the chunk are
//   16-byte multiples; else the widest words the alignment allows, hop by
//   hop.  Data written by another block is read through L2 (ld.cg); the
//   inputs and the bytes no one reads again in the launch are streamed
//   (ld.cs / st.cs).
// - Scope (template): when every rank is on one card, GPU-scope acquire /
//   release; across cards, system scope.
//
// K8d, and K8a-c over one rank (a copy): the chunk in 10 KiB tiles,
// copied through shared memory by Hopper's bulk-copy engine
// (cp.async.bulk), one thread a block issuing every copy, a ring of slots
// keeping loads in flight; after each block's first tiles the rest are
// dealt out by a per-rank ticket counter, so the blocks end together (with
// a fixed share each, the slowest block's tail cost the copy 3-4% against
// cudaMemcpy).  K8d's neighbour barrier overlaps its first loads, which
// read only the rank's own input; it stores nothing before the barrier.
// Both are bound by their bytes: the input read once, the output written
// once; K8d also by its handshake, a few round trips to L2 a block.
//
// Safety, in every kernel:
// - Global counters are tags ``epoch << 32 | count``; each (rank, block)
//   keeps its own call counter (``epoch``) in device memory and bumps it
//   once per call, so a later call, or a CUDA-graph replay of the same
//   launch, never takes a count of an earlier one for its own (the
//   cluster route's mbarriers are made anew by each launch).  Calls on one
//   workspace are ordered: stream order on one card, events across cards.
// - Every wait is bounded by the global timer (``timeout_ns``).  When it
//   runs out the block writes an error word and stops; a block that sees
//   the error word set while waiting stops too, so a fault ends the launch
//   instead of hanging it (on the cluster route a stopped block still
//   meets its peers at the final cluster barrier).  The wrapper reads the
//   word and raises.
// - Co-residency: on the memory route and in K8d a block spins on a
//   counter that another block sets, so all blocks of a launch must be
//   resident at once.  ring_capacity() gives the number that fit; the
//   wrapper keeps the grid within it.
// - A block's flag words lie together, in lines of their own, so no two
//   blocks' signals and polls contend for a line.
// - ``fault`` 1 plants a fault for the checks: in K8a-c rank 0 sends its
//   first clockwise hop to right + 1 instead of right.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kClusterThreads = 256;  // K8b's cluster route: three an SM
constexpr int kMaxRanks = 16;
constexpr int kMaxBlocks = 1024;  // per rank; sizes the flag arrays
constexpr unsigned kPollsPerCheck = 16;  // a wait reads the error word and
                                         // the clock once in so many polls

// flag words of one rank (u64 each), kMaxBlocks of each:
//   epoch, loopback count, barrier, freed[hop] (K8b), ready[dir][hop], and
//   the copy's ticket counter (block 0's word is the rank's)
constexpr int kEpoch = 0, kLoops = 1, kBarrier = 2, kFreed = 3,
              kReady = kFreed + kMaxRanks, kTicket = kReady + 2 * kMaxRanks;
constexpr int kFlagStride = 64;  // words a block: kTicket + 1, in whole lines
static_assert(kTicket < kFlagStride, "a block's flag words overflow");

enum {
  kAllGather = 0,
  kReduceScatter = 1,
  kBidir = 2,
  kLoopback = 3,
  kReduceScatterCluster = 4,  // K8b with its slots in a cluster's shared
                              // memory (one card)
  kCopy = 5                   // K8a or K8b over one rank
};
enum { kWaitReady = 1, kWaitFreed = 2, kWaitBarrier = 3 };
enum { kGpu = 0, kSys = 1 };

struct Table {
  const char* x[kMaxRanks];
  char* out[kMaxRanks];
  char* slots[kMaxRanks];
  unsigned long long* flags[kMaxRanks];
};

struct Args {
  int n, shift, fault, vec, lag, slots, slice_log2;
  long long chunk, per_block, timeout_ns;
  unsigned int* err;
};

// Block b's words of every array lie together, kFlagStride words (whole
// 128-byte lines) a block, so the blocks' signals and polls never share a
// line (on one card they had contended there).
__device__ __forceinline__ unsigned long long* flag(const Table& t, int rank,
                                                    int array, int b) {
  return t.flags[rank] + (long long)b * kFlagStride + array;
}

// One ready word per hop: a hop whose counter never came cannot be passed
// by a later hop's.
__device__ __forceinline__ int ready_array(int dir, int hop) {
  return kReady + dir * kMaxRanks + hop;
}

template <int S>
__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  if constexpr (S == kSys)
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
  return v;
}

template <int S>
__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  if constexpr (S == kSys)
    asm volatile("st.release.sys.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
  else
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

// Makes the block's writes before the last __syncthreads visible at the
// scope before the release stores that follow.
template <int S>
__device__ __forceinline__ void fence() {
  if constexpr (S == kSys)
    asm volatile("fence.acq_rel.sys;" ::: "memory");
  else
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
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
                                                  long long count) {
  return (epoch << 32) | (unsigned long long)count;
}

__device__ __forceinline__ unsigned int err_code(int kind, int rank, int hop,
                                                 int what) {
  return 0x80000000u | ((unsigned)kind << 24) | ((unsigned)rank << 16) |
         ((unsigned)(hop & 0xfff) << 4) | (unsigned)what;
}

// One thread waits until *p >= want.  ``seen`` keeps the largest value
// this thread has acquired from p, so a counter that is already ahead
// costs no load.  The poll is a bare acquire load: the error word and the
// clock are read once in kPollsPerCheck polls.  Returns false (after
// writing the error word if it was this thread's limit that ran out) when
// the launch is to stop.
template <int S>
__device__ bool thread_wait(const unsigned long long* p,
                            unsigned long long want, unsigned long long* seen,
                            const Args& a, unsigned int code) {
  if (*seen >= want) return true;
  unsigned long long v = ld_acquire<S>(p);
  const unsigned long long t0 = global_ns();
  for (unsigned polls = 1; v < want; ++polls) {
    if ((polls & (kPollsPerCheck - 1)) == 0) {  // now and then: give up?
      if (ld_volatile(a.err) != 0) return false;
      if (global_ns() - t0 > (unsigned long long)a.timeout_ns) {
        atomicCAS_system(a.err, 0u, code);
        return false;
      }
    }
    v = ld_acquire<S>(p);
  }
  *seen = v;
  return true;
}

// dst[0:n) = src[0:n) by threads 0 .. bd - 1, in the widest words the
// alignment allows; through L2 (slots are written by other SMs or cards).
__device__ void copy_bytes(char* dst, const char* src, long long n,
                           long long bd = kThreads) {
  const uintptr_t al = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)n;
  const long long tid = threadIdx.x;
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
// through L2, b: the rank's own input) by threads 0 .. bd - 1, in the
// widest words allowed.
template <typename T>
__device__ void add_bytes(char* dst, const char* a, const char* b,
                          long long n, long long bd) {
  const uintptr_t al = (uintptr_t)dst | (uintptr_t)a | (uintptr_t)b |
                       (uintptr_t)n;
  const long long tid = threadIdx.x;
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

// This block's rank and byte range; false if its range is empty (then no
// rank's block b has anything to move).
__device__ __forceinline__ bool block_range(const Args& a, int rank0,
                                            Block* blk) {
  blk->rank = rank0 + blockIdx.y;
  blk->b = blockIdx.x;
  blk->lo = (long long)blockIdx.x * a.per_block;
  if (blk->lo >= a.chunk) return false;
  blk->nb = min(a.per_block, a.chunk - blk->lo);
  return true;
}

// block_range, and the block's call number.
template <int S>
__device__ bool block_setup(const Table& t, const Args& a, int rank0,
                            Block* blk) {
  __shared__ unsigned long long epoch;
  if (!block_range(a, rank0, blk)) return false;
  if (threadIdx.x == 0)
    epoch = ld_acquire<S>(flag(t, blk->rank, kEpoch, blk->b)) + 1;
  __syncthreads();
  blk->epoch = epoch;
  return true;
}

// ------------------------------------------- K8a, K8b, K8c: sliced steps
// One hop's work in one step: dst[0:len) = (a ? a + b : b), and also
// dst2 = b (a gather's hop 0 keeps its own chunk) and dst3 = b (K8c's hop
// 0 also sends the same slice the other way round).  ``b_in``: b is the
// rank's input (streamed); ``last`` / ``last3``: no one reads dst / dst3
// again in this launch.
struct Job {
  char* dst;   // global: the receiver's output, or (K8b) its slot
  char* dst2;  // global: a gather's hop 0 keeps its own chunk here
  char* dst3;  // global: K8c's hop 0, the left neighbour's output
  char* peer;  // K8b's cluster route: the receiver's slot (shared memory)
  const char* a;
  const char* b;
  int len;
  int b_in, last, last3;
};

// One job of the cluster route element by element: b is the rank's
// input, a (if any) a slot in this block's shared memory, dst global and
// peer a slot of a cluster peer.
template <typename T, int kN>
__device__ void cluster_elems(const Job& jb) {
  const T* pa = reinterpret_cast<const T*>(jb.a);
  const T* pb = reinterpret_cast<const T*>(jb.b);
  for (int i = threadIdx.x; i < jb.len / (int)sizeof(T); i += kN) {
    T v = ldcg_elem(pb + i);
    if (pa) v = AddOp<T>::add(pa[i], v);
    if (jb.dst) stcg_elem(reinterpret_cast<T*>(jb.dst) + i, v);
    if (jb.peer) reinterpret_cast<T*>(jb.peer)[i] = v;
  }
}

// The step's jobs by the block (kN threads).  ``kSmem`` (K8b's cluster
// route): a and peer are slots in shared memory of this block or a
// cluster peer, reached by generic addresses; else everything is global,
// and what other blocks wrote is read through L2.  ``k3``: jobs may have
// a third destination (K8c), so K8a and K8b compile without its test.
// Vector path: item k is vector k & (2^vlog - 1) of job k >> vlog; each
// thread loads kU items before it stores any, over all the step's hops at
// once.
template <typename T, bool kAdds, bool kSmem, int kN = kThreads,
          bool k3 = false>
__device__ void run_jobs(const Job* jobs, int nj, int slice_log2, bool vec) {
  if (!vec) {
    for (int j = 0; j < nj; ++j) {
      const Job& jb = jobs[j];
      if constexpr (kSmem) {
        cluster_elems<T, kN>(jb);
        continue;
      } else if constexpr (kAdds) {
        if (jb.a) add_bytes<T>(jb.dst, jb.a, jb.b, jb.len, kN);
        else copy_bytes(jb.dst, jb.b, jb.len, kN);
      } else {
        copy_bytes(jb.dst, jb.b, jb.len, kN);
      }
      if (jb.dst2) copy_bytes(jb.dst2, jb.b, jb.len, kN);
      if (k3 && jb.dst3) copy_bytes(jb.dst3, jb.b, jb.len, kN);
    }
    return;
  }
  constexpr int kU = 4;
  const int vlog = slice_log2 - 4;
  const int mask = (1 << vlog) - 1;
  const int total = nj << vlog;
  for (int base = threadIdx.x; base < total; base += kU * kN) {
    int4 vb[kU], va[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int k = base + u * kN;
      const int j = k >> vlog, e = k & mask;
      if (k < total && (e << 4) < jobs[j].len) {
        const Job& jb = jobs[j];
        const int4* pb = reinterpret_cast<const int4*>(jb.b) + e;
        vb[u] = jb.b_in ? __ldcs(pb) : __ldcg(pb);
        if (kAdds && jb.a) {
          const int4* pa = reinterpret_cast<const int4*>(jb.a) + e;
          va[u] = kSmem ? *pa : __ldcg(pa);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int k = base + u * kN;
      const int j = k >> vlog, e = k & mask;
      if (k >= total || (e << 4) >= jobs[j].len) continue;
      const Job& jb = jobs[j];
      int4 v = vb[u];
      if (kAdds && jb.a) v = AddOp<T>::add4(va[u], v);
      if (jb.dst) {
        int4* d = reinterpret_cast<int4*>(jb.dst) + e;
        if (jb.last) __stcs(d, v);
        else __stcg(d, v);
      }
      if (jb.dst2) __stcs(reinterpret_cast<int4*>(jb.dst2) + e, v);
      if (k3 && jb.dst3) {
        int4* d = reinterpret_cast<int4*>(jb.dst3) + e;
        if (jb.last3) __stcs(d, v);
        else __stcg(d, v);
      }
      if (kSmem && jb.peer) reinterpret_cast<int4*>(jb.peer)[e] = v;
    }
  }
}

// What lane ``hop`` of warp 0 does in step t: its job (if the hop runs),
// its waits and its signals.
struct Plan {
  bool on;
  Job job;
  const unsigned long long* wait[2];
  unsigned long long want[2];
  unsigned long long* sig[2];
  unsigned long long sig_v;
  int sig_rank[2];  // the cluster peer of each signal (cluster K8b)
};

// K8a, hop i (0 .. n - 2) of slice s.
__device__ void gather_hop(const Table& t, const Args& a, const Block& blk,
                           int i, long long s, Plan* p) {
  const int n = a.n, r = blk.rank, right = (r + 1) % n;
  const long long off = s << a.slice_log2;
  const int c = (r - i + n) % n;  // the rank whose chunk this hop moves
  const long long at = (long long)((c + a.shift) % n) * a.chunk + blk.lo + off;
  p->job.len = (int)min((long long)1 << a.slice_log2, blk.nb - off);
  p->job.a = nullptr;
  const int to = (a.fault == 1 && r == 0 && i == 0) ? (right + 1) % n : right;
  p->job.dst = t.out[to] + at;
  p->job.dst2 = i == 0 ? t.out[r] + at : nullptr;
  p->job.b = i == 0 ? t.x[r] + blk.lo + off : t.out[r] + at;
  p->job.b_in = i == 0;
  p->job.last = i == n - 2;
  if (i >= 1) {  // arrived at hop i - 1
    p->wait[0] = flag(t, r, ready_array(0, i - 1), blk.b);
    p->want[0] = tag(blk.epoch, s + 1);
  }
  p->sig[0] = flag(t, to, ready_array(0, i), blk.b);
  p->sig_v = tag(blk.epoch, s + 1);
}

// K8c's lanes: lane j < n / 2 plans clockwise hop j (to the right,
// carrying rank r - j's chunk); lane n / 2 + k - 1 counter-clockwise hop
// k = 1 .. (n - 1) / 2 - 1 (to the left, rank r + k's chunk).  The
// counter-clockwise hop 0 reads the same input slice as the clockwise one,
// so lane 0 does both.  n - 1 hops, in n - 2 lanes from n = 3 on.
__device__ __forceinline__ int bidir_lanes(int n) {
  const int ccw = (n - 1) / 2;
  return n / 2 + (ccw > 1 ? ccw - 1 : 0);
}

// K8c, hop i of direction ``dir`` (0 clockwise, 1 counter-clockwise) of
// slice s.  The output row of each chunk is its rank (the reference's
// o_ref[src]); hop i > 0 forwards what arrived at hop i - 1 of the same
// direction.
__device__ void bidir_hop(const Table& t, const Args& a, const Block& blk,
                          int dir, int i, long long s, Plan* p) {
  const int n = a.n, r = blk.rank;
  const int left = (r + n - 1) % n, right = (r + 1) % n;
  const int ccw_hops = (n - 1) / 2;
  const long long off = s << a.slice_log2;
  const int c = dir == 0 ? (r - i + n) % n : (r + i) % n;
  const long long at = (long long)c * a.chunk + blk.lo + off;
  p->job.len = (int)min((long long)1 << a.slice_log2, blk.nb - off);
  p->job.a = nullptr;
  int to = dir == 0 ? right : left;
  if (a.fault == 1 && r == 0 && dir == 0 && i == 0) to = (right + 1) % n;
  p->job.dst = t.out[to] + at;
  p->job.last = i == (dir == 0 ? n / 2 : ccw_hops) - 1;
  p->sig[0] = flag(t, to, ready_array(dir, i), blk.b);
  p->sig_v = tag(blk.epoch, s + 1);
  if (i >= 1) {  // arrived at hop i - 1 of this direction
    p->job.b = t.out[r] + at;
    p->job.b_in = 0;
    p->wait[0] = flag(t, r, ready_array(dir, i - 1), blk.b);
    p->want[0] = tag(blk.epoch, s + 1);
    return;
  }
  p->job.b = t.x[r] + blk.lo + off;  // read once for all three places
  p->job.b_in = 1;
  p->job.dst2 = t.out[r] + at;
  if (ccw_hops >= 1) {
    p->job.dst3 = t.out[left] + at;
    p->job.last3 = ccw_hops == 1;
    p->sig[1] = flag(t, left, ready_array(1, 0), blk.b);
  }
}

__device__ __forceinline__ char* slot_ptr(const Table& t, const Args& a,
                                          int rank, int b, int hop,
                                          long long s) {
  const long long k = ((long long)b * (a.n - 1) + hop) * a.slots +
                      s % a.slots;
  return t.slots[rank] + (k << a.slice_log2);
}

// K8b, hop i (0 .. n - 1; hop n - 1 writes the output) of slice s.
__device__ void reduce_hop(const Table& t, const Args& a, const Block& blk,
                           int i, long long s, Plan* p) {
  const int n = a.n, r = blk.rank;
  const int left = (r + n - 1) % n, right = (r + 1) % n;
  const long long off = s << a.slice_log2;
  const int c = (r - i + n) % n;  // the chunk this hop adds to
  p->job.len = (int)min((long long)1 << a.slice_log2, blk.nb - off);
  p->job.b = t.x[r] + (long long)c * a.chunk + blk.lo + off;
  p->job.b_in = 1;
  p->job.dst2 = nullptr;
  // the partial sum of chunk c that arrived at hop i - 1, and its ack
  p->job.a = i >= 1 ? slot_ptr(t, a, r, blk.b, i - 1, s) : nullptr;
  if (i >= 1) {
    p->wait[0] = flag(t, r, ready_array(0, i - 1), blk.b);
    p->want[0] = tag(blk.epoch, s + 1);
    p->sig[1] = flag(t, left, kFreed + i - 1, blk.b);
  }
  p->sig_v = tag(blk.epoch, s + 1);
  if (i == n - 1) {
    p->job.dst = t.out[r] + blk.lo + off;
    p->job.last = 1;
    return;
  }
  const int to = (a.fault == 1 && r == 0 && i == 0) ? (right + 1) % n : right;
  p->job.dst = slot_ptr(t, a, to, blk.b, i, s);
  p->job.last = 0;
  p->sig[0] = flag(t, to, ready_array(0, i), blk.b);
  if (s >= a.slots) {  // slot s % D of ``to`` held slice s - D
    p->wait[1] = flag(t, r, kFreed + i, blk.b);
    p->want[1] = tag(blk.epoch, s - a.slots + 1);
  }
}

// Lane ``lane`` of warp 0 plans its hop of step ``st`` and waits for what
// the hop reads; false (in every lane) when the launch is to stop.
template <int kKind, int S>
__device__ bool plan_and_wait(const Table& t, const Args& a, const Block& blk,
                              int lanes, long long slices, long long st,
                              int lane, unsigned long long* seen, Plan* p) {
  p->on = false;
  p->job.dst2 = p->job.dst3 = p->job.peer = nullptr;
  p->job.last3 = 0;
  p->wait[0] = p->wait[1] = nullptr;
  p->sig[0] = p->sig[1] = nullptr;
  p->sig_v = 0;
  int dir = 0, hop = lane;  // the lane's hop in its direction
  if (kKind == kBidir && lane >= a.n / 2) {
    dir = 1;
    hop = lane - a.n / 2 + 1;
  }
  const long long s = st - (long long)a.lag * hop;
  if (lane < lanes && s >= 0 && s < slices) {
    p->on = true;
    if constexpr (kKind == kReduceScatter) reduce_hop(t, a, blk, hop, s, p);
    else if constexpr (kKind == kBidir) bidir_hop(t, a, blk, dir, hop, s, p);
    else gather_hop(t, a, blk, hop, s, p);
  }
  bool ok = true;
  for (int w = 0; w < 2; ++w)
    if (p->wait[w] &&
        !thread_wait<S>(p->wait[w], p->want[w], &seen[w], a,
                        err_code(kKind, blk.rank, hop,
                                 w == 0 ? kWaitReady : kWaitFreed)))
      ok = false;
  return __all_sync(0xffffffffu, ok);
}

// K8a (T unused), K8b and K8c (T unused): ``lanes`` hops a step, a hop i
// hops from its slice's start on slice st - lag i.  Lane j of warp 0 plans
// its hop of the step and waits for what it reads; the whole block
// copies; then warp 0 releases every hop's counter.
template <typename T, int kKind, int S>
__device__ void ring_steps(const Table& t, const Args& a, int rank0) {
  constexpr bool kAdds = kKind == kReduceScatter;
  __shared__ Job jobs[kMaxRanks];
  __shared__ unsigned long long* sig[2][kMaxRanks];
  __shared__ unsigned long long sig_v[kMaxRanks];
  __shared__ int njobs, stop;
  Block blk;
  if (!block_setup<S>(t, a, rank0, &blk)) return;
  const int lanes = kAdds ? a.n : kKind == kBidir ? bidir_lanes(a.n) : a.n - 1;
  // hops of the longest chain a slice makes: K8c's clockwise one
  const int chain = kKind == kBidir ? a.n / 2 : lanes;
  const long long slices =
      (blk.nb + (1ll << a.slice_log2) - 1) >> a.slice_log2;
  const long long steps = slices + (long long)a.lag * (chain - 1);
  const int lane = threadIdx.x;  // in warp 0: lane j plans a hop
  unsigned long long seen[2] = {0, 0};
  for (long long st = 0; st < steps; ++st) {
    if (lane < 32) {
      Plan p;
      const bool ok = plan_and_wait<kKind, S>(t, a, blk, lanes, slices, st,
                                              lane, seen, &p);
      const unsigned on = __ballot_sync(0xffffffffu, p.on);
      if (p.on) jobs[__popc(on & ((1u << lane) - 1))] = p.job;
      if (lane < kMaxRanks) {
        sig[0][lane] = p.sig[0];
        sig[1][lane] = p.sig[1];
        sig_v[lane] = p.sig_v;
      }
      if (lane == 0) {
        njobs = __popc(on);
        stop = ok ? 0 : 1;
      }
    }
    __syncthreads();
    if (stop) return;
    run_jobs<T, kAdds, false, kThreads, kKind == kBidir>(
        jobs, njobs, a.slice_log2, a.vec != 0);
    __syncthreads();
    if (lane < kMaxRanks) {  // the step's writes are done: a release store
      // of each hop's counter orders them before it
      if (sig[0][lane]) st_release<S>(sig[0][lane], sig_v[lane]);
      if (sig[1][lane]) st_release<S>(sig[1][lane], sig_v[lane]);
    }
  }
  if (lane == 0) *flag(t, blk.rank, kEpoch, blk.b) = blk.epoch;
}

template <int S>
__global__ void __launch_bounds__(kThreads, 2)
ring_all_gather_kernel(Table t, Args a, int rank0) {
  ring_steps<float, kAllGather, S>(t, a, rank0);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads, 2)
ring_reduce_scatter_kernel(Table t, Args a, int rank0) {
  ring_steps<T, kReduceScatter, S>(t, a, rank0);
}

template <int S>
__global__ void __launch_bounds__(kThreads, 2)
ring_bidir_all_gather_kernel(Table t, Args a, int rank0) {
  ring_steps<float, kBidir, S>(t, a, rank0);
}

// ------------------------------------------- K8b on one card: a cluster
// Block b of every rank forms one thread-block cluster (cluster dims (1,
// n, 1)), so a partial sum goes from the sender's registers straight into
// a slot in the receiver's shared memory and never through L2.  Per
// (rank, block) there are ``slots`` slots of one slice per hop in shared
// memory; mbarrier full[hop][slot] (in the receiver) completes when the
// sender has written a slice there, empty[hop][slot] (in the sender) when
// the receiver has read it.  The step schedule, the plans and the adds
// are K8b's; only where the slots live and how they are signalled differ.
constexpr int kMaxSlots = 4;

// p in this block's shared memory -> the same place in cluster peer
// ``rank``'s, as a generic address.
__device__ __forceinline__ char* cluster_map(const void* p, int rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<char*>(out);
}

// One arrival (with release at cluster scope) on the barrier at the same
// place as ``bar`` in cluster peer ``rank``.
__device__ __forceinline__ void cluster_arrive(unsigned long long* bar,
                                               int rank) {
  const unsigned local = (unsigned)__cvta_generic_to_shared(bar);
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               :: "r"(remote) : "memory");
}

__device__ __forceinline__ bool bar_test(const unsigned long long* bar,
                                         unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"((unsigned)__cvta_generic_to_shared(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// One thread waits for the phase of parity ``parity`` of a barrier in this
// block's shared memory, bounded as thread_wait is.
__device__ bool bar_wait(const unsigned long long* bar, unsigned parity,
                         const Args& a, unsigned int code) {
  if (bar_test(bar, parity)) return true;
  const unsigned long long t0 = global_ns();
  for (unsigned polls = 1; !bar_test(bar, parity); ++polls) {
    if ((polls & (kPollsPerCheck - 1)) == 0) {  // now and then: give up?
      if (ld_volatile(a.err) != 0) return false;
      if (global_ns() - t0 > (unsigned long long)a.timeout_ns) {
        atomicCAS_system(a.err, 0u, code);
        return false;
      }
    }
  }
  return true;
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"((unsigned)__cvta_generic_to_shared(bar)) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

struct ClusterSlots {
  char* slots;  // arrivals x ``slots`` x S bytes of dynamic smem
  unsigned long long (*full)[kMaxSlots];
  unsigned long long (*empty)[kMaxSlots];

  __device__ char* at(const Args& a, int arrival, int d) const {
    return slots + (((long long)arrival * a.slots + d) << a.slice_log2);
  }
};

// The hop's slot handshakes on the cluster route: it reads slot d of
// ``in_hop`` (>= 0) in this block, then frees it in the left; it writes
// slot d of ``out_hop`` (>= 0) in ``to`` once ``to`` has freed it (use -
// 1), then tells ``to``.
__device__ void cluster_handshakes(const ClusterSlots& cs, int in_hop,
                                   int out_hop, int d, unsigned use, int left,
                                   int to, Plan* p) {
  if (in_hop >= 0) {
    p->wait[0] = &cs.full[in_hop][d];
    p->want[0] = use & 1;
    p->sig[1] = &cs.empty[in_hop][d];  // in the left
    p->sig_rank[1] = left;
  }
  if (out_hop >= 0) {
    p->sig[0] = &cs.full[out_hop][d];  // in ``to``
    p->sig_rank[0] = to;
    if (use >= 1) {
      p->wait[1] = &cs.empty[out_hop][d];
      p->want[1] = (use - 1) & 1;
    }
  }
}

// K8b, hop i (0 .. n - 1) of slice s on the cluster route.
__device__ void reduce_hop_cluster(const Table& t, const Args& a,
                                   const Block& blk, const ClusterSlots& cs,
                                   int i, long long s, Plan* p) {
  const int n = a.n, r = blk.rank;
  const int left = (r + n - 1) % n, right = (r + 1) % n;
  const long long off = s << a.slice_log2;
  const int c = (r - i + n) % n;  // the chunk this hop adds to
  const int d = (int)(s % a.slots);
  const unsigned use = (unsigned)(s / a.slots);  // of slot d
  const int to = (a.fault == 1 && r == 0 && i == 0) ? (right + 1) % n : right;
  p->job.len = (int)min((long long)1 << a.slice_log2, blk.nb - off);
  p->job.b = t.x[r] + (long long)c * a.chunk + blk.lo + off;
  p->job.b_in = 1;
  p->job.dst2 = nullptr;
  // the partial of chunk c that arrived at hop i - 1
  p->job.a = i >= 1 ? cs.at(a, i - 1, d) : nullptr;
  const bool last = i == n - 1;
  p->job.dst = last ? t.out[r] + blk.lo + off : nullptr;
  p->job.last = last;
  p->job.peer = last ? nullptr : cluster_map(cs.at(a, i, d), to);
  cluster_handshakes(cs, i - 1, last ? -1 : i, d, use, left, to, p);
}

// K8b on one card, with block b of every rank one thread-block cluster:
// the steps of ring_steps, but a partial sum passes from the sender's
// registers into a slot in the receiver's shared memory, and the counters
// are mbarriers there.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 3)
ring_reduce_scatter_cluster_kernel(Table t, Args a, int rank0) {
  extern __shared__ __align__(128) char cluster_slots[];
  __shared__ unsigned long long full[kMaxRanks][kMaxSlots];
  __shared__ unsigned long long empty[kMaxRanks][kMaxSlots];
  __shared__ Job jobs[kMaxRanks];
  __shared__ unsigned long long* sig[2][kMaxRanks];
  __shared__ int sig_rank[2][kMaxRanks];
  __shared__ int stop;
  const ClusterSlots cs{cluster_slots, full, empty};
  const int n = a.n, lane = threadIdx.x;
  if (lane < 32) {
    for (int k = lane; k < (n - 1) * a.slots; k += 32) {
      bar_init(&full[k / a.slots][k % a.slots]);
      bar_init(&empty[k / a.slots][k % a.slots]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // every peer's barriers exist before any arrives
  Block blk;
  blk.rank = rank0 + blockIdx.y;
  blk.b = blockIdx.x;
  blk.lo = (long long)blockIdx.x * a.per_block;
  blk.nb = min(a.per_block, a.chunk - blk.lo);
  blk.epoch = 0;
  const long long slices =
      (blk.nb + (1ll << a.slice_log2) - 1) >> a.slice_log2;
  const long long steps = slices + (long long)a.lag * (n - 1);
  for (long long st = 0; st < steps; ++st) {
    if (lane < 32) {
      Plan p;
      p.on = false;
      p.job.len = 0;
      p.job.a = nullptr;
      p.job.dst = p.job.dst2 = p.job.dst3 = p.job.peer = nullptr;
      p.wait[0] = p.wait[1] = nullptr;
      p.sig[0] = p.sig[1] = nullptr;
      const long long s = st - (long long)a.lag * lane;
      if (lane < n && s >= 0 && s < slices) {
        p.on = true;
        reduce_hop_cluster(t, a, blk, cs, lane, s, &p);
      }
      bool ok = true;
      for (int w = 0; w < 2; ++w)
        if (p.wait[w] &&
            !bar_wait(p.wait[w], (unsigned)p.want[w], a,
                      err_code(kReduceScatter, blk.rank, lane,
                               w == 0 ? kWaitReady : kWaitFreed)))
          ok = false;
      ok = __all_sync(0xffffffffu, ok);
      if (lane < kMaxRanks) {
        jobs[lane] = p.job;  // by hop; len 0 where it does not run
        sig[0][lane] = p.sig[0];
        sig[1][lane] = p.sig[1];
        sig_rank[0][lane] = p.sig_rank[0];
        sig_rank[1][lane] = p.sig_rank[1];
      }
      if (lane == 0) stop = ok ? 0 : 1;
    }
    __syncthreads();
    if (stop) break;
    run_jobs<T, true, true, kClusterThreads>(jobs, n, a.slice_log2,
                                             a.vec != 0);
    __syncthreads();
    if (lane < kMaxRanks) {  // release the step's writes and reads
      asm volatile("fence.acq_rel.cluster;" ::: "memory");
      if (sig[0][lane]) cluster_arrive(sig[0][lane], sig_rank[0][lane]);
      if (sig[1][lane]) cluster_arrive(sig[1][lane], sig_rank[1][lane]);
    }
  }
  cluster_sync();  // no peer still writes to or arrives on this block
}

// ----------------------------------------- K8d, and K8a-c over one rank
// A rank's chunk is cut into tiles of kCopyTile bytes, copied through
// kCopyStages slots of shared memory by Hopper's bulk-copy engine: thread 0
// of each block starts every copy, global to shared (cp.async.bulk,
// counted off one mbarrier a slot) and back (one bulk group a tile), and
// refills the slot the previous store read while the next store goes out,
// so no register or instruction of the SM touches the bytes.  The first
// kCopyStages tiles of block b are b, b + G, ... (G blocks a rank); every
// later tile comes from the rank's ticket counter, so a block that runs
// ahead takes more tiles and all blocks end together, as the blocks of a
// one-shot grid do.  Each block takes tickets until one is past the end;
// the block that draws the launch's last ticket (the G-th past the end)
// sets the counter back to 0 for the next launch.  Where a base or the
// count is not a 16-byte multiple, or (the plain copy only) the chunk is
// one tile or less, every thread copies words over the block's byte range
// (copy_bytes): one round trip of plain loads beats the mbarriers' set-up
// there, but K8d's bulk loads overlap its barrier, so K8d keeps them.
// What bounds it: bytes, each read once and written once.
constexpr int kCopyStages = 4;
constexpr int kCopyTile = 10 * 1024;  // bytes a slot: 40 KiB a block

// One bulk store of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from shared memory to global memory, as its own bulk group.
__device__ __forceinline__ void bulk_store(char* dst, const char* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n"
      :: "l"(dst), "r"(hopper::smem_u32(src)), "r"(bytes) : "memory");
}

// Until at most N of this thread's bulk stores still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Until every bulk store of this thread is written, ordered before its
// later generic accesses (the release of a ready flag).
__device__ __forceinline__ void bulk_wait_written() {
  asm volatile("cp.async.bulk.wait_group 0;\n"
               "fence.proxy.async.global;\n" ::: "memory");
}

// dst[0:nb) = src[0:nb) by G = gridDim.x blocks, tile by tile; thread 0 of
// each block runs it: start(), then finish() (or drain() when the copy is
// called off after start).
struct CopyRing {
  char* dst;
  const char* src;
  long long nb;
  unsigned long long* ticket;  // the rank's counter
  char* slot;                  // kCopyStages x kCopyTile bytes, shared
  uint64_t* full;              // one mbarrier a slot: its tile has landed
  long long tile[kCopyStages];  // the tile in each slot (>= tiles: none)
  long long next;               // the next ticket's tile, once it is drawn

  __device__ long long tiles() const {
    return (nb + kCopyTile - 1) / kCopyTile;
  }
  __device__ int bytes(long long k) const {
    return (int)min((long long)kCopyTile, nb - k * kCopyTile);
  }
  // A ticket's tile: those after the first kCopyStages x G.  The last
  // ticket a launch draws resets the counter (no block draws after it).
  __device__ long long draw() const {
    const long long g = gridDim.x, dynamic =
        max(0ll, tiles() - (long long)kCopyStages * g);
    const long long t = (long long)atomicAdd(ticket, 1ull);
    if (t == dynamic + g - 1) *ticket = 0;
    return (long long)kCopyStages * g + t;
  }
  __device__ void load(int s, long long k) const {
    hopper::mbar_arrive_expect_tx(&full[s], bytes(k));
    hopper::bulk_load(slot + s * kCopyTile, src + k * kCopyTile, bytes(k),
                      &full[s]);
  }
  // The first loads and the first ticket; they read the source only.
  __device__ void start() {
    for (int s = 0; s < kCopyStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
    for (int s = 0; s < kCopyStages; ++s) {
      tile[s] = blockIdx.x + (long long)s * gridDim.x;
      if (tile[s] < tiles()) load(s, tile[s]);
    }
    next = draw();
  }
  // Every store: slot j % kCopyStages holds the block's j-th tile; the
  // slot store j - 1 read takes the next ticket's tile.  ``written``: wait
  // until every byte is written (else until the stores have read shared
  // memory, so the block may end).
  __device__ void finish(bool written) {
    const long long nt = tiles();
    for (int j = 0;; ++j) {
      const int s = j % kCopyStages;
      if (tile[s] >= nt) break;  // no tile here, so none after it either
      hopper::mbar_wait(&full[s], (j / kCopyStages) & 1);
      bulk_store(dst + tile[s] * kCopyTile, slot + s * kCopyTile,
                 bytes(tile[s]));
      if (j >= 1) {
        const int ps = (j - 1) % kCopyStages;
        tile[ps] = next;
        if (next < nt) {
          bulk_wait_read<1>();
          load(ps, next);
          next = draw();
        }
      }
    }
    while (next < nt) next = draw();  // a block always draws past the end
    if (written) bulk_wait_written();
    else bulk_wait_read<0>();
  }
  // The loads start() began land before the block lets its shared
  // memory go (the ticket counter is zeroed with the flags after a fault).
  __device__ void drain() const {
    for (int s = 0; s < kCopyStages; ++s)
      if (tile[s] < tiles()) hopper::mbar_wait(&full[s], 0);
  }
};

// K8a-c over one rank: the rank's own copy.
template <int S>
__global__ void __launch_bounds__(kThreads)
ring_copy_kernel(Table t, Args a, int rank0) {
  __shared__ __align__(128) char slot[kCopyStages * kCopyTile];
  __shared__ uint64_t full[kCopyStages];
  const int r = rank0 + blockIdx.y;
  if (a.vec == 0 || a.chunk <= kCopyTile) {
    Block blk;
    if (block_range(a, rank0, &blk))
      copy_bytes(t.out[r] + blk.lo, t.x[r] + blk.lo, blk.nb);
  } else if (threadIdx.x == 0) {
    CopyRing cr{t.out[r], t.x[r], a.chunk, flag(t, r, kTicket, 0), slot,
                full};
    cr.start();
    cr.finish(false);
  }
}

// K8d: the neighbour barrier (block b signals block b of both neighbours
// and waits for both), the copy to the rank's own output, then what the
// reference's rdma.wait() waits for: a release of the rank's ready flag,
// and the wait for it.  The first bulk loads read only the rank's own
// input, so they go out before the barrier and overlap its round trips;
// no byte is stored before the barrier.
template <int S>
__global__ void __launch_bounds__(kThreads)
ring_loopback_kernel(Table t, Args a, int rank0) {
  __shared__ __align__(128) char slot[kCopyStages * kCopyTile];
  __shared__ uint64_t full[kCopyStages];
  __shared__ int ok;
  Block blk;
  const bool in_range = block_range(a, rank0, &blk);
  const bool bulk = a.vec != 0;
  if (!bulk && !in_range) return;  // every block takes part in a bulk copy
  const int n = a.n, r = blk.rank;
  const int left = (r + n - 1) % n, right = (r + 1) % n;
  if (bulk && threadIdx.x != 0) return;  // thread 0 starts every copy
  CopyRing cr{t.out[r], t.x[r], a.chunk, flag(t, r, kTicket, 0), slot, full};
  unsigned long long epoch = 0, loops = 0, seen = 0;
  if (threadIdx.x == 0) {
    if (bulk) cr.start();
    if constexpr (S == kSys) {
      atomicAdd_system(flag(t, left, kBarrier, blk.b), 1ull);
      atomicAdd_system(flag(t, right, kBarrier, blk.b), 1ull);
    } else {
      atomicAdd(flag(t, left, kBarrier, blk.b), 1ull);
      atomicAdd(flag(t, right, kBarrier, blk.b), 1ull);
    }
    // this block's own words, written only by it in earlier launches
    epoch = ld_relaxed(flag(t, r, kEpoch, blk.b)) + 1;
    loops = ld_relaxed(flag(t, r, kLoops, blk.b)) + 1;
    ok = thread_wait<S>(flag(t, r, kBarrier, blk.b), 2 * loops, &seen, a,
                        err_code(kLoopback, r, 0, kWaitBarrier));
  }
  if (!bulk) {
    __syncthreads();
    if (!ok) return;
    copy_bytes(t.out[r] + blk.lo, t.x[r] + blk.lo, blk.nb);
    __syncthreads();
    if (threadIdx.x != 0) return;
    fence<S>();
  } else if (!ok) {
    cr.drain();
    return;
  } else {
    cr.finish(true);
  }
  unsigned long long* ready = flag(t, r, ready_array(0, 0), blk.b);
  st_release<S>(ready, tag(epoch, 1));
  seen = 0;
  if (!thread_wait<S>(ready, tag(epoch, 1), &seen, a,
                      err_code(kLoopback, r, 0, kWaitReady)))
    return;
  *flag(t, r, kLoops, blk.b) = loops;
  *flag(t, r, kEpoch, blk.b) = epoch;
}

typedef void (*RingKernel)(Table, Args, int);

template <int S>
RingKernel pick_scoped(int kind, int dtype) {
  switch (kind) {
    case kAllGather: return ring_all_gather_kernel<S>;
    case kBidir: return ring_bidir_all_gather_kernel<S>;
    case kLoopback: return ring_loopback_kernel<S>;
    case kCopy: return ring_copy_kernel<S>;
    case kReduceScatter:
      if (dtype == 0) return ring_reduce_scatter_kernel<float, S>;
      if (dtype == 1) return ring_reduce_scatter_kernel<__nv_bfloat16, S>;
      if (dtype == 2) return ring_reduce_scatter_kernel<__half, S>;
      return nullptr;
    default: return nullptr;
  }
}

RingKernel pick(int kind, int dtype, int scope) {
  if (kind == kReduceScatterCluster) {
    if (scope != kGpu) return nullptr;  // one card only
    if (dtype == 0) return ring_reduce_scatter_cluster_kernel<float>;
    if (dtype == 1) return ring_reduce_scatter_cluster_kernel<__nv_bfloat16>;
    if (dtype == 2) return ring_reduce_scatter_cluster_kernel<__half>;
    return nullptr;
  }
  if (scope == kGpu) return pick_scoped<kGpu>(kind, dtype);
  if (scope == kSys) return pick_scoped<kSys>(kind, dtype);
  return nullptr;
}

// The cluster K8b's dynamic shared memory: its slots.
long long cluster_smem(int n, int slots, int slice_log2) {
  return (long long)(n - 1) * slots << slice_log2;
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

// Blocks of the ``kind`` kernel at ``scope`` (0 GPU, 1 system) that can be
// resident on ``device`` at once (a negative cudaError_t on failure).
int ring_capacity(int kind, int dtype, int scope, int device) {
  RingKernel k = pick(kind, dtype, scope);
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

// Clusters of the cluster K8b (n blocks of ``smem`` dynamic bytes each)
// that can be resident on ``device`` at once (0 if none fits; a negative
// cudaError_t on failure).
int ring_cluster_capacity(int dtype, int n, int smem, int device) {
  RingKernel k = pick(kReduceScatterCluster, dtype, kGpu);
  if (k == nullptr || n < 2 || n > 8) return -(int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.status != cudaSuccess) return -(int)on.status;
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(k),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(1, n, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters,
                                     reinterpret_cast<const void*>(k), &cfg);
  if (e != cudaSuccess) return -(int)e;
  return clusters;
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
// ranks on other cards).  K8a / K8b walk slices of 2^slice_log2 bytes,
// ``lag`` steps a hop, through ``slots`` slots a hop (K8b); ``vec``: every
// base and the chunk are 16-byte multiples.  Returns cudaGetLastError().
int ring_launch(int kind, int dtype, int scope, int n, int rank0,
                int ranks_here, int device, const long long* xs,
                const long long* outs, const long long* slots,
                const long long* flags, long long chunk, long long per_block,
                int blocks, int slice_log2, int lag, int nslots, int vec,
                int shift, int fault, long long timeout_ns, void* err,
                void* stream) {
  RingKernel k = pick(kind, dtype, scope);
  const bool sliced = kind == kAllGather || kind == kReduceScatter ||
                      kind == kBidir || kind == kReduceScatterCluster;
  const bool adds = kind == kReduceScatter || kind == kReduceScatterCluster;
  if (k == nullptr || n < 1 || n > kMaxRanks || blocks < 1 ||
      blocks > kMaxBlocks ||
      (sliced && (slice_log2 < 4 || slice_log2 > 30 || lag < 1 ||
                  (adds && n > 1 && nslots <= lag))))
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
  a.vec = vec;
  a.lag = lag;
  a.slots = nslots;
  a.slice_log2 = slice_log2;
  a.chunk = chunk;
  a.per_block = per_block;
  a.timeout_ns = timeout_ns;
  a.err = reinterpret_cast<unsigned int*>(err);
  if (kind == kReduceScatterCluster) {  // block b of every rank: a cluster
    if (ranks_here != n || n < 2 || n > 8 || nslots > kMaxSlots)
      return (int)cudaErrorInvalidValue;
    const long long smem = cluster_smem(n, nslots, slice_log2);
    cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(k),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = n;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks, n, 1);
    cfg.blockDim = dim3(kClusterThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = reinterpret_cast<cudaStream_t>(stream);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, k, t, a, rank0);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  k<<<dim3(blocks, ranks_here), kThreads, 0,
      reinterpret_cast<cudaStream_t>(stream)>>>(t, a, rank0);
  return (int)cudaGetLastError();
}

// Words of one rank's flag block, and the largest block count per rank.
int ring_flag_words() { return kFlagStride * kMaxBlocks; }
int ring_max_blocks() { return kMaxBlocks; }

}  // extern "C"
