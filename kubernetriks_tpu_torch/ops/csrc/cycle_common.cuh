// Device code shared by the three scheduling-cycle kernels
// (select_cycle_commit.cu, select_schedule_cycle.cu, schedule_cycle.cu):
// the queue key order, the bit-exact LeastAllocatedResources score, and the
// passes every cycle is made of — the queue pick and the decision pass
// (fit + score on every node, last-max-wins argmax). One definition, so
// the kernels cannot drift apart, as the reference's `_argmin_select`
// (ops/scheduler_kernel.py:986) and `_fit_score_place` (:118) are shared
// by its Pallas kernels.
//
// Two generations live here. The block passes over shared memory
// (block_select, block_fit_argmax: one block of kThreads threads per
// cluster, the cluster's rows in shared memory, every thread ending with
// the result read from per-warp slots; the caller must __syncthreads()
// before the next pass reuses them) serve select_schedule_cycle.cu. The
// register-resident decision pass (NodeRegs) and the queue ordered once by
// a block sort (order_hi/order_lo, block_bitonic_sort) serve the
// candidate cycle and the megakernel.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace ktt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPhaseUnschedulable = 2;
constexpr int kPhaseRunning = 3;
constexpr int32_t kBig = 0x7fffffff;

// A queue entry's order: (queue win, queue offset as int32 bits, queue
// seq, slot). Non-negative float32 offsets order like their bit patterns.
struct Key {
  int32_t win, off, seq, slot;
};

__device__ __forceinline__ bool key_less(const Key& a, const Key& b) {
  if (a.win != b.win) return a.win < b.win;
  if (a.off != b.off) return a.off < b.off;
  if (a.seq != b.seq) return a.seq < b.seq;
  return a.slot < b.slot;
}

__device__ __forceinline__ Key shfl_key(const Key& k, int delta) {
  Key o;
  o.win = __shfl_down_sync(0xffffffffu, k.win, delta);
  o.off = __shfl_down_sync(0xffffffffu, k.off, delta);
  o.seq = __shfl_down_sync(0xffffffffu, k.seq, delta);
  o.slot = __shfl_down_sync(0xffffffffu, k.slot, delta);
  return o;
}

// (score, node) pairs: the greater score wins, equal scores go to the
// higher node slot — the reference's last-max-wins argmax.
__device__ __forceinline__ bool node_better(float s, int n, float bs, int bn) {
  return s > bs || (s == bs && n > bn);
}

// Score of pipeline.py `_score_least_allocated`, op for op: IEEE
// subtract, multiply and divide with no contraction (nvcc --fmad=false).
__device__ __forceinline__ float least_allocated(int32_t cpu, int32_t ram,
                                                 int32_t rc, int32_t rr) {
  const float cpu_f = (float)cpu, ram_f = (float)ram;
  const float cs = cpu > 0 ? __fdiv_rn(__fmul_rn(__fsub_rn(cpu_f, (float)rc), 100.0f), cpu_f)
                           : -INFINITY;
  const float rs = ram > 0 ? __fdiv_rn(__fmul_rn(__fsub_rn(ram_f, (float)rr), 100.0f), ram_f)
                           : -INFINITY;
  return __fmul_rn(__fadd_rn(cs, rs), 0.5f);
}

// Shared-memory slots of the per-warp partial results.
struct Scratch {
  Key key[kWarps];
  float score[kWarps];
  int node[kWarps];
  int fit[kWarps];
  int count;
};

// Block-wide sum of one int per thread (every thread gets the total).
__device__ __forceinline__ int block_sum(int v, Scratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  if (lane == 0) s.node[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += s.node[w];
  __syncthreads();
  return total;
}

// The queue pick: the slot of the remaining eligible pod with the least
// Key, or -1 when none remains.
__device__ __forceinline__ int block_select(const int32_t* s_win, const int32_t* s_off,
                                            const int32_t* s_seq, const uint8_t* s_rem,
                                            int P, Scratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Key best = {kBig, kBig, kBig, kBig};
  for (int p = threadIdx.x; p < P; p += kThreads) {
    if (!s_rem[p]) continue;
    const Key cand = {s_win[p], s_off[p], s_seq[p], p};
    if (key_less(cand, best)) best = cand;
  }
  for (int d = 16; d > 0; d >>= 1) {
    const Key o = shfl_key(best, d);
    if (key_less(o, best)) best = o;
  }
  if (lane == 0) s.key[warp] = best;
  __syncthreads();
  Key b = s.key[0];
  for (int w = 1; w < kWarps; ++w)
    if (key_less(s.key[w], b)) b = s.key[w];
  return b.slot == kBig ? -1 : b.slot;
}

struct Decision {
  int best;    // last node of maximal score (N - 1 when nothing fits)
  int anyfit;  // 1 when some alive node fits the request
};

// The decision pass for one request (rc, rr) over the cluster's nodes.
__device__ __forceinline__ Decision block_fit_argmax(const int32_t* s_cpu, const int32_t* s_ram,
                                                     const uint8_t* s_alive, int N,
                                                     int32_t rc, int32_t rr, Scratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float bscore = -INFINITY;
  int bnode = -1, anyfit = 0;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const int32_t cpu = s_cpu[n], ram = s_ram[n];
    const bool fit = s_alive[n] && rc <= cpu && rr <= ram;
    const float score = fit ? least_allocated(cpu, ram, rc, rr) : -INFINITY;
    anyfit |= fit ? 1 : 0;
    if (node_better(score, n, bscore, bnode)) {
      bscore = score;
      bnode = n;
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, bscore, d);
    const int on = __shfl_down_sync(0xffffffffu, bnode, d);
    anyfit |= __shfl_down_sync(0xffffffffu, anyfit, d);
    if (node_better(os, on, bscore, bnode)) {
      bscore = os;
      bnode = on;
    }
  }
  if (lane == 0) {
    s.score[warp] = bscore;
    s.node[warp] = bnode;
    s.fit[warp] = anyfit;
  }
  __syncthreads();
  float bs = s.score[0];
  Decision out = {s.node[0], s.fit[0]};
  for (int w = 1; w < kWarps; ++w) {
    out.anyfit |= s.fit[w];
    if (node_better(s.score[w], s.node[w], bs, out.best)) {
      bs = s.score[w];
      out.best = s.node[w];
    }
  }
  return out;
}

// --- The register-resident decision pass ------------------------------------
// (schedule_cycle.cu and select_cycle_commit.cu.) A block of T threads
// (cycle_threads) holds the cluster's node rows in registers: thread t owns
// slots t, t + T, ... (SLOTS of them, cycle_slots). One candidate is a fit +
// score over the owned slots, a warp max by `redux.sync` on an orderable
// score key and then on the node, one barrier (`__syncthreads_or`, which
// also yields any-fit), and the same two-step max over the per-warp
// partials, done by every warp at once so that no second barrier is
// needed. The owner of the chosen node deducts in its registers.

constexpr int kMaxCycleThreads = 1024;
constexpr int kMaxCycleSlots = 32;

// Threads per block: two node slots per thread, 128 to 1 024 threads.
inline int cycle_threads(int N) {
  const int t = ((N + 1) / 2 + 31) / 32 * 32;
  return t < 128 ? 128 : (t > kMaxCycleThreads ? kMaxCycleThreads : t);
}

// Node slots per thread (a power of two), or 0 when N exceeds
// kMaxCycleThreads * kMaxCycleSlots.
inline int cycle_slots(int N, int T) {
  const int need = (N + T - 1) / T;
  int s = 1;
  while (s < need) s <<= 1;
  return s <= kMaxCycleSlots ? s : 0;
}

// Key of a score whose unsigned order is the float order (scores are
// finite or -inf; -0.0 is taken as +0.0, which it equals).
__device__ __forceinline__ uint32_t score_key(float s) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The per-warp partial results of one candidate, double-buffered so that
// a warp may write candidate k + 1's while another still reads k's.
struct Partials {
  uint32_t key[2][32];
  uint32_t node[2][32];  // node + 1; 0 = no node
};

template <int SLOTS>
struct NodeRegs {
  int32_t cpu[SLOTS], ram[SLOTS];
  bool alive[SLOTS];

  __device__ __forceinline__ void load(const uint8_t* a, const int32_t* c, const int32_t* r, int N) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int n = threadIdx.x + j * blockDim.x;
      const bool in = n < N;
      cpu[j] = in ? c[n] : 0;
      ram[j] = in ? r[n] : 0;
      alive[j] = in && a[n];
    }
  }

  __device__ __forceinline__ void store(int32_t* c, int32_t* r, int N) const {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int n = threadIdx.x + j * blockDim.x;
      if (n < N) {
        c[n] = cpu[j];
        r[n] = ram[j];
      }
    }
  }

  // The decision for request (rc, rr): every thread of the block calls it
  // (it holds one barrier) and gets the same result. `buf` alternates
  // between consecutive calls.
  __device__ __forceinline__ Decision fit_argmax(int N, int32_t rc, int32_t rr, Partials& part,
                                                 int buf) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t bkey = 0, bnode = 0;
    int fit_any = 0;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int n = threadIdx.x + j * blockDim.x;
      if (n < N) {
        const bool fit = alive[j] && rc <= cpu[j] && rr <= ram[j];
        const uint32_t key = score_key(fit ? least_allocated(cpu[j], ram[j], rc, rr) : -INFINITY);
        fit_any |= fit ? 1 : 0;
        if (key >= bkey) {  // slots ascend: the last of equal scores wins
          bkey = key;
          bnode = n + 1;
        }
      }
    }
    const uint32_t wkey = __reduce_max_sync(0xffffffffu, bkey);
    const uint32_t wnode = __reduce_max_sync(0xffffffffu, bkey == wkey ? bnode : 0u);
    if (lane == 0) {
      part.key[buf][warp] = wkey;
      part.node[buf][warp] = wnode;
    }
    const int anyfit = __syncthreads_or(fit_any);
    const bool has = lane < (int)(blockDim.x >> 5);
    const uint32_t pk = has ? part.key[buf][lane] : 0u;
    const uint32_t pn = has ? part.node[buf][lane] : 0u;
    const uint32_t key = __reduce_max_sync(0xffffffffu, pk);
    const uint32_t node = __reduce_max_sync(0xffffffffu, pk == key ? pn : 0u);
    return {(int)node - 1, anyfit ? 1 : 0};
  }

  // The owner of node `best` takes the request off its allocatable.
  __device__ __forceinline__ void deduct(int best, int32_t rc, int32_t rr) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if ((int)threadIdx.x + j * (int)blockDim.x == best) {
        cpu[j] -= rc;
        ram[j] -= rr;
      }
    }
  }
};

// --- The queue order as sortable words (select_cycle_commit.cu) -------------
// A queue entry's Key as two unsigned words whose lexicographic order is
// key_less's: (win, off bits) and (seq, slot), signed words biased by 2^31.

__device__ __forceinline__ uint64_t order_hi(int32_t win, int32_t off_bits) {
  return ((uint64_t)((uint32_t)win ^ 0x80000000u) << 32) | ((uint32_t)off_bits ^ 0x80000000u);
}

__device__ __forceinline__ uint64_t order_lo(int32_t seq, int slot) {
  return ((uint64_t)((uint32_t)seq ^ 0x80000000u) << 32) | (uint32_t)slot;
}

__device__ __forceinline__ bool order_less(uint64_t ah, uint64_t al, uint64_t bh, uint64_t bl) {
  return ah < bh || (ah == bh && al < bl);
}

// Ascending bitonic sort of n (a power of two) entries (hi[i], lo[i]) in
// shared memory by the whole block; the caller has published the entries
// with a barrier, and the sort ends with one.
__device__ __forceinline__ void block_bitonic_sort(uint64_t* hi, uint64_t* lo, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int a = 2 * i - (i & (stride - 1));
        const int b = a + stride;
        const uint64_t ah = hi[a], al = lo[a], bh = hi[b], bl = lo[b];
        if (order_less(bh, bl, ah, al) == ((a & size) == 0)) {
          hi[a] = bh;
          lo[a] = bl;
          hi[b] = ah;
          lo[b] = al;
        }
      }
      __syncthreads();
    }
  }
}

// Exclusive prefix sum of one int per thread over the block, in thread
// order; `total` gets the sum. `s_warp` holds 32 ints; two barriers.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int w = lane < (int)(blockDim.x >> 5) ? s_warp[lane] : 0;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, w, d);
    if (lane >= d) w += y;
  }
  const int before = __shfl_sync(0xffffffffu, w, (warp + 31) & 31);
  total = __shfl_sync(0xffffffffu, w, 31);
  __syncthreads();
  return (warp ? before : 0) + x - v;
}

__device__ __forceinline__ int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Launch `kernel_for<SLOTS>` with the slot count `slots` (a power of two
// up to kMaxCycleSlots): `launch` is called with a std::integral_constant.
template <typename Launch>
inline int dispatch_slots(int slots, Launch&& launch) {
  switch (slots) {
    case 1: return launch(std::integral_constant<int, 1>());
    case 2: return launch(std::integral_constant<int, 2>());
    case 4: return launch(std::integral_constant<int, 4>());
    case 8: return launch(std::integral_constant<int, 8>());
    case 16: return launch(std::integral_constant<int, 16>());
    case 32: return launch(std::integral_constant<int, 32>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// Copy a cluster's node rows into shared memory.
__device__ __forceinline__ void load_nodes(const uint8_t* alive, const int32_t* alloc_cpu,
                                           const int32_t* alloc_ram, int N, int32_t* s_cpu,
                                           int32_t* s_ram, uint8_t* s_alive) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    s_cpu[i] = alloc_cpu[i];
    s_ram[i] = alloc_ram[i];
    s_alive[i] = alive[i] ? 1 : 0;
  }
}

// Raise a kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace ktt
