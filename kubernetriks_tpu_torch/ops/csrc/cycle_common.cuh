// Device code shared by the three scheduling-cycle kernels
// (select_cycle_commit.cu, select_schedule_cycle.cu, schedule_cycle.cu):
// the bit-exact scores of the scheduler profiles, the decision pass (fit +
// score on every node, last-max-wins argmax) and the queue's order. One
// definition, so the kernels cannot drift apart, as the reference's
// `_argmin_select` (ops/scheduler_kernel.py:986) and `_fit_score_place`
// (:118) are shared by its Pallas kernels.
//
// A block of cycle_threads(N) threads runs one cluster. The node rows sit
// in registers (NodeRegs) and each placement is one register pass with one
// barrier. The two selecting kernels order the queue once per cycle
// (order_queue): the eligible pods' keys, packed into two 64-bit words
// (order_hi/order_lo), bitonic-sorted in shared memory a batch of picks at
// a time. Shared memory is fixed; none of it grows with N, P or K.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace ktt {

constexpr int kPhaseUnschedulable = 2;
constexpr int kPhaseRunning = 3;

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

// Score of pipeline.py `_score_most_allocated`, op for op.
__device__ __forceinline__ float most_allocated(int32_t cpu, int32_t ram, int32_t rc, int32_t rr) {
  const float cpu_f = (float)cpu, ram_f = (float)ram;
  const float cs = cpu > 0 ? __fdiv_rn(__fmul_rn(__fsub_rn((float)rc, cpu_f), 100.0f), cpu_f)
                           : -INFINITY;
  const float rs = ram > 0 ? __fdiv_rn(__fmul_rn(__fsub_rn((float)rr, ram_f), 100.0f), ram_f)
                           : -INFINITY;
  return __fmul_rn(__fadd_rn(cs, rs), 0.5f);
}

// Score of pipeline.py `_score_balanced`: the divisors guarded as there
// (1 where an allocatable is not positive), and `100 - |d| * 100` as one
// fused multiply-add, which is what XLA:CPU, the reference's yardstick,
// contracts it into (the intrinsic is exempt from --fmad=false).
__device__ __forceinline__ float balanced(int32_t cpu, int32_t ram, int32_t rc, int32_t rr) {
  const bool ok = cpu > 0 && ram > 0;
  const float cpu_frac = __fdiv_rn((float)rc, ok ? (float)cpu : 1.0f);
  const float ram_frac = __fdiv_rn((float)rr, ok ? (float)ram : 1.0f);
  const float d = fabsf(__fsub_rn(cpu_frac, ram_frac));
  return ok ? __fmaf_rn(-d, 100.0f, 100.0f) : -INFINITY;
}

// --- Scheduler profiles ------------------------------------------------------
// A profile is a fit predicate and a score (pipeline.py `profile_fit_mask`
// / `profile_score`). The default profile (Fit + LeastAllocatedResources,
// weight 1.0) is its own type, so its instantiation is the expression the
// kernels always ran. Every other profile runs TermProfile: the Fit filter
// or none, and a list of terms (scorer id, float32 weight bits, whether to
// multiply) in the profile's order, summed left to right after weighting;
// no term scores 0.0. The list lies in device memory, read through the
// read-only cache; it has no length limit.

constexpr int kScoreLeast = 0;
constexpr int kScoreMost = 1;
constexpr int kScoreBalanced = 2;

struct DefaultProfile {
  __device__ __forceinline__ bool fit(bool alive, int32_t cpu, int32_t ram, int32_t rc,
                                      int32_t rr) const {
    return alive && rc <= cpu && rr <= ram;
  }
  __device__ __forceinline__ float score(int32_t cpu, int32_t ram, int32_t rc, int32_t rr) const {
    return least_allocated(cpu, ram, rc, rr);
  }
};

struct TermProfile {
  const int32_t* __restrict__ terms;  // n_terms x (id, weight bits, multiply)
  int n_terms;
  int use_fit;

  __device__ __forceinline__ bool fit(bool alive, int32_t cpu, int32_t ram, int32_t rc,
                                      int32_t rr) const {
    return alive && (!use_fit || (rc <= cpu && rr <= ram));
  }
  __device__ __forceinline__ float score(int32_t cpu, int32_t ram, int32_t rc, int32_t rr) const {
    float total = 0.0f;
    for (int i = 0; i < n_terms; ++i) {
      const int id = __ldg(terms + 3 * i);
      float s = id == kScoreLeast  ? least_allocated(cpu, ram, rc, rr)
                : id == kScoreMost ? most_allocated(cpu, ram, rc, rr)
                                   : balanced(cpu, ram, rc, rr);
      if (__ldg(terms + 3 * i + 2)) s = __fmul_rn(s, __int_as_float(__ldg(terms + 3 * i + 1)));
      total = i ? __fadd_rn(total, s) : s;
    }
    return total;
  }
};

// Profile kinds of the C entry points: 0 the default profile, 1 a term
// list with the Fit filter, 2 a term list with no filter; another kind is
// refused. Each cycle kernel's library holds both instantiations.
template <typename Launch>
inline int dispatch_profile(int kind, const void* terms, int n_terms, Launch&& launch) {
  if (kind == 0) return launch(DefaultProfile{});
  if (kind == 1 || kind == 2) return launch(TermProfile{(const int32_t*)terms, n_terms, kind == 1 ? 1 : 0});
  return (int)cudaErrorInvalidValue;
}

struct Decision {
  int best;    // last node of maximal score (N - 1 when nothing fits)
  int anyfit;  // 1 when some alive node fits the request
};

// --- The register-resident decision pass ------------------------------------
// A block of T threads (cycle_threads) holds the cluster's node rows in
// registers: thread t owns slots t, t + T, ... (SLOTS of them,
// cycle_slots). One candidate is a fit + score over the owned slots, a warp
// max by `redux.sync` on an orderable score key and then on the node, one
// barrier (`__syncthreads_or`, which also yields any-fit), and the same
// two-step max over the per-warp partials, done by every warp at once so
// that no second barrier is needed. The owner of the chosen node deducts in
// its registers. With no fit every slot below N keys -inf and the last one,
// N - 1, wins; slots at or past N take no part.

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

  // The decision for request (rc, rr) under `prof`: every thread of the
  // block calls it (it holds one barrier) and gets the same result. `buf`
  // alternates between consecutive calls.
  template <typename Profile>
  __device__ __forceinline__ Decision fit_argmax(int N, int32_t rc, int32_t rr, Partials& part,
                                                 int buf, const Profile& prof) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t bkey = 0, bnode = 0;
    int fit_any = 0;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int n = threadIdx.x + j * blockDim.x;
      if (n < N) {
        const bool fit = prof.fit(alive[j], cpu[j], ram[j], rc, rr);
        const uint32_t key = score_key(fit ? prof.score(cpu[j], ram[j], rc, rr) : -INFINITY);
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

// --- The queue order as sortable words ---------------------------------------
// A queue entry's order (queue win, queue offset as int32 bits, queue seq,
// slot) as two unsigned words compared lexicographically: (win, off bits)
// and (seq, slot), signed words biased by 2^31. -0.0 comes before +0.0:
// its int32 bits are the least.

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

// --- The queue ordered once per cycle ---------------------------------------
// A pick leaves the queue whatever its fit, so a cycle's picks are the
// first min(depth, K) eligible pods in queue order and only the placements
// depend on each other. A queue of at most kQueueCap pods is counted,
// compacted with a block prefix sum and bitonic-sorted once. A deeper queue
// runs in batches of kQueueBatch picks. For each batch up to kQueueBatch
// threads walk their own slots once, all at the same time, and offer the
// pods past the previous batch's last key that are less than the batch's
// current kQueueBatch-th least key; the offers fill the buffer's upper half
// (a window) and each window is sorted with the lower half, which ends as
// the batch's picks. So a batch costs one pass over the slots spread over
// the block, and the least-key filter leaves most windows after the first
// few empty (no sort).

constexpr int kQueueCap = 512;
constexpr int kQueueBatch = kQueueCap / 2;
constexpr uint64_t kNoKey = ~0ull;  // above every real key: slot < 2^32 - 1

struct QueueOrder {
  uint64_t hi[kQueueCap], lo[kQueueCap];
  int warp[32];
};

// The slot of a batch's i-th pick.
__device__ __forceinline__ int pick_slot(const QueueOrder& q, int i) {
  return (int)(uint32_t)q.lo[i];
}

// Calls `batch(done, n)` for each batch of the cluster's picks, in pick
// order: picks done .. done + n - 1 are the pods pick_slot(q, 0 .. n - 1),
// which hold until `batch` returns. Every thread of the block calls it and
// `batch`; `batch` may hold barriers and must not write `q`. The operands
// are the cluster's rows. Returns the number of picks, min(depth, K).
template <typename Batch>
__device__ __forceinline__ int order_queue(const uint8_t* __restrict__ elig,
                                           const int32_t* __restrict__ qwin,
                                           const int32_t* __restrict__ qoff_bits,
                                           const int32_t* __restrict__ qseq, int P, int K,
                                           QueueOrder& q, Batch&& batch) {
  const int tid = threadIdx.x, T = blockDim.x;
  // The depth: the mask alone, so that its loads are all in flight together.
  int mine = 0;
  for (int p = tid; p < P; p += T) mine += elig[p] ? 1 : 0;
  int M;
  const int first = block_exclusive_scan(mine, q.warp, M);
  const int picks = M < K ? M : K;
  if (picks == 0) return 0;

  if (M <= kQueueCap) {
    // Every eligible pod, in this thread's compaction range, then one sort.
    const int n = pow2_ceil(M);
    for (int i = M + tid; i < n; i += T) {
      q.hi[i] = kNoKey;
      q.lo[i] = kNoKey;
    }
    for (int p = tid, idx = first; idx < first + mine; p += T) {
      if (!elig[p]) continue;
      q.hi[idx] = order_hi(qwin[p], qoff_bits[p]);
      q.lo[idx] = order_lo(qseq[p], p);
      ++idx;
    }
    __syncthreads();
    block_bitonic_sort(q.hi, q.lo, n);
    const int n0 = picks < kQueueBatch ? picks : kQueueBatch;
    batch(0, n0);
    __syncthreads();
    if (picks > n0) {
      for (int i = tid; i < picks - n0; i += T) {
        q.hi[i] = q.hi[kQueueBatch + i];
        q.lo[i] = q.lo[kQueueBatch + i];
      }
      __syncthreads();
      batch(n0, picks - n0);
      __syncthreads();
    }
    return picks;
  }

  // The first S = min(T, kQueueBatch) threads walk the slots (stride S) and
  // offer at positions j * S + tid for j < J of the upper half; the batch's
  // first window, with nothing held yet, fills the whole buffer (j < 2J).
  const int S = T < kQueueBatch ? T : kQueueBatch;
  const int J = kQueueBatch / S;

  uint64_t last_hi = 0, last_lo = 0;
  for (int done = 0; done < picks;) {
    int p = tid < S ? tid : P;  // this thread's next slot
    bool wide = true;
    for (;;) {
      const int Jw = wide ? 2 * J : J, cap = wide ? kQueueCap : kQueueBatch;
      uint64_t* const w_hi = wide ? q.hi : q.hi + kQueueBatch;
      uint64_t* const w_lo = wide ? q.lo : q.lo + kQueueBatch;
      // Offers must be less than the batch's kQueueBatch-th least key so
      // far (kNoKey until that many are held).
      const uint64_t bh = wide ? kNoKey : q.hi[kQueueBatch - 1];
      const uint64_t bl = wide ? kNoKey : q.lo[kQueueBatch - 1];
      int got = 0;
      while (got < Jw && p < P) {
        // Four slots' mask and keys in flight at once.
        uint8_t e[4];
        int32_t w[4], o[4], s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pp = p + u * S;
          const bool in = pp < P;
          e[u] = in ? elig[pp] : 0;
          w[u] = in ? qwin[pp] : 0;
          o[u] = in ? qoff_bits[pp] : 0;
          s[u] = in ? qseq[pp] : 0;
        }
        int u = 0;
        for (; u < 4 && got < Jw; ++u) {
          const int pp = p + u * S;
          if (!e[u]) continue;
          const uint64_t hi = order_hi(w[u], o[u]), lo = order_lo(s[u], pp);
          if ((done == 0 || order_less(last_hi, last_lo, hi, lo)) &&
              order_less(hi, lo, bh, bl)) {
            w_hi[got * S + tid] = hi;
            w_lo[got * S + tid] = lo;
            ++got;
          }
        }
        p += u * S;
      }
      if (tid < S) {
        for (int j = got; j < Jw; ++j) {
          w_hi[j * S + tid] = kNoKey;
          w_lo[j * S + tid] = kNoKey;
        }
      }
      for (int i = Jw * S + tid; i < cap; i += T) {  // positions no thread owns
        w_hi[i] = kNoKey;
        w_lo[i] = kNoKey;
      }
      const int any = __syncthreads_or(got);
      if (any) block_bitonic_sort(q.hi, q.lo, kQueueCap);
      wide = false;
      if (!__syncthreads_or(p < P)) break;
    }

    const int n = picks - done < kQueueBatch ? picks - done : kQueueBatch;
    batch(done, n);
    last_hi = q.hi[n - 1];
    last_lo = q.lo[n - 1];
    done += n;
    __syncthreads();
  }
  return picks;
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

}  // namespace ktt
