// Device code shared by the three scheduling-cycle kernels
// (select_cycle_commit.cu, select_schedule_cycle.cu, schedule_cycle.cu):
// the queue key order, the bit-exact LeastAllocatedResources score, and the
// two block-wide passes every cycle is made of — the queue pick (a
// lexicographic argmin over the remaining eligible pods) and the decision
// pass (fit + score on every node, last-max-wins argmax). One definition,
// so the three kernels cannot drift apart, as the reference's
// `_argmin_select` (ops/scheduler_kernel.py:986) and `_fit_score_place`
// (:118) are shared by its Pallas kernels.
//
// Every kernel runs one block of kThreads threads per cluster with the
// cluster's rows in shared memory. Both passes end with every thread
// holding the same result, read from per-warp slots in shared memory; the
// caller must __syncthreads() before the next pass reuses those slots (the
// cycle loops do, after each commit).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
