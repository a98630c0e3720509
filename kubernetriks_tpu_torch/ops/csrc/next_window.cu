// The next window whose body could change state, for fast-forward: the
// span [W + 1, next) the window executor skips, with next clamped to the
// span's limit.
//
// Replaces no TPU kernel. The reference computes it in XLA
// (kubernetriks_tpu/batched/step.py:2239 `_next_interesting_window`),
// fused; in eager PyTorch it is ~30 launches of compares and reductions.
//
// next = max(W + 1, cand), cand the least over every cluster of
//   the next unapplied trace event's window + 1 (cursor < E),
//   a running pod's finish window,
//   a pending node creation's, node removal's, pod removal's window + 1,
//   a queued pod's queue window + 1,
//   where any pod of any cluster is parked: the least last flush window
//     + flush_windows,
//   with the autoscalers: the HPA tick's window, the collection latch's
//     window, and, where any pod is parked or any cluster has a CA node,
//     the CA cycle's snapshot window (ca_next + ca_snap, the float32 pair
//     sum of timerep.t_add, unfused);
// span = [W + 1, min(next, limit)]. INF_WIN (2^29) stands for none.
//
// Bound on an H100: bytes. It reads the (C, P) phase, finish, removal and
// queue windows (16 B a pod), the (C, N) node windows (8 B a node), a slab
// word and a few (C,) words a cluster. Design: one block per cluster
// reduces its rows to five words (its least trigger, parked or not, its
// last flush window, its CA snapshot window, has CA nodes or not); one
// block then combines the clusters' words in the reference's order: two
// launches, no atomics on global memory, no buffer to clear beforehand.
//
// `part` 1 launches the first pass (the (C, 5) words from the state's
// rows), `part` 2 the combine over C given words (W, limit -> span): a
// cluster batch sharded over a mesh gathers every shard's words between
// the two, so its span is the whole batch's (the reference reduces over
// the whole sharded axis). The pointers a part does not read may be null.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kQueued = 1;         // PHASE_QUEUED
constexpr int kUnschedulable = 2;  // PHASE_UNSCHEDULABLE
constexpr int kRunning = 3;        // PHASE_RUNNING
constexpr int kBig = 1 << 29;      // INF_WIN

__global__ void next_rows(const int32_t* __restrict__ cursor, const int32_t* __restrict__ packed,
                          const int32_t* __restrict__ phase, const int32_t* __restrict__ finish_win,
                          const int32_t* __restrict__ create_win, const int32_t* __restrict__ remove_win,
                          const int32_t* __restrict__ removal_win, const int32_t* __restrict__ queue_win,
                          const int32_t* __restrict__ last_flush, const int32_t* __restrict__ ca_next_win,
                          const float* __restrict__ ca_next_off, const int32_t* __restrict__ ca_snap_win,
                          const float* __restrict__ ca_snap_off, const int32_t* __restrict__ hpa_next_win,
                          const int32_t* __restrict__ col_next_win, const int32_t* __restrict__ ca_count,
                          int32_t* __restrict__ rows, int N, int P, int E, int G, int has_auto, float interval) {
  const int c = blockIdx.x;
  __shared__ int s_min;
  if (threadIdx.x == 0) s_min = INT32_MAX;
  __syncthreads();
  int m = INT32_MAX;
  int parked = 0;
  const size_t pb = (size_t)c * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int ph = phase[pb + p];
    if (ph == kRunning) m = min(m, finish_win[pb + p]);
    m = min(m, removal_win[pb + p] + 1);
    if (ph == kQueued) m = min(m, queue_win[pb + p] + 1);
    parked |= ph == kUnschedulable;
  }
  const size_t nb = (size_t)c * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    m = min(m, min(create_win[nb + n], remove_win[nb + n]) + 1);
  }
  int snap = kBig, ca_any = 0;
  if (threadIdx.x == 0) {
    if (E > 0) {
      const int cur = cursor[c];
      const int at = cur < 0 ? 0 : (cur > E - 1 ? E - 1 : cur);
      m = min(m, (cur < E ? packed[((size_t)c * E + at) * 4] : kBig) + 1);
    } else {
      m = min(m, kBig + 1);
    }
    if (has_auto) {
      m = min(m, hpa_next_win[c]);
      if (col_next_win != nullptr) m = min(m, col_next_win[c]);
      // t_add: the offsets' float32 sum renormalized by one carry.
      const float off = __fadd_rn(ca_next_off[c], ca_snap_off[c]);
      const float q = floorf(__fdiv_rn(off, interval));
      snap = ca_next_win[c] + ca_snap_win[c] + (int)q;
      for (int g = 0; g < G; ++g) ca_any |= ca_count[(size_t)c * G + g] != 0;
    }
  }
  atomicMin(&s_min, m);
  parked = __syncthreads_or(parked);
  if (threadIdx.x == 0) {
    int32_t* r = rows + (size_t)c * 5;
    r[0] = s_min;
    r[1] = parked;
    r[2] = last_flush[c];
    r[3] = snap;
    r[4] = ca_any;
  }
}

__global__ void next_combine(const int32_t* __restrict__ rows, const int32_t* __restrict__ W,
                             const int32_t* __restrict__ limit, int32_t* __restrict__ span, int C,
                             int flush_windows, int has_auto) {
  __shared__ int s_cand, s_flush, s_snap;
  if (threadIdx.x == 0) {
    s_cand = INT32_MAX;
    s_flush = INT32_MAX;
    s_snap = INT32_MAX;
  }
  __syncthreads();
  int cand = INT32_MAX, flush = INT32_MAX, snap = INT32_MAX, parked = 0, ca_any = 0;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int32_t* r = rows + (size_t)c * 5;
    cand = min(cand, r[0]);
    parked |= r[1];
    flush = min(flush, r[2]);
    snap = min(snap, r[3]);
    ca_any |= r[4];
  }
  atomicMin(&s_cand, cand);
  atomicMin(&s_flush, flush);
  atomicMin(&s_snap, snap);
  parked = __syncthreads_or(parked);
  ca_any = __syncthreads_or(ca_any);
  if (threadIdx.x == 0) {
    int best = s_cand;
    best = min(best, parked ? s_flush + flush_windows : kBig);
    if (has_auto) best = min(best, (parked || ca_any) ? s_snap : kBig);
    const int first = W[0] + 1;
    span[0] = first;
    span[1] = min(max(first, best), limit[0]);
  }
}

}  // namespace

extern "C" int ktt_next_window(const void* cursor, const void* packed, const void* phase, const void* finish_win,
                               const void* create_win, const void* remove_win, const void* removal_win,
                               const void* queue_win, const void* last_flush, const void* W, const void* limit,
                               const void* ca_next_win, const void* ca_next_off, const void* ca_snap_win,
                               const void* ca_snap_off, const void* hpa_next_win, const void* col_next_win,
                               const void* ca_count, void* rows, void* span, int C, int N, int P, int E, int G,
                               int flush_windows, int has_auto, int interval_bits, int part, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float interval;
  memcpy(&interval, &interval_bits, 4);
  if (part == 1) {
    if (C > 0) {
      next_rows<<<C, 256, 0, s>>>(
          (const int32_t*)cursor, (const int32_t*)packed, (const int32_t*)phase, (const int32_t*)finish_win,
          (const int32_t*)create_win, (const int32_t*)remove_win, (const int32_t*)removal_win,
          (const int32_t*)queue_win, (const int32_t*)last_flush, (const int32_t*)ca_next_win,
          (const float*)ca_next_off, (const int32_t*)ca_snap_win, (const float*)ca_snap_off,
          (const int32_t*)hpa_next_win, (const int32_t*)col_next_win, (const int32_t*)ca_count, (int32_t*)rows,
          N, P, E, G, has_auto, interval);
    }
  } else if (part == 2) {
    next_combine<<<1, 1024, 0, s>>>((const int32_t*)rows, (const int32_t*)W, (const int32_t*)limit,
                                    (int32_t*)span, C, flush_windows, has_auto);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
