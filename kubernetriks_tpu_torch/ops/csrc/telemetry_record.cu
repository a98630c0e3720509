// The flight recorder's per-window record: one int32 row a cluster into
// the telemetry ring.
//
// Replaces no TPU kernel. The reference computes it in XLA
// (kubernetriks_tpu/batched/step.py:1784 `_telemetry_record`), fused; in
// eager PyTorch it is ~30 launches (two phase counts over P, the alive
// count over N, the reserve sums over the groups, ten counter deltas, the
// stack and the scatter), which a window of graphs would replay every
// window. Here it is one launch.
//
// Row of cluster c, written at slot cursor[c] % R:
//   [window, decisions delta, #QUEUED, #UNSCHEDULABLE, HPA pod actions
//    delta, CA node actions delta, fault events delta, #alive nodes,
//    sum_g(hpa_tail - hpa_head), sum_g(ca_cursor),
//    max(head_bound - pod_base, 0), lane active]
// where window is W[c], or Wrec[c] where the optional Wrec is given (a
// lane-asynchronous engine records the global window there, W being the
// lane's own), and lane active is 1, or active[c] where the optional
// (C,) bool active is given (the reference's TELEM_LANE_ACTIVE column,
// step.py:1853-1876).
// where a delta is the counter now less its snapshot m0 (the window's
// incoming counters), head_bound = trace_pod_bound - plain width (a host
// int), and the reserve sums are 0 without the autoscalers. Then cursor
// += 1 and m0 = the counters now: the next window's incoming counters
// (nothing between two windows changes them).
//
// Integer only: bit for bit with its plain version (batched/step.py
// `telemetry_record_plain`). Bound on an H100: bytes (the (C, P) phase row
// and the (C, N) alive row, read once). Design: one block per cluster
// counts its rows with warp shuffles; thread 0 writes the row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQueued = 1;  // PHASE_QUEUED
constexpr int kUnsched = 2;  // PHASE_UNSCHEDULABLE
constexpr int kCols = 12;  // TELEMETRY_COLS
constexpr int kCounters = 10;  // TELEM_COUNTERS
constexpr int kThreads = 256;

struct Counters {
  const int32_t* p[kCounters];
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) telemetry_record_kernel(
    const int32_t* __restrict__ phase, const bool* __restrict__ alive, const int32_t* __restrict__ hpa_head,
    const int32_t* __restrict__ hpa_tail, const int32_t* __restrict__ ca_cursor,
    const int32_t* __restrict__ pod_base, const int32_t* __restrict__ W, const int32_t* __restrict__ Wrec,
    const bool* __restrict__ active, Counters now, int32_t* __restrict__ m0,
    int32_t* __restrict__ buf, int32_t* __restrict__ cursor, int C, int P, int N, int Gp, int Gn, int R,
    int head_bound) {
  const int c = blockIdx.x;
  int queued = 0, unsched = 0, n_alive = 0;
  const int32_t* ph = phase + (size_t)c * P;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int v = ph[p];
    queued += v == kQueued;
    unsched += v == kUnsched;
  }
  const bool* al = alive + (size_t)c * N;
  for (int n = threadIdx.x; n < N; n += kThreads) n_alive += al[n] ? 1 : 0;
  __shared__ int part[3][kThreads / 32];
  queued = warp_sum(queued);
  unsched = warp_sum(unsched);
  n_alive = warp_sum(n_alive);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = queued;
    part[1][warp] = unsched;
    part[2][warp] = n_alive;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  queued = unsched = n_alive = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    queued += part[0][w];
    unsched += part[1][w];
    n_alive += part[2][w];
  }
  int hpa_used = 0, ca_used = 0;
  for (int g = 0; g < Gp; ++g) hpa_used += hpa_tail[(size_t)c * Gp + g] - hpa_head[(size_t)c * Gp + g];
  for (int g = 0; g < Gn; ++g) ca_used += ca_cursor[(size_t)c * Gn + g];
  int d[kCounters];
  for (int k = 0; k < kCounters; ++k) {
    const int v = now.p[k][c];
    d[k] = v - m0[(size_t)k * C + c];
    m0[(size_t)k * C + c] = v;
  }
  const int headroom = max(head_bound - pod_base[c], 0);
  const int cur = cursor[c];
  const int slot = ((cur % R) + R) % R;
  int32_t* row = buf + ((size_t)c * R + slot) * kCols;
  row[0] = Wrec != nullptr ? Wrec[c] : W[c];
  row[1] = d[0];
  row[2] = queued;
  row[3] = unsched;
  row[4] = d[1] + d[2];
  row[5] = d[3] + d[4];
  row[6] = d[5] + d[6] + d[7] + d[8] + d[9];
  row[7] = n_alive;
  row[8] = hpa_used;
  row[9] = ca_used;
  row[10] = headroom;
  row[11] = active != nullptr ? (active[c] ? 1 : 0) : 1;
  cursor[c] = cur + 1;
}

}  // namespace

extern "C" int ktt_telemetry_record(const void* phase, const void* alive, const void* hpa_head,
                                    const void* hpa_tail, const void* ca_cursor, const void* pod_base,
                                    const void* W, const void* Wrec, const void* active, const void* c0,
                                    const void* c1, const void* c2, const void* c3, const void* c4, const void* c5,
                                    const void* c6, const void* c7, const void* c8, const void* c9, void* m0,
                                    void* buf, void* cursor, int C, int P, int N, int Gp, int Gn, int R,
                                    int head_bound, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  Counters now;
  const void* cs[kCounters] = {c0, c1, c2, c3, c4, c5, c6, c7, c8, c9};
  for (int k = 0; k < kCounters; ++k) now.p[k] = (const int32_t*)cs[k];
  telemetry_record_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)phase, (const bool*)alive, (const int32_t*)hpa_head, (const int32_t*)hpa_tail,
      (const int32_t*)ca_cursor, (const int32_t*)pod_base, (const int32_t*)W, (const int32_t*)Wrec,
      (const bool*)active, now, (int32_t*)m0,
      (int32_t*)buf, (int32_t*)cursor, C, P, N, Gp, Gn, R, head_bound);
  return (int)cudaGetLastError();
}
