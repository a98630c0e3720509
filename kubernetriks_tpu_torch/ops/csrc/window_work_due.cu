// The window-cost razor's predicate: could a window's event application
// change any state leaf at window W?
//
// Replaces no TPU kernel. The reference computes it in XLA
// (kubernetriks_tpu/batched/step.py:157 `_window_work_due`), fused; in
// eager PyTorch it is ~12 launches (compares and reductions over (C, N)
// and (C, P)). The window executor reads the flag in a CUDA graph
// conditional node (ops/csrc/graph_if.cu), so the host never sees it.
//
// due = OR over every cluster c of
//   cursor[c] < E and packed[c, clamp(cursor[c], 0, E - 1)].win < W[c]
//   (a trace event is due)
//   or any node n: create_win[c, n] < W[c] or remove_win[c, n] < W[c]
//   or any pod p: removal_win[c, p] < W[c]
//   or (phase[c, p] == RUNNING and (finish_win < W[c] or (finish_win ==
//   W[c] and finish_off <= 0)))   (a finish due by the window's start)
//
// Bound on an H100: bytes. It reads every (C, N) and (C, P) row once
// (8 B a node, 16 B a pod) and writes one flag. Design: one block per
// cluster ORs its rows (__syncthreads_or) into a per-cluster byte, then
// one block ORs the clusters' bytes into the flag: two launches, no
// atomics and no flag to clear beforehand.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRunning = 3;  // PHASE_RUNNING

__global__ void work_due_rows(const int32_t* __restrict__ cursor, const int32_t* __restrict__ packed,
                              const int32_t* __restrict__ create_win, const int32_t* __restrict__ remove_win,
                              const int32_t* __restrict__ removal_win, const int32_t* __restrict__ phase,
                              const int32_t* __restrict__ finish_win, const float* __restrict__ finish_off,
                              const int32_t* __restrict__ W, uint8_t* __restrict__ rows, int N, int P, int E) {
  const int c = blockIdx.x;
  const int w = W[c];
  int due = 0;
  if (threadIdx.x == 0 && E > 0) {
    const int cur = cursor[c];
    const int at = cur < 0 ? 0 : (cur > E - 1 ? E - 1 : cur);
    due = cur < E && packed[((size_t)c * E + at) * 4] < w;
  }
  const size_t nb = (size_t)c * N;
  for (int n = threadIdx.x; n < N && !due; n += blockDim.x) {
    due = create_win[nb + n] < w || remove_win[nb + n] < w;
  }
  const size_t pb = (size_t)c * P;
  for (int p = threadIdx.x; p < P && !due; p += blockDim.x) {
    const int fw = finish_win[pb + p];
    due = removal_win[pb + p] < w ||
          (phase[pb + p] == kRunning && (fw < w || (fw == w && finish_off[pb + p] <= 0.0f)));
  }
  due = __syncthreads_or(due);
  if (threadIdx.x == 0) rows[c] = due ? 1 : 0;
}

__global__ void work_due_any(const uint8_t* __restrict__ rows, bool* __restrict__ out, int C) {
  int due = 0;
  for (int c = threadIdx.x; c < C && !due; c += blockDim.x) due = rows[c];
  due = __syncthreads_or(due);
  if (threadIdx.x == 0) *out = due != 0;
}

}  // namespace

extern "C" int ktt_window_work_due(const void* cursor, const void* packed, const void* create_win,
                                   const void* remove_win, const void* removal_win, const void* phase,
                                   const void* finish_win, const void* finish_off, const void* W, void* rows,
                                   void* out, int C, int N, int P, int E, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C > 0) {
    work_due_rows<<<C, 256, 0, s>>>(
        (const int32_t*)cursor, (const int32_t*)packed, (const int32_t*)create_win, (const int32_t*)remove_win,
        (const int32_t*)removal_win, (const int32_t*)phase, (const int32_t*)finish_win,
        (const float*)finish_off, (const int32_t*)W, (uint8_t*)rows, N, P, E);
  }
  work_due_any<<<1, 1024, 0, s>>>((const uint8_t*)rows, (bool*)out, C);
  return (int)cudaGetLastError();
}
