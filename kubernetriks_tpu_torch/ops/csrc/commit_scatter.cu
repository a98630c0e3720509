// The two-kernel route's second half: the cycle's K decisions per cluster
// written into the pod rows.
//
// Replaces: kubernetriks_tpu/ops/scheduler_kernel.py `fused_commit_scatter`
// (:828; Pallas kernel `_commit_kernel` :767). Outputs: phase and node
// copied from the inputs, start and park offsets +inf; then for each
// (cluster, k) that was assigned or parked: phase = RUNNING or
// UNSCHEDULABLE at slot cand[k], and where assigned node = best[k] and
// start = start_s[k], where parked park = park_s[k].
//
// Bound on an H100: bytes. The function must read the two pod rows it
// copies through (8P B per cluster) and the candidate rows (22 B each:
// slot, two flags, node and two offsets), and write four pod rows (16P B):
// at C = 1024, P = 2 048, K = 64, ~51 MB, ~15 us at 3.35 TB/s.
//
// Design: two kernels on one stream, in that order, so the order of the
// writes is explicit: a grid-stride fill of the four outputs (coalesced),
// then one thread per (cluster, k) writing its slot. Candidate slots are
// unique within a cluster's cycle, so no two threads of the second kernel
// write one element and no atomics are needed. Slots outside [0, P) are
// dropped.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPhaseUnschedulable = 2;
constexpr int kPhaseRunning = 3;

__global__ void commit_fill_kernel(const int32_t* __restrict__ phase,
                                   const int32_t* __restrict__ node,
                                   int32_t* __restrict__ phase_out,
                                   int32_t* __restrict__ node_out,
                                   float* __restrict__ start_out,
                                   float* __restrict__ park_out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    phase_out[i] = phase[i];
    node_out[i] = node[i];
    start_out[i] = INFINITY;
    park_out[i] = INFINITY;
  }
}

__global__ void commit_scatter_kernel(
    const int32_t* __restrict__ cand, const uint8_t* __restrict__ assign,
    const uint8_t* __restrict__ park, const int32_t* __restrict__ best,
    const float* __restrict__ start_s, const float* __restrict__ park_s,
    int32_t* __restrict__ phase_out, int32_t* __restrict__ node_out,
    float* __restrict__ start_out, float* __restrict__ park_out, int C, int P,
    int K) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)C * K) return;
  const bool a = assign[i], pk = park[i];
  const int slot = cand[i];
  if (!(a || pk) || slot < 0 || slot >= P) return;
  const size_t at = (i / K) * (size_t)P + slot;
  if (a) {
    phase_out[at] = kPhaseRunning;
    node_out[at] = best[i];
    start_out[at] = start_s[i];
  } else {
    phase_out[at] = kPhaseUnschedulable;
  }
  if (pk) park_out[at] = park_s[i];
}

}  // namespace

extern "C" int ktt_commit_scatter(const void* cand, const void* assign, const void* park,
                                  const void* best, const void* start_s, const void* park_s,
                                  const void* phase, const void* node, void* phase_out,
                                  void* node_out, void* start_out, void* park_out, int C,
                                  int P, int K, void* stream) {
  if (C <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n = (size_t)C * P;
  if (n) {
    size_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    commit_fill_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)phase, (const int32_t*)node, (int32_t*)phase_out,
        (int32_t*)node_out, (float*)start_out, (float*)park_out, n);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const size_t m = (size_t)C * K;
  if (m) {
    commit_scatter_kernel<<<(unsigned)((m + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        (const int32_t*)cand, (const uint8_t*)assign, (const uint8_t*)park,
        (const int32_t*)best, (const float*)start_s, (const float*)park_s,
        (int32_t*)phase_out, (int32_t*)node_out, (float*)start_out, (float*)park_out, C, P,
        K);
  }
  return (int)cudaGetLastError();
}
