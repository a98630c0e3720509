// The candidate cycle of the sorted route: K pre-sorted candidates per
// cluster placed one after another on its nodes.
//
// Replaces: kubernetriks_tpu/ops/scheduler_kernel.py `fused_schedule_cycle`
// (:903; Pallas kernel `_cycle_kernel` :152, decision core
// `_fit_score_place` :118). The caller sorts the queue and gathers the top
// K (step.prepare_cycle), so a cluster's valid rows are a prefix. Per
// cluster, for each row k below its last valid row + 1 (capped at K):
//   fit mask + LeastAllocatedResources score on every node, the last node
//   of maximal score (ties go to the highest slot; with no fit, the last
//   node), and, where the row is valid and some node fits, the request
//   deducted from that node. assign = valid & fit, fit_any and best are
//   written for every such row; rows at or past the bound stay zero.
//
// Bound on an H100: at the trace-replay shape (C = 1, N = 1 713 node slots,
// K = 256) the function must read the node rows (9N B) and the candidates
// up to the last valid one (9 B each), and write two node rows (8N B) and
// 6 B per candidate row: ~30 KB, ~0.01 us at 3.35 TB/s. What bounds it is
// latency: each candidate is a block-wide pass over the N nodes and a
// reduction, one after another, and at C = 1 one block runs on one of the
// 132 SMs.
//
// Design: one block of 256 threads per cluster (cycle_common.cuh). The
// allocatable rows and the alive mask sit in shared memory (9N B: 15 KB at
// N = 1 713), so a candidate is one pass over shared memory, a warp
// shuffle reduction of (score, node) and one pass over the per-warp
// results; thread 0 deducts and writes the row. The loop stops at the
// cluster's own last valid row, the early exit of the Pallas kernel.

#include "cycle_common.cuh"

namespace {

using namespace ktt;

__global__ void schedule_cycle_kernel(
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ alloc_cpu,
    const int32_t* __restrict__ alloc_ram, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ req_cpu, const int32_t* __restrict__ req_ram,
    uint8_t* __restrict__ assign_out, uint8_t* __restrict__ fitany_out,
    int32_t* __restrict__ best_out, int32_t* __restrict__ cpu_out,
    int32_t* __restrict__ ram_out, int N, int K) {
  extern __shared__ int32_t smem[];
  int32_t* s_cpu = smem;
  int32_t* s_ram = s_cpu + N;
  uint8_t* s_alive = reinterpret_cast<uint8_t*>(s_ram + N);
  __shared__ Scratch scratch;
  __shared__ int s_live;

  const size_t c = blockIdx.x;
  const size_t nb = c * (size_t)N, kb = c * (size_t)K;
  const int tid = threadIdx.x;

  load_nodes(alive + nb, alloc_cpu + nb, alloc_ram + nb, N, s_cpu, s_ram, s_alive);
  // The bound: last valid row + 1.
  if (tid == 0) s_live = 0;
  __syncthreads();
  int live = 0;
  for (int k = tid; k < K; k += kThreads)
    if (valid[kb + k]) live = k + 1;
  if (live) atomicMax(&s_live, live);
  __syncthreads();
  const int bound = s_live;
  for (int k = bound + tid; k < K; k += kThreads) {
    assign_out[kb + k] = 0;
    fitany_out[kb + k] = 0;
    best_out[kb + k] = 0;
  }

  for (int k = 0; k < bound; ++k) {
    const int32_t rc = req_cpu[kb + k], rr = req_ram[kb + k];
    const Decision d = block_fit_argmax(s_cpu, s_ram, s_alive, N, rc, rr, scratch);
    if (tid == 0) {
      const bool assign = valid[kb + k] && d.anyfit;
      if (assign) {
        s_cpu[d.best] -= rc;
        s_ram[d.best] -= rr;
      }
      assign_out[kb + k] = assign ? 1 : 0;
      fitany_out[kb + k] = d.anyfit ? 1 : 0;
      best_out[kb + k] = d.best;
    }
    __syncthreads();
  }

  for (int i = tid; i < N; i += kThreads) {
    cpu_out[nb + i] = s_cpu[i];
    ram_out[nb + i] = s_ram[i];
  }
}

}  // namespace

extern "C" int ktt_schedule_cycle(const void* alive, const void* alloc_cpu,
                                  const void* alloc_ram, const void* valid,
                                  const void* req_cpu, const void* req_ram,
                                  void* assign_out, void* fitany_out, void* best_out,
                                  void* cpu_out, void* ram_out, int C, int N, int K,
                                  void* stream) {
  if (C <= 0) return 0;
  const size_t smem = 2 * sizeof(int32_t) * (size_t)N + (size_t)N;
  const cudaError_t e = allow_smem(schedule_cycle_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  schedule_cycle_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)alive, (const int32_t*)alloc_cpu, (const int32_t*)alloc_ram,
      (const uint8_t*)valid, (const int32_t*)req_cpu, (const int32_t*)req_ram,
      (uint8_t*)assign_out, (uint8_t*)fitany_out, (int32_t*)best_out,
      (int32_t*)cpu_out, (int32_t*)ram_out, N, K);
  return (int)cudaGetLastError();
}
