// The two-kernel route's first half: queue selection and the cycle, with
// the per-candidate decisions returned instead of committed.
//
// Replaces: kubernetriks_tpu/ops/scheduler_kernel.py
// `fused_select_schedule_cycle` (:336; Pallas kernel `_select_cycle_kernel`
// :239). It is the megakernel (select_cycle_commit.cu) without its commit:
// per cluster, up to K times, the remaining eligible pod with the least
// (queue win, offset bits, seq) — lowest slot on a whole-key tie — is
// fitted and scored on every node, placed on the last node of maximal
// score where some node fits, and its row k written: cand = its slot,
// valid = 1, assign = fit_any = whether a node fits, best = that node.
// Rows past the cluster's queue depth (or K) are zero. commit_scatter.cu
// writes the decisions into the pod rows.
//
// Bound on an H100: bytes, as the megakernel's (its note): the eligible
// mask, the queue keys of the eligible pods and the requests of the picked
// ones, the node rows in and out and 15 B per candidate row out. The K
// picks per cluster are latency-bound block-wide reductions in sequence.
//
// Design: the megakernel's, through the same device code
// (cycle_common.cuh): one block of 256 threads per cluster, the node rows,
// the three queue-key rows and the remaining mask in shared memory
// (4(2N+3P) + N + P bytes), one block argmin and one decision pass per
// pick, thread 0 deducting and writing the row.

#include "cycle_common.cuh"

namespace {

using namespace ktt;

__global__ void select_schedule_cycle_kernel(
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ alloc_cpu,
    const int32_t* __restrict__ alloc_ram, const uint8_t* __restrict__ eligible,
    const int32_t* __restrict__ qwin, const int32_t* __restrict__ qoff_bits,
    const int32_t* __restrict__ qseq, const int32_t* __restrict__ req_cpu,
    const int32_t* __restrict__ req_ram, int32_t* __restrict__ cand_out,
    uint8_t* __restrict__ valid_out, uint8_t* __restrict__ assign_out,
    uint8_t* __restrict__ fitany_out, int32_t* __restrict__ best_out,
    int32_t* __restrict__ cpu_out, int32_t* __restrict__ ram_out, int N, int P,
    int K) {
  extern __shared__ int32_t smem[];
  int32_t* s_cpu = smem;
  int32_t* s_ram = s_cpu + N;
  int32_t* s_win = s_ram + N;
  int32_t* s_off = s_win + P;
  int32_t* s_seq = s_off + P;
  uint8_t* s_alive = reinterpret_cast<uint8_t*>(s_seq + P);
  uint8_t* s_rem = s_alive + N;
  __shared__ Scratch scratch;

  const size_t c = blockIdx.x;
  const size_t nb = c * (size_t)N, pb = c * (size_t)P, kb = c * (size_t)K;
  const int tid = threadIdx.x;

  load_nodes(alive + nb, alloc_cpu + nb, alloc_ram + nb, N, s_cpu, s_ram, s_alive);
  int depth = 0;
  for (int p = tid; p < P; p += kThreads) {
    s_win[p] = qwin[pb + p];
    s_off[p] = qoff_bits[pb + p];
    s_seq[p] = qseq[pb + p];
    const uint8_t e = eligible[pb + p] ? 1 : 0;
    s_rem[p] = e;
    depth += e;
  }
  depth = block_sum(depth, scratch);  // its syncs also publish the rows
  const int picks = depth < K ? depth : K;
  for (int k = picks + tid; k < K; k += kThreads) {
    cand_out[kb + k] = 0;
    valid_out[kb + k] = 0;
    assign_out[kb + k] = 0;
    fitany_out[kb + k] = 0;
    best_out[kb + k] = 0;
  }

  for (int k = 0; k < picks; ++k) {
    const int slot = block_select(s_win, s_off, s_seq, s_rem, P, scratch);
    const int32_t rc = req_cpu[pb + slot], rr = req_ram[pb + slot];
    const Decision d = block_fit_argmax(s_cpu, s_ram, s_alive, N, rc, rr, scratch);
    if (tid == 0) {
      if (d.anyfit) {
        s_cpu[d.best] -= rc;
        s_ram[d.best] -= rr;
      }
      cand_out[kb + k] = slot;
      valid_out[kb + k] = 1;
      assign_out[kb + k] = d.anyfit ? 1 : 0;
      fitany_out[kb + k] = d.anyfit ? 1 : 0;
      best_out[kb + k] = d.best;
      s_rem[slot] = 0;
    }
    __syncthreads();
  }

  for (int i = tid; i < N; i += kThreads) {
    cpu_out[nb + i] = s_cpu[i];
    ram_out[nb + i] = s_ram[i];
  }
}

}  // namespace

extern "C" int ktt_select_schedule_cycle(
    const void* alive, const void* alloc_cpu, const void* alloc_ram,
    const void* eligible, const void* qwin, const void* qoff, const void* qseq,
    const void* req_cpu, const void* req_ram, void* cand_out, void* valid_out,
    void* assign_out, void* fitany_out, void* best_out, void* cpu_out,
    void* ram_out, int C, int N, int P, int K, void* stream) {
  if (C <= 0) return 0;
  const size_t smem = sizeof(int32_t) * (2 * (size_t)N + 3 * (size_t)P) + (size_t)N + (size_t)P;
  const cudaError_t e = allow_smem(select_schedule_cycle_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  select_schedule_cycle_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)alive, (const int32_t*)alloc_cpu, (const int32_t*)alloc_ram,
      (const uint8_t*)eligible, (const int32_t*)qwin, (const int32_t*)qoff,
      (const int32_t*)qseq, (const int32_t*)req_cpu, (const int32_t*)req_ram,
      (int32_t*)cand_out, (uint8_t*)valid_out, (uint8_t*)assign_out,
      (uint8_t*)fitany_out, (int32_t*)best_out, (int32_t*)cpu_out,
      (int32_t*)ram_out, N, P, K);
  return (int)cudaGetLastError();
}
