// The scheduling megakernel: queue selection, fit/score/place and the
// decision commit of one window's cycle, for every cluster in one launch.
//
// Replaces: kubernetriks_tpu/ops/scheduler_kernel.py
// `fused_select_cycle_commit` (:1139; Pallas kernel
// `_select_cycle_commit_kernel` :1010, selection `_argmin_select` :986,
// decision core `_fit_score_place` :118). Per cluster, up to K times:
//   1. pick the remaining eligible pod with the least (queue win, queue
//      offset as int32 bits, queue seq) — the active queue's order;
//   2. Fit mask + LeastAllocatedResources score on every node, written op
//      for op as kubernetriks_tpu/batched/pipeline.py:97-117 (IEEE
//      division, no contraction), and the last node of maximal score
//      (ties go to the highest slot);
//   3. if a node fits: deduct its allocatable, mark the pod RUNNING on it
//      with start offset start_t[k], and fold waited + qpre_t[k] into the
//      queue-time estimator; else park it UNSCHEDULABLE at park_t[k].
// Picks run in order, one thread commits each, so the deductions and the
// estimator fold happen in the reference loop's order.
//
// Bound on an H100: bytes. Per cluster the function must read the node
// rows (9N B), the eligible mask (P B), the queue keys of the eligible pods
// (12 B each), the requests, wait and table entries of the picked ones
// (24 B each) and the phase/node rows it copies through (8P B), and write
// two node rows (8N B), four pod rows (16P B) and 5 stats: at N=256,
// P=2048 ~56 KB per cluster, ~57 MB per launch at C=1024, ~17 us at
// 3.35 TB/s (chip_smoke.py counts it from the run's data). The work per
// pick (a pass over the queue keys and the N nodes) is latency-bound, not
// rate-bound: K block-wide reductions in sequence per cluster.
//
// Design: one block of 256 threads per cluster. The cluster's allocatable
// rows, alive mask, the three queue-key rows and the remaining-eligible
// mask sit in shared memory (4(2N+3P) + N + P bytes: ~29 KB at the
// headline shape; the wrapper refuses shapes above 227 KB), so each of
// the K picks is two block-wide reductions over shared memory (warp
// shuffles, then one pass over the per-warp results; cycle_common.cuh,
// shared with the two-kernel route's selection kernel and the sorted
// route's candidate kernel) and one serial commit. The full-width outputs
// (phase, node, start, park) are written once by coalesced strided copies
// before the picks; each pick then touches one pod slot.

#include "cycle_common.cuh"

namespace {

using namespace ktt;

__global__ void select_cycle_commit_kernel(
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ alloc_cpu,
    const int32_t* __restrict__ alloc_ram, const uint8_t* __restrict__ eligible,
    const int32_t* __restrict__ qwin, const int32_t* __restrict__ qoff_bits,
    const int32_t* __restrict__ qseq, const int32_t* __restrict__ req_cpu,
    const int32_t* __restrict__ req_ram, const float* __restrict__ waited,
    const int32_t* __restrict__ phase_in, const int32_t* __restrict__ node_in,
    const float* __restrict__ qpre_t, const float* __restrict__ start_t,
    const float* __restrict__ park_t, int32_t* __restrict__ cpu_out,
    int32_t* __restrict__ ram_out, int32_t* __restrict__ phase_out,
    int32_t* __restrict__ node_out, float* __restrict__ start_out,
    float* __restrict__ park_out, float* __restrict__ stats, int N, int P,
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
    phase_out[pb + p] = phase_in[pb + p];
    node_out[pb + p] = node_in[pb + p];
    start_out[pb + p] = INFINITY;
    park_out[pb + p] = INFINITY;
  }
  depth = block_sum(depth, scratch);  // its syncs also publish the rows
  const int picks = depth < K ? depth : K;

  float cnt = 0.0f, tot = 0.0f, tsq = 0.0f, mn = INFINITY, mx = -INFINITY;
  for (int k = 0; k < picks; ++k) {
    // 1. The next pod in queue order (picks <= the eligible count, so a
    //    real pod).
    const int slot = block_select(s_win, s_off, s_seq, s_rem, P, scratch);
    const int32_t rc = req_cpu[pb + slot], rr = req_ram[pb + slot];
    // 2. Fit + score over the nodes; last-max-wins argmax.
    const Decision d = block_fit_argmax(s_cpu, s_ram, s_alive, N, rc, rr, scratch);
    // 3. Commit, in pick order, by one thread.
    if (tid == 0) {
      if (d.anyfit) {
        s_cpu[d.best] -= rc;
        s_ram[d.best] -= rr;
        phase_out[pb + slot] = kPhaseRunning;
        node_out[pb + slot] = d.best;
        start_out[pb + slot] = start_t[kb + k];
        const float q = __fadd_rn(waited[pb + slot], qpre_t[kb + k]);
        cnt = __fadd_rn(cnt, 1.0f);
        tot = __fadd_rn(tot, q);
        tsq = __fadd_rn(tsq, __fmul_rn(q, q));
        mn = fminf(mn, q);
        mx = fmaxf(mx, q);
      } else {
        phase_out[pb + slot] = kPhaseUnschedulable;
        park_out[pb + slot] = park_t[kb + k];
      }
      s_rem[slot] = 0;
    }
    __syncthreads();
  }

  for (int i = tid; i < N; i += kThreads) {
    cpu_out[nb + i] = s_cpu[i];
    ram_out[nb + i] = s_ram[i];
  }
  if (tid == 0) {
    float* s = stats + c * 5;
    s[0] = cnt;
    s[1] = tot;
    s[2] = tsq;
    s[3] = mn;
    s[4] = mx;
  }
}

}  // namespace

extern "C" int ktt_select_cycle_commit(
    const void* alive, const void* alloc_cpu, const void* alloc_ram,
    const void* eligible, const void* qwin, const void* qoff,
    const void* qseq, const void* req_cpu, const void* req_ram,
    const void* waited, const void* phase, const void* node,
    const void* qpre_t, const void* start_t, const void* park_t,
    void* cpu_out, void* ram_out, void* phase_out, void* node_out,
    void* start_out, void* park_out, void* stats, int C, int N, int P,
    int K, void* stream) {
  if (C <= 0) return 0;
  const size_t smem = sizeof(int32_t) * (2 * (size_t)N + 3 * (size_t)P) + (size_t)N + (size_t)P;
  const cudaError_t e = allow_smem(select_cycle_commit_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  select_cycle_commit_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)alive, (const int32_t*)alloc_cpu,
      (const int32_t*)alloc_ram, (const uint8_t*)eligible,
      (const int32_t*)qwin, (const int32_t*)qoff, (const int32_t*)qseq,
      (const int32_t*)req_cpu, (const int32_t*)req_ram, (const float*)waited,
      (const int32_t*)phase, (const int32_t*)node, (const float*)qpre_t,
      (const float*)start_t, (const float*)park_t, (int32_t*)cpu_out,
      (int32_t*)ram_out, (int32_t*)phase_out, (int32_t*)node_out,
      (float*)start_out, (float*)park_out, (float*)stats, N, P, K);
  return (int)cudaGetLastError();
}
