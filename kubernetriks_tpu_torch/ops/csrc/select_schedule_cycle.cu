// The two-kernel route's first half: queue selection and the cycle, with
// the per-candidate decisions returned instead of committed.
//
// Replaces: kubernetriks_tpu/ops/scheduler_kernel.py
// `fused_select_schedule_cycle` (:336; Pallas kernel `_select_cycle_kernel`
// :239). It is the megakernel (select_cycle_commit.cu) without its commit:
// per cluster, the first min(depth, K) eligible pods in the order (queue
// win, offset bits, seq, slot) are, one after another, fitted and scored on
// every node, placed on the last node of maximal score where some node
// fits, and written to row k: cand = the slot, valid = 1, assign = fit_any
// = whether a node fits, best = that node (N - 1 when none fits). Rows
// past the cluster's picks are zero. commit_scatter.cu writes the
// decisions into the pod rows.
//
// Bound on an H100: bytes. Per cluster the function must read the node
// rows (9N B), the eligible mask (P B), the queue keys of the eligible pods
// (12 B each) and the requests of the picked ones (8 B each), and write
// two node rows (8N B) and 11 B per candidate row: at the headline (N =
// 256, P = 2 048, K = 64) ~7 KB per cluster, ~0.002 ms per launch at
// C = 1 024 (chip_smoke.py counts it from the run's data). The placements
// are a dependent chain per cluster, as in the megakernel: one score, two
// warp-max steps, one barrier and two more warp-max steps per pick.
//
// Design: the megakernel's, through the same device code
// (cycle_common.cuh): one block per cluster of cycle_threads(N) threads
// (128 at N = 256), the node rows in registers (`NodeRegs`), the queue
// ordered once, a deeper one per batch of up to 256 picks
// (`order_queue`). A batch's requests are gathered into shared memory,
// each pick is one register decision pass (one barrier) and the owner's
// deduction, and the batch's five output rows are written in parallel
// after it. Shared memory is static, ~12 KB whatever N, P and K.

#include "cycle_common.cuh"

namespace {

using namespace ktt;

template <int SLOTS, typename Profile>
__global__ void __launch_bounds__(kMaxCycleThreads) select_schedule_cycle_kernel(
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ alloc_cpu,
    const int32_t* __restrict__ alloc_ram, const uint8_t* __restrict__ eligible,
    const int32_t* __restrict__ qwin, const int32_t* __restrict__ qoff_bits,
    const int32_t* __restrict__ qseq, const int32_t* __restrict__ req_cpu,
    const int32_t* __restrict__ req_ram, int32_t* __restrict__ cand_out,
    uint8_t* __restrict__ valid_out, uint8_t* __restrict__ assign_out,
    uint8_t* __restrict__ fitany_out, int32_t* __restrict__ best_out,
    int32_t* __restrict__ cpu_out, int32_t* __restrict__ ram_out, int N, int P,
    int K, const Profile prof) {
  __shared__ QueueOrder q;
  __shared__ int32_t s_rc[kQueueBatch], s_rr[kQueueBatch], s_best[kQueueBatch];
  __shared__ uint8_t s_fit[kQueueBatch];
  __shared__ Partials part;

  const size_t c = blockIdx.x;
  const size_t nb = c * (size_t)N, pb = c * (size_t)P, kb = c * (size_t)K;
  const int tid = threadIdx.x, T = blockDim.x;

  NodeRegs<SLOTS> nodes;
  nodes.load(alive + nb, alloc_cpu + nb, alloc_ram + nb, N);

  int buf = 0;
  const int picks = order_queue(
      eligible + pb, qwin + pb, qoff_bits + pb, qseq + pb, P, K, q, [&](int done, int batch) {
        for (int i = tid; i < batch; i += T) {
          const int slot = pick_slot(q, i);
          s_rc[i] = req_cpu[pb + slot];
          s_rr[i] = req_ram[pb + slot];
        }
        __syncthreads();
        for (int i = 0; i < batch; ++i) {
          const int32_t rc = s_rc[i], rr = s_rr[i];
          const Decision d = nodes.fit_argmax(N, rc, rr, part, buf, prof);
          buf ^= 1;
          if (d.anyfit) nodes.deduct(d.best, rc, rr);
          if (tid == 0) {
            s_best[i] = d.best;
            s_fit[i] = d.anyfit ? 1 : 0;
          }
        }
        __syncthreads();
        for (int i = tid; i < batch; i += T) {
          const size_t k = kb + done + i;
          cand_out[k] = pick_slot(q, i);
          valid_out[k] = 1;
          assign_out[k] = s_fit[i];
          fitany_out[k] = s_fit[i];
          best_out[k] = s_best[i];
        }
      });

  for (int k = picks + tid; k < K; k += T) {
    cand_out[kb + k] = 0;
    valid_out[kb + k] = 0;
    assign_out[kb + k] = 0;
    fitany_out[kb + k] = 0;
    best_out[kb + k] = 0;
  }
  nodes.store(cpu_out + nb, ram_out + nb, N);
}

}  // namespace

extern "C" int ktt_select_schedule_cycle(
    const void* alive, const void* alloc_cpu, const void* alloc_ram,
    const void* eligible, const void* qwin, const void* qoff, const void* qseq,
    const void* req_cpu, const void* req_ram, void* cand_out, void* valid_out,
    void* assign_out, void* fitany_out, void* best_out, void* cpu_out,
    void* ram_out, const void* terms, int C, int N, int P, int K, int profile_kind,
    int n_terms, void* stream) {
  if (C <= 0) return 0;
  const int T = cycle_threads(N);
  return dispatch_profile(profile_kind, terms, n_terms, [&](auto prof) {
    return dispatch_slots(cycle_slots(N, T), [&](auto slots) {
      select_schedule_cycle_kernel<decltype(slots)::value, decltype(prof)>
          <<<C, T, 0, (cudaStream_t)stream>>>(
              (const uint8_t*)alive, (const int32_t*)alloc_cpu, (const int32_t*)alloc_ram,
              (const uint8_t*)eligible, (const int32_t*)qwin, (const int32_t*)qoff,
              (const int32_t*)qseq, (const int32_t*)req_cpu, (const int32_t*)req_ram,
              (int32_t*)cand_out, (uint8_t*)valid_out, (uint8_t*)assign_out,
              (uint8_t*)fitany_out, (int32_t*)best_out, (int32_t*)cpu_out,
              (int32_t*)ram_out, N, P, K, prof);
      return (int)cudaGetLastError();
    });
  });
}
