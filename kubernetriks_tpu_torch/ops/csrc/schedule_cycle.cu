// The candidate cycle of the sorted route: K pre-sorted candidates per
// cluster placed one after another on its nodes.
//
// Replaces: kubernetriks_tpu/ops/scheduler_kernel.py `fused_schedule_cycle`
// (:903; Pallas kernel `_cycle_kernel` :152, decision core
// `_fit_score_place` :118). The caller sorts the queue and gathers the top
// K (step.prepare_cycle), so a cluster's valid rows are a prefix. Per
// cluster, for each row k below its last valid row + 1 (capped at K):
//   the profile's fit mask and score on every node, the last node
//   of maximal score (ties go to the highest slot; with no fit, the last
//   node), and, where the row is valid and some node fits, the request
//   deducted from that node. assign = valid & fit, fit_any and best are
//   written for every such row; rows at or past the bound stay zero.
//
// Bound on an H100: at the trace-replay shape (C = 1, N = 1 713 node slots,
// K = 256) the function must read the node rows (9N B) and the candidates
// up to the last valid one (9 B each), and write two node rows (8N B) and
// 6 B per candidate row: ~30 KB, ~0.01 us at 3.35 TB/s. What bounds it is
// latency: each candidate depends on the deduction of the one before, and
// at C = 1 one block runs on one of the 132 SMs. The floor of that chain is
// one score, two warp-max steps, one barrier and two more warp-max steps
// per candidate.
//
// Design: one block per cluster of cycle_threads(N) threads (864 at
// N = 1 713), each holding at most two node slots in registers
// (cycle_common.cuh `NodeRegs`); the candidates' valid flags and requests
// are staged in shared memory a tile of kTile rows at a time, so no global
// load sits in the per-candidate chain. Per candidate: the register
// decision pass (one barrier), the owner of the chosen node deducts in its
// registers, thread 0 records the row in shared memory; each tile's rows
// are written out once, coalesced. The loop stops at the cluster's own last
// valid row, the early exit of the Pallas kernel.

#include "cycle_common.cuh"

namespace {

using namespace ktt;

constexpr int kTile = 512;

template <int SLOTS, typename Profile>
__global__ void __launch_bounds__(kMaxCycleThreads) schedule_cycle_kernel(
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ alloc_cpu,
    const int32_t* __restrict__ alloc_ram, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ req_cpu, const int32_t* __restrict__ req_ram,
    uint8_t* __restrict__ assign_out, uint8_t* __restrict__ fitany_out,
    int32_t* __restrict__ best_out, int32_t* __restrict__ cpu_out,
    int32_t* __restrict__ ram_out, int N, int K, const Profile prof) {
  __shared__ int32_t s_rc[kTile], s_rr[kTile], s_best[kTile];
  __shared__ uint8_t s_valid[kTile], s_assign[kTile], s_fit[kTile];
  __shared__ Partials part;
  __shared__ int s_live;

  const size_t c = blockIdx.x;
  const size_t nb = c * (size_t)N, kb = c * (size_t)K;
  const int tid = threadIdx.x, T = blockDim.x;

  NodeRegs<SLOTS> nodes;
  nodes.load(alive + nb, alloc_cpu + nb, alloc_ram + nb, N);
  // The bound: last valid row + 1.
  if (tid == 0) s_live = 0;
  __syncthreads();
  int live = 0;
  for (int k = tid; k < K; k += T)
    if (valid[kb + k]) live = k + 1;
  live = __reduce_max_sync(0xffffffffu, live);
  if ((tid & 31) == 0 && live) atomicMax(&s_live, live);
  __syncthreads();
  const int bound = s_live;
  for (int k = bound + tid; k < K; k += T) {
    assign_out[kb + k] = 0;
    fitany_out[kb + k] = 0;
    best_out[kb + k] = 0;
  }

  int buf = 0;
  for (int t0 = 0; t0 < bound; t0 += kTile) {
    const int n = bound - t0 < kTile ? bound - t0 : kTile;
    for (int i = tid; i < n; i += T) {
      s_valid[i] = valid[kb + t0 + i];
      s_rc[i] = req_cpu[kb + t0 + i];
      s_rr[i] = req_ram[kb + t0 + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const int32_t rc = s_rc[i], rr = s_rr[i];
      const Decision d = nodes.fit_argmax(N, rc, rr, part, buf, prof);
      buf ^= 1;
      const bool assign = s_valid[i] && d.anyfit;
      if (assign) nodes.deduct(d.best, rc, rr);
      if (tid == 0) {
        s_assign[i] = assign ? 1 : 0;
        s_fit[i] = d.anyfit ? 1 : 0;
        s_best[i] = d.best;
      }
    }
    __syncthreads();
    for (int i = tid; i < n; i += T) {
      assign_out[kb + t0 + i] = s_assign[i];
      fitany_out[kb + t0 + i] = s_fit[i];
      best_out[kb + t0 + i] = s_best[i];
    }
  }
  nodes.store(cpu_out + nb, ram_out + nb, N);
}

}  // namespace

extern "C" int ktt_schedule_cycle(const void* alive, const void* alloc_cpu,
                                  const void* alloc_ram, const void* valid,
                                  const void* req_cpu, const void* req_ram,
                                  void* assign_out, void* fitany_out, void* best_out,
                                  void* cpu_out, void* ram_out, const void* terms, int C,
                                  int N, int K, int profile_kind, int n_terms, void* stream) {
  if (C <= 0) return 0;
  const int T = cycle_threads(N);
  return dispatch_profile(profile_kind, terms, n_terms, [&](auto prof) {
    return dispatch_slots(cycle_slots(N, T), [&](auto slots) {
      schedule_cycle_kernel<decltype(slots)::value, decltype(prof)>
          <<<C, T, 0, (cudaStream_t)stream>>>(
              (const uint8_t*)alive, (const int32_t*)alloc_cpu, (const int32_t*)alloc_ram,
              (const uint8_t*)valid, (const int32_t*)req_cpu, (const int32_t*)req_ram,
              (uint8_t*)assign_out, (uint8_t*)fitany_out, (int32_t*)best_out,
              (int32_t*)cpu_out, (int32_t*)ram_out, N, K, prof);
      return (int)cudaGetLastError();
    });
  });
}
