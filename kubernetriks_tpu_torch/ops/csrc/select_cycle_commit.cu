// The scheduling megakernel: queue selection, fit/score/place and the
// decision commit of one window's cycle, for every cluster in one launch.
//
// Replaces: kubernetriks_tpu/ops/scheduler_kernel.py
// `fused_select_cycle_commit` (:1139; Pallas kernel
// `_select_cycle_commit_kernel` :1010, selection `_argmin_select` :986,
// decision core `_fit_score_place` :118). Per cluster, up to K times:
//   1. pick the remaining eligible pod with the least (queue win, queue
//      offset as int32 bits, queue seq) — the active queue's order;
//   2. the scheduler profile's fit mask and score on every node, written
//      op for op as kubernetriks_tpu/batched/pipeline.py:97-285 (IEEE
//      division, no contraction but the balanced scorer's, which XLA:CPU
//      contracts too; cycle_common.cuh), and the last node of maximal
//      score (ties go to the highest slot);
//   3. if a node fits: deduct its allocatable, mark the pod RUNNING on it
//      with start offset start_t[k], and fold waited + qpre_t[k] into the
//      queue-time estimator; else park it UNSCHEDULABLE at park_t[k].
// A pick leaves the queue whatever its fit, so the K picks are the first
// min(depth, K) eligible pods in key order, and only the placements depend
// on each other.
//
// Bound on an H100: bytes. Per cluster the function must read the node
// rows (9N B), the eligible mask (P B), the queue keys of the eligible pods
// (12 B each), the requests, wait and table entries of the picked ones
// (24 B each) and the phase/node rows it copies through (8P B), and write
// two node rows (8N B), four pod rows (16P B) and 5 stats: at N=256,
// P=2048 ~56 KB per cluster, ~57 MB per launch at C=1024, ~17 us at
// 3.35 TB/s (chip_smoke.py counts it from the run's data). The placements
// are a dependent chain per cluster: one score, two warp-max steps, one
// barrier and two more warp-max steps per pick.
//
// Design: one block per cluster of cycle_threads(N) threads (128 at
// N = 256), the node rows in registers (cycle_common.cuh `NodeRegs`, at
// most two slots a thread). The queue is ordered once (cycle_common.cuh
// `order_queue`, shared with select_schedule_cycle.cu): the eligible pods
// counted and compacted, their keys bitonic-sorted in a shared buffer of
// 512 entries; a deeper queue in batches of 256 picks, each batch one pass
// of the whole block over the slots that sorts only the keys below the
// batch's current 256th least. A batch's requests
// and estimator samples are gathered into shared memory, then the picks
// run the register decision pass (one barrier each) and the owner deducts;
// the phase/node/start/park writes of the batch follow in parallel and
// thread 0 folds the estimator in pick order, the reference loop's float
// order. The copy-through of the full pod rows is vectorised and
// coalesced. Shared memory is 12 928 B whatever P and K; at N = 256 (128
// threads of at most 64 registers; chip_smoke.py prints ptxas's count) at
// least eight blocks share an SM, so 1 024 clusters run in one wave.

#include "cycle_common.cuh"

namespace {

using namespace ktt;

// phase/node copied through, start/park set to +inf (16-byte words when
// the rows allow it).
__device__ __forceinline__ void copy_through(const int32_t* phase_in, const int32_t* node_in,
                                             int32_t* phase_out, int32_t* node_out,
                                             float* start_out, float* park_out, int P) {
  const uintptr_t mis = (uintptr_t)phase_in | (uintptr_t)node_in | (uintptr_t)phase_out |
                        (uintptr_t)node_out | (uintptr_t)start_out | (uintptr_t)park_out;
  if ((P & 3) == 0 && (mis & 15) == 0) {
    const float4 inf4 = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    for (int i = threadIdx.x; i < (P >> 2); i += blockDim.x) {
      reinterpret_cast<int4*>(phase_out)[i] = reinterpret_cast<const int4*>(phase_in)[i];
      reinterpret_cast<int4*>(node_out)[i] = reinterpret_cast<const int4*>(node_in)[i];
      reinterpret_cast<float4*>(start_out)[i] = inf4;
      reinterpret_cast<float4*>(park_out)[i] = inf4;
    }
    return;
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    phase_out[p] = phase_in[p];
    node_out[p] = node_in[p];
    start_out[p] = INFINITY;
    park_out[p] = INFINITY;
  }
}

template <int SLOTS, typename Profile>
__global__ void __launch_bounds__(kMaxCycleThreads) select_cycle_commit_kernel(
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
    int K, const Profile prof) {
  __shared__ QueueOrder q;
  __shared__ int32_t s_rc[kQueueBatch], s_rr[kQueueBatch], s_best[kQueueBatch];
  __shared__ float s_q[kQueueBatch];
  __shared__ Partials part;

  const size_t c = blockIdx.x;
  const size_t nb = c * (size_t)N, pb = c * (size_t)P, kb = c * (size_t)K;
  const int tid = threadIdx.x, T = blockDim.x;

  NodeRegs<SLOTS> nodes;
  nodes.load(alive + nb, alloc_cpu + nb, alloc_ram + nb, N);
  copy_through(phase_in + pb, node_in + pb, phase_out + pb, node_out + pb, start_out + pb,
               park_out + pb, P);

  float cnt = 0.0f, tot = 0.0f, tsq = 0.0f, mn = INFINITY, mx = -INFINITY;
  int buf = 0;
  order_queue(eligible + pb, qwin + pb, qoff_bits + pb, qseq + pb, P, K, q, [&](int done, int batch) {
    // This batch's picks: requests and estimator samples to shared memory.
    for (int i = tid; i < batch; i += T) {
      const int slot = pick_slot(q, i);
      s_rc[i] = req_cpu[pb + slot];
      s_rr[i] = req_ram[pb + slot];
      s_q[i] = __fadd_rn(waited[pb + slot], qpre_t[kb + done + i]);
    }
    __syncthreads();
    for (int i = 0; i < batch; ++i) {
      const int32_t rc = s_rc[i], rr = s_rr[i];
      const Decision d = nodes.fit_argmax(N, rc, rr, part, buf, prof);
      buf ^= 1;
      if (d.anyfit) nodes.deduct(d.best, rc, rr);
      if (tid == 0) s_best[i] = d.anyfit ? d.best : -1;
    }
    __syncthreads();
    for (int i = tid; i < batch; i += T) {
      const size_t at = pb + pick_slot(q, i);
      const int best = s_best[i];
      if (best >= 0) {
        phase_out[at] = kPhaseRunning;
        node_out[at] = best;
        start_out[at] = start_t[kb + done + i];
      } else {
        phase_out[at] = kPhaseUnschedulable;
        park_out[at] = park_t[kb + done + i];
      }
    }
    if (tid == 0) {
      for (int i = 0; i < batch; ++i) {
        if (s_best[i] < 0) continue;
        const float w = s_q[i];
        cnt = __fadd_rn(cnt, 1.0f);
        tot = __fadd_rn(tot, w);
        tsq = __fadd_rn(tsq, __fmul_rn(w, w));
        mn = fminf(mn, w);
        mx = fmaxf(mx, w);
      }
    }
  });

  nodes.store(cpu_out + nb, ram_out + nb, N);
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
    void* start_out, void* park_out, void* stats, const void* terms, int C, int N,
    int P, int K, int profile_kind, int n_terms, void* stream) {
  if (C <= 0) return 0;
  const int T = cycle_threads(N);
  return dispatch_profile(profile_kind, terms, n_terms, [&](auto prof) {
    return dispatch_slots(cycle_slots(N, T), [&](auto slots) {
      select_cycle_commit_kernel<decltype(slots)::value, decltype(prof)>
          <<<C, T, 0, (cudaStream_t)stream>>>(
              (const uint8_t*)alive, (const int32_t*)alloc_cpu,
              (const int32_t*)alloc_ram, (const uint8_t*)eligible,
              (const int32_t*)qwin, (const int32_t*)qoff, (const int32_t*)qseq,
              (const int32_t*)req_cpu, (const int32_t*)req_ram, (const float*)waited,
              (const int32_t*)phase, (const int32_t*)node, (const float*)qpre_t,
              (const float*)start_t, (const float*)park_t, (int32_t*)cpu_out,
              (int32_t*)ram_out, (int32_t*)phase_out, (int32_t*)node_out,
              (float*)start_out, (float*)park_out, (float*)stats, N, P, K, prof);
      return (int)cudaGetLastError();
    });
  });
}
