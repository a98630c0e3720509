// Cluster-autoscaler scale-up bin-pack: which CA slots to open.
//
// Replaces: kubernetriks_tpu/ops/autoscale_kernel.py `fused_ca_scale_up`
// (:402; Pallas kernel `_ca_up_kernel` :271-399). Per cluster, the valid
// prefix of the name-ordered unscheduled-pod cache is bin-packed first-fit:
// a pod goes into the first already-planned node (in plan order) whose
// virtual allocatable holds it, else a node opens in the first group that
// accepts it (quota headroom, group max, template fit, reserve left), at
// the full template allocatable: the triggering pod is not packed into it
// (a reference quirk). Opens stop at the global CA node quota, which counts
// CA nodes only. An open blocked only by a consumed slot reserve counts as
// reserve-starved.
//
// Bound on an H100: bytes. Per cluster the function reads seven group rows
// (28 Gn B), the cache prefix (9 B per candidate) and writes S flags, Gn
// counts and one counter: ~0.7 KB per cluster at Gn=1, K=64, S=64, ~0.2 MB
// per launch at C=256 (chip_smoke.py counts it from the run's data). The
// pack is a serial chain over the candidates, so latency bounds it.
//
// Design: one warp per cluster (one block of 32 threads): the planned
// slots' plan order and virtual allocatables sit in shared memory; each
// candidate is one butterfly warp-min over the S slots' plan order, and
// lane 0 runs the (few) groups serially when a node has to open. Integer
// arithmetic only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 0x7fffffff;

__device__ __forceinline__ int warp_min_all(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void ca_scale_up_kernel(
    const int32_t* __restrict__ max_nodes, const int32_t* __restrict__ ca_count,
    const int32_t* __restrict__ ca_cursor, const int32_t* __restrict__ ng_max,
    const int32_t* __restrict__ ng_slots, const int32_t* __restrict__ tmpl_cpu,
    const int32_t* __restrict__ tmpl_ram, const int32_t* __restrict__ ng_start,
    const uint8_t* __restrict__ cvalid, const int32_t* __restrict__ creq_cpu,
    const int32_t* __restrict__ creq_ram, uint8_t* __restrict__ planned_out,
    int32_t* __restrict__ gpl_out, int32_t* __restrict__ starved_out,
    int S, int G, int K) {
  extern __shared__ int32_t smem[];
  int32_t* s_seq = smem;      // S plan order; kBig = not planned
  int32_t* s_pc = s_seq + S;  // S virtual allocatable cpu
  int32_t* s_pr = s_pc + S;   // S virtual allocatable ram
  int32_t* s_gpl = s_pr + S;  // G opened per group
  __shared__ int s_total, s_counter, s_starved;

  const size_t c = blockIdx.x;
  const size_t sb = c * (size_t)S, gb = c * (size_t)G, kb = c * (size_t)K;
  const int lane = threadIdx.x;

  for (int s = lane; s < S; s += 32) {
    s_seq[s] = kBig;
    s_pc[s] = 0;
    s_pr[s] = 0;
  }
  for (int g = lane; g < G; g += 32) s_gpl[g] = 0;
  if (lane == 0) {
    int total = 0;
    for (int g = 0; g < G; ++g) total += ca_count[gb + g];
    s_total = total;
    s_counter = 0;
    s_starved = 0;
  }
  __syncwarp();

  const int quota = max_nodes[c];
  for (int k = 0; k < K; ++k) {
    if (!cvalid[kb + k]) continue;  // uniform across the warp
    const int rc = creq_cpu[kb + k], rr = creq_ram[kb + k];
    int best = kBig;
    for (int s = lane; s < S; s += 32) {
      if (s_seq[s] != kBig && rc <= s_pc[s] && rr <= s_pr[s]) best = min(best, s_seq[s]);
    }
    best = warp_min_all(best);
    if (best != kBig) {
      // Plan orders are unique among planned slots: one lane deducts.
      for (int s = lane; s < S; s += 32) {
        if (s_seq[s] == best) {
          s_pc[s] -= rc;
          s_pr[s] -= rr;
        }
      }
      __syncwarp();
      continue;
    }
    if (lane == 0 && s_total < quota) {
      int first = -1;
      bool any_accepts = false;
      for (int g = 0; g < G; ++g) {
        const int gmax = ng_max[gb + g];
        const bool accepts = (gmax < 0 || ca_count[gb + g] + s_gpl[g] < gmax) &&
                             rc <= tmpl_cpu[gb + g] && rr <= tmpl_ram[gb + g];
        if (accepts && ng_slots[gb + g] > 0) any_accepts = true;
        if (first < 0 && accepts && ca_cursor[gb + g] + s_gpl[g] < ng_slots[gb + g]) first = g;
      }
      if (first >= 0) {
        const int s_new = ng_start[gb + first] + ca_cursor[gb + first] + s_gpl[first];
        if (s_new >= 0 && s_new < S) {
          s_seq[s_new] = s_counter;
          s_pc[s_new] = tmpl_cpu[gb + first];
          s_pr[s_new] = tmpl_ram[gb + first];
        }
        s_gpl[first] += 1;
        s_total += 1;
        s_counter += 1;
      } else if (any_accepts) {
        s_starved += 1;
      }
    }
    __syncwarp();
  }

  for (int s = lane; s < S; s += 32) planned_out[sb + s] = s_seq[s] != kBig;
  for (int g = lane; g < G; g += 32) gpl_out[gb + g] = s_gpl[g];
  if (lane == 0) starved_out[c] = s_starved;
}

}  // namespace

extern "C" int ktt_ca_scale_up(
    const void* max_nodes, const void* ca_count, const void* ca_cursor,
    const void* ng_max, const void* ng_slots, const void* tmpl_cpu,
    const void* tmpl_ram, const void* ng_start, const void* cvalid,
    const void* creq_cpu, const void* creq_ram, void* planned, void* gpl,
    void* starved, int C, int S, int G, int K, void* stream) {
  if (C <= 0) return 0;
  const size_t smem = sizeof(int32_t) * (3 * (size_t)S + (size_t)G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ca_scale_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ca_scale_up_kernel<<<C, 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)max_nodes, (const int32_t*)ca_count,
      (const int32_t*)ca_cursor, (const int32_t*)ng_max,
      (const int32_t*)ng_slots, (const int32_t*)tmpl_cpu,
      (const int32_t*)tmpl_ram, (const int32_t*)ng_start,
      (const uint8_t*)cvalid, (const int32_t*)creq_cpu,
      (const int32_t*)creq_ram, (uint8_t*)planned, (int32_t*)gpl,
      (int32_t*)starved, S, G, K);
  return (int)cudaGetLastError();
}
