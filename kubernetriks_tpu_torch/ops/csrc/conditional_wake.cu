// The conditional move's scans (enable_unscheduled_pods_conditional_move):
// which parked pods a window's wake events move back to the active queue.
//
// Replaces no TPU kernel. The reference computes it in XLA
// (kubernetriks_tpu/batched/step.py:994 `_conditional_wake_exact`, a
// while_loop over the events around a scan over the parked pods); the
// port's plain twin loops on the host (step.wake_scan_plain), which reads
// the device back. The two stable sorts that order the operands stay
// torch.sort(stable=True) (step._wake_scan_inputs).
//
// Per cluster: the parked pods in queue order (o_valid, requests) and the
// wake events in effect-time order (s_valid, node-add or freed pod,
// budget). Each valid event, in order, walks the parked pods not moved
// yet with an int32 budget (the node's capacity, or the freed pod's
// requests), first-fit: a pod fits where both requests are within the
// budget, and then consumes it. A node-add moves the pods that do NOT fit
// (the reference's inverted sense, kept as it is); a freed pod moves the
// pods that fit. moved[c, j] is set once and stays.
//
// Bound on an H100: bytes at this size. It reads the parked pods' rows
// (9 B a slot) and the events' rows (10 B an event slot) once and writes
// P flags; the walk is ~6 integer operations a parked pod a valid event.
// Design: one thread per cluster (the walk is a serial dependence through
// the budget), its moved flags in the output row, which it alone reads
// and writes; the walk stops at the cluster's last parked pod.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void conditional_wake_kernel(const uint8_t* __restrict__ o_valid, const int32_t* __restrict__ o_cpu,
                                        const int32_t* __restrict__ o_ram, const uint8_t* __restrict__ s_valid,
                                        const uint8_t* __restrict__ s_is_node, const int32_t* __restrict__ s_cpu,
                                        const int32_t* __restrict__ s_ram, uint8_t* __restrict__ moved, int C,
                                        int P, int V) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t pb = (size_t)c * P, vb = (size_t)c * V;
  int nu = 0;
  for (int j = 0; j < P; ++j) {
    moved[pb + j] = 0;
    if (o_valid[pb + j]) nu = j + 1;
  }
  for (int e = 0; e < V; ++e) {
    if (!s_valid[vb + e]) continue;
    const bool node = s_is_node[vb + e] != 0;
    int bud_cpu = s_cpu[vb + e], bud_ram = s_ram[vb + e];
    for (int j = 0; j < nu; ++j) {
      if (!o_valid[pb + j] || moved[pb + j]) continue;
      const int rc = o_cpu[pb + j], rr = o_ram[pb + j];
      const bool fits = rc <= bud_cpu && rr <= bud_ram;
      if (fits) {
        bud_cpu -= rc;
        bud_ram -= rr;
      }
      if (node ? !fits : fits) moved[pb + j] = 1;
    }
  }
}

}  // namespace

extern "C" int ktt_conditional_wake(const void* o_valid, const void* o_cpu, const void* o_ram,
                                    const void* s_valid, const void* s_is_node, const void* s_cpu,
                                    const void* s_ram, void* moved, int C, int P, int V, void* stream) {
  if (C <= 0 || P <= 0) return 0;
  const int threads = 64;
  conditional_wake_kernel<<<(C + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)o_valid, (const int32_t*)o_cpu, (const int32_t*)o_ram, (const uint8_t*)s_valid,
      (const uint8_t*)s_is_node, (const int32_t*)s_cpu, (const int32_t*)s_ram, (uint8_t*)moved, C, P, V);
  return (int)cudaGetLastError();
}
