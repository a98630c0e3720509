// Freed resources back to their nodes, plus the pod-duration estimator
// fold over the finished subset.
//
// Replaces: kubernetriks_tpu/ops/scheduler_kernel.py `fused_free_resources`
// (:513; Pallas kernel `_free_kernel` :435). Per cluster: every freed pod's
// cpu/ram request is added back to its node's allocatable (exact integer
// adds, so the order does not matter), and the count/sum/sum of squares/
// min/max of `value` over the finished pods is folded in ascending slot
// order, the order of the reference kernel's loop.
//
// Bound on an H100: bytes. Per cluster the function must read the freed
// mask (P B) and, for the freed pods only, their finished flag, node and
// requests (13 B) and, for the finished ones, their value (4 B); it reads
// and writes the two allocatable rows (16N B) and writes 5 stats. A window
// frees a few dozen pods per cluster, so at N=256, P=2048 that is ~6.6 KB
// per cluster, ~6.8 MB per launch at C=1024, ~2 us at 3.35 TB/s
// (chip_smoke.py counts it from the run's data). The kernel scans all P
// masks and sits at a few times that: the block's fixed cost dominates.
//
// Design: one block per cluster; the two allocatable rows live in shared
// memory, where the freed pods' requests land with integer atomicAdd
// (commutative and exact; no float atomics). For the float fold the block
// compacts the finished pods' values chunk by chunk with warp ballots into
// shared memory, in slot order, and one thread folds them in that order —
// a handful per window, instead of a serial walk over all P slots.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void free_resources_kernel(
    const uint8_t* __restrict__ freed, const int32_t* __restrict__ node,
    const int32_t* __restrict__ req_cpu, const int32_t* __restrict__ req_ram,
    const uint8_t* __restrict__ finishes, const float* __restrict__ value,
    const int32_t* __restrict__ acpu_in, const int32_t* __restrict__ aram_in,
    int32_t* __restrict__ acpu_out, int32_t* __restrict__ aram_out,
    float* __restrict__ stats, int N, int P) {
  extern __shared__ int32_t smem[];
  int32_t* s_cpu = smem;
  int32_t* s_ram = smem + N;
  float* s_vals = reinterpret_cast<float*>(smem + 2 * N);  // kThreads
  __shared__ int s_off[kWarps];
  __shared__ int s_total;

  const size_t c = blockIdx.x;
  const size_t nb = c * (size_t)N, pb = c * (size_t)P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < N; i += kThreads) {
    s_cpu[i] = acpu_in[nb + i];
    s_ram[i] = aram_in[nb + i];
  }
  __syncthreads();
  for (int p = tid; p < P; p += kThreads) {
    if (freed[pb + p]) {
      const int nd = node[pb + p];
      if (nd >= 0 && nd < N) {
        atomicAdd(&s_cpu[nd], req_cpu[pb + p]);
        atomicAdd(&s_ram[nd], req_ram[pb + p]);
      }
    }
  }

  float cnt = 0.0f, tot = 0.0f, tsq = 0.0f, mn = INFINITY, mx = -INFINITY;
  for (int base = 0; base < P; base += kThreads) {
    const int p = base + tid;
    const bool f = p < P && freed[pb + p] && finishes[pb + p];
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s_off[warp] = __popc(m);
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int n = s_off[w];
        s_off[w] = run;
        run += n;
      }
      s_total = run;
    }
    __syncthreads();
    if (f) s_vals[s_off[warp] + __popc(m & ((1u << lane) - 1u))] = value[pb + p];
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < s_total; ++i) {
        const float v = s_vals[i];
        cnt = __fadd_rn(cnt, 1.0f);
        tot = __fadd_rn(tot, v);
        tsq = __fadd_rn(tsq, __fmul_rn(v, v));
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < N; i += kThreads) {
    acpu_out[nb + i] = s_cpu[i];
    aram_out[nb + i] = s_ram[i];
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

extern "C" int ktt_free_resources(
    const void* freed, const void* node, const void* req_cpu,
    const void* req_ram, const void* finishes, const void* value,
    const void* acpu_in, const void* aram_in, void* acpu_out, void* aram_out,
    void* stats, int C, int N, int P, void* stream) {
  if (C <= 0) return 0;
  const size_t smem = sizeof(int32_t) * 2 * (size_t)N + sizeof(float) * kThreads;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        free_resources_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  free_resources_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)freed, (const int32_t*)node, (const int32_t*)req_cpu,
      (const int32_t*)req_ram, (const uint8_t*)finishes, (const float*)value,
      (const int32_t*)acpu_in, (const int32_t*)aram_in, (int32_t*)acpu_out,
      (int32_t*)aram_out, (float*)stats, N, P);
  return (int)cudaGetLastError();
}
