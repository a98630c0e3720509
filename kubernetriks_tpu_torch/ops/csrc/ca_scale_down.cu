// Cluster-autoscaler scale-down walk: which CA candidate nodes can go.
//
// Replaces: kubernetriks_tpu/ops/autoscale_kernel.py `fused_ca_scale_down`
// (:177; Pallas kernel `_ca_down_kernel` :59-165). Per cluster, walk the CA
// candidates in node-name order. A candidate that is alive, not already
// pending removal, below the utilization threshold (float32: (cap - valloc)
// over max(cap, 1), each side cast to float) and runs at most K pods tries
// to first-fit each of its pods onto another alive node, in node-name order
// (lowest slot on an equal rank), deducting the pod's requests from the
// virtual allocatable. If every pod fits the candidate is removed and the
// deductions stay for the later candidates; otherwise they are rolled back.
//
// Bound on an H100: bytes. Per cluster the function reads seven node rows
// (alive, not-pending, two capacities, two allocatables, name rank: ~22N B),
// the candidate rows (9S B) and, for the candidates it attempts, their pod
// tables (9K B each), and writes S flags: ~3 KB per cluster at N=96, S=64,
// K=8, ~0.8 MB per launch at C=256, well under a microsecond at 3.35 TB/s
// (chip_smoke.py counts it from the run's data). The walk is a serial chain
// of block reductions (one per pod re-placement), so the kernel is bound by
// that latency, not by either roof.
//
// Design: one block per cluster (clusters are independent). The two
// working allocatable rows, the name ranks and the alive mask sit in shared
// memory (~1.2 KB at N=96). Every per-candidate decision reads values all
// threads see alike, so the block stays converged; each re-placement is a
// block argmin over the packed (name rank, node slot) key, and thread 0
// applies it and records it for a rollback. Integer arithmetic throughout
// except the threshold divide (__fdiv_rn; built with --fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_down_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__global__ void ca_scale_down_kernel(
    const uint8_t* __restrict__ branch, const float* __restrict__ thresh,
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ not_pending,
    const int32_t* __restrict__ cap_cpu, const int32_t* __restrict__ cap_ram,
    const int32_t* __restrict__ vcpu, const int32_t* __restrict__ vram,
    const int32_t* __restrict__ name_rank, const int32_t* __restrict__ slot_perm,
    const uint8_t* __restrict__ cand_alive, const int32_t* __restrict__ cnt,
    const int32_t* __restrict__ pr_cpu, const int32_t* __restrict__ pr_ram,
    const uint8_t* __restrict__ pv0, uint8_t* __restrict__ removed,
    int N, int S, int K) {
  extern __shared__ int32_t smem[];
  int32_t* s_vc = smem;           // N working allocatable cpu
  int32_t* s_vr = s_vc + N;       // N working allocatable ram
  int32_t* s_rank = s_vr + N;     // N node-name ranks
  int32_t* s_pt = s_rank + N;     // K placed targets of this candidate
  int32_t* s_pc = s_pt + K;       // K their cpu requests
  int32_t* s_pr = s_pc + K;       // K their ram requests
  uint8_t* s_alive = reinterpret_cast<uint8_t*>(s_pr + K);  // N
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ int s_target;

  const size_t c = blockIdx.x;
  const size_t nb = c * (size_t)N, sb = c * (size_t)S, kb = c * (size_t)S * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int n = tid; n < N; n += kThreads) {
    s_vc[n] = vcpu[nb + n];
    s_vr[n] = vram[nb + n];
    s_rank[n] = name_rank[nb + n];
    s_alive[n] = alive[nb + n];
  }
  for (int s = tid; s < S; s += kThreads) removed[sb + s] = 0;
  __syncthreads();

  const bool br = branch[c] != 0;
  const float th = thresh[c];
  for (int s = 0; s < S; ++s) {
    // Every test below reads global or shared values that all threads see
    // alike, so the whole block takes the same path.
    if (!br || !cand_alive[sb + s]) continue;
    const int slot = slot_perm[sb + s];
    if (slot < 0 || slot >= N || !not_pending[nb + slot]) continue;
    const int cc = cap_cpu[nb + slot], cr = cap_ram[nb + slot];
    const float used_c = (float)(cc - s_vc[slot]);
    const float used_r = (float)(cr - s_vr[slot]);
    const float util = fmaxf(__fdiv_rn(used_c, (float)max(cc, 1)),
                             __fdiv_rn(used_r, (float)max(cr, 1)));
    if (!(util < th) || cnt[sb + s] > K) continue;

    bool ok = true;
    int n_placed = 0;
    for (int k = 0; k < K && ok; ++k) {
      const size_t j = kb + (size_t)s * K + k;
      if (!pv0[j]) continue;
      const int rc = pr_cpu[j], rr = pr_ram[j];
      unsigned long long best = kNone;
      for (int n = tid; n < N; n += kThreads) {
        if (s_alive[n] && n != slot && rc <= s_vc[n] && rr <= s_vr[n]) {
          const unsigned long long key =
              ((unsigned long long)(uint32_t)s_rank[n] << 32) | (uint32_t)n;
          best = key < best ? key : best;
        }
      }
      best = warp_min(best);
      if (lane == 0) s_warp[warp] = best;
      __syncthreads();
      if (tid == 0) {
        unsigned long long b = s_warp[0];
        for (int w = 1; w < kWarps; ++w) b = s_warp[w] < b ? s_warp[w] : b;
        if (b == kNone) {
          s_target = -1;
        } else {
          const int t = (int)(b & 0xffffffffull);
          s_vc[t] -= rc;
          s_vr[t] -= rr;
          s_pt[n_placed] = t;
          s_pc[n_placed] = rc;
          s_pr[n_placed] = rr;
          s_target = t;
        }
      }
      __syncthreads();
      if (s_target < 0) {
        ok = false;
      } else {
        ++n_placed;
      }
      __syncthreads();  // s_target and s_warp are rewritten next round
    }
    if (tid == 0) {
      if (ok) {
        removed[sb + s] = 1;
      } else {
        for (int i = 0; i < n_placed; ++i) {
          s_vc[s_pt[i]] += s_pc[i];
          s_vr[s_pt[i]] += s_pr[i];
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int ktt_ca_scale_down(
    const void* branch, const void* thresh, const void* alive,
    const void* not_pending, const void* cap_cpu, const void* cap_ram,
    const void* vcpu, const void* vram, const void* name_rank,
    const void* slot_perm, const void* cand_alive, const void* cnt,
    const void* pr_cpu, const void* pr_ram, const void* pv0, void* removed,
    int C, int N, int S, int K, void* stream) {
  if (C <= 0) return 0;
  const size_t smem = sizeof(int32_t) * (3 * (size_t)N + 3 * (size_t)K) + (size_t)N;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ca_scale_down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ca_scale_down_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)branch, (const float*)thresh, (const uint8_t*)alive,
      (const uint8_t*)not_pending, (const int32_t*)cap_cpu,
      (const int32_t*)cap_ram, (const int32_t*)vcpu, (const int32_t*)vram,
      (const int32_t*)name_rank, (const int32_t*)slot_perm,
      (const uint8_t*)cand_alive, (const int32_t*)cnt, (const int32_t*)pr_cpu,
      (const int32_t*)pr_ram, (const uint8_t*)pv0, (uint8_t*)removed, N, S, K);
  return (int)cudaGetLastError();
}
