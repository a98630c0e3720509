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
// reserve-starved. Like the reference, the walk takes every valid row; the
// engine's rows are a prefix (the cache sort puts the valid pods first).
//
// Bound on an H100: bytes, far below one launch. Per cluster the function
// reads the quota and the K validity flags; with a valid candidate, seven
// group rows (28 Gn B) and the valid candidates' requests (8 B each); it
// writes S flags, Gn counts and one counter: ~0.5 KB at the Alibaba replay
// (C=1, Gn=1, K=64, S=400) with no valid candidate, ~0.1 ns at 3.35 TB/s
// (chip_smoke.py counts it from the run's data). The pack is a serial
// chain over the valid candidates, so its latency bounds the kernel.
//
// Design: one warp per cluster (a block of 32 threads).
//   1. One coalesced pass over the validity row, ballots compacting the
//      valid candidates in order. With none valid the outputs are written
//      0 and the warp returns: the group rows are never read.
//   2. One more round trip stages the valid candidates' requests and the
//      Gn group rows in shared memory; a warp reduction sums the CA counts.
//   3. Walk the valid list. The planned nodes are kept as a list in plan
//      order (at most one a candidate), entry p owned by lane p % 32: the
//      first fit is a ballot over the list, and the owning lane deducts.
//      Group g's row is owned by lane g % 32: a ballot picks the first
//      accepting group, another says whether any group with a reserve
//      would accept (starvation), and the owner opens the slot and
//      broadcasts it. An open on a slot already planned replaces that
//      entry, as the reference overwrites the slot's plan order.
// Every shared value is read and written by its owning lane alone, except
// the staged requests, written once before a __syncwarp. Integer
// arithmetic only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int sub_wrap(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
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
  // The per-row arrays hold KP >= K + 1 entries, a whole number of warps,
  // so a lane reads its entry of a 32-entry chunk, and the next
  // candidate's request, without a bound test.
  const int KP = (K + 32) & ~31;
  extern __shared__ int32_t smem[];
  int32_t* s_rc = smem;            // KP staged requests of the valid candidates
  int32_t* s_rr = s_rc + KP;
  int32_t* s_ppc = s_rr + KP;      // KP planned nodes in plan order: allocatable
  int32_t* s_ppr = s_ppc + KP;
  int32_t* s_pslot = s_ppr + KP;   // KP their slot, -1 once replaced
  int32_t* s_gcnt = s_pslot + KP;  // G group rows
  int32_t* s_gcur = s_gcnt + G;
  int32_t* s_gmax = s_gcur + G;
  int32_t* s_gslots = s_gmax + G;
  int32_t* s_gtc = s_gslots + G;
  int32_t* s_gtr = s_gtc + G;
  int32_t* s_gstart = s_gtr + G;
  int32_t* s_gpl = s_gstart + G;  // G opened per group
  uint8_t* s_pl = reinterpret_cast<uint8_t*>(s_gpl + G);  // S planned flags

  const size_t c = blockIdx.x;
  const size_t sb = c * (size_t)S, gb = c * (size_t)G, kb = c * (size_t)K;
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;

  // 1. The validity row, compacted in order (positions into s_rc for now).
  const int quota = max_nodes[c];
  int n_valid = 0;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const bool v = k < K && cvalid[kb + k];
    const unsigned b = __ballot_sync(kFull, v);
    if (v) s_rc[n_valid + __popc(b & below)] = k;
    n_valid += __popc(b);
  }
  if (n_valid == 0) {
    for (int s = lane; s < S; s += 32) planned_out[sb + s] = 0;
    for (int g = lane; g < G; g += 32) gpl_out[gb + g] = 0;
    if (lane == 0) starved_out[c] = 0;
    return;
  }

  // 2. The valid candidates' requests, the group rows, each on its owning
  // lane, and the CA node total, in one round trip.
  __syncwarp();
  for (int i = lane; i < n_valid; i += 32) {
    const int k = s_rc[i];
    s_rc[i] = creq_cpu[kb + k];
    s_rr[i] = creq_ram[kb + k];
  }
  int total = 0;
  for (int g = lane; g < G; g += 32) {
    const int cnt = ca_count[gb + g];
    s_gcnt[g] = cnt;
    s_gcur[g] = ca_cursor[gb + g];
    s_gmax[g] = ng_max[gb + g];
    s_gslots[g] = ng_slots[gb + g];
    s_gtc[g] = tmpl_cpu[gb + g];
    s_gtr[g] = tmpl_ram[gb + g];
    s_gstart[g] = ng_start[gb + g];
    s_gpl[g] = 0;
    total = (int)((unsigned)total + (unsigned)cnt);
  }
  for (int o = 16; o > 0; o >>= 1)
    total = (int)((unsigned)total + (unsigned)__shfl_xor_sync(kFull, total, o));
  __syncwarp();  // the staged requests are read by every lane

  // 3. The walk. The loads of a step are issued together (no
  // short-circuit), and the next candidate's request ahead of its turn.
  int n_plan = 0, starved = 0;
  int rc_next = s_rc[0], rr_next = s_rr[0];
  for (int v = 0; v < n_valid; ++v) {
    const int rc = rc_next, rr = rr_next;
    rc_next = s_rc[v + 1];
    rr_next = s_rr[v + 1];
    int first = -1;
    for (int p0 = 0; p0 < n_plan; p0 += 32) {
      const int p = p0 + lane;
      const bool fit = (p < n_plan) & (s_pslot[p] >= 0) & (rc <= s_ppc[p]) & (rr <= s_ppr[p]);
      const unsigned b = __ballot_sync(kFull, fit);
      if (b) {
        first = p0 + __ffs(b) - 1;
        break;
      }
    }
    if (first >= 0) {
      if ((first & 31) == lane) {
        s_ppc[first] = sub_wrap(s_ppc[first], rc);
        s_ppr[first] = sub_wrap(s_ppr[first], rr);
      }
      continue;
    }
    if (total >= quota) continue;
    int g_open = -1;
    bool any_reserve = false;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      bool ok = false, nc = false;
      if (g < G) {
        const int gmax = s_gmax[g];
        const bool accepts = (gmax < 0 || s_gcnt[g] + s_gpl[g] < gmax) &&
                             rc <= s_gtc[g] && rr <= s_gtr[g];
        ok = accepts && s_gcur[g] + s_gpl[g] < s_gslots[g];
        nc = accepts && s_gslots[g] > 0;
      }
      const unsigned bo = __ballot_sync(kFull, ok);
      any_reserve |= __ballot_sync(kFull, nc) != 0;
      if (g_open < 0 && bo) g_open = g0 + __ffs(bo) - 1;
    }
    if (g_open < 0) {
      if (any_reserve) ++starved;
      continue;
    }
    const int src = g_open & 31;
    int s_new = 0, tc = 0, tr = 0;
    if (lane == src) {
      s_new = s_gstart[g_open] + s_gcur[g_open] + s_gpl[g_open];
      tc = s_gtc[g_open];
      tr = s_gtr[g_open];
      s_gpl[g_open] += 1;
    }
    s_new = __shfl_sync(kFull, s_new, src);
    tc = __shfl_sync(kFull, tc, src);
    tr = __shfl_sync(kFull, tr, src);
    for (int p = lane; p < n_plan; p += 32)
      if (s_pslot[p] == s_new) s_pslot[p] = -1;
    if (s_new >= 0 && s_new < S) {
      if ((n_plan & 31) == lane) {
        s_ppc[n_plan] = tc;
        s_ppr[n_plan] = tr;
        s_pslot[n_plan] = s_new;
      }
      ++n_plan;
    }
    ++total;
  }

  for (int s = lane; s < S; s += 32) s_pl[s] = 0;
  __syncwarp();
  for (int p = lane; p < n_plan; p += 32)
    if (s_pslot[p] >= 0) s_pl[s_pslot[p]] = 1;
  __syncwarp();
  for (int s = lane; s < S; s += 32) planned_out[sb + s] = s_pl[s];
  for (int g = lane; g < G; g += 32) gpl_out[gb + g] = s_gpl[g];
  if (lane == 0) starved_out[c] = starved;
}

}  // namespace

extern "C" int ktt_ca_scale_up(
    const void* max_nodes, const void* ca_count, const void* ca_cursor,
    const void* ng_max, const void* ng_slots, const void* tmpl_cpu,
    const void* tmpl_ram, const void* ng_start, const void* cvalid,
    const void* creq_cpu, const void* creq_ram, void* planned, void* gpl,
    void* starved, int C, int S, int G, int K, void* stream) {
  if (C <= 0) return 0;
  // ca_up_smem in ops/autoscale_kernel.py reckons the same bytes.
  const size_t smem = sizeof(int32_t) * (5 * (size_t)((K + 32) & ~31) + 8 * (size_t)G) + (size_t)S;
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
