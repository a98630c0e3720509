// Trace-event scatter for one chunk of due slab events.
//
// Replaces: kubernetriks_tpu/ops/scheduler_kernel.py `fused_event_scatter`
// (:671; Pallas kernel `_event_kernel` :596). Per cluster, the chunk's
// valid events update five per-slot accumulators: node created (set), node
// removal time (min), pod create time (min), pod create seq (max) and pod
// removal time (min). Slots outside [0, N) / [0, P) drop, as the
// reference's one-hot rows and mode="drop" scatters do.
//
// Bound on an H100: bytes. Per cluster the function reads the chunk's
// valid mask (E B) and its valid events (16 B each), reads the five
// accumulators (5N + 12P B) and writes them again: at N=256, P=2048 about
// 26 KB in and 26 KB out per cluster, ~53 MB per launch at C=1024, ~16 us
// at 3.35 TB/s (chip_smoke.py counts it from the run's data). Nothing is
// computed worth counting.
//
// Design: one block per cluster. The block copies the accumulators to the
// outputs with coalesced strided loops, then one thread walks the chunk in
// event order and applies the min/max/set combiners (E <= 32, so the
// serial walk is short; the copy is the cost). No float atomics; the
// combiners are order-free, and the walk keeps the reference's order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCreateNode = 1;
constexpr int kRemoveNode = 2;
constexpr int kCreatePod = 3;
constexpr int kRemovePod = 4;
constexpr int kThreads = 256;

__global__ void event_scatter_kernel(
    const int32_t* __restrict__ ev_kind, const int32_t* __restrict__ ev_slot,
    const float* __restrict__ ev_rel, const int32_t* __restrict__ ev_seq,
    const uint8_t* __restrict__ ev_valid,
    const uint8_t* __restrict__ created_in, const float* __restrict__ nrm_in,
    const float* __restrict__ pcr_in, const int32_t* __restrict__ pseq_in,
    const float* __restrict__ prm_in,
    uint8_t* __restrict__ created_out, float* __restrict__ nrm_out,
    float* __restrict__ pcr_out, int32_t* __restrict__ pseq_out,
    float* __restrict__ prm_out, int N, int P, int E) {
  const size_t c = blockIdx.x;
  const size_t nb = c * (size_t)N, pb = c * (size_t)P, eb = c * (size_t)E;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    created_out[nb + i] = created_in[nb + i];
    nrm_out[nb + i] = nrm_in[nb + i];
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    pcr_out[pb + i] = pcr_in[pb + i];
    pseq_out[pb + i] = pseq_in[pb + i];
    prm_out[pb + i] = prm_in[pb + i];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int k = 0; k < E; ++k) {
    if (!ev_valid[eb + k]) continue;
    const int kind = ev_kind[eb + k];
    const int slot = ev_slot[eb + k];
    const float rel = ev_rel[eb + k];
    if (kind == kCreateNode || kind == kRemoveNode) {
      if (slot < 0 || slot >= N) continue;
      if (kind == kCreateNode) {
        created_out[nb + slot] = 1;
      } else {
        const float cur = nrm_out[nb + slot];
        nrm_out[nb + slot] = rel < cur ? rel : cur;
      }
    } else if (kind == kCreatePod || kind == kRemovePod) {
      if (slot < 0 || slot >= P) continue;
      if (kind == kCreatePod) {
        const float cur = pcr_out[pb + slot];
        pcr_out[pb + slot] = rel < cur ? rel : cur;
        const int32_t seq = ev_seq[eb + k];
        const int32_t cs = pseq_out[pb + slot];
        pseq_out[pb + slot] = seq > cs ? seq : cs;
      } else {
        const float cur = prm_out[pb + slot];
        prm_out[pb + slot] = rel < cur ? rel : cur;
      }
    }
  }
}

}  // namespace

extern "C" int ktt_event_scatter(
    const void* ev_kind, const void* ev_slot, const void* ev_rel,
    const void* ev_seq, const void* ev_valid, const void* created_in,
    const void* nrm_in, const void* pcr_in, const void* pseq_in,
    const void* prm_in, void* created_out, void* nrm_out, void* pcr_out,
    void* pseq_out, void* prm_out, int C, int N, int P, int E, void* stream) {
  if (C <= 0) return 0;
  event_scatter_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ev_kind, (const int32_t*)ev_slot, (const float*)ev_rel,
      (const int32_t*)ev_seq, (const uint8_t*)ev_valid,
      (const uint8_t*)created_in, (const float*)nrm_in, (const float*)pcr_in,
      (const int32_t*)pseq_in, (const float*)prm_in, (uint8_t*)created_out,
      (float*)nrm_out, (float*)pcr_out, (int32_t*)pseq_out, (float*)prm_out,
      N, P, E);
  return (int)cudaGetLastError();
}
