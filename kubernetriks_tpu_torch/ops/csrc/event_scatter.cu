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
// accumulators (5N + 12P B) and writes them again: at the headline (C=1024,
// N=256, P=2048) about 26 KB in and 26 KB out per cluster, ~53 MB per
// launch, ~16 us at 3.35 TB/s; at the Alibaba replay (C=1, N=1 713,
// P=107 136) ~2.6 MB, ~0.8 us (chip_smoke.py counts both from the run's
// data). Nothing is computed worth counting.
//
// Design: a grid of (cluster, 1 024-slot tile) blocks, so a lone large
// cluster (the replay's 107 k pod rows) spreads over 105 blocks instead of
// one. Each thread owns 4 consecutive slots of every accumulator (node and
// pod rows alike; rows past N or P are simply not there) and loads them
// into registers with one 16-byte load a row (4 bytes for the bool row),
// so a warp's load covers 512 contiguous bytes; element loops take over
// where a row start is not aligned or the rows end. Then the events, 32 at
// a time in chunk order: each warp stages them in its own slice of shared
// memory, and each thread applies, in order and without branches, the
// ones whose slot it owns, with the min/max/set combiners; then it stores
// its slots with vector stores. Every slot belongs to one thread, so each
// slot sees its events in chunk order with no atomics, no block barrier
// and no ordering across blocks, and no accumulator makes a round trip
// through device memory between the copy and the events. A chunk's events
// mostly sit on consecutive slots, so on one warp: a walk of the warp's
// events by all its lanes, one event at a time through divergent
// branches, took the replay's busiest chunk (32 node creations on slots
// 0-31) to 0.0104 ms on an H100, against 0.0044 for the owner's own
// ordered, branch-free walk, whose cost is the most events one thread
// owns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCreateNode = 1;
constexpr int kRemoveNode = 2;
constexpr int kCreatePod = 3;
constexpr int kRemovePod = 4;
constexpr int kThreads = 256;
constexpr int kRows = 4;                 // consecutive slots a thread holds: 16 B of a 4-byte row
constexpr int kTile = kThreads * kRows;  // slots a block (EVENT_TILE in the wrapper)

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The kRows slots from r of a 4-byte accumulator row (n slots in range).
__device__ __forceinline__ void load_words(const uint32_t* row, int n, int r, uint32_t (&v)[kRows]) {
  const uint32_t* p = row + r;
  if (r + kRows <= n && aligned(p, 16)) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) v[j] = r + j < n ? p[j] : 0u;
  }
}

__device__ __forceinline__ void store_words(uint32_t* row, int n, int r, const uint32_t (&v)[kRows]) {
  uint32_t* p = row + r;
  if (r + kRows <= n && aligned(p, 16)) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (r + j < n) p[j] = v[j];
  }
}

// The same for the bool row, its kRows bytes packed in one word.
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* row, int n, int r) {
  const uint8_t* p = row + r;
  if (r + kRows <= n && aligned(p, 4)) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (r + j < n) v |= (uint32_t)p[j] << (8 * j);
  return v;
}

__device__ __forceinline__ void store_bytes(uint8_t* row, int n, int r, uint32_t v) {
  uint8_t* p = row + r;
  if (r + kRows <= n && aligned(p, 4)) {
    *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (r + j < n) p[j] = (uint8_t)((v >> (8 * j)) & 0xffu);
}

__device__ __forceinline__ uint32_t min_bits(uint32_t cur, float rel) {
  const float c = __uint_as_float(cur);
  return __float_as_uint(rel < c ? rel : c);
}

__global__ void __launch_bounds__(kThreads) event_scatter_kernel(
    const int32_t* __restrict__ ev_kind, const int32_t* __restrict__ ev_slot,
    const float* __restrict__ ev_rel, const int32_t* __restrict__ ev_seq,
    const uint8_t* __restrict__ ev_valid,
    const uint8_t* __restrict__ created_in, const float* __restrict__ nrm_in,
    const float* __restrict__ pcr_in, const int32_t* __restrict__ pseq_in,
    const float* __restrict__ prm_in,
    uint8_t* __restrict__ created_out, float* __restrict__ nrm_out,
    float* __restrict__ pcr_out, int32_t* __restrict__ pseq_out,
    float* __restrict__ prm_out, int N, int P, int E) {
  __shared__ int4 s_ev[kThreads / 32][32];  // per warp: kind (0: not valid), slot, rel bits, seq

  const size_t c = blockIdx.x;
  const size_t nb = c * (size_t)N, pb = c * (size_t)P, eb = c * (size_t)E;
  const int t0 = blockIdx.y * kTile;
  const int r = t0 + kRows * (int)threadIdx.x;  // this thread's first slot
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  uint32_t cr = load_bytes(created_in + nb, N, r);
  uint32_t nrm[kRows], pcr[kRows], pseq[kRows], prm[kRows];
  load_words(reinterpret_cast<const uint32_t*>(nrm_in + nb), N, r, nrm);
  load_words(reinterpret_cast<const uint32_t*>(pcr_in + pb), P, r, pcr);
  load_words(reinterpret_cast<const uint32_t*>(pseq_in + pb), P, r, pseq);
  load_words(reinterpret_cast<const uint32_t*>(prm_in + pb), P, r, prm);

  // Events, 32 at a time in chunk order, a lane an event: a ballot picks
  // the warp's, a shuffle of each one's owner gives each thread its own,
  // which it applies in order from the warp's slice of shared memory.
  int4* my_ev = s_ev[warp];
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int k = e0 + lane;
    int4 ev = make_int4(0, 0, 0, 0);
    if (k < E) {
      ev = make_int4(ev_valid[eb + k] ? ev_kind[eb + k] : 0, ev_slot[eb + k],
                     __float_as_int(ev_rel[eb + k]), ev_seq[eb + k]);
    }
    my_ev[lane] = ev;
    const unsigned d = (unsigned)ev.y - (unsigned)t0;  // slot in this tile
    const unsigned owner = d / kRows;
    const bool in_warp = ev.x != 0 && d < (unsigned)kTile && owner / 32 == (unsigned)warp;
    const unsigned hits = __ballot_sync(0xffffffffu, in_warp);
    __syncwarp();
    unsigned mine = 0;
    for (unsigned h = hits; h; h &= h - 1) {
      const int l = __ffs(h) - 1;
      if (__shfl_sync(0xffffffffu, owner, l) == threadIdx.x) mine |= 1u << l;
    }
    for (; mine; mine &= mine - 1) {
      const int4 e = my_ev[__ffs(mine) - 1];
      const unsigned jd = (unsigned)e.y - (unsigned)r;  // its register
      const bool cn = e.x == kCreateNode && e.y < N, rn = e.x == kRemoveNode && e.y < N;
      const bool cp = e.x == kCreatePod && e.y < P, rp = e.x == kRemovePod && e.y < P;
      const float rel = __int_as_float(e.z);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const bool at = jd == (unsigned)j;
        cr |= at && cn ? 1u << (8 * j) : 0u;
        nrm[j] = at && rn ? min_bits(nrm[j], rel) : nrm[j];
        pcr[j] = at && cp ? min_bits(pcr[j], rel) : pcr[j];
        pseq[j] = at && cp ? (uint32_t)max((int32_t)pseq[j], e.w) : pseq[j];
        prm[j] = at && rp ? min_bits(prm[j], rel) : prm[j];
      }
    }
    __syncwarp();
  }

  store_bytes(created_out + nb, N, r, cr);
  store_words(reinterpret_cast<uint32_t*>(nrm_out + nb), N, r, nrm);
  store_words(reinterpret_cast<uint32_t*>(pcr_out + pb), P, r, pcr);
  store_words(reinterpret_cast<uint32_t*>(pseq_out + pb), P, r, pseq);
  store_words(reinterpret_cast<uint32_t*>(prm_out + pb), P, r, prm);
}

}  // namespace

extern "C" int ktt_event_scatter(
    const void* ev_kind, const void* ev_slot, const void* ev_rel,
    const void* ev_seq, const void* ev_valid, const void* created_in,
    const void* nrm_in, const void* pcr_in, const void* pseq_in,
    const void* prm_in, void* created_out, void* nrm_out, void* pcr_out,
    void* pseq_out, void* prm_out, int C, int N, int P, int E, void* stream) {
  const int rows = N > P ? N : P;
  if (C <= 0 || rows <= 0) return 0;
  const int T = (rows + kTile - 1) / kTile;
  if (T > 65535) return (int)cudaErrorInvalidConfiguration;
  event_scatter_kernel<<<dim3(C, T), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ev_kind, (const int32_t*)ev_slot, (const float*)ev_rel,
      (const int32_t*)ev_seq, (const uint8_t*)ev_valid,
      (const uint8_t*)created_in, (const float*)nrm_in, (const float*)pcr_in,
      (const int32_t*)pseq_in, (const float*)prm_in, (uint8_t*)created_out,
      (float*)nrm_out, (float*)pcr_out, (int32_t*)pseq_out, (float*)prm_out,
      N, P, E);
  return (int)cudaGetLastError();
}
