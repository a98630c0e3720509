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
// frees a few dozen pods per cluster: at the headline (C=1024, N=256,
// P=2048) ~6.8 MB per launch, ~2 us at 3.35 TB/s; at the Alibaba replay
// (C=1, N=1 713, P=107 136) ~0.13 MB, ~0.04 us, so there the bound is the
// launch itself (chip_smoke.py counts both from the run's data).
//
// Design: a grid of (cluster, pod-row tile) blocks: one block of 128
// threads (2 048 rows) where the cluster fits, else tiles of 256 threads
// and 4 096 rows, so a lone large cluster (the replay's 107 k rows)
// spreads over 27 SMs instead of one. Each thread takes 16 consecutive
// rows: one 16-byte load of their freed flags and one of their finished
// flags (byte loops where the row start is not 16-aligned or the tile
// ends). The finished rows' values are compacted into shared memory in
// slot order by one block-wide exclusive scan of the threads' counts, so
// a block makes two dependent memory round trips (flags, then the freed
// rows' node, requests and values), and loops over many rows load a batch
// before they store.
//   - One tile a cluster (the headline): the two allocatable rows sit in
//     shared memory, the freed requests land there with integer atomicAdd
//     (exact; no float atomics), and thread 0 folds the compacted values.
//   - Several tiles (or node rows too large for shared memory): the freed
//     requests go straight to a per-cluster integer delta in a scratch
//     buffer (atomicAdd, exact), each tile stores its compacted values and
//     count in a scratch area, fences, and takes a ticket on a per-cluster
//     counter. The block that takes the last ticket writes alloc_out =
//     alloc_in + delta, gathers the tiles' values in tile (so slot) order
//     into shared memory and folds them on thread 0, and zeroes the delta
//     and the ticket, so the scratch is zero again for the next launch on
//     the stream (CUDA-graph replays included). The wrapper owns the
//     scratch, one per device, stream and shape, allocated zeroed once.
// One launch per call, no memset: the float fold keeps the serial slot
// order, the one thing that does not spread.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// A cluster of at most kSmallTile pod rows is one block of 128 threads;
// larger ones take tiles of 256 threads (FREE_TILE_SMALL and FREE_TILE in
// the wrapper). Measured on the H100 at the two shapes on the main path:
// 128 threads win at the headline (half of a 256-thread block's threads
// would hold no row), 256 at the replay (the last block's node rows).
constexpr int kRows = 16;           // pod rows a thread: one 16-byte mask load
constexpr int kSmallTile = 128 * kRows;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kBatch = 4;           // rows a thread loads before it stores

// Bit j set where byte j of the kRows at p (the first n of them in range)
// is nonzero.
__device__ __forceinline__ unsigned flags16(const uint8_t* p, int n) {
  unsigned m = 0;
  if (n >= kRows && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if ((w[j >> 2] >> (8 * (j & 3))) & 0xffu) m |= 1u << j;
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (j < n && p[j]) m |= 1u << j;
  }
  return m;
}

// Exclusive prefix of x over the block's threads in thread order; *total
// gets the block's sum. Every thread of the block calls it.
template <int kThreads>
__device__ __forceinline__ int block_scan(int x, int* s_warp, int* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = s_warp[w];
    if (w < warp) before += v;
    sum += v;
  }
  __syncthreads();
  *total = sum;
  return before + inc - x;
}

struct Stats {
  float cnt = 0.0f, tot = 0.0f, tsq = 0.0f, mn = INFINITY, mx = -INFINITY;

  __device__ void fold(const float* v, int n) {
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      cnt = __fadd_rn(cnt, 1.0f);
      tot = __fadd_rn(tot, v[i]);
      tsq = __fadd_rn(tsq, __fmul_rn(v[i], v[i]));
      mn = fminf(mn, v[i]);
      mx = fmaxf(mx, v[i]);
    }
  }

  __device__ void write(float* s) const {
    s[0] = cnt;
    s[1] = tot;
    s[2] = tsq;
    s[3] = mn;
    s[4] = mx;
  }
};

// counters: a ticket per cluster, then per cluster its cpu and ram node
// deltas (N each); zero before and after every launch. tile_cnt /
// tile_vals: each tile's finished count and compacted values.
template <int kThreads>
__global__ void __launch_bounds__(kThreads) free_resources_kernel(
    const uint8_t* __restrict__ freed, const int32_t* __restrict__ node,
    const int32_t* __restrict__ req_cpu, const int32_t* __restrict__ req_ram,
    const uint8_t* __restrict__ finishes, const float* __restrict__ value,
    const int32_t* __restrict__ acpu_in, const int32_t* __restrict__ aram_in,
    int32_t* __restrict__ acpu_out, int32_t* __restrict__ aram_out,
    float* __restrict__ stats, int32_t* __restrict__ counters,
    int32_t* __restrict__ tile_cnt, float* __restrict__ tile_vals, int N,
    int P, bool smem_nodes) {
  constexpr int kTile = kThreads * kRows;  // pod rows a block
  extern __shared__ int32_t smem[];
  float* s_vals = reinterpret_cast<float*>(smem);  // kTile
  // smem_nodes: the two allocatable rows (2N); else the tiles' value
  // offsets (T + 1).
  int32_t* s_aux = smem + kTile;
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_last;

  const int T = gridDim.y;
  const size_t c = blockIdx.x;
  const int t = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t nb = c * (size_t)N, pb = c * (size_t)P;
  const int r0 = t * kTile + tid * kRows;
  const int n = min(kRows, P - r0);  // this thread's rows in range (<= 0: none)
  int32_t* delta = counters + gridDim.x + 2 * nb;

  // Both flag rows in one round trip (the finished flags are read where
  // nothing is freed too: 1 B a row, against a dependent trip).
  const unsigned fm = flags16(freed + pb + r0, n);
  const unsigned fin = flags16(finishes + pb + r0, n) & fm;
  if (smem_nodes) {
    for (int i0 = 0; i0 < N; i0 += kBatch * kThreads) {
      int32_t ac[kBatch], ar[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * kThreads + tid;
        ac[k] = i < N ? acpu_in[nb + i] : 0;
        ar[k] = i < N ? aram_in[nb + i] : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * kThreads + tid;
        if (i < N) s_aux[i] = ac[k], s_aux[N + i] = ar[k];
      }
    }
  }
  int total;
  int off = block_scan<kThreads>(__popc(fin), s_warp, &total);  // its syncs also publish s_aux
  // One round trip for every freed row's node, requests and value.
  for (unsigned m = fm; m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    const size_t p = pb + r0 + j;
    const int nd = node[p];
    const int32_t rc = req_cpu[p], rr = req_ram[p];
    const float v = value[p];
    if ((fin >> j) & 1u) s_vals[off++] = v;
    if (nd < 0 || nd >= N) continue;
    if (smem_nodes) {
      atomicAdd(&s_aux[nd], rc);
      atomicAdd(&s_aux[N + nd], rr);
    } else {
      atomicAdd(&delta[nd], rc);
      atomicAdd(&delta[N + nd], rr);
    }
  }
  __syncthreads();

  if (smem_nodes) {  // one tile: this block is the cluster's only block
    for (int i = tid; i < N; i += kThreads) {
      acpu_out[nb + i] = s_aux[i];
      aram_out[nb + i] = s_aux[N + i];
    }
    if (tid == 0) {
      Stats s;
      s.fold(s_vals, total);
      s.write(stats + c * 5);
    }
    return;
  }

  // Cross-block step: publish this tile, then the last block finishes.
  const size_t tb = c * (size_t)T;
  float* my_vals = tile_vals + (tb + t) * (size_t)kTile;
  for (int i = tid; i < total; i += kThreads) my_vals[i] = s_vals[i];
  if (tid == 0) tile_cnt[tb + t] = total;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[c], 1) == T - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The first kThreads tiles' counts load beside the node rows.
  int cnt = tid < T ? __ldcg(&tile_cnt[tb + tid]) : 0;
  for (int i0 = 0; i0 < N; i0 += kBatch * kThreads) {
    int32_t ac[kBatch], ar[kBatch], dc[kBatch], dr[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads + tid;
      ac[k] = i < N ? acpu_in[nb + i] : 0;
      ar[k] = i < N ? aram_in[nb + i] : 0;
      dc[k] = i < N ? __ldcg(&delta[i]) : 0;
      dr[k] = i < N ? __ldcg(&delta[N + i]) : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads + tid;
      if (i >= N) continue;
      acpu_out[nb + i] = ac[k] + dc[k];
      aram_out[nb + i] = ar[k] + dr[k];
      delta[i] = 0;
      delta[N + i] = 0;
    }
  }
  if (tid == 0) counters[c] = 0;

  // The tiles' value offsets in tile order.
  int run = 0;
  for (int t0 = 0; t0 < T; t0 += kThreads) {
    const int tt = t0 + tid;
    if (t0) cnt = tt < T ? __ldcg(&tile_cnt[tb + tt]) : 0;
    int chunk;
    const int ex = block_scan<kThreads>(cnt, s_warp, &chunk);
    if (tt < T) s_aux[tt] = run + ex;
    run += chunk;
  }
  if (tid == 0) s_aux[T] = run;
  __syncthreads();

  // Gather the values kBatch * kThreads at a time, in one round trip
  // (each thread finds its values' tiles by binary search over the
  // offsets, then loads them all), and fold them in order.
  Stats s;
  for (int w0 = 0; w0 < run; w0 += kBatch * kThreads) {
    const int w1 = min(run, w0 + kBatch * kThreads);
    size_t src[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = min(w0 + k * kThreads + tid, w1 - 1);
      int lo = 0, hi = T;  // s_aux[lo] <= i < s_aux[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_aux[mid] <= i) lo = mid;
        else hi = mid;
      }
      src[k] = (tb + lo) * (size_t)kTile + (i - s_aux[lo]);
    }
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) v[k] = __ldcg(&tile_vals[src[k]]);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = w0 + k * kThreads + tid;
      if (i < w1) s_vals[i - w0] = v[k];
    }
    __syncthreads();
    if (tid == 0) s.fold(s_vals, w1 - w0);
    __syncthreads();
  }
  if (tid == 0) s.write(stats + c * 5);
}

// The launch at one block size; see ktt_free_resources.
template <int kThreads>
int launch(const void* freed, const void* node, const void* req_cpu,
           const void* req_ram, const void* finishes, const void* value,
           const void* acpu_in, const void* aram_in, void* acpu_out,
           void* aram_out, void* stats, void* counters, void* tiles, int C,
           int N, int P, cudaStream_t stream) {
  constexpr int kTile = kThreads * kRows;
  const int T = P > kTile ? (P + kTile - 1) / kTile : 1;
  const size_t vals_smem = sizeof(float) * (size_t)kTile;
  const bool smem_nodes = T == 1 && vals_smem + sizeof(int32_t) * 2 * (size_t)N <= kSmemLimit;
  const size_t smem = vals_smem + sizeof(int32_t) * (smem_nodes ? 2 * (size_t)N : (size_t)T + 1);
  if (smem > kSmemLimit || T > 65535) return (int)cudaErrorInvalidConfiguration;
  if (!smem_nodes && (counters == nullptr || tiles == nullptr)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        free_resources_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int32_t* tile_cnt = (int32_t*)tiles;
  float* tile_vals = tiles ? (float*)(tile_cnt + (size_t)C * T) : nullptr;
  free_resources_kernel<kThreads><<<dim3(C, T), kThreads, smem, stream>>>(
      (const uint8_t*)freed, (const int32_t*)node, (const int32_t*)req_cpu,
      (const int32_t*)req_ram, (const uint8_t*)finishes, (const float*)value,
      (const int32_t*)acpu_in, (const int32_t*)aram_in, (int32_t*)acpu_out,
      (int32_t*)aram_out, (float*)stats, (int32_t*)counters, tile_cnt,
      tile_vals, N, P, smem_nodes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ktt_free_resources(
    const void* freed, const void* node, const void* req_cpu,
    const void* req_ram, const void* finishes, const void* value,
    const void* acpu_in, const void* aram_in, void* acpu_out, void* aram_out,
    void* stats, void* counters, void* tiles, int C, int N, int P,
    void* stream) {
  if (C <= 0) return 0;
  auto* run = P <= kSmallTile ? launch<128> : launch<256>;
  return run(freed, node, req_cpu, req_ram, finishes, value, acpu_in, aram_in,
             acpu_out, aram_out, stats, counters, tiles, C, N, P, (cudaStream_t)stream);
}
