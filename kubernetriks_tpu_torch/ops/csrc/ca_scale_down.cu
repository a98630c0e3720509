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
// A removed candidate stays alive for the later candidates' first-fits, as
// in the reference.
//
// Bound on an H100: bytes, far below one launch. Per cluster the function
// reads the branch flag; on the branch, the threshold, the candidate rows
// (9S B) and, at the slots of the candidates that could attempt,
// not-pending, the capacities and the allocatables; only if some candidate
// is statically eligible, four node rows (alive, two allocatables, name
// rank: 13N B) and those candidates' pod tables (9K B each); it writes S
// flags. At the Alibaba replay (C=1, N=1 713, S=400) that is a few KB,
// ~0.001 us at 3.35 TB/s (chip_smoke.py counts it from the run's data):
// the kernel is bound by its chain of dependent steps, not by either roof.
//
// Design: one block per cluster of ca_down_layout(N) threads (the wrapper
// picks it: ~4 node slots a thread in whole warps, from one warp at N = 96
// to 448 threads at N = 1 713; the slots a thread, NPT, a template
// parameter so the scans unroll). The candidates go in windows of `window`
// positions (all of them where shared memory holds their pod tables):
//   1. Prologue, in parallel over the window: the candidate rows
//      (coalesced, a position a thread); a second round trip gathers, at
//      the slots of the candidates alive, in range and with at most K pods,
//      not-pending, the capacities and the starting allocatables, and
//      makes each one's threshold test on them. Warp 0 compacts the
//      statically eligible ones (also not pending) in name order with
//      ballots. With the branch off every flag is written 0 and the block
//      returns; with nothing eligible the node rows are never loaded.
//   2. Stage the eligible candidates' pods (one thread a candidate, its
//      flagged pods compacted in order) and, once, the node rows: each
//      thread owns the slots n = tid + j*T and keeps their working
//      allocatables and name-rank keys in registers (NPT of each), the
//      alive flags as a bitmask; only the owner ever reads or changes them.
//   3. Walk the eligible list. The threshold test must see the current
//      working allocatables (an earlier removal's deductions can push a
//      later candidate over it), but a slot no deduction has reached
//      still holds its starting values: every thread marks each target in
//      a shared "touched" byte (its own view is then complete without a
//      barrier). Candidates that need no round (untouched and without
//      pods, or over the threshold for good) are resolved 32 at a time with
//      a ballot; a touched one is tested again, by the owner of its slot,
//      in the same round as its first pod. A round is: each thread takes
//      the least (rank, slot) key among its own fitting slots (from
//      registers), each warp reduces it with two redux.sync, lane 0
//      publishes the warp's key into a double-buffered array, one
//      __syncthreads, every warp folds the published keys with two more,
//      and the target's owner deducts. A one-warp block skips the publishing and
//      the barrier. Thread 0 logs the targets; on a failure every owner
//      adds its deductions back. One barrier a pod.
// Integer arithmetic throughout except the threshold divide (__fdiv_rn;
// built with --fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ int sub_wrap(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// The reference's float32 utilization test: max((cap - v) / max(cap, 1))
// over cpu and ram, each side cast to float, below the threshold.
__device__ __forceinline__ bool under_threshold(int2 cap, int vc, int vr, float th) {
  const float util = fmaxf(__fdiv_rn((float)sub_wrap(cap.x, vc), (float)max(cap.x, 1)),
                           __fdiv_rn((float)sub_wrap(cap.y, vr), (float)max(cap.y, 1)));
  return util < th;
}

// The warp's least packed (rank key, slot), on every lane.
__device__ __forceinline__ unsigned long long warp_min_key(unsigned long long v) {
  const unsigned hi = (unsigned)(v >> 32), lo = (unsigned)v;
  const unsigned whi = __reduce_min_sync(kFull, hi);
  const unsigned wlo = __reduce_min_sync(kFull, hi == whi ? lo : kFull);
  return ((unsigned long long)whi << 32) | wlo;
}

// The node slots a thread owns, n = tid + j*T for j < NPT: working
// allocatables, rank keys and alive flags, in registers.
template <int NPT>
struct OwnNodes {
  int vc[NPT], vr[NPT];
  uint32_t key[NPT];
  uint32_t alive = 0;  // bit j: slot tid + j*T alive

  // Add (dc, dr) to slot t if this thread owns it.
  __device__ __forceinline__ void add(int t, int tid, int T, int dc, int dr) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (tid + j * T == t) {
        vc[j] = add_wrap(vc[j], dc);
        vr[j] = add_wrap(vr[j], dr);
      }
    }
  }

  // Whether this thread owns slot t; if so, its working allocatables.
  __device__ __forceinline__ bool get(int t, int tid, int T, int& c, int& r) const {
    bool mine = false;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (tid + j * T == t) {
        c = vc[j];
        r = vr[j];
        mine = true;
      }
    }
    return mine;
  }
};

// NPT: node slots a thread (a power of two, at most 32: a bit each in
// OwnNodes::alive); kOneWarp: a block of one warp, which needs no barrier.
template <int NPT, bool kOneWarp>
__global__ void __launch_bounds__(1024) ca_scale_down_kernel(
    const uint8_t* __restrict__ branch, const float* __restrict__ thresh,
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ not_pending,
    const int32_t* __restrict__ cap_cpu, const int32_t* __restrict__ cap_ram,
    const int32_t* __restrict__ vcpu, const int32_t* __restrict__ vram,
    const int32_t* __restrict__ name_rank, const int32_t* __restrict__ slot_perm,
    const uint8_t* __restrict__ cand_alive, const int32_t* __restrict__ cnt,
    const int32_t* __restrict__ pr_cpu, const int32_t* __restrict__ pr_ram,
    const uint8_t* __restrict__ pv0, uint8_t* __restrict__ removed,
    int N, int S, int K, int W) {
  extern __shared__ int4 smem[];
  int4* s_cand = smem;                                  // W eligible: slot, position, pods, under at start
  int2* s_cap = reinterpret_cast<int2*>(s_cand + W);    // W (cpu, ram) capacity at the slot
  int32_t* s_tgt = reinterpret_cast<int32_t*>(s_cap + W);  // K targets of the candidate
  int32_t* s_slot = s_tgt + K;                          // W slot per position, -1: no
  int32_t* s_list = s_slot + W;                         // W eligible positions
  int32_t* s_prc = s_list + W;                          // W*K staged pod cpu
  int32_t* s_prr = s_prc + (size_t)W * K;               // W*K staged pod ram
  uint8_t* s_touch = reinterpret_cast<uint8_t*>(s_prr + (size_t)W * K);  // N deducted from
  uint8_t* s_elig = s_touch + N;                        // W
  uint8_t* s_under0 = s_elig + W;                       // W under at the start
  uint8_t* s_res = s_under0 + W;                        // W removed flags
  __shared__ unsigned long long s_part[2][32];
  __shared__ int s_under[2];
  __shared__ int s_count;
  __shared__ int s_neg;  // set by any thread that stages a negative request

  const size_t c = blockIdx.x;
  const size_t nb = c * (size_t)N, sb = c * (size_t)S, kb = c * (size_t)S * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nwarps = T >> 5;

  if (!branch[c]) {
    for (int s = tid; s < S; s += T) removed[sb + s] = 0;
    return;
  }
  const float th = thresh[c];

  bool loaded = false;
  OwnNodes<NPT> own;
  int buf = 0;
  // Whether every pod staged so far asks for >= 0 of both resources: then
  // allocatables only shrink, and a candidate over the threshold at the
  // start stays over.
  bool nonneg = true;

  for (int base = 0; base < S; base += W) {
    const int n_w = min(W, S - base);
    // 1. The candidate rows; then, at the slots of the ones that could
    // attempt, not-pending, the capacities and the starting allocatables.
#pragma unroll 4
    for (int p = tid; p < n_w; p += T) {
      const size_t q = sb + base + p;
      const int slot = slot_perm[q];
      const bool pre = cand_alive[q] && slot >= 0 && slot < N && cnt[q] <= K;
      s_slot[p] = pre ? slot : -1;
    }
#pragma unroll 4
    for (int p = tid; p < n_w; p += T) {
      const int slot = s_slot[p];
      bool elig = false;
      if (slot >= 0) {
        elig = not_pending[nb + slot] != 0;
        const int2 cap = make_int2(cap_cpu[nb + slot], cap_ram[nb + slot]);
        s_cap[p] = cap;
        s_under0[p] = under_threshold(cap, vcpu[nb + slot], vram[nb + slot], th);
      }
      s_elig[p] = elig;
      if (!elig) removed[sb + base + p] = 0;
    }
    __syncthreads();
    if (warp == 0) {
      int count = 0;
      for (int p0 = 0; p0 < n_w; p0 += 32) {
        const int p = p0 + lane;
        const bool e = p < n_w && s_elig[p];
        const unsigned b = __ballot_sync(kFull, e);
        if (e) s_list[count + __popc(b & ((1u << lane) - 1u))] = p;
        count += __popc(b);
      }
      if (lane == 0) {
        s_count = count;
        s_neg = 0;
      }
    }
    __syncthreads();
    const int E = s_count;
    if (E == 0) continue;  // uniform; nothing read below until the next barrier

    // 2. Stage the eligible candidates' pods (one thread a candidate, its
    // flagged pods compacted in order) and, once, the node rows.
    for (int i = tid; i < E; i += T) {
      const int p = s_list[i];
      const size_t j0 = kb + (size_t)(base + p) * K;
      int m = 0;
      bool neg = false;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const bool pv = pv0[j0 + k] != 0;
        const int rc = pr_cpu[j0 + k], rr = pr_ram[j0 + k];
        if (pv) {
          s_prc[i * K + m] = rc;
          s_prr[i * K + m] = rr;
          neg |= rc < 0 || rr < 0;
          ++m;
        }
      }
      if (neg) s_neg = 1;
      s_cand[i] = make_int4(s_slot[p], p, m, s_under0[p]);
    }
    if (!loaded) {
      loaded = true;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int n = tid + j * T;
        own.vc[j] = 0;
        own.vr[j] = 0;
        own.key[j] = kFull;
        if (n < N) {
          own.vc[j] = vcpu[nb + n];
          own.vr[j] = vram[nb + n];
          own.key[j] = (uint32_t)name_rank[nb + n] ^ 0x80000000u;
          s_touch[n] = 0;
          if (alive[nb + n]) own.alive |= 1u << j;
        }
      }
    }
    __syncthreads();
    nonneg = nonneg && !s_neg;

    // 3. The walk over the eligible list. Every thread writes s_touch for
    // every target, so its own view of it is complete without a barrier.
    for (int i = 0; i < E;) {
      // The run of candidates ahead that need no round, resolved 32 at a
      // time by the lanes of every warp alike: one over the threshold at
      // the start that no deduction can have brought under it (untouched,
      // or no request below zero so far: allocatables only shrink), or one
      // untouched, under it and without pods (removed). Nothing changes
      // while they are resolved, so each lane's view of s_touch holds.
      const int q = i + lane;
      int4 c = make_int4(0, 0, 0, 0);
      bool touched = false, trivial = false;
      if (q < E) {
        c = s_cand[q];
        touched = s_touch[c.x] != 0;
        trivial = (!c.w && (nonneg || !touched)) || (!touched && c.z == 0);
      }
      const unsigned hard = __ballot_sync(kFull, q < E && !trivial);
      const int run = hard ? __ffs(hard) - 1 : min(32, E - i);
      if (warp == 0 && lane < run) s_res[q] = trivial && c.w && !touched;
      i += run;
      if (!hard) continue;
      // Candidate i needs rounds; the lane that read it hands it over.
      const int4 cd = make_int4(__shfl_sync(kFull, c.x, run), __shfl_sync(kFull, c.y, run),
                                __shfl_sync(kFull, c.z, run), __shfl_sync(kFull, c.w, run));
      const int slot = cd.x, np = cd.z;
      // An untouched slot still holds its starting allocatables, so the
      // threshold test made in the prologue stands; a touched one is
      // tested again, by its owner, in the candidate's first round.
      bool check = __shfl_sync(kFull, (int)touched, run) != 0;
      bool under = check || cd.w != 0, ok = true;
      int placed = 0;  // pods re-placed so far (the first ones, in order)
      while (under && (placed < np || check)) {
        const bool has_pod = placed < np;
        int rc = 0, rr = 0;
        unsigned long long best = kNone;
        if (has_pod) {
          rc = s_prc[i * K + placed];
          rr = s_prr[i * K + placed];
#pragma unroll
          for (int j = 0; j < NPT; ++j) {
            const int n = tid + j * T;
            const unsigned long long key = ((unsigned long long)own.key[j] << 32) | (uint32_t)n;
            if (((own.alive >> j) & 1u) && n != slot && rc <= own.vc[j] && rr <= own.vr[j] && key < best)
              best = key;
          }
          best = warp_min_key(best);
        }
        int u = 0;
        bool mine = false;  // this thread owns the candidate's slot
        if (check) {
          int vc = 0, vr = 0;
          mine = own.get(slot, tid, T, vc, vr);
          if (mine) u = under_threshold(s_cap[cd.y], vc, vr, th);
        }
        if (kOneWarp) {
          if (check) under = __shfl_sync(kFull, u, slot & 31) != 0;
        } else {
          if (has_pod && lane == 0) s_part[buf][warp] = best;
          if (mine) s_under[buf] = u;
          __syncthreads();
          if (check) under = s_under[buf] != 0;
          if (has_pod) best = warp_min_key(lane < nwarps ? s_part[buf][lane] : kNone);
          buf ^= 1;
        }
        check = false;
        if (!under || !has_pod) break;
        if ((unsigned)best == kFull) {
          ok = false;
          break;
        }
        const int t = (int)(unsigned)best;
        own.add(t, tid, T, -rc, -rr);
        s_touch[t] = 1;
        if (tid == 0) s_tgt[placed] = t;
        ++placed;
      }
      if (under && !ok) {
        // Roll back: the owner of each target adds its pod back. Thread 0
        // logged the targets before the failing round's barrier (in a
        // one-warp block, before this __syncwarp).
        if (kOneWarp) __syncwarp();
        for (int q = 0; q < placed; ++q) own.add(s_tgt[q], tid, T, s_prc[i * K + q], s_prr[i * K + q]);
      }
      if (tid == 0) s_res[i] = under && ok;
      ++i;
    }
    __syncthreads();
    for (int i = tid; i < E; i += T) removed[sb + base + s_cand[i].y] = s_res[i];
    __syncthreads();  // the next window rewrites the staging arrays
  }
}

template <int NPT, bool kOneWarp>
int launch(const void* const* a, void* removed, int C, int N, int S, int K,
           int threads, int window, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ca_scale_down_kernel<NPT, kOneWarp>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ca_scale_down_kernel<NPT, kOneWarp><<<C, threads, smem, stream>>>(
      (const uint8_t*)a[0], (const float*)a[1], (const uint8_t*)a[2],
      (const uint8_t*)a[3], (const int32_t*)a[4], (const int32_t*)a[5],
      (const int32_t*)a[6], (const int32_t*)a[7], (const int32_t*)a[8],
      (const int32_t*)a[9], (const uint8_t*)a[10], (const int32_t*)a[11],
      (const int32_t*)a[12], (const int32_t*)a[13], (const uint8_t*)a[14],
      (uint8_t*)removed, N, S, K, window);
  return (int)cudaGetLastError();
}

template <int NPT>
int launch_npt(const void* const* a, void* removed, int C, int N, int S, int K,
               int threads, int window, size_t smem, cudaStream_t stream) {
  return threads == 32
             ? launch<NPT, true>(a, removed, C, N, S, K, threads, window, smem, stream)
             : launch<NPT, false>(a, removed, C, N, S, K, threads, window, smem, stream);
}

}  // namespace

// threads, npt (node slots a thread, a power of two up to 32) and window
// come from ca_down_layout in ops/autoscale_kernel.py, which reckons the
// same shared bytes.
extern "C" int ktt_ca_scale_down(
    const void* branch, const void* thresh, const void* alive,
    const void* not_pending, const void* cap_cpu, const void* cap_ram,
    const void* vcpu, const void* vram, const void* name_rank,
    const void* slot_perm, const void* cand_alive, const void* cnt,
    const void* pr_cpu, const void* pr_ram, const void* pv0, void* removed,
    int C, int N, int S, int K, int threads, int npt, int window, void* stream) {
  if (C <= 0 || S <= 0) return 0;
  if (threads % 32 != 0 || threads < 32 || threads > 1024 || (long long)npt * threads < N || window < 1)
    return (int)cudaErrorInvalidValue;
  const void* a[15] = {branch, thresh, alive, not_pending, cap_cpu, cap_ram, vcpu, vram,
                       name_rank, slot_perm, cand_alive, cnt, pr_cpu, pr_ram, pv0};
  const size_t smem = (size_t)N + 4 * (size_t)K + (size_t)window * (35 + 8 * (size_t)K);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (npt) {
    case 1: return launch_npt<1>(a, removed, C, N, S, K, threads, window, smem, st);
    case 2: return launch_npt<2>(a, removed, C, N, S, K, threads, window, smem, st);
    case 4: return launch_npt<4>(a, removed, C, N, S, K, threads, window, smem, st);
    case 8: return launch_npt<8>(a, removed, C, N, S, K, threads, window, smem, st);
    case 16: return launch_npt<16>(a, removed, C, N, S, K, threads, window, smem, st);
    case 32: return launch_npt<32>(a, removed, C, N, S, K, threads, window, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
