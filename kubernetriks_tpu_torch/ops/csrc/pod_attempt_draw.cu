// The chaos engine's commit-time draw: for every pod slot whose attempt
// starts in this cycle, the CrashLoopBackOff failure draw and the fail
// time.
//
// Replaces no TPU kernel. The reference computes this in XLA inside its
// commit (kubernetriks_tpu/batched/step.py:1311-1360, chaos.py
// `pod_attempt_uniforms`): two chained threefry-2x32 blocks of 20 rounds
// per slot, which XLA fuses into one loop. In eager PyTorch the same bits
// take ~300-400 elementwise launches a committing window, as many as the
// rest of the window; this kernel computes them in one pass over (C, P).
//
// Per slot p of row c (cluster row0 + c: a shard of a cluster batch
// sharded over a mesh keys its draws on the global cluster index),
// started = start_tmp < +inf:
//   gslot = p + pod_base[c] (only plain slots, p < plain_width, draw)
//   (u_fail, u_frac) = pod_attempt_uniforms(seed, row0 + c, gslot, restarts)
//     = to_unit of threefry(key = threefry(key = (seed, 3), ctr = (c,
//       gslot)), ctr = (restarts, 0)), to_unit(b) = (b >> 8) * 2^-24
//   (a scenario fleet passes `seeds`, (C,) uint32 in device memory: then
//   the seed is seeds[c] and the cluster key 0, reference step.py:1328-
//   1336; read at run time, so a captured graph draws with the seeds
//   written last)
//   wf = started & p < plain_width & dur_win >= 0 & u_fail < fail_prob
//   will_fail_out = started ? wf : will_fail
//   fail_rel = wf ? start_tmp + u_frac * dur_s : 0, with dur_s = dur_win *
//     interval + dur_off and the last multiply-add fused, as XLA:CPU (the
//     reference's yardstick) contracts it; everything else unfused
//     (--fmad=false).
//
// Bound on an H100: bytes where few slots start. The function reads 17 B
// a slot (start offset, restarts, duration pair, will_fail) and writes 5 B;
// the hashing is ~170 integer operations for each started slot only.
// Design: one thread per slot, grid-stride, coalesced loads; a slot that
// does not start skips the hash.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kStreamPod = 3u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// Threefry-2x32, 20 rounds, of counter (x0, x1) under key (k0, k1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int chunk = 0; chunk < 5; ++chunk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, rot[chunk & 1][i]);
      x1 ^= x0;
    }
    const int d = chunk + 1;
    x0 += ks[d % 3];
    x1 += ks[(d + 1) % 3] + (uint32_t)d;
  }
}

__device__ __forceinline__ float to_unit(uint32_t b) {
  return __fmul_rn((float)(b >> 8), 5.9604644775390625e-08f);  // 2^-24
}

__global__ void pod_attempt_draw_kernel(
    const float* __restrict__ start_tmp, const int32_t* __restrict__ restarts,
    const int32_t* __restrict__ dur_win, const float* __restrict__ dur_off,
    const uint8_t* __restrict__ will_fail, const int32_t* __restrict__ pod_base,
    const uint32_t* __restrict__ seeds, uint8_t* __restrict__ will_fail_out,
    float* __restrict__ fail_rel, int C, int P, uint32_t seed, int plain_width, float fail_prob,
    float interval, int row0) {
  const size_t total = (size_t)C * P;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const float st = start_tmp[i];
    const bool started = st < INFINITY;
    float rel = 0.0f;
    uint8_t wf_out = will_fail[i];
    if (started) {
      const int c = (int)(i / P), p = (int)(i - (size_t)c * P);
      const bool in_plain = p < plain_width;
      const int32_t dwin = dur_win[i];
      bool wf = false;
      if (in_plain && dwin >= 0) {
        uint32_t h0 = seeds ? 0u : (uint32_t)(row0 + c), h1 = (uint32_t)(p + pod_base[c]);
        threefry(seeds ? seeds[c] : seed, kStreamPod, h0, h1);
        uint32_t b0 = (uint32_t)restarts[i], b1 = 0u;
        threefry(h0, h1, b0, b1);
        wf = to_unit(b0) < fail_prob;
        if (wf) {
          const float dur_s = __fadd_rn(__fmul_rn((float)dwin, interval), dur_off[i]);
          rel = __fmaf_rn(to_unit(b1), dur_s, st);
        }
      }
      wf_out = wf ? 1 : 0;
    }
    will_fail_out[i] = wf_out;
    fail_rel[i] = rel;
  }
}

}  // namespace

extern "C" int ktt_pod_attempt_draw(const void* start_tmp, const void* restarts,
                                    const void* dur_win, const void* dur_off,
                                    const void* will_fail, const void* pod_base,
                                    const void* seeds, void* will_fail_out, void* fail_rel, int C,
                                    int P, int seed,
                                    int plain_width, int fail_prob_bits, int interval_bits,
                                    int row0, void* stream) {
  const size_t total = (size_t)C * P;
  if (total == 0) return 0;
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  float fail_prob, interval;
  memcpy(&fail_prob, &fail_prob_bits, 4);
  memcpy(&interval, &interval_bits, 4);
  pod_attempt_draw_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)start_tmp, (const int32_t*)restarts, (const int32_t*)dur_win,
      (const float*)dur_off, (const uint8_t*)will_fail, (const int32_t*)pod_base,
      (const uint32_t*)seeds, (uint8_t*)will_fail_out, (float*)fail_rel, C, P, (uint32_t)seed,
      plain_width, fail_prob, interval, row0);
  return (int)cudaGetLastError();
}
