// Fast-forward's catch-up: the cadence bookkeeping of the skipped windows
// [from, to), with the window body's own per-window float32 arithmetic,
// so a fast-forwarded run ends bit for bit where stepping every window
// ends.
//
// Replaces no TPU kernel. The reference computes it in XLA
// (kubernetriks_tpu/batched/step.py:2322 `_catch_up_bookkeeping`, a
// while_loop of ~10 small (C,) ops a window); in eager PyTorch a 50-window
// skip is ~500 launches.
//
// For every cluster c and every skipped window w in [span[0], span[1]),
// in order:
//   last_flush = w where float32(w - last_flush) * interval >=
//     flush_interval (the flush cadence, prepare_queue's compare);
//   with the autoscalers: hpa_next += hpa_interval where hpa_next <= (w,
//   0); ca_next += ca_period where ca_next + ca_snap < (w + 1, 0)
//   (pair arithmetic of timerep.t_add: offsets summed in float32, one
//   carry by a float32 division and floor, every operation unfused);
// then time = max(time, span[1] - 1).
//
// Bound on an H100: bytes, ~40 B read and ~24 B written a cluster; the
// loop is ~20 float32 operations a cluster a skipped window. Design: one
// thread per cluster, the span read from the device (the window
// executor's next piece wrote it), so one captured graph serves any skip.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

struct Pair {
  int win;
  float off;
};

__device__ __forceinline__ Pair t_add(Pair a, int bw, float bo, float interval) {
  const float off = __fadd_rn(a.off, bo);
  const float q = floorf(__fdiv_rn(off, interval));
  return {a.win + bw + (int)q, __fsub_rn(off, __fmul_rn(q, interval))};
}

__global__ void catch_up_kernel(const int32_t* __restrict__ span, const int32_t* __restrict__ last_flush,
                                const int32_t* __restrict__ time, const int32_t* __restrict__ hpa_win,
                                const float* __restrict__ hpa_off, const int32_t* __restrict__ ca_win,
                                const float* __restrict__ ca_off, const int32_t* __restrict__ hi_win,
                                const float* __restrict__ hi_off, const int32_t* __restrict__ snap_win,
                                const float* __restrict__ snap_off, const int32_t* __restrict__ per_win,
                                const float* __restrict__ per_off, int32_t* __restrict__ out_flush,
                                int32_t* __restrict__ out_time, int32_t* __restrict__ out_hpa_win,
                                float* __restrict__ out_hpa_off, int32_t* __restrict__ out_ca_win,
                                float* __restrict__ out_ca_off, int C, int has_auto, float interval,
                                float flush_interval) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int lo = span[0], hi = span[1];
  int lf = last_flush[c];
  Pair hpa = {0, 0.0f}, ca = {0, 0.0f};
  if (has_auto) {
    hpa = {hpa_win[c], hpa_off[c]};
    ca = {ca_win[c], ca_off[c]};
  }
  for (int w = lo; w < hi; ++w) {
    if (__fmul_rn(__int2float_rn(w - lf), interval) >= flush_interval) lf = w;
    if (has_auto) {
      if (hpa.win < w || (hpa.win == w && hpa.off <= 0.0f)) hpa = t_add(hpa, hi_win[c], hi_off[c], interval);
      const Pair snap = t_add(ca, snap_win[c], snap_off[c], interval);
      if (snap.win < w + 1 || (snap.win == w + 1 && snap.off < 0.0f)) ca = t_add(ca, per_win[c], per_off[c], interval);
    }
  }
  out_flush[c] = lf;
  out_time[c] = max(time[c], hi - 1);
  if (has_auto) {
    out_hpa_win[c] = hpa.win;
    out_hpa_off[c] = hpa.off;
    out_ca_win[c] = ca.win;
    out_ca_off[c] = ca.off;
  }
}

}  // namespace

extern "C" int ktt_catch_up(const void* span, const void* last_flush, const void* time, const void* hpa_win,
                            const void* hpa_off, const void* ca_win, const void* ca_off, const void* hi_win,
                            const void* hi_off, const void* snap_win, const void* snap_off, const void* per_win,
                            const void* per_off, void* out_flush, void* out_time, void* out_hpa_win,
                            void* out_hpa_off, void* out_ca_win, void* out_ca_off, int C, int has_auto,
                            int interval_bits, int flush_bits, void* stream) {
  if (C <= 0) return 0;
  float interval, flush_interval;
  memcpy(&interval, &interval_bits, 4);
  memcpy(&flush_interval, &flush_bits, 4);
  const int threads = 128;
  catch_up_kernel<<<(C + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)span, (const int32_t*)last_flush, (const int32_t*)time, (const int32_t*)hpa_win,
      (const float*)hpa_off, (const int32_t*)ca_win, (const float*)ca_off, (const int32_t*)hi_win,
      (const float*)hi_off, (const int32_t*)snap_win, (const float*)snap_off, (const int32_t*)per_win,
      (const float*)per_off, (int32_t*)out_flush, (int32_t*)out_time, (int32_t*)out_hpa_win,
      (float*)out_hpa_off, (int32_t*)out_ca_win, (float*)out_ca_off, C, has_auto, interval, flush_interval);
  return (int)cudaGetLastError();
}
