// Fused tone-ratio kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel axctdprocessor_tpu/ops/pallas/tonepower.py
// (fused_tone_ratios): for every window of `window` samples at `stride`,
// the single-bin DFT magnitude at 400 Hz, 7500 Hz and the dead frequency,
// a causal box mean over the trailing SMOOTH+1 = 6 windows (count
// min(w+1, 6)), then r400 = log10(p400/pdead), r7500 = log10(p7500/pdead).
//
// Work: each window is 6 dot products of length `window` (4410 at
// 44.1 kHz) against the (window, 6) cos/sin table, ~12 flop per sample per
// window at ~2.5 windows per sample.  Every sample is read by ~2.5 windows
// and every table entry by every window, so both should come from cache;
// what bounds the kernel on the card is not measured yet.
//
// Design: the TPU kernel carries tail tiles and five power rows in VMEM
// scratch from one grid step to the next, which is legal only because a
// TPU grid runs in order.  CUDA blocks run concurrently, so each block owns
// a run of RUN windows and recomputes the powers of the SMOOTH windows
// before its run itself (its left halo).  One warp reduces one window's
// six dot products in f32 (lanes stride over the samples, then a shuffle
// tree); powers go to shared memory; after one barrier each thread forms
// the box mean and the two ratios of one owned window.  The table is read
// through the read-only cache; sin/cos are never evaluated on the device
// (fast intrinsics at arguments up to ~4700 rad would break the tolerance).
//
// Samples past n read as 0, powers of windows with index < 0 count as 0,
// and the ratios take no epsilon: a window whose dead-tone mean is 0 (the
// zero-padded tail of a bucket) gives NaN or inf, as the plain version
// does; callers mask it.
//
// Batch: a (rows, n) input is one launch with grid (ceil(n_win/64), rows),
// blockIdx.y the row, as the Pallas kernel under vmap gets a batch grid
// axis.  A block reads only its own row, with the per-window work and its
// order unchanged, so every row of a batched call is bitwise equal to the
// 1-D call on that row; a 1-D input is the rows = 1 case.  Row offsets are
// 64-bit (64 rows of 60 s at 44.1 kHz are 169M samples).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRun = 64;               // windows owned by one block
constexpr int kSmooth = 5;             // trailing windows in the box mean
constexpr int kTaps = kSmooth + 1;
constexpr int kCols = 6;               // cos/sin for 400, 7500, dead

__global__ void __launch_bounds__(kThreads)
tone_ratios_kernel(const float* __restrict__ x, long long n,
                   const float* __restrict__ tm, int window, int stride,
                   int n_win, float* __restrict__ r400,
                   float* __restrict__ r7500) {
  __shared__ float pw[kRun + kSmooth][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w0 = static_cast<long long>(blockIdx.x) * kRun;
  const long long row = blockIdx.y;
  x += row * n;
  r400 += row * n_win;
  r7500 += row * n_win;

  // powers of windows w0-kSmooth .. w0+kRun-1 (the left halo recomputed)
  for (int j = warp; j < kRun + kSmooth; j += kWarps) {
    const long long w = w0 - kSmooth + j;
    float acc[kCols] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (w >= 0 && w < n_win) {
      const long long base = w * stride;
      for (int k = lane; k < window; k += 32) {
        const long long s = base + k;
        const float v = s < n ? __ldg(x + s) : 0.f;
        const float* t = tm + kCols * k;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(v, __ldg(t + c), acc[c]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int f = 0; f < 3; ++f)
        pw[j][f] = sqrtf(acc[2 * f] * acc[2 * f] + acc[2 * f + 1] * acc[2 * f + 1]);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kRun; i += kThreads) {
    const long long w = w0 + i;
    if (w >= n_win) break;
    float s400 = 0.f, s7500 = 0.f, sdead = 0.f;
#pragma unroll
    for (int t = kSmooth; t >= 0; --t) {  // oldest first, as a running sum would
      s400 += pw[i + kSmooth - t][0];
      s7500 += pw[i + kSmooth - t][1];
      sdead += pw[i + kSmooth - t][2];
    }
    const float cnt = static_cast<float>(w + 1 < kTaps ? w + 1 : kTaps);
    const float m400 = s400 / cnt, m7500 = s7500 / cnt, mdead = sdead / cnt;
    r400[w] = log10f(m400 / mdead);
    r7500[w] = log10f(m7500 / mdead);
  }
}

}  // namespace

extern "C" int axctd_tone_ratios_launch(const float* x, int rows, long long n,
                                        const float* tm, int window,
                                        int stride, int n_win, float* r400,
                                        float* r7500, void* stream) {
  if (n_win <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n_win + kRun - 1) / kRun, rows);
  tone_ratios_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, tm, window, stride, n_win, r400, r7500);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* axctd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
