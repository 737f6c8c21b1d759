// Per-bit tone probe for Hopper (sm_90a): probe_at.
//
// Replaces, for the demod front end over a batch, the JAX package's
// goertzel.tone_power_at (axctdprocessor_tpu/ops/goertzel.py:91-110, a
// correlation at every sample then a gather, plain XLA under jax.vmap in
// the vmapped stage-1 programs): for every start s of a row, the magnitudes
// sqrt(re^2 + im^2) of the `window`-sample frame x[s : s + window] against
// the mark and the space tone, with s clamped into [0, L - window].
//
// Inputs: x, rows of L float32 samples at a row pitch of `ld` floats (a
// view with its last dimension contiguous); starts, (rows, K) int64; tab,
// the (window, 4) table (mark cos, mark sin, space cos, space sin).  Output:
// (rows, K, 2) float32 (mark, space).
//
// Bound: the frames of a row cover most of it (bit edges are about
// fs / 800 samples apart and a window is 39 samples at 44.1 kHz), so the
// kernel must read about the waveform once (106 MB at 600 s) and the starts
// (8 bytes a probe) and write 8 bytes a probe; the arithmetic is 8 flop a
// sample of a frame (187 MFLOP at 600 s, 2.8 us at 66.9 TFLOP/s).  At
// 3.35 TB/s the bytes take about 10x as long: the kernel is bound by bytes.
//
// Design: a block for each run of RUN consecutive probes of one row, over
// the run's span staged in shared memory.  The grid is (runs, rows): no
// division per probe.  The block reads its RUN starts coalesced (one
// thread a probe), clamps them and reduces their least and greatest value.
// The starts are bit edges, ascending and about fs / 800 apart; past the
// row's edges the tail repeats the terminal edge (ops/chain.py), one frame
// probed again and again.  So a run's span [min, max + window) is about
// RUN * fs / 800 samples, and when it fits the SPAN-float buffer the
// block stages it: 16-byte cp.async copies of its aligned interior and
// plain loads of the at most 3 samples at either end, so nothing outside
// the span is read and no alignment of the row is assumed.  A run whose
// span does not fit (unsorted starts, gaps, a terminal entry clamped to
// L - window after live edges) reads its frames straight from device
// memory instead, with the same arithmetic.  Then each thread computes its
// probe: four FMA chains over the frame's samples in order, the table's row
// from shared memory as one float4 (a broadcast), and writes its two
// magnitudes as one float2: a warp's stores are 256 contiguous bytes.
// Several blocks on each SM overlap one block's copy with another's
// arithmetic.
//
// The sum of a probe is a fixed order that depends only on its frame and
// the table, whichever path read the frame: every row of a (rows, K) call
// is bitwise the 1-D call on that row, whatever K, rows, the run a probe
// falls in or where the row lies in memory.  Samples are assumed finite.
//
// Geometry (RUN, SPAN), chosen from the window by size before the launch
// (plan), never after a failure.  The window is the engine's probe
// window, about 0.73 of a bit (engine.probe_window: 39 samples of 55.1 at
// 44.1 kHz, 81 of 110.25 at 88.2 kHz, 88 of 120 at 96 kHz), so the window
// sets the span a run of bit edges covers:
//  * the standard geometry, runs of 128 probes over a 9,216-float buffer
//    (36 KB: five blocks an SM), stages every run of bit edges up to 50 kHz
//    (a window of 50, bits of 62.5 samples: 127 * 62.5 + 53 = 7,991
//    floats);
//  * windows above 50 (the batch paths' 88.2 and 96 kHz rows at their
//    native rate, where a run of 128 spans about 14,100 and 15,330 floats)
//    take runs of 64 probes over the same buffer: a run of 64 bit edges
//    spans 63 * 120 + 91 = 7,651 floats at 96 kHz (windows up to about 106,
//    113 kHz, fit), five blocks of two warps an SM.  Timed in turns against
//    runs of 128 over an 18,432-float buffer and runs of 64 over 8,192
//    floats on an H100 SXM (PERF.md; tools/probe_variants.py --high-rate):
//    the three tied within one call's noise.  This one was taken because
//    8,192 floats left 2.6% of the 96 kHz runs unstaged and an 18,432-float
//    buffer holds fewer blocks an SM (three).
// Both are instances of one template, so a probe's arithmetic, and so its
// bits, are the same in either (the sum's order above); a geometry may be
// forced to compare them.  A build may set one geometry alone
// (AXCTD_PROBE_RUN, AXCTD_PROBE_SPAN) to compare variants.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geometry {
  int run, span;  // probes a block owns (one thread each), floats of the staged span
};

#if defined(AXCTD_PROBE_RUN) && defined(AXCTD_PROBE_SPAN)
constexpr Geometry kGeometries[] = {{AXCTD_PROBE_RUN, AXCTD_PROBE_SPAN}};
#else
// The standard geometry first, then the high-rate one.
constexpr Geometry kGeometries[] = {{128, 9216}, {64, 9216}};
#endif
constexpr int kNumGeometries = sizeof(kGeometries) / sizeof(kGeometries[0]);
constexpr int kStdMaxWindow = 50;  // the standard geometry's windows: rates up to 50 kHz
constexpr int kMaxDevices = 64;
constexpr long long kMaxGridX = 2147483647LL;
constexpr long long kMaxGridY = 65535LL;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A float's place in its 16-byte chunk.
__device__ __forceinline__ int word_in_chunk(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

template <int RUN, int SPAN>
__global__ void __launch_bounds__(RUN)
probe_run_kernel(const float* __restrict__ x, long long ld, long long len, long long rows,
                 const long long* __restrict__ starts, long long k, long long runs,
                 const float* __restrict__ tab, int window, float2* __restrict__ out) {
  constexpr int kThreads = RUN;
  constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % 32 == 0 && kThreads >= 32 && kThreads <= 1024,
                "whole warps, at most 1024 threads");
  static_assert(SPAN % 4 == 0, "the span buffer is whole 16-byte chunks");
  extern __shared__ float4 smem4[];
  float* span = reinterpret_cast<float*>(smem4);  // SPAN floats, then the table
  float4* tab_s = smem4 + SPAN / 4;
  __shared__ long long red_lo[kWarps], red_hi[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < window; i += kThreads)
    tab_s[i] = make_float4(tab[4 * i], tab[4 * i + 1], tab[4 * i + 2], tab[4 * i + 3]);
  const uint32_t span_s = static_cast<uint32_t>(__cvta_generic_to_shared(span));
  const long long last = len - window;

  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* xr = x + row * ld;
    for (long long run = blockIdx.x; run < runs; run += gridDim.x) {
      const long long p = run * RUN + t;
      const bool live = p < k;
      long long s = live ? starts[row * k + p] : 0;
      s = s < 0 ? 0 : (s > last ? last : s);
      long long lo = live ? s : len, hi = live ? s : 0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if (lane == 0) {
        red_lo[warp] = lo;
        red_hi[warp] = hi;
      }
      __syncthreads();  // every thread is also done with the last run's span
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        lo = min(lo, red_lo[w]);
        hi = max(hi, red_hi[w]);
      }
      const long long end = hi + window;  // one past the span's last sample
      const bool staged = end - lo + 3 <= SPAN;  // the same on every thread
      int pad = 0;  // span[i - lo + pad] holds sample i of the row
      if (staged) {
        // head [lo, a), 16-byte chunks [a, b), tail [b, end); a and b aligned
        long long a = lo + ((4 - word_in_chunk(xr + lo)) & 3);
        long long b = end - word_in_chunk(xr + end);
        if (b < a) b = a = end;  // a span within one chunk: all head
        pad = static_cast<int>((4 - (a - lo)) & 3);
        const int nch = static_cast<int>((b - a) >> 2);
        const uint32_t dst = span_s + 4u * static_cast<uint32_t>(a - lo + pad);
        for (int c = t; c < nch; c += kThreads) cp_async16(dst + 16u * c, xr + a + 4 * c);
        if (t < 3 && lo + t < a) span[t + pad] = xr[lo + t];
        if (t >= 3 && t < 6 && b + (t - 3) < end) span[b - lo + pad + (t - 3)] = xr[b + (t - 3)];
        cp_async_wait_all();
      }
      __syncthreads();
      if (live) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        const float* f = staged ? span + (s - lo + pad) : xr + s;
        if (staged) {
#pragma unroll 4
          for (int j = 0; j < window; ++j) {
            const float v = f[j];
            const float4 c = tab_s[j];
            a0 = fmaf(v, c.x, a0);
            a1 = fmaf(v, c.y, a1);
            a2 = fmaf(v, c.z, a2);
            a3 = fmaf(v, c.w, a3);
          }
        } else {
#pragma unroll 4
          for (int j = 0; j < window; ++j) {
            const float v = __ldg(f + j);
            const float4 c = tab_s[j];
            a0 = fmaf(v, c.x, a0);
            a1 = fmaf(v, c.y, a1);
            a2 = fmaf(v, c.z, a2);
            a3 = fmaf(v, c.w, a3);
          }
        }
        out[row * k + p] = make_float2(sqrtf(fmaf(a0, a0, a1 * a1)),
                                       sqrtf(fmaf(a2, a2, a3 * a3)));
      }
    }
  }
}

// The geometry the launcher takes for `window`: the standard one up to
// kStdMaxWindow, the high-rate one above (a build of one geometry: that one).
Geometry plan(int window) {
  return kGeometries[window <= kStdMaxWindow || kNumGeometries == 1 ? 0 : 1];
}

// The geometry of this thread's last probe launch; zero if it launched nothing.
thread_local Geometry last_launched;

template <int RUN, int SPAN>
int launch(const float* x, long long ld, long long len, int rows, const long long* starts,
           long long k, const float* tab, int window, float* out, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float) * SPAN + sizeof(float4) * window);
  // per device, once: the opt-in, all of the SM's L1 as shared memory (the
  // blocks per SM are set by it), and the dynamic size granted so far
  static int optin[kMaxDevices], granted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (optin[dev] == 0) {
    err = cudaDeviceGetAttribute(&optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(probe_run_kernel<RUN, SPAN>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (smem > optin[dev]) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > granted[dev]) {
    err = cudaFuncSetAttribute(probe_run_kernel<RUN, SPAN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted[dev] = smem;
  }
  const long long runs = (k + RUN - 1) / RUN;
  const dim3 grid(static_cast<unsigned>(runs < kMaxGridX ? runs : kMaxGridX),
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  probe_run_kernel<RUN, SPAN><<<grid, RUN, smem, stream>>>(
      x, ld, len, rows, starts, k, runs, tab, window, reinterpret_cast<float2*>(out));
  err = cudaGetLastError();
  if (err == cudaSuccess) last_launched = Geometry{RUN, SPAN};
  return static_cast<int>(err);
}

template <int I>
int launch_geometry(Geometry g, const float* x, long long ld, long long len, int rows,
                    const long long* starts, long long k, const float* tab, int window,
                    float* out, cudaStream_t stream) {
  if constexpr (I < kNumGeometries) {
    constexpr Geometry kG = kGeometries[I];
    if (g.run == kG.run && g.span == kG.span)
      return launch<kG.run, kG.span>(x, ld, len, rows, starts, k, tab, window, out, stream);
    return launch_geometry<I + 1>(g, x, ld, len, rows, starts, k, tab, window, out, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Probes at the launcher's geometry for the window (`run` 0), or at (run,
// span), one of the geometries axctd_probe_geometries lists, forced.
extern "C" int axctd_probe_geometry_launch(const float* x, long long ld, long long len, int rows,
                                           const long long* starts, long long k,
                                           const float* tab, int window, int run, int span,
                                           float* out, void* stream) {
  last_launched = Geometry{};
  if (rows <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  if (window <= 0 || len < window) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = run == 0 ? plan(window) : Geometry{run, span};
  return launch_geometry<0>(g, x, ld, len, rows, starts, k, tab, window, out,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int axctd_probe_launch(const float* x, long long ld, long long len, int rows,
                                  const long long* starts, long long k, const float* tab,
                                  int window, float* out, void* stream) {
  return axctd_probe_geometry_launch(x, ld, len, rows, starts, k, tab, window, 0, 0, out,
                                     stream);
}

// The geometry the launcher takes for `window`: the probes a block owns (one
// run) and the floats of its staged span; a run is staged when its clamped
// starts' span plus its window and 3 floats of alignment fits.  Test code
// builds its edge cases from these.
extern "C" void axctd_probe_plan(int window, int* run, int* span) {
  const Geometry g = plan(window);
  *run = g.run;
  *span = g.span;
}

// The geometries a launch may take, the standard one first: writes at most
// `cap` (run, span) pairs and returns how many there are.
extern "C" int axctd_probe_geometries(int* run, int* span, int cap) {
  for (int i = 0; i < kNumGeometries && i < cap; ++i) {
    run[i] = kGeometries[i].run;
    span[i] = kGeometries[i].span;
  }
  return kNumGeometries;
}

// The geometry this thread's last probe call launched, (0, 0) if it
// launched nothing.
extern "C" void axctd_probe_last_launch(int* run, int* span) {
  *run = last_launched.run;
  *span = last_launched.span;
}
