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
// Design, simple and right: one warp per probe at a time, warps striding
// over the rows' probes.  Lane l takes samples l, l + 32, ... of the frame
// (one coalesced load of 32 neighbouring samples per step, the table's row
// from shared memory as one float4), four FMA chains; then a fixed butterfly
// of xor shuffles sums the four values over the warp, and lane 0 writes the
// two magnitudes.  No (K, window) gather and no int64 index tensor.  The
// sum of a probe depends only on its frame and the table: every row of a
// (rows, K) call is bitwise the 1-D call on that row, whatever K, rows or
// where the row lies in memory.  Samples are assumed finite.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 8;  // 2,048 threads: a full SM
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ x, long long ld, long long len,
             const long long* __restrict__ starts, long long k, long long total,
             const float* __restrict__ tab, int window, float* __restrict__ out) {
  extern __shared__ float4 tab_s[];
  for (int i = threadIdx.x; i < window; i += kThreads)
    tab_s[i] = make_float4(tab[4 * i], tab[4 * i + 1], tab[4 * i + 2], tab[4 * i + 3]);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long last = len - window;
  long long p = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  long long nxt = p < total ? starts[p] : 0;
  for (; p < total; p += warps) {
    const long long row = p / k;
    long long s = nxt;
    if (p + warps < total) nxt = starts[p + warps];  // the next probe's start, ahead
    s = s < 0 ? 0 : (s > last ? last : s);
    const float* f = x + row * ld + s;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int j = lane; j < window; j += 32) {
      const float v = f[j];
      const float4 t = tab_s[j];
      a0 = fmaf(v, t.x, a0);
      a1 = fmaf(v, t.y, a1);
      a2 = fmaf(v, t.z, a2);
      a3 = fmaf(v, t.w, a3);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, off);
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
      a2 += __shfl_xor_sync(0xffffffffu, a2, off);
      a3 += __shfl_xor_sync(0xffffffffu, a3, off);
    }
    if (lane == 0) {
      out[2 * p] = sqrtf(a0 * a0 + a1 * a1);
      out[2 * p + 1] = sqrtf(a2 * a2 + a3 * a3);
    }
  }
}

}  // namespace

extern "C" int axctd_probe_launch(const float* x, long long ld, long long len, int rows,
                                  const long long* starts, long long k, const float* tab,
                                  int window, float* out, void* stream) {
  const long long total = static_cast<long long>(rows) * k;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  if (window <= 0 || len < window) return static_cast<int>(cudaErrorInvalidValue);
  static int sms_of[kMaxDevices];  // read once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sms = sms_of[dev];
  const long long want = (total + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < static_cast<long long>(sms) * kBlocksPerSm
                                          ? want : static_cast<long long>(sms) * kBlocksPerSm);
  const size_t smem = sizeof(float4) * static_cast<size_t>(window);
  probe_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, ld, len, starts, k, total, tab, window, out);
  return static_cast<int>(cudaGetLastError());
}
