// Chain-walk kernels for Hopper (sm_90a): the pointer-doubling chain
// enumeration of ops/chain.py on the card.
//
// Replaces code that the JAX package leaves to XLA, not a Pallas kernel:
//  * chain_compose_kernel: one squaring level of the strided delta table,
//    the shifted-select loop of axctdprocessor_tpu/ops/chain.py:284-297
//    (chain_enumerate_strided).  d2[i] = d[i] + d[i + d[i]] where
//    span <= d[i] <= hi and i + d[i] < m, else d[i]: exactly the JAX
//    condition (a stalled walk keeps its delta; a jump past the table reads
//    the zero pad), written as one bounded gather instead of 3*span + 1
//    shifted copies and selects.  One launch per level; every level's table
//    is kept, because the walk below reads all of them.
//  * chain_walk_kernel: the doubling fill of chain[:first] from the level
//    tables and the tail, the lax.scan of chain.py:299-329 (strided deltas,
//    nc += d_last[nc]) and of chain.py:216-245 (a full jump table,
//    nc = J_last[nc]).  One block per row: the block fills chain[:first] in
//    shared memory, one barrier per level, then thread t walks head t
//    ceil((k - first) / first) dependent steps and writes
//    out[row, j * first + t] while below k.
//
// Bound.  The walk is bound by the latency of its dependent loads, not by
// bytes: each step is one load whose address is the previous load's value.
// The table it walks (the 600 s drop's d_last: 1.8 M int16, 3.6 MB) sits in
// the 50 MB L2, so a step costs about one L2 hit (a few hundred cycles); the
// `first` heads of a row walk at once and the rows of a batch run on their
// own SMs.  The bytes a call must move (its k outputs of 8 bytes and the k
// entries it reads) take microseconds at 3.35 TB/s; the latency floor is
// about (k / first) L2 round trips, about a millisecond at 600 s.  More heads
// (a deeper table) would shorten the walk at the cost of compose levels;
// that is left for later.  The compose pass reads each entry and one other
// per entry and writes each once: bound by bytes, coalesced but for the
// gather, which lands within 4 * span entries of its reader.
//
// Everything is integer, so the result is bit for bit that of the plain
// version in ops/chain.py, on any grid.  The tables must be valid: every
// index the walk reaches (start, and each value of a full table, or i + d[i]
// of a delta table) lies in [0, m), as the callers' successor maps do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kComposeThreads = 256;
constexpr int kMaxFirst = 1024;  // chain heads a block holds in shared memory

__global__ void chain_compose_kernel(const int16_t* __restrict__ d, int16_t* __restrict__ out,
                                     long long m, int span, int hi) {
  const long long i = blockIdx.x * static_cast<long long>(kComposeThreads) + threadIdx.x;
  if (i >= m) return;
  const long long row = static_cast<long long>(blockIdx.y) * m;
  const int di = d[row + i];
  int add = 0;
  if (di >= span && di <= hi && i + di < m) add = d[row + i + di];
  out[row + i] = static_cast<int16_t>(di + add);
}

// one step of a walk from position i through a level table
template <typename T, bool kStrided>
__device__ __forceinline__ int step(const T* __restrict__ table, int i) {
  const int v = static_cast<int>(table[i]);
  return kStrided ? i + v : v;
}

template <typename T, bool kStrided>
__global__ void chain_walk_kernel(const T* __restrict__ levels, int n_levels, long long level_stride,
                                  long long m, int start, long long k, int first,
                                  long long* __restrict__ out) {
  __shared__ int chain0[kMaxFirst];
  const int t = threadIdx.x;
  const T* base = levels + static_cast<long long>(blockIdx.x) * m;
  long long* orow = out + static_cast<long long>(blockIdx.x) * k;
  if (t == 0) chain0[0] = start;
  __syncthreads();
  int lvl = 0;
  for (int s2 = 1; s2 < first; s2 *= 2, ++lvl) {  // doubling: chain[s2 : 2 s2]
    if (t < s2) chain0[s2 + t] = step<T, kStrided>(base + lvl * level_stride, chain0[t]);
    __syncthreads();
  }
  if (t >= first) return;
  int nc = chain0[t];
  if (t < k) orow[t] = nc;
  const T* last = base + static_cast<long long>(n_levels - 1) * level_stride;
  for (long long j = first + t; j < k; j += first) {  // the tail: first steps at a time
    nc = step<T, kStrided>(last, nc);
    orow[j] = nc;
  }
}

template <typename T, bool kStrided>
int walk(const T* levels, int n_levels, int rows, long long m, int start, long long k, int first,
         long long* out, cudaStream_t stream) {
  if (rows <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  if (first < 1 || first > kMaxFirst || n_levels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = first < 32 ? 32 : first;
  chain_walk_kernel<T, kStrided><<<rows, threads, 0, stream>>>(
      levels, n_levels, static_cast<long long>(rows) * m, m, start, k, first, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int axctd_chain_compose_launch(const int16_t* d, int16_t* out, int rows, long long m,
                                          int span, int hi, void* stream) {
  if (rows <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((m + kComposeThreads - 1) / kComposeThreads), rows);
  chain_compose_kernel<<<grid, kComposeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d, out, m, span, hi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int axctd_chain_walk_strided_launch(const int16_t* levels, int n_levels, int rows,
                                               long long m, int start, long long k, int first,
                                               long long* out, void* stream) {
  return walk<int16_t, true>(levels, n_levels, rows, m, start, k, first, out,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int axctd_chain_walk_launch(const long long* levels, int n_levels, int rows,
                                       long long m, int start, long long k, int first,
                                       long long* out, void* stream) {
  return walk<long long, false>(levels, n_levels, rows, m, start, k, first, out,
                                static_cast<cudaStream_t>(stream));
}
