// Fused tone-ratio kernel for Hopper (sm_90a), and its raw-powers variant.
//
// Replaces the Pallas kernel axctdprocessor_tpu/ops/pallas/tonepower.py
// (fused_tone_ratios): for every window of `window` samples at `stride`,
// the single-bin DFT magnitude at 400 Hz, 7500 Hz and the dead frequency,
// a causal box mean over the trailing SMOOTH+1 = 6 windows (count
// min(w+1, 6)), then r400 = log10(p400/pdead), r7500 = log10(p7500/pdead).
//
// Bound: each sample must be read once (4 bytes) and each window does six
// dot products of length `window`: at 44.1 kHz (window 4410, stride 1764)
// that is 30 flop per sample (the third table segment is half zeros and is
// skipped), so 4 bytes per 30 flop.  At 3.35 TB/s and 66.9 TFLOP/s (f32,
// CUDA cores) the bytes take 2.6x as long as the arithmetic: the kernel is
// bound by reading the samples once.
//
// Design: the TPU kernel's tiles-times-segments decomposition.  A row is
// viewed as (n_tiles, stride) tiles and the (window, 6) table as n_seg =
// ceil(window/stride) stride-aligned segments (segment j, row r is table
// row j*stride + r); window w = sum_j tile[w+j] . seg[j].
//  * Blocks own fixed runs.  A block owns kRun windows (a compile-time
//    constant, independent of rows, n and the card) and computes the powers
//    of kLocal = kRun + 5 windows: its own and the 5 before them (the box
//    mean's halo), from kLocal + n_seg - 1 tiles.  Nothing carries between
//    blocks, which run in no order.
//  * The table lives in shared memory, copied once per block as it lies in
//    device memory and zero past `window` (107 KB at 44.1 kHz, 121 KB at
//    50 kHz).  With the ring that is one block per SM (213 / 228 KB).  A
//    table that does not fit beside the ring (windows above about 5,200
//    samples at the standard shape: the batch and archive paths decode
//    88.2 and 96 kHz rows at their own rate) is streamed instead; see
//    "Streamed table" below.
//  * The tiles stream through shared memory in a ring of kStages = 3 stages
//    of kKc = 64 samples of every tile, with cp.async 16-byte copies that
//    overlap the arithmetic.  A tile's start is 16-byte aligned only when n
//    and stride are multiples of 4 (not for stride 882, or a ragged n), so
//    every copy starts at the 16-byte boundary at or below it and the
//    reader offsets inside the staged row: one code path.  Samples past n
//    are zero-filled by the copy (its source size), as are tiles before 0.
//  * Register blocking.  A block is WARPS warps (8 in the standard shape)
//    and a warp owns WPW consecutive windows (16 in the standard shape;
//    template parameters, smaller for small grids below).  In a step of 32
//    samples, lane l takes sample l of every tile: it reads the
//    WPW + n_seg - 1 tiles the warp's windows touch once from shared
//    memory and feeds each to the n_seg windows that use it, with one
//    8-byte table read per tone and segment (conflict-free at a 24-byte
//    lane stride): at WPW 16, 288 FMAs per 27 shared loads.  The next
//    step's operands are loaded while this step's FMAs run.  The third
//    segment is skipped past its last nonzero row.  f32 FMAs on the CUDA
//    cores: no TF32.  The
//    WPW x 6 partial sums are then reduced across the warp by halving
//    exchanges (each lane keeps half of what it holds and sends the other
//    half), a fixed tree.
//
// Measured on an H100 SXM (scripts/tone_ratios_variants.py, PERF.md): at
// 600 s the kernel reads the samples at about 2.2 TB/s (a device-to-device
// copy of the same bytes runs at about 2.5 TB/s); on small grids one
// block's walk (about 45 us for 128 windows) sets the time.
//
// The arithmetic of a window depends only on its index, the row's samples,
// and the constants above, so every row of a (rows, n) call is bitwise
// equal to the 1-D call on that row.  Samples past n read as 0, powers of
// windows with index < 0 count as 0, the box mean is summed oldest first
// and the ratios take no epsilon: a window whose dead-tone mean is 0 (the
// zero-padded tail of a bucket) gives NaN or inf, as the plain version
// does; callers mask it.  Samples are assumed finite: a zero table entry
// times a non-finite sample is skipped here in the third segment's zero
// half, where the plain version's matmul would propagate it.
//
// Small grids.  The standard block computes 8 x 16 = 128
// windows and owns 123; one block fits an SM (the table is 107 KB at 44.1
// kHz), so a grid under one wave of the card's SMs is as slow as one block's
// walk: a group of 4 segments of 23.56 s is 20 blocks on 132 SMs, one 60 s
// drop 13 (the monolithic decode of every drop up to 300 s: 61 blocks).  There the
// launcher takes the fewest windows a warp (8 warps of 2, 3, 4, 5, 6 or 8)
// whose grid still fits in one wave: more blocks, each a walk shorter by the
// windows a warp.  The 5 halo windows are then a
// larger share of a block's arithmetic: kLocal / kRun - 1 = 4% at 128
// windows a block, 8% at 64, 12% at 48, 14% at 40, 19% at 32, 26% at 24,
// 45% at 16; under one wave that costs blocks, not time.  The bits cannot move: a window's sum is its
// lane's FMA chain over steps and segments, the same in any shape, then
// reduce_lanes' xor butterfly over lane bits 16, 8, 4, 2, 1, the same tree
// for any count of values (each sum is mine + my partner's, and addition
// commutes).  The box mean of a window reads the powers of it and the 5
// before it, all computed in its block, oldest first, so the ratios too are
// the standard shape's bit for bit.  Both launchers take the rule, each with
// its resident or streamed table as the shape's ring leaves room for.
//
// Batch: grid (ceil(n_win / kRun), rows), blockIdx.y the row, 64-bit row
// offsets (64 rows of 60 s at 44.1 kHz are 169M samples).  Rows lie `ld`
// floats apart (a view of a wider tensor, its last dimension contiguous).
// x must lie in a 16-byte aligned allocation (every CUDA tensor's storage
// does): a copy may start up to 12 bytes before a row, never before its
// storage.
//
// Streamed table (STREAM = true).  Each stage of the ring holds, beside its
// kKc samples of every tile, the NSEG x kKc table rows those samples meet
// (rows j * stride + s * kKc + [0, kKc) of segment j at stage s: 1,152
// floats at NSEG 3, copied with the tiles by the same cp.async groups from
// the 16-byte boundary at or below, zero past `window`), so shared memory
// does not grow with the window: 120 KB at the standard shape for any
// window of at most 3 strides.  A lane reads the same table values in the
// same steps as from the resident table (zeros past `window` there too),
// so its FMA chains, the xor tree and every output are the resident
// kernel's bit for bit.  The launcher takes the resident table whenever
// it fits the card's opt-in with the ring of the launch's block shape, the
// streamed one otherwise: a choice made by size before the launch
// (make_plan, reported by axctd_tone_plan), never after a failure.  It
// reads the table once per block and stage from L2 (about 4.6 KB a stage)
// in place of once per block.
//
// tone_powers (POWERS = true) is the same kernel up to the powers of its
// windows and writes them raw, (rows, n_win, 3) for [400 Hz, 7500 Hz, dead]:
// no box mean, no log.  It stands for the segmented and time-sharded paths'
// framed_tone_power_tiled (the JAX package's axctdprocessor_tpu/ops/goertzel.py
// under jax.vmap in _segment_program_grouped and _resident_program), whose
// callers smooth the gathered series themselves.  Its blocks still compute
// the 5 halo windows before their run (4% more arithmetic), so that a
// window's powers are the tone-ratio kernel's bit for bit; as there, a
// window's sum depends only on its index and its row, never on how many
// rows share the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsStd = 8;            // warps per block, the standard shape
constexpr int kWpwStd = 16;             // windows per warp (register block), the standard shape
// A build may force the ratios' one shape (AXCTD_TONE_RATIOS_WARPS,
// AXCTD_TONE_RATIOS_WPW) to compare it with another build; otherwise
// (kWarpsRatios 0) the ratios take the launcher's shape, as the raw powers do.
#if defined(AXCTD_TONE_RATIOS_WARPS) && defined(AXCTD_TONE_RATIOS_WPW)
constexpr int kWarpsRatios = AXCTD_TONE_RATIOS_WARPS;
constexpr int kWpwRatios = AXCTD_TONE_RATIOS_WPW;
#else
constexpr int kWarpsRatios = 0;
constexpr int kWpwRatios = 0;
#endif
constexpr int kSmooth = 5;              // trailing windows in the box mean
constexpr int kTaps = kSmooth + 1;
constexpr int kCols = 6;                // cos/sin for 400, 7500, dead
constexpr int kKc = 64;                 // samples of every tile per stage
constexpr int kPitch = kKc + 4;         // staged row: a 16-byte aligned span
constexpr int kChunks = kPitch / 4;     // 16-byte copies per staged row
constexpr int kStages = 3;              // stages in the copy ring
constexpr int kTabPitch = kKc * kCols + 4;   // a segment's rows of a stage (streamed
                                             // table), from the 16-byte boundary below
constexpr int kTabChunks = kTabPitch / 4;    // 16-byte copies of them
constexpr int kMaxDevices = 64;

static_assert(kStages >= 2, "a ring of at least two stages");
static_assert(kKc == 64, "a stage is two steps of one sample per lane");

// Windows whose powers a block of `warps` warps computes at `wpw` windows
// per warp, and the windows it owns (the others are the box mean's halo).
__host__ __device__ constexpr int local_windows(int warps, int wpw) { return warps * wpw; }
__host__ __device__ constexpr int run_windows(int warps, int wpw) {
  return local_windows(warps, wpw) - kSmooth;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Values a lane holds after reduce_lanes<V, 16>.
__host__ __device__ constexpr int held_count(int v, int off) {
  return off == 0 ? v : (v % 2 == 0 ? held_count(v / 2, off / 2) : held_count(v, off / 2));
}

// Sums V values over the 32 lanes of a warp.  While V is even, a lane keeps
// one half (by its bit OFF) and adds its partner's copy of that half; an
// odd V is summed whole.  On return the lane holds the totals of values
// base .. base + held_count(V, OFF) - 1; `writer` is false on the lanes
// whose totals another lane also holds.
template <int V, int OFF>
__device__ __forceinline__ void reduce_lanes(float* v, int lane, int& base, bool& writer) {
  if constexpr (OFF > 0) {
    if constexpr (V % 2 == 0) {
      const bool up = lane & OFF;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        const float send = up ? v[i] : v[i + V / 2];
        const float keep = up ? v[i + V / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (up) base += V / 2;
      reduce_lanes<V / 2, OFF / 2>(v, lane, base, writer);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], OFF);
      if (lane & OFF) writer = false;
      reduce_lanes<V, OFF / 2>(v, lane, base, writer);
    }
  }
}

__host__ __device__ constexpr int tiles_per_block(int nseg, int warps, int wpw) {
  return local_windows(warps, wpw) + nseg - 1;
}

// Floats of one stage of the ring: kKc samples of every tile, and with a
// streamed table the stage's rows of every segment.
__host__ __device__ constexpr int stage_floats(int nseg, int warps, int wpw, bool stream) {
  return tiles_per_block(nseg, warps, wpw) * kPitch + (stream ? nseg * kTabPitch : 0);
}

// Floats of the shared table: rows up to window + kKc - 1 (a stage reads up
// to kKc - 1 rows past the end of a segment, or of the table), rounded up to
// 16 bytes.
__host__ __device__ inline int table_floats(int window) {
  return ((window + kKc) * kCols + 3) & ~3;
}

// Dynamic shared memory of a launch: the resident table (none when it is
// streamed) and the ring.
inline int smem_bytes(int window, int nseg, int warps, int wpw, bool stream) {
  return static_cast<int>(sizeof(float)) *
         ((stream ? 0 : table_floats(window)) + kStages * stage_floats(nseg, warps, wpw, stream));
}

template <int NSEG, bool POWERS, int WARPS, int WPW, bool STREAM>
__global__ void __launch_bounds__(WARPS * 32, 1)
tone_ratios_kernel(const float* __restrict__ x, long long ld, long long n,
                   const float* __restrict__ tm, int window, int stride, int n_win,
                   float* __restrict__ r400, float* __restrict__ r7500) {
  constexpr int kWpw = WPW;
  constexpr int kThreads = WARPS * 32;
  constexpr int kLocal = local_windows(WARPS, WPW);
  constexpr int kRun = run_windows(WARPS, WPW);
  static_assert(kRun > 0, "a block must own at least one window");
  static_assert(kLocal * (kCols + 3) <= kStages * kLocal * kPitch,
                "the epilogue reuses the stage ring");
  constexpr int kTiles = tiles_per_block(NSEG, WARPS, WPW);
  constexpr int kXs = kWpw + NSEG - 1;  // tiles one warp reads
  constexpr int kStageFloats = stage_floats(NSEG, WARPS, WPW, STREAM);
  constexpr int kTabAt = kTiles * kPitch;  // a stage's table rows (streamed)
  constexpr int kCopies = (kTiles * kChunks + kThreads - 1) / kThreads;
  constexpr int kTabCopies = STREAM ? (NSEG * kTabChunks + kThreads - 1) / kThreads : 0;
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  const int tab_floats = STREAM ? 0 : table_floats(window);
  float* ring = tab + tab_floats;
  const uint32_t tab_s = static_cast<uint32_t>(__cvta_generic_to_shared(tab));
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row = blockIdx.y;
  const float* xr = x + row * ld;
  const long long w0 = static_cast<long long>(blockIdx.x) * kRun;
  const long long tile0 = w0 - kSmooth;  // tile of local window 0
  const uintptr_t xr_word = reinterpret_cast<uintptr_t>(xr) >> 2;

  // the resident table, as it lies in device memory, then zeros
  if constexpr (!STREAM) {
    const int tab_bytes = window * kCols * 4;
    const int tab_chunks = (tab_bytes + 15) / 16;
    for (int c = tid; c < tab_chunks; c += kThreads)
      cp_async16(tab_s + 16 * c, reinterpret_cast<const char*>(tm) + 16 * c,
                 min(16, tab_bytes - 16 * c));
    for (int i = 4 * tab_chunks + tid; i < tab_floats; i += kThreads) tab[i] = 0.f;
  }

  // this thread's copies of every stage: staged row u, 16-byte chunk c, at
  // sample off[i] from the block's first tile at stage 0 (16-byte aligned:
  // up to 3 samples before the tile).  avail[i] samples from there exist in
  // the row (clamped to +-2^30), so the chunk's valid samples at stage s are
  // clamp(avail[i] - s*kKc, 0, 4).
  const float* xb = xr + tile0 * stride;  // before the row in block 0: never read there
  int off[kCopies], avail[kCopies];
  uint32_t dst[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int q = tid + i * kThreads;
    const int u = q / kChunks;
    const int c = q - u * kChunks;
    const long long t = tile0 + u;
    const int o = static_cast<int>((xr_word + t * stride) & 3);
    off[i] = u * stride - o + 4 * c;
    avail[i] = 0;  // tiles before 0, and copies past the last row, fill nothing
    if (q < kTiles * kChunks && t >= 0) {
      const long long a = n - (t * stride - o + 4 * c);
      constexpr long long kCap = 1LL << 30;
      avail[i] = static_cast<int>(a < -kCap ? -kCap : (a > kCap ? kCap : a));
    }
    dst[i] = q < kTiles * kChunks ? ring_s + 4u * (u * kPitch + 4 * c) : 0xffffffffu;
  }
  // a streamed table: this thread's copies of every stage's rows, segment
  // j's 16-byte chunk c at float tq[i] of the table at stage 0 (the rows of
  // stage s lie s * kKc * kCols floats further); the table's end zero-fills
  int tq[kTabCopies > 0 ? kTabCopies : 1];
  uint32_t tdst[kTabCopies > 0 ? kTabCopies : 1];
  const int tab_total = window * kCols;
  if constexpr (STREAM) {
#pragma unroll
    for (int i = 0; i < kTabCopies; ++i) {
      const int q = tid + i * kThreads;
      const int j = q / kTabChunks;
      const int c = q - j * kTabChunks;
      tq[i] = ((j * stride * kCols) & ~3) + 4 * c;
      tdst[i] = q < NSEG * kTabChunks ? ring_s + 4u * (kTabAt + j * kTabPitch + 4 * c)
                                      : 0xffffffffu;
    }
  }
  auto issue = [&](int s, int buf) {
    const int kc = s * kKc;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      if (dst[i] == 0xffffffffu) continue;
      const int bytes = 4 * min(max(avail[i] - kc, 0), 4);
      const float* src = bytes ? xb + (off[i] + kc) : xr;
      cp_async16(dst[i] + 4u * buf * kStageFloats, src, bytes);
    }
    if constexpr (STREAM) {
#pragma unroll
      for (int i = 0; i < kTabCopies; ++i) {
        if (tdst[i] == 0xffffffffu) continue;
        const int t = tq[i] + kc * kCols;
        const int bytes = 4 * min(max(tab_total - t, 0), 4);
        cp_async16(tdst[i] + 4u * buf * kStageFloats, bytes ? tm + t : tm, bytes);
      }
    }
  };

  // where lane `lane` reads tile i0 + u of a stage
  const int i0 = warp * kWpw;
  int rd[kXs];
#pragma unroll
  for (int u = 0; u < kXs; ++u) {
    const long long t = tile0 + i0 + u;
    rd[u] = (i0 + u) * kPitch + static_cast<int>((xr_word + t * stride) & 3) + lane;
  }
  int len[NSEG];  // nonzero table rows of each segment
  int toff[NSEG];  // where a streamed stage's rows of segment j begin
#pragma unroll
  for (int j = 0; j < NSEG; ++j) {
    len[j] = min(stride, window - j * stride);
    toff[j] = kTabAt + j * kTabPitch + ((j * stride * kCols) & 3);
  }
  const int n_kst = (min(stride, window) + kKc - 1) / kKc;

  float acc[kWpw * kCols];
#pragma unroll
  for (int i = 0; i < kWpw * kCols; ++i) acc[i] = 0.f;

  // One step is 32 samples of every tile, one per lane; a stage is two
  // steps.  The operands of the next step are loaded into registers while
  // the FMAs of this one run (two register sets, fa and fb), and the
  // barrier for the next stage comes before this stage's second step, whose
  // operands are already in registers.
  struct Frag {
    float x[kXs];
    float2 b[NSEG][3];
  };
  auto load = [&](const float* buf, int h, int kc, Frag& f) {
#pragma unroll
    for (int u = 0; u < kXs; ++u) f.x[u] = buf[rd[u] + 32 * h];
    if (kc + 32 > stride) {  // warp-uniform: lanes past the tile hold the next tile's samples
      const bool past = kc + lane >= stride;
#pragma unroll
      for (int u = 0; u < kXs; ++u) f.x[u] = past ? 0.f : f.x[u];
    }
#pragma unroll
    for (int j = 0; j < NSEG; ++j) {
      if (kc < len[j]) {  // warp-uniform
        const float2* b = reinterpret_cast<const float2*>(
            STREAM ? buf + toff[j] + (32 * h + lane) * kCols
                   : tab + (j * stride + kc + lane) * kCols);
        f.b[j][0] = b[0];
        f.b[j][1] = b[1];
        f.b[j][2] = b[2];
      }
    }
  };
  auto step = [&](const Frag& f, int kc) {
#pragma unroll
    for (int j = 0; j < NSEG; ++j) {
      if (kc < len[j]) {
#pragma unroll
        for (int i = 0; i < kWpw; ++i) {
          const float xs = f.x[i + j];
          float* a = acc + i * kCols;
          a[0] = fmaf(xs, f.b[j][0].x, a[0]);
          a[1] = fmaf(xs, f.b[j][0].y, a[1]);
          a[2] = fmaf(xs, f.b[j][1].x, a[2]);
          a[3] = fmaf(xs, f.b[j][1].y, a[3]);
          a[4] = fmaf(xs, f.b[j][2].x, a[4]);
          a[5] = fmaf(xs, f.b[j][2].y, a[5]);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kst) issue(s, s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  if (kStages - 1 < n_kst) issue(kStages - 1, kStages - 1);
  cp_async_commit();
  Frag fa, fb;
  load(ring, 0, 0, fa);
  for (int s = 0; s < n_kst; ++s) {
    const float* buf = ring + (s % kStages) * kStageFloats;
    const int kc = s * kKc;
    load(buf, 1, kc + 32, fb);
    step(fa, kc);
    if (s + 1 < n_kst) {
      cp_async_wait<kStages - 2>();  // stage s + 1 has landed
      __syncthreads();               // and every warp is done reading stage s
      if (s + kStages < n_kst) issue(s + kStages, s % kStages);
      cp_async_commit();
      load(ring + ((s + 1) % kStages) * kStageFloats, 0, kc + kKc, fa);
    }
    step(fb, kc + 32);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue reuses it

  float* proj = ring;                   // (kLocal, 6) dot products
  float* pw = ring + kLocal * kCols;    // (kLocal, 3) powers
  int base = 0;
  bool writer = true;
  reduce_lanes<kWpw * kCols, 16>(acc, lane, base, writer);
  constexpr int kHeld = held_count(kWpw * kCols, 16);
  if (writer) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i) proj[i0 * kCols + base + i] = acc[i];
  }
  __syncthreads();

  for (int i = tid; i < kLocal; i += kThreads) {
    const bool live = w0 - kSmooth + i >= 0;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const float re = proj[i * kCols + 2 * f], im = proj[i * kCols + 2 * f + 1];
      pw[i * 3 + f] = live ? sqrtf(re * re + im * im) : 0.f;
    }
  }
  __syncthreads();

  if constexpr (POWERS) {  // r400 is the (rows, n_win, 3) powers
    for (int i = tid; i < kRun; i += kThreads) {
      const long long w = w0 + i;
      if (w >= n_win) break;
#pragma unroll
      for (int f = 0; f < 3; ++f) r400[(row * n_win + w) * 3 + f] = pw[(i + kSmooth) * 3 + f];
    }
    return;
  }
  for (int i = tid; i < kRun; i += kThreads) {
    const long long w = w0 + i;
    if (w >= n_win) break;
    float s400 = 0.f, s7500 = 0.f, sdead = 0.f;
#pragma unroll
    for (int t = kSmooth; t >= 0; --t) {  // oldest first, as a running sum would
      const float* p = pw + (i + kSmooth - t) * 3;
      s400 += p[0];
      s7500 += p[1];
      sdead += p[2];
    }
    const float cnt = static_cast<float>(w + 1 < kTaps ? w + 1 : kTaps);
    const float m400 = s400 / cnt, m7500 = s7500 / cnt, mdead = sdead / cnt;
    r400[row * n_win + w] = log10f(m400 / mdead);
    r7500[row * n_win + w] = log10f(m7500 / mdead);
  }
}

// A block shape: warps per block, windows per warp.
struct Shape {
  int warps, wpw;
};

// The shapes a launch may take: the standard one, then the small
// ones in the order the launcher prefers them (the fewest windows per warp,
// the shortest walk).
constexpr Shape kShapes[] = {{kWarpsStd, kWpwStd}, {8, 2}, {8, 3}, {8, 4},
                             {8, 5},               {8, 6}, {8, 8}};
constexpr int kNumShapes = sizeof(kShapes) / sizeof(kShapes[0]);

// Blocks of a launch of shape `s`.
long long grid_blocks(int rows, int n_win, Shape s) {
  const int run = run_windows(s.warps, s.wpw);
  return static_cast<long long>(rows) * ((n_win + run - 1) / run);
}

// The block shape of a launch: the standard one, unless its grid
// is under one wave of the card's SMs (one block fits an SM: the table alone
// is 107 KB at 44.1 kHz); then the first small shape whose grid still fits
// in one wave.  A block's walk is set by its windows per warp, so a grid of
// one wave ends with its slowest block, and fewer windows a warp is a
// shorter walk.  Every shape gives each window the same sum.
Shape small_grid_shape(int rows, int n_win, int sms) {
  if (grid_blocks(rows, n_win, kShapes[0]) >= sms) return kShapes[0];
  for (int i = 1; i < kNumShapes; ++i)
    if (grid_blocks(rows, n_win, kShapes[i]) <= sms) return kShapes[i];
  return kShapes[0];
}

// What a launch runs: the block shape, whether the table is streamed, the
// dynamic shared memory, the blocks and the table's segments.
struct Plan {
  Shape shape;
  bool streamed;
  int smem;
  long long blocks;
  int nseg;
};

// The launch of `rows` rows of `n_win` windows of `window` samples at
// `stride`, decided by size before it runs: `shape` ({0, 0}:
// small_grid_shape; the ratios' one shape in a build that forces it); the
// resident table if it fits `optin` bytes beside that shape's ring, the
// streamed one if not.
Plan make_plan(bool powers, int rows, int n_win, int window, int stride, Shape shape, int sms,
               int optin) {
  Plan p;
  p.shape = !powers && kWarpsRatios != 0 ? Shape{kWarpsRatios, kWpwRatios}
            : shape.warps == 0           ? small_grid_shape(rows, n_win, sms)
                                         : shape;
  p.nseg = (window + stride - 1) / stride;
  p.streamed = smem_bytes(window, p.nseg, p.shape.warps, p.shape.wpw, false) > optin;
  p.smem = smem_bytes(window, p.nseg, p.shape.warps, p.shape.wpw, p.streamed);
  p.blocks = grid_blocks(rows, n_win, p.shape);
  return p;
}

// The template arguments of the instance that this thread's last tone call
// launched, written once the launch is made; all zero if it launched nothing.
struct Launched {
  int nseg, powers, warps, wpw, streamed;
};
thread_local Launched last_launched;

template <int NSEG, bool POWERS, int WARPS, int WPW, bool STREAM>
int launch(const float* x, int rows, long long ld, long long n, const float* tm, int window,
           int stride, int n_win, float* r400, float* r7500, cudaStream_t stream, int dev,
           int smem) {
  // the opt-in above 48 KB, set once per device and size (host calls that
  // cost more than a small launch); one per instance of the template
  static int granted[kMaxDevices];
  if (smem > granted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        tone_ratios_kernel<NSEG, POWERS, WARPS, WPW, STREAM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted[dev] = smem;
  }
  constexpr int kRun = run_windows(WARPS, WPW);
  const dim3 grid((n_win + kRun - 1) / kRun, rows);
  tone_ratios_kernel<NSEG, POWERS, WARPS, WPW, STREAM><<<grid, WARPS * 32, smem, stream>>>(
      x, ld, n, tm, window, stride, n_win, r400, r7500);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) last_launched = {NSEG, POWERS ? 1 : 0, WARPS, WPW, STREAM ? 1 : 0};
  return static_cast<int>(err);
}

template <int NSEG, bool POWERS, int WARPS, int WPW>
int launch_planned(const Plan& p, const float* x, int rows, long long ld, long long n,
                   const float* tm, int window, int stride, int n_win, float* r400,
                   float* r7500, cudaStream_t s, int dev) {
  return p.streamed
      ? launch<NSEG, POWERS, WARPS, WPW, true>(x, rows, ld, n, tm, window, stride, n_win, r400,
                                               r7500, s, dev, p.smem)
      : launch<NSEG, POWERS, WARPS, WPW, false>(x, rows, ld, n, tm, window, stride, n_win, r400,
                                                r7500, s, dev, p.smem);
}

template <int NSEG, bool POWERS>
int launch_shape(const Plan& p, const float* x, int rows, long long ld, long long n,
                 const float* tm, int window, int stride, int n_win, float* r400, float* r7500,
                 cudaStream_t s, int dev) {
#define AXCTD_TONE_SHAPE(W, P)                                                              \
  if (p.shape.warps == W && p.shape.wpw == P)                                               \
    return launch_planned<NSEG, POWERS, W, P>(p, x, rows, ld, n, tm, window, stride, n_win, \
                                              r400, r7500, s, dev);
  if constexpr (!POWERS && kWarpsRatios != 0) {
    AXCTD_TONE_SHAPE(kWarpsRatios, kWpwRatios)
  } else {
    AXCTD_TONE_SHAPE(kWarpsStd, kWpwStd)
    AXCTD_TONE_SHAPE(8, 8)
    AXCTD_TONE_SHAPE(8, 6)
    AXCTD_TONE_SHAPE(8, 5)
    AXCTD_TONE_SHAPE(8, 4)
    AXCTD_TONE_SHAPE(8, 3)
    AXCTD_TONE_SHAPE(8, 2)
  }
#undef AXCTD_TONE_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The card's SM count and shared-memory opt-in, read once per device.
int device_limits(int* dev, int* sms, int* optin) {
  static int optin_of[kMaxDevices], sms_of[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (optin_of[*dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&optin_of[*dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *sms = sms_of[*dev];
  *optin = optin_of[*dev];
  return static_cast<int>(cudaSuccess);
}

// Plans and launches: `shape` {0, 0} is the launcher's choice
// (small_grid_shape), another one of kShapes forced.  A plan whose
// shared memory exceeds the opt-in even streamed, or a table of more than 3
// segments, is refused.
template <bool POWERS>
int dispatch(const float* x, int rows, long long ld, long long n, const float* tm, int window,
             int stride, int n_win, Shape shape, float* r400, float* r7500, void* stream) {
  last_launched = Launched{};
  if (n_win <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0, optin = 0;
  const int err = device_limits(&dev, &sms, &optin);
  if (err != cudaSuccess) return err;
  const Plan p = make_plan(POWERS, rows, n_win, window, stride, shape, sms, optin);
  if (p.smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.nseg) {
    case 1: return launch_shape<1, POWERS>(p, x, rows, ld, n, tm, window, stride, n_win, r400,
                                           r7500, s, dev);
    case 2: return launch_shape<2, POWERS>(p, x, rows, ld, n, tm, window, stride, n_win, r400,
                                           r7500, s, dev);
    case 3: return launch_shape<3, POWERS>(p, x, rows, ld, n, tm, window, stride, n_win, r400,
                                           r7500, s, dev);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The ratios; `warps` 0 is the launcher's choice (small_grid_shape),
// otherwise (warps, wpw), one of the shapes axctd_tone_powers_shapes lists,
// forced, to compare with the launcher's choice.
extern "C" int axctd_tone_ratios_shape_launch(const float* x, int rows, long long n,
                                              const float* tm, int window, int stride, int n_win,
                                              int warps, int wpw, float* r400, float* r7500,
                                              void* stream) {
  return dispatch<false>(x, rows, n, n, tm, window, stride, n_win, Shape{warps, wpw}, r400,
                         r7500, stream);
}

extern "C" int axctd_tone_ratios_launch(const float* x, int rows, long long n,
                                        const float* tm, int window,
                                        int stride, int n_win, float* r400,
                                        float* r7500, void* stream) {
  return axctd_tone_ratios_shape_launch(x, rows, n, tm, window, stride, n_win, 0, 0, r400, r7500,
                                        stream);
}

// The raw powers, at the launcher's shape or one forced, as the ratios.
extern "C" int axctd_tone_powers_launch(const float* x, int rows, long long ld, long long n,
                                        const float* tm, int window, int stride, int n_win,
                                        int warps, int wpw, float* powers, void* stream) {
  return dispatch<true>(x, rows, ld, n, tm, window, stride, n_win, Shape{warps, wpw}, powers,
                        nullptr, stream);
}

// The shapes a launch may take, the standard one first: writes at most
// `cap` (warps, windows per warp) pairs and returns how many there are.
extern "C" int axctd_tone_powers_shapes(int* warps, int* wpw, int cap) {
  for (int i = 0; i < kNumShapes && i < cap; ++i) {
    warps[i] = kShapes[i].warps;
    wpw[i] = kShapes[i].wpw;
  }
  return kNumShapes;
}

// 1 if (warps, wpw) is one of the shapes a launch may take.
extern "C" int axctd_tone_powers_shape_known(int warps, int wpw) {
  for (const Shape& s : kShapes)
    if (s.warps == warps && s.wpw == wpw) return 1;
  return 0;
}

// The launch that the ratios (`powers` 0) or the raw powers (1), at the
// launcher's shape (`warps` 0) or (warps, wpw), of `rows` rows of `n_win` windows of `window`
// samples at `stride` makes on the current device, by the launchers' own
// make_plan: out = {streamed, warps, windows a warp, shared-memory bytes,
// the card's opt-in}, and the blocks.  Returns a CUDA error code.
extern "C" int axctd_tone_plan(int powers, int rows, int n_win, int window, int stride, int warps,
                               int wpw, int* out, long long* blocks) {
  int dev = 0, sms = 0, optin = 0;
  const int err = device_limits(&dev, &sms, &optin);
  if (err != cudaSuccess) return err;
  const Plan p = make_plan(powers != 0, rows, n_win, window, stride, Shape{warps, wpw}, sms, optin);
  out[0] = p.streamed ? 1 : 0;
  out[1] = p.shape.warps;
  out[2] = p.shape.wpw;
  out[3] = p.smem;
  out[4] = optin;
  *blocks = p.blocks;
  return static_cast<int>(cudaSuccess);
}

// What this thread's last tone_ratios or tone_powers call launched, from the
// instance itself: out = {segments, powers, warps, windows a warp, streamed},
// all zero if the call launched nothing.
extern "C" void axctd_tone_last_launch(int* out) {
  const Launched& l = last_launched;
  out[0] = l.nseg;
  out[1] = l.powers;
  out[2] = l.warps;
  out[3] = l.wpw;
  out[4] = l.streamed;
}

extern "C" const char* axctd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
