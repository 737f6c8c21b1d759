// Chain kernels for Hopper (sm_90a): the bit-edge chain and the frame-sync
// walk of ops/chain.py on the card.
//
// Both replace code that the JAX package leaves to XLA, not a Pallas kernel.
//
// chain_walk_segments: the bit-edge chain chain[j] = next^j(start), j < k, of
// a (rows, m) int64 successor table with next[i] - i in {0} ∪ [1, SB] (0 marks
// a fixed point; SB = stride_bound, 4 for the bit edges).  It replaces
// axctdprocessor_tpu/ops/chain.py:248-329 (chain_enumerate_strided: int16 level
// tables squared by shifted selects, the doubling fill and the lax.scan tail).
// The level tables only serve pointer doubling; every algorithm that computes
// next^j(start) gives JAX's result bit for bit, whatever its level count, so
// none is built here.  Instead the data-parallel simulation of a finite-state
// machine (speculate on every entry state, then scan the transition maps):
//  * records (one block per tile of tpb segments of `seg` entries, one
//    thread per segment): the tile's int64 table is copied to shared memory
//    at once (cp.async), then kept as uint8 deltas, four to a word (a layout
//    in which a warp's 32 segments sit in 32 banks), in shared memory and in a
//    scratch copy for the write pass.  A chain enters a segment at one of its
//    first SB entries, because no step is longer than SB and seg >= SB.  Each
//    thread makes its segment's map of those SB entry states (the exit offset
//    into the next segment, or STOP with the terminal, a fixed point; and the
//    chain entries passed) in one backward pass over the segment, the next SB
//    entries' results in registers: no load depends on another.  The maps
//    compose (a monoid); the tile's map follows by a tree of log2(tpb)
//    levels;
//  * scan (one block per row, one warp of it composing): the row's tile maps
//    staged in shared memory, composed from entry 0 of the first tile, 32
//    lanes each over a run of tiles, then across lanes: each tile's true entry
//    and the rank of its first chain entry, the row's chain length and
//    terminal;
//  * write (one block per tile): the segments' entries and ranks within the
//    tile by an inclusive scan of their maps (Hillis-Steele, log2(tpb)
//    levels), then each live segment passes forward from its true entry,
//    writing the chain's positions into a shared buffer that the block writes
//    out coalesced; chain[length:k] is the terminal, as JAX's walk repeats a
//    fixed point.
//  `start` is the origin of the tiling, so the chain enters the first tile at
//  offset 0 and no record of its own is needed.
//
// Bound.  The call must read the (rows, m) int64 table once and write the
// (rows, k) int64 chain once: bytes, 5.7 us at 3.35 TB/s for the 600 s drop,
// 4.6 us for 8 rows of 60 s, 36.8 us for 64.  It moves 1 + 1/8 reads of the
// table (the write pass reads the uint8 copy), the output once and a few
// hundred KB of maps.  Nothing depends on k / first, and the 8 int16 level
// tables are gone.  What holds it above the bound: three kernels one after
// another, each short (a grid of one or a few waves), and in each the
// latency of its steps (copy, convert, pass, tree; stage, compose; scan,
// pass, write).
// Tiling (ops/chain.py SEGMENT, SEGMENTS_PER_BLOCK): seg 32, tpb 128, chosen by
// tools/chain_variants.py --sweep (NVIDIA H100 80GB HBM3, 700.00 W) over seg
// 8-128 x tpb 64-1024 at the decodes' tables; device us per call at the 600 s
// drop / 8 rows / 64 rows: 32 x 128 30.5 / 24.4 / 85.5, the best of each
// shape 28.9 (32 x 256) / 23.4 (16 x 64) / 84.1 (32 x 64), 64 x 128 30.5 /
// 28.2 / 104.5; segments of 128 or more entries, or blocks of 512 or more
// threads, are slower than 32 x 128 at every shape.
// ptxas (sm_90a, SB = 4; no spills): records 32 registers, 40,960 bytes of
// dynamic shared memory at that tiling (the int64 tile, its deltas, the maps);
// scan 32 registers, 1,280 static bytes and 32 per tile of the row (14,080 for
// the 600 s drop); write 39 registers, 20,480 dynamic bytes.
//
// chain_walk_frames: frame sync's chain chain[j] = succ^j(start), j < k, of the
// (rows, m) int64 successor table in the accept-compacted domain
// (ops/chain.py frame_successors), where succ[i] - i is in {0} ∪ [1, 32]: accept
// positions are distinct and ascending, so the next accept 32 bits on lies at
// most 32 entries on.  It replaces axctdprocessor_tpu/ops/chain.py:197-245
// (chain_enumerate: jump tables squared by gathers, the doubling fill and the
// lax.scan tail) for enumerate_frames, with no jump tables.  One kernel, in
// one pass, with a decoupled look-back across tiles (Merrill and Garland,
// "Single-pass parallel prefix scan with decoupled look-back", NVIDIA 2016):
//  * a chain enters a segment of 32 entries at one of its first 32, because
//    no step is longer than 32: one entry state per lane of a warp.  A warp
//    takes spw consecutive segments; lane e loads entry e of each (coalesced)
//    and finds where the walk from e leaves the segment (the exit offset into
//    the next one, or STOP with the terminal, a fixed point) and the entries
//    it passes, by pointer jumping: 5 rounds of __shfl_sync, no dependent
//    load.  The rounds' pointers (succ^1, ^2, ^4, ^8, ^16 inside the segment)
//    stay in one register, 6 bits each, for the write.  Two maps compose with
//    one shuffle per lane (a monoid); the warp's run of segments in spw - 1
//    compositions;
//  * the block's warps' maps are scanned inclusively in shared memory
//    (Hillis-Steele, log2(warps) levels): the tile's map and each warp's
//    prefix;
//  * tiles take their ids from an atomic counter, so a tile's predecessors
//    are running.  A tile publishes its map (32 records) with flag 1, then
//    warp 0 looks back: lane i reads tile j - i's flag, the nearest tile with
//    flag 2 has published the state in which the walk leaves it (entry into
//    the next tile, rank), and the maps of the tiles between are folded in
//    front of the state, one shuffle per lane each, their loads kFold at a
//    time (one L2 round trip each after another made the 600 s walk 15 us).
//    The tile then publishes its own exit state with flag 2;
//  * write: each warp's entry from the tile's and its warp prefix; each live
//    segment's positions from its true entry by a doubling fill through the
//    rounds' pointers (5 rounds, lane i then holds chain[rank + i]), stored
//    as coalesced 8-byte stores while below k.  The row's last tile writes
//    chain[length:k] with the terminal, as JAX's walk repeats a fixed point.
//  The flags and the tile counter must be zero at the launch (the binding
//  allocates them with torch.zeros: one fill).  `start` is the origin of the
//  tiling, so tile 0 is entered at offset 0 with rank 0.
// Bound.  The table read once and the chain written once: 0.137 us at 3.35 TB/s
// for the 600 s drop's frames (38,528 entries, k = 18,760); a few hundred
// nanoseconds at the other shapes.  At these sizes the launch itself and each
// step's latency (the tile id's atomic, load, 5 shuffle rounds, the warps'
// scan, the look-back's L2 round trips, the fill) are what the call takes.
// Tiling (ops/chain.py FRAME_WARPS, FRAME_SEGMENTS_PER_WARP): 16 warps x 4
// segments (tiles of 2,048 entries), chosen by tools/chain_variants.py --frames
// --sweep (NVIDIA H100 80GB HBM3, 700.00 W) over 1-32 warps x 1-8 segments at
// the decodes' tables; us per call queued behind a sleep (the flags' fill
// included) at the 600 s frames / a header window / 8 and 64 rows of 60 s:
// 16 x 4 10.5 / 7.1 / 8.9 / 10.3, the fastest or within 0.1 us of it at every
// shape; 8 x 2 13.1 / 7.8 / 9.4 / 15.4; 1 x 1 33.5 / 10.6 / 19.4 / 76.4.
// ptxas (sm_90a): 62 registers at 4 segments a warp, no spills (8 segments: 64
// registers and 12 bytes of spills), 16,400 bytes of static shared memory.
//
// chain_walk_kernel: the walk over full jump tables of a general map, the
// lax.scan of chain.py:216-245 (nc = J_last[nc]); off the decode paths since
// chain_walk_frames took frame sync.  One block per row: the block fills
// chain[:first] in shared memory, one barrier per level, then thread t walks
// head t ceil((k - first) / first) dependent steps and writes
// out[row, j * first + t] while below k.  Bound by the latency of its dependent
// L2 loads (each address is the previous load's value), not by bytes.
//
// Everything is integer, so every result is bit for bit that of the plain
// versions in ops/chain.py, on any grid.  The tables must be valid, as the
// callers' successor maps are by construction; nothing checks on the card:
// start lies in [0, m); for chain_walk_segments next[i] - i is in
// {0} ∪ [1, SB] and next[i] < m; for chain_walk_frames succ[i] - i is in
// {0} ∪ [1, 32] and succ[i] < m; for chain_walk every value lies in [0, m).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFirst = 1024;   // chain_walk: chain heads a block holds in shared memory
constexpr int kStride = 4;        // chain_walk_segments: the bit edges' stride bound, the one built
constexpr int kMaxTile = 65536;   // positions within a tile are uint16
constexpr int kLanes = 32;        // the scan's lanes (one warp per row)
constexpr int kScanThreads = 256;  // the scan's block, which stages the row's tile maps
constexpr int kMaxShared = 232448;
constexpr int kFrameStride = 32;  // chain_walk_frames: frame sync's stride bound, a warp's lanes
constexpr int kMaxWarps = 32;     // chain_walk_frames: warps of a tile
constexpr int kNone = 32;         // a frame segment's pointer once the walk has left it or stopped
constexpr int kFold = 8;          // chain_walk_frames: predecessors' maps loaded at once in the look-back
constexpr unsigned kFull = 0xffffffffu;

// A map entry: the exit offset into the next segment or tile (st >= 0), or
// STOP with st = -1 - terminal (a position relative to the tile, or to the
// row in the scan); cnt counts the chain entries passed.
struct Rec {
  int st;
  int cnt;
};

// a, then the map b, whose entry e lies at b[e * stride]
__device__ __forceinline__ Rec then(Rec a, const Rec* b, int stride) {
  if (a.st < 0) return a;
  const Rec r = b[a.st * stride];
  return {r.st, a.cnt + r.cnt};
}

// A tile's deltas are uint8, four to a 32-bit word: entries 4g..4g+3 of
// segment s in word g * tpb + (s + skew * g) % tpb.  The walks step through
// g together, one segment a thread, so a warp reads 32 banks; the skew
// (32 / (seg / 4), at least 1) spreads the words that one warp writes when it
// converts 128 consecutive entries over 32 banks too.
__device__ __forceinline__ int word_at(int s, int g, int tpb, int skew) {
  return g * tpb + ((s + skew * g) & (tpb - 1));
}

__device__ __forceinline__ int word_skew(int seg) { return max(1, 128 / seg); }

struct Plan {  // the tiling of one call, the same on host and card
  long long n;  // entries from start to the row's end
  int tile;
  int n_blk;
  // scratch: uint8 deltas, segment maps, tile maps, tiles' entries, rows' ends
  long long off_seg, off_blk, off_in, off_end, bytes;
};

long long align16(long long x) { return (x + 15) / 16 * 16; }

Plan make_plan(int rows, long long m, long long start, int sb, int seg, int tpb) {
  Plan p;
  p.n = m - start;
  p.tile = seg * tpb;
  p.n_blk = static_cast<int>((p.n + p.tile - 1) / p.tile);
  const long long tiles = static_cast<long long>(rows) * p.n_blk;
  p.off_seg = align16(tiles * p.tile);
  p.off_blk = align16(p.off_seg + tiles * tpb * sb * static_cast<long long>(sizeof(Rec)));
  p.off_in = align16(p.off_blk + tiles * sb * static_cast<long long>(sizeof(Rec)));
  p.off_end = align16(p.off_in + tiles * static_cast<long long>(sizeof(Rec)));
  p.bytes = align16(p.off_end + rows * static_cast<long long>(sizeof(Rec)));
  return p;
}

// the int64 tile, its deltas, the segment maps
long long records_smem(int seg, int tpb, int sb) {
  return 9LL * seg * tpb + 1LL * tpb * sb * sizeof(Rec);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  }
}

// the row's tile maps
long long scan_smem(long long m, long long start, int sb, int seg, int tpb) {
  return (m - start + 1LL * seg * tpb - 1) / (1LL * seg * tpb) * sb * sizeof(Rec);
}

// the deltas, the chain's positions (uint16), two buffers of segment maps
long long write_smem(int seg, int tpb, int sb) {
  return 3LL * seg * tpb + 2LL * tpb * sb * sizeof(Rec);
}

template <int SB>
__global__ void chain_segments_records(const long long* __restrict__ nxt, long long m,
                                       long long start, int seg, long long n, int n_blk,
                                       uint8_t* __restrict__ delta, Rec* __restrict__ seg_rec,
                                       Rec* __restrict__ blk_rec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tpb = blockDim.x, t = threadIdx.x, b = blockIdx.x, row = blockIdx.y;
  const int tile = seg * tpb, skew = word_skew(seg);
  long long* raw = reinterpret_cast<long long*>(smem);
  unsigned* dw = reinterpret_cast<unsigned*>(smem + 8 * tile);
  Rec* rec = reinterpret_cast<Rec*>(smem + 9 * tile);  // entry e of segment i at e * tpb + i
  const long long lo = static_cast<long long>(b) * tile;  // the tile's first entry, from start
  const long long valid = n - lo;  // entries of the row from there on; deltas past it are 0
  const long long* src = nxt + static_cast<long long>(row) * m + start + lo;
  // the whole int64 tile in flight at once, without registers: 16-byte
  // copies where the row's address allows them, else 8-byte ones
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = 2 * t; i + 1 < valid && i < tile; i += 2 * tpb) cp_async(raw + i, src + i, 16);
    if (valid < tile && (valid & 1) && t == 0) cp_async(raw + valid - 1, src + valid - 1, 8);
  } else {
    for (int i = t; i < valid && i < tile; i += tpb) cp_async(raw + i, src + i, 8);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // two entries a thread (16 bytes of shared memory, no bank conflict), lanes
  // 2w and 2w + 1 joined into word w of the tile (entries 4w..4w + 3:
  // segment w / (seg / 4))
  for (int i = 2 * t; i < tile; i += 2 * tpb) {  // seg / 2 steps for every thread
    const longlong2 v = reinterpret_cast<const longlong2*>(raw)[i >> 1];
    const unsigned d0 = i < valid ? static_cast<unsigned>(v.x - (start + lo + i)) : 0;
    const unsigned d1 = i + 1 < valid ? static_cast<unsigned>(v.y - (start + lo + i + 1)) : 0;
    const unsigned half = d0 | d1 << 8;
    const unsigned up = __shfl_down_sync(0xffffffffu, half, 1);
    if ((t & 1) == 0) {
      const int w = i >> 2, s = w / (seg >> 2);
      dw[word_at(s, w - s * (seg >> 2), tpb, skew)] = half | up << 16;
    }
  }
  __syncthreads();
  const long long tile_id = static_cast<long long>(row) * n_blk + b;
  uint4* dcopy = reinterpret_cast<uint4*>(delta + tile_id * tile);
  for (int i = t; i < tile / 16; i += tpb) dcopy[i] = reinterpret_cast<const uint4*>(dw)[i];

  // segment t's map, by one backward pass over its entries: the walk from
  // entry j goes on as the walk from j + d[j], one of the next SB entries,
  // whose results a window of registers holds (w[k]: entry j + 1 + k; past
  // the segment's end, the exit at offset k).  Each word of 4 deltas is read
  // once; no load depends on another, and every thread takes seg steps.
  Rec w[SB];
#pragma unroll
  for (int k = 0; k < SB; ++k) w[k] = Rec{k, 0};
  for (int g = (seg >> 2) - 1; g >= 0; --g) {
    const unsigned word = dw[word_at(t, g, tpb, skew)];
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      const int j = 4 * g + q;
      const int dd = (word >> (8 * q)) & 0xff;
      Rec r = w[0];
#pragma unroll
      for (int k = 1; k < SB; ++k) r = dd == k + 1 ? w[k] : r;
      r = dd == 0 ? Rec{-1 - (t * seg + j), 1} : Rec{r.st, r.cnt + 1};
#pragma unroll
      for (int k = SB - 1; k > 0; --k) w[k] = w[k - 1];
      w[0] = r;
    }
  }
  Rec* out = seg_rec + (tile_id * tpb + t) * SB;
#pragma unroll
  for (int e = 0; e < SB; ++e) rec[e * tpb + t] = out[e] = w[e];
  // the tile's map: segment maps composed pairwise, in place
  for (int h = 1; h < tpb; h *= 2) {
    __syncthreads();
    const int tasks = tpb / (2 * h) * SB;
    for (int task = t; task < tasks; task += tpb) {
      const int i = task / SB * 2 * h, e = task % SB;
      rec[e * tpb + i] = then(rec[e * tpb + i], rec + i + h, tpb);
    }
  }
  __syncthreads();
  if (t < SB) blk_rec[tile_id * SB + t] = rec[t * tpb];
}

template <int SB>
__global__ void chain_segments_scan(const Rec* __restrict__ blk_rec, int n_blk, int tile,
                                    Rec* __restrict__ blk_in, Rec* __restrict__ row_end) {
  __shared__ Rec lane_map[kLanes][SB];
  __shared__ Rec lane_in[kLanes];
  extern __shared__ Rec br[];  // the row's tile maps, staged by the whole block
  const int l = threadIdx.x, row = blockIdx.x;
  const Rec* src = blk_rec + static_cast<long long>(row) * n_blk * SB;
#pragma unroll 8
  for (int i = l; i < n_blk * SB; i += kScanThreads) br[i] = src[i];
  __syncthreads();
  if (l >= kLanes) return;
  const int run = (n_blk + kLanes - 1) / kLanes;
  const int b0 = min(l * run, n_blk), b1 = min(b0 + run, n_blk);
  Rec a[SB];  // the lane's run of tiles as a map; terminals relative to the row
#pragma unroll
  for (int e = 0; e < SB; ++e) a[e] = Rec{e, 0};
  for (int b = b0; b < b1; ++b) {
#pragma unroll
    for (int e = 0; e < SB; ++e) {
      if (a[e].st < 0) continue;
      const Rec r = br[b * SB + a[e].st];
      a[e].cnt += r.cnt;
      a[e].st = r.st >= 0 ? r.st : r.st - b * tile;
    }
  }
#pragma unroll
  for (int e = 0; e < SB; ++e) lane_map[l][e] = a[e];
  __syncwarp();
  if (l == 0) {  // across the lanes, from entry 0 of the first tile
    Rec x{0, 0};
    for (int i = 0; i < kLanes; ++i) {
      lane_in[i] = x;
      x = then(x, lane_map[i], 1);
    }
    row_end[row] = x;  // st = -1 - terminal, cnt = the chain's length
  }
  __syncwarp();
  Rec x = lane_in[l];
  for (int b = b0; b < b1; ++b) {  // each tile's entry (st, -1 if the chain ended) and rank
    blk_in[static_cast<long long>(row) * n_blk + b] = Rec{x.st >= 0 ? x.st : -1, x.cnt};
    if (x.st >= 0) {
      const Rec r = br[b * SB + x.st];
      x = Rec{r.st >= 0 ? r.st : -1, x.cnt + r.cnt};
    }
  }
}

template <int SB>
__global__ void chain_segments_write(const uint8_t* __restrict__ delta,
                                     const Rec* __restrict__ seg_rec,
                                     const Rec* __restrict__ blk_in,
                                     const Rec* __restrict__ row_end, int seg, int n_blk,
                                     long long start, long long k, long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tpb = blockDim.x, t = threadIdx.x, b = blockIdx.x, row = blockIdx.y;
  const int tile = seg * tpb, skew = word_skew(seg);
  const long long tile_id = static_cast<long long>(row) * n_blk + b;
  long long* orow = out + static_cast<long long>(row) * k;
  const Rec in = blk_in[tile_id];  // uniform over the block
  if (in.st >= 0 && in.cnt < k) {
    unsigned* dw = reinterpret_cast<unsigned*>(smem);
    uint16_t* chain = reinterpret_cast<uint16_t*>(smem + tile);
    Rec* cur = reinterpret_cast<Rec*>(smem + 3 * tile);  // entry e of segment i at e * tpb + i
    Rec* nxt = cur + tpb * SB;
    const uint4* src = reinterpret_cast<const uint4*>(delta + tile_id * tile);
#pragma unroll 4
    for (int i = t; i < tile / 16; i += tpb) reinterpret_cast<uint4*>(dw)[i] = src[i];
    const Rec* sr = seg_rec + (tile_id * tpb + t) * SB;
#pragma unroll
    for (int e = 0; e < SB; ++e) cur[e * tpb + t] = sr[e];
    for (int off = 1; off < tpb; off *= 2) {  // inclusive scan of the segments' maps
      __syncthreads();
#pragma unroll
      for (int e = 0; e < SB; ++e) {
        nxt[e * tpb + t] = t >= off ? then(cur[e * tpb + t - off], cur + t, tpb) : cur[e * tpb + t];
      }
      Rec* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    __syncthreads();
    const Rec entry = t == 0 ? Rec{in.st, 0} : cur[in.st * tpb + t - 1];
    if (entry.st >= 0) {  // segment t again from its true entry, one forward pass
      int next = entry.st, r = entry.cnt;  // the walk's next entry; seg once it has left or stopped
      for (int g = entry.st >> 2; g < seg >> 2 && next < seg; ++g) {
        const unsigned word = dw[word_at(t, g, tpb, skew)];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * g + q;
          if (j == next) {
            chain[r++] = static_cast<uint16_t>(t * seg + j);
            const int dd = (word >> (8 * q)) & 0xff;
            next = dd == 0 ? seg : j + dd;
          }
        }
      }
    }
    __syncthreads();
    const long long n_out = min(static_cast<long long>(cur[in.st * tpb + tpb - 1].cnt),
                                k - in.cnt);
    const long long origin = start + static_cast<long long>(b) * tile;
    for (long long i = t; i < n_out; i += tpb) orow[in.cnt + i] = origin + chain[i];
  }
  // past the terminal the chain repeats it: chain[length:k], spread over the row's tiles
  const Rec end = row_end[row];
  const long long term = start + (-1 - end.st);
  for (long long i = end.cnt + static_cast<long long>(b) * tpb + t; i < k;
       i += static_cast<long long>(n_blk) * tpb) {
    orow[i] = term;
  }
}

template <int SB>
int segments(const long long* nxt, int rows, long long m, long long start, long long k, int seg,
             int tpb, unsigned char* scratch, long long* out, cudaStream_t stream) {
  const Plan p = make_plan(rows, m, start, SB, seg, tpb);
  uint8_t* delta = scratch;
  Rec* seg_rec = reinterpret_cast<Rec*>(scratch + p.off_seg);
  Rec* blk_rec = reinterpret_cast<Rec*>(scratch + p.off_blk);
  Rec* blk_in = reinterpret_cast<Rec*>(scratch + p.off_in);
  Rec* row_end = reinterpret_cast<Rec*>(scratch + p.off_end);
  const long long smem_a = records_smem(seg, tpb, SB), smem_c = write_smem(seg, tpb, SB);
  const long long smem_b = scan_smem(m, start, SB, seg, tpb);
  cudaError_t err = cudaFuncSetAttribute(chain_segments_records<SB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(chain_segments_write<SB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_c));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(chain_segments_scan<SB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_blk, rows);
  chain_segments_records<SB><<<grid, tpb, smem_a, stream>>>(nxt, m, start, seg, p.n, p.n_blk,
                                                            delta, seg_rec, blk_rec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chain_segments_scan<SB><<<rows, kScanThreads, smem_b, stream>>>(blk_rec, p.n_blk, p.tile, blk_in,
                                                           row_end);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chain_segments_write<SB><<<grid, tpb, smem_c, stream>>>(delta, seg_rec, blk_in, row_end, seg,
                                                          p.n_blk, start, k, out);
  return static_cast<int>(cudaGetLastError());
}

bool segments_args_ok(int rows, long long m, long long start, long long k, int sb, int seg,
                      int tpb) {
  if (rows < 1 || rows > 65535 || m < 1 || m >= (1LL << 31) || start < 0 || start >= m || k < 1) {
    return false;
  }
#ifdef AXCTD_CHAIN_VARIANTS  // tools/chain_variants.py: the same walk at frame sync's stride bound
  if (sb != kStride && sb != kFrameStride) return false;
#else
  if (sb != kStride) return false;
#endif
  if (seg < sb || seg % 4 || tpb < kLanes || tpb > 1024 || (tpb & (tpb - 1))) return false;
  return 1LL * seg * tpb <= kMaxTile && records_smem(seg, tpb, sb) <= kMaxShared &&
         write_smem(seg, tpb, sb) <= kMaxShared &&
         scan_smem(m, start, sb, seg, tpb) + kLanes * (sb + 1) * sizeof(Rec) <= kMaxShared;
}

// one step of a walk from position i through a full jump table
template <typename T>
__device__ __forceinline__ int step(const T* __restrict__ table, int i) {
  return static_cast<int>(table[i]);
}

template <typename T>
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
    if (t < s2) chain0[s2 + t] = step<T>(base + lvl * level_stride, chain0[t]);
    __syncthreads();
  }
  if (t >= first) return;
  int nc = chain0[t];
  if (t < k) orow[t] = nc;
  const T* last = base + static_cast<long long>(n_levels - 1) * level_stride;
  for (long long j = first + t; j < k; j += first) {  // the tail: first steps at a time
    nc = step<T>(last, nc);
    orow[j] = nc;
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The lane's state a, then the map of which lane e holds entry e in b; every
// lane of the warp takes part.
__device__ __forceinline__ Rec then_warp(Rec a, Rec b) {
  const int q = a.st >= 0 ? a.st : 0;
  const int st = __shfl_sync(kFull, b.st, q);
  const int cnt = __shfl_sync(kFull, b.cnt, q);
  return a.st >= 0 ? Rec{st, a.cnt + cnt} : a;
}

// Frame maps: st >= 0 the exit offset into the next segment, warp run or tile;
// st < 0 STOP at the terminal -1 - st (an entry of the row, from start); cnt the
// chain entries passed.  One block a tile of warps x SPW segments of 32.
template <int SPW>
__global__ void __launch_bounds__(1024)
chain_frames_kernel(const long long* __restrict__ succ, long long m, long long start, long long k,
                    int n_tiles, int n_ids, int* __restrict__ flags, int2* __restrict__ agg,
                    int2* __restrict__ inc, long long* __restrict__ out) {
  __shared__ Rec pre[2][kMaxWarps][kLanes];  // the warps' maps, scanned (double buffer)
  __shared__ Rec tile_in;                    // the walk's entry into the tile and its rank
  __shared__ int tile_id;
  const int lane = threadIdx.x & (kLanes - 1), w = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  if (threadIdx.x == 0) tile_id = atomicAdd(flags + n_ids, 1);
  __syncthreads();
  const int id = tile_id, row = id / n_tiles, b = id - row * n_tiles;
  const long long n = m - start;
  const long long lo = (static_cast<long long>(b) * n_warps + w) * (SPW * kLanes);  // from start
  const long long* src = succ + static_cast<long long>(row) * m + start;

  long long v[SPW];  // every load in flight before the first shuffle
#pragma unroll
  for (int s = 0; s < SPW; ++s) {
    const long long i = lo + s * kLanes + lane;
    v[s] = i < n ? src[i] : start + i;  // past the row's end: fixed points, never reached
  }
  unsigned lv[SPW];  // the pointers of the 5 rounds, 6 bits each (kNone: left or stopped)
  Rec mp[SPW];       // the segments' maps
#pragma unroll
  for (int s = 0; s < SPW; ++s) {
    const long long base = lo + s * kLanes;
    const int d = static_cast<int>(v[s] - (start + base + lane));
    int p = d == 0 ? -1 - lane : lane + d;  // < 0 stop at -1 - p; [0, 32) inside; else exit
    int c = 1;
    unsigned word = 0;
#pragma unroll
    for (int r = 0; r < 5; ++r) {  // p = succ^(2^(r+1)) from the lane's entry
      const bool in = p >= 0 && p < kLanes;
      word |= static_cast<unsigned>(in ? p : kNone) << (6 * r);
      const int q = in ? p : lane;
      const int pq = __shfl_sync(kFull, p, q);
      const int cq = __shfl_sync(kFull, c, q);
      if (in) {
        p = pq;
        c += cq;
      }
    }
    lv[s] = word;
    mp[s] = p < 0 ? Rec{static_cast<int>(-1 - (base + (-1 - p))), c} : Rec{p - kLanes, c};
  }
  Rec run = mp[0];
#pragma unroll
  for (int s = 1; s < SPW; ++s) run = then_warp(run, mp[s]);
  pre[0][w][lane] = run;
  int cur = 0;
  for (int off = 1; off < n_warps; off *= 2) {  // inclusive scan over the warps
    __syncthreads();
    Rec x = pre[cur][w][lane];
    if (w >= off) {
      const Rec a = pre[cur][w - off][lane];
      x = a.st >= 0 ? Rec{pre[cur][w][a.st].st, a.cnt + pre[cur][w][a.st].cnt} : a;
    }
    pre[cur ^ 1][w][lane] = x;
    cur ^= 1;
  }
  __syncthreads();
  const Rec* whole = pre[cur][n_warps - 1];  // the tile's map
  const int first_id = row * n_tiles;
  const bool last = b == n_tiles - 1;  // no tile looks back at the row's last
  if (w == 0) {
    Rec in{0, 0};
    if (b > 0) {
      if (!last) {
        agg[static_cast<long long>(id) * kLanes + lane] =
            make_int2(whole[lane].st, whole[lane].cnt);
        __threadfence();
        __syncwarp();
        if (lane == 0) st_release(flags + id, 1);
      }
      Rec c{lane, 0};  // the maps of the tiles after the one found, folded: identity at first
      for (int j = b - 1;; j -= kLanes) {
        const int t = j - lane;
        int f = 0;
        if (t >= 0) {
          do {
            f = ld_acquire(flags + first_id + t);
          } while (f == 0);
        }
        const unsigned ready = __ballot_sync(kFull, f == 2);
        const int upto = ready ? __ffs(ready) - 1 : kLanes;
        __threadfence();
        for (int i0 = 0; i0 < upto; i0 += kFold) {  // kFold maps' loads in flight at once
          int2 a[kFold];
#pragma unroll
          for (int u = 0; u < kFold; ++u) {
            if (i0 + u < upto) {
              a[u] = __ldcg(agg + static_cast<long long>(first_id + j - i0 - u) * kLanes + lane);
            }
          }
#pragma unroll
          for (int u = 0; u < kFold; ++u) {
            if (i0 + u < upto) c = then_warp(Rec{a[u].x, a[u].y}, c);
          }
        }
        if (ready) {
          const int2 x = __ldcg(inc + first_id + j - upto);
          in = Rec{x.x, x.y};
          if (in.st >= 0) {
            const int st = __shfl_sync(kFull, c.st, in.st);
            const int cnt = __shfl_sync(kFull, c.cnt, in.st);
            in = Rec{st, in.cnt + cnt};
          }
          break;
        }
      }
    }
    if (lane == 0) {
      tile_in = in;
      if (!last) {
        const Rec e = in.st >= 0 ? Rec{whole[in.st].st, in.cnt + whole[in.st].cnt} : in;
        inc[id] = make_int2(e.st, e.cnt);
        __threadfence();
        st_release(flags + id, 2);
      }
    }
  }
  __syncthreads();
  long long* orow = out + static_cast<long long>(row) * k;
  Rec x = tile_in;
  if (w > 0 && x.st >= 0) {
    const Rec p = pre[cur][w - 1][x.st];
    x = Rec{p.st, x.cnt + p.cnt};
  }
#pragma unroll
  for (int s = 0; s < SPW; ++s) {
    if (x.st < 0 || x.cnt >= k) break;  // the same for every lane
    int pos = lane == 0 ? x.st : kNone;     // lane i: chain[rank + i], by doubling from the entry
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int q = __shfl_sync(kFull, pos, lane >= (1 << r) ? lane - (1 << r) : 0);
      const unsigned lq = __shfl_sync(kFull, lv[s], q == kNone ? 0 : q);
      if (lane >= (1 << r) && lane < (2 << r)) pos = q == kNone ? kNone : (lq >> (6 * r)) & 63;
    }
    const long long j = x.cnt + lane;
    if (pos != kNone && j < k) orow[j] = start + lo + s * kLanes + pos;
    x = then_warp(x, mp[s]);
  }
  if (last) {  // the row's walk ends at a fixed point: the terminal repeats to k
    const Rec in = tile_in;
    const Rec e = in.st >= 0 ? Rec{whole[in.st].st, in.cnt + whole[in.st].cnt} : in;
    const long long term = start + (-1 - e.st);
    for (long long j = e.cnt + threadIdx.x; j < k; j += blockDim.x) orow[j] = term;
  }
}

int frame_tiles(long long m, long long start, int warps, int spw) {
  const long long tile = 1LL * warps * spw * kLanes;
  return static_cast<int>((m - start + tile - 1) / tile);
}

bool frames_args_ok(int rows, long long m, long long start, long long k, int warps, int spw) {
  if (rows < 1 || m < 1 || m >= (1LL << 31) || start < 0 || start >= m || k < 1 ||
      k >= (1LL << 31) || warps < 1 || warps > kMaxWarps) {
    return false;
  }
  if (spw != 1 && spw != 2 && spw != 4 && spw != 8) return false;
  return 1LL * rows * frame_tiles(m, start, warps, spw) < (1LL << 31) / kLanes;
}

}  // namespace

// Bytes of scratch chain_walk_segments needs, or -1 if it does not take these
// arguments.
extern "C" long long axctd_chain_segments_scratch(int rows, long long m, long long start,
                                                  long long k, int sb, int seg, int tpb) {
  if (!segments_args_ok(rows, m, start, k, sb, seg, tpb)) return -1;
  return make_plan(rows, m, start, sb, seg, tpb).bytes;
}

extern "C" int axctd_chain_segments_launch(const long long* nxt, int rows, long long m,
                                           long long start, long long k, int sb, int seg, int tpb,
                                           void* scratch, long long* out, void* stream) {
  if (!segments_args_ok(rows, m, start, k, sb, seg, tpb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#ifdef AXCTD_CHAIN_VARIANTS
  if (sb == kFrameStride) {
    return segments<kFrameStride>(nxt, rows, m, start, k, seg, tpb,
                                  static_cast<unsigned char*>(scratch), out,
                                  static_cast<cudaStream_t>(stream));
  }
#endif
  return segments<kStride>(nxt, rows, m, start, k, seg, tpb, static_cast<unsigned char*>(scratch),
                           out, static_cast<cudaStream_t>(stream));
}

// Tiles of one chain_walk_frames call (its flags are one more int32, the
// counter, zeroed; its records 33 int2 a tile), or -1 if it does not take
// these arguments.
extern "C" long long axctd_chain_frames_tiles(int rows, long long m, long long start, long long k,
                                              int warps, int spw) {
  if (!frames_args_ok(rows, m, start, k, warps, spw)) return -1;
  return static_cast<long long>(rows) * frame_tiles(m, start, warps, spw);
}

extern "C" int axctd_chain_frames_launch(const long long* succ, int rows, long long m,
                                         long long start, long long k, int warps, int spw,
                                         int* flags, void* recs, long long* out, void* stream) {
  if (!frames_args_ok(rows, m, start, k, warps, spw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = frame_tiles(m, start, warps, spw);
  const int n_ids = rows * n_tiles;
  int2* agg = static_cast<int2*>(recs);
  int2* inc = agg + static_cast<long long>(n_ids) * kLanes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = warps * kLanes;
  switch (spw) {
    case 1:
      chain_frames_kernel<1><<<n_ids, threads, 0, s>>>(succ, m, start, k, n_tiles, n_ids, flags,
                                                       agg, inc, out);
      break;
    case 2:
      chain_frames_kernel<2><<<n_ids, threads, 0, s>>>(succ, m, start, k, n_tiles, n_ids, flags,
                                                       agg, inc, out);
      break;
    case 4:
      chain_frames_kernel<4><<<n_ids, threads, 0, s>>>(succ, m, start, k, n_tiles, n_ids, flags,
                                                       agg, inc, out);
      break;
    default:
      chain_frames_kernel<8><<<n_ids, threads, 0, s>>>(succ, m, start, k, n_tiles, n_ids, flags,
                                                       agg, inc, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int axctd_chain_walk_launch(const long long* levels, int n_levels, int rows,
                                       long long m, int start, long long k, int first,
                                       long long* out, void* stream) {
  if (rows <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  if (first < 1 || first > kMaxFirst || n_levels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = first < 32 ? 32 : first;
  chain_walk_kernel<long long><<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, n_levels, static_cast<long long>(rows) * m, m, start, k, first, out);
  return static_cast<int>(cudaGetLastError());
}
