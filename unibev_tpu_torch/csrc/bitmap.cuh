// Occupancy bitmaps with ranks, shared by the hard voxelizer (kernel K10,
// voxelize.cu) and the sparse encoder's active sets (kernel K11,
// active_set.cu).
//
// A bitmap holds one bit per cell of a grid, 32 cells a word over the flat
// cell index.  Its words are padded to whole scan tiles (kTileWords) and
// zeroed at that length, so the scan reads whole tiles without a guard.
// The scan gives each word, or each 32-byte sector of 8 words, the number
// of set bits before it, so the rank of a set cell c, its place among the
// set cells in ascending flat order, is base[c >> 5] + popc(bits[c >> 5] &
// ((1 << (c & 31)) - 1)) with a base per word: the layout of
// ops/sparse_conv.py::CompactTable, which K6 and K8 read.
//
// What bounds the scan: bytes (the bitmap read once and its counts written
// once: 10.4 MB each at the LiDAR voxel grid's 82.9 M cells, in the 50 MB
// L2) and latency (at the small bitmaps of the strided convs, a launch's).
// So it is one launch, a single pass with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA NVR-2016-002), not three (the tiles' sums, one block scanning
// them, the tiles' bases):
//   * a block takes its tile from a ticket (atomicAdd), so every tile it
//     waits on belongs to a block that has started, whatever order the SMs
//     take blocks in;
//   * it stages its 8192 words (32 KB) in shared memory with coalesced
//     16-byte loads, and each thread counts 32 consecutive words;
//   * it publishes its aggregate and then its inclusive prefix in one
//     64-bit status word per tile (the flag above the value; st.release,
//     read with ld.acquire), and warp 0 finds the tile's prefix by a look
//     back over 32 predecessors at a time;
//   * it writes its counts once, coalesced (per word through the stage, or
//     one int4 of 4 sectors a thread); the last tile writes the total.
// The tiles are 8192 words, so a bitmap of the port has at most 325 (the
// res-0 grid), all resident at once: 2048- and 4096-word tiles scanned the
// res-0 grid in 0.0125 and 0.0105 ms against 0.0102-0.0105 and K10's
// LiDAR grid in 0.0105 and 0.0087 against 0.0079-0.0080, and 4 windows of
// look-back a step or relaxed loads gained nothing
// (unibev_tpu_torch/tools/bitmap_study.py; PERF.md section 6).  A 1-tile
// scan still takes ~0.003 ms: a launch, the ticket's round trip and the
// tile's loads and stores one after another.  The status words and the
// ticket (the scan state) are zeroed by the call's own fill launch, which
// also zeroes the bitmap, so the reset is in stream order and a CUDA graph
// of a call replays it.  Every __global__ function here takes the kernel's
// number as its first template argument (10 or 11), so a profile tells
// K10's launches from K11's.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFillThreads = 256;
constexpr int kScanThreads = 256;
constexpr int kVectorsPerThread = 8;            // uint4s: 32 words
constexpr int kTileVectors = kScanThreads * kVectorsPerThread;
constexpr int kTileWords = 4 * kTileVectors;    // 8192
constexpr int kLookBackWindows = 1;             // of 32 tiles a step
// the status word of a tile: its flag in the high half, its value below
constexpr unsigned kStatusNotReady = 0, kStatusAggregate = 1,
                   kStatusPrefix = 2;

// int32 words of the scan state of `tiles` tiles: a 64-bit status word per
// tile, the ticket and the total, rounded up to 16 bytes
inline long long scan_state_words(long long tiles) {
  return (2 * tiles + 2 + 3) / 4 * 4;
}

struct ScanState {
  unsigned long long* status;   // tiles status words
  unsigned* ticket;             // the next tile to take
  int* total;                   // the set bits of the whole bitmap
  long long tiles;
};

inline long long round4(long long n) { return (n + 3) / 4 * 4; }
inline long long blocks_of(long long n, int threads) {
  return (n + threads - 1) / threads;
}
// blocks of a fill of n items (grid-stride beyond 4096)
inline long long fill_blocks(long long n) {
  const long long b = blocks_of(n, kFillThreads);
  return b < 4096 ? b : 4096;
}

// the scan state laid out at `p` (16-byte aligned)
inline ScanState scan_state_at(int* p, long long tiles) {
  ScanState s;
  s.status = reinterpret_cast<unsigned long long*>(p);
  s.ticket = reinterpret_cast<unsigned*>(p + 2 * tiles);
  s.total = p + 2 * tiles + 1;
  s.tiles = tiles;
  return s;
}

// the rank of cell `cell`, which must be set, from a base per word
__device__ __forceinline__ int bitmap_rank(const unsigned* __restrict__ bits,
                                           const int* __restrict__ base,
                                           long long cell) {
  const long long w = cell >> 5;
  const unsigned below = (1u << (cell & 31)) - 1u;
  return base[w] + __popc(bits[w] & below);
}

// the same from a count per 32-byte sector of 8 words: the sector that
// holds the cell's word is read whole
__device__ __forceinline__ int sector_rank(const unsigned* __restrict__ bits,
                                           const int* __restrict__ dir,
                                           long long cell) {
  const long long w = cell >> 5;
  const uint4* s = reinterpret_cast<const uint4*>(bits) + ((w >> 3) << 1);
  const uint4 a = s[0], b = s[1];
  const unsigned words[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int k = (int)(w & 7);
  const unsigned below = (1u << (cell & 31)) - 1u;
  int r = dir[w >> 3];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    r += __popc(words[j] & (j < k ? ~0u : j == k ? below : 0u));
  return r;
}

__device__ __forceinline__ void set_bit(unsigned* bits, long long cell) {
  atomicOr(bits + (cell >> 5), 1u << (cell & 31));
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

// The exclusive prefix of `v` over the block's threads (a multiple of 32, at
// most 1024); `*sum` gets the block's sum.  Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sum) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int incl = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int s = warp_inclusive_scan(lane < warps ? warp_sums[lane] : 0);
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *sum = warp_sums[warps - 1];
  __syncthreads();
  return before + incl - v;
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// The first n_zero uint4s of `zero` set to 0, then the n_set words of `set`
// to `value`, in one grid-stride pass.
template <int Kernel>
__global__ void __launch_bounds__(kFillThreads)
fill_words(uint4* __restrict__ zero, long long n_zero,
           unsigned* __restrict__ set, long long n_set, unsigned value) {
  for (long long i = (long long)blockIdx.x * kFillThreads + threadIdx.x;
       i < n_zero + n_set; i += (long long)gridDim.x * kFillThreads) {
    if (i < n_zero)
      zero[i] = make_uint4(0u, 0u, 0u, 0u);
    else
      set[i - n_zero] = value;
  }
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long status_word(unsigned flag,
                                                          int value) {
  return ((unsigned long long)flag << 32) | (unsigned)value;
}

__device__ __forceinline__ unsigned status_flag(unsigned long long s) {
  return (unsigned)(s >> 32);
}

// Warp 0 of the block of tile `tile`, whose set bits are `aggregate`:
// publishes the aggregate, looks back over the predecessors' status words
// in windows of 32 (lane 0 the nearest; kLookBackWindows windows loaded a
// step), until one holds an inclusive prefix, publishes the tile's own
// inclusive prefix and returns its exclusive one.
__device__ __forceinline__ int look_back(const ScanState& st, long long tile,
                                         int aggregate) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0)
      store_release(st.status, status_word(kStatusPrefix, aggregate));
    return 0;
  }
  if (lane == 0)
    store_release(st.status + tile, status_word(kStatusAggregate, aggregate));
  int prefix = 0;
  for (long long end = tile;; end -= 32 * kLookBackWindows) {
    // before tile 0: nothing, as if a prefix of 0
    unsigned long long s[kLookBackWindows];
#pragma unroll
    for (int w = 0; w < kLookBackWindows; ++w) {
      const long long j = end - 1 - lane - 32 * w;
      s[w] = j >= 0 ? load_acquire(st.status + j)
                    : status_word(kStatusPrefix, 0);
    }
    bool found = false;
#pragma unroll
    for (int w = 0; w < kLookBackWindows; ++w) {
      if (found) break;
      const long long j = end - 1 - lane - 32 * w;
      while (status_flag(s[w]) == kStatusNotReady)
        s[w] = load_acquire(st.status + j);
      const unsigned done =
          __ballot_sync(0xffffffffu, status_flag(s[w]) == kStatusPrefix);
      // the lanes up to the nearest inclusive prefix, or all 32
      const int last = done ? __ffs(done) - 1 : 31;
      prefix += __reduce_add_sync(0xffffffffu,
                                  lane <= last ? (int)(unsigned)s[w] : 0);
      found = done != 0;
    }
    if (found) break;
  }
  if (lane == 0)
    store_release(st.status + tile,
                  status_word(kStatusPrefix, prefix + aggregate));
  return prefix;
}

// A block's tile from the ticket (every thread gets it)
__device__ __forceinline__ long long take_tile(unsigned* ticket) {
  __shared__ unsigned taken;
  if (threadIdx.x == 0) taken = atomicAdd(ticket, 1u);
  __syncthreads();
  return taken;
}

// 16-byte vector v of a staged tile, with one pad vector after every 8, so
// that neither a thread's 8 consecutive vectors nor 8 threads' vectors at
// one place share a bank
__device__ __forceinline__ int staged(int v) { return v + (v >> 3); }

// The single-pass scan: one block a tile, st.tiles blocks of kScanThreads.
// `dir` gets the set bits before each word (Stride 1, a CompactTable's
// base) or before each 8-word sector (Stride 8).
template <int Kernel, int Stride>
__global__ void __launch_bounds__(kScanThreads)
scan_tiles(const uint4* __restrict__ bits, int* __restrict__ dir,
           ScanState st) {
  static_assert(Stride == 1 || Stride == 8, "a base per word or per sector");
  __shared__ uint4 stage[kTileVectors + kTileVectors / 8];
  __shared__ int tile_prefix;
  const long long tile = take_tile(st.ticket);
  const int t = threadIdx.x;
  const uint4* src = bits + tile * kTileVectors;
#pragma unroll
  for (int i = 0; i < kVectorsPerThread; ++i)
    stage[staged(i * kScanThreads + t)] = src[i * kScanThreads + t];
  __syncthreads();
  // this thread's 32 consecutive words
  uint4 mine[kVectorsPerThread];
  int count[kVectorsPerThread];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kVectorsPerThread; ++j) {
    mine[j] = stage[staged(t * kVectorsPerThread + j)];
    count[j] = popc4(mine[j]);
    sum += count[j];
  }
  int block_sum;
  const int before = block_exclusive_scan(sum, &block_sum);
  if (t < 32) {
    const int prefix = look_back(st, tile, block_sum);
    if (t == 0) tile_prefix = prefix;
  }
  __syncthreads();
  int run = tile_prefix + before;
  if (Stride == 8) {
    // the thread's 4 sectors (2 vectors each) as one int4
    int4 d;
    d.x = run; run += count[0] + count[1];
    d.y = run; run += count[2] + count[3];
    d.z = run; run += count[4] + count[5];
    d.w = run;
    reinterpret_cast<int4*>(dir)[tile * kScanThreads + t] = d;
  } else {
    // every thread read its words before the barriers above: the stage
    // takes the bases, which then go out coalesced
#pragma unroll
    for (int j = 0; j < kVectorsPerThread; ++j) {
      uint4 b;
      b.x = run; run += __popc(mine[j].x);
      b.y = run; run += __popc(mine[j].y);
      b.z = run; run += __popc(mine[j].z);
      b.w = run; run += __popc(mine[j].w);
      stage[staged(t * kVectorsPerThread + j)] = b;
    }
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(dir) + tile * kTileVectors;
#pragma unroll
    for (int i = 0; i < kVectorsPerThread; ++i)
      dst[i * kScanThreads + t] = stage[staged(i * kScanThreads + t)];
  }
  if (tile == st.tiles - 1 && t == 0) *st.total = tile_prefix + block_sum;
}

}  // namespace
