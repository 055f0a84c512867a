// Occupancy bitmaps with ranks, shared by the hard voxelizer (kernel K10,
// voxelize.cu) and the sparse encoder's active sets (kernel K11,
// active_set.cu).
//
// A bitmap holds one bit per cell of a grid, 32 cells a word over the flat
// cell index.  Its words are padded to whole scan tiles (kTileWords) and
// zeroed at that length, so the scan reads whole tiles without a guard.
// base[w] is the number of set bits in the words before w, so the rank of a
// set cell c, its place among the set cells in ascending flat order, is
// base[c >> 5] + popc(bits[c >> 5] & ((1 << (c & 31)) - 1)): the layout of
// ops/sparse_conv.py::CompactTable, which K6 and K8 read.
//
// The scan of the per-word counts is three launches: each tile of 2048
// words sums its counts (tile_counts); one block scans the tile sums and
// writes the total of set bits (scan_tile_sums); each tile scans its words
// from its offset and writes base (tile_bases).  The bitmaps the port scans
// are 10 MB at most (the LiDAR voxel grid's 82.9 M cells) and stay in the
// 50 MB L2 between the launches.  The bitmap is zeroed by fill_words, a
// kernel and not a memset, so that a profile puts its time under its
// kernel.  Every __global__ function here takes the kernel's number as a
// template argument (10 or 11), so a profile tells K10's launches from
// K11's.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScanThreads = 256;
constexpr int kWordsPerThread = 8;
constexpr int kTileWords = kScanThreads * kWordsPerThread;

// the rank of cell `cell`, which must be set
__device__ __forceinline__ int bitmap_rank(const unsigned* __restrict__ bits,
                                           const int* __restrict__ base,
                                           long long cell) {
  const long long w = cell >> 5;
  const unsigned below = (1u << (cell & 31)) - 1u;
  return base[w] + __popc(bits[w] & below);
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

__device__ __forceinline__ void word_counts(const uint4* __restrict__ bits,
                                            long long q, int (&c)[8]) {
  const uint4 a = bits[q], b = bits[q + 1];
  c[0] = __popc(a.x); c[1] = __popc(a.y); c[2] = __popc(a.z);
  c[3] = __popc(a.w); c[4] = __popc(b.x); c[5] = __popc(b.y);
  c[6] = __popc(b.z); c[7] = __popc(b.w);
}

template <int Kernel>
__global__ void __launch_bounds__(kScanThreads)
fill_words(unsigned* __restrict__ p, long long n, unsigned value) {
  for (long long i = (long long)blockIdx.x * kScanThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kScanThreads)
    p[i] = value;
}

// n words of p set to value (n > 0)
template <int Kernel>
inline void fill(unsigned* p, long long n, unsigned value, cudaStream_t s) {
  const long long blocks = (n + kScanThreads - 1) / kScanThreads;
  fill_words<Kernel><<<(unsigned)(blocks < 4096 ? blocks : 4096),
                       kScanThreads, 0, s>>>(p, n, value);
}

template <int Kernel>
__global__ void __launch_bounds__(kScanThreads)
tile_counts(const uint4* __restrict__ bits, int* __restrict__ tile_sums) {
  int c[8];
  word_counts(bits, (long long)blockIdx.x * (kTileWords / 4) + threadIdx.x * 2,
              c);
  int sum;
  block_exclusive_scan(c[0] + c[1] + c[2] + c[3] + c[4] + c[5] + c[6] + c[7],
                       &sum);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = sum;
}

// one block: tile_sums[0, n) becomes its exclusive prefix; *total the sum
template <int Kernel>
__global__ void __launch_bounds__(1024)
scan_tile_sums(int* __restrict__ tile_sums, int n, int* __restrict__ total) {
  int carry = 0;
  for (int start = 0; start < n; start += blockDim.x) {
    const int i = start + threadIdx.x;
    const int v = i < n ? tile_sums[i] : 0;
    int chunk;
    const int before = block_exclusive_scan(v, &chunk);
    if (i < n) tile_sums[i] = carry + before;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = carry;
}

template <int Kernel>
__global__ void __launch_bounds__(kScanThreads)
tile_bases(const uint4* __restrict__ bits, const int* __restrict__ offsets,
           int4* __restrict__ base) {
  const long long q =
      (long long)blockIdx.x * (kTileWords / 4) + threadIdx.x * 2;
  int c[8];
  word_counts(bits, q, c);
  int sum;
  int run = offsets[blockIdx.x] + block_exclusive_scan(
      c[0] + c[1] + c[2] + c[3] + c[4] + c[5] + c[6] + c[7], &sum);
  int4 lo, hi;
  lo.x = run; run += c[0];
  lo.y = run; run += c[1];
  lo.z = run; run += c[2];
  lo.w = run; run += c[3];
  hi.x = run; run += c[4];
  hi.y = run; run += c[5];
  hi.z = run; run += c[6];
  hi.w = run;
  base[q] = lo;
  base[q + 1] = hi;
}

// base and *total of a bitmap of `padded` words (a multiple of kTileWords,
// both arrays 16-byte aligned); `tile_sums` holds padded / kTileWords ints
template <int Kernel>
inline void scan_bitmap(const unsigned* bits, int* base, int* tile_sums,
                        int* total, long long padded, cudaStream_t s) {
  const unsigned tiles = (unsigned)(padded / kTileWords);
  const uint4* words = reinterpret_cast<const uint4*>(bits);
  tile_counts<Kernel><<<tiles, kScanThreads, 0, s>>>(words, tile_sums);
  scan_tile_sums<Kernel><<<1, 1024, 0, s>>>(tile_sums, (int)tiles, total);
  tile_bases<Kernel><<<tiles, kScanThreads, 0, s>>>(
      words, tile_sums, reinterpret_cast<int4*>(base));
}

}  // namespace
