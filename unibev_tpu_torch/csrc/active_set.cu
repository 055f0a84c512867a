// The sparse encoder's compact tables (kernel K11 of the port): the cell ->
// row table of an active set, and the active set of a strided conv with its
// table.
//
// Replaces the XLA ops unibev_tpu/ops/sparse_conv.py::build_table (:154),
// the dense cell -> row table, and downsample_with_table (:883) /
// downsample_active_set (:987), the output sites of a strided conv: every
// site whose window covers a live row, in ascending flat order, the first
// `capacity` kept.  Their plain PyTorch counterparts, ops/sparse_conv.py::
// build_table_reference (a sort of the rows' cells) and
// downsample_with_table_reference (a byte per output cell, per-byte counts
// and a search of them), take ~40 launches a call; a forward makes five
// calls.  Both modes write ops/sparse_conv.py::CompactTable: the bitmap
// over the flat cells ((b * D + z) * H + y) * W + x, the set bits before
// each word (bitmap.cuh), and the row of each rank, which K6 and K8 read.
//
// One C entry point a call and six launches: the bitmap's fill, mark, the
// three of the bitmap scan, and a mode's last launch.  No sort, no search, no
// host synchronization.
//   * mode 0, build_table: a thread per live row sets its own cell's bit;
//     after the scan a thread per row writes rows[rank(cell)] = v (the
//     rank comes from the bitmap: the live rows' cells are distinct, as the
//     voxelizer gives them) and, for v at or past the live count, rows[v]
//     = V, the sentinel: entries a lookup never reads, since it tests the
//     bit first.
//   * mode 1, downsample: a thread per live row sets the bits of the at
//     most ceil(k / s) sites per axis whose window holds it (8 for k3 s2, 2
//     for conv_out's (3, 1, 1) s(2, 1, 1)); after the scan a warp per group
//     of at most 32 output words writes the coords of their set cells at
//     ranks base[w] + j below the capacity, and a thread per rank below the
//     capacity writes mask_out = rank < total, rows = the rank (the map is
//     the identity: a site past the capacity reads the sentinel), and -1
//     coords past the total; thread 0 writes overflow = max(total -
//     capacity, 0).
// What bounds it: the bitmap, 10.6 MB at res 0 (B = 1) and 1.4 MB at res 1,
// zeroed and scanned in L2, and the launches' latency: the rows, coords and
// maps are a few MB.

#include <cstdint>

#include "bitmap.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSites = 4;   // sites per axis that may hold one input cell

__device__ __forceinline__ long long flat_cell(long long b, long long z,
                                               long long y, long long x,
                                               int D, int H, int W) {
  return ((b * D + z) * H + y) * W + x;
}

// The sites o of an axis of `n` output cells whose window holds input
// coordinate i: o * s - p <= i < o * s - p + k, the counterpart of
// ops/sparse_conv.py::_site_tables.  Returns how many, at most kMaxSites.
__device__ __forceinline__ int axis_sites(int i, int k, int s, int p, int n,
                                          int (&o)[kMaxSites]) {
  const int hi = (i + p) / s;       // i + p >= 0
  int m = 0;
#pragma unroll
  for (int j = 0; j < kMaxSites; ++j) {
    const int c = hi - j;
    if (j * s < k && c >= 0 && c < n && c * s - p + k > i) o[m++] = c;
  }
  return m;
}

__global__ void __launch_bounds__(kThreads)
mark_rows(const int* __restrict__ coords, const bool* __restrict__ mask, int V,
          int D, int H, int W, unsigned* __restrict__ bits) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V || !mask[v]) return;
  const int* c = coords + 4 * (long long)v;
  set_bit(bits, flat_cell(c[0], c[1], c[2], c[3], D, H, W));
}

// Where the candidate sites outnumber the output words 4 to 1 (Aggregate),
// rows of one warp (consecutive ranks, so neighbouring cells) mark mostly
// the same words: the lanes that set bits of one word OR them together
// first and one of them adds them with a single atomicOr, which takes the
// contention off the few words of res 2-3 (480k candidates into 5,063
// words at res 2).  On a sparse output (res 0 -> 1: 960k candidates over
// 340,200 words) the matching costs more than it saves, so each lane adds
// its own bits there (PERF.md section 6 has both times).
template <bool Aggregate>
__global__ void __launch_bounds__(kThreads)
mark_sites(const int* __restrict__ coords, const bool* __restrict__ mask,
           int V, int kz, int ky, int kx, int sz, int sy, int sx, int pz,
           int py, int px, int Do, int Ho, int Wo,
           unsigned* __restrict__ bits) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const bool live = v < V && mask[v];
  const int* c = coords + 4 * (long long)(live ? v : 0);
  int oz[kMaxSites], oy[kMaxSites], ox[kMaxSites];
  const int nz = live ? axis_sites(c[1], kz, sz, pz, Do, oz) : 0;
  const int ny = live ? axis_sites(c[2], ky, sy, py, Ho, oy) : 0;
  const int nx = live ? axis_sites(c[3], kx, sx, px, Wo, ox) : 0;
  // the whole warp runs every candidate any lane has
  const int mz = __reduce_max_sync(0xffffffffu, nz);
  const int my = __reduce_max_sync(0xffffffffu, ny);
  const int mx = __reduce_max_sync(0xffffffffu, nx);
  const long long b = live ? c[0] : 0;
  for (int i = 0; i < mz; ++i)
    for (int j = 0; j < my; ++j)
      for (int k = 0; k < mx; ++k) {
        const bool set = i < nz && j < ny && k < nx;
        const long long cell =
            set ? flat_cell(b, oz[i], oy[j], ox[k], Do, Ho, Wo) : 0;
        if (!Aggregate) {
          if (set) set_bit(bits, cell);
          continue;
        }
        // word indices fit 31 bits (the wrapper); ~0u marks no word
        const unsigned w = set ? (unsigned)(cell >> 5) : ~0u;
        const unsigned peers = __match_any_sync(0xffffffffu, w);
        const unsigned word =
            __reduce_or_sync(peers, set ? 1u << (cell & 31) : 0u);
        if (set && (threadIdx.x & 31) == __ffs(peers) - 1)
          atomicOr(bits + w, word);
      }
}

__global__ void __launch_bounds__(kThreads)
build_rows(const int* __restrict__ coords, const bool* __restrict__ mask,
           int V, int D, int H, int W, const unsigned* __restrict__ bits,
           const int* __restrict__ base, const int* __restrict__ total,
           int* __restrict__ rows) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;
  if (v >= *total) rows[v] = V;
  if (!mask[v]) return;
  const int* c = coords + 4 * (long long)v;
  rows[bitmap_rank(bits, base, flat_cell(c[0], c[1], c[2], c[3], D, H, W))] =
      v;
}

// The place of the n-th (from 0) set bit of w, which has more than n.
__device__ __forceinline__ int nth_set_bit(unsigned w, int n) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width > 0; width >>= 1) {
    const int c = __popc(w & ((1u << width) - 1u));
    if (n >= c) {
      n -= c;
      w >>= width;
      pos += width;
    }
  }
  return pos;
}

// (b, z, y, x) of a flat cell of the (Do, Ho, Wo) grid; 32-bit division
// where the grid's cells fit
__device__ __forceinline__ int4 decode_cell(long long cell, bool narrow,
                                            int Do, int Ho, int Wo) {
  if (narrow) {
    unsigned q = (unsigned)cell;
    const int x = (int)(q % Wo);
    q /= Wo;
    const int y = (int)(q % Ho);
    q /= Ho;
    return make_int4((int)(q / Do), (int)(q % Do), y, x);
  }
  const int x = (int)(cell % Wo);
  cell /= Wo;
  const int y = (int)(cell % Ho);
  cell /= Ho;
  return make_int4((int)(cell / Do), (int)(cell % Do), y, x);
}

// A warp per `group` consecutive words (a power of two, at most 32): their
// set cells hold consecutive ranks from the first word's base, so the warp
// writes them as consecutive rows, each lane finding its rank's word by a
// search of the warp's running counts (5 shuffles) and its bit by a search
// of the word.  The entry point sizes the group so that a warp writes about
// 32 rows when the sites below the capacity fill their words: the ranks
// below the capacity lie in the first words, so a warp that owns more of
// them loops while others idle.  (A thread per word that wrote its cells
// one after another was several times slower on the dense outputs of res
// 2-3, ~20 set cells a word: PERF.md section 6.)  Threads below the
// capacity also write the mask, the identity map and the -1 coords past
// the total.
__global__ void __launch_bounds__(kThreads)
emit_sites(const unsigned* __restrict__ bits, const int* __restrict__ base,
           long long words, int group, const int* __restrict__ total,
           int capacity, int Do, int Ho, int Wo, int4* __restrict__ coords_out,
           bool* __restrict__ mask_out, int* __restrict__ rows,
           long long* __restrict__ overflow) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int live = *total;
  if (t == 0) *overflow = live > capacity ? live - capacity : 0;
  const long long w0 = (t >> 5) * group;
  if (w0 < words) {                              // the whole warp
    const long long w = w0 + lane;
    const unsigned word = lane < group && w < words ? bits[w] : 0u;
    const int count = __popc(word);
    const int incl = warp_inclusive_scan(count);
    const int first = __shfl_sync(0xffffffffu, lane == 0 ? base[w0] : 0, 0);
    const int all = __shfl_sync(0xffffffffu, incl, 31);
    const int n = all < capacity - first ? all : capacity - first;
    const bool narrow = words * 32 <= 0xffffffffLL;
    for (int k0 = 0; k0 < n; k0 += 32) {
      const int k = k0 + lane;
      int owner = 0;                             // lanes whose incl <= k
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(0xffffffffu, incl, owner + step - 1) <= k)
          owner += step;
      const unsigned own = __shfl_sync(0xffffffffu, word, owner);
      const int before = __shfl_sync(0xffffffffu, incl - count, owner);
      if (k < n)
        coords_out[first + k] = decode_cell(
            (w0 + owner) * 32 + nth_set_bit(own, k - before), narrow, Do, Ho,
            Wo);
    }
  }
  if (t < capacity) {
    const bool kept = t < live;
    mask_out[t] = kept;
    rows[t] = (int)t;
    if (!kept) coords_out[t] = make_int4(-1, -1, -1, -1);
  }
}

}  // namespace

// coords (V, 4) int32 (b, z, y, x) and mask (V,) bool of the input rows on
// the (batch, D, H, W) grid.  mode 0 (build_table): the table of those
// rows; rows (V,) int32.  mode 1 (downsample): the sites of the strided
// conv (kernel, stride, padding) on the (batch, Do, Ho, Wo) output grid,
// the first `capacity` of them: coords_out (capacity, 4) int32, mask_out
// (capacity,) bool, rows (capacity,) int32, overflow () int64.  work: int32
// words [bitmap padded | base padded | tile sums padded / kTileWords | total
// 1], `work_words` of them; `padded` is the output bitmap's words rounded up
// to kTileWords.  Returns the cudaError_t of the launches.
extern "C" int unibev_active_set(const void* coords, const void* mask, int V,
                                 int batch, int D, int H, int W, int mode,
                                 int kz, int ky, int kx, int sz, int sy,
                                 int sx, int pz, int py, int px, int Do,
                                 int Ho, int Wo, int capacity, void* rows,
                                 void* coords_out, void* mask_out,
                                 void* overflow, void* work, long long padded,
                                 long long work_words, void* stream) {
  if (mode == 0) {
    Do = D;
    Ho = H;
    Wo = W;
  }
  const long long cells = (long long)batch * Do * Ho * Wo;
  const long long words = (cells + 31) / 32;
  if (V < 0 || batch < 1 || D < 1 || H < 1 || W < 1 || Do < 1 || Ho < 1 ||
      Wo < 1 || (mode != 0 && mode != 1) || padded % kTileWords != 0 ||
      words > padded || work_words != 2 * padded + padded / kTileWords + 1)
    return cudaErrorInvalidValue;
  if (mode == 1 &&
      (capacity < 1 || kz < 1 || ky < 1 || kx < 1 || sz < 1 || sy < 1 ||
       sx < 1 || pz < 0 || py < 0 || px < 0 ||
       (kz + sz - 1) / sz > kMaxSites || (ky + sy - 1) / sy > kMaxSites ||
       (kx + sx - 1) / sx > kMaxSites))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(work);
  unsigned* bits = reinterpret_cast<unsigned*>(w);
  int* base = w + padded;
  int* tile_sums = base + padded;
  int* total = tile_sums + padded / kTileWords;
  fill<11>(bits, padded, 0u, s);
  const unsigned row_blocks = (unsigned)((V + kThreads - 1) / kThreads);
  const int* c = static_cast<const int*>(coords);
  const bool* m = static_cast<const bool*>(mask);
  if (V > 0) {
    if (mode == 0)
      mark_rows<<<row_blocks, kThreads, 0, s>>>(c, m, V, D, H, W, bits);
    else if ((long long)V * ((kz + sz - 1) / sz) * ((ky + sy - 1) / sy) *
                 ((kx + sx - 1) / sx) > 4 * words)
      mark_sites<true><<<row_blocks, kThreads, 0, s>>>(
          c, m, V, kz, ky, kx, sz, sy, sx, pz, py, px, Do, Ho, Wo, bits);
    else
      mark_sites<false><<<row_blocks, kThreads, 0, s>>>(
          c, m, V, kz, ky, kx, sz, sy, sx, pz, py, px, Do, Ho, Wo, bits);
  }
  scan_bitmap<11>(bits, base, tile_sums, total, padded, s);
  if (mode == 0) {
    if (V > 0)
      build_rows<<<row_blocks, kThreads, 0, s>>>(c, m, V, D, H, W, bits, base,
                                                 total, static_cast<int*>(rows));
  } else {
    // a warp per group of words, and a thread per rank below the capacity;
    // the group: 32 rows a warp where the ranks below the capacity come
    // from words at the density capacity / words gives, when they are full
    int group = 32;
    while (group > 1 && (long long)group * capacity > 32 * words) group /= 2;
    const long long lanes = (words + group - 1) / group * 32;
    const long long n = lanes > capacity ? lanes : capacity;
    emit_sites<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        bits, base, words, group, total, capacity, Do, Ho, Wo,
        static_cast<int4*>(coords_out), static_cast<bool*>(mask_out),
        static_cast<int*>(rows), static_cast<long long*>(overflow));
  }
  return cudaGetLastError();
}
