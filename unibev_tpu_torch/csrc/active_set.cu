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
// One C entry point a call, no sort, no search, no host synchronization.
// The stages, one launch each:
//   * fill: zeroes the bitmap and the scan state;
//   * mark, mode 0 (build_table): a thread per live row sets its own
//     cell's bit; mode 1 (downsample): a thread per live row sets the bits
//     of the at most ceil(k / s) sites per axis whose window holds it (8
//     for k3 s2, 2 for conv_out's (3, 1, 1) s(2, 1, 1));
//   * scan: the single-pass scan of bitmap.cuh, the set bits before each
//     word (the table's base);
//   * mode 0: a thread per row writes rows[rank(cell)] = v (the rank comes
//     from the bitmap: the live rows' cells are distinct, as the voxelizer
//     gives them) and, for v at or past the live count, rows[v] = V, the
//     sentinel: entries a lookup never reads, since it tests the bit first;
//     mode 1: a warp per group of at most 32 output words writes the coords
//     of their set cells at ranks base[w] + j below the capacity, and a
//     thread per rank below the capacity writes mask_out = rank < total,
//     rows = the rank (the map is the identity: a site past the capacity
//     reads the sentinel), and -1 coords past the total; thread 0 writes
//     overflow = max(total - capacity, 0).
// What bounds it: bytes in L2 and launches.  The bitmap, 10.6 MB at res 0
// (B = 1) and 1.4 MB at res 1, is zeroed, scanned and its base written;
// the rows, coords and maps are a few MB.  At res 2, res 3 and conv_out
// the output bitmap is 6, 1 and 1 scan tiles, so each stage is about a
// launch's latency.  So a call is four launches, one scan launch among
// them.  One cooperative launch running a downsample's stages with
// grid-wide barriers between them was slower at every site, conv_out's
// too (PERF.md section 6).
//
// The launch plan is ops/sparse_conv.py::active_set_plan, handed over as
// an array of int64 in the order of ActiveSetPlan below; the entry point
// refuses a plan whose layout or launch sizes disagree with its own.

#include <cstdint>

#include "bitmap.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSites = 4;   // sites per axis that may hold one input cell

// the fields of a plan, in ops/sparse_conv.py::ActiveSetPlan's order
enum ActiveSetPlan {
  kRowsIn, kBatch, kD, kH, kW, kMode, kKz, kKy, kKx, kSz, kSy, kSx, kPz,
  kPy, kPx, kDo, kHo, kWo, kCapacity, kWords, kPadded, kTiles, kAggregate,
  kGroup, kStateOffset, kBaseOffset, kRowsOffset, kCoordsOffset,
  kOverflowOffset, kMaskOffset, kWorkWords, kZeroVectors, kFillBlocks,
  kRowBlocks, kEmitBlocks, kPlanFields
};

// everything a stage reads or writes
struct ActiveSet {
  const int* coords;
  const bool* mask;
  int V, D, H, W;
  int kz, ky, kx, sz, sy, sx, pz, py, px;
  int Do, Ho, Wo, capacity, group;
  long long words;
  unsigned* bits;
  int* base;
  ScanState st;
  int* rows;
  int4* coords_out;
  bool* mask_out;
  long long* overflow;
};

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

__global__ void __launch_bounds__(kThreads) mark_rows(const ActiveSet a) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= a.V || !a.mask[v]) return;
  const int* c = a.coords + 4 * (long long)v;
  set_bit(a.bits, flat_cell(c[0], c[1], c[2], c[3], a.D, a.H, a.W));
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
__global__ void __launch_bounds__(kThreads) mark_sites(const ActiveSet a) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const bool live = v < a.V && a.mask[v];
  const int* c = a.coords + 4 * (long long)(live ? v : 0);
  int oz[kMaxSites], oy[kMaxSites], ox[kMaxSites];
  const int nz = live ? axis_sites(c[1], a.kz, a.sz, a.pz, a.Do, oz) : 0;
  const int ny = live ? axis_sites(c[2], a.ky, a.sy, a.py, a.Ho, oy) : 0;
  const int nx = live ? axis_sites(c[3], a.kx, a.sx, a.px, a.Wo, ox) : 0;
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
            set ? flat_cell(b, oz[i], oy[j], ox[k], a.Do, a.Ho, a.Wo) : 0;
        if (!Aggregate) {
          if (set) set_bit(a.bits, cell);
          continue;
        }
        // word indices fit 31 bits (the plan); ~0u marks no word
        const unsigned w = set ? (unsigned)(cell >> 5) : ~0u;
        const unsigned peers = __match_any_sync(0xffffffffu, w);
        const unsigned word =
            __reduce_or_sync(peers, set ? 1u << (cell & 31) : 0u);
        if (set && (threadIdx.x & 31) == __ffs(peers) - 1)
          atomicOr(a.bits + w, word);
      }
}

__global__ void __launch_bounds__(kThreads) build_rows(const ActiveSet a) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= a.V) return;
  if (v >= *a.st.total) a.rows[v] = a.V;
  if (!a.mask[v]) return;
  const int* c = a.coords + 4 * (long long)v;
  a.rows[bitmap_rank(a.bits, a.base,
                     flat_cell(c[0], c[1], c[2], c[3], a.D, a.H, a.W))] = v;
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
// of the word.  The plan sizes
// the group so that a warp writes about 32 rows when the sites below the
// capacity fill their words: the ranks below the capacity lie in the first
// words, so a warp that owns more of them loops while others idle.  (A
// thread per word that wrote its cells one after another was several times
// slower on the dense outputs of res 2-3, ~20 set cells a word: PERF.md
// section 6.)  Threads below the capacity also write the mask, the
// identity map and the -1 coords past the total.
__global__ void __launch_bounds__(kThreads) emit_sites(const ActiveSet a) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int live = *a.st.total;
  const int capacity = a.capacity;
  if (t == 0) *a.overflow = live > capacity ? live - capacity : 0;
  const long long w0 = (t >> 5) * a.group;
  if (w0 < a.words) {                            // the whole warp
    const long long w = w0 + lane;
    const unsigned word = lane < a.group && w < a.words ? a.bits[w] : 0u;
    const int count = __popc(word);
    const int incl = warp_inclusive_scan(count);
    const int first = __shfl_sync(0xffffffffu, lane == 0 ? a.base[w0] : 0, 0);
    const int all = __shfl_sync(0xffffffffu, incl, 31);
    const int n = all < capacity - first ? all : capacity - first;
    const bool narrow = a.words * 32 <= 0xffffffffLL;
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
        a.coords_out[first + k] = decode_cell(
            (w0 + owner) * 32 + nth_set_bit(own, k - before), narrow, a.Do,
            a.Ho, a.Wo);
    }
  }
  if (t < capacity) {
    const bool kept = t < live;
    a.mask_out[t] = kept;
    a.rows[t] = (int)t;
    if (!kept) a.coords_out[t] = make_int4(-1, -1, -1, -1);
  }
}

// The plan this entry point would make from the plan's shape fields: false
// where they are out of range.
bool expected_plan(const long long* p, long long* e) {
  for (int i = 0; i < kPlanFields; ++i) e[i] = p[i];
  const long long mode = p[kMode], V = p[kRowsIn], cap = p[kCapacity];
  if (mode == 0) {
    e[kDo] = p[kD];
    e[kHo] = p[kH];
    e[kWo] = p[kW];
  }
  const long long cells = p[kBatch] * e[kDo] * e[kHo] * e[kWo];
  e[kWords] = (cells + 31) / 32;
  if (V < 0 || p[kBatch] < 1 || p[kD] < 1 || p[kH] < 1 || p[kW] < 1 ||
      e[kDo] < 1 || e[kHo] < 1 || e[kWo] < 1 || (mode != 0 && mode != 1) ||
      e[kWords] >= (1LL << 31) || V >= (1LL << 31) || cap >= (1LL << 31))
    return false;
  long long candidates = 1;
  if (mode == 1) {
    const long long k[3] = {p[kKz], p[kKy], p[kKx]};
    const long long s[3] = {p[kSz], p[kSy], p[kSx]};
    const long long pad[3] = {p[kPz], p[kPy], p[kPx]};
    if (cap < 1) return false;
    for (int i = 0; i < 3; ++i) {
      if (k[i] < 1 || s[i] < 1 || pad[i] < 0 ||
          (k[i] + s[i] - 1) / s[i] > kMaxSites)
        return false;
      candidates *= (k[i] + s[i] - 1) / s[i];
    }
  }
  e[kPadded] = (e[kWords] + kTileWords - 1) / kTileWords * kTileWords;
  e[kTiles] = e[kPadded] / kTileWords;
  e[kStateOffset] = e[kPadded];
  e[kBaseOffset] = e[kStateOffset] + scan_state_words(e[kTiles]);
  e[kRowsOffset] = e[kBaseOffset] + e[kPadded];
  e[kZeroVectors] = e[kBaseOffset] / 4;
  e[kFillBlocks] = fill_blocks(e[kZeroVectors]);
  e[kRowBlocks] = blocks_of(V, kThreads);
  if (mode == 0) {
    e[kAggregate] = 0;
    e[kGroup] = 0;
    e[kCoordsOffset] = e[kOverflowOffset] = e[kMaskOffset] =
        e[kRowsOffset] + round4(V);
    e[kWorkWords] = e[kMaskOffset];
    e[kEmitBlocks] = 0;
    return true;
  }
  e[kAggregate] = V * candidates > 4 * e[kWords];
  // a warp per group of words and a thread per rank below the capacity;
  // the group: 32 rows a warp where the ranks below the capacity come from
  // words at the density capacity / words gives, when they are full
  long long group = 32;
  while (group > 1 && group * cap > 32 * e[kWords]) group /= 2;
  e[kGroup] = group;
  e[kCoordsOffset] = e[kRowsOffset] + round4(cap);
  e[kOverflowOffset] = e[kCoordsOffset] + 4 * cap;
  e[kMaskOffset] = e[kOverflowOffset] + 4;
  e[kWorkWords] = e[kMaskOffset] + round4((cap + 3) / 4);
  const long long lanes = (e[kWords] + group - 1) / group * 32;
  e[kEmitBlocks] = blocks_of(lanes > cap ? lanes : cap, kThreads);
  return true;
}

}  // namespace

// coords (V, 4) int32 (b, z, y, x) and mask (V,) bool of the input rows on
// the (batch, D, H, W) grid.  work: the plan's work_words int32 words, the
// table and every output: [bitmap padded | scan state | base padded | rows
// | coords_out (capacity, 4) int32 | overflow () int64 | mask_out
// (capacity,) bool] at the plan's offsets.  mode 0 (build_table): the
// table of those rows, rows (V,) int32.  mode 1 (downsample): the sites of
// the strided conv (kernel, stride, padding) on the (batch, Do, Ho, Wo)
// output grid, the first `capacity` of them, and their table, rows
// (capacity,) int32.  Returns the cudaError_t of the launches.
extern "C" int unibev_active_set(const void* coords, const void* mask,
                                 void* work, const long long* plan,
                                 int plan_fields, void* stream) {
  long long e[kPlanFields];
  if (plan_fields != kPlanFields || !expected_plan(plan, e))
    return cudaErrorInvalidValue;
  for (int i = 0; i < kPlanFields; ++i)
    if (e[i] != plan[i]) return cudaErrorInvalidValue;
  const long long* p = plan;
  ActiveSet a;
  a.coords = static_cast<const int*>(coords);
  a.mask = static_cast<const bool*>(mask);
  a.V = (int)p[kRowsIn];
  a.D = (int)p[kD]; a.H = (int)p[kH]; a.W = (int)p[kW];
  a.kz = (int)p[kKz]; a.ky = (int)p[kKy]; a.kx = (int)p[kKx];
  a.sz = (int)p[kSz]; a.sy = (int)p[kSy]; a.sx = (int)p[kSx];
  a.pz = (int)p[kPz]; a.py = (int)p[kPy]; a.px = (int)p[kPx];
  a.Do = (int)p[kDo]; a.Ho = (int)p[kHo]; a.Wo = (int)p[kWo];
  a.capacity = (int)p[kCapacity];
  a.group = (int)p[kGroup];
  a.words = p[kWords];
  int* w = static_cast<int*>(work);
  a.bits = reinterpret_cast<unsigned*>(w);
  a.base = w + p[kBaseOffset];
  a.st = scan_state_at(w + p[kStateOffset], p[kTiles]);
  a.rows = w + p[kRowsOffset];
  a.coords_out = reinterpret_cast<int4*>(w + p[kCoordsOffset]);
  a.overflow = reinterpret_cast<long long*>(w + p[kOverflowOffset]);
  a.mask_out = reinterpret_cast<bool*>(w + p[kMaskOffset]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aggregate = p[kAggregate] != 0;
  fill_words<11><<<(unsigned)p[kFillBlocks], kFillThreads, 0, s>>>(
      reinterpret_cast<uint4*>(w), p[kZeroVectors], nullptr, 0, 0u);
  const unsigned row_blocks = (unsigned)p[kRowBlocks];
  if (row_blocks > 0) {
    if (p[kMode] == 0)
      mark_rows<<<row_blocks, kThreads, 0, s>>>(a);
    else if (aggregate)
      mark_sites<true><<<row_blocks, kThreads, 0, s>>>(a);
    else
      mark_sites<false><<<row_blocks, kThreads, 0, s>>>(a);
  }
  scan_tiles<11, 1><<<(unsigned)p[kTiles], kScanThreads, 0, s>>>(
      reinterpret_cast<const uint4*>(a.bits), a.base, a.st);
  if (p[kMode] == 0) {
    if (row_blocks > 0) build_rows<<<row_blocks, kThreads, 0, s>>>(a);
  } else {
    emit_sites<<<(unsigned)p[kEmitBlocks], kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}
