// Hard voxelization with the mean voxel feature encoder (kernel K10 of the
// port).
//
// Replaces the XLA op unibev_tpu/ops/voxelize.py::voxelize_and_encode
// (:41), not a Pallas kernel: a stable argsort of the points by voxel key,
// an associative scan for each point's place in its voxel, and one fused
// segment_sum.  Its plain PyTorch counterpart, ops/voxelize.py::
// voxelize_and_encode_reference, sorts and scans the same way in ~20
// launches.  The semantics, which this kernel keeps exactly:
//   * a point's cell is floor((p - x0) * inv) on each axis, in float32 with
//     the subtraction and the product each rounded (__fsub_rn, __fmul_rn: no
//     contraction into an FMA), inv the float32 reciprocal of the voxel
//     size, as XLA compiles the JAX op's division; masked points and points
//     outside the grid take no part;
//   * voxels are numbered in ascending key order (z * Y + y) * X + x and the
//     max_voxels smallest keys are kept;
//   * a voxel keeps its first max_points points by input index, and its
//     feature is the float32 mean of those points, summed in input order.
//
// The stages, one launch each, with no sort and no host synchronization:
//   * fill: zeroes the occupancy bitmap and the scan state and empties the
//     point slots, in one pass;
//   * mark: a thread per point computes its cell and key, keeps the key in
//     the workspace and sets the key's bit in an occupancy bitmap over the
//     whole grid (the LiDAR grid's 82.9 M cells: 10.4 MB);
//   * scan: the single-pass scan of bitmap.cuh counts the set bits before
//     each 32-byte sector of 8 words, so a voxel's rank in ascending key
//     order (its output row) is one read of its sector and of the count;
//     rank < max_voxels is exactly the smallest-key cap, and the total is
//     the number of distinct voxels;
//   * slot: a thread per point of a kept voxel inserts its index into the
//     voxel's list of max_points slots with a cascade of atomicMin: each
//     slot keeps the least index that reaches it and passes the larger one
//     on, so whatever the order of the threads, slot j ends with the j-th
//     smallest index of the voxel (a point that finds the last slot already
//     below its index stops at once: slots only decrease);
//   * emit: a thread per output row reads its slots in order, sums the
//     points' features in float32, divides by the count, and writes the
//     coords from the key of the voxel's first point; rows past the kept
//     voxels get zeros, -1 coords and a false mask.
// What bounds it: bytes in L2 and launches.  The points are read twice
// (mark, emit), the bitmap written once (fill), read once (scan) and where
// a point lands (slot): at the flagship's 300k points a few MB a stage, a
// few microseconds each, so the launches count as much.  So a call is five
// launches, one fill and one scan launch among them, and the scan writes a
// count per sector (1.3 MB at the LiDAR grid), not a base per word (10.4
// MB; 0.0454 against 0.0403 ms a LiDAR call, PERF.md section 6).  One
// cooperative launch running the five stages with grid-wide barriers
// between them was slower at every site, the radar pillars' one tile too.
//
// The launch plan is ops/voxelize.py::voxelize_plan, handed over as an
// array of int64 in the order of VoxelizePlan below; the entry point
// refuses a plan whose layout or launch sizes disagree with its own.

#include <cstdint>

#include "bitmap.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kEmpty = 0xffffffffu;

// the fields of a plan, in ops/voxelize.py::VoxelizePlan's order
enum VoxelizePlan {
  kPoints, kFeatures, kX, kY, kZ, kMaxVoxels, kMaxPoints, kRows, kWords,
  kPadded, kTiles, kStateOffset, kDirOffset, kKeysOffset, kSlotsOffset,
  kWorkWords, kZeroVectors, kSlotWords, kCoordsOffset, kNumPointsOffset,
  kNumVoxelsOffset, kNumDistinctOffset, kMaskOffset, kOutBytes, kFillBlocks,
  kPointBlocks, kVoxelBlocks, kPlanFields
};

// everything a stage reads or writes
struct Voxelize {
  const float* pts;
  const bool* mask;
  int P, F;
  float x0, y0, z0, ix, iy, iz;
  int X, Y, Z, M, K, rows;
  unsigned* bits;
  int* dir;
  ScanState st;
  int* keys;
  unsigned* slots;
  uint4* zero;
  long long zero_vectors, slot_words;
  float* feats;
  int* coords;
  bool* vmask;
  int* num_points;
  int* num_voxels;
  long long* num_distinct;
};

// the cell of coordinate p on an axis of n cells, or -1 outside (NaN too)
__device__ __forceinline__ int axis_cell(float p, float x0, float inv, int n) {
  const float f = floorf(__fmul_rn(__fsub_rn(p, x0), inv));
  return (f >= 0.f && f < (float)n) ? (int)f : -1;
}

__global__ void __launch_bounds__(kThreads) mark_points(const Voxelize a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.P) return;
  int key = -1;
  if (a.mask[i]) {
    const float* p = a.pts + (long long)i * a.F;
    const int gx = axis_cell(p[0], a.x0, a.ix, a.X);
    const int gy = axis_cell(p[1], a.y0, a.iy, a.Y);
    const int gz = axis_cell(p[2], a.z0, a.iz, a.Z);
    if (gx >= 0 && gy >= 0 && gz >= 0) {
      key = (gz * a.Y + gy) * a.X + gx;   // < X * Y * Z < 2^31 (the plan)
      set_bit(a.bits, key);
    }
  }
  a.keys[i] = key;
}

__global__ void __launch_bounds__(kThreads) slot_points(const Voxelize a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.P) return;
  const int key = a.keys[i];
  if (key < 0) return;
  const int r = sector_rank(a.bits, a.dir, key);
  if (r >= a.rows) return;                       // past the voxel cap
  unsigned* s = a.slots + (long long)r * a.K;
  unsigned v = (unsigned)i;
  if (__ldcg(s + a.K - 1) < v) return;           // K smaller indices are in
  for (int j = 0; j < a.K; ++j) {
    const unsigned old = atomicMin(s + j, v);
    if (old == kEmpty) return;
    v = old > v ? old : v;
  }
}

__global__ void __launch_bounds__(kThreads) emit_voxels(const Voxelize a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int distinct = *a.st.total;
  const int kept = distinct < a.M ? distinct : a.M;
  if (r == 0) {
    *a.num_voxels = kept;
    *a.num_distinct = distinct;
  }
  if (r >= a.M) return;
  const int F = a.F;
  float* f = a.feats + (long long)r * F;
  int* c = a.coords + 3 * (long long)r;
  if (r >= kept) {
    for (int k = 0; k < F; ++k) f[k] = 0.f;
    c[0] = c[1] = c[2] = -1;
    a.vmask[r] = false;
    a.num_points[r] = 0;
    return;
  }
  const unsigned* s = a.slots + (long long)r * a.K;
  int n = 0;
  while (n < a.K && s[n] != kEmpty) ++n;
  for (int k = 0; k < F; ++k) {
    float sum = 0.f;
    for (int j = 0; j < n; ++j) sum += a.pts[(long long)s[j] * F + k];
    f[k] = __fdiv_rn(sum, (float)n);
  }
  const int key = a.keys[s[0]];
  c[0] = key / (a.Y * a.X);
  c[1] = (key / a.X) % a.Y;
  c[2] = key % a.X;
  a.vmask[r] = true;
  a.num_points[r] = n;
}

long long round16(long long n) { return (n + 15) / 16 * 16; }

// The plan this entry point would make from the plan's shape fields: false
// where they are out of range.
bool expected_plan(const long long* p, long long* e) {
  for (int i = 0; i < kPlanFields; ++i) e[i] = p[i];
  const long long P = p[kPoints], F = p[kFeatures], M = p[kMaxVoxels],
                  K = p[kMaxPoints];
  const long long cells = p[kX] * p[kY] * p[kZ];
  if (P < 0 || F < 3 || M < 1 || K < 1 || p[kX] < 1 || p[kY] < 1 ||
      p[kZ] < 1 || cells >= (1LL << 31) || P >= (1LL << 31) ||
      M * F >= (1LL << 31))
    return false;
  e[kRows] = M < P ? M : P;
  e[kWords] = (cells + 31) / 32;
  e[kPadded] = (e[kWords] + kTileWords - 1) / kTileWords * kTileWords;
  e[kTiles] = e[kPadded] / kTileWords;
  e[kStateOffset] = e[kPadded];
  e[kDirOffset] = e[kStateOffset] + scan_state_words(e[kTiles]);
  e[kKeysOffset] = e[kDirOffset] + e[kPadded] / 8;
  e[kSlotsOffset] = e[kKeysOffset] + round4(P);
  e[kSlotWords] = e[kRows] * K;
  e[kWorkWords] = e[kSlotsOffset] + e[kSlotWords];
  e[kZeroVectors] = e[kDirOffset] / 4;
  e[kCoordsOffset] = round16(4 * M * F);
  e[kNumPointsOffset] = e[kCoordsOffset] + round16(12 * M);
  e[kNumVoxelsOffset] = e[kNumPointsOffset] + round16(4 * M);
  e[kNumDistinctOffset] = e[kNumVoxelsOffset] + 16;
  e[kMaskOffset] = e[kNumDistinctOffset] + 16;
  e[kOutBytes] = e[kMaskOffset] + round16(M);
  e[kFillBlocks] = fill_blocks(e[kZeroVectors] + e[kSlotWords]);
  e[kPointBlocks] = blocks_of(P, kThreads);
  e[kVoxelBlocks] = blocks_of(M, kThreads);
  return true;
}

}  // namespace

// points (P, F) f32 and mask (P,) bool in; `out` the outputs at the plan's
// byte offsets: feats (M, F) f32 at 0, coords (M, 3) int32, num_points (M,)
// int32, num_voxels () int32, num_distinct () int64, vmask (M,) bool.
// work: the plan's work_words int32 words [bitmap padded | scan state |
// counts padded / 8 | keys P | slots min(M, P) * K].  cell: x0, y0,
// z0 and the reciprocals of the voxel sizes, float32.  Returns the
// cudaError_t of the launches.
extern "C" int unibev_voxelize(const void* points, const void* mask, void* out,
                               void* work, const long long* plan,
                               int plan_fields, const float* cell,
                               void* stream) {
  long long e[kPlanFields];
  if (plan_fields != kPlanFields || !expected_plan(plan, e))
    return cudaErrorInvalidValue;
  for (int i = 0; i < kPlanFields; ++i)
    if (e[i] != plan[i]) return cudaErrorInvalidValue;
  const long long* p = plan;
  Voxelize a;
  a.pts = static_cast<const float*>(points);
  a.mask = static_cast<const bool*>(mask);
  a.P = (int)p[kPoints];
  a.F = (int)p[kFeatures];
  a.x0 = cell[0]; a.y0 = cell[1]; a.z0 = cell[2];
  a.ix = cell[3]; a.iy = cell[4]; a.iz = cell[5];
  a.X = (int)p[kX]; a.Y = (int)p[kY]; a.Z = (int)p[kZ];
  a.M = (int)p[kMaxVoxels];
  a.K = (int)p[kMaxPoints];
  a.rows = (int)p[kRows];
  int* w = static_cast<int*>(work);
  a.bits = reinterpret_cast<unsigned*>(w);
  a.dir = w + p[kDirOffset];
  a.st = scan_state_at(w + p[kStateOffset], p[kTiles]);
  a.keys = w + p[kKeysOffset];
  a.slots = reinterpret_cast<unsigned*>(w + p[kSlotsOffset]);
  a.zero = reinterpret_cast<uint4*>(w);
  a.zero_vectors = p[kZeroVectors];
  a.slot_words = p[kSlotWords];
  char* o = static_cast<char*>(out);
  a.feats = reinterpret_cast<float*>(o);
  a.coords = reinterpret_cast<int*>(o + p[kCoordsOffset]);
  a.num_points = reinterpret_cast<int*>(o + p[kNumPointsOffset]);
  a.num_voxels = reinterpret_cast<int*>(o + p[kNumVoxelsOffset]);
  a.num_distinct = reinterpret_cast<long long*>(o + p[kNumDistinctOffset]);
  a.vmask = reinterpret_cast<bool*>(o + p[kMaskOffset]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_words<10><<<(unsigned)p[kFillBlocks], kFillThreads, 0, s>>>(
      a.zero, a.zero_vectors, a.slots, a.slot_words, kEmpty);
  const unsigned point_blocks = (unsigned)p[kPointBlocks];
  if (point_blocks > 0) mark_points<<<point_blocks, kThreads, 0, s>>>(a);
  scan_tiles<10, 8><<<(unsigned)p[kTiles], kScanThreads, 0, s>>>(
      reinterpret_cast<const uint4*>(a.bits), a.dir, a.st);
  if (point_blocks > 0) slot_points<<<point_blocks, kThreads, 0, s>>>(a);
  emit_voxels<<<(unsigned)p[kVoxelBlocks], kThreads, 0, s>>>(a);
  return cudaGetLastError();
}
