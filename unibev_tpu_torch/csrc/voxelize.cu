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
// The design, one C entry point and eight launches (two fills, mark, the
// three of the bitmap scan in bitmap.cuh, slot, emit), with no sort and no
// host synchronization:
//   * mark: a thread per point computes its cell and key, keeps the key in
//     the workspace and sets the key's bit in an occupancy bitmap over the
//     whole grid (the LiDAR grid's 82.9 M cells: 10.4 MB, and as much
//     again for the per-word counts; both stay in the 50 MB L2);
//   * the scan gives each word the set bits before it, so a voxel's rank in
//     ascending key order is base[w] + popc(bits[w] & below): its output
//     row; rank < max_voxels is exactly the smallest-key cap, and the total
//     is the number of distinct voxels;
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
// What bounds it: the points are read twice (mark, emit) and the bitmap
// passed over three times in L2; at the flagship's 300k points the work is
// a few MB, so the launches' latency sets the time.

#include <cstdint>

#include "bitmap.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kEmpty = 0xffffffffu;

// the cell of coordinate p on an axis of n cells, or -1 outside (NaN too)
__device__ __forceinline__ int axis_cell(float p, float x0, float inv, int n) {
  const float f = floorf(__fmul_rn(__fsub_rn(p, x0), inv));
  return (f >= 0.f && f < (float)n) ? (int)f : -1;
}

__global__ void __launch_bounds__(kThreads)
mark_points(const float* __restrict__ pts, const bool* __restrict__ mask,
            int P, int F, float x0, float y0, float z0, float ix, float iy,
            float iz, int X, int Y, int Z, int* __restrict__ keys,
            unsigned* __restrict__ bits) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  int key = -1;
  if (mask[i]) {
    const float* p = pts + (long long)i * F;
    const int gx = axis_cell(p[0], x0, ix, X);
    const int gy = axis_cell(p[1], y0, iy, Y);
    const int gz = axis_cell(p[2], z0, iz, Z);
    if (gx >= 0 && gy >= 0 && gz >= 0) {
      key = (gz * Y + gy) * X + gx;   // < X * Y * Z < 2^31 (the wrapper)
      set_bit(bits, key);
    }
  }
  keys[i] = key;
}

__global__ void __launch_bounds__(kThreads)
slot_points(const int* __restrict__ keys, int P,
            const unsigned* __restrict__ bits, const int* __restrict__ base,
            int rows, int K, unsigned* __restrict__ slots) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  const int key = keys[i];
  if (key < 0) return;
  const int r = bitmap_rank(bits, base, key);
  if (r >= rows) return;                       // past the voxel cap
  unsigned* s = slots + (long long)r * K;
  unsigned v = (unsigned)i;
  if (__ldcg(s + K - 1) < v) return;           // K smaller indices are in
  for (int j = 0; j < K; ++j) {
    const unsigned old = atomicMin(s + j, v);
    if (old == kEmpty) return;
    v = old > v ? old : v;
  }
}

__global__ void __launch_bounds__(kThreads)
emit_voxels(const float* __restrict__ pts, int F, const int* __restrict__ keys,
            const unsigned* __restrict__ slots, int K, int M,
            const int* __restrict__ total, int X, int Y,
            float* __restrict__ feats, int* __restrict__ coords,
            bool* __restrict__ vmask, int* __restrict__ num_points,
            int* __restrict__ num_voxels, long long* __restrict__ num_distinct) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int distinct = *total;
  const int kept = distinct < M ? distinct : M;
  if (r == 0) {
    *num_voxels = kept;
    *num_distinct = distinct;
  }
  if (r >= M) return;
  float* f = feats + (long long)r * F;
  int* c = coords + 3 * (long long)r;
  if (r >= kept) {
    for (int k = 0; k < F; ++k) f[k] = 0.f;
    c[0] = c[1] = c[2] = -1;
    vmask[r] = false;
    num_points[r] = 0;
    return;
  }
  const unsigned* s = slots + (long long)r * K;
  int n = 0;
  while (n < K && s[n] != kEmpty) ++n;
  for (int k = 0; k < F; ++k) {
    float sum = 0.f;
    for (int j = 0; j < n; ++j) sum += pts[(long long)s[j] * F + k];
    f[k] = __fdiv_rn(sum, (float)n);
  }
  const int key = keys[s[0]];
  c[0] = key / (Y * X);
  c[1] = (key / X) % Y;
  c[2] = key % X;
  vmask[r] = true;
  num_points[r] = n;
}

}  // namespace

// points (P, F) f32 and mask (P,) bool in; feats (M, F) f32, coords (M, 3)
// int32, vmask (M,) bool, num_points (M,) int32, num_voxels () int32 and
// num_distinct () int64 out.  work: int32 words laid out as [bitmap padded
// | base padded | tile sums padded / kTileWords | total 1 | keys P | slots
// min(M, P) * K], `work_words` of them; `padded` is the bitmap's words
// rounded up to kTileWords.  Returns the cudaError_t of the launches.
extern "C" int unibev_voxelize(const void* points, const void* mask, int P,
                               int F, float x0, float y0, float z0, float ix,
                               float iy, float iz, int X, int Y, int Z, int M,
                               int K, void* feats, void* coords, void* vmask,
                               void* num_points, void* num_voxels,
                               void* num_distinct, void* work,
                               long long padded, long long work_words,
                               void* stream) {
  if (P < 0 || F < 3 || M < 1 || K < 1 || X < 1 || Y < 1 || Z < 1 ||
      padded % kTileWords != 0 ||
      (long long)X * Y * Z > 32 * padded || (long long)X * Y * Z >= (1LL << 31))
    return cudaErrorInvalidValue;
  const long long tiles = padded / kTileWords;
  const int rows = M < P ? M : P;
  if (work_words != 2 * padded + tiles + 1 + P + (long long)rows * K)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(work);
  unsigned* bits = reinterpret_cast<unsigned*>(w);
  int* base = w + padded;
  int* tile_sums = base + padded;
  int* total = tile_sums + tiles;
  int* keys = total + 1;
  unsigned* slots = reinterpret_cast<unsigned*>(keys + P);
  fill<10>(bits, padded, 0u, s);
  if (rows > 0) fill<10>(slots, (long long)rows * K, kEmpty, s);
  const unsigned point_blocks = (unsigned)((P + kThreads - 1) / kThreads);
  const float* pts = static_cast<const float*>(points);
  if (P > 0)
    mark_points<<<point_blocks, kThreads, 0, s>>>(
        pts, static_cast<const bool*>(mask), P, F, x0, y0, z0, ix, iy, iz, X,
        Y, Z, keys, bits);
  scan_bitmap<10>(bits, base, tile_sums, total, padded, s);
  if (P > 0)
    slot_points<<<point_blocks, kThreads, 0, s>>>(keys, P, bits, base, rows, K,
                                                  slots);
  emit_voxels<<<(unsigned)((M + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      pts, F, keys, slots, K, M, total, X, Y, static_cast<float*>(feats),
      static_cast<int*>(coords), static_cast<bool*>(vmask),
      static_cast<int*>(num_points), static_cast<int*>(num_voxels),
      static_cast<long long*>(num_distinct));
  return cudaGetLastError();
}
