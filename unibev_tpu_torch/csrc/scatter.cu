// Row scatter-add (kernel K5 of the port): table[idx[m], :] += contrib[m, :].
//
// Replaces the Pallas TPU kernel unibev_tpu/ops/scatter_pallas.py::
// scatter_add_rows (_scatter_kernel), the step every deformable-sampling
// backward ends in on the TPU: the MSDA d_value and the DCNv2 d_x.  The
// Pallas kernel keeps the whole table in VMEM and adds the
// rows one after another, in the contributions' dtype.  Here the table is
// float32 in device memory, the adds are float32 atomics, and the
// caller rounds the table to its dtype once at the end: at least as accurate
// as the Pallas kernel's bf16 sums.  Atomics make the order of the adds,
// and so the last bits of a sum, change from run to run.
//
// Layouts: idx (M,) int32 in [0, tr) -- rows outside are skipped, never
// written; contrib (M, L) bf16 or f32; table (tr, L) f32, accumulated into
// (the caller zeroes it once and may run several chunks of rows into it).
//
// What bounds it on the H100: atomic throughput at L2 and, for narrow rows,
// the instructions per row.  The tables (the 200x200 BEV d_value is 41 MB
// in f32, a stage-3 DCN d_x 36 MB) stay in the 50 MB L2, so the adds
// resolve there.  Zero contributions (corners outside the map, points that
// sample nothing) are skipped, which saves their atomics.
//
// The design is the simple one: one warp per contribution row, each lane
// VEC consecutive elements of it (4 where L and the pointers allow, else
// fewer), read as one access and added with add_f32 (scatter.cuh),
// the vector reductions with which the sampling backwards K3 and K4 add
// their rows straight into their tables.  Those write no contribution rows,
// so no path of the port launches K5; it keeps the Pallas kernel's contract
// for a caller that holds such rows.

#include <cstdint>

#include "bilinear.cuh"
#include "scatter.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T, int VEC>
__global__ void scatter_add_rows_kernel(const int* __restrict__ idx,
                                        const T* __restrict__ contrib,
                                        float* __restrict__ table,
                                        long long M, int L, int tr) {
  const long long m =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= M) return;
  const int k = idx[m];
  if (k < 0 || k >= tr) return;
  const int lane = threadIdx.x & 31;
  const T* src = contrib + m * L;
  float* dst = table + (long long)k * L;
  for (int c = lane * VEC; c < L; c += 32 * VEC) {
    Chunk<T, VEC> v;
    v.load(src + c);
    float add[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) add[i] = v.get(i);
    add_f32<VEC>(dst + c, add);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* idx, const void* contrib, void* table,
                   long long M, int L, int tr, cudaStream_t s) {
  const unsigned blocks = (unsigned)((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
  scatter_add_rows_kernel<T, VEC><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const T*>(contrib),
      static_cast<float*>(table), M, L, tr);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16 (of contrib).  Returns the cudaError_t of the launch.
extern "C" int unibev_scatter_add_rows(const void* idx, const void* contrib,
                                       void* table, long long M, int L,
                                       int tr, int dtype, void* stream) {
  if (M < 0 || L < 1 || tr < 1) return cudaErrorInvalidValue;
  const int size = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (size == 0) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  // the widest access of at most 4 elements that L, contrib and the table
  // allow: each lane's adds are then one 16-byte reduction, and a warp's
  // are contiguous (two strided 16-byte reductions a lane, from 8 bf16
  // elements, ran slower)
  int vec = 4;
  while (vec > 1 &&
         (L % vec != 0 ||
          reinterpret_cast<uintptr_t>(contrib) % (vec * size) != 0 ||
          reinterpret_cast<uintptr_t>(table) % (4 * (vec < 4 ? vec : 4)) != 0))
    vec /= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  switch (dtype * 100 + vec) {
    case 4:
      return launch<float, 4>(idx, contrib, table, M, L, tr, s);
    case 2:
      return launch<float, 2>(idx, contrib, table, M, L, tr, s);
    case 1:
      return launch<float, 1>(idx, contrib, table, M, L, tr, s);
    case 104:
      return launch<BF, 4>(idx, contrib, table, M, L, tr, s);
    case 102:
      return launch<BF, 2>(idx, contrib, table, M, L, tr, s);
    default:
      return launch<BF, 1>(idx, contrib, table, M, L, tr, s);
  }
}
