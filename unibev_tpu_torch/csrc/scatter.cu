// Row scatter-add (kernel K5 of the port): table[idx[m], :] += contrib[m, :].
//
// Replaces the Pallas TPU kernel unibev_tpu/ops/scatter_pallas.py::
// scatter_add_rows (_scatter_kernel), the step every deformable-sampling
// backward ends in: the MSDA d_value (K3's contribution rows) and the DCNv2
// d_x (K4's).  The Pallas kernel keeps the whole table in VMEM and adds the
// rows one after another, in the contributions' dtype.  Here the table is
// float32 in device memory, each row add is a float32 atomic, and the
// caller rounds the table to its dtype once at the end: at least as accurate
// as the Pallas kernel's bf16 sums.  Atomics make the order of the adds,
// and so the last bits of a sum, change from run to run.
//
// Layouts: idx (M,) int32 in [0, tr) -- rows outside are skipped, never
// written; contrib (M, L) bf16 or f32; table (tr, L) f32, accumulated into
// (the caller zeroes it once and may run several chunks of rows into it).
//
// What bounds it on the H100: atomic throughput at L2.  Each contribution
// element is one 4-byte red.global.add; the tables (the 200x200 BEV d_value
// is 41 MB in f32, a stage-3 DCN d_x 36 MB) stay in the 50 MB L2, so the
// adds resolve there.  Zero contributions (corners outside the map, points
// that sample nothing) are skipped, which saves their atomics.
//
// The design is the simple one: one warp per contribution row, lanes over L,
// so that the reads and the atomics of a row are contiguous.  Left for
// later: fusing the adds into K3 / K4 so that the contribution rows never
// reach device memory.

#include "bilinear.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
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
  for (int c = lane; c < L; c += 32) {
    const float v = to_float(src[c]);
    if (v != 0.f) atomicAdd(dst + c, v);
  }
}

}  // namespace

// dtype: 0 f32, 1 bf16 (of contrib).  Returns the cudaError_t of the launch.
extern "C" int unibev_scatter_add_rows(const void* idx, const void* contrib,
                                       void* table, long long M, int L,
                                       int tr, int dtype, void* stream) {
  if (M < 0 || L < 1 || tr < 1) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    scatter_add_rows_kernel<float><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const int*>(idx), static_cast<const float*>(contrib),
        static_cast<float*>(table), M, L, tr);
  } else if (dtype == 1) {
    scatter_add_rows_kernel<__nv_bfloat16>
        <<<blocks, kWarpsPerBlock * 32, 0, s>>>(
            static_cast<const int*>(idx),
            static_cast<const __nv_bfloat16*>(contrib),
            static_cast<float*>(table), M, L, tr);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
