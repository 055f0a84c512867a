// The one float32 add routine of the port's scatter kernels: the row
// scatter-add K5 (scatter.cu) and the sampling backwards K3 (msda.cu) and K4
// (deform_conv.cu), which add their d_value / d_x rows straight into a
// float32 table with it.
//
// add_f32<N> adds N consecutive floats as vector reductions: the float4 and
// float2 overloads of atomicAdd, which compute capability 9.x offers for
// global memory and which compile, their result unused, to one
// REDG.E.ADD.F32x4 (F32x2) each.  A group of four (two) values that are all
// zero issues nothing: corners that weigh nothing and padded rows cost no
// atomic.  Like the scalar float atomics, the reductions flush denormals to
// zero, and their order, so the last bits of a sum, changes from run to run.

#pragma once

#include <cuda_runtime.h>

namespace {

// dst[i] += v[i] for i < N; dst is aligned to 4 floats when N is a multiple
// of 4, to 2 when N is 2.
template <int N>
__device__ __forceinline__ void add_f32(float* dst, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      if (v[i] != 0.f || v[i + 1] != 0.f || v[i + 2] != 0.f || v[i + 3] != 0.f)
        atomicAdd(reinterpret_cast<float4*>(dst + i),
                  make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  } else if constexpr (N == 2) {
    if (v[0] != 0.f || v[1] != 0.f)
      atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (v[i] != 0.f) atomicAdd(dst + i, v[i]);
  }
}

}  // namespace
