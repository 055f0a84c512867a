// Device helpers shared by the port's sampling kernels: dtype conversions,
// the bilinear geometry of one sample point, and a warp sum.
//
// The geometry is the one the forward kernels and their backwards must agree
// on exactly: a point counts only when it lies in (-1, W) x (-1, H) (this
// also drops NaN coordinates before they reach an integer conversion), and
// each of its four corners is then tested against the map on its own (zero
// padding).  A backward that used another test would give a non-zero
// gradient where the forward read nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One sample point at pixel coordinates (x, y).  Corner c = 2 * dy + dx sits
// at (y0 + dy, x0 + dx) and carries the bilinear weight w[c]; in[c] says
// whether it lies inside the W x H map.  ya/yb/xa/xb are the corner rows and
// columns clamped into the map, safe to address whatever in[] says.
struct Bilinear {
  float lx, ly;
  float w[4];
  bool in[4];
  int ya, yb, xa, xb;
};

// False when no corner can be inside the map (or x, y is NaN): the point
// then contributes nothing and b is left unset.
__device__ __forceinline__ bool bilinear_at(float x, float y, int W, int H,
                                            Bilinear& b) {
  if (!(x > -1.f && x < (float)W && y > -1.f && y < (float)H)) return false;
  const float xf = floorf(x);
  const float yf = floorf(y);
  const int x0 = (int)xf;
  const int y0 = (int)yf;
  b.lx = x - xf;
  b.ly = y - yf;
  const bool xin0 = x0 >= 0;
  const bool xin1 = x0 + 1 < W;
  const bool yin0 = y0 >= 0;
  const bool yin1 = y0 + 1 < H;
  b.in[0] = yin0 && xin0;
  b.in[1] = yin0 && xin1;
  b.in[2] = yin1 && xin0;
  b.in[3] = yin1 && xin1;
  b.w[0] = (1.f - b.ly) * (1.f - b.lx);
  b.w[1] = (1.f - b.ly) * b.lx;
  b.w[2] = b.ly * (1.f - b.lx);
  b.w[3] = b.ly * b.lx;
  b.ya = yin0 ? y0 : 0;
  b.yb = yin1 ? y0 + 1 : 0;
  b.xa = xin0 ? x0 : 0;
  b.xb = xin1 ? x0 + 1 : 0;
  return true;
}

// Row-major offset of corner c in a W-wide map.
__device__ __forceinline__ long long corner_cell(const Bilinear& b, int c,
                                                 int W) {
  const int y = (c >> 1) ? b.yb : b.ya;
  const int x = (c & 1) ? b.xb : b.xa;
  return (long long)y * W + x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace
