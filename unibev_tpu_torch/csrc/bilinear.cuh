// Device helpers shared by the port's sampling kernels: dtype conversions,
// vector loads, the bilinear geometry of one sample point, and lane sums.
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

template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> {
  using type = uint4;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<4> {
  using type = unsigned;
};
template <>
struct RawOf<2> {
  using type = unsigned short;
};

// VEC consecutive channels of T, moved as one 16-, 8-, 4- or 2-byte access.
template <typename T, int VEC>
struct Chunk {
  using Raw = typename RawOf<VEC * (int)sizeof(T)>::type;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ void clear() { raw = Raw{}; }
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) {
      return reinterpret_cast<const float*>(&raw)[i];
    } else {  // bf16 -> float is the 16 bits shifted up, exactly
      return __uint_as_float(
          (unsigned)reinterpret_cast<const unsigned short*>(&raw)[i] << 16);
    }
  }
};

// One sample point at pixel coordinates (x, y).  Corner c = 2 * dy + dx sits
// at (y0 + dy, x0 + dx) and carries the bilinear weight w[c]; in[c] says
// whether it lies inside the W x H map.  ya/yb/xa/xb are the corner rows and
// columns clamped into the map, safe to address whatever in[] says.
struct Bilinear {
  float lx, ly;
  float w[4];
  bool in[4];
  int x0, y0;
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
  b.x0 = x0;
  b.y0 = y0;
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

// Threads that share one item of `chunks` vector chunks (a row of
// channels): chunks rounded up to a power of two, at most a warp; lane j
// owns the chunks j, j + lanes, ...
__host__ __device__ inline int group_lanes(int chunks) {
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  return lanes;
}

// The sum of v over a group of `lanes` consecutive lanes of a warp (a power
// of two, at most 32, the group aligned to it); `mask` names the group's
// lanes (group_mask).  Every lane of the group gets the sum.
__device__ __forceinline__ float group_sum(float v, int lanes, unsigned mask) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

__device__ __forceinline__ unsigned group_mask(int lanes) {
  if (lanes == 32) return 0xffffffffu;
  const int first = (threadIdx.x & 31) & ~(lanes - 1);
  return ((1u << lanes) - 1u) << first;
}

}  // namespace
