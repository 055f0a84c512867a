// Modulated deformable im2col for DCNv2, forward (kernel K2 of the port).
//
// Replaces the sampling half of unibev_tpu/ops/deform_conv.py::
// modulated_deform_conv2d: the f32 path _mdcn_clean (which defines the
// semantics) and the bf16 path _mdcn_fast (s32 pair-packed corner gathers for
// the TPU gather engine).  The (K*Cin) x Cout product after it stays a plain
// matrix product (torch.matmul), as the JAX package left it to XLA.
//
// Semantics, per output pixel (b, ho, wo) and tap k = ky * Kw + kx:
//   sy = ho * stride - pad + ky * dil + offset[b, ho, wo, 2k]      (dy)
//   sx = wo * stride - pad + kx * dil + offset[b, ho, wo, 2k + 1]  (dx)
//   cols[(b, ho, wo), k * Cin + c] = mask[b, ho, wo, k] * bilinear(x[b, :, :, c], sy, sx)
// A sample counts only when -1 < sy < H and -1 < sx < W; each of its four
// corners is then checked on its own (zero padding).  The offset layout is
// mmcv's: (dy, dx) interleaved per tap; the mask is already sigmoid-ed.
//
// Layouts: x (B, H, W, Cin) NHWC; offset (B, Ho, Wo, 2K); mask (B, Ho, Wo, K);
// cols (B * Ho * Wo, K * Cin), tap-major; all in one dtype, bf16 or f32;
// bilinear weights and sums in f32.
//
// What bounds it on the H100: bytes.  Each column element reads four input
// values and writes one; at the flagship stage-3 shape (6 x 58 x 100 x 256,
// K = 9) cols alone is 160 MB in bf16 written and read back by the product,
// against 37 GFLOP for the product itself.  The input map (18 MB per stage-3
// call in bf16) stays in L2, so the corner reads are L2 traffic.
//
// The design is the simple one: one warp per (output pixel, tap), the
// geometry computed once per warp, lanes over Cin so that the four corner
// reads and the column write are contiguous.  Left for later: two or more
// channels per lane (16-byte loads), and fusing the sampling into the
// product (build the column tile in shared memory and feed it to wgmma), which
// would take the 160 MB round trip through device memory away.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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

template <typename T>
__global__ void dcn_im2col_kernel(const T* __restrict__ x,
                                  const T* __restrict__ offset,
                                  const T* __restrict__ mask,
                                  T* __restrict__ cols, int H, int W, int Cin,
                                  int Ho, int Wo, int Kw, int K, int stride,
                                  int pad, int dil, long long n_warps) {
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= n_warps) return;
  const int lane = threadIdx.x & 31;
  // warp = n * K + k, n = (b * Ho + ho) * Wo + wo
  const int k = (int)(warp % K);
  const long long n = warp / K;
  const int wo = (int)(n % Wo);
  const int ho = (int)((n / Wo) % Ho);
  const long long b = n / ((long long)Wo * Ho);
  const int ky = k / Kw;
  const int kx = k % Kw;

  const float dy = to_float(offset[n * 2 * K + 2 * k]);
  const float dx = to_float(offset[n * 2 * K + 2 * k + 1]);
  const float m = to_float(mask[n * K + k]);
  const float sy = (float)(ho * stride - pad + ky * dil) + dy;
  const float sx = (float)(wo * stride - pad + kx * dil) + dx;
  T* dst = cols + warp * Cin;

  // Outside (-1, H) x (-1, W) no corner is inside the map; this also drops
  // NaN positions before they reach the integer conversion.
  if (!(sy > -1.f && sy < (float)H && sx > -1.f && sx < (float)W)) {
    for (int c = lane; c < Cin; c += 32) dst[c] = from_float<T>(0.f);
    return;
  }
  const float yf = floorf(sy);
  const float xf = floorf(sx);
  const int y0 = (int)yf;
  const int x0 = (int)xf;
  const float ly = sy - yf;
  const float lx = sx - xf;
  const bool yin0 = y0 >= 0;
  const bool yin1 = y0 + 1 < H;
  const bool xin0 = x0 >= 0;
  const bool xin1 = x0 + 1 < W;
  const float w00 = (yin0 && xin0) ? (1.f - ly) * (1.f - lx) * m : 0.f;
  const float w01 = (yin0 && xin1) ? (1.f - ly) * lx * m : 0.f;
  const float w10 = (yin1 && xin0) ? ly * (1.f - lx) * m : 0.f;
  const float w11 = (yin1 && xin1) ? ly * lx * m : 0.f;
  // Clamp the addresses of out-of-range corners; their weight is 0.
  const int ya = yin0 ? y0 : 0;
  const int yb = yin1 ? y0 + 1 : 0;
  const int xa = xin0 ? x0 : 0;
  const int xb = xin1 ? x0 + 1 : 0;
  const T* img = x + b * H * W * Cin;
  const T* p00 = img + ((long long)ya * W + xa) * Cin;
  const T* p01 = img + ((long long)ya * W + xb) * Cin;
  const T* p10 = img + ((long long)yb * W + xa) * Cin;
  const T* p11 = img + ((long long)yb * W + xb) * Cin;
  for (int c = lane; c < Cin; c += 32) {
    const float s = w00 * to_float(p00[c]) + w01 * to_float(p01[c]) +
                    w10 * to_float(p10[c]) + w11 * to_float(p11[c]);
    dst[c] = from_float<T>(s);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* offset, const void* mask,
                   void* cols, int B, int H, int W, int Cin, int Ho, int Wo,
                   int Kh, int Kw, int stride, int pad, int dil,
                   cudaStream_t stream) {
  const int K = Kh * Kw;
  const long long n_warps = (long long)B * Ho * Wo * K;
  if (n_warps == 0) return cudaSuccess;
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dcn_im2col_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset),
      static_cast<const T*>(mask), static_cast<T*>(cols), H, W, Cin, Ho, Wo,
      Kw, K, stride, pad, dil, n_warps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16.  Returns the cudaError_t of the launch (0 on success).
extern "C" int unibev_dcn_im2col(const void* x, const void* offset,
                                 const void* mask, void* cols, int B, int H,
                                 int W, int Cin, int Ho, int Wo, int Kh,
                                 int Kw, int stride, int pad, int dil,
                                 int dtype, void* stream) {
  if (Kh < 1 || Kw < 1 || Cin < 1 || stride < 1 || dil < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, offset, mask, cols, B, H, W, Cin, Ho, Wo, Kh, Kw,
                         stride, pad, dil, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, offset, mask, cols, B, H, W, Cin, Ho, Wo,
                                 Kh, Kw, stride, pad, dil, s);
  return cudaErrorInvalidValue;
}
