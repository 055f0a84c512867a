// Modulated deformable convolution (DCNv2): the im2col (kernel K2) and its
// backward (K4).
//
// K2 replaces the sampling half of unibev_tpu/ops/deform_conv.py::
// modulated_deform_conv2d: the f32 path _mdcn_clean (which defines the
// semantics) and the bf16 path _mdcn_fast (s32 pair-packed corner gathers for
// the TPU gather engine).  The (K*Cin) x Cout product after it stays a plain
// matrix product (torch.matmul), as the JAX package left it to XLA.
// K4 replaces the sampling half of its hand-written backward _mdcn_fast_bwd:
// from d_cols (the product's adjoint, again a torch.matmul) it computes
// d_offset, d_mask and the d_x contribution rows; the row scatter-add K5
// (csrc/scatter.cu) sums the rows into d_x.
//
// Semantics, per output pixel (b, ho, wo) and tap k = ky * Kw + kx:
//   sy = ho * stride - pad + ky * dil + offset[b, ho, wo, 2k]      (dy)
//   sx = wo * stride - pad + kx * dil + offset[b, ho, wo, 2k + 1]  (dx)
//   cols[(b, ho, wo), k * Cin + c] = mask[b, ho, wo, k] * bilinear(x[b, :, :, c], sy, sx)
// The geometry (whole-point test, per-corner zero padding) is bilinear_at in
// bilinear.cuh, shared with the MSDA kernels.  The offset layout is mmcv's:
// (dy, dx) interleaved per tap; the mask is already sigmoid-ed.
//
// Layouts: x (B, H, W, Cin) NHWC; offset (B, Ho, Wo, 2K); mask (B, Ho, Wo, K);
// cols and d_cols (B * Ho * Wo, K * Cin), tap-major; all in one dtype, bf16
// or f32; bilinear weights and sums in f32.
//
// What bounds them on the H100: bytes.  Each column element reads four input
// values and writes one; at the flagship stage-3 shape (6 x 58 x 100 x 256,
// K = 9) cols alone is 160 MB in bf16 written and read back by the product,
// against 37 GFLOP for the product itself.  K4 reads d_cols (160 MB) and the
// four corners, and writes four Cin-wide contribution rows per tap (640 MB
// in bf16 at stage 3, in chunks).  The input map (18 MB per stage-3 call in
// bf16) stays in L2, so the corner reads are L2 traffic.
//
// The design is the simple one: one warp per (output pixel, tap), the
// geometry computed once per warp, lanes over Cin so that the corner reads,
// the column and contribution writes are contiguous; K4 reduces its five
// per-tap dot products over Cin with warp shuffles.  Left for later: two or
// more channels per lane (16-byte loads), fusing the sampling into the
// product (build the column tile in shared memory and feed it to wgmma),
// and fusing K5 into K4.

#include "bilinear.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

struct Tap {
  long long n;  // output pixel (b * Ho + ho) * Wo + wo
  long long b;
  int k;
  float sy, sx, m;
};

template <typename T>
__device__ __forceinline__ Tap tap_at(long long warp, const T* offset,
                                      const T* mask, int Ho, int Wo, int Kw,
                                      int K, int stride, int pad, int dil) {
  Tap t;
  t.k = (int)(warp % K);
  t.n = warp / K;
  const int wo = (int)(t.n % Wo);
  const int ho = (int)((t.n / Wo) % Ho);
  t.b = t.n / ((long long)Wo * Ho);
  const int ky = t.k / Kw;
  const int kx = t.k % Kw;
  t.sy = (float)(ho * stride - pad + ky * dil) +
         to_float(offset[t.n * 2 * K + 2 * t.k]);
  t.sx = (float)(wo * stride - pad + kx * dil) +
         to_float(offset[t.n * 2 * K + 2 * t.k + 1]);
  t.m = to_float(mask[t.n * K + t.k]);
  return t;
}

template <typename T>
__global__ void dcn_im2col_kernel(const T* __restrict__ x,
                                  const T* __restrict__ offset,
                                  const T* __restrict__ mask,
                                  T* __restrict__ cols, int H, int W, int Cin,
                                  int Ho, int Wo, int Kw, int K, int stride,
                                  int pad, int dil, long long n_warps) {
  // warp = n * K + k
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const Tap t = tap_at(warp, offset, mask, Ho, Wo, Kw, K, stride, pad, dil);
  T* dst = cols + warp * Cin;

  Bilinear g;
  if (!bilinear_at(t.sx, t.sy, W, H, g)) {
    for (int c = lane; c < Cin; c += 32) dst[c] = from_float<T>(0.f);
    return;
  }
  float w[4];
  const T* p[4];
  const T* img = x + t.b * H * W * Cin;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    w[c] = g.in[c] ? g.w[c] * t.m : 0.f;   // out-of-range corners weigh 0
    p[c] = img + corner_cell(g, c, W) * Cin;
  }
  for (int c = lane; c < Cin; c += 32) {
    const float s = w[0] * to_float(p[0][c]) + w[1] * to_float(p[1][c]) +
                    w[2] * to_float(p[2][c]) + w[3] * to_float(p[3][c]);
    dst[c] = from_float<T>(s);
  }
}

// One warp per (output pixel, tap) of the pixels [n0, n0 + n_pix).
// Contribution row ((n - n0) * K + k) * 4 + c holds mask * w_c * d_cols for
// corner c, and idx names the row of x viewed as (B * H * W, Cin) it adds
// to; corners outside the map and taps that sample nothing get zero rows at
// an in-range index.
template <typename T>
__global__ void dcn_bwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ offset,
                               const T* __restrict__ mask,
                               const T* __restrict__ d_cols,
                               T* __restrict__ d_offset,
                               T* __restrict__ d_mask,
                               T* __restrict__ contrib, int* __restrict__ idx,
                               int H, int W, int Cin, int Ho, int Wo, int Kw,
                               int K, int stride, int pad, int dil,
                               long long n0, long long n_warps) {
  const long long local =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (local >= n_warps) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const long long warp = n0 * K + local;  // = n * K + k
  const Tap t = tap_at(warp, offset, mask, Ho, Wo, Kw, K, stride, pad, dil);
  const T* ds = d_cols + warp * Cin;
  T* cw = contrib + local * 4 * Cin;
  const long long xrow0 = t.b * H * W;  // idx of x row (b, 0, 0)

  Bilinear g;
  if (!bilinear_at(t.sx, t.sy, W, H, g)) {
    for (int c = 0; c < 4; ++c) {
      for (int i = lane; i < Cin; i += 32) cw[c * Cin + i] = from_float<T>(0.f);
      if (lane == 0) idx[local * 4 + c] = (int)xrow0;
    }
    if (lane == 0) {
      d_offset[t.n * 2 * K + 2 * t.k] = from_float<T>(0.f);
      d_offset[t.n * 2 * K + 2 * t.k + 1] = from_float<T>(0.f);
      d_mask[t.n * K + t.k] = from_float<T>(0.f);
    }
    return;
  }
  const T* img = x + xrow0 * Cin;
  float gv[4] = {0.f, 0.f, 0.f, 0.f};
  float dm = 0.f;
  for (int i = lane; i < Cin; i += 32) {
    const float d = to_float(ds[i]);
    const float dsm = d * t.m;
    float sampled = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float contribution = 0.f;
      if (g.in[c]) {
        const float v = to_float(img[corner_cell(g, c, W) * Cin + i]);
        sampled += g.w[c] * v;
        gv[c] += v * dsm;
        contribution = dsm * g.w[c];
      }
      cw[c * Cin + i] = from_float<T>(contribution);
    }
    dm += d * sampled;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) gv[c] = warp_sum(gv[c]);
  dm = warp_sum(dm);
  if (lane < 4) idx[local * 4 + lane] = (int)(xrow0 + corner_cell(g, lane, W));
  if (lane == 0) {
    const float dsx =
        (gv[1] - gv[0]) * (1.f - g.ly) + (gv[3] - gv[2]) * g.ly;
    const float dsy =
        (gv[2] - gv[0]) * (1.f - g.lx) + (gv[3] - gv[1]) * g.lx;
    d_offset[t.n * 2 * K + 2 * t.k] = from_float<T>(dsy);
    d_offset[t.n * 2 * K + 2 * t.k + 1] = from_float<T>(dsx);
    d_mask[t.n * K + t.k] = from_float<T>(dm);
  }
}

unsigned blocks_for(long long n_warps) {
  return (unsigned)((n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
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
  const int K = Kh * Kw;
  const long long n_warps = (long long)B * Ho * Wo * K;
  if (n_warps == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dcn_im2col_kernel<float><<<blocks_for(n_warps), kWarpsPerBlock * 32, 0,
                               s>>>(
        static_cast<const float*>(x), static_cast<const float*>(offset),
        static_cast<const float*>(mask), static_cast<float*>(cols), H, W, Cin,
        Ho, Wo, Kw, K, stride, pad, dil, n_warps);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    dcn_im2col_kernel<T><<<blocks_for(n_warps), kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(offset),
        static_cast<const T*>(mask), static_cast<T*>(cols), H, W, Cin, Ho, Wo,
        Kw, K, stride, pad, dil, n_warps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The backward of the output pixels [n0, n0 + n_pix).  d_cols, d_offset and
// d_mask are full-size in x's dtype; contrib (n_pix * K * 4, Cin) in x's
// dtype and idx (same rows,) int32 hold this chunk only.
extern "C" int unibev_dcn_bwd(const void* x, const void* offset,
                              const void* mask, const void* d_cols,
                              void* d_offset, void* d_mask, void* contrib,
                              void* idx, int B, int H, int W, int Cin, int Ho,
                              int Wo, int Kh, int Kw, int stride, int pad,
                              int dil, long long n0, long long n_pix,
                              int dtype, void* stream) {
  if (Kh < 1 || Kw < 1 || Cin < 1 || stride < 1 || dil < 1)
    return cudaErrorInvalidValue;
  if (n0 < 0 || n_pix < 0 || n0 + n_pix > (long long)B * Ho * Wo)
    return cudaErrorInvalidValue;
  const int K = Kh * Kw;
  const long long n_warps = n_pix * K;
  if (n_warps == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dcn_bwd_kernel<float><<<blocks_for(n_warps), kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(offset),
        static_cast<const float*>(mask), static_cast<const float*>(d_cols),
        static_cast<float*>(d_offset), static_cast<float*>(d_mask),
        static_cast<float*>(contrib), static_cast<int*>(idx), H, W, Cin, Ho,
        Wo, Kw, K, stride, pad, dil, n0, n_warps);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    dcn_bwd_kernel<T><<<blocks_for(n_warps), kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(offset),
        static_cast<const T*>(mask), static_cast<const T*>(d_cols),
        static_cast<T*>(d_offset), static_cast<T*>(d_mask),
        static_cast<T*>(contrib), static_cast<int*>(idx), H, W, Cin, Ho, Wo,
        Kw, K, stride, pad, dil, n0, n_warps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
