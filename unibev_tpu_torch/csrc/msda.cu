// Multi-scale deformable attention, forward (kernel K1 of the port).
//
// Replaces, with one kernel:
//   * unibev_tpu/ops/msda_pallas.py::ms_deform_attn_smallv (the Pallas TPU
//     kernel: one-hot sampling matrix built in VMEM, applied as one MXU
//     matmul) -- the camera spatial cross-attention over 29x50 maps;
//   * unibev_tpu/ops/msda.py::_slab_level_op2 forward (_slab2 / _slab2_fast:
//     corner-packed XLA gathers) -- temporal self-attention and decoder
//     cross-attention over the 200x200 BEV map.
//
// Semantics (the reference's multi_scale_deformable_attn_pytorch, grid_sample
// with align_corners=False and zero padding):
//   out[b, q, h*D + d] = sum_{l, p} attn[b, q, h, l, p]
//                        * bilinear(value_l[b, :, h, d], loc * (W_l, H_l) - 0.5)
// Each of the four corners is checked on its own against the map bounds.
//
// Layouts (the JAX package's ms_deform_attn):
//   value (B, V, heads, D) with V = sum_l H_l * W_l, bf16 or f32;
//   loc   (B, Q, heads, L, P, 2) f32, xy order, in [0, 1] over each level;
//   attn  (B, Q, heads, L, P) in value's dtype;
//   out   (B, Q, heads * D) in value's dtype; sums are kept in f32.
//
// What bounds it on the H100: the gathers.  Every (query, head, point) reads
// four D-wide value rows (4 * 32 * 2 = 256 bytes in bf16) at data-dependent
// addresses; there is almost no arithmetic per byte.  The maps are small
// enough to stay in the 50 MB L2 (the 200x200x256 BEV map is 20 MB in bf16,
// the six 29x50x256 camera maps 4.5 MB), so the rate is set by L2 gather
// throughput and by how many warps are in flight.
//
// The design is the simple one: one warp per (b, q, head), lanes over D
// (D = 32 at every flagship site), a loop over levels x points, f32
// accumulation.  Left for later: staging one (camera, head) 1450 x 32 map in
// shared memory for the camera cross-attention (93 KB in bf16, 186 KB in
// f32, both under the 227 KB a block may use), 16-byte vector loads of two
// or more channels per lane, and the backward kernels for training.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

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
__global__ void msda_fwd_kernel(const T* __restrict__ value,
                                const float* __restrict__ loc,
                                const T* __restrict__ attn,
                                T* __restrict__ out, int V, int Q, int heads,
                                int D, int L, int P, long long n_warps,
                                Levels lv) {
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= n_warps) return;
  const int lane = threadIdx.x & 31;
  // warp = (b * Q + q) * heads + h
  const int h = (int)(warp % heads);
  const long long b = warp / heads / Q;
  const long long row = (long long)heads * D;  // elements between value rows
  const T* vb = value + b * V * row + (long long)h * D;
  const float* lw = loc + warp * L * P * 2;
  const T* aw = attn + warp * L * P;

  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int H = lv.h[l];
      const int W = lv.w[l];
      const T* vl = vb + (long long)lv.start[l] * row + d;
      for (int p = 0; p < P; ++p) {
        const int i = l * P + p;
        const float x = lw[2 * i] * W - 0.5f;
        const float y = lw[2 * i + 1] * H - 0.5f;
        // Outside (-1, W) x (-1, H) no corner is inside the map; this also
        // drops NaN locations before they reach the integer conversion.
        if (!(x > -1.f && x < (float)W && y > -1.f && y < (float)H)) continue;
        const float xf = floorf(x);
        const float yf = floorf(y);
        const int x0 = (int)xf;
        const int y0 = (int)yf;
        const float lx = x - xf;
        const float ly = y - yf;
        const bool xin0 = x0 >= 0;
        const bool xin1 = x0 + 1 < W;
        const bool yin0 = y0 >= 0;
        const bool yin1 = y0 + 1 < H;
        float s = 0.f;
        if (yin0 && xin0)
          s += (1.f - ly) * (1.f - lx) * to_float(vl[((long long)y0 * W + x0) * row]);
        if (yin0 && xin1)
          s += (1.f - ly) * lx * to_float(vl[((long long)y0 * W + x0 + 1) * row]);
        if (yin1 && xin0)
          s += ly * (1.f - lx) * to_float(vl[((long long)(y0 + 1) * W + x0) * row]);
        if (yin1 && xin1)
          s += ly * lx * to_float(vl[((long long)(y0 + 1) * W + x0 + 1) * row]);
        acc += to_float(aw[i]) * s;
      }
    }
    out[warp * D + d] = from_float<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   void* out, int B, int V, int Q, int heads, int D, int L,
                   int P, const Levels& lv, cudaStream_t stream) {
  const long long n_warps = (long long)B * Q * heads;
  if (n_warps == 0) return cudaSuccess;
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  msda_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const T*>(attn), static_cast<T*>(out), V, Q, heads, D, L, P,
      n_warps, lv);
  return cudaGetLastError();
}

}  // namespace

// shapes: host array of L triples (H_l, W_l, start_l).  dtype: 0 f32, 1 bf16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int unibev_msda_fwd(const void* value, const void* loc,
                               const void* attn, void* out, int B, int V,
                               int Q, int heads, int D, int L, int P,
                               const int* shapes, int dtype, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 1) return cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[3 * l];
    lv.w[l] = shapes[3 * l + 1];
    lv.start[l] = shapes[3 * l + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(value, loc, attn, out, B, V, Q, heads, D, L, P, lv, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(value, loc, attn, out, B, V, Q, heads, D, L,
                                 P, lv, s);
  return cudaErrorInvalidValue;
}
