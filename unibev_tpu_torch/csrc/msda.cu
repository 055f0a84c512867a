// Multi-scale deformable attention: forward (kernel K1) and backward (K3).
//
// K1 replaces, with one kernel:
//   * unibev_tpu/ops/msda_pallas.py::ms_deform_attn_smallv (the Pallas TPU
//     kernel: one-hot sampling matrix built in VMEM, applied as one MXU
//     matmul) -- the camera spatial cross-attention over 29x50 maps;
//   * unibev_tpu/ops/msda.py::_slab_level_op2 forward (_slab2 / _slab2_fast:
//     corner-packed XLA gathers) -- temporal self-attention and decoder
//     cross-attention over the 200x200 BEV map.
// K3 replaces their backwards: unibev_tpu/ops/msda.py::_slab_level_op2_bwd
// and the autodiff of msda_pallas._smallv_reference (_smallv_bwd).  It
// writes d_attn, d_loc and the d_value contribution rows; the row
// scatter-add K5 (csrc/scatter.cu) sums the rows into d_value.
//
// Semantics (the reference's multi_scale_deformable_attn_pytorch, grid_sample
// with align_corners=False and zero padding):
//   out[b, q, h*D + d] = sum_{l, p} attn[b, q, h, l, p]
//                        * bilinear(value_l[b, :, h, d], loc * (W_l, H_l) - 0.5)
// The geometry (whole-point test, per-corner zero padding) is bilinear_at in
// bilinear.cuh, shared by K1 and K3.
//
// Layouts (the JAX package's ms_deform_attn):
//   value (B, V, heads, D) with V = sum_l H_l * W_l, bf16 or f32;
//   loc   (B, Q, heads, L, P, 2) f32, xy order, in [0, 1] over each level;
//   attn  (B, Q, heads, L, P) in value's dtype;
//   out   (B, Q, heads * D) in value's dtype; sums are kept in f32.
//
// What bounds them on the H100: the gathers.  Every (query, head, point)
// reads four D-wide value rows (4 * 32 * 2 = 256 bytes in bf16) at
// data-dependent addresses, and K3 also writes four D-wide contribution rows;
// there is almost no arithmetic per byte.  The maps are small enough to stay
// in the 50 MB L2 (the 200x200x256 BEV map is 20 MB in bf16, the six
// 29x50x256 camera maps 4.5 MB), so the rate is set by L2 gather throughput
// and by how many warps are in flight.
//
// The design is the simple one: one warp per (b, q, head), lanes over D
// (D = 32 at every flagship site), a loop over levels x points, f32
// accumulation.  K3 reduces the four corner dot products <v_c, g> over D
// with warp shuffles.  Left for later: staging one (camera, head) 1450 x 32
// map in shared memory for the camera cross-attention, 16-byte vector loads
// of two or more channels per lane, and fusing K5 into K3 (atomics straight
// into d_value instead of the contribution rows).

#include "bilinear.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

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
        Bilinear g;
        if (!bilinear_at(lw[2 * i] * W - 0.5f, lw[2 * i + 1] * H - 0.5f, W, H,
                         g))
          continue;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (g.in[c]) s += g.w[c] * to_float(vl[corner_cell(g, c, W) * row]);
        acc += to_float(aw[i]) * s;
      }
    }
    out[warp * D + d] = from_float<T>(acc);
  }
}

// One warp per (b, q, head) of the rows [r0, r0 + n_rows) of the flattened
// (b, q) range.  Contribution row ((local * heads + h) * L * P + i) * 4 + c
// holds g * attn * w_c for corner c of point i, and idx names the row of
// value viewed as (B * V * heads, D) it adds to.  Corners outside the map and
// points that fail the whole-point test get zero rows at an in-range index.
template <typename T>
__global__ void msda_bwd_kernel(const T* __restrict__ value,
                                const float* __restrict__ loc,
                                const T* __restrict__ attn,
                                const T* __restrict__ grad,
                                T* __restrict__ d_attn,
                                float* __restrict__ d_loc,
                                T* __restrict__ contrib,
                                int* __restrict__ idx, int V, int Q,
                                int heads, int D, int L, int P, long long r0,
                                long long n_warps, Levels lv) {
  const long long local =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (local >= n_warps) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const long long warp = r0 * heads + local;  // = (b * Q + q) * heads + h
  const int h = (int)(warp % heads);
  const long long b = warp / heads / Q;
  const long long row = (long long)heads * D;
  const T* vb = value + b * V * row + (long long)h * D;
  const float* lw = loc + warp * L * P * 2;
  const T* aw = attn + warp * L * P;
  const T* gw = grad + warp * D;
  const long long vrow0 = b * V * heads + h;  // idx of value row (b, 0, h)

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const T* vl = vb + (long long)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const long long crow = ((local * L * P) + i) * 4;
      T* cw = contrib + crow * D;
      const float x = lw[2 * i] * W - 0.5f;
      const float y = lw[2 * i + 1] * H - 0.5f;
      Bilinear g;
      if (!bilinear_at(x, y, W, H, g)) {
        for (int c = 0; c < 4; ++c) {
          for (int d = lane; d < D; d += 32) cw[c * D + d] = from_float<T>(0.f);
          if (lane == 0) idx[crow + c] = (int)vrow0;
        }
        if (lane == 0) {
          d_attn[warp * L * P + i] = from_float<T>(0.f);
          d_loc[(warp * L * P + i) * 2] = 0.f;
          d_loc[(warp * L * P + i) * 2 + 1] = 0.f;
        }
        continue;
      }
      const float a = to_float(aw[i]);
      float gv[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = lane; d < D; d += 32) {
        const float gd = to_float(gw[d]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float contribution = 0.f;
          if (g.in[c]) {
            gv[c] += gd * to_float(vl[corner_cell(g, c, W) * row + d]);
            contribution = gd * a * g.w[c];
          }
          cw[c * D + d] = from_float<T>(contribution);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) gv[c] = warp_sum(gv[c]);
      if (lane < 4) {
        idx[crow + lane] = (int)(vrow0 + ((long long)lv.start[l] +
                                          corner_cell(g, lane, W)) * heads);
      }
      if (lane == 0) {
        const float da = g.w[0] * gv[0] + g.w[1] * gv[1] + g.w[2] * gv[2] +
                         g.w[3] * gv[3];
        const float dx =
            ((gv[1] - gv[0]) * (1.f - g.ly) + (gv[3] - gv[2]) * g.ly) * a;
        const float dy =
            ((gv[2] - gv[0]) * (1.f - g.lx) + (gv[3] - gv[1]) * g.lx) * a;
        d_attn[warp * L * P + i] = from_float<T>(da);
        d_loc[(warp * L * P + i) * 2] = dx * W;
        d_loc[(warp * L * P + i) * 2 + 1] = dy * H;
      }
    }
  }
}

unsigned blocks_for(long long n_warps) {
  return (unsigned)((n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

bool read_levels(int L, int P, int D, const int* shapes, Levels& lv) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 1) return false;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[3 * l];
    lv.w[l] = shapes[3 * l + 1];
    lv.start[l] = shapes[3 * l + 2];
  }
  return true;
}

}  // namespace

// shapes: host array of L triples (H_l, W_l, start_l).  dtype: 0 f32, 1 bf16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int unibev_msda_fwd(const void* value, const void* loc,
                               const void* attn, void* out, int B, int V,
                               int Q, int heads, int D, int L, int P,
                               const int* shapes, int dtype, void* stream) {
  Levels lv;
  if (!read_levels(L, P, D, shapes, lv)) return cudaErrorInvalidValue;
  const long long n_warps = (long long)B * Q * heads;
  if (n_warps == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    msda_fwd_kernel<float><<<blocks_for(n_warps), kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<float*>(out), V, Q, heads,
        D, L, P, n_warps, lv);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    msda_fwd_kernel<T><<<blocks_for(n_warps), kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const T*>(value), static_cast<const float*>(loc),
        static_cast<const T*>(attn), static_cast<T*>(out), V, Q, heads, D, L,
        P, n_warps, lv);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The backward of the (b, q) rows [r0, r0 + n_rows).  grad (B, Q, heads * D)
// and d_attn in value's dtype, d_loc f32, all full-size; contrib
// (n_rows * heads * L * P * 4, D) in value's dtype and idx (same rows,) int32
// hold this chunk only.
extern "C" int unibev_msda_bwd(const void* value, const void* loc,
                               const void* attn, const void* grad,
                               void* d_attn, void* d_loc, void* contrib,
                               void* idx, int B, int V, int Q, int heads,
                               int D, int L, int P, const int* shapes,
                               long long r0, long long n_rows, int dtype,
                               void* stream) {
  Levels lv;
  if (!read_levels(L, P, D, shapes, lv)) return cudaErrorInvalidValue;
  if (r0 < 0 || n_rows < 0 || r0 + n_rows > (long long)B * Q)
    return cudaErrorInvalidValue;
  const long long n_warps = n_rows * heads;
  if (n_warps == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    msda_bwd_kernel<float><<<blocks_for(n_warps), kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<const float*>(grad),
        static_cast<float*>(d_attn), static_cast<float*>(d_loc),
        static_cast<float*>(contrib), static_cast<int*>(idx), V, Q, heads, D,
        L, P, r0, n_warps, lv);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    msda_bwd_kernel<T><<<blocks_for(n_warps), kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const T*>(value), static_cast<const float*>(loc),
        static_cast<const T*>(attn), static_cast<const T*>(grad),
        static_cast<T*>(d_attn), static_cast<float*>(d_loc),
        static_cast<T*>(contrib), static_cast<int*>(idx), V, Q, heads, D, L,
        P, r0, n_warps, lv);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
