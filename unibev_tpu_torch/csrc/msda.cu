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
// writes d_attn and d_loc and adds d_value straight into a float32 table
// with vector reductions (scatter.cuh); the JAX backward's contribution
// rows and their scatter-add (the Pallas kernel scatter_pallas.py, ported
// as K5) have no counterpart on this path.
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
// data-dependent addresses; there is almost no arithmetic per byte.  The
// maps are small enough to stay in the 50 MB L2 (the 200x200x256 BEV map is
// 20 MB in bf16, the six 29x50x256 camera maps 4.5 MB), so the rate is set
// by L2 gather throughput and by how many warps are in flight.  K3 adds, on
// top, four D-wide float32 rows per point into its table (512 bytes in
// reductions): 655 MB a call at the flagship's TSA.
//
// K1: one thread per (b, q, head, group of VEC channels), VEC channels per
// 16-byte access where D and value's alignment allow (8 in bf16, 4 in f32:
// 4 threads per (query, head) at D = 32), else 8, 4 or 2 bytes; the
// wrapper (ops/msda.py::msda_fwd_route) chooses the width.  Each thread
// reads its points' loc and attn once, computes their geometry once, issues
// one vector load per live corner, four points at a time (16 loads in
// flight), and sums VEC float32 channels.  Every site gathers from global
// memory (L2 at the flagship's sizes).  A variant that first copied one
// head's small camera map (29x50, 92.8 KB in bf16) into shared memory, the
// Pallas kernel's idea, gained the camera SCA about 7% on the H100 (PERF.md
// section 6): too little to keep a second kernel for.
// K3 (ops/msda.py::msda_bwd_plan): `lanes` threads per (b, q, head),
// each owning chunks of VEC <= 4 channels (at D = 32, 4 threads of two
// chunks of 4 bf16 channels: 8-byte loads of the corners and of grad), so
// that each live corner's g * attn * w_c goes from registers into the
// table as one 16-byte reduction per chunk, the item's lanes covering 64
// contiguous bytes an instruction.  The shares of d_attn and d_loc (linear
// in the four corner dot products <v_c, g>) are summed over the item's
// lanes with a 4-lane shuffle.  Measured at the flagship's sites (PERF.md
// section 6): 16-byte loads of 8 channels, whose two reductions a lane lie
// 32 bytes apart, took ~15% longer, and 8 threads of one chunk ~10%
// longer.  One launch per call and no contribution rows: four bf16 rows
// per point, written and read back by a scatter-add, would come to 7 GB an
// LC train step.  Map and table side by side: the camera SCA's (4.5 + 9
// MB) and, just, the LiDAR SCA's (17 + 33 MB) fit the 50 MB L2; at TSA,
// the decoder and the LiDAR TSA (20 + 41 MB) the gathers and the
// reductions share L2 with some traffic to HBM.  Without the reductions a
// call kept ~88% of its time (8 threads a point, PERF.md section 6): the
// gathers, the geometry and the shuffles per point, not the atomics, set
// it.

#include <cstdint>

#include "bilinear.cuh"
#include "scatter.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kFwdThreads = 256;   // K1
constexpr int kBatch = 4;          // points whose corner loads K1 issues together
constexpr int kBwdThreads = 256;   // K3
constexpr int kBwdBatch = 2;       // points whose corner loads K3 issues together

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

template <typename T, int VEC>
__device__ __forceinline__ void store_chunk(T* p, const float (&acc)[VEC]) {
  typename Chunk<T, VEC>::Raw raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(acc[i]);
  *reinterpret_cast<typename Chunk<T, VEC>::Raw*>(p) = raw;
}

// acc += sum over the n points of one level of attn * the bilinear sample
// of the VEC channels at `base` (the thread's channels of the level's cell
// 0, `row` elements between cells).  Each thread reads its points' loc and
// attn once and computes their geometry once; the points go in batches of
// kBatch, whose 4 * kBatch corner loads are all issued before the first is
// used.  A corner outside the map, or a point
// that fails the whole-point test, loads nothing and adds zero.
template <typename T, int VEC>
__device__ __forceinline__ void sample_level(const T* base, long long row,
                                             const float* __restrict__ lw,
                                             const T* __restrict__ aw, int W,
                                             int H, int n, float (&acc)[VEC]) {
  for (int p0 = 0; p0 < n; p0 += kBatch) {
    Chunk<T, VEC> v[kBatch][4];
    float w[kBatch][4];
    float a[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int p = p0 + j;
      Bilinear g;
      const bool ok = p < n && bilinear_at(lw[2 * p] * W - 0.5f,
                                           lw[2 * p + 1] * H - 0.5f, W, H, g);
      a[j] = ok ? to_float(aw[p]) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = ok && g.in[c];
        w[j][c] = in ? g.w[c] : 0.f;
        if (in)
          v[j][c].load(base + corner_cell(g, c, W) * row);
        else
          v[j][c].clear();
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      float s[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) s[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < VEC; ++i) s[i] += w[j][c] * v[j][c].get(i);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += a[j] * s[i];
    }
  }
}

// K1: one thread per (b, q, head, group of VEC channels), the map read
// from global memory.
template <typename T, int VEC>
__global__ void __launch_bounds__(kFwdThreads)
    msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const T* __restrict__ attn, T* __restrict__ out, int V,
                    int Q, int heads, int D, int L, int P, long long n_threads,
                    Levels lv) {
  const long long t = (long long)blockIdx.x * kFwdThreads + threadIdx.x;
  if (t >= n_threads) return;
  const int groups = D / VEC;
  const long long item = t / groups;  // (b * Q + q) * heads + h
  const int g = (int)(t - item * groups);
  const int h = (int)(item % heads);
  const long long b = item / heads / Q;
  const long long row = (long long)heads * D;  // elements between value rows
  const T* vb = value + b * V * row + (long long)h * D + g * VEC;
  const float* lw = loc + item * L * P * 2;
  const T* aw = attn + item * L * P;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int l = 0; l < L; ++l)
    sample_level<T, VEC>(vb + (long long)lv.start[l] * row, row, lw + 2 * l * P,
                         aw + l * P, lv.w[l], lv.h[l], P, acc);
  store_chunk<T, VEC>(out + item * D + g * VEC, acc);
}

template <typename T, int VEC>
cudaError_t launch_fwd(const void* value, const void* loc, const void* attn,
                       void* out, int B, int V, int Q, int heads, int D, int L,
                       int P, const Levels& lv, cudaStream_t s) {
  const long long n = (long long)B * Q * heads * (D / VEC);
  msda_fwd_kernel<T, VEC>
      <<<(unsigned)((n + kFwdThreads - 1) / kFwdThreads), kFwdThreads, 0, s>>>(
          static_cast<const T*>(value), static_cast<const float*>(loc),
          static_cast<const T*>(attn), static_cast<T*>(out), V, Q, heads, D, L,
          P, n, lv);
  return cudaGetLastError();
}

// K3: `lanes` threads per (b, q, head) item, each owning the VEC-channel
// chunks lane, lane + lanes, ... of the D channels (two at the flagship's
// D = 32: 4 threads of 2 x 4 bf16 channels).  For each point it loads its
// chunks of the four corners and of grad, forms its share of the corner
// dot products <v_c, g> and adds g * attn * w_c for each live corner into
// the f32 table (value's layout) with add_f32's vector reductions.  The
// shares of d_attn and d_loc are summed over the item's lanes, and one
// lane writes them.  Points go in batches of kBwdBatch, whose corner loads
// are issued together.  A point that fails the whole-point test gets zero
// d_attn and d_loc and adds nothing; a corner outside the map loads and
// adds nothing.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
    msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const T* __restrict__ attn, const T* __restrict__ grad,
                    T* __restrict__ d_attn, float* __restrict__ d_loc,
                    float* __restrict__ table, int V, int Q, int heads, int D,
                    int L, int P, int lanes, long long n_threads, Levels lv) {
  const long long t = (long long)blockIdx.x * kBwdThreads + threadIdx.x;
  if (t >= n_threads) return;  // whole groups: n_threads = items * lanes
  const int shift = __ffs(lanes) - 1;
  const long long item = t >> shift;  // (b * Q + q) * heads + h
  const int lane = (int)(t & (lanes - 1));
  const unsigned mask = group_mask(lanes);
  const int groups = D / VEC;
  const int h = (int)(item % heads);
  const long long b = item / heads / Q;
  const long long row = (long long)heads * D;  // elements between value rows
  // element offset of (b, cell 0, h, channel 0), in value and in the table
  const long long base = b * V * row + (long long)h * D;
  const float* lw = loc + item * L * P * 2;
  const T* aw = attn + item * L * P;
  const T* gw = grad + item * D;

  for (int l = 0; l < L; ++l) {
    const int W = lv.w[l];
    const int H = lv.h[l];
    const long long lbase = base + (long long)lv.start[l] * row;
    for (int p0 = 0; p0 < P; p0 += kBwdBatch) {
      Bilinear g[kBwdBatch];
      bool ok[kBwdBatch];
      float a[kBwdBatch];
      float gv[kBwdBatch][4];
#pragma unroll
      for (int j = 0; j < kBwdBatch; ++j) {
        const int i = l * P + p0 + j;
        ok[j] = p0 + j < P && bilinear_at(lw[2 * i] * W - 0.5f,
                                          lw[2 * i + 1] * H - 0.5f, W, H, g[j]);
        a[j] = ok[j] ? to_float(aw[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) gv[j][c] = 0.f;
      }
      for (int ch = lane; ch < groups; ch += lanes) {
        Chunk<T, VEC> gc;
        gc.load(gw + ch * VEC);
        Chunk<T, VEC> v[kBwdBatch][4];
#pragma unroll
        for (int j = 0; j < kBwdBatch; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (ok[j] && g[j].in[c])
              v[j][c].load(value + lbase + corner_cell(g[j], c, W) * row +
                           ch * VEC);
            else
              v[j][c].clear();
          }
#pragma unroll
        for (int j = 0; j < kBwdBatch; ++j) {
          float ga[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) ga[i] = gc.get(i) * a[j];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float s = 0.f;
#pragma unroll
            for (int i = 0; i < VEC; ++i) s += gc.get(i) * v[j][c].get(i);
            gv[j][c] += s;
            if (ok[j] && g[j].in[c]) {
              float add[VEC];
#pragma unroll
              for (int i = 0; i < VEC; ++i) add[i] = ga[i] * g[j].w[c];
              add_f32<VEC>(table + lbase + corner_cell(g[j], c, W) * row +
                               ch * VEC,
                           add);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBwdBatch; ++j) {
        if (p0 + j >= P) break;  // uniform across the item's lanes
        // d_attn and d_loc are linear in the corner sums: each lane forms
        // its share from its own, and three values are summed over the
        // item's lanes instead of four
        float da = 0.f, dx = 0.f, dy = 0.f;
        if (ok[j]) {
          const Bilinear& q = g[j];
          da = q.w[0] * gv[j][0] + q.w[1] * gv[j][1] + q.w[2] * gv[j][2] +
               q.w[3] * gv[j][3];
          dx = ((gv[j][1] - gv[j][0]) * (1.f - q.ly) +
                (gv[j][3] - gv[j][2]) * q.ly) * a[j] * W;
          dy = ((gv[j][2] - gv[j][0]) * (1.f - q.lx) +
                (gv[j][3] - gv[j][1]) * q.lx) * a[j] * H;
        }
        da = group_sum(da, lanes, mask);
        dx = group_sum(dx, lanes, mask);
        dy = group_sum(dy, lanes, mask);
        if (lane != (j & (lanes - 1))) continue;
        const long long i = item * L * P + l * P + p0 + j;
        d_attn[i] = from_float<T>(da);
        *reinterpret_cast<float2*>(d_loc + 2 * i) = make_float2(dx, dy);
      }
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* value, const void* loc, const void* attn,
                       const void* grad, void* d_attn, void* d_loc,
                       void* table, int B, int V, int Q, int heads, int D,
                       int L, int P, int lanes, const Levels& lv,
                       cudaStream_t s) {
  const long long n = (long long)B * Q * heads * lanes;
  msda_bwd_kernel<T, VEC>
      <<<(unsigned)((n + kBwdThreads - 1) / kBwdThreads), kBwdThreads, 0, s>>>(
          static_cast<const T*>(value), static_cast<const float*>(loc),
          static_cast<const T*>(attn), static_cast<const T*>(grad),
          static_cast<T*>(d_attn), static_cast<float*>(d_loc),
          static_cast<float*>(table), V, Q, heads, D, L, P, lanes, n, lv);
  return cudaGetLastError();
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
// vec: channels per access (D % vec == 0, value and out aligned to vec
// elements; at most 16 bytes), chosen by the wrapper's msda_fwd_route.
// Returns the cudaError_t of the launch.
extern "C" int unibev_msda_fwd(const void* value, const void* loc,
                               const void* attn, void* out, int B, int V,
                               int Q, int heads, int D, int L, int P,
                               const int* shapes, int dtype, int vec,
                               void* stream) {
  Levels lv;
  if (!read_levels(L, P, D, shapes, lv)) return cudaErrorInvalidValue;
  const int size = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (size == 0 || vec < 1 || D % vec != 0 || 16 % (vec * size) != 0 ||
      reinterpret_cast<uintptr_t>(value) % (vec * size) != 0 ||
      reinterpret_cast<uintptr_t>(out) % (vec * size) != 0)
    return cudaErrorInvalidValue;
  if ((long long)B * Q * heads == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  const int key = dtype * 100 + vec;
  switch (key) {
    case 4:
      return launch_fwd<float, 4>(value, loc, attn, out, B, V, Q, heads, D, L,
                                  P, lv, s);
    case 2:
      return launch_fwd<float, 2>(value, loc, attn, out, B, V, Q, heads, D, L,
                                  P, lv, s);
    case 1:
      return launch_fwd<float, 1>(value, loc, attn, out, B, V, Q, heads, D, L,
                                  P, lv, s);
    case 108:
      return launch_fwd<BF, 8>(value, loc, attn, out, B, V, Q, heads, D, L, P,
                               lv, s);
    case 104:
      return launch_fwd<BF, 4>(value, loc, attn, out, B, V, Q, heads, D, L, P,
                               lv, s);
    case 102:
      return launch_fwd<BF, 2>(value, loc, attn, out, B, V, Q, heads, D, L, P,
                               lv, s);
    case 101:
      return launch_fwd<BF, 1>(value, loc, attn, out, B, V, Q, heads, D, L, P,
                               lv, s);
    default:
      return cudaErrorInvalidValue;
  }
}


// The backward.  grad (B, Q, heads * D) and d_attn in value's dtype, d_loc
// f32; table (B * V * heads, D) f32, zeroed by the caller, takes d_value.
// vec: channels per access, at most 4 (D % vec == 0; value and grad
// aligned to vec elements, the table to vec floats); lanes: threads per
// (b, q, head), which must be group_lanes((D / vec + 1) / 2) (ops/msda.py::
// msda_bwd_plan).  Returns the cudaError_t of the launch.
extern "C" int unibev_msda_bwd(const void* value, const void* loc,
                               const void* attn, const void* grad,
                               void* d_attn, void* d_loc, void* table, int B,
                               int V, int Q, int heads, int D, int L, int P,
                               const int* shapes, int dtype, int vec,
                               int lanes, void* stream) {
  Levels lv;
  if (!read_levels(L, P, D, shapes, lv)) return cudaErrorInvalidValue;
  const int size = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (size == 0 || vec < 1 || D % vec != 0 || 16 % (vec * size) != 0 ||
      reinterpret_cast<uintptr_t>(value) % (vec * size) != 0 ||
      reinterpret_cast<uintptr_t>(grad) % (vec * size) != 0 ||
      reinterpret_cast<uintptr_t>(table) % (4 * vec) != 0 || vec > 4 ||
      lanes != group_lanes((D / vec + 1) / 2))
    return cudaErrorInvalidValue;
  if ((long long)B * Q * heads == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  switch (dtype * 100 + vec) {
    case 4:
      return launch_bwd<float, 4>(value, loc, attn, grad, d_attn, d_loc, table,
                                  B, V, Q, heads, D, L, P, lanes, lv, s);
    case 2:
      return launch_bwd<float, 2>(value, loc, attn, grad, d_attn, d_loc, table,
                                  B, V, Q, heads, D, L, P, lanes, lv, s);
    case 1:
      return launch_bwd<float, 1>(value, loc, attn, grad, d_attn, d_loc, table,
                                  B, V, Q, heads, D, L, P, lanes, lv, s);
    case 104:
      return launch_bwd<BF, 4>(value, loc, attn, grad, d_attn, d_loc, table, B,
                               V, Q, heads, D, L, P, lanes, lv, s);
    case 102:
      return launch_bwd<BF, 2>(value, loc, attn, grad, d_attn, d_loc, table, B,
                               V, Q, heads, D, L, P, lanes, lv, s);
    case 101:
      return launch_bwd<BF, 1>(value, loc, attn, grad, d_attn, d_loc, table, B,
                               V, Q, heads, D, L, P, lanes, lv, s);
    default:
      return cudaErrorInvalidValue;
  }
}
