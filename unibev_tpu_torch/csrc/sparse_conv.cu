// Sparse 3D convolution of the SECOND middle encoder: the rulebook (kernel
// K6), the gather-product conv (kernel K7), and the backward's inverse
// rulebook (kernel K8) and weight gradient (kernel K9).
//
// Replace the XLA ops of unibev_tpu/ops/sparse_conv.py that carry the LiDAR
// branch: subm_neighbor_idx (:170) and strided_neighbor_idx (:1057), the
// rulebook, and gather_conv (:312), which every x-pair / x-quad route of
// best_gather_conv (:833) computes with another packing of the gathered
// rows.  Those packings serve the TPU's gather engine; here a block gathers
// the rows it needs itself.  The backward is the JAX package's gather-only
// VJP (_subm_gc_bwd :370, _strided_xp_bwd :785): d_feats is K7 again, with
// the weight's taps transposed (and, for a submanifold conv, reversed) and,
// for a strided conv, over the inverse rulebook K8 (inverse_strided_idx
// :701); d_weight is K9 (_dw_dot :358).  No scatter anywhere.
//
// K6 unibev_sparse_nbr: nidx[o, k] = table[cell(o * stride - pad + tap_k)],
// or the sentinel when the cell is outside the grid or the output row is
// masked (an empty cell holds the sentinel in the table already).  Taps are
// (dz, dy, dx) row-major with dx fastest, the weight layout.  One thread per
// (row, tap): the kernel is bound by the table reads, one 4-byte load per
// output, scattered over the 340 MB full-resolution table.
//
// K7 unibev_sparse_conv: out[v, :] = mask[v] ? sum_k feats[nidx[v, k], :] @
// W[k * Cin : (k + 1) * Cin, :] : 0, float32 sums, out in feats' dtype.  A
// row index outside [0, V) (the sentinel V) reads zeros.  The JAX op writes
// the (V, K * Cin) columns (104 MB at full resolution, 276 MB at stage 3 in
// bf16) and multiplies them; this kernel never writes them.  A block owns 64
// output rows and up to 128 output channels; for each tap it stages the 64
// gathered feature rows (32 channels at a time) and the tap's weight slice
// in shared memory and accumulates on CUDA cores, 4 rows x (TC / 16)
// channels per thread.  A tap for which none of the block's 64 rows has a
// neighbour is skipped.  What bounds it: CUDA-core FMAs (the flagship's 21
// convs are ~250 GFLOP); tensor cores and a sorted rulebook are later work.
//
// K8 unibev_sparse_inv_nbr: for input row i and tap d, the output row o of
// a strided conv that reads i through d: o = (i + p - d) / s on every axis
// when the division is exact and o is inside the output grid, looked up in
// the output resolution's table; else the sentinel (the output capacity,
// passed in: an input whose output site was dropped by the capacity finds
// the sentinel in the table, never a real row).  The numerator is shifted
// by k * s so that it stays non-negative, as the JAX op does.  A masked
// input row gets the sentinel in every tap.  One thread per (row, tap), like
// K6: bound by writing the (Vin, K) int32 table, a few microseconds; it
// runs at the latency of a launch.
//
// K9 unibev_sparse_conv_wgrad: dW[k * Cin + c, n] = sum_v feats_pad[nidx[v,
// k], c] * g[v, n], float32 products and sums, dW float32 whatever the
// inputs' dtype.  A block owns one tap, one span of rows and a TI x TO
// (input x output channel) patch of dW: it stages 64 gathered feature rows
// and the matching 64 rows of g in shared memory, zero for the sentinel (g
// is not even read there), and accumulates the patch in registers on CUDA
// cores, (TI / 16) x (TO / 16) per thread; a step whose 64 rows all miss
// the tap is skipped, as in K7.  At the end each thread atomicAdds its part
// of the patch into dW, which the wrapper zeroes: a span of 256 to 4096
// rows, chosen so that the grid has about 1024 blocks or more, bounds the
// atomics to a few per element of dW.  The atomics sum the spans in an
// order that changes from run to run, so the last bits of dW do too.  What
// bounds it: CUDA-core FMAs, the same contraction as K7's forward;
// tensor cores are later work.

#include "bilinear.cuh"

namespace {

__global__ void sparse_nbr_kernel(const int* __restrict__ table,
                                  const int* __restrict__ coords,
                                  const unsigned char* __restrict__ mask,
                                  int* __restrict__ out, long long n, int K,
                                  int D, int H, int W, int kz, int ky, int kx,
                                  int sz, int sy, int sx, int pz, int py,
                                  int px, int sentinel, long long table_size) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i / K;
  const int k = (int)(i - o * K);
  int row = sentinel;
  if (mask[o]) {
    const int dx = k % kx;
    const int dy = (k / kx) % ky;
    const int dz = k / (kx * ky);
    const int* c = coords + 4 * o;  // (b, z, y, x)
    const int z = c[1] * sz - pz + dz;
    const int y = c[2] * sy - py + dy;
    const int x = c[3] * sx - px + dx;
    if (z >= 0 && z < D && y >= 0 && y < H && x >= 0 && x < W) {
      const long long cell = (((long long)c[0] * D + z) * H + y) * W + x;
      if (cell >= 0 && cell < table_size) row = table[cell];
    }
  }
  out[i] = row;
}

constexpr int kRows = 64;     // output rows per block
constexpr int kChunk = 32;    // input channels staged at a time
constexpr int kThreads = 256;

template <typename T, int TC>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_kernel(const T* __restrict__ feats,
                       const int* __restrict__ nidx,
                       const T* __restrict__ weight,
                       const unsigned char* __restrict__ mask,
                       T* __restrict__ out, long long Vout, int K, int Cin,
                       int Cout, int V) {
  constexpr int kCols = TC / 16;  // output channels per thread
  __shared__ float a_s[kRows][kChunk + 1];
  __shared__ float b_s[kChunk][TC];
  __shared__ int rows[kRows];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long v0 = (long long)blockIdx.x * kRows;
  const int n0 = blockIdx.y * TC;

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    int r = -1;
    if (tid < kRows && v0 + tid < Vout) {
      r = nidx[(v0 + tid) * K + k];
      if (r < 0 || r >= V) r = -1;
    }
    if (tid < kRows) rows[tid] = r;
    // a barrier for rows[], and the block skips the tap if no row reads
    if (!__syncthreads_or(r >= 0)) continue;

    for (int c0 = 0; c0 < Cin; c0 += kChunk) {
      const int kc = min(kChunk, Cin - c0);
      for (int e = tid; e < kRows * kChunk; e += kThreads) {
        const int rr = e / kChunk;
        const int c = e - rr * kChunk;
        const int src = rows[rr];
        float v = 0.f;
        if (c < kc && src >= 0) v = to_float(feats[(long long)src * Cin + c0 + c]);
        a_s[rr][c] = v;
      }
      for (int e = tid; e < kChunk * TC; e += kThreads) {
        const int c = e / TC;
        const int n = e - c * TC;
        float v = 0.f;
        if (c < kc && n0 + n < Cout)
          v = to_float(weight[((long long)k * Cin + c0 + c) * Cout + n0 + n]);
        b_s[c][n] = v;
      }
      __syncthreads();
      for (int c = 0; c < kc; ++c) {
        float a[4], b[kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = a_s[ty + 16 * i][c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) b[j] = b_s[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long v = v0 + ty + 16 * i;
    if (v >= Vout) continue;
    const bool keep = mask[v] != 0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) out[v * Cout + n] = from_float<T>(keep ? acc[i][j] : 0.f);
    }
  }
}

template <typename T, int TC>
void launch_conv(const void* feats, const int* nidx, const void* weight,
                 const unsigned char* mask, void* out, long long Vout, int K,
                 int Cin, int Cout, int V, cudaStream_t s) {
  const dim3 grid((unsigned)((Vout + kRows - 1) / kRows),
                  (unsigned)((Cout + TC - 1) / TC));
  sparse_conv_kernel<T, TC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(feats), nidx, static_cast<const T*>(weight), mask,
      static_cast<T*>(out), Vout, K, Cin, Cout, V);
}

template <typename T>
void dispatch_conv(const void* feats, const int* nidx, const void* weight,
                   const unsigned char* mask, void* out, long long Vout, int K,
                   int Cin, int Cout, int V, cudaStream_t s) {
  if (Cout <= 16)
    launch_conv<T, 16>(feats, nidx, weight, mask, out, Vout, K, Cin, Cout, V, s);
  else if (Cout <= 32)
    launch_conv<T, 32>(feats, nidx, weight, mask, out, Vout, K, Cin, Cout, V, s);
  else if (Cout <= 64)
    launch_conv<T, 64>(feats, nidx, weight, mask, out, Vout, K, Cin, Cout, V, s);
  else
    launch_conv<T, 128>(feats, nidx, weight, mask, out, Vout, K, Cin, Cout, V, s);
}

__global__ void sparse_inv_nbr_kernel(const int* __restrict__ table,
                                      const int* __restrict__ coords,
                                      const unsigned char* __restrict__ mask,
                                      int* __restrict__ out, long long n,
                                      int K, int Do, int Ho, int Wo, int kz,
                                      int ky, int kx, int sz, int sy, int sx,
                                      int pz, int py, int px, int sentinel,
                                      long long table_size) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long v = i / K;
  const int k = (int)(i - v * K);
  int row = sentinel;
  if (mask[v]) {
    const int dx = k % kx;
    const int dy = (k / kx) % ky;
    const int dz = k / (kx * ky);
    const int* c = coords + 4 * v;  // (b, z, y, x)
    const int vz = c[1] + pz + kz * sz - dz;
    const int vy = c[2] + py + ky * sy - dy;
    const int vx = c[3] + px + kx * sx - dx;
    if (vz % sz == 0 && vy % sy == 0 && vx % sx == 0) {
      const int qz = vz / sz - kz;
      const int qy = vy / sy - ky;
      const int qx = vx / sx - kx;
      if (qz >= 0 && qz < Do && qy >= 0 && qy < Ho && qx >= 0 && qx < Wo) {
        const long long cell = (((long long)c[0] * Do + qz) * Ho + qy) * Wo + qx;
        if (cell >= 0 && cell < table_size) {
          const int r = table[cell];
          if (r >= 0 && r < sentinel) row = r;
        }
      }
    }
  }
  out[i] = row;
}

constexpr int kWRows = 64;  // rows staged at a time by K9

template <typename T, int TI, int TO>
__global__ void __launch_bounds__(kThreads)
    sparse_wgrad_kernel(const T* __restrict__ feats,
                        const int* __restrict__ nidx,
                        const T* __restrict__ g, float* __restrict__ dw,
                        long long Vout, int K, int Cin, int Cout, int V,
                        long long span) {
  constexpr int kI = TI / 16;  // input channels per thread
  constexpr int kO = TO / 16;  // output channels per thread
  __shared__ float a_s[kWRows][TI + 1];
  __shared__ float b_s[kWRows][TO];
  __shared__ int rows[kWRows];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k = blockIdx.y;
  const int tiles_o = (Cout + TO - 1) / TO;
  const int c0 = (int)(blockIdx.z / tiles_o) * TI;
  const int n0 = (int)(blockIdx.z % tiles_o) * TO;
  const long long v_begin = (long long)blockIdx.x * span;
  const long long v_end = min(v_begin + span, Vout);

  float acc[kI][kO];
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int j = 0; j < kO; ++j) acc[i][j] = 0.f;

  bool any = false;  // the same in every thread of the block
  for (long long v0 = v_begin; v0 < v_end; v0 += kWRows) {
    int r = -1;
    if (tid < kWRows && v0 + tid < v_end) {
      r = nidx[(v0 + tid) * K + k];
      if (r < 0 || r >= V) r = -1;
    }
    if (tid < kWRows) rows[tid] = r;
    // a barrier for rows[], and the block skips the step if no row reads
    if (!__syncthreads_or(r >= 0)) continue;
    any = true;
    for (int e = tid; e < kWRows * TI; e += kThreads) {
      const int rr = e / TI;
      const int c = e - rr * TI;
      const int src = rows[rr];
      float x = 0.f;
      if (src >= 0 && c0 + c < Cin) x = to_float(feats[(long long)src * Cin + c0 + c]);
      a_s[rr][c] = x;
    }
    for (int e = tid; e < kWRows * TO; e += kThreads) {
      const int rr = e / TO;
      const int n = e - rr * TO;
      float y = 0.f;
      if (rows[rr] >= 0 && n0 + n < Cout) y = to_float(g[(v0 + rr) * Cout + n0 + n]);
      b_s[rr][n] = y;
    }
    __syncthreads();
    for (int rr = 0; rr < kWRows; ++rr) {
      float a[kI], b[kO];
#pragma unroll
      for (int i = 0; i < kI; ++i) a[i] = a_s[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kO; ++j) b[j] = b_s[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kO; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (!any) return;

#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= Cin) continue;
#pragma unroll
    for (int j = 0; j < kO; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) atomicAdd(dw + ((long long)k * Cin + c) * Cout + n, acc[i][j]);
    }
  }
}

template <typename T, int TI, int TO>
void launch_wgrad(const void* feats, const int* nidx, const void* g, float* dw,
                  long long Vout, int K, int Cin, int Cout, int V,
                  cudaStream_t s) {
  const int tiles = ((Cin + TI - 1) / TI) * ((Cout + TO - 1) / TO);
  long long span = 4096;
  while (span > 256 && ((Vout + span - 1) / span) * K * tiles < 1024) span /= 2;
  const dim3 grid((unsigned)((Vout + span - 1) / span), (unsigned)K,
                  (unsigned)tiles);
  sparse_wgrad_kernel<T, TI, TO><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(feats), nidx, static_cast<const T*>(g), dw, Vout,
      K, Cin, Cout, V, span);
}

template <typename T, int TI>
void dispatch_wgrad_out(const void* feats, const int* nidx, const void* g,
                        float* dw, long long Vout, int K, int Cin, int Cout,
                        int V, cudaStream_t s) {
  if (Cout <= 16)
    launch_wgrad<T, TI, 16>(feats, nidx, g, dw, Vout, K, Cin, Cout, V, s);
  else if (Cout <= 32)
    launch_wgrad<T, TI, 32>(feats, nidx, g, dw, Vout, K, Cin, Cout, V, s);
  else
    launch_wgrad<T, TI, 64>(feats, nidx, g, dw, Vout, K, Cin, Cout, V, s);
}

template <typename T>
void dispatch_wgrad(const void* feats, const int* nidx, const void* g,
                    float* dw, long long Vout, int K, int Cin, int Cout, int V,
                    cudaStream_t s) {
  if (Cin <= 16)
    dispatch_wgrad_out<T, 16>(feats, nidx, g, dw, Vout, K, Cin, Cout, V, s);
  else if (Cin <= 32)
    dispatch_wgrad_out<T, 32>(feats, nidx, g, dw, Vout, K, Cin, Cout, V, s);
  else
    dispatch_wgrad_out<T, 64>(feats, nidx, g, dw, Vout, K, Cin, Cout, V, s);
}

}  // namespace

// coords (Vout, 4) int32 (b, z, y, x); mask (Vout,) bool; out (Vout, K)
// int32 with K = kz * ky * kx.  Returns the cudaError_t of the launch.
extern "C" int unibev_sparse_nbr(const void* table, const void* coords,
                                 const void* mask, void* out, long long Vout,
                                 int D, int H, int W, int kz, int ky, int kx,
                                 int sz, int sy, int sx, int pz, int py,
                                 int px, int sentinel, long long table_size,
                                 void* stream) {
  if (Vout < 0 || kz < 1 || ky < 1 || kx < 1 || sz < 1 || sy < 1 || sx < 1)
    return cudaErrorInvalidValue;
  const int K = kz * ky * kx;
  const long long n = Vout * K;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  sparse_nbr_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(coords),
      static_cast<const unsigned char*>(mask), static_cast<int*>(out), n, K,
      D, H, W, kz, ky, kx, sz, sy, sx, pz, py, px, sentinel, table_size);
  return cudaGetLastError();
}

// feats (V, Cin); nidx (Vout, K) int32; weight (K * Cin, Cout) tap-major;
// mask (Vout,) bool; out (Vout, Cout).  dtype: 0 f32, 1 bf16 (feats, weight
// and out).  Returns the cudaError_t of the launch.
extern "C" int unibev_sparse_conv(const void* feats, const void* nidx,
                                  const void* weight, const void* mask,
                                  void* out, long long Vout, int K, int Cin,
                                  int Cout, int V, int dtype, void* stream) {
  if (Vout < 0 || K < 1 || Cin < 1 || Cout < 1 || V < 0)
    return cudaErrorInvalidValue;
  if (Vout == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(nidx);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  if (dtype == 0)
    dispatch_conv<float>(feats, idx, weight, m, out, Vout, K, Cin, Cout, V, s);
  else if (dtype == 1)
    dispatch_conv<__nv_bfloat16>(feats, idx, weight, m, out, Vout, K, Cin,
                                 Cout, V, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// coords_in (Vin, 4) int32 (b, z, y, x); mask_in (Vin,) bool; table (the
// output resolution's cell -> row table, table_size cells); out (Vin, K)
// int32 output rows, sentinel where no output row reads the input through
// the tap.  Returns the cudaError_t of the launch.
extern "C" int unibev_sparse_inv_nbr(const void* table, const void* coords,
                                     const void* mask, void* out,
                                     long long Vin, int Do, int Ho, int Wo,
                                     int kz, int ky, int kx, int sz, int sy,
                                     int sx, int pz, int py, int px,
                                     int sentinel, long long table_size,
                                     void* stream) {
  if (Vin < 0 || kz < 1 || ky < 1 || kx < 1 || sz < 1 || sy < 1 || sx < 1 ||
      pz < 0 || py < 0 || px < 0)
    return cudaErrorInvalidValue;
  const int K = kz * ky * kx;
  const long long n = Vin * K;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  sparse_inv_nbr_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(coords),
      static_cast<const unsigned char*>(mask), static_cast<int*>(out), n, K,
      Do, Ho, Wo, kz, ky, kx, sz, sy, sx, pz, py, px, sentinel, table_size);
  return cudaGetLastError();
}

// feats (V, Cin); nidx (Vout, K) int32; g (Vout, Cout); dw (K * Cin, Cout)
// float32, zeroed by the caller, the sums added into it.  dtype: 0 f32, 1
// bf16 (feats and g).  Returns the cudaError_t of the launch.
extern "C" int unibev_sparse_conv_wgrad(const void* feats, const void* nidx,
                                        const void* g, void* dw,
                                        long long Vout, int K, int Cin,
                                        int Cout, int V, int dtype,
                                        void* stream) {
  if (Vout < 0 || K < 1 || K > 65535 || Cin < 1 || Cout < 1 || V < 0)
    return cudaErrorInvalidValue;
  if (Vout == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(nidx);
  float* out = static_cast<float*>(dw);
  if (dtype == 0)
    dispatch_wgrad<float>(feats, idx, g, out, Vout, K, Cin, Cout, V, s);
  else if (dtype == 1)
    dispatch_wgrad<__nv_bfloat16>(feats, idx, g, out, Vout, K, Cin, Cout, V, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
