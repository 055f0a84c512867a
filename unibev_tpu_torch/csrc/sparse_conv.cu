// Sparse 3D convolution of the SECOND middle encoder: the rulebook (kernel
// K6) and the gather-product conv (kernel K7).
//
// Replace the XLA ops of unibev_tpu/ops/sparse_conv.py that carry the LiDAR
// branch: subm_neighbor_idx (:170) and strided_neighbor_idx (:1057), the
// rulebook, and gather_conv (:312), which every x-pair / x-quad route of
// best_gather_conv (:833) computes with another packing of the gathered
// rows.  Those packings serve the TPU's gather engine; here a block gathers
// the rows it needs itself.
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
