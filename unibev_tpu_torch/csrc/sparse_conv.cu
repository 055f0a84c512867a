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
// output rows and BN (16 to 128) output channels and writes each output
// element once, without atomics, so the result is deterministic:
//   * it reads its (64 x K) index tile once into shared memory and compacts,
//     with one ballot per tap, the list of taps that hold a live row in the
//     tile; only those taps are visited (at res 0-2 the rows are sparse and
//     many taps of a tile are empty; at res 3, 40,000 of 162,000 cells, most
//     are live);
//   * for each (live tap, chunk of up to 128 input channels) it stages the
//     64 gathered rows A and the tap's (Cin x BN) weight slice B in shared
//     memory with 16-byte cp.async copies (a sentinel row and the channels
//     past Cin are zero-filled, not read), two stages deep: the copies of
//     the next item fly while this one is multiplied, one barrier per item.
//     Widths that are not a 16-byte multiple (conv_input's Cin = 5) take
//     plain loads into the same layout;
//   * bf16 multiplies on the tensor cores with mma.sync m16n8k16 (float32
//     sums in registers), A by ldmatrix and B, stored k-major, by
//     ldmatrix.trans; the k depth is Cin padded to 16 with zeros.  mma.sync
//     and not wgmma: the products are small (the flagship's 21 convs bound
//     at ~0.18 ms) and come in 64-row tiles whose rows are gathered, so
//     taking the multiply off the critical path is what counts;
//   * float32 keeps exact float32 FMAs on CUDA cores (TF32 would break the
//     1e-4 f32 tolerance; no main path runs K7 in f32) with the same
//     live-tap loop and staged copies, 32 channels per stage.
// What bounds it: the gathers (each live (row, tap) reads a Cin-wide row,
// from L2 at the flagship's sizes) and, at res 3, the product.
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

#include <atomic>
#include <cstdint>

#include "bilinear.cuh"
#include "tensor_core.cuh"

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

constexpr int kRows = 64;      // output rows per block
constexpr int kThreads = 256;  // 8 warps

// K7's shared memory, byte offsets from the start of the block's dynamic
// shared memory: the (kRows x K) index tile; the live-tap area (K flags, the
// list of live taps, their count); then two stages, each the gathered rows A
// (kRows x kc, row pitch a_pitch) followed by the tap's weight rows B (kc x
// BN, row pitch b_pitch).  Both pitches carry 16 bytes of padding, so that
// the eight 16-byte rows one ldmatrix reads fall on distinct banks.
struct ConvLayout {
  int kc;        // input channels per stage (bf16: a multiple of 16)
  int chunks;    // stages per tap, ceil(Cin / kc)
  int a_pitch;   // elements
  int b_pitch;   // elements
  int b_offset;  // elements from a stage's start to its B
  int stage;     // bytes per stage, a multiple of 16
  int taps;      // byte offset of the live-tap area
  int stages;    // byte offset of stage 0, 128-aligned
  int bytes;     // in all
};

template <typename T, int BN>
ConvLayout conv_layout(int K, int Cin) {
  constexpr int kE = 16 / sizeof(T);                // elements per 16 bytes
  constexpr int kStep = sizeof(T) == 2 ? 16 : kE;   // bf16: the mma's depth
  constexpr int kMaxChunk = sizeof(T) == 2 ? 128 : 32;
  ConvLayout c;
  const int padded = (Cin + kStep - 1) / kStep * kStep;
  c.kc = padded < kMaxChunk ? padded : kMaxChunk;
  c.chunks = (Cin + c.kc - 1) / c.kc;
  c.a_pitch = c.kc + kE;
  c.b_pitch = BN + kE;
  c.b_offset = kRows * c.a_pitch;
  c.stage = (c.b_offset + c.kc * c.b_pitch) * (int)sizeof(T);
  c.taps = kRows * K * 4;
  c.stages = (c.taps + 4 * (2 * K + 1) + 127) / 128 * 128;
  c.bytes = c.stages + 2 * c.stage;
  return c;
}

// bf16: one stage's product on the tensor cores.  The 8 warps are 4 (rows)
// x 2 (columns): warp (wm, wn) owns rows wm * 16 .. + 16 and columns wn *
// BN / 2 .. + BN / 2, that is BN / 16 n-tiles of 8 with 4 float32 sums
// each, acc[4 * j + i] (the mma's C fragment of n-tile j).  A is read with
// ldmatrix, B (k-major rows) with ldmatrix.trans.
template <int BN>
__device__ __forceinline__ void stage_product(float (&acc)[BN / 4],
                                              const __nv_bfloat16* a_s,
                                              const __nv_bfloat16* b_s,
                                              const ConvLayout& lay) {
  constexpr int kNT = BN / 16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const __nv_bfloat16* a_row =
      a_s + (wm * 16 + (lane & 15)) * lay.a_pitch + (lane >> 4) * 8;
  const __nv_bfloat16* b_row = b_s + (lane & 15) * lay.b_pitch +
                               wn * (BN / 2) + (kNT > 1 ? (lane >> 4) * 8 : 0);
  for (int kk = 0; kk < lay.kc; kk += 16) {
    unsigned a[4];
    ldmatrix_x4(a, a_row + kk);
    const __nv_bfloat16* b_k = b_row + kk * lay.b_pitch;
    if constexpr (kNT == 1) {
      unsigned b0, b1;
      ldmatrix_x2_trans(b0, b1, b_k);
      mma_bf16(acc, a, b0, b1);
    } else {
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        unsigned b[4];
        ldmatrix_x4_trans(b, b_k + j * 8);
        mma_bf16(acc + 4 * j, a, b[0], b[1]);
        mma_bf16(acc + 4 * (j + 1), a, b[2], b[3]);
      }
    }
  }
}

// float32: exact float32 products on CUDA cores (TF32 would not hold the
// f32 tolerance); thread (tx, ty) owns rows ty + 16 i, i < 4, and columns
// tx + 16 j, j < BN / 16, acc[i * BN / 16 + j].
template <int BN>
__device__ __forceinline__ void stage_product(float (&acc)[BN / 4],
                                              const float* a_s,
                                              const float* b_s,
                                              const ConvLayout& lay) {
  constexpr int kCols = BN / 16;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int c = 0; c < lay.kc; ++c) {
    float a[4], b[kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a_s[(ty + 16 * i) * lay.a_pitch + c];
#pragma unroll
    for (int j = 0; j < kCols; ++j) b[j] = b_s[c * lay.b_pitch + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[i * kCols + j] = fmaf(a[i], b[j], acc[i * kCols + j]);
  }
}

template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 4],
                                           __nv_bfloat16* __restrict__ out,
                                           const unsigned char* __restrict__ mask,
                                           long long v0, int rows, int n0,
                                           int Cout) {
  constexpr int kNT = BN / 16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp & 3;
  const int wn = warp >> 2;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = n0 + wn * (BN / 2) + j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 16 + (lane >> 2) + 8 * half;
      if (r >= rows || n >= Cout) continue;
      const long long v = v0 + r;
      const bool keep = mask[v] != 0;
      const float x = keep ? acc[4 * j + 2 * half] : 0.f;
      const float y = keep ? acc[4 * j + 2 * half + 1] : 0.f;
      __nv_bfloat16* o = out + v * Cout + n;
      if ((Cout & 1) == 0) {  // n is even: n + 1 < Cout, 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x, y);
      } else {
        o[0] = __float2bfloat16(x);
        if (n + 1 < Cout) o[1] = __float2bfloat16(y);
      }
    }
  }
}

template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 4],
                                           float* __restrict__ out,
                                           const unsigned char* __restrict__ mask,
                                           long long v0, int rows, int n0,
                                           int Cout) {
  constexpr int kCols = BN / 16;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const long long v = v0 + r;
    const bool keep = mask[v] != 0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) out[v * Cout + n] = keep ? acc[i * kCols + j] : 0.f;
    }
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_kernel(const T* __restrict__ feats,
                       const int* __restrict__ nidx,
                       const T* __restrict__ weight,
                       const unsigned char* __restrict__ mask,
                       T* __restrict__ out, long long Vout, int K, int Cin,
                       int Cout, int V, ConvLayout lay, bool vec_a,
                       bool vec_b) {
  constexpr int kE = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  int* idx_s = reinterpret_cast<int*>(smem);
  int* flags = reinterpret_cast<int*>(smem + lay.taps);
  int* list = flags + K;  // the live taps in order, then their count
  T* const stage0 = reinterpret_cast<T*>(smem + lay.stages);
  const int stage_elems = lay.stage / (int)sizeof(T);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long v0 = (long long)blockIdx.x * kRows;
  const int n0 = blockIdx.y * BN;
  const int rows = (int)min((long long)kRows, Vout - v0);

  // The index tile, read once, its loads independent of each other: -1
  // for a sentinel or a row past Vout.  A masked output row is not looked
  // at here (its rulebook row holds sentinels); the epilogue writes it as
  // zeros whatever it gathered.
#pragma unroll 4
  for (int e = tid; e < kRows * K; e += kThreads) {
    int src = -1;
    if (e < rows * K) {
      src = nidx[v0 * K + e];
      if (src < 0 || src >= V) src = -1;
    }
    idx_s[e] = src;
  }
  __syncthreads();
  // The taps with at least one live row: a ballot over the 64 rows per tap,
  // then one warp compacts them in order.
  for (int k = warp; k < K; k += kThreads / 32) {
    const bool any = __any_sync(0xffffffffu, idx_s[lane * K + k] >= 0 ||
                                                 idx_s[(lane + 32) * K + k] >= 0);
    if (lane == 0) flags[k] = any;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const bool live = k0 + lane < K && flags[k0 + lane];
      const unsigned bits = __ballot_sync(0xffffffffu, live);
      if (live) list[n + __popc(bits & ((1u << lane) - 1u))] = k0 + lane;
      n += __popc(bits);
    }
    if (lane == 0) list[K] = n;
  }
  __syncthreads();
  const int items = list[K] * lay.chunks;  // (live tap, channel chunk)

  // Stage item `it` into buffer it & 1: the tile's gathered rows of the
  // tap's channel chunk (zeros for -1 rows and past Cin) and the tap's
  // weight rows of the block's columns (zeros past Cin and Cout), by 16-byte
  // cp.async where the widths and pointers allow, else by plain loads.
  auto issue = [&](int it) {
    T* a_s = stage0 + (it & 1) * stage_elems;
    T* b_s = a_s + lay.b_offset;
    const int k = list[it / lay.chunks];
    const int c0 = (it % lay.chunks) * lay.kc;
    const int kc = lay.kc;
    if (vec_a) {
      const int segs = kc / kE;
      for (int e = tid; e < kRows * segs; e += kThreads) {
        const int r = e / segs;
        const int c = (e - r * segs) * kE;
        const int src = idx_s[r * K + k];
        const bool ok = src >= 0 && c0 + c < Cin;
        cp_async16(a_s + r * lay.a_pitch + c,
                   ok ? feats + (long long)src * Cin + c0 + c : feats,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kRows * kc; e += kThreads) {
        const int r = e / kc;
        const int c = e - r * kc;
        const int src = idx_s[r * K + k];
        a_s[r * lay.a_pitch + c] = (src >= 0 && c0 + c < Cin)
                                       ? feats[(long long)src * Cin + c0 + c]
                                       : from_float<T>(0.f);
      }
    }
    const T* wk = weight + ((long long)k * Cin + c0) * Cout + n0;
    if (vec_b) {
      constexpr int segs = BN / kE;
      for (int e = tid; e < kc * segs; e += kThreads) {
        const int c = e / segs;
        const int n = (e - c * segs) * kE;
        const bool ok = c0 + c < Cin && n0 + n < Cout;
        cp_async16(b_s + c * lay.b_pitch + n,
                   ok ? wk + (long long)c * Cout + n : weight, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kc * BN; e += kThreads) {
        const int c = e / BN;
        const int n = e - c * BN;
        b_s[c * lay.b_pitch + n] = (c0 + c < Cin && n0 + n < Cout)
                                       ? wk[(long long)c * Cout + n]
                                       : from_float<T>(0.f);
      }
    }
    cp_async_commit();
  };

  float acc[BN / 4];
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) acc[i] = 0.f;
  // Two stages, one barrier per item: the barrier publishes item `it` and
  // frees the other buffer, whose copies for `it + 1` then fly while `it`
  // is multiplied.
  if (items > 0) issue(0);
  for (int it = 0; it < items; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < items) issue(it + 1);
    const T* a_s = stage0 + (it & 1) * stage_elems;
    stage_product<BN>(acc, a_s, a_s + lay.b_offset, lay);
  }
  store_tile<BN>(acc, out, mask, v0, rows, n0, Cout);
}

template <typename T, int BN>
cudaError_t launch_conv(const void* feats, const int* nidx,
                        const void* weight, const unsigned char* mask,
                        void* out, long long Vout, int K, int Cin, int Cout,
                        int V, cudaStream_t s) {
  constexpr int kE = 16 / sizeof(T);
  const ConvLayout lay = conv_layout<T, BN>(K, Cin);
  if (lay.bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = allow_max_smem(sparse_conv_kernel<T, BN>, smem_set);
  if (err != cudaSuccess) return err;
  const bool vec_a =
      Cin % kE == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const bool vec_b =
      Cout % kE == 0 && reinterpret_cast<uintptr_t>(weight) % 16 == 0;
  const dim3 grid((unsigned)((Vout + kRows - 1) / kRows),
                  (unsigned)((Cout + BN - 1) / BN));
  sparse_conv_kernel<T, BN><<<grid, kThreads, lay.bytes, s>>>(
      static_cast<const T*>(feats), nidx, static_cast<const T*>(weight), mask,
      static_cast<T*>(out), Vout, K, Cin, Cout, V, lay, vec_a, vec_b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_conv(const void* feats, const int* nidx,
                          const void* weight, const unsigned char* mask,
                          void* out, long long Vout, int K, int Cin, int Cout,
                          int V, cudaStream_t s) {
  if (Cout <= 16)
    return launch_conv<T, 16>(feats, nidx, weight, mask, out, Vout, K, Cin,
                              Cout, V, s);
  if (Cout <= 32)
    return launch_conv<T, 32>(feats, nidx, weight, mask, out, Vout, K, Cin,
                              Cout, V, s);
  if (Cout <= 64)
    return launch_conv<T, 64>(feats, nidx, weight, mask, out, Vout, K, Cin,
                              Cout, V, s);
  return launch_conv<T, 128>(feats, nidx, weight, mask, out, Vout, K, Cin,
                             Cout, V, s);
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
    return dispatch_conv<float>(feats, idx, weight, m, out, Vout, K, Cin,
                                Cout, V, s);
  if (dtype == 1)
    return dispatch_conv<__nv_bfloat16>(feats, idx, weight, m, out, Vout, K,
                                        Cin, Cout, V, s);
  return cudaErrorInvalidValue;
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
