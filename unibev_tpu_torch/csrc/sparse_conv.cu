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
// The tables (ops/sparse_conv.py::CompactTable): a bitmap of the occupied
// cells of a resolution, 32 cells a word over the flat cell index (b, z, y,
// x), the set bits before each word, and the row of each of the first
// n_rows ranks.  Cell c's rank is base[c >> 5] + popc(bits[c >> 5] & ((1 <<
// (c & 31)) - 1)); its row is rows[rank] if its bit is set and the rank is
// below n_rows (past it: a site a downsample dropped for the capacity), else
// the sentinel.  At res 0 that is 21 MB, where a dense int32 table takes
// 340 MB: the whole table stays in the 50 MB L2.
// The JAX package reads a dense table through its window3_lookup (:119).
//
// K6 unibev_sparse_nbr: nidx[o, k] = row(cell(o * stride - pad + tap_k)),
// or the sentinel when the cell is outside the grid or the output row is
// masked.  Taps are (dz, dy, dx) row-major with dx fastest, the weight
// layout.  One thread per (output row, dz, dy) plane: the plane's kx cells
// are consecutive flat cells, so the thread reads the one or two words that
// hold them once (ld.global.nc: read-only, L2-resident), and a word's count
// and a map entry per occupied cell, and writes the plane's kx entries.  It
// is bound by the rulebook it writes and the latency of its dependent loads
// (word, then map entry); at the flagship's sites it runs near the latency
// of a launch.
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
// passed in: a site dropped by the capacity is empty in the table, never a
// real row).  The numerator is shifted by k * s so that it stays
// non-negative, as the JAX op does.  A masked input row gets the sentinel
// in every tap.  One thread per (input row, dz, dy) plane, like K6: the
// parity test on z and y comes first, then on each x tap, and only the taps
// that pass it touch the table (6-8 of the 27 taps of a k3 s2 row).  Bound
// by writing the (Vin, K) int32 table, a few microseconds.
//
// K9 unibev_sparse_conv_wgrad: dW[k * Cin + c, n] = sum_v feats_pad[nidx[v,
// k], c] * g[v, n], float32 sums, dW float32 whatever the inputs' dtype; a
// sentinel entry adds nothing.  Replaces _dw_dot (:358), one bf16
// contraction on the TPU's matrix unit with float32 sums.  The launch plan
// (span, chunk, tiles, shared memory) is ops/sparse_conv.py::wgrad_plan; the
// entry point refuses a plan that disagrees with its own layout.
//   * bf16, on the tensor cores: a block owns a span of output rows, KC
//     input channels (Cin padded to 16, at most 128) and BN output channels
//     (16 to 128).  It reads the span's (rows x K) index tile once,
//     coalesced, into shared memory and compacts, with one ballot per (tap,
//     chunk of rows), the (tap, chunk) items that hold a live row, tap by
//     tap; empty items are never visited (at res 0-2 most are empty).  It
//     stages the span's g slice once, zero for a row with no live tap (a
//     dropped output row: its g may hold anything, and 0 * NaN must not
//     reach dW), and reuses it for every item.  For each item it stages the
//     chunk's gathered feature rows (zero for a sentinel, not read) with
//     16-byte cp.async, two stages deep, one barrier per item, and
//     multiplies with mma.sync m16n8k16: M = input channels, N = output
//     channels, the contraction over the chunk's rows.  Both tiles are
//     stored row by row, so A (the gathered rows, transposed) and B (g) both
//     load with ldmatrix.trans.  The 8 warps split M, N and, at narrow
//     widths, the chunk's 16-row steps (WgradWarps).  When the block leaves
//     a tap it adds its (KC x BN) partial into dW, which the wrapper zeroes,
//     with 16-byte float4 reductions (add_f32; a pair of lanes swaps halves
//     of its C fragments so that each lane holds 4 consecutive columns).
//     Widths that are not 16-byte multiples (conv_input's Cin = 5) take
//     plain loads into the same layout.  mma.sync and not wgmma: the items
//     are 64-256 gathered rows deep and 16-128 channels wide, the products
//     small against the gathers, as in K7.
//   * float32: exact float32 FMAs on CUDA cores (TF32 would break the 1e-4
//     float32 tolerance; no main path runs K9 in float32).  A block owns
//     one tap, one span of rows and a TI x TO patch of dW, stages 64 rows
//     at a time and adds its patch with scalar atomics at the end.
// The reductions sum the spans in an order that changes from run to run, so
// the last bits of dW do too.  What bounds the bf16 kernel: its parts run
// one after another, none hidden behind another (measured by builds that
// drop each, PERF.md section 6): at res 3 the products, the reductions (one
// KC x BN partial per block and live tap, which the span trades against
// the number of blocks), the gathers, and the staging of g with the
// barriers take a fifth to a third each.

#include <atomic>
#include <cstdint>

#include "bilinear.cuh"
#include "scatter.cuh"
#include "tensor_core.cuh"

namespace {

// The row of a cell of a compact table, or `sentinel`: `word` caches the
// last word read (`w` its index, -1 before the first).
struct TableReader {
  const unsigned* bits;
  const int* base;
  const int* rows;
  int n_rows;
  long long w = -1;
  unsigned word = 0;

  __device__ __forceinline__ int row(long long cell, int sentinel) {
    if (cell >> 5 != w) {
      w = cell >> 5;
      word = __ldg(bits + w);
    }
    const unsigned bit = (unsigned)cell & 31u;
    if (!((word >> bit) & 1u)) return sentinel;
    const int rank = __ldg(base + w) + __popc(word & ((1u << bit) - 1u));
    return rank < n_rows ? __ldg(rows + rank) : sentinel;
  }
};

__global__ void sparse_nbr_kernel(const unsigned* __restrict__ bits,
                                  const int* __restrict__ base,
                                  const int* __restrict__ rows, int n_rows,
                                  const int* __restrict__ coords,
                                  const unsigned char* __restrict__ mask,
                                  int* __restrict__ out, long long n, int P,
                                  int D, int H, int W, int ky, int kx,
                                  int sz, int sy, int sx, int pz, int py,
                                  int px, int sentinel, long long size) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i / P;
  const int plane = (int)(i - o * P);
  int* dst = out + o * P * kx + plane * kx;
  const int* c = coords + 4 * o;  // (b, z, y, x)
  const int z = __ldg(c + 1) * sz - pz + plane / ky;
  const int y = __ldg(c + 2) * sy - py + plane % ky;
  const int x0 = __ldg(c + 3) * sx - px;
  const long long row0 = (((long long)__ldg(c) * D + z) * H + y) * W;
  const bool live = mask[o] && z >= 0 && z < D && y >= 0 && y < H;
  TableReader t{bits, base, rows, n_rows};
  for (int dx = 0; dx < kx; ++dx) {
    const int x = x0 + dx;
    const long long cell = row0 + x;
    int r = sentinel;
    if (live && x >= 0 && x < W && cell >= 0 && cell < size)
      r = t.row(cell, sentinel);
    dst[dx] = r;
  }
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

__global__ void sparse_inv_nbr_kernel(const unsigned* __restrict__ bits,
                                      const int* __restrict__ base,
                                      const int* __restrict__ rows,
                                      int n_rows,
                                      const int* __restrict__ coords,
                                      const unsigned char* __restrict__ mask,
                                      int* __restrict__ out, long long n,
                                      int P, int Do, int Ho, int Wo, int kz,
                                      int ky, int kx, int sz, int sy, int sx,
                                      int pz, int py, int px, int sentinel,
                                      long long size) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long v = i / P;
  const int plane = (int)(i - v * P);
  int* dst = out + v * P * kx + plane * kx;
  const int* c = coords + 4 * v;  // (b, z, y, x)
  const int vz = __ldg(c + 1) + pz + kz * sz - plane / ky;
  const int vy = __ldg(c + 2) + py + ky * sy - plane % ky;
  const int qz = vz / sz - kz;
  const int qy = vy / sy - ky;
  // the plane's parity and bounds before any read of the table
  const bool live = mask[v] && vz % sz == 0 && vy % sy == 0 && qz >= 0 &&
                    qz < Do && qy >= 0 && qy < Ho;
  const long long row0 = (((long long)__ldg(c) * Do + qz) * Ho + qy) * Wo;
  const int vx0 = __ldg(c + 3) + px + kx * sx;
  TableReader t{bits, base, rows, n_rows};
  for (int dx = 0; dx < kx; ++dx) {
    const int vx = vx0 - dx;
    const int qx = vx / sx - kx;
    const long long cell = row0 + qx;
    int r = sentinel;
    if (live && vx % sx == 0 && qx >= 0 && qx < Wo && cell >= 0 &&
        cell < size) {
      r = t.row(cell, sentinel);
      if (r < 0 || r >= sentinel) r = sentinel;
    }
    dst[dx] = r;
  }
}

constexpr int kWRows = 64;  // rows staged at a time by K9

template <int TI, int TO>
__global__ void __launch_bounds__(kThreads)
    sparse_wgrad_kernel(const float* __restrict__ feats,
                        const int* __restrict__ nidx,
                        const float* __restrict__ g, float* __restrict__ dw,
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
      if (src >= 0 && c0 + c < Cin) x = feats[(long long)src * Cin + c0 + c];
      a_s[rr][c] = x;
    }
    for (int e = tid; e < kWRows * TO; e += kThreads) {
      const int rr = e / TO;
      const int n = e - rr * TO;
      float y = 0.f;
      if (rows[rr] >= 0 && n0 + n < Cout) y = g[(v0 + rr) * Cout + n0 + n];
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

// K9, float32: the launch over the plan's span (a multiple of kWRows).
template <int TI, int TO>
cudaError_t launch_wgrad_f32(const void* feats, const int* nidx,
                             const void* g, float* dw, long long Vout, int K,
                             int Cin, int Cout, int V, int span,
                             cudaStream_t s) {
  if (span % kWRows != 0 || K > 65535) return cudaErrorInvalidValue;
  const int tiles = ((Cin + TI - 1) / TI) * ((Cout + TO - 1) / TO);
  const dim3 grid((unsigned)((Vout + span - 1) / span), (unsigned)K,
                  (unsigned)tiles);
  sparse_wgrad_kernel<TI, TO><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(feats), nidx, static_cast<const float*>(g), dw,
      Vout, K, Cin, Cout, V, span);
  return cudaGetLastError();
}

// K9, bf16: the block's shared memory, byte offsets from its start: the
// (span x K) index tile; one flag per (tap, chunk) pair; the live items, tap
// by tap, then their count; one flag per row (a live tap); the span's g
// slice (span x BN, pitch BN + 8 elements), 128-aligned; two stages of
// gathered rows (chunk x KC, pitch KC + 8).  The 16 bytes of padding put
// the eight 16-byte rows one ldmatrix reads on distinct banks.
struct WgradLayout {
  int a_pitch;  // elements
  int g_pitch;  // elements
  int flags;
  int list;
  int live;
  int g;
  int stages;
  int stage;    // bytes per stage
  int bytes;    // in all
};

WgradLayout wgrad_layout(int K, int span, int chunk, int kc, int bn) {
  WgradLayout L;
  const int pairs = span / chunk * K;
  L.a_pitch = kc + 8;
  L.g_pitch = bn + 8;
  L.flags = span * K * 4;
  L.list = L.flags + pairs * 4;
  L.live = L.list + (pairs + 1) * 4;
  L.g = (L.live + span * 4 + 127) / 128 * 128;
  L.stages = L.g + span * L.g_pitch * 2;
  L.stage = chunk * L.a_pitch * 2;
  L.bytes = L.stages + 2 * L.stage;
  return L;
}

// How the 8 warps split a (KC x BN) tile: WM x WN warps of MT m-tiles (16
// input channels) by NT n-tiles (8 output channels) each, and WK warps
// that take every WK-th 16-row step of an item (at narrow widths).
template <int KC, int BN>
struct WgradWarps {
  static constexpr int WM = KC / 16 < 4 ? KC / 16 : 4;
  static constexpr int MT = KC / 16 / WM;
  static constexpr int WN = BN / 8 < 8 / WM ? BN / 8 : 8 / WM;
  static constexpr int NT = BN / 8 / WN;
  static constexpr int WK = 8 / (WM * WN);
  static_assert(WM * WN * WK == 8 && WK <= 4, "8 warps, 4 steps an item");
};

template <int KC, int BN>
__global__ void __launch_bounds__(kThreads)
    sparse_wgrad_mma_kernel(const __nv_bfloat16* __restrict__ feats,
                            const int* __restrict__ nidx,
                            const __nv_bfloat16* __restrict__ g,
                            float* __restrict__ dw, long long Vout, int K,
                            int Cin, int Cout, int V, int span, int chunk,
                            WgradLayout lay, bool vec_a, bool vec_g,
                            bool vec_dw) {
  using W = WgradWarps<KC, BN>;
  constexpr int kAcc = W::MT * W::NT * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  int* idx_s = reinterpret_cast<int*>(smem);
  int* flags = reinterpret_cast<int*>(smem + lay.flags);
  int* list = reinterpret_cast<int*>(smem + lay.list);
  int* live = reinterpret_cast<int*>(smem + lay.live);
  __nv_bfloat16* g_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.g);
  __nv_bfloat16* const stage0 =
      reinterpret_cast<__nv_bfloat16*>(smem + lay.stages);
  const int stage_elems = lay.stage / 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long v0 = (long long)blockIdx.x * span;
  const int n0 = blockIdx.y * BN;
  const int c0 = blockIdx.z * KC;
  const int rows = (int)min((long long)span, Vout - v0);
  const int chunks = span / chunk;
  const int pairs = chunks * K;

  // The index tile, one coalesced read: -1 for a sentinel or a row past
  // Vout.
  const int* tile = nidx + v0 * K;
#pragma unroll 4
  for (int e = tid; e < span * K; e += kThreads) {
    int src = -1;
    if (e < rows * K) {
      src = tile[e];
      if (src < 0 || src >= V) src = -1;
    }
    idx_s[e] = src;
  }
  __syncthreads();
  // A row is live when any tap reads a row; a (tap, chunk) pair when any of
  // the chunk's rows is live in the tap: a ballot per pair, p = k * chunks
  // + chunk, so that the items of one tap follow each other.
  for (int r = tid; r < span; r += kThreads) {
    bool any = false;
    for (int k = 0; k < K; ++k) any |= idx_s[r * K + k] >= 0;
    live[r] = any;
  }
  for (int p = warp; p < pairs; p += kThreads / 32) {
    const int k = p / chunks;
    const int* col = idx_s + (p - k * chunks) * chunk * K + k;
    bool any = false;
    for (int i = lane; i < chunk; i += 32) any |= col[i * K] >= 0;
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) flags[p] = any;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int p0 = 0; p0 < pairs; p0 += 32) {
      const bool on = p0 + lane < pairs && flags[p0 + lane];
      const unsigned bits = __ballot_sync(0xffffffffu, on);
      if (on) list[n + __popc(bits & ((1u << lane) - 1u))] = p0 + lane;
      n += __popc(bits);
    }
    if (lane == 0) list[pairs] = n;
  }
  __syncthreads();
  const int items = list[pairs];
  if (items == 0) return;

  // The span's g slice, once, in the first copy group: zeros for a row
  // with no live tap and past Cout.
  if (vec_g) {
    constexpr int segs = BN / 8;
    for (int e = tid; e < span * segs; e += kThreads) {
      const int r = e / segs;
      const int n = (e - r * segs) * 8;
      const bool ok = live[r] && n0 + n < Cout;
      cp_async16(g_s + r * lay.g_pitch + n,
                 ok ? g + (v0 + r) * Cout + n0 + n : g, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < span * BN; e += kThreads) {
      const int r = e / BN;
      const int n = e - r * BN;
      g_s[r * lay.g_pitch + n] = live[r] && n0 + n < Cout
                                     ? g[(v0 + r) * Cout + n0 + n]
                                     : __float2bfloat16(0.f);
    }
  }
  // Stage item `it` into buffer it & 1: the chunk's rows gathered through
  // the item's tap, zeros for a sentinel and past Cin.
  auto issue = [&](int it) {
    __nv_bfloat16* a_s = stage0 + (it & 1) * stage_elems;
    const int p = list[it];
    const int k = p / chunks;
    const int* col = idx_s + (p - k * chunks) * chunk * K + k;
    if (vec_a) {
      constexpr int segs = KC / 8;
      for (int e = tid; e < chunk * segs; e += kThreads) {
        const int r = e / segs;
        const int c = (e - r * segs) * 8;
        const int src = col[r * K];
        const bool ok = src >= 0 && c0 + c < Cin;
        cp_async16(a_s + r * lay.a_pitch + c,
                   ok ? feats + (long long)src * Cin + c0 + c : feats,
                   ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < chunk * KC; e += kThreads) {
        const int r = e / KC;
        const int c = e - r * KC;
        const int src = col[r * K];
        a_s[r * lay.a_pitch + c] = src >= 0 && c0 + c < Cin
                                       ? feats[(long long)src * Cin + c0 + c]
                                       : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
  };

  const int wm = warp % W::WM;
  const int wn = (warp / W::WM) % W::WN;
  const int wk = warp / (W::WM * W::WN);
  // ldmatrix.trans row addresses.  A: lanes 8j..8j+7 give the rows (k)
  // 8 (j / 2) + 0..7 at channels 8 (j % 2), matrices a0-a3 of the mma's A
  // (channels x rows).  B: lanes 0-15 give rows 0-15 of the warp's first
  // n-tile, lanes 16-31 those of the next.
  const int a_lane = ((lane & 7) + ((lane >> 4) << 3)) * lay.a_pitch +
                     wm * W::MT * 16 + ((lane >> 3) & 1) * 8;
  const int g_lane = (lane & 15) * lay.g_pitch + wn * W::NT * 8 +
                     (W::NT > 1 ? (lane >> 4) * 8 : 0);
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // Two stages, one barrier per item: the barrier publishes item `it` and
  // frees the other buffer, whose copies for it + 1 then fly while `it` is
  // multiplied (deeper rings measured no faster, PERF.md section 6).
  issue(0);
  for (int it = 0; it < items; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < items) issue(it + 1);
    const int p = list[it];
    const int k = p / chunks;
    const __nv_bfloat16* a_s = stage0 + (it & 1) * stage_elems + a_lane;
    const __nv_bfloat16* b_s =
        g_s + (p - k * chunks) * chunk * lay.g_pitch + g_lane;
    for (int kk = wk * 16; kk < chunk; kk += 16 * W::WK) {
      unsigned a[W::MT][4];
#pragma unroll
      for (int i = 0; i < W::MT; ++i)
        ldmatrix_x4_trans(a[i], a_s + kk * lay.a_pitch + i * 16);
      const __nv_bfloat16* b_k = b_s + kk * lay.g_pitch;
      if constexpr (W::NT == 1) {
        unsigned b0, b1;
        ldmatrix_x2_trans(b0, b1, b_k);
#pragma unroll
        for (int i = 0; i < W::MT; ++i) mma_bf16(acc + 4 * i, a[i], b0, b1);
      } else {
#pragma unroll
        for (int j = 0; j < W::NT; j += 2) {
          unsigned b[4];
          ldmatrix_x4_trans(b, b_k + j * 8);
#pragma unroll
          for (int i = 0; i < W::MT; ++i) {
            mma_bf16(acc + 4 * (i * W::NT + j), a[i], b[0], b[1]);
            mma_bf16(acc + 4 * (i * W::NT + j + 1), a[i], b[2], b[3]);
          }
        }
      }
    }
    if (it + 1 < items && list[it + 1] / chunks == k) continue;
    // The block leaves tap k: add the partial into dW.  C fragment of a
    // tile: c0, c1 at (channel l / 4, columns 2 (l % 4) + 0, 1), c2, c3 8
    // channels further.  An even lane takes its odd neighbour's c0, c1
    // (columns 4 (l % 4 / 2) + 0..3 of channel l / 4), the odd lane the
    // even one's c2, c3 (the same columns, 8 channels further).
    const bool odd = lane & 1;
#pragma unroll
    for (int i = 0; i < W::MT; ++i) {
#pragma unroll
      for (int j = 0; j < W::NT; ++j) {
        float* d = acc + 4 * (i * W::NT + j);
        const float x = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
        const float y = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
        const float v[4] = {odd ? x : d[0], odd ? y : d[1], odd ? d[2] : x,
                            odd ? d[3] : y};
        const int c =
            c0 + wm * W::MT * 16 + i * 16 + (lane >> 2) + (odd ? 8 : 0);
        const int n = n0 + wn * W::NT * 8 + j * 8 + 4 * ((lane & 3) >> 1);
        if (c < Cin && n < Cout) {
          float* dst = dw + ((long long)k * Cin + c) * Cout + n;
          if (vec_dw) {
            add_f32<4>(dst, v);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (n + q < Cout && v[q] != 0.f) atomicAdd(dst + q, v[q]);
          }
        }
        d[0] = d[1] = d[2] = d[3] = 0.f;
      }
    }
  }
}

template <int KC, int BN>
cudaError_t launch_wgrad_mma(const void* feats, const int* nidx,
                             const void* g, float* dw, long long Vout, int K,
                             int Cin, int Cout, int V, int span, int chunk,
                             int smem_bytes, cudaStream_t s) {
  if (chunk % 64 != 0 || span % chunk != 0) return cudaErrorInvalidValue;
  const WgradLayout lay = wgrad_layout(K, span, chunk, KC, BN);
  if (lay.bytes != smem_bytes || lay.bytes > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err =
      allow_max_smem(sparse_wgrad_mma_kernel<KC, BN>, smem_set);
  if (err != cudaSuccess) return err;
  const bool vec_a =
      Cin % 8 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const bool vec_g =
      Cout % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const bool vec_dw =
      Cout % 4 == 0 && reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  const dim3 grid((unsigned)((Vout + span - 1) / span),
                  (unsigned)((Cout + BN - 1) / BN),
                  (unsigned)((Cin + KC - 1) / KC));
  sparse_wgrad_mma_kernel<KC, BN><<<grid, kThreads, lay.bytes, s>>>(
      static_cast<const __nv_bfloat16*>(feats), nidx,
      static_cast<const __nv_bfloat16*>(g), dw, Vout, K, Cin, Cout, V, span,
      chunk, lay, vec_a, vec_g, vec_dw);
  return cudaGetLastError();
}

// A tile width of the plan: the least of 16, 32, 64 (and 128 where `wide`)
// that holds `c`, else the widest.
inline int wgrad_tile(int c, bool wide) {
  for (int t = 16; t < (wide ? 128 : 64); t *= 2)
    if (c <= t) return t;
  return wide ? 128 : 64;
}

template <int KC>
cudaError_t dispatch_wgrad_mma(int bn, const void* feats, const int* nidx,
                               const void* g, float* dw, long long Vout, int K,
                               int Cin, int Cout, int V, int span, int chunk,
                               int smem_bytes, cudaStream_t s) {
  switch (bn) {
    case 16:
      return launch_wgrad_mma<KC, 16>(feats, nidx, g, dw, Vout, K, Cin, Cout,
                                      V, span, chunk, smem_bytes, s);
    case 32:
      return launch_wgrad_mma<KC, 32>(feats, nidx, g, dw, Vout, K, Cin, Cout,
                                      V, span, chunk, smem_bytes, s);
    case 64:
      return launch_wgrad_mma<KC, 64>(feats, nidx, g, dw, Vout, K, Cin, Cout,
                                      V, span, chunk, smem_bytes, s);
    default:
      return launch_wgrad_mma<KC, 128>(feats, nidx, g, dw, Vout, K, Cin, Cout,
                                       V, span, chunk, smem_bytes, s);
  }
}

template <int TI>
cudaError_t dispatch_wgrad_f32(int to, const void* feats, const int* nidx,
                               const void* g, float* dw, long long Vout, int K,
                               int Cin, int Cout, int V, int span,
                               cudaStream_t s) {
  if (to == 16)
    return launch_wgrad_f32<TI, 16>(feats, nidx, g, dw, Vout, K, Cin, Cout, V,
                                    span, s);
  if (to == 32)
    return launch_wgrad_f32<TI, 32>(feats, nidx, g, dw, Vout, K, Cin, Cout, V,
                                    span, s);
  return launch_wgrad_f32<TI, 64>(feats, nidx, g, dw, Vout, K, Cin, Cout, V,
                                  span, s);
}

}  // namespace

// bits, base, rows (n_rows ranks): the input resolution's compact table of
// `size` cells; coords (Vout, 4) int32 (b, z, y, x); mask (Vout,) bool; out
// (Vout, K) int32 with K = kz * ky * kx.  Returns the cudaError_t of the
// launch.
extern "C" int unibev_sparse_nbr(const void* bits, const void* base,
                                 const void* rows, int n_rows,
                                 const void* coords,
                                 const void* mask, void* out, long long Vout,
                                 int D, int H, int W, int kz, int ky, int kx,
                                 int sz, int sy, int sx, int pz, int py,
                                 int px, int sentinel, long long size,
                                 void* stream) {
  if (Vout < 0 || n_rows < 0 || kz < 1 || ky < 1 || kx < 1 || sz < 1 ||
      sy < 1 || sx < 1)
    return cudaErrorInvalidValue;
  const int P = kz * ky;
  const long long n = Vout * P;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  sparse_nbr_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(bits), static_cast<const int*>(base),
      static_cast<const int*>(rows), n_rows,
      static_cast<const int*>(coords),
      static_cast<const unsigned char*>(mask), static_cast<int*>(out), n, P,
      D, H, W, ky, kx, sz, sy, sx, pz, py, px, sentinel, size);
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

// bits, base, rows (n_rows ranks): the output resolution's compact table of
// `size` cells; coords_in (Vin, 4) int32 (b, z, y, x); mask_in (Vin,) bool;
// out (Vin, K) int32 output rows, sentinel where no output row reads the
// input through the tap.  Returns the cudaError_t of the launch.
extern "C" int unibev_sparse_inv_nbr(const void* bits, const void* base,
                                     const void* rows, int n_rows,
                                     const void* coords,
                                     const void* mask, void* out,
                                     long long Vin, int Do, int Ho, int Wo,
                                     int kz, int ky, int kx, int sz, int sy,
                                     int sx, int pz, int py, int px,
                                     int sentinel, long long size,
                                     void* stream) {
  if (Vin < 0 || n_rows < 0 || kz < 1 || ky < 1 || kx < 1 || sz < 1 ||
      sy < 1 || sx < 1 || pz < 0 || py < 0 || px < 0)
    return cudaErrorInvalidValue;
  const int P = kz * ky;
  const long long n = Vin * P;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  sparse_inv_nbr_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(bits), static_cast<const int*>(base),
      static_cast<const int*>(rows), n_rows,
      static_cast<const int*>(coords),
      static_cast<const unsigned char*>(mask), static_cast<int*>(out), n, P,
      Do, Ho, Wo, kz, ky, kx, sz, sy, sx, pz, py, px, sentinel, size);
  return cudaGetLastError();
}

// feats (V, Cin); nidx (Vout, K) int32; g (Vout, Cout); dw (K * Cin, Cout)
// float32, zeroed by the caller, the sums added into it.  dtype: 0 f32, 1
// bf16 (feats and g).  The plan (ops/sparse_conv.py::wgrad_plan): tiles of
// kc input by bn output channels, spans of `span` rows, items of `chunk`
// rows and smem_bytes of dynamic shared memory (bf16; for f32 chunk 64 and
// smem_bytes 0); a plan that disagrees with this file's tiles or layout is
// refused.  Returns the cudaError_t of the launch.
extern "C" int unibev_sparse_conv_wgrad(const void* feats, const void* nidx,
                                        const void* g, void* dw,
                                        long long Vout, int K, int Cin,
                                        int Cout, int V, int dtype, int kc,
                                        int bn, int span, int chunk,
                                        int smem_bytes, void* stream) {
  if (Vout < 0 || K < 1 || Cin < 1 || Cout < 1 || V < 0 || span < 1 ||
      chunk < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(nidx);
  float* out = static_cast<float*>(dw);
  if (dtype == 0) {
    if (kc != wgrad_tile(Cin, false) || bn != wgrad_tile(Cout, false) ||
        chunk != kWRows || smem_bytes != 0)
      return cudaErrorInvalidValue;
    if (Vout == 0) return cudaSuccess;
    if (kc == 16)
      return dispatch_wgrad_f32<16>(bn, feats, idx, g, out, Vout, K, Cin,
                                    Cout, V, span, s);
    if (kc == 32)
      return dispatch_wgrad_f32<32>(bn, feats, idx, g, out, Vout, K, Cin,
                                    Cout, V, span, s);
    return dispatch_wgrad_f32<64>(bn, feats, idx, g, out, Vout, K, Cin, Cout,
                                  V, span, s);
  }
  if (dtype != 1 || kc != wgrad_tile(Cin, true) || bn != wgrad_tile(Cout, true))
    return cudaErrorInvalidValue;
  if (Vout == 0) return cudaSuccess;
  switch (kc) {
    case 16:
      return dispatch_wgrad_mma<16>(bn, feats, idx, g, out, Vout, K, Cin,
                                    Cout, V, span, chunk, smem_bytes, s);
    case 32:
      return dispatch_wgrad_mma<32>(bn, feats, idx, g, out, Vout, K, Cin,
                                    Cout, V, span, chunk, smem_bytes, s);
    case 64:
      return dispatch_wgrad_mma<64>(bn, feats, idx, g, out, Vout, K, Cin,
                                    Cout, V, span, chunk, smem_bytes, s);
    default:
      return dispatch_wgrad_mma<128>(bn, feats, idx, g, out, Vout, K, Cin,
                                     Cout, V, span, chunk, smem_bytes, s);
  }
}
