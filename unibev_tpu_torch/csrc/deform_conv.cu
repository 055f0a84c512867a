// Modulated deformable convolution (DCNv2): the fused forward (dcn_fwd,
// kernel K2), the im2col its backward multiplies (dcn_im2col) and the
// backward's sampling half (K4).
//
// dcn_fwd replaces unibev_tpu/ops/deform_conv.py::modulated_deform_conv2d
// (:442): the f32 path _mdcn_clean (which defines the semantics) and the
// bf16 path _mdcn_fast (s32 pair-packed corner gathers for the TPU gather
// engine, then one (K*Cin) x Cout product).  It computes
//   out[n, :] = sum_k sum_c cols[n, k * Cin + c] * W[k * Cin + c, :]
// straight into the (B, Ho, Wo, Cout) output; the column matrix never
// reaches device memory (160 MB per flagship stage-3 call in bf16, written
// and read back by the product when the im2col and torch.matmul were two
// passes).  The bias stays outside, as in the JAX op.
// The backward follows _mdcn_fast_bwd (:323), which recomputes the gather
// rather than saving it: dcn_im2col writes the columns for d_weight = cols^T
// g (a torch.matmul); from d_cols = g W^T (again a torch.matmul) K4 computes
// d_offset and d_mask and adds d_x straight into a float32 table with
// vector reductions (scatter.cuh), in one launch per layer.
//
// Semantics, per output pixel n = (b, ho, wo) and tap k = ky * Kw + kx:
//   sy = ho * stride - pad + ky * dil + offset[b, ho, wo, 2k]      (dy)
//   sx = wo * stride - pad + kx * dil + offset[b, ho, wo, 2k + 1]  (dx)
//   cols[n, k * Cin + c] = mask[b, ho, wo, k] * bilinear(x[b, :, :, c], sy, sx)
// The geometry (whole-point test, per-corner zero padding) is bilinear_at in
// bilinear.cuh, shared with the MSDA kernels: the forward and K4 agree on it
// exactly.  The offset layout is mmcv's: (dy, dx) interleaved per tap; the
// mask is already sigmoid-ed.
//
// Layouts: x (B, H, W, Cin) NHWC; offset (B, Ho, Wo, 2K); mask (B, Ho, Wo, K);
// weight (K * Cin, Cout), tap-major; out (B, Ho, Wo, Cout); cols and d_cols
// (B * Ho * Wo, K * Cin); all in one dtype, bf16 or f32; bilinear weights
// and sums in f32.
//
// dcn_fwd, what bounds it on the H100.  The product is the work: 2 * pix *
// 9 * Cin * Cout operations, 41 GFLOP per flagship stage-3 or stage-4 call,
// 0.042 ms at the bf16 tensor-core peak, against 0.012 ms for the bytes it
// must move.  What sets its time is the sampling and the loop around the
// product: each column element blends four corners, 8 bytes in bf16 read
// from the input map (18 MB at stage 3, in L2), ~640 MB per stage-3 call,
// in f32 on the CUDA cores, and each item ends on a block barrier.  With
// mask 0 (no corner is read; the blend and the loop remain) a call keeps
// most of its time (chip_smoke.py phase 3, PERF.md): L2's rate is not the
// limit.  The design keeps the columns in shared memory and overlaps the
// gathers with the tensor cores:
//   * a tile is 128 output pixels by 256 output channels (stage 3), or for
//     256 < Cout <= 512 (stage 4) 64 pixels by 512 channels, so that every
//     column element is sampled once up to Cout 512 (two 256-wide tiles
//     sampled stage 4's columns twice, and took ~30% longer);
//   * the grid is one wave, at most one block per SM, and the blocks share
//     the layer's tiles x (Cin chunk, tap) items evenly; a tile that two
//     blocks share is summed by both in f32 and finished by the last (see
//     dcn_fwd_kernel).  A grid of one block per tile ran 3 waves where
//     2.06 would do at stage 3, and 2 where 1.03 would do at stage 4;
//   * 16 warps, 4 warpgroups, 2 (rows) x 2 (columns) over the 128 x 256
//     tile or 1 x 4 over the 64 x 512 one, each a wgmma m64n128k16 into 64
//     f32 registers a thread; a thread samples two 16-byte vectors an item
//     (one in the wide tile) and 16 warps hide the gathers' latency;
//   * for each tile it runs, the block computes the geometry of its pixels'
//     K sample points once (bilinear_at, the geometry K4 shares), folds the
//     mask into the four corner weights and keeps them, with the row of the
//     first corner, in shared memory;
//   * it walks (Cin chunk of 64, tap) items.  For each it samples the A tile
//     (the pixels x 128 bytes of channels) into shared memory: each thread
//     loads the corners that weigh something as 16-byte vectors (8 bf16
//     channels), blends them in f32 and stores 16 bytes of bf16 into a
//     128-byte-swizzled row; points and corners outside the map give zeros;
//   * the weight slice (the tile's output channels x 128 bytes, K-major:
//     the wrapper hands over the weight transposed) comes by TMA, 256 rows
//     a copy, with the same swizzle and completes the stage's mbarrier; the
//     threads issue no copy;
//   * a ring of three stages (two in the wide tile, whose weight slice is
//     twice the size), one block barrier per item: the weights are copied
//     two items (one) ahead; while the tensor cores run item it
//     (asynchronous wgmma, A and B read from shared memory through
//     descriptors) the threads blend item it + 1's corners, loaded one
//     iteration earlier, and issue item it + 2's loads;
//   * the epilogue stages the tile in shared memory and writes rows of Cout
//     with 16-byte stores;
//   * float32 serves the tests: the same tile, staging and loop with exact
//     CUDA-core FMAs (TF32 would break the 1e-4 tolerance), 32 channels a
//     stage.  A Cin that is not a multiple of 8 (conv_input-like Cin 5)
//     takes plain loads of x into the same layout; the wrapper pads each
//     tap's weights to whole stages.

// dcn_im2col: one warp per (output pixel, tap), the geometry computed once
// per warp, lanes over Cin, so that the corner reads and the column writes
// are contiguous; the columns' bytes (160 MB at stage 3 in bf16) bound it.
//
// K4: each (pixel, tap) reads a Cin-wide row of d_cols (160 MB a flagship
// stage-3 call, from HBM) and four Cin-wide corner rows of x (in L2), and
// adds four Cin-wide f32 rows into the table: 1.2 GB of reductions a
// stage-3 call, 37x the 35.6 MB table (beside x's 17.8 MB: together just
// above the 50 MB L2).  What bounds it on the H100 is not those
// reductions (without them a stage-3 call kept 0.378 of its 0.439 ms,
// PERF.md section 6) but the dependent loads and the per-tap work of each
// lane.  The design: `lanes` threads per (pixel, tap) (ops/deform_conv.py::
// dcn_bwd_plan), each owning chunks of 4 channels of Cin (8-byte loads in
// bf16: a warp covers 128 channels a pass, two passes at Cin 256, where
// 2-byte accesses took eight), the five dot products summed with one warp
// shuffle, and each corner's chunk added from registers as one 16-byte
// reduction, so that a warp's reductions cover 512 contiguous bytes.
// 16-byte loads of 8 channels left each lane two reductions 32 bytes apart
// and took twice as long (0.85 against 0.44 ms at stage 3).  Measured and
// dropped: a block that first summed a pixel tile's adds in a shared-memory
// window of input cells took 2.4x (stage 3) and 6.7x (stage 4) as long; a
// thread group per pixel walking its taps, 8 or 16 threads per (pixel,
// tap), changed the time by less than 4%; each lane loading two chunks
// before using either made it 7% slower.  No contribution rows: four bf16
// rows per tap, written and read back by a scatter-add, would come to
// 15.7 GB an LC train step.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>

#include "bilinear.cuh"
#include "scatter.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;  // dcn_im2col
constexpr int kBwdThreads = 256;   // K4

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

// K4: `lanes` threads per (output pixel, tap) item, each owning the
// VEC-channel chunks lane, lane + lanes, ... of Cin (a warp, two chunks of
// 4 bf16 channels a lane at Cin 256, four at Cin 512).  Each thread loads
// its chunk of d_cols and of the four corners with one access each,
// forms its share of the per-corner dot products and of d_mask, and adds
// mask * w_c * d_cols for each live corner into the f32 table (x's layout)
// with add_f32's vector reductions; the shares are summed over the item's
// lanes and one lane writes d_offset and d_mask.  A tap that samples
// nothing gets zeros and adds nothing.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
    dcn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                   const T* __restrict__ mask, const T* __restrict__ d_cols,
                   T* __restrict__ d_offset, T* __restrict__ d_mask,
                   float* __restrict__ table, int H, int W, int Cin, int Ho,
                   int Wo, int Kw, int K, int stride, int pad, int dil,
                   int lanes, long long n_threads) {
  const long long t = (long long)blockIdx.x * kBwdThreads + threadIdx.x;
  if (t >= n_threads) return;  // whole groups: n_threads = items * lanes
  const long long item = t >> (__ffs(lanes) - 1);  // = n * K + k
  const int lane = (int)(t & (lanes - 1));
  const unsigned gmask = group_mask(lanes);
  const Tap tp = tap_at(item, offset, mask, Ho, Wo, Kw, K, stride, pad, dil);
  const long long dofs = tp.n * 2 * K + 2 * tp.k;

  Bilinear g;
  if (!bilinear_at(tp.sx, tp.sy, W, H, g)) {  // uniform across the group
    if (lane == 0) {
      d_offset[dofs] = from_float<T>(0.f);
      d_offset[dofs + 1] = from_float<T>(0.f);
      d_mask[tp.n * K + tp.k] = from_float<T>(0.f);
    }
    return;
  }
  // element offset of x's row (b, 0, 0), in x and in the table
  const long long xbase = tp.b * H * W * Cin;
  const T* ds = d_cols + item * Cin;
  const int groups = Cin / VEC;
  float gv[4] = {0.f, 0.f, 0.f, 0.f};
  float dm = 0.f;
  for (int ch = lane; ch < groups; ch += lanes) {
    Chunk<T, VEC> d;
    d.load(ds + ch * VEC);
    Chunk<T, VEC> v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (g.in[c])
        v[c].load(x + xbase + corner_cell(g, c, W) * Cin + ch * VEC);
      else
        v[c].clear();
    }
    float dsm[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float di = d.get(i);
      dsm[i] = di * tp.m;
      float sampled = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float vc = v[c].get(i);
        if (g.in[c]) sampled += g.w[c] * vc;
        gv[c] += vc * dsm[i];
      }
      dm += di * sampled;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!g.in[c]) continue;
      float add[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) add[i] = dsm[i] * g.w[c];
      add_f32<VEC>(table + xbase + corner_cell(g, c, W) * Cin + ch * VEC, add);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) gv[c] = group_sum(gv[c], lanes, gmask);
  dm = group_sum(dm, lanes, gmask);
  if (lane == 0) {
    const float dsx = (gv[1] - gv[0]) * (1.f - g.ly) + (gv[3] - gv[2]) * g.ly;
    const float dsy = (gv[2] - gv[0]) * (1.f - g.lx) + (gv[3] - gv[1]) * g.lx;
    d_offset[dofs] = from_float<T>(dsy);
    d_offset[dofs + 1] = from_float<T>(dsx);
    d_mask[tp.n * K + tp.k] = from_float<T>(dm);
  }
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* x, const void* offset, const void* mask,
                       const void* d_cols, void* d_offset, void* d_mask,
                       void* table, int H, int W, int Cin, int Ho, int Wo,
                       int Kw, int K, int stride, int pad, int dil, int lanes,
                       long long n_threads, cudaStream_t s) {
  dcn_bwd_kernel<T, VEC>
      <<<(unsigned)((n_threads + kBwdThreads - 1) / kBwdThreads), kBwdThreads,
         0, s>>>(static_cast<const T*>(x), static_cast<const T*>(offset),
                 static_cast<const T*>(mask), static_cast<const T*>(d_cols),
                 static_cast<T*>(d_offset), static_cast<T*>(d_mask),
                 static_cast<float*>(table), H, W, Cin, Ho, Wo, Kw, K, stride,
                 pad, dil, lanes, n_threads);
  return cudaGetLastError();
}

unsigned blocks_for(long long n_warps) {
  return (unsigned)((n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// ---- dcn_fwd ---------------------------------------------------------------

constexpr int kFwdThreads = 512;  // 16 warps, 4 warpgroups
constexpr int kRowBytes = 128;    // a staged row: 64 bf16 or 32 f32 channels
constexpr int kFwdMinItems = 4;   // items a block runs at the least
constexpr int kBoxRows = 256;     // weight rows a TMA copy moves (its most)
constexpr int kAcc = 64;          // f32 sums a thread: a tile's / threads

// dcn_fwd's two tiles.  The square one, 128 output pixels by 256 output
// channels in a ring of three items, covers Cout <= 256 with one channel
// tile (wider Couts take several, each sampling the columns anew); the
// wide one, 64 pixels by 512 channels in a ring of two (its weight slice is
// twice the size), covers 256 < Cout <= 512 sampling each column once.
template <bool kWide>
struct FwdTile {
  static constexpr int kRows = kWide ? 64 : 128;   // output pixels
  static constexpr int kBN = kWide ? 512 : 256;    // output channels
  static constexpr int kStages = kWide ? 2 : 3;    // items in the ring
  static constexpr int kVecs = kRows * 8 / kFwdThreads;  // A vectors a
                                                         // thread samples
  static_assert(kRows * kBN == kAcc * kFwdThreads, "64 sums a thread");
};

// dcn_fwd's shared memory, byte offsets from its first 1024-byte boundary
// (the swizzle pattern follows address bits; 1024 bytes of slack are
// allocated for the alignment): a ring of kStages stages, each the sampled
// columns A (kRows rows) followed by the item's weight rows B (kBN rows, one
// per output channel), every row 128 bytes of input channels, 128-byte
// swizzled (sw128); after the loop the ring holds the output tile (kRows x
// kBN, row pitch o_pitch).  Then one mbarrier
// per stage, which the stage's TMA weight copy completes, and at byte 32
// the flag of the last share of a tile (64 bytes reserved), and the
// geometry: K x kRows x 4 mask-folded corner
// weights, f32, 0 for a corner that reads nothing, and K x kRows rows of
// corner 0 in x viewed as (B * H * W, Cin), int32 (corner c adds (c / 2) *
// W + c % 2).  ops/deform_conv.py::dcn_fwd_plan computes the same layout;
// the launch checks that the two agree.
struct FwdLayout {
  int kc;       // input channels per stage: 128 bytes of them
  int chunks;   // stages per tap, ceil(Cin / kc)
  int a_bytes;  // from a stage's start to its B
  int stage;    // bytes per stage, a multiple of 1024
  int o_pitch;  // elements
  int bars;     // byte offset of the stages' mbarriers
  int geo;      // byte offset of the geometry
  int bytes;    // in all, with the alignment slack
};

template <typename T, bool kWide>
FwdLayout fwd_layout(int K, int Cin) {
  using Tl = FwdTile<kWide>;
  FwdLayout l;
  l.kc = kRowBytes / (int)sizeof(T);
  l.chunks = (Cin + l.kc - 1) / l.kc;
  l.a_bytes = Tl::kRows * kRowBytes;
  l.stage = l.a_bytes + Tl::kBN * kRowBytes;
  l.o_pitch = Tl::kBN + 16 / (int)sizeof(T);
  const int ring = Tl::kStages * l.stage;
  const int out_bytes = Tl::kRows * l.o_pitch * (int)sizeof(T);
  l.bars = ring > out_bytes ? ring : out_bytes;
  l.geo = l.bars + 64;
  l.bytes = 1024 + l.geo + K * Tl::kRows * 20;
  return l;
}

// Byte offset of 16-byte chunk c of row r in a tile of 128-byte rows,
// 128-byte swizzled: the layout wgmma's sw128 descriptors read and TMA's
// 128-byte swizzle writes, in which the eight chunks a row's eight threads
// store fall on distinct banks.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ unsigned word(const uint4& u, int j) {
  return j == 0 ? u.x : j == 1 ? u.y : j == 2 ? u.z : u.w;
}

// 16 bytes of one input row from channel p on, zeros past n channels: one
// 16-byte load where the row width and the address allow (vec), else
// element by element.
__device__ __forceinline__ uint4 load_vec(const float* p, int n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = j < n ? __float_as_uint(p[j]) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 load_vec(const __nv_bfloat16* p, int n,
                                          bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned lo = 2 * j < n ? __bfloat16_as_ushort(p[2 * j]) : 0u;
    const unsigned hi =
        2 * j + 1 < n ? __bfloat16_as_ushort(p[2 * j + 1]) : 0u;
    w[j] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One 16-byte vector of the A tile: the four corner vectors weighed by the
// mask-folded bilinear weights, summed in f32 (in K2's order), rounded to T.
template <typename T>
__device__ __forceinline__ uint4 blend(const uint4 (&v)[4],
                                       const float (&w)[4]);

template <>
__device__ __forceinline__ uint4 blend<float>(const uint4 (&v)[4],
                                              const float (&w)[4]) {
  unsigned o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float s = w[0] * __uint_as_float(word(v[0], j)) +
                    w[1] * __uint_as_float(word(v[1], j)) +
                    w[2] * __uint_as_float(word(v[2], j)) +
                    w[3] * __uint_as_float(word(v[3], j));
    o[j] = __float_as_uint(s);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <>
__device__ __forceinline__ uint4 blend<__nv_bfloat16>(const uint4 (&v)[4],
                                                      const float (&w)[4]) {
  unsigned o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // a bf16 is the high half of its float
      float c[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned u = word(v[q], j);
        c[q] = __uint_as_float(h == 0 ? u << 16 : u & 0xffff0000u);
      }
      s[h] = w[0] * c[0] + w[1] * c[1] + w[2] * c[2] + w[3] * c[3];
    }
    o[j] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(s[0])) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16(s[1])) << 16);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The warpgroup's rows of A and first output channel: the 4 warpgroups are
// 2 (rows) x 2 (columns) over the square tile, 1 x 4 over the wide one.
template <bool kWide>
__device__ __forceinline__ int wg_row() {
  return kWide ? 0 : (threadIdx.x >> 7 & 1) * 64;
}

template <bool kWide>
__device__ __forceinline__ int wg_col() {
  return (kWide ? threadIdx.x >> 7 : threadIdx.x >> 8) * 128;
}

// bf16: issue the item's product on the tensor cores, asynchronously: the
// warpgroup multiplies its 64 rows of A by its 128 weight rows (output
// channels), four wgmma m64n128k16 along the item's 64 channels; acc holds
// the warpgroup's (64 x 128) f32 sums (the layout of wgmma_m64n128k16).
template <bool kWide>
__device__ __forceinline__ void fwd_product(float (&acc)[kAcc],
                                            const unsigned char* a_s,
                                            const FwdLayout& lay,
                                            __nv_bfloat16) {
  const unsigned long long da = sw128_desc(a_s + wg_row<kWide>() * kRowBytes);
  const unsigned long long db =
      sw128_desc(a_s + lay.a_bytes + wg_col<kWide>() * kRowBytes);
  fence_registers(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)  // 16 channels, 32 bytes, a step
    wgmma_m64n128k16(acc, da + 2 * s, db + 2 * s);
  wgmma_commit();
}

__device__ __forceinline__ void fwd_product_wait(float (&acc)[kAcc],
                                                 __nv_bfloat16) {
  wgmma_wait<0>();
  fence_registers(acc);
}

// float32: exact float32 products on CUDA cores (TF32 would not hold the
// f32 tolerance); thread (tx, ty) owns rows ty + kTY i, i < 4, and columns
// tx + kTX j, j < 16, acc[16 i + j].
template <bool kWide>
struct FwdF32 {
  static constexpr int kTY = FwdTile<kWide>::kRows / 4;
  static constexpr int kTX = kFwdThreads / kTY;
};

__device__ __forceinline__ float sw_load(const unsigned char* tile, int r,
                                         int c) {
  return *reinterpret_cast<const float*>(tile + sw128(r, c >> 2) +
                                         (c & 3) * 4);
}

template <bool kWide>
__device__ __forceinline__ void fwd_product(float (&acc)[kAcc],
                                            const unsigned char* a_s,
                                            const FwdLayout& lay, float) {
  constexpr int kTY = FwdF32<kWide>::kTY;
  constexpr int kTX = FwdF32<kWide>::kTX;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const unsigned char* b_s = a_s + lay.a_bytes;
  for (int c = 0; c < lay.kc; ++c) {
    float a[4], b[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sw_load(a_s, ty + kTY * i, c);
#pragma unroll
    for (int j = 0; j < 16; ++j) b[j] = sw_load(b_s, tx + kTX * j, c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        acc[16 * i + j] = fmaf(a[i], b[j], acc[16 * i + j]);
  }
}

__device__ __forceinline__ void fwd_product_wait(float (&)[kAcc], float) {}

// The sums into the output tile in shared memory, as T.
template <bool kWide>
__device__ __forceinline__ void stage_out(const float (&acc)[kAcc],
                                          __nv_bfloat16* o_s, int o_pitch) {
  const int lane = threadIdx.x & 31;
  const int r =
      wg_row<kWide>() + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = wg_col<kWide>() + j * 8 + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(o_s + r * o_pitch + n) =
        __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(o_s + (r + 8) * o_pitch + n) =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <bool kWide>
__device__ __forceinline__ void stage_out(const float (&acc)[kAcc],
                                          float* o_s, int o_pitch) {
  constexpr int kTY = FwdF32<kWide>::kTY;
  constexpr int kTX = FwdF32<kWide>::kTX;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      o_s[(ty + kTY * i) * o_pitch + tx + kTX * j] = acc[16 * i + j];
}

// Block b of G over `total` units takes units [range_start(b),
// range_start(b + 1)); range_owner(u) is the block whose range holds unit u.
__device__ __forceinline__ int range_start(int g, int total, int G) {
  return (int)((long long)g * total / G);
}

__device__ __forceinline__ int range_owner(int u, int total, int G) {
  return (int)(((long long)(u + 1) * G - 1) / total);
}

// The work of a layer is tiles x items: a tile is kRows output pixels by
// kBN output channels, an item one (Cin chunk, tap) of it.  The grid is
// one wave of G blocks, and block b runs the units [b * U / G, (b + 1) * U /
// G) of the U = tiles x items units in order, tile-major; a stretch of one
// tile's items is a segment.  A tile whose items more than one block runs
// is summed by each of them: each writes its f32 sums to its slot of
// `partial` (slot 2 b for block b's first segment, 2 b + 1 for its last)
// and counts itself in `arrivals`; the last to arrive adds the slots in
// block order, writes the tile and sets the count back to 0 for the next
// launch.  No block waits on another, so the schedule needs no
// co-residency.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kFwdThreads, 1)
    dcn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                   const T* __restrict__ mask,
                   const __grid_constant__ CUtensorMap wt_map,
                   T* __restrict__ out, float* __restrict__ partial,
                   int* __restrict__ arrivals, int H, int W, int Cin,
                   int cin_pad, int Ho, int Wo, int Cout, int Kw, int K,
                   int stride, int pad, int dil, long long n_pix,
                   FwdLayout lay, bool vec_a, bool vec_o) {
  using Tl = FwdTile<kWide>;
  constexpr int kE = 16 / sizeof(T);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + lay.bars);
  int* const last = reinterpret_cast<int*>(ring + lay.bars + 32);
  float4* geo_w = reinterpret_cast<float4*>(ring + lay.geo);  // [K][rows]
  int* geo_row = reinterpret_cast<int*>(ring + lay.geo + K * Tl::kRows * 16);
  const int corner_step[4] = {0, 1, W, W + 1};
  const int tid = threadIdx.x;
  const int items = lay.chunks * K;
  const int ctiles = (Cout + Tl::kBN - 1) / Tl::kBN;
  // the units (tiles x items; fewer than 2^31, the launch checks)
  const int total =
      (int)((n_pix + Tl::kRows - 1) / Tl::kRows) * ctiles * items;
  const int G = gridDim.x;
  const int begin = range_start(blockIdx.x, total, G);
  const int end = range_start(blockIdx.x + 1, total, G);
  // item i of a tile is (Cin chunk i / K, tap i % K); the quotient without
  // a division: (i + 1/2) / K lies at least 1/(2K) from an integer, far
  // more than the float product's error for i < 2^22 (the launch checks)
  const float inv_k = 1.f / K;
  const auto chunk_of = [&](int i) { return (int)((i + 0.5f) * inv_k); };

  if (tid == 0) {
    for (int st = 0; st < Tl::kStages; ++st) mbar_init(&full[st], 1);
    fence_barrier_init();
  }

  uint4 corner[Tl::kVecs][4];
  float acc[kAcc];
  int q = 0;  // items through the ring before this segment
  // The segments: unit u starts one, of tile u / items.  Only u, begin,
  // end, q and o0 live across the item loop (registers are the limit: 16
  // warps of 128); the rest is derived from them where it is used.
  for (int u = begin; u < end;) {
    const int i0 = u % items;
    const int len = min(items - i0, end - u);
    const int o0 = (u / items % ctiles) * Tl::kBN;

    // the previous segment's output tile and geometry are read no more
    fence_proxy_async();
    __syncthreads();
    {
      // the geometry of the tile's kRows x K sample points, tap-major
      // (as tap_at, in 32 bits: the launch checks B * H * W and n_pix)
      const int n0 = u / items / ctiles * Tl::kRows;
      const int rows = (int)min((long long)Tl::kRows, n_pix - n0);
      for (int e = tid; e < Tl::kRows * K; e += kFwdThreads) {
        const int r = e % Tl::kRows;
        const int k = e / Tl::kRows;
        float w[4] = {0.f, 0.f, 0.f, 0.f};
        int row = 0;
        if (r < rows) {
          const int n = n0 + r;
          const int wo = n % Wo;
          const int ho = n / Wo % Ho;
          const int b = n / Wo / Ho;
          const int ky = k / Kw;
          const int kx = k - ky * Kw;
          const T* off = offset + ((long long)n * K + k) * 2;
          const float sy = (float)(ho * stride - pad + ky * dil) +
                           to_float(off[0]);
          const float sx = (float)(wo * stride - pad + kx * dil) +
                           to_float(off[1]);
          const float m = to_float(mask[(long long)n * K + k]);
          Bilinear g;
          if (bilinear_at(sx, sy, W, H, g)) {
            // corner 0's cell, outside the map when it is; a corner
            // outside weighs 0 and is not read
            row = (b * H + g.y0) * W + g.x0;
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (g.in[c]) w[c] = g.w[c] * m;
          }
        }
        geo_w[k * Tl::kRows + r] = make_float4(w[0], w[1], w[2], w[3]);
        geo_row[k * Tl::kRows + r] = row;
      }
      __syncthreads();
    }

    // Items are (Cin chunk, tap), chunk-major; segment item `it` is item
    // i0 + it of the tile and item q + it of the block's ring.  Thread tid
    // samples the A-tile vectors e = tid + i * kFwdThreads, i < kVecs:
    // row e / 8, channels (e % 8) * kE .. + kE of the chunk (8 threads a
    // row).
    // The corner loads of item `it`, into registers: the corners that weigh
    // something (inside the map, of a point inside it, mask not 0).
    auto gather = [&](int it) {
      const int chunk = chunk_of(i0 + it);
      const int k = (i0 + it) - chunk * K;
      const int c0 = chunk * lay.kc;
#pragma unroll
      for (int i = 0; i < Tl::kVecs; ++i) {
        const int e = tid + i * kFwdThreads;
        const int r = e >> 3;
        const int ch = c0 + (e & 7) * kE;
        const int row = geo_row[k * Tl::kRows + r];
        const float4 g4 = geo_w[k * Tl::kRows + r];
        const float w[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          corner[i][c] = make_uint4(0u, 0u, 0u, 0u);
          if (w[c] != 0.f && ch < Cin)
            corner[i][c] = load_vec(
                x + (long long)(row + corner_step[c]) * Cin + ch, Cin - ch,
                vec_a);
        }
      }
    };
    // Blend item `it`'s corners into its A tile.
    auto blend_store = [&](int it) {
      const int k = (i0 + it) - chunk_of(i0 + it) * K;
      unsigned char* a_s = ring + ((q + it) % Tl::kStages) * lay.stage;
#pragma unroll
      for (int i = 0; i < Tl::kVecs; ++i) {
        const int e = tid + i * kFwdThreads;
        const int r = e >> 3;
        const float4 g4 = geo_w[k * Tl::kRows + r];
        const float w[4] = {g4.x, g4.y, g4.z, g4.w};
        *reinterpret_cast<uint4*>(a_s + sw128(r, e & 7)) =
            blend<T>(corner[i], w);
      }
    };
    // Stage item `it`'s weight rows: for each of the block's output
    // channels, the tap's chunk of input channels, TMA copies of kBoxRows
    // rows of 128 bytes (rows past Cout read as zeros), issued by one
    // thread.
    auto issue_b = [&](int it) {
      if (it < len && tid == 0) {
        const int st = (q + it) % Tl::kStages;
        const int chunk = chunk_of(i0 + it);
        const int k = (i0 + it) - chunk * K;
        mbar_expect_tx(&full[st], Tl::kBN * kRowBytes);
#pragma unroll
        for (int h = 0; h < Tl::kBN / kBoxRows; ++h)
          tma_load_2d(ring + st * lay.stage + lay.a_bytes +
                          h * kBoxRows * kRowBytes,
                      &wt_map, k * cin_pad + chunk * lay.kc,
                      o0 + h * kBoxRows, &full[st]);
      }
    };

#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    // A ring of kStages items, one barrier per item: the barrier publishes
    // item `it` (its weights copied by TMA kStages - 1 items ahead, their
    // arrival awaited on the stage's mbarrier; its columns sampled one item
    // ahead) and frees the buffer item it + kStages - 1 then takes.  While
    // the tensor cores run item `it`, the threads blend item it + 1's
    // corners, loaded one iteration earlier, then issue all of item it +
    // 2's corner loads, which fly across the rest of the product, the
    // barrier and the next product's issue.
#pragma unroll
    for (int it = 0; it < Tl::kStages - 1; ++it) issue_b(it);
    gather(0);
    blend_store(0);
    if (len > 1) gather(1);
    for (int it = 0; it < len; ++it) {
      const int g = q + it;
      mbar_wait(&full[g % Tl::kStages], (g / Tl::kStages) & 1);
      fence_proxy_async();
      __syncthreads();
      issue_b(it + Tl::kStages - 1);
      fwd_product<kWide>(acc, ring + (g % Tl::kStages) * lay.stage, lay,
                         T());
      if (it + 1 < len) blend_store(it + 1);
      if (it + 2 < len) gather(it + 2);
      fwd_product_wait(acc, T());
    }
    q += len;

    // the segment's tile
    const int tile = u / items;
    const long long n0 = (long long)(tile / ctiles) * Tl::kRows;
    const int rows = (int)min((long long)Tl::kRows, n_pix - n0);
    const bool first = u == begin;
    u += len;
    if (len < items) {
      // a share of the tile: hand in the sums; the last share writes it
      constexpr int kSlot = kAcc * kFwdThreads;
      const long long slot = 2ll * blockIdx.x + (first ? 0 : 1);
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        __stcg(partial + slot * kSlot + i * kFwdThreads + tid, acc[i]);
      const int g_lo = range_owner(tile * items, total, G);
      const int g_hi = range_owner(tile * items + items - 1, total, G);
      __threadfence();
      __syncthreads();
      if (tid == 0) *last = atomicAdd(&arrivals[tile], 1) == g_hi - g_lo;
      __syncthreads();
      if (!*last) continue;
      __threadfence();
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      for (int g = g_lo; g <= g_hi; ++g) {
        // block g ran the tile as its first segment unless its range began
        // in an earlier tile
        const long long s =
            2ll * g + (range_start(g, total, G) / items == tile ? 0 : 1);
#pragma unroll
        for (int i = 0; i < kAcc; ++i)
          acc[i] += __ldcg(partial + s * kSlot + i * kFwdThreads + tid);
      }
      if (tid == 0) arrivals[tile] = 0;
    }

    __syncthreads();  // the ring becomes the output tile
    T* const o_s = reinterpret_cast<T*>(ring);
    stage_out<kWide>(acc, o_s, lay.o_pitch);
    __syncthreads();
    if (vec_o) {
      constexpr int segs = Tl::kBN / kE;
      for (int e = tid; e < rows * segs; e += kFwdThreads) {
        const int r = e / segs;
        const int n = (e - r * segs) * kE;
        if (o0 + n < Cout)
          *reinterpret_cast<uint4*>(out + (n0 + r) * Cout + o0 + n) =
              *reinterpret_cast<const uint4*>(o_s + r * lay.o_pitch + n);
      }
    } else {
      for (int e = tid; e < rows * Tl::kBN; e += kFwdThreads) {
        const int r = e / Tl::kBN;
        const int n = e - r * Tl::kBN;
        if (o0 + n < Cout)
          out[(n0 + r) * Cout + o0 + n] = o_s[r * lay.o_pitch + n];
      }
    }
  }
}

// cuTensorMapEncodeTiled of the CUDA runtime's lower API, looked up at run
// time through cudaGetDriverEntryPoint (the library does not link against
// libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T, bool kWide>
cudaError_t launch_fwd(const void* x, const void* offset, const void* mask,
                       const void* wt, void* out, void* partial,
                       void* arrivals, int max_blocks, int H, int W, int Cin,
                       int cin_pad, int Ho, int Wo, int Cout, int Kw, int K,
                       int stride, int pad, int dil, long long n_pix,
                       int smem_bytes, cudaStream_t s) {
  using Tl = FwdTile<kWide>;
  constexpr int kE = 16 / sizeof(T);
  const FwdLayout lay = fwd_layout<T, kWide>(K, Cin);
  if (lay.bytes != smem_bytes || lay.bytes > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  if (cin_pad != lay.chunks * lay.kc) return cudaErrorInvalidValue;
  if (max_blocks < 1 || partial == nullptr || arrivals == nullptr)
    return cudaErrorInvalidValue;
  const long long units = (n_pix + Tl::kRows - 1) / Tl::kRows *
                          ((Cout + Tl::kBN - 1) / Tl::kBN) * lay.chunks * K;
  // the kernel's int32 counters and pixel indices, and its division-free
  // item split
  if (units > INT_MAX || n_pix > INT_MAX || lay.chunks * K >= (1 << 22))
    return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || !aligned(wt)) return cudaErrorInvalidValue;
  // wt (Cout, K * cin_pad): boxes of kc channels (128 bytes) by kBoxRows
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)K * cin_pad, (cuuint64_t)Cout};
  const cuuint64_t pitch[1] = {(cuuint64_t)K * cin_pad * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)lay.kc, (cuuint32_t)kBoxRows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map,
             sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(wt), dims, pitch, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = allow_max_smem(dcn_fwd_kernel<T, kWide>, smem_set);
  if (err != cudaSuccess) return err;
  // one wave: at most max_blocks blocks (one per SM; the caller's workspace
  // holds two slots a block), each running at least kFwdMinItems items
  const unsigned grid = (unsigned)std::max(
      1ll, std::min((long long)max_blocks, units / kFwdMinItems));
  const bool vec_a = Cin % kE == 0 && aligned(x);
  const bool vec_o = Cout % kE == 0 && aligned(out);
  dcn_fwd_kernel<T, kWide><<<grid, kFwdThreads, lay.bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset),
      static_cast<const T*>(mask), map, static_cast<T*>(out),
      static_cast<float*>(partial), static_cast<int*>(arrivals), H, W, Cin,
      cin_pad, Ho, Wo, Cout, Kw, K, stride, pad, dil, n_pix, lay, vec_a,
      vec_o);
  return cudaGetLastError();
}

}  // namespace

// The fused forward.  x (B, H, W, Cin); offset (B, Ho, Wo, 2K); mask (B,
// Ho, Wo, K); wt (Cout, K, cin_pad), the tap-major weight transposed, one
// row of K * cin_pad per output channel, its input channels zero-padded to
// cin_pad, a whole number of stages of input channels; out (B, Ho, Wo,
// Cout); all in one dtype (0 f32, 1 bf16).  smem_bytes is the plan of
// ops/deform_conv.py::dcn_fwd_plan; a plan that disagrees with this file's
// layout is refused.  The grid is at most max_blocks blocks; partial (2 *
// max_blocks * 128 * 256 floats) holds the sums of the tiles that blocks
// share, and arrivals (one int32 per tile of 128 pixels x 256 channels)
// must be 0 and is left 0.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int unibev_dcn_fwd(const void* x, const void* offset,
                              const void* mask, const void* wt, void* out,
                              void* partial, void* arrivals, int max_blocks,
                              int B, int H, int W, int Cin, int cin_pad,
                              int Ho, int Wo, int Cout, int Kh, int Kw,
                              int stride, int pad, int dil, int smem_bytes,
                              int dtype, void* stream) {
  if (B < 0 || Ho < 0 || Wo < 0 || Kh < 1 || Kw < 1 || Cin < 1 || Cout < 1 ||
      stride < 1 || dil < 1)
    return cudaErrorInvalidValue;
  if ((long long)B * H * W > INT_MAX) return cudaErrorInvalidValue;  // int32 rows
  const int K = Kh * Kw;
  const long long n_pix = (long long)B * Ho * Wo;
  if (n_pix == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the wide tile where it covers Cout in one channel tile
  const bool wide = Cout > FwdTile<false>::kBN && Cout <= FwdTile<true>::kBN;
#define UNIBEV_DCN_FWD(T, WIDE)                                              \
  return launch_fwd<T, WIDE>(x, offset, mask, wt, out, partial, arrivals,    \
                             max_blocks, H, W, Cin, cin_pad, Ho, Wo, Cout,   \
                             Kw, K, stride, pad, dil, n_pix, smem_bytes, s)
  if (dtype == 0 && !wide) UNIBEV_DCN_FWD(float, false);
  if (dtype == 0 && wide) UNIBEV_DCN_FWD(float, true);
  if (dtype == 1 && !wide) UNIBEV_DCN_FWD(__nv_bfloat16, false);
  if (dtype == 1 && wide) UNIBEV_DCN_FWD(__nv_bfloat16, true);
#undef UNIBEV_DCN_FWD
  return cudaErrorInvalidValue;
}

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

// The backward.  d_cols, d_offset and d_mask in x's dtype; table (B * H *
// W, Cin) f32, zeroed by the caller, takes d_x.  vec: channels per access,
// at most 4 (Cin % vec == 0; x and d_cols aligned to vec elements, the
// table to vec floats); lanes: threads per (pixel, tap), which must be
// group_lanes(Cin / vec) (ops/deform_conv.py::dcn_bwd_plan).  Returns the
// cudaError_t of the launch.
extern "C" int unibev_dcn_bwd(const void* x, const void* offset,
                              const void* mask, const void* d_cols,
                              void* d_offset, void* d_mask, void* table, int B,
                              int H, int W, int Cin, int Ho, int Wo, int Kh,
                              int Kw, int stride, int pad, int dil, int dtype,
                              int vec, int lanes, void* stream) {
  const int size = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (Kh < 1 || Kw < 1 || Cin < 1 || stride < 1 || dil < 1 || size == 0 ||
      vec < 1 || Cin % vec != 0 || 16 % (vec * size) != 0 ||
      reinterpret_cast<uintptr_t>(x) % (vec * size) != 0 ||
      reinterpret_cast<uintptr_t>(d_cols) % (vec * size) != 0 ||
      reinterpret_cast<uintptr_t>(table) % (4 * vec) != 0 || vec > 4 ||
      lanes != group_lanes(Cin / vec))
    return cudaErrorInvalidValue;
  const int K = Kh * Kw;
  const long long n = (long long)B * Ho * Wo * K * lanes;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
#define UNIBEV_DCN_BWD(T, VEC)                                            \
  launch_bwd<T, VEC>(x, offset, mask, d_cols, d_offset, d_mask, table, H, W, \
                     Cin, Ho, Wo, Kw, K, stride, pad, dil, lanes, n, s)
  switch (dtype * 100 + vec) {
    case 4:
      return UNIBEV_DCN_BWD(float, 4);
    case 2:
      return UNIBEV_DCN_BWD(float, 2);
    case 1:
      return UNIBEV_DCN_BWD(float, 1);
    case 104:
      return UNIBEV_DCN_BWD(BF, 4);
    case 102:
      return UNIBEV_DCN_BWD(BF, 2);
    case 101:
      return UNIBEV_DCN_BWD(BF, 1);
    default:
      return cudaErrorInvalidValue;
  }
#undef UNIBEV_DCN_BWD
}

