// Frozen BatchNorm, residual add and ReLU in one pass over an activation
// (kernel K13 of the port).
//
// Replaces no Pallas kernel.  The JAX package's ResNet applies each frozen BN
// as jnp arithmetic (unibev_tpu/models/backbones/resnet.py, FrozenBatchNorm
// and Bottleneck), and XLA fuses the affine, the residual add and the ReLU
// into one loop over the activation.  Eager PyTorch does not: there a frozen
// BN was 13 launches (casts of its four buffers, +eps, rsqrt, two multiplies
// and a subtract on C-vectors, then a multiply and an add over the
// activation), and the ReLU and the residual add one pass each.
//
// Per channel c, s = w * rsqrt(var + eps) and t = b - mean * s, FrozenBatch-
// Norm's formula in float32 from the BN's own four buffers (read in their
// stored dtype, f32 or bf16), then per element, in float32 and in this order:
//   form 0:  y = relu(x * s + t)
//   form 1:  y = relu((x * s + t) + r)                      identity residual
//   form 2:  y = relu((x * s + t) + (d * sd + td))          downsample branch
// rounded to x's dtype once, at the store.  Adds and multiplies are the
// round-to-nearest intrinsics, so no FMA contraction changes the sums from
// the plain version's (ops/frozen_bn.py).  Nothing is cached across launches
// and nothing is folded into a convolution's weights.
//
// Layouts: x, r, d and out are NHWC (a channels_last NCHW tensor) of one
// dtype, f32 or bf16, C a multiple of 8, every pointer 16-byte aligned; the
// buffers are (C,) vectors, all of one dtype.
//
// What bounds it on the H100: bytes.  Each element is read once from each
// input and written once: 4, 6 or 8 bytes an element in bf16.  The design:
//  - 16-byte vectors (8 bf16 or 4 f32 channels), streamed in with an
//    evict-first hint (each input is dead after this pass); the output is
//    stored plainly, since the next convolution reads it.
//  - The loop's stride, in vectors, is a multiple of a row's vectors
//    (C / VEC), so a thread meets the same VEC channels at every step: it
//    computes their s and t (and sd, td) into registers once, from vector
//    loads of the buffers, and needs no shared memory and no barrier.
//  - One wave of resident blocks (occupancy from the runtime, cached per
//    instantiation), each thread kUnroll vectors an iteration, all loads of
//    an iteration issued before its first store.
// No atomics, no workspace, no host sync; the only allocation is the output
// (the wrapper's).

#include <cstdint>

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

struct Bn {
  const void* w;
  const void* b;
  const void* mean;
  const void* var;
  float eps;
};

struct Args {
  const void* x;
  const void* r;
  const void* d;
  void* out;
  Bn bn;
  Bn bn_d;
  long long n_vec;     // 16-byte vectors of x
  long long stride;    // threads of the loop, a multiple of row_vecs
  int row_vecs;        // C / VEC
};

// N channels of a buffer from c0, as floats: 16-byte loads (c0 * sizeof(B)
// and the buffer are aligned to min(16, N * sizeof(B)) bytes)
template <typename B, int N>
__device__ __forceinline__ void load_channels(const void* buf, int c0,
                                              float (&out)[N]) {
  constexpr int kPer = 16 / (int)sizeof(B) < N ? 16 / (int)sizeof(B) : N;
  const B* p = static_cast<const B*>(buf) + c0;
#pragma unroll
  for (int j = 0; j < N; j += kPer) {
    Chunk<B, kPer> c;
    c.load(p + j);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[j + i] = c.get(i);
  }
}

// FrozenBatchNorm's s and t for channels [c0, c0 + N)
template <typename B, int N>
__device__ __forceinline__ void affine(const Bn& bn, int c0, float (&s)[N],
                                       float (&t)[N]) {
  float w[N], b[N], mean[N], var[N];
  load_channels<B, N>(bn.w, c0, w);
  load_channels<B, N>(bn.b, c0, b);
  load_channels<B, N>(bn.mean, c0, mean);
  load_channels<B, N>(bn.var, c0, var);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = __fmul_rn(w[i], rsqrtf(__fadd_rn(var[i], bn.eps)));
    t[i] = __fsub_rn(b[i], __fmul_rn(mean[i], s[i]));
  }
}

__device__ __forceinline__ uint4 load_stream(const void* base, long long v) {
  return __ldcs(static_cast<const uint4*>(base) + v);
}

template <typename T, int VEC>
__device__ __forceinline__ float lane(const uint4& raw, int i) {
  Chunk<T, VEC> c;
  c.raw = raw;
  return c.get(i);
}

template <typename T, typename B, int FORM>
__global__ void __launch_bounds__(kThreads)
    frozen_bn_act_kernel(const Args a) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (tid >= a.stride) return;
  const int c0 = (int)(tid % a.row_vecs) * VEC;
  float s[VEC], t[VEC], sd[VEC], td[VEC];
  affine<B, VEC>(a.bn, c0, s, t);
  if constexpr (FORM == 2) affine<B, VEC>(a.bn_d, c0, sd, td);
  for (long long v0 = tid; v0 < a.n_vec; v0 += kUnroll * a.stride) {
    uint4 xs[kUnroll], rs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * a.stride;
      if (v < a.n_vec) {
        xs[u] = load_stream(a.x, v);
        if constexpr (FORM == 1) rs[u] = load_stream(a.r, v);
        if constexpr (FORM == 2) rs[u] = load_stream(a.d, v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * a.stride;
      if (v >= a.n_vec) break;
      Chunk<T, VEC> y;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float z = __fadd_rn(__fmul_rn(lane<T, VEC>(xs[u], i), s[i]), t[i]);
        if constexpr (FORM == 1) z = __fadd_rn(z, lane<T, VEC>(rs[u], i));
        if constexpr (FORM == 2)
          z = __fadd_rn(
              z, __fadd_rn(__fmul_rn(lane<T, VEC>(rs[u], i), sd[i]), td[i]));
        // relu as torch.relu: NaN stays NaN
        reinterpret_cast<T*>(&y.raw)[i] = from_float<T>(z < 0.f ? 0.f : z);
      }
      static_cast<uint4*>(a.out)[v] = y.raw;
    }
  }
}

template <typename T, typename B, int FORM>
cudaError_t launch(const Args& base, long long n, int C, int sms,
                   cudaStream_t s) {
  static const int per_sm = [] {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, frozen_bn_act_kernel<T, B, FORM>, kThreads, 0);
    return blocks > 0 ? blocks : 1;
  }();
  constexpr int VEC = 16 / (int)sizeof(T);
  Args a = base;
  a.n_vec = n / VEC;
  a.row_vecs = C / VEC;
  // one wave of resident blocks at most, and no thread without a vector
  long long threads = (a.n_vec + kUnroll - 1) / kUnroll;
  const long long wave = (long long)sms * per_sm * kThreads;
  if (threads > wave) threads = wave;
  a.stride = (threads + a.row_vecs - 1) / a.row_vecs * a.row_vecs;
  const unsigned blocks = (unsigned)((a.stride + kThreads - 1) / kThreads);
  frozen_bn_act_kernel<T, B, FORM><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, typename B>
cudaError_t launch_form(const Args& a, long long n, int C, int form, int sms,
                        cudaStream_t s) {
  switch (form) {
    case 0:
      return launch<T, B, 0>(a, n, C, sms, s);
    case 1:
      return launch<T, B, 1>(a, n, C, sms, s);
    default:
      return launch<T, B, 2>(a, n, C, sms, s);
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, r (form 1), d (form 2), out: n elements NHWC, C channels; w, b, mean,
// var, eps: the BN of x; wd .. epsd: the downsample branch's BN (form 2).
// dtype: 0 f32, 1 bf16 (of x, r, d and out); buf_dtype: the same codes for
// the eight buffers.  sms: the device's SM count.  Returns the cudaError_t
// of the launch; refuses C not a multiple of 8, n not a multiple of C, an
// unaligned pointer, another form or dtype.
extern "C" int unibev_frozen_bn_act(const void* x, const void* r,
                                    const void* d, void* out, const void* w,
                                    const void* b, const void* mean,
                                    const void* var, float eps,
                                    const void* wd, const void* bd,
                                    const void* meand, const void* vard,
                                    float epsd, long long n, int C, int form,
                                    int dtype, int buf_dtype, int sms,
                                    void* stream) {
  if (n < 0 || C < 8 || C % 8 != 0 || n % C != 0 || form < 0 || form > 2 ||
      dtype < 0 || dtype > 1 || buf_dtype < 0 || buf_dtype > 1 || sms < 1)
    return cudaErrorInvalidValue;
  const void* ptrs[] = {x, out, w, b, mean, var};
  for (const void* p : ptrs)
    if (!aligned(p)) return cudaErrorInvalidValue;
  if ((form == 1 && !aligned(r)) ||
      (form == 2 && !(aligned(d) && aligned(wd) && aligned(bd) &&
                      aligned(meand) && aligned(vard))))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Args a{x, r, d, out, Bn{w, b, mean, var, eps},
               Bn{wd, bd, meand, vard, epsd}, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  switch (dtype * 2 + buf_dtype) {
    case 0:
      return launch_form<float, float>(a, n, C, form, sms, s);
    case 1:
      return launch_form<float, BF>(a, n, C, form, sms, s);
    case 2:
      return launch_form<BF, float>(a, n, C, form, sms, s);
    default:
      return launch_form<BF, BF>(a, n, C, form, sms, s);
  }
}
