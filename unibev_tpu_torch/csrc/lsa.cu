// Linear sum assignment (kernel K12 of the port): for each problem, the
// min-cost assignment of its valid rows (gt boxes) to distinct columns
// (queries), by the rectangular Jonker-Volgenant shortest augmenting path.
//
// Replaces unibev_tpu/core/bbox/lsa.py:31 (linear_sum_assignment), the JAX
// package's in-graph solver: lax.while_loop over the rows, a Dijkstra over
// the columns from each row, the duals' update and an augmenting walk.  It
// keeps the head's Hungarian matching on the card, where the port copied
// the costs to the host for scipy; that copy made every train step wait for
// its forward to drain.
//
// Layouts: cost (P, R, C) f32, rows gt boxes and columns queries, R <= C;
// valid (P, R) bool; col4row (P, R) int32 out, each valid row's column and
// -1 on the others.  Valid rows are solved in increasing order, so a packed
// mask gives the JAX function's result and any other mask the solution of
// the valid rows' sub-matrix.  The arithmetic is the JAX loop's, in its
// order (reduced = ((min_val + cost) - u) - v; plain + and -, built without
// --use_fast_math), the strict < of its relaxation, and ties to the lowest
// column as jnp.argmin breaks them, so col4row equals the plain version's
// (core/bbox/lsa.py) bit for bit.  Costs must be finite.
//
// What bounds it on the H100: not bytes.  The rows the Dijkstras read are
// at most the valid rows' costs (~1.4 MB at the flagship's 6 x 64 x 900,
// well under a microsecond at 3.35 TB/s), and the arithmetic is a few
// operations per column and step.  What sets its time is the sequential
// chain: rows x Dijkstra steps, each step one block-wide argmin whose
// result decides the next row to read.
//
// The design is the simple one against that chain.  One block a problem,
// so the L x B problems of a loss run side by side.  256 threads, each
// owning K columns (j = thread + k * 256): their v, shortest and remaining
// in registers, their path entries in shared memory (the walk reads them).
// row4col, col4row and u sit in shared memory.  A step reads row i of the
// costs, coalesced, from global memory (L2: the costs were just written);
// relaxes the thread's columns and takes its (distance, column) minimum,
// then a warp's by shuffles and the block's through shared memory: one
// __syncthreads a step, the warps' minima double-buffered by the step's
// parity.  The duals' update goes column by column: a scanned column j
// gives v[j] -= min_val - shortest[j] and, through row4col[j], the tree
// row's u += the same amount (the JAX package's per-row delta), so no
// set of tree rows is kept.  One thread walks the augmenting path; two
// more __syncthreads a row.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the JAX package's INF: the distance of a column not yet reached
constexpr float kInf = 1e30f;

// (a, ja) before (b, jb): the smaller distance, the lower column on ties
__device__ __forceinline__ bool before(float a, int ja, float b, int jb) {
  return a < b || (a == b && ja < jb);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    lsa_kernel(const float* __restrict__ cost, const bool* __restrict__ valid,
               int* __restrict__ col4row_out, int R, int C) {
  extern __shared__ int smem[];
  int* row4col = smem;                       // C
  int* path = row4col + C;                   // C
  int* col4row = path + C;                   // R
  float* u = reinterpret_cast<float*>(col4row + R);            // R
  float* warp_v = u + R;                                       // 2 x kWarps
  int* warp_j = reinterpret_cast<int*>(warp_v + 2 * kWarps);   // 2 x kWarps

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* cp = cost + (long long)blockIdx.x * R * C;
  const bool* vp = valid + (long long)blockIdx.x * R;
  const float past_all = __int_as_float(0x7f800000);  // +inf: no column

  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.f;
  for (int j = t; j < C; j += kThreads) row4col[j] = -1;
  for (int r = t; r < R; r += kThreads) {
    col4row[r] = -1;
    u[r] = 0.f;
  }
  __syncthreads();

  int parity = 0;
  for (int cur = 0; cur < R; ++cur) {
    if (!vp[cur]) continue;
    float shortest[K];
    bool remaining[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = t + k * kThreads;
      shortest[k] = kInf;
      remaining[k] = j < C;
      if (j < C) path[j] = -1;
    }
    int i = cur, j_star = 0;
    float min_val = 0.f;
    // each step scans one more column: at most C steps with finite costs
    for (int step = 0; step < C; ++step) {
      const float* row = cp + (long long)i * C;
      const float ui = u[i];
      float best = past_all;
      int best_j = INT_MAX;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = t + k * kThreads;
        if (j < C) {
          float masked = kInf;
          if (remaining[k]) {
            const float reduced = ((min_val + row[j]) - ui) - v[k];
            if (reduced < shortest[k]) {
              shortest[k] = reduced;
              path[j] = i;
            }
            masked = shortest[k];
          }
          if (masked < best) {   // j rises with k: the lowest column on ties
            best = masked;
            best_j = j;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
        if (before(ov, oj, best, best_j)) {
          best = ov;
          best_j = oj;
        }
      }
      if (lane == 0) {
        warp_v[parity * kWarps + warp] = best;
        warp_j[parity * kWarps + warp] = best_j;
      }
      __syncthreads();
      // every thread reduces the warps' minima itself; the next step writes
      // the other buffer, and the one after it only once every thread has
      // passed the next step's barrier, after reading this one
      best = warp_v[parity * kWarps];
      best_j = warp_j[parity * kWarps];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float ov = warp_v[parity * kWarps + w];
        const int oj = warp_j[parity * kWarps + w];
        if (before(ov, oj, best, best_j)) {
          best = ov;
          best_j = oj;
        }
      }
      parity ^= 1;
      j_star = best_j;
      min_val = best;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (t + k * kThreads == j_star) remaining[k] = false;
      const int next = row4col[j_star];
      if (next < 0) break;
      i = next;
    }
    // the duals: each scanned column, and the tree row it leads to
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = t + k * kThreads;
      if (j < C && !remaining[k]) {
        const float d = min_val - shortest[k];
        v[k] = v[k] - d;
        const int r = row4col[j];
        if (r >= 0) u[r] = u[r] + d;
      }
    }
    if (t == 0) u[cur] = u[cur] + min_val;   // cur is in no column's row4col
    __syncthreads();
    // augment along the alternating path back to cur
    if (t == 0) {
      int j = j_star;
      for (int n = 0; n <= R; ++n) {
        const int r = path[j];
        if (r < 0) break;                    // only with non-finite costs
        row4col[j] = r;
        const int prev = col4row[r];
        col4row[r] = j;
        if (r == cur || prev < 0) break;
        j = prev;
      }
    }
    __syncthreads();
  }
  for (int r = t; r < R; r += kThreads)
    col4row_out[(long long)blockIdx.x * R + r] = col4row[r];
}

template <int K>
cudaError_t launch(const void* cost, const void* valid, void* col4row, int P,
                   int R, int C, cudaStream_t s) {
  const size_t smem = (size_t)(2 * C + 2 * R) * 4 + 2 * kWarps * 8;
  lsa_kernel<K><<<P, kThreads, smem, s>>>(
      static_cast<const float*>(cost), static_cast<const bool*>(valid),
      static_cast<int*>(col4row), R, C);
  return cudaGetLastError();
}

}  // namespace

// One block per problem.  Returns the cudaError_t of the launch; refuses
// R > C and C > 2048 (8 columns a thread; 32 KB of shared memory at most).
extern "C" int unibev_lsa(const void* cost, const void* valid, void* col4row,
                          int P, int R, int C, void* stream) {
  if (P < 0 || R < 0 || C < 1 || R > C || C > 8 * kThreads)
    return cudaErrorInvalidValue;
  if (P == 0 || R == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= kThreads) return launch<1>(cost, valid, col4row, P, R, C, s);
  if (C <= 2 * kThreads) return launch<2>(cost, valid, col4row, P, R, C, s);
  if (C <= 4 * kThreads) return launch<4>(cost, valid, col4row, P, R, C, s);
  return launch<8>(cost, valid, col4row, P, R, C, s);
}
