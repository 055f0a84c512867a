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
// result decides the next row to read.  The loss's problems (64 gt rows,
// 40 valid, 900 queries) run 41-44 steps for 40 rows after a few train
// steps: nearly every row's Dijkstra ends at its first step, whose argmin
// column is free.
//
// The design shortens each link of that chain.  One block a problem, so
// the L x B problems of a loss run side by side; kWarps warps a block,
// each thread owning the columns j = thread + k * threads (32 at most):
// their v, shortest and remaining bit in registers, their path entries in
// shared memory (the walk reads them).  row4col, col4row and u sit in
// shared memory.
//  - The mask: read once at the block's start into a list of the valid
//    rows (a ballot per 32 rows), so no global read stays on the chain.
//  - Staged rows.  A row's first step reads row `cur`, known long before
//    the previous row ends, and a later step's row i = row4col[j*] is an
//    earlier valid row.  The shared memory holds n_slots rows of costs
//    (as many as fit beside the arrays: 59 at the loss's shape, at least
//    19 at C = 2048): the first n_slots - kRing valid rows stay resident,
//    copied at the block's start, and every step on them, first or later,
//    reads shared memory; the valid rows past them take a ring of kRing
//    slots, each copied while the rows before it are solved, and their
//    later steps read global memory (L2).  Every copy is cp.async of the
//    thread's own columns, which only that thread reads, so it waits on
//    its own copy groups and needs no barrier.
//  - The relaxation issues its loads first, all of them (a column past C
//    reads column 0), then selects and predicated stores with no branch:
//    with a branch a column, each column's load waited on the previous
//    column's compare.  One step body serves first and later steps.
//  - The argmin: the thread's (distance, column) minimum, then the warp's
//    by two redux.sync minima (the distance's bits as an unsigned that
//    orders as the float, then the lowest column among the lanes that hold
//    it).  With more than one warp each warp's lane 0 reads the row its
//    column is matched to and writes one 64-bit word (key, column, row + 1)
//    to its own slot, the slots' two halves in turn; after the step's one
//    __syncthreads every thread takes the least word.  No thread reads
//    row4col after the barrier, so thread 0 may store a match as soon as
//    it passes it.  The float order of the keys is exact: no distance is
//    NaN (a relaxation stores only on <) or -0.0 (min_val starts at +0.0,
//    and ((m + c) - u) - v rounds to -0.0 only when m is -0.0, so by
//    induction no distance or min_val is), and the key of min_val decodes
//    to its own bits.
//  - The fast path.  When the first step's argmin column j* is free, the
//    Dijkstra ends there having scanned j* alone: d = min_val -
//    shortest[j*] is exactly 0 (min_val is shortest[j*]'s own value), so v
//    keeps its bits (v - 0.0f == v), no tree row but cur exists, so u[cur]
//    += min_val is the duals' whole update, and the walk is row4col[j*] =
//    cur, col4row[cur] = j* (path[j*] is cur).  Thread 0 writes those three
//    and the row ends: no dual pass, no walk, no barrier.  The next row's
//    first barrier orders the writes before any read after it, and every
//    thread keeps the match in registers for the reads before it.  The
//    first step writes no path entries at all: its relaxations all lead
//    back to cur, and only a Dijkstra that goes on stores them (path = cur
//    where a column's distance is below INF), before its second step.
//  - A Dijkstra of more steps takes the general path: the dual pass over
//    the scanned columns (v[j] -= min_val - shortest[j] and, through
//    row4col[j], the tree row's u += the same amount: the JAX package's
//    per-row delta, so no set of tree rows is kept), a barrier, thread 0's
//    walk back along path, and a barrier before the next row's reads.
// The width (kWarps), the ring (kRing) and each part above were chosen by
// measurement on the H100 against copies of this file with one change
// each (unibev_tpu_torch/tools/lsa_study.py; PERF.md section 6).

#include <algorithm>
#include <atomic>
#include <climits>

#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

// warps a block (8 beat 1, 4, 16 and 32 at the loss's shape, PERF.md)
constexpr int kWarps = 8;
// the most columns, at most 32 a lane (a thread's `remaining` bits)
constexpr int kMaxCols = 2048;
static_assert(kMaxCols <= kWarps * 32 * 32, "32 columns a lane at most");
// the ring slots of the valid rows past the resident ones
constexpr int kRing = 3;
// the JAX package's INF: the distance of a column not yet reached
constexpr float kInf = 1e30f;

// Asynchronous 4-byte copy from global to shared memory (sm_80 and up).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// A float's bits as an unsigned that orders as the float does (not NaN,
// not -0.0), and back.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

// Shared bytes before the arrays: the row count (16) and 2 x W argmin
// slots of 8 bytes.
__host__ __device__ constexpr int header_bytes(int W) { return 16 + 16 * W; }

template <int W>
__device__ __forceinline__ void block_sync() {
  if constexpr (W == 1)
    __syncwarp();
  else
    __syncthreads();
}

// The block's least (distance, column) of the threads' (best, best_j),
// the lowest column among equal distances, and the row matched to that
// column (next, -1 if free).  (pend_j, pend_r) is a match that thread 0
// may not have stored in row4col yet, -1 if none.
template <int W>
__device__ __forceinline__ void block_argmin(float best, int best_j,
                                             const int* row4col, int pend_j,
                                             int pend_r,
                                             unsigned long long* slots,
                                             int& slot, int& j_star,
                                             int& next, float& min_val) {
  const unsigned key = __reduce_min_sync(0xffffffffu, order_key(best));
  const unsigned col = __reduce_min_sync(
      0xffffffffu,
      order_key(best) == key ? (unsigned)best_j : 0xffffffffu);
  if constexpr (W == 1) {
    j_star = (int)col;
    min_val = key_value(key);
    next = row4col[j_star];
  } else {
    // Each warp reads its column's row before the barrier, so that no
    // thread reads row4col after it: thread 0 may store a match there
    // as soon as it has passed the barrier.  (column, row + 1) pack below
    // the distance's key, the column first (11 and 12 bits), and the
    // warps' words meet in shared memory, one slot a warp, the two halves
    // in turn: a half is written again only after the next barrier, which
    // every thread reaches after reading it.
    unsigned long long* half = slots + slot * W;
    if ((threadIdx.x & 31) == 0) {
      unsigned low = 0xffffffffu;     // a warp with no column
      if (col < (unsigned)kMaxCols) {
        const int r = (int)col == pend_j ? pend_r : row4col[col];
        low = col << 12 | (unsigned)(r + 1);
      }
      half[threadIdx.x >> 5] = (unsigned long long)key << 32 | low;
    }
    __syncthreads();
    unsigned long long m = half[0];
#pragma unroll
    for (int w = 1; w < W; ++w) m = half[w] < m ? half[w] : m;
    slot ^= 1;
    j_star = (int)((unsigned)m >> 12);
    next = (int)((unsigned)m & 0xfffu) - 1;
    min_val = key_value((unsigned)(m >> 32));
  }
}

// The thread's columns of cost row `row`, every load unconditional (a
// column past C reads column 0), so that they are in flight together.
template <int T, int K>
__device__ __forceinline__ void load_row(const float* row, int C,
                                         float (&cost)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = threadIdx.x + k * T;
    cost[k] = row[j < C ? j : 0];
  }
}

// One Dijkstra step's relaxation of the thread's columns from cost row i
// (its costs `cost`, its u ui), with selects and predicated stores, no
// branches, and their (distance, column) minimum.  The first step
// (store_path false) stores no path entries.
template <int T, int K>
__device__ __forceinline__ void relax(const float (&cost)[K], int i,
                                      float ui, float min_val,
                                      const float (&v)[K],
                                      float (&shortest)[K],
                                      unsigned remaining, bool store_path,
                                      int* path, int C, float& best,
                                      int& best_j) {
  best = __int_as_float(0x7f800000);  // +inf: no column
  best_j = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = threadIdx.x + k * T;
    const bool live = (remaining >> k & 1u) && j < C;
    const float reduced = ((min_val + cost[k]) - ui) - v[k];
    const bool better = live && reduced < shortest[k];
    shortest[k] = better ? reduced : shortest[k];
    if (store_path && better) path[j] = i;
    const float masked = live ? shortest[k] : kInf;
    // j rises with k: the lowest column on ties
    const bool take = j < C && masked < best;
    best = take ? masked : best;
    best_j = take ? j : best_j;
  }
}

template <int W, int K>
__global__ void __launch_bounds__(W * 32)
    lsa_kernel(const float* __restrict__ cost, const bool* __restrict__ valid,
               int* __restrict__ col4row_out, int R, int C, int n_slots) {
  constexpr int T = W * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  // the count of valid rows and the warps' argmin slots (2 x W), then
  // the arrays; the block has no static shared memory, so it may take all
  // kMaxSmemBytes dynamically
  int* n_rows = reinterpret_cast<int*>(smem);
  unsigned long long* slots =
      reinterpret_cast<unsigned long long*>(smem + 16);
  // n_slots rows of costs: the first `resident` valid rows stay, the
  // others take the last kRing slots in turn
  float* staged = reinterpret_cast<float*>(smem + header_bytes(W));
  int* row4col = reinterpret_cast<int*>(staged + n_slots * C);  // C
  int* path = row4col + C;                                     // C
  int* col4row = path + C;                                     // R
  float* u = reinterpret_cast<float*>(col4row + R);            // R
  int* rows = reinterpret_cast<int*>(u + R);                   // R
  int* slot_of = rows + R;   // R: a resident row's slot, -1 for the others
  const int resident = n_slots - kRing;

  const int t = threadIdx.x;
  const float* cp = cost + (long long)blockIdx.x * R * C;

  for (int j = t; j < C; j += T) {
    row4col[j] = -1;
    path[j] = -1;
  }
  for (int r = t; r < R; r += T) {
    col4row[r] = -1;
    u[r] = 0.f;
  }
  if (t < 32) {   // the valid rows, in order, and the resident ones' slots
    const bool* vp = valid + (long long)blockIdx.x * R;
    int n = 0;
    for (int r0 = 0; r0 < R; r0 += 32) {
      const int r = r0 + t;
      const bool ok = r < R && vp[r];
      const unsigned ballot = __ballot_sync(0xffffffffu, ok);
      const int m = n + __popc(ballot & ((1u << t) - 1u));
      if (ok) rows[m] = r;
      if (r < R) slot_of[r] = ok && m < resident ? m : -1;
      n += __popc(ballot);
    }
    if (t == 0) *n_rows = n;
  }
  block_sync<W>();
  const int n_valid = *n_rows;

  // valid row n's slot
  auto slot_for = [&](int n) {
    return n < resident ? n : resident + (n - resident) % kRing;
  };
  // valid row n's costs into its slot, the thread's columns
  auto copy_row = [&](int n) {
    float* dst = staged + slot_for(n) * C;
    const float* src = cp + (long long)rows[n] * C;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = t + k * T;
      if (j < C) cp_async4(dst + j, src + j);
    }
  };
  // a ring row: one copy group a call, empty past the last row
  auto stage = [&](int n) {
    if (n < n_valid) copy_row(n);
    cp_async_commit();
  };
  // the resident rows in one group, then the ring's first rows
  for (int n = 0; n < n_valid && n < resident; ++n) copy_row(n);
  cp_async_commit();
#pragma unroll
  for (int n = 0; n < kRing - 1; ++n) stage(resident + n);
  cp_async_wait<kRing - 1>();   // the resident rows are in

  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.f;
  int slot = 0;
  int pend_j = -1, pend_r = -1;   // the last fast path's match
  for (int n = 0; n < n_valid; ++n) {
    const int cur = rows[n];
    if (n >= resident) {
      stage(n + kRing - 1);
      cp_async_wait<kRing - 1>();   // row n's group is complete
    }
    float shortest[K];
#pragma unroll
    for (int k = 0; k < K; ++k) shortest[k] = kInf;
    unsigned remaining = ~0u;     // bit k: column t + k * T not scanned
    // the first step reads the staged row, and u[cur] is 0 (cur was never
    // in a tree); a later step reads row i = row4col[j*], from its slot if
    // it is resident (staged at its own row), else from global memory
    int i = cur, s = slot_for(n), step = 0, j_star, next;
    float ui = 0.f, min_val = 0.f;
    // each step scans one more column: at most C steps with finite costs
    for (;;) {
      float cost[K];
      if (s >= 0)
        load_row<T, K>(staged + s * C, C, cost);
      else
        load_row<T, K>(cp + (long long)i * C, C, cost);
      float best;
      int best_j;
      relax<T, K>(cost, i, ui, min_val, v, shortest, remaining, step > 0,
                  path, C, best, best_j);
      block_argmin<W>(best, best_j, row4col, pend_j, pend_r, slots, slot,
                      j_star, next, min_val);
      pend_j = -1;   // thread 0 stored it before the barrier
      if (j_star % T == t) remaining &= ~(1u << (j_star / T));
      if (next < 0 || step + 1 == C) break;
      if (step == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {   // the first step's tree row
          const int j = t + k * T;
          if (j < C && shortest[k] < kInf) path[j] = cur;
        }
      }
      ++step;
      i = next;
      ui = u[i];
      s = slot_of[i];
    }
    if (step == 0) {
      // the fast path: j* is free at the first step
      if constexpr (W == 1) __syncwarp();   // every lane has read next
      if (t == 0) {
        row4col[j_star] = cur;
        col4row[cur] = j_star;
        u[cur] = u[cur] + min_val;
      }
      if constexpr (W == 1) __syncwarp();
      pend_j = j_star;
      pend_r = cur;
      continue;
    }
    // the duals: each scanned column, and the tree row it leads to
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = t + k * T;
      if (j < C && !(remaining >> k & 1u)) {
        const float d = min_val - shortest[k];
        v[k] = v[k] - d;
        const int r = row4col[j];
        if (r >= 0) u[r] = u[r] + d;
      }
    }
    if (t == 0) u[cur] = u[cur] + min_val;   // cur is in no column's row4col
    block_sync<W>();
    // augment along the alternating path back to cur
    if (t == 0) {
      int j = j_star;
      for (int m = 0; m <= R; ++m) {
        const int r = path[j];
        if (r < 0) break;                    // only with non-finite costs
        row4col[j] = r;
        const int prev = col4row[r];
        col4row[r] = j;
        if (r == cur || prev < 0) break;
        j = prev;
      }
    }
    // the walk's stores before the next row's reads of row4col
    block_sync<W>();
  }
  cp_async_wait<0>();
  block_sync<W>();
  for (int r = t; r < R; r += T)
    col4row_out[(long long)blockIdx.x * R + r] = col4row[r];
}

template <int W, int K>
cudaError_t launch(const void* cost, const void* valid, void* col4row, int P,
                   int R, int C, cudaStream_t s) {
  // as many rows of costs as the shared memory holds beside the arrays, at
  // most one a row and the ring: at least 22 at C = 2048
  const int arrays = 4 * (2 * C + 4 * R);
  const int n_slots =
      std::min((kMaxSmemBytes - header_bytes(W) - arrays) / (4 * C),
               R + kRing);
  const size_t smem = header_bytes(W) + (size_t)n_slots * C * 4 + arrays;
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> done{0};
    const cudaError_t err = allow_max_smem(lsa_kernel<W, K>, done);
    if (err != cudaSuccess) return err;
  }
  lsa_kernel<W, K><<<P, W * 32, smem, s>>>(
      static_cast<const float*>(cost), static_cast<const bool*>(valid),
      static_cast<int*>(col4row), R, C, n_slots);
  return cudaGetLastError();
}

// K columns a lane: the least power of two that covers C, up to kMaxCols
template <int K>
cudaError_t launch_cols(const void* cost, const void* valid, void* col4row,
                        int P, int R, int C, cudaStream_t s) {
  if constexpr (kWarps * 32 * K < kMaxCols)
    if (C > kWarps * 32 * K)
      return launch_cols<2 * K>(cost, valid, col4row, P, R, C, s);
  return launch<kWarps, K>(cost, valid, col4row, P, R, C, s);
}

}  // namespace

// One block per problem.  Returns the cudaError_t of the launch; refuses
// R > C and C > 2048.
extern "C" int unibev_lsa(const void* cost, const void* valid, void* col4row,
                          int P, int R, int C, void* stream) {
  if (P < 0 || R < 0 || C < 1 || R > C || C > kMaxCols)
    return cudaErrorInvalidValue;
  if (P == 0 || R == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_cols<1>(cost, valid, col4row, P, R, C, s);
}
