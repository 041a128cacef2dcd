// The pruning forward sweep at S = 4 for Hopper (sm_90a), shared by K1'
// (csrc/pruning.cu, one chain, RootWeights) and K5' at S = 4
// (csrc/loop.cu, a batch of L chains, FreqsProps): each internal node's
// rescaled partials and scaler, and the site log-likelihoods.
//
// Layouts (pattern axis innermost):
//   tips      [T, 4, P]          shared by every chain
//   pmats     [L, N, C, 4, 4]    P matrix of the branch above each node
//   children  [I, maxc]          int32 child ids, -1 for a missing child
//   order     [I]                internal ranks by postorder level, leaves
//                                first (topo.levels)
//   offsets   [levels + 1]       the levels' bounds in `order`; the last
//                                level holds the root alone
//   partials  [L, I, C, 4, P]    rescaled partials of internal node rank k
//   scale     [L, I, P]          per-node max m over (C, 4), at least tiny;
//                                1 unrescaled
//   site_log  [L, P]             log(max(sum_c,s rootw(l, c, s) x_root,
//                                tiny)) + sum_k log m_k
// Internal node k has id T + k; ids are postorder ranks, the root is N - 1.
// The reverse sweep (csrc/s4_backward.cuh) reads partials and scale as they
// are.
//
// What bounds it: per node and pattern about 32 C maxc FLOPs against C x
// 16 bytes of partials written in float32, and at MCMC and ML sizes (fluA,
// 238 patterns) the whole sweep moves a few MB: bounds of 0.2-0.6 us. The
// time is the latency of the dependent chain from the leaves to the root.
// The first designs (one thread a pattern, or a (pattern, chain), walking
// every internal node in postorder rank, 68 on the fluA tree, each child's
// partials loaded behind a branch on the child's kind, from a node the same
// thread wrote one step earlier) ran at 330-520x the bound: 68 dependent
// round trips, and 2 of the 132 SMs busy for one chain. This design:
// - Walks by postorder level, leaves first (33 levels against 68 nodes on
//   the fluA tree), one barrier a level; a level's nodes are spread over
//   the warps of a block, and a block walks every level for its patterns
//   in one launch.
// - Puts a pattern's categories on the threads, not on the grid, since the
//   rescaling max runs over (C, 4): threads sit on (pattern, category,
//   state), the 4 C' lanes of a pattern in one warp (C' is C rounded up to
//   1, 2, 4 or 8), so that the max is log2(4 C') shuffles and no barrier.
//   Padded lanes (category C and above) hold 0, which never raises the max
//   (it is clamped at tiny), and store nothing. A lane reads one state of a
//   child and takes the other three from its quad by shuffles.
// - Hands each node's partials to its parent's level through shared
//   memory: a thread keeps its lane of a node at every level, so it writes
//   its lane of each node it computes into the block's hand-off [I, lanes]
//   and reads its lane of each internal child there after the barrier,
//   with the scalers beside them for the log sum. The partials and scalers
//   still go to device memory for the reverse sweep. Where the hand-off
//   does not fit beside the rest with the whole grid resident, internal
//   children are read from device memory with plain loads, never through
//   the read-only path, which is not coherent with writes made in the same
//   launch.
// - Keeps off the chain what does not depend on the walk: a binary node's
//   position, rank and children are read two levels ahead and its tip
//   children's states loaded into registers one level ahead; the chain's P
//   matrices and the index tables sit in shared memory where they fit
//   (else they are read from device memory). Every load is unconditional
//   (loads behind per-load branches are issued one after another): a
//   missing child (-1) loads node 0 and then counts as 1, a lane past P
//   loads pattern P - 1 and stores nothing.
// - Polytomies (maxc != 2) take a generic step, each child loaded in turn,
//   as do a wide level's further rounds.
// - Sums in fixed orders, with no atomics, so results are bit-identical run
//   to run: the root's sum over (C, 4) by a butterfly over its lane group,
//   and after the walk sum_k log m_k, R lanes a pattern each taking every
//   R-th rank in rank order, then a butterfly over the R lanes.
// - Grid (pattern blocks, L), S4_THREADS threads: a block takes the fewest
//   patterns (at least one warp a node) with which the whole grid is
//   resident at once.
// - Starts where its Stage says: K1' and K5' walk the whole tree
//   (WholeTree), K3' (csrc/staged.cu) the narrow top of a tree whose wide
//   levels earlier launches wrote to the stage (TopOfStage: children below
//   the start level read from there with plain loads, log m stored as the
//   scaler, the stage's scaler rows folded into the site log).
// Measured against the alternatives (clock64() stamps a level, PERF.md):
// copying a binary node's tip children into shared memory by cp.async two
// levels ahead, as the reverse walk does, put its cost on every level
// wherever it sat in the step, and a hand-off through device memory waits
// on L2 at every level; that layout took about 2000 cycles a level on the
// fluA tree, this one about 1400.

#pragma once

#include <cuda_runtime.h>

#include "s4_common.cuh"
#include "tiles.cuh"

namespace {

// one chain's P matrices sit in shared memory up to this size
constexpr size_t S4F_P_SMEM = 96 * 1024;
// patterns a block takes at most: 256 threads at 4 lanes a pattern
constexpr int S4F_MAX_PB = S4_THREADS / 4;
// the P matrices are copied in rounds of this many loads a thread
constexpr int S4F_COPY = 8;
// a top-of-stage walk's sum of log m keeps this many loads in flight a lane
constexpr int S4F_SUM_LOADS = 4;

// Where the walk starts and what lies below it. K1' and K5' walk the whole
// tree: an internal child is in the hand-off (or the walk's partials) at
// its rank, and the scaler stored is m.
struct WholeTree {
  static constexpr bool whole = true;
  __device__ int start() const { return 0; }
};

// K3''s walk of the top of the tree from level `level`: the nodes of the
// levels below were written to the stage (partials [I, C, 4, P], log m
// [I, P]) by earlier launches on the stream; a walked node takes the
// hand-off slot of its position in the walk. slots [I]: rank k's slot, -1
// below the walk. The scaler stored is log m.
struct TopOfStage {
  static constexpr bool whole = false;
  const int* slots;  // device memory, or the block's copy in shared memory
  int level;
  __device__ int start() const { return level; }
  __device__ int slot(int k) const { return slots[k]; }
};

// the bytes of a walk's index tables in shared memory: a top-of-stage walk
// keeps its slots [I] beside them
template <typename Stage>
__host__ __device__ inline size_t s4_walk_table_bytes(int n_levels, int I,
                                                      int maxc) {
  return s4_table_bytes(n_levels, I, maxc) +
         (Stage::whole ? 0 : (size_t)I * sizeof(int));
}

// One chain's walk as one thread sees it: its lane r of a node (W =
// 2^node_log2 lanes), category cc (C - 1 for a padded lane), state s and
// pattern pc (P - 1 past P)
template <typename scalar_t, typename Stage> struct S4Forward {
  const scalar_t* __restrict__ tips;  // [T, 4, P]
  const scalar_t* pt;     // P matrices: node n's category c at (n C + c) 16
  scalar_t* part;         // [I, C, 4, P]: written and read in this launch
  scalar_t* sc;           // [I, P]
  scalar_t* hand;         // [I, W] shared: each node at the block's lanes
                          // (a top-of-stage walk: [walked, W] by slot)
  WalkTables tb;
  int T, C, P, cc, s, pc, q0, r, node_log2;
  Stage stage;

  // y[s] = sum_b P_child[cc][s][b] v[b], v[b] held by lane q0 | b
  __device__ scalar_t row_product(int a, scalar_t v) const {
    const scalar_t* q = pt + ((size_t)a * C + cc) * 16 + s * 4;
    scalar_t y = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) y += q[b] * __shfl_sync(S4_FULL, v, q0 | b);
    return y;
  }
  // where this lane's state of tip a lies
  __device__ const scalar_t* tip(int a) const {
    return tips + ((size_t)a * 4 + s) * P + pc;
  }
  // where this lane's state of internal node rank k lies: the block's
  // hand-off in shared memory, else the walk's partials (or the stage)
  __device__ const scalar_t* internal(int k) const {
    const scalar_t* own = part + (((size_t)k * C + cc) * 4 + s) * P + pc;
    if constexpr (Stage::whole) {
      return hand ? hand + ((size_t)k << node_log2) + r : own;
    } else {
      const int sl = stage.slot(k);
      return hand && sl >= 0 ? hand + ((size_t)sl << node_log2) + r : own;
    }
  }
  // the rank read in place of a tip child's: one the hand-off holds
  __device__ int spare(int I) const { return Stage::whole ? 0 : I - 1; }
};

// The product over the children of the node at position j of `order` at
// this lane, for any number of children: each child loaded in turn, tips
// and internal nodes through one address. Uniform over a warp.
template <typename scalar_t, typename Stage>
__device__ inline scalar_t generic_product(const S4Forward<scalar_t, Stage>& w,
                                           int j) {
  scalar_t res = 1;
  for (int i = 0; i < w.tb.maxc; ++i) {
    const int ci = w.tb.kid(j, i);
    const int a = ci >= 0 ? ci : 0;
    const scalar_t y = w.row_product(
        a, *(a < w.T ? w.tip(a) : w.internal(a - w.T)));
    res *= ci >= 0 ? y : scalar_t(1);  // a missing child contributes 1
  }
  return res;
}

// A binary node's first-round step as known ahead of its level: its
// position j and rank k in the walk, its children and each tip child's
// state at this lane (node 0's for an internal or missing child)
template <typename scalar_t> struct PairAhead {
  int j, k, c0, c1;
  scalar_t v0, v1;
};

// the node at position j's indices (shared memory, two levels ahead)
template <typename scalar_t, typename Stage>
__device__ inline PairAhead<scalar_t> pair_indices(
    const S4Forward<scalar_t, Stage>& w, int j) {
  return PairAhead<scalar_t>{j, w.tb.order[j], w.tb.kid(j, 0),
                             w.tb.kid(j, 1), scalar_t(0), scalar_t(0)};
}

// its tip children's states, loaded unconditionally (one level ahead)
template <typename scalar_t, typename Stage>
__device__ inline void pair_tips(const S4Forward<scalar_t, Stage>& w,
                                 PairAhead<scalar_t>& pa) {
  pa.v0 = __ldg(w.tip(pa.c0 >= 0 && pa.c0 < w.T ? pa.c0 : 0));
  pa.v1 = __ldg(w.tip(pa.c1 >= 0 && pa.c1 < w.T ? pa.c1 : 0));
}

// The binary node's product at this lane: the internal children's states
// read from the hand-off (both, unconditionally), the tips' from `pa`
template <typename scalar_t, typename Stage>
__device__ inline scalar_t pair_product(const S4Forward<scalar_t, Stage>& w,
                                        const PairAhead<scalar_t>& pa, int I) {
  const int a0 = pa.c0 >= 0 ? pa.c0 : 0, a1 = pa.c1 >= 0 ? pa.c1 : 0;
  const scalar_t i0 = *w.internal(a0 >= w.T ? a0 - w.T : w.spare(I));
  const scalar_t i1 = *w.internal(a1 >= w.T ? a1 - w.T : w.spare(I));
  const scalar_t y0 = w.row_product(a0, a0 < w.T ? pa.v0 : i0);
  const scalar_t y1 = w.row_product(a1, a1 < w.T ? pa.v1 : i1);
  return (pa.c0 >= 0 ? y0 : scalar_t(1)) * (pa.c1 >= 0 ? y1 : scalar_t(1));
}

// The walk: grid (ceil(P / 2^pb_log2), L), S4_THREADS threads. A pattern
// takes G = 4 << cg_log2 lanes (cg_log2 = log2 C'); item t of a level is
// the node at position t / W of the level (W = G PB lanes a node), pattern
// p0 + (t % W) / G, category (t / 4) % C', state t % 4, so that a thread
// keeps its pattern, category and state, and its lane r of a node, at
// every level (W divides S4_THREADS and is at least 32). At a binary node
// a thread's first item of a level has its indices read two levels ahead
// and its tip children loaded one level ahead; a level of more than
// S4_THREADS / W nodes takes further rounds, loaded in turn. The levels
// walked are stage.start() to the root's; `walked` nodes lie in them.
// Dynamic shared memory: the index tables (`tables`; a top-of-stage
// walk's slots beside them), the root's sites,
// with `hand` the hand-off [walked, W] and the scalers [walked, PB], and
// this chain's P matrices (`stage_p`).
template <typename scalar_t, typename Root, typename Stage>
__global__ void __launch_bounds__(S4_THREADS)
    s4_forward_kernel(const scalar_t* __restrict__ tips,
                      const scalar_t* __restrict__ pmats,
                      const int* __restrict__ children,
                      const int* __restrict__ order,
                      const int* __restrict__ offsets, int n_levels,
                      Root rootw, Stage stage, scalar_t* partials,
                      scalar_t* scale, scalar_t* __restrict__ site_log, int T,
                      int I, int C, int cg_log2, int maxc, int P, int pb_log2,
                      int rescale, int tables, int hand, int stage_p,
                      int walked) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int l = blockIdx.y;
  const int p0 = blockIdx.x << pb_log2;
  const int g_log2 = cg_log2 + 2;          // lanes a pattern
  const int node_log2 = pb_log2 + g_log2;  // lanes a node
  const int N = T + I;
  const WalkTables tb =
      walk_tables(offsets, order, children, n_levels, I, maxc, tables,
                  reinterpret_cast<int*>(smem_raw));
  if constexpr (!Stage::whole) {
    if (tables) {
      int* sl = reinterpret_cast<int*>(smem_raw) +
                s4_table_bytes(n_levels, I, maxc) / sizeof(int);
      for (int t = threadIdx.x; t < I; t += blockDim.x)
        sl[t] = __ldg(stage.slots + t);
      stage.slots = sl;
    }
  }
  scalar_t* site_sh = reinterpret_cast<scalar_t*>(
      smem_raw +
      (tables ? (s4_walk_table_bytes<Stage>(n_levels, I, maxc) + 15) / 16 *
                    16
              : 0));
  scalar_t* msh = site_sh + S4F_MAX_PB;  // [walked, PB] with the hand-off
  scalar_t* hsh = msh + (hand ? (size_t)walked << pb_log2 : 0);
  scalar_t* Ps = hsh + (hand ? (size_t)walked << node_log2 : 0);
  const scalar_t* pm = pmats + (size_t)l * N * C * 16;
  if (stage_p) {
    // all of a round's loads in flight before its stores
    const int n = N * C * 16;
    for (int t = threadIdx.x; t < n; t += S4F_COPY * S4_THREADS) {
      scalar_t v[S4F_COPY];
#pragma unroll
      for (int u = 0; u < S4F_COPY; ++u)
        v[u] = __ldg(pm + min(t + u * S4_THREADS, n - 1));
#pragma unroll
      for (int u = 0; u < S4F_COPY; ++u)
        if (t + u * S4_THREADS < n) Ps[t + u * S4_THREADS] = v[u];
    }
  }
  __syncthreads();

  const int t0 = threadIdx.x;
  const int r = t0 & ((1 << node_log2) - 1);
  const int lane_g = r & ((1 << g_log2) - 1);  // s + 4 c
  const int s = r & 3, c = lane_g >> 2, jp = r >> g_log2;
  const bool cin = c < C;
  const int p = p0 + jp;
  const bool valid = p < P;
  const S4Forward<scalar_t, Stage> w{tips,
                                     stage_p ? Ps : pm,
                                     partials + (size_t)l * I * C * 4 * P,
                                     scale + (size_t)l * I * P,
                                     hand ? hsh : nullptr,
                                     tb,
                                     T,
                                     C,
                                     P,
                                     cin ? c : C - 1,
                                     s,
                                     valid ? p : P - 1,
                                     t0 & 28,
                                     r,
                                     node_log2,
                                     stage};
  const scalar_t tiny = Limits<scalar_t>::tiny();
  const int d0 = stage.start();
  // the first walked position of `order`: a walked node's hand-off slot is
  // its position less this one
  const int j0 = Stage::whole ? 0 : tb.offsets[d0];

  // the rest of node k's step (at position j) from the product over its
  // children: the max over the lane group (0 in padded lanes), the rescaled
  // partials and the scaler (m, or log m for the stage), into the hand-off
  // and the outputs
  auto finish = [&](int k, int j, scalar_t res) {
    res = cin ? res : scalar_t(0);
    scalar_t m = res;
    for (int off = 1; off < (1 << g_log2); off <<= 1) {
      const scalar_t o = __shfl_xor_sync(S4_FULL, m, off);
      m = o > m ? o : m;
    }
    m = rescale ? (m > tiny ? m : tiny) : scalar_t(1);
    const scalar_t x = res / m;
    const scalar_t sc = Stage::whole ? m : log_(m);
    const int slot = Stage::whole ? k : j - j0;
    if (hand) {
      hsh[((size_t)slot << node_log2) + r] = x;
      if (lane_g == 0) msh[((size_t)slot << pb_log2) + jp] = sc;
    }
    if (valid && cin) w.part[(((size_t)k * C + c) * 4 + s) * P + p] = x;
    if (valid && lane_g == 0) w.sc[(size_t)k * P + p] = sc;
    return x;
  };
  // a level's items, and the position of this thread's first item's node
  auto items_at = [&](int d) {
    return d < n_levels ? (tb.offsets[d + 1] - tb.offsets[d]) << node_log2
                        : 0;
  };
  auto first = [&](int d) { return tb.offsets[d] + (t0 >> node_log2); };

  const bool binary = maxc == 2;
  scalar_t x_root = 0;  // the root's rescaled partial at this lane
  int items = items_at(d0), next = items_at(d0 + 1);
  PairAhead<scalar_t> ahead{}, ahead2{};  // levels d and d + 1
  if (binary && t0 < items) {
    ahead = pair_indices(w, first(d0));
    pair_tips(w, ahead);
  }
  if (binary && t0 < next) ahead2 = pair_indices(w, first(d0 + 1));
  for (int d = d0; d < n_levels; ++d) {
    const PairAhead<scalar_t> cur = ahead;
    const int next2 = items_at(d + 2);
    // level d + 1's tips in flight during this level, level d + 2's indices
    if (binary && t0 < next) {
      ahead = ahead2;
      pair_tips(w, ahead);
    }
    if (binary && t0 < next2) ahead2 = pair_indices(w, first(d + 2));
    scalar_t x = 0;
    if (t0 < items)
      x = binary ? finish(cur.k, cur.j, pair_product(w, cur, I))
                 : finish(tb.order[first(d)], first(d),
                          generic_product(w, first(d)));
    // a wide level's further rounds (a top-of-stage walk's binary nodes
    // with both children's loads in flight at once)
    for (int t = t0 + S4_THREADS; t < items; t += S4_THREADS) {
      const int j = tb.offsets[d] + (t >> node_log2);
      if constexpr (!Stage::whole) {
        if (binary) {
          PairAhead<scalar_t> pa = pair_indices(w, j);
          pair_tips(w, pa);
          finish(pa.k, j, pair_product(w, pa, I));
          continue;
        }
      }
      finish(tb.order[j], j, generic_product(w, j));
    }
    x_root = x;  // the last level holds the root alone
    items = next;
    next = next2;
    __syncthreads();
  }

  // the root's site over (C, 4): a butterfly over its lane group, the same
  // bits in every lane
  if (t0 < (1 << node_log2)) {
    scalar_t v = cin ? rootw(l, w.cc, s, C) * x_root : scalar_t(0);
    for (int off = 1; off < (1 << g_log2); off <<= 1)
      v += __shfl_xor_sync(S4_FULL, v, off);
    if (lane_g == 0) site_sh[jp] = v;
  }
  __syncthreads();
  // sum_k log m_k: R lanes a pattern (one warp or less), each every R-th
  // rank in rank order, then a butterfly over the R lanes
  const int r_log2 = min(5, 8 - pb_log2);
  const int jq = t0 >> r_log2, rr = t0 & ((1 << r_log2) - 1);
  if (jq < (1 << pb_log2)) {
    const int q = p0 + jq;
    const int qc = q < P ? q : P - 1;
    scalar_t acc = 0;
    if constexpr (Stage::whole) {
      if (rescale)
        for (int k = rr; k < I; k += 1 << r_log2)
          acc += log_(hand ? msh[((size_t)k << pb_log2) + jq]
                           : w.sc[(size_t)k * P + qc]);
    } else {
      // log m of the walked ranks from the hand-off's scalers, of the
      // stage's from its rows: S4F_SUM_LOADS loads in flight, then their
      // sum in rank order
      for (int k0 = rr; k0 < I; k0 += S4F_SUM_LOADS << r_log2) {
        scalar_t v[S4F_SUM_LOADS];
#pragma unroll
        for (int u = 0; u < S4F_SUM_LOADS; ++u) {
          const int k = min(k0 + (u << r_log2), I - 1);
          const int sl = hand ? stage.slot(k) : -1;
          v[u] = *(sl >= 0 ? msh + ((size_t)sl << pb_log2) + jq
                           : w.sc + (size_t)k * P + qc);
        }
#pragma unroll
        for (int u = 0; u < S4F_SUM_LOADS; ++u)
          if (k0 + (u << r_log2) < I) acc += v[u];
      }
    }
    for (int off = 1; off < (1 << r_log2); off <<= 1)
      acc += __shfl_xor_sync(S4_FULL, acc, off);
    if (rr == 0 && q < P) {
      const scalar_t site = site_sh[jq];
      site_log[(size_t)l * P + q] = log_(site > tiny ? site : tiny) + acc;
    }
  }
}

// The walk's blocks an SM at `smem` bytes of shared memory on device `dev`,
// from the last 16 sizes asked for there (by occupancy query otherwise)
template <typename Kernel>
cudaError_t s4_blocks_per_sm(Kernel kernel, int dev, size_t smem,
                             size_t (&sizes)[64][16], int (&blocks)[64][16],
                             int& n, int* out) {
  for (int i = 0; i < 16; ++i)
    if (blocks[dev][i] > 0 && sizes[dev][i] == smem) {
      *out = blocks[dev][i];
      return cudaSuccess;
    }
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, S4_THREADS, smem);
  if (e != cudaSuccess) return e;
  sizes[dev][n % 16] = smem;
  blocks[dev][n % 16] = *out > 0 ? *out : -1;
  ++n;
  return cudaSuccess;
}

// One launch on `stream`. Patterns a block: the fewest (at least 32 lanes
// a node, at most S4_THREADS) at which the whole grid is resident at once
// on this card. Shared memory: the index tables where they take at most
// S4_TABLE_SMEM, this chain's P matrices where they take at most
// S4F_P_SMEM (a top-of-stage walk: unless fewer blocks an SM fit with
// them where no size is resident),
// the root's sites and, where the grid stays resident with them at that
// block size, the hand-off and the scalers of the `walked` nodes (all I
// for a whole tree; a larger block would take a wide level in more
// rounds). The walk's occupancy at each size is kept for the next calls.
template <typename scalar_t, typename Root, typename Stage = WholeTree>
cudaError_t launch_s4_forward(const scalar_t* tips, const scalar_t* pmats,
                              const int* children, const int* order,
                              const int* offsets, int n_levels, Root rootw,
                              scalar_t* partials, scalar_t* scale,
                              scalar_t* site_log, int T, int I, int C,
                              int maxc, int P, int L, int rescale,
                              cudaStream_t stream, Stage stage = Stage{},
                              int walked = -1) {
  if (walked < 0) walked = I;
  if (C < 1 || C > MAX_C || L < 1 || L > 65535 || I < 1 || maxc < 1 ||
      n_levels < 1 || n_levels > I || P < 1 || walked < 1 || walked > I)
    return cudaErrorInvalidValue;
  const auto kernel = s4_forward_kernel<scalar_t, Root, Stage>;
  static int sms[64] = {0};  // by device, with the smem limit set
  static size_t occ_sizes[64][16];
  static int occ_blocks[64][16];
  static int occ_n[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  constexpr size_t max_smem = 227 * 1024;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  const size_t table_bytes = s4_walk_table_bytes<Stage>(n_levels, I, maxc);
  const bool tables = table_bytes <= S4_TABLE_SMEM;
  const size_t p_bytes = (size_t)(T + I) * C * 16 * sizeof(scalar_t);
  bool stage_p = p_bytes <= S4F_P_SMEM;
  auto base_bytes = [&]() {
    return (tables ? (table_bytes + 15) / 16 * 16 : 0) +
           S4F_MAX_PB * sizeof(scalar_t) + (stage_p ? p_bytes : 0);
  };
  size_t base = base_bytes();
  int cg_log2 = 0;
  while ((1 << cg_log2) < C) ++cg_log2;
  const int g_log2 = cg_log2 + 2;
  const int lg_min = g_log2 < 5 ? 5 - g_log2 : 0, lg_max = 8 - g_log2;
  // whether the grid at 2^g patterns a block is resident at `bytes`
  auto resident = [&](int g, size_t bytes, bool& yes) -> cudaError_t {
    yes = false;
    if (bytes > max_smem) return cudaSuccess;
    int blocks = 0;
    const cudaError_t err = s4_blocks_per_sm(
        kernel, dev, bytes, occ_sizes, occ_blocks, occ_n[dev], &blocks);
    yes = blocks > 0 &&
          (long)((P + (1 << g) - 1) >> g) * L <= (long)sms[dev] * blocks;
    return err;
  };
  // the fewest patterns a block at which the grid is resident at `bytes`
  // (lg_max if none)
  int lg = lg_min;
  bool fits = false;
  auto smallest = [&](size_t bytes) -> cudaError_t {
    for (lg = lg_min;; ++lg) {
      const cudaError_t err = resident(lg, bytes, fits);
      if (err != cudaSuccess || fits || lg == lg_max) return err;
    }
  };
  if ((e = smallest(base)) != cudaSuccess) return e;
  if (!Stage::whole && stage_p && !fits) {
    // no size is resident: the P matrices stay in shared memory unless
    // fewer blocks an SM fit with them
    int with_p = 0, without = 0;
    e = s4_blocks_per_sm(kernel, dev, base, occ_sizes, occ_blocks, occ_n[dev],
                         &with_p);
    if (e != cudaSuccess) return e;
    e = s4_blocks_per_sm(kernel, dev, base - p_bytes, occ_sizes, occ_blocks,
                         occ_n[dev], &without);
    if (e != cudaSuccess) return e;
    if (without > with_p) {
      stage_p = false;
      base = base_bytes();
      if ((e = smallest(base)) != cudaSuccess) return e;
    }
  }
  // the hand-off where the grid stays resident with it at that size
  const size_t with_hand =
      base + (size_t)walked *
                 (((size_t)1 << (lg + g_log2)) + ((size_t)1 << lg)) *
                 sizeof(scalar_t);
  bool hand = false;
  if ((e = resident(lg, with_hand, hand)) != cudaSuccess) return e;
  const size_t smem = hand ? with_hand : base;
  const dim3 grid((P + (1 << lg) - 1) >> lg, L);
  kernel<<<grid, S4_THREADS, smem, stream>>>(
      tips, pmats, children, order, offsets, n_levels, rootw, stage,
      partials, scale, site_log, T, I, C, cg_log2, maxc, P, lg, rescale,
      tables, hand ? 1 : 0, stage_p ? 1 : 0, walked);
  return cudaGetLastError();
}

}  // namespace
