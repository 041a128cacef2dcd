// The reverse pruning sweep at S = 4 for Hopper (sm_90a), shared by K6' at
// S = 4 (csrc/loop.cu, a batch of L chains) and K2' (csrc/pruning.cu, one
// chain): d pmats and d rootw (rootw[c, s] = props_c freqs_s) from the
// forward's rescaled partials and scalers.
//
// Layouts (pattern axis innermost):
//   tips      [T, 4, P]          shared by every chain
//   pmats     [L, N, C, 4, 4]    P matrix of the branch above each node
//   children  [I, maxc]          int32 child ids, -1 for a missing child
//   order     [I]                internal ranks by preorder level, root first
//   offsets   [levels + 1]       the levels' bounds in `order`
//   partials  [L, I, C, 4, P]    rescaled partials of internal node rank k
//   scale     [L, I, P]          per-node max m over (C, 4); 1 unrescaled
//   g         [L, P]             cotangent of the site log-likelihoods
//   gbuf      [L, I, C, 4, P]    scratch: cotangent of each node's partials
//   inv       [L, P]             scratch: g / site
//   dP_part   [L, nq, N, C, 16]  per-chunk sums (nq chunks of DP_CHUNK
//                                patterns); the caller sums over nq
// and the root weights' cotangent, a row a chunk (RootWeights, FreqsProps).
// Internal node k has id T + k; ids are postorder ranks, the root is N - 1.
//
// What bounds it: the function moves a few MB and does a few MFLOPs at MCMC
// and ML sizes (fluA, 238 patterns: bounds of 0.2 us), so the time is the
// latency of the dependent chain from the root to the leaves. The first
// design (one thread a pattern walking every node in reverse postorder,
// recomputing siblings' products for each child and reducing the 16 dP
// entries of each child and category by warp shuffles and two barriers a
// node) put the dP reductions on that chain and ran 1350-1750x above the
// bound. This design splits the sweep in two launches:
// - The walk (s4_walk_kernel) carries only the cotangents: for each node k,
//   category c and pattern, graw = gbuf[k] / m_k, other_i = graw x prod over
//   siblings j of P_j x_j, and gbuf[child_i] = P_i^T other_i. It walks the
//   tree by preorder level (33 levels against 68 nodes on the fluA tree),
//   one barrier a level; a level's nodes are spread over the warps of a
//   block. Threads sit on (pattern, state): the four lanes of a quad hold
//   one pattern's states, compute their rows of P_j x_j and trade the
//   entries of other_i by shuffles for the product with P_i^T. The grid is
//   (pattern blocks, C, L): the categories and chains share nothing here.
//   A block takes 8 to 64 patterns, the fewest that let the whole grid be
//   resident at once. Only gbuf[k] depends on the walk. The rest of a
//   binary node's step (the children's partials at the thread's pattern,
//   the node's scale) is copied by cp.async into shared memory two levels
//   ahead, and the chain's P matrices and the index tables sit in shared
//   memory, so that a level costs the hand-off of gbuf[k] through L1, the
//   step's arithmetic, a few shuffles and a barrier. Two things shaped
//   this (chip_profile.py --s4-trace): loads behind per-load branches are
//   issued one after another, and a barrier waits for its threads'
//   outstanding loads, so a level that loads its next level's inputs in
//   registers still waits for them; copies by cp.async are not waited for.
// - The dP pass (s4_dp_kernel) computes for every branch at once
//   dP[child_i, c] = sum_p other_i (x) x_i, which depends only on the
//   parent's gbuf and scale and the children's partials: grid (pattern
//   chunks x C, internal node, L), one block a parent, which forms its
//   children's products once, recomputes other_i and sums each dP entry
//   over its chunk in a fixed order (a thread's patterns in turn, then a
//   butterfly over each warp, then the warps in order), with no atomics.
//   One more block a chunk sums d rootw[c, s] = sum_p x_root[c, s] / site
//   for every category at once, so that K6' writes d freqs and d props
//   itself; the root's blocks write its own dP row (it is no node's child)
//   as zeros. No per-branch `other` buffer is kept: the scratch is gbuf,
//   1 / site and nq x N x C x 16 dP scalars a chain (nq = 1 up to DP_CHUNK
//   patterns).

#pragma once

#include <cuda_runtime.h>

#include "s4_common.cuh"
#include "tiles.cuh"

namespace {

// patterns a walk block takes: 2^3 to 2^6
constexpr int S4_MIN_PB_LOG2 = 3, S4_MAX_PB_LOG2 = 6;
// the scalars a thread copies for one binary step: its children's partials
// at its pattern and the node's scale
constexpr int S4_STAGE = 9;
// patterns a dP block sums: 8 a thread. The caller sizes the dP scratch by
// it and passes it to launch_s4_backward, which checks it.
constexpr int S4_DP_CHUNK = 8 * S4_THREADS;

// One chain's inputs; partials are read-only in both launches
template <typename scalar_t> struct S4Chain {
  const scalar_t* __restrict__ tips;  // [T, 4, P]
  const scalar_t* __restrict__ pm;    // [N, C, 4, 4]
  const scalar_t* __restrict__ part;  // [I, C, 4, P]
  int T, C, P;

  // child `ch`'s partials in category c at pattern p, state b at [b P]:
  // one address for tips and internal nodes alike
  __device__ const scalar_t* xs(int ch, int c, int p) const {
    return (ch < T ? tips + (size_t)ch * 4 * P
                   : part + ((size_t)(ch - T) * C + c) * 4 * P) +
           p;
  }
  __device__ scalar_t x(int ch, int c, int b, int p) const {
    return __ldg(xs(ch, c, p) + (size_t)b * P);
  }
  __device__ const scalar_t* pmat(int ch, int c) const {
    return pm + ((size_t)ch * C + c) * 16;
  }
  // (P_ch x_ch)[s] at pattern p, which lies in [0, P)
  __device__ scalar_t row_product(int ch, int c, int s, int p) const {
    const scalar_t* q = pmat(ch, c) + s * 4;
    const scalar_t* xp = xs(ch, c, p);
    scalar_t y = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) y += __ldg(q + b) * __ldg(xp + (size_t)b * P);
    return y;
  }
};

// gbuf[child, c, s, p] = sum_a P_child[c, a, s] other[a], with col[a] =
// P_child[c, a, s]: the four lanes of this thread's quad (q0 its first)
// hold other[0..3]. Every lane of the warp calls it.
template <typename scalar_t>
__device__ inline void store_cotangent(const S4Chain<scalar_t>& ch,
                                       scalar_t* gb, int child, int c, int s,
                                       int p, bool valid, int q0,
                                       const scalar_t (&col)[4],
                                       scalar_t other) {
  scalar_t v = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    v += col[a] * __shfl_sync(S4_FULL, other, q0 | a);
  if (valid)
    gb[(((size_t)(child - ch.T) * ch.C + c) * 4 + s) * ch.P + p] = v;
}

// The cotangents of node k's internal children at (c, s, p), from graw =
// gbuf[k] / m_k at this lane's state, for any number of children: each
// internal child's siblings' products again. Uniform over a warp.
template <typename scalar_t>
__device__ inline void node_cotangents(const S4Chain<scalar_t>& ch,
                                       const WalkTables& tb, int j,
                                       scalar_t* gb, int c, int s, int p,
                                       int pc, bool valid, int q0,
                                       scalar_t graw) {
  for (int i = 0; i < tb.maxc; ++i) {
    const int ci = tb.kid(j, i);
    if (ci < ch.T) continue;  // a tip or a missing child takes no cotangent
    scalar_t other = graw;
    for (int jj = 0; jj < tb.maxc; ++jj) {
      const int cj = tb.kid(j, jj);
      if (jj != i && cj >= 0) other *= ch.row_product(cj, c, s, pc);
    }
    const scalar_t* q = ch.pmat(ci, c) + s;
    scalar_t col[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) col[a] = __ldg(q + a * 4);
    store_cotangent(ch, gb, ci, c, s, p, valid, q0, col, other);
  }
}

// All of a binary node's step at this thread's (c, s, p) but the parent's
// cotangent: the children, (P_j x_j)[s] of each, column s of each child's
// P and the parent's scale. Nothing here depends on the walk, so the walk
// loads it ahead. Its 21 loads carry no conditions (pattern pc in [0, P)
// for p, node 0 for a missing child), so that they are all in flight at
// once.
template <typename scalar_t> struct PairStep {
  int k, c0, c1;
  scalar_t m, y0, y1, col0[4], col1[4];
};

// What a PairStep is made of, as loaded: rows s of the children's P and
// their partials at pc, not yet multiplied
template <typename scalar_t> struct PairLoads {
  int k, c0, c1;
  scalar_t m, r0[4], r1[4], v0[4], v1[4], col0[4], col1[4];
};

template <typename scalar_t>
__device__ inline PairLoads<scalar_t> pair_loads(const S4Chain<scalar_t>& ch,
                                                 const WalkTables& tb, int j,
                                                 const scalar_t* sc, int c,
                                                 int s, int pc) {
  PairLoads<scalar_t> ld;
  ld.k = tb.order[j];
  ld.c0 = tb.kid(j, 0);
  ld.c1 = tb.kid(j, 1);
  const int a0 = ld.c0 >= 0 ? ld.c0 : 0, a1 = ld.c1 >= 0 ? ld.c1 : 0;
  const scalar_t *q0 = ch.pmat(a0, c), *q1 = ch.pmat(a1, c);
  const scalar_t *x0 = ch.xs(a0, c, pc), *x1 = ch.xs(a1, c, pc);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    ld.r0[b] = __ldg(q0 + s * 4 + b);
    ld.r1[b] = __ldg(q1 + s * 4 + b);
    ld.v0[b] = __ldg(x0 + (size_t)b * ch.P);
    ld.v1[b] = __ldg(x1 + (size_t)b * ch.P);
    ld.col0[b] = __ldg(q0 + b * 4 + s);
    ld.col1[b] = __ldg(q1 + b * 4 + s);
  }
  ld.m = __ldg(sc + (size_t)ld.k * ch.P + pc);
  return ld;
}

template <typename scalar_t>
__device__ inline PairStep<scalar_t> pair_finish(
    const PairLoads<scalar_t>& ld) {
  PairStep<scalar_t> st;
  st.k = ld.k;
  st.c0 = ld.c0;
  st.c1 = ld.c1;
  st.m = ld.m;
  scalar_t y0 = 0, y1 = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    y0 += ld.r0[b] * ld.v0[b];
    y1 += ld.r1[b] * ld.v1[b];
    st.col0[b] = ld.col0[b];
    st.col1[b] = ld.col1[b];
  }
  // a missing child contributes 1
  st.y0 = ld.c0 >= 0 ? y0 : scalar_t(1);
  st.y1 = ld.c1 >= 0 ? y1 : scalar_t(1);
  return st;
}

template <typename scalar_t>
__device__ inline PairStep<scalar_t> pair_step(const S4Chain<scalar_t>& ch,
                                               const WalkTables& tb, int j,
                                               const scalar_t* sc, int c,
                                               int s, int pc) {
  return pair_finish(pair_loads(ch, tb, j, sc, c, s, pc));
}

// Copies this thread's stage for the node at position j of `order` into
// `st` (its slots S4_THREADS apart) by cp.async: the children's partials
// at pc (node 0's for a missing child) and the node's scale.
template <typename scalar_t>
__device__ inline void stage_pair(const S4Chain<scalar_t>& ch,
                                  const WalkTables& tb, int j,
                                  const scalar_t* sc, int c, int pc,
                                  scalar_t* st) {
  const int c0 = tb.kid(j, 0), c1 = tb.kid(j, 1);
  const scalar_t* x0 = ch.xs(c0 >= 0 ? c0 : 0, c, pc);
  const scalar_t* x1 = ch.xs(c1 >= 0 ? c1 : 0, c, pc);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    copy_async(st + b * S4_THREADS, x0 + (size_t)b * ch.P, true);
    copy_async(st + (4 + b) * S4_THREADS, x1 + (size_t)b * ch.P, true);
  }
  copy_async(st + 8 * S4_THREADS, sc + (size_t)tb.order[j] * ch.P + pc,
             true);
}

// The step of the node at position j from its copied stage `st` and the
// P matrices at pt (node n's at pt + n pstride)
template <typename scalar_t>
__device__ inline PairStep<scalar_t> staged_pair(const WalkTables& tb, int j,
                                                 const scalar_t* pt,
                                                 int pstride, int s,
                                                 const scalar_t* st) {
  PairLoads<scalar_t> ld;
  ld.k = tb.order[j];
  ld.c0 = tb.kid(j, 0);
  ld.c1 = tb.kid(j, 1);
  const scalar_t* q0 = pt + (size_t)(ld.c0 >= 0 ? ld.c0 : 0) * pstride;
  const scalar_t* q1 = pt + (size_t)(ld.c1 >= 0 ? ld.c1 : 0) * pstride;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    ld.r0[b] = q0[s * 4 + b];
    ld.r1[b] = q1[s * 4 + b];
    ld.col0[b] = q0[b * 4 + s];
    ld.col1[b] = q1[b * 4 + s];
    ld.v0[b] = st[b * S4_THREADS];
    ld.v1[b] = st[(4 + b) * S4_THREADS];
  }
  ld.m = st[8 * S4_THREADS];
  return pair_finish(ld);
}

// The rest of the step once the parent's cotangent gk is known: other_0 =
// graw y_1 and other_1 = graw y_0, and each internal child's P^T other.
template <typename scalar_t>
__device__ inline void pair_cotangents(const S4Chain<scalar_t>& ch,
                                       const PairStep<scalar_t>& st,
                                       scalar_t gk, scalar_t* gb, int c,
                                       int s, int p, bool valid, int q0) {
  // cotangent of the raw (pre-rescale) product; the max is a constant
  const scalar_t graw = valid ? gk / st.m : scalar_t(0);
  if (st.c0 >= ch.T)
    store_cotangent(ch, gb, st.c0, c, s, p, valid, q0, st.col0,
                    graw * st.y1);
  if (st.c1 >= ch.T)
    store_cotangent(ch, gb, st.c1, c, s, p, valid, q0, st.col1,
                    graw * st.y0);
}

// The walk: grid (ceil(P / 2^pb_log2), C, L), S4_THREADS threads; item t of
// a level is the node at position t / (4 PB) of the level, pattern
// p0 + (t % 4 PB) / 4, state t % 4, so a thread keeps its pattern and state
// at every level (4 PB divides S4_THREADS). At a binary node (maxc = 2) a
// thread's first item of a level is copied into shared memory by cp.async
// two levels ahead; a level of more than S4_THREADS / (4 PB) nodes takes
// further rounds, loaded in turn. `tables` ints of dynamic shared
// memory hold the index tables (none: they stay in device memory).
template <typename scalar_t, typename Root>
__global__ void __launch_bounds__(S4_THREADS)
    s4_walk_kernel(const scalar_t* __restrict__ tips,
                   const scalar_t* __restrict__ pmats,
                   const int* __restrict__ children,
                   const int* __restrict__ order,
                   const int* __restrict__ offsets, int n_levels, Root rootw,
                   const scalar_t* __restrict__ partials,
                   const scalar_t* __restrict__ scale,
                   const scalar_t* __restrict__ g, scalar_t* gbuf,
                   scalar_t* __restrict__ inv, int T, int I, int C, int maxc,
                   int P, int pb_log2, int tables, int stage_p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* tab = reinterpret_cast<int*>(smem_raw);
  const int c = blockIdx.y, l = blockIdx.z;
  const int p0 = blockIdx.x << pb_log2;
  const int node_log2 = pb_log2 + 2;  // items a node: 4 states a pattern
  const int N = T + I;
  const S4Chain<scalar_t> ch{tips, pmats + (size_t)l * N * C * 16,
                             partials + (size_t)l * I * C * 4 * P, T, C, P};
  const scalar_t* sc = scale + (size_t)l * I * P;
  scalar_t* gb = gbuf + (size_t)l * I * C * 4 * P;
  const WalkTables tb = walk_tables(offsets, order, children, n_levels, I,
                                    maxc, tables, tab);
  // this chain's P matrices of category c in shared memory, rows of 16
  // (stage_p), else in device memory; then the threads' stages
  scalar_t* Ps = reinterpret_cast<scalar_t*>(
      smem_raw + ((size_t)(tables ? n_levels + 1 + I * (1 + maxc) : 0) *
                      sizeof(int) + 15) / 16 * 16);
  const scalar_t* pt = ch.pm + c * 16;
  int pstride = C * 16;
  if (stage_p) {
    for (int t = threadIdx.x; t < N * 16; t += S4_THREADS)
      Ps[t] = __ldg(ch.pm + ((size_t)(t >> 4) * C + c) * 16 + (t & 15));
    pt = Ps;
    pstride = 16;
  }
  scalar_t* stages = Ps + (stage_p ? (size_t)N * 16 : 0);
  __syncthreads();
  const int t0 = threadIdx.x;
  const int r = t0 & ((1 << node_log2) - 1);
  const int s = r & 3, p = p0 + (r >> 2);
  const bool valid = p < P;
  const int pc = valid ? p : P - 1;  // where a lane past P loads
  const int q0 = t0 & 28;  // the quad's first lane
  const scalar_t tiny = Limits<scalar_t>::tiny();
  auto at = [&](int k) { return (((size_t)k * C + c) * 4 + s) * P + p; };

  // the root's seed (level 0 holds the root alone): site over every
  // category (the quad's four states summed by a butterfly, the same bits
  // in each lane), in scaled coordinates as the forward had it
  auto seed = [&]() {
    scalar_t v = 0;
#pragma unroll
    for (int cc = 0; cc < MAX_C; ++cc) {
      const int ci = cc < C ? cc : C - 1;
      const scalar_t term = rootw(l, ci, s, C) * ch.x(N - 1, ci, s, pc);
      v += cc < C ? term : scalar_t(0);
    }
    v += __shfl_xor_sync(S4_FULL, v, 1);
    v += __shfl_xor_sync(S4_FULL, v, 2);
    const scalar_t iv =
        valid ? g[(size_t)l * P + p] / (v > tiny ? v : tiny) : scalar_t(0);
    const scalar_t gk = rootw(l, c, s, C) * iv;
    if (valid) {
      gb[at(I - 1)] = gk;
      if (c == 0 && s == 0) inv[(size_t)l * P + p] = iv;
    }
    return gk;
  };

  if (maxc != 2) {
    for (int d = 0; d < n_levels; ++d) {
      const int lo = tb.offsets[d];
      const int items = (tb.offsets[d + 1] - lo) << node_log2;
      for (int t = t0; t < items; t += S4_THREADS) {
        const int j = lo + (t >> node_log2), k = tb.order[j];
        const scalar_t gk = d == 0 ? seed() : valid ? gb[at(k)] : scalar_t(0);
        const scalar_t m = __ldg(sc + (size_t)k * P + pc);
        node_cotangents(ch, tb, j, gb, c, s, p, pc, valid, q0,
                        valid ? gk / m : scalar_t(0));
      }
      __syncthreads();
    }
    return;
  }

  // a level's items, and the position of this thread's first item's node
  auto items_at = [&](int d) {
    return d < n_levels ? (tb.offsets[d + 1] - tb.offsets[d]) << node_log2
                        : 0;
  };
  auto first = [&](int d) { return tb.offsets[d] + (t0 >> node_log2); };
  // this thread's stage of level d: three in turn
  auto stage_of = [&](int d) {
    return stages + (size_t)(d % 3) * S4_STAGE * S4_THREADS + t0;
  };
  // level d's copies, one cp.async group whether or not there are any
  auto stage = [&](int d) {
    if (t0 < items_at(d))
      stage_pair(ch, tb, first(d), sc, c, pc, stage_of(d));
    __pipeline_commit();
  };
  int items = items_at(0);
  stage(0);
  stage(1);
  for (int d = 0; d < n_levels; ++d) {
    __pipeline_wait_prior(1);  // every group but level d + 1's has landed
    PairStep<scalar_t> cur{};
    if (t0 < items) cur = staged_pair(tb, first(d), pt, pstride, s,
                                      stage_of(d));
    scalar_t gk = 0;
    if (t0 < items) gk = d == 0 ? seed() : valid ? gb[at(cur.k)] : scalar_t(0);
    stage(d + 2);  // in flight across the barriers
    if (t0 < items) pair_cotangents(ch, cur, gk, gb, c, s, p, valid, q0);
    // a wide level's further rounds
    for (int t = t0 + S4_THREADS; t < items; t += S4_THREADS) {
      const PairStep<scalar_t> st = pair_step(
          ch, tb, tb.offsets[d] + (t >> node_log2), sc, c, s, pc);
      pair_cotangents(ch, st, valid ? gb[at(st.k)] : scalar_t(0), gb, c, s,
                      p, valid, q0);
    }
    items = items_at(d + 1);
    __syncthreads();
  }
}

// Sums v[0 .. NV) over the block in a fixed order: each warp's lanes by a
// butterfly, then the warps in order through `red` (up to S4_WARPS x NV
// scalars). Thread i < NV returns sum i.
template <typename scalar_t, int NV>
__device__ inline scalar_t block_sums(const scalar_t (&v)[NV],
                                      scalar_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    scalar_t x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(S4_FULL, x, off);
    if (lane == 0) red[warp * NV + i] = x;
  }
  __syncthreads();
  scalar_t sum = 0;
  if (threadIdx.x < NV)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
      sum += red[w * NV + threadIdx.x];
  __syncthreads();  // red is free again
  return sum;
}

// (P x)[a] for a in 0..3, P [4][4] row-major
template <typename scalar_t>
__device__ inline void product4(const scalar_t* q, const scalar_t x[4],
                                scalar_t y[4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    scalar_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) v += q[a * 4 + b] * x[b];
    y[a] = v;
  }
}

template <typename scalar_t>
__device__ inline void load4(const S4Chain<scalar_t>& ch, int child, int c,
                             int p, scalar_t x[4]) {
  const scalar_t* xp = ch.xs(child, c, p);
#pragma unroll
  for (int b = 0; b < 4; ++b) x[b] = __ldg(xp + (size_t)b * ch.P);
}

// The dP pass: grid (nq x C, I + 1, L), 64 to S4_THREADS threads (a
// multiple of 32); block (q, c) of parent k sums its children's dP rows
// over patterns [q DP_CHUNK, (q + 1) DP_CHUNK), and block (q, 0) of row I
// the chunk's d rootw.
template <typename scalar_t, typename Root>
__global__ void __launch_bounds__(S4_THREADS)
    s4_dp_kernel(const scalar_t* __restrict__ tips,
                 const scalar_t* __restrict__ pmats,
                 const int* __restrict__ children,
                 const scalar_t* __restrict__ partials,
                 const scalar_t* __restrict__ scale,
                 const scalar_t* __restrict__ gbuf,
                 const scalar_t* __restrict__ inv,
                 scalar_t* __restrict__ dP_part, Root rootw, int T, int I,
                 int C, int maxc, int P) {
  __shared__ __align__(16) unsigned char red_raw[S4_WARPS * 32 *
                                                 sizeof(double)];
  scalar_t* red = reinterpret_cast<scalar_t*>(red_raw);
  const int c = blockIdx.x % C, q = blockIdx.x / C;
  const int k = blockIdx.y, l = blockIdx.z;
  const int nq = gridDim.x / C, N = T + I;
  const int lo = q * S4_DP_CHUNK;
  const int hi = min(P, lo + S4_DP_CHUNK);
  const S4Chain<scalar_t> ch{tips, pmats + (size_t)l * N * C * 16,
                             partials + (size_t)l * I * C * 4 * P, T, C, P};
  const scalar_t* sc = scale + ((size_t)l * I + k) * P;
  const scalar_t* gk = gbuf + (((size_t)l * I + k) * C + c) * 4 * P;
  // row n of this (chain, chunk, category): dP + n * C * 16
  scalar_t* dP = dP_part + ((size_t)l * nq + q) * N * C * 16 + c * 16;
  const int* kids = children + (size_t)k * maxc;

  if (k == I) {
    // d rootw over the chunk, every category at once (one block a chunk):
    // d[c, s] = sum_p x_root[c, s] / site
    if (c != 0) return;
    const scalar_t* iv = inv + (size_t)l * P;
    scalar_t acc[4 * MAX_C];
#pragma unroll
    for (int i = 0; i < 4 * MAX_C; ++i) acc[i] = 0;
    for (int p = lo + threadIdx.x; p < hi; p += blockDim.x) {
      const scalar_t w = iv[p];
#pragma unroll
      for (int cc = 0; cc < MAX_C; ++cc) {
        // categories past C load category C - 1 and add nothing
        const int ci = cc < C ? cc : C - 1;
        const scalar_t wc = cc < C ? w : scalar_t(0);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          acc[cc * 4 + s] += ch.x(N - 1, ci, s, p) * wc;
      }
    }
    const scalar_t sum = block_sums(acc, red);
    if ((int)threadIdx.x < 4 * C) red[threadIdx.x] = sum;
    __syncthreads();
    rootw.put(red, l, q, C);
    return;
  }
  // the root is no node's child: its dP row is zero
  if (k == I - 1 && threadIdx.x < 16)
    dP[(size_t)(N - 1) * C * 16 + threadIdx.x] = 0;

  if (maxc == 2) {
    // both children in one pass: y_i = P_i x_i once, other_0 = graw y_1,
    // other_1 = graw y_0
    // a missing child (node 0's loads, contributing 1 and no dP row)
    const int c0 = __ldg(kids), c1 = __ldg(kids + 1);
    const int a0 = c0 >= 0 ? c0 : 0, a1 = c1 >= 0 ? c1 : 0;
    scalar_t P0[16], P1[16], acc[32];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      P0[i] = __ldg(ch.pmat(a0, c) + i);
      P1[i] = __ldg(ch.pmat(a1, c) + i);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0;
    for (int p = lo + threadIdx.x; p < hi; p += blockDim.x) {
      const scalar_t m = sc[p];
      scalar_t graw[4], x0[4], x1[4], y0[4], y1[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) graw[a] = gk[(size_t)a * P + p] / m;
      load4(ch, a0, c, p, x0);
      load4(ch, a1, c, p, x1);
      product4(P0, x0, y0);
      product4(P1, x1, y1);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        y0[a] = c0 >= 0 ? y0[a] : scalar_t(1);
        y1[a] = c1 >= 0 ? y1[a] : scalar_t(1);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const scalar_t o0 = graw[a] * y1[a], o1 = graw[a] * y0[a];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a * 4 + b] += o0 * x0[b];
          acc[16 + a * 4 + b] += o1 * x1[b];
        }
      }
    }
    const scalar_t sum = block_sums(acc, red);
    const int t = threadIdx.x;
    if (t < 16 && c0 >= 0) dP[(size_t)c0 * C * 16 + t] = sum;
    if (t >= 16 && t < 32 && c1 >= 0) dP[(size_t)c1 * C * 16 + t - 16] = sum;
    return;
  }

  // a polytomy: one pass a child, the siblings' products again
  for (int i = 0; i < maxc; ++i) {
    const int ci = __ldg(kids + i);
    if (ci < 0) continue;  // no d pmats row for a missing child
    scalar_t acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0;
    for (int p = lo + threadIdx.x; p < hi; p += blockDim.x) {
      const scalar_t m = sc[p];
      scalar_t other[4], x[4], y[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) other[a] = gk[(size_t)a * P + p] / m;
      for (int j = 0; j < maxc; ++j) {
        const int cj = __ldg(kids + j);
        if (j == i || cj < 0) continue;
        load4(ch, cj, c, p, x);
        scalar_t Pj[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) Pj[e] = __ldg(ch.pmat(cj, c) + e);
        product4(Pj, x, y);
#pragma unroll
        for (int a = 0; a < 4; ++a) other[a] *= y[a];
      }
      load4(ch, ci, c, p, x);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a * 4 + b] += other[a] * x[b];
    }
    const scalar_t sum = block_sums(acc, red);
    if (threadIdx.x < 16) dP[(size_t)ci * C * 16 + threadIdx.x] = sum;
  }
}

// Both launches on `stream`; dp_chunk is the caller's S4_DP_CHUNK, by which
// it sized dP_part and the d rootw rows. The walk's shared memory: the
// index tables where they take at most 48 KB, this chain's P matrices where
// they take at most 96 KB, and the threads' stages (the walk's occupancy at
// that size is kept for the next call). Its patterns a block: the fewest (8
// to 64) at which the whole grid is resident at once on this card (a wider
// block takes a wide level in more rounds, which are not staged, but fewer
// waves). The dP pass: a thread for every 4 patterns of a chunk, 64 to
// S4_THREADS.
template <typename scalar_t, typename Root>
cudaError_t launch_s4_backward(
    const scalar_t* tips, const scalar_t* pmats, const int* children,
    const int* order, const int* offsets, int n_levels, Root rootw,
    const scalar_t* partials, const scalar_t* scale, const scalar_t* g,
    scalar_t* gbuf, scalar_t* inv, scalar_t* dP_part, int T, int I, int C,
    int maxc, int P, int L, int dp_chunk, cudaStream_t stream) {
  if (C < 1 || C > MAX_C || L < 1 || L > 65535 || I < 1 || I >= 65535 ||
      maxc < 1 || n_levels < 1 || P < 1 || dp_chunk != S4_DP_CHUNK)
    return cudaErrorInvalidValue;
  const auto walk_kernel = s4_walk_kernel<scalar_t, Root>;
  static int sms[64] = {0};  // by device, with the walk's smem limit set
  // by device: the walk's blocks an SM at the shared memory last asked for
  static size_t occ_smem[64];
  static int occ_blocks[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  const size_t table_bytes = s4_table_bytes(n_levels, I, maxc);
  const bool tables = table_bytes <= S4_TABLE_SMEM;
  const size_t p_bytes = (size_t)(T + I) * 16 * sizeof(scalar_t);
  const bool stage_p = p_bytes <= 96 * 1024;
  const size_t smem = (tables ? (table_bytes + 15) / 16 * 16 : 0) +
                      (stage_p ? p_bytes : 0) +
                      3 * S4_STAGE * S4_THREADS * sizeof(scalar_t);
  if (occ_blocks[dev] == 0 || occ_smem[dev] != smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ_blocks[dev], walk_kernel, S4_THREADS, smem);
    if (e != cudaSuccess) {
      occ_blocks[dev] = 0;
      return e;
    }
    occ_smem[dev] = smem;
  }
  const long resident = (long)sms[dev] * occ_blocks[dev];
  int lg = S4_MIN_PB_LOG2;
  while (lg < S4_MAX_PB_LOG2 &&
         (long)((P + (1 << lg) - 1) >> lg) * C * L > resident)
    ++lg;
  const dim3 walk((P + (1 << lg) - 1) >> lg, C, L);
  walk_kernel<<<walk, S4_THREADS, smem, stream>>>(
      tips, pmats, children, order, offsets, n_levels, rootw, partials,
      scale, g, gbuf, inv, T, I, C, maxc, P, lg, tables, stage_p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int nq = (P + S4_DP_CHUNK - 1) / S4_DP_CHUNK;
  const int per_chunk = P < S4_DP_CHUNK ? P : S4_DP_CHUNK;
  int dp_threads = (per_chunk + 127) / 128 * 32;
  dp_threads = dp_threads < 64 ? 64 : dp_threads > S4_THREADS ? S4_THREADS
                                                               : dp_threads;
  const dim3 dp(nq * C, I + 1, L);
  s4_dp_kernel<scalar_t, Root><<<dp, dp_threads, 0, stream>>>(
      tips, pmats, children, partials, scale, gbuf, inv, dP_part, rootw, T,
      I, C, maxc, P);
  return cudaGetLastError();
}

}  // namespace
