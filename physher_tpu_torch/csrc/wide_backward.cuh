// The node step of the reverse sweep for any state count S from 2 to 64,
// shared by K6' at S != 4 (csrc/loop.cu loop_wide_backward_kernel: one block
// walks every node of one chain, backward_walk below), K2' at S != 4
// (csrc/pruning.cu: that walk, fused_wide_backward_walk, or
// fused_wide_backward_tree, where blocks claim (node or child of a node,
// pattern block, category) items of one launch) and K8'
// (csrc/wide.cu backward_level: one block takes one node, or one child of a
// node, of a level). A block of 256
// threads takes one category c of one node k for its patterns pb .. pe - 1
// (at most 128):
//   y_j = P_j @ x_j,  other_i = gbuf[k, c] / m_k * prod_{j != i} y_j
//   dP[child i, c] = sum over the block's patterns of other_i @ x_i^T
//   gbuf[child i, c] = P_i^T @ other_i   (internal children only)
// m_k is a constant of the backward (read from `scale`), and gbuf[k, c] and
// dP[ch, c] are disjoint per c, so the categories are independent blocks.
//
// What bounds it: per branch, category and pattern 6 S^2 FLOPs above an
// internal node (the child's product P x, its dP outer product, its
// cotangent P^T other) and 4 S^2 above a tip (no cotangent) against a few
// S scalars read, so the FLOPs bound the function. What the design does:
// - Each child staged once per node: at a node of at most two children, the
//   block stages both children's P and P^T once per (node, category), both
//   children's partials once per step, computes each y_j = P_j x_j once in
//   registers and forms other_i = g_raw * y_{1-i} from it (the TPU kernel's
//   order): three barriers a step. Polytomies (maxc 3 and up) take one
//   child at a time: its P^T staged once, its siblings' products recomputed
//   per step. K8' also gives one child a block where a level is too narrow
//   to fill the card.
// - Steps shaped to S: at S <= 32 the block takes its four 32-pattern tiles
//   at once (CP = 4: two warps a tile, one step a node); above, one tile a
//   step (CP = 1: eight warps a tile). A thread owns A rows a = wi + WPC i
//   (wi its warp within the tile) of its lane's pattern in the products, A
//   a template parameter (12 instantiations a type, chosen at launch from S
//   rounded up to a 16-byte vector by with_wide_tiles), so P x and P^T
//   other spend almost no FMA on padding (at S = 20 none); the dP pass
//   gives each thread rows w + 8 i (i < AD) and columns lane + 32 j (j < J)
//   of the [S, S] sum, reading X and O as 16-byte vectors along the
//   patterns and P, P^T as 16-byte broadcasts: about 0.3-0.6 shared-memory
//   wavefronts per warp FMA instruction.
// - Tiles, in shared memory: Ps, Pts [2][RA][SP] (P[ch, c] and its
//   transpose for two children, zero outside [S, S]); Xs [2][XR][TX] (the
//   children's partials); Os [2][OR][TX] (their `other`), with RA = WPC A
//   rows, SP = S rounded up to a 16-byte vector, XR = 32 J, OR = 8 AD and a
//   row stride TX = 32 CP + one vector, so that eight lanes' vectors fall in
//   distinct banks.
// - Staging by cp.async: a thread's copies of P, P^T and the tiles are all
//   in flight at once instead of waiting in turn on loads through its
//   registers. A second tile buffer, fetching the next step while this one
//   computes, gained nothing measurable on the card and is not kept.
// - Sums stay deterministic: per-thread registers over the block's patterns,
//   written to the block's own dP row, which the caller sums over blocks.
// Tensor cores wait: in float32 they take TF32, which keeps about three
// digits, and TF32 stays off in this port; keeping float32 accuracy needs a
// 3xTF32 split of each product (three mma.sync where there was one FMA
// pass), the next lever for K6' and K8'. Float64 keeps CUDA-core FMAs.

#pragma once

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

// The tiles' places in dynamic shared memory (WideTiles::smem_scalars)
template <typename scalar_t> struct WideSmem {
  scalar_t *Ps, *Pts, *Xs, *Os;
  template <int A, int CP>
  __device__ static WideSmem at(unsigned char* raw, int S) {
    using Tiles = WideTiles<scalar_t, A, CP>;
    WideSmem s;
    s.Ps = reinterpret_cast<scalar_t*>(raw);
    s.Pts = s.Ps + 2 * Tiles::RA * Tiles::sp(S);
    s.Xs = s.Pts + 2 * Tiles::RA * Tiles::sp(S);
    s.Os = s.Xs + 2 * Tiles::XR * Tiles::TX;
    return s;
  }
};

// acc[i][j] += sum_q O[w + NW i, q] X[lane + 32 j, q] over q < TQ:
// O [OR][TX], X [XR][TX]
template <typename scalar_t, int AD, int J>
__device__ inline void dp_accumulate(const scalar_t* O, const scalar_t* X,
                                     int TQ, int TX, int w, int lane,
                                     scalar_t acc[AD][J]) {
  constexpr int V = Vec<scalar_t>::n;
#pragma unroll 1
  for (int q0 = 0; q0 < TQ; q0 += V) {
    scalar_t x[J][V];
#pragma unroll
    for (int j = 0; j < J; ++j)
      Vec<scalar_t>::load(X + (lane + 32 * j) * TX + q0, x[j]);
#pragma unroll
    for (int i = 0; i < AD; ++i) {
      scalar_t o[V];
      Vec<scalar_t>::load(O + (w + NW * i) * TX + q0, o);
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[i][j] += o[v] * x[j][v];
    }
  }
}

// Zeroes the O rows that no product writes (RA to OR of both buffers), which
// the dP pass reads; before the block's first node step, whose barriers
// order it before those reads
template <typename scalar_t, int A, int CP>
__device__ inline void zero_spare_o_rows(scalar_t* Os) {
  using Tiles = WideTiles<scalar_t, A, CP>;
  constexpr int RA = Tiles::RA, OR = Tiles::OR, TX = Tiles::TX;
  for (int t = RA * TX + threadIdx.x; t < OR * TX; t += blockDim.x)
    Os[t] = Os[OR * TX + t] = 0;
}

// The node step of one block: category c, patterns pb .. pe - 1 (pe - pb a
// multiple of the step's TQ patterns, at most BWD_P, or pe = P). pair(k)
// takes a node of at most two children (maxc <= 2), polytomy(k) one of
// more, child(k, i) one child of either; k is an internal rank whose
// gbuf[k, c] an earlier step wrote (the parent's, or the root seed). Every
// argument is uniform over the block.
// pm [N, C, S, S], part and gb [I, C, S, P], sc [I, P] (one chain's); dP
// [N, C, S, S] the block's row of the per-block sums. The O rows that no
// product writes must be zero (zero_spare_o_rows).
template <typename scalar_t, int A, int CP> struct WideBackwardStep {
  using Tiles = WideTiles<scalar_t, A, CP>;
  static constexpr int WPC = Tiles::WPC, RA = Tiles::RA, AD = Tiles::AD;
  static constexpr int J = Tiles::J, XR = Tiles::XR, OR = Tiles::OR;
  static constexpr int TQ = Tiles::TQ, TX = Tiles::TX;
  const scalar_t* tips;
  const scalar_t* pm;
  const int* children;
  const scalar_t* part;
  const scalar_t* sc;
  scalar_t* gb;
  scalar_t* dP;
  scalar_t *Ps, *Pts, *Xs, *Os;
  int T, C, S, SP, SS, maxc, P, c, pb, pe;
  int lane, w, wi, col;  // col, wi: the products' pattern and row offset

  __device__ WideBackwardStep(const scalar_t* tips_, const scalar_t* pm_,
                              const int* children_, const scalar_t* part_,
                              const scalar_t* sc_, scalar_t* gb_,
                              scalar_t* dP_, const WideSmem<scalar_t>& sm,
                              int T_, int C_, int S_, int maxc_, int P_,
                              int c_, int pb_, int pe_)
      : tips(tips_), pm(pm_), children(children_), part(part_), sc(sc_),
        gb(gb_), dP(dP_), Ps(sm.Ps), Pts(sm.Pts), Xs(sm.Xs), Os(sm.Os),
        T(T_), C(C_), S(S_), SP(Tiles::sp(S_)), SS(S_ * S_), maxc(maxc_),
        P(P_), c(c_), pb(pb_), pe(pe_), lane(threadIdx.x & 31),
        w(threadIdx.x >> 5), wi(w % WPC), col((w / WPC) * TP + lane) {}

  __device__ const scalar_t* pmat(int ch) const {
    return pm + ((size_t)ch * C + c) * SS;
  }
  __device__ const scalar_t* src(int ch) const {
    return ch < T ? tips + (size_t)ch * S * P
                  : part + ((size_t)(ch - T) * C + c) * S * P;
  }
  // g_raw = gbuf[k, c] / m_k (the max is a constant) at this thread's
  // product rows of pattern p
  __device__ void load_graw(int k, int p, scalar_t gr[A]) const {
    const bool valid = p < P;
    const scalar_t m = valid ? sc[(size_t)k * P + p] : scalar_t(1);
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const int a = wi + WPC * i;
      gr[i] = (valid && a < S)
                  ? gb[(((size_t)k * C + c) * S + a) * P + p] / m
                  : scalar_t(0);
    }
  }
  __device__ void store_other(scalar_t* O, const scalar_t o[A]) const {
#pragma unroll
    for (int i = 0; i < A; ++i) O[(wi + WPC * i) * TX + col] = o[i];
  }
  // the child's cotangent P_ch^T other, from Pts and O, to gbuf
  __device__ void child_cotangent(int ch, const scalar_t* Pt,
                                  const scalar_t* O, int p) const {
    scalar_t gch[A];
    rows_product<scalar_t, A>(Pt, O, SP, TX, wi, WPC, col, gch);
    if (p < P) {
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const int b = wi + WPC * i;
        if (b < S)
          gb[((((size_t)(ch - T)) * C + c) * S + b) * P + p] = gch[i];
      }
    }
  }
  __device__ void write_dp(int ch, scalar_t acc[AD][J]) const {
    scalar_t* out = dP + ((size_t)ch * C + c) * SS;
#pragma unroll
    for (int i = 0; i < AD; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int a = w + NW * i, b = lane + 32 * j;
        if (a < S && b < S) out[a * S + b] = acc[i][j];
      }
  }

  // A node of at most two children: each child's P and Pᵀ staged once, its
  // x once per step, y computed once and reused for the sibling's other.
  // g_raw at (a, p) is read by the thread that wrote it as a child cotangent
  // (the same rows and column), so it needs no barrier.
  __device__ void pair(int k) const {
    const int ch0 = __ldg(children + k * maxc);
    const int ch1 = maxc > 1 ? __ldg(children + k * maxc + 1) : -1;
    scalar_t acc0[AD][J], acc1[AD][J];
#pragma unroll
    for (int i = 0; i < AD; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc0[i][j] = acc1[i][j] = 0;
    for (int p0 = pb; p0 < pe; p0 += TQ) {
      const int p = p0 + col;
      scalar_t gr[A], y[A];
      load_graw(k, p, gr);
      __syncthreads();  // the last step's reads of every tile are done
      if (p0 == pb) {
        if (ch0 >= 0)
          stage_pmat(pmat(ch0), RA, S, SP, Ps, ch0 >= T ? Pts : nullptr);
        if (ch1 >= 0)
          stage_pmat(pmat(ch1), RA, S, SP, Ps + RA * SP,
                     ch1 >= T ? Pts + RA * SP : nullptr);
      }
      if (ch0 >= 0) stage_tile(src(ch0), S, P, p0, XR, TQ, TX, Xs);
      if (ch1 >= 0) stage_tile(src(ch1), S, P, p0, XR, TQ, TX, Xs + XR * TX);
      staged();
      __syncthreads();
      const scalar_t* X0 = Xs;
      const scalar_t* X1 = Xs + XR * TX;
      // the other of child 1 is g_raw y_0, that of child 0 g_raw y_1; a
      // missing child contributes 1
      if (ch0 >= 0) {
        rows_product<scalar_t, A>(Ps, X0, SP, TX, wi, WPC, col, y);
      } else {
#pragma unroll
        for (int i = 0; i < A; ++i) y[i] = 1;
      }
#pragma unroll
      for (int i = 0; i < A; ++i) y[i] *= gr[i];
      store_other(Os + OR * TX, y);
      if (ch1 >= 0) {
        rows_product<scalar_t, A>(Ps + RA * SP, X1, SP, TX, wi, WPC, col, y);
      } else {
#pragma unroll
        for (int i = 0; i < A; ++i) y[i] = 1;
      }
#pragma unroll
      for (int i = 0; i < A; ++i) y[i] *= gr[i];
      store_other(Os, y);
      __syncthreads();
      if (ch0 >= 0) {
        dp_accumulate<scalar_t, AD, J>(Os, X0, TQ, TX, w, lane, acc0);
        if (ch0 >= T) child_cotangent(ch0, Pts, Os, p);
      }
      if (ch1 >= 0) {
        dp_accumulate<scalar_t, AD, J>(Os + OR * TX, X1, TQ, TX, w, lane,
                                       acc1);
        if (ch1 >= T) child_cotangent(ch1, Pts + RA * SP, Os + OR * TX, p);
      }
    }
    if (ch0 >= 0) write_dp(ch0, acc0);
    if (ch1 >= 0) write_dp(ch1, acc1);
  }

  // A polytomy (maxc 3 and up), one child after the other
  __device__ void polytomy(int k) const {
    for (int i = 0; i < maxc; ++i) child(k, i);
  }

  // Child i of node k alone (nothing if it is missing): its Pᵀ staged once
  // in slot 0, its x per step in slot 0; the siblings' products recomputed
  // per step in slot 1, where a lone sibling's P is staged once. At a binary
  // node that is half of pair(k)'s work, for a grid of twice the blocks.
  __device__ void child(int k, int i) const {
    const int* kids = children + k * maxc;
    const int ch = __ldg(kids + i);
    if (ch < 0) return;  // block-uniform
    int siblings = 0;
    for (int jj = 0; jj < maxc; ++jj)
      siblings += jj != i && __ldg(kids + jj) >= 0;
    __syncthreads();  // the last child's reads of the tiles are done
    if (ch >= T)
      stage_pmat(pmat(ch), RA, S, SP, static_cast<scalar_t*>(nullptr), Pts);
    scalar_t acc[AD][J];
#pragma unroll
    for (int u = 0; u < AD; ++u)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[u][j] = 0;
    for (int p0 = pb; p0 < pe; p0 += TQ) {
      const int p = p0 + col;
      scalar_t o[A];
      load_graw(k, p, o);
      __syncthreads();  // the last step's reads of Xs and Os are done
      stage_tile(src(ch), S, P, p0, XR, TQ, TX, Xs);
      bool first = true;
      for (int jj = 0; jj < maxc; ++jj) {
        const int cj = __ldg(kids + jj);
        if (jj == i || cj < 0) continue;
        if (!first) __syncthreads();  // slot 1's last reads are done
        if (siblings > 1 || p0 == pb)
          stage_pmat(pmat(cj), RA, S, SP, Ps + RA * SP,
                     static_cast<scalar_t*>(nullptr));
        stage_tile(src(cj), S, P, p0, XR, TQ, TX, Xs + XR * TX);
        staged();
        __syncthreads();
        scalar_t y[A];
        rows_product<scalar_t, A>(Ps + RA * SP, Xs + XR * TX, SP, TX, wi,
                                  WPC, col, y);
#pragma unroll
        for (int u = 0; u < A; ++u) o[u] *= y[u];
        first = false;
      }
      staged();  // x_i's copies, where no sibling waited for them
      store_other(Os, o);
      __syncthreads();
      dp_accumulate<scalar_t, AD, J>(Os, Xs, TQ, TX, w, lane, acc);
      if (ch >= T) child_cotangent(ch, Pts, Os, p);
    }
    write_dp(ch, acc);
  }
};

// The root seed of the reverse sweep for category c of one chain at
// patterns pb .. min(pb + BWD_P, P) - 1: gbuf[root, c] = w(c, s) g / site,
// and the block's d rootw[c, s], the sum over its patterns of
// root[c, s] g / site, where site = max(sum_c' w(c', .) . root[c'], tiny)
// over every category (in scaled coordinates as the forward had it),
// recomputed by each of the C blocks of a pattern block. With csplit, site
// is category c's own w(c, .) . root[c], g its own cotangent row, and the
// seed 0 where site is below tiny (the forward's log max(site, tiny) is flat
// there). inv_s: BWD_P scalars of shared memory, free until the barrier at
// the end.
template <typename scalar_t>
__device__ inline void backward_seed(const scalar_t* __restrict__ part,
                                     scalar_t* gb, scalar_t* __restrict__ drootw,
                                     const StateWeights<scalar_t>& rw,
                                     const scalar_t* __restrict__ g,
                                     scalar_t* inv_s, int I, int C, int S,
                                     int P, int c, int pb, int csplit) {
  const size_t root = (size_t)(I - 1) * C * S * P;
  const size_t root_c = root + (size_t)c * S * P;
  const scalar_t tiny = Limits<scalar_t>::tiny();
  for (int r = threadIdx.x; r < BWD_P; r += blockDim.x) {
    const int p = pb + r;
    scalar_t inv = 0;
    if (p < P && csplit) {
      const scalar_t* fr = rw.states(c);
      scalar_t site = 0;
      for (int s = 0; s < S; ++s)
        site += __ldg(fr + s) * part[root_c + (size_t)s * P + p];
      site *= rw.factor(c);
      inv = site >= tiny ? g[p] / site : scalar_t(0);
    } else if (p < P) {
      scalar_t site = 0;
      for (int cc = 0; cc < C; ++cc) {
        const scalar_t* fr = rw.states(cc);
        scalar_t per_cat = 0;
        for (int s = 0; s < S; ++s)
          per_cat += __ldg(fr + s) * part[root + ((size_t)cc * S + s) * P + p];
        site += rw.factor(cc) * per_cat;
      }
      site = site > tiny ? site : tiny;
      inv = g[p] / site;
    }
    inv_s[r] = inv;
  }
  __syncthreads();
  const scalar_t wc = rw.factor(c);
  const scalar_t* fc = rw.states(c);
  for (int t = threadIdx.x; t < S * BWD_P; t += blockDim.x) {
    const int s = t / BWD_P, r = t - s * BWD_P, p = pb + r;
    if (p < P) gb[root_c + (size_t)s * P + p] = wc * __ldg(fc + s) * inv_s[r];
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    scalar_t acc = 0;
    for (int r = 0; r < BWD_P && pb + r < P; ++r)
      acc += part[root_c + (size_t)s * P + pb + r] * inv_s[r];
    drootw[s] = acc;
  }
  __syncthreads();  // inv_s is read
}

// The reverse sweep of K6' at S != 4 in one block: category c of one chain
// for its patterns pb .. min(pb + BWD_P, P) - 1. First the root seed of
// category c (backward_seed), then the reverse postorder, one
// WideBackwardStep a node. m_k is read from sc.
// pm [N, C, S, S], part and gb [I, C, S, P], sc [I, P] (one chain's, or
// with csplit category c's), g [P]; dP the block's row [N, C, S, S] of the
// per-block sums (the caller zeroes the root's rows), drootw the block's
// d rootw[c] [S].
template <typename scalar_t, int A, int CP>
__device__ inline void backward_walk(
    const scalar_t* __restrict__ tips, const scalar_t* __restrict__ pm,
    const int* __restrict__ children, const scalar_t* __restrict__ part,
    const scalar_t* __restrict__ sc, scalar_t* gb,
    scalar_t* __restrict__ dP, scalar_t* __restrict__ drootw,
    const StateWeights<scalar_t>& rw, const scalar_t* __restrict__ g,
    unsigned char* smem_raw, int T, int I, int C, int S, int maxc, int P,
    int c, int pb, int csplit) {
  const auto sm = WideSmem<scalar_t>::template at<A, CP>(smem_raw, S);
  // Os is free until the first node
  backward_seed(part, gb, drootw, rw, g, sm.Os, I, C, S, P, c, pb, csplit);
  zero_spare_o_rows<scalar_t, A, CP>(sm.Os);
  const WideBackwardStep<scalar_t, A, CP> step(tips, pm, children, part, sc,
                                               gb, dP, sm, T, C, S, maxc, P,
                                               c, pb, min(pb + BWD_P, P));
  if (maxc <= 2) {
    for (int k = I - 1; k >= 0; --k) step.pair(k);
    return;
  }
  for (int k = I - 1; k >= 0; --k) step.polytomy(k);
}

}  // namespace
