// The node step of the forward sweep for any state count S from 2 to 64,
// shared by K5' at S != 4 (csrc/loop.cu loop_wide_forward_kernel: one block
// walks every node of one chain), K1' at S != 4 (csrc/pruning.cu
// fused_wide_forward_kernel: the same walk, rootw for the root's weights)
// and K7' (csrc/wide.cu forward_level: one block takes one node of a
// level). A block of 256 threads takes one category c of one node k for
// one step's patterns p0 .. p0 + TQ - 1 (128 at S <= 32, 32 above;
// csrc/tiles.cuh):
//   x_k[c] = prod_j P_j[c] @ x_j[c]   (a missing child contributes 1)
//   m_k = max(tiny, max over (c', s) of x_k[c', s]),  partials = x_k / m_k
// and the root's props_c sum_s freqs_s root[c, s] for its category. In
// category-split mode (`csplit`, K1' at S != 4 where the TPU kernel splits
// the categories) each category is a sweep of its own: m_k is the max over
// its own states, each block writes its own scalers, and the root writes
// log(max(w_c . root_c, tiny)) + sum_k log m_k per category, which the
// caller combines by a logsumexp over c.
//
// What bounds it: per branch, category and pattern 2 S^2 FLOPs (the child's
// product P x) against S partials read and written, so the FLOPs bound the
// function above S of about 10 in float32. The first design (one block per
// 32-pattern tile walking every category x child of a node in turn, tiles
// laid out for S = 64 at every S, P read as one scalar load per FMA and
// staged through registers) ran at 23-25x that bound. What the design does:
// - Categories on the grid, met by a thread-block cluster. A node's
//   category-c partials depend only on its children's category-c partials,
//   but its rescaling needs the per-pattern max over every (c, s). The C
//   blocks of one (pattern block, chain or node) form one cluster (C <= 8,
//   the portable cluster size): each reduces its rows to a per-pattern max
//   in its own shared memory, one cluster barrier follows, and each then
//   reads the C blocks' maxima through distributed shared memory. The max
//   is exact, so m is the same in any order. Two max slots, by node
//   parity, let one cluster barrier a node suffice. At C = 1 (the codon
//   models) there is no cluster; with `rescale` off only the root meets.
// - Each child staged once per node, two at a time (a binary node in one
//   round; a polytomy in rounds of two): P (zero outside [S, S]; a warp's
//   rows, its lanes' columns, no division) and the child's tile (16-byte
//   copies where P is a multiple of a vector) by cp.async, then
//   y_j = P_j x_j by rows_product (16-byte broadcast P rows, A rows a
//   thread shaped to S) and the product over children in registers.
// - The root: each block sums its category's props_c sum_s freqs_s root[c,
//   s] / m over its rows and warps; the cluster sums the blocks in a fixed
//   order, c = 0 .. C - 1, and the c = 0 block writes site_log. Every sum
//   has a fixed order, so a launch is bit-identical run to run.
// What bounds it now, at GY94 32 x 4096 (S = 61, C = 1): not shared-memory
// bandwidth (P rows read as four 4-byte broadcasts in place of one 16-byte
// one cost 1.1-1.35x, not 3x: chip_profile.py --k5-loads) but each node's
// serial chain of staging, barriers, products and the max.
// Tiles, in shared memory: Ps [2][RA][SP], Xs [2][SP][TX], red [WPC][TQ]
// (the per-warp maxima and root sums), bmax [2][TQ] (the block's maxima,
// read by the cluster), site [TQ] (the root's category sum).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

namespace cg = cooperative_groups;

// Pd [RA][SP] <- P ([S, S], row-major), zero outside [S, S]: warp w takes
// rows w, w + 8, ..., its lanes the columns (no division by SP)
template <typename scalar_t>
__device__ inline void stage_rows(const scalar_t* __restrict__ pm, int RA,
                                  int S, int SP, scalar_t* Pd) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < RA; r += NW)
    for (int col = lane; col < SP; col += 32) {
      const bool in = r < S && col < S;
      copy_async(Pd + r * SP + col, pm + (in ? r * S + col : 0), in);
    }
}

// Xd [SP][TX] <- src [S, P] at patterns p0 .. p0 + TQ - 1, zero outside, in
// 16-byte copies: src and P aligned to a vector
template <typename scalar_t, int TQ, int TX>
__device__ inline void stage_tile_vec(const scalar_t* src, int S, int SP,
                                      int P, int p0, scalar_t* Xd) {
  constexpr int V = Vec<scalar_t>::n, QV = TQ / V;
  for (int t = threadIdx.x; t < SP * QV; t += blockDim.x) {
    const int b = t / QV, q = (t - b * QV) * V, p = p0 + q;
    const bool in = b < S && p < P;
    __pipeline_memcpy_async(Xd + b * TX + q,
                            src + (in ? (size_t)b * P + p : 0), 16,
                            in ? 0 : 16);
  }
}

template <typename scalar_t, int A, int CP> struct WideForwardStep {
  using Tiles = WideTiles<scalar_t, A, CP>;
  static constexpr int WPC = Tiles::WPC, RA = Tiles::RA, TQ = Tiles::TQ;
  static constexpr int TX = Tiles::TX;
  __host__ __device__ static size_t smem_scalars(int S) {
    const size_t SP = Tiles::sp(S);
    return 2 * RA * SP + 2 * SP * TX + (size_t)WPC * TQ + 3 * TQ;
  }

  const scalar_t* tips;
  const scalar_t* pm;
  const int* children;
  scalar_t* part;
  scalar_t* sc;  // written by the c = 0 block only (with csplit, by each)
  scalar_t *Ps, *Xs, *red, *bmax, *site;
  int T, C, S, SP, maxc, P, c, p0, rescale, csplit;
  int wi, col, p;  // the products' row offset, pattern in the step, pattern
  bool vec;        // tiles staged in 16-byte copies

  // pm [N, C, S, S], part [I, C, S, P], sc [I, P] (one chain's, or with
  // csplit category c's); the block's patterns start at p0. Every argument
  // is uniform over the block.
  __device__ WideForwardStep(const scalar_t* tips_, const scalar_t* pm_,
                             const int* children_, scalar_t* part_,
                             scalar_t* sc_, unsigned char* smem, int T_,
                             int C_, int S_, int maxc_, int P_, int c_,
                             int p0_, int rescale_, int csplit_ = 0)
      : tips(tips_), pm(pm_), children(children_), part(part_),
        sc(c_ == 0 || csplit_ ? sc_ : nullptr), T(T_), C(C_), S(S_),
        SP(Tiles::sp(S_)), maxc(maxc_), P(P_), c(c_), p0(p0_),
        rescale(rescale_), csplit(csplit_) {
    Ps = reinterpret_cast<scalar_t*>(smem);
    Xs = Ps + 2 * RA * SP;
    red = Xs + 2 * SP * TX;
    bmax = red + WPC * TQ;
    site = bmax + 2 * TQ;
    const int w = threadIdx.x >> 5;
    wi = w % WPC;
    col = (w / WPC) * TP + (threadIdx.x & 31);
    p = p0 + col;
    vec = P % Tiles::V == 0 && reinterpret_cast<size_t>(tips) % 16 == 0 &&
          reinterpret_cast<size_t>(part) % 16 == 0;
  }

  // P[ch, c] to slot s of Ps, child ch's category-c partials (tips: its
  // states) at the step's patterns to slot s of Xs
  __device__ void stage(int ch, int s) const {
    stage_rows(pm + ((size_t)ch * C + c) * S * S, RA, S, SP,
               Ps + s * RA * SP);
    const scalar_t* src = ch < T ? tips + (size_t)ch * S * P
                                 : part + ((size_t)(ch - T) * C + c) * S * P;
    if (vec)
      stage_tile_vec<scalar_t, TQ, TX>(src, S, SP, P, p0, Xs + s * SP * TX);
    else
      stage_tile(src, S, P, p0, SP, TQ, TX, Xs + s * SP * TX);
  }

  // x <- child ch's y = P x (slot s) times x
  __device__ void mul_child(int s, scalar_t x[A]) const {
    scalar_t y[A];
    rows_product<scalar_t, A>(Ps + s * RA * SP, Xs + s * SP * TX, SP, TX, wi,
                              WPC, col, y);
#pragma unroll
    for (int i = 0; i < A; ++i) x[i] *= y[i];
  }

  // Node k: x <- its category-c partials at this thread's rows and pattern,
  // rescaled; writes them (and, in the c = 0 block or with csplit, m) to
  // device memory and returns log m (0 with rescale off). `slot` alternates
  // between consecutive calls of a block (node parity). The block's
  // partials written by earlier calls are read back after a barrier.
  __device__ scalar_t node(int k, int slot, scalar_t x[A]) const {
    const int* kids = children + (size_t)k * maxc;
#pragma unroll
    for (int i = 0; i < A; ++i) x[i] = 1;
    for (int j = 0; j < maxc; j += 2) {
      const int ch0 = __ldg(kids + j);
      const int ch1 = j + 1 < maxc ? __ldg(kids + j + 1) : -1;
      if (ch0 < 0 && ch1 < 0) continue;  // block-uniform
      // the last round's reads of the tiles are done, and the partials
      // this block wrote before are visible
      __syncthreads();
      if (ch0 >= 0) stage(ch0, 0);
      if (ch1 >= 0) stage(ch1, 1);
      staged();
      __syncthreads();
      if (ch0 >= 0) mul_child(0, x);
      if (ch1 >= 0) mul_child(1, x);
    }
    scalar_t m = 1;
    if (rescale) {
      scalar_t mx = Limits<scalar_t>::tiny();
#pragma unroll
      for (int i = 0; i < A; ++i)
        if (wi + WPC * i < S) mx = x[i] > mx ? x[i] : mx;
      red[wi * TQ + col] = mx;
      __syncthreads();
      if (C == 1 || csplit) {
        m = red[col];
        for (int v = 1; v < WPC; ++v)
          m = red[v * TQ + col] > m ? red[v * TQ + col] : m;
      } else {
        scalar_t* mine = bmax + slot * TQ;
        if (wi == 0) {
          scalar_t b = red[col];
          for (int v = 1; v < WPC; ++v)
            b = red[v * TQ + col] > b ? red[v * TQ + col] : b;
          mine[col] = b;
        }
        // the categories meet: every block's maxima are written
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        m = cluster.map_shared_rank(mine, 0)[col];
        for (int r = 1; r < C; ++r) {
          const scalar_t b = cluster.map_shared_rank(mine, r)[col];
          m = b > m ? b : m;
        }
      }
#pragma unroll
      for (int i = 0; i < A; ++i) x[i] = x[i] / m;
    }
    if (p < P) {
      scalar_t* out = part + ((size_t)k * C + c) * S * P + p;
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const int a = wi + WPC * i;
        if (a < S) out[(size_t)a * P] = x[i];
      }
      if (sc && wi == 0) sc[(size_t)k * P + p] = m;
    }
    return rescale ? log_(m) : scalar_t(0);
  }

  // The root from its rescaled partials x (node() of rank I - 1):
  // site_log[p] = log(max(sum_c w(c, s) root[c, s], tiny)) + log_sum,
  // written by the c = 0 block; with csplit every block writes
  // log(max(sum_s w(c, s) root[c, s], tiny)) + log_sum of its category to
  // its own row, site_log
  __device__ void root(const StateWeights<scalar_t>& rw, const scalar_t x[A],
                       scalar_t log_sum, scalar_t* site_log) const {
    const scalar_t* __restrict__ fr = rw.states(c);
    scalar_t s = 0;
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const int a = wi + WPC * i;
      if (a < S) s += __ldg(fr + a) * x[i];
    }
    __syncthreads();  // the last node's reads of `red` are done
    red[wi * TQ + col] = s;
    __syncthreads();
    scalar_t v = 0;
    if (wi == 0) {
      v = red[col];
      for (int u = 1; u < WPC; ++u) v += red[u * TQ + col];
      v *= rw.factor(c);
    }
    if (C > 1 && !csplit) {
      if (wi == 0) site[col] = v;
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      if (c == 0 && wi == 0) {
        v = site[col];
        for (int r = 1; r < C; ++r) v += cluster.map_shared_rank(site, r)[col];
      }
      cluster.sync();  // no block leaves while the c = 0 block reads it
    }
    if ((c == 0 || csplit) && wi == 0 && p < P) {
      const scalar_t tiny = Limits<scalar_t>::tiny();
      site_log[p] = log_(v > tiny ? v : tiny) + log_sum;
    }
  }

  // Where a block ends after node() without root(): no block of the cluster
  // leaves while another reads its maxima
  __device__ void leave() const {
    if (rescale && C > 1 && !csplit) cg::this_cluster().sync();
  }
};

// The walk of K5' and K1' at S != 4: every node of one chain's postorder at
// the step's category and patterns, one node() a node, then the root
template <typename scalar_t, int A, int CP>
__device__ inline void forward_walk(
    const WideForwardStep<scalar_t, A, CP>& step, int I,
    const StateWeights<scalar_t>& rw, scalar_t* site_log) {
  scalar_t x[A], log_sum = 0;
  for (int k = 0; k < I; ++k) log_sum += step.node(k, k & 1, x);
  step.root(rw, x, log_sum, site_log);
}

// Launches `kernel` on grid (x, C, z) as clusters (1, C, 1) (none at C = 1
// or without `cluster`) with the forward step's dynamic shared memory
// (raising the limit above 48 KB where needed)
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, dim3 grid, size_t smem,
                            cudaStream_t stream, bool cluster,
                            Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster && grid.y > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The most clusters (1, C, 1) of `kernel` the card keeps resident at once
template <typename Kernel>
cudaError_t cluster_occupancy(Kernel kernel, int C, size_t smem,
                              int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, C, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace
