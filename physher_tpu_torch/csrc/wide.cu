// Felsenstein pruning for wide state spaces (codon S = 61, protein S = 20)
// and its reverse sweep, for Hopper (sm_90a).
//
// Kernel K7' (wide_forward_*) replaces the TPU kernel
// physher_tpu/ops/pallas_wide.py _fwd_kernel (built by build_wide_forward);
// kernel K8' (wide_backward_*) replaces _bwd_kernel (build_wide_backward).
// They compute the function of the TPU kernels, not their layout: no
// group-diagonal [Rg, Rg] packing, no padding of S to a multiple of 8 and no
// per-step DMA semaphores, all of which exist for the MXU and Mosaic.
//
// Layouts (all contiguous, pattern axis innermost):
//   tips      [T, S, P]      tip partials (pad columns: all ones)
//   pmats     [N, C, S, S]   P matrix of the branch above each node
//   children  [I, maxc]      int32 child ids, -1 for a missing child
//   nodes     [I]            internal ranks, level by level, leaves first
//   rootw     [C * S]        props (x) freqs
//   partials  [I, C, S, P]   rescaled partials of internal node rank k
//   scale     [I, P]         per-node per-pattern max m over (C, S)
//   site_log  [P]            log(max(rootw . root, tiny)) + sum_k log m_k
// Internal node k has id T + k; ids are postorder ranks, the root is N - 1.
//
// What the TPU design keeps: the per-node partials live in device memory,
// not on chip, so on-chip memory is bounded by one node's work whatever the
// tree's depth. The forward writes them anyway, so the backward reads them
// instead of recomputing the forward.
//
// What bounds them on this card: per node, category and child a product
// [S, S] @ [S, patterns], 2 S^2 FLOPs per pattern against S partials read
// and written: 2 S FLOP per element, 30 FLOP per byte at S = 61 in float32,
// so codon models are compute-heavy for plain FMAs, and protein models
// (S = 20, C = 4, more nodes) sit near the ridge.
//
// K7', redesigned for this card. The first design (one block per (32
// patterns, node) walking every category x child in turn, tiles laid out for
// S = 64 at every S, P read as one scalar load per FMA and staged through
// registers) ran at 25x its bound. It is now K5''s forward node step
// (csrc/wide_forward.cuh), launched once per level:
// - Grid (pattern blocks of one step, C, nodes of the level), as thread-
//   block clusters (1, C, 1): a block takes one (node, category) and runs
//   one node step, each child staged once by cp.async, tiles shaped to S;
//   the C blocks of a cluster meet for the per-pattern max over (C, S)
//   through distributed shared memory. The stream orders the levels, so a
//   child's partials written by one launch are read by the next.
// - The root's site (forward_root) is a launch of its own after the levels:
//   it sums log m over every node, which the level launches cannot.
//
// K8', redesigned for this card. Per branch, category and pattern it does
// 6 S^2 FLOPs above an internal node (the child's product P x, its dP outer
// product, its cotangent P^T other) and 4 S^2 above a tip (no cotangent)
// against a few S scalars read, so the FLOPs bound it (0.124 ms at WAG+G4
// 64 x 8192, C = 4; 0.070 ms at GY94 32 x 4096, C = 1). The first design,
// one block per (128 patterns, node) walking every category x child x
// 32-pattern tile in sequence, with tiles laid out for S = 64 at every S,
// each sibling restaged and its product recomputed per tile, and loads
// through registers, waited on latency at 40x that bound. It is now K6''s
// node step (csrc/wide_backward.cuh), launched once per level:
// - Grid (pattern blocks, C, nodes of the level), one launch per level, root
//   first. A block takes one (node, category) and runs one node step: each
//   child's P and P^T staged once, its partials once per step, each
//   y_j = P_j x_j computed once, tiles shaped to S, cp.async staging. The
//   categories are independent blocks (m_k is read from `scale`; gbuf[k, c]
//   and dP[ch, c] are disjoint per c), and the stream orders the levels, so
//   a child's gbuf rows written by one launch are read by the next. At
//   WAG+G4 the root level is 256 blocks, where it was 64.
// - A level of at most one block an SM (the top of a codon tree: C = 1, 32
//   pattern blocks at the root of GY94 32 x 4096) gives each child of a
//   node its own blocks (WideBackwardStep::child): at a binary node half the
//   work a block for twice the blocks, with no arithmetic added, since each
//   y_j serves only its sibling's `other`. The other levels keep one block
//   per node, which stages each child once.
// - Patterns per block: BWD_P (128), a multiple of every step's (128 at
//   S <= 32, 32 above). 64-pattern blocks at S > 32 widen the top levels of
//   a codon tree, but every other level and the dP scratch with them, for
//   no clear gain (chip_profile.py --k8-blocks).
// - The root seed (gbuf[root], d rootw, and the root's zero dP rows) is a
//   launch of its own before the levels.
// - Each (block, child, category) dP row is written by exactly one block,
//   and the caller sums the block axis in a fixed order: deterministic, no
//   atomics.

#include <cuda_runtime.h>

#include "tiles.cuh"
#include "wide_backward.cuh"
#include "wide_forward.cuh"

namespace {

// One level of the postorder: grid (pattern blocks of one step, C, nodes of
// the level), as clusters (1, C, 1); one WideForwardStep a block
// (csrc/wide_forward.cuh). Registers: float32 at three blocks an SM (K5'
// measured best at four; this budget was not swept), float64 at two.
template <typename scalar_t, int A, int CP>
__global__ void __launch_bounds__(THREADS, sizeof(scalar_t) == 4 ? 3 : 2)
    forward_level(const scalar_t* __restrict__ tips,
                  const scalar_t* __restrict__ pmats,
                  const int* __restrict__ children,
                  const int* __restrict__ nodes, scalar_t* partials,
                  scalar_t* __restrict__ scale, int T, int C, int S, int maxc,
                  int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Step = WideForwardStep<scalar_t, A, CP>;
  const Step step(tips, pmats, children, partials, scale, smem_raw, T, C, S,
                  maxc, P, blockIdx.y, blockIdx.x * Step::TQ, 1);
  scalar_t x[A];
  step.node(__ldg(nodes + blockIdx.z), 0, x);
  step.leave();
}

// site_log[p] = log(max(rootw . root, tiny)) + sum_k log scale[k, p]
template <typename scalar_t>
__global__ void forward_root(const scalar_t* __restrict__ partials,
                             const scalar_t* __restrict__ scale,
                             const scalar_t* __restrict__ rootw,
                             scalar_t* __restrict__ site_log, int I, int CS,
                             int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const scalar_t* root = partials + (size_t)(I - 1) * CS * P;
  scalar_t site = 0;
  for (int cs = 0; cs < CS; ++cs) site += __ldg(rootw + cs) * root[(size_t)cs * P + p];
  const scalar_t tiny = Limits<scalar_t>::tiny();
  site = site > tiny ? site : tiny;
  scalar_t log_sum = 0;
  for (int k = 0; k < I; ++k) log_sum += log_(scale[(size_t)k * P + p]);
  site_log[p] = log_(site) + log_sum;
}

// Root seed of the reverse sweep, per block of BWD_P patterns:
// gbuf[root] = rootw * g / site; drootw_part[block] = sum_p root * g / site;
// dP_part[block, root] = 0 (the root is no node's child).
template <typename scalar_t>
__global__ void backward_root(const scalar_t* __restrict__ partials,
                              const scalar_t* __restrict__ rootw,
                              const scalar_t* __restrict__ g,
                              scalar_t* __restrict__ gbuf,
                              scalar_t* __restrict__ drootw_part,
                              scalar_t* __restrict__ dP_part, int I, int N,
                              int C, int S, int P) {
  __shared__ scalar_t inv_s[BWD_P];
  const int CS = C * S, p0 = blockIdx.x * BWD_P;
  const size_t root = (size_t)(I - 1) * CS * P;
  scalar_t* dP_root = dP_part + ((size_t)blockIdx.x * N + N - 1) * CS * S;
  for (int t = threadIdx.x; t < CS * S; t += blockDim.x) dP_root[t] = 0;
  const scalar_t tiny = Limits<scalar_t>::tiny();
  for (int q = threadIdx.x; q < BWD_P; q += blockDim.x) {
    const int p = p0 + q;
    scalar_t inv = 0;
    if (p < P) {
      scalar_t site = 0;
      for (int cs = 0; cs < CS; ++cs)
        site += __ldg(rootw + cs) * partials[root + (size_t)cs * P + p];
      site = site > tiny ? site : tiny;
      inv = g[p] / site;
    }
    inv_s[q] = inv;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < CS * BWD_P; t += blockDim.x) {
    const int cs = t / BWD_P, q = t - cs * BWD_P, p = p0 + q;
    if (p < P) gbuf[root + (size_t)cs * P + p] = __ldg(rootw + cs) * inv_s[q];
  }
  for (int cs = threadIdx.x; cs < CS; cs += blockDim.x) {
    scalar_t s = 0;
    for (int q = 0; q < BWD_P && p0 + q < P; ++q)
      s += partials[root + (size_t)cs * P + p0 + q] * inv_s[q];
    drootw_part[(size_t)blockIdx.x * CS + cs] = s;
  }
}

// One level of the reverse sweep: grid (pattern blocks of BWD_P, C, nodes of
// the level), one node step a block (csrc/wide_backward.cuh); with `split`,
// grid (pattern blocks, C, nodes x maxc), one child of a node a block.
// dP_part: [gridDim.x, N, C, S, S]; every row but the root's.
// Registers as K6''s: float32 at two blocks an SM where a step takes the
// block's four tiles, at three (80 registers, with spills) where it takes
// one; float64 at one.
template <typename scalar_t, int A, int CP>
__global__ void __launch_bounds__(THREADS,
                                  sizeof(scalar_t) == 4 ? (CP == 4 ? 2 : 3)
                                                        : 1)
    backward_level(const scalar_t* __restrict__ tips,
                   const scalar_t* __restrict__ pmats,
                   const int* __restrict__ children,
                   const int* __restrict__ nodes,
                   const scalar_t* __restrict__ partials,
                   const scalar_t* __restrict__ scale, scalar_t* gbuf,
                   scalar_t* __restrict__ dP_part, int T, int N, int C, int S,
                   int maxc, int P, int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const auto sm = WideSmem<scalar_t>::template at<A, CP>(smem_raw, S);
  zero_spare_o_rows<scalar_t, A, CP>(sm.Os);
  const int pb = blockIdx.x * BWD_P;
  const WideBackwardStep<scalar_t, A, CP> step(
      tips, pmats, children, partials, scale, gbuf,
      dP_part + (size_t)blockIdx.x * N * C * S * S, sm, T, C, S, maxc, P,
      blockIdx.y, pb, min(pb + BWD_P, P));
  if (split) {
    step.child(__ldg(nodes + blockIdx.z / maxc), blockIdx.z % maxc);
    return;
  }
  const int k = __ldg(nodes + blockIdx.z);
  if (maxc <= 2)
    step.pair(k);
  else
    step.polytomy(k);
}

constexpr long MAX_GRID_Z = 65535;

bool bad_dims(int C, int S, int maxc) {
  return S < 2 || S > MAX_S || C < 1 || C > MAX_C || maxc < 1;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The levels of the forward sweep, leaves first, at one tile shape
template <typename scalar_t, int A, int CP> struct ForwardLevels {
  static size_t smem(int S) {
    return WideForwardStep<scalar_t, A, CP>::smem_scalars(S) *
           sizeof(scalar_t);
  }
  static cudaError_t run(const void* tips, const void* pmats,
                         const void* children, const int* nodes,
                         const int* offsets, int n_levels, void* partials,
                         void* scale, int T, int C, int S, int maxc, int P,
                         cudaStream_t stream) {
    constexpr int TQ = WideForwardStep<scalar_t, A, CP>::TQ;
    for (int l = 0; l < n_levels; ++l) {
      const dim3 grid((P + TQ - 1) / TQ, C, offsets[l + 1] - offsets[l]);
      const cudaError_t e = launch_clusters(
          forward_level<scalar_t, A, CP>, grid, smem(S), stream,
          static_cast<const scalar_t*>(tips),
          static_cast<const scalar_t*>(pmats),
          static_cast<const int*>(children), nodes + offsets[l],
          static_cast<scalar_t*>(partials), static_cast<scalar_t*>(scale), T,
          C, S, maxc, P);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

// The most clusters of forward_level at (S, C) resident at once
template <typename scalar_t, int A, int CP> struct ForwardClusters {
  static cudaError_t run(int S, int C, int* clusters) {
    return cluster_occupancy(forward_level<scalar_t, A, CP>, C,
                             ForwardLevels<scalar_t, A, CP>::smem(S),
                             clusters);
  }
};

template <typename scalar_t>
cudaError_t launch_forward(const void* tips, const void* pmats,
                           const void* children, const void* nodes,
                           const int* offsets, int n_levels,
                           const void* rootw, void* partials, void* scale,
                           void* site_log, int T, int I, int C, int S,
                           int maxc, int P, cudaStream_t stream) {
  if (bad_dims(C, S, maxc)) return cudaErrorInvalidValue;
  cudaError_t e = with_wide_tiles<scalar_t, ForwardLevels>(
      S, tips, pmats, children, static_cast<const int*>(nodes), offsets,
      n_levels, partials, scale, T, C, S, maxc, P, stream);
  if (e != cudaSuccess) return e;
  forward_root<scalar_t><<<(P + 255) / 256, 256, 0, stream>>>(
      static_cast<const scalar_t*>(partials),
      static_cast<const scalar_t*>(scale),
      static_cast<const scalar_t*>(rootw), static_cast<scalar_t*>(site_log),
      I, C * S, P);
  return cudaGetLastError();
}

// The levels of the reverse sweep, root first, at one tile shape
template <typename scalar_t, int A, int CP> struct BackwardLevels {
  static cudaError_t run(const void* tips, const void* pmats,
                         const void* children, const int* nodes,
                         const int* offsets, int n_levels,
                         const void* partials, const void* scale, void* gbuf,
                         void* dP_part, int T, int I, int C, int S, int maxc,
                         int P, cudaStream_t stream) {
    const size_t smem =
        WideTiles<scalar_t, A, CP>::smem_scalars(S) * sizeof(scalar_t);
    cudaError_t e = allow_smem(backward_level<scalar_t, A, CP>, smem);
    if (e != cudaSuccess) return e;
    int device, sms;
    e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    const int blocks = (P + BWD_P - 1) / BWD_P;
    for (int l = n_levels - 1; l >= 0; --l) {
      // a level of at most one block an SM (the top of a codon tree, C = 1)
      // gives each child of a node its own blocks, where grid.z holds them
      const int nodes_l = offsets[l + 1] - offsets[l];
      const int split = (long)blocks * C * nodes_l <= sms &&
                        (long)nodes_l * maxc <= MAX_GRID_Z;
      const dim3 grid(blocks, C, split ? nodes_l * maxc : nodes_l);
      backward_level<scalar_t, A, CP><<<grid, THREADS, smem, stream>>>(
          static_cast<const scalar_t*>(tips),
          static_cast<const scalar_t*>(pmats),
          static_cast<const int*>(children), nodes + offsets[l],
          static_cast<const scalar_t*>(partials),
          static_cast<const scalar_t*>(scale), static_cast<scalar_t*>(gbuf),
          static_cast<scalar_t*>(dP_part), T, T + I, C, S, maxc, P, split);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

template <typename scalar_t>
cudaError_t launch_backward(const void* tips, const void* pmats,
                            const void* children, const void* nodes,
                            const int* offsets, int n_levels,
                            const void* rootw, const void* partials,
                            const void* scale, const void* g, void* gbuf,
                            void* dP_part, void* drootw_part, int T, int I,
                            int C, int S, int maxc, int P,
                            cudaStream_t stream) {
  if (bad_dims(C, S, maxc)) return cudaErrorInvalidValue;
  const int blocks = (P + BWD_P - 1) / BWD_P;
  backward_root<scalar_t><<<blocks, THREADS, 0, stream>>>(
      static_cast<const scalar_t*>(partials),
      static_cast<const scalar_t*>(rootw), static_cast<const scalar_t*>(g),
      static_cast<scalar_t*>(gbuf), static_cast<scalar_t*>(drootw_part),
      static_cast<scalar_t*>(dP_part), I, T + I, C, S, P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return with_wide_tiles<scalar_t, BackwardLevels>(
      S, tips, pmats, children, static_cast<const int*>(nodes), offsets,
      n_levels, partials, scale, gbuf, dP_part, T, I, C, S, maxc, P, stream);
}

}  // namespace

extern "C" {

#define PHYSHER_WIDE_ENTRY(SUFFIX, TYPE)                                       \
  cudaError_t wide_forward_##SUFFIX(                                           \
      const void* tips, const void* pmats, const void* children,               \
      const void* nodes, const int* offsets, int n_levels, const void* rootw,  \
      void* partials, void* scale, void* site_log, int T, int I, int C, int S, \
      int maxc, int P, void* stream) {                                         \
    return launch_forward<TYPE>(tips, pmats, children, nodes, offsets,         \
                                n_levels, rootw, partials, scale, site_log, T, \
                                I, C, S, maxc, P,                              \
                                static_cast<cudaStream_t>(stream));            \
  }                                                                            \
  cudaError_t wide_backward_##SUFFIX(                                          \
      const void* tips, const void* pmats, const void* children,               \
      const void* nodes, const int* offsets, int n_levels, const void* rootw,  \
      const void* partials, const void* scale, const void* g, void* gbuf,      \
      void* dP_part, void* drootw_part, int T, int I, int C, int S, int maxc,  \
      int P, void* stream) {                                                   \
    return launch_backward<TYPE>(tips, pmats, children, nodes, offsets,        \
                                 n_levels, rootw, partials, scale, g, gbuf,    \
                                 dP_part, drootw_part, T, I, C, S, maxc, P,    \
                                 static_cast<cudaStream_t>(stream));           \
  }                                                                            \
  cudaError_t wide_forward_clusters_##SUFFIX(int S, int C, int* clusters) {    \
    if (C < 1 || C > MAX_C) return cudaErrorInvalidValue;                      \
    return with_wide_tiles<TYPE, ForwardClusters>(S, S, C, clusters);          \
  }

PHYSHER_WIDE_ENTRY(f32, float)
PHYSHER_WIDE_ENTRY(f64, double)

#undef PHYSHER_WIDE_ENTRY

}  // extern "C"
